"""PyTorch + CUDA port of the VEXP serving stack (``repro``'s counterpart).

Mirrors the reference package's layout: ``configs`` (model configs),
``core`` (the exp backends and attention reference math), ``runtime``
(execution policy, device), ``kernels`` (hand-written Hopper kernels, their
plain versions and the dispatch table), ``models`` (the dense decoder, its
API and the serving state), ``launch`` (the continuous-batching server)
and ``bridge`` (the reference's parameters carried over as numpy).
Imports ``torch`` only; nothing here imports JAX or the reference package.
"""
