"""Kernel dispatch table (port of ``repro/kernels/dispatch.py:54-126``).

``dispatch(op, policy)`` maps each numeric op onto the implementation the
policy's kernel tier selects:

    op                       cuda                          reference              eager
    ----------------------   ---------------------------   --------------------   ------------------
    vexp                     kernels.vexp                  core exp fn            core exp fn
    softmax                  kernels.softmax               core softmax           core softmax
    flash_attention          kernels.flash_attention       core attention_flash   core attention_xla
    decode_attention         kernels.decode_attention      core decode ref.       core decode ref.
    decode_attention_paged   kernels.decode_attention      paged_gather +         paged_gather +
                             (decode_attention_paged)      core decode ref.       core decode ref.
    decode_attention_sharded kernels.decode_attention      all_gather of the      all_gather of the
                             (decode_attention_sharded:    K/V slices +           K/V slices +
                             partial kernels + merge)      core decode ref.       core decode ref.

Every callable takes the op's tensors and keywords plus ``policy=``. There
is no autotune and no fallback: an unregistered (op, tier) raises, and a
``cuda``-tier wrapper given a CUDA tensor launches its kernel or raises.

``exp_callable(policy)`` is the one resolution rule of the
model-internal gate exponentials (the SSD's decays, softplus and SiLU
gates): the vexp op's kernel under the ``cuda`` tier (one launch a gate
exp on a CUDA tensor, its plain version on a CPU tensor), the plain exp
function under ``reference`` and ``eager``.
"""

from __future__ import annotations

import functools
import importlib
from typing import Callable, Dict, Tuple

import torch

_TABLE: Dict[Tuple[str, str], str] = {}

OPS = ("vexp", "softmax", "flash_attention", "decode_attention",
       "decode_attention_paged", "decode_attention_sharded")


def register(op: str, backend: str, target: str) -> None:
    _TABLE[(op, backend)] = target


def _load(target: str) -> Callable:
    mod_name, fn_name = target.split(":")
    return getattr(importlib.import_module(mod_name), fn_name)


register("vexp", "cuda", "repro_torch.kernels.vexp:vexp")
register("vexp", "reference", "repro_torch.kernels.dispatch:_vexp_plain")
register("vexp", "eager", "repro_torch.kernels.dispatch:_vexp_plain")

register("softmax", "cuda", "repro_torch.kernels.softmax:softmax")
register("softmax", "reference", "repro_torch.kernels.dispatch:_softmax_core")
register("softmax", "eager", "repro_torch.kernels.dispatch:_softmax_core")

register("flash_attention", "cuda",
         "repro_torch.kernels.flash_attention:flash_attention")
register("flash_attention", "reference",
         "repro_torch.kernels.dispatch:_attention_reference")
register("flash_attention", "eager",
         "repro_torch.kernels.dispatch:_attention_eager")

register("decode_attention", "cuda",
         "repro_torch.kernels.decode_attention:decode_attention")
register("decode_attention", "reference",
         "repro_torch.kernels.dispatch:_decode_reference")
register("decode_attention", "eager",
         "repro_torch.kernels.dispatch:_decode_reference")

# paged decode over a page pool and per-row block tables: the cuda tier
# walks the table inside the kernel; the other tiers gather the table
# into a contiguous cache first (the oracle semantics)
register("decode_attention_paged", "cuda",
         "repro_torch.kernels.decode_attention:decode_attention_paged")
register("decode_attention_paged", "reference",
         "repro_torch.kernels.dispatch:_decode_paged_reference")
register("decode_attention_paged", "eager",
         "repro_torch.kernels.dispatch:_decode_paged_reference")


# sequence-parallel decode over a cache sharded along S across ranks
# (``shard`` a distributed.ShardSpec): the cuda tier sweeps each rank's
# slice with the partial-statistics kernels and merges per the policy's
# merge_strategy; the other tiers all_gather the slices and run the
# decode reference (same semantics, one extra copy)
register("decode_attention_sharded", "cuda",
         "repro_torch.kernels.decode_attention:decode_attention_sharded")
register("decode_attention_sharded", "reference",
         "repro_torch.kernels.dispatch:_decode_sharded_reference")
register("decode_attention_sharded", "eager",
         "repro_torch.kernels.dispatch:_decode_sharded_reference")


def dispatch(op: str, policy) -> Callable:
    """The callable implementing ``op`` under ``policy``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    try:
        target = _TABLE[(op, policy.kernel_backend)]
    except KeyError:
        raise ValueError(f"no implementation registered for op={op!r} "
                         f"backend={policy.kernel_backend!r}") from None
    return _load(target)


def exp_callable(policy) -> Callable:
    """Elementwise exp of the model-internal gates under ``policy``
    (port of the reference's ``exp_callable``,
    ``repro/kernels/dispatch.py:136-153``); ``policy.exp_backend`` picks
    the function. The policy is required: with none, a gate on a CUDA
    tensor would run the plain chain of torch ops and skip the kernel.
    Under the ``cuda`` tier it is the vexp op's wrapper: one launch of
    ``csrc/vexp.cu`` a call on a CUDA tensor (the counterpart of the one
    fused XLA kernel a gate gets in the reference), the plain function on
    a CPU tensor; a kernel that cannot build or launch raises. Under
    ``reference`` / ``eager`` it is the plain function."""
    if policy is None:
        raise ValueError("exp_callable needs an ExecPolicy "
                         "(runtime.resolve_policy)")
    if policy.kernel_backend == "cuda":
        from repro_torch.kernels.vexp import vexp
        return functools.partial(vexp, policy=policy)
    from repro_torch.core.vexp import get_exp_fn
    return get_exp_fn(policy.exp_backend)


# ------------------------------------------------ reference / eager tiers

def _vexp_plain(x, *, policy):
    return policy.exp_fn()(x)


def _softmax_core(x, axis=-1, *, policy):
    from repro_torch.core.softmax import softmax as core_softmax
    return core_softmax(x, axis, exp_impl=policy.exp_backend)


def _kv_valid(kv_len, sk):
    from repro_torch.core.attention import kv_valid_from_len
    return None if kv_len is None else kv_valid_from_len(kv_len, sk)


def _attention_reference(q, k, v, *, causal=True, window=None, kv_len=None,
                         q_offset=0, sm_scale=None, policy):
    from repro_torch.core.attention import attention_flash
    return attention_flash(q, k, v, causal=causal, window=window,
                           exp_impl=policy.exp_backend, q_offset=q_offset,
                           sm_scale=sm_scale, block_k=policy.block_k,
                           kv_valid=_kv_valid(kv_len, k.shape[1]))


def _attention_eager(q, k, v, *, causal=True, window=None, kv_len=None,
                     q_offset=0, sm_scale=None, policy):
    from repro_torch.core.attention import attention_xla
    return attention_xla(q, k, v, causal=causal, window=window,
                         exp_impl=policy.exp_backend, q_offset=q_offset,
                         sm_scale=sm_scale,
                         kv_valid=_kv_valid(kv_len, k.shape[1]))


def _decode_reference(q, k_cache, v_cache, cache_len, *, window=None,
                      sm_scale=None, layout="bshd", policy):
    from repro_torch.core.attention import decode_attention_reference
    return decode_attention_reference(
        q, k_cache, v_cache, cache_len, window=window,
        exp_impl=policy.exp_backend, sm_scale=sm_scale, layout=layout)


def _decode_paged_reference(q, k_pool, v_pool, block_tab, cache_len, *,
                            window=None, sm_scale=None, layout="bshd",
                            policy):
    """Gather the block table into a contiguous per-row cache, then the
    one-pass decode reference (``_decode_paged_fallback`` of the JAX
    package)."""
    from repro_torch.core.attention import decode_attention_reference
    from repro_torch.kernels.decode_attention import paged_gather
    return decode_attention_reference(
        q, paged_gather(k_pool, block_tab, layout),
        paged_gather(v_pool, block_tab, layout), cache_len, window=window,
        exp_impl=policy.exp_backend, sm_scale=sm_scale, layout=layout)


def _decode_sharded_reference(q, k_cache, v_cache, cache_len, *, shard,
                              window=None, sm_scale=None, layout="bshd",
                              policy):
    """all_gather every rank's K/V slice into the whole cache (ranks in
    order along the sequence axis), then the one-pass decode reference
    (``_decode_sharded_fallback`` of the JAX package, with the gather
    written out)."""
    from repro_torch.core.attention import decode_attention_reference
    ax = 2 if layout == "bhsd" else 1

    def whole(c):
        parts = shard.comm.all_gather(c)             # (n, *slice)
        return torch.cat(list(parts.unbind(0)), dim=ax)

    return decode_attention_reference(
        q, whole(k_cache), whole(v_cache), cache_len, window=window,
        exp_impl=policy.exp_backend, sm_scale=sm_scale, layout=layout)
