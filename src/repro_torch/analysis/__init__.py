"""Hot-path contract analyzer of the port (counterpart of
``repro/analysis/``): the serving engine's contracts as checks.

The reference holds its decode step to "zero host syncs, donated
buffers, one collective per layer". The port's step is a CUDA graph
over an in-place carry (``runtime.graphs.StepGraph``), which breaks the
same ways: a host sync inside the step cannot be captured, and a carry
tensor rebound instead of written in place leaves the graph reading
stale storage. Two layers:

**AST lint** (stdlib only; runs without torch): source rules over
``src/repro_torch/**`` driven by the hot-path registry (the
``registry.hot_path`` marker and its lists): ``host-sync-in-hot-path``,
``refcount-pairing``, ``capture-hazard``, ``engine-family-branch`` and
``silent-fallback`` (``rules``). Findings are diffed against
``baseline.toml``, where every suppression carries its reason;
``python -m repro_torch.analysis src/repro_torch`` exits non-zero on
anything new (``cli``).

**Graph audit** (``graph_audit``; imports torch): the collective budget
of one step, the in-place carry (the donation counterpart), carry
stability, and on the card the capture audit (the captured step replays
to the eager step's tokens).

This ``__init__`` stays stdlib-only: model modules import
``registry.hot_path``. ``graph_audit`` is loaded on first use.
"""

from __future__ import annotations

from .findings import Finding, RunResult, Severity  # noqa: F401
from .registry import hot_path  # noqa: F401
from .rules import ALL_RULES, run_rules  # noqa: F401

__all__ = ["Finding", "RunResult", "Severity", "hot_path", "ALL_RULES",
           "run_rules", "graph_audit"]


def __getattr__(name):
    if name == "graph_audit":            # lazy: pulls in torch
        import importlib
        return importlib.import_module(".graph_audit", __name__)
    raise AttributeError(name)
