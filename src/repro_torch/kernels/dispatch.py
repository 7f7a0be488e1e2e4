"""Kernel dispatch table (port of ``repro/kernels/dispatch.py:54-126``).

``dispatch(op, policy)`` maps each numeric op onto the implementation the
policy's kernel tier selects:

    op                 cuda                        reference              eager
    ----------------   -------------------------   --------------------   ------------------
    vexp               kernels.vexp                core exp fn            core exp fn
    flash_attention    kernels.flash_attention     core attention_flash   core attention_xla
    decode_attention   kernels.decode_attention    core decode ref.       core decode ref.

Every callable takes the op's tensors and keywords plus ``policy=``. There
is no autotune and no fallback: an unregistered (op, tier) raises, and a
``cuda``-tier wrapper given a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

_TABLE: Dict[Tuple[str, str], str] = {}

OPS = ("vexp", "flash_attention", "decode_attention")


def register(op: str, backend: str, target: str) -> None:
    _TABLE[(op, backend)] = target


def _load(target: str) -> Callable:
    mod_name, fn_name = target.split(":")
    return getattr(importlib.import_module(mod_name), fn_name)


register("vexp", "cuda", "repro_torch.kernels.vexp:vexp")
register("vexp", "reference", "repro_torch.kernels.dispatch:_vexp_plain")
register("vexp", "eager", "repro_torch.kernels.dispatch:_vexp_plain")

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


# ------------------------------------------------ reference / eager tiers

def _vexp_plain(x, *, policy):
    return policy.exp_fn()(x)


def _kv_valid(kv_len, sk):
    from repro_torch.core.attention import kv_valid_from_len
    return None if kv_len is None else kv_valid_from_len(kv_len, sk)


def _attention_reference(q, k, v, *, causal=True, window=None, kv_len=None,
                         sm_scale=None, policy):
    from repro_torch.core.attention import attention_flash
    return attention_flash(q, k, v, causal=causal, window=window,
                           exp_impl=policy.exp_backend, sm_scale=sm_scale,
                           block_k=policy.block_k,
                           kv_valid=_kv_valid(kv_len, k.shape[1]))


def _attention_eager(q, k, v, *, causal=True, window=None, kv_len=None,
                     sm_scale=None, policy):
    from repro_torch.core.attention import attention_xla
    return attention_xla(q, k, v, causal=causal, window=window,
                         exp_impl=policy.exp_backend, sm_scale=sm_scale,
                         kv_valid=_kv_valid(kv_len, k.shape[1]))


def _decode_reference(q, k_cache, v_cache, cache_len, *, window=None,
                      sm_scale=None, layout="bshd", policy):
    from repro_torch.core.attention import decode_attention_reference
    return decode_attention_reference(
        q, k_cache, v_cache, cache_len, window=window,
        exp_impl=policy.exp_backend, sm_scale=sm_scale, layout=layout)
