"""Flash-decode kernel (port of ``repro/kernels/decode_attention``,
contiguous cache, ``partial=False``).

``decode_attention`` launches ``csrc/decode_attention.cu`` on CUDA tensors
and runs ``decode_attention_plain`` on CPU tensors. Both cache layouts
("bshd" (B,S,Hkv,d), "bhsd" (B,Hkv,S,d)) go to the one kernel through
strides; per-row ``cache_len`` (B,) and an optional window.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.core.vexp import get_exp_fn
from .build import BACKEND_CODE, F, I, KernelLib, LL, P

LIB = KernelLib("decode_attention.cu")
HEAD_DIMS = (32, 64)      # gpt2-small, and its --reduced config
MAX_GROUP = 8


def _as_bhsd(cache, layout):
    if layout == "bhsd":
        return cache
    if layout == "bshd":
        return cache.transpose(1, 2)        # a view: (B, Hkv, S, d)
    raise ValueError(f"unknown kv cache layout {layout!r}")


def decode_attention_plain(q, k_cache, v_cache, cache_len, *, window=None,
                           sm_scale=None, layout="bshd", block_s=512,
                           exp_backend="vexp"):
    """The function the kernel computes (reference ``_decode_kernel``):
    q scaled in f32 then rounded to the cache dtype, f32 scores, online
    update once per ``block_s`` keys, p rounded to the cache dtype before
    p @ v, f32 accumulation. q (B,1,H,d) -> (B,1,H,d)."""
    exp_fn = get_exp_fn(exp_backend)
    kk, vv = _as_bhsd(k_cache, layout), _as_bhsd(v_cache, layout)
    b, _, h, d = q.shape
    hkv, smax = kk.shape[1], kk.shape[2]
    g = h // hkv
    cdt = kk.dtype
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = (q.float() * scale).to(cdt).float().reshape(b, hkv, g, d)
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    bs = min(block_s, smax)
    for k0 in range(0, smax, bs):
        kb = kk[:, :, k0:k0 + bs].float()
        vb = vv[:, :, k0:k0 + bs].float()
        kpos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        keep = kpos < cl
        if window is not None:
            keep = keep & (kpos >= cl - window)
        keep = keep[:, None, None, :]
        s = torch.where(keep, torch.einsum("bkgd,bktd->bkgt", qg, kb),
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = exp_fn(m - m_new)
        p = torch.where(keep, exp_fn(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgt,bktd->bkgd", p.to(cdt).float(), vb)
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     sm_scale=None, layout="bshd", policy):
    """Flash-decode under ``policy`` (exp backend, ``block_s``).
    q (B,1,H,d); cache_len (B,) int. Returns (B,1,H,d) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, cache_len, window=window,
            sm_scale=sm_scale, layout=layout, block_s=policy.block_s,
            exp_backend=policy.exp_backend)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel: unsupported device "
                         f"{q.device}")
    kk, vv = _as_bhsd(k_cache, layout), _as_bhsd(v_cache, layout)
    b, _, h, d = q.shape
    hkv, smax = kk.shape[1], kk.shape[2]
    g = h // hkv
    for name, t in (("q", q), ("k_cache", kk), ("v_cache", vv)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"decode_attention kernel: {name} must be "
                            f"bfloat16 on {q.device}, got {t.dtype} on "
                            f"{t.device}")
    if (d not in HEAD_DIMS or h % hkv or g > MAX_GROUP
            or kk.stride() != vv.stride() or kk.stride(3) != 1
            or any(s % 8 for s in kk.stride()[:3])
            or kk.data_ptr() % 16 or vv.data_ptr() % 16):
        raise ValueError(
            f"decode_attention kernel: needs head dim in {HEAD_DIMS}, "
            f"H % Hkv == 0 with H/Hkv <= {MAX_GROUP}, K and V with equal "
            f"strides, a packed last dim and 16-byte aligned rows")
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = torch.broadcast_to(cl.to(torch.int32).reshape(-1), (b,)).contiguous()
    qg = q.reshape(b, hkv, g, d).contiguous()
    out = torch.empty_like(qg)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    launch = LIB.fn("decode_fwd", [P, P, P, P, P] + [I] * 5 + [LL] * 3
                    + [F, I, I, I, P])
    LIB.check(launch(
        qg.data_ptr(), kk.data_ptr(), vv.data_ptr(), out.data_ptr(),
        cl.data_ptr(), b, hkv, g, smax, d, *kk.stride()[:3], scale,
        window or 0, policy.block_s, BACKEND_CODE[policy.exp_backend],
        torch.cuda.current_stream(q.device).cuda_stream),
        "decode_attention")
    return out.reshape(b, 1, h, d)
