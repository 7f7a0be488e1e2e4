"""Flash-decode kernels (port of ``repro/kernels/decode_attention``,
``partial=False``): the contiguous sweep and the paged sweep.

``decode_attention`` launches ``csrc/decode_attention.cu`` on CUDA tensors
and runs ``decode_attention_plain`` on CPU tensors. Both cache layouts
("bshd" (B,S,Hkv,d), "bhsd" (B,Hkv,S,d)) go to the one kernel through
strides; per-row ``cache_len`` (B,) and an optional window.

``decode_attention_paged`` launches ``csrc/decode_attention_paged.cu``:
the cache is a pool of pages ("bshd" (N,page,Hkv,d), "bhsd"
(N,Hkv,page,d)) and ``block_tab`` (B,nS) maps each row's logical pages to
pool pages. Its online update runs once per page, as the Pallas paged
kernel's does; ``decode_attention_paged_plain`` is the same function in
plain tensor ops, and ``paged_gather`` the oracle's gather.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.core.vexp import get_exp_fn
from .build import BACKEND_CODE, F, I, KernelLib, LL, P

LIB = KernelLib("decode_attention.cu")
PAGED_LIB = KernelLib("decode_attention_paged.cu")
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


# ------------------------------------------------------------ paged sweep

def _pool_layout(pool, layout):
    """(page, Hkv) of a pool in ``layout``."""
    if layout == "bhsd":
        return pool.shape[2], pool.shape[1]
    if layout == "bshd":
        return pool.shape[1], pool.shape[2]
    raise ValueError(f"unknown kv cache layout {layout!r}")


def paged_gather(pool, block_tab, layout="bshd"):
    """A contiguous per-row cache from a paged pool (the reference tier's
    semantics of block-table indirection, ``ops.paged_gather``). Returns
    (B, nS*page, Hkv, d) for "bshd" pools, (B, Hkv, nS*page, d) for
    "bhsd"."""
    tab = torch.as_tensor(block_tab, device=pool.device).long()
    b, ns = tab.shape
    got = pool[tab]                             # (B, nS, *page_shape)
    if layout == "bhsd":                        # (B, nS, Hkv, page, d)
        g = got.permute(0, 2, 1, 3, 4)
        return g.reshape(b, g.shape[1], ns * g.shape[3], g.shape[4])
    return got.reshape(b, ns * got.shape[2], *got.shape[3:])


def decode_attention_paged_plain(q, k_pool, v_pool, block_tab, cache_len, *,
                                 window=None, sm_scale=None, layout="bshd",
                                 exp_backend="vexp", block=None):
    """The function the paged kernel computes: the row's pages gathered
    through the table, then the flash-decode arithmetic with the online
    update once per ``block`` keys counted from key 0 (default: the
    page). Blocks past a row's ``cache_len`` are exact no-ops, so the
    gathered tail changes nothing. q (B,1,H,d) -> (B,1,H,d)."""
    page, _ = _pool_layout(k_pool, layout)
    return decode_attention_plain(
        q, paged_gather(k_pool, block_tab, layout),
        paged_gather(v_pool, block_tab, layout), cache_len, window=window,
        sm_scale=sm_scale, layout=layout, block_s=block or page,
        exp_backend=exp_backend)


def decode_attention_paged(q, k_pool, v_pool, block_tab, cache_len, *,
                           window=None, sm_scale=None, layout="bshd",
                           policy):
    """Paged flash-decode under ``policy`` (exp backend; the online-update
    unit is the pool's page). q (B,1,H,d); block_tab (B,nS) int; cache_len
    (B,) int. Returns (B,1,H,d) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_paged_plain(
            q, k_pool, v_pool, block_tab, cache_len, window=window,
            sm_scale=sm_scale, layout=layout,
            exp_backend=policy.exp_backend)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged kernel: unsupported "
                         f"device {q.device}")
    page, hkv = _pool_layout(k_pool, layout)
    b, _, h, d = q.shape
    g = h // hkv
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"decode_attention_paged kernel: {name} must "
                            f"be bfloat16 on {q.device}, got {t.dtype} on "
                            f"{t.device}")
    # strides in (page, head, token) order
    st = (k_pool.stride(0),) + ((k_pool.stride(1), k_pool.stride(2))
                                if layout == "bhsd"
                                else (k_pool.stride(2), k_pool.stride(1)))
    if (d not in HEAD_DIMS or h % hkv or g > MAX_GROUP
            or k_pool.shape != v_pool.shape
            or k_pool.stride() != v_pool.stride() or k_pool.stride(3) != 1
            or any(s % 8 for s in st)
            or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16):
        raise ValueError(
            f"decode_attention_paged kernel: needs head dim in "
            f"{HEAD_DIMS}, H % Hkv == 0 with H/Hkv <= {MAX_GROUP}, K and V "
            f"pools of equal shape and strides, a packed last dim and "
            f"16-byte aligned rows")
    tab = torch.as_tensor(block_tab, device=q.device).to(torch.int32)
    if tab.dim() != 2 or tab.shape[0] != b:
        raise ValueError(f"block_tab must be ({b}, nS), got "
                         f"{tuple(tab.shape)}")
    tab = tab.contiguous()
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = torch.broadcast_to(cl.to(torch.int32).reshape(-1), (b,)).contiguous()
    qg = q.reshape(b, hkv, g, d).contiguous()
    out = torch.empty_like(qg)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    launch = PAGED_LIB.fn("paged_decode_fwd", [P] * 6 + [I] * 6 + [LL] * 3
                          + [F, I, I, P])
    PAGED_LIB.check(launch(
        qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tab.data_ptr(), cl.data_ptr(), b, hkv, g, d, page, tab.shape[1],
        *st, scale, window or 0, BACKEND_CODE[policy.exp_backend],
        torch.cuda.current_stream(q.device).cuda_stream),
        "decode_attention_paged")
    return out.reshape(b, 1, h, d)
