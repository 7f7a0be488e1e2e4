"""Attention with VEXP softmax: the port's reference tiers and routed entries.

Port of ``repro/core/attention.py``. Shapes: q (B, S, H, D), k/v
(B, S, Hkv, D); GQA groups query heads over KV heads without repeating KV.

``attention_xla``     materialized scores (the ``eager`` tier),
``attention_flash``   FlashAttention-2 scan over KV blocks with online
                      (m, l, acc) statistics (the ``reference`` tier, and
                      the plain version the FA kernel is held to),
``decode_attention_reference``
                      single-token attention over a KV cache.

``attention`` and ``decode_attention`` route by ``policy.kernel_backend``
through ``kernels.dispatch``: the ``cuda`` tier reaches the hand-written
kernels, which take per-row key lengths, so ragged serving prefill runs on
the kernel too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .vexp import get_exp_fn

NEG_INF = -1e30  # finite mask value: keeps the vexp branches NaN-free


def _resolve(exp_impl):
    return exp_impl if callable(exp_impl) else get_exp_fn(exp_impl)


def _qpos(sq: int, q_offset, device) -> torch.Tensor:
    """(1|B, Sq) absolute query positions: ``q_offset`` is the position of
    q[0] minus that of k[0] (an int, or a (B,) tensor of per-row
    offsets)."""
    off = torch.as_tensor(q_offset, device=device).reshape(-1, 1)
    return torch.arange(sq, device=device)[None, :] + off


def _mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
          q_offset=0, device) -> Optional[torch.Tensor]:
    """(1|B, Sq, Sk) boolean keep-mask, or None when nothing is masked.
    Causal keep is ``kpos <= qpos + q_offset``."""
    if not causal and window is None:
        return None
    qpos = _qpos(sq, q_offset, device)[:, :, None]
    kpos = torch.arange(sk, device=device)[None, None, :]
    keep = (kpos <= qpos) if causal else torch.ones(
        qpos.shape[0], sq, sk, dtype=torch.bool, device=device)
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep


def kv_valid_from_len(kv_len: torch.Tensor, sk: int) -> torch.Tensor:
    """(B,) key lengths -> (B, Sk) boolean key-validity mask."""
    return (torch.arange(sk, device=kv_len.device)[None, :]
            < kv_len.reshape(-1, 1))


def attention_xla(q, k, v, *, causal=True, window=None, exp_impl="vexp",
                  q_offset=0, sm_scale=None, kv_valid=None):
    """Materialized-score attention. ``kv_valid`` (B, Sk) bool masks
    padding keys out of both weights and normalizer; ``q_offset`` (int or
    (B,)) places the queries past a key history."""
    exp_fn = _resolve(exp_impl)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    msk = _mask(sq, sk, causal=causal, window=window, q_offset=q_offset,
                device=q.device)                      # (1|B, Sq, Sk)
    if kv_valid is not None:
        kvm = kv_valid[:, None, :]                    # (B, 1, Sk)
        msk = kvm if msk is None else msk & kvm
    if msk is not None:
        s = torch.where(msk[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = exp_fn(s - m)
    if msk is not None:
        p = torch.where(msk[:, None, None], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p * (1.0 / torch.clamp(l, min=1e-30))
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_flash(q, k, v, *, causal=True, window=None, exp_impl="vexp",
                    q_offset=0, sm_scale=None, block_k=512, kv_valid=None):
    """FlashAttention-2 scan: per-row running (m, l, acc) updated once per
    KV block of ``block_k`` keys counted from key 0, f32 throughout. Under
    vexp the block partition is part of the result (vexp(a)·vexp(b) !=
    vexp(a+b)), so the kernel that is held to this function updates on
    the same blocks. ``q_offset`` (int or (B,)) is the absolute position
    of q[0] minus that of k[0]."""
    exp_fn = _resolve(exp_impl)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    block_k = min(block_k, sk)
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d)
    qpos = _qpos(sq, q_offset, q.device)[:, :, None]     # (1|B, Sq, 1)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, sk, block_k):
        kblk = k[:, k0:k0 + block_k].float()
        vblk = v[:, k0:k0 + block_k].float()
        bk = kblk.shape[1]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kblk)
        kpos = k0 + torch.arange(bk, device=q.device)[None, :]
        keep = torch.ones((1, sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            keep = keep & (kpos[None] <= qpos)
        if window is not None:
            keep = keep & (kpos[None] > qpos - window)
        if kv_valid is not None:
            keep = keep & kv_valid[:, None, k0:k0 + bk]
        keep = keep[:, None, None]                    # (B|1, 1, 1, Sq, bk)
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = exp_fn(m - m_new)
        p = torch.where(keep, exp_fn(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd",
                                                    p, vblk)
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def decode_attention_reference(q, k_cache, v_cache, cache_len, *,
                               window=None, exp_impl="vexp", sm_scale=None,
                               layout="bshd"):
    """Single-token attention over a cache, one pass in f32.

    q: (B, 1, H, D); caches (B, S, Hkv, D) ("bshd") or (B, Hkv, S, D)
    ("bhsd"); cache_len: (B,) valid positions per row (the new token's
    K/V already written)."""
    exp_fn = _resolve(exp_impl)
    b, _, h, d = q.shape
    if layout == "bhsd":
        hkv, smax = k_cache.shape[1], k_cache.shape[2]
        eq_s, eq_o = "bkgd,bktd->bkgt", "bkgt,bktd->bkgd"
    else:
        smax, hkv = k_cache.shape[1], k_cache.shape[2]
        eq_s, eq_o = "bkgd,btkd->bkgt", "bkgt,btkd->bkgd"
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, hkv, g, d)
    s = torch.einsum(eq_s, qg, k_cache.float())
    pos = torch.arange(smax, device=q.device)[None, :]
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    keep = pos < cl
    if window is not None:
        keep = keep & (pos >= cl - window)
    keep = keep[:, None, None, :]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, exp_fn(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p * (1.0 / torch.clamp(l, min=1e-30))
    o = torch.einsum(eq_o, p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, kv_len=None,
              q_offset=0, sm_scale=None, policy):
    """Full-sequence attention under ``policy``. ``kv_len`` (B,) int32:
    per-row count of real keys (ragged right-padded prompts); None means
    every key is real. ``q_offset`` (int or (B,)): queries sit that many
    positions past key 0 (suffix prefill against a key history); the
    cuda tier's kernel takes both, so no call leaves the kernel."""
    from repro_torch.kernels.dispatch import dispatch
    return dispatch("flash_attention", policy)(
        q, k, v, causal=causal, window=window, kv_len=kv_len,
        q_offset=q_offset, sm_scale=sm_scale, policy=policy)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     sm_scale=None, layout="bshd", policy):
    """Single-token decode attention under ``policy``; cache_len (B,)."""
    from repro_torch.kernels.dispatch import dispatch
    return dispatch("decode_attention", policy)(
        q, k_cache, v_cache, cache_len, window=window, sm_scale=sm_scale,
        layout=layout, policy=policy)
