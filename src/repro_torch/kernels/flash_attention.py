"""FlashAttention-2 forward kernel (port of ``repro/kernels/flash_attention``).

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors
and runs the plain version on CPU tensors. Layout (B, S, H, D) at the
interface, as in the reference's ``ops.flash_attention``; the kernel reads
that layout in place through strides, so nothing is transposed or padded.
Unlike the Pallas kernel it takes per-row key lengths ``kv_len`` and a
query offset ``q_offset``, so the serving engine's ragged prefill and its
suffix prefill against a shared-prefix history both run on it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.attention import (NEG_INF, _qpos, attention_flash,
                                       kv_valid_from_len)
from repro_torch.core.vexp import get_exp_fn
from .build import BACKEND_CODE, F, I, KernelLib, LL, P

LIB = KernelLib("flash_attention.cu")
HEAD_DIMS = (32, 64, 120, 128, 256)  # gpt2-small's 64, its --reduced
                                     # config's 32, h2o-danube3's 120,
                                     # phi3-medium's 128, recurrentgemma's
                                     # 256; 120 runs the D 128 kernel on
                                     # zero-filled columns
L_CHAIN_DIMS = (120, 128, 256)  # head dims whose kernel (fa_rows) chains
                                # each block's l
_SMEM_OK = set()          # (device, head dim, block_k) that fit


def flash_attention_plain(q, k, v, *, causal=True, window=None, kv_len=None,
                          q_offset=0, sm_scale=None, block_k=128,
                          exp_backend="vexp"):
    """The function the kernel computes: the reference's blockwise scan
    with the online update once per ``block_k`` keys counted from key 0,
    f32 dots, keys at or past ``kv_len[b]`` masked, queries at
    ``q_offset`` + i. Each block's l is summed in the order of the
    kernel's instantiation at this head dim: at D = 32 and 64 the
    threads' partial sums and a tree, nearest to ``sum``'s; at D = 120,
    128 and 256 one chain over the block's keys in order (``L_CHAIN_DIMS``,
    ``_attention_flash_l_chain``), since over their ~10-30x more outputs
    a tree's one-ulp flips reach outputs of |o| >= 0.5, past the exact
    limit."""
    kv_valid = (None if kv_len is None
                else kv_valid_from_len(kv_len, k.shape[1]))
    scan = (_attention_flash_l_chain if q.shape[-1] in L_CHAIN_DIMS
            else attention_flash)
    return scan(q, k, v, causal=causal, window=window, exp_impl=exp_backend,
                q_offset=q_offset, sm_scale=sm_scale, block_k=block_k,
                kv_valid=kv_valid)


def _attention_flash_l_chain(q, k, v, *, causal, window, exp_impl, q_offset,
                             sm_scale, block_k, kv_valid):
    """``core.attention.attention_flash`` with each block's l taken from
    the product of p with ones shaped as v, the product p @ v is: cuBLAS's
    f32 product on the H100 sums it over the block's keys in order, as
    the D 128 and 256 kernel chains both; with one column of ones it leaves key
    order (``tools/matmul_order.py`` reads both)."""
    exp_fn = get_exp_fn(exp_impl)
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
        l = l * alpha + torch.einsum("bkgst,btkd->bkgsd", p,
                                     torch.ones_like(vblk))[..., 0]
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd",
                                                    p, vblk)
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _rows16(t):
    """16-byte aligned rows, as the kernel's cp.async copies need."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) % 8 == 0 for i in range(3))


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward (the plain version on CPU tensors) with the
    reference's recompute backward (``_fa_bwd``, ``repro/kernels/
    flash_attention/ops.py:82-96``): autograd of ``attention_flash``
    under the same exp, mask and scale, at that function's own block_k
    (512, as ``flash_attention_ref`` calls it), from the saved q, k, v.
    No kernel runs in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, q_offset, sm_scale,
                policy):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, kv_len, q_offset, sm_scale,
                    policy.exp_backend)
        return _flash_attention(q, k, v, causal=causal, window=window,
                                kv_len=kv_len, q_offset=q_offset,
                                sm_scale=sm_scale, policy=policy)

    @staticmethod
    def backward(ctx, g):
        causal, window, kv_len, q_offset, sm_scale, exp = ctx.args
        qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_flash(
                *qkv, causal=causal, window=window, exp_impl=exp,
                q_offset=q_offset, sm_scale=sm_scale,
                kv_valid=(None if kv_len is None
                          else kv_valid_from_len(kv_len, qkv[1].shape[1])))
        return (*torch.autograd.grad(out, qkv, g),
                None, None, None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=None, kv_len=None,
                    q_offset=0, sm_scale=None, policy):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (B,Sq,H,D) in q's dtype.
    Where autograd records q, k or v (training) the call goes through
    ``_FlashAttentionFn``; otherwise (serving, a captured step) straight
    to the kernel.

    ``kv_len`` (B,) int: real keys per row (None: all Sk). ``q_offset``
    int or (B,) int: query i of row b sits at position q_offset[b] + i.
    The policy gives the exp backend and ``block_k``, the online-update
    block; the kernel holds a block's scores in shared memory, so on the
    card ``block_k`` is bounded by it (on an H100: 640 keys at D = 64 with
    64-row query tiles; 640 at D = 120 and 128 and 512 at D = 256, whose 64-row
    tiles of (position, head) pairs keep q^T and the K / V slabs as f32
    beside a 256-byte row of scores a key)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, window, kv_len,
                                       q_offset, sm_scale, policy)
    return _flash_attention(q, k, v, causal=causal, window=window,
                            kv_len=kv_len, q_offset=q_offset,
                            sm_scale=sm_scale, policy=policy)


def _flash_attention(q, k, v, *, causal, window, kv_len, q_offset, sm_scale,
                     policy):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    block_k = min(policy.block_k, sk)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, kv_len=kv_len,
            q_offset=q_offset, sm_scale=sm_scale, block_k=block_k,
            exp_backend=policy.exp_backend)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: unsupported device "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"flash_attention kernel: {name} must be "
                            f"bfloat16 on {q.device}, got {t.dtype} on "
                            f"{t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel: {name} needs a "
                             f"packed last dim")
    if d not in HEAD_DIMS or h % hkv or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{HEAD_DIMS}, or H={h} not a multiple of "
                         f"Hkv={hkv}, or v {tuple(v.shape)} != k "
                         f"{tuple(k.shape)}")
    if (q.device, d, block_k) not in _SMEM_OK:
        smem = LIB.fn("fa_smem_bytes", [I, I], LL)(d, block_k)
        limit = torch.cuda.get_device_properties(
            q.device).shared_memory_per_block_optin
        if smem > limit:
            raise ValueError(f"flash_attention kernel: block_k={block_k} "
                             f"needs {smem} B of shared memory, the card "
                             f"allows {limit}")
        _SMEM_OK.add((q.device, d, block_k))
    # the kernel copies whole 16-byte rows (and reads q in pairs): realign
    # a view that has none
    q, k, v = (t if _rows16(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_len.shape != (b,):
            raise ValueError(f"kv_len must be ({b},), got "
                             f"{tuple(kv_len.shape)}")
    # an int offset goes to the kernel as a scalar: no tensor to copy to
    # the card, so a CUDA graph can capture the call
    qoff, q_off = None, 0
    if isinstance(q_offset, int):
        q_off = q_offset
    else:
        qoff = torch.broadcast_to(
            torch.as_tensor(q_offset, device=q.device).to(torch.int32)
            .reshape(-1), (b,)).contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    launch = LIB.fn("fa_fwd", [P] * 6 + [I] * 6 + [LL] * 12
                    + [F, I, I, I, I, I, P])

    def bhs(t):          # (B, S, H, D) strides in (b, h, s) order
        return t.stride(0), t.stride(2), t.stride(1)

    LIB.check(launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        None if qoff is None else qoff.data_ptr(),
        b, h, hkv, sq, sk, d, *bhs(q), *bhs(k), *bhs(v), *bhs(out),
        scale, int(causal), window or 0, block_k, q_off,
        BACKEND_CODE[policy.exp_backend],
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention")
    return out
