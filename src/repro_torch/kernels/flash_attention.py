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

from repro_torch.core.attention import attention_flash, kv_valid_from_len
from .build import BACKEND_CODE, F, I, KernelLib, LL, P

LIB = KernelLib("flash_attention.cu")
HEAD_DIMS = (32, 64)      # gpt2-small, and its --reduced config
_SMEM_OK = set()          # (device, head dim, block_k) that fit


def flash_attention_plain(q, k, v, *, causal=True, window=None, kv_len=None,
                          q_offset=0, sm_scale=None, block_k=128,
                          exp_backend="vexp"):
    """The function the kernel computes: the reference's blockwise scan
    with the online update once per ``block_k`` keys counted from key 0,
    f32 dots, keys at or past ``kv_len[b]`` masked, queries at
    ``q_offset`` + i."""
    kv_valid = (None if kv_len is None
                else kv_valid_from_len(kv_len, k.shape[1]))
    return attention_flash(q, k, v, causal=causal, window=window,
                           exp_impl=exp_backend, q_offset=q_offset,
                           sm_scale=sm_scale, block_k=block_k,
                           kv_valid=kv_valid)


def _rows16(t):
    """16-byte aligned rows, as the kernel's cp.async copies need."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) % 8 == 0 for i in range(3))


def flash_attention(q, k, v, *, causal=True, window=None, kv_len=None,
                    q_offset=0, sm_scale=None, policy):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (B,Sq,H,D) in q's dtype.

    ``kv_len`` (B,) int: real keys per row (None: all Sk). ``q_offset``
    int or (B,) int: query i of row b sits at position q_offset[b] + i.
    The policy gives the exp backend and ``block_k``, the online-update
    block; the kernel holds a block's scores in shared memory, so on the
    card ``block_k`` is bounded by it (640 keys at D = 64 on an H100)."""
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
