"""Elementwise exponential kernel (port of ``repro/kernels/vexp``).

``vexp`` launches ``csrc/vexp.cu`` on a CUDA tensor and runs the plain
version, ``vexp_plain``, on a CPU tensor. Any shape; float32 or bfloat16
in, the same dtype out. The reference's 512-lane tiling and padding have
no counterpart: the kernel walks the flat array.

Bound: bytes, one read and one write per element (8 B f32, 4 B bf16;
0.060 and 0.030 ms at 49152 x 512 on an H100 SXM at 3.35 TB/s). Design:
``exact`` and ``vexp`` are computed per element by CTAs that each stream
one step of 16-byte vectors (one a thread for f32, four for bf16) with
streaming cache hints. ``vexp_hw`` is a function of the 16 bits of its
bf16-rounded input, so it reads a 65,536-entry table of the BF16
hardware model (``vexp_hw_table``, built on first use on each device),
copied into each CTA's shared memory by TMA: a gather per element in
place of the integer datapath. An input at an odd offset (not 16-byte
aligned) takes a scalar loop inside the same kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.vexp import get_exp_fn, vexp_bf16_fixedpoint
from .build import BACKEND_CODE, KernelLib, I, LL, P

LIB = KernelLib("vexp.cu")
TABLE_LIB = KernelLib("vexp.cu")        # counts the vexp_hw table builds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TABLE_ENTRIES = 1 << 16
_TABLES = {}                            # CUDA device index -> table


def vexp_plain(x: torch.Tensor, exp_backend: str) -> torch.Tensor:
    """The function the kernel computes, in plain tensor ops."""
    return get_exp_fn(exp_backend)(x)


def vexp_table_plain(device="cpu") -> torch.Tensor:
    """The vexp_hw table in plain tensor ops: entry b (int16, read as the
    unsigned bit pattern) is the BF16 hardware model of bf16 pattern b."""
    bits = torch.arange(TABLE_ENTRIES, dtype=torch.int32, device=device)
    x = bits.to(torch.int16).view(torch.bfloat16)
    return vexp_bf16_fixedpoint(x).view(torch.int16)


def vexp_hw_table(device: torch.device) -> torch.Tensor:
    """The vexp_hw table on a CUDA device (int16, 65,536 entries), built by
    the table kernel at its first use there and kept for the process.
    A first use inside a CUDA-graph capture raises: the build must run
    before capture."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    table = _TABLES.get(index)
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "vexp_hw table: first use inside a CUDA-graph capture; run "
                "one vexp_hw call on this device before capturing")
        table = torch.empty(TABLE_ENTRIES, dtype=torch.int16,
                            device=torch.device("cuda", index))
        stream = torch.cuda.current_stream(table.device)
        build = TABLE_LIB.fn("vexp_hw_table_build", [P, P])
        TABLE_LIB.check(build(table.data_ptr(), stream.cuda_stream),
                        "vexp_hw_table")
        stream.synchronize()        # later launches may use other streams
        _TABLES[index] = table
    return table


class _VexpFn(torch.autograd.Function):
    """The kernel's forward (the plain version on a CPU tensor) with the
    plain function's derivative, so training takes the same gradient
    through either: ``g * y`` under exact (``torch.exp``'s), ``y``
    guarded against inf * 0 under vexp (``core.vexp._VexpF32``'s), zero
    under vexp_hw (``core.vexp._VexpHw``'s)."""

    @staticmethod
    def forward(ctx, x, policy):
        y = _vexp(x, policy)
        ctx.exp_backend = policy.exp_backend
        if policy.exp_backend != "vexp_hw":
            ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.exp_backend == "vexp_hw":
            return torch.zeros_like(g), None
        (y,) = ctx.saved_tensors
        if ctx.exp_backend == "vexp":
            return torch.where(torch.isfinite(y), y,
                               torch.zeros_like(y)) * g, None
        return g * y, None


def vexp(x: torch.Tensor, *, policy) -> torch.Tensor:
    """exp(x) under ``policy.exp_backend``. Where autograd records ``x``
    the call goes through ``_VexpFn``; otherwise (serving, a captured
    step) straight to the kernel."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _VexpFn.apply(x, policy)
    return _vexp(x, policy)


def _vexp(x: torch.Tensor, policy) -> torch.Tensor:
    if x.device.type == "cpu":
        return vexp_plain(x, policy.exp_backend)
    if x.device.type != "cuda":
        raise ValueError(f"vexp kernel: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"vexp kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    xc = x.contiguous()
    y = torch.empty_like(xc)
    table = (vexp_hw_table(x.device).data_ptr()
             if policy.exp_backend == "vexp_hw" else None)
    launch = LIB.fn("vexp_launch", [P, P, LL, I, I, P, P])
    LIB.check(launch(xc.data_ptr(), y.data_ptr(), xc.numel(),
                     _DTYPE_CODE[x.dtype], BACKEND_CODE[policy.exp_backend],
                     table, torch.cuda.current_stream(x.device).cuda_stream),
              "vexp")
    return y
