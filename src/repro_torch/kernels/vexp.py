"""Elementwise exponential kernel (port of ``repro/kernels/vexp``).

``vexp`` launches ``csrc/vexp.cu`` on a CUDA tensor and runs the plain
version, ``vexp_plain``, on a CPU tensor. Any shape; float32 or bfloat16
in, the same dtype out. The reference's 512-lane tiling and padding have
no counterpart: the kernel walks the flat array.
"""

from __future__ import annotations

import torch

from repro_torch.core.vexp import get_exp_fn
from .build import BACKEND_CODE, KernelLib, I, LL, P

LIB = KernelLib("vexp.cu")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def vexp_plain(x: torch.Tensor, exp_backend: str) -> torch.Tensor:
    """The function the kernel computes, in plain tensor ops."""
    return get_exp_fn(exp_backend)(x)


def vexp(x: torch.Tensor, *, policy) -> torch.Tensor:
    """exp(x) under ``policy.exp_backend``."""
    if x.device.type == "cpu":
        return vexp_plain(x, policy.exp_backend)
    if x.device.type != "cuda":
        raise ValueError(f"vexp kernel: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"vexp kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    xc = x.contiguous()
    y = torch.empty_like(xc)
    launch = LIB.fn("vexp_launch", [P, P, LL, I, I, P])
    LIB.check(launch(xc.data_ptr(), y.data_ptr(), xc.numel(),
                     _DTYPE_CODE[x.dtype], BACKEND_CODE[policy.exp_backend],
                     torch.cuda.current_stream(x.device).cuda_stream),
              "vexp")
    return y
