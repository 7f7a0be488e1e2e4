"""Fused row-softmax kernel (port of ``repro/kernels/softmax``).

``softmax`` launches ``csrc/softmax.cu`` on a CUDA tensor and runs the
plain version, ``softmax_plain``, on a CPU tensor. As the reference's
``ops.softmax`` does, the wrapper moves ``axis`` last and flattens the
leading dims into rows; float32 or bfloat16 in, the same dtype out, f32
math. There is no guard for a row masked everywhere: only
``core.softmax`` has one.
"""

from __future__ import annotations

import torch

from repro_torch.core.vexp import get_exp_fn
from .build import BACKEND_CODE, I, KernelLib, LL, P

LIB = KernelLib("softmax.cu")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_OK = set()          # (device, row length) checked to fit


def softmax_plain(x: torch.Tensor, axis: int = -1, *,
                  exp_backend: str = "vexp") -> torch.Tensor:
    """The function the kernel computes: f32 row max, exp(x - max), its
    sum, one reciprocal, a multiply; the result in x's dtype."""
    xf = x.float()
    m = torch.amax(xf, dim=axis, keepdim=True)
    e = get_exp_fn(exp_backend)(xf - m)
    s = e.sum(dim=axis, keepdim=True)
    return (e * (1.0 / s)).to(x.dtype)


def softmax(x: torch.Tensor, axis: int = -1, *, policy) -> torch.Tensor:
    """Softmax along ``axis`` under ``policy.exp_backend``."""
    if x.device.type == "cpu":
        return softmax_plain(x, axis, exp_backend=policy.exp_backend)
    if x.device.type != "cuda":
        raise ValueError(f"softmax kernel: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"softmax kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    xt = torch.movedim(x, axis, -1)
    n = xt.shape[-1]
    if (x.device, n) not in _SMEM_OK:
        smem = LIB.fn("softmax_smem_bytes", [I], LL)(n)
        limit = getattr(torch.cuda.get_device_properties(x.device),
                        "shared_memory_per_block_optin", None)
        if limit is not None and smem > limit:
            raise ValueError(f"softmax kernel: a row of {n} lanes needs "
                             f"{smem} B of shared memory, the card allows "
                             f"{limit}")
        _SMEM_OK.add((x.device, n))
    x2 = xt.reshape(-1, n).contiguous()
    y2 = torch.empty_like(x2)
    launch = LIB.fn("softmax_fwd", [P, P, LL, I, I, I, P])
    LIB.check(launch(x2.data_ptr(), y2.data_ptr(), x2.shape[0], n,
                     _DTYPE_CODE[x.dtype], BACKEND_CODE[policy.exp_backend],
                     torch.cuda.current_stream(x.device).cuda_stream),
              "softmax")
    return torch.movedim(y2.reshape(xt.shape), -1, axis)
