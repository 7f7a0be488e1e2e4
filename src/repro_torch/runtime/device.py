"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
card and no explicit ``device="cpu"`` they raise instead of carrying on
quietly on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device with no card present raises.

    On a CUDA device this also pins the matmul numerics the port states:
    f32 matmuls in full f32 (no TF32) and bf16 matmuls reduced in f32,
    matching the reference's f32-accumulated dots."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev
