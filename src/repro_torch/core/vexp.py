"""VEXP: fast exponential approximation (Schraudolph + Belano polynomial).

Plain-tensor port of ``repro/core/vexp.py``. These functions are the
numerical contract: the CUDA device helpers in ``csrc/vexp.cuh`` reproduce
them bit for bit, and the kernels' plain versions call them.

``vexp_f32``
    Schraudolph's method in f32: ``x' = x*log2(e)`` split into integer and
    fraction, the two-branch quadratic mantissa correction P(frac), and
    ``2^i * (1+P)`` rebuilt by adding ``i`` to the exponent field.
``vexp_bf16_fixedpoint``
    Bit-level model of the paper's BF16 hardware datapath, all int32
    fixed point.

Every f32 operation below is one rounded tensor op (no fused multiply-add),
and every constant is an explicit f32 tensor value, rounded as JAX rounds a
weakly-typed Python float.
"""

from __future__ import annotations

import torch

ALPHA = 0.21875        # = 7/32
BETA = 0.4375          # = 7/16
GAMMA1 = 3.296875      # = 211/64
GAMMA2 = 2.171875      # = 139/64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

_F = 15                # fraction bits of x'
_LOG2E_Q15 = 47274     # round(log2(e) * 2**15)
_ALPHA_Q15 = 7168
_BETA_Q15 = 14336
_GAMMA1_Q15 = 108032
_GAMMA2_Q15 = 71168


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device, not a host->device copy, so a captured step
    # (runtime.graphs) can hold it
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _pcorr_f32(f: torch.Tensor) -> torch.Tensor:
    """P(f) ~ 2**f - 1 for f in [0, 1), evaluated in the reference's
    association order: ``(ALPHA*f)*(f+GAMMA1)`` and
    ``1 - (BETA*(1-f))*(f+GAMMA2)``."""
    lo = (ALPHA * f) * (f + GAMMA1)
    hi = 1.0 - (BETA * (1.0 - f)) * (f + GAMMA2)
    return torch.where(f < 0.5, lo, hi)


def _vexp_f32_value(x: torch.Tensor) -> torch.Tensor:
    orig = x.dtype
    xf = x.to(torch.float32)
    xp = torch.clamp(xf, -200.0, 200.0) * _f32(LOG2E, xf)
    i = torch.floor(xp)
    f = xp - i
    m = 1.0 + _pcorr_f32(f)                      # in [1, 2)
    ii = torch.clamp(i.to(torch.int32), -127, 128)
    mbits = m.view(torch.int32)
    out = (mbits + (ii << 23)).view(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=x.device)
    out = torch.where(ii <= -127, zero, out)
    out = torch.where(ii >= 128, inf, out)
    out = torch.where(xf <= _f32(-126.0 * LN2, xf), zero, out)
    out = torch.where(xf >= _f32(128.0 * LN2, xf), inf, out)
    out = torch.where(torch.isnan(xf), torch.full_like(out, float("nan")),
                      out)
    return out.to(orig)


class _VexpF32(torch.autograd.Function):
    """exp' = exp: the derivative reuses the approximation itself, with
    the saturated tails guarded against inf * 0 (reference ``:97-103``)."""

    @staticmethod
    def forward(ctx, x):
        y = _vexp_f32_value(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(torch.isfinite(y), y, torch.zeros_like(y)) * g


def vexp_f32(x: torch.Tensor) -> torch.Tensor:
    """Schraudolph+P(x) exponential computed in f32; returns x's dtype.
    Overflow gives +inf, underflow flushes to 0, NaN propagates."""
    if x.requires_grad:
        return _VexpF32.apply(x)
    return _vexp_f32_value(x)


def _round_shift_right(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Right shift with round-to-nearest (ties away from zero); v >= 0."""
    k = torch.clamp(k, 0, 30)
    bias = torch.where(k > 0, 1 << torch.clamp(k - 1, min=0),
                       torch.zeros_like(k))
    return (v + bias) >> k


def _pcorr_q15(f: torch.Tensor) -> torch.Tensor:
    """Fixed-point P(f), f in Q0.15. ``>>`` on int32 is an arithmetic
    shift; every shifted operand here is non-negative, so it equals the
    reference's logical shift."""
    fl = torch.clamp(f, max=(1 << 14) - 1)          # [0, 0.5)
    fh = torch.clamp(f, min=1 << 14)                # [0.5, 1)
    t1 = (fl * (fl + _GAMMA1_Q15)) >> 15
    lo = (_ALPHA_Q15 * t1) >> 15
    nf = 0x7FFF - fh                                # not(f)
    t2 = (nf * (fh + _GAMMA2_Q15)) >> 15
    hi = 0x7FFF - ((_BETA_Q15 * t2) >> 15)
    return torch.where(f < (1 << 14), lo, hi)


def vexp_bf16_fixedpoint(x: torch.Tensor) -> torch.Tensor:
    """Bit-level model of the paper's EXP block; bf16 in, bf16 out."""
    if x.dtype != torch.bfloat16:
        raise TypeError("hardware model is BF16-only")
    bits = x.view(torch.int16).to(torch.int32) & 0xFFFF
    sign = (bits >> 15) & 1
    e = (bits >> 7) & 0xFF
    mant = (bits & 0x7F) | 0x80                     # Q1.7 in [1, 2)

    prod = mant * _LOG2E_Q15
    k = 134 - torch.clamp(e, max=134)
    xq = _round_shift_right(prod, k)                # Q0.15 magnitude of x'
    xq = torch.where(sign == 1, -xq, xq)
    i = xq >> _F                                    # floor(x'), arithmetic
    f = xq & 0x7FFF

    p = _pcorr_q15(f)
    m7 = (p + (1 << 7)) >> 8
    carry = m7 >> 7
    m7 = torch.where(carry == 1, torch.zeros_like(m7), m7)
    new_e = i + 127 + carry

    out = (new_e << 7) | m7
    pos_over = (sign == 0) & ((e >= 135) | (new_e >= 255))
    under = (sign == 1) & ((e >= 135) | (new_e <= 0))
    under = under | ((sign == 0) & (new_e <= 0))
    out = torch.where(pos_over, 0x7F80, out)
    out = torch.where(under, 0, out)
    special = e == 255
    mbits = bits & 0x7F
    out = torch.where(special & (mbits != 0), 0x7FC0, out)          # qNaN
    out = torch.where(special & (mbits == 0) & (sign == 1), 0, out)  # -inf
    out = torch.where(special & (mbits == 0) & (sign == 0), 0x7F80, out)
    # every result is a non-negative bf16 pattern (<= 0x7FC0): fits int16
    return out.to(torch.int16).view(torch.bfloat16)


def vexp_hw(x: torch.Tensor) -> torch.Tensor:
    """Any float dtype through the bf16 hardware model (round to bf16,
    then back to the caller's dtype)."""
    if x.dtype == torch.bfloat16:
        return vexp_bf16_fixedpoint(x)
    return vexp_bf16_fixedpoint(x.to(torch.bfloat16)).to(x.dtype)


def exact_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


EXP_FNS = {
    "exact": exact_exp,
    "vexp": vexp_f32,
    "vexp_hw": vexp_hw,
}


def get_exp_fn(name: str):
    try:
        return EXP_FNS[name]
    except KeyError:
        raise ValueError(
            f"unknown exp impl {name!r}; one of {list(EXP_FNS)}") from None
