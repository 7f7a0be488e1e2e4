"""The numerics of a FlashAttention kernel on bf16 tensor cores, checked
on the CPU: what splitting the f32 operands into bf16 terms keeps and what
it loses against ``repro_torch.kernels.limits.ATT_LIMITS``.

* An f32 value is exactly the sum of its three leading bf16 terms
  (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)): over
  q * sm_scale for every bf16 q at D = 32's scale, and over p from each
  exp backend. So three bf16 x bf16 products, each exact in an f32
  accumulator, reproduce an f32 product with a bf16 operand.
* One term is exact where the operand is a bf16 value already:
  bf16(q) * 2^-3 (D = 64's scale) for every bf16 q whose product stays
  normal, and every vexp_hw output.
* A negative control: the plain scan with p rounded to one or two bf16
  terms, or at D = 32 with q * sm_scale rounded to one or two terms,
  falls outside ``ATT_LIMITS["flash_attention"]`` under the exact exp
  and vexp, against the same scan unrounded. The limits see an
  under-split kernel.

Inputs are made with numpy from a seed. The emulation of the split is
this file's own; the package holds none.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.vexp import get_exp_fn, vexp_hw  # noqa: E402
from repro_torch.kernels.limits import (  # noqa: E402
    ATT_LIMITS, ONE_ULP_FREE, beyond_one_ulp)

ALL_BF16 = torch.arange(-32768, 32768, dtype=torch.int32).to(
    torch.int16).view(torch.bfloat16)


def bf16_terms(x: torch.Tensor, n: int) -> list:
    """The n leading bf16 terms of f32 x, largest first."""
    terms, r = [], x
    for _ in range(n):
        t = r.to(torch.bfloat16).float()
        terms.append(t)
        r = r - t
    return terms


def rounded(x: torch.Tensor, n: int) -> torch.Tensor:
    """x as the f32 sum of its n leading bf16 terms (exact for n <= 3)."""
    return torch.stack(bf16_terms(x, n)).double().sum(0).float()


def assert_split_exact(x: torch.Tensor):
    x = x[torch.isfinite(x)]
    got = torch.stack(bf16_terms(x, 3)).double().sum(0)
    bad = got != x.double()
    assert not bad.any(), (f"{int(bad.sum())} of {x.numel()} values are not "
                           f"the sum of three bf16 terms, e.g. "
                           f"{x[bad][:4].tolist()}")


def test_three_terms_exact_for_q_times_scale_d32():
    """Every bf16 q times 1/sqrt(32) in f32, as the kernel forms it. Only
    values whose lo term would fall below bf16's least subnormal (|x| <
    2^-110) can lose bits, and they move no output; the sweep keeps
    |x| >= 2^-100."""
    scale = torch.tensor(1.0 / math.sqrt(32), dtype=torch.float32)
    x = ALL_BF16.float() * scale
    assert_split_exact(x[x.abs() >= 2.0 ** -100])


@pytest.mark.parametrize("exp", ("exact", "vexp"))
def test_three_terms_exact_for_p(exp):
    """p = exp(s - m) over a dense sweep of s - m in [-90, 0]: every
    value the online softmax feeds to p . v."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(np.concatenate([
        np.linspace(-90.0, 0.0, 1 << 20, dtype=np.float32),
        -rng.exponential(4.0, 1 << 18).astype(np.float32)]))
    p = get_exp_fn(exp)(s)
    assert_split_exact(p[p >= 2.0 ** -100])


def test_one_term_exact_for_power_of_two_scale():
    """bf16(q) * 2^-3 (D = 64's sm_scale) is a bf16 value for every
    finite q with |q| >= 2^-123, so that the product stays normal. Below
    that the product is subnormal and may round; such a q moves no
    output."""
    q = ALL_BF16.float()
    q = q[torch.isfinite(q) & (q.abs() >= 2.0 ** -123)]
    x = q * torch.tensor(0.125, dtype=torch.float32)
    assert torch.equal(x.to(torch.bfloat16).float(), x)


def test_vexp_hw_outputs_are_bf16_values():
    """NP = 1 under vexp_hw: p is one bf16 term, over all bf16 inputs and
    a dense f32 sweep."""
    x = torch.cat([ALL_BF16.float(),
                   torch.linspace(-100.0, 100.0, 1 << 20)])
    y = vexp_hw(x)
    y = y[~torch.isnan(y)]
    assert torch.equal(y.to(torch.bfloat16).float(), y)


def _scan(q, k, v, kv_len, block_k, exp, *, q_terms=None, p_terms=None):
    """The plain blockwise scan (causal, keys below kv_len, f32), with
    q * sm_scale and / or p (in p . v) optionally rounded to their
    leading bf16 terms: an emulation of an under-split kernel."""
    exp_fn = get_exp_fn(exp)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qs = q.float().transpose(1, 2) * (1.0 / math.sqrt(d))
    if q_terms:
        qs = rounded(qs, q_terms)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].float().transpose(1, 2)
        vb = v[:, k0:k0 + block_k].float().transpose(1, 2)
        kpos = k0 + torch.arange(kb.shape[2])[None, :]
        keep = ((kpos <= qpos)[None, None]
                & (kpos < kv_len[:, None, None, None]))
        s = torch.where(keep, qs @ kb.transpose(-1, -2), -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = exp_fn(m - m_new)
        p = torch.where(keep, exp_fn(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        pv = rounded(p, p_terms) if p_terms else p
        acc = acc * alpha[..., None] + pv @ vb
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


def _qkv(d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, 256, 4, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3)]


KV_LEN = torch.tensor([256, 150], dtype=torch.int32)


@pytest.mark.parametrize("exp", ("exact", "vexp"))
@pytest.mark.parametrize("operand,d,terms", [
    ("p", 64, 1), ("p", 64, 2), ("q", 32, 1), ("q", 32, 2), ("p", 256, 2)])
def test_under_split_fails_the_limits(operand, d, terms, exp):
    """Rounding p (D = 64, and recurrentgemma's D = 256, whose scale 1/16
    keeps q * sm_scale a bf16 value as D = 64's 1/8 does) or q * sm_scale
    (D = 32) to fewer than three bf16 terms moves outputs past
    ATT_LIMITS["flash_attention"]; three terms move none (the split is
    exact, the sums keep their order)."""
    q, k, v = _qkv(d, seed=d)
    real = (torch.arange(256)[None, :] < KV_LEN[:, None])[:, :, None, None]
    ref = _scan(q, k, v, KV_LEN, 128, exp)
    key = "p_terms" if operand == "p" else "q_terms"
    lim_err, lim_share = ATT_LIMITS["flash_attention"][exp]

    def reading(n):
        out = _scan(q, k, v, KV_LEN, 128, exp, **{key: n})
        o, r = out[real.expand_as(out)], ref[real.expand_as(ref)]
        err = (beyond_one_ulp(o, r)
               if exp in ONE_ULP_FREE["flash_attention"]
               else float((o.float() - r.float()).abs().max()))
        return err, float((o != r).double().mean())

    err, share = reading(terms)
    assert not (err <= lim_err and share <= lim_share), (err, share)
    assert reading(3) == (0.0, 0.0)


def test_one_ulp_free_max():
    """FA's exact max counts only the outputs more than one bf16 ulp off
    the plain version's: a flip at |o| in [0.5, 1) (3.9e-3) is inside
    at any magnitude, two ulps are not, and +0 / -0 count as equal."""
    assert ONE_ULP_FREE == {"flash_attention": ("exact",)}
    ref = torch.tensor([0.75, 0.3, -0.6, 0.0], dtype=torch.bfloat16)
    one = torch.tensor([0.75390625, 0.3, -0.6015625, -0.0],
                       dtype=torch.bfloat16)
    assert float((one.float() - ref.float()).abs().max()) > \
        ATT_LIMITS["flash_attention"]["exact"][0]
    assert beyond_one_ulp(one, ref) == 0.0
    two = one.clone()
    two[0] = 0.7578125
    assert beyond_one_ulp(two, ref) == 0.0078125
    assert beyond_one_ulp(two.float(), ref.float()) == 0.0078125
