"""The port's exponentials against the JAX reference's (``repro.core.vexp``).

vexp_hw and vexp_f32 are held bit for bit: the port's tensor code and the
reference perform the same rounded f32 / int32 steps in the same order.
The CUDA device helpers are held to these same functions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import vexp as jv  # noqa: E402
from repro_torch.core import vexp as tv  # noqa: E402
from repro_torch.kernels import vexp as kvexp  # noqa: E402
from repro_torch.runtime import ExecPolicy  # noqa: E402


def _bits32(a):
    return np.asarray(a).view(np.int32)


def _all_bf16():
    bits = np.arange(65536, dtype=np.uint16)
    return (jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16),
            torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))


def _dense_f32():
    """1M evenly spaced points over [-130, 130], 250k random bit patterns
    inside that range, and the specials. (chip_smoke.py sweeps every f32
    value in the range, kernel against plain version, on the card.)"""
    rng = np.random.default_rng(0)
    lin = np.linspace(-130.0, 130.0, 1_000_001, dtype=np.float32)
    hi = np.float32(130.0).view(np.int32)
    rnd = rng.integers(0, hi + 1, 250_000).astype(np.int32).view(
        np.float32) * rng.choice(np.float32([-1, 1]), 250_000)
    spec = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45,
                     -126.0 * 0.6931471805599453, 128.0 * 0.6931471805599453,
                     200.0, -200.0, 1e30, -1e30], np.float32)
    return np.concatenate([lin, rnd.astype(np.float32), spec])


def test_vexp_hw_all_bf16_patterns_bitwise():
    """All 65,536 bf16 patterns, NaN / inf / subnormal included."""
    xj, xt = _all_bf16()
    want = np.asarray(jax.lax.bitcast_convert_type(jv.vexp_hw(xj),
                                                   jnp.uint16))
    got = tv.vexp_hw(xt).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def _exact_ulps(x, got, true, normal):
    """ulps of ``got`` from ``true`` where ``normal``, and the x there."""
    ulp = np.abs(_bits32(got[normal]).astype(np.int64)
                 - _bits32(true[normal]))
    return ulp, x[normal]


@pytest.mark.parametrize("name", ["vexp", "vexp_hw", "exact"])
def test_f32_dense_sweep(name):
    """vexp and vexp_hw bitwise over the sweep. exact: torch's exp and
    XLA's exp are each held to the true value (float64 ``np.exp`` rounded
    to f32), not to each other: how far two libm implementations agree
    depends on the host's CPU, while each stays close to the truth. Each
    within 2 ulp where the true result is a normal number, except next to
    f32 overflow (x > 88.5), where XLA's exp polynomial is measured up to
    5 ulp off (limit 6); XLA's CPU runtime flushes subnormal results to
    zero and torch does not, so in exp's subnormal tail both only have to
    stay below 2^-126."""
    x = _dense_f32()
    want = np.asarray(jv.get_exp_fn(name)(jnp.asarray(x)))
    got = tv.get_exp_fn(name)(torch.from_numpy(x)).numpy()
    if name != "exact":
        np.testing.assert_array_equal(_bits32(got), _bits32(want))
        return
    with np.errstate(over="ignore"):
        true = np.exp(x.astype(np.float64)).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    assert np.array_equal(np.isnan(got), np.isnan(true)), "torch NaNs"
    assert np.array_equal(np.isnan(want), np.isnan(true)), "XLA NaNs"
    normal = np.isfinite(true) & (true >= tiny)
    edge = x > 88.5
    for region, sel, limit in (("x <= 88.5", normal & ~edge, 2),
                               ("x > 88.5", normal & edge, 6)):
        ut, xs = _exact_ulps(x, got, true, sel)
        ux, _ = _exact_ulps(x, want, true, sel)
        for who, u in (("torch", ut), ("XLA", ux)):
            i = int(u.argmax())
            assert u[i] <= limit, (
                f"exact exp, {region}: {who} is {u[i]} ulp from the true "
                f"value (limit {limit}) at x = {xs[i]!r}; there torch is "
                f"{ut[i]} ulp and XLA {ux[i]} ulp off")
    sub = ~normal & ~np.isnan(true) & np.isfinite(true)
    assert (got[sub] < tiny).all(), "torch: subnormal tail above 2^-126"
    assert (want[sub] < tiny).all(), "XLA: subnormal tail above 2^-126"


def test_vexp_f32_on_bf16_input_bitwise():
    """bf16 in, f32 datapath, bf16 out (NaN payload aside: both quiet)."""
    xj, xt = _all_bf16()
    want = np.asarray(jax.lax.bitcast_convert_type(jv.vexp_f32(xj),
                                                   jnp.uint16))
    got = tv.vexp_f32(xt).view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(np.asarray(jv.vexp_f32(xj), np.float32))
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(tv.vexp_f32(xt).float().numpy()[nan]).all()


@pytest.mark.parametrize("name", ["vexp", "vexp_hw"])
def test_paper_accuracy_envelope(name):
    """Paper §V-A: ~0.14% mean / 0.78% max relative error vs exp, on the
    reference tests' range [-30, 10]."""
    x = np.random.default_rng(1).uniform(-30, 10, 200_000).astype(np.float32)
    xt = torch.from_numpy(x)
    if name == "vexp_hw":
        xt = xt.to(torch.bfloat16)
        ref = np.exp(xt.float().numpy().astype(np.float64))
    else:
        ref = np.exp(x.astype(np.float64))
    y = tv.get_exp_fn(name)(xt).float().numpy().astype(np.float64)
    rel = np.abs(y - ref) / ref
    assert rel.mean() < 0.0025
    assert rel.max() < 0.0078 * 1.01


def test_jvp_matches_jax():
    """exp' = exp through the approximation, saturated tails guarded."""
    x = np.concatenate([np.linspace(-90, 90, 2001, dtype=np.float32),
                        np.float32([-1000.0, 1000.0])])
    _, want = jax.jvp(jv.vexp_f32, (jnp.asarray(x),),
                      (jnp.ones_like(jnp.asarray(x)),))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv.vexp_f32(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad[-1] == 0 and xt.grad[-2] == 0


def test_registry():
    assert set(tv.EXP_FNS) == set(jv.EXP_FNS)
    with pytest.raises(ValueError):
        tv.get_exp_fn("nope")
    with pytest.raises(TypeError):
        tv.vexp_bf16_fixedpoint(torch.zeros(2))


@pytest.mark.parametrize("name", ["exact", "vexp", "vexp_hw"])
def test_kernel_wrapper_takes_plain_version_on_cpu(name):
    x = torch.linspace(-20, 5, 1001)
    got = kvexp.vexp(x, policy=ExecPolicy(exp_backend=name))
    assert torch.equal(got, kvexp.vexp_plain(x, name))
