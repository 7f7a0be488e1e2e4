"""The vexp kernel's table of the BF16 hardware model, and the vexp op
against the JAX package's Pallas vexp op.

vexp_hw is a function of the 16 bits of its bf16-rounded input, so the
CUDA kernel reads a 65,536-entry table (``kernels.vexp.vexp_hw_table``,
built on the card by the table kernel and held bit for bit to
``vexp_table_plain`` there by chip_smoke.py). These tests hold the plain
table to the reference's bit model, and the kernel's per-element work
(round to bf16, one lookup, widen) to the plain vexp_hw.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import vexp as jv  # noqa: E402
from repro.kernels.vexp import vexp as jax_vexp_op  # noqa: E402
from repro.runtime.policy import ExecPolicy as JaxPolicy  # noqa: E402
from repro_torch.core import vexp as tv  # noqa: E402
from repro_torch.kernels import vexp as kvexp  # noqa: E402
from repro_torch.runtime import ExecPolicy  # noqa: E402

BACKENDS = ("exact", "vexp", "vexp_hw")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def table():
    return kvexp.vexp_table_plain()


def test_table_is_the_bit_model_on_every_pattern(table):
    """Entry b is the reference's vexp_bf16_fixedpoint of pattern b (and
    the port's), for all 65,536 patterns, NaN and inf included."""
    assert table.dtype == torch.int16 and table.shape == (65536,)
    bits = np.arange(65536, dtype=np.uint16)
    want = np.asarray(jax.lax.bitcast_convert_type(
        jv.vexp_bf16_fixedpoint(jax.lax.bitcast_convert_type(
            jnp.asarray(bits), jnp.bfloat16)), jnp.uint16))
    got = table.numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    port = tv.vexp_bf16_fixedpoint(
        torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
    np.testing.assert_array_equal(port.view(torch.int16).numpy(),
                                  table.numpy())


def _f32_sweep():
    """Dense f32 inputs: evenly spaced over [-300, 300], random bit
    patterns of every exponent, exact bf16 rounding ties (low half
    0x8000, both parities of the kept bit) and their neighbours, +-0,
    f32 and bf16 subnormals, NaN payloads that rounding must keep NaN,
    +-inf, and both saturation edges of exp and of the bit model."""
    rng = np.random.default_rng(7)
    lin = np.linspace(-300.0, 300.0, 600_001, dtype=np.float32)
    rnd = rng.integers(0, 1 << 32, 300_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    hi = rng.integers(0, 1 << 16, 20_000, dtype=np.uint32) << 16
    ties = np.concatenate([hi | 0x8000, hi | 0x7FFF, hi | 0x8001]).astype(
        np.uint32).view(np.float32)
    nan_bits = np.array([0x7F800001, 0x7F80FFFF, 0x7F810000, 0x7FC00000,
                         0x7FFFFFFF, 0xFF800001, 0xFFC00000, 0xFFFFFFFF,
                         0x7F808000], np.uint32).view(np.float32)
    sub = np.array([0x00000001, 0x00008000, 0x00010000, 0x007FFFFF,
                    0x80000001, 0x807FFFFF], np.uint32).view(np.float32)
    edges = []
    for e in (-126.0 * 0.6931471805599453, 128.0 * 0.6931471805599453,
              88.0, -88.0, 89.0, -92.0, 255.0, 256.0, -256.0, -255.0):
        c = np.float32(e)
        edges.append(np.nextafter(c, np.float32(np.inf)))
        edges.append(c)
        edges.append(np.nextafter(c, np.float32(-np.inf)))
    spec = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45] + edges,
                    np.float32)
    return np.concatenate([lin, rnd, ties, nan_bits, sub, spec])


def test_lookup_after_round_equals_plain_vexp_hw(table):
    """The table kernel's f32 path, in plain tensor ops: round to bf16,
    look the pattern up, widen. Bitwise equal to the plain vexp_hw (and
    to the reference's) over the sweep."""
    x = torch.from_numpy(_f32_sweep())
    idx = x.to(torch.bfloat16).view(torch.int16).long() & 0xFFFF
    got = table[idx].view(torch.bfloat16).float()
    want = tv.vexp_hw(x)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(torch.int32).numpy())
    ref = np.asarray(jv.vexp_hw(jnp.asarray(x.numpy())), np.float32)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  ref.view(np.int32))


def _ulps(a, b, bf16):
    ints = np.int16 if bf16 else np.int32
    return np.abs(a.view(ints).astype(np.int64) - b.view(ints))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("exp", BACKENDS)
def test_op_matches_jax_pallas_op(exp, dtype):
    """The port's vexp op (its plain version on the CPU) against the JAX
    package's Pallas vexp op in interpret mode, at a ragged 3 x 700 shape
    (not a multiple of the kernel's 512-lane rows or of 8). vexp_hw
    bitwise. vexp bitwise against the reference's exp function run op by
    op (the numerical contract) and within 1 ulp of the Pallas op: XLA's
    CPU compiler fuses the jitted kernel body and moves 115 of these 2,100
    f32 results by 1 ulp from the reference's own op-by-op vexp_f32 (so
    does ``jax.jit(vexp_f32)``). exact within 2 ulps of the dtype (torch's
    and XLA's CPU exp differ there)."""
    tdt, jdt = DTYPES[dtype]
    x = (np.random.default_rng(11).standard_normal((3, 700)) * 5.0
         ).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    want = jax_vexp_op(xj, interpret=True,
                       policy=JaxPolicy(exp_backend=exp, interpret=True))
    xt = torch.from_numpy(x).to(tdt)
    got = kvexp.vexp(xt, policy=ExecPolicy(exp_backend=exp))
    assert got.shape == xt.shape and got.dtype == tdt
    bf16 = dtype == "bf16"
    if bf16:
        w = np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16))
        g = got.view(torch.int16).numpy()
    else:
        w = np.asarray(want).view(np.int32)
        g = got.view(torch.int32).numpy()
    if exp == "vexp_hw":
        np.testing.assert_array_equal(g, w)
    else:
        assert _ulps(g, w, bf16).max() <= (2 if exp == "exact" else 1)
    if exp == "vexp":
        eager = jv.vexp_f32(xj)
        e = (np.asarray(jax.lax.bitcast_convert_type(eager, jnp.int16))
             if bf16 else np.asarray(eager).view(np.int32))
        np.testing.assert_array_equal(g, e)


def test_cpu_path_builds_no_table():
    """The table is the card's; the CPU path runs the plain vexp_hw."""
    x = torch.linspace(-5, 5, 33)
    got = kvexp.vexp(x, policy=ExecPolicy(exp_backend="vexp_hw"))
    assert torch.equal(got, kvexp.vexp_plain(x, "vexp_hw"))
    assert kvexp.TABLE_LIB.launches == 0 and not kvexp._TABLES


def test_table_first_use_inside_graph_capture_raises(monkeypatch):
    """The table builds on first use, never inside a CUDA-graph capture:
    there the first use raises before touching the device."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        kvexp.vexp_hw_table(torch.device("cuda", 0))
    assert not kvexp._TABLES
