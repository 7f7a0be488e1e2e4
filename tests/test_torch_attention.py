"""The port's attention against the JAX reference.

* The FlashAttention kernel's plain version (what the CUDA kernel is held
  to on the card) against the reference's blockwise scan with ragged
  ``kv_valid``, under every exp backend, and against the Pallas
  ``flash_attention_bhsd`` in interpret mode at one small shape.
* The flash-decode kernel's plain version against the Pallas
  ``decode_attention_kernel`` in interpret mode at one small shape: both
  cache layouts, ragged (B,) ``cache_len``, with and without a window.
* The port's reference / eager tiers against their JAX counterparts.
* ``q_offset`` (queries placed past a key history, as hot prefix
  admission calls attention): the FA kernel's plain version and the eager
  tier against the JAX ``attention_flash`` / ``attention_xla`` with the
  same offset, an int or one per row.

Inputs are made with numpy from a seed and fed to both packages in bf16.
Tolerance: both sides compute in f32 and round the output to bf16 once,
but sum in different orders, so an output may land one bf16 ulp apart
(2^-8 relative); under vexp_hw, where the exp input itself is rounded to
bf16, an f32 ulp of difference in a score can move one p by a bf16 ulp.
Hence atol = rtol = 2^-7 on outputs of magnitude <= ~1.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import attention as jatt  # noqa: E402
from repro.kernels.decode_attention.ops import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd  # noqa: E402
from repro.runtime import ExecPolicy as JaxPolicy  # noqa: E402
from repro_torch.core import attention as tatt  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels.dispatch import OPS, dispatch  # noqa: E402
from repro_torch.runtime import ExecPolicy, KERNEL_BACKENDS  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)


def _inputs(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(x):
    return jnp.asarray(x, jnp.bfloat16)


def _t(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


B, S, H, HKV, D = 3, 200, 4, 2, 32          # GQA 2:1, two KV blocks of 128
KV_LEN = np.array([200, 57, 130], np.int32)


@pytest.fixture(scope="module")
def qkv():
    return _inputs([(B, S, H, D), (B, S, HKV, D), (B, S, HKV, D)])


@pytest.mark.parametrize("exp", EXPS)
def test_flash_plain_matches_reference_scan_ragged(qkv, exp):
    q, k, v = qkv
    kv_valid = jnp.arange(S)[None, :] < jnp.asarray(KV_LEN)[:, None]
    want = jatt.attention_flash(_j(q), _j(k), _j(v), causal=True,
                                exp_impl=exp, block_k=128, kv_valid=kv_valid)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    kv_len=torch.from_numpy(KV_LEN),
                                    block_k=128, exp_backend=exp)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("exp", EXPS)
def test_eager_tier_matches_reference_xla(qkv, exp):
    q, k, v = qkv
    kv_valid = jnp.arange(S)[None, :] < jnp.asarray(KV_LEN)[:, None]
    want = jatt.attention_xla(_j(q), _j(k), _j(v), causal=True,
                              exp_impl=exp, kv_valid=kv_valid)
    pol = ExecPolicy(exp_backend=exp, kernel_backend="eager")
    got = tatt.attention(_t(q), _t(k), _t(v), causal=True,
                         kv_len=torch.from_numpy(KV_LEN), policy=pol)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_flash_plain_matches_pallas_interpret():
    """One small shape through the Pallas kernel body (interpret mode):
    same block partition (64 keys) and causal masking."""
    q, k, v = _inputs([(1, 128, 2, 32)] * 3, seed=1)
    want = flash_attention_bhsd(
        *(_j(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        sm_scale=1.0 / math.sqrt(32), causal=True, window=None,
        sk_valid=128, block_q=64, block_k=64, interpret=True,
        exp_impl="vexp")
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    block_k=64, exp_backend="vexp")
    np.testing.assert_allclose(_np(got), _np(want).transpose(0, 2, 1, 3),
                               **TOL)


@pytest.mark.parametrize("layout,window", [("bshd", None), ("bhsd", 40)])
def test_decode_plain_matches_pallas_interpret(layout, window):
    """Flash-decode: ragged (B,) cache_len, GQA groups of 2, a 300-row
    cache swept in 128-key blocks (the last one partial), vexp_hw."""
    b, hkv, g, d, smax = 3, 2, 2, 32, 300
    q, kc, vc = _inputs([(b, 1, hkv * g, d), (b, smax, hkv, d),
                         (b, smax, hkv, d)], seed=2)
    if layout == "bhsd":
        kc, vc = kc.transpose(0, 2, 1, 3).copy(), vc.transpose(0, 2, 1, 3).copy()
    cl = np.array([300, 17, 150], np.int32)
    want = pallas_decode(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                         window=window, layout=layout, interpret=True,
                         policy=JaxPolicy(exp_backend="vexp_hw",
                                          kernel_backend="pallas",
                                          block_s=128, interpret=True))
    got = kdec.decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(cl),
                                window=window, layout=layout,
                                policy=ExecPolicy(exp_backend="vexp_hw",
                                                  block_s=128))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_decode_reference_tier_matches_jax(exp, layout):
    b, hkv, d, smax = 3, 2, 32, 96
    q, kc, vc = _inputs([(b, 1, 4, d), (b, smax, hkv, d),
                         (b, smax, hkv, d)], seed=3)
    if layout == "bhsd":
        kc, vc = kc.transpose(0, 2, 1, 3).copy(), vc.transpose(0, 2, 1, 3).copy()
    cl = np.array([96, 5, 60], np.int32)
    want = jatt.decode_attention(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                                 exp_impl=exp, layout=layout)
    pol = ExecPolicy(exp_backend=exp, kernel_backend="reference")
    got = tatt.decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(cl),
                                layout=layout, policy=pol)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# recurrentgemma's attention shape: head dim 256, 16 query heads on one KV
# head (MQA), a window that cuts the keys
H256, D256, WIN = 16, 256, 20


@pytest.mark.parametrize("exp", EXPS)
def test_flash_plain_d256_mqa_window_matches_reference_scan(exp):
    q, k, v = _inputs([(2, 48, H256, D256), (2, 48, 1, D256),
                       (2, 48, 1, D256)], seed=7)
    kv_len = np.array([48, 31], np.int32)
    kv_valid = jnp.arange(48)[None, :] < jnp.asarray(kv_len)[:, None]
    want = jatt.attention_flash(_j(q), _j(k), _j(v), causal=True,
                                window=WIN, exp_impl=exp, block_k=32,
                                kv_valid=kv_valid)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    window=WIN,
                                    kv_len=torch.from_numpy(kv_len),
                                    block_k=32, exp_backend=exp)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_decode_plain_d256_g16_matches_jax(exp, paged):
    """The decode sweeps' plain versions at D 256, G 16 (one KV head),
    updating once per 32 keys (a page), a window cutting the keys,
    against the JAX package's one-pass decode reference."""
    b, smax, page = 3, 96, 32
    q, kc, vc = _inputs([(b, 1, H256, D256), (b, smax, 1, D256),
                         (b, smax, 1, D256)], seed=8)
    cl = np.array([96, 5, 70], np.int32)
    want = jatt.decode_attention(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                                 window=WIN, exp_impl=exp)
    if paged:
        ns = smax // page
        tab = np.random.default_rng(9).permutation(b * ns).reshape(
            b, ns).astype(np.int32) + 1
        pools = []
        for x in (kc, vc):
            pool = np.zeros((1 + b * ns, page, 1, D256), np.float32)
            pool[tab.reshape(-1)] = x.reshape(b * ns, page, 1, D256)
            pools.append(_t(pool))
        got = kdec.decode_attention_paged_plain(
            _t(q), *pools, torch.from_numpy(tab), torch.from_numpy(cl),
            window=WIN, exp_backend=exp)
    else:
        got = kdec.decode_attention_plain(_t(q), _t(kc), _t(vc),
                                          torch.from_numpy(cl), window=WIN,
                                          block_s=page, exp_backend=exp)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_cuda_tier_on_cpu_runs_the_plain_versions(qkv):
    q, k, v = (_t(x) for x in qkv)
    kvl = torch.from_numpy(KV_LEN)
    pol = ExecPolicy(exp_backend="vexp", kernel_backend="cuda", block_k=128)
    got = tatt.attention(q, k, v, kv_len=kvl, policy=pol)
    want = kfa.flash_attention_plain(q, k, v, kv_len=kvl, block_k=128,
                                     exp_backend="vexp")
    assert torch.equal(got, want)


def test_dispatch_table_complete_and_strict(monkeypatch):
    """Every op has all three tiers; an unknown op, or an (op, tier) with
    no entry, raises instead of falling back."""
    import importlib
    table = importlib.import_module("repro_torch.kernels.dispatch")._TABLE
    for op in OPS:
        for tier in KERNEL_BACKENDS:
            assert callable(dispatch(op, ExecPolicy(kernel_backend=tier)))
    with pytest.raises(ValueError):
        dispatch("decode_attention_windowed", ExecPolicy())   # no such op
    monkeypatch.delitem(table, ("decode_attention_sharded", "eager"))
    with pytest.raises(ValueError, match="no implementation"):
        dispatch("decode_attention_sharded",
                 ExecPolicy(kernel_backend="eager"))


QOFF_SQ, QOFF_SK = 40, 104                  # 64 history keys + 40 queries
# jitted, so the JAX side runs as one program, not op by op
_j_flash = jax.jit(jatt.attention_flash,
                   static_argnames=("causal", "exp_impl", "block_k"))
_j_xla = jax.jit(jatt.attention_xla, static_argnames=("causal", "exp_impl"))


@pytest.mark.parametrize("q_offset", [64, "per_row"])
@pytest.mark.parametrize("exp", EXPS)
def test_q_offset_matches_reference(exp, q_offset):
    """Suffix queries after a key history: causal keep is kpos <= qpos +
    q_offset, ragged per-row key lengths, blocks of 64 keys counted from
    key 0. Per-row offsets give each row its own history length."""
    q, = _inputs([(B, QOFF_SQ, H, D)], seed=7)
    k, v = _inputs([(B, QOFF_SK, HKV, D)] * 2, seed=8)
    kv_len = np.array([104, 70, 90], np.int32)
    off = (np.array([64, 30, 50], np.int32) if q_offset == "per_row"
           else q_offset)
    kv_valid = jnp.arange(QOFF_SK)[None, :] < jnp.asarray(kv_len)[:, None]
    joff = jnp.asarray(off)
    toff = torch.from_numpy(off) if q_offset == "per_row" else off
    want = _j_flash(_j(q), _j(k), _j(v), causal=True, exp_impl=exp,
                    block_k=64, q_offset=joff, kv_valid=kv_valid)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    kv_len=torch.from_numpy(kv_len),
                                    q_offset=toff, block_k=64,
                                    exp_backend=exp)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    want = _j_xla(_j(q), _j(k), _j(v), causal=True, exp_impl=exp,
                  q_offset=joff, kv_valid=kv_valid)
    pol = ExecPolicy(exp_backend=exp, kernel_backend="eager")
    got = tatt.attention(_t(q), _t(k), _t(v), causal=True,
                         kv_len=torch.from_numpy(kv_len), q_offset=toff,
                         policy=pol)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
