"""The attention kernels' plain versions at h2o-danube3-4b's head dim 120
with 4 query heads a KV head (G 4), against the JAX package.

On the card B3 runs ``fa_rows`` and B2 / B7 the chained decode sweep of
head dim 128, with columns 120-127 of q, K and V zero-filled as they
load (an exact +0 at the end of each score's chain) and 120 columns
written; the plain versions take 120 as they take 128 (``L_CHAIN_DIMS``
and ``KEY_MAJOR_DIMS`` hold it: the card's f32 products sum in order at
d 120, padded or not, ``tools/d128_order.py --d 120``). Here the plain
versions are held to:

* the JAX package's blockwise scan for FA, ragged ``kv_len``, a window
  and a (B,) ``q_offset``, under every exp backend, and the Pallas
  kernel in interpret mode (through the reference's ops, which pad d to
  128 lanes) at one small shape;
* the JAX package's one-pass decode reference for B2 (both layouts, a
  window) and B7 (a page table in random order), under every exp
  backend, and the Pallas decode kernels in interpret mode at one small
  shape each.

It also pins what the D 120 wrappers take against the CUDA sources: the
head dim runs the D 128 instantiation (``KERNEL_D``), the decode tier at
G 4 is the four-row one, and the split sweep's scratch and FA's shared
memory are the D 128 layouts'.

Inputs are made with numpy from a seed and fed to both packages in
bf16. Tolerance as ``test_torch_attention_d128.py`` states it: an output
may land a bf16 ulp apart, atol = rtol = 2^-7 on outputs of magnitude
<= ~1.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import attention as jatt  # noqa: E402
from repro.kernels.decode_attention.ops import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ops import \
    decode_attention_paged as pallas_decode_paged  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as pallas_fa  # noqa: E402
from repro.runtime import ExecPolicy as JaxPolicy  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.runtime import ExecPolicy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
G, D = 4, 120
CSRC = Path(kdec.__file__).resolve().parents[1] / "csrc"


def _inputs(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(x):
    return jnp.asarray(x, jnp.bfloat16)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------- B3

@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("window", [None, 20])
def test_flash_plain_d120_g4_matches_reference_scan(exp, window):
    """Two KV heads of G 4, ragged kv_len, a 32-key block, with and
    without a window, against the JAX blockwise scan."""
    b, s, hkv = 3, 72, 2
    q, k, v = _inputs([(b, s, hkv * G, D), (b, s, hkv, D), (b, s, hkv, D)],
                      seed=41)
    kv_len = np.array([72, 1, 40], np.int32)
    kv_valid = jnp.arange(s)[None, :] < jnp.asarray(kv_len)[:, None]
    want = jatt.attention_flash(_j(q), _j(k), _j(v), causal=True,
                                window=window, exp_impl=exp, block_k=32,
                                kv_valid=kv_valid)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    window=window,
                                    kv_len=torch.from_numpy(kv_len),
                                    block_k=32, exp_backend=exp)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, hkv * G, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("exp", EXPS)
def test_flash_plain_d120_chunk_offsets_match_reference(exp):
    """A chunk: 16 queries a row at (B,) offsets over a 64-key cache
    under a window of 24, as the windowed chunk program calls it."""
    b, sq, sk, hkv = 3, 16, 64, 1
    q, k, v = _inputs([(b, sq, hkv * G, D), (b, sk, hkv, D),
                       (b, sk, hkv, D)], seed=42)
    off = np.array([0, 48, 20], np.int32)
    toks = np.array([16, 16, 5], np.int32)
    kv_len = off + toks
    kv_valid = jnp.arange(sk)[None, :] < jnp.asarray(kv_len)[:, None]
    want = jatt.attention_flash(_j(q), _j(k), _j(v), causal=True, window=24,
                                exp_impl=exp, block_k=32, kv_valid=kv_valid,
                                q_offset=jnp.asarray(off))
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    window=24,
                                    kv_len=torch.from_numpy(kv_len),
                                    q_offset=torch.from_numpy(off),
                                    block_k=32, exp_backend=exp)
    real = (np.arange(sq)[None, :] < toks[:, None])[:, :, None, None]
    real = np.broadcast_to(real, got.shape)
    np.testing.assert_allclose(_np(got)[real], _np(want)[real], **TOL)


def test_flash_plain_d120_matches_pallas_interpret():
    """One small shape through the Pallas kernel body (interpret mode;
    the reference's ops pad d to 128 lanes with zeros): G 4 on one KV
    head, 32-key blocks, causal, a window of 20."""
    q, = _inputs([(1, 64, G, D)], seed=43)
    k, v = _inputs([(1, 64, 1, D), (1, 64, 1, D)], seed=44)
    jpol = JaxPolicy(exp_backend="vexp", kernel_backend="pallas",
                     block_q=32, block_k=32, interpret=True)
    want = pallas_fa(_j(q), _j(k), _j(v), True, 20, None, 32, 32, True,
                     jpol)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    window=20, block_k=32,
                                    exp_backend="vexp")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_flash_d120_runs_the_d128_kernel():
    """D 120 is a head dim of the FA wrapper with the l-chain plain
    version, and the kernel source runs it on fa_rows<128> (its
    dispatch, and its shared memory that of D 128)."""
    assert D in kfa.HEAD_DIMS and D in kfa.L_CHAIN_DIMS
    src = (CSRC / "flash_attention.cu").read_text()
    assert re.search(r"case 120:\s*case 128:\s*return "
                     r"fa_rows::smem_bytes<128>\(block_k\);", src)
    assert "fa_rows::launch<D == 120 ? 128 : D, BACKEND>" in src
    assert "constexpr bool kNarrow = kD == 128;" in src
    assert re.search(r"case 120:\s*return launch_exp<120>", src)


# ------------------------------------------------------------ B2, B7

@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("layout,window", [("bshd", None), ("bhsd", 40)])
def test_decode_plain_d120_g4_matches_jax(exp, layout, window):
    """B2's plain sweep at D 120, G 4 (two KV heads), 32-key update
    blocks, ragged cache_len, both layouts, a window cutting the keys,
    against the JAX package's one-pass decode reference."""
    b, hkv, smax = 3, 2, 96
    q, kc, vc = _inputs([(b, 1, hkv * G, D), (b, smax, hkv, D),
                         (b, smax, hkv, D)], seed=46)
    cl = np.array([96, 5, 70], np.int32)
    want = jatt.decode_attention(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                                 window=window, exp_impl=exp)
    if layout == "bhsd":
        kc, vc = kc.transpose(0, 2, 1, 3), vc.transpose(0, 2, 1, 3)
    got = kdec.decode_attention_plain(_t(q), _t(kc), _t(vc),
                                      torch.from_numpy(cl), window=window,
                                      layout=layout, block_s=32,
                                      exp_backend=exp)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _paged(x, page, tab):
    b, smax = x.shape[:2]
    ns = smax // page
    pool = np.zeros((1 + b * ns, page) + x.shape[2:], np.float32)
    pool[tab.reshape(-1)] = x.reshape((b * ns, page) + x.shape[2:])
    return pool


@pytest.mark.parametrize("exp", EXPS)
def test_paged_decode_plain_d120_g4_matches_jax(exp):
    """B7's plain sweep at D 120, G 4: 16-token pages behind a table in
    random order, one update a page."""
    b, hkv, smax, page = 3, 2, 64, 16
    q, kc, vc = _inputs([(b, 1, hkv * G, D), (b, smax, hkv, D),
                         (b, smax, hkv, D)], seed=47)
    cl = np.array([64, 3, 33], np.int32)
    ns = smax // page
    tab = (1 + np.random.default_rng(7).permutation(b * ns)).reshape(
        b, ns).astype(np.int32)
    want = jatt.decode_attention(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                                 exp_impl=exp)
    got = kdec.decode_attention_paged_plain(
        _t(q), _t(_paged(kc, page, tab)), _t(_paged(vc, page, tab)),
        torch.from_numpy(tab), torch.from_numpy(cl), exp_backend=exp)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_plain_d120_matches_pallas_interpret():
    """One small shape through the Pallas decode kernel and its paged
    form (interpret mode, d padded to 128 lanes by the reference's ops):
    G 4 on two KV heads, ragged cache_len, vexp_hw; 32-key blocks, and a
    16-token page at a time."""
    b, hkv, smax, page = 2, 2, 64, 16
    q, kc, vc = _inputs([(b, 1, hkv * G, D), (b, smax, hkv, D),
                         (b, smax, hkv, D)], seed=48)
    cl = np.array([64, 21], np.int32)
    jpol = JaxPolicy(exp_backend="vexp_hw", kernel_backend="pallas",
                     block_s=32, block_page=page, interpret=True)
    want = pallas_decode(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                         layout="bshd", interpret=True, policy=jpol)
    got = kdec.decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(cl),
                                layout="bshd",
                                policy=ExecPolicy(exp_backend="vexp_hw",
                                                  block_s=32))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    ns = smax // page
    tab = (1 + np.random.default_rng(8).permutation(b * ns)).reshape(
        b, ns).astype(np.int32)
    kp, vp = _paged(kc, page, tab), _paged(vc, page, tab)
    want = pallas_decode_paged(_j(q), _j(kp), _j(vp), jnp.asarray(tab),
                               jnp.asarray(cl), interpret=True, policy=jpol)
    got = kdec.decode_attention_paged(
        _t(q), _t(kp), _t(vp), torch.from_numpy(tab), torch.from_numpy(cl),
        policy=ExecPolicy(exp_backend="vexp_hw", block_page=page))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _cuh_const(name):
    src = (CSRC / "decode_split.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 6, 8, 9, 16])
def test_decode_d120_tiers_and_scratch_match_the_kernel(g):
    """decode_split.cuh runs head dim 120 on its D 128 kernels (``run``:
    case 120 takes launch<128, MODE, PAGED, 120>), so the wrapper's
    tier (chain_rows: four rows a key at G <= kChainG4, danube's G 4) and
    scratch are D 128's: the scores of those rows a key, then per row
    the tile maxes and each update block's p @ v of 128 columns, alpha
    and l, contiguous (8 blocks of 512 keys: danube's 4,096-slot ring)
    and paged (64 pages of 64)."""
    src = (CSRC / "decode_split.cuh").read_text()
    assert re.search(r"case 120:\s*if constexpr \(MODE == kNormalized\)"
                     r"\s*return launch<128, MODE, PAGED, 120>", src)
    assert D in kdec.HEAD_DIMS and D in kdec.KEY_MAJOR_DIMS
    assert kdec.KERNEL_D[D] == 128 and D not in kdec.STAT_HEAD_DIMS
    g4, g8 = _cuh_const("kChainG4"), _cuh_const("kChainG8")
    rows = g4 if g <= g4 else g8 if g <= g8 else _cuh_const("kChainG")
    assert kdec._chain_rows(D, g) == kdec._chain_rows(128, g) == rows
    b, hkv, keys = 2, 8, 4096
    for block in (512, 64):
        n_b = keys // block
        n_t = n_b * -(-block // 64)
        want = b * hkv * (n_t * 64 * rows + g * (n_t + n_b * (128 + 2)))
        buf, n = kdec._split_scratch(torch.empty(b, hkv, g, D), keys, block)
        assert n == want == buf.numel(), (g, block)


def test_decode_d120_shape_checks():
    """D 120 takes the normalized sweeps at G up to 16 and no partial /
    packed mode (the windowed dense family never shards its sequence)."""
    kdec._check_shape("t", "normalized", D, 32, 8)
    kdec._check_shape("t", "normalized", D, 16, 1)
    with pytest.raises(ValueError):
        kdec._check_shape("t", "partial", D, 32, 8)
    with pytest.raises(ValueError):
        kdec._check_shape("t", "normalized", D, 17 * 2, 2)
    with pytest.raises(ValueError):
        kdec._check_shape("t", "normalized", 112, 32, 8)
