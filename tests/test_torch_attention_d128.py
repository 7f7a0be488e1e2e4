"""The attention kernels' plain versions at phi3-medium's head dim 128
with 4 query heads a KV head (G 4), against the JAX package.

On the card B3 runs ``fa_rows`` and B2 / B7 the chained decode sweep at
D 128 (``L_CHAIN_DIMS`` and ``KEY_MAJOR_DIMS`` hold 128), and each is
held to these plain versions; here the plain versions are held to:

* the JAX package's blockwise scan (``core.attention.attention_flash``)
  for FA, ragged ``kv_len``, a (B,) ``q_offset``, under every exp
  backend, and the Pallas ``flash_attention_bhsd`` in interpret mode at
  one small shape;
* the JAX package's one-pass decode reference for B2 (both layouts, a
  window) and B7 (a page table in random order), under every exp
  backend, and the Pallas ``decode_attention_kernel`` and its paged form
  in interpret mode at one small shape each.

It also pins what the D 128 wrappers take: the head dims, the group
bound, the split sweep's scratch size, and the shared-memory budget that
bounds FA's ``block_k`` (the policy's 512 fits, and up to 640).

Inputs are made with numpy from a seed and fed to both packages in
bf16. Tolerance, as ``test_torch_attention.py`` states it: both sides
round the output to bf16 once but sum in different orders (and the
decode plain version rounds q and p to bf16 as the kernel does), so an
output may land a bf16 ulp apart: atol = rtol = 2^-7 on outputs of
magnitude <= ~1.
"""

import math

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
from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd  # noqa: E402
from repro.runtime import ExecPolicy as JaxPolicy  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.runtime import ExecPolicy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
G, D = 4, 128
SMEM_OPTIN = 232_448          # an H100's shared memory a block may opt in to


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
def test_flash_plain_d128_g4_matches_reference_scan(exp):
    """Two KV heads of G 4, ragged kv_len, a 32-key block (the scan's
    online update), against the JAX blockwise scan."""
    b, s, hkv = 3, 72, 2
    q, k, v = _inputs([(b, s, hkv * G, D), (b, s, hkv, D), (b, s, hkv, D)],
                      seed=21)
    kv_len = np.array([72, 1, 40], np.int32)
    kv_valid = jnp.arange(s)[None, :] < jnp.asarray(kv_len)[:, None]
    want = jatt.attention_flash(_j(q), _j(k), _j(v), causal=True,
                                exp_impl=exp, block_k=32, kv_valid=kv_valid)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    kv_len=torch.from_numpy(kv_len),
                                    block_k=32, exp_backend=exp)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, hkv * G, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("exp", EXPS)
def test_flash_plain_d128_chunk_offsets_match_reference(exp):
    """A chunk: 16 queries a row at (B,) offsets over a 64-key cache
    (kv_len = offset + tokens), as the chunk program calls it."""
    b, sq, sk, hkv = 3, 16, 64, 1
    q, k, v = _inputs([(b, sq, hkv * G, D), (b, sk, hkv, D),
                       (b, sk, hkv, D)], seed=22)
    off = np.array([0, 48, 20], np.int32)
    toks = np.array([16, 16, 5], np.int32)
    kv_len = off + toks
    kv_valid = jnp.arange(sk)[None, :] < jnp.asarray(kv_len)[:, None]
    want = jatt.attention_flash(_j(q), _j(k), _j(v), causal=True,
                                exp_impl=exp, block_k=32, kv_valid=kv_valid,
                                q_offset=jnp.asarray(off))
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    kv_len=torch.from_numpy(kv_len),
                                    q_offset=torch.from_numpy(off),
                                    block_k=32, exp_backend=exp)
    real = (np.arange(sq)[None, :] < toks[:, None])[:, :, None, None]
    real = np.broadcast_to(real, got.shape)
    np.testing.assert_allclose(_np(got)[real], _np(want)[real], **TOL)


def test_flash_plain_d128_matches_pallas_interpret():
    """One small shape through the Pallas kernel body (interpret mode):
    G 4 on one KV head, a 32-key block, causal."""
    q, = _inputs([(1, 32, G, D)], seed=23)
    k, v = _inputs([(1, 32, 1, D), (1, 32, 1, D)], seed=24)
    want = flash_attention_bhsd(
        *(_j(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        sm_scale=1.0 / math.sqrt(D), causal=True, window=None,
        sk_valid=32, block_q=32, block_k=32, interpret=True,
        exp_impl="vexp")
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    block_k=32, exp_backend="vexp")
    np.testing.assert_allclose(_np(got), _np(want).transpose(0, 2, 1, 3),
                               **TOL)


def test_flash_d128_takes_the_l_chain_plain_version():
    """D 128 is a head dim of the kernel and sums each block's l as one
    chain (fa_rows); the plain version there is the l-chain scan, and it
    stays within a bf16 ulp of the sum-l scan."""
    assert D in kfa.HEAD_DIMS and D in kfa.L_CHAIN_DIMS
    q, k, v = (_t(x) for x in _inputs([(2, 40, G, D), (2, 40, 1, D),
                                       (2, 40, 1, D)], seed=25))
    chain = kfa.flash_attention_plain(q, k, v, block_k=16,
                                      exp_backend="vexp")
    from repro_torch.core.attention import attention_flash
    summed = attention_flash(q, k, v, causal=True, exp_impl="vexp",
                             block_k=16)
    np.testing.assert_allclose(_np(chain), _np(summed), **TOL)


def test_fa_score_tile_fits_block_k_512_to_640():
    """fa_rows' shared memory at D 128: q^T f32 (32 KB), the two f32
    stages (32 KB: 256 keys by 16 d, or 16 keys by 128 d in half of
    one), the row maxima of eight warps, each row's m_new, alpha and
    position, then the score tile of 64 rows by block_k keys rounded up
    to whole 32-key groups: 199,424 B at the policy's 512, and block_k up
    to 640 fits an H100's 227 KB a block."""
    rows, group = 64, 32
    fixed = D * rows * 4 + 2 * 8 * 32 * 16 * 4 + 8 * rows * 4 + 3 * rows * 4

    def smem(bk):
        return fixed + (bk + group - 1) // group * group * rows * 4
    assert smem(512) == 199_424
    assert smem(640) <= SMEM_OPTIN < smem(641)


# ------------------------------------------------------------ B2, B7

@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("layout,window", [("bshd", None), ("bhsd", 40)])
def test_decode_plain_d128_g4_matches_jax(exp, layout, window):
    """B2's plain sweep at D 128, G 4 (two KV heads), 32-key update
    blocks, ragged cache_len, both layouts, a window cutting the keys,
    against the JAX package's one-pass decode reference."""
    b, hkv, smax = 3, 2, 96
    q, kc, vc = _inputs([(b, 1, hkv * G, D), (b, smax, hkv, D),
                         (b, smax, hkv, D)], seed=26)
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
def test_paged_decode_plain_d128_g4_matches_jax(exp):
    """B7's plain sweep at D 128, G 4: 16-token pages behind a table in
    random order, one update a page."""
    b, hkv, smax, page = 3, 2, 64, 16
    q, kc, vc = _inputs([(b, 1, hkv * G, D), (b, smax, hkv, D),
                         (b, smax, hkv, D)], seed=27)
    cl = np.array([64, 3, 33], np.int32)
    ns = smax // page
    tab = (1 + np.random.default_rng(5).permutation(b * ns)).reshape(
        b, ns).astype(np.int32)
    want = jatt.decode_attention(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                                 exp_impl=exp)
    got = kdec.decode_attention_paged_plain(
        _t(q), _t(_paged(kc, page, tab)), _t(_paged(vc, page, tab)),
        torch.from_numpy(tab), torch.from_numpy(cl), exp_backend=exp)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_plain_d128_matches_pallas_interpret():
    """One small shape through the Pallas decode kernel and its paged
    form (interpret mode): G 4 on two KV heads, ragged cache_len,
    vexp_hw; the contiguous sweep in 32-key blocks, the paged one a
    16-token page at a time."""
    b, hkv, smax, page = 2, 2, 64, 16
    q, kc, vc = _inputs([(b, 1, hkv * G, D), (b, smax, hkv, D),
                         (b, smax, hkv, D)], seed=28)
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
    tab = (1 + np.random.default_rng(6).permutation(b * ns)).reshape(
        b, ns).astype(np.int32)
    kp, vp = _paged(kc, page, tab), _paged(vc, page, tab)
    want = pallas_decode_paged(_j(q), _j(kp), _j(vp), jnp.asarray(tab),
                               jnp.asarray(cl), interpret=True, policy=jpol)
    got = kdec.decode_attention_paged(
        _t(q), _t(kp), _t(vp), torch.from_numpy(tab), torch.from_numpy(cl),
        policy=ExecPolicy(exp_backend="vexp_hw", block_page=page))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_d128_shape_checks_and_scratch():
    """D 128 takes the normalized sweeps at G up to 16 (the chained
    design's rows a KV head) and no partial / packed mode; the scratch
    is the chained layout's: the scores of the rows the sweep computes a
    key (4 at phi3-medium's G 4, the four-row instantiation; 8 at G 5 to
    8, dbrx's 6 among them; 16 from G 9),
    then per row the tile maxes and each update block's p @ v, alpha and
    l."""
    assert D in kdec.HEAD_DIMS and D in kdec.KEY_MAJOR_DIMS
    assert D not in kdec.STAT_HEAD_DIMS and kdec.MAX_GROUP[D] >= G
    kdec._check_shape("t", "normalized", D, 40, 10)
    with pytest.raises(ValueError):
        kdec._check_shape("t", "partial", D, 40, 10)
    with pytest.raises(ValueError):
        kdec._check_shape("t", "normalized", D, 17 * 2, 2)
    b, hkv, keys, block = 8, 10, 2048, 512
    tiles, blocks = keys // 64, keys // block
    for g, rows in ((G, 4), (1, 4), (5, 8), (6, 8), (8, 8), (9, 16),
                    (16, 16)):
        _, n = kdec._split_scratch(torch.empty(b, hkv, g, D), keys, block)
        assert n == b * hkv * (tiles * 64 * rows
                               + g * (tiles + blocks * (D + 2))), g
