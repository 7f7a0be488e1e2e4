"""The numerics of the sequence-split flash-decode sweep, checked on the
CPU with this file's own emulation of its three stages (the package holds
none; the kernels are ``csrc/decode_split.cuh``):

1. scores in 64-key tiles, each tile inside one update block (``block_s``
   keys, or one page), and each tile's max;
2. m_j, the running max after update block j, formed from the maxes of
   every tile of blocks 0..j; per tile p = exp(s - m_j) masked to the
   kept keys, its f32 sum l_t and p (rounded to bf16) @ v;
3. the blocks chained in order: the block's tiles summed in tile order,
   alpha_j = exp(m_{j-1} - m_j), l = l * alpha_j + l_block,
   acc = acc * alpha_j + pv_block; rows with no kept key in a block skip
   it.

What is shown:

* m of the emulation is bitwise the plain sweep's (``_sweep_plain``), in
  the contiguous sweep at ``block_s`` = 128 and the paged sweep at page
  64, partial mode at ``seq_offset`` > 0, with and without a window;
* its normalized output sits inside ``ATT_LIMITS["decode_attention"]`` /
  ``["decode_attention_paged"]`` against ``decode_attention_plain`` /
  ``decode_attention_paged_plain`` under every exp backend, and within
  the cross-framework tolerance of ``tests/test_torch_attention.py``
  against the JAX package's Pallas decode (interpret mode);
* a negative control: the textbook split-KV merge (each tile's own max,
  one exp(m_t - m) per tile) falls outside the vexp_hw limits and outside
  the vexp share limit, since exp(a) * exp(b) != exp(a + b) under the
  approximate exps. The limits see a kernel that merges that way;
* the head-dim-256 decomposition (``sliced_sweep``, recurrentgemma's 16
  query heads on one KV head): each update block chained over its kept
  keys in key order by column slices, one (alpha, l, p @ v) slot per
  block, and a combine per four output columns that reads only those
  columns of each slot. Its m is bitwise the plain sweep's and its
  output sits inside the limits, contiguous (``block_s`` 128) and paged
  (page 64), G 16 and 5, with and without a window;
* the scratch the wrappers size for the kernels (``_split_scratch``), at
  the dense heads' layout and at D 256's.

Inputs are made with numpy from a seed.
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
from repro.runtime import ExecPolicy as JaxPolicy  # noqa: E402
from repro_torch.core.attention import NEG_INF  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels.limits import ATT_LIMITS  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
TILE = 64
SLICES = 4            # decode_split.cuh's column slices a row at D 256
B, HKV, D, S, PAGE = 3, 2, 32, 256, 64
TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)   # test_torch_attention.py's


def _inputs(g, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               [(B, 1, HKV * g, D), (B, S, HKV, D), (B, S, HKV, D)])
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))


def _pool(k, v, seed):
    """k / v (B,S,Hkv,d) cut into pages of a shuffled pool whose page 0
    is the scratch page; returns (k_pool, v_pool, block_tab)."""
    ns = S // PAGE
    perm = np.random.default_rng(seed).permutation(B * ns) + 1
    tab = torch.from_numpy(perm.reshape(B, ns).astype(np.int32))
    pools = []
    for x in (k, v):
        pool = torch.zeros((1 + B * ns, PAGE, HKV, D), dtype=x.dtype)
        pool[tab.reshape(-1).long()] = x.reshape(B * ns, PAGE, HKV, D)
        pools.append(pool)
    return pools[0], pools[1], tab


def _stages(q, k, v, cache_len, seq_offset, *, window, block):
    """Stages 1 and 2 over a bshd cache: per tile (block index, scores
    (B,Hkv,G,n), keep (B,1,1,n), V rows (B,Hkv,n,d)), in tile order, and
    the q rows. Scores are taken per update block, as the plain sweep
    takes them, then cut into tiles."""
    b, _, h, d = q.shape
    g = h // HKV
    kk, vv = k.transpose(1, 2), v.transpose(1, 2)
    smax = kk.shape[2]
    qg = (q.float() * (1.0 / math.sqrt(d))).to(k.dtype).float()
    qg = qg.reshape(b, HKV, g, d)
    cl = torch.as_tensor(cache_len).reshape(-1, 1)
    kpos = seq_offset + torch.arange(smax)[None, :]
    keep = kpos < cl
    if window is not None:
        keep = keep & (kpos >= cl - window)
    bs = min(block, smax)
    tiles = []
    for j, k0 in enumerate(range(0, smax, bs)):
        s = torch.einsum("bkgd,bktd->bkgt", qg, kk[:, :, k0:k0 + bs].float())
        kb = keep[:, None, None, k0:k0 + bs]
        s = torch.where(kb, s, NEG_INF)
        for t0 in range(0, s.shape[-1], TILE):
            sl = slice(t0, t0 + TILE)
            tiles.append((j, s[..., sl], kb[..., sl],
                          vv[:, :, k0 + t0:k0 + t0 + TILE].float()))
    return tiles, keep, bs


def split_sweep(q, k, v, cache_len, seq_offset=0, *, window=None, block,
                exp_backend):
    """The three stages; returns (m, l) (B,Hkv,G) and acc (B,Hkv,G,d)."""
    exp_fn = get_exp_fn(exp_backend)
    tiles, keep, bs = _stages(q, k, v, cache_len, seq_offset, window=window,
                              block=block)
    tmax = [s.amax(-1) for _, s, _, _ in tiles]
    stats = []                                  # (l_t, pv_t) per tile
    for i, (j, s, kb, vt) in enumerate(tiles):
        m_j = torch.stack([tm for (jj, *_), tm in zip(tiles, tmax)
                           if jj <= j]).amax(0)
        p = torch.where(kb, exp_fn(s - m_j[..., None]), 0.0)
        stats.append((p.sum(-1), torch.einsum(
            "bkgt,bktd->bkgd", p.to(k.dtype).float(), vt)))
    m = torch.full_like(tmax[0], NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(stats[0][1])
    for j in sorted({t[0] for t in tiles}):
        idx = [i for i, t in enumerate(tiles) if t[0] == j]
        m_new, lb, pb = m, torch.zeros_like(l), torch.zeros_like(acc)
        for i in idx:
            m_new = torch.maximum(m_new, tmax[i])
            lb = lb + stats[i][0]
            pb = pb + stats[i][1]
        alpha = exp_fn(m - m_new)
        live = keep[:, j * bs:(j + 1) * bs].any(-1)[:, None, None]
        l = torch.where(live, l * alpha + lb, l)
        acc = torch.where(live[..., None], acc * alpha[..., None] + pb, acc)
        m = torch.where(live, m_new, m)
    return m, l, acc


def textbook_sweep(q, k, v, cache_len, seq_offset=0, *, window=None, block,
                   exp_backend):
    """The usual split-KV merge over the same tiles: each tile's p taken
    against its own max, the tiles folded with one exp(m_t - m) each."""
    exp_fn = get_exp_fn(exp_backend)
    tiles, _, _ = _stages(q, k, v, cache_len, seq_offset, window=window,
                          block=block)
    parts = []
    for _, s, kb, vt in tiles:
        m_t = s.amax(-1)
        p = torch.where(kb, exp_fn(s - m_t[..., None]), 0.0)
        parts.append((m_t, p.sum(-1), torch.einsum(
            "bkgt,bktd->bkgd", p.to(k.dtype).float(), vt)))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_t, l_t, pv_t in parts:
        w = exp_fn(m_t - m)
        l = l + w * l_t
        acc = acc + w[..., None] * pv_t
    return m, l, acc


def normalized(q, m_l_acc):
    _, l, acc = m_l_acc
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.reshape(q.shape).to(q.dtype)


def reading(out, ref):
    """(max |out - ref|, share of outputs whose bits differ)."""
    o, r = out.float(), ref.float()
    return float((o - r).abs().max()), float((o != r).double().mean())


def inside(kernel, exp, got):
    lim_err, lim_share = ATT_LIMITS[kernel][exp]
    return got[0] <= lim_err and got[1] <= lim_share


CASES = [  # (G, window, cache_len)
    (1, None, [256, 70, 181]),
    (2, 100, [256, 33, 200]),
]


@pytest.mark.parametrize("g,window", [(1, None), (2, 100)])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_running_max_bitwise_partial(g, window, paged):
    """Partial mode on the slice of global rows [128, 384): one row fills
    it, one ends before it (the merge identity), one is cut by it."""
    q, k, v = _inputs(g, seed=10 + g)
    off = 128
    cache_len = torch.tensor([384, 100, 300], dtype=torch.int32)
    if paged:
        kp, vp, tab = _pool(k, v, seed=3)
        want = kdec.decode_attention_paged_partial_plain(
            q, kp, vp, tab, cache_len, off, window=window,
            exp_backend="vexp")
        block = PAGE
    else:
        want = kdec.decode_attention_partial_plain(
            q, k, v, cache_len, off, window=window, block_s=128,
            exp_backend="vexp")
        block = 128
    m, l, acc = split_sweep(q, k, v, cache_len, off, window=window,
                            block=block, exp_backend="vexp")
    assert torch.equal(m, want[0][..., 0])
    assert bool((m[1] == NEG_INF).all()) and bool((l[1] == 0).all())
    torch.testing.assert_close(l, want[1][..., 0], rtol=1e-5, atol=0)
    torch.testing.assert_close(acc, want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("g,window,lens", CASES)
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_split_inside_limits(exp, g, window, lens, paged):
    q, k, v = _inputs(g, seed=20 + g)
    cache_len = torch.tensor(lens, dtype=torch.int32)
    if paged:
        kp, vp, tab = _pool(k, v, seed=4)
        ref = kdec.decode_attention_paged_plain(
            q, kp, vp, tab, cache_len, window=window, exp_backend=exp)
        kernel, block = "decode_attention_paged", PAGE
    else:
        ref = kdec.decode_attention_plain(q, k, v, cache_len, window=window,
                                          block_s=128, exp_backend=exp)
        kernel, block = "decode_attention", 128
    out = normalized(q, split_sweep(q, k, v, cache_len, window=window,
                                    block=block, exp_backend=exp))
    got = reading(out, ref)
    assert inside(kernel, exp, got), (kernel, exp, got,
                                      ATT_LIMITS[kernel][exp])


@pytest.mark.parametrize("layout,window", [("bshd", None), ("bhsd", 40)])
def test_split_matches_pallas_interpret(layout, window):
    """test_torch_attention.py::test_decode_plain_matches_pallas_interpret's
    case (300-row cache in 128-key blocks, the last one partial, GQA
    groups of 2, vexp_hw) with the emulated split in place of the plain
    version."""
    b, hkv, g, d, smax = 3, 2, 2, 32, 300
    rng = np.random.default_rng(2)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32) for s in
                 [(b, 1, hkv * g, d), (b, smax, hkv, d), (b, smax, hkv, d)])
    cl = np.array([300, 17, 150], np.int32)
    jk, jv = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
    if layout == "bhsd":
        jk, jv = jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3)
    want = pallas_decode(jnp.asarray(q, jnp.bfloat16), jk, jv,
                         jnp.asarray(cl), window=window, layout=layout,
                         interpret=True,
                         policy=JaxPolicy(exp_backend="vexp_hw",
                                          kernel_backend="pallas",
                                          block_s=128, interpret=True))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (q, kc, vc))
    got = normalized(tq, split_sweep(tq, tk, tv, torch.from_numpy(cl),
                                     window=window, block=128,
                                     exp_backend="vexp_hw"))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL)


@pytest.mark.parametrize("exp", ["vexp", "vexp_hw"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_textbook_merge_outside_limits(exp, paged):
    g, window, lens = CASES[0]
    q, k, v = _inputs(g, seed=30)
    cache_len = torch.tensor(lens, dtype=torch.int32)
    if paged:
        kp, vp, tab = _pool(k, v, seed=5)
        ref = kdec.decode_attention_paged_plain(
            q, kp, vp, tab, cache_len, window=window, exp_backend=exp)
        kernel, block = "decode_attention_paged", PAGE
    else:
        ref = kdec.decode_attention_plain(q, k, v, cache_len, window=window,
                                          block_s=128, exp_backend=exp)
        kernel, block = "decode_attention", 128
    out = normalized(q, textbook_sweep(q, k, v, cache_len, window=window,
                                       block=block, exp_backend=exp))
    got = reading(out, ref)
    assert not inside(kernel, exp, got), got
    if exp == "vexp":
        assert got[1] > ATT_LIMITS[kernel][exp][1], got
    # the same tiles merged at the running max stay inside
    split = normalized(q, split_sweep(q, k, v, cache_len, window=window,
                                      block=block, exp_backend=exp))
    assert inside(kernel, exp, reading(split, ref))


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_d256_g16_plain_matches_jax(exp, paged):
    """recurrentgemma's decode shape (D 256, 16 query heads on one KV head)
    over a 256-row cache, a window of 150 cutting the keys: the plain
    sweeps (contiguous in 128-key blocks, paged per 64-key page), which
    the D 256 kernels are held to bit for bit on the card, against the
    JAX package's one-pass decode reference within the cross-framework
    tolerance."""
    d, g = 256, 16
    rng = np.random.default_rng(40)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in
               [(B, 1, g, d), (B, S, 1, d), (B, S, 1, d)])
    cache_len = torch.tensor([256, 40, 199], dtype=torch.int32)
    window = 150
    want = jatt.decode_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(cache_len.numpy()), window=window, exp_impl=exp)
    if paged:
        ns = S // PAGE
        tab = torch.from_numpy(np.random.default_rng(41).permutation(
            B * ns).reshape(B, ns).astype(np.int32) + 1)
        pools = []
        for x in (k, v):
            pool = torch.zeros((1 + B * ns, PAGE, 1, d), dtype=x.dtype)
            pool[tab.reshape(-1).long()] = x.reshape(B * ns, PAGE, 1, d)
            pools.append(pool)
        ref = kdec.decode_attention_paged_plain(q, *pools, tab, cache_len,
                                                window=window,
                                                exp_backend=exp)
    else:
        ref = kdec.decode_attention_plain(q, k, v, cache_len, window=window,
                                          block_s=128, exp_backend=exp)
    np.testing.assert_allclose(ref.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL)


def sliced_sweep(q, k, v, cache_len, *, window=None, block, exp_backend):
    """The head-dim-256 sweep of ``csrc/decode_split.cuh``: stage 1's
    scores and tile maxes (64-key tiles inside each update block); per
    update block
    j, m_j from the tile maxes of blocks 0..j, alpha_j = exp(m_{j-1} -
    m_j), p = exp(s - m_j) on the kept keys, and the block's l and p @ v
    chained over its kept keys in key order from 0, into one slot a block
    (a block without a kept key in a row leaves that row's slot unused),
    each column slice's p @ v on its own; then per four output columns
    the blocks chained in order over those columns of each slot. Returns
    (m, l, acc) and the normalized output (B,1,H,d)."""
    exp_fn = get_exp_fn(exp_backend)
    b, _, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    kk, vv = k.transpose(1, 2).float(), v.transpose(1, 2).float()
    smax = kk.shape[2]
    qg = (q.float() * (1.0 / math.sqrt(d))).to(k.dtype).float()
    qg = qg.reshape(b, hkv, g, d)
    cl = torch.as_tensor(cache_len).reshape(-1, 1)
    kpos = torch.arange(smax)[None, :]
    keep = kpos < cl
    if window is not None:
        keep = keep & (kpos >= cl - window)
    bs = min(block, smax)
    m_prev = torch.full((b, hkv, g), NEG_INF)
    slots = []                                # (live, alpha, l_j, pv_j)
    for k0 in range(0, smax, bs):
        kb = keep[:, k0:k0 + bs]
        # the block's scores as the plain sweep takes them (key-major; on
        # the card the kernel's chain over d is that product's order)
        s = (kk[:, :, k0:k0 + bs].contiguous()
             @ qg.transpose(-1, -2)).transpose(-1, -2)
        s = torch.where(kb[:, None, None], s, NEG_INF)
        tile_max = torch.stack([s[..., t:t + TILE].amax(-1)
                                for t in range(0, s.shape[-1], TILE)])
        m_j = torch.maximum(m_prev, tile_max.amax(0))
        alpha = exp_fn(m_prev - m_j)
        p = torch.where(kb[:, None, None], exp_fn(s - m_j[..., None]), 0.0)
        pr = p.to(k.dtype).float()
        l_j = torch.zeros_like(m_j)
        pv_j = torch.zeros((b, hkv, g, d))
        sc = d // SLICES
        for c in range(s.shape[-1]):
            kc = kb[:, c][:, None, None]
            l_j = torch.where(kc, l_j + p[..., c], l_j)
            for sl in range(SLICES):
                cols = slice(sl * sc, (sl + 1) * sc)
                pv_j[..., cols] = torch.where(
                    kc[..., None], pv_j[..., cols] + pr[..., c, None]
                    * vv[:, :, None, k0 + c, cols], pv_j[..., cols])
        slots.append((kb.any(-1)[:, None, None], alpha, l_j, pv_j))
        m_prev = m_j
    out = torch.empty((b, hkv, g, d))
    for c4 in range(0, d, 4):
        cols = slice(c4, c4 + 4)
        l = torch.zeros((b, hkv, g))
        acc = torch.zeros((b, hkv, g, 4))
        for live, alpha, l_j, pv_j in slots:
            l = torch.where(live, l * alpha + l_j, l)
            acc = torch.where(live[..., None],
                              acc * alpha[..., None] + pv_j[..., cols], acc)
        out[..., cols] = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    full = torch.zeros((b, hkv, g, d))
    for live, alpha, _, pv_j in slots:
        full = torch.where(live[..., None], full * alpha[..., None] + pv_j,
                           full)
    return (m_prev, l, full), out.reshape(q.shape).to(q.dtype)


D256_CASES = [  # (window, cache_len): block starts, block ends and one key
    (None, [256, 65, 129]),
    (100, [200, 1, 181]),     # first kept keys mid-block (100, 81)
]


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("g", [16, 5])
@pytest.mark.parametrize("window,lens", D256_CASES)
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_d256_sliced_sweep_inside_limits(exp, g, window, lens, paged):
    """The D 256 decomposition over a 256-row ring of one KV head: m
    bitwise the plain sweep's, l and acc within f32 rounding of it, the
    normalized output inside the kernel's ATT_LIMITS."""
    d = 256
    rng = np.random.default_rng(50 + g)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in
               [(B, 1, g, d), (B, S, 1, d), (B, S, 1, d)])
    cache_len = torch.tensor(lens, dtype=torch.int32)
    if paged:
        ns = S // PAGE
        tab = torch.from_numpy(np.random.default_rng(51).permutation(
            B * ns).reshape(B, ns).astype(np.int32) + 1)
        pools = []
        for x in (k, v):
            pool = torch.zeros((1 + B * ns, PAGE, 1, d), dtype=x.dtype)
            pool[tab.reshape(-1).long()] = x.reshape(B * ns, PAGE, 1, d)
            pools.append(pool)
        ref = kdec.decode_attention_paged_plain(q, *pools, tab, cache_len,
                                                window=window,
                                                exp_backend=exp)
        kk = kdec.paged_gather(pools[0], tab)
        vv = kdec.paged_gather(pools[1], tab)
        kernel, block = "decode_attention_paged", PAGE
    else:
        ref = kdec.decode_attention_plain(q, k, v, cache_len, window=window,
                                          block_s=128, exp_backend=exp)
        kk, vv = k, v
        kernel, block = "decode_attention", 128
    assert torch.equal(kk, k) and torch.equal(vv, v)
    (m, l, acc), out = sliced_sweep(q, k, v, cache_len, window=window,
                                    block=block, exp_backend=exp)
    want = kdec._sweep_plain(q, kk, vv, cache_len, 0, window=window,
                             sm_scale=None, layout="bshd", block_s=block,
                             exp_backend=exp)
    assert torch.equal(m, want[0])
    torch.testing.assert_close(l, want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(acc, want[2], rtol=1e-5, atol=1e-5)
    got = reading(out, ref)
    assert inside(kernel, exp, got), (kernel, exp, got,
                                      ATT_LIMITS[kernel][exp])


@pytest.mark.parametrize("shape,keys,block,n", [
    # gpt2-small's decode: 2 blocks of 512 keys, 16 tiles a row, the dense
    # heads' layout B*Hkv*(G*nT*(64 + 3 + D) + 1)
    ((8, 12, 1, 64), 1024, 512, 96 * (16 * 131 + 1)),
    # recurrentgemma's ring at block_s 512: nT 32, nB 4, scores for 16
    # query rows a key, then per block p @ v, alpha and l:
    # B*Hkv*(nT*64*16 + G*(nT + nB*(D + 2)))
    ((8, 1, 16, 256), 2048, 512, 8 * (32 * 64 * 16 + 16 * (32 + 4 * 258))),
    # and paged, one update block a 64-key page: nT = nB = 32
    ((8, 1, 16, 256), 2048, 64, 8 * (32 * 64 * 16 + 16 * (32 + 32 * 258))),
    # G 5 over a 256-key ring at block_s 128: nT 4, nB 2
    ((1, 1, 5, 256), 256, 128, 4 * 64 * 16 + 5 * (4 + 2 * 258)),
    # phi3-medium's decode at head dim 128, G 4: the four-row
    # instantiation, scores for 4 query rows a key (not 16), block_s 512
    ((8, 10, 4, 128), 2048, 512, 80 * (32 * 64 * 4 + 4 * (32 + 4 * 130))),
    # and paged, page 64
    ((8, 10, 4, 128), 2048, 64, 80 * (32 * 64 * 4 + 4 * (32 + 32 * 130))),
    # dbrx-132b's decode at head dim 128, G 6: the eight-row
    # instantiation, scores for 8 query rows a key, block_s 512 and page 64
    ((8, 8, 6, 128), 2048, 512, 64 * (32 * 64 * 8 + 6 * (32 + 4 * 130))),
    ((8, 8, 6, 128), 2048, 64, 64 * (32 * 64 * 8 + 6 * (32 + 32 * 130))),
])
def test_split_scratch_length(shape, keys, block, n):
    buf, got = kdec._split_scratch(torch.empty(shape), keys, block)
    assert got == n and buf.numel() == n and buf.dtype == torch.float32
