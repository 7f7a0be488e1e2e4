"""The head-dim-128 partitions of FlashAttention and flash-decode at
phi3-medium's 4 and dbrx's 6 query heads a KV head, checked on the CPU
with this file's own emulations of them (the kernels are ``fa_rows<128>``
in ``csrc/flash_attention.cu`` and the four- and eight-row instantiations
of ``csrc/decode_split.cuh``; the package holds no emulation):

FlashAttention, ``fa_rows<128>``:

* a CTA takes 64 query rows of one KV head, rows being (position, query
  head) pairs, position-major (at G 4: sixteen positions of 4 heads); its
  KV blocks are counted from key 0 in units of ``block_k`` and walked from
  the window's first key to the causal bound or ``kv_len``;
* a block's live keys go in 32-key groups counted from the block's start,
  scored in pieces of up to eight groups (``piece``), each score one FMA
  chain over d = 0 .. 127 in 16-d slabs; keys past the block's bound are
  zero-filled and masked, and a group kept whole for every row skips the
  mask;
* the block's max over kept keys, alpha, p = exp(s - m_new) masked after
  the exp; p . v one FMA chain over the block's live keys in order, in V
  slabs of a whole 32-key group (one barrier and one V copy a group on
  the card), and the block's l one chain of f32 adds over the same keys
  in order; then the one online update.

Flash-decode at head dim 128 and G <= 8 (``chain_rows`` 4 at G <= 4, 8
at G 5 to 8):

1. scores for the G rows only, a 64-key tile at a time inside each update
   block (``[key][4]`` or ``[key][8]`` in scratch, written by stage 1's
   warps: a row each at four rows, two adjacent rows each at eight, a
   warp whose rows are past G idle), and each tile's max over its kept
   keys;
2. per update block j (one CTA on the card, all 128 columns): m_{j-1} and
   m_j from the tile maxes of blocks 0..j-1 and 0..j, alpha_j = exp(m_{j-1}
   - m_j), p = exp(s - m_j) on the kept keys (a chain thread's (key, row)
   pairs at flat indices tid + 128 u of the tile's scores), rounded to
   bf16 for p @ v; each (row, column) of p @ v one FMA chain over the
   block's kept keys in key order from +0.0, tile by tile (R rows a
   column: 4, or 6 at G 5 and 6, 8 at G 7 and 8), and each row's l one
   chain of f32 adds of the unrounded p beside it (lane g reads row g & (PS
   - 1)); a block with no kept key leaves its slot unused;
3. per four output columns the blocks chained in order: l = l alpha_j +
   l_j, acc = acc alpha_j + pv_j, rounded step by step.

What is shown: each emulation equals, bit for bit, the unpartitioned
sweep written with the same chains (every key of every block, masked; the
decode's m is also bitwise the plain sweep's); it sits inside
``ATT_LIMITS`` against the plain version under every exp backend, ragged
rows, a (B,) q_offset, a window cutting the decode's keys, G 2 and 4 and
G 5 to 8 (rows past G written by no one); and the plain version at half
the block falls outside the limits under vexp and vexp_hw. Inputs are
made with numpy from a seed. Also the order of stage 2's V copies on the
card (a ring of up to four tile buffers, a page of 64 keys one): every
live tile of a block is read after its copy has landed, at one to eight
tiles a block, with room for three CTAs an SM at each tier; and the
wrapper's tiers and scratch length are the kernel's.
"""

import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.attention import NEG_INF  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels.limits import ATT_LIMITS  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
D, G, HKV = 128, 4, 2
ROWS, GROUP, SUBGROUPS, SLAB_D = 64, 32, 8, 16
V_KEYS = GROUP                  # fa_rows<128>'s V slab: a whole group
TILE = 64                       # decode_split.cuh's tile


def fma(acc, a, b):
    """f32 fmaf: the product of two f32 is exact in float64, and so is
    its sum with an f32 but for a tie at the f32 rounding (not met
    here)."""
    return (acc.double() + a.double() * b.double()).float()


def keep_key(kp, qp, km, causal, window):
    ok = kp < km
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok


def piece(rem):
    """Groups of the next score piece: 8, or 4 when 5 or 6 are left, else
    all that are left."""
    return SUBGROUPS if rem >= SUBGROUPS else 4 if rem in (5, 6) else rem


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The chains are thousands of small ops: one thread each, so that
    test workers sharing the host do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reading(out, ref, real=None):
    o, r = out.float(), ref.float()
    if real is not None:
        sel = real.expand_as(o)
        o, r = o[sel], r[sel]
    return float((o - r).abs().max()), float((o != r).double().mean())


def inside(kernel, exp, got):
    lim_err, lim_share = ATT_LIMITS[kernel][exp]
    return got[0] <= lim_err and got[1] <= lim_share


# ------------------------------------------------------------ FA, D 128

def score_chains(q, k):
    """Every score as the kernel forms it: q * sm_scale rounded, then one
    FMA chain over d = 0 .. 127 from 0; (B, Hkv, G, Sq, Sk)."""
    b_, sq, h, d = q.shape
    hkv = k.shape[2]
    qs = (q.float() * torch.tensor(1.0 / math.sqrt(d))).reshape(
        b_, sq, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    ks = k.float().permute(0, 2, 1, 3)[:, :, None, None]   # b k 1 1 t d
    s = torch.zeros(b_, hkv, h // hkv, sq, k.shape[1])
    for dd in range(d):
        s = fma(s, qs[..., dd, None], ks[..., dd])
    return s


def fa128_emulate(q, k, v, *, kv_len, q_offset, causal, window, block_k,
                  exp_backend, scores):
    """fa_rows<128>'s partition of the work, CTA by CTA (the tiles of a
    batch row from the last position down), on ``score_chains``' scores.
    Returns (output, {"ctas", "groups", "v_slabs"})."""
    exp_fn = get_exp_fn(exp_backend)
    b_, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g_ = h // hkv
    nrows = sq * g_
    ntiles = (nrows + ROWS - 1) // ROWS
    out = torch.zeros(b_, sq, h, d, dtype=q.dtype)
    stats = {"ctas": 0, "groups": 0, "v_slabs": 0}
    for b in range(b_):
        klen, qoff = min(int(kv_len[b]), sk), int(q_offset[b])
        for hk in range(hkv):
            for tile in reversed(range(ntiles)):
                stats["ctas"] += 1
                r0 = tile * ROWS
                rows = r0 + torch.arange(ROWS)
                real = rows < nrows
                qp = qoff + rows // g_
                p_lo = qoff + r0 // g_
                p_hi = qoff + (min(r0 + ROWS, nrows) - 1) // g_
                kend = min(klen, p_hi + 1) if causal else klen
                kstart = max(0, p_lo - window + 1) if window > 0 else 0
                pos = torch.clamp(rows // g_, max=sq - 1)   # dead rows: any
                srows = scores[b, hk, rows % g_, pos]          # (64, Sk)
                m_run = torch.full((ROWS,), NEG_INF)
                l_run = torch.zeros(ROWS)
                acc = torch.zeros(ROWS, d)
                for blk in range(kstart // block_k,
                                 (kend + block_k - 1) // block_k):
                    k0 = blk * block_k
                    lo, hi = max(kstart, k0), min(k0 + block_k, kend)
                    if lo >= hi:
                        continue
                    g_lo = (lo - k0) // GROUP
                    g_hi = (hi - k0 + GROUP - 1) // GROUP
                    km = min(k0 + block_k, kend)
                    keys = k0 + torch.arange(g_lo * GROUP, g_hi * GROUP)
                    ok = keys < km                   # zero-filled past km
                    vv = torch.zeros(len(keys), d)
                    vv[ok] = v[b, keys[ok], hk].float()
                    s = torch.zeros(ROWS, len(keys))
                    gs = g_lo
                    while gs < g_hi:                 # score pieces
                        n = piece(g_hi - gs)
                        c = slice((gs - g_lo) * GROUP,
                                  (gs - g_lo + n) * GROUP)
                        s[:, c] = torch.where(
                            ok[None, c], srows[:, keys[c].clamp(max=sk - 1)],
                            0.0)
                        gs += n
                    keep = torch.ones(ROWS, len(keys), dtype=torch.bool)
                    for g in range(g_lo, g_hi):      # the mask, skipped for
                        stats["groups"] += 1         # groups kept whole
                        a = k0 + g * GROUP
                        inner = (a + GROUP <= km
                                 and (not causal or a + GROUP - 1 <= p_lo)
                                 and (window <= 0 or a > p_hi - window))
                        if not inner:
                            c = slice((g - g_lo) * GROUP,
                                      (g - g_lo + 1) * GROUP)
                            keep[:, c] = keep_key(keys[None, c], qp[:, None],
                                                  km, causal, window)
                    mx = torch.where(keep, s, NEG_INF).amax(-1)
                    m_new = torch.maximum(m_run, mx)
                    alpha = exp_fn(m_run - m_new)
                    m_run = m_new
                    p = torch.where(keep, exp_fn(s - m_new[:, None]), 0.0)
                    pv = torch.zeros(ROWS, d)
                    lch = torch.zeros(ROWS)
                    for v0 in range(0, len(keys), V_KEYS):   # V slabs
                        stats["v_slabs"] += 1
                        for c in range(v0, v0 + V_KEYS):
                            pv = fma(pv, p[:, c, None], vv[None, c])
                            lch = lch + p[:, c]
                    l_run = l_run * alpha + lch
                    acc = acc * alpha[:, None] + pv
                o = acc * (1.0 / torch.clamp(l_run, min=1e-30))[:, None]
                r = rows[real]
                out[b, r // g_, hk * g_ + r % g_] = o[real].to(q.dtype)
    return out, stats


def fa_chain_reference(q, k, v, *, kv_len, q_offset, causal, window,
                       block_k, exp_backend, scores):
    """The l-chain scan (``_attention_flash_l_chain``) written with the
    kernel's chains and no partition: every key of every block, masked."""
    exp_fn = get_exp_fn(exp_backend)
    b_, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g_ = h // hkv
    qpos = (torch.arange(sq)[None, :]
            + torch.as_tensor(q_offset).reshape(-1, 1))[:, None, None, :,
                                                          None]
    m = torch.full((b_, hkv, g_, sq), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b_, hkv, g_, sq, d)
    klen = torch.clamp(torch.as_tensor(kv_len), max=sk)
    for k0 in range(0, sk, block_k):
        vb = v[:, k0:k0 + block_k].float().permute(0, 2, 1, 3)
        bk = vb.shape[2]
        s = scores[..., k0:k0 + bk]
        kpos = k0 + torch.arange(bk)
        keep = keep_key(kpos, qpos, klen.reshape(-1, 1, 1, 1, 1), causal,
                        window or 0)
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = exp_fn(m - m_new)
        p = torch.where(keep, exp_fn(s - m_new[..., None]), 0.0)
        pv = torch.zeros_like(acc)
        lch = torch.zeros_like(l)
        for c in range(bk):
            pv = fma(pv, p[..., c, None], vb[:, :, None, None, c])
            lch = lch + p[..., c]
        l = l * alpha + lch
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b_, sq, h, d).to(q.dtype)


# name -> (B, Sq, Sk, kv_len, q_offset, block_k); Sq * 4 rows is never a
# whole number of 64-row tiles
FA_CASES = {
    # ragged prefill: a row of one key, a full row, one mid-block; 48-key
    # blocks (a group and a half)
    "prefill": (3, 45, 96, [1, 96, 61], [0, 0, 0], 48),
    # chunk at (B,) offsets: a row whose last query is the last key, a
    # row of no token (kv_len 0), one crossing blocks; 64-key blocks
    "chunk": (4, 23, 160, [23, 160, 70, 0], [0, 137, 60, 0], 64),
}
_FA_EMU, _FA_SCORES = {}, {}


def _fa_inputs(case):
    b, sq, sk = FA_CASES[case][:3]
    rng = np.random.default_rng(sum(map(ord, case)) + 128)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               [(b, sq, HKV * G, D), (b, sk, HKV, D), (b, sk, HKV, D)])
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))


def _fa_kw(case, exp):
    _, _, _, kv_len, q_off, bk = FA_CASES[case]
    return dict(kv_len=torch.tensor(kv_len, dtype=torch.int32),
                q_offset=torch.tensor(q_off, dtype=torch.int32), causal=True,
                window=0, block_k=bk, exp_backend=exp)


def _fa_scores(case):
    if case not in _FA_SCORES:
        q, k, _ = _fa_inputs(case)
        _FA_SCORES[case] = score_chains(q, k)
    return _FA_SCORES[case]


def _fa_emulated(case, exp):
    if (case, exp) not in _FA_EMU:
        _FA_EMU[case, exp] = fa128_emulate(*_fa_inputs(case),
                                           scores=_fa_scores(case),
                                           **_fa_kw(case, exp))
    return _FA_EMU[case, exp]


def _fa_plain(case, exp, block_k=None):
    kw = _fa_kw(case, exp)
    q, k, v = _fa_inputs(case)
    return kfa.flash_attention_plain(
        q, k, v, causal=True, kv_len=kw["kv_len"], q_offset=kw["q_offset"],
        block_k=block_k or kw["block_k"], exp_backend=exp)


def _fa_real(case):
    b, sq, sk, kv_len, q_off, bk = FA_CASES[case]
    qpos = torch.arange(sq)[None, :] + torch.tensor(q_off)[:, None]
    return (qpos < torch.tensor(kv_len)[:, None])[:, :, None, None]


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_fa128_emulation_equals_chain_reference(case, exp):
    """The partition (tiles of sixteen positions, skipped blocks and
    groups, zero-filled keys, unmasked whole groups, whole-group V slabs,
    l beside p . v) changes no bit of any output, dead rows included."""
    out, stats = _fa_emulated(case, exp)
    ref = fa_chain_reference(*_fa_inputs(case), scores=_fa_scores(case),
                             **_fa_kw(case, exp))
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert stats["groups"] == stats["v_slabs"] > 0
    assert D in kfa.L_CHAIN_DIMS


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_fa128_emulation_inside_the_limits(case, exp):
    out, _ = _fa_emulated(case, exp)
    got = reading(out, _fa_plain(case, exp), _fa_real(case))
    assert inside("flash_attention", exp, got), got


@pytest.mark.parametrize("exp", ("vexp", "vexp_hw"))
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_fa128_half_block_outside_the_limits(case, exp):
    """The plain version updating twice a block: the limits see a kernel
    with the wrong partition."""
    bk = FA_CASES[case][-1]
    got = reading(_fa_plain(case, exp, bk // 2), _fa_plain(case, exp),
                  _fa_real(case))
    assert not inside("flash_attention", exp, got), got


# ------------------------------------------------- decode, D 128, G <= 4

B, S, PAGE, BLOCK = 3, 256, 64, 128


def _dec_inputs(g, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               [(B, 1, HKV * g, D), (B, S, HKV, D), (B, S, HKV, D)])
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))


def _dec_scores(q, k):
    """Every score as stage 1 forms it: q * sm_scale rounded to bf16, then
    one FMA chain over d from 0; (B, Hkv, G, S)."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    qg = (q.float() * (1.0 / math.sqrt(d))).to(k.dtype).float()
    qg = qg.reshape(b, hkv, h // hkv, d)
    kk = k.float().permute(0, 2, 1, 3)[:, :, None]           # b k 1 s d
    s = torch.zeros(b, hkv, h // hkv, k.shape[1])
    for dd in range(d):
        s = fma(s, qg[..., dd, None], kk[..., dd])
    return s


def _kept(cache_len, window):
    cl = torch.as_tensor(cache_len).reshape(-1, 1)
    kpos = torch.arange(S)[None, :]
    keep = kpos < cl
    if window is not None:
        keep = keep & (kpos >= cl - window)
    return keep                                              # (B, S)


@functools.lru_cache(maxsize=None)
def _cuh_const(name):
    """An int constant of decode_split.cuh (``constexpr int name = N;``)."""
    src = (Path(kdec.__file__).resolve().parents[1] / "csrc"
           / "decode_split.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def chain_tier(g):
    """``launch`` in decode_split.cuh at head dim 128: (the scores' rows a
    key, chain_rows; the rows stage 2 chains, split_pv_rows' R, or None
    on the sixteen-row path) for ``g`` query heads a KV head."""
    g4, g8, g16 = (_cuh_const(n) for n in ("kChainG4", "kChainG8",
                                           "kChainG"))
    if g <= g4:
        return g4, g4
    if g <= g8:
        return g8, 6 if g <= _cuh_const("kChainG6") else g8
    return g16, None


def score_warp_rows(quarter, maxg, g):
    """The rows split_scores_rows' warp ``quarter`` chains: at eight rows
    two adjacent rows, those past G skipped; else maxg / 4 rows quarter,
    quarter + 4, ... (rows past G chained, not written)."""
    rpt = maxg // 4
    if maxg == 8:
        return [r for r in (rpt * quarter, rpt * quarter + 1) if r < g]
    return [quarter + 4 * i for i in range(rpt)]


def rows_sweep(q, k, v, cache_len, *, window, block, exp_backend, scores):
    """The four- and eight-row sweeps' three stages (tiles, one CTA a
    block, the combine per four columns), with the kernels' layouts:
    stage 1's warps write the scores of their rows < G to a tile of
    scratch [key][PS] (the rest stays NaN, as uninitialised scratch),
    stage 2's chain threads take (key, row) pairs at flat indices tid + u
    * 128 of it, write p to [key][PS] buffers, R chains a column read rows
    0 .. R - 1 of a key, and the l warp's lane reads row lane & (PS - 1).
    Returns ((m, l, acc), output, stats)."""
    exp_fn = get_exp_fn(exp_backend)
    b, _, h, d = q.shape
    g = h // HKV
    ps, r = chain_tier(g)
    assert r is not None and g <= r <= ps and kdec._chain_rows(d, g) == ps
    chain, per = 128, ps * TILE // 128          # kRowsChain, PER
    flat = torch.arange(chain)[:, None] + chain * torch.arange(per)[None]
    flat = flat.reshape(-1)                     # every pair, once
    assert torch.equal(flat.sort().values, torch.arange(TILE * ps))
    p_key, p_row = flat // ps, flat % ps
    lane_row = torch.arange(32) & (ps - 1)
    vv = v.float().permute(0, 2, 1, 3)                       # b k s d
    keep = _kept(cache_len, window)
    bs = min(block, S)
    nb = -(-S // bs)
    written = sorted(x for qq in range(4)
                     for x in score_warp_rows(qq, ps, g) if x < g)
    s1_rows = sum(len(score_warp_rows(qq, ps, g)) for qq in range(4))
    stats = {"blocks": 0, "tiles": 0, "written": written,
             "s1_rows": s1_rows, "s2_rows": r}
    # stage 1: each 64-key tile of each update block, its max over kept
    # keys (-1e30 where it keeps none)
    s = torch.where(keep[:, None, None], scores, NEG_INF)
    tmax = []                                    # per block: [(B,Hkv,G)]
    for j in range(nb):
        tmax.append([s[..., t:min(t + TILE, (j + 1) * bs, S)].amax(-1)
                     for t in range(j * bs, min((j + 1) * bs, S), TILE)])
    slots = []
    for j in range(nb):
        live = keep[:, j * bs:(j + 1) * bs].any(-1)[:, None, None]
        before = torch.full((b, HKV, g), NEG_INF)
        for t in [t for jj in range(j) for t in tmax[jj]]:
            before = torch.maximum(before, t)
        m_j = before
        for t in tmax[j]:
            m_j = torch.maximum(m_j, t)
        alpha = exp_fn(before - m_j)
        m_pair = torch.zeros((b, HKV, ps))
        m_pair[..., :g] = m_j                    # m_g, 0 past G
        acc = torch.zeros((b, HKV, r, d))
        lsum = torch.zeros((b, HKV, 32))
        if live.any():
            stats["blocks"] += int(live.sum()) * HKV
        for t0 in range(j * bs, min((j + 1) * bs, S), TILE):
            stats["tiles"] += 1
            kend = min(t0 + TILE, (j + 1) * bs, S)
            tile = torch.full((b, HKV, TILE, ps), float("nan"))
            tile[:, :, :kend - t0, written] = s[..., written, t0:kend] \
                .transpose(-1, -2)
            tile = tile.reshape(b, HKV, TILE * ps)
            kp = t0 + p_key
            kept = (kp < kend) & keep[:, kp.clamp(max=S - 1)]
            grow = (p_row < g)[None] & kept                  # (B, pairs)
            sv = torch.where(grow[:, None], tile[..., flat], 0.0)
            e = exp_fn(sv - m_pair[..., p_row])
            pu = torch.full((b, HKV, TILE * ps), float("nan"))
            pu[..., flat] = torch.where(grow[:, None], e, 0.0)
            pr = pu.to(torch.bfloat16).float()
            pu, pr = pu.reshape(b, HKV, TILE, ps), pr.reshape(b, HKV, TILE,
                                                              ps)
            for c in range(kend - t0):
                kc = keep[:, t0 + c][:, None, None]
                acc = torch.where(kc[..., None],
                                  fma(acc, pr[:, :, c, :r, None],
                                      vv[:, :, None, t0 + c]), acc)
                lsum = torch.where(kc, lsum + pu[:, :, c, lane_row], lsum)
        slots.append((live, alpha, lsum[..., :g], acc[:, :, :g]))
    out = torch.empty((b, HKV, g, d))
    for c4 in range(0, d, 4):                    # the combine
        cols = slice(c4, c4 + 4)
        l = torch.zeros((b, HKV, g))
        acc = torch.zeros((b, HKV, g, 4))
        for live, alpha, l_j, pv_j in slots:
            l = torch.where(live, l * alpha + l_j, l)
            acc = torch.where(live[..., None],
                              acc * alpha[..., None] + pv_j[..., cols], acc)
        out[..., cols] = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    full = torch.zeros((b, HKV, g, d))
    for live, alpha, _, pv_j in slots:
        full = torch.where(live[..., None], full * alpha[..., None] + pv_j,
                           full)
    return (m_j, l, full), out.reshape(q.shape).to(q.dtype), stats


def dec_chain_reference(q, k, v, cache_len, *, window, block, exp_backend,
                        scores):
    """The plain sweep's function written with the kernel's chains and no
    partition: every key of every block, masked, one online update a
    block."""
    exp_fn = get_exp_fn(exp_backend)
    b, _, h, d = q.shape
    g = h // HKV
    vv = v.float().permute(0, 2, 1, 3)
    keep = _kept(cache_len, window)
    m = torch.full((b, HKV, g), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, HKV, g, d))
    for k0 in range(0, S, block):
        kb = keep[:, None, None, k0:k0 + block]
        s = torch.where(kb, scores[..., k0:k0 + block], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = exp_fn(m - m_new)
        pv = torch.zeros_like(acc)
        lb = torch.zeros_like(l)
        for c in range(s.shape[-1]):
            p = torch.where(kb[..., c], exp_fn(s[..., c] - m_new), 0.0)
            pv = fma(pv, p.to(torch.bfloat16).float()[..., None],
                     vv[:, :, None, k0 + c])
            lb = lb + p
        l = l * alpha + lb
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.reshape(q.shape).to(q.dtype)


DEC_CASES = [  # (window, cache_len): block starts, block ends and one key
    (None, [256, 65, 129]),
    (100, [200, 1, 181]),     # first kept keys mid-block (100, 81)
]


def _dec_plain(q, k, v, cache_len, window, exp, paged, block):
    if not paged:
        return kdec.decode_attention_plain(q, k, v, cache_len, window=window,
                                           block_s=block, exp_backend=exp)
    ns = S // PAGE
    tab = torch.from_numpy(np.random.default_rng(61).permutation(
        B * ns).reshape(B, ns).astype(np.int32) + 1)
    pools = []
    for x in (k, v):
        pool = torch.zeros((1 + B * ns, PAGE, HKV, D), dtype=x.dtype)
        pool[tab.reshape(-1).long()] = x.reshape(B * ns, PAGE, HKV, D)
        pools.append(pool)
    assert torch.equal(kdec.paged_gather(pools[0], tab), k)
    if block != PAGE:                   # the half-page control
        return kdec.decode_attention_plain(q, k, v, cache_len, window=window,
                                           block_s=block, exp_backend=exp)
    return kdec.decode_attention_paged_plain(q, *pools, tab, cache_len,
                                             window=window, exp_backend=exp)


# the rows-a-KV-head cases of the four- and eight-row tiers beside their
# pools: the ids of G 4 (the tier's first cases) are the pools' alone
TIER_CASES = [(paged, 4) for paged in (False, True)] + [
    (paged, g) for g in (5, 6, 7, 8) for paged in (False, True)]
TIER_IDS = [("paged" if paged else "contig") + ("" if g == 4 else f"-g{g}")
            for paged, g in TIER_CASES]


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("g", [4, 2, 5, 6, 7, 8])
@pytest.mark.parametrize("window,lens", DEC_CASES)
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_rows4_sweep(exp, g, window, lens, paged):
    """The four-row sweep (G 2, 4) and the eight-row one (G 5 to 8),
    contiguous (128-key update blocks of two tiles) and paged (one update
    a 64-key page): bit for bit the unpartitioned chain, m bitwise the
    plain sweep's, the output inside the kernel's ATT_LIMITS against its
    plain version; stage 1 writes every row below G once, and at eight
    rows chains no row past G, and stage 2 chains six rows at G 5 and 6
    and eight at G 7 and 8."""
    q, k, v = _dec_inputs(g, 70 + g)
    cache_len = torch.tensor(lens, dtype=torch.int32)
    block = PAGE if paged else BLOCK
    scores = _dec_scores(q, k)
    (m, _, _), out, stats = rows_sweep(q, k, v, cache_len, window=window,
                                       block=block, exp_backend=exp,
                                       scores=scores)
    ref = dec_chain_reference(q, k, v, cache_len, window=window,
                              block=block, exp_backend=exp, scores=scores)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    want = kdec._sweep_plain(q, k, v, cache_len, 0, window=window,
                             sm_scale=None, layout="bshd", block_s=block,
                             exp_backend=exp)
    assert torch.equal(m, want[0])
    assert stats["tiles"] == S // TILE and stats["blocks"] > 0
    assert stats["written"] == list(range(g))
    if g > kdec.CHAIN_G4:
        assert stats["s1_rows"] == g
        assert stats["s2_rows"] == {5: 6, 6: 6, 7: 8, 8: 8}[g]
    kernel = "decode_attention_paged" if paged else "decode_attention"
    got = reading(out, _dec_plain(q, k, v, cache_len, window, exp, paged,
                                  block))
    assert inside(kernel, exp, got), (kernel, exp, got,
                                      ATT_LIMITS[kernel][exp])


@pytest.mark.parametrize("exp", ("vexp", "vexp_hw"))
@pytest.mark.parametrize("paged,g", TIER_CASES, ids=TIER_IDS)
def test_rows4_half_block_outside_the_limits(exp, paged, g):
    """The plain sweep updating at half the block (half the page): the
    limits see a four- or eight-row kernel with the wrong partition."""
    q, k, v = _dec_inputs(g, 70 + g if g > kdec.CHAIN_G4 else 74)
    cache_len = torch.tensor(DEC_CASES[0][1], dtype=torch.int32)
    block = PAGE if paged else BLOCK
    ref = _dec_plain(q, k, v, cache_len, None, exp, paged, block)
    half = _dec_plain(q, k, v, cache_len, None, exp, paged, block // 2)
    kernel = "decode_attention_paged" if paged else "decode_attention"
    assert not inside(kernel, exp, reading(half, ref))


@pytest.mark.parametrize("g", range(1, 17))
def test_chain_rows_and_scratch_match_the_kernel(g):
    """At head dim 128 the wrapper's tiers are the kernel's: _chain_rows
    is chain_rows in decode_split.cuh (G 1-4: 4, 5-8: 8, 9-16: 16, its
    constants read from the source), and _split_scratch's length is
    scratch_floats' at those rows, contiguous (4 blocks of 512 keys) and
    paged (32 pages of 64), so the kernel neither refuses the buffer nor
    reads the scores at another stride."""
    rows, r = chain_tier(g)
    assert kdec._chain_rows(128, g) == rows == (4 if g <= 4 else
                                                8 if g <= 8 else 16)
    assert (r is None) == (g > 8)
    assert kdec._chain_rows(256, g) == 16
    b, hkv, d, keys = 2, 3, 128, 2048
    for block in (512, 64):
        n_b = keys // block
        n_t = n_b * -(-block // TILE)
        want = b * hkv * (n_t * TILE * rows + g * (n_t + n_b * (d + 2)))
        buf, n = kdec._split_scratch(torch.empty(b, hkv, g, d), keys, block)
        assert n == want == buf.numel()


# ---- the four- and eight-row stage 2's V ring (split_pv_rows): which
# tile each buffer holds, and whether its cp.async group has landed, as
# the kernel issues, waits and reads; the buffer count as the kernel
# takes it


def rows_bufs(tpb, paged):
    """rows_bufs in decode_split.cuh: a block's V buffers, kRowsBufs on
    the contiguous cache, as many as a page has tiles up to kRowsBufs."""
    most = _cuh_const("kRowsBufs")
    return min(tpb, most) if paged else most


def rows_smem_per_cta(ps):
    """split_pv_rows' shared memory at ``ps`` scores' rows a key, in
    bytes: the V ring (dynamic, kRowsBufs tiles of 64 keys x 128 bf16),
    two p buffers rounded and two unrounded ([key][ps] f32) and the row
    maxes, and the 1 KB the card reserves a CTA."""
    ring = _cuh_const("kRowsBufs") * TILE * D * 2
    return ring + 2 * 2 * TILE * ps * 4 + ps * 4 + 1024


def rows_v_ring(nbuf, t_lo, t_hi):
    """split_pv_rows' copies of V tiles t_lo .. t_hi - 1 into ``nbuf``
    buffers: the prologue's copies, then a tile a step its wait
    (cp.async.wait_group `ahead`, and the barrier after it), the refill
    of the buffer the tile before used, and the chain's read. Returns the
    tiles the chains read, each complete, or None where a read meets a
    buffer holding another tile or a copy still in flight."""
    buf = [None] * nbuf                  # (tile, landed) a buffer
    pending = []                         # committed groups, oldest first

    def copy(t, i):
        buf[i] = (t, False)
        pending.append(i)

    for u in range(min(nbuf, t_hi - t_lo)):
        copy(t_lo + u, u)
    read = []
    for tt in range(t_lo, t_hi):
        ahead = max(min(nbuf - 1 - (tt > t_lo), t_hi - 1 - tt), 0)
        while len(pending) > ahead:      # wait, then the barrier
            i = pending.pop(0)
            buf[i] = (buf[i][0], True)
        if tt > t_lo and tt - 1 + nbuf < t_hi:
            copy(tt - 1 + nbuf, (tt - 1 - t_lo) % nbuf)
        if buf[(tt - t_lo) % nbuf] != (tt, True):
            return None
        read.append(tt)
    return read


@pytest.mark.parametrize("tpb", range(1, 9))
@pytest.mark.parametrize("paged,g", TIER_CASES, ids=TIER_IDS)
def test_rows4_v_ring_reads_each_tile_landed(tpb, paged, g):
    """Every run of live tiles a block can have (a window's first kept key
    mid-block, a cache ending mid-block) at 1 to 8 tiles a block (a page
    of 64 keys or a short cache to a 512-key block, pages of 128 keys and
    more between), at G's tier: each tile read once, in order, after its
    copy landed and before its buffer is refilled; the full ring beside
    the tier's p buffers leaves three CTAs an SM (228 KB). Control: one
    buffer at two tiles a block reads a tile whose copy is still in
    flight."""
    nbuf = rows_bufs(tpb, paged)
    assert nbuf == (min(tpb, 4) if paged else 4)
    assert 3 * rows_smem_per_cta(chain_tier(g)[0]) <= 228 * 1024
    for t_lo in range(tpb):
        for t_hi in range(t_lo + 1, tpb + 1):
            assert rows_v_ring(nbuf, t_lo, t_hi) == list(range(t_lo,
                                                              t_hi))
    if tpb > 1:
        assert rows_v_ring(1, 0, tpb) is None
