"""The partition of FlashAttention's head-dim-256 kernel, checked on the
CPU with this file's own emulation of it (the kernel is ``fa_rows<256>`` in
``csrc/flash_attention.cu``; the package holds no emulation):

* a CTA takes 64 query rows of one KV head, rows being (position, query
  head) pairs, position-major (at G 16: four positions of all 16 heads);
  its KV blocks are counted from key 0 in units of ``block_k`` and walked
  from the window's first key to the causal bound or ``kv_len``;
* a block's live keys go in 32-key groups counted from the block's
  start; a K piece is up to eight groups (one a warp; two or four warps
  a group when it holds four or two or fewer, and a piece of four where
  five or six are left), and its scores accumulate over sixteen 16-d
  slabs, each score one FMA chain over d = 0 .. 255; keys at
  or past the block's bound are zero-filled and masked; a group whose
  every key is kept for every row of the tile skips the mask;
* the block's max over kept keys, alpha, p = exp(s - m_new) masked after
  the exp; p . v one FMA chain over the block's live keys in order, V
  in 16-key slabs, and the block's l one chain of f32 adds over the same
  keys in order (the kernel folds it into the p . v loop); then the one
  online update;
* the tiles of a batch row launch from the last position down (an
  order, not a result).

What is shown: the emulation equals, bit for bit, the unpartitioned
blockwise scan written with the same FMA chains; it sits inside
``ATT_LIMITS["flash_attention"]`` against ``flash_attention_plain``
under every exp backend, with ragged kv_len (a row of length 1), a (B,)
q_offset (a row whose last query is the last key, a row of no token), a
window that cuts keys, and Sq * G not a multiple of the 64-row tile; the
plain version at half the block falls outside the limits under vexp and
vexp_hw. Inputs are made with numpy from a seed.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.attention import NEG_INF  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels.limits import ATT_LIMITS  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
ROWS, GROUP, SUBGROUPS, SLAB_D, V_KEYS, D = 64, 32, 8, 16, 16, 256
SMEM_OPTIN = 232_448          # an H100's shared memory a block may opt in to


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
    """Groups of the next score piece: 8, or 4 when 5 or 6 are left (the
    rest then runs at 4 or 2 rows a thread), else all that are left."""
    return SUBGROUPS if rem >= SUBGROUPS else 4 if rem in (5, 6) else rem


def score_chains(q, k):
    """Every score as the kernel forms it: q * sm_scale rounded, then one
    FMA chain over d = 0 .. 255 from 0, slab by slab; (B, Hkv, G, Sq, Sk).
    A key the kernel zero-fills scores 0 from this chain too."""
    b_, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qs = (q.float() * torch.tensor(1.0 / math.sqrt(d))).reshape(
        b_, sq, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)
    ks = k.float().permute(0, 2, 1, 3)[:, :, None, None]   # b k 1 1 t d
    s = torch.zeros(b_, hkv, h // hkv, sq, sk)
    for sl in range(d // SLAB_D):
        for dd in range(sl * SLAB_D, (sl + 1) * SLAB_D):
            s = fma(s, qs[..., dd, None], ks[..., dd])
    return s


def fa256_emulate(q, k, v, *, kv_len, q_offset, causal, window, block_k,
                  exp_backend, scores):
    """The kernel's partition of the work, CTA by CTA (the tiles of a
    batch row from the last position down), on ``score_chains``'
    scores. Returns (output, {"ctas", "groups"})."""
    exp_fn = get_exp_fn(exp_backend)
    b_, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g_ = h // hkv
    nrows = sq * g_
    ntiles = (nrows + ROWS - 1) // ROWS
    out = torch.zeros(b_, sq, h, d, dtype=q.dtype)
    stats = {"ctas": 0, "groups": 0}
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
                    # scores, piece by piece (up to 8 groups)
                    s = torch.zeros(ROWS, len(keys))
                    gs = g_lo
                    while gs < g_hi:
                        n = piece(g_hi - gs)
                        c = slice((gs - g_lo) * GROUP, (gs - g_lo + n) * GROUP)
                        s[:, c] = torch.where(ok[None, c],
                                              srows[:, keys[c].clamp(max=sk - 1)],
                                              0.0)
                        gs += n
                    # the mask, skipped for groups kept whole
                    keep = torch.ones(ROWS, len(keys), dtype=torch.bool)
                    for g in range(g_lo, g_hi):
                        stats["groups"] += 1
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
                        for c in range(v0, v0 + V_KEYS):
                            pv = fma(pv, p[:, c, None], vv[None, c])
                            lch = lch + p[:, c]
                    l_run = l_run * alpha + lch
                    acc = acc * alpha[:, None] + pv
                o = (acc * (1.0 / torch.clamp(l_run, min=1e-30))[:, None])
                r = rows[real]
                out[b, r // g_, hk * g_ + r % g_] = o[real].to(q.dtype)
    return out, stats


def chain_reference(q, k, v, *, kv_len, q_offset, causal, window, block_k,
                    exp_backend):
    """``_attention_flash_l_chain`` written with the kernel's chains and
    no partition: every key of every block, masked."""
    exp_fn = get_exp_fn(exp_backend)
    b_, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g_ = h // hkv
    qs = (q.float() * torch.tensor(1.0 / math.sqrt(d))).reshape(
        b_, sq, hkv, g_, d).permute(0, 2, 3, 1, 4)         # b k g s d
    qpos = (torch.arange(sq)[None, :]
            + torch.as_tensor(q_offset).reshape(-1, 1))[:, None, None, :,
                                                          None]
    m = torch.full((b_, hkv, g_, sq), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b_, hkv, g_, sq, d)
    klen = torch.clamp(torch.as_tensor(kv_len), max=sk)
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].float().permute(0, 2, 1, 3)  # b k t d
        vb = v[:, k0:k0 + block_k].float().permute(0, 2, 1, 3)
        bk = kb.shape[2]
        s = torch.zeros(b_, hkv, g_, sq, bk)
        for dd in range(d):
            s = fma(s, qs[..., dd, None], kb[:, :, None, None, :, dd])
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


def _qkv(b, sq, sk, seed, g=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               [(b, sq, g, D), (b, sk, 1, D), (b, sk, 1, D)])
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))


# name -> (B, Sq, Sk, kv_len, q_offset, window, block_k); Sq * 16 rows is
# never a whole number of 64-row tiles
CASES = {
    # ragged prefill: a row of one key, a full row, one mid-block;
    # 48-key blocks (a group and a half)
    "prefill": (3, 45, 96, [1, 96, 61], [0, 0, 0], 0, 48),
    # chunk at (B,) offsets: a row whose last query is the last key, a
    # row of no token (kv_len 0), one crossing blocks; 64-key blocks
    "chunk": (4, 23, 160, [23, 160, 70, 0], [0, 137, 60, 0], 0, 64),
    # a window of 20 that cuts the keys below each query
    "window": (2, 57, 57, [57, 40], [0, 0], 20, 32),
}


def _run(case, exp, fn, **extra):
    b, sq, sk, kv_len, q_off, window, bk = CASES[case]
    q, k, v = _qkv(b, sq, sk, seed=sum(map(ord, case)))
    return fn(q, k, v, kv_len=torch.tensor(kv_len, dtype=torch.int32),
              q_offset=torch.tensor(q_off, dtype=torch.int32), causal=True,
              window=window, block_k=bk, exp_backend=exp, **extra)


def _plain(case, exp, block_k=None):
    b, sq, sk, kv_len, q_off, window, bk = CASES[case]
    q, k, v = _qkv(b, sq, sk, seed=sum(map(ord, case)))
    return kfa.flash_attention_plain(
        q, k, v, causal=True, window=window or None,
        kv_len=torch.tensor(kv_len, dtype=torch.int32),
        q_offset=torch.tensor(q_off, dtype=torch.int32),
        block_k=block_k or bk, exp_backend=exp)


def _real(case):
    b, sq, sk, kv_len, q_off, window, bk = CASES[case]
    qpos = torch.arange(sq)[None, :] + torch.tensor(q_off)[:, None]
    return (qpos < torch.tensor(kv_len)[:, None])[:, :, None, None]


def reading(out, ref, real):
    sel = real.expand_as(out)
    o, r = out.float()[sel], ref.float()[sel]
    return float((o - r).abs().max()), float((o != r).double().mean())


_EMU, _SCORES = {}, {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The chains are thousands of small ops: one thread each, so that
    test workers sharing the host do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emulated(case, exp):
    if case not in _SCORES:
        b, sq, sk = CASES[case][:3]
        q, k, _ = _qkv(b, sq, sk, seed=sum(map(ord, case)))
        _SCORES[case] = score_chains(q, k)
    if (case, exp) not in _EMU:
        _EMU[case, exp] = _run(case, exp, fa256_emulate,
                               scores=_SCORES[case])
    return _EMU[case, exp]


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_equals_chain_reference(case, exp):
    """The partition (tiles, skipped blocks and groups, zero-filled keys,
    unmasked whole groups, d slabs, l in the p . v loop) changes no
    bit of any output, dead rows included."""
    out, stats = _emulated(case, exp)
    ref = _run(case, exp, chain_reference)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert stats["groups"] > 0


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_inside_the_limits(case, exp):
    out, _ = _emulated(case, exp)
    got = reading(out, _plain(case, exp), _real(case))
    lim_err, lim_share = ATT_LIMITS["flash_attention"][exp]
    assert got[0] <= lim_err and got[1] <= lim_share, got


@pytest.mark.parametrize("exp", ("vexp", "vexp_hw"))
@pytest.mark.parametrize("case", ("chunk", "prefill"))
def test_half_block_outside_the_limits(case, exp):
    """The plain version updating twice a block: the limits see a kernel
    with the wrong partition."""
    bk = CASES[case][-1]
    got = reading(_plain(case, exp, bk // 2), _plain(case, exp), _real(case))
    lim_err, lim_share = ATT_LIMITS["flash_attention"][exp]
    assert not (got[0] <= lim_err and got[1] <= lim_share), got


def test_score_tile_fits_block_k_512():
    """fa_rows<256>'s shared memory: q^T f32 (64 KB), the two f32 stages (32
    KB: 256 keys by 16 d, or 16 keys by 256 d), the row maxima of eight warps, each row's m_new, alpha and
    position, then the score tile of 64 rows by block_k keys rounded up
    to whole groups: the policy's 512 fits an H100's 227 KB a block, the
    next group does not."""
    fixed = D * ROWS * 4 + 2 * SUBGROUPS * GROUP * SLAB_D * 4 \
        + 8 * ROWS * 4 + 3 * ROWS * 4

    def smem(bk):
        return fixed + (bk + GROUP - 1) // GROUP * GROUP * ROWS * 4
    assert smem(512) <= SMEM_OPTIN < smem(513)
