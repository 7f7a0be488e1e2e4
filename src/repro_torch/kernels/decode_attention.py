"""Flash-decode kernels (port of ``repro/kernels/decode_attention``): the
contiguous sweep and the paged sweep, each normalized or as one shard's
partial statistics.

``decode_attention`` launches ``csrc/decode_attention.cu`` on CUDA tensors
and runs ``decode_attention_plain`` on CPU tensors. Both cache layouts
("bshd" (B,S,Hkv,d), "bhsd" (B,Hkv,S,d)) go to the one kernel through
strides; per-row ``cache_len`` (B,) and an optional window.

``decode_attention_paged`` launches ``csrc/decode_attention_paged.cu``:
the cache is a pool of pages ("bshd" (N,page,Hkv,d), "bhsd"
(N,Hkv,page,d)) and ``block_tab`` (B,nS) maps each row's logical pages to
pool pages. Its online update runs once per page, as the Pallas paged
kernel's does; ``decode_attention_paged_plain`` is the same function in
plain tensor ops, and ``paged_gather`` the oracle's gather.

Sequence-sharded decode (the paper's partial-softmax algebra across
ranks): each rank holds one slice of the cache's sequence axis, whose
first row sits at global position ``seq_offset``, while ``cache_len``
stays global. ``decode_attention_partial`` (B5) and
``decode_attention_paged_partial`` (B8) sweep the slice and return its
raw f32 statistics (m, l, acc); ``decode_attention_partial_packed`` (B6)
and ``decode_attention_paged_packed`` (B9) write the same statistics as
one (B,Hkv,G,d+2) tile ``[acc | m | l]``, the unit one all_gather moves.
A row with no key on the slice gets the merge identity
(``KERNEL_NEG_INF``, 0, 0). ``decode_attention_partial_merged`` /
``decode_attention_paged_partial_merged`` fold the shards through
``policy.merge_strategy`` (``core.softmax``'s collective merges) into the
normalized output; ``decode_attention_sharded`` is the dispatch entry.
Each kernel has its own C entry, launch counter and plain version.

On the card every mode of both sweeps is the sequence-split sweep of
``csrc/decode_split.cuh``: 64-key tiles spread over CTAs, p taken against
each update block's running max (the plain sweep's exp arguments, bit for
bit), the blocks chained in order. One C entry call launches its kernels
(two; three at head dims 128 and 256) and counts as one launch; the
wrapper hands it one uninitialized scratch buffer (``_split_scratch``).
At head dims 128 and 256 (phi3-medium: 4 query heads a KV head;
recurrentgemma: 16 on one KV head; normalized mode only) a CTA per
(update block, 64-column slice) chains the block's p @ v for its
columns, and slice 0 each row's l, in key order, the order of the plain
sweep's key-major products on the card, so the kernels match their plain
versions bit for bit there; a third kernel chains the blocks, one thread
per four outputs. At head dim 128 the rows a KV head come in three tiers
(``_chain_rows``): up to ``CHAIN_G4`` query heads a KV head and up to
``CHAIN_G8`` each take an instantiation of their own, scores for four or
eight rows a key and a CTA per update block chaining all 128 columns for
the live rows only; more take the sixteen-row path.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.core.softmax import (SoftmaxStats, stats_merge_collective,
                                      stats_merge_collective_packed)
from repro_torch.core.vexp import get_exp_fn
from .build import BACKEND_CODE, F, I, KernelLib, LL, P

# one launch counter per C entry; the three modes of a sweep share a source
LIB = KernelLib("decode_attention.cu")                 # decode_fwd
PARTIAL_LIB = KernelLib("decode_attention.cu")         # decode_partial_fwd
PACKED_LIB = KernelLib("decode_attention.cu")          # decode_packed_fwd
PAGED_LIB = KernelLib("decode_attention_paged.cu")     # paged_decode_fwd
PAGED_PARTIAL_LIB = KernelLib("decode_attention_paged.cu")
PAGED_PACKED_LIB = KernelLib("decode_attention_paged.cu")
# head dims of the normalized sweeps (B2, B7): gpt2-small's 64, its
# --reduced config's 32, h2o-danube3's 120, phi3-medium's 128,
# recurrentgemma's 256; the
# partial and packed modes (B5, B6, B8, B9) serve the sequence-sharded
# dense path only, whose configs have head dims 32 and 64
HEAD_DIMS = (32, 64, 120, 128, 256)
STAT_HEAD_DIMS = (32, 64)
# head dims that run a wider instantiation of the kernels: the rest of each
# q, K and V row is zero-filled in shared memory (an exact +0 at the end
# of each score's chain) and the scratch keeps the wider rows
KERNEL_D = {120: 128}
# head dims whose plain sweep writes its products key-major, (keys, d) @
# (d, G) and (d, keys) @ (keys, G): the orientation in which cuBLAS's
# f32 product on the H100 sums each score over d and each p @ v and l over
# the block's keys in order (tools/matmul_order.py reads it), the order
# the kernels at these head dims chain them in (block_chain in
# decode_split.cuh; at 120 as at 128, tools/d128_order.py --d 120); 32 and
# 64 keep einsum / sum
KEY_MAJOR_DIMS = (120, 128, 256)
# query heads per KV head the sweep takes at a head dim: 16 where the
# block chains (phi3-medium's 4 and dbrx's 6 at D 128, recurrentgemma's 16
# at D 256; the sixteen-row path's shared memory is sized by it), 8 at D 32
# and 64, so gpt2's heads keep their occupancy
MAX_GROUP = {d: 16 if d in KEY_MAJOR_DIMS else 8 for d in HEAD_DIMS}
# the tiers of query rows a key the chained sweep's scores take at head
# dim 128, and so at 120 (chain_rows in decode_split.cuh): G <= CHAIN_G4
# (phi3-medium's and h2o-danube3's 4) takes four rows, G <= CHAIN_G8
# (dbrx's 6) eight, each an instantiation of its own whose stage 2
# chains no row past G (at eight rows: six for G <= 6); G 9 to 16 take
# MAX_GROUP's 16
CHAIN_G4 = 4
CHAIN_G8 = 8
TILE = 64                 # keys per tile of the split sweep (decode_split.cuh)


def _as_bhsd(cache, layout):
    if layout == "bhsd":
        return cache
    if layout == "bshd":
        return cache.transpose(1, 2)        # a view: (B, Hkv, S, d)
    raise ValueError(f"unknown kv cache layout {layout!r}")


def _sweep_plain(q, k_cache, v_cache, cache_len, seq_offset, *, window,
                 sm_scale, layout, block_s, exp_backend):
    """The kernels' sweep in plain tensor ops: q scaled in f32 then
    rounded to the cache dtype, f32 scores, online update once per
    ``block_s`` keys counted from the slice's row 0, p rounded to the
    cache dtype before p @ v, f32 accumulation. The slice's row r is the
    key at global position ``seq_offset`` + r, kept when
    ``cache_len - window <= r + seq_offset < cache_len``. Returns the raw
    (m, l) (B,Hkv,G) and acc (B,Hkv,G,d), all f32; a row with no kept key
    keeps (NEG_INF, 0, 0)."""
    exp_fn = get_exp_fn(exp_backend)
    kk, vv = _as_bhsd(k_cache, layout), _as_bhsd(v_cache, layout)
    b, _, h, d = q.shape
    hkv, smax = kk.shape[1], kk.shape[2]
    g = h // hkv
    cdt = kk.dtype
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = (q.float() * scale).to(cdt).float().reshape(b, hkv, g, d)
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    bs = min(block_s, smax)
    key_major = d in KEY_MAJOR_DIMS
    # one query row would take cuBLAS's matrix-vector path, which does not
    # sum in order; a second, zero row keeps the matrix product's order
    # (tools/d128_order.py --d 120)
    gm = max(g, 2) if key_major else g

    def rows(t):                          # (..., G, n) -> (..., gm, n)
        return t if gm == g else torch.nn.functional.pad(
            t, (0, 0, 0, gm - g))
    qm = rows(qg)
    for k0 in range(0, smax, bs):
        kb = kk[:, :, k0:k0 + bs].float()
        vb = vv[:, :, k0:k0 + bs].float()
        kpos = (seq_offset + k0
                + torch.arange(kb.shape[2], device=q.device)[None, :])
        keep = kpos < cl
        if window is not None:
            keep = keep & (kpos >= cl - window)
        keep = keep[:, None, None, :]
        if key_major:
            s = (kb.contiguous() @ qm.transpose(-1, -2)).transpose(
                -1, -2)[..., :g, :]
        else:
            s = torch.einsum("bkgd,bktd->bkgt", qg, kb)
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = exp_fn(m - m_new)
        p = torch.where(keep, exp_fn(s - m_new[..., None]), 0.0)
        pr = p.to(cdt).float()
        if key_major:
            pt = rows(p).contiguous().transpose(-1, -2)      # (keys, gm)
            vt = vb.contiguous().transpose(-1, -2)           # (d, keys)
            # l as the product of p with d rows of ones, one kept: the
            # same product as p @ v; with one row cuBLAS leaves key order
            l_blk = (torch.ones_like(vt) @ pt)[..., 0, :g]
            pv = (vt @ rows(pr).contiguous().transpose(-1, -2)).transpose(
                -1, -2)[..., :g, :]
        else:
            l_blk = p.sum(dim=-1)
            pv = torch.einsum("bkgt,bktd->bkgd", pr, vb)
        l = l * alpha + l_blk
        acc = acc * alpha[..., None] + pv
        m = m_new
    return m, l, acc


def decode_attention_plain(q, k_cache, v_cache, cache_len, *, window=None,
                           sm_scale=None, layout="bshd", block_s=512,
                           exp_backend="vexp"):
    """The function the kernel computes (reference ``_decode_kernel``):
    ``_sweep_plain`` over the whole cache, normalized by 1/max(l, 1e-30).
    q (B,1,H,d) -> (B,1,H,d)."""
    _, l, acc = _sweep_plain(q, k_cache, v_cache, cache_len, 0,
                             window=window, sm_scale=sm_scale, layout=layout,
                             block_s=block_s, exp_backend=exp_backend)
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_partial_plain(q, k_cache, v_cache, cache_len,
                                   seq_offset, *, window=None, sm_scale=None,
                                   layout="bshd", block_s=512,
                                   exp_backend="vexp"):
    """What the partial kernel computes: the slice's raw statistics
    (m, l) (B,Hkv,G,1) and acc (B,Hkv,G,d), f32."""
    m, l, acc = _sweep_plain(q, k_cache, v_cache, cache_len, seq_offset,
                             window=window, sm_scale=sm_scale, layout=layout,
                             block_s=block_s, exp_backend=exp_backend)
    return m[..., None], l[..., None], acc


def decode_attention_packed_plain(q, k_cache, v_cache, cache_len, seq_offset,
                                  *, window=None, sm_scale=None,
                                  layout="bshd", block_s=512,
                                  exp_backend="vexp"):
    """What the packed kernel computes: the partial statistics as one
    (B,Hkv,G,d+2) f32 tile ``[acc | m | l]``."""
    m, l, acc = decode_attention_partial_plain(
        q, k_cache, v_cache, cache_len, seq_offset, window=window,
        sm_scale=sm_scale, layout=layout, block_s=block_s,
        exp_backend=exp_backend)
    return torch.cat([acc, m, l], dim=-1)


def _cuda_only(q, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel: unsupported device {q.device}")


def _check_shape(what, mode, d, h, hkv):
    """Raise unless the sweep in ``mode`` takes head dim ``d`` with
    ``h`` query heads on ``hkv`` KV heads."""
    dims = HEAD_DIMS if mode == "normalized" else STAT_HEAD_DIMS
    if d not in dims or h % hkv or h // hkv > MAX_GROUP[d]:
        raise ValueError(
            f"{what} kernel: needs head dim in {dims} and H % Hkv == 0 "
            f"with H/Hkv <= {MAX_GROUP.get(d, MAX_GROUP[64])} at that head "
            f"dim; got head dim {d}, H {h}, Hkv {hkv}")


def _check_bf16(what, device, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16 or t.device != device:
            raise TypeError(f"{what} kernel: {name} must be bfloat16 on "
                            f"{device}, got {t.dtype} on {t.device}")


def _lens(cache_len, b, device):
    cl = torch.as_tensor(cache_len, device=device)
    if cl.dtype != torch.int32:
        cl = cl.to(torch.int32)
    if cl.shape != (b,):
        cl = torch.broadcast_to(cl.reshape(-1), (b,))
    return cl.contiguous()


def _stat_outputs(qg, mode):
    """Output buffers of a sweep's mode: the normalized bf16 output, the
    partial (acc, m, l) or the packed tile; the kernel writes every
    element, so they start uninitialized."""
    b, hkv, g, d = qg.shape
    f32 = dict(dtype=torch.float32, device=qg.device)
    if mode == "normalized":
        return (torch.empty_like(qg),)
    if mode == "partial":
        return (torch.empty((b, hkv, g, d), **f32),
                torch.empty((b, hkv, g, 1), **f32),
                torch.empty((b, hkv, g, 1), **f32))
    return (torch.empty((b, hkv, g, d + 2), **f32),)


def _ptrs(outs):
    """(o, om, ol) pointers; the modes without m / l pass null."""
    p = [t.data_ptr() for t in outs]
    return p + [None] * (3 - len(p))


def _chain_rows(d, g):
    """Query rows a key the chained sweep's scores take at head dim ``d``
    for ``g`` query heads a KV head: at head dim 128 (and 120, which runs
    it) CHAIN_G4 for g <= CHAIN_G4 and CHAIN_G8 for g <= CHAIN_G8, else
    MAX_GROUP[d]."""
    if KERNEL_D.get(d, d) == 128:
        for rows in (CHAIN_G4, CHAIN_G8):
            if g <= rows:
                return rows
    return MAX_GROUP[d]


def _split_scratch(qg, keys, block):
    """The split sweep's scratch for ``keys`` slice rows updated once per
    ``block`` keys, one flat f32 buffer (uninitialized: the kernels write
    what they read): scores and tile maxes, then at the dense heads each
    tile's l, block alpha and p @ v and one ticket counter per (b, KV
    head); at ``KEY_MAJOR_DIMS``, where the kernels chain each update
    block by column slices (``block_chain``), the scores of
    ``_chain_rows(d, g)`` query rows a key, and each update block's p @
    v, alpha and l, at the width of the instantiation that runs ``d``
    (``KERNEL_D``). Returns (buffer, its length)."""
    b, hkv, g, d = qg.shape
    d = KERNEL_D.get(d, d)
    bs = max(min(block, keys), 1)
    blocks = max(-(-keys // bs), 1)
    tiles = blocks * -(-bs // TILE)
    if d in KEY_MAJOR_DIMS:
        n = b * hkv * (tiles * TILE * _chain_rows(d, g)
                       + g * (tiles + blocks * (d + 2)))
    else:
        n = b * hkv * (g * tiles * (TILE + 3 + d) + 1)
    return torch.empty(n, dtype=torch.float32, device=qg.device), n


_CONTIG_ENTRY = {"normalized": ("decode_fwd", LIB),
                 "partial": ("decode_partial_fwd", PARTIAL_LIB),
                 "packed": ("decode_packed_fwd", PACKED_LIB)}


def _launch_contig(mode, q, k_cache, v_cache, cache_len, seq_offset, *,
                   window, sm_scale, layout, policy):
    """Validate, allocate and launch the contiguous sweep in ``mode``;
    returns the mode's output buffers, shaped (B,Hkv,G,...)."""
    entry, lib = _CONTIG_ENTRY[mode]
    what = f"decode_attention ({mode})"
    kk, vv = _as_bhsd(k_cache, layout), _as_bhsd(v_cache, layout)
    b, _, h, d = q.shape
    hkv, smax = kk.shape[1], kk.shape[2]
    g = h // hkv
    _check_bf16(what, q.device, q=q, k_cache=kk, v_cache=vv)
    _check_shape(what, mode, d, h, hkv)
    if (kk.stride() != vv.stride() or kk.stride(3) != 1
            or any(s % 8 for s in kk.stride()[:3])
            or kk.data_ptr() % 16 or vv.data_ptr() % 16):
        raise ValueError(
            f"{what} kernel: needs K and V with equal strides, a packed "
            f"last dim and 16-byte aligned rows")
    cl = _lens(cache_len, b, q.device)
    qg = q.reshape(b, hkv, g, d).contiguous()
    outs = _stat_outputs(qg, mode)
    scratch, n = _split_scratch(qg, smax, policy.block_s)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    launch = lib.fn(entry, [P] * 7 + [LL, P] + [I] * 5 + [LL] * 3 + [F]
                    + [I] * 4 + [P])
    lib.check(launch(
        qg.data_ptr(), kk.data_ptr(), vv.data_ptr(), *_ptrs(outs),
        scratch.data_ptr(), n, cl.data_ptr(), b, hkv, g, smax, d,
        *kk.stride()[:3], scale, window or 0, policy.block_s,
        seq_offset,
        BACKEND_CODE[policy.exp_backend],
        torch.cuda.current_stream(q.device).cuda_stream), what)
    return outs


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     sm_scale=None, layout="bshd", policy):
    """Flash-decode under ``policy`` (exp backend, ``block_s``).
    q (B,1,H,d); cache_len (B,) int. Returns (B,1,H,d) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, cache_len, window=window,
            sm_scale=sm_scale, layout=layout, block_s=policy.block_s,
            exp_backend=policy.exp_backend)
    _cuda_only(q, "decode_attention")
    out, = _launch_contig("normalized", q, k_cache, v_cache, cache_len, 0,
                          window=window, sm_scale=sm_scale, layout=layout,
                          policy=policy)
    return out.reshape(q.shape)


def decode_attention_partial(q, k_cache, v_cache, cache_len, seq_offset, *,
                             window=None, sm_scale=None, layout="bshd",
                             policy):
    """One shard's partial statistics (B5): ``k_cache`` / ``v_cache`` are
    the shard's slice, its first row at global position ``seq_offset``
    (an int); ``cache_len`` stays global. Returns (m, l) (B,Hkv,G,1) and
    acc (B,Hkv,G,d), all f32."""
    if q.device.type == "cpu":
        return decode_attention_partial_plain(
            q, k_cache, v_cache, cache_len, seq_offset, window=window,
            sm_scale=sm_scale, layout=layout, block_s=policy.block_s,
            exp_backend=policy.exp_backend)
    _cuda_only(q, "decode_attention_partial")
    acc, m, l = _launch_contig("partial", q, k_cache, v_cache, cache_len,
                               seq_offset, window=window, sm_scale=sm_scale,
                               layout=layout, policy=policy)
    return m, l, acc


def decode_attention_partial_packed(q, k_cache, v_cache, cache_len,
                                    seq_offset, *, window=None, sm_scale=None,
                                    layout="bshd", policy):
    """One shard's partial statistics as one packed f32 tile (B6):
    (B,Hkv,G,d+2) laid out ``[acc | m | l]``."""
    if q.device.type == "cpu":
        return decode_attention_packed_plain(
            q, k_cache, v_cache, cache_len, seq_offset, window=window,
            sm_scale=sm_scale, layout=layout, block_s=policy.block_s,
            exp_backend=policy.exp_backend)
    _cuda_only(q, "decode_attention_partial_packed")
    tile, = _launch_contig("packed", q, k_cache, v_cache, cache_len,
                           seq_offset, window=window, sm_scale=sm_scale,
                           layout=layout, policy=policy)
    return tile


def _merged(q, policy, comm, packed, split):
    """Fold the shards' statistics over ``comm`` per
    ``policy.merge_strategy`` and normalize: ``packed()`` returns this
    shard's tile, ``split()`` its (m, l, acc). Returns (B,1,H,d) in q's
    dtype."""
    exp_fn = policy.exp_fn()
    if policy.merge_strategy == "packed":
        stats, acc = stats_merge_collective_packed(packed(), comm,
                                                   exp_fn=exp_fn)
    else:
        m, l, acc = split()
        stats, acc = stats_merge_collective(SoftmaxStats(m=m, l=l), acc,
                                            comm, exp_fn=exp_fn)
    out = acc * (1.0 / torch.clamp(stats.l, min=1e-30))
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_partial_merged(q, k_cache, v_cache, cache_len,
                                    seq_offset, *, comm, window=None,
                                    sm_scale=None, layout="bshd", policy):
    """This shard's sweep plus the merge over ``comm`` (a
    ``distributed.ShardGroup``): "packed" is one all_gather of the packed
    tile and a local fold, "split" all_reduce MAX of m and two
    all_reduce SUMs. The one merge site of the contiguous sharded path.
    Returns the normalized (B,1,H,d) output, equal on every rank."""
    kw = dict(window=window, sm_scale=sm_scale, layout=layout, policy=policy)
    args = (q, k_cache, v_cache, cache_len, seq_offset)
    return _merged(q, policy, comm,
                   lambda: decode_attention_partial_packed(*args, **kw),
                   lambda: decode_attention_partial(*args, **kw))


def decode_attention_sharded(q, k_cache, v_cache, cache_len, *, shard,
                             window=None, sm_scale=None, layout="bshd",
                             policy):
    """Sequence-parallel flash decode (the cuda tier of the
    ``decode_attention_sharded`` op): ``k_cache`` / ``v_cache`` are this
    rank's slice of the sequence axis, ``shard`` the
    ``distributed.ShardSpec`` placing it (``offset``, ``comm``); q and
    ``cache_len`` are the same on every rank. Returns (B,1,H,d)."""
    return decode_attention_partial_merged(
        q, k_cache, v_cache, cache_len, shard.offset, comm=shard.comm,
        window=window, sm_scale=sm_scale, layout=layout, policy=policy)


# ------------------------------------------------------------ paged sweep

def _pool_layout(pool, layout):
    """(page, Hkv) of a pool in ``layout``."""
    if layout == "bhsd":
        return pool.shape[2], pool.shape[1]
    if layout == "bshd":
        return pool.shape[1], pool.shape[2]
    raise ValueError(f"unknown kv cache layout {layout!r}")


def paged_gather(pool, block_tab, layout="bshd"):
    """A contiguous per-row cache from a paged pool (the reference tier's
    semantics of block-table indirection, ``ops.paged_gather``). Returns
    (B, nS*page, Hkv, d) for "bshd" pools, (B, Hkv, nS*page, d) for
    "bhsd"."""
    tab = torch.as_tensor(block_tab, device=pool.device).long()
    b, ns = tab.shape
    got = pool[tab]                             # (B, nS, *page_shape)
    if layout == "bhsd":                        # (B, nS, Hkv, page, d)
        g = got.permute(0, 2, 1, 3, 4)
        return g.reshape(b, g.shape[1], ns * g.shape[3], g.shape[4])
    return got.reshape(b, ns * got.shape[2], *got.shape[3:])


def decode_attention_paged_plain(q, k_pool, v_pool, block_tab, cache_len, *,
                                 window=None, sm_scale=None, layout="bshd",
                                 exp_backend="vexp", block=None):
    """The function the paged kernel computes: the row's pages gathered
    through the table, then the flash-decode arithmetic with the online
    update once per ``block`` keys counted from key 0 (default: the
    page). Blocks past a row's ``cache_len`` are exact no-ops, so the
    gathered tail changes nothing. q (B,1,H,d) -> (B,1,H,d)."""
    page, _ = _pool_layout(k_pool, layout)
    return decode_attention_plain(
        q, paged_gather(k_pool, block_tab, layout),
        paged_gather(v_pool, block_tab, layout), cache_len, window=window,
        sm_scale=sm_scale, layout=layout, block_s=block or page,
        exp_backend=exp_backend)


def decode_attention_paged_partial_plain(q, k_pool, v_pool, block_tab,
                                         cache_len, seq_offset, *,
                                         window=None, sm_scale=None,
                                         layout="bshd", exp_backend="vexp",
                                         block=None):
    """What the paged partial kernel computes: this shard's pages (its
    pool, its table slice of local page ids) gathered, then the partial
    sweep at ``seq_offset``, one update per ``block`` keys (default: the
    page). Returns (m, l) (B,Hkv,G,1) and acc (B,Hkv,G,d), f32."""
    page, _ = _pool_layout(k_pool, layout)
    return decode_attention_partial_plain(
        q, paged_gather(k_pool, block_tab, layout),
        paged_gather(v_pool, block_tab, layout), cache_len, seq_offset,
        window=window, sm_scale=sm_scale, layout=layout,
        block_s=block or page, exp_backend=exp_backend)


def decode_attention_paged_packed_plain(q, k_pool, v_pool, block_tab,
                                        cache_len, seq_offset, *,
                                        window=None, sm_scale=None,
                                        layout="bshd", exp_backend="vexp",
                                        block=None):
    """What the paged packed kernel computes: the paged partial
    statistics as one (B,Hkv,G,d+2) f32 tile ``[acc | m | l]``."""
    m, l, acc = decode_attention_paged_partial_plain(
        q, k_pool, v_pool, block_tab, cache_len, seq_offset, window=window,
        sm_scale=sm_scale, layout=layout, exp_backend=exp_backend,
        block=block)
    return torch.cat([acc, m, l], dim=-1)


_PAGED_ENTRY = {"normalized": ("paged_decode_fwd", PAGED_LIB),
                "partial": ("paged_decode_partial_fwd", PAGED_PARTIAL_LIB),
                "packed": ("paged_decode_packed_fwd", PAGED_PACKED_LIB)}


def _launch_paged(mode, q, k_pool, v_pool, block_tab, cache_len, seq_offset,
                  *, window, sm_scale, layout, policy):
    """Validate, allocate and launch the paged sweep in ``mode``; returns
    the mode's output buffers, shaped (B,Hkv,G,...)."""
    entry, lib = _PAGED_ENTRY[mode]
    what = f"decode_attention_paged ({mode})"
    page, hkv = _pool_layout(k_pool, layout)
    b, _, h, d = q.shape
    g = h // hkv
    _check_bf16(what, q.device, q=q, k_pool=k_pool, v_pool=v_pool)
    # strides in (page, head, token) order
    st = (k_pool.stride(0),) + ((k_pool.stride(1), k_pool.stride(2))
                                if layout == "bhsd"
                                else (k_pool.stride(2), k_pool.stride(1)))
    _check_shape(what, mode, d, h, hkv)
    if (k_pool.shape != v_pool.shape
            or k_pool.stride() != v_pool.stride() or k_pool.stride(3) != 1
            or any(s % 8 for s in st)
            or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16):
        raise ValueError(
            f"{what} kernel: needs K and V pools of equal shape and "
            f"strides, a packed last dim and 16-byte aligned rows")
    tab = torch.as_tensor(block_tab, device=q.device).to(torch.int32)
    if tab.dim() != 2 or tab.shape[0] != b:
        raise ValueError(f"block_tab must be ({b}, nS), got "
                         f"{tuple(tab.shape)}")
    tab = tab.contiguous()
    cl = _lens(cache_len, b, q.device)
    qg = q.reshape(b, hkv, g, d).contiguous()
    outs = _stat_outputs(qg, mode)
    scratch, n = _split_scratch(qg, tab.shape[1] * page, page)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    launch = lib.fn(entry, [P] * 7 + [LL] + [P] * 2 + [I] * 6 + [LL] * 3
                    + [F] + [I] * 3 + [P])
    lib.check(launch(
        qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *_ptrs(outs),
        scratch.data_ptr(), n, tab.data_ptr(), cl.data_ptr(), b, hkv, g, d,
        page, tab.shape[1], *st, scale, window or 0, seq_offset,
        BACKEND_CODE[policy.exp_backend],
        torch.cuda.current_stream(q.device).cuda_stream), what)
    return outs


def decode_attention_paged(q, k_pool, v_pool, block_tab, cache_len, *,
                           window=None, sm_scale=None, layout="bshd",
                           policy):
    """Paged flash-decode under ``policy`` (exp backend; the online-update
    unit is the pool's page). q (B,1,H,d); block_tab (B,nS) int; cache_len
    (B,) int. Returns (B,1,H,d) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_paged_plain(
            q, k_pool, v_pool, block_tab, cache_len, window=window,
            sm_scale=sm_scale, layout=layout,
            exp_backend=policy.exp_backend)
    _cuda_only(q, "decode_attention_paged")
    out, = _launch_paged("normalized", q, k_pool, v_pool, block_tab,
                         cache_len, 0, window=window, sm_scale=sm_scale,
                         layout=layout, policy=policy)
    return out.reshape(q.shape)


def decode_attention_paged_partial(q, k_pool, v_pool, block_tab, cache_len,
                                   seq_offset, *, window=None, sm_scale=None,
                                   layout="bshd", policy):
    """One shard's paged partial statistics (B8): ``k_pool`` / ``v_pool``
    the shard's own pool, ``block_tab`` its (B, nS_local) slice of local
    page ids whose logical page 0 sits at global position ``seq_offset``;
    ``cache_len`` stays global. Returns (m, l) (B,Hkv,G,1) and acc
    (B,Hkv,G,d), all f32."""
    if q.device.type == "cpu":
        return decode_attention_paged_partial_plain(
            q, k_pool, v_pool, block_tab, cache_len, seq_offset,
            window=window, sm_scale=sm_scale, layout=layout,
            exp_backend=policy.exp_backend)
    _cuda_only(q, "decode_attention_paged_partial")
    acc, m, l = _launch_paged("partial", q, k_pool, v_pool, block_tab,
                              cache_len, seq_offset, window=window,
                              sm_scale=sm_scale, layout=layout,
                              policy=policy)
    return m, l, acc


def decode_attention_paged_packed(q, k_pool, v_pool, block_tab, cache_len,
                                  seq_offset, *, window=None, sm_scale=None,
                                  layout="bshd", policy):
    """One shard's paged partial statistics as one packed f32 tile (B9):
    (B,Hkv,G,d+2) laid out ``[acc | m | l]``."""
    if q.device.type == "cpu":
        return decode_attention_paged_packed_plain(
            q, k_pool, v_pool, block_tab, cache_len, seq_offset,
            window=window, sm_scale=sm_scale, layout=layout,
            exp_backend=policy.exp_backend)
    _cuda_only(q, "decode_attention_paged_packed")
    tile, = _launch_paged("packed", q, k_pool, v_pool, block_tab, cache_len,
                          seq_offset, window=window, sm_scale=sm_scale,
                          layout=layout, policy=policy)
    return tile


def decode_attention_paged_partial_merged(q, k_pool, v_pool, block_tab,
                                          cache_len, seq_offset, *, comm,
                                          window=None, sm_scale=None,
                                          layout="bshd", policy):
    """This shard's paged sweep plus the merge over ``comm``, per
    ``policy.merge_strategy`` as ``decode_attention_partial_merged``.
    Returns the normalized (B,1,H,d) output, equal on every rank."""
    kw = dict(window=window, sm_scale=sm_scale, layout=layout, policy=policy)
    args = (q, k_pool, v_pool, block_tab, cache_len, seq_offset)
    return _merged(q, policy, comm,
                   lambda: decode_attention_paged_packed(*args, **kw),
                   lambda: decode_attention_paged_partial(*args, **kw))
