"""Refcounted free-list page allocator + shared-prefix page cache.

The port's own copy of ``repro/models/block_pool.py`` (numpy only): the
same chain hashes and the same order of allocation and eviction, so the
same operations give the same page ids in both packages.

The paged DecodeState stores KV in fixed-size physical *pages* behind a
per-slot block table (the paged decode kernel walks the table). This
module is the host-side bookkeeping for that pool:

``BlockAllocator``
    Free lists + refcounts over the pool's physical page ids. The
    authoritative state is host-side and is mutated only at *scheduling
    events* (admission, finish, cache eviction) — exactly like the
    serving engine's ``lens``/``ntok`` mirrors — so the decode hot loop
    stays zero-host-sync: the device only ever sees the (B, nS) int32
    tables the state scatters at admission, and nothing is ever read
    back. Pages are refcounted so several slots (and the prefix cache)
    can reference one physical page; a page returns to the free list
    when its last reference drops.

    Sequence-sharded pools partition the page ids: logical page column
    ``j`` must be served by partition ``j // cols_per_part`` (the shard
    owning that slice of the table), so each partition keeps its own
    free list. An unsharded pool is the 1-partition special case.

    Page id 0 of every partition is RESERVED (never allocated): block
    tables must always point at a *valid* page — the kernel's index map
    fetches unconditionally and masks compute by ``cache_len`` — so
    unassigned table entries and dead-slot writes all land on the
    partition's scratch page.

``PrefixCache``
    Content-addressed sharing of *full* prompt pages: a hash chain over
    page-sized token runs (h_i = H(h_{i-1}, tokens[i*page:(i+1)*page]))
    keyed to the physical page holding that run's KV. A request whose
    prompt prefix hashes onto cached pages attaches to them (refcount++,
    zero prefill compute/storage for the shared prefix); pages are
    shared at page granularity, so a slot can never write a shared page
    — decode writes only at positions >= its prompt length, which lie in
    pages past every full (hashable) page. True divergence *within* a
    page is a hash miss, i.e. a private copy from the start — the
    copy-on-write discipline degenerates to copy-on-admission, and
    ``BlockAllocator.cow`` covers the remaining defensive case (a writer
    holding a page whose refcount > 1 must clone before writing).

    The cache holds one reference of its own per cached page, so cached
    prefixes survive the slot that created them. Under allocation
    pressure the allocator asks the cache to evict: least-recently-used
    chains release their cache reference deepest-page-first (a page is
    only unreachable once its descendants are), which frees the page
    immediately if no live slot still holds it — live state is never
    evicted, only the cache's claim on it.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class BlockPoolError(RuntimeError):
    pass


class OutOfBlocks(BlockPoolError):
    """Allocation failed even after cache eviction."""


class BlockAllocator:
    """Host-authoritative refcounted page allocator over global page ids
    ``[0, n_pages)``; partition ``p`` owns ids
    ``[p * per_part, (p+1) * per_part)`` with local id 0 reserved."""

    def __init__(self, n_pages: int, *, n_partitions: int = 1,
                 cols_per_part: Optional[int] = None):
        if n_pages % n_partitions:
            raise ValueError(f"n_pages={n_pages} not divisible by "
                             f"n_partitions={n_partitions}")
        self.n_pages = n_pages
        self.n_partitions = n_partitions
        self.per_part = n_pages // n_partitions
        if self.per_part < 2:
            raise ValueError("each partition needs >= 2 pages (one is the "
                             "reserved scratch page)")
        # table column -> partition (sharded tables slice columns evenly)
        self.cols_per_part = cols_per_part
        self.refs = np.zeros(n_pages, np.int64)
        # lowest-id-first free lists keep allocation deterministic
        self._free: List[List[int]] = [
            sorted(range(p * self.per_part + 1, (p + 1) * self.per_part),
                   reverse=True)
            for p in range(n_partitions)]
        # eviction hook wired by PrefixCache: evict_cb(partition, n) must
        # try to release >= n pages of that partition; returns #released.
        self._evict_cb: Optional[Callable[[int, int], int]] = None
        # fault hook: when set, _alloc_one asks ``injector.fire(point)``
        # whether to force OutOfBlocks — mid-alloc_cols, so every rollback
        # path upstream (all-or-nothing release, attach decref, wave
        # requeue) is exercised, not just the clean "pool actually full"
        # case. Tests drive it.
        self.injector = None

    # ------------------------------------------------------------ queries

    def part_of_col(self, col: int) -> int:
        """Partition owning logical table column ``col``."""
        if self.cols_per_part is None:
            return 0
        return col // self.cols_per_part

    def part_of(self, gid: int) -> int:
        return gid // self.per_part

    def local_id(self, gid: int) -> int:
        """Partition-local id (what a sharded table stores)."""
        return gid % self.per_part

    def scratch_id(self, part: int = 0) -> int:
        return part * self.per_part

    def free_counts(self) -> np.ndarray:
        return np.array([len(f) for f in self._free], np.int64)

    def n_free(self) -> int:
        return int(sum(len(f) for f in self._free))

    def n_used(self) -> int:
        """Allocated (ref > 0) pages, excluding the reserved scratch."""
        return int((self.refs > 0).sum())

    def refcount(self, gid: int) -> int:
        return int(self.refs[gid])

    # -------------------------------------------------------- alloc / free

    def _alloc_one(self, part: int) -> int:
        if self.injector is not None and \
                self.injector.fire("alloc.out_of_blocks"):
            raise OutOfBlocks(f"partition {part}: injected allocation fault")
        if not self._free[part]:
            if self._evict_cb is not None:
                self._evict_cb(part, 1)
            if not self._free[part]:
                raise OutOfBlocks(
                    f"partition {part}: no free pages "
                    f"({self.per_part - 1} allocatable)")
        gid = self._free[part].pop()
        self.refs[gid] = 1
        return gid

    def alloc_cols(self, cols) -> List[int]:
        """Allocate one fresh page per logical table column (ref = 1).
        All-or-nothing: on failure every page of this call is released."""
        got: List[int] = []
        try:
            for c in cols:
                got.append(self._alloc_one(self.part_of_col(int(c))))
        except OutOfBlocks:
            for gid in got:
                self.decref(gid)
            raise
        return got

    def can_alloc_cols(self, cols) -> bool:
        need = np.zeros(self.n_partitions, np.int64)
        for c in cols:
            need[self.part_of_col(int(c))] += 1
        return bool((need <= self.free_counts()).all())

    def incref(self, gid: int) -> None:
        if self.refs[gid] <= 0:
            raise BlockPoolError(f"incref of unallocated page {gid}")
        self.refs[gid] += 1

    def decref(self, gid: int) -> None:
        if gid % self.per_part == 0:
            raise BlockPoolError(f"page {gid} is the reserved scratch page")
        if self.refs[gid] <= 0:
            raise BlockPoolError(f"double free of page {gid}")
        self.refs[gid] -= 1
        if self.refs[gid] == 0:
            self._free[self.part_of(gid)].append(gid)

    def cow(self, gid: int) -> int:
        """Copy-on-write: called by a writer about to mutate ``gid``.
        Refcount 1 means exclusive ownership — write in place (returns
        ``gid``). Otherwise allocate a fresh page in the same partition,
        drop one reference on the shared page and return the new id; the
        caller must copy the page's contents device-side before writing."""
        if self.refs[gid] <= 0:
            raise BlockPoolError(f"cow of unallocated page {gid}")
        if self.refs[gid] == 1:
            return gid
        new = self._alloc_one(self.part_of(gid))
        # decref, not a raw decrement: _alloc_one may have run the
        # eviction hook, which can drop the cache's reference on ``gid``
        # mid-call — the release here may then be the LAST reference and
        # the page must return to the free list.
        self.decref(gid)
        return new

    def check(self) -> None:
        """Internal-consistency invariants (property tests)."""
        free = sorted(g for f in self._free for g in f)
        assert all(self.refs[g] == 0 for g in free), "free page with refs"
        assert len(set(free)) == len(free), "page double-listed as free"
        live = [g for g in range(self.n_pages)
                if self.refs[g] > 0 or g % self.per_part == 0]
        assert len(free) + len(live) == self.n_pages, "page leaked"


class PrefixCache:
    """Content-addressed full-page prompt sharing over a BlockAllocator."""

    def __init__(self, alloc: BlockAllocator, page: int):
        self.alloc = alloc
        self.page = page
        # chain hash -> (gid, depth, parent_hash)
        self._entries: Dict[bytes, Tuple[int, int, Optional[bytes]]] = {}
        self._children: Dict[bytes, int] = {}    # hash -> #cached children
        self._last_use: Dict[bytes, int] = {}
        self._clock = 0
        self.hits = self.misses = self.hit_tokens = self.evictions = 0
        alloc._evict_cb = self._evict_for

    # ------------------------------------------------------------- hashing

    def chain(self, tokens: np.ndarray) -> List[bytes]:
        """Hash chain over the prompt's *full* pages (len // page of them):
        h_i commits to every token in pages 0..i, so equal hashes mean an
        identical prefix through page i."""
        toks = np.asarray(tokens, np.int32)
        n_full = len(toks) // self.page
        out, h = [], b""
        for i in range(n_full):
            blk = toks[i * self.page:(i + 1) * self.page]
            h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
            out.append(h)
        return out

    # -------------------------------------------------------------- lookup

    def probe(self, tokens: np.ndarray) -> int:
        """Longest cached prefix, in pages. No side effects."""
        n = 0
        for h in self.chain(tokens):
            if h not in self._entries:
                break
            n += 1
        return n

    def hit_gids(self, tokens: np.ndarray,
                 max_pages: Optional[int] = None) -> List[int]:
        """Gids of the longest cached prefix's pages (in page order,
        capped at ``max_pages``). No references taken and no LRU stamp —
        the read-only companion of ``attach`` for admission accounting."""
        gids: List[int] = []
        hashes = self.chain(tokens)
        if max_pages is not None:
            hashes = hashes[:max_pages]
        for h in hashes:
            ent = self._entries.get(h)
            if ent is None:
                break
            gids.append(ent[0])
        return gids

    def attach(self, tokens: np.ndarray,
               max_pages: Optional[int] = None) -> List[int]:
        """Attach to the longest cached prefix (capped at ``max_pages`` —
        an admission wave's shared history depth is the min over its
        rows): increfs every hit page on the caller's behalf and returns
        their gids in page order."""
        gids: List[int] = []
        hashes = self.chain(tokens)
        if max_pages is not None:
            hashes = hashes[:max_pages]
        try:
            for h in hashes:
                ent = self._entries.get(h)
                if ent is None:
                    break
                self._clock += 1
                self._last_use[h] = self._clock
                self.alloc.incref(ent[0])
                gids.append(ent[0])
        except BaseException:
            # exception-safety: release every reference this call took
            # (incref raises before mutating, so gids is exact)
            for gid in gids:
                self.alloc.decref(gid)
            raise
        self.hits += len(gids)
        self.misses += len(hashes) - len(gids)
        self.hit_tokens += len(gids) * self.page
        return gids

    # -------------------------------------------------------------- insert

    def insert(self, tokens: np.ndarray, page_idx: int, gid: int) -> bool:
        """Cache prompt page ``page_idx`` (a *full* page) as ``gid``. The
        cache takes its own reference. Returns False (no ref taken) when
        the chain position is already cached — two identical cold prompts
        admitted in one wave each prefilled privately; first in wins."""
        hashes = self.chain(tokens)
        h = hashes[page_idx]
        if h in self._entries:
            return False
        parent = hashes[page_idx - 1] if page_idx else None
        if parent is not None and parent not in self._entries:
            return False       # ancestor evicted mid-wave: orphan, skip
        self.alloc.incref(gid)
        self._entries[h] = (gid, page_idx, parent)
        if parent is not None:
            self._children[parent] = self._children.get(parent, 0) + 1
        self._clock += 1
        self._last_use[h] = self._clock
        return True

    # ------------------------------------------------------------ eviction

    def _evict_one(self, h: bytes) -> None:
        gid, _, parent = self._entries.pop(h)
        self._last_use.pop(h, None)
        self._children.pop(h, None)
        if parent is not None:
            self._children[parent] -= 1
            if not self._children[parent]:
                del self._children[parent]
        self.alloc.decref(gid)        # frees now iff no slot references it
        self.evictions += 1

    def _evict_for(self, part: int, n: int) -> int:
        """Allocator pressure hook: release cache references until >= ``n``
        pages of ``part`` hit the free list (or nothing that can relieve
        ``part`` is left). Only *leaf* entries (no cached children) are
        evictable — an interior page must outlive its descendants so
        chains stay walkable; evicting LRU leaves peels chains from the
        tail. On a partitioned pool a chain's page for column ``c`` lives
        in partition ``part_of_col(c)``, so exposing a page of ``part``
        may require peeling deeper leaves in LATER partitions first —
        but a chain that never reaches ``part`` cannot relieve it, and
        its leaves are left alone (draining them would strip the whole
        cache without freeing a single page where it is needed)."""
        freed = 0
        while freed < n:
            leaves = [h for h in self._entries if h not in self._children]
            in_part = [h for h in leaves
                       if self.alloc.part_of(self._entries[h][0]) == part]
            if not in_part:
                # fall back only to leaves whose chain passes through the
                # starved partition (chains start at column 0, so a leaf
                # deeper than ``part``'s column range has cached ancestors
                # inside it): peeling such a leaf exposes an ancestor
                # strictly closer to — eventually inside — ``part``.
                in_part = [h for h in leaves
                           if self.alloc.part_of_col(self._entries[h][1])
                           > part]
                if not in_part:
                    break
            pick = min(in_part, key=lambda h: self._last_use[h])
            gid = self._entries[pick][0]
            was = self.alloc.refcount(gid)
            self._evict_one(pick)
            if was == 1 and self.alloc.part_of(gid) == part:
                freed += 1
        return freed

    def invalidate(self, n: Optional[int] = None, rng=None) -> int:
        """Drop ``n`` cached entries (all of them when ``n`` is None),
        leaf-first so chains stay walkable, releasing the cache's own
        reference on each page. This is the recovery action for detected
        prefix corruption — a suspect entry is dropped, never served.
        (The engine's fault handling that calls it is not ported yet;
        the refcount storms in the tests drive it.) Live slots are
        untouched: only the cache's claim is released, and the cache is
        transparent to serving semantics (a dropped entry costs a future
        re-prefill, never a wrong token). ``rng`` (numpy Generator)
        picks victims; None peels deterministically."""
        want = len(self._entries) if n is None else min(int(n),
                                                       len(self._entries))
        dropped = 0
        while dropped < want and self._entries:
            leaves = [h for h in self._entries if h not in self._children]
            pick = leaves[int(rng.integers(len(leaves)))] \
                if rng is not None else leaves[0]
            self._evict_one(pick)
            dropped += 1
        return dropped

    # ------------------------------------------------------------ teardown

    def drop_all(self) -> None:
        """Release every cache reference (tests/teardown)."""
        while self._entries:
            leaves = [h for h in self._entries if h not in self._children]
            for h in leaves:
                self._evict_one(h)

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {"pages": len(self._entries), "hits": self.hits,
                "misses": self.misses, "hit_tokens": self.hit_tokens,
                "evictions": self.evictions,
                "hit_rate": self.hits / lookups if lookups else 0.0}
