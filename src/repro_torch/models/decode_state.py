"""Per-slot serving state (port of ``repro/models/decode_state.py``,
contiguous and paged KV caches).

A ``DecodeState`` owns one policy group's pool: the stacked KV cache
(``data``), allocated once at pool width and capacity, and the per-slot
device-side position vector (``pos_dev``). The engine talks to it only
through ``prefill_into`` / ``step`` / ``reset_slots`` / ``max_len`` /
``prefill_width`` / ``check_integrity``; paged states add the admission
budget queries (``free_with_evictable`` / ``admission_need`` /
``admission_pin``) and ``pool_stats``. Positions advance on the device,
and emitted tokens stay there: a decode step ships nothing to the host.
``decode_state_for`` picks the class.

Chunked admission (port of ``decode_state.py:545-621``; paged
``:1545-1620``): ``begin_chunk`` reserves a slot and pins its position
at the prompt length while the slot stays dead to decode,
``prefill_chunk_into`` advances every prefilling row by one chunk in one
fixed-shape program over the whole pool (rows with no tokens this tick
stay bit for bit), ``finish_chunk`` completes the admission (paged:
publishes the full pages to the prefix cache) and ``abort_chunk`` rolls
the reservation back. The lifecycle (``:609-700``; paged
``:1622-1690``): ``set_injector``, ``poison_slot``, ``corrupt_prefix``,
``scrub_slot`` (the quarantine release: zero the slot's rows, so no NaN
outlives its request), ``recover`` and ``set_policy``.

Given a ``distributed.ShardGroup`` (``comm``), a state holds only its
rank's slice of the sequence axis (port of the reference's sequence-
sharded ``KVDecodeState`` / ``PagedKVDecodeState``,
``decode_state.py:94-165,824-916,996-1060,1231-1360``): the contiguous
cache is (L, B, S/n, Hkv, hd), the paged pool n_pages/n pages with its
own scratch page 0. Every rank runs the same prefill (replicated, on the
FlashAttention kernel) and keeps its slice, and decodes through the
partial-statistics kernels and the policy's merge. Admission is
monolithic, as the reference's sharded states are.

The decode step is the reference's donated step (``decode_state.py:
509-515,1501``, jitted with ``donate_argnums`` at ``:131`` / ``:1026``)
in the port's form: its carry (``carry()``: the cache leaves, positions,
block tables, the engine's input tokens and live mask, and a static
(pool_width, 1) output buffer ``out``) is allocated once and written in
place, never rebound, and an unsharded state runs the step through one
``runtime.graphs.StepGraph`` per policy it can run: captured by
``capture`` when the engine builds the group, over the empty pool, so no
request waits on the capture; replayed by every step after (the pool
width is fixed, so one graph serves each policy). The chunk program is a
second ``StepGraph`` per (policy, chunk width), captured there too,
over static input buffers that each tick writes with one host-to-device
copy. Switching policy (the degradation ladder) is then a lookup.
``recover`` zeroes the carry in place, so the graphs stay valid. Sharded
states step eagerly: their gloo collectives stage through the host,
which a graph cannot hold.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.registry import hot_path
from repro_torch.runtime.graphs import StepGraph
from . import transformer
from .block_pool import OutOfBlocks


def host_to_device(arr, device):
    """A host array on ``device``. On the card the copy is queued from
    pinned memory without waiting (the pinned block is not reused until
    the copy has run), so a tick that ships its inputs keeps the host
    ahead of the device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _guard_tokens(logits, last=None):
    """Greedy next token, with ``-1`` for a row whose logits are not all
    finite. Passing ``last`` makes the sentinel sticky: one poisoned step
    marks the slot for good."""
    tok = logits.argmax(dim=-1).to(torch.int32)
    bad = ~torch.isfinite(logits).all(dim=-1)
    if last is not None:
        bad = bad | (last < 0)
    return torch.where(bad, -1, tok)


def _len_bucket(n: int, cap: int) -> int:
    """Pow2-rounded prefill length (>= 8), capped at the cache capacity,
    so ragged admission shares a small set of prefill shapes."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


class DecodeState:
    """Pool algebra shared by the serving states; ``KVDecodeState`` is
    the one family this slice ports."""

    kind = "state"
    is_paged = False

    def __init__(self, cfg, params, policy, pool_width, cache_s, *, device,
                 comm=None, cuda_graphs=True):
        self.cfg, self.params, self.policy = cfg, params, policy
        self.pool_width, self.cache_s = pool_width, cache_s
        self.device = device
        self.data = None       # allocated by capture or first admission
        self.pos_dev = torch.zeros(pool_width, dtype=torch.int32,
                                   device=device)
        self.out = torch.zeros((pool_width, 1), dtype=torch.int32,
                               device=device)      # the step's tokens
        self.shard = self._shard_spec(comm)
        self.cuda_graphs = cuda_graphs
        self.graphs: dict = {}      # policy -> decode StepGraph
        self.chunk_progs: dict = {}  # (policy, width) -> chunk program
        self._sealed = False        # capture done: no graph made after
        self.graph = self._decode_graph(policy)
        self.injector = None        # ft.inject.FaultInjector (chaos)

    def _shard_spec(self, comm):
        """This rank's slice of the sequence axis (None: the whole)."""
        if comm is None:
            return None
        from repro_torch.distributed import ShardSpec
        if self.cache_s % comm.world:
            raise ValueError(f"cache length {self.cache_s} not divisible by "
                             f"{comm.world} shards")
        return ShardSpec(comm, self.cache_s // comm.world)

    @property
    def shards(self) -> int:
        return 1 if self.shard is None else self.shard.world

    def max_len(self):
        """Length at which a slot must stop decoding (None: unbounded)."""
        return None

    def prefill_width(self, n: int) -> int:
        """Admission width for a wave whose longest prompt is ``n``."""
        return _len_bucket(n, self.cache_s)

    def prefill_into(self, slots, toks, plens):
        """One pool-width ragged prefill; the admitted rows land in freed
        slots. ``toks`` (pool_width, sp) right-padded prompts, ``plens``
        (pool_width,) real lengths (1 for rows without a request). Returns
        the (pool_width, 1) first greedy tokens on the device."""
        self._maybe_inject_admission_fault()
        toks_t = torch.as_tensor(toks, device=self.device)
        plens_t = torch.as_tensor(plens, device=self.device)
        logits, pref = transformer.prefill(self.params, self.cfg, toks_t,
                                           prompt_len=plens_t,
                                           policy=self.policy)
        off, local = ((0, self.cache_s) if self.shard is None
                      else (self.shard.offset, self.shard.local_s))
        self._ensure_cache()
        sl = torch.as_tensor(np.asarray(slots), device=self.device)
        end = min(off + local, toks.shape[1])    # this slice's prompt rows
        if end > off:
            for name in ("k", "v"):
                pool, rows = self.data[name], pref[name][:, sl]
                if self.cfg.kv_cache_layout == "bhsd":
                    pool[:, sl, :, :end - off] = rows[:, :, :, off:end]
                else:
                    pool[:, sl, :end - off] = rows[:, :, off:end]
        self.pos_dev[sl] = plens_t[sl].to(torch.int32)
        return _guard_tokens(logits)

    def _new_cache(self):
        local = self.cache_s if self.shard is None else self.shard.local_s
        return transformer.init_cache(self.cfg, self.pool_width, local,
                                      self.device)

    def _new_graph(self, key, what):
        """A StepGraph for ``key``, unless every graph was captured
        already: on the card a new graph would capture on the request
        path."""
        if self._sealed and self.cuda_graphs and self.device.type == "cuda":
            raise RuntimeError(f"{what} for {key!r} was not captured when "
                               f"the group was built")
        graph = StepGraph(self.device, enabled=self.cuda_graphs)
        graph.what = what
        return graph

    def _decode_graph(self, policy):
        if self.shard is not None:
            return None          # sharded: the step runs eagerly
        if policy not in self.graphs:
            self.graphs[policy] = self._new_graph(policy, "decode step")
        return self.graphs[policy]

    def _ensure_cache(self):
        if self.data is None:
            self.data = self._new_cache()

    def capture(self, last, live, policies=(), chunks=()):
        """Allocate the cache and capture, before any request, the decode
        step under the state's policy and each of ``policies``, and the
        chunk program at each (policy, width) of ``chunks``, where steps
        are graphs on the card (elsewhere a no-op). Every slot is dead
        (``live`` all 0) and every chunk row inert (no tokens), so the
        warm-ups write only what a step writes for dead slots: KV at
        position 0 of a contiguous row, which admission overwrites, and
        the paged scratch page."""
        if self.graph is None or not self.graph.use_graph:
            return
        self._ensure_cache()
        base = self.policy
        for pol in (base, *policies):
            self.set_policy(pol)
            self.graph(self._step, self.carry(last, live))
        for pol, width in chunks:
            self.set_policy(pol)
            prog = self._chunk_prog(width)
            prog["graph"](self._chunk_step, self._chunk_carry(prog))
        self.set_policy(base)
        self._sealed = True

    @hot_path
    def carry(self, last, live) -> dict:
        """Every tensor the decode step reads or writes, by name: the
        engine's input tokens ``last`` (pool_width, 1) and live mask
        ``live`` (pool_width,), the positions, the output buffer and the
        cache leaves. All allocated once; the step writes them in place."""
        c = {"last": last, "live": live, "pos": self.pos_dev,
             "out": self.out}
        c.update(self.data)
        return c

    @hot_path
    def step(self, last, live):
        """One decode step over the pool; live slots' positions advance
        by one on the device. Returns ``out``, the static (pool_width, 1)
        buffer holding the next tokens until the next step."""
        c = self.carry(last, live)
        if self.graph is None:
            self._step(c)          # sharded: gloo stages through the host
        else:
            self.graph(self._step, c)
        return self.out

    @hot_path
    def _step(self, c):
        """The step over the carry ``c``, in place: tokens into ``out``,
        positions of live slots advanced."""
        logits = self._logits(c)
        c["out"].copy_(_guard_tokens(logits, c["last"]))
        c["pos"].add_(c["live"])

    @hot_path
    def _logits(self, c):
        cache = {"k": c["k"], "v": c["v"]}
        if self.shard is None:
            logits, _ = transformer.decode_step(
                self.params, self.cfg, c["last"], cache, c["pos"],
                policy=self.policy, live=c["live"])
        else:
            logits, _ = transformer.decode_step_sharded(
                self.params, self.cfg, c["last"], cache, c["pos"],
                policy=self.policy, shard=self.shard, live=c["live"])
        return logits

    def graph_stats(self) -> dict:
        """How the step runs ("graph", "eager", or eager because the
        cache is sharded), with the decode graphs' captures and replays
        and the chunk programs' (``chunk_*``), summed over policies and
        widths."""
        def total(graphs, prefix=""):
            gs = [g.stats() for g in graphs]
            return {f"{prefix}captures": sum(g["captures"] for g in gs),
                    f"{prefix}replays": sum(g["replays"] for g in gs),
                    f"{prefix}capture_s": sum(g["capture_s"] for g in gs)}

        out = total([p["graph"] for p in self.chunk_progs.values()],
                    "chunk_")
        if self.graph is None:
            return {"mode": "eager (sharded: collectives stage through the "
                            "host)", **total([]), **out}
        return {"mode": self.graph.stats()["mode"],
                **total(self.graphs.values()), **out}

    # ------------------------------------------------------ chunked prefill

    def supports_chunked(self) -> bool:
        """Whether this pool admits prompts through the chunk protocol.
        Contiguous pools can; ``chunk_width`` refuses a sharded one."""
        return True

    def chunk_width(self, c: int) -> int:
        """The chunk program's width for a requested chunk of ``c``
        tokens: at least 1 and at most the cache length (a prompt never
        needs more lanes, and the chunk's write relies on C <= S)."""
        if self.shard is not None:
            raise NotImplementedError(
                "chunked prefill of a sequence-sharded contiguous cache is "
                "not ported (ROADMAP A10: the sharded chunk program); "
                "serve this group with prefill_chunk=0")
        return max(1, min(int(c), self.cache_s))

    def begin_chunk(self, slot, prompt, plen) -> int:
        """Start chunked admission of a ``plen``-token prompt into
        ``slot``; returns the cursor (tokens already cached). The slot's
        position is pinned at ``plen`` now: decode steps in between see a
        dead row (live == 0) and leave its cache and position untouched,
        so the completion tick only flips the slot live."""
        del prompt
        self._ensure_cache()
        self._maybe_inject_admission_fault()
        self.pos_dev[int(slot)] = int(plen)
        return 0

    def finish_chunk(self, slot, prompt, plen):
        """Complete a chunked admission (paged pools publish the prompt's
        full pages to the prefix cache)."""

    def abort_chunk(self, slot):
        """Roll back a chunked admission: release what ``begin_chunk``
        reserved (pages, prefix references, table row, pinned position)
        and park the slot; ``reset_slots`` is that release."""
        self.reset_slots([int(slot)])

    def _chunk_prog(self, width):
        """The chunk program at ``width`` under the state's policy: its
        StepGraph, a static (pool_width, width + 2) int32 input buffer
        (tokens, then the cursor and the valid count of each row) and a
        static (pool_width, 1) output buffer."""
        key = (self.policy, int(width))
        prog = self.chunk_progs.get(key)
        if prog is None:
            dev = self.device
            prog = {"graph": self._new_graph(key, "chunk program"),
                    "in": torch.zeros((self.pool_width, key[1] + 2),
                                      dtype=torch.int32, device=dev),
                    "out": torch.zeros((self.pool_width, 1),
                                       dtype=torch.int32, device=dev)}
            self.chunk_progs[key] = prog
        return prog

    @hot_path
    def _chunk_carry(self, prog) -> dict:
        c = {"in": prog["in"], "out": prog["out"]}
        c.update(self.data)
        return c

    @hot_path
    def prefill_chunk_into(self, toks, offs, clens):
        """One chunk over the whole pool: ``toks`` (pool_width, C) host
        tokens, ``offs`` / ``clens`` (pool_width,) each row's cursor and
        valid count (0: the row is not prefilling this tick and stays bit
        for bit). The inputs reach the program's static buffer in one
        host-to-device copy. Returns the program's static (pool_width, 1)
        output: the greedy token at each row's last valid lane, until the
        next chunk."""
        self._ensure_cache()
        prog = self._chunk_prog(toks.shape[1])
        host = np.concatenate([toks, offs[:, None], clens[:, None]], axis=1)
        prog["in"].copy_(host_to_device(host.astype(np.int32), self.device))
        prog["graph"](self._chunk_step, self._chunk_carry(prog))
        return prog["out"]

    @hot_path
    def _chunk_step(self, c):
        width = c["in"].shape[1] - 2
        logits = self._chunk_logits(c, c["in"][:, :width], c["in"][:, width],
                                    c["in"][:, width + 1])
        c["out"].copy_(_guard_tokens(logits))

    @hot_path
    def _chunk_logits(self, c, toks, offs, clens):
        cache = {"k": c["k"], "v": c["v"]}
        logits, _ = transformer.prefill_chunk(self.params, self.cfg, toks,
                                              cache, offs, clens,
                                              policy=self.policy)
        return logits

    # ------------------------------------------------------------ lifecycle

    def set_injector(self, inj):
        """Wire the chaos harness (``ft.inject.FaultInjector``) into this
        pool's admission paths; None disables it."""
        self.injector = inj

    def _maybe_inject_admission_fault(self):
        if self.injector is not None and \
                self.injector.fire("admit.out_of_blocks"):
            raise OutOfBlocks("injected: admission rejected")

    def poison_slot(self, slot) -> bool:
        """Write NaN over one slot's cache rows (the ``decode.poison``
        fault); the step's finite-logits guard must turn it into the
        sentinel token. False when there is nothing to poison yet."""
        if self.data is None:
            return False
        for t in self.data.values():
            t[:, int(slot)] = float("nan")
        return True

    def corrupt_prefix(self, injector) -> int:
        """Drop prefix-cache entries (the ``prefix.corrupt`` fault: a
        suspect entry is dropped, never served). Contiguous pools have no
        cache. Returns the entries dropped."""
        return 0

    def scrub_slot(self, slot):
        """Quarantine release: zero every row of the slot, in place, then
        park it. ``reset_slots`` keeps KV rows (decode masks them by
        length), but the plain tiers compute ``p @ v`` over every row,
        and 0 x NaN is NaN: a NaN row past a later occupant's length
        would reach its output."""
        if self.data is not None:
            for t in self.data.values():
                t[:, int(slot)] = 0
        self.reset_slots([int(slot)])

    def recover(self):
        """Reset the pool after a failed decode dispatch: every carry
        tensor is zeroed in place (positions and the cache), so the
        captured graphs, which hold their storage, stay valid. The engine
        re-queues every in-flight request."""
        self.pos_dev.zero_()
        if self.data is not None:
            for t in self.data.values():
                t.zero_()

    def set_policy(self, policy):
        """Run the decode step and the chunk programs under ``policy``
        (the degradation ladder's lever): a lookup of graphs captured at
        construction, never a capture on the request path."""
        self.graph = self._decode_graph(policy)
        self.policy = policy

    def reset_slots(self, slots):
        """Park freed slots at position 0. KV rows are not zeroed: decode
        masks them by cache_len and admission overwrites them."""
        self.pos_dev[torch.as_tensor(np.asarray(slots),
                                     device=self.device)] = 0

    def check_integrity(self, live_slots=()):
        """Invariant sweep (it syncs; never on the decode path): freed
        slots must be parked at position 0."""
        live = {int(j) for j in live_slots}
        pos = self.pos_dev.cpu().numpy()
        for j in range(self.pool_width):
            if j not in live and int(pos[j]) != 0:
                raise AssertionError(
                    f"freed slot {j} parked at pos {int(pos[j])}")


class KVDecodeState(DecodeState):
    """Dense transformer: contiguous KV cache + per-slot positions."""

    kind = "kv"

    def max_len(self):
        # a linear cache is exhausted when the next write would fall past
        # its last row
        return self.cache_s


# --------------------------------------------------------------- paged pool

def _paged_scatter(pool, rows, gids, page, lay):
    """Write admitted rows' prefill KV into their pool pages, in place.
    ``pool`` (L, N, page, Hkv, hd) ("bshd") / (L, N, Hkv, page, hd)
    ("bhsd"); ``rows`` (L, n, sp, Hkv, hd) / (L, n, Hkv, sp, hd); ``gids``
    (n, ceil(sp/page)) pool pages. A partial last page is zero-padded:
    those positions lie past every reader's cache_len until decode
    overwrites them."""
    g = torch.as_tensor(np.asarray(gids).reshape(-1), device=pool.device)
    L, n = rows.shape[0], rows.shape[1]
    nc = g.shape[0] // n
    if lay == "bhsd":
        hkv, sp, hd = rows.shape[2:]
        r = torch.nn.functional.pad(rows, (0, 0, 0, nc * page - sp))
        r = r.reshape(L, n, hkv, nc, page, hd).permute(0, 1, 3, 2, 4, 5)
        r = r.reshape(L, n * nc, hkv, page, hd)
    else:
        sp, hkv, hd = rows.shape[2:]
        r = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, nc * page - sp))
        r = r.reshape(L, n * nc, page, hkv, hd)
    pool[:, g] = r.to(pool.dtype)


def _paged_gather_hist(pool, gids, page, lay):
    """Gather prefix pages into a contiguous (L, B, hP*page, Hkv, hd)
    history, always "bshd" (the ``hist`` contract of
    ``transformer.prefill``). Rows without a history point at the scratch
    page; their gathered content is arbitrary and their outputs are
    ignored."""
    g = torch.as_tensor(np.asarray(gids), device=pool.device)
    b, hp = g.shape
    got = pool[:, g.reshape(-1)]
    L = got.shape[0]
    if lay == "bhsd":                        # (L, B*hP, Hkv, page, hd)
        hkv, hd = got.shape[2], got.shape[4]
        got = got.reshape(L, b, hp, hkv, page, hd).permute(0, 1, 2, 4, 3, 5)
        return got.reshape(L, b, hp * page, hkv, hd)
    return got.reshape(L, b, hp * page, *got.shape[3:])


def _paged_integrity(state, live):
    """Paged-pool invariant sweep: the allocator's self-check (free-list
    conservation), freed slots hold no pages and have all-zero table
    rows, and every page's refcount equals its holders (slot tables plus
    prefix-cache entries): conservation with no orphans. One table
    readback; runs in tests and at shutdown, never on the decode path."""
    state.alloc.check()
    holders: dict = {}
    for j, pages in enumerate(state.slot_pages):
        if j not in live and pages:
            raise AssertionError(
                f"freed slot {j} still holds {len(pages)} pages")
        for gid in pages:
            holders[int(gid)] = holders.get(int(gid), 0) + 1
    if state.pcache is not None:
        for gid, _, _ in state.pcache._entries.values():
            holders[int(gid)] = holders.get(int(gid), 0) + 1
    for gid in range(state.n_pages):
        if state.alloc.local_id(gid) == 0:    # a partition's scratch page
            continue
        refs = state.alloc.refcount(gid)
        held = holders.get(gid, 0)
        if refs != held:
            raise AssertionError(
                f"page {gid}: refcount {refs} != {held} holders")
    tab = state.tables.cpu().numpy()
    for j in range(state.pool_width):
        if j not in live and tab[j].any():
            raise AssertionError(f"freed slot {j} has a nonzero table row")


class PagedKVDecodeState(KVDecodeState):
    """Dense transformer over a paged pool: fixed-size KV pages behind
    per-slot block tables, a host-side refcounted allocator, and a
    shared-prefix page cache (port of ``PagedKVDecodeState``,
    ``decode_state.py:1207-1505``, monolithic admission).

      * full reservation: a slot's whole table (ceil(cache_s/page)
        columns, minus its prefix-cache hits) is allocated at admission,
        so decode never touches the allocator or the tables;
      * oversubscription comes from sharing: N slots on a shared prefix
        of P pages hold P + N*suffix physical pages;
      * no shared page is ever written: decode writes only at positions
        >= the prompt length, past every full (shareable) prompt page.

    Sequence-sharded over n ranks (``comm``), the allocator has one
    partition per rank: table column c belongs to rank c // (ns/n), global
    page ids are partition-major, and each rank's pool holds only its
    partition (local id = global id % pages per partition, local page 0
    its scratch page). The host bookkeeping (allocator, prefix cache,
    slot pages) is the same on every rank; the device tables hold this
    rank's columns as local ids. The default budget is a full reservation
    per slot plus one scratch page per partition.
    """

    kind = "paged-kv"
    is_paged = True

    def __init__(self, cfg, params, policy, pool_width, cache_s, *, device,
                 comm=None, cuda_graphs=True, n_pages=None,
                 prefix_cache=True):
        from .block_pool import BlockAllocator, PrefixCache
        self.page = policy.block_page
        self.ns = -(-cache_s // self.page)          # table columns per slot
        super().__init__(cfg, params, policy, pool_width, cache_s,
                         device=device, comm=comm, cuda_graphs=cuda_graphs)
        nsh = self.shards
        self.n_pages = int(n_pages if n_pages is not None
                           else nsh + pool_width * self.ns)
        if self.n_pages % nsh:
            raise ValueError(f"page budget {self.n_pages} not divisible by "
                             f"{nsh} shards")
        self.alloc = BlockAllocator(
            self.n_pages, n_partitions=nsh,
            cols_per_part=None if nsh == 1 else self.ns // nsh)
        self.pcache = (PrefixCache(self.alloc, self.page) if prefix_cache
                       else None)
        self.slot_pages = [[] for _ in range(pool_width)]
        self.tables = torch.zeros((pool_width, self.ns // nsh),
                                  dtype=torch.int32, device=device)
        self.wave_hist = 0      # prefix-cache tokens of the last wave's rows
        self._chunk_hit = {}    # slot -> prefix-hit pages (chunked)

    def _shard_spec(self, comm):
        if comm is None:
            return None
        from repro_torch.distributed import ShardSpec
        if self.ns % comm.world:
            raise ValueError(f"{self.ns} pages per slot not divisible by "
                             f"{comm.world} shards")
        return ShardSpec(comm, self.ns // comm.world * self.page)

    def _own_cols(self):
        """[first, end) table columns held by this rank."""
        n = self.ns // self.shards
        r = 0 if self.shard is None else self.shard.rank
        return r * n, (r + 1) * n

    # ------------------------------------------------------------- budget

    def free_with_evictable(self):
        """Per-partition page budget: free pages plus prefix-cache pages
        held only by the cache (refcount 1). Live state is never evicted,
        so only those are reclaimable."""
        free = self.alloc.free_counts()
        if self.pcache is not None:
            for gid, _, _ in self.pcache._entries.values():
                if self.alloc.refcount(gid) == 1:
                    free[self.alloc.part_of(gid)] += 1
        return free

    def admission_need(self, prompt, *, cap_h=None):
        """(per-partition fresh-page counts, hit depth in pages) for
        admitting one request: its own prefix-cache depth (capped at
        ``cap_h``, the wave's depth, and leaving >= 1 suffix token), and
        the reserved columns [h, ns) as fresh pages of their partitions."""
        h = 0
        if self.pcache is not None:
            p = np.asarray(prompt).reshape(-1)
            h = min(self.pcache.probe(p), (len(p) - 1) // self.page)
        if cap_h is not None:
            h = min(h, cap_h)
        need = np.zeros(self.alloc.n_partitions, np.int64)
        for c in range(h, self.ns):
            need[self.alloc.part_of_col(c)] += 1
        return need, h

    def admission_pin(self, prompt, h, reserved):
        """Evictable supply this admission consumes beyond its fresh
        pages: its first ``h`` hit pages that are cache-only (refcount 1)
        and not already in ``reserved`` (pinned earlier in the wave).
        ``free_with_evictable`` counts them as reclaimable while
        ``admission_need`` counts them as hits; attach pins them, so the
        gate must debit them once. Returns (per-partition counts, gids)."""
        pin = np.zeros(self.alloc.n_partitions, np.int64)
        gids = []
        if self.pcache is not None and h:
            p = np.asarray(prompt).reshape(-1)
            for gid in self.pcache.hit_gids(p, max_pages=h):
                if gid not in reserved and self.alloc.refcount(gid) == 1:
                    pin[self.alloc.part_of(gid)] += 1
                    gids.append(gid)
        return pin, gids

    def pool_stats(self) -> dict:
        s = {"page": self.page, "pages_total": self.n_pages,
             "pages_allocatable": self.n_pages - self.alloc.n_partitions,
             "pages_used": self.alloc.n_used(),
             "pages_free": self.alloc.n_free()}
        s["utilization"] = s["pages_used"] / max(s["pages_allocatable"], 1)
        if self.pcache is not None:
            s["prefix"] = self.pcache.stats()
        return s

    # -------------------------------------------------------- engine ops

    def prefill_into(self, slots, toks, plens):
        """Admit one wave: probe the prefix cache (the wave's history
        depth is the min over its rows), attach every row's hits before
        any fresh allocation, reserve the rest of each table, prefill
        (cold: whole prompts; hot: suffixes against the gathered
        history), scatter the new KV into the pages, publish full prompt
        pages to the cache, and write the table rows and positions. On
        OutOfBlocks every page the wave holds is released before it
        propagates, so the engine can re-queue the wave."""
        self._ensure_cache()
        self._maybe_inject_admission_fault()
        slots = [int(j) for j in np.asarray(slots).reshape(-1)]
        toks = np.asarray(toks)
        plens = np.asarray(plens).reshape(-1)
        page, ns = self.page, self.ns

        # ---- prefix probe; a hit must leave >= 1 suffix token
        h_pages = 0
        if self.pcache is not None and slots:
            h_pages = min(min(self.pcache.probe(toks[j, :plens[j]]),
                              (int(plens[j]) - 1) // page) for j in slots)

        # ---- attach the shared prefix FIRST, for every row, so a later
        # row's allocation cannot evict a chain another row probed; if a
        # probed page vanished anyway, degrade the wave's depth
        held = {j: [] for j in slots}
        if h_pages:
            try:
                for j in slots:
                    held[j] = self.pcache.attach(toks[j, :plens[j]],
                                                 max_pages=h_pages)
            except BaseException:
                for gids in held.values():
                    for gid in gids:
                        self.alloc.decref(int(gid))
                raise
            got = min(len(held[j]) for j in slots)
            if got < h_pages:
                for j in slots:
                    for gid in held[j][got:]:
                        self.alloc.decref(int(gid))
                    held[j] = held[j][:got]
                h_pages = got
        h = h_pages * page

        # ---- full reservation, all or nothing for the wave
        new_tab = {}
        try:
            for j in slots:
                new_tab[j] = held[j] + self.alloc.alloc_cols(
                    range(h_pages, ns))
        except OutOfBlocks:
            for j in slots:
                for gid in new_tab.get(j, held[j]):
                    self.alloc.decref(int(gid))
            raise
        for j in slots:
            self.slot_pages[j] = new_tab[j]

        # ---- prefill (cold, or the suffix against the history) + scatter
        lay = self.cfg.kv_cache_layout
        dev = self.device
        if h_pages == 0:
            logits, pref = transformer.prefill(
                self.params, self.cfg, torch.as_tensor(toks, device=dev),
                prompt_len=torch.as_tensor(plens, device=dev),
                policy=self.policy)
            sp = toks.shape[1]
        else:
            hist_tab = np.zeros((self.pool_width, h_pages), np.int64)
            for j in slots:
                hist_tab[j] = new_tab[j][:h_pages]
            hist = {name: self._gather_hist(self.data[name], hist_tab)
                    for name in ("k", "v")}
            sp = _len_bucket(int((plens - h).max()), self.cache_s - h)
            toks_suf = np.ones((self.pool_width, sp), toks.dtype)
            plens_suf = np.ones((self.pool_width,), plens.dtype)
            for j in slots:
                n_suf = int(plens[j]) - h
                toks_suf[j, :n_suf] = toks[j, h:h + n_suf]
                plens_suf[j] = n_suf
            logits, pref = transformer.prefill(
                self.params, self.cfg, torch.as_tensor(toks_suf, device=dev),
                prompt_len=torch.as_tensor(plens_suf, device=dev),
                policy=self.policy, hist=hist)
        # this rank's columns of the prefilled span [h_pages, h_pages + nc)
        nc = -(-sp // page)
        c0, c1 = self._own_cols()
        a, e = max(h_pages, c0), min(h_pages + nc, c1)
        sl = torch.as_tensor(np.asarray(slots), device=dev)
        if e > a:
            gids = self._local_ids([new_tab[j][a:e] for j in slots])
            r0 = (a - h_pages) * page               # rows of the prefill
            for name in ("k", "v"):
                rows = pref[name][:, sl]
                rows = (rows[:, :, :, r0:(e - h_pages) * page]
                        if lay == "bhsd" else
                        rows[:, :, r0:(e - h_pages) * page])
                _paged_scatter(self.data[name], rows, gids, page, lay)

        # ---- publish full prompt pages (the cache takes its own refs)
        if self.pcache is not None:
            for j in slots:
                prompt = toks[j, :plens[j]]
                for c in range(h_pages, int(plens[j]) // page):
                    self.pcache.insert(prompt, c, self.slot_pages[j][c])

        # ---- table rows + positions of the admitted slots
        self.tables[sl] = torch.as_tensor(
            self._local_ids([new_tab[j][c0:c1] for j in slots]), device=dev)
        self.pos_dev[sl] = torch.as_tensor(plens[slots].astype(np.int32),
                                           device=dev)
        self.wave_hist = h
        return _guard_tokens(logits)

    def _new_cache(self):
        return transformer.init_paged_cache(self.cfg, self.alloc.per_part,
                                            self.page, self.device)

    def _local_ids(self, gids):
        """Pool page ids of this rank for global page ids (partition-local
        on a sharded pool: each rank indexes its own pool)."""
        return (np.asarray(gids, np.int64) % self.alloc.per_part).astype(
            np.int32)

    def _gather_hist(self, pool, hist_tab):
        """The (L, pool_width, hP*page, Hkv, hd) prefix history of the
        global page ids ``hist_tab`` (pool_width, hP). Sharded, each rank
        gathers the columns it holds and one all_gather brings every
        rank the others' (admission only, never on the decode path)."""
        page, lay = self.page, self.cfg.kv_cache_layout
        if self.shard is None:
            return _paged_gather_hist(pool, hist_tab, page, lay)
        # ids of other ranks' pages land on arbitrary local pages here;
        # only each column's owner's copy is kept
        mine = _paged_gather_hist(pool, self._local_ids(hist_tab), page, lay)
        got = self.shard.comm.all_gather(mine)    # (n, L, B, hP*page, ...)
        cols = self.ns // self.shards
        return torch.cat([got[c // cols, :, :, c * page:(c + 1) * page]
                          for c in range(hist_tab.shape[1])], dim=2)

    @hot_path
    def carry(self, last, live) -> dict:
        c = super().carry(last, live)
        c["tables"] = self.tables
        return c

    @hot_path
    def _logits(self, c):
        cache = {"k": c["k"], "v": c["v"]}
        if self.shard is None:
            logits, _ = transformer.decode_step_paged(
                self.params, self.cfg, c["last"], cache, c["tables"],
                c["pos"], policy=self.policy, live=c["live"])
        else:
            logits, _ = transformer.decode_step_paged_sharded(
                self.params, self.cfg, c["last"], cache, c["tables"],
                c["pos"], policy=self.policy, shard=self.shard,
                live=c["live"])
        return logits

    # ---------------------------------------------------- chunked prefill

    def supports_chunked(self) -> bool:
        # a chunk writes through the device tables, whose ids are this
        # rank's only on an unsharded pool: sharded paged pools admit
        # monolithically, as the reference's do
        return self.shard is None

    def begin_chunk(self, slot, prompt, plen) -> int:
        """Reserve the slot's whole table now (the full-reservation
        invariant of monolithic admission) and attach this prompt's own
        prefix-cache hits (its own depth, not a wave's). The cursor
        starts past the attached pages; chunks never write them (only
        full pages are shared, and writes begin at the cursor). On
        OutOfBlocks everything taken is released first."""
        self._ensure_cache()
        self._maybe_inject_admission_fault()
        j, plen = int(slot), int(plen)
        prompt = np.asarray(prompt).reshape(-1)[:plen]
        h_pages, held = 0, []
        if self.pcache is not None:
            # a hit must leave >= 1 suffix token to emit logits from
            h_pages = min(self.pcache.probe(prompt), (plen - 1) // self.page)
            if h_pages:
                held = self.pcache.attach(prompt, max_pages=h_pages)
                h_pages = len(held)
        try:
            tab = held + self.alloc.alloc_cols(range(h_pages, self.ns))
        except OutOfBlocks:
            for gid in held:
                self.alloc.decref(int(gid))
            raise
        self.slot_pages[j] = tab
        self._chunk_hit[j] = h_pages
        self.tables[j].copy_(host_to_device(self._local_ids(tab), self.device))
        self.pos_dev[j] = plen
        return h_pages * self.page

    def finish_chunk(self, slot, prompt, plen):
        """Publish the prompt's full pages past the attached hits to the
        prefix cache (the cache takes its own references)."""
        j, plen = int(slot), int(plen)
        h0 = self._chunk_hit.pop(j, 0)
        if self.pcache is None:
            return
        prompt = np.asarray(prompt).reshape(-1)[:plen]
        for c in range(h0, plen // self.page):
            self.pcache.insert(prompt, c, self.slot_pages[j][c])

    @hot_path
    def _chunk_carry(self, prog) -> dict:
        c = super()._chunk_carry(prog)
        c["tables"] = self.tables
        return c

    @hot_path
    def _chunk_logits(self, c, toks, offs, clens):
        cache = {"k": c["k"], "v": c["v"]}
        logits, _ = transformer.prefill_chunk_paged(
            self.params, self.cfg, toks, cache, c["tables"], offs, clens,
            policy=self.policy)
        return logits

    def reset_slots(self, slots):
        """Park freed slots, release their pages (shared pages keep their
        other references) and zero their table rows."""
        super().reset_slots(slots)
        for j in np.asarray(slots).reshape(-1):
            for gid in self.slot_pages[int(j)]:
                self.alloc.decref(int(gid))
            self.slot_pages[int(j)] = []
            self._chunk_hit.pop(int(j), None)
        self.tables[torch.as_tensor(np.asarray(slots),
                                    device=self.device)] = 0

    # ------------------------------------------------------------ lifecycle

    def set_injector(self, inj):
        super().set_injector(inj)
        self.alloc.injector = inj        # alloc.out_of_blocks fires there

    def _private_pages(self, slot):
        """Pool ids of the slot's pages held by nobody else."""
        gids = [int(g) for g in self.slot_pages[int(slot)]
                if self.alloc.refcount(int(g)) == 1]
        return torch.as_tensor(self._local_ids(gids), dtype=torch.long,
                               device=self.device)

    def poison_slot(self, slot) -> bool:
        """NaN only the slot's private pages: shared prefix pages back
        other requests. A slot with no private page reports False."""
        ids = self._private_pages(slot)
        if self.data is None or not len(ids):
            return False
        for t in self.data.values():
            t[:, ids] = float("nan")
        return True

    def corrupt_prefix(self, injector) -> int:
        if self.pcache is None or not self.pcache._entries:
            return 0
        n = max(1, len(self.pcache._entries) // 2)
        return self.pcache.invalidate(n=n, rng=injector.rng)

    def scrub_slot(self, slot):
        """Zero the slot's private pages before ``reset_slots`` returns
        them to the free list: a NaN page handed to a later request
        would sit past its length, where the plain tiers' ``p @ v``
        still reads it."""
        ids = self._private_pages(slot)
        if self.data is not None and len(ids):
            for t in self.data.values():
                t[:, ids] = 0
        self.reset_slots([int(slot)])

    def recover(self):
        """Also release every page the slots hold and drop the prefix
        cache, whose entries point at zeroed pages, then zero the tables
        in place."""
        for j in range(self.pool_width):
            for gid in self.slot_pages[j]:
                self.alloc.decref(int(gid))
            self.slot_pages[j] = []
        self._chunk_hit.clear()
        if self.pcache is not None:
            self.pcache.drop_all()
        self.tables.zero_()
        super().recover()

    def check_integrity(self, live_slots=()):
        super().check_integrity(live_slots)
        _paged_integrity(self, {int(j) for j in live_slots})


def decode_state_for(cfg, paged=False):
    """The DecodeState class serving ``cfg``: paged or contiguous KV (the
    dense family is the one ported)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.arch_id}: family {cfg.family!r} "
                                  f"has no ported decode state")
    return PagedKVDecodeState if paged else KVDecodeState
