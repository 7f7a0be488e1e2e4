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

Self-speculative decode (port of ``decode_state.py:181-378,709-810``;
paged ``:1507-1534``): ``enable_speculative(k)`` gives an unsharded pool
static burst buffers (``pos0``, ``toks``, ``rem``, ``block``, ``nlast``)
and a verify program per (policy, W = k + 1, mode, impl). A burst is
``spec_snapshot`` (positions into ``pos0``, the engine's last tokens
into ``toks[:, 0]``), ``k`` replays of the draft policy's decode-step
graph (the policy with only its exp backend swapped to
``draft_exp_backend``; each draft's token copied into the next lane of
``toks`` and into the next draft's input) and one replay of the verify
graph, which scores the W candidates under the group's own policy and
folds the acceptance into the carry: positions advance by the accepted
length m, the budget ``rem`` shrinks by m, and ``block`` / ``nlast``
hold the emitted tokens (``SPEC_PAD`` past m) and the next input. The
verify is "scan" (W decode steps of the policy at the plain step's
shape, token-identical to plain decode by construction) or "chunk" (one
all-lanes chunk program at width W on the FlashAttention kernel). The
cursor rewind is the whole rollback: rejected rows past the new
position are masked by length and overwritten by the next burst, and a
paged pool touches its allocator zero times (every slot holds its full
reservation from admission).
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


# Block-padding sentinel for lanes past a burst's accepted length. Not
# the poison sentinel (-1): the engine filters PAD out of a finished
# stream, while -1 still quarantines the slot.
SPEC_PAD = -2


@hot_path
def _spec_accept(toks, logits, clens, rem, live):
    """The acceptance fold of one verify pass (port of the reference's
    ``_spec_accept``, ``decode_state.py:189-218``).

    ``toks`` (B, W) the burst's candidates [t0, d1..dk] (t0 the pre-burst
    last token, d_i the drafts); ``logits`` (B, W, V) the verify
    policy's scores of every lane; ``clens`` (B,) the lanes actually
    scored (0: a dead or cap-full row); ``rem`` (B,) the remaining
    emission budget; ``live`` (B,). Emits ``m = min(n_acc + 1, clens,
    rem)`` tokens a row: the longest draft prefix that agrees with the
    verify argmaxes, plus the bonus token the verify proposes after it,
    so every emitted token is the verify policy's argmax. A non-finite
    lane poisons itself and every later lane of the burst (the sentinel
    -1), and a row whose t0 is -1 stays poisoned. Elementwise ops and
    lane reductions only. Returns (block (B, W) with SPEC_PAD past m,
    nlast (B, 1), m (B,))."""
    w = toks.shape[1]
    lanes = torch.arange(w, dtype=torch.int32, device=toks.device)[None, :]
    e = logits.argmax(dim=-1).to(torch.int32)                     # (B, W)
    badlane = ~torch.isfinite(logits).all(dim=-1)
    bad = (torch.cumsum(badlane.to(torch.int32), dim=1) > 0) \
        | (toks[:, :1] < 0)
    agree = (toks[:, 1:] == e[:, :-1]).to(torch.int32)            # (B, k)
    n_acc = torch.cumprod(agree, dim=1).sum(dim=1, dtype=torch.int32)
    m = torch.minimum(torch.minimum(n_acc + 1, clens), rem)
    m = torch.where(live > 0, torch.clamp(m, min=0), 0).to(torch.int32)
    tokv = torch.where(bad, -1, e)
    block = torch.where(lanes < m[:, None], tokv, SPEC_PAD)
    nlast = torch.gather(tokv, 1, torch.clamp(m - 1, 0, w - 1)[:, None]
                         .to(torch.int64))
    nlast = torch.where((m > 0)[:, None], nlast, toks[:, :1])
    return block.to(torch.int32), nlast.to(torch.int32), m


@hot_path
def _spec_clens(pos0, live, cap, w):
    """Lanes a burst may score per row: the room left below the linear
    cache capacity ``cap``, at most ``w``, and 0 for a dead row (the
    reference's ``_clens``, ``decode_state.py:284-287``), so m never runs
    past the cap."""
    room = torch.clamp(cap - pos0, 0, w)
    return torch.where(live > 0, room, 0).to(torch.int32)


@hot_path
def _spec_fold(c, logits, clens):
    """Fold one verify's acceptance into the burst carry ``c`` in place:
    the block and next input, positions at ``pos0 + m``, the budget
    shrunk by m."""
    block, nlast, m = _spec_accept(c["toks"], logits, clens, c["rem"],
                                   c["live"])
    c["block"].copy_(block)
    c["nlast"].copy_(nlast)
    c["pos"].copy_(c["pos0"] + m)
    c["rem"].sub_(m)


SPEC_MODES = ("kv", "kv_paged")


def _spec_verify_fn(params, cfg, policy, w, mode, cap, impl):
    """The verify program of a W-lane burst under ``policy`` (port of
    the reference's ``_spec_programs``, ``decode_state.py:226-378``, for
    the KV modes): a function of the burst carry (``spec_carry``), run
    eagerly or captured once as a CUDA graph.

    ``impl="scan"``: W decode steps of ``policy`` through the very
    ``transformer.decode_step[_paged]`` of the plain step, at its
    (pool_width, 1) shape; step i runs with ``live * (i < clens)``, so a
    lane that must not score leaves the cache and the position alone.
    Every accepted token then comes out of the plain step's program on
    the plain step's inputs: token-identical to plain decode by
    construction. Step i rewrites row pos0 + i with the policy's K/V
    before anything reads it, over the draft's row.

    ``impl="chunk"``: one ``prefill_chunk[_paged](..., all_lanes=True)``
    at width W, cursor ``pos0`` and ``clens`` valid lanes: one
    FlashAttention launch a layer scores every lane. Tokens are the
    policy's argmaxes of the chunk program, which may break a near tie
    differently from the decode step.

    Either way the acceptance is folded in on the device
    (``_spec_fold``), so a burst syncs on nothing. ``cap`` is the linear
    cache capacity: lanes at or past it are not scored."""
    if impl not in ("scan", "chunk"):
        raise ValueError(f"unknown speculative verify impl {impl!r}")
    if mode not in SPEC_MODES:
        raise NotImplementedError(
            f"speculative verify of a {mode!r} pool is not ported: the "
            f"recurrent modes (a replay from a state snapshot) wait for "
            f"the recurrent families (ROADMAP A11)")
    paged = mode == "kv_paged"

    @hot_path
    def scan(c):
        toks, pos0, live = c["toks"], c["pos0"], c["live"]
        clens = _spec_clens(pos0, live, cap, w)
        cache = {"k": c["k"], "v": c["v"]}
        pos, lanes = pos0, []
        for i in range(w):
            lv = live * (clens > i).to(live.dtype)
            if paged:
                logits, _ = transformer.decode_step_paged(
                    params, cfg, toks[:, i:i + 1], cache, c["tables"], pos,
                    policy=policy, live=lv)
            else:
                logits, _ = transformer.decode_step(
                    params, cfg, toks[:, i:i + 1], cache, pos,
                    policy=policy, live=lv)
            lanes.append(logits[:, 0])
            pos = pos + lv
        _spec_fold(c, torch.stack(lanes, dim=1), clens)

    @hot_path
    def chunk(c):
        toks, pos0 = c["toks"], c["pos0"]
        clens = _spec_clens(pos0, c["live"], cap, w)
        cache = {"k": c["k"], "v": c["v"]}
        if paged:
            logits, _ = transformer.prefill_chunk_paged(
                params, cfg, toks, cache, c["tables"], pos0, clens,
                policy=policy, all_lanes=True)
        else:
            logits, _ = transformer.prefill_chunk(
                params, cfg, toks, cache, pos0, clens, policy=policy,
                all_lanes=True)
        _spec_fold(c, logits, clens)

    return scan if impl == "scan" else chunk


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
        # (policy, W, mode, impl) -> speculative verify program
        self.spec_progs: dict = {}
        self.spec_k = 0             # 0: plain decode (no burst buffers)
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
        are graphs on the card (elsewhere a no-op); a speculating state
        also captures, under each of those policies, its draft policy's
        decode step (shared where it is the policy's own) and the verify
        program. Every slot is dead (``live`` all 0) and every chunk row
        inert (no tokens), so the warm-ups write only what a step writes
        for dead slots: KV at position 0 of a contiguous row, which
        admission overwrites, the paged scratch page, and the burst
        buffers' PAD blocks."""
        if self.graph is None or not self.graph.use_graph:
            return
        self._ensure_cache()
        base = self.policy
        for pol in (base, *policies):
            self.set_policy(pol)
            self.graph(self._step, self.carry(last, live))
            if self.spec_k:
                if self._draft_graph.signature is None:  # not shared
                    self._draft_graph(self._draft, self.carry(last, live))
                self._verify["graph"](self._verify["fn"],
                                      self.spec_carry(live))
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
    def _step(self, c, policy=None):
        """The step over the carry ``c`` under ``policy`` (default: the
        state's), in place: tokens into ``out``, positions of live slots
        advanced."""
        logits = self._logits(c, policy)
        c["out"].copy_(_guard_tokens(logits, c["last"]))
        c["pos"].add_(c["live"])

    @hot_path
    def _logits(self, c, policy=None):
        policy = self.policy if policy is None else policy
        cache = {"k": c["k"], "v": c["v"]}
        if self.shard is None:
            logits, _ = transformer.decode_step(
                self.params, self.cfg, c["last"], cache, c["pos"],
                policy=policy, live=c["live"])
        else:
            logits, _ = transformer.decode_step_sharded(
                self.params, self.cfg, c["last"], cache, c["pos"],
                policy=policy, shard=self.shard, live=c["live"])
        return logits

    def graph_stats(self) -> dict:
        """How the step runs ("graph", "eager", or eager because the
        cache is sharded), with the decode graphs' captures and replays
        (the draft steps' among them), the chunk programs' (``chunk_*``)
        and the speculative verify programs' (``spec_*``), summed over
        policies and widths."""
        def total(graphs, prefix=""):
            gs = [g.stats() for g in graphs]
            return {f"{prefix}captures": sum(g["captures"] for g in gs),
                    f"{prefix}replays": sum(g["replays"] for g in gs),
                    f"{prefix}capture_s": sum(g["capture_s"] for g in gs)}

        out = total([p["graph"] for p in self.chunk_progs.values()],
                    "chunk_")
        out.update(total([p["graph"] for p in self.spec_progs.values()],
                         "spec_"))
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
        for t in self._burst_buffers():
            t.zero_()
        if self.data is not None:
            for t in self.data.values():
                t.zero_()

    def set_policy(self, policy):
        """Run the decode step, the chunk programs and a speculating
        state's draft and verify under ``policy`` (the degradation
        ladder's lever; the reference re-wires its draft and verify the
        same way, ``decode_state.py:702-706``): a lookup of graphs
        captured at construction, never a capture on the request path."""
        self.graph = self._decode_graph(policy)
        self.policy = policy
        if self.spec_k:
            self._wire_spec()

    def reset_slots(self, slots):
        """Park freed slots at position 0, their burst buffers' rows
        zeroed (no budget outlives its request). KV rows are not zeroed:
        decode masks them by cache_len and admission overwrites them."""
        idx = torch.as_tensor(np.asarray(slots), device=self.device)
        self.pos_dev[idx] = 0
        for t in self._burst_buffers():
            t[idx] = 0

    def check_integrity(self, live_slots=()):
        """Invariant sweep (it syncs; never on the decode path): freed
        slots must be parked at position 0."""
        live = {int(j) for j in live_slots}
        pos = self.pos_dev.cpu().numpy()
        rem = self.spec_rem.cpu().numpy() if self.spec_k else None
        for j in range(self.pool_width):
            if j not in live and int(pos[j]) != 0:
                raise AssertionError(
                    f"freed slot {j} parked at pos {int(pos[j])}")
            if rem is not None and j not in live and int(rem[j]) != 0:
                raise AssertionError(
                    f"freed slot {j} keeps an emission budget of "
                    f"{int(rem[j])}")

    # ------------------------------------------------- speculative decoding

    def supports_speculative(self) -> bool:
        """Whether this pool can run draft bursts and a verify that rolls
        a rejected draft back (the self-speculative decode path)."""
        return False

    def _spec_mode(self) -> str:
        raise NotImplementedError

    def enable_speculative(self, spec_k: int) -> None:
        """Switch the pool to self-speculative decode (reference
        ``decode_state.py:727-739``): ``spec_k``-step draft bursts under
        the policy's ``draft_exp_backend``, verified by one pass under
        the policy itself. Allocates the static burst buffers and wires
        the draft and verify programs of the active policy; call it
        before ``capture``, which captures them with the decode step."""
        if not self.supports_speculative():
            raise ValueError(
                f"{self.kind} state cannot run speculative decode"
                + ("" if self.shard is None else
                   " (its cache is sequence-sharded; the verify program is "
                   "unsharded, as in the reference)"))
        if not (isinstance(spec_k, int) and spec_k >= 2):
            raise ValueError(f"spec_k must be an int >= 2, got {spec_k!r}")
        self.spec_k = int(spec_k)
        w, dev = self.spec_k + 1, self.device

        def buf(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        self.spec_pos0 = buf(self.pool_width)       # pre-burst positions
        self.spec_toks = buf(self.pool_width, w)    # [t0, d1 .. dk]
        self.spec_rem = buf(self.pool_width)        # emission budget
        self.spec_block = buf(self.pool_width, w)   # emitted, PAD past m
        self.spec_nlast = buf(self.pool_width, 1)   # the next input token
        self._draft_lane = 0
        self._wire_spec()

    def _burst_buffers(self):
        if not self.spec_k:
            return ()
        return (self.spec_pos0, self.spec_toks, self.spec_rem,
                self.spec_block, self.spec_nlast)

    def _draft_policy(self):
        """The active policy with only its exp backend swapped: draft and
        verify differ in exactly one execution choice."""
        return self.policy.replace(exp_backend=self.policy.draft_exp_backend)

    def _spec_impl(self) -> str:
        return self.policy.spec_verify

    def _wire_spec(self):
        """Look up (or, before capture, make) the draft step's graph and
        the verify program of the active policy."""
        self._draft_pol = self._draft_policy()
        self._draft_graph = self._decode_graph(self._draft_pol)
        pol, w, mode, impl = key = (self.policy, self.spec_k + 1,
                                    self._spec_mode(), self._spec_impl())
        prog = self.spec_progs.get(key)
        if prog is None:
            prog = {"graph": self._new_graph(key, "speculative verify"),
                    "fn": _spec_verify_fn(self.params, self.cfg, pol, w,
                                          mode, self.max_len(), impl)}
            self.spec_progs[key] = prog
        self._verify = prog

    @hot_path
    def spec_carry(self, live) -> dict:
        """Every tensor the verify reads or writes: the burst buffers,
        the live mask, the positions and the cache leaves."""
        c = {"toks": self.spec_toks, "pos0": self.spec_pos0,
             "rem": self.spec_rem, "block": self.spec_block,
             "nlast": self.spec_nlast, "live": live, "pos": self.pos_dev}
        c.update(self.data)
        return c

    @hot_path
    def spec_snapshot(self, last):
        """Pre-burst snapshot into the static buffers: the positions into
        ``pos0`` and the engine's ``last`` tokens into lane 0 of ``toks``.
        Returns ``pos0``, the burst's rollback token (positions only: on
        a KV pool the cursor rewind is the whole rollback)."""
        self.spec_pos0.copy_(self.pos_dev)
        self.spec_toks[:, :1].copy_(last)
        self._draft_lane = 0
        return self.spec_pos0

    def spec_restore(self, snap):
        """Roll every slot back to the snapshot's positions, in place.
        ``verify_step`` is the normal consumer of a snapshot (the
        acceptance folds the rewind into the verify), so this is the
        abort path and the protocol's testable rollback: stale draft rows
        past the restored positions are masked by length and overwritten
        by the next burst, and a paged pool touches its allocator zero
        times (reference ``decode_state.py:773-786``)."""
        self.pos_dev.copy_(snap)

    @hot_path
    def draft_step(self, last, live):
        """One decode step under the draft policy over the decode carry
        (its graph is the draft policy's decode-step graph). The token it
        writes to ``out`` goes into the next lane of ``toks`` and into
        ``last``, the next draft's input. Returns ``out``."""
        self._draft_graph(self._draft, self.carry(last, live))
        lane = self._draft_lane + 1
        self.spec_toks[:, lane:lane + 1].copy_(self.out)
        last.copy_(self.out)
        self._draft_lane = lane
        return self.out

    @hot_path
    def _draft(self, c):
        self._step(c, self._draft_pol)

    @hot_path
    def verify_step(self, snap, live):
        """One verify over the burst (the active policy's program, a
        graph replay on the card) from the positions of ``snap``, the
        token ``spec_snapshot`` returned (the static ``pos0`` the program
        reads). Returns the static ``(block, nlast)``: the (pool, W)
        accepted tokens, SPEC_PAD past each row's accepted length, and
        the (pool, 1) next input. Positions and ``rem`` are advanced in
        place."""
        del snap                     # the carry's pos0
        self._verify["graph"](self._verify["fn"], self.spec_carry(live))
        return self.spec_block, self.spec_nlast


class KVDecodeState(DecodeState):
    """Dense transformer: contiguous KV cache + per-slot positions."""

    kind = "kv"

    def max_len(self):
        # a linear cache is exhausted when the next write would fall past
        # its last row
        return self.cache_s

    def supports_speculative(self) -> bool:
        # a linear, unsharded cache (reference decode_state.py:845-853):
        # the verify program is unsharded, and the position-only rollback
        # relies on rejected rows staying masked until overwritten
        return self.shard is None

    def _spec_mode(self) -> str:
        return "kv"


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
    def _logits(self, c, policy=None):
        policy = self.policy if policy is None else policy
        cache = {"k": c["k"], "v": c["v"]}
        if self.shard is None:
            logits, _ = transformer.decode_step_paged(
                self.params, self.cfg, c["last"], cache, c["tables"],
                c["pos"], policy=policy, live=c["live"])
        else:
            logits, _ = transformer.decode_step_paged_sharded(
                self.params, self.cfg, c["last"], cache, c["tables"],
                c["pos"], policy=policy, shard=self.shard,
                live=c["live"])
        return logits

    # ------------------------------------------------- speculative decoding

    def supports_speculative(self) -> bool:
        # the preconditions of per-slot chunk admission (reference
        # decode_state.py:1509-1512): the verify writes through the device
        # tables, whose ids are this rank's only on an unsharded pool
        return self.supports_chunked()

    def _spec_mode(self) -> str:
        return "kv_paged"

    @hot_path
    def spec_carry(self, live) -> dict:
        # the tables are read only, and a rollback frees no page: every
        # slot holds its full reservation from admission (prefill_into,
        # begin_chunk), accepted prefix included
        c = super().spec_carry(live)
        c["tables"] = self.tables
        return c

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
