"""Slot-level continuous-batching server (port of ``repro/launch/serve.py``,
contiguous or paged KV cache, monolithic ragged admission).

* A fixed pool of ``max_batch`` slots per policy group (a
  ``KVDecodeState``, or with ``paged=True`` a ``PagedKVDecodeState``:
  fixed-size KV pages behind per-slot block tables, a refcounted page
  allocator and a shared-prefix page cache), allocated once at
  ``max_seq``.
* Ragged admission: queued requests are right-padded to a pow2 length
  bucket, prefilled as one pool-width batch with per-request prompt
  lengths (on the ``cuda`` tier the FlashAttention kernel masks each row
  against its own length), and their rows land in freed slots.
* Per-slot decode: one pool-width step per group with a (B,) position
  vector; the decode kernel masks each row against its own length.
* Continuous batching: a slot frees the step its request finishes
  (``max_new`` or the cache's length cap) and the next queued request is
  admitted mid-decode.
* Policy groups: each group has its own ExecPolicy and pool, so ``exact``
  traffic never shares a batch with ``vexp`` traffic.
* Paged admission: a wave closes at a request whose fresh pages (plus the
  cache-only hit pages its attach pins) do not fit the free + evictable
  budget, or whose prefix-cache hit depth is below the wave head's. A
  wave whose allocation still fails (``OutOfBlocks``) goes back to the
  queue in FIFO order and the bounded retry policy decides
  (``_admit_backoff``): with work in flight, retry next tick; with
  nothing in flight, retry with backoff a bounded number of times, then
  shed the head request (``finish_reason == "failed"``).
* Chunked prefill (``ExecPolicy.prefill_chunk > 0``; reference
  ``serve.py:597-700``): queued prompts are admitted one per freed slot
  (``DecodeState.begin_chunk``) and stream into it ``chunk_c`` tokens a
  tick through one fixed-shape program over the pool (rows not
  prefilling ride along untouched), so each tick runs at most one chunk
  and one decode step, and a long prompt holds decode back by one chunk.
  A mid-prefill slot is dead to decode, its position pinned at the
  prompt length; the tick that completes its prompt flips it live.
* Request lifecycle (reference ``serve.py:133-441``): deadlines and
  cooperative ``cancel`` honored at every scheduling event (``reap``:
  queued, mid-prefill or decoding, releasing the slot and its pages);
  a slot that emits the non-finite sentinel (-1) is quarantined and its
  rows scrubbed, never streamed; a decode dispatch fault (the injected
  one) re-queues every in-flight request, up to ``MAX_STEP_RETRIES``
  re-serves each; a hysteretic degradation ladder under pool pressure
  (L1 halves the chunk width, L2 drops the ``degrade_groups`` to their
  policy's ``degrade_exp_backend``) that restores itself; and a seeded
  ``ft.FaultInjector`` that fires faults at six named points.
* Sequence-sharded decode (``kv_mode="seq"``, ``shards`` a
  ``distributed.ShardGroup``): every rank runs the same server on the
  same requests; each ``cuda``-tier group keeps only its rank's slice of
  the cache's sequence axis and folds the ranks' attention statistics
  through its policy's ``merge_strategy`` every layer. ``reference`` /
  ``eager`` groups stay whole and replicated on every rank, as the
  reference keeps non-pallas groups off its sharded program. Scheduling
  reads only token counts, so every rank makes the same decisions.

The decode step is the reference's (``serve.py:715-760``: one donated,
jitted program per group that syncs on nothing) in the port's form: each
unsharded group's state runs it as one CUDA graph over a carry written in
place (``models.decode_state``, ``runtime.graphs.StepGraph``), captured
when the Server builds the group, before any request, and replayed by
every decode step. The engine keeps its own carry tensors (``last``,
``live_dev``) static too and writes them with in-place ops only.
``Server(cuda_graphs=False)`` runs the identical in-place step eagerly
(the measurement's eager arm).

Emitted tokens stay on the device: each step's tokens are copied out of
the step's static output buffer once (one device copy per step), and
each request's tokens reach the host once, when it finishes.

Self-speculative decode (``ExecPolicy.spec_k >= 2``; reference
``serve.py:443-455,764-871``): a speculating group replaces its decode
step by a burst (``decode_spec_once``): ``spec_k`` draft steps under the
policy's ``draft_exp_backend``, then one verify under the group's own
policy ("scan" or "chunk", ``spec_verify``) that accepts the longest
agreeing draft prefix plus one bonus token and folds the rollback into
the device carry. Each draft and the verify is a CUDA-graph replay of a
program captured when the Server builds the group, over static burst
buffers (``models.decode_state``). The accepted lengths stay on the
device: the host's per-slot counters advance by the burst width as
upper bounds, and a slot whose counter crosses its budget or the cache
cap settles with one sync (``_settle_slot``). ``spec_groups`` names the
groups that speculate (default: every group whose policy asks).
"""

from __future__ import annotations

import argparse
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.registry import hot_path
from repro_torch.configs import get_config
from repro_torch.distributed import KV_MODES, init_from_env, resolve_kv_shards
from repro_torch.ft import (FAULT_SEED_ENV, FaultInjector, InjectedFault,
                            default_chaos_rates)
from repro_torch.models import api
from repro_torch.models.block_pool import OutOfBlocks
from repro_torch.models.decode_state import (SPEC_PAD,
                                             _len_bucket,  # noqa: F401  (re-export)
                                             decode_state_for,
                                             host_to_device)
from repro_torch.runtime import (ExecPolicy, parse_policy_groups,
                                 resolve_device, resolve_policy)

# Bounded admission retry: with work in flight a rejected admission waits
# for the next tick (pages will free); with nothing in flight no page
# frees on its own, so the engine retries with exponential backoff a
# bounded number of times (absorbing transient or injected rejections),
# then sheds the head request.
MAX_ADMIT_RETRIES = 8
ADMIT_BACKOFF_S = 0.002
ADMIT_BACKOFF_CAP_S = 0.05
# A step-fault victim is re-queued and re-served this many times before
# the engine sheds it.
MAX_STEP_RETRIES = 3
# Degradation-ladder hysteresis in scheduler ticks: escalation needs
# DEGRADE_AFTER consecutive pressured ticks, restoration RESTORE_AFTER
# clear ones.
PRESSURE_HIGH = 0.85
DEGRADE_AFTER = 3
RESTORE_AFTER = 8


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int = 16
    group: str = "default"              # policy group (Server.policy_groups)
    out: list = field(default_factory=list)
    # "max_new" | "length_cap" when served; "cancelled" | "deadline" |
    # "quarantined" | "failed" when the engine stopped the request
    # without its tokens
    finish_reason: Optional[str] = None
    prefix_hit: int = 0                 # prompt tokens from the prefix cache
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    deadline_s: Optional[float] = None  # TTL from submit (None: server's)
    cancel_requested: bool = False
    retries: int = 0                    # step-fault re-serves so far

    def cancel(self):
        """Cooperative cancellation: the engine honors the flag at its
        next scheduling event (``reap``), releasing the slot and any
        pages or prefix references the request holds."""
        self.cancel_requested = True


class _Group:
    """One policy group: ExecPolicy + slot pool + scheduling. Scheduling
    depends only on token counts, never on token values, so tokens stay on
    the device until a request finishes."""

    def __init__(self, cfg, params, policy, max_batch, cache_s, device, *,
                 paged=False, block_budget=None, prefix_cache=True,
                 comm=None, cuda_graphs=True, ladder=False,
                 degradable=False, spec_k=0):
        self.cfg, self.policy = cfg, policy
        self.max_batch, self.device = max_batch, device
        self.paged = paged
        self.comm = comm                # set: the cache is sequence-sharded
        kw = (dict(n_pages=block_budget, prefix_cache=prefix_cache)
              if paged else {})
        self.state = decode_state_for(cfg, paged=paged)(
            cfg, params, policy, max_batch, cache_s, device=device,
            comm=comm, cuda_graphs=cuda_graphs, **kw)
        # chunk width: 0 keeps monolithic waves, because the policy asks
        # for them or the pool cannot chunk (a sharded paged pool)
        self.chunk_c = (self.state.chunk_width(policy.prefill_chunk)
                        if policy.prefill_chunk
                        and self.state.supports_chunked() else 0)
        self.base_policy, self.base_chunk = policy, self.chunk_c
        self.degradable = degradable    # named in Server's degrade_groups
        self.degraded = 0               # the ladder's rung
        self.queue: deque = deque()
        self.reqs: list = [None] * max_batch
        self.prefilling: dict = {}      # slot -> (Request, cursor)
        self.lens = np.zeros(max_batch, np.int64)   # tokens held per slot
        self.ntok = np.zeros(max_batch, np.int64)   # tokens emitted per slot
        # the step's carry on the engine side: written in place only
        self.last = torch.zeros((max_batch, 1), dtype=torch.int32,
                                device=device)
        self.live_dev = torch.zeros(max_batch, dtype=torch.int32,
                                    device=device)
        # ---- speculative decode (spec_k >= 2; the Server decides which
        # groups speculate): burst counters, host side
        self.spec_k = 0                 # 0: plain one-token decode
        self._bursts = [0] * max_batch  # per slot, of the request in flight
        self.spec_bursts = 0            # bursts of finished requests
        self.spec_drafted = 0           # draft tokens proposed
        self.spec_accepted = 0          # draft tokens accepted
        self.spec_rolled_back = 0       # draft tokens rolled back
        if spec_k:
            self.enable_spec(spec_k)
        self.state.capture(self.last, self.live_dev,
                           *self._ladder_plan(ladder))
        self.decode_steps = 0
        self.decode_steps_prefilling = 0  # steps run while a prompt streams
        self.collectives = 0        # issued by decode steps (sharded)
        self.decode_s: list = []    # per-step host dispatch time (no sync)
        self.chunk_s: list = []     # per-chunk host dispatch time (no sync)
        self.admit_s: list = []     # per-wave admission time (synced)
        self.admit_hist: list = []  # per-wave prefix-cache tokens per row
        self.req_lat: list = []     # submit -> tokens on the host
        self.ttft: list = []        # submit -> first token dispatched
        self.peak_logical = 0       # max summed live tokens (paged)
        self.peak_pages = 0         # max physical pages in use (paged)
        self._toks: dict = {}       # slot -> [(B, 1) per-step token copies]
        # ---- lifecycle and faults
        self.injector = None        # ft.FaultInjector (the Server's)
        self.cancelled = self.deadline_missed = self.quarantined = 0
        self.step_faults = 0
        self.requeued = 0           # step-fault victims re-queued
        self.shed = 0               # requests dropped as unservable
        self.admit_retries = 0
        self._admit_fail = 0        # consecutive nothing-in-flight fails
        self._admit_pressure = False  # admission rejected this tick

    # ------------------------------------------------ degradation ladder

    def _degraded_policy(self):
        """The policy of the ladder's second rung: the group's own unless
        it is degradable and its degrade backend differs."""
        pol = self.base_policy
        if self.degradable and pol.exp_backend != pol.degrade_exp_backend:
            return pol.replace(exp_backend=pol.degrade_exp_backend)
        return pol

    def _half_chunk(self):
        return self.state.chunk_width(max(1, self.base_chunk // 2))

    def _ladder_plan(self, ladder):
        """(extra decode policies, (policy, chunk width) pairs) the group
        can run: with the ladder on, every rung's, so that the state
        captures them all before any request (a speculating state also
        captures each rung's draft step and verify program)."""
        base, deg = self.base_policy, self._degraded_policy()
        policies = (deg,) if ladder and deg != base else ()
        chunks = []
        if self.base_chunk:
            chunks.append((base, self.base_chunk))
            if ladder:
                chunks += [(base, self._half_chunk()),
                           (deg, self._half_chunk())]
        return policies, tuple(dict.fromkeys(chunks))

    def set_degraded(self, level: int):
        """Apply one rung of the ladder. L1 halves the chunk width
        (smaller prefill bites a tick, so decode drains page-holding
        slots sooner); L2 also drops a degradable group to its policy's
        ``degrade_exp_backend``. Both directions are lookups of programs
        captured when the group was built."""
        level = max(0, min(2, level))
        if level == self.degraded:
            return
        self.degraded = level
        if self.base_chunk:
            self.chunk_c = self.base_chunk if level == 0 else \
                self._half_chunk()
        pol = self._degraded_policy() if level >= 2 else self.base_policy
        if pol != self.policy:
            self.policy = pol
            self.state.set_policy(pol)

    def under_pressure(self) -> bool:
        """Pool pressure, from host counters only: admission was rejected
        this tick, or a paged pool's utilization reached PRESSURE_HIGH."""
        if self._admit_pressure:
            return True
        if self.paged:
            return self.state.pool_stats()["utilization"] >= PRESSURE_HIGH
        return False

    def enable_spec(self, spec_k: int):
        """Opt this group into self-speculative decode (reference
        ``serve.py:443-455``): each tick runs ``spec_k`` draft steps and
        one verify. Raises if the pool cannot roll a rejected burst back
        (``supports_speculative``). The construction calls it before the
        capture, so the burst's programs are captured with the group;
        the emission budgets live in the state's ``spec_rem`` buffer."""
        self.state.enable_speculative(spec_k)
        self.spec_k = int(spec_k)

    def _seed_budgets(self, sl, reqs):
        """Device emission budgets of newly live slots ``sl``: the tokens
        each request may emit after its first."""
        if self.spec_k:
            self.state.spec_rem.index_copy_(0, sl, host_to_device(
                np.array([r.max_new - 1 for r in reqs], np.int32),
                self.device))

    # ------------------------------------------------- lifecycle / faults

    @hot_path
    def reap(self, now=None):
        """Drop cancelled and deadline-expired requests, once a tick.
        Queued requests hold nothing; a mid-prefill slot rolls its
        reservation back (``abort_chunk``); a decoding slot is released
        as an abort. The invariant sweep runs on these events only."""
        now = time.perf_counter() if now is None else now

        def expired(r):
            if r.cancel_requested:
                return "cancelled"
            if r.deadline_s is not None and now - r.t_submit > r.deadline_s:
                return "deadline"
            return None

        if self.queue and any(expired(r) for r in self.queue):
            kept: deque = deque()
            for r in self.queue:
                why = expired(r)
                if why is None:
                    kept.append(r)
                else:
                    self._finish_host(r, why)
            self.queue = kept
        for j in list(self.prefilling):
            why = expired(self.prefilling[j][0])
            if why is not None:
                r, _ = self.prefilling.pop(j)
                self.state.abort_chunk(j)
                self._finish_host(r, why)
                self.sweep()
        for j in range(self.max_batch):
            if self.reqs[j] is not None:
                why = expired(self.reqs[j])
                if why is not None:
                    self._abort_slot(j, why)

    def _finish_host(self, r, reason):
        """Terminal bookkeeping of a request stopped without its tokens
        (no latency sample: the percentiles describe served traffic)."""
        r.finish_reason = reason
        r.t_done = time.perf_counter()
        if reason == "cancelled":
            self.cancelled += 1
        elif reason == "deadline":
            self.deadline_missed += 1
        elif reason == "quarantined":
            self.quarantined += 1

    def _abort_slot(self, j, reason):
        """Release a decoding slot without its tokens, then sweep."""
        self._bump_peaks()
        r = self.reqs[j]
        self._toks.pop(j, None)
        self._bursts[j] = 0
        self.reqs[j] = None
        self.live_dev[j] = 0
        self.state.reset_slots([j])
        self._finish_host(r, reason)
        self.sweep()

    def _admit_backoff(self) -> bool:
        """The one bounded-retry policy for a rejected admission (both
        admission modes). Work in flight: pages will free, retry next
        tick. Nothing in flight: retry MAX_ADMIT_RETRIES times with
        exponential backoff, then shed the head request. Returns True
        if admission should be retried."""
        self.admit_retries += 1
        self._admit_pressure = True
        if self._in_flight():
            self._admit_fail = 0
            return True
        self._admit_fail += 1
        if self._admit_fail <= MAX_ADMIT_RETRIES:
            time.sleep(min(ADMIT_BACKOFF_S * 2 ** (self._admit_fail - 1),
                           ADMIT_BACKOFF_CAP_S))
            return True
        self._admit_fail = 0
        if self.queue:
            self._finish_host(self.queue.popleft(), "failed")
            self.shed += 1
        return False

    def _recover_step_fault(self):
        """Self-heal after a failed decode dispatch: every in-flight
        request, decoding or mid-prefill, is a victim. The state zeroes
        its carry in place (paged: releases every page and the prefix
        cache), and the victims go back to the head of the queue in
        submit order, up to MAX_STEP_RETRIES re-serves each; their
        tokens so far are dropped, and re-admission replays the prompt,
        so a re-served request is token-identical to an undisturbed
        run."""
        victims = [r for r in self.reqs if r is not None]
        victims += [self.prefilling[j][0] for j in sorted(self.prefilling)]
        self.reqs = [None] * self.max_batch
        self.prefilling.clear()
        self._toks.clear()
        self.state.recover()
        self.last.zero_()
        self.live_dev.zero_()
        self.lens[:] = 0
        self.ntok[:] = 0
        self._bursts = [0] * self.max_batch
        for r in sorted(victims, key=lambda v: v.t_submit, reverse=True):
            r.retries += 1
            if r.retries > MAX_STEP_RETRIES:
                self._finish_host(r, "failed")
                self.shed += 1
            else:
                r.out.clear()
                r.t_first = 0.0
                self.requeued += 1
                self.queue.appendleft(r)
        self.sweep()

    def sweep(self):
        """Invariant sweep (it syncs; fault events, tests and shutdown
        only): freed slots parked, and for paged pools refcount
        conservation and no orphaned table rows."""
        self.state.check_integrity(
            {j for j in range(self.max_batch) if self.reqs[j] is not None}
            | set(self.prefilling))

    # ---------------------------------------------------------- admission

    def _take_wave(self, free):
        """The maximal FIFO prefix of the queue that shares the head
        request's prefill bucket: a long prompt closes the wave and heads
        the next one, so shorter prompts never pay its width. Paged
        groups also close the wave at a request whose fresh pages plus
        the cache-only hit pages its attach pins do not fit the free +
        evictable budget (admission blocks on pages; decode never does),
        and at a request colder than the wave head's hit depth (one
        history shape per prefill)."""
        take, bucket = [], None
        head_h = avail = None
        pinned = set()     # evictable hit pages already debited this wave
        while free and self.queue:
            r = self.queue[0]
            b = self.state.prefill_width(len(r.prompt))
            if bucket is not None and b > bucket:
                break
            if self.paged:
                if avail is None:
                    avail = self.state.free_with_evictable()
                need, h = self.state.admission_need(r.prompt, cap_h=head_h)
                if head_h is not None and h < head_h:
                    break
                pin, pin_gids = self.state.admission_pin(r.prompt, h,
                                                         pinned)
                if not ((need + pin) <= avail).all():
                    break
                avail = avail - need - pin
                pinned.update(pin_gids)
                if head_h is None:
                    head_h = h
            bucket = b if bucket is None else bucket
            take.append((free.pop(0), self.queue.popleft()))
        return take, bucket

    def _in_flight(self) -> bool:
        return bool(self.prefilling) or any(r is not None for r in self.reqs)

    @hot_path
    def admit(self, admit_log=None):
        """Fill freed slots from the queue: one ragged prefill wave, or
        per-request chunk admission when the group chunks."""
        self._admit_pressure = False     # set again by a rejection below
        if self.injector is not None and \
                self.injector.fire("prefix.corrupt"):
            # detected prefix corruption: drop the chains and re-prefill
            # later instead of serving them (host-side, no device sync)
            self.state.corrupt_prefix(self.injector)
        if self.chunk_c:
            return self.admit_chunked(admit_log)
        free = [j for j in range(self.max_batch) if self.reqs[j] is None]
        take, sp = self._take_wave(free)
        if not take:
            if free and self.queue and not self._in_flight():
                # nothing in flight, yet the gate cannot take the head:
                # its pages exceed what the pool can supply
                self._admit_backoff()
            return
        slots = np.array([j for j, _ in take])
        # full pool width, so admitting 1 or max_batch requests runs the
        # same shapes per bucket; rows without a request are length-1
        # dummies
        toks = np.zeros((self.max_batch, sp), np.int32)
        plens = np.ones(self.max_batch, np.int32)
        for j, r in take:
            toks[j, :len(r.prompt)] = r.prompt
            plens[j] = len(r.prompt)
        t0 = time.perf_counter()
        try:
            first = self.state.prefill_into(slots, toks, plens)
        except OutOfBlocks:
            # prefill_into released every page the wave held: re-queue it
            # in FIFO order and let the bounded retry policy decide
            for _, r in reversed(take):
                self.queue.appendleft(r)
            self._admit_backoff()
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._admit_fail = 0
        self.admit_s.append(time.perf_counter() - t0)
        hist = self.state.wave_hist if self.paged else 0
        self.admit_hist.append(hist)
        sl = torch.as_tensor(slots, device=self.device)
        self.last.index_copy_(0, sl, first[sl])
        self.live_dev.index_fill_(0, sl, 1)
        self._seed_budgets(sl, [r for _, r in take])
        now = time.perf_counter()
        for j, r in take:
            self.reqs[j] = r
            self.lens[j] = len(r.prompt)
            self.ntok[j] = 1
            self._toks[j] = [first]
            r.prefix_hit = hist
            r.t_first = now
            self.ttft.append(now - r.t_submit)
            if admit_log is not None:
                admit_log.append(r.rid)
            if self.ntok[j] >= r.max_new:
                self._finish(j, "max_new")
        self._bump_peaks()

    @hot_path
    def admit_chunked(self, admit_log=None):
        """Chunked admission: one queued request per freed slot, strictly
        FIFO, no wave bucketing, so a long prompt at the head streams in
        its own slot while the next tick admits the request behind it.
        Paged pools reserve the slot's pages (and attach its own prefix
        hits) in ``begin_chunk``; admission blocks on pages, the chunk
        and decode steps never do."""
        free = [j for j in range(self.max_batch)
                if self.reqs[j] is None and j not in self.prefilling]
        while free and self.queue:
            r = self.queue[0]
            j = free[0]
            try:
                cur = self.state.begin_chunk(j, r.prompt, len(r.prompt))
                try:
                    # the slot holds its reservation now; only the chunk's
                    # completion, reap or this rollback release it
                    self.prefilling[j] = (self.queue.popleft(), cur)
                except BaseException:
                    self.state.abort_chunk(j)
                    raise
            except OutOfBlocks:
                # begin_chunk released what it held; retry next tick with
                # work in flight, else back off, then shed the head
                if self._admit_backoff():
                    break
                continue
            free.pop(0)
            r.prefix_hit = cur
            self._admit_fail = 0
            if admit_log is not None:
                admit_log.append(r.rid)
        self._bump_peaks()

    @hot_path
    def prefill_chunk_once(self):
        """Advance every prefilling slot by one chunk: one fixed-shape
        (pool, chunk_c) program a tick, each prefilling row taking its
        next ``clens[j] <= chunk_c`` prompt tokens at its cursor, every
        other row inert. Dispatched without a sync (``chunk_s`` is host
        dispatch time, as ``decode_s`` is)."""
        if not self.prefilling:
            return
        if self.injector is not None and \
                self.injector.fire("chunk.delay"):
            time.sleep(self.injector.delay_s)    # a straggler chunk
        toks = np.zeros((self.max_batch, self.chunk_c), np.int32)
        offs = np.zeros(self.max_batch, np.int32)
        clens = np.zeros(self.max_batch, np.int32)
        done = []
        for j in list(self.prefilling):
            r, cur = self.prefilling[j]
            n = min(self.chunk_c, len(r.prompt) - cur)
            toks[j, :n] = r.prompt[cur:cur + n]
            offs[j] = cur
            clens[j] = n
            if cur + n >= len(r.prompt):
                done.append(j)
            else:
                self.prefilling[j] = (r, cur + n)
        t0 = time.perf_counter()
        first = self.state.prefill_chunk_into(toks, offs, clens)
        self.chunk_s.append(time.perf_counter() - t0)
        if done:
            self._chunk_done(done, first)

    @hot_path
    def _chunk_done(self, done, first):
        """Slots whose prompt completed this chunk go live and seed
        decode with their first token (copied out of the chunk program's
        static output buffer). TTFT is sampled here, at the scheduling
        event, without a sync."""
        first = first.clone()
        sl = host_to_device(done, self.device)
        self.last.index_copy_(0, sl, first[sl])
        self.live_dev.index_fill_(0, sl, 1)
        self._seed_budgets(sl, [self.prefilling[j][0] for j in done])
        now = time.perf_counter()
        for j in done:
            r, _ = self.prefilling.pop(j)
            self.reqs[j] = r
            self.lens[j] = len(r.prompt)
            self.ntok[j] = 1
            self._toks[j] = [first]
            r.t_first = now
            self.ttft.append(now - r.t_submit)
            self.state.finish_chunk(j, r.prompt, len(r.prompt))
            if self.ntok[j] >= r.max_new:
                self._finish(j, "max_new")
        self._bump_peaks()

    def _bump_peaks(self):
        """Paged pools: track the high-water marks of summed live tokens
        and of physical pages in use (host counters only, sampled at
        scheduling events)."""
        if not self.paged:
            return
        logical = int(sum(self.lens[j] for j in range(self.max_batch)
                          if self.reqs[j] is not None))
        self.peak_logical = max(self.peak_logical, logical)
        self.peak_pages = max(self.peak_pages, self.state.alloc.n_used())

    # ------------------------------------------------------------- decode

    @hot_path
    def decode_once(self):
        """One batched decode step over the live slots (no-op when idle).
        The step's output buffer is rewritten by the next step, so its
        tokens are copied once: into ``last`` (the next step's input) and
        into a per-step copy the finished request gathers."""
        cap = self.state.max_len()
        for j in range(self.max_batch):
            if self.reqs[j] is not None and self.lens[j] >= cap:
                self._finish(j, "length_cap")
        live = [j for j in range(self.max_batch) if self.reqs[j] is not None]
        if not live:
            return
        if self.injector is not None and \
                self.injector.fire("decode.poison"):
            # NaN one live slot's rows before the step: the step's
            # finite-logits guard must absorb it
            self.state.poison_slot(self.injector.choose(live))
        if self.injector is not None and \
                self.injector.fire("decode.step_error"):
            # the decode dispatch failed (the injected fault, raised at
            # dispatch); a CUDA error inside a replay is not caught here:
            # it poisons the context, and hiding it would hide the device
            self.step_faults += 1
            self._recover_step_fault()
            return
        t0 = time.perf_counter()
        calls = 0 if self.comm is None else self.comm.calls
        out = self.state.step(self.last, self.live_dev)
        self.last.copy_(out)
        nxt = out.clone()
        self.decode_s.append(time.perf_counter() - t0)
        if self.comm is not None:
            self.collectives += self.comm.calls - calls
        self.decode_steps += 1
        if self.prefilling:
            self.decode_steps_prefilling += 1
        for j in live:
            self.lens[j] += 1
            self.ntok[j] += 1
            self._toks[j].append(nxt)
            if self.ntok[j] >= self.reqs[j].max_new:
                self._finish(j, "max_new")

    @hot_path
    def decode_spec_once(self):
        """One speculative burst over the live slots (no-op when idle;
        reference ``serve.py:764-821``): snapshot, ``spec_k`` draft steps
        under the draft policy, one verify under the group's policy that
        accepts the longest agreeing prefix plus one bonus token and
        folds the rollback into the device carry. Every step is a graph
        replay, and nothing reaches the host: the counters below advance
        by the burst width W as upper bounds, and a counter that crosses
        the budget or the cap goes through ``_settle_slot``, the one
        sync. Every emitted token is the group policy's argmax, so with
        the "scan" verify the stream is token-identical to plain
        decode."""
        live = [j for j in range(self.max_batch) if self.reqs[j] is not None]
        if not live:
            return
        if self.injector is not None and \
                self.injector.fire("decode.poison"):
            self.state.poison_slot(self.injector.choose(live))
        t0 = time.perf_counter()
        try:
            snap = self.state.spec_snapshot(self.last)
            for _ in range(self.spec_k):
                self.state.draft_step(self.last, self.live_dev)
            if self.injector is not None and \
                    self.injector.fire("decode.step_error"):
                # the injected dispatch fault, mid-burst: the drafts have
                # advanced the positions and only the verify would fold
                # them back; a CUDA error inside a replay is not caught
                raise InjectedFault("decode dispatch failed mid-burst")
            block, nlast = self.state.verify_step(snap, self.live_dev)
        except InjectedFault:
            self.step_faults += 1
            self._recover_step_fault()
            return
        self.last.copy_(nlast)
        block = block.clone()
        self.decode_s.append(time.perf_counter() - t0)
        self.decode_steps += 1
        if self.prefilling:
            self.decode_steps_prefilling += 1
        cap = self.state.max_len()
        w = self.spec_k + 1
        for j in live:
            r = self.reqs[j]
            self._bursts[j] += 1
            self._toks[j].append(block)
            self.ntok[j] = min(self.ntok[j] + w, r.max_new)
            self.lens[j] = min(self.lens[j] + w, cap)
            if self.ntok[j] >= r.max_new or self.lens[j] >= cap:
                self._settle_slot(j)

    def _settle_slot(self, j):
        """A speculating slot whose upper-bound counters crossed its
        budget (``max_new``) or the cache cap (reference
        ``serve.py:823-845``): one device->host copy of its token column.
        A budget truly spent finishes the request (quarantine is decided
        in ``_finish``); otherwise the counters become exact and the slot
        decodes on. While budget and room remain every burst emits >= 1
        token, so settling cannot spin."""
        r = self.reqs[j]
        col = torch.cat(self._toks[j], dim=1)[j].cpu().numpy()
        col = col[col != SPEC_PAD]
        n = len(col)
        pos = len(r.prompt) + n - 1          # cache rows the slot holds
        if (col < 0).any() or n >= r.max_new:
            self._finish(j, "max_new")
        elif pos >= self.state.max_len():
            self._finish(j, "length_cap")
        else:
            self.ntok[j] = n
            self.lens[j] = pos

    @hot_path
    def _finish(self, j, reason):
        """One device->host copy per finished request, then free the
        slot. A token column holding the non-finite sentinel (-1) is
        quarantined instead: its tokens are never streamed, and the slot
        is scrubbed (every row zeroed, not just parked) before reuse. A
        speculating group drops the SPEC_PAD lanes of its bursts and
        books the burst's drafts as accepted or rolled back."""
        self._bump_peaks()
        r = self.reqs[j]
        toks = torch.cat(self._toks.pop(j), dim=1)[j].cpu().numpy()
        toks = toks[toks != SPEC_PAD]
        if self.spec_k:
            b, self._bursts[j] = self._bursts[j], 0
            self.spec_bursts += b
            self.spec_drafted += b * self.spec_k
            # a burst that emitted anything spent one bonus token; the
            # rest of the column after the first token is accepted drafts
            acc = min(max(0, len(toks) - 1 - b), b * self.spec_k)
            self.spec_accepted += acc
            self.spec_rolled_back += b * self.spec_k - acc
        if (toks < 0).any():
            self.reqs[j] = None
            self.live_dev[j] = 0
            self.state.scrub_slot(j)
            self._finish_host(r, "quarantined")
            self.sweep()
            return
        r.out.extend(int(t) for t in toks)
        r.finish_reason = reason
        r.t_done = time.perf_counter()
        self.req_lat.append(r.t_done - r.t_submit)
        self.reqs[j] = None
        self.live_dev[j] = 0
        self.state.reset_slots([j])

    @property
    def busy(self) -> bool:
        return bool(self.queue) or self._in_flight()


class Server:
    """Continuous-batching server: one ExecPolicy, slot pool and decode
    step per group. ``run(requests)`` serves until every request is done.
    Runs on the card unless ``device="cpu"`` is passed. With ``paged``
    each group's page size is its policy's ``block_page``;
    ``block_budget`` (physical pages per group, default a full
    reservation per slot plus a scratch page per shard) and
    ``prefix_cache`` exist for tests that squeeze the pool or turn the
    cache off. ``kv_mode`` ("auto", "seq", "batch") with ``shards`` (a
    ``distributed.ShardGroup``) places the cache:
    ``distributed.resolve_kv_shards`` says when "seq" shards a group's
    cache over the group's ranks; every rank then constructs the same
    Server and runs the same requests. ``cuda_graphs=False`` runs each
    unsharded group's in-place decode step (and chunk program) eagerly
    instead of replaying its CUDA graph (on the card; the CPU always runs
    it eagerly). ``injector`` (an ``ft.FaultInjector``) fires faults at
    the engine's scheduling events; ``deadline_s`` is the default
    time-to-live of a request from its submit; ``degrade_groups`` names
    the groups the degradation ladder may drop to their policy's
    ``degrade_exp_backend`` (the ladder runs only when one is named)."""

    def __init__(self, cfg, params, *, max_batch=4, max_seq=512,
                 policy: Optional[ExecPolicy] = None,
                 policy_groups: Optional[dict] = None, device=None,
                 paged: bool = False, block_budget: Optional[int] = None,
                 prefix_cache: bool = True, kv_mode: str = "auto",
                 shards=None, cuda_graphs: bool = True,
                 injector: Optional[FaultInjector] = None,
                 deadline_s: Optional[float] = None, degrade_groups=(),
                 spec_groups=None):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"server runs on {self.device}")
        self.cfg, self.params = cfg, params
        self.max_batch, self.max_seq = max_batch, max_seq
        self.cache_s = max_seq
        self.policy = policy if policy is not None else resolve_policy(cfg)
        groups = dict(policy_groups) if policy_groups else {}
        groups.setdefault("default", self.policy)
        self.policy_groups = groups
        degrade = set(degrade_groups or ())
        unknown = degrade - set(groups)
        if unknown:
            raise ValueError(f"unknown degrade group(s) {sorted(unknown)}; "
                             f"have {sorted(groups)}")
        spec = self._spec_plan(groups, spec_groups)
        self._groups = {}
        for name, pol in groups.items():
            n = resolve_kv_shards(cfg, kv_mode, shards, self.cache_s,
                                  page=pol.block_page if paged else None)
            sharded = n > 1 and pol.kernel_backend == "cuda"
            self._groups[name] = _Group(
                cfg, params, pol, max_batch, self.cache_s, self.device,
                paged=paged, block_budget=block_budget,
                prefix_cache=prefix_cache,
                comm=shards if sharded else None, cuda_graphs=cuda_graphs,
                ladder=bool(degrade), degradable=name in degrade,
                spec_k=spec[name])
        self.admit_log: list = []    # rids in admission order
        self.serve_s = 0.0           # wall time spent in drain()
        self.injector = injector
        self.deadline_s = deadline_s
        for g in self._groups.values():
            if injector is not None:
                g.injector = injector
                g.state.set_injector(injector)
        # the ladder is opt-in: with no degrade group the engine never
        # trades chunk width or numerics for pressure
        self._degrade_enabled = bool(degrade)
        self.degrade_level = 0
        self.degrade_peak = 0            # highest rung reached
        self._pressure_ticks = self._clear_ticks = 0

    @staticmethod
    def _spec_plan(groups, spec_groups) -> dict:
        """{group: spec_k} (0: plain decode; reference
        ``serve.py:1002-1020``): a group speculates when its policy asks
        (``spec_k >= 2``) and, where ``spec_groups`` names groups, it is
        named. Naming an unknown group, or one whose policy does not ask,
        raises."""
        named = None if spec_groups is None else set(spec_groups)
        if named is not None:
            unknown = named - set(groups)
            if unknown:
                raise ValueError(f"unknown spec group(s) {sorted(unknown)}; "
                                 f"have {sorted(groups)}")
            for name in sorted(named):
                if groups[name].spec_k < 2:
                    raise ValueError(
                        f"group {name} named in spec_groups but its policy "
                        f"has spec_k={groups[name].spec_k} (need >= 2)")
        return {name: pol.spec_k if pol.spec_k >= 2
                and (named is None or name in named) else 0
                for name, pol in groups.items()}

    def submit(self, r: Request) -> None:
        if r.group not in self._groups:
            raise ValueError(f"unknown policy group {r.group!r}; "
                             f"have {sorted(self._groups)}")
        plen = len(r.prompt)
        if plen < 1:
            raise ValueError(f"request {r.rid}: empty prompt")
        if plen > self.cache_s:
            raise ValueError(f"request {r.rid}: prompt of {plen} tokens "
                             f"exceeds the cache capacity ({self.cache_s})")
        if r.max_new < 1:
            raise ValueError(f"request {r.rid}: max_new must be >= 1")
        if r.deadline_s is None:
            r.deadline_s = self.deadline_s
        r.t_submit = time.perf_counter()
        self._groups[r.group].queue.append(r)

    def cancel(self, rid: int) -> bool:
        """Flag request ``rid`` for cancellation wherever it is (queued,
        mid-prefill or decoding); the next tick's reap drops it and
        releases what it holds. False for an unknown or finished rid."""
        for g in self._groups.values():
            live = [r for r, _ in g.prefilling.values()]
            for r in (*g.queue, *live, *g.reqs):
                if r is not None and r.rid == rid:
                    r.cancel()
                    return True
        return False

    @hot_path
    def step(self) -> bool:
        """One scheduler tick: reap cancelled and expired requests, admit
        into freed slots, move the degradation ladder, then per busy
        group at most one prefill chunk and one decode step (a
        speculating group's: one burst). The chunk comes first, so a
        prompt that completes goes live this tick. Returns True while
        work remains."""
        for g in self._groups.values():
            g.reap()
        for g in self._groups.values():
            g.admit(self.admit_log)
        self._degradation_tick()
        for g in self._groups.values():
            g.prefill_chunk_once()
        for g in self._groups.values():
            if g.spec_k:
                g.decode_spec_once()
            else:
                g.decode_once()
        return any(g.busy for g in self._groups.values())

    def _degradation_tick(self):
        """The ladder's hysteresis, from host-side pressure signals only:
        DEGRADE_AFTER consecutive pressured ticks go one rung up (L1:
        half the chunk width; L2: the degrade groups' cheaper exp), and
        RESTORE_AFTER clear ticks one rung down. Inert unless a group was
        named in ``degrade_groups``."""
        if not self._degrade_enabled:
            return
        pressured = any(g.under_pressure() for g in self._groups.values())
        if pressured:
            self._pressure_ticks += 1
            self._clear_ticks = 0
        else:
            self._clear_ticks += 1
            self._pressure_ticks = 0
        level = self.degrade_level
        if pressured and self._pressure_ticks >= DEGRADE_AFTER \
                and level < 2:
            level, self._pressure_ticks = level + 1, 0
        elif not pressured and self._clear_ticks >= RESTORE_AFTER \
                and level > 0:
            level, self._clear_ticks = level - 1, 0
        if level != self.degrade_level:
            self.degrade_level = level
            self.degrade_peak = max(self.degrade_peak, level)
            for g in self._groups.values():
                g.set_degraded(level)

    def drain(self) -> None:
        t0 = time.perf_counter()
        while self.step():
            pass
        self.serve_s += time.perf_counter() - t0

    def run(self, requests: list) -> list:
        for r in requests:
            self.submit(r)
        self.drain()
        return requests

    def stats(self) -> dict:
        """Per-group decode steps, request latency, TTFT and host
        dispatch time percentiles (the host time to enqueue a decode
        step, taken with no sync: not the step's time), admission waves
        and queue depth, how the step runs (``step_mode``: "graph",
        "eager", or eager because the cache is sharded) with its graph
        captures and replays, the cache's shard count with its merge
        strategy and the collectives its decode steps issued, from
        host-side records only. ``wall_per_decode_step_s`` is the
        server's, the same in every group: wall time in ``drain`` minus
        every group's (synced) admission time, over every group's decode
        steps (chunk dispatches included). The chunk telemetry
        (``prefill_chunk`` width, ``prefill_chunks`` dispatched, their
        host dispatch time, the chunk programs' captures and replays,
        ``decode_steps_prefilling``: decode steps run while a prompt was
        still streaming in) and the lifecycle counters (cancelled,
        deadline_missed, quarantined, step_faults, requeued, shed,
        admit_retries, the ladder rung) come from the same host records.
        Paged groups add their pool and the hot waves (those whose rows
        attached prefix-cache pages) with their admission time. A
        speculating group's decode steps are its bursts, and it adds the
        burst telemetry (``spec_*``: bursts, drafted, accepted and rolled
        back draft tokens of finished requests, the acceptance share, and
        the verify programs' captures and replays; its draft steps are
        among the decode graph's replays)."""
        def pct(xs, q):
            xs = sorted(xs)
            return xs[min(len(xs) * q // 100, len(xs) - 1)] if xs else 0.0

        groups = self._groups.values()
        steps = sum(g.decode_steps for g in groups)
        admit = sum(sum(g.admit_s, 0.0) for g in groups)
        per_step = (self.serve_s - admit) / steps if steps else 0.0
        out = {}
        for name, g in self._groups.items():
            gs = g.state.graph_stats()
            out[name] = {"decode_steps": g.decode_steps,
                         "p50_req_s": pct(g.req_lat, 50),
                         "p95_req_s": pct(g.req_lat, 95),
                         "admit_waves": len(g.admit_s),
                         "admit_s_total": sum(g.admit_s, 0.0),
                         "queue_depth": len(g.queue),
                         "p50_ttft_s": pct(g.ttft, 50),
                         "p95_ttft_s": pct(g.ttft, 95),
                         "p50_host_dispatch_s": pct(g.decode_s, 50),
                         "wall_per_decode_step_s": per_step,
                         "step_mode": gs["mode"],
                         "graph_captures": gs["captures"],
                         "graph_replays": gs["replays"],
                         "graph_capture_s": gs["capture_s"],
                         "prefilling": len(g.prefilling),
                         "prefill_chunk": g.chunk_c,
                         "prefill_chunks": len(g.chunk_s),
                         "chunk_s_total": sum(g.chunk_s, 0.0),
                         "p50_chunk_dispatch_s": pct(g.chunk_s, 50),
                         "chunk_graph_captures": gs["chunk_captures"],
                         "chunk_graph_replays": gs["chunk_replays"],
                         "chunk_graph_capture_s": gs["chunk_capture_s"],
                         "decode_steps_prefilling":
                             g.decode_steps_prefilling,
                         "cancelled": g.cancelled,
                         "deadline_missed": g.deadline_missed,
                         "quarantined": g.quarantined,
                         "step_faults": g.step_faults,
                         "requeued": g.requeued,
                         "shed": g.shed,
                         "admit_retries": g.admit_retries,
                         "degraded": g.degraded,
                         "policy": g.policy.describe(),
                         "shards": g.state.shards,
                         "merge_strategy": (g.policy.merge_strategy
                                            if g.state.shards > 1 else None),
                         "collectives": g.collectives,
                         "collectives_per_step": (g.collectives
                                                  / max(g.decode_steps, 1))}
            if g.spec_k:
                drafted = g.spec_drafted
                out[name].update({
                    "spec_k": g.spec_k,
                    "spec_verify": g.policy.spec_verify,
                    "draft_exp_backend": g.policy.draft_exp_backend,
                    "spec_bursts": g.spec_bursts,
                    "spec_drafted": drafted,
                    "spec_accepted": g.spec_accepted,
                    "spec_rolled_back": g.spec_rolled_back,
                    "spec_acceptance": (g.spec_accepted / drafted
                                        if drafted else 0.0),
                    "spec_graph_captures": gs["spec_captures"],
                    "spec_graph_replays": gs["spec_replays"],
                    "spec_graph_capture_s": gs["spec_capture_s"]})
            if g.paged:
                hot = [s for s, h in zip(g.admit_s, g.admit_hist) if h]
                out[name]["hot_waves"] = len(hot)
                out[name]["hot_admit_s_total"] = sum(hot, 0.0)
                g._bump_peaks()          # sample the current footprint
                pool = g.state.pool_stats()
                pool["peak_pages"] = g.peak_pages
                pool["peak_logical_tokens"] = g.peak_logical
                # summed live tokens over what the pool could hold with
                # every page exclusive: above 1.0, prefix sharing carries
                # logical state past physical capacity
                cap = pool["pages_allocatable"] * pool["page"]
                pool["peak_oversubscription"] = (g.peak_logical / cap
                                                 if cap else 0.0)
                out[name]["pool"] = pool
        return out

    def fault_stats(self) -> dict:
        """The ladder's rung (now and the highest reached) and the
        injector's per-point seen / fired counts (none without one)."""
        out = {"degrade_level": self.degrade_level,
               "degrade_peak": self.degrade_peak}
        if self.injector is not None:
            out["injector"] = self.injector.stats()
        return out

    def check_invariants(self):
        """Every group's invariant sweep: freed slots parked, and for
        paged pools refcount conservation and no orphaned table rows.
        Raises AssertionError on the first violation."""
        for g in self._groups.values():
            g.sweep()

    def assert_idle_clean(self):
        """Leak check for a drained server: nothing queued or in flight,
        invariants hold, and after dropping the prefix cache's own
        references every paged group's allocator has zero pages in use.
        Destructive to the prefix cache (a shutdown check): serving can
        go on, but restarts cold."""
        for name, g in self._groups.items():
            if g.busy:
                raise AssertionError(f"group {name} still busy")
            g.sweep()
            if g.paged:
                if g.state.pcache is not None:
                    g.state.pcache.drop_all()
                used = g.state.alloc.n_used()
                if used:
                    raise AssertionError(f"group {name}: {used} pages "
                                         f"leaked")


def make_requests(cfg, n, prompt_len, max_new, *, mixed_lengths=False,
                  min_len=4, groups=("default",), seed=0, shared_prefix=0):
    """``n`` requests with random prompts from ``seed``, assigned to
    ``groups`` round-robin; ``mixed_lengths`` draws each prompt length in
    [min_len, prompt_len]. ``shared_prefix`` > 0 gives every prompt the
    same first tokens (one draw), followed by its own suffix of the
    drawn length."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, (shared_prefix,), dtype=np.int32)
    reqs = []
    for i in range(n):
        plen = (int(rng.integers(min_len, prompt_len + 1)) if mixed_lengths
                else prompt_len)
        prompt = np.concatenate(
            [shared, rng.integers(0, cfg.vocab, (plen,), dtype=np.int32)])
        reqs.append(Request(i, prompt, max_new, group=groups[i % len(groups)]))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="draw prompt lengths in [4, --prompt-len] instead "
                         "of a uniform length (exercises ragged admission)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--exp-backend", default=None,
                    choices=["exact", "vexp", "vexp_hw"],
                    help="exponential backend (default: config/env)")
    ap.add_argument("--kernel-backend", default=None,
                    choices=["cuda", "reference", "eager", "pallas", "xla"],
                    help="kernel tier (default: config/env; pallas and xla "
                         "are the reference package's names for cuda and "
                         "eager)")
    ap.add_argument("--policy-groups", default=None,
                    help='per-request policy groups, e.g. '
                         '"eval=exact,bulk=vexp" (requests are assigned '
                         'round-robin); omit for a single default group')
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV pool (per-slot block "
                         "tables, refcounted page allocator, shared-prefix "
                         "page cache) instead of contiguous slot rows")
    ap.add_argument("--block-page", type=int, default=None,
                    help="KV page size in tokens, the policy's block_page "
                         "(default: config/env)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend the same N tokens to every generated "
                         "prompt (exercises the prefix cache)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk in tokens, the policy's "
                         "prefill_chunk (0: monolithic waves; > 0 streams "
                         "each prompt into its slot one chunk a tick, "
                         "between decode steps)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="default time-to-live of a request in seconds "
                         "from submit; expired requests are dropped at "
                         "the next tick and release their slot and pages")
    ap.add_argument("--degrade-groups", default=None,
                    help='comma-separated policy groups the degradation '
                         'ladder may drop to their policy\'s '
                         'degrade_exp_backend under sustained pool '
                         'pressure, e.g. "bulk" (restored when it clears)')
    ap.add_argument("--chaos", action="store_true",
                    help="fire seeded faults at the default chaos rates, "
                         "check a clean shutdown (no page or slot leaked) "
                         "and print the fault report")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help=f"chaos seed (default: ${FAULT_SEED_ENV} or 0)")
    ap.add_argument("--cancel-frac", type=float, default=0.0,
                    help="cancel about this share of the requests right "
                         "after submitting them")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="self-speculative decode: draft tokens per burst, "
                         "the policy's spec_k (0: plain decode; >= 2: "
                         "k draft steps under --draft-backend, then one "
                         "verify under the group's policy that accepts "
                         "the longest agreeing prefix + 1 bonus token)")
    ap.add_argument("--draft-backend", default=None,
                    choices=["exact", "vexp", "vexp_hw"],
                    help="exp backend of the draft steps, the policy's "
                         "draft_exp_backend (default vexp_hw, the model "
                         "of the proposed BF16 block; emitted tokens "
                         "always come from the verify)")
    ap.add_argument("--spec-verify", default=None, choices=["scan", "chunk"],
                    help='how the verify scores a burst: "scan" runs the '
                         'policy\'s decode step once per lane (tokens '
                         'identical to plain decode); "chunk" scores all '
                         'lanes in one chunk program on the '
                         'FlashAttention kernel (may break near ties '
                         'differently)')
    ap.add_argument("--spec-groups", default=None,
                    help="comma-separated policy groups that speculate "
                         "(their policies need spec_k >= 2); omit to "
                         "speculate in every group whose policy asks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--kv-mode", default="auto", choices=KV_MODES,
                    help='decode-cache placement over the ranks of '
                         'torchrun: "seq" shards the KV sequence axis '
                         '(sequence-parallel decode through the partial '
                         'kernels and the policy\'s merge_strategy); '
                         '"auto" and "batch" keep it whole on every rank')
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    policy = resolve_policy(cfg, exp_backend=args.exp_backend,
                            kernel_backend=args.kernel_backend,
                            block_page=args.block_page,
                            prefill_chunk=args.prefill_chunk,
                            spec_k=args.spec_k,
                            draft_exp_backend=args.draft_backend,
                            spec_verify=args.spec_verify)
    groups = None
    if args.policy_groups:
        groups = parse_policy_groups(args.policy_groups, cfg, base=policy)
    device = resolve_device(args.device)
    comm, device = init_from_env(device)
    rank = 0 if comm is None else comm.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[serve] policy: {policy.describe()}")
    for name, pol in (groups or {}).items():
        say(f"[serve]   group {name}: {pol.describe()}")
    params = api.init_params(cfg, 0, device=device)
    injector = None
    if args.chaos:
        seed = (args.fault_seed if args.fault_seed is not None
                else int(os.environ.get(FAULT_SEED_ENV, "0") or "0"))
        injector = FaultInjector(seed=seed, rates=default_chaos_rates())
        say(f"[serve] chaos: seed={seed} rates={default_chaos_rates()}")
    degrade = tuple(n.strip() for n in (args.degrade_groups or "").split(",")
                    if n.strip())
    spec_groups = (tuple(n.strip() for n in args.spec_groups.split(",")
                         if n.strip())
                   if args.spec_groups is not None else None)
    server = Server(cfg, params, max_batch=args.max_batch,
                    max_seq=args.max_seq, policy=policy,
                    policy_groups=groups, device=device, paged=args.paged,
                    kv_mode=args.kv_mode, shards=comm, injector=injector,
                    deadline_s=args.deadline, degrade_groups=degrade,
                    spec_groups=spec_groups)
    for name, g in server._groups.items():
        if g.spec_k:
            say(f"[serve] group {name}: speculative decode k={g.spec_k} "
                f"draft={g.policy.draft_exp_backend} "
                f"verify={g.policy.spec_verify}")
    stats = server.stats()
    if args.kv_mode == "seq":
        world = 1 if comm is None else comm.world
        say(f"[serve] kv-mode seq over {world} rank(s): decode axis "
            + ", ".join(f"{n}: {'sharded ' + str(s['shards']) + '-way'}"
                        if s["shards"] > 1 else f"{n}: unsharded"
                        for n, s in stats.items()))
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         mixed_lengths=args.mixed_lengths,
                         groups=sorted(groups) if groups else ("default",),
                         shared_prefix=args.shared_prefix)
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    if args.cancel_frac > 0:
        for r in reqs[::max(1, round(1.0 / args.cancel_frac))]:
            server.cancel(r.rid)
    server.drain()
    dt = time.perf_counter() - t0
    ntok = sum(len(r.out) for r in reqs)
    if comm is not None:
        # every rank must have emitted the same tokens, bit for bit
        mine = torch.as_tensor([t for r in reqs for t in r.out],
                               dtype=torch.int64, device=device)
        got = comm.all_gather(mine)
        if not bool((got == got[0]).all()):
            raise RuntimeError("ranks emitted different tokens")
    say(f"served {len(reqs)} requests on {device}, {ntok} tokens in "
        f"{dt:.2f}s ({ntok / dt:.1f} tok/s)")
    for name, s in server.stats().items():
        say(f"  group {name}: {s['decode_steps']} decode steps, "
            f"request latency p50 {s['p50_req_s'] * 1e3:.1f}ms "
            f"p95 {s['p95_req_s'] * 1e3:.1f}ms, "
            f"ttft p50 {s['p50_ttft_s'] * 1e3:.1f}ms "
            f"p95 {s['p95_ttft_s'] * 1e3:.1f}ms, step {s['step_mode']} "
            f"({s['graph_captures']} capture(s), {s['graph_replays']} "
            f"replays), wall per decode step (all groups) "
            f"{s['wall_per_decode_step_s'] * 1e3:.2f}ms"
            + (f", {s['shards']} shards, merge {s['merge_strategy']}, "
               f"{s['collectives_per_step']:.0f} collectives/step"
               if s["shards"] > 1 else ""))
        if "pool" in s:
            p = s["pool"]
            line = (f"    pool: page={p['page']} used {p['pages_used']}/"
                    f"{p['pages_allocatable']} peak {p['peak_pages']} "
                    f"(logical {p['peak_logical_tokens']} tok, "
                    f"oversub {p['peak_oversubscription']:.2f}x), hot "
                    f"waves {s['hot_waves']}/{s['admit_waves']}")
            if "prefix" in p:
                line += (f", prefix hit rate "
                         f"{p['prefix']['hit_rate']:.2f}")
            say(line)
        if "spec_k" in s:
            bursts = max(s["spec_bursts"], 1)
            say(f"    speculative: {s['spec_bursts']} bursts of k="
                f"{s['spec_k']} ({s['spec_verify']} verify), drafted "
                f"{s['spec_drafted']}, accepted {s['spec_accepted']} "
                f"({s['spec_acceptance']:.2f}), rolled back "
                f"{s['spec_rolled_back']}; "
                f"{s['spec_accepted'] / bursts + 1:.2f} tokens/burst")
        if s["prefill_chunks"]:
            say(f"    chunked prefill: width {s['prefill_chunk']}, "
                f"{s['prefill_chunks']} chunks "
                f"({s['chunk_s_total'] * 1e3:.1f}ms host dispatch), "
                f"{s['decode_steps_prefilling']} decode steps while a "
                f"prompt streamed")
        dropped = (s["cancelled"] + s["deadline_missed"] + s["quarantined"]
                   + s["shed"])
        if dropped or s["step_faults"] or s["admit_retries"]:
            say(f"    lifecycle: cancelled={s['cancelled']} "
                f"deadline={s['deadline_missed']} "
                f"quarantined={s['quarantined']} shed={s['shed']} "
                f"step_faults={s['step_faults']} "
                f"requeued={s['requeued']} "
                f"admit_retries={s['admit_retries']}")
    if injector is not None:
        server.assert_idle_clean()
        fs = server.fault_stats()
        say(f"[serve] chaos: clean shutdown (no page or slot leaked); "
            f"faults fired {fs['injector']['fired'] or 'none'}; ladder "
            f"peak {fs['degrade_peak']}, at exit {fs['degrade_level']}")
    for r in reqs[:3]:
        say(f"  req {r.rid} [{r.group}] len={len(r.prompt)}: "
            f"{r.out[:8]}... ({r.finish_reason})")
    if comm is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
