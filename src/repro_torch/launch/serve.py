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
  queue in FIFO order; with nothing in flight that can never clear, so
  the server raises naming the head request.
* Sequence-sharded decode (``kv_mode="seq"``, ``shards`` a
  ``distributed.ShardGroup``): every rank runs the same server on the
  same requests; each ``cuda``-tier group keeps only its rank's slice of
  the cache's sequence axis and folds the ranks' attention statistics
  through its policy's ``merge_strategy`` every layer. ``reference`` /
  ``eager`` groups stay whole and replicated on every rank, as the
  reference keeps non-pallas groups off its sharded program. Scheduling
  reads only token counts, so every rank makes the same decisions.

Emitted tokens stay on the device; each request's tokens reach the host
once, when it finishes. Chunked prefill, fault handling (the backoff /
shed ladder) and speculative decoding are not ported yet. Until
quarantine is, a slot that emits the non-finite sentinel (-1) stops the
server with an error.
"""

from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import KV_MODES, init_from_env, resolve_kv_shards
from repro_torch.models import api
from repro_torch.models.block_pool import OutOfBlocks
from repro_torch.models.decode_state import _len_bucket, decode_state_for  # noqa: F401  (re-export)
from repro_torch.runtime import (ExecPolicy, parse_policy_groups,
                                 resolve_device, resolve_policy)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int = 16
    group: str = "default"              # policy group (Server.policy_groups)
    out: list = field(default_factory=list)
    finish_reason: Optional[str] = None  # "max_new" | "length_cap"
    prefix_hit: int = 0                 # prompt tokens from the prefix cache
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Group:
    """One policy group: ExecPolicy + slot pool + scheduling. Scheduling
    depends only on token counts, never on token values, so tokens stay on
    the device until a request finishes."""

    def __init__(self, cfg, params, policy, max_batch, cache_s, device, *,
                 paged=False, block_budget=None, prefix_cache=True,
                 comm=None):
        self.cfg, self.policy = cfg, policy
        self.max_batch, self.device = max_batch, device
        self.paged = paged
        self.comm = comm                # set: the cache is sequence-sharded
        kw = (dict(n_pages=block_budget, prefix_cache=prefix_cache)
              if paged else {})
        self.state = decode_state_for(cfg, paged=paged)(
            cfg, params, policy, max_batch, cache_s, device=device,
            comm=comm, **kw)
        self.queue: deque = deque()
        self.reqs: list = [None] * max_batch
        self.lens = np.zeros(max_batch, np.int64)   # tokens held per slot
        self.ntok = np.zeros(max_batch, np.int64)   # tokens emitted per slot
        self.last = torch.zeros((max_batch, 1), dtype=torch.int32,
                                device=device)
        self.live_dev = torch.zeros(max_batch, dtype=torch.int32,
                                    device=device)
        self.decode_steps = 0
        self.collectives = 0        # issued by decode steps (sharded)
        self.decode_s: list = []    # per-step host dispatch time
        self.admit_s: list = []     # per-wave admission time (synced)
        self.admit_hist: list = []  # per-wave prefix-cache tokens per row
        self.req_lat: list = []     # submit -> tokens on the host
        self.ttft: list = []        # submit -> first token on the device
        self.peak_logical = 0       # max summed live tokens (paged)
        self.peak_pages = 0         # max physical pages in use (paged)
        self._toks: dict = {}       # slot -> [(B, 1) token tensors]

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
        return any(r is not None for r in self.reqs)

    def _unservable(self, why):
        r = self.queue[0]
        raise RuntimeError(
            f"request {r.rid} ({len(r.prompt)} prompt tokens) cannot be "
            f"admitted with nothing in flight: {why}")

    def admit(self, admit_log=None):
        """Fill freed slots from the queue with one ragged prefill."""
        free = [j for j in range(self.max_batch) if self.reqs[j] is None]
        take, sp = self._take_wave(free)
        if not take:
            if free and self.queue and not self._in_flight():
                self._unservable("its pages exceed what the pool can "
                                 "ever supply")
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
            # in FIFO order and retry once pages free up
            for _, r in reversed(take):
                self.queue.appendleft(r)
            if not self._in_flight():
                self._unservable("the page pool ran out (OutOfBlocks)")
            return
        _sync(self.device)
        self.admit_s.append(time.perf_counter() - t0)
        hist = self.state.wave_hist if self.paged else 0
        self.admit_hist.append(hist)
        sl = torch.as_tensor(slots, device=self.device)
        self.last = self.last.index_copy(0, sl, first[sl])
        self.live_dev = self.live_dev.index_fill(0, sl, 1)
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

    def sweep(self):
        """Invariant sweep (it syncs; tests and shutdown only): freed
        slots parked, and for paged pools refcount conservation and no
        orphaned table rows."""
        self.state.check_integrity(
            {j for j in range(self.max_batch) if self.reqs[j] is not None})

    def decode_once(self):
        """One batched decode step over the live slots (no-op when idle)."""
        cap = self.state.max_len()
        for j in range(self.max_batch):
            if self.reqs[j] is not None and self.lens[j] >= cap:
                self._finish(j, "length_cap")
        live = [j for j in range(self.max_batch) if self.reqs[j] is not None]
        if not live:
            return
        t0 = time.perf_counter()
        calls = 0 if self.comm is None else self.comm.calls
        nxt = self.state.step(self.last, self.live_dev)
        self.last = nxt
        self.decode_s.append(time.perf_counter() - t0)
        if self.comm is not None:
            self.collectives += self.comm.calls - calls
        self.decode_steps += 1
        for j in live:
            self.lens[j] += 1
            self.ntok[j] += 1
            self._toks[j].append(nxt)
            if self.ntok[j] >= self.reqs[j].max_new:
                self._finish(j, "max_new")

    def _finish(self, j, reason):
        """One device->host copy per finished request, then free the slot."""
        r = self.reqs[j]
        toks = torch.cat(self._toks.pop(j), dim=1)[j].cpu().numpy()
        if (toks < 0).any():
            raise RuntimeError(
                f"request {r.rid}: slot {j} produced non-finite logits "
                f"(token -1); quarantine is not ported yet")
        r.out.extend(int(t) for t in toks)
        r.finish_reason = reason
        r.t_done = time.perf_counter()
        self.req_lat.append(r.t_done - r.t_submit)
        self.reqs[j] = None
        self.live_dev = self.live_dev.index_fill(
            0, torch.tensor([j], device=self.device), 0)
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
    Server and runs the same requests."""

    def __init__(self, cfg, params, *, max_batch=4, max_seq=512,
                 policy: Optional[ExecPolicy] = None,
                 policy_groups: Optional[dict] = None, device=None,
                 paged: bool = False, block_budget: Optional[int] = None,
                 prefix_cache: bool = True, kv_mode: str = "auto",
                 shards=None):
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
        self._groups = {}
        for name, pol in groups.items():
            n = resolve_kv_shards(cfg, kv_mode, shards, self.cache_s,
                                  page=pol.block_page if paged else None)
            sharded = n > 1 and pol.kernel_backend == "cuda"
            self._groups[name] = _Group(
                cfg, params, pol, max_batch, self.cache_s, self.device,
                paged=paged, block_budget=block_budget,
                prefix_cache=prefix_cache,
                comm=shards if sharded else None)
        self.admit_log: list = []    # rids in admission order

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
        r.t_submit = time.perf_counter()
        self._groups[r.group].queue.append(r)

    def step(self) -> bool:
        """One scheduler tick: admit into freed slots, then one decode
        step per busy group. Returns True while work remains."""
        for g in self._groups.values():
            g.admit(self.admit_log)
        for g in self._groups.values():
            g.decode_once()
        return any(g.busy for g in self._groups.values())

    def drain(self) -> None:
        while self.step():
            pass

    def run(self, requests: list) -> list:
        for r in requests:
            self.submit(r)
        self.drain()
        return requests

    def stats(self) -> dict:
        """Per-group decode steps, request latency, TTFT and decode-step
        (host) time percentiles, admission waves and queue depth, the
        cache's shard count with its merge strategy and the collectives
        its decode steps issued, from host-side records only.
        Paged groups add their pool and the hot waves (those whose rows
        attached prefix-cache pages) with their admission time."""
        def pct(xs, q):
            xs = sorted(xs)
            return xs[min(len(xs) * q // 100, len(xs) - 1)] if xs else 0.0

        out = {}
        for name, g in self._groups.items():
            out[name] = {"decode_steps": g.decode_steps,
                         "p50_req_s": pct(g.req_lat, 50),
                         "p95_req_s": pct(g.req_lat, 95),
                         "admit_waves": len(g.admit_s),
                         "admit_s_total": sum(g.admit_s, 0.0),
                         "queue_depth": len(g.queue),
                         "p50_ttft_s": pct(g.ttft, 50),
                         "p95_ttft_s": pct(g.ttft, 95),
                         "p50_step_s": pct(g.decode_s, 50),
                         "policy": g.policy.describe(),
                         "shards": g.state.shards,
                         "merge_strategy": (g.policy.merge_strategy
                                            if g.state.shards > 1 else None),
                         "collectives": g.collectives,
                         "collectives_per_step": (g.collectives
                                                  / max(g.decode_steps, 1))}
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
                            block_page=args.block_page)
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
    server = Server(cfg, params, max_batch=args.max_batch,
                    max_seq=args.max_seq, policy=policy,
                    policy_groups=groups, device=device, paged=args.paged,
                    kv_mode=args.kv_mode, shards=comm)
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
    server.run(reqs)
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
            f"p95 {s['p95_ttft_s'] * 1e3:.1f}ms"
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
    for r in reqs[:3]:
        say(f"  req {r.rid} [{r.group}] len={len(r.prompt)}: "
            f"{r.out[:8]}... ({r.finish_reason})")
    if comm is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
