"""Slot-level continuous-batching server (port of ``repro/launch/serve.py``,
contiguous KV cache, monolithic ragged admission).

* A fixed pool of ``max_batch`` slots per policy group (a
  ``KVDecodeState``), allocated once at ``max_seq``.
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

Emitted tokens stay on the device; each request's tokens reach the host
once, when it finishes. Paged KV, chunked prefill, fault handling and
speculative decoding are later slices. Until quarantine is ported, a slot
that emits the non-finite sentinel (-1) stops the server with an error.
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
from repro_torch.models import api
from repro_torch.models.decode_state import KVDecodeState, _len_bucket  # noqa: F401  (re-export)
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

    def __init__(self, cfg, params, policy, max_batch, cache_s, device):
        self.cfg, self.policy = cfg, policy
        self.max_batch, self.device = max_batch, device
        self.state = KVDecodeState(cfg, params, policy, max_batch, cache_s,
                                   device=device)
        self.queue: deque = deque()
        self.reqs: list = [None] * max_batch
        self.lens = np.zeros(max_batch, np.int64)   # tokens held per slot
        self.ntok = np.zeros(max_batch, np.int64)   # tokens emitted per slot
        self.last = torch.zeros((max_batch, 1), dtype=torch.int32,
                                device=device)
        self.live_dev = torch.zeros(max_batch, dtype=torch.int32,
                                    device=device)
        self.decode_steps = 0
        self.decode_s: list = []    # per-step host dispatch time
        self.admit_s: list = []     # per-wave admission time (synced)
        self.req_lat: list = []     # submit -> tokens on the host
        self.ttft: list = []        # submit -> first token on the device
        self._toks: dict = {}       # slot -> [(B, 1) token tensors]

    def _take_wave(self, free):
        """The maximal FIFO prefix of the queue that shares the head
        request's prefill bucket: a long prompt closes the wave and heads
        the next one, so shorter prompts never pay its width."""
        take, bucket = [], None
        while free and self.queue:
            b = self.state.prefill_width(len(self.queue[0].prompt))
            if bucket is not None and b > bucket:
                break
            bucket = b if bucket is None else bucket
            take.append((free.pop(0), self.queue.popleft()))
        return take, bucket

    def admit(self, admit_log=None):
        """Fill freed slots from the queue with one ragged prefill."""
        free = [j for j in range(self.max_batch) if self.reqs[j] is None]
        take, sp = self._take_wave(free)
        if not take:
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
        first = self.state.prefill_into(slots, toks, plens)
        _sync(self.device)
        self.admit_s.append(time.perf_counter() - t0)
        sl = torch.as_tensor(slots, device=self.device)
        self.last = self.last.index_copy(0, sl, first[sl])
        self.live_dev = self.live_dev.index_fill(0, sl, 1)
        now = time.perf_counter()
        for j, r in take:
            self.reqs[j] = r
            self.lens[j] = len(r.prompt)
            self.ntok[j] = 1
            self._toks[j] = [first]
            r.t_first = now
            self.ttft.append(now - r.t_submit)
            if admit_log is not None:
                admit_log.append(r.rid)
            if self.ntok[j] >= r.max_new:
                self._finish(j, "max_new")

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
        nxt = self.state.step(self.last, self.live_dev)
        self.last = nxt
        self.decode_s.append(time.perf_counter() - t0)
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
        return bool(self.queue) or any(r is not None for r in self.reqs)


class Server:
    """Continuous-batching server: one ExecPolicy, slot pool and decode
    step per group. ``run(requests)`` serves until every request is done.
    Runs on the card unless ``device="cpu"`` is passed."""

    def __init__(self, cfg, params, *, max_batch=4, max_seq=512,
                 policy: Optional[ExecPolicy] = None,
                 policy_groups: Optional[dict] = None, device=None):
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
        self._groups = {name: _Group(cfg, params, pol, max_batch,
                                     self.cache_s, self.device)
                        for name, pol in groups.items()}
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
        """Per-group decode steps, request latency and TTFT percentiles,
        admission waves and queue depth, from host-side records only."""
        def pct(xs, q):
            xs = sorted(xs)
            return xs[min(len(xs) * q // 100, len(xs) - 1)] if xs else 0.0

        return {name: {"decode_steps": g.decode_steps,
                       "p50_req_s": pct(g.req_lat, 50),
                       "p95_req_s": pct(g.req_lat, 95),
                       "admit_waves": len(g.admit_s),
                       "admit_s_total": sum(g.admit_s, 0.0),
                       "queue_depth": len(g.queue),
                       "p50_ttft_s": pct(g.ttft, 50),
                       "p95_ttft_s": pct(g.ttft, 95),
                       "policy": g.policy.describe()}
                for name, g in self._groups.items()}


def make_requests(cfg, n, prompt_len, max_new, *, mixed_lengths=False,
                  min_len=4, groups=("default",), seed=0):
    """``n`` requests with random prompts from ``seed``, assigned to
    ``groups`` round-robin; ``mixed_lengths`` draws each prompt length in
    [min_len, prompt_len]."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = (int(rng.integers(min_len, prompt_len + 1)) if mixed_lengths
                else prompt_len)
        prompt = rng.integers(0, cfg.vocab, (plen,), dtype=np.int32)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    policy = resolve_policy(cfg, exp_backend=args.exp_backend,
                            kernel_backend=args.kernel_backend)
    groups = None
    if args.policy_groups:
        groups = parse_policy_groups(args.policy_groups, cfg, base=policy)
    print(f"[serve] policy: {policy.describe()}")
    for name, pol in (groups or {}).items():
        print(f"[serve]   group {name}: {pol.describe()}")
    device = resolve_device(args.device)
    params = api.init_params(cfg, 0, device=device)
    server = Server(cfg, params, max_batch=args.max_batch,
                    max_seq=args.max_seq, policy=policy,
                    policy_groups=groups, device=device)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         mixed_lengths=args.mixed_lengths,
                         groups=sorted(groups) if groups else ("default",))
    t0 = time.perf_counter()
    server.run(reqs)
    dt = time.perf_counter() - t0
    ntok = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests on {device}, {ntok} tokens in "
          f"{dt:.2f}s ({ntok / dt:.1f} tok/s)")
    for name, s in server.stats().items():
        print(f"  group {name}: {s['decode_steps']} decode steps, "
              f"request latency p50 {s['p50_req_s'] * 1e3:.1f}ms "
              f"p95 {s['p95_req_s'] * 1e3:.1f}ms, "
              f"ttft p50 {s['p50_ttft_s'] * 1e3:.1f}ms "
              f"p95 {s['p95_ttft_s'] * 1e3:.1f}ms")
    for r in reqs[:3]:
        print(f"  req {r.rid} [{r.group}] len={len(r.prompt)}: "
              f"{r.out[:8]}... ({r.finish_reason})")


if __name__ == "__main__":
    main()
