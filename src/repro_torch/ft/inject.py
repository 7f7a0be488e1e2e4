"""Seeded fault injection for the serving stack (the chaos harness; the
port's own copy of ``repro/ft/inject.py``, numpy only, kept unchanged in
its catalog, its RNG and its draw order, so one seed fires the same
faults in the same event order in both packages).

The engine's fault-tolerance claims (a cancelled request releases its
pages, a poisoned slot is quarantined instead of streaming garbage,
admission pressure degrades service instead of stopping the loop) hold
only once faults fire. ``FaultInjector`` makes them fire
deterministically: a seeded RNG plus named injection points threaded
through ``launch/serve.py``, ``models/decode_state.py`` and
``models/block_pool.py``.

* **Off by default.** Every call site guards with ``if injector is not
  None``: serving without an injector pays one attribute check per
  scheduling event and nothing per decode step.
* **Scheduling events only.** Faults fire at admission, chunk dispatch
  and decode dispatch, host-side decision points the engine already
  owns; no injection point adds a device sync or runs inside a
  captured step.
* **Deterministic per seed.** A point fires either on an explicit
  ``schedule`` (the Nth evaluation of that point) or at a seeded
  ``rate``; given the same seed and the same engine event order, the
  same faults fire. ``REPRO_FAULT_SEED`` seeds the CLI runs.
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

FAULT_SEED_ENV = "REPRO_FAULT_SEED"

# The injection-point catalog. Call sites pass these names to ``fire``;
# anything else is a typo we want loud, not a silently-dead fault.
POINTS = (
    # admission rejected at the DecodeState entry (contiguous pools have
    # no allocator to exhaust, so this is how THEIR OutOfBlocks path is
    # exercised; paged pools get it too, upstream of any reservation)
    "admit.out_of_blocks",
    # allocation fails inside BlockAllocator._alloc_one — mid-alloc_cols,
    # so the all-or-nothing rollback and attach-release paths actually run
    "alloc.out_of_blocks",
    # the decode dispatch fails (the engine re-queues every in-flight
    # request and resets the pool)
    "decode.step_error",
    # NaNs written into one live slot's private state; the decode
    # program's finite-logits guard must catch it and the engine must
    # quarantine the slot
    "decode.poison",
    # a prefill chunk dispatch stalls (straggler chunk)
    "chunk.delay",
    # prefix-cache chains invalidated (the recovery action for detected
    # corruption: drop the entry, never serve it)
    "prefix.corrupt",
)


class InjectedFault(RuntimeError):
    """Raised by injection points that simulate a failed dispatch."""


class FaultInjector:
    """Seeded, named-point fault injector.

    Each point fires either on an explicit ``schedule`` (a set of event
    indices: the point's Nth evaluation, 0-based) or with probability
    ``rates[point]`` per evaluation. ``limits[point]`` optionally caps
    the total number of fires. Per-point evaluation and fire counters
    (``seen``/``fired``) make test assertions and smoke-run reports
    exact.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Mapping[str, float]] = None,
                 schedule: Optional[Mapping[str, Iterable[int]]] = None,
                 limits: Optional[Mapping[str, int]] = None,
                 delay_s: float = 0.002):
        for m in (rates, schedule, limits):
            for point in (m or ()):
                if point not in POINTS:
                    raise ValueError(f"unknown injection point {point!r}; "
                                     f"catalog: {POINTS}")
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.rates = dict(rates or {})
        self.schedule = {k: frozenset(int(i) for i in v)
                         for k, v in (schedule or {}).items()}
        self.limits = dict(limits or {})
        self.delay_s = float(delay_s)
        self.seen: dict = {}      # point -> fire() evaluations
        self.fired: dict = {}     # point -> times it actually fired

    def fire(self, point: str) -> bool:
        """Should ``point`` fault at this evaluation? Counts either way."""
        n = self.seen.get(point, 0)
        self.seen[point] = n + 1
        if point in self.schedule:
            hit = n in self.schedule[point]
        elif point in self.rates:
            hit = float(self.rng.random()) < self.rates[point]
        else:
            hit = False
        if hit and self.fired.get(point, 0) >= self.limits.get(point, 1 << 62):
            hit = False
        if hit:
            self.fired[point] = self.fired.get(point, 0) + 1
        return hit

    def choose(self, seq: Sequence):
        """Deterministically pick a victim (e.g. which slot to poison)."""
        return seq[int(self.rng.integers(len(seq)))]

    def stats(self) -> dict:
        return {"seed": self.seed,
                "fired": dict(self.fired),
                "seen": dict(self.seen)}

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 **kw) -> "FaultInjector":
        """Injector seeded from ``REPRO_FAULT_SEED`` (default 0)."""
        env = os.environ if env is None else env
        return cls(seed=int(env.get(FAULT_SEED_ENV, "0") or "0"), **kw)


def default_chaos_rates() -> dict:
    """The smoke/benchmark chaos mix: every catalog point enabled at a
    rate a short run will actually fire, low enough that the workload
    still completes (step errors requeue whole pools, so they stay
    rarest)."""
    return {
        "admit.out_of_blocks": 0.10,
        "alloc.out_of_blocks": 0.02,
        "decode.step_error": 0.03,
        "decode.poison": 0.05,
        "chunk.delay": 0.10,
        "prefix.corrupt": 0.05,
    }
