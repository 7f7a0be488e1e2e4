"""Fault-tolerance runtime of the trainer (port of ``repro/ft/runtime.py:
36-108``, host-side Python with no JAX in it, copied): preemption
handling, straggler detection, restart supervision.

Components
----------
PreemptionGuard
    Installs SIGTERM/SIGINT handlers (the signals preemptions deliver)
    and exposes ``should_stop``; the train loop checks it once per step and
    takes a final synchronous checkpoint before exiting cleanly.

StragglerDetector
    Tracks a rolling window of per-step wall times; flags steps slower than
    ``threshold``× the rolling median. On a real fleet the flagged host ids
    feed the scheduler's replace/restart policy; here the detector powers
    tests and logs.

run_supervised
    In-process restart supervisor: runs a step function, catches crashes,
    restores the latest checkpoint and resumes — the single-process model
    of a cluster controller's restart-from-checkpoint loop. Used by tests
    to prove checkpoint/restart correctness (bitwise-identical resume).
"""

from __future__ import annotations

import collections
import signal
import statistics
import time
from typing import Callable


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:          # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def trigger(self):                  # tests / manual drain
        self._stop = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StragglerDetector:
    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.window = collections.deque(maxlen=window)
        self.threshold = threshold
        self.flagged: list[tuple[int, float, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.window) >= 5:
            med = statistics.median(self.window)
            if seconds > self.threshold * med:
                self.flagged.append((step, seconds, med))
                is_straggler = True
        self.window.append(seconds)
        return is_straggler

    @property
    def median(self) -> float:
        return statistics.median(self.window) if self.window else 0.0


def run_supervised(make_state: Callable, step_fn: Callable,
                   save_fn: Callable, restore_fn: Callable,
                   n_steps: int, *, max_restarts: int = 3,
                   ckpt_every: int = 10):
    """Crash-tolerant supervisor. step_fn(state, step) -> state (may raise);
    save_fn(state, step); restore_fn() -> (state, step) or None.

    Returns (final_state, restarts_used).
    """
    restarts = 0
    restored = restore_fn()
    state, start = restored if restored else (make_state(), 0)
    step = start
    while step < n_steps:
        try:
            state = step_fn(state, step)
            step += 1
            if step % ckpt_every == 0:
                save_fn(state, step)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            restored = restore_fn()
            state, step = restored if restored else (make_state(), 0)
    return state, restarts
