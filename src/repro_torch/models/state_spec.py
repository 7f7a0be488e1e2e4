"""Per-leaf axis metadata of decode-state trees (the port's copy of
``repro/models/state_spec.py``).

Every family's decode state (a KV cache, an SSM's per-layer ``(h,
conv)`` snapshots) is a dict of tensors in which each leaf has one
*slot* (batch) axis and at most one *sequence* axis. That is all the slot
engine needs to scatter admitted rows into a pool or zero a freed slot;
each family's ``state_axes()`` returns a dict of ``LeafAxes`` matching
its state, and ``models.decode_state`` drives the generic ops.
"""

from __future__ import annotations

from typing import Optional


class LeafAxes:
    """Axis roles of one decode-state leaf.

    batch  index of the slot (pool/batch) axis.
    seq    index of the sequence axis, or None for per-slot snapshots
           (recurrent ``h``/``conv`` state has no sequence extent).
    """

    __slots__ = ("batch", "seq")

    def __init__(self, batch: int, seq: Optional[int] = None):
        self.batch = batch
        self.seq = seq

    def __repr__(self):
        return f"LeafAxes(batch={self.batch}, seq={self.seq})"
