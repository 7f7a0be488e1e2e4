"""Per-slot serving state (port of ``repro/models/decode_state.py``,
contiguous KV cache only).

A ``DecodeState`` owns one policy group's pool: the stacked KV cache
(``data``), allocated once at pool width and capacity, and the per-slot
device-side position vector (``pos_dev``). The engine talks to it only
through ``prefill_into`` / ``step`` / ``reset_slots`` / ``max_len`` /
``prefill_width``. Positions advance on the device, and emitted tokens
stay there: a decode step ships nothing to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import transformer


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

    def __init__(self, cfg, params, policy, pool_width, cache_s, *, device):
        self.cfg, self.params, self.policy = cfg, params, policy
        self.pool_width, self.cache_s = pool_width, cache_s
        self.device = device
        self.data = None                 # allocated on first admission
        self.pos_dev = torch.zeros(pool_width, dtype=torch.int32,
                                   device=device)

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
        toks_t = torch.as_tensor(toks, device=self.device)
        plens_t = torch.as_tensor(plens, device=self.device)
        logits, pref = transformer.prefill(self.params, self.cfg, toks_t,
                                           prompt_len=plens_t,
                                           policy=self.policy)
        if self.data is None:
            self.data = transformer.init_cache(self.cfg, self.pool_width,
                                               self.cache_s, self.device)
        sl = torch.as_tensor(np.asarray(slots), device=self.device)
        sp = toks.shape[1]
        for name in ("k", "v"):
            pool, rows = self.data[name], pref[name][:, sl]
            if self.cfg.kv_cache_layout == "bhsd":
                pool[:, sl, :, :sp] = rows
            else:
                pool[:, sl, :sp] = rows
        self.pos_dev[sl] = plens_t[sl].to(torch.int32)
        return _guard_tokens(logits)

    def step(self, last, live):
        """One decode step over the pool; live slots' positions advance
        by one on the device. Returns the (pool_width, 1) next tokens."""
        logits, self.data = transformer.decode_step(
            self.params, self.cfg, last, self.data, self.pos_dev,
            policy=self.policy, live=live)
        self.pos_dev = self.pos_dev + live
        return _guard_tokens(logits, last)

    def reset_slots(self, slots):
        """Park freed slots at position 0. KV rows are not zeroed: decode
        masks them by cache_len and admission overwrites them."""
        self.pos_dev[torch.as_tensor(np.asarray(slots),
                                     device=self.device)] = 0


class KVDecodeState(DecodeState):
    """Dense transformer: contiguous KV cache + per-slot positions."""

    kind = "kv"

    def max_len(self):
        # a linear cache is exhausted when the next write would fall past
        # its last row
        return self.cache_s
