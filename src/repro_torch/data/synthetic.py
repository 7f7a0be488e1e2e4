"""Deterministic, resumable synthetic data (the port's own copy of
``repro/data/synthetic.py``; numpy only, so every batch equals the JAX
package's bit for bit).

Every batch is a pure function of (seed, step, shape): a job restarted
from a checkpoint at step k replays the same stream with no state file.
``StructuredLM`` is the learnable stream (a repeated random motif with
noise, so a model that learns to copy drops its loss well below the
unigram entropy). The modality families (vlm, audio) are not ported, and
``SyntheticLM`` raises for them.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


class SyntheticLM:
    """Uniform-random token batches of a (cfg, batch, seq) cell."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0):
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{cfg.family} batches (modality inputs) are not ported "
                f"yet (ROADMAP.md, A12)")
        self.cfg, self.b, self.s, self.seed = cfg, batch, seq, seed

    def batch(self, step: int) -> dict:
        rng = _rng(self.seed, step)
        return {
            "tokens": rng.integers(0, self.cfg.vocab, (self.b, self.s),
                                   dtype=np.int32),
            "labels": rng.integers(0, self.cfg.vocab, (self.b, self.s),
                                   dtype=np.int32),
        }


class StructuredLM:
    """Learnable synthetic LM stream: each sequence is a repeated random
    motif with noise. Deterministic per (seed, step)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 motif_len: int = 16, noise: float = 0.05):
        self.v, self.b, self.s, self.seed = vocab, batch, seq, seed
        self.m, self.noise = motif_len, noise

    def batch(self, step: int) -> dict:
        rng = _rng(self.seed, step)
        motifs = rng.integers(0, self.v, (self.b, self.m))
        reps = -(-(self.s + 1) // self.m)
        seqs = np.tile(motifs, (1, reps))[:, :self.s + 1]
        flip = rng.random(seqs.shape) < self.noise
        seqs = np.where(flip, rng.integers(0, self.v, seqs.shape), seqs)
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}
