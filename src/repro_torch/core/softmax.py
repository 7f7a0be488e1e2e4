"""Softmax on the VEXP exponential, and the online (partial) softmax algebra.

Port of ``repro/core/softmax.py:29-189``. ``softmax`` is the paper's
three-step kernel structure: the row max, ``exp(x - max)`` with its sum,
then one reciprocal per row and a multiply. The online variants keep
FlashAttention-style running statistics (m = running max, l = running sum
of exponentials) with an associative, commutative merge.
``stats_merge_collective`` / ``stats_merge_collective_packed`` fold that
merge over the shards of a sequence-sharded KV cache through a
``torch.distributed`` process group, wrapped as
``repro_torch.distributed.ShardGroup`` (any object with its
``all_gather`` / ``all_reduce`` does).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .vexp import get_exp_fn

# Finite "empty" sentinel the kernels use instead of -inf (keeps the vexp
# bit-twiddle NaN-free). Anything at or below half of it means "this
# shard saw no valid key".
KERNEL_NEG_INF = -1e30


def _resolve(exp_impl) -> Callable:
    return exp_impl if callable(exp_impl) else get_exp_fn(exp_impl)


def softmax(x: torch.Tensor, axis: int = -1, *, exp_impl="vexp",
            where=None, policy=None) -> torch.Tensor:
    """Numerically stable softmax with a pluggable exp backend.

    A ``policy`` overrides ``exp_impl``; under the ``cuda`` tier an
    unmasked call goes to the fused row-softmax kernel through the
    dispatch table. ``where`` (bool, broadcast to x) masks entries out;
    a row masked everywhere comes out all zeros, not NaN."""
    if policy is not None:
        if policy.kernel_backend == "cuda" and where is None:
            from repro_torch.kernels.dispatch import dispatch
            return dispatch("softmax", policy)(x, axis=axis, policy=policy)
        exp_impl = policy.exp_backend
    exp_fn = _resolve(exp_impl)
    if where is not None:
        x = torch.where(where, x, -torch.inf)
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, 0.0)          # all-masked rows
    e = exp_fn(x - m)
    if where is not None:
        e = torch.where(where, e, 0.0)
    s = e.sum(dim=axis, keepdim=True)
    # one reciprocal per row, then a multiply; the guard keeps a row with
    # s == 0 at zeros instead of inf * 0 = NaN
    return e * (1.0 / torch.clamp(s, min=1e-30))


def log_softmax(x: torch.Tensor, axis: int = -1, *,
                exp_impl="vexp") -> torch.Tensor:
    """log softmax; only the exp is approximated, the log stays exact."""
    exp_fn = _resolve(exp_impl)
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    shifted = x - m
    s = exp_fn(shifted).sum(dim=axis, keepdim=True)
    return shifted - torch.log(s)


class SoftmaxStats(NamedTuple):
    """Online softmax running statistics for a row (or batch of rows)."""
    m: torch.Tensor    # running max
    l: torch.Tensor    # running sum of exp(x - m)


def stats_init(shape, dtype=torch.float32, device=None) -> SoftmaxStats:
    return SoftmaxStats(m=torch.full(shape, -torch.inf, dtype=dtype,
                                     device=device),
                        l=torch.zeros(shape, dtype=dtype, device=device))


def stats_update(stats: SoftmaxStats, x_blk: torch.Tensor, axis: int = -1,
                 *, exp_fn: Callable):
    """Absorb one block of scores; returns (new_stats, p_blk, alpha):
    p_blk = exp(x_blk - m_new), and alpha = exp(m_old - m_new) rescales
    any accumulator keyed on m_old (the FlashAttention-2 rescale)."""
    m_blk = torch.amax(x_blk, dim=axis)
    m_new = torch.maximum(stats.m, m_blk)
    # guard -inf - -inf = NaN for fully masked blocks
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    old_ok = torch.isfinite(stats.m)
    alpha = exp_fn(torch.where(old_ok, stats.m - safe_m, -torch.inf))
    alpha = torch.where(old_ok, alpha, 0.0)
    p_blk = exp_fn(x_blk - safe_m.unsqueeze(axis))
    p_blk = torch.where(torch.isfinite(x_blk), p_blk, 0.0)
    l_new = stats.l * alpha + p_blk.sum(dim=axis)
    return SoftmaxStats(m=m_new, l=l_new), p_blk, alpha


def stats_merge(a: SoftmaxStats, b: SoftmaxStats, *, exp_fn: Callable):
    """Merge two partial softmaxes; returns (merged, alpha_a, alpha_b).
    Associative and commutative, so it folds in any tree order."""
    m = torch.maximum(a.m, b.m)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)

    def _alpha(mm):
        ok = torch.isfinite(mm)
        al = exp_fn(torch.where(ok, mm - safe_m, -torch.inf))
        return torch.where(ok, al, 0.0)

    aa, ab = _alpha(a.m), _alpha(b.m)
    return SoftmaxStats(m=m, l=a.l * aa + b.l * ab), aa, ab


def _shard_alpha(m_sh, m_g, exp_fn):
    """exp(m_shard - m_global), 0 for empty shards. The global max is
    taken before any exp, so the argument is <= 0 and cannot overflow
    however far apart the shards' maxima are; a shard that saw no valid
    key (m <= KERNEL_NEG_INF / 2, or -inf) contributes exactly nothing."""
    empty = (m_sh <= 0.5 * KERNEL_NEG_INF) | ~torch.isfinite(m_sh)
    safe_g = torch.where(torch.isfinite(m_g), m_g, 0.0)
    return torch.where(empty, 0.0, exp_fn(m_sh - safe_g))


def stats_fold_packed(tiles: torch.Tensor, *, exp_fn: Callable):
    """The local fold of gathered packed tiles: ``tiles`` (n_shards, ...,
    d + 2) f32, each laid out ``[acc (d) | m (1) | l (1)]``. Returns
    (SoftmaxStats with (..., 1) m and l, acc (..., d)); normalize with
    ``acc / max(l, tiny)``. The fold after the all_gather of
    ``stats_merge_collective_packed``, on its own so that tiles from one
    device fold the same way."""
    d = tiles.shape[-1] - 2
    m_sh, l_sh = tiles[..., d:d + 1], tiles[..., d + 1:d + 2]
    m_g = m_sh.amax(dim=0)
    alpha = _shard_alpha(m_sh, m_g, exp_fn)
    return (SoftmaxStats(m=m_g, l=(l_sh * alpha).sum(dim=0)),
            (tiles[..., :d] * alpha).sum(dim=0))


def stats_merge_collective_packed(packed: torch.Tensor, comm, *,
                                  exp_fn: Callable):
    """Single-collective merge: one all_gather of every shard's packed
    ``(..., d + 2)`` tile over ``comm``, then ``stats_fold_packed``.
    Returns (SoftmaxStats, acc) as ``stats_merge_collective`` does."""
    return stats_fold_packed(comm.all_gather(packed), exp_fn=exp_fn)


def stats_merge_collective(stats: SoftmaxStats, acc: torch.Tensor, comm, *,
                           exp_fn: Callable):
    """``stats_merge`` folded over every shard of ``comm``: all_reduce MAX
    of m (the global max, before any exp), then all_reduce SUMs of the
    alpha-rescaled l and acc (acc's trailing dims broadcast against l's).
    Three collectives; the packed form moves the same algebra in one."""
    m_g = comm.all_reduce(stats.m, "max")
    alpha = _shard_alpha(stats.m, m_g, exp_fn)
    l_g = comm.all_reduce(stats.l * alpha, "sum")
    acc_g = comm.all_reduce(acc * alpha, "sum")
    return SoftmaxStats(m=m_g, l=l_g), acc_g
