"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): the grok-1 /
dbrx style layer, a softmax router on the policy's exponential, top-k
experts a token, and a per-row capacity dispatch into stacked experts.

The computation follows the reference step by step:

* router logits in f32 (``x.float() @ router.float()``; the router is
  held in the compute dtype, as the reference's layer-entry cast leaves
  it), their softmax through ``core.softmax.softmax`` with the exp from
  ``kernels.dispatch.exp_callable(policy)``: on the card one launch of
  the vexp kernel a call;
* the top ``k`` probabilities a token, lower expert index first among
  equal values, as ``jax.lax.top_k`` orders them (``torch.topk`` does
  not), renormalised by ``max(sum, 1e-9)``;
* every batch row buckets its ``S * k`` choices on its own: a choice's
  rank within its expert is a cumulative sum over the row, a choice
  ranked at or past the capacity ``cap`` is dropped, and a kept one
  lands at slot ``expert * cap + rank``. The capacity is the
  reference's ``_capacity`` of the call's sequence width (a chunk's or a
  suffix's width where the call prefills one; 8 in a decode step), so
  padding, which sits after a row's real tokens, never displaces one;
* the experts run as batched products over the expert axis (SwiGLU, whose
  gate exp is one more vexp launch, or tanh GELU);
* each choice gathers its slot's output, dropped ones give zero, and the
  ``k`` outputs a token are weighted in f32 and summed in order.

Every shape is static and no value goes to the host, so the decode step
stays one CUDA graph: no boolean indexing, ``nonzero`` or data-dependent
size; the reference's ``mode="drop"`` scatter is a scatter into
``E * cap + 1`` columns whose last one is cut off; a parked row or one
with non-finite logits still indexes in range. The reference's
load-balance and z losses are read only by its loss, so they are not
computed here (training is not ported).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.analysis.registry import hot_path
from repro_torch.core.softmax import softmax
from repro_torch.kernels.dispatch import exp_callable
from .layers import gelu, vexp_silu


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _stack(g, n, d_in, d_out, dtype, device):
    """(n, d_in, d_out) of N(0, 1) / sqrt(d_in), drawn one matrix at a
    time in f32 and held in ``dtype``."""
    out = torch.empty(n, d_in, d_out, dtype=dtype, device=device)
    for e in range(n):
        out[e] = (torch.randn(d_in, d_out, generator=g, device=device)
                  * (1.0 / math.sqrt(d_in))).to(dtype)
    return out


class Experts(nn.Module):
    """The stacked expert FFNs: ``wg`` (SwiGLU only) and ``wu`` (E, D, F),
    ``wd`` (E, F, D)."""

    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        if cfg.act == "swiglu":
            self.wg = _param(_stack(g, e, d, f, dtype, device))
        self.wu = _param(_stack(g, e, d, f, dtype, device))
        self.wd = _param(_stack(g, e, f, d, dtype, device))


class MoE(nn.Module):
    """``router`` (D, E) and the stacked ``experts``, the reference's
    ``moe_init`` tree (``moe.py:32``), 2-D and 3-D weights in the compute
    dtype."""

    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        self.experts = Experts(cfg, g, dtype, device)
        self.router = _param(_stack(g, 1, cfg.d_model, cfg.n_experts, dtype,
                                    device)[0])


def capacity(seq: int, cfg) -> int:
    """Expert slots a row for a call of ``seq`` tokens (reference
    ``_capacity``, ``moe.py:41``): ceil(seq * k / E * capacity_factor),
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def top_k(probs, k):
    """(values, indices) of the ``k`` largest entries of the last axis,
    in descending order and, among equal values, lower index first
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x, router, cfg, policy):
    """(probs (B, S, E) f32, weights (B, S, k) f32, experts (B, S, k)
    int64) of ``x`` (B, S, D): the router softmax on the policy's exp, its
    top ``k`` and the renormalised weights."""
    logits = x.float() @ router.float()
    probs = softmax(logits, -1, exp_impl=exp_callable(policy))
    weights, idx = top_k(probs, cfg.top_k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return probs, weights, idx


def _dispatch(idx, cap, e):
    """Per-row capacity dispatch of the (B, S, k) expert choices: (slot
    (B, S*k) in [0, E*cap), keep (B, S*k) bool, bucket sources (B, E*cap)
    int64, each the row-local token index a slot takes or S for an empty
    slot)."""
    b, s, k = idx.shape
    flat = idx.reshape(b, s * k)
    onehot = torch.nn.functional.one_hot(flat, e).to(torch.int32)
    rank = ((torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot)
            * onehot).sum(-1)                                   # (B, S*k)
    keep = rank < cap
    slot = flat * cap + torch.clamp(rank, max=cap - 1)
    src = (torch.arange(s * k, device=idx.device) // k).expand(b, -1)
    buckets = torch.full((b, e * cap + 1), s, dtype=torch.int64,
                         device=idx.device)
    buckets.scatter_(1, torch.where(keep, slot, e * cap), src)
    return slot, keep, buckets[:, :e * cap]


def _expert_mlp(xe, experts, act, policy):
    """xe (E, N, D) -> (E, N, D) through each expert's FFN (reference
    ``_expert_mlp``, ``moe.py:102``)."""
    if act == "swiglu":
        h = vexp_silu(torch.bmm(xe, experts.wg), exp_callable(policy)) \
            * torch.bmm(xe, experts.wu)
    else:
        h = gelu(torch.bmm(xe, experts.wu))
    return torch.bmm(h, experts.wd)


@hot_path
def moe_apply(x, p, cfg, *, policy):
    """x (B, S, D) -> (B, S, D) in x's dtype (reference ``moe_apply``,
    ``moe.py:46``, without its aux losses). ``p`` is an ``MoE``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(s, cfg)
    _, weights, idx = route(x, p.router, cfg, policy)
    slot, keep, buckets = _dispatch(idx, cap, e)
    # the buckets expert-major, (E, B*cap), as rows of x padded with a
    # zero row per batch row (the empty slots' source)
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1).reshape(-1, d)
    rows = buckets + (s + 1) * torch.arange(b, device=x.device)[:, None]
    rows = rows.reshape(b, e, cap).transpose(0, 1).reshape(e, b * cap)
    ye = _expert_mlp(x_pad[rows], p.experts, cfg.act, policy)  # (E,B*cap,D)
    # each choice's output: slot e*cap + r of row b is ye[e, b*cap + r]
    at = (slot // cap) * (b * cap) + torch.arange(
        b, device=x.device)[:, None] * cap + slot % cap
    got = ye.reshape(e * b * cap, d)[torch.where(keep, at, 0)]
    got = torch.where(keep[..., None], got, 0).float() \
        * weights.reshape(b, s * k)[..., None]
    got = got.reshape(b, s, k, d)
    out = got[:, :, 0]
    for j in range(1, k):
        out = out + got[:, :, j]
    return out.to(x.dtype)
