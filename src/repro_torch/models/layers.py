"""Shared building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors. Dtype behaviour follows the reference: norms
compute in f32 and return the input dtype; RoPE rotates in f32 and
returns the input dtype; biases are added in the activation dtype; the
gates (``vexp_sigmoid``, ``vexp_softplus``, ``vexp_silu``) compute in
f32 through the exp callable they are given and return the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import exp_callable


def rmsnorm(x, w, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def norm_apply(x, p, kind, eps):
    """``p`` holds ``w`` (and ``b`` for layernorm)."""
    if kind == "layernorm":
        return layernorm(x, p.w, p.b, eps)
    return rmsnorm(x, p.w, eps)


def rope_freqs(d_rot: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def apply_rope(x, pos, theta=10000.0, rope_pct=1.0):
    """x: (B, S, H, D); pos: (B, S) or (S,) absolute positions. Rotates
    interleaved lane pairs (x[..., ::2], x[..., 1::2]), as the reference
    does, not the two halves."""
    d = x.shape[-1]
    d_rot = int(d * rope_pct) // 2 * 2
    if d_rot == 0:
        return x
    freqs = rope_freqs(d_rot, theta, x.device)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None].float() * freqs              # (B, S, d_rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin                          # f32 (promotion)
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def vexp_sigmoid(x, exp_fn):
    """sigmoid(x) = 1 / (1 + exp(-x)) with the given exponential, stable
    on both signs (reference ``layers.py:90-95``)."""
    xf = x.float()
    e = exp_fn(-xf.abs())
    s = torch.where(xf >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    return s.to(x.dtype)


def vexp_softplus(x, exp_fn):
    """softplus(x) = max(x, 0) + log1p(exp(-|x|)), exp through
    ``exp_fn`` (reference ``layers.py:98-102``)."""
    xf = x.float()
    return (torch.clamp(xf, min=0.0)
            + torch.log1p(exp_fn(-xf.abs()))).to(x.dtype)


def vexp_silu(x, exp_fn):
    return x * vexp_sigmoid(x, exp_fn)


def gelu(x):
    """Tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(x, p, act, *, policy):
    """The FFN (reference ``layers.py:130-144``). ``act == "swiglu"``:
    ``p`` holds wg, wu and wd; h = vexp_silu(x @ wg) * (x @ wu), whose
    gate exp comes from ``kernels.dispatch.exp_callable(policy)`` (one
    launch of the vexp kernel a call under the ``cuda`` tier on the card,
    the plain function on the CPU). ``act == "gelu"``: ``p`` holds wu, wd
    and the optional biases bu, bd; ``policy`` is not read."""
    if act == "swiglu":
        h = vexp_silu(x @ p.wg, exp_callable(policy)) * (x @ p.wu)
    elif act == "gelu":
        h = x @ p.wu
        if p.bu is not None:
            h = h + p.bu.to(h.dtype)
        h = gelu(h)
    else:
        raise NotImplementedError(f"mlp activation {act!r} is not ported")
    y = h @ p.wd
    if p.bd is not None:
        y = y + p.bd.to(y.dtype)
    return y


def mask_padded_logits(logits, vocab: int):
    """Mask the padded tail of the vocab dim to -1e30 so it never wins an
    argmax."""
    if logits.shape[-1] == vocab:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
    return torch.where(keep, logits, -1e30)


def _ce_chunk(x, w, lab, m, softcap, exp_fn):
    """One sequence chunk's masked NLL (B, C) (the reference's scan body,
    ``layers.py:183-201``): f32 logits against the unembedding, a
    log-sum-exp through ``exp_fn`` about the detached row max, the label
    logit from a gathered unembedding row."""
    wf = w.float()
    xf = x.float()
    logits = xf @ wf                                      # (B, C, V)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mx = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(exp_fn(logits - mx).sum(dim=-1)) + mx[..., 0]
    corr = (xf * F.embedding(lab, wf.T)).sum(dim=-1)
    if softcap:
        corr = softcap * torch.tanh(corr / softcap)
    return (lse - corr) * m


def cross_entropy(x_final, w_unembed, labels, *, chunk=512,
                  logit_softcap=0.0, mask=None, policy):
    """Chunked cross-entropy over the sequence axis, mean nats a token
    (reference ``layers.py:160-214``). x_final (B, S, D); w_unembed (D,
    V); labels (B, S) int; mask: optional (B, S) bool of the tokens that
    count. The sequence is cut into chunks of ``chunk`` (the last padded,
    its pad masked); each chunk's (B, C, V) f32 logits live only inside
    ``_ce_chunk``, which the backward recomputes
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so
    no chunk's logits are kept for it. The exp is the policy's
    (``kernels.dispatch.exp_callable``: the exp kernel under the cuda
    tier on the card); the label logit comes through a row gather
    (``F.embedding``, deterministic in its gradient)."""
    exp_fn = exp_callable(policy)
    b, s, _ = x_final.shape
    chunk = min(chunk, s)
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=x_final.device)
    if pad:
        x_final = F.pad(x_final, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x_final.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x_final.device)
    for c0 in range(0, nchunk * chunk, chunk):
        m = mask[:, c0:c0 + chunk].float()
        nll = checkpoint(_ce_chunk, x_final[:, c0:c0 + chunk], w_unembed,
                         labels[:, c0:c0 + chunk], m, logit_softcap, exp_fn,
                         use_reentrant=False)
        tot = tot + nll.sum()
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)
