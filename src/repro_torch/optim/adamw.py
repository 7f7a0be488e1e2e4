"""AdamW with global-norm clipping and a warmup + cosine schedule (port
of ``repro/optim/adamw.py:13-87``), as plain functions on tensors.

A parameter set is a dict of tensors keyed by name (``dict(model.
named_parameters())``); the state is ``{"m": {name: moment}, "v": {name:
moment}, "step": int32 0-d}``. The f32 math and its order follow the
reference: clip every gradient by the global norm, bias-correct both
moments, ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, decay only
on leaves of two or more dims in the reference's tree (where each
layer's leaves are stacked on a layer axis: ``_tree_ndim``); the moments
are held in ``moment_dtype``. A gradient of ``None`` (a parameter the loss does not
reach) counts as zero, as JAX's zero cotangent does.
``torch.optim.AdamW`` is not this function: it applies the decay before
the step, outside the lr-scaled sum, and clips nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0
    # Adam moments in bf16 halve the optimizer's memory; the masters stay
    # f32
    moment_dtype: str = "float32"


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: dict, cfg: OptConfig) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
                for n, p in params.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares; ``None``
    leaves count as zero."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()
              if x is not None]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _tree_ndim(name: str, p: torch.Tensor) -> int:
    """The dims of ``p``'s leaf in the reference's tree: each module-list
    index in its name ("layers.3.ln_attn.w") is a stacking axis there,
    so a layer's norms and biases are 2-D leaves and decay, as in the
    reference; only the top-level 1-D ones (``ln_f``) do not."""
    return p.dim() + sum(part.isdigit() for part in name.split("."))


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, cfg: OptConfig):
    """Returns (new_params, new_state, stats), new tensors throughout."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    mdt = getattr(torch, cfg.moment_dtype)
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        g = grads.get(n)
        pf = p.float()
        gf = (torch.zeros_like(pf) if g is None else g.float()) * scale
        mn = b1 * state["m"][n].float() + (1 - b1) * gf
        vn = b2 * state["v"][n].float() + (1 - b2) * gf * gf
        step_ = (mn / c1) / (torch.sqrt(vn / c2) + cfg.eps)
        # decoupled weight decay on >= 2-D leaves of the reference's tree
        wd = cfg.weight_decay if _tree_ndim(n, p) >= 2 else 0.0
        new_p[n] = (pf - lr * (step_ + wd * pf)).to(p.dtype)
        new_m[n], new_v[n] = mn.to(mdt), vn.to(mdt)
    stats = {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
    return new_p, {"m": new_m, "v": new_v, "step": step}, stats
