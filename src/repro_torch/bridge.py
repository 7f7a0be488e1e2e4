"""Carry the JAX package's parameters into the port.

``params_from_numpy(tree, cfg)`` takes the reference's parameter tree
(``repro.models.api.init_params`` or a checkpoint's arrays) as nested
dicts of numpy arrays and returns the port's module of ``cfg``'s family
holding the same values: a ``Transformer`` (dense, moe), an ``SSM``
(ssm) or a ``Hybrid`` (hybrid). Matmul weights keep the reference's (d_in, d_out)
orientation.

The reference stacks layers on leading axes and casts, as a stack enters
its scan, every f32 leaf of more than one dimension to the compute
dtype; the port holds each value as that cast leaves it:

* dense, moe and ssm: ``tree["layers"]`` stacks the layers on one
  ``L`` axis; a layer's weights of two or more dimensions go to the
  compute dtype, its 1-D leaves stay f32;
* hybrid: ``tree["periods"]`` stacks the periods, and within each its
  ``recs`` carry a second stacking axis; ``tree["tail"]`` stacks the
  tail. The recurrent layers are cast while stacked, so every one of
  their leaves goes to the compute dtype (the two gate matrices are then
  held as f32 copies of those values); the attention layer's 2-D
  weights go to the compute dtype and its norms stay f32.

``embed`` and, where the embeddings are untied (``cfg.tie_embeddings``
false: every family but gpt2-small's), ``unembed`` stay f32. A SwiGLU
layer's gate ``wg`` crosses with its other 2-D weights. A MoE layer's
``moe`` subtree crosses the same way: its ``router`` (D, E) goes to the
compute dtype like every other 2-D weight (the reference lifts it back
to f32 only after that cast), and its stacked ``experts`` {wg, wu, wd}
keep their leading E axis and go to the compute dtype too.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import hybrid, ssm
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import resolve_device


def _copy(param, array, via=None):
    """``param`` <- ``array``, rounded through dtype ``via`` first."""
    src = torch.from_numpy(np.array(array, dtype=np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(src.shape)} != parameter "
                         f"{tuple(param.shape)}")
    if via is not None:
        src = src.to(via)
    param.data.copy_(src.to(param.dtype))


def _copy_module(mod, leaves, idx, via=None):
    """Copy slice ``idx`` of every stacked leaf of ``leaves`` (a dict of
    arrays and dicts, one per submodule) into ``mod``."""
    for name, leaf in leaves.items():
        if isinstance(leaf, dict):
            _copy_module(getattr(mod, name), leaf, idx, via)
        else:
            _copy(getattr(mod, name), leaf[idx], via)


def _depth(leaves):
    first = next(iter(leaves.values()))
    return _depth(first) if isinstance(first, dict) else first.shape[0]


def _copy_layers(model, layers, cfg):
    if _depth(layers) != cfg.n_layers:
        raise ValueError(f"tree has {_depth(layers)} layers, cfg "
                         f"{cfg.n_layers}")
    for i, blk in enumerate(model.layers):
        _copy_module(blk, layers, i)


def _copy_hybrid(model, tree, cfg):
    cdt = getattr(torch, cfg.compute_dtype)
    _, n_per, tail = hybrid.period_counts(cfg)
    per = tree["periods"]
    if _depth(per) != n_per or (tail and _depth(tree["tail"]) != tail):
        raise ValueError(f"tree's periods / tail do not match cfg "
                         f"({n_per} periods, tail {tail})")
    for i, p in enumerate(model.periods):
        for j, rec in enumerate(p.recs):
            _copy_module(rec, per["recs"], (i, j), via=cdt)
        _copy_module(p.attn, per["attn"], i)
    for j, rec in enumerate(model.tail):
        _copy_module(rec, tree["tail"], j, via=cdt)


def params_from_numpy(tree: dict, cfg, *, device=None):
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    if cfg.family == "hybrid":
        model = hybrid.Hybrid(cfg, g, dev)
        _copy_hybrid(model, tree, cfg)
    else:
        model = (ssm.SSM(cfg, g, dev) if cfg.family == "ssm"
                 else Transformer(cfg, g, dev))
        _copy_layers(model, tree["layers"], cfg)
    for name, arr in tree["ln_f"].items():
        _copy(getattr(model.ln_f, name), arr)
    _copy(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        _copy(model.unembed, tree["unembed"])
    return model
