"""Carry the JAX package's parameters into the port.

``params_from_numpy(tree, cfg)`` takes the reference's parameter tree
(``repro.models.api.init_params`` or a checkpoint's arrays) as nested
dicts of numpy arrays and returns the port's module of ``cfg``'s family
holding the same values: a ``Transformer`` (dense) or an ``SSM`` (ssm).
The reference stacks layers on a leading ``L`` axis of ``tree["layers"]``;
each slice becomes one layer module. Matmul weights keep the reference's
(d_in, d_out) orientation; per-layer 2-D weights are cast to the compute
dtype, everything else (1-D leaves, ``embed``, ``unembed``) stays f32, as
the reference's per-call cast does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import ssm
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import resolve_device


def _copy(param, array):
    src = torch.from_numpy(np.array(array, dtype=np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(src.shape)} != parameter "
                         f"{tuple(param.shape)}")
    param.data.copy_(src.to(param.dtype))


def _copy_layers(model, layers, cfg):
    """Slice ``layers``' stacked leaves into ``model.layers``: a leaf is an
    array (a parameter of the layer) or a dict of arrays (a submodule)."""
    first = next(iter(layers.values()))
    first = next(iter(first.values())) if isinstance(first, dict) else first
    if first.shape[0] != cfg.n_layers:
        raise ValueError(f"tree has {first.shape[0]} layers, cfg "
                         f"{cfg.n_layers}")
    for i, blk in enumerate(model.layers):
        for name, leaf in layers.items():
            if isinstance(leaf, dict):
                mod = getattr(blk, name)
                for sub, arr in leaf.items():
                    _copy(getattr(mod, sub), arr[i])
            else:
                _copy(getattr(blk, name), leaf[i])


def params_from_numpy(tree: dict, cfg, *, device=None):
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    model = (ssm.SSM(cfg, g, dev) if cfg.family == "ssm"
             else Transformer(cfg, g, dev))
    _copy_layers(model, tree["layers"], cfg)
    for name, arr in tree["ln_f"].items():
        _copy(getattr(model.ln_f, name), arr)
    _copy(model.embed, tree["embed"])
    if cfg.family == "ssm":
        _copy(model.unembed, tree["unembed"])
    return model
