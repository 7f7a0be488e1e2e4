"""Carry the JAX package's parameters into the port.

``params_from_numpy(tree, cfg)`` takes the reference's parameter tree
(``repro.models.api.init_params`` or a checkpoint's arrays) as nested
dicts of numpy arrays and returns the port's ``Transformer`` holding the
same values. The reference stacks layers on a leading ``L`` axis of
``tree["layers"]``; each slice becomes one ``Block``. Matmul weights keep
the reference's (d_in, d_out) orientation; per-layer 2-D weights are cast
to the compute dtype, everything else stays f32, as the reference's
forward does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Transformer
from repro_torch.runtime import resolve_device


def _copy(param, array):
    src = torch.from_numpy(np.array(array, dtype=np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(src.shape)} != parameter "
                         f"{tuple(param.shape)}")
    param.data.copy_(src.to(param.dtype))


def params_from_numpy(tree: dict, cfg, *, device=None) -> Transformer:
    dev = resolve_device(device)
    model = Transformer(cfg, torch.Generator(device=dev), dev)
    layers = tree["layers"]
    n = next(iter(layers["ln_attn"].values())).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, cfg {cfg.n_layers}")
    for i, blk in enumerate(model.layers):
        for group, sub in layers.items():
            mod = getattr(blk, group)
            for name, arr in sub.items():
                _copy(getattr(mod, name), arr[i])
    for name, arr in tree["ln_f"].items():
        _copy(getattr(model.ln_f, name), arr)
    _copy(model.embed, tree["embed"])
    return model
