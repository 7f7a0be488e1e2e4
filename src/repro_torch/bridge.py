"""Carry the JAX package's parameters into the port, and back.

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

The way back: ``params_to_numpy(model)`` (numpy) and ``params_to_tree``
/ ``opt_state_to_tree`` (tensors, for checkpoints) give the reference's
tree, layers stacked on axis 0 under the reference's leaf names;
``opt_state_from_tree`` reads an optimizer state back onto a model's
parameter names. A trainable model (``trainable=True``) holds every
value as an f32 master, unrounded.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import hybrid, ssm
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import resolve_device


def _copy(param, array, via=None):
    """``param`` <- ``array`` (numpy or a tensor), rounded through dtype
    ``via`` first."""
    src = (array.detach().to("cpu", torch.float32)
           if isinstance(array, torch.Tensor)
           else torch.from_numpy(np.array(array, dtype=np.float32)))
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


def params_from_numpy(tree: dict, cfg, *, device=None, trainable=False):
    """The port's model of ``cfg`` holding ``tree``'s values (leaves numpy
    arrays or tensors). ``trainable`` (dense and MoE families): f32
    masters that take gradients, every value carried unrounded."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    if trainable and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family's training is not "
            f"ported yet (ROADMAP.md, A13)")
    if cfg.family == "hybrid":
        model = hybrid.Hybrid(cfg, g, dev)
        _copy_hybrid(model, tree, cfg)
    else:
        model = (ssm.SSM(cfg, g, dev) if cfg.family == "ssm"
                 else Transformer(cfg, g, dev, trainable=trainable))
        _copy_layers(model, tree["layers"], cfg)
    for name, arr in tree["ln_f"].items():
        _copy(getattr(model.ln_f, name), arr)
    _copy(model.embed, tree["embed"])
    if not cfg.tie_embeddings:
        _copy(model.unembed, tree["unembed"])
    return model


def _split(name: str):
    """A parameter's dotted name -> (tree path, stacking indices): the
    module-list indices ("layers.3.attn.wq" -> ("layers", "attn", "wq"),
    (3,)) are the reference's stacking axes, outermost first."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def named_to_tree(named: dict) -> dict:
    """Tensors keyed by parameter name (``model.named_parameters()``, or
    an optimizer moment) -> the reference's tree: nested dicts by leaf
    name, each module list stacked on a leading axis (two for the
    hybrid's period recurrences). Dtypes and devices are kept."""
    groups: dict = {}
    for name, t in named.items():
        path, idx = _split(name)
        groups.setdefault(path, {})[idx] = t.detach()
    tree: dict = {}
    for path, parts in groups.items():
        def stack(prefix):
            if len(prefix) == len(next(iter(parts))):
                return parts[prefix]
            n = 1 + max(i[len(prefix)] for i in parts)
            return torch.stack([stack(prefix + (j,)) for j in range(n)])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack(())
    return tree


def tree_to_named(tree: dict, names) -> dict:
    """``named_to_tree``'s inverse for the parameter ``names`` of a model:
    each name's slice of its stacked leaf."""
    out = {}
    for name in names:
        path, idx = _split(name)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = torch.as_tensor(leaf)[idx] if idx else \
            torch.as_tensor(leaf)
    return out


def params_to_tree(model) -> dict:
    """The model's parameters as the reference's tree (tensors, on the
    model's device, in the dtypes held)."""
    return named_to_tree(dict(model.named_parameters()))


def params_to_numpy(model) -> dict:
    """``params_from_numpy``'s inverse: the reference's tree of numpy
    arrays, layers stacked on axis 0, the reference's leaf names. A
    trainable model's leaves are f32, the reference's ``param_dtype``; a
    serving model's bf16 leaves come back widened to f32, which holds
    their values exactly (numpy has no bf16)."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if node.dtype == torch.bfloat16:
            node = node.float()
        return node.cpu().numpy()
    return host(params_to_tree(model))


def opt_state_to_tree(state: dict) -> dict:
    """An optimizer state ``{"m", "v", "step"}`` (``optim.adamw``, the
    moments keyed by parameter name) as the reference's ``{"m": tree,
    "v": tree, "step"}``."""
    return {"m": named_to_tree(state["m"]), "v": named_to_tree(state["v"]),
            "step": state["step"]}


def opt_state_from_tree(tree: dict, model) -> dict:
    """``opt_state_to_tree``'s inverse for ``model``'s parameters, on the
    model's device, moments in the dtype the tree holds."""
    dev = model.embed.device
    names = [n for n, _ in model.named_parameters()]

    def moments(t):
        return {n: v.to(dev) for n, v in tree_to_named(t, names).items()}

    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": torch.as_tensor(tree["step"]).to(dev, torch.int32)}
