"""Model API of the port (the ``repro/models/api.py`` subset ported so
far): init_params / loss_fn / forward / prefill (with an optional
shared-prefix history) / prefill_chunk / init_cache / decode_step /
init_paged_cache / prefill_chunk_paged / decode_step_paged. ``loss_fn``
covers the dense family; the others raise, naming ROADMAP A13.

One family dispatch (``_mod``, the reference's ``api.py:24-30``) picks
the module: ``models.ssm`` for the ssm family, ``models.hybrid`` for the
hybrid one, ``models.transformer`` for the dense and MoE ones. The ssm family has
no KV cache, so it refuses what needs one, with the reference's
``ValueError``s (``api.py:119-124, 139-140, 175, 189-190``): no
shared-prefix history, no paged cache or paged step, no all-lanes chunk
scoring. The hybrid family takes the paged cache (its ring pools; the
paged cache then needs ``batch_size`` for the recurrent rows), the paged
step and the paged chunk, but no history and no all-lanes scoring.

Every entry runs on the card unless the caller passes ``device="cpu"``;
with no card and no explicit device they raise. Inputs may be numpy
arrays or tensors; they are placed on the resolved device. The params
must already live there.
"""

from __future__ import annotations

import torch

from repro_torch.runtime import resolve_device, resolve_policy
from . import hybrid, ssm, transformer


def _mod(cfg):
    """The module implementing ``cfg``'s family."""
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return hybrid
    return transformer


def _check_params(params, dev: torch.device):
    pdev = params.embed.device
    if pdev.type != dev.type:
        raise ValueError(f"params live on {pdev}, the call asked for {dev}")


def _policy(cfg, policy):
    return policy if policy is not None else resolve_policy(cfg)


def _no_training(cfg):
    """Families whose loss is not ported raise, naming the ROADMAP item."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family's training (its loss "
            f"and trainable parameters) is not ported yet (ROADMAP.md, A13)")


def init_params(cfg, seed: int = 0, *, device=None, trainable=False):
    """Random weights from ``torch.Generator(device).manual_seed(seed)``;
    with ``trainable``, f32 masters that take gradients (dense and MoE
    families)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    if trainable:
        _no_training(cfg)
        return transformer.init_params(cfg, g, dev, trainable=True)
    return _mod(cfg).init_params(cfg, g, dev)


def loss_fn(params, cfg, batch, *, policy=None, device=None):
    """Training loss of ``batch`` {"tokens", "labels", optional "mask"}
    (reference ``api.py:41-43``): mean nats a token, a 0-d f32 tensor
    that autograd differentiates into ``params``. The ssm and hybrid
    families, and the MoE one, raise (ROADMAP.md, A13)."""
    _no_training(cfg)
    dev = resolve_device(device)
    _check_params(params, dev)
    b = {k: torch.as_tensor(batch[k], device=dev)
         for k in ("tokens", "labels", "mask") if batch.get(k) is not None}
    return transformer.loss_fn(params, cfg, b, policy=_policy(cfg, policy))


def forward(params, cfg, batch, *, policy=None, device=None):
    """Final normed hidden states (B, S, D) of ``batch["tokens"]``."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return _mod(cfg).forward(params, cfg,
                             torch.as_tensor(batch["tokens"], device=dev),
                             policy=_policy(cfg, policy))


def prefill(params, cfg, batch, *, policy=None, device=None):
    """Prompt forward -> (last_logits (B, 1, V), cache). The optional
    ``batch["prompt_len"]`` (B,) marks ragged right-padded prompts; the
    optional ``batch["hist"]`` {"k", "v"} (L, B, h, Hkv, hd) is a
    shared-prefix KV history the tokens continue (suffix prefill)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    plen = batch.get("prompt_len")
    hist = batch.get("hist")
    kw = {}
    if hist is not None:
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"{cfg.family} family has no KV history to "
                             f"continue")
        kw["hist"] = {k: torch.as_tensor(v, device=dev)
                      for k, v in hist.items()}
    return _mod(cfg).prefill(
        params, cfg, torch.as_tensor(batch["tokens"], device=dev),
        prompt_len=None if plen is None else torch.as_tensor(plen,
                                                             device=dev),
        policy=_policy(cfg, policy), **kw)


def prefill_chunk(params, cfg, tokens, cache, off, clens, *, policy=None,
                  all_lanes=False, device=None):
    """Resumable chunked prefill over a contiguous pool ``cache``: every
    row advances by its ``clens[b]`` tokens of the (B, C) ``tokens`` at
    its cursor ``off[b]`` (0 tokens: the row's cache stays bit for bit).
    The cache is written in place and returned with the (B, 1, V) logits
    of each row's last valid lane, or with ``all_lanes`` (the speculative
    verify) the (B, C, V) logits of every lane. The ssm family carries
    (h, conv) across chunks in place, ignores ``off`` and has no
    all-lanes scoring."""
    dev = resolve_device(device)
    _check_params(params, dev)
    if all_lanes and cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"{cfg.family} family has no all-lanes chunk "
                         f"scoring")
    return _mod(cfg).prefill_chunk(
        params, cfg, torch.as_tensor(tokens, device=dev), cache,
        torch.as_tensor(off, device=dev), torch.as_tensor(clens, device=dev),
        policy=_policy(cfg, policy), **({"all_lanes": True} if all_lanes
                                        else {}))


def prefill_chunk_paged(params, cfg, tokens, cache, tables, off, clens, *,
                        policy=None, all_lanes=False, device=None):
    """``prefill_chunk`` over a paged pool through the (B, nS) block
    ``tables``; the pool is written in place and returned with the
    logits (every lane's with ``all_lanes``)."""
    if cfg.family == "ssm":
        raise ValueError("ssm family has no paged chunked prefill")
    if all_lanes and cfg.family == "hybrid":
        raise ValueError("hybrid family has no all-lanes chunk scoring")
    dev = resolve_device(device)
    _check_params(params, dev)
    return _mod(cfg).prefill_chunk_paged(
        params, cfg, torch.as_tensor(tokens, device=dev), cache,
        torch.as_tensor(tables, device=dev), torch.as_tensor(off, device=dev),
        torch.as_tensor(clens, device=dev), policy=_policy(cfg, policy),
        **({"all_lanes": True} if all_lanes else {}))


def init_cache(cfg, batch_size, seq_len, *, device=None):
    """The decode state of ``batch_size`` rows: a KV cache of
    ``seq_len`` positions, or the ssm family's (h, conv), whose size does
    not depend on ``seq_len``."""
    return _mod(cfg).init_cache(cfg, batch_size, seq_len,
                                resolve_device(device))


def decode_step(params, cfg, token, cache, pos, *, policy=None, live=None,
                device=None):
    """One decode step; ``pos`` scalar or (B,); the cache is updated in
    place and returned with the logits."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return _mod(cfg).decode_step(
        params, cfg, torch.as_tensor(token, device=dev), cache,
        torch.as_tensor(pos, device=dev), policy=_policy(cfg, policy),
        live=None if live is None else torch.as_tensor(live, device=dev))


def init_paged_cache(cfg, n_pages, page, *, batch_size=None, device=None):
    """A paged pool of ``n_pages`` pages of ``page`` positions: the dense
    family's KV pools, or the hybrid's ring pools beside the recurrent
    rows of ``batch_size`` slots."""
    if cfg.family == "ssm":
        raise ValueError("recurrent state is O(1) per slot; nothing to "
                         "page")
    if cfg.family == "hybrid":
        if batch_size is None:
            raise ValueError("the hybrid's paged state needs batch_size "
                             "for its recurrent rows")
        return hybrid.init_paged_cache(cfg, batch_size, n_pages, page,
                                       resolve_device(device))
    return transformer.init_paged_cache(cfg, n_pages, page,
                                        resolve_device(device))


def decode_step_paged(params, cfg, token, cache, tables, pos, *,
                      policy=None, live=None, device=None):
    """One decode step over a paged pool through the (B, nS) block
    ``tables``; the pool is updated in place and returned with the
    logits."""
    if cfg.family == "ssm":
        raise ValueError("ssm family has no paged decode step")
    dev = resolve_device(device)
    _check_params(params, dev)
    return _mod(cfg).decode_step_paged(
        params, cfg, torch.as_tensor(token, device=dev), cache,
        torch.as_tensor(tables, device=dev), torch.as_tensor(pos, device=dev),
        policy=_policy(cfg, policy),
        live=None if live is None else torch.as_tensor(live, device=dev))
