"""Model API of the port (the ``repro/models/api.py`` subset ported so
far): init_params / forward / prefill (with an optional shared-prefix
history) / prefill_chunk / init_cache / decode_step / init_paged_cache /
prefill_chunk_paged / decode_step_paged.

Every entry runs on the card unless the caller passes ``device="cpu"``;
with no card and no explicit device they raise. Inputs may be numpy
arrays or tensors; they are placed on the resolved device. The params
must already live there.
"""

from __future__ import annotations

import torch

from repro_torch.runtime import resolve_device, resolve_policy
from . import transformer


def _check_params(params, dev: torch.device):
    pdev = params.embed.device
    if pdev.type != dev.type:
        raise ValueError(f"params live on {pdev}, the call asked for {dev}")


def _policy(cfg, policy):
    return policy if policy is not None else resolve_policy(cfg)


def init_params(cfg, seed: int = 0, *, device=None):
    """Random weights from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return transformer.init_params(cfg, g, dev)


def forward(params, cfg, batch, *, policy=None, device=None):
    """Final normed hidden states (B, S, D) of ``batch["tokens"]``."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return transformer.forward(params, cfg,
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
    return transformer.prefill(
        params, cfg, torch.as_tensor(batch["tokens"], device=dev),
        prompt_len=None if plen is None else torch.as_tensor(plen,
                                                             device=dev),
        policy=_policy(cfg, policy),
        hist=None if hist is None else {k: torch.as_tensor(v, device=dev)
                                        for k, v in hist.items()})


def prefill_chunk(params, cfg, tokens, cache, off, clens, *, policy=None,
                  all_lanes=False, device=None):
    """Resumable chunked prefill over a contiguous pool ``cache``: every
    row advances by its ``clens[b]`` tokens of the (B, C) ``tokens`` at
    its cursor ``off[b]`` (0 tokens: the row's cache stays bit for bit).
    The cache is written in place and returned with the (B, 1, V) logits
    of each row's last valid lane, or with ``all_lanes`` (the speculative
    verify) the (B, C, V) logits of every lane."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return transformer.prefill_chunk(
        params, cfg, torch.as_tensor(tokens, device=dev), cache,
        torch.as_tensor(off, device=dev), torch.as_tensor(clens, device=dev),
        policy=_policy(cfg, policy), all_lanes=all_lanes)


def prefill_chunk_paged(params, cfg, tokens, cache, tables, off, clens, *,
                        policy=None, all_lanes=False, device=None):
    """``prefill_chunk`` over a paged pool through the (B, nS) block
    ``tables``; the pool is written in place and returned with the
    logits (every lane's with ``all_lanes``)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return transformer.prefill_chunk_paged(
        params, cfg, torch.as_tensor(tokens, device=dev), cache,
        torch.as_tensor(tables, device=dev), torch.as_tensor(off, device=dev),
        torch.as_tensor(clens, device=dev), policy=_policy(cfg, policy),
        all_lanes=all_lanes)


def init_cache(cfg, batch_size, seq_len, *, device=None):
    return transformer.init_cache(cfg, batch_size, seq_len,
                                  resolve_device(device))


def decode_step(params, cfg, token, cache, pos, *, policy=None, live=None,
                device=None):
    """One decode step; ``pos`` scalar or (B,); the cache is updated in
    place and returned with the logits."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return transformer.decode_step(
        params, cfg, torch.as_tensor(token, device=dev), cache,
        torch.as_tensor(pos, device=dev), policy=_policy(cfg, policy),
        live=None if live is None else torch.as_tensor(live, device=dev))


def init_paged_cache(cfg, n_pages, page, *, device=None):
    return transformer.init_paged_cache(cfg, n_pages, page,
                                        resolve_device(device))


def decode_step_paged(params, cfg, token, cache, tables, pos, *,
                      policy=None, live=None, device=None):
    """One decode step over a paged pool through the (B, nS) block
    ``tables``; the pool is updated in place and returned with the
    logits."""
    dev = resolve_device(device)
    _check_params(params, dev)
    return transformer.decode_step_paged(
        params, cfg, torch.as_tensor(token, device=dev), cache,
        torch.as_tensor(tables, device=dev), torch.as_tensor(pos, device=dev),
        policy=_policy(cfg, policy),
        live=None if live is None else torch.as_tensor(live, device=dev))
