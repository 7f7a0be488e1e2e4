"""Decoder transformer (port of ``repro/models/transformer.py``, the
dense and MoE paths): parameters as ``nn.Module``s, prefill and decode as
plain functions over them. A MoE block (``cfg.n_experts`` > 0) holds a
``moe.MoE`` where a dense block holds its ``MLP``; that one branch, in
``_finish_block``, covers forward, prefill, chunks and decode.

Parameter layout and dtypes follow the reference: matmul weights are
(d_in, d_out); per layer, a serving model holds 2-D weights in the
compute dtype (the reference casts each layer's 2-D f32 params to bf16
as it enters the scan; casting once at load gives the same values), a
trainable one (``trainable=True``, ``loss_fn``) holds f32 masters and
casts them inside ``forward``; 1-D params stay f32; the
embedding stays f32 and lookups are cast to the compute dtype afterwards;
logits are an f32 matmul against ``embed.T`` (tied embeddings) or the
f32 ``unembed`` (d_model, vocab_padded) (untied). The MLP is GELU or
SwiGLU (``layers.mlp_apply``; the SwiGLU gate's exp takes the policy's
exponential, on the card one launch of the vexp kernel a layer).

The KV cache is a dict {"k", "v"} of stacked (L, B, S, Hkv, hd) ("bshd")
or (L, B, Hkv, S, hd) ("bhsd") bf16 tensors. A config with a
``sliding_window`` (h2o-danube3-4b) attends over the last ``window``
positions and keeps a ring of min(seq, window) rows: position p at slot
p % window, written by decode at that slot, each step sweeping the
ring's min(pos + 1, window) slots in slot order with no window mask
(reference ``transformer.py:402-412``, ``:633-660``, ``:741-751``); a
paged pool holds the ring behind a table of ceil(window / page) pages,
indexed by ``(pos % window) // page`` (``:835-845``). ``decode_step``
writes the cache in place (the reference donates it through a jitted
step instead), and the
decode steps read only device tensors (positions, live mask, tables) and
copy nothing from the host, so one CUDA graph can hold a whole step
(``runtime.graphs.StepGraph``). The paged
pool (``init_paged_cache``) stacks pages instead of slots; per-row block
tables map each row's logical pages to pool pages, and
``decode_step_paged`` writes it in place through them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.analysis.registry import hot_path
from repro_torch.core.attention import attention, decode_attention
from repro_torch.kernels.dispatch import dispatch
from .layers import (apply_rope, cross_entropy, mask_padded_logits,
                     mlp_apply, norm_apply)
from .moe import MoE, moe_apply


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _opt(module: nn.Module, name: str, t):
    if t is None:
        module.register_parameter(name, None)
    else:
        setattr(module, name, _param(t))


class Norm(nn.Module):
    def __init__(self, d, kind, device):
        super().__init__()
        self.w = _param(torch.ones(d, device=device))
        _opt(self, "b", torch.zeros(d, device=device)
             if kind == "layernorm" else None)


def _dense(g, d_in, d_out, dtype, device):
    return (torch.randn(d_in, d_out, generator=g, device=device)
            * (1.0 / math.sqrt(d_in))).to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param(_dense(g, d, h * hd, dtype, device))
        self.wk = _param(_dense(g, d, hkv * hd, dtype, device))
        self.wv = _param(_dense(g, d, hkv * hd, dtype, device))
        self.wo = _param(_dense(g, h * hd, d, dtype, device))
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            _opt(self, name, torch.zeros(n, device=device)
                 if cfg.use_bias else None)


class MLP(nn.Module):
    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        if cfg.act == "swiglu":
            self.wg = _param(_dense(g, cfg.d_model, cfg.d_ff, dtype, device))
        self.wu = _param(_dense(g, cfg.d_model, cfg.d_ff, dtype, device))
        self.wd = _param(_dense(g, cfg.d_ff, cfg.d_model, dtype, device))
        _opt(self, "bu", torch.zeros(cfg.d_ff, device=device)
             if cfg.use_bias else None)
        _opt(self, "bd", torch.zeros(cfg.d_model, device=device)
             if cfg.use_bias else None)


class Block(nn.Module):
    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        self.ln_attn = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg, g, dtype, device)
        self.ln_mlp = Norm(cfg.d_model, cfg.norm, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, g, dtype, device)
        else:
            self.mlp = MLP(cfg, g, dtype, device)


class Transformer(nn.Module):
    """Parameter container; the computations are the functions below.

    ``trainable``: every parameter an f32 master with ``requires_grad``
    (the reference's ``param_dtype``), the layers' 2-D weights cast to
    the compute dtype inside ``forward`` as the reference casts them
    (``transformer.py:366``); else (serving) frozen, with those weights
    held in the compute dtype."""

    def __init__(self, cfg, g: torch.Generator, device, *, trainable=False):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"{cfg.arch_id}: family {cfg.family!r} (parallel blocks, "
                f"modality inputs, the logit softcap) is not ported yet; "
                f"only dense and MoE decoders are")
        dtype = (torch.float32 if trainable
                 else getattr(torch, cfg.compute_dtype))
        self.layers = nn.ModuleList(
            [Block(cfg, g, dtype, device) for _ in range(cfg.n_layers)])
        self.ln_f = Norm(cfg.d_model, cfg.norm, device)
        self.embed = _param(torch.randn(cfg.vocab_padded, cfg.d_model,
                                        generator=g, device=device) * 0.02)
        if not cfg.tie_embeddings:
            self.unembed = _param(_dense(g, cfg.d_model, cfg.vocab_padded,
                                         torch.float32, device))
        if trainable:
            self.requires_grad_(True)


def init_params(cfg, g: torch.Generator, device, *,
                trainable=False) -> Transformer:
    """Random weights with the reference's layout and scales (dense
    N(0,1)/sqrt(d_in), a MoE layer's router and each expert's FFN the
    same, the experts stacked on a leading E axis, embedding N(0,1)*0.02,
    an untied unembedding N(0,1)/sqrt(d_model) in f32, zero biases, unit
    norms), drawn from ``g`` on ``device``; f32 masters with
    ``trainable``."""
    return Transformer(cfg, g, device, trainable=trainable)


class _Cast:
    """A layer's parameters as its forward reads them: f32 weights of
    two or more dims in the compute dtype, the rest as held (the
    reference's cast at ``transformer.py:366``)."""

    def __init__(self, mod: nn.Module, dtype):
        for name, t in mod._parameters.items():
            if t is not None and t.dtype == torch.float32 and t.dim() > 1:
                t = t.to(dtype)
            setattr(self, name, t)
        for name, sub in mod._modules.items():
            setattr(self, name, _Cast(sub, dtype))


def _compute_layer(blk, cfg):
    """``blk`` itself when its weights are already in the compute dtype
    (a serving model), else its ``_Cast``."""
    dtype = getattr(torch, cfg.compute_dtype)
    if blk.attn.wq.dtype == dtype:
        return blk
    return _Cast(blk, dtype)


# ------------------------------------------------------------ attention

def _qkv(x, p, cfg, pos):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.rope_pct > 0:
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def _finish_block(x, a, blk, cfg, policy):
    x = x + a
    h = norm_apply(x, blk.ln_mlp, cfg.norm, cfg.norm_eps)
    if cfg.n_experts:
        return x + moe_apply(h, blk.moe, cfg, policy=policy)
    return x + mlp_apply(h, blk.mlp, cfg.act, policy=policy)


def embed_inputs(params, cfg, tokens):
    """tokens (B, S) int -> (B, S, D) in the compute dtype. The lookup
    is ``F.embedding``, whose gradient on the card sums each row's
    tokens in a fixed order (no atomics), so a train step is
    deterministic."""
    return F.embedding(tokens, params.embed).to(
        getattr(torch, cfg.compute_dtype))


def forward(params, cfg, tokens, *, policy):
    """Full-sequence forward to the final normed hidden states (B, S, D).
    Differentiable: a trainable model's layers are cast as they enter
    (``_compute_layer``), and attention keeps the gradient (the cuda
    tier through the kernel's recompute backward)."""
    x = embed_inputs(params, cfg, tokens)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    for blk in params.layers:
        blk = _compute_layer(blk, cfg)
        h = norm_apply(x, blk.ln_attn, cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(h, blk.attn, cfg, pos)
        o = attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                      policy=policy)
        x = _finish_block(x, o.flatten(2) @ blk.attn.wo, blk, cfg, policy)
    return norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)


def unembed_matrix(params, cfg):
    """(d_model, vocab_padded) f32: the tied embedding's transpose, or
    the untied ``unembed`` (reference ``transformer.py:333-335``)."""
    return params.embed.T if cfg.tie_embeddings else params.unembed


def loss_fn(params, cfg, batch, *, policy):
    """Training loss, mean nats a token (reference ``transformer.py:
    384-398``): ``forward``, then the chunked ``cross_entropy`` against
    ``unembed_matrix`` over ``batch["labels"]`` with the optional
    ``batch["mask"]`` (B, S) bool. The MoE family raises: its aux and z
    losses are not carried yet."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.arch_id}: the MoE loss (the router's aux and z losses, "
            f"router_aux_coef) is not ported yet (ROADMAP.md, A13)")
    x = forward(params, cfg, batch["tokens"], policy=policy)
    return cross_entropy(x, unembed_matrix(params, cfg), batch["labels"],
                         chunk=cfg.loss_chunk, mask=batch.get("mask"),
                         policy=policy)


def _logits(params, cfg, x):
    """f32 logits against the unembedding, padded vocab masked."""
    return mask_padded_logits(x.float() @ unembed_matrix(params, cfg),
                              cfg.vocab)


def init_cache(cfg, batch, seq_len, device):
    """Stacked KV cache of ``seq_len`` rows, or a ring of min(seq_len,
    window) rows for a windowed config."""
    w = cfg.sliding_window
    s = min(seq_len, w) if w else seq_len
    if cfg.kv_cache_layout == "bhsd":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.hd)
    else:
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def cache_seq_axis(layout: str, stacked: bool = True) -> int:
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown kv cache layout {layout!r}")
    return (1 if layout == "bshd" else 2) + (1 if stacked else 0)


def state_axes(cfg):
    """Leaf metadata of the KV cache: slot axis 1, sequence axis after it
    (``bshd``) or after the heads (``bhsd``)."""
    from .state_spec import LeafAxes
    seq = cache_seq_axis(cfg.kv_cache_layout)
    return {"k": LeafAxes(1, seq), "v": LeafAxes(1, seq)}


def _ring_len(cfg, pos):
    """Keys in a slot's ring at position ``pos`` (its token written):
    min(pos + 1, window), or pos + 1 without a window."""
    w = cfg.sliding_window
    return torch.clamp(pos + 1, max=w) if w else pos + 1


def _ring_pos(cfg, pos):
    """The slot position ``pos`` is written at: pos % window, or pos."""
    w = cfg.sliding_window
    return torch.remainder(pos, w) if w else pos


def _ring_rows(kv, w):
    """A prefill's (B, S, ...) K or V as the cache keeps it: all S rows
    where S <= ``w`` (or no window), else the last ``w`` rolled into ring
    order, position p at slot p % w (reference ``transformer.py:473-478``)."""
    s = kv.shape[1]
    if w and s > w:
        return torch.roll(kv[:, s - w:], s % w, dims=1)
    return kv


def prefill(params, cfg, tokens, *, prompt_len=None, policy, hist=None):
    """Forward over the prompt; returns (last_logits (B, 1, V), cache).

    ``prompt_len`` (B,) marks ragged right-padded rows: padding keys are
    masked out of attention (the kernel takes them as per-row key
    lengths), pad K/V rows are zeroed, and logits come from each row's
    last real token. A windowed config attends over the last ``window``
    positions and returns its ring (``_ring_rows``); a ragged prefill
    wider than the window raises, as the ring's roll is batch-uniform.

    ``hist`` {"k", "v"}: (L, B, h, Hkv, hd) bf16 ("bshd" whatever the
    cache layout) is a shared-prefix KV history already in the page pool.
    ``tokens`` are then each row's suffix at absolute positions h + i,
    attending over [history | suffix] through attention's ``q_offset=h``
    with ``kv_len = h + prompt_len``; ``prompt_len`` counts suffix tokens,
    and the returned cache and logits cover the suffix only. Linear caches
    only: a ring has no history split."""
    w = cfg.sliding_window
    if hist is not None and w:
        raise ValueError("history-conditioned prefill needs a linear "
                         "(non-windowed) cache")
    x = embed_inputs(params, cfg, tokens)
    b, s, _ = x.shape
    if prompt_len is not None and w and s > w:
        raise ValueError(
            f"ragged prefill of {s} tokens exceeds the sliding window "
            f"({w}): the ring-buffer roll is batch-uniform; prefill ragged "
            f"windowed batches at <= window")
    h0 = 0 if hist is None else hist["k"].shape[2]
    pos = torch.arange(s, device=x.device)[None, :] + h0
    kv_len = valid = None
    if prompt_len is not None:
        plen = torch.as_tensor(prompt_len, device=x.device).to(
            torch.int32).reshape(-1)
        valid = (pos - h0 < plen[:, None])[:, :, None, None]    # (B,S,1,1)
        kv_len = plen + h0
    ks, vs = [], []
    for i, blk in enumerate(params.layers):
        h = norm_apply(x, blk.ln_attn, cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(h, blk.attn, cfg, pos)
        if hist is None:
            o = attention(q, k, v, causal=cfg.causal, window=w,
                          kv_len=kv_len, policy=policy)
        else:
            kc = torch.cat([hist["k"][i].to(k.dtype), k], dim=1)
            vc = torch.cat([hist["v"][i].to(v.dtype), v], dim=1)
            o = attention(q, kc, vc, causal=True, kv_len=kv_len,
                          q_offset=h0, policy=policy)
        x = _finish_block(x, o.flatten(2) @ blk.attn.wo, blk, cfg, policy)
        if valid is not None:
            k = torch.where(valid, k, 0)
            v = torch.where(valid, v, 0)
        k, v = _ring_rows(k, w), _ring_rows(v, w)
        if cfg.kv_cache_layout == "bhsd":
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    if prompt_len is None:
        xl = x[:, -1:]
    else:
        idx = torch.clamp(plen.long() - 1, 0, s - 1)
        xl = x[torch.arange(b, device=x.device), idx][:, None]
    return _logits(params, cfg, xl), {"k": torch.stack(ks),
                                      "v": torch.stack(vs)}


# ------------------------------------------------------------ chunked prefill

def _chunk_lanes(off, clens, c, device):
    """(positions (B, C), valid lanes (B, C), cursors (B,), key lengths
    (B,)) of a chunk whose row b holds ``clens[b]`` tokens at positions
    ``off[b]`` on."""
    off = torch.as_tensor(off, device=device).to(torch.int32).reshape(-1)
    clens = torch.as_tensor(clens, device=device).to(torch.int32).reshape(-1)
    lane = torch.arange(c, device=device, dtype=torch.int32)[None, :]
    return off[:, None] + lane, lane < clens[:, None], off, off + clens


def _write_chunk_kv(cache, kv, pos, ok, layout):
    """Write a C-token chunk's K (or V) in place: kv (B, C, Hkv, hd) at
    positions ``pos`` (B, C), only where ``ok`` (B, C). One layer's
    (B, S, Hkv, hd) ("bshd") / (B, Hkv, S, hd) ("bhsd") cache. Lanes that
    must not write put the old value back, as ``_write_token_kv`` does,
    at ``pos % S``: a row's lanes then land on distinct rows (C <= S, and
    a lane past S wraps below the row's cursor, which its valid lanes
    never reach), so no write races another lane's."""
    b, c = pos.shape
    s = cache.shape[cache_seq_axis(layout, stacked=False)]
    rows = torch.arange(b, device=cache.device)[:, None]
    p = torch.remainder(pos, s).long()
    new = kv.to(cache.dtype)
    keep = ok[:, :, None, None]
    if layout == "bhsd":
        old = cache[rows, :, p]                         # (B, C, Hkv, hd)
        cache[rows, :, p] = torch.where(keep, new, old)
    else:
        old = cache[rows, p]
        cache[rows, p] = torch.where(keep, new, old)


def _chunk_logits(params, cfg, x, clens):
    """(B, 1, V) logits of each row's last valid lane."""
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    b, c, _ = x.shape
    idx = torch.clamp(clens.long() - 1, 0, c - 1)
    xl = x[torch.arange(b, device=x.device), idx][:, None]
    return _logits(params, cfg, xl)


def _chunk_all_logits(params, cfg, x):
    """(B, C, V) logits of every lane (port of the reference's
    ``_chunk_all_logits``, ``transformer.py:566``): the speculative
    verify scores all of a burst's candidates from one chunk pass. Lanes
    at or past a row's valid count are garbage the caller masks."""
    return _final_logits(params, cfg, x)


def _chunk_layers(params, cfg, tokens, lanes, layer_attn, all_lanes=False,
                  *, policy):
    """The chunk program's layer loop over ``lanes`` (``_chunk_lanes``):
    ``layer_attn(i, q, k, v)`` lands the chunk's K/V in layer i's cache
    and returns its attention output (B, C, H, hd). Returns the
    last-valid-lane logits (B, 1, V), or with ``all_lanes`` every lane's
    (B, C, V)."""
    pos, _, off, kv_len = lanes
    x = embed_inputs(params, cfg, tokens)
    for i, blk in enumerate(params.layers):
        h = norm_apply(x, blk.ln_attn, cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(h, blk.attn, cfg, pos)
        o = layer_attn(i, q, k, v)
        x = _finish_block(x, o.flatten(2) @ blk.attn.wo, blk, cfg, policy)
    if all_lanes:
        return _chunk_all_logits(params, cfg, x)
    return _chunk_logits(params, cfg, x, kv_len - off)


@hot_path
def prefill_chunk(params, cfg, tokens, cache, off, clens, *, policy,
                  all_lanes=False):
    """Resumable prefill (port of the reference's ``prefill_chunk``,
    ``transformer.py:579``): advance every row of the pool's contiguous
    ``cache`` by one chunk, written in place.

    tokens (B, C) int; off (B,) each row's cursor (tokens already
    cached); clens (B,) valid tokens this chunk, 0 for rows that are not
    prefilling (decoding or free slots), whose cache rows stay bit for
    bit. The chunk's K/V land at positions off .. off + clens - 1, then
    its queries attend causally over the updated cache (the cached
    prefix and the chunk's own keys) with ``q_offset=off`` and ``kv_len =
    off + clens``: on the ``cuda`` tier one FlashAttention launch per
    layer with a (B,) offset tensor. Returns (logits (B, 1, V) at each
    row's last valid lane, meaningful where the prompt completes with
    this chunk, and the cache). ``all_lanes=True`` (the speculative
    verify) returns (B, C, V) logits of every lane instead; lanes at or
    past a row's ``clens`` are garbage the caller masks. A windowed
    config's queries are window-masked; its prompts fit the ring, so a
    chunk's positions are its slots."""
    lay = cfg.kv_cache_layout
    lanes = _chunk_lanes(off, clens, tokens.shape[1], tokens.device)
    pos, ok, off, kv_len = lanes

    def layer_attn(i, q, k, v):
        ck, cv = cache["k"][i], cache["v"][i]
        _write_chunk_kv(ck, k, pos, ok, lay)
        _write_chunk_kv(cv, v, pos, ok, lay)
        if lay == "bhsd":
            ck, cv = ck.transpose(1, 2), cv.transpose(1, 2)
        return attention(q, ck, cv, causal=True, window=cfg.sliding_window,
                         kv_len=kv_len, q_offset=off, policy=policy)

    return _chunk_layers(params, cfg, tokens, lanes, layer_attn,
                         all_lanes, policy=policy), cache


def _write_token_kv(cache, kv, pos, ok, layout, offset=0):
    """Write one token's K (or V) per row in place: kv (B, 1, Hkv, hd) at
    global position ``pos[b]``, only where ``ok[b]`` and the position
    lies in this cache, whose first row is global position ``offset`` (a
    rank's slice of a sequence-sharded cache; 0 for a whole cache). Rows
    that must not write (parked slots, positions past or before the
    cache) write their old value back at a clamped row. The clamp comes
    before any indexing, so a position below the slice never wraps round
    to its end as a negative index would; nothing is out of range and no
    host sync is needed."""
    b = kv.shape[0]
    s = cache.shape[cache_seq_axis(layout, stacked=False)]
    rows = torch.arange(b, device=cache.device)
    lp = pos - offset
    ok = ok & (lp >= 0) & (lp < s)
    p = torch.clamp(lp, 0, s - 1)
    new = kv[:, 0].to(cache.dtype)                          # (B, Hkv, hd)
    if layout == "bhsd":
        old = cache[rows, :, p]
        cache[rows, :, p] = torch.where(ok[:, None, None], new, old)
    else:
        old = cache[rows, p]
        cache[rows, p] = torch.where(ok[:, None, None], new, old)


def _decode_layers(params, cfg, token, pos, layer_attn, *, policy):
    """The decode step's layer loop: ``layer_attn(i, q, k, v)`` lands the
    token's K/V in layer i's cache and returns its attention output
    (B, 1, H, hd); everything else is the same for every cache form.
    Returns the (B, 1, V) logits."""
    x = embed_inputs(params, cfg, torch.clamp(token, min=0))
    for i, blk in enumerate(params.layers):
        h = norm_apply(x, blk.ln_attn, cfg.norm, cfg.norm_eps)
        q, k, v = _qkv(h, blk.attn, cfg, pos[:, None])
        o = layer_attn(i, q, k, v)
        x = _finish_block(x, o.flatten(2) @ blk.attn.wo, blk, cfg, policy)
    return _final_logits(params, cfg, x)


def _positions(pos, b, device):
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    return torch.broadcast_to(pos.reshape(-1), (b,))


def _live(live, b, device):
    ok = torch.ones(b, dtype=torch.bool, device=device)
    return ok if live is None else ok & (live > 0)


@hot_path
def decode_step(params, cfg, token, cache, pos, *, policy, live=None):
    """One decode step. token (B, 1) int; pos (B,) int, each row's token
    position; ``cache`` is updated in place and returned with the
    (B, 1, V) logits. ``live`` (B,) int: rows with ``live == 0`` leave
    their cache rows untouched (the reference parks their write at a
    dropped index). A negative token (the non-finite sentinel) is never
    used as an embedding index. A windowed config writes its ring at
    pos % window and sweeps min(pos + 1, window) slots."""
    b = token.shape[0]
    pos = _positions(pos, b, token.device)
    ok = _live(live, b, token.device)
    lay = cfg.kv_cache_layout
    wpos, clen = _ring_pos(cfg, pos), _ring_len(cfg, pos)

    def layer_attn(i, q, k, v):
        ck, cv = cache["k"][i], cache["v"][i]
        _write_token_kv(ck, k, wpos, ok, lay)
        _write_token_kv(cv, v, wpos, ok, lay)
        return decode_attention(q, ck, cv, clen, layout=lay, policy=policy)

    return _decode_layers(params, cfg, token, pos, layer_attn,
                          policy=policy), cache


def attn_decode_sharded(q, k, v, cache_k, cache_v, pos, ok, *, shard,
                        layout, policy):
    """One layer's decode attention over a sequence-sharded cache: this
    rank's ``cache_k`` / ``cache_v`` are rows [shard.offset,
    shard.offset + shard.local_s) of the global cache. Every rank
    computes the token's K/V (replicated), only the rank whose slice
    holds ``pos`` lands it (the reference's ``oob_drop``), each rank
    sweeps its slice in partial-statistics mode, and the ranks merge
    through the policy's merge strategy: the only collectives of the
    step. Returns (B, 1, H, hd), equal on every rank."""
    from repro_torch.kernels.decode_attention import \
        decode_attention_partial_merged
    _write_token_kv(cache_k, k, pos, ok, layout, shard.offset)
    _write_token_kv(cache_v, v, pos, ok, layout, shard.offset)
    return decode_attention_partial_merged(
        q, cache_k, cache_v, pos + 1, shard.offset, comm=shard.comm,
        layout=layout, policy=policy)


@hot_path
def decode_step_sharded(params, cfg, token, cache, pos, *, policy, shard,
                        live=None):
    """``decode_step`` over a sequence-sharded cache, run by every rank of
    ``shard.comm`` with the same token, positions and live mask: ``cache``
    holds this rank's (L, B, local_s, Hkv, hd) slice ("bshd"), written in
    place. Everything outside attention is replicated compute; per layer
    the merge is the step's only collective ("packed") or three of them
    ("split"). Returns the (B, 1, V) logits, equal on every rank. Linear
    caches only: a ring's wrapping write straddles the slices."""
    if cfg.sliding_window:
        raise NotImplementedError("sequence-sharded decode covers linear "
                                  "caches, not a windowed ring")
    b = token.shape[0]
    pos = _positions(pos, b, token.device)
    ok = _live(live, b, token.device)
    lay = cfg.kv_cache_layout

    def layer_attn(i, q, k, v):
        return attn_decode_sharded(q, k, v, cache["k"][i], cache["v"][i],
                                   pos, ok, shard=shard, layout=lay,
                                   policy=policy)

    return _decode_layers(params, cfg, token, pos, layer_attn,
                          policy=policy), cache


def _final_logits(params, cfg, x):
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    return _logits(params, cfg, x)


# ------------------------------------------------------------- paged decode

def init_paged_cache(cfg, n_pages, page, device):
    """Paged KV pool: (L, N, page, Hkv, hd) ("bshd") / (L, N, Hkv, page,
    hd) ("bhsd") x2. No slot axis: the host allocator hands pages to slots
    through per-slot block tables; page 0 is the reserved scratch page
    every unassigned table entry points at."""
    if cfg.kv_cache_layout == "bhsd":
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page, cfg.hd)
    else:
        shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _write_token_kv_paged(pool, kv, gids, offs, ok, layout):
    """Write one token's K (or V) per row in place into its pool page:
    kv (B, 1, Hkv, hd) at page ``gids[b]``, offset ``offs[b]``, only where
    ``ok[b]``. Rows that must not write (dead slots, and on a sharded
    pool the rows this rank does not own, all pointed at the scratch page
    0) write the old value back, as ``_write_token_kv`` does, so nothing
    is indexed out of range and no host sync is needed."""
    new = kv[:, 0].to(pool.dtype)                           # (B, Hkv, hd)
    if layout == "bhsd":
        old = pool[gids, :, offs]
        pool[gids, :, offs] = torch.where(ok[:, None, None], new, old)
    else:
        old = pool[gids, offs]
        pool[gids, offs] = torch.where(ok[:, None, None], new, old)


def _paged_coords(tables, pos, ok, page, offset=0):
    """(page ids, in-page offsets, write mask) of each row's token at
    global ``pos`` through ``tables``, whose logical page 0 sits at global
    position ``offset``. Rows whose position lies outside the tables, or
    that are not ``ok``, point at the scratch page 0 and do not write."""
    b, ns = tables.shape
    lp = pos - offset
    ok = ok & (lp >= 0) & (lp < ns * page)
    p = torch.clamp(lp, 0, ns * page - 1).long()
    rows = torch.arange(b, device=tables.device)
    gids = torch.where(ok, tables[rows, p // page].long(), 0)
    return gids, p % page, ok


def _paged_attn(q, pool_k, pool_v, tables, cache_len, cfg, policy):
    """Policy-routed paged sweep: the cuda tier walks the table inside the
    kernel; the reference / eager tiers gather it into a contiguous cache
    first (the same function, the oracle the kernel is held to)."""
    return dispatch("decode_attention_paged", policy)(
        q, pool_k, pool_v, tables, cache_len, window=None, sm_scale=None,
        layout=cfg.kv_cache_layout, policy=policy)


@hot_path
def decode_step_paged(params, cfg, token, cache, tables, pos, *, policy,
                      live=None):
    """One decode step over a paged pool. token (B, 1) int; ``cache`` the
    stacked pools of ``init_paged_cache``; ``tables`` (B, nS) int32 block
    table shared by every layer; pos (B,) int, each row's token position.
    The pool is written in place and returned with the (B, 1, V) logits;
    the tables are read only. Rows with ``live == 0`` write nothing. A
    windowed config's tables are rings of ceil(window / page) pages: the
    write lands at column (pos % window) // page, and the sweep takes
    min(pos + 1, window) keys."""
    b = token.shape[0]
    lay = cfg.kv_cache_layout
    page = cache["k"].shape[3 if lay == "bhsd" else 2]
    pos = _positions(pos, b, token.device)
    gids, offs, ok = _paged_coords(tables, _ring_pos(cfg, pos),
                                   _live(live, b, token.device), page)
    clen = _ring_len(cfg, pos)

    def layer_attn(i, q, k, v):
        pk, pv = cache["k"][i], cache["v"][i]
        _write_token_kv_paged(pk, k, gids, offs, ok, lay)
        _write_token_kv_paged(pv, v, gids, offs, ok, lay)
        return _paged_attn(q, pk, pv, tables, clen, cfg, policy)

    return _decode_layers(params, cfg, token, pos, layer_attn,
                          policy=policy), cache


def _write_chunk_kv_paged(pool, kv, gids, offs, ok, layout):
    """Write a C-token chunk's K (or V) per row in place into its pool
    pages: kv (B, C, Hkv, hd) at pages ``gids`` (B, C), in-page offsets
    ``offs``, only where ``ok``. Lanes that must not write point at the
    scratch page 0 and put its old value back; they may share a row
    there, but all write the same value, and no valid lane writes page
    0."""
    new = kv.to(pool.dtype)
    keep = ok[:, :, None, None]
    if layout == "bhsd":
        old = pool[gids, :, offs]                       # (B, C, Hkv, hd)
        pool[gids, :, offs] = torch.where(keep, new, old)
    else:
        old = pool[gids, offs]
        pool[gids, offs] = torch.where(keep, new, old)


@hot_path
def prefill_chunk_paged(params, cfg, tokens, cache, tables, off, clens, *,
                        policy, all_lanes=False):
    """``prefill_chunk`` over a paged pool (port of the reference's
    ``prefill_chunk_paged``, ``transformer.py:949``): each row's chunk
    K/V scatter into its reserved pages through ``tables`` (B, nS) at its
    cursor, then the row's pages are gathered through its table (shared
    prefix pages, attached at admission, included) and its queries
    attend causally over them (``q_offset=off``, ``kv_len = off +
    clens``). Rows with ``clens == 0`` write nothing. The pool is
    written in place and returned with the (B, 1, V) logits (every
    lane's (B, C, V) with ``all_lanes``). Linear tables only: windowed
    paged pools admit monolithically."""
    from repro_torch.kernels.decode_attention import paged_gather
    if cfg.sliding_window:
        raise NotImplementedError("chunked prefill over a paged ring: "
                                  "windowed paged pools admit "
                                  "monolithically")
    lay = cfg.kv_cache_layout
    page = cache["k"].shape[3 if lay == "bhsd" else 2]
    ns = tables.shape[1]
    lanes = _chunk_lanes(off, clens, tokens.shape[1], tokens.device)
    pos, ok, off, kv_len = lanes
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    cols = torch.clamp(pos // page, 0, ns - 1).long()
    gids = torch.where(ok, tables[rows, cols].long(), 0)
    offs = torch.remainder(pos, page).long()

    def layer_attn(i, q, k, v):
        pk, pv = cache["k"][i], cache["v"][i]
        _write_chunk_kv_paged(pk, k, gids, offs, ok, lay)
        _write_chunk_kv_paged(pv, v, gids, offs, ok, lay)
        kk, vv = paged_gather(pk, tables, lay), paged_gather(pv, tables, lay)
        if lay == "bhsd":
            kk, vv = kk.transpose(1, 2), vv.transpose(1, 2)
        return attention(q, kk, vv, causal=True, kv_len=kv_len,
                         q_offset=off, policy=policy)

    return _chunk_layers(params, cfg, tokens, lanes, layer_attn,
                         all_lanes, policy=policy), cache


@hot_path
def decode_step_paged_sharded(params, cfg, token, cache, tables, pos, *,
                              policy, shard, live=None):
    """``decode_step_paged`` over a sequence-sharded pool, run by every
    rank of ``shard.comm`` with the same token, positions and live mask:
    ``cache`` is this rank's own pool (its page 0 the scratch page),
    ``tables`` its (B, nS_local) slice of the table columns holding local
    page ids, whose logical page 0 sits at global position
    ``shard.offset`` (= rank * nS_local * page). The token's K/V land
    only on the rank owning the position; each rank walks its pages in
    partial-statistics mode and the ranks merge through the policy's
    merge strategy. Returns the (B, 1, V) logits, equal on every rank.
    Linear tables only."""
    from repro_torch.kernels.decode_attention import \
        decode_attention_paged_partial_merged
    if cfg.sliding_window:
        raise NotImplementedError("sequence-sharded paged decode covers "
                                  "linear tables, not a windowed ring")
    b = token.shape[0]
    lay = cfg.kv_cache_layout
    page = cache["k"].shape[3 if lay == "bhsd" else 2]
    pos = _positions(pos, b, token.device)
    gids, offs, ok = _paged_coords(tables, pos, _live(live, b, token.device),
                                   page, shard.offset)

    def layer_attn(i, q, k, v):
        pk, pv = cache["k"][i], cache["v"][i]
        _write_token_kv_paged(pk, k, gids, offs, ok, lay)
        _write_token_kv_paged(pv, v, gids, offs, ok, lay)
        return decode_attention_paged_partial_merged(
            q, pk, pv, tables, pos + 1, shard.offset, comm=shard.comm,
            layout=lay, policy=policy)

    return _decode_layers(params, cfg, token, pos, layer_attn,
                          policy=policy), cache
