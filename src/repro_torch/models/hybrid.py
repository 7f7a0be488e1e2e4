"""RecurrentGemma / Griffin hybrid (port of ``repro/models/hybrid.py``):
RG-LRU recurrent blocks beside local attention.

One local-attention layer per ``cfg.attn_period`` layers (3 for
recurrentgemma: rec, rec, attn), so ``n_layers // attn_period`` periods
and a tail of ``n_layers % attn_period`` recurrent layers. The
parameters keep the reference's tree: ``periods[i].recs[j]``,
``periods[i].attn``, ``tail[j]``, ``ln_f``, ``embed``, ``unembed``.

Gate exps. The RG-LRU's sigmoids of r and i, exp(2 log a), the decode
step's a = exp(log a) and every exp of the associative scan's combine
take the policy's exponential through ``kernels.dispatch.exp_callable``
(one launch of the vexp kernel a gate exp under the ``cuda`` tier). The
scan's combine is exp(la2) * b1 + b2 on summed log decays, and under
vexp / vexp_hw exp(a) exp(b) != exp(a + b), so the combine tree is part
of the function: ``_assoc_scan`` is the tree of
``jax.lax.associative_scan`` (its recursive odd/even pairing), written
out in torch. A sequential loop or another parallel scan would compute
another function.

Dtypes. The reference casts every f32 leaf of more than one dimension to
the compute dtype as a layer enters its scan (``_cast``). The recurrent
layers' leaves are cast while still stacked (a period's ``recs``, the
``tail``), so every one of them, 1-D ones included (``lam``, norms,
``conv_b``), computes in the compute dtype; the attention layer's 1-D
leaves (its norms) stay f32. The port holds the parameters so from the
start. The two gate matrices are read in f32 (``xf @ w.astype(f32)``):
they are held as f32 copies of their compute-dtype values, made once at
load, so a step reads them and does not upcast them.

State. A flat dict of the mixed per-period state:

* ``rec_h`` (n_per, period - 1, B, W) f32, ``rec_conv`` (n_per,
  period - 1, B, conv - 1, W) f32: the RG-LRU snapshots;
* ``k`` / ``v`` (n_per, B, win, Hkv, hd) bf16, the ring buffers of the
  local attention ("bshd"; slot = absolute position % window), or, on a
  paged pool, (n_per, N, page, Hkv, hd) page pools behind per-slot ring
  tables of ceil(window / page) pages;
* ``tail_h`` (tail, B, W) and ``tail_conv`` (tail, B, conv - 1, W) f32.

``decode_step``, ``decode_step_paged`` and the chunk programs write it in
place: a row the ``live`` mask parks, or that holds no tokens in a chunk
(``clens == 0``), keeps its recurrent rows bit for bit and writes no KV.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.analysis.registry import hot_path
from repro_torch.core.attention import attention, decode_attention
from repro_torch.kernels.dispatch import dispatch, exp_callable
from .layers import gelu, mask_padded_logits, mlp_apply, norm_apply, \
    vexp_sigmoid
from .ssm import _causal_conv
from .state_spec import LeafAxes
from .transformer import (MLP, Attention, Norm, _chunk_lanes, _dense, _live,
                          _param, _positions, _qkv, _ring_len, _ring_pos,
                          _ring_rows, _write_chunk_kv, _write_chunk_kv_paged,
                          _write_token_kv, _write_token_kv_paged)

RG_LRU_C = 8.0     # Griffin's fixed exponent scale
LAYOUT = "bshd"    # the ring buffers' layout, whatever cfg.kv_cache_layout


# ------------------------------------------------------------ parameters

class RecLayer(nn.Module):
    """One RG-LRU block; every leaf in the compute dtype (see the module
    docstring), the two gate matrices as f32 copies of such values."""

    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        self.ln = Norm(d, cfg.norm, device)
        self.wx = _param(_dense(g, d, w, dtype, device))
        self.wy = _param(_dense(g, d, w, dtype, device))
        self.conv_w = _param((torch.randn(cfg.conv_width, w, generator=g,
                                          device=device) * 0.1).to(dtype))
        self.conv_b = _param(torch.zeros(w, dtype=dtype, device=device))
        self.w_input_gate = _param(_dense(g, w, w, dtype, device).float())
        self.w_rec_gate = _param(_dense(g, w, w, dtype, device).float())
        # a = sigmoid(lam) uniform in [0.9, 0.999] (Griffin app. A)
        u = 0.9 + 0.099 * torch.rand(w, generator=g, device=device)
        self.lam = _param(torch.log(u ** 2 / (1 - u ** 2)).to(dtype))
        self.w_out = _param(_dense(g, w, d, dtype, device))
        self.ln_mlp = Norm(d, cfg.norm, device)
        self.mlp = MLP(cfg, g, dtype, device)
        for norm in (self.ln, self.ln_mlp):
            for p in norm.parameters():
                p.data = p.data.to(dtype)


class AttnLayer(nn.Module):
    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        self.ln = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg, g, dtype, device)
        self.ln_mlp = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg, g, dtype, device)


class Period(nn.Module):
    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        self.recs = nn.ModuleList([RecLayer(cfg, g, dtype, device)
                                   for _ in range(cfg.attn_period - 1)])
        self.attn = AttnLayer(cfg, g, dtype, device)


class Hybrid(nn.Module):
    """Parameter container; the computations are the functions below."""

    def __init__(self, cfg, g: torch.Generator, device):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.arch_id}: family {cfg.family!r} is not "
                             f"a hybrid")
        dtype = getattr(torch, cfg.compute_dtype)
        _, n_per, tail = period_counts(cfg)
        self.periods = nn.ModuleList(
            [Period(cfg, g, dtype, device) for _ in range(n_per)])
        self.tail = nn.ModuleList(
            [RecLayer(cfg, g, dtype, device) for _ in range(tail)])
        self.ln_f = Norm(cfg.d_model, cfg.norm, device)
        self.embed = _param(torch.randn(cfg.vocab_padded, cfg.d_model,
                                        generator=g, device=device) * 0.02)
        self.unembed = _param(_dense(g, cfg.d_model, cfg.vocab_padded,
                                     torch.float32, device))


def period_counts(cfg):
    """(period, scanned periods, trailing recurrent layers)."""
    period = cfg.attn_period
    return period, cfg.n_layers // period, cfg.n_layers % period


def init_params(cfg, g: torch.Generator, device) -> Hybrid:
    """Random weights with the reference's layout and scales (projections
    N(0,1)/sqrt(d_in), conv taps N(0,1)*0.1, embedding N(0,1)*0.02, lam
    with sigmoid(lam) in [0.9, 0.999], zero conv bias, unit norms), drawn
    from ``g``."""
    return Hybrid(cfg, g, device)


# ------------------------------------------------------------ RG-LRU

def _combine(e1, e2, exp_fn):
    """The scan's operator on (log decay, state) pairs: the decays add,
    the later element's decay scales the earlier state."""
    (la1, b1), (la2, b2) = e1, e2
    if la2.numel() == 0:
        return la1 + la2, b1 + b2
    return la1 + la2, exp_fn(la2) * b1 + b2


def _assoc_scan(la, b, exp_fn):
    """Inclusive scan of (la, b) along axis 1 under ``_combine``, in the
    combine tree of ``jax.lax.associative_scan`` (``_scan`` in
    ``jax/_src/lax/control_flow/loops.py``): combine adjacent pairs, scan
    the half-length sequence recursively (its results are the odd
    elements), combine each odd result with the next even input (the
    even elements; the first element passes through), interleave."""
    n = la.shape[1]
    if n < 2:
        return la, b
    red = _combine((la[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                   (la[:, 1::2], b[:, 1::2]), exp_fn)
    odd_l, odd_b = _assoc_scan(*red, exp_fn)
    if n % 2 == 0:
        ev_l, ev_b = _combine((odd_l[:, :-1], odd_b[:, :-1]),
                              (la[:, 2::2], b[:, 2::2]), exp_fn)
    else:
        ev_l, ev_b = _combine((odd_l, odd_b), (la[:, 2::2], b[:, 2::2]),
                              exp_fn)
    out = []
    for first, ev, odd in ((la, ev_l, odd_l), (b, ev_b, odd_b)):
        t = torch.empty_like(first)
        t[:, 0:1] = first[:, 0:1]
        t[:, 2::2] = ev
        t[:, 1::2] = odd
        out.append(t)
    return out[0], out[1]


def scan_exps(n: int) -> int:
    """Exp calls of ``_assoc_scan`` over a sequence of ``n`` (the
    combines whose later operand is not empty)."""
    if n < 2:
        return 0
    return 1 + scan_exps(n // 2) + (1 if n >= 3 else 0)


def _log_a_base(lam):
    """log sigmoid(lam) = -logaddexp(0, -lam) <= 0, in lam's dtype."""
    return -torch.logaddexp(torch.zeros_like(lam), -lam)


def _gates(xf, p, exp_fn):
    """(r, i, log a) of f32 inputs ``xf``: the gate matmuls in f32."""
    r = vexp_sigmoid(xf @ p.w_rec_gate, exp_fn)
    i = vexp_sigmoid(xf @ p.w_input_gate, exp_fn)
    return r, i, RG_LRU_C * r * _log_a_base(p.lam)


@hot_path
def _rg_lru(xw, p, cfg, h0=None, last_idx=None, *, policy):
    """RG-LRU over a sequence. xw: (B, S, W). Returns (y in xw's dtype,
    h_last (B, W) f32).

    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t), log a_t = c r_t log
    sigmoid(lam) <= 0, as an associative scan in the log-decay domain;
    ``h0`` contributes exp(la_acc) h0, added after the scan.
    ``last_idx`` (B,) takes each row's state at that position instead of
    the sequence end (a prefix-scan element depends only on positions at
    or before it, so a right-padded tail needs no masking)."""
    del cfg
    exp_fn = exp_callable(policy)
    xf = xw.float()
    r, i, log_a = _gates(xf, p, exp_fn)
    b = torch.sqrt(torch.clamp(1.0 - exp_fn(2.0 * log_a), min=0.0)) \
        * (i * xf)
    la_acc, h = _assoc_scan(log_a, b, exp_fn)
    if h0 is not None:
        h = h + exp_fn(la_acc) * h0[:, None, :]
    if last_idx is None:
        h_last = h[:, -1]
    else:
        idx = last_idx.to(torch.int64).reshape(-1, 1, 1)
        h_last = torch.take_along_dim(h, idx.expand(-1, 1, h.shape[2]),
                                      dim=1)[:, 0]
    return h.to(xw.dtype), h_last


@hot_path
def rec_layer_apply(x, p, cfg, h0=None, conv_state=None, last_idx=None,
                    valid_len=None, *, policy):
    """Full-sequence recurrent block. Returns (y, (h_last, conv_state)).
    ``last_idx`` / ``valid_len`` (both (B,), prompt_len - 1 / prompt_len)
    take each row's recurrent and conv state at its last real token."""
    hin = norm_apply(x, p.ln, cfg.norm, cfg.norm_eps)
    u = hin @ p.wx
    u, conv_state = _causal_conv(u, p.conv_w, p.conv_b, conv_state,
                                 valid_len=valid_len)
    y, h_last = _rg_lru(u, p, cfg, h0, last_idx=last_idx, policy=policy)
    gate = gelu(hin @ p.wy)
    x = x + (y * gate) @ p.w_out
    h2 = norm_apply(x, p.ln_mlp, cfg.norm, cfg.norm_eps)
    x = x + mlp_apply(h2, p.mlp, cfg.act, policy=policy)
    return x, (h_last, conv_state)


@hot_path
def rec_layer_decode(x, p, cfg, state, *, policy):
    """Single-token decode. state: {"h": (B, W), "conv": (B, conv - 1,
    W)}. Returns (out, new state); writes nothing."""
    exp_fn = exp_callable(policy)
    hin = norm_apply(x, p.ln, cfg.norm, cfg.norm_eps)
    u = hin @ p.wx
    u, new_conv = _causal_conv(u, p.conv_w, p.conv_b, state["conv"])
    uf = u[:, 0].float()
    r, i, log_a = _gates(uf, p, exp_fn)
    a = exp_fn(log_a)
    bterm = torch.sqrt(torch.clamp(1.0 - exp_fn(2 * log_a), min=0.0)) \
        * (i * uf)
    h = a * state["h"] + bterm
    gate = gelu(hin[:, 0] @ p.wy)
    x = x + ((h.to(x.dtype) * gate) @ p.w_out)[:, None, :]
    h2 = norm_apply(x, p.ln_mlp, cfg.norm, cfg.norm_eps)
    x = x + mlp_apply(h2, p.mlp, cfg.act, policy=policy)
    return x, {"h": h, "conv": new_conv}


# ----------------------------------------------------- attention layers

def _attn_out(x, o, p, cfg, policy):
    """Residual of the attention output, then the layer's MLP."""
    x = x + o.flatten(2) @ p.attn.wo
    h2 = norm_apply(x, p.ln_mlp, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(h2, p.mlp, cfg.act, policy=policy)


@hot_path
def attn_layer_apply(x, p, cfg, pos, kv_len=None, *, policy):
    """Windowed causal attention over the sequence (the FlashAttention
    kernel under the ``cuda`` tier), keys at or past ``kv_len`` (B,)
    masked. Returns (x, (k, v))."""
    h = norm_apply(x, p.ln, cfg.norm, cfg.norm_eps)
    q, k, v = _qkv(h, p.attn, cfg, pos)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window,
                  kv_len=kv_len, policy=policy)
    return _attn_out(x, o, p, cfg, policy), (k, v)


@hot_path
def attn_layer_decode(x, p, cfg, ck, cv, pos, wpos, ok, *, policy):
    """Single-token local-attention decode against a ring buffer: the
    token's K/V land at the write cursor ``wpos`` (pos % window; rows not
    ``ok`` write nothing), then the kernel sweeps the ring's
    min(pos + 1, window) valid rows. ``ck`` / ``cv`` (B, win, Hkv, hd)
    are written in place."""
    h = norm_apply(x, p.ln, cfg.norm, cfg.norm_eps)
    q, k, v = _qkv(h, p.attn, cfg, pos[:, None])
    _write_token_kv(ck, k, wpos, ok, LAYOUT)
    _write_token_kv(cv, v, wpos, ok, LAYOUT)
    o = decode_attention(q, ck, cv, _ring_len(cfg, pos), layout=LAYOUT,
                         policy=policy)
    return _attn_out(x, o, p, cfg, policy)


@hot_path
def attn_layer_decode_paged(x, p, cfg, pk, pv, tables, pos, wpos, ok, *,
                            policy):
    """``attn_layer_decode`` against a page pool: the ring write lands in
    page ``tables[b, wpos // page]`` at offset ``wpos % page`` (rows not
    ``ok`` point at the scratch page 0 and put its old value back); the
    paged kernel walks each row's ring table, validity by length."""
    page = pk.shape[1]
    b = x.shape[0]
    h = norm_apply(x, p.ln, cfg.norm, cfg.norm_eps)
    q, k, v = _qkv(h, p.attn, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    gids = torch.where(ok, tables[rows, (wpos // page).long()].long(), 0)
    offs = torch.remainder(wpos, page).long()
    _write_token_kv_paged(pk, k, gids, offs, ok, LAYOUT)
    _write_token_kv_paged(pv, v, gids, offs, ok, LAYOUT)
    o = dispatch("decode_attention_paged", policy)(
        q, pk, pv, tables, _ring_len(cfg, pos), window=None, sm_scale=None,
        layout=LAYOUT, policy=policy)
    return _attn_out(x, o, p, cfg, policy)


# ------------------------------------------------------------ full model

def _embed(params, cfg, tokens):
    return params.embed[tokens].to(getattr(torch, cfg.compute_dtype))


def _logits(params, cfg, x):
    """f32 logits against ``unembed``, the padded vocab masked."""
    return mask_padded_logits(x.float() @ params.unembed, cfg.vocab)


def _last_logits(params, cfg, x, last_idx):
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    b, _, d = x.shape
    xl = torch.take_along_dim(
        x, last_idx.to(torch.int64).reshape(-1, 1, 1).expand(b, 1, d),
        dim=1)
    return _logits(params, cfg, xl)


def _rec_layers(params):
    """(period index or None, index, layer) of every recurrent layer in
    order: each period's recs, then the tail."""
    for i, per in enumerate(params.periods):
        for j, rec in enumerate(per.recs):
            yield i, j, rec
    for j, rec in enumerate(params.tail):
        yield None, j, rec


def _rec_rows(state, i, j):
    """(h, conv) views of one recurrent layer's state rows."""
    if i is None:
        return state["tail_h"][j], state["tail_conv"][j]
    return state["rec_h"][i, j], state["rec_conv"][i, j]


def forward(params, cfg, tokens, *, policy):
    """Full-sequence forward to the final normed hidden states (B, S, D)."""
    x = _embed(params, cfg, tokens)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    for per in params.periods:
        for rec in per.recs:
            x, _ = rec_layer_apply(x, rec, cfg, policy=policy)
        x, _ = attn_layer_apply(x, per.attn, cfg, pos, policy=policy)
    for rec in params.tail:
        x, _ = rec_layer_apply(x, rec, cfg, policy=policy)
    return norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)


def _rec_shapes(cfg, batch):
    period, n_per, tail = period_counts(cfg)
    w = cfg.lru_width or cfg.d_model
    return {"rec_h": (n_per, period - 1, batch, w),
            "rec_conv": (n_per, period - 1, batch, cfg.conv_width - 1, w),
            "tail_h": (tail, batch, w),
            "tail_conv": (tail, batch, cfg.conv_width - 1, w)}


def _zeros(shapes, kv_shape, device):
    st = {name: torch.zeros(shape, dtype=torch.float32, device=device)
          for name, shape in shapes.items()}
    for name in ("k", "v"):
        st[name] = torch.zeros(kv_shape, dtype=torch.bfloat16,
                               device=device)
    return st


def init_cache(cfg, batch, seq_len, device):
    """The contiguous state of ``batch`` rows: RG-LRU snapshots and ring
    buffers of min(seq_len, window) rows."""
    _, n_per, _ = period_counts(cfg)
    win = min(seq_len, cfg.sliding_window or seq_len)
    return _zeros(_rec_shapes(cfg, batch),
                  (n_per, batch, win, cfg.n_kv_heads, cfg.hd), device)


def init_paged_cache(cfg, batch, n_pages, page, device):
    """The paged state: recurrent leaves keep their slot axis (O(1) a
    slot, nothing to page), the ring KV leaves become slotless page pools
    (n_per, N, page, Hkv, hd), "bshd". Every period indexes the same
    per-slot ring table; page 0 is the scratch page."""
    _, n_per, _ = period_counts(cfg)
    return _zeros(_rec_shapes(cfg, batch),
                  (n_per, n_pages, page, cfg.n_kv_heads, cfg.hd), device)


def state_axes(cfg):
    """Leaf metadata of the mixed state: the recurrent snapshots carry
    only a slot axis; the ring KV leaves also a sequence axis."""
    del cfg
    return {"rec_h": LeafAxes(2), "rec_conv": LeafAxes(2),
            "k": LeafAxes(1, 2), "v": LeafAxes(1, 2),
            "tail_h": LeafAxes(1), "tail_conv": LeafAxes(1)}


def prefill(params, cfg, tokens, *, prompt_len=None, policy):
    """Prompt forward -> (last_logits (B, 1, V), state).

    ``prompt_len`` (B,) marks ragged right-padded prompts: padding is
    masked out of the local attention (and its K/V rows zeroed), each
    recurrent layer's (h, conv) is taken at the row's last real token,
    and so are the logits. Ragged batches must fit the window (the
    ring-buffer roll is batch-uniform); a uniform prompt longer than the
    window keeps its last ``window`` K/V rows rolled into ring order
    (slot = absolute position % window)."""
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    dev = x.device
    pos = torch.arange(s, device=dev)[None, :]
    w = cfg.sliding_window
    plen = last_idx = valid = None
    if prompt_len is not None:
        if w and s > w:
            raise ValueError(
                f"ragged prefill of {s} tokens exceeds the sliding window "
                f"({w}): the ring-buffer roll is batch-uniform; prefill "
                f"ragged windowed batches at <= window")
        plen = torch.as_tensor(prompt_len, device=dev).to(
            torch.int32).reshape(-1)
        valid = (pos < plen[:, None])[:, :, None, None]
        last_idx = torch.clamp(plen - 1, 0, s - 1)
    st = {name: [] for name in ("rec_h", "rec_conv", "k", "v", "tail_h",
                                "tail_conv")}
    for per in params.periods:
        hs, convs = [], []
        for rec in per.recs:
            x, (h, conv) = rec_layer_apply(x, rec, cfg, last_idx=last_idx,
                                           valid_len=plen, policy=policy)
            hs.append(h)
            convs.append(conv.float())
        st["rec_h"].append(torch.stack(hs))
        st["rec_conv"].append(torch.stack(convs))
        x, (k, v) = attn_layer_apply(x, per.attn, cfg, pos, kv_len=plen,
                                     policy=policy)
        if valid is not None:
            # pad rows must not reach the decode state
            k = torch.where(valid, k, 0)
            v = torch.where(valid, v, 0)
        k, v = _ring_rows(k, w), _ring_rows(v, w)
        st["k"].append(k.to(torch.bfloat16))
        st["v"].append(v.to(torch.bfloat16))
    for rec in params.tail:
        x, (h, conv) = rec_layer_apply(x, rec, cfg, last_idx=last_idx,
                                       valid_len=plen, policy=policy)
        st["tail_h"].append(h)
        st["tail_conv"].append(conv.float())
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    xl = x[:, -1:] if plen is None else torch.take_along_dim(
        x, last_idx.long().reshape(-1, 1, 1).expand(b, 1, x.shape[2]),
        dim=1)
    state = {}
    for name, leaves in st.items():
        if leaves:
            state[name] = torch.stack(leaves)
    if not params.tail:
        for name, shape in _rec_shapes(cfg, b).items():
            if name.startswith("tail"):
                state[name] = torch.zeros(shape, dtype=torch.float32,
                                          device=dev)
    return _logits(params, cfg, xl), state


def _prefill_chunk_impl(params, cfg, tokens, state, clens, attn_fn, policy):
    """The chunk program's layer loop, the state written in place:
    recurrent layers continue from their carried (h, conv) rows; the
    period's attention layer is ``attn_fn(i, h_normed, attn_params) ->
    attention output (B, C, H, hd)``, which lands the chunk's K/V. Rows
    with ``clens == 0`` are inert: the RG-LRU keeps the carried h
    explicitly (``last_idx`` would clamp to 0 and take one real step
    otherwise), the conv state gathers back its own left context, and
    the KV writes are masked. Returns the (B, 1, V) logits of each row's
    last valid lane."""
    x = _embed(params, cfg, tokens)
    c = tokens.shape[1]
    last_idx = torch.clamp(clens - 1, 0, c - 1)
    alive = (clens > 0)[:, None]

    def rec_chunk(x, rec, h, conv):
        y, (h_last, new_conv) = rec_layer_apply(
            x, rec, cfg, h0=h, conv_state=conv, last_idx=last_idx,
            valid_len=clens, policy=policy)
        h.copy_(torch.where(alive, h_last, h))
        conv.copy_(new_conv.float())
        return y

    for i, per in enumerate(params.periods):
        for j, rec in enumerate(per.recs):
            x = rec_chunk(x, rec, *_rec_rows(state, i, j))
        hn = norm_apply(x, per.attn.ln, cfg.norm, cfg.norm_eps)
        x = _attn_out(x, attn_fn(i, hn, per.attn.attn), per.attn, cfg,
                      policy)
    for j, rec in enumerate(params.tail):
        x = rec_chunk(x, rec, *_rec_rows(state, None, j))
    return _last_logits(params, cfg, x, last_idx)


@hot_path
def prefill_chunk(params, cfg, tokens, state, off, clens, *, policy):
    """Resumable chunked prefill over the contiguous state, written in
    place: every row advances by ``clens[b]`` tokens of the (B, C)
    ``tokens`` at its cursor ``off[b]``; the chunk's K/V land in the ring
    at positions off .. off + clens - 1 and its queries attend causally,
    window-masked, over the ring (``q_offset = off``, ``kv_len = off +
    clens``: one FlashAttention launch a period under the ``cuda``
    tier). Prefill positions never wrap the ring (prompts fit the
    window), so a ring slot is the absolute position throughout. The
    RG-LRU combine tree depends on the scan's length, so the chunk width
    must be fixed for run-to-run equality; chunked output equals the
    one-shot prefill up to that tree. Returns (logits (B, 1, V) at each
    row's last valid lane, state)."""
    pos, ok, off, kv_len = _chunk_lanes(off, clens, tokens.shape[1],
                                        tokens.device)

    def attn_fn(i, h, p):
        q, k, v = _qkv(h, p, cfg, pos)
        ck, cv = state["k"][i], state["v"][i]
        _write_chunk_kv(ck, k, pos, ok, LAYOUT)
        _write_chunk_kv(cv, v, pos, ok, LAYOUT)
        return attention(q, ck, cv, causal=True, window=cfg.sliding_window,
                         kv_len=kv_len, q_offset=off, policy=policy)

    return _prefill_chunk_impl(params, cfg, tokens, state, kv_len - off,
                               attn_fn, policy), state


@hot_path
def prefill_chunk_paged(params, cfg, tokens, state, tables, off, clens, *,
                        policy):
    """``prefill_chunk`` over the paged state: the chunk's K/V scatter
    into each row's ring pages at its cursor (``tables[b, pos // page]``,
    cursor-monotonic during prefill), then the row's pages are gathered
    and its queries attend over them."""
    from repro_torch.kernels.decode_attention import paged_gather
    pos, ok, off, kv_len = _chunk_lanes(off, clens, tokens.shape[1],
                                        tokens.device)
    page = state["k"].shape[2]
    ns = tables.shape[1]
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    cols = torch.clamp(pos // page, 0, ns - 1).long()
    gids = torch.where(ok, tables[rows, cols].long(), 0)
    offs = torch.remainder(pos, page).long()

    def attn_fn(i, h, p):
        q, k, v = _qkv(h, p, cfg, pos)
        pk, pv = state["k"][i], state["v"][i]
        _write_chunk_kv_paged(pk, k, gids, offs, ok, LAYOUT)
        _write_chunk_kv_paged(pv, v, gids, offs, ok, LAYOUT)
        return attention(q, paged_gather(pk, tables, LAYOUT),
                         paged_gather(pv, tables, LAYOUT), causal=True,
                         window=cfg.sliding_window, kv_len=kv_len,
                         q_offset=off, policy=policy)

    return _prefill_chunk_impl(params, cfg, tokens, state, kv_len - off,
                               attn_fn, policy), state


def _decode_layers(params, cfg, token, state, pos, ok, attn_fn, policy):
    """The decode step's layer loop, the state written in place: rows not
    ``ok`` keep their recurrent rows bit for bit; ``attn_fn(i, x,
    attn_params)`` runs period i's attention layer. Returns the (B, 1,
    V) logits."""
    x = _embed(params, cfg, torch.clamp(token, min=0))
    keep = ok[:, None]

    def rec_step(x, rec, h, conv):
        y, new = rec_layer_decode(x, rec, cfg, {"h": h, "conv": conv},
                                  policy=policy)
        h.copy_(torch.where(keep, new["h"], h))
        conv.copy_(torch.where(keep[:, :, None], new["conv"].float(), conv))
        return y

    for i, per in enumerate(params.periods):
        for j, rec in enumerate(per.recs):
            x = rec_step(x, rec, *_rec_rows(state, i, j))
        x = attn_fn(i, x, per.attn)
    for j, rec in enumerate(params.tail):
        x = rec_step(x, rec, *_rec_rows(state, None, j))
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    return _logits(params, cfg, x)


@hot_path
def decode_step(params, cfg, token, state, pos, *, policy, live=None):
    """One decode step over the contiguous state, written in place and
    returned with the (B, 1, V) logits. ``pos`` (B,) each row's token
    position; the ring write cursor is pos % window, and rows with
    ``live == 0`` are parked after that wrap (their ring rows and
    recurrent rows untouched)."""
    b = token.shape[0]
    pos = _positions(pos, b, token.device)
    ok = _live(live, b, token.device)
    wpos = _ring_pos(cfg, pos)

    def attn_fn(i, x, p):
        return attn_layer_decode(x, p, cfg, state["k"][i], state["v"][i],
                                 pos, wpos, ok, policy=policy)

    return _decode_layers(params, cfg, token, state, pos, ok, attn_fn,
                          policy), state


@hot_path
def decode_step_paged(params, cfg, token, state, tables, pos, *, policy,
                      live=None):
    """One decode step over the paged state: ``tables`` (B, ceil(window /
    page)) int32, each row's ring table, shared by every period; the
    state is written in place and returned with the logits."""
    b = token.shape[0]
    pos = _positions(pos, b, token.device)
    ok = _live(live, b, token.device)
    wpos = _ring_pos(cfg, pos)

    def attn_fn(i, x, p):
        return attn_layer_decode_paged(x, p, cfg, state["k"][i],
                                       state["v"][i], tables, pos, wpos, ok,
                                       policy=policy)

    return _decode_layers(params, cfg, token, state, pos, ok, attn_fn,
                          policy), state


def gate_exps_per_step(cfg) -> int:
    """Launches of the exp kernel a decode step makes under the ``cuda``
    tier: r, i, a and exp(2 log a) of every recurrent layer."""
    period, n_per, tail = period_counts(cfg)
    return 4 * (n_per * (period - 1) + tail)


def gate_exps_per_pass(cfg, width: int, chunk: bool = False) -> int:
    """Launches of the exp kernel a prefill (``chunk``: a chunk program)
    of ``width`` tokens makes: per recurrent layer r, i, exp(2 log a),
    the scan's combines, and in a chunk the carried state's decay."""
    period, n_per, tail = period_counts(cfg)
    per_layer = 3 + scan_exps(width) + (1 if chunk else 0)
    return per_layer * (n_per * (period - 1) + tail)


__all__ = ["Hybrid", "RG_LRU_C", "decode_step", "decode_step_paged",
           "forward", "init_cache", "init_paged_cache", "init_params",
           "period_counts", "prefill", "prefill_chunk",
           "prefill_chunk_paged", "rec_layer_apply", "rec_layer_decode",
           "state_axes"]
