"""Mamba-2 (SSD, state-space duality), the attention-free family (port of
``repro/models/ssm.py``).

There is no attention softmax here, but the SSD is exponential-heavy:
the per-step decays ``a_t = exp(dt * A)``, ``softplus(dt)`` and the SiLU
gates all take the policy's exponential through
``kernels.dispatch.exp_callable`` (under the ``cuda`` tier one launch of
the vexp kernel per gate exp on the card).

Chunked SSD (chunk = ``cfg.ssm_chunk``):

* decays kept in log domain (log a = dt * A <= 0);
* intra-chunk: the masked quadratic score (C_i . B_j) exp(L_i - L_j) dt_j;
* inter-chunk: the (B, nh, hd, ds) state carried chunk to chunk.

Decode is one state update: h <- a h + dt (B outer x); y = C . h + D x.

Parameters follow the reference: per layer, 2-D weights (``in_proj``,
``conv_w``, ``out_proj``) are held in the compute dtype (the reference
casts them as each layer enters its scan) and 1-D ones (``ln.w``,
``conv_b``, ``dt_bias``, ``A_log``, ``D``) stay f32; ``embed`` and
``unembed`` stay f32. The three-operand einsums of the reference are
written out as two products in a fixed order, so the order of the f32
sums does not depend on the library's choice of contraction path.

The decode state is a dict {"h": (L, B, nh, hd, ds) f32, "conv": (L, B,
W - 1, C) f32}. ``decode_step`` and ``prefill_chunk`` write it in place,
so a captured CUDA graph replays over one carry: a row the ``live`` mask
parks (decode), or that holds no tokens in a chunk (``clens == 0``),
keeps its ``h`` and ``conv`` bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.analysis.registry import hot_path
from repro_torch.kernels.dispatch import exp_callable
from .layers import mask_padded_logits, norm_apply, vexp_silu, vexp_softplus
from .state_spec import LeafAxes
from .transformer import Norm, _dense, _param


def ssm_dims(cfg):
    di = cfg.d_inner
    nh = cfg.ssm_nheads
    ds = cfg.ssm_state
    ng = cfg.ssm_ngroups
    conv_dim = di + 2 * ng * ds
    return di, nh, ds, ng, conv_dim


class SSMLayer(nn.Module):
    def __init__(self, cfg, g, dtype, device):
        super().__init__()
        d = cfg.d_model
        di, nh, ds, ng, conv_dim = ssm_dims(cfg)
        self.ln = Norm(d, cfg.norm, device)
        self.in_proj = _param(_dense(g, d, 2 * di + 2 * ng * ds + nh, dtype,
                                     device))
        self.conv_w = _param((torch.randn(cfg.conv_width, conv_dim,
                                          generator=g, device=device)
                              * 0.1).to(dtype))
        self.conv_b = _param(torch.zeros(conv_dim, device=device))
        self.dt_bias = _param(torch.zeros(nh, device=device))
        self.A_log = _param(torch.zeros(nh, device=device))   # A = -1
        self.D = _param(torch.ones(nh, device=device))
        self.out_proj = _param(_dense(g, di, d, dtype, device))


class SSM(nn.Module):
    """Parameter container; the computations are the functions below."""

    def __init__(self, cfg, g: torch.Generator, device):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.arch_id}: family {cfg.family!r} is not "
                             f"an ssm")
        dtype = getattr(torch, cfg.compute_dtype)
        self.layers = nn.ModuleList(
            [SSMLayer(cfg, g, dtype, device) for _ in range(cfg.n_layers)])
        self.ln_f = Norm(cfg.d_model, cfg.norm, device)
        self.embed = _param(torch.randn(cfg.vocab_padded, cfg.d_model,
                                        generator=g, device=device) * 0.02)
        self.unembed = _param(_dense(g, cfg.d_model, cfg.vocab_padded,
                                     torch.float32, device))


def init_params(cfg, g: torch.Generator, device) -> SSM:
    """Random weights with the reference's layout and scales (projections
    N(0,1)/sqrt(d_in), conv taps N(0,1)*0.1, embedding N(0,1)*0.02, zero
    conv bias, dt bias and A_log, unit D and norms), drawn from ``g``."""
    return SSM(cfg, g, device)


def _split_proj(zxbcdt, cfg):
    di, nh, ds, ng, _ = ssm_dims(cfg)
    return torch.split(zxbcdt, [di, di, ng * ds, ng * ds, nh], dim=-1)


def _causal_conv(u, w, b, state=None, valid_len=None):
    """Depthwise causal conv along the sequence. u: (B, S, C); w: (W, C);
    ``state``: optional (B, W-1, C) left context (decode, chunks).

    ``valid_len`` selects where the returned left-context state ends:
    None, the last W-1 inputs; an int, the window ending at that
    position; a (B,) tensor, the window ending at each row's last real
    token. Returns (y, new_state). The taps are summed in the input
    dtype (the reference's Python ``sum``), then the f32 bias promotes
    the output to f32."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]),
                          dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    y = sum(full[:, i:i + s] * w[i] for i in range(width)) + b
    if valid_len is None:
        new_state = full[:, full.shape[1] - (width - 1):]
    elif isinstance(valid_len, int):
        new_state = full[:, valid_len:valid_len + width - 1]
    else:
        idx = (valid_len.to(torch.int64).reshape(-1, 1)
               + torch.arange(width - 1, device=u.device)[None, :])
        new_state = torch.take_along_dim(full, idx[..., None], dim=1)
    return y, new_state


@hot_path
def ssm_layer_apply(x, p, cfg, return_state=False, prompt_len=None, *,
                    policy, h0=None, conv_state=None):
    """Full-sequence SSD. x: (B, S, D) -> (B, S, D) [, final state].

    ``h0`` (B, nh, hd, ds) and ``conv_state`` (B, W-1, C) resume the
    recurrence from a carried state (chunked prefill): the inter-chunk
    recurrence starts at ``h0`` and the causal conv reads its left
    context from ``conv_state``. The sequence is padded to the next
    ``cfg.ssm_chunk`` multiple and the pad steps are masked by zeroing
    their ``dt`` (decay exp(0) = 1, update 0), so they move no state;
    ``prompt_len`` (B,) extends the mask to ragged right-padded rows, and
    with ``return_state`` each row's (h, conv) is the state at its last
    real token. The chunk size is always ``cfg.ssm_chunk``, so a row's
    block decomposition, and with it the order of its f32 sums, does not
    depend on how far its batch was padded or where a chunk boundary on
    a ``cfg.ssm_chunk`` multiple fell."""
    exp_fn = exp_callable(policy)
    b, s, _ = x.shape
    di, nh, ds, ng, _ = ssm_dims(cfg)
    hd = cfg.ssm_headdim
    q = cfg.ssm_chunk
    pad = (-s) % q
    sp = s + pad
    nc = sp // q
    dev = x.device
    valid = plen = None
    if prompt_len is not None:
        plen = prompt_len.to(torch.int32).reshape(-1)
        valid = torch.arange(sp, device=dev)[None, :] < plen[:, None]
    elif pad:
        valid = (torch.arange(sp, device=dev)[None, :] < s).expand(b, sp)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))

    h = norm_apply(x, p.ln, cfg.norm, cfg.norm_eps)
    z, xin, Bc, Cc, dt = _split_proj(h @ p.in_proj, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    state_at = None
    if return_state:
        state_at = plen if plen is not None else s
    conv_out, conv_new = _causal_conv(conv_in, p.conv_w, p.conv_b,
                                      state=conv_state, valid_len=state_at)
    conv_out = vexp_silu(conv_out, exp_fn)
    xin, Bc, Cc = torch.split(conv_out, [di, ng * ds, ng * ds], dim=-1)

    dt = vexp_softplus(dt.float() + p.dt_bias, exp_fn)        # (B, Sp, nh)
    if valid is not None:
        # pad / ragged steps: dt = 0, so decay 1 and update 0
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -exp_fn(p.A_log)                                       # (nh,)
    la = dt * A                                                # log a <= 0

    gph = nh // ng                                  # heads per group
    xc = xin.float().reshape(b, nc, q, nh, hd)
    Bb = Bc.float().reshape(b, nc, q, ng, ds)
    Cb = Cc.float().reshape(b, nc, q, ng, ds)
    lac = la.reshape(b, nc, q, nh)
    dtc = dt.reshape(b, nc, q, nh)

    L = torch.cumsum(lac, dim=2)                    # within-chunk
    Ltot = L[:, :, -1]                              # (B, nc, nh)

    # ---- intra-chunk: y_i = sum_{j<=i} (C_i.B_j) exp(L_i-L_j) dt_j x_j
    Cg = Cb.permute(0, 1, 3, 2, 4)                  # (B, nc, ng, Q, ds)
    Bg = Bb.permute(0, 1, 3, 2, 4)
    cb = Cg @ Bg.transpose(-1, -2)                  # (B, nc, ng, Q, Q)
    Li = L.transpose(2, 3)                          # (B, nc, nh, Q)
    diff = Li[..., :, None] - Li[..., None, :]      # (B, nc, nh, Q, Q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    decay = torch.where(mask, exp_fn(torch.clamp(diff, max=0.0)), 0.0)
    dtj = dtc.transpose(2, 3)                       # (B, nc, nh, Q)
    wh = (decay * dtj[..., None, :]).reshape(b, nc, ng, gph, q, q)
    xg = xc.reshape(b, nc, q, ng, gph, hd)
    # scores then the sum over j: (cb * wh) @ x
    y_intra = (cb[:, :, :, None] * wh) @ xg.permute(0, 1, 3, 4, 2, 5)
    y_intra = y_intra.permute(0, 1, 4, 2, 3, 5).reshape(b, nc, q, nh, hd)

    # ---- chunk states: sum_j exp(Ltot - L_j) dt_j B_j (x) x_j
    sdecay = exp_fn(Ltot[:, :, None, :] - L) * dtc  # (B, nc, Q, nh)
    u = sdecay.reshape(b, nc, q, ng, gph)[..., None] * xg
    u = u.permute(0, 1, 3, 4, 5, 2).reshape(b, nc, ng, gph * hd, q)
    states = (u @ Bg).reshape(b, nc, nh, hd, ds)

    # ---- inter-chunk recurrence over nc
    hc = (torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=dev)
          if h0 is None else h0.float())
    etot = exp_fn(Ltot)                             # (B, nc, nh)
    hprevs = []
    for c in range(nc):
        hprevs.append(hc)
        hc = hc * etot[:, c, :, None, None] + states[:, c]
    hprev = torch.stack(hprevs, dim=1)              # (B, nc, nh, hd, ds)

    # ---- y_inter_i = exp(L_i) (C_i . H_prev)
    edec = exp_fn(Li).transpose(2, 3)               # (B, nc, Q, nh)
    hg = hprev.reshape(b, nc, ng, gph * hd, ds)
    y_inter = (Cg @ hg.transpose(-1, -2)).reshape(b, nc, ng, q, gph, hd)
    y_inter = y_inter.permute(0, 1, 3, 2, 4, 5) \
        * edec.reshape(b, nc, q, ng, gph)[..., None]
    y_inter = y_inter.reshape(b, nc, q, nh, hd)

    y = (y_intra + y_inter).reshape(b, sp, nh, hd)
    y = y + xc.reshape(b, sp, nh, hd) * p.D[None, None, :, None]
    y = y.reshape(b, sp, di).to(x.dtype)
    y = y * vexp_silu(z, exp_fn)
    out = (x + y @ p.out_proj)[:, :s]
    if return_state:
        return out, {"h": hc, "conv": conv_new.float()}
    return out


@hot_path
def ssm_layer_decode(x, p, cfg, state, *, policy):
    """Single-token decode. x: (B, 1, D); state: {"h": (B, nh, hd, ds),
    "conv": (B, W-1, C)}. Returns (out, new state); writes nothing."""
    exp_fn = exp_callable(policy)
    b = x.shape[0]
    di, nh, ds, ng, _ = ssm_dims(cfg)
    hd = cfg.ssm_headdim
    gph = nh // ng

    hin = norm_apply(x, p.ln, cfg.norm, cfg.norm_eps)
    z, xin, Bc, Cc, dt = _split_proj(hin @ p.in_proj, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)             # (B, 1, C)
    conv_out, new_conv = _causal_conv(conv_in, p.conv_w, p.conv_b,
                                      state["conv"])
    conv_out = vexp_silu(conv_out, exp_fn)
    xin, Bc, Cc = torch.split(conv_out, [di, ng * ds, ng * ds], dim=-1)

    dt = vexp_softplus(dt[:, 0].float() + p.dt_bias, exp_fn)
    a = exp_fn(dt * (-exp_fn(p.A_log)))                    # (B, nh)
    xh = xin[:, 0].float().reshape(b, nh, hd)
    Bh = torch.repeat_interleave(Bc[:, 0].float().reshape(b, ng, ds), gph,
                                 dim=1)                    # (B, nh, ds)
    Ch = torch.repeat_interleave(Cc[:, 0].float().reshape(b, ng, ds), gph,
                                 dim=1)

    hnew = (state["h"] * a[..., None, None]
            + (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = (hnew @ Ch[..., None])[..., 0] + xh * p.D[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = y * vexp_silu(z, exp_fn)
    # the conv state stays f32, as init_cache and prefill allocate it
    return x + y @ p.out_proj, {"h": hnew, "conv": new_conv.float()}


# ------------------------------------------------------------ full model

def _embed(params, cfg, tokens):
    return params.embed[tokens].to(getattr(torch, cfg.compute_dtype))


def _logits(params, cfg, x):
    """f32 logits against ``unembed``, the padded vocab masked."""
    return mask_padded_logits(x.float() @ params.unembed, cfg.vocab)


def _last_rows(x, lens):
    """x (B, S, D) at each row's last valid position ``lens - 1``."""
    b, s, d = x.shape
    idx = torch.clamp(lens.to(torch.int64).reshape(-1) - 1, 0, s - 1)
    return torch.take_along_dim(x, idx[:, None, None].expand(b, 1, d),
                                dim=1)


def forward(params, cfg, tokens, *, policy):
    """Full-sequence forward to the final normed hidden states (B, S, D)."""
    x = _embed(params, cfg, tokens)
    for layer in params.layers:
        x = ssm_layer_apply(x, layer, cfg, policy=policy)
    return norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)


def init_cache(cfg, batch, seq_len, device):
    """Decode state for ``batch`` rows on ``device``, which the caller
    names, as for every family's cache. ``seq_len`` is accepted for the
    family-uniform signature and unused: the state is O(1) in length."""
    del seq_len
    di, nh, ds, ng, conv_dim = ssm_dims(cfg)
    shape_h = (cfg.n_layers, batch, nh, cfg.ssm_headdim, ds)
    shape_c = (cfg.n_layers, batch, cfg.conv_width - 1, conv_dim)
    return {"h": torch.zeros(shape_h, dtype=torch.float32, device=device),
            "conv": torch.zeros(shape_c, dtype=torch.float32, device=device)}


def state_axes(cfg):
    """Leaf metadata of the decode state: the slot axis, no sequence."""
    del cfg
    return {"h": LeafAxes(1), "conv": LeafAxes(1)}


def prefill(params, cfg, tokens, *, prompt_len=None, policy):
    """Returns (last_logits (B, 1, V), state): one full-sequence SSD pass
    per layer, collecting each layer's final (h, conv). ``prompt_len``
    (B,) marks ragged right-padded prompts: pad steps are dt-masked out
    of the recurrence, and each row's state and logits are taken at its
    last real token."""
    x = _embed(params, cfg, tokens)
    hs, convs = [], []
    for layer in params.layers:
        x, st = ssm_layer_apply(x, layer, cfg, return_state=True,
                                prompt_len=prompt_len, policy=policy)
        hs.append(st["h"])
        convs.append(st["conv"])
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    xl = x[:, -1:] if prompt_len is None else _last_rows(x, prompt_len)
    return (_logits(params, cfg, xl),
            {"h": torch.stack(hs), "conv": torch.stack(convs)})


@hot_path
def prefill_chunk(params, cfg, tokens, state, off, clens, *, policy):
    """Resumable chunked prefill: one SSD pass over a (B, C) token chunk
    per layer, continuing from the carried ``state``, which is written in
    place. ``off`` is accepted for the family-uniform signature and
    unused: the recurrence carries all positional information. ``clens``
    (B,) counts each row's valid tokens; a row with 0 is inert (its
    state passes through bit for bit). Widths on ``cfg.ssm_chunk``
    multiples keep the block decomposition of a one-shot pass. Returns
    (logits (B, 1, V) at each row's last valid token, state)."""
    del off
    x = _embed(params, cfg, tokens)
    for i, layer in enumerate(params.layers):
        h, conv = state["h"][i], state["conv"][i]
        x, new = ssm_layer_apply(x, layer, cfg, return_state=True,
                                 prompt_len=clens, policy=policy, h0=h,
                                 conv_state=conv)
        h.copy_(new["h"])
        conv.copy_(new["conv"])
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    return _logits(params, cfg, _last_rows(x, clens)), state


@hot_path
def decode_step(params, cfg, token, state, pos, *, policy, live=None):
    """One decode step; the state is written in place and returned with
    the (B, 1, V) logits. ``pos`` is accepted for the family-uniform
    signature and unused. ``live`` (B,) parks rows: a row with
    ``live == 0`` keeps its (h, conv) bit for bit."""
    del pos
    x = _embed(params, cfg, token)
    keep = None if live is None else live.reshape(-1) > 0
    for i, layer in enumerate(params.layers):
        h, conv = state["h"][i], state["conv"][i]
        x, new = ssm_layer_decode(x, layer, cfg, {"h": h, "conv": conv},
                                  policy=policy)
        if keep is None:
            h.copy_(new["h"])
            conv.copy_(new["conv"])
        else:
            h.copy_(torch.where(keep[:, None, None, None], new["h"], h))
            conv.copy_(torch.where(keep[:, None, None], new["conv"], conv))
    x = norm_apply(x, params.ln_f, cfg.norm, cfg.norm_eps)
    return _logits(params, cfg, x), state
