"""The gap between a recurrent family's two forms in the JAX package: the
logits of teacher-forced ``decode_step``s (the recurrence) against one
``forward`` over prompt + tokens (the parallel form: the SSD's chunked
scan, or the hybrid's associative RG-LRU scan beside windowed attention)
on the same tokens, on the CPU, under every exp backend.

``chip_smoke.py``'s ``serve_ssm`` and ``serve_hybrid`` phases hold the
port's two forms at full width to limits set from these readings. Run
from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ssm_form_gap.py \
        [--arch mamba2-1.3b|recurrentgemma-9b] [--width reduced|full] \
        [--layers 2 8 24 48]

``--width reduced`` (the default) reads ``mamba2-1.3b.reduced()`` (d 128,
SSD block 16) on 4 prompts of 8-40 tokens and 24 forced steps.
``--width full`` reads mamba2-1.3b's own widths (d 2048, d_inner 4096, 64
heads of 64, state 128, SSD block 256, the whole vocabulary) on 2 prompts
of 300 and 487 tokens, so both cross a block boundary, and 64 forced
steps, as ``chip_smoke.py``'s check runs; only the depth is cut (f32
weights of 48 layers are 5 GB, so give it a few layers on the CPU).
``--arch recurrentgemma-9b --width reduced`` reads its ``reduced()``
config (4 layers, window 16) on prompts of 16, 5, 12 and 9 tokens and 24
forced steps, so decode wraps the ring. Each prompt is prefilled as the
serving engine admits it: right-padded to the window, so the ring holds
the whole window (a prefill of the bare prompt keeps a ring of the
prompt's length, which the decode steps would overrun). ``--width full``
reads its own
widths (d 4096, 16 heads of 256 on one KV head, lru 4096, window 2048,
the whole vocabulary) on 2 prompts of 300 and 2000 tokens (the second's
decode wraps the 2048-slot ring) and 64 forced steps, as
``chip_smoke.py``'s check runs; only the depth is cut: ``--layers n``
keeps n // 3 periods and the two tail layers, so give it 5 or 8 (f32
weights of one period, the tail, the embedding and the unembedding are
12 GB). ``--layers`` repeats the reading with that many layers (how the
gap grows with depth). Prints one JSON line per depth: per backend the max
|decode - forward| over the forced steps, the max |logit|, and their
ratio. With ``--extrapolate L`` and two or more depths it also prints a
least-squares fit of log(ratio) against log(depth) per backend and the
ratio it gives at depth L; ``--prior FILE`` adds to the fit the depth
lines an earlier run printed into FILE (~35 min on 8 CPU cores):

    ... tools/ssm_form_gap.py --width full --layers 8 16 24 --extrapolate 48
"""

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import api
from repro.models.layers import mask_padded_logits
from repro.runtime import resolve_policy

# (prompt lengths, forced steps) per arch and width
SHAPES = {"mamba2-1.3b": {"reduced": ((40, 17, 33, 8), 24),
                          "full": ((300, 487), 64)},
          "recurrentgemma-9b": {"reduced": ((16, 5, 12, 9), 24),
                                "full": ((300, 2000), 64)}}


def gap(width, n_layers=None, arch="mamba2-1.3b"):
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if width == "reduced":
        cfg = cfg.reduced()
    PROMPT, STEPS = SHAPES[arch][width]
    B = len(PROMPT)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = api.init_params(cfg, jax.random.PRNGKey(0))
    pos = 0 if cfg.family == "ssm" else None
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT]
    forced = rng.integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
    out = {}
    for exp in ("exact", "vexp", "vexp_hw"):
        pol = resolve_policy(cfg, env={}, exp_backend=exp,
                             kernel_backend="reference")
        gap, top = 0.0, 0.0
        for b in range(B):
            batch = {"tokens": jnp.asarray(prompts[b][None])}
            if cfg.family == "hybrid":
                # the serving engine's admission: the prompt right-padded
                # to the window, so the ring holds the whole window
                toks = np.zeros((1, cfg.sliding_window), np.int32)
                toks[0, :len(prompts[b])] = prompts[b]
                batch = {"tokens": jnp.asarray(toks),
                         "prompt_len": jnp.asarray([len(prompts[b])],
                                                   jnp.int32)}
            logits, state = api.prefill(params, cfg, batch, policy=pol)
            dec = [np.asarray(logits[0, 0])]
            for t in range(STEPS - 1):
                # the ssm family ignores the position; the hybrid's ring
                # cursor and rope read it
                p = (pos if pos is not None
                     else jnp.asarray([len(prompts[b]) + t], jnp.int32))
                logits, state = api.decode_step(
                    params, cfg, jnp.asarray(forced[b, t:t + 1][None]),
                    state, p, policy=pol)
                dec.append(np.asarray(logits[0, 0]))
            seq = np.concatenate([prompts[b], forced[b, :STEPS - 1]])
            h = api.forward(params, cfg, {"tokens": jnp.asarray(seq[None])},
                            policy=pol)
            # only the forced steps' rows against the unembedding
            full = mask_padded_logits(
                h[0, len(prompts[b]) - 1:].astype(jnp.float32)
                @ params["unembed"], cfg.vocab)
            full = np.asarray(full)
            gap = max(gap, float(np.abs(np.stack(dec) - full).max()))
            top = max(top, float(np.abs(full[:, :cfg.vocab]).max()))
        out[exp] = {"max_abs_gap": gap, "max_abs_logit": top,
                    "relative": gap / top}
        # op-by-op dispatch compiles one executable per op and static
        # argument; dropping them keeps a deep full-width run under the
        # process's limit of memory maps
        jax.clear_caches()
    line = {"arch": cfg.arch_id, "width": width,
                      "d_model": cfg.d_model, "ssm_chunk": cfg.ssm_chunk,
                      "sliding_window": getattr(cfg, "sliding_window", None),
                      "n_layers": cfg.n_layers, "prompts": list(PROMPT),
                      "forms": "decode_step vs forward", "steps": STEPS,
                      "gap": out, "seconds": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return line


def fit(lines, depth):
    """Per backend: ratio = a x n_layers^p fitted by least squares in log
    space over ``lines``, and the ratio it gives at ``depth``."""
    if len({ln["n_layers"] for ln in lines}) < 2:
        raise SystemExit("--extrapolate needs two or more depths")
    x = np.log([ln["n_layers"] for ln in lines])
    out = {}
    for exp in lines[0]["gap"]:
        y = np.log([ln["gap"][exp]["relative"] for ln in lines])
        p, c = np.polyfit(x, y, 1)
        out[exp] = {"power": float(p),
                    "relative_at_depth": float(np.exp(c + p * np.log(depth)))}
    print(json.dumps({"fit": "relative = a x n_layers^power",
                      "width": lines[0]["width"],
                      "depths": [ln["n_layers"] for ln in lines],
                      "depth": depth, "gap": out}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(SHAPES), default="mamba2-1.3b")
    ap.add_argument("--width", choices=("reduced", "full"),
                    default="reduced")
    ap.add_argument("--layers", type=int, nargs="*", default=[None])
    ap.add_argument("--extrapolate", type=int, default=None)
    ap.add_argument("--prior", default=None,
                    help="a file of lines this tool printed earlier for the "
                         "same arch and width, fitted with this run's")
    args = ap.parse_args()
    lines = [gap(args.width, n, args.arch) for n in args.layers]
    if args.prior:
        with open(args.prior) as f:
            prior = [json.loads(ln) for ln in f if '"n_layers"' in ln]
        lines = [ln for ln in prior if ln["arch"] == lines[0]["arch"]
                 and ln["width"] == lines[0]["width"]] + lines
    if args.extrapolate:
        fit(lines, args.extrapolate)


if __name__ == "__main__":
    main()
