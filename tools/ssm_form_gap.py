"""The gap between the SSD's two forms in the JAX package: the logits of
teacher-forced ``decode_step``s (the recurrence) against one ``forward``
over prompt + tokens (the chunked scan) on the same tokens, on the CPU,
under every exp backend.

``chip_smoke.py``'s ``serve_ssm`` phase holds the port's two forms at full
width to a limit set from this reading. Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ssm_form_gap.py \
        [--width reduced|full] [--layers 2 8 24 48]

``--width reduced`` (the default) reads ``mamba2-1.3b.reduced()`` (d 128,
SSD block 16) on 4 prompts of 8-40 tokens and 24 forced steps.
``--width full`` reads mamba2-1.3b's own widths (d 2048, d_inner 4096, 64
heads of 64, state 128, SSD block 256, the whole vocabulary) on 2 prompts
of 300 and 487 tokens, so both cross a block boundary, and 64 forced
steps, as ``chip_smoke.py``'s check runs; only the depth is cut (f32
weights of 48 layers are 5 GB, so give it a few layers on the CPU).
``--layers`` repeats the reading with that many layers (how the gap
grows with depth). Prints one JSON line per depth: per backend the max
|decode - forward| over the forced steps, the max |logit|, and their
ratio. With ``--extrapolate L`` and two or more depths it also prints a
least-squares fit of log(ratio) against log(depth) per backend and the
ratio it gives at depth L (~35 min on 8 CPU cores):

    ... tools/ssm_form_gap.py --width full --layers 8 16 24 --extrapolate 48
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import api
from repro.models.layers import mask_padded_logits
from repro.runtime import resolve_policy

# (prompt lengths, forced steps) per width
SHAPES = {"reduced": ((40, 17, 33, 8), 24), "full": ((300, 487), 64)}


def gap(width, n_layers=None):
    cfg = get_config("mamba2-1.3b")
    if width == "reduced":
        cfg = cfg.reduced()
    PROMPT, STEPS = SHAPES[width]
    B = len(PROMPT)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = api.init_params(cfg, jax.random.PRNGKey(0))
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
            toks = jnp.asarray(prompts[b][None])
            logits, state = api.prefill(params, cfg, {"tokens": toks},
                                        policy=pol)
            dec = [np.asarray(logits[0, 0])]
            for t in range(STEPS - 1):
                logits, state = api.decode_step(
                    params, cfg, jnp.asarray(forced[b, t:t + 1][None]),
                    state, 0, policy=pol)
                dec.append(np.asarray(logits[0, 0]))
            seq = np.concatenate([prompts[b], forced[b, :STEPS - 1]])
            h = api.forward(params, cfg, {"tokens": jnp.asarray(seq[None])},
                            policy=pol)
            full = mask_padded_logits(
                h[0].astype(jnp.float32) @ params["unembed"], cfg.vocab)
            full = np.asarray(full)[len(prompts[b]) - 1:]
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
                      "n_layers": cfg.n_layers, "prompts": list(PROMPT),
                      "forms": "decode_step vs forward", "steps": STEPS,
                      "gap": out}
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
    ap.add_argument("--width", choices=sorted(SHAPES), default="reduced")
    ap.add_argument("--layers", type=int, nargs="*", default=[None])
    ap.add_argument("--extrapolate", type=int, default=None)
    args = ap.parse_args()
    lines = [gap(args.width, n) for n in args.layers]
    if args.extrapolate:
        fit(lines, args.extrapolate)


if __name__ == "__main__":
    main()
