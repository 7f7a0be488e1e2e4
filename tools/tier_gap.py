"""The gap between the JAX package's two kernel tiers on a decoder
(dense or MoE): the logits of a teacher-forced serve (one prefill, then
one ``decode_step`` per forced token) under the ``pallas`` tier (the
Pallas FlashAttention and flash-decode kernels, interpreted on the CPU)
against the same under the ``reference`` tier, on the same tokens, under
every exp backend.

``chip_smoke.py``'s ``serve_phi3``, ``serve_dbrx`` and ``serve_danube``
phases hold the port's ``cuda`` tier (its kernels, which compute what
the Pallas kernels compute: q and p rounded to bf16 in the decode sweep,
the blockwise online update) to its ``reference`` tier on the card, to
limits set from these readings, as ``tools/ssm_form_gap.py`` sets the
recurrent families' form limits. Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tier_gap.py \
        [--arch phi3-medium-14b|dbrx-132b|h2o-danube3-4b] \
        [--width reduced|narrow|full] [--layers 2 4 6] [--extrapolate 40] \
        [--prior FILE]

``--width reduced`` reads the arch's ``reduced()`` config on prompts of
24 and 9 tokens (dbrx: 4 experts, top-2, G 1, head dim 32). The other
widths run 2 prompts of 300 and 1,000 tokens and 16 forced steps, as
``chip_smoke.py``'s checks do, with only the depth cut: ``--width full``
is phi3-medium-14b's own widths (d 5120, 40 query heads on 10 KV heads
of 128, SwiGLU d_ff 17,920, the whole untied vocabulary; f32 weights of
one layer are 1.4 GB, the embedding and the unembedding 4.1 GB, so give
it a few layers on the CPU); ``--width narrow`` is dbrx-132b's shape at
an eighth of its widths (d 768, 6 query heads on one KV head of 128: G 6
and head dim 128 as on the card; 16 experts, top-4, capacity factor
1.25, expert d_ff 1,344; the whole untied vocabulary; ~2 GB of f32
weights at 8 layers). h2o-danube3-4b at ``--width full`` (d 3840, 32
query heads on 8 KV heads of 120, SwiGLU d_ff 10,240, vocabulary 32,000,
window 4,096; f32 weights of one layer 0.62 GB, the embedding and the
unembedding 0.98 GB) takes prompts of 1,000 and 4,096 tokens, so that its
16 forced steps run past the ring's wrap, as ``serve_danube`` replays
each group's 4,096-token request; its cache is the ring, never wider
than the window. Prints one JSON line per depth: per backend the
max |pallas - reference| over the forced steps, the max |logit| and
their ratio. With ``--extrapolate L`` and two or more depths it also
prints a least-squares fit of log(ratio) against log(depth) per backend
and the ratio it gives at depth L; ``--prior FILE`` adds to the fit the
depth lines an earlier run printed into FILE.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import api
from repro.runtime import resolve_policy

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ssm_form_gap import fit  # noqa: E402

# (prompt lengths, forced steps) per width
SHAPES = {"reduced": ((24, 9), 16), "narrow": ((300, 1000), 16),
          "full": ((300, 1000), 16)}
# a windowed arch's full-width prompts: one at the window, so the forced
# steps wrap the ring
WINDOWED_FULL = (1000, 4096)
# dbrx-132b at an eighth of its widths (``--width narrow``)
NARROW = {"d_model": 768, "n_heads": 6, "n_kv_heads": 1, "head_dim": 128,
          "d_ff": 1344}


def tier_logits(params, cfg, prompt, forced, pol):
    """Teacher-forced logits under ``pol``: (steps, V)."""
    logits, cache = api.prefill(params, cfg,
                                {"tokens": jnp.asarray(prompt[None])},
                                policy=pol)
    steps = len(forced)
    # room for the forced tokens; a ring (a windowed arch) holds at most
    # the window
    s = len(prompt)
    room = (min(s + steps, cfg.sliding_window) if cfg.sliding_window
            else s + steps) - s
    cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, room), (0, 0), (0, 0)))
             for k, v in cache.items()}
    out = [np.asarray(logits[0, 0])]
    for t in range(steps - 1):
        logits, cache = api.decode_step(
            params, cfg, jnp.asarray([[forced[t]]], jnp.int32), cache,
            jnp.asarray([len(prompt) + t], jnp.int32), policy=pol)
        out.append(np.asarray(logits[0, 0]))
    return np.stack(out)


def gap(width, n_layers=None, arch="phi3-medium-14b"):
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if width == "reduced":
        cfg = cfg.reduced()
    elif width == "narrow":
        if cfg.family != "moe":
            raise SystemExit("--width narrow is dbrx-132b's")
        cfg = dataclasses.replace(cfg, **NARROW)
    prompts_len, steps = SHAPES[width]
    if width == "full" and cfg.sliding_window:
        prompts_len = WINDOWED_FULL
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = api.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in prompts_len]
    forced = rng.integers(0, cfg.vocab, (len(prompts), steps)).astype(
        np.int32)
    out = {}
    for exp in ("exact", "vexp", "vexp_hw"):
        pols = {tier: resolve_policy(cfg, env={}, exp_backend=exp,
                                     kernel_backend=tier)
                for tier in ("pallas", "reference")}
        g, top = 0.0, 0.0
        for b, prompt in enumerate(prompts):
            fast, ref = (tier_logits(params, cfg, prompt, forced[b], p)
                         for p in pols.values())
            g = max(g, float(np.abs(fast - ref).max()))
            top = max(top, float(np.abs(ref[:, :cfg.vocab]).max()))
        out[exp] = {"max_abs_gap": g, "max_abs_logit": top,
                    "relative": g / top}
        jax.clear_caches()
    line = {"arch": cfg.arch_id, "width": width, "d_model": cfg.d_model,
            "head_dim": cfg.hd, "n_layers": cfg.n_layers,
            "prompts": list(prompts_len), "tiers": "pallas vs reference",
            "steps": steps, "gap": out,
            "seconds": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=("phi3-medium-14b", "dbrx-132b",
                                       "h2o-danube3-4b"),
                    default="phi3-medium-14b")
    ap.add_argument("--width", choices=tuple(SHAPES), default="reduced")
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
