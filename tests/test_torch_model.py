"""Reduced gpt2-small through both packages on the same weights.

The JAX package's ``api.init_params`` arrays cross over as numpy through
``bridge.params_from_numpy``. Ragged prefill logits and teacher-forced
``decode_step`` logits of the port's ``reference`` tier and of its
``cuda`` tier (the kernels' plain versions, on the CPU) are held to the
JAX ``reference`` tier under every exp backend.

Tolerance: |logit difference| <= LOGIT_TOL. Activations are bf16 in both
packages (8 significant bits), and the two frameworks round at different
places (bf16 matmul outputs, GELU, the order of f32 sums), which moves a
logit of magnitude ~1 by a few 1e-3 (measured max 7.9e-3 at this size);
the cuda tier adds the flash-decode kernel's bf16 casts of q and p. Near-
tie rule: a greedy token must match wherever the JAX top-2 logit gap
exceeds 2 * LOGIT_TOL, since a smaller gap can flip legitimately.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import resolve_policy as jax_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402

LOGIT_TOL = 0.02
B, S, STEPS = 3, 24, 3
PLEN = np.array([24, 9, 17], np.int32)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("gpt2-small").reduced()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("gpt2-small").reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    forced = rng.integers(0, 512, (STEPS, B, 1)).astype(np.int32)
    return toks, forced


_JAX = {}


def _jax_run(models, inputs, exp):
    """JAX reference-tier logits: ragged prefill, then STEPS
    teacher-forced decode steps (computed once per exp backend)."""
    if exp not in _JAX:
        jcfg, jp, _, _ = models
        toks, forced = inputs
        pol = jax_policy(jcfg, env={}, exp_backend=exp,
                         kernel_backend="reference")
        logits, cache = japi.prefill(
            jp, jcfg, {"tokens": jnp.asarray(toks),
                       "prompt_len": jnp.asarray(PLEN)}, policy=pol)
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
                 for k, v in cache.items()}
        out = [np.asarray(logits)]
        pos = PLEN.copy()
        for t in range(STEPS):
            logits, cache = japi.decode_step(jp, jcfg, jnp.asarray(forced[t]),
                                             cache, jnp.asarray(pos),
                                             policy=pol)
            out.append(np.asarray(logits))
            pos = pos + 1
        _JAX[exp] = out
    return _JAX[exp]


def _port_run(models, inputs, exp, tier):
    _, _, cfg, tp = models
    toks, forced = inputs
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend=tier)
    logits, cache = api.prefill(tp, cfg, {"tokens": toks, "prompt_len": PLEN},
                                policy=pol, device="cpu")
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, STEPS))
             for k, v in cache.items()}
    out = [logits.numpy()]
    pos = PLEN.copy()
    for t in range(STEPS):
        logits, cache = api.decode_step(tp, cfg, forced[t], cache, pos,
                                        policy=pol, device="cpu")
        out.append(logits.numpy())
        pos = pos + 1
    return out, cache


@pytest.mark.parametrize("tier", ["reference", "cuda"])
@pytest.mark.parametrize("exp", ["exact", "vexp", "vexp_hw"])
def test_prefill_and_decode_logits_match_jax(models, inputs, exp, tier):
    want = _jax_run(models, inputs, exp)
    got, cache = _port_run(models, inputs, exp, tier)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, 1, 512)
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= LOGIT_TOL, step
        # greedy tokens under the near-tie rule
        srt = np.sort(w[:, 0], axis=-1)
        clear = srt[:, -1] - srt[:, -2] > 2 * LOGIT_TOL
        np.testing.assert_array_equal(g[clear, 0].argmax(-1),
                                      w[clear, 0].argmax(-1))
    # pad K/V rows of the ragged prefill are zero (past the rows the
    # decode steps wrote)
    k = cache["k"].float()
    for b, n in enumerate(PLEN):
        assert (k[:, b, n + STEPS:S] == 0).all()


def test_forward_hidden_states_match_jax(models):
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)
    want = np.asarray(japi.forward(
        jp, jcfg, {"tokens": jnp.asarray(toks)},
        policy=jax_policy(jcfg, env={}, kernel_backend="reference")),
        np.float32)
    got = api.forward(tp, cfg, {"tokens": toks},
                      policy=resolve_policy(cfg, env={},
                                            kernel_backend="reference"),
                      device="cpu").float().numpy()
    # final-layernorm outputs (unit scale, bf16): a few bf16 ulps
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.02)


def test_bridge_checks_layer_count(models):
    jcfg, jp, cfg, _ = models
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError):
        params_from_numpy(tree, dataclasses.replace(cfg, n_layers=3),
                          device="cpu")


def test_decode_step_parks_dead_rows(models):
    """live == 0 rows leave their cache rows untouched; live rows write."""
    _, _, cfg, tp = models
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    before = cache["k"].clone()
    api.decode_step(tp, cfg, np.array([[3], [4]], np.int32), cache,
                    np.array([2, 5], np.int32), live=np.array([1, 0]),
                    policy=resolve_policy(cfg, env={}), device="cpu")
    assert not torch.equal(cache["k"][:, 0, 2], before[:, 0, 2])
    assert torch.equal(cache["k"][:, 1], before[:, 1])
