"""The SwiGLU dense decoder with untied embeddings (phi3-medium-14b)
through both packages, on the CPU.

* The SwiGLU MLP (``models.layers.mlp_apply``) against the JAX
  package's: its gate, ``vexp_silu``, bit for bit under vexp and vexp_hw
  on the same pre-activations (f32 and bf16), within EXACT_GATE_ULP of
  the float64 truth under exact, as ``test_torch_ssm.py`` holds the SSM
  gates; the whole MLP in f32 within F32_TOL; the gate's exp resolved
  through ``kernels.dispatch.exp_callable`` (the policy is required).
* Untied embeddings: the bridge carries ``unembed``, and the logits are
  the f32 product with it (not with ``embed.T``).
* Ragged prefill, teacher-forced decode steps, chunked prefill and paged
  decode steps against ``repro.models.transformer`` under every exp
  backend (the paged steps against the JAX reference tier's contiguous
  steps, which its paged step equals: it gathers the pages and runs the
  same one-pass decode), at two sizes: ``phi3-medium-14b.reduced()``
  (4 heads on 4 KV heads, head dim 32: G 1) and the same with one KV
  head of head dim 128 (G 4, phi3's group and head dim).
* The engine identities of the reduced model through ``Server``:
  batched == solo, chunked == one-shot, paged == contiguous.

Tolerance. In f32 compute (``compute_dtype="float32"``, both packages on
their reference tiers) the functions are the same and only the order of
f32 sums differs: F32_TOL = 1e-4. In the configured bf16 compute the
frameworks round activations at different places, which moves a logit by
about 1 % of its magnitude (``test_torch_model.py``: 7.9e-3 on gpt2's
logits of ~0.8; here ~0.035 on logits of ~3, the untied f32
unembedding's scale): LOGIT_REL = 0.02 of max(1, max |logit|), the same
0.02 as gpt2's limit on logits of magnitude <= 1, and the scaling
``test_torch_ssm.py`` applies to its untied logits. The port's cuda tier
(the kernels' plain versions on CPU tensors) and its reference tier are
both held to the JAX reference tier in bf16.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.vexp import get_exp_fn as jax_exp  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.runtime import resolve_policy as jax_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api, layers, transformer  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402

ARCH = "phi3-medium-14b"
EXPS = ("exact", "vexp", "vexp_hw")
LOGIT_REL = 0.02
F32_TOL = 1e-4
EXACT_GATE_ULP = 4
# the reduced config (G 1, head dim 32) and phi3's group and head dim
SIZES = {"g1_d32": {}, "g4_d128": {"n_kv_heads": 1, "head_dim": 128}}
B, S, STEPS = 3, 24, 3
PLEN = np.array([24, 9, 17], np.int32)
C, OFFS, CLENS = 8, ([0, 0, 0], [8, 5, 8]), ([8, 5, 8], [8, 0, 3])
PAGE = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


_MODELS: dict = {}


def _models(size, dtype="bfloat16"):
    """(jcfg, jax params, cfg, port params) on the same weights."""
    key = (size, dtype)
    if key not in _MODELS:
        kw = dict(SIZES[size], compute_dtype=dtype)
        jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **kw)
        cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
        jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _MODELS[key] = (jcfg, jp, cfg, tp)
    return _MODELS[key]


def _inputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    forced = rng.integers(0, 512, (STEPS, B, 1)).astype(np.int32)
    chunks = [rng.integers(0, 512, (B, C)).astype(np.int32) for _ in OFFS]
    ns = -(-(S + STEPS) // PAGE)
    tab = (1 + rng.permutation(B * ns)).reshape(B, ns).astype(np.int32)
    return toks, forced, chunks, tab


def _pools(cache, tab):
    """A prefill cache (L, B, S, Hkv, hd) laid into a page pool through
    ``tab`` (page 0 the scratch page)."""
    ns = tab.shape[1]
    out = {}
    for name in ("k", "v"):
        c = np.asarray(_np(cache[name]))
        c = np.pad(c, ((0, 0), (0, 0), (0, ns * PAGE - c.shape[2]), (0, 0),
                       (0, 0)))
        pool = np.zeros((c.shape[0], 1 + tab.size, PAGE) + c.shape[3:],
                        np.float32)
        for b in range(B):
            for si in range(ns):
                pool[:, tab[b, si]] = c[:, b, si * PAGE:(si + 1) * PAGE]
        out[name] = pool
    return out


def _run(pkg, size, dtype, exp, tier, cache0=None):
    """Logits of every path through one package: the ragged prefill and
    STEPS teacher-forced decode steps, two chunks of a chunked prefill
    on a contiguous pool, and STEPS paged decode steps over the prefill's
    KV laid into a shuffled page pool; the decode steps start from
    ``cache0`` (a prefill cache as numpy) where given, else from the
    package's own prefill. Returns ({path: [logits, ...]}, the prefill
    cache as numpy)."""
    jcfg, jp, cfg, tp = _models(size, dtype)
    toks, forced, chunks, tab = _inputs()
    out = {}
    if pkg == "jax":
        pol = jax_policy(jcfg, env={}, exp_backend=exp,
                         kernel_backend="reference")
        lg, cache = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "prompt_len": jnp.asarray(PLEN)},
                                 policy=pol)
        cache_np = {k: _np(v) for k, v in cache.items()}
        if cache0 is not None:
            cache = {k: jnp.asarray(v, jnp.bfloat16)
                     for k, v in cache0.items()}
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
                 for k, v in cache.items()}
        # one compiled program for the steps (and one for the chunks)
        step = jax.jit(lambda p, t, c, ps: japi.decode_step(
            p, jcfg, t, c, ps, policy=pol))
        chunk = jax.jit(lambda p, t, c, o, n: japi.prefill_chunk(
            p, jcfg, t, c, o, n, policy=pol))
        out["decode"], pos = [lg], PLEN.copy()
        for t in range(STEPS):
            lg, cache = step(jp, jnp.asarray(forced[t]), cache,
                             jnp.asarray(pos))
            out["decode"].append(lg)
            pos = pos + 1
        # the reference tier's paged step gathers the pages and runs the
        # same one-pass decode: its logits are the contiguous steps'
        out["paged"] = out["decode"][1:]
        # f32 compute: an f32 pool, so the chunk's own K/V reach its
        # attention unrounded in both packages
        cc = {k: v.astype(jcfg.compute_dtype)
              for k, v in japi.init_cache(jcfg, B, 2 * C).items()}
        out["chunk"] = []
        for tk, off, cl in zip(chunks, OFFS, CLENS):
            lg, cc = chunk(jp, jnp.asarray(tk), cc, jnp.asarray(off),
                           jnp.asarray(cl))
            out["chunk"].append(lg)
    else:
        pol = resolve_policy(cfg, env={}, exp_backend=exp,
                             kernel_backend=tier)
        lg, cache = api.prefill(tp, cfg, {"tokens": toks,
                                          "prompt_len": PLEN},
                                policy=pol, device="cpu")
        cache_np = {k: _np(v) for k, v in cache.items()}
        if cache0 is not None:
            cache = {k: torch.tensor(v).to(torch.bfloat16)
                     for k, v in cache0.items()}
        pools = {k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in _pools(cache, tab).items()}
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, STEPS))
                 for k, v in cache.items()}
        out["decode"], pos = [lg], PLEN.copy()
        out["paged"], ppos = [], PLEN.copy()
        for t in range(STEPS):
            lg, cache = api.decode_step(tp, cfg, forced[t], cache, pos,
                                        policy=pol, device="cpu")
            out["decode"].append(lg)
            lg, pools = api.decode_step_paged(tp, cfg, forced[t], pools, tab,
                                              ppos, policy=pol, device="cpu")
            out["paged"].append(lg)
            pos, ppos = pos + 1, ppos + 1
        cc = {k: v.to(getattr(torch, cfg.compute_dtype)) for k, v in
              api.init_cache(cfg, B, 2 * C, device="cpu").items()}
        out["chunk"] = []
        for tk, off, cl in zip(chunks, OFFS, CLENS):
            lg, cc = api.prefill_chunk(tp, cfg, tk, cc, np.array(off),
                                       np.array(cl), policy=pol,
                                       device="cpu")
            out["chunk"].append(lg)
    return {k: [_np(x) for x in v] for k, v in out.items()}, cache_np


def _chunk_rows(i):
    """Rows that hold a valid lane in chunk i (the others' logits are
    garbage the engine never reads)."""
    return np.asarray(CLENS[i]) > 0


def _compare(got, want, limit_of):
    worst = {}
    for path in want:
        for i, (g, w) in enumerate(zip(got[path], want[path])):
            if path == "chunk":
                g, w = g[_chunk_rows(i)], w[_chunk_rows(i)]
            assert g.shape == w.shape and np.isfinite(g).all()
            d, lim = float(np.abs(g - w).max()), limit_of(w)
            worst[path] = max(worst.get(path, 0.0), d)
            assert d <= lim, (path, i, d, lim)
    print(worst)


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("size", sorted(SIZES))
def test_paths_match_jax_bf16(size, exp):
    want, _ = _run("jax", size, "bfloat16", exp, None)
    for tier in ("cuda", "reference"):
        got, _ = _run("port", size, "bfloat16", exp, tier)
        _compare(got, want, lambda w: LOGIT_REL * max(1.0,
                                                      float(np.abs(w).max())))


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("size", sorted(SIZES))
def test_paths_match_jax_f32(size, exp):
    """f32 compute: the decode steps of both packages start from the
    JAX prefill's bf16 cache, and the chunks run on an f32 pool, since an
    f32 ulp between the two packages' K or V can round to a bf16 ulp in
    a bf16 cache and move a logit by ~1e-4 (the prefill logits
    themselves are compared)."""
    want, cache = _run("jax", size, "float32", exp, None)
    got, _ = _run("port", size, "float32", exp, "reference", cache)
    _compare(got, want, lambda w: F32_TOL)


# ------------------------------------------------------------ the MLP

def _gate_inputs():
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal(size=40_000) * 4,
                           rng.normal(size=20_000) * 30,
                           np.linspace(-100, 100, 10_001),
                           [0.0, -0.0, 1e-30, -1e-30]]).astype(np.float32)


@pytest.mark.parametrize("exp", ["vexp", "vexp_hw"])
def test_swiglu_gate_bitwise(exp):
    """vexp_silu on the same pre-activations: every f32 output and every
    bf16 output bit for bit with the JAX package's."""
    x = _gate_inputs()
    want = _np(jlayers.vexp_silu(jnp.asarray(x), jax_exp(exp)))
    got = layers.vexp_silu(torch.from_numpy(x), get_exp_fn(exp)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _np(jlayers.vexp_silu(xb, jax_exp(exp)))
    got = layers.vexp_silu(torch.from_numpy(x).to(torch.bfloat16),
                           get_exp_fn(exp))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_swiglu_gate_exact_within_ulps_of_float64():
    x = _gate_inputs()
    xd = x.astype(np.float64)
    e = np.exp(-np.abs(xd))
    true = (xd * np.where(xd >= 0, 1 / (1 + e), e / (1 + e))).astype(
        np.float32)
    tiny = np.finfo(np.float32).tiny
    normal = (np.abs(true) >= tiny) & (e >= tiny)
    got = layers.vexp_silu(torch.from_numpy(x), get_exp_fn("exact")).numpy()
    ulp = np.abs(_bits(got[normal]) - _bits(true[normal]))
    assert ulp.max() <= EXACT_GATE_ULP


@pytest.mark.parametrize("exp", EXPS)
def test_swiglu_mlp_matches_jax(exp):
    """One layer's SwiGLU MLP in f32 on the same weights and inputs, the
    gate's exp through the policy's callable (the cuda tier's vexp
    wrapper, whose plain version runs on CPU tensors)."""
    jcfg, jp, cfg, tp = _models("g4_d128", "float32")
    x = np.random.default_rng(2).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    jmlp = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    want = _np(jlayers.mlp_apply(jnp.asarray(x), jmlp, "swiglu",
                                 policy=jax_policy(jcfg, env={},
                                                   exp_backend=exp)))
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend="cuda")
    got = layers.mlp_apply(torch.from_numpy(x), tp.layers[0].mlp, "swiglu",
                           policy=pol).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    with pytest.raises(TypeError):
        layers.mlp_apply(torch.from_numpy(x), tp.layers[0].mlp, "swiglu")


def test_swiglu_gate_takes_one_exp_call_a_layer(monkeypatch):
    """Under the cuda tier each SwiGLU layer's gate is one call of the
    vexp kernel's wrapper (one launch on the card): a prefill of the
    reduced model calls it n_layers times."""
    from repro_torch.kernels import vexp as kvexp
    _, _, cfg, tp = _models("g1_d32")
    calls = []
    orig = kvexp.vexp

    def counting(x, *, policy):
        calls.append(tuple(x.shape))
        return orig(x, policy=policy)
    monkeypatch.setattr(kvexp, "vexp", counting)
    api.prefill(tp, cfg, {"tokens": np.zeros((2, 6), np.int32)},
                policy=resolve_policy(cfg, env={}, kernel_backend="cuda"),
                device="cpu")
    assert calls == [(2, 6, cfg.d_ff)] * cfg.n_layers


# ------------------------------------------------ untied embeddings

def test_bridge_and_logits_carry_the_unembedding():
    jcfg, jp, cfg, tp = _models("g1_d32")
    assert not cfg.tie_embeddings and jcfg.tie_embeddings is False
    np.testing.assert_array_equal(tp.unembed.numpy(),
                                  np.asarray(jp["unembed"], np.float32))
    np.testing.assert_array_equal(tp.layers[1].mlp.wg.float().numpy(),
                                  _np(jnp.asarray(jp["layers"]["mlp"]["wg"][1],
                                                  jnp.bfloat16)))
    x = torch.randn(2, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    want = x @ tp.unembed
    got = transformer._logits(tp, cfg, x)
    assert torch.equal(got[..., :cfg.vocab], want[..., :cfg.vocab])
    assert not torch.equal(got[..., :cfg.vocab],
                           (x @ tp.embed.T)[..., :cfg.vocab])
    # the tied family keeps no unembedding
    g2 = get_config("gpt2-small").reduced()
    assert not hasattr(api.init_params(g2, 0, device="cpu"), "unembed")
    assert REGISTRY[ARCH].hd == 128 and REGISTRY[ARCH].act == "swiglu"


# ------------------------------------------------ the engine identities

LENS = (21, 9, 4, 17, 12)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _serve(cfg, params, prompts, *, max_batch=3, max_new=8, **pol):
    pol.setdefault("block_page", PAGE)
    paged = pol.pop("paged", False)
    policy = resolve_policy(cfg, env={}, kernel_backend="cuda", **pol)
    srv = Server(cfg, params, max_batch=max_batch, max_seq=64, policy=policy,
                 device="cpu", paged=paged)
    reqs = [Request(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    srv.run(reqs)
    srv.assert_idle_clean()
    assert all(r.finish_reason == "max_new" for r in reqs)
    return [list(r.out) for r in reqs], srv


@pytest.mark.parametrize("size", sorted(SIZES))
def test_engine_identities(size):
    """Five requests through three slots (two admitted into freed
    slots): batched == each served alone; chunked prefill (8) == one-shot
    admission; the paged pool (8-token pages, block_s at the page so both
    compute one function) == the contiguous pool."""
    _, _, cfg, tp = _models(size)
    prompts = _prompts(cfg, LENS)
    batched, srv = _serve(cfg, tp, prompts)
    assert srv.stats()["default"]["admit_waves"] >= 2
    solo = [_serve(cfg, tp, [p], max_batch=1)[0][0] for p in prompts]
    assert batched == solo
    chunked, srv = _serve(cfg, tp, prompts, prefill_chunk=8)
    assert srv.stats()["default"]["prefill_chunks"] >= 3
    assert chunked == batched
    contig, _ = _serve(cfg, tp, prompts, block_s=PAGE)
    paged, srv = _serve(cfg, tp, prompts, block_s=PAGE, paged=True)
    assert paged == contig
    assert srv.stats()["default"]["pool"]["pages_used"] == 0
