"""Reduced mamba2-1.3b (the ssm family) through both packages.

The JAX package's ``api.init_params`` arrays cross over as numpy through
``bridge.params_from_numpy``; the same numpy inputs go through
``repro.models.ssm`` (run directly: the SSM reaches no Pallas kernel) and
the port's ``models.ssm``, under every exp backend, with the port on its
``cuda`` tier (the kernels' plain versions, on the CPU).

* The gates (``layers.py:90-106``): ``vexp_sigmoid`` and ``vexp_silu``
  bitwise under vexp and vexp_hw (f32, and bf16 for SiLU), and
  ``vexp_softplus`` within SOFTPLUS_ULP (its exp is bitwise; ``log1p`` is
  each framework's own libm); under exact, the port and the reference
  each within EXACT_GATE_ULP of the float64 truth where it and the exp
  inside are normal numbers (each exp within the 2-ulp rule of
  ``test_torch_vexp.py``, plus the rounding of the gate's own few
  operations; where exp(-|x|) is subnormal the f32 formula itself keeps
  only a few bits, in both packages).
* ``ssm_layer_apply`` (plain, ragged, and resumed from ``h0`` /
  ``conv_state``), ``ssm_layer_decode``, ``prefill``, ``prefill_chunk``
  and ``decode_step``.

  Tolerance. In f32 compute (``compute_dtype="float32"``) the two
  packages agree to F32_TOL: the functions are the same, and only the
  order of f32 sums differs. In the configured bf16 compute, activations
  carry 8 significant bits and the frameworks round at different places
  (XLA's fused bf16 chains keep excess precision), which moves a logit
  by a few 1e-2: LOGIT_TOL = 0.05, from test_torch_model.py's 0.02 on
  gpt2's logits of magnitude ~0.8, scaled to these logits of magnitude
  ~4-5 (the untied f32 unembedding); states within STATE_TOL, the
  (h, conv) of bf16 inputs of magnitude ~1-4. Each test prints its
  measured max.
* The port's own identities: the chunked SSD equals the sequential
  recurrence (f32 compute, exact exp, F32_TOL: under vexp and vexp_hw
  exp(a) exp(b) != exp(a + b), and the two forms factor the decays
  differently); chunked prefill on ``ssm_chunk``
  boundaries equals monolithic prefill bit for bit; a row a decode step
  parks, or a chunk leaves inert, keeps its (h, conv) bit for bit; the
  two forms' logits (teacher-forced decode against one forward) within
  FORM_RATIO times the JAX package's own gap between them at this size
  (FORM_GAP: ``tools/ssm_form_gap.py`` reads 0.0116 / 0.0245 / 0.0233
  under exact / vexp / vexp_hw); the gap comes from the approximate
  exps' exp(a) exp(b) != exp(a + b) and bf16 rounding, so the test asks
  the same order, not the same digits.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.runtime import resolve_policy as jax_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.models import api, layers, ssm  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402

EXP_BACKENDS = ("exact", "vexp", "vexp_hw")
LOGIT_TOL = 0.05
STATE_TOL = 0.05
F32_TOL = 1e-4
SOFTPLUS_ULP = 2
EXACT_GATE_ULP = 4
FORM_GAP = {"exact": 0.0116, "vexp": 0.0245, "vexp_hw": 0.0233}
FORM_RATIO = 2.0
B, S = 3, 40                     # S: two full SSD blocks and a partial
PLEN = np.array([40, 9, 23], np.int32)


def _cfgs(dtype=None):
    jcfg = jax_config("mamba2-1.3b").reduced()
    cfg = get_config("mamba2-1.3b").reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return jcfg, cfg


def _models(dtype=None):
    jcfg, cfg = _cfgs(dtype)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def models_f32():
    return _models("float32")


def _pols(jcfg, cfg, exp):
    return (jax_policy(jcfg, env={}, exp_backend=exp,
                       kernel_backend="reference"),
            resolve_policy(cfg, env={}, exp_backend=exp,
                           kernel_backend="cuda"))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _maxdiff(a, b):
    return float(np.abs(_np(a) - torch.as_tensor(b).float().numpy()).max())


def _tokens(seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


# ------------------------------------------------------------------ gates

def _gate_inputs():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(size=50_000) * 4,
                           rng.normal(size=50_000) * 30,
                           np.linspace(-100, 100, 20_001),
                           [0.0, -0.0, 1e-30, -1e-30]]).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("exp", ["vexp", "vexp_hw"])
def test_gates_bitwise(exp):
    x = _gate_inputs()
    for name in ("vexp_sigmoid", "vexp_silu", "vexp_softplus"):
        want = _np(getattr(jlayers, name)(jnp.asarray(x), jax_exp(exp)))
        got = getattr(layers, name)(torch.from_numpy(x),
                                    get_exp_fn(exp)).numpy()
        ulp = np.abs(_bits(got) - _bits(want))
        print(f"{exp} {name}: {int((ulp > 0).sum())} differ, max "
              f"{int(ulp.max())} ulp")
        limit = SOFTPLUS_ULP if name == "vexp_softplus" else 0
        assert ulp.max() <= limit, name
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _np(jlayers.vexp_silu(xb, jax_exp(exp)))
    got = layers.vexp_silu(torch.from_numpy(x).to(torch.bfloat16),
                           get_exp_fn(exp))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def _truth(name, x):
    x = x.astype(np.float64)
    e = np.exp(-np.abs(x))
    sig = np.where(x >= 0, 1 / (1 + e), e / (1 + e))
    if name == "vexp_sigmoid":
        return sig
    if name == "vexp_silu":
        return x * sig
    return np.maximum(x, 0) + np.log1p(e)


def test_gates_exact_against_float64():
    x = _gate_inputs()
    tiny = np.finfo(np.float32).tiny
    for name in ("vexp_sigmoid", "vexp_silu", "vexp_softplus"):
        true = _truth(name, x).astype(np.float32)
        normal = (np.abs(true) >= tiny) & (np.exp(-np.abs(x.astype(
            np.float64))) >= tiny)
        for who, got in (
                ("torch", getattr(layers, name)(torch.from_numpy(x),
                                                get_exp_fn("exact")).numpy()),
                ("XLA", _np(getattr(jlayers, name)(jnp.asarray(x),
                                                   jax_exp("exact"))))):
            ulp = np.abs(_bits(got[normal]) - _bits(true[normal]))
            print(f"exact {name} {who}: max {int(ulp.max())} ulp")
            assert ulp.max() <= EXACT_GATE_ULP, (name, who)
            sub = np.abs(true) < tiny
            assert (np.abs(got[sub]) < tiny).all(), (name, who)


# ------------------------------------------------------------ layer level

def _jax_layer(jp, jcfg, i=0):
    dt = jnp.dtype(jcfg.compute_dtype)
    lp = jax.tree.map(lambda a: a[i], jp["layers"])
    return jax.tree.map(lambda a: a.astype(dt)
                        if a.dtype == jnp.float32 and a.ndim > 1 else a, lp)


def _layer_inputs(cfg, dtype):
    rng = np.random.default_rng(1)
    di, nh, ds, ng, conv_dim = ssm.ssm_dims(cfg)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    h0 = (rng.normal(size=(B, nh, cfg.ssm_headdim, ds)) * 0.5).astype(
        np.float32)
    conv = np.array(jnp.asarray(rng.normal(
        size=(B, cfg.conv_width - 1, conv_dim)).astype(np.float32))
        .astype(jnp.bfloat16).astype(jnp.float32))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx, h0, conv


VARIANTS = ("plain", "ragged", "resumed")


def _layer_pair(models, exp, variant):
    jcfg, jp, cfg, tp = models
    jpol, tpol = _pols(jcfg, cfg, exp)
    jx, tx, h0, conv = _layer_inputs(cfg, cfg.compute_dtype)
    kw_j, kw_t = {}, {}
    if variant != "plain":
        kw_j = dict(return_state=True, prompt_len=jnp.asarray(PLEN))
        kw_t = dict(return_state=True, prompt_len=torch.from_numpy(PLEN))
    if variant == "resumed":
        kw_j.update(h0=jnp.asarray(h0), conv_state=jnp.asarray(conv))
        kw_t.update(h0=torch.from_numpy(h0), conv_state=torch.from_numpy(conv))
    want = jax.jit(lambda x, p, kw: jssm.ssm_layer_apply(
        x, p, jcfg, policy=jpol, return_state=variant != "plain", **kw))(
        jx, _jax_layer(jp, jcfg),
        {k: v for k, v in kw_j.items() if k != "return_state"})
    got = ssm.ssm_layer_apply(tx, tp.layers[0], cfg, policy=tpol, **kw_t)
    if variant == "plain":
        want, got = (want, None), (got, None)
    return want, got


def _check_pair(want, got, tol, what):
    d_out = _maxdiff(want[0], got[0])
    assert got[0].dtype == torch.as_tensor(got[0]).dtype
    if want[1] is None:
        print(f"{what}: out {d_out:.3g}")
        assert d_out <= tol, what
        return
    d_h = _maxdiff(want[1]["h"], got[1]["h"])
    d_c = _maxdiff(want[1]["conv"], got[1]["conv"])
    print(f"{what}: out {d_out:.3g} h {d_h:.3g} conv {d_c:.3g}")
    assert got[1]["h"].dtype == got[1]["conv"].dtype == torch.float32
    assert max(d_out, d_h, d_c) <= tol, what


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_layer_apply(models, exp, variant):
    want, got = _layer_pair(models, exp, variant)
    assert got[0].dtype == torch.bfloat16
    _check_pair(want, got, STATE_TOL, f"layer {exp} {variant}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_layer_apply_f32(models_f32, variant):
    """f32 compute: the same function up to the order of f32 sums."""
    want, got = _layer_pair(models_f32, "vexp", variant)
    _check_pair(want, got, F32_TOL, f"layer f32 {variant}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_layer_decode(models, models_f32, exp, dtype):
    jcfg, jp, cfg, tp = models if dtype == "bfloat16" else models_f32
    jpol, tpol = _pols(jcfg, cfg, exp)
    jx, tx, h0, conv = _layer_inputs(cfg, dtype)
    want = jax.jit(lambda x, p, st: jssm.ssm_layer_decode(
        x, p, jcfg, st, policy=jpol))(
        jx[:, :1], _jax_layer(jp, jcfg),
        {"h": jnp.asarray(h0), "conv": jnp.asarray(conv)})
    state = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv)}
    got = ssm.ssm_layer_decode(tx[:, :1], tp.layers[0], cfg, state,
                               policy=tpol)
    assert torch.equal(state["h"], torch.from_numpy(h0))   # writes nothing
    _check_pair(want, got, STATE_TOL if dtype == "bfloat16" else F32_TOL,
                f"decode layer {exp} {dtype}")


# ------------------------------------------------------------ model level

_JAX = {}


def _jax_model_run(models, exp):
    """The reference's ragged prefill, two teacher-forced decode steps,
    and a chunked prefill (two 16-token chunks, one row inert in the
    second) of the same prompts (computed once per backend)."""
    if exp in _JAX:
        return _JAX[exp]
    jcfg, jp, cfg, _ = models
    jpol, _ = _pols(jcfg, cfg, exp)
    toks = _tokens()
    logits, state = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "prompt_len": jnp.asarray(PLEN)},
                                 policy=jpol)
    out = {"prefill": (_np(logits), jax.tree.map(_np, state)), "decode": []}
    forced = _tokens(2, (2, B, 1))
    for t in range(2):
        logits, state = japi.decode_step(jp, jcfg, jnp.asarray(forced[t]),
                                         state, jnp.asarray(PLEN + t),
                                         policy=jpol)
        out["decode"].append((_np(logits), jax.tree.map(_np, state)))
    cache = japi.init_cache(jcfg, B, S)
    out["chunks"] = []
    for toks_c, clens in _chunks():
        logits, cache = japi.prefill_chunk(
            jp, jcfg, jnp.asarray(toks_c), cache, jnp.zeros(B, jnp.int32),
            jnp.asarray(clens), policy=jpol)
        out["chunks"].append((_np(logits), jax.tree.map(_np, cache)))
    _JAX[exp] = out
    return out


def _chunks():
    toks = _tokens(3, (B, 32))
    return [(toks[:, :16], np.array([16, 16, 7], np.int32)),
            (toks[:, 16:], np.array([16, 0, 16], np.int32))]


def _check_model(want, got, what):
    d_l = _maxdiff(want[0], got[0])
    d_h = _maxdiff(want[1]["h"], got[1]["h"])
    d_c = _maxdiff(want[1]["conv"], got[1]["conv"])
    print(f"{what}: logits {d_l:.3g} h {d_h:.3g} conv {d_c:.3g}")
    assert d_l <= LOGIT_TOL and max(d_h, d_c) <= STATE_TOL, what


@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_prefill_and_decode(models, exp):
    jcfg, jp, cfg, tp = models
    want = _jax_model_run(models, exp)
    _, pol = _pols(jcfg, cfg, exp)
    logits, state = api.prefill(tp, cfg, {"tokens": _tokens(),
                                          "prompt_len": PLEN},
                                policy=pol, device="cpu")
    _check_model(want["prefill"], (logits, state), f"prefill {exp}")
    forced = _tokens(2, (2, B, 1))
    for t in range(2):
        logits, got = api.decode_step(tp, cfg, forced[t], state, PLEN + t,
                                      policy=pol, device="cpu")
        assert got is state                       # written in place
        _check_model(want["decode"][t], (logits, state), f"decode {exp} {t}")


@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_prefill_chunk(models, exp):
    jcfg, jp, cfg, tp = models
    want = _jax_model_run(models, exp)
    _, pol = _pols(jcfg, cfg, exp)
    cache = api.init_cache(cfg, B, S, device="cpu")
    for i, (toks_c, clens) in enumerate(_chunks()):
        before = {k: v.clone() for k, v in cache.items()}
        logits, got = api.prefill_chunk(tp, cfg, toks_c, cache,
                                        np.zeros(B, np.int32), clens,
                                        policy=pol, device="cpu")
        assert got is cache
        _check_model(want["chunks"][i], (logits, cache), f"chunk {exp} {i}")
        for name in cache:                         # inert rows bit for bit
            for b in np.flatnonzero(clens == 0):
                assert torch.equal(cache[name][:, b], before[name][:, b])


def test_api_refuses_what_ssm_lacks(models):
    _, _, cfg, tp = models
    pol = resolve_policy(cfg, env={})
    cache = api.init_cache(cfg, B, S, device="cpu")
    toks = _tokens(shape=(B, 8))
    with pytest.raises(ValueError, match="all-lanes"):
        api.prefill_chunk(tp, cfg, toks, cache, np.zeros(B), np.ones(B),
                          policy=pol, all_lanes=True, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        api.prefill_chunk_paged(tp, cfg, toks, cache, None, None, None,
                                policy=pol, device="cpu")
    with pytest.raises(ValueError, match="page"):
        api.init_paged_cache(cfg, 8, 8, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        api.decode_step_paged(tp, cfg, toks[:, :1], cache, None, 0,
                              policy=pol, device="cpu")
    with pytest.raises(ValueError, match="history"):
        api.prefill(tp, cfg, {"tokens": toks, "hist": {}}, policy=pol,
                    device="cpu")
    assert set(ssm.state_axes(cfg)) == {"h", "conv"}
    assert cache["h"].shape == (cfg.n_layers, B, cfg.ssm_nheads,
                                cfg.ssm_headdim, cfg.ssm_state)


def test_gate_exp_resolution():
    """``exp_callable``: under the cuda tier the vexp kernel's wrapper
    (its plain version on a CPU tensor, bitwise), under reference and
    eager the plain function; with no policy it raises, and the layer
    functions take no default, so a gate on a CUDA tensor never runs the
    plain chain of torch ops in place of the kernel."""
    from repro_torch.kernels import vexp as kvexp
    from repro_torch.kernels.dispatch import exp_callable
    cfg = get_config("mamba2-1.3b").reduced()
    x = torch.linspace(-20.0, 0.0, 97)
    for exp in EXP_BACKENDS:
        pol = resolve_policy(cfg, env={}, exp_backend=exp)
        assert pol.kernel_backend == "cuda"
        fn = exp_callable(pol)
        assert fn.func is kvexp.vexp and fn.keywords["policy"] is pol
        assert torch.equal(fn(x), get_exp_fn(exp)(x))
        for tier in ("reference", "eager"):
            got = exp_callable(pol.replace(kernel_backend=tier))
            assert got is get_exp_fn(exp)
    with pytest.raises(ValueError, match="ExecPolicy"):
        exp_callable(None)
    with pytest.raises(TypeError, match="policy"):
        ssm.ssm_layer_decode(None, None, cfg, None)
    with pytest.raises(TypeError, match="policy"):
        ssm.ssm_layer_apply(None, None, cfg)


# --------------------------------------------------- the port's identities

def test_chunked_ssd_equals_recurrence(models_f32):
    """One layer's chunked scan over 40 tokens against 40 single-token
    decode steps from the zero state (f32 compute): outputs and final
    state within F32_TOL."""
    _, _, cfg, tp = models_f32
    pol = resolve_policy(cfg, env={}, exp_backend="exact")
    _, tx, _, _ = _layer_inputs(cfg, "float32")
    out, st = ssm.ssm_layer_apply(tx, tp.layers[0], cfg, return_state=True,
                                  policy=pol)
    di, nh, ds, ng, conv_dim = ssm.ssm_dims(cfg)
    state = {"h": torch.zeros(B, nh, cfg.ssm_headdim, ds),
             "conv": torch.zeros(B, cfg.conv_width - 1, conv_dim)}
    steps = []
    for t in range(S):
        y, state = ssm.ssm_layer_decode(tx[:, t:t + 1], tp.layers[0], cfg,
                                        state, policy=pol)
        steps.append(y)
    d = max(float((out - torch.cat(steps, 1)).abs().max()),
            float((st["h"] - state["h"]).abs().max()),
            float((st["conv"] - state["conv"]).abs().max()))
    print(f"chunked vs sequential: {d:.3g}")
    assert d <= F32_TOL


@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_chunked_prefill_equals_monolithic(models, exp):
    """Two chunks of ``ssm_chunk`` tokens then a ragged third against one
    prefill of the whole prompts: logits and (h, conv) bit for bit."""
    _, _, cfg, tp = models
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend="cuda")
    q = cfg.ssm_chunk
    plen = np.array([40, 33, 16], np.int32)
    toks = _tokens(5, (B, 3 * q))
    for b in range(B):
        toks[b, plen[b]:] = 0
    mono, mstate = ssm.prefill(tp, cfg, torch.from_numpy(toks),
                               prompt_len=torch.from_numpy(plen), policy=pol)
    state = ssm.init_cache(cfg, B, None, "cpu")
    last = None
    for c in range(3):
        clens = np.clip(plen - c * q, 0, q).astype(np.int32)
        logits, _ = ssm.prefill_chunk(
            tp, cfg, torch.from_numpy(toks[:, c * q:(c + 1) * q]), state,
            None, torch.from_numpy(clens), policy=pol)
        done = clens > 0
        last = logits if last is None else torch.where(
            torch.from_numpy(done)[:, None, None], logits, last)
    assert torch.equal(last, mono)
    for name in ("h", "conv"):
        assert torch.equal(state[name], mstate[name]), name


@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_parked_row_keeps_its_state(models, exp):
    """decode_step with a dead row: the row's (h, conv) bit for bit, the
    live rows' equal to an unmasked step's."""
    _, _, cfg, tp = models
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend="cuda")
    _, state = ssm.prefill(tp, cfg, torch.from_numpy(_tokens()),
                           prompt_len=torch.from_numpy(PLEN), policy=pol)
    free = {k: v.clone() for k, v in state.items()}
    before = {k: v.clone() for k, v in state.items()}
    tok = torch.from_numpy(_tokens(6, (B, 1)))
    ssm.decode_step(tp, cfg, tok, state, None, policy=pol,
                    live=torch.tensor([1, 0, 1], dtype=torch.int32))
    ssm.decode_step(tp, cfg, tok, free, None, policy=pol)
    for name in state:
        assert torch.equal(state[name][:, 1], before[name][:, 1])
        for b in (0, 2):
            assert torch.equal(state[name][:, b], free[name][:, b])


@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_two_forms_within_the_reference_gap(models, exp):
    """Teacher-forced decode logits against one forward over prompt +
    tokens: the port's gap between the SSD's two forms within FORM_RATIO
    times the JAX package's own (FORM_GAP)."""
    _, _, cfg, tp = models
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend="cuda")
    prompt = _tokens(7, (1, 21))
    forced = _tokens(8, (1, 12))
    logits, state = ssm.prefill(tp, cfg, torch.from_numpy(prompt),
                                policy=pol)
    dec = [logits[0, 0]]
    for t in range(forced.shape[1] - 1):
        logits, _ = ssm.decode_step(tp, cfg,
                                    torch.from_numpy(forced[:, t:t + 1]),
                                    state, None, policy=pol)
        dec.append(logits[0, 0])
    seq = torch.from_numpy(np.concatenate([prompt, forced[:, :-1]], axis=1))
    h = ssm.forward(tp, cfg, seq, policy=pol)
    full = ssm._logits(tp, cfg, h)[0, prompt.shape[1] - 1:]
    d = float((torch.stack(dec) - full).abs().max())
    print(f"{exp}: decode vs forward {d:.3g}, the JAX package's "
          f"{FORM_GAP[exp]}")
    assert d <= FORM_RATIO * FORM_GAP[exp]
