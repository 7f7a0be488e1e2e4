"""Reduced recurrentgemma-9b (the hybrid family) through both packages.

The JAX package's ``api.init_params`` arrays cross over as numpy through
``bridge.params_from_numpy``; the same numpy inputs go through
``repro.models.hybrid`` (jitted, on its ``reference`` tier: the hybrid's
attention reaches no Pallas kernel there) and the port's
``models.hybrid`` on its ``cuda`` tier (the kernels' plain versions, on
the CPU), under every exp backend. The reduced config: 4 layers (one
period of rec, rec, attn and one tail layer), d 128, lru 128, 4 heads of
32 on one KV head, window 16.

* ``_assoc_scan`` is ``jax.lax.associative_scan``'s combine tree: the
  exp calls of one scan have the same shapes in the same order in both
  packages, at even and odd lengths; the summed log decays agree bit for
  bit (adds in the same tree) and the states within F32_TOL (XLA may
  fuse the combine's multiply-add into one rounding).
* The gate exps: on the same inputs, the sigmoids of r and i, exp(log a)
  and exp(2 log a) bit for bit under vexp and vexp_hw.
* ``_rg_lru`` (with and without ``h0``, with ``last_idx``),
  ``rec_layer_apply`` (resumed from a carried (h, conv), ragged) and
  ``rec_layer_decode``, in f32 compute: within F32_TOL.
* ``forward``, ``prefill`` (ragged at the window; a uniform prompt longer
  than the window, whose ring is rolled), ``decode_step`` over 12 steps
  that wrap the 16-slot ring with a parked row, ``decode_step_paged``
  over ring tables of 8-token pages, ``prefill_chunk`` and
  ``prefill_chunk_paged`` over two chunks, in the configured bf16
  compute: every state leaf within STATE_TOL (test_torch_ssm.py's:
  activations carry 8 significant bits and the frameworks round at
  different places), logits within LOGIT_TOL = 0.1, ``chip_smoke.py``'s
  tier tolerance (REPLAY_LOGIT_TOL): test_torch_ssm.py's 0.05 is for the
  last position's logits, and over every position of a 16-token forward
  the hybrid's bf16 logits (max |logit| ~4.3, each recurrent layer's
  scan output rounded to bf16) read 0.051-0.057, its other paths at most
  0.045; the parked row's recurrent rows bit for bit. In f32 compute,
  both packages on their reference tiers, the same calls within F32_TOL
  (readings ~1e-5).
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
from repro.models import hybrid as jhyb  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.runtime import resolve_policy as jax_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.kernels.dispatch import exp_callable  # noqa: E402
from repro_torch.models import hybrid, layers  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402

EXP_BACKENDS = ("exact", "vexp", "vexp_hw")
LOGIT_TOL = 0.1
STATE_TOL = 0.05
F32_TOL = 1e-4
KV_ULP_TOL = 2.0 ** -5           # one bf16 ulp of a K/V entry below 4
B, W = 3, 16                       # rows; the reduced window
PLEN = np.array([16, 5, 11], np.int32)
STEPS = 12                         # decode steps: rows 0 and 1 wrap
LIVE = np.array([1, 1, 0], np.int32)
PAGE = 8


def _cfgs(dtype=None):
    jcfg = jax_config("recurrentgemma-9b").reduced()
    cfg = get_config("recurrentgemma-9b").reduced()
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


def _pols(jcfg, cfg, exp, tier="cuda"):
    return (jax_policy(jcfg, env={}, exp_backend=exp,
                       kernel_backend="reference"),
            resolve_policy(cfg, env={}, exp_backend=exp,
                           kernel_backend=tier))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _maxdiff(a, b):
    return float(np.abs(_np(a) - torch.as_tensor(b).float().numpy()).max())


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def _flat(c):
    """The JAX package's nested hybrid state as the port's flat leaves."""
    return {"rec_h": c["periods"]["rec_h"],
            "rec_conv": c["periods"]["rec_conv"],
            "k": c["periods"]["k"], "v": c["periods"]["v"],
            "tail_h": c["tail"]["h"], "tail_conv": c["tail"]["conv"]}


def _nested(flat):
    def leaf(n):
        return jnp.asarray(flat[n], jnp.bfloat16 if n in ("k", "v")
                           else jnp.float32)
    return {"periods": {n: leaf(n) for n in ("rec_h", "rec_conv", "k",
                                             "v")},
            "tail": {"h": leaf("tail_h"), "conv": leaf("tail_conv")}}


def _torch_state(flat):
    return {n: torch.from_numpy(np.array(_np(t))).to(
        torch.bfloat16 if n in ("k", "v") else torch.float32)
        for n, t in flat.items()}


def _assert_state(jstate, tstate, tol, what, kv_tol=None):
    """Every leaf within ``tol``; the bf16 K/V rings within ``kv_tol``
    (default ``tol``)."""
    for name, t in _flat(jstate).items():
        d = _maxdiff(t, tstate[name])
        print(f"{what} {name}: {d:.3g}")
        lim = kv_tol if kv_tol is not None and name in ("k", "v") else tol
        assert d <= lim, (what, name, d)


# ------------------------------------------------------------ the scan

@pytest.mark.parametrize("exp", EXP_BACKENDS)
@pytest.mark.parametrize("n", [16, 13])
def test_assoc_scan_is_the_jax_combine_tree(exp, n):
    """The same exp calls, by shape and order, as jax.lax.associative_scan
    makes; summed decays bit for bit, states within F32_TOL."""
    rng = np.random.default_rng(n)
    la = -np.abs(rng.normal(size=(2, n, 8))).astype(np.float32)
    b = rng.normal(size=(2, n, 8)).astype(np.float32)
    jcalls, tcalls = [], []
    jfn, tfn = jax_exp(exp), get_exp_fn(exp)

    def jrec(x):
        jcalls.append(tuple(x.shape))
        return jfn(x)

    def trec(x):
        tcalls.append(tuple(x.shape))
        return tfn(x)

    def combine(e1, e2):
        (la1, b1), (la2, b2) = e1, e2
        return la1 + la2, jrec(la2) * b1 + b2

    # traced once: the combine runs on tracers of the real shapes
    jl, jb = jax.jit(lambda x, y: jax.lax.associative_scan(
        combine, (x, y), axis=1))(jnp.asarray(la), jnp.asarray(b))
    tl, tb = hybrid._assoc_scan(torch.from_numpy(la), torch.from_numpy(b),
                                trec)
    assert [c for c in jcalls if c[1]] == tcalls
    assert len(tcalls) == hybrid.scan_exps(n)
    assert np.array_equal(_np(jl), tl.numpy())
    assert _maxdiff(jb, tb) <= F32_TOL


@pytest.mark.parametrize("exp", ["vexp", "vexp_hw"])
def test_gate_exps_bitwise(models, exp):
    """The RG-LRU's gate exps on the same inputs: bit for bit."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(4)
    pre = (rng.normal(size=(3, 7, 128)) * 3).astype(np.float32)
    lam = np.asarray(jp["tail"]["lam"][0]).astype(np.float32)
    _, tpol = _pols(jcfg, cfg, exp)
    texp = exp_callable(tpol)
    jsig = _np(jlayers.vexp_sigmoid(jnp.asarray(pre), jax_exp(exp)))
    tsig = layers.vexp_sigmoid(torch.from_numpy(pre), texp).numpy()
    assert np.array_equal(jsig, tsig)
    log_a = (hybrid.RG_LRU_C * jsig
             * np.asarray(-jnp.logaddexp(0.0, -jnp.asarray(lam))))
    for arg in (log_a, 2.0 * log_a):
        want = _np(jax_exp(exp)(jnp.asarray(arg.astype(np.float32))))
        got = texp(torch.from_numpy(arg.astype(np.float32))).numpy()
        assert np.array_equal(want, got)


# ------------------------------------------------------------ layer level

def _jax_rec(jp, jcfg):
    dt = jnp.dtype(jcfg.compute_dtype)
    return jhyb._cast(jax.tree.map(lambda a: a[0], jp["tail"]), dt)


def _layer_inputs(seed=1, s=13):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(B, s, 128)).astype(np.float32),
            "h0": rng.normal(size=(B, 128)).astype(np.float32),
            "conv": rng.normal(size=(B, 3, 128)).astype(np.float32),
            "plen": np.array([s, 4, 9], np.int32)}


@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_rg_lru_and_layers_f32(models_f32, exp):
    jcfg, jp, cfg, tp = models_f32
    jpol, tpol = _pols(jcfg, cfg, exp)
    jl, tl = _jax_rec(jp, jcfg), tp.tail[0]
    inp = _layer_inputs()
    x, h0 = inp["x"], inp["h0"]
    last = inp["plen"] - 1
    for kw in ({}, {"h0": h0}, {"h0": h0, "last_idx": last}):
        jy, jh = jax.jit(lambda xx, p, hh, li: jhyb._rg_lru(
            xx, p, jcfg, h0=hh, last_idx=li, policy=jpol))(
                jnp.asarray(x), jl,
                None if "h0" not in kw else jnp.asarray(h0),
                None if "last_idx" not in kw else jnp.asarray(last))
        ty, th = hybrid._rg_lru(
            torch.from_numpy(x), tl, cfg,
            None if "h0" not in kw else torch.from_numpy(h0),
            None if "last_idx" not in kw else torch.from_numpy(last),
            policy=tpol)
        print(exp, sorted(kw), _maxdiff(jy, ty), _maxdiff(jh, th))
        assert _maxdiff(jy, ty) <= F32_TOL and _maxdiff(jh, th) <= F32_TOL
    plen = inp["plen"]
    jy, (jh, jc) = jax.jit(lambda xx, p, hh, cc, li, vl: jhyb.rec_layer_apply(
        xx, p, jcfg, h0=hh, conv_state=cc, last_idx=li, valid_len=vl,
        policy=jpol))(jnp.asarray(x), jl, jnp.asarray(h0),
                      jnp.asarray(inp["conv"]), jnp.asarray(plen - 1),
                      jnp.asarray(plen))
    ty, (th, tc) = hybrid.rec_layer_apply(
        torch.from_numpy(x), tl, cfg, h0=torch.from_numpy(h0),
        conv_state=torch.from_numpy(inp["conv"]),
        last_idx=torch.from_numpy(plen - 1),
        valid_len=torch.from_numpy(plen), policy=tpol)
    for a, b in ((jy, ty), (jh, th), (jc, tc)):
        assert _maxdiff(a, b) <= F32_TOL
    st = {"h": h0, "conv": inp["conv"]}
    jy, jst = jax.jit(lambda xx, p, ss: jhyb.rec_layer_decode(
        xx, p, jcfg, ss, policy=jpol))(
            jnp.asarray(x[:, :1]), jl,
            {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = hybrid.rec_layer_decode(torch.from_numpy(x[:, :1]), tl, cfg,
                                      {k: torch.from_numpy(v) for k, v in
                                       st.items()}, policy=tpol)
    assert _maxdiff(jy, ty) <= F32_TOL
    for k in st:
        assert _maxdiff(jst[k], tst[k]) <= F32_TOL


# ------------------------------------------------------------ model level

def _paged_from(flat, tables, n_pages):
    """A contiguous ring state's K/V moved into page pools through
    ``tables`` (B, W / PAGE): the same paged state for both packages."""
    out = {n: np.array(_np(t)) for n, t in flat.items()}
    for name in ("k", "v"):
        ring = out[name]                      # (n_per, B, W, Hkv, hd)
        pool = np.zeros((ring.shape[0], n_pages, PAGE) + ring.shape[3:],
                        np.float32)
        for b in range(ring.shape[1]):
            for c in range(tables.shape[1]):
                pool[:, tables[b, c]] = ring[:, b, c * PAGE:(c + 1) * PAGE]
        out[name] = pool
    return out


def _tables():
    ns = W // PAGE
    perm = np.random.default_rng(7).permutation(B * ns) + 1
    return perm.reshape(B, ns).astype(np.int32), 1 + B * ns


def _run_jax(jcfg, jp, pol):
    """Every JAX model-level reading of one backend, each program jitted
    once."""
    out = {}
    toks = _tokens((B, W))
    longt = _tokens((1, W + 8), seed=5)
    steps = _tokens((STEPS, B, 1), seed=2)
    fwd = jax.jit(lambda p, t: japi.forward(p, jcfg, {"tokens": t},
                                            policy=pol))
    h = fwd(jp, jnp.asarray(toks))
    out["forward"] = h.astype(jnp.float32) @ jp["unembed"]
    pre = jax.jit(lambda p, t, n: japi.prefill(
        p, jcfg, {"tokens": t, "prompt_len": n}, policy=pol))
    out["prefill"] = pre(jp, jnp.asarray(toks), jnp.asarray(PLEN))
    out["prefill_long"] = jax.jit(lambda p, t: japi.prefill(
        p, jcfg, {"tokens": t}, policy=pol))(jp, jnp.asarray(longt))
    dec = jax.jit(lambda p, t, c, pos, lv: japi.decode_step(
        p, jcfg, t, c, pos, policy=pol, live=lv))
    c, pos, lg = out["prefill"][1], PLEN.copy(), []
    for i in range(STEPS):
        logits, c = dec(jp, jnp.asarray(steps[i]), c, jnp.asarray(pos),
                        jnp.asarray(LIVE))
        lg.append(logits)
        pos = pos + LIVE
    out["decode"] = (lg, c)
    tables, n_pages = _tables()
    paged = _nested(_paged_from(_flat(out["prefill"][1]), tables, n_pages))
    decp = jax.jit(lambda p, t, c, tab, pos, lv: japi.decode_step_paged(
        p, jcfg, t, c, tab, pos, policy=pol, live=lv))
    c, pos, lg = paged, PLEN.copy(), []
    for i in range(STEPS):
        logits, c = decp(jp, jnp.asarray(steps[i]), c, jnp.asarray(tables),
                         jnp.asarray(pos), jnp.asarray(LIVE))
        lg.append(logits)
        pos = pos + LIVE
    out["decode_paged"] = (lg, c)
    chunk = jax.jit(lambda p, t, c, o, n: japi.prefill_chunk(
        p, jcfg, t, c, o, n, policy=pol))
    chunkp = jax.jit(lambda p, t, c, tab, o, n: japi.prefill_chunk_paged(
        p, jcfg, t, c, tab, o, n, policy=pol))
    c = japi.init_cache(jcfg, B, W)
    cp = japi.init_paged_cache(jcfg, B, n_pages, PAGE)
    lg, lgp = [], []
    for off, n, t in _chunks():
        logits, c = chunk(jp, jnp.asarray(t), c, jnp.asarray(off),
                          jnp.asarray(n))
        logp, cp = chunkp(jp, jnp.asarray(t), cp, jnp.asarray(tables),
                          jnp.asarray(off), jnp.asarray(n))
        lg.append(logits)
        lgp.append(logp)
    out["chunk"], out["chunk_paged"] = (lg, c), (lgp, cp)
    return out


def _chunks():
    """Two 8-lane chunks: rows at different cursors, a row inert in
    each."""
    t = _tokens((2, B, 8), seed=9)
    return [(np.array([0, 0, 0], np.int32), np.array([8, 5, 0], np.int32),
             t[0]),
            (np.array([8, 5, 0], np.int32), np.array([6, 0, 7], np.int32),
             t[1])]


def _run_port(cfg, tp, pol):
    out = {}
    toks = torch.from_numpy(_tokens((B, W)))
    longt = torch.from_numpy(_tokens((1, W + 8), seed=5))
    steps = torch.from_numpy(_tokens((STEPS, B, 1), seed=2))
    h = hybrid.forward(tp, cfg, toks, policy=pol)
    out["forward"] = h.float() @ tp.unembed
    out["prefill"] = hybrid.prefill(tp, cfg, toks,
                                    prompt_len=torch.from_numpy(PLEN),
                                    policy=pol)
    out["prefill_long"] = hybrid.prefill(tp, cfg, longt, policy=pol)
    st = {n: t.clone() for n, t in out["prefill"][1].items()}
    parked = {n: st[n][:, :, 2].clone() for n in ("rec_h", "rec_conv")}
    pos, lg = torch.from_numpy(PLEN.copy()), []
    live = torch.from_numpy(LIVE)
    for i in range(STEPS):
        logits, _ = hybrid.decode_step(tp, cfg, steps[i], st, pos,
                                       policy=pol, live=live)
        lg.append(logits)
        pos = pos + live
    out["decode"] = (lg, st)
    out["parked"] = all(torch.equal(parked[n], st[n][:, :, 2])
                        for n in parked)
    tables, n_pages = _tables()
    st = _torch_state(_paged_from(
        {n: t.float().numpy() for n, t in out["prefill"][1].items()},
        tables, n_pages))
    pos, lg = torch.from_numpy(PLEN.copy()), []
    for i in range(STEPS):
        logits, _ = hybrid.decode_step_paged(
            tp, cfg, steps[i], st, torch.from_numpy(tables), pos,
            policy=pol, live=live)
        lg.append(logits)
        pos = pos + live
    out["decode_paged"] = (lg, st)
    c = hybrid.init_cache(cfg, B, W, "cpu")
    cp = hybrid.init_paged_cache(cfg, B, n_pages, PAGE, "cpu")
    lg, lgp = [], []
    for off, n, t in _chunks():
        args = (torch.from_numpy(t),)
        logits, _ = hybrid.prefill_chunk(tp, cfg, *args, c,
                                         torch.from_numpy(off),
                                         torch.from_numpy(n), policy=pol)
        logp, _ = hybrid.prefill_chunk_paged(
            tp, cfg, *args, cp, torch.from_numpy(tables),
            torch.from_numpy(off), torch.from_numpy(n), policy=pol)
        lg.append(logits)
        lgp.append(logp)
    out["chunk"], out["chunk_paged"] = (lg, c), (lgp, cp)
    return out


_RUNS: dict = {}


def _runs(models, exp, tier="cuda"):
    jcfg, jp, cfg, tp = models
    key = (jcfg.compute_dtype, exp, tier)
    if key not in _RUNS:
        jpol, tpol = _pols(jcfg, cfg, exp, tier)
        _RUNS[key] = (_run_jax(jcfg, jp, jpol), _run_port(cfg, tp, tpol))
    return _RUNS[key]


def _compare(j, t, logit_tol, state_tol, kv_tol=None, vocab=512):
    def logits(a, b, what):
        d = _maxdiff(np.asarray(_np(a))[..., :vocab],
                     torch.as_tensor(b)[..., :vocab])
        print(f"{what} logits: {d:.3g}")
        assert d <= logit_tol, (what, d)

    logits(j["forward"], t["forward"], "forward")
    for name in ("prefill", "prefill_long"):
        logits(j[name][0], t[name][0], name)
        _assert_state(j[name][1], t[name][1], state_tol, name, kv_tol)
    for name in ("decode", "decode_paged", "chunk", "chunk_paged"):
        jl, jc = j[name]
        tl, tc = t[name]
        rows = slice(0, 2) if name.startswith("decode") else slice(None)
        for i, (a, b) in enumerate(zip(jl, tl)):
            if name.startswith("chunk"):   # rows with tokens this chunk
                n = _chunks()[i][1] > 0
                a, b = np.asarray(_np(a))[n], b[torch.from_numpy(n)]
            logits(np.asarray(_np(a))[rows], b[rows], f"{name} {i}")
        _assert_state(jc, tc, state_tol, name, kv_tol)


@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_model_matches_jax_bf16(models, exp):
    """forward, ragged and rolled prefill, a ring-wrapping decode with a
    parked row, paged decode and both chunk paths, in the configured
    bf16 compute."""
    j, t = _runs(models, exp)
    _compare(j, t, LOGIT_TOL, STATE_TOL)
    assert t["parked"]


def test_model_matches_jax_f32_reference_tier(models_f32):
    """The same calls in f32 compute, both packages on their reference
    tiers (f32 attention; the port's cuda-tier plain decode rounds q to
    the cache's bf16, as the kernel does), under exact. The rings hold
    bf16 K/V, which an f32 difference at a rounding boundary moves by one
    bf16 ulp: KV_ULP_TOL."""
    j, t = _runs(models_f32, "exact", tier="reference")
    _compare(j, t, F32_TOL, F32_TOL, kv_tol=KV_ULP_TOL)


def test_ragged_prefill_longer_than_window_raises(models):
    _, _, cfg, tp = models
    pol = resolve_policy(cfg, env={}, kernel_backend="cuda")
    with pytest.raises(ValueError, match="sliding window"):
        hybrid.prefill(tp, cfg, torch.zeros((2, W + 1), dtype=torch.int64),
                       prompt_len=torch.tensor([3, W + 1]), policy=pol)
