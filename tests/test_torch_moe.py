"""The MoE family (dbrx-132b and grok-1-314b, ``.reduced()``) through both
packages, on the CPU.

* ``models.moe.moe_apply`` against ``repro.models.moe.moe_apply`` on the
  same weights and inputs under every exp backend, for dbrx's SwiGLU
  experts and grok's GELU ones: at s = 1 (a decode step: capacity 8),
  at a prefill width where a planted router sends every token to the
  same two experts, so capacity binds and choices are dropped, and with
  a router whose columns tie, where the top-k must take the lower
  expert index first as ``jax.lax.top_k`` does (every token then ties,
  so capacity binds there too). The routing (experts,
  weights) is compared with the JAX package's as well as the output.
* ``top_k`` on planted ties gives ``jax.lax.top_k``'s indices
  (``torch.topk`` does not where four values tie).
* dbrx ``.reduced()`` end to end: the ragged prefill, teacher-forced
  decode steps (contiguous and paged) and two chunks of a chunked
  prefill, against ``repro.models.transformer`` through its api.
* The bridge carries the reference's ``layers.moe`` tree (the router and
  the stacked experts rounded to the compute dtype).
* Under the cuda tier a layer's router exp and gate exp are one call of
  the vexp kernel's wrapper each.
* The port's own identities through ``Server``: batched == solo, paged
  == contiguous (block_s at the page), chunked == one-shot (no row's
  capacity binds at these lengths), and the decode step keeps its carry
  in place (``graph_audit.audit_step``).

Tolerance, as ``test_torch_dense_swiglu.py`` sets it: in f32 compute
both packages compute the same function up to the order of f32 sums,
F32_TOL = 1e-4; in bf16 compute the frameworks round activations at
different places, LOGIT_REL = 0.02 of max(1, max |logit|). Where the
routing of the two packages could differ, at a near tie of two
probabilities, the f32 run would show it: none does on these inputs.
Greedy tokens must agree wherever the JAX top-2 gap exceeds twice the
limit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import resolve_policy as jax_policy  # noqa: E402
from repro_torch.analysis import graph_audit  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
ARCHS = ("dbrx-132b", "grok-1-314b")
LOGIT_REL = 0.02
F32_TOL = 1e-4
# f32 under the approximate exps: vexp_hw rounds its argument to bf16 and
# vexp is piecewise, so an f32 ulp between the packages' arguments can
# cross one of their steps and move an exp by a step (a bf16 ulp for
# vexp_hw); measured here up to 1.24e-3 on logits of ~3.6 (one chunk lane,
# vexp_hw, the jump in an attention layer's output), 1.4e-4 under vexp
F32_STEP_TOL = 2e-3
# a routing decision may differ between the packages only where the JAX
# router's probabilities of two neighbouring choices are within this log
# gap (twice the bf16 logit limit; measured flips: gaps <= 0.017)
ROUTE_TIE = 2 * LOGIT_REL
B, S, STEPS = 3, 24, 4
PLEN = np.array([24, 9, 17], np.int32)
C, OFFS, CLENS = 8, ([0, 0, 0], [8, 5, 8]), ([8, 5, 8], [8, 0, 3])
PAGE = 8
BIND_S = 32                   # capacity 24 a row: 8 of 32 choices dropped


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


_MODELS: dict = {}


def _models(arch, dtype="bfloat16"):
    """(jcfg, jax params, cfg, port params) on the same weights."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jax_config(arch).reduced(),
                                   compute_dtype=dtype)
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  compute_dtype=dtype)
        jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _MODELS[key] = (jcfg, jp, cfg, tp)
    return _MODELS[key]


# ------------------------------------------------------------ top-k

TIES = {
    "four_equal": [0.1, 0.3, 0.3, 0.05, 0.3, 0.2, 0.3, 0.0],
    "all_equal": [0.125] * 8,
    "pairs": [0.2, 0.1, 0.2, 0.1, 0.05, 0.2, 0.05, 0.1],
}


@pytest.mark.parametrize("case", sorted(TIES))
def test_top_k_takes_lax_top_k_order_on_ties(case):
    p = np.asarray(TIES[case], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(p), 3)
    gv, gi = moe.top_k(torch.from_numpy(p), 3)
    assert gi.tolist() == np.asarray(wi).tolist()
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    if case == "four_equal":          # what the stable sort is there for
        assert torch.topk(torch.from_numpy(p), 3).indices.tolist() \
            != gi.tolist()


# ------------------------------------------------------------ moe_apply

def _layer_inputs(arch, dtype, s, kind):
    """(jcfg, cfg, x in JAX, x in torch, JAX layer-0 MoE params, the port's
    ``MoE``) on the same values, x (B, s, D) and the params in the
    compute dtype (the JAX ones cast as the reference's layer entry casts
    them); ``kind`` "random", "bind" (every token prefers experts 0 and
    1) or "tie" (router columns 1..E-1 equal, above column 0)."""
    jcfg, jp, cfg, tp = _models(arch, dtype)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    router = np.asarray(jp["layers"]["moe"]["router"][0], np.float32)
    if kind == "bind":
        x = x + 3.0
        router = router * 0.1
        router[:, 0] += 0.05
        router[:, 1] += 0.03
    elif kind == "tie":
        x = x + 3.0
        router = np.repeat(router[:, 1:2] * 0.1 + 0.04, cfg.n_experts, 1)
        router[:, 0] = 0.0
    cdt = getattr(jnp, cfg.compute_dtype)
    jmp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    jmp = dict(jmp, router=jnp.asarray(router))
    jmp = jax.tree.map(lambda a: a.astype(cdt), jmp)
    tmod = moe.MoE(cfg, torch.Generator(), getattr(torch, cfg.compute_dtype),
                   "cpu")
    tmod.load_state_dict(tp.layers[0].moe.state_dict())
    tmod.router.data.copy_(torch.from_numpy(np.array(_np(jmp["router"]))))
    xd = jnp.asarray(x).astype(cdt)
    return jcfg, cfg, xd, torch.from_numpy(np.array(_np(xd))).to(
        getattr(torch, cfg.compute_dtype)), jmp, tmod


def _jax_moe(jcfg, x, jmp):
    """(output, routing weights, experts) of the reference's MoE layer
    under ``jcfg``'s exp, as one compiled program."""
    from repro.core.softmax import softmax as jsoftmax
    from repro.core.vexp import get_exp_fn as jexp

    def run(x, p):
        out, _ = jmoe.moe_apply(x, p, jcfg)
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        probs = jsoftmax(logits, axis=-1, exp_impl=jexp(jcfg.exp_impl))
        w, i = jax.lax.top_k(probs, jcfg.top_k)
        return out, w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9), i
    out, w, i = jax.jit(run)(x, jmp)
    return _np(out), _np(w), np.asarray(i)


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("case", ["decode", "bind", "tie"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_apply_matches_jax(dtype, arch, case, exp):
    """One layer's MoE on the same input and weights: the routing (expert
    indices exactly, weights to 1e-6), whether any choice was dropped,
    and the output within F32_TOL in f32, LOGIT_REL x max(1, max |out|)
    in bf16."""
    s = 1 if case == "decode" else BIND_S
    kind = "random" if case == "decode" else case
    jcfg, cfg, xj, xt, jmp, tmod = _layer_inputs(arch, dtype, s, kind)
    pol = jax_policy(jcfg, env={}, exp_backend=exp, kernel_backend="reference")
    w, ww, wi = _jax_moe(jcfg.with_policy(pol), xj, jmp)
    tpol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend="cuda")
    got = moe.moe_apply(xt, tmod, cfg, policy=tpol)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    # the routing, then the output
    _, gw, gi = moe.route(xt, tmod.router, cfg, tpol)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gw.numpy(), ww, atol=1e-6, rtol=1e-6)
    _, keep, _ = moe._dispatch(gi, moe.capacity(s, cfg), cfg.n_experts)
    assert bool(keep.all()) == (case == "decode")   # the others drop
    g = _np(got)
    tol = F32_TOL if dtype == "float32" else \
        LOGIT_REL * max(1.0, float(np.abs(w).max()))
    assert np.abs(g - w).max() <= tol, (np.abs(g - w).max(), tol)


def test_capacity_and_dispatch_shapes():
    """The reference's capacity (8 at s = 1, rounded up to 8), and the
    dispatch's static shapes: kept slots unique and in range, a dropped
    choice never lands in a bucket, empty buckets name the dummy row."""
    cfg = get_config("dbrx-132b")
    assert moe.capacity(1, cfg) == 8 and moe.capacity(1024, cfg) == 320
    assert moe.capacity(256, cfg) == 80 and moe.capacity(64, cfg) == 24
    red = cfg.reduced()
    idx = torch.zeros(2, 40, red.top_k, dtype=torch.int64)
    idx[..., 1] = 1
    cap = moe.capacity(40, red)
    slot, keep, buckets = moe._dispatch(idx, cap, red.n_experts)
    assert buckets.shape == (2, red.n_experts * cap)
    assert int(keep.sum()) == 2 * 2 * cap
    for b in range(2):
        kept = slot[b][keep[b]]
        assert len(set(kept.tolist())) == len(kept) and int(kept.max()) < \
            red.n_experts * cap
    assert int((buckets == 40).sum()) == 2 * (red.n_experts - 2) * cap


def test_router_and_gate_exps_one_call_each(monkeypatch):
    """Under the cuda tier a MoE layer calls the vexp kernel's wrapper
    twice: the router softmax's exp on (B, S, E) f32 logits and the
    SwiGLU gate's exp on the (E, B * cap, F) expert pre-activations."""
    from repro_torch.kernels import vexp as kvexp
    _, _, cfg, tp = _models("dbrx-132b")
    calls = []
    orig = kvexp.vexp

    def counting(x, *, policy):
        calls.append((tuple(x.shape), x.dtype))
        return orig(x, policy=policy)
    monkeypatch.setattr(kvexp, "vexp", counting)
    api.prefill(tp, cfg, {"tokens": np.zeros((2, 6), np.int32)},
                policy=resolve_policy(cfg, env={}, kernel_backend="cuda"),
                device="cpu")
    cap = moe.capacity(6, cfg)
    assert calls == [((2, 6, cfg.n_experts), torch.float32),
                     ((cfg.n_experts, 2 * cap, cfg.d_ff), torch.float32)] \
        * cfg.n_layers


# ------------------------------------------------------------ the model

def _inputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    forced = rng.integers(0, 512, (STEPS, B, 1)).astype(np.int32)
    chunks = [rng.integers(0, 512, (B, C)).astype(np.int32) for _ in OFFS]
    ns = -(-(S + STEPS) // PAGE)
    tab = (1 + rng.permutation(B * ns)).reshape(B, ns).astype(np.int32)
    return toks, forced, chunks, tab


def _pools(cache, tab):
    ns = tab.shape[1]
    out = {}
    for name in ("k", "v"):
        c = _np(cache[name])
        c = np.pad(c, ((0, 0), (0, 0), (0, ns * PAGE - c.shape[2]), (0, 0),
                       (0, 0)))
        pool = np.zeros((c.shape[0], 1 + tab.size, PAGE) + c.shape[3:],
                        np.float32)
        for b in range(B):
            for si in range(ns):
                pool[:, tab[b, si]] = c[:, b, si * PAGE:(si + 1) * PAGE]
        out[name] = torch.from_numpy(pool).to(torch.bfloat16)
    return out


class Routes:
    """The JAX package's router probabilities, recorded call by call per
    path (``record``), and the port's routing forced to the JAX
    package's decisions and weights (``force``), so that the logits
    compare the rest of the computation. Where a port call's own top-k
    (indices and order) differs from the JAX one, ``flips`` keeps the
    JAX probabilities' smallest log gap between neighbours among the
    first k + 1 there: how near a tie the decision was."""

    def __init__(self):
        self.rec, self.path, self.flips, self.calls = {}, None, [], 0

    def use(self, path):
        self.path, self.queue = path, list(self.rec.get(path, []))

    def record(self, monkeypatch):
        from repro.core.softmax import softmax as jsoftmax
        from repro.core.vexp import get_exp_fn as jexp
        from repro.models import transformer as jtransformer
        orig = jtransformer.moe_apply

        def wrapped(x, p, cfg):
            logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
            probs = jsoftmax(logits, axis=-1, exp_impl=jexp(cfg.exp_impl))
            jax.debug.callback(lambda pr: self.rec.setdefault(
                self.path, []).append(np.array(pr)), probs, ordered=True)
            return orig(x, p, cfg)
        monkeypatch.setattr(jtransformer, "moe_apply", wrapped)

    def force(self, monkeypatch):
        orig = moe.top_k

        def forced(probs, k):
            jp = self.queue.pop(0)
            assert jp.shape == tuple(probs.shape)
            order = np.argsort(-jp, axis=-1, kind="stable")[..., :k + 1]
            own = orig(probs, k)[1].numpy()
            ps = np.log(np.take_along_axis(jp, order, -1))
            gap = (ps[..., :-1] - ps[..., 1:]).min(-1)
            self.flips.extend(gap[(own != order[..., :k]).any(-1)].tolist())
            self.calls += 1
            return (torch.from_numpy(np.take_along_axis(
                jp, order[..., :k], -1).copy()),
                torch.from_numpy(order[..., :k].copy()))
        monkeypatch.setattr(moe, "top_k", forced)


def _run(pkg, dtype, exp, tier=None, cache0=None, routes=None):
    """{path: [logits, ...]} of the ragged prefill and STEPS teacher-forced
    decode steps (from ``cache0``, the JAX prefill's cache, where given),
    the same steps on a shuffled page pool (port only; the reference
    tier's paged step gathers the pages into the contiguous step), and
    two chunks of a chunked prefill. ``routes`` (a ``Routes``, already
    recording or forcing) is told which path each call belongs to.
    Returns (paths, prefill cache)."""
    jcfg, jp, cfg, tp = _models("dbrx-132b", dtype)
    toks, forced, chunks, tab = _inputs()
    use = routes.use if routes is not None else (lambda path: None)
    out = {}
    if pkg == "jax":
        pol = jax_policy(jcfg, env={}, exp_backend=exp,
                         kernel_backend="reference")
        use("prefill")
        lg, cache = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "prompt_len": jnp.asarray(PLEN)},
                                 policy=pol)
        cache_np = {k: _np(v) for k, v in cache.items()}
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
                 for k, v in cache.items()}
        step = jax.jit(lambda p, t, c, ps: japi.decode_step(
            p, jcfg, t, c, ps, policy=pol))
        chunk = jax.jit(lambda p, t, c, o, n: japi.prefill_chunk(
            p, jcfg, t, c, o, n, policy=pol))
        out["decode"], pos = [lg], PLEN.copy()
        use("decode")
        for t in range(STEPS):
            lg, cache = step(jp, jnp.asarray(forced[t]), cache,
                             jnp.asarray(pos))
            out["decode"].append(lg)
            pos = pos + 1
        out["paged"] = out["decode"][1:]
        cc = {k: v.astype(jcfg.compute_dtype)
              for k, v in japi.init_cache(jcfg, B, 2 * C).items()}
        out["chunk"] = []
        use("chunk")
        for tk, off, cl in zip(chunks, OFFS, CLENS):
            lg, cc = chunk(jp, jnp.asarray(tk), cc, jnp.asarray(off),
                           jnp.asarray(cl))
            out["chunk"].append(lg)
        jax.effects_barrier()
    else:
        pol = resolve_policy(cfg, env={}, exp_backend=exp,
                             kernel_backend=tier)
        use("prefill")
        lg, cache = api.prefill(tp, cfg, {"tokens": toks,
                                          "prompt_len": PLEN},
                                policy=pol, device="cpu")
        cache_np = {k: _np(v) for k, v in cache.items()}
        if cache0 is not None:
            cache = {k: torch.tensor(v).to(torch.bfloat16)
                     for k, v in cache0.items()}
        pools = _pools(cache, tab)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, STEPS))
                 for k, v in cache.items()}
        out["decode"], out["paged"] = [lg], []
        use("decode")
        for t in range(STEPS):
            lg, cache = api.decode_step(tp, cfg, forced[t], cache,
                                        PLEN + t, policy=pol, device="cpu")
            out["decode"].append(lg)
        use("decode")
        for t in range(STEPS):
            lg, pools = api.decode_step_paged(tp, cfg, forced[t], pools, tab,
                                              PLEN + t, policy=pol,
                                              device="cpu")
            out["paged"].append(lg)
        cc = {k: v.to(getattr(torch, cfg.compute_dtype)) for k, v in
              api.init_cache(cfg, B, 2 * C, device="cpu").items()}
        out["chunk"] = []
        use("chunk")
        for tk, off, cl in zip(chunks, OFFS, CLENS):
            lg, cc = api.prefill_chunk(tp, cfg, tk, cc, np.array(off),
                                       np.array(cl), policy=pol,
                                       device="cpu")
            out["chunk"].append(lg)
    return {k: [_np(x) for x in v] for k, v in out.items()}, cache_np


def _compare(got, want, limit_of):
    for path in want:
        for i, (g, w) in enumerate(zip(got[path], want[path])):
            if path == "chunk":
                rows = np.asarray(CLENS[i]) > 0
                g, w = g[rows], w[rows]
            assert g.shape == w.shape and np.isfinite(g).all()
            lim = limit_of(w)
            d = float(np.abs(g - w).max())
            assert d <= lim, (path, i, d, lim)
            # greedy tokens agree wherever the JAX top-2 gap is no tie
            top2 = np.sort(w[:, 0], -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 2 * lim
            assert (g[:, 0].argmax(-1) == w[:, 0].argmax(-1))[clear].all()


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dbrx_paths_match_jax(dtype, exp, monkeypatch):
    """Every path with the port's routing forced to the JAX package's
    (``Routes``), so that a routing flip at a near tie does not hide or
    stand in for a difference elsewhere: bf16 within LOGIT_REL x max(1,
    max |logit|) on both tiers; f32 (the decode steps from the JAX
    prefill's bf16 cache, the chunks on an f32 pool) within F32_TOL under
    exact and F32_STEP_TOL under vexp / vexp_hw. Every routing decision
    the port makes on its own equals the JAX one unless the JAX router's
    probabilities there are within ROUTE_TIE of a tie (log gap)."""
    routes = Routes()
    routes.record(monkeypatch)
    want, cache = _run("jax", dtype, exp, routes=routes)
    assert {k: len(v) for k, v in routes.rec.items()} == {
        "prefill": 2, "decode": 2 * STEPS, "chunk": 2 * len(OFFS)}
    routes.force(monkeypatch)
    if dtype == "float32":
        tol = F32_TOL if exp == "exact" else F32_STEP_TOL
        got, _ = _run("port", dtype, exp, "reference", cache, routes)
        _compare(got, want, lambda w: tol)
    else:
        for tier in ("cuda", "reference"):
            got, _ = _run("port", dtype, exp, tier, routes=routes)
            _compare(got, want, lambda w: LOGIT_REL * max(
                1.0, float(np.abs(w).max())))
    assert all(g <= ROUTE_TIE for g in routes.flips), routes.flips


def test_bridge_carries_the_moe_tree():
    jcfg, jp, cfg, tp = _models("dbrx-132b")
    jm = jp["layers"]["moe"]
    for i, blk in enumerate(tp.layers):
        assert not hasattr(blk, "mlp")
        assert blk.moe.router.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            blk.moe.router.float().numpy(),
            _np(jnp.asarray(jm["router"][i], jnp.bfloat16)))
        for name in ("wg", "wu", "wd"):
            t = getattr(blk.moe.experts, name)
            assert t.shape[0] == cfg.n_experts and t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.float().numpy(),
                _np(jnp.asarray(jm["experts"][name][i], jnp.bfloat16)))
    np.testing.assert_array_equal(tp.unembed.numpy(),
                                  np.asarray(jp["unembed"], np.float32))
    g = _models("grok-1-314b")[3]
    assert not hasattr(g.layers[0].moe.experts, "wg")


# ------------------------------------------------ the engine identities

LENS = (21, 9, 4, 17, 12)


def _serve(cfg, params, prompts, *, max_batch=3, max_new=6, **pol):
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


def test_engine_identities():
    """Five requests through three slots: batched == each served alone
    (decode is per row; no row's capacity binds at these lengths, so
    the wave's width does not change a row's routing); the paged pool
    (block_s at the page) == the contiguous pool; chunked (8) ==
    one-shot."""
    _, _, cfg, tp = _models("dbrx-132b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in LENS]
    batched, srv = _serve(cfg, tp, prompts)
    assert srv.stats()["default"]["admit_waves"] >= 2
    solo = [_serve(cfg, tp, [p], max_batch=1)[0][0] for p in prompts]
    assert batched == solo
    contig, _ = _serve(cfg, tp, prompts, block_s=PAGE)
    paged, _ = _serve(cfg, tp, prompts, block_s=PAGE, paged=True)
    assert paged == contig
    chunked, srv = _serve(cfg, tp, prompts, prefill_chunk=8)
    assert srv.stats()["default"]["prefill_chunks"] >= 3
    assert chunked == batched


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_decode_carry_in_place(paged):
    """The MoE decode step writes its carry in place (what lets it be one
    CUDA graph): every tick keeps each carry tensor's storage."""
    _, _, cfg, tp = _models("dbrx-132b")
    pol = resolve_policy(cfg, env={}, exp_backend="vexp", block_page=PAGE)
    srv = Server(cfg, tp, max_batch=2, max_seq=64, policy=pol, paged=paged,
                 device="cpu")
    rng = np.random.default_rng(1)
    for i, n in enumerate((5, 11, 7)):
        srv.submit(Request(i, rng.integers(0, cfg.vocab, (n,),
                                           dtype=np.int32), 4))
    g = srv._groups["default"]
    srv.step()
    ticks = 0
    while g.busy:
        graph_audit.audit_step(g.state, g.last, g.live_dev, step=srv.step)
        ticks += 1
    assert ticks >= 4 and len(srv.admit_log) == 3


def test_serve_cli_runs_dbrx_reduced(capsys):
    serve.main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu",
                "--requests", "3", "--mixed-lengths", "--prompt-len", "12",
                "--max-new", "3", "--max-seq", "32",
                "--policy-groups", "eval=exact,hw=vexp_hw"])
    out = capsys.readouterr().out
    assert "[serve] model: dbrx-132b (reduced), 2 layers" in out
    assert "served 3 requests on cpu, 9 tokens" in out
