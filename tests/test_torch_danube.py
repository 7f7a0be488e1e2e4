"""The sliding-window dense decoder (h2o-danube3-4b) through both
packages, on the CPU.

* Ragged prefill, teacher-forced decode steps well past the ring's wrap
  (the cache is a ring of ``window`` slots: position p at slot p %
  window), chunked prefill on the contiguous ring and paged decode steps
  through a shuffled ring table against ``repro.models.transformer``
  under every exp backend, at two sizes: ``h2o-danube3-4b.reduced()``
  (4 heads on 4 KV heads, head dim 32, window 16: G 1) and the same with
  one KV head of head dim 120 (G 4, danube's group and head dim). The
  paged steps are held to the JAX reference tier's contiguous steps,
  which its paged step equals (it gathers the ring's pages and runs the
  same one-pass decode).
* Decode past the wrap against a windowed forward over the whole
  sequence (and not the window-less forward).
* The engine identities of the reduced model through ``Server`` with
  every request decoding past the wrap: batched == solo, paged ring ==
  contiguous ring at ``block_s`` = page, chunked == monolithic on the
  contiguous ring, a slot reused after a wrapped request starts clean.
* What must raise: a ragged prefill wider than the window, a history
  with a window, a windowed pool asked for speculation or a prefix
  cache, a paged windowed pool asked for chunked admission, a sharded
  ring.
* The bridge carries every parameter; ``ssm.init_cache`` takes no
  default device.

Tolerance, as ``test_torch_dense_swiglu.py`` states it for phi3: in f32
compute only the order of f32 sums differs, F32_TOL = 1e-4 over the
first F32_STEPS decode steps (2e-3 under vexp_hw, whose BF16 table
turns an f32 ulp into a table step; ``test_paths_match_jax_f32``); in
bf16 the frameworks round activations at different places, LOGIT_REL =
0.02 of max(1, max |logit|). Decode against the f32 forward also takes
LOGIT_REL: the decode path rounds K / V to the bf16 cache and q and p to
bf16, the forward does not.
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
from repro.runtime import resolve_policy as jax_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api, ssm, transformer  # noqa: E402
from repro_torch.models.decode_state import (KVDecodeState,  # noqa: E402
                                             PagedKVDecodeState)
from repro_torch.runtime import resolve_policy  # noqa: E402

ARCH = "h2o-danube3-4b"
EXPS = ("exact", "vexp", "vexp_hw")
LOGIT_REL = 0.02
F32_TOL = 1e-4
F32_TOL_HW = 2e-3                    # test_torch_moe.py's vexp_hw limit
F32_STEPS = 8                        # f32 decode steps compared
SIZES = {"g1_d32": {}, "g4_d120": {"n_kv_heads": 1, "head_dim": 120}}
W = 16                               # the reduced config's window
B, S, STEPS = 3, W, 20               # prompts of <= W; decode to pos 35
PLEN = np.array([16, 9, 13], np.int32)
C, OFFS, CLENS = 8, ([0, 0, 0], [8, 5, 8]), ([8, 5, 8], [8, 0, 3])
PAGE = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


_MODELS: dict = {}


def _models(size, dtype="bfloat16"):
    """(jcfg, jax params, cfg, port params) on the same weights."""
    key = (size, dtype)
    if key not in _MODELS:
        kw = dict(SIZES[size], compute_dtype=dtype)
        jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **kw)
        cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
        assert cfg.sliding_window == jcfg.sliding_window == W
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
    ns = W // PAGE
    tab = (1 + rng.permutation(B * ns)).reshape(B, ns).astype(np.int32)
    return toks, forced, chunks, tab


def _pools(cache, tab):
    """A prefill ring (L, B, W, Hkv, hd) laid into a page pool through
    the ring table ``tab`` (page 0 the scratch page)."""
    out = {}
    for name in ("k", "v"):
        c = np.asarray(_np(cache[name]))
        pool = np.zeros((c.shape[0], 1 + tab.size, PAGE) + c.shape[3:],
                        np.float32)
        for b in range(B):
            for si in range(tab.shape[1]):
                pool[:, tab[b, si]] = c[:, b, si * PAGE:(si + 1) * PAGE]
        out[name] = pool
    return out


def _run(pkg, size, dtype, exp, tier, cache0=None):
    """Logits of every path through one package: the ragged prefill and
    STEPS teacher-forced decode steps over the ring, two chunks of a
    chunked prefill on a contiguous ring, and STEPS paged decode steps
    over the prefill's ring laid into a shuffled ring table; the decode
    steps start from ``cache0`` (a prefill ring as numpy) where given.
    Returns ({path: [logits, ...]}, the prefill ring as numpy)."""
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
        out["paged"] = out["decode"][1:]
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
        out["decode"], pos = [lg], PLEN.copy()
        out["paged"] = []
        for t in range(STEPS):
            lg, cache = api.decode_step(tp, cfg, forced[t], cache, pos,
                                        policy=pol, device="cpu")
            out["decode"].append(lg)
            lg, pools = api.decode_step_paged(tp, cfg, forced[t], pools, tab,
                                              pos, policy=pol, device="cpu")
            out["paged"].append(lg)
            pos = pos + 1
        cc = {k: v.to(getattr(torch, cfg.compute_dtype)) for k, v in
              api.init_cache(cfg, B, 2 * C, device="cpu").items()}
        out["chunk"] = []
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
            d, lim = float(np.abs(g - w).max()), limit_of(w)
            assert d <= lim, (path, i, d, lim)


def test_decode_wraps_the_ring():
    """Every row's decode runs past the window: the ring wraps at least
    once for each (twice for the longest prompt)."""
    assert int((PLEN + STEPS - 1).min()) >= W
    assert int(PLEN.max()) + STEPS - 1 >= 2 * W


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("size", sorted(SIZES))
def test_paths_match_jax_bf16(size, exp):
    want, _ = _run("jax", size, "bfloat16", exp, None)
    for tier in ("cuda", "reference"):
        got, _ = _run("port", size, "bfloat16", exp, tier)
        _compare(got, want, lambda w: LOGIT_REL * max(1.0,
                                                      float(np.abs(w).max())))


@pytest.mark.parametrize("exp", EXPS)
def test_paths_match_jax_f32(exp):
    """f32 compute at danube's group and head dim: the decode steps of
    both packages start from the JAX prefill's bf16 ring and the chunks
    run on an f32 ring, as phi3's f32 test does. Each decode step writes
    its K / V to the bf16 ring, where an f32 ulp between the packages
    can round to a bf16 ulp and move later logits by ~1e-4, so more
    steps take more of those flips (phi3's test takes 3): the first
    F32_STEPS steps are compared, in which every row wraps. Under
    vexp_hw an f32 ulp of an exp argument can cross a step of the BF16
    table, as ``test_torch_moe.py`` states: F32_TOL_HW."""
    want, cache = _run("jax", "g4_d120", "float32", exp, None)
    got, _ = _run("port", "g4_d120", "float32", exp, "reference", cache)
    assert int((PLEN + F32_STEPS - 1).min()) >= W
    for out in (want, got):
        out["decode"] = out["decode"][:1 + F32_STEPS]
        out["paged"] = out["paged"][:F32_STEPS]
    tol = F32_TOL_HW if exp == "vexp_hw" else F32_TOL
    _compare(got, want, lambda w: tol)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_decode_past_the_wrap_equals_windowed_forward(size):
    """Teacher-forced decode over the ring from a 10-token prefill to
    position 39 against the f32 windowed forward over the whole
    sequence, position by position; the window-less forward is far
    off past the window, so the window is what the ring computes."""
    _, _, cfg, tp = _models(size, "float32")
    pol = resolve_policy(cfg, env={}, exp_backend="vexp",
                         kernel_backend="cuda")
    n0, n = 10, 40
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, n)).astype(np.int64))
    lg, cache = transformer.prefill(tp, cfg, toks[:, :n0], policy=pol)
    ring = transformer.init_cache(cfg, 2, 64, "cpu")
    assert ring["k"].shape[2] == W
    for name in ("k", "v"):
        ring[name][:, :, :n0] = cache[name]
    dec = [lg]
    for t in range(n0, n - 1):
        lg, _ = transformer.decode_step(tp, cfg, toks[:, t:t + 1], ring,
                                        torch.full((2,), t), policy=pol)
        dec.append(lg)
    dec = torch.cat(dec, 1)
    fwd = transformer._logits(tp, cfg, transformer.forward(
        tp, cfg, toks[:, :n - 1], policy=pol))[:, n0 - 1:]
    lim = LOGIT_REL * max(1.0, float(fwd.abs().max()))
    assert float((dec - fwd).abs().max()) <= lim
    full = dataclasses.replace(cfg, sliding_window=None)
    nowin = transformer._logits(tp, full, transformer.forward(
        tp, full, toks[:, :n - 1], policy=pol))[:, n0 - 1:]
    past = W - n0 + 1                     # the first step past the window
    assert float((nowin[:, past:] - fwd[:, past:]).abs().max()) > 10 * lim


# ------------------------------------------------------- what must raise

def _pol(cfg, **kw):
    kw.setdefault("block_page", PAGE)
    return resolve_policy(cfg, env={}, kernel_backend="cuda", **kw)


def test_windowed_paths_that_raise():
    _, _, cfg, tp = _models("g1_d32")
    pol = _pol(cfg)
    toks = np.zeros((2, W + 1), np.int32)
    with pytest.raises(ValueError, match="sliding window"):
        transformer.prefill(tp, cfg, torch.from_numpy(toks),
                            prompt_len=torch.tensor([W + 1, 3]), policy=pol)
    # a uniform prompt wider than the window keeps its last W rows, rolled
    _, ring = transformer.prefill(tp, cfg, torch.from_numpy(toks),
                                  policy=pol)
    assert ring["k"].shape[2] == W
    hist = {k: torch.zeros(cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd,
                           dtype=torch.bfloat16) for k in ("k", "v")}
    with pytest.raises(ValueError, match="linear"):
        transformer.prefill(tp, cfg, torch.from_numpy(toks[:, :4]),
                            prompt_len=torch.tensor([4, 4]), policy=pol,
                            hist=hist)
    # the contiguous ring: no speculation, no sequence sharding, unbounded
    st = KVDecodeState(cfg, tp, pol, 2, W, device=torch.device("cpu"),
                       cuda_graphs=False)
    assert st.max_len() is None and not st.supports_speculative()
    assert not KVDecodeState.supports_seq_sharding(cfg)
    with pytest.raises(ValueError, match="speculative"):
        st.enable_speculative(4)
    with pytest.raises(ValueError, match="speculative"):
        Server(cfg, tp, max_batch=2, max_seq=64, device="cpu",
               policy=_pol(cfg, spec_k=4))
    # a pool narrower than the window is a linear cache
    narrow = KVDecodeState(cfg, tp, pol, 2, W // 2,
                           device=torch.device("cpu"), cuda_graphs=False)
    assert narrow.max_len() == W // 2
    # the paged ring: no prefix cache, monolithic admission only
    with pytest.raises(ValueError, match="prefix cache"):
        PagedKVDecodeState(cfg, tp, pol, 2, W, device=torch.device("cpu"),
                           cuda_graphs=False)
    with pytest.raises(ValueError, match="prefix cache"):
        Server(cfg, tp, max_batch=2, max_seq=64, device="cpu", paged=True,
               policy=pol, prefix_cache=True)
    pst = PagedKVDecodeState(cfg, tp, pol, 2, W, device=torch.device("cpu"),
                             cuda_graphs=False, prefix_cache=False)
    assert pst.ns == W // PAGE and pst.pcache is None
    assert not pst.supports_speculative()
    with pytest.raises(ValueError, match="monolithically"):
        pst.begin_chunk(0, np.zeros(4, np.int32), 4)
    with pytest.raises(ValueError, match="monolithically"):
        Server(cfg, tp, max_batch=2, max_seq=64, device="cpu", paged=True,
               policy=_pol(cfg, prefill_chunk=8))
    with pytest.raises(NotImplementedError):
        transformer.decode_step_sharded(tp, cfg, None, None, None,
                                        policy=pol, shard=None)


# ------------------------------------------------ the engine identities

LENS = (16, 9, 4, 13, 11)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _serve(cfg, params, prompts, *, max_batch=3, max_new=22, **pol):
    paged = pol.pop("paged", False)
    srv = Server(cfg, params, max_batch=max_batch, max_seq=64,
                 policy=_pol(cfg, **pol), device="cpu", paged=paged)
    reqs = [Request(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    srv.run(reqs)
    srv.assert_idle_clean()
    assert all(r.finish_reason == "max_new" for r in reqs)
    return [list(r.out) for r in reqs], srv


@pytest.mark.parametrize("size", sorted(SIZES))
def test_engine_identities(size):
    """Five requests through three slots on a 16-slot ring (max_seq 64),
    each decoding 22 tokens, so every one wraps: batched == each served
    alone; the paged ring (8-token pages, block_s at the page) == the
    contiguous ring; chunked prefill (8) == one-shot admission; a slot
    that served a wrapped request serves the next one as a fresh pool
    does."""
    _, _, cfg, tp = _models(size)
    prompts = _prompts(cfg, LENS)
    assert min(LENS) + 22 > W
    batched, srv = _serve(cfg, tp, prompts)
    assert srv.cache_s == W and srv.stats()["default"]["admit_waves"] >= 2
    solo = [_serve(cfg, tp, [p], max_batch=1)[0][0] for p in prompts]
    assert batched == solo
    contig, _ = _serve(cfg, tp, prompts, block_s=PAGE)
    paged, srv = _serve(cfg, tp, prompts, block_s=PAGE, paged=True)
    assert paged == contig
    assert srv.stats()["default"]["pool"]["pages_used"] == 0
    chunked, srv = _serve(cfg, tp, prompts, prefill_chunk=8)
    assert srv.stats()["default"]["prefill_chunks"] >= 3
    assert chunked == batched
    # one slot: request 1 lands in the slot request 0 wrapped
    reused, _ = _serve(cfg, tp, prompts[:2], max_batch=1)
    assert reused[1] == solo[1]


# ------------------------------------------------ bridge, config, repair

def test_bridge_carries_every_parameter():
    """Every parameter of the port's model holds the JAX package's value
    (2-D layer weights through the compute dtype), and nothing is left
    out: the leaves copied count every parameter element."""
    jcfg, jp, cfg, tp = _models("g4_d120")
    seen = 0

    def walk(tree, mod, idx):
        nonlocal seen
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, getattr(mod, name), idx)
                continue
            got = getattr(mod, name)
            want = np.asarray(leaf if idx is None else leaf[idx])
            if idx is not None and want.ndim > 1:
                want = _np(jnp.asarray(want, jnp.bfloat16))
            np.testing.assert_array_equal(got.float().numpy(), want)
            seen += got.numel()

    for i in range(cfg.n_layers):
        walk(jp["layers"], tp.layers[i], i)
    walk({k: v for k, v in jp.items() if k != "layers"}, tp, None)
    assert seen == sum(p.numel() for p in tp.parameters())
    assert tp.layers[0].attn.wq.shape == (cfg.d_model, cfg.n_heads * 120)


def test_config_is_the_reference_s():
    c, j = REGISTRY[ARCH], jax_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "sliding_window", "act", "rope_theta",
              "tie_embeddings", "family"):
        assert getattr(c, f) == getattr(j, f), f
    assert (c.hd, c.n_heads // c.n_kv_heads, c.sliding_window) == (120, 4,
                                                                   4096)


def test_ssm_init_cache_needs_a_device():
    cfg = get_config("mamba2-1.3b").reduced()
    with pytest.raises(TypeError):
        ssm.init_cache(cfg, 2)
    st = ssm.init_cache(cfg, 2, None, "cpu")
    assert st["h"].device.type == "cpu"
