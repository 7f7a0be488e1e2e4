"""Chunked prefill in the port (reduced gpt2-small on the CPU).

* Against the JAX package, on weights bridged from it: the port's
  ``prefill_chunk`` / ``prefill_chunk_paged`` and the reference's on the
  same tokens, cursors and valid counts, two chunks deep, under every
  exp backend. Logits of the rows that hold tokens, and the cache rows
  the chunks wrote, within LOGIT_TOL (the tolerance of
  ``test_torch_model.py``); a row with no tokens in a chunk keeps its
  cache bit for bit.
* The port's own identities, after ``tests/test_chunked_prefill.py``:
  chunked serving gives the monolithic serve's tokens, contiguous and
  paged (chunks straddling a page), for a prompt shorter than a chunk
  and for chunk width 1, with slots and pages freed and re-admitted
  through chunks; decode steps run while a long prompt streams in and
  leave its rows alone; ``stats()`` carries the chunk telemetry; a
  sequence-sharded contiguous group refuses ``prefill_chunk > 0`` and a
  sharded paged one admits monolithically.
* The port's chunked ``Server`` gives the JAX ``Server``'s tokens on the
  same requests, near ties aside (the rule of ``test_torch_serving.py``).
* The chunk program as a captured graph under host stand-ins of the
  CUDA graph API (``test_torch_graph_audit.py``'s): one capture per
  group when it is built, a replay per chunk, the tokens of the eager
  arm, and the carry's storage kept across chunks, decode steps and
  admissions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402
from repro_torch.runtime.graphs import StepGraph, carry_signature  # noqa: E402

LOGIT_TOL = 0.02          # as in test_torch_model.py
EXP_BACKENDS = ("exact", "vexp", "vexp_hw")
PAGE = 8
B, S, C = 3, 32, 8
# two chunks: row 0 streams 8 + 8 tokens, row 1 takes 5 then sits inert,
# row 2 sits inert, then takes 6 tokens at cursor 0
OFFS = (np.array([0, 0, 0], np.int32), np.array([8, 5, 0], np.int32))
CLENS = (np.array([8, 5, 0], np.int32), np.array([8, 0, 6], np.int32))


@pytest.fixture(scope="module")
def cfg():
    return get_config("gpt2-small").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return api.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def models():
    from repro.configs import get_config as jax_config
    from repro.models import api as japi
    from repro_torch.bridge import params_from_numpy
    jcfg = jax_config("gpt2-small").reduced()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("gpt2-small").reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _chunk_tokens():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 512, (B, C)).astype(np.int32) for _ in OFFS]


def _tables():
    """Rows 0-2 own pages 1-4, 5-8, 9-12 (pool of 13 with scratch 0)."""
    return np.arange(1, 13, dtype=np.int32).reshape(B, 4)


# ------------------------------------------------------- against the JAX

def _jax_chunks(models, exp, paged):
    from repro.models import api as japi
    from repro.runtime import resolve_policy as jax_policy
    jcfg, jp, _, _ = models
    pol = jax_policy(jcfg, env={}, exp_backend=exp,
                     kernel_backend="reference")
    if paged:
        cache = japi.init_paged_cache(jcfg, B, 13, PAGE)
    else:
        cache = japi.init_cache(jcfg, B, S)
    out = []
    for toks, off, clens in zip(_chunk_tokens(), OFFS, CLENS):
        args = (jnp.asarray(toks), cache)
        if paged:
            args += (jnp.asarray(_tables()),)
        logits, cache = (japi.prefill_chunk_paged if paged
                         else japi.prefill_chunk)(
            jp, jcfg, *args, jnp.asarray(off), jnp.asarray(clens),
            policy=pol)
        out.append(np.asarray(logits))
    return out, {k: np.array(v.astype(jnp.float32))
                 for k, v in cache.items()}


def _port_chunks(models, exp, paged):
    _, _, cfg, tp = models
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend="cuda")
    if paged:
        cache = api.init_paged_cache(cfg, 13, PAGE, device="cpu")
    else:
        cache = api.init_cache(cfg, B, S, device="cpu")
    out, before = [], []
    for toks, off, clens in zip(_chunk_tokens(), OFFS, CLENS):
        before.append({k: v.clone() for k, v in cache.items()})
        if paged:
            logits, got = api.prefill_chunk_paged(
                tp, cfg, toks, cache, _tables(), off, clens, policy=pol,
                device="cpu")
        else:
            logits, got = api.prefill_chunk(tp, cfg, toks, cache, off,
                                            clens, policy=pol, device="cpu")
        assert got is cache                   # written in place
        out.append(logits.numpy())
    return out, cache, before


def _rows(cache, b, paged):
    """Row b's (L, S, Hkv, hd) K and V, paged rows through their table."""
    out = []
    for name in ("k", "v"):
        t = torch.as_tensor(cache[name]).float()
        if paged:
            t = t[:, torch.as_tensor(_tables()[b]).long()]
            t = t.reshape(t.shape[0], -1, *t.shape[3:])
        else:
            t = t[:, b]
        out.append(t)
    return out


def _one_shot_kv_distance(models, exp, plen):
    """Largest |port - JAX| over the K/V rows that a one-shot ragged
    prefill of the chunks' prompts writes in each package. K/V reach
    ~2.5 after one layer, where a bf16 ulp is up to 0.0156; the two
    frameworks round the first layer's output differently, and the
    one-shot rows already sit 0.0234 apart under exact (3 ulps in
    [1, 2)). The chunk's rows are held to that distance, or to
    LOGIT_TOL where it is larger."""
    from repro.models import api as japi
    from repro.runtime import resolve_policy as jax_policy
    jcfg, jp, cfg, tp = models
    t1, t2 = _chunk_tokens()
    toks = np.zeros((B, 2 * C), np.int32)
    toks[0] = np.concatenate([t1[0], t2[0]])
    toks[1, :5], toks[2, :6] = t1[1, :5], t2[2, :6]
    batch = {"tokens": toks, "prompt_len": plen.astype(np.int32)}
    _, want = japi.prefill(jp, jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                           policy=jax_policy(jcfg, env={}, exp_backend=exp,
                                             kernel_backend="reference"))
    _, got = api.prefill(tp, cfg, batch, device="cpu",
                         policy=resolve_policy(cfg, env={}, exp_backend=exp))
    return max(float((got[k][:, b, :n].float() - torch.as_tensor(
        np.array(want[k][:, b, :n].astype(jnp.float32)))).abs().max())
        for k in ("k", "v") for b, n in enumerate(plen))


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_chunk_programs_match_jax(models, exp, paged):
    want, jcache = _jax_chunks(models, exp, paged)
    got, cache, before = _port_chunks(models, exp, paged)
    written = OFFS[1] + CLENS[1]
    for t, (g, w, clens) in enumerate(zip(got, want, CLENS)):
        assert g.shape == w.shape == (B, 1, 512) and np.isfinite(g).all()
        real = clens > 0
        assert np.abs(g[real] - w[real]).max() <= LOGIT_TOL, t
        srt = np.sort(w[real, 0], axis=-1)
        clear = srt[:, -1] - srt[:, -2] > 2 * LOGIT_TOL
        np.testing.assert_array_equal(g[real, 0][clear].argmax(-1),
                                      w[real, 0][clear].argmax(-1))
    tol = max(LOGIT_TOL, _one_shot_kv_distance(models, exp, written))
    for b in range(B):
        for mine, theirs in zip(_rows(cache, b, paged),
                                _rows(jcache, b, paged)):
            n = written[b]
            assert (mine[:, :n] - theirs[:, :n]).abs().max() <= tol
            assert (mine[:, n:] == 0).all()   # nothing past the cursor
    # a row with no tokens in the second chunk keeps its cache bit for bit
    for a, b in zip(_rows(before[1], 1, paged), _rows(cache, 1, paged)):
        assert torch.equal(a, b)
    if paged:                                 # the scratch page: untouched
        assert all((cache[n][:, 0] == 0).all() for n in ("k", "v"))


def test_chunk_entry_points_run_on_the_card_unless_asked(params, cfg,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toks, zero = np.zeros((1, 4), np.int32), np.zeros(1, np.int32)
    cache = api.init_cache(cfg, 1, 8, device="cpu")
    pool = api.init_paged_cache(cfg, 2, PAGE, device="cpu")
    for call in (lambda: api.prefill_chunk(params, cfg, toks, cache, zero,
                                           zero),
                 lambda: api.prefill_chunk_paged(
                     params, cfg, toks, pool, np.ones((1, 1), np.int32),
                     zero, zero)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------------------------------------- port identities

def _serve(cfg, params, prompts, *, chunk, exp="vexp", paged=False,
           max_new=6, max_batch=2, news=None, **kw):
    pol = resolve_policy(cfg, env={}, exp_backend=exp, prefill_chunk=chunk,
                         block_page=PAGE)
    srv = Server(cfg, params, max_batch=max_batch, max_seq=64, policy=pol,
                 paged=paged, device="cpu", **kw)
    reqs = [Request(i, p.copy(), (news or {}).get(i, max_new))
            for i, p in enumerate(prompts)]
    srv.run(reqs)
    return {r.rid: list(r.out) for r in reqs}, srv


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_chunked_equals_monolithic(cfg, params, exp, paged):
    """More requests than slots, so completion frees slots (and pages)
    and later requests are chunk-admitted mid-decode; width 6 against
    page 8 makes the second chunk of each long prompt straddle a page."""
    prompts = _prompts(cfg, (21, 5, 33, 12))
    mono, _ = _serve(cfg, params, prompts, chunk=0, exp=exp, paged=paged)
    got, srv = _serve(cfg, params, prompts, chunk=6, exp=exp, paged=paged)
    assert got == mono
    g = srv._groups["default"]
    assert g.chunk_c == 6 and g.chunk_s and not g.admit_s
    assert srv.admit_log == [0, 1, 2, 3]
    srv.assert_idle_clean()


@pytest.mark.parametrize("chunk,lens", [(64, (5, 3)), (1, (7, 3))],
                         ids=["shorter-than-a-chunk", "width-1"])
def test_chunk_width_extremes(cfg, params, chunk, lens):
    prompts = _prompts(cfg, lens)
    mono, _ = _serve(cfg, params, prompts, chunk=0)
    got, srv = _serve(cfg, params, prompts, chunk=chunk)
    assert got == mono
    n = len(srv._groups["default"].chunk_s)
    assert n == (1 if chunk == 64 else max(lens))


def test_freed_pages_readmit_through_chunks(cfg, params):
    """A paged pool sized for about two slots: chunk admission blocks on
    pages, recycles what finished requests free, and serves every
    request with the monolithic tokens; staggered max_new frees slots
    while the other decodes."""
    prompts = _prompts(cfg, (21, 5, 33, 12, 9))
    news = {0: 3, 1: 8, 2: 5, 3: 2, 4: 6}
    mono, _ = _serve(cfg, params, prompts, chunk=0, paged=True, news=news,
                     block_budget=2 * 8 + 1)
    got, srv = _serve(cfg, params, prompts, chunk=6, paged=True, news=news,
                      block_budget=2 * 8 + 1)
    assert got == mono
    assert srv.admit_log == [0, 1, 2, 3, 4]
    srv.assert_idle_clean()


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_decode_overlaps_a_long_prefill(cfg, params, paged):
    """With a long and a short prompt in flight, the short request is
    served end to end while the long one streams in; decode steps between
    its chunks leave its rows (cache and pinned position) bit for bit."""
    rng = np.random.default_rng(1)
    long_p = rng.integers(0, cfg.vocab, (33,), dtype=np.int32)
    short_p = rng.integers(0, cfg.vocab, (4,), dtype=np.int32)
    pol = resolve_policy(cfg, env={}, prefill_chunk=2, block_page=PAGE)
    srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                 paged=paged, device="cpu")
    reqs = [Request(0, long_p, 4), Request(1, short_p, 3)]
    for r in reqs:
        srv.submit(r)
    g = srv._groups["default"]
    st = g.state
    checked = 0
    while g.busy:
        g.reap()
        g.admit(srv.admit_log)
        g.prefill_chunk_once()
        if g.prefilling and any(r is not None for r in g.reqs):
            j = next(iter(g.prefilling))
            rows = (st.slot_pages[j] if paged else None)
            snap = {k: (v[:, rows] if paged else v[:, j]).clone()
                    for k, v in st.data.items()}
            pos = int(st.pos_dev[j])
            g.decode_once()
            for k, v in st.data.items():
                now = v[:, rows] if paged else v[:, j]
                assert torch.equal(now, snap[k])
            assert int(st.pos_dev[j]) == pos == len(long_p)
            checked += 1
        else:
            g.decode_once()
    assert checked >= 2
    assert reqs[1].t_done < reqs[0].t_first
    assert len(g.chunk_s) == 17 and g.decode_steps_prefilling >= 2
    mono, _ = _serve(cfg, params, [long_p, short_p], chunk=0, paged=paged,
                     news={0: 4, 1: 3})
    assert [r.out for r in reqs] == [mono[0], mono[1]]


def test_inert_rows_leave_decoding_slots_alone(cfg, params):
    """A chunk with a decoding slot's row inert (no tokens) leaves that
    slot's cache rows bit for bit."""
    pol = resolve_policy(cfg, env={}, prefill_chunk=8)
    srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                 device="cpu")
    srv.run([Request(0, _prompts(cfg, (12,))[0], 2)])
    st = srv._groups["default"].state
    before = {k: v[:, 0].clone() for k, v in st.data.items()}
    toks = np.ones((2, 8), np.int32)
    st.prefill_chunk_into(toks, np.array([12, 0], np.int32),
                          np.array([0, 8], np.int32))
    for k, v in st.data.items():
        assert torch.equal(v[:, 0], before[k])
        assert not torch.equal(v[:, 1, :8], torch.zeros_like(v[:, 1, :8]))


def test_stats_report_chunk_telemetry(cfg, params):
    prompts = _prompts(cfg, (21, 5, 33))
    _, srv = _serve(cfg, params, prompts, chunk=6)
    s = srv.stats()["default"]
    assert s["prefill_chunk"] == 6 and s["prefill_chunks"] >= 6
    assert s["chunk_s_total"] > 0.0 and s["p50_chunk_dispatch_s"] > 0.0
    assert s["queue_depth"] == 0 and s["prefilling"] == 0
    assert s["p95_ttft_s"] >= s["p50_ttft_s"] > 0.0
    assert s["admit_waves"] == 0
    assert (s["chunk_graph_captures"], s["chunk_graph_replays"]) == (0, 0)
    _, msrv = _serve(cfg, params, prompts, chunk=0)
    m = msrv.stats()["default"]
    assert m["prefill_chunks"] == 0 and m["prefill_chunk"] == 0
    assert m["p50_ttft_s"] > 0.0 and m["admit_waves"] > 0


class _OneRankOfTwo:
    """The rank-0 view of a two-rank ShardGroup: enough to build a
    sequence-sharded state, which here never reaches a collective."""
    world, rank, calls = 2, 0, 0


def test_sharded_groups_refuse_or_skip_chunking(cfg, params):
    pol = resolve_policy(cfg, env={}, prefill_chunk=16, block_page=PAGE)
    with pytest.raises(NotImplementedError, match="A10"):
        Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
               device="cpu", kv_mode="seq", shards=_OneRankOfTwo())
    srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                 device="cpu", kv_mode="seq", shards=_OneRankOfTwo(),
                 paged=True)
    g = srv._groups["default"]
    assert g.state.shards == 2 and not g.state.supports_chunked()
    assert g.chunk_c == 0


# --------------------------------------------------- against the JAX Server

@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_chunked_server_matches_the_jax_server(models, paged):
    from repro.launch.serve import Request as JaxRequest, Server as JaxServer
    from repro.models import api as japi
    from repro.runtime import resolve_policy as jax_policy
    jcfg, jp, cfg, tp = models
    prompts = _prompts(cfg, (21, 5, 19, 12), seed=17)
    news = (3, 7, 4, 5)
    jpol = jax_policy(jcfg, env={}, exp_backend="vexp",
                      kernel_backend="reference", prefill_chunk=6)
    kw = dict(paged=True, block_page=PAGE) if paged else {}
    jsrv = JaxServer(jcfg, jp, max_batch=2, max_seq=64, policy=jpol, **kw)
    jreqs = [JaxRequest(i, p.copy(), n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    jsrv.run(jreqs)
    ours, srv = _serve(cfg, tp, prompts, chunk=6, paged=paged,
                       news=dict(enumerate(news)))
    assert srv.admit_log == jsrv.admit_log == [0, 1, 2, 3]
    for r in jreqs:
        got = ours[r.rid]
        assert len(got) == r.max_new
        diff = [i for i, (a, b) in enumerate(zip(got, r.out)) if a != b]
        if not diff:
            continue
        seq = np.concatenate([r.prompt, np.asarray(r.out[:diff[0]],
                                                   np.int32)])
        logits, _ = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(seq[None])},
                                 policy=jpol)
        top = np.sort(np.asarray(logits)[0, 0])
        assert top[-1] - top[-2] <= 2 * LOGIT_TOL, (r.rid, diff[0])


# ------------------------------------------------- the chunk program graph

class _ReplayingGraph:
    """Stand-in for a captured step: ``replay`` runs the step on the
    carry it was captured over, the storage a CUDA graph reads."""

    def __init__(self, fn, carry):
        self.fn, self.carry = fn, dict(carry)

    def replay(self):
        self.fn(self.carry)


@pytest.fixture
def host_graphs(monkeypatch):
    init = StepGraph.__init__

    def init_graph(self, device, *, enabled=True):
        init(self, device, enabled=enabled)
        self.use_graph = enabled

    def capture(self, fn, carry):
        fn(carry)
        self.graph = _ReplayingGraph(fn, carry)
        self.captures += 1

    monkeypatch.setattr(StepGraph, "__init__", init_graph)
    monkeypatch.setattr(StepGraph, "_capture", capture)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_chunk_program_captured_with_the_group(cfg, params, paged,
                                               host_graphs):
    """Built, a chunked group holds one decode capture and one chunk
    capture; every chunk is then a replay over static buffers, the carry
    keeps its storage across chunks, decode steps and admissions, and
    the tokens equal the eager arm's."""
    prompts = _prompts(cfg, (21, 5, 33, 12))
    outs = {}
    for arm in ("graph", "eager"):
        pol = resolve_policy(cfg, env={}, prefill_chunk=6, block_page=PAGE)
        srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                     paged=paged, device="cpu", cuda_graphs=arm == "graph")
        g = srv._groups["default"]
        st = g.state
        s0 = srv.stats()["default"]
        if arm == "graph":
            assert (s0["graph_captures"], s0["chunk_graph_captures"]) \
                == (1, 1)
            prog = next(iter(st.chunk_progs.values()))
            sig = carry_signature({**st._chunk_carry(prog),
                                   **st.carry(g.last, g.live_dev)})
        reqs = [Request(i, p.copy(), 5) for i, p in enumerate(prompts)]
        srv.run(reqs)
        outs[arm] = [r.out for r in reqs]
        s = srv.stats()["default"]
        if arm == "graph":
            assert carry_signature({**st._chunk_carry(prog),
                                    **st.carry(g.last, g.live_dev)}) == sig
            assert s["chunk_graph_captures"] == 1
            assert s["chunk_graph_replays"] == s["prefill_chunks"] > 0
            assert s["graph_replays"] == s["decode_steps"] > 0
        else:
            assert s["chunk_graph_captures"] == s["graph_captures"] == 0
        srv.assert_idle_clean()
    assert outs["graph"] == outs["eager"]


def test_ladder_captures_every_rung_at_construction(cfg, params,
                                                    host_graphs):
    """A degradable chunked group captures the decode step under both
    policies and the chunk program at every (policy, width) the ladder
    reaches; moving along the ladder captures nothing more."""
    pol = resolve_policy(cfg, env={}, exp_backend="exact", prefill_chunk=16,
                         block_page=PAGE)
    srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                 device="cpu", degrade_groups=("default",))
    g = srv._groups["default"]
    st = g.state
    assert set(st.graphs) == {pol, pol.replace(exp_backend="vexp_hw")}
    assert set(st.chunk_progs) == {
        (pol, 16), (pol, 8), (pol.replace(exp_backend="vexp_hw"), 8)}
    before = srv.stats()["default"]
    for level in (1, 2, 1, 0):
        g.set_degraded(level)
    reqs = [Request(i, p.copy(), 4) for i, p in enumerate(
        _prompts(cfg, (21, 5)))]
    g.set_degraded(2)
    srv.run(reqs)
    after = srv.stats()["default"]
    assert after["graph_captures"] == before["graph_captures"] == 2
    assert after["chunk_graph_captures"] == before[
        "chunk_graph_captures"] == 3
    assert g.policy.exp_backend == "vexp_hw" and g.chunk_c == 8
    hw, _ = _serve(cfg, params, _prompts(cfg, (21, 5)), chunk=8,
                   exp="vexp_hw", max_new=4)
    assert [r.out for r in reqs] == [hw[0], hw[1]]
