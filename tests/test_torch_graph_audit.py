"""The port's compiled decode step on the CPU: the in-place carry and the
audits of ``repro_torch.analysis.graph_audit``.

* The contiguous and paged states keep every carry tensor (cache leaves,
  positions, tables, the engine's tokens and live mask, the output
  buffer) at the same storage, shape and dtype across several steps with
  an admission between them; a planted step that rebinds its positions
  fails the in-place audit, and the step graph refuses it on its next
  call.
* The engine's logged tokens are copies per step, not views of the
  step's static output buffer: each request's tokens equal a greedy
  decode through ``transformer.decode_step`` on a cache of its own.
* The in-place engine gives the JAX ``Server``'s tokens on fixed prompts
  (contiguous and paged, slots freed and refilled mid-decode), up to the
  first step whose JAX top-2 logit gap is a near tie (<= 2 * LOGIT_TOL,
  the rule of ``test_torch_serving.py``).
* ``StepGraph``'s capture path under stand-ins for the CUDA graph API:
  the warm-up counts its launches, capture counts none, every replay
  adds the captured launches; a failed capture raises with the counts
  restored and keeps no carry, so the next call captures again. A Server
  captures each group's step when it is built, and under a stand-in
  graph that replays on the captured carry its tokens equal the eager
  arm's. The capture audit itself needs the card and refuses the CPU.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.analysis import graph_audit  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.decode_state import KVDecodeState  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402
from repro_torch.runtime.graphs import StepGraph, carry_signature  # noqa: E402

LOGIT_TOL = 0.02          # as in test_torch_model.py
PAGE = 8


@pytest.fixture(scope="module")
def cfg():
    return get_config("gpt2-small").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return api.init_params(cfg, 0, device="cpu")


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _server(cfg, params, paged, **kw):
    pol = resolve_policy(cfg, env={}, exp_backend="vexp", block_page=PAGE)
    return Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                  paged=paged, device="cpu", **kw)


# --------------------------------------------------------- in-place carry

@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_carry_kept_in_place_across_steps_and_admissions(cfg, params,
                                                         paged):
    """Three requests through two slots (max_new 2, 6, 3): the third is
    admitted while the second decodes. Every tick after the first
    admission keeps the carry's storage, shape and dtype."""
    srv = _server(cfg, params, paged)
    for i, (p, n) in enumerate(zip(_prompts(cfg, (5, 11, 7)), (2, 6, 3))):
        srv.submit(Request(i, p, n))
    g = srv._groups["default"]
    srv.step()                        # first admission allocates the cache
    first = carry_signature(g.state.carry(g.last, g.live_dev))
    assert {"k", "v", "pos", "last", "live", "out"} <= set(first)
    assert ("tables" in first) == paged
    ticks = 0
    while srv._groups["default"].busy:
        graph_audit.audit_step(g.state, g.last, g.live_dev, step=srv.step)
        ticks += 1
    assert ticks >= 5 and len(srv.admit_log) == 3
    assert carry_signature(g.state.carry(g.last, g.live_dev)) == first
    st = srv.stats()["default"]
    assert (st["step_mode"], st["graph_captures"], st["graph_replays"]) \
        == ("eager", 0, 0)
    srv.assert_idle_clean()


class _Rebinding(KVDecodeState):
    """A planted step that rebinds its positions instead of adding in
    place (the port's state before its decode step became a graph)."""

    def _step(self, c):
        logits = self._logits(c)
        c["out"].copy_(logits.argmax(dim=-1).to(torch.int32))
        self.pos_dev = self.pos_dev + c["live"]


def test_rebinding_step_fails_the_in_place_audit(cfg, params):
    pol = resolve_policy(cfg, env={}, exp_backend="vexp")
    st = _Rebinding(cfg, params, pol, 2, 32, device="cpu")
    toks = np.ones((2, 8), np.int32)
    first = st.prefill_into([0, 1], toks, np.array([8, 5], np.int32))
    last = first.clone()
    live = torch.ones(2, dtype=torch.int32)
    with pytest.raises(graph_audit.InPlaceCarryError, match="pos"):
        graph_audit.audit_step(st, last, live)
    # the graph wrapper refuses the moved carry on the next step
    with pytest.raises(RuntimeError, match="pos"):
        st.step(last, live)


def test_carry_stability_and_budget_reports():
    a = {"pos": torch.zeros(4, dtype=torch.int32)}
    before = carry_signature(a)
    a["pos"] = a["pos"].long()
    with pytest.raises(graph_audit.CarryStabilityError, match="pos"):
        graph_audit.assert_carry_kept(before, carry_signature(a))
    assert graph_audit.budget_mismatch({}, graph_audit.step_budget(
        12, None)) is None
    assert graph_audit.step_budget(12, "split") == {
        "all_reduce_max": 12, "all_reduce_sum": 24}
    assert graph_audit.budget_mismatch(
        {"all_gather": 11}, graph_audit.step_budget(12, "packed"))
    with pytest.raises(graph_audit.CollectiveBudgetError):
        graph_audit.assert_collective_budget(lambda: None, None,
                                             {"all_gather": 1})


# ---------------------------------------------------- logged tokens, JAX

def _greedy(cfg, params, prompt, n, policy):
    """n greedy tokens for one prompt through prefill + decode_step on a
    cache of its own (fresh output tensors every step)."""
    logits, pref = transformer.prefill(params, cfg,
                                       torch.as_tensor(prompt[None]),
                                       policy=policy)
    cache = transformer.init_cache(cfg, 1, 64, "cpu")
    for name in ("k", "v"):
        cache[name][:, :, :len(prompt)] = pref[name]
    out = [int(logits[0, 0].argmax())]
    for t in range(n - 1):
        tok = torch.tensor([[out[-1]]], dtype=torch.int32)
        pos = torch.tensor([len(prompt) + t], dtype=torch.int32)
        logits, cache = transformer.decode_step(params, cfg, tok, cache, pos,
                                                policy=policy)
        out.append(int(logits[0, 0].argmax()))
    return out


def test_logged_tokens_are_per_step_copies(cfg, params):
    """Mid-decode, no logged token tensor shares the step's output
    buffer, and every request's tokens equal its own greedy decode: a log
    of views of the static buffer would repeat the last step's tokens."""
    srv = _server(cfg, params, False)
    prompts = _prompts(cfg, (5, 11, 7), seed=5)
    reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    g = srv._groups["default"]
    srv.step()
    srv.step()
    out_ptr = g.state.out.data_ptr()
    logged = [t for toks in g._toks.values() for t in toks]
    assert len(logged) >= 4
    assert all(t.data_ptr() != out_ptr for t in logged)
    srv.drain()
    for r in reqs:
        assert r.out == _greedy(cfg, params, r.prompt, 6, srv.policy), r.rid


def _first_divergence(a, b):
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    return diff[0] if diff else None


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


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_inplace_engine_matches_the_jax_server(models, paged):
    """Five requests through two slots with unequal max_new, so slots are
    freed and refilled while others decode: the in-place engine's tokens
    against the JAX Server's (reference tier), near ties aside."""
    from repro.launch.serve import Request as JaxRequest, Server as JaxServer
    from repro.models import api as japi
    from repro.runtime import resolve_policy as jax_policy
    jcfg, jp, cfg, tp = models
    prompts = _prompts(cfg, (5, 19, 9, 14, 6), seed=17)
    news = (3, 7, 4, 6, 5)
    jpol = jax_policy(jcfg, env={}, exp_backend="vexp",
                      kernel_backend="reference")
    kw = dict(paged=True, block_page=PAGE) if paged else {}
    jsrv = JaxServer(jcfg, jp, max_batch=2, max_seq=64, policy=jpol, **kw)
    jreqs = [JaxRequest(i, p.copy(), n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    jsrv.run(jreqs)
    srv = _server(cfg, tp, paged)
    reqs = [Request(i, p.copy(), n)
            for i, (p, n) in enumerate(zip(prompts, news))]
    srv.run(reqs)
    assert srv.admit_log == [0, 1, 2, 3, 4]
    for r, ours in zip(jreqs, [q.out for q in reqs]):
        assert len(ours) == r.max_new
        i = _first_divergence(ours, r.out)
        if i is None:
            continue
        seq = np.concatenate([r.prompt, np.asarray(r.out[:i], np.int32)])
        logits, _ = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(seq[None])},
                                 policy=jpol)
        top = np.sort(np.asarray(logits)[0, 0])
        assert top[-1] - top[-2] <= 2 * LOGIT_TOL, (r.rid, i)


# ------------------------------------------------ StepGraph's capture path

class _FakeGraph:
    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


class _FakeStream:
    def __init__(self, *a):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph and stream API replaced by host stand-ins, so
    StepGraph's capture path runs here; ``fail`` makes capture raise."""
    state = {"fail": False, "graphs": []}

    def graph_ctx(g):
        @contextlib.contextmanager
        def ctx():
            state["graphs"].append(g)
            yield
            if state["fail"]:
                raise RuntimeError("operation not permitted when stream "
                                   "is capturing")
        return ctx()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", graph_ctx)
    kernels.reset_launch_counts()
    yield state
    kernels.reset_launch_counts()


def _counting_step(calls):
    lib = kernels.LIBS["decode_attention"]

    def fn(c):
        calls.append(1)
        for _ in range(3):            # three launches a step
            lib.check(0, "decode_attention")
        c["pos"].add_(1)
    return fn


def test_capture_counts_the_warm_up_and_every_replay(fake_cuda):
    calls = []
    fn = _counting_step(calls)
    g = StepGraph("cuda")
    carry = {"pos": torch.zeros(2, dtype=torch.int32)}
    g(fn, carry)                      # warm-up (runs) + capture (runs not)
    assert len(calls) == 2 and g.captures == 1 and g.replays == 0
    assert kernels.launch_counts()["decode_attention"] == 3
    assert g.launches == {"decode_attention": 3}
    g(fn, carry)
    g(fn, carry)
    assert len(calls) == 2 and g.replays == 2
    assert fake_cuda["graphs"][0].replayed == 2
    assert kernels.launch_counts()["decode_attention"] == 9
    assert kernels.replay_counts()["decode_attention"] == 6
    assert g.stats()["mode"] == "graph"
    with pytest.raises(RuntimeError, match="pos"):
        g(fn, {"pos": torch.zeros(2, dtype=torch.int32)})   # another tensor
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["decode_attention"] == 0
    assert kernels.replay_counts()["decode_attention"] == 0


def test_failed_capture_raises_with_counts_restored(fake_cuda):
    fake_cuda["fail"] = True
    g = StepGraph("cuda")
    with pytest.raises(RuntimeError, match="capture of the decode step"):
        g(_counting_step([]), {"pos": torch.zeros(2, dtype=torch.int32)})
    assert kernels.launch_counts()["decode_attention"] == 3   # warm-up only
    assert g.graph is None and g.captures == 0
    # the failed call kept no carry: the next call captures again rather
    # than stepping eagerly on the card
    fake_cuda["fail"] = False
    calls = []
    g(_counting_step(calls), {"pos": torch.zeros(2, dtype=torch.int32)})
    assert len(calls) == 2 and g.captures == 1 and g.graph is not None


def test_eager_arm_and_cpu_never_capture():
    calls = []
    carry = {"pos": torch.zeros(2, dtype=torch.int32)}
    fn = _counting_step(calls)
    for g in (StepGraph("cpu"), StepGraph("cuda", enabled=False)):
        g(fn, carry)
        g(fn, carry)
        assert g.graph is None and g.stats()["mode"] == "eager"
    assert len(calls) == 4 and int(carry["pos"][0]) == 4
    kernels.reset_launch_counts()


class _ReplayingGraph:
    """Stand-in for a captured step: ``replay`` runs the step on the
    carry it was captured over, the storage a CUDA graph reads."""

    def __init__(self, fn, carry):
        self.fn, self.carry = fn, dict(carry)

    def replay(self):
        self.fn(self.carry)


@pytest.fixture
def host_graphs(monkeypatch):
    """StepGraph in graph mode on the CPU: capture runs the warm-up step
    and installs a ``_ReplayingGraph``."""
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
def test_group_captures_before_any_request(cfg, params, paged, host_graphs):
    """A group captures its step when the Server is built, over the empty
    pool; every decode step is then a replay, and the tokens equal the
    eager arm's (the warm-up's writes for dead slots are overwritten)."""
    srv = _server(cfg, params, paged)
    st = srv.stats()["default"]
    assert (st["step_mode"], st["graph_captures"], st["graph_replays"]) \
        == ("graph", 1, 0)
    outs = {}
    for arm, s in (("graph", srv),
                   ("eager", _server(cfg, params, paged, cuda_graphs=False))):
        reqs = [Request(i, p, n) for i, (p, n) in enumerate(
            zip(_prompts(cfg, (5, 11, 7)), (2, 6, 3)))]
        s.run(reqs)
        outs[arm] = [list(r.out) for r in reqs]
        s.assert_idle_clean()
    st = srv.stats()["default"]
    assert st["graph_captures"] == 1
    assert st["graph_replays"] == st["decode_steps"] > 0
    assert outs["graph"] == outs["eager"]


def test_capture_audit_refuses_the_cpu(cfg, params):
    srv = _server(cfg, params, False)
    g = srv._groups["default"]
    with pytest.raises(ValueError, match="needs the card"):
        graph_audit.capture_audit(g.state, g.last, g.live_dev)
