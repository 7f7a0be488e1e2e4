"""The ssm family through the port's slot engine (reduced mamba2-1.3b on
the CPU): ``RecurrentDecodeState`` under ``Server``.

* Batched == solo, the port's own contract: ragged waves of mixed
  lengths, and requests admitted mid-decode into freed slots, emit the
  tokens each request emits served alone. On the CPU this holds token
  for token (a row's SSD is computed independently of the other rows and
  the pad steps are dt-masked), so the tests ask equality; a freed slot
  is zeroed and its next request does not see the last one.
* The lifecycle: a poisoned slot is quarantined and scrubbed, the next
  request through it is a clean one; a step fault's ``recover`` zeroes
  the state (and the speculative snapshot) in place and the re-served
  requests equal an undisturbed run.
* The capabilities the engine reads off the state class: ``paged=True``
  serves through the contiguous recurrent state, ``kv_mode="seq"``
  serves unsharded, and a request decodes to ``max_new`` with no length
  cap (``max_len()`` is None) in plain and speculative decode.
* Chunked admission (chunks rounded up to ``ssm_chunk``) emits the
  monolithic serve's tokens.
* Self-speculative decode, "recurrent" scan verify: a speculating
  server emits the plain server's tokens under every exp backend;
  ``spec_restore`` puts the state back bit for bit; the verify program
  against the reference's ``_spec_programs(..., "recurrent")`` on one
  burst, on weights bridged from it (blocks equal wherever no scored
  lane is a near tie, lane logits within LOGIT_TOL, the state after the
  replay within STATE_TOL: the tolerances of ``test_torch_ssm.py``).
* The graph arm under host stand-ins of the CUDA graph API
  (``test_torch_graph_audit.py``'s): the decode step, the chunk program,
  the draft step and the verify captured when the group is built, a
  replay each after, the carry (``h``, ``conv``, and the snapshot) kept
  in place, tokens equal to the eager arm's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.analysis import graph_audit  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.ft import FaultInjector  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api, ssm  # noqa: E402
from repro_torch.models.decode_state import (  # noqa: E402
    SPEC_PAD, RecurrentDecodeState, _spec_verify_fn, decode_state_for)
from repro_torch.runtime import resolve_policy  # noqa: E402
from repro_torch.runtime.graphs import StepGraph, carry_signature  # noqa: E402

EXP_BACKENDS = ("exact", "vexp", "vexp_hw")
LOGIT_TOL = 0.05          # as in test_torch_ssm.py
STATE_TOL = 0.05
LENS = (5, 19, 9, 33, 12)


@pytest.fixture(scope="module")
def cfg():
    return get_config("mamba2-1.3b").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return api.init_params(cfg, 0, device="cpu")


def _pol(cfg, **kw):
    return resolve_policy(cfg, env={}, kernel_backend="cuda", **kw)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _serve(cfg, params, prompts, *, max_new=6, max_batch=2, policy=None,
           **kw):
    srv = Server(cfg, params, max_batch=max_batch, max_seq=64,
                 policy=policy or _pol(cfg), device="cpu", **kw)
    reqs = [Request(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    srv.run(reqs)
    srv.assert_idle_clean()
    return reqs, srv


_SOLO: dict = {}


def _solo(cfg, params, prompts, exp="vexp", max_new=6):
    """Each prompt served alone through a one-slot server (cached)."""
    key = (tuple(len(p) for p in prompts), exp, max_new)
    if key not in _SOLO:
        _SOLO[key] = [_serve(cfg, params, [p], max_new=max_new, max_batch=1,
                             policy=_pol(cfg, exp_backend=exp))[0][0].out
                      for p in prompts]
    return _SOLO[key]


# ------------------------------------------------------- batched == solo

def test_mixed_lengths_and_mid_decode_admission_match_solo(cfg, params):
    """Five mixed-length requests through two slots (three admitted into
    slots freed mid-decode) and through a pool wide enough for one wave:
    every request's tokens equal its solo run's."""
    prompts = _prompts(cfg, LENS)
    solo = _solo(cfg, params, prompts)
    for width in (2, 5):
        reqs, srv = _serve(cfg, params, prompts, max_batch=width)
        assert [r.out for r in reqs] == solo, width
        assert all(r.finish_reason == "max_new" for r in reqs)
        st = srv.stats()["default"]
        assert st["admit_waves"] >= (3 if width == 2 else 1)


def test_freed_slot_does_not_bleed_into_its_next_request(cfg, params):
    """One slot, two requests in turn: the slot's (h, conv) are zero once
    the first finishes, and the second emits its solo tokens."""
    prompts = _prompts(cfg, (33, 7), seed=3)
    solo = _solo(cfg, params, prompts)
    srv = Server(cfg, params, max_batch=1, max_seq=64, policy=_pol(cfg),
                 device="cpu")
    st = srv._groups["default"].state
    first = Request(0, prompts[0].copy(), 6)
    srv.run([first])
    assert all(not t.any() for t in st.data.values())
    second = Request(1, prompts[1].copy(), 6)
    srv.run([second])
    assert [first.out, second.out] == solo


def test_chunked_admission_equals_monolithic(cfg, params):
    """prefill_chunk = 10 rounds up to one SSD block (16): prompts stream
    in over one to three chunks between decode steps, and every request
    emits the monolithic serve's tokens."""
    prompts = _prompts(cfg, LENS)
    reqs, srv = _serve(cfg, params, prompts,
                       policy=_pol(cfg, prefill_chunk=10))
    st = srv.stats()["default"]
    assert st["prefill_chunk"] == cfg.ssm_chunk and st["prefill_chunks"] > 3
    assert [r.out for r in reqs] == _solo(cfg, params, prompts)


# ------------------------------------------------------------- lifecycle

def test_poison_quarantine_then_scrub(cfg, params):
    """One slot: the first request's state is poisoned mid-decode, it is
    quarantined and its rows scrubbed; the next request through the slot
    emits its solo tokens."""
    prompts = _prompts(cfg, (11, 5), seed=4)
    solo = _solo(cfg, params, prompts)
    srv = Server(cfg, params, max_batch=1, max_seq=64, policy=_pol(cfg),
                 device="cpu")
    reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.step()
    assert srv._groups["default"].state.poison_slot(0)
    srv.drain()
    assert reqs[0].finish_reason == "quarantined" and reqs[0].out == []
    assert reqs[1].finish_reason == "max_new" and reqs[1].out == solo[1]
    assert srv.stats()["default"]["quarantined"] == 1
    srv.assert_idle_clean()


@pytest.mark.parametrize("spec", [0, 3], ids=["plain", "spec"])
def test_step_fault_recover_zeroes_the_state(cfg, params, spec):
    """An injected dispatch fault: ``recover`` zeroes (h, conv), the
    positions and the speculative snapshot in place (their storage kept),
    and the re-served requests equal an undisturbed run."""
    prompts = _prompts(cfg, (5, 11), seed=5)
    solo = _solo(cfg, params, prompts)
    # the third plain step, or the second burst: both requests in flight
    inj = FaultInjector(seed=0,
                        schedule={"decode.step_error": [1 if spec else 2]})
    srv = Server(cfg, params, max_batch=2, max_seq=64,
                 policy=_pol(cfg, spec_k=spec), device="cpu", injector=inj)
    state = srv._groups["default"].state
    calls = []
    real = state.recover

    def recover():
        ptrs = {k: t.data_ptr() for k, t in state.data.items()}
        real()
        calls.append(all(not t.any() for t in (
            *state.data.values(), *state.spec_snap.values(), state.pos_dev)))
        assert {k: t.data_ptr() for k, t in state.data.items()} == ptrs

    state.recover = recover
    reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
    srv.run(reqs)
    assert calls == [True]
    assert [r.out for r in reqs] == solo
    assert all(r.retries == 1 for r in reqs)
    srv.assert_idle_clean()


# ---------------------------------------------------------- capabilities

def test_paged_and_seq_sharding_resolve_to_the_contiguous_state(cfg,
                                                                params):
    class _OneRankOfTwo:             # rank 0 of a two-rank ShardGroup
        world, rank, calls = 2, 0, 0

    assert decode_state_for(cfg, paged=True) is RecurrentDecodeState
    assert not RecurrentDecodeState.is_paged
    assert not RecurrentDecodeState.supports_seq_sharding(cfg)
    prompts = _prompts(cfg, LENS[:3])
    solo = _solo(cfg, params, prompts)
    for kw in (dict(paged=True), dict(kv_mode="seq", shards=_OneRankOfTwo())):
        reqs, srv = _serve(cfg, params, prompts, **kw)
        g = srv._groups["default"]
        assert not g.paged and g.state.kind == "recurrent"
        assert srv.stats()["default"]["shards"] == 1
        assert "pool" not in srv.stats()["default"]
        assert [r.out for r in reqs] == solo


@pytest.mark.parametrize("spec", [0, 4], ids=["plain", "spec"])
def test_decodes_to_max_new_with_no_length_cap(cfg, params, spec):
    """A 40-token prompt asking for 30 tokens in a 64-position server:
    a KV cache would stop it at the cap; recurrent state has none."""
    prompt = _prompts(cfg, (40,), seed=6)
    reqs, srv = _serve(cfg, params, prompt, max_new=30,
                       policy=_pol(cfg, spec_k=spec))
    assert srv._groups["default"].state.max_len() is None
    assert reqs[0].finish_reason == "max_new" and len(reqs[0].out) == 30
    if spec:
        plain, _ = _serve(cfg, params, prompt, max_new=30)
        assert reqs[0].out == plain[0].out


# --------------------------------------------------- speculative decode

@pytest.mark.parametrize("exp", EXP_BACKENDS)
def test_recurrent_scan_equals_plain(cfg, params, exp):
    """spec_k = 3, drafts under vexp_hw, the recurrent verify: tokens and
    finish reasons equal the plain server's; the chunk verify the policy
    asks for is served as a scan."""
    prompts = _prompts(cfg, LENS[:3])
    plain = _solo(cfg, params, prompts, exp=exp, max_new=9)
    reqs, srv = _serve(cfg, params, prompts, max_new=9,
                       policy=_pol(cfg, exp_backend=exp, spec_k=3,
                                   spec_verify="chunk"))
    assert [r.out for r in reqs] == plain
    st = srv.stats()["default"]
    assert st["spec_bursts"] > 0
    assert all(k[2:] == ("recurrent", "scan")
               for k in srv._groups["default"].state.spec_progs)
    if exp == "vexp_hw":
        # drafts under its own backend, and the 8 tokens after the first
        # fill two bursts of W = 4 lanes: every draft accepted
        assert st["spec_accepted"] == st["spec_drafted"] == 6 * len(prompts)


def test_spec_restore_puts_the_state_back(cfg, params):
    pol = _pol(cfg, spec_k=3)
    st = RecurrentDecodeState(cfg, params, pol, 2, 64, device="cpu")
    st.enable_speculative(3)
    toks = np.zeros((2, 16), np.int32)
    toks[:, :9] = _prompts(cfg, (9,))[0]
    first = st.prefill_into([0, 1], toks, np.array([9, 9], np.int32))
    last = first.clone()
    live = torch.ones(2, dtype=torch.int32)
    before = {k: v.clone() for k, v in st.data.items()}
    snap = st.spec_snapshot(last)
    for _ in range(3):
        st.draft_step(last, live)
    assert not torch.equal(st.data["h"], before["h"])
    st.spec_restore(snap)
    for k in before:
        assert torch.equal(st.data[k], before[k]), k
    assert st.pos_dev.tolist() == [9, 9]


# the burst of the verify-program comparison: rows of candidates after
# prompts of PLEN tokens, budgets REM, row 3 dead
VB, W = 5, 4
PLEN = np.array([9, 14, 5, 7, 11], np.int32)
REM = np.array([9, 9, 2, 9, 9], np.int32)
LIVE = np.array([1, 1, 1, 0, 1], np.int32)


@pytest.fixture(scope="module")
def models():
    from repro.configs import get_config as jax_config
    from repro.models import api as japi
    from repro_torch.bridge import params_from_numpy
    jcfg = jax_config("mamba2-1.3b").reduced()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("mamba2-1.3b").reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _burst_inputs(cfg):
    rng = np.random.default_rng(9)
    toks = np.zeros((VB, 16), np.int32)
    for b in range(VB):
        toks[b, :PLEN[b]] = rng.integers(0, cfg.vocab, PLEN[b])
    return toks


def test_verify_program_matches_the_reference(models):
    """The same prompts prefilled on both sides, the reference's greedy
    drafts (row 1 broken at lane 2) as the burst: the port's recurrent
    verify against the reference's on the lane logits of its first scan,
    the block, next input, positions, budgets and the state after the
    replay."""
    from repro.models import api as japi
    from repro.models.decode_state import _spec_programs
    from repro.runtime import resolve_policy as jax_policy
    jcfg, jp, cfg, tp = models
    jpol = jax_policy(jcfg, env={}, exp_backend="vexp",
                      kernel_backend="reference")
    toks = _burst_inputs(cfg)
    lg, c0 = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                     "prompt_len": jnp.asarray(PLEN)},
                          policy=jpol)
    cand = [np.asarray(lg)[:, 0].argmax(-1).astype(np.int32)]
    cur, c, lanes = jnp.asarray(cand[0][:, None]), c0, []
    for i in range(W):
        lg, c = japi.decode_step(jp, jcfg, cur, c, 0, policy=jpol)
        lanes.append(np.asarray(lg)[:, 0])
        cur = jnp.argmax(lg, -1).astype(jnp.int32)
        if i < W - 1:
            cand.append(np.asarray(cur)[:, 0])
    cand = np.stack(cand, 1).astype(np.int32)
    cand[1, 2] = (cand[1, 2] + 1) % jcfg.vocab
    verify = _spec_programs(jcfg, jpol, W, "recurrent", None, impl="scan")
    want = verify(jp, jnp.asarray(cand), c0, jnp.asarray(PLEN),
                  jnp.asarray(REM), jnp.asarray(LIVE))
    block_w, nlast_w, state_w, pos_w, rem_w = (
        np.asarray(want[0]), np.asarray(want[1]),
        jax.tree.map(np.asarray, want[2]), np.asarray(want[3]),
        np.asarray(want[4]))

    pol = resolve_policy(cfg, env={}, exp_backend="vexp")
    _, state = ssm.prefill(tp, cfg, torch.from_numpy(toks),
                           prompt_len=torch.from_numpy(PLEN), policy=pol)
    c = {"toks": torch.from_numpy(cand), "pos0": torch.from_numpy(PLEN),
         "rem": torch.from_numpy(REM.copy()),
         "block": torch.zeros((VB, W), dtype=torch.int32),
         "nlast": torch.zeros((VB, 1), dtype=torch.int32),
         "live": torch.from_numpy(LIVE),
         "pos": torch.zeros(VB, dtype=torch.int32),
         "h": torch.zeros_like(state["h"]),
         "conv": torch.zeros_like(state["conv"]),
         "snap_h": state["h"].clone(), "snap_conv": state["conv"].clone()}
    _spec_verify_fn(tp, cfg, pol, W, "recurrent", None, "scan")(c)
    jl = np.stack(lanes, 1)
    top = np.sort(jl, axis=-1)
    near = top[..., -1] - top[..., -2] <= 2 * LOGIT_TOL
    got = (c["block"].numpy(), c["nlast"].numpy(), c["pos"].numpy(),
           c["rem"].numpy())
    same = 0
    for b in range(VB):
        rows = list(zip((g[b] for g in got),
                        (w[b] for w in (block_w, nlast_w, pos_w, rem_w))))
        if all(np.array_equal(g, w) for g, w in rows):
            same += 1
            continue
        diff = np.flatnonzero(rows[0][0] != rows[0][1])
        first = int(diff[0]) if len(diff) else W - 1
        assert near[b, :first + 1].any(), (b, rows)
    assert same >= 4
    m = (got[0] != SPEC_PAD).sum(1)
    # row 0 accepts every draft, row 1 breaks at lane 2, row 2 is held
    # to its budget of 2, row 3 is dead
    assert [int(x) for x in m] == [4, 2, 2, 0, 4]
    np.testing.assert_array_equal(got[2], PLEN + m)
    np.testing.assert_array_equal(got[3], REM - m)
    for name in ("h", "conv"):
        d = float(np.abs(state_w[name] - c[name].numpy()).max())
        assert d <= STATE_TOL, (name, d)
    # the dead row's state is the snapshot's, bit for bit
    assert torch.equal(c["h"][:, 3], c["snap_h"][:, 3])


# ------------------------------------------------------- the graph arm

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


@pytest.mark.parametrize("spec", [0, 3], ids=["plain", "spec"])
def test_graph_arm_replays_what_the_group_captured(cfg, params, spec,
                                                   host_graphs):
    """Built, the group holds its decode step and chunk program (and,
    speculating, its draft step and verify), captured over the empty
    pool; every tick is then replays over a carry whose storage (h, conv,
    the snapshot, the burst buffers) never moves, and the tokens equal
    the eager arm's."""
    prompts = _prompts(cfg, LENS)
    pol = _pol(cfg, exp_backend="exact", prefill_chunk=16, spec_k=spec)
    outs = {}
    for arm in ("graph", "eager"):
        srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                     device="cpu", cuda_graphs=arm == "graph")
        g = srv._groups["default"]
        st = g.state
        s0 = srv.stats()["default"]
        if arm == "graph":
            assert s0["chunk_graph_captures"] == 1
            assert s0["graph_captures"] == (2 if spec else 1)
            assert s0.get("spec_graph_captures", 0) == (1 if spec else 0)
            assert not any(t.any() for t in st.data.values())
            carry = (graph_audit.burst_carry(st, g.last, g.live_dev) if spec
                     else st.carry(g.last, g.live_dev))
            sig = carry_signature(carry)
            if spec:
                assert {"snap_h", "snap_conv", "h", "conv"} <= set(sig)
        reqs = [Request(i, p.copy(), 9) for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        while srv.step():
            if arm == "graph":
                carry = (graph_audit.burst_carry(st, g.last, g.live_dev)
                         if spec else st.carry(g.last, g.live_dev))
                graph_audit.assert_carry_kept(sig, carry_signature(carry))
        outs[arm] = [r.out for r in reqs]
        s = srv.stats()["default"]
        if arm == "graph":
            assert s["chunk_graph_replays"] == s["prefill_chunks"] > 0
            if spec:
                assert s["spec_graph_replays"] == s["decode_steps"] > 0
                assert s["graph_replays"] == 3 * s["decode_steps"]
            else:
                assert s["graph_replays"] == s["decode_steps"] > 0
        srv.assert_idle_clean()
    assert outs["graph"] == outs["eager"]
