"""Self-speculative decode in the port (reduced gpt2-small on the CPU):
the counterparts of ``tests/test_speculative.py``'s classes, with the
port's ``Server`` and serving states.

* Identity: with the "scan" verify a speculating server emits the plain
  server's tokens and finish reasons, contiguous and paged, under every
  exp backend, near the cache cap, behind chunked prefill, for k = 2
  and 4; the paged pool leaks nothing.
* The draft agrees with the verify often enough (an acceptance floor),
  and a group that drafts under its own backend accepts every draft
  lane no budget or cap clamps.
* Rollback: ``spec_restore`` puts the positions back, and the pool then
  decodes as one that never drafted.
* Validation of the policy fields, ``enable_speculative``, a sharded
  state and the Server's ``spec_groups``.
* "chunk" verify: tokens equal the plain server's up to a near tie
  (top-2 gap <= 2 * LOGIT_TOL under the policy's own prefill), and the
  paged pool leaks nothing.
* Against the JAX package, on weights bridged from it: ``_spec_accept``
  bit for bit on the same integer inputs (poisoned lanes, clamps, dead
  rows, a poisoned t0); the verify programs of both impls and pools on
  the same bursts, blocks equal wherever no scored lane is a near tie
  and lane logits within LOGIT_TOL (the tolerance of
  ``test_torch_model.py``); the speculating Server against the JAX
  Server, near ties aside.
* The burst as CUDA-graph replays, under host stand-ins of the graph
  API (``test_torch_graph_audit.py``'s): every program captured when the
  group is built (each ladder rung's), nothing after; the burst buffers
  and the decode carry kept in place across bursts; tokens equal the
  eager arm's.
* Faults in a burst: an injected step error mid-burst re-queues the
  victims, re-served token-identically; a poisoned slot is quarantined
  and no SPEC_PAD or -1 is ever streamed.
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
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.decode_state import (  # noqa: E402
    SPEC_PAD, KVDecodeState, PagedKVDecodeState, _spec_accept,
    _spec_verify_fn)
from repro_torch.runtime import resolve_policy  # noqa: E402
from repro_torch.runtime.graphs import StepGraph, carry_signature  # noqa: E402

LOGIT_TOL = 0.02          # as in test_torch_model.py
EXP_BACKENDS = ("exact", "vexp", "vexp_hw")
PAGE = 8
LENS = (5, 11, 17, 8, 26)


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


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _pol(cfg, **kw):
    return resolve_policy(cfg, env={}, block_page=PAGE, **kw)


def _serve(cfg, params, prompts, *, policy, max_new=12, max_batch=4,
           max_seq=64, **kw):
    srv = Server(cfg, params, max_batch=max_batch, max_seq=max_seq,
                 policy=policy, device="cpu", **kw)
    reqs = [Request(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    srv.run(reqs)
    return {r.rid: (list(r.out), r.finish_reason) for r in reqs}, srv


def _counts_add_up(st):
    assert st["spec_bursts"] > 0
    assert st["spec_accepted"] + st["spec_rolled_back"] == \
        st["spec_drafted"] == st["spec_bursts"] * st["spec_k"]


# ------------------------------------------------------ speculative == plain

class TestSpeculativeIdentity:
    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    @pytest.mark.parametrize("exp", EXP_BACKENDS)
    def test_scan_equals_plain(self, cfg, params, exp, paged):
        """More requests than slots, so slots free mid-decode and later
        requests are admitted between bursts."""
        prompts = _prompts(cfg, LENS)
        base = _pol(cfg, exp_backend=exp)
        plain, _ = _serve(cfg, params, prompts, policy=base, paged=paged)
        spec, srv = _serve(cfg, params, prompts, paged=paged,
                           policy=base.replace(spec_k=4))
        assert spec == plain
        st = srv.stats()["default"]
        _counts_add_up(st)
        assert st["spec_verify"] == "scan"
        assert st["draft_exp_backend"] == "vexp_hw"
        srv.assert_idle_clean()          # rollback leaked no page

    def test_k2_and_another_draft(self, cfg, params):
        prompts = _prompts(cfg, LENS)
        base = _pol(cfg, exp_backend="exact")
        plain, _ = _serve(cfg, params, prompts, policy=base)
        spec, srv = _serve(cfg, params, prompts, policy=base.replace(
            spec_k=2, draft_exp_backend="vexp"))
        assert spec == plain
        _counts_add_up(srv.stats()["default"])

    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    def test_rows_near_the_cap(self, cfg, params, paged):
        """A 32-row cache and prompts of 26-31 tokens: draft steps run
        past the cap, the verify clamps each row to the room left, and
        every request stops at the cap with the plain tokens."""
        prompts = _prompts(cfg, (26, 29, 31, 30, 12))
        base = _pol(cfg)
        plain, _ = _serve(cfg, params, prompts, policy=base, paged=paged,
                          max_seq=32)
        spec, srv = _serve(cfg, params, prompts, paged=paged, max_seq=32,
                           policy=base.replace(spec_k=4))
        assert spec == plain
        assert [plain[i][1] for i in range(4)] == ["length_cap"] * 4
        assert [len(plain[i][0]) for i in range(4)] == [7, 4, 2, 3]
        srv.assert_idle_clean()

    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    def test_chunked_prefill_composes(self, cfg, params, paged):
        """Bursts while prompts stream in: a mid-prefill slot is dead to
        the drafts and the verify, its pinned position untouched."""
        prompts = _prompts(cfg, (5, 21, 8, 17))
        base = _pol(cfg, prefill_chunk=8)
        plain, _ = _serve(cfg, params, prompts, policy=base, paged=paged,
                          max_batch=2)
        spec, srv = _serve(cfg, params, prompts, paged=paged, max_batch=2,
                           policy=base.replace(spec_k=4))
        assert spec == plain
        st = srv.stats()["default"]
        assert st["prefill_chunks"] > 0 and st["decode_steps_prefilling"] > 0
        srv.assert_idle_clean()

    def test_spec_groups_opt_in(self, cfg, params):
        """Only named groups speculate; the others run the plain step."""
        base = _pol(cfg)
        srv = Server(cfg, params, max_batch=2, max_seq=64,
                     policy=base.replace(spec_k=2),
                     policy_groups={"aux": base.replace(spec_k=3)},
                     spec_groups=("default",), device="cpu")
        assert srv._groups["default"].spec_k == 2
        assert srv._groups["aux"].spec_k == 0
        assert "spec_k" not in srv.stats()["aux"]
        srv = Server(cfg, params, max_batch=2, max_seq=64,
                     policy=base.replace(spec_k=2),
                     policy_groups={"aux": base}, device="cpu")
        assert (srv._groups["default"].spec_k, srv._groups["aux"].spec_k) \
            == (2, 0)


# -------------------------------------------------- draft / verify agreement

class TestDraftAgreement:
    @pytest.mark.parametrize("draft", ("vexp", "vexp_hw"))
    def test_acceptance_floor(self, cfg, params, draft):
        """The acceptance share is the draft's agreement with the verify:
        a broken draft would collapse it to ~1 / vocab."""
        _, srv = _serve(cfg, params, _prompts(cfg, (5, 11, 17, 8)),
                        max_new=16, policy=_pol(cfg, exp_backend="exact",
                                                spec_k=4,
                                                draft_exp_backend=draft))
        st = srv.stats()["default"]
        assert st["spec_drafted"] > 0 and st["spec_acceptance"] > 0.25

    @pytest.mark.parametrize("verify", ("scan", "chunk"))
    def test_own_backend_draft_accepts_every_unclamped_lane(self, cfg,
                                                            params, verify):
        """A group that drafts under its own backend (the card's hw
        control): scan verify reruns the draft's own steps, so each
        request takes ceil((max_new - 1) / W) bursts, and only the last
        one, clamped by the budget, rolls drafts back."""
        _, srv = _serve(cfg, params, _prompts(cfg, (5, 11, 17, 8)),
                        max_new=13, policy=_pol(
                            cfg, exp_backend="vexp_hw", spec_k=4,
                            draft_exp_backend="vexp_hw", spec_verify=verify))
        st = srv.stats()["default"]
        if verify == "scan":     # 12 tokens after the first: W, W, 2
            assert st["spec_bursts"] == 4 * 3
            assert st["spec_accepted"] == 4 * (12 - 3)
        else:                    # the chunk program may disagree
            assert st["spec_acceptance"] > 0.5


# ------------------------------------------------------------ rollback

class TestRollbackPurity:
    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    def test_restore_positions_and_behavior(self, cfg, params, paged):
        """Drafts advance the positions and write rows; ``spec_restore``
        puts the positions back bit for bit, and the pool then decodes
        exactly like one that never drafted; a paged pool's allocator is
        untouched."""
        cls = PagedKVDecodeState if paged else KVDecodeState

        def make():
            st = cls(cfg, params, _pol(cfg, spec_k=4), 2, 64, device="cpu")
            toks = np.zeros((2, st.prefill_width(9)), np.int32)
            plens = np.array([9, 5], np.int32)
            p = _prompts(cfg, (9, 5), seed=0)
            toks[0, :9], toks[1, :5] = p
            first = st.prefill_into([0, 1], toks, plens)
            return st, first.clone()

        live = torch.ones(2, dtype=torch.int32)
        st, last = make()
        st.enable_speculative(4)
        pos_before = st.pos_dev.clone()
        used = st.alloc.n_used() if paged else None
        snap = st.spec_snapshot(last)
        cur = last.clone()
        for _ in range(4):
            st.draft_step(cur, live)
        assert torch.equal(st.pos_dev, pos_before + 4)
        st.spec_restore(snap)
        assert torch.equal(st.pos_dev, pos_before)
        if paged:
            assert st.alloc.n_used() == used
        ctrl, clast = make()
        a, b = last.clone(), clast.clone()
        for _ in range(6):
            a.copy_(st.step(a, live))
            b.copy_(ctrl.step(b, live))
            assert torch.equal(a, b)

    def test_reset_and_recover_clear_the_burst_buffers(self, cfg, params):
        st = KVDecodeState(cfg, params, _pol(cfg), 2, 64, device="cpu")
        st.enable_speculative(2)
        for t in st._burst_buffers():
            t.fill_(7)
        st.reset_slots([1])
        assert all(bool((t[1] == 0).all()) and bool((t[0] == 7).all())
                   for t in st._burst_buffers())
        st.recover()
        assert all(not t.any() for t in st._burst_buffers())
        st.check_integrity(())


# ---------------------------------------------------------- validation

class _OneRankOfTwo:
    """The rank-0 view of a two-rank ShardGroup: enough to build a
    sequence-sharded state, which here never reaches a collective."""
    world, rank, calls = 2, 0, 0


class TestSpecValidation:
    @pytest.mark.parametrize("field,value", [
        ("spec_k", 1), ("spec_k", -2), ("spec_verify", "fused"),
        ("draft_exp_backend", "fast")])
    def test_policy_fields_rejected(self, cfg, field, value):
        with pytest.raises(ValueError, match=field):
            _pol(cfg).replace(**{field: value})

    def test_env_overrides_and_describe(self, cfg):
        pol = resolve_policy(cfg, env={"REPRO_SPEC_K": "3",
                                       "REPRO_DRAFT_EXP_BACKEND": "vexp",
                                       "REPRO_SPEC_VERIFY": "chunk"})
        assert (pol.spec_k, pol.draft_exp_backend, pol.spec_verify) == \
            (3, "vexp", "chunk")
        assert "spec_k=3 draft=vexp spec_verify=chunk" in pol.describe()
        assert (_pol(cfg).spec_k, _pol(cfg).draft_exp_backend,
                _pol(cfg).spec_verify) == (0, "vexp_hw", "scan")

    def test_enable_speculative_validates_k(self, cfg, params):
        st = KVDecodeState(cfg, params, _pol(cfg), 2, 64, device="cpu")
        for k in (1, 0, 2.0):
            with pytest.raises(ValueError, match="spec_k"):
                st.enable_speculative(k)

    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    def test_sharded_state_refuses(self, cfg, params, paged):
        """A sequence-sharded pool cannot speculate (the reference's
        sharded states neither): the state and the Server both raise."""
        pol = _pol(cfg, spec_k=2)
        cls = PagedKVDecodeState if paged else KVDecodeState
        st = cls(cfg, params, pol, 2, 64, device="cpu",
                 comm=_OneRankOfTwo())
        assert not st.supports_speculative()
        with pytest.raises(ValueError, match="sequence-sharded"):
            st.enable_speculative(2)
        with pytest.raises(ValueError, match="speculative"):
            Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                   device="cpu", kv_mode="seq", shards=_OneRankOfTwo(),
                   paged=paged)

    def test_server_spec_group_validation(self, cfg, params):
        base = _pol(cfg)
        with pytest.raises(ValueError, match="unknown spec group"):
            Server(cfg, params, max_batch=2, max_seq=64, policy=base,
                   device="cpu", spec_groups=("nope",))
        with pytest.raises(ValueError, match="spec_k=0"):
            Server(cfg, params, max_batch=2, max_seq=64, policy=base,
                   device="cpu", spec_groups=("default",))

    def test_recurrent_verify_waits_for_a11(self, cfg, params):
        # both recurrent modes are ported (A11b brought the hybrid's
        # ring-pool mode), scan only, as in the reference
        for mode in ("recurrent", "recurrent_paged"):
            assert callable(_spec_verify_fn(params, cfg, _pol(cfg), 3,
                                            mode, None, "scan"))
            with pytest.raises(ValueError, match="scan"):
                _spec_verify_fn(params, cfg, _pol(cfg), 3, mode, None,
                                "chunk")
        with pytest.raises(ValueError, match="mode"):
            _spec_verify_fn(params, cfg, _pol(cfg), 3, "ring", None,
                            "scan")
        with pytest.raises(ValueError, match="impl"):
            _spec_verify_fn(params, cfg, _pol(cfg), 3, "kv", 64, "fused")


# --------------------------------------------------------- chunk verify

def _assert_near_tie_equal(cfg, params, pol, prompts, got, want):
    """Each request's tokens equal ``want``'s, or first leave them at a
    step where the policy's own prefill of the prefix has a top-2 logit
    gap <= 2 * LOGIT_TOL. Returns the number of identical requests."""
    same = 0
    for rid, (toks, reason) in got.items():
        ref, ref_reason = want[rid]
        assert len(toks) == len(ref) and reason == ref_reason
        assert all(t >= 0 for t in toks)
        diff = [i for i, (a, b) in enumerate(zip(toks, ref)) if a != b]
        if not diff:
            same += 1
            continue
        seq = np.concatenate([prompts[rid], np.asarray(ref[:diff[0]],
                                                       np.int32)])
        lg, _ = api.prefill(params, cfg, {"tokens": seq[None]}, policy=pol,
                            device="cpu")
        top = torch.topk(lg[0, 0], 2).values
        assert float(top[0] - top[1]) <= 2 * LOGIT_TOL, (rid, diff[0])
    return same


class TestChunkVerify:
    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    def test_chunk_tokens_are_policy_argmaxes(self, cfg, params, paged):
        prompts = _prompts(cfg, LENS)
        base = _pol(cfg, exp_backend="exact")
        plain, _ = _serve(cfg, params, prompts, policy=base, paged=paged)
        cpol = base.replace(spec_k=4, spec_verify="chunk")
        out, srv = _serve(cfg, params, prompts, policy=cpol, paged=paged)
        st = srv.stats()["default"]
        assert st["spec_verify"] == "chunk"
        _counts_add_up(st)
        assert _assert_near_tie_equal(cfg, params, base, prompts, out,
                                      plain) >= 1
        srv.assert_idle_clean()

    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    def test_chunk_verify_near_the_cap(self, cfg, params, paged):
        """Rows with fewer lanes of room than W: the chunk's masked lanes
        write nothing, and every request stops at the cap."""
        prompts = _prompts(cfg, (26, 29, 31, 30))
        base = _pol(cfg)
        plain, _ = _serve(cfg, params, prompts, policy=base, paged=paged,
                          max_seq=32)
        out, srv = _serve(cfg, params, prompts, paged=paged, max_seq=32,
                          policy=base.replace(spec_k=4,
                                              spec_verify="chunk"))
        _assert_near_tie_equal(cfg, params, base, prompts, out, plain)
        assert all(r == "length_cap" for _, r in out.values())
        srv.assert_idle_clean()

    def test_all_lanes_last_lane_is_the_chunk_logits(self, cfg, params):
        """``all_lanes`` gives every lane's logits; at each row's last
        valid lane they are the plain chunk program's (within f32
        rounding: the logits matmul runs at another shape)."""
        toks = np.asarray(_prompts(cfg, (3 * 6,), seed=5)[0]).reshape(3, 6)
        off, clens = np.array([0, 4, 9], np.int32), np.array([6, 3, 0],
                                                            np.int32)
        pol = _pol(cfg)
        out = []
        for all_lanes in (False, True):
            cache = api.init_cache(cfg, 3, 32, device="cpu")
            lg, _ = api.prefill_chunk(params, cfg, toks, cache, off, clens,
                                      policy=pol, all_lanes=all_lanes,
                                      device="cpu")
            out.append(lg)
        assert out[0].shape == (3, 1, cfg.vocab_padded)
        assert out[1].shape == (3, 6, cfg.vocab_padded)
        for b, n in enumerate(clens[:2]):
            torch.testing.assert_close(out[1][b, n - 1], out[0][b, 0],
                                       rtol=0, atol=1e-5)
        assert bool((out[1][:, :, cfg.vocab:] < -1e29).all())


# ------------------------------------------------------- against the JAX

def _accept_inputs(seed):
    """(toks, logits, clens, rem, live) with agreeing prefixes of every
    length, non-finite lanes, clamps, dead rows and a poisoned t0."""
    rng = np.random.default_rng(seed)
    b, w, v = 12, 5, 7
    logits = rng.standard_normal((b, w, v)).astype(np.float32)
    e = logits.argmax(-1)
    toks = rng.integers(0, v, (b, w)).astype(np.int32)
    for i in range(b):                       # row i agrees on i % w lanes
        n = i % w
        toks[i, 1:1 + n] = e[i, :n]
        if n < w - 1:
            toks[i, 1 + n] = (e[i, n] + 1) % v
    logits[3, 2, 4] = np.nan                 # a poisoned lane mid-burst
    logits[7, 0, :] = np.inf                 # a poisoned first lane
    logits[9, 4, 1] = -np.inf                # a poisoned last lane
    toks[5, 0] = -1                          # a poisoned t0 (sticky)
    clens = rng.integers(0, w + 1, b).astype(np.int32)
    clens[:4] = w
    rem = rng.integers(0, 8, b).astype(np.int32)
    rem[:3] = 9
    live = (rng.random(b) > 0.2).astype(np.int32)
    live[:6] = 1
    return toks, logits, clens, rem, live


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_accept_matches_the_reference_bitwise(seed):
    from repro.models.decode_state import SPEC_PAD as JAX_PAD
    from repro.models.decode_state import _spec_accept as jax_accept
    ins = _accept_inputs(seed)
    want = jax_accept(*(jnp.asarray(a) for a in ins))
    got = _spec_accept(*(torch.as_tensor(a) for a in ins))
    assert SPEC_PAD == JAX_PAD
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    block, _, m = (g.numpy() for g in got)
    assert set(block[5][block[5] != SPEC_PAD]) <= {-1}   # t0 poisoned
    assert (m[ins[4] == 0] == 0).all()                   # dead rows


B, S, W = 5, 32, 5
PLEN = np.array([9, 14, 29, 6, 11], np.int32)     # row 2: 3 lanes of room
REM = np.array([10, 10, 10, 10, 2], np.int32)     # row 4: budget of 2
LIVE = np.array([1, 1, 1, 0, 1], np.int32)        # row 3: dead


def _tables():
    return np.arange(1, 1 + B * (S // PAGE), dtype=np.int32).reshape(B, -1)


_JAX_BURSTS: dict = {}


def _jax_burst(models, paged):
    """The reference's side of a burst, once per pool: its prompts
    through its chunk program, greedy drafts (row 1 broken at lane 3),
    the lanes each row may score and the all-lanes chunk logits of the
    candidates (the near-tie oracle of both impls). Returns (candidates,
    cache, tables, clens, lane logits (B, W, V))."""
    if paged in _JAX_BURSTS:
        return _JAX_BURSTS[paged]
    from repro.models import api as japi
    jcfg, jp, _, _ = models
    pol = _jax_pol(jcfg)
    toks = jnp.asarray(_verify_prompts())
    tab = jnp.asarray(_tables())
    zero = jnp.zeros(B, jnp.int32)
    if paged:
        cache = japi.init_paged_cache(jcfg, B, 1 + B * (S // PAGE), PAGE)
        lg, cache = japi.prefill_chunk_paged(jp, jcfg, toks, cache, tab, zero,
                                             jnp.asarray(PLEN), policy=pol)
    else:
        cache = japi.init_cache(jcfg, B, S)
        lg, cache = japi.prefill_chunk(jp, jcfg, toks, cache, zero,
                                       jnp.asarray(PLEN), policy=pol)
    cand = [np.asarray(lg)[:, 0].argmax(-1).astype(np.int32)]
    cur, pos, c = jnp.asarray(cand[0][:, None]), jnp.asarray(PLEN), cache
    for _ in range(W - 1):
        if paged:
            lg, c = japi.decode_step_paged(jp, jcfg, cur, c, tab, pos,
                                           policy=pol)
        else:
            lg, c = japi.decode_step(jp, jcfg, cur, c, pos, policy=pol)
        cur = jnp.argmax(lg, -1).astype(jnp.int32)
        cand.append(np.asarray(cur)[:, 0])
        pos = pos + 1
    cand = np.stack(cand, 1).astype(np.int32)
    cand[1, 3] = (cand[1, 3] + 1) % jcfg.vocab
    clens = np.where(LIVE > 0, np.clip(S - PLEN, 0, W), 0).astype(np.int32)
    args = (jp, jcfg, jnp.asarray(cand), cache)
    if paged:
        lanes, _ = japi.prefill_chunk_paged(
            *args, tab, jnp.asarray(PLEN), jnp.asarray(clens), policy=pol,
            all_lanes=True)
    else:
        lanes, _ = japi.prefill_chunk(*args, jnp.asarray(PLEN),
                                      jnp.asarray(clens), policy=pol,
                                      all_lanes=True)
    _JAX_BURSTS[paged] = (cand, cache, tab, clens, np.asarray(lanes))
    return _JAX_BURSTS[paged]


def _jax_pol(jcfg):
    from repro.runtime import resolve_policy as jax_policy
    return jax_policy(jcfg, env={}, exp_backend="vexp",
                      kernel_backend="reference")


def _jax_verify(models, impl, paged):
    """The reference's verify program on the burst: (block, nlast, pos,
    rem)."""
    from repro.models.decode_state import _spec_programs
    jcfg, jp, _, _ = models
    cand, cache, tab, _, _ = _jax_burst(models, paged)
    verify = _spec_programs(jcfg, _jax_pol(jcfg), W,
                            "kv_paged" if paged else "kv", S,
                            page=PAGE if paged else None, impl=impl)
    cache = jax.tree.map(jnp.copy, cache)         # the verify donates it
    args = (jp, jnp.asarray(cand), cache) + ((tab,) if paged else ())
    out = verify(*args, jnp.asarray(PLEN), jnp.asarray(REM),
                 jnp.asarray(LIVE))
    return tuple(np.asarray(out[i]) for i in (0, 1, 3, 4))


def _verify_prompts():
    rng = np.random.default_rng(3)
    toks = np.zeros((B, S), np.int32)
    for b in range(B):
        toks[b, :PLEN[b]] = rng.integers(0, 512, PLEN[b])
    return toks


def _port_side(models, impl, paged, cand, clens):
    """The port's prompts through its chunk program, then its verify
    program over a burst carry holding ``cand``. Returns ((block, nlast,
    pos, rem), lane logits from the same scoring as the impl)."""
    _, _, cfg, tp = models
    pol = resolve_policy(cfg, env={}, exp_backend="vexp")
    tab = torch.as_tensor(_tables())
    zero = np.zeros(B, np.int32)
    if paged:
        cache = api.init_paged_cache(cfg, 1 + B * (S // PAGE), PAGE,
                                     device="cpu")
        api.prefill_chunk_paged(tp, cfg, _verify_prompts(), cache, tab,
                                zero, PLEN, policy=pol, device="cpu")
    else:
        cache = api.init_cache(cfg, B, S, device="cpu")
        api.prefill_chunk(tp, cfg, _verify_prompts(), cache, zero, PLEN,
                          policy=pol, device="cpu")
    scratch = {k: v.clone() for k, v in cache.items()}
    ct, cl = torch.as_tensor(cand), torch.as_tensor(clens)
    p0 = torch.as_tensor(PLEN)
    if impl == "chunk":
        if paged:
            lanes, _ = transformer.prefill_chunk_paged(
                tp, cfg, ct, scratch, tab, p0, cl, policy=pol,
                all_lanes=True)
        else:
            lanes, _ = transformer.prefill_chunk(tp, cfg, ct, scratch, p0,
                                                 cl, policy=pol,
                                                 all_lanes=True)
    else:
        lanes, pos = [], p0
        for i in range(W):
            lv = torch.as_tensor(LIVE * (clens > i))
            if paged:
                lg, _ = transformer.decode_step_paged(
                    tp, cfg, ct[:, i:i + 1], scratch, tab, pos, policy=pol,
                    live=lv)
            else:
                lg, _ = transformer.decode_step(tp, cfg, ct[:, i:i + 1],
                                                scratch, pos, policy=pol,
                                                live=lv)
            lanes.append(lg[:, 0])
            pos = pos + lv
        lanes = torch.stack(lanes, 1)
    c = {"toks": ct.clone(), "pos0": p0.clone(),
         "rem": torch.as_tensor(REM).clone(),
         "block": torch.zeros((B, W), dtype=torch.int32),
         "nlast": torch.zeros((B, 1), dtype=torch.int32),
         "live": torch.as_tensor(LIVE),
         "pos": torch.zeros(B, dtype=torch.int32), **cache}
    if paged:
        c["tables"] = tab
    _spec_verify_fn(tp, cfg, pol, W, "kv_paged" if paged else "kv", S,
                    impl)(c)
    return tuple(c[k].numpy() for k in ("block", "nlast", "pos", "rem")), \
        lanes.numpy()


@pytest.mark.parametrize("impl,paged", [("scan", False), ("chunk", False),
                                        ("chunk", True)],
                         ids=["scan-contig", "chunk-contig", "chunk-paged"])
def test_verify_program_matches_the_reference(models, impl, paged):
    """The port's verify program and the reference's on one burst: the
    port's lane logits (its decode steps for "scan", its all-lanes chunk
    for "chunk") within LOGIT_TOL of the reference's all-lanes chunk
    logits, and the block, next input, positions and budgets equal
    wherever no scored lane up to the first difference is a near tie."""
    cand, _, _, clens, jlanes = _jax_burst(models, paged)
    want = _jax_verify(models, impl, paged)
    got, lanes = _port_side(models, impl, paged, cand, clens)
    scored = (np.arange(W)[None, :] < clens[:, None])
    assert np.isfinite(lanes[scored]).all()
    assert np.abs(lanes[scored] - jlanes[scored]).max() <= LOGIT_TOL
    top = np.sort(jlanes, axis=-1)
    near = (top[..., -1] - top[..., -2] <= 2 * LOGIT_TOL) & scored
    same = 0
    for b in range(B):
        rows = [(g.reshape(B, -1)[b], w.reshape(B, -1)[b])
                for g, w in zip(got, want)]
        if all(np.array_equal(g, w) for g, w in rows):
            same += 1
            continue
        # a row may leave the reference's only after a near-tie lane
        diff = np.flatnonzero(rows[0][0] != rows[0][1])
        first = int(diff[0]) if len(diff) else W - 1
        assert near[b, :first + 1].any(), (b, rows)
    assert same >= 3
    block, _, pos, rem = got
    m = (block != SPEC_PAD).sum(1)
    # row 0 accepts every draft, row 1 breaks at lane 3, row 2 is clamped
    # to its 3 lanes of room, row 3 is dead, row 4 to its budget of 2
    assert [int(x) for x in m] == [5, 3, 3, 0, 2]
    np.testing.assert_array_equal(pos, PLEN + m)
    np.testing.assert_array_equal(rem, REM - m)


def test_speculating_server_matches_the_jax_server(models):
    """Three requests through two slots (one admitted mid-decode), paged
    with prefix sharing on both sides: the port's tokens against the
    JAX Server's, near ties aside."""
    from repro.launch.serve import Request as JaxRequest, Server as JaxServer
    from repro.models import api as japi
    from repro.runtime import resolve_policy as jax_policy
    jcfg, jp, cfg, tp = models
    prompts = _prompts(cfg, (5, 19, 9), seed=17)
    news = (6, 11, 5)
    jpol = jax_policy(jcfg, env={}, exp_backend="vexp",
                      kernel_backend="reference", spec_k=4)
    jsrv = JaxServer(jcfg, jp, max_batch=2, max_seq=64, policy=jpol,
                     paged=True, block_page=PAGE)
    jreqs = [JaxRequest(i, p.copy(), n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    jsrv.run(jreqs)
    srv = Server(cfg, tp, max_batch=2, max_seq=64, device="cpu",
                 paged=True, policy=_pol(cfg, exp_backend="vexp", spec_k=4))
    reqs = [Request(i, p.copy(), n)
            for i, (p, n) in enumerate(zip(prompts, news))]
    srv.run(reqs)
    assert srv._groups["default"].spec_k == jsrv._groups["default"].spec_k
    for r, ours in zip(jreqs, [q.out for q in reqs]):
        assert len(ours) == len(r.out) == r.max_new
        diff = [i for i, (a, b) in enumerate(zip(ours, r.out)) if a != b]
        if not diff:
            continue
        seq = np.concatenate([r.prompt, np.asarray(r.out[:diff[0]],
                                                   np.int32)])
        logits, _ = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(seq[None])},
                                 policy=jpol)
        top = np.sort(np.asarray(logits)[0, 0])
        assert top[-1] - top[-2] <= 2 * LOGIT_TOL, (r.rid, diff[0])
    srv.assert_idle_clean()


# ------------------------------------------------------ the burst's graphs

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
def test_bursts_replay_graphs_captured_with_the_group(cfg, params, paged,
                                                      host_graphs):
    """Built, a speculating group holds its decode step, its draft step
    and its verify, all captured; every burst is then k draft replays and
    one verify replay, the burst buffers and the decode carry keep their
    storage across bursts and admissions, and the tokens equal the eager
    arm's."""
    prompts = _prompts(cfg, LENS)
    pol = _pol(cfg, exp_backend="exact", spec_k=3)
    outs = {}
    for arm in ("graph", "eager"):
        srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                     paged=paged, device="cpu", cuda_graphs=arm == "graph")
        g = srv._groups["default"]
        st = g.state
        s0 = srv.stats()["default"]
        if arm == "graph":
            assert (s0["graph_captures"], s0["spec_graph_captures"]) == \
                (2, 1)
            assert set(st.graphs) == {pol, pol.replace(exp_backend="vexp_hw")}
            sig = carry_signature(graph_audit.burst_carry(st, g.last,
                                                          g.live_dev))
        reqs = [Request(i, p.copy(), 9) for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        while srv.step():
            if arm == "graph":
                assert carry_signature(graph_audit.burst_carry(
                    st, g.last, g.live_dev)) == sig
        outs[arm] = [r.out for r in reqs]
        s = srv.stats()["default"]
        if arm == "graph":
            assert (s["graph_captures"], s["spec_graph_captures"]) == (2, 1)
            assert s["spec_graph_replays"] == s["decode_steps"] > 0
            assert s["graph_replays"] == 3 * s["decode_steps"]
        else:
            assert s["graph_captures"] == s["spec_graph_captures"] == 0
        srv.assert_idle_clean()
    assert outs["graph"] == outs["eager"]


def test_burst_audit_catches_a_rebound_buffer(cfg, params, monkeypatch):
    """The burst audit holds every burst buffer in place; a verify that
    rebinds its block fails it, and a snapshot that rebinds ``pos0`` is
    refused by the verify's graph on that very burst."""
    def group():
        srv = Server(cfg, params, max_batch=2, max_seq=64, device="cpu",
                     policy=_pol(cfg, spec_k=2))
        srv.submit(Request(0, _prompts(cfg, (7,))[0], 9))
        srv.step()
        return srv._groups["default"]

    g = group()
    graph_audit.audit_burst(g.state, g.last, g.live_dev, g.decode_spec_once)
    cls = type(g.state)
    verify, snapshot = cls.verify_step, cls.spec_snapshot

    def rebinding_verify(self, snap, live):
        out = verify(self, snap, live)
        self.spec_block = self.spec_block.clone()
        return out

    monkeypatch.setattr(cls, "verify_step", rebinding_verify)
    with pytest.raises(graph_audit.InPlaceCarryError, match="block"):
        graph_audit.audit_burst(g.state, g.last, g.live_dev,
                                g.decode_spec_once)
    monkeypatch.setattr(cls, "verify_step", verify)

    def rebinding_snapshot(self, last):
        self.spec_pos0 = self.spec_pos0.clone()
        return snapshot(self, last)

    g = group()
    monkeypatch.setattr(cls, "spec_snapshot", rebinding_snapshot)
    with pytest.raises(RuntimeError, match="pos0"):
        g.decode_spec_once()


def test_ladder_captures_each_rung_of_a_speculating_group(cfg, params,
                                                          host_graphs):
    """A degradable speculating group captures, per rung, the decode
    step, the draft step and the verify; moving along the ladder
    captures nothing more, and the degraded rung's bursts give the
    degraded policy's plain tokens."""
    pol = _pol(cfg, exp_backend="exact", spec_k=2, draft_exp_backend="vexp")
    deg = pol.replace(exp_backend="vexp_hw")
    srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                 device="cpu", degrade_groups=("default",))
    g = srv._groups["default"]
    assert set(g.state.graphs) == {pol, deg, pol.replace(exp_backend="vexp")}
    assert {k[0] for k in g.state.spec_progs} == {pol, deg}
    before = srv.stats()["default"]
    for level in (1, 2, 1, 0, 2):
        g.set_degraded(level)
    prompts = _prompts(cfg, (9, 5))
    reqs = [Request(i, p.copy(), 7) for i, p in enumerate(prompts)]
    srv.run(reqs)
    after = srv.stats()["default"]
    for k in ("graph_captures", "spec_graph_captures"):
        assert after[k] == before[k]
    assert (after["graph_captures"], after["spec_graph_captures"]) == (3, 2)
    plain, _ = _serve(cfg, params, prompts, policy=_pol(
        cfg, exp_backend="vexp_hw"), max_new=7)
    assert [r.out for r in reqs] == [plain[0][0], plain[1][0]]


# ---------------------------------------------------------- faults in bursts

@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_step_error_mid_burst_reserves_token_identically(cfg, params,
                                                         paged):
    """An injected dispatch fault after the drafts: the pool is zeroed in
    place, every in-flight request re-queued and re-served from scratch,
    finishing with the tokens of an undisturbed (plain) run."""
    prompts = _prompts(cfg, (5, 11))
    pol = _pol(cfg)
    plain, _ = _serve(cfg, params, prompts, policy=pol, paged=paged,
                      max_new=9, max_batch=2)
    inj = FaultInjector(seed=0, schedule={"decode.step_error": [1]})
    out, srv = _serve(cfg, params, prompts, paged=paged, max_new=9,
                      max_batch=2, policy=pol.replace(spec_k=4),
                      injector=inj)
    st = srv.stats()["default"]
    assert st["step_faults"] == 1 and st["requeued"] == 2
    assert out == plain
    srv.assert_idle_clean()


def test_poison_in_a_burst_is_quarantined(cfg, params):
    """A NaN slot in a burst: its request is quarantined and streams
    nothing, the other request keeps its plain tokens, and no SPEC_PAD
    or -1 reaches any stream."""
    prompts = _prompts(cfg, (5, 11, 8))
    pol = _pol(cfg, exp_backend="vexp")
    plain, _ = _serve(cfg, params, prompts, policy=pol, max_new=10,
                      max_batch=2)
    srv = Server(cfg, params, max_batch=2, max_seq=64, device="cpu",
                 policy=pol.replace(spec_k=4))
    reqs = [Request(i, p.copy(), 10) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.step()                                  # admitted, one burst
    g = srv._groups["default"]
    j = next(j for j in range(2) if g.reqs[j].rid == 0)
    assert g.state.poison_slot(j)
    srv.drain()
    assert reqs[0].finish_reason == "quarantined" and reqs[0].out == []
    for r in reqs[1:]:
        assert r.finish_reason == "max_new" and r.out == plain[r.rid][0]
        assert min(r.out) >= 0 and SPEC_PAD not in r.out
    assert srv.stats()["default"]["quarantined"] == 1
    srv.assert_idle_clean()
