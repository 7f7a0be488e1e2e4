"""Request lifecycle and fault handling of the port's serving engine
(reduced gpt2-small on the CPU): the counterparts of the 17 tests of
``tests/test_fault_tolerance.py``, with the port's ``Server``.

The contract everywhere: a fault may cost the faulted request its tokens,
but never changes another request's tokens and never leaks a page or a
slot; every test ends on the engine's own sweep (``check_invariants`` /
``assert_idle_clean``). Also: the port's ``FaultInjector`` fires the same
faults in the same order as the reference's for one seed, and a slot
reused after a quarantine serves the tokens of a run that was never
poisoned only because the quarantine scrubs it.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.ft import (POINTS, FaultInjector,  # noqa: E402
                            default_chaos_rates)
from repro_torch.launch.serve import (DEGRADE_AFTER,  # noqa: E402
                                      MAX_ADMIT_RETRIES, RESTORE_AFTER,
                                      Request, Server)
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402

EXP_BACKENDS = ("exact", "vexp", "vexp_hw")
PAGE = 8


@pytest.fixture(scope="module")
def cfg():
    return get_config("gpt2-small").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return api.init_params(cfg, 0, device="cpu")


def _pol(cfg, **kw):
    return resolve_policy(cfg, env={}, block_page=PAGE, **kw)


def _server(cfg, params, *, max_batch=4, policy=None, **kw):
    return Server(cfg, params, max_batch=max_batch, max_seq=64,
                  policy=policy or _pol(cfg), device="cpu", **kw)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _oracle(cfg, params, prompts, *, max_new=6, **kw):
    """Fault-free tokens, one list per rid."""
    srv = _server(cfg, params, **kw)
    reqs = [Request(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    srv.run(reqs)
    return {r.rid: list(r.out) for r in reqs}


# ------------------------------------------------------- request lifecycle

class TestLifecycle:
    def test_deadline_expires_queued_requests(self, cfg, params):
        srv = _server(cfg, params, max_batch=2, deadline_s=1e-6)
        reqs = [Request(i, p.copy(), 4)
                for i, p in enumerate(_prompts(cfg, (5, 7, 9)))]
        for r in reqs:
            srv.submit(r)
        time.sleep(0.01)                  # everyone is past their TTL
        srv.drain()
        for r in reqs:
            assert r.finish_reason == "deadline" and r.out == []
            assert r.t_done > 0
        assert srv.stats()["default"]["deadline_missed"] == 3
        srv.check_invariants()
        srv.assert_idle_clean()

    def test_per_request_deadline_overrides_server_default(self, cfg,
                                                           params):
        prompts = _prompts(cfg, (5, 5))
        srv = _server(cfg, params, max_batch=1, deadline_s=60.0)
        a = Request(0, prompts[0].copy(), 4)
        b = Request(1, prompts[1].copy(), 4, deadline_s=1e-6)
        srv.run([a, b])
        assert a.finish_reason == "max_new" and len(a.out) == 4
        assert b.finish_reason == "deadline" and b.out == []
        srv.assert_idle_clean()

    def test_cancel_queued_and_mid_decode(self, cfg, params):
        prompts = _prompts(cfg, (5, 11, 7))
        oracle = _oracle(cfg, params, prompts, max_batch=1)
        srv = _server(cfg, params, max_batch=1)
        reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        for _ in range(3):                # req 0 is now mid-decode
            srv.step()
        assert srv._groups["default"].reqs[0] is not None
        assert srv.cancel(0)              # mid-decode
        assert srv.cancel(2)              # still queued
        assert not srv.cancel(99)         # unknown rid
        srv.drain()
        assert reqs[0].finish_reason == "cancelled"
        assert reqs[2].finish_reason == "cancelled" and reqs[2].out == []
        assert reqs[1].finish_reason == "max_new"
        assert reqs[1].out == oracle[1]
        assert srv.stats()["default"]["cancelled"] == 2
        assert not srv.cancel(0)          # finished
        srv.assert_idle_clean()

    def test_cancel_mid_chunk_releases_paged_reservation(self, cfg,
                                                         params):
        """``abort_chunk`` hands back the slot's pages and prefix
        references when a request is cancelled mid-prefill."""
        srv = _server(cfg, params, max_batch=2, paged=True,
                      policy=_pol(cfg, prefill_chunk=16))
        reqs = [Request(i, p.copy(), 4)
                for i, p in enumerate(_prompts(cfg, (40, 5)))]
        for r in reqs:
            srv.submit(r)
        g = srv._groups["default"]
        srv.step()                        # req 0 enters chunked prefill
        assert 0 in [r.rid for r, _ in g.prefilling.values()]
        assert g.state.alloc.n_used() > 0  # the reservation is real
        assert srv.cancel(0)
        srv.drain()
        assert reqs[0].finish_reason == "cancelled" and reqs[0].out == []
        assert reqs[1].finish_reason == "max_new" and len(reqs[1].out) == 4
        srv.check_invariants()
        srv.assert_idle_clean()           # no page outlives the cancel


# -------------------------------------------------- quarantine / isolation

class TestQuarantine:
    @pytest.mark.parametrize("exp", EXP_BACKENDS)
    def test_poisoned_slot_quarantined_others_exact(self, cfg, params,
                                                    exp):
        """NaN in one slot quarantines that request; the other slot's
        tokens stay those of a fault-free run, under every exp backend,
        and no -1 is ever streamed."""
        pol = _pol(cfg, exp_backend=exp)
        prompts = _prompts(cfg, (5, 11))
        oracle = _oracle(cfg, params, prompts, policy=pol)
        srv = _server(cfg, params, max_batch=2, policy=pol)
        reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        srv.step()                        # both admitted, decoding
        g = srv._groups["default"]
        j = next(j for j in range(2)
                 if g.reqs[j] is not None and g.reqs[j].rid == 0)
        assert g.state.poison_slot(j)
        srv.drain()
        assert reqs[0].finish_reason == "quarantined" and reqs[0].out == []
        assert reqs[1].finish_reason == "max_new"
        assert reqs[1].out == oracle[1]
        assert srv.stats()["default"]["quarantined"] == 1
        srv.assert_idle_clean()

    @pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
    def test_poison_then_slot_reuse_after_scrub(self, cfg, params, paged,
                                                monkeypatch):
        """One slot: poison the first request, let quarantine scrub the
        slot, then serve a shorter prompt through it: its tokens equal a
        never-poisoned run's. Without the scrub (a plain reset), the NaN
        rows past the new occupant's length reach its output through the
        plain tier's p @ v, and it is quarantined too."""
        pol = _pol(cfg)
        prompts = _prompts(cfg, (11, 5))     # 11 % 8 != 0: private page
        kw = dict(paged=True, prefix_cache=False) if paged else {}
        oracle = _oracle(cfg, params, prompts, max_batch=1, policy=pol,
                         **kw)

        def serve():
            srv = _server(cfg, params, max_batch=1, policy=pol, **kw)
            reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
            for r in reqs:
                srv.submit(r)
            srv.step()
            assert srv._groups["default"].state.poison_slot(0)
            srv.drain()
            srv.assert_idle_clean()
            return reqs

        reqs = serve()
        assert reqs[0].finish_reason == "quarantined"
        assert reqs[1].finish_reason == "max_new"
        assert reqs[1].out == oracle[1]
        cls = type(_server(cfg, params, max_batch=1, policy=pol,
                           **kw)._groups["default"].state)
        monkeypatch.setattr(cls, "scrub_slot",
                            lambda self, j: self.reset_slots([j]))
        unscrubbed = serve()
        assert [r.finish_reason for r in unscrubbed] == ["quarantined"] * 2


# ------------------------------------------------------ step-fault healing

class TestStepFaultRecovery:
    def test_injected_step_error_reserves_token_identically(self, cfg,
                                                            params):
        """A decode-dispatch fault resets the pool; every in-flight
        request is re-queued and re-served from scratch, finishing with
        the tokens of an undisturbed run."""
        prompts = _prompts(cfg, (5, 11))
        oracle = _oracle(cfg, params, prompts)
        inj = FaultInjector(seed=0, schedule={"decode.step_error": [2]})
        srv = _server(cfg, params, max_batch=2, injector=inj)
        reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
        srv.run(reqs)
        st = srv.stats()["default"]
        assert st["step_faults"] == 1 and st["requeued"] == 2
        for r in reqs:
            assert r.finish_reason == "max_new" and r.retries == 1
            assert r.out == oracle[r.rid], r.rid
        srv.assert_idle_clean()

    def test_repeat_offender_is_shed_not_retried_forever(self, cfg,
                                                         params):
        inj = FaultInjector(seed=0,
                            schedule={"decode.step_error": range(100)})
        srv = _server(cfg, params, max_batch=1, injector=inj)
        r = Request(0, _prompts(cfg, (5,))[0], 6)
        srv.run([r])
        assert r.finish_reason == "failed" and r.out == []
        st = srv.stats()["default"]
        assert st["shed"] == 1 and st["step_faults"] == 4  # 1 + 3 retries
        srv.assert_idle_clean()


# ------------------------------------------------- bounded admission retry

class TestBoundedAdmission:
    @pytest.mark.parametrize("chunk", [0, 16], ids=["waves", "chunked"])
    def test_unservable_requests_shed(self, cfg, params, chunk):
        """A pool whose budget is below one cold reservation (8 pages of
        8 tokens at max_seq 64; the pool allocates 3) can never admit,
        and no page frees on its own: both admission modes back off a
        bounded number of times, then shed, and the drain returns."""
        srv = _server(cfg, params, max_batch=2, paged=True, block_budget=4,
                      policy=_pol(cfg, prefill_chunk=chunk))
        reqs = [Request(i, p.copy(), 4)
                for i, p in enumerate(_prompts(cfg, (40, 9)))]
        srv.run(reqs)
        for r in reqs:
            assert r.finish_reason == "failed" and r.out == []
        st = srv.stats()["default"]
        assert st["shed"] == 2
        assert st["admit_retries"] >= MAX_ADMIT_RETRIES
        srv.assert_idle_clean()

    def test_transient_rejection_retries_with_work_in_flight(self, cfg,
                                                             params):
        """An injected admission rejection on the second wave, while the
        first decodes: retried next tick, invisible to the tokens."""
        prompts = _prompts(cfg, (5, 7, 9, 11))
        oracle = _oracle(cfg, params, prompts, max_batch=2)
        inj = FaultInjector(seed=0, schedule={"admit.out_of_blocks": [1]})
        srv = _server(cfg, params, max_batch=2, injector=inj)
        reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
        srv.run(reqs)
        for r in reqs:
            assert r.finish_reason == "max_new"
            assert r.out == oracle[r.rid], r.rid
        assert inj.stats()["fired"] == {"admit.out_of_blocks": 1}
        assert srv.stats()["default"]["admit_retries"] >= 1
        srv.assert_idle_clean()


# ------------------------------------------------------ degradation ladder

class TestDegradationLadder:
    def test_escalates_and_restores_with_hysteresis(self, cfg, params):
        pol = _pol(cfg, exp_backend="exact", prefill_chunk=16)
        srv = _server(cfg, params, max_batch=2, policy=pol,
                      degrade_groups=("default",))
        g = srv._groups["default"]
        base_chunk = g.chunk_c
        assert g.degradable and srv.degrade_level == 0

        def tick(pressured):
            g._admit_pressure = pressured
            srv._degradation_tick()

        for _ in range(DEGRADE_AFTER - 1):
            tick(True)
        assert srv.degrade_level == 0     # hysteresis: not yet
        tick(True)
        assert srv.degrade_level == 1     # L1: narrower chunks
        assert 0 < g.chunk_c < base_chunk
        assert g.policy.exp_backend == "exact"
        for _ in range(DEGRADE_AFTER):
            tick(True)
        assert srv.degrade_level == 2     # L2: the cheaper exp
        assert g.policy.exp_backend == pol.degrade_exp_backend == "vexp_hw"
        assert g.state.policy == g.policy
        for _ in range(RESTORE_AFTER):
            tick(False)
        assert srv.degrade_level == 1
        for _ in range(RESTORE_AFTER):
            tick(False)
        assert srv.degrade_level == 0 and srv.fault_stats()[
            "degrade_peak"] == 2
        assert g.chunk_c == base_chunk
        assert g.policy.exp_backend == g.state.policy.exp_backend == "exact"

    def test_non_degradable_group_keeps_its_backend(self, cfg, params):
        srv = _server(cfg, params, max_batch=2,
                      policy=_pol(cfg, exp_backend="exact"))
        g = srv._groups["default"]
        g.set_degraded(2)
        assert g.policy.exp_backend == "exact"

    def test_unknown_degrade_group_rejected(self, cfg, params):
        with pytest.raises(ValueError, match="unknown degrade group"):
            _server(cfg, params, max_batch=2, degrade_groups=("nope",))

    def test_degraded_serving_matches_degraded_oracle(self, cfg, params):
        """Tokens served at L2 equal a server run at vexp_hw outright."""
        pol = _pol(cfg, exp_backend="exact")
        prompts = _prompts(cfg, (5, 11))
        hw = _oracle(cfg, params, prompts,
                     policy=pol.replace(exp_backend="vexp_hw"))
        srv = _server(cfg, params, max_batch=2, policy=pol,
                      degrade_groups=("default",))
        srv._groups["default"].set_degraded(2)
        reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
        srv.run(reqs)
        for r in reqs:
            assert r.out == hw[r.rid], r.rid
        srv.assert_idle_clean()


# --------------------------------------------------------- chaos storms

def _storm(cfg, params, *, seed, paged, prompts, oracle):
    inj = FaultInjector(seed=seed, rates=default_chaos_rates())
    srv = _server(cfg, params, injector=inj, paged=paged)
    reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.cancel(3)                         # a cancellation mid-storm too
    srv.drain()
    for r in reqs:                        # nobody is left in limbo
        assert r.finish_reason is not None, r.rid
        assert all(t >= 0 for t in r.out), r.rid
    for r in reqs:                        # served ones: fault-free tokens
        if r.finish_reason in ("max_new", "length_cap"):
            assert r.out == oracle[r.rid], r.rid
    srv.check_invariants()
    srv.assert_idle_clean()               # no page or slot leaked
    return srv, reqs


class TestChaosStorm:
    @pytest.mark.parametrize("paged", (False, True),
                             ids=("contiguous", "paged"))
    def test_seeded_storm_clean_shutdown(self, cfg, params, paged):
        prompts = _prompts(cfg, (5, 11, 7, 9, 13, 6, 8, 10))
        oracle = _oracle(cfg, params, prompts, paged=paged)
        srv, _ = _storm(cfg, params, seed=11, paged=paged, prompts=prompts,
                        oracle=oracle)
        fired = srv.fault_stats()["injector"]["fired"]
        assert sum(fired.values()) >= 1   # the storm stormed

    def test_storm_is_replayable_by_seed(self, cfg, params):
        prompts = _prompts(cfg, (5, 11, 7, 9, 13, 6))
        oracle = _oracle(cfg, params, prompts)
        runs = []
        for _ in range(2):
            srv, reqs = _storm(cfg, params, seed=5, paged=False,
                               prompts=prompts, oracle=oracle)
            runs.append((srv.fault_stats()["injector"]["fired"],
                         [(r.rid, r.finish_reason, r.out) for r in reqs]))
        assert runs[0] == runs[1]


# ------------------------------------------------ the injector, both packages

@pytest.mark.parametrize("seed", [0, 5, 11])
def test_injector_fires_as_the_reference_does(seed):
    """One seed, one event order: the port's injector fires the same
    points at the same evaluations, and picks the same victims, as the
    reference's (numpy only on both sides)."""
    from repro.ft import inject as ref
    assert POINTS == ref.POINTS
    assert default_chaos_rates() == ref.default_chaos_rates()
    kw = dict(rates=default_chaos_rates(), schedule={"chunk.delay": [1, 4]},
              limits={"decode.step_error": 2})
    ours, theirs = FaultInjector(seed=seed, **kw), ref.FaultInjector(
        seed=seed, **kw)
    events = np.random.default_rng(seed + 100).integers(0, len(POINTS), 400)
    for e in events:
        point = POINTS[int(e)]
        assert ours.fire(point) == theirs.fire(point), point
        if point == "decode.poison":
            assert ours.choose(list(range(8))) == theirs.choose(
                list(range(8)))
    assert ours.stats() == theirs.stats()
    assert sum(ours.stats()["fired"].values()) > 0
    assert ours.stats()["fired"].get("decode.step_error", 0) <= 2
    with pytest.raises(ValueError, match="unknown injection point"):
        FaultInjector(rates={"decode.oops": 1.0})
    env = FaultInjector.from_env({"REPRO_FAULT_SEED": str(seed)})
    assert env.seed == seed
