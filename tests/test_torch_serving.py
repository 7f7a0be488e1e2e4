"""The port's continuous-batching server (``repro_torch.launch.serve``).

The identities ``tests/test_serving.py`` pins for the reference engine,
held by the port on its own (mixed-length batch == solo, FIFO admission
and slot reuse, freed slots, length cap, policy-group isolation, pow2
buckets), plus one cross-framework check: the same requests through the
JAX ``Server`` (reference tier) and the port's give the same greedy
tokens, up to the first step whose JAX top-2 logit gap is a near tie.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import Request, Server, _len_bucket  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import parse_policy_groups, resolve_policy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
LOGIT_TOL = 0.02          # as in test_torch_model.py


@pytest.fixture(scope="module")
def cfg():
    return get_config("gpt2-small").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return api.init_params(cfg, 0, device="cpu")


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _serve(cfg, params, prompts, idxs, *, max_new=6, max_batch=4,
           max_seq=64, policy=None, policy_groups=None, groups_of=None):
    srv = Server(cfg, params, max_batch=max_batch, max_seq=max_seq,
                 policy=policy, policy_groups=policy_groups, device="cpu")
    reqs = [Request(i, prompts[i].copy(), max_new,
                    group=(groups_of or {}).get(i, "default"))
            for i in idxs]
    srv.run(reqs)
    return {r.rid: r.out for r in reqs}, srv


@pytest.mark.parametrize("exp", EXPS)
def test_unequal_batch_matches_solo(cfg, params, exp):
    """A mixed-length batch gives each request the tokens it gets alone."""
    pol = resolve_policy(cfg, env={}, exp_backend=exp)
    prompts = _prompts(cfg, (5, 11, 20))
    together, _ = _serve(cfg, params, prompts, [0, 1, 2], policy=pol)
    for i in range(3):
        solo, _ = _serve(cfg, params, prompts, [i], policy=pol)
        assert together[i] == solo[i], i


@pytest.mark.parametrize("tier", ["cuda", "reference"])
def test_bhsd_cache_layout_serves_the_same_tokens(cfg, params, tier):
    """The head-major cache ("bhsd") runs the same arithmetic through other
    strides, so it emits the same tokens as "bshd"."""
    pol = resolve_policy(cfg, env={}, kernel_backend=tier)
    prompts = _prompts(cfg, (5, 11, 20), seed=1)
    seq, _ = _serve(cfg, params, prompts, [0, 1, 2], policy=pol)
    head, srv = _serve(dataclasses.replace(cfg, kv_cache_layout="bhsd"),
                       params, prompts, [0, 1, 2], policy=pol)
    assert srv._groups["default"].state.data["k"].shape[2:] == (4, 64, 32)
    assert head == seq


def test_admission_order_and_slot_reuse(cfg, params):
    """5 requests through 2 slots: FIFO admission, exact max_new each."""
    news = (2, 5, 3, 4, 1)
    prompts = _prompts(cfg, (5, 9, 7, 6, 8))
    srv = Server(cfg, params, max_batch=2, max_seq=64, device="cpu")
    reqs = [Request(i, prompts[i].copy(), news[i]) for i in range(5)]
    srv.run(reqs)
    assert srv.admit_log == [0, 1, 2, 3, 4]
    for r in reqs:
        assert len(r.out) == r.max_new and r.finish_reason == "max_new"
        assert r.t_done >= r.t_first >= r.t_submit > 0


def test_finished_slots_freed_not_burned(cfg, params):
    prompts = _prompts(cfg, (5, 7, 6))
    srv = Server(cfg, params, max_batch=2, max_seq=64, device="cpu")
    reqs = [Request(0, prompts[0].copy(), 1), Request(1, prompts[1].copy(), 8),
            Request(2, prompts[2].copy(), 1)]
    srv.run(reqs)
    assert [len(r.out) for r in reqs] == [1, 8, 1]
    assert srv.stats()["default"]["decode_steps"] <= 8


def test_decode_past_capacity_stops_slot(cfg, params):
    """length_cap: 1 prefill token + (16 - 11) decode writes."""
    srv = Server(cfg, params, max_batch=2, max_seq=16, device="cpu")
    r = Request(0, _prompts(cfg, (11,))[0], 50)
    srv.run([r])
    assert len(r.out) == 6 and r.finish_reason == "length_cap"


def test_submit_validation(cfg, params):
    srv = Server(cfg, params, max_batch=2, max_seq=16, device="cpu")
    with pytest.raises(ValueError):
        srv.submit(Request(0, np.zeros(17, np.int32), 4))
    with pytest.raises(ValueError):
        srv.submit(Request(1, np.zeros(4, np.int32), 4, group="nope"))
    with pytest.raises(ValueError):
        srv.submit(Request(2, np.zeros(4, np.int32), 0))


def test_len_bucket():
    assert [_len_bucket(n, 512) for n in (1, 8, 9, 100)] == [8, 8, 16, 128]
    assert _len_bucket(400, 96) == 96


def test_exact_slots_isolated_from_vexp(cfg, params):
    prompts = _prompts(cfg, (5, 11, 7))
    groups = {"eval": resolve_policy(cfg, env={}, exp_backend="exact"),
              "bulk": resolve_policy(cfg, env={}, exp_backend="vexp")}
    mixed, _ = _serve(cfg, params, prompts, [0, 1, 2], policy_groups=groups,
                      groups_of={0: "eval", 1: "bulk", 2: "eval"})
    pure_exact, _ = _serve(cfg, params, prompts, [0, 2],
                           policy=groups["eval"])
    pure_vexp, _ = _serve(cfg, params, prompts, [1], policy=groups["bulk"])
    assert mixed[0] == pure_exact[0] and mixed[2] == pure_exact[2]
    assert mixed[1] == pure_vexp[1]


def test_parse_policy_groups_and_aliases(cfg):
    g = parse_policy_groups("eval=exact,bulk=vexp_hw/xla,hw=vexp/pallas",
                            cfg, env={})
    assert g["eval"].exp_backend == "exact"
    assert g["eval"].kernel_backend == "cuda"            # the port's default
    assert g["bulk"].kernel_backend == "eager"           # xla -> eager
    assert g["hw"].kernel_backend == "cuda"              # pallas -> cuda
    base = resolve_policy(cfg, env={}, kernel_backend="reference")
    assert parse_policy_groups("e=exact", cfg,
                               base=base)["e"].kernel_backend == "reference"
    env = {"REPRO_KERNEL_BACKEND": "xla", "REPRO_BLOCK_S": "256"}
    p = resolve_policy(cfg, env=env)
    assert (p.kernel_backend, p.block_s, p.block_k) == ("eager", 256, 512)
    for bad in ("", "noequals", "x=,", "a=exact,a=vexp"):
        with pytest.raises(ValueError):
            parse_policy_groups(bad, cfg, env={})
    with pytest.raises(ValueError):
        resolve_policy(cfg, env={}, accum_dtype="bfloat16")


@pytest.mark.parametrize("tier", ["reference", "cuda"])
def test_same_greedy_tokens_as_the_jax_server(tier):
    """Same weights (bridged), same requests: the port's tokens equal the
    JAX Server's up to the first step where the JAX logits are a near tie
    (top-2 gap <= 2 * LOGIT_TOL); past such a step the streams may part."""
    from repro.configs import get_config as jax_config
    from repro.launch.serve import Request as JaxRequest, Server as JaxServer
    from repro.models import api as japi
    from repro.runtime import resolve_policy as jax_policy
    from repro_torch.bridge import params_from_numpy

    jcfg = jax_config("gpt2-small").reduced()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("gpt2-small").reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    prompts = _prompts(cfg, (5, 11, 20, 8), seed=3)
    jpol = jax_policy(jcfg, env={}, exp_backend="vexp",
                      kernel_backend="reference")
    jsrv = JaxServer(jcfg, jp, max_batch=4, max_seq=64, policy=jpol)
    jreqs = [JaxRequest(i, p.copy(), 6) for i, p in enumerate(prompts)]
    jsrv.run(jreqs)
    got, _ = _serve(cfg, tp, prompts, range(len(prompts)),
                    policy=resolve_policy(cfg, env={}, exp_backend="vexp",
                                          kernel_backend=tier))
    for r in jreqs:
        ours = got[r.rid]
        diff = [i for i, (a, b) in enumerate(zip(ours, r.out)) if a != b]
        if not diff:
            assert ours == r.out
            continue
        i = diff[0]
        seq = np.concatenate([r.prompt, np.asarray(r.out[:i], np.int32)])
        logits, _ = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(seq[None])},
                                 policy=jpol)
        top = np.sort(np.asarray(logits)[0, 0])
        assert top[-1] - top[-2] <= 2 * LOGIT_TOL, (r.rid, i)
