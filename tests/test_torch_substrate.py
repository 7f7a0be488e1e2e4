"""The trainer's substrate in the port against the JAX package's, on the
CPU (the counterparts of ``tests/test_substrate.py``).

* optim: the update moves the parameters, clipping, the schedule, bf16
  moments, a quadratic converges, and one ``update`` equals
  ``repro.optim.update`` on the same numpy tree (f32, UPDATE_RTOL: the
  two frameworks' pow and sqrt differ by ulps).
* data: every batch equals the JAX package's bit for bit; replay is
  deterministic; steps differ; the modality families raise.
* ckpt: a round trip with bf16 leaves, LATEST and atomicity, the async
  saver; a checkpoint the JAX package wrote restores into the port, and
  one the port wrote into the JAX package (``repro.ckpt.restore`` +
  ``unflatten_like``), value for value.
* ft: the guard, the straggler detector, ``run_supervised`` restarting
  the port's train step from the port's checkpoints to the bits of an
  uninterrupted run.
* compression: error feedback is unbiased; ``compressed_psum`` on a
  one-rank gloo group.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import StructuredLM as JStructuredLM  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import bridge, ckpt, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import StructuredLM, SyntheticLM  # noqa: E402
from repro_torch.distributed import compressed_psum, ef_compress  # noqa: E402
from repro_torch.ft import (PreemptionGuard, StragglerDetector,  # noqa: E402
                            run_supervised)
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import resolve_policy  # noqa: E402

UPDATE_RTOL = 1e-6
_JAX_UPDATE = jax.jit(joptim.update, static_argnums=3)


# ------------------------------------------------------------------ optim

def _quad_params():
    return {"w": torch.ones(4, 4), "b": torch.zeros(4)}


def test_update_moves_params():
    cfg = optim.OptConfig(warmup_steps=1, total_steps=10)
    p = _quad_params()
    g = {"w": torch.full((4, 4), 0.5), "b": torch.full((4,), -0.5)}
    new, state, stats = optim.update(g, optim.init(p, cfg), p, cfg)
    assert int(state["step"]) == 1
    assert torch.all(new["w"] < p["w"]) and torch.all(new["b"] > p["b"])
    assert float(stats["lr"]) > 0


def test_clipping_scales_large_gradients():
    cfg = optim.OptConfig(clip_norm=1.0)
    p = _quad_params()
    g = {"w": torch.full((4, 4), 100.0), "b": torch.zeros(4)}
    _, _, stats = optim.update(g, optim.init(p, cfg), p, cfg)
    assert float(stats["grad_norm"]) == pytest.approx(400.0)
    assert float(stats["clip_scale"]) == pytest.approx(1 / 400.0)


def test_schedule_matches_jax():
    """Warmup, the cosine and its floor, step for step against the
    reference's."""
    cfg = optim.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jc = joptim.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 120, 7)
    ours = np.array([float(optim.schedule(cfg, s)) for s in steps])
    ref = np.array([float(joptim.schedule(jc, s)) for s in steps])
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    assert float(optim.schedule(cfg, 5)) == pytest.approx(5e-4)
    assert float(optim.schedule(cfg, 200)) == pytest.approx(1e-4)


def test_bf16_moments():
    cfg = optim.OptConfig(moment_dtype="bfloat16")
    p = _quad_params()
    state = optim.init(p, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    new, state, _ = optim.update({"w": torch.ones(4, 4), "b": None},
                                 state, p, cfg)
    assert state["v"]["w"].dtype == torch.bfloat16
    assert new["w"].dtype == torch.float32
    assert not torch.any(state["m"]["b"])       # a None gradient is 0


def test_quadratic_converges():
    cfg = optim.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0)
    target = torch.arange(8, dtype=torch.float32)
    p = {"x": torch.zeros(8)}
    state = optim.init(p, cfg)
    for _ in range(200):
        g = {"x": 2 * (p["x"] - target)}
        p, state, _ = optim.update(g, state, p, cfg)
    assert float((p["x"] - target).abs().max()) < 0.05


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
def test_update_matches_jax(moments):
    """Three updates of a two-leaf tree (a matrix that decays, a vector
    that does not; one step clipped) against ``repro.optim.update``."""
    rng = np.random.default_rng(0)
    cfg = optim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                          moment_dtype=moments)
    jc = joptim.OptConfig(**dataclasses.asdict(cfg))
    pn = {"a": rng.standard_normal((6, 5)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    p = {k: torch.tensor(v) for k, v in pn.items()}
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    st, jst = optim.init(p, cfg), joptim.init(jp, jc)
    for i in range(3):
        gn = {k: (rng.standard_normal(v.shape) * (3.0 if i == 1 else 0.1))
              .astype(np.float32) for k, v in pn.items()}
        p, st, stats = optim.update({k: torch.tensor(v) for k, v in
                                     gn.items()}, st, p, cfg)
        jp, jst, jstats = _JAX_UPDATE(
            {k: jnp.asarray(v) for k, v in gn.items()}, jst, jp, jc)
        for k in pn:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=UPDATE_RTOL, atol=1e-8)
        assert float(stats["clip_scale"]) == pytest.approx(
            float(jstats["clip_scale"]), rel=1e-6)
    assert int(st["step"]) == int(jst["step"]) == 3


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("step", (0, 7))
def test_batches_equal_jax(step):
    cfg, jcfg = get_config("gpt2-small"), jax_config("gpt2-small")
    for ours, ref in ((StructuredLM(cfg.vocab, 3, 33, seed=17),
                       JStructuredLM(jcfg.vocab, 3, 33, seed=17)),
                      (SyntheticLM(cfg, 3, 33, seed=5),
                       JSyntheticLM(jcfg, 3, 33, seed=5))):
        a, b = ours.batch(step), ref.batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_replay_is_deterministic_and_steps_differ():
    pipe = StructuredLM(512, 2, 32, seed=1)
    np.testing.assert_array_equal(pipe.batch(3)["tokens"],
                                  StructuredLM(512, 2, 32, seed=1)
                                  .batch(3)["tokens"])
    assert not np.array_equal(pipe.batch(3)["tokens"],
                              pipe.batch(4)["tokens"])
    b = pipe.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("family", ("vlm", "audio"))
def test_modality_data_raises(family):
    cfg = dataclasses.replace(get_config("gpt2-small"), family=family)
    with pytest.raises(NotImplementedError):
        SyntheticLM(cfg, 2, 8)


# ------------------------------------------------------------------- ckpt

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "b": torch.randn(3, generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
        return
    a, b = (torch.as_tensor(np.array(x)) if isinstance(x, np.ndarray)
            else x for x in (a, b))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_ckpt_round_trip_with_bf16(tmp_path):
    tree = _tree()
    ckpt.save(tree, str(tmp_path), 3, extra={"note": "x"})
    flat, manifest = ckpt.restore(str(tmp_path))
    assert manifest["step"] == 3 and manifest["extra"] == {"note": "x"}
    assert manifest["leaves"]["params/b"]["dtype"] == "bfloat16"
    _assert_tree_equal(ckpt.unflatten_like(flat, tree), tree)


def test_ckpt_latest_and_atomicity(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save(_tree(), d, 1)
    ckpt.save(_tree(), d, 2)
    assert ckpt.latest_step(d) == 2
    # a save that died mid-write leaves only its temp dir: LATEST holds
    os.makedirs(os.path.join(d, ".tmp-step_00000003-1"))
    assert ckpt.latest_step(d) == 2
    # LATEST naming a step dir whose manifest is missing is no restore
    # point
    os.remove(os.path.join(d, "step_00000002", "manifest.json"))
    assert ckpt.latest_step(d) is None
    with pytest.raises(KeyError):
        ckpt.unflatten_like({}, _tree())


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3):
        saved = tree["params"]["w"].clone()
        saver.save_async(tree, step)
        tree["params"]["w"].add_(1.0)   # the snapshot was taken already
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("step_")) == ["step_00000002",
                                                "step_00000003"]
    flat, _ = ckpt.restore(str(tmp_path), 3)
    assert torch.equal(flat["params/w"], saved)


@pytest.fixture(scope="module")
def state():
    """gpt2-small.reduced()'s JAX parameters and a bf16-moment AdamW
    state one update in, and the port's trainable model and state on the
    same values."""
    jc = jax_config("gpt2-small").reduced()
    cfg = get_config("gpt2-small").reduced()
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    jo = joptim.OptConfig(moment_dtype="bfloat16")
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jp)
    jp, jopt, _ = _JAX_UPDATE(grads, joptim.init(jp, jo), jp, jo)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu", trainable=True)
    return jc, jp, jopt, cfg, model


def _port_state(model, opt):
    return {"params": bridge.params_to_tree(model),
            "opt": bridge.opt_state_to_tree(opt)}


def test_jax_checkpoint_restores_into_port(tmp_path, state):
    jc, jp, jopt, cfg, model = state
    jckpt.save({"params": jp, "opt": jopt}, str(tmp_path), 4)
    template = _port_state(model, optim.init(
        dict(model.named_parameters()),
        optim.OptConfig(moment_dtype="bfloat16")))
    flat, manifest = ckpt.restore(str(tmp_path))
    tree = ckpt.unflatten_like(flat, template)
    back = bridge.params_from_numpy(tree["params"], cfg, device="cpu",
                                    trainable=True)
    opt = bridge.opt_state_from_tree(tree["opt"], back)
    assert manifest["step"] == 4 and int(opt["step"]) == 1
    _assert_tree_equal(bridge.params_to_numpy(back),
                       jax.tree.map(np.asarray, jp))
    for k in ("m", "v"):
        got = bridge.opt_state_to_tree(opt)[k]
        ref = jax.tree.map(lambda x: torch.from_numpy(
            np.asarray(x).view(np.int16)).view(torch.bfloat16), jopt[k])
        _assert_tree_equal(got, ref)


def test_port_checkpoint_restores_into_jax(tmp_path, state):
    jc, jp, jopt, cfg, model = state
    opt = bridge.opt_state_from_tree(
        {"m": jax.tree.map(lambda x: torch.from_numpy(
            np.asarray(x).view(np.int16)).view(torch.bfloat16), jopt["m"]),
         "v": jax.tree.map(lambda x: torch.from_numpy(
             np.asarray(x).view(np.int16)).view(torch.bfloat16), jopt["v"]),
         "step": np.asarray(jopt["step"])}, model)
    ckpt.save(_port_state(model, opt), str(tmp_path), 9)
    flat, manifest = jckpt.restore(str(tmp_path))
    tree = jckpt.unflatten_like(flat, {"params": jp, "opt": jopt})
    assert manifest["step"] == 9
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            {"params": jp, "opt": jopt})):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------- ft

def test_preemption_guard_and_straggler_detector():
    g = PreemptionGuard(signals=())
    assert not g.should_stop
    g.trigger()
    assert g.should_stop
    d = StragglerDetector(window=20, threshold=2.0)
    for i in range(10):
        assert not d.record(i, 1.0)
    assert d.record(10, 5.0)
    assert d.flagged[0][0] == 10 and d.median == 1.0


def test_run_supervised_resumes_bitwise(tmp_path):
    """The port's train step crashes twice mid-run; ``run_supervised``
    restores the port's latest checkpoint each time, and the final
    parameters equal an uninterrupted run's bit for bit."""
    cfg = get_config("gpt2-small").reduced()
    opt_cfg = optim.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    step_fn = ltrain.make_train_step(cfg, opt_cfg,
                                     policy=resolve_policy(cfg, env={}))
    pipe = StructuredLM(cfg.vocab, 2, 16, seed=17)
    crashes = {"n": 0}

    def make_state():
        p = api.init_params(cfg, 0, device="cpu", trainable=True)
        return p, optim.init(dict(p.named_parameters()), opt_cfg)

    def step(st, i, crash=True):
        if crash and i == 5 and crashes["n"] < 2:
            crashes["n"] += 1
            raise RuntimeError("simulated node failure")
        p, o, _ = step_fn(st[0], st[1], pipe.batch(i))
        return p, o

    def save(st, i):
        ckpt.save({"params": bridge.params_to_tree(st[0]),
                   "opt": bridge.opt_state_to_tree(st[1])},
                  str(tmp_path), i)

    def restore():
        if ckpt.latest_step(str(tmp_path)) is None:
            return None
        p, o = make_state()
        flat, man = ckpt.restore(str(tmp_path))
        tree = ckpt.unflatten_like(flat, {
            "params": bridge.params_to_tree(p),
            "opt": bridge.opt_state_to_tree(o)})
        p = bridge.params_from_numpy(tree["params"], cfg, device="cpu",
                                     trainable=True)
        return (p, bridge.opt_state_from_tree(tree["opt"], p)), man["step"]

    (p, _), restarts = run_supervised(make_state, step, save, restore, 8,
                                      ckpt_every=2)
    assert restarts == 2
    ref = make_state()
    for i in range(8):
        ref = step(ref, i, crash=False)
    for (n, a), (_, b) in zip(p.named_parameters(),
                              ref[0].named_parameters()):
        assert torch.equal(a, b), n


# ------------------------------------------------------------ compression

def test_ef_compress_unbiased():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.standard_normal(512), dtype=torch.float32) * 1e-3
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        c, err = ef_compress(g, err)
        assert c.dtype == torch.bfloat16
        total = total + c.float()
    np.testing.assert_allclose(total.numpy(), g.numpy() * 50, rtol=2e-2,
                               atol=1e-5)


def test_compressed_psum_one_rank_gloo(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        g = {"w": torch.full((8, 8), 0.25), "b": torch.full((3,), 1e-3)}
        e = {k: torch.zeros_like(v) for k, v in g.items()}
        m, ne = compressed_psum(g, e)
        np.testing.assert_allclose(m["w"].numpy(), 0.25, atol=1e-3)
        for k in g:
            torch.testing.assert_close(m[k] + ne[k], g[k], rtol=0,
                                       atol=1e-9)
    finally:
        dist.destroy_process_group()
