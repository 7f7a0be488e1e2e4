"""The port's training path against the JAX package's, on the CPU.

* ``vexp_hw``'s derivative is 0 in both packages (``jax.grad`` of the
  reference's bitcast model reads 0; the port returns zeros, not a cut
  graph); vexp's is the guarded approximation, exact's ``exp``.
* The exp kernel's and the FlashAttention kernel's autograd Functions
  (``kernels.vexp._VexpFn``, ``kernels.flash_attention.
  _FlashAttentionFn``) on CPU tensors: the exp's gradient bit for bit the
  plain function's under every backend; FA's dq, dk, dv bit for bit
  autograd of ``attention_flash`` (the recompute the reference's
  ``_fa_bwd`` runs), and within FA_TOL of ``jax.vjp`` through the Pallas
  kernel in interpret mode.
* ``cross_entropy`` (ragged last chunk, a mask, a softcap) against the
  reference's, value and gradients, f32 within CE_TOL.
* ``loss_fn`` and its per-leaf gradients against ``jax.value_and_grad(
  repro.models.api.loss_fn)`` on the same weights (``bridge``, trainable
  f32 masters), for gpt2-small and phi3-medium-14b ``.reduced()`` under
  every exp backend, in bf16 and in f32 compute, the port's cuda tier
  (the kernels' plain versions on CPU tensors) and reference tier both;
  h2o-danube3-4b ``.reduced()`` (window 16, 40 tokens) under vexp. Under
  vexp_hw every ``wq`` / ``wk`` gradient is exactly 0 in both packages.
* ``make_train_step`` (``accum_steps`` 1 and 2) against the reference's
  step: its gradients' mean through ``repro.optim.update``.
* The train loop: the loss falls against the lr-0 control, 40 steps
  log the reference trainer's losses (from the same weights), a resumed
  run repeats an uninterrupted one bit for bit, the preemption drain leaves a checkpoint, the CLI
  runs on ``--device cpu``; what is not ported raises.

Tolerances (per gradient leaf: max |port - jax| / max |jax|; the loss
relative). f32 compute: the two frameworks sum in other orders, 1e-4
(F32_TOL; read 1.6e-6 at most), and under vexp_hw 1e-3 (F32_HW_TOL, read
2.7e-4: an f32 ulp of an exp input can cross a bf16 rounding step, which
moves that exp by a bf16 ulp). bf16 compute: the frameworks round
activations at different places, BF16_TOL = 0.06 of the leaf's max
(read up to 0.025 on bias leaves), the loss within 1e-3 (read 3.9e-5).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.vexp import get_exp_fn as jax_exp  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.runtime import resolve_policy as jax_policy  # noqa: E402
from repro_torch import ckpt, optim  # noqa: E402
from repro_torch.bridge import named_to_tree, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.attention import attention_flash  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.data import StructuredLM  # noqa: E402
from repro_torch.ft import PreemptionGuard  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import vexp as kvexp  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import api, layers, transformer  # noqa: E402
from repro_torch.runtime import ExecPolicy, resolve_policy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
F32_TOL, F32_HW_TOL, BF16_TOL = 1e-4, 1e-3, 0.06
LOSS_F32_TOL, LOSS_BF16_TOL = 1e-6, 1e-3
CE_TOL = 1e-5
FA_TOL = 2e-2
B, S = 2, 40


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaf_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _walk(jt, tt, path=()):
    if isinstance(jt, dict):
        assert set(jt) == set(tt), path
        for k in jt:
            yield from _walk(jt[k], tt[k], path + (k,))
    else:
        yield "/".join(path), jt, tt


def _batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2 * B, S)).astype(np.int32)
    labs = rng.integers(0, 512, (2 * B, S)).astype(np.int32)
    mask = rng.random((2 * B, S)) > 0.2
    return {"tokens": toks, "labels": labs, "mask": mask}


class _Models:
    """The JAX package's and the port's models on the same weights, and
    one jitted JAX value_and_grad per (arch, dtype, exp), kept for the
    module so each compiles once."""

    def __init__(self):
        self._m, self._vg = {}, {}

    def get(self, arch, dtype, **kw):
        key = (arch, dtype, tuple(sorted(kw.items())))
        if key not in self._m:
            jc = dataclasses.replace(jax_config(arch).reduced(),
                                     compute_dtype=dtype, **kw)
            c = dataclasses.replace(get_config(arch).reduced(),
                                    compute_dtype=dtype, **kw)
            jp = japi.init_params(jc, jax.random.PRNGKey(0))
            self._m[key] = (jc, jp, c, jax.tree.map(np.asarray, jp))
        return self._m[key]

    def jax_vg(self, arch, dtype, exp, batch, **kw):
        jc, jp, _, _ = self.get(arch, dtype, **kw)
        key = (arch, dtype, exp, tuple(sorted(kw.items())))
        if key not in self._vg:
            pol = jax_policy(jc, env={}, exp_backend=exp,
                             kernel_backend="reference")
            self._vg[key] = jax.jit(jax.value_and_grad(
                lambda p, b: japi.loss_fn(p, jc, b, policy=pol)))
        return self._vg[key](jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})


@pytest.fixture(scope="module")
def models():
    return _Models()


def _port_vg(tree, cfg, batch, exp, tier):
    model = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend=tier)
    loss, grads = ltrain.value_and_grad(
        model, cfg, {k: torch.as_tensor(v) for k, v in batch.items()}, pol)
    return loss, named_to_tree(grads)


# ------------------------------------------------------------ exp derivative

@pytest.mark.parametrize("exp", EXPS)
def test_exp_derivative_matches_jax(exp):
    """vexp_hw: zeros in both (an integer path without a derivative of
    its own cuts the graph, and the backward raises); vexp: the guarded
    approximation; exact: exp. Over finite, saturating and underflowing
    inputs."""
    xs = np.array([-200.0, -90.0, -1.0, 0.0, 0.5, 2.0, 80.0, 95.0],
                  np.float32)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(jax_exp(exp)(x))))(
        jnp.asarray(xs))
    x = torch.tensor(xs, requires_grad=True)
    get_exp_fn(exp)(x).sum().backward()
    assert x.grad is not None
    if exp == "vexp_hw":
        assert not np.any(_np(jg)) and not torch.any(x.grad)
    elif exp == "vexp":
        np.testing.assert_array_equal(x.grad.numpy(), _np(jg))
    else:       # XLA's CPU exp flushes a subnormal result (exp(-90)) to 0
        np.testing.assert_allclose(x.grad.numpy(), _np(jg), rtol=1e-6,
                                   atol=1e-37)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("exp", EXPS)
def test_exp_kernel_function_gradient_is_plain(exp, dtype):
    """``kernels.vexp.vexp`` under autograd (``_VexpFn``) against autograd
    of the plain function: the same values and gradient bits."""
    g = torch.Generator().manual_seed(3)
    x0 = (torch.randn(64, 33, generator=g) * 30).to(dtype)
    x0[0, :4] = torch.tensor([-200.0, 100.0, -100.0, 0.0])
    cot = torch.randn(64, 33, generator=g).to(dtype)
    pol = ExecPolicy(exp_backend=exp)
    xa, xb = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    ya = kvexp.vexp(xa, policy=pol)
    yb = kvexp.vexp_plain(xb, exp)
    assert ya.grad_fn is not None and "VexpFn" in type(ya.grad_fn).__name__
    (ga,) = torch.autograd.grad(ya, xa, cot)
    (gb,) = torch.autograd.grad(yb, xb, cot)
    assert torch.equal(ya, yb)
    assert torch.equal(ga.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32),
                       gb.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32))


# ------------------------------------------------------- FlashAttention bwd

def _fa_inputs(h=4, hkv=2, d=32, s=48, b=2, seed=5):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, generator=g).to(torch.bfloat16)
    cot = torch.randn(b, s, h, d, generator=g).to(torch.bfloat16)
    return q, k, v, cot


@pytest.mark.parametrize("window", (None, 20))
@pytest.mark.parametrize("exp", EXPS)
def test_fa_function_backward_is_attention_flash(exp, window):
    """dq, dk, dv through ``flash_attention`` (its Function: the forward
    at the policy's block_k 16, so the rows walk three blocks) equal
    autograd of ``attention_flash`` at its default block_k bit for bit;
    under vexp_hw dq and dk are 0."""
    q, k, v, cot = _fa_inputs()
    pol = ExecPolicy(exp_backend=exp, block_k=16)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qa, ka, va, causal=True, window=window,
                             policy=pol)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    assert torch.equal(out, fa.flash_attention_plain(
        q, k, v, causal=True, window=window, block_k=16, exp_backend=exp))
    ga = torch.autograd.grad(out, (qa, ka, va), cot)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    ref = attention_flash(qb, kb, vb, causal=True, window=window,
                          exp_impl=exp)
    gb = torch.autograd.grad(ref, (qb, kb, vb), cot)
    for x, y in zip(ga, gb):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    if exp == "vexp_hw":
        assert not torch.any(ga[0]) and not torch.any(ga[1])


def test_fa_function_backward_matches_jax_fa_bwd():
    """The port's dq, dk, dv against ``jax.vjp`` of the reference's
    ``flash_attention`` (the Pallas forward in interpret mode, its
    ``_fa_bwd``) under vexp: FA_TOL of each gradient's max (bf16
    gradients, summed in other orders)."""
    q, k, v, cot = _fa_inputs(h=2, hkv=1, b=1)    # a 2-step Pallas grid
    pol = ExecPolicy(exp_backend="vexp")
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qa, ka, va, causal=True, policy=pol)
    ga = torch.autograd.grad(out, (qa, ka, va), cot)
    jpol = jax_policy(None, env={}, exp_backend="vexp",
                      kernel_backend="pallas")
    jq, jk, jv, jc = (jnp.asarray(_np(t), jnp.bfloat16)
                      for t in (q, k, v, cot))
    jout, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_policy(
        a, b_, c, causal=True, policy=jpol), jq, jk, jv)
    gj = vjp(jc)
    assert _leaf_err(jout, out) < FA_TOL
    for x, y in zip(gj, ga):
        assert _leaf_err(x, y) < FA_TOL


def test_serving_calls_skip_the_function():
    """Without grad the wrappers return the kernel path's tensor directly
    (no autograd node), as a captured serving step needs."""
    q, k, v, _ = _fa_inputs()
    pol = ExecPolicy(exp_backend="vexp")
    assert fa.flash_attention(q, k, v, causal=True, policy=pol).grad_fn \
        is None
    with torch.no_grad():
        x = torch.randn(8, requires_grad=True)
        assert kvexp.vexp(x, policy=pol).grad_fn is None


# -------------------------------------------------------- cross_entropy

def test_cross_entropy_matches_jax():
    """Ragged last chunk (40 positions in chunks of 16), a mask and a
    softcap of 30, vexp, f32 inputs: the loss and its gradients in x and
    the unembedding within CE_TOL."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 100)) * 0.5).astype(np.float32)
    lab = rng.integers(0, 100, (B, S)).astype(np.int32)
    mask = rng.random((B, S)) > 0.3
    jl, (jgx, jgw) = jax.jit(jax.value_and_grad(
        lambda a, b_: jlayers.cross_entropy(
            a, b_, jnp.asarray(lab), chunk=16, exp_impl="vexp",
            logit_softcap=30.0, mask=jnp.asarray(mask)),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    tl = layers.cross_entropy(tx, tw, torch.tensor(lab), chunk=16,
                              logit_softcap=30.0, mask=torch.tensor(mask),
                              policy=ExecPolicy(exp_backend="vexp"))
    gx, gw = torch.autograd.grad(tl, (tx, tw))
    assert abs(tl.item() - float(jl)) <= CE_TOL * abs(float(jl))
    assert _leaf_err(jgx, gx) < CE_TOL and _leaf_err(jgw, gw) < CE_TOL


# ------------------------------------------------------------- loss_fn

def _check_grads(jg, tg, dtype, exp):
    tol = BF16_TOL if dtype == "bfloat16" else (
        F32_HW_TOL if exp == "vexp_hw" else F32_TOL)
    for path, a, b in _walk(jax.tree.map(np.asarray, jg), tg):
        err = _leaf_err(a, b)
        assert err < tol, (path, err)
        if exp == "vexp_hw" and path.endswith(("attn/wq", "attn/wk")):
            assert not np.any(a) and not torch.any(b), path


@pytest.mark.parametrize("exp", EXPS)
@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("arch", ("gpt2-small", "phi3-medium-14b"))
def test_loss_and_grads_match_jax(models, arch, dtype, exp):
    batch = {k: v[:B] for k, v in _batch().items()}
    jl, jg = models.jax_vg(arch, dtype, exp, batch)
    _, _, cfg, tree = models.get(arch, dtype)
    tol = LOSS_BF16_TOL if dtype == "bfloat16" else LOSS_F32_TOL
    for tier in ("cuda", "reference"):
        loss, tg = _port_vg(tree, cfg, batch, exp, tier)
        assert abs(float(loss) - float(jl)) <= tol * abs(float(jl)), tier
        _check_grads(jg, tg, dtype, exp)


def test_windowed_loss_and_grads_match_jax(models):
    """h2o-danube3-4b.reduced(): window 16 under 40 tokens, vexp, bf16."""
    batch = {k: v[:B] for k, v in _batch().items()}
    jl, jg = models.jax_vg("h2o-danube3-4b", "bfloat16", "vexp", batch)
    _, _, cfg, tree = models.get("h2o-danube3-4b", "bfloat16")
    assert cfg.sliding_window == 16 < S
    loss, tg = _port_vg(tree, cfg, batch, "vexp", "cuda")
    assert abs(float(loss) - float(jl)) <= LOSS_BF16_TOL * abs(float(jl))
    _check_grads(jg, tg, "bfloat16", "vexp")


def test_trainable_forward_equals_serving_forward(models):
    """f32 masters cast inside ``forward`` give the serving model's
    hidden states bit for bit (it holds the same bf16 weights)."""
    _, _, cfg, tree = models.get("phi3-medium-14b", "bfloat16")
    toks = torch.as_tensor(_batch()["tokens"][:B])
    pol = resolve_policy(cfg, env={})
    outs = [transformer.forward(params_from_numpy(tree, cfg, device="cpu",
                                                  trainable=t),
                                cfg, toks, policy=pol) for t in (True,
                                                                 False)]
    assert outs[0].requires_grad and not outs[1].requires_grad
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------- train step

_JAX_UPDATE = jax.jit(joptim.update, static_argnums=3)


def _micro_mean(vg, batch, accum):
    """The mean of ``vg``'s (loss, grads) over ``accum`` microbatches
    (rows in order): the reference's accumulation."""
    n = batch["tokens"].shape[0] // accum
    loss, grads = 0.0, None
    for i in range(accum):
        l, g = vg({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        loss = loss + l
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return loss / accum, jax.tree.map(lambda g: g / accum, grads)


@pytest.mark.parametrize("accum", (1, 2))
def test_train_step_matches_jax(models, accum):
    """One ``make_train_step`` step against the reference's (bf16
    compute, vexp): the loss and the global gradient norm against the
    reference's step (its microbatches' mean gradients through
    ``repro.optim.update``); the new parameters against
    ``repro.optim.update`` of the port's own mean gradients within 1e-6
    relative (f32 ulps: the two frameworks' sqrt and pow). (Against the reference's own gradients the new parameters
    differ by up to 2 lr: Adam's first step is lr x the gradient's sign,
    and a leaf like ``bk``, whose gradient is rounding noise, flips.)"""
    batch = {k: v[:B * accum] for k, v in _batch().items()}
    opt_cfg = optim.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jo = joptim.OptConfig(**dataclasses.asdict(opt_cfg))
    jc, jp, cfg, tree = models.get("gpt2-small", "bfloat16")
    jl, jg = _micro_mean(
        lambda mb: models.jax_vg("gpt2-small", "bfloat16", "vexp", mb),
        batch, accum)
    _, _, jstats = _JAX_UPDATE(jg, joptim.init(jp, jo), jp, jo)
    pol = resolve_policy(cfg, env={})

    def port_vg(mb):
        loss, g = _port_vg(tree, cfg, mb, "vexp", "cuda")
        return jnp.asarray(_np(loss)), jax.tree.map(
            lambda t: jnp.asarray(_np(t)), g)

    _, pg = _micro_mean(port_vg, batch, accum)
    pnew, _, _ = _JAX_UPDATE(pg, joptim.init(jp, jo), jp, jo)
    model = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    state = optim.init(dict(model.named_parameters()), opt_cfg)
    step = ltrain.make_train_step(cfg, opt_cfg, accum_steps=accum,
                                  policy=pol)
    model, state, stats = step(model, state, batch)
    assert int(state["step"]) == 1
    assert abs(float(stats["loss"]) - float(jl)) <= LOSS_BF16_TOL * abs(
        float(jl))
    assert abs(float(stats["grad_norm"]) - float(jstats["grad_norm"])) \
        <= 0.02 * float(jstats["grad_norm"])
    assert float(stats["lr"]) == pytest.approx(float(jstats["lr"]),
                                               rel=1e-6)
    new = named_to_tree(dict(model.named_parameters()))
    for path, a, b in _walk(jax.tree.map(np.asarray, pnew), new):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6,
                                   atol=1e-6 * opt_cfg.lr, err_msg=path)


# ---------------------------------------------------------- train loop

def _reduced():
    return get_config("gpt2-small").reduced()


FALL_MIN = 0.03


def _fall(losses):
    return float(np.mean(losses[:4]) - np.mean(losses[-4:]))


def test_loss_falls_and_resume_is_bitwise(tmp_path):
    """40 steps at batch 4, seq 32, lr 1e-3: of the 8 losses of every 5th
    step, the mean of the last four is below the first four's, and that
    fall exceeds by FALL_MIN nats the same fall of the initial weights'
    losses on the same batches (the lr-0 control: the batches' own
    spread cancels; read 0.067, the unpaired fall 0.048, the control's
    own -0.019). A run of 6 steps,
    then a fresh ``train`` resuming it to 12 from its LATEST, logs the
    uninterrupted run's losses of steps 6-11 bit for bit (the same
    OptConfig, so the same schedule)."""
    cfg = _reduced()
    opt_cfg = optim.OptConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    kw = dict(batch=4, seq=32, opt_cfg=opt_cfg, device="cpu",
              guard=PreemptionGuard(signals=()))
    _, full = ltrain.train(cfg, steps=40, log_every=1, log=lambda m: None,
                           **kw)
    every5 = [loss for s, loss in full if s % 5 == 0]
    params = api.init_params(cfg, 0, device="cpu", trainable=True)
    data = StructuredLM(cfg.vocab, 4, 32, seed=17)
    with torch.no_grad():
        control = [float(api.loss_fn(
            params, cfg, {k: torch.from_numpy(v) for k, v in
                          data.batch(s).items()}, device="cpu"))
            for s in range(0, 40, 5)]
    assert len(every5) == 8 and control[0] == every5[0], (every5, control)
    assert _fall(every5) > 0, every5
    assert _fall(every5) - _fall(control) > FALL_MIN, (every5, control)
    logs = []
    ltrain.train(cfg, steps=6, ckpt_dir=str(tmp_path), ckpt_every=100,
                 log_every=1, log=logs.append, **kw)
    assert ckpt.latest_step(str(tmp_path)) == 6
    _, resumed = ltrain.train(cfg, steps=12, ckpt_dir=str(tmp_path),
                              ckpt_every=100, log_every=1, log=logs.append,
                              **kw)
    assert "[train] resumed from step 6" in logs
    assert resumed == [(s, loss) for s, loss in full if 6 <= s < 12]


def test_curve_matches_the_reference_trainer():
    """A witness of the loss-falls run: 40 steps of ``make_train_step``
    (gpt2-small .reduced(), bf16 compute, vexp, batch 4, seq 32,
    StructuredLM seed 17, lr 1e-3) from the JAX package's initial
    weights log, every step, the reference trainer's jitted step's loss
    within LOSS_BF16_TOL (read 6.6e-4 nats at most, at ~6.3)."""
    from repro.data import StructuredLM as JaxLM
    from repro.launch import train as jtrain
    cfg, jc = _reduced(), jax_config("gpt2-small").reduced()
    opt_cfg = optim.OptConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    jo = joptim.OptConfig(**dataclasses.asdict(opt_cfg))
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu", trainable=True)
    state = optim.init(dict(model.named_parameters()), opt_cfg)
    step = ltrain.make_train_step(cfg, opt_cfg,
                                  policy=resolve_policy(cfg, env={}))
    jstep = jax.jit(jtrain.make_train_step(jc, jo,
                                           policy=jax_policy(jc, env={})))
    jstate = joptim.init(jp, jo)
    data = JaxLM(cfg.vocab, 4, 32, seed=17)
    for s in range(40):
        hb = data.batch(s)
        jp, jstate, jstats = jstep(jp, jstate, {
            k: jnp.asarray(v) for k, v in hb.items()})
        model, state, stats = step(model, state, {
            k: torch.from_numpy(v) for k, v in hb.items()})
        want = float(jstats["loss"])
        assert abs(float(stats["loss"]) - want) <= LOSS_BF16_TOL * abs(
            want), (s, float(stats["loss"]), want)


def test_preemption_drain(tmp_path):
    """``guard.trigger()`` mid-run: the loop saves the drained step
    synchronously and returns."""
    guard = PreemptionGuard(signals=())
    seen = []

    def log(msg):
        seen.append(msg)
        if len(seen) == 2:
            guard.trigger()

    _, hist = ltrain.train(_reduced(), steps=50, batch=2, seq=16,
                           ckpt_dir=str(tmp_path), ckpt_every=100,
                           log_every=1, guard=guard, log=log, device="cpu")
    assert [s for s, _ in hist] == [0, 1]
    assert any("preemption at step 1; draining" in m for m in seen)
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_cli_main_on_cpu(tmp_path, capsys):
    ltrain.main(["--arch", "gpt2-small", "--reduced", "--device", "cpu",
                 "--steps", "3", "--batch", "2", "--seq", "32",
                 "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] policy: exp=vexp kernel=cuda" in out
    assert "[train] step     0 loss" in out and "[train] step     2" in out
    assert ckpt.latest_step(str(tmp_path)) == 3


# -------------------------------------------------------------- raises

@pytest.mark.parametrize("arch", ("mamba2-1.3b", "recurrentgemma-9b",
                                  "dbrx-132b"))
def test_unported_losses_raise(arch):
    cfg = get_config(arch).reduced()
    batch = {k: v[:1, :16] for k, v in _batch().items()}
    with pytest.raises(NotImplementedError, match="A13"):
        params = api.init_params(cfg, 0, device="cpu", trainable=True)
        api.loss_fn(params, cfg, batch, device="cpu")


def test_fsdp_raises():
    with pytest.raises(NotImplementedError, match="A10"):
        ltrain.main(["--reduced", "--device", "cpu", "--steps", "1",
                     "--fsdp"])


def test_train_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no ``device="cpu"`` the trainer's entry points
    raise instead of training on the host (the card's absence
    simulated)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _reduced()
    params = api.init_params(cfg, device="cpu", trainable=True)
    batch = {k: v[:1, :16] for k, v in _batch().items()}
    for call in (lambda: api.init_params(cfg, trainable=True),
                 lambda: api.loss_fn(params, cfg, batch),
                 lambda: ltrain.train(cfg, steps=1, batch=1, seq=8),
                 lambda: ltrain.main(["--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
