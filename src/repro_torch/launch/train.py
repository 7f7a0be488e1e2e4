"""The port's trainer (``repro/launch/train.py:31-194``): the
train step, checkpoint / restart, preemption drain, straggler log lines
and deterministic data replay, on one device.

Usage (also callable as a library: ``train(cfg, ...)``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir ckpt/ [--device cpu]

The step runs on the card unless ``--device cpu`` is given. There is
no mesh: ``--fsdp`` raises (ROADMAP.md, A10). The dense family trains;
the ssm, hybrid and MoE families raise (A13). On the ``cuda`` tier the
step's attention is the FlashAttention kernel's forward, with the
reference's recompute backward (``kernels.flash_attention``), and the
loss's exp is the exp kernel's, with the plain function's derivative
(``kernels.vexp``).

The step is deterministic: every reduction of its forward and backward
runs in a fixed order (the embedding's gradient through ``F.embedding``,
no atomics), so a run resumed from a checkpoint repeats the losses of
one that was never stopped, bit for bit.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import bridge, ckpt as ckpt_lib, optim
from repro_torch.configs import get_config
from repro_torch.data import StructuredLM, SyntheticLM
from repro_torch.ft import PreemptionGuard, StragglerDetector
from repro_torch.models import api
from repro_torch.runtime import resolve_device, resolve_policy


def value_and_grad(params, cfg, batch, policy=None):
    """(loss, {parameter name: gradient, or None where the loss does not
    reach it}) of ``batch`` (tensors on the params' device). The
    gradients come from ``torch.autograd.grad``, so nothing is left in
    the parameters' ``.grad``."""
    names, tensors = zip(*params.named_parameters())
    loss = api.loss_fn(params, cfg, batch, policy=policy,
                       device=params.embed.device)
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(cfg, opt_cfg, accum_steps: int = 1, policy=None):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    stats)``: the params (a trainable model) are updated in place, the
    state and stats are new. ``accum_steps`` > 1 runs the batch as that
    many sequential microbatches (rows split in order) and takes the
    mean of their losses and gradients, the reference's gradient
    accumulation. ``policy`` None resolves the config's."""
    def train_step(params, opt_state, batch):
        dev = params.embed.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if accum_steps == 1:
            loss, grads = value_and_grad(params, cfg, batch, policy)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {n: torch.zeros_like(p)
                     for n, p in params.named_parameters()}
            for i in range(accum_steps):
                mb = {k: v.reshape((accum_steps, -1) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(params, cfg, mb, policy)
                loss = loss + l
                grads = {n: acc if g[n] is None else acc + g[n]
                         for n, acc in grads.items()}
            loss = loss / accum_steps
            grads = {n: g / accum_steps for n, g in grads.items()}
        named = dict(params.named_parameters())
        new_p, new_opt, stats = optim.update(grads, opt_state, named,
                                             opt_cfg)
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(new_p[n])
        stats["loss"] = loss
        return params, new_opt, stats
    return train_step


def _state(params, opt_state) -> dict:
    """The checkpoint's tree, the reference's ``{"params", "opt"}``."""
    return {"params": bridge.params_to_tree(params),
            "opt": bridge.opt_state_to_tree(opt_state)}


def train(cfg, *, steps=100, batch=8, seq=256, ckpt_dir=None,
          ckpt_every=50, opt_cfg=None, data="structured", log_every=10,
          guard=None, log=print, policy=None, device=None):
    """Run (or resume from ``ckpt_dir``'s LATEST) a training job on one
    device. Returns (params, history): the trained model and the logged
    (step, loss) pairs."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or optim.OptConfig(total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, policy=policy)
    if data == "structured":
        pipe = StructuredLM(cfg.vocab, batch, seq, seed=17)
    else:
        pipe = SyntheticLM(cfg, batch, seq, seed=17)

    start_step = 0
    params = api.init_params(cfg, 0, device=dev, trainable=True)
    opt_state = optim.init(dict(params.named_parameters()), opt_cfg)
    if ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
        flat, manifest = ckpt_lib.restore(ckpt_dir)
        tree = ckpt_lib.unflatten_like(flat, _state(params, opt_state))
        params = bridge.params_from_numpy(tree["params"], cfg, device=dev,
                                          trainable=True)
        opt_state = bridge.opt_state_from_tree(tree["opt"], params)
        start_step = manifest["step"]
        log(f"[train] resumed from step {start_step}")

    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    guard = guard or PreemptionGuard()
    strag = StragglerDetector()
    history = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        hb = pipe.batch(step)
        db = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
        params, opt_state, stats = step_fn(params, opt_state, db)
        if step % log_every == 0 or step == steps - 1:
            loss = float(stats["loss"])
            history.append((step, loss))
            log(f"[train] step {step:5d} loss {loss:.4f} "
                f"gnorm {float(stats['grad_norm']):.3f} "
                f"lr {float(stats['lr']):.2e}")
        dt = time.perf_counter() - t0
        if strag.record(step, dt):
            log(f"[train] straggler step {step}: {dt:.2f}s "
                f"(median {strag.median:.2f}s)")
        if saver and (step + 1) % ckpt_every == 0:
            saver.save_async(_state(params, opt_state), step + 1)
        if guard.should_stop:
            log(f"[train] preemption at step {step}; draining")
            if saver:
                saver.wait()
                ckpt_lib.save(_state(params, opt_state), ckpt_dir, step + 1)
            return params, history
    if saver:
        saver.wait()
        ckpt_lib.save(_state(params, opt_state), ckpt_dir, steps)
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fsdp", action="store_true",
                    help="not ported: raises (one device, no mesh)")
    ap.add_argument("--data", default="structured",
                    choices=["structured", "uniform"])
    ap.add_argument("--exp-backend", default=None,
                    choices=["exact", "vexp", "vexp_hw"],
                    help="exponential backend (default: config/env)")
    ap.add_argument("--kernel-backend", default=None,
                    choices=["cuda", "reference", "eager"],
                    help="kernel tier (default: config/env)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.fsdp:
        raise NotImplementedError(
            "fsdp: the port trains on one device; parameter sharding over "
            "a mesh is not ported (ROADMAP.md, A10)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    policy = resolve_policy(cfg, exp_backend=args.exp_backend,
                            kernel_backend=args.kernel_backend)
    print(f"[train] policy: {policy.describe()}")
    opt_cfg = optim.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 20))
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 opt_cfg=opt_cfg, data=args.data,
                 policy=policy, device=args.device)


if __name__ == "__main__":
    main()
