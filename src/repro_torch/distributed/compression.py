"""Gradient compression with error feedback (port of
``repro/distributed/compression.py:38-66``).

``compressed_psum`` all-reduces gradients in bf16 instead of f32 (half
the data-parallel bytes) while an error-feedback buffer keeps each
rank's quantization residual, so the mean update stays unbiased over
steps. The reference sums over a mesh axis under ``shard_map``; here
the sum is ``torch.distributed.all_reduce`` over a process group (gloo
on CPU ranks, as the sharded decode's ``ShardGroup`` uses it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ef_compress(grad, err):
    """Quantize grad + err to bf16; returns (compressed, new_err)."""
    g = grad.float() + err
    c = g.to(torch.bfloat16)
    return c, g - c.float()


def compressed_psum(grads: dict, errs: dict, group=None):
    """All-reduce a dict of gradients in bf16 with error feedback.

    grads: {name: f32 tensor} (this rank's); errs: matching error
    buffers. Returns ({name: mean over the group's ranks, f32}, new
    errs). The summed values are the bf16 ones, widened to f32 for the
    reduction as the reference's ``psum`` of ``c.astype(f32)``."""
    world = dist.get_world_size(group)
    means, nerrs = {}, {}
    for n, g in grads.items():
        c, nerrs[n] = ef_compress(g, errs[n])
        s = c.float()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        means[n] = s / world
    return means, nerrs
