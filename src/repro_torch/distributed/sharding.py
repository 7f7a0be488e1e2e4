"""Placement of the decode KV cache over ``torch.distributed`` ranks.

The port's counterpart of ``repro/distributed/sharding.py:142-223``
(``cache_specs`` / ``decode_kv_axis`` / ``serve_cache_sharding``). There a
cache is sharded over a mesh axis by a PartitionSpec; here every rank is
one process holding its own slice, and the pieces are:

``ShardGroup``
    A ``torch.distributed`` process group as the sharded decode uses it:
    rank, world size and the two collectives of the stats merges
    (``all_gather``, ``all_reduce``), each call counted.
``ShardSpec``
    One cache's slice: the group, the local length ``local_s`` of the
    sequence axis, and ``offset = rank * local_s``, the global position
    of the slice's first row.
``resolve_kv_shards``
    ``kv_mode`` -> how many shards a serving cache gets. "seq" shards
    linear "bshd" dense caches over every rank of the group when the
    length divides (for a paged pool, the pages per slot too); "auto"
    and "batch" leave the cache whole on every rank (the reference's
    choice on a (1, n) mesh). A "bhsd" cache under "seq" raises: the
    reference shards heads there, which the port does not yet.
``init_from_env`` / ``init_shard_group``
    Process-group setup: from the ``torchrun`` environment, or from an
    explicit ``init_method`` (a ``file://`` store in tests), always with
    a timeout so that ranks that diverge fail instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

KV_MODES = ("auto", "seq", "batch")
DEFAULT_TIMEOUT_S = 300

_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}
# the flat all_gather: all_gather_single where torch has it, the older
# name (deprecated since) elsewhere
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class ShardGroup:
    """A process group with the sharded decode's two collectives.

    ``calls`` counts the collectives issued through it and ``kinds``
    the same by kind ("all_gather", "all_reduce_max", "all_reduce_sum"),
    which ``analysis.graph_audit`` holds to a step's budget. CUDA tensors go
    to the collectives as they are: NCCL moves them between cards, gloo
    (CPU ranks, or ranks sharing one card, which NCCL refuses) stages
    them through host memory itself (``host_staged``), so times taken
    over gloo measure host-staged collectives, not NVLink."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.host_staged = self.backend == "gloo"
        self.calls = 0
        self.kinds: dict = {}

    def _count(self, kind: str) -> None:
        self.calls += 1
        self.kinds[kind] = self.kinds.get(kind, 0) + 1

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: (world, *t.shape)."""
        src = t.contiguous().reshape(-1)
        out = torch.empty((self.world * src.numel(),), dtype=src.dtype,
                          device=src.device)
        _ALL_GATHER(out, src, group=self.group)
        self._count("all_gather")
        return out.view(self.world, *t.shape)

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """The elementwise ``op`` ("max" or "sum") of every rank's ``t``,
        as a new tensor."""
        buf = t.contiguous().clone()
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        self._count(f"all_reduce_{op}")
        return buf


@dataclass(frozen=True)
class ShardSpec:
    """One rank's slice of a sequence-sharded cache: rows
    [offset, offset + local_s) of the global sequence axis."""

    comm: ShardGroup
    local_s: int

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def world(self) -> int:
        return self.comm.world

    @property
    def offset(self) -> int:
        return self.comm.rank * self.local_s


def resolve_kv_shards(cfg, kv_mode: str, comm, cache_s: int, *,
                      page=None) -> int:
    """Shards of the sequence axis for a serving cache of ``cache_s``
    positions (1: the whole cache on every rank). ``page`` is the page
    size of a paged pool, whose pages per slot must divide as well."""
    if kv_mode not in KV_MODES:
        raise ValueError(f"kv_mode {kv_mode!r} not in {KV_MODES}")
    if kv_mode != "seq":
        return 1
    if cfg.kv_cache_layout != "bshd":
        raise NotImplementedError(
            f"kv_mode='seq' with a {cfg.kv_cache_layout!r} cache: the "
            f"reference shards its heads, and head sharding is not ported "
            f"(ROADMAP.md, A10)")
    world = 1 if comm is None else comm.world
    if world <= 1 or cache_s % world:
        return 1
    if page is not None and -(-cache_s // page) % world:
        return 1
    return world


def init_shard_group(init_method: str, rank: int, world: int, *, device,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> ShardGroup:
    """Join the default process group and wrap it. NCCL when every rank
    has a card of its own, else gloo (CPU ranks, or ranks sharing a
    card, which NCCL refuses)."""
    dev = torch.device(device)
    backend = ("nccl" if dev.type == "cuda"
               and world <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ShardGroup()


def init_from_env(device, *, timeout_s: float = DEFAULT_TIMEOUT_S):
    """(ShardGroup or None, this rank's device) from the ``torchrun``
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).
    Outside ``torchrun``, or with one rank, there is no group. A CUDA
    rank takes ``cuda:{LOCAL_RANK % device_count}``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if world <= 1:
        return None, dev
    comm = init_shard_group("env://", int(os.environ["RANK"]), world,
                            device=dev, timeout_s=timeout_s)
    return comm, dev
