"""Sequence-sharded decode over ``torch.distributed`` ranks (see
``sharding``)."""

from .sharding import (KV_MODES, ShardGroup, ShardSpec, init_from_env,
                       init_shard_group, resolve_kv_shards)

__all__ = ["KV_MODES", "ShardGroup", "ShardSpec", "init_from_env",
           "init_shard_group", "resolve_kv_shards"]
