"""Sequence-sharded decode over ``torch.distributed`` ranks (see
``sharding``) and the trainer's compressed gradient all-reduce (see
``compression``)."""

from .compression import compressed_psum, ef_compress
from .sharding import (KV_MODES, ShardGroup, ShardSpec, init_from_env,
                       init_shard_group, resolve_kv_shards)

__all__ = ["compressed_psum", "ef_compress", "KV_MODES", "ShardGroup",
           "ShardSpec", "init_from_env", "init_shard_group",
           "resolve_kv_shards"]
