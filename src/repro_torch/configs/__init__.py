"""Config registry of the port: only the architectures ported so far
(gpt2-small, mamba2-1.3b, recurrentgemma-9b, phi3-medium-14b,
h2o-danube3-4b, dbrx-132b, grok-1-314b)."""

from .base import ModelConfig
from . import (dbrx_132b, gpt2_small, grok1_314b, h2o_danube3_4b,
               mamba2_1_3b, phi3_medium_14b, recurrentgemma_9b)

REGISTRY = {c.arch_id: c for c in (gpt2_small.CONFIG, mamba2_1_3b.CONFIG,
                                   recurrentgemma_9b.CONFIG,
                                   phi3_medium_14b.CONFIG,
                                   h2o_danube3_4b.CONFIG,
                                   dbrx_132b.CONFIG, grok1_314b.CONFIG)}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise ValueError(f"arch {arch_id!r} is not ported yet; "
                         f"ported: {list(REGISTRY)}") from None


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
