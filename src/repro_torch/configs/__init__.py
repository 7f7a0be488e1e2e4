"""Config registry of the port: only the architectures ported so far."""

from .base import ModelConfig
from . import gpt2_small, mamba2_1_3b, recurrentgemma_9b

REGISTRY = {c.arch_id: c for c in (gpt2_small.CONFIG, mamba2_1_3b.CONFIG,
                                   recurrentgemma_9b.CONFIG)}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise ValueError(f"arch {arch_id!r} is not ported yet; "
                         f"ported: {list(REGISTRY)}") from None


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
