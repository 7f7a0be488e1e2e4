"""Config registry of the port: only the architectures ported so far."""

from .base import ModelConfig
from . import gpt2_small

REGISTRY = {gpt2_small.CONFIG.arch_id: gpt2_small.CONFIG}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise ValueError(f"arch {arch_id!r} is not ported yet; "
                         f"ported: {list(REGISTRY)}") from None


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
