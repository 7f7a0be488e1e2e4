"""Checkpoints of the port, in the JAX package's format (see
``checkpoint``)."""

from .checkpoint import (AsyncCheckpointer, latest_step, restore, save,
                         unflatten_like)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save",
           "unflatten_like"]
