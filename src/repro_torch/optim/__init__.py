"""AdamW of the port (see ``adamw``)."""

from .adamw import OptConfig, global_norm, init, schedule, update

__all__ = ["OptConfig", "global_norm", "init", "schedule", "update"]
