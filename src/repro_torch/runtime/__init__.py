"""Runtime execution-policy layer of the port (see ``policy``)."""

from .policy import (ExecPolicy, resolve_policy, policy_from_env,
                     parse_policy_groups, EXP_BACKENDS, KERNEL_BACKENDS,
                     ENV_PREFIX)
from .device import resolve_device

__all__ = ["ExecPolicy", "resolve_policy", "policy_from_env",
           "parse_policy_groups", "EXP_BACKENDS", "KERNEL_BACKENDS",
           "ENV_PREFIX", "resolve_device"]
