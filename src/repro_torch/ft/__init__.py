"""Fault injection for the serving engine (see ``inject``)."""

from .inject import (FAULT_SEED_ENV, POINTS, FaultInjector, InjectedFault,
                     default_chaos_rates)

__all__ = ["FAULT_SEED_ENV", "POINTS", "FaultInjector", "InjectedFault",
           "default_chaos_rates"]
