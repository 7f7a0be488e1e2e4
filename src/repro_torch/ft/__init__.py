"""Fault injection for the serving engine (see ``inject``) and the
trainer's fault-tolerance runtime (see ``runtime``)."""

from .inject import (FAULT_SEED_ENV, POINTS, FaultInjector, InjectedFault,
                     default_chaos_rates)
from .runtime import PreemptionGuard, StragglerDetector, run_supervised

__all__ = ["FAULT_SEED_ENV", "POINTS", "FaultInjector", "InjectedFault",
           "default_chaos_rates", "PreemptionGuard", "StragglerDetector",
           "run_supervised"]
