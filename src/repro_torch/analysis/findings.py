"""Finding and severity model shared by every analysis rule (port of
``repro/analysis/findings.py``).

A finding's identity (``Finding.key``) is line-insensitive:
``(rule, path, symbol, detail)``. Lines shift with every edit; what the
baseline suppresses is "this construct in this function". ``detail`` is
a short stable token for the flagged construct (``".item()"``), so two
different syncs in one function are suppressed independently.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    """Ordered so ``max()`` over findings gives the run's worst level."""

    WARN = 1     # suspicious; the argument may be a host scalar
    ERROR = 2    # a contract violation: fix it or justify it in baseline

    def __str__(self) -> str:
        return self.name.lower()


@dataclass(frozen=True)
class Finding:
    rule: str          # rule name (kebab-case, stable)
    severity: Severity
    path: str          # posix path as given to the runner
    line: int          # 1-indexed source line (display only)
    symbol: str        # enclosing qualname ("" at module level)
    detail: str        # stable token for the construct (baseline identity)
    message: str

    @property
    def key(self) -> tuple:
        return (self.rule, self.path, self.symbol, self.detail)

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}: {self.severity} "
                f"{self.rule}{sym}: {self.message}")


@dataclass
class RunResult:
    """One analysis run: the findings split against a baseline."""

    findings: list = field(default_factory=list)
    new: list = field(default_factory=list)        # not in the baseline
    suppressed: list = field(default_factory=list)
    stale: list = field(default_factory=list)      # entries matching none

    @property
    def failed(self) -> bool:
        return bool(self.new)
