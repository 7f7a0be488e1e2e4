"""The baseline of justified suppressions: load, match and write
``baseline.toml`` (port of ``repro/analysis/baseline.py``).

Every entry suppresses exactly one finding key, ``(rule, path, symbol,
detail)`` (line-insensitive), and must carry a real ``reason``. An entry
without one, with a placeholder (TODO / FIXME / XXX), or covering a
symbol the registry marks step-strict is a configuration error: the CLI
exits 2 before it reports anything. The file is TOML, read with the
standard library's ``tomllib``.
"""

from __future__ import annotations

import fnmatch
import os
import re
import tomllib
from dataclasses import dataclass, field

from . import registry
from .findings import RunResult
from .rules import canon_path

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.toml")

_PLACEHOLDER = re.compile(r"^\s*(TODO|FIXME|XXX)\b", re.IGNORECASE)

_KEYS = ("rule", "path", "symbol", "detail", "reason")


class BaselineError(ValueError):
    """A malformed baseline or an illegal suppression (exit code 2)."""


@dataclass
class Baseline:
    path: str
    entries: list = field(default_factory=list)   # list[dict]

    def split(self, findings) -> RunResult:
        """Findings against the baseline: ``new`` (these fail the run),
        ``suppressed``, and ``stale`` entries that matched nothing
        (reported so the file shrinks as debt is paid; not failing)."""
        used = [False] * len(self.entries)
        res = RunResult(findings=list(findings))
        for f in findings:
            hit = next((i for i, e in enumerate(self.entries)
                        if self._matches(e, f)), None)
            if hit is None:
                res.new.append(f)
            else:
                used[hit] = True
                res.suppressed.append(f)
        res.stale = [e for e, u in zip(self.entries, used) if not u]
        return res

    @staticmethod
    def _matches(entry, finding) -> bool:
        return (entry["rule"] == finding.rule
                and entry["path"] == canon_path(finding.path)
                and entry["symbol"] == finding.symbol
                and entry["detail"] == finding.detail)


def load_baseline(path: str | None = None) -> Baseline:
    """Load and validate ``baseline.toml``. Raises BaselineError on a
    malformed file, a missing or placeholder reason, or an entry on
    step-strict code. A missing file is an empty baseline."""
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return Baseline(path=path)
    with open(path, "rb") as fh:
        try:
            doc = tomllib.load(fh)
        except tomllib.TOMLDecodeError as e:
            raise BaselineError(f"{path}: invalid TOML: {e}") from e
    entries = doc.get("suppress", [])
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: 'suppress' must be an array of "
                            f"tables")
    for i, e in enumerate(entries):
        where = f"{path}: [[suppress]] #{i + 1}"
        missing = [k for k in _KEYS
                   if not isinstance(e.get(k), str)
                   or (k != "symbol" and not e[k].strip())]
        if missing:
            raise BaselineError(
                f"{where}: missing or empty field(s): {', '.join(missing)}"
                f"; every suppression needs rule/path/symbol/detail and a "
                f"reason")
        if _PLACEHOLDER.match(e["reason"]):
            raise BaselineError(
                f"{where}: placeholder reason {e['reason']!r}; write why "
                f"this finding is acceptable")
        e["path"] = canon_path(e["path"])
        for suffix, glob in registry.STEP_STRICT:
            if (e["path"].endswith(canon_path(suffix))
                    and fnmatch.fnmatch(e["symbol"], glob)):
                raise BaselineError(
                    f"{where}: {e['symbol']!r} in {e['path']} is "
                    f"step-strict (per-decode-step code): fix the "
                    f"finding; suppressions are for scheduling-event "
                    f"code only")
    return Baseline(path=path, entries=list(entries))


def write_baseline(path: str, findings) -> int:
    """Write a baseline covering ``findings`` with placeholder reasons,
    which fail validation until each is replaced by a real one (so this
    is no way to get to green). Returns the number of entries."""
    seen = set()
    lines = ["# repro_torch.analysis baseline: suppressed findings, one "
             "table per", "# finding key (rule/path/symbol/detail). Every "
             "entry needs a real", "# reason; placeholder reasons fail "
             "validation.", "", "version = 1"]
    for f in findings:
        key = (f.rule, canon_path(f.path), f.symbol, f.detail)
        if key in seen:
            continue
        seen.add(key)
        lines += ["", "[[suppress]]", f'rule = "{f.rule}"',
                  f'path = "{key[1]}"', f'symbol = "{f.symbol}"',
                  f'detail = "{f.detail}"',
                  'reason = "TODO: justify this suppression"']
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return len(seen)
