"""``python -m repro_torch.analysis`` (port of ``repro/analysis/cli.py``):
the AST lint as a gate.

Exit codes:

* **0**: no findings, or every finding covered by a justified baseline
  entry (stale entries are reported but do not fail);
* **1**: at least one finding not in the baseline;
* **2**: a configuration error: an unreadable baseline, a suppression
  without a real reason, or a suppression on step-strict code.

Stdlib only: the gate runs without torch.
"""

from __future__ import annotations

import argparse
import json
import sys

from .baseline import (DEFAULT_BASELINE, Baseline, BaselineError,
                       load_baseline, write_baseline)
from .findings import RunResult
from .rules import ALL_RULES, run_rules


def run_analysis(paths, *, baseline_path: str | None = None,
                 use_baseline: bool = True, rules=None) -> RunResult:
    """Library entry point: the findings over ``paths`` split against
    the baseline."""
    findings, _ = run_rules(paths, rules=rules)
    base = load_baseline(baseline_path) if use_baseline else Baseline("")
    return base.split(findings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Hot-path contract lint over repro_torch sources (the "
                    "AST layer; the carry and capture audits are "
                    "repro_torch.analysis.graph_audit).")
    ap.add_argument("paths", nargs="+",
                    help="files or directories (e.g. src/repro_torch)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline TOML (default: the package's)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the findings to --baseline with "
                         "placeholder reasons (which fail validation "
                         "until replaced)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            doc = (r.__doc__ or "").strip().splitlines()[0]
            print(f"{r.name:<24} {doc}")
        return 0

    findings, n_files = run_rules(args.paths)
    if args.write_baseline:
        n = write_baseline(args.baseline, findings)
        print(f"wrote {n} suppression(s) to {args.baseline}: give each "
              f"a reason before this baseline validates")
        return 0
    try:
        base = (Baseline("") if args.no_baseline
                else load_baseline(args.baseline))
    except BaselineError as e:
        print(f"repro_torch.analysis: baseline error: {e}", file=sys.stderr)
        return 2
    res = base.split(findings)
    if args.as_json:
        print(json.dumps({
            "files": n_files,
            "new": [f.__dict__ | {"severity": str(f.severity)}
                    for f in res.new],
            "suppressed": len(res.suppressed),
            "stale": res.stale}, indent=2, default=str))
    else:
        _report(res, n_files)
    return 1 if res.failed else 0


def _report(res: RunResult, n_files: int) -> None:
    for f in res.new:
        print(f.render())
    for e in res.stale:
        print(f"stale baseline entry (matched nothing; remove it): "
              f"{e['rule']} {e['path']} [{e.get('symbol', '')}] "
              f"{e['detail']}")
    verdict = "FAIL" if res.failed else "ok"
    print(f"repro_torch.analysis: {verdict}: {len(res.findings)} "
          f"finding(s) ({len(res.new)} new, {len(res.suppressed)} "
          f"suppressed, {len(res.stale)} stale) over {n_files} file(s)")
