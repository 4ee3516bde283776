"""CLI: ``python -m repro_torch.analysis --paths src/repro_torch chip_smoke.py``.

Exit codes: 0 = clean (modulo baseline), 1 = new findings or file
errors, 2 = usage error. ``--write-baseline`` regenerates the baseline
from the current findings (then hand-edit each entry's justification).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.core import (DEFAULT_BASELINE, Baseline,
                                       entry_key, load_baseline,
                                       run_analysis)
from repro_torch.analysis.registry import ALL_RULES, get_rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the PyTorch port (trace-safety, "
                    "lock discipline, determinism, kernel contracts).")
    ap.add_argument("--paths", nargs="+", default=["src/repro_torch"],
                    help="files or directories to analyze")
    ap.add_argument("--root", default=".",
                    help="repo root paths are relative to (and baseline "
                         "paths are recorded against)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="grandfathered-findings file ('' to disable)")
    ap.add_argument("--rules", default=None,
                    help=f"comma-separated rule families to run "
                         f"(default all: {','.join(ALL_RULES)})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--verbose", action="store_true",
                    help="also list baselined findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite --baseline from current findings "
                         "(keeps existing justifications)")
    args = ap.parse_args(argv)

    try:
        rules = get_rules(args.rules.split(",") if args.rules else None)
    except KeyError as e:
        ap.error(str(e))
    if args.write_baseline and not args.baseline:
        ap.error("--write-baseline needs --baseline")
    baseline = load_baseline(args.baseline or None)
    report = run_analysis(args.paths, root=args.root, baseline=baseline,
                          rules=rules)

    if args.write_baseline:
        # keep hand-written justifications for findings that persist
        just = {entry_key(e): str(e.get("justification", ""))
                for e in baseline.entries}
        fresh = Baseline.from_findings(report.findings)
        for e in fresh.entries:
            if just.get(entry_key(e)):
                e["justification"] = just[entry_key(e)]
        fresh.dump(args.baseline)
        print(f"wrote {len(fresh.entries)} entries to {args.baseline} "
              f"(review every 'TODO: justify')")
        return 0

    if args.as_json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.render(verbose=args.verbose))
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
