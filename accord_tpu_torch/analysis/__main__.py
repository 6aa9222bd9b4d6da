"""CLI runner: `python -m accord_tpu_torch.analysis`.

Exit codes: 0 clean (possibly with suppressed/stale warnings), 2 when
unsuppressed findings exist, 3 on baseline-policy violations.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import PASSES, run_repo
from .baseline import (DEFAULT_BASELINE, BaselineError, load_baseline,
                       write_baseline)
from .core import build_package_index


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m accord_tpu_torch.analysis",
        description="accord-lint: protocol static analysis")
    ap.add_argument("--select", default=None,
                    help=f"comma-separated pass names "
                         f"(default: all of {','.join(PASSES)})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file (use '' to disable)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write every current finding to the baseline file "
                         "with a TODO justification (must be edited before "
                         "it will load)")
    args = ap.parse_args(argv)

    select = args.select.split(",") if args.select else None
    baseline_path = Path(args.baseline) if args.baseline else None

    if args.write_baseline:
        index = build_package_index()
        report = run_repo(select=select, baseline_path=None, index=index)
        write_baseline(report.new, baseline_path or DEFAULT_BASELINE)
        print(f"wrote {len(report.new)} entries to "
              f"{baseline_path or DEFAULT_BASELINE} — justify each before "
              f"checking in")
        return 0

    try:
        report = run_repo(select=select, baseline_path=baseline_path)
    except BaselineError as e:
        print(f"baseline policy violation: {e}", file=sys.stderr)
        return 3
    except KeyError as e:
        ap.error(str(e.args[0] if e.args else e))

    if args.as_json:
        print(json.dumps({
            "ok": report.ok,
            "findings": [f.to_json() for f in report.new],
            "suppressed": [f.to_json() for f in report.suppressed],
            "stale_baseline_keys": report.stale,
            "timings_s": {k: round(v, 4) for k, v in report.timings.items()},
        }, indent=2))
    else:
        for f in report.new:
            print(f.render())
        total = sum(report.timings.values())
        print(f"accord-lint: {len(report.new)} finding(s), "
              f"{len(report.suppressed)} suppressed by baseline, "
              f"{len(report.stale)} stale baseline key(s) "
              f"[{total:.2f}s]")
        for k in report.stale:
            print(f"  stale baseline entry (construct gone — remove): {k}")
    return 0 if report.ok else 2


if __name__ == "__main__":
    sys.exit(main())
