"""CLI for the port's cooptlint: ``python -m repro_torch.analysis
[paths...]``.

Exit status is 0 iff every finding is suppressed inline or carried by the
committed baseline, so CI can run this as a blocking gate.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.analysis.core import (Finding, baseline_keys, load_baseline,
                                       run_suite, write_baseline)

_DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def _print_text(live: List[Finding], suppressed: List[Finding],
                baselined: List[Finding], kernel_report) -> None:
    for f in live:
        sym = f" [{f.symbol}]" if f.symbol else ""
        print(f"{f.path}:{f.line}: {f.code}{sym}: {f.message}")
    if kernel_report:
        print()
        print("page-table loads of the CUDA kernels (COOPT005):")
        for e in kernel_report:
            guards = ", ".join(f"{r['table']}@{r['line']} "
                               f"{r['guard'] or 'UNGUARDED'}"
                               for r in e["table_loads"]) or "no table"
            print(f"  {e['kernel']:<28s} {e['path']}:{e['line']}: {guards}")
    print()
    print(f"cooptlint: {len(live)} finding(s), {len(suppressed)} "
          f"suppressed inline, {len(baselined)} baselined")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="cooptlint for the port: host syncs, mesh-ctx scoping, "
                    "CUDA-graph capture safety, the kernels' -1 page "
                    "sentinel and fault swallowing")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=_DEFAULT_BASELINE,
                    help="baseline JSON of grandfathered findings "
                         "(default: the committed src/repro_torch/analysis/"
                         "baseline.json); pass '' to disable")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current live findings to --baseline "
                         "(each entry then needs a justification) and "
                         "exit 0")
    ap.add_argument("--select", default=None,
                    help="comma-separated finding codes to run, e.g. "
                         "COOPT001,COOPT005")
    args = ap.parse_args(argv)

    paths = args.paths or ["src/repro_torch"]
    select = ([c.strip() for c in args.select.split(",") if c.strip()]
              if args.select else None)
    baseline = args.baseline or None

    live, suppressed, baselined, kernel_report = run_suite(
        paths, select=select, baseline_path=baseline)

    if args.write_baseline:
        if not baseline:
            print("--write-baseline requires --baseline", file=sys.stderr)
            return 2
        write_baseline(baseline, live)
        print(f"wrote {len(live)} finding(s) to {baseline}; fill in the "
              "justification for each")
        return 0

    # stale-baseline hygiene: entries that no longer match anything are
    # reported (non-fatal) so the baseline shrinks over time
    stale = 0
    if baseline:
        matched = {f.match_key() for f in baselined}
        stale = len(baseline_keys(load_baseline(baseline)) - matched)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in live],
            "suppressed": [f.to_json() for f in suppressed],
            "baselined": [f.to_json() for f in baselined],
            "stale_baseline_entries": stale,
            "kernel_report": kernel_report,
        }, indent=2))
    else:
        _print_text(live, suppressed, baselined, kernel_report)
        if stale:
            print(f"note: {stale} baseline entr{'y' if stale == 1 else 'ies'} "
                  "no longer match any finding — prune the baseline")
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
