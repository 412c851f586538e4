"""The knee sweep of an open-loop cell, on the card (not part of a run):
the cell at each rate of ``--rates`` in turn, one process, the reference
skipped. One JSON line a rate: the end-to-end metrics, the requests due
and the requests finished, so the highest rate without a growing backlog
can be read off.

    python3 bench_h100/sweep.py --workload <cell> --seconds <s> --rates 0.5,1,1.5
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from run import cache_env
    cache_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bench_h100 import traffic
    from bench_h100.harness import find, run_cell
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find(bench["workloads"], args.workload, "workload")
    for rate in (float(r) for r in args.rates.split(",")):
        mix = traffic.load_mix(cell["traffic"], ROOT / "bench_h100")
        mix["arrivals"]["rate_per_s"] = rate
        out = run_cell(ROOT, args.workload, args.seed, args.seconds, False,
                       time.perf_counter(), mix=mix, check=False)
        print(json.dumps({"rate_per_s": rate, **out.e2e,
                          "notes": out.notes[:2]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
