"""The control of ``correct`` and the readings that set its limits, on the
card at a cell's own size (not part of a run):

    python3 bench_h100/control.py --workload <cell> --seconds <s> \\
        --seeds 11,12,... --control-seeds 11,12,13

For each seed it runs the cell (a measured window at the cell's own load)
and reads, on the run's own sample of finished requests, the program's
widest gap (the number ``correct`` compares); on the control seeds it also
reads the FP8 reference put in the program's place: at each position of
the same sequences, the gap of the token that the FP8 reference puts first.
One JSON line a seed on standard output; each seed's per-position
readings (gaps, the reference's margins) in ``--out`` as ``.npz``."""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="chiprun_out/control",
                    help="where each seed's per-position readings go")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from run import cache_env
    cache_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bench_h100.harness import run_cell
    from bench_h100.reference.common import FP8
    import numpy as np
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       time.perf_counter(),
                       controls=(FP8(),) if seed in ctrl else ())
        rd = out.readings
        line = {"workload": args.workload, "seed": seed,
                "correct": out.result.get("correct"),
                "program": rd["program"],
                "metrics": {k: v["value"] for k, v in
                            out.result["metrics"].items()},
                "run_s": time.perf_counter() - t}
        if rd["controls"]:
            line["fp8"] = rd["controls"][0]
        print(json.dumps(line), flush=True)
        raw = {f"{k}_{i}": v for i, p in enumerate(rd["raw"])
               for k, v in (("gap", p["gap"]), ("margin", p["margin"]),
                            *(("fp8gap", c) for c in p["controls"]))}
        np.savez(out_dir / f"{args.workload}.{seed}.npz", **raw)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
