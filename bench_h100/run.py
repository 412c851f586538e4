"""The benchmark of ``repro_torch`` on one NVIDIA H100:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints its notes and, last, each number
compared with its limit on standard error, and one JSON result as the last
line of standard output. Without a CUDA card, or with fewer cards than the
cell asks for, it exits 2 and prints no result."""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    set before torch is imported."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        root / "src" / "repro_torch" / "kernels" / "_build")
    cache = root / "bench_h100" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_env(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here in a tree without the program)
    from bench_h100.harness import run_cell

    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), T_PROC)
    for line in out.notes + out.checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
