"""Profile one (architecture x input shape) cell on the card: the top
kernels by card time in a ``torch.profiler`` trace of one step, the
roofline terms, the peak memory beside the dry run's and the card's free
memory.

  python -m repro_torch.launch.inspect_cell --arch qwen3-4b --shape long_500k
      [--mode coopt] [--top 15] [--seed 0]

The cell must be one the dry run (``launch.dryrun``) says fits one card. It
is built through ``make_step`` with random weights and inputs from
``--seed`` (a decode cell's cache full of random pages), with the
hand-written kernels, and its step runs once to warm. Then one step is
timed with CUDA events and one more traced. The roofline
terms are the dry run's counts over the card's peaks (``launch.mesh``): C =
FLOPs / ``PEAK_FLOPS_BF16`` and M = the bytes the step must move
(``cost["min_bytes"]``: weights, the cache rows it reads and writes, its
inputs and outputs, each once) / ``HBM_BW``. The plain path's per-op
bytes accessed are printed beside them (they count its f32 dequantized
copies of the pages), and so are the card's name and power limit.
The trace passes through a temporary file, removed once read. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.core.coopt import MODES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.launch.steps import StepBundle, make_step

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def fresh(bundle: StepBundle, args):
    """The step's inputs for one more run: a serving step replaces the
    cache dict's ``length``, so each run gets a shallow copy of the dict
    (the pool tensors are shared; a rerun writes the same token again)."""
    if bundle.kind == "train":
        return args
    params, batch, cache = args
    return params, batch, dict(cache)


def trace_step(fn) -> Dict[str, Any]:
    """Run ``fn()`` under ``torch.profiler`` and return the card's
    activities by name: {name: [count, us]}, and their busy us (the union
    of their intervals)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    acts = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X"
                  and str(e.get("cat", "")).lower() in _DEVICE_CATS)
    by_name: Dict[str, list] = {}
    busy, end = 0.0, float("-inf")
    for s, e, name in acts:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += e - s
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"by_name": by_name, "busy_us": busy, "activities": len(acts)}


def inspect(bundle: StepBundle, args, dry: dict, *, top: int = 15,
            card_line: Optional[str] = None) -> Dict[str, Any]:
    """Warm, time and trace one step of ``bundle`` on ``args`` (on the
    card). ``dry`` is the cell's dry-run record. Returns the step ms, the
    trace's top ``top`` activities by card time, the roofline terms and the
    peak memory beside the dry run's."""
    if not torch.cuda.is_available():
        raise RuntimeError("inspect_cell needs a CUDA device")
    fn = bundle.fn
    fn(*fresh(bundle, args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn(*fresh(bundle, args))
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    free, total = torch.cuda.mem_get_info()
    tr = trace_step(lambda: fn(*fresh(bundle, args)))
    ranked = sorted(tr["by_name"].items(), key=lambda kv: -kv[1][1])
    mem = dry["memory"]
    flops, moved = dry["cost"]["flops"], dry["cost"]["min_bytes"]
    return {
        "arch": dry["arch"], "shape": dry["shape"], "kind": bundle.kind,
        "use_kernel": bundle.coopt.use_kernel, "card": card_line,
        "step_ms": start.elapsed_time(end), "host_ms": host_ms,
        "busy_ms": tr["busy_us"] / 1e3, "activities": tr["activities"],
        "top": [{"name": n, "calls": c, "ms": us / 1e3}
                for n, (c, us) in ranked[:top]],
        "flops": flops, "min_bytes": moved,
        "bytes_accessed": dry["cost"]["bytes accessed"],
        "C_s": flops / PEAK_FLOPS_BF16, "M_s": moved / HBM_BW,
        "peak_bytes": peak,
        "reserved_bytes": torch.cuda.max_memory_reserved(),
        "free_bytes": free, "total_bytes": total,
        "dry_bytes": mem["argument_bytes"] + mem["temp_bytes"],
        "dry_argument_bytes": mem["argument_bytes"],
        "dry_temp_bytes": mem["temp_bytes"]}


def report(r: Dict[str, Any], log=print) -> None:
    """Print ``inspect``'s result."""
    log(f"{r['arch']} x {r['shape']} ({r['kind']}, kernels "
        f"{r['use_kernel']}) on {r['card']}: step {r['step_ms']:.3f} ms "
        f"(host {r['host_ms']:.3f}), card busy {r['busy_ms']:.3f} ms over "
        f"{r['activities']} activities")
    log(f"  terms: C={r['C_s']:.3e}s M={r['M_s']:.3e}s ({r['flops']:.3e} "
        f"FLOPs, {r['min_bytes']:.3e} B to move; {PEAK_FLOPS_BF16:.3g} "
        f"FLOP/s, {HBM_BW:.3g} B/s); the plain path accesses "
        f"{r['bytes_accessed']:.3e} B")
    log(f"  peak {r['peak_bytes'] / 2**30:.3f} GiB allocated "
        f"({r['reserved_bytes'] / 2**30:.3f} reserved); dry run "
        f"{r['dry_bytes'] / 2**30:.3f} GiB (arguments "
        f"{r['dry_argument_bytes'] / 2**30:.3f} + temp "
        f"{r['dry_temp_bytes'] / 2**30:.3f}); the card's free memory "
        f"after the step {r['free_bytes'] / 2**30:.3f} of "
        f"{r['total_bytes'] / 2**30:.3f} GiB")
    log(f"  top {len(r['top'])} card activities by time:")
    for k in r["top"]:
        log(f"    {k['ms']:10.4f} ms {k['calls']:6d}x  {k['name'][:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mode", default="coopt", choices=list(MODES))
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("inspect_cell: no CUDA device", file=sys.stderr)
        return 2
    coopt = MODES[args.mode].replace(use_kernel=True)
    card_line = dryrun.card()
    dry = dryrun.run_one(args.arch, args.shape, coopt=coopt,
                         card_line=card_line)
    if dry["status"] != "ok" or not dry["fits_h100_80gib"]:
        print(f"inspect_cell: {args.arch} x {args.shape} is not a cell "
              "that fits one card", file=sys.stderr)
        return 1
    bundle = make_step(args.arch, args.shape, coopt, device="cuda")
    r = inspect(bundle, bundle.init_args(args.seed), dry, top=args.top,
                card_line=card_line)
    report(r)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
