"""The control of ``correct`` on the card: the reference computed in FP8 put
in the program's place must come out not correct, and the program must
not, on one seed of each cell at the cell's own size and load (a window of
20 s). On the CPU it skips; on the card:

    python3 -m pytest -q -m cuda bench_h100/tests/test_h100bench_control.py
"""
import json
import time

import pytest

from tiny import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_h100.harness import run_cell
    from bench_h100.oracle import load_limits
    from bench_h100.reference.common import FP8
    from bench_h100.run import cache_env
    cache_env(ROOT)
    out = run_cell(ROOT, cell, 2**31 + 5, 20.0, False, time.perf_counter(),
                   controls=(FP8(),))
    limit = load_limits(cell)["contested_gap_ms"]["limit"]
    assert out.result["correct"], out.checks
    assert out.readings["controls"][0]["contested_gap_ms"] > limit
