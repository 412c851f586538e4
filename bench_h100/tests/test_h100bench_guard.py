"""No module of the JAX stack or the JAX package loads with the harness,
and the references load nothing of the program."""
import json
import subprocess
import sys

from tiny import ROOT

HARNESS = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import bench_h100.harness, bench_h100.trace, bench_h100.record
import bench_h100.window, bench_h100.weights, bench_h100.roofline
import repro_torch.serving.frontend, repro_torch.launch.steps
from bench_h100.traffic import load_file
from pathlib import Path
for kind in ("metrics", "generators", "reference"):
    for f in sorted(Path({root!r}, "bench_h100", kind).glob("*.py")):
        load_file(f, "_m_" + f.stem.replace(".", "_"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
from bench_h100 import oracle
for name in ("qwen2", "deepseek_v2"):
    oracle.reference_module(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(
        src=str(ROOT / "src"), root=str(ROOT))], capture_output=True,
        text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    names = top_level(HARNESS)
    assert "repro_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_program():
    names = top_level(REFERENCE)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_modules_compares_whole_names():
    from bench_h100.harness import forbidden_modules
    sys.modules.setdefault("repro_torch_like", sys)
    assert "repro" not in forbidden_modules() or "repro" in {
        m.split(".")[0] for m in sys.modules}
