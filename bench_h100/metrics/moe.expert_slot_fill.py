"""moe.expert_slot_fill: of the expert slots the MoE layers of the window's
steps computed, the share that held a (real token, routed expert) pair,
in %: real rows x top_k over B x E x C(S), summed over the steps (the
program computes every slot of every expert, filled or not). A step of B
lanes at row width S (1 for a decode step, whose ``rows`` is the lane
count) has C(S) = min(max(ceil(S * top_k / E * cf), 1), S) slots an
expert (``models/moe.py``'s capacity); E and top_k are the configuration
file's, and so are B (its ``num_lanes``) and cf (its
``moe_capacity_factor``), taken from the file whose widths these are. The
program books the same sums as ``EngineStats.moe_pairs`` /
``moe_slots``. Nothing to read for a model without experts, for packed
steps, or where no configuration file has these widths. The run's view
names no configuration file, so the lanes and cf come from the one file
whose widths match: a second file with the same widths and other lanes
or another cf makes this read nothing, without an error. Once the
harness's records carry ``EngineStats.moe_pairs`` / ``moe_slots``, this
reads them and the file scan goes. Moves tpot_p90_ms."""
import json
import math
from pathlib import Path

from bench_h100.roofline import Shapes


def _engine(shapes):
    """(lanes, capacity factor) of the one configuration file with these
    widths, or None."""
    found = set()
    for f in (Path(__file__).resolve().parents[1] / "configs").glob("*.json"):
        hf = json.loads(f.read_text())
        if hf.get("moe_capacity_factor") and Shapes.of(hf) == shapes:
            found.add((hf["engine"]["num_lanes"], hf["moe_capacity_factor"]))
    return found.pop() if len(found) == 1 else None


def read(run):
    sh = run.shapes
    steps = run.window_steps()
    if not sh.experts or not steps or any(s.kind == "packed" for s in steps):
        return None
    engine = _engine(sh)
    if engine is None:
        return None
    lanes, cf = engine
    E, k = sh.experts, sh.top_k
    pairs = slots = 0
    for s in steps:
        S = 1 if s.kind == "decode" else s.rows // lanes
        cap = min(max(math.ceil(S * k / E * cf), 1), S)
        pairs += (s.rows - s.padded) * k
        slots += s.rows // S * E * cap
    return 100.0 * pairs / slots if slots else None
