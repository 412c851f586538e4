"""The serving loop's recorder (``serving/trace.py``) and the engine's row
counters, on a tiny ``AsyncEngine``: off by default, one ``dispatch`` span a
step with its children inside it, the step's ``sync`` and ``emit`` in
order, request stamps in order, ``EngineStats.padded_rows`` against the
built batches. The ``cuda`` case runs on the card
(``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace.py``).
"""
from collections import Counter, defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.serving import AsyncEngine, Engine, EngineConfig  # noqa: E402
from repro_torch.serving.trace import StepRecorder  # noqa: E402

ARCH = "qwen3-4b-reduced"


def _serve(recorder=None, warmup=True, device="cpu", pack=False):
    """Serve five prompts of 5-100 tokens, 6 new tokens each, the last two
    submitted once the first three are running; returns the engine, the
    streams and the host batches built."""
    cfg = get_config(ARCH)
    eng = Engine(cfg, MODES["coopt"].replace(use_kernel=True),
                 EngineConfig(num_lanes=4, max_len=128,
                              prefill_buckets=(32, 64), token_budget=64,
                              pack_prefill=pack, seed=0), device=device)
    built = []
    build = eng._build_step

    def _build_step(plan, device_feed=False):
        sb = build(plan, device_feed)
        built.append(sb)
        return sb
    eng._build_step = _build_step
    fe = AsyncEngine(eng, warmup=warmup)
    eng.recorder = recorder
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 40, 70, 9, 100)]
    streams = [fe.submit(p, max_new_tokens=6) for p in prompts[:3]]
    for _ in range(4):
        fe._loop_once()
    streams += [fe.submit(p, max_new_tokens=6) for p in prompts[3:]]
    fe.run_until_idle()
    fe.close()
    return eng, streams, built


def test_off_by_default_and_recording_changes_no_output():
    eng, streams, _ = _serve()
    assert eng.recorder is None
    rec = StepRecorder()
    _, traced, _ = _serve(rec)
    assert ([list(s.req.output) for s in streams]
            == [list(s.req.output) for s in traced])
    assert rec.spans and rec.steps and rec.requests and rec.dropped == 0


@pytest.mark.parametrize("warmup", [True, False])
def test_each_step_has_one_dispatch_span_with_its_children_inside(warmup):
    """Through the runners a step launches a replay; without them it runs
    eagerly (``launch_eager``, with no ``load``). Each dispatched step: one
    ``dispatch``, its children in order inside it, then one ``sync`` and
    one ``emit`` of the same id."""
    rec = StepRecorder()
    eng, _, built = _serve(rec, warmup=warmup)
    children = (("plan", "build", "load", "launch") if warmup
                else ("plan", "build", "launch_eager"))
    by_step = defaultdict(dict)
    counts = Counter()
    for s in rec.spans:
        by_step[s.step][s.name] = s
        counts[s.step, s.name] += 1
    assert sorted(by_step) == list(range(len(built)))
    assert eng.aot_misses == (0 if warmup else len(built))
    assert [r.step for r in rec.steps] == list(range(len(built)))
    assert all(r.device_ms is None for r in rec.steps)       # the CPU
    for step, sp in by_step.items():
        names = ("dispatch", "sync", "emit") + children
        assert set(names) <= set(sp), (step, sorted(sp))
        assert all(counts[step, n] == 1 for n in names)
        d = sp["dispatch"]
        kids = [sp[n] for n in children]
        assert all(k.parent == "dispatch" and k.thread == "loop"
                   for k in kids)
        assert d.t0 <= kids[0].t0
        for a, b in zip(kids, kids[1:]):
            assert a.t1 <= b.t0
        assert kids[-1].t1 <= d.t1
        assert sp["sync"].thread == "worker"
        assert d.t0 <= sp["sync"].t0 <= sp["sync"].t1 <= sp["emit"].t0
        assert sp["emit"].t0 <= sp["emit"].t1
        assert rec.steps[step].mixed == (built[step].tp > 0)
    for s in rec.spans:
        if s.name == "emit_wait":
            assert s.t1 <= by_step[s.step]["emit"].t0


def test_request_stamps_in_order():
    rec = StepRecorder()
    _, streams, _ = _serve(rec)
    recs = {r.req_id: r for r in rec.requests}
    assert sorted(recs) == sorted(s.req.req_id for s in streams)
    for r in recs.values():
        assert r.reason == "FINISHED"
        assert (0 <= r.submit_time <= r.admit_time <= r.last_chunk_time
                <= r.prefill_time <= r.finish_time)


@pytest.mark.parametrize("pack", [False, True])
def test_padded_rows_count_the_unwritten_slots(pack):
    eng, _, built = _serve(pack=pack)
    slots = [sb.batch["dmeta"][1] if "dmeta" in sb.batch
             else sb.batch["slot_idx"] for sb in built]
    assert any(sb.kind == ("packed" if pack else "prefill") for sb in built)
    assert eng.stats.step_rows == sum(s.size for s in slots)
    assert eng.stats.padded_rows == sum(int((s == -1).sum()) for s in slots)


@pytest.mark.cuda
def test_step_device_ms_on_the_card():
    """Each step's card time is positive and within the host interval from
    its dispatch to its tokens reaching the host; the steps' card times,
    serial on one stream, sum to no more than the whole run's. Graphs are
    captured as without the recorder: no eager step, no new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec = StepRecorder()
    eng, _, built = _serve(rec, device="cuda")
    assert eng.aot_misses == 0
    assert eng.trace_counts == {"decode": 1, "prefill": 2}
    spans = {(s.step, s.name): s for s in rec.spans}
    assert len(rec.steps) == len(built)
    for r in rec.steps:
        d, sync = spans[r.step, "dispatch"], spans[r.step, "sync"]
        assert 0 < r.device_ms <= (sync.t1 - d.t0) * 1e3
    first = spans[0, "dispatch"].t0
    last = spans[len(built) - 1, "sync"].t1
    assert sum(r.device_ms for r in rec.steps) <= (last - first) * 1e3
