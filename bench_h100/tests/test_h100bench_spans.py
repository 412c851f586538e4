"""The readings of the program's own records (``spans.py``): from a tiny
CPU run with the program's recorder switched on, none without one, and
idle gaps named by the loop's leaf spans."""
import pytest

import tiny
from bench_h100 import harness, spans
from bench_h100.trace import label_gaps

HOST = (spans.queue_wait_p90_ms, spans.prefill_p90_ms, spans.emit_lag_ms)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


def _traced_run(root, monkeypatch, recorder):
    """A traced tiny run with the engine's recorder set as the traffic
    starts; returns the recorder and the run's host window."""
    from repro_torch.serving.trace import StepRecorder
    seen = {}

    class View(harness.RunView):
        def __init__(self, *args):
            super().__init__(*args)
            seen["view"] = self
    monkeypatch.setattr(harness, "RunView", View)
    rec = StepRecorder() if recorder else None

    def switch_on(ae):
        ae.engine.recorder = rec
    tiny.run(root, "tiny-dense-poisson", trace=True, check=False,
             fault=switch_on)
    v = seen["view"]
    return rec, v.w0, v.w1


def test_a_tiny_run_gives_the_host_readings(root, monkeypatch):
    rec, w0, w1 = _traced_run(root, monkeypatch, True)
    for read in HOST:
        v = read(rec, w0, w1)
        assert v is not None and v >= 0, read.__name__
    # no card: no device ms, whatever the step kind
    assert spans.device_ms(rec, w0, w1, True) is None
    assert spans.device_ms(rec, w0, w1, False) is None
    # every request submitted in the window went through prefill
    assert spans.prefill_p90_ms(rec, w0, w1) > 0


def test_without_a_recorder_every_reading_is_none(root, monkeypatch):
    rec, w0, w1 = _traced_run(root, monkeypatch, False)
    assert rec is None
    assert all(read(rec, w0, w1) is None for read in HOST)
    assert spans.device_ms(rec, w0, w1, True) is None
    assert spans.leaf_spans(rec) is None


def test_what_ends_past_the_window_is_left_out():
    """A traced run's window ends where the loop pauses for the profiler:
    a wait that straddles the pause is not read."""
    from repro_torch.serving.trace import RequestRecord, Span, StepRecorder
    rec = StepRecorder()
    rec.requests += [RequestRecord(0, "FINISHED", 1.0, 1.1, 1.2, 1.3, 2.0),
                     RequestRecord(1, "FINISHED", 1.5, 1.6, 15.0, 15.1, 16),
                     RequestRecord(2, "FINISHED", 1.8, 14.0, 14.1, 14.2, 16)]
    rec.spans += [Span("dispatch", "loop", 1.0, 1.01, 0, None),
                  Span("sync", "worker", 1.0, 1.05, 0, None),
                  Span("emit", "loop", 1.05, 1.06, 0, None),
                  Span("dispatch", "loop", 1.9, 1.91, 1, None),
                  Span("sync", "worker", 1.9, 1.95, 1, None),
                  Span("emit", "loop", 13.0, 13.1, 1, None)]
    w0, w1 = 0.0, 2.0
    assert spans.queue_wait_p90_ms(rec, w0, w1) == pytest.approx(100.0)
    assert spans.prefill_p90_ms(rec, w0, w1) == pytest.approx(100.0)
    assert spans.emit_lag_ms(rec, w0, w1) == pytest.approx(10.0)


def test_gaps_are_named_by_the_loop_leaf_spans():
    from repro_torch.serving.trace import Span, StepRecorder
    rec = StepRecorder()
    rec.spans += [Span("dispatch", "loop", 0.0, 10.0, 0, None),
                  Span("plan", "loop", 0.0, 1.0, 0, "dispatch"),
                  Span("build", "loop", 1.0, 8.0, 0, "dispatch"),
                  Span("launch", "loop", 8.0, 10.0, 0, "dispatch"),
                  Span("sync", "worker", 0.0, 20.0, 0, None),
                  Span("emit_wait", "loop", 12.0, 20.0, 0, None)]
    leaves = spans.leaf_spans(rec)
    assert [n for n, _, _ in leaves] == ["plan", "build", "launch",
                                         "emit_wait"]
    gaps = [(2.0, 7.0), (13.0, 15.0), (10.5, 11.5)]
    assert label_gaps(gaps, leaves) == [["build", 5e-6], ["emit_wait", 2e-6],
                                        ["host_idle", 1e-6]]
