"""Readings of the program's own records of a run: the serving loop's
spans, step records and request stamps that ``repro_torch`` keeps when its
engine's ``recorder`` is set (``repro_torch/serving/trace.py``), read over
a window [w0, w1) of the host clock (``time.perf_counter``, the clock
``Tracer.us`` maps onto the device trace).

Each reading counts only intervals that end inside the window: in a traced
run the window ends where the loop pauses for the profiler's start-up (tens
of seconds' wait for whatever straddles it). Each function takes the
recorder, or None for a program that has none, and then returns None; so
does a reading with nothing to read in the window.
"""
from __future__ import annotations

from bench_h100.window import percentile

# the loop thread's innermost spans: what the host was doing in a card gap
LEAVES = ("plan", "build", "load", "launch", "launch_eager", "emit",
          "emit_wait")


def _submitted(rec, w0, w1):
    return [r for r in rec.requests if w0 <= r.submit_time < w1]


def _p90_ms(xs):
    p = percentile(xs, 90)
    return None if p is None else p * 1e3


def _dispatched(rec, w0, w1) -> set:
    """Ids of the steps whose dispatch began in the window."""
    return {s.step for s in rec.spans
            if s.name == "dispatch" and w0 <= s.t0 < w1}


def queue_wait_p90_ms(rec, w0, w1):
    """p90 of admission less submission, over requests submitted in the
    window and admitted in it."""
    if rec is None:
        return None
    return _p90_ms([r.admit_time - r.submit_time
                    for r in _submitted(rec, w0, w1)
                    if 0 <= r.admit_time < w1])


def prefill_p90_ms(rec, w0, w1):
    """p90 of the final prompt chunk's dispatch less admission, over
    requests submitted in the window whose final chunk went out in it."""
    if rec is None:
        return None
    return _p90_ms([r.last_chunk_time - r.admit_time
                    for r in _submitted(rec, w0, w1)
                    if r.admit_time >= 0 and 0 <= r.last_chunk_time < w1])


def emit_lag_ms(rec, w0, w1):
    """Mean over the window's steps emitted in it of the end of ``emit``
    less the end of ``sync``: tokens host-visible to tokens handed to the
    streams."""
    if rec is None:
        return None
    steps = _dispatched(rec, w0, w1)
    synced = {s.step: s.t1 for s in rec.spans if s.name == "sync"}
    lags = [s.t1 - synced[s.step] for s in rec.spans
            if s.name == "emit" and s.t1 < w1 and s.step in steps
            and s.step in synced]
    return sum(lags) / len(lags) * 1e3 if lags else None


def device_ms(rec, w0, w1, mixed: bool):
    """Mean card ms of the window's steps that carry prompt chunks
    (``mixed``) or only decode lanes; None without a card."""
    if rec is None:
        return None
    steps = _dispatched(rec, w0, w1)
    xs = [r.device_ms for r in rec.steps
          if r.mixed == mixed and r.step in steps and r.device_ms is not None]
    return sum(xs) / len(xs) if xs else None


def leaf_spans(rec):
    """The loop's leaf spans as (name, start, end), host clock, for
    ``trace.label_gaps``; None without a recorder."""
    if rec is None:
        return None
    return [(s.name, s.t0, s.t1) for s in rec.spans if s.name in LEAVES]
