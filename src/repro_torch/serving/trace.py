"""The serving loop's own spans and records, kept in memory.

Off unless a caller sets ``Engine.recorder = StepRecorder()`` (an
``AsyncEngine``'s engine): every site in the loop tests ``recorder is
None`` and does nothing more. Every host stamp is ``time.perf_counter()``.

Spans (``Span``), by thread:

  * loop: ``dispatch`` (all of ``AsyncEngine._dispatch_one`` for a step
    that was dispatched), with the children ``plan``
    (``scheduler.schedule_step``), ``build`` (``Engine._build_step``),
    ``load`` (``_StepRunner.load``: the pinned staging and the host to
    device copy) and ``launch`` (the graph replay) or ``launch_eager`` (the
    body run eagerly: a step with no runner, an ``aot_misses`` step);
    ``emit`` (routing one completed step's tokens to their streams) and
    ``emit_wait`` (the loop blocked on the emit worker);
  * worker: ``sync`` (the emit worker's wait on the step's ring event); its
    end is when the step's tokens became host-visible.

Each step span carries the step's id (the frontend's dispatch count). On
CUDA a pair of timing events brackets each step's load and launch on the
engine's stream; the worker reads their interval after its sync into the
step's ``StepRecord`` (``device_ms``; None on the CPU). The start event
fires when the stream reaches it, so the interval includes any time the
card waited for the host inside the dispatch. ``RequestRecord``: a
request's stamps, kept when its stream closes.

Records past ``CAP`` (spans, steps and requests together) are dropped and
counted in ``dropped``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

CAP = 1 << 20                   # records kept; ~10 spans a step


class Span(NamedTuple):
    name: str
    thread: str                 # "loop" | "worker"
    t0: float
    t1: float
    step: int                   # the dispatched step's id
    parent: Optional[str]       # the enclosing span of the same step


class StepRecord(NamedTuple):
    step: int
    mixed: bool                 # carries prompt chunks
    device_ms: Optional[float]  # load to launch end on the card (CUDA)


class RequestRecord(NamedTuple):
    req_id: int
    reason: str                 # the request's FinishReason, by name
    submit_time: float          # the stamps of ``Request``; -1 if never
    admit_time: float
    last_chunk_time: float
    prefill_time: float         # the first token's emission
    finish_time: float


class StepRecorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.steps: List[StepRecord] = []
        self.requests: List[RequestRecord] = []
        self.dropped = 0
        self.step = -1                  # the step the loop is dispatching
        self._n = 0
        self._lock = threading.Lock()
        self._events: Dict[int, Tuple[object, object]] = {}   # ring slot

    def _keep(self, records: list, rec) -> None:
        with self._lock:
            if self._n >= CAP:
                self.dropped += 1
                return
            self._n += 1
            records.append(rec)

    def span(self, name: str, t0: float, parent: Optional[str] = None,
             thread: str = "loop", step: Optional[int] = None) -> float:
        """Keep the span [t0, now) of step ``step`` (by default the one
        the loop is dispatching); returns now."""
        t1 = time.perf_counter()
        self._keep(self.spans, Span(name, thread, t0, t1,
                                    self.step if step is None else step,
                                    parent))
        return t1

    # ------------------------------------------------- the step's card time --
    def device_start(self, slot: int) -> None:
        """Record the start event of ring slot ``slot``'s step on the
        current stream (CUDA only)."""
        import torch
        ev = self._events.get(slot)
        if ev is None:
            ev = self._events[slot] = (torch.cuda.Event(enable_timing=True),
                                       torch.cuda.Event(enable_timing=True))
        ev[0].record()

    def device_end(self, slot: int) -> None:
        self._events[slot][1].record()

    def synced(self, step: int, slot: int, mixed: bool, t0: float) -> None:
        """The worker's ``sync`` span of ``step`` from ``t0``, and the
        step's record with its card time, once its ring event completed
        (so the end event before it did too)."""
        self.span("sync", t0, thread="worker", step=step)
        ev = self._events.get(slot)
        ms = ev[0].elapsed_time(ev[1]) if ev is not None else None
        self._keep(self.steps, StepRecord(step, mixed, ms))

    def request(self, req) -> None:
        self._keep(self.requests, RequestRecord(
            req.req_id, req.finish_reason.name if req.finish_reason
            else "", req.submit_time, req.admit_time, req.last_chunk_time,
            req.prefill_time, req.finish_time))
