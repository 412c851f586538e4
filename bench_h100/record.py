"""What the benchmark records of a run, from its own wrappers around the
program's calls that build and dispatch a step (nothing in the program
changes):

  * each step's host batch, as a ``StepRecord``, when the frontend builds it
    (``Engine._build_step``);
  * each prompt chunk as the scheduler planned it (request, start, length,
    the longest chunk of its step), from which the oracle works out the
    MoE rows (the program's expert capacity is per row) and checks that
    the chunks cover each prompt once;
  * with spans on (the traced run), the host's spans: each step dispatch
    (``AsyncEngine._dispatch_one``), each blocking wait on the emit worker
    (``AsyncEngine._drain_done(block=True)``) and each client submit.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class StepRecord:
    t: float                    # host clock when the step was built
    kind: str                   # "decode" | "prefill" | "packed"
    rows: int                   # query rows of the step (padded included)
    padded: int                 # rows that write no slot (slot_idx == -1)
    decode: int                 # decode lanes
    chunks: int                 # prompt chunks
    sampled: int                # rows whose sampled token is used
    q_pos: Optional[np.ndarray] = None     # real query tokens' positions
    tables: Optional[np.ndarray] = None    # (n, NP) lanes' page tables
    lens: Optional[np.ndarray] = None      # (n,) keys each lane sees


@dataclass
class Recorder:
    """Host records of one run. ``detail`` keeps each step's positions and
    page tables (the traced run's kernel and step arithmetic)."""
    detail: bool = False
    steps: List[StepRecord] = field(default_factory=list)
    layouts: Dict[int, List[Tuple[int, int, int]]] = field(
        default_factory=dict)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def on_step(self, sb) -> None:
        t = time.perf_counter()
        b = sb.batch
        if "dmeta" in b:
            pos, slots, lens = b["dmeta"]
            real = slots >= 0
            rows, padded = slots.size, int((~real).sum())
            q_pos, lanes = pos[real], real
            tables = b["page_table"][lanes]
            lens = lens[lanes]
        else:
            slots = b["slot_idx"]
            real = slots >= 0
            rows, padded = slots.shape[0] * slots.shape[1], int((~real).sum())
            q_pos = b["positions"][real]
            lanes = real.any(axis=1)
            tables = b["page_table"][lanes]
            lens = b["cache_len"][lanes]
        longest = max((int(c.n) for c in sb.plan.prefill), default=0)
        for c in sb.plan.prefill:
            self.layouts.setdefault(c.req.req_id, []).append(
                (int(c.start), int(c.n), longest))
        rec = StepRecord(t, sb.kind, rows, padded, len(sb.plan.decode),
                         len(sb.plan.prefill), len(sb.samples))
        if self.detail:
            rec.q_pos, rec.tables, rec.lens = (q_pos.copy(), tables.copy(),
                                               lens.copy())
        self.steps.append(rec)

    def span(self, name: str, t0: float, t1: float) -> None:
        with self.lock:
            self.spans.append((name, t0, t1))


def install(ae, rec: Recorder, before_dispatch: Optional[Callable] = None
            ) -> None:
    """Wrap the frontend's step build and, with ``rec.detail``, its
    dispatch and blocking drain, as instance attributes of this engine."""
    eng = ae.engine
    build = eng._build_step

    def _build_step(plan, device_feed=False):
        sb = build(plan, device_feed)
        rec.on_step(sb)
        return sb
    eng._build_step = _build_step
    if not rec.detail:
        return
    dispatch, drain = ae._dispatch_one, ae._drain_done

    def _dispatch_one():
        if before_dispatch is not None:
            before_dispatch()
        t0 = time.perf_counter()
        ok = dispatch()
        if ok:
            rec.span("dispatch", t0, time.perf_counter())
        return ok

    def _drain_done(block):
        t0 = time.perf_counter()
        out = drain(block)
        if block:
            rec.span("emit_wait", t0, time.perf_counter())
        return out
    ae._dispatch_one = _dispatch_one
    ae._drain_done = _drain_done
