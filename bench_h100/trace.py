"""The traced slice of a run: ``torch.profiler``'s CUDA activity over a few
seconds of the window, read back into the card's activities.

The slice's edges are marked on the serving loop's thread just before a
step dispatch, each after a ``torch.cuda.synchronize``, so the slice holds
exactly the kernels of the steps dispatched inside it; the profiler itself
is driven from the main thread (``Tracer``). A marker kernel launched right
after the start ties the trace's clock to the host's.

``busy_us`` and the kernel name patterns are copies of ``chip_smoke.py``
(``_busy_us`` l. 1584, ``TRACE_KERNELS`` l. 1526, ``_trace_launches``'s
pattern l. 1599).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel

# attention kernels by family, by their CUDA function names
DECODE_KERNELS = ("decode_kernel", "latent_decode_kernel")      # K2/K4, K5/K7
PREFILL_KERNELS = ("chunk_kernel", "latent_chunk_kernel")       # K3, K6


def name_pattern(name: str):
    return re.compile(rf"(?<![A-Za-z_]){name}(?![a-z0-9_])")


def busy_us(acts) -> float:
    """The union of the activities' intervals, us: the card's busy time."""
    busy, end = 0.0, float("-inf")
    for s, e, *_ in acts:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def kernel_us(acts, names) -> float:
    """Summed device time of the kernels whose names match one of
    ``names`` (whole-word, as ``chip_smoke._trace_launches``)."""
    pats = [name_pattern(n) for n in names]
    return sum(e - s for s, e, c, n in acts
               if c == "kernel" and any(p.search(n) for p in pats))


def idle_gaps(acts, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The card's idle intervals inside [t0, t1] (us)."""
    gaps, end = [], t0
    for s, e, *_ in acts:
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return [(a, b) for a, b in gaps if b > a]


def top_ops(acts, n: int = 10) -> list:
    tot: Dict[str, float] = defaultdict(float)
    for s, e, c, name in acts:
        tot[name[:160]] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def label_gaps(gaps, spans, n: int = 10) -> list:
    """The ``n`` longest idle gaps, each named by the host span that covers
    most of it ("host_idle" where none does). ``spans``: (name, start us,
    end us) on the trace's clock."""
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        cover: Dict[str, float] = defaultdict(float)
        for name, s, e in spans:
            ov = min(b, e) - max(a, s)
            if ov > 0:
                cover[name] += ov
        label = max(cover, key=cover.get) if cover else "host_idle"
        out.append([label, (b - a) / 1e6])
    return out


class Tracer:
    """Profiles [start, stop) of one run's window; see the module doc.

    Every call into the profiler is made on the main thread while the
    serving loop waits (``serve`` answers the loop's two requests), so no
    profiler call overlaps a step's launch and CUPTI's start-up (seconds)
    falls in a pause that the open loop's schedule is moved past: at its first dispatch after ``t_start`` the loop
    synchronizes, calls ``on_pause``, asks for a trace to be prepared and
    started, waits, calls ``on_resume`` with the seconds it waited, marks
    ``host0`` and launches the marker; at its first dispatch after
    ``t_stop`` it synchronizes, marks ``host1``, asks for the trace to
    stop and waits. ``t_stop`` is set ``length`` seconds after
    ``host0``."""

    def __init__(self, torch, length: float, on_pause=None, on_resume=None):
        self.torch = torch
        self.length = length            # the slice's seconds, from host0
        self.t_start = self.t_stop = float("inf")
        self.on_pause, self.on_resume = on_pause, on_resume
        self.state = "pending"          # -> running -> done (loop thread)
        self.lock = threading.Lock()
        self.asked = {k: threading.Event() for k in ("start", "stop")}
        self.done = {k: threading.Event() for k in ("start", "stop")}
        self.prof = None
        self.paused_at = self.host0 = self.host1 = 0.0
        self.times = {}                 # seconds of each profiler call
        self.acts: List[tuple] = []
        self.offset_us = 0.0

    # ------------------------------------------------------- main thread --
    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def _timed(self, name, fn) -> None:
        t = time.perf_counter()
        fn()
        self.times[name] = time.perf_counter() - t

    def _begin(self) -> None:
        self.prof = self._profile()
        self._timed("prepare_s", self.prof.prepare_trace)
        self._timed("start_s", self.prof.start_trace)

    def _end(self) -> None:
        self._timed("stop_s", self.prof.stop_trace)

    def serve(self, deadline: float) -> None:
        """Start and stop the trace when the loop asks; past ``deadline``
        (the loop dispatched nothing) do it here."""
        for what, call in (("start", self._begin), ("stop", self._end)):
            self.asked[what].wait(max(deadline - time.perf_counter(), 0.0))
            if not self.asked[what].is_set():
                if what == "start":
                    self.mark_start()
                else:
                    self.mark_stop()
            call()
            self.done[what].set()

    # ------------------------------------------------------- loop thread --
    def before_dispatch(self) -> None:
        now = time.perf_counter()
        if self.state == "pending" and now >= self.t_start:
            self.mark_start(wait=True)
        elif self.state == "running" and now >= self.t_stop:
            self.mark_stop(wait=True)

    def mark_start(self, wait: bool = False) -> None:
        with self.lock:
            if self.state != "pending":
                return
            self.torch.cuda.synchronize()
            self.paused_at = time.perf_counter()
            if self.on_pause is not None:
                self.on_pause()
            self.asked["start"].set()
            if wait:
                self.done["start"].wait(120.0)
            self.host0 = time.perf_counter()
            self.t_stop = self.host0 + self.length
            if self.on_resume is not None:
                self.on_resume(self.host0 - self.paused_at)
            self.torch.cuda._sleep(100)
            self.state = "running"

    def mark_stop(self, wait: bool = False) -> None:
        with self.lock:
            if self.state != "running":
                return
            self.torch.cuda.synchronize()
            self.host1 = time.perf_counter()
            self.state = "done"
            self.asked["stop"].set()
            if wait:
                self.done["stop"].wait(120.0)
            if self.on_resume is not None:
                self.on_resume(time.perf_counter() - self.host1)

    def read(self) -> None:
        """Export and parse the trace (a temporary file, removed once
        read): the card's activities as (start us, end us, category, name)
        on the trace's clock, sorted, the marker taken out; and the offset
        that maps the host clock onto it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        acts, marks = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            if cat not in DEVICE_ACTIVITIES:
                continue
            s = float(e["ts"])
            row = (s, s + float(e["dur"]), cat, str(e["name"]))
            (marks if MARKER in row[3] else acts).append(row)
        self.prof = None
        if not marks:
            raise RuntimeError("the trace holds no marker kernel: the "
                               "profiler recorded no CUDA activity")
        m0 = min(m[0] for m in marks)
        self.offset_us = m0 - self.host0 * 1e6
        end = self.us(self.host1)
        self.acts = sorted(a for a in acts if m0 <= a[0] < end)

    # the trace's clock for a host time
    def us(self, t: float) -> float:
        return t * 1e6 + self.offset_us

    @property
    def window_s(self) -> float:
        return self.host1 - self.host0

    def busy_s(self) -> float:
        return busy_us(self.acts) / 1e6

    def breakdown(self, spans) -> dict:
        t0, t1 = self.us(self.host0), self.us(self.host1)
        host = [(n, self.us(a), self.us(b)) for n, a, b in spans
                if b >= self.host0 and a <= self.host1]
        return {"device_ops": top_ops(self.acts),
                "idle_gaps": label_gaps(idle_gaps(self.acts, t0, t1), host)}
