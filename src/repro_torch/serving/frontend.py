"""Async continuous-batching frontend of the port: an overlapped host/device
pipeline over the synchronous ``Engine``, the counterpart of the JAX
package's ``serving/frontend.py``.

The sync loop serializes HOST plan-building, DEVICE execution and HOST
token emission: every step waits for its tokens before the next plan is
built, so host and card take turns idling. This frontend overlaps them:

  * ``AsyncEngine.submit(prompt, ...)`` registers a request and returns a
    ``TokenStream``; ``stream()`` (or iterating it) yields generated token
    ids as they arrive. ``cancel(handle)`` releases the request's pool
    pages and lane on the loop's next turn, dropping any still-pipelined
    samples at emission.
  * The LOOP (driving thread) builds the plan for step N+1 and dispatches
    it while step N still runs on the card (pipeline depth
    ``PIPELINE_DEPTH`` = 2). It never waits on device results: sampling
    happens ON THE DEVICE inside the step (``Engine._async_step``) and each
    decode lane's input token is read from the device-resident
    ``lane_tok`` feed, so plan construction needs only host metadata (the
    scheduler's pool state advances at DISPATCH time, not emission time;
    ``Request.inflight`` tracks the gap).
  * Right after each dispatch the loop enqueues, on the engine's stream, a
    non-blocking copy of the step's tokens into a slot of a pinned host
    ring and records a CUDA event there. The EMIT worker (background
    thread) owns the only host sync: it waits on that event (which
    releases the interpreter lock), reads the slot and hands the host
    tokens back to the loop, which routes them to the per-request stream
    queues. The ring has ``depth + 1`` slots, so a slot is reused only by
    a step dispatched after the one that last used it was emitted.
  * ``warmup()`` builds one step runner for EVERY shape in the bucket
    lattice (a CUDA graph on the card; ``Engine.warmup``), so steady-state
    serving replays graphs: ``engine.aot_misses`` stays 0 and
    ``engine.trace_counts`` is frozen after warmup.
  * An engine with a mesh on one card (page-range shards, each a pool of
    its own, ``kernels.sharded``) runs its step bodies under the mesh's
    shard context, so each step's graph holds the per-shard writes, kernel
    launches and their merge, in order on the one stream (the decode
    kernels' arrival counters are shared across the shards' launches,
    which that order keeps safe), with no host sync. A mesh across several
    cards is refused: a graph is captured on one card.

Greedy outputs follow ``Engine.generate``'s: the device consumes its own
sampled tokens in dispatch order, and a lane's paged-pool step math does
not depend on the other lanes. But the schedule differs (a finish reaches
the host a step later, so a lane frees a step later and chunks land in
other steps), and on the card a GEMM's rounding depends on the shape it
multiplies, so a stream can part from the sync run's where its best two
logits nearly tie. The pipeline may overrun EOS by at most
``PIPELINE_DEPTH - 1`` steps; overrun tokens are dropped at emission.

Single process, two threads: the loop thread owns ALL scheduler, request
and cache mutation and every launch; the emit worker only waits for events
and reads the host ring.

Host-DRAM KV tier: its spills and prefetch uploads ride the SAME loop
thread and the same stream. ``schedule_step`` ticks the engine's prefetch
flights at the top of every turn and enqueues spill and upload copies
before the turn's step, so an upload dispatched on turn N runs before any
step of turn N+1 and the pipeline needs no host sync and no other
machinery (``Engine._spill_page``, ``_start_prefetch``). A fault drain
(``abort_all``) and ``close`` abandon the flights still in the air: their
staging pages return to the free list, their payloads to the host store.

Failure semantics: every stream terminates with a ``FinishReason``,
delivered AT the terminal event (never at an idle sweep):

  ====================  =================  ==================================
  terminal event        FinishReason       who observes it, and when
  ====================  =================  ==================================
  ran to completion     FINISHED           stream closes as the last token
                                           (EOS / max_new_tokens) emits
  unservable request    REJECTED           stream closes the scheduling turn
                                           that rejected it (on_terminal)
  client cancel()       CANCELLED          stream closes on the loop's next
                                           turn (pages freed immediately;
                                           in-flight samples dropped)
  deadline_s expired    TIMED_OUT          stream closes the scheduling turn
  while QUEUED                             the scheduler shed it
  submit() watermark    SHED               stream returned ALREADY CLOSED;
  (queue depth/tokens)                     the request never enters a queue
  > max_preemptions     PREEMPTION_LIMIT   stream closes the scheduling turn
  evictions                                the preemption bound tripped
  pipeline fault        ERROR              every live stream closes with the
  (step exception,                         exception on ``.error``; the
  emit-worker death,                       pool drains to zero pages; the
  stall watchdog)                          watchdog raises
                                           ``PipelineStallError`` from
                                           ``run_until_idle``
  ====================  =================  ==================================
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.sharded import cards
from repro_torch.serving.engine import Engine, StepBatch
from repro_torch.serving.request import FinishReason, Request, RequestState

PIPELINE_DEPTH = 2          # dispatched-but-not-emitted device steps
_END = object()             # TokenStream sentinel


class PipelineStallError(RuntimeError):
    """The watchdog found the pipeline wedged: steps in flight but no
    completion within ``watchdog_s`` (emit worker dead or device hung).
    Raised from the driving loop AFTER the fault drain, so every stream
    has already closed with ``FinishReason.ERROR``."""


@dataclass
class TokenStream:
    """Per-request output channel. ``get()`` blocks for the next token id;
    ``None`` STRICTLY means the stream closed: inspect ``finish_reason``
    (and ``error`` for ERROR) for why. A closed stream keeps returning
    ``None``; iteration yields tokens until the close."""
    req: Request
    _q: "queue.Queue[object]" = field(default_factory=queue.Queue)
    finish_reason: Optional[FinishReason] = None
    error: Optional[BaseException] = None

    @property
    def closed(self) -> bool:
        return self.finish_reason is not None

    def put(self, tok: int) -> None:
        self._q.put(tok)

    def close(self, reason: Optional[FinishReason] = None,
              error: Optional[BaseException] = None) -> None:
        """Terminate the stream (idempotent, first writer wins). The reason
        defaults to the request's own terminal status."""
        if self.finish_reason is not None:
            return
        self.finish_reason = (reason if reason is not None
                              else self.req.finish_reason)
        self.error = error if error is not None else self.req.error
        self._q.put(_END)

    def get(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next token id, or ``None`` once the stream closed. A ``timeout``
        elapsing raises ``TimeoutError`` (never ``queue.Empty``)."""
        try:
            tok = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no token within {timeout}s (request {self.req.req_id} "
                "still open)") from None
        if tok is _END:
            self._q.put(_END)       # stay closed for any later get()
            return None
        return tok      # type: ignore[return-value]

    def __iter__(self):
        while True:
            tok = self.get()
            if tok is None:
                return
            yield tok


class AsyncEngine:
    """Continuous-batching request frontend over a synchronous ``Engine``.

    ``submit()`` / ``stream()`` / ``cancel()`` may be called from any
    thread; the serving loop runs on the caller of ``run_until_idle``.

    Resilience knobs: ``max_queue_depth`` / ``max_queued_tokens`` are the
    load-shedding watermarks (``submit`` fast-rejects SHED past either);
    ``watchdog_s`` bounds how long the loop waits on an in-flight step
    before declaring the pipeline stalled (``PipelineStallError``)."""

    def __init__(self, engine: Engine, pipeline_depth: int = PIPELINE_DEPTH,
                 warmup: bool = True,
                 max_queue_depth: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 watchdog_s: float = 30.0):
        n = cards(engine._kernel_ctx)
        if n > 1:
            # a step is one CUDA graph, captured on one card's stream from
            # its private memory pool; the shards' launches and copies on
            # other cards are not captured into it
            raise ValueError(
                f"AsyncEngine captures each step in a CUDA graph on one "
                f"card; this engine's mesh puts its KV shards on {n} cards. "
                "Serve it with the sync Engine, or put the mesh on one card")
        self.engine = engine
        self.depth = max(1, int(pipeline_depth))
        self.max_queue_depth = max_queue_depth
        self.max_queued_tokens = max_queued_tokens
        self.watchdog_s = float(watchdog_s)
        self._submit_q: "queue.Queue[Tuple[Request, TokenStream]]" = \
            queue.Queue()
        # (step, ring slot, shape of its sampled tokens); None stops
        self._emit_q: "queue.Queue[Optional[Tuple[StepBatch, int, tuple]]]" \
            = queue.Queue()
        self._done_q: "queue.Queue[Tuple[StepBatch, object]]" = \
            queue.Queue()
        self._streams: Dict[int, TokenStream] = {}
        self._cancelled: set = set()           # req_ids pending release
        self._inflight_steps = 0
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._failed: Optional[BaseException] = None
        # load-shedding bookkeeping (under _id_lock): requests submitted
        # but not yet admitted to a lane, the watermarked queue
        self._awaiting: Dict[int, Request] = {}
        self._queued_tokens = 0
        # terminal decisions made INSIDE the scheduler (REJECTED /
        # TIMED_OUT / PREEMPTION_LIMIT) close the client's stream the
        # moment they happen; the callback runs on the loop thread
        engine.scheduler.on_terminal = self._close_stream
        # the host ring of sampled tokens: depth + 1 slots, each with the
        # event recorded after its device-to-host copy (CUDA); a slot holds
        # a step's tokens flat: num_lanes, or a packed step's R x pack_slots
        # (R <= num_lanes)
        cuda = engine.device.type == "cuda"
        ecfg = engine.ecfg
        width = ecfg.num_lanes * (ecfg.pack_slots if ecfg.pack_prefill
                                  else 1)
        self._ring = torch.zeros((self.depth + 1, width), dtype=torch.int32,
                                 pin_memory=cuda)
        self._events = ([torch.cuda.Event() for _ in range(self.depth + 1)]
                        if cuda else None)
        self._next_slot = 0
        self._emitter = threading.Thread(target=self._emit_worker,
                                         daemon=True)
        self._emitter.start()
        self.warmed_shapes = engine.warmup() if warmup else 0

    # ------------------------------------------------------------- client --
    def _over_watermark(self, n_tokens: int) -> bool:
        """Load-shed check (``_id_lock`` held): sweep requests that left
        the queue (admitted or terminal), then test the watermarks."""
        if self.max_queue_depth is None and self.max_queued_tokens is None:
            return False
        for rid, req in list(self._awaiting.items()):
            if req.admit_time >= 0 or req.is_terminal:
                del self._awaiting[rid]
                self._queued_tokens -= req.prompt_len
        if (self.max_queue_depth is not None
                and len(self._awaiting) >= self.max_queue_depth):
            return True
        return (self.max_queued_tokens is not None
                and self._queued_tokens + n_tokens > self.max_queued_tokens)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_token: Optional[int] = None,
               deadline_s: float = 0.0) -> TokenStream:
        """Register a request; returns its ``TokenStream``. Stamps the
        submission time (the TTFT anchor, so queue wait counts).
        ``deadline_s`` is the client's latency budget: the scheduler sheds
        the request (TIMED_OUT) if it is still queued when it expires.
        Past the queue watermarks the stream comes back ALREADY CLOSED
        with ``FinishReason.SHED``."""
        now = time.perf_counter()
        prompt = np.asarray(prompt, np.int32)
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
            req = Request(req_id=rid, prompt=prompt,
                          max_new_tokens=max_new_tokens,
                          eos_token=eos_token, arrival_time=now,
                          submit_time=now, deadline_s=deadline_s)
            stream = TokenStream(req)
            if self._failed is not None:
                req.state = RequestState.REJECTED
                req.finish(FinishReason.ERROR, self._failed)
            elif self._over_watermark(req.prompt_len):
                req.state = RequestState.REJECTED
                req.finish(FinishReason.SHED)
                self.engine.stats.shed += 1
            elif (self.max_queue_depth is not None
                    or self.max_queued_tokens is not None):
                # only tracked under active watermarks (the sweep that
                # retires entries lives in the watermark check)
                self._awaiting[rid] = req
                self._queued_tokens += req.prompt_len
        if req.is_terminal:
            stream.close()
            return stream
        self._submit_q.put((req, stream))
        return stream

    def stream(self, handle: TokenStream):
        """Yield the request's generated token ids until completion."""
        return iter(handle)

    def cancel(self, handle: TokenStream) -> None:
        """Abandon a request: the loop releases its pool pages and lane on
        its next turn; still-pipelined samples are dropped at emission and
        the stream closes (``FinishReason.CANCELLED``). Cancelling an
        already-terminated stream is a no-op."""
        if handle.closed or handle.req.is_terminal:
            return
        self._cancelled.add(handle.req.req_id)

    # --------------------------------------------------------- emit worker --
    def _emit_worker(self) -> None:
        """The ONLY host sync: drain dispatched steps in device order, wait
        for each step's ring slot (its CUDA event) and copy its tokens out,
        off the loop's critical path. A fault is POSTED to the loop (which
        fails the pipeline and routes ERROR to every stream), never
        swallowed; a killed worker dies silently and the stall watchdog
        detects it."""
        while True:
            item = self._emit_q.get()
            if item is None:
                return
            sb, slot, shape = item
            try:
                faults = self.engine.faults
                if faults is not None:
                    faults.on_emit()
                if self._events is not None:
                    self._events[slot].synchronize()
                n = int(np.prod(shape))
                self._done_q.put((sb, self._ring[slot, :n].numpy()
                                  .reshape(shape).copy()))
            except WorkerKilled:
                return                  # silent death: the watchdog fires
            except Exception as exc:
                self._done_q.put((sb, exc))

    # ---------------------------------------------------------------- loop --
    def _drain_submissions(self) -> None:
        while True:
            try:
                req, stream = self._submit_q.get_nowait()
            except queue.Empty:
                return
            self._streams[req.req_id] = stream
            if self._failed is not None:
                # raced a pipeline fault: never reached the scheduler
                if req.finish(FinishReason.ERROR, self._failed):
                    self.engine.stats.errors += 1
                self._close_stream(req)
                continue
            self.engine.add_request(req)

    def _drain_done(self, block: bool) -> bool:
        """Apply one completed step's host tokens: decrement in-flight
        counters, drop post-EOS / terminal samples, route the rest to
        their streams, retire finished requests. A blocking wait is
        bounded by ``watchdog_s``; its expiry means the pipeline is wedged
        (dead emit worker / hung device) and fails loudly."""
        try:
            if block:
                sb, toks = self._done_q.get(timeout=self.watchdog_s)
            else:
                sb, toks = self._done_q.get(block=False)
        except queue.Empty:
            if not block:
                return False
            self._stall()               # drains + raises PipelineStallError
        self._inflight_steps -= 1
        if isinstance(toks, BaseException):
            self._fail(toks)            # emit-worker fault, posted in-band
            return True
        eng = self.engine
        now = time.perf_counter()
        finished: List[Request] = []
        for req, first, idx in sb.samples:
            emitted = eng._emit(req, int(toks[idx]), now, first=first)
            stream = self._streams.get(req.req_id)
            if emitted and stream is not None:
                stream.put(int(toks[idx]))
            finished.append(req)
        eng._finish_done(finished)
        for req in finished:
            if req.state is RequestState.FINISHED:
                self._close_stream(req)
        eng._update_pool_stats()
        return True

    def _close_stream(self, req: Request) -> None:
        """Close (idempotently) the client's stream with the request's own
        terminal status. Also the scheduler's ``on_terminal`` callback, so
        REJECTED / TIMED_OUT / PREEMPTION_LIMIT close at decision time."""
        stream = self._streams.pop(req.req_id, None)
        if stream is not None:
            stream.close()
        self._cancelled.discard(req.req_id)

    def _apply_cancels(self) -> None:
        """Release cancelled requests IMMEDIATELY: pool pages and lane
        back to the free lists, stream closed. Already-dispatched steps
        that still reference the freed pages are safe: the card runs steps
        in dispatch order, so any reuse of those pages happens in a LATER
        step; their sampled tokens are dropped at emission."""
        if not self._cancelled:
            return
        sched = self.engine.scheduler
        for req in (list(sched.running.values()) + list(sched.waiting)):
            if req.req_id in self._cancelled:
                sched.release(req)
                self._close_stream(req)
        # ids whose streams already closed (raced another terminal event)
        self._cancelled.intersection_update(self._streams)

    def _dispatch_one(self) -> bool:
        """Build + dispatch ONE device step without waiting for results."""
        eng = self.engine
        plan = eng.scheduler.schedule_step()
        if plan.empty:
            return False
        slot = self._next_slot
        if self._events is not None and not self._events[slot].query():
            raise RuntimeError(f"host ring slot {slot} reused before its "
                               "copy completed")
        sb = eng._build_step(plan, device_feed=True)
        toks = eng._dispatch_async(sb, slot)
        self._ring[slot, :toks.numel()].copy_(toks.reshape(-1),
                                              non_blocking=True)
        if self._events is not None:
            self._events[slot].record()
        self._next_slot = (slot + 1) % len(self._ring)
        # host metadata advances at DISPATCH time so the next plan can be
        # built immediately; emission-side effects wait for the tokens
        eng._note_executed(sb)
        for req, _, _ in sb.samples:
            req.inflight += 1
        self._inflight_steps += 1
        self._emit_q.put((sb, slot, tuple(toks.shape)))
        return True

    # ------------------------------------------------------- fault drain --
    def _fail(self, exc: BaseException) -> None:
        """Terminal fault path: drain the WHOLE pipeline as ERROR. Every
        live request (running, queued, still in the submit queue) is
        released (the pool returns to zero pages in use) and every open
        stream closes carrying ``exc``. First fault wins; later submits
        come back already closed."""
        if self._failed is not None:
            return
        self._failed = exc
        # requests still in the frontend's submit queue never reached the
        # scheduler: register their streams so they close with ERROR too
        while True:
            try:
                req, stream = self._submit_q.get_nowait()
            except queue.Empty:
                break
            self._streams[req.req_id] = stream
            if req.finish(FinishReason.ERROR, exc):
                self.engine.stats.errors += 1
        self.engine.abort_all(exc)
        for stream in list(self._streams.values()):
            stream.req.finish(FinishReason.ERROR, exc)   # first-writer-wins
            self._close_stream(stream.req)
        self._cancelled.clear()
        self._inflight_steps = 0

    def _stall(self) -> None:
        """Watchdog trip: no step completed within ``watchdog_s`` while
        steps were in flight. Fail the pipeline (streams close ERROR, pool
        drains) and raise: a wedged pipeline must be loud, not a hang."""
        dead = not self._emitter.is_alive()
        exc = PipelineStallError(
            f"pipeline stalled: {self._inflight_steps} step(s) in flight "
            f"but none completed within watchdog_s={self.watchdog_s}s"
            + ("; the emit worker is DEAD" if dead else ""))
        self._fail(exc)
        raise exc

    def _loop_once(self) -> bool:
        """One scheduling turn. Returns True if anything happened."""
        faults = self.engine.faults
        if faults is not None:
            faults.on_turn(self)
        self._drain_submissions()
        progressed = False
        while self._drain_done(block=False):
            progressed = True
        if self._failed is not None:
            return True
        self._apply_cancels()
        if self._inflight_steps < self.depth:
            try:
                if self._dispatch_one():
                    return True
            except Exception as exc:
                # a dispatched-step fault must not strand the pipeline:
                # drain everything as ERROR (streams carry the exception)
                self._fail(exc)
                return True
        if not progressed and self._inflight_steps:
            # pipeline full (or nothing plannable): block for the oldest
            # dispatched step instead of spinning
            progressed = self._drain_done(block=True)
        return progressed

    @property
    def _has_work(self) -> bool:
        return (self.engine.scheduler.has_work or self._inflight_steps > 0
                or not self._submit_q.empty())

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Drive the pipeline until every submitted request terminated
        (finished, rejected, cancelled, shed, timed out, or errored).
        Raises ``PipelineStallError`` if the watchdog trips, after the
        fault drain, so no stream is left open either way."""
        steps = 0
        while steps < max_steps:
            self._drain_submissions()
            if self._failed is not None or not self._has_work:
                break
            self._loop_once()
            steps += 1
        # safety net: every terminal request's stream must be closed by
        # now (terminal events close them in-line); sweep any straggler
        for stream in list(self._streams.values()):
            if stream.req.is_terminal:
                self._close_stream(stream.req)

    def close(self) -> None:
        """Stop the emit worker (it exits after the steps queued before) and
        abandon the host tier's prefetch flights still in the air."""
        self._emit_q.put(None)
        self._emitter.join(timeout=5.0)
        self.engine._abort_prefetch_flights()


class WorkerKilled(BaseException):
    """Fault-injection signal: kill the emit worker SILENTLY (thread exits,
    nothing posted) so the stall watchdog, not error propagation, has to
    detect the loss. Derives from BaseException so ``except Exception``
    cleanup can never absorb it."""
