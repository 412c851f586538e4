"""Inference request lifecycle (vLLM-style); a verbatim port of the JAX
package's ``serving/request.py``.

States: WAITING -> RUNNING -> FINISHED, plus
  REJECTED  — can never be served (prompt + generation budget exceeds the
              per-request cap). Surfaced by ``Engine.generate`` instead of
              silently returning an empty output. (The old "no prefill
              bucket for a non-chunkable family" rejection is gone: every
              family is served via chunked continuation prefill.)
  PREEMPTED — evicted mid-flight by the token-budget scheduler to relieve
              pool pressure (OutOfBlocks); its non-shared pages were freed
              and it waits at the FRONT of the queue. On re-admission the
              effective prompt is ``prompt + output`` (everything generated
              so far is re-prefilled — possibly straight from the prefix
              cache), so greedy decoding resumes token-for-token.
  CANCELLED — the client gave up (``AsyncEngine.cancel``): pool pages are
              released, the lane freed, and any still-in-flight sampled
              tokens are dropped at emission.

Latency anchors: ``submit_time`` is stamped when the CLIENT hands the
request over (Engine.generate / AsyncEngine.submit — the TTFT anchor, so
queue wait counts); ``enqueue_time`` when the scheduler queue receives it;
``admit_time`` at first lane admission (queue_wait = admit - submit);
``last_chunk_time`` at the dispatch of the step that carries the final
prompt chunk (prefill = last_chunk - admit); ``prefill_time`` at
first-token emission. The last three are stamped once and kept across
preemptions.

Terminal status: every request ends with a ``FinishReason`` — the
STRUCTURED terminal status clients observe (``TokenStream.finish_reason``
after the stream closes, or ``Request.finish_reason`` from
``Engine.generate(return_requests=True)``). It is set exactly once, at the
moment the terminal event happens (``Request.finish``), never at an
idle-sweep. ``RequestState`` stays the engine-internal lifecycle;
``FinishReason`` is the client-facing WHY.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"
    PREEMPTED = "preempted"
    CANCELLED = "cancelled"


class FinishReason(enum.Enum):
    """Why a request's stream terminated (set once, at the terminal event).

    FINISHED          — ran to completion (EOS or ``max_new_tokens``).
    REJECTED          — can never be served (prompt + generation budget over
                        the per-request cap); surfaced at admission time.
    CANCELLED         — the client gave up (``AsyncEngine.cancel``).
    TIMED_OUT         — ``deadline_s`` expired while the request was still
                        QUEUED; the scheduler shed it instead of serving
                        work nobody is waiting for.
    SHED              — fast-rejected at ``AsyncEngine.submit`` because the
                        queue was past its depth/token watermark (overload
                        degrades to bounded queueing, not unbounded
                        latency).
    PREEMPTION_LIMIT  — preempted more than ``max_preemptions`` times; the
                        pool is thrashing and this request will never make
                        progress, so it is rejected instead of livelocking.
    ERROR             — a pipeline fault (emit-worker death, step
                        exception, stall watchdog) terminated it; the
                        exception rides on ``Request.error`` / the stream.
    """
    FINISHED = "finished"
    REJECTED = "rejected"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    SHED = "shed"
    PREEMPTION_LIMIT = "preemption_limit"
    ERROR = "error"


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                       # (prompt_len,) int32 token ids
    max_new_tokens: int = 64
    eos_token: Optional[int] = None
    arrival_time: float = 0.0
    deadline_s: float = 0.0                  # client latency budget from
                                             # submission (0 = none); the
                                             # scheduler sheds QUEUED work
                                             # whose deadline passed
                                             # (TIMED_OUT)

    # runtime state
    state: RequestState = RequestState.WAITING
    lane: int = -1                           # engine batch lane
    output: List[int] = field(default_factory=list)
    num_computed: int = 0                    # prompt tokens with KV in cache
    prefill_target: int = 0                  # prompt tokens to compute (set
                                             # at admission; fixed until
                                             # preemption re-admits)
    num_preemptions: int = 0
    pool_id: int = -1                        # BlockManager key (engine-unique,
                                             # reassigned on re-admission)
    shard: int = -1                          # KV-pool shard the request is
                                             # pinned to (placement hint at
                                             # admission; all its pages stay
                                             # in that shard's page range)
    prefix_hash: int = 0                     # running chain hash after
    prefix_hash_pages: int = 0               # ..this many pages (engine's
                                             # incremental snapshot keying,
                                             # recurrent families)
    enqueue_time: float = -1.0               # perf_counter at add_request
    submit_time: float = -1.0                # perf_counter at client submit
                                             # (TTFT / queue-wait anchor;
                                             # falls back to enqueue_time)
    admit_time: float = -1.0                 # first lane admission
    last_chunk_time: float = -1.0            # final prompt chunk dispatched
    prefill_time: float = -1.0               # first-token timestamp (kept
                                             # across preemptions)
    finish_time: float = -1.0
    inflight: int = 0                        # tokens sampled on device but
                                             # not yet host-emitted (async
                                             # pipeline; 0 in the sync loop)
    prefetch_keys: List[int] = field(default_factory=list)
                                             # chain hashes whose host->HBM
                                             # prefetch gates admission: the
                                             # request holds the queue head
                                             # while any is IN_FLIGHT
    prefetch_shard: int = -1                 # shard the prefetch landed the
                                             # prefix on (placement hint)
    prefetch_replans: int = 0                # landed pages stolen before
                                             # admission -> fetch re-planned
                                             # (bounded; then admit as miss)
    finish_reason: Optional[FinishReason] = None   # structured terminal
                                             # status, set ONCE via finish()
    error: Optional[BaseException] = None    # the fault behind ERROR

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def num_generated(self) -> int:
        return len(self.output)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.num_generated

    def effective_prompt(self) -> np.ndarray:
        """What prefill must (re)compute: the prompt plus everything already
        generated — identical greedy continuation after preemption."""
        if not self.output:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.output, np.int32)])

    def done(self) -> bool:
        if self.num_generated >= self.max_new_tokens:
            return True
        return (self.eos_token is not None and self.output
                and self.output[-1] == self.eos_token)

    @property
    def deadline(self) -> Optional[float]:
        """Absolute ``perf_counter`` deadline, anchored at submission (else
        scheduler-queue arrival); None when the request carries none."""
        if self.deadline_s <= 0:
            return None
        t0 = self.submit_time if self.submit_time >= 0 else self.enqueue_time
        return t0 + self.deadline_s if t0 >= 0 else None

    @property
    def is_terminal(self) -> bool:
        return self.finish_reason is not None

    def finish(self, reason: FinishReason,
               error: Optional[BaseException] = None) -> bool:
        """Record the terminal status. First writer wins — a request that
        already terminated (e.g. cancelled while its rejection was in
        flight) keeps its original reason. Returns True if this call set
        it."""
        if self.finish_reason is not None:
            return False
        self.finish_reason = reason
        self.error = error
        return True
