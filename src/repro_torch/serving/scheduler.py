"""Token-budget continuous-batching scheduler over ONE shared paged-KV pool,
split into page-range shards — ONE step-composition path for every model
family. A port of the JAX package's ``serving/scheduler.py``, kept close to
verbatim so both schedulers compose the same steps from the same requests
and place them on the same shards, with its concat-prefill row packing
(``pack_rows``).

The pool's page range is partitioned into ``CacheConfig.num_shards``
contiguous ranges (the ``(pod, data)`` extent of a ``launch.mesh`` mesh);
each request is pinned to one shard at admission, so its page table never
leaves that range.

The engine exposes ``num_lanes`` batch lanes, but — unlike the old
JetStream-style static partition — lanes do NOT own private page pools: all
lanes draw pages from a single refcounted ``BlockManager`` (prefix-cached,
LRU-evicted), so memory follows actual sequence lengths instead of reserving
``max_len`` per lane (the paper §2 allocator-fragmentation bottleneck).

Each engine step is composed under a TOKEN BUDGET (Sarathi-style):

  * every running, prefill-complete request contributes one decode token;
  * the remaining budget is filled with prefill work — continuation chunks
    of partially-prefilled prompts first, then new admissions (possibly
    only the first chunk of a long prompt). EVERY family takes this path:
    the engine executes decode tokens and prefill chunks in ONE device call
    through the chunked-continuation prefill (a decode lane is a chunk of
    length 1). The legacy monolithic bucketed-prefill tier — and its
    "no bucket -> REJECT" admission rule — is gone.
  * recurrent-state families (griffin/rwkv6) get PAGE-ALIGNED chunk
    boundaries so the engine can snapshot the recurrent state at committed
    page boundaries (the prefix cache's resume points for those families);
  * admission is SHARD-AFFINE: a prompt whose chain-hash head is registered
    on shard s is placed on s (prefix-affinity — CoW reuse is only possible
    shard-locally); otherwise the least-loaded shard wins. If the preferred
    shard lacks capacity the request falls back to another shard and the
    lost reuse is counted as a ``placement_miss``.
  * prefix-cache hits shrink a new request's prefill to the uncached tail
    (full shared pages are reused copy-on-write, never recomputed);
  * ``OutOfBlocks`` is per-shard: the YOUNGEST running request ON THE
    PRESSURED SHARD is preempted — its non-shared pages freed, its
    registered pages parked in the prefix cache, and the request requeued
    at the front with ``effective_prompt = prompt + output`` so greedy
    decoding resumes token-for-token instead of the engine crashing;
  * requests that can NEVER be served (prompt + generation budget over the
    per-request cap — ``max_len`` or the largest shard's page range) are
    marked ``REJECTED`` and surfaced, not silently dropped.

Resilience rules (every terminal decision carries a ``FinishReason`` and
fires ``on_terminal`` at the moment it happens, so frontends can close the
client's stream immediately instead of at idle-sweep time):

  * **deadline shedding** — a QUEUED request whose ``deadline_s`` expired
    is shed (``TIMED_OUT``) at the top of every scheduling turn; the
    engine never spends a device step on work nobody is waiting for.
    Running requests are never killed mid-flight — the deadline is an
    admission contract, not an execution interrupt.
  * **bounded preemption** — a request preempted more than
    ``max_preemptions`` times is rejected (``PREEMPTION_LIMIT``) instead
    of ping-ponging through the pool forever: unbounded preemption under
    sustained pressure is a livelock, not a policy.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.cache.block_manager import (BlockManager, OutOfBlocks,
                                             PageResidency, PrefixMatch,
                                             padded_pool_pages)
from repro_torch.configs.base import CacheConfig
from repro_torch.serving.request import FinishReason, Request, RequestState


def bucket_len(n: int, buckets: List[int]) -> Optional[int]:
    """Smallest bucket holding ``n`` tokens — used to PAD the step's chunk
    axis (bounding recompilation), never to admit or reject."""
    for b in buckets:
        if n <= b:
            return b
    return None


@dataclass
class PrefillChunk:
    req: Request
    start: int                 # logical position of the chunk's first token
    tokens: np.ndarray         # (<= n,) TEXT token ids fed this step (vlm:
                               # positions inside the patch stub carry none)
    final: bool                # completes the prompt -> sample first token
    first: bool = False        # the request's first chunk since (re)admission
                               # (engine: reset/restore recurrent state, fill
                               # whisper cross-KV)
    count: int = -1            # logical POSITIONS covered by the chunk

    @property
    def n(self) -> int:
        return self.count if self.count >= 0 else int(len(self.tokens))


@dataclass
class DecodeItem:
    req: Request
    pos: int                   # logical position of the fed token
    slot: int                  # global flat slot receiving its KV


@dataclass
class StepPlan:
    prefill: List[PrefillChunk] = field(default_factory=list)
    decode: List[DecodeItem] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode


class Scheduler:
    def __init__(self, num_lanes: int, max_len: int, page_size: int,
                 prefill_buckets: List[int], extra_tokens: int = 0,
                 token_budget: Optional[int] = None,
                 page_aligned: bool = False,
                 max_preemptions: int = 32,
                 cache_cfg: CacheConfig = CacheConfig()):
        self.num_lanes = num_lanes
        self.max_len = max_len                 # per-REQUEST cap, not per-lane
        self.page_size = cache_cfg.page_size or page_size
        self.prefill_buckets = sorted(prefill_buckets)
        self.extra_tokens = extra_tokens       # modality-stub prefix (vlm)
        self.token_budget = token_budget or max(self.prefill_buckets)
        self.num_shards = max(int(cache_cfg.num_shards), 1)
        self.page_aligned = page_aligned       # recurrent-state families:
                                               # chunk ends land on page
                                               # boundaries (state snapshots)
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}            # lane -> request
        self.free_lanes: List[int] = list(range(num_lanes - 1, -1, -1))
        self.pages_per_lane = \
            (max_len + self.page_size - 1) // self.page_size
        # ONE pool for all lanes, its page range padded so it splits evenly
        # into the shards; the final device page is never allocated (its
        # last line is the JAX write kernel's SkipSet sentinel, and both
        # packages hand out the same pages), so the LAST shard owns one page
        # less
        self.cache_cfg = cache_cfg.resolve(
            page_size=self.page_size,
            num_pages=num_lanes * self.pages_per_lane)
        p_dev = padded_pool_pages(self.cache_cfg.num_pages, self.num_shards)
        total = max(p_dev - 1, 1)
        self.manager = BlockManager(
            cfg=self.cache_cfg.replace(num_pages=total))
        # ----------------------------------------------- prefetch hooks ----
        # engine-provided: prefetch_tick() runs at the top of every turn
        # (commits/aborts flights whose upload is now ordered ahead of any
        # future step); prefetcher(req, match) dispatches host->HBM uploads
        # for a queued request's matched non-DEVICE pages and returns the
        # chain hashes to gate admission on.
        self.prefetch_tick: Optional[Callable[[], None]] = None
        self.prefetcher: Optional[
            Callable[[Request, PrefixMatch], List[int]]] = None
        self.prefetch_depth = self.cache_cfg.prefetch_depth
        self.prefetches_planned = 0
        self.prefetch_held_turns = 0   # admission turns spent waiting on an
                                       # IN_FLIGHT prefix (overlapped with
                                       # the in-flight step, not idle)
        self.prefetch_replans = 0      # landed prefixes stolen pre-admission
                                       # and fetched again
        self.max_prefetch_replans = 3  # per request; then admit as a miss
        self.preemptions = 0
        self.preemptions_by_shard = [0] * self.num_shards
        self.placement_prefix_hits = 0   # admitted on the prefix-affine shard
        self.placement_misses = 0        # prefix lived on a shard we could
                                         # not use -> cross-shard reuse lost
        self.rejected: List[Request] = []
        self.max_preemptions = max(int(max_preemptions), 0)
        self.deadline_shed = 0           # queued requests shed TIMED_OUT
        self.preemption_limit_rejects = 0
        # fired the MOMENT a request terminates without ever reaching the
        # step path (REJECTED / TIMED_OUT / PREEMPTION_LIMIT), so the async
        # frontend can close the client's stream immediately — a client
        # blocked on stream.get() must not wait for the pipeline to idle
        self.on_terminal: Optional[Callable[[Request], None]] = None
        self._next_pool_id = 0             # engine-unique allocator keys
                                           # (req_ids may collide across
                                           # streams; the pool must not)

    # -------------------------------------------------------------- admit --
    def add_request(self, req: Request) -> None:
        self.waiting.append(req)

    def _target(self, req: Request) -> int:
        """Prompt-side tokens that must be in the cache before decoding
        (frozen at admission — generated tokens arrive via decode slots,
        not prefill chunks)."""
        return req.prefill_target

    def _reject(self, req: Request,
                reason: FinishReason = FinishReason.REJECTED) -> None:
        req.state = RequestState.REJECTED
        req.finish(reason)
        self.rejected.append(req)
        if self.on_terminal is not None:
            self.on_terminal(req)

    def _shed_expired(self) -> None:
        """Shed QUEUED requests whose deadline has passed (TIMED_OUT).
        Safe with in-flight sampled tokens (async pipeline): the emission
        path drops tokens for terminal requests, and a preempted request's
        pages were already freed at preemption."""
        if not any(r.deadline is not None for r in self.waiting):
            return
        now = time.perf_counter()
        kept: Deque[Request] = deque()
        while self.waiting:
            r = self.waiting.popleft()
            dl = r.deadline
            if dl is not None and now >= dl:
                self._reject(r, FinishReason.TIMED_OUT)
                self.deadline_shed += 1
            else:
                kept.append(r)
        self.waiting = kept

    def _chunk_len(self, lo: int, remaining: int, budget: int) -> int:
        """Length of the next chunk of a prompt starting at logical position
        ``lo`` with ``remaining`` tokens to go. Page-aligned mode trims the
        chunk to end on the last page boundary it can reach, so the engine
        can snapshot recurrent state under the committed prefix chain hash
        (the final sub-page tail becomes its own chunk)."""
        n = min(remaining, budget, max(self.prefill_buckets))
        if self.page_aligned:
            aligned = ((lo + n) // self.page_size) * self.page_size - lo
            if 0 < aligned < n:
                return aligned
        return n

    def _youngest_running(self, exclude: Optional[Request] = None,
                          shard: Optional[int] = None):
        cands = [r for r in self.running.values() if r is not exclude
                 and (shard is None or r.shard == shard)]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.arrival_time, r.req_id))

    def preempt(self, req: Request) -> None:
        """Evict a running request: free its references (shared pages stay
        alive under their other owners / the prefix cache) and requeue it at
        the FRONT with everything-so-far as its new prompt. A request past
        ``max_preemptions`` is rejected (PREEMPTION_LIMIT) instead of
        requeued — under sustained pressure the preempt/re-admit cycle is a
        livelock, and a bounded reject lets the client retry elsewhere."""
        self.manager.free(req.pool_id)
        del self.running[req.lane]
        self.free_lanes.append(req.lane)
        req.lane = -1
        req.num_computed = 0
        req.num_preemptions += 1
        self.preemptions += 1
        if 0 <= req.shard < self.num_shards:
            self.preemptions_by_shard[req.shard] += 1
        req.shard = -1                    # re-placed at re-admission
        if req.num_preemptions > self.max_preemptions:
            self.preemption_limit_rejects += 1
            self._reject(req, FinishReason.PREEMPTION_LIMIT)
            return
        req.state = RequestState.PREEMPTED
        self.waiting.appendleft(req)

    def _append_with_preemption(self, req: Request) -> Optional[int]:
        """Grow ``req`` by one decode slot, preempting the youngest running
        request ON THE PRESSURED SHARD on exhaustion. Returns None if
        ``req`` itself was the youngest there and had to be preempted."""
        while True:
            try:
                return self.manager.append_token(req.pool_id)
            except OutOfBlocks as e:
                victim = self._youngest_running(exclude=req, shard=e.shard)
                if victim is None or _younger(req, victim):
                    self.preempt(req)
                    return None
                self.preempt(victim)

    def _plan_prefetch(self) -> None:
        """Scan the first ``prefetch_depth`` queued requests for prefixes
        that are matched but not device-resident (HOST) and hand them to
        the engine's prefetcher, which dispatches the host->HBM staging
        uploads asynchronously — overlapped with the step currently in
        flight. ``match_prefix`` is read-only, so planning never skews the
        allocate-time hit accounting."""
        if (self.prefetcher is None or self.prefetch_depth <= 0
                or not self.manager.host_tier_enabled):
            return
        mgr = self.manager
        scanned = 0
        for r in list(self.waiting):
            if scanned >= self.prefetch_depth:
                break
            if r.prefetch_keys or r.inflight > 0 or r.is_terminal:
                continue
            scanned += 1
            eff = r.effective_prompt()
            m = mgr.match_prefix(eff, len(eff) + self.extra_tokens)
            if not m.fetchable:
                continue
            keys = self.prefetcher(r, m)
            if keys:
                r.prefetch_keys = list(keys)
                r.prefetch_shard = m.shard
                self.prefetches_planned += 1

    def _place(self, pool_id: int, total: int,
               token_ids, pref_hint: Optional[int] = None) -> Optional[int]:
        """Shard-affine admission: try the prefix-affine shard first, then
        every other shard in least-loaded order. Returns the pages' shard or
        None when no shard can hold the request right now (admission never
        preempts running work). Updates placement stats. ``pref_hint``
        (the shard a just-landed prefetch restored the prefix to)
        overrides the chain-hash-head lookup."""
        mgr = self.manager
        pref = pref_hint if pref_hint is not None \
            else mgr.preferred_shard(token_ids, total)
        order = sorted(range(self.num_shards), key=mgr.load_key)
        if pref is not None:
            order.remove(pref)
            order.insert(0, pref)
        for shard in order:
            try:
                mgr.allocate(pool_id, total, token_ids=token_ids,
                             shard=shard)
            except OutOfBlocks:
                continue
            if pref is not None:
                if shard == pref:
                    self.placement_prefix_hits += 1
                else:
                    self.placement_misses += 1
            return shard
        return None

    # --------------------------------------------------------------- plan --
    def schedule_step(self) -> StepPlan:
        """Compose one engine step under the token budget."""
        self._shed_expired()
        if self.prefetch_tick is not None:
            self.prefetch_tick()       # land flights dispatched last turn
        self._plan_prefetch()          # start fetches for queued prefixes
        plan = StepPlan()
        budget = self.token_budget
        mgr = self.manager

        # 1) decode: every prefill-complete running request, oldest first
        #    (so OutOfBlocks preemption always hits a not-yet-planned,
        #    younger victim).
        decode_reqs = sorted(
            (r for r in self.running.values()
             if r.num_computed >= self._target(r)),
            key=lambda r: (r.arrival_time, r.req_id))
        for r in decode_reqs:
            if budget <= 0:
                break
            if r.state is not RequestState.RUNNING:
                continue                               # preempted this step
            if r.num_generated + r.inflight >= r.max_new_tokens:
                continue   # async pipeline: every remaining output token is
                           # already sampled on device (never binds when the
                           # sync loop drains emissions each step)
            slot = self._append_with_preemption(r)
            if slot is None:
                continue
            plan.decode.append(
                DecodeItem(r, pos=mgr.num_tokens(r.pool_id) - 1, slot=slot))
            budget -= 1

        # 2) continuation chunks of partially-prefilled prompts
        for r in sorted(self.running.values(),
                        key=lambda r: (r.arrival_time, r.req_id)):
            tgt = self._target(r)
            if r.num_computed >= tgt or budget <= 0:
                continue
            lo = r.num_computed
            n = self._chunk_len(lo, tgt - lo, budget)
            eff = r.effective_prompt()
            plan.prefill.append(PrefillChunk(
                r, start=lo,
                tokens=eff[max(lo - self.extra_tokens, 0):
                           max(lo - self.extra_tokens + n, 0)],
                final=(lo + n >= tgt), count=n))
            budget -= n

        # 3) admissions (shard-affine placement, chunked for every family)
        while self.waiting and self.free_lanes and budget > 0:
            r = self.waiting[0]
            if r.inflight > 0:
                # async pipeline: a preempted request with sampled-but-not-
                # emitted tokens has an incomplete effective_prompt — hold
                # the queue (it sits at the FRONT) until they drain
                break
            if r.prefetch_keys:
                res = [mgr.residency(h) for h in r.prefetch_keys]
                if any(x is PageResidency.IN_FLIGHT for x in res):
                    # its prefix is mid-upload: hold admission (~1 turn,
                    # overlapped with the in-flight step) so allocate sees
                    # the restored pages as plain device hits
                    self.prefetch_held_turns += 1
                    break
                r.prefetch_keys = []   # landed / aborted — admit normally
                if (any(x is PageResidency.HOST for x in res)
                        and r.prefetch_replans < self.max_prefetch_replans):
                    # a landed page was stolen back to the host tier by
                    # allocation pressure before this request admitted:
                    # forfeit nothing — hold one turn and re-plan the
                    # fetch (keys are clear, so the next turn's
                    # ``_plan_prefetch`` picks it up again). Bounded so a
                    # thrashing pool degrades to recompute, never livelock.
                    r.prefetch_replans += 1
                    self.prefetch_replans += 1
                    break
            eff = r.effective_prompt()
            total = len(eff) + self.extra_tokens
            # a request is pinned to ONE shard, so the largest shard's page
            # range bounds what is ever servable
            cap = min(self.max_len,
                      mgr.max_shard_capacity() * self.page_size)
            if total + (r.max_new_tokens - r.num_generated) > cap:
                self.waiting.popleft()
                self._reject(r)
                continue
            pool_id = self._next_pool_id
            # NOTE(vlm/whisper): the prefix key covers TEXT tokens only —
            # sound while the modality frontends are zero stubs (every
            # request's patch embeddings / audio frames are identical, so
            # the cached patch K/V and frame-conditioned decoder self-KV
            # are too). Real image/audio inputs must fold a modality-content
            # digest into the chain-hash seed, as the recurrent families'
            # prefix_gate does for state (see ROADMAP).
            shard = self._place(
                pool_id, total, eff,
                pref_hint=r.prefetch_shard if r.prefetch_shard >= 0
                else None)
            if shard is None:
                break              # admission never preempts running work
            cached = mgr.cached_tokens(pool_id)
            self._next_pool_id += 1
            r.pool_id = pool_id
            r.shard = shard
            r.prefetch_shard = -1
            if r.admit_time < 0:
                r.admit_time = time.perf_counter()   # queue-wait anchor
            self.waiting.popleft()
            lane = self.free_lanes.pop()
            r.lane = lane
            r.state = RequestState.RUNNING
            r.num_computed = cached
            r.prefill_target = total
            self.running[lane] = r
            n = self._chunk_len(cached, total - cached, budget)
            lo = cached
            plan.prefill.append(PrefillChunk(
                r, start=lo,
                tokens=eff[max(lo - self.extra_tokens, 0):
                           max(lo - self.extra_tokens + n, 0)],
                final=(cached + n >= total),
                first=True, count=n))
            budget -= n
        return plan

    # ---------------------------------------------------------- execution --
    def note_prefilled(self, req: Request, n: int) -> None:
        """Engine callback after a chunk's KV landed on device: advance the
        request and register now-complete full pages for prefix reuse."""
        req.num_computed += n
        self.manager.commit_prefill(req.pool_id, req.num_computed,
                                    token_ids=req.effective_prompt())

    def finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        req.finish(FinishReason.FINISHED)
        self.manager.free(req.pool_id)
        del self.running[req.lane]
        self.free_lanes.append(req.lane)
        req.lane = -1

    def release(self, req: Request,
                reason: FinishReason = FinishReason.CANCELLED) -> None:
        """Cancel/abort support: drop ``req`` wherever it currently lives —
        free its pool pages and lane if running, or unlink it from the
        waiting queue. Safe with in-flight sampled tokens: the async
        pipeline drops them at emission (terminal state), and device-order
        execution keeps already-dispatched steps ahead of any page reuse."""
        if req.state is RequestState.RUNNING:
            self.manager.free(req.pool_id)
            del self.running[req.lane]
            self.free_lanes.append(req.lane)
            req.lane = -1
        elif req in self.waiting:
            self.waiting.remove(req)
        req.state = RequestState.CANCELLED
        req.finish(reason)

    def abort_all(self, reason: FinishReason,
                  error: Optional[BaseException] = None) -> List[Request]:
        """Fault drain: release EVERY live request (running and queued) so
        the pool holds zero pages, marking each with ``reason``. Returns
        the drained requests so the caller can close their streams."""
        drained = list(self.running.values()) + list(self.waiting)
        for req in drained:
            req.finish(reason, error)
            self.release(req, reason)
        return drained

    # ------------------------------------------------------------ queries --
    def active_lanes(self) -> List[int]:
        return sorted(self.running)

    def page_table(self, req: Request) -> np.ndarray:
        return self.manager.page_table(req.pool_id, self.pages_per_lane)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)


def _younger(a: Request, b: Request) -> bool:
    return (a.arrival_time, a.req_id) > (b.arrival_time, b.req_id)


# ----------------------------------------------- concat-prefill packing ----
@dataclass
class PackedRow:
    """One engine-step row holding SEVERAL requests' prefill chunks as
    segments — the concat-prefill layout the segment-aware chunk kernels
    execute (per-row segment ids keep attention from leaking across
    prompts)."""
    chunks: List[PrefillChunk] = field(default_factory=list)
    tokens: int = 0                # occupied query columns
    pages: int = 0                 # page-table slots used
    finals: int = 0                # chunks sampling a first token
    shard: int = -1                # all chunks share one KV shard


def chunk_pages(c: PrefillChunk, page_size: int) -> int:
    """Page-table slots chunk ``c`` needs: its request's WHOLE cached
    history through the end of the chunk (the chunk attends everything)."""
    return -(-(c.start + c.n) // page_size)


def pack_rows(chunks: List[PrefillChunk], width: int, pack_slots: int,
              pages_per_lane: int, page_size: int) -> List[PackedRow]:
    """First-fit-decreasing packing of prefill chunks into rows of
    ``width`` query columns. A chunk is NEVER split: it lands whole in one
    row (and a request's pages live on one shard, so neither crosses
    shards). Row constraints: total tokens <= width, page-table slots <=
    ``pages_per_lane`` (the step's page-table width), sampled chunks
    (final=True) <= ``pack_slots`` (the packed step's per-row logits
    slots), and one KV shard per row."""
    rows: List[PackedRow] = []
    for c in sorted(chunks, key=lambda c: -c.n):
        np_c = chunk_pages(c, page_size)
        shard = c.req.shard
        for row in rows:
            if (row.tokens + c.n <= width
                    and row.pages + np_c <= pages_per_lane
                    and row.finals + int(c.final) <= pack_slots
                    and row.shard == shard):
                break
        else:
            row = PackedRow(shard=shard)
            rows.append(row)
        row.chunks.append(c)
        row.tokens += c.n
        row.pages += np_c
        row.finals += int(c.final)
    return rows
