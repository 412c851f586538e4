"""LLM-CoOpt serving engine of the port: continuous batching over ONE shared,
refcounted, prefix-cached paged-KV pool, with the paper's three techniques
selected by a ``CoOptConfig``. The synchronous path of the JAX package's
``serving/engine.py``.

The device cache is a GLOBAL paged pool — per-layer leaves ``(2, P_total,
ps, Hkv, D)`` with no batch dimension, the final page reserved. All dynamic
paging state (free lists, refcounts, prefix-cache hash tables, slot
indices, SkipSets) lives host-side in the Scheduler/BlockManager; the device
sees only index tensors: global ``slot_idx``, per-lane ``page_table``,
per-lane ``cache_len``. Lane isolation is enforced by slot disjointness, so
pool writes need no lane masking; only the batch-major ``length`` leaf is
masked with the admitted-lane mask.

The pool is updated IN PLACE by every step (the JAX package donates it to
XLA instead); the engine owns it and nothing else holds a reference.

Scheduling (Sarathi-style): each step is composed under a token budget,
mixing decode tokens and chunked-prefill chunks, and runs as ONE model call
through the chunked-continuation prefill (a decode lane is a chunk of
length 1); a step with only decode lanes takes the one-token decode path.
Pool exhaustion preempts the youngest running request (greedy-exact resume);
impossible requests are REJECTED and surfaced.

Not ported yet (the engine raises ``NotImplementedError``): the host-DRAM
tier (``CacheConfig.host_pages > 0``), concat-prefill packing
(``pack_prefill``), a device mesh, recurrent families and the async
frontend; ``CacheConfig`` itself refuses page-range shards
(``num_shards != 1``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CacheConfig, ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.kernels.visits import sharing_stats
from repro_torch.models import get_model
from repro_torch.models.transformer import check_device
from repro_torch.serving.request import FinishReason, Request, RequestState
from repro_torch.serving.sampler import SamplingParams, sample
from repro_torch.serving.scheduler import Scheduler, StepPlan, bucket_len


@dataclass(frozen=True)
class EngineConfig:
    num_lanes: int = 4
    max_len: int = 512
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    long_window: int = 0            # >0: block-sparse long-context decode
    sampling: SamplingParams = SamplingParams()
    seed: int = 0
    token_budget: int = 0           # 0 => max(prefill_buckets)
    pack_prefill: bool = False      # concat-prefill packing (not ported)
    max_preemptions: int = 32       # past it a request is rejected
                                    # (PREEMPTION_LIMIT)
    cache: CacheConfig = CacheConfig()   # pool geometry and cache policy

    def cache_config(self, page_size: int) -> CacheConfig:
        """The effective :class:`CacheConfig`: ``page_size`` and the pool
        size (``num_lanes * pages(max_len)``) filled in where left 0."""
        ps = self.cache.page_size or page_size
        return self.cache.resolve(
            page_size=ps, num_pages=self.num_lanes * -(-self.max_len // ps))


@dataclass
class EngineStats:
    prefill_calls: int = 0
    decode_steps: int = 0
    mixed_steps: int = 0            # decode + prefill fused in one call
    generated_tokens: int = 0
    prefill_time: float = 0.0       # mixed-step wall time is split by
    decode_time: float = 0.0        # planned token share (Eq. 12 fairness)
    # cross-lane prefix sharing, per decode step, from the step's page table
    shared_page_visits: int = 0
    dup_page_streams_saved: int = 0
    lanes_per_shared_page: Dict[int, int] = field(default_factory=dict)
    # per-request latency
    ttft_s: List[float] = field(default_factory=list)   # submit->1st token
    tpot_s: List[float] = field(default_factory=list)   # mean s/token after
    queue_wait_s: List[float] = field(default_factory=list)  # submit->admit
    # pool health
    pool_pages: int = 0
    pages_in_use: int = 0
    peak_pages_in_use: int = 0
    fresh_pages_allocated: int = 0
    prefix_cache_queries: int = 0
    prefix_cache_hits: int = 0      # pages reused, not recomputed
    preemptions: int = 0
    rejected: int = 0
    preemption_limit_rejects: int = 0
    errors: int = 0                 # requests terminated by a step fault

    @property
    def total_time(self) -> float:
        return self.prefill_time + self.decode_time

    def throughput(self) -> float:
        """Paper Eq. 12: generated tokens / generation time (decode's
        token-share of mixed steps)."""
        return self.generated_tokens / self.decode_time \
            if self.decode_time else 0.0

    @staticmethod
    def _pct(xs: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def ttft(self, q: float = 50.0) -> float:
        """Time-to-first-token percentile (s), from submission."""
        return self._pct(self.ttft_s, q)

    def tpot(self, q: float = 50.0) -> float:
        """Per-request mean time-per-output-token percentile (s)."""
        return self._pct(self.tpot_s, q)

    def queue_wait(self, q: float = 50.0) -> float:
        return self._pct(self.queue_wait_s, q)

    def prefix_hit_rate(self) -> float:
        return self.prefix_cache_hits / self.prefix_cache_queries \
            if self.prefix_cache_queries else 0.0

    def pool_utilization(self) -> float:
        return self.pages_in_use / self.pool_pages if self.pool_pages else 0.0


@dataclass
class StepBatch:
    """One built step: the index tensors plus the host metadata that routes
    sampled tokens back to requests (``samples``: request, is-first-token,
    lane)."""
    kind: str                      # "prefill" | "decode"
    batch: Dict[str, torch.Tensor]
    lane_mask: np.ndarray          # (num_lanes,) bool
    plan: StepPlan
    samples: List[Tuple[Request, bool, int]]
    tp: int                        # planned prefill tokens
    td: int                        # planned decode tokens


class Engine:
    def __init__(self, model_cfg: ModelConfig, coopt: CoOptConfig = COOPT,
                 engine_cfg: EngineConfig = EngineConfig(), params=None,
                 device="cuda", mesh=None):
        """``device``: "cuda" (default) or "cpu"; without CUDA the default
        raises. ``params``: the model's parameter dict on ``device`` (None =
        random init from ``engine_cfg.seed``)."""
        if mesh is not None:
            raise NotImplementedError("device mesh: not ported yet")
        if engine_cfg.pack_prefill:
            raise NotImplementedError("pack_prefill: not ported yet")
        self.device = check_device(device)
        self.cfg = model_cfg
        self.coopt = coopt
        ccfg = engine_cfg.cache_config(coopt.page_size)
        if ccfg.host_pages > 0:
            raise NotImplementedError("host-DRAM KV tier: not ported yet")
        self.ccfg = ccfg
        self.ecfg = engine_cfg
        self.model = get_model(model_cfg)        # raises for other families
        if params is None:
            params = self.model.init(engine_cfg.seed, self.device)
        self.params = params
        self.gen = torch.Generator(device=self.device).manual_seed(
            engine_cfg.seed + 1)

        B, M = engine_cfg.num_lanes, engine_cfg.max_len
        self.cache = self.model.init_cache(B, M, coopt, cache_cfg=ccfg,
                                           device=self.device)
        self.scheduler = Scheduler(
            B, M, coopt.page_size, list(engine_cfg.prefill_buckets),
            token_budget=engine_cfg.token_budget or None,
            max_preemptions=engine_cfg.max_preemptions, cache_cfg=ccfg)
        self.stats = EngineStats()
        self.stats.pool_pages = self.scheduler.manager.num_pages

    # ---------------------------------------------------------- step bodies --
    def _run_model(self, sb: StepBatch):
        """One model call for the whole step; only the batch-major
        ``length`` leaf is lane-masked (pool writes are slot-disjoint)."""
        old_len = self.cache["length"].clone()
        fn = (self.model.prefill if sb.kind == "prefill"
              else self.model.decode_step)
        logits, self.cache = fn(self.params, sb.batch, self.cache, self.coopt,
                                long_window=self.ecfg.long_window)
        mask = torch.as_tensor(sb.lane_mask, device=self.device)
        self.cache["length"] = torch.where(mask, self.cache["length"],
                                           old_len)
        return logits

    def _sample(self, logits) -> np.ndarray:
        sp = self.ecfg.sampling
        return sample(logits, self.gen, temperature=sp.temperature,
                      top_k=sp.top_k, top_p=sp.top_p).cpu().numpy()

    def _emit(self, req: Request, tok: int, now: float, first: bool) -> bool:
        """Deliver one sampled token; False when it is dropped because the
        request already terminated or is done."""
        if req.is_terminal or req.done():
            return False
        req.output.append(tok)
        self.stats.generated_tokens += 1
        if first and req.prefill_time < 0:
            req.prefill_time = now          # TTFT anchor survives preemption
        return True

    @staticmethod
    def _anchor(req: Request) -> float:
        return req.submit_time if req.submit_time >= 0 else req.enqueue_time

    def _finish_done(self, reqs: List[Request]) -> None:
        now = time.perf_counter()
        for r in reqs:
            if not r.done() or r.state is not RequestState.RUNNING:
                continue
            self.scheduler.finish(r)
            r.finish_time = now
            t0 = self._anchor(r)
            if r.prefill_time >= 0 and t0 >= 0:
                self.stats.ttft_s.append(r.prefill_time - t0)
                if r.num_generated > 1:
                    self.stats.tpot_s.append(
                        (r.finish_time - r.prefill_time)
                        / (r.num_generated - 1))
            if r.admit_time >= 0 and t0 >= 0:
                self.stats.queue_wait_s.append(r.admit_time - t0)

    def _update_pool_stats(self) -> None:
        mgr = self.scheduler.manager
        s = self.stats
        s.pool_pages = mgr.num_pages
        s.pages_in_use = mgr.pages_in_use
        s.peak_pages_in_use = max(s.peak_pages_in_use, mgr.pages_in_use)
        s.fresh_pages_allocated = mgr.fresh_pages_allocated
        s.prefix_cache_queries = mgr.prefix_queries
        s.prefix_cache_hits = mgr.prefix_hits
        s.preemptions = self.scheduler.preemptions
        s.rejected = len(self.scheduler.rejected)
        s.preemption_limit_rejects = self.scheduler.preemption_limit_rejects

    def _note_sharing(self, rows: np.ndarray) -> None:
        """Cross-lane prefix-sharing counts for one decode step (the dedup
        the visit-list kernel performs on the device)."""
        st = sharing_stats(rows)
        self.stats.shared_page_visits += st["shared_page_visits"]
        self.stats.dup_page_streams_saved += st["dup_page_streams_saved"]
        hist = self.stats.lanes_per_shared_page
        for k, n in st["lanes_per_shared_page"].items():
            hist[k] = hist.get(k, 0) + n

    # --------------------------------------------------- the ONE step path --
    def _build_step(self, plan: StepPlan) -> StepBatch:
        """The whole step's static-shape index tensors from the plan."""
        B = self.ecfg.num_lanes
        NP = self.scheduler.pages_per_lane
        mgr = self.scheduler.manager

        page_table = np.full((B, NP), -1, np.int32)
        cache_len = np.zeros(B, np.int32)
        lane_mask = np.zeros(B, bool)
        S = (bucket_len(max(c.n for c in plan.prefill),
                        self.scheduler.prefill_buckets) or
             max(c.n for c in plan.prefill)) if plan.prefill else 1
        tokens = np.zeros((B, S), np.int32)
        positions = np.zeros((B, S), np.int32)
        slot_idx = np.full((B, S), -1, np.int32)      # Eq. 5 SkipSet: pads
        last_pos = np.zeros(B, np.int32)
        samples: List[Tuple[Request, bool, int]] = []

        for c in plan.prefill:
            lane, n = c.req.lane, c.n
            tokens[lane, :len(c.tokens)] = c.tokens
            positions[lane] = np.minimum(c.start + np.arange(S),
                                         c.start + n - 1)
            slot_idx[lane, :n] = mgr.slot_indices(
                c.req.pool_id, np.arange(c.start, c.start + n))
            page_table[lane] = self.scheduler.page_table(c.req)
            cache_len[lane] = c.start + n
            last_pos[lane] = n - 1
            lane_mask[lane] = True
            if c.final:
                samples.append((c.req, True, lane))
        for d in plan.decode:                          # a chunk of length 1
            lane = d.req.lane
            tokens[lane, 0] = d.req.output[-1] if d.req.output else 0
            positions[lane] = d.pos
            slot_idx[lane, 0] = d.slot
            page_table[lane] = self.scheduler.page_table(d.req)
            cache_len[lane] = d.pos + 1
            last_pos[lane] = 0
            lane_mask[lane] = True
            samples.append((d.req, False, lane))
        if len(plan.decode) > 1:
            self._note_sharing(page_table[[d.req.lane for d in plan.decode]])

        dev = self.device
        batch = {"positions": torch.as_tensor(positions, device=dev),
                 "slot_idx": torch.as_tensor(slot_idx, device=dev),
                 "page_table": torch.as_tensor(page_table, device=dev),
                 "cache_len": torch.as_tensor(cache_len, device=dev)}
        if plan.prefill:
            batch.update(tokens=torch.as_tensor(tokens, device=dev),
                         last_pos=torch.as_tensor(last_pos, device=dev))
            kind = "prefill"
        else:
            batch["token"] = torch.as_tensor(tokens, device=dev)
            kind = "decode"
        return StepBatch(kind=kind, batch=batch, lane_mask=lane_mask,
                         plan=plan, samples=samples,
                         tp=sum(c.n for c in plan.prefill),
                         td=len(plan.decode))

    def _execute(self, sb: StepBatch):
        """Run the step and wait for it; book its wall time by planned token
        share (a prefill-heavy mixed step must not count as decode time)."""
        t0 = time.perf_counter()
        logits = self._run_model(sb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        share = dt / max(sb.tp + sb.td, 1)
        if sb.tp:
            self.stats.prefill_time += share * sb.tp
            self.stats.prefill_calls += 1
        if sb.td:
            self.stats.decode_time += share * sb.td
            self.stats.decode_steps += 1
        if sb.tp and sb.td:
            self.stats.mixed_steps += 1
        return logits

    def _run_mixed(self, plan: StepPlan) -> None:
        """One model call for the whole step: prefill chunks + decode tokens
        through the chunked-continuation path; a decode-only step takes the
        one-token decode path."""
        sb = self._build_step(plan)
        logits = self._execute(sb)
        toks = self._sample(logits)
        for c in sb.plan.prefill:
            self.scheduler.note_prefilled(c.req, c.n)
        now = time.perf_counter()
        for req, first, lane in sb.samples:
            self._emit(req, int(toks[lane]), now, first=first)
        self._finish_done([req for req, _, _ in sb.samples])

    # ---------------------------------------------------------------- API --
    def add_request(self, req: Request) -> None:
        req.enqueue_time = time.perf_counter()
        self.scheduler.add_request(req)

    def abort_all(self, exc: Optional[BaseException] = None) -> List[Request]:
        """Fault drain: terminate every live request with ERROR, returning
        the pool to zero pages in use."""
        drained = self.scheduler.abort_all(FinishReason.ERROR, exc)
        self.stats.errors += len(drained)
        self._update_pool_stats()
        return drained

    def step(self) -> None:
        plan = self.scheduler.schedule_step()
        if plan.empty:
            self._update_pool_stats()       # rejections still count
            return
        try:
            self._run_mixed(plan)
        except Exception as exc:
            # a step fault must not leak pool pages or strand requests:
            # drain everything as ERROR, then surface the fault
            self.abort_all(exc)
            raise
        self._update_pool_stats()

    def run(self, max_steps: int = 100_000) -> None:
        steps = 0
        while self.scheduler.has_work and steps < max_steps:
            self.step()
            steps += 1

    def generate(self, prompts: Sequence[np.ndarray], max_new_tokens: int = 32,
                 eos_token: Optional[int] = None,
                 return_requests: bool = False):
        """Serve ``prompts`` to completion. Returns the per-prompt output
        token lists (or the Request objects with ``return_requests``;
        rejected requests surface with empty output and count in
        ``stats.rejected``)."""
        reqs = []
        for i, p in enumerate(prompts):
            now = time.perf_counter()
            reqs.append(Request(req_id=1000 + i,
                                prompt=np.asarray(p, np.int32),
                                max_new_tokens=max_new_tokens,
                                eos_token=eos_token,
                                arrival_time=now, submit_time=now))
        for r in reqs:
            self.add_request(r)
        self.run()
        if return_requests:
            return reqs
        return [r.output for r in reqs]
