"""Serving launcher of the port: the continuous-batching engine over a
synthetic ShareGPT request mix, reporting the paper's two metrics (Eq. 11
latency, Eq. 12 generation throughput). The port of the JAX package's
``launch/serve.py``, with its flags and report keys.

  python -m repro_torch.launch.serve --arch qwen3-4b --reduced \\
      --requests 16 --mode coopt --use-kernel          # on the card
  python -m repro_torch.launch.serve --arch qwen3-4b --reduced \\
      --requests 4 --device cpu                        # plain versions

``--use-kernel`` runs the hand-written CUDA kernels (on CPU tensors their
plain PyTorch versions); without it the model's plain PyTorch path runs.

Async frontend (``serving.frontend.AsyncEngine``): ``--async`` serves the
same workload through the overlapped host/device pipeline —

  * startup builds a step runner for EVERY step shape of the bucket lattice
    (``launch.steps.serving_warmup`` -> ``Engine.warmup``; on CUDA each
    captures a CUDA graph), so steady-state serving builds none —
    ``--assert-aot`` makes the run fail if a step found no runner
    (``engine.aot_misses``) or a runner was built after the warmup
    (``engine.trace_counts``);
  * ``--arrival-rate R`` replays the requests as a Poisson process with
    mean R requests/s (0 = all submitted up front), so reported TTFT/
    queue-wait percentiles — measured from SUBMISSION — reflect load;
  * ``--pack`` routes prefill chunks through concat-prefill packing
    (dense/moe/mla families).

Page-range shards: ``--shards N`` splits the pool into N page ranges with
shard-affine placement; ``--mesh`` also serves on ``make_sim_mesh(data=N,
model=1)``: with the kernels (``--use-kernel``) each range is a pool of its
own on the serving device, written shard-locally, and each read runs per
shard and merges (``kernels.sharded``).

The host-DRAM KV tier: ``--host-pages N`` keeps up to N device-evicted
prefix pages in host memory and ``--prefetch-depth`` sets how many queued
requests a turn scans for prefixes to upload back; with ``--pool-pages``
small the working set outgrows the device pool and the tier's keys of the
report (host hits, spills, prefetches) move.
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import CacheConfig
from repro_torch.core.coopt import MODES
from repro_torch.data import RequestStream
from repro_torch.serving import AsyncEngine, Engine, EngineConfig
from repro_torch.serving.sampler import SamplingParams


def poisson_offsets(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Cumulative Poisson-process arrival offsets (s) for ``n`` requests at
    ``rate`` requests/s; zeros when rate is 0 (submit everything up
    front)."""
    if rate <= 0:
        return np.zeros(n)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


class ServeRunner:
    """One warmed serving configuration with a repeatable measured pass.

    Several configurations (sync / async / async+pack over the same Poisson
    arrivals) can be built up front and their measured passes interleaved
    round-robin, so drift of the machine's pace between passes cancels out
    of the comparison instead of biasing whichever ran during a slow
    minute. ``params``: the model's parameters on ``device``, which several
    runners of one model may share (None = random init from ``seed``)."""

    def __init__(self, arch: str, mode: str, *, requests: int = 16,
                 num_lanes: int = 4, max_len: int = 512,
                 max_new_tokens: int = 24, scale: float = 0.15,
                 seed: int = 0, use_kernel: bool = False,
                 temperature: float = 0.0, num_shards: int = 1,
                 mesh=None, use_async: bool = False,
                 arrival_rate: float = 0.0, pack: bool = False,
                 assert_aot: bool = False, warmup_pass: bool = False,
                 deadline_s: float = 0.0, max_queue_depth=None,
                 max_queued_tokens=None, pool_pages: int = 0,
                 host_pages: int = 0, prefetch_depth: int = 2,
                 device="cuda", params=None):
        cfg = get_config(arch)
        coopt = MODES[mode].replace(use_kernel=use_kernel)
        # every cache knob travels through ONE CacheConfig; pool_pages=0
        # keeps the derived num_lanes * pages(max_len)
        ecfg = EngineConfig(
            num_lanes=num_lanes, max_len=max_len,
            prefill_buckets=(32, 64, 128, 256, max_len),
            sampling=SamplingParams(temperature=temperature), seed=seed,
            pack_prefill=pack,
            cache=CacheConfig(num_pages=pool_pages, num_shards=num_shards,
                              host_pages=host_pages,
                              prefetch_depth=prefetch_depth))
        self.engine = Engine(cfg, coopt, ecfg, params=params, device=device,
                             mesh=mesh)
        stream = RequestStream(cfg.vocab_size, seed=seed, scale=scale)
        self.reqs = stream.take(requests, max_new_tokens=max_new_tokens)
        self.offsets = poisson_offsets(requests, arrival_rate, seed)
        self.use_async = use_async
        self.assert_aot = assert_aot
        self.deadline_s = deadline_s
        self.meta = {"arch": arch, "mode": mode, "requests": requests,
                     "async": use_async, "pack_prefill": pack,
                     "arrival_rate_req_s": arrival_rate,
                     "deadline_s": deadline_s,
                     "max_queue_depth": max_queue_depth,
                     "max_queued_tokens": max_queued_tokens,
                     "pool_pages_requested": pool_pages,
                     "host_tier_pages": host_pages}
        self.frontend = None
        self.last_streams = []          # TokenStreams of the last async pass
        if use_async:
            from repro_torch.launch.steps import serving_warmup
            self.frontend = AsyncEngine(self.engine, warmup=False,
                                        max_queue_depth=max_queue_depth,
                                        max_queued_tokens=max_queued_tokens)
            self.meta.update(serving_warmup(self.engine))
        if warmup_pass:
            # one full pass of the identical workload before the clock
            # starts: the first calls' lazy setup (kernel libraries, cuBLAS
            # handles, the allocator's blocks) stays out of the measurement
            self._run_pass()
        self._traces_at_warmup = dict(self.engine.trace_counts)

    def measure(self) -> float:
        """One measured pass over the identical arrival process (stats
        reset first); returns the wall-clock seconds."""
        self.engine.stats.__init__()
        return self._run_pass()

    def metrics(self, wall: float) -> dict:
        """Stats snapshot for the LAST measured pass."""
        return _pass_metrics(self.engine.stats, wall)

    def trace_report(self) -> dict:
        """Warmup health after measuring (async only): steps that found no
        runner (``aot_misses``, run eagerly) and runners built after the
        warmup (``retraces``, by step kind). Raises when ``assert_aot`` was
        set and either happened."""
        if not self.use_async:
            return {}
        retraced = {k: v for k, v in self.engine.trace_counts.items()
                    if v != self._traces_at_warmup.get(k, 0)}
        rep = {"aot_misses": self.engine.aot_misses, "retraces": retraced}
        if self.assert_aot and (self.engine.aot_misses or retraced):
            raise RuntimeError(
                f"steady-state serve traced: aot_misses="
                f"{self.engine.aot_misses}, retraces={retraced}")
        return rep

    def outcome_report(self, wall: float) -> dict:
        """Terminal-status breakdown of the last async pass: per
        ``FinishReason`` counts plus goodput — tokens of requests that
        FINISHED per wall second (shed or expired work never counts)."""
        from repro_torch.serving import FinishReason
        streams = self.last_streams
        by_reason = {r.name.lower(): 0 for r in FinishReason}
        good_tokens = 0
        for s in streams:
            if s.finish_reason is None:
                raise RuntimeError(f"stream {s.req.req_id} left without a "
                                   "terminal status")
            by_reason[s.finish_reason.name.lower()] += 1
            if s.finish_reason is FinishReason.FINISHED:
                good_tokens += len(s.req.output)
        n = max(len(streams), 1)
        return {
            "outcomes": by_reason,
            "submitted": len(streams),
            "goodput_tok_s": round(good_tokens / max(wall, 1e-9), 2),
            "shed_rate": round(by_reason["shed"] / n, 4),
            "deadline_hit_rate": round(by_reason["finished"] / n, 4),
        }

    # ------------------------------------------------------------- passes --
    def _run_pass(self) -> float:
        return self._async_pass() if self.use_async else self._sync_pass()

    def _async_pass(self) -> float:
        frontend = self.frontend
        pending = list(zip(self.offsets, self.reqs))
        self.last_streams = streams = []
        t0 = time.perf_counter()

        def _submit_due():
            while pending and time.perf_counter() - t0 >= pending[0][0]:
                _, r = pending.pop(0)
                streams.append(frontend.submit(
                    r.prompt, max_new_tokens=r.max_new_tokens,
                    eos_token=r.eos_token, deadline_s=self.deadline_s))

        _submit_due()
        while pending:
            # interleave submissions with serving turns at their offsets
            if frontend._has_work:
                frontend._loop_once()
            else:
                time.sleep(min(max(pending[0][0] -
                                   (time.perf_counter() - t0), 0), 0.001))
            _submit_due()
        frontend.run_until_idle()
        return time.perf_counter() - t0

    def _sync_pass(self) -> float:
        engine = self.engine
        pending = [(off, copy.deepcopy(r))
                   for off, r in zip(self.offsets, self.reqs)]
        t0 = time.perf_counter()

        def _add_due():
            while pending and time.perf_counter() - t0 >= pending[0][0]:
                _, rr = pending.pop(0)
                now = time.perf_counter()
                rr.arrival_time = rr.submit_time = now
                engine.add_request(rr)

        _add_due()
        while pending or engine.scheduler.has_work:
            if engine.scheduler.has_work:
                engine.step()
            else:
                time.sleep(min(max(pending[0][0] -
                                   (time.perf_counter() - t0), 0), 0.001))
            _add_due()
        return time.perf_counter() - t0

    def close(self) -> None:
        """Stop the async frontend's emit worker."""
        if self.frontend is not None:
            self.frontend.close()


def serve_workload(arch: str, mode: str, *, repeats: int = 1,
                   assert_aot: bool = False, **kw):
    """``use_async`` drives the workload through ``AsyncEngine`` (runners
    built up front); ``arrival_rate`` > 0 spaces submissions as a Poisson
    process (both loops); ``pack`` enables concat-prefill packing.
    ``warmup_pass`` runs the identical workload once before the measured
    pass (stats reset). ``repeats`` runs the measured pass N times
    (identical arrivals, stats reset each time) and reports the best-wall
    pass. ``device``: "cuda" (default) or "cpu"."""
    runner = ServeRunner(arch, mode, assert_aot=assert_aot, **kw)
    try:
        repeats = max(1, int(repeats))
        out = dict(runner.meta)
        out["repeats"] = repeats
        best: dict = {}
        walls = []
        for _ in range(repeats):
            wall = runner.measure()
            walls.append(round(wall, 4))
            if not best or wall < best["wall_s"]:
                best = runner.metrics(wall)
        out.update(best)
        out["repeat_wall_s"] = walls
        out.update(runner.trace_report())
        if runner.use_async and runner.last_streams:
            # terminal-status breakdown of the LAST pass
            out.update(runner.outcome_report(walls[-1]))
    finally:
        runner.close()
    return out


def _pass_metrics(s, wall: float) -> dict:
    """Stats snapshot for one measured pass (``s`` = ``engine.stats``),
    with the JAX package's keys in its order."""
    return {
        "wall_s": round(wall, 4),
        "generated_tokens": s.generated_tokens,
        "prefill_time_s": round(s.prefill_time, 4),
        "decode_time_s": round(s.decode_time, 4),
        "latency_s": round(s.total_time, 4),          # Eq. 11
        "throughput_tok_s": round(s.throughput(), 2),  # Eq. 12
        "wall_throughput_tok_s": round(
            s.generated_tokens / max(wall, 1e-9), 2),
        # per-request latency percentiles, measured from SUBMISSION
        **s.latency_summary(),
        "packed_steps": s.packed_steps,
        "packed_rows_saved": s.packed_rows_saved,
        # shared-pool health (global refcounted allocator)
        "pool_pages": s.pool_pages,
        "peak_pool_utilization": round(
            s.peak_pages_in_use / max(s.pool_pages, 1), 4),
        "prefix_hit_rate": round(s.prefix_hit_rate(), 4),
        "prefix_device_hit_rate": round(s.prefix_device_hit_rate(), 4),
        "prefix_host_hit_rate": round(s.prefix_host_hit_rate(), 4),
        "preemptions": s.preemptions,
        "rejected": s.rejected,
        # host-DRAM KV tier (all zeros when host_pages=0)
        "host_pages": s.host_pages,
        "host_pages_resident": s.host_pages_resident,
        "spilled_pages": s.spilled_pages,
        "host_evictions": s.host_evictions,
        "prefetch_committed": s.prefetch_committed,
        "prefetch_aborted": s.prefetch_aborted,
        "prefetch_held_turns": s.prefetch_held_turns,
        # per-shard page-range ownership
        "kv_shards": s.num_shards,
        "shard_peak_utilization": [
            round(p / max(c, 1), 4)
            for p, c in zip(s.peak_shard_pages_in_use, s.shard_pages)],
        "shard_preemptions": list(s.shard_preemptions),
        "placement_prefix_hits": s.placement_prefix_hits,
        "placement_misses": s.placement_misses,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="coopt", choices=list(MODES))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--use-kernel", action="store_true",
                    help="the hand-written CUDA kernels (their plain "
                         "PyTorch versions on the CPU)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--shards", type=int, default=1,
                    help="KV-pool page-range shards (= the mesh's pod*data "
                         "extent; see launch.mesh.kv_shard_count)")
    ap.add_argument("--mesh", action="store_true",
                    help="serve on a simulated (data=--shards, model=1) "
                         "mesh: with --use-kernel each page range is a "
                         "pool of its own on the device, written and read "
                         "per shard, the reads merged (kernels.sharded)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="AsyncEngine: overlapped host/device pipeline "
                         "with a step runner (CUDA graph) a step shape")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson request arrival rate (req/s; 0 = all "
                         "up front)")
    ap.add_argument("--pack", action="store_true",
                    help="concat-prefill packing (dense/moe/mla)")
    ap.add_argument("--assert-aot", action="store_true",
                    help="fail if any steady-state step found no runner or "
                         "a runner was built after the warmup")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline (s from submission; 0 = "
                         "none). Queued requests past it are shed "
                         "TIMED_OUT. Needs --async")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="load-shed watermark: pending requests beyond "
                         "this are fast-rejected SHED at submit")
    ap.add_argument("--max-queued-tokens", type=int, default=None,
                    help="load-shed watermark: pending prompt tokens "
                         "beyond this fast-reject SHED at submit")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="device KV pool size in pages (0 = derive "
                         "lanes * pages(max_len)); small values force "
                         "memory pressure")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-DRAM KV spill tier capacity in pages "
                         "(0 = off)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="queued requests scanned per turn for host->HBM "
                         "prefix prefetch")
    ap.add_argument("--repeats", type=int, default=1,
                    help="measured passes (best wall reported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_sim_mesh
        mesh = make_sim_mesh(data=args.shards, model=1)
    arch = args.arch + ("-reduced" if args.reduced else "")
    out = serve_workload(arch, args.mode, requests=args.requests,
                         num_lanes=args.lanes, max_len=args.max_len,
                         max_new_tokens=args.max_new_tokens,
                         use_kernel=args.use_kernel,
                         temperature=args.temperature,
                         num_shards=args.shards, mesh=mesh,
                         use_async=args.use_async,
                         arrival_rate=args.arrival_rate, pack=args.pack,
                         assert_aot=args.assert_aot, repeats=args.repeats,
                         deadline_s=args.deadline,
                         max_queue_depth=args.max_queue_depth,
                         max_queued_tokens=args.max_queued_tokens,
                         pool_pages=args.pool_pages,
                         host_pages=args.host_pages,
                         prefetch_depth=args.prefetch_depth,
                         device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
