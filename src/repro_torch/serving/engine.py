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
pool writes need no lane masking; the batch-major leaves (``length`` and a
recurrent model's state) are masked with the step's lane mask.

The pool is updated IN PLACE by every step (the JAX package donates it to
XLA instead); the engine owns it and nothing else holds a reference.

Scheduling (Sarathi-style): each step is composed under a token budget,
mixing decode tokens and chunked-prefill chunks, and runs as ONE model call
through the chunked-continuation prefill (a decode lane is a chunk of
length 1); a step with only decode lanes takes the one-token decode path.
Pool exhaustion preempts the youngest running request (greedy-exact resume);
impossible requests are REJECTED and surfaced.

Concat-prefill packing (``EngineConfig.pack_prefill``): a step with prefill
chunks runs as ROWS instead of lanes. Several prompts' chunks share one row
as segments (``seg_q``/``page_seg``/``page_base``, which the chunk kernels
K3 and K6 read so attention never crosses a segment), each decode lane
keeps a row of its own, and the row count is padded to a power of two, so
a step of short prompts runs on fewer rows than lanes. Rows are decoupled
from lanes, so the lane-major ``length`` leaf keeps its value through a
packed step (every step passes explicit ``cache_len``).

The async pipeline (``serving/frontend.py``) drives the same step
construction through ``_dispatch_async``: one step runner per step shape
of the bucket lattice (``warmup``), holding static input buffers and, on
CUDA, a CUDA graph captured from ``_async_step``, so that a step is one
host-to-device copy and one graph replay instead of a launch per op.
Sampling runs on the device and each sampled token is scattered into the
persistent per-lane ``lane_tok`` feed, so step N+1 is planned and
dispatched before step N's tokens reach the host.

A vlm model's (internvl2) prompt is its ``num_patches`` patch-stub
positions followed by the text: the scheduler counts the stub as
``extra_tokens``, a chunk's columns inside it carry a placeholder token id,
and every prefill step passes zero patch embeddings (one tensor allocated
with the engine, so a captured graph reads it at a fixed address). vlm
does not pack (``pack_prefill`` raises).

The recurrent families (griffin, rwkv6) carry per-lane state in
batch-major cache leaves (the model's ``recurrent_leaves``). A request's
first chunk since admission zeroes its lane's state, or restores the
snapshot that matches its prefix-cache hit; chunks end on page boundaries
(``Scheduler(page_aligned=True)``), and a chunk that ends on one leaves a
snapshot of the lane's state under the chain hash of its pages, the
prefix cache's resume artifact (a match stops at the deepest page with a
snapshot: the manager's ``prefix_gate``). Resets, restores and snapshots
are device copies enqueued on the step stream into and out of the
persistent leaves, so they keep the addresses a captured graph reads and
never wait for the card. Prefill steps carry ``pad_mask`` (B, S), which
freezes the recurrence on a lane's padding columns. These families do not
pack (``pack_prefill`` raises).

Page-range shards (``CacheConfig.num_shards``, or ``EngineConfig.num_shards``):
the pool is padded to split evenly into that many page ranges and the
scheduler pins each request to one (shard-affine placement, per-shard
preemption). With a ``launch.mesh`` mesh (``Engine(mesh=...)``) the shard
count comes from its ``(pod, data)`` extent and, with the kernels, each
page range is a pool of its own on the mesh's device for that shard
(every pool leaf a ``core.opt_kv.ShardedPool``) and every step body runs
under the mesh's shard context (``ops.mesh_ctx_scope``): writes are
shard-local, each read kernel runs on its shard's device and the partials
are merged on the engine's device, the controller, which keeps the weights
and the batch-major leaves (``kernels.sharded``). Both engines serve a mesh
on one device (the async one inside its CUDA graphs); a mesh across
several cards is served by the sync engine. Without a mesh, or off the
kernel path, the shards are the host's placement only and the one pool is
read whole.

whisper (encoder-decoder) keeps its cross-attention K/V in batch-major
leaves (``xk``, ``xv``, ``xscale``), computed ONCE per request: a prefill
step that carries a request's first chunk passes ``cross_mask`` (the lanes
to refill) and the engine's zero ``frames`` (one tensor allocated with the
engine, as the vlm patches), and the model runs the encoder; a step
without a first chunk skips the encoder. The async lattice holds one
prefill runner with the encoder and one without for each bucket. whisper
does not pack (``pack_prefill`` raises).

The host-DRAM tier (``CacheConfig.host_pages > 0``) rescues prefix pages
that the device LRU evicts (``_spill_page``, the BlockManager's
``spill_sink``) and stages them back into reserved pool pages before a
queued request that matches them is admitted (``_start_prefetch`` /
``_tick_prefetch``, the scheduler's ``prefetcher`` / ``prefetch_tick``).
Only the pool leaves (those with a ``pages`` axis) move; batch-major
leaves never spill. The copies are enqueued on the engine's step stream:
a spill's device-to-host copy after every step that wrote the page and
before any later step that may reuse it, an upload's host-to-device copy
before every step planned after its flight commits. On the card the host
payloads live in pinned buffers (non-blocking copies), and no host code
reads a payload before its copy completes; uploads write the staging page
in place, so captured graphs keep reading the pool's addresses.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache.block_manager import (OutOfBlocks, PageResidency,
                                             PrefixMatch, chain_hash_tokens,
                                             extend_chain_hash)
from repro_torch.cache.quant import (HostPage, dequantize_fp8,
                                     encode_host_page, select)
from repro_torch.configs.base import CacheConfig, ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.core.opt_kv import ShardedPool
from repro_torch.kernels import ops
from repro_torch.kernels.sharded import canonical_device, cards
from repro_torch.kernels.visits import sharing_stats
from repro_torch.models import get_model
from repro_torch.models.transformer import check_device
from repro_torch.serving.request import FinishReason, Request, RequestState
from repro_torch.serving.sampler import SamplingParams, sample
from repro_torch.serving.scheduler import (PrefillChunk, Scheduler, StepPlan,
                                           bucket_len, chunk_pages, pack_rows)
from repro_torch.serving.trace import StepRecorder


@dataclass
class _Flight:
    """One dispatched host-to-device prefetch upload, committed to the
    prefix table once the scheduler's turn counter reaches ``lands``. The
    upload is enqueued on the step stream, so it runs before any step
    planned after the commit; the turn delay models the overlap window, it
    is not a wait."""
    hash: int
    turn: int                      # dispatch turn
    lands: int                     # first turn the commit may happen
    ok: bool = True                # fault injection: False -> abort instead


@dataclass(frozen=True)
class EngineConfig:
    num_lanes: int = 4
    max_len: int = 512
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    long_window: int = 0            # >0: block-sparse long-context decode
    sampling: SamplingParams = SamplingParams()
    seed: int = 0
    token_budget: int = 0           # 0 => max(prefill_buckets)
    pack_prefill: bool = False      # concat-prefill packing: several
                                    # prompts' chunks share one row through
                                    # the segment-aware chunk kernels
    pack_slots: int = 4             # sampled-logit slots per packed row
                                    # (max final chunks packed together)
    max_preemptions: int = 32       # past it a request is rejected
                                    # (PREEMPTION_LIMIT)
    state_cache_entries: int = 128  # recurrent-state snapshots retained
                                    # (griffin/rwkv6 prefix-cache resume)
    num_shards: int = 1             # KV-pool page-range shards (the mesh's
                                    # (pod, data) extent: launch.mesh.
                                    # kv_shard_count); or set in ``cache``
    cache: CacheConfig = CacheConfig()   # pool geometry and cache policy

    def cache_config(self, page_size: int) -> CacheConfig:
        """The effective :class:`CacheConfig`: ``page_size`` and the pool
        size (``num_lanes * pages(max_len)``) filled in where left 0, and
        ``num_shards`` folded in; set in both places, they must agree."""
        cc = self.cache
        if self.num_shards != 1:
            if cc.num_shards not in (1, self.num_shards):
                raise ValueError(
                    f"EngineConfig.num_shards={self.num_shards} conflicts "
                    f"with EngineConfig.cache.num_shards={cc.num_shards}; "
                    "set the shard count in ONE place (CacheConfig "
                    "preferred)")
            cc = cc.replace(num_shards=self.num_shards)
        ps = cc.page_size or page_size
        return cc.resolve(
            page_size=ps, num_pages=self.num_lanes * -(-self.max_len // ps))


@dataclass
class EngineStats:
    prefill_calls: int = 0
    decode_steps: int = 0
    mixed_steps: int = 0            # decode + prefill fused in one call
    step_rows: int = 0              # query rows of every step, padding in
    padded_rows: int = 0            # ..of them rows that write no slot
                                    # (slot_idx == -1)
    generated_tokens: int = 0
    prefill_time: float = 0.0       # mixed-step wall time is split by
    decode_time: float = 0.0        # planned token share (Eq. 12 fairness)
    packed_steps: int = 0           # steps run through the packed row path
    packed_rows_saved: int = 0      # lane-rows eliminated by packing
    # cross-lane prefix sharing, per decode step, from the step's page table
    shared_page_visits: int = 0
    dup_page_streams_saved: int = 0
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
                                    # (= device + host hits)
    prefix_device_hits: int = 0     # hit pages that were device-resident
    prefix_host_hits: int = 0       # hit pages restored from the host tier
    preemptions: int = 0
    rejected: int = 0
    # the host-DRAM KV tier
    host_pages: int = 0             # host tier capacity (0 = tier off)
    host_pages_resident: int = 0    # spilled pages now held on the host
    spilled_pages: int = 0          # device evictions rescued to the host
    host_evictions: int = 0         # pages dropped off the host LRU
    prefetch_begun: int = 0         # host-to-device uploads dispatched
    prefetch_committed: int = 0     # ..that landed and re-registered
    prefetch_aborted: int = 0       # ..that failed or lost a registration
    prefetches_planned: int = 0     # queued requests planned a prefetch
    prefetch_held_turns: int = 0    # admission turns gated on an upload
    prefetch_replans: int = 0       # landed prefixes stolen before
                                    # admission, fetched again
    # resilience
    shed: int = 0                   # fast-rejected at submit (overload
                                    # watermark; AsyncEngine only)
    deadline_shed: int = 0          # queued requests shed TIMED_OUT
    preemption_limit_rejects: int = 0
    errors: int = 0                 # requests terminated by a pipeline
                                    # fault (step exception, worker death,
                                    # stall watchdog)
    # the sharded pool
    num_shards: int = 1
    shard_pages: Tuple[int, ...] = ()          # page-range size per shard
    shard_pages_in_use: Tuple[int, ...] = ()
    peak_shard_pages_in_use: Tuple[int, ...] = ()
    shard_preemptions: Tuple[int, ...] = ()    # per-shard pressure evictions
    placement_prefix_hits: int = 0  # admitted on the prefix-affine shard
    placement_misses: int = 0       # prefix lived on an unusable shard ->
                                    # cross-shard CoW reuse lost

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
        # host-side Python lists of times, no device value
        # coopt: allow[COOPT001]
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def ttft(self, q: float = 50.0) -> float:
        """Time-to-first-token percentile (s), from submission."""
        return self._pct(self.ttft_s, q)

    def tpot(self, q: float = 50.0) -> float:
        """Per-request mean time-per-output-token percentile (s)."""
        return self._pct(self.tpot_s, q)

    def queue_wait(self, q: float = 50.0) -> float:
        return self._pct(self.queue_wait_s, q)

    def latency_summary(self) -> Dict[str, float]:
        return {"ttft_p50_s": round(self.ttft(50), 4),
                "ttft_p95_s": round(self.ttft(95), 4),
                "tpot_p50_s": round(self.tpot(50), 4),
                "tpot_p95_s": round(self.tpot(95), 4),
                "queue_wait_p50_s": round(self.queue_wait(50), 4),
                "queue_wait_p95_s": round(self.queue_wait(95), 4),
                "shared_page_visits": float(self.shared_page_visits),
                "dup_page_streams_saved": float(self.dup_page_streams_saved),
                "shed": float(self.shed),
                "deadline_shed": float(self.deadline_shed),
                "preemption_limit_rejects":
                    float(self.preemption_limit_rejects),
                "errors": float(self.errors),
                "prefix_device_hits": float(self.prefix_device_hits),
                "prefix_host_hits": float(self.prefix_host_hits),
                "prefix_misses": float(self.prefix_cache_queries
                                       - self.prefix_cache_hits),
                "spilled_pages": float(self.spilled_pages),
                "prefetch_committed": float(self.prefetch_committed)}

    def prefix_hit_rate(self) -> float:
        return self.prefix_cache_hits / self.prefix_cache_queries \
            if self.prefix_cache_queries else 0.0

    def prefix_device_hit_rate(self) -> float:
        return self.prefix_device_hits / self.prefix_cache_queries \
            if self.prefix_cache_queries else 0.0

    def prefix_host_hit_rate(self) -> float:
        return self.prefix_host_hits / self.prefix_cache_queries \
            if self.prefix_cache_queries else 0.0

    def prefix_miss_rate(self) -> float:
        return 1.0 - self.prefix_hit_rate() \
            if self.prefix_cache_queries else 0.0

    def pool_utilization(self) -> float:
        return self.pages_in_use / self.pool_pages if self.pool_pages else 0.0

    def shard_utilization(self) -> Tuple[float, ...]:
        return tuple(u / p if p else 0.0
                     for u, p in zip(self.shard_pages_in_use,
                                     self.shard_pages))


@dataclass
class StepBatch:
    """One built step: the index arrays plus the host metadata that routes
    sampled tokens back to requests (``samples``: request, is-first-token,
    index into the sampled tokens: ``(lane,)`` for the per-lane kinds,
    ``(row, slot)`` for the packed kind). ``batch`` holds tensors on the
    engine's device for the sync loop and numpy arrays for the async
    pipeline, which copies them into a step runner's static inputs.

    ``feed``/``row_lane``/``scatter_lane`` carry the async token plumbing:
    column 0 of row ``i`` takes its input token from the device-resident
    feed ``lane_tok[row_lane[i]]`` (-1), a host token (>= 0) or keeps the
    batch's value (-2), and each sampled token is scattered back into
    ``lane_tok`` at ``scatter_lane`` (``num_lanes`` = drop)."""
    kind: str                      # "prefill" | "decode" | "packed"
    batch: Dict[str, object]
    lane_mask: np.ndarray          # (num_lanes,) bool; unused for packed
    plan: StepPlan
    samples: List[Tuple[Request, bool, Tuple[int, ...]]]
    tp: int                        # planned prefill tokens
    td: int                        # planned decode tokens
    feed: np.ndarray               # (R,) int32 column-0 token source
    row_lane: np.ndarray           # (R,) int32 lane backing each row
    scatter_lane: np.ndarray       # (n_slots,) int32 lane per sample slot


# the per-row planes of an async step beside its batch (``_host_inputs``)
_PLANES = ("lane_mask", "feed", "row_lane", "scatter_lane")


def _host_inputs(sb: StepBatch) -> Dict[str, np.ndarray]:
    return dict(sb.batch, lane_mask=sb.lane_mask, feed=sb.feed,
                row_lane=sb.row_lane, scatter_lane=sb.scatter_lane)


class _StepRunner:
    """One step shape of the async pipeline (a key of the bucket lattice).

    Its static inputs are int32 views into one device buffer (each view
    starting on 64 bytes), allocated before any capture, so a step's host
    arrays reach the device in ONE copy: without blocking from a pinned
    staging buffer of the ring slot the frontend names (a slot is reused
    only after the step that last used it was emitted, so a copy from it
    is never still queued), else a blocking copy. On CUDA the runner holds
    a ``torch.cuda.CUDAGraph`` captured from ``Engine._async_step`` over
    those inputs, the persistent pool and ``lane_tok``; ``run`` replays
    it and adds the kernel launches counted during its capture to
    ``cuda.LAUNCHES``. On the CPU the same body runs eagerly on the same
    buffers. ``logits`` and ``toks`` are the step's
    outputs (on CUDA, the graph's static outputs, rewritten by each
    replay)."""

    def __init__(self, eng: "Engine", kind: str,
                 host: Dict[str, np.ndarray]):
        self.eng, self.kind = eng, kind
        self._offs: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        n = 0
        for k in sorted(host):
            self._offs[k] = (n, host[k].shape)
            n += -(-host[k].size // 16) * 16
        self._flat = torch.zeros(n, dtype=torch.int32, device=eng.device)
        self.inputs = {k: self._flat[o:o + int(np.prod(sh))].view(sh)
                       for k, (o, sh) in self._offs.items()}
        self._staging: Dict[int, torch.Tensor] = {}
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.logits = self.toks = None

    def load(self, host: Dict[str, np.ndarray],
             slot: Optional[int] = None) -> None:
        """Copy a step's host arrays into the static inputs: through ring
        slot ``slot``'s pinned staging buffer on CUDA, else directly."""
        if slot is None or self._flat.device.type != "cuda":
            buf = torch.zeros(self._flat.shape, dtype=torch.int32)
        else:
            buf = self._staging.get(slot)
            if buf is None:
                buf = self._staging[slot] = torch.zeros(
                    self._flat.shape, dtype=torch.int32, pin_memory=True)
        a = buf.numpy()
        for k, (o, sh) in self._offs.items():
            a[o:o + int(np.prod(sh))] = host[k].reshape(-1)
        self._flat.copy_(buf, non_blocking=slot is not None)

    def body(self):
        return self.eng._async_step(self.kind, self.inputs)

    def capture(self, pool, stream) -> None:
        """Capture the body into a CUDA graph on ``stream`` (the one its
        eager warm-up ran on), with the shared memory ``pool``. A capture
        that fails raises: nothing runs eagerly in place of a replay."""
        from repro_torch.kernels import cuda
        g = torch.cuda.CUDAGraph()
        with cuda.capture_launches() as launches:
            with torch.cuda.graph(g, pool=pool, stream=stream):
                self.logits, self.toks = self.body()
        self.graph, self.launches = g, launches

    def run(self):
        if self.graph is None:
            self.logits, self.toks = self.body()
        else:
            from repro_torch.kernels import cuda
            self.graph.replay()
            cuda.add_launches(self.launches)
        return self.logits, self.toks


class Engine:
    def __init__(self, model_cfg: ModelConfig, coopt: CoOptConfig = COOPT,
                 engine_cfg: EngineConfig = EngineConfig(), params=None,
                 device="cuda", mesh=None):
        """``device``: "cuda" (default) or "cpu"; without CUDA the default
        raises. ``params``: the model's parameter dict on ``device`` (None =
        random init from ``engine_cfg.seed``). ``mesh``: a ``launch.mesh``
        mesh; the pool's shard count is DERIVED from its pages axes
        (``kv_shard_count``): a default ``num_shards`` of 1 takes it, and a
        conflicting explicit value raises. With ``coopt.use_kernel`` each
        page range is then a pool of its own on the mesh's device for it
        (all on ``device`` where the mesh names none; its first device must
        be ``device``, the controller) and the kernels run per shard
        (``kernels.sharded``)."""
        self.device = check_device(device)
        self.cfg = model_cfg
        self.coopt = coopt
        ccfg = engine_cfg.cache_config(coopt.page_size)
        if mesh is not None:
            from repro_torch.launch.mesh import kv_shard_count
            for d in mesh.devices or ():
                if d.type != self.device.type:
                    raise ValueError(f"the mesh is on {d}, the engine on "
                                     f"{self.device}")
            if mesh.devices and canonical_device(mesh.devices[0]) != \
                    canonical_device(self.device):
                raise ValueError(f"the mesh's first shard is on "
                                 f"{mesh.devices[0]}; the controller (the "
                                 f"engine's device) is {self.device}")
            ns = kv_shard_count(mesh)
            if ccfg.num_shards == 1:
                # config built before the mesh: derive the shard count
                ccfg = ccfg.replace(num_shards=ns)
            elif ccfg.num_shards != ns:
                raise ValueError(
                    f"EngineConfig.num_shards={ccfg.num_shards} "
                    f"disagrees with the mesh's KV shard count {ns} "
                    f"(pages axes {mesh.shape}); build the config "
                    "from launch.mesh.kv_shard_count(mesh) or leave it at "
                    "the default to derive it")
        if engine_cfg.num_shards != ccfg.num_shards:
            engine_cfg = dataclasses.replace(engine_cfg,
                                             num_shards=ccfg.num_shards)
        self.ccfg = ccfg
        self.ecfg = engine_cfg
        # the page-range shard context of the kernels (None without a
        # mesh, for an unsharded mesh, or off the kernel path: the
        # unsharded code path on one pool)
        self._kernel_ctx = (ops.make_mesh_ctx(mesh, self.device)
                            if coopt.use_kernel else None)
        # raises for the families not ported
        self.model = get_model(model_cfg)
        # recurrent-state families: the batch-major leaves that carry a
        # lane's state across chunks
        self._rec_leaves = tuple(getattr(self.model, "recurrent_leaves", ()))
        # concat-prefill packing works where "length" is the only
        # batch-major leaf (rows decouple from lanes): dense/moe/mla. vlm's
        # patch stubs, whisper's cross K/V and the recurrent families'
        # state are per lane.
        if engine_cfg.pack_prefill and (
                model_cfg.family not in ("dense", "moe", "mla")
                or self._rec_leaves):
            raise ValueError(
                f"pack_prefill unsupported for family {model_cfg.family!r}"
                " (per-lane batch-major cache state)")
        # the vlm patch-stub prefix: the scheduler's extra positions, and
        # the zero patch embeddings every prefill step reads
        self._patch_offset = (model_cfg.num_patches
                              if model_cfg.family == "vlm" else 0)
        self._patches = (torch.zeros(
            (engine_cfg.num_lanes, self._patch_offset, model_cfg.d_model),
            dtype=torch.bfloat16, device=self.device)
            if self._patch_offset else None)
        # whisper: the zero frame embeddings a first-chunk prefill step
        # encodes, at a fixed address like the vlm patches
        self._frames = (torch.zeros(
            (engine_cfg.num_lanes, model_cfg.num_frames, model_cfg.d_model),
            dtype=torch.bfloat16, device=self.device)
            if model_cfg.family == "whisper" else None)
        if params is None:
            params = self.model.init(engine_cfg.seed, self.device)
        self.params = params
        self.gen = torch.Generator(device=self.device).manual_seed(
            engine_cfg.seed + 1)

        B, M = engine_cfg.num_lanes, engine_cfg.max_len
        # the pool's pages axis is padded to split evenly into the shards
        # (host page ids == device page ids, core.opt_kv.pool_layout); under
        # a shard context each range is a pool of its own on its device
        self.cache = self.model.init_cache(
            B, M, coopt, num_shards=ccfg.num_shards, cache_cfg=ccfg,
            device=self.device, shard_devices=(
                self._kernel_ctx.devices if self._kernel_ctx else None))
        # the batch-major leaves (length, recurrent state) and their batch
        # axis: a step writes them under its lane mask; the pool leaves are
        # isolated by slot disjointness
        shapes = self.model.cache_shape(B, M, coopt, cache_cfg=ccfg)
        self._batch_axis = {k: axes.index("batch")
                            for k, (_, _, axes) in shapes.items()
                            if "batch" in axes}
        # recurrent families: chunk ends land on page boundaries, so the
        # state after a chunk can be snapshotted as the prefix cache's
        # resume artifact (KV pages alone cannot resume a recurrence)
        self.scheduler = Scheduler(
            B, M, coopt.page_size, list(engine_cfg.prefill_buckets),
            extra_tokens=self._patch_offset,
            token_budget=engine_cfg.token_budget or None,
            page_aligned=bool(self._rec_leaves),
            max_preemptions=engine_cfg.max_preemptions, cache_cfg=ccfg)
        # chain hash of a prefix's pages -> the lane state after it, as
        # device tensors (the snapshots); the manager's prefix_gate stops
        # page matching at the deepest boundary that can be restored
        self._state_cache: "OrderedDict[int, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        if self._rec_leaves:
            self.scheduler.manager.prefix_gate = self._state_cache.__contains__
        # deterministic fault-injection hooks (serving.faults); None in
        # production, a seeded FaultInjector in the chaos tests
        self.faults = None
        self.stats = EngineStats()
        self.stats.pool_pages = self.scheduler.manager.num_pages

        # the host-DRAM tier: pool leaves are addressed page-wise along
        # their "pages" axis; batch-major leaves (recurrent state, whisper's
        # cross K/V) have no page identity and never spill
        self._pool_axis = {k: axes.index("pages")
                           for k, (_, _, axes) in shapes.items()
                           if "pages" in axes}
        self._prefetch_flights: List[_Flight] = []
        self._sched_turn = 0
        if ccfg.host_pages > 0 and self._pool_axis:
            self.scheduler.manager.spill_sink = self._spill_page
            self.scheduler.prefetcher = self._start_prefetch
            self.scheduler.prefetch_tick = self._tick_prefetch
        self.stats.host_pages = ccfg.host_pages

        # async pipeline state: the device-resident per-lane token feed
        # (its last entry takes the dropped samples), the step runners by
        # lattice key and the graphs' shared memory pool
        self.lane_tok = torch.zeros(B + 1, dtype=torch.int32,
                                    device=self.device)
        self._runners: Dict[tuple, _StepRunner] = {}
        self._graph_pool = None
        self.graph_pool_bytes = 0             # memory the captures reserved
        self.aot_misses = 0                   # async steps with no runner
        self.trace_counts: Dict[str, int] = {}  # runners built per kind
        # the serving loop's spans and records (serving/trace.py); None: off
        self.recorder: Optional[StepRecorder] = None

    # ---------------------------------------------------------- step bodies --
    def _forward(self, kind: str, batch, lane_mask: torch.Tensor):
        """One model call for the whole step. The pool is updated in place;
        every batch-major leaf (``length``, a recurrent model's state) is
        lane-masked and written into its persistent tensor, in place (the
        JAX package's ``_mask_lanes``; pool writes are slot-disjoint). A
        packed step's rows are not lanes: ``length`` keeps its value (the
        JAX package's ``_prefill_packed_impl``), and its logits are (R, G,
        V). A vlm prefill step reads the engine's zero patch embeddings, a
        whisper step with ``cross_mask`` its zero frames. A leaf the step
        left as it was (whisper's cross K/V without a first chunk) is not
        rewritten."""
        cache = dict(self.cache)
        if self._patches is not None and kind == "prefill":
            batch = dict(batch, patches=self._patches)
        if self._frames is not None and "cross_mask" in batch:
            batch = dict(batch, frames=self._frames)
        fn = self.model.decode_step if kind == "decode" else \
            self.model.prefill
        with ops.mesh_ctx_scope(self._kernel_ctx):
            logits, cache = fn(self.params, batch, cache, self.coopt,
                               long_window=self.ecfg.long_window)
        if kind != "packed":
            for name, ax in self._batch_axis.items():
                leaf = self.cache[name]
                if cache[name] is leaf:
                    continue
                m = lane_mask.reshape((1,) * ax + (-1,)
                                      + (1,) * (leaf.dim() - ax - 1))
                leaf.copy_(select(m, cache[name], leaf))
        return logits

    def _run_model(self, sb: StepBatch):
        return self._forward(sb.kind, sb.batch, torch.as_tensor(
            sb.lane_mask, device=self.device))

    def _sample_device(self, logits) -> torch.Tensor:
        sp = self.ecfg.sampling
        return sample(logits, self.gen, temperature=sp.temperature,
                      top_k=sp.top_k, top_p=sp.top_p)

    def _sample(self, logits) -> np.ndarray:
        return self._sample_device(logits).cpu().numpy()

    def _emit(self, req: Request, tok: int, now: float, first: bool) -> bool:
        """Deliver one sampled token; False when it is dropped because the
        request already terminated (cancelled, rejected, shed, errored) or
        is done (the async pipeline's <= 1-step EOS overrun)."""
        if req.inflight > 0:
            req.inflight -= 1
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
            if not r.done():
                continue
            if r.state is RequestState.PREEMPTED:
                # async pipeline edge: preempted while its LAST tokens were
                # still in flight; their emission just completed it, so it
                # must never re-admit. Its pages were already freed.
                if r in self.scheduler.waiting:
                    self.scheduler.waiting.remove(r)
                r.state = RequestState.FINISHED
                r.finish(FinishReason.FINISHED)
            elif r.state is RequestState.RUNNING:
                self.scheduler.finish(r)
            else:
                continue
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
        s.deadline_shed = self.scheduler.deadline_shed
        s.preemption_limit_rejects = self.scheduler.preemption_limit_rejects
        # per-shard health (the pool's page ranges)
        n = mgr.num_shards
        s.num_shards = n
        s.shard_pages = tuple(mgr.shard_capacity(i) for i in range(n))
        s.shard_pages_in_use = tuple(mgr.pages_in_use_in(i)
                                     for i in range(n))
        peak = s.peak_shard_pages_in_use or (0,) * n
        s.peak_shard_pages_in_use = tuple(
            max(p, u) for p, u in zip(peak, s.shard_pages_in_use))
        s.shard_preemptions = tuple(self.scheduler.preemptions_by_shard)
        s.placement_prefix_hits = self.scheduler.placement_prefix_hits
        s.placement_misses = self.scheduler.placement_misses
        # the host-DRAM tier
        s.prefix_device_hits = mgr.prefix_device_hits
        s.prefix_host_hits = mgr.prefix_host_hits
        s.host_pages = mgr.host_pages
        s.host_pages_resident = mgr.host_resident_pages
        s.spilled_pages = mgr.spilled_pages
        s.host_evictions = mgr.host_evictions
        s.prefetch_begun = mgr.prefetch_begun
        s.prefetch_committed = mgr.prefetch_committed
        s.prefetch_aborted = mgr.prefetch_aborted
        s.prefetches_planned = self.scheduler.prefetches_planned
        s.prefetch_held_turns = self.scheduler.prefetch_held_turns
        s.prefetch_replans = self.scheduler.prefetch_replans

    # ----------------------------------------------- the host-DRAM tier --
    def _pool_page(self, name: str, page: int) -> torch.Tensor:
        """Global page ``page`` of pool leaf ``name``: a view of the pool,
        or of the shard's own pool at its local index (``ShardedPool``)."""
        leaf = self.cache[name]
        if isinstance(leaf, ShardedPool):
            return leaf.page(page)
        return leaf.select(self._pool_axis[name], page)

    def _read_pool_page(self, page: int) -> Dict[str, torch.Tensor]:
        """Page ``page`` of every pool leaf, as views of the pool."""
        return {k: self._pool_page(k, page) for k in self._pool_axis}

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``. On the card: into memory pinned for
        ``t``'s card, enqueued on that card's current (step) stream without
        blocking; the caching host allocator keeps the buffer until the
        copy has run. On the CPU: a plain copy."""
        if t.device.type != "cuda":
            return t.clone()
        with torch.cuda.device(t.device):
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
        return out

    def _write_pool_page(self, name: str, page: int,
                         data: torch.Tensor) -> None:
        """Write ``data`` into page ``page`` of pool leaf ``name``, IN PLACE
        (captured graphs read the pool at fixed addresses)."""
        self._pool_page(name, page).copy_(data, non_blocking=True)

    def _write_pool_page_q(self, name: str, page: int, q: torch.Tensor,
                           scale: torch.Tensor) -> None:
        """An fp8-encoded host leaf (``CacheConfig.host_quant``): upload the
        codes and scales, dequantize on the page's device into the staging
        page."""
        dst = self._pool_page(name, page)
        q = q.to(dst.device, non_blocking=True)
        scale = scale.to(dst.device, non_blocking=True)
        dst.copy_(dequantize_fp8(q, scale, dtype=dst.dtype))

    def _spill_page(self, h: int, page: int, shard: int):
        """The BlockManager's spill sink: rescue an LRU-evicted prefix page
        to host memory. Returns the host payload, or None to let the page
        die (fault injection). ``page`` is a global page id, read from its
        shard's own pool under a mesh. Safe without a host sync: the copies
        are enqueued on the step stream now (the page's card's current
        stream), during the scheduling turn that evicts the page, so they
        run after every step already enqueued (the last that wrote the page
        among them) and before any step this turn or later plans onto the
        page."""
        if self.faults is not None and not self.faults.on_spill():
            return None
        hp = encode_host_page(self._read_pool_page(page),
                              quantize=self.ccfg.host_quant)
        return HostPage({k: self._to_host(v) for k, v in hp.leaves.items()},
                        {k: self._to_host(v) for k, v in hp.scales.items()},
                        hp.encoded)

    def _upload_page(self, hp: HostPage, page: int) -> None:
        """Write a host payload into reserved staging page ``page``, in
        place. Enqueued on the step stream of the page's card, after the
        payload's own spill copy, so it needs no host sync either; the page
        is a staging page (no live request reads it) until its flight
        commits. A payload may have been spilled from another card's shard:
        across cards, the page's stream first waits for the work queued on
        every other card (its spill copy among it)."""
        ctx = self._kernel_ctx
        if cards(ctx) > 1:
            dst = self._pool_page(next(iter(self._pool_axis)), page).device
            here = torch.cuda.current_stream(dst)
            for d in set(ctx.devices) - {dst}:
                here.wait_stream(torch.cuda.current_stream(d))
        for k in self._pool_axis:
            if k in hp.scales:
                self._write_pool_page_q(k, page, hp.leaves[k], hp.scales[k])
            else:
                self._write_pool_page(k, page, hp.leaves[k])

    def _start_prefetch(self, req: Request, match: PrefixMatch) -> List[int]:
        """The scheduler's prefetcher: start host-to-device uploads for the
        pages of a queued request's matched prefix that are not on the
        device. Returns the chain hashes whose landing gates the request's
        admission (an upload already in flight is ridden, not repeated)."""
        mgr = self.scheduler.manager
        keys: List[int] = []
        for mp in match.pages:
            if mp.residency is PageResidency.DEVICE:
                continue
            if mp.residency is PageResidency.IN_FLIGHT:
                keys.append(mp.hash)      # ride the existing upload
                continue
            try:
                page, payload = mgr.begin_prefetch(mp.hash, match.shard)
            except OutOfBlocks:
                break   # no staging page free: admit on what has landed
            except KeyError:
                break   # raced off the host store since match_prefix
            ok, delay = (True, 0) if self.faults is None else \
                self.faults.on_prefetch()
            self._upload_page(payload, page)
            self._prefetch_flights.append(_Flight(
                hash=mp.hash, turn=self._sched_turn,
                # the injected delay is a host int of the fault plan
                # coopt: allow[COOPT001]
                lands=self._sched_turn + 1 + max(int(delay), 0), ok=ok))
            keys.append(mp.hash)
        return keys

    def _tick_prefetch(self) -> None:
        """The scheduler's prefetch_tick, at the top of every turn: advance
        the turn clock and settle the flights that landed. A flight
        dispatched on turn T commits no earlier than turn T+1; its upload
        was enqueued on the step stream before any step planned after the
        commit, so such a step reads the staged page."""
        self._sched_turn += 1
        if not self._prefetch_flights:
            return
        mgr = self.scheduler.manager
        still: List[_Flight] = []
        for f in self._prefetch_flights:
            if self._sched_turn < f.lands:
                still.append(f)
                continue
            if f.ok:
                mgr.commit_prefetch(f.hash)
            else:
                mgr.abort_prefetch(f.hash)
        self._prefetch_flights = still

    def _abort_prefetch_flights(self) -> None:
        """Return every in-flight staging page to the free list (the
        payloads go back to the host store: the upload is abandoned, not
        lost)."""
        mgr = self.scheduler.manager
        for f in self._prefetch_flights:
            mgr.abort_prefetch(f.hash)
        self._prefetch_flights = []

    def _should_pack(self, plan: StepPlan) -> bool:
        return self.ecfg.pack_prefill and bool(plan.prefill)

    def _note_sharing(self, rows: np.ndarray) -> None:
        """Cross-lane prefix-sharing counts for one decode step (the dedup
        the visit-list kernel performs on the device)."""
        st = sharing_stats(rows)
        self.stats.shared_page_visits += st["shared_page_visits"]
        self.stats.dup_page_streams_saved += st["dup_page_streams_saved"]

    # ------------------------------------------------- recurrent snapshots --
    def _lane_index(self, leaf: str, lane: int):
        return (slice(None),) * self._batch_axis[leaf] + (lane,)

    def _reset_or_restore_state(self, chunks: List[PrefillChunk]) -> None:
        """First chunk of a (re)admitted request on a recurrent family: the
        lane's state leaves hold the PREVIOUS occupant's state. Zero them,
        or restore the snapshot matching the prefix-cache hit (``start >
        0`` implies the manager's prefix_gate found one). Device copies into
        the persistent leaves, on the current stream: ordered before the
        step that reads them and after every step already enqueued."""
        ps = self.scheduler.page_size
        for c in chunks:
            if not c.first:
                continue
            # (re)seed the request's running chain hash at its resume point
            c.req.prefix_hash_pages = c.start // ps
            c.req.prefix_hash = chain_hash_tokens(
                c.req.effective_prompt(), c.req.prefix_hash_pages, ps)
            snap = None
            if c.start > 0:
                snap = self._state_cache[c.req.prefix_hash]
                self._state_cache.move_to_end(c.req.prefix_hash)
            for leaf in self._rec_leaves:
                dst = self.cache[leaf][self._lane_index(leaf, c.req.lane)]
                if snap is None:
                    dst.zero_()
                else:
                    dst.copy_(snap[leaf])

    def _snapshot_state(self, c: PrefillChunk) -> None:
        """A chunk that ended exactly on a page boundary leaves the lane's
        recurrent state at a committed-prefix resume point: keep a copy of
        it under the chain hash its pages were registered with. The copy is
        a device clone enqueued after the step that produced the state, so
        the async pipeline's host loop never waits for it."""
        ps = self.scheduler.page_size
        end = c.start + c.n
        if end % ps or not self.ccfg.enable_prefix_cache:
            return
        # extend the request's running hash; never rehash from page 0
        key = extend_chain_hash(c.req.prefix_hash, c.req.effective_prompt(),
                                c.req.prefix_hash_pages, end // ps, ps)
        c.req.prefix_hash, c.req.prefix_hash_pages = key, end // ps
        if key in self._state_cache:
            self._state_cache.move_to_end(key)
            return
        self._state_cache[key] = {
            leaf: self.cache[leaf][self._lane_index(leaf, c.req.lane)].clone()
            for leaf in self._rec_leaves}
        while len(self._state_cache) > self.ecfg.state_cache_entries:
            self._state_cache.popitem(last=False)

    # --------------------------------------------------- the ONE step path --
    def _build_step(self, plan: StepPlan,
                    device_feed: bool = False) -> StepBatch:
        """The whole step's static-shape index arrays from the plan: ONE
        construction path for the sync loop and the async pipeline. The
        sync loop gets them as tensors on the engine's device. With
        ``device_feed`` (the async pipeline) they stay numpy arrays, and
        decode rows take their input token from the device-resident lane
        feed (-1) instead of a host value, so the plan can be built before
        the previous step's tokens reach the host; a decode-only step then
        carries its per-lane metadata as ONE (3, B) ``dmeta`` array
        (positions, slots, cache lengths). With ``pack_prefill`` a step
        with prefill chunks is built as packed rows (``_build_packed``). A
        recurrent model's lanes that start a request are reset or restored
        first, and its prefill steps carry ``pad_mask`` (B, S), the real
        columns of each lane."""
        if self._rec_leaves and plan.prefill:
            self._reset_or_restore_state(plan.prefill)
        if self._should_pack(plan):
            return self._build_packed(plan, device_feed)
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
        pad_mask = np.zeros((B, S), bool)
        last_pos = np.zeros(B, np.int32)
        feed = np.full(B, -2, np.int32)
        scatter_lane = np.full(B, B, np.int32)        # B = drop
        samples: List[Tuple[Request, bool, Tuple[int, ...]]] = []

        off = self._patch_offset
        for c in plan.prefill:
            lane, n = c.req.lane, c.n
            # token column j holds position start+j; the columns inside the
            # vlm patch-stub prefix carry a placeholder id (the model swaps
            # in the patch embedding by position)
            pcols = min(max(off - c.start, 0), n)
            tokens[lane, pcols:pcols + len(c.tokens)] = c.tokens
            positions[lane] = np.minimum(c.start + np.arange(S),
                                         c.start + n - 1)
            slot_idx[lane, :n] = mgr.slot_indices(
                c.req.pool_id, np.arange(c.start, c.start + n))
            page_table[lane] = self.scheduler.page_table(c.req)
            cache_len[lane] = c.start + n
            pad_mask[lane, :n] = True
            last_pos[lane] = n - 1
            lane_mask[lane] = True
            if c.final:
                samples.append((c.req, True, (lane,)))
                scatter_lane[lane] = lane
        for d in plan.decode:                          # a chunk of length 1
            lane = d.req.lane
            tokens[lane, 0] = d.req.output[-1] if d.req.output else 0
            positions[lane] = d.pos
            slot_idx[lane, 0] = d.slot
            page_table[lane] = self.scheduler.page_table(d.req)
            cache_len[lane] = d.pos + 1
            pad_mask[lane, 0] = True
            last_pos[lane] = 0
            lane_mask[lane] = True
            samples.append((d.req, False, (lane,)))
            scatter_lane[lane] = lane
            if device_feed:
                feed[lane] = -1        # device lane feed, never host-sync
        if len(plan.decode) > 1:
            self._note_sharing(page_table[[d.req.lane for d in plan.decode]])

        kind = "prefill" if plan.prefill else "decode"
        if device_feed and kind == "decode":
            batch = {"dmeta": np.stack([positions[:, 0], slot_idx[:, 0],
                                        cache_len]),
                     "page_table": page_table,
                     "token": np.zeros_like(tokens)}
        else:
            batch = {"positions": positions, "slot_idx": slot_idx,
                     "page_table": page_table, "cache_len": cache_len}
            if kind == "prefill":
                batch.update(tokens=tokens, last_pos=last_pos)
                if self._rec_leaves:
                    batch["pad_mask"] = pad_mask
                if self._frames is not None:
                    # cross K/V are computed ONCE per request, on its first
                    # chunk; a step without one skips the encoder
                    firsts = np.zeros(B, bool)
                    for c in plan.prefill:
                        firsts[c.req.lane] |= c.first
                    if firsts.any():
                        batch["cross_mask"] = firsts
            else:
                batch["token"] = tokens
            if not device_feed:
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch.items()}
        return StepBatch(kind=kind, batch=batch, lane_mask=lane_mask,
                         plan=plan, samples=samples,
                         tp=sum(c.n for c in plan.prefill),
                         td=len(plan.decode), feed=feed,
                         row_lane=np.arange(B, dtype=np.int32),
                         scatter_lane=scatter_lane)

    def _build_packed(self, plan: StepPlan,
                      device_feed: bool = False) -> StepBatch:
        """Concat-prefill packing: several prompts' chunks share one row as
        SEGMENTS, with per-row segment ids (``seg_q``/``page_seg``) and
        per-segment logical page indices (``page_base``) for the
        segment-aware chunk kernels, so attention cannot leak across packed
        prompts. Decode items keep one row each (their token feeds the
        async lane plumbing); rows are padded to a power-of-two bucket, so
        short-prompt steps run with FEWER rows than lanes. A row's
        ``cache_len`` is its occupied query columns. Numpy arrays with
        ``device_feed``, tensors on the engine's device without."""
        ps = self.coopt.page_size
        NP = self.scheduler.pages_per_lane
        G = self.ecfg.pack_slots
        mgr = self.scheduler.manager

        S = (bucket_len(max(c.n for c in plan.prefill),
                        self.scheduler.prefill_buckets) or
             max(c.n for c in plan.prefill))
        rows = pack_rows(plan.prefill, S, G, NP, ps)
        n_rows = len(plan.decode) + len(rows)
        R = 1
        while R < n_rows:
            R *= 2
        R = min(R, max(self.ecfg.num_lanes, n_rows))
        B = self.ecfg.num_lanes

        tokens = np.zeros((R, S), np.int32)
        positions = np.zeros((R, S), np.int32)
        seg_q = np.full((R, S), -1, np.int32)        # -1 matches no page
        slot_idx = np.full((R, S), -1, np.int32)
        page_table = np.full((R, NP), -1, np.int32)
        page_seg = np.zeros((R, NP), np.int32)
        page_base = np.zeros((R, NP), np.int32)
        cache_len = np.zeros(R, np.int32)
        last_pos = np.zeros((R, G), np.int32)
        feed = np.full(R, -2, np.int32)
        row_lane = np.zeros(R, np.int32)
        scatter_lane = np.full(R * G, B, np.int32)   # num_lanes = drop
        samples: List[Tuple[Request, bool, Tuple[int, ...]]] = []

        for i, d in enumerate(plan.decode):          # one row per decode
            tokens[i, 0] = d.req.output[-1] if d.req.output else 0
            positions[i] = d.pos
            seg_q[i, 0] = 0
            slot_idx[i, 0] = d.slot
            page_table[i] = self.scheduler.page_table(d.req)
            page_base[i] = np.arange(NP)
            cache_len[i] = d.pos + 1
            row_lane[i] = d.req.lane
            scatter_lane[i * G] = d.req.lane
            samples.append((d.req, False, (i, 0)))
            if device_feed:
                feed[i] = -1
        if len(plan.decode) > 1:
            self._note_sharing(page_table[:len(plan.decode)])

        for j, row in enumerate(rows):
            r = len(plan.decode) + j
            t = pcur = g = 0
            for k, c in enumerate(row.chunks):
                n, npg = c.n, chunk_pages(c, ps)
                tokens[r, t:t + n] = c.tokens
                positions[r, t:t + n] = c.start + np.arange(n)
                seg_q[r, t:t + n] = k
                slot_idx[r, t:t + n] = mgr.slot_indices(
                    c.req.pool_id, np.arange(c.start, c.start + n))
                page_table[r, pcur:pcur + npg] = \
                    self.scheduler.page_table(c.req)[:npg]
                page_seg[r, pcur:pcur + npg] = k
                page_base[r, pcur:pcur + npg] = np.arange(npg)
                if c.final:
                    last_pos[r, g] = t + n - 1
                    scatter_lane[r * G + g] = c.req.lane
                    samples.insert(g + sum(x.finals for x in rows[:j]),
                                   (c.req, True, (r, g)))
                    g += 1
                t += n
                pcur += npg
            cache_len[r] = t
            row_lane[r] = row.chunks[0].req.lane

        # prefill finals emit BEFORE decode tokens (the unpacked emission
        # order)
        samples.sort(key=lambda s: not s[1])

        batch = {"positions": positions, "slot_idx": slot_idx,
                 "page_table": page_table, "cache_len": cache_len,
                 "tokens": tokens, "last_pos": last_pos, "seg_q": seg_q,
                 "page_seg": page_seg, "page_base": page_base}
        if not device_feed:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
        self.stats.packed_steps += 1
        self.stats.packed_rows_saved += max(
            len(plan.decode) + len(plan.prefill) - R, 0)
        return StepBatch(kind="packed", batch=batch,
                         lane_mask=np.ones(B, bool), plan=plan,
                         samples=samples,
                         tp=sum(c.n for c in plan.prefill),
                         td=len(plan.decode), feed=feed, row_lane=row_lane,
                         scatter_lane=scatter_lane)

    def _execute(self, sb: StepBatch):
        """Run the step and wait for it; book its wall time by planned token
        share (a prefill-heavy mixed step must not count as decode time)."""
        if self.faults is not None:
            self.faults.before_execute(sb)
        t0 = time.perf_counter()
        logits = self._run_model(sb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._book_time(sb, time.perf_counter() - t0)
        return logits

    def _book_time(self, sb: StepBatch, dt: float) -> None:
        width = 1 if sb.kind == "decode" else sb.batch["slot_idx"].shape[1]
        rows = sb.feed.size * width
        self.stats.step_rows += rows
        self.stats.padded_rows += rows - sb.tp - sb.td
        share = dt / max(sb.tp + sb.td, 1)
        if sb.tp:
            self.stats.prefill_time += share * sb.tp
            self.stats.prefill_calls += 1
        if sb.td:
            self.stats.decode_time += share * sb.td
            self.stats.decode_steps += 1
        if sb.tp and sb.td:
            self.stats.mixed_steps += 1

    def _note_executed(self, sb: StepBatch) -> None:
        """Host metadata updates that must land before the NEXT plan is
        built and do not depend on sampled token values: advance prefill
        progress, register prefix pages, snapshot recurrent state, stamp
        the final prompt chunk's dispatch."""
        for c in sb.plan.prefill:
            self.scheduler.note_prefilled(c.req, c.n)
            if c.final and c.req.last_chunk_time < 0:
                c.req.last_chunk_time = time.perf_counter()
            if self._rec_leaves:
                self._snapshot_state(c)

    def _postprocess(self, sb: StepBatch, toks: np.ndarray,
                     now: float) -> None:
        """Route host-visible sampled tokens back to their requests and
        retire the finished ones."""
        for req, first, idx in sb.samples:
            self._emit(req, int(toks[idx]), now, first=first)
        self._finish_done([req for req, _, _ in sb.samples])

    def _run_mixed(self, plan: StepPlan) -> None:
        """One model call for the whole step: prefill chunks + decode tokens
        through the chunked-continuation path; a decode-only step takes the
        one-token decode path. With ``pack_prefill`` the prefill chunks run
        through the packed concat-prefill layout instead."""
        sb = self._build_step(plan)
        logits = self._execute(sb)
        toks = self._sample(logits)
        self._note_executed(sb)
        self._postprocess(sb, toks, time.perf_counter())

    # ------------------------------------------------- async step dispatch --
    def _async_step(self, kind: str, inp: Dict[str, torch.Tensor]):
        """One async-pipeline step over device tensors ``inp`` (the batch
        and ``_PLANES``): substitute column 0 of row i from
        ``lane_tok[row_lane[i]]`` (feed -1) or the host token (feed >= 0),
        run the model, lane-mask ``length`` (not in a packed step), and for
        greedy sampling take the argmax and scatter it into ``lane_tok``.
        Returns (logits, tokens); tokens is None at temperature > 0, where
        ``_dispatch_async`` samples after the step with the engine's
        generator, on the same stream. Captured into the step runners'
        graphs, so everything here stays on the device."""
        batch = {k: v for k, v in inp.items() if k not in _PLANES}
        if "dmeta" in batch:
            dm = batch.pop("dmeta")
            batch["positions"] = dm[0][:, None]
            batch["slot_idx"] = dm[1][:, None]
            batch["cache_len"] = dm[2]
        tok_key = "token" if kind == "decode" else "tokens"
        toks_in, feed = batch[tok_key], inp["feed"]
        t0 = torch.where(feed == -1, self.lane_tok[inp["row_lane"].long()],
                         torch.where(feed >= 0, feed, toks_in[:, 0]))
        batch[tok_key] = torch.cat([t0[:, None], toks_in[:, 1:]], dim=1)
        logits = self._forward(kind, batch, inp["lane_mask"] != 0)
        if not self.ecfg.sampling.greedy:
            return logits, None
        toks = sample(logits)
        self.lane_tok.index_copy_(0, inp["scatter_lane"].long(),
                                  toks.reshape(-1))
        return logits, toks

    @staticmethod
    def _async_key(kind: str, batch: Dict[str, np.ndarray]) -> tuple:
        """Step-runner key: the kind and every batch array's (name, shape,
        dtype); params and cache shapes are fixed per engine."""
        return (kind,) + tuple(sorted(
            (k, tuple(v.shape), v.dtype.str) for k, v in batch.items()))

    def _dispatch_async(self, sb: StepBatch,
                        slot: Optional[int] = None) -> torch.Tensor:
        """Dispatch one pipeline step WITHOUT waiting for it: the runner
        built for its key (a graph replay on CUDA); a key with no runner
        runs the body eagerly and counts an ``aot_misses``. ``slot`` names
        the ring slot whose pinned staging buffer the runner's inputs are
        copied from without blocking; only a caller that tracks the slot's
        event may pass it (the frontend). With None the copy blocks.
        Returns the sampled tokens on the device, int32: (B,) per lane, a
        packed step's (R, pack_slots)."""
        if self.faults is not None:
            self.faults.before_execute(sb)
        host = _host_inputs(sb)
        runner = self._runners.get(self._async_key(sb.kind, sb.batch))
        rec = self.recorder
        if rec is not None:
            t = time.perf_counter()
        if runner is not None:
            runner.load(host, slot)
            if rec is not None:
                t = rec.span("load", t, "dispatch")
            logits, toks = runner.run()
            if rec is not None:
                rec.span("launch", t, "dispatch")
            inp = runner.inputs
        else:
            self.aot_misses += 1
            inp = {k: torch.as_tensor(v, device=self.device)
                   for k, v in host.items()}
            logits, toks = self._async_step(sb.kind, inp)
            if rec is not None:
                rec.span("launch_eager", t, "dispatch")
        if toks is None:
            toks = self._sample_device(logits)
            self.lane_tok.index_copy_(0, inp["scatter_lane"].long(),
                                      toks.reshape(-1))
        self._book_time(sb, 0.0)      # step counters; async wall time is
        return toks                   # booked end to end by the caller

    # ------------------------------------------------ step-runner warmup --
    def _dummy_batch(self, kind: str, R: int, S: int,
                     whisper_first: bool = True) -> Dict[str, np.ndarray]:
        """A shape-exact stand-in for one async step's batch that touches
        no live pool state: every slot and page is -1, so the write kernel
        stores nothing and no page is read (a recurrent model's dummy steps
        do write its lanes' state, which a request's first chunk resets;
        whisper's run the encoder with an all-False ``cross_mask``, which
        keeps every lane's cross K/V)."""
        NP = self.scheduler.pages_per_lane
        table = np.full((R, NP), -1, np.int32)
        if kind == "decode":                 # the fused-dmeta schema
            dmeta = np.zeros((3, R), np.int32)
            dmeta[1] = -1
            return {"dmeta": dmeta, "page_table": table,
                    "token": np.zeros((R, S), np.int32)}
        batch = {"positions": np.zeros((R, S), np.int32),
                 "slot_idx": np.full((R, S), -1, np.int32),
                 "page_table": table, "cache_len": np.zeros(R, np.int32),
                 "tokens": np.zeros((R, S), np.int32)}
        if kind == "packed":
            batch.update(last_pos=np.zeros((R, self.ecfg.pack_slots),
                                            np.int32),
                         seg_q=np.full((R, S), -1, np.int32),
                         page_seg=np.zeros((R, NP), np.int32),
                         page_base=np.zeros((R, NP), np.int32))
        else:
            batch["last_pos"] = np.zeros(R, np.int32)
            if self._rec_leaves:
                batch["pad_mask"] = np.zeros((R, S), bool)
            if self._frames is not None and whisper_first:
                batch["cross_mask"] = np.zeros(R, bool)
        return batch

    def _warmup_lattice(self) -> List[Tuple[str, Dict[str, np.ndarray]]]:
        """Every step shape the async pipeline can dispatch: one decode
        shape, one prefill shape per bucket (whisper: with and without the
        first-chunk encoder, told apart by ``cross_mask`` in the runner's
        key) and, when packing, every (row bucket x prefill bucket) packed
        shape."""
        B = self.ecfg.num_lanes
        buckets = self.scheduler.prefill_buckets
        lattice = [("decode", self._dummy_batch("decode", B, 1))]
        for S in buckets:
            lattice.append(("prefill", self._dummy_batch("prefill", B, S)))
            if self._frames is not None:
                lattice.append(("prefill", self._dummy_batch(
                    "prefill", B, S, whisper_first=False)))
        if self.ecfg.pack_prefill:
            row_buckets = []
            r = 1
            while r < B:
                row_buckets.append(r)
                r *= 2
            row_buckets.append(B)
            for R in row_buckets:
                for S in buckets:
                    lattice.append(("packed",
                                    self._dummy_batch("packed", R, S)))
        return lattice

    def warmup(self) -> int:
        """Build one step runner for every shape of the bucket lattice, so
        steady-state serving never misses. Each shape first runs eagerly
        once (on CUDA on a side stream), which sets up every lazy state
        outside a capture: the kernel libraries, CUDA's lazily loaded
        modules, cuBLAS handles and workspaces, the decode kernels'
        counters. On CUDA each runner then captures its graph; all share
        one memory pool, since replays are serialized on one stream.
        Returns the number of runners built. The eager runs write the
        lanes' ``length`` leaf (and a recurrent model's state), so the
        engine must have no work."""
        if self.scheduler.has_work:
            raise RuntimeError("warmup() needs an engine with no work: its "
                               "dummy steps write the lanes' lengths")
        B = self.ecfg.num_lanes
        new = []
        for kind, batch in self._warmup_lattice():
            key = self._async_key(kind, batch)
            # a bucket listed twice (a max_len bucket equal to another) is
            # one shape: one runner
            if key in self._runners or any(key == k for k, _ in new):
                continue
            R = batch["page_table"].shape[0]
            n_slots = batch["last_pos"].size if kind == "packed" else R
            host = dict(batch, lane_mask=np.ones(B, bool),
                        feed=np.full(R, -2, np.int32),
                        row_lane=np.zeros(R, np.int32),
                        scatter_lane=np.full(n_slots, B, np.int32))
            runner = _StepRunner(self, kind, host)
            runner.load(host)
            new.append((key, runner))
        if self.device.type != "cuda":
            for _, runner in new:
                runner.run()
        else:
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _, runner in new:
                    runner.body()
            main.wait_stream(side)
            torch.cuda.synchronize(self.device)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            # a graph or event that dies during a capture (an unreachable
            # engine's, freed by the cycle collector) invalidates it: free
            # them first and keep the collector off while capturing
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            collecting = gc.isenabled()
            gc.disable()
            try:
                for _, runner in new:
                    runner.capture(self._graph_pool, side)
            finally:
                if collecting:
                    gc.enable()
            self.graph_pool_bytes += \
                torch.cuda.memory_reserved(self.device) - reserved
        # only runners whose graphs were all captured serve steps
        for key, runner in new:
            self._runners[key] = runner
            self.trace_counts[runner.kind] = \
                self.trace_counts.get(runner.kind, 0) + 1
        return len(new)

    # ---------------------------------------------------------------- API --
    def add_request(self, req: Request) -> None:
        req.enqueue_time = time.perf_counter()
        self.scheduler.add_request(req)

    def abort_all(self, exc: Optional[BaseException] = None) -> List[Request]:
        """Fault drain: terminate every live request with ERROR, returning
        the pool to zero pages in use."""
        drained = self.scheduler.abort_all(FinishReason.ERROR, exc)
        self.stats.errors += len(drained)
        self._abort_prefetch_flights()
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
