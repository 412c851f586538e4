"""Page-range shards over the pooled kernels, each shard a pool of its own.

The engine's pool is split along its ``pages`` axis into ``num_shards``
contiguous page ranges, one for each shard of a ``launch.mesh`` mesh's
``(pod, data)`` axes (``core.opt_kv.PAGES_AXES``); the scheduler keeps every
request's pages inside one range (``BlockManager.shard_page_ranges``).
Each pool leaf is a ``core.opt_kv.ShardedPool``: shard s is a tensor of its
own on the context's ``devices[s]`` (several shards may share a device, as
separate allocations). One controller, the device of the queries, holds
everything else. This module runs each kernel once per shard, UNCHANGED,
on that shard's device and pool only:

  * writes are shard-local: the GLOBAL flat slots are translated into the
    shard's slot range (``core.opt_kv.global_to_local_slots``), and every
    foreign or dropped slot becomes one PAST the range, which K1 and the
    latent scatter drop; no shard's last line is ever a sentinel;
  * for a read, the lanes' GLOBAL page tables are translated into the
    shard's LOCAL page domain (``core.opt_kv.global_to_local_pages``): other
    shards' pages and -1 holes become -1, which the kernels never read; a
    decode that takes the visit-list kernel plans its visits after the
    translation, so each shard's visits stay inside its range;
  * the shard's inputs (queries, translated tables, ``cache_len``, packing
    planes) are copied to its device, and its kernel launches there, on
    that device's current stream, returning its final online-softmax state
    (``return_state``: the normalized partial output and (m, l));
  * the partials are copied back to the controller and merged there in
    ascending shard order by the log-sum-exp rule, in plain PyTorch as the
    JAX package merges in jnp: m* = max_s m_s; w_s = exp(m_s - m*) l_s;
    out = sum_s w_s o_s / sum_s w_s. A shard holding none of a lane's pages
    reports (m = -1e30, l = 0) and weighs 0.

The merge starts from the partial outputs in the kernels' output dtype
(bf16 for K2-K4, f32 for the latent kernels), as the JAX package's does,
so sharded results differ from unsharded ones by the same rounding. Copies
between devices are exact, so where the shards sit changes no bit.

Nothing here syncs the host: a copy between two cards is ordered after the
work queued on the source's current stream and before the destination's
later work, so a step runs without waiting for the card. When every shard
shares the controller's device, the copies are no-ops and a CUDA graph
captures a step's launches and merge on one stream; the decode kernels'
arrival counters (``paged_gqa_decode._split_buffers``) are kept per device
and shared by the shards of one device, which is safe because their
launches run in order on that device's one stream.

``ops`` dispatches here while a ``ShardCtx`` is installed
(``ops.set_mesh_ctx``, ``ops.mesh_ctx_scope``); a mesh whose pages axes
have extent 1 gives no context (``make_ctx``), so it runs the unsharded
path unchanged.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.cache.quant import quantize_latent
from repro_torch.core.opt_kv import (PAGES_AXES, ShardedPool,
                                     global_to_local_pages,
                                     global_to_local_slots)
from repro_torch.kernels import flash_chunk_prefill as _fc
from repro_torch.kernels import kv_cache_write as _kw
from repro_torch.kernels import latent_chunk_prefill as _lc
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import paged_gqa_decode as _pd
from repro_torch.kernels import paged_latent_decode as _ld
from repro_torch.kernels import visits as _vs


@dataclass(frozen=True)
class ShardCtx:
    """The pages-axis split the wrappers dispatch on: the device of each
    page-range shard, in shard order."""
    devices: Tuple[torch.device, ...]

    @property
    def num_shards(self) -> int:
        return len(self.devices)


def canonical_device(device) -> torch.device:
    """``device`` with its index: "cuda" names the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_ctx(mesh, device=None) -> Optional[ShardCtx]:
    """The ShardCtx of ``mesh`` (its shards on ``mesh.devices``, or all on
    ``device`` where the mesh names none), or None when its pages axes
    (``PAGES_AXES``) have extent 1 (or there is no mesh): an unsharded mesh
    takes the unsharded path."""
    if mesh is None:
        return None
    n = math.prod(mesh.shape[a] for a in PAGES_AXES if a in mesh.shape)
    if n <= 1:
        return None
    devices = mesh.devices
    if devices is None:
        if device is None:
            raise ValueError("a mesh without devices needs the device its "
                             "shards share")
        devices = (device,) * n
    return ShardCtx(devices=tuple(canonical_device(d) for d in devices))


def cards(ctx: Optional[ShardCtx]) -> int:
    """The distinct CUDA devices the context's shards sit on (0 on the
    CPU)."""
    if ctx is None:
        return 0
    return len({d for d in ctx.devices if d.type == "cuda"})


def _on(device: torch.device):
    """Make ``device`` current for a launch (a kernel must launch with its
    stream's device current)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()


def _to(t, device):
    return None if t is None else t.to(device, non_blocking=True)


def _shards(ctx: ShardCtx, pool, what: str):
    """(device, shard tensor) of each shard of ``pool``, in shard order."""
    if not isinstance(pool, ShardedPool):
        raise TypeError(f"{what} under a shard context needs the pool as a "
                        f"core.opt_kv.ShardedPool, got {type(pool).__name__}")
    if pool.num_shards != ctx.num_shards:
        raise ValueError(f"{what}: a pool of {pool.num_shards} shards under "
                         f"a context of {ctx.num_shards}")
    return zip(ctx.devices, pool.shards)


def _lse_merge(parts, out_dtype, device):
    """Merge per-shard ``(o, m, l)`` partials, listed in ascending shard
    order, on ``device``: o (..., D) normalized in the kernel's output
    dtype, m and l (...) f32. Sums run in that order."""
    parts = [tuple(_to(x, device) for x in p) for p in parts]
    m_all = torch.stack([m for _, m, _ in parts]).amax(0)
    num = den = None
    while parts:                  # each partial freed once it is summed
        o, m, l = parts.pop(0)
        w = torch.exp(m - m_all) * l             # 0 for a page-less shard
        t = o.float() * w[..., None]
        del o
        if num is None:
            num, den = t, w
        else:
            num.add_(t)
            den = den + w
    return num.div_(den.clamp_min(1e-30)[..., None]).to(out_dtype)


def _i32(t):
    return t.to(torch.int32).contiguous()


def _split(sc):
    return (None, None) if sc is None else (sc[0], sc[1])


# ------------------------------------------------------------- reads --
def paged_pool_decode(ctx: ShardCtx, q, kv_pages, scale_pages, cache_len,
                      phys_table, log_table, *, opt_kv: bool, opt_gqa: bool,
                      window: int = 0, sink_pages: int = 0,
                      share_visits: bool = False):
    """Sharded ``ops.paged_pool_decode``: kv_pages a ShardedPool of (2,
    P_total, ps, Hkv, D), scale_pages one of (2, P_total, ps, Hkv) or None;
    GLOBAL tables; returns the merged (B, Hq, D) on q's device. With
    ``share_visits`` (and K4's plan fitting, as in ``ops``) each shard plans
    its visit list after the translation."""
    phys, log, cl = _i32(phys_table), _i32(log_table), _i32(cache_len)
    B, Hq, D = q.shape
    _, _, ps, Hkv, _ = kv_pages.shape
    per = kv_pages.pages_per_shard
    use_visits = _ops._gqa_use_visits(share_visits, B, Hq, Hkv, D, ps,
                                      opt_kv, opt_gqa)
    scales = (scale_pages.shards if scale_pages is not None
              else (None,) * ctx.num_shards)
    kw = dict(opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
              sink_pages=sink_pages, return_state=True)
    parts = []
    for s, (dev, kv) in enumerate(_shards(ctx, kv_pages, "paged_pool_decode")):
        ks, vs = _split(scales[s])
        lphys = global_to_local_pages(phys, s * per, per)
        with _on(dev):
            qs, cls, lphys, lg = (_to(x, dev) for x in (q, cl, lphys, log))
            if use_visits:
                vp, vm, vl = _vs.plan_visits(lphys, lg)
                parts.append(_pd.paged_pool_decode_visits(
                    qs, kv[0], kv[1], ks, vs, cls, vp, vm, vl, **kw))
            else:
                parts.append(_pd.paged_pool_decode(
                    qs, kv[0], kv[1], ks, vs, cls, lphys, lg, **kw))
    return _lse_merge(parts, q.dtype, q.device)


def paged_chunk_prefill(ctx: ShardCtx, q, positions, kv_pages, scale_pages,
                        phys_table, *, opt_kv: bool, opt_gqa: bool,
                        window: int = 0, sink_pages: int = 0, seg_q=None,
                        page_seg=None, page_base=None):
    """Sharded ``ops.paged_chunk_prefill``: chunk queries (B, S, Hq, D)
    against each shard's pool, partials merged on q's device. The packing
    planes are in the LOGICAL page domain, so they go to every shard
    untranslated; only the physical table is mapped into the shard's
    range."""
    per = kv_pages.pages_per_shard
    scales = (scale_pages.shards if scale_pages is not None
              else (None,) * ctx.num_shards)
    planes = [None if t is None else _i32(t)
              for t in (seg_q, page_seg, page_base)]
    phys, pos, q = _i32(phys_table), _i32(positions), q.contiguous()
    parts = []
    for s, (dev, kv) in enumerate(_shards(ctx, kv_pages,
                                          "paged_chunk_prefill")):
        ks, vs = _split(scales[s])
        lphys = global_to_local_pages(phys, s * per, per)
        with _on(dev):
            sq, sseg, sbase = (_to(t, dev) for t in planes)
            parts.append(_fc.flash_chunk_prefill(
                _to(q, dev), _to(pos, dev), kv[0], kv[1], ks, vs,
                _to(lphys, dev), opt_kv=opt_kv, opt_gqa=opt_gqa,
                window=window, sink_pages=sink_pages, seg_q=sq,
                page_seg=sseg, page_base=sbase, return_state=True))
    return _lse_merge(parts, q.dtype, q.device)


def paged_latent_decode(ctx: ShardCtx, q_lat, q_rope, lat_pages,
                        scale_pages, cache_len, phys_table, log_table, *,
                        sm_scale: float, opt_kv: bool, window: int = 0,
                        sink_pages: int = 0, share_visits: bool = False):
    """Sharded ``ops.paged_latent_decode``: the latent pool a ShardedPool of
    (P_total, ps, R+dr); returns the merged o_lat (B, H, R) f32 on
    q_lat's device. With ``share_visits`` each shard plans its visit list
    after the translation."""
    phys, log, cl = _i32(phys_table), _i32(log_table), _i32(cache_len)
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    per = lat_pages.pages_per_shard
    use_visits = _ops._use_visits(share_visits, q_lat.shape[0])
    scales = (scale_pages.shards if scale_pages is not None
              else (None,) * ctx.num_shards)
    kw = dict(sm_scale=sm_scale, opt_kv=opt_kv, window=window,
              sink_pages=sink_pages, return_state=True)
    parts = []
    for s, (dev, lat) in enumerate(_shards(ctx, lat_pages,
                                           "paged_latent_decode")):
        lphys = global_to_local_pages(phys, s * per, per)
        with _on(dev):
            ql, qr, cls, lphys, lg = (_to(x, dev) for x in
                                      (q_lat, q_rope, cl, lphys, log))
            if use_visits:
                vp, vm, vl = _vs.plan_visits(lphys, lg)
                parts.append(_ld.paged_latent_decode_visits(
                    ql, qr, lat, scales[s], cls, vp, vm, vl, **kw))
            else:
                parts.append(_ld.paged_latent_decode(
                    ql, qr, lat, scales[s], cls, lphys, lg, **kw))
    return _lse_merge(parts, torch.float32, q_lat.device)


def latent_chunk_prefill(ctx: ShardCtx, q_lat, q_rope, positions, lat_pages,
                         scale_pages, phys_table, *, sm_scale: float,
                         opt_kv: bool, window: int = 0, sink_pages: int = 0,
                         seg_q=None, page_seg=None, page_base=None):
    """Sharded ``ops.latent_chunk_prefill``: a chunk of absorbed queries
    against each shard's latent pool, partials merged; returns o_lat (B, S,
    H, R) f32 on q_lat's device. The packing planes go to every shard
    untranslated."""
    planes = [None if t is None else _i32(t)
              for t in (seg_q, page_seg, page_base)]
    phys, pos = _i32(phys_table), _i32(positions)
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    per = lat_pages.pages_per_shard
    scales = (scale_pages.shards if scale_pages is not None
              else (None,) * ctx.num_shards)
    parts = []
    for s, (dev, lat) in enumerate(_shards(ctx, lat_pages,
                                           "latent_chunk_prefill")):
        lphys = global_to_local_pages(phys, s * per, per)
        with _on(dev):
            sq, sseg, sbase = (_to(t, dev) for t in planes)
            parts.append(_lc.latent_chunk_prefill(
                _to(q_lat, dev), _to(q_rope, dev), _to(pos, dev), lat,
                scales[s], _to(lphys, dev), sm_scale=sm_scale,
                opt_kv=opt_kv, window=window, sink_pages=sink_pages,
                seg_q=sq, page_seg=sseg, page_base=sbase,
                return_state=True))
    return _lse_merge(parts, torch.float32, q_lat.device)


# ------------------------------------------------------------ writes --
def kv_pool_write(ctx: ShardCtx, kv_cache, scale_cache, k_new, v_new,
                  slot_idx, *, opt_kv: bool):
    """Shard-local write into a ShardedPool of (2, P_total, ps, Hkv, D) (and
    its scales): K1 runs once per shard, on the shard's device, with the
    GLOBAL slots in the shard's slot range; K1 drops every slot past the
    range, so each shard writes only its own lines and no other. In place;
    returns (kv_cache, scale_cache)."""
    _, _, ps, Hkv, D = kv_cache.shape
    n = kv_cache.pages_per_shard * ps              # lines a shard
    slots = _i32(slot_idx)
    k, v = k_new.contiguous(), v_new.contiguous()
    scales = (scale_cache.shards if scale_cache is not None
              else (None,) * ctx.num_shards)
    for s, (dev, kv) in enumerate(_shards(ctx, kv_cache, "kv_pool_write")):
        flat = kv.view(2, n, Hkv, D)
        sk, sv = _split(None if scales[s] is None
                        else scales[s].view(2, n, Hkv))
        local = global_to_local_slots(slots, s * n, n)
        with _on(dev):
            _kw.kv_cache_write(_to(k, dev), _to(v, dev), _to(local, dev),
                               flat[0], flat[1], sk, sv, opt_kv=opt_kv)
    return kv_cache, scale_cache


def _drop_plan(local: torch.Tensor, n: int):
    """(target line, source row) of a scatter of ``local`` (N,) slots into
    ``n`` lines that drops every slot >= n, with fixed shapes and no host
    sync (so a CUDA graph captures it). The source rows index the new
    values followed by one row of the pool's line 0 as it was: a dropped
    slot writes the first kept slot's value to that slot's line again, or,
    where no slot is kept, line 0's old value to line 0. No line is written
    two different values, and no line but the kept slots' changes."""
    N = local.numel()
    local = local.reshape(-1).long()
    kept = local < n
    rows = torch.arange(N, device=local.device)
    # the first kept row, 0 when none is kept; as a 1-element index (a
    # 0-d index tensor would be read on the host)
    first = torch.argmax(kept.to(torch.int32)).reshape(1)
    some = kept.any()
    src = torch.where(kept, rows, torch.where(some, first, N))
    tgt = torch.where(kept, local,
                      torch.where(some, local.gather(0, first), 0))
    return tgt, src


def _scatter_drop(flat: torch.Tensor, vals: torch.Tensor, tgt, src) -> None:
    """``flat[tgt] = [vals; flat[0]][src]`` by bytes (``_drop_plan``)."""
    fb, vb = flat.view(torch.uint8), vals.view(torch.uint8)
    fb[tgt] = torch.cat([vb, fb[:1]])[src]


def latent_pool_write(ctx: ShardCtx, lat_cache, scale_cache, latent,
                      slot_idx, *, opt_kv: bool, lora_rank: int):
    """Shard-local write into a ShardedPool of (P_total, ps, R+dr) latents
    (and its (P_total, ps, 2) scales): the dual-scale quantization runs
    once on the controller, as the JAX package runs it replicated, then
    each shard scatters, on its device, only the slots in its own range
    (``global_to_local_slots``); every other slot is dropped
    (``_drop_plan``), so no shard's last line is ever written for a token
    it does not hold. In place; returns (lat_cache, scale_cache)."""
    _, ps, W = lat_cache.shape
    n = lat_cache.pages_per_shard * ps
    new = latent.reshape(-1, W)
    if opt_kv:
        vals, scl = quantize_latent(new, lora_rank)
    else:
        vals, scl = new.to(lat_cache.dtype), None
    slots = slot_idx.reshape(-1)
    scales = (scale_cache.shards if scale_cache is not None
              else (None,) * ctx.num_shards)
    for s, (dev, lat) in enumerate(_shards(ctx, lat_cache,
                                           "latent_pool_write")):
        local = global_to_local_slots(slots, s * n, n)
        with _on(dev):
            tgt, src = _drop_plan(_to(local, dev), n)
            _scatter_drop(lat.view(n, W), _to(vals, dev), tgt, src)
            if opt_kv:
                _scatter_drop(scales[s].view(n, 2), _to(scl, dev), tgt, src)
    return lat_cache, scale_cache
