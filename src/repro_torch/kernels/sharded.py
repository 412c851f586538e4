"""Page-range shards over the pooled kernels, on one card.

The engine's pool is split along its ``pages`` axis into ``num_shards``
contiguous page ranges, one for each shard of a ``launch.mesh`` mesh's
``(pod, data)`` axes (``core.opt_kv.PAGES_AXES``); the scheduler keeps every
request's pages inside one range (``BlockManager.shard_page_ranges``). This
module runs each read kernel once per shard, UNCHANGED, on that shard's
range of the pool only:

  * the shard's pages are the zero-copy view ``pool[lo:hi]`` of the one
    pool on the card;
  * the lanes' GLOBAL page tables are translated into the shard's LOCAL
    page domain (``core.opt_kv.global_to_local_pages``): other shards' pages
    and -1 holes become -1, which the kernels never read; a decode that
    takes the visit-list kernel plans its visits after the translation, so
    each shard's visits stay inside its range;
  * each launch returns its final online-softmax state (``return_state``:
    the normalized partial output and (m, l)), and the partials are merged
    in ascending shard order by the log-sum-exp rule, in plain PyTorch as
    the JAX package merges in jnp: m* = max_s m_s; w_s = exp(m_s - m*) l_s;
    out = sum_s w_s o_s / sum_s w_s. A shard holding none of a lane's pages
    reports (m = -1e30, l = 0) and weighs 0.

The merge starts from the partial outputs in the kernels' output dtype
(bf16 for K2-K4, f32 for the latent kernels), as the JAX package's does,
so sharded results differ from unsharded ones by the same rounding.

Writes under a shard context stay the unsharded global writes
(``kernels.ops``): on one card the shards' views share one storage, so a
global write leaves every shard's live lines as a shard-local write would.
(The latent write routes dropped slots to the pool's last line, which is
live data on every shard but the last, so it must not run per shard view.)

The N launches of a read run in order on one stream, with no host sync,
so a CUDA graph captures them with the merge; the decode kernels' arrival
counters (``paged_gqa_decode._split_buffers``) are shared across them,
which is safe only because they run in order on one stream.

``ops`` dispatches here while a ``ShardCtx`` is installed
(``ops.set_mesh_ctx``, ``ops.mesh_ctx_scope``); a mesh whose pages axes
have extent 1 gives no context (``make_ctx``), so it runs the unsharded
path unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.core.opt_kv import PAGES_AXES, global_to_local_pages
from repro_torch.kernels import flash_chunk_prefill as _fc
from repro_torch.kernels import latent_chunk_prefill as _lc
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import paged_gqa_decode as _pd
from repro_torch.kernels import paged_latent_decode as _ld
from repro_torch.kernels import visits as _vs


@dataclass(frozen=True)
class ShardCtx:
    """The pages-axis split the read wrappers dispatch on: ``num_shards``
    equal page ranges of the pool."""
    num_shards: int


def make_ctx(mesh) -> Optional[ShardCtx]:
    """The ShardCtx of ``mesh``, or None when its pages axes
    (``PAGES_AXES``) have extent 1 (or there is no mesh): an unsharded mesh
    takes the unsharded path."""
    if mesh is None:
        return None
    n = math.prod(mesh.shape[a] for a in PAGES_AXES if a in mesh.shape)
    return ShardCtx(num_shards=n) if n > 1 else None


def shard_ranges(ctx: ShardCtx, num_pages: int) -> List[Tuple[int, int]]:
    """(first page, pages) of each shard of a pool of ``num_pages`` pages,
    in shard order; the pool must split evenly (``pool_layout`` pads it)."""
    n = ctx.num_shards
    if num_pages % n:
        raise ValueError(f"a pool of {num_pages} pages does not split into "
                         f"{n} equal shards (pad it: core.opt_kv.pool_layout)")
    per = num_pages // n
    return [(s * per, per) for s in range(n)]


def _lse_merge(parts, out_dtype):
    """Merge per-shard ``(o, m, l)`` partials, listed in ascending shard
    order: o (..., D) normalized in the kernel's output dtype, m and l
    (...) f32. Sums run in that order."""
    m_all = torch.stack([m for _, m, _ in parts]).amax(0)
    num = den = None
    for o, m, l in parts:
        w = torch.exp(m - m_all) * l             # 0 for a page-less shard
        t = o.float() * w[..., None]
        num, den = (t, w) if num is None else (num + t, den + w)
    return (num / den.clamp_min(1e-30)[..., None]).to(out_dtype)


def _i32(t):
    return t.to(torch.int32).contiguous()


def _view(x, first, n):
    return None if x is None else x[first:first + n]


# ------------------------------------------------------------- reads --
def paged_pool_decode(ctx: ShardCtx, q, kv_pages, scale_pages, cache_len,
                      phys_table, log_table, *, opt_kv: bool, opt_gqa: bool,
                      window: int = 0, sink_pages: int = 0,
                      share_visits: bool = False):
    """Sharded ``ops.paged_pool_decode``: kv_pages (2, P_total, ps, Hkv, D)
    split into the context's page ranges; GLOBAL tables; returns the merged
    (B, Hq, D). With ``share_visits`` (and K4's plan fitting, as in
    ``ops``) each shard plans its visit list after the translation."""
    phys, log, cl = _i32(phys_table), _i32(log_table), _i32(cache_len)
    B, Hq, D = q.shape
    _, P, ps, Hkv, _ = kv_pages.shape
    use_visits = _ops._gqa_use_visits(share_visits, B, Hq, Hkv, D, ps,
                                      opt_kv, opt_gqa)
    ks = scale_pages[0] if scale_pages is not None else None
    vs = scale_pages[1] if scale_pages is not None else None
    kw = dict(opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
              sink_pages=sink_pages, return_state=True)
    parts = []
    # K2/K4 share one set of arrival counters (and the scratch pattern of
    # ``_split_buffers``) across these launches: safe only because they run
    # one after another on one stream, eagerly or inside one CUDA graph.
    # Do not spread the shards over streams.
    for first, n in shard_ranges(ctx, P):
        pool = (_view(kv_pages[0], first, n), _view(kv_pages[1], first, n),
                _view(ks, first, n), _view(vs, first, n))
        lphys = global_to_local_pages(phys, first, n)
        if use_visits:
            vp, vm, vl = _vs.plan_visits(lphys, log)
            parts.append(_pd.paged_pool_decode_visits(q, *pool, cl, vp, vm,
                                                      vl, **kw))
        else:
            parts.append(_pd.paged_pool_decode(q, *pool, cl, lphys, log,
                                               **kw))
    return _lse_merge(parts, q.dtype)


def paged_chunk_prefill(ctx: ShardCtx, q, positions, kv_pages, scale_pages,
                        phys_table, *, opt_kv: bool, opt_gqa: bool,
                        window: int = 0, sink_pages: int = 0, seg_q=None,
                        page_seg=None, page_base=None):
    """Sharded ``ops.paged_chunk_prefill``: chunk queries (B, S, Hq, D)
    against each shard's page range, partials merged. The packing planes
    are in the LOGICAL page domain, so they go to every shard untranslated;
    only the physical table is mapped into the shard's range."""
    P = kv_pages.shape[1]
    ks = scale_pages[0] if scale_pages is not None else None
    vs = scale_pages[1] if scale_pages is not None else None
    planes = [None if t is None else _i32(t)
              for t in (seg_q, page_seg, page_base)]
    phys, pos, q = _i32(phys_table), _i32(positions), q.contiguous()
    parts = []
    for first, n in shard_ranges(ctx, P):
        parts.append(_fc.flash_chunk_prefill(
            q, pos, _view(kv_pages[0], first, n),
            _view(kv_pages[1], first, n), _view(ks, first, n),
            _view(vs, first, n), global_to_local_pages(phys, first, n),
            opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
            sink_pages=sink_pages, seg_q=planes[0], page_seg=planes[1],
            page_base=planes[2], return_state=True))
    return _lse_merge(parts, q.dtype)


def paged_latent_decode(ctx: ShardCtx, q_lat, q_rope, lat_pages,
                        scale_pages, cache_len, phys_table, log_table, *,
                        sm_scale: float, opt_kv: bool, window: int = 0,
                        sink_pages: int = 0, share_visits: bool = False):
    """Sharded ``ops.paged_latent_decode``: the latent pool (P_total, ps,
    R+dr) split into the context's page ranges; returns the merged o_lat
    (B, H, R) f32. With ``share_visits`` each shard plans its visit list
    after the translation."""
    phys, log, cl = _i32(phys_table), _i32(log_table), _i32(cache_len)
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    use_visits = _ops._use_visits(share_visits, q_lat.shape[0])
    kw = dict(sm_scale=sm_scale, opt_kv=opt_kv, window=window,
              sink_pages=sink_pages, return_state=True)
    parts = []
    for first, n in shard_ranges(ctx, lat_pages.shape[0]):
        pool = (_view(lat_pages, first, n), _view(scale_pages, first, n))
        lphys = global_to_local_pages(phys, first, n)
        if use_visits:
            vp, vm, vl = _vs.plan_visits(lphys, log)
            parts.append(_ld.paged_latent_decode_visits(
                q_lat, q_rope, *pool, cl, vp, vm, vl, **kw))
        else:
            parts.append(_ld.paged_latent_decode(q_lat, q_rope, *pool, cl,
                                                 lphys, log, **kw))
    return _lse_merge(parts, torch.float32)


def latent_chunk_prefill(ctx: ShardCtx, q_lat, q_rope, positions, lat_pages,
                         scale_pages, phys_table, *, sm_scale: float,
                         opt_kv: bool, window: int = 0, sink_pages: int = 0,
                         seg_q=None, page_seg=None, page_base=None):
    """Sharded ``ops.latent_chunk_prefill``: a chunk of absorbed queries
    against each shard's page range, partials merged; returns o_lat (B, S,
    H, R) f32. The packing planes go to every shard untranslated."""
    planes = [None if t is None else _i32(t)
              for t in (seg_q, page_seg, page_base)]
    phys, pos = _i32(phys_table), _i32(positions)
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    parts = []
    for first, n in shard_ranges(ctx, lat_pages.shape[0]):
        parts.append(_lc.latent_chunk_prefill(
            q_lat, q_rope, pos, _view(lat_pages, first, n),
            _view(scale_pages, first, n),
            global_to_local_pages(phys, first, n), sm_scale=sm_scale,
            opt_kv=opt_kv, window=window, sink_pages=sink_pages,
            seg_q=planes[0], page_seg=planes[1], page_base=planes[2],
            return_state=True))
    return _lse_merge(parts, torch.float32)
