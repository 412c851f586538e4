"""Dispatch layer between the engine-facing cache layout and the kernels.

The engine's cache is the GLOBAL paged pool — per-layer leaves
``(2, P_total, ps, Hkv, D)`` with no batch dimension, or ``(P_total, ps,
R+dr)`` latents for MLA. These functions cut it into the kernels' page
views (zero-copy) and plug into ``repro_torch.core`` and
``repro_torch.models.mla`` when ``CoOptConfig.use_kernel`` is set. Each kernel
wrapper launches its CUDA kernel on CUDA tensors, raises if its library
does not build, and runs its plain PyTorch version only for CPU tensors;
nothing here catches an error and falls back.

No gradient flows through a hand-written kernel: its library is bound
through ``ctypes``, so its outputs carry no ``grad_fn``. Each wrapper that
can reach one (K1-K8, and the sharded layer through the read wrappers)
refuses a call under autograd (``torch.is_grad_enabled()`` with a floating
input that requires grad) on every device, as the JAX package's
``jax.grad`` refuses ``pallas_call``; training runs the plain path
(``use_kernel=False``).

Page-range shards: while a ``sharded.ShardCtx`` is installed
(``set_mesh_ctx``; the engine binds its mesh's around every step body with
``mesh_ctx_scope``), the pool leaves are ``core.opt_kv.ShardedPool``s and
every pool wrapper dispatches to ``kernels.sharded``: the same kernels run
once per shard, on that shard's pool and device; the writes are
shard-local and the reads' (o, m, l) partials are merged on the
controller. With no context (no mesh, or a mesh whose pages axes have
extent 1) the unsharded kernels run unchanged on the one pool.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch.cache.quant import quantize_latent
from repro_torch.kernels import flash_chunk_prefill as _fc
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import kv_cache_write as _kw
from repro_torch.kernels import latent_chunk_prefill as _lc
from repro_torch.kernels import paged_gqa_decode as _pd
from repro_torch.kernels import paged_latent_decode as _ld
from repro_torch.kernels import sharded as _sh
from repro_torch.kernels import visits as _vs

# the page-range shard context the read wrappers dispatch on; None = the
# unsharded kernels
_MESH_CTX: Optional["_sh.ShardCtx"] = None


def make_mesh_ctx(mesh, device=None) -> Optional["_sh.ShardCtx"]:
    """The ShardCtx of ``mesh``, its shards on the mesh's devices or else
    all on ``device`` (None when its pages axes have extent 1: an unsharded
    mesh takes the unsharded path)."""
    return _sh.make_ctx(mesh, device)


def set_mesh_ctx(ctx: Optional["_sh.ShardCtx"]) -> None:
    """Install (or clear, with None) the shard context."""
    global _MESH_CTX
    _MESH_CTX = ctx


def mesh_ctx() -> Optional["_sh.ShardCtx"]:
    return _MESH_CTX


@contextmanager
def mesh_ctx_scope(ctx: Optional["_sh.ShardCtx"]):
    """Bind ``ctx`` for the block and restore the previous context after:
    the engine wraps its step bodies in this, so a step's context neither
    leaks to later direct calls nor clobbers one a caller installed."""
    prev = _MESH_CTX
    set_mesh_ctx(ctx)
    try:
        yield
    finally:
        set_mesh_ctx(prev)


def _use_visits(share_visits: bool, B: int) -> bool:
    # the visit list pays only with >1 lane, and its int32 lane bitmask caps
    # membership at MAX_VISIT_LANES; beyond either bound the per-lane kernel
    # (bit-identical) runs
    return bool(share_visits) and 1 < B <= _vs.MAX_VISIT_LANES


def _gqa_use_visits(share_visits: bool, B: int, Hq: int, Hkv: int, D: int,
                    ps: int, opt_kv: bool, opt_gqa: bool) -> bool:
    # K4 holds the B * G rows of a head in one block's shared memory; where
    # its one-page plan does not fit, K2 (the same bits) serves the step
    return _use_visits(share_visits, B) and _pd.plan_fits(
        B, Hq, Hkv, D, ps, opt_kv, opt_gqa)


def _no_grad_through(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through kernel ``name``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: no gradient flows through the hand-written kernels "
            "(use_kernel=True); train with use_kernel=False, or call under "
            "torch.no_grad()")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def paged_pool_decode(q, kv_pages, scale_pages, cache_len, phys_table,
                      log_table, *, opt_kv: bool, opt_gqa: bool,
                      window: int = 0, sink_pages: int = 0,
                      share_visits: bool = False):
    """Fused decode over the global pool. q (B,Hq,D); kv_pages
    (2,P_total,ps,Hkv,D); scale_pages (2,P_total,ps,Hkv)|None; phys/log_table
    (B,NSel) int32 (-1 = never read). With ``share_visits`` and 1 < B <= 32
    the visit-list kernel K4 runs where its plan fits one block's shared
    memory; otherwise the per-lane kernel K2. Under a shard context: the
    sharded read (``sharded.paged_pool_decode``)."""
    _no_grad_through("paged_pool_decode", q, kv_pages, scale_pages)
    if _MESH_CTX is not None:
        return _sh.paged_pool_decode(
            _MESH_CTX, q, kv_pages, scale_pages, cache_len, phys_table,
            log_table, opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
            sink_pages=sink_pages, share_visits=share_visits)
    ks = scale_pages[0] if scale_pages is not None else None
    vs = scale_pages[1] if scale_pages is not None else None
    phys, log, cl = _i32(phys_table), _i32(log_table), _i32(cache_len)
    B, Hq, D = q.shape
    _, _, ps, Hkv, _ = kv_pages.shape
    if _gqa_use_visits(share_visits, B, Hq, Hkv, D, ps, opt_kv, opt_gqa):
        vp, vm, vl = _vs.plan_visits(phys, log)
        return _pd.paged_pool_decode_visits(
            q, kv_pages[0], kv_pages[1], ks, vs, cl, vp, vm, vl,
            opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
            sink_pages=sink_pages)
    return _pd.paged_pool_decode(
        q, kv_pages[0], kv_pages[1], ks, vs, cl, phys, log, opt_kv=opt_kv,
        opt_gqa=opt_gqa, window=window, sink_pages=sink_pages)


def kv_cache_write(kv_cache, scale_cache, k_new, v_new, slot_idx, *,
                   opt_kv: bool):
    """Engine-layout adapter for the write kernel: scatters into the pool
    (2,P_total,ps,Hkv,D) in place and returns (kv_cache, scale_cache).
    Under a shard context: the shard-local write
    (``sharded.kv_pool_write``)."""
    _no_grad_through("kv_cache_write", k_new, v_new, kv_cache, scale_cache)
    if _MESH_CTX is not None:
        return _sh.kv_pool_write(_MESH_CTX, kv_cache, scale_cache, k_new,
                                 v_new, slot_idx, opt_kv=opt_kv)
    _, Pt, ps, Hkv, D = kv_cache.shape
    flat = kv_cache.view(2, Pt * ps, Hkv, D)
    sflat = (scale_cache.view(2, Pt * ps, Hkv)
             if scale_cache is not None else (None, None))
    _kw.kv_cache_write(k_new.contiguous(), v_new.contiguous(),
                       _i32(slot_idx), flat[0], flat[1], sflat[0], sflat[1],
                       opt_kv=opt_kv)
    return kv_cache, scale_cache


def paged_chunk_prefill(q, positions, kv_pages, scale_pages, phys_table, *,
                        opt_kv: bool, opt_gqa: bool, window: int = 0,
                        sink_pages: int = 0, seg_q=None, page_seg=None,
                        page_base=None):
    """Continuation-prefill attention over the global pool: a chunk of
    queries (B,S,Hq,D) with absolute ``positions`` (B,S) attends the lane's
    cached pages named by ``phys_table`` (B,NP; -1 = never read). The
    chunk's own K/V must already be written. ``seg_q``/``page_seg``/
    ``page_base`` are the concat-prefill packing planes; None = unpacked.
    Under a shard context: the sharded read."""
    _no_grad_through("paged_chunk_prefill", q, kv_pages, scale_pages)
    if _MESH_CTX is not None:
        return _sh.paged_chunk_prefill(
            _MESH_CTX, q, positions, kv_pages, scale_pages, phys_table,
            opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
            sink_pages=sink_pages, seg_q=seg_q, page_seg=page_seg,
            page_base=page_base)
    ks = scale_pages[0] if scale_pages is not None else None
    vs = scale_pages[1] if scale_pages is not None else None
    planes = [None if t is None else _i32(t)
              for t in (seg_q, page_seg, page_base)]
    return _fc.flash_chunk_prefill(
        q.contiguous(), _i32(positions), kv_pages[0], kv_pages[1], ks, vs,
        _i32(phys_table), opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
        sink_pages=sink_pages, seg_q=planes[0], page_seg=planes[1],
        page_base=planes[2])


def latent_pool_write(lat_cache, scale_cache, latent, slot_idx, *,
                      opt_kv: bool, lora_rank: int):
    """MLA latent write: dual-scale quantization (``opt_kv``) and a flat-slot
    scatter into the global latent pool, in place. lat_cache (P,ps,R+dr);
    latent (B,S,R+dr); slot_idx (B,S). Slots < 0 (the SkipSet) go to the
    pool's last line, as in the JAX package, and so do slots past the pool
    (which it drops): the BlockManager never allocates that line, and a
    scatter of fixed shape needs no host sync, so a CUDA graph can capture
    it. A plain scatter: the JAX package has no kernel here either.
    Under a shard context: the shard-local write, which drops those slots
    instead (``sharded.latent_pool_write``: a shard's last line is live).
    Returns (lat_cache, scale_cache)."""
    if _MESH_CTX is not None:
        return _sh.latent_pool_write(_MESH_CTX, lat_cache, scale_cache,
                                     latent, slot_idx, opt_kv=opt_kv,
                                     lora_rank=lora_rank)
    Pt, ps, W = lat_cache.shape
    flat = lat_cache.view(Pt * ps, W)
    slots = slot_idx.reshape(-1).long()
    slots = torch.where((slots < 0) | (slots >= Pt * ps), Pt * ps - 1, slots)
    new = latent.reshape(-1, W)
    if opt_kv:
        q, sc = quantize_latent(new, lora_rank)
        flat[slots] = q
        scale_cache.view(Pt * ps, 2)[slots] = sc
    else:
        flat[slots] = new.to(flat.dtype)
    return lat_cache, scale_cache


def paged_latent_decode(q_lat, q_rope, lat_pages, scale_pages, cache_len,
                        phys_table, log_table, *, sm_scale: float,
                        opt_kv: bool, window: int = 0, sink_pages: int = 0,
                        share_visits: bool = False):
    """MLA absorbed decode over the global latent pool. q_lat (B,H,R) f32;
    q_rope (B,H,dr) f32; lat_pages (P_total,ps,R+dr); scale_pages
    (P_total,ps,2)|None; phys/log_table (B,NSel) int32 (-1 = never read).
    With ``share_visits`` and 1 < B <= 32 the visit-list kernel K7 runs;
    otherwise the per-lane kernel K5. Returns o_lat (B,H,R) f32. Under a
    shard context: the sharded read."""
    _no_grad_through("paged_latent_decode", q_lat, q_rope, lat_pages,
                     scale_pages)
    if _MESH_CTX is not None:
        return _sh.paged_latent_decode(
            _MESH_CTX, q_lat, q_rope, lat_pages, scale_pages, cache_len,
            phys_table, log_table, sm_scale=sm_scale, opt_kv=opt_kv,
            window=window, sink_pages=sink_pages, share_visits=share_visits)
    phys, log, cl = _i32(phys_table), _i32(log_table), _i32(cache_len)
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    if _use_visits(share_visits, q_lat.shape[0]):
        vp, vm, vl = _vs.plan_visits(phys, log)
        return _ld.paged_latent_decode_visits(
            q_lat, q_rope, lat_pages, scale_pages, cl, vp, vm, vl,
            sm_scale=sm_scale, opt_kv=opt_kv, window=window,
            sink_pages=sink_pages)
    return _ld.paged_latent_decode(
        q_lat, q_rope, lat_pages, scale_pages, cl, phys, log,
        sm_scale=sm_scale, opt_kv=opt_kv, window=window,
        sink_pages=sink_pages)


def latent_chunk_prefill(q_lat, q_rope, positions, lat_pages, scale_pages,
                         phys_table, *, sm_scale: float, opt_kv: bool,
                         window: int = 0, sink_pages: int = 0, seg_q=None,
                         page_seg=None, page_base=None):
    """MLA absorbed continuation prefill over the global latent pool (K6): a
    chunk of absorbed queries q_lat (B,S,H,R) / q_rope (B,S,H,dr) with
    absolute ``positions`` (B,S) attends the lane's cached latent pages
    named by ``phys_table`` (B,NP; -1 = never read). The chunk's own
    latents must already be written. Returns o_lat (B,S,H,R) f32. Under a
    shard context: the sharded read."""
    _no_grad_through("latent_chunk_prefill", q_lat, q_rope, lat_pages,
                     scale_pages)
    if _MESH_CTX is not None:
        return _sh.latent_chunk_prefill(
            _MESH_CTX, q_lat, q_rope, positions, lat_pages, scale_pages,
            phys_table, sm_scale=sm_scale, opt_kv=opt_kv, window=window,
            sink_pages=sink_pages, seg_q=seg_q, page_seg=page_seg,
            page_base=page_base)
    planes = [None if t is None else _i32(t)
              for t in (seg_q, page_seg, page_base)]
    return _lc.latent_chunk_prefill(
        q_lat.contiguous(), q_rope.contiguous(), _i32(positions), lat_pages,
        scale_pages, _i32(phys_table), sm_scale=sm_scale, opt_kv=opt_kv,
        window=window, sink_pages=sink_pages, seg_q=planes[0],
        page_seg=planes[1], page_base=planes[2])


def flash_prefill(q, k, v, *, window: int = 0, q_offset: int = 0):
    """Full-prompt causal attention over in-prompt K/V, no pool (K8)."""
    _no_grad_through("flash_prefill", q, k, v)
    return _fp.flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                             window=window, q_offset=q_offset)
