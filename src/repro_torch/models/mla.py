"""Multi-head Latent Attention (deepseek-v2) over a paged, quantizable latent
cache — Opt-KV and Opt-Pa applied to MLA. The port of the JAX package's
``models/mla.py``.

The per-token cache entry is the compressed latent c_kv (R) concatenated
with the shared rotary key k_rope (dr): one vector of R+dr values for all
heads. Opt-KV stores it as FP8 with two per-token scales
(``cache.quant.quantize_latent``); Opt-Pa pages it. Decode and chunk
continuation both use the matrix-absorption form (queries projected into
latent space through ``w_uk``, outputs expanded through ``w_uv``), so K/V
are never materialised per head.

Under ``coopt.use_kernel`` ``mla_paged_decode`` and ``mla_chunk_attention``
dispatch through ``kernels.ops`` to the hand-written kernels (K5/K7 decode,
K6 chunk prefill), which read the latent pages straight off the FP8 pool;
the ``w_uk`` absorption and ``w_uv`` expansion stay outside them. The
gather-based bodies below are the plain reference path, held against the
JAX package's jnp bodies by the tests.
"""
from __future__ import annotations

import math

import torch

from repro_torch.cache.quant import dequantize_latent
from repro_torch.core.coopt import CoOptConfig
from repro_torch.core.opt_kv import (decode_page_select, identity_page_table,
                                     logical_to_physical, window_page_table)
from repro_torch.models.layers import (apply_rope, causal_attention, linear,
                                       rmsnorm)

_NEG = -1e30


def mla_query(x, p, cfg, positions):
    """x (B,S,d) -> q_nope (B,S,H,dn), q_rope (B,S,H,dr) (rotated)."""
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    B, S, _ = x.shape
    if cfg.q_lora_rank:         # low-rank query: W_qb RMSNorm(W_qa x)
        q = linear(rmsnorm(linear(x, p["wq_a"]), p["q_a_norm"], cfg.norm_eps),
                   p["wq_b"])
    else:
        q = linear(x, p["wq"])
    q = q.reshape(B, S, H, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def mla_project(x, p, cfg, positions):
    """Shared projections. x (B,S,d) -> q_nope (B,S,H,dn), q_rope
    (B,S,H,dr), latent (B,S,R+dr) (k_rope already rotated)."""
    R = cfg.kv_lora_rank
    q_nope, q_rope = mla_query(x, p, cfg, positions)
    ckv = linear(x, p["w_dkv"])                                # (B,S,R+dr)
    c = rmsnorm(ckv[..., :R], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., R:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, torch.cat([c, k_rope], dim=-1)


def mla_full_attention(q_nope, q_rope, latent, p, cfg, *, window: int = 0):
    """Full-prompt path: expand the latent to per-head K/V and run causal
    attention. Returns (B,S,H,dv)."""
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    R, dv = cfg.kv_lora_rank, cfg.v_head_dim
    B, S, _ = latent.shape
    c, k_rope = latent[..., :R], latent[..., R:]
    k_nope = torch.einsum("btr,rhd->bthd", c, p["w_uk"].reshape(R, H, dn))
    v = torch.einsum("btr,rhd->bthd", c, p["w_uv"].reshape(R, H, dv))
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return causal_attention(q, k, v, window=window)


def _absorb_q(q_nope, p, cfg):
    """``w_uk`` absorption outside the kernel, in f32: q_lat_h = q_nope_h @
    W_uk_h, so score_h(t) = <q_lat_h, c_t> + <q_rope_h, k_rope_t>."""
    H, dn, R = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    spec = "bshd,rhd->bshr" if q_nope.dim() == 4 else "bhd,rhd->bhr"
    return torch.einsum(spec, q_nope.float(),
                        p["w_uk"].reshape(R, H, dn).float())


def _expand_o(o_lat, p, cfg, dtype):
    """``w_uv`` expansion outside the kernel: o_lat (..., H, R) f32 ->
    per-head values (..., H, dv) in ``dtype``."""
    H, R, dv = cfg.num_heads, cfg.kv_lora_rank, cfg.v_head_dim
    spec = "bshr,rhd->bshd" if o_lat.dim() == 4 else "bhr,rhd->bhd"
    return torch.einsum(spec, o_lat,
                        p["w_uv"].reshape(R, H, dv).float()).to(dtype)


def _dequant(pages, scales, R, opt_kv):
    """pages (..., R+dr); scales (..., 2) -> f32 latents."""
    if opt_kv:
        return dequantize_latent(pages, scales, R, dtype=torch.float32)
    return pages.float()


def mla_chunk_attention(q_nope, q_rope, lat_pages, scale_pages, positions,
                        page_table, p, cfg, coopt: CoOptConfig, *,
                        window: int = 0, sink_pages: int = 1, seg_q=None,
                        page_seg=None, page_base=None):
    """Matrix-absorption chunk attention against the global latent pool (the
    MLA leg of the chunked-continuation prefill; a decode lane is a chunk
    of length 1). q_nope (B,S,H,dn), q_rope (B,S,H,dr) with absolute
    ``positions`` (B,S); the chunk's latents are already in the pool.
    ``seg_q``/``page_seg``/``page_base`` are the concat-prefill packing
    planes (None = unpacked). Returns (B,S,H,dv)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    R = cfg.kv_lora_rank
    B, S = q_nope.shape[:2]
    P_total, ps, _ = lat_pages.shape
    dev = q_nope.device
    if page_table is None:
        page_table = identity_page_table(B, P_total, dev)
    scale = 1.0 / math.sqrt(dn + dr)
    q_lat = _absorb_q(q_nope, p, cfg)                           # (B,S,H,R)

    if coopt.use_kernel:
        from repro_torch.kernels import ops
        o_lat = ops.latent_chunk_prefill(
            q_lat, q_rope.float(), positions, lat_pages,
            scale_pages if coopt.opt_kv else None, page_table,
            sm_scale=scale, opt_kv=coopt.opt_kv, window=window,
            sink_pages=sink_pages, seg_q=seg_q, page_seg=page_seg,
            page_base=page_base)
        return _expand_o(o_lat, p, cfg, q_nope.dtype)

    pt = page_table.clamp_min(0).long()
    lat = _dequant(lat_pages[pt], scale_pages[pt] if coopt.opt_kv else None,
                   R, coopt.opt_kv)                             # (B,NP,ps,W)
    T = page_table.shape[1] * ps
    lat = lat.reshape(B, T, -1)
    lat_c, lat_r = lat[..., :R], lat[..., R:]
    s = (torch.einsum("bshr,btr->bhst", q_lat, lat_c)
         + torch.einsum("bshe,bte->bhst", q_rope.float(), lat_r)) * scale
    if page_base is not None:
        # packed: key j's position restarts per segment at page_base * ps
        kpos = (page_base.long()[:, :, None] * ps
                + torch.arange(ps, device=dev)[None, None, :]
                ).reshape(B, T)[:, None, :]
    else:
        kpos = torch.arange(T, device=dev)[None, None, :]
    qpos = positions.long()[:, :, None]
    mask = (kpos <= qpos) & \
        (page_table >= 0).repeat_interleave(ps, dim=1)[:, None, :]
    if seg_q is not None:
        mask &= (page_seg.long().repeat_interleave(ps, dim=1)[:, None]
                 == seg_q.long()[:, :, None])
    if window:
        mask &= (kpos > qpos - window) | (kpos < sink_pages * ps)
    s = torch.where(mask[:, None], s, _NEG)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", pr, lat_c)
    return _expand_o(o_lat, p, cfg, q_nope.dtype)


def mla_paged_decode(q_nope, q_rope, lat_pages, scale_pages, cache_len, p,
                     cfg, coopt: CoOptConfig, *, window: int = 0,
                     sink_pages: int = 1, page_table=None):
    """Absorbed decode against the global latent pool. q_nope/q_rope
    (B,H,dn|dr); lat_pages (P_total,ps,R+dr) shared by all lanes;
    page_table (B,P_lane) physical pages in logical order (default: the
    lane-identity partition). Returns (B,H,dv)."""
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    R = cfg.kv_lora_rank
    B = q_nope.shape[0]
    P_total, ps, _ = lat_pages.shape
    dev = q_nope.device
    if page_table is None:
        page_table = identity_page_table(B, P_total, dev)
    P = page_table.shape[1]
    scale = 1.0 / math.sqrt(dn + dr)
    q_lat = _absorb_q(q_nope, p, cfg)                           # (B,H,R)
    q_rope = q_rope.float()
    sc_pages = scale_pages if coopt.opt_kv else None

    if coopt.use_kernel:
        # (physical, logical) tables: Eq. 9 filtering or the {sink + window}
        # policy, shared with the dense decode kernels
        from repro_torch.kernels import ops
        phys, logical = decode_page_select(cache_len, page_table, ps,
                                           window=window,
                                           sink_pages=sink_pages,
                                           opt_pa=coopt.opt_pa)
        o_lat = ops.paged_latent_decode(
            q_lat, q_rope, lat_pages, sc_pages, cache_len, phys, logical,
            sm_scale=scale, opt_kv=coopt.opt_kv, window=window,
            sink_pages=sink_pages, share_visits=coopt.share_visits)
        return _expand_o(o_lat, p, cfg, q_nope.dtype)

    cl = cache_len.long()
    if window:
        logical = window_page_table(cache_len, P, ps, window, sink_pages)
        phys = logical_to_physical(logical, page_table)
        pt = phys.clamp_min(0).long()
        lat = _dequant(lat_pages[pt], None if sc_pages is None
                       else sc_pages[pt], R, coopt.opt_kv).reshape(B, -1,
                                                                   R + dr)
        pos = (logical.clamp_min(0).long()[:, :, None] * ps
               + torch.arange(ps, device=dev)[None, None]).reshape(B, -1)
        ok = (pos < cl[:, None]) \
            & ((pos >= (cl[:, None] - window).clamp_min(0))
               | (pos < sink_pages * ps)) \
            & (phys >= 0).repeat_interleave(ps, dim=1)
        s = (torch.einsum("bhr,btr->bht", q_lat, lat[..., :R])
             + torch.einsum("bhe,bte->bht", q_rope, lat[..., R:])) * scale
        s = torch.where(ok[:, None], s, _NEG)
        m = s.amax(dim=-1, keepdim=True)
        pr = torch.exp(s - m)
        pr = pr / pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o_lat = torch.einsum("bht,btr->bhr", pr, lat[..., :R])
        return _expand_o(o_lat, p, cfg, q_nope.dtype)

    # dense: the lane's pages in logical order, reduced by an online softmax
    # over groups of ``page_group`` pages (Opt-Pa) or in one group
    pt = page_table.clamp_min(0).long()
    lat_lane = lat_pages[pt]                                    # (B,P,ps,W)
    sc_lane = sc_pages[pt] if sc_pages is not None else None
    valid = (page_table >= 0).repeat_interleave(ps, dim=1)      # (B, P*ps)
    pg = coopt.page_group if coopt.opt_pa else P
    while P % pg:
        pg //= 2
    pg = max(pg, 1)
    NG, T = P // pg, pg * ps
    lat_g = lat_lane.reshape(B, NG, T, R + dr)
    sc_g = sc_lane.reshape(B, NG, T, 2) if sc_lane is not None else None
    valid_g = valid.reshape(B, NG, T)

    m = torch.full((B, H, 1), _NEG, device=dev)
    l = torch.zeros((B, H), device=dev)
    acc = torch.zeros((B, H, R), device=dev)
    for g in range(NG):
        lat = _dequant(lat_g[:, g], None if sc_g is None else sc_g[:, g], R,
                       coopt.opt_kv)
        s = (torch.einsum("bhr,btr->bht", q_lat, lat[..., :R])
             + torch.einsum("bhe,bte->bht", q_rope, lat[..., R:])) * scale
        pos = g * T + torch.arange(T, device=dev)[None, None, :]
        ok = (pos < cl[:, None, None]) & valid_g[:, g][:, None, :]
        s = torch.where(ok, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pr = torch.exp(s - m_new)
        l = l * corr[..., 0] + pr.sum(dim=-1)
        acc = acc * corr + torch.einsum("bht,btr->bhr", pr, lat[..., :R])
        m = m_new
    o_lat = acc / l.clamp_min(1e-30)[..., None]
    return _expand_o(o_lat, p, cfg, q_nope.dtype)
