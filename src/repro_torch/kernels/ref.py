"""Flat-softmax oracles of the attention kernels (no blocking, no online
accumulation), written in the most naive form so that a kernel bug cannot
be mirrored here. Layouts follow the GLOBAL paged pool: kv pages carry no
batch dimension; lanes address the pool through (physical, logical) page
tables. Ports of the JAX package's ``kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

_NEG = -1e30


def _dq(pages, scales, opt_kv):
    if opt_kv:
        return pages.float() * scales[..., None]
    return pages.float()


def paged_pool_decode_ref(q, k_pages, v_pages, k_scale, v_scale, cache_len,
                          phys_table, log_table, *, opt_kv: bool,
                          window: int = 0, sink_pages: int = 0):
    """Flat-softmax oracle of K2/K4. q (B,Hq,D); k/v_pages (P_total, ps,
    Hkv, D); phys/log_table (B, NSel), -1 = skipped. Token j of logical page
    L sits at position L*ps+j."""
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    pt = phys_table.clamp_min(0).long()
    k = _dq(k_pages[pt], None if k_scale is None else k_scale[pt], opt_kv)
    v = _dq(v_pages[pt], None if v_scale is None else v_scale[pt], opt_kv)
    NSel = phys_table.shape[1]
    k = k.reshape(B, NSel * ps, Hkv, D)
    v = v.reshape(B, NSel * ps, Hkv, D)
    qf = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qf, k) / math.sqrt(D)
    pos = (log_table.clamp_min(0).long()[:, :, None] * ps
           + torch.arange(ps, device=q.device)[None, None]).reshape(B, -1)
    cl = cache_len.long()[:, None]
    ok = (pos < cl) & (phys_table >= 0).repeat_interleave(ps, dim=1)
    if window:
        ok &= (pos >= (cl - window).clamp_min(0)) | (pos < sink_pages * ps)
    s = torch.where(ok[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, v)
    return o.reshape(B, Hq, D).to(q.dtype)


def _dq_latent(lat, scales, lora_rank, opt_kv):
    """Dual-scale latent dequant, written out naively: column 0 scales the
    c_kv segment, column 1 the k_rope segment."""
    lat = lat.float()
    if not opt_kv:
        return lat
    c = lat[..., :lora_rank] * scales[..., 0:1]
    r = lat[..., lora_rank:] * scales[..., 1:2]
    return torch.cat([c, r], dim=-1)


def _gather_latent(lat_pages, scale_pages, table, lora_rank, opt_kv):
    """(B, NSel) table -> the lanes' dequantized latents (B, NSel*ps, W)."""
    B, NSel = table.shape
    _, ps, W = lat_pages.shape
    pt = table.clamp_min(0).long()
    sc = None if scale_pages is None else scale_pages[pt]
    return _dq_latent(lat_pages[pt], sc, lora_rank, opt_kv).reshape(
        B, NSel * ps, W)


def paged_latent_decode_ref(q_lat, q_rope, lat_pages, scale_pages, cache_len,
                            phys_table, log_table, *, sm_scale: float,
                            opt_kv: bool, window: int = 0,
                            sink_pages: int = 0):
    """Flat-softmax oracle of the MLA latent decode kernels K5/K7. q_lat
    (B,H,R) absorbed queries; q_rope (B,H,dr); lat_pages (P_total, ps, R+dr)
    [c_kv|k_rope]; scale_pages (P_total, ps, 2) | None; phys/log_table
    (B, NSel), -1 = skipped. Returns o_lat (B,H,R) f32."""
    B, H, R = q_lat.shape
    ps = lat_pages.shape[1]
    lat = _gather_latent(lat_pages, scale_pages, phys_table, R, opt_kv)
    s = (torch.einsum("bhr,btr->bht", q_lat.float(), lat[..., :R])
         + torch.einsum("bhe,bte->bht", q_rope.float(), lat[..., R:])) \
        * sm_scale
    pos = (log_table.clamp_min(0).long()[:, :, None] * ps
           + torch.arange(ps, device=q_lat.device)[None, None]).reshape(B, -1)
    cl = cache_len.long()[:, None]
    ok = (pos < cl) & (phys_table >= 0).repeat_interleave(ps, dim=1)
    if window:
        ok &= (pos >= (cl - window).clamp_min(0)) | (pos < sink_pages * ps)
    s = torch.where(ok[:, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,btr->bhr", p, lat[..., :R])


def latent_chunk_prefill_ref(q_lat, q_rope, positions, lat_pages,
                             scale_pages, phys_table, *, sm_scale: float,
                             opt_kv: bool, window: int = 0,
                             sink_pages: int = 0):
    """Flat-softmax oracle of the MLA latent chunk-prefill kernel K6: chunk
    queries q_lat (B,S,H,R) / q_rope (B,S,H,dr) with per-row ``positions``
    (B,S) against the gathered latent history. Returns o_lat (B,S,H,R)."""
    B, S, H, R = q_lat.shape
    ps = lat_pages.shape[1]
    NP = phys_table.shape[1]
    lat = _gather_latent(lat_pages, scale_pages, phys_table, R, opt_kv)
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(), lat[..., :R])
         + torch.einsum("bshe,bte->bhst", q_rope.float(), lat[..., R:])) \
        * sm_scale
    kpos = torch.arange(NP * ps, device=q_lat.device)[None, None, :]
    qpos = positions.long()[:, :, None]
    ok = (kpos <= qpos) & \
        (phys_table >= 0).repeat_interleave(ps, dim=1)[:, None, :]
    if window:
        ok &= (kpos > qpos - window) | (kpos < sink_pages * ps)
    s = torch.where(ok[:, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,btr->bshr", p, lat[..., :R])


def flash_prefill_ref(q, k, v, *, window: int = 0, q_offset: int = 0):
    """Naive full-matrix causal (windowed) GQA attention of K8. q (B,S,Hq,D),
    k/v (B,T,Hkv,D); query s sits at position q_offset + s."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bshgd,bthd->bhgst", qf, k.float()) / math.sqrt(D)
    spos = q_offset + torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = spos >= kpos
    if window:
        mask &= (spos - kpos) < window
    s = torch.where(mask[None, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype)
