"""Flat-softmax oracle of the paged decode kernels (no blocking, no online
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

