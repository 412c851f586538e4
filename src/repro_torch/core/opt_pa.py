"""Opt-Pa — paged attention for long sequences (paper §3.3, Alg. 3).

Decode-phase attention of ONE query token per lane against the GLOBAL paged
KV pool ``kv_pages (2, P_total, ps, Hkv, D)``, with a per-lane
``page_table (B, P_lane)`` naming the lane's physical pages in logical
order (-1 = unallocated), and the chunked-continuation prefill attention of
the engine's mixed steps.

With ``coopt.use_kernel`` both go through ``repro_torch.kernels.ops``, which
launches the hand-written CUDA kernels on CUDA tensors. Otherwise the plain
reference branches below run:
  * ``_flat`` — the Original baseline: every page in the lane's table is
    loaded and one flat softmax is taken over the whole padded history;
  * ``_blockwise`` — Opt-Pa: an online (max, sum, acc) softmax over groups
    of ``page_group`` pages (Eq. 10);
  * ``_windowed`` — the {sink + sliding window} block-sparse policy;
  * ``paged_chunk_attention`` — a position-masked softmax over the gathered
    view, with the concat-prefill packing planes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.coopt import CoOptConfig
from repro_torch.core.opt_kv import (decode_page_select, dequant_pages,
                                     gather_cached_kv, identity_page_table)
from repro_torch.models.layers import repeat_kv

_NEG = -1e30


def _scores(q, k, opt_gqa: bool):
    """q (B,Hq,D), k (B,T,Hkv,D) -> scores (B,Hq,T) f32 (scaled)."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    if opt_gqa and Hkv != Hq:
        qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
        s = torch.einsum("bhgd,bthd->bhgt", qg, k.float())
        return s.reshape(B, Hq, -1) * scale
    k = repeat_kv(k, Hq // Hkv)
    return torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale


def _weighted_v(p, v, opt_gqa: bool, Hq: int):
    """p (B,Hq,T) f32, v (B,T,Hkv,D) -> (B,Hq,D) f32."""
    Hkv = v.shape[2]
    if opt_gqa and Hkv != Hq:
        pg = p.reshape(p.shape[0], Hkv, Hq // Hkv, p.shape[-1])
        o = torch.einsum("bhgt,bthd->bhgd", pg, v.float())
        return o.reshape(p.shape[0], Hq, -1)
    v = repeat_kv(v, Hq // Hkv)
    return torch.einsum("bht,bthd->bhd", p, v.float())


def paged_decode_attention(q, kv_pages, scale_pages, cache_len, *,
                           coopt: CoOptConfig, window: int = 0,
                           sink_pages: int = 1,
                           page_table: Optional[torch.Tensor] = None):
    """q: (B, Hq, D); kv_pages: (2, P_total, ps, Hkv, D) global pool;
    cache_len: (B,) tokens valid per lane (the current token already
    written); page_table: (B, P_lane) physical pages in logical order
    (default: the static lane-identity partition). Returns (B, Hq, D)."""
    B, Hq, D = q.shape
    _, P_total, ps, Hkv, _ = kv_pages.shape
    if page_table is None:
        page_table = identity_page_table(B, P_total, q.device)

    if coopt.use_kernel:
        from repro_torch.kernels import ops
        phys, logical = decode_page_select(cache_len, page_table, ps,
                                           window=window,
                                           sink_pages=sink_pages,
                                           opt_pa=coopt.opt_pa)
        return ops.paged_pool_decode(
            q, kv_pages, scale_pages, cache_len, phys, logical,
            opt_kv=coopt.opt_kv,
            opt_gqa=True if window else coopt.opt_gqa,
            window=window, sink_pages=sink_pages if window else 0,
            share_visits=coopt.share_visits)

    if window:
        phys, logical = decode_page_select(cache_len, page_table, ps,
                                           window=window,
                                           sink_pages=sink_pages)
        return _windowed(q, kv_pages, scale_pages, cache_len, phys, logical,
                         window, sink_pages, coopt)

    flat = gather_cached_kv(kv_pages, scale_pages, page_table, coopt)
    Psel = page_table.shape[1]
    kv_lane = flat.reshape(2, B, Psel, ps, Hkv, D)
    valid = (page_table >= 0).repeat_interleave(ps, dim=1)   # (B, Psel*ps)
    coopt = coopt.replace(opt_kv=False)                      # dequantized
    if coopt.opt_pa:
        return _blockwise(q, kv_lane, None, cache_len, coopt, valid)
    return _flat(q, kv_lane, None, cache_len, coopt, valid)


# ------------------------------------------------ continuation prefill ----
def paged_chunk_attention(q, kv_pages, scale_pages, positions, page_table,
                          coopt: CoOptConfig, *, window: int = 0,
                          sink_pages: int = 1, seg_q=None, page_seg=None,
                          page_base=None):
    """Chunked-continuation prefill attention (the ONE ragged step path): a
    chunk of queries per lane — q (B,S,Hq,D) with absolute ``positions``
    (B,S) — attends over the lane's whole cached history (the chunk's own
    K/V already written) through its page table. A decode lane is a chunk
    of length 1. ``window`` > 0 applies the {sliding window + sink} policy.

    Concat-prefill packing: ``seg_q`` (B,S), ``page_seg`` (B,NP) and
    ``page_base`` (B,NP) pack several prompts' chunks into one row — a query
    attends a key only when their segment ids match, and key positions
    restart per segment at ``page_base * ps``. None = unpacked.
    Returns (B, S, Hq, D) in q.dtype."""
    B, S, Hq, D = q.shape
    _, P_total, ps, Hkv, _ = kv_pages.shape
    if page_table is None:
        page_table = identity_page_table(B, P_total, q.device)

    if coopt.use_kernel:
        from repro_torch.kernels import ops
        return ops.paged_chunk_prefill(
            q, positions, kv_pages, scale_pages, page_table,
            opt_kv=coopt.opt_kv, opt_gqa=coopt.opt_gqa, window=window,
            sink_pages=sink_pages, seg_q=seg_q, page_seg=page_seg,
            page_base=page_base)

    k, v = gather_cached_kv(kv_pages, scale_pages, page_table, coopt)
    T = k.shape[1]
    if not coopt.opt_gqa and Hkv != Hq:
        k, v = repeat_kv(k, Hq // Hkv), repeat_kv(v, Hq // Hkv)
        Hg, G = Hq, 1
    else:
        Hg, G = Hkv, Hq // Hkv
    qg = q.reshape(B, S, Hg, G, D).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * (1.0 / math.sqrt(D))
    dev = q.device
    if page_base is not None:
        kpos = (page_base.to(torch.int32)[:, :, None] * ps
                + torch.arange(ps, dtype=torch.int32, device=dev)[None, None]
                ).reshape(B, T)[:, None, :]
    else:
        kpos = torch.arange(T, dtype=torch.int32, device=dev)[None, None, :]
    qpos = positions[:, :, None]
    mask = (kpos <= qpos) & \
        (page_table >= 0).repeat_interleave(ps, dim=1)[:, None, :]
    if seg_q is not None:
        mask &= (page_seg.to(torch.int32).repeat_interleave(ps, dim=1)
                 [:, None] == seg_q.to(torch.int32)[:, :, None])
    if window:
        mask &= (kpos > qpos - window) | (kpos < sink_pages * ps)
    s = torch.where(mask[:, None, None], s, _NEG)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", pr, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype)


# --------------------------------------------------------------- Original --
def _flat(q, kv_pages, scale_pages, cache_len, coopt, valid):
    B, Hq, D = q.shape
    _, _, P, ps, Hkv, _ = kv_pages.shape
    kv = dequant_pages(kv_pages, scale_pages, coopt)        # ALL pages loaded
    k, v = kv.reshape(2, B, P * ps, Hkv, D)
    s = _scores(q, k, coopt.opt_gqa)                        # (B,Hq,T)
    pos = torch.arange(P * ps, device=q.device)[None, None, :]
    mask = pos < cache_len[:, None, None]
    if valid is not None:
        mask &= valid[:, None, :]
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)                        # Eq. 8 / Eq. 10
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return _weighted_v(p, v, coopt.opt_gqa, Hq).to(q.dtype)


# ----------------------------------------------------- Opt-Pa (block-wise) --
def effective_page_group(num_pages: int, page_group: int) -> Tuple[int, int]:
    """Opt-Pa group size used by ``_blockwise`` for ``num_pages`` pages:
    (group, padded page count). The page axis is padded with masked pages
    up to a multiple of ``page_group`` instead of shrinking the group."""
    pg = max(min(page_group, num_pages), 1)
    return pg, num_pages + (-num_pages) % pg


def _blockwise(q, kv_pages, scale_pages, cache_len, coopt, valid):
    B, Hq, D = q.shape
    _, _, P, ps, Hkv, _ = kv_pages.shape
    pg, P_pad = effective_page_group(P, coopt.page_group)
    if P_pad != P:
        pad = P_pad - P
        kv_pages = torch.nn.functional.pad(
            kv_pages, (0, 0, 0, 0, 0, 0, 0, pad))
        if scale_pages is not None:
            scale_pages = torch.nn.functional.pad(
                scale_pages, (0, 0, 0, 0, 0, pad))
        if valid is None:
            valid = torch.ones((B, P * ps), dtype=torch.bool, device=q.device)
        valid = torch.nn.functional.pad(valid, (0, pad * ps))
        P = P_pad
    NG, T = P // pg, pg * ps
    kv_g = kv_pages.reshape(2, B, NG, T, Hkv, D)
    sc_g = (scale_pages.reshape(2, B, NG, T, Hkv)
            if scale_pages is not None else None)
    valid_g = valid.reshape(B, NG, T) if valid is not None else None

    m = torch.full((B, Hq, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, D), dtype=torch.float32, device=q.device)
    for g in range(NG):
        k, v = dequant_pages(kv_g[:, :, g],
                             None if sc_g is None else sc_g[:, :, g], coopt)
        s = _scores(q, k, coopt.opt_gqa)                    # (B,Hq,T)
        pos = g * T + torch.arange(T, device=q.device)[None, None, :]
        mask = pos < cache_len[:, None, None]
        if valid_g is not None:
            mask &= valid_g[:, g][:, None, :]
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)                         # block_sum analogue
        p = torch.exp(s - m_new)
        l = l * corr[..., 0] + p.sum(dim=-1)
        acc = acc * corr + _weighted_v(p, v, coopt.opt_gqa, Hq)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


# ------------------------------------------------ window/sink block-sparse --
def _windowed(q, kv_pages, scale_pages, cache_len, phys_table, logical_table,
              window, sink_pages, coopt):
    B, Hq, D = q.shape
    _, P, ps, Hkv, _ = kv_pages.shape
    k, v = gather_cached_kv(kv_pages, scale_pages, phys_table, coopt)
    pos = (logical_table.clamp_min(0).long()[:, :, None] * ps
           + torch.arange(ps, device=q.device)[None, None, :]).reshape(B, -1)
    cl = cache_len.long()[:, None]
    in_ctx = pos < cl
    in_win = pos >= (cl - window).clamp_min(0)
    in_sink = pos < sink_pages * ps
    mask = in_ctx & (in_win | in_sink) & \
        (phys_table >= 0).repeat_interleave(ps, dim=1)
    s = _scores(q, k, coopt.opt_gqa)
    s = torch.where(mask[:, None, :], s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return _weighted_v(p, v, coopt.opt_gqa, Hq).to(q.dtype)
