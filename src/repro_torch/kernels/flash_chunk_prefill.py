"""K3 ``flash_chunk_prefill`` — chunked-continuation prefill attention over
the GLOBAL paged-KV pool (the engine's mixed step).

A chunk of queries per lane, each with an absolute position, attends the
lane's cached pages (earlier chunks, prefix-cache hits and the chunk
itself, already written) through its physical page table. Rows are (seq,
group) pairs; masks are causal, window + sink, and the concat-prefill
packing planes: ``seg_q`` (B, S) per-row segment ids, ``page_seg`` (B, NP)
and ``page_base`` (B, NP) per-slot segment and in-segment page index (key
positions ``page_base * ps + i``). None = unpacked: one segment per row and
``base`` = slot. Masked probabilities are hard-zeroed, and a page is
skipped when its entry is -1 or it lies wholly in the future of the
queries.

The wrapper launches ``csrc/flash_chunk_prefill.cu`` on CUDA tensors and
runs ``flash_chunk_prefill_ref``, the plain version that follows the
kernel's page order and masks, on CPU tensors. ``return_state=True``
returns ``(o, m, l)``, each row's final online-softmax max (natural units
of the scaled scores) and sum as f32 (B, S, Hq); a row that sees no live
key reports exactly (-1e30, 0).
"""
from __future__ import annotations

import math

import torch

from repro_torch.cache.quant import FP8_DTYPE
from repro_torch.kernels import cuda
from repro_torch.kernels.paged_gqa_decode import (HEAD_DIMS, MAX_PAGE_SIZE,
                                                  _geometry, _lane_pages)

_NEG = -1e30


def _rows(x, heads, G):
    """(B, S, heads*G, ...) -> (B, heads, S*G, ...): row r = s*G + g."""
    B, S = x.shape[:2]
    tail = x.shape[3:]
    return x.reshape(B, S, heads, G, *tail).transpose(1, 2) \
            .reshape(B, heads, S * G, *tail)


def flash_chunk_prefill_ref(q, positions, k_pages, v_pages, k_scale, v_scale,
                            phys_table, *, opt_kv: bool, opt_gqa: bool = True,
                            window: int = 0, sink_pages: int = 0, seg_q=None,
                            page_seg=None, page_base=None,
                            return_state: bool = False):
    """Plain version of K3: an online softmax over the lane's table slots in
    ascending order, masked probabilities hard-zeroed."""
    B, S, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    NP = phys_table.shape[1]
    dev = q.device
    heads, G, kv_of = _geometry(Hq, Hkv, opt_gqa, dev)
    R = S * G
    qf = _rows(q.float().reshape(B, S, Hq, D), heads, G)      # (B,h,R,D)
    qpos = positions.long().repeat_interleave(G, dim=1)       # (B, R)
    qseg = (torch.zeros_like(qpos) if seg_q is None
            else seg_q.long().repeat_interleave(G, dim=1))
    if page_base is None:
        page_base = torch.arange(NP, device=dev)[None].expand(B, NP)
    if page_seg is None:
        page_seg = torch.zeros((B, NP), dtype=torch.long, device=dev)
    max_pos = qpos.amax(dim=1)                                # (B,)
    m = torch.full((B, heads, R), _NEG, device=dev)
    l = torch.zeros((B, heads, R), device=dev)
    acc = torch.zeros((B, heads, R, D), device=dev)
    j = torch.arange(ps, device=dev)
    sm_scale = 1.0 / math.sqrt(D)
    for slot in range(NP):
        page = phys_table[:, slot].long()
        base = page_base[:, slot].long()
        live = (page >= 0) & (base * ps <= max_pos)           # (B,)
        ids = page.clamp_min(0)
        k = _lane_pages(k_pages, k_scale, ids, kv_of, opt_kv)
        v = _lane_pages(v_pages, v_scale, ids, kv_of, opt_kv)
        kpos = base[:, None] * ps + j                         # (B, ps)
        mask = (kpos[:, None, :] <= qpos[:, :, None]) & \
            (qseg[:, :, None] == page_seg[:, slot].long()[:, None, None])
        if window:
            mask &= (kpos[:, None, :] > qpos[:, :, None] - window) | \
                (kpos[:, None, :] < sink_pages * ps)
        mask = mask[:, None]                                  # (B,1,R,ps)
        s = torch.matmul(qf, k.transpose(-1, -2)) * sm_scale  # (B,h,R,ps)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.matmul(p, v)
        sel = live[:, None, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel[..., None], acc_new, acc)
    out = acc / l.clamp_min(1e-30)[..., None]                 # (B,h,R,D)
    out = out.reshape(B, heads, S, G, D).transpose(1, 2).reshape(B, S, Hq, D)
    if not return_state:
        return out.to(q.dtype)

    def rows(x):                                    # (B,h,R) -> (B,S,Hq)
        return x.reshape(B, heads, S, G).transpose(1, 2).reshape(B, S, Hq)
    return out.to(q.dtype), rows(m), rows(l)


def _check(q, positions, k_pages, v_pages, k_scale, v_scale, phys_table,
           planes, opt_kv):
    B, S, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    NP = phys_table.shape[1]
    dev = q.device
    for t in (positions, k_pages, v_pages, k_scale, v_scale, phys_table) + \
            planes:
        if t is not None and t.device != dev:
            raise ValueError(f"flash_chunk_prefill: all tensors must be on {dev}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_chunk_prefill: q must be bf16, got {q.dtype}")
    if D not in HEAD_DIMS or ps > MAX_PAGE_SIZE or Hq % Hkv:
        raise ValueError(f"flash_chunk_prefill: unsupported geometry "
                         f"D={D} ps={ps} Hq={Hq} Hkv={Hkv}")
    want = FP8_DTYPE if opt_kv else torch.bfloat16
    for p in (k_pages, v_pages):
        if p.dtype != want or tuple(p.shape) != (P, ps, Hkv, D):
            raise ValueError("flash_chunk_prefill: pages must be "
                             f"{want} (P, ps, Hkv, D)")
    if opt_kv:
        for s in (k_scale, v_scale):
            if s is None or s.dtype != torch.float32 or \
                    tuple(s.shape) != (P, ps, Hkv):
                raise ValueError("flash_chunk_prefill: opt_kv needs f32 "
                                 "scales (P, ps, Hkv)")
    if positions.dtype != torch.int32 or tuple(positions.shape) != (B, S):
        raise ValueError("flash_chunk_prefill: positions must be int32 (B, S)")
    if phys_table.dtype != torch.int32 or phys_table.shape[0] != B:
        raise ValueError("flash_chunk_prefill: phys_table must be int32 (B, NP)")
    seg_q, page_seg, page_base = planes
    for t, shape in ((seg_q, (B, S)), (page_seg, (B, NP)),
                     (page_base, (B, NP))):
        if t is not None and (t.dtype != torch.int32 or
                              tuple(t.shape) != shape):
            raise ValueError("flash_chunk_prefill: packing planes must be "
                             f"int32 {shape}")
    for t in (q, positions, k_pages, v_pages, k_scale, v_scale,
              phys_table) + planes:
        if t is not None and not t.is_contiguous():
            raise ValueError("flash_chunk_prefill: tensors must be contiguous")


def flash_chunk_prefill(q, positions, k_pages, v_pages, k_scale, v_scale,
                        phys_table, *, opt_kv: bool, opt_gqa: bool = True,
                        window: int = 0, sink_pages: int = 0, seg_q=None,
                        page_seg=None, page_base=None,
                        return_state: bool = False):
    """q: (B, S, Hq, D) bf16 chunk queries; positions: (B, S) int32
    absolute positions; k/v_pages: (P_total, ps, Hkv, D) GLOBAL pool (fp8 if
    ``opt_kv``); k/v_scale: (P_total, ps, Hkv) f32 or None; phys_table:
    (B, NP) int32 physical pages in logical order (-1 = never read). The
    chunk's own K/V must already be written. Returns (B, S, Hq, D) bf16,
    with ``return_state`` ``(o, m, l)`` (module docstring)."""
    if q.device.type == "cpu":
        return flash_chunk_prefill_ref(
            q, positions, k_pages, v_pages, k_scale, v_scale, phys_table,
            opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
            sink_pages=sink_pages, seg_q=seg_q, page_seg=page_seg,
            page_base=page_base, return_state=return_state)
    if not q.is_cuda:
        raise ValueError(f"flash_chunk_prefill: unsupported device {q.device}")
    planes = (seg_q, page_seg, page_base)
    _check(q, positions, k_pages, v_pages, k_scale, v_scale, phys_table,
           planes, opt_kv)
    B, S, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    m = l = None
    if return_state:
        m = torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    fn = cuda.library("flash_chunk_prefill").flash_chunk_prefill
    err = fn(q.data_ptr(), positions.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), cuda.ptr(k_scale if opt_kv else None),
             cuda.ptr(v_scale if opt_kv else None), phys_table.data_ptr(),
             cuda.ptr(page_base), cuda.ptr(page_seg), cuda.ptr(seg_q),
             out.data_ptr(), cuda.ptr(m), cuda.ptr(l), B, S, Hq, Hkv, D, ps,
             phys_table.shape[1], int(opt_kv), int(opt_gqa), window,
             sink_pages, 1.0 / math.sqrt(D), cuda.stream_ptr(q.device))
    cuda.check(err, "flash_chunk_prefill")
    cuda.count(cuda.state_name("flash_chunk_prefill", return_state))
    return (out, m, l) if return_state else out


KERNEL_INFO = ("registers", "local_bytes", "static_smem_bytes", "smem_bytes",
               "threads")


def kernel_info(d: int, opt_kv: bool, ps: int, device=None) -> dict:
    """The kernel for (head_dim ``d``, ``opt_kv``) as the loaded library
    reports it: registers and local bytes (spills and stack) a thread,
    static shared bytes, the dynamic shared bytes at page size ``ps``, and
    the threads a block."""
    return cuda.info("flash_chunk_prefill", "flash_chunk_prefill_info",
                     KERNEL_INFO, d, int(opt_kv), ps, device=device)
