"""K6 ``latent_chunk_prefill`` — MLA absorbed chunked-continuation prefill
attention over the GLOBAL paged latent pool (the MLA family's mixed step).

A chunk of absorbed queries per lane (rows r = s*H + h in latent space,
each row at its token's absolute position; a decode lane is a chunk of
length 1) attends the lane's cached latent pages (prefix hits, earlier
chunks and the chunk itself, already written) through its physical page
table. Masks are causal, window + sink, and the concat-prefill packing
planes: ``seg_q`` (B, S) per-token segment ids, ``page_seg`` (B, NP) and
``page_base`` (B, NP) per-slot segment and in-segment page index (key
positions ``page_base * ps + i``). None = unpacked: one segment and
``base`` = slot. Masked probabilities are hard-zeroed, and a page is
skipped when its entry is -1 or it lies wholly in the future of the
queries. Returns o_lat (B, S, H, R) f32.

The wrapper launches ``csrc/latent_chunk_prefill.cu`` on CUDA tensors and
runs ``latent_chunk_prefill_ref``, the plain version that follows the
kernel's page order and masks, on CPU tensors. ``return_state=True``
returns ``(o_lat, m, l)``, each row's final online-softmax max (natural
units of the scaled scores) and sum as f32 (B, S, H); a row that sees no
live key reports exactly (-1e30, 0).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.paged_latent_decode import (_latent_tiles,
                                                     check_latent_pool)

_NEG = -1e30


def latent_chunk_prefill_ref(q_lat, q_rope, positions, lat_pages,
                             scale_pages, phys_table, *, sm_scale: float,
                             opt_kv: bool, window: int = 0,
                             sink_pages: int = 0, seg_q=None, page_seg=None,
                             page_base=None, return_state: bool = False):
    """Plain version of K6: an online softmax over the lane's table slots in
    ascending order, masked probabilities hard-zeroed."""
    B, S, H, R = q_lat.shape
    ps = lat_pages.shape[1]
    NP = phys_table.shape[1]
    dev = q_lat.device
    RW = S * H
    qc = q_lat.float().reshape(B, RW, R)
    qr = q_rope.float().reshape(B, RW, -1)
    qpos = positions.long().repeat_interleave(H, dim=1)       # (B, RW)
    qseg = (torch.zeros_like(qpos) if seg_q is None
            else seg_q.long().repeat_interleave(H, dim=1))
    if page_base is None:
        page_base = torch.arange(NP, device=dev)[None].expand(B, NP)
    if page_seg is None:
        page_seg = torch.zeros((B, NP), dtype=torch.long, device=dev)
    max_pos = qpos.amax(dim=1)                                # (B,)
    m = torch.full((B, RW), _NEG, device=dev)
    l = torch.zeros((B, RW), device=dev)
    acc = torch.zeros((B, RW, R), device=dev)
    j = torch.arange(ps, device=dev)
    for slot in range(NP):
        page = phys_table[:, slot].long()
        base = page_base[:, slot].long()
        live = (page >= 0) & (base * ps <= max_pos)           # (B,)
        c, r = _latent_tiles(lat_pages, scale_pages, page.clamp_min(0), R,
                             opt_kv)
        kpos = base[:, None] * ps + j                         # (B, ps)
        mask = (kpos[:, None, :] <= qpos[:, :, None]) & \
            (qseg[:, :, None] == page_seg[:, slot].long()[:, None, None])
        if window:
            mask &= (kpos[:, None, :] > qpos[:, :, None] - window) | \
                (kpos[:, None, :] < sink_pages * ps)
        s = (torch.matmul(qc, c.transpose(-1, -2))
             + torch.matmul(qr, r.transpose(-1, -2))) * sm_scale
        s = torch.where(mask, s, _NEG)                        # (B, RW, ps)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.matmul(p, c)
        sel = live[:, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel[..., None], acc_new, acc)
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(B, S, H, R)
    if not return_state:
        return out
    return out, m.reshape(B, S, H), l.reshape(B, S, H)


def _check(q_lat, q_rope, positions, lat_pages, scale_pages, phys_table,
           planes, opt_kv):
    B, S, H, R = q_lat.shape
    NP = phys_table.shape[1]
    dev = q_lat.device
    name = "latent_chunk_prefill"
    for t in (q_rope, positions, lat_pages, scale_pages, phys_table) + planes:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    if q_lat.dtype != torch.float32 or q_rope.dtype != torch.float32 or \
            q_rope.dim() != 4 or q_rope.shape[:3] != (B, S, H):
        raise ValueError(f"{name}: q_lat (B,S,H,R) and q_rope (B,S,H,dr) "
                         "must be f32")
    check_latent_pool(name, lat_pages, scale_pages, R, q_rope.shape[3],
                      opt_kv)
    if positions.dtype != torch.int32 or tuple(positions.shape) != (B, S):
        raise ValueError(f"{name}: positions must be int32 (B, S)")
    if phys_table.dtype != torch.int32 or phys_table.shape[0] != B:
        raise ValueError(f"{name}: phys_table must be int32 (B, NP)")
    seg_q, page_seg, page_base = planes
    for t, shape in ((seg_q, (B, S)), (page_seg, (B, NP)),
                     (page_base, (B, NP))):
        if t is not None and (t.dtype != torch.int32 or
                              tuple(t.shape) != shape):
            raise ValueError(f"{name}: packing planes must be int32 {shape}")
    for t in (q_lat, q_rope, positions, lat_pages, scale_pages,
              phys_table) + planes:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def latent_chunk_prefill(q_lat, q_rope, positions, lat_pages, scale_pages,
                         phys_table, *, sm_scale: float, opt_kv: bool,
                         window: int = 0, sink_pages: int = 0, seg_q=None,
                         page_seg=None, page_base=None,
                         return_state: bool = False):
    """q_lat: (B, S, H, R) f32 absorbed chunk queries; q_rope: (B, S, H, dr)
    f32; positions: (B, S) int32 absolute positions; lat_pages: (P_total,
    ps, R+dr) GLOBAL latent pool (fp8 if ``opt_kv``, else bf16);
    scale_pages: (P_total, ps, 2) f32 or None; phys_table: (B, NP) int32
    physical pages in logical order (-1 = never read). The chunk's own
    latents must already be written. Returns (B, S, H, R) f32, with
    ``return_state`` ``(o_lat, m, l)`` (module docstring)."""
    if q_lat.device.type == "cpu":
        return latent_chunk_prefill_ref(
            q_lat, q_rope, positions, lat_pages, scale_pages, phys_table,
            sm_scale=sm_scale, opt_kv=opt_kv, window=window,
            sink_pages=sink_pages, seg_q=seg_q, page_seg=page_seg,
            page_base=page_base, return_state=return_state)
    if not q_lat.is_cuda:
        raise ValueError(f"latent_chunk_prefill: unsupported device "
                         f"{q_lat.device}")
    planes = (seg_q, page_seg, page_base)
    _check(q_lat, q_rope, positions, lat_pages, scale_pages, phys_table,
           planes, opt_kv)
    B, S, H, R = q_lat.shape
    out = torch.empty_like(q_lat)
    m = l = None
    if return_state:
        m = torch.empty((B, S, H), dtype=torch.float32, device=q_lat.device)
        l = torch.empty_like(m)
    fn = cuda.library("latent_chunk_prefill").latent_chunk_prefill
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), positions.data_ptr(),
             lat_pages.data_ptr(), cuda.ptr(scale_pages if opt_kv else None),
             phys_table.data_ptr(), cuda.ptr(page_base), cuda.ptr(page_seg),
             cuda.ptr(seg_q), out.data_ptr(), cuda.ptr(m), cuda.ptr(l), B, S,
             H, R, q_rope.shape[3], lat_pages.shape[1], phys_table.shape[1],
             int(opt_kv), window, sink_pages, sm_scale,
             cuda.stream_ptr(q_lat.device))
    cuda.check(err, "latent_chunk_prefill")
    cuda.count(cuda.state_name("latent_chunk_prefill", return_state))
    return (out, m, l) if return_state else out


KERNEL_INFO = ("rows_per_block", "threads", "smem_bytes", "registers",
               "local_bytes", "q_terms", "p_terms", "last_blocks")


def kernel_info(R: int, dr: int, opt_kv: bool, device=None) -> dict:
    """The kernel that runs for (R, dr, opt_kv), as the loaded library
    reports it: rows and threads a block, dynamic shared bytes, registers
    and local bytes (spills and stack) a thread, the bf16 terms of q and
    of P' = p * sc0, and the blocks of the library's last launch."""
    return cuda.info("latent_chunk_prefill", "latent_chunk_prefill_info",
                     KERNEL_INFO, R, dr, int(opt_kv), device=device)
