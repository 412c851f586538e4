"""K8 ``flash_prefill`` — causal grouped-query flash attention of a whole
prompt over its own contiguous K/V (the dense family's full-prompt
prefill; no pool, no paging).

q (B, S, Hq, D) attends k, v (B, T, Hkv, D): query rows are (seq, group)
pairs of one kv head, r = s*G + g with G = Hq / Hkv (the caller expands
K/V per query head when Opt-GQA is off, so G = 1 there), query s at
position ``q_offset + s``; key t is kept when t <= that position and,
with ``window``, when it lies fewer than ``window`` positions back. An
online (m, l, acc) softmax runs over key blocks of ``BLOCK_K`` in
ascending order; a block wholly in the future of the queries, or wholly
before their window, is skipped. Returns (B, S, Hq, D) in q's dtype.

The wrapper launches ``csrc/flash_prefill.cu`` on CUDA tensors and runs
``flash_prefill_ref``, the plain version that follows the kernel's block
order (masked probabilities not hard-zeroed, as in the Pallas kernel), on
CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda

_NEG = -1e30
BLOCK_K = 64                     # csrc/flash_prefill.cu kBlockK


def flash_prefill_ref(q, k, v, *, window: int = 0, q_offset: int = 0):
    """Plain version of K8: an online softmax over key blocks of BLOCK_K
    in ascending order for every row."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    R = S * G
    qf = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, R, D)
    spos = q_offset + torch.arange(S, device=dev).repeat_interleave(G)
    m = torch.full((B, Hkv, R), _NEG, device=dev)
    l = torch.zeros((B, Hkv, R), device=dev)
    acc = torch.zeros((B, Hkv, R, D), device=dev)
    sm_scale = 1.0 / math.sqrt(D)
    for k0 in range(0, T, BLOCK_K):
        kb = k[:, k0:k0 + BLOCK_K].float().transpose(1, 2)    # (B,Hkv,nk,D)
        vb = v[:, k0:k0 + BLOCK_K].float().transpose(1, 2)
        kpos = k0 + torch.arange(kb.shape[2], device=dev)
        mask = kpos[None, :] <= spos[:, None]                 # (R, nk)
        if window:
            mask &= (spos[:, None] - kpos[None, :]) < window
        s = torch.matmul(qf, kb.transpose(-1, -2)) * sm_scale
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]                 # (B,Hkv,R,D)
    out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _check(q, k, v):
    B, S, Hq, D = q.shape
    name = "flash_prefill"
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}")
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[0] != B \
                or t.shape[3] != D or tuple(t.shape) != tuple(k.shape):
            raise ValueError(f"{name}: k, v must be bf16 (B, T, Hkv, {D})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16, got {q.dtype}")
    if D not in (64, 128) or Hq % k.shape[2]:
        raise ValueError(f"{name}: unsupported geometry D={D} Hq={Hq} "
                         f"Hkv={k.shape[2]}")


def flash_prefill(q, k, v, *, window: int = 0, q_offset: int = 0):
    """q: (B, S, Hq, D) bf16; k, v: (B, T, Hkv, D) bf16, contiguous. Causal
    (optionally windowed) grouped-query attention; returns (B, S, Hq, D)
    bf16."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, window=window, q_offset=q_offset)
    if not q.is_cuda:
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    _check(q, k, v)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = cuda.library("flash_prefill").flash_prefill
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             T, Hq, Hkv, D, window, q_offset, 1.0 / math.sqrt(D),
             cuda.stream_ptr(q.device))
    cuda.check(err, "flash_prefill")
    cuda.count("flash_prefill")
    return out
