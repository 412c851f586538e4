"""K1 — Opt-KV write path (paper §3.1 Alg. 1 Phase 1 + Eq. 5): scatter new
tokens' K/V into the GLOBAL paged pool with fused FP8 e4m3 quantization.

``kv_cache_write`` launches ``csrc/kv_cache_write.cu`` on CUDA tensors and
runs ``kv_cache_write_ref``, its plain PyTorch version, on CPU tensors. Both
update the cache in place and drop every slot < 0 (the SkipSet). The JAX
kernel instead routes those tokens to the pool's last line, a sentinel the
BlockManager never allocates, so the two pools agree everywhere but there.
The kernel takes its launch from ``write_plan``; ``kernel_info`` reports
an instantiation's registers and local bytes.
"""
from __future__ import annotations

import torch

from repro_torch.cache.quant import FP8_DTYPE, fp8_scale
from repro_torch.kernels import cuda

HEAD_DIMS = (64, 128, 256)
THREADS = 128            # threads a block at most (csrc kMaxThreads)
MAX_VECS = 2             # vectors a thread at most
_SMS = 132               # the H100's SMs: sizes the plan, never the result


def write_plan(n_tokens: int, hkv: int, d: int) -> tuple[int, int, int]:
    """The kernel's launch: (threads a block, vectors a thread, blocks).

    D/8 threads (a group) own one (token, K|V, head) vector, vectors being
    numbered in that order. A block holds threads / (D/8) groups, each
    taking ``vecs`` vectors ``groups`` apart, so block b covers vectors
    [b * groups * vecs, (b + 1) * groups * vecs). A launch that one vector
    a thread spreads over at most one block an SM (a decode step) takes one
    vector a thread; a larger one takes MAX_VECS, whose loads a thread
    issues together, at half the threads. A launch smaller than a block
    takes fewer threads, down to one warp."""
    if d not in HEAD_DIMS:
        raise ValueError(f"kv_cache_write: head_dim {d} not in {HEAD_DIMS}")
    g = d // 8
    n_vec = 2 * n_tokens * hkv
    vecs = 1 if n_vec * g <= THREADS * _SMS else MAX_VECS
    groups = -(-n_vec // vecs)
    threads = min(THREADS, max(32, -(-groups * g // 32) * 32))
    return threads, vecs, -(-n_vec // (threads // g * vecs))


def kv_cache_write_ref(k_new, v_new, slot_idx, k_cache, v_cache, k_scale,
                       v_scale, *, opt_kv: bool):
    """Plain version: per-(token, head) amax scale, x / scale cast to fp8,
    scatter to the valid slots. Caches are flat (NSlot, Hkv, D)."""
    B, S, Hkv, D = k_new.shape
    slots = slot_idx.reshape(-1).long()
    keep = (slots >= 0) & (slots < k_cache.shape[0])
    slots = slots[keep]
    for new, cache, scale in ((k_new, k_cache, k_scale),
                              (v_new, v_cache, v_scale)):
        x = new.reshape(B * S, Hkv, D)[keep].float()
        if opt_kv:
            sc = fp8_scale(x.abs().amax(dim=-1))
            cache[slots] = (x / sc[..., None]).to(cache.dtype)
            scale[slots] = sc
        else:
            cache[slots] = x.to(cache.dtype)
    return k_cache, v_cache, k_scale, v_scale


def _check(k_new, v_new, slot_idx, k_cache, v_cache, k_scale, v_scale,
           opt_kv):
    B, S, Hkv, D = k_new.shape
    dev = k_new.device
    for t in (v_new, slot_idx, k_cache, v_cache, k_scale, v_scale):
        if t is not None and t.device != dev:
            raise ValueError("kv_cache_write: all tensors must be on "
                             f"{dev}, got {t.device}")
    if k_new.dtype != torch.bfloat16 or v_new.shape != k_new.shape \
            or v_new.dtype != torch.bfloat16:
        raise ValueError("kv_cache_write: k_new/v_new must be bf16 "
                         f"(B,S,Hkv,D), got {k_new.dtype} {tuple(k_new.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kv_cache_write: head_dim {D} not in {HEAD_DIMS}")
    if slot_idx.dtype != torch.int32 or tuple(slot_idx.shape) != (B, S):
        raise ValueError("kv_cache_write: slot_idx must be int32 (B, S)")
    want = FP8_DTYPE if opt_kv else torch.bfloat16
    for c in (k_cache, v_cache):
        if c.dtype != want or c.dim() != 3 or tuple(c.shape[1:]) != (Hkv, D):
            raise ValueError(f"kv_cache_write: cache must be {want} "
                             f"(NSlot, {Hkv}, {D}), got {c.dtype} "
                             f"{tuple(c.shape)}")
    if opt_kv:
        for s in (k_scale, v_scale):
            if s is None or s.dtype != torch.float32 or \
                    tuple(s.shape) != (k_cache.shape[0], Hkv):
                raise ValueError("kv_cache_write: opt_kv needs f32 scales "
                                 "(NSlot, Hkv)")
    for t in (k_new, v_new, slot_idx, k_cache, v_cache, k_scale, v_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError("kv_cache_write: tensors must be contiguous")
    for t in (k_new, v_new, k_cache, v_cache):     # 16-byte rows and lines
        if t.data_ptr() % 16:
            raise ValueError("kv_cache_write: k/v_new and the caches must "
                             "start on a 16-byte boundary")


def kv_cache_write(k_new, v_new, slot_idx, k_cache, v_cache, k_scale,
                   v_scale, *, opt_kv: bool):
    """k/v_new: (B, S, Hkv, D) bf16; slot_idx: (B, S) int32 GLOBAL flat
    slots (< 0 = SkipSet, dropped); k/v_cache: (NSlot, Hkv, D) fp8 when
    ``opt_kv`` else bf16; k/v_scale: (NSlot, Hkv) f32 (None without
    ``opt_kv``). Updates the caches in place and returns them."""
    if k_new.device.type == "cpu":
        return kv_cache_write_ref(k_new, v_new, slot_idx, k_cache, v_cache,
                                  k_scale, v_scale, opt_kv=opt_kv)
    if not k_new.is_cuda:
        raise ValueError(f"kv_cache_write: unsupported device {k_new.device}")
    _launch(k_new, v_new, slot_idx, k_cache, v_cache, k_scale, v_scale,
            opt_kv)
    return k_cache, v_cache, k_scale, v_scale


def _launch(k_new, v_new, slot_idx, k_cache, v_cache, k_scale, v_scale,
            opt_kv):
    """Check the operands, then launch the kernel once."""
    _check(k_new, v_new, slot_idx, k_cache, v_cache, k_scale, v_scale, opt_kv)
    B, S, Hkv, D = k_new.shape
    threads, vecs, blocks = write_plan(B * S, Hkv, D)
    fn = cuda.library("kv_cache_write").kv_cache_write
    err = fn(k_new.data_ptr(), v_new.data_ptr(), slot_idx.data_ptr(), B * S,
             Hkv, D, k_cache.data_ptr(), v_cache.data_ptr(),
             cuda.ptr(k_scale if opt_kv else None),
             cuda.ptr(v_scale if opt_kv else None), k_cache.shape[0],
             int(opt_kv), threads, vecs, blocks,
             cuda.stream_ptr(k_new.device))
    cuda.check(err, "kv_cache_write")
    cuda.count("kv_cache_write")


KERNEL_INFO = ("registers", "local_bytes", "static_smem_bytes", "threads")


def kernel_info(d: int, opt_kv: bool, vecs: int, device=None) -> dict:
    """The instantiation for (head_dim ``d``, ``opt_kv``, ``vecs`` vectors a
    thread) as the loaded library reports it: registers and local bytes
    (spills and stack) a thread, static shared bytes, and the most threads
    a block."""
    return cuda.info("kv_cache_write", "kv_cache_write_info", KERNEL_INFO,
                     d, int(opt_kv), vecs, device=device)
