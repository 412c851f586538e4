"""FP8 (e4m3) quantization for the KV cache — Opt-KV's storage format.

Scales are per-(token, head): one f32 per head vector,
``max(amax, 1e-12) / 448``, and the quantized value is ``x / scale`` cast
to ``torch.float8_e4m3fn`` (round to nearest even). The pool bytes this
produces are the ones the JAX package's ``quantize_fp8`` produces.
"""
from __future__ import annotations

import torch

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0  # e4m3fn finite max
_EPS = 1e-12


def quantize_fp8(x: torch.Tensor, dim: int = -1):
    """x (..., D) -> (q fp8 (..., D), scale f32 (...,) reduced over ``dim``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim)
    scale = fp8_scale(amax)
    q = (xf / scale.unsqueeze(dim)).to(FP8_DTYPE)
    return q, scale


def fp8_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 448`` with IEEE division. The divisor is a
    tensor on purpose: PyTorch's CUDA kernel divides by a Python scalar as
    a multiply by its reciprocal, which rounds some scales one ulp away."""
    return amax.clamp_min(_EPS) / torch.full_like(amax, FP8_MAX)


def dequantize_fp8(q: torch.Tensor, scale: torch.Tensor, dim: int = -1,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Eq. 6: k~ = dequant(k_fp8)."""
    return (q.float() * scale.unsqueeze(dim)).to(dtype)


# ------------------------------------------------- MLA latent (dual-scale) --
def quantize_latent(latent: torch.Tensor, lora_rank: int):
    """MLA latent cache entry ``[c_kv | k_rope]`` (..., R+dr) -> FP8 with two
    per-token scales (..., 2): column 0 scales the c_kv segment, column 1
    the k_rope segment. The two segments come from different projections
    with different dynamic ranges; one shared scale would crush the smaller
    segment's mantissa."""
    qc, sc = quantize_fp8(latent[..., :lora_rank])
    qr, sr = quantize_fp8(latent[..., lora_rank:])
    return torch.cat([qc, qr], dim=-1), torch.stack([sc, sr], dim=-1)


def dequantize_latent(q: torch.Tensor, scales: torch.Tensor, lora_rank: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Eq. 6 for the latent layout: (..., R+dr) fp8 + (..., 2) scales ->
    the dequantized latent, c_kv and k_rope segments scaled separately."""
    c = dequantize_fp8(q[..., :lora_rank], scales[..., 0], dtype=dtype)
    r = dequantize_fp8(q[..., lora_rank:], scales[..., 1], dtype=dtype)
    return torch.cat([c, r], dim=-1)
