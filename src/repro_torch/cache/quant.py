"""FP8 (e4m3) quantization for the KV cache — Opt-KV's storage format.

Scales are per-(token, head): one f32 per head vector,
``max(amax, 1e-12) / 448``, and the quantized value is ``x / scale`` cast
to ``torch.float8_e4m3fn`` (round to nearest even). The pool bytes this
produces are the ones the JAX package's ``quantize_fp8`` produces.

Also the host-DRAM tier's page codec (``HostPage``): a spilled pool page,
verbatim or with its bf16 leaves fp8-encoded (``CacheConfig.host_quant``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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


def select(mask: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """``torch.where(mask, new, old)``; one-byte float leaves (fp8 pools and
    cross K/V) are selected as their bytes, through a uint8 view."""
    if old.dtype.itemsize == 1 and old.dtype.is_floating_point:
        return torch.where(mask, new.view(torch.uint8),
                           old.view(torch.uint8)).view(old.dtype)
    return torch.where(mask, new, old)


# --------------------------------------------- host-DRAM spill page codec --
@dataclasses.dataclass
class HostPage:
    """One spilled prefix page: a per-pool-leaf slice of the device pool
    (the ``pages`` axis removed), moved to host memory by the engine's
    spill sink.

    When ``encoded`` is set, bf16 leaves were fp8-quantized on spill and
    ``scales[name]`` holds the per-vector f32 scales that dequantize them
    on prefetch; fp8 and f32 leaves (Opt-KV pools and their scales) are
    always carried verbatim, so their spill -> prefetch roundtrip is
    byte-lossless."""
    leaves: Dict[str, torch.Tensor]
    scales: Dict[str, torch.Tensor]
    encoded: bool

    @property
    def nbytes(self) -> int:
        """From shapes and dtypes only: never waits for a copy."""
        arrs = list(self.leaves.values()) + list(self.scales.values())
        return sum(a.numel() * a.element_size() for a in arrs)


def encode_host_page(leaves: Dict[str, torch.Tensor],
                     quantize: bool = False) -> HostPage:
    """Pack pool-page slices for the host store: verbatim by default
    (byte-lossless); with ``quantize`` every bf16 leaf is fp8(e4m3)-encoded
    with per-vector scales over the last axis, while fp8, f32 and integer
    leaves stay verbatim."""
    out: Dict[str, torch.Tensor] = {}
    scales: Dict[str, torch.Tensor] = {}
    encoded = False
    for name, arr in leaves.items():
        if quantize and arr.dtype == torch.bfloat16:
            out[name], scales[name] = quantize_fp8(arr)
            encoded = True
        else:
            out[name] = arr
    return HostPage(out, scales, encoded)


def decode_host_page(page: HostPage, name: str,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """One leaf of a host page back in its pool dtype."""
    arr = page.leaves[name]
    if name in page.scales:
        return dequantize_fp8(arr, page.scales[name], dtype=dtype)
    return arr


def quant_roundtrip_error(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max relative error of the fp8 roundtrip, relative to each vector's
    largest magnitude."""
    q, s = quantize_fp8(x, dim)
    back = dequantize_fp8(q, s, dim, torch.float32)
    denom = x.float().abs().amax(dim=dim, keepdim=True).clamp_min(_EPS)
    return ((back - x.float()).abs() / denom).max()
