"""Shared layer primitives of the port: norms, activations, RoPE,
projections, the full-sequence causal attention, and parameter init.

Weights keep the JAX package's ``(d_in, d_out)`` layout (``x @ w``), so a
parameter tree converts by value without transposes. The JAX package's
activation-sharding constraints have no counterpart on one GPU.
"""
from __future__ import annotations

import math

import torch


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------
def init_param(shape, init: str, gen: torch.Generator, device,
               dtype=torch.bfloat16) -> torch.Tensor:
    """One parameter leaf: "zeros" | "ones" | "uniform1" (U[0, 1): RWKV's
    mix coefficients) | "embed" (N(0, 0.02)) | "normal" (fan-in scaled:
    std = 1/sqrt(shape[-2]) for matrices, the JAX package's rule). Draws in
    f32 from ``gen`` on ``device``, then casts: a stacked (L, ...) leaf one
    layer at a time, so a full-size model never holds a leaf-sized f32
    temporary."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "uniform1":
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32).to(dtype)
    if init == "embed":
        std = 0.02
    else:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in (out if len(shape) >= 3 else [out]):
        x = torch.randn(part.shape, generator=gen, device=device,
                        dtype=torch.float32)
        part.copy_(x.mul_(std))
    return out


def init_tree(spec, seed: int, device):
    """A nested dict of (shape, init, dtype) leaves -> the same dict of
    tensors, drawn in order from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(leaf):
        if isinstance(leaf, dict):
            return {k: make(v) for k, v in leaf.items()}
        shape, init, dtype = leaf
        return init_param(shape, init, gen, device, dtype)
    return make(spec)


def tree_count(spec) -> int:
    """Parameters in a nested dict of (shape, init, dtype) leaves."""
    if isinstance(spec, dict):
        return sum(tree_count(v) for v in spec.values())
    return math.prod(spec[0])


# ----------------------------------------------------------------------------
# Norms / activations / projections
# ----------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm with f32 statistics and an affine bias (whisper)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), each step rounded to x's dtype, as XLA evaluates
    ``jax.nn.silu`` on bf16 (``F.silu`` rounds once and differs from it in
    about a third of bf16 outputs)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def swiglu(x, wg, wu, wd):
    return linear(silu(linear(x, wg)) * linear(x, wu), wd)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is erf), each step rounded to x's dtype as XLA evaluates it on
    bf16: x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))."""
    c = torch.tensor(_SQRT_2_OVER_PI, dtype=torch.float32).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def gelu_mlp(x, w1, b1, w2, b2):
    """Whisper's MLP: ``gelu`` (the tanh form, ``jax.nn.gelu``'s default)
    between two biased projections."""
    return linear(gelu(linear(x, w1, b1)), w2, b2)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``; ``F.softplus`` switches to x above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim/2)."""
    half = head_dim // 2
    exponent = (torch.arange(half, dtype=torch.float32,
                             device=positions.device) * 2.0 / head_dim)
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: (..., S) broadcastable."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    cos, sin = cos[..., None, :], sin[..., None, :]       # (..., S, 1, d/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Full-sequence grouped-query attention, q-chunked so the (S x S) score
# matrix is never materialised whole.
# ----------------------------------------------------------------------------
def causal_attention(q, k, v, *, window: int = 0, chunk_q: int = 256,
                     causal: bool = True, q_offset: int = 0):
    """q: (B,S,Hq,D)  k,v: (B,T,Hkv,D)  -> (B,S,Hq,D).

    Grouped (Opt-GQA Eq. 7/8): q heads are folded to (Hkv, G) and share each
    KV head. ``window>0`` = sliding window; ``q_offset`` = absolute position
    of q[0]."""
    B, S, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    kpos = torch.arange(T, device=q.device)

    nchunks = max(S // chunk_q, 1)
    cq = S // nchunks if S % nchunks == 0 else S
    outs = []
    for ci in range(S // cq):
        qs = qg[:, ci * cq:(ci + 1) * cq]
        qpos = q_offset + ci * cq + torch.arange(cq, device=q.device)
        s = torch.einsum("bqhgd,bthd->bhgqt", qs.float(), k.float()) * scale
        mask = torch.ones((cq, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)   # fully masked rows
        p = torch.exp(s - m)
        p = p / p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqt,bthd->bqhgd", p.to(v.dtype), v)
        outs.append(o.reshape(B, cq, Hq, Dv))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def repeat_kv(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """Original-mode (non-Opt-GQA) path: materialise duplicated KV heads."""
    if repeats == 1:
        return x
    B, T, Hkv, D = x.shape
    return x[:, :, :, None].expand(B, T, Hkv, repeats, D) \
        .reshape(B, T, Hkv * repeats, D)
