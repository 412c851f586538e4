"""Plain float32 building blocks of the references, and the two precisions
they run in: ``F32`` (the reference, TF32 off) and ``FP8`` (the control:
every matrix product's operands rounded to float8 e4m3, activations per
row and weights per output column, then multiplied in float32).

Nothing here imports the program."""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class F32:
    name = "f32"

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation operand: rows along the last dimension."""
        return x

    def wt(self, w: torch.Tensor) -> torch.Tensor:
        """A weight (d_in, d_out) operand, as float32."""
        return w.float()


class FP8(F32):
    name = "fp8"

    def act(self, x):
        return q8(x, -1)

    def wt(self, w):
        return q8(w.float(), -2)


def mm(prec, x, w, b=None):
    y = prec.act(x) @ prec.wt(w)
    return y if b is None else y + b.float()


@contextlib.contextmanager
def exact_f32():
    """Matrix products in full float32: TF32 off for cuBLAS and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * scale.float()


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, pos, theta):
    """x (T, H, d) rotated by position: pairs (i, i + d/2), frequency
    theta^(-2i/d)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(d // 2, device=x.device,
                                       dtype=torch.float64) * 2 / d)
    ang = (pos.double()[:, None] * inv[None]).float()
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(prec, q, k, v, scale, chunk=512):
    """q (T, H, dq), k (T, Hkv, dq), v (T, Hkv, dv): causal softmax
    attention, query heads grouped over the KV heads. Returns (T, H, dv)."""
    T, H, dq = q.shape
    Hkv, dv = k.shape[1], v.shape[2]
    G = H // Hkv
    q, k, v = prec.act(q), prec.act(k), prec.act(v)
    qg = q.reshape(T, Hkv, G, dq)
    out = torch.empty((T, Hkv, G, dv), dtype=torch.float32, device=q.device)
    for a in range(0, T, chunk):
        b = min(a + chunk, T)
        s = torch.einsum("qhgd,khd->hgqk", qg[a:b], k[:b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
        p = prec.act(torch.softmax(s, dim=-1))
        out[a:b] = torch.einsum("hgqk,khd->qhgd", p, v[:b])
    return out.reshape(T, H, dv)


def swiglu(prec, x, wg, wu, wd):
    return mm(prec, silu(mm(prec, x, wg)) * mm(prec, x, wu), wd)


def layer_views(params):
    """(layer params as a dict of views, FFN kind) for every layer: the
    stacked leaves of each segment, in order; a segment with a router is
    a MoE one."""
    for seg in params["segments"]:
        n = next(iter(seg.values())).shape[0]
        kind = "moe" if "wr" in seg else "dense"
        for j in range(n):
            yield {k: v[j] for k, v in seg.items()}, kind


def head(prec, params, h, eps):
    return mm(prec, rmsnorm(h, params["final_norm"], eps), params["lm_head"])


def softmax_scale(d):
    return 1.0 / math.sqrt(d)
