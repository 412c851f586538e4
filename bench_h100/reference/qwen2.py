"""Plain reference of the Qwen2 decoder (qwen2.5-14b): RMSNorm, q/k/v with
bias, RoPE, grouped-query causal attention, SwiGLU, final norm, LM head.
Float32 throughout (or the control's FP8 operands), one layer at a time
over one whole sequence, the cache and positions worked out here.

Weights: the parameter dict the benchmark made (``weights.make_params``),
leaves ``(d_in, d_out)`` stacked per layer."""
from __future__ import annotations

import torch

from bench_h100.reference.common import (causal_attention, head, layer_views,
                                         mm, rmsnorm, rope, softmax_scale,
                                         swiglu)


def logits(params, hf: dict, tokens: torch.Tensor, want: torch.Tensor,
           groups=(), prec=None):
    """Logits (len(want), vocab) at positions ``want`` of the sequence
    ``tokens`` (T,). ``groups`` (the MoE routing rows) do not apply."""
    from bench_h100.reference.common import F32
    prec = prec or F32()
    d, H = hf["hidden_size"], hf["num_attention_heads"]
    Hkv = hf["num_key_value_heads"]
    D = hf.get("head_dim") or d // H
    eps, theta = hf["rms_norm_eps"], hf["rope_theta"]
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    h = params["embed"][tokens].float()
    for p, _ in layer_views(params):
        x = rmsnorm(h, p["ln1"], eps)
        q = mm(prec, x, p["wq"], p.get("bq")).reshape(T, H, D)
        k = mm(prec, x, p["wk"], p.get("bk")).reshape(T, Hkv, D)
        v = mm(prec, x, p["wv"], p.get("bv")).reshape(T, Hkv, D)
        o = causal_attention(prec, rope(q, pos, theta), rope(k, pos, theta),
                             v, softmax_scale(D))
        h = h + mm(prec, o.reshape(T, H * D), p["wo"])
        h = h + swiglu(prec, rmsnorm(h, p["ln2"], eps), p["wg"], p["wu"],
                       p["wd"])
    return head(prec, params, h[want], eps)
