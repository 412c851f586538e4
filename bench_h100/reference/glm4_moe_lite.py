"""Plain reference of the GLM-4.7-Flash decoder (``glm4_moe_lite``,
glm-4.7-flash): multi-head latent attention with a low-rank query (q =
W_qb RMSNorm(W_qa x)) in its per-head form (the latent expanded to keys
and values through ``w_uk`` / ``w_uv``; no absorption; values of
``v_head_dim`` beside query heads of ``qk_nope_head_dim`` +
``qk_rope_head_dim``), the leading dense SwiGLU layer, then MoE layers:
sigmoid router scores, the top ``num_experts_per_tok`` of the scores plus
a per-expert correction bias chosen (``topk_method`` noaux_tc, one group),
weighted by their unbiased scores renormalised (``norm_topk_prob``) and
times ``routed_scaling_factor``, and the always-on shared expert. Float32
throughout (or the control's FP8 operands), one layer at a time over one
whole sequence.

The port's stated semantics, which the configuration file lists under
``departures``: RoPE on halves and expert capacity per batch row (a token
that finds its expert full in its row is dropped from that expert).
``groups`` gives the rows: each prompt chunk the scheduler planned, as
(start, length, row width S), with capacity min(ceil(S * k / E * cf), S);
a token in no group (a decode token, alone first in its row) is never
dropped. The multi-token-prediction layer is not run."""
from __future__ import annotations

import math

import torch

from bench_h100.reference.common import (F32, causal_attention, head,
                                         layer_views, mm, rmsnorm, rope,
                                         softmax_scale, swiglu)


def route(prec, x, wr, bias, hf, groups):
    """(experts (T, k), weights (T, k), kept (T, k) bool)."""
    k, cf = hf["num_experts_per_tok"], hf["moe_capacity_factor"]
    scores = torch.sigmoid(mm(prec, x, wr))
    E = scores.shape[-1]
    top_e = torch.sort(scores + bias.float(), dim=-1, descending=True,
                       stable=True).indices[:, :k]
    top_w = torch.gather(scores, 1, top_e)
    if hf["norm_topk_prob"]:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    top_w = top_w * hf["routed_scaling_factor"]
    keep = torch.ones_like(top_e, dtype=torch.bool)
    for start, n, S in groups:
        cap = min(max(math.ceil(S * k / E * cf), 1), S)
        e = top_e[start:start + n]
        mask = torch.zeros((n, E), device=x.device)
        mask.scatter_(1, e, 1.0)
        queue = torch.cumsum(mask, dim=0) - 1           # place in the queue
        keep[start:start + n] = torch.gather(queue, 1, e) < cap
    return top_e, top_w, keep


def moe(prec, x, p, hf, groups):
    top_e, top_w, keep = route(prec, x, p["wr"], p["wr_bias"], hf, groups)
    out = swiglu(prec, x, p["wg_s"], p["wu_s"], p["wd_s"])
    for e in torch.unique(top_e[keep]).tolist():
        t, j = torch.nonzero((top_e == e) & keep, as_tuple=True)
        y = swiglu(prec, x[t], p["wg_e"][e], p["wu_e"][e], p["wd_e"][e])
        out.index_add_(0, t, y * top_w[t, j][:, None])
    return out


def logits(params, hf: dict, tokens: torch.Tensor, want: torch.Tensor,
           groups=(), prec=None):
    """Logits (len(want), vocab) at positions ``want`` of ``tokens`` (T,)."""
    prec = prec or F32()
    H = hf["num_attention_heads"]
    dn, dr = hf["qk_nope_head_dim"], hf["qk_rope_head_dim"]
    R, dv = hf["kv_lora_rank"], hf["v_head_dim"]
    eps, theta = hf["rms_norm_eps"], hf["rope_theta"]
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    h = params["embed"][tokens].float()
    for p, kind in layer_views(params):
        x = rmsnorm(h, p["ln1"], eps)
        cq = rmsnorm(mm(prec, x, p["wq_a"]), p["q_a_norm"], eps)
        q = mm(prec, cq, p["wq_b"]).reshape(T, H, dn + dr)
        ckv = mm(prec, x, p["w_dkv"])
        c = rmsnorm(ckv[:, :R], p["kv_norm"], eps)
        k_rope = rope(ckv[:, None, R:], pos, theta).expand(T, H, dr)
        k_nope = mm(prec, c, p["w_uk"]).reshape(T, H, dn)
        v = mm(prec, c, p["w_uv"]).reshape(T, H, dv)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], dim=-1)
        o = causal_attention(prec, q, torch.cat([k_nope, k_rope], dim=-1), v,
                             softmax_scale(dn + dr))
        h = h + mm(prec, o.reshape(T, H * dv), p["wo"])
        x = rmsnorm(h, p["ln2"], eps)
        if kind == "moe":
            h = h + moe(prec, x, p, hf, groups)
        else:
            h = h + swiglu(prec, x, p["wg"], p["wu"], p["wd"])
    return head(prec, params, h[want], eps)
