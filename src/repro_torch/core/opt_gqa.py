"""Opt-GQA — grouped-query attention restructuring (paper §3.2, Alg. 2).

Eq. 7: Group_q(i) = floor(i / H_g), H_g = H_q / H_k — query head i reads KV
head i // H_g. With Opt-GQA enabled, attention is computed with queries folded
to (H_k, H_g) so each KV head is loaded once per group. With it disabled
(plain MHA semantics), K/V are physically expanded to H_q heads first.

For the paper's MHA checkpoints (LLaMa-13B, H_k == H_q), ``mha_to_gqa``
restructures the K/V projection weights into H_k' < H_q shared heads by
mean-pooling each group.
"""
from __future__ import annotations

import torch


def group_index(i, num_q_heads: int, num_kv_heads: int):
    """Eq. 7 mapping: query head i -> KV group index."""
    return i // (num_q_heads // num_kv_heads)


def fold_queries(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """(..., Hq, D) -> (..., Hkv, G, D) per Eq. 7 (heads of one group adjacent)."""
    *lead, Hq, D = q.shape
    return q.reshape(*lead, num_kv_heads, Hq // num_kv_heads, D)


def unfold_outputs(o: torch.Tensor) -> torch.Tensor:
    """(..., Hkv, G, D) -> (..., Hq, D) — Alg. 2 Phase 3 concatenation."""
    *lead, Hkv, G, D = o.shape
    return o.reshape(*lead, Hkv * G, D)


def mha_to_gqa(wk: torch.Tensor, wv: torch.Tensor, num_kv_heads: int,
               head_dim: int):
    """Mean-pool MHA K/V projections into ``num_kv_heads`` shared heads.

    wk/wv: (d_model, Hq*D) -> (d_model, num_kv_heads*D).
    """
    d_model, hd = wk.shape
    G = hd // head_dim // num_kv_heads

    def pool(w):
        w4 = w.reshape(d_model, num_kv_heads, G, head_dim)
        return w4.float().mean(dim=2).to(w.dtype) \
                 .reshape(d_model, num_kv_heads * head_dim)

    return pool(wk), pool(wv)
