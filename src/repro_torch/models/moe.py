"""Mixture-of-Experts FFN (deepseek-v2) — gather-based dispatch, the port of
the JAX package's ``models/moe.py``.

Routing is computed per batch row (capacity C = ceil(S * top_k / E * cf),
clipped to S, ``capacity``): each token's top-k experts by softmax
probability (ties to the lower expert index, as ``jax.lax.top_k``),
renormalised. The port's sigmoid mode (glm-4.7-flash, DeepSeek-V3's
``noaux_tc``) scores sigmoid(logits) instead, picks the top-k of scores +
a per-expert correction bias, and weighs the picked experts by their
unbiased scores, renormalised and times ``scaling``. Tokens queue
per expert in sequence order, and those beyond capacity are dropped. The
dispatched tokens run through the expert SwiGLU as batched matmuls
((B, E, C, d) x (E, d, ff)) and are scattered back with their router
weights; always-on shared experts are added on top. The JAX package leaves
these products to XLA outside any Pallas kernel; here they are plain
PyTorch matmuls. Training asks for the Switch-style auxiliary terms
(``MoEAux``: load balance, router z-loss, dropped fraction,
``with_aux=True``); a serving step computes none of them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import linear, silu, swiglu


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def capacity(S: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has in a batch row of S tokens."""
    return min(max(int(math.ceil(S * top_k / num_experts * capacity_factor)),
                   1), S)


def _route(logits: torch.Tensor, top_k: int, capacity: int,
           with_aux: bool = False, score: str = "softmax", bias=None,
           scaling: float = 1.0):
    """logits (B,S,E) -> (idx (B,E,C) token positions, S = empty slot;
    comb (B,E,C) f32 router weights of the token in each slot), and with
    ``with_aux`` the ``MoEAux`` terms as a third element. ``score``
    "sigmoid": the top-k of sigmoid(logits) + ``bias`` (E,) f32 picks the
    experts, their unbiased scores renormalised times ``scaling`` weigh
    them."""
    B, S, E = logits.shape
    dev = logits.device
    if score == "softmax":
        probs = torch.softmax(logits.float(), dim=-1)
        # a stable descending sort keeps equal probabilities in index order
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]  # (B,S,K)
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    elif score == "sigmoid":
        probs = torch.sigmoid(logits.float())
        pick = probs if bias is None else probs + bias.float()
        top_e = torch.sort(pick, dim=-1, descending=True,
                           stable=True).indices[..., :top_k]
        top_p = torch.gather(probs, -1, top_e)
        top_p = top_p / top_p.sum(dim=-1, keepdim=True) * scaling
    else:
        raise ValueError(f"unknown router score {score!r}")

    onehot = torch.nn.functional.one_hot(top_e, E).float()     # (B,S,K,E)
    mask = onehot.sum(dim=2)                                   # (B,S,E) 0/1
    # position of each token in its expert's queue (within the batch row)
    pos = torch.cumsum(mask, dim=1) - 1.0
    keep = (pos < capacity) & (mask > 0)
    pos = pos.long()

    tok = torch.arange(S, device=dev)[None, :, None].expand(B, S, E)
    flat_slot = torch.where(
        keep, torch.arange(E, device=dev)[None, None, :] * capacity + pos,
        E * capacity)                                          # spare slot
    idx = torch.full((B, E * capacity + 1), S, dtype=torch.long, device=dev)
    idx.scatter_(1, flat_slot.reshape(B, -1), tok.reshape(B, -1))
    idx = idx[:, :-1].reshape(B, E, capacity)

    w_tok_e = (top_p[..., None] * onehot).sum(dim=2)           # (B,S,E)
    w_tok_e = torch.where(keep, w_tok_e, 0.0)
    w_pad = torch.cat([w_tok_e, torch.zeros((B, 1, E), device=dev)], dim=1)
    comb = w_pad[torch.arange(B, device=dev)[:, None, None], idx,
                 torch.arange(E, device=dev)[None, :, None]]   # (B,E,C)
    if not with_aux:
        return idx, comb
    # Switch-style auxiliary terms
    frac_tokens = mask.mean(dim=1)                             # (B,E)
    frac_probs = probs.mean(dim=1)                             # (B,E)
    lb = E * (frac_tokens * frac_probs).sum(dim=-1).mean()
    z = torch.square(torch.logsumexp(logits.float(), dim=-1)).mean()
    dropped = 1.0 - keep.sum() / torch.clamp_min(mask.sum(), 1.0)
    return idx, comb, MoEAux(lb, z, dropped)


def moe_ffn(x, wr, wg, wu, wd, *, top_k: int, capacity_factor: float = 1.25,
            shared: Optional[tuple] = None, with_aux: bool = False,
            score: str = "softmax", bias=None, scaling: float = 1.0):
    """x (B,S,d); wr (d,E); wg/wu (E,d,ff); wd (E,ff,d); shared: optional
    (wg_s, wu_s, wd_s) always-on shared-expert SwiGLU; ``score``, ``bias``
    (E,) and ``scaling`` as ``_route``. Returns (B,S,d) in x's dtype, and
    with ``with_aux`` (out, ``MoEAux``)."""
    B, S, d = x.shape
    E = wr.shape[-1]
    cap = capacity(S, top_k, E, capacity_factor)
    # the sigmoid router's logits in f32, as the published code computes
    # them (the scores' spread is narrow, so bf16 logits flip the choice);
    # passed without a name, so they are freed before the experts run
    routed = _route(
        x.float() @ wr.float() if score == "sigmoid" else linear(x, wr),
        top_k, cap, with_aux=with_aux, score=score, bias=bias,
        scaling=scaling)
    idx, comb = routed[:2]
    x_pad = torch.cat([x, torch.zeros((B, 1, d), dtype=x.dtype,
                                      device=x.device)], dim=1)
    rows = torch.arange(B, device=x.device)[:, None, None]
    xin = x_pad[rows, idx]                                     # (B,E,C,d)
    h = silu(torch.einsum("becd,edf->becf", xin, wg)) * \
        torch.einsum("becd,edf->becf", xin, wu)
    y = torch.einsum("becf,efd->becd", h, wd)                  # (B,E,C,d)
    y = y * comb[..., None].to(y.dtype)

    # combine: scatter-add expert outputs back to their token positions
    out = torch.zeros((B, S + 1, d), dtype=y.dtype, device=x.device)
    out.index_put_((torch.arange(B, device=x.device)[:, None],
                    idx.reshape(B, -1)), y.reshape(B, -1, d), accumulate=True)
    out = out[:, :S]
    if shared is not None:
        out = out + swiglu(x, *shared)
    return (out.to(x.dtype), routed[2]) if with_aux else out.to(x.dtype)
