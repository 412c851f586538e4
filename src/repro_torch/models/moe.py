"""Mixture-of-Experts FFN (deepseek-v2) — gather-based dispatch, the port of
the JAX package's ``models/moe.py``.

Routing is computed per batch row (capacity C = ceil(S * top_k / E * cf),
clipped to S): each token's top-k experts by softmax probability (ties to
the lower expert index, as ``jax.lax.top_k``), renormalised; tokens queue
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


def _route(logits: torch.Tensor, top_k: int, capacity: int,
           with_aux: bool = False):
    """logits (B,S,E) -> (idx (B,E,C) token positions, S = empty slot;
    comb (B,E,C) f32 router weights of the token in each slot), and with
    ``with_aux`` the ``MoEAux`` terms as a third element."""
    B, S, E = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]      # (B,S,K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

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
            shared: Optional[tuple] = None, with_aux: bool = False):
    """x (B,S,d); wr (d,E); wg/wu (E,d,ff); wd (E,ff,d); shared: optional
    (wg_s, wu_s, wd_s) always-on shared-expert SwiGLU. Returns (B,S,d) in
    x's dtype, and with ``with_aux`` (out, ``MoEAux``)."""
    B, S, d = x.shape
    E = wr.shape[-1]
    capacity = max(int(math.ceil(S * top_k / E * capacity_factor)), 1)
    capacity = min(capacity, S)

    if with_aux:
        idx, comb, aux = _route(linear(x, wr), top_k, capacity, with_aux=True)
    else:
        idx, comb = _route(linear(x, wr), top_k, capacity)
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
    return (out.to(x.dtype), aux) if with_aux else out.to(x.dtype)
