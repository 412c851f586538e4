"""AdamW in plain PyTorch, the port of the JAX package's
``training/optimizer.py``.

Moments are f32 whatever the parameter's dtype; the update is computed in
f32 and cast back to the parameter's dtype, in the reference's order of
operations: global-norm clipping on f32 sums of squares, bias correction
with the step as f32, weight decay inside the update direction.
``torch.optim.AdamW`` is not used: its moments take the parameter's dtype
(bf16 here) and its operations run in another order.

The update runs leaf by leaf, and a large leaf in slices of its flat
elements (every operation is elementwise, so the values are the slices'
whole-leaf values): no f32 copy of all gradients, nor of one stacked leaf,
is ever held. Parameters and moments are updated in place; the call
returns the same tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_util

# elements a slice of one leaf's update (64 Mi: a few 256 MiB f32 temps)
_SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # f32 tree like params
    nu: Any                  # f32 tree like params


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_util.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_util.tree_map(zeros, params),
                      nu=tree_util.tree_map(zeros, params))


def _slices(n: int):
    for i in range(0, n, _SLICE):
        yield slice(i, min(i + _SLICE, n))


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's f32 sum
    of squares: the reference's clipping norm."""
    total = None
    for g in tree_util.leaves(grads):
        flat = g.reshape(-1)
        ss = None
        for sl in _slices(flat.numel()):
            part = torch.sum(torch.square(flat[sl].float()))
            ss = part if ss is None else ss + part
        total = ss if total is None else total + ss
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (params, state, grad_norm): the parameters and moments
    updated in place, ``state.step`` a new tensor."""
    gnorm = _global_norm(grads)
    scale = None
    if grad_clip:
        scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-12),
                                1.0)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

    flat_p = tree_util.leaves(params)
    flat_g = tree_util.leaves(grads)
    flat_m = tree_util.leaves(state.mu)
    flat_v = tree_util.leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in structure")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adamw_update updates contiguous leaves in "
                             "place")
        pf_all, gf_all = p.reshape(-1), g.reshape(-1)
        mf_all, vf_all = m.reshape(-1), v.reshape(-1)
        for sl in _slices(pf_all.numel()):
            gs = gf_all[sl].float()
            if scale is not None:
                gs = gs * scale
            ms, vs = mf_all[sl], vf_all[sl]
            ms.copy_(b1 * ms + (1.0 - b1) * gs)
            vs.copy_(b2 * vs + (1.0 - b2) * torch.square(gs))
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
            ps = pf_all[sl]
            if weight_decay:
                delta = delta + weight_decay * ps.float()
            ps.copy_((ps.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), gnorm
