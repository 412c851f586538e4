"""Token sampler: greedy / temperature / top-k / top-p, on the logits' device.

Random draws come from an explicit ``torch.Generator``; the JAX package's
PRNG gives other numbers from the same seed, so sampled tokens of the two
packages differ while greedy tokens and the top-k/top-p masks agree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => no top-k filter
    top_p: float = 1.0                # 1 => no nucleus filter

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def top_k_mask(lf: torch.Tensor, top_k: int) -> torch.Tensor:
    """Top-k keep-mask (B, V): EXACTLY the ``top_k`` highest-ranked tokens,
    ties broken by sorted rank (a stable descending sort)."""
    order = torch.argsort(-lf, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return rank < top_k


def top_p_mask(lf: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus keep-mask (B, V): the SMALLEST set of tokens whose probability
    mass reaches ``top_p``, ties broken by sorted rank."""
    order = torch.argsort(-lf, dim=-1, stable=True)
    sorted_lf = torch.gather(lf, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_lf, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    keep_sorted = torch.arange(lf.shape[-1], device=lf.device)[None, :] \
        <= cutoff_idx
    rank = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(keep_sorted, -1, rank)


def sample(logits: torch.Tensor, gen: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits (..., V) -> tokens (...) int32: (B, V) per lane, or a packed
    step's (R, G, V) per row and logits slot."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lf = logits.float().reshape(-1, logits.shape[-1]) / temperature
    if top_k:
        lf = torch.where(top_k_mask(lf, top_k), lf, float("-inf"))
    if top_p < 1.0:
        lf = torch.where(top_p_mask(lf, top_p), lf, float("-inf"))
    probs = torch.softmax(lf, dim=-1)
    toks = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return toks.to(torch.int32).reshape(logits.shape[:-1])
