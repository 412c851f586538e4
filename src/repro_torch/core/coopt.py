"""LLM-CoOpt runtime configuration — which of the paper's three techniques are
active. ``ORIGINAL`` reproduces the unmodified-vLLM baseline; ``COOPT`` is the
full framework (Opt-KV + Opt-GQA + Opt-Pa). Intermediate combinations give the
paper's per-technique ablations (Figs. 6-7).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.cache.quant import FP8_DTYPE


@dataclass(frozen=True)
class CoOptConfig:
    opt_kv: bool = False      # FP8 cache + SkipSet-aware writes (Alg. 1)
    opt_gqa: bool = False     # grouped computation (Alg. 2); else KV expanded per q-head
    opt_pa: bool = False      # valid-block filtering + block-wise softmax (Alg. 3)
    page_size: int = 64       # tokens per KV page (vLLM block)
    page_group: int = 8       # pages per online-softmax step of the reference
    use_kernel: bool = False  # hand-written CUDA kernels (on CUDA tensors)
                              # vs the plain PyTorch reference path
    # Cross-lane shared-prefix page batching (kernels.visits): the decode
    # kernel iterates a deduplicated (page, lane-set) visit list, so a
    # prefix page shared by N lanes is read once instead of N times. Used
    # for 1 < B <= visits.MAX_VISIT_LANES; bit-identical to the per-lane
    # kernel. Kernel path only; the reference gathers per lane regardless.
    share_visits: bool = True
    moe_capacity_factor: float = 1.25

    @property
    def kv_dtype(self):
        return FP8_DTYPE if self.opt_kv else torch.bfloat16

    def replace(self, **kw) -> "CoOptConfig":
        return dataclasses.replace(self, **kw)


ORIGINAL = CoOptConfig()
OPT_KV = CoOptConfig(opt_kv=True)
OPT_GQA = CoOptConfig(opt_gqa=True)
OPT_PA = CoOptConfig(opt_pa=True)
COOPT = CoOptConfig(opt_kv=True, opt_gqa=True, opt_pa=True)

MODES = {
    "original": ORIGINAL,
    "opt-kv": OPT_KV,
    "opt-gqa": OPT_GQA,
    "opt-pa": OPT_PA,
    "coopt": COOPT,
}
