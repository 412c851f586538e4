"""The table of peaks and the operations and bytes of the model's steps and
kernels, from a configuration file's published keys and each step's host
batch (``record.StepRecord``). Nothing here reads the program.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
``bound`` is a copy of ``chip_smoke.py:358`` (``bound``): the least time
is the larger of bytes over bandwidth and operations over peak.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
FP8 = 1                          # bytes of one cached fp8 value
F32 = 4
BF16 = 2


def bound(bytes_moved: float, flops: float, rate: float = BF16_FLOPS
          ) -> float:
    """The least seconds the card could take."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / rate)


@dataclass(frozen=True)
class Shapes:
    """The widths a step's arithmetic needs, from a configuration file."""
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    mla: bool = False
    lora: int = 0            # kv_lora_rank
    rope: int = 0            # qk_rope_head_dim
    nope: int = 0            # qk_nope_head_dim
    v_dim: int = 0
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    shared_experts: int = 0
    dense_layers: int = 0    # leading dense-FFN layers of a MoE model

    @classmethod
    def of(cls, hf: dict) -> "Shapes":
        mla = bool(hf.get("kv_lora_rank"))
        H = hf["num_attention_heads"]
        return cls(
            layers=hf["num_hidden_layers"], d=hf["hidden_size"], heads=H,
            kv_heads=hf["num_key_value_heads"],
            head_dim=hf.get("head_dim") or hf["hidden_size"] // H,
            ff=hf["intermediate_size"], vocab=hf["vocab_size"], mla=mla,
            lora=hf.get("kv_lora_rank") or 0,
            rope=hf.get("qk_rope_head_dim") or 0,
            nope=hf.get("qk_nope_head_dim") or 0,
            v_dim=hf.get("v_head_dim") or 0,
            experts=hf.get("n_routed_experts") or 0,
            top_k=hf.get("num_experts_per_tok") or 0,
            expert_ff=hf.get("moe_intermediate_size") or 0,
            shared_experts=hf.get("n_shared_experts") or 0,
            dense_layers=hf.get("first_k_dense_replace") or 0)

    # --------------------------------------------------- the whole model --
    def weight_macs_per_token(self) -> int:
        """Multiply-adds of the projections one token passes through, over
        all layers (a MoE layer: the router, its top-k experts and the
        shared experts); the LM head apart."""
        d = self.d
        if self.mla:
            H = self.heads
            attn = (d * H * (self.nope + self.rope) + d * (self.lora + self.rope)
                    + self.lora * H * (self.nope + self.v_dim)
                    + H * self.v_dim * d)
        else:
            attn = (d * self.heads * self.head_dim
                    + 2 * d * self.kv_heads * self.head_dim
                    + self.heads * self.head_dim * d)
        dense_ffn = 3 * d * self.ff
        if not self.experts:
            return self.layers * (attn + dense_ffn)
        moe = (d * self.experts + 3 * d * self.expert_ff
               * (self.top_k + self.shared_experts))
        n_moe = self.layers - self.dense_layers
        return self.layers * attn + self.dense_layers * dense_ffn \
            + n_moe * moe

    def attn_flops_per_key(self) -> int:
        """Model FLOPs of one query token against one visible key, one
        layer (scores and values; MLA in its per-head form)."""
        if self.mla:
            return 2 * self.heads * (self.nope + self.rope + self.v_dim)
        return 4 * self.heads * self.head_dim

    # ------------------------------------------------ the attention kernels --
    def cached_token_bytes(self) -> int:
        """One token's entry in one layer of the FP8 pool with its f32
        scales: dense K and V per KV head; MLA one latent [c_kv | k_rope]."""
        if self.mla:
            return (self.lora + self.rope) * FP8 + 2 * F32
        return 2 * self.kv_heads * (self.head_dim * FP8 + F32)

    def query_row_bytes(self) -> int:
        """One query row in and one output row out of an attention kernel:
        bf16 q and out (dense); f32 absorbed q_lat, q_rope and o_lat (MLA)."""
        if self.mla:
            return self.heads * (2 * self.lora + self.rope) * F32
        return 2 * self.heads * self.head_dim * BF16

    def kernel_flops_per_key(self) -> int:
        """The attention kernels' FLOPs for one query row and one key, one
        layer: dense q.k and p.v over head_dim; MLA absorbed, scores over
        lora + rope and values over lora."""
        if self.mla:
            return 2 * self.heads * (2 * self.lora + self.rope)
        return 4 * self.heads * self.head_dim


def distinct_page_tokens(tables: np.ndarray, lens: np.ndarray,
                         page_size: int) -> int:
    """Tokens the lanes' live pages hold, each distinct page counted once
    (a prefix page shared by several lanes is read once): the least a
    paged attention kernel must read. ``tables`` (n, NP) page ids (-1
    none), ``lens`` (n,) the tokens each lane sees."""
    best = {}
    for row, n in zip(tables, lens):
        n = int(n)
        for j in range(-(-n // page_size)):
            p = int(row[j])
            if p < 0:
                continue
            best[p] = max(best.get(p, 0), min(page_size, n - j * page_size))
    return sum(best.values())


def attention_launch(shapes: Shapes, q_pos: list, tables: np.ndarray,
                     lens: np.ndarray, page_size: int) -> tuple:
    """(bytes, flops) of ONE layer's attention launch: query tokens at
    positions ``q_pos`` (each sees keys 0..pos), the lanes' page tables and
    visible lengths."""
    keys = sum(int(p) + 1 for p in q_pos)
    pages = distinct_page_tokens(tables, lens, page_size)
    nbytes = pages * shapes.cached_token_bytes() + \
        len(q_pos) * shapes.query_row_bytes()
    return nbytes, keys * shapes.kernel_flops_per_key()


def step_model_flops(shapes: Shapes, q_pos: list, sampled: int) -> int:
    """Useful model FLOPs of one step: the real query tokens through every
    projection, their attention over the visible keys, and the LM head for
    the ``sampled`` rows whose token is used."""
    keys = sum(int(p) + 1 for p in q_pos)
    return (2 * len(q_pos) * shapes.weight_macs_per_token()
            + shapes.layers * keys * shapes.attn_flops_per_key()
            + 2 * sampled * shapes.d * shapes.vocab)
