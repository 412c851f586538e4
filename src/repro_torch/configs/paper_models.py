"""The paper's five evaluation models (§4.1): LLaMa(-2)-7B/13B and
LLaMa-Pro-8B, all GPTQ checkpoints in the paper; bf16 weights here
(DESIGN.md §8.4 — weight quantization is orthogonal to the contribution).

All are MHA (kv == q heads): Opt-GQA's restructuring is exactly the paper's
Fig. 4 scenario. ``bench_reduced`` scales each model by the same factor so
Figs. 6-7's model-size trend survives the reduction (CPU benchmarks).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

LLAMA_7B = ModelConfig(
    name="llama7b-gptq", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
    vocab_size=32000, source="arXiv:2302.13971")

LLAMA2_7B = LLAMA_7B.replace(name="llama2-7b-gptq",
                             source="arXiv:2307.09288")

LLAMA_13B = ModelConfig(
    name="llama13b-gptq", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=40, head_dim=128, d_ff=13824,
    vocab_size=32000, source="arXiv:2302.13971")

LLAMA2_13B = LLAMA_13B.replace(name="llama2-13b-gptq",
                               source="arXiv:2307.09288")

LLAMA_PRO_8B = ModelConfig(  # block-expanded llama2-7b (+8 layers)
    name="llama-pro-8b-gptq", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
    vocab_size=32000, source="arXiv:2401.02415")

PAPER_MODELS = {m.name: m for m in
                (LLAMA_7B, LLAMA2_7B, LLAMA_13B, LLAMA2_13B, LLAMA_PRO_8B)}


def bench_reduced(cfg: ModelConfig, *, layer_div: int = 8,
                  width_div: int = 16, vocab: int = 2048) -> ModelConfig:
    """Proportionally scaled variant: relative model-size differences (the
    x-axis of Figs. 6-7) are preserved."""
    d = cfg.d_model // width_div
    heads = max(d // 64, 1)
    return cfg.replace(
        name=cfg.name + "-bench",
        num_layers=max(cfg.num_layers // layer_div, 2),
        d_model=d, num_heads=heads, num_kv_heads=heads, head_dim=64,
        d_ff=cfg.d_ff // width_div, vocab_size=vocab)
