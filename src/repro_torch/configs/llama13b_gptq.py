"""LLaMa-13B — the paper's own primary evaluation model (LLaMa-13B-GPTQ).

GPTQ int4 weight quantization is a property of the paper's checkpoints, not of
its contribution (DESIGN.md §8.4); we serve bf16 weights. MHA (kv == q heads):
Opt-GQA restructures this into grouped-query attention, which is exactly the
paper's Fig. 4 scenario.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama13b-gptq",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,        # MHA; Opt-GQA regroups to fewer KV heads
    head_dim=128,
    d_ff=13824,
    vocab_size=32000,
    source="arXiv:2302.13971",
)
