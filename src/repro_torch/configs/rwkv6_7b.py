"""rwkv6-7b — "Finch", attention-free, data-dependent decay [arXiv:2404.05892].

LLM-CoOpt's Opt-KV/Opt-GQA/Opt-Pa do not apply (no KV cache, no heads to
group, no pages): the model runs without them. Its decode state is O(1):
per layer an (H, D, D) wkv state and two token-shift buffers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # wkv heads, head_dim 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    source="arXiv:2404.05892",
)
