"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,              # per-expert hidden dim
    moe_d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    top_k=2,
    attn_window=4096,        # SWA per assignment -> long_500k eligible
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)
