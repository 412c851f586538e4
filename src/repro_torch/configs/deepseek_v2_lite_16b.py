"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE 2 shared + 64 routed top-6
[arXiv:2405.04434].

Opt-KV applies to the latent cache: each token caches ``[c_kv | k_rope]``
(R + dr values) once for all heads, stored as FP8 with two scales per token
and paged. Opt-GQA has nothing left to fold: every head already reads the
one shared latent.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="mla",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,         # MLA: all heads read the shared latent
    head_dim=128,            # = qk_nope_head_dim
    d_ff=10944,              # dense FFN (first layer)
    moe_d_ff=1408,           # per routed expert
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    kv_lora_rank=512,
    q_lora_rank=0,           # v2-lite has no q compression
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    source="arXiv:2405.04434",
)
