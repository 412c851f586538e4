"""recurrentgemma-9b — RG-LRU + local attention hybrid, pattern 1 attn : 2 rec
[arXiv:2402.19427].

Opt-KV/Opt-Pa apply to the local-attention layers' (windowed) paged KV
cache; the RG-LRU layers carry O(1) recurrent state (conv taps in bf16, the
recurrence in f32). kv=1 -> MQA; head_dim 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="griffin",
    num_layers=38,           # 12 x (rec, rec, attn) + (rec, rec)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=4096,
    conv1d_width=4,
    source="arXiv:2402.19427",
)
