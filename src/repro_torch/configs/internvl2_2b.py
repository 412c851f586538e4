"""internvl2-2b — InternViT (STUB) + InternLM2 language backbone [arXiv:2404.16821].

A step's ``batch["patches"]`` carries precomputed patch embeddings (B,
num_patches, d_model); the ViT/projector are not implemented. The LM backbone is
a llama-style GQA decoder and gets the full LLM-CoOpt treatment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    num_patches=1024,
    source="arXiv:2404.16821",
)
