"""whisper-small — encoder-decoder, conv/mel frontend a stub [arXiv:2212.04356].

The model takes precomputed frame embeddings (B, num_frames, d_model); the
conv feature extractor and mel spectrogram are not implemented, as in the
JAX package. The decoder is full attention (no window).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="whisper",
    num_layers=12,           # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,         # kv=12 -> GQA group size 1 (identity grouping)
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    num_frames=1500,         # 30 s audio after conv stride-2
    source="arXiv:2212.04356",
)
