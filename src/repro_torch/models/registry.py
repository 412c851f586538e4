"""Model registry: family -> implementation.

Every model exposes the engine-facing protocol of the JAX package:
  param_shapes() / init(seed, device)          — parameter dict (stacked layers)
  prefill(params, batch, cache, coopt)         — last-token logits + filled cache
  decode_step(params, batch, cache, coopt, long_window) — one-token step
  cache_shape(batch, max_len, coopt, num_shards=1, cache_cfg=None) /
  init_cache(..., device)                      — num_shards pads the paged
      pool's pages axis so it splits evenly into page-range shards
  forward(params, batch, coopt) / input_specs(shape) — teacher-forced
      logits and aux terms for training (``repro_torch.training``)
The ``dense``, ``moe``, ``mla`` and ``vlm`` families are ported
(``TransformerModel``), and so are ``griffin`` (``GriffinModel``) and
``rwkv6`` (``RWKV6Model``), whose ``recurrent_leaves`` name the cache leaves
that carry per-lane recurrent state, and ``whisper`` (``WhisperModel``),
whose ``cross_leaves`` hold the cross-attention K/V a request's first chunk
fills; any other family raises ``NotImplementedError``.
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.configs.base import ModelConfig


@lru_cache(maxsize=64)
def get_model(cfg: ModelConfig):
    if cfg.family == "griffin":
        from repro_torch.models.griffin import GriffinModel
        return GriffinModel(cfg)
    if cfg.family == "rwkv6":
        from repro_torch.models.rwkv6 import RWKV6Model
        return RWKV6Model(cfg)
    if cfg.family == "whisper":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(cfg)
    from repro_torch.models.transformer import TransformerModel
    return TransformerModel(cfg)
