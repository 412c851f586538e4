"""Config registry: ``get_config(arch_id)`` for the architectures ported so far,
and the assigned input shapes.

The port serves every architecture of the JAX package: the dense family
(qwen3-4b, qwen2.5-14b, yi-34b, deepseek-67b, the paper's llama13b-gptq),
the MLA family (deepseek-v2-lite), the MoE family (mixtral-8x22b), the vlm
family (internvl2-2b), the recurrent families griffin (recurrentgemma-9b)
and rwkv6 (rwkv6-7b), and the encoder-decoder whisper (whisper-small).
An unknown id raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import CacheConfig, ModelConfig, reduced
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape

# arch-id -> module name
_ARCH_MODULES = {
    "yi-34b": "yi_34b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-small": "whisper_small",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-2b": "internvl2_2b",
    "qwen3-4b": "qwen3_4b",
    "qwen2.5-14b": "qwen2_5_14b",
    "deepseek-67b": "deepseek_67b",
    # the paper's own evaluation model
    "llama13b-gptq": "llama13b_gptq",
}

# the assigned architectures (the paper's model apart)
ARCH_IDS = [k for k in _ARCH_MODULES if k != "llama13b-gptq"]
ALL_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id.endswith("-reduced"):
        return reduced(get_config(arch_id[: -len("-reduced")]))
    try:
        mod = importlib.import_module(
            f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; "
                       f"known: {sorted(_ARCH_MODULES)}") from None
    return mod.CONFIG


__all__ = ["ALL_IDS", "ARCH_IDS", "CacheConfig", "InputShape", "ModelConfig",
           "SHAPES", "get_config", "get_shape", "reduced"]
