"""Config registry: ``get_config(arch_id)`` for the architectures ported so far,
and the assigned input shapes.

The port serves every architecture of the JAX package: the dense family
(qwen3-4b, qwen2.5-14b, yi-34b, deepseek-67b, the paper's llama13b-gptq),
the MLA family (deepseek-v2-lite), the MoE family (mixtral-8x22b), the vlm
family (internvl2-2b), the recurrent families griffin (recurrentgemma-9b)
and rwkv6 (rwkv6-7b), and the encoder-decoder whisper (whisper-small).
Beside them, ``PORT_IDS`` are architectures the port serves that the JAX
package has none of (glm-4.7-flash); ``get_config`` finds them too, and
``ARCH_IDS`` / ``ALL_IDS`` stay the JAX package's lists. An unknown id
raises ``KeyError``.
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

# the port's own architectures (none in the JAX package)
_PORT_MODULES = {
    "glm-4.7-flash": "glm_4_7_flash",
}

# the assigned architectures (the paper's model apart)
ARCH_IDS = [k for k in _ARCH_MODULES if k != "llama13b-gptq"]
ALL_IDS = list(_ARCH_MODULES)
PORT_IDS = list(_PORT_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id.endswith("-reduced"):
        return reduced(get_config(arch_id[: -len("-reduced")]))
    module = _ARCH_MODULES.get(arch_id) or _PORT_MODULES.get(arch_id)
    if module is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES) + PORT_IDS}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


__all__ = ["ALL_IDS", "ARCH_IDS", "CacheConfig", "InputShape", "ModelConfig",
           "PORT_IDS", "SHAPES", "get_config", "get_shape", "reduced"]
