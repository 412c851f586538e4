"""Config registry: ``get_config(arch_id)`` for the architectures ported so far.

The port serves the dense family and the MLA family (deepseek-v2-lite); the
other arch files arrive with their families (see ROADMAP.md), and asking
for one raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import CacheConfig, ModelConfig, reduced

# arch-id -> module name
_ARCH_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    # the paper's own evaluation model
    "llama13b-gptq": "llama13b_gptq",
}

ALL_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id.endswith("-reduced"):
        return reduced(get_config(arch_id[: -len("-reduced")]))
    try:
        mod = importlib.import_module(
            f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    except KeyError:
        raise KeyError(f"arch {arch_id!r} is not ported yet; "
                       f"ported: {sorted(_ARCH_MODULES)}") from None
    return mod.CONFIG


__all__ = ["ALL_IDS", "CacheConfig", "ModelConfig", "get_config", "reduced"]
