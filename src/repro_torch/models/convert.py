"""Carry a JAX parameter tree across to the port.

The JAX package's param tree, as numpy arrays (``{"embed", "segments":
[{stacked (L, ...) leaves}], "final_norm", "lm_head"}``; one segment for a
dense model, two for a MoE model with leading dense layers), becomes the
port's dict of tensors, in the same ``(d_in, d_out)`` layout. A bf16 leaf
arrives as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
rejects; it goes through float32, which is exact for bf16 -> f32 -> bf16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import check_device


def _leaf(arr, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    a = a.astype(np.float32) if a.dtype.name == "bfloat16" else np.array(a)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda") -> Dict[str, Any]:
    """JAX param tree (numpy leaves) -> the port's params on ``device``,
    each leaf in the dtype the port's ``param_shapes`` declares."""
    device = check_device(device)
    spec = get_model(cfg).param_shapes()

    def conv(key):
        shape, _, dtype = spec[key]
        t = _leaf(tree[key], dtype, device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {shape}")
        return t

    if len(tree["segments"]) != len(spec["segments"]):
        raise ValueError(f"{len(tree['segments'])} segments, the model has "
                         f"{len(spec['segments'])}")
    segs = []
    for seg_spec, seg in zip(spec["segments"], tree["segments"]):
        if set(seg) != set(seg_spec):
            raise ValueError(f"segment leaves {sorted(seg)} != "
                             f"{sorted(seg_spec)}")
        out = {}
        for k, (shape, _, dtype) in seg_spec.items():
            out[k] = _leaf(seg[k], dtype, device)
            if tuple(out[k].shape) != tuple(shape):
                raise ValueError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
        segs.append(out)
    return {"embed": conv("embed"), "segments": segs,
            "final_norm": conv("final_norm"), "lm_head": conv("lm_head")}
