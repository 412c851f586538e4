"""Carry a JAX parameter tree across to the port.

The JAX package's param tree, as numpy arrays, becomes the port's dict of
tensors, in the same ``(d_in, d_out)`` layout and the same nesting: a
transformer's ``{"embed", "segments": [{stacked (L, ...) leaves}],
"final_norm", "lm_head"}`` (one segment for a dense model, two for a MoE
model with leading dense layers), griffin's ``{"embed", "rec": {...},
"attn": {...}, ...}``, rwkv6's ``{"embed", "layers": {...}, ...}`` and
whisper's ``{"embed", "pos_dec", "enc": {...}, "dec": {...}, ...}``. Each
leaf is checked against the port's ``param_shapes``. A bf16 leaf arrives
as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects; it
goes through float32, which is exact for bf16 -> f32 -> bf16.
``params_to_numpy`` is the way back: the port's params as numpy arrays, a
bf16 leaf as float32 (exact), which the JAX side casts to its leaf dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint.ckpt import host_array
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

    def conv(spec, node, path):
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise ValueError(f"{path}: {len(node)} segments, the model "
                                 f"has {len(spec)}")
            return [conv(s, n, f"{path}[{i}]")
                    for i, (s, n) in enumerate(zip(spec, node))]
        if isinstance(spec, dict):
            if set(node) != set(spec):
                raise ValueError(f"{path or 'params'}: leaves {sorted(node)} "
                                 f"!= {sorted(spec)}")
            return {k: conv(s, node[k], f"{path}/{k}" if path else k)
                    for k, s in spec.items()}
        shape, _, dtype = spec
        t = _leaf(node, dtype, device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {shape}")
        return t

    return conv(get_model(cfg).param_shapes(), tree, "")


def _is_spec(node) -> bool:
    """A ``param_shapes`` leaf: (shape, init, dtype)."""
    return isinstance(node, tuple) and len(node) == 3 \
        and isinstance(node[0], tuple)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf on the host as the checkpoint writes it, a bf16 leaf's bits
    widened to float32 (exact)."""
    arr, dtype = host_array(t)
    if dtype == "bfloat16":
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def params_to_numpy(cfg: ModelConfig,
                    params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> the same tree of numpy arrays on the host (a
    bf16 leaf as float32), each leaf checked against ``param_shapes``."""
    want = tree_util.leaves_with_path(get_model(cfg).param_shapes(),
                                      is_leaf=_is_spec)
    got = tree_util.leaves_with_path(params)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError(f"leaves {[p for p, _ in got]} != "
                         f"{[p for p, _ in want]}")
    for (path, t), (_, (shape, _, _)) in zip(got, want):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{tuple(t.shape)} != {shape}")
    return tree_util.tree_map(_numpy, params)
