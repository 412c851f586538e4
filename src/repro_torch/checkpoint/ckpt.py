"""Checkpoints: a tree of tensors -> a directory of ``.npy`` leaves and a
manifest. The port of the JAX package's ``checkpoint/ckpt.py``, writing the
same layout, so each package loads the other's checkpoints.

Leaves are written in the JAX flatten order (``repro_torch.tree``: dict keys
sorted, lists by index, a NamedTuple's fields in order), each as
``{i:04d}__{path}.npy`` with its path's keys joined by ``__``; a bf16 leaf
is stored as its ``uint16`` bits and an fp8 leaf as its ``uint8`` bits.
``manifest.json`` records the step and each leaf's dtype and shape. Only
numpy and torch are used.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_util

_MANIFEST = "manifest.json"
# torch dtypes stored as their bits, by the manifest's dtype name
_BITS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
         torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
         torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_BY_NAME = {name: (dt, view) for dt, (name, view, _) in _BITS.items()}


def _leaf_key(path) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def host_array(leaf) -> tuple:
    """(numpy array to write, manifest dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _BITS:
        name, view, np_dt = _BITS[t.dtype]
        return t.view(view).numpy().view(np_dt), name
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for i, (kpath, leaf) in enumerate(tree_util.leaves_with_path(tree)):
        key = f"{i:04d}__{_leaf_key(kpath)}"
        arr, name = host_array(leaf)
        np.save(os.path.join(path, key + ".npy"), arr, allow_pickle=False)
        manifest["leaves"][key] = {"dtype": name, "shape": list(arr.shape)}
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str, like: Any) -> Any:
    """Rebuild a tree with the structure of ``like`` from ``path``, each
    leaf in its stored dtype, on the device of ``like``'s leaf (the CPU
    where that is not a tensor)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    keys = sorted(manifest["leaves"])
    ref = tree_util.leaves(like)
    if len(keys) != len(ref):
        raise ValueError(f"checkpoint has {len(keys)} leaves, expected "
                         f"{len(ref)}")
    out = []
    for key, r in zip(keys, ref):
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, key + ".npy"))
        if meta["dtype"] in _BY_NAME:
            dt, view = _BY_NAME[meta["dtype"]]
            t = torch.from_numpy(arr.view(np.int16 if view == torch.int16
                                          else np.uint8)).view(dt)
        else:
            t = torch.as_tensor(arr)
        out.append(t.to(r.device if isinstance(r, torch.Tensor) else "cpu"))
    return tree_util.unflatten(like, out)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)["step"]
