"""Meshes of the port: named axes with extents, on one card.

A ``Mesh`` names the axes of a device layout and their extents, and the one
``torch.device`` it runs on. The port's engine is one controller on one
card, so a mesh's only effect is the KV pool's page-range shards: the
product of its ``(pod, data)`` extents (``kv_shard_count``,
``core.opt_kv.PAGES_AXES``). ``Engine(mesh=...)`` takes its shard count
from it and reads each shard's page range with the unchanged kernels
(``kernels.sharded``); the ``model`` axis names an extent that nothing on
one card splits.

``make_sim_mesh`` is the counterpart of the JAX package's simulated CPU
mesh, the one its own tests shard the pool on. The JAX package's
``make_production_mesh`` and its TPU v5e constants describe TPU hardware and
have no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.opt_kv import PAGES_AXES


@dataclass(frozen=True)
class Mesh:
    """Axis names and extents of a device layout, and the card it runs on
    (None: the device of the engine it is handed to)."""
    axis_names: Tuple[str, ...]
    extents: Tuple[int, ...]
    device: Optional[torch.device] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.extents) or \
                any(int(e) < 1 for e in self.extents):
            raise ValueError(f"a mesh needs one extent >= 1 per axis, got "
                             f"{self.axis_names} {self.extents}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, in axis order."""
        return dict(zip(self.axis_names, self.extents))


def _device(device) -> Optional[torch.device]:
    return None if device is None else torch.device(device)


def make_host_mesh(device=None) -> Mesh:
    """The degenerate mesh (data 1, model 1): no page-range shards."""
    return Mesh(("data", "model"), (1, 1), _device(device))


def make_sim_mesh(data: int = 4, model: int = 2, pod: int = 1,
                  device=None) -> Mesh:
    """A small mesh whose ``pod * data`` page-range shards all live on one
    card (the JAX package's simulated-device mesh, with its axes)."""
    if pod > 1:
        return Mesh(("pod", "data", "model"), (pod, data, model),
                    _device(device))
    return Mesh(("data", "model"), (data, model), _device(device))


def kv_shard_count(mesh) -> int:
    """The KV pool's page-range shards a mesh implies: the product of its
    ``PAGES_AXES`` extents. ``Engine`` derives ``CacheConfig.num_shards``
    from it (and refuses a config that disagrees)."""
    return math.prod(mesh.shape[a] for a in PAGES_AXES if a in mesh.shape)
