"""Meshes of the port: named axes with extents, and the device of each
page-range shard.

A ``Mesh`` names the axes of a device layout and their extents, and lists
one ``torch.device`` for each position along its pages axes (the product
of its ``(pod, data)`` extents, ``kv_shard_count``;
``core.opt_kv.PAGES_AXES``), in shard order. ``Engine(mesh=...)`` takes
its shard count from it and, on the kernel path, puts each page range of
the KV pool in a pool of its own on that shard's device
(``core.opt_kv.ShardedPool``): writes are shard-local, each read kernel runs
on its shard's device, and the partials are merged on the controller, the
engine's own device, which holds the weights and every batch-major leaf
(``kernels.sharded``). The ``model`` axis names an extent that nothing
splits.

``make_sim_mesh`` is the counterpart of the JAX package's simulated mesh:
without ``devices`` every shard is a separate pool on the engine's one
device; given a list, shard s goes on ``devices[s]`` as
``jax.make_mesh(..., devices=)`` places it. The JAX package's
``make_production_mesh`` and its TPU v5e constants describe TPU hardware and
have no counterpart here; the card's own constants below (an H100 SXM's
published dense bf16 rate and HBM rate, and the device memory a step may
fill) set ``launch.inspect_cell``'s roofline terms and the dry run's fit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.opt_kv import PAGES_AXES

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, H100 SXM dense bf16 tensor cores
HBM_BW = 3.35e12                # B/s, H100 SXM HBM3
# what one 80 GiB card gives a step: the 85,017,493,504 bytes (79.18 GiB)
# an H100 80GB HBM3 reports as ``total_memory``, less ~0.7 GiB of CUDA
# context and allocator slack
H100_USABLE_BYTES = int(78.5 * 2**30)


@dataclass(frozen=True)
class Mesh:
    """Axis names and extents of a device layout, and the device of each
    page-range shard in shard order (None: every shard on the device of
    the engine the mesh is handed to)."""
    axis_names: Tuple[str, ...]
    extents: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.extents) or \
                any(int(e) < 1 for e in self.extents):
            raise ValueError(f"a mesh needs one extent >= 1 per axis, got "
                             f"{self.axis_names} {self.extents}")
        if self.devices is not None:
            devs = tuple(torch.device(d) for d in self.devices)
            if len(devs) != kv_shard_count(self):
                raise ValueError(f"a mesh of {kv_shard_count(self)} shards "
                                 f"needs as many devices, got {len(devs)}")
            object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, in axis order."""
        return dict(zip(self.axis_names, self.extents))


def make_host_mesh(device=None) -> Mesh:
    """The degenerate mesh (data 1, model 1): no page-range shards."""
    return Mesh(("data", "model"), (1, 1),
                None if device is None else [device])


def make_sim_mesh(data: int = 4, model: int = 2, pod: int = 1,
                  devices=None) -> Mesh:
    """A small mesh of ``pod * data`` page-range shards: each a pool of its
    own on ``devices[s]``, or, without ``devices``, all on the engine's
    device (the JAX package's simulated-device mesh, with its axes)."""
    if pod > 1:
        return Mesh(("pod", "data", "model"), (pod, data, model), devices)
    return Mesh(("data", "model"), (data, model), devices)


def kv_shard_count(mesh) -> int:
    """The KV pool's page-range shards a mesh implies: the product of its
    ``PAGES_AXES`` extents. ``Engine`` derives ``CacheConfig.num_shards``
    from it (and refuses a config that disagrees)."""
    return math.prod(mesh.shape[a] for a in PAGES_AXES if a in mesh.shape)
