"""Step builders of the port: one (architecture x input shape) cell's
train, prefill or decode step for the dry run (``launch.dryrun``) and
``launch.inspect_cell``, and the serving engine's launch-time warmup.

For every cell ``make_step`` produces a ``StepBundle``:
  * the step function -- train_step / prefill_step / serve_step, the JAX
    package's three steps over the port's models;
  * its inputs as ``Spec`` trees (shape, dtype; nothing allocated), from
    the models' ``param_shapes``, ``input_specs`` and ``cache_shape``;
  * ``meta_args()`` (the inputs on ``torch.device("meta")``) and
    ``init_args(seed)`` (random weights and inputs on the bundle's device).

The cell policies are the JAX package's: whisper-small x long_500k is
skipped (``ShapeSkipped``), the dense, mla and vlm families decode
long_500k through a ``LONG_WINDOW`` sink + window (``long_window_for``), and
``default_microbatches`` is the train_4k accumulation depth.

Not applicable on one card: the JAX package's sharding rules
(``WEIGHT_RULES``, ``CACHE_RULES``, ``KERNEL_CACHE_RULES``, the activation
rules) and ``axes_pspec``, ``cache_shardings`` and ``batch_shardings`` lay
tensors out on a TPU mesh; one card holds every tensor whole, and the
page-range part of the cache rules is ``CacheConfig.num_shards``.
``StepBundle.jitted``/``lower`` have no counterpart: a step runs eagerly.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.models.registry import get_model

# block-sparse window for dense archs on long_500k
LONG_WINDOW = 8192


class ShapeSkipped(Exception):
    """(arch x shape) cell excluded by policy (whisper x long_500k)."""


@dataclass(frozen=True)
class Spec:
    """A tensor's shape and dtype, nothing allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def _is_leaf_spec(node) -> bool:
    """A ``param_shapes`` leaf: (shape, init, dtype)."""
    return isinstance(node, tuple) and len(node) == 3 and \
        isinstance(node[1], str)


def param_specs(model) -> Any:
    """The model's parameter tree with ``Spec`` leaves."""
    def build(node):
        if _is_leaf_spec(node):
            return Spec(tuple(node[0]), node[2])
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return [build(v) for v in node]
    return build(model.param_shapes())


def tree_nbytes(tree) -> int:
    """The bytes of a tree's ``Spec`` or tensor leaves."""
    return sum(x.nbytes for x in tree_util.leaves(tree))


@dataclass
class StepBundle:
    kind: str                       # train | prefill | decode
    fn: Callable                    # the step function
    args: Tuple[Any, ...]           # Spec trees, in the step's order
    cfg: ModelConfig
    shape: InputShape
    coopt: CoOptConfig
    long_window: int = 0
    device: torch.device = torch.device("cpu")
    microbatches: int = 1           # a train step's accumulation depth

    def meta_args(self) -> Tuple[Any, ...]:
        """The inputs on the meta device: shapes and dtypes, no storage."""
        return tuple(tree_util.tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), a)
            for a in self.args)

    def init_args(self, seed: int = 0) -> Tuple[Any, ...]:
        """Random inputs on the bundle's device from ``seed``: the model's
        ``init`` weights; tokens and labels uniform over the vocabulary,
        patches and frames normal. Train adds zero AdamW moments. A decode
        cache holds ``seq_len - 1`` tokens of random pages (fp8 values of
        about N(0, 1) x 128 at scale 1/128, or bf16 N(0, 1)) so the step
        reads a full context; other cache leaves are zero."""
        model = get_model(self.cfg)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(seed, dev)
        names = ("params", "opt_state", "batch") if self.kind == "train" \
            else ("params", "batch", "cache")
        specs = dict(zip(names, self.args))
        batch = {}
        for k, s in specs["batch"].items():
            if s.dtype == torch.int32:
                batch[k] = torch.randint(self.cfg.vocab_size, s.shape,
                                         generator=gen, device=dev,
                                         dtype=torch.int32)
            else:
                batch[k] = torch.randn(s.shape, generator=gen, device=dev,
                                       dtype=torch.float32).to(s.dtype)
        if self.kind == "train":
            from repro_torch.training.optimizer import adamw_init
            return params, adamw_init(params), batch
        cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                 for k, s in specs["cache"].items()}
        if self.kind == "decode":
            _fill_pages(cache, gen)
            cache["length"].fill_(self.shape.seq_len - 1)
        return params, batch, cache


# elements of one random draw while filling a pool (64 Mi: a 256 MiB f32
# temporary)
_FILL = 1 << 26


def _fill_pages(cache: Dict[str, torch.Tensor], gen) -> None:
    kv, scale = cache.get("kv"), cache.get("scale")
    if kv is None:
        return
    flat = kv.view(-1)
    fp8 = kv.dtype.itemsize == 1
    for i in range(0, flat.numel(), _FILL):
        part = flat[i:i + _FILL]
        x = torch.randn(part.numel(), generator=gen, device=kv.device)
        part.copy_(x.mul_(128.0).clamp_(-448.0, 448.0) if fp8 else x)
    if scale is not None:
        scale.fill_(1.0 / 128.0)


def effective_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the long_500k policy."""
    if shape.name != "long_500k":
        return cfg
    if cfg.family == "whisper":
        raise ShapeSkipped(
            "whisper-small x long_500k skipped: full-attention decoder, "
            "448-token native context")
    return cfg


def long_window_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Window for the block-sparse SkipSet policy on long_500k decode."""
    if shape.name != "long_500k":
        return 0
    if cfg.family in ("rwkv6", "griffin"):
        return 0            # natively sub-quadratic (O(1)/O(window) state)
    if cfg.attn_window:
        return 0            # mixtral: native SWA already windowed
    return LONG_WINDOW      # dense/mla/vlm: Opt-KV SkipSet as block sparsity


def default_microbatches(cfg: ModelConfig) -> int:
    """Gradient-accumulation depth for train_4k: the JAX package's policy
    (the fewest microbatches that fit a TPU v5e's 16 GiB), kept so both
    packages split a step alike. MoE dispatch tensors are the hungriest."""
    if cfg.num_experts:
        return 8
    if cfg.family == "griffin":
        return 8        # associative-scan pyramid is the peak, scales ~1/n
    n = get_model(cfg).param_count()
    if n > 6e10:
        return 16
    if n > 3e10:
        return 8
    if n > 8e9:
        return 4
    if n > 5e9:
        return 2
    return 1


def make_step(arch_id: str, shape: Union[str, InputShape],
              coopt: CoOptConfig = COOPT, *, device="cuda",
              lr: float = 3e-4,
              num_microbatches: Optional[int] = None) -> StepBundle:
    """The step of one cell. ``shape`` is a ``configs.SHAPES`` name or an
    ``InputShape`` (a smaller cell of the same kind). ``device`` is where
    ``init_args`` puts the inputs ("meta" for a bundle only run on
    ``meta_args``). Raises ``ShapeSkipped`` for an excluded cell."""
    from repro_torch.kernels import ops
    cfg = get_config(arch_id)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    cfg = effective_config(cfg, shape)
    model = get_model(cfg)
    lw = long_window_for(cfg, shape)
    device = torch.device(device)
    params = param_specs(model)
    batch = {k: Spec(tuple(s), dt)
             for k, (s, dt) in model.input_specs(shape).items()}

    if shape.kind == "train":
        from repro_torch.training.optimizer import AdamWState
        from repro_torch.training.train import make_train_step
        f32 = tree_util.tree_map(lambda s: Spec(s.shape, torch.float32),
                                 params)
        opt = AdamWState(Spec((), torch.int32), f32, f32)
        nm = (num_microbatches if num_microbatches is not None
              else default_microbatches(cfg))
        train_step = make_train_step(cfg, coopt, lr=lr, num_microbatches=nm)
        return StepBundle("train", train_step, (params, opt, batch), cfg,
                          shape, coopt, device=device, microbatches=nm)

    cache = {k: Spec(tuple(s), dt) for k, (s, dt, _) in model.cache_shape(
        shape.global_batch, shape.seq_len, coopt).items()}

    if shape.kind == "prefill":
        def prefill_step(params, batch, cache):
            with ops.mesh_ctx_scope(None):
                return model.prefill(params, batch, cache, coopt)

        return StepBundle("prefill", prefill_step, (params, batch, cache),
                          cfg, shape, coopt, device=device)

    # decode: ONE new token against a cache of seq_len (serve_step)
    def serve_step(params, batch, cache):
        with ops.mesh_ctx_scope(None):
            return model.decode_step(params, batch, cache, coopt,
                                     long_window=lw)

    return StepBundle("decode", serve_step, (params, batch, cache), cfg,
                      shape, coopt, long_window=lw, device=device)


def serving_warmup(engine) -> Dict[str, Any]:
    """Build the serving engine's step runner for every shape of the bucket
    lattice at launch time (``Engine.warmup``: decode, prefill buckets and,
    packing, row buckets x prefill buckets; on CUDA each runner captures a
    CUDA graph), and return a summary for the launch report: the JAX
    package's keys (``aot_executables``: runners built, ``aot_by_kind``,
    ``warmup_s``) and ``graph_pool_gib``, the memory the captures reserved
    (the port's counterpart of what AOT compilation costs). After this,
    steady-state serving builds no runner (``engine.aot_misses`` stays 0)."""
    t0 = time.perf_counter()
    built = engine.warmup()
    kinds: Dict[str, int] = {}
    for key in engine._runners:
        kinds[key[0]] = kinds.get(key[0], 0) + 1
    return {"aot_executables": built,
            "aot_by_kind": kinds,
            "warmup_s": round(time.perf_counter() - t0, 3),
            "graph_pool_gib": round(engine.graph_pool_bytes / 2**30, 4)}
