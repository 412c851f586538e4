"""Model and cache configuration of the PyTorch port.

The same frozen ``ModelConfig`` / ``CacheConfig`` as the JAX package, field
for field, so a config built by either package describes the same model.
Two router fields (``router_score``, ``routed_scaling``) are the port's
own (``PORT_ONLY_FIELDS``); their defaults are the JAX package's routing, so a config of its architectures
equals its config on every shared field and holds them at the defaults.
``family`` selects the implementation in ``repro_torch.models.registry``;
this port serves the ``dense`` family (llama-style GQA decoders), the
``moe`` family (GQA + routed experts, mixtral), the ``mla`` family (latent
attention + MoE, deepseek-v2), the ``vlm`` family (a GQA decoder behind
a patch-embedding stub, internvl2), ``griffin`` (RG-LRU + local attention,
recurrentgemma) and ``rwkv6`` (attention-free, RWKV-6 "Finch").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""                 # citation (arXiv / model card)

    # -- attention details ----------------------------------------------
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False           # qwen2.5-style bias on qkv projections
    attn_window: int = 0             # 0 = full causal; >0 sliding window
    sink_blocks: int = 1             # Opt-KV SkipSet: KV pages always kept
    rope_theta: float = 10000.0

    # -- MoE --------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    # the router, port only (the JAX package routes by softmax alone): the
    # defaults are its routing
    router_score: str = "softmax"    # "softmax" | "sigmoid" (with a
                                     # per-expert bias that picks, not weighs)
    routed_scaling: float = 1.0      # the routed experts' weights times this

    # -- MLA (deepseek-v2) -------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- hybrid (griffin / recurrentgemma) ----------------------------------
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 0
    lru_width: int = 0
    conv1d_width: int = 4

    # -- encoder-decoder (whisper) ------------------------------------------
    encoder_layers: int = 0
    num_frames: int = 0

    # -- vlm ------------------------------------------------------------------
    num_patches: int = 0

    # -- misc -----------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv6"

    @property
    def q_per_kv(self) -> int:
        """Opt-GQA Eq. 7: H_g = H_q / H_k (query heads per group)."""
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def has_subquadratic_path(self) -> bool:
        if self.family in ("rwkv6", "griffin"):
            return True
        return self.attn_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models.registry import get_model
        return get_model(self).param_count()

    def active_param_count(self) -> int:
        """Parameters one token reads: a MoE layer counts its ``top_k``
        routed experts only."""
        from repro_torch.models.registry import get_model
        return get_model(self).active_param_count()


# fields the JAX package's ModelConfig does not have, with their defaults
PORT_ONLY_FIELDS = {"router_score": "softmax", "routed_scaling": 1.0}


@dataclass(frozen=True)
class CacheConfig:
    """Paged-KV pool geometry and cache policy in one place.

    ``num_pages`` is the requested device pool size in pages (0 = derive it
    from ``num_lanes * pages(max_len)``); the last device page is reserved
    as the SkipSet write sentinel. ``page_size == 0`` inherits
    ``CoOptConfig.page_size``. ``host_pages > 0`` turns on the host-DRAM
    spill tier: LRU-evicted registered prefix pages are spilled to that many
    host pages instead of destroyed and prefetched back on a prefix hit
    (``Engine._spill_page``, ``Engine._upload_page``); ``prefetch_depth``
    bounds how many queued requests the scheduler scans for prefetchable
    prefixes a turn; ``host_quant`` fp8-encodes bf16 pool pages on spill.
    ``num_shards`` splits the pool into
    that many contiguous page ranges, the pool padded so they are equal
    (``cache.block_manager.padded_pool_pages``); a request's pages stay in one
    range, and under a ``launch.mesh`` mesh the kernels read each range as
    its own shard (``kernels.sharded``).
    """
    num_pages: int = 0
    page_size: int = 0
    num_shards: int = 1
    enable_prefix_cache: bool = True
    host_pages: int = 0
    prefetch_depth: int = 2
    host_quant: bool = False

    def __post_init__(self):
        if self.num_pages < 0 or self.page_size < 0 or self.host_pages < 0:
            raise ValueError("CacheConfig sizes must be >= 0")
        if self.num_shards < 1:
            raise ValueError("CacheConfig.num_shards must be >= 1")

    def replace(self, **kw) -> "CacheConfig":
        return dataclasses.replace(self, **kw)

    def resolve(self, *, page_size: int, num_pages: int) -> "CacheConfig":
        """Fill the inherit-defaults (0) fields from the engine context."""
        return self.replace(page_size=self.page_size or page_size,
                            num_pages=self.num_pages or num_pages)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=2, moe_d_ff=128,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.family == "mla":
        # a low-rank query keeps one of its own, and a value width apart
        # from the query's stays apart
        kw.update(kv_lora_rank=64, q_lora_rank=min(cfg.q_lora_rank, 96),
                  qk_nope_head_dim=64, qk_rope_head_dim=32,
                  v_head_dim=64 if cfg.v_head_dim == cfg.qk_nope_head_dim
                  else 96)
    if cfg.family == "griffin":
        kw.update(num_layers=3, lru_width=256, local_window=64)
    if cfg.family == "whisper":
        kw.update(encoder_layers=2, num_frames=32)
    if cfg.family == "vlm":
        kw.update(num_patches=16)
    if cfg.attn_window:
        kw.update(attn_window=64)
    return cfg.replace(**kw)
