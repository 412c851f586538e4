"""Decoder-only transformer of the dense family (llama/qwen-style GQA), the
moe family (mixtral: GQA + a routed-expert FFN on every layer), the mla
family (deepseek-v2: latent attention + MoE FFN) and the vlm family
(internvl2: a GQA decoder whose first ``num_patches`` positions take
precomputed patch embeddings instead of token embeddings), with paged KV
caching and the three LLM-CoOpt techniques toggled by a ``CoOptConfig``.
The port of the JAX package's ``TransformerModel``.

Parameters are a plain dict of tensors in the JAX package's layout:
``{"embed", "segments": [{stacked (L, ...) leaves}], "final_norm",
"lm_head"}``, weights ``(d_in, d_out)``; a MoE model has two segments (its
leading dense-FFN layers, then the MoE layers). The JAX layer scan becomes
a Python loop over per-layer views of the stacked leaves and of the
stacked pool; cache writes update the pool in place.

Cache layout per layer: dense ``kv (2, P, ps, Hkv, D)`` + ``scale (2, P,
ps, Hkv)``; mla ``kv (P, ps, R+dr)`` (one latent per token, no K/V axis)
+ ``scale (P, ps, 2)`` (c_kv and k_rope scales).

Step kinds:
  forward     – teacher-forced logits of a whole sequence (training), each
                layer under activation checkpointing
  prefill     – chunked (``batch["positions"]`` given: the engine's mixed
                step, attention over the paged history) or full-prompt
  decode_step – ONE token against the paged cache (Opt-Pa / Opt-KV read path)
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.core.opt_kv import (alloc_cache, identity_page_table,
                                     identity_slots, pool_layout, write_kv)
from repro_torch.core.opt_pa import (paged_chunk_attention,
                                     paged_decode_attention)
from repro_torch.models import mla as mla_mod
from repro_torch.models.layers import (apply_rope, causal_attention,
                                       init_param, linear, repeat_kv, rmsnorm,
                                       swiglu)
from repro_torch.models.moe import moe_ffn

FAMILIES = ("dense", "moe", "mla", "vlm")


def check_device(device) -> torch.device:
    """Entry points run on the card; the CPU only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


class TransformerModel:
    """Families: dense (yi/qwen/deepseek/llama), moe (mixtral), mla
    (deepseek-v2), vlm (internvl2: stub patch embeddings prepended)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ported: "
                f"{', '.join(FAMILIES)})")
        self.cfg = cfg

    # ------------------------------------------------------------- params --
    def _segments(self):
        """[(layer count, ffn kind)]: a MoE model's leading dense-FFN layers
        form their own segment."""
        cfg = self.cfg
        moe = "moe" if cfg.num_experts else "dense"
        if cfg.num_experts and cfg.first_dense_layers:
            return [(cfg.first_dense_layers, "dense"),
                    (cfg.num_layers - cfg.first_dense_layers, moe)]
        return [(cfg.num_layers, moe)]

    def _attn_shapes(self, L: int) -> Dict[str, Any]:
        cfg = self.cfg
        d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        bf, f32 = torch.bfloat16, torch.float32
        s = {"ln1": ((L, d), "ones", f32)}
        if cfg.family == "mla":
            dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            R, dv = cfg.kv_lora_rank, cfg.v_head_dim
            if cfg.q_lora_rank:     # q = W_qb RMSNorm(W_qa x)
                Rq = cfg.q_lora_rank
                s.update(wq_a=((L, d, Rq), "normal", bf),
                         q_a_norm=((L, Rq), "ones", f32),
                         wq_b=((L, Rq, H * (dn + dr)), "normal", bf))
            else:
                s.update(wq=((L, d, H * (dn + dr)), "normal", bf))
            s.update(w_dkv=((L, d, R + dr), "normal", bf),
                     kv_norm=((L, R), "ones", f32),
                     w_uk=((L, R, H * dn), "normal", bf),
                     w_uv=((L, R, H * dv), "normal", bf),
                     wo=((L, H * dv, d), "normal", bf))
            return s
        s.update(wq=((L, d, H * D), "normal", bf),
                 wk=((L, d, Hkv * D), "normal", bf),
                 wv=((L, d, Hkv * D), "normal", bf),
                 wo=((L, H * D, d), "normal", bf))
        if cfg.qkv_bias:
            s.update(bq=((L, H * D), "zeros", bf),
                     bk=((L, Hkv * D), "zeros", bf),
                     bv=((L, Hkv * D), "zeros", bf))
        if cfg.qk_norm:
            s.update(q_norm=((L, D), "ones", f32),
                     k_norm=((L, D), "ones", f32))
        return s

    def _ffn_shapes(self, L: int, kind: str) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        bf, f32 = torch.bfloat16, torch.float32
        s = {"ln2": ((L, d), "ones", f32)}
        if kind == "dense":
            ff = cfg.d_ff
            s.update(wg=((L, d, ff), "normal", bf),
                     wu=((L, d, ff), "normal", bf),
                     wd=((L, ff, d), "normal", bf))
            return s
        E, ff = cfg.num_experts, cfg.moe_d_ff
        s.update(wr=((L, d, E), "normal", bf))
        if cfg.router_score == "sigmoid":       # its correction bias
            s.update(wr_bias=((L, E), "embed", f32))
        s.update(wg_e=((L, E, d, ff), "normal", bf),
                 wu_e=((L, E, d, ff), "normal", bf),
                 wd_e=((L, E, ff, d), "normal", bf))
        if cfg.num_shared_experts:
            sf = ff * cfg.num_shared_experts
            s.update(wg_s=((L, d, sf), "normal", bf),
                     wu_s=((L, d, sf), "normal", bf),
                     wd_s=((L, sf, d), "normal", bf))
        return s

    def param_shapes(self) -> Dict[str, Any]:
        """Leaf -> (shape, init, dtype); segments hold stacked layers."""
        cfg = self.cfg
        d = cfg.d_model
        bf, f32 = torch.bfloat16, torch.float32
        segs = []
        for count, kind in self._segments():
            seg = self._attn_shapes(count)
            seg.update(self._ffn_shapes(count, kind))
            segs.append(seg)
        return {"embed": ((cfg.vocab_size, d), "embed", bf),
                "segments": segs,
                "final_norm": ((d,), "ones", f32),
                "lm_head": ((d, cfg.vocab_size), "normal", bf)}

    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (fan-in scaled normal, as the JAX package)."""
        device = check_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        spec = self.param_shapes()

        def make(leaf):
            shape, init, dtype = leaf
            return init_param(shape, init, gen, device, dtype)

        return {"embed": make(spec["embed"]),
                "segments": [{k: make(v) for k, v in seg.items()}
                             for seg in spec["segments"]],
                "final_norm": make(spec["final_norm"]),
                "lm_head": make(spec["lm_head"])}

    def param_count(self) -> int:
        spec = self.param_shapes()
        leaves = [spec["embed"], spec["final_norm"], spec["lm_head"]]
        leaves += [v for seg in spec["segments"] for v in seg.values()]
        return sum(math.prod(shape) for shape, _, _ in leaves)

    def active_param_count(self) -> int:
        """``param_count`` less the routed experts a token does not visit
        (each MoE layer reads ``top_k`` of ``num_experts``)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.num_experts:
            return total
        per_layer = 3 * cfg.d_model * cfg.moe_d_ff
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        return total - per_layer * (cfg.num_experts - cfg.top_k) * moe_layers

    # ------------------------------------------------------------ caching --
    def cache_shape(self, batch: int, max_len: int, coopt: CoOptConfig,
                    num_shards: int = 1, cache_cfg=None):
        """Leaf -> (shape, dtype, logical axes). GLOBAL-POOL layout: kv/scale
        leaves carry no batch dimension; ``length`` stays per-lane. The
        pages axis is padded to split evenly into ``num_shards`` page
        ranges (``core.opt_kv.pool_layout``)."""
        cfg = self.cfg
        P, ps = pool_layout(batch, max_len, coopt, num_shards, cache_cfg)
        L = cfg.num_layers
        if cfg.family == "mla":
            # one latent per token; two scales per token (c_kv and k_rope
            # magnitudes differ, a shared scale would crush the smaller)
            width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            out = {"kv": ((L, P, ps, width), coopt.kv_dtype,
                          ("layers", "pages", None, "latent"))}
            if coopt.opt_kv:
                out["scale"] = ((L, P, ps, 2), torch.float32,
                                ("layers", "pages", None, None))
        else:
            Hkv, D = cfg.num_kv_heads, cfg.head_dim
            out = {"kv": ((L, 2, P, ps, Hkv, D), coopt.kv_dtype,
                          ("layers", None, "pages", None, "kv_heads",
                           "head_dim"))}
            if coopt.opt_kv:
                out["scale"] = ((L, 2, P, ps, Hkv), torch.float32,
                                ("layers", None, "pages", None, "kv_heads"))
        out["length"] = ((batch,), torch.int32, ("batch",))
        return out

    def init_cache(self, batch: int, max_len: int, coopt: CoOptConfig,
                   num_shards: int = 1, cache_cfg=None, device="cuda",
                   shard_devices=None):
        """Zero cache leaves on ``device``; with ``shard_devices`` (a mesh's,
        one device a shard) each pool leaf is a ``ShardedPool``, its page
        ranges on those devices (``core.opt_kv.alloc_cache``)."""
        return alloc_cache(
            self.cache_shape(batch, max_len, coopt, num_shards=num_shards,
                             cache_cfg=cache_cfg),
            check_device(device), shard_devices)

    # -------------------------------------------------------------- layers --
    def _qkv(self, p, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = linear(x, p["wq"], p.get("bq")).reshape(B, S, H, D)
        k = linear(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, D)
        v = linear(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, D)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def _query(self, p, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        q = linear(x, p["wq"], p.get("bq")).reshape(B, S, cfg.num_heads,
                                                    cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        return apply_rope(q, positions, cfg.rope_theta)

    def _new_kv(self, p, x, positions):
        """Per-token cache entries of a decode token or chunk: (k, v) of
        shape (B,S,Hkv,D), or (latent (B,S,R+dr), None) for MLA."""
        cfg = self.cfg
        B, S, _ = x.shape
        if cfg.family == "mla":
            return mla_mod.mla_project(x, p, cfg, positions)[2], None
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        k = linear(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, D)
        v = linear(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, D)
        if cfg.qk_norm:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
        return apply_rope(k, positions, cfg.rope_theta), v

    def _attention_full(self, p, x, positions, coopt: CoOptConfig):
        """Full-sequence attention (non-chunked prefill). Returns (out, k, v):
        the per-token cache entries, (latent, None) for MLA."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if cfg.family == "mla":
            qn, qr, latent = mla_mod.mla_project(x, p, cfg, positions)
            o = mla_mod.mla_full_attention(qn, qr, latent, p, cfg,
                                           window=cfg.attn_window)
            return linear(o.reshape(B, S, -1), p["wo"]), latent, None
        q, k, v = self._qkv(p, x, positions)
        if coopt.use_kernel:
            # K8: flash_prefill (its plain version on CPU tensors)
            from repro_torch.kernels import ops
            if coopt.opt_gqa or Hkv == H:
                o = ops.flash_prefill(q, k, v, window=cfg.attn_window)
            else:
                o = ops.flash_prefill(q, repeat_kv(k, H // Hkv),
                                      repeat_kv(v, H // Hkv),
                                      window=cfg.attn_window)
        elif coopt.opt_gqa or Hkv == H:
            o = causal_attention(q, k, v, window=cfg.attn_window)
        else:  # Original: KV physically expanded per query head (Fig. 2)
            o = causal_attention(q, repeat_kv(k, H // Hkv),
                                 repeat_kv(v, H // Hkv),
                                 window=cfg.attn_window)
        return linear(o.reshape(B, S, H * D), p["wo"]), k, v

    def _attention_chunk(self, p, x, positions, kv_c, sc_c, page_table,
                         coopt, long_window: int = 0, seg_q=None,
                         page_seg=None, page_base=None):
        """Prefill-continuation attention: the chunk's K/V are already in
        the pool; queries attend the lane's whole cache through its page
        table with true positions (per-lane, so decode lanes of length 1 mix
        with prefill chunks in one call)."""
        cfg = self.cfg
        B, S, _ = x.shape
        window = cfg.attn_window or long_window
        if cfg.family == "mla":
            qn, qr = mla_mod.mla_query(x, p, cfg, positions)
            o = mla_mod.mla_chunk_attention(
                qn, qr, kv_c, sc_c, positions, page_table, p, cfg, coopt,
                window=window, sink_pages=cfg.sink_blocks, seg_q=seg_q,
                page_seg=page_seg, page_base=page_base)
            return linear(o.reshape(B, S, -1), p["wo"])
        q = self._query(p, x, positions)
        o = paged_chunk_attention(q, kv_c, sc_c, positions, page_table,
                                  coopt, window=window,
                                  sink_pages=cfg.sink_blocks, seg_q=seg_q,
                                  page_seg=page_seg, page_base=page_base)
        return linear(o.reshape(B, S, -1).to(x.dtype), p["wo"])

    def _attention_decode(self, p, x, kv_c, sc_c, positions, new_len,
                          page_table, coopt, long_window: int):
        """One-token attention against this layer's slice of the pool (the
        new token already written). Returns the projected output (B,1,d)."""
        cfg = self.cfg
        B = x.shape[0]
        window = cfg.attn_window or long_window
        if cfg.family == "mla":
            qn, qr = mla_mod.mla_query(x, p, cfg, positions)
            o = mla_mod.mla_paged_decode(
                qn[:, 0], qr[:, 0], kv_c, sc_c, new_len, p, cfg, coopt,
                window=window, sink_pages=cfg.sink_blocks,
                page_table=page_table)
            return linear(o.reshape(B, 1, -1), p["wo"])
        q = self._query(p, x, positions)
        o = paged_decode_attention(
            q[:, 0], kv_c, sc_c, new_len, coopt=coopt, window=window,
            sink_pages=cfg.sink_blocks, page_table=page_table)
        return linear(o.reshape(B, 1, -1), p["wo"])

    def _ffn(self, p, x, kind, coopt: CoOptConfig, with_aux: bool = False):
        """The layer's FFN; with ``with_aux`` (out, ``moe.MoEAux`` or None
        for a dense FFN)."""
        cfg = self.cfg
        if kind == "dense":
            out = swiglu(x, p["wg"], p["wu"], p["wd"])
            return (out, None) if with_aux else out
        shared = ((p["wg_s"], p["wu_s"], p["wd_s"])
                  if cfg.num_shared_experts else None)
        return moe_ffn(x, p["wr"], p["wg_e"], p["wu_e"], p["wd_e"],
                       top_k=cfg.top_k, shared=shared,
                       capacity_factor=coopt.moe_capacity_factor,
                       with_aux=with_aux, score=cfg.router_score,
                       bias=p.get("wr_bias"), scaling=cfg.routed_scaling)

    def _write_layer(self, kv_c, sc_c, new_a, new_b, slots, coopt):
        """Write one layer's cache entries (GLOBAL flat slots; < 0 dropped).
        MLA: new_a = latents (B,S,R+dr) into kv_c (P,ps,R+dr)."""
        if self.cfg.family == "mla":
            from repro_torch.kernels import ops
            return ops.latent_pool_write(kv_c, sc_c, new_a, slots,
                                         opt_kv=coopt.opt_kv,
                                         lora_rank=self.cfg.kv_lora_rank)
        return write_kv(kv_c, sc_c, new_a, new_b, slots, coopt)

    def _layers(self, params, cache, coopt):
        """Per-layer (params, kv, scale, ffn kind) views of the stacked
        leaves."""
        i = 0
        for seg, (count, kind) in zip(params["segments"], self._segments()):
            for j in range(count):
                yield ({k: v[j] for k, v in seg.items()}, cache["kv"][i],
                       cache["scale"][i] if coopt.opt_kv else None, kind)
                i += 1

    def _pool_defaults(self, cache, batch, B, device):
        """(page_table, total_pages) — batch-provided or lane-identity."""
        P_total = cache["kv"].shape[1 if self.cfg.family == "mla" else 2]
        pt = batch.get("page_table")
        if pt is None:
            pt = identity_page_table(B, P_total, device)
        return pt.to(torch.int32), P_total

    # ------------------------------------------------------------ forward --
    def _train_layer(self, pl, h, positions, coopt, kind):
        """One layer of the teacher-forced forward: (h, aux (3,))."""
        eps = self.cfg.norm_eps
        a, _, _ = self._attention_full(pl, rmsnorm(h, pl["ln1"], eps),
                                       positions, coopt)
        h = h + a
        f, aux = self._ffn(pl, rmsnorm(h, pl["ln2"], eps), kind, coopt,
                           with_aux=True)
        aux = h.new_zeros(3, dtype=torch.float32) if aux is None \
            else torch.stack(list(aux))
        return h + f, aux

    def forward(self, params, batch, coopt: CoOptConfig = COOPT):
        """Teacher-forced logits aligned with ``batch["labels"]`` (see
        ``input_specs``): (B,S,V); vlm: the patches of ``batch["patches"]``
        lead the sequence and the logits are the text positions' (B,S_text,
        V). Each layer runs under activation checkpointing (recomputed in
        the backward), as the JAX package's ``jax.checkpoint`` body. Returns
        (logits, aux): the MoE terms summed over layers (zeros for a dense
        model)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = params["embed"][tokens].to(torch.bfloat16)
        off = 0
        if cfg.family == "vlm" and "patches" in batch:
            h = torch.cat([batch["patches"].to(torch.bfloat16), h], dim=1)
            off = cfg.num_patches
        B, S, _ = h.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        aux = torch.zeros(3, dtype=torch.float32, device=h.device)
        for seg, (count, kind) in zip(params["segments"], self._segments()):
            # one unbind a leaf: the backward stacks the layers' gradients
            # once instead of adding a leaf-sized tensor per layer
            views = {k: v.unbind(0) for k, v in seg.items()}
            for j in range(count):
                pl = {k: v[j] for k, v in views.items()}
                h, a = checkpoint(self._train_layer, pl, h, positions, coopt,
                                  kind, use_reentrant=False,
                                  preserve_rng_state=False)
                aux = aux + a
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        if off:
            # as for text alone: logits[i] predicts text token i+1
            h = h[:, off:]
        return linear(h, params["lm_head"]), {
            "load_balance": aux[0], "router_z": aux[1], "dropped": aux[2]}

    def input_specs(self, shape) -> Dict[str, Any]:
        """Step inputs for an ``InputShape``: name -> (shape, dtype)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": ((B, 1), torch.int32)}
        st = S - cfg.num_patches if cfg.family == "vlm" else S
        out = {"tokens": ((B, st), torch.int32)}
        if cfg.family == "vlm":
            out["patches"] = ((B, cfg.num_patches, cfg.d_model),
                              torch.bfloat16)
        if shape.kind == "train":
            out["labels"] = ((B, st), torch.int32)
        return out

    def prefill(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                long_window: int = 0):
        """Prompt forward + cache population. Returns (last-token logits
        (B,V), cache), the cache's pool updated in place.

        Chunked continuation (the engine's ONE ragged step path): pass
        ``batch["positions"]`` (B, S) absolute positions plus matching
        GLOBAL ``slot_idx``, the lane ``page_table`` and the post-step
        ``cache_len``; attention then runs over the whole cached history,
        and a decode lane is a chunk of length 1.

        vlm: ``batch["patches"]`` (B, num_patches, d) holds the patch
        embeddings. A full prompt is the patches followed by the tokens; in
        a chunk, token column j IS position ``positions[:, j]``, and the
        columns whose position falls inside the patch prefix take the patch
        embedding at that position instead of the token's."""
        cfg = self.cfg
        tokens = batch["tokens"]
        dev = tokens.device
        h = params["embed"][tokens].to(torch.bfloat16)
        chunked = "positions" in batch
        off = cfg.num_patches if cfg.family == "vlm" else 0
        patches = batch.get("patches") if off else None
        if chunked:
            positions = batch["positions"].to(torch.int32)
            if patches is not None:
                idx = positions.clamp(0, off - 1).long()
                pe = torch.gather(patches.to(torch.bfloat16), 1, idx[..., None]
                                  .expand(*idx.shape, h.shape[-1]))
                h = torch.where((positions < off)[..., None], pe, h)
        elif patches is not None:
            h = torch.cat([patches.to(torch.bfloat16), h], dim=1)
        B, S, _ = h.shape
        if not chunked:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=dev)[None].expand(B, S)
        page_table, P_total = self._pool_defaults(cache, batch, B, dev)
        if "slot_idx" in batch:
            slots = batch["slot_idx"].to(torch.int32)
        else:
            slots = identity_slots(B, positions, P_total, coopt.page_size)
        new_len = batch.get("cache_len")
        if new_len is None:
            new_len = torch.maximum(cache["length"],
                                    positions.amax(dim=1) + 1)
        new_len = new_len.to(torch.int32)
        seg_q = batch.get("seg_q")
        page_seg = batch.get("page_seg")
        page_base = batch.get("page_base")

        for pl, kv_c, sc_c, kind in self._layers(params, cache, coopt):
            x = rmsnorm(h, pl["ln1"], cfg.norm_eps)
            if chunked:
                k, v = self._new_kv(pl, x, positions)
                self._write_layer(kv_c, sc_c, k, v, slots, coopt)
                a = self._attention_chunk(pl, x, positions, kv_c, sc_c,
                                          page_table, coopt, long_window,
                                          seg_q=seg_q, page_seg=page_seg,
                                          page_base=page_base)
            else:
                a, k, v = self._attention_full(pl, x, positions, coopt)
                self._write_layer(kv_c, sc_c, k, v, slots, coopt)
            h = h + a
            h = h + self._ffn(pl, rmsnorm(h, pl["ln2"], cfg.norm_eps), kind,
                              coopt)
        cache["length"] = new_len
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        last = batch.get("last_pos")
        if last is None:
            last = torch.full((B,), S - 1, dtype=torch.long, device=dev)
        last = last.long()
        if last.dim() == 2:
            # packed rows sample several columns per row: (B, G) -> (B, G, V)
            h_last = torch.gather(h, 1, last[..., None].expand(
                *last.shape, h.shape[-1]))
            return linear(h_last, params["lm_head"]), cache
        h_last = h[torch.arange(B, device=dev), last]
        return linear(h_last, params["lm_head"]), cache

    def decode_step(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                    long_window: int = 0):
        """ONE token (B,1) against the paged cache. Returns (logits (B,V),
        cache). The engine supplies ``positions``/``slot_idx``/
        ``page_table``/``cache_len``; direct callers fall back to the
        per-lane ``length`` leaf and the lane-identity pool partition."""
        cfg = self.cfg
        token = batch["token"]
        dev = token.device
        h = params["embed"][token].to(torch.bfloat16)             # (B,1,d)
        B = h.shape[0]
        positions = batch.get("positions")
        if positions is None:
            positions = cache["length"][:, None]
        positions = positions.to(torch.int32)
        page_table, P_total = self._pool_defaults(cache, batch, B, dev)
        if "slot_idx" in batch:
            slots = batch["slot_idx"].to(torch.int32)
        else:
            slots = identity_slots(B, positions, P_total, coopt.page_size)
        new_len = batch.get("cache_len")
        if new_len is None:
            new_len = cache["length"] + 1
        new_len = new_len.to(torch.int32)

        for pl, kv_c, sc_c, kind in self._layers(params, cache, coopt):
            x = rmsnorm(h, pl["ln1"], cfg.norm_eps)
            k, v = self._new_kv(pl, x, positions)
            self._write_layer(kv_c, sc_c, k, v, slots, coopt)
            h = h + self._attention_decode(pl, x, kv_c, sc_c, positions,
                                           new_len, page_table, coopt,
                                           long_window)
            h = h + self._ffn(pl, rmsnorm(h, pl["ln2"], cfg.norm_eps), kind,
                              coopt)
        cache["length"] = new_len
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return linear(h[:, 0], params["lm_head"]), cache
