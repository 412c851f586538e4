"""Decoder-only transformer of the dense family (llama/qwen-style GQA), with
paged KV caching and the three LLM-CoOpt techniques toggled by a
``CoOptConfig``. The port of the JAX package's ``TransformerModel`` for the
``dense`` family.

Parameters are a plain dict of tensors in the JAX package's layout:
``{"embed", "segments": [{stacked (L, ...) leaves}], "final_norm",
"lm_head"}``, weights ``(d_in, d_out)``. The JAX layer scan becomes a
Python loop over per-layer views of the stacked leaves and of the stacked
pool; cache writes update the pool in place.

Step kinds:
  prefill     – chunked (``batch["positions"]`` given: the engine's mixed
                step, attention over the paged history) or full-prompt
  decode_step – ONE token against the paged cache (Opt-Pa / Opt-KV read path)
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.core.opt_kv import (identity_page_table, identity_slots,
                                     pool_layout, write_kv)
from repro_torch.core.opt_pa import (paged_chunk_attention,
                                     paged_decode_attention)
from repro_torch.models.layers import (apply_rope, causal_attention,
                                       init_param, linear, repeat_kv, rmsnorm,
                                       swiglu)


def check_device(device) -> torch.device:
    """Entry points run on the card; the CPU only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


class TransformerModel:
    """Family: dense (yi/qwen/deepseek/llama)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
        self.cfg = cfg

    # ------------------------------------------------------------- params --
    def param_shapes(self) -> Dict[str, Any]:
        """Leaf -> (shape, init, dtype); segments hold stacked layers."""
        cfg = self.cfg
        L, d = cfg.num_layers, cfg.d_model
        H, Hkv, D, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
        bf, f32 = torch.bfloat16, torch.float32
        seg = {"ln1": ((L, d), "ones", f32),
               "wq": ((L, d, H * D), "normal", bf),
               "wk": ((L, d, Hkv * D), "normal", bf),
               "wv": ((L, d, Hkv * D), "normal", bf),
               "wo": ((L, H * D, d), "normal", bf)}
        if cfg.qkv_bias:
            seg.update(bq=((L, H * D), "zeros", bf),
                       bk=((L, Hkv * D), "zeros", bf),
                       bv=((L, Hkv * D), "zeros", bf))
        if cfg.qk_norm:
            seg.update(q_norm=((L, D), "ones", f32),
                       k_norm=((L, D), "ones", f32))
        seg.update(ln2=((L, d), "ones", f32),
                   wg=((L, d, ff), "normal", bf),
                   wu=((L, d, ff), "normal", bf),
                   wd=((L, ff, d), "normal", bf))
        return {"embed": ((cfg.vocab_size, d), "embed", bf),
                "segments": [seg],
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

    # ------------------------------------------------------------ caching --
    def cache_shape(self, batch: int, max_len: int, coopt: CoOptConfig,
                    cache_cfg=None):
        """Leaf -> (shape, dtype, logical axes). GLOBAL-POOL layout: kv/scale
        leaves carry no batch dimension; ``length`` stays per-lane."""
        cfg = self.cfg
        P, ps = pool_layout(batch, max_len, coopt, cache_cfg)
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        out = {"kv": ((cfg.num_layers, 2, P, ps, Hkv, D), coopt.kv_dtype,
                      ("layers", None, "pages", None, "kv_heads",
                       "head_dim"))}
        if coopt.opt_kv:
            out["scale"] = ((cfg.num_layers, 2, P, ps, Hkv), torch.float32,
                            ("layers", None, "pages", None, "kv_heads"))
        out["length"] = ((batch,), torch.int32, ("batch",))
        return out

    def init_cache(self, batch: int, max_len: int, coopt: CoOptConfig,
                   cache_cfg=None, device="cuda"):
        device = check_device(device)
        return {k: torch.zeros(sh, dtype=dt, device=device)
                for k, (sh, dt, _) in
                self.cache_shape(batch, max_len, coopt,
                                 cache_cfg=cache_cfg).items()}

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
        """Per-token cache entries (B,S,Hkv,D) of a decode token or chunk."""
        cfg = self.cfg
        B, S, _ = x.shape
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        k = linear(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, D)
        v = linear(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, D)
        if cfg.qk_norm:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
        return apply_rope(k, positions, cfg.rope_theta), v

    def _attention_full(self, p, x, positions, coopt: CoOptConfig):
        """Full-sequence attention (non-chunked prefill). Returns (out, k, v)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = self._qkv(p, x, positions)
        if coopt.use_kernel and x.is_cuda:
            # the JAX package runs its flash_prefill kernel here (K8)
            raise NotImplementedError("flash_prefill (K8) not yet ported")
        if coopt.opt_gqa or Hkv == H:
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
        q = self._query(p, x, positions)
        o = paged_chunk_attention(q, kv_c, sc_c, positions, page_table,
                                  coopt, window=cfg.attn_window or long_window,
                                  sink_pages=cfg.sink_blocks, seg_q=seg_q,
                                  page_seg=page_seg, page_base=page_base)
        return linear(o.reshape(B, S, -1).to(x.dtype), p["wo"])

    def _attention_decode(self, p, x, kv_c, sc_c, positions, new_len,
                          page_table, coopt, long_window: int):
        """One-token attention against this layer's slice of the pool (the
        new token already written). Returns the projected output (B,1,d)."""
        cfg = self.cfg
        B = x.shape[0]
        q = self._query(p, x, positions)
        o = paged_decode_attention(
            q[:, 0], kv_c, sc_c, new_len, coopt=coopt,
            window=cfg.attn_window or long_window,
            sink_pages=cfg.sink_blocks, page_table=page_table)
        return linear(o.reshape(B, 1, -1), p["wo"])

    def _ffn(self, p, x):
        return swiglu(x, p["wg"], p["wu"], p["wd"])

    def _layers(self, params, cache, coopt):
        """Per-layer (params, kv, scale) views of the stacked leaves."""
        i = 0
        for seg in params["segments"]:
            count = next(iter(seg.values())).shape[0]
            for j in range(count):
                yield ({k: v[j] for k, v in seg.items()}, cache["kv"][i],
                       cache["scale"][i] if coopt.opt_kv else None)
                i += 1

    def _pool_defaults(self, cache, batch, B, device):
        """(page_table, total_pages) — batch-provided or lane-identity."""
        P_total = cache["kv"].shape[2]
        pt = batch.get("page_table")
        if pt is None:
            pt = identity_page_table(B, P_total, device)
        return pt.to(torch.int32), P_total

    # ------------------------------------------------------------ forward --
    def prefill(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                long_window: int = 0):
        """Prompt forward + cache population. Returns (last-token logits
        (B,V), cache), the cache's pool updated in place.

        Chunked continuation (the engine's ONE ragged step path): pass
        ``batch["positions"]`` (B, S) absolute positions plus matching
        GLOBAL ``slot_idx``, the lane ``page_table`` and the post-step
        ``cache_len``; attention then runs over the whole cached history,
        and a decode lane is a chunk of length 1."""
        cfg = self.cfg
        tokens = batch["tokens"]
        dev = tokens.device
        h = params["embed"][tokens].to(torch.bfloat16)
        B, S, _ = h.shape
        chunked = "positions" in batch
        if chunked:
            positions = batch["positions"].to(torch.int32)
        else:
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

        for pl, kv_c, sc_c in self._layers(params, cache, coopt):
            x = rmsnorm(h, pl["ln1"], cfg.norm_eps)
            if chunked:
                k, v = self._new_kv(pl, x, positions)
                write_kv(kv_c, sc_c, k, v, slots, coopt)
                a = self._attention_chunk(pl, x, positions, kv_c, sc_c,
                                          page_table, coopt, long_window,
                                          seg_q=seg_q, page_seg=page_seg,
                                          page_base=page_base)
            else:
                a, k, v = self._attention_full(pl, x, positions, coopt)
                write_kv(kv_c, sc_c, k, v, slots, coopt)
            h = h + a
            h = h + self._ffn(pl, rmsnorm(h, pl["ln2"], cfg.norm_eps))
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

        for pl, kv_c, sc_c in self._layers(params, cache, coopt):
            x = rmsnorm(h, pl["ln1"], cfg.norm_eps)
            k, v = self._new_kv(pl, x, positions)
            write_kv(kv_c, sc_c, k, v, slots, coopt)
            h = h + self._attention_decode(pl, x, kv_c, sc_c, positions,
                                           new_len, page_table, coopt,
                                           long_window)
            h = h + self._ffn(pl, rmsnorm(h, pl["ln2"], cfg.norm_eps))
        cache["length"] = new_len
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return linear(h[:, 0], params["lm_head"]), cache
