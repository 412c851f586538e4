"""Whisper-small — encoder-decoder transformer [arXiv:2212.04356]. The port
of the JAX package's ``WhisperModel``.

The mel spectrogram and conv feature extractor are a stub, as in the JAX
package: the model takes precomputed frame embeddings (B, num_frames,
d_model).

  encoder  — bidirectional pre-LN attention over the frames (plain
             ``causal_attention(..., causal=False)``, as in the JAX package),
  decoder  — causal self-attention over the LLM-CoOpt paged pool (Opt-KV fp8
             write, Opt-Pa block-wise read: the kernels K1-K4 when
             ``use_kernel`` is set, at head_dim 64 and one query head a kv
             head), then cross-attention whose K/V are computed ONCE from
             the encoder output, on a request's first chunk, and stored
             fp8-quantized in batch-major cache leaves (plain attention
             over the dequantized values).

LayerNorm with bias, a GELU MLP, learned decoder positions (``pos_dec``)
and sinusoidal encoder positions, as in whisper.

Parameters: ``{"embed", "pos_dec", "enc": {stacked (encoder_layers, ...)
leaves}, "enc_ln", "enc_ln_b", "dec": {stacked (num_layers, ...) leaves},
"final_norm", "final_norm_b", "lm_head"}``. Cache: ``kv (L, 2, P, ps, H,
D)`` + ``scale`` (the global pool, written in place), ``xk``/``xv (L, B,
F, H, D)`` + ``xscale (L, 2, B, F, H)`` (batch-major: returned as new
tensors where a step fills them; the engine writes them into its
persistent leaves under the lane mask) and ``length``.

``forward`` is the teacher-forced training path: the encoder, the cross
K/V (fp8 under Opt-KV, as in the JAX package), and the decoder's causal
self-attention over its in-flight K/V (the pool writes of the JAX
package's body are dead there and skipped), each encoder and decoder layer
under activation checkpointing.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.cache.quant import dequantize_fp8, quantize_fp8, select
from repro_torch.configs.base import ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.core.opt_kv import (alloc_cache, identity_page_table,
                                     identity_slots, pool_layout, write_kv)
from repro_torch.core.opt_pa import (paged_chunk_attention,
                                     paged_decode_attention)
from repro_torch.models.layers import (causal_attention, gelu_mlp, init_tree,
                                       layernorm, linear, tree_count)
from repro_torch.models.transformer import check_device

_MAX_POS = 32768 * 2   # learned decoder positions (stress shapes included)


class WhisperModel:
    # batch-major leaves a request's first chunk fills (cross-attention K/V)
    cross_leaves = ("xk", "xv", "xscale")

    def __init__(self, cfg: ModelConfig):
        assert cfg.family == "whisper"
        self.cfg = cfg

    # ------------------------------------------------------------- params --
    def _block_shapes(self, L: int, cross: bool) -> Dict[str, Any]:
        cfg = self.cfg
        d, HD, ff = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.d_ff
        bf, f32 = torch.bfloat16, torch.float32
        s = {"ln1": ((L, d), "ones", f32), "ln1_b": ((L, d), "zeros", f32),
             "wq": ((L, d, HD), "normal", bf), "bq": ((L, HD), "zeros", bf),
             "wk": ((L, d, HD), "normal", bf),
             "wv": ((L, d, HD), "normal", bf), "bv": ((L, HD), "zeros", bf),
             "wo": ((L, HD, d), "normal", bf), "bo": ((L, d), "zeros", bf),
             "ln2": ((L, d), "ones", f32), "ln2_b": ((L, d), "zeros", f32),
             "w1": ((L, d, ff), "normal", bf), "b1": ((L, ff), "zeros", bf),
             "w2": ((L, ff, d), "normal", bf), "b2": ((L, d), "zeros", bf)}
        if cross:
            s.update({
                "lnx": ((L, d), "ones", f32), "lnx_b": ((L, d), "zeros", f32),
                "xwq": ((L, d, HD), "normal", bf),
                "xbq": ((L, HD), "zeros", bf),
                "xwk": ((L, d, HD), "normal", bf),
                "xwv": ((L, d, HD), "normal", bf),
                "xbv": ((L, HD), "zeros", bf),
                "xwo": ((L, HD, d), "normal", bf),
                "xbo": ((L, d), "zeros", bf)})
        return s

    def param_shapes(self) -> Dict[str, Any]:
        """Leaf -> (shape, init, dtype); ``enc`` and ``dec`` hold stacked
        layers."""
        cfg = self.cfg
        d, bf, f32 = cfg.d_model, torch.bfloat16, torch.float32
        return {"embed": ((cfg.vocab_size, d), "embed", bf),
                "pos_dec": ((_MAX_POS, d), "embed", bf),
                "enc": self._block_shapes(cfg.encoder_layers, cross=False),
                "enc_ln": ((d,), "ones", f32),
                "enc_ln_b": ((d,), "zeros", f32),
                "dec": self._block_shapes(cfg.num_layers, cross=True),
                "final_norm": ((d,), "ones", f32),
                "final_norm_b": ((d,), "zeros", f32),
                "lm_head": ((d, cfg.vocab_size), "normal", bf)}

    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (fan-in scaled normal, as the JAX package)."""
        return init_tree(self.param_shapes(), seed, check_device(device))

    def param_count(self) -> int:
        return tree_count(self.param_shapes())

    def active_param_count(self) -> int:
        return self.param_count()

    # -------------------------------------------------------------- encoder --
    @staticmethod
    def _sinusoids(length: int, channels: int, device) -> torch.Tensor:
        half = channels // 2
        log_ts = math.log(10000.0) / (half - 1)
        inv = torch.exp(-log_ts * torch.arange(half, dtype=torch.float32,
                                               device=device))
        t = torch.arange(length, dtype=torch.float32,
                         device=device)[:, None] * inv[None]
        return torch.cat([torch.sin(t), torch.cos(t)], dim=-1)

    def _enc_layer(self, pl, h):
        cfg = self.cfg
        B, F, _ = h.shape
        H, D = cfg.num_heads, cfg.head_dim
        x = layernorm(h, pl["ln1"], pl["ln1_b"], cfg.norm_eps)
        q = linear(x, pl["wq"], pl["bq"]).reshape(B, F, H, D)
        k = linear(x, pl["wk"]).reshape(B, F, H, D)
        v = linear(x, pl["wv"], pl["bv"]).reshape(B, F, H, D)
        o = causal_attention(q, k, v, causal=False)
        h = h + linear(o.reshape(B, F, H * D), pl["wo"], pl["bo"])
        x = layernorm(h, pl["ln2"], pl["ln2_b"], cfg.norm_eps)
        return h + gelu_mlp(x, pl["w1"], pl["b1"], pl["w2"], pl["b2"])

    def encode(self, params, frames: torch.Tensor,
               remat: bool = False) -> torch.Tensor:
        """frames (B, F, d) stub embeddings -> encoder states (B, F, d).
        ``remat`` (training) runs each layer under activation
        checkpointing."""
        cfg = self.cfg
        _, F, d = frames.shape
        h = frames.to(torch.bfloat16) + \
            self._sinusoids(F, d, frames.device).to(torch.bfloat16)[None]
        enc = {k: v.unbind(0) for k, v in params["enc"].items()}
        for i in range(cfg.encoder_layers):
            pl = {k: v[i] for k, v in enc.items()}
            if remat:
                h = checkpoint(self._enc_layer, pl, h, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = self._enc_layer(pl, h)
        return layernorm(h, params["enc_ln"], params["enc_ln_b"],
                         cfg.norm_eps)

    # ---------------------------------------------------------- cross-attn --
    def _cross_kv(self, pl, enc, coopt: CoOptConfig):
        """One layer's cross-attention K/V of the encoder states: (k, v,
        scale (2, B, F, H)) fp8 under Opt-KV, else (k, v, None) bf16."""
        cfg = self.cfg
        B, F, _ = enc.shape
        H, D = cfg.num_heads, cfg.head_dim
        k = linear(enc, pl["xwk"]).reshape(B, F, H, D)
        v = linear(enc, pl["xwv"], pl["xbv"]).reshape(B, F, H, D)
        if not coopt.opt_kv:
            return k, v, None
        (k, sk), (v, sv) = quantize_fp8(k), quantize_fp8(v)
        return k, v, torch.stack([sk, sv])

    def _fill_cross(self, params, enc, coopt: CoOptConfig):
        """Every layer's cross K/V, stacked: ``xk``/``xv`` (L, B, F, H, D)
        and, under Opt-KV, ``xscale`` (L, 2, B, F, H). Returns {leaf:
        tensor}."""
        dec = {k: params["dec"][k].unbind(0) for k in ("xwk", "xwv", "xbv")}
        per = [self._cross_kv({k: v[i] for k, v in dec.items()}, enc, coopt)
               for i in range(self.cfg.num_layers)]
        out = {"xk": torch.stack([p[0] for p in per]),
               "xv": torch.stack([p[1] for p in per])}
        if coopt.opt_kv:
            out["xscale"] = torch.stack([p[2] for p in per])
        return out

    def _cross_attn(self, pl, x, xk, xv, xsc, coopt: CoOptConfig):
        """x (B,S,d); xk/xv (B,F,H,D), fp8 with ``xsc`` (2,B,F,H) under
        Opt-KV."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = linear(x, pl["xwq"], pl["xbq"]).reshape(B, S, H, D)
        if coopt.opt_kv and xsc is not None:
            xk = dequantize_fp8(xk, xsc[0])
            xv = dequantize_fp8(xv, xsc[1])
        else:
            xk, xv = xk.to(q.dtype), xv.to(q.dtype)
        o = causal_attention(q, xk, xv, causal=False)
        return linear(o.reshape(B, S, H * D), pl["xwo"], pl["xbo"])

    # -------------------------------------------------------------- decoder --
    def _decoder(self, params, tokens, cache, coopt, positions, slots,
                 long_window: int = 0, page_table=None, cache_len=None,
                 chunk_attn: bool = False):
        """The decoder stack over ``tokens`` (B,S) at ``positions``: writes
        each layer's K/V into the pool (in place) and returns the final
        normed states (B,S,d); ``cache["length"]`` is set to the new
        lengths."""
        cfg = self.cfg
        B, S = tokens.shape
        H, D = cfg.num_heads, cfg.head_dim
        dev = tokens.device
        h = params["embed"][tokens].to(torch.bfloat16)
        h = h + params["pos_dec"][positions.long()].to(torch.bfloat16)
        if page_table is None:
            page_table = identity_page_table(B, cache["kv"].shape[2], dev)
        page_table = page_table.to(torch.int32)
        new_len = (cache["length"] + S if cache_len is None
                   else cache_len).to(torch.int32)
        dec = {k: v.unbind(0) for k, v in params["dec"].items()}
        for i in range(cfg.num_layers):
            pl = {k: v[i] for k, v in dec.items()}
            kv_c = cache["kv"][i]
            sc_c = cache["scale"][i] if coopt.opt_kv else None
            xsc = cache["xscale"][i] if coopt.opt_kv else None

            def self_attn(q, k, v):
                write_kv(kv_c, sc_c, k, v, slots, coopt)
                if chunk_attn:
                    # a chunk attends the lane's whole cached history
                    # (prefix hits, earlier chunks, this one) with true
                    # positions: the engine's ragged step path
                    return paged_chunk_attention(
                        q, kv_c, sc_c, positions, page_table, coopt,
                        window=long_window, sink_pages=cfg.sink_blocks)
                if S == 1:
                    return paged_decode_attention(
                        q[:, 0], kv_c, sc_c, new_len, coopt=coopt,
                        window=long_window, sink_pages=cfg.sink_blocks,
                        page_table=page_table)[:, None]
                return causal_attention(q, k, v)
            h = self._dec_layer(pl, h, self_attn, cache["xk"][i],
                                cache["xv"][i], xsc, coopt)
        cache["length"] = new_len
        return layernorm(h, params["final_norm"], params["final_norm_b"],
                         cfg.norm_eps)

    def _dec_layer(self, pl, h, self_attn, xk, xv, xsc, coopt: CoOptConfig):
        """One decoder layer; ``self_attn(q, k, v)`` -> (B,S,H,D)."""
        cfg = self.cfg
        B, S, _ = h.shape
        H, D = cfg.num_heads, cfg.head_dim
        x = layernorm(h, pl["ln1"], pl["ln1_b"], cfg.norm_eps)
        q = linear(x, pl["wq"], pl["bq"]).reshape(B, S, H, D)
        k = linear(x, pl["wk"]).reshape(B, S, H, D)
        v = linear(x, pl["wv"], pl["bv"]).reshape(B, S, H, D)
        o = self_attn(q, k, v)
        h = h + linear(o.reshape(B, S, H * D).to(h.dtype), pl["wo"],
                       pl["bo"])
        x = layernorm(h, pl["lnx"], pl["lnx_b"], cfg.norm_eps)
        h = h + self._cross_attn(pl, x, xk, xv, xsc, coopt)
        x = layernorm(h, pl["ln2"], pl["ln2_b"], cfg.norm_eps)
        return h + gelu_mlp(x, pl["w1"], pl["b1"], pl["w2"], pl["b2"])

    # ------------------------------------------------------------- forward --
    def forward(self, params, batch, coopt: CoOptConfig = COOPT):
        """Teacher-forced decoder logits over the text tokens (B,S,V) for
        training: ``batch["frames"]`` through the encoder, the cross K/V
        (fp8 under Opt-KV), then the decoder with causal self-attention
        over its in-flight K/V. Returns (logits, {})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        enc = self.encode(params, batch["frames"], remat=True)
        dec = {k: v.unbind(0) for k, v in params["dec"].items()}
        layers = [{k: v[i] for k, v in dec.items()}
                  for i in range(cfg.num_layers)]
        # per layer, not stacked: the gradient reaches the fp8 K/V in their
        # own dtype (as in the JAX package), and fp8 tensors do not add
        cross = [self._cross_kv(pl, enc, coopt) for pl in layers]
        positions = torch.arange(S, device=tokens.device)
        h = params["embed"][tokens].to(torch.bfloat16) + \
            params["pos_dec"][positions][None].to(torch.bfloat16)
        for pl, (xk, xv, xsc) in zip(layers, cross):
            h = checkpoint(self._dec_layer, pl, h, causal_attention, xk, xv,
                           xsc, coopt, use_reentrant=False,
                           preserve_rng_state=False)
        h = layernorm(h, params["final_norm"], params["final_norm_b"],
                      cfg.norm_eps)
        return linear(h, params["lm_head"]), {}

    def prefill(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                long_window: int = 0):
        """Prompt prefill, monolithic (the whole right-padded prompt) or a
        chunked continuation (``batch["positions"]``: absolute per-lane
        positions, the engine's ragged step path). Returns (last-token
        logits (B,V), cache): the pool written in place, the cross leaves
        and ``length`` new tensors.

        The cross-attention K/V are computed ONCE per request, on its first
        chunk: pass ``frames`` and a per-lane bool ``cross_mask`` naming
        the lanes whose cross K/V are (re)filled; a step without ``frames``
        skips the encoder entirely."""
        tokens = batch["tokens"]
        dev = tokens.device
        B, S = tokens.shape
        chunked = "positions" in batch
        if "frames" in batch:
            filled = self._fill_cross(params,
                                      self.encode(params, batch["frames"]),
                                      coopt)
            cm = batch.get("cross_mask")
            for key, new in filled.items():
                if cm is None:
                    cache[key] = new
                    continue
                ax = 2 if key == "xscale" else 1     # the batch axis
                m = cm.bool().reshape((1,) * ax + (-1,)
                                      + (1,) * (new.dim() - ax - 1))
                cache[key] = select(m, new, cache[key])
        if chunked:
            positions = batch["positions"].to(torch.int32)
        else:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=dev)[None].expand(B, S)
        if "slot_idx" in batch:
            slots = batch["slot_idx"].to(torch.int32)
        else:
            slots = identity_slots(B, positions, cache["kv"].shape[2],
                                   coopt.page_size)
        h = self._decoder(params, tokens, cache, coopt, positions, slots,
                          long_window=long_window,
                          page_table=batch.get("page_table"),
                          cache_len=batch.get("cache_len"),
                          chunk_attn=chunked)
        last_pos = batch.get("last_pos")
        if last_pos is None:
            h_last = h[:, -1]
        else:
            if not chunked:
                # pads carry slot -1 (never cached); length = real tokens
                cache["length"] = (last_pos + 1).to(torch.int32)
            h_last = h[torch.arange(B, device=dev), last_pos.long()]
        return linear(h_last, params["lm_head"]), cache

    def decode_step(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                    long_window: int = 0):
        """ONE token (B,1) against the paged cache and the stored cross
        K/V. Returns (logits (B,V), cache)."""
        token = batch["token"]
        B = token.shape[0]
        positions = batch.get("positions")
        if positions is None:
            positions = cache["length"][:, None]
        positions = positions.to(torch.int32)
        if "slot_idx" in batch:
            slots = batch["slot_idx"].to(torch.int32)
        else:
            slots = identity_slots(B, positions, cache["kv"].shape[2],
                                   coopt.page_size)
        h = self._decoder(params, token, cache, coopt, positions, slots,
                          long_window=long_window,
                          page_table=batch.get("page_table"),
                          cache_len=batch.get("cache_len"))
        return linear(h[:, 0], params["lm_head"]), cache

    # ------------------------------------------------------------- caching --
    def cache_shape(self, batch: int, max_len: int, coopt: CoOptConfig,
                    num_shards: int = 1, cache_cfg=None):
        """Leaf -> (shape, dtype, logical axes): the decoder's self-KV in
        the GLOBAL-POOL layout (no batch dimension); the cross K/V are
        static per-lane encoder projections and stay batch-major."""
        cfg = self.cfg
        P, ps = pool_layout(batch, max_len, coopt, num_shards, cache_cfg)
        L, H, D, F = cfg.num_layers, cfg.num_heads, cfg.head_dim, \
            cfg.num_frames
        out = {
            "kv": ((L, 2, P, ps, H, D), coopt.kv_dtype,
                   ("layers", None, "pages", None, "kv_heads", "head_dim")),
            "xk": ((L, batch, F, H, D), coopt.kv_dtype,
                   ("layers", "batch", None, "kv_heads", "head_dim")),
            "xv": ((L, batch, F, H, D), coopt.kv_dtype,
                   ("layers", "batch", None, "kv_heads", "head_dim")),
            "length": ((batch,), torch.int32, ("batch",)),
        }
        if coopt.opt_kv:
            out["scale"] = ((L, 2, P, ps, H), torch.float32,
                            ("layers", None, "pages", None, "kv_heads"))
            out["xscale"] = ((L, 2, batch, F, H), torch.float32,
                             ("layers", None, "batch", None, "kv_heads"))
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

    # -------------------------------------------------------------- specs --
    def input_specs(self, shape) -> Dict[str, Any]:
        """Step inputs for an ``InputShape``: name -> (shape, dtype)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": ((B, 1), torch.int32)}
        out = {"tokens": ((B, S), torch.int32),
               "frames": ((B, cfg.num_frames, cfg.d_model), torch.bfloat16)}
        if shape.kind == "train":
            out["labels"] = ((B, S), torch.int32)
        return out
