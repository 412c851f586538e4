"""Griffin / RecurrentGemma — RG-LRU + local-attention hybrid, one attention
layer per two recurrent layers [arXiv:2402.19427]. The port of the JAX
package's ``GriffinModel``.

LLM-CoOpt applies to the local-attention layers, which carry a windowed
paged KV cache: Opt-KV (fp8 + SkipSet), Opt-GQA (one kv head: MQA) and
Opt-Pa (window + sink pages, online softmax) all run there, through the
kernels K1-K4 when ``use_kernel`` is set. The RG-LRU layers carry O(1)
recurrent state: the conv taps (bf16) and the recurrence h (f32).

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(c * r_t * (-softplus(LAMBDA)))            # c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
A chunk runs the linear recurrence as a log-depth associative scan over the
sequence axis (``_assoc_scan``: the tree of ``jax.lax.associative_scan``,
in plain PyTorch; the reference has no Pallas kernel here); a decode step
is the O(1) update.

Parameters: ``{"embed", "rec": {stacked (n_rec, ...) leaves}, "attn":
{stacked (n_attn, ...) leaves}, "final_norm", "lm_head"}``. Layers run in
periods of (rec, rec, attn), then ``num_layers % 3`` trailing rec layers.
Cache: ``conv (n_rec, B, cw-1, W)`` bf16, ``lru (n_rec, B, W)`` f32 (both
batch-major, returned as new tensors: the engine writes them into its
persistent leaves under the lane mask), ``kv (n_attn, 2, P, ps, Hkv, D)``
+ ``scale`` (the global pool, written in place) and ``length``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.core.opt_kv import (alloc_cache, identity_page_table,
                                     identity_slots, pool_layout, write_kv)
from repro_torch.core.opt_pa import (paged_chunk_attention,
                                     paged_decode_attention)
from repro_torch.models.layers import (apply_rope, causal_attention, gelu,
                                       init_tree, linear, repeat_kv, rmsnorm,
                                       softplus, tree_count)
from repro_torch.models.transformer import check_device

_C = 8.0  # RG-LRU temperature


def _comb(u, v):
    """The RG-LRU scan's operator: (au, bu) then (av, bv) is
    (au av, av bu + bv)."""
    (au, bu), (av, bv) = u, v
    return au * av, av * bu + bv


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_comb`` over axis 1, by the recursion of
    ``jax.lax.associative_scan`` (pairs of neighbours combined, the odd
    prefixes scanned recursively, the even ones filled in): log-depth, and
    the same tree of f32 operations as the reference."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _assoc_scan(*_comb((a[:, 0:-1:2], b[:, 0:-1:2]),
                                (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ea, eb = _comb((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _comb((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = ea, oa
    out_b[:, 0::2], out_b[:, 1::2] = eb, ob
    return out_a, out_b


class GriffinModel:
    # batch-major cache leaves carrying cross-chunk recurrent state: the
    # engine zeroes them on a request's first chunk and snapshots them at
    # committed page boundaries (prefix-cache resume points)
    recurrent_leaves = ("conv", "lru")

    def __init__(self, cfg: ModelConfig):
        assert cfg.family == "griffin"
        self.cfg = cfg
        self.n_periods = cfg.num_layers // 3
        self.n_trail = cfg.num_layers % 3          # leftover rec layers
        self.n_rec = self.n_periods * 2 + self.n_trail
        self.n_attn = self.n_periods

    # ------------------------------------------------------------- params --
    def _rec_shapes(self, L: int) -> Dict[str, Any]:
        cfg = self.cfg
        d, W, cw = cfg.d_model, cfg.lru_width, cfg.conv1d_width
        bf, f32 = torch.bfloat16, torch.float32
        return {"ln": ((L, d), "ones", f32),
                "w_gelu": ((L, d, W), "normal", bf),
                "w_rec_in": ((L, d, W), "normal", bf),
                "conv_w": ((L, cw, W), "normal", bf),
                "conv_b": ((L, W), "zeros", bf),
                "w_a": ((L, W, W), "normal", bf),
                "w_x": ((L, W, W), "normal", bf),
                "lam": ((L, W), "ones", f32),
                "w_rec_out": ((L, W, d), "normal", bf),
                "ln_f": ((L, d), "ones", f32),
                "wg": ((L, d, cfg.d_ff), "normal", bf),
                "wu": ((L, d, cfg.d_ff), "normal", bf),
                "wd": ((L, cfg.d_ff, d), "normal", bf)}

    def _attn_shapes(self, L: int) -> Dict[str, Any]:
        cfg = self.cfg
        d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        bf, f32 = torch.bfloat16, torch.float32
        return {"ln": ((L, d), "ones", f32),
                "wq": ((L, d, H * D), "normal", bf),
                "wk": ((L, d, Hkv * D), "normal", bf),
                "wv": ((L, d, Hkv * D), "normal", bf),
                "wo": ((L, H * D, d), "normal", bf),
                "ln_f": ((L, d), "ones", f32),
                "wg": ((L, d, cfg.d_ff), "normal", bf),
                "wu": ((L, d, cfg.d_ff), "normal", bf),
                "wd": ((L, cfg.d_ff, d), "normal", bf)}

    def param_shapes(self) -> Dict[str, Any]:
        """Leaf -> (shape, init, dtype); ``rec`` and ``attn`` hold stacked
        layers."""
        cfg = self.cfg
        return {"embed": ((cfg.vocab_size, cfg.d_model), "embed",
                          torch.bfloat16),
                "rec": self._rec_shapes(self.n_rec),
                "attn": self._attn_shapes(self.n_attn),
                "final_norm": ((cfg.d_model,), "ones", torch.float32),
                "lm_head": ((cfg.d_model, cfg.vocab_size), "normal",
                            torch.bfloat16)}

    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (fan-in scaled normal, as the JAX package)."""
        return init_tree(self.param_shapes(), seed, check_device(device))

    def param_count(self) -> int:
        return tree_count(self.param_shapes())

    def active_param_count(self) -> int:
        return self.param_count()

    # ---------------------------------------------------------- RG-LRU core --
    def _rg_lru(self, pl, x, h0, valid=None):
        """x (B,S,W) bf16; h0 (B,W) f32. Returns (y (B,S,W) f32, h_S).
        ``valid`` (B,S) freezes the recurrence on padding (a=1, b=0)."""
        log_a0 = -softplus(pl["lam"].float())                     # (W,) < 0
        r = torch.sigmoid(linear(x, pl["w_a"]).float())
        i = torch.sigmoid(linear(x, pl["w_x"]).float())
        log_a = _C * r * log_a0                                   # (B,S,W)
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
            * (i * x.float())
        if valid is not None:
            vm = valid[:, :, None]
            a = torch.where(vm, a, 1.0)
            b = b * vm
        if x.shape[1] == 1:
            h = a[:, 0] * h0 + b[:, 0]
            return h[:, None], h
        b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
        _, hs = _assoc_scan(a, b)
        return hs, hs[:, -1]

    def _rec_block(self, pl, x, conv_state, h0, valid=None, last_pos=None):
        """Recurrent block. x (B,S,d). Returns (out, new conv_state, h_S)."""
        cw = self.cfg.conv1d_width
        S = x.shape[1]
        gel = gelu(linear(x, pl["w_gelu"]))
        u = linear(x, pl["w_rec_in"])                    # (B,S,W)
        if valid is not None:  # padding contributes nothing to the conv taps
            u = u * valid[:, :, None].to(u.dtype)
        # causal depthwise conv1d, the taps summed in the reference's order
        upad = torch.cat([conv_state.to(u.dtype), u], dim=1)
        w = pl["conv_w"].float()                         # (cw, W)
        conv = upad[:, 0:S].float() * w[0]
        for k in range(1, cw):
            conv = conv + upad[:, k:k + S].float() * w[k]
        conv = (conv + pl["conv_b"].float()).to(u.dtype)
        if last_pos is None:
            new_conv_state = upad[:, S:S + cw - 1]
        else:  # the last cw-1 REAL inputs end at last_pos (right padding)
            idx = last_pos.long()[:, None] + 1 + torch.arange(
                cw - 1, device=x.device)[None]          # upad offset
            new_conv_state = torch.gather(
                upad, 1, idx[:, :, None].expand(-1, -1, upad.shape[-1]))
        y, h = self._rg_lru(pl, conv, h0, valid)
        y = y.to(x.dtype) * gel
        return linear(y, pl["w_rec_out"]), new_conv_state, h

    def _mlp(self, pl, x):
        return linear(gelu(linear(x, pl["wg"])) * linear(x, pl["wu"]),
                      pl["wd"])

    # --------------------------------------------------------- attn blocks --
    def _qkv(self, pl, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = linear(x, pl["wq"]).reshape(B, S, H, D)
        k = linear(x, pl["wk"]).reshape(B, S, Hkv, D)
        v = linear(x, pl["wv"]).reshape(B, S, Hkv, D)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def _attn_full(self, pl, x, positions, coopt):
        """Whole-prompt local attention (the reference's plain
        ``causal_attention``). Returns (out, k, v)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        q, k, v = self._qkv(pl, x, positions)
        if coopt.opt_gqa or Hkv == H:
            o = causal_attention(q, k, v, window=cfg.local_window)
        else:
            o = causal_attention(q, repeat_kv(k, H // Hkv),
                                 repeat_kv(v, H // Hkv),
                                 window=cfg.local_window)
        return linear(o.reshape(B, S, -1), pl["wo"]), k, v

    # ------------------------------------------------------------- forward --
    def _layers(self, params, cache, h, attn_fn, valid=None, last_pos=None):
        """Run the (rec, rec, attn) periods, then the trailing rec layers.
        ``attn_fn(pl, x, kv_c, sc_c)`` -> the attention output; the pool is
        written in place. Returns (h, new conv leaf, new lru leaf)."""
        cfg = self.cfg
        rec, attn = params["rec"], params["attn"]
        cs, hs = cache["conv"], cache["lru"]
        new_c, new_h = [], []

        def one_rec(hh, j):
            pl = {k: v[j] for k, v in rec.items()}
            a, c1, h1 = self._rec_block(pl, rmsnorm(hh, pl["ln"], cfg.norm_eps),
                                        cs[j], hs[j], valid, last_pos)
            new_c.append(c1)
            new_h.append(h1)
            hh = hh + a
            return hh + self._mlp(pl, rmsnorm(hh, pl["ln_f"], cfg.norm_eps))

        for p in range(self.n_periods):
            h = one_rec(one_rec(h, 2 * p), 2 * p + 1)
            pl = {k: v[p] for k, v in attn.items()}
            sc_c = cache["scale"][p] if "scale" in cache else None
            h = h + attn_fn(pl, rmsnorm(h, pl["ln"], cfg.norm_eps),
                            cache["kv"][p], sc_c)
            h = h + self._mlp(pl, rmsnorm(h, pl["ln_f"], cfg.norm_eps))
        for j in range(self.n_trail):
            h = one_rec(h, 2 * self.n_periods + j)
        return h, torch.stack(new_c), torch.stack(new_h)

    def forward(self, params, batch, coopt: CoOptConfig = COOPT):
        """Teacher-forced logits (B,S,V) for training, from a zero recurrent
        state and with in-flight attention only (no pool). Each (rec, rec,
        attn) period runs under activation checkpointing, as the JAX
        package's ``jax.checkpoint(period)``; the trailing rec layers do not.
        Returns (logits, {})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = params["embed"][tokens].to(torch.bfloat16)
        dev = h.device
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev)[None].expand(B, S)
        c0 = torch.zeros((B, cfg.conv1d_width - 1, cfg.lru_width),
                         dtype=torch.bfloat16, device=dev)
        h0 = torch.zeros((B, cfg.lru_width), dtype=torch.float32, device=dev)
        rec = {k: v.unbind(0) for k, v in params["rec"].items()}
        attn = {k: v.unbind(0) for k, v in params["attn"].items()}

        def one_rec(hh, pl):
            a, _, _ = self._rec_block(pl, rmsnorm(hh, pl["ln"], cfg.norm_eps),
                                      c0, h0)
            hh = hh + a
            return hh + self._mlp(pl, rmsnorm(hh, pl["ln_f"], cfg.norm_eps))

        def period(hh, r0, r1, ap):
            hh = one_rec(one_rec(hh, r0), r1)
            a, _, _ = self._attn_full(ap, rmsnorm(hh, ap["ln"], cfg.norm_eps),
                                      positions, coopt)
            hh = hh + a
            return hh + self._mlp(ap, rmsnorm(hh, ap["ln_f"], cfg.norm_eps))

        def layer(j):
            return {k: v[j] for k, v in rec.items()}
        for p in range(self.n_periods):
            pa = {k: v[p] for k, v in attn.items()}
            h = checkpoint(period, h, layer(2 * p), layer(2 * p + 1), pa,
                           use_reentrant=False, preserve_rng_state=False)
        for j in range(self.n_trail):
            h = one_rec(h, layer(2 * self.n_periods + j))
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return linear(h, params["lm_head"]), {}

    def input_specs(self, shape) -> Dict[str, Any]:
        """Step inputs for an ``InputShape``: name -> (shape, dtype)."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": ((B, 1), torch.int32)}
        out = {"tokens": ((B, S), torch.int32)}
        if shape.kind == "train":
            out["labels"] = ((B, S), torch.int32)
        return out

    def prefill(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                long_window: int = 0):
        """Prompt prefill. Returns (last-token logits (B,V), cache): the pool
        written in place, the recurrent leaves and ``length`` new tensors.
        ``long_window`` is accepted for engine-call uniformity; local
        attention always uses ``cfg.local_window``. With
        ``batch["positions"]`` (B,S) this is a CONTINUATION chunk (the
        engine's ragged step path): the recurrent state in the cache is the
        state after the previous chunk, while the local-attention layers
        write this chunk's K/V to the pool and attend the lane's cached
        history with true positions; a decode lane is a chunk of length 1.
        ``batch["pad_mask"]`` (B,S) marks the real columns (padding freezes
        the recurrence) and ``batch["last_pos"]`` (B,) each lane's last
        real column."""
        cfg = self.cfg
        tokens = batch["tokens"]
        dev = tokens.device
        B, S = tokens.shape
        h = params["embed"][tokens].to(torch.bfloat16)
        chunked = "positions" in batch
        if chunked:
            positions = batch["positions"].to(torch.int32)
        else:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=dev)[None].expand(B, S)
        P_total = cache["kv"].shape[2]
        page_table = batch.get("page_table")
        if "slot_idx" in batch:
            slots = batch["slot_idx"].to(torch.int32)
        else:
            slots = identity_slots(B, positions, P_total, coopt.page_size)
        valid = batch.get("pad_mask")
        if valid is not None:
            valid = valid.bool()
        last_pos = batch.get("last_pos")

        def attn_fn(pl, x, kv_c, sc_c):
            if chunked:
                q, k, v = self._qkv(pl, x, positions)
                write_kv(kv_c, sc_c, k, v, slots, coopt)
                o = paged_chunk_attention(
                    q, kv_c, sc_c, positions, page_table, coopt,
                    window=cfg.local_window,
                    sink_pages=cfg.sink_blocks)
                return linear(o.reshape(B, S, -1).to(x.dtype), pl["wo"])
            a, k, v = self._attn_full(pl, x, positions, coopt)
            write_kv(kv_c, sc_c, k, v, slots, coopt)
            return a

        h, conv, lru = self._layers(params, cache, h, attn_fn, valid,
                                    last_pos)
        cache["conv"], cache["lru"] = conv, lru
        new_len = batch.get("cache_len")
        if new_len is None:
            added = S if valid is None else valid.sum(dim=1)
            new_len = cache["length"] + added
        cache["length"] = new_len.to(torch.int32)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        if last_pos is None:
            h_last = h[:, -1]
        else:
            h_last = h[torch.arange(B, device=dev), last_pos.long()]
        return linear(h_last, params["lm_head"]), cache

    def decode_step(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                    long_window: int = 0):
        """ONE token (B,1): the recurrence's O(1) update and windowed
        attention over the paged cache. Returns (logits (B,V), cache)."""
        cfg = self.cfg
        token = batch["token"]
        dev = token.device
        h = params["embed"][token].to(torch.bfloat16)
        B = h.shape[0]
        positions = batch.get("positions")
        if positions is None:
            positions = cache["length"][:, None]
        positions = positions.to(torch.int32)
        P_total = cache["kv"].shape[2]
        page_table = batch.get("page_table")
        if page_table is None:
            page_table = identity_page_table(B, P_total, dev)
        page_table = page_table.to(torch.int32)
        if "slot_idx" in batch:
            slots = batch["slot_idx"].to(torch.int32)
        else:
            slots = identity_slots(B, positions, P_total, coopt.page_size)
        new_len = batch.get("cache_len")
        if new_len is None:
            new_len = cache["length"] + 1
        new_len = new_len.to(torch.int32)

        def attn_fn(pl, x, kv_c, sc_c):
            q, k, v = self._qkv(pl, x, positions)
            write_kv(kv_c, sc_c, k, v, slots, coopt)
            o = paged_decode_attention(
                q[:, 0], kv_c, sc_c, new_len, coopt=coopt,
                window=cfg.local_window, sink_pages=cfg.sink_blocks,
                page_table=page_table)
            return linear(o.reshape(B, 1, -1), pl["wo"])

        h, conv, lru = self._layers(params, cache, h, attn_fn)
        cache["conv"], cache["lru"], cache["length"] = conv, lru, new_len
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return linear(h[:, 0], params["lm_head"]), cache

    # ------------------------------------------------------------- caching --
    def cache_shape(self, batch: int, max_len: int, coopt: CoOptConfig,
                    num_shards: int = 1, cache_cfg=None):
        """Leaf -> (shape, dtype, logical axes): the attention layers' paged
        KV in the GLOBAL-POOL layout (no batch dimension), the recurrent
        state (conv taps, RG-LRU h) batch-major."""
        cfg = self.cfg
        P, ps = pool_layout(batch, max_len, coopt, num_shards, cache_cfg)
        Hkv, D, W = cfg.num_kv_heads, cfg.head_dim, cfg.lru_width
        out = {
            "conv": ((self.n_rec, batch, cfg.conv1d_width - 1, W),
                     torch.bfloat16, ("layers", "batch", None, "d_model")),
            "lru": ((self.n_rec, batch, W), torch.float32,
                    ("layers", "batch", "d_model")),
            "kv": ((self.n_attn, 2, P, ps, Hkv, D), coopt.kv_dtype,
                   ("layers", None, "pages", None, "kv_heads", "head_dim")),
            "length": ((batch,), torch.int32, ("batch",)),
        }
        if coopt.opt_kv:
            out["scale"] = ((self.n_attn, 2, P, ps, Hkv), torch.float32,
                            ("layers", None, "pages", None, "kv_heads"))
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
