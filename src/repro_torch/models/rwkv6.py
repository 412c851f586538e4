"""RWKV-6 "Finch" — attention-free, data-dependent decay [arXiv:2404.05892].
The port of the JAX package's ``RWKV6Model``.

LLM-CoOpt's three techniques do not apply (no KV cache to quantize or page,
no query heads to group): the paged-cache plumbing is replaced by an O(1)
recurrent state (per layer a (B, H, D, D) f32 wkv state and two (B, 1, d)
token-shift buffers), with the same engine-facing ``prefill`` /
``decode_step`` as the attention families. No kernel runs here.

Recurrence (per head, head_dim D, diagonal decay w_t in (0,1)):
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
where w_t = exp(-exp(ww_t)) is data-dependent through a low-rank MLP and u
is the per-head bonus of the current token. A chunk runs the chunked form
(``_wkv_chunked``): within a chunk of ``_CHUNK`` tokens the running
state's part is a matmul and the intra-chunk part a masked quadratic form,
with the reference's chunking rule and its exact, clamp-free decays.

Parameters: ``{"embed", "layers": {stacked (L, ...) leaves},
"final_norm", "lm_head"}``. Cache: ``wkv (L, B, H, D, D)`` f32,
``shift_t``/``shift_c (L, B, 1, d)`` bf16 and ``length``, all batch-major;
a step returns them as new tensors, which the engine writes into its
persistent leaves under the lane mask.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.core.opt_kv import alloc_cache
from repro_torch.models.layers import (init_tree, linear, rmsnorm, silu,
                                       tree_count)
from repro_torch.models.transformer import check_device

_LORA = 64        # low-rank dim of the data-dependent decay MLP
_CHUNK = 32       # chunked-scan length: bounds the (C,C,H,D) pairwise-decay
                  # tensor of the intra-chunk term (exact, clamp-free)


class RWKV6Model:
    # batch-major cache leaves carrying cross-chunk recurrent state: the
    # engine zeroes them on a request's first chunk and snapshots them at
    # committed page boundaries (prefix-cache resume points)
    recurrent_leaves = ("wkv", "shift_t", "shift_c")

    def __init__(self, cfg: ModelConfig):
        assert cfg.family == "rwkv6"
        self.cfg = cfg

    # ------------------------------------------------------------- params --
    def param_shapes(self) -> Dict[str, Any]:
        """Leaf -> (shape, init, dtype); ``layers`` holds stacked layers."""
        cfg = self.cfg
        L, d, H, D = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim
        bf, f32 = torch.bfloat16, torch.float32
        lay = {"ln1": ((L, d), "ones", f32),
               "ln2": ((L, d), "ones", f32),
               # token-shift mix coefficients (r, k, v, w, g)
               "mix": ((L, 5, d), "uniform1", f32),
               "wr": ((L, d, H * D), "normal", bf),
               "wk": ((L, d, H * D), "normal", bf),
               "wv": ((L, d, H * D), "normal", bf),
               "wg": ((L, d, H * D), "normal", bf),
               "wo": ((L, H * D, d), "normal", bf),
               # data-dependent decay: w = base + B @ tanh(A @ x)
               "w_base": ((L, H * D), "zeros", f32),
               "dd_a": ((L, d, _LORA), "normal", bf),
               "dd_b": ((L, _LORA, H * D), "normal", bf),
               "u": ((L, H, D), "zeros", f32),
               "gn": ((L, H * D), "ones", f32),
               # channel mix (FFN): relu^2 key, sigmoid receptance gate
               "ck": ((L, d, cfg.d_ff), "normal", bf),
               "cv": ((L, cfg.d_ff, d), "normal", bf),
               "cr": ((L, d, d), "normal", bf)}
        return {"embed": ((cfg.vocab_size, d), "embed", bf),
                "layers": lay,
                "final_norm": ((d,), "ones", f32),
                "lm_head": ((d, cfg.vocab_size), "normal", bf)}

    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        ``device``."""
        return init_tree(self.param_shapes(), seed, check_device(device))

    def param_count(self) -> int:
        return tree_count(self.param_shapes())

    def active_param_count(self) -> int:
        return self.param_count()

    # ------------------------------------------------------- wkv recurrence --
    def _proj(self, pl, x, x_prev):
        """Token-shifted projections. x (B,S,d); x_prev (B,1,d) = the token
        before x[:, 0]. Returns r, k, v, g (B,S,H,D), the decay w (B,S,H,D)
        in (0,1), and the new shift buffer (B,1,d)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        xs = torch.cat([x_prev, x[:, :-1]], dim=1)            # shifted by 1
        mix = pl["mix"].to(x.dtype)                            # (5, d)

        def mixed(i):
            return x + (xs - x) * mix[i]

        r = linear(mixed(0), pl["wr"]).reshape(B, S, H, D)
        k = linear(mixed(1), pl["wk"]).reshape(B, S, H, D)
        v = linear(mixed(2), pl["wv"]).reshape(B, S, H, D)
        g = linear(mixed(4), pl["wg"]).reshape(B, S, H, D)
        # data-dependent decay (Finch): per token, per channel
        ww = pl["w_base"].float() + linear(
            torch.tanh(linear(mixed(3), pl["dd_a"])), pl["dd_b"]).float()
        w = torch.exp(-torch.exp(ww.clamp(-20.0, 8.0))).reshape(B, S, H, D)
        return r, k, v, g, w, x[:, -1:]

    @staticmethod
    def _wkv_chunk(rc, kc, vc, lwc, u, state, tri):
        """One chunk of ``_wkv_chunked``: (out (B,C,H,D), new state)."""
        cum = torch.cumsum(lwc, dim=1)            # log prod of w up to t
        # decay from the chunk start to just BEFORE t: every exponent below
        # is a true non-positive log-decay, so exp never overflows and
        # underflow to zero is the exact limit
        before = cum - lwc                                    # <= 0
        r_d = rc * torch.exp(before)
        k_d = kc * torch.exp(cum[:, -1:] - cum)
        inter = torch.einsum("bchd,bhde->bche", r_d, state)
        # intra-chunk: exponent(t, s) = cum_{t-1} - cum_s, the decay of k_s
        # by w_{s+1} .. w_{t-1} (``minimum``: a tie at 0 splits the
        # gradient, as ``jnp.minimum``'s does)
        pair = before[:, :, None] - cum[:, None, :]           # (B,C,C,H,D)
        att = (rc[:, :, None] * kc[:, None]
               * torch.exp(torch.minimum(pair, pair.new_zeros(())))).sum(-1)
        att = att.permute(0, 3, 1, 2) * tri                    # (B,H,C,C)
        intra = torch.einsum("bhts,bshd->bthd", att, vc)
        # the current token's bonus u
        bonus = (rc * (u[None, None] * kc)).sum(-1)          # (B,C,H)
        out = inter + intra + bonus[..., None] * vc
        state = state * torch.exp(cum[:, -1])[..., None] + \
            torch.einsum("bchd,bche->bhde", k_d, vc)
        return out, state

    @staticmethod
    def _wkv_chunked(r, k, v, w, u, state, remat: bool = False):
        """Chunked linear recurrence. r, k, v, w (B,S,H,D) f32; u (H,D);
        state (B,H,D,D). Returns (out (B,S,H,D), new state). Within a chunk:
        a decay-weighted quadratic form plus the inherited state's matmul.
        ``remat`` recomputes each chunk in the backward (the JAX package's
        nested ``jax.checkpoint``: the (B,C,C,H,D) pairwise decays are not
        kept for every chunk)."""
        B, S, H, D = r.shape
        C = _CHUNK if S % _CHUNK == 0 else S
        logw = torch.log(torch.clamp_min(w, 1e-20))
        tri = torch.tril(torch.ones((C, C), device=r.device), -1)
        outs = []
        for c0 in range(0, S, C):
            args = [t[:, c0:c0 + C] for t in (r, k, v, logw)] + [u, state,
                                                                  tri]
            if remat:
                o, state = checkpoint(RWKV6Model._wkv_chunk, *args,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                o, state = RWKV6Model._wkv_chunk(*args)
            outs.append(o)
        return torch.cat(outs, dim=1), state

    @staticmethod
    def _wkv_step(r, k, v, w, u, state):
        """One-token recurrence. r, k, v, w (B,H,D); state (B,H,D,D)."""
        kv = torch.einsum("bhd,bhe->bhde", k, v)
        out = torch.einsum("bhd,bhde->bhe", r, state + u[None, :, :, None] * kv)
        return out, state * w[..., None] + kv

    def _time_mix(self, pl, x, shift, state, valid=None, last_pos=None,
                  remat: bool = False):
        """x (B,S,d) -> (out, new shift, new state). ``valid`` (B,S) freezes
        the recurrence on padding (w=1, k=0: the state passes through as if
        the token were never fed)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        r, k, v, g, w, new_shift = self._proj(pl, x, shift)
        if valid is not None:
            vmask = valid[:, :, None, None]
            w = torch.where(vmask, w, 1.0)
            k = k * vmask.to(k.dtype)
        if last_pos is not None:
            new_shift = _take(x, last_pos)
        rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
        u = pl["u"].float()
        if S == 1:
            o, state = self._wkv_step(rf[:, 0], kf[:, 0], vf[:, 0], wf[:, 0],
                                      u, state)
            o = o[:, None]
        else:
            o, state = self._wkv_chunked(rf, kf, vf, wf, u, state, remat)
        # group norm over each head, then the gate (Finch: GroupNorm(H))
        mu = o.mean(dim=-1, keepdim=True)
        var = torch.square(o - mu).mean(dim=-1, keepdim=True)
        o = (o - mu) * torch.rsqrt(var + 1e-5)
        o = o.reshape(B, S, H * D) * pl["gn"].float()
        o = o.reshape(B, S, H, D) * silu(g.float())
        out = linear(o.reshape(B, S, H * D).to(x.dtype), pl["wo"])
        return out, new_shift, state

    def _channel_mix(self, pl, x, shift, last_pos=None):
        """relu^2-keyed FFN with a sigmoid receptance gate."""
        xs = torch.cat([shift, x[:, :-1]], dim=1)
        mix = pl["mix"].to(x.dtype)
        xk = x + (xs - x) * mix[1]
        xr = x + (xs - x) * mix[0]
        k = torch.square(torch.relu(linear(xk, pl["ck"])))
        new_shift = x[:, -1:] if last_pos is None else _take(x, last_pos)
        return torch.sigmoid(linear(xr, pl["cr"])) * linear(k, pl["cv"]), \
            new_shift

    # ------------------------------------------------------------- forward --
    def _layer(self, pl, h, wkv, shift_t, shift_c, valid=None, last_pos=None,
               remat: bool = False):
        """One layer: (h, new wkv, new shift_t, new shift_c)."""
        eps = self.cfg.norm_eps
        a, st, s_wkv = self._time_mix(pl, rmsnorm(h, pl["ln1"], eps), shift_t,
                                      wkv, valid, last_pos, remat)
        h = h + a
        f, sc = self._channel_mix(pl, rmsnorm(h, pl["ln2"], eps), shift_c,
                                  last_pos)
        return h + f, s_wkv, st, sc

    def _run(self, params, tokens, state, valid=None, last_pos=None,
             remat: bool = False):
        """The shared trunk. Returns (normed h (B,S,d), new state dict).
        ``remat`` (training) runs each layer under activation
        checkpointing, and each wkv chunk inside it, as the JAX package."""
        cfg = self.cfg
        S = tokens.shape[1]
        h = params["embed"][tokens].to(torch.bfloat16)
        lay = {k: v.unbind(0) for k, v in params["layers"].items()}
        wkv, sh_t, sh_c = [], [], []
        for i in range(cfg.num_layers):
            pl = {k: v[i] for k, v in lay.items()}
            args = (pl, h, state["wkv"][i], state["shift_t"][i],
                    state["shift_c"][i], valid, last_pos)
            if remat:
                h, s_wkv, st, sc = checkpoint(
                    self._layer, *args, remat=True, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                h, s_wkv, st, sc = self._layer(*args)
            wkv.append(s_wkv)
            sh_t.append(st)
            sh_c.append(sc)
        added = S if valid is None else valid.sum(dim=1)
        new_state = dict(state, wkv=torch.stack(wkv),
                         shift_t=torch.stack(sh_t), shift_c=torch.stack(sh_c),
                         length=(state["length"] + added).to(torch.int32))
        return rmsnorm(h, params["final_norm"], cfg.norm_eps), new_state

    def forward(self, params, batch, coopt: CoOptConfig = COOPT):
        """Teacher-forced logits (B,S,V) for training, from a zero state
        (discarded), each layer under activation checkpointing. Returns
        (logits, {})."""
        tokens = batch["tokens"]
        state = self.init_cache(tokens.shape[0], 0, coopt,
                                device=tokens.device)
        h, _ = self._run(params, tokens, state, remat=True)
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
        """Prompt prefill / chunked continuation (the engine's ragged step
        path): the state in ``cache`` is the state after the previous chunk
        and threads straight through; the paged-cache plumbing (positions,
        slots, page table, ``long_window``) is accepted and ignored.
        ``batch["pad_mask"]`` (B,S) marks the real columns and
        ``batch["last_pos"]`` (B,) each lane's last one. Returns (last-token
        logits (B,V), cache)."""
        valid = batch.get("pad_mask")
        if valid is not None:
            valid = valid.bool()
        last_pos = batch.get("last_pos")
        h, cache = self._run(params, batch["tokens"], cache, valid, last_pos)
        if "cache_len" in batch:
            cache["length"] = batch["cache_len"].to(torch.int32)
        h_last = h[:, -1] if last_pos is None else _take(h, last_pos)[:, 0]
        return linear(h_last, params["lm_head"]), cache

    def decode_step(self, params, batch, cache, coopt: CoOptConfig = COOPT,
                    long_window: int = 0):
        """ONE token (B,1) through the O(1) state update."""
        h, cache = self._run(params, batch["token"], cache)
        return linear(h[:, 0], params["lm_head"]), cache

    # ------------------------------------------------------------- caching --
    def cache_shape(self, batch: int, max_len: int, coopt: CoOptConfig,
                    num_shards: int = 1, cache_cfg=None):
        """Leaf -> (shape, dtype, logical axes). Attention-free: no paged KV
        pool, so ``max_len``, ``num_shards`` and ``cache_cfg`` size nothing
        here."""
        cfg = self.cfg
        L, d, H, D = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim
        return {
            "wkv": ((L, batch, H, D, D), torch.float32,
                    ("layers", "batch", "heads", None, None)),
            "shift_t": ((L, batch, 1, d), torch.bfloat16,
                        ("layers", "batch", None, "d_model")),
            "shift_c": ((L, batch, 1, d), torch.bfloat16,
                        ("layers", "batch", None, "d_model")),
            "length": ((batch,), torch.int32, ("batch",)),
        }

    def init_cache(self, batch: int, max_len: int, coopt: CoOptConfig,
                   num_shards: int = 1, cache_cfg=None, device="cuda",
                   shard_devices=None):
        """Zero state leaves on ``device``. rwkv6 has no pool, so
        ``num_shards`` and ``shard_devices`` change none of its leaves."""
        return alloc_cache(self.cache_shape(batch, max_len, coopt),
                           check_device(device), shard_devices)


def _take(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) at column ``pos[b]`` of each row -> (B,1,d)."""
    return torch.gather(x, 1, pos.long()[:, None, None].expand(
        -1, 1, x.shape[-1]))
