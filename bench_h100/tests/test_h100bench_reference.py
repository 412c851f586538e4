"""The references against an independent hand-written check, one token and
one head at a time in float64, at a tiny size; and the MoE capacity rule."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_h100.oracle import reference_module, rows_of
from bench_h100.reference.common import FP8

T = 7


def rnd(g, *shape, std=1.0):
    return torch.randn(shape, generator=g, dtype=torch.float64).float() * std


def rms(x, w, eps):
    return x / np.sqrt((x * x).mean() + eps) * w


def rot(x, p, theta):
    d = len(x)
    out = x.copy()
    for i in range(d // 2):
        a = p * theta ** (-2 * i / d)
        out[i] = x[i] * math.cos(a) - x[i + d // 2] * math.sin(a)
        out[i + d // 2] = x[i + d // 2] * math.cos(a) + x[i] * math.sin(a)
    return out


def silu(x):
    return x / (1 + np.exp(-x))


def attend(qs, ks, vs, t, scale):
    s = np.array([qs[t] @ ks[j] * scale for j in range(t + 1)])
    p = np.exp(s - s.max())
    p /= p.sum()
    return sum(p[j] * vs[j] for j in range(t + 1))


def test_qwen2_layer_against_a_hand_check():
    g = torch.Generator().manual_seed(0)
    d, H, Hkv, D, ff, V = 16, 4, 2, 4, 24, 11
    hf = {"hidden_size": d, "num_attention_heads": H, "num_key_value_heads":
          Hkv, "rms_norm_eps": 1e-5, "rope_theta": 100.0}
    L = {"ln1": 1 + rnd(g, 1, d, std=.1), "ln2": 1 + rnd(g, 1, d, std=.1),
         "wq": rnd(g, 1, d, H * D, std=.3), "wk": rnd(g, 1, d, Hkv * D, std=.3),
         "wv": rnd(g, 1, d, Hkv * D, std=.3), "bq": rnd(g, 1, H * D),
         "bk": rnd(g, 1, Hkv * D), "bv": rnd(g, 1, Hkv * D),
         "wo": rnd(g, 1, H * D, d, std=.3), "wg": rnd(g, 1, d, ff, std=.3),
         "wu": rnd(g, 1, d, ff, std=.3), "wd": rnd(g, 1, ff, d, std=.3)}
    params = {"embed": rnd(g, V, d), "segments": [L],
              "final_norm": 1 + rnd(g, d, std=.1), "lm_head": rnd(g, d, V)}
    tokens = torch.tensor([3, 1, 4, 1, 5, 9, 2])
    want = torch.tensor([2, 6])
    got = reference_module("qwen2").logits(params, hf, tokens, want).numpy()

    n = {k: v[0].double().numpy() for k, v in L.items()}
    h = [params["embed"][t].double().numpy() for t in tokens]
    x = [rms(hi, n["ln1"], 1e-5) for hi in h]
    q = [(xi @ n["wq"] + n["bq"]).reshape(H, D) for xi in x]
    k = [(xi @ n["wk"] + n["bk"]).reshape(Hkv, D) for xi in x]
    v = [(xi @ n["wv"] + n["bv"]).reshape(Hkv, D) for xi in x]
    out = []
    for t in range(T):
        o = []
        for hq in range(H):
            kv = hq // (H // Hkv)
            o.append(attend([rot(q[i][hq], i, 100.0) for i in range(T)],
                            [rot(k[i][kv], i, 100.0) for i in range(T)],
                            [v[i][kv] for i in range(T)], t, 1 / math.sqrt(D)))
        a = h[t] + np.concatenate(o) @ n["wo"]
        y = rms(a, n["ln2"], 1e-5)
        out.append(a + (silu(y @ n["wg"]) * (y @ n["wu"])) @ n["wd"])
    fn = params["final_norm"].double().numpy()
    lm = params["lm_head"].double().numpy()
    want_ref = np.stack([rms(out[t], fn, 1e-5) @ lm for t in (2, 6)])
    np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=1e-4)


def mla_setup(E=4, k=2):
    g = torch.Generator().manual_seed(1)
    d, H, R, dr, dn, dv, ff, fe, V = 16, 2, 8, 4, 6, 5, 20, 6, 13
    hf = {"num_attention_heads": H, "qk_nope_head_dim": dn,
          "qk_rope_head_dim": dr, "kv_lora_rank": R, "v_head_dim": dv,
          "rms_norm_eps": 1e-5, "rope_theta": 50.0,
          "num_experts_per_tok": k, "moe_capacity_factor": 1.0}

    def attn(L):
        return {"ln1": 1 + rnd(g, L, d, std=.1), "ln2": 1 + rnd(g, L, d, std=.1),
                "wq": rnd(g, L, d, H * (dn + dr), std=.3),
                "w_dkv": rnd(g, L, d, R + dr, std=.3),
                "kv_norm": 1 + rnd(g, L, R, std=.1),
                "w_uk": rnd(g, L, R, H * dn, std=.3),
                "w_uv": rnd(g, L, R, H * dv, std=.3),
                "wo": rnd(g, L, H * dv, d, std=.3)}
    dense = dict(attn(1), wg=rnd(g, 1, d, ff, std=.3), wu=rnd(g, 1, d, ff,
                 std=.3), wd=rnd(g, 1, ff, d, std=.3))
    moe = dict(attn(1), wr=rnd(g, 1, d, E), wg_e=rnd(g, 1, E, d, fe, std=.3),
               wu_e=rnd(g, 1, E, d, fe, std=.3),
               wd_e=rnd(g, 1, E, fe, d, std=.3),
               wg_s=rnd(g, 1, d, fe, std=.3), wu_s=rnd(g, 1, d, fe, std=.3),
               wd_s=rnd(g, 1, fe, d, std=.3))
    params = {"embed": rnd(g, V, d), "segments": [dense, moe],
              "final_norm": 1 + rnd(g, d, std=.1), "lm_head": rnd(g, d, V)}
    return params, hf


def hand_mla(params, hf, tokens, groups):
    H, dn, dr = hf["num_attention_heads"], hf["qk_nope_head_dim"], \
        hf["qk_rope_head_dim"]
    R, dv, k = hf["kv_lora_rank"], hf["v_head_dim"], hf["num_experts_per_tok"]
    h = [params["embed"][t].double().numpy() for t in tokens]
    n = len(h)
    for seg in params["segments"]:
        p = {key: v[0].double().numpy() for key, v in seg.items()}
        x = [rms(hi, p["ln1"], 1e-5) for hi in h]
        q = [(xi @ p["wq"]).reshape(H, dn + dr) for xi in x]
        ckv = [xi @ p["w_dkv"] for xi in x]
        c = [rms(ci[:R], p["kv_norm"], 1e-5) for ci in ckv]
        kr = [rot(ci[R:], i, 50.0) for i, ci in enumerate(ckv)]
        new = []
        for t in range(n):
            o = []
            for hh in range(H):
                qs = [np.concatenate([q[i][hh, :dn], rot(q[i][hh, dn:], i, 50.0)])
                      for i in range(n)]
                ks = [np.concatenate([(c[i] @ p["w_uk"]).reshape(H, dn)[hh],
                                      kr[i]]) for i in range(n)]
                vs = [(c[i] @ p["w_uv"]).reshape(H, dv)[hh] for i in range(n)]
                o.append(attend(qs, ks, vs, t, 1 / math.sqrt(dn + dr)))
            new.append(h[t] + np.concatenate(o) @ p["wo"])
        h = new
        y = [rms(hi, p["ln2"], 1e-5) for hi in h]
        if "wr" not in p:
            h = [hi + (silu(yi @ p["wg"]) * (yi @ p["wu"])) @ p["wd"]
                 for hi, yi in zip(h, y)]
            continue
        E = p["wr"].shape[1]
        routed = []
        for yi in y:
            lg = yi @ p["wr"]
            pr = np.exp(lg - lg.max())
            pr /= pr.sum()
            top = sorted(range(E), key=lambda e: (-pr[e], e))[:k]
            w = pr[top] / pr[top].sum()
            routed.append((top, w))
        kept = [[True] * k for _ in range(n)]
        for start, m, S in groups:
            cap = min(max(math.ceil(S * k / E * hf["moe_capacity_factor"]), 1),
                      S)
            seen = [0] * E
            for t in range(start, start + m):
                for j, e in enumerate(routed[t][0]):
                    kept[t][j] = seen[e] < cap
                    seen[e] += 1
        out = []
        for t in range(n):
            acc = (silu(y[t] @ p["wg_s"]) * (y[t] @ p["wu_s"])) @ p["wd_s"]
            for j, e in enumerate(routed[t][0]):
                if kept[t][j]:
                    acc = acc + routed[t][1][j] * (
                        (silu(y[t] @ p["wg_e"][e]) * (y[t] @ p["wu_e"][e]))
                        @ p["wd_e"][e])
            out.append(h[t] + acc)
        h = out
    fn = params["final_norm"].double().numpy()
    lm = params["lm_head"].double().numpy()
    return np.stack([rms(hi, fn, 1e-5) @ lm for hi in h])


@pytest.mark.parametrize("groups", [[], [(0, 5, 8), (5, 2, 4)], [(0, 7, 7)]])
def test_deepseek_v2_layers_against_a_hand_check(groups):
    params, hf = mla_setup()
    tokens = torch.tensor([3, 1, 4, 1, 5, 9, 2])
    got = reference_module("deepseek_v2").logits(
        params, hf, tokens, torch.arange(T), groups).numpy()
    np.testing.assert_allclose(got, hand_mla(params, hf, tokens, groups),
                               rtol=1e-4, atol=1e-4)


def test_capacity_drops_the_late_tokens_of_a_full_expert():
    params, hf = mla_setup(E=2, k=1)
    tokens = torch.tensor([3, 1, 4, 1, 5, 9, 2])
    ref = reference_module("deepseek_v2")
    # capacity min(ceil(7 * 1 / 2 * 1.0), 7) = 4 of 7: some token drops
    tight = ref.logits(params, hf, tokens, torch.arange(T), [(0, 7, 7)])
    loose = ref.logits(params, hf, tokens, torch.arange(T), [])
    assert not torch.allclose(tight, loose)
    np.testing.assert_allclose(tight.numpy(),
                               hand_mla(params, hf, tokens, [(0, 7, 7)]),
                               rtol=1e-4, atol=1e-4)


def test_fp8_control_moves_the_logits():
    params, hf = mla_setup()
    tokens = torch.tensor([3, 1, 4, 1, 5, 9, 2])
    ref = reference_module("deepseek_v2")
    a = ref.logits(params, hf, tokens, torch.arange(T), [])
    b = ref.logits(params, hf, tokens, torch.arange(T), [], FP8())
    assert 1e-3 < (a - b).abs().max() < 1.0


ENGINE = {"prefill_buckets": [64, 128, 256, 512], "token_budget": 512}


def served(prompt_len, n_tokens):
    return SimpleNamespace(prompt=np.zeros(prompt_len), tokens=[0] * n_tokens)


def test_the_last_admission_layout_holds():
    # each row as wide as the smallest bucket holding its step's longest
    # chunk, worked out from the configuration
    assert rows_of([(0, 64, 64), (64, 30, 100)], served(94, 5), ENGINE) == \
        [(0, 64, 64), (64, 30, 128)]
    # preempted after two chunks, recomputed from 0 in one (the prompt and
    # two served tokens)
    assert rows_of([(0, 64, 64), (64, 30, 30), (0, 96, 96)], served(94, 5),
                   ENGINE) == [(0, 96, 128)]


@pytest.mark.parametrize("layout", [
    [(0, 64, 64), (65, 29, 29)],            # a token left out
    [(0, 64, 64), (60, 34, 34)],            # a token run twice
    [(0, 64, 64)],                          # the prompt's end never run
    [(0, 600, 600)],                        # over the token budget
    [(0, 94, 94), (94, 0, 94)],             # an empty chunk
    None])                                  # never prefilled
def test_chunks_that_miss_the_prompt_are_wrong(layout):
    assert rows_of(layout, served(94, 5), ENGINE) is None
