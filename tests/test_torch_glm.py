"""glm-4.7-flash, the port's own architecture (the JAX package has none):
its config against the benchmark's configuration file, the sigmoid router
with its correction bias, the reduced model served by ``Engine`` (prefill,
then decode through the FP8 latent cache) against the benchmark's plain
float32 reference, and the MoE slot counters of ``EngineStats``. No JAX:
the reference is ``bench_h100/reference/glm4_moe_lite.py``."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench_h100.reference import glm4_moe_lite  # noqa: E402
from bench_h100.reference.common import F32  # noqa: E402
from repro_torch.configs import (ALL_IDS, PORT_IDS, get_config,  # noqa: E402
                                 reduced)
from repro_torch.configs.base import PORT_ONLY_FIELDS  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.moe import _route, capacity  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "glm-4.7-flash-reduced"
CFG = get_config(ARCH)
# E / top_k: every expert has a slot for every token of a row, so no token
# is dropped and the reference routes without capacity groups
NO_DROPS = CFG.num_experts / CFG.top_k
# The FP8 latent pages round c_kv and k_rope to e4m3 (3 mantissa bits, a
# relative step of 2^-4), which moves this 2-layer model's logits (|l| < 5)
# by ~0.2 at every served position (0.04 with bf16 pages); where that flips
# a token's expert at a near tie, one position moves by up to ~1.5. So the
# FP8 path holds the mean over positions of the widest gap, and bf16 pages
# hold the widest gap itself: a few bf16 ulps of activations and weights
# (2^-6 at these logits) through two layers. Measured: FP8 mean 0.21, bf16
# widest 0.067; a softmax router, no bias, no scaling or a full-rank query
# read a mean of 0.74 or more.
FP8_MEAN_GAP = 0.4
BF16_MAX_GAP = 0.1
# the reduced router's correction bias: wide enough against the sigmoid
# scores' spread (~0.2) that it changes the choice of many tokens
BIAS = [0.3, -0.3, 0.15, -0.15]


def test_config_is_the_benchmark_files():
    """The port's glm-4.7-flash has the published widths, the low-rank
    query and the router that the benchmark's configuration file states."""
    hf = json.loads((ROOT / "bench_h100" / "configs" /
                     "glm-4.7-flash.json").read_text())
    cfg = get_config(hf["arch"])
    pairs = {"num_hidden_layers": cfg.num_layers,
             "hidden_size": cfg.d_model,
             "num_attention_heads": cfg.num_heads,
             "num_key_value_heads": cfg.num_kv_heads,
             "intermediate_size": cfg.d_ff,
             "moe_intermediate_size": cfg.moe_d_ff,
             "n_routed_experts": cfg.num_experts,
             "n_shared_experts": cfg.num_shared_experts,
             "num_experts_per_tok": cfg.top_k,
             "first_k_dense_replace": cfg.first_dense_layers,
             "q_lora_rank": cfg.q_lora_rank,
             "kv_lora_rank": cfg.kv_lora_rank,
             "qk_nope_head_dim": cfg.qk_nope_head_dim,
             "qk_rope_head_dim": cfg.qk_rope_head_dim,
             "v_head_dim": cfg.v_head_dim, "vocab_size": cfg.vocab_size,
             "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
             "routed_scaling_factor": cfg.routed_scaling,
             "tie_word_embeddings": cfg.tie_embeddings}
    assert {k: hf[k] for k in pairs} == pairs
    assert hf["topk_method"] == "noaux_tc" and hf["norm_topk_prob"]
    assert (hf["n_group"], hf["topk_group"]) == (1, 1)
    assert (cfg.family, cfg.router_score) == ("mla", "sigmoid")
    assert get_model(cfg).param_shapes()["segments"][1]["wr_bias"][0] == \
        (46, 64)
    # 29.94 B parameters: 59.9 GB in bf16
    assert 59.8e9 < 2 * cfg.param_count() < 60.0e9


def test_port_only_registry():
    """glm-4.7-flash is found by ``get_config`` but stays out of the JAX
    lists; its reduced form cuts the query's rank and keeps v apart from
    the query's width; every other config holds the router at the JAX
    package's defaults."""
    assert PORT_IDS == ["glm-4.7-flash"] and "glm-4.7-flash" not in ALL_IDS
    assert (CFG.q_lora_rank, CFG.qk_nope_head_dim, CFG.v_head_dim) == \
        (96, 64, 96)
    assert reduced(get_config("deepseek-v2-lite-16b")).q_lora_rank == 0
    for arch in ALL_IDS:
        cfg = get_config(arch)
        assert {k: getattr(cfg, k) for k in PORT_ONLY_FIELDS} == \
            PORT_ONLY_FIELDS


def test_route_bias_picks_but_does_not_weigh():
    """Sigmoid routing: the bias moves the choice to expert 3, the weights
    stay the chosen experts' unbiased scores, renormalised, times the
    scaling; ties of score + bias go to the lower index."""
    logits = torch.tensor([[[2.0, 1.0, 0.5, 0.0],
                            [0.0, 0.0, 0.0, 0.0]]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.5])
    p = torch.sigmoid(logits[0, 0])
    idx0, comb0 = _route(logits, 2, 2, score="sigmoid", scaling=1.8)
    idx1, comb1 = _route(logits, 2, 2, score="sigmoid", bias=bias,
                         scaling=1.8)
    # without the bias token 0 takes experts 0 and 1, with it 0 and 3
    assert idx0[0, :, 0].tolist() == [0, 0, 2, 2]
    assert idx1[0, :, 0].tolist() == [0, 2, 2, 0]
    w0 = p[[0, 1]] / p[[0, 1]].sum() * 1.8
    w1 = p[[0, 3]] / p[[0, 3]].sum() * 1.8
    torch.testing.assert_close(comb0[0, [0, 1], 0], w0, rtol=0, atol=0)
    torch.testing.assert_close(comb1[0, [0, 3], 0], w1, rtol=0, atol=0)
    # token 1: every score 0.5; the bias alone decides (3, then 0), the
    # weights are equal halves of 1.8 either way
    assert idx1[0, 3, 1] == 1 and idx1[0, 0, 1] == 1
    torch.testing.assert_close(comb1[0, [0, 3], 1], torch.tensor([.9, .9]))
    assert idx0[0, 0, 1] == 1 and idx0[0, 1, 1] == 1


def test_softmax_route_is_unchanged():
    """The default scoring is the softmax route, renormalised top-k, with
    no scaling: the same bits as written out here."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((2, 9, 6), generator=g)
    idx, comb = _route(logits, 2, 9)
    pr = torch.softmax(logits, -1)
    top_p, top_e = torch.sort(pr, dim=-1, descending=True, stable=True)
    w = top_p[..., :2] / top_p[..., :2].sum(-1, keepdim=True)
    for b in range(2):
        for s in range(9):
            for j in range(2):
                e = top_e[b, s, j]
                slot = (idx[b, e] == s).nonzero()[0, 0]
                assert comb[b, e, slot] == w[b, s, j]


def _params(cfg, seed=0):
    """The reduced model's weights, norm scales around 1 and the router
    bias of ``BIAS``."""
    params = get_model(cfg).init(seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for seg in params["segments"]:
        for k in ("ln1", "ln2", "kv_norm", "q_a_norm"):
            if k in seg:
                seg[k] = 1 + 0.1 * torch.randn(seg[k].shape, generator=g)
    params["segments"][1]["wr_bias"] = torch.tensor([BIAS])
    return params


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in (45, 20)]


def _served(cfg, params, mode="coopt", max_new=16):
    """Each request's (served token, its logits row), served by the sync
    engine: a 45-token prompt in two chunks beside a 20-token one, then
    decode steps."""
    co = MODES[mode].replace(use_kernel=True, moe_capacity_factor=NO_DROPS)
    eng = Engine(cfg, co, EngineConfig(num_lanes=2, max_len=128,
                                       prefill_buckets=(16, 32),
                                       token_budget=32),
                 params=params, device="cpu")
    log, last = {}, {}
    sample, emit = eng._sample, eng._emit

    def _sample(logits):
        last["logits"] = logits.float().numpy()
        return sample(logits)

    def _emit(req, tok, now, first):
        log.setdefault(req.req_id, []).append((tok, last["logits"][req.lane]))
        return emit(req, tok, now, first=first)
    eng._sample, eng._emit = _sample, _emit
    eng.generate(_prompts(), max_new_tokens=max_new)
    return [log[r] for r in sorted(log)]


def _gaps(served, params):
    """The widest |logit| gap to the reference's full forward over the
    prompt and served tokens, at each served position."""
    hf = {"num_attention_heads": CFG.num_heads,
          "qk_nope_head_dim": CFG.qk_nope_head_dim,
          "qk_rope_head_dim": CFG.qk_rope_head_dim,
          "kv_lora_rank": CFG.kv_lora_rank, "v_head_dim": CFG.v_head_dim,
          "rms_norm_eps": CFG.norm_eps, "rope_theta": CFG.rope_theta,
          "num_experts_per_tok": CFG.top_k, "moe_capacity_factor": NO_DROPS,
          "norm_topk_prob": True, "routed_scaling_factor": 1.8}
    out = []
    for prompt, toks in zip(_prompts(), served):
        seq = np.concatenate([prompt, [t for t, _ in toks[:-1]]])
        want = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(toks))
        with torch.no_grad():
            ref = glm4_moe_lite.logits(params, hf, torch.as_tensor(
                seq, dtype=torch.long), want, [], F32()).numpy()
        got = np.stack([row for _, row in toks])
        out.append(np.abs(got - ref).max(axis=1))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def params():
    return _params(CFG)


@pytest.mark.parametrize("mode", ["coopt", "opt-gqa"])
def test_engine_logits_match_the_reference(params, mode):
    """Prefill (chunked) and decode through the pool, FP8 latent pages
    (coopt) and bf16 ones (opt-gqa), against the reference's full forward
    at every served position (tolerances at FP8_MEAN_GAP)."""
    gaps = _gaps(_served(CFG, params, mode), params)
    assert gaps.size == 32
    if mode == "coopt":
        assert gaps.mean() < FP8_MEAN_GAP, gaps
    else:
        assert gaps.max() < BF16_MAX_GAP, gaps


def _full_rank(cfg, params):
    """A full-rank query in the low-rank one's place: wq = W_qa W_qb, the
    query's RMSNorm left out."""
    segs = []
    for seg in params["segments"]:
        seg = dict(seg)
        seg["wq"] = (seg.pop("wq_a").float() @ seg.pop("wq_b").float()
                     ).to(torch.bfloat16)
        seg.pop("q_a_norm")
        segs.append(seg)
    return cfg.replace(q_lora_rank=0), dict(params, segments=segs)


def _no_bias(cfg, params):
    seg = {k: v for k, v in params["segments"][1].items() if k != "wr_bias"}
    return cfg, dict(params, segments=[params["segments"][0], seg])


MUTATIONS = {
    "softmax_router": lambda c, p: (c.replace(router_score="softmax"), p),
    "no_bias": _no_bias,
    "no_scaling": lambda c, p: (c.replace(routed_scaling=1.0), p),
    "full_rank_query": _full_rank,
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_the_comparison_sees_each_mechanism(params, mutation):
    """A port without one of the model's mechanisms fails the FP8 path's
    comparison with the reference."""
    cfg, p = MUTATIONS[mutation](CFG, params)
    gaps = _gaps(_served(cfg, p), params)
    assert gaps.mean() > 1.5 * FP8_MEAN_GAP, gaps.mean()


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-lite-16b-reduced",
                                  "qwen3-4b-reduced"])
def test_moe_slot_counters(arch):
    """``EngineStats.moe_slots`` / ``moe_pairs`` over a prefill step, a
    mixed step and a decode step of 4 lanes: each MoE layer computes B x E
    x C(S) slots, C the capacity at the step's row width S (32, 16, 1),
    for the real tokens x top_k pairs (20, 10 + 1, 2 tokens)."""
    cfg = get_config(arch)
    co = MODES["coopt"].replace(use_kernel=True)
    eng = Engine(cfg, co, EngineConfig(num_lanes=4, max_len=128,
                                       prefill_buckets=(16, 32, 64),
                                       token_budget=64), device="cpu")
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(1)

    def add(i, n):
        eng.add_request(Request(req_id=i, max_new_tokens=4, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32)))
    E, k = cfg.num_experts, cfg.top_k
    layers = cfg.num_layers - cfg.first_dense_layers if E else 0
    add(0, 20)
    seen = []
    for S, tokens, later in ((32, 20, (1, 10)), (16, 11, None), (1, 2, None)):
        before = (eng.stats.moe_slots, eng.stats.moe_pairs)
        eng.step()
        if later:
            add(*later)
        cap = capacity(S, k, E, co.moe_capacity_factor) if E else 0
        seen.append((eng.stats.moe_slots - before[0],
                     eng.stats.moe_pairs - before[1]))
        assert seen[-1] == (layers * 4 * E * cap, layers * tokens * k)
    if E:
        assert seen[-1] == (layers * 4 * E, layers * 2 * k)
        assert math.isclose(seen[-1][1] / seen[-1][0], k / (2 * E))
    assert eng.stats.mixed_steps == 1 and eng.stats.decode_steps == 2
