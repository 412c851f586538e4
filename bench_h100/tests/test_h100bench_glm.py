"""glm-4.7-flash's pieces of the benchmark at a tiny size on the CPU: its
reference (``reference/glm4_moe_lite.py``) against a hand-written float64
check, the router's bias that picks but does not weigh, a tiny cell of the
port's reduced glm-4.7-flash through the whole harness, and the
``moe.expert_slot_fill`` reader against the program's own counters, and
the reasoning mix of glm's cell."""
import json
import math

import numpy as np
import pytest
import torch

import tiny
from bench_h100.harness import RunView
from bench_h100.oracle import reference_module
from bench_h100.roofline import Shapes
from bench_h100 import traffic
from bench_h100.traffic import load_file

T = 7


def rnd(g, *shape, std=1.0):
    return torch.randn(shape, generator=g, dtype=torch.float64).float() * std


def rms(x, w, eps=1e-5):
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


def setup(E=4, k=2, bias_std=0.3):
    g = torch.Generator().manual_seed(2)
    d, H, Rq, R, dr, dn, dv, ff, fe, V = 16, 2, 6, 8, 4, 6, 5, 20, 6, 13
    hf = {"num_attention_heads": H, "qk_nope_head_dim": dn,
          "qk_rope_head_dim": dr, "kv_lora_rank": R, "v_head_dim": dv,
          "rms_norm_eps": 1e-5, "rope_theta": 50.0, "num_experts_per_tok": k,
          "moe_capacity_factor": 1.0, "norm_topk_prob": True,
          "routed_scaling_factor": 1.8}

    def attn(L):
        return {"ln1": 1 + rnd(g, L, d, std=.1), "ln2": 1 + rnd(g, L, d, std=.1),
                "wq_a": rnd(g, L, d, Rq, std=.3),
                "q_a_norm": 1 + rnd(g, L, Rq, std=.1),
                "wq_b": rnd(g, L, Rq, H * (dn + dr), std=.3),
                "w_dkv": rnd(g, L, d, R + dr, std=.3),
                "kv_norm": 1 + rnd(g, L, R, std=.1),
                "w_uk": rnd(g, L, R, H * dn, std=.3),
                "w_uv": rnd(g, L, R, H * dv, std=.3),
                "wo": rnd(g, L, H * dv, d, std=.3)}
    dense = dict(attn(1), wg=rnd(g, 1, d, ff, std=.3),
                 wu=rnd(g, 1, d, ff, std=.3), wd=rnd(g, 1, ff, d, std=.3))
    moe = dict(attn(1), wr=rnd(g, 1, d, E), wr_bias=rnd(g, 1, E, std=bias_std),
               wg_e=rnd(g, 1, E, d, fe, std=.3), wu_e=rnd(g, 1, E, d, fe, std=.3),
               wd_e=rnd(g, 1, E, fe, d, std=.3), wg_s=rnd(g, 1, d, fe, std=.3),
               wu_s=rnd(g, 1, d, fe, std=.3), wd_s=rnd(g, 1, fe, d, std=.3))
    params = {"embed": rnd(g, V, d), "segments": [dense, moe],
              "final_norm": 1 + rnd(g, d, std=.1), "lm_head": rnd(g, d, V)}
    return params, hf


def hand_glm(params, hf, tokens, groups):
    """One token and one head at a time in float64."""
    H, dn, dr = hf["num_attention_heads"], hf["qk_nope_head_dim"], \
        hf["qk_rope_head_dim"]
    R, dv, k = hf["kv_lora_rank"], hf["v_head_dim"], hf["num_experts_per_tok"]
    h = [params["embed"][t].double().numpy() for t in tokens]
    n = len(h)
    for seg in params["segments"]:
        p = {key: v[0].double().numpy() for key, v in seg.items()}
        x = [rms(hi, p["ln1"]) for hi in h]
        q = [(rms(xi @ p["wq_a"], p["q_a_norm"]) @ p["wq_b"]).reshape(
            H, dn + dr) for xi in x]
        ckv = [xi @ p["w_dkv"] for xi in x]
        c = [rms(ci[:R], p["kv_norm"]) for ci in ckv]
        kr = [rot(ci[R:], i, 50.0) for i, ci in enumerate(ckv)]
        new = []
        for t in range(n):
            o = []
            for hh in range(H):
                s = []
                for j in range(t + 1):
                    qv = np.concatenate([q[t][hh, :dn],
                                         rot(q[t][hh, dn:], t, 50.0)])
                    kv = np.concatenate([(c[j] @ p["w_uk"]).reshape(H, dn)[hh],
                                         kr[j]])
                    s.append(qv @ kv / math.sqrt(dn + dr))
                s = np.array(s)
                w = np.exp(s - s.max())
                w /= w.sum()
                o.append(sum(w[j] * (c[j] @ p["w_uv"]).reshape(H, dv)[hh]
                             for j in range(t + 1)))
            new.append(h[t] + np.concatenate(o) @ p["wo"])
        h = new
        y = [rms(hi, p["ln2"]) for hi in h]
        if "wr" not in p:
            h = [hi + (silu(yi @ p["wg"]) * (yi @ p["wu"])) @ p["wd"]
                 for hi, yi in zip(h, y)]
            continue
        E = p["wr"].shape[1]
        routed = []
        for yi in y:
            sc = 1 / (1 + np.exp(-(yi @ p["wr"])))
            top = sorted(range(E), key=lambda e: (-(sc[e] + p["wr_bias"][e]),
                                                  e))[:k]
            routed.append((top, sc[top] / sc[top].sum() * 1.8))
        kept = [[True] * k for _ in range(n)]
        for start, m, S in groups:
            cap = min(max(math.ceil(S * k / E * hf["moe_capacity_factor"]),
                          1), S)
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
    return np.stack([rms(hi, fn) @ lm for hi in h])


@pytest.mark.parametrize("groups", [[], [(0, 5, 8), (5, 2, 4)], [(0, 7, 7)]])
def test_glm4_moe_lite_layers_against_a_hand_check(groups):
    params, hf = setup()
    tokens = torch.tensor([3, 1, 4, 1, 5, 9, 2])
    got = reference_module("glm4_moe_lite").logits(
        params, hf, tokens, torch.arange(T), groups).numpy()
    np.testing.assert_allclose(got, hand_glm(params, hf, tokens, groups),
                               rtol=1e-4, atol=1e-4)


def test_the_bias_picks_and_does_not_weigh():
    """The reference's router: the bias changes which experts a token
    takes; the weights of the experts it takes are their unbiased scores."""
    ref = reference_module("glm4_moe_lite")
    params, hf = setup(E=6, k=2)
    x = rnd(torch.Generator().manual_seed(5), 40, 16)
    wr = params["segments"][1]["wr"][0]
    bias = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.4])
    e0, w0, _ = ref.route(ref.F32(), x, wr, bias * 0, hf, [])
    e1, w1, _ = ref.route(ref.F32(), x, wr, bias, hf, [])
    assert (e1 == 5).any(dim=1).sum() > (e0 == 5).any(dim=1).sum()
    s = torch.sigmoid(x @ wr)
    for e, w in ((e0, w0), (e1, w1)):
        picked = torch.gather(s, 1, e)
        torch.testing.assert_close(w, picked / picked.sum(1, keepdim=True)
                                   * 1.8)


GLM = dict(tiny.MLA, arch="glm-4.7-flash-reduced", reference="glm4_moe_lite",
           rope_theta=1e6, q_lora_rank=96, v_head_dim=96,
           routed_scaling_factor=1.8, norm_topk_prob=True)


def glm_root(tmp_path):
    """The tiny checkout with a tiny cell of the reduced glm-4.7-flash, and
    ``moe.expert_slot_fill`` read in it and in the tiny MLA cell. The
    program's models are built afresh: ``get_model`` keeps one instance a
    config, and the fault tests patch theirs (``_write_layer``) in place."""
    from repro_torch.models.registry import get_model
    get_model.cache_clear()
    root = tiny.make_root(tmp_path)
    b = root / tiny.BENCH.name
    tiny.write(b / "configs" / "tiny-glm.json", GLM)
    tiny.write(b / "limits" / "tiny-glm-closed.json", tiny.LIMITS)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-glm", "source": "test",
                             "file": f"{b.name}/configs/tiny-glm.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": "tiny-glm-closed", "config": "tiny-glm",
                               "traffic": "tiny-closed", "chips": 1,
                               "why": "a CPU test"})
    for e in bench["per_layer"]:
        if e["name"] == "moe.expert_slot_fill":
            e["workloads"] = ["tiny-glm-closed", "tiny-mla-closed"]
    tiny.write(root / "BENCHMARK.json", bench)
    return root


@pytest.mark.parametrize("cell,hf", [("tiny-glm-closed", GLM),
                                     ("tiny-mla-closed", tiny.MLA)])
def test_slot_fill_reads_the_programs_counters(tmp_path, cell, hf):
    """A tiny traced cell runs through the harness with its exact checks
    met, reports ``moe.expert_slot_fill``, and the reader over all of the
    run's steps equals the program's ``EngineStats.moe_pairs /
    moe_slots``. (The tiny glm's contested gap is not held to the tiny
    cells' limit: with 4 experts of near-equal sigmoid scores, bf16
    rounding flips a token's experts as often as FP8 does, over seeds 1-8
    0.0003-0.113 against the FP8 control's 0.013-0.142.)"""
    root = glm_root(tmp_path)
    seen = {}
    out = tiny.run(root, cell, trace=True,
                   fault=lambda ae: seen.update(engine=ae.engine))
    checks = out.result["checks"]
    assert out.result["failed"] == 0 and out.result["attempted"] > 0
    assert checks["tokens_wrong_count"]["value"] == 0
    assert checks["chunks_wrong_count"]["value"] == 0
    if cell == "tiny-mla-closed":
        assert out.result["correct"], out.checks
    assert 0 < out.result["metrics"]["moe.expert_slot_fill"]["value"] < 100
    reader = load_file(root / tiny.BENCH.name / "metrics" /
                       "moe.expert_slot_fill.py", "_slot_fill_test")
    stats = seen["engine"].stats
    # the harness's recorder, in the closure of its wrapper of the build
    rec = next(c.cell_contents for c in seen["engine"]._build_step.__closure__
               if type(c.cell_contents).__name__ == "Recorder")
    whole = RunView(Shapes.of(hf), 16, rec, -math.inf, math.inf, {}, {})
    assert reader.read(whole) == pytest.approx(
        100.0 * stats.moe_pairs / stats.moe_slots, rel=1e-12)


def test_slot_fill_reads_nothing_without_experts(tmp_path):
    """No experts, or no configuration file with these widths: None."""
    from bench_h100.record import Recorder, StepRecord
    reader = load_file(tiny.BENCH / "metrics" / "moe.expert_slot_fill.py",
                       "_slot_fill_test")
    rec = Recorder()
    rec.steps.append(StepRecord(1.0, "decode", 32, 0, 32, 0, 32))
    for hf in (tiny.DENSE, tiny.MLA):
        view = RunView(Shapes.of(hf), 16, rec, 0.0, 2.0, {}, {})
        assert reader.read(view) is None
    hf = json.loads((tiny.BENCH / "configs" / "glm-4.7-flash.json").read_text())
    view = RunView(Shapes.of(hf), 64, rec, 0.0, 2.0, {}, {})
    assert reader.read(view) == pytest.approx(100 * 4 / 64)   # 6.25%


def test_the_reasoning_mix_is_short_questions_and_long_traces():
    """``reasoning-closed32``: 32 closed clients; every block of 32 holds
    the same prompt and output lengths, each block in one fixed order on
    every seed; prompts from 32 to 2048 tokens (median ~365), outputs from
    256 to 3072 (median ~990)."""
    from itertools import islice
    mix = traffic.load_mix("reasoning-closed32")
    assert mix["arrivals"] == {"kind": "closed", "clients": 32}
    assert mix["lead_in_s"] == 40.0

    def take(seed):
        return list(islice(traffic.requests(mix, 154880, seed), 96))
    a, b = take(2**31 + 77), take(2**33)
    shape = [(len(r.prompt), r.max_new) for r in a]
    assert shape == [(len(r.prompt), r.max_new) for r in b]
    for i in (0, 1):
        blocks = [sorted(x[i] for x in shape[j:j + 32]) for j in (0, 32, 64)]
        assert blocks[0] == blocks[1] == blocks[2]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    plens, outs = [p for p, _ in shape[:32]], [o for _, o in shape[:32]]
    assert 32 <= min(plens) and max(plens) <= 2048
    assert 256 <= min(outs) and max(outs) <= 3072
    assert 300 < np.median(plens) < 440 and 850 < np.median(outs) < 1150
