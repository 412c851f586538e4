"""A tiny checkout for CPU runs of the harness: the benchmark's folder
copied, with two configurations at the program's reduced sizes, small
mixes, cells and limits."""
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

ENGINE = {"num_lanes": 4, "max_len": 256, "prefill_buckets": [16, 32, 64],
          "token_budget": 64, "page_size": 16, "pack_prefill": False,
          "mode": "coopt", "use_kernel": True, "pipeline_depth": 2}
DENSE = {"hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 512, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
         "qkv_bias": True, "arch": "qwen2.5-14b-reduced",
         "reference": "qwen2", "engine": ENGINE}
MLA = {"hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 512,
       "rope_theta": 10000, "rms_norm_eps": 1e-5, "kv_lora_rank": 64,
       "qk_nope_head_dim": 64, "qk_rope_head_dim": 32, "v_head_dim": 64,
       "n_routed_experts": 4, "num_experts_per_tok": 2,
       "moe_intermediate_size": 128, "n_shared_experts": 1,
       "first_k_dense_replace": 1, "moe_capacity_factor": 1.25,
       "arch": "deepseek-v2-lite-16b-reduced", "reference": "deepseek_v2",
       "engine": ENGINE}
SMALL = {"kind": "sharegpt", "block": 8, "prompt_log_mean": 3.0,
         "prompt_log_std": 0.8, "min_prompt": 4, "max_prompt": 100,
         "output_log_mean": 2.0, "output_log_std": 0.6, "min_output": 2,
         "max_output": 24}
# limits of the tiny cells, from CPU readings at this size (seeds 1-6 of
# each cell): the program's contested mean squared gap 0-0.0028
LIMITS = {"contested_gap_ms": {"limit": 0.01},
          "tokens_wrong_count": {"limit": 0},
          "chunks_wrong_count": {"limit": 0}}


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj))


def make_root(root: Path) -> Path:
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__", "tests"))
    b = root / BENCH.name
    write(b / "configs" / "tiny-dense.json", DENSE)
    write(b / "configs" / "tiny-mla.json", MLA)
    write(b / "traffic" / "tiny-poisson.json", {
        "arrivals": {"kind": "poisson", "rate_per_s": 4.0},
        "requests": SMALL, "lead_in_s": 1.0})
    write(b / "traffic" / "tiny-closed.json", {
        "arrivals": {"kind": "closed", "clients": 4}, "requests": SMALL,
        "lead_in_s": 1.0})
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": n, "source": "test", "file": f"{b.name}/configs/{n}.json",
         "reduced": [], "why": "a CPU test"} for n in ("tiny-dense",
                                                         "tiny-mla")]
    bench["workloads"] = [
        {"name": "tiny-dense-poisson", "config": "tiny-dense",
         "traffic": "tiny-poisson", "chips": 1, "why": "a CPU test"},
        {"name": "tiny-mla-closed", "config": "tiny-mla",
         "traffic": "tiny-closed", "chips": 1, "why": "a CPU test"}]
    for w in bench["workloads"]:
        write(b / "limits" / f"{w['name']}.json", LIMITS)
    for e in bench["end_to_end"] + bench["per_layer"]:  # as in the real
        if "workloads" in e:                    # file: the open loop alone
            e["workloads"] = ["tiny-dense-poisson"]
    write(root / "BENCHMARK.json", bench)
    return root


def run(root: Path, cell: str, seed: int = 3, trace: bool = False, **kw):
    import time

    import torch
    from bench_h100.harness import run_cell
    torch.set_num_threads(2)
    return run_cell(root, cell, seed, 2.5, trace, time.perf_counter(),
                    device="cpu", **kw)
