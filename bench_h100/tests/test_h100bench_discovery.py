"""A new configuration, mix or per-layer metric is a file and an entry in
BENCHMARK.json: the harness finds each by its name, with no other edit."""
import json

import pytest

import tiny


def test_new_config_mix_and_metric_run_with_no_other_edit(tmp_path):
    root = tiny.make_root(tmp_path)
    b = root / tiny.BENCH.name
    # another model of the dense family, through the same reference
    tiny.write(b / "configs" / "tiny-new.json",
               dict(tiny.DENSE, arch="yi-34b-reduced", qkv_bias=False,
                    rope_theta=5e6))
    tiny.write(b / "traffic" / "tiny-new-mix.json", {
        "arrivals": {"kind": "closed", "clients": 3},
        "requests": dict(tiny.SMALL, block=4), "lead_in_s": 0.5})
    (b / "metrics" / "host.steps_per_s.py").write_text(
        "def read(run):\n"
        "    return len(run.window_steps()) / (run.w1 - run.w0)\n")
    tiny.write(b / "limits" / "tiny-new-cell.json", tiny.LIMITS)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-new", "source": "test",
                             "file": f"{b.name}/configs/tiny-new.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": "tiny-new-cell", "config": "tiny-new",
                               "traffic": "tiny-new-mix", "chips": 1,
                               "why": "a CPU test"})
    bench["per_layer"].append({
        "name": "host.steps_per_s", "unit": "1/s", "better": "higher",
        "source": "program_counter", "layer": "engine step",
        "moves": "output_tok_s"})
    tiny.write(root / "BENCHMARK.json", bench)

    out = tiny.run(root, "tiny-new-cell", trace=True)
    assert out.result["correct"], out.checks
    assert out.result["metrics"]["host.steps_per_s"]["value"] > 0
    # a metric with no cells listed is read in every cell
    out = tiny.run(root, "tiny-dense-poisson", trace=True)
    assert out.result["metrics"]["host.steps_per_s"]["value"] > 0
    assert out.result["correct"], out.checks


def test_a_metric_listed_for_some_cells_is_read_there_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    listed = tiny.run(root, "tiny-dense-poisson", trace=True).result["metrics"]
    other = tiny.run(root, "tiny-mla-closed", trace=True).result["metrics"]
    assert "sched.prefix_hit_rate" in listed
    assert "sched.prefix_hit_rate" not in other and "frontend.dispatch_ms" in other


E2E = {"output_tok_s", "tpot_p90_ms", "setup_s"}


@pytest.mark.parametrize("cell,metrics", [
    ("tiny-mla-closed", E2E),
    ("tiny-dense-poisson", E2E | {"ttft_p90_ms"})])   # listed for it alone
def test_end_to_end_line(tmp_path, cell, metrics):
    root = tiny.make_root(tmp_path)
    out = tiny.run(root, cell)
    r = out.result
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == metrics
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r["checks"]) == ["contested_gap_ms", "tokens_wrong_count",
                                 "chunks_wrong_count"]
    assert out.checks[-1].startswith("check chunks_wrong_count")


def test_unshared_prompts_bypass_the_prefix_cache(tmp_path):
    root = tiny.make_root(tmp_path)
    out = tiny.run(root, "tiny-dense-poisson", trace=True)
    assert out.result["metrics"]["sched.prefix_hit_rate"]["value"] == 0
