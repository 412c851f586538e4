"""The port's serving launcher (``repro_torch.launch.serve``) against the JAX
package's on qwen3-4b-reduced: Poisson offsets, the report of
``serve_workload`` sync (key sets, counts and rates; the async and async +
packing cases are in ``tests/test_torch_serve_async.py``, so the two
longest cases run in separate workers of a ``--dist loadfile`` run),
``--assert-aot``, the host-DRAM tier, and ``main``'s JSON on the CPU (the
sharded workloads, with and without a mesh, are in
``tests/test_torch_serve_sharded.py``, so they run in a worker of their
own under ``--dist loadfile``).

The port runs on the JAX engine's weights (``params_from_numpy`` of
``init(PRNGKey(seed))``, which the JAX ``ServeRunner`` draws), with its
kernel wrappers (their plain versions on CPU tensors). Times differ by
nature; every count and rate that does not depend on the clock must be
equal."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import serving_warmup  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "qwen3-4b-reduced"
# a greedy parting at a near-tie (tests/test_torch_engine.py)
NEAR_TIE = 0.1
# 8 ShareGPT requests at scale 0.25 on 4 lanes over 7 usable pages: the
# warmup pass leaves prompt pages cached, so the measured pass prefix-hits
# (and places prefix-affine), the pool preempts, and packing saves rows
KW = dict(requests=8, num_lanes=4, max_len=192, max_new_tokens=24,
          scale=0.25, warmup_pass=True, pool_pages=8)
CASES = {"sync": {}, "async": dict(use_async=True),
         "async_pack": dict(use_async=True, pack=True)}
# counts and rates equal to the JAX report's; the others are times (or
# derived from them) or the port's warmup record
EQUAL = ("generated_tokens", "packed_steps", "packed_rows_saved",
         "prefix_hit_rate", "prefix_device_hit_rate", "prefix_host_hit_rate",
         "preemptions", "rejected", "pool_pages", "peak_pool_utilization",
         "prefix_device_hits", "prefix_host_hits", "prefix_misses",
         "shared_page_visits", "dup_page_streams_saved", "shed",
         "deadline_shed", "preemption_limit_rejects", "errors",
         "host_pages", "host_pages_resident", "spilled_pages",
         "host_evictions", "prefetch_committed", "prefetch_aborted",
         "prefetch_held_turns", "kv_shards", "shard_peak_utilization",
         "shard_preemptions", "placement_prefix_hits", "placement_misses",
         "arch", "mode", "requests", "async", "pack_prefill",
         "arrival_rate_req_s", "deadline_s", "max_queue_depth",
         "max_queued_tokens", "pool_pages_requested", "host_tier_pages",
         "repeats", "aot_executables", "aot_by_kind", "aot_misses",
         "retraces", "outcomes", "submitted", "shed_rate",
         "deadline_hit_rate")


def _capture(monkeypatch, mod):
    """Keep the runner ``mod.serve_workload`` builds (its streams hold the
    async pass's tokens)."""
    got = []

    class Runner(mod.ServeRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            got.append(self)
    monkeypatch.setattr(mod, "ServeRunner", Runner)
    return got


def _record_async_rows(monkeypatch):
    """Log, per request id, the logits row behind each token the port's
    async pipeline emits (the step runner's logits at dispatch, the
    sample's index into them; a request's samples emit in dispatch order):
    {req_id: [row]}."""
    from repro_torch.serving import Engine
    rows, queued = {}, {}
    dispatch, emit = Engine._dispatch_async, Engine._emit

    def _dispatch(self, sb, slot=None):
        toks = dispatch(self, sb, slot)
        logits = self._runners[self._async_key(sb.kind, sb.batch)].logits
        for req, _, idx in sb.samples:
            queued.setdefault(req.req_id, []).append(
                logits[idx].float().numpy().copy())
        return toks

    def _emit(self, req, tok, now, first):
        row = queued[req.req_id].pop(0)
        ok = emit(self, req, tok, now, first=first)
        if ok:
            rows.setdefault(req.req_id, []).append(row)
        return ok
    monkeypatch.setattr(Engine, "_dispatch_async", _dispatch)
    monkeypatch.setattr(Engine, "_emit", _emit)
    return rows


def _same_or_near_tie(got, want, rows):
    """Each stream equals the JAX one, or parts at a token where the port's
    logits' best two lie within NEAR_TIE and the JAX token's logit within
    NEAR_TIE of the best (the port's greedy pick is its argmax). Random
    bf16 weights tie often here: 6 of these 8 streams part in the sync
    pass, at gaps of 0 to 0.0625. Returns the partings."""
    parted = []
    for g, w, r in zip(got, want, rows):
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                top = np.sort(r[i])[::-1]
                assert top[0] - top[1] <= NEAR_TIE, (i, top[:2])
                assert r[i][b] >= top[0] - NEAR_TIE, i
                parted.append(i)
                break
    return parted


@pytest.fixture(scope="module")
def params():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return params_from_numpy(get_config(ARCH),
                             jax.tree.map(np.asarray, jparams), "cpu")


def test_poisson_offsets_match_jax():
    for n, rate, seed in ((16, 2.0, 0), (5, 0.5, 3), (4, 0.0, 1)):
        np.testing.assert_array_equal(serve.poisson_offsets(n, rate, seed),
                                      jserve.poisson_offsets(n, rate, seed))


def check_workload(monkeypatch, params, case):
    """The report has the JAX report's keys in its order (the async ones
    add ``graph_pool_gib``, the memory the step runners' captures reserved:
    0 on the CPU), with every count and rate equal; the async pass's
    greedy tokens are equal, or part only at a near-tie."""
    kw = dict(KW, **CASES[case])
    jrun = _capture(monkeypatch, jserve)
    want = jserve.serve_workload(ARCH, "coopt", **kw)
    run = _capture(monkeypatch, serve)
    rows = _record_async_rows(monkeypatch) if kw.get("use_async") else None
    got = serve.serve_workload(ARCH, "coopt", use_kernel=True, device="cpu",
                               params=params, **kw)
    extra = ["graph_pool_gib"] if kw.get("use_async") else []
    assert [k for k in got if k not in extra] == list(want)
    assert got.get("graph_pool_gib", 0) == 0
    for k in EQUAL:
        if k in want:
            assert got[k] == want[k], k
    assert got["preemptions"] > 0 and got["prefix_hit_rate"] > 0
    assert got["placement_prefix_hits"] > 0
    assert (got["packed_rows_saved"] > 0) == bool(kw.get("pack"))
    if kw.get("use_async"):
        streams = run[0].last_streams
        outs = [s.req.output for s in streams]
        assert all(len(o) == KW["max_new_tokens"] for o in outs)
        _same_or_near_tie(outs, [s.req.output for s in jrun[0].last_streams],
                          [rows[s.req.req_id] for s in streams])


@pytest.mark.parametrize("case", ["sync"])
def test_serve_workload_matches_jax(monkeypatch, params, case):
    """``check_workload`` for the sync pass."""
    check_workload(monkeypatch, params, case)


def test_assert_aot_passes_after_warmup(params):
    """Every step of an async pass finds a runner built by the warmup: 0
    misses, no runner built after it, so ``assert_aot`` passes; a runner
    built after the warmup is a retrace and fails it."""
    runner = serve.ServeRunner(ARCH, "coopt", use_async=True, pack=True,
                               assert_aot=True, device="cpu", params=params,
                               **dict(KW, warmup_pass=False))
    try:
        # buckets 32, 64, 128, 192 (max_len), 256; packed rows 1, 2, 4
        assert runner.meta["aot_executables"] == 21
        assert runner.meta["aot_by_kind"] == {"decode": 1, "prefill": 5,
                                              "packed": 15}
        runner.measure()
        assert runner.trace_report() == {"aot_misses": 0, "retraces": {}}
        runner.engine.trace_counts["decode"] += 1
        with pytest.raises(RuntimeError, match="steady-state serve traced"):
            runner.trace_report()
    finally:
        runner.close()
    rep = serving_warmup(runner.engine)          # nothing left to build
    assert rep["aot_executables"] == 0 and rep["graph_pool_gib"] == 0


# the host-DRAM tier: 6 usable device pages; the warmup pass's prompt
# pages spill to the host, and the measured pass prefetches them back
TIER_KW = dict(requests=6, num_lanes=2, max_len=192, max_new_tokens=4,
               scale=0.25, warmup_pass=True, pool_pages=6)
TIER_KEYS = ("host_pages", "host_pages_resident", "spilled_pages",
             "host_evictions", "prefix_host_hit_rate",
             "prefix_device_hit_rate", "prefix_hit_rate", "prefix_host_hits",
             "prefix_device_hits", "prefetch_committed", "prefetch_aborted",
             "prefetch_held_turns", "host_tier_pages")


@pytest.mark.parametrize("flags,err", [
    (["--host-pages", "8"], "host-DRAM")])
def test_unported_options_raise(params, capsys, flags, err):
    """``--host-pages`` (the host-DRAM tier, once refused) serves:
    ``main`` prints a report with the tier's capacity, and
    ``serve_workload`` with 8 host pages reports the JAX report's keys in
    its order, with every tier key equal and the tier spilling, prefetching
    and hitting."""
    serve.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                "--requests", "2", "--max-new-tokens", "2", "--lanes", "2",
                "--max-len", "128", "--prefetch-depth", "1"] + flags)
    out = json.loads(capsys.readouterr().out)
    assert out["host_pages"] == out["host_tier_pages"] == int(flags[1])
    assert out["generated_tokens"] == 4
    kw = dict(TIER_KW, host_pages=int(flags[1]))
    want = jserve.serve_workload(ARCH, "coopt", **kw)
    got = serve.serve_workload(ARCH, "coopt", use_kernel=True, device="cpu",
                               params=params, **kw)
    assert list(got) == list(want)
    for k in TIER_KEYS + EQUAL:
        if k in want:
            assert got[k] == want[k], k
    assert got["spilled_pages"] > 0 and got["prefetch_committed"] > 0
    assert got["prefix_host_hit_rate"] > 0


def test_main_serves_shards_and_mesh_on_cpu(capsys):
    """``main`` with ``--shards 4 --mesh`` serves on the CPU and reports the
    four shards."""
    serve.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new-tokens", "4", "--lanes", "2",
                "--max-len", "128", "--use-kernel", "--shards", "4",
                "--mesh"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_tokens"] == 12 and out["kv_shards"] == 4
    assert len(out["shard_preemptions"]) == 4


def test_main_prints_json_on_cpu(capsys):
    serve.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new-tokens", "4", "--lanes", "2",
                "--max-len", "128", "--use-kernel", "--async",
                "--arrival-rate", "50", "--assert-aot"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_tokens"] == 12 and out["aot_misses"] == 0
    assert out["arrival_rate_req_s"] == 50.0
    assert out["outcomes"]["finished"] == 3


def test_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-4b", "--reduced", "--requests", "1"])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_main_serves_the_recurrent_families(arch, capsys):
    """griffin and rwkv6 (``--reduced``) serve through ``ServeRunner`` sync
    and async on the CPU, every request finished; ``--pack`` raises the
    engine's ValueError (their state is per lane)."""
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "3", "--max-new-tokens", "3", "--lanes", "2", "--max-len", "128",
            "--use-kernel"]
    for extra in ([], ["--async", "--assert-aot"]):
        serve.main(base + extra)
        out = json.loads(capsys.readouterr().out)
        assert out["generated_tokens"] == 9 and out["rejected"] == 0
    with pytest.raises(ValueError, match="pack_prefill unsupported"):
        serve.main(base + ["--pack"])
