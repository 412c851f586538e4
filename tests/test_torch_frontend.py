"""The port's ``AsyncEngine`` on the CPU: greedy token identity with its own
sync ``Engine`` under interleaved submissions, cancel releasing pool pages
mid-stream, zero misses after warmup, TTFT anchored at submission (the
cases of ``tests/test_async_frontend.py``; the packed lattice is in
``tests/test_torch_packing.py``); the same tokens as the JAX package's ``AsyncEngine``
on the same weights; ``_build_step(device_feed=True)``'s token plumbing and
fused decode metadata equal to the JAX package's for the same plans; and
the step runners' buffers, the launch counting through graph replays and
the capture-safe latent write, as far as the CPU reaches them.

Generation is greedy (temperature 0) unless a test says otherwise, and the
engines run the kernel wrappers (``use_kernel``), whose plain versions
serve CPU tensors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import AsyncEngine as JAsyncEngine  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.sampler import SamplingParams as JSamplingParams  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.kernels import cuda, ops  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (AsyncEngine, Engine, EngineConfig,  # noqa: E402
                                 Request)
from repro_torch.serving.request import RequestState  # noqa: E402
from repro_torch.serving.sampler import SamplingParams  # noqa: E402

ARCH = "qwen3-4b-reduced"
CFG = get_config(ARCH)
COOPT = MODES["coopt"].replace(use_kernel=True)
jops.configure_for_backend()
# Greedy streams of the two packages may part only at a near-tie: where the
# JAX logits' two best tokens lie within the model-level logit tolerance of
# tests/test_torch_model.py (random weights in bf16 tie often).
NEAR_TIE = 0.1


def _ecfg(cls=EngineConfig, sp=SamplingParams, num_lanes=4, max_len=128,
          seed=0, temperature=0.0):
    return cls(num_lanes=num_lanes, max_len=max_len,
               prefill_buckets=(32, 64, 128),
               sampling=sp(temperature=temperature), seed=seed)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The pipeline hands each step between two Python threads; on a
    loaded machine (the suite's parallel workers) torch's spinning
    intra-op pool starves those hand-offs, so these tests run torch on one
    thread (the reduced model is as fast on it) and restore the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _engine(num_lanes=4, max_len=128, seed=0, arch=ARCH, **kw):
    return Engine(get_config(arch), COOPT,
                  _ecfg(num_lanes=num_lanes, max_len=max_len, seed=seed,
                        **kw), device="cpu")


def _prompts(n, rng, lo=4, hi=40):
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


def _sync_outputs(prompts, max_new_tokens):
    return _engine().generate(prompts, max_new_tokens=max_new_tokens)


# ---------------------------------------------------------- identity -----
def test_async_matches_sync_greedy_interleaved():
    """Interleaved submissions (a second wave submitted while the first is
    mid-decode) give the same greedy tokens as the synchronous loop
    serving the same prompts."""
    rng = np.random.default_rng(11)
    prompts = _prompts(6, rng)
    sync_out = _sync_outputs(prompts, 12)

    eng = _engine()
    fe = AsyncEngine(eng, warmup=True)
    streams = [fe.submit(p, max_new_tokens=12) for p in prompts[:3]]
    # run a few pipeline turns so wave 1 is mid-decode, then submit wave 2
    for _ in range(6):
        fe._loop_once()
    streams += [fe.submit(p, max_new_tokens=12) for p in prompts[3:]]
    fe.run_until_idle()
    fe.close()

    async_out = [list(s.req.output) for s in streams]
    assert async_out == [list(o) for o in sync_out]
    assert all(s.req.state is RequestState.FINISHED for s in streams)


def test_stream_yields_all_tokens_in_order():
    rng = np.random.default_rng(3)
    prompts = _prompts(2, rng)
    eng = _engine()
    fe = AsyncEngine(eng, warmup=True)
    handles = [fe.submit(p, max_new_tokens=8) for p in prompts]
    fe.run_until_idle()
    fe.close()
    for h in handles:
        assert list(fe.stream(h)) == list(h.req.output)
        assert len(h.req.output) == 8


# ------------------------------------------------------------ cancel -----
def test_cancel_mid_stream_releases_pool_pages_and_lane():
    """cancel() mid-generation drops the request (state CANCELLED), frees
    its lane, and returns the pool to baseline: after the surviving
    requests finish, zero pages stay referenced."""
    rng = np.random.default_rng(7)
    prompts = _prompts(3, rng, lo=8, hi=24)
    eng = _engine(num_lanes=4)
    fe = AsyncEngine(eng, warmup=True)
    victim = fe.submit(prompts[0], max_new_tokens=64)
    others = [fe.submit(p, max_new_tokens=10) for p in prompts[1:]]
    # let the victim produce a few tokens, then abandon it mid-stream
    for _ in range(8):
        fe._loop_once()
    assert len(victim.req.output) > 0
    fe.cancel(victim)
    fe.run_until_idle()
    fe.close()

    assert victim.req.state is RequestState.CANCELLED
    assert all(o.req.state is RequestState.FINISHED for o in others)
    assert len(victim.req.output) < 64          # stopped early
    assert not eng.scheduler.running
    eng._update_pool_stats()
    assert eng.stats.pages_in_use == 0
    assert eng.scheduler.manager.audit() == []
    # the victim's stream is closed: iteration ends with exactly the
    # tokens emitted before the cancel landed
    assert list(victim) == list(victim.req.output)


def test_cancelled_tokens_never_reach_stream_after_cancel():
    rng = np.random.default_rng(9)
    eng = _engine(num_lanes=2)
    fe = AsyncEngine(eng, warmup=True)
    h = fe.submit(_prompts(1, rng)[0], max_new_tokens=64)
    for _ in range(4):
        fe._loop_once()
    fe.cancel(h)
    n_at_cancel = len(h.req.output)
    fe.run_until_idle()
    fe.close()
    # the pipeline may deliver at most the already-dispatched steps
    assert len(h.req.output) <= n_at_cancel + 2


# --------------------------------------------- runners / zero misses ---
def test_zero_traces_after_warmup():
    """After ``warmup()`` builds a runner for every shape of the bucket
    lattice (one decode shape, one prefill shape per bucket), a serving run
    never misses and builds nothing more."""
    rng = np.random.default_rng(5)
    prompts = _prompts(5, rng)
    eng = _engine()
    fe = AsyncEngine(eng, warmup=True)
    assert fe.warmed_shapes == 1 + len(eng.ecfg.prefill_buckets)
    assert eng.trace_counts == {"decode": 1, "prefill": 3}
    traces = dict(eng.trace_counts)
    for p in prompts:
        fe.submit(p, max_new_tokens=10)
    fe.run_until_idle()
    fe.close()
    assert eng.aot_misses == 0
    assert eng.trace_counts == traces
    assert eng.warmup() == 0                  # every key has its runner


def test_without_warmup_every_step_is_a_counted_miss():
    """With no runners each step runs the body eagerly and counts a miss;
    the tokens are the same as through the runners."""
    rng = np.random.default_rng(5)
    prompts = _prompts(3, rng)
    outs, misses = [], []
    for warm in (False, True):
        eng = _engine()
        fe = AsyncEngine(eng, warmup=warm)
        hs = [fe.submit(p, max_new_tokens=6) for p in prompts]
        fe.run_until_idle()
        fe.close()
        outs.append([list(h.req.output) for h in hs])
        misses.append(eng.aot_misses)
        steps = (eng.stats.prefill_calls + eng.stats.decode_steps
                 - eng.stats.mixed_steps)
    assert outs[0] == outs[1]
    assert misses[0] == steps > 0 and misses[1] == 0


def test_warmup_refuses_an_engine_with_work():
    eng = _engine()
    eng.add_request(Request(req_id=0, prompt=np.arange(8, dtype=np.int32),
                            max_new_tokens=2))
    with pytest.raises(RuntimeError, match="no work"):
        eng.warmup()


def test_runner_inputs_are_one_buffer_of_aligned_views():
    """Each runner's static inputs are int32 views into one buffer, every
    view on a 64-byte boundary, so a step is one host-to-device copy; the
    warmup's dummy steps leave the lane feed and the pool untouched."""
    eng = _engine()
    pool0 = {k: v.clone() for k, v in eng.cache.items() if k != "length"}
    eng.warmup()
    for runner in eng._runners.values():
        flat = runner._flat
        for k, t in runner.inputs.items():
            assert t.dtype == torch.int32 and t.is_contiguous()
            assert t.untyped_storage().data_ptr() == \
                flat.untyped_storage().data_ptr()
            assert (t.data_ptr() - flat.data_ptr()) % 64 == 0, k
    assert eng.lane_tok[:eng.ecfg.num_lanes].eq(0).all()   # the last
    # entry takes the dropped samples
    for k, v in pool0.items():
        assert torch.equal(eng.cache[k], v), k


def test_async_sampling_at_temperature():
    """Temperature 0.8 (sampled after the step with the engine's
    generator, then scattered into the lane feed): every token finite and
    inside the vocabulary, every request finished, the pool empty."""
    rng = np.random.default_rng(4)
    eng = _engine(temperature=0.8)
    fe = AsyncEngine(eng, warmup=True)
    hs = [fe.submit(p, max_new_tokens=6) for p in _prompts(3, rng)]
    fe.run_until_idle()
    fe.close()
    for h in hs:
        assert h.req.state is RequestState.FINISHED
        assert len(h.req.output) == 6
        assert all(0 <= t < CFG.vocab_size for t in h.req.output)
    assert eng.aot_misses == 0
    assert eng.scheduler.manager.audit() == []


def test_mla_async_matches_sync_greedy():
    """The MLA family (latent pool, K6/K7 plain versions, the capture-safe
    latent write, MoE FFN) through the same pipeline."""
    arch = "deepseek-v2-lite-16b-reduced"
    rng = np.random.default_rng(12)
    prompts = _prompts(5, rng)
    want = _engine(arch=arch).generate(prompts, max_new_tokens=8)
    eng = _engine(arch=arch)
    fe = AsyncEngine(eng, warmup=True)
    hs = [fe.submit(p, max_new_tokens=8) for p in prompts]
    fe.run_until_idle()
    fe.close()
    assert [list(h.req.output) for h in hs] == [list(w) for w in want]
    assert eng.aot_misses == 0


# ------------------------------------------------- latency provenance ----
def test_ttft_measured_from_submission_includes_queue_wait():
    """More requests than lanes: the overflow request queues, so its TTFT
    (anchored at submit time) includes the queue wait, and
    ``queue_wait_s`` percentiles are populated."""
    rng = np.random.default_rng(21)
    prompts = _prompts(5, rng, lo=8, hi=24)
    eng = _engine(num_lanes=2)
    fe = AsyncEngine(eng, warmup=True)
    for p in prompts:
        fe.submit(p, max_new_tokens=8)
    fe.run_until_idle()
    fe.close()

    s = eng.stats
    assert len(s.ttft_s) == len(prompts)
    assert len(s.queue_wait_s) == len(prompts)
    assert all(t > 0 for t in s.ttft_s)
    assert all(q >= 0 for q in s.queue_wait_s)
    assert all(t >= q for t, q in zip(sorted(s.ttft_s),
                                      sorted(s.queue_wait_s)))
    summary = s.latency_summary()
    for k in ("ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
              "queue_wait_p50_s", "queue_wait_p95_s"):
        assert k in summary
    # with 5 requests on 2 lanes SOMEONE waited for a lane
    assert summary["queue_wait_p95_s"] > 0


def test_sync_generate_stamps_real_submission_times():
    rng = np.random.default_rng(2)
    eng = _engine(num_lanes=2)
    reqs = eng.generate(_prompts(4, rng, lo=6, hi=16), max_new_tokens=4,
                        return_requests=True)
    assert all(r.submit_time > 0 for r in reqs)
    assert all(r.admit_time >= r.submit_time for r in reqs)
    assert len(eng.stats.queue_wait_s) == 4


# ------------------------------------------------ against the JAX package --
def _jax_engine(jparams):
    return JEngine(jget_config(ARCH), JMODES["coopt"],
                   _ecfg(JEngineConfig, JSamplingParams), params=jparams)


def _assert_same_or_near_tie(got, want):
    """Token streams agree, or part at a step where the JAX logits' best two
    tokens are within NEAR_TIE and the port took one of them."""
    parted = 0
    for rid, seq in want.items():
        mine = [t for t, _ in got[rid]]
        for i, (tok, row) in enumerate(seq):
            if mine[i] == tok:
                continue
            top = np.sort(row)[::-1]
            assert top[0] - top[1] <= NEAR_TIE, (rid, i, top[:2])
            assert row[mine[i]] >= top[0] - NEAR_TIE, (rid, i)
            parted += 1
            break
    return parted


def test_async_matches_jax_async_engine():
    """The port's AsyncEngine (runners built) and the JAX package's
    (``warmup=False``) on the same weights and interleaved submissions:
    the same greedy tokens, or streams that part only at a near-tie of the
    JAX logits (read from the JAX sync engine, whose tokens equal its
    AsyncEngine's)."""
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    params = params_from_numpy(CFG, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(11)
    prompts = _prompts(6, rng)

    def drive(fe):
        hs = [fe.submit(p, max_new_tokens=12) for p in prompts[:3]]
        for _ in range(6):
            fe._loop_once()
        hs += [fe.submit(p, max_new_tokens=12) for p in prompts[3:]]
        fe.run_until_idle()
        fe.close()
        return [list(h.req.output) for h in hs]

    jtoks = drive(JAsyncEngine(_jax_engine(jparams), warmup=False))
    # the JAX logits of every emitted token, from its sync engine
    jeng = _jax_engine(jparams)
    rows, sample, emit = {}, jeng._sample, jeng._emit
    last = {}

    def _sample(logits):
        last["logits"] = np.asarray(logits, np.float32)
        return sample(logits)

    def _emit(req, tok, now, first):
        rows.setdefault(req.req_id - 1000, []).append(
            last["logits"][req.lane])
        return emit(req, tok, now, first=first)

    jeng._sample, jeng._emit = _sample, _emit
    assert [list(o) for o in jeng.generate(prompts, 12)] == jtoks

    eng = Engine(CFG, COOPT, _ecfg(), params=params, device="cpu")
    mine = drive(AsyncEngine(eng, warmup=True))
    assert eng.aot_misses == 0
    assert all(len(m) == 12 for m in mine)
    want = {i: list(zip(jtoks[i], rows[i])) for i in range(len(prompts))}
    got = {i: [(t, None) for t in mine[i]] for i in range(len(prompts))}
    assert _assert_same_or_near_tie(got, want) <= len(prompts) // 2


def _fake_emit(eng, sb):
    """Host-side stand-in for a step's emission (no model run): every
    sample gets token 1."""
    eng._note_executed(sb)
    eng._postprocess(sb, np.ones(eng.ecfg.num_lanes, np.int32), 0.0)


def test_build_step_device_feed_matches_jax():
    """For the same plans, ``_build_step(plan, device_feed=True)`` gives
    the JAX package's kind, samples, ``feed``, ``row_lane`` and
    ``scatter_lane``, the decode step's fused ``dmeta`` and page table, and
    the prefill step's index arrays (row i is lane i: ``row_lane`` is the
    identity without packing). Both engines
    schedule the same requests; emissions are faked, so no model runs."""
    rng = np.random.default_rng(8)
    prompts = _prompts(6, rng, lo=20, hi=100)
    jeng = _jax_engine(None)
    eng = Engine(CFG, COOPT, _ecfg(), device="cpu")
    for i, p in enumerate(prompts):
        for e, cls in ((jeng, JRequest), (eng, Request)):
            e.add_request(cls(req_id=i, prompt=p, max_new_tokens=5,
                              arrival_time=float(i)))
    kinds = set()
    for _ in range(60):
        jplan, plan = jeng.scheduler.schedule_step(), \
            eng.scheduler.schedule_step()
        assert jplan.empty == plan.empty
        if plan.empty:
            break
        jsb = jeng._build_step(jplan, device_feed=True)
        sb = eng._build_step(plan, device_feed=True)
        kinds.add(sb.kind if not plan.prefill or not plan.decode
                  else "mixed")
        assert sb.kind == jsb.kind
        assert [(r.req_id, f, idx) for r, f, idx in sb.samples] == \
            [(r.req_id, f, idx) for r, f, idx in jsb.samples]
        for k in ("feed", "row_lane", "scatter_lane", "lane_mask"):
            np.testing.assert_array_equal(getattr(sb, k), getattr(jsb, k))
        np.testing.assert_array_equal(sb.row_lane, np.arange(len(sb.feed)))
        assert sorted(sb.batch) == sorted(
            k for k in jsb.batch if k != "pad_mask")
        for k, v in sb.batch.items():
            np.testing.assert_array_equal(v, np.asarray(jsb.batch[k]))
        _fake_emit(jeng, jsb)
        _fake_emit(eng, sb)
    assert kinds == {"prefill", "decode", "mixed"}
    assert not eng.scheduler.has_work


# ---------------------------------------------- pieces the graphs rely on --
def test_capture_launches_moves_counts_to_the_replays():
    """``cuda.capture_launches`` takes the counts made inside it back out
    of ``LAUNCHES`` and returns them; ``add_launches`` adds them once a
    replay."""
    cuda.reset_launches()
    cuda.count("flash_chunk_prefill")
    with cuda.capture_launches() as got:
        cuda.count("kv_cache_write")
        cuda.count("kv_cache_write")
        cuda.count("paged_pool_decode_visits")
    assert got == {"kv_cache_write": 2, "paged_pool_decode_visits": 1}
    assert cuda.LAUNCHES["kv_cache_write"] == 0
    assert cuda.LAUNCHES["flash_chunk_prefill"] == 1
    for _ in range(3):
        cuda.add_launches(got)
    assert cuda.LAUNCHES["kv_cache_write"] == 6
    assert cuda.LAUNCHES["paged_pool_decode_visits"] == 3
    cuda.reset_launches()


def test_latent_pool_write_routes_skipped_slots_to_the_sentinel_line():
    """Slots < 0 and past the pool land on the pool's last line (the JAX
    package's sentinel, which the BlockManager never allocates); every
    other line holds exactly the rows whose slots name it."""
    R, W = 16, 24
    P, ps = 3, 4
    lat = torch.randn(1, 6, W).bfloat16()
    slots = torch.tensor([[0, -1, 5, P * ps, 7, -3]], dtype=torch.int32)
    pool = torch.zeros(P, ps, W, dtype=torch.bfloat16)
    ops.latent_pool_write(pool, None, lat, slots, opt_kv=False,
                          lora_rank=R)
    flat = pool.view(P * ps, W)
    for j, s in ((0, 0), (2, 5), (4, 7)):
        assert torch.equal(flat[s], lat[0, j])
    untouched = [i for i in range(P * ps - 1) if i not in (0, 5, 7)]
    assert flat[untouched].eq(0).all()
    assert any(torch.equal(flat[-1], lat[0, j]) for j in (1, 3, 5))
