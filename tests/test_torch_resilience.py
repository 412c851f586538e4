"""The port's serving resilience layer on the CPU: the chaos episodes of
``tests/test_resilience.py`` (its two host-DRAM tier episodes are twinned
in ``tests/test_torch_host_tier.py``), seeded ``FaultPlan`` episodes
against the port's async pipeline, each asserting the three invariants of
the layer —

  1. ``BlockManager.audit()`` is clean after the episode (zero leaked
     pages, zero refcount drift, coherent free/LRU/prefix state);
  2. EVERY stream terminates with the CORRECT ``FinishReason`` (no hangs,
     no idle-sweep laggards — terminal events close streams in-line);
  3. surviving requests' greedy outputs are identical to a fault-free run
     of the same prompts.

Episodes: OutOfBlocks storms (injected pool pressure driving preemption),
emit-worker kill (stall watchdog), dispatched-step exceptions (ERROR
drain), emit-path exceptions (posted in-band), seeded cancel storms,
cancel-during-preemption, deadline expiry under load, submit-time load
shedding, and the bounded-preemption reject. All generation is greedy so
any corruption shows up as a token difference. The cancel-during-
preemption episode lets the emit worker emit a step only when the test
says so, so that every scheduling turn sees exactly the newest step in
flight whatever the threads' timing.
"""
import queue
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.serving import (AsyncEngine, Engine, EngineConfig,  # noqa: E402
                                 FaultInjector, FaultPlan, FinishReason,
                                 PipelineStallError, Request, TokenStream)
from repro_torch.serving.faults import FaultInjected  # noqa: E402
from repro_torch.serving.request import RequestState  # noqa: E402
from repro_torch.serving.sampler import SamplingParams  # noqa: E402

CFG = get_config("qwen3-4b-reduced")


def _engine(num_lanes=4, max_len=128, seed=0, **kw):
    ecfg = EngineConfig(num_lanes=num_lanes, max_len=max_len,
                        prefill_buckets=(32, 64, 128),
                        sampling=SamplingParams(temperature=0.0),
                        seed=seed, **kw)
    return Engine(CFG, MODES["coopt"].replace(use_kernel=True), ecfg,
                  device="cpu")


def _prompts(n, rng, lo=4, hi=40):
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


def _baseline(prompts, max_new_tokens):
    return _engine().generate(prompts, max_new_tokens=max_new_tokens)


def _assert_clean(eng):
    """Episode oracle: allocator invariants hold and the pool is empty."""
    assert eng.scheduler.manager.audit() == []
    eng._update_pool_stats()
    assert eng.stats.pages_in_use == 0
    assert not eng.scheduler.running


def _assert_all_terminated(streams):
    for s in streams:
        assert s.closed, f"stream {s.req.req_id} never closed"
        assert s.finish_reason is not None
        assert s.req.finish_reason is not None
        # the stream's status mirrors the request's
        assert s.finish_reason is s.req.finish_reason
        # drain any delivered tokens; the terminal sentinel is right
        # behind them — and once closed, get() keeps returning None
        for _ in range(10_000):
            if s.get(timeout=0.1) is None:
                break
        assert s.get(timeout=0.1) is None


# ------------------------------------------------------ OutOfBlocks storm --
def test_oob_storm_preempts_and_survivors_match_baseline():
    """Injected pool-pressure storm: preemptions fire, every request still
    finishes, outputs are bit-identical to a fault-free run, and the
    allocator audits clean."""
    rng = np.random.default_rng(17)
    prompts = _prompts(5, rng, lo=8, hi=30)
    want = _baseline(prompts, 12)

    eng = _engine()
    inj = FaultInjector(FaultPlan(seed=17, oob_at_append=10,
                                  oob_count=4)).install(eng)
    fe = AsyncEngine(eng, warmup=False)
    streams = [fe.submit(p, max_new_tokens=12) for p in prompts]
    fe.run_until_idle()

    assert inj.injected_oob > 0
    assert eng.scheduler.preemptions > 0
    _assert_all_terminated(streams)
    assert [s.finish_reason for s in streams] == \
        [FinishReason.FINISHED] * len(streams)
    assert [list(s.req.output) for s in streams] == [list(o) for o in want]
    _assert_clean(eng)


def test_preemption_limit_rejects_instead_of_livelock():
    """With ``max_preemptions=0`` any preemption becomes a bounded reject
    (PREEMPTION_LIMIT), closing the victim's stream at decision time."""
    rng = np.random.default_rng(23)
    prompts = _prompts(4, rng, lo=8, hi=24)
    eng = _engine(max_preemptions=0)
    FaultInjector(FaultPlan(oob_at_append=6, oob_count=2)).install(eng)
    fe = AsyncEngine(eng, warmup=False)
    streams = [fe.submit(p, max_new_tokens=12) for p in prompts]
    fe.run_until_idle()

    _assert_all_terminated(streams)
    reasons = [s.finish_reason for s in streams]
    assert FinishReason.PREEMPTION_LIMIT in reasons
    assert eng.scheduler.preemption_limit_rejects > 0
    assert eng.stats.preemption_limit_rejects > 0
    for s in streams:          # rejected victims surface as REJECTED state
        if s.finish_reason is FinishReason.PREEMPTION_LIMIT:
            assert s.req.state is RequestState.REJECTED
    _assert_clean(eng)


# ------------------------------------------------------- emit-worker kill --
def test_emit_worker_kill_trips_watchdog_not_a_hang():
    """A silently-dead emit worker must NOT hang ``run_until_idle``: the
    stall watchdog raises ``PipelineStallError`` after the fault drain, so
    every stream is already closed with ERROR and the pool is empty."""
    rng = np.random.default_rng(31)
    eng = _engine()
    FaultInjector(FaultPlan(kill_emit_at=1)).install(eng)
    fe = AsyncEngine(eng, warmup=False, watchdog_s=1.0)
    streams = [fe.submit(p, max_new_tokens=16)
               for p in _prompts(3, rng, lo=6, hi=20)]
    with pytest.raises(PipelineStallError):
        fe.run_until_idle()

    _assert_all_terminated(streams)
    for s in streams:
        assert s.finish_reason is FinishReason.ERROR
        assert isinstance(s.error, PipelineStallError)
    _assert_clean(eng)
    assert eng.stats.errors == len(streams)


# ---------------------------------------------------- step-fault episodes --
def test_dispatched_step_fault_drains_pipeline_as_error():
    """A fault raised inside step dispatch routes ERROR (with the
    exception) to every affected stream; the loop drains instead of
    stranding the pipeline, and later submits fast-fail."""
    rng = np.random.default_rng(37)
    eng = _engine()
    FaultInjector(FaultPlan(raise_at_step=3)).install(eng)
    fe = AsyncEngine(eng, warmup=False)
    streams = [fe.submit(p, max_new_tokens=16)
               for p in _prompts(4, rng, lo=6, hi=20)]
    fe.run_until_idle()        # returns: the fault rides on the streams

    _assert_all_terminated(streams)
    for s in streams:
        assert s.finish_reason is FinishReason.ERROR
        assert isinstance(s.error, FaultInjected)
    _assert_clean(eng)
    # the pipeline is dead: a later submit comes back closed immediately
    late = fe.submit(_prompts(1, rng)[0], max_new_tokens=4)
    assert late.closed and late.finish_reason is FinishReason.ERROR
    assert isinstance(late.error, FaultInjected)


def test_emit_path_exception_is_posted_not_swallowed():
    """An exception inside the emit worker's host sync is posted in-band
    to the loop, which fails the pipeline — the worker never dies silently
    for a non-kill fault."""
    rng = np.random.default_rng(41)
    eng = _engine()

    class EmitBomb:
        def __init__(self):
            self.emissions = 0

        def before_execute(self, sb):
            pass

        def on_turn(self, fe):
            pass

        def on_emit(self):
            self.emissions += 1
            if self.emissions == 2:
                raise RuntimeError("emit-path fault")

    eng.faults = EmitBomb()
    fe = AsyncEngine(eng, warmup=False, watchdog_s=5.0)
    streams = [fe.submit(p, max_new_tokens=16)
               for p in _prompts(3, rng, lo=6, hi=20)]
    fe.run_until_idle()

    _assert_all_terminated(streams)
    for s in streams:
        assert s.finish_reason is FinishReason.ERROR
        assert isinstance(s.error, RuntimeError)
        assert "emit-path fault" in str(s.error)
    _assert_clean(eng)


def test_sync_engine_step_fault_aborts_all_and_reraises():
    """The synchronous loop's contract: a step fault re-raises to the
    caller AFTER draining every live request as ERROR (no leaked pages)."""
    rng = np.random.default_rng(43)
    eng = _engine()
    FaultInjector(FaultPlan(raise_at_step=2)).install(eng)
    reqs = [Request(req_id=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts(3, rng, lo=6, hi=20))]
    for r in reqs:
        eng.add_request(r)
    with pytest.raises(FaultInjected):
        eng.run()
    for r in reqs:
        assert r.finish_reason is FinishReason.ERROR
        assert isinstance(r.error, FaultInjected)
    _assert_clean(eng)


# -------------------------------------------------------- cancel chaos ----
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cancel_storm_audits_clean_and_survivors_identical(seed):
    """Seeded cancel storms mid-flight: pool returns to zero pages, no
    stream is left unclosed, and the UNcancelled requests' outputs are
    bit-identical to a fault-free run."""
    rng = np.random.default_rng(100 + seed)
    prompts = _prompts(6, rng, lo=6, hi=28)
    want = _baseline(prompts, 10)

    eng = _engine()
    inj = FaultInjector(FaultPlan(seed=seed, cancel_at_turns=(4, 8),
                                  cancel_frac=0.5)).install(eng)
    fe = AsyncEngine(eng, warmup=False)
    streams = [fe.submit(p, max_new_tokens=10) for p in prompts]
    fe.run_until_idle()

    assert inj.injected_cancels > 0
    _assert_all_terminated(streams)
    for s, w in zip(streams, want):
        assert s.finish_reason in (FinishReason.FINISHED,
                                   FinishReason.CANCELLED)
        if s.finish_reason is FinishReason.FINISHED:
            assert list(s.req.output) == list(w)
    _assert_clean(eng)


class _EmitGate:
    """Wraps an injector's ``on_emit`` so the emit worker emits a step only
    after the test allowed it (``lag``)."""

    def __init__(self, inj: FaultInjector):
        self.inj, self.allowed, self.open = inj, 0, False
        self._sem = threading.Semaphore(0)
        hook = inj.on_emit

        def on_emit():
            if not self.open:
                assert self._sem.acquire(timeout=5.0), "emit gate never opened"
            hook()
        inj.on_emit = on_emit

    def lag(self, fe: AsyncEngine) -> None:
        """After a loop turn: let the worker emit every dispatched step but
        the newest, and wait until it has, so the next turn drains them and
        schedules with exactly the newest step in flight."""
        while self.allowed < self.inj.steps - 1:
            self._sem.release()
            self.allowed += 1
        t0 = time.perf_counter()
        while fe._done_q.qsize() < max(fe._inflight_steps - 1, 0):
            assert time.perf_counter() - t0 < 5.0, "emit worker stuck"
            time.sleep(0.001)

    def release_all(self) -> None:
        self.open = True
        for _ in range(4):
            self._sem.release()


def test_cancel_during_preemption_interleaving():
    """Cancel a request WHILE it sits preempted in the waiting queue (with
    in-flight device tokens): pages return to zero, its stream closes
    CANCELLED, and the other requests are unaffected. The emit gate keeps
    the newest step in flight at every scheduling turn, so the victim's
    sampled-but-unemitted token holds it in the queue where the cancel
    finds it."""
    rng = np.random.default_rng(53)
    prompts = _prompts(3, rng, lo=8, hi=24)
    want = _baseline(prompts, 12)

    eng = _engine()
    inj = FaultInjector(FaultPlan(oob_at_append=8,
                                  oob_count=2)).install(eng)
    gate = _EmitGate(inj)
    fe = AsyncEngine(eng, warmup=False)
    streams = [fe.submit(p, max_new_tokens=12) for p in prompts]
    victim = None
    for _ in range(400):
        fe._loop_once()
        gate.lag(fe)
        preempted = [s for s in streams
                     if s.req.state is RequestState.PREEMPTED]
        if preempted and victim is None:
            victim = preempted[0]
            assert victim.req.inflight > 0
            fe.cancel(victim)          # cancel WHILE preempted
        if victim is not None:
            break
    assert victim is not None, "injection never caused a preemption"
    assert inj.injected_oob > 0
    gate.release_all()
    fe.run_until_idle()

    _assert_all_terminated(streams)
    assert victim.finish_reason is FinishReason.CANCELLED
    for s, w in zip(streams, want):
        if s is not victim:
            assert s.finish_reason is FinishReason.FINISHED
            assert list(s.req.output) == list(w)
    _assert_clean(eng)


# --------------------------------------------- deadlines & load shedding --
def test_deadline_expiry_sheds_queued_work_at_decision_time():
    """Queued requests whose deadline passes are shed TIMED_OUT by the
    scheduler — their streams close WHILE the busy wave still runs, not at
    idle time."""
    rng = np.random.default_rng(59)
    eng = _engine(num_lanes=2)
    fe = AsyncEngine(eng, warmup=False)
    busy = [fe.submit(p, max_new_tokens=40)
            for p in _prompts(2, rng, lo=6, hi=16)]
    doomed = [fe.submit(p, max_new_tokens=8, deadline_s=1e-4)
              for p in _prompts(3, rng, lo=6, hi=16)]
    for _ in range(600):
        fe._loop_once()
        if all(s.closed for s in doomed):
            break
    # the terminal event closed them in-line: the busy wave is still going
    assert all(s.closed for s in doomed)
    assert any(not s.closed for s in busy)
    for s in doomed:
        assert s.finish_reason is FinishReason.TIMED_OUT
        assert s.get(timeout=0.1) is None
    fe.run_until_idle()
    _assert_all_terminated(busy + doomed)
    assert eng.stats.deadline_shed == len(doomed)
    assert eng.stats.latency_summary()["deadline_shed"] == len(doomed)
    _assert_clean(eng)


def test_submit_load_shedding_past_queue_depth_watermark():
    """Past ``max_queue_depth`` pending requests, ``submit`` fast-rejects:
    the stream comes back ALREADY closed with SHED, without ever touching
    the scheduler."""
    rng = np.random.default_rng(61)
    eng = _engine(num_lanes=2)
    fe = AsyncEngine(eng, warmup=False, max_queue_depth=2)
    streams = [fe.submit(p, max_new_tokens=6)
               for p in _prompts(5, rng, lo=6, hi=16)]
    kept, shed = streams[:2], streams[2:]
    for s in shed:
        assert s.closed and s.finish_reason is FinishReason.SHED
        assert s.get(timeout=0.1) is None          # closed NOW, no loop run
    assert eng.stats.shed == len(shed)
    fe.run_until_idle()
    for s in kept:
        assert s.finish_reason is FinishReason.FINISHED
    assert eng.stats.latency_summary()["shed"] == len(shed)
    _assert_clean(eng)


def test_submit_load_shedding_past_queued_tokens_watermark():
    rng = np.random.default_rng(67)
    eng = _engine(num_lanes=2)
    fe = AsyncEngine(eng, warmup=False, max_queued_tokens=40)
    a = fe.submit(rng.integers(0, CFG.vocab_size, 30, dtype=np.int32),
                  max_new_tokens=4)
    b = fe.submit(rng.integers(0, CFG.vocab_size, 30, dtype=np.int32),
                  max_new_tokens=4)              # 30 + 30 > 40 -> shed
    assert not a.closed
    assert b.closed and b.finish_reason is FinishReason.SHED
    fe.run_until_idle()
    assert a.finish_reason is FinishReason.FINISHED
    _assert_clean(eng)


# ---------------------------------------------- terminal-status contract --
def test_rejected_stream_closes_at_rejection_time():
    """Regression (PR 9 satellite): a REJECTED request's stream must close
    the scheduling turn that rejected it — not after the whole pipeline
    idles — so a client blocked on ``get()`` is released immediately."""
    rng = np.random.default_rng(71)
    eng = _engine(num_lanes=2, max_len=128)
    fe = AsyncEngine(eng, warmup=False)
    busy = fe.submit(_prompts(1, rng, lo=8, hi=16)[0], max_new_tokens=48)
    # 100 prompt tokens + 64 generation > max_len=128: never servable
    doomed = fe.submit(rng.integers(0, CFG.vocab_size, 100, dtype=np.int32),
                       max_new_tokens=64)
    for _ in range(600):
        fe._loop_once()
        if doomed.closed:
            break
    assert doomed.closed and doomed.finish_reason is FinishReason.REJECTED
    assert doomed.get(timeout=0.1) is None
    assert not busy.closed          # the pipeline is very much still busy
    fe.run_until_idle()
    assert busy.finish_reason is FinishReason.FINISHED
    _assert_clean(eng)


def test_token_stream_timeout_raises_timeout_error():
    """``get(timeout=...)`` raises TimeoutError (never ``queue.Empty``);
    None strictly means closed, and a closed stream stays closed."""
    s = TokenStream(Request(req_id=0, prompt=np.zeros(4, np.int32)))
    with pytest.raises(TimeoutError):
        s.get(timeout=0.01)
    try:
        s.get(timeout=0.01)
    except queue.Empty:
        pytest.fail("queue.Empty leaked through TokenStream.get")
    except TimeoutError:
        pass
    s.put(7)
    s.req.finish(FinishReason.CANCELLED)
    s.close()
    assert s.get(timeout=0.1) == 7
    assert s.get(timeout=0.1) is None
    assert s.get(timeout=0.1) is None       # stays closed
    assert s.finish_reason is FinishReason.CANCELLED


# ------------------------------------------------------- host-DRAM tier --
def _host_tier_kw(host_pages=32):
    """The JAX chaos suite's tier cell: 4 usable device pages (pages of 64,
    2 a request), so the shared-prefix replay spills to the host tier and
    repeats prefetch back."""
    from repro_torch.configs import CacheConfig
    return dict(num_lanes=2, max_len=128,
                cache=CacheConfig(num_pages=5, host_pages=host_pages,
                                  prefetch_depth=2))


def _shared_prefix_prompts(rng, k=6, rounds=2):
    """k distinct one-page (64-token) prefixes replayed round-robin: every
    reuse distance exceeds the 4-page device pool."""
    prefixes = [rng.integers(0, CFG.vocab_size, 64, dtype=np.int32)
                for _ in range(k)]
    return [np.concatenate([p, rng.integers(0, CFG.vocab_size, 16,
                                            dtype=np.int32)])
            for _ in range(rounds) for p in prefixes]


@pytest.fixture(scope="module")
def tier_baseline():
    """The fault-free tier run of the shared-prefix prompts (seed 83)."""
    prompts = _shared_prefix_prompts(np.random.default_rng(83))
    ref = _engine(**_host_tier_kw())
    want = ref.generate(prompts, max_new_tokens=8)
    assert ref.stats.spilled_pages > 0 and ref.stats.prefetch_begun > 0
    return prompts, want


def _record_flights(eng):
    """Every prefetch flight the engine's prefetcher starts, in order."""
    seen, start = [], eng.scheduler.prefetcher

    def prefetcher(req, match):
        before = {id(f) for f in eng._prefetch_flights}
        keys = start(req, match)
        seen.extend(f for f in eng._prefetch_flights if id(f) not in before)
        return keys
    eng.scheduler.prefetcher = prefetcher
    return seen


@pytest.mark.parametrize("setting", [
    dict(spill_drop_at=1), dict(spill_drop_at=1, spill_drop_count=2),
    dict(prefetch_fail_at=1), dict(prefetch_fail_at=1, prefetch_fail_count=2),
    dict(prefetch_delay_turns=1)])
def test_host_tier_fault_plan_is_refused_not_ignored(tier_baseline,
                                                     setting):
    """Each of the plan's host-DRAM tier settings is installed and INJECTS
    into the tier's engine (none is ignored): a dropped spill destroys the
    page (recomputed later), a failed prefetch returns its payload to the
    host store, a delay holds every flight one more turn. Every request
    finishes with the fault-free tier run's tokens and the two-tier
    allocator audits clean with no staging page left."""
    prompts, want = tier_baseline
    eng = _engine(**_host_tier_kw())
    seen = _record_flights(eng)
    inj = FaultInjector(FaultPlan(**setting)).install(eng)
    assert eng.faults is inj
    outs = eng.generate(prompts, max_new_tokens=8)
    assert outs == want
    _assert_clean(eng)
    assert eng.scheduler.manager.staging_pages == 0
    if "spill_drop_at" in setting:
        assert inj.injected_spill_drops == setting.get("spill_drop_count", 1)
        assert eng.stats.spilled_pages == inj.spills - inj.injected_spill_drops
    if "prefetch_fail_at" in setting:
        n = setting.get("prefetch_fail_count", 1)
        assert inj.injected_prefetch_fails == n
        assert eng.stats.prefetch_aborted >= n
        assert sum(not f.ok for f in seen) == n
    if "prefetch_delay_turns" in setting:
        assert seen and all(f.lands - f.turn == 2 for f in seen)


def test_host_tier_hooks_count_like_the_reference():
    """``on_spill`` / ``on_prefetch`` (their callers: ``Engine._spill_page``
    and ``_start_prefetch``) answer call for call as the JAX package's
    hooks do."""
    from repro.serving.faults import FaultInjector as JaxInjector
    from repro.serving.faults import FaultPlan as JaxPlan
    kw = dict(spill_drop_at=2, spill_drop_count=3, prefetch_fail_at=3,
              prefetch_fail_count=2, prefetch_delay_turns=4)
    mine, ref = FaultInjector(FaultPlan(**kw)), JaxInjector(JaxPlan(**kw))
    for _ in range(7):
        assert mine.on_spill() == ref.on_spill()
        assert mine.on_prefetch() == ref.on_prefetch()
    for k in ("spills", "prefetches", "injected_spill_drops",
              "injected_prefetch_fails"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert mine.injected_spill_drops == 3
    assert mine.injected_prefetch_fails == 2
