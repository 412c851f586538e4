"""The port's host-DRAM KV tier against the JAX package: the twins of the 14
tests of ``tests/test_host_tier.py`` and of the two host-tier chaos
episodes of ``tests/test_resilience.py``.

Unit layer: the BlockManager's residency machine (DEVICE -> HOST on
eviction, HOST -> IN_FLIGHT -> DEVICE on prefetch, DROPPED on a declined
spill), run as the same sequence on the port's and the JAX package's
managers with the same fake spill sink, their residencies and counters
compared step for step; the CacheConfig and EngineConfig checks; the host
page codec's bytes against the JAX ``encode_host_page`` /
``decode_host_page``.

Engine layer: the memory-pressure cell (a working set 3-4x the device
pool, every reuse distance past it), tier on against tier off: the port's
greedy tokens are identical, its counts equal the JAX engine's, and every
page an upload writes equals, byte for byte, what its spill read. The
chaos episodes run under ``AsyncEngine`` with an emit gate, so each
scheduling turn sees the same steps in flight whatever the threads'
timing."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import block_manager as jbm  # noqa: E402
from repro.cache import quant as jquant  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import CacheConfig as JCacheConfig  # noqa: E402
from repro.core.coopt import CoOptConfig as JCoOptConfig  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch.cache import block_manager as bm  # noqa: E402
from repro_torch.cache import quant  # noqa: E402
from repro_torch.configs import CacheConfig, get_config  # noqa: E402
from repro_torch.core.coopt import CoOptConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (AsyncEngine, Engine, EngineConfig,  # noqa: E402
                                 FaultInjector, FaultPlan, FinishReason)
from test_torch_resilience import (_assert_all_terminated,  # noqa: E402
                                   _assert_clean, _engine, _host_tier_kw,
                                   _shared_prefix_prompts)

# the two packages' block managers and their configs
SIDES = ((bm, CacheConfig), (jbm, JCacheConfig))


def _mgr(side, num_pages=4, page_size=4, host_pages=8, sink=None):
    mod, Cfg = side
    m = mod.BlockManager(cfg=Cfg(num_pages=num_pages, page_size=page_size,
                                 host_pages=host_pages))
    m.spill_sink = sink if sink is not None else (lambda h, p, s: {"h": h})
    return m


def _fill_and_release(m, seq_id, toks):
    """Allocate + commit + free: leaves the full pages registered (LRU)."""
    m.allocate(seq_id, len(toks), token_ids=toks)
    m.commit_prefill(seq_id, len(toks), token_ids=toks)
    m.free(seq_id)


STATS = ("spilled_pages", "host_resident_pages", "host_evictions",
         "prefetch_begun", "prefetch_committed", "prefetch_aborted",
         "prefix_hits", "prefix_device_hits", "prefix_host_hits",
         "pages_in_use", "staging_pages")


def _view(m, hashes):
    """What the unit tests read of a manager: each hash's residency (by
    name, the two packages' enums being distinct types), the counters and
    the audit."""
    return ([m.residency(h).name for h in hashes],
            {k: getattr(m, k) for k in STATS}, m.audit())


def _twin(scenario, **kw):
    """Run ``scenario(m, mod)`` on the port's manager and the JAX one with
    the same fake sink; every view it returns must be equal. Returns the
    port's views."""
    views = [scenario(_mgr(side, **kw), side[0]) for side in SIDES]
    assert views[0] == views[1]
    return views[0]


def _h(toks, k):
    return bm.chain_hash_tokens(toks, k, 4)


# ------------------------------------------------------------ unit: spill --
def test_spill_on_evict_lands_host():
    toks = list(range(8))                      # 2 full pages
    hs = [_h(toks, 1), _h(toks, 2)]
    assert hs == [jbm.chain_hash_tokens(toks, k, 4) for k in (1, 2)]

    def run(m, mod):
        _fill_and_release(m, 1, toks)
        before = _view(m, hs)
        # pressure: 4 fresh pages evict both registered pages -> spilled
        m.allocate(2, 16, token_ids=list(range(100, 116)))
        return before, _view(m, hs)
    before, after = _twin(run)
    assert before[0] == ["DEVICE", "DEVICE"]
    assert after[0] == ["HOST", "HOST"]
    assert after[1]["spilled_pages"] == after[1]["host_resident_pages"] == 2
    assert after[2] == []


def test_declined_spill_drops_page():
    toks = list(range(8))

    def run(m, mod):
        _fill_and_release(m, 1, toks)
        m.allocate(2, 16, token_ids=list(range(100, 116)))
        return _view(m, [_h(toks, 1)])
    res, st, audit = _twin(run, sink=lambda h, p, s: None)
    assert res == ["DROPPED"]
    assert st["spilled_pages"] == st["host_resident_pages"] == 0
    assert audit == []


def test_tier_off_never_spills():
    toks = list(range(8))

    def run(m, mod):
        tier = m.host_tier_enabled
        _fill_and_release(m, 1, toks)
        m.allocate(2, 16, token_ids=list(range(100, 116)))
        return tier, _view(m, [_h(toks, 1)])
    tier, (res, st, audit) = _twin(run, host_pages=0)
    assert not tier and res == ["DROPPED"]
    assert st["host_resident_pages"] == 0 and audit == []


def test_host_lru_capacity_evicts_cold_end():
    toks = list(range(16))                     # 4 full pages registered
    hs = [_h(toks, k) for k in (1, 2, 3, 4)]

    def run(m, mod):
        _fill_and_release(m, 1, toks)
        m.allocate(2, 16, token_ids=list(range(100, 116)))  # evict + spill
        return _view(m, hs)
    res, st, audit = _twin(run, num_pages=4, host_pages=2)
    assert st["spilled_pages"] == 4
    assert st["host_resident_pages"] == 2      # capacity clamps the store
    assert st["host_evictions"] == 2
    assert res.count("HOST") == 2 and res.count("DROPPED") == 2
    assert audit == []


# -------------------------------------------------------- unit: prefetch --
def test_prefetch_roundtrip_restores_device_hit():
    toks = list(range(9))                      # 2 full pages + tail
    h1 = _h(toks, 1)

    def run(m, mod):
        out = []
        _fill_and_release(m, 1, toks)
        m.allocate(2, 24, token_ids=list(range(100, 124)))  # evict -> spill
        m.free(2)
        match = m.match_prefix(toks, len(toks))
        out.append(([p.residency.name for p in match.pages],
                    len(match.fetchable)))
        page, payload = m.begin_prefetch(h1, match.shard)
        out.append((payload, m.page_states()[page].home.name,
                    _view(m, [h1])))
        out.append((m.commit_prefetch(h1), _view(m, [h1])))
        # the restored page serves allocate as a HOST-attributed hit
        _, cached = m.allocate(3, 9, token_ids=toks)
        out.append((cached, _view(m, [h1])))
        m.free(3)
        out.append(_view(m, [h1]))
        return out
    match, begun, committed, hit, freed = _twin(run, num_pages=6)
    assert match == (["HOST", "HOST"], 2)
    payload, home, (res, st, _) = begun
    assert payload == {"h": h1} and home == "STAGING"
    assert res == ["IN_FLIGHT"] and st["staging_pages"] == 1
    assert st["pages_in_use"] == 0             # staging is not "in use"
    ok, (res, st, audit) = committed
    assert ok and res == ["DEVICE"] and st["staging_pages"] == 0
    assert audit == []
    cached, (_, st, _) = hit
    assert cached == 4
    assert (st["prefix_host_hits"], st["prefix_device_hits"],
            st["prefix_hits"]) == (1, 0, 1)
    assert freed[2] == []


def test_abort_prefetch_returns_payload_to_host():
    toks = list(range(8))
    h1 = _h(toks, 1)

    def run(m, mod):
        _fill_and_release(m, 1, toks)
        m.allocate(2, 16, token_ids=list(range(100, 116)))
        m.free(2)
        m.begin_prefetch(h1, 0)
        return m.abort_prefetch(h1), _view(m, [h1])
    ok, (res, st, audit) = _twin(run)
    assert ok and res == ["HOST"]              # retriable
    assert st["staging_pages"] == 0 and st["prefetch_aborted"] == 1
    assert audit == []


def test_commit_prefetch_loses_registration_race():
    toks = list(range(8))
    h1 = _h(toks, 1)

    def run(m, mod):
        _fill_and_release(m, 1, toks)
        m.allocate(2, 24, token_ids=list(range(100, 124)))  # evict -> spill
        m.free(2)
        m.begin_prefetch(h1, 0)
        # meanwhile the same prefix is recomputed and re-registered
        _fill_and_release(m, 3, toks)
        raced = _view(m, [h1])
        return raced, m.commit_prefetch(h1), _view(m, [h1])
    raced, ok, (_, st, audit) = _twin(run, num_pages=6)
    assert raced[0] == ["DEVICE"]              # device takes priority
    assert not ok                              # race lost: page freed
    assert st["prefetch_aborted"] == 1 and st["staging_pages"] == 0
    assert audit == []


def test_begin_prefetch_requires_host_residency():
    for side in SIDES:
        with pytest.raises(KeyError):
            _mgr(side).begin_prefetch(12345, 0)


def test_failed_allocate_rewinds_split_hit_stats():
    toks = list(range(8))

    def run(m, mod):
        _fill_and_release(m, 1, toks)
        m.allocate(2, 8, token_ids=list(range(100, 108)))  # 2 referenced
        # seq 3 matches the 2 registered pages but cannot get its 3rd page
        with pytest.raises(mod.OutOfBlocks):
            m.allocate(3, 9, token_ids=toks)
        return _view(m, [_h(toks, 1)])
    _, st, audit = _twin(run, num_pages=4)
    assert st["prefix_hits"] == st["prefix_device_hits"] == \
        st["prefix_host_hits"] == 0
    assert audit == []


# ------------------------------------------------- unit: config + shims --
def test_cache_config_validation():
    for Cfg in (CacheConfig, JCacheConfig):
        for bad in (dict(num_pages=-1), dict(num_shards=0),
                    dict(host_pages=-2)):
            with pytest.raises(ValueError):
                Cfg(**bad)


def test_block_manager_constructor_shims():
    """The port's BlockManager takes the CacheConfig form only (the JAX
    package keeps a legacy positional one); both forms of the JAX manager
    and the port's agree on the geometry, and an unresolved config
    raises in both."""
    mine = bm.BlockManager(cfg=CacheConfig(num_pages=16, page_size=8,
                                           num_shards=2))
    legacy = jbm.BlockManager(16, page_size=8, num_shards=2)
    cfged = jbm.BlockManager(cfg=JCacheConfig(num_pages=16, page_size=8,
                                              num_shards=2))
    for m in (legacy, cfged):
        assert (mine.num_pages, mine.page_size, mine.num_shards) == \
            (m.num_pages, m.page_size, m.num_shards) == (16, 8, 2)
    with pytest.raises(ValueError):
        bm.BlockManager(cfg=CacheConfig())     # unresolved sizes
    with pytest.raises(ValueError):
        jbm.BlockManager(cfg=JCacheConfig())


def test_engine_config_cache_conflict_raises():
    from repro.serving import EngineConfig as JEC
    for Ecfg, Cfg in ((EngineConfig, CacheConfig), (JEC, JCacheConfig)):
        with pytest.raises(ValueError):
            Ecfg(num_shards=2, cache=Cfg(num_shards=4)).cache_config(16)
    # the legacy shard count folds in where the cache leaves it unset
    cc = EngineConfig(num_shards=2).cache_config(16)
    jcc = JEC(num_shards=2).cache_config(16)
    assert (cc.num_shards, cc.page_size, cc.num_pages) == \
        (jcc.num_shards, jcc.page_size, jcc.num_pages) == (2, 16, 128)


# ------------------------------------------------------ unit: host codec --
def _bytes(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes()
        if t.dtype.itemsize == 1:
            return t.view(torch.uint8).numpy().tobytes()
        return t.numpy().tobytes()
    a = np.asarray(t)
    return a.view(np.uint8).tobytes() if a.dtype.itemsize == 1 \
        else a.tobytes()


def test_host_page_codec_roundtrip():
    """Verbatim pages are bit-exact; with ``quantize`` the bf16 leaf is
    fp8-encoded to the JAX codec's bytes and scales, decodes to its bf16
    values (within the reference's 0.2), and ``nbytes`` (from shapes
    only) equals the JAX page's and halves the verbatim page's."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 4)).astype(np.float32)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    jbf = jnp.asarray(x, jnp.bfloat16)
    f8, _ = quant.quantize_fp8(bf)
    hp = quant.encode_host_page({"kv": bf, "scale": f8})
    assert not hp.encoded and not hp.scales
    assert torch.equal(quant.decode_host_page(hp, "kv"), bf)
    assert _bytes(quant.decode_host_page(hp, "scale")) == _bytes(f8)
    hq = quant.encode_host_page({"kv": bf}, quantize=True)
    jq = jquant.encode_host_page({"kv": jbf}, quantize=True)
    assert hq.encoded and jq.encoded and set(hq.scales) == {"kv"}
    assert _bytes(hq.leaves["kv"]) == _bytes(jq.leaves["kv"])
    assert _bytes(hq.scales["kv"]) == _bytes(jq.scales["kv"])
    back = quant.decode_host_page(hq, "kv")
    assert _bytes(back) == _bytes(jquant.decode_host_page(jq, "kv"))
    err = (back.float() - bf.float()).abs().max().item()
    assert err < 0.2
    assert hq.nbytes == jq.nbytes == 2 * 8 * 4 * 1 + 2 * 8 * 4
    assert hq.nbytes < hp.nbytes
    rt = quant.quant_roundtrip_error(bf).item()
    np.testing.assert_allclose(rt, float(jquant.quant_roundtrip_error(jbf)),
                               rtol=1e-6)


# ------------------------------------------- engine: memory pressure cell --
ARCH = "qwen3-4b-reduced"


def _pressure_prompts():
    """8 distinct 3-page shared prefixes, replayed A..H A..H: every reuse
    distance exceeds the 12-page device pool (LRU worst case), working set
    ~= 24 prefix + 16 tail pages ~= 3-4x the pool."""
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(10, 500, size=48).astype(np.int32)
                for _ in range(8)]
    return [np.concatenate([p, rng.integers(10, 500, size=8)
                            .astype(np.int32)])
            for _ in range(2) for p in prefixes]


def _pressure_kw(Cfg, host_pages):
    return dict(num_lanes=2, max_len=128, prefill_buckets=(32, 64, 128),
                seed=0, cache=Cfg(num_pages=13, host_pages=host_pages,
                                  prefetch_depth=2))


@pytest.fixture(scope="module")
def jax_pressure():
    """The JAX engine's memory-pressure run with the tier on: its weights
    (as the port's params) and its stats."""
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    jeng = JEngine(jget_config(ARCH),
                   JCoOptConfig(opt_kv=True, opt_gqa=True, opt_pa=True,
                                page_size=16),
                   JEngineConfig(**_pressure_kw(JCacheConfig, 64)),
                   params=jparams)
    jeng.generate(_pressure_prompts(), max_new_tokens=8)
    params = params_from_numpy(get_config(ARCH),
                               jax.tree.map(np.asarray, jparams), "cpu")
    return params, jeng.stats


def _pressure_engine(params, host_pages):
    return Engine(get_config(ARCH),
                  CoOptConfig(opt_kv=True, opt_gqa=True, opt_pa=True,
                              page_size=16, use_kernel=True),
                  EngineConfig(**_pressure_kw(CacheConfig, host_pages)),
                  params=params, device="cpu")


def _spy_pages(eng):
    """Keep the pool bytes of every page a spill reads (by chain hash, at
    the spill) and, after every upload, the staging page's bytes with the
    hash it restores: (spilled, uploaded)."""
    spilled, uploaded = {}, []
    spill, begin = eng._spill_page, eng.scheduler.manager.begin_prefetch
    upload = eng._upload_page

    def page_bytes(page):
        return {k: _bytes(v.clone()) for k, v in
                eng._read_pool_page(page).items()}

    def spill_page(h, page, shard):
        spilled.setdefault(h, []).append(page_bytes(page))
        return spill(h, page, shard)

    def begin_prefetch(h, shard):
        page, payload = begin(h, shard)
        pending[page] = h
        return page, payload

    def upload_page(hp, page):
        upload(hp, page)
        uploaded.append((pending.pop(page), page_bytes(page)))

    pending = {}
    eng.scheduler.manager.spill_sink = spill_page
    eng.scheduler.manager.begin_prefetch = begin_prefetch
    eng._upload_page = upload_page
    return spilled, uploaded


def test_memory_pressure_tier_bit_identity_and_hit_rate(jax_pressure):
    """Tier on against tier off: greedy tokens bit-identical (a restored
    fp8 page is its spilled bytes), host hits, spills and committed
    prefetches, a strictly better hit rate, every counter equal to the JAX
    engine's, every uploaded page equal byte for byte to the bytes its
    spill read, and both engines drained clean."""
    params, jst = jax_pressure
    prompts = _pressure_prompts()
    on = _pressure_engine(params, 64)
    spilled, uploaded = _spy_pages(on)
    outs_on = on.generate(prompts, max_new_tokens=8)
    off = _pressure_engine(params, 0)
    outs_off = off.generate(prompts, max_new_tokens=8)
    assert len(outs_on) == len(outs_off) == len(prompts)
    assert outs_on == outs_off

    s_on, s_off = on.stats, off.stats
    assert s_on.prefix_host_hits > 0
    assert s_on.spilled_pages > 0 and s_on.prefetch_committed > 0
    assert s_on.prefix_hit_rate() > s_off.prefix_hit_rate()
    assert s_on.prefix_host_hit_rate() > 0 and s_on.prefix_miss_rate() < 1
    assert (s_on.prefix_device_hits + s_on.prefix_host_hits
            == s_on.prefix_cache_hits)
    assert s_off.prefix_host_hits == 0 and s_off.spilled_pages == 0
    for k in ("prefix_cache_queries", "prefix_cache_hits",
              "prefix_device_hits", "prefix_host_hits", "spilled_pages",
              "host_evictions", "host_pages_resident", "prefetch_begun",
              "prefetch_committed", "prefetch_aborted",
              "prefetches_planned", "prefetch_held_turns",
              "prefetch_replans", "preemptions", "generated_tokens"):
        assert getattr(s_on, k) == getattr(jst, k), k

    # losslessness, directly: each upload wrote its spill's bytes
    assert len(uploaded) == s_on.prefetch_begun > 0
    for h, got in uploaded:
        assert got == spilled[h][-1]
    for eng in (on, off):
        assert eng.scheduler.manager.audit() == []
        assert eng.scheduler.manager.pages_in_use == 0
        assert eng.scheduler.manager.staging_pages == 0


# ------------------------------------------------- async: tier chaos ----
class _Gate:
    """Holds the emit worker so the async loop schedules deterministically:
    after each turn every dispatched step but the newest is emitted (and
    waited for), and a turn that blocks for a step first releases them all
    and waits for every one. So each scheduling decision sees the same
    steps in flight whatever the threads' timing."""

    def __init__(self, inj, fe):
        self.inj, self.fe, self.allowed = inj, fe, 0
        self._sem = threading.Semaphore(0)
        hook, drain = inj.on_emit, fe._drain_done

        def on_emit():
            assert self._sem.acquire(timeout=10.0), "emit gate never opened"
            hook()

        def drain_done(block):
            if block:
                self.release(self.inj.steps)
            return drain(block)
        inj.on_emit, fe._drain_done = on_emit, drain_done

    def release(self, upto):
        """Let the worker emit the first ``upto`` dispatched steps and wait
        until it has."""
        while self.allowed < upto:
            self._sem.release()
            self.allowed += 1
        t0 = time.perf_counter()
        held = self.inj.steps - self.allowed
        while self.fe._done_q.qsize() < self.fe._inflight_steps - held:
            assert time.perf_counter() - t0 < 10.0, "emit worker stuck"
            time.sleep(0.001)

    def run(self, turns=5000):
        for _ in range(turns):
            if not self.fe._has_work:
                break
            self.fe._loop_once()
            self.release(self.inj.steps - 1)
        self.release(self.inj.steps)
        self.fe.run_until_idle()


def test_host_tier_chaos_spill_drop_and_prefetch_fail():
    """Dropped spill copies and a failed prefetch landing under the async
    pipeline are absorbed: dropped pages recompute, the failed flight
    returns its payload to the host store, every stream FINISHES with the
    fault-free tier run's tokens, and the two-tier allocator audits clean
    with no staging page and no flight left."""
    prompts = _shared_prefix_prompts(np.random.default_rng(83))
    ref = _engine(**_host_tier_kw())
    want = ref.generate(prompts, max_new_tokens=8)
    assert ref.stats.spilled_pages > 0       # the episode exercises the tier

    eng = _engine(**_host_tier_kw())
    inj = FaultInjector(FaultPlan(seed=83, spill_drop_at=2,
                                  spill_drop_count=3, prefetch_fail_at=1,
                                  prefetch_fail_count=1)).install(eng)
    fe = AsyncEngine(eng, warmup=False)
    gate = _Gate(inj, fe)
    streams = [fe.submit(p, max_new_tokens=8) for p in prompts]
    try:
        gate.run()
    finally:
        fe.close()

    assert inj.spills > 0 and inj.injected_spill_drops == 3
    assert inj.injected_prefetch_fails == 1
    _assert_all_terminated(streams)
    assert [s.finish_reason for s in streams] == \
        [FinishReason.FINISHED] * len(streams)
    assert [list(s.req.output) for s in streams] == [list(o) for o in want]
    _assert_clean(eng)
    assert eng.scheduler.manager.staging_pages == 0
    assert eng._prefetch_flights == []


def test_host_tier_chaos_slow_prefetch_cancel_storm():
    """A slow host link (every prefetch lands 3 turns late) and a seeded
    cancel storm under the async pipeline: cancelled streams close
    CANCELLED, the others FINISH, no flight leaks a staging page, and the
    allocator audits clean with zero pages in use."""
    prompts = _shared_prefix_prompts(np.random.default_rng(89))
    eng = _engine(**_host_tier_kw())
    inj = FaultInjector(FaultPlan(seed=89, prefetch_delay_turns=3,
                                  cancel_at_turns=(6, 12),
                                  cancel_frac=0.3)).install(eng)
    fe = AsyncEngine(eng, warmup=False)
    gate = _Gate(inj, fe)
    streams = [fe.submit(p, max_new_tokens=8) for p in prompts]
    try:
        gate.run()
    finally:
        fe.close()

    _assert_all_terminated(streams)
    reasons = [s.finish_reason for s in streams]
    assert set(reasons) <= {FinishReason.FINISHED, FinishReason.CANCELLED}
    assert inj.injected_cancels > 0 and inj.prefetches > 0
    assert reasons.count(FinishReason.CANCELLED) == inj.injected_cancels
    assert reasons.count(FinishReason.FINISHED) > 0
    _assert_clean(eng)
    assert eng.scheduler.manager.staging_pages == 0
    assert eng._prefetch_flights == []
