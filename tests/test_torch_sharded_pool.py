"""The port's sharded KV pool against the JAX package's on the CPU: the
twins of ``tests/test_sharded_pool.py`` that need no mesh. Page ranges,
allocation pinned to a shard with per-shard ``OutOfBlocks``, the
shard-local prefix cache and per-shard accounting against the JAX
``BlockManager`` (one parametrised test: the same calls on both managers,
their answers equal); the sharded engine's greedy tokens against one
shard's and the JAX engine's, with every lane's table inside its shard at
every step; least-loaded placement, per-shard preemption and the
rejection of a request larger than a shard against the JAX ``Engine``
with the same ``num_shards``, on the same weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.cache.block_manager import BlockManager as JBlockManager  # noqa: E402
from repro.cache.block_manager import OutOfBlocks as JOutOfBlocks  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import CacheConfig as JCacheConfig  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.core.coopt import ORIGINAL as JORIGINAL  # noqa: E402
from repro.core.opt_kv import padded_pool_pages as jpadded  # noqa: E402
from repro.core.opt_kv import shard_page_ranges as jranges  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402

from repro_torch.cache.block_manager import (BlockManager,  # noqa: E402
                                             OutOfBlocks, padded_pool_pages,
                                             shard_page_ranges)
from repro_torch.configs import CacheConfig, get_config  # noqa: E402
from repro_torch.core.coopt import MODES, ORIGINAL  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, Request  # noqa: E402

from test_torch_engine import _assert_same_or_near_tie, _record  # noqa: E402

ARCH = "qwen3-4b-reduced"
BUCKETS = (16, 32, 64, 128, 256)


def _prompt(rng, n):
    return rng.integers(0, 512, n, dtype=np.int32)


@pytest.fixture(scope="module")
def weights():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(get_config(ARCH),
                                      jax.tree.map(np.asarray, jparams), "cpu")


# ------------------------------------------------- the managers, twinned --
def _ranges(mk, oob):
    """Page ranges tile the pool and line up with the device shards (the
    reserved last page comes out of the last shard only)."""
    p_dev = padded_pool_pages(4 * 8, 4)
    ranges = shard_page_ranges(p_dev - 1, 4)
    assert ranges == [(0, 8), (8, 16), (16, 24), (24, 31)]
    for s, (lo, hi) in enumerate(ranges):
        assert lo == s * (p_dev // 4) and hi <= (s + 1) * (p_dev // 4)
    m = mk(31, 64, 4)
    return [p_dev, ranges, padded_pool_pages(30, 4),
            padded_pool_pages(32, 1), padded_pool_pages(5, 8),
            shard_page_ranges(7, 3), m.shard_ranges,
            [m.shard_capacity(s) for s in range(4)], m.max_shard_capacity()]


def _in_shard(mk, oob):
    """Allocation stays in its shard, OutOfBlocks names the pressured
    shard, the other shards stay allocatable, append_token draws only from
    the sequence's shard."""
    m = mk(31, 64, 4)
    pages, _ = m.allocate(1, 100, shard=2)
    assert all(16 <= p < 24 for p in pages)
    out = [pages, m.seq_shard(1), m.shard_of(pages[0])]
    out.append(m.allocate(2, 64 * 6, shard=2)[0])
    with pytest.raises(oob) as ei:
        m.allocate(3, 64, shard=2)
    assert ei.value.shard == 2
    out += [ei.value.shard, m.free_pages_in(0),
            m.can_allocate(64 * 8, shard=0), m.can_allocate(64, shard=2)]
    m.allocate(4, 64, shard=1)
    slots = [m.append_token(4) for _ in range(65)]
    assert 8 * 64 <= slots[-1] < 16 * 64
    return out + [slots, m.least_loaded_shard(),
                  [m.load_key(s) for s in range(4)]]


def _prefix_local(mk, oob):
    """A committed prefix is reusable only on its own shard;
    ``preferred_shard`` names where its chain-hash head lives."""
    m = mk(16, 4, 2)
    toks = list(range(9))                          # 2 full pages + 1
    m.allocate(1, 9, token_ids=toks, shard=0)
    m.commit_prefill(1, 9, token_ids=toks)
    out = [m.preferred_shard(toks, 9)]
    _, same = m.allocate(2, 9, token_ids=toks, shard=0)
    _, other = m.allocate(3, 9, token_ids=toks, shard=1)
    assert out[0] == 0 and same == 8 and other == 0
    return out + [same, other, m.preferred_shard(list(range(100, 109)), 9),
                  m.match_prefix(toks, 9).shard, m.audit()]


def _accounting(mk, oob):
    """Per-shard free, in-use and capacity sum to the pool's."""
    m = mk(31, 64, 4)
    m.allocate(1, 100, shard=0)
    m.allocate(2, 300, shard=3)
    assert sum(m.free_pages_in(s) for s in range(4)) == m.free_pages
    assert sum(m.pages_in_use_in(s) for s in range(4)) == m.pages_in_use
    assert sum(m.shard_capacity(s) for s in range(4)) == m.num_pages
    m.free(1)
    return [[m.free_pages_in(s), m.evictable_pages_in(s),
             m.staging_pages_in(s), m.pages_in_use_in(s),
             m.shard_utilization(s)] for s in range(4)] + [m.free_pages,
                                                           m.pages_in_use]


@pytest.mark.parametrize("case", [_ranges, _in_shard, _prefix_local,
                                  _accounting],
                         ids=["ranges", "in_shard_oob", "prefix_local",
                              "accounting"])
def test_block_manager_shards_match_jax(case):
    """Each case's calls on the port's manager answer as the JAX
    package's do (and pass the JAX test's own assertions)."""
    mine = case(lambda n, ps, s: BlockManager(CacheConfig(
        num_pages=n, page_size=ps, num_shards=s)), OutOfBlocks)
    if case is _ranges:
        assert mine[:6] == [jpadded(32, 4), jranges(31, 4), jpadded(30, 4),
                            jpadded(32, 1), jpadded(5, 8), jranges(7, 3)]
    want = case(lambda n, ps, s: JBlockManager(JCacheConfig(
        num_pages=n, page_size=ps, num_shards=s)), JOutOfBlocks)
    assert mine == want


# ---------------------------------------------------- engines, twinned --
def _engines(weights, ns, lanes=4, max_len=256, mode="coopt", buckets=BUCKETS):
    jparams, params = weights
    jm = JORIGINAL if mode == "original" else JMODES[mode]
    m = ORIGINAL if mode == "original" else MODES[mode]
    jeng = JEngine(jget_config(ARCH), jm,
                   JEngineConfig(num_lanes=lanes, max_len=max_len,
                                 prefill_buckets=buckets, num_shards=ns),
                   params=jparams)
    eng = Engine(get_config(ARCH), m,
                 EngineConfig(num_lanes=lanes, max_len=max_len,
                              prefill_buckets=buckets, num_shards=ns),
                 params=params, device="cpu")
    return jeng, eng


def _run_checked(eng, reqs):
    """Serve ``reqs`` step by step, asserting after every step that each
    running request's page table lies inside its shard's range."""
    for r in reqs:
        eng.add_request(r)
    mgr = eng.scheduler.manager
    steps = 0
    while eng.scheduler.has_work:
        eng.step()
        steps += 1
        for r in eng.scheduler.running.values():
            lo, hi = mgr.shard_ranges[r.shard]
            table = np.asarray(eng.scheduler.page_table(r))
            live = table[table >= 0]
            assert np.all((live >= lo) & (live < hi)), (table, lo, hi)
    return steps


def test_sharded_engine_greedy_and_shard_local_tables(weights):
    """8 shards: greedy tokens equal one shard's exactly (the port's), and
    the JAX engine's at 8 shards or part at a near-tie; no lane's table
    leaves its shard at any step; the per-shard stats match the JAX
    engine's."""
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng, n) for n in (30, 70, 15, 90)]

    def reqs(cls):
        return [cls(req_id=i, prompt=p, max_new_tokens=6,
                    arrival_time=float(i)) for i, p in enumerate(prompts)]
    _, one = _engines(weights, 1)
    r1 = reqs(Request)
    _run_checked(one, r1)
    jeng, eng = _engines(weights, 8)
    want, got = _record(jeng), _record(eng)
    jr = reqs(JRequest)
    for r in jr:
        jeng.add_request(r)
    jeng.run()
    r8 = reqs(Request)
    assert _run_checked(eng, r8) > 0
    assert [r.output for r in r8] == [r.output for r in r1]
    _assert_same_or_near_tie(got, want)
    s, js = eng.stats, jeng.stats
    assert s.num_shards == js.num_shards == 8
    assert s.shard_pages == js.shard_pages and len(s.shard_pages) == 8
    assert sum(s.shard_pages) == s.pool_pages
    assert s.peak_shard_pages_in_use == js.peak_shard_pages_in_use
    assert len(s.shard_utilization()) == 8
    assert max(s.peak_shard_pages_in_use) > 0
    assert [r.shard for r in r8] == [r.shard for r in jr]


def test_least_loaded_placement_spreads_requests(weights):
    """Four equal cold requests land on four distinct shards, where the JAX
    engine puts them."""
    jeng, eng = _engines(weights, 4)
    rng = np.random.default_rng(7)
    prompts = [_prompt(rng, 40) for _ in range(4)]
    placed = []
    for e, cls in ((jeng, JRequest), (eng, Request)):
        reqs = [cls(req_id=i, prompt=p, max_new_tokens=4,
                    arrival_time=float(i)) for i, p in enumerate(prompts)]
        for r in reqs:
            e.add_request(r)
        e.step()
        placed.append([r.shard for r in reqs])
        e.run()
    assert sorted(placed[1]) == [0, 1, 2, 3]
    assert placed[1] == placed[0]


def test_per_shard_pressure_preempts_youngest_on_that_shard(weights):
    """One shard filled while the other is empty: the YOUNGEST request on
    the pressured shard is preempted (not one on another shard), resumes
    greedy-exact against an unpressured engine, and its re-placement off
    its prefix's shard counts as a placement miss; the per-shard stats
    equal the JAX engine's."""
    rng = np.random.default_rng(2)
    shared = _prompt(rng, 64)                     # one full shared page
    pa = np.concatenate([shared, _prompt(rng, 6)])
    pb = np.concatenate([shared, _prompt(rng, 8)])

    def run(eng, cls):
        a = cls(req_id=1, prompt=pa, max_new_tokens=120, arrival_time=0.0)
        b = cls(req_id=2, prompt=pb, max_new_tokens=100, arrival_time=1.0)
        eng.add_request(a)
        eng.step()            # A prefills fully; its page-0 hash commits
        eng.add_request(b)    # prefix affinity pins B to A's shard
        eng.run()
        return a, b
    # 2 shards of a (2 lanes x 4 pages) pool: shard 0 = 4 pages, shard 1 = 3
    jeng, eng = _engines(weights, 2, lanes=2, mode="original")
    ja, jb = run(jeng, JRequest)
    a, b = run(eng, Request)
    s = eng.stats
    assert a.shard == 0 and s.placement_prefix_hits >= 1
    assert s.shard_preemptions[0] >= 1 and s.shard_preemptions[1] == 0
    assert b.num_preemptions >= 1 and a.num_preemptions == 0
    assert s.placement_misses >= 1
    assert len(a.output) == 120 and len(b.output) == 100
    js = jeng.stats
    assert (s.shard_preemptions, s.placement_prefix_hits,
            s.placement_misses, b.num_preemptions) == \
        (js.shard_preemptions, js.placement_prefix_hits,
         js.placement_misses, jb.num_preemptions)
    _, free = _engines(weights, 1, lanes=3, mode="original")
    a2, b2 = run(free, Request)
    assert a.output == a2.output and b.output == b2.output


def test_request_larger_than_shard_rejected(weights):
    """A request is pinned to one shard, so the largest shard's range caps
    what is servable: 300 + 8 tokens against 4 pages of 64 is rejected up
    front, as the JAX engine rejects it."""
    jeng, eng = _engines(weights, 8, max_len=512,
                         buckets=(16, 32, 64, 128, 512))
    prompt = _prompt(np.random.default_rng(3), 300)
    for e, cls in ((jeng, JRequest), (eng, Request)):
        r = cls(req_id=1, prompt=prompt, max_new_tokens=8)
        e.add_request(r)
        e.run()
        assert e.stats.rejected == 1 and r.output == []
    assert eng.scheduler.manager.max_shard_capacity() == \
        jeng.scheduler.manager.max_shard_capacity() == 4
