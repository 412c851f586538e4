"""The port's ``Engine.generate`` against the JAX package's ``Engine`` on the
same weights and prompts: greedy tokens and the stats counters (prefix
hits, preemptions) must agree, in ``coopt`` and ``original`` modes, on the
reference path and on the kernel wrappers' plain versions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.configs.base import CacheConfig as JCacheConfig  # noqa: E402

from repro_torch.configs import CacheConfig, get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

ARCH = "qwen3-4b-reduced"
# (mode, pool pages): coopt runs on a pool small enough to preempt
CASES = [("coopt", 7), ("original", 0)]
# Greedy streams may part only at a near-tie: where the JAX logits' two
# best tokens lie within the model-level logit tolerance of
# tests/test_torch_model.py (0.1; random weights in bf16 tie often).
NEAR_TIE = 0.1


def _record(eng):
    """Wrap the engine's sampler and token emission so that every emitted
    token is logged with its logits row: {req_id: [(token, logits)]}."""
    log, last = {}, {}
    sample, emit = eng._sample, eng._emit

    def _sample(logits):
        last["logits"] = np.asarray(logits, np.float32) \
            if not isinstance(logits, torch.Tensor) else logits.float().numpy()
        return sample(logits)

    def _emit(req, tok, now, first):
        log.setdefault(req.req_id, []).append((tok, last["logits"][req.lane]))
        return emit(req, tok, now, first=first)

    eng._sample, eng._emit = _sample, _emit
    return log


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


@pytest.fixture(scope="module")
def weights():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(get_config(ARCH),
                                      jax.tree.map(np.asarray, jparams), "cpu")


def _prompts():
    """Six prompts; four share a 70-token prefix (two full 32-token pages)."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 512, 70)
    out = [np.concatenate([prefix, rng.integers(0, 512, n)])
           for n in (5, 30, 12, 44)]
    return out + [rng.integers(0, 512, n) for n in (40, 9)]


def _ecfg(cls, cache_cls, pages):
    return cls(num_lanes=3, max_len=160, prefill_buckets=(16, 32, 64),
               cache=cache_cls(num_pages=pages, page_size=32))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def jax_run(request, weights):
    mode, pages = request.param
    jparams, _ = weights
    eng = JEngine(jget_config(ARCH), JMODES[mode].replace(page_size=32),
                  _ecfg(JEngineConfig, JCacheConfig, pages), params=jparams)
    log = _record(eng)
    eng.generate(_prompts(), max_new_tokens=24)
    return mode, pages, log, eng.stats


@pytest.mark.parametrize("use_kernel", [False, True])
def test_generate_matches_jax_engine(weights, jax_run, use_kernel):
    """Greedy tokens equal, or part only at a near-tie (NEAR_TIE); the
    generated-token, prefix-hit, preemption and rejection counts are equal.
    ``use_kernel`` routes attention and writes through the kernel wrappers
    (their plain versions on CPU)."""
    mode, pages, want, jstats = jax_run
    _, params = weights
    eng = Engine(get_config(ARCH),
                 MODES[mode].replace(page_size=32, use_kernel=use_kernel),
                 _ecfg(EngineConfig, CacheConfig, pages), params=params,
                 device="cpu")
    got = _record(eng)
    eng.generate(_prompts(), max_new_tokens=24)
    assert sorted(got) == sorted(want)
    # most streams run to the end identical
    assert _assert_same_or_near_tie(got, want) <= len(want) // 2
    st = eng.stats
    assert st.generated_tokens == jstats.generated_tokens
    assert st.prefix_cache_queries == jstats.prefix_cache_queries
    assert st.prefix_cache_hits == jstats.prefix_cache_hits > 0
    assert st.preemptions == jstats.preemptions
    assert (st.preemptions > 0) == (pages > 0)
    assert st.rejected == jstats.rejected == 0
    assert st.shared_page_visits == jstats.shared_page_visits
    assert eng.scheduler.manager.audit() == []


def test_unported_options_raise(weights):
    """Every option of the JAX engine is served: ``pack_prefill`` builds an
    engine that packs, the host-DRAM tier (``host_pages > 0``) one whose
    spill sink and prefetch hooks are wired (tests/test_torch_host_tier.py
    holds it to the JAX engine), and so do page-range shards and a mesh
    (tests/test_torch_sharded_*.py); a mesh whose shard count disagrees
    with the config's is refused."""
    _, params = weights
    cfg = get_config(ARCH)
    eng = Engine(cfg, MODES["coopt"], EngineConfig(pack_prefill=True),
                 params=params, device="cpu")
    outs = eng.generate([np.arange(5), np.arange(9)], max_new_tokens=2)
    assert [len(o) for o in outs] == [2, 2]
    assert eng.stats.packed_steps > 0 and eng.stats.packed_rows_saved > 0
    eng = Engine(cfg, MODES["coopt"],
                 EngineConfig(cache=CacheConfig(host_pages=4)), params=params,
                 device="cpu")
    mgr = eng.scheduler.manager
    assert mgr.host_tier_enabled and mgr.spill_sink == eng._spill_page
    assert eng.scheduler.prefetcher == eng._start_prefetch
    assert eng.scheduler.prefetch_tick == eng._tick_prefetch
    outs = eng.generate([np.arange(5), np.arange(9)], max_new_tokens=2)
    assert [len(o) for o in outs] == [2, 2]
    assert eng.stats.host_pages == 4 and mgr.audit() == []
    from repro_torch.launch.mesh import make_sim_mesh
    with pytest.raises(ValueError, match="disagrees"):
        Engine(cfg, MODES["coopt"],
               EngineConfig(cache=CacheConfig(num_shards=2)), params=params,
               device="cpu", mesh=make_sim_mesh(data=4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(cfg, MODES["coopt"], params=params)


@pytest.mark.parametrize("mode,use_kernel",
                         [("coopt", True), ("original", False)])
def test_long_window_decode_schedule_independent(mode, use_kernel):
    """The port's twin of the JAX package's engine-level regression: with
    ``long_window`` set, a decode token gets the same {sink + sliding
    window} policy whether its step is decode-only or shares the call with
    another request's prefill chunks, so the tokens equal the solo run's."""
    from repro_torch.serving import Request
    cfg = get_config(ARCH)
    coopt = MODES[mode].replace(use_kernel=use_kernel)
    ecfg = EngineConfig(num_lanes=2, max_len=256,
                        prefill_buckets=(16, 32, 64, 128), long_window=32)
    r1 = np.random.default_rng(12).integers(0, cfg.vocab_size, 120,
                                            dtype=np.int32)
    r2 = np.random.default_rng(13).integers(0, cfg.vocab_size, 100,
                                            dtype=np.int32)
    params = get_model(cfg).init(0, "cpu")
    solo = Engine(cfg, coopt, ecfg, params=params, device="cpu").generate(
        [r1], max_new_tokens=10)[0]
    eng = Engine(cfg, coopt, ecfg, params=params, device="cpu")
    req1 = Request(req_id=1, prompt=r1, max_new_tokens=10)
    eng.add_request(req1)
    for _ in range(6):                              # r1 reaches decode
        eng.step()
    eng.add_request(Request(req_id=2, prompt=r2, max_new_tokens=10))
    eng.run()                                       # r1 decodes in MIXED steps
    assert eng.stats.mixed_steps > 0
    assert req1.output == solo
