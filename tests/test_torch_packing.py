"""Concat-prefill packing in the port against the JAX package: ``pack_rows``
and ``chunk_pages`` give the same rows; the engine's packed step arrays
(every plane, the row bucket, the async token plumbing and the order of
the samples) equal ``_build_packed``'s for the same admitted requests; two
prompts packed into one row give the first-token logits of the JAX packed
step and of the port's unpacked one; greedy ``Engine.generate`` with
packing equals the JAX packed engine (or parts only at a near-tie) on a
dense, a qkv-bias and an MLA config; the async lattice gains every packed
shape and serves with no miss; sampling at a temperature stays inside the
vocabulary.

The port runs its kernel wrappers (``use_kernel``), whose plain versions
serve CPU tensors; the JAX engines run their jnp reference path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.sampler import SamplingParams as JSamplingParams  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (AsyncEngine, Engine, EngineConfig,  # noqa: E402
                                 Request)
from repro_torch.serving import scheduler as sched  # noqa: E402
from repro_torch.serving.request import RequestState  # noqa: E402
from repro_torch.serving.sampler import SamplingParams  # noqa: E402

ARCH = "qwen3-4b-reduced"
COOPT = MODES["coopt"].replace(use_kernel=True)
# Greedy streams of the two packages may part only at a near-tie: where the
# JAX logits' two best tokens lie within the model-level logit tolerance of
# tests/test_torch_model.py (random weights in bf16 tie often).
NEAR_TIE = 0.1
# Port against JAX logits: the model-level tolerance of
# tests/test_torch_model.py (bf16 activations through 2 layers round
# differently in the two frameworks).
LOGIT_ATOL = 0.1
# The reference's packed-against-unpacked logit tolerance
# (tests/test_concat_prefill.py): the packed row multiplies other shapes,
# so its bf16 GEMMs round differently.
PACK_TOL = 2e-3


def _ecfg(cls, sp, pack, num_lanes=4, temperature=0.0, seed=0):
    return cls(num_lanes=num_lanes, max_len=128,
               prefill_buckets=(32, 64, 128),
               sampling=sp(temperature=temperature), seed=seed,
               pack_prefill=pack)


def _engine(pack, arch=ARCH, params=None, **kw):
    return Engine(get_config(arch), COOPT,
                  _ecfg(EngineConfig, SamplingParams, pack, **kw),
                  params=params, device="cpu")


def _jax_engine(pack, arch=ARCH, jparams=None, **kw):
    return JEngine(jget_config(arch), JMODES["coopt"],
                   _ecfg(JEngineConfig, JSamplingParams, pack, **kw),
                   params=jparams)


def _weights(arch):
    jparams = jget_model(jget_config(arch)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(get_config(arch),
                                      jax.tree.map(np.asarray, jparams), "cpu")


def _prompts(n, rng, lo=4, hi=24, vocab=512):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi)), dtype=np.int32)
            for _ in range(n)]


# --------------------------------------------------------- pack_rows ----
def _chunk_pair(i, n, start, final):
    """The same prefill chunk for each package: (JAX chunk, port chunk)."""
    prompt = np.zeros(start + n, np.int32)
    jr = JRequest(req_id=i, prompt=prompt, max_new_tokens=1)
    jr.shard = 0
    r = Request(req_id=i, prompt=prompt, max_new_tokens=1)
    tok = np.zeros(n, np.int32)
    return (jsched.PrefillChunk(req=jr, start=start, tokens=tok, final=final,
                                first=start == 0),
            sched.PrefillChunk(req=r, start=start, tokens=tok, final=final,
                               first=start == 0))


def _rows(rows):
    return [([c.req.req_id for c in row.chunks], row.tokens, row.pages,
             row.finals) for row in rows]


@pytest.mark.parametrize("seed", range(6))
def test_pack_rows_matches_jax_on_random_chunks(seed):
    """First-fit decreasing over seeded random chunk lists (continuation
    and final chunks, several widths, slot and page limits): the same
    rows, with the same chunks in the same order."""
    rng = np.random.default_rng(seed)
    ps = int(rng.choice([16, 32]))
    pairs = [_chunk_pair(i, int(rng.integers(1, 60)),
                         int(rng.integers(0, 4)) * ps, bool(rng.random() < .7))
             for i in range(int(rng.integers(3, 12)))]
    width = int(rng.choice([32, 64, 128]))
    slots, ppl = int(rng.integers(1, 5)), int(rng.integers(2, 9))
    want = jsched.pack_rows([j for j, _ in pairs], width, slots, ppl, ps)
    got = sched.pack_rows([p for _, p in pairs], width, slots, ppl, ps)
    assert _rows(got) == _rows(want)
    for (j, p) in pairs:
        assert sched.chunk_pages(p, ps) == jsched.chunk_pages(j, ps)


# the reference's constraint cases (tests/test_concat_prefill.py), on one
# KV shard: (chunk sizes and starts, width, pack_slots, pages_per_lane, ps)
CONSTRAINT_CASES = {
    "all_constraints": ([(n, 0) for n in (20, 16, 8, 8, 4, 4)], 32, 2, 4, 16),
    "one_shard": ([(4, 0)] * 4, 32, 4, 8, 16),
    "history_pages": ([(8, 32)], 32, 4, 2, 16),
}


@pytest.mark.parametrize("case", sorted(CONSTRAINT_CASES))
def test_pack_rows_constraint_cases_match_jax(case):
    """Each chunk lands whole, exactly once; rows keep to the width, page
    and slot limits (a chunk whose history alone exceeds the page limit
    still lands, alone); the rows equal the JAX package's."""
    sizes, width, slots, ppl, ps = CONSTRAINT_CASES[case]
    pairs = [_chunk_pair(i, n, start, True)
             for i, (n, start) in enumerate(sizes)]
    got = sched.pack_rows([p for _, p in pairs], width, slots, ppl, ps)
    want = jsched.pack_rows([j for j, _ in pairs], width, slots, ppl, ps)
    assert _rows(got) == _rows(want)
    packed = [c for row in got for c in row.chunks]
    assert sorted(c.req.req_id for c in packed) == list(range(len(pairs)))
    for row in got:
        assert sum(c.n for c in row.chunks) == row.tokens <= width
        pages = sum(sched.chunk_pages(c, ps) for c in row.chunks)
        assert pages == row.pages
        assert pages <= ppl or len(row.chunks) == 1
        assert sum(int(c.final) for c in row.chunks) == row.finals <= slots
    if case == "history_pages":
        assert sched.chunk_pages(pairs[0][1], ps) == 3
    else:
        assert len(got) < len(pairs)


# ------------------------------------------------- packed step arrays ----
def _fake_emit(eng, sb):
    """Host-side stand-in for a step's emission (no model run): every
    sample gets token 1."""
    eng._note_executed(sb)
    shape = ((len(sb.row_lane), eng.ecfg.pack_slots) if sb.kind == "packed"
             else eng.ecfg.num_lanes)
    eng._postprocess(sb, np.ones(shape, np.int32), 0.0)


@pytest.mark.parametrize("device_feed", [False, True])
def test_packed_build_step_matches_jax(device_feed):
    """For the same admitted requests, every step's kind, planes (all of
    the JAX batch's but ``pad_mask``, which the port's model does not
    read), row bucket ``R``, ``feed``, ``row_lane``, ``scatter_lane``,
    ``lane_mask`` and samples (order and index) equal the JAX package's,
    over a whole schedule with packed, mixed and decode steps."""
    rng = np.random.default_rng(8)
    # the first four share two rows (two pages a row); later ones join
    # decode rows
    prompts = [rng.integers(0, 512, n, dtype=np.int32)
               for n in (33, 12, 10, 8, 50, 60, 20, 90, 5)]
    jeng, eng = _jax_engine(True), _engine(True)
    for i, p in enumerate(prompts):
        for e, cls in ((jeng, JRequest), (eng, Request)):
            e.add_request(cls(req_id=i, prompt=p, max_new_tokens=3 + i % 4,
                              arrival_time=float(i)))
    kinds, rows = set(), set()
    for _ in range(80):
        jplan, plan = jeng.scheduler.schedule_step(), \
            eng.scheduler.schedule_step()
        assert jplan.empty == plan.empty
        if plan.empty:
            break
        jsb = jeng._build_step(jplan, device_feed=device_feed)
        sb = eng._build_step(plan, device_feed=device_feed)
        assert sb.kind == jsb.kind
        if sb.kind == "packed":
            kinds.add("packed+decode" if plan.decode else "packed")
            rows.add(sb.batch["page_table"].shape[0])
        else:
            kinds.add(sb.kind)
        assert [(r.req_id, f, idx) for r, f, idx in sb.samples] == \
            [(r.req_id, f, idx) for r, f, idx in jsb.samples]
        for k in ("feed", "row_lane", "scatter_lane", "lane_mask"):
            np.testing.assert_array_equal(getattr(sb, k), getattr(jsb, k))
        assert sorted(sb.batch) == sorted(
            k for k in jsb.batch if k != "pad_mask")
        for k, v in sb.batch.items():
            assert isinstance(v, torch.Tensor) == (not device_feed)
            got = v if device_feed else v.numpy()
            np.testing.assert_array_equal(got, np.asarray(jsb.batch[k]), k)
        _fake_emit(jeng, jsb)
        _fake_emit(eng, sb)
    assert not eng.scheduler.has_work
    assert {"packed", "packed+decode", "decode"} <= kinds
    assert {2, 4} <= rows
    assert eng.stats.packed_steps == jeng.stats.packed_steps > 0
    assert eng.stats.packed_rows_saved == jeng.stats.packed_rows_saved > 0


# ------------------------------------------------ two prompts one row ----
@pytest.fixture(scope="module")
def weights():
    return _weights(ARCH)


def _first_token_logits(eng, prompts):
    """Admit ``prompts``, build ONE step and run it: ({req_id: the
    first-token logits}, the step)."""
    for i, p in enumerate(prompts):
        cls = JRequest if isinstance(eng, JEngine) else Request
        eng.add_request(cls(req_id=i, prompt=np.asarray(p, np.int32),
                            max_new_tokens=1))
    sb = eng._build_step(eng.scheduler.schedule_step())
    if isinstance(eng, JEngine):
        fn = eng._packed_fn if sb.kind == "packed" else eng._prefill_fn
        logits, _ = fn(eng.params, sb.batch, eng.cache,
                       eng._dev_const(sb.lane_mask))
        logits = np.asarray(logits, np.float32)
    else:
        logits = eng._run_model(sb).float().numpy()
    return {req.req_id: logits[idx] for req, _, idx in sb.samples}, sb


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["reference", "kernel"])
def test_two_prompts_one_row_logits(weights, use_kernel):
    """THE segment-mask check: two short prompts packed into ONE row give
    the port's own unpacked first-token logits within the reference's
    2e-3 (any leak across the shared row would move them; measured: 0),
    as the JAX packed step gives the JAX unpacked ones; against the JAX
    packed step they agree within the model-level LOGIT_ATOL, the bf16
    rounding the two frameworks differ by packed or not (measured: at
    most 0.0625 either way), with the same greedy token or a near-tie."""
    jparams, params = weights
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 512, 9, dtype=np.int32),
               rng.integers(0, 512, 6, dtype=np.int32)]
    coopt = MODES["coopt"].replace(use_kernel=use_kernel)

    def mine(pack):
        return Engine(get_config(ARCH), coopt,
                      _ecfg(EngineConfig, SamplingParams, pack),
                      params=params, device="cpu")
    packed, sb = _first_token_logits(mine(True), prompts)
    unpacked, _ = _first_token_logits(mine(False), prompts)
    jpacked, jsb = _first_token_logits(_jax_engine(True, jparams=jparams),
                                       prompts)
    junpacked, _ = _first_token_logits(_jax_engine(False, jparams=jparams),
                                       prompts)
    assert sb.kind == jsb.kind == "packed"
    assert set(sb.batch["seg_q"][0].tolist()) - {-1} == {0, 1}
    assert sb.batch["page_table"].shape[0] == 1
    for rid in (0, 1):
        for got, want in ((packed, unpacked), (jpacked, junpacked)):
            np.testing.assert_allclose(got[rid], want[rid], rtol=PACK_TOL,
                                       atol=PACK_TOL)
            assert np.argmax(got[rid]) == np.argmax(want[rid])
        np.testing.assert_allclose(packed[rid], jpacked[rid],
                                   atol=LOGIT_ATOL)
        top = np.sort(jpacked[rid])[::-1]
        assert np.argmax(packed[rid]) == np.argmax(jpacked[rid]) or \
            top[0] - top[1] <= NEAR_TIE


# ----------------------------------------------------- end to end -------
def _record(eng, is_jax):
    """Log every emitted token with its logits row, through the engine's
    sampler and ``_postprocess``: {req_id: [(token, logits row)]}."""
    log, last = {}, {}
    sample, post = eng._sample, eng._postprocess

    def _sample(logits):
        last["logits"] = (np.asarray(logits, np.float32) if is_jax
                          else logits.float().numpy())
        return sample(logits)

    def _post(sb, toks, now):
        for req, _, idx in sb.samples:
            log.setdefault(req.req_id, []).append(
                (int(toks[idx]), last["logits"][idx]))
        return post(sb, toks, now)

    eng._sample, eng._postprocess = _sample, _post
    return log


def _assert_same_or_near_tie(got, want):
    """Token streams agree, or part at a step where the JAX logits' best two
    tokens are within NEAR_TIE and the port took one of them."""
    parted = 0
    for rid, seq in want.items():
        mine = [t for t, _ in got[rid]]
        assert len(mine) == len(seq)
        for i, (tok, row) in enumerate(seq):
            if mine[i] == tok:
                continue
            top = np.sort(row)[::-1]
            assert top[0] - top[1] <= NEAR_TIE, (rid, i, top[:2])
            assert row[mine[i]] >= top[0] - NEAR_TIE, (rid, i)
            parted += 1
            break
    return parted


def _serve_prompts():
    """Eight prompts of 4-40 tokens (two of them 70+ tokens, chunked over
    two steps), so rows pack two to four prompts and mixed steps occur."""
    rng = np.random.default_rng(23)
    return _prompts(6, rng, lo=4, hi=40) + _prompts(2, rng, lo=70, hi=100)


@pytest.mark.parametrize("arch", ["qwen3-4b-reduced", "qwen2.5-14b-reduced",
                                  "deepseek-v2-lite-16b-reduced"])
def test_packed_generate_matches_jax_packed_engine(arch):
    """Greedy ``Engine.generate`` with packing on equals the JAX packed
    engine on the same weights, or parts only at a near-tie, with the same
    ``packed_steps`` and ``packed_rows_saved``. On deepseek-v2-lite the
    MoE router's per-row capacity sees the same packed rows in both."""
    jparams, params = _weights(arch)
    prompts = _serve_prompts()
    jeng = _jax_engine(True, arch, jparams)
    want = _record(jeng, True)
    jeng.generate(prompts, max_new_tokens=6)
    eng = _engine(True, arch, params)
    got = _record(eng, False)
    eng.generate(prompts, max_new_tokens=6)
    assert sorted(got) == sorted(want)
    assert _assert_same_or_near_tie(got, want) <= len(want) // 2
    st, jst = eng.stats, jeng.stats
    assert st.packed_steps == jst.packed_steps > 0
    assert st.packed_rows_saved == jst.packed_rows_saved > 0
    assert st.generated_tokens == jst.generated_tokens == 6 * len(prompts)
    assert eng.scheduler.manager.audit() == []


def test_packed_equals_unpacked_on_the_dense_config(weights):
    """Packing on and off serve the same greedy tokens on the dense config
    (the reference's packed-vs-unpacked identity), and the packed run
    really packed."""
    _, params = weights
    prompts = _serve_prompts()
    ref = _engine(False, params=params)
    want = _record(ref, False)
    ref.generate(prompts, max_new_tokens=6)
    eng = _engine(True, params=params)
    got = _record(eng, False)
    eng.generate(prompts, max_new_tokens=6)
    assert _assert_same_or_near_tie(got, want) == 0
    assert ref.stats.packed_steps == 0
    assert eng.stats.packed_steps > 0 and eng.stats.packed_rows_saved > 0


def test_async_warmup_covers_packed_lattice(weights):
    """``AsyncEngine(warmup=True)`` with packing builds one runner per
    shape of the JAX package's lattice (decode, each prefill bucket, each
    row bucket x prefill bucket packed), serves with no miss and no new
    runner, and its tokens equal the sync packed engine's."""
    _, params = weights
    rng = np.random.default_rng(13)
    prompts = _prompts(5, rng, lo=4, hi=20)
    sync = _engine(True, params=params).generate(prompts, max_new_tokens=6)
    eng = _engine(True, params=params)
    fe = AsyncEngine(eng, warmup=True)
    lattice = _jax_engine(True)._warmup_lattice()
    assert fe.warmed_shapes == len(lattice) == 1 + 3 + 3 * 3
    assert sorted(eng.trace_counts.items()) == sorted(
        {"decode": 1, "prefill": 3, "packed": 9}.items())
    built = dict(eng.trace_counts)
    streams = [fe.submit(p, max_new_tokens=6) for p in prompts]
    fe.run_until_idle()
    fe.close()
    assert eng.aot_misses == 0
    assert eng.trace_counts == built
    assert eng.stats.packed_steps > 0
    assert all(s.req.state is RequestState.FINISHED for s in streams)
    assert [list(s.req.output) for s in streams] == [list(o) for o in sync]


@pytest.mark.parametrize("frontend", ["sync", "async"])
def test_packed_steps_sample_at_temperature(weights, frontend):
    """Temperature 0.8 on packed steps: the engine's generator samples the
    (R, pack_slots) logits; every token lies inside the vocabulary."""
    _, params = weights
    rng = np.random.default_rng(5)
    prompts = _prompts(4, rng, lo=4, hi=20)
    eng = _engine(True, params=params, temperature=0.8)
    if frontend == "sync":
        outs = eng.generate(prompts, max_new_tokens=5)
    else:
        fe = AsyncEngine(eng, warmup=True)
        streams = [fe.submit(p, max_new_tokens=5) for p in prompts]
        fe.run_until_idle()
        fe.close()
        outs = [s.req.output for s in streams]
        assert eng.aot_misses == 0
    vocab = get_config(ARCH).vocab_size
    assert all(len(o) == 5 and all(0 <= t < vocab for t in o) for o in outs)
    assert eng.stats.packed_steps > 0


def test_packed_row_feed_takes_the_row_lane_and_host_tokens(weights):
    """``_async_step``'s column-0 feed: row i reads ``lane_tok[row_lane[i]]``
    where ``feed`` is -1, the host token where it is >= 0, and keeps the
    batch's token at -2 (the JAX package's ``_async_step_impl``)."""
    _, params = weights
    eng = _engine(True, params=params)
    batch = eng._dummy_batch("packed", 4, 32)
    batch["tokens"][:, 0] = [11, 12, 13, 14]
    eng.lane_tok.copy_(torch.tensor([100, 101, 102, 103, 0],
                                    dtype=torch.int32))
    planes = dict(lane_mask=np.ones(4, bool),
                  feed=np.array([-1, 7, -2, -1], np.int32),
                  row_lane=np.array([2, 0, 0, 3], np.int32),
                  scatter_lane=np.full(4 * eng.ecfg.pack_slots, 4, np.int32))
    seen = {}
    model_prefill = eng.model.prefill

    def spy(params, b, cache, coopt, **kw):
        seen["col0"] = b["tokens"][:, 0].tolist()
        return model_prefill(params, b, cache, coopt, **kw)
    eng.model.prefill = spy
    inp = {k: torch.as_tensor(v) for k, v in dict(batch, **planes).items()}
    before = eng.cache["length"].clone()
    logits, toks = eng._async_step("packed", inp)
    assert seen["col0"] == [102, 7, 13, 103]
    assert tuple(logits.shape) == (4, eng.ecfg.pack_slots,
                                   get_config(ARCH).vocab_size)
    assert tuple(toks.shape) == (4, eng.ecfg.pack_slots)
    assert torch.equal(eng.cache["length"], before)
    # every sample slot dropped: only the drop entry of lane_tok changed
    assert eng.lane_tok[:4].tolist() == [100, 101, 102, 103]
