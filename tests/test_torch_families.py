"""The port's moe (mixtral-8x22b) and vlm (internvl2-2b) families against the
JAX package, on reduced configs with the same weights (``params_from_numpy``)
and numpy-seeded inputs: the model's prefill and decode logits, the
engine's greedy tokens, and the port's twins of
``tests/test_unified_families.py``'s chunked-vs-whole-prompt and prefix-hit
cells. mixtral-8x22b-reduced keeps a sliding window (64 positions, one sink
page); internvl2-2b-reduced has a 16-position patch stub."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES, ORIGINAL  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

ARCHS = ["mixtral-8x22b-reduced", "internvl2-2b-reduced"]
# The dense family's logit tolerance (tests/test_torch_model.py): a few bf16
# ulps of |logit| < 4 through 2 layers, plus an fp8 code step with Opt-KV.
LOGIT_ATOL = 0.1
# Greedy streams may part only where the JAX logits' best two lie within
# the same 0.1 (tests/test_torch_engine.py).
NEAR_TIE = 0.1


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    arch = request.param
    jparams = jget_model(jget_config(arch)).init(jax.random.PRNGKey(0))
    return arch, jparams, params_from_numpy(
        get_config(arch), jax.tree.map(np.asarray, jparams), "cpu")


def test_configs_keep_the_window_and_the_stub():
    mix, vlm = get_config("mixtral-8x22b"), get_config("internvl2-2b")
    assert (mix.family, mix.attn_window, mix.sink_blocks, mix.q_per_kv) == \
        ("moe", 4096, 1, 6)
    assert (vlm.family, vlm.num_patches, vlm.q_per_kv) == ("vlm", 1024, 2)
    assert get_config("mixtral-8x22b-reduced").attn_window == 64
    assert get_config("internvl2-2b-reduced").num_patches == 16


def _steps(rng, vocab):
    """Three engine-style steps on two lanes of a lane-identity pool with
    16-token pages (8 a lane): lane 0 prefills 96 tokens, then a chunk of 8
    and a decode (105 positions: past mixtral-reduced's window of 64 and
    its sink page), lane 1 prefills 40, then decodes twice. Pads repeat the
    last position and write nowhere (slot -1)."""
    P_lane, ps = 8, 16
    lens = [96, 40]
    S = 96
    toks = rng.integers(0, vocab, (2, S)).astype(np.int32)
    pos = np.stack([np.minimum(np.arange(S), n - 1) for n in lens])
    slot = np.stack([np.where(np.arange(S) < n, b * P_lane * ps + pos[b], -1)
                     for b, n in enumerate(lens)])
    yield "prefill", dict(tokens=toks, positions=pos, slot_idx=slot,
                          cache_len=np.array(lens),
                          last_pos=np.array([n - 1 for n in lens]))
    S2 = 8
    toks2 = rng.integers(0, vocab, (2, S2)).astype(np.int32)
    pos2 = np.stack([96 + np.arange(S2), np.full(S2, 40)])
    slot2 = np.stack([pos2[0], np.r_[P_lane * ps + 40, [-1] * (S2 - 1)]])
    yield "prefill", dict(tokens=toks2, positions=pos2, slot_idx=slot2,
                          cache_len=np.array([104, 41]),
                          last_pos=np.array([S2 - 1, 0]))
    tok3 = rng.integers(0, vocab, (2, 1)).astype(np.int32)
    yield "decode", dict(token=tok3, positions=np.array([[104], [41]]),
                         slot_idx=np.array([[104], [P_lane * ps + 41]]),
                         cache_len=np.array([105, 42]))


def _patches(cfg, rng, B):
    """Random patch embeddings, bf16-exact, as numpy f32."""
    p = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model))
    return torch.from_numpy(p).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("mode", ["coopt", "original"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_logits_match_jax(weights, mode, use_kernel):
    """Every step's logits within LOGIT_ATOL of the JAX model's (on its jnp
    path). vlm: the chunks' first 16 columns take the patch embeddings
    (random, the same on both sides). ``use_kernel``: the kernel wrappers,
    their plain versions on CPU tensors."""
    arch, jparams, params = weights
    cfg, jcfg = get_config(arch), jget_config(arch)
    coopt = MODES[mode].replace(page_size=16, use_kernel=use_kernel)
    jcoopt = JMODES[mode].replace(page_size=16)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    cache = model.init_cache(2, 128, coopt, device="cpu")
    jcache = jmodel.init_cache(2, 128, jcoopt)
    rng = np.random.default_rng(0)
    patches = _patches(cfg, rng, 2) if cfg.family == "vlm" else None
    for kind, host in _steps(rng, cfg.vocab_size):
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in host.items()}
        tb = {k: torch.from_numpy(np.asarray(v, np.int32))
              for k, v in host.items()}
        if patches is not None and kind == "prefill":
            jb["patches"] = jnp.asarray(patches, jnp.bfloat16)
            tb["patches"] = torch.from_numpy(patches).to(torch.bfloat16)
        step = "prefill" if kind == "prefill" else "decode_step"
        jl, jcache = getattr(jmodel, step)(jparams, jb, jcache, jcoopt)
        tl, cache = getattr(model, step)(params, tb, cache, coopt)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   atol=LOGIT_ATOL)


def test_full_prompt_prefill_matches_jax(weights):
    """The full-prompt prefill (no positions): vlm prepends the patches to
    the tokens; mixtral's 80 tokens pass its window of 64."""
    arch, jparams, params = weights
    cfg, jcfg = get_config(arch), jget_config(arch)
    coopt, jcoopt = MODES["coopt"].replace(page_size=16), \
        JMODES["coopt"].replace(page_size=16)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 80)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        p = _patches(cfg, rng, 2)
        jb["patches"] = jnp.asarray(p, jnp.bfloat16)
        tb["patches"] = torch.from_numpy(p).to(torch.bfloat16)
    jmodel, model = jget_model(jcfg), get_model(cfg)
    jl, _ = jmodel.prefill(jparams, jb, jmodel.init_cache(2, 128, jcoopt),
                           jcoopt)
    tl, _ = model.prefill(params, tb,
                          model.init_cache(2, 128, coopt, device="cpu"), coopt)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_ATOL)


# ---------------------------------------------------------------- engine --
def _record(eng):
    """Log every emitted token with its logits row: {req_id: [(tok, row)]}."""
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


def _engine_prompts(cfg):
    """Four prompts; two share a 70-token prefix. 16 new tokens take the
    longest past mixtral-reduced's window and sink page."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 70)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
            for n in (40, 12)] + [rng.integers(0, cfg.vocab_size, n)
                                  for n in (90, 9)]


def _ecfg(cls):
    return cls(num_lanes=2, max_len=192, prefill_buckets=(16, 32, 64))


@pytest.mark.parametrize("mode,use_kernel",
                         [("coopt", True), ("original", False)])
def test_engine_greedy_matches_jax_engine(weights, mode, use_kernel):
    """Greedy tokens equal the JAX engine's (its jnp path), or part only at
    a near-tie (NEAR_TIE) of its logits; the generated-token and prefix
    counts are equal. ``use_kernel``: the port's kernel wrappers (their
    plain versions on CPU)."""
    arch, jparams, params = weights
    cfg = get_config(arch)
    jeng = JEngine(jget_config(arch), JMODES[mode].replace(page_size=32),
                   _ecfg(JEngineConfig), params=jparams)
    want = _record(jeng)
    jeng.generate(_engine_prompts(cfg), max_new_tokens=16)
    eng = Engine(cfg, MODES[mode].replace(page_size=32,
                                          use_kernel=use_kernel),
                 _ecfg(EngineConfig), params=params, device="cpu")
    got = _record(eng)
    eng.generate(_engine_prompts(cfg), max_new_tokens=16)
    assert sorted(got) == sorted(want)
    parted = 0
    for rid, seq in want.items():
        mine = [t for t, _ in got[rid]]
        assert len(mine) == len(seq) == 16
        for i, (tok, row) in enumerate(seq):
            if mine[i] == tok:
                continue
            top = np.sort(row)[::-1]
            assert top[0] - top[1] <= NEAR_TIE, (rid, i, top[:2])
            assert row[mine[i]] >= top[0] - NEAR_TIE, (rid, i)
            parted += 1
            break
    assert parted <= len(want) // 2     # as tests/test_torch_engine.py
    st, jst = eng.stats, jeng.stats
    assert st.generated_tokens == jst.generated_tokens
    assert st.prefix_cache_queries == jst.prefix_cache_queries
    assert st.prefix_cache_hits == jst.prefix_cache_hits > 0
    assert st.mixed_steps == jst.mixed_steps
    assert eng.scheduler.manager.audit() == []


# ----------------------------------------- twins of test_unified_families --
def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n,
                                                dtype=np.int32)


def _original(cfg):
    """ORIGINAL mode (bf16). Expert capacity is per row, so which tokens a
    MoE layer drops depends on how a prompt was cut into chunks: the JAX
    engine's mixtral-8x22b-reduced parts on both cells at the default
    capacity factor 1.25. The moe twins run at E / top_k (capacity = the
    row's length: no token dropped), where the JAX engine passes both."""
    if cfg.family == "moe":
        return ORIGINAL.replace(
            moe_capacity_factor=cfg.num_experts / cfg.top_k)
    return ORIGINAL


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_vs_whole_prompt_greedy_parity(arch):
    """Small buckets cut the prompt into chunks, big ones serve it whole;
    both run the same continuation path over the same cached bytes, so the
    greedy tokens are identical (``_original``)."""
    cfg = get_config(arch)
    prompt = _prompt(cfg, 100, seed=1)
    outs = []
    for buckets in ((16, 32), (64, 128, 256)):
        eng = Engine(cfg, _original(cfg),
                     EngineConfig(num_lanes=2, max_len=256,
                                  prefill_buckets=buckets), device="cpu")
        outs.append(eng.generate([prompt], max_new_tokens=8)[0])
        assert len(outs[-1]) == 8
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_hits_on_repeated_prompt(arch):
    """A repeated prompt of more than a page prefix-hits, with identical
    greedy tokens warm and cold (``_original``)."""
    cfg = get_config(arch)
    prompt = _prompt(cfg, 100, seed=2)
    eng = Engine(cfg, _original(cfg),
                 EngineConfig(num_lanes=2, max_len=256,
                              prefill_buckets=(16, 32, 64, 128)),
                 device="cpu")
    cold = eng.generate([prompt], max_new_tokens=4)[0]
    warm = eng.generate([prompt], max_new_tokens=4)[0]
    assert eng.stats.prefix_cache_hits > 0
    assert cold == warm


def test_vlm_does_not_pack():
    """Packing needs ``length`` to be the only per-lane state; the vlm
    patch stub is per lane, so ``pack_prefill`` raises the JAX engine's
    ValueError. The moe family packs."""
    with pytest.raises(ValueError, match="pack_prefill unsupported"):
        Engine(get_config("internvl2-2b-reduced"), MODES["coopt"],
               EngineConfig(pack_prefill=True), device="cpu")
    eng = Engine(get_config("mixtral-8x22b-reduced"), MODES["coopt"],
                 EngineConfig(pack_prefill=True), device="cpu")
    outs = eng.generate([np.arange(5), np.arange(9)], max_new_tokens=2)
    assert [len(o) for o in outs] == [2, 2]
    assert eng.stats.packed_steps > 0


def test_vlm_step_carries_the_stub():
    """A vlm chunk's columns inside the patch stub carry the placeholder id
    0 and the text after them; the scheduler counts the stub's positions,
    and the zero patch embeddings are one tensor for the engine's life."""
    cfg = get_config("internvl2-2b-reduced")
    eng = Engine(cfg, MODES["coopt"],
                 EngineConfig(num_lanes=2, max_len=128,
                              prefill_buckets=(16, 32, 64)), device="cpu")
    assert eng.scheduler.extra_tokens == 16
    prompt = _prompt(cfg, 30, seed=5) % (cfg.vocab_size - 1) + 1   # no 0
    from repro_torch.serving import Request
    eng.add_request(Request(req_id=1, prompt=prompt, max_new_tokens=2))
    plan = eng.scheduler.schedule_step()
    sb = eng._build_step(plan)
    (c,) = plan.prefill
    assert (c.start, c.n) == (0, 46)
    toks = sb.batch["tokens"][c.req.lane].numpy()
    assert (toks[:16] == 0).all()
    np.testing.assert_array_equal(toks[16:46], prompt)
    patches = eng._patches
    assert patches.shape == (2, 16, cfg.d_model) and not patches.any()
    eng._run_model(sb)
    assert eng._patches is patches
