"""The port's whisper family (whisper-small: encoder-decoder, cross-attention
K/V computed once a request and stored fp8) against the JAX package, on
whisper-small-reduced with the same weights (``params_from_numpy``) and
numpy-seeded inputs: the model's prefill (chunked, with and without
``cross_mask``, and monolithic) and decode logits, the stored cross K/V,
the engine's greedy tokens against the JAX engine's, the twins of
``tests/test_unified_families.py``'s whisper cells and of
``tests/test_engine.py::test_engine_other_families[whisper-small]``, the
async warmup lattice (a prefill runner with the encoder and one without
for each bucket), and the refusal to pack. The decoder's self-attention
runs through the kernel wrappers (their plain versions here) at head_dim
64 with one query head a kv head, the full-size shape of K1-K4."""
import functools

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
from repro_torch.data import sharegpt_stream  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.whisper import WhisperModel  # noqa: E402
from repro_torch.serving import AsyncEngine, Engine, EngineConfig  # noqa: E402
from test_torch_families import _record  # noqa: E402
from test_torch_resilience import _one_torch_thread  # noqa: E402,F401

ARCH = "whisper-small-reduced"
# The other families' logit bound (tests/test_torch_recurrent.py and
# tests/test_torch_mla.py): a few bf16 ulps of |logit| through the
# encoder's and the decoder's layers, plus an fp8 code step with Opt-KV.
LOGIT_ATOL = 0.125
# Greedy streams may part only where the JAX logits' best two lie within
# 0.1 (tests/test_torch_engine.py).
NEAR_TIE = 0.1
# The stored cross K/V against the JAX package's, dequantized. The encoder
# states differ by bf16 ulps (its layers of attention and GELU), so an fp8
# code may step once: one e4m3 step (3 mantissa bits) is at most 1/8 of the
# value (CROSS_RTOL). A value whose projection cancels keeps the states'
# absolute error, a few bf16 ulps (2**-8) of the largest magnitudes: up to
# 0.0055 of the layer's largest value on these inputs, which CROSS_ATOL
# (2**-6 of it) bounds.
CROSS_RTOL = 1 / 8
CROSS_ATOL = 2 ** -6


@functools.lru_cache(maxsize=None)
def _weights():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(get_config(ARCH),
                                      jax.tree.map(np.asarray, jparams),
                                      "cpu")


def test_whisper_small_keeps_the_published_widths():
    cfg = get_config("whisper-small")
    assert (cfg.family, cfg.num_layers, cfg.encoder_layers, cfg.d_model,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_frames,
            cfg.vocab_size) == ("whisper", 12, 12, 768, 12, 12, 64, 1500,
                                51865)
    model = get_model(cfg)
    assert isinstance(model, WhisperModel)
    assert model.param_count() == jget_model(
        jget_config("whisper-small")).param_count()
    specs = model.input_specs(type("S", (), dict(global_batch=2, seq_len=8,
                                                 kind="prefill"))())
    assert specs["frames"] == ((2, 1500, 768), torch.bfloat16)


# ----------------------------------------------------------------- model --
def _frames(cfg, rng, B):
    """Random frame embeddings, bf16-exact, as numpy f32."""
    f = rng.normal(0, 0.5, (B, cfg.num_frames, cfg.d_model))
    return torch.from_numpy(f).to(torch.bfloat16).float().numpy()


def _steps(rng, cfg):
    """Engine-style steps on two lanes of a lane-identity pool with 16-token
    pages (8 a lane): lane 0's first chunk of 40 (encoder on, lane 1 masked
    off), then lane 0's second chunk beside lane 1's first chunk of 20
    (encoder on for lane 1 only), then a decode of both."""
    P_lane, ps, vocab = 8, 16, cfg.vocab_size

    def chunk(starts, ns, S, mask):
        toks = rng.integers(0, vocab, (2, S)).astype(np.int32)
        pos = np.stack([np.minimum(s + np.arange(S), s + max(n, 1) - 1)
                        for s, n in zip(starts, ns)])
        slot = np.stack([np.where(np.arange(S) < n, b * P_lane * ps + pos[b],
                                  -1) for b, n in enumerate(ns)])
        return dict(tokens=toks, positions=pos, slot_idx=slot,
                    cache_len=np.array([s + n for s, n in zip(starts, ns)]),
                    last_pos=np.array([max(n, 1) - 1 for n in ns]),
                    frames=_frames(cfg, rng, 2), cross_mask=np.array(mask))

    yield "prefill", chunk((0, 0), (40, 0), 40, [True, False])
    yield "prefill", chunk((40, 0), (8, 20), 20, [False, True])
    s3 = chunk((48, 20), (8, 8), 8, [False, False])
    del s3["frames"], s3["cross_mask"]          # no first chunk: no encoder
    yield "prefill", s3
    yield "decode", dict(token=rng.integers(0, vocab, (2, 1)),
                         positions=np.array([[56], [28]]),
                         slot_idx=np.array([[56], [P_lane * ps + 28]]),
                         cache_len=np.array([57, 29]))


def _dequant(cache, i):
    """Layer i's cross K of lane-major cache leaves, f32 numpy (the
    dequantized values under Opt-KV)."""
    xk = cache["xk"][i]
    if isinstance(xk, torch.Tensor):
        xk = xk.float().numpy()
        sc = cache["xscale"][i, 0].numpy() if "xscale" in cache else None
    else:
        xk = np.asarray(xk.astype(jnp.float32))
        sc = np.asarray(cache["xscale"][i, 0]) if "xscale" in cache else None
    return xk * sc[..., None] if sc is not None else xk


@pytest.mark.parametrize("mode,use_kernel",
                         [("coopt", True), ("original", False)])
def test_prefill_and_decode_logits_match_jax(mode, use_kernel):
    """Every step's logits within LOGIT_ATOL of the JAX model's; the stored
    cross K/V within one fp8 step of its (dequantized), a lane masked off by
    ``cross_mask`` keeps its leaves, and a step without ``frames`` leaves
    them as they were."""
    jparams, params = _weights()
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    coopt = MODES[mode].replace(page_size=16, use_kernel=use_kernel)
    jcoopt = JMODES[mode].replace(page_size=16)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    cache = model.init_cache(2, 128, coopt, device="cpu")
    jcache = jmodel.init_cache(2, 128, jcoopt)
    rng = np.random.default_rng(0)
    for n, (kind, host) in enumerate(_steps(rng, cfg)):
        jb = {k: jnp.asarray(v, jnp.bfloat16 if k == "frames" else
                             bool if k == "cross_mask" else jnp.int32)
              for k, v in host.items()}
        tb = {k: torch.from_numpy(np.asarray(v)).to(
            torch.bfloat16 if k == "frames" else
            torch.bool if k == "cross_mask" else torch.int32)
            for k, v in host.items()}
        step = "prefill" if kind == "prefill" else "decode_step"
        before = {k: cache[k] for k in WhisperModel.cross_leaves
                  if k in cache}
        jl, jcache = getattr(jmodel, step)(jparams, jb, jcache, jcoopt)
        tl, cache = getattr(model, step)(params, tb, cache, coopt)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   atol=LOGIT_ATOL, err_msg=f"step {n}")
        if "cross_mask" not in host:
            assert all(cache[k] is v for k, v in before.items())
        if n == 0:          # lane 1 was masked off: still zeros
            assert not cache["xk"][:, 1].float().abs().any()
        for i in range(cfg.num_layers):
            want, got = _dequant(jcache, i), _dequant(cache, i)
            np.testing.assert_allclose(
                got, want, rtol=CROSS_RTOL,
                atol=CROSS_ATOL * np.abs(want).max(),
                err_msg=f"step {n} layer {i}")


def test_full_prompt_prefill_matches_jax():
    """The monolithic prefill (no positions, no ``cross_mask``: every lane's
    cross K/V filled), the decoder's self-attention the plain causal one
    in both packages."""
    jparams, params = _weights()
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    coopt, jcoopt = MODES["coopt"].replace(page_size=16), \
        JMODES["coopt"].replace(page_size=16)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    fr = _frames(cfg, rng, 2)
    jmodel, model = jget_model(jcfg), get_model(cfg)
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(fr, jnp.bfloat16)},
                           jmodel.init_cache(2, 128, jcoopt), jcoopt)
    tl, cache = model.prefill(
        params, {"tokens": torch.from_numpy(toks),
                 "frames": torch.from_numpy(fr).to(torch.bfloat16)},
        model.init_cache(2, 128, coopt, device="cpu"), coopt)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_ATOL)
    assert cache["xk"].float().abs().amin(dim=(0, 2, 3, 4)).numel() == 2
    assert cache["length"].tolist() == [48, 48]


def test_cross_kv_bytes_and_scales_equal():
    """Given the same encoder states, the stored cross K/V are the JAX
    package's byte for byte: fp8 codes and f32 ``xscale`` (L, 2, B, F, H).
    The states and the projection weights are small dyadic values, so both
    packages' GEMMs sum exactly and the comparison isolates the layout and
    the quantizer."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    rng = np.random.default_rng(2)
    B, F, d = 2, cfg.num_frames, cfg.d_model
    enc = rng.integers(-4, 5, (B, F, d)).astype(np.float32) / 8
    jparams, params = _weights()
    jdec = dict(jparams["dec"])
    dec = dict(params["dec"])
    for k in ("xwk", "xwv", "xbv"):
        w = rng.integers(-4, 5, dec[k].shape).astype(np.float32) / 32
        dec[k] = torch.from_numpy(w).to(torch.bfloat16)
        jdec[k] = jnp.asarray(w, jnp.bfloat16)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    got = model._fill_cross(dict(params, dec=dec),
                            torch.from_numpy(enc).to(torch.bfloat16),
                            MODES["coopt"])
    want = jmodel._fill_cross(dict(jparams, dec=jdec),
                              jmodel.init_cache(B, 64, JMODES["coopt"]),
                              jnp.asarray(enc, jnp.bfloat16), JMODES["coopt"])
    for k in ("xk", "xv"):
        assert got[k].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(got[k].view(torch.uint8).numpy(),
                                      np.asarray(want[k]).view(np.uint8))
    assert got["xscale"].shape == (cfg.num_layers, 2, B, F, cfg.num_heads)
    np.testing.assert_array_equal(got["xscale"].numpy(),
                                  np.asarray(want["xscale"]))


# ---------------------------------------------------------------- engine --
def _engine_prompts(cfg):
    """Four prompts; two share a 40-token prefix (two 16-token pages)."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 40)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
            for n in (30, 7)] + [rng.integers(0, cfg.vocab_size, n)
                                 for n in (70, 9)]


def _ecfg(cls):
    return cls(num_lanes=2, max_len=128, prefill_buckets=(16, 32, 64))


@pytest.mark.parametrize("mode,use_kernel",
                         [("coopt", True), ("original", False)])
def test_engine_greedy_matches_jax_engine(mode, use_kernel):
    """Greedy tokens equal the JAX engine's (its jnp path), or part only at
    a near-tie (NEAR_TIE) of its logits; the generated-token, prefix and
    step counts are equal."""
    jparams, params = _weights()
    cfg = get_config(ARCH)
    jeng = JEngine(jget_config(ARCH), JMODES[mode].replace(page_size=16),
                   _ecfg(JEngineConfig), params=jparams)
    want = _record(jeng)
    jeng.generate(_engine_prompts(cfg), max_new_tokens=8)
    eng = Engine(cfg, MODES[mode].replace(page_size=16,
                                          use_kernel=use_kernel),
                 _ecfg(EngineConfig), params=params, device="cpu")
    got = _record(eng)
    eng.generate(_engine_prompts(cfg), max_new_tokens=8)
    assert sorted(got) == sorted(want)
    parted = 0
    for rid, seq in want.items():
        mine = [t for t, _ in got[rid]]
        assert len(mine) == len(seq) == 8
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
    assert (st.mixed_steps, st.decode_steps, st.prefill_calls) == \
        (jst.mixed_steps, jst.decode_steps, jst.prefill_calls)
    assert eng.scheduler.manager.audit() == []


def test_engine_other_families():
    """The twin of ``test_engine.py::test_engine_other_families`` at
    whisper-small: three ShareGPT requests through small buckets, coopt
    with the kernel wrappers, every one finished."""
    cfg = get_config(ARCH)
    eng = Engine(cfg, MODES["coopt"].replace(use_kernel=True),
                 EngineConfig(num_lanes=2, max_len=96,
                              prefill_buckets=(16, 32)),
                 params=_weights()[1], device="cpu")
    reqs = sharegpt_stream(cfg.vocab_size, 3, seed=1, scale=0.05)
    for r in reqs:
        r.max_new_tokens = 4
        eng.add_request(r)
    eng.run()
    assert all(len(r.output) == 4 for r in reqs)


# ----------------------------------------- twins of test_unified_families --
def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n,
                                                dtype=np.int32)


def test_chunked_vs_whole_prompt_greedy_parity():
    """Small buckets cut the prompt into chunks (the encoder on the first
    only), big ones serve it whole; both run the same continuation path
    over the same cached bytes, so the greedy tokens are identical
    (ORIGINAL, bf16)."""
    cfg = get_config(ARCH)
    prompt = _prompt(cfg, 100, seed=1)
    outs = []
    for buckets in ((16, 32), (64, 128, 256)):
        eng = Engine(cfg, ORIGINAL,
                     EngineConfig(num_lanes=2, max_len=256,
                                  prefill_buckets=buckets),
                     params=_weights()[1], device="cpu")
        outs.append(eng.generate([prompt], max_new_tokens=8)[0])
        assert len(outs[-1]) == 8
    assert outs[0] == outs[1]


def test_prefix_cache_hits_on_repeated_prompt():
    """A repeated prompt of more than a page prefix-hits (its cross K/V are
    computed again: they are per request, not per page), with identical
    greedy tokens warm and cold (ORIGINAL)."""
    cfg = get_config(ARCH)
    prompt = _prompt(cfg, 100, seed=2)
    eng = Engine(cfg, ORIGINAL,
                 EngineConfig(num_lanes=2, max_len=256,
                              prefill_buckets=(16, 32, 64, 128)),
                 params=_weights()[1], device="cpu")
    cold = eng.generate([prompt], max_new_tokens=4)[0]
    warm = eng.generate([prompt], max_new_tokens=4)[0]
    assert eng.stats.prefix_cache_hits > 0
    assert cold == warm


def test_preempt_and_resume_token_identical():
    """An over-subscribed pool completes through preemption with the tokens
    of an unconstrained run: a resumed request's first chunk fills its
    cross K/V again (ORIGINAL)."""
    cfg = get_config(ARCH)
    prompts = [_prompt(cfg, 50, seed=3 + i) for i in range(2)]
    tight = EngineConfig(num_lanes=2, max_len=128,
                         prefill_buckets=(16, 32, 64, 128))
    roomy = EngineConfig(num_lanes=2, max_len=256,
                         prefill_buckets=(16, 32, 64, 128, 256))
    eng_t = Engine(cfg, ORIGINAL, tight, params=_weights()[1], device="cpu")
    out_t = eng_t.generate(prompts, max_new_tokens=20)
    eng_r = Engine(cfg, ORIGINAL, roomy, params=_weights()[1], device="cpu")
    out_r = eng_r.generate(prompts, max_new_tokens=20)
    assert eng_t.stats.preemptions > 0
    assert eng_r.stats.preemptions == 0
    assert all(len(o) == 20 for o in out_t)
    assert out_t == out_r


# ------------------------------------------------- the step and the async --
def test_encoder_runs_on_first_chunks_and_async_lattice():
    """The encoder runs exactly on the steps that carry a first chunk, over
    the engine's one zero ``frames`` buffer; ``AsyncEngine(warmup=True)``
    builds 1 + 2 x buckets runners (a prefill runner with the encoder and
    one without for each bucket, told apart by ``cross_mask``), no step
    misses one, and the async tokens equal the sync engine's."""
    cfg = get_config(ARCH)
    params = _weights()[1]
    coopt = MODES["coopt"].replace(page_size=16, use_kernel=True)
    prompts = _engine_prompts(cfg)
    outs = {}
    for name in ("sync", "async"):
        eng = Engine(cfg, coopt, _ecfg(EngineConfig), params=params,
                     device="cpu")
        model = eng.model
        n = {"encode": 0, "first": 0, "steps": 0, "firsts": 0}
        encode, forward, build = model.encode, eng._forward, eng._build_step

        def counted_encode(p, frames, encode=encode, eng=eng, n=n):
            assert frames is eng._frames
            n["encode"] += 1
            return encode(p, frames)

        def counted_forward(kind, batch, lane_mask, forward=forward, n=n):
            n["first"] += "cross_mask" in batch
            n["steps"] += 1
            return forward(kind, batch, lane_mask)

        def counted_build(plan, device_feed=False, build=build, n=n):
            n["firsts"] += any(c.first for c in plan.prefill)
            return build(plan, device_feed)
        model.encode, eng._forward, eng._build_step = \
            counted_encode, counted_forward, counted_build
        try:
            if name == "sync":
                outs[name] = eng.generate(prompts, max_new_tokens=8)
            else:
                fe = AsyncEngine(eng, warmup=True)
                buckets = eng.scheduler.prefill_buckets
                assert fe.warmed_shapes == 1 + 2 * len(buckets) == 7
                assert eng.trace_counts == {"decode": 1,
                                            "prefill": 2 * len(buckets)}
                keys = [k for k in eng._runners if k[0] == "prefill"]
                assert sum(any(e[0] == "cross_mask" for e in k[1:])
                           for k in keys) == len(buckets)
                for k in ("encode", "first", "steps", "firsts"):
                    n[k] = 0                  # the warmup's dummy steps
                streams = [fe.submit(p, max_new_tokens=8) for p in prompts]
                fe.run_until_idle()
                fe.close()
                assert eng.aot_misses == 0
                outs[name] = [list(s.req.output) for s in streams]
        finally:
            del model.encode
        assert n["encode"] == n["first"] == n["firsts"] > 0
        assert n["steps"] > n["first"]
    assert outs["async"] == outs["sync"]


def test_pack_prefill_raises():
    """Packing needs ``length`` to be the only per-lane state; whisper's
    cross K/V are per lane, so ``pack_prefill`` raises the JAX engine's
    ValueError."""
    with pytest.raises(ValueError, match="pack_prefill unsupported"):
        Engine(get_config(ARCH), MODES["coopt"],
               EngineConfig(pack_prefill=True), params=_weights()[1],
               device="cpu")


def test_main_serves_whisper(capsys):
    """``--arch whisper-small --reduced`` serves through the launcher, sync
    and async (no step misses a runner), every request finished."""
    import json
    from repro_torch.launch import serve
    base = ["--arch", "whisper-small", "--reduced", "--device", "cpu",
            "--requests", "3", "--max-new-tokens", "3", "--lanes", "2",
            "--max-len", "128", "--use-kernel"]
    for extra in ([], ["--async", "--assert-aot"]):
        serve.main(base + extra)
        out = json.loads(capsys.readouterr().out)
        assert out["generated_tokens"] == 9 and out["rejected"] == 0
