"""The port's recurrent families, griffin (recurrentgemma-9b: RG-LRU + local
attention) and rwkv6 (rwkv6-7b: attention-free), against the JAX package on
reduced configs with the same weights (``params_from_numpy``) and
numpy-seeded inputs: the models' step logits and recurrent state, the
RG-LRU scan and the wkv recurrence, the pad mask, and the engine's
recurrent-state machinery (reset or restore at admission, snapshots at page
boundaries, the prefix gate) through the twins of
``tests/test_unified_families.py``'s and ``tests/test_rwkv_recurrence.py``'s
cells. griffin also runs at head_dim 256, its full-size width, so its local
attention reaches K1-K4 (their plain versions here) at D 256.

``test_preempt_and_resume_token_identical`` runs both families: the rwkv6
cell fails in the JAX package itself (its resumed request parts from the
unconstrained run), so each family's tight engine is held to its own
roomy run, not to the JAX engine."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models.rwkv6 import RWKV6Model as JRWKV6Model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch.configs import CacheConfig, get_config  # noqa: E402
from repro_torch.core.coopt import MODES, ORIGINAL  # noqa: E402
from repro_torch.core.opt_kv import identity_slots  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.griffin import GriffinModel, _assoc_scan  # noqa: E402
from repro_torch.models.rwkv6 import RWKV6Model  # noqa: E402
from repro_torch.serving import AsyncEngine, Engine, EngineConfig  # noqa: E402

GRIFFIN, RWKV = "recurrentgemma-9b-reduced", "rwkv6-7b-reduced"
ARCHS = [GRIFFIN, RWKV]
# The dense family's logit tolerance (tests/test_torch_model.py): a few bf16
# ulps of |logit| < 4 through the layers, plus an fp8 code step with Opt-KV.
LOGIT_ATOL = 0.1
# Carried state: 5% of the leaf's largest magnitude, the JAX package's own
# bound between its chunked and monolithic prefill
# (tests/test_unified_families.py); bf16 matmuls part by an ulp upstream.
STATE_RTOL = 0.05
# Greedy streams may part only where the JAX logits' best two lie within
# 0.1 (tests/test_torch_engine.py).
NEAR_TIE = 0.1
# (mode, use_kernel) pairs the engine cells run: coopt through the kernel
# wrappers (their plain versions on CPU tensors), original (bf16) plain
ENGINE_MODES = [("coopt", True), ("original", False)]


def _cfgs(arch, head_dim=None):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if head_dim:
        cfg, jcfg = cfg.replace(head_dim=head_dim), \
            jcfg.replace(head_dim=head_dim)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _weights(arch, head_dim=None):
    """(JAX params, the port's params on the CPU) from one JAX init."""
    cfg, jcfg = _cfgs(arch, head_dim)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                      "cpu")


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _assert_state_close(got, want, what):
    x, y = _np(want), _np(got)
    np.testing.assert_allclose(y, x, atol=STATE_RTOL * max(np.abs(x).max(),
                                                           1.0),
                               err_msg=what)


def test_configs_keep_the_published_widths():
    rg, rw = get_config("recurrentgemma-9b"), get_config("rwkv6-7b")
    assert (rg.family, rg.num_layers, rg.head_dim, rg.num_kv_heads,
            rg.q_per_kv, rg.local_window, rg.lru_width) == \
        ("griffin", 38, 256, 1, 16, 2048, 4096)
    assert (rw.family, rw.num_layers, rw.num_heads, rw.head_dim) == \
        ("rwkv6", 32, 64, 64)
    m = get_model(rg)
    assert isinstance(m, GriffinModel)
    assert (m.n_periods, m.n_trail, m.n_rec, m.n_attn) == (12, 2, 26, 12)
    assert isinstance(get_model(rw), RWKV6Model)


# ---------------------------------------------------------------- models --
def _steps(rng, vocab):
    """Three engine-style steps on two lanes of a lane-identity pool with
    16-token pages (8 a lane): lane 0 prefills 96 tokens, then a chunk of 8
    and a decode (105 positions: past griffin-reduced's window of 64 and
    its sink page), lane 1 prefills 40 (56 pad columns), then a decode
    column padded to the chunk (7 pad columns) and a decode. Pads repeat
    the last position, write nowhere (slot -1) and are off in
    ``pad_mask``."""
    P_lane, ps, S = 8, 16, 96
    lens = [96, 40]
    toks = rng.integers(0, vocab, (2, S)).astype(np.int32)
    pos = np.stack([np.minimum(np.arange(S), n - 1) for n in lens])
    slot = np.stack([np.where(np.arange(S) < n, b * P_lane * ps + pos[b], -1)
                     for b, n in enumerate(lens)])
    yield "prefill", dict(tokens=toks, positions=pos, slot_idx=slot,
                          cache_len=np.array(lens),
                          last_pos=np.array([n - 1 for n in lens]),
                          pad_mask=np.stack([np.arange(S) < n
                                             for n in lens]))
    S2 = 8
    toks2 = rng.integers(0, vocab, (2, S2)).astype(np.int32)
    pos2 = np.stack([96 + np.arange(S2), np.full(S2, 40)])
    slot2 = np.stack([pos2[0], np.r_[P_lane * ps + 40, [-1] * (S2 - 1)]])
    yield "prefill", dict(tokens=toks2, positions=pos2, slot_idx=slot2,
                          cache_len=np.array([104, 41]),
                          last_pos=np.array([S2 - 1, 0]),
                          pad_mask=np.stack([np.ones(S2, bool),
                                             np.arange(S2) < 1]))
    tok3 = rng.integers(0, vocab, (2, 1)).astype(np.int32)
    yield "decode", dict(token=tok3, positions=np.array([[104], [41]]),
                         slot_idx=np.array([[104], [P_lane * ps + 41]]),
                         cache_len=np.array([105, 42]))


def _batches(host):
    jb, tb = {}, {}
    for k, v in host.items():
        v = np.asarray(v) if v.dtype == bool else np.asarray(v, np.int32)
        jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v.copy())
    return jb, tb


@pytest.mark.parametrize("mode,use_kernel", ENGINE_MODES)
@pytest.mark.parametrize("arch,head_dim", [(GRIFFIN, None), (GRIFFIN, 256),
                                           (RWKV, None)])
def test_step_logits_and_state_match_jax(arch, head_dim, mode, use_kernel):
    """Every step's logits within LOGIT_ATOL of the JAX model's (its jnp
    path) and every recurrent leaf within STATE_RTOL, through padded
    chunks, a windowed continuation and a decode. griffin at head_dim 256
    runs its attention at D 256 (G 4 at this width)."""
    cfg, jcfg = _cfgs(arch, head_dim)
    jparams, params = _weights(arch, head_dim)
    coopt = MODES[mode].replace(page_size=16, use_kernel=use_kernel)
    jcoopt = JMODES[mode].replace(page_size=16)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    cache = model.init_cache(2, 128, coopt, device="cpu")
    jcache = jmodel.init_cache(2, 128, jcoopt)
    for kind, host in _steps(np.random.default_rng(0), cfg.vocab_size):
        jb, tb = _batches(host)
        step = "prefill" if kind == "prefill" else "decode_step"
        jl, jcache = getattr(jmodel, step)(jparams, jb, jcache, jcoopt)
        tl, cache = getattr(model, step)(params, tb, cache, coopt)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGIT_ATOL)
        for leaf in model.recurrent_leaves:
            _assert_state_close(cache[leaf], jcache[leaf], f"{kind} {leaf}")
        np.testing.assert_array_equal(cache["length"].numpy(),
                                      np.asarray(jcache["length"]))


@pytest.mark.parametrize("arch,head_dim", [(GRIFFIN, None), (GRIFFIN, 256),
                                           (RWKV, None)])
def test_full_prompt_prefill_matches_jax(arch, head_dim):
    """The whole-prompt prefill (no positions; griffin's local attention is
    the plain ``causal_attention`` over its window) at 80 tokens, past the
    window of 64: logits within LOGIT_ATOL, state within STATE_RTOL."""
    cfg, jcfg = _cfgs(arch, head_dim)
    jparams, params = _weights(arch, head_dim)
    coopt = MODES["coopt"].replace(page_size=16)
    jcoopt = JMODES["coopt"].replace(page_size=16)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 80)).astype(np.int32)
    jmodel, model = jget_model(jcfg), get_model(cfg)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            jmodel.init_cache(2, 128, jcoopt), jcoopt)
    tl, c = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                          model.init_cache(2, 128, coopt, device="cpu"),
                          coopt)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGIT_ATOL)
    for leaf in model.recurrent_leaves:
        _assert_state_close(c[leaf], jc[leaf], leaf)


@pytest.mark.parametrize("S", [2, 97])
def test_assoc_scan_matches_jax(S):
    """The log-depth scan (``_assoc_scan``, ``jax.lax.associative_scan``'s
    tree in plain PyTorch) of h_t = a_t h_{t-1} + b_t on the same f32
    inputs: within 2 f32 ulps of the JAX scan (the same tree of operations;
    XLA may contract a multiply-add)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 64)).astype(np.float32)
    b = rng.standard_normal((2, S, 64)).astype(np.float32)

    def comb(u, v):
        return u[0] * v[0], v[0] * u[1] + v[1]
    _, want = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                       axis=1)
    _, got = _assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_max_ulp(got.numpy(), _np(want), maxulp=2)


@pytest.mark.parametrize("S", [1, 64])
def test_rg_lru_matches_jax(S):
    """The RG-LRU against the JAX ``_rg_lru`` on the same bf16 inputs and
    f32 state, a fifth of the columns padded: y and the final state within
    1e-3 of their largest magnitude (a bf16 gate projection that rounds
    one ulp apart moves its a_t by up to a few per cent; the scan itself
    is held above)."""
    cfg, jcfg = _cfgs(GRIFFIN)
    jparams, params = _weights(GRIFFIN)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
    valid = rng.random((2, S)) < 0.8
    jpl = jax.tree.map(lambda a: a[0], jparams["rec"])
    pl = {k: v[0] for k, v in params["rec"].items()}
    jy, jh = jget_model(jcfg)._rg_lru(jpl, jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(h0), jnp.asarray(valid))
    y, h = get_model(cfg)._rg_lru(pl, torch.from_numpy(x).to(torch.bfloat16),
                                  torch.from_numpy(h0),
                                  torch.from_numpy(valid))
    for got, want in ((y, jy), (h, jh)):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want,
                                   atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_mask_freezes_the_recurrence(arch):
    """A continuation chunk of 10 tokens padded to 16 (pad_mask off, last
    position 9) leaves the same recurrent state and logits as the same 10
    tokens unpadded (within 1e-3 of the leaf's largest magnitude: the
    padded and unpadded matmuls and scans may round differently), while
    the same padded chunk with its padding taken as tokens moves the state
    by far more: a padded column that advanced the state would fail."""
    cfg, _ = _cfgs(arch)
    _, params = _weights(arch)
    model = get_model(cfg)
    coopt = ORIGINAL.replace(page_size=16)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, 74)).astype(np.int32)
    first = dict(tokens=toks[:, :64], positions=np.arange(64)[None],
                 slot_idx=np.arange(64)[None], cache_len=np.array([64]),
                 last_pos=np.array([63]))

    def run(S, pad, lp):
        cache = model.init_cache(1, 128, coopt, device="cpu")
        _, cache = model.prefill(params, _batches(first)[1], cache, coopt)
        tok = np.zeros((1, S), np.int32)
        tok[0, :10] = toks[0, 64:]
        host = dict(tokens=tok,
                    positions=np.minimum(64 + np.arange(S), 73)[None],
                    slot_idx=np.where(np.arange(S) < 10, 64 + np.arange(S),
                                      -1)[None],
                    cache_len=np.array([74]), last_pos=np.array([lp]))
        if pad:
            host["pad_mask"] = (np.arange(S) < 10)[None]
        return model.prefill(params, _batches(host)[1], cache, coopt)

    want_l, want = run(10, False, 9)
    got_l, got = run(16, True, 9)
    bad_l, bad = run(16, False, 15)
    np.testing.assert_allclose(_np(got_l), _np(want_l), atol=LOGIT_ATOL)
    for leaf in model.recurrent_leaves:
        x = _np(want[leaf])
        tol = 1e-3 * max(np.abs(x).max(), 1.0)
        np.testing.assert_allclose(_np(got[leaf]), x, atol=tol, err_msg=leaf)
        assert np.abs(_np(bad[leaf]) - x).max() > 10 * tol, leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_state_threads_across_chunks(arch):
    """Twin of the JAX cell: a prompt fed as 3 continuation chunks (state
    after chunk k = input state of chunk k+1) matches the monolithic
    prefill, final logits and recurrent state within the reference's 5%;
    the chunked run also matches the JAX monolithic prefill."""
    cfg, jcfg = _cfgs(arch)
    jparams, params = _weights(arch)
    m, jm = get_model(cfg), jget_model(jcfg)
    B, S, C = 2, 48, 16
    coopt, jcoopt = ORIGINAL, JMODES["original"]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    mono_l, mono = m.prefill(params, {"tokens": torch.from_numpy(toks)},
                             m.init_cache(B, S + 16, coopt, device="cpu"),
                             coopt)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(B, S + 16, jcoopt), jcoopt)
    ch = m.init_cache(B, S + 16, coopt, device="cpu")
    P_total = ch["kv"].shape[2] if "kv" in ch else 1     # rwkv6: no pool
    for i in range(0, S, C):
        pos = torch.arange(i, i + C, dtype=torch.int32)[None].expand(B, C)
        ch_l, ch = m.prefill(params, {
            "tokens": torch.from_numpy(toks[:, i:i + C]), "positions": pos,
            "slot_idx": identity_slots(B, pos, P_total, coopt.page_size),
            "cache_len": torch.full((B,), i + C, dtype=torch.int32)},
            ch, coopt)
    for ref_l, ref in ((mono_l, mono), (jl, jc)):
        a = _np(ref_l)
        np.testing.assert_allclose(_np(ch_l), a,
                                   atol=STATE_RTOL * max(np.abs(a).max(), 1))
        for leaf in m.recurrent_leaves:
            _assert_state_close(ch[leaf], ref[leaf], leaf)


# ---------------------------------------- twins of test_rwkv_recurrence --
def _wkv_inputs(seed, B, S, H, D, ww_lo=-3.0, ww_hi=1.0, u_scale=0.1):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    ww = rng.uniform(ww_lo, ww_hi, (B, S, H, D)).astype(np.float32)
    w = np.exp(-np.exp(ww)).astype(np.float32)   # extreme decays underflow
    u = (rng.standard_normal((H, D)) * u_scale).astype(np.float32)
    return r, k, v, w, u


def _seq(r, k, v, w, u, s0):
    st, outs = s0, []
    for t in range(r.shape[1]):
        o, st = RWKV6Model._wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], u,
                                     st)
        outs.append(o)
    return torch.stack(outs, 1), st


@pytest.mark.parametrize("seed,ww_hi", [(0, -1.0), (1, 0.5), (2, 2.0),
                                        (3, 4.0)])
def test_chunked_equals_sequential(seed, ww_hi):
    """The chunked wkv form equals the O(1) step recurrence (atol 2e-3, the
    JAX cell's) down to decays of exp(-exp(4)), and equals the JAX chunked
    form within 1e-3 of each value plus 1e-5 of the largest: the decays'
    exponents are sums of log-decays as large as e^4 ~ 55 each, summed in
    another order, and a last-bit difference of such a sum (~1e-4 over a
    chunk) moves its exp by that share."""
    r, k, v, w, u = _wkv_inputs(seed, 2, 64, 2, 4, ww_hi=ww_hi)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    s0 = torch.zeros((2, 2, 4, 4))
    seq_o, seq_s = _seq(*t, s0)
    ch_o, ch_s = RWKV6Model._wkv_chunked(*t, s0)
    np.testing.assert_allclose(ch_o.numpy(), seq_o.numpy(), atol=2e-3)
    np.testing.assert_allclose(ch_s.numpy(), seq_s.numpy(), atol=2e-3)
    j_o, j_s = JRWKV6Model._wkv_chunked(*(jnp.asarray(a)
                                          for a in (r, k, v, w, u)),
                                        jnp.zeros((2, 2, 4, 4)))
    for got, want in ((ch_o, j_o), (ch_s, j_s)):
        want = _np(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max())


def test_chunk_boundary_state_handoff():
    """Chunked prefix state + one sequential step == the step recurrence
    throughout (atol 1e-4, the JAX cell's)."""
    r, k, v, w, _ = _wkv_inputs(7, 1, 33, 2, 8, ww_lo=-2.0, ww_hi=2.0)
    t = [torch.from_numpy(a) for a in (r, k, v, w)]
    u = torch.zeros((2, 8))
    s0 = torch.zeros((1, 2, 8, 8))
    _, st32 = RWKV6Model._wkv_chunked(*(a[:, :32] for a in t), u, s0)
    o_step, _ = RWKV6Model._wkv_step(*(a[:, 32] for a in t), u, st32)
    seq_o, _ = _seq(*t, u, s0)
    np.testing.assert_allclose(o_step.numpy(), seq_o[:, 32].numpy(),
                               atol=1e-4)


# ---------------------------------------------------------------- engine --
def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n,
                                                dtype=np.int32)


def _coopt(mode, use_kernel, page_size=64):
    return MODES[mode].replace(use_kernel=use_kernel, page_size=page_size)


def _record(eng):
    """Log every emitted token with its logits row: {req_id: [(tok, row)]}."""
    log, last = {}, {}
    sample, emit = eng._sample, eng._emit

    def _sample(logits):
        last["logits"] = _np(logits)
        return sample(logits)

    def _emit(req, tok, now, first):
        log.setdefault(req.req_id, []).append((tok, last["logits"][req.lane]))
        return emit(req, tok, now, first=first)

    eng._sample, eng._emit = _sample, _emit
    return log


def _held_to_jax(outs, want):
    """Each port stream equals the JAX engine's (``want``: recorded rows by
    request id 1000 + i) or parts once, at a near-tie of the JAX logits."""
    assert len(outs) == len(want)
    for i, mine in enumerate(outs):
        seq = want[1000 + i]
        assert len(mine) == len(seq)
        for j, (tok, row) in enumerate(seq):
            if mine[j] == tok:
                continue
            top = np.sort(row)[::-1]
            assert top[0] - top[1] <= NEAR_TIE, (i, j, top[:2])
            assert row[mine[j]] >= top[0] - NEAR_TIE, (i, j)
            break


def _jax_rows(arch, mode, ecfg, prompts, max_new, page_size=64):
    """The JAX engine's (jnp path) emitted (token, logits row) by request,
    on the same weights; and the engine."""
    cfg, jcfg = _cfgs(arch)
    jeng = JEngine(jcfg, JMODES[mode].replace(page_size=page_size),
                   JEngineConfig(**ecfg), params=_weights(arch)[0])
    rows = _record(jeng)
    jeng.generate(prompts, max_new_tokens=max_new)
    return rows, jeng


def _engine(arch, mode, use_kernel, page_size=64, **ecfg):
    cfg, _ = _cfgs(arch)
    return Engine(cfg, _coopt(mode, use_kernel, page_size),
                  EngineConfig(**ecfg), params=_weights(arch)[1],
                  device="cpu")


def _restores(eng):
    """Spy on the engine's first chunks: [(start, restored from a
    snapshot)]."""
    seen, fn = [], eng._reset_or_restore_state

    def spy(chunks):
        seen.extend((c.start, c.start > 0) for c in chunks if c.first)
        return fn(chunks)
    eng._reset_or_restore_state = spy
    return seen


@pytest.mark.parametrize("mode,use_kernel", ENGINE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_vs_whole_prompt_greedy_parity(arch, mode, use_kernel):
    """Small buckets cut the prompt into page-aligned chunks, big ones serve
    it whole: the greedy tokens are identical, and equal the JAX engine's
    whole-prompt run or part at a near-tie."""
    cfg, _ = _cfgs(arch)
    prompt = _prompt(cfg, 100, seed=1)
    outs = []
    for buckets in ((16, 32), (64, 128, 256)):
        eng = _engine(arch, mode, use_kernel, num_lanes=2, max_len=256,
                      prefill_buckets=buckets)
        outs.append(eng.generate([prompt], max_new_tokens=8)[0])
        assert len(outs[-1]) == 8
    assert outs[0] == outs[1]
    want, _ = _jax_rows(arch, mode, dict(num_lanes=2, max_len=256,
                                         prefill_buckets=(64, 128, 256)),
                        [prompt], 8)
    _held_to_jax(outs[1:], want)


@pytest.mark.parametrize("mode,use_kernel", ENGINE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_hits_on_repeated_prompt(arch, mode, use_kernel):
    """A repeated prompt of more than a page prefix-hits, its first chunk
    starting past the hit and restoring the lane's state from a snapshot,
    with greedy tokens identical warm and cold."""
    cfg, _ = _cfgs(arch)
    prompt = _prompt(cfg, 100, seed=2)
    eng = _engine(arch, mode, use_kernel, num_lanes=2, max_len=256,
                  prefill_buckets=(16, 32, 64, 128))
    seen = _restores(eng)
    cold = eng.generate([prompt], max_new_tokens=4)[0]
    warm = eng.generate([prompt], max_new_tokens=4)[0]
    assert eng.stats.prefix_cache_hits > 0
    assert seen == [(0, False), (64, True)]
    assert cold == warm
    if mode == "original":
        want, _ = _jax_rows(arch, mode, dict(
            num_lanes=2, max_len=256, prefill_buckets=(16, 32, 64, 128)),
            [prompt], 4)
        _held_to_jax([cold], want)


@pytest.mark.parametrize("mode,use_kernel", ENGINE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_lane_reuse_does_not_leak_state(arch, mode, use_kernel):
    """A request admitted on a lane a previous request used sees zero
    state, not the previous occupant's: its tokens equal a fresh engine's
    (the prefix cache off, so nothing is restored)."""
    cfg, _ = _cfgs(arch)
    ecfg = dict(num_lanes=1, max_len=256, prefill_buckets=(16, 32, 64),
                cache=CacheConfig(enable_prefix_cache=False))
    p1, p2 = _prompt(cfg, 40, seed=7), _prompt(cfg, 40, seed=8)
    eng = _engine(arch, mode, use_kernel, **ecfg)
    eng.generate([p1], max_new_tokens=4)                 # dirties lane 0
    reused = eng.generate([p2], max_new_tokens=4)[0]
    fresh = _engine(arch, mode, use_kernel, **ecfg).generate(
        [p2], max_new_tokens=4)[0]
    assert reused == fresh
    assert not eng._state_cache


@pytest.mark.parametrize("mode,use_kernel", ENGINE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_prefix_hit_with_multi_page_chunk(arch, mode, use_kernel):
    """A prompt prefilled as ONE multi-page chunk has a snapshot only at the
    chunk's end; matching trims to that boundary (the deepest gated hash):
    all 3 full pages reused, tokens equal warm and cold, and the JAX
    engine counts the same hits."""
    cfg, _ = _cfgs(arch)
    prompt = _prompt(cfg, 200, seed=11)              # 3 full pages + tail
    ecfg = dict(num_lanes=2, max_len=256, prefill_buckets=(64, 128, 256))
    eng = _engine(arch, mode, use_kernel, **ecfg)
    seen = _restores(eng)
    cold = eng.generate([prompt], max_new_tokens=4)[0]
    warm = eng.generate([prompt], max_new_tokens=4)[0]
    assert eng.stats.prefix_cache_hits >= 3
    assert seen == [(0, False), (192, True)]
    assert cold == warm
    if mode == "original":
        want, jeng = _jax_rows(arch, mode, ecfg, [prompt], 4)
        _held_to_jax([cold], want)
        jeng.generate([prompt], max_new_tokens=4)
        assert jeng.stats.prefix_cache_hits == eng.stats.prefix_cache_hits


def test_snapshot_cache_is_capped_and_gates_the_match():
    """``state_cache_entries`` caps the snapshots (oldest out first); a
    prompt whose snapshot was evicted no longer prefix-hits (the manager's
    gate refuses pages it cannot resume), and serves the same tokens."""
    cfg, _ = _cfgs(GRIFFIN)
    a, b = _prompt(cfg, 100, seed=20), _prompt(cfg, 100, seed=21)
    eng = _engine(GRIFFIN, "original", False, num_lanes=1, max_len=256,
                  prefill_buckets=(64, 128), state_cache_entries=1)
    cold = eng.generate([a], max_new_tokens=3)[0]
    eng.generate([b], max_new_tokens=3)
    assert len(eng._state_cache) == 1
    hits = eng.stats.prefix_cache_hits
    assert eng.generate([a], max_new_tokens=3)[0] == cold
    assert eng.stats.prefix_cache_hits == hits


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,use_kernel", ENGINE_MODES)
def test_preempt_and_resume_token_identical(mode, use_kernel, arch):
    """griffin and rwkv6: an over-subscribed pool completes through
    preemption with tokens identical to an unconstrained run (the resumed
    request's state zeroed or restored at re-admission)."""
    cfg, _ = _cfgs(arch)
    prompts = [_prompt(cfg, 50, seed=3 + i) for i in range(2)]
    tight = _engine(arch, mode, use_kernel, num_lanes=2, max_len=128,
                    prefill_buckets=(16, 32, 64, 128))
    out_t = tight.generate(prompts, max_new_tokens=20)
    roomy = _engine(arch, mode, use_kernel, num_lanes=2, max_len=256,
                    prefill_buckets=(16, 32, 64, 128, 256))
    out_r = roomy.generate(prompts, max_new_tokens=20)
    assert tight.stats.preemptions > 0 and roomy.stats.preemptions == 0
    assert all(len(o) == 20 for o in out_t)
    assert out_t == out_r


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_prefill_raises(arch):
    """Packed rows are not lanes, and these families keep per-lane state:
    ``pack_prefill`` raises the JAX engine's ValueError."""
    cfg, _ = _cfgs(arch)
    with pytest.raises(ValueError, match="pack_prefill unsupported"):
        Engine(cfg, MODES["coopt"], EngineConfig(pack_prefill=True),
               device="cpu")


def _mixed_prompts(cfg):
    """Four prompts on 2 lanes, pages of 16: the first and third share a
    64-token prefix, which the first prefills as one chunk ending on a
    page boundary (a snapshot there), so the third, admitted when a lane
    frees, hits 4 pages and restores the snapshot; the second spans
    several chunks, the fourth is shorter than a page."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 64)
    a, b = (np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
            for n in (20, 9))
    return [a, rng.integers(0, cfg.vocab_size, 90), b,
            rng.integers(0, cfg.vocab_size, 7)]


@pytest.mark.parametrize("mode,use_kernel", ENGINE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax_engine(arch, mode, use_kernel):
    """Mixed steps, multi-chunk prompts, lane reuse and a prefix hit that
    restores a snapshot: greedy tokens equal the JAX engine's (its jnp
    path) or part only at a near-tie; the generated-token, prefix and
    mixed-step counts are equal."""
    cfg, _ = _cfgs(arch)
    ecfg = dict(num_lanes=2, max_len=160, prefill_buckets=(16, 32, 64))
    prompts = _mixed_prompts(cfg)
    want, jeng = _jax_rows(arch, mode, dict(ecfg), prompts, 8, page_size=16)
    eng = _engine(arch, mode, use_kernel, page_size=16, **ecfg)
    seen = _restores(eng)
    outs = eng.generate(prompts, max_new_tokens=8)
    _held_to_jax(outs, want)
    st, jst = eng.stats, jeng.stats
    assert st.generated_tokens == jst.generated_tokens == 32
    assert st.prefix_cache_queries == jst.prefix_cache_queries
    assert st.prefix_cache_hits == jst.prefix_cache_hits > 0
    assert st.mixed_steps == jst.mixed_steps
    assert any(restored for _, restored in seen)
    assert eng.scheduler.manager.audit() == []


@pytest.mark.parametrize("arch", ARCHS)
def test_async_engine_matches_sync(arch):
    """``AsyncEngine(warmup=True)`` (the step runners' bodies run eagerly
    on the CPU, ``pad_mask`` one more static input) serves the sync
    engine's tokens on the same requests, prefix hit and snapshot restore
    included, with no step missing a runner."""
    cfg, _ = _cfgs(arch)
    ecfg = dict(num_lanes=2, max_len=160, prefill_buckets=(16, 32, 64))
    prompts = _mixed_prompts(cfg)
    sync = _engine(arch, "coopt", True, page_size=16, **ecfg).generate(
        prompts, max_new_tokens=6)
    eng = _engine(arch, "coopt", True, page_size=16, **ecfg)
    fe = AsyncEngine(eng, warmup=True)
    try:
        streams = [fe.submit(p, max_new_tokens=6) for p in prompts]
        fe.run_until_idle()
    finally:
        fe.close()
    assert [list(s.req.output) for s in streams] == sync
    assert eng.aot_misses == 0 and eng.stats.prefix_cache_hits > 0
    assert "pad_mask" in next(r for r in eng._runners.values()
                              if r.kind == "prefill").inputs

