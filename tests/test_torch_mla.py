"""The port's MLA family (deepseek-v2-lite) against the JAX package on the
CPU: the dual-scale latent quantizer and pool write, the plain versions of
the latent kernels K5/K6/K7 against the Pallas kernels (interpret mode) and
the jnp oracles, the absorbed attention of ``models.mla``, the reduced
model's logits in all five modes, and ``Engine.generate`` greedy tokens and
stats counters. Inputs are numpy-seeded and handed to both packages.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cache import quant as jquant  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import CacheConfig as JCacheConfig  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.core.opt_kv import decode_page_select as jdecode_page_select  # noqa: E402
from repro.kernels import latent_chunk_prefill as jlc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_latent_decode as jld  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import visits as jvisits  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch.cache import quant  # noqa: E402
from repro_torch.configs import CacheConfig, get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.core.opt_kv import decode_page_select  # noqa: E402
from repro_torch.kernels import ops, ref, visits  # noqa: E402
from repro_torch.kernels.paged_latent_decode import (  # noqa: E402
    paged_latent_decode_ref, paged_latent_decode_visits_ref)
from repro_torch.models import get_model, mla  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

from test_torch_engine import _assert_same_or_near_tie, _record  # noqa: E402
from test_torch_model import _steps  # noqa: E402

ARCH = "deepseek-v2-lite-16b-reduced"
CFG = get_config(ARCH)
H, DN, DR = CFG.num_heads, CFG.qk_nope_head_dim, CFG.qk_rope_head_dim
R, DV = CFG.kv_lora_rank, CFG.v_head_dim
SCALE = 1.0 / math.sqrt(DN + DR)
# The latent kernels return f32: the plain versions, the Pallas kernels and
# the flat oracles all sum in f32 in other orders (online vs flat softmax),
# a few f32 ulps of outputs |o| < 4.
LATENT_ATOL = 1e-4
# Attention outputs after the w_uv expansion are bf16 (|o| < 2, ulp 2**-7);
# the jnp bodies and the port round their f32 sums to bf16 independently.
ATTN_ATOL = 2e-2
# Reduced-model logits, bf16 activations through 2 layers (one of them
# MoE), |logit| < 4: a few bf16 ulps (2**-6) as for the dense model
# (tests/test_torch_model.py), and with FP8 a one-ulp change of a latent
# element can move its fp8 code one step. The JAX model's scanned layer also
# rounds some latent scales (amax / 448) one f32 ulp away from the exact
# division both quantizers use eagerly. Measured: at most 0.031 without FP8
# and 0.088 with it.
LOGIT_ATOL = 0.125


def _i32(x):
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _f32(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x, np.float32).copy())


def _t2n(t):
    return t.float().numpy()


def _latent_pool(rng, PT, ps, fp8):
    """(jax pages, jax scales|None, torch pages, torch scales|None) of PT
    latent pages with the same values in both."""
    lat = rng.standard_normal((PT, ps, R + DR)).astype(np.float32)
    lat[..., R:] *= 4.0                       # k_rope on its own scale
    t = torch.from_numpy(lat)
    if fp8:
        q, sc = quant.quantize_latent(t, R)
        jq = jnp.asarray(q.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
        return jq, jnp.asarray(sc.numpy()), q, sc
    tb = t.to(torch.bfloat16)
    return jnp.asarray(tb.float().numpy(), jnp.bfloat16), None, tb, None


# ----------------------------------------------------------- quantizer ----
def test_quantize_latent_matches_jax_bytes():
    """Pool bytes and both scale columns equal the JAX quantizer's, and the
    dequantized latents agree exactly."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, R + DR)).astype(np.float32)
    x *= rng.uniform(1e-3, 300, (64, 1)).astype(np.float32)
    x[:, R:] *= 7.0
    x[0] = 0.0                                 # amax below eps
    x[1, :R] = 0.0                             # c_kv zero, k_rope not
    x[2, 0], x[2, R] = 448.0, -448.0           # scale 1 in both columns
    jb = jnp.asarray(x, jnp.bfloat16)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jquant.quantize_latent(jb, R)
    tq, ts = quant.quantize_latent(tb, R)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize_latent(tq, ts, R).numpy(),
        np.asarray(jquant.dequantize_latent(jq, js, R)))


@pytest.mark.parametrize("opt_kv", [False, True])
def test_latent_pool_write_matches_jax(opt_kv):
    """ops.latent_pool_write == the JAX scatter, bytes and scales, in place;
    slots < 0 are dropped here and wrapped onto the pool's last line there,
    so that line is excluded."""
    rng = np.random.default_rng(1)
    P, ps, B, S = 6, 16, 2, 8
    lat = rng.standard_normal((B, S, R + DR)).astype(np.float32)
    jl, tl = jnp.asarray(lat, jnp.bfloat16), torch.from_numpy(lat).bfloat16()
    slots = [[0, 5, -1, 17, 33, -1, 62, 2], [64, -1, 73, 74, 75, 80, 94, 1]]
    js, ts = _i32(slots)
    dt = (jnp.float8_e4m3fn, torch.float8_e4m3fn) if opt_kv else \
        (jnp.bfloat16, torch.bfloat16)
    jpool = jnp.zeros((P, ps, R + DR), dt[0])
    jsc = jnp.zeros((P, ps, 2), jnp.float32) if opt_kv else None
    tpool = torch.zeros((P, ps, R + DR), dtype=dt[1])
    tsc = torch.zeros((P, ps, 2)) if opt_kv else None
    jpool, jsc = jops.latent_pool_write(jpool, jsc, jl, js, opt_kv=opt_kv,
                                        lora_rank=R)
    out = ops.latent_pool_write(tpool, tsc, tl, ts, opt_kv=opt_kv,
                                lora_rank=R)
    assert out[0] is tpool
    n = P * ps - 1
    np.testing.assert_array_equal(
        tpool.view(torch.uint8).reshape(P * ps, -1).numpy()[:n],
        np.asarray(jpool).view(np.uint8).reshape(P * ps, -1)[:n])
    if opt_kv:
        np.testing.assert_array_equal(tsc.reshape(-1, 2).numpy()[:n],
                                      np.asarray(jsc).reshape(-1, 2)[:n])


# -------------------------------------------------------------- K5 / K7 ----
def _decode_case(fp8, window, sink, seed=2):
    rng = np.random.default_rng(seed)
    B, P_lane, ps = 3, 4, 16
    jlat, jsc, tlat, tsc = _latent_pool(rng, B * P_lane, ps, fp8)
    (jql, tql), (jqr, tqr) = (_f32(rng.standard_normal(s).astype(np.float32))
                              for s in ((B, H, R), (B, H, DR)))
    perm = rng.permutation(B * P_lane).reshape(B, P_lane)
    perm[2, -1] = -1                           # a -1 hole in lane 2
    jpt, tpt = _i32(perm)
    jcl, tcl = _i32([P_lane * ps, 37, 40])
    jphys, jlog = jdecode_page_select(jcl, jpt, ps, window=window,
                                      sink_pages=sink, opt_pa=True)
    tphys, tlog = decode_page_select(tcl, tpt, ps, window=window,
                                     sink_pages=sink, opt_pa=True)
    return (jql, jqr, jlat, jsc, jcl, jphys, jlog), \
        (tql, tqr, tlat, tsc, tcl, tphys, tlog)


@pytest.mark.parametrize("fp8", [True, False])
@pytest.mark.parametrize("window,sink", [(0, 0), (32, 1), (16, 2)])
def test_latent_decode_plain_matches_pallas_and_oracle(fp8, window, sink):
    """K5 plain vs the interpret kernel and the flat oracle (LATENT_ATOL);
    the port's oracle vs the JAX oracle."""
    j, t = _decode_case(fp8, window, sink)
    kw = dict(sm_scale=SCALE, opt_kv=fp8, window=window, sink_pages=sink)
    got = paged_latent_decode_ref(*t, **kw)
    kern = jld.paged_latent_decode(*j, interpret=True, **kw)
    oracle = jref.paged_latent_decode_ref(*j, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_t2n(got), np.asarray(kern), atol=LATENT_ATOL)
    np.testing.assert_allclose(_t2n(got), np.asarray(oracle),
                               atol=LATENT_ATOL)
    np.testing.assert_allclose(_t2n(ref.paged_latent_decode_ref(*t, **kw)),
                               np.asarray(oracle), atol=LATENT_ATOL)


def _shared_tables(seed=3):
    """Four lanes; lanes 0-2 share a 3-page prefix at the same slots."""
    rng = np.random.default_rng(seed)
    phys = rng.permutation(40)[:24].reshape(4, 6).astype(np.int32)
    phys[1:3, :3] = phys[0, :3]
    phys[3, 4:] = -1
    log = np.broadcast_to(np.arange(6, dtype=np.int32), (4, 6)).copy()
    log[3, 4:] = -1
    return phys, log


@pytest.mark.parametrize("fp8,window", [(True, 0), (False, 0), (True, 40)])
def test_latent_visit_plain_bit_identical_to_decode_plain(fp8, window):
    """K7 plain == K5 plain exactly (torch.equal) over a shared prefix, and
    K7 plain vs the JAX visit kernel in interpret mode (LATENT_ATOL)."""
    rng = np.random.default_rng(4)
    ps = 16
    phys, log = _shared_tables()
    jlat, jsc, tlat, tsc = _latent_pool(rng, 40, ps, fp8)
    (jql, tql), (jqr, tqr) = (_f32(rng.standard_normal(s).astype(np.float32))
                              for s in ((4, H, R), (4, H, DR)))
    jcl, tcl = _i32([90, 96, 60, 50])
    kw = dict(sm_scale=SCALE, opt_kv=fp8, window=window, sink_pages=1)
    tphys, tlog = torch.from_numpy(phys), torch.from_numpy(log)
    vp, vm, vl = visits.plan_visits(tphys, tlog)
    k7 = paged_latent_decode_visits_ref(tql, tqr, tlat, tsc, tcl, vp, vm, vl,
                                        **kw)
    k5 = paged_latent_decode_ref(tql, tqr, tlat, tsc, tcl, tphys, tlog, **kw)
    assert torch.equal(k7, k5)
    jvp, jvm, jvl = jvisits.plan_visits(jnp.asarray(phys), jnp.asarray(log))
    kern = jld.paged_latent_decode_visits(jql, jqr, jlat, jsc, jcl, jvp, jvm,
                                          jvl, interpret=True, **kw)
    np.testing.assert_allclose(_t2n(k7), np.asarray(kern), atol=LATENT_ATOL)


def test_ops_latent_decode_routes_visits_by_lane_count():
    """ops.paged_latent_decode takes the visit list (K7) for 1 < B <= 32
    with share_visits and the per-lane version (K5) otherwise; both agree
    bit for bit."""
    rng = np.random.default_rng(5)
    phys, log = _shared_tables()
    _, _, tlat, tsc = _latent_pool(rng, 40, 16, True)
    ql = torch.from_numpy(rng.standard_normal((4, H, R)).astype(np.float32))
    qr = torch.from_numpy(rng.standard_normal((4, H, DR)).astype(np.float32))
    cl = torch.tensor([90, 96, 60, 50], dtype=torch.int32)
    args = (ql, qr, tlat, tsc, cl, torch.from_numpy(phys),
            torch.from_numpy(log))
    a = ops.paged_latent_decode(*args, sm_scale=SCALE, opt_kv=True,
                                share_visits=True)
    b = ops.paged_latent_decode(*args, sm_scale=SCALE, opt_kv=True,
                                share_visits=False)
    assert torch.equal(a, b)


# ------------------------------------------------------------------ K6 ----
def _chunk_case(fp8, seed=11):
    """Lane 0 a chunk at [24, 32); lane 1 a decode lane (one token at 40,
    padding clamped to it) whose final page is a -1 hole."""
    rng = np.random.default_rng(seed)
    B, P, ps, S = 2, 4, 16, 8
    jlat, jsc, tlat, tsc = _latent_pool(rng, B * P, ps, fp8)
    (jql, tql), (jqr, tqr) = (_f32(rng.standard_normal(s).astype(np.float32))
                              for s in ((B, S, H, R), (B, S, H, DR)))
    pt = np.arange(B * P).reshape(B, P)
    pt[1, P - 1] = -1
    (jpos, tpos), (jpt, tpt) = _i32(np.stack([np.arange(24, 32),
                                              np.full(S, 40)])), _i32(pt)
    return (jql, jqr, jpos, jlat, jsc, jpt), (tql, tqr, tpos, tlat, tsc, tpt)


@pytest.mark.parametrize("fp8", [True, False])
@pytest.mark.parametrize("window,sink", [(0, 0), (32, 1)])
def test_latent_chunk_plain_matches_pallas_and_oracle(fp8, window, sink):
    """K6 plain (unpacked) vs the interpret kernel and the flat oracle
    (LATENT_ATOL); the port's oracle vs the JAX oracle."""
    j, t = _chunk_case(fp8)
    kw = dict(sm_scale=SCALE, opt_kv=fp8, window=window, sink_pages=sink)
    got = ops.latent_chunk_prefill(*t, **kw)
    kern = jlc.latent_chunk_prefill(*j, interpret=True, **kw)
    oracle = jref.latent_chunk_prefill_ref(*j, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_t2n(got), np.asarray(kern), atol=LATENT_ATOL)
    np.testing.assert_allclose(_t2n(got), np.asarray(oracle),
                               atol=LATENT_ATOL)
    np.testing.assert_allclose(_t2n(ref.latent_chunk_prefill_ref(*t, **kw)),
                               np.asarray(oracle), atol=LATENT_ATOL)


def test_latent_chunk_plain_packed_matches_pallas():
    """Concat-prefill packing: two prompts share one row as segments (seg
    0: 20 tokens on slots 0-1, seg 1: 10 tokens on slot 2 with page_base
    restarting at 0, 2 pad columns of segment -1). K6 plain vs the
    interpret kernel (LATENT_ATOL) on the real rows; pad rows exactly 0."""
    rng = np.random.default_rng(8)
    ps, S = 16, 32
    jlat, jsc, tlat, tsc = _latent_pool(rng, 6, ps, True)
    (jql, tql), (jqr, tqr) = (_f32(rng.standard_normal(s).astype(np.float32))
                              for s in ((1, S, H, R), (1, S, H, DR)))
    pos = np.concatenate([np.arange(20), np.arange(10), [9, 9]])[None]
    seg = np.concatenate([np.zeros(20), np.ones(10), [-1, -1]])[None]
    pt, pseg, pbase = [[4, 1, 3, -1]], [[0, 0, 1, 0]], [[0, 1, 0, 0]]
    j, t = zip(*(_i32(x) for x in (pos, seg, pt, pseg, pbase)))
    got = ops.latent_chunk_prefill(tql, tqr, t[0], tlat, tsc, t[2],
                                   sm_scale=SCALE, opt_kv=True, seg_q=t[1],
                                   page_seg=t[3], page_base=t[4])
    kern = jlc.latent_chunk_prefill(jql, jqr, j[0], jlat, jsc, j[2],
                                    sm_scale=SCALE, opt_kv=True,
                                    interpret=True, seg_q=j[1],
                                    page_seg=j[3], page_base=j[4])
    np.testing.assert_allclose(_t2n(got)[:, :30], np.asarray(kern)[:, :30],
                               atol=LATENT_ATOL)
    assert torch.all(got[:, 30:] == 0)


# ------------------------------------------------- models.mla attention ----
def _absorb_params(rng):
    return {k: rng.standard_normal((R, H * d)).astype(np.float32) * 0.05
            for k, d in (("w_uk", DN), ("w_uv", DV))}


@pytest.mark.parametrize("fp8", [True, False])
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mla_paged_decode_and_chunk_attention_match_jax(fp8, window,
                                                        use_kernel):
    """mla_paged_decode and mla_chunk_attention (the port's plain bodies,
    or its kernel wrappers' plain versions) vs the JAX jnp bodies, within
    ATTN_ATOL after the bf16 w_uv expansion."""
    rng = np.random.default_rng(13)
    B, P, ps, S = 2, 4, 16, 8
    jlat, jsc, tlat, tsc = _latent_pool(rng, B * P, ps, fp8)
    w = _absorb_params(rng)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()}
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in w.items()}
    pt = np.arange(B * P).reshape(B, P)
    pt[1, P - 1] = -1
    jpt, tpt = _i32(pt)
    jco = JMODES["coopt" if fp8 else "original"]
    co = MODES["coopt" if fp8 else "original"].replace(use_kernel=use_kernel)
    # decode
    qn = rng.standard_normal((B, H, DN)).astype(np.float32)
    qr = rng.standard_normal((B, H, DR)).astype(np.float32)
    jcl, tcl = _i32([P * ps, 37])
    want = jmla.mla_paged_decode(
        jnp.asarray(qn, jnp.bfloat16), jnp.asarray(qr, jnp.bfloat16), jlat,
        jsc, jcl, jp, jget_config(ARCH), jco, window=window, sink_pages=1,
        page_table=jpt)
    got = mla.mla_paged_decode(
        torch.from_numpy(qn).bfloat16(), torch.from_numpy(qr).bfloat16(),
        tlat, tsc, tcl, tp, CFG, co, window=window, sink_pages=1,
        page_table=tpt)
    np.testing.assert_allclose(_t2n(got), np.asarray(want, np.float32),
                               atol=ATTN_ATOL)
    # chunk
    qn = rng.standard_normal((B, S, H, DN)).astype(np.float32)
    qr = rng.standard_normal((B, S, H, DR)).astype(np.float32)
    jpos, tpos = _i32(np.stack([np.arange(24, 32), np.full(S, 40)]))
    want = jmla.mla_chunk_attention(
        jnp.asarray(qn, jnp.bfloat16), jnp.asarray(qr, jnp.bfloat16), jlat,
        jsc, jpos, jpt, jp, jget_config(ARCH), jco, window=window,
        sink_pages=1)
    got = mla.mla_chunk_attention(
        torch.from_numpy(qn).bfloat16(), torch.from_numpy(qr).bfloat16(),
        tlat, tsc, tpos, tpt, tp, CFG, co, window=window, sink_pages=1)
    np.testing.assert_allclose(_t2n(got), np.asarray(want, np.float32),
                               atol=ATTN_ATOL)


# ---------------------------------------------------------------- model ----
@pytest.fixture(scope="module")
def weights():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(CFG, jax.tree.map(np.asarray, jparams),
                                      "cpu")


def test_param_tree_has_two_segments(weights):
    """One dense-FFN layer, then MoE layers; the count equals JAX's."""
    _, params = weights
    dense, moe = params["segments"]
    assert dense["wg"].shape[0] == 1 and "wg_e" not in dense
    assert moe["wg_e"].shape == (1, 4, 256, 128) and "wg" not in moe
    assert get_model(CFG).param_count() == \
        jget_model(jget_config(ARCH)).param_count()
    cache = get_model(CFG).init_cache(2, 64, MODES["coopt"], device="cpu")
    assert cache["kv"].shape == (2, 2, 64, R + DR)
    assert cache["scale"].shape == (2, 2, 64, 2)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_logits_match_jax(weights, mode, use_kernel):
    """Logits of a chunked prefill, a continuation chunk beside a decode
    lane and a decode step within LOGIT_ATOL of the JAX model's (JAX on its
    jnp path), in all five modes; with ``use_kernel`` the port runs its
    kernel wrappers, which on CPU tensors take their plain versions."""
    jparams, params = weights
    coopt = MODES[mode].replace(page_size=16, use_kernel=use_kernel)
    jcoopt = JMODES[mode].replace(page_size=16)
    model, jmodel = get_model(CFG), jget_model(jget_config(ARCH))
    cache = model.init_cache(2, 64, coopt, device="cpu")
    jcache = jmodel.init_cache(2, 64, jcoopt)
    for kind, host in _steps(np.random.default_rng(0), CFG.vocab_size):
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in host.items()}
        tb = {k: torch.from_numpy(np.asarray(v, np.int32))
              for k, v in host.items()}
        step = "prefill" if kind == "prefill" else "decode_step"
        jl, jcache = getattr(jmodel, step)(jparams, jb, jcache, jcoopt)
        tl, cache = getattr(model, step)(params, tb, cache, coopt)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   atol=LOGIT_ATOL)
        np.testing.assert_array_equal(cache["length"].numpy(),
                                      np.asarray(jcache["length"]))


def test_full_prefill_matches_jax(weights):
    """The non-chunked prefill (latent expanded to per-head K/V, full causal
    attention) matches JAX."""
    jparams, params = weights
    co, jco = (m["coopt"].replace(page_size=16) for m in (MODES, JMODES))
    toks = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)
    jmodel = jget_model(jget_config(ARCH))
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                           jmodel.init_cache(2, 64, jco), jco)
    tl, _ = get_model(CFG).prefill(
        params, {"tokens": torch.from_numpy(toks)},
        get_model(CFG).init_cache(2, 64, co, device="cpu"), co)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_ATOL)


# --------------------------------------------------------------- engine ----
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


CASES = [("coopt", 7), ("original", 0)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def jax_run(request, weights):
    mode, pages = request.param
    jparams, _ = weights
    eng = JEngine(jget_config(ARCH), JMODES[mode].replace(page_size=32),
                  _ecfg(JEngineConfig, JCacheConfig, pages), params=jparams)
    log = _record(eng)
    eng.generate(_prompts(), max_new_tokens=16)
    return mode, pages, log, eng.stats


@pytest.mark.parametrize("use_kernel", [False, True])
def test_generate_matches_jax_engine(weights, jax_run, use_kernel):
    """Greedy tokens equal, or part only at a near-tie (the JAX logits' best
    two within tests/test_torch_engine.py's NEAR_TIE); the generated-token,
    prefix-hit, preemption and rejection counts are equal. coopt runs on a
    pool small enough to preempt; ``use_kernel`` routes attention and the
    latent writes through the kernel wrappers (their plain versions on
    CPU)."""
    mode, pages, want, jstats = jax_run
    _, params = weights
    eng = Engine(CFG, MODES[mode].replace(page_size=32, use_kernel=use_kernel),
                 _ecfg(EngineConfig, CacheConfig, pages), params=params,
                 device="cpu")
    got = _record(eng)
    eng.generate(_prompts(), max_new_tokens=16)
    assert sorted(got) == sorted(want)
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
