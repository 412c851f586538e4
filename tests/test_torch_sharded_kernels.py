"""The port's page-range shards at the kernel level, held against the JAX
package on the CPU: ``return_state`` of K2-K7's plain versions against the
Pallas kernels' (interpret mode) on shard-local tables, the log-sum-exp
merge of ``kernels.sharded`` against the JAX package's unsharded jnp
reference and kernels, writes under a shard context, the views each
shard's launch receives, and the shard context an engine derives from a
``launch.mesh`` mesh.

The (m, l) state rule (stated once, used throughout): m within STATE_M_TOL
* (1 + |m|) -- the same f32 scores summed in other orders -- and l within
STATE_L_RTOL of |l|; a row that saw no live key reports m = -1e30 and the
same l exactly. A control, the plain version with each row's newest key
dropped, must exceed the l rule. Inputs are numpy-seeded and handed to
both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import opt_kv as jopt_kv  # noqa: E402
from repro.core import opt_pa as jopt_pa  # noqa: E402
from repro.core.coopt import COOPT as JCOOPT  # noqa: E402
from repro.kernels import flash_chunk_prefill as jfc  # noqa: E402
from repro.kernels import latent_chunk_prefill as jlc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_gqa_decode as jpd  # noqa: E402
from repro.kernels import paged_latent_decode as jld  # noqa: E402
from repro.kernels import visits as jvisits  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import opt_kv  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.kernels import flash_chunk_prefill as fc  # noqa: E402
from repro_torch.kernels import latent_chunk_prefill as lc  # noqa: E402
from repro_torch.kernels import ops, sharded, visits  # noqa: E402
from repro_torch.kernels import paged_gqa_decode as pd  # noqa: E402
from repro_torch.kernels import paged_latent_decode as ld  # noqa: E402
from repro_torch.launch.mesh import (kv_shard_count, make_host_mesh,  # noqa: E402
                                     make_sim_mesh)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

from test_torch_kernels import KERNEL_ATOL, _bf16, _i32, _pool, _t2n  # noqa: E402
from test_torch_mla import (DR, LATENT_ATOL, R, SCALE, H,  # noqa: E402
                            _latent_pool)

STATE_M_TOL = 2 ** -16
STATE_L_RTOL = 2 ** -12
NEG = -1e30
# the JAX package's own tolerances for the sharded merge against its jnp
# reference (tests/test_sharded_kernels.py): fp8 and bf16 pools
MERGE_TOL = {True: 0.05, False: 5e-3}
PS, P = 16, 16                  # pages of 16 tokens, a pool of 16 pages
# lane 0 has a page on every shard of 2 or 4; lane 1 only on the first
# quarter and second (none on shards 2-3 of 4, none on shard 1 of 2); lane
# 2 none on shard 0 of 4 but its first page, shared with lane 0 at the
# same slot (a visit both read once)
TABLE = [[0, 5, 9, 13], [1, 2, 6, -1], [0, 11, 14, 15]]
CACHE_LEN = [64, 50, 60]


CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_ctx():
    yield
    ops.set_mesh_ctx(None)


def _ctx(n=4):
    """A context of ``n`` shards, each a pool of its own on the CPU."""
    return sharded.ShardCtx(devices=(CPU,) * n)


def _split(pool, pages_dim, n=4):
    """``pool`` as a ShardedPool of ``n`` CPU tensors (None stays None)."""
    return None if pool is None else opt_kv.ShardedPool.split(
        pool, [CPU] * n, pages_dim)


def _hold_state(got, want, o_atol):
    """The port's (o, m, l) against the JAX kernel's, by the state rule."""
    o, m, l = (_t2n(x) for x in got)
    wo, wm, wl = (np.asarray(x, np.float32) for x in want)
    np.testing.assert_allclose(o, wo, atol=o_atol)
    empty = wm == NEG
    np.testing.assert_array_equal(m[empty], wm[empty])
    np.testing.assert_array_equal(l[empty], wl[empty])
    assert np.all(np.abs(m - wm)[~empty]
                  <= STATE_M_TOL * (1 + np.abs(wm[~empty])))
    assert np.all(np.abs(l - wl)[~empty] <= STATE_L_RTOL * np.abs(wl[~empty]))
    return int((empty & (wl == 0)).sum())


def _l_ratio(l, want):
    """The l rule's largest share over rows both see as non-empty."""
    l, want = _t2n(l), np.asarray(want, np.float32)
    ok = (want != 0) & (l != 0)
    return float((np.abs(l - want) / (STATE_L_RTOL * np.abs(want)))[ok].max())


def _shards(n):
    per = P // n
    return [(s * per, per) for s in range(n)]


def _local(table, first, per):
    """The table in one shard's page domain, in both packages (equal)."""
    jt = jopt_kv.global_to_local_pages(jnp.asarray(table), first, per)
    tt = opt_kv.global_to_local_pages(torch.as_tensor(np.asarray(table)),
                                      first, per)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    return jt, tt


def _gqa_case(seed, Hkv=2, G=4, D=64, opt_kv_on=True):
    rng = np.random.default_rng(seed)
    jkv, jsc, tkv, tsc = _pool(rng, P, PS, Hkv, D, opt_kv_on)
    jq, tq = _bf16(rng.standard_normal((3, Hkv * G, D)).astype(np.float32))
    return rng, (jq, jkv, jsc), (tq, tkv, tsc)


# ------------------------------------------------------- return_state ----
def test_global_to_local_pages_matches_jax():
    table = np.asarray(TABLE, np.int32)
    for n in (1, 2, 4):
        for first, per in _shards(n):
            _local(table, first, per)


@pytest.mark.parametrize("window,sink", [(0, 0), (32, 1)])
@pytest.mark.parametrize("n", [2, 4])
def test_decode_state_matches_pallas(n, window, sink):
    """K2 and K4 plain with ``return_state`` on each shard's page range and
    local tables against the Pallas kernels' (interpret): o within
    KERNEL_ATOL, (m, l) by the state rule; lanes with no page on a shard
    report (-1e30, 0); K4's (o, m, l) equal K2's exactly."""
    _, (jq, jkv, jsc), (tq, tkv, tsc) = _gqa_case(2)
    jcl, tcl = _i32(CACHE_LEN)
    jpt, tpt = _i32(TABLE)
    jphys, jlog = jopt_kv.decode_page_select(jcl, jpt, PS, window=window,
                                             sink_pages=sink, opt_pa=True)
    tphys, tlog = opt_kv.decode_page_select(tcl, tpt, PS, window=window,
                                            sink_pages=sink, opt_pa=True)
    kw = dict(opt_kv=True, opt_gqa=True, window=window, sink_pages=sink)
    empty = 0
    for first, per in _shards(n):
        jl, tl = _local(np.asarray(tphys), first, per)
        jv = [x[:, first:first + per] for x in (jkv, jsc)]
        tv = [x[:, first:first + per] for x in (tkv, tsc)]
        jpool = (jv[0][0], jv[0][1], jv[1][0], jv[1][1])
        tpool = (tv[0][0], tv[0][1], tv[1][0], tv[1][1])
        got2 = pd.paged_pool_decode_ref(tq, *tpool, tcl, tl, tlog, **kw,
                                        return_state=True)
        want2 = jpd.paged_pool_decode(jq, *jpool, jcl, jl, jlog, **kw,
                                      return_state=True, interpret=True)
        empty += _hold_state(got2, want2, KERNEL_ATOL)
        vp, vm, vl = visits.plan_visits(tl, tlog)
        got4 = pd.paged_pool_decode_visits_ref(tq, *tpool, tcl, vp, vm, vl,
                                               **kw, return_state=True)
        assert all(torch.equal(a, b) for a, b in zip(got4, got2))
        jvp, jvm, jvl = jvisits.plan_visits(jl, jlog)
        want4 = jpd.paged_pool_decode_visits(jq, *jpool, jcl, jvp, jvm, jvl,
                                             **kw, return_state=True,
                                             interpret=True)
        _hold_state(got4, want4, KERNEL_ATOL)
    assert empty > 0            # some lane read no page on some shard


def _chunk_inputs(packed):
    """A mixed step of 3 lanes (chunks at [40, 48) and [48, 56), a decode
    lane at 59), or one packed row: two prompts as segments (seg 0 on
    slots 0-1 at [16, 24), seg 1 on slot 2 at [0, 8), page_base restarting
    at 0) beside the decode lanes."""
    S = 8
    if not packed:
        pos = np.stack([np.arange(40, 48), np.arange(48, 56),
                        np.full(S, 59)])
        return pos, TABLE, None
    pos = np.stack([np.concatenate([np.arange(16, 20), np.arange(0, 4)]),
                    np.arange(48, 56), np.full(S, 59)])
    seg = np.zeros((3, S), np.int32)
    seg[0, 4:] = 1
    table = [[0, 5, 9, -1], TABLE[1], TABLE[2]]
    pseg = np.zeros((3, 4), np.int32)
    pseg[0, 2] = 1
    pbase = np.tile(np.arange(4, dtype=np.int32), (3, 1))
    pbase[0, 2] = 0
    return pos, table, (seg, pseg, pbase)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("n", [2, 4])
def test_chunk_state_matches_pallas(n, packed):
    """K3 plain with ``return_state`` on each shard against the Pallas
    kernel (interpret), unpacked and packed (the planes go to every shard
    untranslated): o within KERNEL_ATOL, (m, l) by the state rule."""
    rng, (_, jkv, jsc), (_, tkv, tsc) = _gqa_case(3)
    jq, tq = _bf16(rng.standard_normal((3, 8, 8, 64)).astype(np.float32))
    pos, table, planes = _chunk_inputs(packed)
    jpos, tpos = _i32(pos)
    jp = tp = {}
    if planes:
        (js, ts), (jps, tps), (jpb, tpb) = (_i32(x) for x in planes)
        jp = dict(seg_q=js, page_seg=jps, page_base=jpb)
        tp = dict(seg_q=ts, page_seg=tps, page_base=tpb)
    empty = 0
    for first, per in _shards(n):
        jl, tl = _local(np.asarray(table, np.int32), first, per)
        jv = [x[:, first:first + per] for x in (jkv, jsc)]
        tv = [x[:, first:first + per] for x in (tkv, tsc)]
        got = fc.flash_chunk_prefill_ref(
            tq, tpos, tv[0][0], tv[0][1], tv[1][0], tv[1][1], tl,
            opt_kv=True, return_state=True, **tp)
        want = jfc.flash_chunk_prefill(
            jq, jpos, jv[0][0], jv[0][1], jv[1][0], jv[1][1], jl,
            opt_kv=True, return_state=True, interpret=True, **jp)
        empty += _hold_state(got, want, KERNEL_ATOL)
    assert empty > 0


@pytest.mark.parametrize("window,sink", [(0, 0), (32, 1)])
@pytest.mark.parametrize("n", [2, 4])
def test_latent_decode_state_matches_pallas(n, window, sink):
    """K5 and K7 plain with ``return_state`` on each shard against the
    Pallas kernels (interpret): o_lat within LATENT_ATOL, (m, l) by the
    state rule; K7's (o, m, l) equal K5's exactly."""
    rng = np.random.default_rng(5)
    jlat, jsc, tlat, tsc = _latent_pool(rng, P, PS, True)
    ql = rng.standard_normal((3, H, R)).astype(np.float32)
    qr = rng.standard_normal((3, H, DR)).astype(np.float32)
    jcl, tcl = _i32(CACHE_LEN)
    jpt, tpt = _i32(TABLE)
    jphys, jlog = jopt_kv.decode_page_select(jcl, jpt, PS, window=window,
                                             sink_pages=sink, opt_pa=True)
    tphys, tlog = opt_kv.decode_page_select(tcl, tpt, PS, window=window,
                                            sink_pages=sink, opt_pa=True)
    kw = dict(sm_scale=SCALE, opt_kv=True, window=window, sink_pages=sink)
    tq = (torch.from_numpy(ql), torch.from_numpy(qr))
    jq = (jnp.asarray(ql), jnp.asarray(qr))
    empty = 0
    for first, per in _shards(n):
        jl, tl = _local(np.asarray(tphys), first, per)
        tpool = (tlat[first:first + per], tsc[first:first + per])
        jpool = (jlat[first:first + per], jsc[first:first + per])
        got5 = ld.paged_latent_decode_ref(*tq, *tpool, tcl, tl, tlog, **kw,
                                          return_state=True)
        want5 = jld.paged_latent_decode(*jq, *jpool, jcl, jl, jlog, **kw,
                                        return_state=True, interpret=True)
        empty += _hold_state(got5, want5, LATENT_ATOL)
        vp, vm, vl = visits.plan_visits(tl, tlog)
        got7 = ld.paged_latent_decode_visits_ref(*tq, *tpool, tcl, vp, vm,
                                                 vl, **kw, return_state=True)
        assert all(torch.equal(a, b) for a, b in zip(got7, got5))
        jvp, jvm, jvl = jvisits.plan_visits(jl, jlog)
        want7 = jld.paged_latent_decode_visits(*jq, *jpool, jcl, jvp, jvm,
                                               jvl, **kw, return_state=True,
                                               interpret=True)
        _hold_state(got7, want7, LATENT_ATOL)
    assert empty > 0


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("n", [2, 4])
def test_latent_chunk_state_matches_pallas(n, packed):
    """K6 plain with ``return_state`` on each shard against the Pallas
    kernel (interpret), unpacked and packed: o_lat within LATENT_ATOL,
    (m, l) by the state rule."""
    rng = np.random.default_rng(6)
    jlat, jsc, tlat, tsc = _latent_pool(rng, P, PS, True)
    ql = rng.standard_normal((3, 8, H, R)).astype(np.float32)
    qr = rng.standard_normal((3, 8, H, DR)).astype(np.float32)
    pos, table, planes = _chunk_inputs(packed)
    jpos, tpos = _i32(pos)
    jp = tp = {}
    if planes:
        (js, ts), (jps, tps), (jpb, tpb) = (_i32(x) for x in planes)
        jp = dict(seg_q=js, page_seg=jps, page_base=jpb)
        tp = dict(seg_q=ts, page_seg=tps, page_base=tpb)
    empty = 0
    for first, per in _shards(n):
        jl, tl = _local(np.asarray(table, np.int32), first, per)
        got = lc.latent_chunk_prefill_ref(
            torch.from_numpy(ql), torch.from_numpy(qr), tpos,
            tlat[first:first + per], tsc[first:first + per], tl,
            sm_scale=SCALE, opt_kv=True, return_state=True, **tp)
        want = jlc.latent_chunk_prefill(
            jnp.asarray(ql), jnp.asarray(qr), jpos, jlat[first:first + per],
            jsc[first:first + per], jl, sm_scale=SCALE, opt_kv=True,
            return_state=True, interpret=True, **jp)
        empty += _hold_state(got, want, LATENT_ATOL)
    assert empty > 0


@pytest.mark.parametrize("kernel", ["K2", "K3", "K5", "K6"])
def test_state_rule_fails_a_dropped_key(kernel):
    """The control: each plain version with every row's newest key dropped
    (cache_len - 1, or positions - 1) must break the l rule against the
    Pallas kernel's state on the whole pool."""
    rng = np.random.default_rng(7)
    jcl, tcl = _i32(CACHE_LEN)
    jpt, tpt = _i32(TABLE)
    if kernel in ("K2", "K3"):
        _, (jq, jkv, jsc), (tq, tkv, tsc) = _gqa_case(8)
        jpool = (jkv[0], jkv[1], jsc[0], jsc[1])
        tpool = (tkv[0], tkv[1], tsc[0], tsc[1])
        kw = dict(opt_kv=True, opt_gqa=True)
        if kernel == "K2":
            jphys, jlog = jopt_kv.decode_page_select(jcl, jpt, PS)
            tphys, tlog = opt_kv.decode_page_select(tcl, tpt, PS)
            want = jpd.paged_pool_decode(jq, *jpool, jcl, jphys, jlog, **kw,
                                         return_state=True, interpret=True)
            got = pd.paged_pool_decode_ref(tq, *tpool, tcl - 1, tphys, tlog,
                                           **kw, return_state=True)
        else:
            jq, tq = _bf16(rng.standard_normal((3, 8, 8, 64))
                           .astype(np.float32))
            jpos, tpos = _i32(_chunk_inputs(False)[0])
            want = jfc.flash_chunk_prefill(jq, jpos, *jpool, jpt, **kw,
                                           return_state=True, interpret=True)
            got = fc.flash_chunk_prefill_ref(tq, tpos - 1, *tpool, tpt, **kw,
                                             return_state=True)
    else:
        jlat, jsc, tlat, tsc = _latent_pool(rng, P, PS, True)
        kw = dict(sm_scale=SCALE, opt_kv=True)
        if kernel == "K5":
            ql = rng.standard_normal((3, H, R)).astype(np.float32)
            qr = rng.standard_normal((3, H, DR)).astype(np.float32)
            jphys, jlog = jopt_kv.decode_page_select(jcl, jpt, PS)
            tphys, tlog = opt_kv.decode_page_select(tcl, tpt, PS)
            want = jld.paged_latent_decode(
                jnp.asarray(ql), jnp.asarray(qr), jlat, jsc, jcl, jphys,
                jlog, **kw, return_state=True, interpret=True)
            got = ld.paged_latent_decode_ref(
                torch.from_numpy(ql), torch.from_numpy(qr), tlat, tsc,
                tcl - 1, tphys, tlog, **kw, return_state=True)
        else:
            ql = rng.standard_normal((3, 8, H, R)).astype(np.float32)
            qr = rng.standard_normal((3, 8, H, DR)).astype(np.float32)
            jpos, tpos = _i32(_chunk_inputs(False)[0])
            want = jlc.latent_chunk_prefill(
                jnp.asarray(ql), jnp.asarray(qr), jpos, jlat, jsc, jpt,
                **kw, return_state=True, interpret=True)
            got = lc.latent_chunk_prefill_ref(
                torch.from_numpy(ql), torch.from_numpy(qr), tpos - 1, tlat,
                tsc, tpt, **kw, return_state=True)
    assert _l_ratio(got[2], want[2]) > 1


def test_return_state_off_returns_the_output_alone():
    """Without ``return_state`` every wrapper returns the output tensor it
    always did (the same values as the state form's first element)."""
    _, (_, _, _), (tq, tkv, tsc) = _gqa_case(9)
    tcl = torch.tensor(CACHE_LEN, dtype=torch.int32)
    tphys, tlog = opt_kv.decode_page_select(tcl, torch.tensor(
        TABLE, dtype=torch.int32), PS)
    args = (tq, tkv[0], tkv[1], tsc[0], tsc[1], tcl, tphys, tlog)
    plain = pd.paged_pool_decode(*args, opt_kv=True, opt_gqa=True)
    o, m, l = pd.paged_pool_decode(*args, opt_kv=True, opt_gqa=True,
                                   return_state=True)
    assert isinstance(plain, torch.Tensor) and torch.equal(plain, o)
    assert m.dtype == l.dtype == torch.float32 and m.shape == (3, 8)


# ------------------------------------------------------------- merge ----
def _merge_pool(opt_kv_on, B=2, Hq=8, Hkv=4, D=128, ps=8, PT=16, seed=1):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((2, PT, ps, Hkv, D)) * 0.3).astype(np.float32)
    jkv, jsc = jnp.asarray(kv), None
    tkv, tsc = torch.from_numpy(kv).to(torch.bfloat16), None
    if opt_kv_on:
        from repro_torch.cache.quant import quantize_fp8
        tkv, tsc = quantize_fp8(torch.from_numpy(kv))
        jkv = jnp.asarray(tkv.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
        jsc = jnp.asarray(tsc.numpy())
    else:
        jkv = jnp.asarray(tkv.float().numpy(), jnp.bfloat16)
    jq, tq = _bf16(rng.standard_normal((B, Hq, D)).astype(np.float32))
    return (jq, jkv, jsc), (tq, tkv, tsc)


@pytest.mark.parametrize("opt_kv_on", [False, True])
def test_sharded_decode_merge_matches_jax_unsharded(opt_kv_on):
    """``sharded.paged_pool_decode`` at 4 shards (through the plain
    versions) against the JAX package's unsharded jnp reference and its
    unsharded ops decode, at the JAX package's own tolerances for its
    sharded merge (0.05 over fp8 pages, 5e-3 over bf16)."""
    (jq, jkv, jsc), (tq, tkv, tsc) = _merge_pool(opt_kv_on)
    coopt = JCOOPT.replace(opt_kv=opt_kv_on, use_kernel=False)
    jcl, tcl = _i32([37, 90])
    jpt = jopt_kv.identity_page_table(2, 16)
    ref = jopt_pa.paged_decode_attention(jq, jkv, jsc, jcl, coopt=coopt,
                                         page_table=jpt)
    jphys, jlog = jopt_kv.decode_page_select(jcl, jpt, 8, opt_pa=True)
    jk = jops.paged_pool_decode(jq, jkv, jsc, jcl, jphys, jlog,
                                opt_kv=opt_kv_on, opt_gqa=True)
    tphys, tlog = opt_kv.decode_page_select(
        tcl, opt_kv.identity_page_table(2, 16), 8, opt_pa=True)
    with ops.mesh_ctx_scope(_ctx()):
        out = ops.paged_pool_decode(tq, _split(tkv, 1), _split(tsc, 1), tcl,
                                    tphys, tlog, opt_kv=opt_kv_on,
                                    opt_gqa=True)
    tol = MERGE_TOL[opt_kv_on]
    np.testing.assert_allclose(_t2n(out), np.asarray(ref, np.float32),
                               atol=tol)
    np.testing.assert_allclose(_t2n(out), np.asarray(jk, np.float32),
                               atol=tol)


def test_sharded_visit_shards_match_per_lane_shards():
    """``share_visits`` under a shard context: each shard plans its visits
    after the translation (prefix pages 0 and 9, shared by every lane, lie
    on different shards); the result equals the per-lane shards' within
    1e-6 and the JAX jnp reference within 0.05."""
    (jq, jkv, jsc), (tq, tkv, tsc) = _merge_pool(True, B=4)
    coopt = JCOOPT.replace(opt_kv=True, use_kernel=False)
    pt = np.asarray([[0, 9, 2 + b, 12 + b] for b in range(4)], np.int32)
    cl = [32 - 3 * b for b in range(4)]
    (jpt, tpt), (jcl, tcl) = _i32(pt), _i32(cl)
    ref = jopt_pa.paged_decode_attention(jq, jkv, jsc, jcl, coopt=coopt,
                                         page_table=jpt)
    tphys, tlog = opt_kv.decode_page_select(tcl, tpt, 8, opt_pa=True)
    skv, ssc = _split(tkv, 1), _split(tsc, 1)
    with ops.mesh_ctx_scope(_ctx()):
        on = ops.paged_pool_decode(tq, skv, ssc, tcl, tphys, tlog,
                                   opt_kv=True, opt_gqa=True,
                                   share_visits=True)
        off = ops.paged_pool_decode(tq, skv, ssc, tcl, tphys, tlog,
                                    opt_kv=True, opt_gqa=True,
                                    share_visits=False)
    np.testing.assert_allclose(_t2n(on), _t2n(off), atol=1e-6)
    np.testing.assert_allclose(_t2n(on), np.asarray(ref, np.float32),
                               atol=0.05)


def test_sharded_chunk_merge_matches_jax_unsharded():
    """``sharded.paged_chunk_prefill`` at 4 shards against the JAX jnp
    reference and unsharded ops chunk (5e-3, a bf16 pool)."""
    rng = np.random.default_rng(3)
    (_, jkv, jsc), (_, tkv, tsc) = _merge_pool(False)
    jq, tq = _bf16(rng.standard_normal((2, 4, 8, 128)).astype(np.float32))
    pos = np.stack([np.arange(33, 37), np.arange(86, 90)])
    (jpos, tpos) = _i32(pos)
    jpt = jopt_kv.identity_page_table(2, 16)
    ref = jopt_pa.paged_chunk_attention(
        jq, jkv, None, jpos, jpt, JCOOPT.replace(opt_kv=False,
                                                 use_kernel=False))
    jk = jops.paged_chunk_prefill(jq, jpos, jkv, None, jpt, opt_kv=False,
                                  opt_gqa=True)
    with ops.mesh_ctx_scope(_ctx()):
        out = ops.paged_chunk_prefill(tq, tpos, _split(tkv, 1), None,
                                      opt_kv.identity_page_table(2, 16),
                                      opt_kv=False, opt_gqa=True)
    np.testing.assert_allclose(_t2n(out), np.asarray(ref, np.float32),
                               atol=5e-3)
    np.testing.assert_allclose(_t2n(out), np.asarray(jk, np.float32),
                               atol=5e-3)


@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_sharded_latent_merge_matches_jax_unsharded(kind):
    """``sharded.paged_latent_decode`` (with visits) and
    ``sharded.latent_chunk_prefill`` at 4 shards against the JAX package's
    unsharded ops (interpret kernels): f32 partials, LATENT_ATOL."""
    rng = np.random.default_rng(4)
    jlat, jsc, tlat, tsc = _latent_pool(rng, P, PS, True)
    (jpt, tpt), (jcl, tcl) = _i32(TABLE), _i32(CACHE_LEN)
    kw = dict(sm_scale=SCALE, opt_kv=True)
    ctx = _ctx()
    slat, slsc = _split(tlat, 0), _split(tsc, 0)
    if kind == "decode":
        ql = rng.standard_normal((3, H, R)).astype(np.float32)
        qr = rng.standard_normal((3, H, DR)).astype(np.float32)
        jphys, jlog = jopt_kv.decode_page_select(jcl, jpt, PS)
        tphys, tlog = opt_kv.decode_page_select(tcl, tpt, PS)
        want = jops.paged_latent_decode(jnp.asarray(ql), jnp.asarray(qr),
                                        jlat, jsc, jcl, jphys, jlog, **kw,
                                        share_visits=True)
        with ops.mesh_ctx_scope(ctx):
            got = ops.paged_latent_decode(
                torch.from_numpy(ql), torch.from_numpy(qr), slat, slsc, tcl,
                tphys, tlog, **kw, share_visits=True)
    else:
        ql = rng.standard_normal((3, 8, H, R)).astype(np.float32)
        qr = rng.standard_normal((3, 8, H, DR)).astype(np.float32)
        jpos, tpos = _i32(_chunk_inputs(False)[0])
        want = jops.latent_chunk_prefill(jnp.asarray(ql), jnp.asarray(qr),
                                         jpos, jlat, jsc, jpt, **kw)
        with ops.mesh_ctx_scope(ctx):
            got = ops.latent_chunk_prefill(
                torch.from_numpy(ql), torch.from_numpy(qr), tpos, slat, slsc,
                tpt, **kw)
    np.testing.assert_allclose(_t2n(got), np.asarray(want),
                               atol=LATENT_ATOL)


def test_each_shard_reads_only_its_own_view(monkeypatch):
    """The port's counterpart of the JAX package's no-pool-all-gather check,
    on pools of their own: every per-shard launch of the four reads
    receives its own shard's tensor (by ``data_ptr``: shard s's allocation,
    a tensor of exactly its pages, never a view of a whole pool) and a
    table with no page outside that shard's range."""
    seen = []

    def spy(mod, name, arg, tab):        # the pages' and table's positions
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            seen.append((name, a[arg].data_ptr(), a[arg].shape[0],
                         int(a[tab].max())))
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, name, arg, tab in ((pd, "paged_pool_decode", 1, 6),
                                (pd, "paged_pool_decode_visits", 1, 6),
                                (fc, "flash_chunk_prefill", 2, 6),
                                (ld, "paged_latent_decode", 2, 5),
                                (ld, "paged_latent_decode_visits", 2, 5),
                                (lc, "latent_chunk_prefill", 3, 5)):
        spy(mod, name, arg, tab)
    _, _, (tq, tkv, tsc) = _gqa_case(10)
    rng = np.random.default_rng(10)
    _, _, tlat, tlsc = _latent_pool(rng, P, PS, True)
    skv, ssc, slat, slsc = (_split(tkv, 1), _split(tsc, 1),
                            _split(tlat, 0), _split(tlsc, 0))
    tcl = torch.tensor(CACHE_LEN, dtype=torch.int32)
    tpt = torch.tensor(TABLE, dtype=torch.int32)
    phys, log = opt_kv.decode_page_select(tcl, tpt, PS)
    pos = torch.from_numpy(_chunk_inputs(False)[0].astype(np.int32))
    ql, qr = torch.randn(3, H, R), torch.randn(3, H, DR)
    with ops.mesh_ctx_scope(_ctx()):
        for v in (False, True):
            ops.paged_pool_decode(tq, skv, ssc, tcl, phys, log, opt_kv=True,
                                  opt_gqa=True, share_visits=v)
            ops.paged_latent_decode(ql, qr, slat, slsc, tcl, phys, log,
                                    sm_scale=SCALE, opt_kv=True,
                                    share_visits=v)
        ops.paged_chunk_prefill(torch.randn(3, 8, 8, 64).to(torch.bfloat16),
                                pos, skv, ssc, tpt, opt_kv=True,
                                opt_gqa=True)
        ops.latent_chunk_prefill(torch.randn(3, 8, H, R),
                                 torch.randn(3, 8, H, DR), pos, slat, slsc,
                                 tpt, sm_scale=SCALE, opt_kv=True)
    assert len(seen) == 6 * 4
    for i, (name, ptr, pages, top) in enumerate(seen):
        shard = (slat.shards if "latent" in name else
                 [t[0] for t in skv.shards])[i % 4]
        assert pages == P // 4 and ptr == shard.data_ptr(), (name, i)
        assert top < P // 4, (name, i, top)
    ptrs = {p for _, p, _, _ in seen}
    assert len(ptrs) == 8           # 4 K halves and 4 latent pools


# ------------------------------------------------------------ writes ----
WPS, WPT = 8, 16        # the write tests' pool: 16 pages of 8 lines


def _jbytes(x):
    return np.asarray(x).view(np.uint8)


def _tbytes(t):
    return t.contiguous().view(torch.uint8).numpy()


def _write_slots(n):
    """(2, 4) GLOBAL slots for a pool split into ``n`` shards: -1 twice,
    shard 1's first line, a line of shard 0 and one of shard 1 (n = 4: of
    shard 0), the pool's last line and one past the pool. No mid-pool
    shard's last line is written."""
    per = WPS * WPT // n
    return np.asarray([[-1, per, 37, per - 2],
                       [WPS * WPT - 1, WPS * WPT, 5, -1]], np.int32)


def test_global_to_local_slots_matches_jax():
    """``global_to_local_slots`` equals the JAX function on slots that
    include -1, other shards' slots, the first and last line of every
    shard and one past the pool, at 2 and 4 shards: a shard's own slots
    become local lines, every other slot one past its range (never -1)."""
    total = WPS * WPT
    for n in (2, 4):
        per = total // n
        slots = np.asarray([[-1, total, total - 1, 0, 37]
                            + [s * per for s in range(n)]
                            + [s * per + per - 1 for s in range(n)]],
                           np.int32)
        for s in range(n):
            got = opt_kv.global_to_local_slots(torch.from_numpy(slots),
                                               s * per, per)
            want = jopt_kv.global_to_local_slots(jnp.asarray(slots),
                                                 s * per, per)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            own = (slots >= s * per) & (slots < (s + 1) * per)
            assert np.all(got.numpy()[~own] == per)
            assert np.all(got.numpy()[own] == slots[own] - s * per)


@pytest.mark.parametrize("opt_kv_on", [True, False], ids=["fp8", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_local_writes_match_jax(n, opt_kv_on):
    """The shard-local K1 path (its plain version) and latent write at
    ``n`` shards, each shard a tensor of its own: every shard equals, byte
    for byte, the JAX ``kv_pool_write``/``latent_pool_write`` body run on
    that shard's slice without a mesh (``quantize_fp8``/
    ``quantize_latent``, ``global_to_local_slots``, ``.at[].set(
    mode="drop")``); concatenated, the shards equal the JAX global write's
    live lines (its sentinel, the pool's last line, excluded); only the
    written lines change, so the dropped slots leave every mid-pool
    shard's last line as it was. The control, the global latent write run
    on each shard with its local slots (it routes a dropped slot to the
    tensor's last line), must change those lines."""
    from repro.cache import quant as jquant
    rng = np.random.default_rng(20 + n)
    Hkv, D, pp = 2, 16, WPT // n
    per, total = pp * WPS, WPT * WPS
    slots = _write_slots(n)
    (jsl, tsl) = _i32(slots)
    written = sorted(x for x in slots.ravel().tolist() if 0 <= x < total)
    mid_last = [s * per - 1 for s in range(1, n)]
    coopt = JCOOPT.replace(opt_kv=opt_kv_on, use_kernel=False)

    # K1's path
    jkv, jsc, tkv, tsc = _pool(rng, WPT, WPS, Hkv, D, opt_kv_on)
    jk, tk = _bf16(rng.standard_normal((2, 4, Hkv, D)).astype(np.float32)
                   * 3)
    jv, tv = _bf16(rng.standard_normal((2, 4, Hkv, D)).astype(np.float32))
    skv, ssc = _split(tkv, 1, n), _split(tsc, 1, n)
    with ops.mesh_ctx_scope(_ctx(n)):
        ops.kv_cache_write(skv, ssc, tk, tv, tsl, opt_kv=opt_kv_on)
    new = jnp.stack([jk, jv])
    vals, scl = jquant.quantize_fp8(new, axis=-1) if opt_kv_on \
        else (new, None)
    for s in range(n):
        ls = jopt_kv.global_to_local_slots(jsl, s * per, per)
        want = jkv[:, s * pp:(s + 1) * pp].reshape(2, per, Hkv, D)
        want = want.at[:, ls].set(vals.astype(want.dtype), mode="drop")
        np.testing.assert_array_equal(_tbytes(skv.shards[s]).ravel(),
                                      _jbytes(want).ravel())
        if opt_kv_on:
            wsc = jsc[:, s * pp:(s + 1) * pp].reshape(2, per, Hkv)
            wsc = wsc.at[:, ls].set(scl, mode="drop")
            np.testing.assert_array_equal(ssc.shards[s].numpy().ravel(),
                                          np.asarray(wsc).ravel())
    ref, _ = jopt_kv.write_kv(jkv, jsc, jk, jv, jsl, coopt)
    cat = _tbytes(torch.cat(skv.shards, 1)).reshape(2, total, -1)
    np.testing.assert_array_equal(cat[:, :-1],
                                  _jbytes(ref).reshape(2, total, -1)[:, :-1])
    changed = np.any(cat != _tbytes(tkv).reshape(2, total, -1), axis=(0, 2))
    assert np.flatnonzero(changed).tolist() == written

    # the latent write
    jlat, jlsc, tlat, tlsc = _latent_pool(rng, WPT, WPS, opt_kv_on)
    W = R + DR
    jn, tn = _bf16(rng.standard_normal((2, 4, W)).astype(np.float32))
    slat, slsc = _split(tlat, 0, n), _split(tlsc, 0, n)
    with ops.mesh_ctx_scope(_ctx(n)):
        ops.latent_pool_write(slat, slsc, tn, tsl, opt_kv=opt_kv_on,
                              lora_rank=R)
    lv, lsc = jquant.quantize_latent(jn, R) if opt_kv_on else (jn, None)
    for s in range(n):
        ls = jopt_kv.global_to_local_slots(jsl, s * per, per)
        want = jlat[s * pp:(s + 1) * pp].reshape(per, W)
        want = want.at[ls].set(lv.astype(want.dtype), mode="drop")
        np.testing.assert_array_equal(_tbytes(slat.shards[s]).ravel(),
                                      _jbytes(want).ravel())
        if opt_kv_on:
            wsc = jlsc[s * pp:(s + 1) * pp].reshape(per, 2)
            wsc = wsc.at[ls].set(lsc, mode="drop")
            np.testing.assert_array_equal(slsc.shards[s].numpy().ravel(),
                                          np.asarray(wsc).ravel())
    ref, _ = jops.latent_pool_write(jlat, jlsc, jn, jsl, opt_kv=opt_kv_on,
                                    lora_rank=R)
    cat = _tbytes(torch.cat(slat.shards, 0)).reshape(total, -1)
    np.testing.assert_array_equal(cat[:-1],
                                  _jbytes(ref).reshape(total, -1)[:-1])
    before = _tbytes(tlat).reshape(total, -1)
    changed = np.flatnonzero(np.any(cat != before, axis=1)).tolist()
    assert changed == written
    assert not set(mid_last) & set(changed)
    # the control: the global rule on each shard (drops to its last line)
    ctl = _split(tlat, 0, n)
    ctl_sc = _split(tlsc, 0, n)
    for s in range(n):
        ops.latent_pool_write(ctl.shards[s], None if ctl_sc is None
                              else ctl_sc.shards[s], tn,
                              opt_kv.global_to_local_slots(tsl, s * per,
                                                           per),
                              opt_kv=opt_kv_on, lora_rank=R)
    cat = _tbytes(torch.cat(ctl.shards, 0)).reshape(total, -1)
    changed = np.flatnonzero(np.any(cat != before, axis=1)).tolist()
    assert set(mid_last) <= set(changed)


def test_write_under_a_context_is_the_global_write():
    """Under a shard context K1's path (the plain version here) and the
    latent write are shard-local, and write what the global writes write:
    the concatenated shards change only at the written slots and equal the
    global write on one pool and the JAX jnp ``write_kv``'s live lines (the
    JAX sentinel line, the pool's last, excluded). A dropped token (slot
    -1) touches no line of any shard, where the global latent write puts it
    on the pool's last line."""
    rng = np.random.default_rng(11)
    B, Hkv, D, ps, PT = 2, 4, 16, 8, 16
    kv = rng.standard_normal((2, PT, ps, Hkv, D)).astype(np.float32)
    k_new = np.full((B, 1, Hkv, D), 7.0, np.float32)
    v_new = np.full((B, 1, Hkv, D), 9.0, np.float32)
    slots = np.asarray([[37], [-1]], np.int32)
    ref, _ = jopt_kv.write_kv(jnp.asarray(kv), None, jnp.asarray(k_new),
                              jnp.asarray(v_new), jnp.asarray(slots),
                              JCOOPT.replace(opt_kv=False, use_kernel=False))
    one = torch.from_numpy(kv.copy())
    ops.kv_cache_write(one, None, torch.from_numpy(k_new),
                       torch.from_numpy(v_new), torch.from_numpy(slots),
                       opt_kv=False)
    pool = _split(torch.from_numpy(kv), 1)
    with ops.mesh_ctx_scope(_ctx()):
        ops.kv_cache_write(pool, None, torch.from_numpy(k_new),
                           torch.from_numpy(v_new), torch.from_numpy(slots),
                           opt_kv=False)
    got = torch.cat(pool.shards, 1)
    assert torch.equal(got, one)
    o = got.numpy().reshape(2, PT * ps, Hkv, D)
    r = np.asarray(ref).reshape(2, PT * ps, Hkv, D)
    np.testing.assert_array_equal(o[:, :-1], r[:, :-1])
    changed = np.any(o != kv.reshape(2, PT * ps, Hkv, D), axis=(0, 2, 3))
    assert np.flatnonzero(changed).tolist() == [37]
    # the latent pool: one slot on a mid-pool shard's last line, one dropped
    from repro_torch.cache.quant import quantize_latent
    lat = rng.standard_normal((PT, ps, R + DR)).astype(np.float32)
    tq, tsc = quantize_latent(torch.from_numpy(lat), R)
    new = torch.from_numpy(rng.standard_normal((B, 1, R + DR))
                           .astype(np.float32))
    lslots = torch.tensor([[ps * PT // 4 - 1], [-1]], dtype=torch.int32)
    g, gsc = tq.clone(), tsc.clone()
    ops.latent_pool_write(g, gsc, new, lslots, opt_kv=True, lora_rank=R)
    spool, ssc = _split(tq, 0), _split(tsc, 0)
    with ops.mesh_ctx_scope(_ctx()):
        ops.latent_pool_write(spool, ssc, new, lslots, opt_kv=True,
                              lora_rank=R)
    flat = torch.cat(spool.shards).view(torch.uint8).reshape(PT * ps, -1)
    before = tq.view(torch.uint8).reshape(PT * ps, -1)
    gflat = g.view(torch.uint8).reshape(PT * ps, -1)
    assert torch.equal(flat[:-1], gflat[:-1])
    assert torch.equal(torch.cat(ssc.shards)[:-1], gsc[:-1])
    changed = torch.any(flat != before, dim=1).nonzero().flatten().tolist()
    assert changed == [ps * PT // 4 - 1]
    # the global write also put the dropped token on the pool's last line
    gchanged = torch.any(gflat != before, dim=1).nonzero().flatten()
    assert gchanged.tolist() == [ps * PT // 4 - 1, PT * ps - 1]


# ------------------------------------------------------- engine + mesh ----
ARCH = "qwen3-4b-reduced"


def _engine(mesh=None, **kw):
    cfg = get_config(ARCH)
    ecfg = EngineConfig(num_lanes=2, max_len=128,
                        prefill_buckets=(16, 32, 64), **kw)
    return Engine(cfg, MODES["coopt"].replace(use_kernel=True), ecfg,
                  params=_params(), device="cpu", mesh=mesh)


_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS["p"] = get_model(get_config(ARCH)).init(0, "cpu")
    return _PARAMS["p"]


def test_unsharded_mesh_is_the_unsharded_path():
    """A mesh whose pages axes have extent 1 gives no shard context: the
    engine runs the unsharded kernels, one shard, and the same tokens as
    an engine with no mesh."""
    assert ops.make_mesh_ctx(None) is None
    assert ops.make_mesh_ctx(make_host_mesh()) is None
    assert ops.make_mesh_ctx(make_sim_mesh(data=1, model=1)) is None
    assert ops.make_mesh_ctx(make_sim_mesh(data=1, model=2)) is None
    prompts = [np.random.default_rng(0).integers(0, 512, 40,
                                                 dtype=np.int32)]
    out = _engine().generate(prompts, max_new_tokens=4)
    eng = _engine(mesh=make_host_mesh())
    assert eng._kernel_ctx is None and eng.ecfg.num_shards == 1
    assert eng.generate(prompts, max_new_tokens=4) == out


def test_engine_derives_num_shards_from_mesh_and_rejects_conflict():
    """The engine takes its shard count from the mesh's pages axes
    (``kv_shard_count``; a matching explicit value is accepted) and
    refuses a conflicting one; ``EngineConfig.num_shards`` and
    ``CacheConfig.num_shards`` must agree where both are set."""
    from repro_torch.configs import CacheConfig
    mesh = make_sim_mesh(data=4, model=2)
    assert kv_shard_count(mesh) == 4
    assert kv_shard_count(make_sim_mesh(data=2, model=1, pod=2)) == 4
    eng = _engine(mesh=mesh)
    assert eng.ecfg.num_shards == 4 == eng.ccfg.num_shards
    assert eng._kernel_ctx.num_shards == 4
    assert eng.scheduler.manager.num_shards == 4
    assert _engine(mesh=mesh, num_shards=4).ecfg.num_shards == 4
    with pytest.raises(ValueError, match="disagrees"):
        _engine(mesh=make_sim_mesh(data=1, model=1), num_shards=3)
    with pytest.raises(ValueError, match="conflicts"):
        EngineConfig(num_shards=4,
                     cache=CacheConfig(num_shards=2)).cache_config(64)
    with pytest.raises(ValueError, match="mesh is on"):
        _engine(mesh=make_sim_mesh(data=4, devices=["meta"] * 4))
