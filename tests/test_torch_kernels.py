"""The port's kernels, held against the JAX package on the CPU.

Each CUDA kernel of ``repro_torch.kernels`` has a plain PyTorch version that
CPU tensors take; here those plain versions, fed the same numpy-seeded
inputs, are held against the JAX package's Pallas kernels (interpret mode)
and its jnp oracles. Tolerances are stated per test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.core.opt_kv import decode_page_select as jdecode_page_select  # noqa: E402
from repro.core.opt_kv import write_kv as jwrite_kv  # noqa: E402
from repro.core.opt_pa import paged_chunk_attention as jchunk  # noqa: E402
from repro.kernels import flash_chunk_prefill as jfc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_gqa_decode as jpd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import visits as jvisits  # noqa: E402

from repro_torch.cache.quant import quantize_fp8  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.core.opt_kv import decode_page_select  # noqa: E402
from repro_torch.core.opt_pa import paged_chunk_attention  # noqa: E402
from repro_torch.kernels import cuda, ops, ref, visits  # noqa: E402
from repro_torch.kernels import kv_cache_write as kwm  # noqa: E402
from repro_torch.kernels import paged_gqa_decode as pdm  # noqa: E402
from repro_torch.kernels.flash_chunk_prefill import flash_chunk_prefill_ref  # noqa: E402
from repro_torch.kernels.kv_cache_write import kv_cache_write  # noqa: E402
from repro_torch.kernels.paged_gqa_decode import (  # noqa: E402
    paged_pool_decode_ref, paged_pool_decode_visits_ref)

# One bf16 ulp at |x| < 2 is 2**-7; the plain versions and the Pallas
# kernels both accumulate in f32 and round once to bf16, so they may differ
# by one ulp where the f32 sums round differently.
KERNEL_ATOL = 2 ** -7
# The jnp references dequantize K/V to bf16 before the f32 softmax (the
# kernels keep f32), which moves outputs by a few bf16 ulps.
JNP_ATOL = 3e-2


def _bf16(x):
    """numpy f32 -> (jax bf16, torch bf16) with identical bits."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _f32(a):
    return np.asarray(a, np.float32)


def _t2n(t):
    return t.float().numpy()


def _pool(rng, PT, ps, Hkv, D, opt_kv):
    """(jax kv, jax scale|None, torch kv, torch scale|None) for a pool of
    PT pages whose content is the same quantized values in both."""
    k = rng.standard_normal((PT, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((PT, ps, Hkv, D)).astype(np.float32)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if opt_kv:
        (kq, ks), (vq, vs) = quantize_fp8(kt), quantize_fp8(vt)
        tkv, tsc = torch.stack([kq, vq]), torch.stack([ks, vs])
        jkv = jnp.asarray(tkv.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
        return jkv, jnp.asarray(tsc.numpy()), tkv, tsc
    tkv = torch.stack([kt, vt]).to(torch.bfloat16)
    return jnp.asarray(tkv.float().numpy(), jnp.bfloat16), None, tkv, None


def _i32(x):
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


# ------------------------------------------------------------------ K1 ----
@pytest.mark.parametrize("opt_kv", [False, True])
@pytest.mark.parametrize("Hkv,D", [(2, 64), (8, 128), (1, 256)])
def test_kv_cache_write_plain_matches_pallas_bytes(opt_kv, Hkv, D):
    """K1 plain == the JAX write kernel (interpret) and the jnp
    ``write_kv``, pool bytes equal, the pool's last line (the JAX sentinel)
    excluded. Scales equal the jnp path's exactly; the interpret kernel
    rounds amax / 448 differently in some vectors, so its scales are held
    to within one f32 ulp."""
    rng = np.random.default_rng(1)
    B, S, P, ps = 2, 8, 8, 16
    kn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32) * 3
    vn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kn[0, 1, 0, :] = 0.0                       # all-zero vector: eps scale
    jk, tk = _bf16(kn)
    jv, tv = _bf16(vn)
    slots = [[0, 5, -1, 17, 33, -1, 62, 2], [64, -1, 73, 74, 75, 104, -1, 125]]
    js, ts = _i32(slots)
    dt = (jnp.float8_e4m3fn, torch.float8_e4m3fn) if opt_kv else \
        (jnp.bfloat16, torch.bfloat16)
    jkv = jnp.zeros((2, P, ps, Hkv, D), dt[0])
    jsc = jnp.zeros((2, P, ps, Hkv), jnp.float32) if opt_kv else None
    tkv = torch.zeros((2, P, ps, Hkv, D), dtype=dt[1])
    tsc = torch.zeros((2, P, ps, Hkv)) if opt_kv else None
    jnp_kv, jnp_sc = jwrite_kv(jkv, jsc, jk, jv, js, JMODES["coopt"].replace(
        opt_kv=opt_kv))
    jkv, jsc = jops.kv_cache_write(jkv, jsc, jk, jv, js, opt_kv=opt_kv)
    ops.kv_cache_write(tkv, tsc, tk, tv, ts, opt_kv=opt_kv)
    n = P * ps - 1                             # exclude the sentinel line

    def lines(x, *tail):
        return np.asarray(x).reshape(2, P * ps, *tail)[:, :n]

    tb = tkv.reshape(2, P * ps, Hkv, D).view(torch.uint8).numpy()[:, :n]
    np.testing.assert_array_equal(tb, lines(jnp_kv, Hkv, D).view(np.uint8))
    if not opt_kv:
        np.testing.assert_array_equal(tb, lines(jkv, Hkv, D).view(np.uint8))
        return
    ts_ = tsc.reshape(2, P * ps, Hkv).numpy()[:, :n]
    np.testing.assert_array_equal(ts_, lines(jnp_sc, Hkv))
    ksc = lines(jsc, Hkv)
    np.testing.assert_array_max_ulp(ts_, ksc, maxulp=1)
    # the interpret kernel's bytes are the port's quantizer applied with
    # the kernel's own scales: its only difference is that scale rounding
    new = torch.stack([tk, tv]).float().reshape(2, B * S, Hkv, D)
    flat = np.asarray(slots).reshape(-1)
    ok = flat >= 0
    want = (new[:, ok] / torch.from_numpy(ksc[:, flat[ok]])[..., None]).to(
        torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(
        lines(jkv, Hkv, D).view(np.uint8)[:, flat[ok]], want)


def test_kv_cache_write_plain_drops_skipset_in_place():
    """Slots < 0 never touch the pool, the sentinel line included, and
    unwritten lines keep their contents."""
    Hkv, D, NS = 1, 64, 32
    k_cache = torch.full((NS, Hkv, D), 7.0, dtype=torch.bfloat16)
    v_cache = k_cache.clone()
    kn = torch.ones((1, 3, Hkv, D), dtype=torch.bfloat16)
    slots = torch.tensor([[3, -1, -5]], dtype=torch.int32)
    out = kv_cache_write(kn, kn, slots, k_cache, v_cache, None, None,
                         opt_kv=False)
    assert out[0] is k_cache
    assert torch.all(k_cache[3] == 1.0)
    keep = [i for i in range(NS) if i != 3]
    assert torch.all(k_cache[keep] == 7.0)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Hkv", [1, 2, 8, 40])
@pytest.mark.parametrize("n_tokens", [1, 4, 877, 2048, 4096])
def test_write_plan_covers_every_vector_once(n_tokens, Hkv, D):
    """Through write_plan's launch, the kernel's index map (block b, thread
    t, vector i of the thread: vector b * groups * vecs + t // (D/8) + i *
    groups, its 8 values t % (D/8)) covers each value of every (token,
    K|V, head) vector exactly once; the D/8 threads of a group take the
    same vector, so no group straddles two; no block is idle. A decode
    step takes one vector a thread, a chunk or a prompt two."""
    threads, vecs, blocks = kwm.write_plan(n_tokens, Hkv, D)
    g = D // 8
    assert threads % 32 == 0 and 32 <= threads <= kwm.THREADS
    assert 1 <= vecs <= kwm.MAX_VECS
    groups = threads // g
    n_vec = 2 * n_tokens * Hkv
    t = np.arange(threads)
    v = (np.arange(blocks)[:, None, None] * groups * vecs
         + np.arange(vecs)[None, :, None] * groups + (t // g)[None, None])
    by_group = v.reshape(blocks, vecs, groups, g)
    assert (by_group == by_group[..., :1]).all()
    cells = (v * g + t % g)[v < n_vec]
    np.testing.assert_array_equal(np.sort(cells), np.arange(n_vec * g))
    assert (blocks - 1) * groups * vecs < n_vec
    if n_tokens <= 4:                 # a decode step: one vector a thread
        assert vecs == 1
    if n_tokens >= 2048:              # a chunk or a prompt: two
        assert vecs == kwm.MAX_VECS


def test_kv_cache_write_checks_before_launch(monkeypatch):
    """The kernel path refuses a head_dim outside (64, 128, 256) and a new-token
    or cache view off a 16-byte boundary with ValueError, before the
    library is loaded or a launch counted."""
    def refuse(name):
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(cuda, "library", refuse)
    before = dict(cuda.LAUNCHES)
    B, S, Hkv, NS = 1, 3, 2, 32
    slots = torch.tensor([[3, -1, 5]], dtype=torch.int32)

    def operands(D, new_off=0, cache_off=0):
        n, m = B * S * Hkv * D, NS * Hkv * D
        kn = torch.zeros(n + 8, dtype=torch.bfloat16)[new_off:new_off + n]
        kc = torch.zeros(m + 16, dtype=torch.uint8)[cache_off:cache_off + m]
        return (kn.view(B, S, Hkv, D), torch.zeros((B, S, Hkv, D),
                                                     dtype=torch.bfloat16),
                slots, kc.view(torch.float8_e4m3fn).view(NS, Hkv, D),
                torch.zeros((NS, Hkv, D), dtype=torch.float8_e4m3fn),
                torch.zeros((NS, Hkv)), torch.zeros((NS, Hkv)), True)
    with pytest.raises(ValueError, match="head_dim 96"):
        kwm._launch(*operands(96))
    with pytest.raises(ValueError, match="head_dim 32"):
        kwm.write_plan(4, Hkv, 32)
    for off in (dict(new_off=1), dict(cache_off=8)):
        with pytest.raises(ValueError, match="16-byte"):
            kwm._launch(*operands(64, **off))
    with pytest.raises(AssertionError, match="library"):   # aligned: loads
        kwm._launch(*operands(64))
    assert cuda.LAUNCHES == before


# ------------------------------------------------------------------ K2 ----
def _decode_inputs(mode, window=0, sink=0, seed=2, Hkv=2, G=4, D=64):
    rng = np.random.default_rng(seed)
    B, P_lane, ps = 3, 6, 16
    coopt = MODES[mode]
    jkv, jsc, tkv, tsc = _pool(rng, B * P_lane, ps, Hkv, D, coopt.opt_kv)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    jq, tq = _bf16(q)
    # lanes own scattered pages of the shared pool; lane 2 holds a -1 hole
    perm = rng.permutation(B * P_lane).reshape(B, P_lane)
    perm[2, -1] = -1
    jpt, tpt = _i32(perm)
    jcl, tcl = _i32([P_lane * ps, 37, 70])
    jphys, jlog = jdecode_page_select(jcl, jpt, ps, window=window,
                                      sink_pages=sink, opt_pa=coopt.opt_pa)
    tphys, tlog = decode_page_select(tcl, tpt, ps, window=window,
                                     sink_pages=sink, opt_pa=coopt.opt_pa)
    np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))
    np.testing.assert_array_equal(tlog.numpy(), np.asarray(jlog))
    return coopt, (jq, jkv, jsc, jcl, jphys, jlog), (tq, tkv, tsc, tcl,
                                                     tphys, tlog)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("window,sink", [(0, 0), (32, 1)])
def test_pool_decode_plain_matches_pallas_and_oracle(mode, window, sink):
    """K2 plain vs the interpret kernel (KERNEL_ATOL) and the flat jnp
    oracle (KERNEL_ATOL: both dequantize in f32), in all five modes."""
    coopt, (jq, jkv, jsc, jcl, jphys, jlog), (tq, tkv, tsc, tcl, tphys,
                                              tlog) = \
        _decode_inputs(mode, window, sink)
    opt_gqa = True if window else coopt.opt_gqa
    jks, jvs = (jsc[0], jsc[1]) if jsc is not None else (None, None)
    tks, tvs = (tsc[0], tsc[1]) if tsc is not None else (None, None)
    got = paged_pool_decode_ref(tq, tkv[0], tkv[1], tks, tvs, tcl, tphys,
                                tlog, opt_kv=coopt.opt_kv, opt_gqa=opt_gqa,
                                window=window, sink_pages=sink)
    kern = jpd.paged_pool_decode(jq, jkv[0], jkv[1], jks, jvs, jcl, jphys,
                                 jlog, opt_kv=coopt.opt_kv, opt_gqa=opt_gqa,
                                 window=window, sink_pages=sink,
                                 interpret=True)
    oracle = jref.paged_pool_decode_ref(jq, jkv[0], jkv[1], jks, jvs, jcl,
                                        jphys, jlog, opt_kv=coopt.opt_kv,
                                        window=window, sink_pages=sink)
    np.testing.assert_allclose(_t2n(got), _f32(kern), atol=KERNEL_ATOL)
    np.testing.assert_allclose(_t2n(got), _f32(oracle), atol=KERNEL_ATOL)
    # the port's flat oracle is the JAX one
    mine = ref.paged_pool_decode_ref(tq, tkv[0], tkv[1], tks, tvs, tcl,
                                     tphys, tlog, opt_kv=coopt.opt_kv,
                                     window=window, sink_pages=sink)
    np.testing.assert_allclose(_t2n(mine), _f32(oracle), atol=KERNEL_ATOL)


# ------------------------------------------------------------------ K4 ----
def _shared_tables(seed=3):
    """Four lanes; lanes 0-2 share a 3-page prefix at the same slots."""
    rng = np.random.default_rng(seed)
    phys = rng.permutation(40)[:24].reshape(4, 6).astype(np.int32)
    phys[1:3, :3] = phys[0, :3]
    phys[3, 4:] = -1
    log = np.broadcast_to(np.arange(6, dtype=np.int32), (4, 6)).copy()
    log[3, 4:] = -1
    return phys, log


def test_plan_visits_matches_jax():
    """plan_visits == the JAX planner exactly, bitmask sign bit included."""
    phys, log = _shared_tables()
    for p, l in ((phys, log),
                 (np.tile(phys[:1], (32, 1)), np.tile(log[:1], (32, 1)))):
        want = jvisits.plan_visits(jnp.asarray(p), jnp.asarray(l))
        got = visits.plan_visits(torch.from_numpy(p), torch.from_numpy(l))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_equal(visits.sharing_stats(phys),
                            jvisits.sharing_stats(phys))


@pytest.mark.parametrize("opt_kv,opt_gqa", [(True, True), (False, False)])
def test_visit_decode_plain_bit_identical_to_pool_decode_plain(opt_kv,
                                                               opt_gqa):
    """K4 plain == K2 plain exactly (torch.equal), and K4 plain vs the JAX
    visit kernel in interpret mode within KERNEL_ATOL."""
    rng = np.random.default_rng(4)
    ps, Hkv, G, D = 16, 2, 4, 64
    phys, log = _shared_tables()
    jkv, jsc, tkv, tsc = _pool(rng, 40, ps, Hkv, D, opt_kv)
    jq, tq = _bf16(rng.standard_normal((4, Hkv * G, D)).astype(np.float32))
    jcl, tcl = _i32([90, 96, 60, 50])
    tks, tvs = (tsc[0], tsc[1]) if opt_kv else (None, None)
    tphys, tlog = torch.from_numpy(phys), torch.from_numpy(log)
    vp, vm, vl = visits.plan_visits(tphys, tlog)
    k4 = paged_pool_decode_visits_ref(tq, tkv[0], tkv[1], tks, tvs, tcl, vp,
                                      vm, vl, opt_kv=opt_kv, opt_gqa=opt_gqa)
    k2 = paged_pool_decode_ref(tq, tkv[0], tkv[1], tks, tvs, tcl, tphys,
                               tlog, opt_kv=opt_kv, opt_gqa=opt_gqa)
    assert torch.equal(k4, k2)
    jks, jvs = (jsc[0], jsc[1]) if opt_kv else (None, None)
    jvp, jvm, jvl = jvisits.plan_visits(jnp.asarray(phys), jnp.asarray(log))
    kern = jpd.paged_pool_decode_visits(jq, jkv[0], jkv[1], jks, jvs, jcl,
                                        jvp, jvm, jvl, opt_kv=opt_kv,
                                        opt_gqa=opt_gqa, interpret=True)
    np.testing.assert_allclose(_t2n(k4), _f32(kern), atol=KERNEL_ATOL)


def test_ops_decode_routes_visits_by_lane_count():
    """ops.paged_pool_decode takes the visit list for 1 < B <= 32 with
    share_visits and the per-lane version otherwise; both agree."""
    rng = np.random.default_rng(5)
    phys, log = _shared_tables()
    _, _, tkv, tsc = _pool(rng, 40, 16, 2, 64, True)
    q = torch.from_numpy(rng.standard_normal((4, 8, 64)).astype(
        np.float32)).to(torch.bfloat16)
    cl = torch.tensor([90, 96, 60, 50], dtype=torch.int32)
    a = ops.paged_pool_decode(q, tkv, tsc, cl, torch.from_numpy(phys),
                              torch.from_numpy(log), opt_kv=True,
                              opt_gqa=True, share_visits=True)
    b = ops.paged_pool_decode(q, tkv, tsc, cl, torch.from_numpy(phys),
                              torch.from_numpy(log), opt_kv=True,
                              opt_gqa=True, share_visits=False)
    assert torch.equal(a, b)
    assert ops._use_visits(True, 4) and not ops._use_visits(True, 1)
    assert not ops._use_visits(True, 33) and not ops._use_visits(False, 4)
    # K4 holds a head's B * G rows in one block's shared memory: where its
    # one-page plan does not fit, K2 (the same bits) serves the step.
    # (share, B, Hq, Hkv, D, ps, opt_kv, opt_gqa) -> K4?
    for args, k4 in (((True, 32, 32, 8, 128, 64, True, True), True),   # qwen3-4b
                     ((True, 32, 32, 8, 128, 128, False, True), True),
                     ((True, 32, 64, 8, 128, 128, True, True), False),  # G 8
                     ((True, 32, 64, 8, 128, 64, False, True), False),
                     ((True, 22, 64, 8, 128, 128, True, True), True),
                     ((True, 23, 64, 8, 128, 128, True, True), False),
                     ((True, 32, 56, 8, 128, 64, True, True), True),    # G 7
                     ((True, 32, 64, 8, 128, 128, True, False), True),  # MHA
                     ((False, 4, 32, 8, 128, 64, True, True), False),
                     ((True, 1, 64, 8, 128, 64, True, True), False)):
        assert ops._gqa_use_visits(*args) is k4, args


def test_ops_decode_routes_oversized_visit_plans_to_k2(monkeypatch):
    """At G 8 and 32 lanes (fp8 pages of 128) K4's plan does not fit a
    block, so ops.paged_pool_decode runs K2 and never K4, with share_visits
    on; its output equals K2's."""
    rng = np.random.default_rng(6)
    B, Hkv, G, D, ps = 32, 1, 8, 128, 128
    _, _, tkv, tsc = _pool(rng, B + 1, ps, Hkv, D, True)
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, D)).astype(
        np.float32)).to(torch.bfloat16)
    phys = torch.arange(B, dtype=torch.int32)[:, None].contiguous()
    phys[1:] = 0                                  # one shared page
    log = torch.zeros((B, 1), dtype=torch.int32)
    cl = torch.from_numpy(rng.integers(1, ps + 1, B).astype(np.int32))

    def refuse(*a, **k):
        raise AssertionError("K4 called for a plan that does not fit")
    monkeypatch.setattr(pdm, "paged_pool_decode_visits", refuse)
    got = ops.paged_pool_decode(q, tkv, tsc, cl, phys, log, opt_kv=True,
                                opt_gqa=True, share_visits=True)
    k2 = paged_pool_decode_ref(q, tkv[0], tkv[1], tsc[0], tsc[1], cl, phys,
                               log, opt_kv=True, opt_gqa=True)
    assert torch.equal(got, k2)


# ---------------------------------------------- K2 / K4 split-page decode ----
@pytest.mark.parametrize("nsel,lane_heads,sms", [
    (16, 32, 132), (128, 32, 132), (16, 8, 132), (1, 32, 132), (0, 32, 132),
    (7, 8, 5), (67, 8, 132), (8, 256, 132), (1000, 1, 1)])
def test_decode_splits_cover_every_slot_once(nsel, lane_heads, sms):
    """decode_splits cuts the slots into ascending ranges that cover each
    slot exactly once, with enough splits for _BLOCKS_PER_SM blocks an SM
    where the slots allow; K4's visit ranges [s0 * B, s1 * B) hold exactly
    the same slots of every lane (plan_visits is slot-major), so both
    kernels meet each lane's live slots split by split in the same order."""
    slots, splits = pdm.decode_splits(nsel, lane_heads, sms)
    ranges = [(z * slots, min((z + 1) * slots, nsel)) for z in range(splits)]
    assert slots >= 1 and splits >= 1
    assert [i for a, b in ranges for i in range(a, b)] == list(range(nsel))
    assert all(a < b for a, b in ranges) or nsel == 0
    # the fewest slots a split whose count stays within the aim
    aim = max(min(-(-pdm._BLOCKS_PER_SM * sms // lane_heads), nsel), 1)
    assert splits <= aim
    assert slots == 1 or -(-nsel // (slots - 1)) > aim
    B = 3
    rng = np.random.default_rng(nsel)
    phys = rng.integers(-1, 4, (B, nsel)).astype(np.int32)
    phys[1:, : nsel // 2] = phys[0, : nsel // 2]          # shared prefix
    log = np.where(phys >= 0, np.arange(nsel, dtype=np.int32), -1)
    vp, vm, vl = (x.numpy() for x in visits.plan_visits(
        torch.from_numpy(phys), torch.from_numpy(log.astype(np.int32))))
    for a, b in ranges:
        for lane in range(B):
            mine = [v // B for v in range(a * B, b * B)
                    if vp[v] >= 0 and (int(vm[v]) >> lane) & 1]
            assert mine == [s for s in range(a, b) if phys[lane, s] >= 0]


def _split_emulation(q, kv, sc, cl, phys, log, slots, *, opt_kv, opt_gqa,
                     window=0, sink=0, visits_form=False):
    """The split-page kernels' arithmetic in PyTorch f32: the slots cut
    into splits of ``slots`` (as decode_splits gives them), each split's
    (m, l, acc) from the plain update over its slots (``visits_form``: over
    its visits [s0 * B, s1 * B) of plan_visits, member rows only), merged
    in split order: m = max m_s, l = sum l_s e^(m_s - m), acc likewise.
    Returns the f32 output (B, Hq, D) before the bf16 rounding."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = kv[0].shape
    heads, G, kv_of = pdm._geometry(Hq, Hkv, opt_gqa, q.device)
    qf = q.float().reshape(B, heads, G, D)
    ks, vs = (sc[0], sc[1]) if opt_kv else (None, None)
    nsel = phys.shape[1]
    j = torch.arange(ps)
    lane = torch.arange(B)
    upd = dict(window=window, sink_pages=sink, ps=ps,
               sm_scale=1.0 / np.sqrt(D))
    vp, vm, vl = visits.plan_visits(phys, log)

    def update(state, ids, pos, member):
        k = pdm._lane_pages(kv[0], ks, ids, kv_of, opt_kv)
        v = pdm._lane_pages(kv[1], vs, ids, kv_of, opt_kv)
        return pdm._decode_update(qf, k, v, pos, cl, member, state, **upd)

    parts = []
    for s0 in range(0, max(nsel, 1), slots):
        s1 = min(s0 + slots, nsel)
        st = pdm._init_state(B, heads, G, D, q.device)
        if not visits_form:
            for s in range(s0, s1):
                page = phys[:, s].long()
                pos = log[:, s].long().clamp_min(0)[:, None] * ps + j
                st = update(st, page.clamp_min(0), pos, page >= 0)
        else:
            for v in range(s0 * B, s1 * B):
                if int(vp[v]) < 0:
                    continue
                pos = (int(vl[v]) * ps + j)[None].expand(B, ps)
                st = update(st, torch.full((B,), int(vp[v])), pos,
                            ((int(vm[v]) >> lane) & 1).bool())
        parts.append(st)
    m = torch.stack([p[0] for p in parts]).amax(0)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:
        w = torch.exp(pm - m)
        l = l + pl * w
        acc = acc + pa * w[..., None]
    return (acc / l.clamp_min(1e-30)[..., None]).reshape(B, Hq, D)


# The split merge re-associates the f32 online softmax: a few f32 ulps of
# the output, far inside the bf16 ulp the card tests hold the kernels to.
SPLIT_RTOL, SPLIT_ATOL = 2 ** -16, 2 ** -20


@pytest.mark.parametrize("mode", ["coopt", "original"])
@pytest.mark.parametrize("window,sink", [(0, 0), (32, 1)])
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_split_emulation_matches_plain_and_pallas(mode, window, sink, slots):
    """The split-then-merge arithmetic against the plain version (one
    split: the same bits; more: within SPLIT_RTOL/ATOL in f32) and against
    the JAX kernel in interpret mode (within one bf16 ulp, KERNEL_ATOL)."""
    coopt, (jq, jkv, jsc, jcl, jphys, jlog), (tq, tkv, tsc, tcl, tphys,
                                              tlog) = \
        _decode_inputs(mode, window, sink)
    opt_gqa = True if window else coopt.opt_gqa
    kw = dict(opt_kv=coopt.opt_kv, opt_gqa=opt_gqa, window=window,
              sink=sink)
    one = _split_emulation(tq, tkv, tsc, tcl, tphys, tlog, tphys.shape[1],
                           **kw)
    tks, tvs = (tsc[0], tsc[1]) if tsc is not None else (None, None)
    plain = paged_pool_decode_ref(tq, tkv[0], tkv[1], tks, tvs, tcl, tphys,
                                  tlog, opt_kv=coopt.opt_kv, opt_gqa=opt_gqa,
                                  window=window, sink_pages=sink)
    assert torch.equal(one.to(torch.bfloat16), plain)
    got = _split_emulation(tq, tkv, tsc, tcl, tphys, tlog, slots, **kw)
    torch.testing.assert_close(got, one, rtol=SPLIT_RTOL, atol=SPLIT_ATOL)
    jks, jvs = (jsc[0], jsc[1]) if jsc is not None else (None, None)
    kern = jpd.paged_pool_decode(jq, jkv[0], jkv[1], jks, jvs, jcl, jphys,
                                 jlog, opt_kv=coopt.opt_kv, opt_gqa=opt_gqa,
                                 window=window, sink_pages=sink,
                                 interpret=True)
    np.testing.assert_allclose(_t2n(got.to(torch.bfloat16)), _f32(kern),
                               atol=KERNEL_ATOL)


@pytest.mark.parametrize("opt_kv,opt_gqa", [(True, True), (False, False)])
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_split_emulation_visit_form_bit_identical(opt_kv, opt_gqa, slots):
    """K4's split over visits [s0 * B, s1 * B) gives the same bits as K2's
    split over slots [s0, s1): the per-lane and visit-list emulations are
    torch.equal in f32, on tables with a prefix shared by three lanes and a
    lane with -1 holes."""
    rng = np.random.default_rng(6)
    ps, Hkv, G, D = 16, 2, 4, 64
    phys, log = _shared_tables()
    _, _, tkv, tsc = _pool(rng, 40, ps, Hkv, D, opt_kv)
    tq = torch.from_numpy(rng.standard_normal((4, Hkv * G, D)).astype(
        np.float32)).to(torch.bfloat16)
    tcl = torch.tensor([90, 96, 60, 50], dtype=torch.int32)
    args = (tq, tkv, tsc, tcl, torch.from_numpy(phys), torch.from_numpy(log),
            slots)
    lanes = _split_emulation(*args, opt_kv=opt_kv, opt_gqa=opt_gqa)
    visit = _split_emulation(*args, opt_kv=opt_kv, opt_gqa=opt_gqa,
                             visits_form=True)
    assert torch.equal(lanes, visit)


def test_decode_smem_plan():
    """The wrappers' shared-memory plan (csrc ``make_layout``): at qwen3-4b's
    widths K2 (1 lane) and K4 (4 lanes) take a 2-page ring in a third of
    the SM's shared memory (3 blocks an SM); K4 fits 32 lanes of G 4 at D
    128 with pages of 128 bf16 tokens on a 1-page ring, not on 2; 32
    lanes of G 16 do not fit at all."""
    limit = pdm._SMEM_LIMIT
    assert pdm._smem_bytes(64, 128, 1, 1, 4, nstage=2) <= limit // 3
    assert pdm._smem_bytes(64, 128, 1, 4, 4, nstage=2) <= limit // 3
    assert pdm._smem_bytes(128, 128, 2, 32, 4) <= limit
    assert pdm._smem_bytes(128, 128, 2, 32, 4, nstage=2) > limit
    assert pdm._smem_bytes(64, 128, 1, 32, 16) > limit


# ------------------------------------------------------ K1-K4 at D 256 ----
# recurrentgemma-9b's local attention: head_dim 256, 16 query heads on one
# kv head (MQA, G 16), a window with one sink page.
D256 = dict(Hkv=1, G=16, D=256)


def test_decode_smem_plan_at_head_dim_256():
    """At G 16, D 256 and fp8 pages of 64 tokens K2's block (~100 KB) and
    K4's at 4 lanes (~174 KB) fit one block's shared memory on a one-page
    ring; K4's fits up to 6 lanes, and ops sends 8 lanes to K2."""
    limit = pdm._SMEM_LIMIT
    assert pdm._smem_bytes(64, 256, 1, 1, 16) <= limit // 2
    assert pdm._smem_bytes(64, 256, 1, 4, 16) <= limit
    assert pdm.plan_fits(6, 16, 1, 256, 64, True, True)
    assert not pdm.plan_fits(7, 16, 1, 256, 64, True, True)
    assert ops._gqa_use_visits(True, 4, 16, 1, 256, 64, True, True)
    assert not ops._gqa_use_visits(True, 8, 16, 1, 256, 64, True, True)


@pytest.mark.parametrize("opt_kv", [False, True])
def test_pool_decode_plain_at_head_dim_256(opt_kv):
    """K2 plain at D 256, G 16, Hkv 1, windowed with a sink page, vs the
    interpret kernel and the flat jnp oracle (KERNEL_ATOL: one bf16 ulp);
    K4 plain over the same tables equals K2 plain bit for bit."""
    mode = "coopt" if opt_kv else "opt-gqa"
    window, sink = 32, 1
    coopt, (jq, jkv, jsc, jcl, jphys, jlog), (tq, tkv, tsc, tcl, tphys,
                                              tlog) = \
        _decode_inputs(mode, window, sink, **D256)
    jks, jvs = (jsc[0], jsc[1]) if jsc is not None else (None, None)
    tks, tvs = (tsc[0], tsc[1]) if tsc is not None else (None, None)
    kw = dict(opt_kv=coopt.opt_kv, opt_gqa=True, window=window,
              sink_pages=sink)
    got = paged_pool_decode_ref(tq, tkv[0], tkv[1], tks, tvs, tcl, tphys,
                                tlog, **kw)
    kern = jpd.paged_pool_decode(jq, jkv[0], jkv[1], jks, jvs, jcl, jphys,
                                 jlog, interpret=True, **kw)
    oracle = jref.paged_pool_decode_ref(jq, jkv[0], jkv[1], jks, jvs, jcl,
                                        jphys, jlog, opt_kv=coopt.opt_kv,
                                        window=window, sink_pages=sink)
    np.testing.assert_allclose(_t2n(got), _f32(kern), atol=KERNEL_ATOL)
    np.testing.assert_allclose(_t2n(got), _f32(oracle), atol=KERNEL_ATOL)
    vp, vm, vl = visits.plan_visits(tphys, tlog)
    k4 = paged_pool_decode_visits_ref(tq, tkv[0], tkv[1], tks, tvs, tcl, vp,
                                      vm, vl, **kw)
    assert torch.equal(k4, got)


@pytest.mark.parametrize("opt_kv", [False, True])
def test_chunk_prefill_plain_at_head_dim_256(opt_kv):
    """K3 plain at D 256, G 16, Hkv 1, windowed with a sink page, vs the
    interpret kernel (KERNEL_ATOL) and the jnp ``paged_chunk_attention``
    (JNP_ATOL)."""
    window, sink = 16, 1
    (jq, jkv, jsc, jpos, jpt), (tq, tkv, tsc, tpos, tpt) = \
        _chunk_case(opt_kv, **D256)
    got = ops.paged_chunk_prefill(tq, tpos, tkv, tsc, tpt, opt_kv=opt_kv,
                                  opt_gqa=True, window=window,
                                  sink_pages=sink)
    kern = jops.paged_chunk_prefill(jq, jpos, jkv, jsc, jpt, opt_kv=opt_kv,
                                    opt_gqa=True, window=window,
                                    sink_pages=sink)
    exp = jchunk(jq, jkv, jsc, jpos, jpt,
                 JMODES["coopt"].replace(opt_kv=opt_kv), window=window,
                 sink_pages=sink)
    np.testing.assert_allclose(_t2n(got), _f32(kern), atol=KERNEL_ATOL)
    np.testing.assert_allclose(_t2n(got), _f32(exp), atol=JNP_ATOL)


# ------------------------------------------------------------------ K3 ----
def _chunk_case(opt_kv, seed=7, Hkv=2, G=4, D=64):
    rng = np.random.default_rng(seed)
    B, P, ps, S = 2, 4, 16, 8
    jkv, jsc, tkv, tsc = _pool(rng, B * P, ps, Hkv, D, opt_kv)
    jq, tq = _bf16(rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32))
    # lane 0: a continuation chunk at positions [24, 32); lane 1: a decode
    # lane (one token at 40, padding clamped to it) with its last page -1
    pos = np.stack([np.arange(24, 32), np.full(S, 40)])
    pt = np.arange(B * P).reshape(B, P)
    pt[1, P - 1] = -1
    (jpos, tpos), (jpt, tpt) = _i32(pos), _i32(pt)
    return (jq, jkv, jsc, jpos, jpt), (tq, tkv, tsc, tpos, tpt)


@pytest.mark.parametrize("opt_kv,opt_gqa,window,sink", [
    (False, True, 0, 0), (True, True, 0, 0), (True, False, 0, 0),
    (True, True, 32, 1)])
def test_chunk_prefill_plain_matches_pallas_and_jnp(opt_kv, opt_gqa, window,
                                                   sink):
    """K3 plain (unpacked) vs the interpret kernel (KERNEL_ATOL) and the jnp
    ``paged_chunk_attention`` (JNP_ATOL)."""
    (jq, jkv, jsc, jpos, jpt), (tq, tkv, tsc, tpos, tpt) = _chunk_case(opt_kv)
    got = ops.paged_chunk_prefill(tq, tpos, tkv, tsc, tpt, opt_kv=opt_kv,
                                  opt_gqa=opt_gqa, window=window,
                                  sink_pages=sink)
    kern = jops.paged_chunk_prefill(jq, jpos, jkv, jsc, jpt, opt_kv=opt_kv,
                                    opt_gqa=opt_gqa, window=window,
                                    sink_pages=sink)
    cfg = JMODES["coopt"].replace(opt_kv=opt_kv, opt_gqa=opt_gqa)
    exp = jchunk(jq, jkv, jsc, jpos, jpt, cfg, window=window,
                 sink_pages=sink)
    np.testing.assert_allclose(_t2n(got), _f32(kern), atol=KERNEL_ATOL)
    np.testing.assert_allclose(_t2n(got), _f32(exp), atol=JNP_ATOL)
    # the port's jnp-style reference is the JAX one
    mine = paged_chunk_attention(tq, tkv, tsc, tpos, tpt,
                                 MODES["coopt"].replace(opt_kv=opt_kv,
                                                        opt_gqa=opt_gqa),
                                 window=window, sink_pages=sink)
    np.testing.assert_allclose(_t2n(mine), _f32(exp), atol=KERNEL_ATOL)


def test_chunk_prefill_plain_packed_matches_pallas_and_jnp():
    """Concat-prefill packing: two prompts share one row as segments (seg
    0: 20 tokens on slots 0-1, seg 1: 10 tokens on slot 2, 2 pad columns).
    K3 plain vs the interpret kernel (KERNEL_ATOL) and the jnp reference
    (JNP_ATOL) on the real rows; pad rows are exactly 0."""
    rng = np.random.default_rng(8)
    ps, Hkv, G, D, S = 16, 2, 2, 64, 32
    jkv, jsc, tkv, tsc = _pool(rng, 6, ps, Hkv, D, True)
    jq, tq = _bf16(rng.standard_normal((1, S, Hkv * G, D)).astype(np.float32))
    pos = np.concatenate([np.arange(20), np.arange(10), [9, 9]])[None]
    seg = np.concatenate([np.zeros(20), np.ones(10), [-1, -1]])[None]
    pt, pseg, pbase = [[4, 1, 3, -1]], [[0, 0, 1, 0]], [[0, 1, 0, 0]]
    j, t = zip(*(_i32(x) for x in (pos, seg, pt, pseg, pbase)))
    got = ops.paged_chunk_prefill(tq, t[0], tkv, tsc, t[2], opt_kv=True,
                                  opt_gqa=True, seg_q=t[1], page_seg=t[3],
                                  page_base=t[4])
    kern = jfc.flash_chunk_prefill(jq, j[0], jkv[0], jkv[1], jsc[0], jsc[1],
                                   j[2], opt_kv=True, opt_gqa=True,
                                   interpret=True, seg_q=j[1], page_seg=j[3],
                                   page_base=j[4])
    exp = jchunk(jq, jkv, jsc, j[0], j[2], JMODES["coopt"], seg_q=j[1],
                 page_seg=j[3], page_base=j[4])
    real = slice(0, 30)
    np.testing.assert_allclose(_t2n(got)[:, real], _f32(kern)[:, real],
                               atol=KERNEL_ATOL)
    np.testing.assert_allclose(_t2n(got)[:, real], _f32(exp)[:, real],
                               atol=JNP_ATOL)
    assert torch.all(got[:, 30:] == 0)
    mine = flash_chunk_prefill_ref(tq, t[0], tkv[0], tkv[1], tsc[0], tsc[1],
                                   t[2], opt_kv=True, seg_q=t[1],
                                   page_seg=t[3], page_base=t[4])
    assert torch.equal(mine, got)


def test_wrappers_raise_on_unsupported_device():
    """A tensor that is neither on the CPU nor on CUDA never reaches a
    plain version."""
    q = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.zeros((2, 2, 16, 2, 64), dtype=torch.float8_e4m3fn,
                     device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.paged_pool_decode(q, kv, None, torch.ones(1, dtype=torch.int32,
                                                       device="meta"),
                              torch.zeros((1, 2), dtype=torch.int32,
                                          device="meta"),
                              torch.zeros((1, 2), dtype=torch.int32,
                                          device="meta"),
                              opt_kv=True, opt_gqa=True)


# ------------------------------------------------------------------ K8 ----
@pytest.mark.parametrize("S,T,Hq,Hkv,D,window,q_offset", [
    (128, 128, 8, 2, 64, 0, 0),
    (128, 128, 8, 2, 64, 32, 0),
    (64, 64, 4, 1, 128, 0, 0),          # MQA
    (96, 96, 14, 2, 64, 0, 0),          # odd G = 7, a ragged key block
    (32, 96, 4, 4, 64, 40, 64),         # q_offset: the last 32 of 96 keys
])
def test_flash_prefill_plain_matches_pallas_and_oracle(S, T, Hq, Hkv, D,
                                                       window, q_offset):
    """K8 plain vs the interpret kernel (KERNEL_ATOL) and the flat oracle
    (KERNEL_ATOL), and the port's oracle vs the JAX one."""
    from repro.kernels import flash_prefill as jfp
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    rng = np.random.default_rng(9)
    B = 2
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16(rng.standard_normal(s).astype(np.float32))
        for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    got = ops.flash_prefill(tq, tk, tv, window=window, q_offset=q_offset)
    assert got.dtype == torch.bfloat16
    if q_offset == 0:                 # the Pallas tiling wants S == T
        kern = jfp.flash_prefill(jq, jk, jv, window=window, block_q=64,
                                 block_k=32, interpret=True)
        np.testing.assert_allclose(_t2n(got), _f32(kern), atol=KERNEL_ATOL)
    oracle = jref.flash_prefill_ref(jq, jk, jv, window=window,
                                    q_offset=q_offset)
    np.testing.assert_allclose(_t2n(got), _f32(oracle), atol=KERNEL_ATOL)
    mine = ref.flash_prefill_ref(tq, tk, tv, window=window, q_offset=q_offset)
    np.testing.assert_allclose(_t2n(mine), _f32(oracle), atol=KERNEL_ATOL)
    assert torch.equal(flash_prefill_ref(tq, tk, tv, window=window,
                                         q_offset=q_offset), got)


# ------------------------------------------------------------- build -----
def test_build_hash_sees_every_header():
    """A library's file name hashes its source and ``cuda._HEADERS``, so
    every header a source includes must be listed there (else an edited
    header leaves a stale library loadable under an unchanged name), and
    every listed source and header must exist."""
    import re
    from repro_torch.kernels import cuda
    csrc = cuda._CSRC
    files = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    included = {m for f in files
                for m in re.findall(r'#include\s+"([^"]+)"', f.read_text())}
    assert included, "no local includes found"
    assert included <= set(cuda._HEADERS), included - set(cuda._HEADERS)
    for name in tuple(cuda.SOURCES.values()) + cuda._HEADERS:
        assert (csrc / name).is_file(), name
    assert {f.name for f in csrc.glob("*.cu")} == set(cuda.SOURCES.values())


def _tile_emulation(q, k, v, p_round):
    """K8's tensor-core tile arithmetic (``csrc/mma_attention.cuh``) in
    PyTorch: 64-key tiles, bf16 inputs with f32 sums, the online softmax in
    the log2 domain, and P rounded by ``p_round`` (a list of terms whose sum
    approximates P) before the P V products."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    R = S * G
    qf = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, R, D)
    spos = torch.arange(S).repeat_interleave(G)
    m = torch.full((B, Hkv, R), -1e30)
    l = torch.zeros((B, Hkv, R))
    o = torch.zeros((B, Hkv, R, D))
    scale = 1.4426950408889634 / np.sqrt(D)
    for k0 in range(0, S, 64):
        kb = k[:, k0:k0 + 64].float().transpose(1, 2)
        vb = v[:, k0:k0 + 64].float().transpose(1, 2)
        live = (k0 + torch.arange(kb.shape[2]))[None, :] <= spos[:, None]
        s = torch.where(live, torch.matmul(qf, kb.transpose(-1, -2)) * scale,
                        -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None]
        for term in p_round(p):
            o = o + torch.matmul(term, vb)
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, Hq, D).to(torch.bfloat16)


def test_p_as_two_bf16_terms_holds_one_ulp():
    """Why K3 and K8 carry P into the P V product as two bf16 terms: the
    tile arithmetic with P = bf16(P) + bf16(P - bf16(P)) stays within one
    bf16 ulp of the plain version (the card tests' tolerance), while P
    rounded once to bf16, or to fp16's 10-bit significand, does not."""
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    rng = np.random.default_rng(13)
    B, S, Hq, Hkv, D = 1, 1024, 8, 2, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16)
               for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    plain = flash_prefill_ref(q, k, v).float()
    tol = 2 ** -14 + 2 ** -7 * plain.abs()

    def bf16(x):
        return x.to(torch.bfloat16).float()

    def share(p_round):
        got = _tile_emulation(q, k, v, p_round).float()
        return ((got - plain).abs() / tol).max().item()

    two_terms = share(lambda p: (bf16(p), bf16(p - bf16(p))))
    once = share(lambda p: (bf16(p),))
    fp16 = share(lambda p: (p.half().float(),))
    assert two_terms <= 1 < fp16 < once, (two_terms, fp16, once)


def _latent_tile_emulation(q_lat, q_rope, positions, lat, sc, sm_scale, q_terms,
                           p_terms):
    """K6's tensor-core tile arithmetic (``csrc/latent_chunk_prefill.cu``) in
    PyTorch, one lane, pages of 64 keys in slot order: q_lat and q_rope as
    ``q_terms`` bf16 terms against the exact fp8 values, the latent and rope
    scores scaled per key column after the products, the online softmax in
    the log2 domain with masked probabilities hard-zeroed, and P' = p * sc0
    as ``p_terms`` bf16 terms against the same exact latent values."""
    def terms(x, n):
        out = []
        for _ in range(n):
            out.append(x.to(torch.bfloat16).float())
            x = x - out[-1]
        return out

    _, S, H, R = q_lat.shape
    NP, ps, _ = lat.shape
    qc = terms(q_lat.reshape(S * H, R), q_terms)
    qr = terms(q_rope.reshape(S * H, -1), q_terms)
    qpos = positions[0].long().repeat_interleave(H)
    m = torch.full((S * H,), -1e30)
    l = torch.zeros(S * H)
    acc = torch.zeros((S * H, R))
    scale = sm_scale * 1.4426950408889634
    for page in range(NP):
        x = lat[page].float()
        c, r = x[:, :R], x[:, R:]
        s = (sum(t @ c.T for t in qc) * sc[page, :, 0]
             + sum(t @ r.T for t in qr) * sc[page, :, 1]) * scale
        live = (page * ps + torch.arange(ps))[None] <= qpos[:, None]
        s = torch.where(live, s, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[:, None] + sum(
            t @ c for t in terms(p * sc[page, :, 0], p_terms))
        m = m_new
    return (acc / l.clamp_min(1e-30)[:, None]).reshape(q_lat.shape)


def test_latent_tile_three_q_terms_hold_f32_tolerance():
    """Why K6 carries q (q_lat, q_rope) into its score MMAs as three bf16
    terms and P' = p * sc0 into P' C as two: at deepseek-v2-lite's widths
    (R 512, dr 64, H 16) over an fp8 pool with dual scales, 256 tokens at
    the end of 1024 keys, that tile arithmetic stays within the f32
    tolerance the card holds K6 to (LAT_RTOL 2^-12, LAT_ATOL 2^-16) of the
    plain version with under half the error of two q terms (which the
    card's larger kernel-phase shape takes past the tolerance), while q or
    P' as one bf16 term is far outside it."""
    from repro_torch.cache.quant import quantize_latent
    from repro_torch.kernels.latent_chunk_prefill import \
        latent_chunk_prefill_ref
    rng = np.random.default_rng(16)
    R, dr, H, ps, NP, S = 512, 64, 16, 64, 16, 256
    lat = torch.from_numpy(rng.standard_normal((NP, ps, R + dr)).astype(
        np.float32))
    lat[..., R:] *= 3.0                         # k_rope on its own scale
    lat, sc = quantize_latent(lat, R)
    q_lat, q_rope = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((1, S, H, R), (1, S, H, dr)))
    pos = torch.arange(NP * ps - S, NP * ps, dtype=torch.int32)[None]
    sm_scale = 1.0 / (128 + dr) ** 0.5
    plain = latent_chunk_prefill_ref(
        q_lat, q_rope, pos, lat, sc, torch.arange(NP, dtype=torch.int32)[None],
        sm_scale=sm_scale, opt_kv=True)
    tol = 2 ** -16 + 2 ** -12 * plain.abs()

    def share(q_terms, p_terms):
        got = _latent_tile_emulation(q_lat, q_rope, pos, lat, sc, sm_scale,
                                     q_terms, p_terms)
        return ((got - plain).abs() / tol).max().item()

    k6, two_q = share(3, 2), share(2, 2)
    assert k6 <= 1 and 2 * k6 < two_q, (k6, two_q)
    assert share(1, 2) > 1 and share(3, 1) > 1


# ------------------------------------------- K5 / K7 split-page decode ----
@pytest.mark.parametrize("nsel,B,sms", [
    (16, 4, 132), (64, 32, 132), (6, 4, 132), (1, 4, 132), (0, 4, 132),
    (40, 1, 132), (7, 4, 5), (600, 2, 1), (2560, 1, 132), (3, 32, 132)])
def test_latent_splits_cover_every_slot_once(nsel, B, sms):
    """latent_splits cuts the slots into ascending ranges that cover each
    slot exactly once, in at most _MAX_SPLITS splits (a lane's splits are
    one thread-block cluster); K7's visit ranges [s0 * B, s1 * B) hold
    exactly the same live slots of every lane (plan_visits is slot-major),
    so K5 and K7 meet each lane's pages split by split in the same order."""
    from repro_torch.kernels import paged_latent_decode as ld
    slots, splits = ld.latent_splits(nsel, B, sms)
    ranges = [(z * slots, min((z + 1) * slots, nsel)) for z in range(splits)]
    assert slots >= 1 and 1 <= splits <= ld._MAX_SPLITS
    assert [i for a, b in ranges for i in range(a, b)] == list(range(nsel))
    assert all(a < b for a, b in ranges) or nsel == 0
    # the fewest slots a split that keep K5's B * splits blocks within one
    # an SM and the cluster's _MAX_SPLITS
    cap = max(min(ld._MAX_SPLITS, -(-sms // B)), 1)
    assert splits <= cap
    assert slots == 1 or -(-nsel // (slots - 1)) > cap
    rng = np.random.default_rng(nsel + B)
    n = min(nsel, 64)                           # the plan check, cut short
    phys = rng.integers(-1, 4, (B, n)).astype(np.int32)
    phys[1:, : n // 2] = phys[0, : n // 2]      # shared prefix
    log = np.where(phys >= 0, np.arange(n, dtype=np.int32), -1)
    vp, vm, vl = (x.numpy() for x in visits.plan_visits(
        torch.from_numpy(phys), torch.from_numpy(log.astype(np.int32))))
    for a, b in ranges:
        for lane in range(B):
            mine = [v // B for v in range(a * B, min(b, n) * B)
                    if vp[v] >= 0 and (int(vm[v]) >> lane) & 1]
            assert mine == [s for s in range(a, min(b, n))
                            if phys[lane, s] >= 0]


def test_ops_latent_decode_routes_every_visit_plan_to_k7(monkeypatch):
    """K7 holds a fixed number of lanes a block, whatever B, so it gains no
    limit of its own: ops.paged_latent_decode with share_visits runs K7 for
    every 1 < B <= 32 and K5 for B 1 and B 33 (K7's int32 lane bitmask),
    through the one predicate ``ops._use_visits``."""
    from repro_torch.kernels import paged_latent_decode as ld
    calls = []

    def spy(name):
        def fn(q_lat, *a, **k):
            calls.append((name, q_lat.shape[0]))
            return torch.zeros_like(q_lat)
        return fn
    monkeypatch.setattr(ld, "paged_latent_decode", spy("k5"))
    monkeypatch.setattr(ld, "paged_latent_decode_visits", spy("k7"))
    R, dr, ps = 64, 32, 16
    lat = torch.zeros((2, ps, R + dr), dtype=torch.bfloat16)
    for B in (1, 2, 17, 32, 33):
        phys = torch.zeros((B, 1), dtype=torch.int32)
        ql, qr = torch.zeros((B, 4, R)), torch.zeros((B, 4, dr))
        ops.paged_latent_decode(ql, qr, lat, None, torch.ones(B), phys, phys,
                                sm_scale=0.1, opt_kv=False, share_visits=True)
        ops.paged_latent_decode(ql, qr, lat, None, torch.ones(B), phys, phys,
                                sm_scale=0.1, opt_kv=False, share_visits=False)
    assert calls == [("k5", 1), ("k5", 1), ("k7", 2), ("k5", 2), ("k7", 17),
                     ("k5", 17), ("k7", 32), ("k5", 32), ("k5", 33),
                     ("k5", 33)]


def _latent_decode_split_emulation(q_lat, q_rope, lat, sc, cache_len, phys,
                                   log, sm_scale, slots, q_terms, p_terms,
                                   window=0, sink=0):
    """K5's and K7's arithmetic (``csrc/paged_latent_decode.cu`` on the tile
    of ``csrc/latent_mma.cuh``) in PyTorch: each lane's table slots cut into
    splits of ``slots``; each split's (m, l, acc) from 64-key tiles of its
    pages in slot order (q_lat and q_rope as ``q_terms`` bf16 terms against
    the exact fp8 values, each key's scales after the products, the online
    softmax in the log2 domain, masked probabilities hard-zeroed, P' = p *
    sc0 as ``p_terms`` bf16 terms); then the splits merged in ascending
    order: m = max m_s, l = sum l_s 2^(m_s - m), acc likewise."""
    def terms(x, n):
        out = []
        for _ in range(n):
            out.append(x.to(torch.bfloat16).float())
            x = x - out[-1]
        return out

    B, H, R = q_lat.shape
    _, ps, _ = lat.shape
    nsel = phys.shape[1]
    scale = sm_scale * 1.4426950408889634
    out = torch.zeros((B, H, R))
    for b in range(B):
        qc, qr = terms(q_lat[b], q_terms), terms(q_rope[b], q_terms)
        length = int(cache_len[b])
        parts = []
        for s0 in range(0, max(nsel, 1), slots):
            m = torch.full((H,), -1e30)
            l = torch.zeros(H)
            acc = torch.zeros((H, R))
            for s in range(s0, min(s0 + slots, nsel)):
                page = int(phys[b, s])
                if page < 0:
                    continue
                for j0 in range(0, ps, 64):
                    x = lat[page, j0:j0 + 64].float()
                    c, r = x[:, :R], x[:, R:]
                    s0c, s1c = sc[page, j0:j0 + 64, 0], sc[page, j0:j0 + 64, 1]
                    pos = int(log[b, s]) * ps + j0 + torch.arange(x.shape[0])
                    live = pos < length
                    if window:
                        live &= (pos >= max(length - window, 0)) | \
                            (pos < sink * ps)
                    sc_ = (sum(t @ c.T for t in qc) * s0c
                           + sum(t @ r.T for t in qr) * s1c) * scale
                    sc_ = torch.where(live[None], sc_, -float("inf"))
                    m_new = torch.maximum(m, sc_.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(sc_ - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + sum(
                        t @ c for t in terms(p * s0c, p_terms))
                    m = m_new
            parts.append((m, l, acc))
        mm = torch.stack([p[0] for p in parts]).amax(0)
        ll, aa = torch.zeros(H), torch.zeros((H, R))
        for pm, pl, pa in parts:
            w = torch.exp2(pm - mm)
            ll = ll + pl * w
            aa = aa + pa * w[:, None]
        out[b] = aa / ll.clamp_min(1e-30)[:, None]
    return out


def test_latent_decode_split_merge_holds_f32_tolerance():
    """Why K5 and K7 may split a lane's pages across blocks and merge the
    splits in the same launch: at deepseek-v2-lite's widths (R 512, dr 64,
    H 16) over an fp8 pool with dual scales and a window + sink, the tile
    arithmetic with q as three bf16 terms and P' as two stays within the
    f32 tolerance the card holds K5 to (LAT_RTOL 2^-12, LAT_ATOL 2^-16) of
    the plain version with one split, 3 and 12 (one slot each), while the
    same arithmetic with q as one bf16 term is far outside it."""
    from repro_torch.cache.quant import quantize_latent
    from repro_torch.kernels.paged_latent_decode import \
        paged_latent_decode_ref
    rng = np.random.default_rng(17)
    R, dr, H, ps, NP, B = 512, 64, 16, 64, 12, 2
    lat = torch.from_numpy(rng.standard_normal((B * NP, ps, R + dr)).astype(
        np.float32))
    lat[..., R:] *= 3.0                         # k_rope on its own scale
    lat, sc = quantize_latent(lat, R)
    q_lat, q_rope = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, H, R), (B, H, dr)))
    table = torch.arange(B * NP, dtype=torch.int32).reshape(B, NP)
    table[1, :4] = table[0, :4]                 # a shared prefix
    cache_len = torch.tensor([NP * ps, NP * ps - 37], dtype=torch.int32)
    window, sink = 500, 1
    phys, log = decode_page_select(cache_len, table, ps, window=window,
                                   sink_pages=sink)
    sm_scale = 1.0 / (128 + dr) ** 0.5
    plain = paged_latent_decode_ref(q_lat, q_rope, lat, sc, cache_len, phys,
                                    log, sm_scale=sm_scale, opt_kv=True,
                                    window=window, sink_pages=sink)
    tol = 2 ** -16 + 2 ** -12 * plain.abs()

    def share(slots, q_terms):
        got = _latent_decode_split_emulation(
            q_lat, q_rope, lat, sc, cache_len, phys, log, sm_scale, slots,
            q_terms, 2, window, sink)
        return ((got - plain).abs() / tol).max().item()

    for slots in (NP, 4, 1):
        assert share(slots, 3) <= 1, slots
    assert share(4, 1) > 1
