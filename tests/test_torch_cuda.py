"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and ``nvcc`` (the kernels are built at first use)
and skip elsewhere; run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` makes the same checks at the main path's full shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cache.quant import quantize_fp8  # noqa: E402
from repro_torch.core.opt_kv import decode_page_select  # noqa: E402
from repro_torch.kernels import cuda, ops, visits  # noqa: E402
from repro_torch.kernels import flash_chunk_prefill as fc  # noqa: E402
from repro_torch.kernels import kv_cache_write as kw  # noqa: E402
from repro_torch.kernels import paged_gqa_decode as pd  # noqa: E402

pytestmark = pytest.mark.cuda
# Both sides sum in f32 in different orders and round to bf16, so they may
# land on neighbouring bf16 values: RTOL admits one bf16 ulp anywhere in a
# binade (an ulp is 2**-8 to 2**-7 of |x|), ATOL nothing near zero beyond
# 2**-14 (as in chip_smoke.py).
RTOL, ATOL = 2 ** -7, 2 ** -14


def _assert_close(got, plain):
    torch.testing.assert_close(got.float(), plain.float(), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pool(dev, P, ps, Hkv, D, opt_kv, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
    v = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
    if opt_kv:
        (kq, ks), (vq, vs) = quantize_fp8(k), quantize_fp8(v)
        return torch.stack([kq, vq]), torch.stack([ks, vs])
    return torch.stack([k, v]).to(torch.bfloat16), None


# K1 cases: (opt_kv, D, Hkv, B, S, slots). "base": distinct random slots,
# every 7th token dropped (-1); "none": every slot -1; "pool_edge": the
# pool's last line (NSlot - 1) written, slots past the pool dropped;
# "values": an all-zero vector, e4m3 ties and +-448 saturation at scale 1,
# bf16 subnormals.
_WRITE_CASES = (
    [(o, D, 4, 2, 40, "base") for o in (False, True) for D in (64, 128)]
    + [(o, D, h, 2, 40, "base") for h in (1, 2, 8, 40) for D in (64, 128)
       for o in (False, True)]
    + [(True, 128, 8, 4, 1, "base"), (False, 64, 2, 4, 1, "base"),
       (True, 128, 8, 2, 2048, "base"), (False, 128, 8, 2, 2048, "base"),
       (True, 64, 40, 2, 2048, "base"),
       (True, 128, 8, 2, 40, "none"), (False, 64, 2, 2, 40, "none"),
       (True, 128, 8, 2, 40, "pool_edge"), (False, 64, 40, 2, 40, "pool_edge"),
       (True, 128, 8, 2, 40, "values"), (True, 64, 2, 2, 40, "values"),
       (False, 128, 8, 2, 40, "values")]
    # recurrentgemma-9b's local attention: D 256 on one kv head (a group is
    # a whole warp), its decode step, mixed chunk and the value edges
    + [(o, 256, 1, 2, 40, "base") for o in (False, True)]
    + [(True, 256, 1, 4, 1, "base"), (True, 256, 1, 4, 512, "base"),
       (True, 256, 1, 2, 40, "none"), (True, 256, 1, 2, 40, "pool_edge"),
       (True, 256, 1, 2, 40, "values")]
    # whisper-small's decoder self-attention: D 64 on 12 kv heads (G 1),
    # its decode step, a 512-token chunk step, a bf16 pool, the value edges
    + [(True, 64, 12, 4, 1, "base"), (True, 64, 12, 4, 512, "base"),
       (False, 64, 12, 2, 40, "base"), (True, 64, 12, 2, 40, "values"),
       (True, 64, 12, 2, 40, "pool_edge")])
_EDGE = [1.0625, 1.1875, -1.0625, 432.0, -432.0, 0.0, 3.25, 208.0]


def _write_inputs(dev, opt_kv, D, Hkv, B, S, case):
    g = torch.Generator(device=dev).manual_seed(1)
    kn = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    vn = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    ps = 16
    P = max(8, -(-B * S * 8 // 7 // ps) + 1)
    slots = torch.randperm(P * ps - 1, generator=g, device=dev)[:B * S]
    slots = slots.reshape(B, S).to(torch.int32)
    slots[:, ::7] = -1
    if case == "none":
        slots[:] = -1
    elif case == "pool_edge":
        slots[0, 1] = P * ps - 1                   # the last line: written
        slots[0, 2], slots[1, 3] = P * ps, 2 ** 31 - 1      # past: dropped
    elif case == "values":                         # tokens (0, 1), (0, 2)
        kn[0, 1, :, :8] = torch.tensor(_EDGE)  # ties at scale 1
        kn[0, 1, :, 8:] = 0.0
        kn[0, 1, :, 8] = 448.0
        kn[0, 2] = 0.0                             # all zero: scale eps
        bits = torch.arange(1, D + 1, device=dev, dtype=torch.int16)
        bits[1::2] |= -2 ** 15                     # negative subnormals
        vn[0, 1] = bits.view(torch.bfloat16)
        vn[0, 2, :, ::2] *= 2 ** -130              # subnormals beside normals
    dt = torch.float8_e4m3fn if opt_kv else torch.bfloat16
    # the pool starts as random bytes: lines no token writes must keep them
    a = torch.randint(0, 256, (2, P, ps, Hkv, D * dt.itemsize),
                      generator=g, device=dev, dtype=torch.uint8).view(dt)
    sa = torch.rand((2, P, ps, Hkv), generator=g, device=dev) \
        if opt_kv else None
    return kn, vn, slots, a, sa


@pytest.mark.parametrize("opt_kv,D,Hkv,B,S,case", _WRITE_CASES)
def test_kv_cache_write_bytes(dev, opt_kv, D, Hkv, B, S, case):
    """K1 equals its plain version bit for bit (pool bytes and scales, every
    line), in one launch; lines no valid slot names keep their bytes."""
    kn, vn, slots, a, sa = _write_inputs(dev, opt_kv, D, Hkv, B, S, case)
    _, P, ps, _, _ = a.shape
    b, sb = a.clone(), None if sa is None else sa.clone()
    cuda.reset_launches()
    ops.kv_cache_write(a, sa, kn, vn, slots, opt_kv=opt_kv)
    assert cuda.LAUNCHES["kv_cache_write"] == 1
    fb = b.view(2, P * ps, Hkv, D)
    fs = sb.view(2, P * ps, Hkv) if opt_kv else (None, None)
    init = fb.clone()
    sinit = sb.view(2, P * ps, Hkv).clone() if opt_kv else None
    kw.kv_cache_write_ref(kn, vn, slots, fb[0], fb[1], fs[0], fs[1],
                          opt_kv=opt_kv)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    if opt_kv:
        assert torch.equal(sa, sb)
    flat = slots.reshape(-1)
    written = torch.zeros(P * ps, dtype=torch.bool, device=dev)
    written[flat[(flat >= 0) & (flat < P * ps)].long()] = True
    fa = a.view(2, P * ps, Hkv, D)
    assert torch.equal(fa[:, ~written].view(torch.uint8),
                       init[:, ~written].view(torch.uint8))
    if opt_kv:
        assert torch.equal(sa.view(2, P * ps, Hkv)[:, ~written],
                           sinit[:, ~written])
    if case == "values" and opt_kv:
        ties, zero = slots[0, 1].item(), slots[0, 2].item()
        want = [1.0, 1.25, -1.0, 448.0, -448.0, 0.0, 3.25, 208.0, 448.0]
        assert fa[0, ties, :, :9].float().tolist() == [want] * Hkv
        assert torch.all(fa[0, zero].view(torch.uint8) == 0)  # +0 bytes
        eps = (torch.tensor(1e-12) / torch.tensor(448.0)).item()
        assert torch.all(sa.view(2, -1, Hkv)[0, zero] == eps)


def test_kv_cache_write_refuses_misaligned_views(dev):
    """A new-token or cache view off a 16-byte boundary raises ValueError
    before any launch."""
    kn, vn, slots, a, sa = _write_inputs(dev, True, 128, 8, 2, 40, "base")
    _, P, ps, Hkv, D = a.shape
    flat = a.view(2, P * ps, Hkv, D)
    n = kn.numel()
    off = torch.empty(n + 8, dtype=torch.bfloat16, device=dev)[1:n + 1]
    bad_new = off.view(kn.shape).copy_(kn)
    m = P * ps * Hkv * D
    bad_cache = torch.empty(m + 16, dtype=torch.uint8, device=dev)[8:m + 8]
    bad_cache = bad_cache.view(torch.float8_e4m3fn).view(P * ps, Hkv, D)
    sflat = sa.view(2, P * ps, Hkv)
    cuda.reset_launches()
    for args in ((bad_new, vn, flat[0], flat[1]),
                 (kn, bad_new, flat[0], flat[1]),
                 (kn, vn, bad_cache, flat[1]), (kn, vn, flat[0], bad_cache)):
        with pytest.raises(ValueError, match="16-byte"):
            kw.kv_cache_write(args[0], args[1], slots, args[2], args[3],
                              sflat[0], sflat[1], opt_kv=True)
    assert cuda.LAUNCHES["kv_cache_write"] == 0


_DECODE_MODES = [(True, True, 0, 0), (False, True, 0, 0), (True, False, 0, 0),
                 (True, True, 48, 1)]
# case: (lanes B, table slots NP, page size ps, SM count handed to
# decode_splits or None for the card's). With Hkv 2 (G 4) the 8 or 16
# (lane, head) pairs of 4 lanes give one slot a split on the card's 132
# SMs; a small SM count makes the splits longer.
_DECODE_CASES = {
    "base": (4, 6, 32, None),          # lanes 1-2 share 2 pages
    "ragged_splits": (4, 7, 32, 5),    # 3 slots a split: [0,3) [3,6) [6,7)
    "nsel1": (4, 1, 32, None),         # one slot a lane
    "dead_split": (4, 8, 32, 7),       # slots 2-3 of every lane are -1
    "first_page": (4, 6, 32, 6),       # lanes 1 and 3 end inside page 0
    "window_split": (4, 10, 16, 6),    # window + sink pages in 2 splits
    "ps8": (4, 20, 8, 5), "ps16": (4, 10, 16, None),
    "ps128": (4, 3, 128, None),
    "b1": (1, 6, 32, None), "b2": (2, 6, 32, 3),
    "b32": (32, 3, 32, None),          # page 0 shared by all 32: bit 31
    "all_share": (4, 6, 32, 6),        # a 3-page prefix of every lane
    # the served models' head groups on the engine's 64-token pages:
    # qwen2.5-14b (G 5), yi-34b (G 7), deepseek-67b (G 8), llama13b (G 1)
    "g5": (4, 16, 64, None), "g7": (4, 16, 64, None),
    "g8": (4, 16, 64, None), "g1": (4, 16, 64, None),
    # recurrentgemma-9b (G 16, one kv head, D 256): 4 lanes, and 6, the
    # most whose K4 plan fits a block
    "g16": (4, 32, 64, None), "g16b6": (6, 8, 64, None),
    # whisper-small (G 1 on 12 kv heads, D 64): 4 lanes sharing a prefix,
    # and one lane (K2)
    "w12": (4, 16, 64, None), "w12b1": (1, 16, 64, None),
}
# (Hkv, G) of a case; G 4 over 2 KV heads otherwise
_DECODE_HEADS = {"g5": (8, 5), "g7": (8, 7), "g8": (8, 8), "g1": (40, 1),
                 "g16": (1, 16), "g16b6": (1, 16), "w12": (12, 1),
                 "w12b1": (12, 1)}


def _decode_tables(case, dev):
    B, NP, ps, _ = _DECODE_CASES[case]
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    cl = [NP * ps - (b * 29) % (NP * ps // 2) for b in range(B)]
    if case == "base":
        table[1:3, :2] = table[0, :2]
        cl = [NP * ps, 150, 70, 33]
    elif case == "all_share":
        table[1:, :3] = table[0, :3]
    elif case == "b32":
        table[:, 0] = table[0, 0]
    elif B > 1:
        table[1:, :NP // 3] = table[0, :NP // 3]
    if case == "dead_split":
        table[:, 2:4] = -1
    if case == "first_page":
        cl[1], cl[3] = 5, 1
    return table, torch.tensor(cl, dtype=torch.int32, device=dev)


@pytest.mark.parametrize(
    "opt_kv,opt_gqa,window,sink,D,case",
    [m + (D, "base") for D in (64, 128) for m in _DECODE_MODES]
    # the split's edges: ragged and one-slot tables, a split of -1 slots,
    # a lane ending in its first page, window + sink across a split, MHA
    # with splits, pages of 8, 16 and 128, K4 at 1, 2 and 32 lanes, a
    # prefix shared by every lane
    + [(True, True, 0, 0, 128, "ragged_splits"),
       (False, True, 0, 0, 128, "ragged_splits"),
       (True, False, 0, 0, 128, "ragged_splits"),
       (True, True, 0, 0, 128, "nsel1"), (True, True, 0, 0, 128, "dead_split"),
       (True, True, 0, 0, 128, "first_page"),
       (True, True, 48, 1, 128, "window_split"),
       (True, True, 48, 1, 64, "window_split"),
       (True, True, 0, 0, 128, "ps8"), (True, True, 0, 0, 64, "ps8"),
       (False, True, 0, 0, 128, "ps16"), (True, True, 0, 0, 128, "ps128"),
       (False, True, 0, 0, 128, "ps128"), (True, True, 0, 0, 128, "b1"),
       (True, True, 0, 0, 128, "b2"), (True, True, 0, 0, 128, "b32"),
       (False, False, 0, 0, 64, "b32"), (True, True, 0, 0, 128, "all_share")]
    # K4 at the served models' G, fp8 and bf16 pools
    + [(kv, True, 0, 0, 128, g) for g in ("g5", "g7", "g8", "g1")
       for kv in (True, False)]
    # D 256: G 16 on one kv head, plain and windowed with a sink page
    + [(kv, True, w, s, 256, "g16") for kv in (True, False)
       for w, s in ((0, 0), (2048, 1), (96, 1))]
    + [(True, True, 96, 1, 256, "b1"), (True, True, 96, 1, 256, "g16b6")]
    # D 64, G 1 on 12 kv heads (whisper-small), fp8 and bf16 pools, Opt-GQA
    # off, one lane
    + [(kv, gqa, 0, 0, 64, "w12") for kv, gqa in
       ((True, True), (False, True), (True, False))]
    + [(True, True, 0, 0, 64, "w12b1")])
def test_decode_kernels(dev, monkeypatch, opt_kv, opt_gqa, window, sink, D,
                        case):
    """K2 vs its plain version within one bf16 ulp; K4 bit-identical to
    K2."""
    _, NP, ps, sms = _DECODE_CASES[case]
    if sms is not None:       # the wrapper keys its SM count by q.device
        monkeypatch.setitem(pd._SMS, torch.device(
            "cuda", torch.cuda.current_device()), sms)
    Hkv, G = _DECODE_HEADS.get(case, (2, 4))
    table, cl = _decode_tables(case, dev)
    B = table.shape[0]
    kv, sc = _pool(dev, B * NP + 1, ps, Hkv, D, opt_kv)
    phys, log = decode_page_select(cl, table, ps, window=window,
                                   sink_pages=sink)
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((B, Hkv * G, D), generator=g, device=dev).bfloat16()
    ks, vs = (sc[0], sc[1]) if opt_kv else (None, None)
    gqa = True if window else opt_gqa
    k2 = pd.paged_pool_decode(q, kv[0], kv[1], ks, vs, cl, phys, log,
                              opt_kv=opt_kv, opt_gqa=gqa, window=window,
                              sink_pages=sink)
    plain = pd.paged_pool_decode_ref(q, kv[0], kv[1], ks, vs, cl, phys, log,
                                     opt_kv=opt_kv, opt_gqa=gqa,
                                     window=window, sink_pages=sink)
    vp, vm, vl = visits.plan_visits(phys, log)
    k4 = pd.paged_pool_decode_visits(q, kv[0], kv[1], ks, vs, cl, vp, vm, vl,
                                     opt_kv=opt_kv, opt_gqa=gqa,
                                     window=window, sink_pages=sink)
    torch.cuda.synchronize()
    _assert_close(k2, plain)
    assert torch.equal(k4, k2)


@pytest.mark.parametrize("visit_list", [False, True])
def test_decode_launches_once(dev, visit_list):
    """One K2 or K4 call is one launch, splits and merge included."""
    table, cl = _decode_tables("ragged_splits", dev)
    kv, sc = _pool(dev, table.numel() + 1, 32, 2, 128, True)
    phys, log = decode_page_select(cl, table, 32)
    q = torch.zeros((4, 8, 128), device=dev).bfloat16()
    cuda.reset_launches()
    if visit_list:
        pd.paged_pool_decode_visits(q, kv[0], kv[1], sc[0], sc[1], cl,
                                    *visits.plan_visits(phys, log),
                                    opt_kv=True, opt_gqa=True)
    else:
        pd.paged_pool_decode(q, kv[0], kv[1], sc[0], sc[1], cl, phys, log,
                             opt_kv=True, opt_gqa=True)
    torch.cuda.synchronize()
    name = "paged_pool_decode_visits" if visit_list else "paged_pool_decode"
    assert cuda.LAUNCHES[name] == 1
    assert sum(cuda.LAUNCHES.values()) == 1


@pytest.mark.parametrize("opt_kv,ps", [(True, 128), (False, 64)])
def test_decode_routes_oversized_visit_plan_to_k2(dev, opt_kv, ps):
    """G 8 at 32 lanes: K4's one-page plan does not fit one block's shared
    memory (its wrapper refuses it), so ops.paged_pool_decode with
    share_visits runs K2, whose output it is bit for bit."""
    B, Hkv, G, D, NP = 32, 8, 8, 128, 3
    kv, sc = _pool(dev, B * NP + 1, ps, Hkv, D, opt_kv)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[:, 0] = table[0, 0]                          # a shared first page
    cl = torch.tensor([ps + (b * 37) % (2 * ps) + 1 for b in range(B)],
                      dtype=torch.int32, device=dev)
    phys, log = decode_page_select(cl, table, ps)
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, Hkv * G, D), generator=g, device=dev).bfloat16()
    ks, vs = (sc[0], sc[1]) if opt_kv else (None, None)
    cuda.reset_launches()
    got = ops.paged_pool_decode(q, kv, sc, cl, phys, log, opt_kv=opt_kv,
                                opt_gqa=True, share_visits=True)
    launches = dict(cuda.LAUNCHES)
    k2 = pd.paged_pool_decode(q, kv[0], kv[1], ks, vs, cl, phys, log,
                              opt_kv=opt_kv, opt_gqa=True)
    plain = pd.paged_pool_decode_ref(q, kv[0], kv[1], ks, vs, cl, phys, log,
                                     opt_kv=opt_kv, opt_gqa=True)
    torch.cuda.synchronize()
    assert launches["paged_pool_decode"] == 1
    assert launches["paged_pool_decode_visits"] == 0
    assert torch.equal(got, k2)
    _assert_close(k2, plain)
    with pytest.raises(ValueError):
        pd.paged_pool_decode_visits(q, kv[0], kv[1], ks, vs, cl,
                                    *visits.plan_visits(phys, log),
                                    opt_kv=opt_kv, opt_gqa=True)


@pytest.mark.parametrize("opt_kv", [True, False])
def test_head_dim_256_kernel_info(dev, opt_kv):
    """The D 256 instantiations of K1 (one and two vectors a thread), K2,
    K4 and K3 load and report their resources: at most 255 registers a
    thread, and K3's dynamic shared memory at pages of 64 within a block's
    227 KB."""
    infos = [kw.kernel_info(256, opt_kv, v, dev) for v in (1, 2)] + \
        [pd.kernel_info(256, opt_kv, v, dev) for v in (False, True)] + \
        [fc.kernel_info(256, opt_kv, 64, dev)]
    assert all(0 < i["registers"] <= 255 for i in infos)
    assert infos[-1]["smem_bytes"] <= 232448


_CHUNK_MODES = [(True, True, 0), (False, True, 0), (True, False, 0),
                (True, True, 40)]


@pytest.mark.parametrize(
    "opt_kv,opt_gqa,window,packed,D,ps,S",
    [m + (p, 128, 32, 40) for p in (False, True) for m in _CHUNK_MODES]
    # the edges of the tensor-core tiles: D 64; pages of 8 (half a 16-key
    # step, padded with zero rows), 16 and 128 (two tile updates a page);
    # decode lanes only (S = 1); S * G = 92 rows, not a multiple of a tile
    + [m + (p, 64, 32, 40) for p in (False, True) for m in _CHUNK_MODES]
    + [(kv, True, w, p, 128, ps, 40) for ps in (8, 16, 128)
       for kv in (True, False) for w, p in ((0, False), (40, True))]
    + [(kv, gqa, 0, False, 128, 32, 1) for kv, gqa in
       ((True, True), (False, True), (True, False))]
    + [(kv, True, w, False, D, 32, 23) for kv in (True, False)
       for w, D in ((0, 128), (40, 64))]
    # D 256 (Q's fragments read from shared memory at each use), the
    # engine's pages of 64, packed and windowed
    + [(kv, True, w, p, 256, 64, 40) for kv in (True, False)
       for w, p in ((0, False), (40, False), (0, True))])
def test_chunk_kernel(dev, opt_kv, opt_gqa, window, packed, D, ps, S):
    """K3 vs its plain version within one bf16 ulp, a chunk lane and decode
    lanes. ``packed``: lane 0's row holds two prompts as segments (24 rows
    at [0, 24) and 12 rows at [30, 42) whose page_base restarts at 0, then 4
    pad rows of segment -1), and its table interleaves the two segments'
    pages, so each segment's rows meet a live page of the other; the other
    lanes pass planes equal to the unpacked defaults. The lanes hold at
    least 160 keys whatever the page size."""
    B, Hkv, G = 3, 2, 4
    NP = max(5, 160 // ps)
    kv, sc = _pool(dev, B * NP, ps, Hkv, D, opt_kv)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[2, -1] = -1
    pos = torch.empty((B, S), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(100, 100 + S, device=dev)
    pos[1] = 60
    pos[2] = 127
    planes = {}
    if packed:
        i32 = dict(dtype=torch.int32, device=dev)
        pos[0] = torch.cat([torch.arange(24, **i32),
                            torch.arange(30, 42, **i32),
                            torch.full((4,), 41, **i32)])
        seg_q = torch.zeros((B, S), **i32)
        seg_q[0, 24:36] = 1
        seg_q[0, 36:] = -1
        table[0] = -1
        table[0, :4] = torch.tensor([0, 1, 2, 3], **i32)
        page_seg = torch.zeros((B, NP), **i32)
        page_seg[0, :4] = torch.tensor([0, 1, 1, 0], **i32)
        page_base = torch.arange(NP, **i32).repeat(B, 1).contiguous()
        page_base[0] = 0
        page_base[0, :4] = torch.tensor([0, 0, 1, 1], **i32)
        planes = dict(seg_q=seg_q, page_seg=page_seg, page_base=page_base)
    q = torch.randn((B, S, Hkv * G, D), device=dev).bfloat16()
    ks, vs = (sc[0], sc[1]) if opt_kv else (None, None)
    got = ops.paged_chunk_prefill(q, pos, kv, sc, table, opt_kv=opt_kv,
                                  opt_gqa=opt_gqa, window=window, sink_pages=1,
                                  **planes)
    plain = fc.flash_chunk_prefill_ref(q, pos, kv[0], kv[1], ks, vs, table,
                                       opt_kv=opt_kv, opt_gqa=opt_gqa,
                                       window=window, sink_pages=1, **planes)
    torch.cuda.synchronize()
    _assert_close(got, plain)
    if packed:
        assert torch.all(got[0, 36:] == 0)            # pad rows see no key


@pytest.mark.parametrize("opt_kv", [True, False])
@pytest.mark.parametrize("S", [64, 512])
def test_chunk_kernel_whisper_heads(dev, opt_kv, S):
    """K3 at whisper-small's decoder widths (D 64, G 1 on 12 kv heads, one
    query row a head in a tile) on the engine's pages of 64: one chunk lane
    at [200, 200 + S) beside 3 decode lanes (one token, the padding
    clamped to it), within one bf16 ulp of its plain version; a control
    with the newest key of each lane masked off must fall outside it."""
    B, Hkv, G, D, ps = 4, 12, 1, 64, 64
    NP = -(-(200 + S) // ps)
    kv, sc = _pool(dev, B * NP, ps, Hkv, D, opt_kv)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[1:, :2] = table[0, :2]                  # a shared 128-token prefix
    pos = torch.empty((B, S), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(200, 200 + S, device=dev)
    for b in range(1, B):
        pos[b] = 150 + 31 * b
    q = torch.randn((B, S, Hkv * G, D), device=dev).bfloat16()
    ks, vs = (sc[0], sc[1]) if opt_kv else (None, None)
    got = ops.paged_chunk_prefill(q, pos, kv, sc, table, opt_kv=opt_kv,
                                  opt_gqa=True)
    plain = fc.flash_chunk_prefill_ref(q, pos, kv[0], kv[1], ks, vs, table,
                                       opt_kv=opt_kv, opt_gqa=True)
    control = fc.flash_chunk_prefill_ref(q, pos - 1, kv[0], kv[1], ks, vs,
                                         table, opt_kv=opt_kv, opt_gqa=True)
    torch.cuda.synchronize()
    _assert_close(got, plain)
    diff = (got.float() - control.float()).abs()
    assert bool((diff > ATOL + RTOL * control.float().abs()).any())


def test_launch_counts(dev):
    cuda.reset_launches()
    test_kv_cache_write_bytes(dev, True, 128, 4, 2, 40, "base")
    assert cuda.LAUNCHES["kv_cache_write"] == 1
    assert cuda.LAUNCHES["paged_pool_decode"] == 0


def test_full_prefill_kernel_path_launches_k8(dev):
    """The dense full-prompt prefill with ``use_kernel`` runs K8 once per
    layer, and K1 beside it."""
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    cfg = get_config("qwen3-4b-reduced")
    model = get_model(cfg)
    coopt = COOPT.replace(use_kernel=True)
    params = model.init(0, dev)
    cache = model.init_cache(1, 64, coopt, device=dev)
    toks = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    cuda.reset_launches()
    logits, _ = model.prefill(params, {"tokens": toks}, cache, coopt)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert cuda.LAUNCHES["flash_prefill"] == cfg.num_layers
    assert cuda.LAUNCHES["kv_cache_write"] == cfg.num_layers


# ------------------------------------------------ MLA latent kernels ------
# K5 and K6 return f32: kernel and plain version sum in f32 in different
# orders (FMA chains and warp butterflies against PyTorch's reductions), a
# few f32 ulps apart. LAT_RTOL / LAT_ATOL (as in chip_smoke.py) are far
# tighter than the bf16 criterion.
LAT_RTOL, LAT_ATOL = 2 ** -12, 2 ** -16


def _latent_pool(dev, P, ps, R, dr, opt_kv, seed=0):
    from repro_torch.cache.quant import quantize_latent
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn((P, ps, R + dr), generator=g, device=dev)
    if opt_kv:
        return quantize_latent(lat, R)
    return lat.to(torch.bfloat16), None


def _latent_q(dev, shape, dr, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev),
            torch.randn(shape[:-1] + (dr,), generator=g, device=dev))


# case: (lanes B, table slots NP, page size ps, heads H, SM count handed to
# latent_splits or None for the card's). On the card's 132 SMs a lane of a
# few pages gets one slot a split; one SM gives one split; 9 SMs give the
# 4-lane tables 3 slots a split.
_LATENT_CASES = {
    "base": (4, 6, 32, 16, None),      # lanes 1-2 share 2 pages
    "one_split": (4, 6, 32, 16, 1),
    "ragged_splits": (4, 7, 32, 16, 9),   # [0,3) [3,6) [6,7)
    "window_split": (4, 10, 16, 16, 6),   # window + sink pages in 2 splits
    "dead_lane": (4, 6, 32, 16, None),    # lane 2's pages all -1
    "original": (4, 6, 32, 16, 5),     # every page, tiles past the length
    "b1": (1, 6, 32, 16, None), "b2": (2, 6, 32, 16, 3),
    "b17": (17, 3, 64, 16, None),      # an odd lane count: a half block
    "b32": (32, 3, 32, 16, None),      # page 0 shared by all 32: bit 31
    "b32_one_split": (32, 4, 64, 16, 1),
    "ps8": (4, 20, 8, 16, 5), "ps16": (4, 10, 16, 16, None),
    "ps64": (4, 4, 64, 16, None), "ps128": (4, 3, 128, 16, None),
    "h4": (4, 6, 32, 4, None),         # the reduced config's 4 heads
    "b1_capped": (1, 40, 16, 16, None),   # 40 slots: splits capped at 8
    "long_list": (2, 600, 8, 16, 1),   # one split of 600 live slots: the
                                       # block lists them in two rounds
    "r64_5_splits": (4, 10, 16, 4, 9),    # 64 columns in 5 slices
}


def _latent_tables(case, shared, dev):
    B, NP, ps, _, _ = _LATENT_CASES[case]
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    cl = [NP * ps - (b * 29) % (NP * ps // 2) for b in range(B)]
    if case in ("base", "one_split", "dead_lane", "h4"):
        cl = [NP * ps, 150, 70, 33]
    if shared:
        if case == "b32":
            table[:, 0] = table[0, 0]
        elif B > 1:
            table[1:3, :max(NP // 3, 1)] = table[0, :max(NP // 3, 1)]
    if case == "dead_lane":
        table[2] = -1
    return table, torch.tensor(cl, dtype=torch.int32, device=dev)


@pytest.mark.parametrize(
    "R,dr,opt_kv,window,sink,shared,case",
    [(R, dr) + m + (sh, "base") for R, dr in ((512, 64), (64, 32))
     for m in ((True, 0, 0), (False, 0, 0), (True, 48, 1), (True, 40, 2))
     for sh in (False, True)]
    # one split and many, ragged splits, window + sink across a split, a
    # lane with no live page, every page of the table (tiles past the
    # length), 1, 2, 17 and 32 lanes, pages of 8 to 128, 4 heads, a split
    # count capped at a cluster's 8 blocks, more live entries than a block
    # lists at once, R 64 merged in 5 column slices
    + [(512, 64, kv, 0, 0, sh, c) for c in (
        "one_split", "ragged_splits", "dead_lane", "original", "b1", "b2",
        "b17", "b32", "b32_one_split", "ps8", "ps16", "ps64", "ps128", "h4")
       for kv, sh in ((True, True), (False, False))]
    + [(512, 64, True, 0, 0, True, c) for c in ("b1_capped", "long_list")]
    + [(512, 64, True, 48, 1, True, "window_split"),
       (64, 32, True, 48, 1, True, "window_split")]
    + [(64, 32, kv, 0, 0, True, c) for c in ("ragged_splits", "b17", "b32",
                                             "ps128", "h4", "r64_5_splits")
       for kv in (True, False)])
def test_latent_decode_kernels(dev, monkeypatch, R, dr, opt_kv, window, sink,
                               shared, case):
    """K5 vs its plain version within LAT_RTOL/LAT_ATOL; K7 bit-identical
    to K5 (layouts in ``_LATENT_CASES``), with lanes sharing a prefix and
    without."""
    from repro_torch.kernels import paged_latent_decode as ld
    B, NP, ps, H, sms = _LATENT_CASES[case]
    if sms is not None:       # the wrapper keys its SM count by q.device
        monkeypatch.setitem(ld._SMS, torch.device(
            "cuda", torch.cuda.current_device()), sms)
    lat, sc = _latent_pool(dev, B * NP + 1, ps, R, dr, opt_kv)
    table, cl = _latent_tables(case, shared, dev)
    phys, log = decode_page_select(cl, table, ps, window=window,
                                   sink_pages=sink,
                                   opt_pa=case != "original")
    ql, qr = _latent_q(dev, (B, H, R), dr)
    kw = dict(sm_scale=0.07, opt_kv=opt_kv, window=window, sink_pages=sink)
    k5 = ld.paged_latent_decode(ql, qr, lat, sc, cl, phys, log, **kw)
    plain = ld.paged_latent_decode_ref(ql, qr, lat, sc, cl, phys, log, **kw)
    vp, vm, vl = visits.plan_visits(phys, log)
    k7 = ld.paged_latent_decode_visits(ql, qr, lat, sc, cl, vp, vm, vl, **kw)
    torch.cuda.synchronize()
    assert k5.dtype == torch.float32
    torch.testing.assert_close(k5, plain, rtol=LAT_RTOL, atol=LAT_ATOL)
    assert torch.equal(k7, k5)
    if case == "dead_lane":
        assert torch.all(k5[2] == 0)


@pytest.mark.parametrize("R,dr,lanes", [(512, 64, 2), (64, 32, 8)])
@pytest.mark.parametrize("opt_kv", [True, False])
def test_latent_decode_kernel_info(dev, R, dr, lanes, opt_kv):
    """One K5 or K7 call is one launch, splits and merge included;
    ``kernel_info`` reports each one's grid (K5: B x splits blocks of one
    lane; K7: ceil(B / lanes) x splits), q and P' as 3 and 2 bf16 terms,
    and no local memory (no spills)."""
    from repro_torch.kernels import paged_latent_decode as ld
    B, NP, ps, H = 5, 6, 32, 16
    lat, sc = _latent_pool(dev, B * NP, ps, R, dr, opt_kv)
    table = torch.arange(B * NP, dtype=torch.int32, device=dev).reshape(B, NP)
    cl = torch.full((B,), NP * ps, dtype=torch.int32, device=dev)
    phys, log = decode_page_select(cl, table, ps)
    ql, qr = _latent_q(dev, (B, H, R), dr)
    kw = dict(sm_scale=0.07, opt_kv=opt_kv)
    slots, splits = ld.latent_splits(NP, B, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    for visit_list, per_block in ((False, 1), (True, lanes)):
        cuda.reset_launches()
        if visit_list:
            ld.paged_latent_decode_visits(ql, qr, lat, sc, cl,
                                          *visits.plan_visits(phys, log), **kw)
        else:
            ld.paged_latent_decode(ql, qr, lat, sc, cl, phys, log, **kw)
        torch.cuda.synchronize()
        assert sum(cuda.LAUNCHES.values()) == 1
        info = ld.kernel_info(R, dr, opt_kv, visit_list, dev)
        assert info["lanes_per_block"] == per_block
        assert splits > 1 and info["last_splits"] == splits
        assert info["last_blocks"] == -(-B // per_block) * splits
        assert (info["q_terms"], info["p_terms"]) == (3, 2)
        assert info["local_bytes"] == 0 and 0 < info["registers"] <= 255


@pytest.mark.parametrize("B", [17, 32])
def test_latent_decode_routes_every_visit_plan_to_k7(dev, B):
    """K7 holds a fixed number of lanes a block, so ops.paged_latent_decode
    with share_visits runs it for every 1 < B <= 32 the Pallas K7 serves,
    with K5's bits."""
    from repro_torch.kernels import paged_latent_decode as ld
    NP, ps, H, R, dr = 3, 64, 16, 512, 64
    lat, sc = _latent_pool(dev, B * NP + 1, ps, R, dr, True)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[:, 0] = table[0, 0]
    cl = torch.tensor([ps + (b * 37) % (2 * ps) + 1 for b in range(B)],
                      dtype=torch.int32, device=dev)
    phys, log = decode_page_select(cl, table, ps)
    ql, qr = _latent_q(dev, (B, H, R), dr)
    kw = dict(sm_scale=0.07, opt_kv=True)
    cuda.reset_launches()
    got = ops.paged_latent_decode(ql, qr, lat, sc, cl, phys, log,
                                  share_visits=True, **kw)
    launches = dict(cuda.LAUNCHES)
    k5 = ld.paged_latent_decode(ql, qr, lat, sc, cl, phys, log, **kw)
    torch.cuda.synchronize()
    assert launches["paged_latent_decode_visits"] == 1
    assert launches["paged_latent_decode"] == 0
    assert torch.equal(got, k5)


def _latent_chunk_layout(case, dev, R, dr, packed):
    """(B, NP, ps, H, S, table, positions, packing planes) of a K6 case.
    "small": a 40-token chunk lane at [100, 140) and decode lanes at 60 and
    127 over 5 pages of 32, lane 2's table ending in -1; ``packed``: lane
    0's row holds two prompts as segments (24 rows at [0, 24) and 12 rows
    at [30, 42) whose page_base restarts at 0, then 4 pad rows of segment
    -1), its table interleaving the two segments' pages. "engine64" /
    "engine128": the engine's mixed step, a 512-token chunk lane at [512,
    1024) and three decode lanes (each padded to 512 rows of its one
    token) over ~1k cached tokens, lane 2's table ending in -1 and lane 1
    missing a page it would read. "h4": 4 heads (the reduced config), a
    100-token chunk: 400 rows, not a multiple of a block's rows. "ragged":
    4 heads at R 512, 41 tokens: 164 rows, the last row group part-filled.
    "future": a chunk lane at [0, 512) whose first 3 slots are -1, so its
    rows below position 192 see no page (every page in their future).
    "decode": four decode lanes of one token (K5's shape, through the
    latent tile K5, K6 and K7 share)."""
    i32 = dict(dtype=torch.int32, device=dev)
    B, NP, ps, H, S = {"small": (3, 5, 32, 16, 40),
                       "engine64": (4, 16, 64, 16, 512),
                       "engine128": (4, 8, 128, 16, 512),
                       "h4": (3, 6, 32, 4, 100),
                       "ragged": (3, 4, 64, 4, 41),
                       "future": (2, 8, 64, 16, 512),
                       "decode": (4, 6, 32, 16, 1)}[case]
    table = torch.arange(B * NP, **i32).reshape(B, NP)
    pos = torch.empty((B, S), **i32)
    planes = {}
    if case in ("engine64", "engine128"):
        pos[0] = torch.arange(512, 1024, **i32)
        for b, n in ((1, 1000), (2, 980), (3, 1010)):
            pos[b] = n - 1
        table[2, -1] = -1
        table[1, 3] = -1
        return B, NP, ps, H, S, table, pos, planes
    if case == "decode":
        pos[:, 0] = torch.tensor([NP * ps - 1, 149, 69, 32], **i32)
        return B, NP, ps, H, S, table, pos, planes
    if case == "future":
        pos[0] = torch.arange(S, **i32)
        pos[1] = 300
        table[0, :3] = -1
        return B, NP, ps, H, S, table, pos, planes
    last = NP * ps - 1
    pos[0] = torch.arange(last - S, last, **i32) if case != "small" else \
        torch.arange(100, 100 + S, **i32)
    pos[1] = 60
    pos[2] = min(127, last)
    table[2, -1] = -1
    if packed:
        pos[0] = torch.cat([torch.arange(24, **i32),
                            torch.arange(30, 42, **i32),
                            torch.full((4,), 41, **i32)])
        seg_q = torch.zeros((B, S), **i32)
        seg_q[0, 24:36] = 1
        seg_q[0, 36:] = -1
        table[0] = torch.tensor([0, 1, 2, 3, -1], **i32)
        page_seg = torch.zeros((B, NP), **i32)
        page_seg[0] = torch.tensor([0, 1, 1, 0, 0], **i32)
        page_base = torch.arange(NP, **i32).repeat(B, 1).contiguous()
        page_base[0] = torch.tensor([0, 0, 1, 1, 0], **i32)
        planes = dict(seg_q=seg_q, page_seg=page_seg, page_base=page_base)
    return B, NP, ps, H, S, table, pos, planes


@pytest.mark.parametrize(
    "opt_kv,window,packed,R,dr,case",
    [m + (p, R, dr, "small") for R, dr in ((512, 64), (64, 32))
     for p in (False, True) for m in ((True, 0), (False, 0), (True, 40))]
    # the engine's mixed step at pages of 64 and 128, fp8 and bf16 pools,
    # with a window; the reduced config's 4 heads; a part-filled row tile;
    # rows that see no page
    + [(kv, w, False, 512, 64, c) for c in ("engine64", "engine128")
       for kv, w in ((True, 0), (False, 0), (True, 300))]
    + [(kv, w, False, 64, 32, "h4") for kv, w in ((True, 0), (False, 40))]
    + [(True, 0, False, 512, 64, "ragged"), (False, 40, False, 512, 64, "ragged")]
    + [(kv, 0, False, 512, 64, c) for c in ("future", "decode")
       for kv in (True, False)])
def test_latent_chunk_kernel(dev, opt_kv, window, packed, R, dr, case):
    """K6 vs its plain version within LAT_RTOL/LAT_ATOL, a chunk lane and
    decode lanes (layouts in ``_latent_chunk_layout``); pad rows of segment
    -1, and rows that see no page, are exactly 0."""
    from repro_torch.kernels import latent_chunk_prefill as lc
    B, NP, ps, H, S, table, pos, planes = _latent_chunk_layout(
        case, dev, R, dr, packed)
    lat, sc = _latent_pool(dev, B * NP, ps, R, dr, opt_kv)
    ql, qr = _latent_q(dev, (B, S, H, R), dr)
    kw = dict(sm_scale=0.07, opt_kv=opt_kv, window=window, sink_pages=1,
              **planes)
    cuda.reset_launches()
    got = ops.latent_chunk_prefill(ql, qr, pos, lat, sc, table, **kw)
    plain = lc.latent_chunk_prefill_ref(ql, qr, pos, lat, sc, table, **kw)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["latent_chunk_prefill"] == 1
    torch.testing.assert_close(got, plain, rtol=LAT_RTOL, atol=LAT_ATOL)
    if packed:
        assert torch.all(got[0, 36:] == 0)            # pad rows see no key
    if case == "future":
        assert torch.all(got[0, :3 * ps] == 0)        # every page in the future
        assert torch.all(got[0, 3 * ps:].abs().amax(-1) > 0)


@pytest.mark.parametrize("R,dr,rows", [(512, 64, 32), (64, 32, 128)])
@pytest.mark.parametrize("opt_kv", [True, False])
def test_latent_chunk_kernel_info(dev, R, dr, rows, opt_kv):
    """``kernel_info`` reports what K6 ran: its launch's grid (B x
    ceil(S * H / rows) blocks), q and P' as 3 and 2 bf16 terms, and no
    local memory (no spills)."""
    from repro_torch.kernels import latent_chunk_prefill as lc
    B, NP, ps, H, S = 2, 3, 32, 4, 41
    lat, sc = _latent_pool(dev, B * NP, ps, R, dr, opt_kv)
    ql, qr = _latent_q(dev, (B, S, H, R), dr)
    table = torch.arange(B * NP, dtype=torch.int32, device=dev).reshape(B, NP)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    ops.latent_chunk_prefill(ql, qr, pos.contiguous(), lat, sc, table,
                             sm_scale=0.07, opt_kv=opt_kv)
    info = lc.kernel_info(R, dr, opt_kv, dev)
    assert (info["rows_per_block"], info["threads"]) == (rows, 256)
    assert info["last_blocks"] == B * -(-S * H // rows)
    assert (info["q_terms"], info["p_terms"]) == (3, 2)
    assert info["local_bytes"] == 0 and 0 < info["registers"] <= 255


@pytest.mark.parametrize("S,T,Hq,Hkv,D,window,q_offset", [
    (256, 256, 32, 8, 128, 0, 0), (200, 200, 8, 8, 64, 0, 0),
    (256, 256, 32, 8, 128, 100, 0), (64, 320, 16, 4, 128, 96, 256),
    (2048, 2048, 32, 8, 128, 0, 0),                   # chip_smoke.py's shape
    (100, 300, 16, 4, 128, 0, 200), (100, 300, 16, 4, 64, 50, 200),
    (130, 130, 8, 8, 128, 0, 0)])                     # G = 1 at D 128
def test_flash_prefill_kernel(dev, S, T, Hq, Hkv, D, window, q_offset):
    """K8 vs its plain version within one bf16 ulp, with a window and a
    q_offset (queries at the last S of T positions), T not a multiple of
    the 64-key block, and G = 1."""
    from repro_torch.kernels import flash_prefill as fp
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16()
               for s in ((2, S, Hq, D), (2, T, Hkv, D), (2, T, Hkv, D)))
    got = ops.flash_prefill(q, k, v, window=window, q_offset=q_offset)
    plain = fp.flash_prefill_ref(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _assert_close(got, plain)


# ------------------------------------------- step runners (CUDA graphs) --
def _graph_engine(dev, temperature=0.0, arch="qwen3-4b-reduced"):
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    return Engine(get_config(arch), COOPT.replace(use_kernel=True),
                  EngineConfig(num_lanes=4, max_len=256,
                               prefill_buckets=(32, 64, 128),
                               sampling=SamplingParams(
                                   temperature=temperature)),
                  device=dev)


def _graph_prompts(n, seed=0, lo=40, hi=200):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(lo, hi)), dtype=np.int32)
            for _ in range(n)]


def _replay_against_eager(eng, sb):
    """Run step ``sb`` eagerly (the body on uploaded inputs) and through
    its runner, from the same pool and feed state. Returns (logits, pool
    and feed after the step) of both; the engine is left after the
    runner's step."""
    from repro_torch.serving.engine import _host_inputs
    host = _host_inputs(sb)
    before = {k: v.clone() for k, v in eng.cache.items()}
    feed = eng.lane_tok.clone()
    inp = {k: torch.as_tensor(v, device=eng.device) for k, v in host.items()}
    logits, _ = eng._async_step(sb.kind, inp)
    eager = (logits.clone(), {k: v.clone() for k, v in eng.cache.items()},
             eng.lane_tok.clone())
    for k, v in before.items():
        eng.cache[k].copy_(v)
    eng.lane_tok.copy_(feed)
    runner = eng._runners[eng._async_key(sb.kind, sb.batch)]
    assert runner.graph is not None
    runner.load(host)
    logits, _ = runner.run()
    torch.cuda.synchronize()
    return eager, (logits.clone(), eng.cache, eng.lane_tok)


@pytest.mark.parametrize("kind", ["decode", "mixed"])
def test_replay_matches_eager_step(dev, kind):
    """A captured decode runner and a captured prefill runner (a mixed step
    of prefill chunks and decode lanes) replayed against the eager body
    from the same pool state: logits, pool bytes and the lane feed
    bit-equal."""
    import time
    from repro_torch.serving import Request
    eng = _graph_engine(dev)
    assert eng.warmup() == 4
    for i, p in enumerate(_graph_prompts(6)):
        eng.add_request(Request(req_id=i, prompt=p, max_new_tokens=8,
                                arrival_time=float(i)))
    for _ in range(200):
        plan = eng.scheduler.schedule_step()
        assert not plan.empty, f"no {kind} step before the run ended"
        sb = eng._build_step(plan, device_feed=True)
        this = "decode" if not plan.prefill else \
            "mixed" if plan.decode else "prefill"
        if this == kind:
            (le, pe, fe), (lr, pr, fr) = _replay_against_eager(eng, sb)
            assert torch.equal(le, lr)
            for k in pe:
                assert torch.equal(pe[k].view(torch.uint8),
                                   pr[k].view(torch.uint8)), k
            assert torch.equal(fe, fr)
            return
        toks = eng._dispatch_async(sb)
        eng._note_executed(sb)
        eng._postprocess(sb, toks.cpu().numpy(), time.perf_counter())
    raise AssertionError(f"no {kind} step in 200")


@pytest.mark.parametrize("encoder", [True, False], ids=["first", "later"])
def test_whisper_replay_matches_eager_step(dev, encoder):
    """whisper-small-reduced's step runners (7: decode, and a prefill
    runner with the encoder and one without for each of 3 buckets): a
    prefill step that carries a first chunk (encoder on) and one that does
    not, each replayed against the eager body from the same state: logits,
    pool bytes, cross K/V leaves and the lane feed bit-equal."""
    import time
    from repro_torch.serving import Request
    eng = _graph_engine(dev, arch="whisper-small-reduced")
    assert eng.warmup() == 7
    for i, p in enumerate(_graph_prompts(6)):
        eng.add_request(Request(req_id=i, prompt=p, max_new_tokens=8,
                                arrival_time=float(i)))
    for _ in range(200):
        plan = eng.scheduler.schedule_step()
        assert not plan.empty, "the run ended before the step"
        sb = eng._build_step(plan, device_feed=True)
        if plan.prefill and ("cross_mask" in sb.batch) == encoder:
            (le, pe, fe), (lr, pr, fr) = _replay_against_eager(eng, sb)
            assert torch.equal(le, lr)
            for k in pe:
                assert torch.equal(pe[k].view(torch.uint8),
                                   pr[k].view(torch.uint8)), k
            assert torch.equal(fe, fr)
            return
        toks = eng._dispatch_async(sb)
        eng._note_executed(sb)
        eng._postprocess(sb, toks.cpu().numpy(), time.perf_counter())
    raise AssertionError("no such step in 200")


def test_async_engine_counts_launches_through_replays(dev):
    """Every step replays a graph, and each replay adds the launches its
    capture counted: K1 once per layer a step, K3 once per layer a
    prefill or mixed step, K4 once per layer a decode step; the greedy
    tokens equal the sync engine's."""
    from repro_torch.serving import AsyncEngine
    prompts = _graph_prompts(6, seed=1)
    want = _graph_engine(dev).generate(prompts, max_new_tokens=8)
    eng = _graph_engine(dev)
    fe = AsyncEngine(eng, warmup=True)
    assert fe.warmed_shapes == 4
    for r in eng._runners.values():
        L = eng.cfg.num_layers
        assert r.launches == ({"kv_cache_write": L,
                               "paged_pool_decode_visits": L}
                              if r.kind == "decode" else
                              {"kv_cache_write": L,
                               "flash_chunk_prefill": L})
    cuda.reset_launches()
    hs = [fe.submit(p, max_new_tokens=8) for p in prompts]
    fe.run_until_idle()
    fe.close()
    torch.cuda.synchronize()
    st, L = eng.stats, eng.cfg.num_layers
    steps = st.prefill_calls + st.decode_steps - st.mixed_steps
    assert eng.aot_misses == 0
    assert cuda.LAUNCHES["kv_cache_write"] == L * steps
    assert cuda.LAUNCHES["flash_chunk_prefill"] == L * st.prefill_calls
    assert cuda.LAUNCHES["paged_pool_decode_visits"] == \
        L * (st.decode_steps - st.mixed_steps)
    assert [list(h.req.output) for h in hs] == [list(w) for w in want]


def test_async_engine_samples_at_temperature(dev):
    """Temperature 0.8: the graph ends at the logits, sampling runs after
    the replay on the same stream; tokens inside the vocabulary."""
    from repro_torch.serving import AsyncEngine
    eng = _graph_engine(dev, temperature=0.8)
    fe = AsyncEngine(eng, warmup=True)
    hs = [fe.submit(p, max_new_tokens=6) for p in _graph_prompts(3)]
    fe.run_until_idle()
    fe.close()
    assert eng.aot_misses == 0
    for h in hs:
        assert len(h.req.output) == 6
        assert all(0 <= t < eng.cfg.vocab_size for t in h.req.output)


@pytest.mark.parametrize("opt_kv", [True, False])
def test_latent_pool_write_under_capture(dev, opt_kv):
    """The latent write captured in a graph and replayed equals it run
    eagerly, bytes and scales, apart from the sentinel line."""
    R, dr, P, ps, B, S = 512, 64, 8, 16, 2, 40
    g = torch.Generator(device=dev).manual_seed(3)
    lat = torch.randn((B, S, R + dr), generator=g, device=dev).bfloat16()
    slots = torch.randperm(P * ps - 1, generator=g, device=dev)[:B * S]
    slots = slots.reshape(B, S).to(torch.int32)
    slots[:, ::5] = -1
    dt = torch.float8_e4m3fn if opt_kv else torch.bfloat16

    def pools():
        return (torch.zeros((P, ps, R + dr), dtype=dt, device=dev),
                torch.zeros((P, ps, 2), device=dev) if opt_kv else None)

    eager, esc = pools()
    ops.latent_pool_write(eager, esc, lat, slots, opt_kv=opt_kv, lora_rank=R)
    pool, sc = pools()
    s_lat, s_slots = lat.clone(), slots.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up outside the capture
        ops.latent_pool_write(pool, sc, s_lat, s_slots, opt_kv=opt_kv,
                              lora_rank=R)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ops.latent_pool_write(pool, sc, s_lat, s_slots, opt_kv=opt_kv,
                              lora_rank=R)
    pool.zero_()
    if opt_kv:
        sc.zero_()
    graph.replay()
    torch.cuda.synchronize()
    n = P * ps - 1
    assert torch.equal(pool.view(torch.uint8).reshape(P * ps, -1)[:n],
                       eager.view(torch.uint8).reshape(P * ps, -1)[:n])
    if opt_kv:
        assert torch.equal(sc.reshape(-1, 2)[:n], esc.reshape(-1, 2)[:n])


def test_warmup_outlives_the_graphs_of_dead_engines(dev):
    """A graph destroyed during a capture invalidates it, and an engine's
    graphs die with the engine <-> runner cycle, when the cycle collector
    runs. An engine that becomes garbage in the middle of another
    engine's capture, with the collector set to run at once, must not be
    collected there: the capture succeeds and the engine serves."""
    import gc
    from repro_torch.serving import AsyncEngine
    first = _graph_engine(dev)
    AsyncEngine(first, warmup=True).close()
    holder = [first]
    del first
    eng = _graph_engine(dev)
    forward = eng._forward

    def dropping(kind, batch, lane_mask):
        if holder and torch.cuda.is_current_stream_capturing():
            holder.clear()               # garbage now, inside the capture
            gc.set_threshold(1, 1, 1)
        return forward(kind, batch, lane_mask)
    eng._forward = dropping
    thresholds = gc.get_threshold()
    try:
        fe = AsyncEngine(eng, warmup=True)
    finally:
        gc.set_threshold(*thresholds)
    assert not holder
    h = fe.submit(_graph_prompts(1)[0], max_new_tokens=4)
    fe.run_until_idle()
    fe.close()
    assert fe.warmed_shapes == 4 and len(h.req.output) == 4


def test_failed_capture_raises_and_registers_no_runner(dev, monkeypatch):
    """A step body that syncs the host cannot be captured: ``warmup``
    raises, registers no runner, and a later step is a counted miss, never
    a quiet eager run in a runner's place."""
    eng = _graph_engine(dev)
    forward = eng._forward

    def syncing(kind, batch, lane_mask):
        logits = forward(kind, batch, lane_mask)
        float(logits.float().sum().item())          # a host sync
        return logits
    monkeypatch.setattr(eng, "_forward", syncing)
    with pytest.raises(RuntimeError):
        eng.warmup()
    assert eng._runners == {} and eng.trace_counts == {}
    torch.cuda.synchronize()


# ------------------------------------------------ packed steps (packing) --
# Two waves of requests, the second admitted after the first step: the
# first step packs two prompts into ONE row (R 1); the second puts two
# decode rows beside a row of two new prompts (R 4).
PACK_WAVES = ((10, 15), (100, 120, 90, 30))
PACK_RUNNERS = 1 + 3 + 3 * 3     # decode, 3 prefill buckets, 3 x 3 packed


def _packed_engine(dev, arch="qwen3-4b-reduced"):
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.serving import Engine, EngineConfig
    return Engine(get_config(arch), COOPT.replace(use_kernel=True),
                  EngineConfig(num_lanes=4, max_len=256,
                               prefill_buckets=(32, 64, 128),
                               pack_prefill=True),
                  device=dev)


def _serve_waves(eng, run, max_new_tokens=8):
    """Serve PACK_WAVES one step at a time; ``run(sb)`` runs each built
    async step and returns its tokens, or None to stop."""
    import time
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    n = 0
    for step in range(200):
        for length in (PACK_WAVES[step] if step < len(PACK_WAVES) else ()):
            eng.add_request(Request(
                req_id=n, prompt=rng.integers(0, 512, length, dtype=np.int32),
                max_new_tokens=max_new_tokens, arrival_time=float(n)))
            n += 1
        if not eng.scheduler.has_work:
            return
        plan = eng.scheduler.schedule_step()
        if plan.empty:
            continue
        sb = eng._build_step(plan, device_feed=True)
        toks = run(sb)
        if toks is None:
            return
        eng._note_executed(sb)
        eng._postprocess(sb, np.asarray(toks.cpu()), time.perf_counter())


@pytest.mark.parametrize("rows", [1, 4])
def test_packed_replay_matches_eager_step(dev, rows):
    """A captured packed runner replayed against the eager body from the
    same pool state, at R 1 (two prompts in one row) and R 4 (decode rows
    beside a row of two prompts): logits, pool bytes and the lane feed
    bit-equal, and the pool's length leaf untouched."""
    eng = _packed_engine(dev)
    assert eng.warmup() == PACK_RUNNERS
    seen = []

    def run(sb):
        if sb.kind != "packed" or len(sb.row_lane) != rows:
            return eng._dispatch_async(sb)
        length = eng.cache["length"].clone()
        (le, pe, fe), (lr, pr, fr) = _replay_against_eager(eng, sb)
        assert torch.equal(le, lr)
        for k in pe:
            assert torch.equal(pe[k].view(torch.uint8),
                               pr[k].view(torch.uint8)), k
        assert torch.equal(fe, fr)
        assert torch.equal(eng.cache["length"], length)
        assert int(sb.batch["seg_q"].max()) >= 1       # a shared row
        seen.append(rows)
        return None
    _serve_waves(eng, run)
    assert seen == [rows]


def test_packed_async_engine_counts_launches_through_replays(dev):
    """With packing, every prefill step is a packed runner's replay: each
    packed runner's capture counted K1 and K3 once per layer, a replay
    adds exactly that, and the served run's K1/K3/K4 launches follow its
    steps; no miss, and the tokens equal the sync packed engine's."""
    import numpy as np
    from repro_torch.serving import AsyncEngine
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n, dtype=np.int32)
               for n in (10, 15, 40, 100, 120, 90, 30, 8)]
    want = _packed_engine(dev).generate(prompts, max_new_tokens=8)
    eng = _packed_engine(dev)
    fe = AsyncEngine(eng, warmup=True)
    assert fe.warmed_shapes == PACK_RUNNERS
    L = eng.cfg.num_layers
    for r in eng._runners.values():
        assert r.launches == ({"kv_cache_write": L,
                               "paged_pool_decode_visits": L}
                              if r.kind == "decode" else
                              {"kv_cache_write": L,
                               "flash_chunk_prefill": L})
    packed = next(r for r in eng._runners.values() if r.kind == "packed")
    cuda.reset_launches()
    packed.run()
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == packed.launches
    cuda.reset_launches()
    hs = [fe.submit(p, max_new_tokens=8) for p in prompts]
    fe.run_until_idle()
    fe.close()
    torch.cuda.synchronize()
    st = eng.stats
    steps = st.prefill_calls + st.decode_steps - st.mixed_steps
    assert eng.aot_misses == 0
    assert st.packed_steps == st.prefill_calls > 0
    assert st.packed_rows_saved > 0
    assert cuda.LAUNCHES["kv_cache_write"] == L * steps
    assert cuda.LAUNCHES["flash_chunk_prefill"] == L * st.packed_steps
    assert cuda.LAUNCHES["paged_pool_decode_visits"] == \
        L * (st.decode_steps - st.mixed_steps)
    assert [list(h.req.output) for h in hs] == [list(w) for w in want]


def _engine_packed_batches(arch):
    """The packed steps' batches of a CPU engine serving PACK_WAVES
    (emissions faked, no model run), with its pool's page count."""
    import numpy as np
    eng = _packed_engine("cpu", arch)
    out = []

    def run(sb):
        if sb.kind == "packed":
            out.append(sb.batch)
        shape = ((len(sb.row_lane), eng.ecfg.pack_slots)
                 if sb.kind == "packed" else eng.ecfg.num_lanes)
        return torch.ones(shape, dtype=torch.int32)
    _serve_waves(eng, run)
    assert len(out) >= 2 and {b["page_table"].shape[0] for b in out} >= {1, 4}
    pages = eng.cache["kv"].shape[1 if eng.cfg.family == "mla" else 2]
    return [{k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
            for b in out], pages, eng.coopt.page_size


@pytest.mark.parametrize("Hq,Hkv,opt_kv", [(40, 8, True), (40, 8, False),
                                           (40, 40, True), (56, 8, True),
                                           (64, 8, True)],
                         ids=["qwen2.5-14b-fp8", "qwen2.5-14b-bf16",
                              "llama13b-fp8", "yi-34b-fp8",
                              "deepseek-67b-fp8"])
def test_chunk_kernel_on_engine_packed_batches(dev, Hq, Hkv, opt_kv):
    """K3 on the planes of engine-built packed steps (rows of several
    segments, ``page_base`` restarting per segment, decode rows, pad rows
    of segment -1) at qwen2.5-14b's (G 5), llama13b-gptq's (G 1), yi-34b's
    (G 7) and deepseek-67b's (G 8) heads:
    within one bf16 ulp of its plain version; pad rows exactly 0."""
    D = 128
    batches, P, ps = _engine_packed_batches("qwen3-4b-reduced")
    kv, sc = _pool(dev, P, ps, Hkv, D, opt_kv)
    ks, vs = (sc[0], sc[1]) if opt_kv else (None, None)
    for b in batches:
        b = {k: v.to(dev) for k, v in b.items()}
        R, S = b["positions"].shape
        q = torch.randn((R, S, Hq, D), device=dev).bfloat16()
        planes = dict(seg_q=b["seg_q"], page_seg=b["page_seg"],
                      page_base=b["page_base"])
        cuda.reset_launches()
        got = ops.paged_chunk_prefill(q, b["positions"], kv, sc,
                                      b["page_table"], opt_kv=opt_kv,
                                      opt_gqa=True, sink_pages=1, **planes)
        plain = fc.flash_chunk_prefill_ref(
            q, b["positions"], kv[0], kv[1], ks, vs, b["page_table"],
            opt_kv=opt_kv, opt_gqa=True, sink_pages=1, **planes)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["flash_chunk_prefill"] == 1
        _assert_close(got, plain)
        assert torch.all(got[b["seg_q"] < 0] == 0)


@pytest.mark.parametrize("opt_kv", [True, False])
def test_latent_chunk_kernel_on_engine_packed_batches(dev, opt_kv):
    """K6 on the planes of engine-built packed steps of the MLA family at
    deepseek-v2-lite's widths (H 16, R 512, dr 64): within LAT_RTOL /
    LAT_ATOL of its plain version; pad rows exactly 0."""
    from repro_torch.kernels import latent_chunk_prefill as lc
    R, dr, H = 512, 64, 16
    batches, P, ps = _engine_packed_batches("deepseek-v2-lite-16b-reduced")
    lat, sc = _latent_pool(dev, P, ps, R, dr, opt_kv)
    for b in batches:
        b = {k: v.to(dev) for k, v in b.items()}
        rows, S = b["positions"].shape
        ql, qr = _latent_q(dev, (rows, S, H, R), dr)
        kw = dict(sm_scale=0.07, opt_kv=opt_kv, sink_pages=1,
                  seg_q=b["seg_q"], page_seg=b["page_seg"],
                  page_base=b["page_base"])
        cuda.reset_launches()
        got = ops.latent_chunk_prefill(ql, qr, b["positions"], lat, sc,
                                       b["page_table"], **kw)
        plain = lc.latent_chunk_prefill_ref(ql, qr, b["positions"], lat, sc,
                                            b["page_table"], **kw)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["latent_chunk_prefill"] == 1
        torch.testing.assert_close(got, plain, rtol=LAT_RTOL, atol=LAT_ATOL)
        assert torch.all(got[b["seg_q"] < 0] == 0)


# ------------------------------------------------- return_state, shards ----
# chip_smoke.py's state rule: m within 2**-16 (1 + |m|), l within 2**-12 |l|;
# rows that read no page exactly (-1e30, 0)
STATE_M_TOL, STATE_L_RTOL = 2 ** -16, 2 ** -12


def _assert_state(got, plain, rtol, atol):
    torch.testing.assert_close(got[0].float(), plain[0].float(), rtol=rtol,
                               atol=atol)
    _, m, l = got
    _, mp, lp = plain
    empty = mp == -1e30
    assert torch.equal(m[empty], mp[empty]) and torch.equal(l[empty],
                                                            lp[empty])
    assert bool(((m - mp).abs() <= STATE_M_TOL * (1 + mp.abs()))[~empty]
                .all())
    assert bool(((l - lp).abs() <= STATE_L_RTOL * lp.abs())[~empty].all())


@pytest.mark.parametrize("D,Hq,Hkv", [(128, 32, 8), (256, 16, 1)])
@pytest.mark.parametrize("n", [2, 4])
def test_gqa_kernels_return_state_on_shards(dev, D, Hq, Hkv, n):
    """K2, K4 and K3 with ``return_state`` on each shard's page range and
    local table against their plain versions; K4's (o, m, l) equal K2's
    bit for bit; lane 0's pages lie on the first shard only."""
    from repro_torch.core.opt_kv import global_to_local_pages
    B, ps, NP, P = 4, 16, 6, 28
    kv, sc = _pool(dev, P, ps, Hkv, D, True)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(
        B, NP)
    table[1:, :2] = 24 + torch.arange(2, device=dev, dtype=torch.int32)
    cl = torch.tensor([96, 90, 70, 81], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, Hq, D), generator=g, device=dev).bfloat16()
    qc = torch.randn((B, 8, Hq, D), generator=g, device=dev).bfloat16()
    pos = (cl[:, None] - 8 + torch.arange(8, device=dev)).to(torch.int32)
    phys, log = decode_page_select(cl, table, ps)
    kw = dict(opt_kv=True, opt_gqa=True, return_state=True)
    per = P // n
    for first in range(0, P, per):
        pool = [x[first:first + per] for x in (kv[0], kv[1], sc[0], sc[1])]
        lp = global_to_local_pages(phys, first, per)
        lt = global_to_local_pages(table, first, per)
        vp, vm, vl = visits.plan_visits(lp, log)
        k2 = pd.paged_pool_decode(q, *pool, cl, lp, log, **kw)
        k4 = pd.paged_pool_decode_visits(q, *pool, cl, vp, vm, vl, **kw)
        k3 = fc.flash_chunk_prefill(qc, pos, *pool, lt, **kw)
        _assert_state(k2, pd.paged_pool_decode_ref(q, *pool, cl, lp, log,
                                                   **kw), RTOL, ATOL)
        _assert_state(k3, fc.flash_chunk_prefill_ref(qc, pos, *pool, lt,
                                                     **kw), RTOL, ATOL)
        assert all(torch.equal(a, b) for a, b in zip(k4, k2))


@pytest.mark.parametrize("n", [2, 4])
def test_latent_kernels_return_state_on_shards(dev, n):
    """K5, K7 and K6 with ``return_state`` on each shard against their plain
    versions (the f32 tolerance); K7's (o, m, l) equal K5's bit for bit."""
    from repro_torch.cache.quant import quantize_latent
    from repro_torch.core.opt_kv import global_to_local_pages
    from repro_torch.kernels import latent_chunk_prefill as lc
    from repro_torch.kernels import paged_latent_decode as ld
    B, H, R, dr, ps, NP, P = 4, 16, 512, 64, 16, 6, 28
    g = torch.Generator(device=dev).manual_seed(4)
    lat, sc = quantize_latent(torch.randn((P, ps, R + dr), generator=g,
                                          device=dev), R)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(
        B, NP)
    cl = torch.tensor([96, 90, 70, 81], dtype=torch.int32, device=dev)
    ql = torch.randn((B, H, R), generator=g, device=dev)
    qr = torch.randn((B, H, dr), generator=g, device=dev)
    qlc = torch.randn((B, 8, H, R), generator=g, device=dev)
    qrc = torch.randn((B, 8, H, dr), generator=g, device=dev)
    pos = (cl[:, None] - 8 + torch.arange(8, device=dev)).to(torch.int32)
    phys, log = decode_page_select(cl, table, ps)
    kw = dict(sm_scale=0.1, opt_kv=True, return_state=True)
    per = P // n
    for first in range(0, P, per):
        pool = (lat[first:first + per], sc[first:first + per])
        lp = global_to_local_pages(phys, first, per)
        lt = global_to_local_pages(table, first, per)
        vp, vm, vl = visits.plan_visits(lp, log)
        k5 = ld.paged_latent_decode(ql, qr, *pool, cl, lp, log, **kw)
        k7 = ld.paged_latent_decode_visits(ql, qr, *pool, cl, vp, vm, vl,
                                           **kw)
        k6 = lc.latent_chunk_prefill(qlc, qrc, pos, *pool, lt, **kw)
        _assert_state(k5, ld.paged_latent_decode_ref(ql, qr, *pool, cl, lp,
                                                     log, **kw),
                      2 ** -12, 2 ** -16)
        _assert_state(k6, lc.latent_chunk_prefill_ref(qlc, qrc, pos, *pool,
                                                      lt, **kw),
                      2 ** -12, 2 ** -16)
        assert all(torch.equal(a, b) for a, b in zip(k7, k5))


# ------------------------------------------------------------- training --
def _train_case():
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import TrainPipeline
    from repro_torch.models import get_model
    cfg = get_config("qwen3-4b-reduced")
    batch = TrainPipeline(cfg.vocab_size, 2, 64, seed=0).next_batch()
    return cfg, get_model(cfg), {k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in batch.items()}


def test_train_step_card_against_cpu(dev):
    """One ``make_train_step`` on qwen3-4b-reduced from the same params and
    batch on the card and on the CPU: the loss within 1e-2, each leaf's
    gradient within 4% relative L2 (tests/test_torch_training.py's bound
    for this model), the updated params within 2e-2."""
    from repro_torch import tree as tree_util
    from repro_torch.core.coopt import COOPT
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.train import loss_and_grads
    cfg, model, batch = _train_case()
    p_cpu = model.init(0, "cpu")
    p_card = tree_util.tree_map(lambda t: t.to(dev), p_cpu)
    gb = {k: v.to(dev) for k, v in batch.items()}
    m_cpu, g_cpu = loss_and_grads(model, p_cpu, batch, COOPT)
    m_card, g_card = loss_and_grads(model, p_card, gb, COOPT)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) < 1e-2
    for a, b in zip(g_card, g_cpu):
        rel = (a.cpu().float() - b.float()).norm() / b.float().norm()
        assert rel <= 0.04
    step = make_train_step(cfg, COOPT, lr=1e-3)
    p_cpu, _, _ = step(p_cpu, adamw_init(p_cpu), batch)
    p_card, _, _ = step(p_card, adamw_init(p_card), gb)
    for a, b in zip(tree_util.leaves(p_card), tree_util.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=2e-2,
                                   rtol=2e-2)


def test_gradient_through_a_kernel_raises_on_the_card(dev):
    """``use_kernel=True`` under autograd raises on the card (K8's wrapper
    before its launch); under ``torch.no_grad()`` the same forward runs."""
    from repro_torch.core.coopt import COOPT
    from repro_torch.training.train import loss_and_grads
    cuda.build_all()
    _, model, batch = _train_case()
    params = model.init(0, dev)
    gb = {k: v.to(dev) for k, v in batch.items()}
    kern = COOPT.replace(use_kernel=True)
    cuda.reset_launches()
    with pytest.raises(RuntimeError, match="no gradient flows"):
        loss_and_grads(model, params, gb, kern)
    assert cuda.LAUNCHES["flash_prefill"] == 0
    with torch.no_grad():
        logits, _ = model.forward(params, gb, kern)
    assert cuda.LAUNCHES["flash_prefill"] == 2 and \
        torch.isfinite(logits.float()).all()


def test_checkpoint_roundtrip_of_card_tensors(dev, tmp_path):
    """Params and AdamW state on the card through ``save_checkpoint`` and
    ``load_checkpoint``: every leaf back on the card, byte for byte."""
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.training import adamw_init
    _, model, _ = _train_case()
    params = model.init(0, dev)
    tree = {"params": params, "opt": adamw_init(params),
            "fp8": torch.randn(64, device=dev).to(torch.float8_e4m3fn)}
    save_checkpoint(str(tmp_path), tree, step=5)
    out = load_checkpoint(str(tmp_path), tree)
    for a, b in zip(tree_util.leaves(tree), tree_util.leaves(out)):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


# ------------------------------------------------- launch: make_step, inspect
@pytest.mark.parametrize("arch", ["qwen3-4b-reduced",
                                  "deepseek-v2-lite-16b-reduced"])
def test_make_step_decode_on_the_card(dev, arch):
    """make_step's long_500k decode step at a reduced size on the card:
    its kernels launch (K1 and K2, or K5 for MLA) and its logits match the
    same step with ``use_kernel=False`` within the port's logit bound."""
    from repro_torch.configs import InputShape
    from repro_torch.core.coopt import COOPT
    from repro_torch.launch.inspect_cell import fresh
    from repro_torch.launch.steps import make_step
    shape = InputShape("long_500k", 16384, 1, "decode")
    step = make_step(arch, shape, COOPT.replace(use_kernel=True), device=dev)
    plain = make_step(arch, shape, COOPT, device=dev)
    args = step.init_args(seed=0)
    cuda.reset_launches()
    with torch.no_grad():
        got, _ = step.fn(*fresh(step, args))
    launched = {k for k, n in cuda.LAUNCHES.items() if n}
    with torch.no_grad():
        want, _ = plain.fn(*fresh(plain, args))
    read = "paged_latent_decode" if "deepseek" in arch else \
        "paged_pool_decode"
    assert read in launched
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 0.125


def test_inspect_cell_reports_kernels_and_terms(dev):
    """``inspect_cell.inspect`` on a reduced cell: the trace's top card
    activities hold the decode kernel, the roofline terms come from the
    dry run, the peak memory is at least the arguments' bytes."""
    from repro_torch.configs import InputShape
    from repro_torch.core.coopt import COOPT
    from repro_torch.launch import dryrun, inspect_cell
    from repro_torch.launch.steps import make_step
    shape = InputShape("long_500k", 16384, 1, "decode")
    coopt = COOPT.replace(use_kernel=True)
    dry = dryrun.run_one("qwen3-4b-reduced", shape, coopt=coopt,
                         verbose=False)
    step = make_step("qwen3-4b-reduced", shape, coopt, device=dev)
    r = inspect_cell.inspect(step, step.init_args(seed=0), dry, top=40)
    names = " ".join(k["name"] for k in r["top"])
    assert "decode_kernel" in names and "kv_write_kernel" in names
    assert r["step_ms"] > 0 and r["busy_ms"] > 0
    assert r["C_s"] == dry["cost"]["flops"] / 989e12
    assert r["M_s"] == dry["cost"]["min_bytes"] / 3.35e12
    assert r["peak_bytes"] >= dry["memory"]["argument_bytes"]
