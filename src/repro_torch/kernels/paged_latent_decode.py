"""K5 ``paged_latent_decode`` and K7 ``paged_latent_decode_visits`` — the
MLA absorbed decode attention over the GLOBAL paged latent pool.

One query token per lane, its H heads already absorbed into latent space
(``q_lat = q_nope @ W_uk``, f32) beside their rotary part ``q_rope``,
attends the lane's latent pages ``(P, ps, R+dr)`` = ``[c_kv | k_rope]``
through (physical, logical) page tables: the two FP8 scales of each token
(column 0 for c_kv, column 1 for k_rope) dequantize on read, the score is
``(<q_lat, c> + <q_rope, k_rope>) * sm_scale``, the window + sink mask
applies to logical positions, and an online (m, l, acc) softmax runs over
the lane's table slots in ascending order with the accumulator in latent
space. A -1 entry is never read. K7 runs the same math over the
deduplicated cross-lane visit list of ``kernels.visits.plan_visits`` and
equals K5 bit for bit. Both return o_lat (B, H, R) f32; the ``w_uv``
expansion stays with the caller.

The wrappers launch ``csrc/paged_latent_decode.cu`` on CUDA tensors and run
the plain PyTorch versions beside them (``paged_latent_decode_ref``,
``paged_latent_decode_visits_ref``) on CPU tensors. The plain versions
follow the kernels' page order and masks; masked probabilities are not
hard-zeroed (exp(-1e30 - m) underflows once a live key has been seen), as
in the Pallas kernels. The kernels hard-zero them, which differs only for
a lane that sees no live key at all (the kernels write 0). They split the
slots across blocks (``latent_splits``, the same for both), run a lane's
splits as one thread-block cluster and merge their (m, l, acc) in
ascending order through the cluster's shared memory in the same launch,
which moves their f32 sums by rounding only. K7 takes every 1 < B <= 32
that the Pallas K7 serves: its blocks hold a fixed number of lanes,
whatever B. Both take at most MAX_HEADS heads: a lane's heads are
ceil(H / 16) 16-row MMA groups of one block, which read each staged page
tile once (up to 16 heads the kernels are those of one group).

``return_state=True`` (the page-range sharded layer, ``kernels.sharded``)
returns ``(o_lat, m, l)``: each row's final online-softmax max (natural
units of the scaled scores) and sum, f32 (B, H); a lane that read no page
reports exactly (-1e30, 0). K7's (m, l) equal K5's bit for bit. (Where a
lane reads pages but none of their keys is live the kernels, hard-zeroing,
report l = 0, the plain versions l = the masked keys' count; such a lane's
output is undefined in both packages, and a merge weighs its m = -1e30 by 0
beside any shard that saw a live key.)
"""
from __future__ import annotations

import torch

from repro_torch.cache.quant import FP8_DTYPE
from repro_torch.kernels import cuda

_NEG = -1e30
MAX_PAGE_SIZE = 128              # csrc/paged_attention.cuh PA_MAX_PS
# (kv_lora_rank, qk_rope_head_dim) pairs the kernels are built for:
# deepseek-v2-lite and its reduced form
LATENT_WIDTHS = ((512, 64), (64, 32))
# splits a lane at most: a lane's splits are one thread-block cluster, 8
# blocks at most (the portable cluster size; csrc kMaxSplits)
_MAX_SPLITS = 8
# heads a lane at most: two 16-row MMA groups of one block hold a lane's
# heads (csrc HG)
MAX_HEADS = 32

_SMS: dict = {}


def _latent_tiles(lat_pages, scale_pages, page_ids, R, opt_kv):
    """Per-lane latent tiles, dequantized as the kernels do (f32(x) *
    scale): c (B, ps, R) and k_rope (B, ps, dr), f32."""
    x = lat_pages[page_ids].float()                       # (B, ps, W)
    c, r = x[..., :R], x[..., R:]
    if opt_kv:
        sc = scale_pages[page_ids]                        # (B, ps, 2)
        c = c * sc[..., 0:1]
        r = r * sc[..., 1:2]
    return c, r


def _latent_update(ql, qr, c, r, pos, cache_len, member, state, *, window,
                   sink_pages, ps, sm_scale):
    """One page per lane of the online softmax for rows ql (B,H,R), qr
    (B,H,dr); c/r (B, ps, R|dr); pos (B, ps) key positions; only lanes in
    ``member`` (B,) change."""
    m, l, acc = state
    cl = cache_len.long()[:, None]
    mask = pos < cl
    if window:
        mask &= (pos >= (cl - window).clamp_min(0)) | (pos < sink_pages * ps)
    s = (torch.einsum("bhr,bjr->bhj", ql, c)
         + torch.einsum("bhe,bje->bhj", qr, r)) * sm_scale
    s = torch.where(mask[:, None, :], s, _NEG)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhj,bjr->bhr", p, c)
    sel = member[:, None]
    return (torch.where(sel, m_new, m), torch.where(sel, l_new, l),
            torch.where(sel[..., None], acc_new, acc))


def _init_state(B, H, R, device):
    return (torch.full((B, H), _NEG, device=device),
            torch.zeros((B, H), device=device),
            torch.zeros((B, H, R), device=device))


def _finish(state, return_state=False):
    m, l, acc = state
    out = acc / l.clamp_min(1e-30)[..., None]
    return (out, m, l) if return_state else out


def paged_latent_decode_ref(q_lat, q_rope, lat_pages, scale_pages, cache_len,
                            phys_table, log_table, *, sm_scale: float,
                            opt_kv: bool, window: int = 0,
                            sink_pages: int = 0, return_state: bool = False):
    """Plain version of K5: every lane walks its table slots in ascending
    order; a slot whose physical page is -1 leaves the lane untouched."""
    B, H, R = q_lat.shape
    ps = lat_pages.shape[1]
    dev = q_lat.device
    ql, qr = q_lat.float(), q_rope.float()
    state = _init_state(B, H, R, dev)
    j = torch.arange(ps, device=dev)
    for s in range(phys_table.shape[1]):
        page = phys_table[:, s].long()
        c, r = _latent_tiles(lat_pages, scale_pages, page.clamp_min(0), R,
                             opt_kv)
        pos = log_table[:, s].long().clamp_min(0)[:, None] * ps + j
        state = _latent_update(ql, qr, c, r, pos, cache_len, page >= 0, state,
                               window=window, sink_pages=sink_pages, ps=ps,
                               sm_scale=sm_scale)
    return _finish(state, return_state)


def paged_latent_decode_visits_ref(q_lat, q_rope, lat_pages, scale_pages,
                                   cache_len, visit_page, visit_lanes,
                                   visit_log, *, sm_scale: float,
                                   opt_kv: bool, window: int = 0,
                                   sink_pages: int = 0,
                                   return_state: bool = False):
    """Plain version of K7: walk the visit list; each visit's page is read
    once and updates the rows of its member lanes (bit b of the mask), with
    the same per-row arithmetic as ``paged_latent_decode_ref``."""
    B, H, R = q_lat.shape
    ps = lat_pages.shape[1]
    dev = q_lat.device
    ql, qr = q_lat.float(), q_rope.float()
    state = _init_state(B, H, R, dev)
    j = torch.arange(ps, device=dev)
    lane = torch.arange(B, device=dev)
    plan = zip(visit_page.tolist(), visit_lanes.tolist(), visit_log.tolist())
    for page, lanes, lpage in plan:
        if page < 0:
            continue
        ids = torch.full((B,), page, dtype=torch.long, device=dev)
        c, r = _latent_tiles(lat_pages, scale_pages, ids, R, opt_kv)
        pos = (lpage * ps + j)[None].expand(B, ps)
        member = ((torch.full_like(lane, lanes) >> lane) & 1).bool()
        state = _latent_update(ql, qr, c, r, pos, cache_len, member, state,
                               window=window, sink_pages=sink_pages, ps=ps,
                               sm_scale=sm_scale)
    return _finish(state, return_state)


def _state(q_lat, return_state):
    """The (m, l) outputs of a launch that returns its state, else (None,
    None): f32 (B, H) each."""
    if not return_state:
        return None, None
    m = torch.empty(q_lat.shape[:2], dtype=torch.float32,
                    device=q_lat.device)
    return m, torch.empty_like(m)


def check_latent_pool(name, lat_pages, scale_pages, R, dr, opt_kv):
    """The latent pool and scales a latent kernel takes (K5, K6, K7)."""
    P, ps, W = lat_pages.shape
    if (R, dr) not in LATENT_WIDTHS or W != R + dr:
        raise ValueError(f"{name}: latent widths R={R} dr={dr} W={W} not in "
                         f"{LATENT_WIDTHS}")
    if ps > MAX_PAGE_SIZE:
        raise ValueError(f"{name}: page size {ps} > {MAX_PAGE_SIZE}")
    want = FP8_DTYPE if opt_kv else torch.bfloat16
    if lat_pages.dtype != want or (ps * W * lat_pages.element_size()) % 16 \
            or lat_pages.data_ptr() % 16:
        raise ValueError(f"{name}: pages must be 16-byte aligned {want} "
                         "(P, ps, R+dr)")
    if opt_kv and (scale_pages is None or scale_pages.dtype != torch.float32
                   or tuple(scale_pages.shape) != (P, ps, 2)):
        raise ValueError(f"{name}: opt_kv needs f32 scales (P, ps, 2)")


def _check(name, q_lat, q_rope, lat_pages, scale_pages, cache_len, tables,
           opt_kv):
    B, H, R = q_lat.shape
    dev = q_lat.device
    operands = (q_rope, lat_pages, scale_pages, cache_len) + tables
    for t in operands:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    if q_lat.dtype != torch.float32 or q_rope.dtype != torch.float32 or \
            q_rope.shape[:2] != (B, H) or q_rope.dim() != 3:
        raise ValueError(f"{name}: q_lat (B,H,R) and q_rope (B,H,dr) must "
                         "be f32")
    if H > MAX_HEADS:
        raise ValueError(f"{name}: {H} heads > {MAX_HEADS}")
    check_latent_pool(name, lat_pages, scale_pages, R, q_rope.shape[2],
                      opt_kv)
    if cache_len.dtype != torch.int32 or tuple(cache_len.shape) != (B,):
        raise ValueError(f"{name}: cache_len must be int32 (B,)")
    for t in tables:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: page tables must be int32")
    for t in (q_lat,) + operands:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def latent_splits(nsel: int, B: int, sms: int):
    """(slots per split, splits) of K5 and K7 for ``nsel`` table slots, B
    lanes and ``sms`` SMs: enough splits that K5's B * splits blocks (165 KB
    of shared memory each at R 512) reach one an SM, at most _MAX_SPLITS,
    never more splits than slots. Split z covers the slots [z * slots,
    min((z + 1) * slots, nsel)); K7's the visits [z * slots * B, ...), the
    same slots of every lane."""
    want = max(min(_MAX_SPLITS, nsel, -(-sms // max(B, 1))), 1)
    slots = -(-nsel // want) if nsel > 0 else 1
    return slots, max(-(-nsel // slots), 1)


def _slots(q_lat, nsel):
    """The slots a split for this call (``latent_splits`` on the device's
    SM count)."""
    dev = q_lat.device
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return latent_splits(nsel, q_lat.shape[0], _SMS[dev])[0]


def paged_latent_decode(q_lat, q_rope, lat_pages, scale_pages, cache_len,
                        phys_table, log_table, *, sm_scale: float,
                        opt_kv: bool, window: int = 0, sink_pages: int = 0,
                        return_state: bool = False):
    """q_lat: (B, H, R) f32 absorbed queries; q_rope: (B, H, dr) f32;
    lat_pages: (P_total, ps, R+dr) GLOBAL latent pool (fp8 if ``opt_kv``,
    else bf16); scale_pages: (P_total, ps, 2) f32 or None; cache_len: (B,)
    int32; phys/log_table: (B, NSel) int32, -1 = never read. ``sm_scale``
    is 1/sqrt(dn + dr), never derived from R. Returns (B, H, R) f32, with
    ``return_state`` ``(o_lat, m, l)`` (module docstring)."""
    if q_lat.device.type == "cpu":
        return paged_latent_decode_ref(
            q_lat, q_rope, lat_pages, scale_pages, cache_len, phys_table,
            log_table, sm_scale=sm_scale, opt_kv=opt_kv, window=window,
            sink_pages=sink_pages, return_state=return_state)
    if not q_lat.is_cuda:
        raise ValueError(f"paged_latent_decode: unsupported device "
                         f"{q_lat.device}")
    _check("paged_latent_decode", q_lat, q_rope, lat_pages, scale_pages,
           cache_len, (phys_table, log_table), opt_kv)
    B, H, R = q_lat.shape
    NSel = phys_table.shape[1]
    if tuple(phys_table.shape) != (B, NSel) or \
            tuple(log_table.shape) != (B, NSel):
        raise ValueError("paged_latent_decode: tables must be (B, NSel)")
    slots = _slots(q_lat, NSel)
    out = torch.empty_like(q_lat)
    m, l = _state(q_lat, return_state)
    fn = cuda.library("paged_latent_decode").paged_latent_decode
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), lat_pages.data_ptr(),
             cuda.ptr(scale_pages if opt_kv else None), cache_len.data_ptr(),
             phys_table.data_ptr(), log_table.data_ptr(), out.data_ptr(),
             cuda.ptr(m), cuda.ptr(l), B, H, R, q_rope.shape[2],
             lat_pages.shape[1], NSel, int(opt_kv), window, sink_pages,
             slots, sm_scale, cuda.stream_ptr(q_lat.device))
    cuda.check(err, "paged_latent_decode")
    cuda.count(cuda.state_name("paged_latent_decode", return_state))
    return (out, m, l) if return_state else out


def paged_latent_decode_visits(q_lat, q_rope, lat_pages, scale_pages,
                               cache_len, visit_page, visit_lanes, visit_log,
                               *, sm_scale: float, opt_kv: bool,
                               window: int = 0, sink_pages: int = 0,
                               return_state: bool = False):
    """Visit-list twin of ``paged_latent_decode``: visit_page/visit_lanes/
    visit_log are the (B * NSel,) int32 slot-major plan vectors of
    ``plan_visits``. Requires B <= visits.MAX_VISIT_LANES (int32 lane
    bitmask)."""
    if q_lat.device.type == "cpu":
        return paged_latent_decode_visits_ref(
            q_lat, q_rope, lat_pages, scale_pages, cache_len, visit_page,
            visit_lanes, visit_log, sm_scale=sm_scale, opt_kv=opt_kv,
            window=window, sink_pages=sink_pages, return_state=return_state)
    if not q_lat.is_cuda:
        raise ValueError("paged_latent_decode_visits: unsupported device "
                         f"{q_lat.device}")
    _check("paged_latent_decode_visits", q_lat, q_rope, lat_pages,
           scale_pages, cache_len, (visit_page, visit_lanes, visit_log),
           opt_kv)
    B, H, R = q_lat.shape
    NV = visit_page.shape[0]
    if not 1 <= B <= 32:
        raise ValueError(f"paged_latent_decode_visits: {B} lanes not in "
                         "[1, 32]")
    if visit_lanes.shape != (NV,) or visit_log.shape != (NV,) or NV % B:
        raise ValueError("paged_latent_decode_visits: plan vectors must be "
                         "(B * NSel,)")
    slots = _slots(q_lat, NV // B)
    out = torch.empty_like(q_lat)
    m, l = _state(q_lat, return_state)
    fn = cuda.library("paged_latent_decode").paged_latent_decode_visits
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), lat_pages.data_ptr(),
             cuda.ptr(scale_pages if opt_kv else None), cache_len.data_ptr(),
             visit_page.data_ptr(), visit_lanes.data_ptr(),
             visit_log.data_ptr(), out.data_ptr(), cuda.ptr(m), cuda.ptr(l),
             B, H, R, q_rope.shape[2], lat_pages.shape[1], NV // B,
             int(opt_kv), window, sink_pages, slots, sm_scale,
             cuda.stream_ptr(q_lat.device))
    cuda.check(err, "paged_latent_decode_visits")
    cuda.count(cuda.state_name("paged_latent_decode_visits", return_state))
    return (out, m, l) if return_state else out


KERNEL_INFO = ("lanes_per_block", "threads", "smem_bytes", "registers",
               "local_bytes", "q_terms", "p_terms", "last_blocks",
               "last_splits")


def kernel_info(R: int, dr: int, opt_kv: bool, visits: bool,
                device=None, heads: int = 16) -> dict:
    """The K5 (``visits`` False) or K7 kernel that runs for (R, dr,
    opt_kv) at ``heads`` heads, as the loaded library reports it: lanes
    and threads a block,
    dynamic shared bytes, registers and local bytes (spills and stack) a
    thread, the bf16 terms of q and of P' = p * sc0, and the blocks and
    splits of that kernel's last launch."""
    return cuda.info("paged_latent_decode", "paged_latent_decode_info",
                     KERNEL_INFO, R, dr, heads, int(opt_kv), int(visits),
                     device=device)
