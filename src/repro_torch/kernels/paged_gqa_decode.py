"""K2 ``paged_pool_decode`` and K4 ``paged_pool_decode_visits`` — the fused
LLM-CoOpt decode attention over the GLOBAL paged-KV pool.

One query token per lane attends the lane's pages through (physical,
logical) page tables: Opt-KV fp8 pages dequantized on read, Opt-GQA query
heads folded onto their kv head (MHA mode re-reads the kv head per query
head), the window + sink mask, and Opt-Pa's online (m, l, acc) softmax
over the lane's table slots in ascending order; a -1 entry is never read.
K4 runs the same math over the deduplicated cross-lane visit list of
``kernels.visits.plan_visits`` and is bit-identical to K2.

The wrappers launch ``csrc/paged_gqa_decode.cu`` on CUDA tensors and run the
plain PyTorch versions beside them (``paged_pool_decode_ref``,
``paged_pool_decode_visits_ref``) on CPU tensors. The plain versions walk
each lane's slots in order; K2's masked probabilities are not hard-zeroed
(exp(-1e30 - m) underflows once a live key has been seen). The kernels
split the slots across blocks (``decode_splits``, the same for both) and
merge the splits' (m, l, acc) in ascending order in the same launch, which
moves their f32 sums by rounding only.

``return_state=True`` (the page-range sharded layer, ``kernels.sharded``)
returns ``(o, m, l)``: beside the output, each row's final online-softmax
max ``m`` (natural units of the scaled scores) and sum ``l``, f32 (B, Hq);
a row that read no page reports exactly (-1e30, 0). Without it the kernels
store nothing more and allocate nothing more. K4's (m, l) equal K2's bit
for bit, as its output does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.cache.quant import FP8_DTYPE
from repro_torch.kernels import cuda

_NEG = -1e30
MAX_PAGE_SIZE = 128              # csrc/paged_attention.cuh PA_MAX_PS
HEAD_DIMS = (64, 128, 256)       # the kernels' instantiations
_SMEM_LIMIT = 227 * 1024
_BLOCKS_PER_SM = 8               # decode_splits' aim: this many blocks an SM


def decode_splits(nsel: int, lane_heads: int, sms: int):
    """(slots per split, splits) of K2 and K4 for ``nsel`` table slots,
    ``lane_heads`` = B * heads (lane, head) pairs and ``sms`` SMs: enough
    splits that K2's B * heads * splits blocks reach _BLOCKS_PER_SM an SM
    (K4 runs heads * splits), never more splits than slots. Split z covers
    the slots [z * slots, min((z + 1) * slots, nsel)); K4's the visits
    [z * slots * B, ...), the same slots of every lane."""
    want = -(-_BLOCKS_PER_SM * sms // max(lane_heads, 1))
    slots = -(-nsel // max(min(want, nsel), 1)) if nsel > 0 else 1
    return slots, max(-(-nsel // slots), 1)


def _smem_bytes(ps, D, kv_bytes, lanes, G, nstage=1):
    """Dynamic shared memory of one K2 (lanes 1) or K4 (lanes B) block with
    an ``nstage``-deep page ring: csrc/paged_gqa_decode.cu ``make_layout``
    (the kernel takes up to 4 stages while 3 blocks fit an SM, at least 1,
    and refuses a block that 1 stage does not fit)."""
    def al(x):
        return -(-x // 16) * 16
    rows = lanes * G
    rb = min(16, rows)
    ps16 = -(-ps // 16) * 16
    stage = al(2 * ps * (D * kv_bytes + 16)) + al(2 * ps * 4) + 48
    return (nstage * stage + al(rows * (D + 8) * 2) + rows * D * 4
            + 2 * al(rows * 4) + al(lanes * 4) + al(rb * ps * 4)
            + al(ps16 * (D + 8) * 2) + 2 * al(16 * (ps16 + 8) * 2)
            + al(rb * 4))


_SMS: dict = {}
_COUNTERS: dict = {}
_RETIRED: list = []              # outgrown counters, kept allocated


def plan_fits(lanes, Hq, Hkv, D, ps, opt_kv, opt_gqa) -> bool:
    """Whether one block of K2 (``lanes`` 1) or K4 (``lanes`` B: every
    lane's rows of a head) fits one block's shared memory with a one-page
    ring. Where K4's does not, K2 (the same bits) serves the decode."""
    G = Hq // Hkv if opt_gqa else 1
    return _smem_bytes(ps, D, 1 if opt_kv else 2, lanes, G) <= _SMEM_LIMIT


def _split_buffers(name, q, Hkv, nsel, lanes, ps, opt_kv, opt_gqa):
    """Check the block fits (``plan_fits``), then (slots, f32 scratch for
    the splits' partials or None, the device's int32 arrival counters: one
    a (lane, head) for K2, one a head for K4). The counters start at 0 and
    the kernel's merging block resets each one, so they are kept per device
    across calls (and never freed: a CUDA graph captured over them keeps
    their address); calls that could run at once on two streams would
    share them, so the decode runs on one stream, as the engine's does (its
    graphs replay on one stream too)."""
    B, Hq, D = q.shape
    heads, G = (Hkv, Hq // Hkv) if opt_gqa else (Hq, 1)
    if not plan_fits(lanes, Hq, Hkv, D, ps, opt_kv, opt_gqa):
        raise ValueError(f"{name}: {lanes} lanes x {G} rows do not fit one "
                         "block's shared memory")
    dev = q.device
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    slots, splits = decode_splits(nsel, B * heads, _SMS[dev])
    ctr = _COUNTERS.get(dev)
    if ctr is None or ctr.numel() < B * heads:
        if ctr is not None:
            _RETIRED.append(ctr)     # a captured graph may still use it
        ctr = _COUNTERS[dev] = torch.zeros(B * heads, dtype=torch.int32,
                                           device=dev)
    partial = None
    if splits > 1:
        partial = torch.empty(B * heads * splits * G * (D + 4),
                              dtype=torch.float32, device=dev)
    return slots, partial, ctr


def _geometry(Hq: int, Hkv: int, opt_gqa: bool, device):
    """(heads, G, kv head of each head) — Opt-GQA folds G = Hq/Hkv query
    heads onto each kv head; MHA semantics give every query head its own
    pass over kv head h // (Hq/Hkv)."""
    if opt_gqa:
        return Hkv, Hq // Hkv, torch.arange(Hkv, device=device)
    return Hq, 1, torch.arange(Hq, device=device) // max(Hq // Hkv, 1)


def _lane_pages(pages, scales, page_ids, kv_of, opt_kv):
    """Per-lane page tiles (B, heads, ps, D) f32, dequantized (Eq. 6)."""
    x = pages[page_ids][:, :, kv_of].float()             # (B, ps, heads, D)
    if opt_kv:
        x = x * scales[page_ids][:, :, kv_of][..., None]
    return x.permute(0, 2, 1, 3).contiguous()


def _decode_update(qf, k, v, pos, cache_len, member, state, *, window,
                   sink_pages, ps, sm_scale):
    """One page per lane of the online softmax for rows qf (B, heads, G, D);
    k/v (B, heads, ps, D); pos (B, ps) key positions; only rows of lanes in
    ``member`` (B,) change."""
    m, l, acc = state
    B, heads, G, _ = qf.shape
    cl = cache_len.long()[:, None]
    mask = pos < cl
    if window:
        mask &= (pos >= (cl - window).clamp_min(0)) | (pos < sink_pages * ps)
    mask = mask[:, None, None, :].expand(B, heads, G, ps)
    s = (qf[..., None, :] * k[:, :, None]).sum(-1) * sm_scale
    s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + \
        (p[..., None] * v[:, :, None]).sum(-2)
    sel = member[:, None, None]
    return (torch.where(sel, m_new, m), torch.where(sel, l_new, l),
            torch.where(sel[..., None], acc_new, acc))


def _init_state(B, heads, G, D, device):
    return (torch.full((B, heads, G), _NEG, device=device),
            torch.zeros((B, heads, G), device=device),
            torch.zeros((B, heads, G, D), device=device))


def _finish(state, q, return_state=False):
    m, l, acc = state
    B, Hq, D = q.shape
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype).reshape(B, Hq, D)
    if not return_state:
        return out
    return out, m.reshape(B, Hq), l.reshape(B, Hq)


def paged_pool_decode_ref(q, k_pages, v_pages, k_scale, v_scale, cache_len,
                          phys_table, log_table, *, opt_kv: bool,
                          opt_gqa: bool, window: int = 0,
                          sink_pages: int = 0, return_state: bool = False):
    """Plain version of K2: every lane walks its table slots in ascending
    order; a slot whose physical page is -1 leaves the lane untouched."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    heads, G, kv_of = _geometry(Hq, Hkv, opt_gqa, q.device)
    qf = q.float().reshape(B, heads, G, D)
    state = _init_state(B, heads, G, D, q.device)
    j = torch.arange(ps, device=q.device)
    for s in range(phys_table.shape[1]):
        page = phys_table[:, s].long()
        ids = page.clamp_min(0)
        k = _lane_pages(k_pages, k_scale, ids, kv_of, opt_kv)
        v = _lane_pages(v_pages, v_scale, ids, kv_of, opt_kv)
        pos = log_table[:, s].long().clamp_min(0)[:, None] * ps + j
        state = _decode_update(qf, k, v, pos, cache_len, page >= 0, state,
                               window=window, sink_pages=sink_pages, ps=ps,
                               sm_scale=1.0 / math.sqrt(D))
    return _finish(state, q, return_state)


def paged_pool_decode_visits_ref(q, k_pages, v_pages, k_scale, v_scale,
                                 cache_len, visit_page, visit_lanes,
                                 visit_log, *, opt_kv: bool, opt_gqa: bool,
                                 window: int = 0, sink_pages: int = 0,
                                 return_state: bool = False):
    """Plain version of K4: walk the visit list; each visit's page is read
    once and updates the rows of its member lanes (bit b of the mask),
    with the same per-row arithmetic as ``paged_pool_decode_ref``."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    heads, G, kv_of = _geometry(Hq, Hkv, opt_gqa, q.device)
    qf = q.float().reshape(B, heads, G, D)
    state = _init_state(B, heads, G, D, q.device)
    j = torch.arange(ps, device=q.device)
    lane = torch.arange(B, device=q.device)
    plan = zip(visit_page.tolist(), visit_lanes.tolist(), visit_log.tolist())
    for page, lanes, lpage in plan:
        if page < 0:
            continue
        ids = torch.full((B,), page, dtype=torch.long, device=q.device)
        k = _lane_pages(k_pages, k_scale, ids, kv_of, opt_kv)
        v = _lane_pages(v_pages, v_scale, ids, kv_of, opt_kv)
        pos = (lpage * ps + j)[None].expand(B, ps)
        member = ((torch.full_like(lane, lanes) >> lane) & 1).bool()
        state = _decode_update(qf, k, v, pos, cache_len, member, state,
                               window=window, sink_pages=sink_pages, ps=ps,
                               sm_scale=1.0 / math.sqrt(D))
    return _finish(state, q, return_state)


def _state(q, return_state):
    """The (m, l) outputs of a launch that returns its state, else (None,
    None): f32 (B, Hq) each."""
    if not return_state:
        return None, None
    m = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return m, torch.empty_like(m)


def _check(name, q, k_pages, v_pages, k_scale, v_scale, cache_len, tables,
           opt_kv, opt_gqa):
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    dev = q.device
    operands = (k_pages, v_pages, k_scale, v_scale, cache_len) + tables
    for t in operands:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: q must be bf16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if ps > MAX_PAGE_SIZE:
        raise ValueError(f"{name}: page size {ps} > {MAX_PAGE_SIZE}")
    if Hq % Hkv:
        raise ValueError(f"{name}: {Hq} query heads over {Hkv} kv heads")
    want = FP8_DTYPE if opt_kv else torch.bfloat16
    for p in (k_pages, v_pages):
        if p.dtype != want or tuple(p.shape) != (P, ps, Hkv, D):
            raise ValueError(f"{name}: pages must be {want} (P, ps, Hkv, D)")
    if opt_kv:
        for s in (k_scale, v_scale):
            if s is None or s.dtype != torch.float32 or \
                    tuple(s.shape) != (P, ps, Hkv):
                raise ValueError(f"{name}: opt_kv needs f32 scales "
                                 "(P, ps, Hkv)")
    if cache_len.dtype != torch.int32 or tuple(cache_len.shape) != (B,):
        raise ValueError(f"{name}: cache_len must be int32 (B,)")
    for t in tables:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: page tables must be int32")
    for t in (q,) + operands:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def paged_pool_decode(q, k_pages, v_pages, k_scale, v_scale, cache_len,
                      phys_table, log_table, *, opt_kv: bool, opt_gqa: bool,
                      window: int = 0, sink_pages: int = 0,
                      return_state: bool = False):
    """q: (B, Hq, D) bf16; k/v_pages: (P_total, ps, Hkv, D) GLOBAL pool (fp8
    if ``opt_kv``); k/v_scale: (P_total, ps, Hkv) f32 or None; cache_len:
    (B,) int32; phys/log_table: (B, NSel) int32, -1 = never read. Returns
    (B, Hq, D) bf16, with ``return_state`` ``(o, m, l)`` (module
    docstring). On the card the G rows of a (lane, head) and a one-page
    ring must fit one block's shared memory (``plan_fits``)."""
    if q.device.type == "cpu":
        return paged_pool_decode_ref(
            q, k_pages, v_pages, k_scale, v_scale, cache_len, phys_table,
            log_table, opt_kv=opt_kv, opt_gqa=opt_gqa, window=window,
            sink_pages=sink_pages, return_state=return_state)
    if not q.is_cuda:
        raise ValueError(f"paged_pool_decode: unsupported device {q.device}")
    _check("paged_pool_decode", q, k_pages, v_pages, k_scale, v_scale,
           cache_len, (phys_table, log_table), opt_kv, opt_gqa)
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    NSel = phys_table.shape[1]
    if tuple(log_table.shape) != (B, NSel) or phys_table.shape[0] != B:
        raise ValueError("paged_pool_decode: tables must be (B, NSel)")
    slots, partial, ctr = _split_buffers(
        "paged_pool_decode", q, Hkv, NSel, 1, ps, opt_kv, opt_gqa)
    out = torch.empty_like(q)
    m, l = _state(q, return_state)
    fn = cuda.library("paged_gqa_decode").paged_pool_decode
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             cuda.ptr(k_scale if opt_kv else None),
             cuda.ptr(v_scale if opt_kv else None), cache_len.data_ptr(),
             phys_table.data_ptr(), log_table.data_ptr(), out.data_ptr(),
             cuda.ptr(m), cuda.ptr(l), cuda.ptr(partial), ctr.data_ptr(), B,
             Hq, Hkv, D, ps, NSel, int(opt_kv), int(opt_gqa), window,
             sink_pages, slots, 1.0 / math.sqrt(D),
             cuda.stream_ptr(q.device))
    cuda.check(err, "paged_pool_decode")
    cuda.count(cuda.state_name("paged_pool_decode", return_state))
    return (out, m, l) if return_state else out


def paged_pool_decode_visits(q, k_pages, v_pages, k_scale, v_scale,
                             cache_len, visit_page, visit_lanes, visit_log,
                             *, opt_kv: bool, opt_gqa: bool, window: int = 0,
                             sink_pages: int = 0, return_state: bool = False):
    """Visit-list twin of ``paged_pool_decode``: visit_page/visit_lanes/
    visit_log are the (B * NSel,) int32 slot-major plan vectors of
    ``plan_visits``. Requires B <= visits.MAX_VISIT_LANES (int32 lane
    bitmask) and every lane's q, acc, m and l of a head in one block's
    shared memory (``plan_fits``)."""
    if q.device.type == "cpu":
        return paged_pool_decode_visits_ref(
            q, k_pages, v_pages, k_scale, v_scale, cache_len, visit_page,
            visit_lanes, visit_log, opt_kv=opt_kv, opt_gqa=opt_gqa,
            window=window, sink_pages=sink_pages, return_state=return_state)
    if not q.is_cuda:
        raise ValueError("paged_pool_decode_visits: unsupported device "
                         f"{q.device}")
    _check("paged_pool_decode_visits", q, k_pages, v_pages, k_scale, v_scale,
           cache_len, (visit_page, visit_lanes, visit_log), opt_kv, opt_gqa)
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    NV = visit_page.shape[0]
    if not 1 <= B <= 32:
        raise ValueError(f"paged_pool_decode_visits: {B} lanes not in [1, 32]")
    if visit_lanes.shape != (NV,) or visit_log.shape != (NV,) or NV % B:
        raise ValueError("paged_pool_decode_visits: plan vectors must be "
                         "(B * NSel,)")
    slots, partial, ctr = _split_buffers(
        "paged_pool_decode_visits", q, Hkv, NV // B, B, ps, opt_kv, opt_gqa)
    out = torch.empty_like(q)
    m, l = _state(q, return_state)
    fn = cuda.library("paged_gqa_decode").paged_pool_decode_visits
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             cuda.ptr(k_scale if opt_kv else None),
             cuda.ptr(v_scale if opt_kv else None), cache_len.data_ptr(),
             visit_page.data_ptr(), visit_lanes.data_ptr(),
             visit_log.data_ptr(), out.data_ptr(), cuda.ptr(m), cuda.ptr(l),
             cuda.ptr(partial), ctr.data_ptr(), B, Hq, Hkv, D, ps, NV // B,
             int(opt_kv), int(opt_gqa), window, sink_pages, slots,
             1.0 / math.sqrt(D), cuda.stream_ptr(q.device))
    cuda.check(err, "paged_pool_decode_visits")
    cuda.count(cuda.state_name("paged_pool_decode_visits", return_state))
    return (out, m, l) if return_state else out


KERNEL_INFO = ("registers", "local_bytes", "static_smem_bytes", "threads")


def kernel_info(d: int, opt_kv: bool, visits: bool, device=None) -> dict:
    """The K2 (``visits`` False) or K4 kernel for (head_dim ``d``,
    ``opt_kv``) as the loaded library reports it: registers and local
    bytes (spills and stack) a thread, static shared bytes, threads a
    block (the dynamic bytes are ``_smem_bytes``)."""
    return cuda.info("paged_gqa_decode", "paged_gqa_decode_info", KERNEL_INFO,
                     d, int(opt_kv), int(visits), device=device)
