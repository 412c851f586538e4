#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only kernels

Phases:
  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
  2. each kernel at the main path's shapes (qwen3-4b widths: Hq 32, Hkv 8,
     D 128, pages of 64, 4 lanes with ~1024 cached tokens and a shared
     256-token prefix), held against its plain PyTorch version on the card:
     K1 pool bytes and scales equal (the JAX sentinel line excluded), K4
     bit-identical to K2, K2 and K3 (unpacked and with two packed
     segments) within one bf16 ulp (``ATTN_RTOL``, ``ATTN_ATOL``), while a
     control with one key masked off must fall outside it. Then each one's
     time (CUDA events, cold L2), the plain version's, a library call's
     where one computes the same function, and the least time the card
     could take (``bound_ms``).
  3. ``Engine.generate`` on qwen3-4b at full width and depth (random
     weights from a seed) in coopt mode with the kernels: 8 greedy
     requests, 4 sharing a 256-token prefix; K1, K3 and K4 must launch.
     Then a one-lane engine (4 layers) on which K2 must launch.
  4. qwen3-4b-reduced with the same weights on the card (kernels) and on
     the CPU (plain versions): first-step logits within ``LOGIT_ATOL`` and
     greedy-token agreement.
The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
Details go to ``chiprun_out/chip_smoke.json`` and the nvcc (ptxas) log to
``chiprun_out/build.log``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
# Attention outputs are bf16 roundings of f32 sums that the kernel (FMA
# chains, warp butterflies) and PyTorch take in different orders, so the two
# may round to neighbouring bf16 values: |kernel - plain| <= ATTN_ATOL +
# ATTN_RTOL * |plain| admits one bf16 ulp anywhere in a binade (an ulp is
# 2**-8 to 2**-7 of |x|) and nothing near zero beyond 2**-14. Each check
# also runs a control, the plain version with one key masked off, which
# must exceed the tolerance.
ATTN_RTOL = 2 ** -7
ATTN_ATOL = 2 ** -14
# qwen3-4b-reduced logits, bf16 activations through 2 layers: cuBLAS and
# the CPU's bf16 GEMMs round differently, a few bf16 ulps of |logit| ~ 4.
LOGIT_ATOL = 0.125

OUT = ROOT / "chiprun_out"
DEV = "cuda"                     # the phases' device (a CPU rehearsal sets "cpu")


def log(*a):
    print(*a, flush=True)


class Fail(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise Fail(what)


# ------------------------------------------------------------- timing --
def make_timer(torch):
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=DEV)

    def time_ms(fn, iters=20, warmup=3):
        """Mean device time of ``fn`` over ``iters`` calls, L2 flushed
        before each (the pool layer a step reads is cold in L2). A spin of
        ~0.5 ms keeps the card busy while the host reaches the launch, so
        a short kernel's time holds no wait for its Python wrapper."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters

    return time_ms


def tol_ratio(got, plain):
    """Largest |got - plain| as a share of the attention tolerance (<= 1
    passes) and the largest absolute difference."""
    g, p = got.float(), plain.float()
    diff = (g - p).abs()
    ratio = (diff / (ATTN_ATOL + ATTN_RTOL * p.abs())).max().item()
    return ratio, diff.max().item()


def bound(bytes_moved, flops, rate):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# -------------------------------------------------------------- kernels --
def kernel_phase(torch, rec):
    import torch.nn.functional as F
    from repro_torch.cache.quant import quantize_fp8
    from repro_torch.kernels import cuda, ops, visits
    from repro_torch.kernels import flash_chunk_prefill as fc
    from repro_torch.kernels import kv_cache_write as kw
    from repro_torch.kernels import paged_gqa_decode as pd
    time_ms = make_timer(torch)
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, Hq, Hkv, D, ps, NP = 4, 32, 8, 128, 64, 16
    P = B * NP + 1                          # + the reserved last page
    out = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # pool: lanes 1-3 share lane 0's first 4 pages (a 256-token prefix)
    kq, ks = quantize_fp8(randn(P, ps, Hkv, D))
    vq, vs = quantize_fp8(randn(P, ps, Hkv, D))
    kv = torch.stack([kq, vq]).contiguous()
    sc = torch.stack([ks, vs]).contiguous()
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[1:, :4] = table[0, :4]
    cache_len = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32,
                             device=dev)
    # ---- K1: one prefill step's chunk (S = 512) with padded columns -----
    S = 512
    kn = randn(B, S, Hkv, D).to(torch.bfloat16)
    vn = randn(B, S, Hkv, D).to(torch.bfloat16)
    kn[0, 0, 0, :] = 448.0                  # exact e4m3 edge: scale 1
    kn[0, 0, 0, 1:9] = torch.tensor([1.0625, 1.1875, -1.0625, 432.0, -432.0,
                                     0.0, 3.25, 208.0])   # ties at scale 1
    slots = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    n_valid = [512, 300, 1, 64]
    for b, n in enumerate(n_valid):
        slots[b, :n] = (torch.arange(n, device=dev, dtype=torch.int32)
                        + b * NP * ps)
    pool_a = torch.zeros((2, P, ps, Hkv, D), dtype=torch.float8_e4m3fn,
                         device=dev)
    sc_a = torch.zeros((2, P, ps, Hkv), device=dev)
    pool_b, sc_b = pool_a.clone(), sc_a.clone()
    ops.kv_cache_write(pool_a, sc_a, kn, vn, slots, opt_kv=True)
    flat_b = pool_b.view(2, P * ps, Hkv, D)
    sflat_b = sc_b.view(2, P * ps, Hkv)
    kw.kv_cache_write_ref(kn, vn, slots, flat_b[0], flat_b[1], sflat_b[0],
                          sflat_b[1], opt_kv=True)
    torch.cuda.synchronize()
    n = P * ps - 1
    same = torch.equal(pool_a.view(2, P * ps, Hkv, D)[:, :n].view(torch.uint8),
                       flat_b[:, :n].view(torch.uint8))
    same_sc = torch.equal(sc_a.view(2, P * ps, Hkv)[:, :n], sflat_b[:, :n])
    deq_a = pool_a.view(2, P * ps, Hkv, D)[:, :n].float() * \
        sc_a.view(2, P * ps, Hkv)[:, :n, :, None]
    deq_b = flat_b[:, :n].float() * sflat_b[:, :n, :, None]
    err1 = (deq_a - deq_b).abs().max().item()
    edge = pool_a.view(2, P * ps, Hkv, D)[0, 0, 0, :9].float().tolist()
    log(f"K1 kv_cache_write: pool bytes equal {same}, scales equal {same_sc},"
        f" edge values {edge}")
    check(same and same_sc, "K1 differs from its plain version")
    check(edge == [448.0, 1.0, 1.25, -1.0, 448.0, -448.0, 0.0, 3.25, 208.0],
          f"K1 e4m3 edge/tie values {edge}")
    # the kernel reads every slot but the K/V rows of valid slots only
    # (a slot < 0 returns before its row is read)
    valid = sum(n_valid)
    k1_bytes = 2 * valid * Hkv * D * 2 + B * S * 4 + \
        2 * valid * Hkv * (D + 4)
    k1_ops = 2 * valid * Hkv * D * 4                 # abs, max, div, cvt
    flat_a = pool_a.view(2, P * ps, Hkv, D)
    ok_slots = slots.reshape(-1)[slots.reshape(-1) >= 0].long()
    rows_q = flat_b[0][ok_slots].view(torch.uint8).contiguous()
    t_kernel = time_ms(lambda: ops.kv_cache_write(pool_a, sc_a, kn, vn, slots,
                                                  opt_kv=True))
    t_plain = time_ms(lambda: kw.kv_cache_write_ref(
        kn, vn, slots, flat_b[0], flat_b[1], sflat_b[0], sflat_b[1],
        opt_kv=True))
    t_lib = time_ms(lambda: flat_a[0].view(torch.uint8).index_copy_(
        0, ok_slots, rows_q))
    bms, by = bound(k1_bytes, k1_ops, F32_FLOPS)
    out.append(dict(name="kv_cache_write", route="cuda",
                    source="src/repro_torch/kernels/csrc/kv_cache_write.cu",
                    replaces="src/repro/kernels/kv_cache_write.py:59",
                    max_abs_err=err1, ms=t_kernel, plain_ms=t_plain,
                    bound_ms=bms, bound_by=by, library_ms=t_lib,
                    library="index_copy_ of the pre-quantized K rows "
                            "(scatter only)",
                    shape=f"B={B} S={S} Hkv={Hkv} D={D}, {valid} valid"))

    # ---- K2 / K4: a decode step of 4 lanes --------------------------------
    from repro_torch.core.opt_kv import decode_page_select
    q = randn(B, Hq, D).to(torch.bfloat16)
    phys, logt = decode_page_select(cache_len, table, ps, opt_pa=True)
    vp, vm, vl = visits.plan_visits(phys, logt)
    k2 = pd.paged_pool_decode(q, kv[0], kv[1], sc[0], sc[1], cache_len, phys,
                              logt, opt_kv=True, opt_gqa=True)
    k4 = pd.paged_pool_decode_visits(q, kv[0], kv[1], sc[0], sc[1], cache_len,
                                     vp, vm, vl, opt_kv=True, opt_gqa=True)
    p2 = pd.paged_pool_decode_ref(q, kv[0], kv[1], sc[0], sc[1], cache_len,
                                  phys, logt, opt_kv=True, opt_gqa=True)
    p4 = pd.paged_pool_decode_visits_ref(q, kv[0], kv[1], sc[0], sc[1],
                                         cache_len, vp, vm, vl, opt_kv=True,
                                         opt_gqa=True)
    # control: the plain version with each lane's last key masked off
    c2 = pd.paged_pool_decode_ref(q, kv[0], kv[1], sc[0], sc[1],
                                  cache_len - 1, phys, logt, opt_kv=True,
                                  opt_gqa=True)
    torch.cuda.synchronize()
    r2, err2 = tol_ratio(k2, p2)
    r4, err4 = tol_ratio(k4, p4)
    rc2, errc2 = tol_ratio(k2, c2)
    bitwise = torch.equal(k4, k2)
    n_visits = int((vp >= 0).sum().item())
    log(f"K2 paged_pool_decode: max |kernel - plain| {err2:.3e} = "
        f"{r2:.3f} of the tolerance (rtol {ATTN_RTOL}, atol {ATTN_ATOL}); "
        f"control, one key masked off: {errc2:.3e} = {rc2:.2f}")
    log(f"K4 paged_pool_decode_visits: bit-identical to K2 {bitwise}, "
        f"max |kernel - plain| {err4:.3e} = {r4:.3f} of the tolerance, "
        f"{n_visits} visits for {int((phys >= 0).sum().item())} lane pages")
    check(r2 <= 1, "K2 differs from its plain version")
    check(rc2 > 1, "the tolerance passes a one-key mask error in K2")
    check(bitwise, "K4 is not bit-identical to K2")
    check(r4 <= 1, "K4 differs from its plain version")
    rec["tolerance"] = dict(rtol=ATTN_RTOL, atol=ATTN_ATOL, k2=r2, k4=r4,
                            k2_control=rc2, k2_control_err=errc2)
    # exact-data bound: distinct live pages once, q and out, the tables
    live_pages = torch.unique(phys[phys >= 0]).numel()
    dec_bytes = live_pages * 2 * ps * Hkv * (D + 4) + 2 * B * Hq * D * 2 + \
        2 * B * NP * 4 + B * 4
    dec_flops = int(cache_len.sum().item()) * Hq * D * 4
    # library yardstick: SDPA on pre-gathered, dequantized bf16 K/V
    pt = table.long()
    kd = (kv[0][pt].float() * sc[0][pt][..., None]).to(torch.bfloat16)
    vd = (kv[1][pt].float() * sc[1][pt][..., None]).to(torch.bfloat16)
    kd = kd.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    vd = vd.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    mask = (torch.arange(NP * ps, device=dev)[None] <
            cache_len[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa_decode():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = (sdpa_decode()[:, :, 0].float() - p2.float()).abs().max().item()
    t_lib = time_ms(sdpa_decode)
    bms, by = bound(dec_bytes, dec_flops, BF16_FLOPS)
    for name, fn, plain, err, line in (
            ("paged_pool_decode",
             lambda: pd.paged_pool_decode(q, kv[0], kv[1], sc[0], sc[1],
                                          cache_len, phys, logt, opt_kv=True,
                                          opt_gqa=True),
             lambda: pd.paged_pool_decode_ref(q, kv[0], kv[1], sc[0], sc[1],
                                              cache_len, phys, logt,
                                              opt_kv=True, opt_gqa=True),
             err2, 122),
            ("paged_pool_decode_visits",
             lambda: pd.paged_pool_decode_visits(q, kv[0], kv[1], sc[0],
                                                 sc[1], cache_len, vp, vm,
                                                 vl, opt_kv=True,
                                                 opt_gqa=True),
             lambda: pd.paged_pool_decode_visits_ref(
                 q, kv[0], kv[1], sc[0], sc[1], cache_len, vp, vm, vl,
                 opt_kv=True, opt_gqa=True),
             err4, 288)):
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/"
                               "paged_gqa_decode.cu",
                        replaces=f"src/repro/kernels/paged_gqa_decode.py:{line}",
                        max_abs_err=err, ms=time_ms(fn),
                        plain_ms=time_ms(plain, iters=5, warmup=1),
                        bound_ms=bms, bound_by=by, library_ms=t_lib,
                        library="F.scaled_dot_product_attention on "
                                "pre-gathered dequantized bf16 K/V "
                                f"(max |lib - plain| {lib_err:.3e})",
                        shape=f"B={B} Hq={Hq} Hkv={Hkv} D={D} ps={ps} "
                              f"NSel={NP}, cache_len {cache_len.tolist()}"))

    # ---- K3: a mixed step: lane 0 a 512-token chunk at [512, 1024), -------
    # lanes 1-3 decode lanes (one token, padding clamped to it)
    qc = randn(B, S, Hq, D).to(torch.bfloat16)
    pos = torch.empty((B, S), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(512, 1024, device=dev, dtype=torch.int32)
    for b in range(1, B):
        pos[b] = cache_len[b] - 1
    k3 = ops.paged_chunk_prefill(qc, pos, kv, sc, table, opt_kv=True,
                                 opt_gqa=True)
    p3 = fc.flash_chunk_prefill_ref(qc, pos, kv[0], kv[1], sc[0], sc[1], table,
                                    opt_kv=True, opt_gqa=True)
    # control: each row's newest key masked off (positions one earlier)
    c3 = fc.flash_chunk_prefill_ref(qc, pos - 1, kv[0], kv[1], sc[0], sc[1],
                                    table, opt_kv=True, opt_gqa=True)
    # concat-prefill packing: lane 0's row holds two prompts, rows [0, 256)
    # at [512, 768) on its own pages, rows [256, 512) a second prompt at
    # [0, 256) on lane 3's pages 4-7, whose key positions restart at 0
    seg_q = torch.zeros((B, S), dtype=torch.int32, device=dev)
    seg_q[0, 256:] = 1
    pos_pk = pos.clone()
    pos_pk[0, :256] = torch.arange(512, 768, device=dev, dtype=torch.int32)
    pos_pk[0, 256:] = torch.arange(0, 256, device=dev, dtype=torch.int32)
    table_pk = table.clone()
    table_pk[0, 12:] = table[3, 4:8]
    page_seg = torch.zeros((B, NP), dtype=torch.int32, device=dev)
    page_seg[0, 12:] = 1
    page_base = torch.arange(NP, device=dev, dtype=torch.int32) \
        .repeat(B, 1).contiguous()
    page_base[0, 12:] = torch.arange(4, device=dev, dtype=torch.int32)
    planes = dict(seg_q=seg_q, page_seg=page_seg, page_base=page_base)
    k3p = ops.paged_chunk_prefill(qc, pos_pk, kv, sc, table_pk, opt_kv=True,
                                  opt_gqa=True, **planes)
    p3p = fc.flash_chunk_prefill_ref(qc, pos_pk, kv[0], kv[1], sc[0], sc[1],
                                     table_pk, opt_kv=True, opt_gqa=True,
                                     **planes)
    # control: the planes dropped, so each segment also sees the other's keys
    c3p = fc.flash_chunk_prefill_ref(qc, pos_pk, kv[0], kv[1], sc[0], sc[1],
                                     table_pk, opt_kv=True, opt_gqa=True)
    torch.cuda.synchronize()
    r3, err3 = tol_ratio(k3, p3)
    rc3, errc3 = tol_ratio(k3, c3)
    r3p, err3p = tol_ratio(k3p, p3p)
    rc3p, errc3p = tol_ratio(k3p, c3p)
    log(f"K3 flash_chunk_prefill: max |kernel - plain| {err3:.3e} = "
        f"{r3:.3f} of the tolerance; control, one key masked off: "
        f"{errc3:.3e} = {rc3:.2f}")
    log(f"K3 packed (two segments in lane 0): max |kernel - plain| "
        f"{err3p:.3e} = {r3p:.3f} of the tolerance; control, planes "
        f"dropped: {errc3p:.3e} = {rc3p:.2f}")
    check(r3 <= 1, "K3 differs from its plain version")
    check(r3p <= 1, "packed K3 differs from its plain version")
    check(rc3 > 1, "the tolerance passes a one-key mask error in K3")
    check(rc3p > 1, "the tolerance passes a segment mask error in K3")
    rec["tolerance"].update(k3=r3, k3_packed=r3p, k3_control=rc3,
                            k3_control_err=errc3, k3_packed_control=rc3p,
                            k3_packed_err=err3p)
    err3 = max(err3, err3p)
    qpos = pos.long()
    last_page = qpos.amax(dim=1) // ps                       # (B,)
    used = torch.cat([table[b, :int(last_page[b]) + 1] for b in range(B)])
    pages3 = torch.unique(used).numel()
    keys = (qpos + 1).sum().item()                           # causal keys
    chunk_bytes = pages3 * 2 * ps * Hkv * (D + 4) + 2 * B * S * Hq * D * 2 + \
        B * S * 4 + B * NP * 4
    chunk_flops = keys * Hq * D * 4
    kd3 = (kv[0][pt].float() * sc[0][pt][..., None]).to(torch.bfloat16)
    vd3 = (kv[1][pt].float() * sc[1][pt][..., None]).to(torch.bfloat16)
    kd3 = kd3.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    vd3 = vd3.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    cmask = (torch.arange(NP * ps, device=dev)[None, None] <=
             pos[:, :, None])[:, None]
    qc4 = qc.transpose(1, 2).contiguous()

    def sdpa_chunk():
        return F.scaled_dot_product_attention(qc4, kd3, vd3, attn_mask=cmask,
                                              enable_gqa=True)
    lib_err3 = (sdpa_chunk().transpose(1, 2).float() - p3.float()).abs() \
        .max().item()
    bms, by = bound(chunk_bytes, chunk_flops, BF16_FLOPS)
    out.append(dict(name="flash_chunk_prefill", route="cuda",
                    source="src/repro_torch/kernels/csrc/"
                           "flash_chunk_prefill.cu",
                    replaces="src/repro/kernels/flash_chunk_prefill.py:155",
                    max_abs_err=err3,
                    ms=time_ms(lambda: ops.paged_chunk_prefill(
                        qc, pos, kv, sc, table, opt_kv=True, opt_gqa=True)),
                    plain_ms=time_ms(lambda: fc.flash_chunk_prefill_ref(
                        qc, pos, kv[0], kv[1], sc[0], sc[1], table,
                        opt_kv=True, opt_gqa=True), iters=3, warmup=1),
                    bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa_chunk),
                    library="F.scaled_dot_product_attention on pre-gathered "
                            "dequantized bf16 K/V with a causal position "
                            f"mask (max |lib - plain| {lib_err3:.3e})",
                    shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} ps={ps} "
                          f"NP={NP}"))
    for k in out:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']})")
    rec["kernels"] = out
    rec["ptxas"] = {n: [ln for ln in s.splitlines() if "registers" in ln
                        or "spill" in ln] for n, s in cuda.BUILD_LOG.items()}
    return out


# --------------------------------------------------------------- engine --
def engine_phase(torch, rec, arch="qwen3-4b"):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.kernels import cuda
    from repro_torch.serving import Engine, EngineConfig
    coopt = COOPT.replace(use_kernel=True)
    cfg = get_config(arch)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 256)
    lens = rng.integers(300, 701, 8)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    n - 256)])
               if i < 4 else rng.integers(0, cfg.vocab_size, n)
               for i, n in enumerate(lens)]
    t0 = time.perf_counter()
    eng = Engine(cfg, coopt, EngineConfig(num_lanes=4, max_len=1024, seed=0),
                 device=DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in [eng.params["embed"],
                                       eng.params["lm_head"]]) + \
        sum(t.numel() for seg in eng.params["segments"] for t in seg.values())
    log(f"engine: {cfg.name}, {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
        f"params, set-up {setup_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    finite = []
    run_model = eng._run_model

    def checked(sb):
        logits = run_model(sb)
        finite.append(torch.isfinite(logits).all())
        return logits
    eng._run_model = checked
    cuda.reset_launches()
    t0 = time.perf_counter()
    reqs = eng.generate(prompts, max_new_tokens=32, return_requests=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    st = eng.stats
    done = sum(len(r.output) == 32 and r.finish_reason is not None
               and r.finish_reason.value == "finished" for r in reqs)
    all_finite = bool(torch.stack(finite).all().item())
    steps = st.prefill_calls + st.decode_steps - st.mixed_steps
    res = dict(requests=len(reqs), finished=done, generated=st.generated_tokens,
               wall_s=wall, tokens_per_s=st.generated_tokens / wall,
               ttft_p50_s=st.ttft(50), ttft_p95_s=st.ttft(95),
               tpot_p50_s=st.tpot(50), tpot_p95_s=st.tpot(95),
               prefix_hit_rate=st.prefix_hit_rate(), steps=steps,
               decode_steps=st.decode_steps, prefill_calls=st.prefill_calls,
               shared_page_visits=st.shared_page_visits,
               dup_page_streams_saved=st.dup_page_streams_saved,
               launches=launches, logits_finite=all_finite,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"engine: {done}/{len(reqs)} finished, {st.generated_tokens} tokens "
        f"in {wall:.2f} s = {res['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{res['tpot_p50_s'] * 1e3:.2f} ms, prefix hit rate "
        f"{res['prefix_hit_rate']:.3f}, {steps} steps, launches {launches}")
    check(done == len(reqs), "not every request finished")
    check(all_finite, "non-finite logits")
    for k in ("kv_cache_write", "flash_chunk_prefill",
              "paged_pool_decode_visits"):
        check(launches[k] > 0, f"{k} never launched on the engine path")
    rec["engine"] = res
    del eng
    torch.cuda.empty_cache()

    # one lane: decode steps go through the per-lane kernel K2
    cfg1 = cfg.replace(num_layers=4)
    eng1 = Engine(cfg1, coopt, EngineConfig(num_lanes=1, max_len=1024, seed=1),
                  device=DEV)
    cuda.reset_launches()
    outs = eng1.generate(prompts[:2], max_new_tokens=16)
    torch.cuda.synchronize()
    launches1 = dict(cuda.LAUNCHES)
    log(f"engine (1 lane, 4 layers): {[len(o) for o in outs]} tokens, "
        f"launches {launches1}")
    check(all(len(o) == 16 for o in outs), "one-lane engine did not finish")
    check(launches1["paged_pool_decode"] > 0,
          "paged_pool_decode never launched on the one-lane engine")
    rec["engine_one_lane"] = dict(launches=launches1)
    return launches, launches1


# ------------------------------------------------------- card vs CPU ----
def parity_phase(torch, rec):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig
    cfg = get_config("qwen3-4b-reduced")
    coopt = COOPT.replace(use_kernel=True)
    params_cpu = get_model(cfg).init(seed=3, device="cpu")
    params_gpu = {"embed": params_cpu["embed"].to(DEV),
                  "segments": [{k: v.to(DEV) for k, v in s.items()}
                               for s in params_cpu["segments"]],
                  "final_norm": params_cpu["final_norm"].to(DEV),
                  "lm_head": params_cpu["lm_head"].to(DEV)}
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 100)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
               for n in (20, 45, 70)] + [rng.integers(0, cfg.vocab_size, 90)]
    ecfg = EngineConfig(num_lanes=4, max_len=256,
                        prefill_buckets=(32, 64, 128))
    outs, first = {}, {}
    for tag, dev, params in (("card", DEV, params_gpu),
                             ("cpu", "cpu", params_cpu)):
        eng = Engine(cfg, coopt, ecfg, params=params, device=dev)
        run_model = eng._run_model
        seen = []

        def capture(sb, run_model=run_model, seen=seen):
            logits = run_model(sb)
            if not seen:
                seen.append(logits.float().cpu())
            return logits
        eng._run_model = capture
        outs[tag] = eng.generate(prompts, max_new_tokens=24)
        first[tag] = seen[0]
    diff = (first["card"] - first["cpu"]).abs().max().item()
    scale = first["cpu"].abs().max().item()
    toks = [(a == b) for oa, ob in zip(outs["card"], outs["cpu"])
            for a, b in zip(oa, ob)]
    agree = sum(toks) / len(toks)
    first_tok = all(oa[0] == ob[0] for oa, ob in zip(outs["card"],
                                                     outs["cpu"]))
    log(f"card vs CPU (qwen3-4b-reduced): first-step max |logit diff| "
        f"{diff:.4f} (|logit| max {scale:.2f}, atol {LOGIT_ATOL}), greedy "
        f"agreement {agree:.3f}, first tokens equal {first_tok}")
    rec["parity"] = dict(max_logit_diff=diff, logit_max=scale,
                         greedy_agreement=agree, first_tokens_equal=first_tok)
    check(diff <= LOGIT_ATOL, "card and CPU logits differ")
    check(first_tok, "card and CPU disagree on a first greedy token")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels", "engine", "parity"),
                    help="run one phase (debugging; prints no result line)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import cuda
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    rec = {"card": smi}
    OUT.mkdir(exist_ok=True)
    try:
        t0 = time.perf_counter()
        cuda.build_all()
        rec["build_s"] = time.perf_counter() - t0
        log(f"kernels built in {rec['build_s']:.1f} s")
        (OUT / "build.log").write_text(
            "\n".join(f"== {n}\n{s}" for n, s in cuda.BUILD_LOG.items()))
        kernels = launches = None
        if args.only in (None, "kernels"):
            kernels = kernel_phase(torch, rec)
        if args.only in (None, "engine"):
            launches, launches1 = engine_phase(torch, rec)
        if args.only in (None, "parity"):
            parity_phase(torch, rec)
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        (OUT / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
        return 1
    finally:
        torch.cuda.synchronize()
    (OUT / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
    if args.only is not None:
        return 0
    for k in kernels:
        k["launches"] = (launches1 if k["name"] == "paged_pool_decode"
                         else launches)[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: x[k] for k in keys} for x in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
