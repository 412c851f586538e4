#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only kernels   # or write|decode|latent|engine|
                                           # prefill|async|serve|mla|packed|
                                           # recurrent|sharded|whisper|host|
                                           # parity|train|launch
    python3 chip_smoke.py --only decode --src OTHER/src
                                     # K2/K4 of another tree's package
                                     # (--only write: K1; --only latent:
                                     # K5/K7 of a tree whose K5/K7 report
                                     # kernel_info)

Phases:
  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
  2. each kernel at its path's shapes, held against its plain PyTorch
     version on the card. K1-K4 at qwen3-4b's widths (Hq 32, Hkv 8, D 128,
     pages of 64, 4 lanes with ~1024 cached tokens and a shared 256-token
     prefix): K1 at four shapes (``K1_SHAPES``: the engine's mixed chunk
     and decode step, the full prompt of 2 x 2048 tokens over a bf16 and an
     fp8 pool), pool bytes and scales equal (the JAX sentinel line
     excluded), beside one launch's floor (a 4-byte ``zero_()``) and its
     host microseconds a call; K4 bit-identical to K2, K2 and K3
     (unpacked and with two packed segments) within one bf16 ulp
     (``ATTN_RTOL``, ``ATTN_ATOL``).
     K5-K7 at deepseek-v2-lite's (H 16, R 512, dr 64, the same pages and
     lanes): K7 bit-identical to K5, K5 and K6 (unpacked and packed)
     within the f32 tolerance (``LAT_RTOL``, ``LAT_ATOL``). K2 and K4 again
     at a long context (4 lanes of 8192 tokens, 2048 shared: an fp8 pool
     larger than L2), with the same checks; a decode at G 8 and 32 lanes,
     whose K4 plan does not fit a block, must run K2. K8 at 2 x 2048
     tokens of qwen3-4b's heads within one bf16 ulp. Each check beside a
     control (one key masked off, or the packing planes dropped) that must
     fall outside its tolerance. K5 and K7 again at a long context (32
     lanes of ~4096 tokens, 1024 shared: ~58 MB of distinct fp8 latent
     pages), with the same checks, K7's time over K5's at equal work. Then each kernel's time (CUDA events, cold
     L2), the plain version's, a library call's that computes the same
     function, and the least time the card could take (``bound_ms``),
     with the achieved rate (the bound's operations over the time) and the
     share of the bound. K3 is also timed over the pool dequantized to
     bf16, and its chunk lane apart from its decode lanes; K6 its chunk
     lane apart from its decode lanes, with its launch's blocks, the
     registers and local bytes its instantiations report, the tensor
     cores' operations over the bound's, and its bound at the bf16 and the
     f32 rate; K2 and K4 record their splits and blocks, K5 and K7 their
     grid, splits, registers and local bytes.
  3. ``Engine.generate`` on qwen3-4b at full width and depth (random
     weights from a seed) in coopt mode with the kernels: 8 greedy
     requests, 4 sharing a 256-token prefix; K1, K3 and K4 must launch.
     Then a one-lane engine (4 layers) on which K2 must launch.
  4. The full-prompt prefill (``TransformerModel.prefill`` with no
     positions) of 2 x 2048 tokens on the same qwen3-4b weights: K8 must
     launch once per layer, and the last-token logits must agree with the
     same prompts chunked through K1/K3 within ``LOGIT_ATOL``.
  4b. ``AsyncEngine`` (the async pipeline: one CUDA graph a step shape,
     sampling on the card, one event-synced host ring) against
     ``Engine.generate`` in the same call, on the same qwen3-4b weights,
     settings and requests: 5 runners captured, no miss, K1, K3 and K4
     launched through replays (once per layer a step of their kind),
     greedy tokens equal to the sync run's or parted only at a near-tie of
     its logits (``NEAR_TIE``), tokens/s, TTFT and TPOT beside the sync
     run's; the async engine also at pipeline depth 1 (the same graphs,
     no overlap of host and card). Each of the three is served again
     under ``torch.profiler``: the card's busy time (the union of its
     kernels, copies and memsets) and idle share of the wall, and the
     trace's kernels must equal the launches the wrappers counted. One
     decode and one mixed step replayed against the eager body from the
     same pool state: logits and pool bytes equal; the decode and the
     512-token prefill graph's replays traced: kernels by group, the span
     and the gaps between kernels, each replay's kernels equal to its
     capture's counts.
     deepseek-v2-lite-16b at 4 layers (1 dense + 3 MoE) the same way (K6,
     K7 and the latent write replayed; its tokens held like for like, as
     in 5b). At 4 layers of qwen3-4b: a step
     fault closes every stream with ERROR and leaves no page in use, a
     cancel mid-stream frees its pages, and temperature 0.8 gives tokens
     inside the vocabulary.
  4c. The serving launcher (``repro_torch.launch.serve.ServeRunner``) on
     qwen3-4b at full width and depth (``SERVE``): 16 ShareGPT requests
     (``RequestStream``, scale 1.0: prompts up to 2048 tokens), 32 new
     tokens, Poisson arrivals at 2 requests/s, 4 lanes; sync, async and
     async + packing built up front on one parameter dict and warmed with
     a pass each, then measured round-robin, 2 passes each: tokens/s,
     TTFT/TPOT/queue-wait p50/p95, steps, packed steps; every request
     finished, the async runners with no step missing a runner and no
     runner built after the warmup (``assert_aot``), their tokens equal to
     the sync pass's or parted at a near-tie. mixtral-8x22b (MoE, window
     4096 + a sink page, G 6) at full width and 4 of its 56 layers
     (``SERVE_MOE``: a 5000-token prompt and 3 ShareGPT ones, 16 tokens)
     and internvl2-2b (vlm, a 1024-position patch stub, G 2) at full width
     and depth (``SERVE_VLM``: 8 ShareGPT requests), each through
     ``Engine.generate`` and ``AsyncEngine`` (tokens held as in 4b/5b):
     K3 and K4 held to their plain versions on steps of the sync run, a
     windowed chunk and decode past the window (controls: the window
     dropped, the newest key masked off) and a chunk past the stub; K4
     bit-identical to K2; the launches in windowed steps counted; a vlm
     engine with ``pack_prefill`` must raise.
  5. ``Engine.generate`` on deepseek-v2-lite-16b (MLA + MoE) at full width
     and depth, the same requests: K6 and K7 must launch. Then a one-lane
     engine (4 layers: 1 dense-FFN, 3 MoE) on which K5 must launch.
  5b. Concat-prefill packing (``EngineConfig.pack_prefill``): qwen2.5-14b
     at full width and depth (48 layers, G 5, qkv bias) on one set of
     weights: ``Engine.generate`` unpacked and packed, and
     ``AsyncEngine(warmup=True)`` packed (17 runners: decode, 4 prefill
     buckets, 3 row buckets x 4 buckets packed), 12 requests of 40-240
     prompt tokens (``packed_prompts``), 32 new tokens each; packed steps
     and rows saved > 0, K3 launched once a layer in every packed step
     (and through replays), packed tokens equal the unpacked run's and
     async the sync packed run's, or parted at a near-tie; one packed step
     whose row holds several prompts replayed against its eager body (0
     logit difference, 0 pool bytes). llama13b-gptq (the paper's model,
     MHA) at full width and depth, sync unpacked and packed, 16 tokens;
     yi-34b (G 7) and deepseek-67b (G 8) at full width and 4 layers, sync
     packed (K3 on packed rows, K4 on decode steps). For each of the four,
     K3 and K4 are held to their plain versions on the inputs of one of
     its packed and decode steps (G 5, 1, 7, 8), beside controls that must
     fail. deepseek-v2-lite-16b at 4 layers, sync and async packed: K6 on
     packed rows, by replays. A MoE model's async tokens are held to the
     async run's own steps replayed eagerly (its chunk and row layout:
     expert capacity is per row), and where a request's layout equals the
     sync run's, to the sync run too, each at a near-tie at most.
  5c. The recurrent families (``--only recurrent``). K1-K4 at
     recurrentgemma-9b's attention widths (D 256, Hq 16, Hkv 1: G 16, pages
     of 64, window 2048 + one sink page): K1 at B 4, S 512 (bytes and
     scales equal), K3 on a 512-token chunk past the window and its sink
     page beside 3 decode lanes, K2 and K4 on a windowed decode of 4 lanes
     (K4 = K2 bit for bit) and K2 at 8 lanes, where K4's plan does not fit
     (the wrapper must route it to K2), each beside a control that must
     fail (a key masked off, the window dropped), with its time, plain and
     library times, bound and the registers and local bytes of its
     instantiation. Then recurrentgemma-9b (38 layers, 10.4 B parameters)
     and rwkv6-7b (32 layers, 7.5 B) at full width and depth, coopt with
     the kernels, 4 lanes, ``Engine.generate`` then
     ``AsyncEngine(warmup=True)``: 8 requests (a 512-token prefix alone and
     the same prefix with 100 more tokens, admitted later: a prefix hit
     that restores a state snapshot; for griffin a 3000-token prompt past
     its window; ShareGPT prompts), 16 new tokens; the hit request's
     tokens equal its run with the prefix cache off or part at a near-tie;
     the async tokens equal the async run's own steps replayed eagerly
     (lane resets and restores included) exactly, and the sync run's where
     a request's chunk layout did not move, or part at a near-tie; K1, K3
     and K4 at D 256 held to their plain versions on engine-built steps
     past the window and sink page and launched there in both engines;
     rwkv6 launches no kernel; ``pack_prefill`` raises.
  5d. whisper-small (``--only whisper``). K1-K4 at its decoder widths (D
     64, Hq = Hkv = 12: G 1, pages of 64, 4 lanes of ~1024 cached tokens
     with a 128-token shared prefix): K1 at the mixed step (bytes and
     scales equal), K3 on a 512-token chunk beside 3 decode lanes, K2 and
     K4 on a 4-lane decode (K4 = K2 bit for bit), each beside a one-key
     control, with its time, plain and SDPA times, bound, registers and
     local bytes. Then whisper-small at full width and depth (12 encoder
     and 12 decoder layers, 1500 frames), coopt with the kernels, 4 lanes,
     max_len 512: 8 requests (4 sharing a 128-token prefix), 32 new tokens,
     ``Engine.generate`` then ``AsyncEngine(warmup=True)``: 1 + 2 x
     buckets runners (a prefill runner with the encoder and one without),
     no miss, the encoder exactly on the steps that carry a first chunk,
     a prefix hit, K1, K3 and K4 launched in both engines and held to their
     plain versions on engine-built steps, the async tokens equal to the
     sync run's or parted at a near-tie, one encoder-on and one
     encoder-off prefill step replayed against its eager body.
  5e. The host-DRAM tier (``--only host``): qwen3-4b at full width and
     depth, coopt with the kernels, in the reference's memory-pressure
     cell at pages of 64 (``HOST``: 8 distinct 3-page prefixes replayed
     twice on a 13-page pool, 2 lanes, 64 host pages, prefetch depth 2),
     ``Engine.generate`` with the tier on and off: host hits, spills and
     committed prefetches, a hit rate above the tier-off run's, both
     drained clean, every uploaded page equal byte for byte to the bytes
     its spill read, the tokens equal or parted at a near-tie; the copies'
     microseconds a page and GB/s on pinned memory; ``AsyncEngine`` with
     the tier on and off under the profiler (no runner missed, the card's
     idle share); ``host_quant`` on a bf16 pool at 4 layers (host bytes
     about half, roundtrip error under 0.2); the reference's tier chaos
     episode at 4 layers under ``AsyncEngine`` (dropped spills, a failed
     prefetch: every stream finished, drained clean).
  6. qwen3-4b-reduced, deepseek-v2-lite-16b-reduced, mixtral-8x22b-reduced,
     internvl2-2b-reduced, recurrentgemma-9b-reduced, rwkv6-7b-reduced and
     whisper-small-reduced (``PARITY``) with the same
     weights on the card (kernels) and on the CPU (plain versions): the
     first step's logits, and each request's logits until its stream
     parts, within ``LOGIT_ATOL``; first greedy tokens equal, a later one
     parted only at a near-tie of the CPU's logits (``NEAR_TIE``); MoE
     routes flipped only at a tie (``ROUTE_TIE``), which excuses the
     request's rows from that step on, and a control run of planted
     mis-routes that the check must flag; greedy agreement.
  7. Training (``--only train``), which runs no hand-written kernel (none
     has a backward; the wrappers refuse autograd): qwen3-4b at full size
     (36 layers, 4.41 B parameters) through ``Trainer`` (COOPT, the plain
     path, per-layer activation checkpointing, AdamW with f32 moments),
     ``TRAIN``: 8 steps of B 4 x S 512 from ``TrainPipeline(seed=0)``,
     every loss and grad norm finite, the last loss below the first, no
     kernel launched; step ms (median of steps 2-8), tokens/s, peak GiB and
     the model FLOPs' share of the bf16 peak (8 N T + attention); one more
     step's forward + backward and its AdamW update, each timed alone. The
     trained params through ``save_checkpoint`` and, the optimizer state
     freed, ``load_checkpoint`` onto the card, byte for byte; the loaded
     params served by ``Engine.generate`` (coopt, the kernels: K1, K3 and
     K4 launched, 4 greedy requests, tokens inside the vocabulary). The
     seven ``PARITY`` models: one ``make_train_step`` on the card and on
     the CPU from the same params and batch, the loss within
     ``TRAIN_LOSS_ATOL``, each leaf's gradient within ``TRAIN_GRAD_RTOL``
     (relative L2), a control with the labels rolled by one that must
     break it; a MoE model's card routes held to the CPU's, a flip only at
     a router near-tie (``TiePin``, ``ROUTE_TIE``). qwen3-4b at 4 layers,
     4 microbatches against 1 (the JAX test's bounds). ``loss_fn`` under
     autograd with ``use_kernel=True`` must raise.
  8. The launch tools (``--only launch``): ``launch.dryrun`` of all 40
     (arch x shape) cells on the meta device in ``DRY_WORKERS`` processes
     (39 ok, whisper-small x long_500k skipped; a line a cell: FLOPs,
     bytes to move, argument and temp bytes, whether it fits one card),
     and beside it ``LAUNCH_CELLS``, qwen3-4b and deepseek-v2-lite-16b x
     long_500k at full size through ``launch.steps.make_step`` on the
     card: K1 and K2 (window 8192 over an 8192-page lane table), or the
     latent write and K5, launched; each K1 call's written rows equal to
     the plain write's, byte for byte, and each K2 / K5 call held to its
     plain version on the inputs the step gave it, each beside a control
     that must fail; the step's logits within ``LAUNCH_LOGIT_ATOL`` of the
     plain step's, and a plain step with one layer's attention moved by
     one tolerance unit beyond it; the peak memory beside the dry run's;
     ``inspect_cell``'s top kernels and roofline terms.
Each kernel's launch count is read from the path that runs it, the counts
set to 0 just before that path and read just after; a kernel that never
launched fails the run. Launches through a CUDA graph count once a replay
(the counts its capture made, ``kernels/cuda.py:capture_launches``); the
``kernels`` line gives them as ``async_launches``, the packed phase's
packed runs' as ``packed_launches``, the serve phase's runs' as
``serve_launches``, the recurrent phase's as ``recurrent_launches``, the
whisper phase's as ``whisper_launches``, the host phase's as
``host_launches`` and the launch phase's as ``launch_launches``; K1-K4 add their D 256 and D 64 records to ``shapes``. K1's are also split by the
shape that runs them
(the 4-lane engine's mixed and decode steps, the full-prompt path). The
line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
Details go to ``chiprun_out/chip_smoke.json`` (``chip_smoke_src.json``
with ``--src``) and the nvcc (ptxas) log to ``chiprun_out/build.log``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
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
# chains and warp butterflies, or tensor-core tiles with P carried as two
# bf16 terms) and PyTorch take in different orders, so the two
# may round to neighbouring bf16 values: |kernel - plain| <= ATTN_ATOL +
# ATTN_RTOL * |plain| admits one bf16 ulp anywhere in a binade (an ulp is
# 2**-8 to 2**-7 of |x|) and nothing near zero beyond 2**-14. Each check
# also runs a control, the plain version with one key masked off, which
# must exceed the tolerance.
ATTN_RTOL = 2 ** -7
ATTN_ATOL = 2 ** -14
# The MLA latent kernels (K5, K6) return f32, summed in other orders than
# PyTorch's by the kernel (FMA chains, warp butterflies): |kernel - plain| <=
# LAT_ATOL + LAT_RTOL * |plain|, 32x and 4x tighter than the bf16
# criterion's terms; a one-key-masked control must exceed it.
LAT_RTOL = 2 ** -12
LAT_ATOL = 2 ** -16
# Reduced-model logits, bf16 activations through 2 layers: cuBLAS and the
# CPU's bf16 GEMMs round differently, a few bf16 ulps of |logit| ~ 4. The
# full-prompt phase holds qwen3-4b's last-token logits (K8 against K3 over
# a bf16 pool) to the same bound; K8's 64-key blocks and K3's 64-token
# pages run the same tensor-core tile update (``mma::RowTile``) in the same
# order, so they should agree exactly; that is read, not required.
LOGIT_ATOL = 0.125
# A greedy near-tie: the CPU's best two logits within NEAR_TIE, the card's
# pick among them (the CPU tests' rule against the JAX package).
NEAR_TIE = 0.1
# Two experts whose router probabilities lie within ROUTE_TIE of each other
# at the top-k boundary are a tie that a last-bit difference upstream may
# break either way. The bound lies between the CPU gap of the one route
# that flips in sound runs (2.55e-4 on an H100, the same token every run)
# and the narrowest gap of the parity phase's planted mis-routes; PERF.md
# keeps both readings.
ROUTE_TIE = 2 ** -9
# The launch phase's full-size steps (36 and 27 layers of random weights)
# with the kernels against the same steps on the plain path: their logits
# differed by at most 0.2090 (qwen3-4b) and 0.2188 (deepseek-v2-lite-16b,
# routes pinned at router near-ties) on an H100 80GB HBM3 at 700 W, and
# the plain step with one layer's attention output moved by one tolerance
# unit of its read kernel differed from itself by 0.2622 and 0.5762. The
# bound lies between: the kernel step must stay under it, that control
# must not.
LAUNCH_LOGIT_ATOL = 0.25

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
def make_timer(torch, clean=False):
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=DEV)

    def time_ms(fn, iters=20, warmup=3):
        """Mean device time of ``fn`` over ``iters`` calls, L2 flushed
        before each (the pool layer a step reads is cold in L2). A spin of
        ~0.5 ms keeps the card busy while the host reaches the launch, so
        a short kernel's time holds no wait for its Python wrapper. The
        flush zeroes a 128 MB buffer, which leaves L2 full of dirty lines;
        with ``clean`` it reads the buffer, which leaves them clean."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            if clean:
                flush.max()
            else:
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


def tol_ratio(got, plain, rtol=ATTN_RTOL, atol=ATTN_ATOL):
    """Largest |got - plain| as a share of the tolerance (<= 1 passes; the
    attention tolerance by default) and the largest absolute difference."""
    g, p = got.float(), plain.float()
    diff = (g - p).abs()
    ratio = (diff / (atol + rtol * p.abs())).max().item()
    return ratio, diff.max().item()


def bound(bytes_moved, flops, rate):
    """The least time the card could take (``bound_ms``), what bounds it,
    and the operations counted (``flops``, for the achieved rate)."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / rate * 1e3
    return dict(bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf
                else "operations", flops=flops)


# -------------------------------------------------------------- kernels --
def paged_pool(torch, gen, B, NP, shared, Hkv, D, ps):
    """An fp8 pool of B * NP + 1 pages (the last one reserved), K and V
    stacked with their scales, and lane b's table of pages b * NP ... b *
    NP + NP - 1, lanes 1.. sharing lane 0's first ``shared`` pages."""
    from repro_torch.cache.quant import quantize_fp8
    dev = gen.device
    P = B * NP + 1
    kq, ks = quantize_fp8(torch.randn((P, ps, Hkv, D), generator=gen,
                                      device=dev))
    vq, vs = quantize_fp8(torch.randn((P, ps, Hkv, D), generator=gen,
                                      device=dev))
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[1:, :shared] = table[0, :shared]
    return (torch.stack([kq, vq]).contiguous(),
            torch.stack([ks, vs]).contiguous(), table)


def decode_step(torch, rec, time_ms, key, q, kv, sc, table, cache_len,
                timed_plain=True, window=0, sink=0, visits_fit=True):
    """K2 and K4 on one decode step (Opt-KV, Opt-GQA, Opt-Pa page select,
    with ``window`` > 0 the window + ``sink`` pages policy): K2 within one
    bf16 ulp of its plain version beside a control (the plain version with
    each lane's last key masked off; windowed, also the window dropped)
    that must fail, K4 bit-identical to K2 and within the ulp of its own
    plain version; then each kernel's time, the bytes bound, SDPA on
    pre-gathered dequantized bf16 K/V, and the splits. Each plain version
    runs once for the check (and is timed only if ``timed_plain``). Where
    K4's plan does not fit (``visits_fit`` False), ``ops.paged_pool_decode``
    with ``share_visits`` must launch K2 and not K4, and only K2 is timed.
    The summary goes to ``rec[key]``; returns the kernel records."""
    import torch.nn.functional as F
    from repro_torch.core.opt_kv import decode_page_select
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels import paged_gqa_decode as pd
    from repro_torch.kernels import visits
    dev = q.device
    B, Hq, D = q.shape
    _, ps, Hkv, _ = kv[0].shape
    NP = table.shape[1]
    kw = dict(opt_kv=True, opt_gqa=True, window=window, sink_pages=sink)
    pool = (q, kv[0], kv[1], sc[0], sc[1])
    phys, logt = decode_page_select(cache_len, table, ps, window=window,
                                    sink_pages=sink, opt_pa=True)
    vp, vm, vl = visits.plan_visits(phys, logt)
    k2 = pd.paged_pool_decode(*pool, cache_len, phys, logt, **kw)
    p2 = pd.paged_pool_decode_ref(*pool, cache_len, phys, logt, **kw)
    c2 = pd.paged_pool_decode_ref(*pool, cache_len - 1, phys, logt, **kw)
    w2 = pd.paged_pool_decode_ref(*pool, cache_len, phys, logt,
                                  **dict(kw, window=0)) if window else None
    if visits_fit:
        k4 = pd.paged_pool_decode_visits(*pool, cache_len, vp, vm, vl, **kw)
        p4 = pd.paged_pool_decode_visits_ref(*pool, cache_len, vp, vm, vl,
                                             **kw)
    else:
        cuda.reset_launches()
        routed = ops.paged_pool_decode(q, kv, sc, cache_len, phys, logt,
                                       share_visits=True, **kw)
        launches = dict(cuda.LAUNCHES)
    torch.cuda.synchronize()
    r2, err2 = tol_ratio(k2, p2)
    rc2, errc2 = tol_ratio(k2, c2)
    n_visits = int((vp >= 0).sum().item())
    log(f"K2 paged_pool_decode ({key}): max |kernel - plain| {err2:.3e} = "
        f"{r2:.3f} of the tolerance (rtol {ATTN_RTOL}, atol {ATTN_ATOL}); "
        f"control, one key masked off: {errc2:.3e} = {rc2:.2f}")
    check(r2 <= 1, f"K2 differs from its plain version ({key})")
    check(rc2 > 1, f"the tolerance passes a one-key mask error in K2 ({key})")
    sfx = "" if key == "decode" else "_" + key
    tol = {"rtol": ATTN_RTOL, "atol": ATTN_ATOL, "k2" + sfx: r2,
           "k2_control" + sfx: rc2, "k2_control_err" + sfx: errc2}
    if w2 is not None:
        rw2, errw2 = tol_ratio(k2, w2)
        log(f"  control, window dropped: {errw2:.3e} = {rw2:.2f}")
        check(rw2 > 1, f"the tolerance passes a window error in K2 ({key})")
        tol["k2_window_control" + sfx] = rw2
    if visits_fit:
        r4, err4 = tol_ratio(k4, p4)
        bitwise = torch.equal(k4, k2)
        log(f"K4 paged_pool_decode_visits ({key}): bit-identical to K2 "
            f"{bitwise}, max |kernel - plain| {err4:.3e} = {r4:.3f} of the "
            f"tolerance, {n_visits} visits for "
            f"{int((phys >= 0).sum().item())} lane pages")
        check(bitwise, f"K4 is not bit-identical to K2 ({key})")
        check(r4 <= 1, f"K4 differs from its plain version ({key})")
        tol["k4" + sfx] = r4
    else:
        same = torch.equal(routed, k2)
        log(f"  {B} lanes, K4's plan does not fit: ops.paged_pool_decode "
            f"launched K2 {launches['paged_pool_decode']} and K4 "
            f"{launches['paged_pool_decode_visits']} times, equal to K2 "
            f"{same}")
        check(launches["paged_pool_decode"] == 1 and
              launches["paged_pool_decode_visits"] == 0,
              f"an oversized K4 plan was not routed to K2 ({key})")
        check(same, f"the rerouted decode differs from K2 ({key})")
    rec.setdefault("tolerance", {}).update(tol)
    # exact-data bound: distinct live pages once, q and out, the tables;
    # the keys each lane sees (its window and sink pages when windowed)
    live_pages = torch.unique(phys[phys >= 0]).numel()
    dec_bytes = live_pages * 2 * ps * Hkv * (D + 4) + 2 * B * Hq * D * 2 + \
        2 * B * NP * 4 + B * 4
    cl = cache_len.long()
    seen = cl if not window else (
        torch.clamp(cl, max=window)
        + torch.clamp(torch.clamp(cl - window, min=0), max=sink * ps))
    dec_flops = int(seen.sum().item()) * Hq * D * 4
    bnd = bound(dec_bytes, dec_flops, BF16_FLOPS)
    # library yardstick: SDPA on pre-gathered, dequantized bf16 K/V
    pt = table.long()
    kd = (kv[0][pt].float() * sc[0][pt][..., None]).to(torch.bfloat16)
    vd = (kv[1][pt].float() * sc[1][pt][..., None]).to(torch.bfloat16)
    kd = kd.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    vd = vd.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    kpos = torch.arange(NP * ps, device=dev)[None]
    mask = kpos < cache_len[:, None]
    if window:
        mask &= (kpos >= cache_len[:, None] - window) | (kpos < sink * ps)
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa_decode():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = (sdpa_decode()[:, :, 0].float() - p2.float()).abs().max().item()
    t_lib = time_ms(sdpa_decode)
    del kd, vd
    split = getattr(pd, "decode_splits", None)     # absent before the split
    slots, splits = split(NP, B * Hkv, torch.cuda.get_device_properties(
        dev).multi_processor_count) if split else (None, None)
    shape = (f"B={B} Hq={Hq} Hkv={Hkv} D={D} ps={ps} NSel={NP}, cache_len "
             f"{cache_len.tolist()}, {live_pages} distinct live pages")
    if window:
        shape += f", window {window} + {sink} sink page"
    out, summary = [], dict(shape=shape, library_ms=t_lib, **bnd,
                            visits=n_visits, slots=slots, splits=splits)
    for name, fn, plain, err, line, blocks in (
            ("paged_pool_decode",
             lambda: pd.paged_pool_decode(*pool, cache_len, phys, logt, **kw),
             lambda: pd.paged_pool_decode_ref(*pool, cache_len, phys, logt,
                                              **kw),
             err2, 122, splits and B * Hkv * splits),
            ("paged_pool_decode_visits",
             lambda: pd.paged_pool_decode_visits(*pool, cache_len, vp, vm, vl,
                                                 **kw),
             lambda: pd.paged_pool_decode_visits_ref(*pool, cache_len, vp, vm,
                                                     vl, **kw),
             visits_fit and err4, 288, splits and Hkv * splits))[
                :2 if visits_fit else 1]:
        ms = time_ms(fn)
        summary[name] = dict(ms=ms, blocks=blocks,
                             bound_share=bnd["bound_ms"] / ms,
                             x_library=ms / t_lib)
        share = summary[name]["bound_share"]
        log(f"  {name} ({key}): {ms:.4f} ms, {share:.2%} of the "
            f"{bnd['bound_ms']:.4f} ms bound, {ms / t_lib:.2f}x SDPA "
            f"({t_lib:.4f} ms); {splits} splits of {slots} slots, {blocks} "
            "blocks")
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/"
                               "paged_gqa_decode.cu",
                        replaces="src/repro/kernels/paged_gqa_decode.py:"
                                 f"{line}",
                        max_abs_err=err, ms=ms,
                        plain_ms=time_ms(plain, iters=5, warmup=1)
                        if timed_plain else None,
                        **bnd, library_ms=t_lib,
                        library="F.scaled_dot_product_attention on "
                                "pre-gathered dequantized bf16 K/V "
                                f"(max |lib - plain| {lib_err:.3e})",
                        shape=shape))
    rec[key] = summary
    return out


def long_decode_phase(torch, rec, time_ms):
    """K2 and K4 at a long context, where bytes dominate: qwen3-4b's heads,
    4 lanes of 8192 tokens (128 pages of 64), the first 2048 tokens shared
    by all four (an fp8 pool of ~67 MB, more than L2)."""
    gen = torch.Generator(device=torch.device(DEV)).manual_seed(5)
    B, Hq, Hkv, D, ps, NP = 4, 32, 8, 128, 64, 128
    kv, sc, table = paged_pool(torch, gen, B, NP, 32, Hkv, D, ps)
    cache_len = torch.tensor([8192, 8150, 8100, 8050], dtype=torch.int32,
                             device=DEV)
    q = torch.randn((B, Hq, D), generator=gen, device=DEV).to(torch.bfloat16)
    decode_step(torch, rec, time_ms, "decode_long", q, kv, sc, table,
                cache_len, timed_plain=False)


def oversized_decode_case(torch, rec):
    """A decode whose K4 plan does not fit one block's shared memory: G 8
    (Hq 64, Hkv 8, D 128) at 32 lanes over fp8 pages of 128, through
    ``ops.paged_pool_decode`` with ``share_visits``, must launch K2 and not
    K4, and give K2's bits."""
    from repro_torch.core.opt_kv import decode_page_select
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels import paged_gqa_decode as pd
    gen = torch.Generator(device=torch.device(DEV)).manual_seed(6)
    B, Hq, Hkv, D, ps, NP = 32, 64, 8, 128, 128, 4
    kv, sc, table = paged_pool(torch, gen, B, NP, 1, Hkv, D, ps)
    cache_len = torch.randint(ps + 1, NP * ps + 1, (B,), generator=gen,
                              device=DEV, dtype=torch.int32)
    q = torch.randn((B, Hq, D), generator=gen, device=DEV).to(torch.bfloat16)
    phys, logt = decode_page_select(cache_len, table, ps, opt_pa=True)
    kw = dict(opt_kv=True, opt_gqa=True)
    cuda.reset_launches()
    got = ops.paged_pool_decode(q, kv, sc, cache_len, phys, logt,
                                share_visits=True, **kw)
    launches = dict(cuda.LAUNCHES)
    k2 = pd.paged_pool_decode(q, kv[0], kv[1], sc[0], sc[1], cache_len, phys,
                              logt, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, k2)
    log(f"decode G 8 at 32 lanes (fp8 pages of 128): K2 launches "
        f"{launches['paged_pool_decode']}, K4 launches "
        f"{launches['paged_pool_decode_visits']}, equal to K2 {same}")
    check(launches["paged_pool_decode"] == 1 and
          launches["paged_pool_decode_visits"] == 0,
          "an oversized K4 plan was not routed to K2")
    check(same, "the rerouted decode differs from K2")
    rec["decode_g8_b32"] = dict(launches=launches, equal_to_k2=same)


def decode_phase(torch, rec, time_ms):
    """K2 and K4 alone (``--only decode``, for comparing trees): the kernel
    phase's decode shape on a pool of its own, then the long shape."""
    gen = torch.Generator(device=torch.device(DEV)).manual_seed(4)
    B, Hq, Hkv, D, ps, NP = 4, 32, 8, 128, 64, 16
    kv, sc, table = paged_pool(torch, gen, B, NP, 4, Hkv, D, ps)
    cache_len = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32,
                             device=DEV)
    q = torch.randn((B, Hq, D), generator=gen, device=DEV).to(torch.bfloat16)
    decode_step(torch, rec, time_ms, "decode", q, kv, sc, table, cache_len)
    long_decode_phase(torch, rec, time_ms)


# ------------------------------------------------------------------ K1 --
# K1's shapes, all at qwen3-4b's widths (Hkv 8, D 128, pages of 64): key,
# lanes B, tokens a lane S, valid tokens of each lane, the first one's
# position, pages a lane, fp8 pool (Opt-KV), and the run that launches K1
# at this shape (the 4-lane engine's mixed or decode steps, the full-prompt
# path; None: no path writes an fp8 pool of 2 x 2048 tokens at once).
K1_SHAPES = (
    ("mixed", 4, 512, (512, 300, 1, 64), 0, 16, True, "qwen3-4b prefill"),
    ("decode", 4, 1, (1, 1, 1, 1), 1000, 16, True, "qwen3-4b decode"),
    ("full_prompt_bf16", 2, 2048, (2048, 2048), 0, 32, False,
     "qwen3-4b full prompt"),
    ("full_prompt_fp8", 2, 2048, (2048, 2048), 0, 32, True, None),
)


def write_case(torch, time_ms, gen, key, B, S, n_valid, start, NP, opt_kv,
               Hkv=8, D=128, ps=64):
    """K1 at one shape through ``ops.kv_cache_write``: pool bytes and scales
    equal to the plain version's (the JAX sentinel line excluded; at the
    mixed shape also the e4m3 edge row), then the kernel's time, the plain
    version's, ``index_copy_`` of the written K rows and the bytes bound."""
    from repro_torch.kernels import kv_cache_write as kw
    from repro_torch.kernels import ops
    dev = gen.device
    P = B * NP + 1                          # + the reserved last page
    kn = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    vn = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    if key == "mixed":
        kn[0, 0, 0, :] = 448.0              # exact e4m3 edge: scale 1
        kn[0, 0, 0, 1:9] = torch.tensor([1.0625, 1.1875, -1.0625, 432.0,
                                         -432.0, 0.0, 3.25, 208.0])  # ties
    slots = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    for b, n in enumerate(n_valid):
        slots[b, :n] = (torch.arange(n, device=dev, dtype=torch.int32)
                        + b * NP * ps + start)
    dt = torch.float8_e4m3fn if opt_kv else torch.bfloat16
    pool_a = torch.zeros((2, P, ps, Hkv, D), dtype=dt, device=dev)
    sc_a = torch.zeros((2, P, ps, Hkv), device=dev) if opt_kv else None
    pool_b = pool_a.clone()
    sc_b = sc_a.clone() if opt_kv else None
    flat_a = pool_a.view(2, P * ps, Hkv, D)
    flat_b = pool_b.view(2, P * ps, Hkv, D)
    sflat_b = sc_b.view(2, P * ps, Hkv) if opt_kv else (None, None)

    def kernel():
        ops.kv_cache_write(pool_a, sc_a, kn, vn, slots, opt_kv=opt_kv)

    def plain():
        kw.kv_cache_write_ref(kn, vn, slots, flat_b[0], flat_b[1],
                              sflat_b[0], sflat_b[1], opt_kv=opt_kv)
    kernel()
    plain()
    torch.cuda.synchronize()
    n = P * ps - 1
    same = torch.equal(flat_a[:, :n].view(torch.uint8),
                       flat_b[:, :n].view(torch.uint8))
    same_sc = True
    if opt_kv:
        sflat_a = sc_a.view(2, P * ps, Hkv)
        same_sc = torch.equal(sflat_a[:, :n], sflat_b[:, :n])
        err = (flat_a[:, :n].float() * sflat_a[:, :n, :, None] -
               flat_b[:, :n].float() * sflat_b[:, :n, :, None]).abs().max()
    else:
        err = (flat_a[:, :n].float() - flat_b[:, :n].float()).abs().max()
    res = dict(key=key, max_abs_err=err.item(), bytes_equal=same,
               scales_equal=same_sc)
    log(f"K1 kv_cache_write ({key}): pool bytes equal {same}, scales equal "
        f"{same_sc}")
    check(same and same_sc, f"K1 differs from its plain version ({key})")
    if key == "mixed":
        edge = flat_a[0, 0, 0, :9].float().tolist()
        log(f"K1 e4m3 edge values {edge}")
        check(edge == [448.0, 1.0, 1.25, -1.0, 448.0, -448.0, 0.0, 3.25,
                       208.0], f"K1 e4m3 edge/tie values {edge}")
    # the kernel reads every slot but the K/V rows of valid slots only (a
    # dropped slot's row is never read), and writes each valid token's lines
    valid = sum(n_valid)
    out_bytes = D + 4 if opt_kv else 2 * D
    k1_bytes = (2 * valid * Hkv * D * 2 + B * S * 4
                + 2 * valid * Hkv * out_bytes)
    k1_ops = 2 * valid * Hkv * D * 4 if opt_kv else 0  # abs, max, div, cvt
    ok_slots = slots.reshape(-1)[slots.reshape(-1) >= 0].long()
    rows = flat_b[0][ok_slots].view(torch.uint8).contiguous()
    res.update(ms=time_ms(kernel), plain_ms=time_ms(plain),
               library_ms=time_ms(lambda: flat_a[0].view(
                   torch.uint8).index_copy_(0, ok_slots, rows)),
               **bound(k1_bytes, k1_ops, F32_FLOPS),
               shape=f"B={B} S={S} Hkv={Hkv} D={D}, {valid} valid, "
                     f"{'fp8' if opt_kv else 'bf16'} pool")
    return res


def host_us(torch, fn, calls=1000):
    """Host microseconds a call: the mean of ``calls`` back-to-back calls,
    no sync between them (the cost the engine's host pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def write_phase(torch, rec, time_ms, gen=None):
    """K1 at its four shapes (``K1_SHAPES``; the mixed chunk from ``gen``,
    the others from a generator of their own), one launch's floor (a 4-byte
    ``zero_()``) in the same timer, and the host microseconds of
    ``ops.kv_cache_write`` at the decode shape. Returns the K1 ``kernels``
    entry: the mixed shape's numbers, with a record for each shape."""
    from repro_torch.kernels import ops
    dev = torch.device(DEV)
    gen = gen or torch.Generator(device=dev).manual_seed(0)
    own = torch.Generator(device=dev).manual_seed(9)
    shapes = [write_case(torch, time_ms, gen if key == "mixed" else own, key,
                         *args) for key, *args, _ in K1_SHAPES]
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = time_ms(z.zero_)
    B, Hkv, D, P, ps = 4, 8, 128, 65, 64
    kn = torch.randn((B, 1, Hkv, D), generator=own, device=dev).bfloat16()
    slots = (torch.arange(B, device=dev, dtype=torch.int32) * 1024 + 1000
             ).reshape(B, 1)
    pool = torch.zeros((2, P, ps, Hkv, D), dtype=torch.float8_e4m3fn,
                       device=dev)
    sc = torch.zeros((2, P, ps, Hkv), device=dev)
    us = host_us(torch, lambda: ops.kv_cache_write(pool, sc, kn, kn, slots,
                                                   opt_kv=True))
    # the mixed shape again with L2 left clean by the flush: what evicting
    # the timer's dirty lines costs K1 (5.5 MB) and index_copy_ (1.8 MB)
    clean = write_case(torch, make_timer(torch, clean=True),
                       torch.Generator(device=dev).manual_seed(9),
                       *K1_SHAPES[0][:-1])
    for r in shapes:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["x_lib"] = r["ms"] / r["library_ms"]
        r["floor_share"] = r["bound_ms"] / floor_ms
        log(f"  K1 {r['key']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"index_copy_ {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} "
            f"by {r['bound_by']}); {r['bound_share']:.2%} of the bound, "
            f"{r['x_lib']:.2f}x index_copy_, {r['ms'] / floor_ms:.2f}x the "
            f"launch floor")
    log(f"  K1 launch floor (4-byte zero_): {floor_ms:.4f} ms; host "
        f"{us:.1f} us a call at the decode shape (mean of 1000, no sync); "
        f"mixed with a clean L2: {clean['ms']:.4f} ms, index_copy_ "
        f"{clean['library_ms']:.4f}")
    mixed = shapes[0]
    entry = dict(name="kv_cache_write", route="cuda",
                 source="src/repro_torch/kernels/csrc/kv_cache_write.cu",
                 replaces="src/repro/kernels/kv_cache_write.py:59",
                 library="index_copy_ of the written K rows (scatter only)",
                 shapes=shapes, launch_floor_ms=floor_ms, host_us=us,
                 clean_l2=dict(ms=clean["ms"],
                               library_ms=clean["library_ms"]),
                 **{k: mixed[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "flops", "shape")})
    rec["write"] = entry
    return entry


def kernel_phase(torch, rec, time_ms):
    """K1-K4 at qwen3-4b's widths (K2/K4 through ``decode_step``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels import flash_chunk_prefill as fc
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, Hq, Hkv, D, ps, NP = 4, 32, 8, 128, 64, 16
    out = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # pool: lanes 1-3 share lane 0's first 4 pages (a 256-token prefix)
    kv, sc, table = paged_pool(torch, gen, B, NP, 4, Hkv, D, ps)
    cache_len = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32,
                             device=dev)
    # ---- K1 at its paths' shapes (the mixed chunk from this generator) ----
    S = 512
    out.append(write_phase(torch, rec, time_ms, gen))

    # ---- K2 / K4: a decode step of 4 lanes --------------------------------
    q = randn(B, Hq, D).to(torch.bfloat16)
    out += decode_step(torch, rec, time_ms, "decode", q, kv, sc, table,
                       cache_len)

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
    pt = table.long()
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
    bnd = bound(chunk_bytes, chunk_flops, BF16_FLOPS)
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
                    **bnd, library_ms=time_ms(sdpa_chunk),
                    library="F.scaled_dot_product_attention on pre-gathered "
                            "dequantized bf16 K/V with a causal position "
                            f"mask (max |lib - plain| {lib_err3:.3e})",
                    shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} ps={ps} "
                          f"NP={NP}"))
    # what K3's time is made of: the same step over the pool dequantized to
    # bf16 (no fp8 staging, no scales), and the chunk lane apart from the
    # three decode lanes
    kvb = torch.stack([kv[i].float() * sc[i][..., None] for i in (0, 1)]) \
        .to(torch.bfloat16)
    split = dict(fp8_pool_ms=out[-1]["ms"], bf16_pool_ms=time_ms(
        lambda: ops.paged_chunk_prefill(qc, pos, kvb, None, table,
                                        opt_kv=False, opt_gqa=True)))
    for key, lanes in (("chunk_lane_ms", slice(0, 1)),
                       ("decode_lanes_ms", slice(1, B))):
        split[key] = time_ms(lambda: ops.paged_chunk_prefill(
            qc[lanes], pos[lanes], kv, sc, table[lanes], opt_kv=True,
            opt_gqa=True))
    log("K3 split: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    rec["k3_split"] = split
    del kvb
    rec["ptxas"] = {n: [ln for ln in s.splitlines() if "registers" in ln
                        or "spill" in ln] for n, s in cuda.BUILD_LOG.items()}
    return out


def latent_decode_step(torch, rec, time_ms, key, lat, sc, table, cache_len,
                       H, lat_d=None, q=None, timed_plain=True, dn=128):
    """K5 and K7 on one decode step of deepseek-v2-lite's widths (``H``
    heads, query heads of ``dn`` + dr: glm-4.7-flash's 20 and 192) over the
    fp8 latent pool ``lat``/``sc``: K5 within the f32 tolerance of its plain
    version beside a control (each lane's last key masked off) that must
    fail, K7 bit-identical to K5; then each kernel's time, the bound of the
    function both compute (bytes of each distinct page once, against
    operations at the bf16 rate of the tensor cores they run on; the bound
    of the pages each kernel reads beside it as ``own_bound_ms``), the grid,
    splits and registers the loaded kernels report, and SDPA on ``lat_d``
    (each lane's pages gathered and dequantized to bf16) where given.
    ``q``: (q_lat, q_rope), else drawn from a seed. The summary goes to
    ``rec[key]``; returns the two kernel records."""
    import torch.nn.functional as F
    from repro_torch.core.opt_kv import decode_page_select
    from repro_torch.kernels import paged_latent_decode as ld
    from repro_torch.kernels import visits
    dev = lat.device
    B, NP = table.shape
    _, ps, W = lat.shape
    R, dr = 512, W - 512                        # deepseek-v2-lite's R
    sm_scale = 1.0 / (dn + dr) ** 0.5
    if q is None:
        gen = torch.Generator(device=dev).manual_seed(7)
        q = (torch.randn((B, H, R), generator=gen, device=dev),
             torch.randn((B, H, dr), generator=gen, device=dev))
    ql, qr = q
    phys, logt = decode_page_select(cache_len, table, ps, opt_pa=True)
    vp, vm, vl = visits.plan_visits(phys, logt)
    kw = dict(sm_scale=sm_scale, opt_kv=True)
    k5 = ld.paged_latent_decode(ql, qr, lat, sc, cache_len, phys, logt, **kw)
    k7 = ld.paged_latent_decode_visits(ql, qr, lat, sc, cache_len, vp, vm, vl,
                                       **kw)
    p5 = ld.paged_latent_decode_ref(ql, qr, lat, sc, cache_len, phys, logt,
                                    **kw)
    c5 = ld.paged_latent_decode_ref(ql, qr, lat, sc, cache_len - 1, phys,
                                    logt, **kw)
    torch.cuda.synchronize()
    r5, err5 = tol_ratio(k5, p5, LAT_RTOL, LAT_ATOL)
    rc5, errc5 = tol_ratio(k5, c5, LAT_RTOL, LAT_ATOL)
    bitwise = torch.equal(k7, k5)
    n_visits = int((vp >= 0).sum().item())
    sel_pages = int((phys >= 0).sum().item())
    uniq_pages = torch.unique(phys[phys >= 0]).numel()
    log(f"K5 paged_latent_decode ({key}): max |kernel - plain| {err5:.3e} = "
        f"{r5:.3f} of the f32 tolerance (rtol {LAT_RTOL}, atol {LAT_ATOL}); "
        f"control, one key masked off: {errc5:.3e} = {rc5:.2f}")
    log(f"K7 paged_latent_decode_visits ({key}): bit-identical to K5 "
        f"{bitwise}, {n_visits} visits for {sel_pages} lane pages "
        f"({uniq_pages} distinct)")
    check(r5 <= 1, f"K5 differs from its plain version ({key})")
    check(rc5 > 1, f"the tolerance passes a one-key mask error in K5 ({key})")
    check(bitwise, f"K7 is not bit-identical to K5 ({key})")
    sfx = "" if key == "latent" else "_" + key
    rec.setdefault("tolerance", {}).update(
        {"lat_rtol": LAT_RTOL, "lat_atol": LAT_ATOL, "k5" + sfx: r5,
         "k5_control" + sfx: rc5, "k5_control_err" + sfx: errc5})
    keys = int(cache_len.sum().item())
    dec_flops = keys * H * (2 * W + 2 * R)      # score + weighted sum
    io_bytes = B * H * (W + R) * 4 + B * 4      # q in, o_lat out, lengths
    lib, t_lib = None, None
    if lat_d is not None:
        q_d = torch.cat([ql, qr], -1).to(torch.bfloat16)[:, :, None, :]
        kpos = torch.arange(lat_d.shape[2], device=dev)
        dmask = (kpos[None] < cache_len[:, None])[:, None, None, :]
        val_d = lat_d[..., :R]

        def sdpa_decode():
            return F.scaled_dot_product_attention(
                q_d, lat_d, val_d, attn_mask=dmask, scale=sm_scale,
                enable_gqa=True)
        lib_err = (sdpa_decode()[:, :, 0].float() - p5).abs().max().item()
        t_lib = time_ms(sdpa_decode)
        lib = ("F.scaled_dot_product_attention on pre-gathered dequantized "
               f"bf16 latents, scale= given (max |lib - plain| "
               f"{lib_err:.3e})")
    lens = cache_len.tolist() if B <= 4 else f"mean {keys / B:.1f}"
    shape = (f"B={B} H={H} R={R} dr={dr} ps={ps} NSel={NP}, cache_len "
             f"{lens}, {sel_pages} lane pages, {uniq_pages} distinct")
    # the function's bound counts each distinct page once (584 B a token:
    # 576 fp8 + 2 f32 scales); K5 reads every selected page, which its own
    # reads' bound below states beside it
    bnd = bound(uniq_pages * ps * (W + 8) + io_bytes + 3 * vp.numel() * 4,
                dec_flops, BF16_FLOPS)
    out, summary = [], dict(shape=shape, library_ms=t_lib, **bnd,
                            visits=n_visits, lane_pages=sel_pages,
                            distinct_pages=uniq_pages)
    for name, fn, plain, pages, tables, line, visit_list in (
            ("paged_latent_decode",
             lambda: ld.paged_latent_decode(ql, qr, lat, sc, cache_len, phys,
                                            logt, **kw),
             lambda: ld.paged_latent_decode_ref(ql, qr, lat, sc, cache_len,
                                                phys, logt, **kw),
             sel_pages, 2 * B * NP * 4, 132, False),
            ("paged_latent_decode_visits",
             lambda: ld.paged_latent_decode_visits(ql, qr, lat, sc, cache_len,
                                                   vp, vm, vl, **kw),
             lambda: ld.paged_latent_decode_visits_ref(
                 ql, qr, lat, sc, cache_len, vp, vm, vl, **kw),
             uniq_pages, 3 * vp.numel() * 4, 277, True)):
        own = bound(pages * ps * (W + 8) + io_bytes + tables, dec_flops,
                    BF16_FLOPS)
        ms = time_ms(fn)
        fn()                                    # the grid of this shape
        torch.cuda.synchronize()
        k = ld.kernel_info(R, dr, True, visit_list, dev, heads=H)
        summary[name] = dict(ms=ms, bound_share=bnd["bound_ms"] / ms,
                             own_bound_ms=own["bound_ms"],
                             own_bound_share=own["bound_ms"] / ms,
                             x_library=t_lib and ms / t_lib, **k)
        log(f"  {name} ({key}): {ms:.4f} ms, "
            f"{summary[name]['bound_share']:.2%} of the {bnd['bound_ms']:.4f}"
            f" ms bound (distinct pages once; its own reads "
            f"{summary[name]['own_bound_share']:.2%} of "
            f"{own['bound_ms']:.4f} ms)" +
            (f", {ms / t_lib:.2f}x SDPA ({t_lib:.4f} ms)" if t_lib else "") +
            f"; {k['last_blocks']} blocks of {k['lanes_per_block']} lanes, "
            f"{k['last_splits']} splits, registers / local bytes a thread "
            f"{k['registers']}/{k['local_bytes']}")
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/"
                               "paged_latent_decode.cu",
                        replaces="src/repro/kernels/paged_latent_decode.py:"
                                 f"{line}",
                        max_abs_err=err5, ms=ms,
                        plain_ms=time_ms(plain, iters=5, warmup=1)
                        if timed_plain else None,
                        **bnd, own_bound_ms=own["bound_ms"], library_ms=t_lib,
                        library=lib, shape=shape, registers=k["registers"],
                        local_bytes=k["local_bytes"], blocks=k["last_blocks"],
                        splits=k["last_splits"],
                        lanes_per_block=k["lanes_per_block"]))
    summary["k7_over_k5"] = summary["paged_latent_decode_visits"]["ms"] / \
        summary["paged_latent_decode"]["ms"]
    log(f"  K7 / K5 at equal work ({key}): {summary['k7_over_k5']:.3f}")
    rec[key] = summary
    return out


def latent_long_case(torch, rec, time_ms):
    """K5 and K7 at a long context, where bytes dominate: deepseek-v2-lite's
    widths, 32 lanes of ~4096 cached tokens (64 pages of 64), the first 1024
    tokens shared by all 32 (an fp8 latent pool of ~58 MB of distinct pages,
    more than L2)."""
    from repro_torch.cache.quant import quantize_latent
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(8)
    B, H, R, dr, ps, NP, shared = 32, 16, 512, 64, 64, 64, 16
    P = B * NP + 1
    lat_f = torch.randn((P, ps, R + dr), generator=gen, device=dev)
    lat_f[..., R:] *= 3.0
    lat, sc = quantize_latent(lat_f, R)
    del lat_f
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[1:, :shared] = table[0, :shared]
    cache_len = (NP * ps - torch.arange(B, device=dev, dtype=torch.int32)
                 ).contiguous()
    latent_decode_step(torch, rec, time_ms, "latent_long", lat, sc, table,
                       cache_len, H, timed_plain=False)


def latent_phase(torch, rec, time_ms):
    """K5 and K7 alone (``--only latent``, for comparing trees): the kernel
    phase's decode shape on a pool of its own, the same at glm-4.7-flash's
    20 heads (two 16-row groups a lane, ``rec["latent_h20"]``), then the
    long shape."""
    from repro_torch.cache.quant import quantize_latent
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, R, dr, ps, NP = 4, 16, 512, 64, 64, 16
    lat_f = torch.randn((B * NP + 1, ps, R + dr), generator=gen, device=dev)
    lat_f[..., R:] *= 3.0
    lat, sc = quantize_latent(lat_f, R)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[1:, :4] = table[0, :4]
    cache_len = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32,
                             device=dev)
    latent_decode_step(torch, rec, time_ms, "latent", lat, sc, table,
                       cache_len, H, timed_plain=False)
    pt = table.long()
    lat_d = (torch.cat([lat[pt][..., :R].float() * sc[pt][..., 0:1],
                        lat[pt][..., R:].float() * sc[pt][..., 1:2]], -1)
             .to(torch.bfloat16).reshape(B, 1, NP * ps, R + dr))
    rec["latent_h20_kernels"] = latent_decode_step(
        torch, rec, time_ms, "latent_h20", lat, sc, table, cache_len, 20,
        lat_d, dn=192)
    latent_long_case(torch, rec, time_ms)


def mla_kernel_phase(torch, rec, time_ms):
    """K5, K7 and K6 at deepseek-v2-lite's widths (H 16, R 512, dr 64, pages
    of 64): a decode step of 4 lanes with ~1024 cached tokens and a shared
    256-token prefix, and a mixed step of one 512-token chunk lane and
    three decode lanes."""
    import torch.nn.functional as F
    from repro_torch.cache.quant import quantize_latent
    from repro_torch.kernels import ops
    from repro_torch.kernels import latent_chunk_prefill as lc
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, R, dr, ps, NP, S = 4, 16, 512, 64, 64, 16, 512
    W = R + dr
    sm_scale = 1.0 / (128 + dr) ** 0.5          # 1/sqrt(dn + dr), dn 128
    P = B * NP + 1
    out = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    lat_f = randn(P, ps, W)
    lat_f[..., R:] *= 3.0                       # k_rope on its own scale
    lat, sc = quantize_latent(lat_f, R)
    table = torch.arange(B * NP, device=dev, dtype=torch.int32).reshape(B, NP)
    table[1:, :4] = table[0, :4]                # a 256-token shared prefix
    cache_len = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32,
                             device=dev)
    # library yardstick input: each lane's pages gathered and dequantized,
    # bf16, one kv head shared by all H query heads
    pt = table.long()
    lat_d = (torch.cat([lat[pt][..., :R].float() * sc[pt][..., 0:1],
                        lat[pt][..., R:].float() * sc[pt][..., 1:2]], -1)
             .to(torch.bfloat16).reshape(B, 1, NP * ps, W))
    val_d = lat_d[..., :R]
    kpos = torch.arange(NP * ps, device=dev)

    # ---- K5 / K7: a decode step ------------------------------------------
    kw = dict(sm_scale=sm_scale, opt_kv=True)
    out += latent_decode_step(torch, rec, time_ms, "latent", lat, sc, table,
                              cache_len, H, lat_d,
                              q=(randn(B, H, R), randn(B, H, dr)))

    # ---- K6: a mixed step: lane 0 a 512-token chunk at [512, 1024), -------
    # lanes 1-3 decode lanes (one token, padding clamped to it)
    qlc, qrc = randn(B, S, H, R), randn(B, S, H, dr)
    pos = torch.empty((B, S), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(512, 1024, device=dev, dtype=torch.int32)
    for b in range(1, B):
        pos[b] = cache_len[b] - 1
    k6 = ops.latent_chunk_prefill(qlc, qrc, pos, lat, sc, table, **kw)
    p6 = lc.latent_chunk_prefill_ref(qlc, qrc, pos, lat, sc, table, **kw)
    c6 = lc.latent_chunk_prefill_ref(qlc, qrc, pos - 1, lat, sc, table, **kw)
    # packing: lane 0's row holds two prompts, rows [0, 256) at [512, 768)
    # on its own pages, rows [256, 512) a second prompt at [0, 256) on lane
    # 3's pages 4-7, whose key positions restart at 0
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
    k6p = ops.latent_chunk_prefill(qlc, qrc, pos_pk, lat, sc, table_pk, **kw,
                                   **planes)
    p6p = lc.latent_chunk_prefill_ref(qlc, qrc, pos_pk, lat, sc, table_pk,
                                      **kw, **planes)
    c6p = lc.latent_chunk_prefill_ref(qlc, qrc, pos_pk, lat, sc, table_pk,
                                      **kw)
    k6p_masked = lc.latent_chunk_prefill_ref(qlc, qrc, pos_pk - 1, lat, sc,
                                             table_pk, **kw, **planes)
    torch.cuda.synchronize()
    r6, err6 = tol_ratio(k6, p6, LAT_RTOL, LAT_ATOL)
    rc6, errc6 = tol_ratio(k6, c6, LAT_RTOL, LAT_ATOL)
    r6p, err6p = tol_ratio(k6p, p6p, LAT_RTOL, LAT_ATOL)
    rc6p, errc6p = tol_ratio(k6p, c6p, LAT_RTOL, LAT_ATOL)
    rk6p, errk6p = tol_ratio(k6p, k6p_masked, LAT_RTOL, LAT_ATOL)
    log(f"K6 latent_chunk_prefill: max |kernel - plain| {err6:.3e} = "
        f"{r6:.3f} of the f32 tolerance; control, one key masked off: "
        f"{errc6:.3e} = {rc6:.2f}")
    log(f"K6 packed (two segments in lane 0): max |kernel - plain| "
        f"{err6p:.3e} = {r6p:.3f} of the f32 tolerance; controls: one key "
        f"masked off {errk6p:.3e} = {rk6p:.2f}, planes dropped "
        f"{errc6p:.3e} = {rc6p:.2f}")
    check(r6 <= 1, "K6 differs from its plain version")
    check(r6p <= 1, "packed K6 differs from its plain version")
    check(rc6 > 1, "the tolerance passes a one-key mask error in K6")
    check(rc6p > 1, "the tolerance passes a segment mask error in K6")
    check(rk6p > 1, "the tolerance passes a one-key mask error in packed K6")
    rec["tolerance"].update(k6=r6, k6_packed=r6p, k6_control=rc6,
                            k6_control_err=errc6, k6_packed_control=rc6p,
                            k6_packed_key_control=rk6p, k6_packed_err=err6p)
    qpos = pos.long()
    last_page = qpos.amax(dim=1) // ps
    used = torch.cat([table[b, :int(last_page[b]) + 1] for b in range(B)])
    chunk_keys = int((qpos + 1).sum().item()) * H       # causal (row, key)
    chunk_flops = chunk_keys * (2 * W + 2 * R)
    chunk_bytes = torch.unique(used).numel() * ps * (W + 8) + \
        B * S * H * (W + R) * 4 + B * S * 4 + B * NP * 4
    # what the tensor cores execute: every (row, key) pair of each 64-key
    # tile (a page shorter than 64 keys fills a whole tile) that a row group
    # of 16 rows does not skip as wholly in its future, with the kernel's
    # bf16 terms of q over R + dr dims and of P' over R
    rows = qpos.repeat_interleave(H, dim=1)
    rows = F.pad(rows, (0, -rows.shape[1] % 16), value=-1)
    gmax = rows.reshape(B, -1, 16).amax(-1)             # (B, groups)
    kstart = torch.arange(NP, device=dev)[:, None] * ps + \
        torch.arange(0, ps, 64, device=dev)
    tiles = (table >= 0)[:, None, :, None] & \
        (kstart[None, None] <= gmax[:, :, None, None])
    tc_pairs = int(tiles.sum().item()) * 16 * 64
    q6 = torch.cat([qlc, qrc], -1).to(torch.bfloat16).transpose(1, 2) \
        .contiguous()
    cmask = (kpos[None, None] <= pos[:, :, None])[:, None]

    def sdpa_chunk():
        return F.scaled_dot_product_attention(
            q6, lat_d, val_d, attn_mask=cmask, scale=sm_scale,
            enable_gqa=True)
    lib_err6 = (sdpa_chunk().transpose(1, 2).float() - p6).abs().max().item()
    # K6 runs its operations on bf16 tensor cores: the bound is their rate;
    # the f32 rate's bound (the first version's) stays beside it
    bnd = bound(chunk_bytes, chunk_flops, BF16_FLOPS)
    out.append(dict(name="latent_chunk_prefill", route="cuda",
                    source="src/repro_torch/kernels/csrc/"
                           "latent_chunk_prefill.cu",
                    replaces="src/repro/kernels/latent_chunk_prefill.py:150",
                    max_abs_err=max(err6, err6p),
                    ms=time_ms(lambda: ops.latent_chunk_prefill(
                        qlc, qrc, pos, lat, sc, table, **kw), iters=10),
                    plain_ms=time_ms(lambda: lc.latent_chunk_prefill_ref(
                        qlc, qrc, pos, lat, sc, table, **kw), iters=3,
                        warmup=1),
                    **bnd,
                    library_ms=time_ms(sdpa_chunk, iters=10),
                    library="F.scaled_dot_product_attention on pre-gathered "
                            "dequantized bf16 latents with a causal position "
                            f"mask, scale= given (max |lib - plain| "
                            f"{lib_err6:.3e})",
                    shape=f"B={B} S={S} H={H} R={R} dr={dr} ps={ps} "
                          f"NP={NP}"))
    # the kernel as the loaded library reports it, the blocks those of the
    # timed launch at this shape; the other instantiations' resources beside
    info = {f"R{r} dr{d} {'fp8' if f else 'bf16'}": lc.kernel_info(r, d, f, dev)
            for r, d in ((R, dr), (64, 32)) for f in (True, False)}
    k6 = info[f"R{R} dr{dr} {'fp8' if kw['opt_kv'] else 'bf16'}"]
    tc_flops = tc_pairs * (k6["q_terms"] * 2 * W + k6["p_terms"] * 2 * R)
    f32_ms = bound(chunk_bytes, chunk_flops, F32_FLOPS)["bound_ms"]
    out[-1].update(blocks=k6["last_blocks"],
                   rows_per_block=k6["rows_per_block"],
                   registers=k6["registers"], local_bytes=k6["local_bytes"])
    log(f"K6: {k6['last_blocks']} blocks of {k6['rows_per_block']} rows; "
        "registers / local bytes a thread " + ", ".join(
            f"{n} {v['registers']}/{v['local_bytes']}"
            for n, v in info.items()) +
        f"; the tensor cores execute {tc_flops / chunk_flops:.3f}x the "
        f"bound's operations ({k6['q_terms']} q terms, {k6['p_terms']} P' "
        f"terms); bound {bnd['bound_ms']:.4f} ms at the bf16 rate, "
        f"{f32_ms:.4f} ms at the f32 rate")
    rec["k6"] = dict(kernels=info, tc_ops_over_bound=tc_flops / chunk_flops,
                     bound_bf16_ms=bnd["bound_ms"], bound_f32_ms=f32_ms)
    # what K6's time is made of: the chunk lane apart from the three decode
    # lanes (each padded to the chunk's 512 rows of its one token)
    split = {}
    for key, lanes in (("chunk_lane_ms", slice(0, 1)),
                       ("decode_lanes_ms", slice(1, B))):
        split[key] = time_ms(lambda: ops.latent_chunk_prefill(
            qlc[lanes], qrc[lanes], pos[lanes], lat, sc, table[lanes], **kw),
            iters=10)
    log("K6 split: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    rec["k6_split"] = split
    return out


def flash_prefill_kernel_phase(torch, rec, time_ms):
    """K8 at the full-prompt path's shapes: 2 prompts of 2048 tokens,
    qwen3-4b's heads (Hq 32, Hkv 8, D 128)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S, Hq, Hkv, D = 2, 2048, 32, 8, 128
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
               for sh in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    k8 = ops.flash_prefill(q, k, v)
    p8 = fp.flash_prefill_ref(q, k, v)
    # control: each row's own key masked off (queries one position earlier)
    c8 = fp.flash_prefill_ref(q, k, v, q_offset=-1)
    torch.cuda.synchronize()
    r8, err8 = tol_ratio(k8, p8)
    rc8, errc8 = tol_ratio(k8, c8)
    log(f"K8 flash_prefill: max |kernel - plain| {err8:.3e} = {r8:.3f} of "
        f"the tolerance; control, one key masked off: {errc8:.3e} = "
        f"{rc8:.2f}")
    check(r8 <= 1, "K8 differs from its plain version")
    check(rc8 > 1, "the tolerance passes a one-key mask error in K8")
    rec["tolerance"].update(k8=r8, k8_control=rc8, k8_control_err=errc8)
    pairs = B * Hq * S * (S + 1) // 2                 # causal (row, key)
    bnd = bound(2 * B * S * Hq * D * 2 + 2 * B * S * Hkv * D * 2,
                pairs * D * 4, BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib_err = (sdpa().transpose(1, 2).float() - p8.float()).abs().max().item()
    return [dict(name="flash_prefill", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_prefill.cu",
                 replaces="src/repro/kernels/flash_prefill.py:84",
                 max_abs_err=err8,
                 ms=time_ms(lambda: ops.flash_prefill(q, k, v), iters=10),
                 plain_ms=time_ms(lambda: fp.flash_prefill_ref(q, k, v),
                                  iters=3, warmup=1),
                 **bnd,
                 library_ms=time_ms(sdpa, iters=10),
                 library="F.scaled_dot_product_attention(is_causal=True, "
                         f"enable_gqa=True) (max |lib - plain| "
                         f"{lib_err:.3e})",
                 shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D}")]


# --------------------------------------------------------------- engine --
# The kernels each serving path must launch: (4-lane engine, 1-lane engine)
ENGINE_KERNELS = {
    "qwen3-4b": (("kv_cache_write", "flash_chunk_prefill",
                  "paged_pool_decode_visits"), ("paged_pool_decode",)),
    "deepseek-v2-lite-16b": (("latent_chunk_prefill",
                              "paged_latent_decode_visits"),
                             ("paged_latent_decode",)),
}


def engine_prompts(cfg):
    """The engines' 8 requests: 300-700 prompt tokens, the first 4 sharing
    a 256-token prefix."""
    import numpy as np
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 256)
    lens = rng.integers(300, 701, 8)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                 n - 256)])
            if i < 4 else rng.integers(0, cfg.vocab_size, n)
            for i, n in enumerate(lens)]


def engine_phase(torch, rec, arch="qwen3-4b", keep_params=False):
    """``Engine.generate`` at full width and depth (8 greedy requests, 4
    lanes), then a one-lane engine at 4 layers. Returns (launches of the
    4-lane run, launches of the 1-lane run, the 4-lane engine's params if
    ``keep_params``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.kernels import cuda
    from repro_torch.serving import Engine, EngineConfig
    coopt = COOPT.replace(use_kernel=True)
    cfg = get_config(arch)
    need4, need1 = ENGINE_KERNELS[arch]
    key = "engine" if arch == "qwen3-4b" else f"engine_{arch}"
    prompts = engine_prompts(cfg)
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
    k1_by_kind = {"prefill": 0, "decode": 0}

    def checked(sb):
        n0 = cuda.LAUNCHES["kv_cache_write"]
        logits = run_model(sb)
        k1_by_kind[sb.kind] += cuda.LAUNCHES["kv_cache_write"] - n0
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
               launches=launches, k1_launches_by_step=k1_by_kind,
               logits_finite=all_finite,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    res["gib_allocated"] = torch.cuda.memory_allocated() / 2**30
    log(f"engine: {done}/{len(reqs)} finished, {st.generated_tokens} tokens "
        f"in {wall:.2f} s = {res['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{res['tpot_p50_s'] * 1e3:.2f} ms, prefix hit rate "
        f"{res['prefix_hit_rate']:.3f}, {steps} steps, "
        f"{res['gib_allocated']:.1f} GiB allocated, launches {launches}")
    check(done == len(reqs), "not every request finished")
    check(all_finite, "non-finite logits")
    for k in need4:
        check(launches[k] > 0, f"{k} never launched on the {arch} engine")
    rec[key] = res
    params = eng.params if keep_params else None
    del eng, run_model, checked
    gc.collect()                    # the sampler hook closes a cycle
    torch.cuda.empty_cache()

    # one lane, 4 layers: decode steps take the per-lane kernel
    cfg1 = cfg.replace(num_layers=4)
    eng1 = Engine(cfg1, coopt, EngineConfig(num_lanes=1, max_len=1024, seed=1),
                  device=DEV)
    cuda.reset_launches()
    outs = eng1.generate(prompts[:2], max_new_tokens=16)
    torch.cuda.synchronize()
    launches1 = dict(cuda.LAUNCHES)
    log(f"engine ({arch}, 1 lane, 4 layers): {[len(o) for o in outs]} tokens,"
        f" launches {launches1}")
    check(all(len(o) == 16 for o in outs), "one-lane engine did not finish")
    for k in need1:
        check(launches1[k] > 0, f"{k} never launched on the one-lane engine")
    rec[key + "_one_lane"] = dict(launches=launches1)
    del eng1
    torch.cuda.empty_cache()
    return launches, launches1, params


# ------------------------------------------------------- full prompt ----
def full_prompt_phase(torch, rec, params, arch="qwen3-4b", S=2048,
                      chunk=512):
    """``TransformerModel.prefill`` of 2 prompts of ``S`` tokens with no
    positions: the full-prompt path, K8 once per layer (K1 writes the
    pool). The same prompts chunked through K1/K3 (``chunk`` tokens a call)
    give the reference last-token logits. Both run with the bf16 pool
    (Opt-KV off), so both attend the same K/V values and the comparison
    holds the attention kernels, not the FP8 rounding."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.kernels import cuda
    from repro_torch.models import get_model
    cfg = get_config(arch)
    model = get_model(cfg)
    coopt = COOPT.replace(use_kernel=True, opt_kv=False)
    B = 2
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEV)
    cache = model.init_cache(B, S, coopt, device=DEV)
    cuda.reset_launches()
    t0 = time.perf_counter()
    full, _ = model.prefill(params, {"tokens": toks}, cache, coopt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    cache = model.init_cache(B, S, coopt, device=DEV)
    for c0 in range(0, S, chunk):
        pos = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                           device=DEV)[None].expand(B, chunk).contiguous()
        chunked, _ = model.prefill(params, {"tokens": toks[:, c0:c0 + chunk],
                                            "positions": pos}, cache, coopt)
    torch.cuda.synchronize()
    diff = (full.float() - chunked.float()).abs().max().item()
    scale = chunked.float().abs().max().item()
    same_top = (full.argmax(-1) == chunked.argmax(-1)).all().item()
    finite = bool(torch.isfinite(full).all().item())
    log(f"full prompt ({arch}, {B} x {S} tokens): {wall:.2f} s, launches "
        f"{launches}; last-token logits vs {chunk}-token chunks: max |diff| "
        f"{diff:.4f} (|logit| max {scale:.2f}, atol {LOGIT_ATOL}), "
        f"bit-equal {torch.equal(full, chunked)}, argmax equal {same_top}")
    rec["full_prompt"] = dict(arch=arch, B=B, S=S, wall_s=wall,
                              launches=launches, max_logit_diff=diff,
                              logit_max=scale, argmax_equal=same_top,
                              bit_equal=torch.equal(full, chunked))
    check(finite, "non-finite full-prompt logits")
    check(launches["flash_prefill"] == cfg.num_layers,
          "flash_prefill did not launch once per layer")
    check(diff <= LOGIT_ATOL, "full-prompt and chunked logits differ")
    return launches


# ------------------------------------------------------- async engine ----
def _timed(fn, kind_of, steps):
    """``fn(sb, ...)`` with its host seconds: appends (step kind, host s)
    to ``steps``."""
    def timed(sb, *a):
        t0 = time.perf_counter()
        out = fn(sb, *a)
        steps.append((kind_of(sb), time.perf_counter() - t0))
        return out
    return timed


def _step_kind(sb):
    return "mixed" if sb.tp and sb.td else "prefill" if sb.tp else "decode"


def _host_steps(steps):
    """By step kind: the steps and the host's ms in the timed call (the
    sync engine's model call, which launches the step op by op; the async
    engine's dispatch: build the inputs, copy them, replay)."""
    out = {}
    for kind, host in steps:
        r = out.setdefault(kind, dict(steps=0, host_ms=0.0))
        r["steps"] += 1
        r["host_ms"] += host * 1e3
    return out


def _fmt_steps(t):
    return ", ".join(f"{k} {r['steps']} x {r['host_ms'] / r['steps']:.2f} ms"
                     for k, r in sorted(t.items()))


# kernel-name groups of a step's profile (cuBLAS names its Hopper GEMMs
# nvjet_*, sm90_xmma_*, or cutlass_*)
KERNEL_GROUPS = (("K1", ("kv_write",)), ("K3", ("chunk_kernel",)),
                 ("K2/K4", ("decode_kernel",)),
                 ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass")))
# the CUDA kernel each wrapper launches, by its name in a trace, and the
# ``LAUNCHES`` keys that count it
TRACE_KERNELS = (
    ("kv_write_kernel", ("kv_cache_write",)),
    ("chunk_kernel", ("flash_chunk_prefill", "flash_chunk_prefill_state")),
    ("decode_kernel", ("paged_pool_decode", "paged_pool_decode_visits",
                       "paged_pool_decode_state",
                       "paged_pool_decode_visits_state")),
    ("latent_chunk_kernel", ("latent_chunk_prefill",
                             "latent_chunk_prefill_state")),
    ("latent_decode_kernel", ("paged_latent_decode",
                              "paged_latent_decode_visits",
                              "paged_latent_decode_state",
                              "paged_latent_decode_visits_state")),
    ("prefill_kernel", ("flash_prefill",)))
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_PAD = 64          # spin kernels on each side of a traced run,
TRACE_PAD_S = 0.05      # then the host's wait before going on


def _device_trace(torch, fn):
    """Run ``fn()`` under ``torch.profiler`` (the CUDA activity) and
    return (its wall seconds, the card's activities as (start us, end us,
    category, name, correlation id) sorted by start): kernels, copies and
    memsets, those of graph replays included (the kernels of one replay
    share its launch's correlation id). A trace can leave a few of its
    first and last activities unrecorded, so ``TRACE_PAD`` spin kernels
    and a ``TRACE_PAD_S`` wait come before and after ``fn``, outside its
    wall time; the spins are left out of the result. The trace passes through a file in ``OUT``, removed
    once read."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        if DEV == "cuda":
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
    acts = [ProfilerActivity.CUDA if DEV == "cuda" else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        pad()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pad()
    path = OUT / "trace.tmp.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    return wall, sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
         str(e["cat"]).lower(), e["name"],
         e.get("args", {}).get("correlation")) for e in events
        if e.get("ph") == "X" and "spin_kernel" not in e["name"]
        and str(e.get("cat", "")).lower() in DEVICE_ACTIVITIES)


def _busy_us(acts):
    """The union of the activities' intervals, us: the card's busy time."""
    busy, end = 0.0, float("-inf")
    for s, e, *_ in acts:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _trace_launches(acts):
    """The trace's kernels of each ``TRACE_KERNELS`` entry, keyed by its
    ``LAUNCHES`` keys joined with '+'."""
    import re
    out = {}
    for name, keys in TRACE_KERNELS:
        pat = re.compile(rf"(?<![A-Za-z_]){name}(?![a-z0-9_])")
        out["+".join(keys)] = sum(1 for _, _, c, n, _ in acts
                                  if c == "kernel" and pat.search(n))
    return out


def _counted(launches):
    """``launches`` (wrapper counts) in ``_trace_launches``'s keys."""
    return {"+".join(keys): sum(launches.get(k, 0) for k in keys)
            for _, keys in TRACE_KERNELS}


def _card_share(acts, wall, launches, what):
    """A traced served run: the card's busy ms (the union of its kernels,
    copies and memsets) and idle share of the run's wall time. The
    kernels the trace shows must be the launches the wrappers counted."""
    seen = _trace_launches(acts)
    if seen != _counted(launches):      # each launch's share, for the record
        by_launch = {}
        for a in acts:
            by_launch.setdefault(a[4], []).append(a)
        (OUT / "trace_mismatch.json").write_text(json.dumps({what: [
            (g[0][0] - acts[0][0], len(g), _trace_launches(g))
            for g in by_launch.values()]}))
    check(seen == _counted(launches), f"{what}: the trace shows kernels "
          f"{seen}, the wrappers counted {_counted(launches)}")
    busy = _busy_us(acts) / 1e3
    return dict(wall_s=wall, busy_ms=busy, idle_share=1 - busy / (wall * 1e3),
                kernels=sum(a[2] == "kernel" for a in acts),
                trace_launches=seen)


def _replay_ms(torch, runner, reps=10):
    """A graph replay's card time: ``reps`` replays of ``runner`` back to
    back between two CUDA events, after one more. Run on an idle engine:
    it rewrites the runner's last step."""
    runner.run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        runner.run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _step_profile(torch, eng, runner, reps=10):
    """Where a replayed step's card time goes: ``reps`` replays of
    ``runner``'s graph timed with CUDA events, then ``reps`` more under
    ``_device_trace``, between two more that pad the trace. From the
    trace, per replay: the graph's kernels by ``KERNEL_GROUPS`` ("other":
    norms, rope, activations, gathers, copies, sampling) and their device
    ms, the span from its first kernel's start
    to its last one's end, and the gaps in that span that no kernel
    covers (a replay's activities: those of its launch's correlation id).
    Each replay must run the kernels its capture counted
    (``runner.launches``). Run on an idle engine: it rewrites the
    runner's last step."""
    replay = _replay_ms(torch, runner, reps)
    _, acts = _device_trace(torch, lambda: [runner.run()
                                            for _ in range(reps + 2)])
    by_launch = {}
    for a in acts:
        by_launch.setdefault(a[4], []).append(a)
    # the first and last replays only pad the window
    per = list(by_launch.values())[1:-1]
    n = len(per[0]) if per else 0
    check(len(per) == reps and all(len(p) == n > 0 for p in per),
          f"the trace of {reps} replays holds {[len(p) for p in per]} "
          "activities a launch")
    for p in per:
        check(_trace_launches(p) == _counted(runner.launches),
              f"a replay ran kernels {_trace_launches(p)}, its capture "
              f"counted {_counted(runner.launches)}")
    groups = {}
    for s, e, c, name, _ in (a for p in per for a in p):
        name = name.lower()
        g = "other" if c == "kernel" else "copies"
        g = next((g for g, keys in KERNEL_GROUPS
                  if c == "kernel" and any(k in name for k in keys)), g)
        r = groups.setdefault(g, dict(kernels=0, ms=0.0))
        r["kernels"] += 1
        r["ms"] += (e - s) / 1e3
    for r in groups.values():           # a replay's share
        r["kernels"] //= reps
        r["ms"] /= reps
    span = sum(max(a[1] for a in p) - p[0][0] for p in per) / reps / 1e3
    busy = sum(_busy_us(p) for p in per) / reps / 1e3
    return dict(replay_ms=replay, kernels=n, span_ms=span, busy_ms=busy,
                gaps_ms=span - busy, groups=groups)


def _served(torch, serve, traced):
    """Run ``serve()``: (wall seconds, None), or with ``traced`` under
    ``_device_trace``: (wall seconds, the card's activities)."""
    if traced:
        return _device_trace(torch, serve)
    t0 = time.perf_counter()
    serve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, None


def _sync_recorded(torch, eng, prompts, max_new, steps=None, traced=False):
    """``Engine.generate`` keeping every emitted token's logits row on the
    card (no extra host sync); with ``steps``, each step's model call is
    timed on the host (``_timed``); ``traced``: run under
    ``_device_trace``. Returns (requests, {request index: [(token, logits
    row)]}, wall seconds, the run's launches, the trace or None)."""
    from repro_torch.kernels import cuda
    sample, post = eng._sample, eng._postprocess
    if steps is not None:
        eng._run_model = _timed(eng._run_model, _step_kind, steps)
    rows, last, got = {}, {}, {}

    def keep(logits):
        last["logits"] = logits.float()
        return sample(logits)

    def note(sb, toks, now):
        # a sample's index: (lane,), or (row, slot) in a packed step
        for req, _, idx in sb.samples:
            rows.setdefault(req.req_id - 1000, []).append(
                (int(toks[idx]), last["logits"][idx]))
        return post(sb, toks, now)

    def serve():
        cuda.reset_launches()
        got["reqs"] = eng.generate(prompts, max_new_tokens=max_new,
                                   return_requests=True)
        torch.cuda.synchronize()
        got["launches"] = dict(cuda.LAUNCHES)
    eng._sample, eng._postprocess = keep, note
    wall, acts = _served(torch, serve, traced)
    eng._sample, eng._postprocess = sample, post
    return got["reqs"], rows, wall, got["launches"], acts


def _async_run(torch, eng, prompts, max_new, depth=None, steps=None,
               traced=False, kind_of=None):
    """``AsyncEngine`` at pipeline depth ``depth`` (None: the default)
    with its runners built, the requests submitted at once; with
    ``steps``, each step's dispatch is timed on the host (``_timed``,
    by ``kind_of(step)``, ``_step_kind`` by default);
    ``traced``: the served run under ``_device_trace``. Returns
    (frontend, streams, warmup seconds, wall seconds, the launches of the
    served run: every one a graph replay's, the trace or None)."""
    from repro_torch.kernels import cuda
    from repro_torch.serving import AsyncEngine
    from repro_torch.serving.frontend import PIPELINE_DEPTH
    t0 = time.perf_counter()
    fe = AsyncEngine(eng, pipeline_depth=depth or PIPELINE_DEPTH,
                     warmup=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if steps is not None:
        eng._dispatch_async = _timed(eng._dispatch_async,
                                     kind_of or _step_kind, steps)
    got = {}

    def serve():
        cuda.reset_launches()
        got["streams"] = [fe.submit(p, max_new_tokens=max_new)
                          for p in prompts]
        fe.run_until_idle()
        torch.cuda.synchronize()
        got["launches"] = dict(cuda.LAUNCHES)
    wall, acts = _served(torch, serve, traced)
    fe.close()
    return fe, got["streams"], warm_s, wall, got["launches"], acts


def _request_index(req):
    """A request's index in its prompt list: ``Engine.generate`` numbers
    its requests 1000 + i, ``AsyncEngine.submit`` i."""
    return req.req_id % 1000


def _record_layouts(eng):
    """Record, for each request (``_request_index``), the layout of each of
    its prefill chunks as the engine builds its steps: (start, tokens, the
    step's columns) and, in a packed step, every chunk of the step (rows
    are packed from them). A MoE layer's expert capacity is per row
    (``models/moe.py``), so which of a row's tokens it drops depends on
    exactly this; the async schedule frees a lane a step later than the
    sync loop, so a prompt can be split into other chunks. Returns the
    dict it fills."""
    build, lay = eng._build_step, {}

    def recorded(plan, device_feed=False):
        sb = build(plan, device_feed)
        if plan.prefill:
            S = sb.batch["tokens"].shape[1]
            step = tuple(sorted((_request_index(c.req), c.start, c.n)
                                for c in plan.prefill)) \
                if sb.kind == "packed" else ()
            for c in plan.prefill:
                lay.setdefault(_request_index(c.req), []).append(
                    (c.start, c.n, S, step))
        return sb
    eng._build_step = recorded
    return lay


def _partings(torch, rows, outs, what):
    """Where each request's async tokens part from the reference run's
    (``rows``): allowed only at a near-tie of the reference logits (best
    two within NEAR_TIE, the async token among them). Returns the
    partings."""
    parted = []
    for i, seq in sorted(rows.items()):
        mine = outs[i]
        check(len(mine) == len(seq), f"{what}: request {i} emitted "
              f"{len(mine)} tokens, the reference run {len(seq)}")
        for j, (tok, row) in enumerate(seq):
            if mine[j] == tok:
                continue
            top = row.topk(2).values
            gap = (top[0] - top[1]).item()
            near = gap <= NEAR_TIE and \
                row[mine[j]].item() >= top[0].item() - NEAR_TIE
            parted.append(dict(request=i, token=j, reference=tok,
                               async_=mine[j], gap=gap, near_tie=near))
            log(f"  {what}: request {i} parts at token {j} (reference "
                f"{tok}, async {mine[j]}; reference logits' best two "
                f"{gap:.4f} apart)")
            check(near, f"{what}: request {i} parts from the reference run "
                  f"at token {j} without a near-tie")
            break
    return parted


def _leaf_parts(leaf):
    """A cache leaf's tensors: a ShardedPool's shards, else the leaf."""
    return getattr(leaf, "shards", (leaf,))


def _leaf_clone(leaf):
    """A copy of a cache leaf (a ShardedPool shard by shard)."""
    if hasattr(leaf, "shards"):
        return type(leaf)([t.clone() for t in leaf.shards], leaf.pages_dim)
    return leaf.clone()


def _record_steps(eng):
    """Record every step the async pipeline dispatches, in order: (kind,
    its host inputs, each sample's request index and index into the
    step's tokens, and for a recurrent model the state its first chunks'
    lanes were reset or restored to); at the first dispatch, also the
    engine's pool, batch-major leaves and lane feed. ``_eager_rows``
    replays them. Returns (the steps, the starting state), the lists it
    fills."""
    import numpy as np
    from repro_torch.serving.engine import _host_inputs
    dispatch, steps, state = eng._dispatch_async, [], {}

    def recorded(sb, slot=None):
        if not steps:
            state.update(cache={k: _leaf_clone(v)
                                for k, v in eng.cache.items()},
                         lane_tok=eng.lane_tok.clone())
        # the resets and restores _build_step enqueued for this step
        lanes = {c.req.lane for c in sb.plan.prefill if c.first}
        resets = {(leaf, lane): eng.cache[leaf][
            eng._lane_index(leaf, lane)].clone()
            for leaf in eng._rec_leaves for lane in lanes}
        steps.append((sb.kind, {k: np.array(v, copy=True)
                                for k, v in _host_inputs(sb).items()},
                      [(_request_index(r), idx) for r, _, idx in sb.samples],
                      resets))
        return dispatch(sb, slot)
    eng._dispatch_async = recorded
    return steps, state


def _eager_rows(torch, eng, recorded, max_new):
    """The async run's own steps (``_record_steps``) replayed eagerly
    (``Engine._async_step``, no graph) from its starting state, in
    dispatch order, each after the lane resets and restores of its first
    chunks: the reference with the async run's chunk and row layout.
    Returns {request index: [(token, logits row)]}, each request's first
    ``max_new`` samples (the pipeline's overrun samples dropped, as at
    emission)."""
    steps, state = recorded
    for k, v in state["cache"].items():
        for dst, src in zip(_leaf_parts(eng.cache[k]), _leaf_parts(v)):
            dst.copy_(src)
    eng.lane_tok.copy_(state["lane_tok"])
    rows = {}
    for kind, host, samples, resets in steps:
        for (leaf, lane), v in resets.items():
            eng.cache[leaf][eng._lane_index(leaf, lane)].copy_(v)
        inp = {k: torch.as_tensor(v, device=eng.device)
               for k, v in host.items()}
        logits, toks = eng._async_step(kind, inp)
        check(toks is not None, "the eager replay needs greedy sampling")
        logits, toks = logits.float(), toks.cpu().numpy()
        for i, idx in samples:
            rows.setdefault(i, []).append((int(toks[idx]), logits[idx]))
    return {i: seq[:max_new] for i, seq in rows.items()}


def _moe_partings(torch, eng, recorded, rows, layouts, outs, max_new, what):
    """A MoE model's async tokens, held like for like. A layer's expert
    capacity is per row (``models/moe.py``), so which tokens it drops
    depends on how the prompts were cut into chunks and rows, and the
    async schedule (it frees a lane a step later than the sync loop) can
    cut a prompt otherwise. So every request is held to the async run's
    own steps replayed eagerly (``_eager_rows``: the same layout, no
    graph), and each request whose layout (``_record_layouts``: the sync
    run's, then the async run's) did not move is also held to the sync
    run (``rows``); both under the near-tie rule, no request excused.
    Returns a summary."""
    moved = sorted(i for i in outs if layouts[0].get(i) != layouts[1].get(i))
    eager = _eager_rows(torch, eng, recorded, max_new)
    check(sorted(eager) == sorted(outs), f"{what}: the eager replay served "
          f"requests {sorted(eager)}, the async run {sorted(outs)}")
    res = dict(
        parted_vs_replay=_partings(torch, eager, outs,
                                   f"{what} vs its steps replayed eagerly"),
        parted_vs_sync=_partings(
            torch, {i: s for i, s in rows.items() if i not in moved}, outs,
            f"{what} vs sync"),
        layout_moved=moved, excused=0)
    log(f"{what}: {len(outs)} requests held to the eager replay of the "
        f"async steps, {len(res['parted_vs_replay'])} parted at a near-tie;"
        f" {len(outs) - len(moved)} (layout unmoved) held to the sync run, "
        f"{len(res['parted_vs_sync'])} parted at a near-tie; {len(moved)} "
        f"prefilled in another layout than the sync run's {moved}; 0 "
        "excused")
    return res


def _engine_summary(st, wall):
    steps = st.prefill_calls + st.decode_steps - st.mixed_steps
    return dict(generated=st.generated_tokens, wall_s=wall,
                tokens_per_s=st.generated_tokens / wall,
                ttft_p50_s=st.ttft(50), ttft_p95_s=st.ttft(95),
                tpot_p50_s=st.tpot(50), tpot_p95_s=st.tpot(95), steps=steps,
                prefill_calls=st.prefill_calls, decode_steps=st.decode_steps,
                mixed_steps=st.mixed_steps, packed_steps=st.packed_steps,
                packed_rows_saved=st.packed_rows_saved)


def _fmt(r):
    return (f"{r['tokens_per_s']:.1f} tok/s, TTFT p50/p95 "
            f"{r['ttft_p50_s'] * 1e3:.1f}/{r['ttft_p95_s'] * 1e3:.1f} ms, "
            f"TPOT p50/p95 {r['tpot_p50_s'] * 1e3:.2f}/"
            f"{r['tpot_p95_s'] * 1e3:.2f} ms, {r['steps']} steps")


def _replay_vs_eager(torch, eng, sb):
    """Step ``sb`` eagerly (the runner's body on uploaded inputs) and by its
    runner's replay, from the same pool and lane-feed state. Returns (max
    |logit difference|, pool bytes that differ, lane feeds equal, the
    replay's tokens); the engine is left after the replay's step."""
    from repro_torch.serving.engine import _host_inputs
    host = _host_inputs(sb)
    before = {k: v.clone() for k, v in eng.cache.items()}
    feed = eng.lane_tok.clone()
    inp = {k: torch.as_tensor(v, device=eng.device) for k, v in host.items()}
    logits, _ = eng._async_step(sb.kind, inp)
    eager = logits.float().clone()
    eager_pool = {k: v.clone() for k, v in eng.cache.items()}
    eager_feed = eng.lane_tok.clone()
    for k, v in before.items():
        eng.cache[k].copy_(v)
    eng.lane_tok.copy_(feed)
    runner = eng._runners[eng._async_key(sb.kind, sb.batch)]
    check(runner.graph is not None or DEV == "cpu",
          "a runner without a graph on the card")
    runner.load(host)
    logits, toks = runner.run()
    torch.cuda.synchronize()
    diff = (logits.float() - eager).abs().max().item()
    nbytes = sum(int((eng.cache[k].view(torch.uint8)
                      != v.view(torch.uint8)).sum().item())
                 for k, v in eager_pool.items())
    return diff, nbytes, bool(torch.equal(eng.lane_tok, eager_feed)), toks


def _runner(eng, kind, S):
    """The engine's step runner of ``kind`` at ``S`` tokens a lane."""
    tok = "token" if kind == "decode" else "tokens"
    return next(r for r in eng._runners.values()
                if r.kind == kind and r.inputs[tok].shape[1] == S)


def _replay_checks(torch, eng, prompts, want=("decode", "mixed")):
    """Serve ``prompts`` one async step at a time on the calling thread;
    the first step of each kind in ``want`` runs eagerly and by replay
    from the same state. Kinds: "decode" (decode-only), "mixed" (prefill
    chunks beside decode lanes), "prefill", and "packed" (packed rows, one
    row holding several prompts)."""
    import numpy as np
    from repro_torch.serving import Request
    for i, p in enumerate(prompts):      # lanes free at different steps
        eng.add_request(Request(req_id=i, prompt=np.asarray(p, np.int32),
                                max_new_tokens=4 + 3 * i,
                                arrival_time=float(i)))
    out = {}
    while eng.scheduler.has_work:
        plan = eng.scheduler.schedule_step()
        if plan.empty:
            continue
        sb = eng._build_step(plan, device_feed=True)
        kind = "decode" if not plan.prefill else \
            "mixed" if plan.decode else "prefill"
        if sb.kind == "packed":
            kind = ("packed" if sb.batch["seg_q"].max() > 0
                    else "packed, a prompt a row")
        if kind in want and kind not in out:
            diff, nbytes, feed, toks = _replay_vs_eager(torch, eng, sb)
            out[kind] = dict(max_logit_diff=diff, pool_bytes_differ=nbytes,
                             lane_feed_equal=feed)
        else:
            toks = eng._dispatch_async(sb)
        eng._note_executed(sb)
        eng._postprocess(sb, toks.cpu().numpy(), time.perf_counter())
    check(set(out) == set(want),
          f"replay against eager saw only {sorted(out)} steps")
    return out


def async_phase(torch, rec, params, arch="qwen3-4b",
                mla_arch="deepseek-v2-lite-16b"):
    """``AsyncEngine`` (the async pipeline, one CUDA graph a step shape)
    against ``Engine.generate`` in the same call: qwen3-4b at full width
    and depth on ``params`` (the engine phase's settings and requests),
    async at the default pipeline depth and at depth 1 (the same graphs,
    host and card taking turns), then each of the three served again
    under a trace for the card's busy time; one decode and one mixed step
    replayed against the eager body from the same pool state, and two
    steps' replays traced; ``mla_arch`` at 4 layers (1 dense + 3 MoE);
    faults (a step fault, a cancel) and temperature 0.8 at 4 layers of
    ``arch``. Returns the launches of the two served async runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.serving import (Engine, EngineConfig, FaultInjector,
                                     FaultPlan, FinishReason, SamplingParams)
    from repro_torch.serving.faults import FaultInjected
    from repro_torch.serving.frontend import PIPELINE_DEPTH
    # the profiler's CUDA tracing starts up before any graph is captured
    _device_trace(torch, lambda: torch.ones(1, device=DEV).add_(1))
    coopt = COOPT.replace(use_kernel=True)
    cfg = get_config(arch)
    ecfg = EngineConfig(num_lanes=4, max_len=1024, seed=0)
    prompts = engine_prompts(cfg)
    L = cfg.num_layers
    res = {}

    # qwen3-4b, full width and depth: sync, then async at each depth
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    steps = []
    reqs, rows, wall, _, _ = _sync_recorded(torch, eng, prompts, 32, steps)
    res["sync"] = _engine_summary(eng.stats, wall)
    res["sync"]["host_steps"] = _host_steps(steps)
    check(all(len(r.output) == 32 for r in reqs), "sync run unfinished")
    log(f"sync ({arch}, {L} layers): {_fmt(res['sync'])}; host ms a step "
        f"{_fmt_steps(res['sync']['host_steps'])}")
    del eng, reqs
    for depth in (PIPELINE_DEPTH, 1):
        key = "async" if depth == PIPELINE_DEPTH else f"async_depth{depth}"
        eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
        steps = []
        fe, streams, warm_s, wall, launches, _ = _async_run(
            torch, eng, prompts, 32, depth, steps)
        a = res[key] = _engine_summary(eng.stats, wall)
        a.update(depth=depth, host_steps=_host_steps(steps),
                 runners=fe.warmed_shapes, warmup_s=warm_s,
                 graph_pool_gib=eng.graph_pool_bytes / 2**30,
                 aot_misses=eng.aot_misses, launches=launches,
                 runner_launches={
                     r.kind if r.kind == "decode" else
                     f"prefill {r.inputs['tokens'].shape[1]}": r.launches
                     for r in eng._runners.values()})
        outs = {i: list(h.req.output) for i, h in enumerate(streams)}
        a["parted"] = _partings(torch, rows, outs, f"{arch} {key}")
        log(f"{key} ({arch}, {L} layers, pipeline depth {depth}): "
            f"{fe.warmed_shapes} runners captured in {warm_s:.2f} s, graph "
            f"pool {a['graph_pool_gib']:.3f} GiB, {_fmt(a)}, aot_misses "
            f"{eng.aot_misses}, launches {launches}; host ms a dispatch "
            f"{_fmt_steps(a['host_steps'])}")
        log(f"  greedy tokens: {len(outs) - len(a['parted'])}/{len(outs)} "
            f"requests equal to the sync run's, {len(a['parted'])} parted "
            "at a near-tie")
        check(fe.warmed_shapes == 1 + len(ecfg.prefill_buckets),
              "not one runner a lattice shape")
        check(eng.aot_misses == 0, "the async run missed a runner")
        check(all(h.finish_reason is FinishReason.FINISHED
                  for h in streams), "async run unfinished")
        check(all(0 <= t < cfg.vocab_size for o in outs.values()
                  for t in o), "a token outside the vocabulary")
        st = eng.stats
        want = {"kv_cache_write": L * a["steps"],
                "flash_chunk_prefill": L * st.prefill_calls,
                "paged_pool_decode_visits": L * (st.decode_steps
                                                 - st.mixed_steps)}
        for k, n in want.items():
            check(launches[k] == n > 0, f"{k}: {launches[k]} launches "
                  f"through replays, {n} expected")
        if depth != PIPELINE_DEPTH:
            del eng, fe
            continue
        served = launches

        # replay against eager, one decode and one mixed step
        res["replay_vs_eager"] = r = _replay_checks(torch, eng, prompts[:6])
        log(f"replay vs eager ({arch}): " + ", ".join(
            f"{k} step: max |logit diff| {v['max_logit_diff']}, pool bytes "
            f"differing {v['pool_bytes_differ']}, lane feed equal "
            f"{v['lane_feed_equal']}" for k, v in r.items()))
        for k, v in r.items():
            check(v["max_logit_diff"] == 0 and v["pool_bytes_differ"] == 0
                  and v["lane_feed_equal"],
                  f"the {k} step's replay differs from its eager run")
        prof = res["step_profile"] = {
            name: _step_profile(torch, eng, runner)
            for name, runner in (("decode", _runner(eng, "decode", 1)),
                                 ("prefill 512",
                                  _runner(eng, "prefill", 512)))}
        for name, p in prof.items():
            log(f"  {name} step: replay {p['replay_ms']:.3f} ms (events); "
                f"traced: {p['kernels']} kernels over a {p['span_ms']:.3f}"
                f" ms span, busy {p['busy_ms']:.3f}, gaps "
                f"{p['gaps_ms']:.3f} ms (" + ", ".join(
                    f"{g} {v['kernels']:.0f} x -> {v['ms']:.3f} ms"
                    for g, v in sorted(p["groups"].items())) + ")")
        del eng, fe

    # the card's busy time in each served run, from a trace of it served
    # again: the trace's kernels must be the launches counted
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    _, _, wall, launches, acts = _sync_recorded(torch, eng, prompts, 32,
                                                traced=True)
    res["sync"]["trace"] = _card_share(acts, wall, launches, "sync")
    del eng, acts, rows
    for depth in (PIPELINE_DEPTH, 1):
        key = "async" if depth == PIPELINE_DEPTH else f"async_depth{depth}"
        eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
        fe, _, _, wall, launches, acts = _async_run(
            torch, eng, prompts, 32, depth, traced=True)
        res[key]["trace"] = _card_share(acts, wall, launches, key)
        del eng, fe, acts
    for key in ("sync", "async", "async_depth1"):
        # the trace slows the host, so the busy time is also set against
        # the wall of the untraced run (derived from two runs)
        t = res[key]["trace"]
        t["idle_share_untraced"] = \
            1 - t["busy_ms"] / (res[key]["wall_s"] * 1e3)
        log(f"traced {key}: the card busy {t['busy_ms']:.1f} ms of "
            f"{t['wall_s'] * 1e3:.1f} ms wall (idle {t['idle_share']:.1%}; "
            f"of the untraced run's {res[key]['wall_s'] * 1e3:.1f} ms: "
            f"{t['idle_share_untraced']:.1%}), {t['kernels']} kernels; "
            f"trace launches {t['trace_launches']} = counted")
    torch.cuda.empty_cache()

    # MLA at 4 layers (1 dense + 3 MoE), full width: K6, K7 and the
    # latent write replayed
    mcfg = get_config(mla_arch).replace(num_layers=4)
    meng = Engine(mcfg, coopt, ecfg, device=DEV)
    mparams = meng.params
    mprompts = engine_prompts(mcfg)
    slay = _record_layouts(meng)
    _, rows, wall, _, _ = _sync_recorded(torch, meng, mprompts, 32)
    res["mla_sync"] = _engine_summary(meng.stats, wall)
    del meng
    meng = Engine(mcfg, coopt, ecfg, params=mparams, device=DEV)
    alay = _record_layouts(meng)
    recorded = _record_steps(meng)
    fe, streams, warm_s, wall, mlaunches, _ = _async_run(
        torch, meng, mprompts, 32)
    m = res["mla_async"] = _engine_summary(meng.stats, wall)
    m.update(runners=fe.warmed_shapes, warmup_s=warm_s,
             aot_misses=meng.aot_misses, launches=mlaunches)
    log(f"async ({mla_arch}, 4 layers): {_fmt(m)}, aot_misses "
        f"{meng.aot_misses}, launches {mlaunches}; sync "
        f"{_fmt(res['mla_sync'])}")
    outs = {i: list(h.req.output) for i, h in enumerate(streams)}
    m.update(_moe_partings(torch, meng, recorded, rows, (slay, alay), outs,
                           32, mla_arch))
    check(meng.aot_misses == 0, "the MLA async run missed a runner")
    for k in ("latent_chunk_prefill", "paged_latent_decode_visits"):
        check(mlaunches[k] > 0, f"{k} never replayed on the MLA async run")
    del meng, fe, recorded
    meng = Engine(mcfg, coopt, ecfg, params=mparams, device=DEV)
    _, _, _, wall, launches, acts = _async_run(torch, meng, mprompts, 32,
                                               traced=True)
    m["trace"] = _card_share(acts, wall, launches, f"{mla_arch} async")
    log(f"traced {mla_arch} async: the card busy {m['trace']['busy_ms']:.1f}"
        f" ms of {wall * 1e3:.1f} ms wall; trace launches "
        f"{m['trace']['trace_launches']} = counted")
    del meng, mparams, rows, acts
    torch.cuda.empty_cache()

    # faults and sampling at 4 layers of the dense model
    cfg4 = cfg.replace(num_layers=4)
    eng = Engine(cfg4, coopt, ecfg, device=DEV)
    inj = FaultInjector(FaultPlan(raise_at_step=3)).install(eng)
    fe, streams, *_ = _async_run(torch, eng, prompts[:4], 16)
    eng._update_pool_stats()
    res["fault"] = dict(
        reasons=[h.finish_reason.value for h in streams],
        errors=[type(h.error).__name__ for h in streams],
        audit=eng.scheduler.manager.audit(),
        pages_in_use=eng.stats.pages_in_use, steps=inj.steps)
    log(f"faults ({arch}, 4 layers): raise_at_step 3 -> {res['fault']}")
    check(all(h.finish_reason is FinishReason.ERROR
              and isinstance(h.error, FaultInjected) for h in streams),
          "a stream did not close with the injected ERROR")
    check(res["fault"]["audit"] == [] and eng.stats.pages_in_use == 0,
          "the step fault leaked pool pages")

    from repro_torch.serving import AsyncEngine
    eng = Engine(cfg4, coopt, ecfg, params=eng.params, device=DEV)
    fe = AsyncEngine(eng, warmup=True)
    victim = fe.submit(prompts[0], max_new_tokens=64)
    others = [fe.submit(p, max_new_tokens=12) for p in prompts[1:3]]
    for _ in range(200):
        fe._loop_once()
        if victim.req.output:
            break
    fe.cancel(victim)
    fe.run_until_idle()
    fe.close()
    eng._update_pool_stats()
    res["cancel"] = dict(victim=victim.finish_reason.value,
                         victim_tokens=len(victim.req.output),
                         others=[h.finish_reason.value for h in others],
                         audit=eng.scheduler.manager.audit(),
                         pages_in_use=eng.stats.pages_in_use)
    log(f"cancel ({arch}, 4 layers): {res['cancel']}")
    check(victim.finish_reason is FinishReason.CANCELLED
          and 0 < len(victim.req.output) < 64, "the cancel did not land")
    check(all(h.finish_reason is FinishReason.FINISHED for h in others),
          "a request beside the cancelled one did not finish")
    check(res["cancel"]["audit"] == [] and eng.stats.pages_in_use == 0,
          "the cancel leaked pool pages")

    teng = Engine(cfg4, coopt, EngineConfig(
        num_lanes=4, max_len=1024, seed=0,
        sampling=SamplingParams(temperature=0.8)), params=eng.params,
        device=DEV)
    fe, streams, *_ = _async_run(torch, teng, prompts[:4], 8)
    toks = [t for h in streams for t in h.req.output]
    res["temperature"] = dict(tokens=len(toks), aot_misses=teng.aot_misses,
                              first=[list(h.req.output[:4]) for h in streams])
    log(f"temperature 0.8 ({arch}, 4 layers): {res['temperature']}")
    check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
          "sampled tokens missing or outside the vocabulary")
    check(teng.aot_misses == 0, "the sampled run missed a runner")
    rec["async"] = res
    del eng, teng, fe
    torch.cuda.empty_cache()
    return served, mlaunches


# ------------------------------------------------------------ packing ----
# The packed phase's models: (arch, layers or None for full depth, new
# tokens, requests). yi-34b and deepseek-67b at full depth would need ~64
# and ~126 GiB of bf16 weights, so they run at 4 layers.
PACKED_DENSE = (("llama13b-gptq", None, 16, 12), ("yi-34b", 4, 8, 4),
                ("deepseek-67b", 4, 8, 4))


def packed_prompts(cfg, n=12):
    """The packed phase's requests, from a seed, in waves of 4 (a wave
    prefills in one step of the 512-token budget and finishes together,
    so the next wave is admitted together): a long prompt of 150-240
    tokens and three short ones of 40-72, which share a row of the
    256-token bucket beside it. The long prompts and the second wave's
    first short one (72 tokens) share a 64-token prefix (one page)."""
    import numpy as np
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 64)
    out = []
    for i in range(n):
        if i % 4 == 0 or i == 5:
            m = 72 if i == 5 else int(rng.integers(150, 241))
            out.append(np.concatenate(
                [prefix, rng.integers(0, cfg.vocab_size, m - 64)]))
        else:
            out.append(rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(40, 73))))
    return out


def _launches_in_steps(eng, when):
    """Count every kernel's launches made inside the engine's steps for
    which ``when(step)`` holds, through the sync path's model calls and
    the async path's dispatches (graph replays); returns the dict the
    counts land in."""
    from repro_torch.kernels import cuda
    run_model, dispatch, got = eng._run_model, eng._dispatch_async, {}

    def counting(fn):
        def counted(sb, *a):
            n0 = dict(cuda.LAUNCHES)
            out = fn(sb, *a)
            if when(sb):
                for k, n in cuda.LAUNCHES.items():
                    if n != n0.get(k, 0):
                        got[k] = got.get(k, 0) + n - n0.get(k, 0)
            return out
        return counted
    eng._run_model, eng._dispatch_async = counting(run_model), \
        counting(dispatch)
    return got


def _packed(sb):
    return sb.kind == "packed"


def _several_prompts_a_row(args, kw):
    """A K3 call of a packed step with a row of several prompts."""
    return kw.get("seg_q") is not None and int(kw["seg_q"].max()) > 0


def _capture_kernel_inputs(torch, chunk_when=_several_prompts_a_row,
                           decode_when=None):
    """Keep the inputs of the first K3 call for which ``chunk_when(args,
    kw)`` holds (default: a packed step with a row of several prompts) and
    of the first K4 call (a decode-only step through the visit list) for
    which ``decode_when`` holds (default: any), every tensor cloned (the
    layer's pool too: later steps write it), for ``_hold_to_plain``.
    Patches ``ops.paged_chunk_prefill`` and ``ops.paged_pool_decode``,
    which the models call, until ``restore()``. Returns (the calls by
    kernel, restore)."""
    from repro_torch.kernels import ops
    got, saved = {}, (ops.paged_chunk_prefill, ops.paged_pool_decode)

    def keep(name, args, kw):
        def clone(a):
            return a.clone() if isinstance(a, torch.Tensor) else a
        got[name] = (tuple(map(clone, args)),
                     {k: clone(v) for k, v in kw.items()})

    def chunk(*args, **kw):
        if "flash_chunk_prefill" not in got and chunk_when(args, kw):
            keep("flash_chunk_prefill", args, kw)
        return saved[0](*args, **kw)

    def decode(*args, **kw):
        q, kv = args[0], args[1]
        B, Hq, D = q.shape
        if "paged_pool_decode_visits" not in got and ops._gqa_use_visits(
                kw.get("share_visits", False), B, Hq, kv.shape[3], D,
                kv.shape[2], kw["opt_kv"], kw["opt_gqa"]) and (
                decode_when is None or decode_when(args, kw)):
            keep("paged_pool_decode_visits", args, kw)
        return saved[1](*args, **kw)

    def restore():
        ops.paged_chunk_prefill, ops.paged_pool_decode = saved
    ops.paged_chunk_prefill, ops.paged_pool_decode = chunk, decode
    return got, restore


def _hold_to_plain(torch, got, what):
    """K3 and K4 on the engine-built inputs ``got``
    (``_capture_kernel_inputs``), each launched once through its wrapper
    and held to its plain version on the same inputs: K3 within one bf16
    ulp beside a control that must fail (a packed step: its planes
    dropped, so each segment also sees its row-mates' keys; else a
    windowed step: the window dropped; else each row's newest key masked
    off); K4 bit-identical to K2 on the same step and K2 within the ulp of
    its plain version beside a control (each lane's newest key masked
    off) that must fail, and on a windowed step a second one (the window
    dropped). Returns {kernel: summary}."""
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels import flash_chunk_prefill as fc
    from repro_torch.kernels import paged_gqa_decode as pd
    check(set(got) == {"flash_chunk_prefill", "paged_pool_decode_visits"},
          f"{what}: the engine gave K3/K4 inputs only for {sorted(got)}")
    out = {}
    (q, pos, kv, sc, table), kw = got["flash_chunk_prefill"]
    ks, vs = (sc[0], sc[1]) if sc is not None else (None, None)
    base = {k: kw[k] for k in ("opt_kv", "opt_gqa", "window", "sink_pages")}
    packed = kw.get("seg_q") is not None
    planes = {k: kw[k].int() for k in ("seg_q", "page_seg", "page_base")} \
        if packed else {}
    n0 = cuda.LAUNCHES["flash_chunk_prefill"]
    k3 = ops.paged_chunk_prefill(q, pos, kv, sc, table, **kw)
    n3 = cuda.LAUNCHES["flash_chunk_prefill"] - n0
    ref = (q, pos.int(), kv[0], kv[1], ks, vs, table.int())
    p3 = fc.flash_chunk_prefill_ref(*ref, **base, **planes)
    if packed:
        control3 = "planes dropped"
        c3 = fc.flash_chunk_prefill_ref(*ref, **base)
    elif base["window"]:
        control3 = "window dropped"
        c3 = fc.flash_chunk_prefill_ref(*ref, **dict(base, window=0))
    else:
        control3 = "newest key masked off"
        c3 = fc.flash_chunk_prefill_ref(q, pos.int() - 1, *ref[2:], **base)
    torch.cuda.synchronize()
    r3, err3 = tol_ratio(k3, p3)
    rc3, errc3 = tol_ratio(k3, c3)
    R, S, Hq, _ = q.shape
    out["flash_chunk_prefill"] = dict(
        G=Hq // kv.shape[3], rows=R, S=S, window=base["window"],
        max_position=int(pos.max()),
        segments=int(planes["seg_q"].max()) + 1 if packed else 1, ratio=r3,
        max_abs_err=err3, control=control3, control_ratio=rc3,
        control_err=errc3)
    (q, kv, sc, cl, phys, logt), kw = got["paged_pool_decode_visits"]
    ks, vs = (sc[0], sc[1]) if sc is not None else (None, None)
    base = {k: kw[k] for k in ("opt_kv", "opt_gqa", "window", "sink_pages")}
    n0 = cuda.LAUNCHES["paged_pool_decode_visits"]
    k4 = ops.paged_pool_decode(q, kv, sc, cl, phys, logt, **kw)
    n4 = cuda.LAUNCHES["paged_pool_decode_visits"] - n0
    k2 = ops.paged_pool_decode(q, kv, sc, cl, phys, logt,
                               **dict(kw, share_visits=False))
    ref = (q, kv[0], kv[1], ks, vs)
    p2 = pd.paged_pool_decode_ref(*ref, cl.int(), phys.int(), logt.int(),
                                  **base)
    c2 = pd.paged_pool_decode_ref(*ref, (cl.int() - 1).clamp(min=0),
                                  phys.int(), logt.int(), **base)
    w2 = pd.paged_pool_decode_ref(*ref, cl.int(), phys.int(), logt.int(),
                                  **dict(base, window=0)) \
        if base["window"] else None
    torch.cuda.synchronize()
    r2, err2 = tol_ratio(k2, p2)
    rc2, errc2 = tol_ratio(k2, c2)
    r4, err4 = tol_ratio(k4, p2)
    bitwise = torch.equal(k4, k2)
    out["paged_pool_decode_visits"] = dict(
        G=q.shape[1] // kv.shape[3], lanes=q.shape[0],
        cache_len=cl.tolist(), window=base["window"], ratio=r4,
        max_abs_err=err4, bit_identical_to_k2=bitwise, k2_ratio=r2,
        k2_err=err2, control_ratio=rc2, control_err=errc2)
    line = ""
    if w2 is not None:
        rw2, errw2 = tol_ratio(k2, w2)
        out["paged_pool_decode_visits"].update(window_control_ratio=rw2,
                                               window_control_err=errw2)
        line = f"; control, window dropped: {errw2:.3e} = {rw2:.2f}"
    kind = "packed" if packed else "windowed" if base["window"] else "mixed"
    log(f"{what}: K3 on an engine-built {kind} step (G {Hq // kv.shape[3]},"
        f" {R} rows x {S}, positions to {int(pos.max())}, up to "
        f"{out['flash_chunk_prefill']['segments']} prompts a row): max "
        f"|kernel - plain| {err3:.3e} = {r3:.3f} of the tolerance; control, "
        f"{control3}: {errc3:.3e} = {rc3:.2f}. K4 on an engine-built decode "
        f"step (cache_len {cl.tolist()}): bit-identical to K2 {bitwise}, max "
        f"|kernel - plain| {err4:.3e} = {r4:.3f} of the tolerance; control, "
        f"newest key masked off: {errc2:.3e} = {rc2:.2f}" + line)
    check(n3 == 1 and n4 == 1, f"{what}: the held calls launched K3 {n3} "
          f"and K4 {n4} times, not once each")
    check(r3 <= 1, f"{what}: K3 differs from its plain version")
    check(rc3 > 1, f"{what}: the tolerance passes a K3 mask error "
          f"({control3})")
    check(w2 is None or rw2 > 1, f"{what}: the tolerance passes a window "
          "error in K2/K4")
    check(bitwise, f"{what}: K4 is not bit-identical to K2")
    check(r2 <= 1 and r4 <= 1, f"{what}: K2/K4 differ from their plain "
          "version")
    check(rc2 > 1, f"{what}: the tolerance passes a one-key mask error in "
          "K2/K4")
    return out


def _packed_sync(torch, cfg, coopt, ecfg, params, prompts, max_new, what,
                 kernel="flash_chunk_prefill", hold=False, capture=(),
                 count=None):
    """``Engine.generate`` with ``ecfg`` on ``params``: (summary, logits
    rows, launches). Every request must finish with finite logits;
    with packing the engine must pack and save rows, and ``kernel`` must
    launch once a layer in every packed step. ``hold``: K3 and K4 are
    held to their plain versions on the inputs of one of this run's
    packed and decode steps (``_hold_to_plain``, into the summary's
    ``vs_plain``); ``capture`` (``_capture_kernel_inputs``' predicates)
    chooses other steps. ``count(step)``: the launches in the steps it
    holds for go to the summary's ``counted_launches``."""
    from repro_torch.serving import Engine
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    in_packed = _launches_in_steps(eng, _packed)
    counted = _launches_in_steps(eng, count) if count else None
    layouts = _record_layouts(eng)
    got, restore = _capture_kernel_inputs(torch, *capture) if hold \
        else ({}, None)
    try:
        reqs, rows, wall, launches, _ = _sync_recorded(torch, eng, prompts,
                                                       max_new)
    finally:
        if restore is not None:
            restore()
    r = _engine_summary(eng.stats, wall)
    if hold:
        r["vs_plain"] = _hold_to_plain(torch, got, what)
        del got
    r.update(launches=launches,
             packed_step_launches={kernel: in_packed.get(kernel, 0)},
             layouts=layouts)
    if counted is not None:
        r["counted_launches"] = dict(counted)
    log(f"{what}: {_fmt(r)}, packed steps {r['packed_steps']}, rows saved "
        f"{r['packed_rows_saved']}, launches {launches}")
    check(all(len(q.output) == max_new for q in reqs), f"{what}: unfinished")
    check(all(bool(torch.isfinite(row).all()) for seq in rows.values()
              for _, row in seq), f"{what}: non-finite logits")
    if ecfg.pack_prefill:
        st = eng.stats
        check(st.packed_steps > 0 and st.packed_rows_saved > 0,
              f"{what}: nothing was packed")
        check(st.packed_steps == st.prefill_calls,
              f"{what}: a prefill step ran unpacked")
        check(in_packed.get(kernel, 0) == cfg.num_layers * st.packed_steps,
              f"{what}: {kernel} launched {in_packed.get(kernel, 0)} times "
              f"in {st.packed_steps} packed steps")
    return r, rows, launches


def _packed_async(torch, cfg, coopt, ecfg, params, prompts, max_new, rows,
                  sync_layouts, what, chunk_kernel="flash_chunk_prefill",
                  decode_kernel="paged_pool_decode_visits", count=None):
    """``AsyncEngine(warmup=True)`` with ``ecfg`` on ``params``: one runner
    a lattice shape (decode, each prefill bucket and, packing, each row
    bucket x prefill bucket packed), no miss, every prefill step packed
    when packing, the launches of the replays following the steps, and
    greedy tokens equal to the sync run's of the same ``ecfg`` (``rows``)
    or parted at a near-tie (a MoE model: ``_moe_partings``, with the sync
    run's ``sync_layouts``). The summary adds, by step shape ("kind R x
    S"), the host's ms a dispatch and, after the run, the card's ms a
    replay of that shape's graph (``_replay_ms``); ``count(step)``: the
    launches of the replays of the steps it holds for
    (``counted_launches``). Returns (engine, frontend, summary)."""
    from repro_torch.serving import Engine, FinishReason
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    counted = _launches_in_steps(eng, count) if count else None
    layouts = _record_layouts(eng)
    recorded = _record_steps(eng) if cfg.num_experts else None
    keys, steps = {}, []

    def shape_of(sb):
        R, S = sb.batch["page_table"].shape[0], \
            sb.batch["tokens"].shape[1] if "tokens" in sb.batch else 1
        label = f"{sb.kind} {R} x {S}"
        keys[label] = eng._async_key(sb.kind, sb.batch)
        return label
    fe, streams, warm_s, wall, launches, _ = _async_run(
        torch, eng, prompts, max_new, steps=steps, kind_of=shape_of)
    a = _engine_summary(eng.stats, wall)
    a["host_steps"] = _host_steps(steps)
    for label, key in sorted(keys.items()):
        a["host_steps"][label]["replay_ms"] = _replay_ms(
            torch, eng._runners[key])
    B, nb = ecfg.num_lanes, len(ecfg.prefill_buckets)
    # packed shapes: 1, 2, 4, ... rows, and B
    row_buckets = (B - 1).bit_length() + 1 if ecfg.pack_prefill else 0
    a.update(runners=fe.warmed_shapes, warmup_s=warm_s,
             graph_pool_gib=eng.graph_pool_bytes / 2**30,
             aot_misses=eng.aot_misses, launches=launches,
             trace_counts=dict(eng.trace_counts))
    outs = {i: list(h.req.output) for i, h in enumerate(streams)}
    a["layouts"] = layouts
    if counted is not None:
        a["counted_launches"] = dict(counted)
    if recorded is not None:
        a.update(_moe_partings(torch, eng, recorded, rows,
                               (sync_layouts, layouts), outs, max_new, what))
        a["parted"] = a["parted_vs_replay"] + a["parted_vs_sync"]
    else:
        a["parted"] = _partings(torch, rows, outs, what)
    log(f"{what}: {fe.warmed_shapes} runners captured in {warm_s:.2f} s, "
        f"graph pool {a['graph_pool_gib']:.3f} GiB, {_fmt(a)}, packed steps "
        f"{a['packed_steps']}, rows saved {a['packed_rows_saved']}, "
        f"aot_misses {eng.aot_misses}, launches {launches}; "
        f"{len(a['parted'])} partings at a near-tie; by step shape: "
        + ", ".join(
            f"{k} {v['steps']} x (host {v['host_ms'] / v['steps']:.2f} ms, "
            f"replay {v['replay_ms']:.3f} ms)"
            for k, v in sorted(a["host_steps"].items())))
    check(fe.warmed_shapes == 1 + nb + row_buckets * nb,
          f"{what}: {fe.warmed_shapes} runners, not one a lattice shape")
    check(eng.aot_misses == 0, f"{what}: the async run missed a runner")
    check(all(h.finish_reason is FinishReason.FINISHED for h in streams),
          f"{what}: unfinished")
    st, L = eng.stats, cfg.num_layers
    if ecfg.pack_prefill:
        check(st.packed_steps == st.prefill_calls > 0
              and st.packed_rows_saved > 0, f"{what}: nothing was packed")
    want = {chunk_kernel: L * st.prefill_calls,
            decode_kernel: L * (st.decode_steps - st.mixed_steps)}
    if cfg.family != "mla":         # the latent write is a plain scatter
        want["kv_cache_write"] = L * a["steps"]
    for k, n in want.items():
        check(launches[k] == n > 0, f"{what}: {k}: {launches[k]} launches "
              f"through replays, {n} expected")
    return eng, fe, a


def packed_phase(torch, rec, arch="qwen2.5-14b",
                 mla_arch="deepseek-v2-lite-16b", dense=PACKED_DENSE):
    """Concat-prefill packing end to end. ``arch`` at full width and depth
    served on the same weights by ``Engine.generate`` unpacked, packed,
    packed, unpacked, then by ``AsyncEngine(warmup=True)`` packed (17
    runners, a CUDA graph each), unpacked (5), unpacked, packed (the
    repeats in reverse order show the spread of the pace); packed tokens
    equal the unpacked run's and async the sync run's of its setting, or
    part at a near-tie; one packed step (a row holding several prompts)
    replayed against its eager body. ``dense``: each
    (arch, layers, new tokens, requests) served sync unpacked, packed,
    packed, unpacked (only packed at cut depth). Each model's last sync
    packed run holds K3 and K4 to their plain versions on its own packed
    and decode steps' inputs (``_hold_to_plain``: G 5, 1, 7 and 8).
    ``mla_arch`` at 4 layers, sync and async packed: K6 on packed rows
    through replays, the async tokens held like for like
    (``_moe_partings``). Returns the launches of the packed runs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    from repro_torch.serving import EngineConfig
    coopt = COOPT.replace(use_kernel=True)
    ecfg = EngineConfig(num_lanes=4, max_len=1024, seed=0)
    pcfg = dataclasses.replace(ecfg, pack_prefill=True)
    res, packed_launches = {}, {}

    def add(launches):
        for k, n in launches.items():
            packed_launches[k] = packed_launches.get(k, 0) + n

    def params_of(cfg):
        t0 = time.perf_counter()
        params = get_model(cfg).init(0, DEV)
        torch.cuda.synchronize()
        n = get_model(cfg).param_count()
        log(f"{cfg.name}: {cfg.num_layers} layers, {n / 1e9:.3f} B params "
            f"initialised in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        return params, n

    def free():
        gc.collect()                 # the recorders close cycles
        torch.cuda.empty_cache()

    # the slice's path: full width and depth, sync then async, each
    # unpacked and packed in turns
    cfg = get_config(arch)
    prompts = packed_prompts(cfg)
    params, n = params_of(cfg)
    r = res[arch] = {"params": n}
    rows = {}
    for key, e in (("sync", ecfg), ("sync_packed", pcfg),
                   ("sync_packed_2", pcfg), ("sync_2", ecfg)):
        r[key], got, launches = _packed_sync(
            torch, cfg, coopt, e, params, prompts, 32, f"{arch} {key}",
            hold=key == "sync_packed_2")
        rows.setdefault(e.pack_prefill, got)
        if e.pack_prefill:
            add(launches)
        del got
    outs = {i: [t for t, _ in seq] for i, seq in rows[True].items()}
    r["sync_packed"]["parted"] = _partings(torch, rows[False], outs,
                                           f"{arch} packed vs unpacked")
    for key, e in (("async_packed", pcfg), ("async", ecfg),
                   ("async_2", ecfg), ("async_packed_2", pcfg)):
        sync_key = "sync_packed" if e.pack_prefill else "sync"
        eng, fe, r[key] = _packed_async(
            torch, cfg, coopt, e, params, prompts, 32, rows[e.pack_prefill],
            r[sync_key]["layouts"], f"{arch} {key}")
        if e.pack_prefill:
            add(r[key]["launches"])
        if key == "async_packed":
            # a packed step whose row holds several prompts, replayed
            # against its eager body from the same pool state; a packed
            # runner's counts are K1 and K3 once a layer
            r["replay_vs_eager"] = rv = _replay_checks(
                torch, eng, prompts[:6], want=("packed",))
            log(f"packed replay vs eager ({arch}): {rv}")
            check(rv["packed"]["max_logit_diff"] == 0
                  and rv["packed"]["pool_bytes_differ"] == 0
                  and rv["packed"]["lane_feed_equal"],
                  "the packed step's replay differs from its eager run")
            L = cfg.num_layers
            counted = [x.launches for x in eng._runners.values()
                       if x.kind == "packed"]
            check(len(counted) == 12 and all(
                c == {"kv_cache_write": L, "flash_chunk_prefill": L}
                for c in counted), f"the packed runners counted {counted}")
        del eng, fe
    del rows, params
    free()

    # the paper's model at full depth (unpacked and packed in turns), and
    # G 7 / G 8 at 4 layers (packed)
    for name, layers, new, nreq in dense:
        cfg = get_config(name)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        prompts = packed_prompts(cfg, nreq)
        params, n = params_of(cfg)
        r = res[name] = {"params": n, "layers": cfg.num_layers}
        runs = ((("sync", ecfg), ("sync_packed", pcfg),
                 ("sync_packed_2", pcfg), ("sync_2", ecfg))
                if layers is None else (("sync_packed", pcfg),))
        rows = {}
        for key, e in runs:
            r[key], got, launches = _packed_sync(
                torch, cfg, coopt, e, params, prompts, new,
                f"{name} ({cfg.num_layers} layers) {key}",
                hold=key == ("sync_packed" if layers else "sync_packed_2"))
            rows.setdefault(e.pack_prefill, got)
            check(launches["paged_pool_decode_visits"] > 0,
                  f"{name}: K4 never launched")
            if e.pack_prefill:
                add(launches)
            del got
        if layers is None:
            outs = {i: [t for t, _ in seq] for i, seq in rows[True].items()}
            r["sync_packed"]["parted"] = _partings(
                torch, rows[False], outs, f"{name} packed vs unpacked")
        del params, rows
        free()

    # MLA at 4 layers (1 dense + 3 MoE): K6 on packed rows, sync and by
    # replays
    mcfg = get_config(mla_arch).replace(num_layers=4)
    prompts = packed_prompts(mcfg)
    params, n = params_of(mcfg)
    r = res[mla_arch] = {"params": n, "layers": 4}
    r["sync_packed"], prows, launches = _packed_sync(
        torch, mcfg, coopt, pcfg, params, prompts, 32,
        f"{mla_arch} (4 layers) sync packed", kernel="latent_chunk_prefill")
    add(launches)
    eng, fe, r["async_packed"] = _packed_async(
        torch, mcfg, coopt, pcfg, params, prompts, 32, prows,
        r["sync_packed"]["layouts"], f"{mla_arch} (4 layers) async packed",
        chunk_kernel="latent_chunk_prefill",
        decode_kernel="paged_latent_decode_visits")
    add(r["async_packed"]["launches"])
    del eng, fe, params, prows
    free()
    # the largest error of each kernel held on the engines' inputs
    held = [run["vs_plain"] for m in res.values() for run in m.values()
            if isinstance(run, dict) and "vs_plain" in run]
    check(len(held) == 1 + len(dense), f"K3/K4 held on {len(held)} models' "
          f"engine inputs, not {1 + len(dense)}")
    res["vs_plain_max_abs_err"] = {
        "flash_chunk_prefill": max(h["flash_chunk_prefill"]["max_abs_err"]
                                   for h in held),
        "paged_pool_decode_visits": max(
            h["paged_pool_decode_visits"]["max_abs_err"] for h in held),
        "paged_pool_decode": max(h["paged_pool_decode_visits"]["k2_err"]
                                 for h in held)}
    log("packed: K3/K4 held to their plain versions at G " + ", ".join(
        str(h["flash_chunk_prefill"]["G"]) for h in held) + "; largest "
        f"errors {res['vs_plain_max_abs_err']}")
    rec["packed"] = res
    return packed_launches


# ------------------------------------------------------------ serve ----
# The serve phase's launcher workload: (arch, requests, new tokens, lanes,
# max_len, arrival rate in requests/s, measured rounds). max_len holds the
# longest ShareGPT prompt (2048 tokens at scale 1.0) and its new tokens.
SERVE = ("qwen3-4b", 16, 32, 4, 2048 + 32, 2.0, 2)
# the families' workloads: (arch, layers or None for full depth, the long
# prompt's tokens or 0, ShareGPT requests, new tokens, max_len)
SERVE_MOE = ("mixtral-8x22b", 4, 5000, 3, 16, 6144)
SERVE_VLM = ("internvl2-2b", None, 0, 8, 16, 1024 + 2048 + 32)


def _context(sb):
    """The longest context a step's lanes attend over (from its plan)."""
    return max([c.start + c.n for c in sb.plan.prefill]
               + [d.pos + 1 for d in sb.plan.decode])


def _pass_record(runner, wall, rep):
    """One measured pass's line: the launcher's report keys this phase
    prints, and the step counts."""
    st = runner.engine.stats
    keys = ("wall_s", "generated_tokens", "wall_throughput_tok_s",
            "ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
            "queue_wait_p50_s", "queue_wait_p95_s", "packed_steps",
            "packed_rows_saved", "prefix_hit_rate", "preemptions", "rejected")
    r = {k: rep[k] for k in keys}
    r.update(steps=st.prefill_calls + st.decode_steps - st.mixed_steps,
             **runner.trace_report())
    return r


def launcher_runs(torch, rec, params=None, spec=SERVE):
    """(a) ``repro_torch.launch.serve.ServeRunner`` at full width and depth:
    sync, async and async + packing built up front on one parameter dict,
    each warmed with a pass of the workload, then measured round-robin
    (``rounds`` passes each) over the same Poisson arrivals of ShareGPT
    requests (``RequestStream`` at scale 1.0). Every request must finish,
    the async runners must pass ``assert_aot`` (no step without a runner,
    no runner built after the warmup), and each async pass's greedy tokens
    must equal the last sync pass's or part at a near-tie of its logits.
    Returns the launches of the measured passes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import ServeRunner
    from repro_torch.models import get_model
    arch, n, new, lanes, max_len, rate, rounds = spec
    if params is None:
        params = get_model(get_config(arch)).init(0, DEV)
    kw = dict(requests=n, num_lanes=lanes, max_len=max_len,
              max_new_tokens=new, scale=1.0, seed=0, use_kernel=True,
              arrival_rate=rate, warmup_pass=True, device=DEV,
              params=params)
    runners, res = {}, {"spec": dict(zip(
        ("arch", "requests", "new_tokens", "lanes", "max_len",
         "arrival_rate", "rounds"), spec))}
    for name, extra in (("sync", {}), ("async", dict(use_async=True)),
                        ("async_pack", dict(use_async=True, pack=True))):
        t0 = time.perf_counter()
        runners[name] = ServeRunner(arch, "coopt", assert_aot=name != "sync",
                                    **kw, **extra)
        torch.cuda.synchronize()
        meta = {k: v for k, v in runners[name].meta.items()
                if k in ("aot_executables", "aot_by_kind", "warmup_s",
                         "graph_pool_gib")}
        res[name] = dict(build_s=time.perf_counter() - t0, passes=[], **meta)
        log(f"serve {arch} {name}: built and warmed (a pass of the workload)"
            f" in {res[name]['build_s']:.1f} s {meta}")
    reqs = runners["sync"].reqs
    plens = sorted(r.prompt_len for r in reqs)
    res["prompt_tokens"] = dict(min=plens[0], median=plens[len(plens) // 2],
                                max=plens[-1], total=sum(plens))
    log(f"serve {arch}: {n} requests, prompts {res['prompt_tokens']}, "
        f"Poisson arrivals at {rate} requests/s over "
        f"{runners['sync'].offsets[-1]:.2f} s")
    # the sync run's rows (token, logits) of its last pass, by request
    eng = runners["sync"].engine
    sample, post, rows, last = eng._sample, eng._postprocess, {}, {}

    def keep(logits):
        last["logits"] = logits.float()
        return sample(logits)

    def note(sb, toks, now):
        for req, _, idx in sb.samples:
            rows.setdefault(req.req_id - 1, []).append(
                (int(toks[idx]), last["logits"][idx]))
        return post(sb, toks, now)
    eng._sample, eng._postprocess = keep, note
    launches = {}
    try:
        for rnd in range(rounds):
            for name, runner in runners.items():
                if name == "sync":
                    rows.clear()
                cuda.reset_launches()
                wall = runner.measure()
                torch.cuda.synchronize()
                for k, v in cuda.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v
                try:
                    p = _pass_record(runner, wall, runner.metrics(wall))
                except RuntimeError as e:       # assert_aot
                    raise Fail(f"serve {arch} {name}: {e}") from e
                p["launches"] = dict(cuda.LAUNCHES)
                res[name]["passes"].append(p)
                log(f"serve {arch} {name} pass {rnd + 1}: "
                    f"{p['wall_throughput_tok_s']:.1f} tok/s over "
                    f"{p['wall_s']:.2f} s, TTFT p50/p95 "
                    f"{p['ttft_p50_s'] * 1e3:.1f}/{p['ttft_p95_s'] * 1e3:.1f}"
                    f" ms, TPOT p50/p95 {p['tpot_p50_s'] * 1e3:.2f}/"
                    f"{p['tpot_p95_s'] * 1e3:.2f} ms, queue wait p50/p95 "
                    f"{p['queue_wait_p50_s'] * 1e3:.1f}/"
                    f"{p['queue_wait_p95_s'] * 1e3:.1f} ms, {p['steps']} "
                    f"steps, packed steps {p['packed_steps']}, rows saved "
                    f"{p['packed_rows_saved']}, aot_misses "
                    f"{p.get('aot_misses', '-')}, retraces "
                    f"{p.get('retraces', '-')}")
                check(p["generated_tokens"] == n * new and not p["rejected"],
                      f"serve {arch} {name}: {p['generated_tokens']} of "
                      f"{n * new} tokens")
                if runner.use_async:
                    out = runner.outcome_report(wall)["outcomes"]
                    check(out["finished"] == n, f"serve {arch} {name}: "
                          f"outcomes {out}")
        for name in ("async", "async_pack"):
            outs = {i: list(s.req.output)
                    for i, s in enumerate(runners[name].last_streams)}
            res[name]["parted"] = _partings(
                torch, rows, outs, f"serve {arch} {name} vs sync")
        check(runners["async_pack"].engine.stats.packed_steps > 0,
              f"serve {arch}: the packed runner never packed")
    finally:
        eng._sample, eng._postprocess = sample, post
        for runner in runners.values():
            runner.close()
    rec.setdefault("serve", {})[arch] = res
    del runners, rows, last
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_runs(torch, rec, spec):
    """(b), (c): a family's engines at full width (``layers``: cut depth),
    sync then async (``Engine.generate``, ``AsyncEngine(warmup=True)``;
    ``_packed_sync``, ``_packed_async``), ShareGPT requests (and a long
    prompt), K3 and K4 held to their plain versions on steps of the sync
    run (``_hold_to_plain``): a windowed model on a chunk and a decode
    step whose context passes its window and sink page, a vlm model on a
    chunk past its patch stub. Returns (the launches of both runs, the
    held summary)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.data import RequestStream
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig
    arch, layers, long_n, n, new, max_len = spec
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    coopt = COOPT.replace(use_kernel=True)
    ecfg = EngineConfig(num_lanes=4, max_len=max_len, seed=0)
    t0, held = time.perf_counter(), torch.cuda.memory_allocated()
    params = get_model(cfg).init(0, DEV)
    torch.cuda.synchronize()
    res = {"layers": cfg.num_layers, "params": get_model(cfg).param_count(),
           "init_s": time.perf_counter() - t0,
           "weights_gib": (torch.cuda.memory_allocated() - held) / 2**30}
    prompts = [r.prompt for r in RequestStream(
        cfg.vocab_size, seed=0, scale=1.0).take(n)]
    if long_n:
        prompts.insert(0, np.random.default_rng(5).integers(
            0, cfg.vocab_size, long_n))
    stub = cfg.num_patches if cfg.family == "vlm" else 0
    res["prompt_tokens"] = [len(p) + stub for p in prompts]
    log(f"serve {arch}: {cfg.num_layers} layers, {res['params'] / 1e9:.3f} B "
        f"params in {res['init_s']:.1f} s, {res['weights_gib']:.1f} GiB; "
        f"contexts {res['prompt_tokens']} + {new} new tokens")
    if cfg.attn_window:
        limit = cfg.attn_window + cfg.sink_blocks * coopt.page_size

        def chunk_when(args, kw):
            return kw["window"] > 0 and int(args[1].max()) >= limit

        def decode_when(args, kw):
            return int(args[3].max()) > limit
        res["window_limit"] = limit
    else:
        def chunk_when(args, kw):
            return int(args[1].max()) >= stub
        decode_when = None
        limit = stub
    past = (lambda sb: _context(sb) > limit) if cfg.attn_window else None
    res["sync"], rows, launches = _packed_sync(
        torch, cfg, coopt, ecfg, params, prompts, new, f"serve {arch} sync",
        hold=True, capture=(chunk_when, decode_when), count=past)
    total = dict(launches)
    eng, fe, res["async"] = _packed_async(
        torch, cfg, coopt, ecfg, params, prompts, new, rows,
        res["sync"]["layouts"], f"serve {arch} async", count=past)
    for k, v in res["async"]["launches"].items():
        total[k] = total.get(k, 0) + v
    del eng, fe, rows
    for k in ("flash_chunk_prefill", "paged_pool_decode_visits"):
        check(total.get(k, 0) > 0, f"serve {arch}: {k} never launched")
    if past is not None:
        for run in ("sync", "async"):
            got = res[run]["counted_launches"]
            log(f"serve {arch} {run}: launches in steps past the window "
                f"and sink page ({limit} positions): {got}")
            for k in ("flash_chunk_prefill", "paged_pool_decode_visits"):
                check(got.get(k, 0) > 0, f"serve {arch} {run}: {k} never "
                      "launched on a windowed step")
    if stub:
        try:
            Engine(cfg, coopt, dataclasses.replace(ecfg, pack_prefill=True),
                   params=params, device=DEV)
        except ValueError as e:
            res["pack_refused"] = str(e)
        check("pack_refused" in res, f"serve {arch}: pack_prefill did not "
              "raise")
    rec.setdefault("serve", {})[arch] = res
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total, res["sync"]["vs_plain"]


def serve_phase(torch, rec, params=None):
    """The launcher at full width and depth (``launcher_runs``), then
    mixtral-8x22b (4 layers, windowed) and internvl2-2b (full depth, patch
    stub) through both engines (``family_runs``). Returns (the launches of
    the phase's runs, the held summaries)."""
    launches = launcher_runs(torch, rec, params)
    held = []
    for spec in (SERVE_MOE, SERVE_VLM):
        got, vs = family_runs(torch, rec, spec)
        held.append(vs)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    rec["serve"]["launches"] = launches
    rec["serve"]["vs_plain_max_abs_err"] = {
        "flash_chunk_prefill": max(h["flash_chunk_prefill"]["max_abs_err"]
                                   for h in held),
        "paged_pool_decode_visits": max(
            h["paged_pool_decode_visits"]["max_abs_err"] for h in held),
        "paged_pool_decode": max(h["paged_pool_decode_visits"]["k2_err"]
                                 for h in held)}
    for k in ("kv_cache_write", "flash_chunk_prefill",
              "paged_pool_decode_visits"):
        check(launches.get(k, 0) > 0, f"serve: {k} never launched")
    return launches


# ------------------------------------------------ the recurrent families --
# (arch, ShareGPT requests, the long prompt's tokens or 0, the shared
# prefix's tokens, new tokens, max_len)
RECURRENT_RG = ("recurrentgemma-9b", 5, 3000, 512, 16, 3136)
RECURRENT_RW = ("rwkv6-7b", 6, 0, 512, 16, 3136)


def _d256_record(rec_k, name, info, key="d256", label="D 256"):
    """A kernel's record at another head_dim (D 256 by default): its
    numbers, the registers and local bytes its instantiation reports."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "flops",
            "max_abs_err", "shape", "library")
    r = {k: rec_k[k] for k in keys if k in rec_k}
    r.update(key=key, registers=info["registers"],
             local_bytes=info["local_bytes"],
             bound_share=r["bound_ms"] / r["ms"])
    log(f"  {name} at {label}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
        f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
        f"{r['bound_by']}, {r['bound_share']:.2%} of it); "
        f"{info['registers']} registers, {info['local_bytes']} local bytes "
        "a thread")
    return r


def recurrent_kernel_case(torch, rec, time_ms):
    """K1-K4 at recurrentgemma-9b's attention widths (D 256, Hq 16, Hkv 1:
    G 16, pages of 64, window 2048 + one sink page): K1 at B 4, S 512
    (pool bytes and scales equal); K3 over a 512-token chunk at [2560,
    3072) beside 3 decode lanes, past the window and its sink page, held
    to its plain version beside a control (the window dropped); K2 and K4
    on a windowed decode of 4 lanes of 32 pages (K4 = K2 bit for bit), and
    K2 at 8 lanes, where K4's plan does not fit a block (the wrapper routes
    it to K2); the decodes at ~3000 tokens a lane, 48 pages of which the
    window and sink select 33. Each with its time, the plain version's, a
    library call's, the bound, and the registers and local bytes of its
    instantiation. Returns {kernel name: [its D 256 records]}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_chunk_prefill as fc
    from repro_torch.kernels import kv_cache_write as kw
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_gqa_decode as pd
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(22)
    Hq, Hkv, D, ps, W, sink = 16, 1, 256, 64, 2048, 1
    out = {}
    # ---- K1: the engine's mixed chunk (one 512-token lane, three decode
    # lanes' single tokens and a 64-token tail) at one kv head of 256
    k1 = write_case(torch, time_ms, gen, "d256", 4, 512, (512, 300, 1, 64),
                    0, 16, True, Hkv=Hkv, D=D, ps=ps)
    _, vecs, _ = kw.write_plan(4 * 512, Hkv, D)
    out["kv_cache_write"] = [_d256_record(
        k1, "K1 kv_cache_write", kw.kernel_info(D, True, vecs, dev))]
    # ---- K2 / K4: a windowed decode past the window, 4 lanes; K2 at 8
    for B, NP, key in ((4, 48, "decode_d256"), (8, 48, "decode_d256_b8")):
        kv, sc, table = paged_pool(torch, gen, B, NP, 4, Hkv, D, ps)
        cache_len = (NP * ps - torch.arange(B, device=dev) * 37).to(
            torch.int32)
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(
            torch.bfloat16)
        fits = pd.plan_fits(B, Hq, Hkv, D, ps, True, True)
        check(fits == (B <= 6), f"K4's plan at D 256, G 16 and {B} lanes "
              f"fits {fits}")
        recs = decode_step(torch, rec, time_ms, key, q, kv, sc, table,
                           cache_len, window=W, sink=sink, visits_fit=fits)
        for r in recs:
            info = pd.kernel_info(D, True, r["name"].endswith("visits"), dev)
            d = _d256_record(r, f"{r['name']} ({B} lanes)", info)
            d["key"] = f"d256_b{B}"
            out.setdefault(r["name"], []).append(d)
        del kv, sc
    # ---- K3: a 512-token chunk past the window and its sink page, and 3
    # decode lanes (one token, padding clamped to it), 50 pages a lane
    B, S, NP = 4, 512, 50
    kv, sc, table = paged_pool(torch, gen, B, NP, 0, Hkv, D, ps)
    pos = torch.empty((B, S), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(2560, 3072, device=dev, dtype=torch.int32)
    for b in range(1, B):
        pos[b] = 3000 + 41 * b
    qc = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(
        torch.bfloat16)
    kwc = dict(opt_kv=True, opt_gqa=True, window=W, sink_pages=sink)
    k3 = ops.paged_chunk_prefill(qc, pos, kv, sc, table, **kwc)
    ref = (qc, pos, kv[0], kv[1], sc[0], sc[1], table)
    p3 = fc.flash_chunk_prefill_ref(*ref, **kwc)
    c3 = fc.flash_chunk_prefill_ref(*ref, **dict(kwc, window=0))
    torch.cuda.synchronize()
    r3, err3 = tol_ratio(k3, p3)
    rc3, errc3 = tol_ratio(k3, c3)
    log(f"K3 flash_chunk_prefill at D 256 (G 16, positions to "
        f"{int(pos.max())}, window {W} + {sink} sink page): max |kernel - "
        f"plain| {err3:.3e} = {r3:.3f} of the tolerance; control, window "
        f"dropped: {errc3:.3e} = {rc3:.2f}")
    check(r3 <= 1, "K3 at D 256 differs from its plain version")
    check(rc3 > 1, "the tolerance passes a window error in K3 at D 256")
    rec.setdefault("tolerance", {}).update(k3_d256=r3, k3_d256_control=rc3)
    # the keys each row sees and the pages they lie on, from the mask
    T = NP * ps
    kpos = torch.arange(T, device=dev)
    vis = (kpos[None, None] <= pos[..., None]) & (
        (kpos[None, None] > pos[..., None] - W) | (kpos < sink * ps))
    keys = int(vis.sum().item())
    pages = int(vis.any(1).reshape(B, NP, ps).any(-1).sum().item())
    chunk_bytes = pages * 2 * ps * Hkv * (D + 4) + 2 * B * S * Hq * D * 2 + \
        B * S * 4 + B * NP * 4
    bnd = bound(chunk_bytes, keys * Hq * D * 4, BF16_FLOPS)
    pt = table.long()
    kd = (kv[0][pt].float() * sc[0][pt][..., None]).to(torch.bfloat16)
    vd = (kv[1][pt].float() * sc[1][pt][..., None]).to(torch.bfloat16)
    kd = kd.reshape(B, T, Hkv, D).transpose(1, 2).contiguous()
    vd = vd.reshape(B, T, Hkv, D).transpose(1, 2).contiguous()
    qc4 = qc.transpose(1, 2).contiguous()
    vmask = vis[:, None]

    def sdpa_chunk():
        return F.scaled_dot_product_attention(qc4, kd, vd, attn_mask=vmask,
                                              enable_gqa=True)
    lib_err = (sdpa_chunk().transpose(1, 2).float() - p3.float()).abs() \
        .max().item()
    k3r = dict(ms=time_ms(lambda: ops.paged_chunk_prefill(
                   qc, pos, kv, sc, table, **kwc)),
               plain_ms=time_ms(lambda: fc.flash_chunk_prefill_ref(
                   *ref, **kwc), iters=3, warmup=1),
               library_ms=time_ms(sdpa_chunk), max_abs_err=err3,
               library="F.scaled_dot_product_attention on pre-gathered "
                       "dequantized bf16 K/V with the window + sink mask "
                       f"(max |lib - plain| {lib_err:.3e})",
               shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} ps={ps} NP={NP}, "
                     f"window {W} + {sink} sink page, {keys} visible keys",
               **bnd)
    out["flash_chunk_prefill"] = [_d256_record(
        k3r, "K3 flash_chunk_prefill", fc.kernel_info(D, True, ps, dev))]
    # the bf16-pool instantiation (opt_kv off) beside the fp8 one
    bf = fc.kernel_info(D, False, ps, dev)
    out["flash_chunk_prefill"][0]["bf16_pool"] = {
        k: bf[k] for k in ("registers", "local_bytes", "smem_bytes")}
    log(f"  K3 at D 256 over a bf16 pool: {bf['registers']} registers, "
        f"{bf['local_bytes']} local bytes a thread, {bf['smem_bytes']} "
        "bytes of shared memory")
    rec["d256"] = out
    del kv, sc, kd, vd
    torch.cuda.empty_cache()
    return out


def _capture_write_inputs(torch, when):
    """Keep the inputs of the first K1 call (``ops.kv_cache_write``) for
    which ``when(args)`` holds, the layer's pool and scales cloned before
    the write. Returns (the call or {}, restore)."""
    from repro_torch.kernels import ops
    got, saved = {}, ops.kv_cache_write

    def write(*args, **kw):
        if not got and when(args):
            got["args"] = tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args)
            got["kw"] = dict(kw)
        return saved(*args, **kw)

    def restore():
        ops.kv_cache_write = saved
    ops.kv_cache_write = write
    return got, restore


def _hold_k1(torch, got, what):
    """K1 on an engine-built write (``_capture_write_inputs``) through its
    wrapper, against its plain version on a copy of the same pool: pool
    bytes and scales equal (the JAX sentinel line excluded)."""
    from repro_torch.kernels import kv_cache_write as kw
    from repro_torch.kernels import ops
    check(bool(got), f"{what}: the engine gave no K1 inputs")
    (kv, sc, k, v, slots), opts = got["args"], got["kw"]
    a_kv, a_sc = kv.clone(), sc.clone()
    ops.kv_cache_write(a_kv, a_sc, k, v, slots, **opts)
    _, P, ps, Hkv, D = kv.shape
    flat, sflat = kv.view(2, P * ps, Hkv, D), sc.view(2, P * ps, Hkv)
    kw.kv_cache_write_ref(k.contiguous(), v.contiguous(), slots.int(),
                          flat[0], flat[1], sflat[0], sflat[1], **opts)
    torch.cuda.synchronize()
    n = P * ps - 1
    same = torch.equal(a_kv.view(2, P * ps, Hkv, D)[:, :n].view(torch.uint8),
                       flat[:, :n].view(torch.uint8))
    same_sc = torch.equal(a_sc.view(2, P * ps, Hkv)[:, :n], sflat[:, :n])
    res = dict(tokens=int((slots >= 0).sum().item()), D=D, Hkv=Hkv,
               bytes_equal=same, scales_equal=same_sc)
    log(f"{what}: K1 on an engine-built step ({res['tokens']} tokens, Hkv "
        f"{Hkv}, D {D}): pool bytes equal {same}, scales equal {same_sc}")
    check(same and same_sc, f"{what}: K1 differs from its plain version")
    return res


def _record_schedule(eng):
    """Record, for each request (``_request_index``), every step it ran in:
    ("chunk", start, tokens, the step's columns) for a prefill chunk and
    ("token", position, the step's columns) for a decode token, which a
    mixed step runs as a padded chunk (a recurrent model then takes the
    chunked form of its recurrence instead of the one-token step). Returns
    the dict it fills."""
    build, lay = eng._build_step, {}

    def recorded(plan, device_feed=False):
        sb = build(plan, device_feed)
        S = sb.batch["tokens"].shape[1] if "tokens" in sb.batch else 1
        for c in plan.prefill:
            lay.setdefault(_request_index(c.req), []).append(
                ("chunk", c.start, c.n, S))
        for d in plan.decode:
            lay.setdefault(_request_index(d.req), []).append(
                ("token", d.pos, S))
        return sb
    eng._build_step = recorded
    return lay


def _runner_shapes(eng):
    """The async runners' replay ms by step shape ("kind R x S")."""
    out = {}
    for r in eng._runners.values():
        tok = r.inputs["token" if r.kind == "decode" else "tokens"]
        out[f"{r.kind} {tok.shape[0]} x {tok.shape[1]}"] = r
    return out


def recurrent_runs(torch, rec, spec, kernels=True):
    """A recurrent family's model at full width and depth, coopt (with the
    kernels), pages of 64, 4 lanes: ``Engine.generate`` then
    ``AsyncEngine(warmup=True)`` on one set of weights, greedy. Requests:
    a page-aligned prefix alone and the same prefix with 100 more tokens
    (admitted after the first has prefilled it, so it hits the prefix
    cache and restores the state snapshotted at the prefix's end), a long
    prompt if any, ShareGPT ones. Checks: every request
    finishes with finite logits; a prefix hit restored a snapshot in both
    engines, and the hit request's tokens equal its run with the prefix
    cache off or part at a near-tie; the async tokens equal the async
    run's own steps replayed eagerly (``_eager_rows``, the resets and
    restores replayed too) exactly, and where a request ran in the same
    steps (``_record_schedule``: they set the state's rounding), the sync
    run's or part at a near-tie; ``pack_prefill`` raises. With ``kernels`` (griffin): K1, K3
    and K4 at D 256 held to their plain versions on engine-built steps past
    the window and its sink page, and launched in both engines. Returns
    (the launches of both runs, the held summary or None)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import CacheConfig, get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.data import RequestStream
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig
    arch, n, long_n, shared, new, max_len = spec
    cfg = get_config(arch)
    coopt = COOPT.replace(use_kernel=True)
    ecfg = EngineConfig(num_lanes=4, max_len=max_len, seed=0)
    t0, held0 = time.perf_counter(), torch.cuda.memory_allocated()
    model = get_model(cfg)
    params = model.init(0, DEV)
    torch.cuda.synchronize()
    res = {"layers": cfg.num_layers, "params": model.param_count(),
           "init_s": time.perf_counter() - t0,
           "weights_gib": (torch.cuda.memory_allocated() - held0) / 2**30}
    lane_bytes = sum(math.prod(sh[2:]) * torch.empty((), dtype=dt)
                     .element_size() * sh[0]
                     for k, (sh, dt, _) in model.cache_shape(
                         1, max_len, coopt).items()
                     if k in model.recurrent_leaves)
    res["snapshot_bytes_a_lane"] = lane_bytes
    rng = np.random.default_rng(7)
    # the first sharer is the prefix itself: its last chunk ends on the
    # prefix's page boundary, where the state is snapshotted
    prefix = rng.integers(0, cfg.vocab_size, shared)
    share = [prefix, np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                          100)])]
    sgpt = [r.prompt for r in RequestStream(cfg.vocab_size, seed=0,
                                            scale=1.0).take(n)]
    longp = [rng.integers(0, cfg.vocab_size, long_n)] if long_n else []
    # the first sharer, the long prompt and ShareGPT ones fill the 4 lanes;
    # the second sharer waits for a free lane
    k = 3 - len(longp)
    prompts = [share[0]] + longp + sgpt[:k] + [share[1]] + sgpt[k:]
    hit_i = 4
    res["prompt_tokens"] = [len(p) for p in prompts]
    log(f"recurrent {arch}: {cfg.num_layers} layers, "
        f"{res['params'] / 1e9:.3f} B params in {res['init_s']:.1f} s, "
        f"{res['weights_gib']:.1f} GiB; prompts {res['prompt_tokens']} "
        f"(requests 0 and {hit_i} share {shared} tokens) + {new} new; a "
        f"lane's state snapshot {lane_bytes / 2**20:.2f} MiB")
    limit = cfg.local_window + cfg.sink_blocks * coopt.page_size

    def restores(eng):
        seen, fn = [], eng._reset_or_restore_state

        def spy(chunks):
            seen.extend((_request_index(c.req), c.start)
                        for c in chunks if c.first)
            return fn(chunks)
        eng._reset_or_restore_state = spy
        return seen

    # ---- sync
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    seen = restores(eng)
    layouts = _record_schedule(eng)
    held = {}
    if kernels:
        got, restore = _capture_kernel_inputs(
            torch, lambda a, kw: kw["window"] > 0 and int(a[1].max())
            >= limit, lambda a, kw: int(a[3].max()) > limit)
        got1, restore1 = _capture_write_inputs(
            torch, lambda a: a[2].shape[1] > 1 and int(a[4].max()) >= 0)
    past = _launches_in_steps(eng, lambda sb: _context(sb) > limit)
    try:
        reqs, rows, wall, launches, _ = _sync_recorded(torch, eng, prompts,
                                                       new)
    finally:
        if kernels:
            restore()
            restore1()
    r = _engine_summary(eng.stats, wall)
    r.update(launches=launches, restores=list(seen),
             prefix_hits=eng.stats.prefix_cache_hits,
             snapshots=len(eng._state_cache),
             past_window_launches=dict(past))
    log(f"recurrent {arch} sync: {_fmt(r)}, prefix hits "
        f"{r['prefix_hits']}, first chunks (request, start) {seen}, "
        f"{r['snapshots']} snapshots, launches {launches}")
    check(all(len(q.output) == new for q in reqs), f"{arch} sync: unfinished")
    check(all(bool(torch.isfinite(row).all()) for seq in rows.values()
              for _, row in seq), f"{arch} sync: non-finite logits")
    check(r["prefix_hits"] > 0 and (hit_i, 0) not in seen and any(
        i == hit_i and s > 0 for i, s in seen), f"{arch} sync: request "
        f"{hit_i} did not restore a snapshot ({seen})")
    if kernels:
        held = _hold_to_plain(torch, got, f"recurrent {arch} sync")
        held["kv_cache_write"] = _hold_k1(torch, got1,
                                          f"recurrent {arch} sync")
        del got, got1
        for k in ("kv_cache_write", "flash_chunk_prefill",
                  "paged_pool_decode_visits"):
            check(past.get(k, 0) > 0, f"{arch} sync: {k} never launched "
                  f"in a step past the window and sink page ({limit})")
    res["sync"] = r
    # ---- the hit request alone with the prefix cache off
    off = Engine(cfg, coopt, dataclasses.replace(
        ecfg, cache=CacheConfig(enable_prefix_cache=False)), params=params,
        device=DEV)
    _, off_rows, _, _, _ = _sync_recorded(torch, off, [prompts[hit_i]], new)
    del off
    mine = {0: list(reqs[hit_i].output)}
    res["hit_vs_cache_off"] = _partings(torch, off_rows, mine,
                                        f"{arch} prefix hit vs cache off")
    # ---- async
    aeng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    aseen = restores(aeng)
    alayouts = _record_schedule(aeng)
    recorded = _record_steps(aeng)
    apast = _launches_in_steps(aeng, lambda sb: _context(sb) > limit)
    fe, streams, warm_s, awall, alaunches, _ = _async_run(torch, aeng,
                                                          prompts, new)
    a = _engine_summary(aeng.stats, awall)
    outs = {i: list(h.req.output) for i, h in enumerate(streams)}
    eager = _eager_rows(torch, aeng, recorded, new)
    same = all([t for t, _ in eager[i]] == outs[i] for i in outs)
    # the steps a request ran in set its state's rounding (the scan's and
    # the chunked wkv's order, a decode token's one-token step or padded
    # chunk), and the async schedule frees a lane a step later than the
    # sync loop: only requests whose schedule did not move are held to the
    # sync run (the async overrun steps past the last token aside)
    moved = sorted(i for i in outs if alayouts.get(i, [])[
        :len(layouts.get(i, []))] != layouts.get(i))
    a.update(runners=fe.warmed_shapes, warmup_s=warm_s,
             graph_pool_gib=aeng.graph_pool_bytes / 2**30,
             aot_misses=aeng.aot_misses, launches=alaunches,
             restores=list(aseen), prefix_hits=aeng.stats.prefix_cache_hits,
             equal_to_eager_replay=same, layout_moved=moved,
             parted_vs_sync=_partings(
                 torch, {i: q for i, q in rows.items() if i not in moved},
                 outs, f"{arch} async vs sync"),
             past_window_launches=dict(apast),
             replay_ms={k: _replay_ms(torch, rn)
                        for k, rn in sorted(_runner_shapes(aeng).items())})
    log(f"recurrent {arch} async: {fe.warmed_shapes} runners in "
        f"{warm_s:.2f} s, graph pool {a['graph_pool_gib']:.3f} GiB, "
        f"{_fmt(a)}, prefix hits {a['prefix_hits']}, first chunks "
        f"{aseen}, aot_misses {aeng.aot_misses}, launches {alaunches}; "
        f"equal to its steps replayed eagerly: {same}; held to the sync run "
        f"but {len(moved)} requests run in other steps {moved}; replay ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in a["replay_ms"].items()))
    check(aeng.aot_misses == 0, f"{arch} async: a step missed its runner")
    check(all(len(o) == new for o in outs.values()),
          f"{arch} async: unfinished")
    check(same, f"{arch} async: tokens differ from its own steps replayed "
          "eagerly")
    check(a["prefix_hits"] > 0 and any(i == hit_i and s > 0
                                       for i, s in aseen),
          f"{arch} async: request {hit_i} did not restore a snapshot")
    if kernels:
        for k in ("kv_cache_write", "flash_chunk_prefill",
                  "paged_pool_decode_visits"):
            check(apast.get(k, 0) > 0, f"{arch} async: {k} never launched "
                  "in a replay past the window and sink page")
    res["async"] = a
    del fe, streams, recorded, eager, aeng, eng
    try:
        Engine(cfg, coopt, dataclasses.replace(ecfg, pack_prefill=True),
               params=params, device=DEV)
    except ValueError as e:
        res["pack_refused"] = str(e)
    check("pack_refused" in res, f"{arch}: pack_prefill did not raise")
    rec.setdefault("recurrent", {})[arch] = res
    total = dict(launches)
    for k, v in alaunches.items():
        total[k] = total.get(k, 0) + v
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total, held or None


def recurrent_phase(torch, rec, time_ms):
    """The recurrent families: K1-K4 at D 256 (``recurrent_kernel_case``),
    then recurrentgemma-9b and rwkv6-7b at full width and depth through
    both engines (``recurrent_runs``). Returns (the D 256 records, the
    launches of the engines' runs, the held summary)."""
    d256 = recurrent_kernel_case(torch, rec, time_ms)
    launches, held = recurrent_runs(torch, rec, RECURRENT_RG)
    rw, _ = recurrent_runs(torch, rec, RECURRENT_RW, kernels=False)
    check(not any(rw.values()), f"rwkv6-7b launched kernels: {rw}")
    rec["recurrent"]["launches"] = launches
    rec["recurrent"]["vs_plain_max_abs_err"] = {
        "flash_chunk_prefill": held["flash_chunk_prefill"]["max_abs_err"],
        "paged_pool_decode_visits":
            held["paged_pool_decode_visits"]["max_abs_err"],
        "paged_pool_decode": held["paged_pool_decode_visits"]["k2_err"]}
    return d256, launches


# ------------------------------------------------------- card vs CPU ----
def _parity_run(torch, cfg, params, dev, prompts, follow=None):
    """``Engine.generate`` with hooks that record, per step, the real-token
    mask, the request of each lane, the router probabilities of each MoE
    call, the logits and each request's emitted (token, logits row).

    ``follow`` (a CPU run's record) plants a mis-route: in every MoE call,
    the first real token of a request whose stream still follows
    ``follow`` has its k-th and (k+1)-th router logits swapped; its site
    (step, call, lane, position) goes to ``planted``."""
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import Engine, EngineConfig
    ecfg = EngineConfig(num_lanes=4, max_len=256,
                        prefill_buckets=(32, 64, 128))
    eng = Engine(cfg, COOPT.replace(use_kernel=True), ecfg, params=params,
                 device=dev)
    run_model, sample, emit = eng._run_model, eng._sample, eng._emit
    route = moe_mod._route
    r = dict(real=[], lanes=[], routes=[], logits=[], emits=[], parted=set(),
             planted=set())

    def capture(sb):
        r["real"].append((sb.batch["slot_idx"] >= 0).cpu())
        r["lanes"].append({w.req.lane: w.req.req_id
                           for w in sb.plan.prefill + sb.plan.decode})
        r["routes"].append([])
        return run_model(sb)

    def keep(logits):
        r["logits"].append(logits.float().cpu())
        r["emits"].append({})
        return sample(logits)

    def note(req, tok, now, first):
        step = len(r["emits"]) - 1
        r["emits"][step][req.req_id] = (tok, r["logits"][step][req.lane])
        if follow and follow["emits"][step][req.req_id][0] != tok:
            r["parted"].add(req.req_id)
        return emit(req, tok, now, first=first)

    def spy(logits, top_k, capacity):
        if follow is not None:
            lanes = r["lanes"][-1]
            for b, s_ in r["real"][-1].nonzero().tolist():
                if b in lanes and lanes[b] not in r["parted"]:
                    order = logits[b, s_].float().sort(
                        descending=True, stable=True).indices
                    i, j = order[top_k - 1], order[top_k]
                    logits = logits.clone()
                    logits[b, s_, i], logits[b, s_, j] = \
                        logits[b, s_, j].clone(), logits[b, s_, i].clone()
                    r["planted"].add((len(r["routes"]) - 1,
                                      len(r["routes"][-1]), b, s_))
                    break
        r["routes"][-1].append(torch.softmax(logits.float(), -1).cpu())
        return route(logits, top_k, capacity)
    eng._run_model, eng._sample, eng._emit = capture, keep, note
    moe_mod._route = spy
    try:
        r["outs"] = eng.generate(prompts, max_new_tokens=24)
    finally:
        moe_mod._route = route
    return r


def _route_flips(torch, card, cpu, k):
    """Compare the top-k expert sets of each request's real tokens (pads
    excluded) in every MoE call, card against CPU, until the request's
    stream parts (both runs schedule the same steps: token values never
    change a plan). Returns {req: [(CPU gap between its k-th and (k+1)-th
    probability, (step, call, lane, position)), ...]} for the tokens whose
    set moved, and the largest |card - CPU| router
    probability over the compared tokens."""
    parted, flips, dp = set(), {}, 0.0
    for step in range(len(cpu["routes"])):
        live = torch.zeros_like(cpu["real"][step])
        for lane, q in cpu["lanes"][step].items():
            live[lane] = q not in parted
        real = cpu["real"][step] & live
        for call, (pa, pb) in enumerate(zip(card["routes"][step],
                                            cpu["routes"][step])):
            if real.any():
                dp = max(dp, (pa - pb).abs()[real].max().item())
            # top-k sets, ties to the lower index
            sa = pa.sort(dim=-1, descending=True, stable=True) \
                .indices[..., :k].sort(-1).values
            srt = pb.sort(dim=-1, descending=True, stable=True)
            sb = srt.indices[..., :k].sort(-1).values
            moved = (sa != sb).any(-1) & real
            gap = srt.values[..., k - 1] - srt.values[..., k]
            for lane, pos in moved.nonzero().tolist():
                flips.setdefault(cpu["lanes"][step][lane], []).append(
                    (gap[lane, pos].item(), (step, call, lane, pos)))
        for q, (t, _) in cpu["emits"][step].items():
            if card["emits"][step][q][0] != t:
                parted.add(q)
    return flips, dp


def parity_phase(torch, rec, arch="qwen3-4b-reduced"):
    """The same weights and prompts through ``Engine.generate`` on the card
    (kernels) and on the CPU (their plain versions). Until a request's
    stream parts, its inputs are equal on both sides, so every logits row
    it emits is held to ``LOGIT_ATOL``, and so is every row of the first
    step. Its first token must be equal; a later token may part only at a
    near-tie of the CPU's logits (``NEAR_TIE``). A MoE router's top-k is
    discontinuous: where two experts' probabilities nearly tie, a last-bit
    difference upstream flips the route and the token's FFN output. A flip
    is allowed only at such a tie (``ROUTE_TIE``); a request's rows from
    the step of its first flip on are then not held, nor is its parting.
    A control run plants mis-routes on the card that the check must flag."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch)
    params_cpu = get_model(cfg).init(seed=3, device="cpu")

    def to_card(t):
        if isinstance(t, dict):
            return {k: to_card(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_card(v) for v in t]
        return t.to(DEV)
    params_gpu = to_card(params_cpu)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 100)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
               for n in (20, 45, 70)] + [rng.integers(0, cfg.vocab_size, 90)]
    cpu = _parity_run(torch, cfg, params_cpu, "cpu", prompts)
    card = _parity_run(torch, cfg, params_gpu, DEV, prompts)
    flips, dp = _route_flips(torch, card, cpu, cfg.top_k)
    first_flip = {q: min(site[0] for _, site in f) for q, f in flips.items()}
    gaps = [g for f in flips.values() for g, _ in f]
    # the first step's rows, every lane but those of a request whose route
    # flipped in it
    flipped0 = {lane for lane, q in cpu["lanes"][0].items()
                if first_flip.get(q) == 0}
    diff0 = max(((card["logits"][0][i] - row).abs().max().item()
                 for i, row in enumerate(cpu["logits"][0])
                 if i not in flipped0), default=0.0)
    scale = cpu["logits"][0].abs().max().item()
    held, parted, excused, bad = 0.0, [], [], []
    for q in sorted({q for e in cpu["emits"] for q in e}):
        steps = [s for s, e in enumerate(cpu["emits"]) if q in e]
        for i, s in enumerate(steps):
            tok, row = cpu["emits"][s][q]
            mine, mrow = card["emits"][s][q]
            if s >= first_flip.get(q, float("inf")):
                excused.append(q)        # rows from its first flip on
                if mine != tok:
                    parted.append(dict(req=q, token=i, route_flip=True))
                break
            held = max(held, (mrow - row).abs().max().item())
            if mine != tok:
                top = row.topk(2).values
                p = dict(req=q, token=i, gap=(top[0] - top[1]).item(),
                         behind=(top[0] - row[mine]).item(),
                         route_flip=False)
                parted.append(p)
                if i == 0 or max(p["gap"], p["behind"]) > NEAR_TIE:
                    bad.append(p)
                break
    toks = [(a == b) for oa, ob in zip(card["outs"], cpu["outs"])
            for a, b in zip(oa, ob)]
    agree = sum(toks) / len(toks)
    res = dict(max_logit_diff=diff0, held_rows_diff=held, logit_max=scale,
               greedy_agreement=agree, parted=parted, rows_not_held=excused)
    line = (f"card vs CPU ({arch}): first-step max |logit diff| {diff0:.4f}, "
            f"rows held until each request parts {held:.4f} (|logit| max "
            f"{scale:.2f}, atol {LOGIT_ATOL}), greedy agreement {agree:.3f}, "
            f"partings (token index, CPU top-2 gap, card pick behind; "
            f"NEAR_TIE {NEAR_TIE}) {parted}")
    if cfg.num_experts:
        plant = _parity_run(torch, cfg, params_gpu, DEV, prompts, follow=cpu)
        pflips, _ = _route_flips(torch, plant, cpu, cfg.top_k)
        pgaps = sorted(g for f in pflips.values() for g, site in f
                       if site in plant["planted"])
        check(pgaps, "no planted mis-route was compared")
        res.update(route_flips=len(gaps), widest_flip_gap=max(gaps, default=0),
                   router_prob_diff=dp, planted_flip_gaps=pgaps)
        line += (f"; MoE route flips {len(gaps)} (widest CPU gap "
                 f"{max(gaps, default=0):.2e}, ROUTE_TIE {ROUTE_TIE:.2e}, max "
                 f"|router prob diff| {dp:.2e}); planted mis-routes: "
                 f"{len(pgaps)} compared, CPU gap min {min(pgaps):.2e} median "
                 f"{pgaps[len(pgaps) // 2]:.2e} max {max(pgaps):.2e}, "
                 f"{sum(g > ROUTE_TIE for g in pgaps)} beyond ROUTE_TIE")
    log(line)
    rec.setdefault("parity", {})[arch] = res
    check(max(diff0, held) <= LOGIT_ATOL, "card and CPU logits differ")
    check(not bad, f"card and CPU part away from a near-tie: {bad}")
    if cfg.num_experts:
        check(max(gaps, default=0) <= ROUTE_TIE,
              "a MoE route flipped away from a tie")
        check(max(pgaps) > ROUTE_TIE, "the route check missed every planted "
              "mis-route")


# the parity phase's reduced configs, card against CPU
# ------------------------------------------------------------ sharded --
# The (m, l) state a kernel returns (``return_state``) against its plain
# version's: m (natural units of the scaled scores) within STATE_M_TOL * (1
# + |m|) -- the scores' f32 sums in another order, and for K3 and K5-K7 one
# f32 rounding of their log2 -> ln conversion -- and l within STATE_L_RTOL
# of |l| (its p's rounded like the outputs' terms); a row that saw no live
# key must report m = -1e30 and l = 0 exactly. The control, the plain
# version with each row's newest key masked off, must exceed the l rule.
STATE_M_TOL = 2 ** -16
STATE_L_RTOL = 2 ** -12
SHARDS = (1, 2, 4)              # 1: the whole pool (the control's case)
PA_NEG = -1e30
STATE_LINES = {"paged_pool_decode": ("paged_gqa_decode", 122),
               "paged_pool_decode_visits": ("paged_gqa_decode", 288),
               "flash_chunk_prefill": ("flash_chunk_prefill", 155),
               "paged_latent_decode": ("paged_latent_decode", 132),
               "paged_latent_decode_visits": ("paged_latent_decode", 277),
               "latent_chunk_prefill": ("latent_chunk_prefill", 150)}
STATE_SOURCES = {"paged_pool_decode": "paged_gqa_decode.cu",
                 "paged_pool_decode_visits": "paged_gqa_decode.cu",
                 "flash_chunk_prefill": "flash_chunk_prefill.cu",
                 "paged_latent_decode": "paged_latent_decode.cu",
                 "paged_latent_decode_visits": "paged_latent_decode.cu",
                 "latent_chunk_prefill": "latent_chunk_prefill.cu"}


def torch_equal(a, b):
    return bool((a == b).all().item()) if a.numel() else True


def state_ratio(got, plain):
    """(m ratio, l ratio) of a kernel's (o, m, l) against its plain
    version's as shares of the state rule (<= 1 passes), and whether the
    rows the plain version reports at m = -1e30 (no live key) are exact in
    the kernel's: m -1e30, the same l (0 where no page was read: then a
    zero output), every output finite."""
    _, m, l = got
    _, mp, lp = plain
    empty = mp == PA_NEG
    rm = ((m - mp).abs() / (STATE_M_TOL * (1 + mp.abs())))[~empty]
    rl = ((l - lp).abs() / (STATE_L_RTOL * lp.abs()))[~empty]
    o = got[0].float()
    unread = empty & (lp == 0)
    sentinel = bool((m[empty] == PA_NEG).all().item()
                    and torch_equal(l[empty], lp[empty])
                    and (o[unread] == 0).all().item()
                    and o.isfinite().all().item())
    return (rm.max().item() if rm.numel() else 0.0,
            rl.max().item() if rl.numel() else 0.0, sentinel)


def _l_control(torch, got, control):
    """The l rule's ratio for the kernel's l against the control's (one key
    dropped), over rows both see as non-empty: must exceed 1."""
    _, m, l = got
    _, mc, lc = control
    ok = (mc != PA_NEG) & (m != PA_NEG)
    return ((l - lc).abs() / (STATE_L_RTOL * lc.abs()))[ok].max().item()


def shard_tables(torch, B, NP, P, shared, seed):
    """Page tables of B lanes, NP pages each, from a pool of P pages (P a
    multiple of 4, its last page reserved): lane 0's pages all in the first
    quarter (so it has none on the other shards of 2 or 4), the others'
    scattered over the rest, lanes 2.. sharing lane 1's first ``shared``
    pages (a prefix for the visit list to read once)."""
    g = torch.Generator().manual_seed(seed)
    q4 = P // 4
    lane0 = torch.randperm(q4, generator=g)[:NP]
    rest = q4 + torch.randperm(P - 1 - q4, generator=g)[:(B - 1) * NP]
    table = torch.cat([lane0, rest]).reshape(B, NP).to(torch.int32)
    table[2:, :shared] = table[1, :shared]
    return table.to(DEV)


def _views(x, first, n):
    return None if x is None else x[first:first + n]


def _shard_runs(torch, P, tables):
    """(shards, shard, first page, pages, the tables translated) for each
    shard of each count in SHARDS."""
    from repro_torch.core.opt_kv import global_to_local_pages
    for n in SHARDS:
        per = P // n
        for s in range(n):
            yield n, s, s * per, per, [
                global_to_local_pages(t, s * per, per) for t in tables]


def _hold_states(torch, rec, key, runs, tol):
    """Hold each kernel of ``runs`` (name -> [(shards, shard, kernel's (o,
    m, l), plain's (o, m, l))]) to its plain version: o within ``tol``,
    (m, l) within the state rule, empty rows exact. Returns {name: worst o
    error}."""
    errs = {}
    for name, cases in runs.items():
        worst = dict(o=0.0, m=0.0, l=0.0, err=0.0, empty_rows=0)
        for n, s, got, plain in cases:
            ro, err = tol_ratio(got[0], plain[0], *tol)
            rm, rl, sentinel = state_ratio(got, plain)
            check(ro <= 1, f"{name} (return_state, {n} shards, shard {s}) "
                  f"differs from its plain version ({key})")
            check(rm <= 1 and rl <= 1, f"{name}: (m, l) outside the state "
                  f"rule ({key}, {n} shards, shard {s}): m {rm:.3f}, l "
                  f"{rl:.3f}")
            check(sentinel, f"{name}: an empty row is not (-1e30, 0) with a "
                  f"zero output ({key}, {n} shards, shard {s})")
            worst = dict(o=max(worst["o"], ro), m=max(worst["m"], rm),
                         l=max(worst["l"], rl), err=max(worst["err"], err),
                         empty_rows=worst["empty_rows"] + int(
                             ((plain[1] == PA_NEG) & (plain[2] == 0))
                             .sum().item()))
        log(f"{name} return_state ({key}, {len(cases)} shard launches over "
            f"{SHARDS} shards): o {worst['o']:.3f} of its tolerance, m "
            f"{worst['m']:.3f}, l {worst['l']:.3f} of the state rule; "
            f"{worst['empty_rows']} rows that read no page, (-1e30, 0) "
            "exact")
        rec.setdefault("state_tolerance", {})[f"{name} {key}"] = worst
        errs[name] = worst["err"]
    return errs


def _state_record(torch, time_ms, name, key, fn, plain, bnd, lib_ms, err,
                  shape, extra=None):
    """A ``return_state`` instantiation's record: its time with and without
    the state (cold L2), the plain version's with it, the bound and the
    library yardstick of the same shape."""
    ms = time_ms(lambda: fn(True))
    ms_off = time_ms(lambda: fn(False))
    plain_ms = time_ms(plain, iters=3, warmup=1)
    lib, line = STATE_LINES[name]
    log(f"  {name}_state ({key}): {ms:.4f} ms with the state, {ms_off:.4f} "
        f"without (+{ms / ms_off - 1:.2%}), plain {plain_ms:.4f}, bound "
        f"{bnd['bound_ms']:.4f} by {bnd['bound_by']} "
        f"({bnd['bound_ms'] / ms:.2%}), library {lib_ms:.4f}")
    return dict(name=name + "_state", route="cuda",
                source="src/repro_torch/kernels/csrc/" + STATE_SOURCES[name],
                replaces=f"src/repro/kernels/{lib}.py:{line}",
                max_abs_err=err, ms=ms, ms_without_state=ms_off,
                state_cost=ms / ms_off - 1, plain_ms=plain_ms, **bnd,
                library_ms=lib_ms, shape=shape, key=key, **(extra or {}))


def _gqa_state_case(torch, rec, time_ms, key, B, Hq, Hkv, D, ps, NP,
                    cache_len, window=0, sink=0, chunk_pos=None, seed=0):
    """K2, K4 (a decode step) and K3 (a mixed step at ``chunk_pos``) with
    ``return_state`` on 1, 2 and 4 shard-local tables of one fp8 pool of
    4 * (NP + 1) pages. Returns ({name: record}, the pool and tables for
    the sharded reads)."""
    import torch.nn.functional as F
    from repro_torch.cache.quant import quantize_fp8
    from repro_torch.core.opt_kv import decode_page_select
    from repro_torch.kernels import flash_chunk_prefill as fc
    from repro_torch.kernels import paged_gqa_decode as pd
    from repro_torch.kernels import visits
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = 4 * (NP + 1)
    kq, ks = quantize_fp8(torch.randn((P, ps, Hkv, D), generator=gen,
                                      device=dev))
    vq, vs = quantize_fp8(torch.randn((P, ps, Hkv, D), generator=gen,
                                      device=dev))
    table = shard_tables(torch, B, NP, P, 4, seed)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    S = chunk_pos.shape[1]
    qc = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(opt_kv=True, opt_gqa=True, window=window, sink_pages=sink)
    phys, logt = decode_page_select(cache_len, table, ps, window=window,
                                    sink_pages=sink, opt_pa=True)
    runs = {"paged_pool_decode": [], "paged_pool_decode_visits": [],
            "flash_chunk_prefill": []}
    bits = True
    for n, s, first, per, (lp, lt) in _shard_runs(torch, P, (phys, table)):
        pool = (_views(kq, first, per), _views(vq, first, per),
                _views(ks, first, per), _views(vs, first, per))
        vp, vm, vl = visits.plan_visits(lp, logt)
        k2 = pd.paged_pool_decode(q, *pool, cache_len, lp, logt, **kw,
                                  return_state=True)
        k4 = pd.paged_pool_decode_visits(q, *pool, cache_len, vp, vm, vl,
                                         **kw, return_state=True)
        k3 = fc.flash_chunk_prefill(qc, chunk_pos, *pool, lt, **kw,
                                    return_state=True)
        runs["paged_pool_decode"].append((n, s, k2, pd.paged_pool_decode_ref(
            q, *pool, cache_len, lp, logt, **kw, return_state=True)))
        runs["paged_pool_decode_visits"].append(
            (n, s, k4, pd.paged_pool_decode_visits_ref(
                q, *pool, cache_len, vp, vm, vl, **kw, return_state=True)))
        runs["flash_chunk_prefill"].append((n, s, k3, fc.flash_chunk_prefill_ref(
            qc, chunk_pos, *pool, lt, **kw, return_state=True)))
        bits &= all(torch.equal(a, b) for a, b in zip(k4, k2))
        if n == 1:         # controls: each row's newest key masked off
            ctl = {"paged_pool_decode": (k2, pd.paged_pool_decode_ref(
                q, *pool, cache_len - 1, lp, logt, **kw, return_state=True)),
                "flash_chunk_prefill": (k3, fc.flash_chunk_prefill_ref(
                    qc, chunk_pos - 1, *pool, lt, **kw, return_state=True))}
    torch.cuda.synchronize()
    errs = _hold_states(torch, rec, key, runs, (ATTN_RTOL, ATTN_ATOL))
    log(f"K4 = K2 bit for bit in (o, m, l) on every shard ({key}): {bits}")
    check(bits, f"K4's (o, m, l) is not K2's bit for bit ({key})")
    for name, (got, c) in ctl.items():
        r = _l_control(torch, got, c)
        log(f"  {name} ({key}) control, one key masked off: l {r:.2f} of "
            "the state rule")
        check(r > 1, f"the state rule passes a one-key mask error in {name} "
              f"({key})")
        rec.setdefault("state_tolerance", {})[f"{name} {key} control"] = r
    # timing at the whole pool (1 shard), the bound, SDPA on the pages
    # gathered and dequantized to bf16
    pool = (kq, vq, ks, vs)
    vp, vm, vl = visits.plan_visits(phys, logt)
    T = NP * ps
    pt = table.long()
    kd = (kq[pt].float() * ks[pt][..., None]).to(torch.bfloat16) \
        .reshape(B, T, Hkv, D).transpose(1, 2).contiguous()
    vd = (vq[pt].float() * vs[pt][..., None]).to(torch.bfloat16) \
        .reshape(B, T, Hkv, D).transpose(1, 2).contiguous()
    kpos = torch.arange(T, device=dev)
    cl = cache_len.long()
    dmask = kpos[None] < cl[:, None]
    if window:
        dmask &= (kpos[None] >= cl[:, None] - window) | (kpos < sink * ps)
    q4 = q[:, :, None, :]
    t_dec = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=dmask[:, None, None, :], enable_gqa=True))
    cp = chunk_pos.long()
    cmask = kpos[None, None] <= cp[..., None]
    if window:
        cmask &= (kpos[None, None] > cp[..., None] - window) | \
            (kpos < sink * ps)
    qc4 = qc.transpose(1, 2).contiguous()
    t_chunk = time_ms(lambda: F.scaled_dot_product_attention(
        qc4, kd, vd, attn_mask=cmask[:, None], enable_gqa=True))
    del kd, vd
    state_b = 8 * B * Hq
    live = torch.unique(phys[phys >= 0]).numel()
    seen = int(dmask.sum().item())
    dec_bytes = 2 * B * Hq * D * 2 + 2 * B * NP * 4 + B * 4 + state_b
    bnd2 = bound(live * 2 * ps * Hkv * (D + 4) + dec_bytes,
                 seen * Hq * D * 4, BF16_FLOPS)
    pages3 = int(cmask.any(1).reshape(B, NP, ps).any(-1).sum().item())
    bnd3 = bound(pages3 * 2 * ps * Hkv * (D + 4) + 2 * B * S * Hq * D * 2 +
                 B * S * 4 + B * NP * 4 + 8 * B * S * Hq,
                 int(cmask.sum().item()) * Hq * D * 4, BF16_FLOPS)
    shape = (f"B={B} Hq={Hq} Hkv={Hkv} D={D} ps={ps} NSel={NP}, pool {P} "
             f"pages, cache_len {cache_len.tolist()}" +
             (f", window {window} + {sink} sink page" if window else ""))
    recs = {
        "paged_pool_decode": _state_record(
            torch, time_ms, "paged_pool_decode", key,
            lambda st: pd.paged_pool_decode(q, *pool, cache_len, phys, logt,
                                            **kw, return_state=st),
            lambda: pd.paged_pool_decode_ref(q, *pool, cache_len, phys, logt,
                                             **kw, return_state=True),
            bnd2, t_dec, errs["paged_pool_decode"], shape),
        "paged_pool_decode_visits": _state_record(
            torch, time_ms, "paged_pool_decode_visits", key,
            lambda st: pd.paged_pool_decode_visits(
                q, *pool, cache_len, vp, vm, vl, **kw, return_state=st),
            lambda: pd.paged_pool_decode_visits_ref(
                q, *pool, cache_len, vp, vm, vl, **kw, return_state=True),
            bnd2, t_dec, errs["paged_pool_decode_visits"],
            shape + f", {int((vp >= 0).sum().item())} visits"),
        "flash_chunk_prefill": _state_record(
            torch, time_ms, "flash_chunk_prefill", key,
            lambda st: fc.flash_chunk_prefill(qc, chunk_pos, *pool, table,
                                              **kw, return_state=st),
            lambda: fc.flash_chunk_prefill_ref(qc, chunk_pos, *pool, table,
                                               **kw, return_state=True),
            bnd3, t_chunk, errs["flash_chunk_prefill"],
            f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} ps={ps} NP={NP}, "
            f"positions to {int(cp.max())}" +
            (f", window {window} + {sink} sink page" if window else "")),
    }
    data = dict(kv=torch.stack([kq, vq]), sc=torch.stack([ks, vs]), q=q,
                qc=qc, pos=chunk_pos, table=table, phys=phys, log=logt,
                cache_len=cache_len, kw=kw)
    return recs, data


def _latent_state_case(torch, rec, time_ms, key="latent", seed=1):
    """K5, K7 (a decode step) and K6 (a mixed step) at deepseek-v2-lite's
    widths with ``return_state`` on 1, 2 and 4 shard-local tables of one
    fp8 latent pool of 68 pages."""
    import torch.nn.functional as F
    from repro_torch.cache.quant import quantize_latent
    from repro_torch.core.opt_kv import decode_page_select
    from repro_torch.kernels import latent_chunk_prefill as lc
    from repro_torch.kernels import paged_latent_decode as ld
    from repro_torch.kernels import visits
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, H, R, dr, ps, NP, S = 4, 16, 512, 64, 64, 16, 512
    W, P = R + dr, 4 * (NP + 1)
    sm_scale = 1.0 / (128 + dr) ** 0.5
    lat_f = torch.randn((P, ps, W), generator=gen, device=dev)
    lat_f[..., R:] *= 3.0
    lat, sc = quantize_latent(lat_f, R)
    del lat_f
    table = shard_tables(torch, B, NP, P, 4, seed)
    cache_len = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32,
                             device=dev)
    ql = torch.randn((B, H, R), generator=gen, device=dev)
    qr = torch.randn((B, H, dr), generator=gen, device=dev)
    qlc = torch.randn((B, S, H, R), generator=gen, device=dev)
    qrc = torch.randn((B, S, H, dr), generator=gen, device=dev)
    pos = torch.empty((B, S), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(512, 1024, device=dev, dtype=torch.int32)
    for b in range(1, B):
        pos[b] = cache_len[b] - 1
    kw = dict(sm_scale=sm_scale, opt_kv=True)
    phys, logt = decode_page_select(cache_len, table, ps, opt_pa=True)
    runs = {"paged_latent_decode": [], "paged_latent_decode_visits": [],
            "latent_chunk_prefill": []}
    bits = True
    for n, s, first, per, (lp, lt) in _shard_runs(torch, P, (phys, table)):
        pool = (_views(lat, first, per), _views(sc, first, per))
        vp, vm, vl = visits.plan_visits(lp, logt)
        k5 = ld.paged_latent_decode(ql, qr, *pool, cache_len, lp, logt, **kw,
                                    return_state=True)
        k7 = ld.paged_latent_decode_visits(ql, qr, *pool, cache_len, vp, vm,
                                           vl, **kw, return_state=True)
        k6 = lc.latent_chunk_prefill(qlc, qrc, pos, *pool, lt, **kw,
                                     return_state=True)
        runs["paged_latent_decode"].append((n, s, k5, ld.paged_latent_decode_ref(
            ql, qr, *pool, cache_len, lp, logt, **kw, return_state=True)))
        runs["paged_latent_decode_visits"].append(
            (n, s, k7, ld.paged_latent_decode_visits_ref(
                ql, qr, *pool, cache_len, vp, vm, vl, **kw,
                return_state=True)))
        runs["latent_chunk_prefill"].append(
            (n, s, k6, lc.latent_chunk_prefill_ref(
                qlc, qrc, pos, *pool, lt, **kw, return_state=True)))
        bits &= all(torch.equal(a, b) for a, b in zip(k7, k5))
        if n == 1:
            ctl = {"paged_latent_decode": (k5, ld.paged_latent_decode_ref(
                ql, qr, *pool, cache_len - 1, lp, logt, **kw,
                return_state=True)),
                "latent_chunk_prefill": (k6, lc.latent_chunk_prefill_ref(
                    qlc, qrc, pos - 1, *pool, lt, **kw, return_state=True))}
    torch.cuda.synchronize()
    errs = _hold_states(torch, rec, key, runs, (LAT_RTOL, LAT_ATOL))
    log(f"K7 = K5 bit for bit in (o, m, l) on every shard ({key}): {bits}")
    check(bits, f"K7's (o, m, l) is not K5's bit for bit ({key})")
    for name, (got, c) in ctl.items():
        r = _l_control(torch, got, c)
        log(f"  {name} ({key}) control, one key masked off: l {r:.2f} of "
            "the state rule")
        check(r > 1, f"the state rule passes a one-key mask error in {name} "
              f"({key})")
        rec.setdefault("state_tolerance", {})[f"{name} {key} control"] = r
    pt = table.long()
    T = NP * ps
    lat_d = (torch.cat([lat[pt][..., :R].float() * sc[pt][..., 0:1],
                        lat[pt][..., R:].float() * sc[pt][..., 1:2]], -1)
             .to(torch.bfloat16).reshape(B, 1, T, W))
    val_d = lat_d[..., :R]
    kpos = torch.arange(T, device=dev)
    dmask = (kpos[None] < cache_len[:, None])[:, None, None, :]
    q_d = torch.cat([ql, qr], -1).to(torch.bfloat16)[:, :, None, :]
    t_dec = time_ms(lambda: F.scaled_dot_product_attention(
        q_d, lat_d, val_d, attn_mask=dmask, scale=sm_scale, enable_gqa=True))
    q6 = torch.cat([qlc, qrc], -1).to(torch.bfloat16).transpose(1, 2) \
        .contiguous()
    cmask = (kpos[None, None] <= pos.long()[..., None])[:, None]
    t_chunk = time_ms(lambda: F.scaled_dot_product_attention(
        q6, lat_d, val_d, attn_mask=cmask, scale=sm_scale, enable_gqa=True))
    del lat_d, val_d, q6
    pool = (lat, sc)
    vp, vm, vl = visits.plan_visits(phys, logt)
    live = torch.unique(phys[phys >= 0]).numel()
    keys = int(cache_len.sum().item())
    bnd5 = bound(live * ps * (W + 8) + B * H * (W + R) * 4 + B * 4 +
                 2 * B * NP * 4 + 8 * B * H, keys * H * (2 * W + 2 * R),
                 BF16_FLOPS)
    ckeys = int((pos.long() + 1).sum().item()) * H
    pages6 = torch.unique(torch.cat([table[b, :int(pos[b].max()) // ps + 1]
                                     for b in range(B)])).numel()
    bnd6 = bound(pages6 * ps * (W + 8) + B * S * H * (W + R) * 4 + B * S * 4
                 + B * NP * 4 + 8 * B * S * H, ckeys * (2 * W + 2 * R),
                 BF16_FLOPS)
    shape = (f"B={B} H={H} R={R} dr={dr} ps={ps} NSel={NP}, pool {P} pages,"
             f" cache_len {cache_len.tolist()}")
    recs = {
        "paged_latent_decode": _state_record(
            torch, time_ms, "paged_latent_decode", key,
            lambda st: ld.paged_latent_decode(ql, qr, *pool, cache_len, phys,
                                              logt, **kw, return_state=st),
            lambda: ld.paged_latent_decode_ref(ql, qr, *pool, cache_len,
                                               phys, logt, **kw,
                                               return_state=True),
            bnd5, t_dec, errs["paged_latent_decode"], shape),
        "paged_latent_decode_visits": _state_record(
            torch, time_ms, "paged_latent_decode_visits", key,
            lambda st: ld.paged_latent_decode_visits(
                ql, qr, *pool, cache_len, vp, vm, vl, **kw, return_state=st),
            lambda: ld.paged_latent_decode_visits_ref(
                ql, qr, *pool, cache_len, vp, vm, vl, **kw,
                return_state=True),
            bnd5, t_dec, errs["paged_latent_decode_visits"],
            shape + f", {int((vp >= 0).sum().item())} visits"),
        "latent_chunk_prefill": _state_record(
            torch, time_ms, "latent_chunk_prefill", key,
            lambda st: lc.latent_chunk_prefill(qlc, qrc, pos, *pool, table,
                                               **kw, return_state=st),
            lambda: lc.latent_chunk_prefill_ref(qlc, qrc, pos, *pool, table,
                                                **kw, return_state=True),
            bnd6, t_chunk, errs["latent_chunk_prefill"],
            f"B={B} S={S} H={H} R={R} dr={dr} ps={ps} NP={NP} (1 chunk "
            "lane, 3 decode lanes)"),
    }
    data = dict(lat=lat, sc=sc, ql=ql, qr=qr, qlc=qlc, qrc=qrc, pos=pos,
                table=table, phys=phys, log=logt, cache_len=cache_len,
                kw=kw)
    return recs, data


# The sharded reads against the unsharded kernels: bf16 partials (K2-K4)
# are each rounded to bf16 before the merge, an error of up to 2^-9 of the
# partial's own magnitude (which cancellation between shards can leave
# above the result's), so |sharded - unsharded| <= SHARD_ATOL + SHARD_RTOL
# |x| (a bf16 ulp at |x| ~ 1 absolute, one relative); the f32 partials of
# the latent kernels (K5-K7) within SHARD_LAT_ATOL + SHARD_LAT_RTOL |x|. A
# control, the unsharded kernel with the last shard's pages dropped from
# the table, must exceed each.
SHARD_RTOL, SHARD_ATOL = 2 ** -7, 2 ** -7
SHARD_LAT_RTOL, SHARD_LAT_ATOL = 2 ** -11, 2 ** -10


def sharded_reads(torch, rec, time_ms, gqa, lat):
    """``kernels.sharded``'s four reads at 4 shards, each a pool of its own
    holding a copy of its range of the one pool, against the unsharded
    kernels on that pool and the same GLOBAL tables (the rule above, beside
    its control), the visit-planned shards against the per-lane ones, and
    the time of the 4 launches and their merge beside the one unsharded
    launch."""
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.core.opt_kv import ShardedPool
    from repro_torch.kernels import ops, sharded
    ctx = sharded.make_ctx(make_sim_mesh(data=4, devices=[DEV] * 4))
    g, la = gqa, lat
    P = g["kv"].shape[1]
    lo = P - P // 4
    # each shard a pool of its own (copies of the one pool's ranges)
    pools = {k: (None if t is None else ShardedPool.split(
        t, ctx.devices, 1 if k in ("kv", "sc") else 0))
        for k, t in (("kv", g["kv"]), ("sc", g["sc"]), ("lat", la["lat"]),
                     ("lsc", la["sc"]))}

    def pool(c, k, t):                 # the shards under a context
        return t if c is None else pools[k]

    def drop(t):                       # the last shard's pages dropped
        return torch.where(t >= lo, -1, t)
    cases = {
        "paged_pool_decode": ((SHARD_RTOL, SHARD_ATOL),
                              lambda c, v, d: ops.paged_pool_decode(
            g["q"], pool(c, "kv", g["kv"]), pool(c, "sc", g["sc"]),
            g["cache_len"], d(g["phys"]), g["log"], **g["kw"],
            share_visits=v)),
        "flash_chunk_prefill": ((SHARD_RTOL, SHARD_ATOL),
                                lambda c, v, d: ops.paged_chunk_prefill(
            g["qc"], g["pos"], pool(c, "kv", g["kv"]),
            pool(c, "sc", g["sc"]), d(g["table"]), **g["kw"])),
        "paged_latent_decode": ((SHARD_LAT_RTOL, SHARD_LAT_ATOL),
                                lambda c, v, d: ops.paged_latent_decode(
            la["ql"], la["qr"], pool(c, "lat", la["lat"]),
            pool(c, "lsc", la["sc"]), la["cache_len"], d(la["phys"]),
            la["log"], **la["kw"], share_visits=v)),
        "latent_chunk_prefill": ((SHARD_LAT_RTOL, SHARD_LAT_ATOL),
                                 lambda c, v, d: ops.latent_chunk_prefill(
            la["qlc"], la["qrc"], la["pos"], pool(c, "lat", la["lat"]),
            pool(c, "lsc", la["sc"]), d(la["table"]), **la["kw"])),
    }
    out = {}
    for name, (tol, fn) in cases.items():
        def run(c, v=False, d=lambda t: t):
            with ops.mesh_ctx_scope(c):
                return fn(c, v, d)
        one, four, four_v = run(None), run(ctx), run(ctx, True)
        ctl = run(None, d=drop)
        torch.cuda.synchronize()
        r, err = tol_ratio(four, one, *tol)
        rv, _ = tol_ratio(four_v, four, *tol)
        rc, _ = tol_ratio(four, ctl, *tol)
        check(r <= 1, f"sharded {name} (4 shards) differs from the "
              "unsharded kernel")
        check(rv <= 1, f"sharded {name}: visit-planned shards differ")
        check(rc > 1, f"the sharded rule passes a dropped shard ({name})")
        ms4, ms1 = time_ms(lambda: run(ctx, True)), time_ms(
            lambda: run(None, True))
        out[name] = dict(ratio=r, max_abs_err=err, visits_ratio=rv,
                         control=rc, ms_4_shards=ms4, ms_unsharded=ms1,
                         tolerance=dict(rtol=tol[0], atol=tol[1]))
        log(f"sharded {name} at 4 shards: max |sharded - unsharded| "
            f"{err:.3e} = {r:.3f} of the rule (rtol {tol[0]}, atol "
            f"{tol[1]}); control, a shard dropped: {rc:.2f}; visit plans "
            f"{rv:.3f}; {ms4:.4f} ms (4 launches and the merge) against "
            f"{ms1:.4f} ms unsharded")
    rec["sharded_reads"] = out


def _in_shard_tables(eng):
    """Wrap ``eng._build_step`` so every step checks that each running
    request's page table lies inside its shard's page range. Returns the
    list of per-step results it fills."""
    import numpy as np
    build, seen = eng._build_step, []

    def checked(plan, device_feed=False):
        mgr = eng.scheduler.manager
        ok = True
        for r in eng.scheduler.running.values():
            lo, hi = mgr.shard_ranges[r.shard]
            t = np.asarray(eng.scheduler.page_table(r))
            live = t[t >= 0]
            ok &= bool(((live >= lo) & (live < hi)).all())
        seen.append(ok)
        return build(plan, device_feed)
    eng._build_step = checked
    return seen


SHARD_WRITE_CONTROLS = 32      # shard writes that also run the drop control


def _hold_shard_writes(torch):
    """Wrap ``kernels.sharded``'s two writes until ``restore()``: after each
    call, every shard's tensor (and its scales) must equal, byte for byte,
    its copy from before the call with the PLAIN GLOBAL write of the same
    inputs applied over the shard's range: each global slot in [first,
    first + n) written at line slot - first, every other slot dropped, by a
    mask (K1's path: ``kv_cache_write_ref``; the latent write: its
    quantizer and a masked scatter). On a call that drops a slot, a
    control that puts the dropped slots on the shard's last line (what the
    global latent write does with them, ``ops.latent_pool_write`` with no
    context; for K1's path, its plain write with those slots moved there)
    must fail that check on each mid-pool shard it runs on: the first
    ``SHARD_WRITE_CONTROLS`` shards whose write drops a slot and keeps none
    on the last line. Returns (the summary, restore)."""
    from repro_torch.cache.quant import quantize_latent
    from repro_torch.kernels import kv_cache_write as kw
    from repro_torch.kernels import ops, sharded
    saved = (sharded.kv_pool_write, sharded.latent_pool_write)
    held = dict(kv_calls=0, kv_equal=0, lat_calls=0, lat_equal=0,
                control_calls=0, control_failed=0)

    def masks(slots, first, n):
        local = slots.reshape(-1).long() - first
        own = (local >= 0) & (local < n) & (slots.reshape(-1) >= 0)
        return local, own

    def same(a, b):
        return a is None or torch.equal(a.view(torch.uint8),
                                        b.view(torch.uint8))

    def control_due():
        return held["control_calls"] < SHARD_WRITE_CONTROLS

    def control(passed):
        # one shard's control: it must not pass the write check
        held.update(control_calls=held["control_calls"] + 1,
                    control_failed=held["control_failed"] + (not passed))

    def drops_to_last(local, own, n):
        # a slot is dropped here and no kept slot writes the last line, so
        # the control's last line must differ from the reference's
        return not bool(own.all()) and not bool((local[own] == n - 1).any())

    def kv_write(ctx, kv_cache, scale_cache, k_new, v_new, slot_idx, *,
                 opt_kv):
        before = [t.clone() for t in kv_cache.shards]
        sbefore = ([t.clone() for t in scale_cache.shards]
                   if scale_cache is not None else None)
        out = saved[0](ctx, kv_cache, scale_cache, k_new, v_new, slot_idx,
                       opt_kv=opt_kv)
        _, _, ps, H, D = kv_cache.shape
        n = kv_cache.pages_per_shard * ps

        def plain(s, slots):
            kv = before[s].clone()
            sc = sbefore[s].clone() if sbefore else None
            f = kv.view(2, n, H, D)
            fs = sc.view(2, n, H) if sc is not None else (None, None)
            kw.kv_cache_write_ref(k_new.to(kv.device), v_new.to(kv.device),
                                  slots.to(torch.int32).view(
                                      slot_idx.shape), f[0], f[1], fs[0],
                                  fs[1], opt_kv=opt_kv)
            return kv, sc
        ok = True
        for s, dev in enumerate(ctx.devices):
            local, own = masks(slot_idx.to(dev), s * n, n)
            ref, rsc = plain(s, torch.where(own, local, -1))
            ok &= same(kv_cache.shards[s], ref)
            ok &= same(None if rsc is None else scale_cache.shards[s], rsc)
            if s < ctx.num_shards - 1 and control_due() and \
                    drops_to_last(local, own, n):
                ctl, csc = plain(s, torch.where(own, local, n - 1))
                control(same(ctl, ref) and same(csc, rsc))
        held.update(kv_calls=held["kv_calls"] + 1,
                    kv_equal=held["kv_equal"] + ok)
        return out

    def lat_write(ctx, lat_cache, scale_cache, latent, slot_idx, *, opt_kv,
                  lora_rank):
        before = [t.clone() for t in lat_cache.shards]
        sbefore = ([t.clone() for t in scale_cache.shards]
                   if scale_cache is not None else None)
        out = saved[1](ctx, lat_cache, scale_cache, latent, slot_idx,
                       opt_kv=opt_kv, lora_rank=lora_rank)
        _, ps, W = lat_cache.shape
        n = lat_cache.pages_per_shard * ps
        new = latent.reshape(-1, W)
        vals, scl = quantize_latent(new, lora_rank) if opt_kv else \
            (new.to(lat_cache.dtype), None)
        ok = True
        for s, dev in enumerate(ctx.devices):
            local, own = masks(slot_idx.to(dev), s * n, n)
            ref = before[s].clone().view(n, W)
            ref[local[own]] = vals.to(dev)[own]
            rsc = None
            if opt_kv:
                rsc = sbefore[s].clone().view(n, 2)
                rsc[local[own]] = scl.to(dev)[own]
            ok &= same(lat_cache.shards[s].view(n, W), ref)
            ok &= same(None if rsc is None else
                       scale_cache.shards[s].view(n, 2), rsc)
            if s < ctx.num_shards - 1 and control_due() and \
                    drops_to_last(local, own, n):
                ctl = before[s].clone()
                csc = sbefore[s].clone() if sbefore else None
                with ops.mesh_ctx_scope(None):      # the global rule
                    ops.latent_pool_write(
                        ctl, csc, latent.to(dev),
                        torch.where(own, local, n).view(slot_idx.shape),
                        opt_kv=opt_kv, lora_rank=lora_rank)
                control(same(ctl.view(n, W), ref) and same(
                    None if csc is None else csc.view(n, 2), rsc))
        held.update(lat_calls=held["lat_calls"] + 1,
                    lat_equal=held["lat_equal"] + ok)
        return out

    def restore():
        sharded.kv_pool_write, sharded.latent_pool_write = saved
    sharded.kv_pool_write, sharded.latent_pool_write = kv_write, lat_write
    return held, restore


def _pool_bytes(eng):
    """(the bytes of the engine's pool leaves, of the same leaves padded
    for one shard, of them padded for the engine's shards) from the
    model's ``cache_shape``."""
    def nbytes(shapes):
        return sum(math.prod(sh) * dt.itemsize
                   for k, (sh, dt, axes) in shapes.items() if "pages" in axes)
    B, M = eng.ecfg.num_lanes, eng.ecfg.max_len
    cc = eng.ccfg
    held = sum(eng.cache[k].nbytes for k in eng._pool_axis)
    return (held, nbytes(eng.model.cache_shape(B, M, eng.coopt,
                                               cache_cfg=cc.replace(
                                                   num_shards=1))),
            nbytes(eng.model.cache_shape(B, M, eng.coopt, cache_cfg=cc)))


def _check_shard_pools(torch, eng, arch):
    """Every pool leaf of a 4-shard mesh engine is four tensors of their
    own, each on its shard's device (distinct allocations, none a view of
    another), holding exactly its page range; their bytes add up to the
    pool padded for the shards. Returns the bytes."""
    from repro_torch.core.opt_kv import ShardedPool
    ctx = eng._kernel_ctx
    for k, ax in eng._pool_axis.items():
        leaf = eng.cache[k]
        check(isinstance(leaf, ShardedPool) and leaf.num_shards == 4,
              f"{arch}: pool leaf {k} is not 4 shards of their own")
        whole = eng.model.cache_shape(eng.ecfg.num_lanes, eng.ecfg.max_len,
                                      eng.coopt, cache_cfg=eng.ccfg)[k][0]
        check(tuple(leaf.shape) == tuple(whole) and all(
            t.device == d and t.untyped_storage().nbytes() == t.nbytes
            and t.shape[ax] == whole[ax] // 4
            for t, d in zip(leaf.shards, ctx.devices))
              and len({t.data_ptr() for t in leaf.shards}) == 4,
              f"{arch}: pool leaf {k}'s shards are not its page ranges on "
              "the mesh's devices")
    held, one, padded = _pool_bytes(eng)
    check(held == padded, f"{arch}: the shards hold {held} bytes, the "
          f"padded pool {padded}")
    devs = [str(d) for d in ctx.devices]
    log(f"{arch}: every pool leaf is 4 tensors on {devs}, {held} bytes in "
        f"all = the pool padded for 4 shards ({padded}; {one} unsharded)")
    return dict(bytes=held, padded_bytes=padded, unsharded_bytes=one)


def _check_shard_peak(torch, eng, arch, peak_ref, peak, pools):
    """The sharded sync run's peak device memory (over the engine's build
    and run, the weights aside) is no more than the unsharded run's plus
    the pools' padding and the merge's temporaries at the largest read:
    the n shards' partials and the f32 sums, (n + 2) x lanes x the largest
    prefill bucket x heads x value width x 4 bytes, and the write checks'
    copies of one layer's shards (2 x pool / layers). A copy of the whole
    pool would add its bytes."""
    cfg, n = eng.cfg, eng._kernel_ctx.num_shards
    width = cfg.kv_lora_rank if cfg.family == "mla" else cfg.head_dim
    merge = ((n + 2) * eng.ecfg.num_lanes * max(eng.ecfg.prefill_buckets)
             * cfg.num_heads * width * 4)
    copies = 2 * pools["bytes"] // cfg.num_layers
    pad = pools["padded_bytes"] - pools["unsharded_bytes"]
    limit = peak_ref + pad + merge + copies
    check(peak <= limit, f"{arch}: the sharded run's peak {peak} bytes is "
          f"above the unsharded run's {peak_ref} plus padding, merge and "
          f"checks ({pad} + {merge} + {copies})")
    log(f"{arch}: peak device memory of the sharded sync run {peak} bytes "
        f"against the unsharded run's {peak_ref} (+{peak - peak_ref}; limit "
        f"+{pad + merge + copies}: padding {pad}, merge {merge}, write "
        f"checks {copies}; the pool is {pools['bytes']})")
    return dict(peak=peak, unsharded_peak=peak_ref, padding=pad,
                merge_slack=merge, check_copies=copies)


def _check_held_writes(held, launches, arch, mla):
    """``_hold_shard_writes``'s summary: every write call of the run held
    (K1's calls a quarter of its launches), every control failed."""
    calls = held["lat_calls"] if mla else held["kv_calls"]
    equal = held["lat_equal"] if mla else held["kv_equal"]
    check(calls > 0 and equal == calls, f"{arch}: {calls - equal} of "
          f"{calls} shard-local writes differ from the plain global write")
    if not mla:
        check(4 * calls == launches.get("kv_cache_write", 0),
              f"{arch}: {calls} writes held, "
              f"{launches.get('kv_cache_write', 0)} K1 launches")
    check(held["control_calls"] > 0
          and held["control_failed"] == held["control_calls"],
          f"{arch}: the drop-to-last-line control passed the write check "
          f"{held['control_calls'] - held['control_failed']} of "
          f"{held['control_calls']} times")
    log(f"{arch}: {equal} of {calls} {'latent' if mla else 'K1'} writes "
        f"(4 shards each) equal byte for byte to the plain global write "
        f"over each shard's range; control, the dropped slots put on a "
        f"mid-pool shard's last line: failed the check on "
        f"{held['control_failed']} of {held['control_calls']} shard writes")
    return dict(held)


def _distinct_card_run(torch, cfg, coopt, ecfg, params, prompts, max_new,
                       rows, arch):
    """Where the machine has 2 or more cards: the sync run again with shard
    s on card s % count, traced; its tokens and logits must equal the
    one-card mesh run's (``rows``) bit for bit, and ``AsyncEngine`` must
    refuse the engine. Returns the card count used (0 with one card), the
    peer copies' time a step."""
    count = torch.cuda.device_count()
    if count < 2:
        return dict(cards=0)
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.serving import AsyncEngine, Engine
    devs = [torch.device("cuda", s % count) for s in range(4)]
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV,
                 mesh=make_sim_mesh(data=4, devices=devs))
    _, rows_d, wall, _, acts = _sync_recorded(torch, eng, prompts, max_new,
                                              traced=True)
    for i, seq in rows.items():
        mine = rows_d.get(i, [])
        check(len(mine) == len(seq) and all(
            a == b and torch.equal(x, y.to(x.device))
            for (a, x), (b, y) in zip(seq, mine)),
              f"{arch}: shards on {min(count, 4)} cards part from the "
              f"one-card mesh at request {i}")
    peer = [(e - b) for b, e, cat, name, _ in acts
            if cat == "gpu_memcpy" and "PtoP" in name]
    steps = _engine_summary(eng.stats, wall)["steps"]
    refused = False
    try:
        AsyncEngine(eng, warmup=False)
    except ValueError:
        refused = True
    check(refused, f"{arch}: AsyncEngine took a mesh across cards")
    out = dict(cards=min(count, 4), steps=steps, peer_copies=len(peer),
               peer_copy_us=sum(peer), peer_copy_us_per_step=sum(peer) / steps)
    log(f"{arch}: shards on {out['cards']} cards: tokens and logits equal "
        f"the one-card mesh bit for bit; {len(peer)} peer copies, "
        f"{out['peer_copy_us_per_step']:.1f} us of card time a step")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


SHARDED_ENGINE = ("qwen3-4b", 36, 32)            # arch, layers, new tokens
SHARDED_MLA = ("deepseek-v2-lite-16b", 4, 16)


def sharded_engine_runs(torch, rec, spec, mla=False):
    """One model at full width on a 4-shard mesh on one card
    (``make_sim_mesh(data=4, devices=[DEV] * 4)``): the unsharded
    ``Engine.generate``, then the mesh's sync engine and
    ``AsyncEngine(warmup=True)`` on the same weights and requests; every
    pool leaf four tensors of their own (``_check_shard_pools``) and the
    sync run's peak memory against the unsharded run's
    (``_check_shard_peak``); every write of the sharded sync run held byte
    for byte to the plain global write over each shard's range, beside its
    drop control (``_hold_shard_writes``); every lane's page table inside
    its shard at every step; the kernels launched per shard (the state
    instantiations, 4 a layer in each replay of a captured step); tokens
    held to the unsharded run's (a MoE model's like for like,
    ``_moe_partings``); with 2 or more cards, the sync run with the shards
    spread over them, bit for bit (``_distinct_card_run``); then a
    one-lane engine at 4 layers (the per-lane decode kernel per shard).
    Returns the launches of the sharded runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig
    arch, layers, max_new = spec
    cfg = get_config(arch).replace(num_layers=layers)
    coopt = COOPT.replace(use_kernel=True)
    ecfg = EngineConfig(num_lanes=4, max_len=1024, seed=0)
    prompts = engine_prompts(cfg)
    params = get_model(cfg).init(0, DEV)
    mesh = make_sim_mesh(data=4, devices=[DEV] * 4)
    res, total = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def fresh_peak():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()
    base = fresh_peak()
    ref = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    lay_ref = _record_layouts(ref)
    _, rows, wall, _, _ = _sync_recorded(torch, ref, prompts, max_new)
    peak_ref = torch.cuda.max_memory_allocated() - base
    res["unsharded_sync"] = _engine_summary(ref.stats, wall)
    del ref
    base = fresh_peak()
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV, mesh=mesh)
    check(eng._kernel_ctx is not None and eng._kernel_ctx.num_shards == 4
          and eng.ccfg.num_shards == 4, "the mesh gave no 4-shard context")
    res["pools"] = _check_shard_pools(torch, eng, arch)
    tables = _in_shard_tables(eng)
    checked = eng._build_step
    lay = _record_layouts(eng)
    held_w, restore_w = _hold_shard_writes(torch)
    try:
        reqs, rows_s, wall, launches, _ = _sync_recorded(torch, eng, prompts,
                                                         max_new)
    finally:
        restore_w()
    add(launches)
    res["peak"] = _check_shard_peak(torch, eng, arch, peak_ref,
                                    torch.cuda.max_memory_allocated() - base,
                                    res["pools"])
    res["writes"] = _check_held_writes(held_w, launches, arch, mla)
    res["sharded_sync"] = dict(_engine_summary(eng.stats, wall),
                               launches=launches,
                               shard_pages=list(eng.stats.shard_pages),
                               peak_shard_pages_in_use=list(
                                   eng.stats.peak_shard_pages_in_use),
                               shard_preemptions=list(
                                   eng.stats.shard_preemptions),
                               placement_prefix_hits=eng.stats
                               .placement_prefix_hits,
                               placement_misses=eng.stats.placement_misses)
    outs = {i: list(r.output) for i, r in enumerate(reqs)}
    if mla:
        moved = sorted(i for i in outs if lay_ref.get(i) != lay.get(i))
        res["sync_parted"] = _partings(
            torch, {i: s for i, s in rows.items() if i not in moved}, outs,
            f"{arch} sharded sync vs unsharded")
        res["sync_layout_moved"] = moved
    else:
        res["sync_parted"] = _partings(torch, rows, outs,
                                       f"{arch} sharded sync vs unsharded")
    # the async engine on the same engine state: graphs of the sharded step
    eng.stats.__init__()
    eng._build_step = checked           # the sync run's layouts are kept
    rec_steps = _record_steps(eng) if mla else None
    lay_async = _record_layouts(eng) if mla else None
    fe, streams, warm_s, wall_a, launches_a, _ = _async_run(
        torch, eng, prompts, max_new)
    add(launches_a)
    aouts = {i: list(s.req.output) for i, s in enumerate(streams)}
    per_runner = {f"{r.kind} {tuple(r.inputs['page_table'].shape)}":
                  dict(r.launches) for r in eng._runners.values()}
    L = cfg.num_layers
    decode_k = "paged_latent_decode_visits_state" if mla else \
        "paged_pool_decode_visits_state"
    chunk_k = "latent_chunk_prefill_state" if mla else \
        "flash_chunk_prefill_state"
    for r in eng._runners.values():
        want = decode_k if r.kind == "decode" else chunk_k
        check(r.launches.get(want, 0) == 4 * L, f"{arch}: a {r.kind} graph "
              f"launches {want} {r.launches.get(want, 0)} times, not 4 a "
              f"layer ({4 * L})")
        unsharded = [n for n in r.launches if not n.endswith("_state")
                     and n != "kv_cache_write" and r.launches[n]]
        check(not unsharded, f"{arch}: a {r.kind} graph launches the "
              f"unsharded {unsharded}")
    if mla:
        res["async_vs"] = _moe_partings(torch, eng, rec_steps, rows_s,
                                        (lay, lay_async), aouts, max_new,
                                        f"{arch} sharded async")
    else:
        res["async_parted"] = _partings(torch, rows, aouts,
                                        f"{arch} sharded async vs unsharded")
    check(all(tables), f"{arch}: a lane's page table left its shard")
    res["sharded_async"] = dict(_engine_summary(eng.stats, wall_a),
                                warmup_s=warm_s, runners=len(eng._runners),
                                launches=launches_a,
                                runner_launches=per_runner,
                                aot_misses=eng.aot_misses)
    check(eng.aot_misses == 0, f"{arch}: an async step found no runner")
    res["steps_in_shard"] = len(tables)
    res["distinct_cards"] = _distinct_card_run(
        torch, cfg, coopt, ecfg, params, prompts, max_new, rows_s, arch)
    for name in (decode_k, chunk_k):
        check(total.get(name, 0) > 0, f"{name} never launched on the "
              f"sharded {arch} engines")
    log(f"{arch} ({L} layers), 4 shards: unsharded sync "
        f"{_fmt(res['unsharded_sync'])}; sharded sync "
        f"{_fmt(res['sharded_sync'])}; sharded async "
        f"{_fmt(res['sharded_async'])}, {len(eng._runners)} graphs "
        f"(warmup {warm_s:.1f} s); {len(tables)} steps, every lane table "
        f"in its shard; shard pages {res['sharded_sync']['shard_pages']}, "
        f"peak in use {res['sharded_sync']['peak_shard_pages_in_use']}")
    del eng, fe
    gc.collect()
    torch.cuda.empty_cache()
    # one lane, 4 layers: the per-lane decode kernel, per shard (a pool of
    # 64 pages, so each shard holds a 1024-token request)
    from repro_torch.configs import CacheConfig
    eng1 = Engine(cfg.replace(num_layers=4), coopt,
                  EngineConfig(num_lanes=1, max_len=1024, seed=1,
                               cache=CacheConfig(num_pages=64)),
                  params=params if layers == 4 else None, device=DEV,
                  mesh=mesh)
    from repro_torch.kernels import cuda
    cuda.reset_launches()
    outs1 = eng1.generate(prompts[:2], max_new_tokens=8)
    torch.cuda.synchronize()
    launches1 = dict(cuda.LAUNCHES)
    add(launches1)
    one = "paged_latent_decode_state" if mla else "paged_pool_decode_state"
    check(all(len(o) == 8 for o in outs1) and launches1.get(one, 0) > 0,
          f"{one} never launched on the one-lane sharded engine")
    res["one_lane_launches"] = launches1
    rec.setdefault("sharded", {})[arch] = res
    del eng1, params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def sharded_phase(torch, rec, time_ms):
    """``--only sharded``: K2-K7 with ``return_state`` against their plain
    versions on 1, 2 and 4 shard-local tables (qwen3-4b's widths, K2-K4
    again at recurrentgemma-9b's D 256 windowed, deepseek-v2-lite's), the
    sharded reads at 4 shards (each a pool of its own) against the
    unsharded kernels, the line ``{"distinct_cards": N}`` (0 with one
    card), then qwen3-4b at full width and depth and deepseek-v2-lite-16b
    at 4 layers on a 4-shard mesh, sync and async. Returns (the state
    instantiations' records, the launches of the sharded engine runs)."""
    dev = torch.device(DEV)
    cl = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32, device=dev)
    pos = torch.empty((4, 512), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(512, 1024, device=dev, dtype=torch.int32)
    for b in range(1, 4):
        pos[b] = cl[b] - 1
    recs, gqa = _gqa_state_case(torch, rec, time_ms, "decode", 4, 32, 8, 128,
                                64, 16, cl, chunk_pos=pos, seed=30)
    cl256 = (48 * 64 - torch.arange(4, device=dev) * 37).to(torch.int32)
    pos256 = torch.empty((4, 512), dtype=torch.int32, device=dev)
    pos256[0] = torch.arange(2560, 3072, device=dev, dtype=torch.int32)
    for b in range(1, 4):
        pos256[b] = cl256[b] - 1
    recs256, _ = _gqa_state_case(torch, rec, time_ms, "d256", 4, 16, 1, 256,
                                 64, 48, cl256, window=2048, sink=1,
                                 chunk_pos=pos256, seed=31)
    for name, r in recs256.items():
        recs[name]["shapes"] = [r]
    lrecs, lat = _latent_state_case(torch, rec, time_ms)
    recs.update(lrecs)
    sharded_reads(torch, rec, time_ms, gqa, lat)
    del gqa, lat
    torch.cuda.empty_cache()
    count = torch.cuda.device_count()
    # with one card the distinct-card runs do not run; say so
    cards = min(count, 4) if count >= 2 else 0
    print(json.dumps({"distinct_cards": cards}), flush=True)
    total = sharded_engine_runs(torch, rec, SHARDED_ENGINE)
    for k, v in sharded_engine_runs(torch, rec, SHARDED_MLA,
                                    mla=True).items():
        total[k] = total.get(k, 0) + v
    return list(recs.values()), total


# ------------------------------------------------- whisper (enc-dec) ----
WHISPER = ("whisper-small", 128, 32, 512)   # arch, shared, new, max_len


def whisper_kernel_case(torch, rec, time_ms):
    """K1-K4 at whisper-small's decoder widths (D 64, Hq = Hkv = 12: G 1,
    pages of 64, 4 lanes of ~1024 cached tokens, a 128-token shared
    prefix): K1 at the mixed step (one 512-token lane, three decode
    tokens), pool bytes and scales equal; K3 on a 512-token chunk at
    [512, 1024) beside 3 decode lanes, held to its plain version beside a
    control (the newest key masked off); K2 and K4 on a decode of the 4
    lanes (K4 = K2 bit for bit), each beside a one-key control. Each with
    its time (cold L2), the plain version's, SDPA's on pre-gathered
    dequantized K/V, the bound, and the registers and local bytes of its
    instantiation. Returns {kernel name: [its D 64 records]}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_chunk_prefill as fc
    from repro_torch.kernels import kv_cache_write as kw
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_gqa_decode as pd
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(24)
    B, Hq, Hkv, D, ps, NP = 4, 12, 12, 64, 64, 16
    rkw = dict(key="d64", label="D 64")
    out = {}
    # ---- K1: the mixed step's writes
    k1 = write_case(torch, time_ms, gen, "d64", B, 512, (512, 1, 1, 1), 512,
                    NP, True, Hkv=Hkv, D=D, ps=ps)
    _, vecs, _ = kw.write_plan(B * 512, Hkv, D)
    out["kv_cache_write"] = [_d256_record(
        k1, "K1 kv_cache_write", kw.kernel_info(D, True, vecs, dev), **rkw)]
    # ---- K2 / K4: a decode of the 4 lanes
    kv, sc, table = paged_pool(torch, gen, B, NP, 2, Hkv, D, ps)
    cache_len = torch.tensor([1024, 1000, 980, 1010], dtype=torch.int32,
                             device=dev)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    fits = pd.plan_fits(B, Hq, Hkv, D, ps, True, True)
    check(fits, "K4's plan at D 64, G 1, 12 kv heads and 4 lanes does not "
          "fit a block")
    for r in decode_step(torch, rec, time_ms, "decode_d64", q, kv, sc, table,
                         cache_len):
        info = pd.kernel_info(D, True, r["name"].endswith("visits"), dev)
        out[r["name"]] = [_d256_record(r, f"{r['name']} (4 lanes)", info,
                                       **rkw)]
    # ---- K3: a 512-token chunk at [512, 1024) beside 3 decode lanes
    S = 512
    qc = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.empty((B, S), dtype=torch.int32, device=dev)
    pos[0] = torch.arange(512, 1024, device=dev, dtype=torch.int32)
    for b in range(1, B):
        pos[b] = cache_len[b] - 1
    kwc = dict(opt_kv=True, opt_gqa=True)
    k3 = ops.paged_chunk_prefill(qc, pos, kv, sc, table, **kwc)
    ref = (qc, pos, kv[0], kv[1], sc[0], sc[1], table)
    p3 = fc.flash_chunk_prefill_ref(*ref, **kwc)
    c3 = fc.flash_chunk_prefill_ref(qc, pos - 1, *ref[2:], **kwc)
    torch.cuda.synchronize()
    r3, err3 = tol_ratio(k3, p3)
    rc3, errc3 = tol_ratio(k3, c3)
    log(f"K3 flash_chunk_prefill at D 64 (G 1, 12 kv heads): max |kernel - "
        f"plain| {err3:.3e} = {r3:.3f} of the tolerance; control, newest "
        f"key masked off: {errc3:.3e} = {rc3:.2f}")
    check(r3 <= 1, "K3 at D 64 differs from its plain version")
    check(rc3 > 1, "the tolerance passes a one-key mask error in K3 at D 64")
    rec.setdefault("tolerance", {}).update(k3_d64=r3, k3_d64_control=rc3)
    qpos = pos.long()
    last_page = qpos.amax(dim=1) // ps
    used = torch.cat([table[b, :int(last_page[b]) + 1] for b in range(B)])
    pages = torch.unique(used).numel()
    keys = int((qpos + 1).sum().item())
    chunk_bytes = pages * 2 * ps * Hkv * (D + 4) + 2 * B * S * Hq * D * 2 + \
        B * S * 4 + B * NP * 4
    bnd = bound(chunk_bytes, keys * Hq * D * 4, BF16_FLOPS)
    pt = table.long()
    kd = (kv[0][pt].float() * sc[0][pt][..., None]).to(torch.bfloat16)
    vd = (kv[1][pt].float() * sc[1][pt][..., None]).to(torch.bfloat16)
    kd = kd.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    vd = vd.reshape(B, NP * ps, Hkv, D).transpose(1, 2).contiguous()
    cmask = (torch.arange(NP * ps, device=dev)[None, None] <=
             pos[:, :, None])[:, None]
    qc4 = qc.transpose(1, 2).contiguous()

    def sdpa_chunk():
        return F.scaled_dot_product_attention(qc4, kd, vd, attn_mask=cmask)
    lib_err = (sdpa_chunk().transpose(1, 2).float() - p3.float()).abs() \
        .max().item()
    k3r = dict(ms=time_ms(lambda: ops.paged_chunk_prefill(
                   qc, pos, kv, sc, table, **kwc)),
               plain_ms=time_ms(lambda: fc.flash_chunk_prefill_ref(
                   *ref, **kwc), iters=3, warmup=1),
               library_ms=time_ms(sdpa_chunk), max_abs_err=err3,
               library="F.scaled_dot_product_attention on pre-gathered "
                       "dequantized bf16 K/V with a causal position mask "
                       f"(max |lib - plain| {lib_err:.3e})",
               shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} ps={ps} NP={NP}",
               **bnd)
    out["flash_chunk_prefill"] = [_d256_record(
        k3r, "K3 flash_chunk_prefill", fc.kernel_info(D, True, ps, dev),
        **rkw)]
    rec["d64"] = out
    del kv, sc, kd, vd
    torch.cuda.empty_cache()
    return out


def whisper_prompts(cfg, shared, rng):
    """8 prompts: 4 share a ``shared``-token prefix (the first alone in the
    first wave of 4 lanes, the other 3 admitted after it, so they hit),
    4 of random lengths."""
    import numpy as np
    prefix = rng.integers(0, cfg.vocab_size, shared)
    share = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
             for n in (0, 40, 200, 7)]
    other = [rng.integers(0, cfg.vocab_size, n) for n in (300, 60, 450, 90)]
    return [share[0]] + other[:3] + share[1:] + other[3:]


def _count_encoder(eng):
    """Count, for the engine's steps, those whose plan holds a first chunk
    and those whose batch carries ``cross_mask`` (each step must carry it
    exactly when it holds a first chunk), and the model's ``encode`` calls
    made from Python (the sync engine's; an async step replays the
    encoder inside its runner's graph). Returns (the counts, undo)."""
    n = dict(encodes=0, cross_mask_steps=0, first_chunk_steps=0,
             mismatched=0)
    model, build = eng.model, eng._build_step

    def encode(params, frames):
        check(frames is eng._frames, "the encoder ran on another buffer "
              "than the engine's zero frames")
        n["encodes"] += 1
        return type(model).encode(model, params, frames)

    def counted_build(plan, device_feed=False):
        sb = build(plan, device_feed)
        first = any(c.first for c in plan.prefill)
        n["first_chunk_steps"] += first
        n["cross_mask_steps"] += "cross_mask" in sb.batch
        n["mismatched"] += first != ("cross_mask" in sb.batch)
        return sb
    model.encode, eng._build_step = encode, counted_build

    def undo():
        del model.encode
        eng._build_step = build
    return n, undo


def _whisper_replays(torch, eng, prompts):
    """Serve ``prompts`` one async step at a time on the calling thread;
    the first prefill step with a first chunk (the encoder on) and the
    first without run eagerly and by replay from the same state: logits,
    pool bytes (the cross K/V leaves included) and lane feed. A prompt
    longer than the token budget left beside another's first chunk gives
    the step without one: its second chunk."""
    import numpy as np
    from repro_torch.serving import Request
    for i, p in enumerate(prompts):
        eng.add_request(Request(req_id=i, prompt=np.asarray(p, np.int32),
                                max_new_tokens=4 + 3 * i,
                                arrival_time=float(i)))
    out = {}
    while eng.scheduler.has_work:
        plan = eng.scheduler.schedule_step()
        if plan.empty:
            continue
        sb = eng._build_step(plan, device_feed=True)
        kind = None if not plan.prefill else \
            "encoder on" if "cross_mask" in sb.batch else "encoder off"
        if kind is not None and kind not in out:
            diff, nbytes, feed, toks = _replay_vs_eager(torch, eng, sb)
            out[kind] = dict(max_logit_diff=diff, pool_bytes_differ=nbytes,
                             lane_feed_equal=feed,
                             rows=int(sb.batch["tokens"].shape[1]))
        else:
            toks = eng._dispatch_async(sb)
        eng._note_executed(sb)
        eng._postprocess(sb, toks.cpu().numpy(), time.perf_counter())
    check(set(out) == {"encoder on", "encoder off"},
          f"whisper replay against eager saw only {sorted(out)} steps")
    for k, r in out.items():
        check(r["max_logit_diff"] == 0 and r["pool_bytes_differ"] == 0
              and r["lane_feed_equal"], f"whisper {k}: the replay differs "
              f"from its eager body {r}")
    return out


def whisper_runs(torch, rec, spec=WHISPER):
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, 1500 frames, vocab 51865), coopt with the kernels, 4 lanes:
    ``Engine.generate`` then ``AsyncEngine(warmup=True)`` on one set of
    weights, 8 greedy requests (``whisper_prompts``), ``new`` tokens each.
    Checks: every request finishes with finite logits; at least one prefix
    hit; the encoder runs exactly on the steps that carry a first chunk;
    K1, K3 and K4 launch in both engines (through replays in the async
    one); 1 + 2 x buckets runners and no step misses one; the async tokens
    equal the sync run's or part at a near-tie; K1, K3 and K4 held to
    their plain versions on engine-built steps; one encoder-on and one
    encoder-off prefill step replayed against its eager body. Returns the
    launches of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig
    arch, shared, new, max_len = spec
    cfg = get_config(arch)
    coopt = COOPT.replace(use_kernel=True)
    ecfg = EngineConfig(num_lanes=4, max_len=max_len, seed=0)
    t0, held0 = time.perf_counter(), torch.cuda.memory_allocated()
    model = get_model(cfg)
    params = model.init(0, DEV)
    torch.cuda.synchronize()
    res = {"layers": (cfg.encoder_layers, cfg.num_layers),
           "params": model.param_count(), "init_s": time.perf_counter() - t0,
           "weights_gib": (torch.cuda.memory_allocated() - held0) / 2**30}
    import numpy as np
    prompts = whisper_prompts(cfg, shared, np.random.default_rng(24))
    res["prompt_tokens"] = [len(p) for p in prompts]
    cross = sum(math.prod(sh) * torch.empty((), dtype=dt).element_size()
                for k, (sh, dt, _) in model.cache_shape(
                    ecfg.num_lanes, max_len, coopt).items()
                if k in model.cross_leaves)
    res["cross_kv_bytes"] = cross
    log(f"whisper {arch}: {cfg.encoder_layers} + {cfg.num_layers} layers, "
        f"{res['params'] / 1e6:.1f} M params in {res['init_s']:.1f} s; "
        f"prompts {res['prompt_tokens']} (4 share {shared} tokens) + {new} "
        f"new; cross K/V {cross / 2**20:.1f} MiB for 4 lanes")
    # ---- sync
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    n_sync, undo = _count_encoder(eng)
    got, restore = _capture_kernel_inputs(
        torch, lambda a, kw: int(a[1].max()) > shared and a[0].shape[1] > 1)
    got1, restore1 = _capture_write_inputs(
        torch, lambda a: a[2].shape[1] > 1 and int(a[4].max()) >= 0)
    try:
        reqs, rows, wall, launches, _ = _sync_recorded(torch, eng, prompts,
                                                       new)
    finally:
        restore()
        restore1()
        undo()
    r = _engine_summary(eng.stats, wall)
    r.update(launches=launches, prefix_hits=eng.stats.prefix_cache_hits,
             encoder=dict(n_sync))
    log(f"whisper sync: {_fmt(r)}, prefix hits {r['prefix_hits']}, encoder "
        f"{n_sync}, launches {launches}")
    check(all(len(q.output) == new for q in reqs), "whisper sync: unfinished")
    check(all(bool(torch.isfinite(row).all()) for seq in rows.values()
              for _, row in seq), "whisper sync: non-finite logits")
    check(r["prefix_hits"] > 0, "whisper sync: no prefix hit")
    check(n_sync["encodes"] == n_sync["cross_mask_steps"]
          == n_sync["first_chunk_steps"] > 0 and not n_sync["mismatched"],
          "whisper sync: the encoder did not run exactly on the first-chunk "
          f"steps {n_sync}")
    for k in ("kv_cache_write", "flash_chunk_prefill",
              "paged_pool_decode_visits"):
        check(launches.get(k, 0) > 0, f"whisper sync: {k} never launched")
    held = _hold_to_plain(torch, got, "whisper sync")
    held["kv_cache_write"] = _hold_k1(torch, got1, "whisper sync")
    del got, got1
    res["sync"] = r
    # ---- async
    aeng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    n_async, undo = _count_encoder(aeng)
    try:
        fe, streams, warm_s, awall, alaunches, _ = _async_run(
            torch, aeng, prompts, new)
    finally:
        undo()
    a = _engine_summary(aeng.stats, awall)
    outs = {i: list(h.req.output) for i, h in enumerate(streams)}
    nb = len(aeng.scheduler.prefill_buckets)
    replay = {}
    for rn in aeng._runners.values():
        tok = rn.inputs["token" if rn.kind == "decode" else "tokens"]
        enc = " + encoder" if "cross_mask" in rn.inputs else ""
        replay[f"{rn.kind} {tok.shape[0]} x {tok.shape[1]}{enc}"] = \
            _replay_ms(torch, rn)
    a.update(runners=fe.warmed_shapes, buckets=nb, warmup_s=warm_s,
             graph_pool_gib=aeng.graph_pool_bytes / 2**30,
             aot_misses=aeng.aot_misses, launches=alaunches,
             prefix_hits=aeng.stats.prefix_cache_hits, encoder=dict(n_async),
             parted_vs_sync=_partings(torch, rows, outs,
                                      "whisper async vs sync"),
             replay_ms=replay)
    log(f"whisper async: {fe.warmed_shapes} runners ({nb} buckets) in "
        f"{warm_s:.2f} s, graph pool {a['graph_pool_gib']:.3f} GiB, "
        f"{_fmt(a)}, prefix hits {a['prefix_hits']}, aot_misses "
        f"{aeng.aot_misses}, encoder {n_async}, launches {alaunches}; replay "
        "ms " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(replay.items())))
    check(fe.warmed_shapes == 1 + 2 * nb, f"whisper async: "
          f"{fe.warmed_shapes} runners, not 1 + 2 x {nb}")
    check(aeng.aot_misses == 0, "whisper async: a step missed its runner")
    check(all(len(o) == new for o in outs.values()),
          "whisper async: unfinished")
    check(a["prefix_hits"] > 0, "whisper async: no prefix hit")
    check(n_async["mismatched"] == 0 and n_async["first_chunk_steps"] > 0,
          "whisper async: a step carried cross_mask without a first chunk "
          f"or the reverse {n_async}")
    for k in ("kv_cache_write", "flash_chunk_prefill",
              "paged_pool_decode_visits"):
        check(alaunches.get(k, 0) > 0, f"whisper async: {k} never launched")
    rng = np.random.default_rng(25)
    a["replay_vs_eager"] = _whisper_replays(
        torch, aeng, [rng.integers(0, cfg.vocab_size, n) for n in (450, 300)])
    log(f"whisper replay vs eager: {a['replay_vs_eager']}")
    res["async"] = a
    res["vs_plain"] = held
    rec["whisper"] = res
    total = dict(launches)
    for k, v in alaunches.items():
        total[k] = total.get(k, 0) + v
    del fe, streams, aeng, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return total, held


def whisper_phase(torch, rec, time_ms):
    """``--only whisper``: K1-K4 at D 64 (``whisper_kernel_case``), then
    whisper-small through both engines (``whisper_runs``). Returns (the
    D 64 records, the launches of the engine runs)."""
    d64 = whisper_kernel_case(torch, rec, time_ms)
    launches, held = whisper_runs(torch, rec)
    rec["whisper"]["launches"] = launches
    rec["whisper"]["vs_plain_max_abs_err"] = {
        "flash_chunk_prefill": held["flash_chunk_prefill"]["max_abs_err"],
        "paged_pool_decode_visits":
            held["paged_pool_decode_visits"]["max_abs_err"],
        "paged_pool_decode": held["paged_pool_decode_visits"]["k2_err"]}
    return d64, launches


# ------------------------------------------------ the host-DRAM tier ----
# the reference's memory-pressure cell (tests/test_host_tier.py) at pages
# of 64: 8 distinct 3-page prefixes with half-page tails, replayed A..H
# A..H, on a 13-page device pool (12 usable) with 2 lanes: every reuse
# distance (8 requests, 24 prefix pages) exceeds the pool
HOST = dict(arch="qwen3-4b", num_pages=13, host_pages=64, prefetch_depth=2,
            prefix=192, tail=32, new=8, lanes=2, max_len=512)


def host_prompts(vocab, prefix, tail, k=8, rounds=2, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    heads = [rng.integers(10, vocab, prefix) for _ in range(k)]
    return [np.concatenate([h, rng.integers(10, vocab, tail)])
            for _ in range(rounds) for h in heads]


def _host_engine(cfg, coopt, params, host_pages, spec=HOST, **kw):
    from repro_torch.configs import CacheConfig
    from repro_torch.serving import Engine, EngineConfig
    cc = CacheConfig(num_pages=spec["num_pages"], host_pages=host_pages,
                     prefetch_depth=spec["prefetch_depth"], **kw)
    return Engine(cfg, coopt, EngineConfig(num_lanes=spec["lanes"],
                                           max_len=spec["max_len"], seed=0,
                                           cache=cc),
                  params=params, device=DEV)


def _spy_tier(torch, eng):
    """Keep, on the card, the pool bytes of every page a spill reads (by
    chain hash, cloned at the spill, before any later step) and of every
    staging page right after its upload (cloned after the upload's copies,
    on the same stream). Returns (spilled {hash: [bytes]}, uploaded [(hash,
    bytes)], [(the bytes a spill read, the host page it returned)])."""
    mgr = eng.scheduler.manager
    spill, begin, upload = mgr.spill_sink, mgr.begin_prefetch, \
        eng._upload_page
    spilled, uploaded, pages, pending = {}, [], [], {}

    def page_bytes(page):
        return {k: v.clone() for k, v in eng._read_pool_page(page).items()}

    def spill_page(h, page, shard):
        spilled.setdefault(h, []).append(page_bytes(page))
        hp = spill(h, page, shard)
        if hp is not None:
            pages.append((spilled[h][-1], hp))
        return hp

    def begin_prefetch(h, shard):
        page, payload = begin(h, shard)
        pending[page] = h
        return page, payload

    def upload_page(hp, page):
        upload(hp, page)
        uploaded.append((pending.pop(page), page_bytes(page)))
    mgr.spill_sink, mgr.begin_prefetch, eng._upload_page = \
        spill_page, begin_prefetch, upload_page
    return spilled, uploaded, pages


def _copy_rates(torch, eng, pages=32):
    """The tier's copies on an idle engine, per page: ``pages`` spills
    (device to pinned host) then their uploads (host to device) back into
    the same pages, each direction timed on the host clock around its
    calls and a synchronize, and under ``_device_trace`` for the card's
    copy time. A spill into fresh pinned memory pays its allocation; the
    traced spills run again after the first ones' buffers were freed, on
    the caching host allocator's blocks (``spill_warm_us_a_page``).
    Returns µs a page and GB/s both ways, and the bytes a page."""
    ids = list(range(min(pages, eng.scheduler.manager.num_pages - 1)))
    pages = len(ids)
    spill = type(eng)._spill_page.__get__(eng)      # past any spy
    upload = type(eng)._upload_page.__get__(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hps = [spill(0, p, 0) for p in ids]
    torch.cuda.synchronize()
    spill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for hp, p in zip(hps, ids):
        upload(hp, p)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    nbytes = hps[0].nbytes
    pinned = all(v.is_pinned() for hp in hps for v in hp.leaves.values())
    warm = [spill(0, p, 0) for p in ids]      # the blocks stay cached
    del warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = [spill(0, p, 0) for p in ids]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del warm
    torch.cuda.synchronize()
    _, acts = _device_trace(torch, lambda: [spill(0, p, 0) for p in ids])
    d2h = sum(e - s for s, e, c, n, _ in acts if c == "gpu_memcpy")
    _, acts = _device_trace(torch, lambda: [upload(hp, p)
                                            for hp, p in zip(hps, ids)])
    h2d = sum(e - s for s, e, c, n, _ in acts if c == "gpu_memcpy")
    res = dict(pages=pages, bytes_a_page=nbytes, pinned=pinned,
               spill_us_a_page=spill_s / pages * 1e6,
               spill_warm_us_a_page=warm_s / pages * 1e6,
               upload_us_a_page=upload_s / pages * 1e6,
               spill_gb_s=nbytes * pages / spill_s / 1e9,
               upload_gb_s=nbytes * pages / upload_s / 1e9,
               spill_copy_us_a_page=d2h / pages,
               upload_copy_us_a_page=h2d / pages,
               spill_copy_gb_s=nbytes * pages / d2h / 1e3 if d2h else None,
               upload_copy_gb_s=nbytes * pages / h2d / 1e3 if h2d else None)
    log(f"host tier copies: {nbytes / 2**20:.2f} MiB a page (pinned "
        f"{pinned}); spill {res['spill_us_a_page']:.1f} us a page on the "
        f"host clock ({res['spill_gb_s']:.2f} GB/s; on cached pinned blocks "
        f"{res['spill_warm_us_a_page']:.1f} us), the card's copies "
        f"{res['spill_copy_us_a_page']:.1f} us; upload "
        f"{res['upload_us_a_page']:.1f} us a page ({res['upload_gb_s']:.2f} "
        f"GB/s), the card's copies {res['upload_copy_us_a_page']:.1f} us")
    check(pinned, "a spilled page's host payload is not pinned")
    return res


def _tier_stats(st):
    return {k: getattr(st, k) for k in (
        "prefix_cache_queries", "prefix_cache_hits", "prefix_device_hits",
        "prefix_host_hits", "spilled_pages", "host_evictions",
        "host_pages_resident", "prefetch_begun", "prefetch_committed",
        "prefetch_aborted", "prefetches_planned", "prefetch_held_turns",
        "prefetch_replans", "preemptions")} | dict(
            hit_rate=st.prefix_hit_rate(),
            host_hit_rate=st.prefix_host_hit_rate())


def _drained(eng, what):
    mgr = eng.scheduler.manager
    audit = mgr.audit()
    check(audit == [] and mgr.pages_in_use == 0 and mgr.staging_pages == 0
          and eng._prefetch_flights == [], f"{what}: not drained clean "
          f"(audit {audit[:3]}, {mgr.pages_in_use} pages in use, "
          f"{mgr.staging_pages} staging, {len(eng._prefetch_flights)} "
          "flights)")


def host_runs(torch, rec, spec=HOST):
    """qwen3-4b at full width and depth, coopt with the kernels, in the
    memory-pressure cell (``HOST``): ``Engine.generate`` with the tier on
    (spills and uploads spied: every uploaded page must equal, byte for
    byte, the bytes its spill read) and off; the tier's counts, the hit
    rate on above off, both drained clean, the tokens on against off equal
    or parted at a near-tie. The copies' rates on the idle engine. Then
    ``AsyncEngine(warmup=True)`` with the tier on and off, each served
    under the profiler: no runner missed, the card's idle share. Returns
    the launches of the runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    cfg = get_config(spec["arch"])
    coopt = COOPT.replace(use_kernel=True)
    t0 = time.perf_counter()
    params = get_model(cfg).init(0, DEV)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0, "layers": cfg.num_layers,
           "spec": dict(spec)}
    prompts = host_prompts(cfg.vocab_size, spec["prefix"], spec["tail"])
    new = spec["new"]
    log(f"host tier {spec['arch']}: {cfg.num_layers} layers, "
        f"{len(prompts)} prompts of {len(prompts[0])} tokens (8 prefixes "
        f"of {spec['prefix']} replayed twice) + {new} new, a "
        f"{spec['num_pages']}-page pool, {spec['host_pages']} host pages")
    total, marks = {}, res.setdefault("s", {})

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def mark(what, t=[time.perf_counter()]):
        now = time.perf_counter()
        marks[what], t[0] = now - t[0], now
    # ---- sync, tier on (spied) and off
    on = _host_engine(cfg, coopt, params, spec["host_pages"], spec)
    spilled, uploaded, _ = _spy_tier(torch, on)
    reqs, on_rows, wall, launches, _ = _sync_recorded(torch, on, prompts,
                                                      new)
    add(launches)
    s_on = _engine_summary(on.stats, wall) | _tier_stats(on.stats)
    same = [all(torch.equal(got[k].view(torch.uint8),
                            spilled[h][-1][k].view(torch.uint8))
                for k in got) for h, got in uploaded]
    s_on.update(uploads_checked=len(same), uploads_equal=sum(same),
                launches=launches)
    _drained(on, "host tier on, sync")
    off = _host_engine(cfg, coopt, params, 0, spec)
    _, off_rows, owall, olaunches, _ = _sync_recorded(torch, off, prompts,
                                                      new)
    add(olaunches)
    s_off = _engine_summary(off.stats, owall) | _tier_stats(off.stats)
    _drained(off, "host tier off, sync")
    outs = {i: list(q.output) for i, q in enumerate(reqs)}
    s_on["parted_vs_off"] = _partings(torch, off_rows, outs,
                                      "host tier on vs off")
    log(f"host tier sync on: {_fmt(s_on)}; {_tier_stats(on.stats)}; "
        f"{sum(same)} of {len(same)} uploaded pages equal their spilled "
        f"bytes")
    log(f"host tier sync off: {_fmt(s_off)}; hit rate "
        f"{s_off['hit_rate']:.4f}")
    check(s_on["prefix_host_hits"] > 0 and s_on["spilled_pages"] > 0
          and s_on["prefetch_committed"] > 0, f"host tier on: the tier did "
          f"not work {_tier_stats(on.stats)}")
    check(s_on["hit_rate"] > s_off["hit_rate"], "host tier on: the hit rate "
          f"{s_on['hit_rate']} is not above the tier off's "
          f"{s_off['hit_rate']}")
    check(len(same) == s_on["prefetch_begun"] > 0 and all(same),
          f"host tier: {len(same) - sum(same)} of {len(same)} uploaded "
          "pages differ from their spilled bytes")
    res["sync_on"], res["sync_off"] = s_on, s_off
    del spilled, uploaded
    mark("sync")
    res["copies"] = _copy_rates(torch, on)
    mark("copies")
    del on, off
    gc.collect()
    torch.cuda.empty_cache()
    # ---- async, tier on and off, traced
    for name, hp in (("async_on", spec["host_pages"]), ("async_off", 0)):
        eng = _host_engine(cfg, coopt, params, hp, spec)
        fe, streams, warm_s, awall, alaunches, acts = _async_run(
            torch, eng, prompts, new, traced=True)
        add(alaunches)
        a = _engine_summary(eng.stats, awall) | _tier_stats(eng.stats)
        a.update(runners=fe.warmed_shapes, aot_misses=eng.aot_misses,
                 launches=alaunches,
                 card=_card_share(acts, awall, alaunches,
                                  f"host tier {name}"))
        outs = {i: list(h.req.output) for i, h in enumerate(streams)}
        a["parted_vs_sync_on"] = _partings(torch, on_rows, outs,
                                           f"host tier {name} vs sync on")
        log(f"host tier {name}: {fe.warmed_shapes} runners, {_fmt(a)}, "
            f"aot_misses {eng.aot_misses}, the card idle "
            f"{a['card']['idle_share']:.2%} of {awall:.2f} s; "
            f"{_tier_stats(eng.stats)}")
        check(eng.aot_misses == 0, f"host tier {name}: a step missed its "
              "runner")
        check(all(len(o) == new for o in outs.values()),
              f"host tier {name}: unfinished")
        if hp:
            check(a["prefix_host_hits"] > 0 and a["prefetch_committed"] > 0,
                  f"host tier {name}: the tier did not work")
        _drained(eng, f"host tier {name}")
        res[name] = a
        del fe, streams, eng, acts
        mark(name)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res, total


def host_quant_case(torch, rec, spec=HOST, layers=4):
    """``host_quant`` in ORIGINAL mode (a bf16 pool) at ``layers`` layers of
    qwen3-4b: the memory-pressure cell with fp8-encoded host pages. Every
    spilled page is encoded, its host bytes about half the page's (fp8
    codes plus one f32 scale a vector), each leaf's roundtrip error under
    the reference's 0.2, and uploads dequantize into the staging pages
    (the tier's hits > 0)."""
    from repro_torch.cache import quant
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import ORIGINAL
    cfg = get_config(spec["arch"]).replace(num_layers=layers)
    coopt = ORIGINAL.replace(use_kernel=True)
    eng = _host_engine(cfg, coopt, None, spec["host_pages"], spec,
                       host_quant=True)
    _, _, pairs = _spy_tier(torch, eng)
    prompts = host_prompts(cfg.vocab_size, spec["prefix"], spec["tail"])
    eng.generate(prompts, max_new_tokens=4)
    torch.cuda.synchronize()
    check(pairs and all(hp.encoded for _, hp in pairs), "host_quant: a "
          "spilled page was not encoded")
    raw = sum(v.numel() * v.element_size() for v in pairs[0][0].values())
    # each spilled page's values against its decoded host copy, relative
    # to each vector's largest magnitude (the reference's bound: 0.2)
    errs, rts = [], []
    for page, hp in pairs[:8]:
        for k in hp.leaves:
            x = page[k].float()
            y = quant.decode_host_page(hp, k, dtype=torch.float32).to(DEV)
            errs.append(((y - x).abs() / x.abs().amax(-1, keepdim=True)
                         .clamp_min(1e-12)).max().item())
            rts.append(quant.quant_roundtrip_error(page[k]).item())
    res = dict(layers=layers, spilled=len(pairs), page_bytes=raw,
               host_bytes=pairs[0][1].nbytes,
               ratio=pairs[0][1].nbytes / raw, max_decoded_err=max(errs),
               max_roundtrip_err=max(rts),
               prefix_host_hits=eng.stats.prefix_host_hits,
               prefetch_committed=eng.stats.prefetch_committed)
    log(f"host_quant (ORIGINAL, {layers} layers): {len(pairs)} pages "
        f"spilled encoded, {res['host_bytes']} host bytes a page for {raw} "
        f"in the pool ({res['ratio']:.3f}); decoded vs spilled "
        f"{res['max_decoded_err']:.4f}, quant_roundtrip_error "
        f"{res['max_roundtrip_err']:.4f} of a vector's largest magnitude; "
        f"host hits {res['prefix_host_hits']}")
    check(res["ratio"] < 0.55, f"host_quant: the host page is {res['ratio']}"
          " of the pool page's bytes")
    check(res["max_decoded_err"] < 0.2 and res["max_roundtrip_err"] < 0.2,
          "host_quant: a roundtrip error reaches the reference's 0.2")
    check(res["prefix_host_hits"] > 0, "host_quant: no host hit")
    _drained(eng, "host_quant")
    del eng, pairs
    torch.cuda.empty_cache()
    return res


def host_chaos_case(torch, rec, layers=4, arch="qwen3-4b"):
    """The reference's tier chaos episode (tests/test_resilience.py) at
    ``layers`` layers of qwen3-4b, coopt with the kernels, under
    ``AsyncEngine``: a 5-page pool, 32 host pages, 6 one-page prefixes
    replayed twice; spills 2-4 dropped and the first prefetch failed.
    Every stream ends FINISHED, its tokens equal the fault-free tier run's
    (sync) or part at a near-tie, no staging page or flight is left and
    the audit is clean."""
    import numpy as np
    from repro_torch.configs import CacheConfig, get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.serving import (AsyncEngine, Engine, EngineConfig,
                                     FaultInjector, FaultPlan, FinishReason)
    cfg = get_config(arch).replace(num_layers=layers)
    coopt = COOPT.replace(use_kernel=True)
    ecfg = EngineConfig(num_lanes=2, max_len=128,
                        prefill_buckets=(32, 64, 128),
                        cache=CacheConfig(num_pages=5, host_pages=32,
                                          prefetch_depth=2))
    params = None
    rng = np.random.default_rng(83)
    heads = [rng.integers(0, cfg.vocab_size, 64) for _ in range(6)]
    prompts = [np.concatenate([h, rng.integers(0, cfg.vocab_size, 16)])
               for _ in range(2) for h in heads]
    ref = Engine(cfg, coopt, ecfg, device=DEV)
    params = ref.params
    _, rows, _, _, _ = _sync_recorded(torch, ref, prompts, 8)
    check(ref.stats.spilled_pages > 0, "host chaos: the fault-free run did "
          "not spill")
    eng = Engine(cfg, coopt, ecfg, params=params, device=DEV)
    inj = FaultInjector(FaultPlan(seed=83, spill_drop_at=2,
                                  spill_drop_count=3, prefetch_fail_at=1,
                                  prefetch_fail_count=1)).install(eng)
    fe = AsyncEngine(eng, warmup=True)
    streams = [fe.submit(p, max_new_tokens=8) for p in prompts]
    fe.run_until_idle()
    fe.close()
    outs = {i: list(s.req.output) for i, s in enumerate(streams)}
    res = dict(spills=inj.spills, spill_drops=inj.injected_spill_drops,
               prefetches=inj.prefetches,
               prefetch_fails=inj.injected_prefetch_fails,
               finished=sum(s.finish_reason is FinishReason.FINISHED
                            for s in streams),
               equal=sum(outs[i] == [t for t, _ in rows[i]] for i in outs),
               parted=_partings(torch, rows, outs, "host chaos vs fault-free"),
               aot_misses=eng.aot_misses)
    log(f"host chaos ({layers} layers, async): {res}")
    check(res["finished"] == len(streams), "host chaos: a stream did not "
          "finish")
    check(res["spill_drops"] == 3 and res["prefetch_fails"] == 1,
          f"host chaos: the faults were not all injected {res}")
    _drained(eng, "host chaos")
    del ref, eng, fe, params
    torch.cuda.empty_cache()
    return res


def host_phase(torch, rec):
    """``--only host``: the memory-pressure cell on qwen3-4b (``host_runs``),
    ``host_quant`` on a bf16 pool and the chaos episode at 4 layers.
    Returns the launches of the engine runs."""
    res, launches = host_runs(torch, rec)
    t0 = time.perf_counter()
    res["host_quant"] = host_quant_case(torch, rec)
    res["s"]["host_quant"] = time.perf_counter() - t0
    res["chaos"] = host_chaos_case(torch, rec)
    res["s"]["chaos"] = time.perf_counter() - t0 - res["s"]["host_quant"]
    log("host phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in res["s"].items()))
    res["launches"] = launches
    rec["host"] = res
    return launches


# ---------------------------------------------------------------- train --
# The training phase (``--only train``). qwen3-4b at full size, COOPT (the
# reference trainer's mode: no kernel has a backward, so training runs the
# plain path under autograd), B x S tokens of ``TrainPipeline(seed=0)`` a
# step, ``TRAIN_STEPS`` steps at the launcher's learning rate.
TRAIN = ("qwen3-4b", 4, 512, 8, 1e-3)        # arch, batch, seq, steps, lr
TRAIN_MICRO = (4, 4)                          # layers, microbatches
# Card against CPU, the same params and batch: the loss within
# TRAIN_LOSS_ATOL, each leaf's gradient within TRAIN_GRAD_RTOL of the CPU's
# as a relative L2 error; on whisper the leaves whose gradient crosses the
# fp8 cast of the cross K/V (the cross K/V projections and the encoder
# upstream of them: the cotangent is rounded to fp8, as in the JAX
# package) within FP8_PATH_RTOL. The same bounds as the CPU tests against
# the JAX package (tests/test_torch_training.py); measured card against CPU
# on an H100 (PERF.md section 6): 1.04-1.46% for the dense-path models,
# rwkv6 5.41%, whisper 7.82% (dec/xwk, of the fp8 group).
TRAIN_LOSS_ATOL = 1e-2
TRAIN_GRAD_RTOL = {"qwen3-4b-reduced": 0.04,
                   "deepseek-v2-lite-16b-reduced": 0.04,
                   "mixtral-8x22b-reduced": 0.04, "internvl2-2b-reduced": 0.04,
                   "recurrentgemma-9b-reduced": 0.05, "rwkv6-7b-reduced": 0.1,
                   "whisper-small-reduced": 0.075}
FP8_PATH_RTOL = 0.2
# the JAX microbatch test's bounds (tests/test_microbatch.py), which one
# AdamW step meets whatever the gradient (it moves a param by about lr);
# the accumulated gradients are held to MICRO_GRAD_RTOL per leaf (relative
# L2) and the step's grad norm to MICRO_GNORM_RTOL. On the card a quarter
# of the batch takes other GEMM shapes, which round the bf16 activations
# otherwise (measured on an H100: 1.086e-2, PERF.md section 6; the CPU's
# 2.4e-3 in tests/test_torch_train_launch.py): the bound is the card
# against CPU one of this model, TRAIN_GRAD_RTOL; the controls read 1.77
# and 3.0
MICRO_LOSS_ATOL = 5e-3
MICRO_PARAM_TOL = 2e-2
MICRO_GRAD_RTOL = 0.04
MICRO_GNORM_RTOL = 1e-2
# the full-size run's split of a step: TRAIN_SPLIT more steps, each timed
# with CUDA events around its forward + backward and its AdamW update
TRAIN_SPLIT = 5


def grad_tol(arch, path):
    """The relative L2 bound of one leaf's gradient, card against CPU."""
    if arch.startswith("whisper") and (
            path[0] in ("enc", "enc_ln", "enc_ln_b")
            or (path[0] == "dec" and path[1] in ("xwk", "xwv", "xbv"))):
        return FP8_PATH_RTOL
    return TRAIN_GRAD_RTOL[arch]


def _bits(torch, t):
    return t.detach().reshape(-1).view(torch.uint8)


def _rel_l2(torch, got, want):
    d = (got.float() - want.float()).norm().item()
    return d / max(want.float().norm().item(), 1e-30)


def _topk_sets(np, probs, k):
    order = np.argsort(-probs, axis=-1, kind="stable")
    return np.sort(order[..., :k], -1), -np.sort(-probs, -1)


class RouteLog:
    """Records each MoE ``_route`` call's router probabilities (numpy f32),
    forward and recompute alike."""

    def __init__(self, torch, moe_mod):
        self.torch, self.moe, self.calls = torch, moe_mod, []

    def __enter__(self):
        self.orig = self.moe._route
        self.moe._route = self
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig

    def __call__(self, logits, top_k, capacity, with_aux=False):
        self.calls.append(self.torch.softmax(
            logits.detach().float(), -1).cpu().numpy())
        return self.orig(logits, top_k, capacity, with_aux=with_aux)


class TiePin(RouteLog):
    """A MoE router held to a reference run's routes, as the parity phase
    holds it: a token whose top-k expert set differs from the reference's
    (the reference call nearest in value) is a flip. At a near-tie (the
    reference's k-th and (k+1)-th probabilities within ``tie``, one expert
    swapped) the two experts' logits are swapped so this run takes the
    reference's route, and the gap is kept; any other flip is kept as bad.
    With the ties pinned, both runs route every token alike, so their
    gradients compare leaf by leaf."""

    def __init__(self, torch, moe_mod, ref_calls, tie):
        super().__init__(torch, moe_mod)
        self.ref, self.tie = ref_calls, tie
        self.pinned, self.bad = [], []

    def __call__(self, logits, top_k, capacity, with_aux=False):
        import numpy as np
        torch = self.torch
        probs = torch.softmax(logits.detach().float(), -1).cpu().numpy()
        ref = min((r for r in self.ref if r.shape == probs.shape),
                  key=lambda r: np.abs(r - probs).max())
        mine, _ = _topk_sets(np, probs, top_k)
        want, srt = _topk_sets(np, ref, top_k)
        moved = np.argwhere((mine != want).any(-1))
        if len(moved):
            logits = logits.clone()
        for b, s in moved:
            gap = float(srt[b, s, top_k - 1] - srt[b, s, top_k])
            out = sorted(set(mine[b, s]) - set(want[b, s]))
            inn = sorted(set(want[b, s]) - set(mine[b, s]))
            if gap > self.tie or len(out) != 1:
                self.bad.append((gap, int(b), int(s)))
                continue
            self.pinned.append(gap)
            i, j = out[0], inn[0]
            logits[b, s, [i, j]] = logits[b, s, [j, i]]
        self.calls.append(probs)
        return self.orig(logits, top_k, capacity, with_aux=with_aux)


def train_full_run(torch, rec, smi):
    """qwen3-4b at full size through ``Trainer``: TRAIN_STEPS steps on the
    stream, every loss and grad norm finite, the last loss below the first;
    step ms (the median of steps 2..), tokens/s, peak GiB and the model
    FLOPs' share of the bf16 peak. Returns the trainer."""
    import statistics
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.data import TrainPipeline
    from repro_torch.kernels import cuda
    from repro_torch.training import Trainer, adamw_update
    from repro_torch.training.train import step_grads, to_device
    arch, B, S, steps, lr = TRAIN
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, COOPT, lr=lr, seed=0, device=DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = tr.model.param_count()
    pipe = iter(TrainPipeline(cfg.vocab_size, B, S, seed=0))
    cuda.reset_launches()
    hist, times = [], []
    for _ in range(steps):
        batch = next(pipe)
        t0 = time.perf_counter()
        hist.append(tr.step(batch))           # float() of the metrics syncs
        times.append(time.perf_counter() - t0)
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = statistics.median(times[1:])
    # where a step's time goes: TRAIN_SPLIT more steps as ``Trainer.step``
    # runs them (``step_grads``, then ``adamw_update``), with CUDA events
    # before, between and after, and no sync inside: the two parts add up
    # to the step's device time, beside its host time
    split = dict(fwd_bwd_ms=[], adamw_ms=[], device_ms=[], host_ms=[])
    for _ in range(TRAIN_SPLIT):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = to_device(next(pipe), DEV)
        ev[0].record()
        _, grads = step_grads(tr.model, tr.params, batch, tr.coopt)
        ev[1].record()
        tr.params, tr.opt_state, gnorm = adamw_update(
            tr.params, tree_util.unflatten(tr.params, grads), tr.opt_state,
            lr=lr)
        ev[2].record()
        float(gnorm)
        split["host_ms"].append((time.perf_counter() - t0) * 1e3)
        split["fwd_bwd_ms"].append(ev[0].elapsed_time(ev[1]))
        split["adamw_ms"].append(ev[1].elapsed_time(ev[2]))
        split["device_ms"].append(ev[0].elapsed_time(ev[2]))
        del grads
    split_med = {k: statistics.median(v) for k, v in split.items()}
    T = B * S
    # model FLOPs of one step: every parameter but the embedding table in
    # a matmul, 2 FLOPs a token forward, 4 backward and 2 for the per-layer
    # recompute (8 N T); attention's QK^T and PV over the full S x S
    # (4 B S^2 H D a layer forward, x4 likewise)
    n_mm = n - cfg.vocab_size * cfg.d_model
    attn = 16 * cfg.num_layers * B * S * S * cfg.num_heads * cfg.head_dim
    flops = 8 * n_mm * T + attn
    share = flops / step_s / BF16_FLOPS
    res = dict(arch=arch, params=n, batch=B, seq=S, steps=steps, lr=lr,
               setup_s=setup_s, step_s=times, step_ms=step_s * 1e3,
               tokens_per_s=T / step_s, peak_gib=peak, model_flops=flops,
               flop_share=share, card=smi, split=split,
               split_median=split_med,
               losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist],
               launches={k: v for k, v in launches.items() if v})
    log(f"train: {arch} full size ({cfg.num_layers} layers, {n / 1e9:.3f} B "
        f"params), B {B} x S {S}, lr {lr}: losses "
        f"{[round(x, 4) for x in res['losses']]}, grad norms "
        f"{[round(x, 3) for x in res['grad_norms']]}")
    log(f"train: step {res['step_ms']:.1f} ms (median of steps 2-{steps}; "
        f"all {[round(t * 1e3, 1) for t in times]}), "
        f"{res['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GiB, model "
        f"FLOPs {flops:.3e} a step (8 N T + attention) = {share:.2%} of "
        f"{BF16_FLOPS:.0e} FLOP/s bf16; {smi}")
    span = {k: f"{split_med[k]:.1f} ms ({min(v):.1f}-{max(v):.1f})"
            for k, v in split.items()}
    log(f"train: {TRAIN_SPLIT} more steps on CUDA events, median (range): "
        f"forward + backward {span['fwd_bwd_ms']}, AdamW "
        f"{span['adamw_ms']}, the two {span['device_ms']} on the card, "
        f"{span['host_ms']} on the host clock; {smi}")
    check(all(math.isfinite(x) for x in res["losses"] + res["grad_norms"]),
          "a training loss or grad norm is not finite")
    check(res["losses"][-1] < res["losses"][0], "the training loss did not "
          "fall")
    check(not res["launches"], f"a training step launched a kernel: "
          f"{res['launches']}")
    rec["train"] = res
    return tr


def train_ckpt_serve(torch, rec, tr):
    """The trained params through ``save_checkpoint`` and, with the
    optimizer state freed, ``load_checkpoint`` onto the card: every leaf
    equal byte for byte. Then ``Engine.generate`` (coopt, the kernels) on
    the loaded params: 4 greedy requests, K1, K3 and K4 launched, tokens
    inside the vocabulary."""
    import shutil
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.coopt import COOPT
    from repro_torch.kernels import cuda
    from repro_torch.serving import Engine, EngineConfig
    res = rec["train"]
    cfg = tr.cfg
    path = ROOT / "_work" / "train_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    params, step = tr.params, int(tr.opt_state.step)
    tr.opt_state = tr.params = None
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    save_checkpoint(str(path), params, step=step)
    res["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_checkpoint(str(path), params)
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t0
    pairs = list(zip(tree_util.leaves(params), tree_util.leaves(loaded)))
    same = all(a.dtype == b.dtype and a.device == b.device
               and torch.equal(_bits(torch, a), _bits(torch, b))
               for a, b in pairs)
    res["ckpt_leaves"], res["ckpt_bytes_equal"] = len(pairs), same
    res["ckpt_gib"] = sum(a.numel() * a.element_size()
                          for a, _ in pairs) / 2**30
    del params, pairs
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"train: checkpoint of {res['ckpt_leaves']} leaves, "
        f"{res['ckpt_gib']:.2f} GiB: saved in {res['save_s']:.1f} s, loaded "
        f"onto the card in {res['load_s']:.1f} s, byte-equal {same}")
    check(same, "a checkpoint leaf came back changed")
    eng = Engine(cfg, COOPT.replace(use_kernel=True),
                 EngineConfig(num_lanes=4, max_len=1024, seed=0),
                 params=loaded, device=DEV)
    prompts = engine_prompts(cfg)[:4]
    cuda.reset_launches()
    outs = eng.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    toks = [t for o in outs for t in o]
    res["serve"] = dict(tokens=[list(map(int, o)) for o in outs],
                        launches={k: v for k, v in launches.items() if v})
    log(f"train: the loaded params served: {[len(o) for o in outs]} tokens, "
        f"launches {res['serve']['launches']}")
    check(all(len(o) == 16 for o in outs), "serving the loaded params did "
          "not finish")
    check(all(0 <= t < cfg.vocab_size for t in toks), "a token outside the "
          "vocabulary")
    for k in ("kv_cache_write", "flash_chunk_prefill",
              "paged_pool_decode_visits"):
        check(launches[k] > 0, f"{k} never launched serving the loaded "
              "params")
    del eng, loaded
    gc.collect()
    torch.cuda.empty_cache()


def _train_batch(np, cfg, B, S, seed=0):
    """A host batch of ``TrainPipeline(seed)``, with random bf16-exact
    patches (vlm) or frames (whisper) from a numpy generator."""
    from repro_torch.data import TrainPipeline
    batch = dict(TrainPipeline(cfg.vocab_size, B, S, seed=seed).next_batch())
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model))
    if cfg.family == "whisper":
        batch["frames"] = rng.normal(0, 1, (B, cfg.num_frames, cfg.d_model))
    return batch


def _on(torch, batch, dev):
    return {k: torch.as_tensor(v).to(dev, torch.bfloat16)
            if v.dtype.kind == "f" else torch.as_tensor(v).to(dev)
            for k, v in batch.items()}


def train_parity(torch, rec, archs=None):
    """One ``make_train_step`` from the same params and batch on the card
    and on the CPU for each model of ``PARITY``: the loss within
    TRAIN_LOSS_ATOL, each leaf's gradient within its relative L2 bound, and
    a control (the card's labels rolled by one) that must break the bound.
    A MoE model's card routes are held to the CPU's (``TiePin``): a flip
    only at a router near-tie (``ROUTE_TIE``)."""
    import numpy as np
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training import train as train_mod
    out = {}
    got = {}
    inner = train_mod.loss_and_grads

    def capture(*a, **kw):
        m, g = inner(*a, **kw)
        got["metrics"], got["grads"] = m, g
        return m, g
    for arch in archs or PARITY:
        cfg = get_config(arch)
        model = get_model(cfg)
        p_cpu = model.init(seed=3, device="cpu")
        p_card = tree_util.tree_map(lambda t: t.to(DEV, copy=True), p_cpu)
        host = _train_batch(np, cfg, 2, 64)
        step = make_train_step(cfg, COOPT, lr=1e-3)
        train_mod.loss_and_grads = capture
        try:
            with RouteLog(torch, moe_mod) as ref:
                _, _, m_cpu = step(p_cpu, adamw_init(p_cpu),
                                   _on(torch, host, "cpu"))
            g_cpu = got["grads"]
            with TiePin(torch, moe_mod, ref.calls, ROUTE_TIE) as pin:
                _, _, m_card = step(p_card, adamw_init(p_card),
                                    _on(torch, host, DEV))
            g_card = got["grads"]
        finally:
            train_mod.loss_and_grads = inner
        rolled = dict(host, labels=np.roll(host["labels"], 1, axis=1))
        # the control from the step's starting params: the card's copy
        # moved with its step, so start again from the CPU's
        p_ctl = tree_util.tree_map(lambda t: t.to(DEV, copy=True),
                                   model.init(seed=3, device="cpu"))
        with TiePin(torch, moe_mod, ref.calls, ROUTE_TIE) as pin_c:
            _, g_ctl = inner(model, p_ctl, _on(torch, rolled, DEV), COOPT)
        paths = [p for p, _ in tree_util.leaves_with_path(p_cpu)]
        tols = [grad_tol(arch, p) for p in paths]
        rel = [_rel_l2(torch, a.cpu(), b) for a, b in zip(g_card, g_cpu)]
        rel_ctl = [_rel_l2(torch, a.cpu(), b) for a, b in zip(g_ctl, g_cpu)]
        # the worst leaf of each bound's group, as (leaf, rel L2, bound)
        groups = {}
        for p, x, t in zip(paths, rel, tols):
            if x > groups.get(t, ("", -1.0))[1]:
                groups[t] = ("/".join(map(str, p)), x)
        worst = [(name, x, t) for t, (name, x) in sorted(groups.items())]
        r = dict(loss_card=float(m_card["loss"]), loss_cpu=float(m_cpu["loss"]),
                 grad_norm_card=float(m_card["grad_norm"]),
                 grad_norm_cpu=float(m_cpu["grad_norm"]), worst=worst,
                 over=[w for w in worst if w[1] > w[2]],
                 control_worst_rel_l2=max(rel_ctl),
                 control_breaks=any(c > t for c, t in zip(rel_ctl, tols)),
                 pinned_ties=len(pin.pinned),
                 widest_pinned_gap=max(pin.pinned, default=0.0),
                 bad_flips=pin.bad + pin_c.bad)
        out[arch] = r
        log(f"train card vs CPU ({arch}): loss {r['loss_card']:.5f} / "
            f"{r['loss_cpu']:.5f}, grad norm {r['grad_norm_card']:.4f} / "
            f"{r['grad_norm_cpu']:.4f}, worst leaf rel L2 "
            + ", ".join(f"{n} {x:.3e} (tol {t})" for n, x, t in worst)
            + f"; control (labels rolled) {r['control_worst_rel_l2']:.3e}; "
            f"router ties pinned {r['pinned_ties']} (widest gap "
            f"{r['widest_pinned_gap']:.2e})")
        check(not r["bad_flips"], f"{arch}: a MoE route flipped away from a "
              f"tie: {r['bad_flips'][:4]}")
        check(abs(r["loss_card"] - r["loss_cpu"]) <= TRAIN_LOSS_ATOL,
              f"{arch}: card and CPU losses differ")
        check(not r["over"], f"{arch}: card and CPU gradients differ: "
              f"{r['over']}")
        check(r["control_breaks"], f"{arch}: the gradient check missed the "
              "rolled labels")
        del p_cpu, p_card, p_ctl, g_cpu, g_card, g_ctl
    rec.setdefault("train", {})["parity"] = out
    torch.cuda.empty_cache()


def train_micro_case(torch, rec):
    """qwen3-4b at TRAIN_MICRO layers (full width), the B x S batch in
    ``num_microbatches`` parts against whole, from the same params: the
    accumulated gradients within MICRO_GRAD_RTOL of the whole batch's, leaf
    by leaf (relative L2), and, after one step, the grad norm within
    MICRO_GNORM_RTOL, the loss within MICRO_LOSS_ATOL and every param within
    MICRO_PARAM_TOL (atol and rtol). Controls: the first microbatch's
    gradients alone, and the sum without the division by n, break the
    gradient bound."""
    import numpy as np
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.train import loss_and_grads, step_grads
    arch, B, S = TRAIN[:3]
    layers, n = TRAIN_MICRO
    cfg = get_config(arch).replace(num_layers=layers)
    model = get_model(cfg)
    p1 = model.init(0, DEV)
    batch = _on(torch, _train_batch(np, cfg, B, S), DEV)
    torch.cuda.reset_peak_memory_stats()
    _, g1 = step_grads(model, p1, batch, COOPT, 1)
    _, gn = step_grads(model, p1, batch, COOPT, n)
    rel = [_rel_l2(torch, a, b) for a, b in zip(gn, g1)]
    worst_leaf = "/".join(map(str, tree_util.leaves_with_path(p1)[
        int(np.argmax(rel))][0]))
    ctl_no_div = max(_rel_l2(torch, a * n, b) for a, b in zip(gn, g1))
    del gn
    _, g_first = loss_and_grads(model, p1, {k: v[:B // n]
                                            for k, v in batch.items()}, COOPT)
    ctl_first = max(_rel_l2(torch, a, b) for a, b in zip(g_first, g1))
    first_norm = math.sqrt(sum(g.float().square().sum().item()
                               for g in g_first))
    del g_first, g1
    pn = tree_util.tree_map(lambda t: t.clone(), p1)
    p1, _, m1 = make_train_step(cfg, COOPT, num_microbatches=1)(
        p1, adamw_init(p1), batch)
    pn, _, mn = make_train_step(cfg, COOPT, num_microbatches=n)(
        pn, adamw_init(pn), batch)
    dl = abs(float(m1["loss"]) - float(mn["loss"]))
    gn1, gnn = float(m1["grad_norm"]), float(mn["grad_norm"])
    close = all(torch.allclose(a.float(), b.float(), atol=MICRO_PARAM_TOL,
                               rtol=MICRO_PARAM_TOL)
                for a, b in zip(tree_util.leaves(p1), tree_util.leaves(pn)))
    worst = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(tree_util.leaves(p1), tree_util.leaves(pn)))
    res = dict(layers=layers, microbatches=n, worst_grad_leaf=worst_leaf,
               worst_grad_rel_l2=max(rel),
               control_first_rel_l2=ctl_first,
               control_no_div_rel_l2=ctl_no_div, loss_diff=dl,
               grad_norm_1=gn1, grad_norm_n=gnn,
               grad_norm_first_microbatch=first_norm, params_close=close,
               max_param_diff=worst,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    rec["train"]["microbatch"] = res
    log(f"train: {arch} at {layers} layers, {n} microbatches against 1: "
        f"worst leaf gradient {worst_leaf} rel L2 {max(rel):.3e} (tol "
        f"{MICRO_GRAD_RTOL}; "
        f"controls: the first microbatch alone {ctl_first:.3e}, no division "
        f"by n {ctl_no_div:.3e}), grad norm "
        f"{gnn:.5f} / {gn1:.5f} (rtol {MICRO_GNORM_RTOL}; the first "
        f"microbatch's {first_norm:.5f}), |loss diff| {dl:.2e} (atol "
        f"{MICRO_LOSS_ATOL}), max |param diff| {worst:.3e}, params within "
        f"{MICRO_PARAM_TOL}: {close}, peak {res['peak_gib']:.2f} GiB (an f32 "
        "accumulator a leaf)")
    check(max(rel) <= MICRO_GRAD_RTOL, "microbatched gradients differ")
    check(min(ctl_first, ctl_no_div) > MICRO_GRAD_RTOL,
          "the microbatch gradient check missed a control")
    check(abs(gnn - gn1) <= MICRO_GNORM_RTOL * gn1,
          "microbatched grad norm differs")
    check(dl <= MICRO_LOSS_ATOL, "microbatched loss differs")
    check(close, "microbatched params differ")
    del p1, pn
    torch.cuda.empty_cache()


def train_guard_case(torch, rec):
    """``loss_fn`` under autograd with ``use_kernel=True`` must raise on the
    card (no gradient flows through a hand-written kernel)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import COOPT
    from repro_torch.models import get_model
    from repro_torch.training import train as train_mod
    cfg = get_config("qwen3-4b-reduced")
    model = get_model(cfg)
    params = model.init(0, DEV)
    batch = _on(torch, _train_batch(np, cfg, 2, 64), DEV)
    try:
        train_mod.loss_and_grads(model, params, batch,
                                 COOPT.replace(use_kernel=True))
        raised = None
    except RuntimeError as e:
        raised = str(e)
    rec["train"]["guard"] = raised
    log(f"train: loss_fn with use_kernel=True under autograd raised: "
        f"{raised!r}")
    check(raised is not None and "no gradient" in raised,
          "a gradient through a hand-written kernel did not raise")


def train_phase(torch, rec, smi):
    """``--only train``: the full-size run, the checkpoint round trip and
    serving, the card against the CPU, microbatches and the guard."""
    s = {}
    t0 = time.perf_counter()
    tr = train_full_run(torch, rec, smi)
    s["full"] = time.perf_counter() - t0
    train_ckpt_serve(torch, rec, tr)
    s["ckpt_serve"] = time.perf_counter() - t0 - s["full"]
    del tr
    t1 = time.perf_counter()
    train_parity(torch, rec)
    s["parity"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    train_micro_case(torch, rec)
    train_guard_case(torch, rec)
    s["micro_guard"] = time.perf_counter() - t1
    rec["train"]["s"] = s
    log("train phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in s.items()))


# The launch phase (``--only launch``): the dry run of every (arch x shape)
# cell on the meta device (``launch.dryrun``) in ``DRY_WORKERS`` processes
# of one torch thread, the longest cells first, and meanwhile the
# ``LAUNCH_CELLS`` through ``launch.steps.make_step`` on the card at full
# size with random weights (``seed`` 0) and a cache of seq_len - 1 random
# tokens: every call of K1 inside the real step held to the plain write
# (the rows it wrote, fp8 bytes and f32 scales, equal to what
# ``kv_cache_write_ref`` writes from the same inputs; a control, the rows
# one slot before, must differ), every call of the read kernel held to
# its plain version on the same inputs (K2 within ``ATTN_*``, K5 within
# ``LAT_*``, beside a control with each lane's newest key masked off that
# must fail), the step with the kernels against the same step with
# ``use_kernel=False`` (a MoE model's routes pinned at router near-ties,
# ``TiePin``): logits within ``LAUNCH_LOGIT_ATOL``, and the plain step
# with one layer's attention moved by one tolerance unit beyond it
# (through 36 or 27 layers of random weights a one-ulp difference grows
# past the reduced models' ``LOGIT_ATOL``), the peak memory against the
# dry run's, and ``launch.inspect_cell``'s trace: the top kernels and the
# roofline terms. The two cells' dry runs are the pool's first.
LAUNCH_CELLS = (("qwen3-4b", "long_500k",
                 ("kv_cache_write", "paged_pool_decode")),
                ("deepseek-v2-lite-16b", "long_500k",
                 ("paged_latent_decode",)))
DRY_WORKERS = 7        # of the card machine's 8 cores: one for the cells
# the cells' dry-run cost, longest first (meta steps, measured on the CPU):
# train, then prefill, decode, long_500k; deeper models first within a kind
_KIND_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}


def _dry_cell(cell):
    """One cell's dry run in a worker process (``spawn``): its record and
    wall seconds; an error is a record too."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    try:
        r = dryrun.run_one(*cell, verbose=False)
    except Exception as e:          # recorded, and fails the phase
        r = {"arch": cell[0], "shape": cell[1], "status": "error",
             "error": f"{type(e).__name__}: {e}"}
    r["wall_s"] = time.perf_counter() - t0
    return r


def dry_run_start(first):
    """Start every (arch x shape) cell's dry run in a pool of
    ``DRY_WORKERS`` processes: the cells ``first``, then the longest
    first. Returns (the pool, the pending result by cell, the start
    time)."""
    import multiprocessing as mp
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    rest = [(a, s) for a in ARCH_IDS for s in SHAPES if (a, s) not in first]
    order = list(first) + sorted(rest, key=lambda c: (
        _KIND_ORDER[c[1]], -get_config(c[0]).num_layers))
    pool = mp.get_context("spawn").Pool(DRY_WORKERS)
    pending = {c: pool.apply_async(_dry_cell, (c,)) for c in order}
    return pool, pending, time.perf_counter()


def dry_run_finish(rec, smi, pending, t0):
    """The dry run's records: one line a cell, 39 ok and whisper-small x
    long_500k skipped, none failing. Returns them by (arch, shape)."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    got = {c: p.get() for c, p in pending.items()}
    wall = time.perf_counter() - t0
    recs = [dict(got[a, s], card=smi) for a in ARCH_IDS for s in SHAPES]
    for r in recs:
        if r["status"] != "ok":
            log(f"  dry {r['arch']} x {r['shape']}: {r['status']} "
                f"({r.get('reason') or r.get('error')})")
            continue
        m = r["memory"]
        part = f", microbatches {r['microbatches_counted']} of " \
            f"{r['microbatches']} run" if "microbatches_counted" in r else ""
        log(f"  dry {r['arch']} x {r['shape']} ({r['kind']}): ok, "
            f"{r['cost']['flops']:.4e} FLOPs, {r['cost']['min_bytes']:.4e}"
            f" B to move, arguments {m['argument_bytes'] / 2**30:.3f} GiB, "
            f"temp {m['temp_bytes'] / 2**30:.3f} GiB, "
            f"{'fits' if r['fits_h100_80gib'] else 'does not fit'} one "
            f"card ({r['wall_s']:.1f} s{part})")
    n = {s: sum(r["status"] == s for r in recs)
         for s in ("ok", "skipped", "error")}
    fit = [f"{r['arch']} x {r['shape']}" for r in recs
           if r.get("fits_h100_80gib")]
    cpu = sum(r["wall_s"] for r in recs)
    log(f"dry run: {n['ok']} ok, {n['skipped']} skipped, {n['error']} "
        f"failed in {wall:.1f} s ({DRY_WORKERS} workers, {cpu:.1f} s of "
        f"cells, the longest {max(r['wall_s'] for r in recs):.1f} s); "
        f"{len(fit)} fit one card: {', '.join(fit)}")
    rec["launch"]["dry"] = recs
    rec["launch"]["dry_s"] = wall
    check(n == {"ok": 39, "skipped": 1, "error": 0},
          f"the dry run gave {n}, not 39 ok and 1 skipped")
    return {(r["arch"], r["shape"]): r for r in recs}


def _read_plain(torch, name, args, kw, control):
    """The plain version of read wrapper ``name``'s call (``args``, ``kw``)
    and, with ``control``, the same with each lane's newest key masked off;
    with the kernel's tolerance (rtol, atol), the call's cache lengths and
    physical table."""
    from repro_torch.kernels import paged_gqa_decode as pd
    from repro_torch.kernels import paged_latent_decode as ld
    if name == "paged_pool_decode":
        q, kv, sc, cl, phys, logt = args
        base = {k: kw[k] for k in ("opt_kv", "opt_gqa", "window",
                                   "sink_pages")}
        ref = (q, kv[0], kv[1], sc[0], sc[1])
        fn, tol = pd.paged_pool_decode_ref, (ATTN_RTOL, ATTN_ATOL)
    else:
        ql, qr, lat, sc, cl, phys, logt = args
        base = {k: kw[k] for k in ("sm_scale", "opt_kv", "window",
                                   "sink_pages")}
        ref = (ql, qr, lat, sc)
        fn, tol = ld.paged_latent_decode_ref, (LAT_RTOL, LAT_ATOL)
    plain = fn(*ref, cl.int(), phys.int(), logt.int(), **base)
    ctl = fn(*ref, cl.int() - 1, phys.int(), logt.int(), **base) \
        if control else None
    return plain, ctl, tol, cl, phys


def _hold_reads(torch, name, what):
    """Wrap the read wrapper ``name`` (``paged_pool_decode`` or
    ``paged_latent_decode`` of ``kernels.ops``) until ``restore()``: every
    call the step makes runs the kernel, then its plain version on the
    same inputs (the layer's pool as the step left it), and the largest
    share of the kernel's tolerance is kept; the first call also runs a
    control (each lane's newest key masked off) that must fail it.
    Returns (the summary, restore)."""
    from repro_torch.kernels import ops
    saved = getattr(ops, name)
    held = dict(calls=0, ratio=0.0, max_abs_err=0.0)

    def wrapper(*args, **kw):
        out = saved(*args, **kw)
        first = held["calls"] == 0
        plain, ctl, tol, cl, phys = _read_plain(torch, name, args, kw,
                                                first)
        r, err = tol_ratio(out, plain, *tol)
        held.update(calls=held["calls"] + 1, ratio=max(held["ratio"], r),
                    max_abs_err=max(held["max_abs_err"], err))
        if first:
            rc, errc = tol_ratio(out, ctl, *tol)
            held.update(control_ratio=rc, control_err=errc,
                        cache_len=cl.tolist(), window=kw["window"],
                        live_slots=int((phys >= 0).sum()),
                        slots=phys.shape[1])
        return out

    def restore():
        setattr(ops, name, saved)
        log(f"{what}: {name} on each of the step's {held['calls']} calls "
            f"against its plain version on the same inputs (cache_len "
            f"{held.get('cache_len')}, window {held.get('window')}, "
            f"{held.get('live_slots')} of {held.get('slots')} table slots "
            f"live): max |kernel - plain| {held['max_abs_err']:.3e} = "
            f"{held['ratio']:.3f} of the tolerance; control, newest key "
            f"masked off: {held.get('control_err', 0):.3e} = "
            f"{held.get('control_ratio', 0):.2f}")
    setattr(ops, name, wrapper)
    return held, restore


def _hold_writes(torch, what):
    """Wrap ``kernels.ops.kv_cache_write`` (K1) until ``restore()``: after
    every call the step makes, the rows it wrote (K and V, fp8 bytes and
    f32 scales) must equal, byte for byte, what the plain version
    (``kv_cache_write_ref``) writes from the same inputs into fresh rows;
    a control, the rows one slot before each written one (random pages),
    must differ. Returns (the summary, restore)."""
    from repro_torch.kernels import kv_cache_write as kw
    from repro_torch.kernels import ops
    saved = ops.kv_cache_write
    held = dict(calls=0, equal=0, control_equal=0, rows=0, slots=[])

    def wrapper(kv_cache, scale_cache, k_new, v_new, slot_idx, *, opt_kv):
        out = saved(kv_cache, scale_cache, k_new, v_new, slot_idx,
                    opt_kv=opt_kv)
        _, Pt, ps, Hkv, D = kv_cache.shape
        flat = kv_cache.view(2, Pt * ps, Hkv, D)
        keep = (slot_idx >= 0) & (slot_idx < Pt * ps)
        slots = slot_idx[keep].long()
        n = slots.numel()
        local = torch.full_like(slot_idx, -1)
        local[keep] = torch.arange(n, dtype=local.dtype,
                                   device=local.device)
        ref = torch.zeros((2, n, Hkv, D), dtype=kv_cache.dtype,
                          device=kv_cache.device)
        rsc = torch.zeros((2, n, Hkv), dtype=torch.float32,
                          device=kv_cache.device) if opt_kv else None
        kw.kv_cache_write_ref(k_new, v_new, local, ref[0], ref[1],
                              *((rsc[0], rsc[1]) if opt_kv else
                                (None, None)), opt_kv=opt_kv)

        def same(rows):
            eq = torch.equal(flat[:, rows].view(torch.uint8),
                             ref.view(torch.uint8))
            if opt_kv:
                eq = eq and torch.equal(
                    scale_cache.view(2, Pt * ps, Hkv)[:, rows], rsc)
            return eq
        before = torch.where(slots > 0, slots - 1, slots + 1)
        held.update(calls=held["calls"] + 1, rows=held["rows"] + n,
                    equal=held["equal"] + same(slots),
                    control_equal=held["control_equal"] + same(before))
        if held["calls"] == 1:
            held["slots"] = slots.tolist()
        return out

    def restore():
        ops.kv_cache_write = saved
        log(f"{what}: kv_cache_write on each of the step's {held['calls']} "
            f"calls ({held['rows']} rows, slots {held['slots']} of "
            f"{held.get('pool_slots')}) against the plain write: "
            f"{held['equal']} of {held['calls']} equal byte for byte; "
            f"control, the rows one slot before: {held['control_equal']} "
            f"equal")
    ops.kv_cache_write = wrapper
    return held, restore


def _one_tolerance_control(torch, plain, args, read, want):
    """The plain step again with its first layer's attention output moved
    by one tolerance unit of the read kernel (a relative ``ATTN_RTOL`` or
    ``LAT_RTOL``): how far a difference the kernel check admits at one
    layer moves this model's logits. Returns max |logits - want|."""
    from repro_torch.core import opt_pa
    from repro_torch.launch import inspect_cell
    from repro_torch.models import mla
    mod, name = (opt_pa, "_windowed") if read == "paged_pool_decode" \
        else (mla, "_expand_o")
    rtol = ATTN_RTOL if read == "paged_pool_decode" else LAT_RTOL
    saved, calls = getattr(mod, name), []

    def moved(*a, **kw):
        if not calls and name == "_expand_o":
            a = (a[0] * (1 + rtol),) + a[1:]
        out = saved(*a, **kw)
        if not calls and name == "_windowed":
            out = out * (1 + rtol)
        calls.append(1)
        return out
    setattr(mod, name, moved)
    try:
        with torch.no_grad():
            got, _ = plain.fn(*inspect_cell.fresh(plain, args))
    finally:
        setattr(mod, name, saved)
    check(len(calls) > 0, f"the one-tolerance control never reached {name}")
    return (got.float() - want.float()).abs().max().item()


def _read_in_trace(step, read, held, r, what):
    """The read kernel's card time a call in ``inspect``'s trace beside
    the least time its call's bytes take: the live pages it reads once
    (K2: fp8 K and V and their f32 scales; K5: the fp8 latent row and its
    two f32 scales a token), its queries read and its output written."""
    import re
    cfg, ps = step.cfg, step.coopt.page_size
    tokens = held["live_slots"] * ps
    if read == "paged_pool_decode":
        name = "decode_kernel"
        moved = tokens * cfg.num_kv_heads * (2 * cfg.head_dim + 8) \
            + 2 * 2 * cfg.num_heads * cfg.head_dim
    else:
        name = "latent_decode_kernel"
        R, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        moved = tokens * (R + dr + 8) + 4 * cfg.num_heads * (2 * R + dr)
    pat = re.compile(rf"(?<![A-Za-z_]){name}<")
    hits = [k for k in r["top"] if pat.search(k["name"])]
    check(len(hits) == 1, f"{what}: {name} is not among the trace's top "
          f"{len(r['top'])} activities")
    ms = hits[0]["ms"] / hits[0]["calls"]
    bnd = bound(moved, 0, BF16_FLOPS)
    log(f"{what}: {read} in the trace: {hits[0]['calls']} calls, {ms:.4f} "
        f"ms a call; its bytes ({moved / 1e6:.2f} MB: {tokens} tokens of "
        f"pages) take {bnd['bound_ms']:.4f} ms, {bnd['bound_ms'] / ms:.2%} "
        f"of the call")
    return dict(calls=hits[0]["calls"], ms=ms, bytes=moved,
                bound_ms=bnd["bound_ms"], bound_share=bnd["bound_ms"] / ms)


def launch_cell(torch, rec, arch, shape, kernels, dry, smi):
    """One cell through ``make_step`` on the card (see ``LAUNCH_CELLS``):
    the kernel step with each call of its read kernel held to the plain
    version on the same inputs, its launches, the plain step (greedy
    tokens equal or parted at a near-tie; the logits' difference beside
    the one-tolerance control's), the peak memory beside the dry run's and
    ``inspect_cell``'s report. Returns the launches of the kernel step."""
    from repro_torch.core.coopt import COOPT
    from repro_torch.kernels import cuda
    from repro_torch.launch import inspect_cell
    from repro_torch.launch.steps import make_step
    from repro_torch.models import moe as moe_mod
    what = f"launch {arch} x {shape}"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step = make_step(arch, shape, COOPT.replace(use_kernel=True), device=DEV)
    plain = make_step(arch, shape, COOPT, device=DEV)
    args = step.init_args(seed=0)
    torch.cuda.synchronize()
    arg_bytes = torch.cuda.memory_allocated() - base
    init_s = time.perf_counter() - t0
    read = kernels[-1]
    held, restore = _hold_reads(torch, read, what)
    writes = "kv_cache_write" in kernels
    if writes:
        held_w, restore_w = _hold_writes(torch, what)
        held_w["pool_slots"] = args[2]["kv"].shape[2] * \
            args[2]["kv"].shape[3]
    routes = RouteLog(torch, moe_mod) if step.cfg.num_experts else \
        contextlib.nullcontext()
    cuda.reset_launches()
    try:
        with torch.no_grad(), routes:
            logits, _ = step.fn(*inspect_cell.fresh(step, args))
        torch.cuda.synchronize()
    finally:
        restore()
        if writes:
            restore_w()
    launches = {k: n for k, n in cuda.LAUNCHES.items() if n}
    log(f"{what}: {step.kind}, long_window {step.long_window}, arguments "
        f"{arg_bytes / 2**30:.3f} GiB on the card (dry run "
        f"{dry['memory']['argument_bytes'] / 2**30:.3f}), built in "
        f"{init_s:.1f} s; launches {launches}")
    for k in kernels:
        check(launches.get(k, 0) > 0, f"{what}: {k} never launched")
    check(held["calls"] == launches.get(read, 0) == step.cfg.num_layers,
          f"{what}: {held['calls']} held calls of {read}, "
          f"{launches.get(read, 0)} launches, {step.cfg.num_layers} layers")
    check(held["ratio"] <= 1, f"{what}: {read} differs from its plain "
          "version on the step's inputs")
    check(held["control_ratio"] > 1, f"{what}: the tolerance passes a "
          "one-key mask error")
    if writes:
        n = step.cfg.num_layers
        check(held_w["calls"] == launches["kv_cache_write"] == n,
              f"{what}: {held_w['calls']} held calls of kv_cache_write, "
              f"{launches['kv_cache_write']} launches, {n} layers")
        check(held_w["equal"] == n, f"{what}: kv_cache_write wrote other "
              "bytes than the plain write")
        check(held_w["control_equal"] == 0, f"{what}: the write check "
              "passes rows one slot off")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # a MoE model's plain step takes the kernel step's route where the
    # two part at a router near-tie (``TiePin``, ``ROUTE_TIE``)
    pin = TiePin(torch, moe_mod, routes.calls, ROUTE_TIE) \
        if step.cfg.num_experts else contextlib.nullcontext()
    with torch.no_grad(), pin:
        want, _ = plain.fn(*inspect_cell.fresh(plain, args))
    torch.cuda.synchronize()
    peak_plain = torch.cuda.max_memory_allocated() - base
    g, w = logits.float(), want.float()
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    pin2 = TiePin(torch, moe_mod, pin.calls, ROUTE_TIE) \
        if step.cfg.num_experts else contextlib.nullcontext()
    with pin2:
        moved = _one_tolerance_control(torch, plain, args, read, want)
    if step.cfg.num_experts:
        log(f"{what}: MoE routes of the plain step pinned to the kernel "
            f"step's at {len(pin.pinned)} near-ties (gaps "
            f"{[f'{x:.2e}' for x in pin.pinned]}), {len(pin.bad)} other "
            f"flips; the control's {len(pin2.pinned)} and {len(pin2.bad)}")
        check(not pin.bad, f"{what}: a MoE route flips off a router "
              f"near-tie: {pin.bad}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite logits")
    parted = (g.argmax(-1) != w.argmax(-1)).nonzero().flatten().tolist()
    top2 = w.topk(2, dim=-1).values
    gaps = [float(top2[i, 0] - top2[i, 1]) for i in parted]
    log(f"{what}: logits (B {g.shape[0]}, V {g.shape[1]}, |logit| max "
        f"{scale:.2f}) against the plain step's: max |kernel - plain| "
        f"{err:.4f} (bound {LAUNCH_LOGIT_ATOL}); control, the plain step "
        f"with one layer's attention output moved by one tolerance unit: "
        f"{moved:.4f}; greedy parted at {parted} (the plain step's best two "
        f"{[f'{x:.4f}' for x in gaps]} apart)")
    check(err <= LAUNCH_LOGIT_ATOL, f"{what}: the kernel step's logits "
          f"differ from the plain step's by {err:.4f}")
    check(moved > LAUNCH_LOGIT_ATOL, f"{what}: the logit bound passes a "
          f"one-tolerance move of one layer's attention ({moved:.4f})")
    r = inspect_cell.inspect(step, args, dry, top=12, card_line=smi)
    inspect_cell.report(r, log)
    read_rec = _read_in_trace(step, read, held, r, what)
    peak_kernel = r["peak_bytes"] - base
    dry_total = dry["memory"]["argument_bytes"] + dry["memory"]["temp_bytes"]
    log(f"{what}: peak {peak_kernel / 2**30:.3f} GiB with the kernels, "
        f"{peak_plain / 2**30:.3f} GiB plain, against the dry run's "
        f"{dry_total / 2**30:.3f} GiB (arguments + temp, plain path); the "
        f"card's {torch.cuda.get_device_properties(0).total_memory / 2**30:.3f}"
        f" GiB")
    out = dict(arch=arch, shape=shape, kind=step.kind, dry=dry,
               launches=launches,
               arg_bytes=arg_bytes, init_s=init_s, peak_kernel=peak_kernel,
               peak_plain=peak_plain, dry_bytes=dry_total,
               logits_max_abs_err=err, logits_max=scale,
               logit_bound=LAUNCH_LOGIT_ATOL,
               one_tolerance_control=moved, parted=parted, gaps=gaps,
               held=held, held_writes=held_w if writes else None,
               read=read_rec,
               inspect=r)
    rec["launch"]["cells"].append(out)
    del args, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def launch_phase(torch, rec, smi):
    """``--only launch``: the dry run of every cell in worker processes,
    and meanwhile the ``LAUNCH_CELLS`` on the card, each once the pool has
    its record. Returns the launches by kernel summed over the cells'
    kernel steps."""
    rec["launch"] = {"cells": []}
    t0 = time.perf_counter()
    pool, pending, t_pool = dry_run_start(
        [(a, s) for a, s, _ in LAUNCH_CELLS])
    total = {}
    try:
        for arch, shape, kernels in LAUNCH_CELLS:
            dry = dict(pending[arch, shape].get(), card=smi)
            check(dry["status"] == "ok" and dry["fits_h100_80gib"],
                  f"{arch} x {shape}: the dry run says it does not fit "
                  f"({dry.get('error')})")
            for k, n in launch_cell(torch, rec, arch, shape, kernels, dry,
                                    smi).items():
                total[k] = total.get(k, 0) + n
        rec["launch"]["card_s"] = time.perf_counter() - t0
        dry_run_finish(rec, smi, pending, t_pool)
    finally:
        pool.terminate()
        pool.join()
    log(f"launch phase: the card's cells {rec['launch']['card_s']:.1f} s "
        f"beside the dry run's {DRY_WORKERS} workers, the dry run "
        f"{rec['launch']['dry_s']:.1f} s")
    return total


PARITY = ("qwen3-4b-reduced", "deepseek-v2-lite-16b-reduced",
          "mixtral-8x22b-reduced", "internvl2-2b-reduced",
          "recurrentgemma-9b-reduced", "rwkv6-7b-reduced",
          "whisper-small-reduced")

# which path's run each kernel's launch count is read from
LAUNCH_PATH = {"kv_cache_write": "qwen3-4b", "flash_chunk_prefill": "qwen3-4b",
               "paged_pool_decode_visits": "qwen3-4b",
               "paged_pool_decode": "qwen3-4b one lane",
               "latent_chunk_prefill": "deepseek-v2-lite-16b",
               "paged_latent_decode_visits": "deepseek-v2-lite-16b",
               "paged_latent_decode": "deepseek-v2-lite-16b one lane",
               "flash_prefill": "qwen3-4b full prompt"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels", "write", "decode", "latent",
                                       "engine", "mla", "prefill", "async",
                                       "serve", "packed", "recurrent",
                                       "sharded", "whisper", "host",
                                       "parity", "train", "launch"),
                    help="run one phase (debugging; prints no result line)")
    ap.add_argument("--src", help="import repro_torch from this directory "
                    "instead of ./src (to time another tree's kernels)")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    record = OUT / ("chip_smoke_src.json" if args.src else "chip_smoke.json")
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
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
        f"repro_torch from {Path(cuda.__file__).parents[2]}")
    rec = {"card": smi, "phase_s": {}}
    OUT.mkdir(exist_ok=True)
    t_start = time.perf_counter()

    def done(phase, t0):
        rec["phase_s"][phase] = time.perf_counter() - t0
        log(f"[{phase}: {rec['phase_s'][phase]:.1f} s, "
            f"{time.perf_counter() - t_start:.1f} s since start]")

    only = args.only
    try:
        t0 = time.perf_counter()
        cuda.build_all()
        rec["build_s"] = time.perf_counter() - t0
        log(f"kernels built in {rec['build_s']:.1f} s")
        (OUT / "build.log").write_text(
            "\n".join(f"== {n}\n{s}" for n, s in cuda.BUILD_LOG.items()))
        kernels, paths = [], {}
        if only in (None, "kernels"):
            t0 = time.perf_counter()
            time_ms = make_timer(torch)
            kernels = kernel_phase(torch, rec, time_ms)
            long_decode_phase(torch, rec, time_ms)
            oversized_decode_case(torch, rec)
            kernels += mla_kernel_phase(torch, rec, time_ms) + \
                flash_prefill_kernel_phase(torch, rec, time_ms)
            latent_long_case(torch, rec, time_ms)
            for k in kernels:
                k["tflops"] = k["flops"] / k["ms"] * 1e-9
                k["bound_share"] = k["bound_ms"] / k["ms"]
                log(f"  {k['name']}: {k['ms']:.4f} ms (plain "
                    f"{k['plain_ms']:.4f}, library {k['library_ms']:.4f}, "
                    f"bound {k['bound_ms']:.4f} by {k['bound_by']}); "
                    f"{k['tflops']:.2f} TFLOP/s, {k['bound_share']:.2%} of "
                    f"the bound, {k['ms'] / k['library_ms']:.2f}x the "
                    f"library")
            rec["kernels"] = kernels
            del time_ms
            torch.cuda.empty_cache()
            done("kernels", t0)
        if only == "write":
            t0 = time.perf_counter()
            write_phase(torch, rec, make_timer(torch))
            done("write", t0)
        if only == "decode":
            t0 = time.perf_counter()
            decode_phase(torch, rec, make_timer(torch))
            done("decode", t0)
        if only == "latent":
            t0 = time.perf_counter()
            latent_phase(torch, rec, make_timer(torch))
            done("latent", t0)
        params = None
        if only in (None, "engine"):
            t0 = time.perf_counter()
            paths["qwen3-4b"], paths["qwen3-4b one lane"], params = \
                engine_phase(torch, rec, "qwen3-4b", keep_params=True)
            done("engine qwen3-4b", t0)
        if only in (None, "prefill"):
            t0 = time.perf_counter()
            if params is None:
                from repro_torch.configs import get_config
                from repro_torch.models import get_model
                params = get_model(get_config("qwen3-4b")).init(0, DEV)
            paths["qwen3-4b full prompt"] = full_prompt_phase(torch, rec,
                                                              params)
            done("full prompt", t0)
        if only in (None, "async"):
            t0 = time.perf_counter()
            if params is None:
                from repro_torch.configs import get_config
                from repro_torch.models import get_model
                params = get_model(get_config("qwen3-4b")).init(0, DEV)
            paths["qwen3-4b async"], paths["deepseek-v2-lite-16b async"] = \
                async_phase(torch, rec, params)
            done("async", t0)
        serve = {}
        if only in (None, "serve"):
            t0 = time.perf_counter()
            serve = serve_phase(torch, rec, params)
            done("serve", t0)
        params = None
        torch.cuda.empty_cache()
        if only in (None, "mla"):
            t0 = time.perf_counter()
            arch = "deepseek-v2-lite-16b"
            paths[arch], paths[arch + " one lane"], _ = \
                engine_phase(torch, rec, arch)
            done("engine " + arch, t0)
        packed = {}
        if only in (None, "packed"):
            t0 = time.perf_counter()
            packed = packed_phase(torch, rec)
            done("packed", t0)
        recurrent, d256 = {}, {}
        if only in (None, "recurrent"):
            t0 = time.perf_counter()
            d256, recurrent = recurrent_phase(torch, rec, make_timer(torch))
            done("recurrent", t0)
        state_recs, sharded = [], {}
        if only in (None, "sharded"):
            t0 = time.perf_counter()
            state_recs, sharded = sharded_phase(torch, rec, make_timer(torch))
            rec["state_kernels"] = state_recs
            done("sharded", t0)
        whisper, d64 = {}, {}
        if only in (None, "whisper"):
            t0 = time.perf_counter()
            d64, whisper = whisper_phase(torch, rec, make_timer(torch))
            done("whisper", t0)
        host = {}
        if only in (None, "host"):
            t0 = time.perf_counter()
            host = host_phase(torch, rec)
            done("host", t0)
        if only in (None, "parity"):
            t0 = time.perf_counter()
            for arch in PARITY:
                parity_phase(torch, rec, arch)
            done("parity", t0)
        if only in (None, "train"):
            t0 = time.perf_counter()
            train_phase(torch, rec, smi)
            done("train", t0)
        launch = {}
        if only in (None, "launch"):
            t0 = time.perf_counter()
            launch = launch_phase(torch, rec, smi)
            done("launch", t0)
        if only is None:
            for k in kernels:
                k["launches"] = paths[LAUNCH_PATH[k["name"]]][k["name"]]
                k["async_launches"] = (
                    paths["qwen3-4b async"][k["name"]]
                    + paths["deepseek-v2-lite-16b async"][k["name"]])
                k["packed_launches"] = packed.get(k["name"], 0)
                k["serve_launches"] = serve.get(k["name"], 0)
                k["recurrent_launches"] = recurrent.get(k["name"], 0)
                k["whisper_launches"] = whisper.get(k["name"], 0)
                k["host_launches"] = host.get(k["name"], 0)
                k["launch_launches"] = launch.get(k["name"], 0)
                # K1-K4 at D 256 (recurrentgemma-9b) and D 64
                # (whisper-small): a record each, with the launches of the
                # recurrent and whisper phases' engine runs
                for recs, path, n in (
                        (d256, "recurrentgemma-9b", k["recurrent_launches"]),
                        (d64, "whisper-small", k["whisper_launches"])):
                    for r in recs.get(k["name"], []):
                        r.update(path=path, launches=n)
                    k["shapes"] = k.get("shapes", []) + recs.get(k["name"],
                                                                 [])
                # the packed, serve and recurrent phases' engine-built
                # inputs held too, and the D 256 cases
                k["max_abs_err"] = max(
                    [k["max_abs_err"],
                     rec["packed"]["vs_plain_max_abs_err"].get(k["name"], 0),
                     rec["serve"]["vs_plain_max_abs_err"].get(k["name"], 0),
                     rec["recurrent"]["vs_plain_max_abs_err"].get(
                         k["name"], 0),
                     rec["whisper"]["vs_plain_max_abs_err"].get(
                         k["name"], 0)]
                    + [r["max_abs_err"] for r in d256.get(k["name"], [])
                       + d64.get(k["name"], [])])
                check(k["launches"] > 0, f"{k['name']} never launched on "
                      f"its path ({LAUNCH_PATH[k['name']]})")
            check(sorted(k["name"] for k in kernels) == sorted(LAUNCH_PATH),
                  "the kernels line does not list every kernel")
            # the return_state instantiations, launched per shard by the
            # sharded phase's engines (qwen3-4b and deepseek-v2-lite-16b on
            # a 4-shard mesh, sync, async and one lane)
            for r in state_recs:
                r["launches"] = sharded.get(r["name"], 0)
                check(r["launches"] > 0, f"{r['name']} never launched on "
                      "the sharded engines")
            check(len(state_recs) == 6, "the kernels line lacks a "
                  "return_state instantiation")
            kernels = kernels + state_recs
            for name in ("flash_chunk_prefill", "latent_chunk_prefill"):
                check(packed.get(name, 0) > 0,
                      f"{name} never launched on packed rows")
            for name in ("kv_cache_write", "flash_chunk_prefill",
                         "paged_pool_decode_visits"):
                check(recurrent.get(name, 0) > 0,
                      f"{name} never launched at D 256 (recurrentgemma-9b)")
                check(whisper.get(name, 0) > 0,
                      f"{name} never launched at D 64 (whisper-small)")
                check(host.get(name, 0) > 0,
                      f"{name} never launched with the host tier on")
            by_step = rec["engine"]["k1_launches_by_step"]
            runs = {"qwen3-4b prefill": by_step["prefill"],
                    "qwen3-4b decode": by_step["decode"],
                    "qwen3-4b full prompt":
                        paths["qwen3-4b full prompt"]["kv_cache_write"]}
            for r, (*_, path) in zip(rec["write"]["shapes"], K1_SHAPES):
                r["path"], r["launches"] = path, runs.get(path, 0)
            log("K1 launches by shape: " + ", ".join(
                f"{r['key']} {r['launches']}" for r in rec["write"]["shapes"]))
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        record.write_text(json.dumps(rec, indent=1))
        return 1
    finally:
        torch.cuda.synchronize()
    rec["total_s"] = time.perf_counter() - t_start
    record.write_text(json.dumps(rec, indent=1))
    if only is not None:
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # every kernel adds its launches through the async phase's graph
    # replays (qwen3-4b and deepseek-v2-lite-16b at 4 layers), in the
    # packed phase's packed runs (sync and async, every model), in the
    # serve phase's runs (the launcher's measured passes, mixtral-8x22b and
    # internvl2-2b sync and async) and in the recurrent phase's
    # (recurrentgemma-9b sync and async), the whisper phase's
    # (whisper-small sync and async) and the host phase's (qwen3-4b with
    # the host tier, sync and async); K1-K4 a record at D 256 in ``shapes``
    # (K2 two: 4 and 8 lanes) and one at D 64, with registers and local
    # bytes;
    # K5, K6 and K7 add their launch's grid (K5/K7: and splits) and their
    # registers and local bytes as the loaded kernels report them; K5 and K7
    # the bound of the pages each reads (``own_bound_ms``) beside the
    # function's; K1 a record for each of its shapes, one launch's floor,
    # its host microseconds a call and the mixed shape with L2 left clean
    extra = ("blocks", "splits", "rows_per_block", "lanes_per_block",
             "registers", "local_bytes", "own_bound_ms", "shapes",
             "launch_floor_ms", "host_us", "clean_l2", "async_launches",
             "packed_launches", "serve_launches", "recurrent_launches",
             "whisper_launches", "host_launches", "launch_launches",
             "ms_without_state",
             "state_cost")
    print(json.dumps({"kernels": [
        {k: x[k] for k in keys + extra if k in keys or k in x}
        for x in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
