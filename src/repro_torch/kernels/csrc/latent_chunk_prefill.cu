// K6 — latent_chunk_prefill for sm_90a, on the tensor cores.
//
// Replaces the Pallas kernel `latent_chunk_prefill` (src/repro/kernels/
// latent_chunk_prefill.py, `_latent_chunk_kernel`): the chunk analogue of
// K5 for the MLA family's mixed steps. A chunk of absorbed queries per lane
// (rows r = s * H + h in latent space, each with its token's absolute
// position; a decode lane is a chunk of length 1) attends the lane's cached
// latent pages of the GLOBAL pool (prefix hits, earlier chunks and the
// chunk itself, already written) through its physical page table. Masks:
// causal, window + sink, and the concat-prefill packing planes (segment
// equality, key positions page_base * ps + i), evaluated per row, with
// masked probabilities hard-zeroed, so a cross-segment or wholly masked
// page adds exactly 0 and a row that sees no live key writes 0. A page is
// never loaded when its entry is -1, and a 64-key tile of it is skipped
// when its first key lies beyond every query of the block. Pages are
// reduced in ascending slot order. Returns o_lat (B, S, H, R) f32.
//
// Bound on the H100: operations. Every row scores each causal key over
// R + dr dims and accumulates R dims (2 * (R + dr) + 2 * R operations per
// row and key); a 512-token chunk of 16 heads is 8192 rows a lane against
// the same ~1k-token history, far above the card's ratio of operations to
// bytes. Those operations run on the tensor cores through the latent tile of
// csrc/latent_mma.cuh (`lmma::WarpTile`, shared with K5 and K7): q as three
// bf16 terms, P' = p * sc0 as two, fp8 -> bf16 exact, each key's scales
// after the MMA. At chip_smoke.py's kernel-phase shape (4 lanes of 8192
// rows) an H100 read 0.98 of the f32 tolerance with two q terms (1.12 with
// the packing planes) and 0.43 with three. The tensor cores execute 2.6x
// the bound's operations.
//
// The accumulator is the constraint: a row's is R = 512 f32 wide, so a warp
// owning 16 whole rows would hold 256 accumulator registers a thread.
// Design: one block of 8 warps per (lane, tile of kRows rows); the warps
// form row groups of 16 rows and CW warps each (R 512: 2 groups of 4, 32
// rows a block), each warp owning R / CW latent columns of its group's
// accumulator. The raw fp8 tile of 64 keys (and its f32 scales) is staged by
// cp.async, converted once per block and tile into one XOR-swizzled bf16
// tile, and the next raw tile is in flight while this one computes; a bf16
// pool is staged straight into the bf16 tile. A page shorter than 64 keys
// fills a tile whose rows (and scales) past its end are zero and whose
// columns there are masked. With `return_state` (m_out and l_out set) the
// epilogue also stores each row's final (m, l), m in natural units and a
// row that saw no live key as -1e30 and 0 (latent_mma.cuh). wgmma, TMA and
// warp specialisation are later work.
#include <climits>

#include "latent_mma.cuh"

namespace {

using namespace lmma;

constexpr int kWarps = 8;

struct LatentChunkArgs {
  const float* q_lat;      // (B, S * H, R)
  const float* q_rope;     // (B, S * H, dr)
  const int* positions;    // (B, S)
  const void* pages;       // (P, ps, R + dr)
  const float* scales;     // (P, ps, 2) or null
  const int* phys;         // (B, NP)
  const int* page_base;    // (B, NP) or null: base = slot
  const int* page_seg;     // (B, NP) or null: segment 0
  const int* seg_q;        // (B, S) or null: segment 0
  float* out;              // (B, S * H, R)
  float* m_out;            // (B, S * H) final m, natural units, or null
  float* l_out;            // (B, S * H) final l, or null
  int B, S, H, ps, np, window, sink;
  float sm_scale;
};

template <int R, int DR, int CW, typename KVT>
__global__ void __launch_bounds__(kWarps * 32, 1)
latent_chunk_kernel(LatentChunkArgs a) {
  using G = Geo<R, DR, CW, kWarps>;
  constexpr int W = G::W, WS = G::WS;
  constexpr bool kFp8 = sizeof(KVT) == 1;
  using SM = Smem<R, DR, CW, kWarps, kFp8>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = mma::smem_addr(smem);
  const uint32_t tile = base, qs = base + SM::q;
  __shared__ int warp_max[kWarps];
  const int ps = a.ps;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int RW = a.S * a.H;
  const int w0 = blockIdx.y * G::kRows + (warp / CW) * 16;  // the group's first row
  const long long row_base = (long long)b * RW;

  // this lane's rows g and g + 8 of the group, and the group's smallest and
  // largest position over its rows below RW
  int qpos[2], qseg[2];
  bool real[2];
  int wmax = INT_MIN, wmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + (lane >> 2) + 8 * i;
    real[i] = r < RW;
    const int s = real[i] ? r / a.H : 0;
    qpos[i] = real[i] ? a.positions[b * a.S + s] : 0;
    qseg[i] = real[i] && a.seg_q != nullptr ? a.seg_q[b * a.S + s] : 0;
    if (real[i]) {
      wmax = max(wmax, qpos[i]);
      wmin = min(wmin, qpos[i]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(PA_FULL, wmax, off));
    wmin = min(wmin, __shfl_xor_sync(PA_FULL, wmin, off));
  }
  if (lane == 0) warp_max[warp] = wmax;

  WarpTile<R, DR, CW, kWarps> wt;
  wt.init(a.q_lat, a.q_rope, row_base, w0, RW, qs);
  __syncthreads();
  int max_pos = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) max_pos = max(max_pos, warp_max[w]);

  const int* phys = a.phys + b * a.np;
  auto base_of = [&](int j) { return a.page_base != nullptr ? a.page_base[b * a.np + j] : j; };
  const int nt = (ps + kKeys - 1) / kKeys;    // tiles a page
  const int total = a.np * nt;
  auto next_live = [&](int t) {               // tile t = slot * nt + part
    for (; t < total; ++t) {
      const int j = t / nt;
      if (phys[j] >= 0 && base_of(j) * ps + (t % nt) * kKeys <= max_pos) break;
    }
    return t;
  };
  // stage tile t: fp8 into the raw tile and scale rows `buf`, bf16 straight
  // into the swizzled tile (rows nk..64 zeroed)
  auto stage = [&](int t, int buf) {
    const int j0 = (t % nt) * kKeys;
    const int nk = min(kKeys, ps - j0);
    const long long first = (long long)phys[t / nt] * ps + j0;   // first key line
    if constexpr (kFp8)
      stage_raw<W>(base + SM::raw, base + SM::sc + buf * kKeys * 8,
                   static_cast<const unsigned char*>(a.pages) + first * W, a.scales + first * 2, nk);
    else
      stage_bf16<W, WS>(tile, static_cast<const __nv_bfloat16*>(a.pages) + first * W, nk);
    mma::cp_commit();
  };

  const float scale_log2 = a.sm_scale * mma::kLog2e;
  const uint32_t part = base + SM::part;

  int t = next_live(0);
  if (t < total) stage(t, 0);
  for (int buf = 0; t < total; buf ^= 1) {
    mma::cp_wait_all();
    __syncthreads();            // tile t staged; every warp done with the last one
    const int tn = next_live(t + 1);
    const int j = t / nt, j0 = (t % nt) * kKeys;
    const int nk = min(kKeys, ps - j0);
    if constexpr (kFp8) {       // e4m3 -> bf16, exact; rows (and scales) nk..64 zeroed
      convert_raw<W, WS>(tile, smem + SM::raw,
                         reinterpret_cast<float*>(smem + SM::sc) + buf * kKeys * 2, nk);
      __syncthreads();          // the raw tile is free: the next one lands during this compute
      if (tn < total) stage(tn, buf ^ 1);
    }
    const int pbase = base_of(j);
    const int kbase = pbase * ps + j0;
    if (kbase <= wmax) {        // else wholly in the future of the group (all its warps)
      const int pseg = a.page_seg != nullptr ? a.page_seg[b * a.np + j] : 0;
      // the tile wholly visible to the group's rows: every key at or before
      // each row, inside its window or sink, and in its segment
      const bool all_live =
          kbase + nk - 1 <= wmin &&
          (!a.window || kbase > wmax - a.window || kbase + nk <= a.sink * ps) &&
          __all_sync(PA_FULL, (!real[0] || qseg[0] == pseg) && (!real[1] || qseg[1] == pseg));
      const ChunkMask mk[2] = {{pbase, ps, qpos[0], qseg[0], pseg, a.window, a.sink},
                               {pbase, ps, qpos[1], qseg[1], pseg, a.window, a.sink}};
      wt.template update<kFp8>(tile, qs, base + SM::sc + buf * kKeys * 8, part, j0, nk,
                               all_live, mk, scale_log2);
    }
    if constexpr (!kFp8) {
      __syncthreads();          // every warp done with the tile
      if (tn < total) stage(tn, 0);
    }
    t = tn;
  }
  // the rows' offsets recomputed here, not kept live across the loop
  wt.store(a.out, (long long)blockIdx.x * (a.S * a.H),
           blockIdx.y * G::kRows + (threadIdx.x >> 5) / CW * 16, a.S * a.H, a.m_out,
           a.l_out);
}

// One instantiation: the rows' split (CW warps a row group) and the pool type.
template <int R_, int DR_, int CW_, typename KVT_>
struct Inst {
  static constexpr int R = R_, DR = DR_, CW = CW_;
  using KVT = KVT_;
};

// f(Inst<...>{}) for the instantiation that serves (R, dr, opt_kv)
template <typename F>
int dispatch(int R, int dr, int opt_kv, F&& f) {
  if (R == 512 && dr == 64)     // 2 row groups of 4 warps: 32 rows a block
    return opt_kv ? f(Inst<512, 64, 4, fp8_t>{}) : f(Inst<512, 64, 4, __nv_bfloat16>{});
  if (R == 64 && dr == 32)      // 8 row groups of 1 warp: 128 rows a block
    return opt_kv ? f(Inst<64, 32, 1, fp8_t>{}) : f(Inst<64, 32, 1, __nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

int g_last_blocks = 0;          // blocks of this library's last launch

template <class I>
int launch(const LatentChunkArgs& a, cudaStream_t st) {
  using G = Geo<I::R, I::DR, I::CW, kWarps>;
  const auto kernel = latent_chunk_kernel<I::R, I::DR, I::CW, typename I::KVT>;
  const int tiles = (a.S * a.H + G::kRows - 1) / G::kRows;
  const int smem = Smem<I::R, I::DR, I::CW, kWarps, sizeof(typename I::KVT) == 1>::kBytes;
  // always opt in: the static tile-max array sits on top of the dynamic bytes
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.B, tiles), kWarps * 32, smem, st>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) g_last_blocks = a.B * tiles;
  return (int)e;
}

// info = {rows a block, threads a block, dynamic shared bytes, registers a
// thread, local bytes a thread (spills and stack), bf16 terms of q, bf16
// terms of P', blocks of the last launch}, the registers and local bytes
// as the loaded kernel reports them
template <class I>
int describe(int* info) {
  using G = Geo<I::R, I::DR, I::CW, kWarps>;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(
      &fa, latent_chunk_kernel<I::R, I::DR, I::CW, typename I::KVT>);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {G::kRows, kWarps * 32,
                    Smem<I::R, I::DR, I::CW, kWarps, sizeof(typename I::KVT) == 1>::kBytes,
                    fa.numRegs, (int)fa.localSizeBytes, kQTerms, kPTerms, g_last_blocks};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

}  // namespace

extern "C" int latent_chunk_prefill(
    const float* q_lat, const float* q_rope, const int* positions,
    const void* pages, const float* scales, const int* phys,
    const int* page_base, const int* page_seg, const int* seg_q, float* out,
    float* m_out, float* l_out, int B, int S, int H, int R, int dr, int ps,
    int np, int opt_kv, int window, int sink, float sm_scale, void* stream) {
  LatentChunkArgs a{q_lat, q_rope, positions, pages, scales, phys, page_base,
                    page_seg, seg_q, out, m_out, l_out, B, S, H, ps, np, window,
                    sink, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(R, dr, opt_kv, [&](auto inst) { return launch<decltype(inst)>(a, st); });
}

// The geometry and compiled resources of the instantiation that
// latent_chunk_prefill runs for (R, dr, opt_kv): info[0..7] as `describe`.
extern "C" int latent_chunk_prefill_info(int R, int dr, int opt_kv, int* info) {
  return dispatch(R, dr, opt_kv, [&](auto inst) { return describe<decltype(inst)>(info); });
}
