// K3 — flash_chunk_prefill for sm_90a.
//
// Replaces the Pallas kernel `flash_chunk_prefill` (src/repro/kernels/
// flash_chunk_prefill.py, `_chunk_kernel`): a chunk of queries per lane,
// each with an absolute position, attends the lane's cached pages of the
// GLOBAL pool (earlier chunks, prefix-cache hits and the chunk itself,
// already written) through its physical page table. Rows are (seq, group)
// pairs, r = s * G + g, so each page is staged once for the G query heads
// of a kv head (MHA mode: G = 1, one head per block row set). Masks:
// causal, window + sink, and the concat-prefill packing planes (segment
// equality, key positions page_base * ps + i). Masked probabilities are
// hard-zeroed, so a cross-segment or wholly masked page adds exactly 0.
// A page is skipped when its table entry is -1 or its first key lies
// beyond every query of the tile (base * ps > max position in the tile).
//
// Bound on the H100: bytes at the engine's shapes (a chunk of S queries
// against ~1k cached tokens reads every page of the lane once from device
// memory; S * G * ps * D * 4 operations per page), operations once S * G
// grows past a few hundred rows per head. Design: one block per (lane,
// head, tile of 32 rows), 8 warps of 4 rows, each page tile staged in
// shared memory once per block and read by its 32 rows from there, with
// (m, l, acc) in registers. Tiles of the same lane re-read its pages from
// L2; wgmma tiles and TMA are later work.
#include "paged_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRpw = 4;                       // rows per warp
constexpr int kTileRows = kWarps * kRpw;      // rows per block

struct ChunkArgs {
  const __nv_bfloat16* q;       // (B, S, Hq, D)
  const int* positions;         // (B, S)
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* phys;              // (B, NP)
  const int* page_base;         // (B, NP) or null: base = slot
  const int* page_seg;          // (B, NP) or null: segment 0
  const int* seg_q;             // (B, S) or null: segment 0
  __nv_bfloat16* out;           // (B, S, Hq, D)
  int B, S, Hq, Hkv, ps, np, opt_gqa, window, sink;
  float sm_scale;
};

template <int DPL, typename KVT>
__global__ void __launch_bounds__(kWarps * 32) chunk_kernel(ChunkArgs a) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  KVT* k_tile = reinterpret_cast<KVT*>(smem);
  KVT* v_tile = k_tile + a.ps * D;
  float* k_sc = reinterpret_cast<float*>(v_tile + a.ps * D);
  float* v_sc = k_sc + a.ps;
  __shared__ int tile_max_pos;
  const bool scaled = a.k_scale != nullptr;

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.opt_gqa ? a.Hq / a.Hkv : 1;
  const int kvh = a.opt_gqa ? h : h / (a.Hq / a.Hkv);
  const int R = a.S * G;
  const int row0 = blockIdx.z * kTileRows;

  if (warp == 0) {                            // tile max position
    const int r = row0 + lane;
    int p = -1;
    if (r < R) p = a.positions[b * a.S + r / G];
    for (int off = 16; off > 0; off >>= 1) p = max(p, __shfl_xor_sync(PA_FULL, p, off));
    if (lane == 0) tile_max_pos = p;
  }

  float q[kRpw][DPL], acc[kRpw][DPL], m[kRpw], l[kRpw];
  int qpos[kRpw], qseg[kRpw];
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = row0 + warp * kRpw + i;
    m[i] = PA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
    qpos[i] = 0;
    qseg[i] = 0;
    if (r < R) {
      const int s = r / G, g = r % G;
      load_q_row<DPL>(a.q + (((long long)b * a.S + s) * a.Hq + h * G + g) * D, q[i]);
      qpos[i] = a.positions[b * a.S + s];
      if (a.seg_q != nullptr) qseg[i] = a.seg_q[b * a.S + s];
    }
  }
  __syncthreads();
  const int max_pos = tile_max_pos;

  for (int j = 0; j < a.np; ++j) {
    const int page = a.phys[b * a.np + j];
    const int base = a.page_base != nullptr ? a.page_base[b * a.np + j] : j;
    if (page < 0 || base * a.ps > max_pos) continue;   // never loaded
    const int pseg = a.page_seg != nullptr ? a.page_seg[b * a.np + j] : 0;
    __syncthreads();
    load_page_tile<KVT>(static_cast<const KVT*>(a.k_pages), a.k_scale, page,
                        a.ps, a.Hkv, kvh, D, k_tile, k_sc);
    load_page_tile<KVT>(static_cast<const KVT*>(a.v_pages), a.v_scale, page,
                        a.ps, a.Hkv, kvh, D, v_tile, v_sc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      if (row0 + warp * kRpw + i >= R) break;
      const ChunkMask mask{base, a.ps, qpos[i], qseg[i], pseg, a.window, a.sink};
      row_page_update<DPL, KVT>(q[i], k_tile, v_tile, scaled ? k_sc : nullptr,
                                scaled ? v_sc : nullptr, a.ps, a.sm_scale, mask,
                                true, m[i], l[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = row0 + warp * kRpw + i;
    if (r >= R) break;
    const int s = r / G, g = r % G;
    store_row<DPL>(a.out + (((long long)b * a.S + s) * a.Hq + h * G + g) * D, acc[i], l[i]);
  }
}

template <int DPL, typename KVT>
int launch(const ChunkArgs& a, cudaStream_t st) {
  constexpr int D = DPL * 32;
  const int heads = a.opt_gqa ? a.Hkv : a.Hq;
  const int G = a.opt_gqa ? a.Hq / a.Hkv : 1;
  const int tiles = (a.S * G + kTileRows - 1) / kTileRows;
  const size_t smem = (size_t)2 * a.ps * D * sizeof(KVT) + (size_t)2 * a.ps * sizeof(float);
  cudaError_t e = allow_smem(chunk_kernel<DPL, KVT>, smem);
  if (e != cudaSuccess) return (int)e;
  chunk_kernel<DPL, KVT><<<dim3(a.B, heads, tiles), kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_chunk_prefill(
    const void* q, const int* positions, const void* k_pages,
    const void* v_pages, const float* k_scale, const float* v_scale,
    const int* phys, const int* page_base, const int* page_seg,
    const int* seg_q, void* out, int B, int S, int Hq, int Hkv, int d, int ps,
    int np, int opt_kv, int opt_gqa, int window, int sink, float sm_scale,
    void* stream) {
  ChunkArgs a{static_cast<const __nv_bfloat16*>(q), positions, k_pages, v_pages,
              k_scale, v_scale, phys, page_base, page_seg, seg_q,
              static_cast<__nv_bfloat16*>(out), B, S, Hq, Hkv, ps, np, opt_gqa,
              window, sink, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d * 2 + (opt_kv ? 1 : 0)) {
    case 64 * 2 + 1: return launch<2, fp8_t>(a, st);
    case 64 * 2: return launch<2, __nv_bfloat16>(a, st);
    case 128 * 2 + 1: return launch<4, fp8_t>(a, st);
    case 128 * 2: return launch<4, __nv_bfloat16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
