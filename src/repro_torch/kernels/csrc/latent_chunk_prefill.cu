// K6 — latent_chunk_prefill for sm_90a.
//
// Replaces the Pallas kernel `latent_chunk_prefill` (src/repro/kernels/
// latent_chunk_prefill.py, `_latent_chunk_kernel`): the chunk analogue of
// K5 for the MLA family's mixed steps. A chunk of absorbed queries per lane
// (rows r = s * H + h in latent space, each with its token's absolute
// position; a decode lane is a chunk of length 1) attends the lane's cached
// latent pages of the GLOBAL pool (prefix hits, earlier chunks and the
// chunk itself, already written) through its physical page table. Masks:
// causal, window + sink, and the concat-prefill packing planes (segment
// equality, key positions page_base * ps + i), with masked probabilities
// hard-zeroed, so a cross-segment or wholly masked page adds exactly 0. A
// page is skipped when its entry is -1 or its first key lies beyond every
// query of the tile. Returns o_lat (B, S, H, R) f32.
//
// Bound on the H100: operations at the engine's shapes. Every row scores
// each causal key over R + dr dims and accumulates R dims (2 * (R + dr) +
// 2 * R operations per row and key), and a 512-token chunk
// of 16 heads carries 8192 rows per lane against the same ~1k-token
// history, far above the card's ratio of operations to bytes. Design: one
// block per (lane, tile of 16 rows, one token's heads at H = 16), 8 warps
// of 2 rows, each page tile staged in shared memory once per block, (m, l,
// acc) in registers, the shared `latent_row_page_update` of K5/K7 (CUDA
// cores, f32). Tiles of a lane re-read its pages from L2; tensor-core tiles
// and TMA are later work.
#include "latent_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRpw = 2;                       // rows per warp
constexpr int kTileRows = kWarps * kRpw;      // rows per block

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
  int B, S, H, ps, np, window, sink;
  float sm_scale;
};

template <int DPC, int DPR, typename KVT>
__global__ void __launch_bounds__(kWarps * 32)
latent_chunk_kernel(LatentChunkArgs a) {
  constexpr int R = DPC * 32, DR = DPR * 32, W = R + DR;
  extern __shared__ __align__(16) unsigned char smem[];
  KVT* tile = reinterpret_cast<KVT*>(smem);
  float* tile_sc = reinterpret_cast<float*>(tile + a.ps * W);
  __shared__ int tile_max_pos;
  const bool scaled = a.scales != nullptr;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int RW = a.S * a.H;
  const int row0 = blockIdx.y * kTileRows;

  if (warp == 0) {                            // tile max position
    const int r = row0 + lane;
    int p = -1;
    if (lane < kTileRows && r < RW) p = a.positions[b * a.S + r / a.H];
    for (int off = 16; off > 0; off >>= 1) p = max(p, __shfl_xor_sync(PA_FULL, p, off));
    if (lane == 0) tile_max_pos = p;
  }

  float qc[kRpw][DPC], qr[kRpw][DPR], acc[kRpw][DPC], m[kRpw], l[kRpw];
  int qpos[kRpw], qseg[kRpw];
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = row0 + warp * kRpw + i;
    m[i] = PA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPC; ++t) qc[i][t] = acc[i][t] = 0.f;
#pragma unroll
    for (int t = 0; t < DPR; ++t) qr[i][t] = 0.f;
    qpos[i] = 0;
    qseg[i] = 0;
    if (r < RW) {
      const long long row = (long long)b * RW + r;
      load_latent_q<DPC, DPR>(a.q_lat + row * R, a.q_rope + row * DR, qc[i], qr[i]);
      const int s = r / a.H;
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
    load_latent_tile<KVT>(static_cast<const KVT*>(a.pages), a.scales, page, a.ps,
                          W, tile, tile_sc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      if (row0 + warp * kRpw + i >= RW) break;
      const ChunkMask mask{base, a.ps, qpos[i], qseg[i], pseg, a.window, a.sink};
      latent_row_page_update<DPC, DPR, KVT>(qc[i], qr[i], tile,
                                            scaled ? tile_sc : nullptr, a.ps,
                                            a.sm_scale, mask, true, m[i], l[i],
                                            acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = row0 + warp * kRpw + i;
    if (r >= RW) break;
    store_latent_row<DPC>(a.out + ((long long)b * RW + r) * R, acc[i], l[i]);
  }
}

template <int DPC, int DPR, typename KVT>
int launch(const LatentChunkArgs& a, cudaStream_t st) {
  constexpr int W = DPC * 32 + DPR * 32;
  const int tiles = (a.S * a.H + kTileRows - 1) / kTileRows;
  const size_t smem = (size_t)a.ps * W * sizeof(KVT) + (size_t)2 * a.ps * sizeof(float);
  cudaError_t e = allow_smem(latent_chunk_kernel<DPC, DPR, KVT>, smem);
  if (e != cudaSuccess) return (int)e;
  latent_chunk_kernel<DPC, DPR, KVT><<<dim3(a.B, tiles), kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int latent_chunk_prefill(
    const float* q_lat, const float* q_rope, const int* positions,
    const void* pages, const float* scales, const int* phys,
    const int* page_base, const int* page_seg, const int* seg_q, float* out,
    int B, int S, int H, int R, int dr, int ps, int np, int opt_kv, int window,
    int sink, float sm_scale, void* stream) {
  LatentChunkArgs a{q_lat, q_rope, positions, pages, scales, phys, page_base,
                    page_seg, seg_q, out, B, S, H, ps, np, window, sink,
                    sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 512 && dr == 64)
    return opt_kv ? launch<16, 2, fp8_t>(a, st) : launch<16, 2, __nv_bfloat16>(a, st);
  if (R == 64 && dr == 32)
    return opt_kv ? launch<2, 1, fp8_t>(a, st) : launch<2, 1, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
