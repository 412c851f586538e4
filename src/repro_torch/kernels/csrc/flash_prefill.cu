// K8 — flash_prefill for sm_90a.
//
// Replaces the Pallas kernel `flash_prefill` (src/repro/kernels/
// flash_prefill.py, `_prefill_kernel`): causal (optionally windowed)
// grouped-query flash attention of a whole prompt over its own contiguous
// bf16 K/V, used by the dense family's full-prompt prefill. q (B, S, Hq, D)
// against k, v (B, T, Hkv, D); query rows are (seq, group) pairs of one kv
// head, r = s * G + g with G = Hq / Hkv (G = 1 when the caller expanded
// K/V per query head), at position q_offset + s. The softmax is an online
// (m, l, acc) over key blocks of 64 in ascending order; key blocks wholly
// in the future of a tile, or wholly before its window, are skipped.
// Returns (B, S, Hq, D) bf16.
//
// Bound on the H100: operations. A 2048-token prompt does about
// 4 * D operations per (query head, causal key) pair, some 2 * S / D times
// the bytes of q, k, v and the output. Design: one block per (lane, kv
// head, tile of 32 rows), 8 warps of 4 rows, each 64-key block of K and V
// staged in shared memory once per block, (m, l, acc) in registers, and
// the shared `row_page_update` of the paged kernels (CUDA cores, f32 FMA
// chains). Tensor-core (wgmma) tiles and TMA are later work.
#include "paged_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRpw = 4;                       // rows per warp
constexpr int kTileRows = kWarps * kRpw;      // rows per block
constexpr int kBlockK = 64;                   // keys per staged block

struct PrefillMask {
  int k0, spos, window;
  __device__ __forceinline__ bool operator()(int j) const {
    const int kpos = k0 + j;
    bool ok = kpos <= spos;
    if (window) ok = ok && spos - kpos < window;
    return ok;
  }
};

struct PrefillArgs {
  const __nv_bfloat16* q;   // (B, S, Hq, D)
  const __nv_bfloat16* k;   // (B, T, Hkv, D)
  const __nv_bfloat16* v;   // (B, T, Hkv, D)
  __nv_bfloat16* out;       // (B, S, Hq, D)
  int B, S, T, Hq, Hkv, window, q_offset;
  float sm_scale;
};

// Rows [k0, k0 + nk) of kv head kvh of lane b into a (nk, D) tile.
__device__ __forceinline__ void load_kv_rows(
    const __nv_bfloat16* __restrict__ src, long long b, int T, int Hkv,
    int kvh, int D, int k0, int nk, __nv_bfloat16* tile) {
  const int chunks_per_row = D * 2 / 16;
  for (int c = threadIdx.x; c < nk * chunks_per_row; c += blockDim.x) {
    const int j = c / chunks_per_row, w = c % chunks_per_row;
    const long long line = (b * T + k0 + j) * Hkv + kvh;
    reinterpret_cast<uint4*>(tile + (long long)j * D)[w] =
        reinterpret_cast<const uint4*>(src + line * D)[w];
  }
}

template <int DPL>
__global__ void __launch_bounds__(kWarps * 32) prefill_kernel(PrefillArgs a) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_tile = k_tile + kBlockK * D;

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int G = a.Hq / a.Hkv;
  const int R = a.S * G;
  const int row0 = blockIdx.z * kTileRows;
  const int q_first = a.q_offset + row0 / G;
  const int q_last = a.q_offset + (min(row0 + kTileRows, R) - 1) / G;

  float q[kRpw][DPL], acc[kRpw][DPL], m[kRpw], l[kRpw];
  int spos[kRpw];
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = row0 + warp * kRpw + i;
    m[i] = PA_NEG;
    l[i] = 0.f;
    spos[i] = 0;
#pragma unroll
    for (int t = 0; t < DPL; ++t) q[i][t] = acc[i][t] = 0.f;
    if (r < R) {
      const int s = r / G, g = r % G;
      load_q_row<DPL>(a.q + (((long long)b * a.S + s) * a.Hq + h * G + g) * D, q[i]);
      spos[i] = a.q_offset + s;
    }
  }
  for (int k0 = 0; k0 < a.T && k0 <= q_last; k0 += kBlockK) {
    if (a.window && k0 + kBlockK - 1 < q_first - a.window + 1) continue;
    const int nk = min(kBlockK, a.T - k0);
    __syncthreads();
    load_kv_rows(a.k, b, a.T, a.Hkv, h, D, k0, nk, k_tile);
    load_kv_rows(a.v, b, a.T, a.Hkv, h, D, k0, nk, v_tile);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      if (row0 + warp * kRpw + i >= R) break;
      const PrefillMask mask{k0, spos[i], a.window};
      row_page_update<DPL, __nv_bfloat16>(q[i], k_tile, v_tile, nullptr, nullptr,
                                          nk, a.sm_scale, mask, false, m[i], l[i],
                                          acc[i]);
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

template <int DPL>
int launch(const PrefillArgs& a, cudaStream_t st) {
  const int G = a.Hq / a.Hkv;
  const int tiles = (a.S * G + kTileRows - 1) / kTileRows;
  const size_t smem = (size_t)2 * kBlockK * DPL * 32 * sizeof(__nv_bfloat16);
  prefill_kernel<DPL><<<dim3(a.B, a.Hkv, tiles), kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int S, int T, int Hq, int Hkv,
                             int d, int window, int q_offset, float sm_scale,
                             void* stream) {
  PrefillArgs a{static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v),
                static_cast<__nv_bfloat16*>(out), B, S, T, Hq, Hkv, window,
                q_offset, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<2>(a, st);
    case 128: return launch<4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
