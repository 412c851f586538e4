// K2 — paged_pool_decode and K4 — paged_pool_decode_visits, for sm_90a.
//
// K2 replaces the Pallas kernel `paged_pool_decode` (src/repro/kernels/
// paged_gqa_decode.py, `_pool_kernel`): one query token per lane attends
// its pages of the GLOBAL pool through (physical, logical) page tables,
// with fused FP8 dequant, Opt-GQA head sharing (the G query heads of a kv
// head read each page once; MHA mode re-reads it per query head), the
// window + sink mask, and an online (m, l, acc) softmax over the lane's
// table slots in ascending order. A -1 entry is never loaded.
//
// K4 replaces `paged_pool_decode_visits` (`_visit_kernel`): the same math
// over the deduplicated (page, lane bitmask, logical page) visit list of
// `kernels/visits.plan_visits`. A page shared by N lanes is read once and
// updates every member lane's rows; non-member rows are left untouched
// (the Pallas kernel's exact identity update). Both kernels call the one
// `row_page_update` of paged_attention.cuh, and each lane's member visits
// arrive in ascending slot order, so K4 is bit-identical to K2.
//
// Bound on the H100: bytes. A decode step reads every live fp8 page once
// (ps * D bytes of K and of V plus 2 * ps f32 scales per page and head)
// and does about 4 * D operations per key and query head, far below the
// card's ratio of operations to bytes. Design: K2 runs one block per
// (lane, head) that stages each page tile in shared memory once for its
// G rows (8 warps, up to 2 rows each); K4 runs one block per head that stages each
// visited page once for all member lanes and keeps the B*G rows' (m, l,
// acc) in shared memory. K4's parallelism is only Hkv blocks; splitting
// pages across blocks (split-K) is later work.
#include "paged_attention.cuh"

namespace {

constexpr int kDecodeWarps = 8;     // K2: rows g = warp, warp + 8
constexpr int kDecodeRpw = 2;       // K2: rows per warp, so G <= 16
constexpr int kVisitWarps = 8;      // K4: rows r = warp, warp + 8, ...

struct DecodeMask {
  int lpage, ps, len, window, sink;
  __device__ __forceinline__ bool operator()(int j) const {
    const int pos = lpage * ps + j;
    bool ok = pos < len;
    if (window) ok = ok && (pos >= max(len - window, 0) || pos < sink * ps);
    return ok;
  }
};

struct DecodeArgs {
  const __nv_bfloat16* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* cache_len;
  const int* table_page;   // K2: phys (B, nsel); K4: visit_page (nv,)
  const int* table_log;    // K2: log (B, nsel);  K4: visit_log (nv,)
  const int* visit_lanes;  // K4 only
  __nv_bfloat16* out;
  int B, Hq, Hkv, ps, n, opt_gqa, window, sink;
  float sm_scale;
};

__device__ __forceinline__ void head_geometry(const DecodeArgs& a, int h,
                                              int& G, int& kvh) {
  if (a.opt_gqa) {
    G = a.Hq / a.Hkv;
    kvh = h;
  } else {
    G = 1;
    kvh = h / (a.Hq / a.Hkv);
  }
}

template <int DPL, typename KVT>
__global__ void __launch_bounds__(kDecodeWarps * 32) pool_decode_kernel(DecodeArgs a) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  KVT* k_tile = reinterpret_cast<KVT*>(smem);
  KVT* v_tile = k_tile + a.ps * D;
  float* k_sc = reinterpret_cast<float*>(v_tile + a.ps * D);
  float* v_sc = k_sc + a.ps;
  const bool scaled = a.k_scale != nullptr;

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  int G, kvh;
  head_geometry(a, h, G, kvh);
  const int len = a.cache_len[b];

  float q[kDecodeRpw][DPL], acc[kDecodeRpw][DPL], m[kDecodeRpw], l[kDecodeRpw];
#pragma unroll
  for (int r = 0; r < kDecodeRpw; ++r) {
    const int g = warp + r * kDecodeWarps;
    m[r] = PA_NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    if (g < G) load_q_row<DPL>(a.q + ((long long)b * a.Hq + h * G + g) * D, q[r]);
  }
  for (int s = 0; s < a.n; ++s) {
    const int page = a.table_page[b * a.n + s];
    if (page < 0) continue;                       // never loaded
    const DecodeMask mask{a.table_log[b * a.n + s], a.ps, len, a.window, a.sink};
    __syncthreads();
    load_page_tile<KVT>(static_cast<const KVT*>(a.k_pages), a.k_scale, page,
                        a.ps, a.Hkv, kvh, D, k_tile, k_sc);
    load_page_tile<KVT>(static_cast<const KVT*>(a.v_pages), a.v_scale, page,
                        a.ps, a.Hkv, kvh, D, v_tile, v_sc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDecodeRpw; ++r) {
      if (warp + r * kDecodeWarps >= G) break;
      row_page_update<DPL, KVT>(q[r], k_tile, v_tile, scaled ? k_sc : nullptr,
                                scaled ? v_sc : nullptr, a.ps, a.sm_scale, mask,
                                false, m[r], l[r], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kDecodeRpw; ++r) {
    const int g = warp + r * kDecodeWarps;
    if (g >= G) break;
    store_row<DPL>(a.out + ((long long)b * a.Hq + h * G + g) * D, acc[r], l[r]);
  }
}

template <int DPL, typename KVT>
__global__ void __launch_bounds__(kVisitWarps * 32) visit_decode_kernel(DecodeArgs a) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  KVT* k_tile = reinterpret_cast<KVT*>(smem);
  KVT* v_tile = k_tile + a.ps * D;
  float* k_sc = reinterpret_cast<float*>(v_tile + a.ps * D);
  float* v_sc = k_sc + a.ps;
  const bool scaled = a.k_scale != nullptr;

  const int h = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int G, kvh;
  head_geometry(a, h, G, kvh);
  const int rows = a.B * G;                  // row r = lane_b * G + g
  float* st_acc = v_sc + a.ps;               // (rows, D)
  float* st_m = st_acc + (long long)rows * D;
  float* st_l = st_m + rows;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) st_acc[i] = 0.f;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    st_m[i] = PA_NEG;
    st_l[i] = 0.f;
  }
  for (int v = 0; v < a.n; ++v) {
    const int page = a.table_page[v];
    if (page < 0) continue;                       // padding / non-owner
    const unsigned members = (unsigned)a.visit_lanes[v];
    const int lpage = a.table_log[v];
    __syncthreads();
    load_page_tile<KVT>(static_cast<const KVT*>(a.k_pages), a.k_scale, page,
                        a.ps, a.Hkv, kvh, D, k_tile, k_sc);
    load_page_tile<KVT>(static_cast<const KVT*>(a.v_pages), a.v_scale, page,
                        a.ps, a.Hkv, kvh, D, v_tile, v_sc);
    __syncthreads();
    for (int r = warp; r < rows; r += kVisitWarps) {
      const int b = r / G, g = r % G;
      if (((members >> b) & 1u) == 0u) continue;  // non-member: untouched
      float q[DPL], acc[DPL];
      load_q_row<DPL>(a.q + ((long long)b * a.Hq + h * G + g) * D, q);
      float* acc_row = st_acc + (long long)r * D + lane * DPL;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = acc_row[i];
      float m = st_m[r], l = st_l[r];
      const DecodeMask mask{lpage, a.ps, a.cache_len[b], a.window, a.sink};
      row_page_update<DPL, KVT>(q, k_tile, v_tile, scaled ? k_sc : nullptr,
                                scaled ? v_sc : nullptr, a.ps, a.sm_scale, mask,
                                false, m, l, acc);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc_row[i] = acc[i];
      __syncwarp();
      if (lane == 0) {
        st_m[r] = m;
        st_l[r] = l;
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < rows; r += kVisitWarps) {
    const int b = r / G, g = r % G;
    float acc[DPL];
    const float* acc_row = st_acc + (long long)r * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = acc_row[i];
    store_row<DPL>(a.out + ((long long)b * a.Hq + h * G + g) * D, acc, st_l[r]);
  }
}

template <int DPL, typename KVT>
int launch(const DecodeArgs& a, bool visits, cudaStream_t st) {
  constexpr int D = DPL * 32;
  const int heads = a.opt_gqa ? a.Hkv : a.Hq;
  const size_t tile = (size_t)2 * a.ps * D * sizeof(KVT) + (size_t)2 * a.ps * sizeof(float);
  if (!visits) {
    cudaError_t e = allow_smem(pool_decode_kernel<DPL, KVT>, tile);
    if (e != cudaSuccess) return (int)e;
    pool_decode_kernel<DPL, KVT><<<dim3(a.B, heads), kDecodeWarps * 32, tile, st>>>(a);
  } else {
    const int G = a.opt_gqa ? a.Hq / a.Hkv : 1;
    const size_t state = (size_t)a.B * G * (D + 2) * sizeof(float);
    cudaError_t e = allow_smem(visit_decode_kernel<DPL, KVT>, tile + state);
    if (e != cudaSuccess) return (int)e;
    visit_decode_kernel<DPL, KVT><<<heads, kVisitWarps * 32, tile + state, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int dispatch(const DecodeArgs& a, int d, int opt_kv, bool visits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d * 2 + (opt_kv ? 1 : 0)) {
    case 64 * 2 + 1: return launch<2, fp8_t>(a, visits, st);
    case 64 * 2: return launch<2, __nv_bfloat16>(a, visits, st);
    case 128 * 2 + 1: return launch<4, fp8_t>(a, visits, st);
    case 128 * 2: return launch<4, __nv_bfloat16>(a, visits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_pool_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* cache_len,
    const int* phys, const int* log, void* out, int B, int Hq, int Hkv, int d,
    int ps, int nsel, int opt_kv, int opt_gqa, int window, int sink,
    float sm_scale, void* stream) {
  DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
               k_scale, v_scale, cache_len, phys, log, nullptr,
               static_cast<__nv_bfloat16*>(out), B, Hq, Hkv, ps, nsel,
               opt_gqa, window, sink, sm_scale};
  return dispatch(a, d, opt_kv, false, stream);
}

extern "C" int paged_pool_decode_visits(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* cache_len,
    const int* visit_page, const int* visit_lanes, const int* visit_log,
    void* out, int B, int Hq, int Hkv, int d, int ps, int nv, int opt_kv,
    int opt_gqa, int window, int sink, float sm_scale, void* stream) {
  DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
               k_scale, v_scale, cache_len, visit_page, visit_log, visit_lanes,
               static_cast<__nv_bfloat16*>(out), B, Hq, Hkv, ps, nv,
               opt_gqa, window, sink, sm_scale};
  return dispatch(a, d, opt_kv, true, stream);
}
