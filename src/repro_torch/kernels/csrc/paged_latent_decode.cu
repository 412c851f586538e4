// K5 — paged_latent_decode and K7 — paged_latent_decode_visits, for sm_90a.
//
// K5 replaces the Pallas kernel `paged_latent_decode` (src/repro/kernels/
// paged_latent_decode.py, `_latent_kernel`): MLA decode in absorbed form.
// One query token per lane, its H heads already projected into latent
// space (q_lat = q_nope W_uk, f32), attends the lane's pages of the GLOBAL
// latent pool (P, ps, R+dr) through (physical, logical) page tables:
// dual-scale FP8 dequant, s = (<q_lat, c> + <q_rope, k_rope>) * sm_scale,
// the window + sink mask on logical positions, and an online (m, l, acc)
// softmax with acc in latent space (H, R), pages in ascending slot order.
// A -1 entry is never loaded. Returns o_lat (B, H, R) f32.
//
// K7 replaces `paged_latent_decode_visits` (`_latent_visit_kernel`): the
// same math over the deduplicated (page, lane bitmask, logical page) visit
// list of `kernels/visits.plan_visits`, so a prefix page shared by N lanes
// is read once per step. Both call the one `latent_row_page_update`, and a
// lane's member visits arrive in ascending slot order, so K7 equals K5 bit
// for bit; non-member rows are left untouched (an exact identity update).
//
// Bound on the H100: operations at the f32 rate. A decode step reads each
// selected latent page once (ps * (R + dr) fp8 bytes + 2 * ps f32 scales:
// 584 B per token at R 512, dr 64) but does 2 * (R + dr) + 2 * R f32
// operations per key and head, ~60 per byte at 16 heads, above the card's
// f32 ratio of operations to bytes (~20). Design: K5 runs one block
// per (lane, 4 heads), one warp per head row; each page is staged in
// shared memory once per block and read from there by its rows. K7 runs
// one block per head with every lane's (m, l, acc) in shared memory (the
// Pallas kernel's 512 x 512 f32 accumulator of 32 lanes x 16 heads does not
// fit one block), staging each visited page once per head. Both keep the
// pages' reuse across heads in L2 and have few blocks at small batch;
// splitting pages across blocks is later work.
#include "latent_attention.cuh"

namespace {

constexpr int kDecodeWarps = 4;     // K5: one head row per warp
constexpr int kVisitWarps = 8;      // K7: lane rows b = warp, warp + 8, ...

struct LatentArgs {
  const float* q_lat;      // (B, H, R)
  const float* q_rope;     // (B, H, dr)
  const void* pages;       // (P, ps, R + dr)
  const float* scales;     // (P, ps, 2) or null
  const int* cache_len;    // (B,)
  const int* table_page;   // K5: phys (B, n); K7: visit_page (n,)
  const int* table_log;    // K5: log (B, n);  K7: visit_log (n,)
  const int* visit_lanes;  // K7 only
  float* out;              // (B, H, R)
  int B, H, ps, n, window, sink;
  float sm_scale;
};

template <int DPC, int DPR, typename KVT>
__global__ void __launch_bounds__(kDecodeWarps * 32)
latent_decode_kernel(LatentArgs a) {
  constexpr int R = DPC * 32, DR = DPR * 32, W = R + DR;
  extern __shared__ __align__(16) unsigned char smem[];
  KVT* tile = reinterpret_cast<KVT*>(smem);
  float* tile_sc = reinterpret_cast<float*>(tile + a.ps * W);
  const bool scaled = a.scales != nullptr;

  const int b = blockIdx.x;
  const int h = blockIdx.y * kDecodeWarps + (threadIdx.x >> 5);
  const bool has_row = h < a.H;
  const int len = a.cache_len[b];
  float qc[DPC], qr[DPR], acc[DPC], m = PA_NEG, l = 0.f;
#pragma unroll
  for (int i = 0; i < DPC; ++i) qc[i] = acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DPR; ++i) qr[i] = 0.f;
  const long long row = (long long)b * a.H + h;
  if (has_row) load_latent_q<DPC, DPR>(a.q_lat + row * R, a.q_rope + row * DR, qc, qr);
  for (int s = 0; s < a.n; ++s) {
    const int page = a.table_page[b * a.n + s];
    if (page < 0) continue;                       // never loaded
    const LatentDecodeMask mask{a.table_log[b * a.n + s], a.ps, len, a.window, a.sink};
    __syncthreads();
    load_latent_tile<KVT>(static_cast<const KVT*>(a.pages), a.scales, page, a.ps,
                          W, tile, tile_sc);
    __syncthreads();
    if (has_row)
      latent_row_page_update<DPC, DPR, KVT>(qc, qr, tile, scaled ? tile_sc : nullptr,
                                            a.ps, a.sm_scale, mask, false, m, l, acc);
  }
  if (has_row) store_latent_row<DPC>(a.out + row * R, acc, l);
}

template <int DPC, int DPR, typename KVT>
__global__ void __launch_bounds__(kVisitWarps * 32)
latent_visit_kernel(LatentArgs a) {
  constexpr int R = DPC * 32, DR = DPR * 32, W = R + DR;
  extern __shared__ __align__(16) unsigned char smem[];
  KVT* tile = reinterpret_cast<KVT*>(smem);
  float* tile_sc = reinterpret_cast<float*>(tile + a.ps * W);
  float* st_acc = tile_sc + 2 * a.ps;           // (B, R)
  float* st_m = st_acc + (long long)a.B * R;    // (B,)
  float* st_l = st_m + a.B;                     // (B,)
  const bool scaled = a.scales != nullptr;

  const int h = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < a.B * R; i += blockDim.x) st_acc[i] = 0.f;
  for (int i = threadIdx.x; i < a.B; i += blockDim.x) {
    st_m[i] = PA_NEG;
    st_l[i] = 0.f;
  }
  for (int v = 0; v < a.n; ++v) {
    const int page = a.table_page[v];
    if (page < 0) continue;                       // padding / non-owner
    const unsigned members = (unsigned)a.visit_lanes[v];
    const int lpage = a.table_log[v];
    __syncthreads();
    load_latent_tile<KVT>(static_cast<const KVT*>(a.pages), a.scales, page, a.ps,
                          W, tile, tile_sc);
    __syncthreads();
    for (int b = warp; b < a.B; b += kVisitWarps) {
      if (((members >> b) & 1u) == 0u) continue;  // non-member: untouched
      const long long row = (long long)b * a.H + h;
      float qc[DPC], qr[DPR], acc[DPC];
      load_latent_q<DPC, DPR>(a.q_lat + row * R, a.q_rope + row * DR, qc, qr);
      float* acc_row = st_acc + (long long)b * R + lane * DPC;
#pragma unroll
      for (int i = 0; i < DPC; ++i) acc[i] = acc_row[i];
      float m = st_m[b], l = st_l[b];
      const LatentDecodeMask mask{lpage, a.ps, a.cache_len[b], a.window, a.sink};
      latent_row_page_update<DPC, DPR, KVT>(qc, qr, tile, scaled ? tile_sc : nullptr,
                                            a.ps, a.sm_scale, mask, false, m, l, acc);
#pragma unroll
      for (int i = 0; i < DPC; ++i) acc_row[i] = acc[i];
      __syncwarp();
      if (lane == 0) {
        st_m[b] = m;
        st_l[b] = l;
      }
    }
  }
  __syncthreads();
  for (int b = warp; b < a.B; b += kVisitWarps) {
    float acc[DPC];
    const float* acc_row = st_acc + (long long)b * R + lane * DPC;
#pragma unroll
    for (int i = 0; i < DPC; ++i) acc[i] = acc_row[i];
    store_latent_row<DPC>(a.out + ((long long)b * a.H + h) * R, acc, st_l[b]);
  }
}

template <int DPC, int DPR, typename KVT>
int launch(const LatentArgs& a, bool visits, cudaStream_t st) {
  constexpr int R = DPC * 32, W = R + DPR * 32;
  const size_t tile = (size_t)a.ps * W * sizeof(KVT) + (size_t)2 * a.ps * sizeof(float);
  if (!visits) {
    cudaError_t e = allow_smem(latent_decode_kernel<DPC, DPR, KVT>, tile);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(a.B, (a.H + kDecodeWarps - 1) / kDecodeWarps);
    latent_decode_kernel<DPC, DPR, KVT><<<grid, kDecodeWarps * 32, tile, st>>>(a);
  } else {
    const size_t state = (size_t)a.B * (R + 2) * sizeof(float);
    cudaError_t e = allow_smem(latent_visit_kernel<DPC, DPR, KVT>, tile + state);
    if (e != cudaSuccess) return (int)e;
    latent_visit_kernel<DPC, DPR, KVT><<<a.H, kVisitWarps * 32, tile + state, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int dispatch(const LatentArgs& a, int R, int dr, int opt_kv, bool visits,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 512 && dr == 64)
    return opt_kv ? launch<16, 2, fp8_t>(a, visits, st)
                  : launch<16, 2, __nv_bfloat16>(a, visits, st);
  if (R == 64 && dr == 32)
    return opt_kv ? launch<2, 1, fp8_t>(a, visits, st)
                  : launch<2, 1, __nv_bfloat16>(a, visits, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_latent_decode(
    const float* q_lat, const float* q_rope, const void* pages,
    const float* scales, const int* cache_len, const int* phys, const int* log,
    float* out, int B, int H, int R, int dr, int ps, int nsel, int opt_kv,
    int window, int sink, float sm_scale, void* stream) {
  LatentArgs a{q_lat, q_rope, pages, scales, cache_len, phys, log, nullptr,
               out, B, H, ps, nsel, window, sink, sm_scale};
  return dispatch(a, R, dr, opt_kv, false, stream);
}

extern "C" int paged_latent_decode_visits(
    const float* q_lat, const float* q_rope, const void* pages,
    const float* scales, const int* cache_len, const int* visit_page,
    const int* visit_lanes, const int* visit_log, float* out, int B, int H,
    int R, int dr, int ps, int nv, int opt_kv, int window, int sink,
    float sm_scale, void* stream) {
  LatentArgs a{q_lat, q_rope, pages, scales, cache_len, visit_page, visit_log,
               visit_lanes, out, B, H, ps, nv, window, sink, sm_scale};
  return dispatch(a, R, dr, opt_kv, true, stream);
}
