// Shared device code of the MLA latent decode kernels (K5
// paged_latent_decode, K7 paged_latent_decode_visits): the latent page load
// and the per-row online-softmax update in latent space. (K6
// latent_chunk_prefill runs its rows on the tensor cores instead.)
//
// A latent page is (ps, W) with W = R + dr: each token's line packs the
// compressed c_kv (R values) and the shared rotary key k_rope (dr values),
// in the pool's dtype (fp8 e4m3 or bf16), beside (ps, 2) f32 scales: column
// 0 dequantizes c_kv, column 1 k_rope (the Pallas kernels' Eq. 6).
//
// One warp owns one absorbed query row at a time. Lane t holds dims
// [t*DPC, (t+1)*DPC) of q_lat and of the f32 accumulator (R = 32 * DPC)
// and dims [t*DPR, (t+1)*DPR) of q_rope (dr = 32 * DPR). The score of key j
//   s_j = (<q_lat, c_j * sc0_j> + <q_rope, r_j * sc1_j>) * sm_scale
// is one FMA chain per lane (c dims, then rope dims) and an xor butterfly
// across the warp; the value of key j is c_j * sc0_j, so the accumulator
// stays in latent space and the w_uv expansion stays outside the kernels.
// Explicit round-to-nearest intrinsics and a fixed order (keys ascending)
// leave the compiler no contraction choices, so every kernel that calls
// this on the same row and page produces the same bits: K7 equals K5.
#pragma once

#include "paged_attention.cuh"

// Copy one latent page (ps * W contiguous values) and its (ps, 2) scales
// into shared memory, 16 bytes per thread per step; all threads take part.
template <typename KVT>
__device__ __forceinline__ void load_latent_tile(
    const KVT* __restrict__ pages, const float* __restrict__ scales,
    long long page, int ps, int W, KVT* tile, float* tile_scale) {
  const int chunks = (int)((long long)ps * W * sizeof(KVT) / 16);
  const uint4* src = reinterpret_cast<const uint4*>(pages + page * ps * W);
  uint4* dst = reinterpret_cast<uint4*>(tile);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) dst[c] = src[c];
  if (scales != nullptr) {
    for (int j = threadIdx.x; j < 2 * ps; j += blockDim.x)
      tile_scale[j] = scales[page * ps * 2 + j];
  }
}

// N consecutive values of a tile row as f32; vector loads where the lane's
// slice is a whole number of 16-byte words.
template <int N, typename KVT>
__device__ __forceinline__ void load_vals(const KVT* __restrict__ src,
                                          float (&out)[N]) {
  if constexpr ((N * sizeof(KVT)) % 16 == 0) {
    constexpr int kWords = N * sizeof(KVT) / 16;
    constexpr int kPer = 16 / sizeof(KVT);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[w];
      const KVT* v = reinterpret_cast<const KVT*>(&u);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[w * kPer + i] = kv_to_f32(v[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = kv_to_f32(src[i]);
  }
}

// Load a row's lane slices of q_lat (R f32) and q_rope (dr f32).
template <int DPC, int DPR>
__device__ __forceinline__ void load_latent_q(const float* __restrict__ ql,
                                              const float* __restrict__ qr,
                                              float (&qc)[DPC],
                                              float (&qrr)[DPR]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < DPC; ++i) qc[i] = ql[lane * DPC + i];
#pragma unroll
  for (int i = 0; i < DPR; ++i) qrr[i] = qr[lane * DPR + i];
}

// One page's online-softmax update of one absorbed query row (Eq. 10):
//   m' = max(m, max_j s_j); corr = exp(m - m')
//   p_j = exp(s_j - m')  (0 where !live(j) when hard_zero)
//   l' = l * corr + sum_j p_j;  acc' = acc * corr + sum_j p_j * c_j * sc0_j
// ``live`` is a functor of the key index j; masked keys score PA_NEG. Every
// lane ends with the same m and l.
template <int DPC, int DPR, typename KVT, typename LiveF>
__device__ __forceinline__ void latent_row_page_update(
    const float (&qc)[DPC], const float (&qr)[DPR],
    const KVT* __restrict__ tile, const float* __restrict__ scales, int ps,
    float sm_scale, const LiveF& live, bool hard_zero, float& m, float& l,
    float (&acc)[DPC]) {
  constexpr int R = DPC * 32;
  constexpr int W = R + DPR * 32;
  const int lane = threadIdx.x & 31;
  float s_own[PA_MAX_KPL];
  bool ok_own[PA_MAX_KPL];
  float mx = PA_NEG;
#pragma unroll
  for (int c = 0; c < PA_MAX_KPL; ++c) {
    s_own[c] = PA_NEG;
    ok_own[c] = false;
    for (int jj = 0; jj < 32; ++jj) {
      const int j = c * 32 + jj;
      if (j >= ps) break;
      const KVT* row = tile + j * W;
      float cv[DPC], rv[DPR];
      load_vals<DPC, KVT>(row + lane * DPC, cv);
      load_vals<DPR, KVT>(row + R + lane * DPR, rv);
      float part = 0.f;
      if (scales != nullptr) {
        const float s0 = scales[2 * j], s1 = scales[2 * j + 1];
#pragma unroll
        for (int i = 0; i < DPC; ++i)
          part = __fmaf_rn(qc[i], __fmul_rn(cv[i], s0), part);
#pragma unroll
        for (int i = 0; i < DPR; ++i)
          part = __fmaf_rn(qr[i], __fmul_rn(rv[i], s1), part);
      } else {
#pragma unroll
        for (int i = 0; i < DPC; ++i) part = __fmaf_rn(qc[i], cv[i], part);
#pragma unroll
        for (int i = 0; i < DPR; ++i) part = __fmaf_rn(qr[i], rv[i], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(PA_FULL, part, off));
      const bool ok = live(j);
      const float s = ok ? __fmul_rn(part, sm_scale) : PA_NEG;
      if (jj == lane) {
        s_own[c] = s;
        ok_own[c] = ok;
      }
      mx = fmaxf(mx, s);
    }
  }
  const float m_new = fmaxf(m, mx);
  const float corr = expf(__fsub_rn(m, m_new));
  float p_own[PA_MAX_KPL];
  float psum = 0.f;
#pragma unroll
  for (int c = 0; c < PA_MAX_KPL; ++c) {
    const bool exists = c * 32 + lane < ps;
    float p = 0.f;
    if (exists && !(hard_zero && !ok_own[c]))
      p = expf(__fsub_rn(s_own[c], m_new));
    p_own[c] = p;
    psum = __fadd_rn(psum, p);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    psum = __fadd_rn(psum, __shfl_xor_sync(PA_FULL, psum, off));
  l = __fadd_rn(__fmul_rn(l, corr), psum);

  float t[DPC];
#pragma unroll
  for (int i = 0; i < DPC; ++i) t[i] = 0.f;
#pragma unroll
  for (int c = 0; c < PA_MAX_KPL; ++c) {
    for (int jj = 0; jj < 32; ++jj) {
      const int j = c * 32 + jj;
      if (j >= ps) break;
      const float pj = __shfl_sync(PA_FULL, p_own[c], jj);
      float cv[DPC];
      load_vals<DPC, KVT>(tile + j * W + lane * DPC, cv);
      if (scales != nullptr) {
        const float s0 = scales[2 * j];
#pragma unroll
        for (int i = 0; i < DPC; ++i)
          t[i] = __fmaf_rn(pj, __fmul_rn(cv[i], s0), t[i]);
      } else {
#pragma unroll
        for (int i = 0; i < DPC; ++i) t[i] = __fmaf_rn(pj, cv[i], t[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DPC; ++i)
    acc[i] = __fadd_rn(__fmul_rn(acc[i], corr), t[i]);
  m = m_new;
}

// Final normalisation of one row: acc / max(l, 1e-30), kept in f32.
template <int DPC>
__device__ __forceinline__ void store_latent_row(float* __restrict__ out,
                                                 const float (&acc)[DPC],
                                                 float l) {
  const int lane = threadIdx.x & 31;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPC; ++i) out[lane * DPC + i] = __fdiv_rn(acc[i], den);
}

// Decode mask of K5/K7: the window + sink policy in the logical page
// domain, as the dense decode kernels (K2/K4).
struct LatentDecodeMask {
  int lpage, ps, len, window, sink;
  __device__ __forceinline__ bool operator()(int j) const {
    const int pos = lpage * ps + j;
    bool ok = pos < len;
    if (window) ok = ok && (pos >= max(len - window, 0) || pos < sink * ps);
    return ok;
  }
};
