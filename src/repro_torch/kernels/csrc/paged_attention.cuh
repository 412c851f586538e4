// Shared device code of the paged decode kernels (K2 paged_pool_decode,
// K4 paged_pool_decode_visits): the page-tile load and the per-row
// online-softmax update on the CUDA cores. K3 flash_chunk_prefill and K8
// flash_prefill no longer call `row_page_update`: they run their rows on
// the tensor cores through mma_attention.cuh, and take only `ChunkMask`
// (K3, as K6 does), the fp8 type and `allow_smem` from here.
//
// One warp owns one query row at a time. Lane t holds the row's dims
// [t*DPL, (t+1)*DPL) of q and of the f32 accumulator, so D = 32 * DPL. A
// page tile (ps keys) sits in shared memory in the pool's own dtype (fp8
// e4m3 or bf16) beside its per-(token, head) f32 scales, and is
// dequantized as it is read: f32(k) * scale, the Pallas kernels' Eq. 6.
//
// The update is written with explicit round-to-nearest intrinsics and a
// fixed reduction order (per-lane FMA chain over its dims, then an xor
// butterfly across the warp; keys ascending), so two kernels that call it
// on the same row and page produce the same bits. That is what makes K4
// bit-identical to K2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_NEG (-1e30f)
#define PA_MAX_PS 128
#define PA_MAX_KPL (PA_MAX_PS / 32)
#define PA_FULL 0xffffffffu

typedef __nv_fp8_storage_t fp8_t;   // raw e4m3 byte

__device__ __forceinline__ float kv_to_f32(fp8_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}
__device__ __forceinline__ float kv_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copy one (ps, D) page of one kv head into shared memory, 16 bytes per
// thread per step; all threads of the block take part. Row j of the tile is
// pool line (page * ps + j), head kvh. Scales are copied when given.
template <typename KVT>
__device__ __forceinline__ void load_page_tile(
    const KVT* __restrict__ pages, const float* __restrict__ scales,
    long long page, int ps, int hkv, int kvh, int D,
    KVT* tile, float* tile_scale) {
  const int chunks_per_row = (int)(D * sizeof(KVT) / 16);
  const int total = ps * chunks_per_row;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int j = c / chunks_per_row, w = c % chunks_per_row;
    const long long line = (page * ps + j) * hkv + kvh;
    const uint4* src = reinterpret_cast<const uint4*>(pages + line * D) + w;
    reinterpret_cast<uint4*>(tile + (long long)j * D)[w] = *src;
  }
  if (scales != nullptr) {
    for (int j = threadIdx.x; j < ps; j += blockDim.x)
      tile_scale[j] = scales[(page * ps + j) * hkv + kvh];
  }
}

// Load lane's DPL dims of a bf16 query row as f32.
template <int DPL>
__device__ __forceinline__ void load_q_row(const __nv_bfloat16* __restrict__ q,
                                           float (&qr)[DPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qr[i] = __bfloat162float(q[lane * DPL + i]);
}

// One page's online-softmax update of one query row (Eq. 10):
//   s_j   = <q, f32(k_j) * scale_j> * sm_scale, or PA_NEG where !live(j)
//   m'    = max(m, max_j s_j);  corr = exp(m - m')
//   p_j   = exp(s_j - m')  (0 where !live(j) when hard_zero)
//   l'    = l * corr + sum_j p_j;  acc' = acc * corr + sum_j p_j * v_j
// ``live`` is a functor of the key index j. Every lane ends with the same
// m and l.
template <int DPL, typename KVT, typename LiveF>
__device__ __forceinline__ void row_page_update(
    const float (&q)[DPL], const KVT* __restrict__ k_tile,
    const KVT* __restrict__ v_tile, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, int ps, float sm_scale,
    const LiveF& live, bool hard_zero, float& m, float& l,
    float (&acc)[DPL]) {
  constexpr int D = DPL * 32;
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
      const KVT* kr = k_tile + j * D + lane * DPL;
      float part = 0.f;
      if (k_scale != nullptr) {
        const float sc = k_scale[j];
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          part = __fmaf_rn(q[i], __fmul_rn(kv_to_f32(kr[i]), sc), part);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          part = __fmaf_rn(q[i], kv_to_f32(kr[i]), part);
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

  float t[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) t[i] = 0.f;
#pragma unroll
  for (int c = 0; c < PA_MAX_KPL; ++c) {
    for (int jj = 0; jj < 32; ++jj) {
      const int j = c * 32 + jj;
      if (j >= ps) break;
      const float pj = __shfl_sync(PA_FULL, p_own[c], jj);
      const KVT* vr = v_tile + j * D + lane * DPL;
      if (v_scale != nullptr) {
        const float sc = v_scale[j];
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          t[i] = __fmaf_rn(pj, __fmul_rn(kv_to_f32(vr[i]), sc), t[i]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          t[i] = __fmaf_rn(pj, kv_to_f32(vr[i]), t[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = __fadd_rn(__fmul_rn(acc[i], corr), t[i]);
  m = m_new;
}

// Final normalisation of one row: acc / max(l, 1e-30), rounded to bf16.
template <int DPL>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ out,
                                          const float (&acc)[DPL], float l) {
  const int lane = threadIdx.x & 31;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    out[lane * DPL + i] = __float2bfloat16_rn(__fdiv_rn(acc[i], den));
}

// Chunk mask of K3 and K6: causal on absolute positions, the row's segment
// equal to the page's (concat-prefill packing; key positions restart per
// segment at page_base * ps), and the window + sink policy.
struct ChunkMask {
  int base, ps, qpos, qseg, pseg, window, sink;
  __device__ __forceinline__ bool operator()(int j) const {
    const int kpos = base * ps + j;
    bool ok = kpos <= qpos && qseg == pseg;
    if (window) ok = ok && (kpos > qpos - window || kpos < sink * ps);
    return ok;
  }
};

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
