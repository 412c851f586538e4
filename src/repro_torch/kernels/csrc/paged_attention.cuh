// Device code shared by the attention kernels: the pool's fp8 type, the
// masked-score value and warp constants, K3's and K6's `ChunkMask`, and the
// dynamic shared-memory opt-in. K3/K8 take their tensor-core tile from
// mma_attention.cuh; K2/K4 (csrc/paged_gqa_decode.cu) its MMA and ldmatrix
// helpers beside their own tile update; K5, K6 and K7 their latent tile
// from latent_mma.cuh. Every kernel dequantizes as f32(k) * scale, the
// Pallas kernels' Eq. 6, with per-(token, head) f32 scales beside each page.
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
