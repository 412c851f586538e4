// K1 — kv_cache_write for sm_90a.
//
// Replaces the Pallas kernel `kv_cache_write` (src/repro/kernels/
// kv_cache_write.py, `_write_kernel`): scatter each new token's K and V
// head vectors into its global flat slot of the paged pool, with the Opt-KV
// fused FP8 e4m3 quantize (per-(token, head) scale max(amax, 1e-12) / 448).
//
// Bound on the H100: bytes. It reads 2 * D bytes of bf16 per head vector and
// writes D bytes of fp8 plus one f32 scale, with a few operations per byte;
// at decode sizes it is one short launch. Design: one warp per (token,
// kv head, K|V) vector, D/32 values per lane, a warp max for amax, and
// the quantized bytes written straight from registers, so the unquantized
// vector never goes back to device memory.
//
// Exactness: the scale and x / scale use IEEE division (no fast math) and
// the fp8 conversion rounds to nearest even with saturation, so the pool
// bytes equal those of `quantize_fp8` (x / scale cast to float8_e4m3fn).
//
// SkipSet: on the TPU every slot < 0 is routed to the pool's last line (a
// sentinel written in grid order). Here blocks run in no order, so those
// writes would race; the kernel drops a slot < 0 (and any slot past the
// pool) instead and never touches the sentinel line.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <int DPL>
__global__ void __launch_bounds__(256) kv_write_kernel(
    const __nv_bfloat16* __restrict__ k_new, const __nv_bfloat16* __restrict__ v_new,
    const int* __restrict__ slots, long long n_items, int hkv,
    void* __restrict__ k_cache, void* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    long long n_slots, int opt_kv) {
  constexpr int D = DPL * 32;
  const long long item = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;
  const int which = (int)(item & 1);           // 0 = K, 1 = V
  const long long th = item >> 1;              // token * hkv + head
  const long long tok = th / hkv;
  const int h = (int)(th % hkv);
  const long long slot = slots[tok];
  if (slot < 0 || slot >= n_slots) return;     // SkipSet: dropped
  const __nv_bfloat16* src = (which ? v_new : k_new) + th * D;
  const long long line = (slot * hkv + h) * D;
  if (!opt_kv) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(which ? v_cache : k_cache);
#pragma unroll
    for (int i = 0; i < DPL; ++i) dst[line + lane + 32 * i] = src[lane + 32 * i];
    return;
  }
  float x[DPL];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    x[i] = __bfloat162float(src[lane + 32 * i]);
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 448.0f);
  __nv_fp8_storage_t* dst =
      static_cast<__nv_fp8_storage_t*>(which ? v_cache : k_cache);
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    dst[line + lane + 32 * i] =
        __nv_cvt_float_to_fp8(__fdiv_rn(x[i], scale), __NV_SATFINITE, __NV_E4M3);
  if (lane == 0) (which ? v_scale : k_scale)[slot * hkv + h] = scale;
}

extern "C" int kv_cache_write(const void* k_new, const void* v_new,
                              const int* slots, long long n_tokens, int hkv,
                              int d, void* k_cache, void* v_cache,
                              float* k_scale, float* v_scale,
                              long long n_slots, int opt_kv, void* stream) {
  const long long n_items = n_tokens * hkv * 2;
  if (n_items == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_items * 32 + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* kn = static_cast<const __nv_bfloat16*>(k_new);
  const __nv_bfloat16* vn = static_cast<const __nv_bfloat16*>(v_new);
  switch (d) {
    case 64:
      kv_write_kernel<2><<<blocks, threads, 0, st>>>(kn, vn, slots, n_items, hkv,
          k_cache, v_cache, k_scale, v_scale, n_slots, opt_kv);
      break;
    case 128:
      kv_write_kernel<4><<<blocks, threads, 0, st>>>(kn, vn, slots, n_items, hkv,
          k_cache, v_cache, k_scale, v_scale, n_slots, opt_kv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
