// K1 — kv_cache_write for sm_90a.
//
// Replaces the Pallas kernel `kv_cache_write` (src/repro/kernels/
// kv_cache_write.py, `_write_kernel`): scatter each new token's K and V
// head vectors into its global flat slot of the paged pool, with the Opt-KV
// fused FP8 e4m3 quantize (per-(token, head) scale max(amax, 1e-12) / 448).
//
// Bound on the H100: bytes, and at the engine's sizes the latency of one
// launch (slot, then row, then store). It reads 2 * D bytes of bf16 per
// head vector and writes D bytes of fp8 plus one f32 scale, with a few
// operations per byte. Design:
// - D/8 threads (a group: a warp at D 256, half one at 128) own one
//   (token, K|V, head) vector; each thread
//   moves 8 values with one 16-byte load, and for fp8 one 8-byte store of
//   four packed pairs, so a group reads one 2*D-byte row and writes one
//   D-byte line. amax is a butterfly inside the group.
// - Vectors are ordered (token, K|V, head): a token's K heads, then its V
//   heads, contiguous in k_new / v_new and in the pool line of its slot.
// - The launch plan (threads a block, vectors a thread, blocks) comes from
//   the wrapper (`kv_cache_write.write_plan`). A block covers a contiguous
//   run of vectors, a thread's second vector `groups` after its first, so
//   each load instruction of a block reads one contiguous span. A thread
//   issues its slot loads, then its row loads, before any division or
//   store. Two vectors a thread halve the threads of a large launch (one
//   wave at 2 x 2048 tokens of 8 heads); a small one takes one vector a
//   thread, spread over more SMs.
//
// Exactness: amax is taken on the bf16 bits (for finite values their order
// is that of |x|), the scale and x / scale use IEEE division (`__fdiv_rn`;
// no fast math, no multiply by the reciprocal) and the fp8 conversion rounds
// to nearest even with saturation, so the pool bytes equal those of
// `quantize_fp8` (x / scale cast to float8_e4m3fn).
//
// SkipSet: on the TPU every slot < 0 is routed to the pool's last line (a
// sentinel written in grid order). Here blocks run in no order, so those
// writes would race; the kernel drops a slot < 0 (and any slot past the
// pool) before its row is read, and never touches the sentinel line.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

constexpr int kMaxThreads = 128;   // kv_cache_write.THREADS

// Two bf16 values (one 32-bit word, low half first) over `scale`, as two
// e4m3 bytes, the first in the low byte. bf16 -> f32 is exact by placing
// the bits; the division is IEEE (`__fdiv_rn`).
__device__ __forceinline__ uint32_t fp8x2(uint32_t w, float scale) {
  const float lo = __uint_as_float(w << 16);
  const float hi = __uint_as_float(w & ~0xffffu);
  return __nv_cvt_float2_to_fp8x2(
      make_float2(__fdiv_rn(lo, scale), __fdiv_rn(hi, scale)), __NV_SATFINITE,
      __NV_E4M3);                  // .x (lo) in the low byte
}

// The fp8 lines of a thread's vectors: amax over the group, the scale,
// 8 quantized values (one 8-byte store) and the group's scale.
template <int D, int VECS>
__device__ __forceinline__ void quantize_store(
    const uint4 (&x)[VECS], const int (&line)[VECS], const bool (&is_v)[VECS],
    int sub, void* k_cache, void* v_cache, float* k_scale, float* v_scale) {
  constexpr int G = D / 8;
  constexpr uint32_t kAbs = 0x7fff7fffu;
  // amax as bf16 bits. Every thread of the block reaches every shuffle (a
  // dropped or absent vector carries 0), so the full-warp mask holds.
  uint32_t amax[VECS];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const uint32_t m = __vmaxu2(__vmaxu2(x[i].x & kAbs, x[i].y & kAbs),
                                __vmaxu2(x[i].z & kAbs, x[i].w & kAbs));
    amax[i] = max(m & 0xffffu, m >> 16);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      amax[i] = max(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], off));
  }
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    if (line[i] < 0) continue;
    const float a = __uint_as_float(amax[i] << 16);
    const float scale = __fdiv_rn(a < 1e-12f ? 1e-12f : a, 448.0f);
    const uint2 q =
        make_uint2(fp8x2(x[i].x, scale) | (fp8x2(x[i].y, scale) << 16),
                   fp8x2(x[i].z, scale) | (fp8x2(x[i].w, scale) << 16));
    static_cast<uint2*>(is_v[i] ? v_cache : k_cache)
        [(long long)line[i] * G + sub] = q;
    if (sub == 0) (is_v[i] ? v_scale : k_scale)[line[i]] = scale;
  }
}

template <int D, bool OPT_KV, int VECS>
__global__ void __launch_bounds__(kMaxThreads, 16) kv_write_kernel(
    const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
    const int* __restrict__ slots, int n_vecs, int hkv,
    void* __restrict__ k_cache, void* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale, int n_slots) {
  constexpr int G = D / 8;                    // threads a vector
  const int sub = threadIdx.x % G;            // this thread's 8 values
  const int groups = blockDim.x / G;
  const int first = blockIdx.x * groups * VECS + threadIdx.x / G;
  const int per_tok = 2 * hkv;
  int line[VECS];                             // slot * hkv + head, or -1
  int row[VECS];                              // token * hkv + head
  bool is_v[VECS];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int v = first + i * groups;
    line[i] = -1;
    row[i] = 0;
    is_v[i] = false;
    if (v < n_vecs) {
      const int tok = v / per_tok;
      const int r = v - tok * per_tok;        // which * hkv + head
      is_v[i] = r >= hkv;
      const int h = is_v[i] ? r - hkv : r;
      const int slot = slots[tok];
      row[i] = tok * hkv + h;
      if (slot >= 0 && slot < n_slots) line[i] = slot * hkv + h;
    }
  }
  uint4 x[VECS];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    x[i] = make_uint4(0u, 0u, 0u, 0u);
    if (line[i] >= 0)
      x[i] = (is_v[i] ? v_new : k_new)[(long long)row[i] * G + sub];
  }
  if constexpr (OPT_KV) {
    quantize_store<D, VECS>(x, line, is_v, sub, k_cache, v_cache, k_scale,
                            v_scale);
  } else {
#pragma unroll
    for (int i = 0; i < VECS; ++i)
      if (line[i] >= 0)
        static_cast<uint4*>(is_v[i] ? v_cache : k_cache)
            [(long long)line[i] * G + sub] = x[i];
  }
}

using WriteKernel = void (*)(const uint4*, const uint4*, const int*, int, int,
                            void*, void*, float*, float*, int);

// The instantiation for (d, opt_kv, vecs), or null.
WriteKernel kernel_of(int d, int opt_kv, int vecs) {
  static const WriteKernel kernels[3][2][2] = {   // [D 64|128|256][opt_kv][vecs - 1]
      {{kv_write_kernel<64, false, 1>, kv_write_kernel<64, false, 2>},
       {kv_write_kernel<64, true, 1>, kv_write_kernel<64, true, 2>}},
      {{kv_write_kernel<128, false, 1>, kv_write_kernel<128, false, 2>},
       {kv_write_kernel<128, true, 1>, kv_write_kernel<128, true, 2>}},
      {{kv_write_kernel<256, false, 1>, kv_write_kernel<256, false, 2>},
       {kv_write_kernel<256, true, 1>, kv_write_kernel<256, true, 2>}}};
  const int di = d == 64 ? 0 : d == 128 ? 1 : d == 256 ? 2 : -1;
  if (di < 0 || (vecs != 1 && vecs != 2)) return nullptr;
  return kernels[di][opt_kv != 0][vecs - 1];
}

// threads, vecs, blocks: the launch plan (`kv_cache_write.write_plan`),
// checked here to cover every vector with whole groups.
extern "C" int kv_cache_write(const void* k_new, const void* v_new,
                              const int* slots, long long n_tokens, int hkv,
                              int d, void* k_cache, void* v_cache,
                              float* k_scale, float* v_scale,
                              long long n_slots, int opt_kv, int threads,
                              int vecs, int blocks, void* stream) {
  const long long n_vecs = n_tokens * hkv * 2;
  if (n_vecs == 0) return 0;
  const WriteKernel kernel = kernel_of(d, opt_kv, vecs);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long cover = (long long)blocks * (threads / (d / 8)) * vecs;
  if (hkv < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      (vecs != 1 && vecs != 2) || blocks < 1 || cover < n_vecs ||
      cover > INT_MAX || n_slots * hkv > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, threads, 0, st>>>(
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      slots, (int)n_vecs, hkv, k_cache, v_cache, k_scale, v_scale,
      (int)n_slots);
  return (int)cudaGetLastError();
}

// The registers and local (spill and stack) bytes a thread, the static
// shared bytes and the most threads a block of the instantiation for (d,
// opt_kv, vecs), as the loaded module reports them (cudaFuncGetAttributes).
extern "C" int kv_cache_write_info(int d, int opt_kv, int vecs, int* info) {
  const WriteKernel kernel = kernel_of(d, opt_kv, vecs);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = (int)fa.sharedSizeBytes;
  info[3] = kMaxThreads;
  return 0;
}
