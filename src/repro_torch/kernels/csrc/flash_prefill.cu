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
// Masked probabilities are not hard-zeroed, as in the plain version.
// Returns (B, S, Hq, D) bf16.
//
// Bound on the H100: operations. 2 prompts of 2048 tokens at qwen3-4b's
// heads (Hq 32, D 128) do 4 * D operations per causal (query head, key)
// pair, 6.9e10 in all: 0.070 ms at 989 TFLOP/s bf16, against 0.025 ms for
// the bytes of q, k, v and the output. Design: one block of 8 warps per
// (lane, kv head, tile of 128 rows), the heaviest (latest) tiles launched
// first so the causal tail leaves no SM idle; each 64-key block of K and V
// staged by cp.async into a double buffer, the next block in flight while
// this one computes; the rows' update on the tensor cores through the
// shared `mma::RowTile` (mma_attention.cuh: mma.sync m16n8k16, P carried
// as two bf16 terms to hold the one-ulp check). A warp skips a block in its
// rows' future, or before their window, and skips the mask where the
// block is wholly visible to its rows.
#include "mma_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;            // query rows a block

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

template <int D>
__global__ void __launch_bounds__(kWarps * 32) prefill_kernel(PrefillArgs a) {
  constexpr int kTile = mma::kKeys * D * 2;           // bytes of one K or V block
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = mma::smem_addr(smem);
  const uint32_t kv_s = q_s + kRows * D * 2;          // [buf][K, V]

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.Hq / a.Hkv;
  const int R = a.S * G;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // latest first
  const int q_first = a.q_offset + row0 / G;
  const int q_last = a.q_offset + (min(row0 + kRows, R) - 1) / G;
  const int w0 = row0 + warp * 16;                    // the warp's first row
  const int w_first = a.q_offset + w0 / G;
  const int w_last = a.q_offset + (min(w0 + 16, R) - 1) / G;
  int spos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) spos[i] = a.q_offset + (w0 + (lane >> 2) + 8 * i) / G;

  // key blocks [k_begin, k_end) in steps of 64: none wholly after the
  // tile's last row, none wholly before its first row's window
  int k_begin = 0;
  if (a.window) {
    const int lo = q_first - a.window - 62;           // k0 + 63 >= q_first - window + 1
    if (lo > 0) k_begin = (lo + mma::kKeys - 1) / mma::kKeys * mma::kKeys;
  }
  const int k_end = min(a.T, q_last + 1);
  const long long stride = (long long)a.Hkv * D;
  auto stage = [&](int k0, int buf) {
    const int nk = min(mma::kKeys, a.T - k0);
    const int rows = (nk + 15) & ~15;
    const long long first = ((long long)b * a.T + k0) * a.Hkv + h;
    mma::load_rows<D>(kv_s + (2 * buf) * kTile, a.k + first * D, stride, nk, rows);
    mma::load_rows<D>(kv_s + (2 * buf + 1) * kTile, a.v + first * D, stride, nk, rows);
  };

  mma::load_q_tile<D>(kRows, q_s, a.q, b, a.S, a.Hq, h * G, G, row0, R);
  if (k_begin < k_end) stage(k_begin, 0);
  mma::cp_commit();
  mma::cp_wait_all();
  __syncthreads();
  mma::RowTile<D> t;
  t.init(q_s);
  const float scale_log2 = a.sm_scale * mma::kLog2e;

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += mma::kKeys, buf ^= 1) {
    mma::cp_wait_all();
    __syncthreads();          // block k0 staged; every warp done with buf ^ 1
    if (k0 + mma::kKeys < k_end) stage(k0 + mma::kKeys, buf ^ 1);
    mma::cp_commit();
    const int nk = min(mma::kKeys, a.T - k0);
    if (w0 >= R || k0 > w_last) continue;             // future of the warp
    if (a.window && k0 + nk - 1 < w_first - a.window + 1) continue;
    const bool all_live = k0 + nk - 1 <= w_first &&
                          (!a.window || w_last - k0 < a.window);
    const PrefillMask mk[2] = {{k0, spos[0], a.window}, {k0, spos[1], a.window}};
    t.template update<false>(kv_s + 2 * buf * kTile, kv_s + (2 * buf + 1) * kTile, nk,
                             scale_log2, nullptr, nullptr, all_live,
                             [&](int i, int j) { return mk[i](j); });
  }
  t.store(a.out, b, a.S, a.Hq, h * G, G, row0, R);
}

template <int D>
int launch(const PrefillArgs& a, cudaStream_t st) {
  const int G = a.Hq / a.Hkv;
  const int tiles = (a.S * G + kRows - 1) / kRows;
  const size_t smem = (size_t)(kRows + 4 * mma::kKeys) * D * 2;
  cudaError_t e = allow_smem(prefill_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  prefill_kernel<D><<<dim3(a.B, a.Hkv, tiles), kWarps * 32, smem, st>>>(a);
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
    case 64: return launch<64>(a, st);
    case 128: return launch<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
