// K3 — flash_chunk_prefill for sm_90a.
//
// Replaces the Pallas kernel `flash_chunk_prefill` (src/repro/kernels/
// flash_chunk_prefill.py, `_chunk_kernel`): a chunk of queries per lane,
// each with an absolute position, attends the lane's cached pages of the
// GLOBAL pool (earlier chunks, prefix-cache hits and the chunk itself,
// already written) through its physical page table. Rows are (seq, group)
// pairs, r = s * G + g, so each page is staged once for the G query heads
// of a kv head (MHA mode: G = 1, one head per block row set). Masks:
// causal, window + sink, and the concat-prefill packing planes (segment
// equality, key positions page_base * ps + i). Masked probabilities are
// hard-zeroed, so a cross-segment or wholly masked page adds exactly 0 and
// a row that sees no live key writes 0. A page is skipped when its table
// entry is -1 (never read) or its first key lies beyond every query of the
// tile (base * ps > max position in the tile).
//
// Bound on the H100: operations at the engine's mixed step (4 lanes x 512
// rows x 32 query heads against ~1k cached keys a lane, the decode lanes
// padded to the chunk: 3.2e10 operations, 0.032 ms at 989 TFLOP/s bf16,
// against 0.012 ms for the bytes of the pages and queries). Design: one
// block of 8 warps per (lane, head, tile of 128 rows); the next live page's
// K and V (and fp8 scales) staged by cp.async into a double buffer while
// this page computes; an fp8 page converted once in shared memory to bf16
// (exact); the rows' update on the tensor cores through the shared
// `mma::RowTile` (mma_attention.cuh: mma.sync m16n8k16, the K scale on the
// score columns, the V scale folded into P, P carried as two bf16 terms to
// hold the one-ulp check), 64 keys a step (a page of 128 in two). A page of
// ps keys that is not a multiple of 16 is padded with zero rows in shared
// memory and the padding masked. A warp skips a page wholly in its rows'
// future, and the mask where the page is wholly visible to its rows.
// With `return_state` (m_out and l_out set) the epilogue also stores each
// row's final (m, l): the running max kept in log2 units is converted to
// the natural units of the scaled scores by one f32 multiply, and a row
// that saw no live key (its max never left -1e30: masked scores are -inf)
// reports exactly -1e30 and 0, never -inf, so the merge across shards
// weighs it by 0 instead of NaN. l is the quad's reduced sum.
// Head dims 64, 128 and 256. At D 256 a block's shared memory is 193 KB for
// an fp8 pool of 64-token pages (the 128-row query tile 64 KB, the bf16
// K/V tiles 64 KB, the raw e4m3 pages and scales 65 KB): one block an SM,
// and Q's fragments are read from its staged tile at each use instead of
// being held in registers (mma_attention.cuh), so that O's 128 f32
// registers a thread fit under the 255 of a 256-thread block.
#include <climits>

#include "mma_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;            // query rows a block

struct ChunkArgs {
  const __nv_bfloat16* q;       // (B, S, Hq, D)
  const int* positions;         // (B, S)
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* phys;              // (B, NP)
  const int* page_base;         // (B, NP) or null: base = slot
  const int* page_seg;          // (B, NP) or null: segment 0
  const int* seg_q;             // (B, S) or null: segment 0
  __nv_bfloat16* out;           // (B, S, Hq, D)
  float* m_out;                 // (B, S, Hq) final m, natural units, or null
  float* l_out;                 // (B, S, Hq) final l, or null
  int B, S, Hq, Hkv, ps, np, opt_gqa, window, sink;
  float sm_scale;
};

// Shared memory, in order: the query tile; the bf16 K and V tiles (two
// pairs for a bf16 pool, staged into directly; one pair for fp8, converted
// into); for fp8, two pairs of raw e4m3 pages and two pairs of scale rows.
template <int D, bool kFp8>
struct Smem {
  int pr;                       // rows of a bf16 tile: ps rounded up to 16
  uint32_t q, kv, raw, sc;
  __device__ __forceinline__ Smem(uint32_t base, int ps) {
    pr = (ps + 15) & ~15;
    q = base;
    kv = q + kRows * D * 2;
    raw = kv + (kFp8 ? 2 : 4) * pr * D * 2;
    sc = raw + (kFp8 ? 4 * ps * D : 0);
  }
  static __host__ size_t bytes(int ps) {
    const int pr = (ps + 15) & ~15;
    return (size_t)kRows * D * 2 + (size_t)(kFp8 ? 2 : 4) * pr * D * 2 +
           (kFp8 ? (size_t)4 * ps * D + (size_t)4 * ps * sizeof(float) : 0);
  }
  __device__ __forceinline__ uint32_t k_tile(int buf) const {
    return kv + (kFp8 ? 0 : 2 * buf) * pr * D * 2;
  }
  __device__ __forceinline__ uint32_t v_tile(int buf) const {
    return k_tile(buf) + pr * D * 2;
  }
};

template <int D, typename KVT>
__global__ void __launch_bounds__(kWarps * 32) chunk_kernel(ChunkArgs a) {
  constexpr bool kFp8 = sizeof(KVT) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<D, kFp8> sm(mma::smem_addr(smem), a.ps);
  __shared__ int warp_max[kWarps];
  const int ps = a.ps;

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.opt_gqa ? a.Hq / a.Hkv : 1;
  const int kvh = a.opt_gqa ? h : h / (a.Hq / a.Hkv);
  const int R = a.S * G;
  const int row0 = blockIdx.z * kRows;
  const int w0 = row0 + warp * 16;

  // the two rows of this lane, rows g and g + 8 of the warp, and the
  // warp's smallest and largest position over its rows below R
  int qpos[2], qseg[2];
  bool real[2];
  int wmax = INT_MIN, wmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + (lane >> 2) + 8 * i;
    real[i] = r < R;
    qpos[i] = real[i] ? a.positions[b * a.S + r / G] : 0;
    qseg[i] = real[i] && a.seg_q != nullptr ? a.seg_q[b * a.S + r / G] : 0;
    if (real[i]) {
      wmax = max(wmax, qpos[i]);
      wmin = min(wmin, qpos[i]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(PA_FULL, wmax, off));
    wmin = min(wmin, __shfl_xor_sync(PA_FULL, wmin, off));
  }
  if (lane == 0) warp_max[warp] = wmax;
  __syncthreads();
  int max_pos = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) max_pos = max(max_pos, warp_max[w]);

  const int* phys = a.phys + b * a.np;
  auto base_of = [&](int j) { return a.page_base != nullptr ? a.page_base[b * a.np + j] : j; };
  auto next_live = [&](int j) {
    for (; j < a.np; ++j)
      if (phys[j] >= 0 && base_of(j) * ps <= max_pos) break;   // never loaded
    return j;
  };
  const long long stride = (long long)a.Hkv * D;
  auto stage = [&](int j, int buf) {
    const long long first = (long long)phys[j] * ps * a.Hkv + kvh;
    if constexpr (kFp8) {
      const fp8_t* kp = static_cast<const fp8_t*>(a.k_pages) + first * D;
      const fp8_t* vp = static_cast<const fp8_t*>(a.v_pages) + first * D;
      const uint32_t raw = sm.raw + 2 * buf * ps * D;
      constexpr int kChunks = D / 16;
      for (int c = threadIdx.x; c < ps * kChunks; c += blockDim.x) {
        const int r = c / kChunks, w = c % kChunks;
        mma::cp_async16(raw + r * D + w * 16, kp + r * stride + w * 16, true);
        mma::cp_async16(raw + ps * D + r * D + w * 16, vp + r * stride + w * 16, true);
      }
      const uint32_t sc = sm.sc + 2 * buf * ps * 4;
      for (int r = threadIdx.x; r < ps; r += blockDim.x) {
        mma::cp_async4(sc + r * 4, a.k_scale + first + r * a.Hkv);
        mma::cp_async4(sc + ps * 4 + r * 4, a.v_scale + first + r * a.Hkv);
      }
    } else {
      const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k_pages) + first * D;
      const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v_pages) + first * D;
      mma::load_rows<D>(sm.k_tile(buf), kp, stride, ps, sm.pr);
      mma::load_rows<D>(sm.v_tile(buf), vp, stride, ps, sm.pr);
    }
  };

  mma::load_q_tile<D>(kRows, sm.q, a.q, b, a.S, a.Hq, h * G, G, row0, R);
  if (kFp8 && sm.pr > ps) {     // zero the padding rows of the bf16 tiles once
    const int n = (sm.pr - ps) * D / 8;
    for (int c = threadIdx.x; c < 2 * n; c += blockDim.x) {
      const int t = c / n, i = c % n;
      const int r = ps + i / (D / 8), w = i % (D / 8);
      const uint32_t dst = (t ? sm.v_tile(0) : sm.k_tile(0)) + mma::swz<D>(r, w);
      asm volatile("st.shared.v4.u32 [%0], {%1,%1,%1,%1};\n" ::"r"(dst), "r"(0) : "memory");
    }
  }
  int j = next_live(0);
  if (j < a.np) stage(j, 0);
  mma::cp_commit();
  mma::cp_wait_all();
  __syncthreads();
  mma::RowTile<D> t;
  t.init(sm.q);
  const float scale_log2 = a.sm_scale * mma::kLog2e;
  const float* sc_f = reinterpret_cast<const float*>(
      smem + (sm.sc - mma::smem_addr(smem)));

  for (int buf = 0; j < a.np; buf ^= 1) {
    mma::cp_wait_all();
    __syncthreads();            // page j staged; every warp done with the other buffer
    const int jn = next_live(j + 1);
    if (jn < a.np) stage(jn, buf ^ 1);
    mma::cp_commit();
    if constexpr (kFp8) {       // e4m3 -> bf16 tiles, exact
      const unsigned char* raw = smem + (sm.raw - mma::smem_addr(smem)) + 2 * buf * ps * D;
      constexpr int kChunks = D / 8;
      for (int c = threadIdx.x; c < 2 * ps * kChunks; c += blockDim.x) {
        const int t2 = c / (ps * kChunks), i = c % (ps * kChunks);
        const int r = i / kChunks, w = i % kChunks;
        const uint2 x = *reinterpret_cast<const uint2*>(raw + (t2 * ps + r) * D + w * 8);
        const uint4 y = mma::fp8x8_to_bf16x8(x);
        const uint32_t dst = (t2 ? sm.v_tile(0) : sm.k_tile(0)) + mma::swz<D>(r, w);
        asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(dst), "r"(y.x),
                     "r"(y.y), "r"(y.z), "r"(y.w) : "memory");
      }
      __syncthreads();
    }
    const int base = base_of(j);
    const int kbase = base * ps;
    if (w0 < R && kbase <= wmax) {    // else wholly in the future of the warp
      const int pseg = a.page_seg != nullptr ? a.page_seg[b * a.np + j] : 0;
      // the page wholly visible to the warp's rows: every key at or before
      // each row, inside its window or sink, and in its segment
      const bool all_live =
          kbase + ps - 1 <= wmin &&
          (!a.window || kbase > wmax - a.window || kbase + ps <= a.sink * ps) &&
          __all_sync(PA_FULL, (!real[0] || qseg[0] == pseg) &&
                                  (!real[1] || qseg[1] == pseg));
      const ChunkMask mk[2] = {{base, ps, qpos[0], qseg[0], pseg, a.window, a.sink},
                               {base, ps, qpos[1], qseg[1], pseg, a.window, a.sink}};
      const float* k_sc = kFp8 ? sc_f + 2 * buf * ps : nullptr;
      const float* v_sc = kFp8 ? k_sc + ps : nullptr;
      const int tb = kFp8 ? 0 : buf;
      for (int j0 = 0; j0 < ps; j0 += mma::kKeys) {
        const uint32_t off = j0 * D * 2;
        t.template update<true>(sm.k_tile(tb) + off, sm.v_tile(tb) + off,
                                min(mma::kKeys, ps - j0), scale_log2,
                                kFp8 ? k_sc + j0 : nullptr, kFp8 ? v_sc + j0 : nullptr,
                                all_live, [&](int i, int jj) { return mk[i](j0 + jj); });
      }
    }
    j = jn;
  }
  t.store(a.out, b, a.S, a.Hq, h * G, G, row0, R, a.m_out, a.l_out);
}

template <int D, typename KVT>
int launch(const ChunkArgs& a, cudaStream_t st) {
  const int heads = a.opt_gqa ? a.Hkv : a.Hq;
  const int G = a.opt_gqa ? a.Hq / a.Hkv : 1;
  const int tiles = (a.S * G + kRows - 1) / kRows;
  const size_t smem = Smem<D, sizeof(KVT) == 1>::bytes(a.ps);
  // always opt in: the static tile-max array sits on top of the dynamic bytes
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel<D, KVT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  chunk_kernel<D, KVT><<<dim3(a.B, heads, tiles), kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D_, typename KVT_>
struct Inst {
  static constexpr int D = D_;
  using KVT = KVT_;
};

// f(Inst<D, KVT>{}) for the instantiation of (d, opt_kv), or an error.
template <typename F>
int with_inst(int d, int opt_kv, F f) {
  switch (d * 2 + (opt_kv ? 1 : 0)) {
    case 64 * 2 + 1: return f(Inst<64, fp8_t>{});
    case 64 * 2: return f(Inst<64, __nv_bfloat16>{});
    case 128 * 2 + 1: return f(Inst<128, fp8_t>{});
    case 128 * 2: return f(Inst<128, __nv_bfloat16>{});
    case 256 * 2 + 1: return f(Inst<256, fp8_t>{});
    case 256 * 2: return f(Inst<256, __nv_bfloat16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_chunk_prefill(
    const void* q, const int* positions, const void* k_pages,
    const void* v_pages, const float* k_scale, const float* v_scale,
    const int* phys, const int* page_base, const int* page_seg,
    const int* seg_q, void* out, float* m_out, float* l_out, int B, int S,
    int Hq, int Hkv, int d, int ps, int np, int opt_kv, int opt_gqa,
    int window, int sink, float sm_scale, void* stream) {
  ChunkArgs a{static_cast<const __nv_bfloat16*>(q), positions, k_pages, v_pages,
              k_scale, v_scale, phys, page_base, page_seg, seg_q,
              static_cast<__nv_bfloat16*>(out), m_out, l_out, B, S, Hq, Hkv, ps, np, opt_gqa,
              window, sink, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_inst(d, opt_kv, [&](auto k) { return launch<decltype(k)::D,
                                                     typename decltype(k)::KVT>(a, st); });
}

// The registers and local (spill and stack) bytes a thread, the static
// shared bytes and the dynamic bytes at page size ps, and the threads a
// block of the instantiation that flash_chunk_prefill runs for (d,
// opt_kv), as the loaded module reports them (cudaFuncGetAttributes).
extern "C" int flash_chunk_prefill_info(int d, int opt_kv, int ps, int* info) {
  return with_inst(d, opt_kv, [&](auto k) {
    using K = decltype(k);
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, chunk_kernel<K::D, typename K::KVT>);
    if (e != cudaSuccess) return (int)e;
    info[0] = fa.numRegs;
    info[1] = (int)fa.localSizeBytes;
    info[2] = (int)fa.sharedSizeBytes;
    info[3] = (int)Smem<K::D, sizeof(typename K::KVT) == 1>::bytes(ps);
    info[4] = kWarps * 32;
    return 0;
  });
}
