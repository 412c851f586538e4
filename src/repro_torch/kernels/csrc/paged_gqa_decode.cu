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
// updates every member lane's rows; non-member rows are left untouched.
//
// Bound on the H100: bytes. A decode step reads every live fp8 page once
// (ps * D bytes of K and of V plus 2 * ps f32 scales per page and head)
// and does about 4 * D operations per key and query head, far below the
// card's ratio of operations to bytes. The tensor cores serve to keep the
// instructions a page costs low, so that compute hides behind the copies.
//
// Design: a split-page decode, one launch per call.
//   Grid     K2 (B, heads, splits), K4 (heads, splits). Split z covers the
//            table slots [z * slots, (z + 1) * slots), `slots` from the
//            wrapper's `decode_splits` (the same for both kernels). K4's
//            split covers the visits [s0 * B, s1 * B), which plan_visits'
//            slot-major order makes exactly the slots [s0, s1) of every
//            lane, ascending: each row meets the same pages in the same
//            order in each split under K2 and K4.
//   Pages    A block walks its live entries, found 32 at a time by a warp
//            ballot over the table, with the next pages' K, V and scales
//            in flight: 16-byte cp.async into a ring of up to 4 stages (as
//            many as keep 3 blocks on an SM). Tile rows are padded by 16
//            bytes, so 8 rows' reads hit 8 bank groups.
//   Update   `page_update`, per page and per pass of up to 16 member rows
//            (K2: the G rows of its lane; K4: G rows of each member lane):
//            scores - on the tensor cores, mma.sync m16n8k16 bf16 with f32
//            sums, a warp an 8-key n-tile; q is bf16 as given, e4m3 -> bf16
//            is exact, and q's dims sit permuted in shared memory so that
//            a thread's B fragment is 4 neighbouring bytes of a K row.
//            softmax - one warp a row: K scale, sm_scale and the mask, one
//            max and one sum reduction per page, P' = p * v_scale written
//            as two bf16 terms hi = bf16(P'), lo = bf16(P' - hi).
//            P . V - on the tensor cores against the page's V, converted
//            once to bf16 (exact; zero rows pad to 16 keys) by the warps
//            the softmax leaves idle, hi and lo as
//            two MMAs (one bf16 rounding of P' breaks the one-ulp check,
//            PERF.md PR 13), then acc = acc * corr + that in f32.
//            q, acc, m and l live in shared memory for the block's rows
//            (K4: every lane's), q copied once per block.
//   Merge    Each block writes its rows' (acc, m, l) in f32 to the
//            wrapper's scratch; the last block of a (lane, head) (K4: of a
//            head) to arrive, found by an atomic counter after a
//            __threadfence, merges the splits in ascending order,
//            m = max m_s, l = sum l_s e^(m_s - m), acc likewise, writes
//            acc / max(l, 1e-30) in bf16 and resets the counter to 0. With
//            one split the block writes its rows directly (the same bits:
//            every weight is e^0 = 1).
//   State    Where the wrapper passes m_out and l_out (`return_state`), the
//            epilogue that writes a row's output also stores its final (m,
//            l) in f32: m in natural units of the scaled scores (the
//            softmax runs on expf), a row that saw no page -1e30 and 0.
//            With null pointers nothing more is stored. Both epilogues
//            store the merged (m, l) the output divides by, so K4's state
//            equals K2's bit for bit as its output does.
// Head dims 64, 128 and 256: at D 256, G 16 and fp8 pages of 64 tokens a
// K2 block takes ~100 KB of shared memory and a K4 block of 4 lanes ~174
// KB, both on a one-page ring (more stages would not keep 3 blocks an SM);
// K4's plan fits up to 6 lanes, and the wrapper sends wider decodes to K2.
// A row's arithmetic never depends on which rows share its 16-row tile or
// its block (an MMA output row reads only its own A row), and the order of
// every sum depends only on (ps, D) and the split, so K4 is bit-identical
// to K2 under any split count.
#include "mma_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerPass = 16;    // rows scored together against a page
constexpr int kMinBlocks = 3;       // blocks an SM (80 registers a thread)
constexpr int kMaxStages = 4;       // page ring depth
constexpr size_t kRingBudget = 76 * 1024;   // more stages while 3 blocks fit an SM
constexpr int kMergeBatch = 8;      // splits merged per round of loads
constexpr int kMetaBytes = 48;      // a stage's lpage, member count, lanes
constexpr size_t kSmemMax = 232448; // 227 KB a block on the H100

__host__ __device__ inline size_t al16(size_t x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int imin(int x, int y) { return x < y ? x : y; }

// Shared-memory plan of a block; kernels/paged_gqa_decode.py:_smem_bytes
// mirrors it (the wrapper raises where the kernel would refuse).
struct Layout {
  int rb;         // rows per pass
  int ps16;       // ps rounded up to 16 keys: the P . V k-steps
  int row;        // padded tile row, bytes
  size_t stage;   // one ring stage: K, V tiles, scales, meta
  size_t q;       // q of the block's rows, bf16, padded and permuted
  size_t acc;     // acc of the block's rows, f32
  size_t st;      // m (and l) of the block's rows
  size_t lens, part, vb, p, corr;   // p: one of P's two bf16 terms
  __host__ __device__ size_t bytes(int nstage) const {
    return nstage * stage + q + acc + 2 * st + lens + part + vb + 2 * p + corr;
  }
};

__host__ __device__ inline Layout make_layout(int ps, int D, int kvb,
                                              int lanes, int G) {
  Layout L;
  const int rows = lanes * G;
  L.rb = imin(kRowsPerPass, rows);
  L.ps16 = (ps + 15) / 16 * 16;
  L.row = D * kvb + 16;
  L.stage = al16((size_t)2 * ps * L.row) + al16((size_t)2 * ps * 4) + kMetaBytes;
  L.q = al16((size_t)rows * (D + 8) * 2);
  L.acc = (size_t)rows * D * 4;
  L.st = al16((size_t)rows * 4);
  L.lens = al16((size_t)lanes * 4);
  L.part = al16((size_t)L.rb * ps * 4);
  L.vb = al16((size_t)L.ps16 * (D + 8) * 2);
  L.p = al16((size_t)16 * (L.ps16 + 8) * 2);
  L.corr = al16((size_t)L.rb * 4);
  return L;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(mma::smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(mma::smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four neighbouring values of a K row as the two bf16x2 registers of an
// mma B fragment (e4m3 -> bf16 is exact).
__device__ __forceinline__ uint32_t half2_to_bf16x2(__half2_raw h) {
  const __nv_bfloat162 b = __float22bfloat162_rn(__half22float2(__half2(h)));
  return *reinterpret_cast<const uint32_t*>(&b);
}
__device__ __forceinline__ void kpair_bf16(const fp8_t* p, uint32_t& b0, uint32_t& b1) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  b0 = half2_to_bf16x2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(x & 0xffffu), __NV_E4M3));
  b1 = half2_to_bf16x2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(x >> 16), __NV_E4M3));
}
__device__ __forceinline__ void kpair_bf16(const __nv_bfloat16* p, uint32_t& b0, uint32_t& b1) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  b0 = x.x;
  b1 = x.y;
}
// The dim held at position pos of a q row in shared memory. Within each
// 16-dim block, mma k index 2t, 2t + 1, 2t + 8, 2t + 9 (thread t's B
// registers) map to dims 4t .. 4t + 3, so a thread reads its K fragment as
// 4 neighbouring values; the dot product is the same sum in another order.
__device__ __forceinline__ int q_dim(int pos) {
  const int k = pos & 15;
  return (pos & ~15) + (k < 8 ? 4 * (k >> 1) + (k & 1) : 4 * ((k - 8) >> 1) + 2 + (k & 1));
}

// Eight neighbouring values of a V row as bf16 (e4m3 -> bf16 is exact).
__device__ __forceinline__ uint4 v_bf16x8(const fp8_t* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_uint4(
      half2_to_bf16x2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(x.x & 0xffffu), __NV_E4M3)),
      half2_to_bf16x2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(x.x >> 16), __NV_E4M3)),
      half2_to_bf16x2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(x.y & 0xffffu), __NV_E4M3)),
      half2_to_bf16x2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(x.y >> 16), __NV_E4M3)));
}
__device__ __forceinline__ uint4 v_bf16x8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}


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
  const int* table_page;   // K2: phys (B, nsel); K4: visit_page (B*nsel,)
  const int* table_log;    // K2: log (B, nsel);  K4: visit_log (B*nsel,)
  const int* visit_lanes;  // K4 only
  __nv_bfloat16* out;
  float* m_out;            // (B, Hq) f32 final m (natural units), or null
  float* l_out;            // (B, Hq) f32 final l, or null
  float* partial;          // (B, heads, splits, G, D + 4): acc, m, l, pad
  int* counter;            // (B * heads,) zeros between launches
  int B, Hq, Hkv, ps, nsel, opt_gqa, window, sink, slots, nstage;
  float sm_scale;
};

// The block's rows: row r = local lane * G + g (K2: one lane).
struct Rows {
  const __nv_bfloat16* q;   // (rows, D + 8), dims permuted (q_dim)
  float* acc;       // (rows, D)
  float* m;
  float* l;
  const int* lens;  // cache_len of each local lane
  int G;
  float inv_g;      // 1 / G
};

// A staged page: K and V tiles (rows of `row` bytes), scales, and the
// member lanes whose rows it updates.
template <typename KVT>
struct Stage {
  unsigned char* base;
  int row;
  int ps;
  __device__ __forceinline__ const KVT* k(int j) const {
    return reinterpret_cast<const KVT*>(base + j * row);
  }
  __device__ __forceinline__ const KVT* v(int j) const {
    return reinterpret_cast<const KVT*>(base + (ps + j) * row);
  }
  __device__ __forceinline__ float* ksc() const {
    return reinterpret_cast<float*>(base + al16((size_t)2 * ps * row));
  }
  __device__ __forceinline__ float* vsc() const { return ksc() + ps; }
  __device__ __forceinline__ int* meta() const {
    return reinterpret_cast<int*>(base + al16((size_t)2 * ps * row) + al16((size_t)2 * ps * 4));
  }
  // meta()[0] logical page, [1] member count, then the member lanes as bytes
  __device__ __forceinline__ unsigned char* members() const {
    return reinterpret_cast<unsigned char*>(meta() + 2);
  }
};

// Work buffers of one pass.
struct Pass {
  float* part;   // (rb, ps) scores
  __nv_bfloat16* vb;   // (ps16, D + 8) the page's V in bf16, zero past ps
  __nv_bfloat16* ph;   // (16, ps16 + 8) P' = p * v_scale: hi = bf16(P')
  __nv_bfloat16* pl;   //                 and lo = bf16(P' - hi)
  float* corr;   // (rb,)
};

// One page's online-softmax update (Eq. 10) of every member row:
//   s_j  = (q . f32(k_j)) * k_scale_j * sm_scale, or PA_NEG where masked
//   m'   = max(m, max_j s_j);  corr = exp(m - m');  p_j = exp(s_j - m')
//   l'   = l * corr + sum_j p_j;  acc' = acc * corr + sum_j (p_j v_scale_j) f32(v_j)
// Masked probabilities are not hard-zeroed (exp(-1e30 - m') underflows once
// a live key has been seen), as in the plain version. Ends on a barrier.
template <int D, typename KVT>
__device__ void page_update(const Stage<KVT>& t, const Rows& R, const Pass& w,
                            const Layout& L, bool scaled, float sm_scale,
                            int window, int sink) {
  const int ps = t.ps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpage = t.meta()[0];
  const int nr = t.meta()[1] * R.G;
  const unsigned char* mem = t.members();
  const float* ksc = t.ksc();
  const float* vsc = t.vsc();
  // row of member row k: k / G by a float reciprocal (exact for k < 2^12
  // and G < 2^8: the quotient's fraction is >= 0.5 / G >> the rounding)
  auto row_of = [&](int k) {
    const int i = __float2int_rz(__fmul_rn(__int2float_rn(k) + 0.5f, R.inv_g));
    return mem[i] * R.G + k - i * R.G;
  };

  for (int pb = 0; pb < nr; pb += L.rb) {
    const int np = imin(L.rb, nr - pb);
    // ---- scores on the tensor cores: S (16 rows x 8 keys an n-tile) =
    // q (bf16, as given) . f32(k) (e4m3 -> bf16 exact), f32 sums; a warp
    // an n-tile, rows past np repeat row 0 and are dropped
    {
      uint32_t a_addr;            // this lane's ldmatrix row address
      {
        const int tr = (lane & 7) + ((lane >> 3) & 1) * 8;
        a_addr = mma::smem_addr(R.q + row_of(pb + (tr < np ? tr : 0)) * (D + 8) +
                                (lane >> 4) * 8);
      }
      const int t4 = lane & 3;
      for (int nt = warp; nt * 8 < ps; nt += kWarps) {
        const KVT* krow = t.k(nt * 8 + (lane >> 2));
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t a[4];
          mma::ldsm_x4(a_addr + ks * 32, a);
          uint32_t b0, b1;
          kpair_bf16(krow + ks * 16 + t4 * 4, b0, b1);
          mma::mma_bf16(c, a, b0, b1);
        }
        const int j = nt * 8 + t4 * 2, g = lane >> 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e >> 1) * 8, jj = j + (e & 1);
          if (r < np && jj < ps) w.part[r * ps + jj] = c[e];
        }
      }
    }
    __syncthreads();
    // ---- softmax: one warp a row
    for (int k = warp; k < np; k += kWarps) {
      const int lr = row_of(pb + k);
      const DecodeMask mask{lpage, ps, R.lens[mem[(pb + k) / R.G]], window, sink};
      float sv[PA_MAX_KPL];
      float mx = PA_NEG;
#pragma unroll
      for (int c = 0; c < PA_MAX_KPL; ++c) {
        const int jj = c * 32 + lane;
        sv[c] = PA_NEG;
        if (jj < ps) {
          float d = w.part[k * ps + jj];
          if (scaled) d = __fmul_rn(d, ksc[jj]);
          if (mask(jj)) sv[c] = __fmul_rn(d, sm_scale);
        }
        mx = fmaxf(mx, sv[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(PA_FULL, mx, off));
      const float m_old = R.m[lr];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(__fsub_rn(m_old, m_new));
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < PA_MAX_KPL; ++c) {
        const int jj = c * 32 + lane;
        float pv = 0.f;                   // keys past ps: P' = 0
        if (jj < ps) {
          const float p = expf(__fsub_rn(sv[c], m_new));
          psum = __fadd_rn(psum, p);
          pv = scaled ? __fmul_rn(p, vsc[jj]) : p;
        }
        if (jj < L.ps16) {
          const __nv_bfloat16 hi = __float2bfloat16_rn(pv);
          w.ph[k * (L.ps16 + 8) + jj] = hi;
          w.pl[k * (L.ps16 + 8) + jj] = __float2bfloat16_rn(__fsub_rn(pv, __bfloat162float(hi)));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(PA_FULL, psum, off));
      __syncwarp();
      if (lane == 0) {
        R.m[lr] = m_new;
        R.l[lr] = __fadd_rn(__fmul_rn(R.l[lr], corr), psum);
        w.corr[k] = corr;
      }
    }
    if (pb == 0) {            // the page's V in bf16 (exact), zero rows past ps,
      // by the warps the softmax leaves idle (all of them once np >= 8)
      constexpr int C8 = D / 8;
      const int w0 = np < kWarps ? np : 0, nw = kWarps - w0;
      if (warp >= w0) {
        for (int i = (warp - w0) * 32 + lane; i < L.ps16 * C8; i += nw * 32) {
          const int jj = i / C8, c8 = i % C8;
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (jj < ps) o = v_bf16x8(t.v(jj) + c8 * 8);
          *reinterpret_cast<uint4*>(w.vb + jj * (D + 8) + c8 * 8) = o;
        }
      }
    }
    __syncthreads();
    // ---- P . V on the tensor cores: a warp 16 dims (two n-tiles) of the
    // 16-row tile, P' as hi + lo bf16 terms (one bf16 rounding of P' would
    // not hold one ulp; PERF.md, PR 13) against V in bf16, f32 sums; then
    // acc = acc * corr + that for the rows below np
    {
      const int tr = (lane & 7) + ((lane >> 3) & 1) * 8, g = lane >> 2, t4 = lane & 3;
      const uint32_t ph = mma::smem_addr(w.ph + tr * (L.ps16 + 8) + (lane >> 4) * 8);
      const uint32_t pl = mma::smem_addr(w.pl + tr * (L.ps16 + 8) + (lane >> 4) * 8);
      for (int dp = warp; dp < D / 16; dp += kWarps) {
        float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const uint32_t vb = mma::smem_addr(w.vb + tr * (D + 8) + dp * 16 + (lane >> 4) * 8);
        for (int kk = 0; kk < L.ps16 / 16; ++kk) {
          uint32_t ah[4], al[4], b[4];
          mma::ldsm_x4(ph + kk * 32, ah);
          mma::ldsm_x4(pl + kk * 32, al);
          mma::ldsm_x4_t(vb + kk * 16 * (D + 8) * 2, b);
          mma::mma_bf16(o[0], ah, b[0], b[1]);
          mma::mma_bf16(o[1], ah, b[2], b[3]);
          mma::mma_bf16(o[0], al, b[0], b[1]);
          mma::mma_bf16(o[1], al, b[2], b[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = g + hh * 8;
          if (r >= np) continue;
          const float corr = w.corr[r];
          float* ar = R.acc + row_of(pb + r) * D + dp * 16 + t4 * 2;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float2* x = reinterpret_cast<float2*>(ar + nt * 8);
            float2 v = *x;
            v.x = __fadd_rn(__fmul_rn(v.x, corr), o[nt][2 * hh]);
            v.y = __fadd_rn(__fmul_rn(v.y, corr), o[nt][2 * hh + 1]);
            *x = v;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int D, typename KVT, bool VISITS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = VISITS ? blockIdx.x : blockIdx.y;
  const int z = VISITS ? blockIdx.y : blockIdx.z;
  const int splits = VISITS ? gridDim.y : gridDim.z;
  const int b0 = VISITS ? 0 : blockIdx.x;       // first global lane
  const int lanes = VISITS ? a.B : 1;
  const int heads = a.opt_gqa ? a.Hkv : a.Hq;
  const int G = a.opt_gqa ? a.Hq / a.Hkv : 1;
  const int kvh = a.opt_gqa ? h : h / (a.Hq / a.Hkv);
  const int rows = lanes * G;
  const int ps = a.ps;
  const bool scaled = a.k_scale != nullptr;
  const Layout L = make_layout(ps, D, sizeof(KVT), lanes, G);

  unsigned char* ring = smem;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(ring + a.nstage * L.stage);
  float* acc = reinterpret_cast<float*>(ring + a.nstage * L.stage + L.q);
  float* st_m = acc + rows * D;
  float* st_l = st_m + L.st / 4;
  int* lens = reinterpret_cast<int*>(st_l + L.st / 4);
  Pass w;
  w.part = reinterpret_cast<float*>(lens) + L.lens / 4;
  w.vb = reinterpret_cast<__nv_bfloat16*>(w.part + L.part / 4);
  w.ph = w.vb + L.vb / 2;
  w.pl = w.ph + L.p / 2;
  w.corr = reinterpret_cast<float*>(w.pl + L.p / 2);

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, g = r % G;
    q_s[r * (D + 8) + i % D] =
        a.q[((long long)(b0 + r / G) * a.Hq + h * G + g) * D + q_dim(i % D)];
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    st_m[r] = PA_NEG;
    st_l[r] = 0.f;
  }
  for (int i = tid; i < lanes; i += kThreads) lens[i] = a.cache_len[b0 + i];

  // this split's entries of the table (K2) or the visit list (K4)
  const int s0 = z * a.slots, s1 = imin(s0 + a.slots, a.nsel);
  const int e0 = VISITS ? s0 * a.B : b0 * a.nsel + s0;
  const int e1 = VISITS ? s1 * a.B : b0 * a.nsel + s1;
  // A window of 32 entries sits in every warp's lanes (lane i: entry
  // win + i), with a ballot of its live ones, so finding and issuing the
  // next live page costs one load round trip per 32 entries.
  int win = e0, w_page = -1, w_log = 0, w_lanes = 0;
  unsigned w_live = 0;
  auto load_window = [&](int start) {
    win = start;
    const int e = start + lane;
    w_page = e < e1 ? a.table_page[e] : -1;
    w_log = w_page >= 0 ? a.table_log[e] : 0;
    w_lanes = VISITS ? (w_page >= 0 ? a.visit_lanes[e] : 0) : 1;
    w_live = __ballot_sync(PA_FULL, w_page >= 0);
  };
  auto next_live = [&](int e) {         // the first live entry >= e, or e1
    while (e < e1) {
      if (e >= win + 32) load_window(e);
      const unsigned rest = w_live >> (e - win);
      if (rest) return e + __ffs(rest) - 1;
      e = win + 32;
    }
    return e1;
  };
  load_window(e0);
  auto stage_at = [&](int slot) {
    return Stage<KVT>{ring + slot * L.stage, L.row, ps};
  };
  auto issue = [&](int e, int slot) {
    const Stage<KVT> st = stage_at(slot);
    const int page = __shfl_sync(PA_FULL, w_page, e - win);
    const int lpage = __shfl_sync(PA_FULL, w_log, e - win);
    const unsigned mask = (unsigned)__shfl_sync(PA_FULL, w_lanes, e - win);
    const long long first = (long long)page * ps * a.Hkv + kvh;
    constexpr int NCH = D * (int)sizeof(KVT) / 16;
    const char* kp = static_cast<const char*>(a.k_pages);
    const char* vp = static_cast<const char*>(a.v_pages);
    for (int c = tid; c < ps * NCH; c += kThreads) {
      const int j = c / NCH, x = c % NCH;
      const long long off = ((first + (long long)j * a.Hkv) * D) * sizeof(KVT) + x * 16;
      cp16(st.base + j * L.row + x * 16, kp + off);
      cp16(st.base + (ps + j) * L.row + x * 16, vp + off);
    }
    if (scaled) {
      for (int j = tid; j < ps; j += kThreads) {
        cp4(st.ksc() + j, a.k_scale + first + (long long)j * a.Hkv);
        cp4(st.vsc() + j, a.v_scale + first + (long long)j * a.Hkv);
      }
    }
    if (warp == 0) {
      if ((mask >> lane) & 1u)
        st.members()[__popc(mask & ((1u << lane) - 1u))] = (unsigned char)lane;
      if (lane == 0) {
        st.meta()[0] = lpage;
        st.meta()[1] = __popc(mask);
      }
    }
  };

  int nxt = next_live(e0), issued = 0;
  for (int s = 0; s < a.nstage - 1; ++s) {
    if (nxt < e1) {
      issue(nxt, s);
      ++issued;
      nxt = next_live(nxt + 1);
    }
    cp_commit();
  }
  const Rows R{q_s, acc, st_m, st_l, lens, G, 1.f / G};
  for (int it = 0; it < issued || nxt < e1; ++it) {
    if (nxt < e1) {
      issue(nxt, (it + a.nstage - 1) % a.nstage);
      ++issued;
      nxt = next_live(nxt + 1);
    }
    cp_commit();
    switch (a.nstage) {        // page `it` has landed; nstage - 1 in flight
      case 4: cp_wait<3>(); break;
      case 3: cp_wait<2>(); break;
      case 2: cp_wait<1>(); break;
      default: cp_wait<0>();
    }
    __syncthreads();
    page_update<D, KVT>(stage_at(it % a.nstage), R, w, L, scaled, a.sm_scale,
                        a.window, a.sink);
  }
  cp_wait<0>();
  __syncthreads();

  auto out_row = [&](int r) {
    return a.out + ((long long)(b0 + r / G) * a.Hq + h * G + r % G) * D;
  };
  // the final (m, l) of row r, when the caller asked for the state
  auto store_state = [&](int r, float m, float l) {
    const long long i = (long long)(b0 + r / G) * a.Hq + h * G + r % G;
    a.m_out[i] = m;
    a.l_out[i] = l;
  };
  if (splits == 1) {
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D;
      out_row(r)[i % D] = __float2bfloat16_rn(__fdiv_rn(acc[i], fmaxf(st_l[r], 1e-30f)));
    }
    if (a.m_out != nullptr)
      for (int r = tid; r < rows; r += kThreads) store_state(r, st_m[r], st_l[r]);
    return;
  }
  // partial of row r in split s: a.partial + part_row(r, s) * (D + 4) holds
  // acc (D floats), m, l (and 2 floats of padding: float4-aligned rows)
  auto part_row = [&](int r, int s) {
    return (((long long)(b0 + r / G) * heads + h) * splits + s) * G + r % G;
  };
  for (int i = tid; i < rows * (D + 2); i += kThreads) {
    const int r = i / (D + 2), c = i % (D + 2);
    a.partial[part_row(r, z) * (D + 4) + c] =
        c < D ? acc[r * D + c] : c == D ? st_m[r] : st_l[r];
  }
  __threadfence();
  __syncthreads();
  int* ctr = a.counter + (VISITS ? h : b0 * heads + h);
  int* last = reinterpret_cast<int*>(w.vb);         // free after the loop
  if (tid == 0) *last = atomicAdd(ctr, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // the last block merges the splits in ascending order: first a warp a
  // row, m = max m_s and l = sum l_s e^(m_s - m) ...
  const long long zs = (long long)G * (D + 4);       // split stride
  for (int r = warp; r < rows; r += kWarps) {
    const float* src = a.partial + part_row(r, 0) * (D + 4) + D;
    float m = PA_NEG;
    for (int s = lane; s < splits; s += 32) m = fmaxf(m, __ldcg(src + s * zs));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(PA_FULL, m, off));
    float l = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 32) {
      float t = 0.f;
      if (s0 + lane < splits) {
        const float* p = src + (s0 + lane) * zs;
        t = __fmul_rn(__ldcg(p + 1), expf(__fsub_rn(__ldcg(p), m)));
      }
      for (int u = 0; u < 32 && s0 + u < splits; ++u)
        l = __fadd_rn(l, __shfl_sync(PA_FULL, t, u));
    }
    if (lane == 0) {
      st_m[r] = m;
      st_l[r] = l;
      if (a.m_out != nullptr) store_state(r, m, l);
    }
  }
  __syncthreads();
  // ... then a thread a (row, 4 dims), acc = sum acc_s e^(m_s - m), with
  // kMergeBatch splits' loads in flight at a time
  for (int i = tid; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    const float* src = a.partial + part_row(r, 0) * (D + 4);
    const float m = st_m[r];
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
      float mz[kMergeBatch];
      float4 az[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (s0 + u < splits) {
          mz[u] = __ldcg(src + (s0 + u) * zs + D);
          az[u] = __ldcg(reinterpret_cast<const float4*>(src + (s0 + u) * zs + d));
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (s0 + u < splits) {
          const float wgt = expf(__fsub_rn(mz[u], m));
          o[0] = __fadd_rn(o[0], __fmul_rn(az[u].x, wgt));
          o[1] = __fadd_rn(o[1], __fmul_rn(az[u].y, wgt));
          o[2] = __fadd_rn(o[2], __fmul_rn(az[u].z, wgt));
          o[3] = __fadd_rn(o[3], __fmul_rn(az[u].w, wgt));
        }
      }
    }
    const float den = fmaxf(st_l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out_row(r)[d + e] = __float2bfloat16_rn(__fdiv_rn(o[e], den));
  }
  if (tid == 0) *ctr = 0;
}

template <int D, typename KVT, bool VISITS>
int launch(DecodeArgs a, int splits, cudaStream_t st) {
  const int heads = a.opt_gqa ? a.Hkv : a.Hq;
  const int G = a.opt_gqa ? a.Hq / a.Hkv : 1;
  const Layout L = make_layout(a.ps, D, sizeof(KVT), VISITS ? a.B : 1, G);
  a.nstage = 1;       // the deepest ring within kRingBudget, at least 1
  while (a.nstage < kMaxStages && L.bytes(a.nstage + 1) <= kRingBudget) ++a.nstage;
  const size_t bytes = L.bytes(a.nstage);
  if (bytes > kSmemMax || splits < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(decode_kernel<D, KVT, VISITS>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = VISITS ? dim3(heads, splits) : dim3(a.B, heads, splits);
  decode_kernel<D, KVT, VISITS><<<grid, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D_, typename KVT_, bool VISITS_>
struct Inst {
  static constexpr int D = D_;
  static constexpr bool VISITS = VISITS_;
  using KVT = KVT_;
};

// f(Inst<D, KVT, VISITS>{}) for the instantiation of (d, opt_kv, visits),
// or an error.
template <int D, typename F>
int with_inst_kv(int opt_kv, bool visits, F f) {
  if (opt_kv) return visits ? f(Inst<D, fp8_t, true>{}) : f(Inst<D, fp8_t, false>{});
  return visits ? f(Inst<D, __nv_bfloat16, true>{}) : f(Inst<D, __nv_bfloat16, false>{});
}
template <typename F>
int with_inst(int d, int opt_kv, bool visits, F f) {
  switch (d) {
    case 64: return with_inst_kv<64>(opt_kv, visits, f);
    case 128: return with_inst_kv<128>(opt_kv, visits, f);
    case 256: return with_inst_kv<256>(opt_kv, visits, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const DecodeArgs& a, int d, int opt_kv, bool visits, int splits,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_inst(d, opt_kv, visits, [&](auto k) {
    using K = decltype(k);
    return launch<K::D, typename K::KVT, K::VISITS>(a, splits, st);
  });
}

int splits_of(int nsel, int slots) {
  return slots < 1 ? 0 : nsel < 1 ? 1 : (nsel + slots - 1) / slots;
}

}  // namespace

extern "C" int paged_pool_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* cache_len,
    const int* phys, const int* log, void* out, float* m_out, float* l_out,
    float* partial, int* counter, int B, int Hq, int Hkv, int d, int ps,
    int nsel, int opt_kv, int opt_gqa, int window, int sink, int slots,
    float sm_scale, void* stream) {
  DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
               k_scale, v_scale, cache_len, phys, log, nullptr,
               static_cast<__nv_bfloat16*>(out), m_out, l_out, partial, counter, B, Hq,
               Hkv, ps, nsel, opt_gqa, window, sink, slots, 1, sm_scale};
  return dispatch(a, d, opt_kv, false, splits_of(nsel, slots), stream);
}

extern "C" int paged_pool_decode_visits(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* cache_len,
    const int* visit_page, const int* visit_lanes, const int* visit_log,
    void* out, float* m_out, float* l_out, float* partial, int* counter,
    int B, int Hq, int Hkv, int d, int ps, int nsel, int opt_kv, int opt_gqa,
    int window, int sink, int slots, float sm_scale, void* stream) {
  DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
               k_scale, v_scale, cache_len, visit_page, visit_log, visit_lanes,
               static_cast<__nv_bfloat16*>(out), m_out, l_out, partial, counter, B, Hq, Hkv,
               ps, nsel, opt_gqa, window, sink, slots, 1, sm_scale};
  return dispatch(a, d, opt_kv, true, splits_of(nsel, slots), stream);
}

// The registers and local (spill and stack) bytes a thread, the static
// shared bytes and the threads a block of the K2 (visits 0) or K4 kernel
// that runs for (d, opt_kv), as the loaded module reports them
// (cudaFuncGetAttributes).
extern "C" int paged_gqa_decode_info(int d, int opt_kv, int visits, int* info) {
  return with_inst(d, opt_kv, visits != 0, [&](auto k) {
    using K = decltype(k);
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, decode_kernel<K::D, typename K::KVT, K::VISITS>);
    if (e != cudaSuccess) return (int)e;
    info[0] = fa.numRegs;
    info[1] = (int)fa.localSizeBytes;
    info[2] = (int)fa.sharedSizeBytes;
    info[3] = kThreads;
    return 0;
  });
}
