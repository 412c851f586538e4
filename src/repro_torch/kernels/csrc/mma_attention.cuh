// Shared tensor-core tile code of the flash attention kernels K8
// flash_prefill and K3 flash_chunk_prefill: a block of 8 warps owns a tile
// of 128 query rows (half the K/V bytes staged per row of a 64-row tile;
// PERF.md has both timed), and each warp updates its 16 rows' online
// softmax against a staged tile of at most 64 keys with mma.sync.m16n8k16
// (bf16 inputs, f32 accumulation).
//
// Bound on the H100: operations, at the main path's shapes. K8's 2 x 2048
// tokens (Hq 32, D 128) do 4 * D operations per causal (query head, key)
// pair, 6.9e10 in all (0.070 ms at 989 TFLOP/s bf16); K3's mixed step (4
// lanes x 512 rows, ~1k cached keys a lane) 3.2e10 (0.032 ms). Both need
// some 2 * S / D times more operations than bytes of q, k, v and output,
// above the card's ~295 operations a byte once a tile holds 128 rows.
//
// Design, per warp and key tile:
//   S = Q K^T    Q's A-fragments are loaded once by ldmatrix and kept in
//                registers for the whole key loop (D <= 128); at D 256 they
//                would take 64 registers a thread beside O's 128, so they
//                are reloaded by ldmatrix from the staged query tile, which
//                then stays in shared memory, at each 16-dim step of each
//                key tile (the same fragments: the same bits). K's
//                B-fragments come from shared memory by ldmatrix. The score of column j is
//                acc * k_scale[j] * sm_scale * log2(e) (the fp8 pool's
//                per-(token, head) K scale multiplies after the MMA; the
//                plain version scales k first, which differs only in f32
//                rounding).
//   softmax      (m, l) in f32 per row, in the log2 domain (2^x on the
//                special-function unit); each row's max
//                reduces across the lane quad that holds it. Masks are
//                evaluated per fragment element; masked scores are -1e30
//                (K8, as its plain version) or -inf (K3: a hard zero, so a
//                masked probability adds exactly 0 and a row that sees no
//                live key ends with l = 0 and writes 0). Key columns past
//                the tile's end are -inf in both.
//   O += P V     P' = p * v_scale[j] (p for a bf16 pool) goes in as two
//                bf16 terms, hi = bf16(P') and lo = bf16(P' - hi), two MMAs
//                against V's B-fragments (ldmatrix.trans). The score
//                accumulator's fragment layout is the next MMA's A layout,
//                so P never goes through shared memory. l sums the f32 p.
// Why two terms: the kernels are held to one bf16 ulp of their f32 plain
// versions (|kernel - plain| <= 2^-14 + 2^-7 |plain|). This tile arithmetic
// emulated on the CPU against K8's plain version (S 1024, Hq 8, Hkv 2, D
// 128; tests/test_torch_kernels.py::test_p_as_two_bf16_terms_holds_one_ulp)
// puts the worst output at 17.2x that tolerance with P rounded once to bf16
// (60,022 of 1,048,576 outputs outside), at 1.97x with fp16's 10-bit
// significand (61 outside), and at 0.90x with hi + lo (none): the 1.5x
// tensor-core operations buy the check.
//
// Tiles sit in shared memory as rows of D bf16 whose 16-byte chunks are
// XOR-swizzled by (row & 7), so the 8 row addresses of each ldmatrix hit 8
// different bank groups. The callers stage tiles with 16-byte cp.async
// into a double buffer, the next tile in flight while this one computes.
// wgmma, TMA and warp specialisation are later work.
#pragma once

#include "paged_attention.cuh"

namespace mma {

constexpr int kKeys = 64;              // keys per tile update
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A row's running max in log2 units as the natural-unit m of the scaled
// scores (one f32 rounding); a row that saw no live key keeps -1e30.
__device__ __forceinline__ float natural_m(float m_log2) {
  return m_log2 == PA_NEG ? PA_NEG : __fmul_rn(m_log2, kLn2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of D-wide rows.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * D * 2 + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; with valid false the destination is zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Eight e4m3 bytes -> eight bf16 (exact: every e4m3 value is a bf16 value).
__device__ __forceinline__ uint4 fp8x8_to_bf16x8(uint2 x) {
  const uint32_t w[2] = {x.x, x.y};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_fp8x2_storage_t pair =
        static_cast<__nv_fp8x2_storage_t>(w[i >> 1] >> (16 * (i & 1)));
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3));
    const float2 f = __half22float2(h);
    o[i] = pack_bf16(f.x, f.y);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Row r = s * G + g of a (B, S, Hq, D) tensor: query head h0 + g of token s.
__device__ __forceinline__ long long row_offset(long long b, int S, int Hq,
                                                int h0, int G, int r, int D) {
  return ((b * S + r / G) * Hq + h0 + r % G) * (long long)D;
}

// Stage the block's `rows` query rows (rows past R zeroed), all threads.
template <int D>
__device__ __forceinline__ void load_q_tile(int rows, uint32_t dst,
                                            const __nv_bfloat16* __restrict__ q,
                                            long long b, int S, int Hq, int h0,
                                            int G, int row0, int R) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, w = c % kChunks;
    const bool ok = row0 + r < R;
    const __nv_bfloat16* src =
        ok ? q + row_offset(b, S, Hq, h0, G, row0 + r, D) + w * 8 : q;
    cp_async16(dst + swz<D>(r, w), src, ok);
  }
}

// Stage rows [0, rows) of a key tile whose row j is src + j * stride; rows
// at or past n are zeroed. All threads.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          long long stride, int n, int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int j = c / kChunks, w = c % kChunks;
    const bool ok = j < n;
    cp_async16(dst + swz<D>(j, w), ok ? src + j * stride + w * 8 : src, ok);
  }
}

// One warp's 16 rows: Q fragments, O accumulator, and (m, l) of rows g and
// g + 8 of the warp (g = lane / 4); l is this lane's share of the quad's sum.
template <int D>
struct RowTile {
  // Q's fragments live in registers up to D 128; past it they are read
  // from the staged query tile at each use (see the header).
  static constexpr bool kQRegs = D <= 128;
  uint32_t q[kQRegs ? D / 16 : 1][4];
  uint32_t q_tile;
  float o[D / 8][4];
  float m[2], l[2];

  // Q fragments from the staged tile (kept there when !kQRegs); state to
  // (m, l, o) = (-1e30, 0, 0).
  __device__ __forceinline__ void init(uint32_t tile) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    q_tile = tile;
    if constexpr (kQRegs) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        ldsm_x4(tile + swz<D>(warp * 16 + (lane & 15), 2 * kd + (lane >> 4)), q[kd]);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    m[0] = m[1] = PA_NEG;
    l[0] = l[1] = 0.f;
  }

  // The online-softmax update against keys [0, nk) (nk <= 64) of a staged
  // K/V tile pair. Rows of the tile at or past nk, up to a multiple of 16,
  // must be finite (the loaders zero them). live(h, j): key j is visible to
  // row g + 8h; skipped when all_live. scale_log2 = sm_scale * log2(e);
  // k_sc / v_sc: the keys' fp8 scales in shared memory, or null. A full
  // tile takes a branch-free path (its 16-key step count a constant).
  template <bool kHardZero, typename LiveF>
  __device__ __forceinline__ void update(uint32_t k_tile, uint32_t v_tile,
                                         int nk, float scale_log2,
                                         const float* k_sc, const float* v_sc,
                                         bool all_live, const LiveF& live) {
    if (nk == kKeys)
      tile<kHardZero, true>(k_tile, v_tile, nk, scale_log2, k_sc, v_sc, all_live, live);
    else
      tile<kHardZero, false>(k_tile, v_tile, nk, scale_log2, k_sc, v_sc, all_live, live);
  }

  template <bool kHardZero, bool kFull, typename LiveF>
  __device__ __forceinline__ void tile(uint32_t k_tile, uint32_t v_tile,
                                       int nk, float scale_log2,
                                       const float* k_sc, const float* v_sc,
                                       bool all_live, const LiveF& live) {
    const int lane = threadIdx.x & 31, tg = lane & 3;
    const int steps = kFull ? kKeys / 16 : (nk + 15) >> 4;
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // S = Q K^T: each depth step kd feeds 8 independent accumulators
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qs[4];
      if constexpr (!kQRegs)
        ldsm_x4(q_tile + swz<D>((threadIdx.x >> 5) * 16 + (lane & 15), 2 * kd + (lane >> 4)),
                qs);
      const uint32_t(&qa)[4] = kQRegs ? q[kQRegs ? kd : 0] : qs;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if (!kFull && kk >= steps) break;
        uint32_t b[4];
        ldsm_x4(k_tile + swz<D>(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                2 * kd + ((lane >> 3) & 1)), b);
        mma_bf16(s[2 * kk], qa, b[0], b[1]);
        mma_bf16(s[2 * kk + 1], qa, b[2], b[3]);
      }
    }
    const float masked = kHardZero ? -INFINITY : PA_NEG;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * tg + (e & 1), h = e >> 1;
        float x;
        if (!kFull && j >= nk) x = -INFINITY;
        else if (!all_live && !live(h, j)) x = masked;
        else x = s[n][e] * (k_sc != nullptr ? k_sc[j] * scale_log2 : scale_log2);
        s[n][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(PA_FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(PA_FULL, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
    // O += P V, P as hi + lo bf16 terms
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      if (!kFull && kk >= steps) break;
      // A-fragment registers a0 (row g, keys 2tg, 2tg+1), a1 (row g+8),
      // a2 (row g, keys 8+2tg, 9+2tg), a3 (row g+8): one key pair each
      uint32_t ah[4], al[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int n = 2 * kk + (a >> 1), h = a & 1;
        float pv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = n * 8 + 2 * tg + c;
          const float p = ex2(s[n][2 * h + c] - m[h]);
          l[h] += p;
          pv[c] = v_sc != nullptr && (kFull || j < nk) ? p * v_sc[j] : p;
        }
        ah[a] = pack_bf16(pv[0], pv[1]);                  // hi = bf16(P')
        al[a] = pack_bf16(pv[0] - __uint_as_float(ah[a] << 16),
                          pv[1] - __uint_as_float(ah[a] & 0xffff0000u));
      }
      const int vr = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(v_tile + swz<D>(vr, 2 * dp + (lane >> 4)), b);
        mma_bf16(o[2 * dp], ah, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], ah, b[2], b[3]);
        mma_bf16(o[2 * dp], al, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], al, b[2], b[3]);
      }
    }
  }

  // out row = acc / max(l, 1e-30) in bf16, for the warp's rows below R;
  // with m_out and l_out (K3's `return_state`) also the row's final m, in
  // natural units (natural_m), and l, the quad's sum, at (b, s, h0 + g).
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ out,
                                        long long b, int S, int Hq, int h0,
                                        int G, int row0, int R,
                                        float* __restrict__ m_out = nullptr,
                                        float* __restrict__ l_out = nullptr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(PA_FULL, sum, 1);
      sum += __shfl_xor_sync(PA_FULL, sum, 2);
      const int r = row0 + warp * 16 + (lane >> 2) + 8 * h;
      if (r >= R) continue;
      if (m_out != nullptr && (lane & 3) == 0) {
        const long long i = row_offset(b, S, Hq, h0, G, r, 1);
        m_out[i] = natural_m(m[h]);
        l_out[i] = sum;
      }
      const float den = fmaxf(sum, 1e-30f);
      __nv_bfloat16* dst = out + row_offset(b, S, Hq, h0, G, r, D) + 2 * (lane & 3);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        __nv_bfloat162 v = __floats2bfloat162_rn(__fdiv_rn(o[dt][2 * h], den),
                                                 __fdiv_rn(o[dt][2 * h + 1], den));
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = v;
      }
    }
  }
};

}  // namespace mma
