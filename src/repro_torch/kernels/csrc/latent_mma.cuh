// Shared tensor-core tile of the MLA latent kernels: K5 paged_latent_decode,
// K6 latent_chunk_prefill and K7 paged_latent_decode_visits.
//
// A latent page is (ps, W) with W = R + dr: each token's line packs the
// compressed c_kv (R values) and the shared rotary key k_rope (dr values),
// in the pool's dtype (fp8 e4m3 or bf16), beside (ps, 2) f32 scales: column
// 0 dequantizes c_kv, column 1 k_rope (the Pallas kernels' Eq. 6). A staged
// tile of up to 64 keys is both K and V: the score contracts q_lat with c
// and q_rope with k_rope, the value is c, so the accumulator stays in latent
// space and the w_uv expansion stays outside the kernels.
//
// Arithmetic, on mma.sync.m16n8k16 (bf16 in, f32 sums):
//   S = (sc0_j <q_lat, c_j> + sc1_j <q_rope, r_j>) * sm_scale
//        q_lat and q_rope enter as kQTerms = 3 bf16 terms (t0 = bf16(q),
//        t1 = bf16(q - t0), t2 = bf16(q - t0 - t1)); c and r as the page's
//        values, fp8 -> bf16 exact. The latent and rope parts sum in
//        separate fragments, so each key column takes its own scale after
//        the MMA.
//   O += P' C   P' = p * sc0_j as two bf16 terms (hi, lo), against the same
//        bf16 tile read transposed.
// Masked probabilities are hard-zeroed (a masked score is -inf), so a
// wholly masked tile leaves (m, l, acc) exactly as they were. The online
// softmax runs in the log2 domain (m in units of log2); a kernel's
// `return_state` stores m in the natural units of the scaled scores (one
// f32 multiply by ln 2), a row that saw no live key -1e30 and l 0.
// Why three q terms: this arithmetic emulated on the CPU (tests/
// test_torch_kernels.py::test_latent_tile_three_q_terms_hold_f32_tolerance,
// 256 tokens of 16 heads over 1024 keys) reads 0.61 of the f32 tolerance
// the card holds the latent kernels to (LAT_RTOL 2^-12, LAT_ATOL 2^-16)
// with two q terms, 0.22 with three, and over 100 with q or P' as one
// term; at chip_smoke.py's K6 shape an H100 read 0.98 with two and 0.43
// with three.
//
// Rows form groups of 16 (one m16 tile) and CW warps each. Warp cw of a
// group owns latent columns [cw R/CW, (cw+1) R/CW) of the f32 accumulator
// (64 registers at R 512, CW 4) and computes the score contraction over
// those latent dims and a 1/CW share of the rope dims; the CW partial
// scores meet in shared memory and every warp of the group sums them in the
// same fixed order, so the group's warps hold the same scores and (m, l) bit
// for bit. q's first term stays in registers, the other two in shared
// memory (read by ldmatrix once a k-step and tile). An output row reads only
// its own A row, and every sum's order depends only on (R, dr, ps), so a
// row's bits never depend on which rows share its group or its block.
#pragma once

#include <climits>

#include "mma_attention.cuh"

namespace lmma {

constexpr int kKeys = mma::kKeys;             // keys a tile: 64
constexpr int kQTerms = 3;                    // bf16 terms of q
constexpr int kPTerms = 2;                    // bf16 terms of P' (hi, lo)

// The split of one instantiation: WARPS warps a block, CW a row group of 16
// rows.
template <int R, int DR, int CW, int WARPS>
struct Geo {
  static constexpr int W = R + DR;
  // bf16 row stride: W rounded up to 8 chunks of 16 bytes, so the XOR
  // swizzle (chunk ^ (row & 7)) stays inside the row
  static constexpr int WS = (W / 8 + 7) / 8 * 64;
  static constexpr int kGroups = WARPS / CW;
  static constexpr int kRows = 16 * kGroups;  // rows a block
  static constexpr int NC = R / CW;           // latent columns a warp
  static constexpr int LK = NC / 16;          // latent k-steps a warp
  static constexpr int RK = DR / 16 / CW;     // rope k-steps a warp
  static constexpr int NT = NC / 8;           // accumulator n-tiles a warp
  static_assert(NC % 16 == 0 && DR % (16 * CW) == 0 && WARPS % CW == 0, "split");
};

// Shared memory, in order: the bf16 tile; q's terms 1.. (kRows rows of WS
// bf16 each, swizzled like the tile); for CW > 1, each warp's partial
// scores (32 floats a lane); for fp8, the raw tile and two (64, 2) scale
// rows (the next tile's scales land while this tile's are read).
template <int R, int DR, int CW, int WARPS, bool kFp8>
struct Smem {
  using G = Geo<R, DR, CW, WARPS>;
  static constexpr int kTile = kKeys * G::WS * 2;
  static constexpr int kQ = (kQTerms - 1) * G::kRows * G::WS * 2;
  static constexpr int kPart = CW > 1 ? WARPS * 32 * 32 * 4 : 0;
  static constexpr int kRaw = kFp8 ? kKeys * G::W : 0;
  static constexpr int kSc = kFp8 ? 2 * kKeys * 2 * 4 : 0;
  static constexpr int q = kTile, part = q + kQ, raw = part + kPart, sc = raw + kRaw;
  static constexpr int kBytes = sc + kSc;
};

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four f32 from shared memory, loaded where they are used (asm volatile:
// the compiler neither merges nor hoists them, so no key's scale stays in
// a register from the scores to P' C).
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// Byte offset, inside a swizzled row whose index is the lane's (row & 7 ==
// lane & 7, as every ldmatrix here reads), of 16-byte chunk 2 * P + sel:
// the 16-dim step P's half `sel`. Split so that a step known at compile
// time costs an immediate and one of four per-lane registers, and
// ldmatrix addresses stay register + immediate.
__device__ __forceinline__ uint32_t step_off(int P, int sel) {
  return (uint32_t)((P >> 2) << 7) +
         (uint32_t)(((2 * (P & 3) + sel) ^ (threadIdx.x & 7)) << 4);
}

// Stage `nk` fp8 key lines (W bytes each, contiguous from src) and their
// (nk, 2) f32 scales by cp.async: the lines into the raw tile at `raw`, the
// scales into the scale row at `sc`. All threads; the caller commits.
template <int W>
__device__ __forceinline__ void stage_raw(uint32_t raw, uint32_t sc,
                                          const unsigned char* __restrict__ src,
                                          const float* __restrict__ scales, int nk) {
  for (int c = threadIdx.x; c < nk * W / 16; c += blockDim.x)
    mma::cp_async16(raw + c * 16, src + c * 16, true);
  for (int i = threadIdx.x; i < 2 * nk; i += blockDim.x)
    mma::cp_async4(sc + i * 4, scales + i);
}

// Stage `nk` bf16 key lines straight into the swizzled tile (rows nk..64
// zeroed). All threads; the caller commits.
template <int W, int WS>
__device__ __forceinline__ void stage_bf16(uint32_t tile, const __nv_bfloat16* __restrict__ src,
                                           int nk) {
  constexpr int kC = W / 8;
  for (int c = threadIdx.x; c < kKeys * kC; c += blockDim.x) {
    const int r = c / kC, w = c % kC;
    mma::cp_async16(tile + mma::swz<WS>(r, w), r < nk ? src + r * W + w * 8 : src, r < nk);
  }
}

// The staged raw fp8 tile (`nk` lines) into the bf16 tile, exact; rows (and
// the f32 scales at `sc`) nk..64 zeroed. All threads.
template <int W, int WS>
__device__ __forceinline__ void convert_raw(uint32_t tile, const unsigned char* raw, float* sc,
                                            int nk) {
  constexpr int kC = W / 8, kU = 4;   // chunks a thread converts at once
  for (int i = 2 * nk + threadIdx.x; i < 2 * kKeys; i += blockDim.x) sc[i] = 0.f;
  for (int c0 = threadIdx.x; c0 < kKeys * kC; c0 += kU * blockDim.x) {
    uint2 x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {      // the loads first, then the conversions
      const int c = c0 + u * blockDim.x, r = c / kC;
      x[u] = c < kKeys * kC && r < nk ? *reinterpret_cast<const uint2*>(raw + r * W + (c % kC) * 8)
                                      : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c >= kKeys * kC) break;
      const uint4 y = mma::fp8x8_to_bf16x8(x[u]);
      asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(tile + mma::swz<WS>(c / kC, c % kC)),
                   "r"(y.x), "r"(y.y), "r"(y.z), "r"(y.w) : "memory");
    }
  }
}

// One warp's share of a row group: the first bf16 term of its q fragments
// (the latent columns it owns and its share of the rope dims), its columns
// of the f32 accumulator, and (m, l) of rows g and g + 8 of the group (l is
// this lane's share of the quad's sum; the same in every warp of the
// group).
template <int R, int DR, int CW, int WARPS>
struct WarpTile {
  using G = Geo<R, DR, CW, WARPS>;
  static constexpr int WS = G::WS;
  static constexpr int kTermBytes = G::kRows * WS * 2;
  static_assert(G::LK % 4 == 0 && (R / 16) % 4 == 0, "step_off splits");
  uint32_t ql[G::LK][4], qr[G::RK][4];
  float o[G::NT][4];
  float m[2], l[2];
  // the lane's row offsets: key rows of the score (B) and P' C (V) loads
  // of a 16-key step, and the group's query rows of the q-term (A) loads;
  // the warp's latent columns
  uint32_t brow, vrow, qrow, wcol;

  // The lane's values of one 16 x 16 block of f32 queries: rows w0 + (g,
  // g + 8), columns col0 + (2t, 2t + 1, 2t + 8, 2t + 9), rows at or past
  // RW zero.
  __device__ __forceinline__ void load_q(const float* __restrict__ q,
                                         long long row_base, int stride, int w0,
                                         int RW, int col0, float2 (&x)[4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = w0 + g + 8 * (a & 1);
      const int c = col0 + 2 * tg + 8 * (a >> 1);
      x[a] = r < RW ? __ldg(reinterpret_cast<const float2*>(q + (row_base + r) * stride + c))
                    : make_float2(0.f, 0.f);
    }
  }

  // Those values as kQTerms bf16 terms, each the rounding of what the
  // earlier ones leave: the first into the A-fragment f, the others into
  // the shared q terms at the block's row srow and the tile's dim dim0.
  __device__ __forceinline__ void split_q(float2 (&x)[4], uint32_t (&f)[4], uint32_t qs,
                                          int srow, int dim0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const uint32_t dst = qs + mma::swz<WS>(srow + g + 8 * (a & 1), dim0 / 8 + (a >> 1)) + 4 * tg;
#pragma unroll
      for (int t = 0; t < kQTerms; ++t) {
        const uint32_t u = mma::pack_bf16(x[a].x, x[a].y);
        if (t == 0) f[a] = u;
        else asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst + (t - 1) * kTermBytes), "r"(u) : "memory");
        x[a].x -= __uint_as_float(u << 16);
        x[a].y -= __uint_as_float(u & 0xffff0000u);
      }
    }
  }

  // The group's rows are rows w0.. of the RW rows at row_base of q_lat (.,
  // R) and q_rope (., DR); rows at or past RW are zero. Every load is issued
  // before the first shared store (whose memory clobber would order them).
  __device__ __forceinline__ void init(const float* __restrict__ q_lat,
                                       const float* __restrict__ q_rope,
                                       long long row_base, int w0, int RW,
                                       uint32_t qs) {
    const int warp = threadIdx.x >> 5, grp = warp / CW, cw = warp % CW;
    const int lane = threadIdx.x & 31;
    brow = ((lane & 7) + ((lane >> 4) << 3)) * WS * 2;
    vrow = ((lane & 7) + (((lane >> 3) & 1) << 3)) * WS * 2;
    qrow = (grp * 16 + (lane & 15)) * WS * 2;
    wcol = (cw * G::LK / 4) << 7;               // step_off's (P >> 2) part
    float2 xl[G::LK][4], xr[G::RK][4];
#pragma unroll
    for (int kd = 0; kd < G::LK; ++kd)
      load_q(q_lat, row_base, R, w0, RW, cw * G::NC + 16 * kd, xl[kd]);
#pragma unroll
    for (int rk = 0; rk < G::RK; ++rk)
      load_q(q_rope, row_base, DR, w0, RW, (cw * G::RK + rk) * 16, xr[rk]);
#pragma unroll
    for (int kd = 0; kd < G::LK; ++kd)
      split_q(xl[kd], ql[kd], qs, grp * 16, cw * G::NC + 16 * kd);
#pragma unroll
    for (int rk = 0; rk < G::RK; ++rk)
      split_q(xr[rk], qr[rk], qs, grp * 16, R + (cw * G::RK + rk) * 16);
#pragma unroll
    for (int dt = 0; dt < G::NT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    m[0] = m[1] = PA_NEG;
    l[0] = l[1] = 0.f;
  }

  // S += q K^T over one 16-dim step of the latent dims: the first q term
  // from registers, the others from shared memory. a_off / b_off: the
  // step's offset in a q row (A loads, sel = lane >> 4) and a key row (B
  // loads, sel = (lane >> 3) & 1).
  __device__ __forceinline__ void score_step(float (&s)[kKeys / 8][4], const uint32_t (&q0)[4],
                                             uint32_t tile, uint32_t qs, uint32_t a_off,
                                             uint32_t b_off) {
    uint32_t qt[kQTerms - 1][4];
#pragma unroll
    for (int t = 0; t < kQTerms - 1; ++t) mma::ldsm_x4(qs + t * kTermBytes + qrow + a_off, qt[t]);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t bb[4];
      mma::ldsm_x4(tile + brow + kk * 16 * WS * 2 + b_off, bb);
      mma::mma_bf16(s[2 * kk], q0, bb[0], bb[1]);
      mma::mma_bf16(s[2 * kk + 1], q0, bb[2], bb[3]);
#pragma unroll
      for (int t = 0; t < kQTerms - 1; ++t) {
        mma::mma_bf16(s[2 * kk], qt[t], bb[0], bb[1]);
        mma::mma_bf16(s[2 * kk + 1], qt[t], bb[2], bb[3]);
      }
    }
  }

  // The warp's rope steps, 16 keys at a time in fragments of their own,
  // folded into the latent scores s with each key column's scales: s =
  // s * sc0 + rope * sc1 at the (64, 2) scale rows ksc (kScaled), else s +
  // rope.
  template <bool kScaled>
  __device__ __forceinline__ void rope_steps(float (&s)[kKeys / 8][4], uint32_t tile,
                                             uint32_t qs, uint32_t ksc) {
    const int lane = threadIdx.x & 31, tg = lane & 3, cw = (threadIdx.x >> 5) % CW;
    uint32_t qt[G::RK][kQTerms - 1][4], b_off[G::RK];
#pragma unroll
    for (int rk = 0; rk < G::RK; ++rk) {
      const int P = R / 16 + cw * G::RK + rk;
#pragma unroll
      for (int t = 0; t < kQTerms - 1; ++t)
        mma::ldsm_x4(qs + t * kTermBytes + qrow + step_off(P, lane >> 4), qt[rk][t]);
      b_off[rk] = step_off(P, (lane >> 3) & 1);
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      float4 f[2];
      if constexpr (kScaled) {
#pragma unroll
        for (int n = 0; n < 2; ++n) f[n] = lds4(ksc + 8 * ((2 * kk + n) * 8 + 2 * tg));
      }
      float tr[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int rk = 0; rk < G::RK; ++rk) {
        uint32_t bb[4];
        mma::ldsm_x4(tile + brow + kk * 16 * WS * 2 + b_off[rk], bb);
        mma::mma_bf16(tr[0], qr[rk], bb[0], bb[1]);
        mma::mma_bf16(tr[1], qr[rk], bb[2], bb[3]);
#pragma unroll
        for (int t = 0; t < kQTerms - 1; ++t) {
          mma::mma_bf16(tr[0], qt[rk][t], bb[0], bb[1]);
          mma::mma_bf16(tr[1], qt[rk][t], bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[2 * kk + n][e];
          if constexpr (kScaled)
            x = (e & 1) ? x * f[n].z + tr[n][e] * f[n].w : x * f[n].x + tr[n][e] * f[n].y;
          else x += tr[n][e];
        }
      }
    }
  }

  // The online-softmax update against keys [0, nk) of the staged bf16 tile
  // (rows at or past nk zero, their scales zero). ksc: the shared address
  // of the keys' (64, 2) fp8 scales (kScaled); part: the partial-score
  // exchange (CW > 1); mk[h](j0 + j): the mask of row g + 8h at the tile's
  // key j, skipped when all_live.
  template <bool kScaled, typename MaskT>
  __device__ __forceinline__ void update(uint32_t tile, uint32_t qs, uint32_t ksc,
                                         uint32_t part, int j0, int nk,
                                         bool all_live, const MaskT (&mk)[2],
                                         float scale_log2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tg = lane & 3;
    const int grp = warp / CW;
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // the warp's share of the score contraction: its latent dims, then its
    // rope dims
    const int asel = lane >> 4, bsel = (lane >> 3) & 1;
#pragma unroll
    for (int kd = 0; kd < G::LK; ++kd) {
      const uint32_t c = wcol + ((kd >> 2) << 7);
      score_step(s, ql[kd], tile, qs, c + step_off(kd & 3, asel),
                 c + step_off(kd & 3, bsel));
    }
    rope_steps<kScaled>(s, tile, qs, ksc);
    if constexpr (CW > 1) {     // the group's partial scores, summed in warp order
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
        asm volatile("st.shared.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"r"(
                         part + ((warp * 8 + n) * 32 + lane) * 16),
                     "f"(s[n][0]), "f"(s[n][1]), "f"(s[n][2]), "f"(s[n][3]) : "memory");
      group_sync(1 + grp, CW * 32);
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          float v[4];
          asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
                       : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                       : "r"(part + (((grp * CW + c) * 8 + n) * 32 + lane) * 16));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = c == 0 ? v[e] : s[n][e] + v[e];
        }
      }
    }
    // masks and the online softmax in the log2 domain (K3's tile update)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = n * 8 + 2 * tg + (e & 1), h = e >> 1;
        float x;
        if (jj >= nk) x = -INFINITY;
        else if (!all_live && !mk[h](j0 + jj)) x = -INFINITY;
        else x = s[n][e] * scale_log2;
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
      corr[h] = mma::ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int dt = 0; dt < G::NT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
    // O += P' C over the warp's columns, P' = p * sc0 as hi + lo bf16 terms
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      float4 f[2];
      if constexpr (kScaled) {
#pragma unroll
        for (int n = 0; n < 2; ++n) f[n] = lds4(ksc + 8 * ((2 * kk + n) * 8 + 2 * tg));
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int n = 2 * kk + (a >> 1), h = a & 1;
        float pv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = mma::ex2(s[n][2 * h + c] - m[h]);
          l[h] += p;
          if constexpr (kScaled) pv[c] = p * (c ? f[a >> 1].z : f[a >> 1].x);
          else pv[c] = p;
        }
        ah[a] = mma::pack_bf16(pv[0], pv[1]);
        al[a] = mma::pack_bf16(pv[0] - __uint_as_float(ah[a] << 16),
                               pv[1] - __uint_as_float(ah[a] & 0xffff0000u));
      }
#pragma unroll
      for (int dp = 0; dp < G::NT / 2; ++dp) {
        uint32_t bb[4];
        mma::ldsm_x4_t(tile + vrow + kk * 16 * WS * 2 + wcol + ((dp >> 2) << 7) +
                           step_off(dp & 3, lane >> 4), bb);
        mma::mma_bf16(o[2 * dp], ah, bb[0], bb[1]);
        mma::mma_bf16(o[2 * dp + 1], ah, bb[2], bb[3]);
        mma::mma_bf16(o[2 * dp], al, bb[0], bb[1]);
        mma::mma_bf16(o[2 * dp + 1], al, bb[2], bb[3]);
      }
    }
  }

  // The quad's l of row g + 8h (every lane of the quad gets the same sum).
  __device__ __forceinline__ float row_l(int h) const {
    float sum = l[h];
    sum += __shfl_xor_sync(PA_FULL, sum, 1);
    sum += __shfl_xor_sync(PA_FULL, sum, 2);
    return sum;
  }

  // out row = acc / max(l, 1e-30): the warp's columns of the group's rows
  // w0.. of the RW rows at row_base of out (., R), rows below RW only; with
  // m_out and l_out (`return_state`) also each row's final m, in natural
  // units (mma::natural_m), and l at row_base + r
  __device__ __forceinline__ void store(float* __restrict__ out, long long row_base, int w0,
                                        int RW, float* __restrict__ m_out = nullptr,
                                        float* __restrict__ l_out = nullptr) {
    const int lane = threadIdx.x & 31, cw = (threadIdx.x >> 5) % CW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = row_l(h);
      const int r = w0 + (lane >> 2) + 8 * h;
      if (r >= RW) continue;
      if (m_out != nullptr && cw == 0 && (lane & 3) == 0) {
        m_out[row_base + r] = mma::natural_m(m[h]);
        l_out[row_base + r] = sum;
      }
      const float den = fmaxf(sum, 1e-30f);
      float* dst = out + (row_base + r) * R + cw * G::NC + 2 * (lane & 3);
#pragma unroll
      for (int dt = 0; dt < G::NT; ++dt)
        *reinterpret_cast<float2*>(dst + dt * 8) =
            make_float2(__fdiv_rn(o[dt][2 * h], den), __fdiv_rn(o[dt][2 * h + 1], den));
    }
  }

  // The unnormalised state of the group's rows 0..RW: row r's acc (R
  // floats) at acc + r * R, its m (log2 units) and l at ml + r * ml_stride.
  __device__ __forceinline__ void store_state(float* __restrict__ acc, float* __restrict__ ml,
                                              int ml_stride, int RW) {
    const int lane = threadIdx.x & 31, cw = (threadIdx.x >> 5) % CW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = row_l(h);
      const int r = (lane >> 2) + 8 * h;
      if (r >= RW) continue;
      float* row = acc + (long long)r * R + cw * G::NC + 2 * (lane & 3);
#pragma unroll
      for (int dt = 0; dt < G::NT; ++dt)
        *reinterpret_cast<float2*>(row + dt * 8) = make_float2(o[dt][2 * h], o[dt][2 * h + 1]);
      if (cw == 0 && (lane & 3) == 0)
        *reinterpret_cast<float2*>(ml + (long long)r * ml_stride) = make_float2(m[h], sum);
    }
  }
};

// Decode mask of K5/K7: the window + sink policy in the logical page
// domain, as the dense decode kernels (K2/K4), as bounds on the key j within
// logical page lpage (position lpage * ps + j): live iff the position is
// below len and at or past max(len - window, 0) (no window: always) or
// below sink * ps.
struct LatentDecodeMask {
  int hi, wlo, slo;
  __device__ __forceinline__ LatentDecodeMask(int lpage, int ps, int len, int window, int sink)
      : hi(len - lpage * ps),
        wlo(window ? max(len - window, 0) - lpage * ps : INT_MIN),
        slo(sink * ps - lpage * ps) {}
  __device__ __forceinline__ bool operator()(int j) const {
    return j < hi && (j >= wlo || j < slo);
  }
  // whether every key of [j0, j0 + n) is live
  __device__ __forceinline__ bool all(int j0, int n) const {
    return j0 + n <= hi && (j0 >= wlo || j0 + n <= slo);
  }
};

}  // namespace lmma
