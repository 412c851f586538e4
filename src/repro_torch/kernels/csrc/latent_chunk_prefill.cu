// K6 — latent_chunk_prefill for sm_90a, on the tensor cores.
//
// Replaces the Pallas kernel `latent_chunk_prefill` (src/repro/kernels/
// latent_chunk_prefill.py, `_latent_chunk_kernel`): the chunk analogue of
// K5 for the MLA family's mixed steps. A chunk of absorbed queries per lane
// (rows r = s * H + h in latent space, each with its token's absolute
// position; a decode lane is a chunk of length 1) attends the lane's cached
// latent pages of the GLOBAL pool (prefix hits, earlier chunks and the
// chunk itself, already written) through its physical page table. Masks:
// causal, window + sink, and the concat-prefill packing planes (segment
// equality, key positions page_base * ps + i), evaluated per row, with
// masked probabilities hard-zeroed, so a cross-segment or wholly masked
// page adds exactly 0 and a row that sees no live key writes 0. A page is
// never loaded when its entry is -1, and a 64-key tile of it is skipped
// when its first key lies beyond every query of the block. Pages are
// reduced in ascending slot order. Returns o_lat (B, S, H, R) f32.
//
// Bound on the H100: operations. Every row scores each causal key over
// R + dr dims and accumulates R dims (2 * (R + dr) + 2 * R operations per
// row and key); a 512-token chunk of 16 heads is 8192 rows a lane against
// the same ~1k-token history, far above the card's ratio of operations to
// bytes. Those operations run on mma.sync.m16n8k16 (bf16 in, f32 sums):
//   S = (sc0_j <q_lat, c_j> + sc1_j <q_rope, r_j>) * sm_scale
//        q_lat and q_rope enter as kQTerms = 3 bf16 terms (t0 = bf16(q),
//        t1 = bf16(q - t0), t2 = bf16(q - t0 - t1)); c and r as the page's
//        values, fp8 -> bf16 exact. The latent and rope parts sum in
//        separate fragments, so each key column takes its own scale after
//        the MMA.
//   O += P' C   P' = p * sc0_j as two bf16 terms (hi, lo), against the same
//        bf16 tile read transposed (the latent tile is K and V at once).
// Why three q terms: this arithmetic emulated on the CPU (tests/
// test_torch_kernels.py::test_latent_tile_three_q_terms_hold_f32_tolerance,
// 256 tokens of 16 heads over 1024 keys) reads 0.61 of the f32 tolerance
// the card holds K6 to (LAT_RTOL 2^-12, LAT_ATOL 2^-16) with two q terms,
// 0.22 with three, and over 100 with q or P' as one term; at
// chip_smoke.py's kernel-phase shape (4 lanes of 8192 rows) an H100 read
// 0.98 with two (1.12 with the packing planes) and 0.43 with three. The
// tensor cores execute 2.5x the bound's operations.
//
// The accumulator is the constraint: a row's is R = 512 f32 wide, so a warp
// owning 16 whole rows would hold 256 accumulator registers a thread.
// Design: one block of 8 warps per (lane, tile of kRows rows); the warps
// form row groups of 16 rows and CW warps each (R 512: 2 groups of 4, 32
// rows a block). Warp cw of a group owns latent columns [cw R/CW, (cw+1)
// R/CW) of the accumulator (64 registers at R 512) and computes the score
// contraction over those latent dims and a 1/CW share of the rope dims; the
// CW partial scores meet in shared memory and every warp of the group sums
// them in the same fixed order, so the group's warps hold the same scores
// and (m, l) bit for bit. q's first term stays in registers, the other two
// in shared memory (read by ldmatrix once a k-step and tile). The raw fp8
// tile of 64 keys (and its f32 scales) is staged by cp.async, converted
// once per block and tile into one XOR-swizzled bf16 tile, and the next
// raw tile is in flight while this one computes; a bf16 pool is staged
// straight into the bf16 tile. A page shorter than 64 keys fills a tile
// whose rows (and scales) past its end are zero and whose columns there are
// masked. wgmma, TMA and warp specialisation are later work.
#include <climits>

#include "mma_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kKeys = mma::kKeys;             // keys a tile: 64
constexpr int kQTerms = 3;                    // bf16 terms of q
constexpr int kPTerms = 2;                    // bf16 terms of P' (hi, lo)

struct LatentChunkArgs {
  const float* q_lat;      // (B, S * H, R)
  const float* q_rope;     // (B, S * H, dr)
  const int* positions;    // (B, S)
  const void* pages;       // (P, ps, R + dr)
  const float* scales;     // (P, ps, 2) or null
  const int* phys;         // (B, NP)
  const int* page_base;    // (B, NP) or null: base = slot
  const int* page_seg;     // (B, NP) or null: segment 0
  const int* seg_q;        // (B, S) or null: segment 0
  float* out;              // (B, S * H, R)
  int B, S, H, ps, np, window, sink;
  float sm_scale;
};

// The split of one instantiation: CW warps a row group of 16 rows.
template <int R, int DR, int CW>
struct Geo {
  static constexpr int W = R + DR;
  // bf16 row stride: W rounded up to 8 chunks of 16 bytes, so the XOR
  // swizzle (chunk ^ (row & 7)) stays inside the row
  static constexpr int WS = (W / 8 + 7) / 8 * 64;
  static constexpr int kGroups = kWarps / CW;
  static constexpr int kRows = 16 * kGroups;  // rows a block
  static constexpr int NC = R / CW;           // latent columns a warp
  static constexpr int LK = NC / 16;          // latent k-steps a warp
  static constexpr int RK = DR / 16 / CW;     // rope k-steps a warp
  static constexpr int NT = NC / 8;           // accumulator n-tiles a warp
  static_assert(NC % 16 == 0 && DR % (16 * CW) == 0, "split");
};

// Shared memory, in order: the bf16 tile; q's terms 1.. (kRows rows of WS
// bf16 each, swizzled like the tile); for CW > 1, each warp's partial
// scores (32 floats a lane); for fp8, the raw tile and two (64, 2) scale
// rows (the next tile's scales land while this tile's are read).
template <int R, int DR, int CW, bool kFp8>
struct Smem {
  using G = Geo<R, DR, CW>;
  static constexpr int kTile = kKeys * G::WS * 2;
  static constexpr int kQ = (kQTerms - 1) * G::kRows * G::WS * 2;
  static constexpr int kPart = CW > 1 ? kWarps * 32 * 32 * 4 : 0;
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

// One warp's share of a row group: the first bf16 term of its q fragments
// (the latent columns it owns and its share of the rope dims), its columns
// of the f32 accumulator, and (m, l) of rows g and g + 8 of the group (l is
// this lane's share of the quad's sum; the same in every warp of the
// group).
template <int R, int DR, int CW>
struct WarpTile {
  using G = Geo<R, DR, CW>;
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

  // One 16 x 16 block of f32 queries (rows w0 + (g, g + 8), columns col0 +
  // (2t, 2t + 1, 2t + 8, 2t + 9); rows at or past RW zero) as kQTerms bf16
  // terms, each the rounding of what the earlier ones leave: the first
  // into the A-fragment f, the others into the shared q terms at the
  // block's row srow and the tile's dim dim0.
  __device__ __forceinline__ void load_q(const float* __restrict__ q,
                                         long long row_base, int stride, int w0,
                                         int RW, int col0, uint32_t (&f)[4],
                                         uint32_t qs, int srow, int dim0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = w0 + g + 8 * (a & 1);
      const int c = col0 + 2 * tg + 8 * (a >> 1);
      float x = 0.f, y = 0.f;
      if (r < RW) {
        const float* p = q + (row_base + r) * stride + c;
        x = p[0];
        y = p[1];
      }
      const uint32_t dst = qs + mma::swz<WS>(srow + g + 8 * (a & 1), dim0 / 8 + (a >> 1)) + 4 * tg;
#pragma unroll
      for (int t = 0; t < kQTerms; ++t) {
        const uint32_t u = mma::pack_bf16(x, y);
        if (t == 0) f[a] = u;
        else asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst + (t - 1) * kTermBytes), "r"(u) : "memory");
        x -= __uint_as_float(u << 16);
        y -= __uint_as_float(u & 0xffff0000u);
      }
    }
  }

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
#pragma unroll
    for (int kd = 0; kd < G::LK; ++kd)
      load_q(q_lat, row_base, R, w0, RW, cw * G::NC + 16 * kd, ql[kd], qs, grp * 16,
             cw * G::NC + 16 * kd);
#pragma unroll
    for (int rk = 0; rk < G::RK; ++rk)
      load_q(q_rope, row_base, DR, w0, RW, (cw * G::RK + rk) * 16, qr[rk], qs, grp * 16,
             R + (cw * G::RK + rk) * 16);
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
  // exchange (CW > 1); mk[h]: the mask of row g + 8h, skipped when
  // all_live.
  template <bool kScaled>
  __device__ __forceinline__ void update(uint32_t tile, uint32_t qs, uint32_t ksc,
                                         uint32_t part, int j0, int nk,
                                         bool all_live, const ChunkMask (&mk)[2],
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

  // out row = acc / max(l, 1e-30), the warp's columns of its rows below RW
  __device__ __forceinline__ void store(float* __restrict__ out, int S, int H) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cw = warp % CW;
    const int RW = S * H, w0 = blockIdx.y * G::kRows + (warp / CW) * 16;
    const long long row_base = (long long)blockIdx.x * RW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(PA_FULL, sum, 1);
      sum += __shfl_xor_sync(PA_FULL, sum, 2);
      const int r = w0 + (lane >> 2) + 8 * h;
      if (r >= RW) continue;
      const float den = fmaxf(sum, 1e-30f);
      float* dst = out + (row_base + r) * R + cw * G::NC + 2 * (lane & 3);
#pragma unroll
      for (int dt = 0; dt < G::NT; ++dt)
        *reinterpret_cast<float2*>(dst + dt * 8) =
            make_float2(__fdiv_rn(o[dt][2 * h], den), __fdiv_rn(o[dt][2 * h + 1], den));
    }
  }
};

template <int R, int DR, int CW, typename KVT>
__global__ void __launch_bounds__(kWarps * 32, 1)
latent_chunk_kernel(LatentChunkArgs a) {
  using G = Geo<R, DR, CW>;
  constexpr int W = G::W, WS = G::WS;
  constexpr bool kFp8 = sizeof(KVT) == 1;
  using SM = Smem<R, DR, CW, kFp8>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = mma::smem_addr(smem);
  const uint32_t tile = base, qs = base + SM::q;
  __shared__ int warp_max[kWarps];
  const int ps = a.ps;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int RW = a.S * a.H;
  const int w0 = blockIdx.y * G::kRows + (warp / CW) * 16;  // the group's first row
  const long long row_base = (long long)b * RW;

  // this lane's rows g and g + 8 of the group, and the group's smallest and
  // largest position over its rows below RW
  int qpos[2], qseg[2];
  bool real[2];
  int wmax = INT_MIN, wmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + (lane >> 2) + 8 * i;
    real[i] = r < RW;
    const int s = real[i] ? r / a.H : 0;
    qpos[i] = real[i] ? a.positions[b * a.S + s] : 0;
    qseg[i] = real[i] && a.seg_q != nullptr ? a.seg_q[b * a.S + s] : 0;
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

  WarpTile<R, DR, CW> wt;
  wt.init(a.q_lat, a.q_rope, row_base, w0, RW, qs);
  __syncthreads();
  int max_pos = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) max_pos = max(max_pos, warp_max[w]);

  const int* phys = a.phys + b * a.np;
  auto base_of = [&](int j) { return a.page_base != nullptr ? a.page_base[b * a.np + j] : j; };
  const int nt = (ps + kKeys - 1) / kKeys;    // tiles a page
  const int total = a.np * nt;
  auto next_live = [&](int t) {               // tile t = slot * nt + part
    for (; t < total; ++t) {
      const int j = t / nt;
      if (phys[j] >= 0 && base_of(j) * ps + (t % nt) * kKeys <= max_pos) break;
    }
    return t;
  };
  // stage tile t: fp8 into the raw tile and scale rows `buf`, bf16 straight
  // into the swizzled tile (rows nk..64 zeroed)
  auto stage = [&](int t, int buf) {
    const int j0 = (t % nt) * kKeys;
    const int nk = min(kKeys, ps - j0);
    const long long first = (long long)phys[t / nt] * ps + j0;   // first key line
    if constexpr (kFp8) {
      const unsigned char* src = static_cast<const unsigned char*>(a.pages) + first * W;
      for (int c = threadIdx.x; c < nk * W / 16; c += blockDim.x)
        mma::cp_async16(base + SM::raw + c * 16, src + c * 16, true);
      for (int i = threadIdx.x; i < 2 * nk; i += blockDim.x)
        mma::cp_async4(base + SM::sc + buf * kKeys * 8 + i * 4, a.scales + first * 2 + i);
    } else {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.pages) + first * W;
      constexpr int kC = W / 8;
      for (int c = threadIdx.x; c < kKeys * kC; c += blockDim.x) {
        const int r = c / kC, w = c % kC;
        mma::cp_async16(tile + mma::swz<WS>(r, w), r < nk ? src + r * W + w * 8 : src, r < nk);
      }
    }
    mma::cp_commit();
  };

  const float scale_log2 = a.sm_scale * mma::kLog2e;
  const uint32_t part = base + SM::part;

  int t = next_live(0);
  if (t < total) stage(t, 0);
  for (int buf = 0; t < total; buf ^= 1) {
    mma::cp_wait_all();
    __syncthreads();            // tile t staged; every warp done with the last one
    const int tn = next_live(t + 1);
    const int j = t / nt, j0 = (t % nt) * kKeys;
    const int nk = min(kKeys, ps - j0);
    if constexpr (kFp8) {       // e4m3 -> bf16, exact; rows (and scales) nk..64 zeroed
      const unsigned char* raw = smem + SM::raw;
      constexpr int kC = W / 8;
      float* sc = reinterpret_cast<float*>(smem + SM::sc) + buf * kKeys * 2;
      for (int i = 2 * nk + threadIdx.x; i < 2 * kKeys; i += blockDim.x) sc[i] = 0.f;
      for (int c = threadIdx.x; c < kKeys * kC; c += blockDim.x) {
        const int r = c / kC, w = c % kC;
        uint4 y = make_uint4(0, 0, 0, 0);
        if (r < nk) y = mma::fp8x8_to_bf16x8(*reinterpret_cast<const uint2*>(raw + r * W + w * 8));
        asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(tile + mma::swz<WS>(r, w)),
                     "r"(y.x), "r"(y.y), "r"(y.z), "r"(y.w) : "memory");
      }
      __syncthreads();          // the raw tile is free: the next one lands during this compute
      if (tn < total) stage(tn, buf ^ 1);
    }
    const int pbase = base_of(j);
    const int kbase = pbase * ps + j0;
    if (kbase <= wmax) {        // else wholly in the future of the group (all its warps)
      const int pseg = a.page_seg != nullptr ? a.page_seg[b * a.np + j] : 0;
      // the tile wholly visible to the group's rows: every key at or before
      // each row, inside its window or sink, and in its segment
      const bool all_live =
          kbase + nk - 1 <= wmin &&
          (!a.window || kbase > wmax - a.window || kbase + nk <= a.sink * ps) &&
          __all_sync(PA_FULL, (!real[0] || qseg[0] == pseg) && (!real[1] || qseg[1] == pseg));
      const ChunkMask mk[2] = {{pbase, ps, qpos[0], qseg[0], pseg, a.window, a.sink},
                               {pbase, ps, qpos[1], qseg[1], pseg, a.window, a.sink}};
      wt.template update<kFp8>(tile, qs, base + SM::sc + buf * kKeys * 8, part, j0, nk,
                               all_live, mk, scale_log2);
    }
    if constexpr (!kFp8) {
      __syncthreads();          // every warp done with the tile
      if (tn < total) stage(tn, 0);
    }
    t = tn;
  }
  wt.store(a.out, a.S, a.H);
}

// One instantiation: the rows' split (CW warps a row group) and the pool type.
template <int R_, int DR_, int CW_, typename KVT_>
struct Inst {
  static constexpr int R = R_, DR = DR_, CW = CW_;
  using KVT = KVT_;
};

// f(Inst<...>{}) for the instantiation that serves (R, dr, opt_kv)
template <typename F>
int dispatch(int R, int dr, int opt_kv, F&& f) {
  if (R == 512 && dr == 64)     // 2 row groups of 4 warps: 32 rows a block
    return opt_kv ? f(Inst<512, 64, 4, fp8_t>{}) : f(Inst<512, 64, 4, __nv_bfloat16>{});
  if (R == 64 && dr == 32)      // 8 row groups of 1 warp: 128 rows a block
    return opt_kv ? f(Inst<64, 32, 1, fp8_t>{}) : f(Inst<64, 32, 1, __nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

int g_last_blocks = 0;          // blocks of this library's last launch

template <class I>
int launch(const LatentChunkArgs& a, cudaStream_t st) {
  using G = Geo<I::R, I::DR, I::CW>;
  const auto kernel = latent_chunk_kernel<I::R, I::DR, I::CW, typename I::KVT>;
  const int tiles = (a.S * a.H + G::kRows - 1) / G::kRows;
  const int smem = Smem<I::R, I::DR, I::CW, sizeof(typename I::KVT) == 1>::kBytes;
  // always opt in: the static tile-max array sits on top of the dynamic bytes
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.B, tiles), kWarps * 32, smem, st>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) g_last_blocks = a.B * tiles;
  return (int)e;
}

// info = {rows a block, threads a block, dynamic shared bytes, registers a
// thread, local bytes a thread (spills and stack), bf16 terms of q, bf16
// terms of P', blocks of the last launch}, the registers and local bytes
// as the loaded kernel reports them
template <class I>
int describe(int* info) {
  using G = Geo<I::R, I::DR, I::CW>;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(
      &fa, latent_chunk_kernel<I::R, I::DR, I::CW, typename I::KVT>);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {G::kRows, kWarps * 32,
                    Smem<I::R, I::DR, I::CW, sizeof(typename I::KVT) == 1>::kBytes,
                    fa.numRegs, (int)fa.localSizeBytes, kQTerms, kPTerms, g_last_blocks};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

}  // namespace

extern "C" int latent_chunk_prefill(
    const float* q_lat, const float* q_rope, const int* positions,
    const void* pages, const float* scales, const int* phys,
    const int* page_base, const int* page_seg, const int* seg_q, float* out,
    int B, int S, int H, int R, int dr, int ps, int np, int opt_kv, int window,
    int sink, float sm_scale, void* stream) {
  LatentChunkArgs a{q_lat, q_rope, positions, pages, scales, phys, page_base,
                    page_seg, seg_q, out, B, S, H, ps, np, window, sink,
                    sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(R, dr, opt_kv, [&](auto inst) { return launch<decltype(inst)>(a, st); });
}

// The geometry and compiled resources of the instantiation that
// latent_chunk_prefill runs for (R, dr, opt_kv): info[0..7] as `describe`.
extern "C" int latent_chunk_prefill_info(int R, int dr, int opt_kv, int* info) {
  return dispatch(R, dr, opt_kv, [&](auto inst) { return describe<decltype(inst)>(info); });
}
