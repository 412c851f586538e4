// K5 — paged_latent_decode and K7 — paged_latent_decode_visits, for sm_90a,
// on the tensor cores.
//
// K5 replaces the Pallas kernel `paged_latent_decode` (src/repro/kernels/
// paged_latent_decode.py, `_latent_kernel`): MLA decode in absorbed form.
// One query token per lane, its H heads already projected into latent
// space (q_lat = q_nope W_uk, f32), attends the lane's pages of the GLOBAL
// latent pool (P, ps, R+dr) through (physical, logical) page tables:
// dual-scale FP8 dequant, s = (<q_lat, c> + <q_rope, k_rope>) * sm_scale,
// the window + sink mask on logical positions, and an online (m, l, acc)
// softmax with acc in latent space (H, R), pages in ascending slot order.
// A -1 entry is never loaded. Returns o_lat (B, H, R) f32.
//
// K7 replaces `paged_latent_decode_visits` (`_latent_visit_kernel`): the
// same math over the deduplicated (page, lane bitmask, logical page) visit
// list of `kernels/visits.plan_visits`, so a prefix page shared by the
// lanes of a block is read and converted once for all of them.
//
// Bound on the H100: bytes. A decode step reads each selected latent page
// once (ps * (R + dr) fp8 bytes + 2 * ps f32 scales: 584 B a token at R
// 512, dr 64) and does 2 * (R + dr) + 2 * R operations per key and head,
// ~60 per byte at 16 heads: above the f32 rate's ratio of operations to
// bytes (~20), far below the bf16 tensor cores' (~295), on which they run.
//
// Design: a split-page decode on the latent tile of csrc/latent_mma.cuh.
//   Rows     A lane's H absorbed heads are the rows of HG = ceil(H / 16)
//            16-row groups of `lmma::WarpTile` (head group j holds heads
//            16 j.., rows at or past H zero; HG 1 up to 16 heads, 2 up to
//            32), CW warps a group (R 512: 4 warps of 128 latent columns;
//            R 64: 1). q enters as 3 bf16 terms, P' = p * sc0 as 2, fp8 ->
//            bf16 exact, each key's scales after the MMA; masked
//            probabilities are hard-zeroed.
//   Grid     K5 (B, splits): a block is one lane's HG groups. K7 (ceil(B /
//            LANES), splits): a block holds LANES lanes' groups, LANES = 8
//            warps / (CW * HG) (R 512: 2 at HG 1, 1 at HG 2; R 64: 8, 4).
//            Split z covers the table slots [z * slots,
//            (z + 1) * slots), `slots` from the wrapper's `latent_splits`
//            (the same for both kernels, at most kMaxSplits splits); K7's
//            split covers the visits [s0 * B, s1 * B), which plan_visits'
//            slot-major order makes exactly the slots [s0, s1) of every
//            lane, ascending.
//   Pages    Warp 0 lists the split's live entries (K7: the visits with a
//            member among the block's lanes) in shared memory, 32 a load
//            round trip; the block walks them one 64-key tile at a time (a
//            page of 128 keys is two). The raw fp8 tile and its scales are
//            staged by cp.async, converted once per block and tile into the
//            swizzled bf16 tile, and the next raw tile is in flight while
//            this one computes; a bf16 pool is staged straight into the
//            tile. Each group of a member lane updates its rows from the
//            one staged tile (a lane's head groups read the same tile); a
//            non-member lane's groups leave their rows as they are.
//   Merge    The splits of a lane (K7: of a block's lanes) run as one
//            thread-block cluster. Each block keeps its rows' (acc, m, l)
//            in its own shared memory; after the cluster's barrier block z
//            merges a 1 / splits slice of the columns of every row, reading
//            every block's state through distributed shared memory, in
//            ascending split order: m = max m_s, l = sum l_s 2^(m_s - m),
//            acc likewise, out = acc / max(l, 1e-30). No scratch in device
//            memory, no atomics. One split writes its rows directly.
//   State    With m_out and l_out (`return_state`) the merged (m, l) of each
//            row is stored too, by block 0 of the cluster (one split: by the
//            row's store), m in natural units (latent_mma.cuh); null
//            pointers store nothing. K7's state equals K5's bit for bit.
// A row's arithmetic depends only on its own lane's tiles in slot order,
// on (R, dr, ps) and on the split boundaries, never on which lanes share
// its block (an MMA output row reads only its own A row), so K7 is
// bit-identical to K5 under any split count. At HG 1 the code is the one
// of 16 heads a lane (the head group's offset is the constant 0).
#include <cooperative_groups.h>

#include "latent_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace lmma;

constexpr int kMaxSplits = 8;   // blocks a cluster, the portable most
constexpr int kMaxLive = 512;   // live entries a block lists at a time

struct LatentDecodeArgs {
  const float* q_lat;      // (B, H, R)
  const float* q_rope;     // (B, H, dr)
  const void* pages;       // (P, ps, R + dr)
  const float* scales;     // (P, ps, 2) or null
  const int* cache_len;    // (B,)
  const int* table_page;   // K5: phys (B, nsel); K7: visit_page (B * nsel,)
  const int* table_log;    // K5: log (B, nsel);  K7: visit_log (B * nsel,)
  const int* visit_lanes;  // K7 only
  float* out;              // (B, H, R)
  float* m_out;            // (B, H) final m, natural units, or null
  float* l_out;            // (B, H) final l, or null
  int B, H, ps, nsel, window, sink, slots;
  float sm_scale;
};

// Special registers read anew where used (asm volatile: never kept live
// across the tile loop, whose update takes nearly every register).
__device__ __forceinline__ int sreg_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ int sreg_ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ int sreg_ctaid_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  return v;
}

// The splits of a lane (K7: of a block's lanes) are one cluster, and each
// block's rows' (acc, m, l) sit in its shared memory: st_acc (rows, R),
// st_ml (rows, 2). Block z merges columns [z * slice, (z + 1) * slice) of
// every row from all the cluster's blocks (distributed shared memory) in
// ascending split order: m = max m_s, l = sum l_s 2^(m_s - m), acc
// likewise, out = acc / max(l, 1e-30). Out of line: its registers are its
// own, apart from the tile loop's.
template <int R, int LANES>
__device__ __noinline__ void merge_splits(float* __restrict__ out, float* __restrict__ m_out,
                                          float* __restrict__ l_out, float* st_acc, float* st_ml,
                                          int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, z = blockIdx.y, splits = gridDim.y;
  const int b0 = blockIdx.x * LANES;
  const int rows = min(LANES, B - b0) * H;
  float* row_w = st_ml + LANES * H * 2;             // (rows, kMaxSplits) weights
  float* row_den = row_w + LANES * H * kMaxSplits;  // (rows,)
  cluster.sync();
  for (int r = tid; r < rows; r += blockDim.x) {
    float ms[kMaxSplits], m = PA_NEG;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        ms[s] = cluster.map_shared_rank(st_ml, s)[r * 2];
        m = fmaxf(m, ms[s]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        const float w = mma::ex2(__fsub_rn(ms[s], m));
        row_w[r * kMaxSplits + s] = w;
        l = __fadd_rn(l, __fmul_rn(cluster.map_shared_rank(st_ml, s)[r * 2 + 1], w));
      }
    }
    row_den[r] = fmaxf(l, 1e-30f);
    if (m_out != nullptr && z == 0) {   // the merged state, once a row
      m_out[(long long)b0 * H + r] = mma::natural_m(m);
      l_out[(long long)b0 * H + r] = l;
    }
  }
  __syncthreads();
  // slice: ceil(R / splits) rounded up to whole float4s; the last slices
  // may be short or empty
  const int slice = ((R + splits - 1) / splits + 3) / 4 * 4, c0 = z * slice;
  const int n4 = (min(c0 + slice, R) - c0) / 4;
  for (int i = tid; i < rows * n4; i += blockDim.x) {
    const int r = i / n4, d = c0 + (i % n4) * 4;
    float4 v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits)
        v[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(st_acc, s) + r * R + d);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        const float w = row_w[r * kMaxSplits + s];
        o[0] = __fadd_rn(o[0], __fmul_rn(v[s].x, w));
        o[1] = __fadd_rn(o[1], __fmul_rn(v[s].y, w));
        o[2] = __fadd_rn(o[2], __fmul_rn(v[s].z, w));
        o[3] = __fadd_rn(o[3], __fmul_rn(v[s].w, w));
      }
    }
    const float dn = row_den[r];
    *reinterpret_cast<float4*>(out + ((long long)b0 * H + r) * R + d) =
        make_float4(__fdiv_rn(o[0], dn), __fdiv_rn(o[1], dn), __fdiv_rn(o[2], dn),
                    __fdiv_rn(o[3], dn));
  }
  cluster.sync();               // every block done reading the others' state
}

template <int R, int DR, int CW, int LANES, int HG, typename KVT, bool VISITS>
__global__ void __launch_bounds__(LANES * HG * CW * 32, 1)
latent_decode_kernel(LatentDecodeArgs a) {
  constexpr int WARPS = LANES * HG * CW;
  using G = Geo<R, DR, CW, WARPS>;
  constexpr int W = G::W, WS = G::WS;
  constexpr bool kFp8 = sizeof(KVT) == 1;
  using SM = Smem<R, DR, CW, WARPS, kFp8>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int2 live_list[kMaxLive];   // live entries: (page, lpage << 8 | members)
  __shared__ int n_live, e_next;
  __shared__ int lens[LANES];            // the lanes' lengths (0: no lane)
  const uint32_t base = mma::smem_addr(smem);
  const uint32_t tile = base, qs = base + SM::q;
  const int tid = threadIdx.x, lane = tid & 31, grp = (tid >> 5) / CW;
  const int li = grp / HG, hg = grp % HG;       // the group's lane, head group
  const int z = blockIdx.y;
  const int b0 = blockIdx.x * LANES;            // the block's first lane
  const int ps = a.ps;
  if (tid < LANES) lens[tid] = b0 + tid < a.B ? a.cache_len[b0 + tid] : 0;

  // This split's live entries of the table (K5) or the visit list (K7: the
  // visits with a member among the block's lanes) are listed in shared
  // memory by warp 0, 32 entries a load round trip, up to kMaxLive at a
  // time, as (page, logical page << 8 | member groups): the walk keeps no
  // window in registers (the tile update takes nearly all of them).
  // the end of the split's entries (read anew where used, see sreg_tid)
  auto end_of_split = [&]() {
    const int s1 = min((sreg_ctaid_y() + 1) * a.slots, a.nsel);
    return VISITS ? s1 * a.B : sreg_ctaid_x() * a.nsel + s1;
  };
  auto list = [&](int from) {                   // warp 0; the caller syncs
    const int e1 = end_of_split();
    int n = 0, c = from;
    for (; c < e1 && n <= kMaxLive - 32; c += 32) {
      const int e = c + lane;
      int page = -1, lpage = 0;
      unsigned mem = 0u;
      if (e < e1) {
        page = a.table_page[e];
        lpage = a.table_log[e];
        mem = VISITS ? ((unsigned)a.visit_lanes[e] >> b0) & ((1u << LANES) - 1u) : 1u;
      }
      if (page < 0) mem = 0u;
      const unsigned live = __ballot_sync(PA_FULL, mem != 0u);
      if (mem) live_list[n + __popc(live & ((1u << lane) - 1u))] = make_int2(page, (lpage << 8) | (int)mem);
      n += __popc(live);
    }
    if (lane == 0) {
      n_live = n;
      e_next = min(c, e1);
    }
  };
  // tile t of the list: part t & sh of entry t >> sh (a page of 128 keys is
  // two tiles). stage: fp8 into the raw tile and scale row `buf`, bf16
  // straight into the tile
  const int sh = ps > kKeys ? 1 : 0;
  auto stage = [&](int t, int buf) {
    const int j0 = (t & sh) * kKeys, nk = min(kKeys, ps - j0);
    const long long first = (long long)live_list[t >> sh].x * ps + j0;   // first key line
    if constexpr (kFp8)
      stage_raw<W>(base + SM::raw, base + SM::sc + buf * kKeys * 8,
                   static_cast<const unsigned char*>(a.pages) + first * W, a.scales + first * 2, nk);
    else
      stage_bf16<W, WS>(tile, static_cast<const __nv_bfloat16*>(a.pages) + first * W, nk);
    mma::cp_commit();
  };

  const float scale_log2 = a.sm_scale * mma::kLog2e;
  if (tid < 32) list(VISITS ? z * a.slots * a.B : b0 * a.nsel + z * a.slots);
  __syncthreads();
  if (n_live > 0) stage(0, 0);
  // q's terms load while the first tile is in flight
  WarpTile<R, DR, CW, WARPS> wt;
  wt.init(a.q_lat, a.q_rope, (long long)(b0 + li) * a.H, hg * 16, b0 + li < a.B ? a.H : 0,
          qs);
  for (;;) {
    const int total = n_live << sh;
    for (int t = 0, buf = 0; t < total; ++t, buf ^= 1) {
      mma::cp_wait_all();
      __syncthreads();          // tile staged; every warp done with the last one
      const int j0 = (t & sh) * kKeys, nk = min(kKeys, ps - j0);
      if constexpr (kFp8) {     // e4m3 -> bf16, exact; rows (and scales) nk..64 zeroed
        convert_raw<W, WS>(tile, smem + SM::raw,
                           reinterpret_cast<float*>(smem + SM::sc) + buf * kKeys * 2, nk);
        __syncthreads();        // the raw tile is free: the next one lands during this compute
        if (t + 1 < total) stage(t + 1, buf ^ 1);
      }
      const int meta = live_list[t >> sh].y;
      const LatentDecodeMask mk(meta >> 8, ps, lens[li], a.window, a.sink);
      // a member lane's groups update; a tile wholly past its lane's length
      // is an exact identity update (every score masked), not skipped: the
      // skip's registers spill
      if ((meta >> li) & 1) {
        const LatentDecodeMask mks[2] = {mk, mk};
        wt.template update<kFp8>(tile, qs, base + SM::sc + buf * kKeys * 8, base + SM::part, j0,
                                 nk, mk.all(j0, nk), mks, scale_log2);
      }
      if constexpr (!kFp8) {
        __syncthreads();        // every warp done with the tile
        if (t + 1 < total) stage(t + 1, buf ^ 1);
      }
    }
    __syncthreads();            // every warp done with the list and the tile
    if (e_next >= end_of_split()) break;
    if (sreg_tid() < 32) list(e_next);   // more than kMaxLive live entries: the next ones
    __syncthreads();
    if (n_live > 0) stage(0, 0);
  }

  // the group, its lane and head group read anew (see sreg_tid)
  const int g = (sreg_tid() >> 5) / CW, gl = g / HG, h0 = g % HG * 16;
  const int b = sreg_ctaid_x() * LANES + gl;
  if (gridDim.y == 1) {
    if (b < a.B) wt.store(a.out, (long long)b * a.H, h0, a.H, a.m_out, a.l_out);
    return;
  }
  float* st_acc = reinterpret_cast<float*>(smem);   // (LANES * H, R); free after the loop
  float* st_ml = st_acc + LANES * a.H * R;          // (LANES * H, 2)
  const int r0 = gl * a.H + h0;                     // the group's first row
  if (b < a.B) wt.store_state(st_acc + r0 * R, st_ml + r0 * 2, 2, a.H - h0);
  merge_splits<R, LANES>(a.out, a.m_out, a.l_out, st_acc, st_ml, a.B, a.H);
}

// One instantiation: CW warps a 16-row group, HG groups a lane (ceil(H /
// 16)), LANES lanes a block, the pool type and the kernel (K5: one lane a
// block; K7: as many as 8 warps hold).
template <int R_, int DR_, int CW_, int HG_, typename KVT_, bool VISITS_>
struct Inst {
  static constexpr int R = R_, DR = DR_, CW = CW_, HG = HG_;
  static constexpr bool VISITS = VISITS_;
  static constexpr int LANES = VISITS_ ? 8 / (CW_ * HG_) : 1;
  using KVT = KVT_;
};

template <int R, int DR, int CW, int HG, typename F>
int dispatch_pool(int opt_kv, bool visits, F&& f) {
  if (visits)
    return opt_kv ? f(Inst<R, DR, CW, HG, fp8_t, true>{})
                  : f(Inst<R, DR, CW, HG, __nv_bfloat16, true>{});
  return opt_kv ? f(Inst<R, DR, CW, HG, fp8_t, false>{})
                : f(Inst<R, DR, CW, HG, __nv_bfloat16, false>{});
}

template <int R, int DR, int CW, typename F>
int dispatch_heads(int H, int opt_kv, bool visits, F&& f) {
  if (H >= 1 && H <= 16) return dispatch_pool<R, DR, CW, 1>(opt_kv, visits, f);
  if (H > 16 && H <= 32) return dispatch_pool<R, DR, CW, 2>(opt_kv, visits, f);
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int dispatch(int R, int dr, int H, int opt_kv, bool visits, F&& f) {
  if (R == 512 && dr == 64)     // a group of 4 warps, 128 latent columns each
    return dispatch_heads<512, 64, 4>(H, opt_kv, visits, f);
  if (R == 64 && dr == 32)      // a group of 1 warp
    return dispatch_heads<64, 32, 1>(H, opt_kv, visits, f);
  return (int)cudaErrorInvalidValue;
}

template <class I>
auto kernel_of() {
  return latent_decode_kernel<I::R, I::DR, I::CW, I::LANES, I::HG, typename I::KVT, I::VISITS>;
}

template <class I>
constexpr int smem_of() {
  return Smem<I::R, I::DR, I::CW, I::LANES * I::HG * I::CW, sizeof(typename I::KVT) == 1>::kBytes;
}

// blocks and splits of this instantiation's last launch
template <class I>
int g_last[2] = {0, 0};

template <class I>
int launch(const LatentDecodeArgs& a, int splits, cudaStream_t st) {
  using G = Geo<I::R, I::DR, I::CW, I::LANES * I::HG * I::CW>;
  // the merge keeps a block's rows' state in the dynamic shared memory
  const int rows = I::LANES * a.H;
  if (splits < 1 || splits > kMaxSplits || a.H > 16 * I::HG ||
      rows * (I::R + 2 + kMaxSplits + 1) * 4 > smem_of<I>())
    return (int)cudaErrorInvalidValue;
  static_assert(G::kRows == 16 * I::LANES * I::HG, "HG groups a lane");
  const auto kernel = kernel_of<I>();
  // always opt in: the static list sits on top of the dynamic bytes
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_of<I>());
  if (e != cudaSuccess) return (int)e;
  const int groups = (a.B + I::LANES - 1) / I::LANES;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, splits);
  cfg.blockDim = dim3(I::LANES * I::HG * I::CW * 32);
  cfg.dynamicSmemBytes = smem_of<I>();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // a lane's splits: one cluster
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) {
    g_last<I>[0] = groups * splits;
    g_last<I>[1] = splits;
  }
  return (int)e;
}

// info = {lanes a block, threads a block, dynamic shared bytes, registers a
// thread, local bytes a thread (spills and stack), bf16 terms of q, bf16
// terms of P', blocks and splits of this instantiation's last launch}, the
// registers and local bytes as the loaded kernel reports them
template <class I>
int describe(int* info) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel_of<I>());
  if (e != cudaSuccess) return (int)e;
  const int v[9] = {I::LANES, I::LANES * I::HG * I::CW * 32, smem_of<I>(), fa.numRegs,
                    (int)fa.localSizeBytes, kQTerms, kPTerms, g_last<I>[0],
                    g_last<I>[1]};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return 0;
}

int splits_of(int nsel, int slots) {
  return slots < 1 ? 0 : nsel < 1 ? 1 : (nsel + slots - 1) / slots;
}

}  // namespace

extern "C" int paged_latent_decode(
    const float* q_lat, const float* q_rope, const void* pages,
    const float* scales, const int* cache_len, const int* phys, const int* log,
    float* out, float* m_out, float* l_out, int B, int H, int R, int dr, int ps,
    int nsel, int opt_kv, int window, int sink, int slots, float sm_scale,
    void* stream) {
  const LatentDecodeArgs a{q_lat, q_rope, pages, scales, cache_len, phys, log, nullptr,
                           out, m_out, l_out, B, H, ps, nsel, window, sink, slots,
                           sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(R, dr, H, opt_kv, false, [&](auto inst) {
    return launch<decltype(inst)>(a, splits_of(nsel, slots), st);
  });
}

// nsel: the visits a lane, B * nsel in all (plan_visits' slot-major list)
extern "C" int paged_latent_decode_visits(
    const float* q_lat, const float* q_rope, const void* pages,
    const float* scales, const int* cache_len, const int* visit_page,
    const int* visit_lanes, const int* visit_log, float* out, float* m_out,
    float* l_out, int B, int H, int R, int dr, int ps, int nsel, int opt_kv,
    int window, int sink, int slots, float sm_scale, void* stream) {
  const LatentDecodeArgs a{q_lat, q_rope, pages, scales, cache_len, visit_page, visit_log,
                           visit_lanes, out, m_out, l_out, B, H, ps, nsel, window, sink,
                           slots, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(R, dr, H, opt_kv, true, [&](auto inst) {
    return launch<decltype(inst)>(a, splits_of(nsel, slots), st);
  });
}

// The instantiation that K5 (visits 0) or K7 (visits 1) runs for (R, dr,
// H, opt_kv): info[0..8] as `describe`.
extern "C" int paged_latent_decode_info(int R, int dr, int H, int opt_kv, int visits,
                                        int* info) {
  return dispatch(R, dr, H, opt_kv, visits != 0,
                  [&](auto inst) { return describe<decltype(inst)>(info); });
}
