// Device code of the persistent recurrence kernels (the decoder scans,
// dec_scan_fwd.cu and dec_scan_bwd.cu, and the encoder GRU's backward,
// gru_bwd.cu): the per-step products of the persistent grids against
// weight slices resident in shared memory, the grid of streamed-product
// tiles that runs the time-parallel work before and after the recurrence,
// and the GRU cell backward of one unit. Each recurrence is one cooperative
// grid of one CTA of THREADS threads per SM; its phases are separated by
// grid syncs, and data another CTA wrote in the launch is read through L2
// only (cp.async.cg, __ldcg), never through L1 or the read-only path,
// which are not coherent across SMs.
//
// Products run on the tensor cores as three TF32 products (3xTF32,
// tf32_mma.cuh's mma_tf32): a_small*b_big + a_big*b_small + a_big*b_big in
// fp32 accumulators, about fp32's accuracy. The tiling is ops/dec_scan.py's
// dec_scan_plan and ops/gru_kernel.py's gru_bwd_plan: the constants come
// as -D defines (ops/scan_tiles.py), the tiles of each product as the Prod
// fields (launch arguments), checked but not derived here.
//
// The bf16 instances (built with -DVAG_BF16=1, the JAX package's
// compute_dtype="bfloat16": ops/pallas_dec_scan.py, ops/pallas_gru.py):
// the weights (sx_t) and the time streams arrive in bf16, and every matrix
// product is bf16 x bf16 -> fp32 as jnp.dot(a.astype(bf16), w_bf16,
// preferred_element_type=f32) computes it. The per-step products hold
// their weight slices in shared memory as bf16 (half the bytes: more
// widths resident) and run mma.sync m16n8k16 on the fp32 activations
// rounded to bf16 as they are loaded (loading the bf16 copies below
// instead made every product phase slower: PERF.md's decoder scans); the
// attention phases load the bf16 ctx 16 bytes (8 values) a lane. The
// decoder scans' recurrences write bf16 copies of the activations the
// time-parallel products read (s, s~ and c forward; dpre, dxg2, dhg2, dq
// and dhg1 backward), and those products (the forward's readout; the
// backward's readout terms and weight grads) and the backward's replay,
// whose steps are independent (dec_scan_fwd.cu), run on bf16_tile.cuh's
// m16n8k16 tiles of the bf16 copies, as do gru_bwd.cu's recompute and
// weight grads; the streamed 3xTF32 tiles below stay for fp32 products,
// and may store a bf16 output (Job::obf: dec_scan_bwd.cu's dctx). Gate
// math, the attention, the carries and every sum stay fp32. Without
// VAG_BF16 the code below is the fp32 instances' as before.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32_mma.cuh"

#if defined(VAG_BF16) && VAG_BF16
#define VAG_SCAN_BF16 1
#include <cuda_bf16.h>

#include "bf16_tile.cuh"
#else
#define VAG_SCAN_BF16 0
#endif

#if !defined(VAG_BK) || !defined(VAG_GSTAGES) || !defined(VAG_NI_MAX) || \
    !defined(VAG_GM) || !defined(VAG_GN) || !defined(VAG_PREFETCH) ||     \
    !defined(VAG_ATT_BATCH)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_BK, VAG_GSTAGES, VAG_NI_MAX, VAG_GM, VAG_GN, VAG_PREFETCH, VAG_ATT_BATCH)"
#endif

namespace vag {
namespace scan {

constexpr int THREADS = 256;         // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BK = VAG_BK;           // depth of a streamed product's chunk (32)
constexpr int GSTAGES = VAG_GSTAGES; // its cp.async ring's depth
constexpr int NI_MAX = VAG_NI_MAX;   // n8 tiles of a per-step tile, at most
static_assert(NI_MAX == 3, "product's dispatch covers 1 to 3 n8 tiles");
constexpr int PREFETCH = VAG_PREFETCH;  // 16-deep slabs of a in flight a warp
constexpr int ATT_BATCH = VAG_ATT_BATCH;  // loads a thread keeps in flight
constexpr int TS = BK + 4;           // row stride of a staged [rows][BK] chunk
constexpr int GM = VAG_GM;           // rows of a streamed-product tile (64)
constexpr int GN = VAG_GN;           // columns of a streamed-product tile (64)
constexpr int GTS = GM + 8;          // row stride of a staged [BK][GM] chunk
constexpr int GSTAGE = 2 * GM * TS;  // floats of one streamed stage (A and B)
constexpr float NEG_INF = -1e9f;     // as ops/attention.masked_softmax

static_assert(GM == 64 && GN == 64, "2 x 4 warps of 32 x 16 tiles");
static_assert(GM * TS == BK * GTS, "a stage's halves hold either layout");

// The weights' and the bf16 streams' element type.
#if VAG_SCAN_BF16
typedef __nv_bfloat16 sx_t;
#else
typedef float sx_t;
#endif

// An element as fp32, and a store from fp32, for either type.
__device__ __forceinline__ float ldx(const float* p) { return __ldg(p); }
__device__ __forceinline__ void stx(float* p, float v) { *p = v; }
#if VAG_SCAN_BF16
__device__ __forceinline__ float ldx(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void stx(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// Four bf16 (one uint2) as fp32: a bf16 is the high half of its float.
__device__ __forceinline__ float4 bf16x4(const uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// (lo, hi) rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
#endif

// One per-step product out (B, cols) = a (B, K) @ W as the plan tiles it:
// col_tiles column tiles of nt columns (a gate tile: ub units of H with
// their r, z and n columns at tile columns [0, ub), [ub, 2ub), [2ub, 3ub);
// a plain tile: nt consecutive columns) and row parts of rt rows, on cs
// column slots of nr CTAs each. CTAs [cta0, cta0 + cs * nr) take it: CTA
// cta0 + c * nr + i takes column tiles c, c + cs, ... (its k-th tile's
// weight slice at float woff + k * slice of its shared memory, or, when
// l2off >= 0, in the launch's weight buffer wl2: see prod_slice) and row
// parts i, i + nr, ... W(k, n) is w[k * ldw + n], or w[n * ldw + k] when
// trans (the backward's transposed weights).
struct Prod {
  int ub, nt, rt, nr, col_tiles, cs, cta0, woff, l2off;
  int K, cols, H;
  const sx_t* w;
  int ldw, trans;
};

__device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// x = big + small for the streamed products' 3xTF32, in two operations:
// big keeps x's top 10 mantissa bits (truncated), small = x - big is
// exact, and the tensor cores read small's top 10 bits: a term loses at
// most 2^-20 of |x| (tests/test_torch_dec_scan_plan.py models it). The
// per-step products keep tf32_mma.cuh's split_tf32 (rounded parts, five
// operations): measured faster there, split_tr faster in the streamed
// tiles (PERF.md, the decoder scans).
__device__ __forceinline__ void split_tr(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ bool al16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// W's column for column j of column tile ct, or -1 outside W.
__device__ __forceinline__ int prod_col(const Prod& p, int ct, int j) {
  if (p.ub) {
    const int u = ct * p.ub + j % p.ub;
    return j < 3 * p.ub && u < p.H ? (j / p.ub) * p.H + u : -1;
  }
  const int c = ct * p.nt + j;
  return c < p.cols ? c : -1;
}

// This CTA's column slot of p (its first column tile), or -1.
__device__ __forceinline__ int prod_slot(const Prod& p) {
  const int i = (int)blockIdx.x - p.cta0;
  return i >= 0 && i < p.cs * p.nr ? i / p.nr : -1;
}

// Floats of one column tile's weight slice (depth padded to 16-deep slabs;
// bf16 instances: two weights a float).
__host__ __device__ inline long long slice_floats(const Prod& p) {
  return (long long)((p.K + 15) / 16 * 16) * p.nt / (VAG_SCAN_BF16 ? 2 : 1);
}

// Column tiles a CTA of p takes, at most.
__host__ __device__ inline int col_passes(const Prod& p) {
  return (p.col_tiles + p.cs - 1) / p.cs;
}

// This CTA's k-th column tile's weight slice: in shared memory at float
// woff + k * slice, or (l2off >= 0: the slices do not fit) in the launch's
// buffer wl2, each CTA its own slices at l2off + ((cta - cta0) * col_passes
// + k) * slice. A CTA writes its L2 slices once and reads only its own,
// through L2 (__ldcg).
__device__ __forceinline__ float* prod_slice(const Prod& p, int k, float* smem,
                                             float* wl2) {
  if (p.l2off < 0) return smem + p.woff + k * slice_floats(p);
  return wl2 + p.l2off +
         ((long long)((int)blockIdx.x - p.cta0) * col_passes(p) + k) * slice_floats(p);
}

// Depth k's place in a 16-deep slab as the per-step products read it:
// lane tg of a warp loads depths 4 tg .. 4 tg + 3 of each slab of a in one
// 16-byte load, and uses 4 tg + 2 s and 4 tg + 2 s + 1 as the logical
// depths tg and tg + 4 of the slab's k-step s (a product sums over depth in
// any order both operands share). Returns (k-step, tg, which of the two).
__device__ __forceinline__ void slab_place(int k, int& kstep, int& tg, int& which) {
  const int kk = k & 15;
  kstep = 2 * (k >> 4) + ((kk >> 1) & 1);
  tg = kk >> 2;
  which = kk & 1;
}

// Copies column tile ct's slice of p's weights to dst in the order the
// mma B fragments read it: float2 ((kstep * NI + ni) * 32 + lane) holds
// the two depths slab_place gives lane 4 g + tg of that k-step, at column
// col(8 ni + g); zero past K and outside W. A warp reads one n8 tile's
// fragments as 32 consecutive float2: no bank conflicts, no padding. W is
// read along its rows: W^T's (a tile column's K depths) by the lanes of a
// warp, W's (a depth's tile columns) by consecutive threads. The bf16
// instances' slice: uint2 ((slab * NI + ni) * 32 + lane) holds W's depths
// 4 tg .. 4 tg + 3 of the 16-deep slab at column col(8 ni + g), lane =
// 4 g + tg: the B fragment of one m16n8k16, its depths (2 tg, 2 tg + 1,
// 2 tg + 8, 2 tg + 9) mapped onto those four as the A fragments'
// (product_part_bf16).
__device__ void load_tile(const Prod& p, int ct, sx_t* dst) {
  constexpr int U = 8;   // loads a thread keeps in flight
  const int NI = p.nt / 8, Kp = round_up(p.K, 16);
#if VAG_SCAN_BF16
  const sx_t zero = __float2bfloat16_rn(0.f);
  auto place = [&](int k, int j) {
    return (((k >> 4) * NI + (j >> 3)) * 32 + (j & 7) * 4 + ((k & 15) >> 2)) * 4 + (k & 3);
  };
#else
  const sx_t zero = 0.f;
  auto place = [&](int k, int j) {
    int kstep, tg, which;
    slab_place(k, kstep, tg, which);
    return (((kstep * NI + (j >> 3)) * 32 + (j & 7) * 4 + tg) << 1) + which;
  };
#endif
  if (p.trans) {   // warp w takes columns w, w + WARPS, ...; lanes the depths
    const int lane = threadIdx.x & 31;
    for (int j = threadIdx.x >> 5; j < p.nt; j += WARPS) {
      const int col = prod_col(p, ct, j);
      const sx_t* src = p.w + (size_t)(col < 0 ? 0 : col) * p.ldw;
      for (int k0 = lane; k0 < Kp; k0 += 32 * U) {
        sx_t v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + 32 * u;
          v[u] = col >= 0 && k < p.K ? __ldg(src + k) : zero;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k0 + 32 * u < Kp) dst[place(k0 + 32 * u, j)] = v[u];
      }
    }
  } else {         // thread i takes column i % nt of depths i / nt + dk n
    const int dk = THREADS / p.nt, j = threadIdx.x % p.nt;
    const int col = prod_col(p, ct, j);
    if (threadIdx.x >= dk * p.nt) return;
    for (int k0 = (int)threadIdx.x / p.nt; k0 < Kp; k0 += dk * U) {
      sx_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + dk * u;
        v[u] = col >= 0 && k < p.K ? __ldg(p.w + (size_t)k * p.ldw + col) : zero;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + dk * u < Kp) dst[place(k0 + dk * u, j)] = v[u];
    }
  }
}

// Every weight slice of p this CTA takes, to where prod_slice puts it.
__device__ void load_slice(const Prod& p, float* smem, float* wl2) {
  const int slot = prod_slot(p);
  if (slot < 0) return;
  for (int k = 0, ct = slot; ct < p.col_tiles; ++k, ct += p.cs)
    load_tile(p, ct, reinterpret_cast<sx_t*>(prod_slice(p, k, smem, wl2)));
}

// The first n (< 4) of x[0..3], zero after: load4's path for rows that
// are not 16-byte aligned, out of line to keep the hot loops' code small.
__device__ __noinline__ float4 load_tail(const float* x, int n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = __ldcg(x);
  if (n > 1) v.y = __ldcg(x + 1);
  if (n > 2) v.z = __ldcg(x + 2);
  if (n > 3) v.w = __ldcg(x + 3);
  return v;
}

// Depths [k, k + 4) of a's row `row`, zero past M and K: one 16-byte L2
// load when vec (K % 4 == 0, rows 16-byte aligned), else four.
__device__ __forceinline__ float4 load4(const float* a, int lda, int row, int M,
                                        int k, int K, bool vec) {
  if (row >= M || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = a + (size_t)row * lda + k;
  return vec ? __ldcg(reinterpret_cast<const float4*>(p)) : load_tail(p, K - k);
}

#if VAG_SCAN_BF16
// The same of a bf16 array, as fp32: one 8-byte L2 load when vec (K % 4 ==
// 0, rows 16-byte aligned), else load_tail_bf16 (out of line, as
// load_tail, to keep the hot loops' code small).
__device__ __noinline__ float4 load_tail_bf16(const __nv_bfloat16* x, int n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = __bfloat162float(__ldcg(x));
  if (n > 1) v.y = __bfloat162float(__ldcg(x + 1));
  if (n > 2) v.z = __bfloat162float(__ldcg(x + 2));
  if (n > 3) v.w = __bfloat162float(__ldcg(x + 3));
  return v;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* a, int lda, int row, int M,
                                        int k, int K, bool vec) {
  if (row >= M || k >= K) return make_float4(0.f, 0.f, 0.f, 0.f);
  const __nv_bfloat16* p = a + (size_t)row * lda + k;
  return vec ? bf16x4(__ldcg(reinterpret_cast<const uint2*>(p))) : load_tail_bf16(p, K - k);
}

// Depths [k, k + 8) of a bf16 array's row `row` as they lie in memory (one
// 16-byte L2 load; zero past M and K): for lda and k multiples of 8, a
// 16-byte aligned, K a multiple of 8 (the attention phases' eight-wide
// paths check it). bf_lo / bf_hi read the halves of one of its words.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* a, int lda, int row, int M,
                                       int k, int K) {
  if (row >= M || k >= K) return make_uint4(0u, 0u, 0u, 0u);
  return __ldcg(reinterpret_cast<const uint4*>(a + (size_t)row * lda + k));
}
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
#endif

// The value at (r, j) of a tile whose KS k-slices' accumulators the warps
// left in `part` (fragment order), summed in k-slice order.
__device__ __forceinline__ float tile_sum(const float* part, int KS, int MT,
                                          int NI, int r, int j) {
  const int mi = r >> 4, lane = (r & 7) * 4 + ((j & 7) >> 1);
  const int e = ((r >> 3) & 1) * 2 + (j & 1);
  const int base = (mi * NI + (j >> 3)) * 32 + lane;
  float v = 0.f;
  for (int ks = 0; ks < KS; ++ks) v += part[((ks * MT * NI * 32) + base) * 4 + e];
  return v;
}

// The two k-steps of one 16-deep slab: lo / hi hold depths 4 tg .. 4 tg + 3
// of the warp tile's rows g and g + 8 (slab_place's order), wp the slab's
// first k-step's B fragments of this lane (in shared memory, or in L2 when
// L2). k-step s's big x big products go to acc[s], its two remainder
// products to cor[s]: four independent chains an n8 tile. A warp issues in
// order, so the products are issued by kind: the two into one cor[s][ni]
// stand 4 NI - 1 mma apart.
template <int NI, bool L2>
__device__ __forceinline__ void mma_slab(float (&acc)[2][NI][4], float (&cor)[2][NI][4],
                                         const float4& lo, const float4& hi,
                                         const float2* wp) {
  uint32_t ab[2][4], asl[2][4], bb[2][NI][2], bs[2][NI][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    split_tf32(s ? lo.z : lo.x, ab[s][0], asl[s][0]);
    split_tf32(s ? hi.z : hi.x, ab[s][1], asl[s][1]);
    split_tf32(s ? lo.w : lo.y, ab[s][2], asl[s][2]);
    split_tf32(s ? hi.w : hi.y, ab[s][3], asl[s][3]);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float2 bv = L2 ? __ldcg(wp + (s * NI + ni) * 32) : wp[(s * NI + ni) * 32];
      split_tf32(bv.x, bb[s][ni][0], bs[s][ni][0]);
      split_tf32(bv.y, bb[s][ni][1], bs[s][ni][1]);
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_tf32(cor[s][ni], asl[s], bb[s][ni]);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[s][ni], ab[s], bb[s][ni]);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_tf32(cor[s][ni], ab[s], bs[s][ni]);
}

// One row part of a per-step product (see product) for NI n8 tiles a
// tile, the weight slice in shared memory or (L2) in the weight buffer:
// the warps' k-slice accumulators into `part`. Out of line, one body for
// every call site: the persistent kernels run a dozen products a step, and
// inlined copies would not stay in the instruction cache.
template <int NI, bool L2>
__device__ __noinline__ void product_part(const float* a, int lda, int M, int K,
                                          int rt, int row0, const float* wslice,
                                          float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int MT = rt / 16, KS = WARPS / MT;
  const int mi = warp % MT, ksw = warp / MT;
  const int nslab = (K + 15) / 16;
  const int s_lo = ksw * nslab / KS, s_hi = (ksw + 1) * nslab / KS;
  const bool vec = K % 4 == 0 && lda % 4 == 0 && al16(a);
  const float2* wres = reinterpret_cast<const float2*>(wslice) + lane;
  const int r = row0 + mi * 16 + g;
  float acc[2][NI][4], cor[2][NI][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][ni][e] = cor[s][ni][e] = 0.f;
  float4 lo[PREFETCH], hi[PREFETCH];
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d) {
    const int k = (s_lo + d) * 16 + 4 * tg;
    const int m = s_lo + d < s_hi ? M : 0;
    lo[d] = load4(a, lda, r, m, k, K, vec);
    hi[d] = load4(a, lda, r + 8, m, k, K, vec);
  }
  for (int s0 = s_lo; s0 < s_hi; s0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int s = s0 + d;
      if (s < s_hi) {
        const float4 l = lo[d], h = hi[d];
        if (s + PREFETCH < s_hi) {
          const int k = (s + PREFETCH) * 16 + 4 * tg;
          lo[d] = load4(a, lda, r, M, k, K, vec);
          hi[d] = load4(a, lda, r + 8, M, k, K, vec);
        }
        mma_slab<NI, L2>(acc, cor, l, h, wres + (size_t)2 * s * NI * 32);
      }
    }
  }
  float v[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[ni][e] = (acc[0][ni][e] + cor[0][ni][e]) + (acc[1][ni][e] + cor[1][ni][e]);
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
    *reinterpret_cast<float4*>(part + (((ksw * MT + mi) * NI + ni) * 32 + lane) * 4) =
        make_float4(v[ni][0], v[ni][1], v[ni][2], v[ni][3]);
}

#if VAG_SCAN_BF16
// The bf16 instances' row part: per 16-deep slab one m16n8k16 an n8 tile,
// A's fragments rounded to bf16 from the same L2 loads (lane tg's depths
// 4 tg .. 4 tg + 3 as the logical 2 tg, 2 tg + 1, 2 tg + 8, 2 tg + 9, the
// slice's order), B's one uint2 a lane.
template <int NI, bool L2>
__device__ __noinline__ void product_part_bf16(const float* a, int lda, int M, int K,
                                               int rt, int row0, const float* wslice,
                                               float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int MT = rt / 16, KS = WARPS / MT;
  const int mi = warp % MT, ksw = warp / MT;
  const int nslab = (K + 15) / 16;
  const int s_lo = ksw * nslab / KS, s_hi = (ksw + 1) * nslab / KS;
  const bool vec = K % 4 == 0 && lda % 4 == 0 && al16(a);
  const uint2* wres = reinterpret_cast<const uint2*>(wslice) + lane;
  const int r = row0 + mi * 16 + g;
  float acc[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
  float4 lo[PREFETCH], hi[PREFETCH];
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d) {
    const int k = (s_lo + d) * 16 + 4 * tg;
    const int m = s_lo + d < s_hi ? M : 0;
    lo[d] = load4(a, lda, r, m, k, K, vec);
    hi[d] = load4(a, lda, r + 8, m, k, K, vec);
  }
  for (int s0 = s_lo; s0 < s_hi; s0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int s = s0 + d;
      if (s < s_hi) {
        const float4 l = lo[d], h = hi[d];
        if (s + PREFETCH < s_hi) {
          const int k = (s + PREFETCH) * 16 + 4 * tg;
          lo[d] = load4(a, lda, r, M, k, K, vec);
          hi[d] = load4(a, lda, r + 8, M, k, K, vec);
        }
        const uint32_t af[4] = {pack_bf16(l.x, l.y), pack_bf16(h.x, h.y),
                                pack_bf16(l.z, l.w), pack_bf16(h.z, h.w)};
        const uint2* wp = wres + (size_t)s * NI * 32;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[ni], af, L2 ? __ldcg(wp + ni * 32) : wp[ni * 32]);
      }
    }
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
    *reinterpret_cast<float4*>(part + (((ksw * MT + mi) * NI + ni) * 32 + lane) * 4) =
        make_float4(acc[ni][0], acc[ni][1], acc[ni][2], acc[ni][3]);
}
#define VAG_PRODUCT_PART product_part_bf16
#else
#define VAG_PRODUCT_PART product_part
#endif

// One row part of p against the weight slice w (product_part by its n8
// tiles).
template <bool L2>
__device__ __forceinline__ void product_tile(const Prod& p, const float* a, int lda,
                                             int M, int row0, const float* w,
                                             float* part) {
  const int NI = p.nt / 8;
  if (NI == 1) VAG_PRODUCT_PART<1, L2>(a, lda, M, p.K, p.rt, row0, w, part);
  else if (NI == 2) VAG_PRODUCT_PART<2, L2>(a, lda, M, p.K, p.rt, row0, w, part);
  else VAG_PRODUCT_PART<3, L2>(a, lda, M, p.K, p.rt, row0, w, part);
}

// One per-step product: for each of this CTA's column tiles and row
// parts, warp w takes m16 tile w % MT and k-slice w / MT (MT = rt / 16 m16
// tiles, KS = WARPS / MT k-slices, each a contiguous run of 16-deep slabs)
// against all NI n8 tiles of the tile's weight slice. Each lane loads its
// A fragments straight from L2 (load4), PREFETCH slabs ahead in registers:
// no shared-memory staging and no CTA barrier inside the product. The
// k-slices' accumulators go through `part` and epi(ct, row0, part, KS, MT,
// NI) applies the epilogue (tile_sum). Every thread of the CTA calls it
// (it syncs the CTA); CTAs outside p return. GENERAL: the kernel's plan
// gives some CTA several column tiles of a product or keeps some slices in
// L2; a kernel without it carries code for neither (one tile a CTA, its
// slice resident): the general instance is slower on such a plan
// (dec_scan_tune's probe "general kernel", PERF.md).
template <bool GENERAL, class Epi>
__device__ void product(const Prod& p, const float* a, int lda, int M,
                        float* smem, float* wl2, float* part, const Epi& epi) {
  const int slot = prod_slot(p);
  if (slot < 0) return;
  const int NI = p.nt / 8, MT = p.rt / 16, KS = WARPS / MT;
  const int parts = (M + p.rt - 1) / p.rt;
  const int passes = GENERAL ? col_passes(p) : 1;
  for (int k = 0; k < passes; ++k) {
    const int ct = slot + k * p.cs;
    if (GENERAL && ct >= p.col_tiles) break;
    for (int rp = ((int)blockIdx.x - p.cta0) % p.nr; rp < parts; rp += p.nr) {
      const int row0 = rp * p.rt;
      // the resident slice's pointer stays visibly in shared memory
      if (GENERAL && p.l2off >= 0)
        product_tile<true>(p, a, lda, M, row0, prod_slice(p, k, smem, wl2), part);
      else
        product_tile<false>(p, a, lda, M, row0, smem + p.woff + k * slice_floats(p), part);
      __syncthreads();
      epi(ct, row0, part, KS, MT, NI);
      __syncthreads();   // the next row part rewrites `part`
    }
  }
}

// One streamed product job: out (M, N) (+ batch * o_bs) = sum over its
// segments of A_s (M, K_s) @ B_s (K_s, N), A(m, k) = ta ? a[k * lda + m] :
// a[m * lda + k], B(k, n) = tb ? b[n * ldb + k] : b[k * ldb + n]; batch b
// offsets a, b and out by a_bs, b_bs, o_bs. Epilogue: store, or out =
// tanh(add + acc) (the forward's readout, add = ty).
enum JobEpi { STORE = 0, TANH_ADD = 1 };
struct Job {
  const float* a[2];
  const float* b[2];
  int lda[2], ldb[2], kd[2];
  int nseg, M, N, ta, tb, epi, batch;
  long long a_bs, b_bs, o_bs;
  float* out;
  int ldo;
  const float* add;
#if VAG_SCAN_BF16
  int obf;   // bf16 instances: out points at bf16 elements
#endif
};

__host__ __device__ inline int job_tiles(const Job& j) {
  return j.batch * ((j.M + GM - 1) / GM) * ((j.N + GN - 1) / GN);
}

// A chunk [k0, k0 + BK) of one operand tile: `rows` (the tile's M or N
// side, 64) by BK, from x (row stride ld) either [side][k] (trans == false
// for A, true for B: k contiguous) or [k][side] (side contiguous), into a
// [GM][TS] or [BK][GTS] stage; zero past side_n and ke.
__device__ __forceinline__ void stage_operand(float* st, const float* x, int ld,
                                              bool k_contig, int s0, int side_n,
                                              int k0, int ke, bool vec) {
  if (k_contig) {
    for (int i = threadIdx.x; i < GM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), k = k0 + (i % (BK / 4)) * 4;
      float* d = st + r * TS + (k - k0);
      if (vec) {
        const bool in = s0 + r < side_n && k < ke;
        cp_async16(d, in ? x + (size_t)(s0 + r) * ld + k : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = s0 + r < side_n && k + e < ke ? __ldcg(x + (size_t)(s0 + r) * ld + k + e) : 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < BK * (GM / 4); i += THREADS) {
      const int kk = i / (GM / 4), c = (i % (GM / 4)) * 4, k = k0 + kk;
      float* d = st + kk * GTS + c;
      if (vec) {
        const bool in = s0 + c < side_n && k < ke;
        cp_async16(d, in ? x + (size_t)k * ld + s0 + c : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = s0 + c + e < side_n && k < ke ? __ldcg(x + (size_t)k * ld + s0 + c + e) : 0.f;
      }
    }
  }
}

// One GM x GN tile of a job: 8 warps as 2 (rows) x 4 (columns) of 32 x 16,
// the segments' chunks through a GSTAGES-deep ring at smem.
template <bool TA, bool TB>
__device__ void job_tile(const Job& j, int bt, int m0, int n0, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  int nq[2] = {0, 0};
  bool va[2], vb[2];
  const float* ap[2];
  const float* bp[2];
  for (int s = 0; s < j.nseg; ++s) {
    nq[s] = (j.kd[s] + BK - 1) / BK;
    ap[s] = j.a[s] + bt * j.a_bs;
    bp[s] = j.b[s] + bt * j.b_bs;
    va[s] = j.lda[s] % 4 == 0 && al16(ap[s]) && (TA ? j.M : j.kd[s]) % 4 == 0;
    vb[s] = j.ldb[s] % 4 == 0 && al16(bp[s]) && (TB ? j.kd[s] : j.N) % 4 == 0;
  }
  const int n_chunks = nq[0] + nq[1];
  auto load = [&](int q, float* st) {
    const int s = q < nq[0] ? 0 : 1;
    const int k0 = (q - (s ? nq[0] : 0)) * BK;
    stage_operand(st, ap[s], j.lda[s], !TA, m0, j.M, k0, j.kd[s], va[s]);
    stage_operand(st + GM * TS, bp[s], j.ldb[s], TB, n0, j.N, k0, j.kd[s], vb[s]);
  };
  float acc[2][2][4], cor[2][2][4];   // big x big; the remainder products
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = cor[mi][ni][e] = 0.f;
#pragma unroll
  for (int q = 0; q < GSTAGES - 1; ++q) {
    if (q < n_chunks) load(q, smem + q * GSTAGE);
    cp_async_commit();
  }
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    const int qn = q + GSTAGES - 1;
    if (qn < n_chunks) load(qn, smem + (qn % GSTAGES) * GSTAGE);
    cp_async_commit();
    const float* as = smem + (q % GSTAGES) * GSTAGE;
    const float* bs = as + GM * TS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t ab[2][4], asl[2][4], bb[2][2], bsl[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = wm * 32 + mi * 16 + g, k = ks + tg;
        auto A = [&](int mm, int kk) { return TA ? as[kk * GTS + mm] : as[mm * TS + kk]; };
        split_tr(A(m, k), ab[mi][0], asl[mi][0]);
        split_tr(A(m + 8, k), ab[mi][1], asl[mi][1]);
        split_tr(A(m, k + 4), ab[mi][2], asl[mi][2]);
        split_tr(A(m + 8, k + 4), ab[mi][3], asl[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int n = wn * 16 + ni * 8 + g, k = ks + tg;
        auto Bv = [&](int kk, int nn) { return TB ? bs[nn * TS + kk] : bs[kk * GTS + nn]; };
        split_tr(Bv(k, n), bb[ni][0], bsl[ni][0]);
        split_tr(Bv(k + 4, n), bb[ni][1], bsl[ni][1]);
      }
      // in issue order: the two products into one cor stand 7 mma apart
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_tf32(cor[mi][ni], asl[mi], bb[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_tf32(acc[mi][ni], ab[mi], bb[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_tf32(cor[mi][ni], ab[mi], bsl[ni]);
    }
  }
  cp_async_wait<0>();
#if VAG_SCAN_BF16
  float* out = j.obf ? nullptr : j.out + bt * j.o_bs;
  __nv_bfloat16* outb = j.obf ? reinterpret_cast<__nv_bfloat16*>(j.out) + bt * j.o_bs : nullptr;
#else
  float* out = j.out + bt * j.o_bs;
#endif
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
        const int col = n0 + wn * 16 + ni * 8 + 2 * tg + (e & 1);
        if (row >= j.M || col >= j.N) continue;
        const size_t o = (size_t)row * j.ldo + col;
        const float v = acc[mi][ni][e] + cor[mi][ni][e];
#if VAG_SCAN_BF16
        if (j.obf) {
          stx(outb + o, v);
          continue;
        }
#endif
        out[o] = j.epi == TANH_ADD ? tanhf(__ldg(j.add + o) + v) : v;
      }
}

// Up to 7 jobs of one grid (a kernel argument).
struct Jobs {
  Job j[7];
  int n;
};

// The body of a grid of streamed-product tiles: one CTA a tile (tile i of
// the jobs in order), GSTAGES x GSTAGE floats of shared memory, several
// CTAs a SM; each output tile has one owner and a fixed sum order. Each
// kernel source wraps it in grids named after itself (the profiles sum a
// kernel's device time by name), launched by launch_jobs.
__device__ __forceinline__ void run_jobs(const Jobs& js) {
  extern __shared__ __align__(16) float smem[];
  int ji = 0, rest = blockIdx.x;
  while (rest >= job_tiles(js.j[ji])) rest -= job_tiles(js.j[ji++]);
  const Job& j = js.j[ji];
  const int mt = (j.M + GM - 1) / GM, nt = (j.N + GN - 1) / GN;
  const int bt = rest / (mt * nt), m0 = (rest / nt) % mt * GM, n0 = rest % nt * GN;
  if (j.ta && !j.tb) job_tile<true, false>(j, bt, m0, n0, smem);
  else if (!j.ta && j.tb) job_tile<false, true>(j, bt, m0, n0, smem);
  else job_tile<false, false>(j, bt, m0, n0, smem);
}

// Enqueues kern (a grid around run_jobs) over every tile of js on s.
inline cudaError_t launch_jobs(void (*kern)(Jobs), const Jobs& js, cudaStream_t s) {
  int tiles = 0;
  for (int i = 0; i < js.n; ++i) tiles += job_tiles(js.j[i]);
  if (tiles == 0) return cudaSuccess;
  const int smem = (int)sizeof(float) * GSTAGES * GSTAGE;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<tiles, THREADS, smem, s>>>(js);
  return cudaGetLastError();
}

// Backward through one GRU cell unit (no mask), term for term as
// ops/gru_kernel.py's gru_cell_bwd_plain: from the gate pre-activations x
// (input side) and hg (hidden side, biases added), the previous state h and
// the gradient dh of the new state, dxg = [da_r, da_z, da_n], dhg = [da_r,
// da_z, da_n r] and the carry's share dh z.
__device__ __forceinline__ float gru_unit_bwd(float xr, float xz, float xn,
                                              float hr, float hz, float hn,
                                              float h, float dh, float (&dx)[3],
                                              float (&dhg)[3]) {
  const float r = sigmoidf_(xr + hr);
  const float z = sigmoidf_(xz + hz);
  const float n = tanhf(xn + r * hn);
  const float dn = dh * (1.f - z);
  const float dz = dh * (h - n);
  const float da_n = dn * (1.f - n * n);
  const float dr = da_n * hn;
  const float da_r = dr * r * (1.f - r);
  const float da_z = dz * z * (1.f - z);
  dx[0] = da_r;
  dx[1] = da_z;
  dx[2] = da_n;
  dhg[0] = da_r;
  dhg[1] = da_z;
  dhg[2] = da_n * r;
  return dh * z;
}

// The same with the encoder scan's carry-through mask m (0 or 1; gru_bwd.cu),
// as gru_cell_bwd_plain with a mask: dh_cell = dh m drives the gates (so
// dxg = dhg = 0 at a masked step) and the carry's share is dh_cell z +
// dh (1 - m).
__device__ __forceinline__ float gru_unit_bwd_masked(float xr, float xz, float xn,
                                                     float hr, float hz, float hn,
                                                     float h, float dh, float m,
                                                     float (&dx)[3], float (&dhg)[3]) {
  return gru_unit_bwd(xr, xz, xn, hr, hz, hn, h, dh * m, dx, dhg) + dh * (1.f - m);
}

// Phase timing (chip_smoke.py's phase breakdown): thread 0 of CTA 0 writes
// the global timer (ns) to timers[i] at the grid's barriers, when timers is
// not null (the schedule is the same either way).
__device__ __forceinline__ void stamp(unsigned long long* timers, int i) {
  if (timers != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    timers[i] = ns;
  }
}

// Whether a plan needs the general instance of a persistent kernel (see
// product): a CTA with several column tiles of a product, or slices in L2.
inline bool plan_general(const Prod* p, int n, long long l2_floats) {
  bool general = l2_floats > 0;
  for (int i = 0; i < n; ++i) general |= p[i].cs < p[i].col_tiles;
  return general;
}

// The checks the C entries make of a plan (ops/dec_scan.py owns it): whole
// n8 tiles within NI_MAX, rt of 32 or 64, a gate tile's 3 ub columns inside
// it, between 1 and col_tiles column slots, a CTA range inside the grid,
// and the CTAs' slices before the scratch region in shared memory or
// inside the weight buffer of l2_floats floats.
inline bool prod_ok(const Prod& p, int ctas, int scratch_off, long long l2_floats) {
  if (p.nt < 8 || p.nt % 8 != 0 || p.nt / 8 > NI_MAX || (p.rt != 32 && p.rt != 64) ||
      p.nr < 1 || p.col_tiles < 1 || p.cs < 1 || p.cs > p.col_tiles)
    return false;
  const long long slices = (long long)col_passes(p) * slice_floats(p);
  return (p.ub == 0 || (p.ub >= 1 && 3 * p.ub <= p.nt &&
                        (long long)p.col_tiles * p.ub >= p.H)) &&
         (p.ub != 0 || (long long)p.col_tiles * p.nt >= p.cols) &&
         p.cta0 >= 0 && (long long)p.cta0 + (long long)p.cs * p.nr <= ctas &&
         (p.l2off < 0 ? p.woff >= 0 && p.woff % 4 == 0 && p.woff + slices <= scratch_off
                      : p.l2off % 4 == 0 &&
                            p.l2off + (long long)p.cs * p.nr * slices <= l2_floats);
}

// The attention phases: positions a warp scores at once, the columns (a
// multiple of 4) each of a row's P CTAs sums, and the shared floats of the
// forward's and the backward's row (ops/dec_scan.py's _att_floats).
constexpr int JB = ATT_BATCH / 4;
__host__ __device__ inline int att_cols(int C, int P) { return ((C + P - 1) / P + 3) / 4 * 4; }
inline int att_floats_fwd(int T, int A, int C, int P) {
  return 2 * ((A + 3) / 4 * 4) + 2 * ((T + 3) / 4 * 4) + 2 * att_cols(C, P);
}
inline int att_floats_bwd(int T, int A, int C) {
  return (C + 3) / 4 * 4 + 3 * ((T + 3) / 4 * 4) + 2 * ((A + 3) / 4 * 4);
}

// Shared memory a product's k-slices' accumulators take (in the region
// after the resident slices, which the attention phases share).
inline int prod_part_floats(const Prod& p) { return WARPS * (p.nt / 8) * 32 * 4; }

// Launches kern(args) as one cooperative grid of `ctas` CTAs of THREADS
// with smem_bytes of dynamic shared memory; refuses
// (cudaErrorCooperativeLaunchTooLarge) a grid that is not co-resident.
template <class Args>
int launch_cooperative(void (*kern)(Args), Args args, int ctas,
                       int smem_bytes, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                         smem_bytes)) != cudaSuccess)
    return (int)e;
  if ((long long)ctas > (long long)per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(ctas),
                                  dim3(THREADS), params, (size_t)smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace scan
}  // namespace vag
