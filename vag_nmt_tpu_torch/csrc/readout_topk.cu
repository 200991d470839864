// Fused readout GEMM -> per-row log-sum-exp + top-K, for Hopper (sm_90a),
// plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_readout_topk.py, _kernel (entry
// fused_readout_topk), the beam-search vocab step, at full slot depth K and
// in its shallow-slot watermark mode (slot depth SK < K, VAG_FRT_SLOTS).
//
// For each of R rows (R = sentences * beams) it computes, without writing
// the (R, V) logits to device memory:
//   logits = t @ W + b      (t (R, E), W (E, V) row-major, b (V,))
//   banned ids (optional (R, V) uint8 mask) floored to FLOOR = -3e38
//   vals/idx = top-K of the row's logits, ties to the smaller vocab id
//   lse      = log-sum-exp of the same (floored) logits
// The live/frozen candidate rules and the K*K -> K cross-beam combine stay
// in PyTorch (ops/readout_topk.py::_combine), as in the JAX package.
//
// Bound on this card: 2 R E V operations against R E + E V + V input
// floats, so bound by operations: at R=640, E=256 it is 2.62 GFLOP, ~39 us
// at the H100 SXM's 67 TFLOP/s fp32 outside the tensor cores and ~16 us as
// three TF32 products at 495 TFLOP/s, for V=8000 (twice that at V=16000).
// W (8.2 / 16.4 MB) stays resident in the 50 MB L2 across beam steps.
//
// Design: one grid of (row tiles of BM rows) x (vocab splits) CTAs of 512
// threads, one a SM; the split plan, the tiles and the lane map are
// ops/readout_topk.py's, passed here as -D defines.
//  The product runs on the tensor cores in 3xTF32: each operand is split
//    into a TF32 part and a TF32 remainder, both rounded to nearest with
//    ties away (cvt.rna's rounding, done on the bits: tf32_rna), and
//    a_small*b_big + a_big*b_small + a_big*b_big is summed with
//    mma.sync m16n8k8 into fp32 accumulators: about fp32's accuracy (one
//    TF32 pass keeps ~3 digits; the logits are held to 1e-5 relative).
//    Inputs whose TF32 remainders are 0 and whose sums are exact in fp32
//    (small integers, multiples of 1/512) give exact logits. wgmma takes
//    TF32 operands only K-major from shared memory, and W is V-major as the
//    B operand: wgmma needs a transposed copy of W (later work).
//  Operands: t and W both stream through a STAGES-deep ring of cp.async
//    copies, in BK-deep chunks of a BM x BN output tile (16-byte
//    cp.async.cg, zero-filled past R, E and the split's last column; 4-byte
//    copies where V or E is not a multiple of 4, since rows then start off
//    a 16-byte boundary). t is not kept resident, so any E fits; it is read
//    again for every column tile, which BN = 128 halves against 64. A stage
//    also carries the tile's biases with its last chunk.
//  The fold: the logits tile (its own region of shared memory) takes each
//    column tile's accumulators to the lane states. A lane is (split,
//    (col % 64) / 4): a thread folds 4 columns of every 64 of its split for
//    RPT rows, per element in this order: bias, ban floor, online (max,
//    sum-exp), running top-SK (insert<SK>, early reject against the SK-th
//    slot), watermark. The main loop takes no SK, so a depth-K call and a
//    shallow call see the same logits bit for bit; only the fold and the
//    merges are instantiated per SK (MAX_K kernels: the wrapper builds
//    this file twice, MAX_K = 8 for K <= 8 and MAX_K = 16 for K <= 16,
//    with the same tiling).
//  The merge: the CTA merges its lanes per row (top-K, max, sum-exp,
//    watermark) and writes them as its split's partials; then it takes an
//    arrival ticket on its row tile's counter, and the last CTA of the row
//    tile to arrive merges the splits in index order (never in arrival
//    order, so results repeat bit for bit), lse = M + log(sum s_i
//    exp(m_i - M)), and sets the counter back to 0. The counters are a
//    buffer per (device, stream), or per captured graph (ops/topk.py),
//    shared with kernels 6, 8 and 9 on that stream.
//
// The bf16 instances (t and W in bf16) are readout_topk_bf16.cu's, on
// wgmma and TMA, with this contract.
// Shallow slots (SK < K): a lane keeps SK slots, and its watermark is the
// largest value it pushed out of its last slot (its (SK+1)-th best). The
// merge flags a row (viol) iff the maximum watermark over its lanes and
// splits is >= the row's K-th value of the merged shallow union. A row that
// is not flagged has every value outside the union strictly below its K-th,
// so its vals/idx are those of depth K, bit for bit, and lse does not
// depend on SK at all.
// Passes (K > MAX_K, the MAX_K = 16 build): the candidates being ordered
// strictly and totally by (value desc, id asc), a row's top-K is ceil(K /
// 16) top-16s, pass p taking only the candidates strictly after the
// row's entry 16 p - 1 that pass p - 1 wrote (read back from vals/idx on
// the device). Each pass recomputes the GEMM (and the same lse): writing
// the (R, V) logits once for the later passes to scan would cost the
// beam-5 path's instance a store it does not need, and a pass costs what
// the K <= 16 call costs. At depth the after test sits in the fold; with
// shallow slots the lanes keep their unfiltered top-SK (so the union and
// the watermarks are those of one pass) and the test sits in the lane
// merge, and only the last pass flags rows and marks tiles, against the
// union's K-th entry. The recovery reruns the marked tiles in passes at
// depth.
// Per-step recovery (the TPU's per-step lax.cond, without a host read): the
// merge also marks each row tile holding a flagged LIVE row (a frozen row's
// outputs are discarded by _combine) and counts the flagged rows in a
// device counter; a second grid reruns the call at depth K, where CTAs of
// unmarked row tiles return at once, overwriting vals/idx/lse of the marked
// tiles (and counting the call when any tile was marked). A step with
// nothing flagged so pays one more grid that exits at once and a memset of
// the tile marks.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

// The wrapper (ops/readout_topk.py) owns the tiling that its split plan and
// lane map rely on and passes it here as -D defines when it builds this file.
#if !defined(VAG_BM) || !defined(VAG_BN) || !defined(VAG_BK) || \
    !defined(VAG_LANE_PERIOD) || !defined(VAG_CPT) || !defined(VAG_MAX_K)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_BM, VAG_BN, VAG_BK, VAG_LANE_PERIOD, VAG_CPT, VAG_MAX_K)"
#endif

constexpr float FLOOR = -3.0e38f;
constexpr int BM = VAG_BM;             // rows per CTA (64)
constexpr int BN = VAG_BN;             // columns of an output tile (128)
constexpr int LP = VAG_LANE_PERIOD;    // columns of one lane period (64)
constexpr int CPT = VAG_CPT;           // columns of a lane per period (4)
constexpr int MAX_K = VAG_MAX_K;
constexpr int BK = VAG_BK;             // depth of a staged chunk (64)
constexpr int STAGES = 3;              // the cp.async ring (193 KB with the rest)
constexpr int THREADS = 512;
constexpr int WARPS_M = 2, WARPS_N = 8;            // warp grid over BM x BN
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 32 x 16 a warp
constexpr int MI = WM / 16, NI = WN / 8;           // m16n8 tiles a warp
constexpr int TX = LP / CPT;                       // 16 lanes a row a split
constexpr int RPT = BM / (THREADS / TX);           // 2 rows a thread
constexpr int HALVES = BN / LP;                    // lane periods a tile
// The staged operands' type (fp32), and the elements of one 16-byte copy.
typedef float op_t;
constexpr int VEC = 16 / (int)sizeof(op_t);
// Shared-memory row strides (elements), padded so that the fragment loads
// and the accumulator stores hit 32 distinct banks, and every row starts
// on a 16-byte boundary.
constexpr int TS = BK + VEC;           // t chunk [BM][TS]
constexpr int WS = BN + 8;             // W chunk [BK][WS]
constexpr int LS = BN + 8;             // logits tile [BM][LS] (floats)
// A stage: the t chunk, the W chunk and, with a tile's last chunk, the
// tile's BN fp32 biases (read by the fold before the stage is refilled).
constexpr int OPS_BYTES = (int)sizeof(op_t) * (BM * TS + BK * WS);
constexpr int STAGE_FLOATS = OPS_BYTES / 4 + BN;
constexpr size_t SMEM_BYTES = sizeof(float) * ((size_t)STAGES * STAGE_FLOATS + BM * LS);

static_assert(WARPS_M * WARPS_N * 32 == THREADS, "one warp per warp tile");
static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % (2 * VEC) == 0, "whole mma tiles");
static_assert(OPS_BYTES % 16 == 0, "the biases on a 16-byte boundary");
static_assert(CPT == 4 && LP % CPT == 0 && BN % LP == 0, "lanes: float4 of a period");
static_assert(THREADS % TX == 0 && BM % (THREADS / TX) == 0, "fold: whole rows");
static_assert(BM <= THREADS, "merge: one thread a row");
static_assert(SMEM_BYTES <= 232448, "227 KB a block");
// The lane merge reuses the ring: BM x TX lanes of MAX_K (value, id) and
// (max, sum, watermark).
static_assert((size_t)BM * TX * (2 * MAX_K + 3) <= (size_t)STAGES * STAGE_FLOATS,
              "lane merge fits in the ring");

using vag::better;
using vag::cp_async16;
using vag::cp_async4;
using vag::cp_async_commit;
using vag::cp_async_wait;
using vag::insert;
using vag::mma_tf32;
using vag::split_tf32;

struct Params {
  const op_t *t, *w;
  const float* b;
  const uint8_t* ban;
  const uint8_t* live;          // per-step recovery: flagged live rows mark
  uint8_t* tile_mark;           // (row tiles,) recovery marks
  unsigned long long* counts;   // (2,) flagged live rows, recovering calls
  float *part_v, *part_m, *part_s, *part_w;
  int* part_i;
  unsigned int* arrivals;       // (row tiles,) zero between launches
  float *vals, *lse;
  float* lse_parts;             // (R, 2) the row's max and sum of exp(x - max), or null
  int *idx, *viol;
  int R, E, V, K, n_split, split_cols;
  int vec_t, vec_w, vec_b;      // 16-byte copies of t rows / W rows / b
  int shallow;                  // SK < K: watermark, viol (and marks)
  int rerun;                    // the recovery's depth-K rerun
  int kout, kofs;               // passes: vals/idx row stride, this pass's first entry
  int id_base;                  // added to the ids written to idx (a vocab slice's v0)
};

// An id as idx holds it (the vocab slice's base added) and back; INT_MAX,
// an empty slot, stays INT_MAX.
__device__ __forceinline__ int id_out(int i, int base) {
  return i == INT_MAX ? INT_MAX : i + base;
}
__device__ __forceinline__ int id_in(int i, int base) {
  return i == INT_MAX ? INT_MAX : i - base;
}

// One element of a row that is off a 16-byte boundary: a 4-byte
// cp.async.
// base: any valid address, read from when the element is outside.
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      const float* base, bool in) {
  cp_async4(dst, in ? src : base, in ? 4 : 0);
}

// The tile's biases in stage `st`, after its t and W chunks.
__device__ __forceinline__ float* stage_bias(float* st) {
  return reinterpret_cast<float*>(reinterpret_cast<char*>(st) + OPS_BYTES);
}

// Copies chunk q (column tile q / kc_n, depth chunk q % kc_n) of the CTA's
// t rows and W columns into ring stage `st`, zero-filled outside.
__device__ __forceinline__ void load_chunk(const Params& p, float* st, int q,
                                           int kc_n, int row0, int col_begin,
                                           int col_end) {
  const int tid = threadIdx.x;
  const int c0 = col_begin + (q / kc_n) * BN;
  const int e0 = (q % kc_n) * BK;
  op_t* ts = reinterpret_cast<op_t*>(st);
  op_t* ws = ts + BM * TS;
  for (int i = tid; i < BM * (BK / VEC); i += THREADS) {
    const int r = i / (BK / VEC), e = e0 + (i % (BK / VEC)) * VEC;
    const int row = row0 + r;
    op_t* dst = ts + r * TS + (e - e0);
    if (p.vec_t) {
      const bool in = row < p.R && e < p.E;
      cp_async16(reinterpret_cast<float*>(dst),
                 reinterpret_cast<const float*>(in ? p.t + (size_t)row * p.E + e : p.t),
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool in = row < p.R && e + j < p.E;
        copy1(dst + j, p.t + (size_t)row * p.E + e + j, p.t, in);
      }
    }
  }
  for (int i = tid; i < BK * (BN / VEC); i += THREADS) {
    const int k = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
    const int e = e0 + k, col = c0 + c;
    op_t* dst = ws + k * WS + c;
    if (p.vec_w) {  // V % VEC == 0, so col_end is too: VEC columns in or out
      const bool in = e < p.E && col < col_end;
      cp_async16(reinterpret_cast<float*>(dst),
                 reinterpret_cast<const float*>(in ? p.w + (size_t)e * p.V + col : p.w),
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool in = e < p.E && col + j < col_end;
        copy1(dst + j, p.w + (size_t)e * p.V + col + j, p.w, in);
      }
    }
  }
  if (q % kc_n == kc_n - 1 && tid < BN / 4) {
    const int col = c0 + tid * 4;
    const int n = max(0, min(4, col_end - col));   // the rest zero-filled
    float* dst = stage_bias(st) + tid * 4;
    if (p.vec_b) {
      cp_async16(dst, n ? p.b + col : p.b, 4 * n);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(dst + j, j < n ? p.b + col + j : p.b, j < n ? 4 : 0);
    }
  }
}

// acc += the 3xTF32 product of one staged chunk, for this warp's WM x WN.
__device__ __forceinline__ void mma_chunk(const float* st, float (&acc)[MI][NI][4],
                                          int wm, int wn, int g, int tg) {
  const float* ts = st;
  const float* ws = st + BM * TS;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 8) {
    uint32_t ab[MI][4], as[MI][4], bb[NI][2], bs[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* a = ts + (wm * WM + mi * 16 + g) * TS + ks + tg;
      split_tf32(a[0], ab[mi][0], as[mi][0]);
      split_tf32(a[8 * TS], ab[mi][1], as[mi][1]);
      split_tf32(a[4], ab[mi][2], as[mi][2]);
      split_tf32(a[8 * TS + 4], ab[mi][3], as[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float* b = ws + (ks + tg) * WS + wn * WN + ni * 8 + g;
      split_tf32(b[0], bb[ni][0], bs[ni][0]);
      split_tf32(b[4 * WS], bb[ni][1], bs[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        mma_tf32(acc[mi][ni], as[mi], bb[ni]);
        mma_tf32(acc[mi][ni], ab[mi], bs[ni]);
        mma_tf32(acc[mi][ni], ab[mi], bb[ni]);
      }
  }
}


// The K-th entry of a sorted list (K at run time, the list in registers).
__device__ __forceinline__ float kth(const float (&bv)[MAX_K], int K) {
  float x = bv[0];
#pragma unroll
  for (int k = 1; k < MAX_K; ++k)
    if (k == K - 1) x = bv[k];
  return x;
}

// PASS: one pass of K > MAX_K (the head of this file): lists MAX_K wide
// (p.K), entries [kofs, kofs + MAX_K) of each row's top-K written at row
// stride kout, only candidates strictly after the row's entry kofs - 1
// taken (in the fold at depth, in the lane merge with shallow slots), the
// flags of the last pass alone.
template <int SK, bool PASS>
__global__ void __launch_bounds__(THREADS, 1)
readout_topk_kernel(const Params p) {
  static_assert(1 <= SK && SK <= MAX_K, "slot depth 1..MAX_K");
  const int tid = threadIdx.x;
  const int kout = PASS ? p.kout : p.K, kofs = PASS ? p.kofs : 0;
  const bool filt = PASS && kofs > 0;
  const bool last_pass = !PASS || kofs + p.K >= kout;
  const int tile = blockIdx.x;
  if (p.rerun) {
    if (tile == 0 && blockIdx.y == 0 && tid == 0 && kofs == 0) {
      int any = 0;
      for (int i = 0; i < gridDim.x; ++i) any |= p.tile_mark[i];
      if (any) atomicAdd(&p.counts[1], 1ull);
    }
    if (p.tile_mark[tile] == 0) return;   // every CTA of the row tile
  }
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                               // [STAGES][STAGE_FLOATS]
  float* lg = smem + (size_t)STAGES * STAGE_FLOATS;  // [BM][LS]
  __shared__ bool last;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int row0 = tile * BM;
  const int col_begin = blockIdx.y * p.split_cols;
  const int col_end = min(p.V, col_begin + p.split_cols);
  const int kc_n = (p.E + BK - 1) / BK;
  const int n_ct = col_end > col_begin ? (col_end - col_begin + BN - 1) / BN : 0;
  const int n_q = n_ct * kc_n;

  // fold: thread (rq, gq) keeps lane gq of rows rq + (THREADS / TX) r
  const int gq = tid % TX, rq = tid / TX;
  float sv[RPT][SK], m[RPT], s[RPT], wmark[RPT];
  int si[RPT][SK];
  float key_v[RPT];   // PASS at depth: the rows' keys
  int key_i[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (PASS) {
      const int row = min(row0 + rq + r * (THREADS / TX), p.R - 1);
      key_v[r] = filt ? __ldcg(p.vals + (size_t)row * kout + kofs - 1) : 0.f;
      key_i[r] = filt ? id_in(__ldcg(p.idx + (size_t)row * kout + kofs - 1), p.id_base)
                      : 0;
    }
    m[r] = FLOOR;
    s[r] = 0.f;
    wmark[r] = FLOOR;
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      sv[r][k] = FLOOR;
      si[r][k] = INT_MAX;
    }
  }

#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < n_q)
      load_chunk(p, ring + q * STAGE_FLOATS, q, kc_n, row0, col_begin, col_end);
    cp_async_commit();
  }

  float acc[MI][NI][4];
  for (int q = 0; q < n_q; ++q) {
    const int kc = q % kc_n;
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk q landed; chunk q - 1's stage consumed
    const int qn = q + STAGES - 1;
    if (qn < n_q)
      load_chunk(p, ring + (qn % STAGES) * STAGE_FLOATS, qn, kc_n, row0, col_begin,
                 col_end);
    cp_async_commit();
    mma_chunk(ring + (q % STAGES) * STAGE_FLOATS, acc, wm, wn, g, tg);
    if (kc != kc_n - 1) continue;

    // The tile's logits (without bias) through shared memory ...
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int r = wm * WM + mi * 16 + g, c = wn * WN + ni * 8 + 2 * tg;
        *reinterpret_cast<float2*>(&lg[r * LS + c]) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(&lg[(r + 8) * LS + c]) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    __syncthreads();
    // ... into the lane states, CPT columns at a time in column order.
    const int c0 = col_begin + (q / kc_n) * BN;
    const float* bias = stage_bias(ring + (q % STAGES) * STAGE_FLOATS);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int lr = rq + r * (THREADS / TX);
      const int row = row0 + lr;
      if (row >= p.R) continue;
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const int cl = h * LP + gq * CPT;
        const float4 a4 = *reinterpret_cast<const float4*>(&lg[lr * LS + cl]);
        const float4 b4 = *reinterpret_cast<const float4*>(&bias[cl]);
        const float av[CPT] = {a4.x, a4.y, a4.z, a4.w};
        const float bv4[CPT] = {b4.x, b4.y, b4.z, b4.w};
        float x[CPT];
        float tmax = FLOOR;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = c0 + cl + j;
          x[j] = FLOOR;
          if (col < col_end) {
            x[j] = __fadd_rn(av[j], bv4[j]);
            if (p.ban != nullptr && p.ban[(size_t)row * p.V + col]) x[j] = FLOOR;
            tmax = fmaxf(tmax, x[j]);
          }
        }
        const float m_new = fmaxf(m[r], tmax);
        float acc_s = __fmul_rn(s[r], expf(m[r] - m_new));
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = c0 + cl + j;
          if (col < col_end) {
            acc_s = __fadd_rn(acc_s, expf(x[j] - m_new));
            const bool in = !filt || p.shallow || better(key_v[r], key_i[r], x[j], col);
            const float out = in && better(x[j], col, sv[r][SK - 1], si[r][SK - 1])
                                  ? insert<SK>(sv[r], si[r], x[j], col) : x[j];
            wmark[r] = fmaxf(wmark[r], out);
          }
        }
        m[r] = m_new;
        s[r] = acc_s;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the lane merge reuses it

  // The CTA's lanes of each row -> its split's partials.
  float* cv = ring;                                          // [BM][TX][SK]
  int* ci = reinterpret_cast<int*>(cv + BM * TX * SK);       // [BM][TX][SK]
  float* cm = reinterpret_cast<float*>(ci + BM * TX * SK);   // [BM][TX] x 3
  float* cs = cm + BM * TX;
  float* cw = cs + BM * TX;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lr = rq + r * (THREADS / TX);
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      cv[(lr * TX + gq) * SK + k] = sv[r][k];
      ci[(lr * TX + gq) * SK + k] = si[r][k];
    }
    cm[lr * TX + gq] = m[r];
    cs[lr * TX + gq] = s[r];
    cw[lr * TX + gq] = wmark[r];
  }
  __syncthreads();
  const int row = row0 + tid;
  const bool mine = tid < BM && row < p.R;
  if (mine) {
    float bv[MAX_K];
    int bi[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      bv[k] = FLOOR;
      bi[k] = INT_MAX;
    }
    float M = FLOOR, W = FLOOR;
    float rv = 0.f;   // PASS: the row's key
    int ri = 0;
    if (filt) {
      rv = __ldcg(p.vals + (size_t)row * kout + kofs - 1);
      ri = id_in(__ldcg(p.idx + (size_t)row * kout + kofs - 1), p.id_base);
    }
    for (int j = 0; j < TX; ++j) {
#pragma unroll
      for (int k = 0; k < SK; ++k) {
        const float x = cv[(tid * TX + j) * SK + k];
        const int xi = ci[(tid * TX + j) * SK + k];
        if ((!filt || better(rv, ri, x, xi)) &&
            better(x, xi, bv[MAX_K - 1], bi[MAX_K - 1]))
          insert<MAX_K>(bv, bi, x, xi);
      }
      M = fmaxf(M, cm[tid * TX + j]);
      W = fmaxf(W, cw[tid * TX + j]);
    }
    float S = 0.f;
    for (int j = 0; j < TX; ++j)
      S = __fadd_rn(S, __fmul_rn(cs[tid * TX + j], expf(cm[tid * TX + j] - M)));
    const size_t o = (size_t)blockIdx.y * p.R + row;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < p.K) {
        p.part_v[o * p.K + k] = bv[k];
        p.part_i[o * p.K + k] = bi[k];
      }
    p.part_m[o] = M;
    p.part_s[o] = S;
    if (p.shallow) p.part_w[o] = W;
    __threadfence();  // the partials, before the ticket
  }
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&p.arrivals[tile], 1u) == (unsigned int)(p.n_split - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last CTA of the row tile: the splits in index order.
  if (mine) {
    float bv[MAX_K];
    int bi[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      bv[k] = FLOOR;
      bi[k] = INT_MAX;
    }
    float M = FLOOR, W = FLOOR;
    for (int sp = 0; sp < p.n_split; ++sp) {
      const size_t o = (size_t)sp * p.R + row;
      for (int k = 0; k < p.K; ++k) {
        const float x = __ldcg(p.part_v + o * p.K + k);
        const int xi = __ldcg(p.part_i + o * p.K + k);
        if (better(x, xi, bv[MAX_K - 1], bi[MAX_K - 1])) insert<MAX_K>(bv, bi, x, xi);
      }
      M = fmaxf(M, __ldcg(p.part_m + o));
      if (p.shallow) W = fmaxf(W, __ldcg(p.part_w + o));
    }
    float S = 0.f;
    for (int sp = 0; sp < p.n_split; ++sp) {
      const size_t o = (size_t)sp * p.R + row;
      S = __fadd_rn(S, __fmul_rn(__ldcg(p.part_s + o), expf(__ldcg(p.part_m + o) - M)));
    }
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < p.K && kofs + k < kout) {
        p.vals[(size_t)row * kout + kofs + k] = bv[k];
        p.idx[(size_t)row * kout + kofs + k] = id_out(bi[k], p.id_base);
      }
    p.lse[row] = M + logf(S);
    if (p.lse_parts != nullptr) {
      p.lse_parts[2 * (size_t)row] = M;
      p.lse_parts[2 * (size_t)row + 1] = S;
    }
    if (p.shallow && last_pass) {
      const int flag = W >= kth(bv, kout - kofs) ? 1 : 0;
      p.viol[row] = flag;
      if (flag && p.live != nullptr && p.live[row]) {
        p.tile_mark[tile] = 1;
        atomicAdd(&p.counts[0], 1ull);
      }
    }
  }
  if (tid == 0) p.arrivals[tile] = 0;   // ready for the next launch
}

template <int SK, bool PASS = false>
cudaError_t grid(const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      readout_topk_kernel<SK, PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 g((p.R + BM - 1) / BM, p.n_split);
  readout_topk_kernel<SK, PASS><<<g, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t grid_sk(const Params& p, int sk, cudaStream_t stream) {
  switch (sk) {
    case 1: return grid<1>(p, stream);
    case 2: return grid<2>(p, stream);
    case 3: return grid<3>(p, stream);
    case 4: return grid<4>(p, stream);
    case 5: return grid<5>(p, stream);
    case 6: return grid<6>(p, stream);
    case 7: return grid<7>(p, stream);
    case 8: return grid<8>(p, stream);
#if VAG_MAX_K > 8
    case 9: return grid<9>(p, stream);
    case 10: return grid<10>(p, stream);
    case 11: return grid<11>(p, stream);
    case 12: return grid<12>(p, stream);
    case 13: return grid<13>(p, stream);
    case 14: return grid<14>(p, stream);
    case 15: return grid<15>(p, stream);
    case 16: return grid<16>(p, stream);
#endif
    default: return cudaErrorInvalidValue;
  }
}

#if VAG_MAX_K > 8
// A pass's grid: slot depth sk with shallow slots, else MAX_K (filtered).
cudaError_t grid_pass(const Params& p, int sk, cudaStream_t stream) {
  switch (sk) {
    case 1: return grid<1, true>(p, stream);
    case 2: return grid<2, true>(p, stream);
    case 3: return grid<3, true>(p, stream);
    case 4: return grid<4, true>(p, stream);
    case 5: return grid<5, true>(p, stream);
    case 6: return grid<6, true>(p, stream);
    case 7: return grid<7, true>(p, stream);
    case 8: return grid<8, true>(p, stream);
    case 9: return grid<9, true>(p, stream);
    case 10: return grid<10, true>(p, stream);
    case 11: return grid<11, true>(p, stream);
    case 12: return grid<12, true>(p, stream);
    case 13: return grid<13, true>(p, stream);
    case 14: return grid<14, true>(p, stream);
    case 15: return grid<15, true>(p, stream);
    case 16: return grid<16, true>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}
#endif

}  // namespace

// Device pointers to contiguous tensors: t (R, E) f32, w (E, V) f32,
// b (V,) f32, ban (R, V) uint8 or null; partials part_v/part_i (n_split, R,
// K), part_m/part_s (n_split, R); arrivals (ceil(R / BM),) u32, zero (and
// left zero); outputs vals (R, K) f32, idx (R, K) i32, lse (R,) f32 and,
// where lse_parts is not null, (R, 2) f32: the terms of lse = M + log(S),
// M and S (for a caller that merges the lse of several vocab slices as
// the last CTA merges the splits).
// split_cols is a multiple of BN and n_split * split_cols >= V. id_base
// (>= 0, id_base + V <= INT_MAX) is added to every id written to idx: W
// holds columns id_base.. of a larger vocab (a slice under tensor
// parallelism); the partials keep the slice's own ids.
// 1 <= SK <= K <= MAX_K, or (the MAX_K = 16 build) K > MAX_K in passes
// with K <= V, SK == K or SK <= MAX_K, partials MAX_K wide and one grid a
// pass (two with the recovery). With SK < K also part_w (n_split, R) f32 and the
// output viol (R,) i32; for the per-step recovery live (R,) uint8,
// tile_mark (ceil(R / BM),) uint8 scratch and counts (2,) int64 (flagged
// live rows, recovering calls; added to), else null.
// Enqueues one grid, or with the recovery a memset and two grids. Returns
// 0 or a CUDA error code.
extern "C" int readout_topk_launch(const void* t, const void* w, const void* b,
                                   const void* ban, void* part_v, void* part_i,
                                   void* part_m, void* part_s, void* part_w,
                                   void* arrivals, void* vals, void* idx,
                                   void* lse, void* lse_parts, void* viol,
                                   const void* live,
                                   void* tile_mark, void* counts, int R,
                                   int E, int V, int K, int SK, int n_split,
                                   int split_cols, int id_base, void* stream) {
  const bool passes = K > MAX_K;
#if VAG_MAX_K == 8
  if (passes) return (int)cudaErrorInvalidValue;   // the MAX_K = 16 build's
#endif
  if (R < 1 || E < 1 || V < 1 || K < 1 || K > V || SK < 1 || SK > K ||
      (passes && SK < K && SK > MAX_K) || (!passes && K > MAX_K) ||
      split_cols % BN != 0 || (long long)n_split * split_cols < V ||
      (long long)(n_split - 1) * split_cols >= V || arrivals == nullptr)
    return (int)cudaErrorInvalidValue;
  if (SK < K && (part_w == nullptr || viol == nullptr ||
                 (live != nullptr && (tile_mark == nullptr || counts == nullptr))))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.t = static_cast<const op_t*>(t);
  p.w = static_cast<const op_t*>(w);
  p.b = static_cast<const float*>(b);
  p.ban = static_cast<const uint8_t*>(ban);
  p.live = SK < K ? static_cast<const uint8_t*>(live) : nullptr;
  p.tile_mark = static_cast<uint8_t*>(tile_mark);
  p.counts = static_cast<unsigned long long*>(counts);
  p.part_v = static_cast<float*>(part_v);
  p.part_i = static_cast<int*>(part_i);
  p.part_m = static_cast<float*>(part_m);
  p.part_s = static_cast<float*>(part_s);
  p.part_w = static_cast<float*>(part_w);
  p.arrivals = static_cast<unsigned int*>(arrivals);
  p.vals = static_cast<float*>(vals);
  p.idx = static_cast<int*>(idx);
  p.lse = static_cast<float*>(lse);
  p.lse_parts = static_cast<float*>(lse_parts);
  p.viol = static_cast<int*>(viol);
  p.R = R;
  p.E = E;
  p.V = V;
  p.K = K;
  p.n_split = n_split;
  p.split_cols = split_cols;
  p.vec_t = E % VEC == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  p.vec_w = V % VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.vec_b = reinterpret_cast<uintptr_t>(b) % 16 == 0;
  p.shallow = SK < K;
  p.rerun = 0;
  p.kout = K;
  p.kofs = 0;
  p.id_base = id_base;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool recover = p.live != nullptr;
  if (recover)
    VAG_CHECK(cudaMemsetAsync(p.tile_mark, 0, (R + BM - 1) / BM, st));
  if (!passes) {
    VAG_CHECK(grid_sk(p, SK, st));
    if (recover) {
      Params d = p;              // depth K on the marked row tiles
      d.shallow = 0;
      d.live = nullptr;
      d.rerun = 1;
      VAG_CHECK(grid_sk(d, K, st));
    }
    return 0;
  }
#if VAG_MAX_K > 8
  // K > MAX_K: ceil(K / MAX_K) passes (part_v / part_i MAX_K wide), the
  // recovery's rerun in passes at depth too.
  p.K = MAX_K;
  for (int kofs = 0; kofs < K; kofs += MAX_K) {
    p.kofs = kofs;
    VAG_CHECK(grid_pass(p, p.shallow ? SK : MAX_K, st));
  }
  if (recover) {
    Params d = p;
    d.shallow = 0;
    d.live = nullptr;
    d.rerun = 1;
    for (int kofs = 0; kofs < K; kofs += MAX_K) {
      d.kofs = kofs;
      VAG_CHECK(grid_pass(d, MAX_K, st));
    }
  }
#endif
  return 0;
}

// Two instances (ops/readout_topk.py): MAX_K = 8 for K <= 8, the beam-5
// path's, and MAX_K = 16 for K > 8 (above 16 in passes).
static_assert(MAX_K == 8 || MAX_K == 16, "grid_sk instantiates 1 <= SK <= MAX_K");
