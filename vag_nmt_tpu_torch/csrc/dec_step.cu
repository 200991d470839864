// Fused beam decode step, GRU1 -> attention -> GRU2 -> readout activations,
// for Hopper (sm_90a), plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_dec_step.py, _kernel (entry
// pallas_decode_step), the mid-section of the tabled beam step with
// VAG_DEC_STEP=on. For N = B*K beam rows (K beams per sentence, row
// n = b*K + k), from the gathered table rows gy = [xg1 | ty] and the state s:
//   s~  = GRU1(xg1, hg1 = s @ uh1 + bh1, s)
//   qh  = s~ @ w_s                      (w_s = [ua | uh2]: q | GRU2 h-gates)
//   e   = tanh(ctxpb[b] + q)            (ctxpb = ctx_proj + ba, folded outside)
//   w   = softmax over source positions of (e . va), masked to -1e9
//   c   = sum_j w[j] ctx[b, j]
//   xc  = c @ w_c                       (w_c = [wi2 | wc]: GRU2 x-gates | tc)
//   s'  = GRU2(xc[:3H] + bi2, qh[A:] + bh2, s~)
//   t   = tanh(((ty + s' @ ws) + xc[3H:]) + b)
//
// Bound on this card at B=128, K=5, T=32, full width (H=A=512, C=1024,
// R=256): the four products are 2*640*(512*1536 + 512*2048 + 1024*1792 +
// 512*256) = 4.87 GFLOP, run here as three TF32 products each (3xTF32):
// 14.6 GFLOP at the tensor cores' 495 TFLOP/s, ~30 us; the attention,
// 0.084 GFLOP on the fp32 cores at 67 TFLOP/s, ~1.3 us; ~45 MB of inputs,
// ~13 us at 3.35 TB/s: bound by operations, ~0.031 ms.
//
// Design. The TPU kernel holds every weight in VMEM for a sentence tile
// (15.2 MB fp32 at m30k's widths); one SM holds 227 KB, and q, GRU2 and the
// readout each need whole rows of the stage before. So the step is one C
// entry that enqueues five grids on the caller's stream, the stream's order
// being the barrier between them:
//   1. s @ uh1 with GRU1 in its epilogue: writes s~;
//   2. s~ @ w_s: writes qh;
//   3. the attention, a cluster of CTAs per sentence: writes c;
//   4. c @ w_c with GRU2 in its epilogue (and the tc columns): writes s', tc;
//   5. s' @ ws, split over its depth, the readout in the merge: writes t.
// The products run on the tensor cores in 3xTF32 (tf32_mma.cuh, as
// readout_topk.cu): each operand is split into a TF32 part and a TF32
// remainder, and a_small*b_big + a_big*b_small + a_big*b_big is summed by
// mma.sync m16n8k8 into fp32 accumulators, about fp32's accuracy. A CTA of
// 128 threads (2 x 2 warps) owns BM rows and a tile of columns and streams
// BK-deep chunks of its A rows and of the weight columns through a
// STAGES-deep ring of cp.async copies (16 bytes where rows start on 16-byte
// boundaries, else 4; zero-filled outside). The weights stay row-major
// (in, out): mma.sync builds its B fragments from shared memory, so no
// transposed copy is needed.
//   A gate tile covers a block of UB hidden units with all three of their
// gate columns (u, H + u, 2H + u of uh1 or w_c), so the tile's accumulators
// hold every pre-activation of its units' GRU cell (the idea of
// gru_fwd.cu's unit blocks): the epilogue, from the accumulators staged in
// shared memory, adds the biases and applies the gate algebra in
// dec_step_plain's order, and the gate pre-activations never reach device
// memory. GRU2's grid also has plain tiles over w_c's last R columns (tc).
// An epilogue's other operands (gate rows of gy or qh, state rows, ty, tc)
// are copied into shared memory with the first chunk, so they land while
// the products run. Narrow unit blocks (UB = 16: 320 and 380 CTAs of 64 x
// 48 at the serving shape) spread the work over the 132 SMs more evenly
// than wide ones, at the price of more L2 reads of the a rows.
//   The last product has only R columns: it is split over its depth into
// SPLIT parts, the SPLIT CTAs of a tile launched as one thread-block
// cluster. Each keeps its partial tile in shared memory; after the
// cluster's barrier each CTA adds BM / SPLIT of the tile's rows from all
// of them through distributed shared memory, in split order, so results
// repeat bit for bit, and applies the readout: no partials in device
// memory, no arrival counters.
//   The attention takes one sentence per cluster of ATT_CLUSTER CTAs with
// its K beams inside: ctx and ctx_proj are read once per sentence, the
// scores are shared through distributed shared memory, and each thread
// sums one ctx column for all K beams at once (above 16 beams, in groups
// of 16: once a group).
//   The energies' tanh is tanh_fast (the fast exponential and division,
// absolute error <= 4.8e-7 by their documented bounds), the rest of the
// arithmetic is dec_step_plain's.
// The bf16 instances (the bf16 decode's states, ctx and matrices) are
// dec_step_bf16.cu's, on wgmma and TMA, with this contract.
// The tiling is ops/dec_step.py's dec_step_plan: its constants (BM, BK,
// UB, BN, RN, SPLIT, STAGES, ATT_CLUSTER) come as -D defines, its tile
// counts and split depth as dec_step_launch's arguments. Ragged widths and
// batch are masked at any size: the TPU's shape envelope and its batch
// padding to a multiple of 8 are not carried over.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

#if !defined(VAG_MAX_K) || !defined(VAG_BM) || !defined(VAG_BK) || \
    !defined(VAG_UB) || !defined(VAG_BN) || !defined(VAG_RN) ||    \
    !defined(VAG_SPLIT) || !defined(VAG_STAGES) || !defined(VAG_ATT_CLUSTER)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_MAX_K, VAG_BM, VAG_BK, VAG_UB, VAG_BN, VAG_RN, VAG_SPLIT, VAG_STAGES, VAG_ATT_CLUSTER)"
#endif

constexpr int MAX_K = VAG_MAX_K;
constexpr int BM = VAG_BM;          // rows of a product tile (64)
constexpr int BK = VAG_BK;          // depth of a staged chunk (32)
constexpr int UB = VAG_UB;          // hidden units of a gate tile (16)
constexpr int GT = 3 * UB;          // columns of a gate tile
constexpr int BN = VAG_BN;          // columns of a qh tile (80)
constexpr int RN = VAG_RN;          // columns of a readout tile (32)
constexpr int SPLIT = VAG_SPLIT;    // depth splits of the last product
constexpr int STAGES = VAG_STAGES;  // the cp.async ring
constexpr int THREADS = 128;
constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int WM = BM / WARPS_M;    // rows of a warp tile
constexpr int MI = WM / 16;         // m16n8 row tiles of a warp
// The products' operands (and the states, ctx and c), fp32; VEC of them
// make a 16-byte copy.
typedef float op_t;
__device__ __forceinline__ float ldf(float x) { return x; }
__device__ __forceinline__ float to_op(float x) { return x; }
constexpr int VEC = 16 / (int)sizeof(op_t);
constexpr int TS = BK + VEC;        // A chunk row stride (elements)
constexpr int ATT_CLUSTER = VAG_ATT_CLUSTER;  // CTAs of a sentence (4)
constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_BATCH = 8;        // ctx_proj loads a lane keeps in flight
constexpr float NEG_INF = -1e9f;   // as ops/attention.masked_softmax

static_assert(MAX_K == 8 || MAX_K == 16,
              "two instances (ops/dec_step.py): K <= 8 and K > 8");
static_assert(WARPS_M * WARPS_N * 32 == THREADS, "one warp per warp tile");
static_assert(WM % 16 == 0 && BK % (2 * VEC) == 0 && UB % VEC == 0,
              "whole mma tiles; a 16-byte copy within a gate's units");
static_assert(SPLIT >= 1 && SPLIT <= 8 && BM % SPLIT == 0,
              "a cluster of SPLIT CTAs shares a tile's rows");

enum Epilogue { GRU1, PLAIN, GRU2, READOUT };

// A tile of TN columns with epilogue EPI: B chunk and staged accumulators
// share the row stride WS, chosen so that the B fragment loads (rows tg,
// columns g) and the float2 accumulator stores hit distinct banks (WS = 8
// or 24 mod 32); the A chunk's TS = 4 mod 32 does the same for its
// fragments.
// After the ring (or the staged accumulators, which reuse it) come the
// epilogue's operands, copied in with the first chunk: a gate tile's three
// x (GRU1) or h (GRU2) gate rows and its state rows, [4][BM][UB]; the
// readout's ty and tc, [2][BM][TN].
template <int TN, int EPI>
struct Tile {
  static constexpr int WN = TN / WARPS_N;
  static constexpr int NI = WN / 8;
  static constexpr int WS = TN + 8;   // elements of a B row; floats of et's
  static constexpr int STAGE = (int)sizeof(op_t) * (BM * TS + BK * WS) / 4;  // floats
  static constexpr int RING = STAGES * STAGE > BM * WS ? STAGES * STAGE : BM * WS;
  static constexpr int OPS = EPI == GRU1 || EPI == GRU2 ? 4 * BM * UB
                             : EPI == READOUT ? 2 * BM * TN : 0;
  static constexpr size_t SMEM = sizeof(float) * (size_t)(RING + OPS);
  static_assert(TN % 16 == 0 && WN % 8 == 0, "warp tiles of whole n8 tiles");
  static_assert((int)sizeof(op_t) * BM * TS % 16 == 0 && STAGE % 4 == 0,
                "chunks on 16-byte boundaries");
  static_assert(SMEM <= 232448, "227 KB a block");
};

using vag::cp_async16;
using vag::cp_async4;
using vag::cp_async_commit;
using vag::cp_async_wait;
using vag::gru_unit;
using vag::mma_tf32;
using vag::split_tf32;
using vag::tanh_fast;
using vag::warp_max;
using vag::warp_sum;

// One product out = a (M, Kd) @ b (Kd, *) over column tiles: tiles
// [0, gate_tiles) are gate tiles of UB units over H, the rest plain tiles
// over b's columns [col0, col0 + cols). Epilogue operands by kind:
//   GRU1:    x = gy (xg1, row stride ldx), hb = bh1, h = s, so = s~;
//   PLAIN:   out = qh;
//   GRU2:    xb = bi2, hg = qh + A (row stride ldh), hb = bh2, h = s~,
//            so = s', out2 = tc (M, cols);
//   READOUT: x = gy + 3H (ty), tc, bias = b, out = t; the depth split
//            over SPLIT CTAs of a cluster.
struct Gemm {
  const op_t *a, *b;
  int lda, ldb, M, Kd;
  int H, gate_tiles, col0, cols;
  int kchunk;              // depth of a split (a multiple of BK)
  int vec_a, vec_b, vec_e; // 16-byte copies of a / b / epilogue operand rows
  const float *x, *xb, *hg, *hb, *tc, *bias;
  const op_t* h;
  int ldx, ldh, ldo;
  float *out, *out2;
  op_t* so;                // the gate tiles' new states
};

// b's column for column j of column tile ct, or -1 outside b.
template <int TN>
__device__ __forceinline__ int b_col(const Gemm& p, int ct, int j) {
  if (ct < p.gate_tiles) {
    const int u = ct * UB + j % UB;
    return u < p.H ? (j / UB) * p.H + u : -1;
  }
  const int c = (ct - p.gate_tiles) * TN + j;
  return c < p.cols ? p.col0 + c : -1;
}

// Copies depth chunk [k0, k0 + BK) of the CTA's a rows and b columns into
// ring stage `st`, zero-filled past M, ke and b's columns.
// One element of a row off a 16-byte boundary (base: any valid address,
// read from when the element is outside): a 4-byte cp.async.
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      const float* base, bool in) {
  cp_async4(dst, in ? src : base, in ? 4 : 0);
}

template <int TN>
__device__ __forceinline__ void load_chunk(const Gemm& p, float* st, int k0,
                                           int ke, int row0, int ct) {
  using L = Tile<TN, PLAIN>;
  const int tid = threadIdx.x;
  op_t* as = reinterpret_cast<op_t*>(st);
  op_t* bs = as + BM * TS;
  for (int i = tid; i < BM * (BK / VEC); i += THREADS) {
    const int r = i / (BK / VEC), k = k0 + (i % (BK / VEC)) * VEC;
    const int row = row0 + r;
    op_t* dst = as + r * TS + (k - k0);
    if (p.vec_a) {  // Kd % VEC == 0, so ke is too: VEC depths in or out
      const bool in = row < p.M && k < ke;
      cp_async16(reinterpret_cast<float*>(dst),
                 reinterpret_cast<const float*>(in ? p.a + (size_t)row * p.lda + k : p.a),
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool in = row < p.M && k + j < ke;
        copy1(dst + j, p.a + (size_t)row * p.lda + k + j, p.a, in);
      }
    }
  }
  for (int i = tid; i < BK * (TN / VEC); i += THREADS) {
    const int kk = i / (TN / VEC), j = (i % (TN / VEC)) * VEC;
    const int k = k0 + kk;
    op_t* dst = bs + kk * L::WS + j;
    if (p.vec_b) {  // H, col0 and cols multiples of VEC: VEC columns in or out
      const int col = b_col<TN>(p, ct, j);
      const bool in = col >= 0 && k < ke;
      cp_async16(reinterpret_cast<float*>(dst),
                 reinterpret_cast<const float*>(in ? p.b + (size_t)k * p.ldb + col : p.b),
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj) {
        const int col = b_col<TN>(p, ct, j + jj);
        const bool in = col >= 0 && k < ke;
        copy1(dst + jj, p.b + (size_t)k * p.ldb + col, p.b, in);
      }
    }
  }
}

// acc += the 3xTF32 product of one staged chunk, for this warp's WM x WN.
template <int TN>
__device__ __forceinline__ void mma_chunk(const float* st,
                                          float (&acc)[MI][Tile<TN, PLAIN>::NI][4],
                                          int wm, int wn, int g, int tg) {
  using L = Tile<TN, PLAIN>;
  const float* as = st;
  const float* bs = st + BM * TS;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 8) {
    uint32_t ab[MI][4], asm_[MI][4], bb[L::NI][2], bsm[L::NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* a = as + (wm * WM + mi * 16 + g) * TS + ks + tg;
      split_tf32(a[0], ab[mi][0], asm_[mi][0]);
      split_tf32(a[8 * TS], ab[mi][1], asm_[mi][1]);
      split_tf32(a[4], ab[mi][2], asm_[mi][2]);
      split_tf32(a[8 * TS + 4], ab[mi][3], asm_[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni) {
      const float* b = bs + (ks + tg) * L::WS + wn * L::WN + ni * 8 + g;
      split_tf32(b[0], bb[ni][0], bsm[ni][0]);
      split_tf32(b[4 * L::WS], bb[ni][1], bsm[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < L::NI; ++ni) {
        mma_tf32(acc[mi][ni], asm_[mi], bb[ni]);
        mma_tf32(acc[mi][ni], ab[mi], bsm[ni]);
        mma_tf32(acc[mi][ni], ab[mi], bb[ni]);
      }
  }
}


// Copies rows [row0, row0 + BM) of src (row stride ld) into dst [BM][NC]:
// column j from src's column col(j), zero where col(j) < 0 or past M;
// 16-byte copies when vec (col maps 4-aligned groups of j to 4 contiguous,
// 4-aligned columns, all in or all out).
template <int NC, typename Col>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int ld,
                                           int row0, int M, bool vec, Col col) {
  for (int i = threadIdx.x; i < BM * (NC / 4); i += THREADS) {
    const int r = i / (NC / 4), j = (i % (NC / 4)) * 4;
    const int row = row0 + r;
    float* d = dst + r * NC + j;
    if (vec) {
      const int c = col(j);
      const bool in = row < M && c >= 0;
      cp_async16(d, in ? src + (size_t)row * ld + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = col(j + jj);
        const bool in = row < M && c >= 0;
        cp_async4(d + jj, in ? src + (size_t)row * ld + c : src, in ? 4 : 0);
      }
    }
  }
}

// Grid (row tiles, column tiles, depth splits) of CTAs of THREADS.
template <int TN, int EPI>
__global__ void __launch_bounds__(THREADS)
dec_step_gemm(const Gemm p) {
  using L = Tile<TN, EPI>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int row0 = blockIdx.x * BM, ct = blockIdx.y;
  const int kb = blockIdx.z * p.kchunk;
  const int ke = min(p.Kd, kb + p.kchunk);
  const int n_q = ke > kb ? (ke - kb + BK - 1) / BK : 0;   // 0: an empty split
  const bool gate = ct < p.gate_tiles;
  const int c0 = (ct - p.gate_tiles) * TN;   // a plain tile's first column
  float* ops = smem + L::RING;               // the epilogue's operands

  // The epilogue's operands, with the first chunk: they land while the
  // products run.
  if ((EPI == GRU1 || EPI == GRU2) && gate) {
    const int H = p.H, u0 = ct * UB;
    const float* src = EPI == GRU1 ? p.x : p.hg;
    const int ld = EPI == GRU1 ? p.ldx : p.ldh;
#pragma unroll
    for (int gi = 0; gi < 3; ++gi)
      stage_rows<UB>(ops + gi * BM * UB, src, ld, row0, p.M, p.vec_e,
                     [&](int j) { return u0 + j < H ? gi * H + u0 + j : -1; });
    stage_rows<UB>(ops + 3 * BM * UB, p.h, H, row0, p.M, p.vec_e,
                   [&](int j) { return u0 + j < H ? u0 + j : -1; });
  } else if (EPI == READOUT) {
    const int cols = p.cols;
    auto col = [&](int j) { return c0 + j < cols ? c0 + j : -1; };
    stage_rows<TN>(ops, p.x, p.ldx, row0, p.M, p.vec_e, col);
    stage_rows<TN>(ops + BM * TN, p.tc, cols, row0, p.M, p.vec_e, col);
  }

  float acc[MI][L::NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < n_q) load_chunk<TN>(p, smem + q * L::STAGE, kb + q * BK, ke, row0, ct);
    cp_async_commit();
  }
  for (int q = 0; q < n_q; ++q) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk q landed; chunk q - 1's stage consumed
    const int qn = q + STAGES - 1;
    if (qn < n_q)
      load_chunk<TN>(p, smem + (qn % STAGES) * L::STAGE, kb + qn * BK, ke, row0, ct);
    cp_async_commit();
    mma_chunk<TN>(smem + (q % STAGES) * L::STAGE, acc, wm, wn, g, tg);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the accumulators go through it

  float* et = smem;  // [BM][WS]
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni) {
      const int r = wm * WM + mi * 16 + g, c = wn * L::WN + ni * 8 + 2 * tg;
      *reinterpret_cast<float2*>(&et[r * L::WS + c]) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(&et[(r + 8) * L::WS + c]) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();

  if ((EPI == GRU1 || EPI == GRU2) && gate) {
    const int H = p.H;
    for (int i = tid; i < BM * UB; i += THREADS) {
      const int r = i / UB, uu = i % UB;
      const int row = row0 + r, u = ct * UB + uu;
      if (row >= p.M || u >= H) continue;
      const float* e = et + r * L::WS + uu;
      const float* o = ops + r * UB + uu;   // [gate][BM][UB], then h
      const float h = o[3 * BM * UB];
      float v;
      if (EPI == GRU1) {   // gru(xg1, s @ uh1 + bh1, s)
        v = gru_unit(o[0], o[BM * UB], o[2 * BM * UB], e[0] + __ldg(p.hb + u),
                     e[UB] + __ldg(p.hb + H + u),
                     e[2 * UB] + __ldg(p.hb + 2 * H + u), h);
      } else {             // gru(xc + bi2, qh[A:] + bh2, s~)
        v = gru_unit(e[0] + __ldg(p.xb + u), e[UB] + __ldg(p.xb + H + u),
                     e[2 * UB] + __ldg(p.xb + 2 * H + u),
                     o[0] + __ldg(p.hb + u), o[BM * UB] + __ldg(p.hb + H + u),
                     o[2 * BM * UB] + __ldg(p.hb + 2 * H + u), h);
      }
      p.so[(size_t)row * p.ldo + u] = to_op(v);
    }
    return;
  }

  if (EPI == READOUT) {
    // The SPLIT CTAs of a tile are one cluster, CTA z holding split z's
    // partial tile in its et. After the cluster's barrier, CTA z adds the
    // partials of its BM / SPLIT rows from every CTA's shared memory in
    // split order, then applies tanh(((ty + s' @ ws) + tc) + b).
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    cluster.sync();
    constexpr int RZ = BM / SPLIT;
    for (int i = tid; i < RZ * TN; i += THREADS) {
      const int r = blockIdx.z * RZ + i / TN, j = i % TN;
      const int row = row0 + r, c = c0 + j;
      if (row >= p.M || c >= p.cols) continue;
      float v = 0.f;
#pragma unroll
      for (int z = 0; z < SPLIT; ++z)
        v += cluster.map_shared_rank(et, z)[r * L::WS + j];
      const float ty = ops[r * TN + j], tc = ops[BM * TN + r * TN + j];
      p.out[(size_t)row * p.ldo + c] = tanhf(((ty + v) + tc) + __ldg(p.bias + c));
    }
    cluster.sync();   // no CTA leaves while another reads its partials
    return;
  }
#pragma unroll 4
  for (int i = tid; i < BM * TN; i += THREADS) {
    const int r = i / TN, j = i % TN;
    const int row = row0 + r, c = c0 + j;
    if (row >= p.M || c >= p.cols) continue;
    const float v = et[r * L::WS + j];
    if (EPI == GRU2) {
      p.out2[(size_t)row * p.cols + c] = v;
    } else {
      p.out[(size_t)row * p.ldo + c] = v;
    }
  }
}

// The READOUT grid is launched in clusters of its SPLIT depth splits.
template <int TN, int EPI>
cudaError_t gemm(const Gemm& p, int col_tiles, cudaStream_t s) {
  using L = Tile<TN, EPI>;
  const cudaError_t e = cudaFuncSetAttribute(
      dec_step_gemm<TN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.M + BM - 1) / BM, col_tiles, EPI == READOUT ? SPLIT : 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = EPI == READOUT ? SPLIT : 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dec_step_gemm<TN, EPI>, p);
}

// A cluster of ATT_CLUSTER CTAs per sentence b, its K beams inside each.
// Shared: q (K, A), va (A), scores / weights (K, T). CTA `rank` of the
// cluster takes positions rank * ATT_WARPS + warp (+ ATT_CLUSTER *
// ATT_WARPS ...), one warp a position for all K beams (its ctx_proj row is
// read once), and writes each score into the shared memory of every CTA of
// the cluster; after the cluster's barrier each CTA has all scores, takes
// the softmax, and sums its share of the C context columns, one thread a
// column for all K beams.
// GROUPS (K > MAX_K, the MAX_K = 16 build): the scores and the context
// sums loop over the sentence's beams in groups of MAX_K, each group on
// the register arrays one group of K <= MAX_K uses (ctx_proj's row and
// ctx's column read once a group).
template <bool GROUPS>
__global__ void __cluster_dims__(ATT_CLUSTER, 1, 1) __launch_bounds__(ATT_THREADS)
dec_step_attn(const float* __restrict__ qh, int ldq,
              const float* __restrict__ ctxp, const op_t* __restrict__ ctx,
              const float* __restrict__ mask, const float* __restrict__ va,
              op_t* __restrict__ c, int K, int T, int A, int C) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float sm[];
  float* qs = sm;
  float* vs = qs + K * A;   // va follows q: one copy loop fills both
  float* sc = vs + A;
  const int b = blockIdx.x / ATT_CLUSTER, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // q and va into shared memory, ATT_BATCH loads a thread in flight
  for (int i0 = tid; i0 < (K + 1) * A; i0 += ATT_THREADS * ATT_BATCH) {
    float v[ATT_BATCH];
#pragma unroll
    for (int u = 0; u < ATT_BATCH; ++u) {
      const int i = i0 + u * ATT_THREADS, k = i / A, a = i % A;
      v[u] = i >= (K + 1) * A ? 0.f
             : k < K ? qh[((size_t)b * K + k) * ldq + a] : va[a];
    }
#pragma unroll
    for (int u = 0; u < ATT_BATCH; ++u)
      if (i0 + u * ATT_THREADS < (K + 1) * A) qs[i0 + u * ATT_THREADS] = v[u];
  }
  __syncthreads();
  for (int j = rank * ATT_WARPS + warp; j < T; j += ATT_CLUSTER * ATT_WARPS) {
    const float* cp = ctxp + ((size_t)b * T + j) * A;
    const bool live = mask[(size_t)b * T + j] > 0.f;
    for (int k0 = 0; k0 < (GROUPS ? K : 1); k0 += MAX_K) {
    const int kg = GROUPS ? min(MAX_K, K - k0) : K;   // beams of this group
    const float* qg = qs + (size_t)k0 * A;
    float acc[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) acc[k] = 0.f;
    // ATT_BATCH of the row's values a lane in flight at once, then their
    // terms in the same order as one at a time
    for (int a0 = lane; a0 < A; a0 += 32 * ATT_BATCH) {
      float xb[ATT_BATCH];
#pragma unroll
      for (int u = 0; u < ATT_BATCH; ++u)
        xb[u] = a0 + 32 * u < A ? cp[a0 + 32 * u] : 0.f;
#pragma unroll
      for (int u = 0; u < ATT_BATCH; ++u) {
        const int a = a0 + 32 * u;
        if (a >= A) break;
        const float v = vs[a];
#pragma unroll
        for (int k = 0; k < MAX_K; ++k)
          if (k < kg) acc[k] += tanh_fast(xb[u] + qg[k * A + a]) * v;
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k >= kg) break;
      const float e = warp_sum(acc[k]);
      if (lane < ATT_CLUSTER)
        cluster.map_shared_rank(sc, lane)[(k0 + k) * T + j] = live ? e : NEG_INF;
    }
    }
  }
  cluster.sync();   // every score in every CTA's sc
  for (int k = warp; k < K; k += ATT_WARPS) {   // a softmax warp a beam
    float* s = sc + k * T;
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(s[j] - mx);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) s[j] = s[j] / sum;
  }
  __syncthreads();
  const int per = (C + ATT_CLUSTER - 1) / ATT_CLUSTER;
  const int col_end = min(C, (rank + 1) * per);
  for (int col = rank * per + tid; col < col_end; col += ATT_THREADS) {
    const op_t* cx = ctx + (size_t)b * T * C + col;
    for (int k0 = 0; k0 < (GROUPS ? K : 1); k0 += MAX_K) {
    const int kg = GROUPS ? min(MAX_K, K - k0) : K;
    const float* sg = sc + (size_t)k0 * T;
    float acc[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) acc[k] = 0.f;
#pragma unroll 16
    for (int j = 0; j < T; ++j) {
      const float x = ldf(cx[(size_t)j * C]);
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < kg) acc[k] = fmaf(sg[k * T + j], x, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < kg) c[((size_t)b * K + k0 + k) * C + col] = to_op(acc[k]);
    }
  }
}

bool al16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Device pointers to contiguous fp32 tensors (N = B * K rows, G = 3H + R):
//   gy (N, G) the gathered table rows, s (N, H), ctx (B, T, C),
//   ctxp (B, T, A) with ba folded in, mask (B, T),
//   uh1 (H, 3H), bh1 (3H,), w_s (H, A + 3H), bh2 (3H,), va (A,),
//   w_c (C, 3H + R), bi2 (3H,), ws (H, R), b (R,);
//   outputs s_new (N, H), t (N, R); scratch st (N, H), qh (N, A + 3H),
//   c (N, C), tc (N, R). The tiling of each product in launch order (hg1,
//   qh, xc, sw) comes from ops/dec_step.py's dec_step_plan, which owns it:
//   gate tiles and column tiles (gtN, ctN), and kchunk, the depth of each
//   of the last product's SPLIT splits (a multiple of BK, SPLIT * kchunk
//   >= H). Only the plan's form is checked here (gate tiles in the GRU
//   products alone); every write is masked to the outputs, and that the
//   tiles cover them is the plan's, tested on the CPU.
// 1 <= K <= VAG_MAX_K, or any K >= 1 in the MAX_K = 16 build (the
// attention in groups of 16 above 16). Enqueues 5 grids; returns 0 or the
// first CUDA error.
extern "C" int dec_step_launch(
    const void* gy, const void* s, const void* ctx, const void* ctxp,
    const void* mask, const void* uh1, const void* bh1, const void* w_s,
    const void* bh2, const void* va, const void* w_c, const void* bi2,
    const void* ws, const void* b, void* s_new, void* t, void* st, void* qh,
    void* c, void* tc, int B, int K, int T, int H, int A, int C, int R,
    int gt1, int ct1, int gt2, int ct2, int gt3, int ct3, int gt4, int ct4,
    int kchunk, void* stream) {
  if (K < 1 || (MAX_K == 8 && K > MAX_K) || H < 1 || A < 1 || C < 1 || R < 1 || T < 1 ||
      kchunk < BK || kchunk % BK != 0 || (long long)SPLIT * kchunk < H ||
      gt1 < 1 || ct1 != gt1 || gt2 != 0 || ct2 < 1 || gt3 < 1 || ct3 <= gt3 ||
      gt4 != 0 || ct4 < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int N = B * K, H3 = 3 * H, G = H3 + R, Q = A + H3, X = H3 + R;
  const float* gy_f = static_cast<const float*>(gy);
  op_t* st_f = static_cast<op_t*>(st);
  float* qh_f = static_cast<float*>(qh);
  op_t* c_f = static_cast<op_t*>(c);
  float* tc_f = static_cast<float*>(tc);
  op_t* s_new_f = static_cast<op_t*>(s_new);
  const size_t att_smem = sizeof(float) * ((size_t)K * A + A + (size_t)K * T);
  const bool groups = K > MAX_K;
  if (att_smem > 48 * 1024) {
    VAG_CHECK(cudaFuncSetAttribute(groups ? (const void*)dec_step_attn<true>
                                          : (const void*)dec_step_attn<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)att_smem));
  }

  Gemm g1{};
  g1.a = static_cast<const op_t*>(s);
  g1.b = static_cast<const op_t*>(uh1);
  g1.lda = H; g1.ldb = H3; g1.M = N; g1.Kd = H;
  g1.H = H; g1.gate_tiles = gt1;
  g1.kchunk = H;
  g1.vec_a = H % VEC == 0 && al16(s);
  g1.vec_b = H % VEC == 0 && al16(uh1);
  g1.vec_e = H % 4 == 0 && R % 4 == 0 && al16(gy) && al16(s);
  g1.x = gy_f; g1.ldx = G;
  g1.hb = static_cast<const float*>(bh1);
  g1.h = static_cast<const op_t*>(s);
  g1.so = st_f; g1.ldo = H;
  VAG_CHECK((gemm<GT, GRU1>(g1, ct1, cs)));

  Gemm g2{};
  g2.a = st_f;
  g2.b = static_cast<const op_t*>(w_s);
  g2.lda = H; g2.ldb = Q; g2.M = N; g2.Kd = H;
  g2.cols = Q;
  g2.kchunk = H;
  g2.vec_a = H % VEC == 0;
  g2.vec_b = Q % VEC == 0 && al16(w_s);
  g2.out = qh_f; g2.ldo = Q;
  VAG_CHECK((gemm<BN, PLAIN>(g2, ct2, cs)));

  if (groups)
    dec_step_attn<true><<<B * ATT_CLUSTER, ATT_THREADS, att_smem, cs>>>(
        qh_f, Q, static_cast<const float*>(ctxp), static_cast<const op_t*>(ctx),
        static_cast<const float*>(mask), static_cast<const float*>(va), c_f, K,
        T, A, C);
  else
    dec_step_attn<false><<<B * ATT_CLUSTER, ATT_THREADS, att_smem, cs>>>(
        qh_f, Q, static_cast<const float*>(ctxp), static_cast<const op_t*>(ctx),
        static_cast<const float*>(mask), static_cast<const float*>(va), c_f, K,
        T, A, C);
  VAG_CHECK(cudaGetLastError());

  Gemm g3{};
  g3.a = c_f;
  g3.b = static_cast<const op_t*>(w_c);
  g3.lda = C; g3.ldb = X; g3.M = N; g3.Kd = C;
  g3.H = H; g3.gate_tiles = gt3; g3.col0 = H3; g3.cols = R;
  g3.kchunk = C;
  g3.vec_a = C % VEC == 0;
  g3.vec_b = H % VEC == 0 && R % VEC == 0 && al16(w_c);
  g3.vec_e = H % 4 == 0 && A % 4 == 0;
  g3.xb = static_cast<const float*>(bi2);
  g3.hg = qh_f + A; g3.ldh = Q;
  g3.hb = static_cast<const float*>(bh2);
  g3.h = st_f;
  g3.so = s_new_f; g3.ldo = H;
  g3.out2 = tc_f;
  VAG_CHECK((gemm<GT, GRU2>(g3, ct3, cs)));

  Gemm g4{};
  g4.a = s_new_f;
  g4.b = static_cast<const op_t*>(ws);
  g4.lda = H; g4.ldb = R; g4.M = N; g4.Kd = H;
  g4.cols = R;
  g4.kchunk = kchunk;
  g4.vec_a = H % VEC == 0;
  g4.vec_b = R % VEC == 0 && al16(ws);
  g4.vec_e = H % 4 == 0 && R % 4 == 0 && al16(gy);
  g4.x = gy_f + H3; g4.ldx = G;
  g4.tc = tc_f;
  g4.bias = static_cast<const float*>(b);
  g4.out = static_cast<float*>(t); g4.ldo = R;
  VAG_CHECK((gemm<RN, READOUT>(g4, ct4, cs)));
  return 0;
}
