// Kernel 7b: the fused beam decode step of the bf16 decode, GRU1 ->
// attention -> GRU2 -> readout activations, for Hopper (sm_90a), plain C
// interface. Built only with -DVAG_BF16=1 (dec_step_bf16, dec_step_k16_bf16).
//
// Replaces: vag_nmt_tpu/ops/pallas_dec_step.py, _kernel (entry
// pallas_decode_step) under the JAX package's bf16 decode: the states s, s~
// and s', the attention's context c, ctx and the four weight matrices in
// bf16, each state and c rounded once where the JAX kernel casts it; gy,
// ctxpb, mask, the biases, va, qh, tc and t fp32. For N = B*K beam rows:
//   s~  = GRU1(xg1, s @ uh1 + bh1, s)
//   qh  = s~ @ w_s                      (w_s = [ua | uh2])
//   e   = tanh(ctxpb[b] + q), w = masked softmax of e . va, c = w ctx[b]
//   xc  = c @ w_c                       (w_c = [wi2 | wc])
//   s'  = GRU2(xc[:3H] + bi2, qh[A:] + bh2, s~)
//   t   = tanh(((ty + s' @ ws) + xc[3H:]) + b)
//
// Bound on this card at B=128, K=5, T=32, full width (H=A=512, C=1024,
// R=256): 4.87 GFLOP of bf16 products, 4.9 us at 989 TFLOP/s; ~31 MB
// moved (ctxpb fp32 and ctx bf16 most of it), 9.2 us at 3.35 TB/s: bound
// by bytes (chip_smoke.py's _dec_step_bf16_bound).
//
// Design: six grids on the caller's stream, the stream's order the barrier
// between them:
//   1. s @ uh1 with GRU1 in its epilogue: s~;
//   2. s~ @ w_s: qh;
//   3. the attention's scores, a warp a (sentence, position): sc;
//   4. their softmax and the context sums, ATT_PARTS CTAs a sentence: c;
//   5. c @ w_c with GRU2 in its epilogue, and the tc columns: s', tc;
//   6. s' @ ws with the readout in its epilogue: t.
// The four products run on hopper_mma.cuh's engine: a CTA of one wgmma
// warpgroup and a producer warp owns 64 rows and a tile of columns, the
// producer streaming 64-deep stages (an A box of the activations, the
// tile's B boxes of the weights, row-major as they are) by TMA into a
// STAGES-deep ring, the warpgroup summing each stage's four 16-deep
// wgmma steps into the tile's fp32 accumulators in ascending depth.
//   A gate tile takes a block of UB hidden units with all three of their
// gate columns, three boxes of uh1 or w_c H columns apart, so each thread
// holds the r, z and n pre-activations of its units in its own registers:
// the GRU cell runs on the accumulators in dec_step_plain's order of
// operations, its other operands (gate rows of gy or qh, the old state)
// loaded into registers before the products start. GRU2's grid also has
// plain tiles of three boxes over w_c's last R columns (tc). The readout
// product is not split over its depth (RN = 32 columns a tile): each
// output has one accumulator, its depth summed in ascending order.
//   Grids 2-6 are plain launches: launched as programmatic dependents of
// the grid before (their first weight stages in flight before
// griddepcontrol.wait), the call took about 6 us longer on an H100,
// whether a block let its dependents start at its start or after its
// products (PERF.md).
//   The attention is two grids, not kernel 7's cluster of CTAs a sentence:
// on an H100 that grid took 0.037 ms at B = 128 whatever its loads, its
// phases (q, scores, cluster barrier, context) each a round of latency
// for too few warps. The scores' grid has a warp a position, 8 a CTA,
// ctx_proj read 16 bytes a lane; the context grid reads the bf16 ctx as
// 4b does (dec_scan_fwd.cu's context_bf16): 16 bytes (8 columns) a lane a
// position, the positions in four quarters added (q0 + q1) + (q2 + q3).
// The scores (N, T) go through global memory, after tc in its scratch
// buffer. The tiling is ops/dec_step.py's
// dec_step_bf16_plan: its constants come as -D defines, its tile counts as
// dec_step_launch's arguments.

#include <stdint.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

#if !defined(VAG_MAX_K) || !defined(VAG_UB) || !defined(VAG_BN) || !defined(VAG_RN) || \
    !defined(VAG_STAGES) || !defined(VAG_ATT_PARTS)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_MAX_K, VAG_UB, VAG_BN, VAG_RN, VAG_STAGES, VAG_ATT_PARTS)"
#endif

using vag::hm::A_BOX_BYTES;
using vag::hm::BBox;
using vag::hm::BOX_K;
using vag::hm::bf16;

constexpr int MAX_K = VAG_MAX_K;
constexpr int BM = 64;              // rows of a product tile (one wgmma M)
constexpr int UB = VAG_UB;          // hidden units of a gate tile (one B box)
constexpr int BN = VAG_BN;          // columns of a qh tile
constexpr int RN = VAG_RN;          // columns of a readout tile
constexpr int STAGES = VAG_STAGES;  // the TMA ring
constexpr int MMA_THREADS = 128;    // the wgmma warpgroup
constexpr int THREADS = MMA_THREADS + 32;   // and the producer warp
constexpr int ATT_PARTS = VAG_ATT_PARTS;   // context CTAs a sentence (4)
constexpr int SC_WARPS = 8;         // positions a score CTA takes, a warp each
constexpr int SC_THREADS = 32 * SC_WARPS;
constexpr int CX_THREADS = 128;     // a context CTA
constexpr int CX_WARPS = CX_THREADS / 32;
constexpr int CX_BLOCKS = 4;        // context CTAs an SM holds: 4 B at B = 128
constexpr int ATT_V = 4;            // 16-byte ctx_proj loads a lane a position
constexpr int ATT_BATCH = 8;        // q / ctx loads a lane keeps in flight
constexpr int CKG = 8;              // beams a context sum takes at once
constexpr float NEG_INF = -1e9f;   // as ops/attention.masked_softmax

static_assert(MAX_K == 8 || MAX_K == 16, "two instances (ops/dec_step.py): K <= 8 and K > 8");
static_assert(UB == 32 && RN == 32 && BN == 128, "gate and readout tiles of 32-column "
              "boxes, qh tiles of two 64-column boxes (dec_step_bf16_plan)");

enum Epilogue { GRU1, PLAIN, GRU2, READOUT };

// One product out = a (M, Kd) @ b (Kd, bcols) over column tiles: tiles
// [0, gate_tiles) are gate tiles (box g at b's column g H + ct UB), the rest
// plain tiles over b's columns [col0, col0 + cols) (box j at col0 + (ct -
// gate_tiles) TN + j BW). Epilogue operands by kind:
//   GRU1:    x = gy (xg1, row stride ldx), hb = bh1, h = s, so = s~;
//   PLAIN:   out = qh;
//   GRU2:    xb = bi2, hg = qh + A (row stride ldh), hb = bh2, h = s~,
//            so = s', out2 = tc (M, cols);
//   READOUT: x = gy + 3H (ty), tc, bias = b, out = t.
struct Gemm {
  const bf16 *a, *b;
  int lda, ldb, M, Kd, bcols;
  int tma_a, tma_b;        // TMA, or the copy path
  int H, gate_tiles, col0, cols;
  const float *x, *xb, *hg, *hb, *tc, *bias;
  const bf16* h;
  int ldx, ldh, ldo;
  float *out, *out2;
  bf16* so;                // the gate tiles' new states
};

template <int BW, int NB>
struct Tile {
  static constexpr int TN = BW * NB;                   // columns
  static constexpr int ACC = TN / 2;                   // accumulators a thread
  static constexpr int STAGE = A_BOX_BYTES + NB * BBox<BW>::BYTES;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0, "every box on a 1024-byte boundary");
  static_assert(SMEM <= 232448, "227 KB a block");
};

// The gate tiles' units a thread holds: accumulators [0, NU) are its r
// columns (units acc_col < UB), NU further its z, 2 NU further its n.
constexpr int NU = 4 * (UB / 8);

// Grid (row tiles, column tiles) of CTAs of THREADS: warps 0-3 the wgmma
// warpgroup, warp 4 the producer.
template <int BW, int NB, int EPI>
__global__ void __launch_bounds__(THREADS)
dec_step_gemm(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
              const Gemm p) {
  using L = Tile<BW, NB>;
  using namespace vag::hm;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = vag::hm::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM, ct = blockIdx.y;
  const int n_q = (p.Kd + BOX_K - 1) / BOX_K;
  const bool gate = ct < p.gate_tiles;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], MMA_THREADS / 32);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= MMA_THREADS) {
    // The producer warp. Box j of the tile's B, at b's column:
    const int lane = tid & 31;
    auto bcol = [&](int j) {
      return gate ? j * p.H + ct * UB : p.col0 + (ct - p.gate_tiles) * L::TN + j * BW;
    };
    auto b_boxes = [&](uint8_t* st, int k0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        load_box<BW>(p.tma_b, st + A_BOX_BYTES + j * BBox<BW>::BYTES, &mb,
                     &full[(st - smem) / L::STAGE], p.b, p.Kd, p.bcols, p.ldb, bcol(j), k0);
    };
    for (int q = 0; q < n_q; ++q) {
      const int s = q % STAGES;
      uint8_t* st = smem + s * L::STAGE;
      if (q >= STAGES) bar_wait(&empty[s], ((q / STAGES) - 1) & 1);
      if (!p.tma_a) copy_box<64>(st, p.a, p.M, p.Kd, p.lda, q * BOX_K, row0);
      if (!p.tma_b) b_boxes(st, q * BOX_K);
      __syncwarp();
      if (lane == 0) {
        bar_expect(&full[s], (p.tma_a ? A_BOX_BYTES : 0) +
                                 (p.tma_b ? NB * BBox<BW>::BYTES : 0));
        if (p.tma_a) tma_load(st, &ma, &full[s], q * BOX_K, row0);
        if (p.tma_b) b_boxes(st, q * BOX_K);
      }
    }
    return;
  }

  // The wgmma warpgroup. The epilogue's operands first, into registers:
  // they land while the products run.
  const int H = p.H;
  float e0[NU], e1[NU], e2[NU], e3[NU];
  if constexpr (EPI == GRU1 || EPI == GRU2) {
    if (gate) {
    const float* src = EPI == GRU1 ? p.x : p.hg;
    const int ld = EPI == GRU1 ? p.ldx : p.ldh;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int row = row0 + acc_row(tid, i), u = ct * UB + acc_col(tid, i);
      const bool in = row < p.M && u < H;
      const float* r = src + (size_t)row * ld + u;
      e0[i] = in ? r[0] : 0.f;
      e1[i] = in ? r[H] : 0.f;
      e2[i] = in ? r[2 * H] : 0.f;
      e3[i] = in ? __bfloat162float(p.h[(size_t)row * H + u]) : 0.f;
    }
    }
  } else if constexpr (EPI == READOUT) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int row = row0 + acc_row(tid, i), c = ct * L::TN + acc_col(tid, i);
      const bool in = row < p.M && c < p.cols;
      e0[i] = in ? p.x[(size_t)row * p.ldx + c] : 0.f;
      e1[i] = in ? p.tc[(size_t)row * p.cols + c] : 0.f;
    }
  }

  float d[L::ACC];
#pragma unroll
  for (int i = 0; i < L::ACC; ++i) d[i] = 0.f;
  fence_acc(d);
  for (int q = 0; q < n_q; ++q) {
    const int s = q % STAGES;
    bar_wait(&full[s], (q / STAGES) & 1);
    const uint32_t st = smem_u32(smem + s * L::STAGE);
    mma_stage<BW, NB>(d, st, st + A_BOX_BYTES);
    wg_wait<1>();   // stage q - 1's products are done: its stage is free
    if (q > 0) warp_arrive(&empty[(q - 1) % STAGES]);
  }
  wg_wait<0>();
  fence_acc(d);

  if constexpr (EPI == GRU1 || EPI == GRU2) {
    if (gate) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int row = row0 + acc_row(tid, i), u = ct * UB + acc_col(tid, i);
      if (row >= p.M || u >= H) continue;
      const float a0 = d[i], a1 = d[NU + i], a2 = d[2 * NU + i];
      float v;
      if (EPI == GRU1) {   // gru(xg1, s @ uh1 + bh1, s)
        v = vag::gru_unit(e0[i], e1[i], e2[i], a0 + __ldg(p.hb + u),
                          a1 + __ldg(p.hb + H + u), a2 + __ldg(p.hb + 2 * H + u), e3[i]);
      } else {             // gru(xc + bi2, qh[A:] + bh2, s~)
        v = vag::gru_unit(a0 + __ldg(p.xb + u), a1 + __ldg(p.xb + H + u),
                          a2 + __ldg(p.xb + 2 * H + u), e0[i] + __ldg(p.hb + u),
                          e1[i] + __ldg(p.hb + H + u), e2[i] + __ldg(p.hb + 2 * H + u),
                          e3[i]);
      }
      p.so[(size_t)row * p.ldo + u] = __float2bfloat16_rn(v);
    }
    return;
    }
  }
  const int c0 = EPI == READOUT ? ct * L::TN : (ct - p.gate_tiles) * L::TN;
#pragma unroll
  for (int i = 0; i < L::ACC; ++i) {
    const int row = row0 + acc_row(tid, i), c = c0 + acc_col(tid, i);
    if (row >= p.M || c >= p.cols) continue;
    if constexpr (EPI == READOUT) {
      static_assert(L::ACC == NU, "a readout tile's accumulators are its operands'");
      p.out[(size_t)row * p.ldo + c] = tanhf(((e0[i] + d[i]) + e1[i]) + __ldg(p.bias + c));
    } else if constexpr (EPI == GRU2) {
      p.out2[(size_t)row * p.cols + c] = d[i];
    } else {
      p.out[(size_t)row * p.ldo + c] = d[i];
    }
  }
}

// A grid of the product's tiles, the A and B maps built for this call.
template <int BW, int NB, int EPI>
cudaError_t gemm(Gemm p, int col_tiles, cudaStream_t s) {
  using L = Tile<BW, NB>;
  cudaError_t e = cudaFuncSetAttribute(
      dec_step_gemm<BW, NB, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return e;
  CUtensorMap ma, mb;
  bool ta, tb;
  e = vag::hm::tensor_map(&ma, &ta, p.a, p.M, p.Kd, p.lda, 64, BM);
  if (e != cudaSuccess) return e;
  e = vag::hm::tensor_map(&mb, &tb, p.b, p.Kd, p.bcols, p.ldb, BW, BOX_K);
  if (e != cudaSuccess) return e;
  p.tma_a = ta;
  // A TMA box starts on a 16-byte boundary: the gate tiles' boxes at g H +
  // ct UB and the tc tiles' after 3H need H (and col0) in multiples of 8.
  p.tma_b = tb && (p.gate_tiles == 0 || p.H % 8 == 0) && p.col0 % 8 == 0;
  const dim3 grid((p.M + BM - 1) / BM, col_tiles);
  dec_step_gemm<BW, NB, EPI><<<grid, THREADS, L::SMEM, s>>>(ma, mb, p);
  return cudaGetLastError();
}


__device__ __forceinline__ bool al16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Values [a, a + 4) of an fp32 row of n (zero past n): one 16-byte load
// where vec (n a multiple of 4, the row on a 16-byte boundary), else one at
// a time.
__device__ __forceinline__ float4 ld4(const float* row, int a, int n, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + a);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = a + e < n ? row[a + e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The first n (<= 8) bf16 values at p as they lie in memory (zero past n):
// one 16-byte load where vec (n = 8, p on a 16-byte boundary), else one at
// a time. bf_lo / bf_hi read the halves of one of its words.
__device__ __forceinline__ uint4 ld8(const bf16* p, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = (2 * e < n ? (uint32_t)__bfloat16_as_ushort(p[2 * e]) : 0u) |
           (2 * e + 1 < n ? (uint32_t)__bfloat16_as_ushort(p[2 * e + 1]) << 16 : 0u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// v[0, n) rounded to bf16 at p: one 16-byte store where vec, as ld8.
__device__ __forceinline__ void st8(bf16* p, const float (&v)[8], int n, bool vec) {
  if (vec) {
    uint4 o;
    uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = o;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) p[e] = __float2bfloat16_rn(v[e]);
}

// The context columns of a sentence's part: C in ATT_PARTS parts, each a
// whole number of 8-column groups.
__host__ __device__ __forceinline__ int ctx_cols(int C) {
  return ((C + ATT_PARTS - 1) / ATT_PARTS + 7) / 8 * 8;
}

// The attention's scores: a CTA per (sentence b, SC_WARPS positions), a
// warp a position j for all K beams (its ctx_proj row read once, 16 bytes
// a lane, every load of the row in flight before the first energy). q and
// va (rows of A4 = A rounded up to 4, zero-padded) in shared memory. Each
// lane sums its values' energies in ascending order, 4 a term; a warp sum
// gives the score, written masked to sc (N, T). GROUPS (K > MAX_K, the
// MAX_K = 16 build): the beams in groups of MAX_K.
template <bool GROUPS>
__global__ void __launch_bounds__(SC_THREADS)
dec_step_score(const float* __restrict__ qh, int ldq, const float* __restrict__ ctxp,
               const float* __restrict__ mask, const float* __restrict__ va,
               float* __restrict__ sc, int K, int T, int A) {
  extern __shared__ float4 sm4[];
  const int A4 = (A + 3) & ~3;
  float* qs = reinterpret_cast<float*>(sm4);
  const float* vs = qs + K * A4;   // va follows q: one copy loop fills both
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j = blockIdx.y * SC_WARPS + warp;
  // q and va into shared memory, 4 values a slot, ATT_BATCH slots a thread
  // in flight
  const bool vq = A % 4 == 0 && ldq % 4 == 0 && al16(qh) && al16(va);
  const int slots = (K + 1) * (A4 / 4);
  for (int i0 = tid; i0 < slots; i0 += SC_THREADS * ATT_BATCH) {
    float4 v[ATT_BATCH];
#pragma unroll
    for (int u = 0; u < ATT_BATCH; ++u) {
      const int i = i0 + u * SC_THREADS, k = i / (A4 / 4), a = 4 * (i % (A4 / 4));
      const float* row = k < K ? qh + ((size_t)b * K + k) * ldq : va;
      v[u] = i < slots ? ld4(row, a, A, vq) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < ATT_BATCH; ++u)
      if (i0 + u * SC_THREADS < slots) sm4[i0 + u * SC_THREADS] = v[u];
  }
  __syncthreads();
  if (j >= T) return;
  const bool vp = A % 4 == 0 && al16(ctxp);
  const float* cp = ctxp + ((size_t)b * T + j) * A;
  const bool live = mask[(size_t)b * T + j] > 0.f;
  for (int k0 = 0; k0 < (GROUPS ? K : 1); k0 += MAX_K) {
    const int kg = GROUPS ? min(MAX_K, K - k0) : K;   // beams of this group
    const float* qg = qs + (size_t)k0 * A4;
    float acc[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) acc[k] = 0.f;
    for (int a0 = 4 * lane; a0 < A; a0 += 128 * ATT_V) {
      float4 x[ATT_V];
#pragma unroll
      for (int u = 0; u < ATT_V; ++u)
        x[u] = a0 + 128 * u < A ? ld4(cp, a0 + 128 * u, A, vp) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < ATT_V; ++u) {
        const int a = a0 + 128 * u;
        if (a >= A) break;
        const float4 v = *reinterpret_cast<const float4*>(vs + a);
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          if (k >= kg) break;
          const float4 q = *reinterpret_cast<const float4*>(qg + k * A4 + a);
          acc[k] += vag::tanh_fast(x[u].x + q.x) * v.x + vag::tanh_fast(x[u].y + q.y) * v.y +
                    vag::tanh_fast(x[u].z + q.z) * v.z + vag::tanh_fast(x[u].w + q.w) * v.w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k >= kg) break;
      const float e = vag::warp_sum(acc[k]);
      if (lane == 0) sc[((size_t)b * K + k0 + k) * T + j] = live ? e : NEG_INF;
    }
  }
}

// The softmax and the context sums: a CTA per (sentence b, part), ATT_PARTS
// parts a sentence. The K beams' softmax (a warp a beam) into shared
// memory, then the part's context columns (ctx_cols) as 4b's
// (dec_scan_fwd.cu's context_bf16): in groups of 8, a group read 16 bytes
// a position, the positions in four quarters (lane = 8 quarter + group
// within the warp), each quarter's sums for CKG beams at a time in
// registers, added (q0 + q1) + (q2 + q3) by shuffles, c rounded to bf16
// once. Rows off 16 bytes (C no multiple of 8, ctx or c off a 16-byte
// boundary) load and store their values one at a time: the same sums in
// the same order.
__global__ void __launch_bounds__(CX_THREADS, CX_BLOCKS)
dec_step_context(const float* __restrict__ sc, const bf16* __restrict__ ctx,
                 bf16* __restrict__ c, int K, int T, int C) {
  extern __shared__ float sw[];   // (K, T) weights
  const int b = blockIdx.x / ATT_PARTS, part = blockIdx.x % ATT_PARTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = warp; k < K; k += CX_WARPS) {   // a softmax warp a beam
    const float* s = sc + ((size_t)b * K + k) * T;
    float* w = sw + k * T;
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, s[j]);
    mx = vag::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(s[j] - mx);
      w[j] = e;
      sum += e;
    }
    sum = vag::warp_sum(sum);
    for (int j = lane; j < T; j += 32) w[j] = w[j] / sum;
  }
  __syncthreads();

  // column group warp * 8 + lane % 8 of each round, positions [h T / 4,
  // (h + 1) T / 4) of quarter h = lane / 8
  const int per = ctx_cols(C), c0 = min(C, part * per), c1 = min(C, c0 + per);
  const int ng = (c1 - c0 + 7) / 8, h = lane / 8;
  const int j1 = (h + 1) * T / 4;
  const bool vc = C % 8 == 0 && al16(ctx), vo = C % 8 == 0 && al16(c);
  for (int g0 = warp * 8; g0 < ng; g0 += CX_WARPS * 8) {
    const int gi = g0 + lane % 8, col = c0 + 8 * gi, n = min(8, c1 - col);
    const bf16* cx = ctx + (size_t)b * T * C + col;
    for (int k0 = 0; k0 < K; k0 += CKG) {
      const int kg = min(CKG, K - k0);
      const float* wg = sw + (size_t)k0 * T;
      float acc[CKG][8];
#pragma unroll
      for (int k = 0; k < CKG; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
      for (int j = h * T / 4; j < j1; j += ATT_BATCH) {
        uint4 x[ATT_BATCH];
#pragma unroll
        for (int u = 0; u < ATT_BATCH; ++u)
          x[u] = gi < ng && j + u < j1 ? ld8(cx + (size_t)(j + u) * C, n, vc)
                                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int u = 0; u < ATT_BATCH; ++u) {
          if (j + u >= j1) break;
          const uint32_t xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
          for (int k = 0; k < CKG; ++k) {
            if (k >= kg) break;
            const float w = wg[k * T + j + u];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[k][2 * e] = fmaf(w, bf_lo(xs[e]), acc[k][2 * e]);
              acc[k][2 * e + 1] = fmaf(w, bf_hi(xs[e]), acc[k][2 * e + 1]);
            }
          }
        }
      }
      // (q0 + q1) + (q2 + q3) to quarter 0's lanes, which write c
#pragma unroll
      for (int k = 0; k < CKG; ++k) {
        if (k >= kg) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = acc[k][e];
          const float q1 = __shfl_down_sync(0xffffffffu, v, 8);
          if (!(h & 1)) v += q1;
          const float q23 = __shfl_down_sync(0xffffffffu, v, 16);
          acc[k][e] = v + q23;
        }
        if (h == 0 && gi < ng) st8(c + ((size_t)b * K + k0 + k) * C + col, acc[k], n, vo);
      }
    }
  }
}

// The attention's two grids: the scores into sc, then the softmax and c.
template <bool GROUPS>
cudaError_t attention(const float* qh, int ldq, const void* ctxp, const void* ctx,
                      const void* mask, const void* va, float* sc, bf16* c, int B, int K,
                      int T, int A, int C, cudaStream_t s) {
  const size_t A4 = (A + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)K * A4 + A4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dec_step_score<GROUPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dec_step_score<GROUPS><<<dim3(B, (T + SC_WARPS - 1) / SC_WARPS), SC_THREADS, smem, s>>>(
      qh, ldq, static_cast<const float*>(ctxp), static_cast<const float*>(mask),
      static_cast<const float*>(va), sc, K, T, A);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t wsm = sizeof(float) * (size_t)K * T;
  if (wsm > 48 * 1024) {
    e = cudaFuncSetAttribute(dec_step_context, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wsm);
    if (e != cudaSuccess) return e;
  }
  dec_step_context<<<B * ATT_PARTS, CX_THREADS, wsm, s>>>(
      sc, static_cast<const bf16*>(ctx), c, K, T, C);
  return cudaGetLastError();
}

}  // namespace

// dec_step.cu's dec_step_launch, on bf16 s, ctx, uh1, w_s, w_c, ws, s_new,
// st and c (N = B * K rows, G = 3H + R):
//   gy (N, G) f32, s (N, H), ctx (B, T, C), ctxp (B, T, A) f32 with ba
//   folded in, mask (B, T) f32, uh1 (H, 3H), bh1 (3H,), w_s (H, A + 3H),
//   bh2 (3H,), va (A,), w_c (C, 3H + R), bi2 (3H,), ws (H, R), b (R,);
//   outputs s_new (N, H), t (N, R) f32; scratch st (N, H), qh (N, A + 3H)
//   f32, c (N, C), tc (N R + N T) f32: tc (N, R), then the attention's
//   scores (N, T). The tiling (ops/dec_step.py's
//   dec_step_bf16_plan) in launch order (hg1, qh, xc, sw): gate tiles and
//   column tiles (gtN, ctN), then the readout's depth, one split (kchunk >=
//   H). Only the plan's form is checked here; every write is masked to the
//   outputs, and that the tiles cover them is the plan's, tested on the CPU.
// 1 <= K <= VAG_MAX_K, or any K >= 1 in the MAX_K = 16 build. Enqueues 6
// grids; returns 0 or the first CUDA error.
extern "C" int dec_step_launch(
    const void* gy, const void* s, const void* ctx, const void* ctxp, const void* mask,
    const void* uh1, const void* bh1, const void* w_s, const void* bh2, const void* va,
    const void* w_c, const void* bi2, const void* ws, const void* b, void* s_new, void* t,
    void* st, void* qh, void* c, void* tc, int B, int K, int T, int H, int A, int C, int R,
    int gt1, int ct1, int gt2, int ct2, int gt3, int ct3, int gt4, int ct4, int kchunk,
    void* stream) {
  if (K < 1 || (MAX_K == 8 && K > MAX_K) || H < 1 || A < 1 || C < 1 || R < 1 || T < 1 ||
      kchunk < H || gt1 < 1 || ct1 != gt1 || gt2 != 0 || ct2 < 1 || gt3 < 1 || ct3 <= gt3 ||
      gt4 != 0 || ct4 < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int N = B * K, H3 = 3 * H, G = H3 + R, Q = A + H3, X = H3 + R;
  bf16* st_b = static_cast<bf16*>(st);
  bf16* c_b = static_cast<bf16*>(c);
  bf16* s_new_b = static_cast<bf16*>(s_new);
  float* qh_f = static_cast<float*>(qh);
  float* tc_f = static_cast<float*>(tc);

  Gemm g1{};
  g1.a = static_cast<const bf16*>(s);
  g1.b = static_cast<const bf16*>(uh1);
  g1.lda = H; g1.ldb = H3; g1.M = N; g1.Kd = H; g1.bcols = H3;
  g1.H = H; g1.gate_tiles = gt1;
  g1.x = static_cast<const float*>(gy); g1.ldx = G;
  g1.hb = static_cast<const float*>(bh1);
  g1.h = static_cast<const bf16*>(s);
  g1.so = st_b; g1.ldo = H;
  VAG_CHECK((gemm<32, 3, GRU1>(g1, ct1, cs)));

  Gemm g2{};
  g2.a = st_b;
  g2.b = static_cast<const bf16*>(w_s);
  g2.lda = H; g2.ldb = Q; g2.M = N; g2.Kd = H; g2.bcols = Q;
  g2.cols = Q;
  g2.out = qh_f; g2.ldo = Q;
  VAG_CHECK((gemm<64, 2, PLAIN>(g2, ct2, cs)));

  float* sc = tc_f + (size_t)N * R;   // the scores, after tc
  VAG_CHECK(K > MAX_K
                ? attention<true>(qh_f, Q, ctxp, ctx, mask, va, sc, c_b, B, K, T, A, C, cs)
                : attention<false>(qh_f, Q, ctxp, ctx, mask, va, sc, c_b, B, K, T, A, C, cs));

  Gemm g3{};
  g3.a = c_b;
  g3.b = static_cast<const bf16*>(w_c);
  g3.lda = C; g3.ldb = X; g3.M = N; g3.Kd = C; g3.bcols = X;
  g3.H = H; g3.gate_tiles = gt3; g3.col0 = H3; g3.cols = R;
  g3.xb = static_cast<const float*>(bi2);
  g3.hg = qh_f + A; g3.ldh = Q;
  g3.hb = static_cast<const float*>(bh2);
  g3.h = st_b;
  g3.so = s_new_b; g3.ldo = H;
  g3.out2 = tc_f;
  VAG_CHECK((gemm<32, 3, GRU2>(g3, ct3, cs)));

  Gemm g4{};
  g4.a = s_new_b;
  g4.b = static_cast<const bf16*>(ws);
  g4.lda = H; g4.ldb = R; g4.M = N; g4.Kd = H; g4.bcols = R;
  g4.cols = R;
  g4.x = static_cast<const float*>(gy) + H3; g4.ldx = G;
  g4.tc = tc_f;
  g4.bias = static_cast<const float*>(b);
  g4.out = static_cast<float*>(t); g4.ldo = R;
  VAG_CHECK((gemm<32, 1, READOUT>(g4, ct4, cs)));
  return 0;
}
