// bf16 tensor-core tiles of the recurrences' bf16 instances: the
// time-parallel products of dec_scan_fwd.cu's replay (the steps the
// backward recomputes from the saved states: none of them reads another,
// so each product runs over all Tt * B rows at once, as one grid), of the
// decoder scans' streamed grids (the forward's readout; the backward's
// readout terms and weight grads) and of gru_bwd.cu's recompute and weight
// grads. Built only with -DVAG_BF16=1.
//
// A job is out (M, N) = sum over its segments of A_s (M, K_s) @ B_s (K_s,
// N) on bf16 operands, bf16 x bf16 -> fp32 on mma.sync m16n8k16 with fp32
// accumulators (every product exact, only the sums round), with the
// epilogue in the same CTA: a store in fp32 and / or bf16, a bias add, the
// readout's tanh(add + acc), GRU1's cell or the encoder GRU's cell
// backward coefficients (gate tiles: the r, z and n columns of a block of
// units in one tile). A(m, k) = ta ? a[k * lda + m]
// : a[m * lda + k], B(k, n) = tb ? b[n * ldb + k] : b[k * ldb + n] (not
// both transposed: no product of the scans needs it).
//
// Design. One CTA of 256 threads a BM x BN tile, 8 warps as 2 (rows) x 4
// (columns) of 32 x 16. The operands come in as bf16 through a
// STAGES-deep cp.async ring (16 bytes a copy: 8 bf16 along the operand's
// contiguous side, zero-filled past its edge; element by element where a
// row is not 16-byte aligned), each chunk BK deep, stored with its
// contiguous side padded by 8 (rows 144 bytes apart: ldmatrix reads
// without bank conflicts). Fragments come from ldmatrix.x4, transposed
// where the stored side is not the fragment's (A stored [k][m], B stored
// [k][n]). The accumulators go through shared memory to the epilogue,
// which writes rows with consecutive threads on consecutive columns. Each
// output has one owner and a fixed sum order (segments, then depth in
// order): a second call repeats the first bit for bit.
//
// Bound: operations at the bf16 tensor rate (989 TFLOP/s dense on the
// H100 SXM) where the depth is large, else the bytes of the operands and
// outputs at the memory rate; the replay's is chip_smoke.py's
// _dec_scan_bf16_bound("replay", ...).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace vag {
namespace bt {

constexpr int THREADS = 256;
constexpr int BM = 64, BN = 64;   // a tile's rows and columns
constexpr int BK = 64;            // depth of a stage's chunk
constexpr int STAGES = 3;
constexpr int LD = 72;            // row stride (bf16) of a stored chunk: 64 + 8
constexpr int HALF = 64 * LD;     // bf16 of one operand's chunk, either layout
constexpr int STAGE = 2 * HALF;   // A then B
constexpr int ES = BN + 4;        // row stride (fp32) of the epilogue's tile
constexpr int GATE_UNITS = 16;    // units of a gate tile: 3 x 16 columns of BN
constexpr size_t SMEM_BYTES = sizeof(__nv_bfloat16) * STAGES * STAGE;
static_assert(BM == 64 && BN == 64 && BK == 64, "the stored chunks are 64 x 64");
static_assert(sizeof(float) * BM * ES <= SMEM_BYTES, "the epilogue reuses the ring");
static_assert(3 * GATE_UNITS <= BN, "a gate tile's columns fit the tile");

typedef __nv_bfloat16 bf16;

enum Epi { STORE = 0, BIAS = 1, TANH_ADD = 2, GRU1 = 3, GRU_COEF = 4 };

struct Seg {
  const bf16* a;
  const bf16* b;
  int lda, ldb, K;
};

// One job (see the top). N: output columns, or (GRU1, GRU_COEF) units: its
// tiles are gate tiles of GATE_UNITS units, tile column j < 3 GATE_UNITS
// reading W's column (j / GATE_UNITS) H + u0 + j % GATE_UNITS (N = H).
// Outputs: out (fp32) and / or outb (bf16), row stride ldo. add: BIAS the
// bias (N), TANH_ADD an (M, ldo) array added before the tanh, GRU1 and
// GRU_COEF the bias (3H). GRU1 also reads xg (M, 3H, bf16) and h (M, H,
// fp32) and writes hg = acc + bias to out (M, 3H), the cell's state to
// out2 (M, H, fp32) and to outb (bf16). GRU_COEF reads xg, the mask m (M,
// fp32) and the state the row's step started from (h, or where h is null
// the bf16 A operand's row: A is those states) and writes gru_unit_coef's
// five coefficients of hg = acc + bias to out (M, 5H: coefficient k at
// column k H + u).
struct Job {
  Seg s[2];
  int nseg, M, N, ta, tb, epi;
  float* out;
  bf16* outb;
  int ldo;
  const float* add;
  const bf16* xg;
  const float* h;
  float* out2;
  const float* m;
};

// Up to 7 jobs of one grid (a kernel argument), their tiles in job order.
struct Jobs {
  Job j[7];
  int n;
};

__host__ __device__ inline int tile_cols(const Job& j) {
  return j.epi == GRU1 || j.epi == GRU_COEF ? GATE_UNITS : BN;
}
__host__ __device__ inline int job_tiles(const Job& j) {
  return ((j.M + BM - 1) / BM) * ((j.N + tile_cols(j) - 1) / tile_cols(j));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first index (row or column of x) of the 8 tile-side indices i ..
// i + 7 (i a multiple of 8) of a tile starting at s0, and how many of them
// are inside (0..8). gate: W's gate-tile columns (see Job).
__device__ __forceinline__ int side_run(int i, int s0, int side_n, bool gate, int H,
                                        int& n) {
  if (gate) {
    const int u = s0 + i % GATE_UNITS;
    n = i < 3 * GATE_UNITS ? max(0, min(8, H - u)) : 0;
    return (i / GATE_UNITS) * H + u;
  }
  n = max(0, min(8, side_n - s0 - i));
  return s0 + i;
}

// Eight bf16 from p (n of them inside, zero after) into shared memory at
// d: one cp.async where p is 16-byte aligned (x, the operand's base, the
// address of a copy of nothing), else element by element (visible after
// the __syncthreads that follows the ring's wait).
__device__ __forceinline__ void copy8(bf16* d, const bf16* p, int n, const bf16* x) {
  if (n == 0 || (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(d, n ? p : x, 2 * n);
    return;
  }
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
  unsigned int h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < n ? __ldcg(ps + e) : 0u;
  *reinterpret_cast<uint4*>(d) = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                                            h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

// Depths [k0, k0 + BK) of one operand's tile side (64 rows of A, or 64
// columns of B) into a stored chunk: k_contig (x(side i, k) = x[idx(i) *
// ld + k]) as [side][k], else (x[k * ld + idx(i)]) as [k][side]; zero past
// the side's edge and past K. Two copies of 8 a thread.
__device__ __forceinline__ void stage(bf16* st, const bf16* x, int ld, bool k_contig,
                                      int s0, int side_n, bool gate, int H, int k0, int K) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = threadIdx.x + c * THREADS;      // 512 runs of 8
    if (k_contig) {
      const int r = i >> 3, kk = (i & 7) * 8;
      int n;
      const int idx = side_run(r & ~7, s0, side_n, gate, H, n) + (r & 7);
      const bool in = (r & 7) < n;
      const int nk = in ? max(0, min(8, K - k0 - kk)) : 0;
      copy8(st + r * LD + kk, x + (size_t)idx * ld + k0 + kk, nk, x);
    } else {
      const int kk = i >> 3, j = (i & 7) * 8;
      int n;
      const int idx = side_run(j, s0, side_n, gate, H, n);
      if (k0 + kk >= K) n = 0;
      copy8(st + kk * LD + j, x + (size_t)(k0 + kk) * ld + idx, n, x);
    }
  }
}

// One BM x BN tile of job j (rows from m0, tile columns from n0: for
// gate tiles units from n0).
template <bool TA, bool TB>
__device__ void tile(const Job& j, int m0, int n0, bf16* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const bool gate = j.epi == GRU1 || j.epi == GRU_COEF;
  const int H = j.N;
  int nq[2] = {0, 0};
  for (int s = 0; s < j.nseg; ++s) nq[s] = (j.s[s].K + BK - 1) / BK;
  const int n_chunks = nq[0] + nq[1];
  auto load = [&](int q, bf16* st) {
    const int s = q < nq[0] ? 0 : 1;
    const int k0 = (q - (s ? nq[0] : 0)) * BK;
    const Seg& g = j.s[s];
    stage(st, g.a, g.lda, !TA, m0, j.M, false, 0, k0, g.K);
    stage(st + HALF, g.b, g.ldb, TB, n0, j.N, gate, H, k0, g.K);
  };
  float acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < n_chunks) load(q, smem + q * STAGE);
    commit();
  }
  // ldmatrix lane roles: matrix mat = lane / 8, its row r = lane % 8
  const int mat = lane >> 3, r = lane & 7;
  for (int q = 0; q < n_chunks; ++q) {
    wait_group<STAGES - 2>();
    __syncthreads();
    const int qn = q + STAGES - 1;
    if (qn < n_chunks) load(qn, smem + (qn % STAGES) * STAGE);
    commit();
    const bf16* as = smem + (q % STAGES) * STAGE;
    const bf16* bs = as + HALF;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bf[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = wm * 32 + mi * 16 + (mat & 1) * 8;
        const int k = ks + (mat >> 1) * 8;
        if (TA) ldsm4<true>(af[mi], as + (k + r) * LD + m);
        else ldsm4<false>(af[mi], as + (m + r) * LD + k);
      }
      {
        const int n = wn * 16 + (mat >> 1) * 8, k = ks + (mat & 1) * 8;
        if (TB) ldsm4<false>(bf, bs + (n + r) * LD + k);
        else ldsm4<true>(bf, bs + (k + r) * LD + n);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma16(acc[mi][ni], af[mi], bf[2 * ni], bf[2 * ni + 1]);
    }
  }
  wait_group<0>();
  __syncthreads();   // the ring is free: the accumulators go through it
  float* et = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mi * 16 + g + 8 * h, col = wn * 16 + ni * 8 + 2 * tg;
          *reinterpret_cast<float2*>(et + row * ES + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
  }
  __syncthreads();
  if (j.epi == GRU_COEF) {   // hg = acc + bias, then the cell's coefficients
    const int H3 = 3 * H;
    for (int i = tid; i < BM * GATE_UNITS; i += THREADS) {
      const int rr = i / GATE_UNITS, uu = i % GATE_UNITS, row = m0 + rr, u = n0 + uu;
      if (row >= j.M || u >= H) continue;
      float hg[3], x[3], c[5];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        hg[k] = et[rr * ES + k * GATE_UNITS + uu] + __ldg(j.add + k * H + u);
        x[k] = __bfloat162float(j.xg[(size_t)row * H3 + k * H + u]);
      }
      const float h = j.h ? __ldg(j.h + (size_t)row * H + u)
                          : __bfloat162float(j.s[0].a[(size_t)row * j.s[0].lda + u]);
      vag::gru_unit_coef(x[0], x[1], x[2], hg[0], hg[1], hg[2], h, __ldg(j.m + row), c);
#pragma unroll
      for (int k = 0; k < 5; ++k) j.out[(size_t)row * j.ldo + k * H + u] = c[k];
    }
    return;
  }
  if (gate) {   // hg = acc + bias, then GRU1's cell: s~ in fp32 and bf16
    const int H3 = 3 * H;
    for (int i = tid; i < BM * GATE_UNITS; i += THREADS) {
      const int rr = i / GATE_UNITS, uu = i % GATE_UNITS, row = m0 + rr, u = n0 + uu;
      if (row >= j.M || u >= H) continue;
      float hg[3], x[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const size_t o = (size_t)row * H3 + k * H + u;
        hg[k] = et[rr * ES + k * GATE_UNITS + uu] + __ldg(j.add + k * H + u);
        j.out[o] = hg[k];
        x[k] = __bfloat162float(j.xg[o]);
      }
      const size_t oh = (size_t)row * H + u;
      const float st = gru_unit(x[0], x[1], x[2], hg[0], hg[1], hg[2], __ldg(j.h + oh));
      j.out2[oh] = st;
      j.outb[oh] = __float2bfloat16_rn(st);
    }
    return;
  }
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int rr = i / BN, cc = i % BN, row = m0 + rr, col = n0 + cc;
    if (row >= j.M || col >= j.N) continue;
    const size_t o = (size_t)row * j.ldo + col;
    float v = et[rr * ES + cc];
    if (j.epi == BIAS) v += __ldg(j.add + col);
    else if (j.epi == TANH_ADD) v = tanhf(__ldg(j.add + o) + v);
    if (j.out) j.out[o] = v;
    if (j.outb) j.outb[o] = __float2bfloat16_rn(v);
  }
}

// The body of a grid of tiles: one CTA a tile, tile i of the jobs in
// order, SMEM_BYTES of dynamic shared memory. Each kernel source wraps it
// in grids named after itself (the profiles sum a kernel's device time by
// name), launched by launch.
__device__ __forceinline__ void run(const Jobs& js) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  int ji = 0, rest = blockIdx.x;
  while (rest >= job_tiles(js.j[ji])) rest -= job_tiles(js.j[ji++]);
  const Job& j = js.j[ji];
  const int tc = tile_cols(j);
  const int nt = (j.N + tc - 1) / tc, m0 = rest / nt * BM, n0 = rest % nt * tc;
  if (j.ta) tile<true, false>(j, m0, n0, smem);
  else if (j.tb) tile<false, true>(j, m0, n0, smem);
  else tile<false, false>(j, m0, n0, smem);
}

// Enqueues kern (a grid around run) over every tile of js on s; refuses
// a job with both operands transposed.
inline cudaError_t launch(void (*kern)(Jobs), const Jobs& js, cudaStream_t s) {
  int tiles = 0;
  for (int i = 0; i < js.n; ++i) {
    if (js.j[i].ta && js.j[i].tb) return cudaErrorInvalidValue;
    tiles += job_tiles(js.j[i]);
  }
  if (tiles == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kern<<<tiles, THREADS, SMEM_BYTES, s>>>(js);
  return cudaGetLastError();
}

}  // namespace bt
}  // namespace vag
