// Device code shared by the kernels: a tiled fp32 GEMM with optional
// transposes, bias, accumulation and split-K, the GRU cell forward and
// backward as elementwise grids, a deterministic column sum (gru_bwd.cu,
// dec_scan_fwd.cu, dec_scan_bwd.cu, dec_step.cu); warp reductions (the
// attention grids); and the branch-free running top-K insertion ordered by
// (value descending, index ascending) (readout_topk.cu, beam_topk.cu).
// Everything is fp32 FMA (no TF32), each output written by one thread, sums
// taken in a fixed order (the only atomic is split-K's arrival ticket, which
// orders nothing), so the results do not change from run to run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace vag {

constexpr int GEMM_BM = 64;      // output rows per block
constexpr int GEMM_BN = 64;      // output columns per block
constexpr int GEMM_BK = 16;      // depth chunk staged in shared memory
constexpr int GEMM_THREADS = 256;
constexpr int EW_THREADS = 256;  // elementwise grids

// Scratch for split-K GEMMs, allocated by the caller: `work` holds the
// splits' partial sums, `counters` (zero on entry, and left zero) one
// arrival ticket per output tile. With work == nullptr every GEMM runs
// unsplit.
struct Workspace {
  float* work;
  long long floats;
  unsigned int* counters;
  int n_counters;
};

// C[m, n] = (beta ? C[m, n] : 0) + (bias ? bias[n] : 0) + sum_k A(m, k) B(k, n)
// with A(m, k) = TA ? A[k * lda + m] : A[m * lda + k] and
//      B(k, n) = TB ? B[n * ldb + k] : B[k * ldb + n].
// Each thread owns a 4 x 4 grid of outputs (rows ty + 16 i, columns
// tx + 16 j), summed in k order. Used with beta and bias never together.
//
// Split-K (gridDim.z > 1), for the per-step products whose 64 batch rows
// give too few output tiles to fill the card: block z sums the depth chunk
// [z * kchunk, (z + 1) * kchunk) and parks it in `work`; the last block of
// a tile to arrive (an atomic ticket) adds the parked partials in split
// order and writes C. The order of every sum is fixed, so the result does
// not change from run to run.
template <bool TA, bool TB>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(int M, int N, int K, int kchunk, const float* __restrict__ A,
            int lda, const float* __restrict__ B, int ldb, float* C, int ldc,
            const float* __restrict__ bias, int beta, float* work,
            unsigned int* counters) {
  __shared__ float As[GEMM_BK][GEMM_BM + 1];
  __shared__ float Bs[GEMM_BK][GEMM_BN + 1];
  __shared__ unsigned int ticket;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GEMM_BK) {
    // neighbouring threads read neighbouring addresses in either layout
    for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
      int m, k;
      if (TA) { k = i / GEMM_BM; m = i % GEMM_BM; }
      else    { m = i / GEMM_BK; k = i % GEMM_BK; }
      const int gm = m0 + m, gk = k0 + k;
      float v = 0.f;
      if (gm < M && gk < ke)
        v = TA ? A[(size_t)gk * lda + gm] : A[(size_t)gm * lda + gk];
      As[k][m] = v;
    }
    for (int i = tid; i < GEMM_BN * GEMM_BK; i += GEMM_THREADS) {
      int n, k;
      if (TB) { n = i / GEMM_BK; k = i % GEMM_BK; }
      else    { k = i / GEMM_BN; n = i % GEMM_BN; }
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.f;
      if (gn < N && gk < ke)
        v = TB ? B[(size_t)gn * ldb + gk] : B[(size_t)gk * ldb + gn];
      Bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int splits = gridDim.z;
  if (splits > 1) {
    float* mine = work + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gm < M && gn < N) mine[(size_t)gm * N + gn] = acc[i][j];
      }
    }
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) ticket = atomicAdd(&counters[tile], 1u);
    __syncthreads();
    if (ticket != (unsigned int)(splits - 1)) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gm >= M || gn >= N) continue;
        float v = 0.f;
        for (int z = 0; z < splits; ++z)
          v += __ldcg(work + ((size_t)z * M + gm) * N + gn);
        acc[i][j] = v;
      }
    }
    if (tid == 0) counters[tile] = 0u;     // ready for the next launch
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[gn];
      float* c = C + (size_t)gm * ldc + gn;
      if (beta) v = *c + v;
      *c = v;
    }
  }
}

constexpr int TARGET_BLOCKS = 264;   // two blocks per SM of the H100 SXM
constexpr int MIN_KCHUNK = 128;

template <bool TA, bool TB>
inline cudaError_t gemm(cudaStream_t s, const Workspace& ws, int M, int N,
                        int K, const float* A, int lda, const float* B,
                        int ldb, float* C, int ldc, const float* bias,
                        bool beta) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int gx = (N + GEMM_BN - 1) / GEMM_BN, gy = (M + GEMM_BM - 1) / GEMM_BM;
  const int tiles = gx * gy;
  int splits = 1;
  if (ws.work && tiles < TARGET_BLOCKS && tiles <= ws.n_counters) {
    splits = min((TARGET_BLOCKS + tiles - 1) / tiles, max(1, K / MIN_KCHUNK));
    while (splits > 1 && (long long)splits * M * N > ws.floats) --splits;
  }
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
  splits = max(1, (K + kchunk - 1) / kchunk);
  const dim3 grid(gx, gy, splits);
  gemm_kernel<TA, TB><<<grid, GEMM_THREADS, 0, s>>>(
      M, N, K, kchunk, A, lda, B, ldb, C, ldc, bias, beta ? 1 : 0, ws.work,
      ws.counters);
  return cudaGetLastError();
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// GRU cell on precomputed gates (reset gate after the hidden matmul):
// out = (1 - z) n + z h with h/out (rows, H) and the gate pre-activations
// read from row r of xg and hg at row strides ldx and ldh (3H when packed),
// each plus an optional (3H,) bias added first (xb / hb, or nullptr).
__global__ void gru_cell_kernel(const float* __restrict__ xg, int ldx,
                                const float* __restrict__ xb,
                                const float* __restrict__ hg, int ldh,
                                const float* __restrict__ hb,
                                const float* __restrict__ h,
                                float* __restrict__ out, int rows, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * H) return;
  const int row = i / H, u = i % H;
  const float* x = xg + (size_t)row * ldx;
  const float* g = hg + (size_t)row * ldh;
  float xv[3], gv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    xv[j] = xb ? x[j * H + u] + xb[j * H + u] : x[j * H + u];
    gv[j] = hb ? g[j * H + u] + hb[j * H + u] : g[j * H + u];
  }
  const float r = sigmoidf_(xv[0] + gv[0]);
  const float z = sigmoidf_(xv[1] + gv[1]);
  const float n = tanhf(xv[2] + r * gv[2]);
  out[i] = (1.f - z) * n + z * h[i];
}

// Backward through one GRU cell, term for term as the TPU kernel
// (vag_nmt_tpu/ops/pallas_gru.py, _bwd_kernel):
//   dh = dh_in + g;  dh_cell = dh m  (m = mask[row], 1 without a mask)
//   dxg = [da_r, da_z, da_n],  dhg = [da_r, da_z, da_n r]
//   dh_out = dh_cell z + dh (1 - m)      (the dhg @ Uh^T term is added by
//                                          a GEMM afterwards)
// dh_out may alias dh_in (each element is read, then written, by one thread).
__global__ void gru_cell_bwd_kernel(const float* __restrict__ xg,
                                    const float* __restrict__ hg,
                                    const float* __restrict__ h,
                                    const float* __restrict__ mask,
                                    const float* dh_in,
                                    const float* __restrict__ g,
                                    float* __restrict__ dxg,
                                    float* __restrict__ dhg, float* dh_out,
                                    int rows, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * H) return;
  const int row = i / H, u = i % H;
  const size_t o = (size_t)row * 3 * H;
  const float* x = xg + o;
  const float* hh = hg + o;
  const float r = sigmoidf_(x[u] + hh[u]);
  const float z = sigmoidf_(x[H + u] + hh[H + u]);
  const float hn = hh[2 * H + u];
  const float n = tanhf(x[2 * H + u] + r * hn);
  const float dh = g ? dh_in[i] + g[i] : dh_in[i];
  const float m = mask ? mask[row] : 1.f;
  const float dh_cell = dh * m;
  const float dn = dh_cell * (1.f - z);
  const float dz = dh_cell * (h[i] - n);
  const float da_n = dn * (1.f - n * n);
  const float dr = da_n * hn;
  const float da_r = dr * r * (1.f - r);
  const float da_z = dz * z * (1.f - z);
  dxg[o + u] = da_r;
  dxg[o + H + u] = da_z;
  dxg[o + 2 * H + u] = da_n;
  dhg[o + u] = da_r;
  dhg[o + H + u] = da_z;
  dhg[o + 2 * H + u] = da_n * r;
  dh_out[i] = dh_cell * z + dh * (1.f - m);
}

inline cudaError_t gru_cell(cudaStream_t s, const float* xg, int ldx,
                            const float* xb, const float* hg, int ldh,
                            const float* hb, const float* h, float* out,
                            int rows, int H) {
  const int n = rows * H;
  gru_cell_kernel<<<(n + EW_THREADS - 1) / EW_THREADS, EW_THREADS, 0, s>>>(
      xg, ldx, xb, hg, ldh, hb, h, out, rows, H);
  return cudaGetLastError();
}

// Packed gates (row stride 3H), biases already added.
inline cudaError_t gru_cell(cudaStream_t s, const float* xg, const float* hg,
                            const float* h, float* out, int rows, int H) {
  return gru_cell(s, xg, 3 * H, nullptr, hg, 3 * H, nullptr, h, out, rows, H);
}

inline cudaError_t gru_cell_bwd(cudaStream_t s, const float* xg,
                                const float* hg, const float* h,
                                const float* mask, const float* dh_in,
                                const float* g, float* dxg, float* dhg,
                                float* dh_out, int rows, int H) {
  const int n = rows * H;
  gru_cell_bwd_kernel<<<(n + EW_THREADS - 1) / EW_THREADS, EW_THREADS, 0, s>>>(
      xg, hg, h, mask, dh_in, g, dxg, dhg, dh_out, rows, H);
  return cudaGetLastError();
}

// out[n] = sum over r of X[r * N + n], rows in order: one thread a column.
__global__ void colsum_kernel(const float* __restrict__ X, int R, int N,
                              float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += X[(size_t)r * N + n];
  out[n] = acc;
}

inline cudaError_t colsum(cudaStream_t s, const float* X, int R, int N,
                          float* out) {
  colsum_kernel<<<(N + EW_THREADS - 1) / EW_THREADS, EW_THREADS, 0, s>>>(
      X, R, N, out);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The running top-K order: value descending, then index ascending (the
// order of lax.top_k and of a stable descending sort).
__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Sinks (x, xi) through the K slots kept sorted by `better`; branch-free.
template <int K>
__device__ __forceinline__ void insert(float (&sv)[K], int (&si)[K], float x,
                                       int xi) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool gt = better(x, xi, sv[s], si[s]);
    const float tv = gt ? sv[s] : x;
    const int ti = gt ? si[s] : xi;
    sv[s] = gt ? x : sv[s];
    si[s] = gt ? xi : si[s];
    x = tv;
    xi = ti;
  }
}

#define VAG_CHECK(expr)                              \
  do {                                               \
    const cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

}  // namespace vag
