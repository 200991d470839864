// Fused readout GEMM -> per-row log-sum-exp + top-K, for Hopper (sm_90a),
// plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_readout_topk.py, _kernel (entry
// fused_readout_topk), at full slot depth K, the beam-search vocab step.
//
// For each of R rows (R = sentences * beams) it computes, without writing
// the (R, V) logits to device memory:
//   logits = t @ W + b      (t (R, E), W (E, V) row-major, b (V,)), fp32 FMA
//   banned ids (optional (R, V) uint8 mask) floored to FLOOR = -3e38
//   vals/idx = top-K of the row's logits, ties to the smaller vocab id
//   lse      = log-sum-exp of the same (floored) logits
// The live/frozen candidate rules and the K*K -> K cross-beam combine stay
// in PyTorch (ops/readout_topk.py::_combine), as in the JAX package.
//
// Bound on this card at the main path's shape (R=640, E=256, V=8000, K=5):
// 2.62 GFLOP of fp32 FMA against 8.9 MB of inputs, so it is bound by
// operations: ~39 us at the H100 SXM's 67 TFLOP/s fp32. W (8.2 MB) stays
// resident in the 50 MB L2 across beam steps.
//
// Design: the TPU kernel walks the vocab in order on one core and carries
// the running state in scratch. Here blocks run in parallel in no order, so
// the work is two passes (two grids per call):
//  pass 1: grid (row tiles of RT rows) x (vocab splits). A block stages its
//    t rows in shared memory, streams W column tiles (CT columns, EC-deep
//    chunks) through shared memory, and each thread keeps, for its RPT rows
//    and its CPT columns of every tile (a "lane", as on the TPU), a running
//    top-K (branch-free insertion with the (value, smaller id) order) and
//    an online (max, sum-exp). The block then merges its lanes per row and
//    writes K candidates plus (m, s) per row per split.
//  pass 2: one thread per row merges the splits: top-K with the same order,
//    lse = M + log(sum_i s_i * exp(m_i - M)).
// Columns past V are masked (V need not be a multiple of any tile). Simple
// and right first: wgmma / 3xTF32 products are later work.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// The wrapper (ops/readout_topk.py) owns the tiling that its split plan
// relies on and passes it here as -D defines when it builds this file.
#if !defined(VAG_RT) || !defined(VAG_CT) || !defined(VAG_MAX_K)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_RT, VAG_CT, VAG_MAX_K)"
#endif

constexpr float FLOOR = -3.0e38f;
constexpr int RT = VAG_RT;             // rows per block (32)
constexpr int CT = VAG_CT;             // vocab columns per tile (64)
constexpr int EC = 32;                 // depth of a staged W chunk
constexpr int THREADS = 256;
constexpr int CPT = 4;                 // columns per thread per tile (float4)
constexpr int TX = CT / CPT;           // 16 lanes per row
constexpr int RPT = RT / (THREADS / TX);  // 2 rows per thread
constexpr int MAX_K = VAG_MAX_K;
static_assert(CT % CPT == 0 && THREADS % TX == 0 && RT % (THREADS / TX) == 0,
              "tiling: CT a multiple of 4, RT a multiple of THREADS / TX");

using vag::insert;

template <int K>
size_t pass1_smem(int E) {
  return sizeof(float) * ((size_t)RT * (E + 1) + EC * CT)
       + (sizeof(float) + sizeof(int)) * (size_t)RT * TX * K
       + 2 * sizeof(float) * RT * TX;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
readout_topk_pass1(const float* __restrict__ t, const float* __restrict__ w,
                   const float* __restrict__ b,
                   const uint8_t* __restrict__ ban,
                   float* __restrict__ part_v, int* __restrict__ part_i,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   int R, int E, int V, int split_cols) {
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;                              // [RT][E + 1]
  float* ws = ts + (size_t)RT * (E + 1);         // [EC][CT]
  float* cv = ws + EC * CT;                      // [RT][TX * K]
  int* ci = reinterpret_cast<int*>(cv + RT * TX * K);
  float* cm = reinterpret_cast<float*>(ci + RT * TX * K);  // [RT][TX]
  float* cs = cm + RT * TX;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * RT;
  const int split = blockIdx.y;
  const int col_begin = split * split_cols;
  const int col_end = min(V, col_begin + split_cols);

  for (int i = tid; i < RT * E; i += THREADS) {
    const int r = i / E, e = i % E;
    const int row = row0 + r;
    ts[r * (E + 1) + e] = row < R ? t[(size_t)row * E + e] : 0.f;
  }

  float sv[RPT][K], m[RPT], s[RPT];
  int si[RPT][K];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = FLOOR;
    s[r] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sv[r][k] = FLOOR;
      si[r][k] = INT_MAX;
    }
  }

  for (int c0 = col_begin; c0 < col_end; c0 += CT) {
    float acc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;

    for (int e0 = 0; e0 < E; e0 += EC) {
      __syncthreads();  // t staged / the previous W chunk consumed
      for (int i = tid; i < EC * CT; i += THREADS) {
        const int ee = i / CT, c = i % CT;
        const int e = e0 + ee, col = c0 + c;
        ws[i] = (e < E && col < col_end) ? w[(size_t)e * V + col] : 0.f;
      }
      __syncthreads();
      const int ne = min(EC, E - e0);
      for (int ee = 0; ee < ne; ++ee) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[ee * CT + tx * CPT]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float a = ts[(ty * RPT + r) * (E + 1) + e0 + ee];
          acc[r][0] = fmaf(a, wv.x, acc[r][0]);
          acc[r][1] = fmaf(a, wv.y, acc[r][1]);
          acc[r][2] = fmaf(a, wv.z, acc[r][2]);
          acc[r][3] = fmaf(a, wv.w, acc[r][3]);
        }
      }
    }

    // Fold this tile's CPT columns into each row's lane state.
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + ty * RPT + r;
      float x[CPT];
      float tmax = FLOOR;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + tx * CPT + j;
        x[j] = FLOOR;
        if (col < col_end) {
          x[j] = acc[r][j] + b[col];
          if (ban != nullptr && row < R && ban[(size_t)row * V + col]) x[j] = FLOOR;
          tmax = fmaxf(tmax, x[j]);
        }
      }
      const float m_new = fmaxf(m[r], tmax);
      float acc_s = s[r] * expf(m[r] - m_new);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + tx * CPT + j;
        if (col < col_end) {
          acc_s += expf(x[j] - m_new);
          insert<K>(sv[r], si[r], x[j], col);
        }
      }
      m[r] = m_new;
      s[r] = acc_s;
    }
  }

  // Merge the TX lanes of each row.
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lr = ty * RPT + r;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cv[(lr * TX + tx) * K + k] = sv[r][k];
      ci[(lr * TX + tx) * K + k] = si[r][k];
    }
    cm[lr * TX + tx] = m[r];
    cs[lr * TX + tx] = s[r];
  }
  __syncthreads();
  if (tid < RT) {
    const int row = row0 + tid;
    if (row < R) {
      float bv[K];
      int bi[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        bv[k] = FLOOR;
        bi[k] = INT_MAX;
      }
      float M = FLOOR;
      for (int j = 0; j < TX; ++j) {
        for (int k = 0; k < K; ++k)
          insert<K>(bv, bi, cv[(tid * TX + j) * K + k], ci[(tid * TX + j) * K + k]);
        M = fmaxf(M, cm[tid * TX + j]);
      }
      float S = 0.f;
      for (int j = 0; j < TX; ++j) S += cs[tid * TX + j] * expf(cm[tid * TX + j] - M);
      const size_t o = (size_t)split * R + row;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        part_v[o * K + k] = bv[k];
        part_i[o * K + k] = bi[k];
      }
      part_m[o] = M;
      part_s[o] = S;
    }
  }
}

template <int K>
__global__ void readout_topk_pass2(const float* __restrict__ part_v,
                                   const int* __restrict__ part_i,
                                   const float* __restrict__ part_m,
                                   const float* __restrict__ part_s,
                                   float* __restrict__ vals,
                                   int* __restrict__ idx,
                                   float* __restrict__ lse, int R,
                                   int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float bv[K];
  int bi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bv[k] = FLOOR;
    bi[k] = INT_MAX;
  }
  float M = FLOOR;
  for (int sp = 0; sp < n_split; ++sp) {
    const size_t o = (size_t)sp * R + row;
    for (int k = 0; k < K; ++k) insert<K>(bv, bi, part_v[o * K + k], part_i[o * K + k]);
    M = fmaxf(M, part_m[o]);
  }
  float S = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const size_t o = (size_t)sp * R + row;
    S += part_s[o] * expf(part_m[o] - M);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    vals[(size_t)row * K + k] = bv[k];
    idx[(size_t)row * K + k] = bi[k];
  }
  lse[row] = M + logf(S);
}

template <int K>
int launch(const float* t, const float* w, const float* b, const uint8_t* ban,
           float* part_v, int* part_i, float* part_m, float* part_s,
           float* vals, int* idx, float* lse, int R, int E, int V,
           int n_split, int split_cols, cudaStream_t stream) {
  const size_t smem = pass1_smem<K>(E);
  cudaError_t e = cudaFuncSetAttribute(
      readout_topk_pass1<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid1((R + RT - 1) / RT, n_split);
  readout_topk_pass1<K><<<grid1, THREADS, smem, stream>>>(
      t, w, b, ban, part_v, part_i, part_m, part_s, R, E, V, split_cols);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  readout_topk_pass2<K><<<(R + 127) / 128, 128, 0, stream>>>(
      part_v, part_i, part_m, part_s, vals, idx, lse, R, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Device pointers to contiguous tensors: t (R, E) f32, w (E, V) f32,
// b (V,) f32, ban (R, V) uint8 or null; partials part_v/part_i (n_split, R,
// K), part_m/part_s (n_split, R); outputs vals (R, K) f32, idx (R, K) i32,
// lse (R,) f32. split_cols is a multiple of CT and
// n_split * split_cols >= V. 1 <= K <= 8. Returns 0 or a CUDA error code.
extern "C" int readout_topk_launch(const void* t, const void* w, const void* b,
                                   const void* ban, void* part_v, void* part_i,
                                   void* part_m, void* part_s, void* vals,
                                   void* idx, void* lse, int R, int E, int V,
                                   int K, int n_split, int split_cols,
                                   void* stream) {
  if (split_cols % CT != 0 || (long long)n_split * split_cols < V)
    return (int)cudaErrorInvalidValue;
  const float* tf = static_cast<const float*>(t);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const uint8_t* bn = static_cast<const uint8_t*>(ban);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  float* vf = static_cast<float*>(vals);
  int* ix = static_cast<int*>(idx);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VAG_READOUT_CASE(KK)                                                  \
  case KK:                                                                    \
    return launch<KK>(tf, wf, bf, bn, pv, pi, pm, ps, vf, ix, lf, R, E, V,    \
                      n_split, split_cols, s);
  switch (K) {
    VAG_READOUT_CASE(1)
    VAG_READOUT_CASE(2)
    VAG_READOUT_CASE(3)
    VAG_READOUT_CASE(4)
    VAG_READOUT_CASE(5)
    VAG_READOUT_CASE(6)
    VAG_READOUT_CASE(7)
    VAG_READOUT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VAG_READOUT_CASE
}

static_assert(MAX_K == 8, "the K switch above instantiates 1..MAX_K");
