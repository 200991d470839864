// Fused readout GEMM -> per-row log-sum-exp + top-K, for Hopper (sm_90a),
// plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_readout_topk.py, _kernel (entry
// fused_readout_topk), the beam-search vocab step, at full slot depth K and
// in its shallow-slot watermark mode (slot depth SK < K, VAG_FRT_SLOTS).
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
// Bound on this card: 2 R E V fp32 FMA operations against R E + E V + V
// input floats, so bound by operations, independent of SK: at R=640, E=256
// it is 2.62 GFLOP, ~39 us at the H100 SXM's 67 TFLOP/s fp32, for V=8000,
// and 5.24 GFLOP, ~78 us, for V=16000. W (8.2 / 16.4 MB) stays resident in
// the 50 MB L2 across beam steps.
//
// Design: the TPU kernel walks the vocab in order on one core and carries
// the running state in scratch. Here blocks run in parallel in no order, so
// the work is two passes (two grids per call):
//  pass 1: grid (row tiles of RT rows) x (vocab splits). A block stages its
//    t rows in shared memory, streams W column tiles (CT columns, EC-deep
//    chunks) through shared memory, and each thread keeps, for its RPT rows
//    and its CPT columns of every tile of its split (a "lane": a row has
//    n_split * TX lanes), a running top-SK (branch-free insertion with the
//    (value, smaller id) order) and an online (max, sum-exp). The block then
//    merges its lanes per row and writes K candidates plus (m, s) per row
//    per split.
//  pass 2: one thread per row merges the splits: top-K with the same order,
//    lse = M + log(sum_i s_i * exp(m_i - M)).
// Columns past V are masked (V need not be a multiple of any tile). Simple
// and right first: wgmma / 3xTF32 products are later work.
//
// Shallow slots (SK < K), the TPU kernel's rule with this kernel's lanes: a
// lane keeps SK slots, and its watermark is the largest value it pushed out
// of its last slot (its (SK+1)-th best). Pass 1 also writes each block's
// per-row maximum watermark; pass 2 flags a row (viol) iff the maximum over
// the splits is >= the row's K-th value of the merged shallow union. A row
// that is not flagged has every value outside the union strictly below its
// K-th, so its vals/idx are those of depth K, bit for bit (same sums in the
// same order), and lse does not depend on SK at all.
// Per-step recovery (the TPU's per-step lax.cond, without a host read):
// pass 2 also marks each row tile holding a flagged LIVE row (a frozen
// row's outputs are discarded by _combine) and counts the flagged rows in
// a device counter; a third grid reruns pass 1 at depth K, where blocks of
// unmarked tiles return at once, and a fourth reruns pass 2 on the rows of
// marked tiles only, overwriting vals/idx/lse (and counting the call when
// any tile was marked). A step with nothing flagged so pays two more grid
// launches that exit at once and a memset of the tile marks.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// The wrapper (ops/readout_topk.py) owns the tiling that its split plan and
// lane map rely on and passes it here as -D defines when it builds this file.
#if !defined(VAG_RT) || !defined(VAG_CT) || !defined(VAG_CPT) || !defined(VAG_MAX_K)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_RT, VAG_CT, VAG_CPT, VAG_MAX_K)"
#endif

constexpr float FLOOR = -3.0e38f;
constexpr int RT = VAG_RT;             // rows per block (32)
constexpr int CT = VAG_CT;             // vocab columns per tile (64)
constexpr int EC = 32;                 // depth of a staged W chunk
constexpr int THREADS = 256;
constexpr int CPT = VAG_CPT;           // columns per thread per tile (float4)
constexpr int TX = CT / CPT;           // 16 lanes per row per split
constexpr int RPT = RT / (THREADS / TX);  // 2 rows per thread
constexpr int MAX_K = VAG_MAX_K;
static_assert(CPT == 4, "one float4 of W per thread per tile row");
static_assert(CT % CPT == 0 && THREADS % TX == 0 && RT % (THREADS / TX) == 0,
              "tiling: CT a multiple of 4, RT a multiple of THREADS / TX");

using vag::insert;

template <int SK>
size_t pass1_smem(int E) {
  return sizeof(float) * ((size_t)RT * (E + 1) + EC * CT)
       + (sizeof(float) + sizeof(int)) * (size_t)RT * TX * SK
       + 3 * sizeof(float) * RT * TX;
}

// part_w (the per-row maximum watermark of the block) is written when
// SK < K; blocks of row tiles whose tile_mark is 0 return at once when
// tile_mark is given (the per-step recovery's rerun).
template <int K, int SK>
__global__ void __launch_bounds__(THREADS)
readout_topk_pass1(const float* __restrict__ t, const float* __restrict__ w,
                   const float* __restrict__ b,
                   const uint8_t* __restrict__ ban,
                   const uint8_t* __restrict__ tile_mark,
                   float* __restrict__ part_v, int* __restrict__ part_i,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   float* __restrict__ part_w,
                   int R, int E, int V, int split_cols) {
  static_assert(1 <= SK && SK <= K, "slot depth 1..K");
  if (tile_mark != nullptr && tile_mark[blockIdx.x] == 0) return;
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;                              // [RT][E + 1]
  float* ws = ts + (size_t)RT * (E + 1);         // [EC][CT]
  float* cv = ws + EC * CT;                      // [RT][TX * SK]
  int* ci = reinterpret_cast<int*>(cv + RT * TX * SK);
  float* cm = reinterpret_cast<float*>(ci + RT * TX * SK);  // [RT][TX]
  float* cs = cm + RT * TX;
  float* cw = cs + RT * TX;

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

  float sv[RPT][SK], m[RPT], s[RPT], wm[RPT];
  int si[RPT][SK];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = FLOOR;
    s[r] = 0.f;
    wm[r] = FLOOR;
#pragma unroll
    for (int k = 0; k < SK; ++k) {
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
          const float out = insert<SK>(sv[r], si[r], x[j], col);
          if (SK < K) wm[r] = fmaxf(wm[r], out);
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
    for (int k = 0; k < SK; ++k) {
      cv[(lr * TX + tx) * SK + k] = sv[r][k];
      ci[(lr * TX + tx) * SK + k] = si[r][k];
    }
    cm[lr * TX + tx] = m[r];
    cs[lr * TX + tx] = s[r];
    cw[lr * TX + tx] = wm[r];
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
      float M = FLOOR, W = FLOOR;
      for (int j = 0; j < TX; ++j) {
        for (int k = 0; k < SK; ++k)
          insert<K>(bv, bi, cv[(tid * TX + j) * SK + k], ci[(tid * TX + j) * SK + k]);
        M = fmaxf(M, cm[tid * TX + j]);
        W = fmaxf(W, cw[tid * TX + j]);
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
      if (SK < K) part_w[o] = W;
    }
  }
}

// Merges the splits of each row. With part_w: viol[row] = (maximum
// watermark >= the merged K-th value), and, with live, a flagged live row
// marks its row tile and counts in counts[0]. With only_marked: rows of
// unmarked tiles are left as they are (the recovery's merge), and thread 0
// of block 0 counts the call in counts[1] when any tile is marked.
template <int K>
__global__ void readout_topk_pass2(const float* __restrict__ part_v,
                                   const int* __restrict__ part_i,
                                   const float* __restrict__ part_m,
                                   const float* __restrict__ part_s,
                                   const float* __restrict__ part_w,
                                   float* __restrict__ vals,
                                   int* __restrict__ idx,
                                   float* __restrict__ lse,
                                   int* __restrict__ viol,
                                   const uint8_t* __restrict__ live,
                                   uint8_t* tile_mark, int only_marked,
                                   unsigned long long* counts, int R,
                                   int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (only_marked && row == 0) {
    int any = 0;
    for (int i = 0; i < (R + RT - 1) / RT; ++i) any |= tile_mark[i];
    if (any) atomicAdd(&counts[1], 1ull);
  }
  if (row >= R) return;
  if (only_marked && tile_mark[row / RT] == 0) return;
  float bv[K];
  int bi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bv[k] = FLOOR;
    bi[k] = INT_MAX;
  }
  float M = FLOOR, W = FLOOR;
  for (int sp = 0; sp < n_split; ++sp) {
    const size_t o = (size_t)sp * R + row;
    for (int k = 0; k < K; ++k) insert<K>(bv, bi, part_v[o * K + k], part_i[o * K + k]);
    M = fmaxf(M, part_m[o]);
    if (part_w != nullptr) W = fmaxf(W, part_w[o]);
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
  if (part_w != nullptr) {
    const int flag = W >= bv[K - 1] ? 1 : 0;
    viol[row] = flag;
    if (flag && live != nullptr && live[row]) {
      tile_mark[row / RT] = 1;
      atomicAdd(&counts[0], 1ull);
    }
  }
}

struct Args {
  const float *t, *w, *b;
  const uint8_t* ban;
  float *part_v, *part_m, *part_s, *part_w;
  int* part_i;
  float *vals, *lse;
  int *idx, *viol;
  const uint8_t* live;
  uint8_t* tile_mark;
  unsigned long long* counts;
  int R, E, V, n_split, split_cols;
  cudaStream_t stream;
};

template <int K, int SK>
cudaError_t pass1(const Args& a, const uint8_t* tile_mark) {
  const size_t smem = pass1_smem<SK>(a.E);
  const cudaError_t e = cudaFuncSetAttribute(
      readout_topk_pass1<K, SK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.R + RT - 1) / RT, a.n_split);
  readout_topk_pass1<K, SK><<<grid, THREADS, smem, a.stream>>>(
      a.t, a.w, a.b, a.ban, tile_mark, a.part_v, a.part_i, a.part_m, a.part_s,
      a.part_w, a.R, a.E, a.V, a.split_cols);
  return cudaGetLastError();
}

template <int K>
cudaError_t pass2(const Args& a, bool shallow, bool only_marked) {
  readout_topk_pass2<K><<<(a.R + 127) / 128, 128, 0, a.stream>>>(
      a.part_v, a.part_i, a.part_m, a.part_s, shallow ? a.part_w : nullptr,
      a.vals, a.idx, a.lse, a.viol, a.live, a.tile_mark, only_marked ? 1 : 0,
      a.counts, a.R, a.n_split);
  return cudaGetLastError();
}

template <int K, int SK>
int launch(const Args& a) {
  const bool recover = SK < K && a.live != nullptr;
  if (recover)
    VAG_CHECK(cudaMemsetAsync(a.tile_mark, 0, (a.R + RT - 1) / RT, a.stream));
  VAG_CHECK((pass1<K, SK>(a, nullptr)));
  VAG_CHECK(pass2<K>(a, SK < K, false));
  if (recover) {
    VAG_CHECK((pass1<K, K>(a, a.tile_mark)));
    VAG_CHECK(pass2<K>(a, false, true));
  }
  return 0;
}

}  // namespace

// Device pointers to contiguous tensors: t (R, E) f32, w (E, V) f32,
// b (V,) f32, ban (R, V) uint8 or null; partials part_v/part_i (n_split, R,
// K), part_m/part_s (n_split, R); outputs vals (R, K) f32, idx (R, K) i32,
// lse (R,) f32. split_cols is a multiple of CT and
// n_split * split_cols >= V. 1 <= SK <= K <= 8. With SK < K also part_w
// (n_split, R) f32 and the output viol (R,) i32; for the per-step recovery
// live (R,) uint8, tile_mark (ceil(R / RT),) uint8 scratch and counts (2,)
// int64 (flagged live rows, recovering calls; added to), else null.
// Returns 0 or a CUDA error code.
extern "C" int readout_topk_launch(const void* t, const void* w, const void* b,
                                   const void* ban, void* part_v, void* part_i,
                                   void* part_m, void* part_s, void* part_w,
                                   void* vals, void* idx, void* lse,
                                   void* viol, const void* live,
                                   void* tile_mark, void* counts, int R,
                                   int E, int V, int K, int SK, int n_split,
                                   int split_cols, void* stream) {
  if (split_cols % CT != 0 || (long long)n_split * split_cols < V)
    return (int)cudaErrorInvalidValue;
  if (SK < K && (part_w == nullptr || viol == nullptr ||
                 (live != nullptr && (tile_mark == nullptr || counts == nullptr))))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.t = static_cast<const float*>(t);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.ban = static_cast<const uint8_t*>(ban);
  a.part_v = static_cast<float*>(part_v);
  a.part_i = static_cast<int*>(part_i);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_w = static_cast<float*>(part_w);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int*>(idx);
  a.lse = static_cast<float*>(lse);
  a.viol = static_cast<int*>(viol);
  a.live = static_cast<const uint8_t*>(live);
  a.tile_mark = static_cast<uint8_t*>(tile_mark);
  a.counts = static_cast<unsigned long long*>(counts);
  a.R = R;
  a.E = E;
  a.V = V;
  a.n_split = n_split;
  a.split_cols = split_cols;
  a.stream = static_cast<cudaStream_t>(stream);
#define VAG_CASE(KK, SS) \
  case KK * 16 + SS:     \
    return launch<KK, SS>(a);
  switch (K * 16 + SK) {
    VAG_CASE(1, 1)
    VAG_CASE(2, 1) VAG_CASE(2, 2)
    VAG_CASE(3, 1) VAG_CASE(3, 2) VAG_CASE(3, 3)
    VAG_CASE(4, 1) VAG_CASE(4, 2) VAG_CASE(4, 3) VAG_CASE(4, 4)
    VAG_CASE(5, 1) VAG_CASE(5, 2) VAG_CASE(5, 3) VAG_CASE(5, 4) VAG_CASE(5, 5)
    VAG_CASE(6, 1) VAG_CASE(6, 2) VAG_CASE(6, 3) VAG_CASE(6, 4) VAG_CASE(6, 5)
    VAG_CASE(6, 6)
    VAG_CASE(7, 1) VAG_CASE(7, 2) VAG_CASE(7, 3) VAG_CASE(7, 4) VAG_CASE(7, 5)
    VAG_CASE(7, 6) VAG_CASE(7, 7)
    VAG_CASE(8, 1) VAG_CASE(8, 2) VAG_CASE(8, 3) VAG_CASE(8, 4) VAG_CASE(8, 5)
    VAG_CASE(8, 6) VAG_CASE(8, 7) VAG_CASE(8, 8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VAG_CASE
}

static_assert(MAX_K == 8, "the (K, SK) switch above instantiates 1 <= SK <= K <= MAX_K");
