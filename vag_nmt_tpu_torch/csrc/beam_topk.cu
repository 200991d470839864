// Beam-search candidate scoring + top-K over materialized logits, for
// Hopper (sm_90a), plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_topk.py, _kernel_lanes (entry beam_topk,
// impl="pallas_lanes"), the top-K of the unfused beam step. Per sentence b,
// over its K rows of V logits, with base = scores - lse (scores alone for a
// finished beam) computed by the wrapper with the plain version's torch ops:
//   cand[k, v] = base[k] + logits[k, v]                       (live beam k)
//              = base[k] at v == pad_id, base[k] - 1e9 elsewhere (finished)
// and the K best candidates of the K*V, ordered by (value descending, flat
// index k * V + v ascending): the order of lax.top_k and of the plain
// version's stable sort, so ids and values equal the plain version's.
//
// Bound on this card at the unfused step's shape (B=128, K=5, V=8000): the
// kernel must read the 20.5 MB of logits once, ~6.1 us at 3.35 TB/s, and
// does a few operations per element: bound by bytes.
//
// Design. The TPU kernel walks vocab blocks in order and keeps, per lane, a
// running top-K by a branch-free insertion cascade, merging lanes once at
// the end; the K*K -> K cross-beam combine ran outside it. Here one block
// takes one sentence (its K rows), every thread keeps the cascade in
// registers over a strided slice of each row (coalesced reads, the frozen
// rows' logits not read at all), and the block merges its threads' lists
// pairwise in shared memory (log2(threads) rounds of K insertions). Taking
// the top-K over the sentence's K*V candidates at once is the per-row top-K
// and the combine in one, with the same (value, index) order. Simple first:
// one block per sentence leaves 4 of 132 SMs idle at B=128.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

#if !defined(VAG_MAX_K)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_MAX_K)"
#endif

constexpr float FLOOR = -3.0e38f;
constexpr float NEG_INF = -1e9f;     // ops/topk.py's finished-beam filler
constexpr int THREADS = 256;

using vag::insert;

template <int K>
__global__ void __launch_bounds__(THREADS)
beam_topk_kernel(const float* __restrict__ logits,
                 const float* __restrict__ base,
                 const uint8_t* __restrict__ fin, float* __restrict__ vals,
                 long long* __restrict__ idx, int V, int pad_id) {
  __shared__ float lv[THREADS * K];
  __shared__ int li[THREADS * K];
  const int b = blockIdx.x, tid = threadIdx.x;
  float sv[K];
  int si[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sv[s] = FLOOR;
    si[s] = INT_MAX;
  }
  for (int k = 0; k < K; ++k) {
    const float bs = base[(size_t)b * K + k];
    const int off = k * V;
    if (fin[(size_t)b * K + k]) {
      const float rest = bs + NEG_INF;
      for (int v = tid; v < V; v += THREADS)
        insert<K>(sv, si, v == pad_id ? bs : rest, off + v);
    } else {
      const float* row = logits + ((size_t)b * K + k) * V;
      for (int v = tid; v < V; v += THREADS)
        insert<K>(sv, si, bs + row[v], off + v);
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    lv[tid * K + s] = sv[s];
    li[tid * K + s] = si[s];
  }
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int s = 0; s < K; ++s)
        insert<K>(sv, si, lv[(tid + stride) * K + s], li[(tid + stride) * K + s]);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        lv[tid * K + s] = sv[s];
        li[tid * K + s] = si[s];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      vals[(size_t)b * K + s] = sv[s];
      idx[(size_t)b * K + s] = si[s];
    }
  }
}

template <int K>
int launch(const float* logits, const float* base, const uint8_t* fin,
           float* vals, long long* idx, int B, int V, int pad_id,
           cudaStream_t stream) {
  beam_topk_kernel<K><<<B, THREADS, 0, stream>>>(logits, base, fin, vals, idx,
                                                 V, pad_id);
  return (int)cudaGetLastError();
}

}  // namespace

// Device pointers to contiguous tensors: logits (B, K, V) f32, base (B, K)
// f32, fin (B, K) uint8; outputs vals (B, K) f32 descending, idx (B, K)
// int64 flat indices k * V + v. 1 <= K <= VAG_MAX_K, K * V < 2^31.
// Returns 0 or a CUDA error code.
extern "C" int beam_topk_launch(const void* logits, const void* base,
                                const void* fin, void* vals, void* idx, int B,
                                int K, int V, int pad_id, void* stream) {
  if (B <= 0) return 0;
  if (V <= 0 || (long long)K * V >= INT_MAX) return (int)cudaErrorInvalidValue;
  const float* lg = static_cast<const float*>(logits);
  const float* bs = static_cast<const float*>(base);
  const uint8_t* fn = static_cast<const uint8_t*>(fin);
  float* vf = static_cast<float*>(vals);
  long long* ix = static_cast<long long*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VAG_TOPK_CASE(KK) \
  case KK:                \
    return launch<KK>(lg, bs, fn, vf, ix, B, V, pad_id, s);
  switch (K) {
    VAG_TOPK_CASE(1)
    VAG_TOPK_CASE(2)
    VAG_TOPK_CASE(3)
    VAG_TOPK_CASE(4)
    VAG_TOPK_CASE(5)
    VAG_TOPK_CASE(6)
    VAG_TOPK_CASE(7)
    VAG_TOPK_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VAG_TOPK_CASE
}

static_assert(VAG_MAX_K == 8, "the K switch above instantiates 1..VAG_MAX_K");
