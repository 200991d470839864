// The two legacy beam top-K kernels over materialized logits, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: vag_nmt_tpu/ops/topk_legacy.py, _kernel (gen 1, entry
// legacy_beam_topk, beam_topk(impl="pallas")) and _kernel_rows (gen 2,
// impl="pallas_rows"). Both take beam_topk's candidates, with
// base = scores - lse (scores alone for a finished beam) computed by the
// wrapper with the plain version's torch ops:
//   cand[k, v] = base[k] + logits[k, v]                       (live beam k)
//              = base[k] at v == pad_id, base[k] - 1e9 elsewhere (finished)
// and the columns of the last, partial 512-wide vocab block past V floored
// to -3e38, as the TPU kernels floor them.
//  gen 1 (legacy_topk_blocks): per sentence, the K best of its K*V
//    candidates in the TPU kernel's first-occurrence order, (value desc,
//    v / 512, k, v): the TPU walks 512-wide vocab blocks in order, extracts
//    the block's top-K beam by beam and lists its running entries first in
//    each merge. This is not the flat-index order of lax.top_k. Writes (B,
//    K) values and int64 flat ids k * V + v.
//  gen 2 (legacy_topk_rows): per row (sentence, beam), the K best of its V
//    candidates, ties to the smaller id. Writes (B*K, K) values and int32
//    ids; the K*K -> K combine runs in PyTorch (ops/topk.py), as it ran in
//    XLA.
//
// Bound on this card at the slice's shape (B=128, K=5, V=16000): one read
// of the 41.0 MB of logits, ~12.2 us at 3.35 TB/s, a few operations per
// element: bound by bytes.
//
// Design. The TPU kernels run K extract-max rounds per vocab block (max,
// then min-index over the matching lanes, then a K-round merge with the
// running list). Here every thread keeps a running top-K in registers by
// the branch-free insertion cascade of kernel 6 (common.cuh, vag::insert)
// over a strided slice of the columns, coalesced, frozen rows' logits not
// read; the block merges its threads' lists pairwise in shared memory. The
// insertion order breaks value ties by an int key: for gen 1 the rank
// (v / 512) * K * 512 + k * 512 + v % 512, which orders exactly as (block,
// beam, id) and is turned back into k * V + v at the end; for gen 2 the
// vocab id. Gen 1 takes one block per sentence, gen 2 one per row. Simple
// first: gen 1's 128 blocks leave 4 of 132 SMs idle at B=128.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

#if !defined(VAG_MAX_K)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_MAX_K)"
#endif

constexpr float FLOOR = -3.0e38f;
constexpr float NEG_INF = -1e9f;     // ops/topk.py's finished-beam filler
constexpr int BLK = 512;             // the TPU kernels' vocab block
constexpr int THREADS = 256;

using vag::insert;

// One candidate of row (frozen flag, base) at vocab column v < Vp.
__device__ __forceinline__ float cand(const float* row, bool frozen, float bs,
                                      int v, int V, int pad_id) {
  if (v >= V) return FLOOR;
  if (frozen) return v == pad_id ? bs : bs + NEG_INF;
  return bs + row[v];
}

template <int K>
__global__ void __launch_bounds__(THREADS)
blocks_kernel(const float* __restrict__ logits, const float* __restrict__ base,
              const uint8_t* __restrict__ fin, float* __restrict__ vals,
              long long* __restrict__ idx, int V, int pad_id) {
  __shared__ float lv[THREADS * K];
  __shared__ int li[THREADS * K];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Vp = (V + BLK - 1) / BLK * BLK;
  float sv[K];
  int si[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sv[s] = FLOOR;
    si[s] = INT_MAX;
  }
  for (int k = 0; k < K; ++k) {
    const size_t r = (size_t)b * K + k;
    const float bs = base[r];
    const bool frozen = fin[r] != 0;
    const float* row = logits + r * V;
    for (int v = tid; v < Vp; v += THREADS)
      insert<K>(sv, si, cand(row, frozen, bs, v, V, pad_id),
                (v / BLK) * (K * BLK) + k * BLK + v % BLK);
  }
  vag::block_merge<K>(sv, si, lv, li);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int rank = si[s];
      const int rem = rank % (K * BLK);
      const int v = rank / (K * BLK) * BLK + rem % BLK;
      vals[(size_t)b * K + s] = sv[s];
      idx[(size_t)b * K + s] = (long long)(rem / BLK) * V + v;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ logits, const float* __restrict__ base,
            const uint8_t* __restrict__ fin, float* __restrict__ vals,
            int* __restrict__ idx, int V, int pad_id) {
  __shared__ float lv[THREADS * K];
  __shared__ int li[THREADS * K];
  const size_t r = blockIdx.x;
  const int tid = threadIdx.x;
  const int Vp = (V + BLK - 1) / BLK * BLK;
  const float bs = base[r];
  const bool frozen = fin[r] != 0;
  const float* row = logits + r * V;
  float sv[K];
  int si[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sv[s] = FLOOR;
    si[s] = INT_MAX;
  }
  for (int v = tid; v < Vp; v += THREADS)
    insert<K>(sv, si, cand(row, frozen, bs, v, V, pad_id), v);
  vag::block_merge<K>(sv, si, lv, li);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      vals[r * K + s] = sv[s];
      idx[r * K + s] = si[s];
    }
  }
}

template <int K>
int launch(bool rows, const float* logits, const float* base,
           const uint8_t* fin, float* vals, void* idx, int B, int V,
           int pad_id, cudaStream_t stream) {
  if (rows)
    rows_kernel<K><<<B * K, THREADS, 0, stream>>>(
        logits, base, fin, vals, static_cast<int*>(idx), V, pad_id);
  else
    blocks_kernel<K><<<B, THREADS, 0, stream>>>(
        logits, base, fin, vals, static_cast<long long*>(idx), V, pad_id);
  return (int)cudaGetLastError();
}

int dispatch(bool rows, const void* logits, const void* base, const void* fin,
             void* vals, void* idx, int B, int K, int V, int pad_id,
             void* stream) {
  if (B <= 0) return 0;
  // gen 1's rank and flat id, and gen 2's grid, must fit an int
  if (V < K || (long long)K * (V + BLK) >= INT_MAX || (long long)B * K >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* lg = static_cast<const float*>(logits);
  const float* bs = static_cast<const float*>(base);
  const uint8_t* fn = static_cast<const uint8_t*>(fin);
  float* vf = static_cast<float*>(vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VAG_LEGACY_CASE(KK) \
  case KK:                  \
    return launch<KK>(rows, lg, bs, fn, vf, idx, B, V, pad_id, s);
  switch (K) {
    VAG_LEGACY_CASE(1)
    VAG_LEGACY_CASE(2)
    VAG_LEGACY_CASE(3)
    VAG_LEGACY_CASE(4)
    VAG_LEGACY_CASE(5)
    VAG_LEGACY_CASE(6)
    VAG_LEGACY_CASE(7)
    VAG_LEGACY_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VAG_LEGACY_CASE
}

}  // namespace

// Device pointers to contiguous tensors: logits (B, K, V) f32, base (B, K)
// f32, fin (B, K) uint8; outputs vals (B, K) f32 descending and idx (B, K)
// int64 flat ids k * V + v. K <= V, 1 <= K <= VAG_MAX_K. Returns 0 or a
// CUDA error code.
extern "C" int legacy_topk_blocks_launch(const void* logits, const void* base,
                                         const void* fin, void* vals,
                                         void* idx, int B, int K, int V,
                                         int pad_id, void* stream) {
  return dispatch(false, logits, base, fin, vals, idx, B, K, V, pad_id, stream);
}

// As above, per row: outputs vals (B*K, K) f32 descending and idx (B*K, K)
// int32 vocab ids.
extern "C" int legacy_topk_rows_launch(const void* logits, const void* base,
                                       const void* fin, void* vals, void* idx,
                                       int B, int K, int V, int pad_id,
                                       void* stream) {
  return dispatch(true, logits, base, fin, vals, idx, B, K, V, pad_id, stream);
}

static_assert(VAG_MAX_K == 8, "the K switch above instantiates 1..VAG_MAX_K");
