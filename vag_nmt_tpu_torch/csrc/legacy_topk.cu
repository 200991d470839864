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
//    candidates, ties to the smaller id: the TPU kernel's (B*K, K) values
//    and int32 ids; then the beam-major K*K -> K combine, which XLA ran
//    after the TPU kernel, on the device too: (B, K) values and int64 flat
//    ids k * V + v, in the flat-index order of kernel 6.
//
// Bound on this card at the slice's shape (B=128, K=5, V=16000): one read
// of the 41.0 MB of logits, ~12.2 us at 3.35 TB/s, a few operations per
// element: bound by bytes.
//
// Design, gen 1. The TPU kernels run K extract-max rounds per vocab block
// (max, then min-index over the matching lanes, then a K-round merge with
// the running list). Here every thread keeps a running top-K in registers
// by the branch-free insertion cascade (common.cuh, vag::insert) over a
// strided slice of the columns, coalesced, frozen rows' logits not read;
// the block merges its threads' lists pairwise in shared memory. Value ties
// break by the int rank (v / 512) * K * 512 + k * 512 + v % 512, which
// orders exactly as (block, beam, id) and is turned back into k * V + v at
// the end. One block per sentence: 128 blocks leave 4 of 132 SMs idle at
// B=128 (not redesigned yet).
//
// Design, gen 2: the split top-K of topk_split.cuh. Stage 1, one CTA per
// (row, vocab slice), float4 loads, early reject against the thread's K-th
// entry, warp-shuffle merges, K partials per CTA; stage 2 in the last CTA
// of each sentence to arrive (an atomic ticket): one warp per row merges
// its S partial lists with the floored columns past V, writes the per-row
// output, and warp 0 combines the K rows. One launch where the first
// design ran a grid of one 256-thread CTA per row with scalar loads and the
// full cascade on every element, then ~10 torch launches of combine.
// Measured (chip_smoke.py on an H100 SXM at 700 W; PERF.md), the grid
// alone with L2 cold: 0.030 ms at V=8000 and 0.041 ms at V=16000 with the
// combine, as the first design's grid without it; torch.topk on the same
// candidates takes 0.139 and 0.237.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_split.cuh"

namespace {

#if !defined(VAG_MAX_K)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_MAX_K)"
#endif

constexpr float FLOOR = -3.0e38f;
constexpr float NEG_INF = -1e9f;     // ops/topk.py's finished-beam filler
constexpr int BLK = 512;             // the TPU kernels' vocab block
constexpr int THREADS = 256;

using vag::insert;
namespace split = vag::split;

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
int launch_blocks(const float* logits, const float* base, const uint8_t* fin,
                  float* vals, long long* idx, int B, int V, int pad_id,
                  cudaStream_t stream) {
  blocks_kernel<K><<<B, THREADS, 0, stream>>>(logits, base, fin, vals, idx,
                                              V, pad_id);
  return (int)cudaGetLastError();
}

// Gen 2: stage 1 of topk_split.cuh with vocab ids; stage 2 in the last CTA
// of each sentence: one warp per row merges its S partial lists and the
// floored columns past V into the TPU kernel's per-row output, then warp 0
// takes the beam-major K*K -> K combine, ordered by (value, position
// k * K + j) as the plain version's stable sort orders it.
template <int K>
__global__ void __launch_bounds__(split::THREADS)
rows_kernel(const float* __restrict__ logits, const float* __restrict__ base,
            const uint8_t* __restrict__ fin, float* part_v, int* part_i,
            unsigned int* counters, float* __restrict__ rvals,
            int* __restrict__ ridx, float* __restrict__ vals,
            long long* __restrict__ idx, int V, int S, int pad_id) {
  if (!split::stage1<K>(logits, base, fin, part_v, part_i, counters, V, S,
                        pad_id, /*flat_ids=*/false))
    return;
  __shared__ float cv[K * K];
  __shared__ int ci[K * K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / (S * K);
  const int Vp = (V + BLK - 1) / BLK * BLK;
  const int npad = min(K, Vp - V);
  float sv[K], ov[K];
  int si[K], oi[K];
  for (int k = warp; k < K; k += split::WARPS) {
    const int r = b * K + k;
    const size_t p0 = (size_t)r * S * K;
    split::clear<K>(sv, si);
    // partials other CTAs wrote: read through L2 (__ldcg), not L1
    for (int e = lane; e < S * K; e += 32)
      split::offer<K>(sv, si, __ldcg(part_v + p0 + e),
                      __ldcg(part_i + p0 + e));
    if (lane < npad) split::offer<K>(sv, si, FLOOR, V + lane);
    split::warp_merge<K>(sv, si, ov, oi);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        rvals[(size_t)r * K + j] = ov[j];
        ridx[(size_t)r * K + j] = oi[j];
        cv[k * K + j] = ov[j];
        ci[k * K + j] = oi[j];
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;
  split::clear<K>(sv, si);
  for (int p = lane; p < K * K; p += 32) split::offer<K>(sv, si, cv[p], p);
  split::warp_merge<K>(sv, si, ov, oi);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vals[(size_t)b * K + j] = ov[j];
      idx[(size_t)b * K + j] = (long long)(oi[j] / K) * V + ci[oi[j]];
    }
    counters[b] = 0u;
  }
}

template <int K>
int launch_rows(const float* logits, const float* base, const uint8_t* fin,
                float* part_v, int* part_i, unsigned int* counters,
                float* rvals, int* ridx, float* vals, long long* idx, int B,
                int V, int S, int pad_id, cudaStream_t stream) {
  rows_kernel<K><<<B * K * S, split::THREADS, 0, stream>>>(
      logits, base, fin, part_v, part_i, counters, rvals, ridx, vals, idx, V,
      S, pad_id);
  return (int)cudaGetLastError();
}

// Arguments common to both entry points; rows (gen 2) only: S, scratch,
// counters and the per-row outputs.
struct Args {
  const float* logits;
  const float* base;
  const uint8_t* fin;
  float* part_v;
  int* part_i;
  unsigned int* counters;
  float* rvals;
  int* ridx;
  float* vals;
  long long* idx;
  int B, V, S, pad_id;
  cudaStream_t stream;
};

template <int K>
int launch(bool rows, const Args& a) {
  if (rows)
    return launch_rows<K>(a.logits, a.base, a.fin, a.part_v, a.part_i,
                          a.counters, a.rvals, a.ridx, a.vals, a.idx, a.B,
                          a.V, a.S, a.pad_id, a.stream);
  return launch_blocks<K>(a.logits, a.base, a.fin, a.vals, a.idx, a.B, a.V,
                          a.pad_id, a.stream);
}

int dispatch(bool rows, int K, const Args& a) {
  if (a.B <= 0) return 0;
  // gen 1's rank and flat id, and gen 2's grid, must fit an int
  if (a.V < K || a.S < 1 || (long long)K * (a.V + BLK) >= INT_MAX ||
      (long long)a.B * K * a.S >= INT_MAX)
    return (int)cudaErrorInvalidValue;
#define VAG_LEGACY_CASE(KK) \
  case KK:                  \
    return launch<KK>(rows, a);
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
  const Args a{static_cast<const float*>(logits),
               static_cast<const float*>(base),
               static_cast<const uint8_t*>(fin), nullptr, nullptr, nullptr,
               nullptr, nullptr, static_cast<float*>(vals),
               static_cast<long long*>(idx), B, V, 1, pad_id,
               static_cast<cudaStream_t>(stream)};
  return dispatch(false, K, a);
}

// As above, S slices per row, with scratch part_v (B*K*S*K) f32 and part_i
// int32, counters (>= B) uint32, zero on entry and left zero; outputs the
// per-row top-K rvals (B*K, K) f32 descending and ridx (B*K, K) int32
// vocab ids, and the combined vals (B, K) f32 and idx (B, K) int64 flat
// ids k * V + v.
extern "C" int legacy_topk_rows_launch(const void* logits, const void* base,
                                       const void* fin, void* part_v,
                                       void* part_i, void* counters,
                                       void* rvals, void* ridx, void* vals,
                                       void* idx, int B, int K, int V, int S,
                                       int pad_id, void* stream) {
  const Args a{static_cast<const float*>(logits),
               static_cast<const float*>(base),
               static_cast<const uint8_t*>(fin), static_cast<float*>(part_v),
               static_cast<int*>(part_i),
               static_cast<unsigned int*>(counters),
               static_cast<float*>(rvals), static_cast<int*>(ridx),
               static_cast<float*>(vals), static_cast<long long*>(idx), B, V,
               S, pad_id, static_cast<cudaStream_t>(stream)};
  return dispatch(true, K, a);
}

static_assert(VAG_MAX_K == 8, "the K switch above instantiates 1..VAG_MAX_K");
