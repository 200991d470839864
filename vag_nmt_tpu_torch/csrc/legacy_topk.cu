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
// Design, both gens: the split top-K of topk_split.cuh. Stage 1, one CTA
// per (row, vocab slice), S slices a row from ops/topk.py's split_plan,
// float4 loads, early reject against the thread's K-th entry, warp-shuffle
// merges, K partials per CTA; stage 2 in the last CTA of each sentence to
// arrive (an atomic ticket). One launch, and every CTA's columns read once.
//
// Gen 1. Stage 1 keys each candidate by the TPU kernel's first-occurrence
// rank (v / 512) * K * 512 + k * 512 + v % 512 (BlockRank), which orders
// exactly as (block, beam, v), is distinct across a sentence and grows
// with v within a row: a strict total order, so the merged slice top-Ks
// are the sentence's, bit for bit. Stage 2: one warp merges the
// sentence's K * S partial lists (and the floored columns past V) by rank
// and turns each rank back into k * V + v.
//
// Gen 2. Stage 1 keys by the vocab id (VocabId); stage 2: one warp per
// row merges its S partial lists with the floored columns past V, writes
// the per-row output, and warp 0 combines the K rows. One launch where the
// first design ran a grid of one 256-thread CTA per row with scalar loads
// and the full cascade on every element, then ~10 torch launches of
// combine.
//
// Above 16 beams both gens run ceil(K / 16) passes of 16 (topk_split.cuh),
// one launch each: gen 1 keyed after the last rank the pass before wrote,
// gen 2 after each row's last entry, its combine in the last pass as
// rounds of 16 after the round before (the *_passes_launch entries). Measured (chip_smoke.py on an H100 SXM at 700 W; PERF.md), gen
// 2's grid alone with L2 cold: 0.030 ms at V=8000 and 0.041 ms at V=16000
// with the combine, as the first design's grid without it; torch.topk on
// the same candidates takes 0.139 and 0.237.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_split.cuh"

namespace {

constexpr float FLOOR = -3.0e38f;
constexpr int BLK = 512;             // the TPU kernels' vocab block

namespace split = vag::split;

// Gen 1's id of beam k's column v (see the head of this file).
template <int K>
struct BlockRank {
  __device__ __forceinline__ int operator()(int k, int v) const {
    return (v / BLK) * (K * BLK) + k * BLK + v % BLK;
  }
};

// Gen 1: stage 1 of topk_split.cuh keyed by BlockRank; stage 2 in the last
// CTA of each sentence: one warp merges the sentence's K * S partial lists
// and writes the K best values with their ranks turned back into flat ids
// k * V + v.
template <int K>
__global__ void __launch_bounds__(split::THREADS)
blocks_kernel(const float* __restrict__ logits, const float* __restrict__ base,
              const uint8_t* __restrict__ fin, float* part_v, int* part_i,
              unsigned int* counters, float* __restrict__ vals,
              long long* __restrict__ idx, int V, int S, int pad_id) {
  const BlockRank<K> rank{};
  if (!split::stage1<K>(logits, base, fin, part_v, part_i, counters, V, S,
                        pad_id, rank))
    return;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int b = blockIdx.x / (S * K);
  const size_t p0 = (size_t)b * K * S * K;
  const int npad = (V + BLK - 1) / BLK * BLK - V;
  float sv[K], ov[K];
  int si[K], oi[K];
  split::clear<K>(sv, si);
  // partials other CTAs wrote: read through L2 (__ldcg), not L1
  for (int e = lane; e < K * S * K; e += 32)
    split::offer<K>(sv, si, __ldcg(part_v + p0 + e), __ldcg(part_i + p0 + e));
  // The columns past V in the last 512-block, floored as the TPU kernel
  // floors them: they rank after every candidate above FLOOR, and each row
  // has V >= K of those unless its logits hold -inf. The K of them that
  // rank first (beam 0's first) stand in for all.
  if (npad > 0 && lane < K)
    split::offer<K>(sv, si, FLOOR, rank(lane / npad, V + lane % npad));
  split::warp_merge<K>(sv, si, ov, oi);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int rem = oi[j] % (K * BLK);
      vals[(size_t)b * K + j] = ov[j];
      idx[(size_t)b * K + j] =
          (long long)(rem / BLK) * V + oi[j] / (K * BLK) * BLK + rem % BLK;
    }
    counters[b] = 0u;
  }
}

// Gen 2: stage 1 of topk_split.cuh keyed by VocabId; stage 2 in the last CTA
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
                        pad_id, split::VocabId{}))
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

// ---- Passes: K > 16 beams (topk_split.cuh's passes), one launch a pass ----

// Gen 1's rank at K beams known only at run time.
struct BlockRankK {
  int K;
  __device__ __forceinline__ int operator()(int k, int v) const {
    return (v / BLK) * (K * BLK) + k * BLK + v % BLK;
  }
};

// The first 16 of the floored columns past V (BlockRankK ranks, value
// FLOOR, ordered k-major) strictly after (av, ai), offered by lanes 0..15:
// start = how many of them rank at or before the key.
__device__ __forceinline__ void offer_floored(float (&sv)[split::PASS_K],
                                             int (&si)[split::PASS_K],
                                             const BlockRankK& rank, int V,
                                             bool filt, float av, int ai,
                                             int lane) {
  const int npad = (V + BLK - 1) / BLK * BLK - V;
  if (npad == 0 || lane >= split::PASS_K) return;
  const int n = rank.K * npad;
  int start = 0;
  if (filt && av < FLOOR) start = n;
  if (filt && av == FLOOR) {
    const int base = (V / BLK) * (rank.K * BLK);   // the last block's rank 0
    if (ai >= base) {
      const int rem = ai - base, kk = rem / BLK, c = rem % BLK - V % BLK;
      start = kk * npad + min(npad, max(0, c + 1));
    }
  }
  const int e = start + lane;
  if (e < n) split::offer<split::PASS_K>(sv, si, FLOOR, rank(e / npad, V + e % npad));
}

// Gen 1, one pass: entries [kofs, kofs + 16) of each sentence's top-K in
// gen 1's order, after the key of entry kofs - 1 (its flat id turned back
// into the rank).
__global__ void __launch_bounds__(split::THREADS)
blocks_pass_kernel(const float* __restrict__ logits,
                   const float* __restrict__ base,
                   const uint8_t* __restrict__ fin, float* part_v, int* part_i,
                   unsigned int* counters, float* __restrict__ vals,
                   long long* __restrict__ idx, int K, int V, int S,
                   int pad_id, int kofs) {
  constexpr int KT = split::PASS_K;
  const BlockRankK rank{K};
  const int b = blockIdx.x / (S * K);
  const size_t o = (size_t)b * K;
  const bool filt = kofs > 0;
  float av = 0.f;
  int ai = 0;
  if (filt) {
    const long long f = __ldcg(idx + o + kofs - 1);
    av = __ldcg(vals + o + kofs - 1);
    ai = rank((int)(f / V), (int)(f % V));
  }
  if (!split::stage1_pass(logits, base, fin, part_v, part_i, counters, V, S,
                          pad_id, rank, K, filt, av, ai))
    return;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const size_t p0 = (size_t)b * K * S * KT;
  float sv[KT], ov[KT];
  int si[KT], oi[KT];
  split::clear<KT>(sv, si);
  for (int e = lane; e < K * S * KT; e += 32)
    split::offer<KT>(sv, si, __ldcg(part_v + p0 + e), __ldcg(part_i + p0 + e));
  offer_floored(sv, si, rank, V, filt, av, ai, lane);
  split::warp_merge<KT>(sv, si, ov, oi);
  if (lane == 0) {
    const int n = split::pass_width(K, kofs);
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < n) {
        const int rem = oi[j] % (K * BLK);
        vals[o + kofs + j] = ov[j];
        idx[o + kofs + j] =
            (long long)(rem / BLK) * V + oi[j] / (K * BLK) * BLK + rem % BLK;
      }
    counters[b] = 0u;
  }
}

// Gen 2, one pass: each row's entries [kofs, kofs + 16) after its key
// rvals/ridx[kofs - 1]; the last pass (kofs + 16 >= K) then combines the
// sentence's K * K per-row entries beam-major into vals / idx, 16 at a
// time in the same way (rounds after the key of the round before).
__global__ void __launch_bounds__(split::THREADS)
rows_pass_kernel(const float* __restrict__ logits,
                 const float* __restrict__ base,
                 const uint8_t* __restrict__ fin, float* part_v, int* part_i,
                 unsigned int* counters, float* __restrict__ rvals,
                 int* __restrict__ ridx, float* __restrict__ vals,
                 long long* __restrict__ idx, int K, int V, int S,
                 int pad_id, int kofs) {
  constexpr int KT = split::PASS_K;
  const int r = blockIdx.x / S, b = r / K;
  const bool filt = kofs > 0;
  const float av = filt ? __ldcg(rvals + (size_t)r * K + kofs - 1) : 0.f;
  const int ai = filt ? __ldcg(ridx + (size_t)r * K + kofs - 1) : 0;
  if (!split::stage1_pass(logits, base, fin, part_v, part_i, counters, V, S,
                          pad_id, split::VocabId{}, K, filt, av, ai))
    return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Vp = (V + BLK - 1) / BLK * BLK;
  const int n = split::pass_width(K, kofs);
  float sv[KT], ov[KT];
  int si[KT], oi[KT];
  for (int k = warp; k < K; k += split::WARPS) {
    const int rr = b * K + k;
    const size_t p0 = (size_t)rr * S * KT;
    const bool f2 = kofs > 0;
    const float bv = f2 ? __ldcg(rvals + (size_t)rr * K + kofs - 1) : 0.f;
    const int bi = f2 ? __ldcg(ridx + (size_t)rr * K + kofs - 1) : 0;
    split::clear<KT>(sv, si);
    for (int e = lane; e < S * KT; e += 32)
      split::offer<KT>(sv, si, __ldcg(part_v + p0 + e), __ldcg(part_i + p0 + e));
    // the floored columns past V after the row's key, the first 16
    const int start = !f2 || bv > FLOOR ? V : bv == FLOOR ? max(V, bi + 1) : Vp;
    if (lane < KT && start + lane < Vp)
      split::offer<KT>(sv, si, FLOOR, start + lane);
    split::warp_merge<KT>(sv, si, ov, oi);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j < n) {
          rvals[(size_t)rr * K + kofs + j] = ov[j];
          ridx[(size_t)rr * K + kofs + j] = oi[j];
        }
    }
  }
  if (kofs + KT < K) {
    if (threadIdx.x == 0) counters[b] = 0u;
    return;
  }
  __syncthreads();   // every row's entries written (this CTA's, and earlier launches')
  if (warp != 0) return;
  const size_t c0 = (size_t)b * K * K;
  float cv = 0.f;
  int cp = 0;
  for (int q = 0; q < K; q += KT) {
    split::clear<KT>(sv, si);
    for (int e = lane; e < K * K; e += 32) {
      const float x = __ldcg(rvals + c0 + e);
      if (q == 0 || vag::better(cv, cp, x, e)) split::offer<KT>(sv, si, x, e);
    }
    split::warp_merge<KT>(sv, si, ov, oi);
    const int w = split::pass_width(K, q);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j < w) {
          vals[(size_t)b * K + q + j] = ov[j];
          idx[(size_t)b * K + q + j] =
              (long long)(oi[j] / K) * V + __ldcg(ridx + c0 + oi[j]);
        }
    }
    cv = ov[KT - 1];
    cp = oi[KT - 1];
  }
  if (lane == 0) counters[b] = 0u;
}

// Arguments of both entry points; rows (gen 2) only: the per-row outputs.
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
  const int grid = a.B * K * a.S;
  if (rows)
    rows_kernel<K><<<grid, split::THREADS, 0, a.stream>>>(
        a.logits, a.base, a.fin, a.part_v, a.part_i, a.counters, a.rvals,
        a.ridx, a.vals, a.idx, a.V, a.S, a.pad_id);
  else
    blocks_kernel<K><<<grid, split::THREADS, 0, a.stream>>>(
        a.logits, a.base, a.fin, a.part_v, a.part_i, a.counters, a.vals,
        a.idx, a.V, a.S, a.pad_id);
  return (int)cudaGetLastError();
}

int dispatch_passes(bool rows, int K, const Args& a) {
  if (a.B <= 0) return 0;
  if (K <= split::PASS_K || a.V < K || a.S < 1 ||
      (long long)K * (a.V + BLK) >= INT_MAX || (long long)a.B * K * a.S >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int grid = a.B * K * a.S;
  for (int kofs = 0; kofs < K; kofs += split::PASS_K) {
    if (rows)
      rows_pass_kernel<<<grid, split::THREADS, 0, a.stream>>>(
          a.logits, a.base, a.fin, a.part_v, a.part_i, a.counters, a.rvals,
          a.ridx, a.vals, a.idx, K, a.V, a.S, a.pad_id, kofs);
    else
      blocks_pass_kernel<<<grid, split::THREADS, 0, a.stream>>>(
          a.logits, a.base, a.fin, a.part_v, a.part_i, a.counters, a.vals,
          a.idx, K, a.V, a.S, a.pad_id, kofs);
    VAG_CHECK(cudaGetLastError());
  }
  return 0;
}

int dispatch(bool rows, int K, const Args& a) {
  if (a.B <= 0) return 0;
  // gen 1's rank and the grid must fit an int
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
    VAG_LEGACY_CASE(9)
    VAG_LEGACY_CASE(10)
    VAG_LEGACY_CASE(11)
    VAG_LEGACY_CASE(12)
    VAG_LEGACY_CASE(13)
    VAG_LEGACY_CASE(14)
    VAG_LEGACY_CASE(15)
    VAG_LEGACY_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VAG_LEGACY_CASE
}

}  // namespace

// Device pointers to contiguous tensors: logits (B, K, V) f32, base (B, K)
// f32, fin (B, K) uint8; scratch part_v (B*K*S*K) f32 and part_i int32,
// counters (>= B) uint32, zero on entry and left zero; outputs vals (B, K)
// f32 descending and idx (B, K) int64 flat ids k * V + v. K <= V,
// 1 <= K <= 16 (ops/topk.py's MAX_K), S >= 1 slices per row. Returns 0 or a
// CUDA error code.
extern "C" int legacy_topk_blocks_launch(const void* logits, const void* base,
                                         const void* fin, void* part_v,
                                         void* part_i, void* counters,
                                         void* vals, void* idx, int B, int K,
                                         int V, int S, int pad_id,
                                         void* stream) {
  const Args a{static_cast<const float*>(logits),
               static_cast<const float*>(base),
               static_cast<const uint8_t*>(fin), static_cast<float*>(part_v),
               static_cast<int*>(part_i),
               static_cast<unsigned int*>(counters), nullptr, nullptr,
               static_cast<float*>(vals), static_cast<long long*>(idx), B, V,
               S, pad_id, static_cast<cudaStream_t>(stream)};
  return dispatch(false, K, a);
}

// As above, with the per-row top-K also written: rvals (B*K, K) f32
// descending and ridx (B*K, K) int32 vocab ids; vals and idx are the
// combined top-K.
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

// K > 16 beams: ceil(K / 16) passes, one grid each, on the arguments of
// legacy_topk_blocks_launch / legacy_topk_rows_launch with part_v / part_i
// of B*K*S*16; K <= V.
extern "C" int legacy_topk_blocks_passes_launch(
    const void* logits, const void* base, const void* fin, void* part_v,
    void* part_i, void* counters, void* vals, void* idx, int B, int K, int V,
    int S, int pad_id, void* stream) {
  const Args a{static_cast<const float*>(logits),
               static_cast<const float*>(base),
               static_cast<const uint8_t*>(fin), static_cast<float*>(part_v),
               static_cast<int*>(part_i),
               static_cast<unsigned int*>(counters), nullptr, nullptr,
               static_cast<float*>(vals), static_cast<long long*>(idx), B, V,
               S, pad_id, static_cast<cudaStream_t>(stream)};
  return dispatch_passes(false, K, a);
}

extern "C" int legacy_topk_rows_passes_launch(
    const void* logits, const void* base, const void* fin, void* part_v,
    void* part_i, void* counters, void* rvals, void* ridx, void* vals,
    void* idx, int B, int K, int V, int S, int pad_id, void* stream) {
  const Args a{static_cast<const float*>(logits),
               static_cast<const float*>(base),
               static_cast<const uint8_t*>(fin), static_cast<float*>(part_v),
               static_cast<int*>(part_i),
               static_cast<unsigned int*>(counters),
               static_cast<float*>(rvals), static_cast<int*>(ridx),
               static_cast<float*>(vals), static_cast<long long*>(idx), B, V,
               S, pad_id, static_cast<cudaStream_t>(stream)};
  return dispatch_passes(true, K, a);
}
