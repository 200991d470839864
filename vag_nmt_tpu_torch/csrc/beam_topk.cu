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
// Design (the split top-K of topk_split.cuh). Stage 1: one 128-thread CTA
// per (row, vocab slice), S slices per row planned in ops/topk.py so that
// the grid puts several CTAs on every SM; float4 loads, several in flight
// per thread; a candidate enters the register cascade only if it beats the
// thread's K-th entry; warp shuffles and shared memory merge the CTA's
// lists into K partials with flat ids k * V + v; a finished row reads no
// logits. Stage 2 runs in the last CTA of each sentence to arrive (an
// atomic ticket, so one launch in all): one warp merges the sentence's
// K * S partial lists into its K values and int64 flat ids. Above 16
// beams: ceil(K / 16) such launches, each the next 16 after the key the
// one before wrote (topk_split.cuh's passes; beam_topk_passes_launch).
//
// Measured (chip_smoke.py on an H100 SXM at 700 W; PERF.md), the grid
// alone with L2 cold: 0.027 ms at V=8000 and 0.039 ms at V=16000, 22% and
// 32% of the bytes bound, where the first design (one 256-thread CTA per
// sentence, scalar loads, the full cascade on every element) took 0.047
// and 0.084 and torch.topk on the same candidates takes 0.139 and 0.237.
// What is left: 0.009 ms of fixed cost (every beam finished, no logit
// read) and a loop that reads at ~1.4 TB/s in every tiling tried.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_split.cuh"

namespace {

namespace split = vag::split;

template <int K>
__global__ void __launch_bounds__(split::THREADS)
beam_topk_kernel(const float* __restrict__ logits,
                 const float* __restrict__ base,
                 const uint8_t* __restrict__ fin, float* part_v, int* part_i,
                 unsigned int* counters, float* __restrict__ vals,
                 long long* __restrict__ idx, int V, int S, int pad_id) {
  if (!split::stage1<K>(logits, base, fin, part_v, part_i, counters, V, S,
                        pad_id, split::FlatId{V}))
    return;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int b = blockIdx.x / (S * K);
  const size_t p0 = (size_t)b * K * S * K;
  float sv[K], ov[K];
  int si[K], oi[K];
  split::clear<K>(sv, si);
  // partials other CTAs wrote: read through L2 (__ldcg), not L1
  for (int e = lane; e < K * S * K; e += 32)
    split::offer<K>(sv, si, __ldcg(part_v + p0 + e),
                    __ldcg(part_i + p0 + e));
  split::warp_merge<K>(sv, si, ov, oi);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vals[(size_t)b * K + j] = ov[j];
      idx[(size_t)b * K + j] = oi[j];
    }
    counters[b] = 0u;
  }
}

// One pass of K > 16 beams (topk_split.cuh's passes): entries [kofs, kofs +
// 16) of each sentence's top-K, after the key vals/idx[kofs - 1] that the
// previous pass wrote (the flat id is the kernel's own id).
__global__ void __launch_bounds__(split::THREADS)
beam_topk_pass_kernel(const float* __restrict__ logits,
                      const float* __restrict__ base,
                      const uint8_t* __restrict__ fin, float* part_v,
                      int* part_i, unsigned int* counters,
                      float* __restrict__ vals, long long* __restrict__ idx,
                      int K, int V, int S, int pad_id, int kofs) {
  constexpr int KT = split::PASS_K;
  const int b = blockIdx.x / (S * K);
  const size_t o = (size_t)b * K;
  const bool filt = kofs > 0;
  const float av = filt ? __ldcg(vals + o + kofs - 1) : 0.f;
  const int ai = filt ? (int)__ldcg(idx + o + kofs - 1) : 0;
  if (!split::stage1_pass(logits, base, fin, part_v, part_i, counters, V, S,
                          pad_id, split::FlatId{V}, K, filt, av, ai))
    return;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const size_t p0 = (size_t)b * K * S * KT;
  float sv[KT], ov[KT];
  int si[KT], oi[KT];
  split::clear<KT>(sv, si);
  for (int e = lane; e < K * S * KT; e += 32)
    split::offer<KT>(sv, si, __ldcg(part_v + p0 + e), __ldcg(part_i + p0 + e));
  split::warp_merge<KT>(sv, si, ov, oi);
  if (lane == 0) {
    const int n = split::pass_width(K, kofs);
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < n) {
        vals[o + kofs + j] = ov[j];
        idx[o + kofs + j] = oi[j];
      }
    counters[b] = 0u;
  }
}

template <int K>
int launch(const float* logits, const float* base, const uint8_t* fin,
           float* part_v, int* part_i, unsigned int* counters, float* vals,
           long long* idx, int B, int V, int S, int pad_id,
           cudaStream_t stream) {
  beam_topk_kernel<K><<<B * K * S, split::THREADS, 0, stream>>>(
      logits, base, fin, part_v, part_i, counters, vals, idx, V, S, pad_id);
  return (int)cudaGetLastError();
}

}  // namespace

// K > 16 beams: ceil(K / 16) passes, one grid each, on the arguments of
// beam_topk_launch with part_v / part_i of B*K*S*16; K <= V.
extern "C" int beam_topk_passes_launch(const void* logits, const void* base,
                                       const void* fin, void* part_v,
                                       void* part_i, void* counters,
                                       void* vals, void* idx, int B, int K,
                                       int V, int S, int pad_id, void* stream) {
  if (B <= 0) return 0;
  if (K <= split::PASS_K || K > V || S < 1 || (long long)K * V >= INT_MAX ||
      (long long)B * K * S >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int kofs = 0; kofs < K; kofs += split::PASS_K) {
    beam_topk_pass_kernel<<<B * K * S, split::THREADS, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const float*>(base),
        static_cast<const uint8_t*>(fin), static_cast<float*>(part_v),
        static_cast<int*>(part_i), static_cast<unsigned int*>(counters),
        static_cast<float*>(vals), static_cast<long long*>(idx), K, V, S,
        pad_id, kofs);
    VAG_CHECK(cudaGetLastError());
  }
  return 0;
}

// Device pointers to contiguous tensors: logits (B, K, V) f32, base (B, K)
// f32, fin (B, K) uint8; scratch part_v (B*K*S*K) f32 and part_i int32,
// counters (>= B) uint32, zero on entry and left zero; outputs vals (B, K)
// f32 descending, idx (B, K) int64 flat indices k * V + v.
// 1 <= K <= 16 (ops/topk.py's MAX_K), K * V < 2^31, S >= 1 slices per row.
// Returns 0 or a CUDA error code.
extern "C" int beam_topk_launch(const void* logits, const void* base,
                                const void* fin, void* part_v, void* part_i,
                                void* counters, void* vals, void* idx, int B,
                                int K, int V, int S, int pad_id,
                                void* stream) {
  if (B <= 0) return 0;
  if (V <= 0 || S < 1 || (long long)K * V >= INT_MAX ||
      (long long)B * K * S >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* lg = static_cast<const float*>(logits);
  const float* bs = static_cast<const float*>(base);
  const uint8_t* fn = static_cast<const uint8_t*>(fin);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  unsigned int* ct = static_cast<unsigned int*>(counters);
  float* vf = static_cast<float*>(vals);
  long long* ix = static_cast<long long*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VAG_TOPK_CASE(KK) \
  case KK:                \
    return launch<KK>(lg, bs, fn, pv, pi, ct, vf, ix, B, V, S, pad_id, s);
  switch (K) {
    VAG_TOPK_CASE(1)
    VAG_TOPK_CASE(2)
    VAG_TOPK_CASE(3)
    VAG_TOPK_CASE(4)
    VAG_TOPK_CASE(5)
    VAG_TOPK_CASE(6)
    VAG_TOPK_CASE(7)
    VAG_TOPK_CASE(8)
    VAG_TOPK_CASE(9)
    VAG_TOPK_CASE(10)
    VAG_TOPK_CASE(11)
    VAG_TOPK_CASE(12)
    VAG_TOPK_CASE(13)
    VAG_TOPK_CASE(14)
    VAG_TOPK_CASE(15)
    VAG_TOPK_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VAG_TOPK_CASE
}
