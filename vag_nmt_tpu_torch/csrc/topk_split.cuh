// The split beam top-K shared by kernel 6 (beam_topk.cu) and kernels 8
// and 9 (legacy_topk.cu, gens 1 and 2): stage 1 over (row, vocab slice)
// CTAs, and the warp merges and the arrival ticket that stage 2 runs on.
//
// Candidates, with base = scores - lse (scores alone for a finished beam)
// computed by the wrapper with the plain version's torch ops:
//   cand[r, v] = base[r] + logits[r, v]                        (live row r)
//              = base[r] at v == pad_id, base[r] - 1e9 elsewhere (finished)
// ordered by (value descending, id ascending) (`vag::better`), where the id
// of beam k's column v is the kernel's own: id(k, v), an int that grows
// with v within a row and is distinct across what stage 2 merges (FlatId
// and gen 1's rank in legacy_topk.cu across a sentence, VocabId across a
// row). The order is then strict and total, so the top-K of any split of
// the candidates, merged, is the top-K of the whole, bit for bit, whatever
// order the CTAs run in.
//
// Stage 1. CTA (r, s) takes columns [s * L, min(V, (s + 1) * L)) of row r,
// L = slice_len(V, S) (ops/topk.py plans S and holds the same bounds).
// Each thread keeps a running top-K in registers and reads its columns as
// 16-byte float4 loads, UNROLL in flight, neighbouring threads on
// neighbouring addresses; a row need not start on a 16-byte boundary (it
// starts r * V floats into logits), so a scalar head runs up to the first
// boundary and a scalar tail after the last. A candidate enters the
// insertion cascade only if it is `better` than the thread's K-th entry.
// (A warp-shared threshold and a one-test-per-float4 skip were measured
// and bought nothing: the loop is bound by its loads, PERF.md.) The CTA
// merges its threads' lists with warp arg-max rounds (shuffles), then its
// warps' lists in shared memory, and writes K (value, id) partials. A
// finished row reads no logits: its K best lie among columns 0..K-1 and
// pad_id (ids grow with v), whose values are the plain version's adds.
// Then the CTA takes a ticket on its sentence's arrival counter; the last
// of the sentence's K * S CTAs runs stage 2 (in the kernel's own file) and
// sets the counter back to 0 for the next launch.
//
// Passes (K beams above 16, `stage1_pass`). The order being strict and
// total, a sentence's top-K is ceil(K / 16) passes of a top-16: pass p
// keeps only the candidates strictly worse than an "after" key, the last
// (value, id) that pass p - 1 wrote (read back from the outputs, so no
// host sync), and its 16 best are entries 16 p .. 16 p + 15 of the top-K.
// Each pass is one launch of the same split grid, its lists 16 wide (KT)
// while the sentence keeps its K rows; the finished-row shortcut lists
// columns 0..K-1 and pad_id with the full K, under the after key.

#pragma once

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

#if !defined(VAG_SPLIT_THREADS)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_SPLIT_THREADS)"
#endif

namespace vag {
namespace split {

constexpr int THREADS = VAG_SPLIT_THREADS;   // ops/topk.py SPLIT_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                    // float4 loads in flight
constexpr float FLOOR = -3.0e38f;            // an empty slot's value
constexpr float NEG_INF = -1e9f;             // ops/topk.py's finished filler

static_assert(THREADS % 32 == 0 && WARPS <= 32, "whole warps, one merge warp");

// Columns per slice: ceil(V / S) rounded up to a multiple of 4.
__host__ __device__ inline int slice_len(int V, int S) {
  return ((V + S - 1) / S + 3) / 4 * 4;
}

template <int K>
__device__ __forceinline__ void clear(float (&sv)[K], int (&si)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sv[s] = FLOOR;
    si[s] = INT_MAX;
  }
}

// Early reject: one test against the K-th entry before the cascade.
template <int K>
__device__ __forceinline__ void offer(float (&sv)[K], int (&si)[K], float x,
                                      int xi) {
  if (better(x, xi, sv[K - 1], si[K - 1])) insert<K>(sv, si, x, xi);
}

// The warp's top-K of its lanes' sorted lists, in every lane's (ov, oi):
// K rounds of a butterfly arg-max under `better`; the winner leaves its
// lane's list. Ids are unique but for empty slots (FLOOR, INT_MAX), which
// win a round only when every head is empty.
template <int K>
__device__ __forceinline__ void warp_merge(float (&sv)[K], int (&si)[K],
                                           float (&ov)[K], int (&oi)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float bv = sv[0];
    int bi = si[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
      }
    }
    ov[j] = bv;
    oi[j] = bi;
    if (si[0] == bi) {
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) {
        sv[s] = sv[s + 1];
        si[s] = si[s + 1];
      }
      sv[K - 1] = FLOOR;
      si[K - 1] = INT_MAX;
    }
  }
}

// Candidate ids: kernel 6's flat index k * V + v, kernel 9's vocab id v.
struct FlatId {
  int V;
  __device__ __forceinline__ int operator()(int k, int v) const { return k * V + v; }
};
struct VocabId {
  __device__ __forceinline__ int operator()(int, int v) const { return v; }
};

// The body of stage1 and stage1_pass: lists KT wide, nb beams a sentence
// (KT itself but in passes), and with PASS and `filt` only candidates
// strictly worse than (av, ai).
template <int KT, class Id, bool PASS>
__device__ bool stage1_body(const float* __restrict__ logits,
                            const float* __restrict__ base,
                            const uint8_t* __restrict__ fin, float* part_v,
                            int* part_i, unsigned int* counters, int V, int S,
                            int pad_id, const Id& id, int nb, bool filt,
                            float av, int ai) {
  constexpr int K = KT;
  __shared__ float smv[WARPS * K];
  __shared__ int smi[WARPS * K];
  __shared__ bool last;
  const int beams = PASS ? nb : K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x / S, s = blockIdx.x - r * S;
  const int b = r / beams, k = r - b * beams;
  const float bs = base[r];
  const size_t pofs = ((size_t)r * S + s) * K;
  float sv[K];
  int si[K];
  clear<K>(sv, si);
  // a candidate a pass may take: every one, or those after (av, ai)
  auto take = [&](float x, int xi) { return !PASS || !filt || better(av, ai, x, xi); };
  if (fin[r]) {
    if (tid == 0) {
      if (s == 0) {
        const float rest = bs + NEG_INF;
        for (int v = 0; v < min(beams, V); ++v) {
          const float x = v == pad_id ? bs : rest;
          if (take(x, id(k, v))) insert<K>(sv, si, x, id(k, v));
        }
        if (pad_id >= beams && pad_id < V && take(bs, id(k, pad_id)))
          insert<K>(sv, si, bs, id(k, pad_id));
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        part_v[pofs + j] = sv[j];
        part_i[pofs + j] = si[j];
      }
    }
  } else {
    const int L = slice_len(V, S);
    const int c0 = min(V, s * L), c1 = min(V, c0 + L);
    const float* row = logits + (size_t)r * V;
    const int mis = (int)((reinterpret_cast<uintptr_t>(row + c0) >> 2) & 3);
    const int head = min(c1 - c0, mis ? 4 - mis : 0);
    const int cb = c0 + head;
    const int nq = (c1 - cb) >> 2;
    const int ct = cb + 4 * nq;
    auto off = [&](float x, int xi) {
      if (take(x, xi)) offer<K>(sv, si, x, xi);
    };
    if (tid < head) off(bs + row[c0 + tid], id(k, c0 + tid));
    const float4* q4 = reinterpret_cast<const float4*>(row + cb);
    for (int q = tid; q < nq; q += THREADS * UNROLL) {
      float4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (q + u * THREADS < nq) x[u] = __ldg(q4 + q + u * THREADS);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int qq = q + u * THREADS;
        if (qq < nq) {
          const int v = cb + 4 * qq;
          off(bs + x[u].x, id(k, v));
          off(bs + x[u].y, id(k, v + 1));
          off(bs + x[u].z, id(k, v + 2));
          off(bs + x[u].w, id(k, v + 3));
        }
      }
    }
    if (tid < c1 - ct) off(bs + row[ct + tid], id(k, ct + tid));
    float ov[K];
    int oi[K];
    warp_merge<K>(sv, si, ov, oi);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        smv[warp * K + j] = ov[j];
        smi[warp * K + j] = oi[j];
      }
    }
    __syncthreads();
    if (warp == 0) {
      clear<K>(sv, si);
      if (lane < WARPS) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          sv[j] = smv[lane * K + j];
          si[j] = smi[lane * K + j];
        }
      }
      warp_merge<K>(sv, si, ov, oi);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          part_v[pofs + j] = ov[j];
          part_i[pofs + j] = oi[j];
        }
      }
    }
  }
  // Thread 0 wrote the partials: publish them, then take the ticket.
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&counters[b], 1u) == (unsigned int)(beams * S - 1);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// Stage 1 of CTA blockIdx.x = r * S + s, rows r = b * K + k: writes the
// slice's K best to part[(r * S + s) * K ...] with ids id(k, v), then takes
// the sentence's ticket. Returns true, in every thread, in the CTA that
// arrived last of sentence b's K * S.
template <int K, class Id>
__device__ bool stage1(const float* __restrict__ logits,
                       const float* __restrict__ base,
                       const uint8_t* __restrict__ fin, float* part_v,
                       int* part_i, unsigned int* counters, int V, int S,
                       int pad_id, const Id& id) {
  return stage1_body<K, Id, false>(logits, base, fin, part_v, part_i, counters,
                                   V, S, pad_id, id, K, false, 0.f, 0);
}

// Stage 1 of one pass (see the head of this file): nb beams a sentence,
// 16-wide lists at part[(r * S + s) * PASS_K ...], candidates strictly
// worse than (av, ai) when filt (every pass after the first).
constexpr int PASS_K = 16;
template <class Id>
__device__ bool stage1_pass(const float* __restrict__ logits,
                            const float* __restrict__ base,
                            const uint8_t* __restrict__ fin, float* part_v,
                            int* part_i, unsigned int* counters, int V, int S,
                            int pad_id, const Id& id, int nb, bool filt,
                            float av, int ai) {
  return stage1_body<PASS_K, Id, true>(logits, base, fin, part_v, part_i,
                                       counters, V, S, pad_id, id, nb, filt,
                                       av, ai);
}

// Entries [kofs, kofs + 16) of a sentence's top-K, with kofs = 16 p: how
// many of them a pass of K writes.
__device__ __forceinline__ int pass_width(int K, int kofs) {
  return min(PASS_K, K - kofs);
}

}  // namespace split
}  // namespace vag
