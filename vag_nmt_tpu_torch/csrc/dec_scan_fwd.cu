// Teacher-forced decoder scan, forward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_dec_scan.py, _fwd_kernel (entry
// pallas_decoder_scan), the conditional-GRU decoder's recurrence in
// training. Per target step t, from the state s:
//   s~   = GRU1(xg1[t], hg1 = s @ uh1 + bh1, s)
//   q    = s~ @ ua;  hg2 = s~ @ uh2 + bh2
//   e    = tanh(ctxp + q)  (ctxp = ctx @ wa + ba, the bias folded outside)
//   w    = softmax over source positions of (e . va), masked to -1e9
//   c    = sum_j w[j] ctx[j]
//   s'   = GRU2(xg2 = c @ wi2 + bi2, hg2, s~)
// and the readout t = tanh(ty[t] + s' @ ws + c @ wc) (b folded into ty).
//
// Bound on this card at B=64, T=Tt=24, full width (H=A=512, C=1024,
// R=256): per step 2*B*(H*3H + H*A + H*3H + C*3H + H*R + C*R) ~= 0.42
// GFLOP of products, run as three TF32 products each (3xTF32) on the tensor
// cores at 495 TFLOP/s, and the attention's energies and context sums on
// the fp32 cores at 67 TFLOP/s; bound by operations (chip_smoke.py's
// _dec_scan_bound).
//
// Design. The TPU kernel keeps the weights and the batch tile's ctx /
// ctx_proj in VMEM across every step. Here the recurrence is one
// persistent cooperative grid, one CTA per SM, and the recurrent weights
// (uh1, ua, uh2, wi2: 13.6 MB at full width) stay resident in shared
// memory for the whole launch, split over the CTAs by output column
// (dec_scan.cuh's Prod, load_slice). Where a phase's slices do not fit,
// the plan puts them in a buffer in L2 instead, each CTA's own slices
// copied there once at entry and read through L2 every step; a CTA may
// take several column tiles of a product. A step is four phases with a
// grid sync after each:
//   (a) hg1 = s @ uh1 + bh1 on gate tiles (a unit block's r, z and n
//       columns), GRU1 in the epilogue: writes hg1 and s~;
//   (b) q = s~ @ ua and hg2 = s~ @ uh2 + bh2, on disjoint CTAs;
//   (c) the attention, a sentence's row taken by att_parts CTAs (each
//       computes the row's scores and softmax, and sums its share of the C
//       context columns): writes w and c;
//   (d) xg2 = c @ wi2 + bi2 on gate tiles, GRU2 in the epilogue: writes
//       xg2 and s'.
// A product's lanes load their activation rows straight from L2, slabs
// ahead in registers (the bf16 instance loads the fp32 rows and rounds
// them to bf16 there; the bf16 copies of s, s~ and c that the recurrence
// writes feed only the time-parallel tile grids: the readout below and
// the backward's), and run 3xTF32 mma.sync (bf16: m16n8k16) against the
// resident slice,
// each warp an m16 tile and a k-slice, the k-slices added in a fixed
// order in the epilogue (dec_scan.cuh's product). The readout does not
// feed the recurrence: a second grid runs it as streamed 64 x 64 tiles
// over all Tt*B rows (c @ wc, then s' @ ws into the same accumulators,
// from a cp.async ring, several CTAs a SM; the bf16 instance:
// bf16_tile.cuh's m16n8k16 tiles of the bf16 copies) with the tanh in the
// epilogue.
// Every output has one owner and a fixed sum order, so a second call
// repeats the first bit for bit. The tiling is ops/dec_scan.py's
// dec_scan_plan.
//
// The backward's replay (bf16 instance only). The JAX kernel under bf16
// saves the states s' in bf16 and its backward recomputes each step from
// them (s~, the attention, GRU2's gates and the readout), not from the
// fp32 carry. Step t of that recompute reads only the saved states[t], so
// no step depends on another: dec_scan_replay_launch runs it as
// time-parallel grids over all Tt * B rows at once, with no cooperative
// grid and no grid sync (bf16_tile.cuh's tiles on the bf16 tensor cores):
//   1. hg1 = S @ uh1 + bh1 on gate tiles, GRU1 in the epilogue: hg1, s~
//      (S = states[0:Tt] in bf16; GRU1 reads them in fp32);
//   2. q = s~ @ ua and hg2 = s~ @ uh2 + bh2;
//   3. the attention of every (t, b) row, a CTA taking RG steps of one
//      sentence (each ctx_proj and ctx value it reads serves RG rows): w,
//      c;
//   4. xg2 = c @ wi2 + bi2 and the readout t = tanh(ty + c @ wc + S' @ ws)
//      (S' = states[1:]).
// It writes no s', and bf16 copies of s~ and c for the backward's
// products. Bound on this card: at B=64, T=Tt=24 the bytes it moves (the
// fp32 residuals it writes, most of them) at the memory rate; at
// T=Tt=128 the energies' operations (chip_smoke.py's
// _dec_scan_bf16_bound("replay", ...)).

#include "dec_scan.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace vag::scan;
using vag::gru_unit;
using vag::tanh_fast;
using vag::warp_max;
using vag::warp_sum;

enum { P_HG1 = 0, P_Q = 1, P_HG2 = 2, P_XG2 = 3 };

struct FwdArgs {
  const sx_t* xg1;              // bf16 instance: the bf16 streams
  const sx_t* ctx;
  const float *s0, *ctxp, *mask;
  const float *bh1, *va, *bi2, *bh2;
  float *s, *st, *c, *w, *q, *hg1, *xg2, *hg2, *t;
  int Tt, B, T, H, A, C, R;
  Prod p[4];
  int att_parts, scratch_off;
  float* wl2;                   // the weight slices the plan puts in L2
  unsigned long long* timers;   // 4 Tt + 2 barrier stamps, or null
#if VAG_SCAN_BF16
  // bf16 copies (the readout's operands, and the backward's): s (Tt + 1,
  // B, H; s[0] = s0 rounded), s~, c; written beside the fp32 values
  __nv_bfloat16 *sb, *stb, *cb;
#endif
};

#if VAG_SCAN_BF16
// Phase (c)'s context sums for the bf16 ctx (C and the part's columns
// multiples of 8, ctx 16-byte aligned): eight columns a thread from one
// 16-byte load a position, kept in bf16 until used (twice the columns a
// load of the four-wide path, for the same registers), the positions in
// four quarters (twice the threads of two halves: each thread's chain of
// loads half as long), added as (q0 + q1) + (q2 + q3) through the two
// halves' shared rows; then c and its bf16 copy. Rounds of THREADS / 4
// column groups. sc: the row's softmax; half: 2 x the part's columns of
// shared memory.
__device__ void context_bf16(const FwdArgs& g, int t, int b, int part, const float* sc,
                             float* half) {
  const int B = g.B, T = g.T, C = g.C, per = att_cols(C, g.att_parts);
  const int c0 = part * per, ng = (min(C, c0 + per) - c0) / 8;
  for (int g0 = 0; g0 < ng; g0 += THREADS / 4) {
    const int ngr = min(THREADS / 4, ng - g0), i = threadIdx.x;
    const int gl = i % ngr, h = i / ngr, col = c0 + 8 * (g0 + gl);
    const bool act = i < 4 * ngr;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    const int jend = act ? (h + 1) * T / 4 : 0;
    for (int j0 = h * T / 4; j0 < jend; j0 += ATT_BATCH) {
      uint4 x[ATT_BATCH];
#pragma unroll
      for (int u = 0; u < ATT_BATCH; ++u)
        x[u] = load8(g.ctx, C, b * T + j0 + u, j0 + u < jend ? B * T : 0, col, C);
#pragma unroll
      for (int u = 0; u < ATT_BATCH; ++u) {
        const float w = j0 + u < jend ? sc[j0 + u] : 0.f;
        const uint32_t xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * e] = fmaf(w, bf_lo(xs[e]), acc[2 * e]);
          acc[2 * e + 1] = fmaf(w, bf_hi(xs[e]), acc[2 * e + 1]);
        }
      }
    }
    // quarters 1 and 3 put theirs in the halves; 0 and 2 add them
    float* d = half + (size_t)(h >> 1) * per + 8 * gl;
    if (act && (h & 1)) {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = acc[e];
    }
    __syncthreads();
    if (act && !(h & 1)) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += d[e];
    }
    __syncthreads();
    if (act && h == 2) {   // q2 + q3 to the first half
#pragma unroll
      for (int e = 0; e < 8; ++e) half[8 * gl + e] = acc[e];
    }
    __syncthreads();
    if (act && h == 0) {   // (q0 + q1) + (q2 + q3): c and its bf16 copy
      const size_t o = ((size_t)t * B + b) * C + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = acc[e] + half[8 * gl + e];
        g.c[o + e] = v;
        g.cb[o + e] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();   // the next round, or the next item, rewrites the halves
  }
}
#endif

// Phase (c) for step t: item i = b * att_parts + part (items taken by the
// CTAs in turn). Each CTA of a row computes the row's scores (energies on
// tanh_fast) and softmax, then sums its part's context columns, the
// positions split in two halves added in order. A warp scores JB positions
// at once, all their ctx_proj loads in flight before the first energy.
// Shared (att_floats_fwd): q and va (A, zero-padded to a multiple of 4),
// the mask and the scores (T each), the halves' column sums (2 x the
// part's columns).
__device__ void attention(const FwdArgs& g, int t, float* sm) {
  const int B = g.B, T = g.T, A = g.A, C = g.C, P = g.att_parts;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int A4 = round_up(A, 4), T4 = round_up(T, 4), per = att_cols(C, P);
  float* qs = sm;
  float* vs = qs + A4;
  float* msk = vs + A4;
  float* sc = msk + T4;
  float* half = sc + T4;
  const bool vp = A % 4 == 0 && al16(g.ctxp), vc = C % 4 == 0 && al16(g.ctx);
#if VAG_SCAN_BF16
  const bool c8 = C % 8 == 0 && per % 8 == 0 && al16(g.ctx);
#endif
  const size_t tB = (size_t)t * B;
  for (int item = blockIdx.x; item < B * P; item += gridDim.x) {
    const int b = item / P, part = item % P;
    for (int i = tid; i < A4; i += THREADS) {
      qs[i] = i < A ? __ldcg(g.q + (tB + b) * A + i) : 0.f;
      vs[i] = i < A ? __ldg(g.va + i) : 0.f;
    }
    for (int i = tid; i < T; i += THREADS) msk[i] = __ldg(g.mask + (size_t)b * T + i);
    __syncthreads();
    for (int j0 = warp; j0 < T; j0 += WARPS * JB) {
      float acc[JB];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) acc[jj] = 0.f;
      for (int a0 = 4 * lane; a0 < A; a0 += 512) {
        float4 x[JB][4];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + jj * WARPS;
            x[jj][u] = load4(g.ctxp, A, b * T + j, j < T ? B * T : 0, a0 + 128 * u, A, vp);
          }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int a = a0 + 128 * u;
          if (a >= A) break;
          const float4 q = *reinterpret_cast<const float4*>(qs + a);
          const float4 v = *reinterpret_cast<const float4*>(vs + a);
#pragma unroll
          for (int jj = 0; jj < JB; ++jj)
            acc[jj] += tanh_fast(x[jj][u].x + q.x) * v.x + tanh_fast(x[jj][u].y + q.y) * v.y +
                       tanh_fast(x[jj][u].z + q.z) * v.z + tanh_fast(x[jj][u].w + q.w) * v.w;
        }
      }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int j = j0 + jj * WARPS;
        const float e = warp_sum(acc[jj]);
        if (lane == 0 && j < T) sc[j] = msk[j] > 0.f ? e : NEG_INF;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -INFINITY;
      for (int j = lane; j < T; j += 32) mx = fmaxf(mx, sc[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float e = expf(sc[j] - mx);
        sc[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < T; j += 32) {
        sc[j] = sc[j] / sum;
        if (part == 0) g.w[(tB + b) * T + j] = sc[j];
      }
    }
    __syncthreads();
#if VAG_SCAN_BF16
    if (c8) {
      context_bf16(g, t, b, part, sc, half);
      continue;
    }
#endif
    // the part's columns, 4 a thread, positions [0, T/2) and [T/2, T)
    const int c0 = part * per, ng = (min(C, c0 + per) - c0 + 3) / 4, Th = T / 2;
    for (int i = tid; i < 2 * ng; i += THREADS) {
      const int gi = i % ng, h = i / ng, col = c0 + 4 * gi;
      const int jend = h ? T : Th;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j0 = h ? Th : 0; j0 < jend; j0 += ATT_BATCH) {
        float4 x[ATT_BATCH];
#pragma unroll
        for (int u = 0; u < ATT_BATCH; ++u)
          x[u] = load4(g.ctx, C, b * T + j0 + u, j0 + u < jend ? B * T : 0, col, C, vc);
#pragma unroll
        for (int u = 0; u < ATT_BATCH; ++u) {
          const float w = j0 + u < jend ? sc[j0 + u] : 0.f;
          acc.x = fmaf(w, x[u].x, acc.x);
          acc.y = fmaf(w, x[u].y, acc.y);
          acc.z = fmaf(w, x[u].z, acc.z);
          acc.w = fmaf(w, x[u].w, acc.w);
        }
      }
      *reinterpret_cast<float4*>(half + (size_t)h * per + 4 * gi) = acc;
    }
    __syncthreads();
    for (int i = tid; i < ng * 4; i += THREADS) {
      const int col = c0 + i;
#if VAG_SCAN_BF16
      if (col < min(C, c0 + per)) {
        const float v = half[i] + half[per + i];
        g.c[(tB + b) * C + col] = v;
        g.cb[(tB + b) * C + col] = __float2bfloat16_rn(v);
      }
#else
      if (col < min(C, c0 + per)) g.c[(tB + b) * C + col] = half[i] + half[per + i];
#endif
    }
    __syncthreads();   // the next item refills the shared row
  }
}

// tanh_fast and tanhf of x (n values), for chip_smoke.py's measurement of
// the energies' tanh.
__global__ void tanh_probe_kernel(const float* __restrict__ x, float* fast,
                                  float* ref, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    fast[i] = tanh_fast(x[i]);
    ref[i] = tanhf(x[i]);
  }
}

// The readout's grid of streamed tiles (dec_scan.cuh's run_jobs).
__global__ void __launch_bounds__(THREADS, 2) dec_scan_fwd_readout_kernel(const Jobs js) {
  run_jobs(js);
}

// GENERAL: see dec_scan.cuh's product.
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1) dec_scan_fwd_kernel(const FwdArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem + g.scratch_off;
  const int B = g.B, H = g.H, A = g.A, C = g.C, H3 = 3 * H;
  cg::grid_group grid = cg::this_grid();
  int n_stamp = 0;
  stamp(g.timers, n_stamp++);
  for (int i = 0; i < 4; ++i) load_slice(g.p[i], smem, g.wl2);
#if VAG_SCAN_BF16
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B * H; i += gridDim.x * THREADS)
    g.sb[i] = __float2bfloat16_rn(g.s0[i]);
#endif
  __syncthreads();
  grid.sync();
  stamp(g.timers, n_stamp++);

  for (int t = 0; t < g.Tt; ++t) {
    const size_t tB = (size_t)t * B;
    const float* s_prev = t == 0 ? g.s0 : g.s + tB * H;
    float* st_t = g.st + tB * H;
    // (a) hg1 = s @ uh1 + bh1, GRU1: s~ (and s[0] = s0 at the first step)
    product<GENERAL>(g.p[P_HG1], s_prev, H, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int ub = g.p[P_HG1].ub, rt = g.p[P_HG1].rt;
      for (int i = threadIdx.x; i < rt * ub; i += THREADS) {
        const int r = i / ub, uu = i % ub, row = row0 + r, u = ct * ub + uu;
        if (row >= B || u >= H) continue;
        float hg[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          hg[k] = tile_sum(part, KS, MT, NI, r, k * ub + uu) + __ldg(g.bh1 + k * H + u);
          g.hg1[(tB + row) * H3 + k * H + u] = hg[k];
        }
        const sx_t* x = g.xg1 + (tB + row) * H3 + u;
        const float h = __ldcg(s_prev + (size_t)row * H + u);
#if VAG_SCAN_BF16
        const float st = gru_unit(ldx(x), ldx(x + H), ldx(x + 2 * H), hg[0], hg[1], hg[2], h);
        st_t[(size_t)row * H + u] = st;
        g.stb[(tB + row) * H + u] = __float2bfloat16_rn(st);
#else
        st_t[(size_t)row * H + u] =
            gru_unit(ldx(x), ldx(x + H), ldx(x + 2 * H), hg[0], hg[1], hg[2], h);
#endif
        if (t == 0) g.s[(size_t)row * H + u] = h;
      }
    });
    grid.sync();
    stamp(g.timers, n_stamp++);
    // (b) q = s~ @ ua;  hg2 = s~ @ uh2 + bh2
    product<GENERAL>(g.p[P_Q], st_t, H, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int nt = g.p[P_Q].nt, rt = g.p[P_Q].rt;
      for (int i = threadIdx.x; i < rt * nt; i += THREADS) {
        const int r = i / nt, j = i % nt, row = row0 + r, col = ct * nt + j;
        if (row >= B || col >= A) continue;
        g.q[(tB + row) * A + col] = tile_sum(part, KS, MT, NI, r, j);
      }
    });
    product<GENERAL>(g.p[P_HG2], st_t, H, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int nt = g.p[P_HG2].nt, rt = g.p[P_HG2].rt;
      for (int i = threadIdx.x; i < rt * nt; i += THREADS) {
        const int r = i / nt, j = i % nt, row = row0 + r, col = ct * nt + j;
        if (row >= B || col >= H3) continue;
        g.hg2[(tB + row) * H3 + col] = tile_sum(part, KS, MT, NI, r, j) + __ldg(g.bh2 + col);
      }
    });
    grid.sync();
    stamp(g.timers, n_stamp++);
    // (c) the attention: w, c
    attention(g, t, scratch);
    grid.sync();
    stamp(g.timers, n_stamp++);
    // (d) xg2 = c @ wi2 + bi2, GRU2: s'
    product<GENERAL>(g.p[P_XG2], g.c + tB * C, C, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int ub = g.p[P_XG2].ub, rt = g.p[P_XG2].rt;
      for (int i = threadIdx.x; i < rt * ub; i += THREADS) {
        const int r = i / ub, uu = i % ub, row = row0 + r, u = ct * ub + uu;
        if (row >= B || u >= H) continue;
        float xg[3], hg[3];
        const float* h2 = g.hg2 + (tB + row) * H3 + u;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xg[k] = tile_sum(part, KS, MT, NI, r, k * ub + uu) + __ldg(g.bi2 + k * H + u);
          g.xg2[(tB + row) * H3 + k * H + u] = xg[k];
          hg[k] = __ldcg(h2 + k * H);
        }
        const float h = __ldcg(st_t + (size_t)row * H + u);
#if VAG_SCAN_BF16
        const float s1 = gru_unit(xg[0], xg[1], xg[2], hg[0], hg[1], hg[2], h);
        g.s[(tB + B + row) * H + u] = s1;
        g.sb[(tB + B + row) * H + u] = __float2bfloat16_rn(s1);
#else
        g.s[(tB + B + row) * H + u] = gru_unit(xg[0], xg[1], xg[2], hg[0], hg[1], hg[2], h);
#endif
      }
    });
    grid.sync();
    stamp(g.timers, n_stamp++);
  }
}

#if VAG_SCAN_BF16
// The grids of bf16 tiles (bf16_tile.cuh): the replay's products and the
// forward's readout.
__global__ void __launch_bounds__(vag::bt::THREADS, 3)
    dec_scan_fwd_tiles_kernel(const vag::bt::Jobs js) {
  vag::bt::run(js);
}

// The replay's attention: CTA (b, blockIdx.y) takes sentence b at the RG
// steps t0 = RG blockIdx.y .. t0 + RG - 1 at once, so each ctx_proj and
// ctx element it reads from L2 serves RG rows (one CTA a row read each
// RG times). Scores: warp w takes positions w, w + WARPS, ..., two at a
// time, its lanes the A columns (energies on tanh_fast, each loaded
// ctx_proj value against the RG queries); the softmax of row tt in warp
// tt; then thread i sums context columns 4 i .. 4 i + 3 over the
// positions in order for the RG rows. Shared: the RG queries and va (A,
// zero-padded to a multiple of 4), the mask (T), the RG rows' scores (T).
constexpr int RG = 4;
__global__ void __launch_bounds__(THREADS)
    dec_scan_fwd_replay_attention_kernel(const FwdArgs g) {
  extern __shared__ __align__(16) float smem[];
  const int B = g.B, T = g.T, A = g.A, C = g.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x, t0 = blockIdx.y * RG, nt = min(RG, g.Tt - t0);
  const int A4 = round_up(A, 4), T4 = round_up(T, 4);
  float* qs = smem;            // [RG][A4]
  float* vs = qs + RG * A4;    // [A4]
  float* msk = vs + A4;        // [T4]
  float* sc = msk + T4;        // [RG][T4]
  for (int i = tid; i < RG * A4; i += THREADS) {
    const int tt = i / A4, a = i % A4;
    qs[i] = tt < nt && a < A ? __ldg(g.q + ((size_t)(t0 + tt) * B + b) * A + a) : 0.f;
  }
  for (int i = tid; i < A4; i += THREADS) vs[i] = i < A ? __ldg(g.va + i) : 0.f;
  for (int i = tid; i < T; i += THREADS) msk[i] = __ldg(g.mask + (size_t)b * T + i);
  __syncthreads();
  const bool vp = A % 4 == 0 && al16(g.ctxp), vc = C % 4 == 0 && al16(g.ctx);
  for (int j0 = warp; j0 < T; j0 += 2 * WARPS) {
    float acc[2][RG];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int tt = 0; tt < RG; ++tt) acc[jj][tt] = 0.f;
    for (int a0 = 4 * lane; a0 < A; a0 += 512) {
      float4 x[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + jj * WARPS;
          x[jj][u] = load4(g.ctxp, A, b * T + j, j < T ? B * T : 0, a0 + 128 * u, A, vp);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int a = a0 + 128 * u;
        if (a >= A) break;
        const float4 v = *reinterpret_cast<const float4*>(vs + a);
#pragma unroll
        for (int tt = 0; tt < RG; ++tt) {
          const float4 q = *reinterpret_cast<const float4*>(qs + tt * A4 + a);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            acc[jj][tt] += tanh_fast(x[jj][u].x + q.x) * v.x + tanh_fast(x[jj][u].y + q.y) * v.y +
                           tanh_fast(x[jj][u].z + q.z) * v.z + tanh_fast(x[jj][u].w + q.w) * v.w;
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int tt = 0; tt < RG; ++tt) {
        const int j = j0 + jj * WARPS;
        const float e = warp_sum(acc[jj][tt]);
        if (lane == 0 && j < T) sc[tt * T4 + j] = msk[j] > 0.f ? e : NEG_INF;
      }
  }
  __syncthreads();
  if (warp < nt) {   // the softmax of row `warp`
    float* r = sc + warp * T4;
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, r[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(r[j] - mx);
      r[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const size_t row = (size_t)(t0 + warp) * B + b;
    for (int j = lane; j < T; j += 32) {
      r[j] = r[j] / sum;
      g.w[row * T + j] = r[j];
    }
  }
  __syncthreads();
  constexpr int U = 8;   // positions whose ctx loads a thread keeps in flight
  for (int c4 = 4 * tid; c4 < C; c4 += 4 * THREADS) {
    float4 acc[RG];
#pragma unroll
    for (int tt = 0; tt < RG; ++tt) acc[tt] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < T; j0 += U) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = load4(g.ctx, C, b * T + j0 + u, j0 + u < T ? B * T : 0, c4, C, vc);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u >= T) break;
#pragma unroll
        for (int tt = 0; tt < RG; ++tt) {
          const float w = sc[tt * T4 + j0 + u];
          acc[tt].x = fmaf(w, x[u].x, acc[tt].x);
          acc[tt].y = fmaf(w, x[u].y, acc[tt].y);
          acc[tt].z = fmaf(w, x[u].z, acc[tt].z);
          acc[tt].w = fmaf(w, x[u].w, acc[tt].w);
        }
      }
    }
#pragma unroll
    for (int tt = 0; tt < RG; ++tt) {
      if (tt >= nt) break;
      const size_t o = ((size_t)(t0 + tt) * B + b) * C + c4;
      const float v[4] = {acc[tt].x, acc[tt].y, acc[tt].z, acc[tt].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c4 + e >= C) break;
        g.c[o + e] = v[e];
        g.cb[o + e] = __float2bfloat16_rn(v[e]);
      }
    }
  }
}
#endif

}  // namespace

// Device pointers to contiguous fp32 tensors:
//   ty (Tt, B, R) with b folded in, xg1 (Tt, B, 3H), s0 (B, H),
//   ctx (B, T, C), ctxp (B, T, A) with ba folded in, mask (B, T),
//   uh1 (H, 3H), bh1 (3H,), ua (H, A), va (A,), wi2 (C, 3H), bi2 (3H,),
//   uh2 (H, 3H), bh2 (3H,), ws (H, R), wc (C, R);
//   outputs s (Tt + 1, B, H) (s[0] = s0), st (Tt, B, H) = s~, c (Tt, B, C),
//   w (Tt, B, T), q (Tt, B, A), hg1, xg2, hg2 (Tt, B, 3H), t (Tt, B, R).
// plan: n_plan ints from ops/dec_scan.py's launch_args: the grid's CTAs,
// the attention's parts a row, the scratch region's float offset, the
// dynamic shared memory in bytes, the floats of the weight buffer wl2,
// then for each product (hg1, q, hg2, xg2) ub, nt, rt, nr, col_tiles, cs,
// cta0, woff, l2off. wl2: that many device floats of scratch, or null
// when the plan puts no slice in L2. timers: null, or 4 Tt + 2 uint64 for
// the barrier stamps (entry, weights loaded, the end of each step's four
// phases). bf16 build: then sb (Tt + 1, B, H), stb (Tt, B, H) and cb
// (Tt, B, C), the bf16 copies of s (s[0] = s0 rounded), s~ and c that the
// recurrence writes for its products, the readout and the backward.
// Enqueues the recurrence as one cooperative grid and the readout as one
// grid of streamed tiles (bf16 build: bf16_tile.cuh's tiles on sb and
// cb). Returns 0,
// cudaErrorInvalidValue for a malformed plan,
// cudaErrorCooperativeLaunchTooLarge for a grid that is not co-resident, or
// the launch's error.
extern "C" int dec_scan_fwd_launch(
    const void* ty, const void* xg1, const void* s0, const void* ctx,
    const void* ctxp, const void* mask, const void* uh1, const void* bh1,
    const void* ua, const void* va, const void* wi2, const void* bi2,
    const void* uh2, const void* bh2, const void* ws, const void* wc, void* s,
    void* st, void* c, void* w, void* q, void* hg1, void* xg2, void* hg2,
    void* t_out,
#if VAG_SCAN_BF16
    void* sb, void* stb, void* cb,
#endif
    int Tt, int B, int T, int H, int A, int C, int R,
    const int* plan, int n_plan, void* wl2, void* timers, void* stream) {
  if (n_plan != 5 + 4 * 9 || Tt < 1 || B < 1 || T < 1 || H < 1 || A < 1 ||
      C < 1 || R < 1 || plan[4] < 0 || (plan[4] > 0 && wl2 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto X = [](const void* p) { return static_cast<const sx_t*>(p); };
  auto M = [](void* p) { return static_cast<float*>(p); };
  FwdArgs g{};
  g.xg1 = X(xg1); g.s0 = F(s0); g.ctx = X(ctx); g.ctxp = F(ctxp);
  g.mask = F(mask); g.bh1 = F(bh1); g.va = F(va); g.bi2 = F(bi2);
  g.bh2 = F(bh2);
  g.s = M(s); g.st = M(st); g.c = M(c); g.w = M(w); g.q = M(q);
  g.hg1 = M(hg1); g.xg2 = M(xg2); g.hg2 = M(hg2); g.t = M(t_out);
  g.Tt = Tt; g.B = B; g.T = T; g.H = H; g.A = A; g.C = C; g.R = R;
  g.timers = static_cast<unsigned long long*>(timers);
  g.wl2 = M(wl2);
#if VAG_SCAN_BF16
  g.sb = static_cast<__nv_bfloat16*>(sb);
  g.stb = static_cast<__nv_bfloat16*>(stb);
  g.cb = static_cast<__nv_bfloat16*>(cb);
#endif
  const int ctas = plan[0], smem_bytes = plan[3];
  g.att_parts = plan[1];
  g.scratch_off = plan[2];
  const int H3 = 3 * H;
  // (weights, W's row stride, K, output columns) of hg1, q, hg2, xg2
  const sx_t* wts[4] = {X(uh1), X(ua), X(uh2), X(wi2)};
  const int ldw[4] = {H3, A, H3, H3}, K[4] = {H, H, H, C}, cols[4] = {H3, A, H3, H3};
  if (plan[1] < 1) return (int)cudaErrorInvalidValue;
  int scratch_need = att_floats_fwd(T, A, C, plan[1]);
  for (int i = 0; i < 4; ++i) {
    const int* v = plan + 5 + 9 * i;
    g.p[i] = Prod{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], K[i], cols[i],
                  H, wts[i], ldw[i], 0};
    if (!prod_ok(g.p[i], ctas, g.scratch_off, plan[4]) ||
        (g.p[i].ub != 0) != (i == P_HG1 || i == P_XG2))
      return (int)cudaErrorInvalidValue;
    scratch_need = max(scratch_need, prod_part_floats(g.p[i]));
  }
  if (ctas < 1 || g.att_parts < 1 || g.scratch_off % 4 != 0 ||
      (long long)4 * (g.scratch_off + scratch_need) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  void (*kern)(FwdArgs) = plan_general(g.p, 4, plan[4]) ? &dec_scan_fwd_kernel<true>
                                                     : &dec_scan_fwd_kernel<false>;
  const int rc = launch_cooperative(kern, g, ctas, smem_bytes, cs);
  if (rc != 0) return rc;
#if VAG_SCAN_BF16
  // The readout over all Tt*B rows on bf16 tiles of the bf16 copies:
  // t = tanh(ty + (c @ wc + s' @ ws)).
  vag::bt::Jobs ro{};
  vag::bt::Job& j = ro.j[0];
  ro.n = 1;
  j.nseg = 2;
  j.s[0] = vag::bt::Seg{g.cb, X(wc), C, R, C};
  j.s[1] = vag::bt::Seg{g.sb + (size_t)B * H, X(ws), H, R, H};
  j.M = Tt * B; j.N = R; j.epi = vag::bt::TANH_ADD;
  j.out = g.t; j.ldo = R; j.add = F(ty);
  return (int)vag::bt::launch(dec_scan_fwd_tiles_kernel, ro, cs);
#else
  // The readout over all Tt*B rows: t = tanh(ty + (c @ wc + s' @ ws)).
  Jobs ro{};
  Job& j = ro.j[0];
  ro.n = 1;
  j.nseg = 2;
  j.a[0] = g.c; j.lda[0] = C; j.ldb[0] = R; j.kd[0] = C;
  j.a[1] = g.s + (size_t)B * H; j.lda[1] = H; j.ldb[1] = R;
  j.kd[1] = H;
  j.b[0] = reinterpret_cast<const float*>(X(wc));
  j.b[1] = reinterpret_cast<const float*>(X(ws));
  j.M = Tt * B; j.N = R; j.epi = TANH_ADD; j.batch = 1;
  j.out = g.t; j.ldo = R; j.add = F(ty);
  return (int)launch_jobs(dec_scan_fwd_readout_kernel, ro, cs);
#endif
}

// tanh_fast and tanhf of x (n device floats) into fast and ref, on stream.
extern "C" int dec_scan_tanh_probe(const void* x, void* fast, void* ref, int n,
                                   void* stream) {
  if (n < 1) return 0;
  tanh_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(fast),
      static_cast<float*>(ref), n);
  return (int)cudaGetLastError();
}

#if VAG_SCAN_BF16
// The backward's replay (see the top). Device pointers to contiguous
// tensors: ty (Tt, B, R) fp32 with b folded in, xg1 (Tt, B, 3H) bf16, the
// states (Tt + 1, B, H) in fp32 (sf: states[0] = s0, states[t + 1] the
// bf16 state saved at step t) and in bf16 (sb), ctx (B, T, C) bf16, ctxp
// (B, T, A) and mask (B, T) fp32, the weights as dec_scan_fwd_launch's
// (the six matrices bf16); outputs st (Tt, B, H) in fp32 and in bf16
// (stb), c (Tt, B, C) in fp32 and in bf16 (cb), w, q, hg1, xg2, hg2 and t
// as dec_scan_fwd_launch's. Enqueues four grids on stream; returns 0,
// cudaErrorInvalidValue for a non-positive size, or the launch's error.
extern "C" int dec_scan_replay_launch(
    const void* ty, const void* xg1, const void* sf, const void* sb,
    const void* ctx, const void* ctxp, const void* mask, const void* uh1,
    const void* bh1, const void* ua, const void* va, const void* wi2,
    const void* bi2, const void* uh2, const void* bh2, const void* ws,
    const void* wc, void* st, void* stb, void* c, void* cb, void* w, void* q,
    void* hg1, void* xg2, void* hg2, void* t_out, int Tt, int B, int T, int H,
    int A, int C, int R, void* stream) {
  namespace bt = vag::bt;
  if (Tt < 1 || B < 1 || T < 1 || H < 1 || A < 1 || C < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto X = [](const void* p) { return static_cast<const bt::bf16*>(p); };
  auto M = [](void* p) { return static_cast<float*>(p); };
  auto MX = [](void* p) { return static_cast<bt::bf16*>(p); };
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int rows = Tt * B, H3 = 3 * H;
  auto job = [&](bt::Job& j, const void* a, const void* b, int lda, int ldb, int K,
                 int N, int epi, void* out, int ldo, const void* add) {
    j.nseg = 1;
    j.s[0] = bt::Seg{X(a), X(b), lda, ldb, K};
    j.M = rows; j.N = N; j.epi = epi;
    j.out = M(out); j.ldo = ldo; j.add = F(add);
  };
  // 1. hg1 = S @ uh1 + bh1 on gate tiles, GRU1: s~ in fp32 and bf16
  bt::Jobs g1{};
  g1.n = 1;
  job(g1.j[0], sb, uh1, H, H3, H, H, bt::GRU1, hg1, H3, bh1);
  g1.j[0].xg = X(xg1); g1.j[0].h = F(sf); g1.j[0].out2 = M(st); g1.j[0].outb = MX(stb);
  VAG_CHECK(bt::launch(dec_scan_fwd_tiles_kernel, g1, cs));
  // 2. q = s~ @ ua;  hg2 = s~ @ uh2 + bh2
  bt::Jobs g2{};
  g2.n = 2;
  job(g2.j[0], stb, ua, H, A, H, A, bt::STORE, q, A, nullptr);
  job(g2.j[1], stb, uh2, H, H3, H, H3, bt::BIAS, hg2, H3, bh2);
  VAG_CHECK(bt::launch(dec_scan_fwd_tiles_kernel, g2, cs));
  // 3. the attention of every (t, b) row, RG steps of a sentence a CTA:
  // w, c in fp32 and bf16
  FwdArgs g{};
  g.ctx = X(ctx); g.ctxp = F(ctxp); g.mask = F(mask); g.va = F(va);
  g.q = M(q); g.w = M(w); g.c = M(c); g.cb = MX(cb);
  g.Tt = Tt; g.B = B; g.T = T; g.H = H; g.A = A; g.C = C; g.R = R;
  const int A4 = (A + 3) / 4 * 4, T4 = (T + 3) / 4 * 4;
  const int smem = (int)sizeof(float) * ((RG + 1) * A4 + (RG + 1) * T4);
  VAG_CHECK(cudaFuncSetAttribute(dec_scan_fwd_replay_attention_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  dec_scan_fwd_replay_attention_kernel<<<dim3(B, (Tt + RG - 1) / RG), THREADS, smem, cs>>>(g);
  VAG_CHECK(cudaGetLastError());
  // 4. xg2 = c @ wi2 + bi2;  t = tanh(ty + c @ wc + S' @ ws)
  bt::Jobs g4{};
  g4.n = 2;
  job(g4.j[0], cb, wi2, C, H3, C, H3, bt::BIAS, xg2, H3, bi2);
  bt::Job& ro = g4.j[1];
  job(ro, cb, wc, C, R, C, R, bt::TANH_ADD, t_out, R, ty);
  ro.nseg = 2;
  ro.s[1] = bt::Seg{X(sb) + (size_t)B * H, X(ws), H, R, H};
  return (int)bt::launch(dec_scan_fwd_tiles_kernel, g4, cs);
}
#endif
