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
// ahead in registers, and run 3xTF32 mma.sync against the resident slice,
// each warp an m16 tile and a k-slice, the k-slices added in a fixed
// order in the epilogue (dec_scan.cuh's product). The readout does not
// feed the recurrence: a second grid runs it as streamed 64 x 64 tiles
// over all Tt*B rows (c @ wc, then s' @ ws into the same accumulators,
// from a cp.async ring, several CTAs a SM) with the tanh in the epilogue.
// Every output has one owner and a fixed sum order, so a second call
// repeats the first bit for bit. The tiling is ops/dec_scan.py's
// dec_scan_plan.
//
// Replay (bf16 instance only). The JAX kernel under bf16 saves the states
// s' in bf16 and its backward recomputes each step from them (s~, the
// attention, GRU2's gates and the readout), not from the fp32 carry.
// dec_scan_fwd_launch(..., replay = 1) runs that recompute: s is then an
// input, s[0] = s0 and s[t + 1] the saved state of step t (bf16 values in
// fp32), each step starts from s[t] and GRU2's s' is not written, so the
// residuals (and the readout, on the saved s') are the ones the JAX
// backward sees.

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
  int replay;                   // 1: s is the saved states (see the top)
#endif
};

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
      if (col < min(C, c0 + per)) g.c[(tB + b) * C + col] = half[i] + half[per + i];
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
        st_t[(size_t)row * H + u] =
            gru_unit(ldx(x), ldx(x + H), ldx(x + 2 * H), hg[0], hg[1], hg[2], h);
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
        if (!g.replay)
#endif
        g.s[(tB + B + row) * H + u] = gru_unit(xg[0], xg[1], xg[2], hg[0], hg[1], hg[2], h);
      }
    });
    grid.sync();
    stamp(g.timers, n_stamp++);
  }
}

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
// phases). Enqueues the recurrence as one cooperative grid and the readout
// as one grid of streamed tiles. replay (bf16 build only): see the top;
// s then holds the states on entry and is not written. Returns 0,
// cudaErrorInvalidValue for a malformed plan,
// cudaErrorCooperativeLaunchTooLarge for a grid that is not co-resident, or
// the launch's error.
extern "C" int dec_scan_fwd_launch(
    const void* ty, const void* xg1, const void* s0, const void* ctx,
    const void* ctxp, const void* mask, const void* uh1, const void* bh1,
    const void* ua, const void* va, const void* wi2, const void* bi2,
    const void* uh2, const void* bh2, const void* ws, const void* wc, void* s,
    void* st, void* c, void* w, void* q, void* hg1, void* xg2, void* hg2,
    void* t_out, int Tt, int B, int T, int H, int A, int C, int R,
    const int* plan, int n_plan, void* wl2, void* timers,
#if VAG_SCAN_BF16
    int replay,
#endif
    void* stream) {
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
  g.replay = replay;
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
#if VAG_SCAN_BF16
  j.bbf[0] = j.bbf[1] = 1;   // bf16 weights; c and s' rounded
  j.rnd = 1;
#endif
  j.M = Tt * B; j.N = R; j.epi = TANH_ADD; j.batch = 1;
  j.out = g.t; j.ldo = R; j.add = F(ty);
  return (int)launch_jobs(dec_scan_fwd_readout_kernel, ro, cs);
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
