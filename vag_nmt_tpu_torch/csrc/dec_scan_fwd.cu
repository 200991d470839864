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
// Design. The TPU kernel keeps ~14.5 MB of weights and the batch tile's
// ctx/ctx_proj in VMEM across all steps; one SM holds 227 KB. Each step has
// three dependences across the whole row (q needs all of s~, attention all
// of q, GRU2 all of c), so a step is a short chain of grids on the caller's
// stream, whose order is the barrier: GEMM hg1, GRU1 cell, GEMM q, GEMM
// hg2, attention (one block per batch row), GEMM xg2, GRU2 cell: 7 grids a
// step. The per-step GEMMs have only B=64 rows, so they split their depth
// over several blocks per output tile (split-K, common.cuh) to fill the
// card. The weights and the ctx/ctx_proj of B=64, T=24 (~21 MB) stay in the
// 50 MB L2 between steps. The readout does not feed the recurrence, so it
// is hoisted out of the loop: two time-parallel GEMMs over all Tt*B rows
// and one elementwise tanh. Residuals: besides t and s the scan writes s~,
// c, w, q, hg1, xg2 and hg2 for every step, so the backward
// (dec_scan_bwd.cu) recomputes nothing but the attention energies.
//
// Bound on this card at B=64, T=Tt=24, full width (H=A=512, C=1024,
// R=256): per step 2*B*(H*3H + H*A + H*3H + C*3H + H*R + C*R) + the
// attention's 2*B*T*(A + C) ~= 0.49 GFLOP, 11.8 GFLOP in all, ~0.18 ms at
// 67 TFLOP/s fp32; bound by operations.

#include "common.cuh"

namespace {

constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr float NEG_INF = -1e9f;   // as ops/attention.masked_softmax

using vag::warp_max;
using vag::warp_sum;

// One block per batch row b. Shared: q (A), va (A), scores/weights (T).
__global__ void __launch_bounds__(ATT_THREADS)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ ctxp,
                const float* __restrict__ ctx, const float* __restrict__ mask,
                const float* __restrict__ va, float* __restrict__ w,
                float* __restrict__ c, int T, int A, int C) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* vs = sm + A;
  float* sc = sm + 2 * A;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < A; i += ATT_THREADS) {
    qs[i] = q[(size_t)b * A + i];
    vs[i] = va[i];
  }
  __syncthreads();
  for (int j = warp; j < T; j += ATT_WARPS) {
    const float* cp = ctxp + ((size_t)b * T + j) * A;
    float acc = 0.f;
    for (int a = lane; a < A; a += 32) acc += tanhf(cp[a] + qs[a]) * vs[a];
    acc = warp_sum(acc);
    if (lane == 0) sc[j] = mask[(size_t)b * T + j] > 0.f ? acc : NEG_INF;
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
      w[(size_t)b * T + j] = sc[j];
    }
  }
  __syncthreads();
  for (int k = tid; k < C; k += ATT_THREADS) {
    const float* cx = ctx + (size_t)b * T * C + k;
    float acc = 0.f;
    for (int j = 0; j < T; ++j) acc = fmaf(sc[j], cx[(size_t)j * C], acc);
    c[(size_t)b * C + k] = acc;
  }
}

__global__ void readout_tanh_kernel(const float* __restrict__ ty,
                                    float* __restrict__ t, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) t[i] = tanhf(ty[i] + t[i]);
}

}  // namespace

// Pointers are device pointers to contiguous fp32 tensors:
//   ty (Tt, B, R) with b folded in, xg1 (Tt, B, 3H), ctx (B, T, C),
//   ctxp (B, T, A) with ba folded in, mask (B, T),
//   uh1 (H, 3H), bh1 (3H,), ua (H, A), va (A,), wi2 (C, 3H), bi2 (3H,),
//   uh2 (H, 3H), bh2 (3H,), ws (H, R), wc (C, R);
//   s (Tt + 1, B, H) with s[0] = s0 on entry, s[t + 1] the state after
//   step t on exit; residual outputs st (Tt, B, H) = s~, c (Tt, B, C),
//   w (Tt, B, T), q (Tt, B, A), hg1, xg2, hg2 (Tt, B, 3H); t (Tt, B, R).
// work / counters: the GEMMs' split-K scratch (vag::Workspace). Returns 0
// or the first CUDA error code.
extern "C" int dec_scan_fwd_launch(
    const void* ty, const void* xg1, const void* ctx, const void* ctxp,
    const void* mask, const void* uh1, const void* bh1, const void* ua,
    const void* va, const void* wi2, const void* bi2, const void* uh2,
    const void* bh2, const void* ws, const void* wc, void* s, void* st,
    void* c, void* w, void* q, void* hg1, void* xg2, void* hg2, void* t_out,
    int Tt, int B, int T, int H, int A, int C, int R, void* work,
    long long work_floats, void* counters, int n_counters, void* stream) {
  using namespace vag;
  const Workspace wk{static_cast<float*>(work), work_floats,
                     static_cast<unsigned int*>(counters), n_counters};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int H3 = 3 * H;
  const float* xg1_f = static_cast<const float*>(xg1);
  float* s_f = static_cast<float*>(s);
  float* st_f = static_cast<float*>(st);
  float* c_f = static_cast<float*>(c);
  float* w_f = static_cast<float*>(w);
  float* q_f = static_cast<float*>(q);
  float* hg1_f = static_cast<float*>(hg1);
  float* xg2_f = static_cast<float*>(xg2);
  float* hg2_f = static_cast<float*>(hg2);
  const size_t att_smem = sizeof(float) * (2 * A + T);
  if (att_smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  for (int t = 0; t < Tt; ++t) {
    const size_t oB = (size_t)t * B;
    const float* s_prev = s_f + oB * H;
    float* s_new = s_f + (oB + B) * H;
    float* st_t = st_f + oB * H;
    float* hg1_t = hg1_f + oB * H3;
    float* hg2_t = hg2_f + oB * H3;
    float* xg2_t = xg2_f + oB * H3;
    float* q_t = q_f + oB * A;
    float* c_t = c_f + oB * C;
    VAG_CHECK((gemm<false, false>(cs, wk, B, H3, H, s_prev, H,
                                  static_cast<const float*>(uh1), H3, hg1_t,
                                  H3, static_cast<const float*>(bh1), false)));
    VAG_CHECK(gru_cell(cs, xg1_f + oB * H3, hg1_t, s_prev, st_t, B, H));
    VAG_CHECK((gemm<false, false>(cs, wk, B, A, H, st_t, H,
                                  static_cast<const float*>(ua), A, q_t, A,
                                  nullptr, false)));
    VAG_CHECK((gemm<false, false>(cs, wk, B, H3, H, st_t, H,
                                  static_cast<const float*>(uh2), H3, hg2_t,
                                  H3, static_cast<const float*>(bh2), false)));
    attn_fwd_kernel<<<B, ATT_THREADS, att_smem, cs>>>(
        q_t, static_cast<const float*>(ctxp), static_cast<const float*>(ctx),
        static_cast<const float*>(mask), static_cast<const float*>(va),
        w_f + oB * T, c_t, T, A, C);
    VAG_CHECK(cudaGetLastError());
    VAG_CHECK((gemm<false, false>(cs, wk, B, H3, C, c_t, C,
                                  static_cast<const float*>(wi2), H3, xg2_t,
                                  H3, static_cast<const float*>(bi2), false)));
    VAG_CHECK(gru_cell(cs, xg2_t, hg2_t, st_t, s_new, B, H));
  }
  // Readout, time-parallel: t = tanh(ty + (c @ wc + s' @ ws)).
  float* t_f = static_cast<float*>(t_out);
  const int rows = Tt * B;
  VAG_CHECK((gemm<false, false>(cs, wk, rows, R, C, c_f, C,
                                static_cast<const float*>(wc), R, t_f, R,
                                nullptr, false)));
  VAG_CHECK((gemm<false, false>(cs, wk, rows, R, H, s_f + (size_t)B * H, H,
                                static_cast<const float*>(ws), R, t_f, R,
                                nullptr, true)));
  const int n = rows * R;
  readout_tanh_kernel<<<(n + EW_THREADS - 1) / EW_THREADS, EW_THREADS, 0, cs>>>(
      static_cast<const float*>(ty), t_f, n);
  VAG_CHECK(cudaGetLastError());
  return 0;
}
