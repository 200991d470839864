// Fused beam decode step, GRU1 -> attention -> GRU2 -> readout activations,
// for Hopper (sm_90a), plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_dec_step.py, _kernel (entry
// pallas_decode_step), the mid-section of the tabled beam step with
// VAG_DEC_STEP=on. For N = B*K beam rows (K beams per sentence, row
// n = b*K + k), from the gathered table rows gy = [xg1 | ty] and the state s:
//   s~  = GRU1(xg1, hg1 = s @ uh1 + bh1, s)
//   qh  = s~ @ w_s                      (w_s = [ua | uh2]: q | GRU2 h-gates)
//   e   = tanh(ctxpb[b] + q)            (ctxpb = ctx_proj + ba, folded outside)
//   w   = softmax over source positions of (e . va), masked to -1e9
//   c   = sum_j w[j] ctx[b, j]
//   xc  = c @ w_c                       (w_c = [wi2 | wc]: GRU2 x-gates | tc)
//   s'  = GRU2(xc[:3H] + bi2, qh[A:] + bh2, s~)
//   t   = tanh(ty + s' @ ws + xc[3H:] + b)
//
// Design. The TPU kernel holds every weight in VMEM for a sentence tile
// (15.2 MB fp32 at m30k's widths: uh1, w_s, w_c, ws); one SM holds 227 KB,
// and q, GRU2 and the readout each need whole rows of the previous stage.
// So, as dec_scan_fwd.cu does for one training step, the step is one C
// entry that enqueues a chain of grids on the caller's stream, the order of
// the stream being the barrier: GEMM hg1, GRU1 cell, GEMM qh, attention,
// GEMM xc, GRU2 cell, GEMM s' @ ws, readout tanh: 8 grids for one host
// call, where the PyTorch step makes dozens. The weights (15.2 MB) and the
// chunk's ctx / ctx_proj (25 MB at B=128, T=32) stay in the 50 MB L2 from
// one beam step to the next. The attention grid takes one sentence per
// block with its K beams inside it: ctx and ctx_proj are read once per
// sentence, never tiled across beams (the K-fold traffic the TPU design
// avoids), and each thread sums one ctx column for all K beams at once. The
// GEMMs are common.cuh's fp32 FMA tiles, split-K where the output has too
// few tiles. Ragged widths and batch are masked at any size: the TPU's
// shape envelope and its batch padding to a multiple of 8 (Mosaic rules)
// are not carried over.
//
// Bound on this card at B=128, K=5, T=32, full width (H=A=512, C=1024,
// R=256): the GEMMs are 2*640*(512*1536 + 512*2048 + 1024*1792 + 512*256)
// = 4.87 GFLOP and the attention 2*640*32*(512 + 1024) = 0.06 GFLOP, ~74 us
// at 67 TFLOP/s fp32; ~45 MB of inputs, ~13 us at 3.35 TB/s: bound by
// operations.

#include "common.cuh"

namespace {

#if !defined(VAG_MAX_K)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_MAX_K)"
#endif

constexpr int MAX_K = VAG_MAX_K;
constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr float NEG_INF = -1e9f;   // as ops/attention.masked_softmax
static_assert(MAX_K <= ATT_WARPS, "one softmax warp per beam");

using vag::warp_max;
using vag::warp_sum;

// One block per sentence b, its K beams inside. Shared: q (K, A), va (A),
// scores / weights (K, T).
__global__ void __launch_bounds__(ATT_THREADS)
attn_beams_kernel(const float* __restrict__ qh, int ldq,
                  const float* __restrict__ ctxp,
                  const float* __restrict__ ctx,
                  const float* __restrict__ mask,
                  const float* __restrict__ va, float* __restrict__ c, int K,
                  int T, int A, int C) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* vs = qs + K * A;
  float* sc = vs + A;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < K * A; i += ATT_THREADS) {
    const int k = i / A, a = i % A;
    qs[i] = qh[((size_t)b * K + k) * ldq + a];
  }
  for (int i = tid; i < A; i += ATT_THREADS) vs[i] = va[i];
  __syncthreads();
  // energies: one warp per (position, beam) pair; the K beams of a position
  // read the same ctx_proj row back to back
  for (int p = warp; p < T * K; p += ATT_WARPS) {
    const int j = p / K, k = p % K;
    const float* cp = ctxp + ((size_t)b * T + j) * A;
    const float* q = qs + k * A;
    float acc = 0.f;
    for (int a = lane; a < A; a += 32) acc += tanhf(cp[a] + q[a]) * vs[a];
    acc = warp_sum(acc);
    if (lane == 0) sc[k * T + j] = mask[(size_t)b * T + j] > 0.f ? acc : NEG_INF;
  }
  __syncthreads();
  if (warp < K) {
    float* s = sc + warp * T;
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(s[j] - mx);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) s[j] = s[j] / sum;
  }
  __syncthreads();
  for (int col = tid; col < C; col += ATT_THREADS) {
    const float* cx = ctx + (size_t)b * T * C + col;
    float acc[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) acc[k] = 0.f;
    for (int j = 0; j < T; ++j) {
      const float x = cx[(size_t)j * C];
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < K) acc[k] = fmaf(sc[k * T + j], x, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < K) c[((size_t)b * K + k) * C + col] = acc[k];
  }
}

// t = tanh(ty + sw + tc + b) in that order; sw (N, R) = s' @ ws holds t on
// entry, ty and tc are the R-wide tails of rows of gy and xc.
__global__ void readout_kernel(const float* __restrict__ gy, int ldg,
                               const float* __restrict__ xc, int ldx, int off,
                               const float* __restrict__ bias,
                               float* __restrict__ t, int N, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * R) return;
  const int n = i / R, r = i % R;
  const float ty = gy[(size_t)n * ldg + off + r];
  const float tc = xc[(size_t)n * ldx + off + r];
  t[i] = tanhf(((ty + t[i]) + tc) + bias[r]);
}

}  // namespace

// Device pointers to contiguous fp32 tensors (N = B * K rows, G = 3H + R):
//   gy (N, G) the gathered table rows, s (N, H), ctx (B, T, C),
//   ctxp (B, T, A) with ba folded in, mask (B, T),
//   uh1 (H, 3H), bh1 (3H,), w_s (H, A + 3H), bh2 (3H,), va (A,),
//   w_c (C, 3H + R), bi2 (3H,), ws (H, R), b (R,);
//   outputs s_new (N, H), t (N, R); scratch hg1 (N, 3H), st (N, H),
//   qh (N, A + 3H), c (N, C), xc (N, 3H + R).
// work / counters: the GEMMs' split-K scratch (vag::Workspace). 1 <= K <=
// VAG_MAX_K. Returns 0 or the first CUDA error code.
extern "C" int dec_step_launch(
    const void* gy, const void* s, const void* ctx, const void* ctxp,
    const void* mask, const void* uh1, const void* bh1, const void* w_s,
    const void* bh2, const void* va, const void* w_c, const void* bi2,
    const void* ws, const void* b, void* s_new, void* t, void* hg1, void* st,
    void* qh, void* c, void* xc, int B, int K, int T, int H, int A, int C,
    int R, void* work, long long work_floats, void* counters, int n_counters,
    void* stream) {
  using namespace vag;
  if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const Workspace wk{static_cast<float*>(work), work_floats,
                     static_cast<unsigned int*>(counters), n_counters};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int N = B * K, H3 = 3 * H, G = H3 + R, Q = A + H3, X = H3 + R;
  const float* gy_f = static_cast<const float*>(gy);
  const float* s_f = static_cast<const float*>(s);
  float* s_new_f = static_cast<float*>(s_new);
  float* t_f = static_cast<float*>(t);
  float* hg1_f = static_cast<float*>(hg1);
  float* st_f = static_cast<float*>(st);
  float* qh_f = static_cast<float*>(qh);
  float* c_f = static_cast<float*>(c);
  float* xc_f = static_cast<float*>(xc);
  const size_t att_smem = sizeof(float) * ((size_t)K * A + A + (size_t)K * T);
  if (att_smem > 48 * 1024) {
    VAG_CHECK(cudaFuncSetAttribute(attn_beams_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)att_smem));
  }

  VAG_CHECK((gemm<false, false>(cs, wk, N, H3, H, s_f, H,
                                static_cast<const float*>(uh1), H3, hg1_f, H3,
                                static_cast<const float*>(bh1), false)));
  VAG_CHECK(gru_cell(cs, gy_f, G, nullptr, hg1_f, H3, nullptr, s_f, st_f, N,
                     H));
  VAG_CHECK((gemm<false, false>(cs, wk, N, Q, H, st_f, H,
                                static_cast<const float*>(w_s), Q, qh_f, Q,
                                nullptr, false)));
  attn_beams_kernel<<<B, ATT_THREADS, att_smem, cs>>>(
      qh_f, Q, static_cast<const float*>(ctxp), static_cast<const float*>(ctx),
      static_cast<const float*>(mask), static_cast<const float*>(va), c_f, K,
      T, A, C);
  VAG_CHECK(cudaGetLastError());
  VAG_CHECK((gemm<false, false>(cs, wk, N, X, C, c_f, C,
                                static_cast<const float*>(w_c), X, xc_f, X,
                                nullptr, false)));
  VAG_CHECK(gru_cell(cs, xc_f, X, static_cast<const float*>(bi2), qh_f + A, Q,
                     static_cast<const float*>(bh2), st_f, s_new_f, N, H));
  VAG_CHECK((gemm<false, false>(cs, wk, N, R, H, s_new_f, H,
                                static_cast<const float*>(ws), R, t_f, R,
                                nullptr, false)));
  const int n = N * R;
  readout_kernel<<<(n + EW_THREADS - 1) / EW_THREADS, EW_THREADS, 0, cs>>>(
      gy_f, G, xc_f, X, H3, static_cast<const float*>(b), t_f, N, R);
  VAG_CHECK(cudaGetLastError());
  return 0;
}
