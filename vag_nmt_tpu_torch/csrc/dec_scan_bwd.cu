// Teacher-forced decoder scan, backward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_dec_scan.py, _bwd_kernel (the custom VJP
// of pallas_decoder_scan). Given the cotangent g of the readout t, walks
// the target steps in reverse with the phases of the TPU kernel:
//   readout:   dpre = g (1 - t^2);  ds' += dpre @ ws^T;  dc = dpre @ wc^T
//   GRU2:      dxg2, dhg2 from ds';  dc += dxg2 @ wi2^T;
//              ds~ = ds' z2 + dhg2 @ uh2^T
//   attention: dw_j = dc . ctx_j;  dctx_j += w_j dc;
//              dscore_j = w_j (dw_j - sum_i w_i dw_i) (0 at masked j);
//              da_j = dscore_j va (1 - e_j^2);  dctxp_j += da_j;
//              dq = sum_j da_j;  dva += sum_j e_j dscore_j;  ds~ += dq @ ua^T
//   GRU1:      dxg1, dhg1 from ds~;  ds = ds~ z1 + dhg1 @ uh1^T
// and emits dty (= dpre), dxg1, ds0, dctx, dctx_proj and the grads of uh1,
// bh1, ua, va, wi2, bi2, uh2, bh2, ws and wc.
//
// Design. The forward (dec_scan_fwd.cu) saved s~, c, w, q, hg1, xg2 and
// hg2 for every step, so no forward GEMM is recomputed; only the attention
// energies e = tanh(ctxp + q) are, inside the attention kernel. The readout
// terms do not depend on the carry, so dpre, dpre @ ws^T and dpre @ wc^T
// are time-parallel and run before the loop. Per step, 7 grids on the
// caller's stream: GRU2 cell backward, GEMM dc += dxg2 @ wi2^T, GEMM
// ds~ += dhg2 @ uh2^T, attention backward (one block per batch row, which
// owns that row's dctx and dctxp and accumulates them over steps in order),
// GEMM ds~ += dq @ ua^T, GRU1 cell backward, GEMM ds += dhg1 @ uh1^T (the
// GEMMs split their depth over several blocks a tile, common.cuh). The
// per-step dxg2, dhg2, dq, dhg1 and the per-row dva terms go to (Tt, B, .)
// buffers, and after the loop the ten weight grads are reduction GEMMs and
// column sums over the Tt*B rows: deterministic, no atomics (the TPU kernel
// keeps dva per row too and sums outside).
//
// Bound on this card at B=64, T=Tt=24, full width: the same products as
// the forward's, each once as a transposed product for the input grads and
// once as a reduction for the weight grads, ~2x the forward's 11.8 GFLOP
// plus the attention's ~3x, ~24 GFLOP, ~0.36 ms at 67 TFLOP/s fp32; bound
// by operations.

#include "common.cuh"

namespace {

constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;

using vag::warp_sum;

__global__ void dpre_kernel(const float* __restrict__ g,
                            const float* __restrict__ t,
                            float* __restrict__ dpre, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dpre[i] = g[i] * (1.f - t[i] * t[i]);
}

// One block per batch row b, one target step. Shared: dc (C), w (T),
// dw/dscore (T), q (A), va (A).
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_kernel(const float* __restrict__ dc, const float* __restrict__ w,
                const float* __restrict__ q, const float* __restrict__ ctx,
                const float* __restrict__ ctxp, const float* __restrict__ mask,
                const float* __restrict__ va, float* __restrict__ dctx,
                float* __restrict__ dctxp, float* __restrict__ dq,
                float* __restrict__ dva_rows, int T, int A, int C) {
  extern __shared__ float sm[];
  float* dcs = sm;
  float* ws = dcs + C;
  float* dws = ws + T;
  float* qs = dws + T;
  float* vs = qs + A;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < C; i += ATT_THREADS) dcs[i] = dc[(size_t)b * C + i];
  for (int i = tid; i < T; i += ATT_THREADS) ws[i] = w[(size_t)b * T + i];
  for (int i = tid; i < A; i += ATT_THREADS) {
    qs[i] = q[(size_t)b * A + i];
    vs[i] = va[i];
  }
  __syncthreads();
  // dw_j = dc . ctx_j
  for (int j = warp; j < T; j += ATT_WARPS) {
    const float* cx = ctx + ((size_t)b * T + j) * C;
    float acc = 0.f;
    for (int k = lane; k < C; k += 32) acc += dcs[k] * cx[k];
    acc = warp_sum(acc);
    if (lane == 0) dws[j] = acc;
  }
  __syncthreads();
  // dctx_j += w_j dc (this block owns row b of dctx)
  float* dcx = dctx + (size_t)b * T * C;
  for (int i = tid; i < T * C; i += ATT_THREADS)
    dcx[i] += ws[i / C] * dcs[i % C];
  if (warp == 0) {
    float swdw = 0.f;
    for (int j = lane; j < T; j += 32) swdw += ws[j] * dws[j];
    swdw = warp_sum(swdw);
    for (int j = lane; j < T; j += 32)
      dws[j] = mask[(size_t)b * T + j] > 0.f ? ws[j] * (dws[j] - swdw) : 0.f;
  }
  __syncthreads();
  // energies recomputed; da, dctxp, dq and the row's dva term
  for (int a = tid; a < A; a += ATT_THREADS) {
    const float qa = qs[a], vaa = vs[a];
    float dqa = 0.f, dvaa = 0.f;
    for (int j = 0; j < T; ++j) {
      const size_t o = ((size_t)b * T + j) * A + a;
      const float e = tanhf(ctxp[o] + qa);
      const float da = dws[j] * vaa * (1.f - e * e);
      dctxp[o] += da;
      dqa += da;
      dvaa += e * dws[j];
    }
    dq[(size_t)b * A + a] = dqa;
    dva_rows[(size_t)b * A + a] = dvaa;
  }
}

}  // namespace

// Pointers are device pointers to contiguous fp32 tensors. Inputs: g, t
// (Tt, B, R); the forward's residuals s (Tt + 1, B, H), st (Tt, B, H),
// c (Tt, B, C), w (Tt, B, T), q (Tt, B, A), hg1, xg2, hg2 (Tt, B, 3H); xg1
// (Tt, B, 3H), ctx (B, T, C), ctxp (B, T, A), mask (B, T); weights uh1,
// ua, va, wi2, uh2, ws, wc as in dec_scan_fwd_launch. Outputs: dty
// (Tt, B, R), dxg1 (Tt, B, 3H), ds (B, H) = ds0, dctx (B, T, C) and dctxp
// (B, T, A), both zero on entry, and the weight grads duh1, dbh1, dua, dva,
// dwi2, dbi2, duh2, dbh2, dws, dwc in the weights' shapes. Scratch:
// ds_ro (Tt, B, H), dc (Tt, B, C), dxg2, dhg2, dhg1 (Tt, B, 3H), dq and
// dva_rows (Tt, B, A), dst (B, H); work / counters: the GEMMs' split-K
// scratch (vag::Workspace). Returns 0 or the first CUDA error code.
extern "C" int dec_scan_bwd_launch(
    const void* g, const void* t_out, const void* s, const void* st,
    const void* c, const void* w, const void* q, const void* hg1,
    const void* xg2, const void* hg2, const void* xg1, const void* ctx,
    const void* ctxp, const void* mask, const void* uh1, const void* ua,
    const void* va, const void* wi2, const void* uh2, const void* ws,
    const void* wc, void* dty, void* dxg1, void* ds, void* dctx, void* dctxp,
    void* duh1, void* dbh1, void* dua, void* dva, void* dwi2, void* dbi2,
    void* duh2, void* dbh2, void* dws, void* dwc, void* ds_ro, void* dc,
    void* dxg2, void* dhg2, void* dhg1, void* dq, void* dva_rows, void* dst,
    int Tt, int B, int T, int H, int A, int C, int R, void* work,
    long long work_floats, void* counters, int n_counters, void* stream) {
  using namespace vag;
  const Workspace wk{static_cast<float*>(work), work_floats,
                     static_cast<unsigned int*>(counters), n_counters};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int H3 = 3 * H, rows = Tt * B;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto M = [](void* p) { return static_cast<float*>(p); };
  const size_t att_smem = sizeof(float) * (C + 2 * T + 2 * A);
  if (att_smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  // Readout, time-parallel.
  const int n = rows * R;
  dpre_kernel<<<(n + EW_THREADS - 1) / EW_THREADS, EW_THREADS, 0, cs>>>(
      F(g), F(t_out), M(dty), n);
  VAG_CHECK(cudaGetLastError());
  VAG_CHECK((gemm<false, true>(cs, wk, rows, H, R, F(dty), R, F(ws), R,
                               M(ds_ro), H, nullptr, false)));
  VAG_CHECK((gemm<false, true>(cs, wk, rows, C, R, F(dty), R, F(wc), R,
                               M(dc), C, nullptr, false)));
  VAG_CHECK(cudaMemsetAsync(ds, 0, sizeof(float) * B * H, cs));

  for (int t = Tt - 1; t >= 0; --t) {
    const size_t oB = (size_t)t * B;
    const size_t o3 = oB * H3, o1 = oB * H;
    float* dc_t = M(dc) + oB * C;
    float* dq_t = M(dq) + oB * A;
    // GRU2 (state s~ -> s'): ds' = ds + dpre @ ws^T
    VAG_CHECK(gru_cell_bwd(cs, F(xg2) + o3, F(hg2) + o3, F(st) + o1, nullptr,
                           M(ds), F(ds_ro) + o1, M(dxg2) + o3, M(dhg2) + o3,
                           M(dst), B, H));
    VAG_CHECK((gemm<false, true>(cs, wk, B, C, H3, M(dxg2) + o3, H3, F(wi2), H3,
                                 dc_t, C, nullptr, true)));
    VAG_CHECK((gemm<false, true>(cs, wk, B, H, H3, M(dhg2) + o3, H3, F(uh2), H3,
                                 M(dst), H, nullptr, true)));
    // attention
    attn_bwd_kernel<<<B, ATT_THREADS, att_smem, cs>>>(
        dc_t, F(w) + oB * T, F(q) + oB * A, F(ctx), F(ctxp), F(mask), F(va),
        M(dctx), M(dctxp), dq_t, M(dva_rows) + oB * A, T, A, C);
    VAG_CHECK(cudaGetLastError());
    VAG_CHECK((gemm<false, true>(cs, wk, B, H, A, dq_t, A, F(ua), A, M(dst), H,
                                 nullptr, true)));
    // GRU1 (state s -> s~)
    VAG_CHECK(gru_cell_bwd(cs, F(xg1) + o3, F(hg1) + o3, F(s) + o1, nullptr,
                           M(dst), nullptr, M(dxg1) + o3, M(dhg1) + o3, M(ds),
                           B, H));
    VAG_CHECK((gemm<false, true>(cs, wk, B, H, H3, M(dhg1) + o3, H3, F(uh1), H3,
                                 M(ds), H, nullptr, true)));
  }

  // Weight grads: reduction GEMMs over the Tt*B rows, and column sums.
  const float* s_new = F(s) + (size_t)B * H;   // s' of every step
  VAG_CHECK((gemm<true, false>(cs, wk, H, R, rows, s_new, H, F(dty), R,
                               M(dws), R, nullptr, false)));
  VAG_CHECK((gemm<true, false>(cs, wk, C, R, rows, F(c), C, F(dty), R,
                               M(dwc), R, nullptr, false)));
  VAG_CHECK((gemm<true, false>(cs, wk, C, H3, rows, F(c), C, M(dxg2), H3,
                               M(dwi2), H3, nullptr, false)));
  VAG_CHECK(colsum(cs, M(dxg2), rows, H3, M(dbi2)));
  VAG_CHECK((gemm<true, false>(cs, wk, H, H3, rows, F(st), H, M(dhg2), H3,
                               M(duh2), H3, nullptr, false)));
  VAG_CHECK(colsum(cs, M(dhg2), rows, H3, M(dbh2)));
  VAG_CHECK((gemm<true, false>(cs, wk, H, A, rows, F(st), H, M(dq), A,
                               M(dua), A, nullptr, false)));
  VAG_CHECK(colsum(cs, M(dva_rows), rows, A, M(dva)));
  VAG_CHECK((gemm<true, false>(cs, wk, H, H3, rows, F(s), H, M(dhg1), H3,
                               M(duh1), H3, nullptr, false)));
  VAG_CHECK(colsum(cs, M(dhg1), rows, H3, M(dbh1)));
  return 0;
}
