// Masked GRU backward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_gru.py, _bwd_kernel (called from
// _bwd_call, the custom VJP of pallas_gru_scan): the encoder bi-GRU's
// gradient in training.
//
// Given the forward's inputs, its saved states and the cotangent g of the
// states, walks time against the scan order:
//   hg   = h_prev @ Uh + bh;  r, z, n from xg[t] and hg
//   dh  += g[t];  dh_cell = dh * m[t]   (a masked step sends all grad to
//                                        the carry, and dxg[t] = 0 there)
//   dxg[t] = [da_r, da_z, da_n];  dhg = [da_r, da_z, da_n * r]
//   dh   = dh_cell * z + dh * (1 - m) + dhg @ Uh^T
// and returns dxg, dh0 = the final dh, dUh = sum_t h_prev^T dhg and
// dbh = sum_t,b dhg.
//
// Design. The TPU kernel recomputes hg step by step inside its reverse
// loop. Here the saved states make every h_prev known before the loop, so
// the recompute is one time-parallel GEMM over all T*B rows (HG, kept as
// scratch). What stays sequential is, per step, one elementwise grid (the
// gate algebra's backward, writing dxg[t], dhg[t] and the carry's direct
// part) and one GEMM grid (the carry's dhg @ Uh^T part, which needs the
// whole dhg row of every unit): two grids per step, enqueued back to back on
// the caller's stream, whose order is the step barrier (as gru_fwd.cu). The
// weight gradients are then one reduction GEMM h_prev^T @ dHG over the saved
// (T*B, H) and (T*B, 3H) streams and one column sum: deterministic, no
// atomics. All fp32 FMA (common.cuh).
//
// Bound on this card at B=64, T=24, H=512: the three products (recompute,
// dhg @ Uh^T, h_prev^T dhg) are 3 * 2 * T*B*H*3H = 7.2 GFLOP, ~0.11 ms at
// the H100 SXM's 67 TFLOP/s fp32 (non-tensor-core); its streams (xg, hs, g
// in, dxg out, ~21 MB) need ~6 us of HBM. Bound by operations. Per step the
// GEMM is only 64 x 512 outputs (8 tiles of 64 x 64), so it splits its
// depth of 3H over ~12 blocks a tile (split-K, common.cuh) to fill the
// card. A persistent kernel, or tensor-core (3xTF32) products, are later
// work.

#include "common.cuh"

// Pointers are device pointers to contiguous fp32 tensors:
//   xg (T, B, 3H), mask (T, B), uh (H, 3H), bh (3H,),
//   hprev (T, B, H): the state each step started from in the forward
//     (h0 at the scan's first step), g (T, B, H): cotangent of the states;
//   scratch hg, dhg (T, B, 3H);
//   outputs dxg (T, B, 3H), dh (B, H) = dh0, duh (H, 3H), dbh (3H,);
//   work / counters: the GEMMs' split-K scratch (vag::Workspace).
// Returns 0 or the first CUDA error code.
extern "C" int gru_bwd_launch(const void* xg, const void* mask, const void* uh,
                              const void* bh, const void* hprev, const void* g,
                              void* hg, void* dhg, void* dxg, void* dh,
                              void* duh, void* dbh, int T, int B, int H,
                              int reverse, void* work,
                              long long work_floats, void* counters,
                              int n_counters, void* stream) {
  using namespace vag;
  const Workspace wk{static_cast<float*>(work), work_floats,
                     static_cast<unsigned int*>(counters), n_counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xg_f = static_cast<const float*>(xg);
  const float* mask_f = static_cast<const float*>(mask);
  const float* uh_f = static_cast<const float*>(uh);
  const float* hp_f = static_cast<const float*>(hprev);
  const float* g_f = static_cast<const float*>(g);
  float* hg_f = static_cast<float*>(hg);
  float* dhg_f = static_cast<float*>(dhg);
  float* dxg_f = static_cast<float*>(dxg);
  float* dh_f = static_cast<float*>(dh);
  const int H3 = 3 * H;

  // HG = hprev @ Uh + bh for every step at once.
  VAG_CHECK((gemm<false, false>(s, wk, T * B, H3, H, hp_f, H, uh_f, H3, hg_f,
                                H3, static_cast<const float*>(bh), false)));
  VAG_CHECK(cudaMemsetAsync(dh_f, 0, sizeof(float) * B * H, s));
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? step : T - 1 - step;
    const size_t o3 = (size_t)t * B * H3, o1 = (size_t)t * B * H;
    VAG_CHECK(gru_cell_bwd(s, xg_f + o3, hg_f + o3, hp_f + o1,
                           mask_f + (size_t)t * B, dh_f, g_f + o1, dxg_f + o3,
                           dhg_f + o3, dh_f, B, H));
    // dh += dhg[t] @ Uh^T
    VAG_CHECK((gemm<false, true>(s, wk, B, H, H3, dhg_f + o3, H3, uh_f, H3,
                                 dh_f, H, nullptr, true)));
  }
  // dUh = hprev^T @ dHG over all T*B rows; dbh = column sums of dHG.
  VAG_CHECK((gemm<true, false>(s, wk, H, H3, T * B, hp_f, H, dhg_f, H3,
                               static_cast<float*>(duh), H3, nullptr, false)));
  VAG_CHECK(colsum(s, dhg_f, T * B, H3, static_cast<float*>(dbh)));
  return 0;
}
