// Device code shared by the kernels: the sigmoid, a GRU cell unit, its
// backward's coefficients and the fast tanh (dec_step.cu, the dec_scan
// kernels, gru_bwd.cu); warp
// reductions (the attention grids); the branch-free running top-K
// insertion ordered by (value descending, index ascending)
// (readout_topk.cu, topk_split.cuh); and the launchers' error check.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace vag {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// tanh on the fast exponential (ex2.approx) and division, where tanhf's
// accurate branches cost several times the instructions; the attention's
// energies take T * K * A of them a sentence (dec_step.cu; dec_scan.cuh's
// attention phases). Error: __expf is within
// 2 + 1.2 |2x| ulp (the CUDA guide's bound), which moves tanh by that
// relative error times (1 - tanh^2) / 2, at most 1.6e-7; __fdividef is
// within 2 ulp of 2 / (1 + e^2x) (at most 4.8e-7 near 2), and 1 - q is
// exact there: at most 4.8e-7 in all (tests/test_torch_dec_step_plan.py
// models these bounds; chip_smoke.py's phase 7 measures it against tanhf).
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

// GRU cell of one unit from its gate pre-activations (biases added), reset
// gate after the hidden product: ops/gru_kernel.gru_gate_algebra's order.
__device__ __forceinline__ float gru_unit(float xr, float xz, float xn,
                                          float hr, float hz, float hn,
                                          float h) {
  const float r = sigmoidf_(xr + hr);
  const float z = sigmoidf_(xz + hz);
  const float n = tanhf(xn + r * hn);
  return (1.f - z) * n + z * h;
}

// The masked GRU cell backward's coefficients of one unit that do not
// depend on the gradient dh of the new state (gru_bwd.cu's bf16 instance:
// its recompute writes them, its carry reads them): with r, z, n the gates
// and hn the hidden side's n pre-activation (bias added), c_n = (1 - z)
// (1 - n^2), and for the mask m (0 or 1) c = {m c_n hn r (1 - r), m (h -
// n) z (1 - z), m c_n, m c_n r, m > 0 ? z : 1}, so that the cell backward
// of dh is dxg = dh {c0, c1, c2}, dhg = dh {c0, c1, c3} and the carry's
// share dh c4 (ops/gru_kernel.py's gru_cell_coef, its torch model).
__device__ __forceinline__ void gru_unit_coef(float xr, float xz, float xn,
                                              float hr, float hz, float hn,
                                              float h, float m, float (&c)[5]) {
  const float r = sigmoidf_(xr + hr);
  const float z = sigmoidf_(xz + hz);
  const float n = tanhf(xn + r * hn);
  const float cn = (1.f - z) * (1.f - n * n);
  c[0] = m * (cn * hn * (r * (1.f - r)));
  c[1] = m * ((h - n) * (z * (1.f - z)));
  c[2] = m * cn;
  c[3] = m * (cn * r);
  c[4] = m > 0.f ? z : 1.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The running top-K order: value descending, then index ascending (the
// order of lax.top_k and of a stable descending sort).
__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Sinks (x, xi) through the K slots kept sorted by `better`; branch-free.
// Returns the value that leaves the last slot (x itself when it ranks last).
template <int K>
__device__ __forceinline__ float insert(float (&sv)[K], int (&si)[K], float x,
                                        int xi) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool gt = better(x, xi, sv[s], si[s]);
    const float tv = gt ? sv[s] : x;
    const int ti = gt ? si[s] : xi;
    sv[s] = gt ? x : sv[s];
    si[s] = gt ? xi : si[s];
    x = tv;
    xi = ti;
  }
  return x;
}

#define VAG_CHECK(expr)                              \
  do {                                               \
    const cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

}  // namespace vag
