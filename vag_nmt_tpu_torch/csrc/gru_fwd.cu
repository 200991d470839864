// Masked GRU forward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_gru.py, _fwd_kernel (entry
// pallas_gru_scan), the encoder's bi-GRU recurrence.
//
// Computes, for t over T steps (descending when reverse):
//   hg  = h @ Uh + bh                      (B, 3H), fp32 FMA, no TF32
//   r   = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//   h'  = (1 - z) * n + z * h;  h = mask[t] > 0 ? h' : h;  out[t] = h
// with xg = x @ Wi + bi computed outside (one large matmul).
//
// Bound on this card: at B=1024, T=32, H=512 one direction is 51.5 GFLOP of
// fp32 against ~0.27 GB of streams (xg in, hs out), so it is bound by
// operations: ~0.77 ms at the H100 SXM's 67 TFLOP/s fp32 (non-tensor-core).
//
// Design: the TPU kernel keeps all of Uh (3 MB at H=512 fp32) resident in
// VMEM; one SM cannot. So the columns of h @ Uh are split by hidden unit:
// a block owns UNITS hidden units and all three of their gate columns
// (r, z, n), so the gate algebra needs nothing from other blocks. Every
// unit slice needs the whole previous h, which makes time a dependency
// across blocks; the simplest correct design is chosen here: one grid per
// time step, enqueued back to back on the caller's stream (stream order is
// the step barrier). A persistent cooperative kernel with a grid sync per
// step, and tensor-core (3xTF32) products, are later work. Inside a block
// the (ROWS x H) slice of h and the (H x 3*UNITS) slice of Uh stream through
// shared memory in KC-deep chunks; each thread keeps RPT rows x 3 gates of
// its unit in registers, so the epilogue applies the gates in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int UNITS = 8;     // hidden units per block (3 gate columns each)
constexpr int RPT = 4;       // batch rows per thread
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / UNITS;  // 32
constexpr int ROWS = ROW_GROUPS * RPT;       // 128 batch rows per block
constexpr int KC = 32;       // depth chunk staged in shared memory

__global__ void __launch_bounds__(THREADS)
gru_step_kernel(const float* __restrict__ xg,      // (B, 3H) at step t
                const float* __restrict__ mask,    // (B,) at step t
                const float* __restrict__ uh,      // (H, 3H)
                const float* __restrict__ bh,      // (3H,)
                const float* __restrict__ h_prev,  // (B, H)
                float* __restrict__ h_out,         // (B, H)
                int B, int H) {
  __shared__ float hs[ROWS][KC + 1];        // +1: rows on distinct banks
  __shared__ float us[KC][3 * UNITS];
  const int tid = threadIdx.x;
  const int u = tid % UNITS;
  const int rg = tid / UNITS;
  const int unit0 = blockIdx.x * UNITS;
  const int row0 = blockIdx.y * ROWS;
  const int H3 = 3 * H;

  float acc[RPT][3];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;

  for (int k0 = 0; k0 < H; k0 += KC) {
    for (int i = tid; i < ROWS * KC; i += THREADS) {
      const int r = i / KC, c = i % KC;
      const int row = row0 + r, k = k0 + c;
      hs[r][c] = (row < B && k < H) ? h_prev[(size_t)row * H + k] : 0.f;
    }
    for (int i = tid; i < KC * 3 * UNITS; i += THREADS) {
      const int kk = i / (3 * UNITS), j = i % (3 * UNITS);
      const int k = k0 + kk;
      us[kk][j] = k < H
          ? uh[(size_t)k * H3 + (j / UNITS) * H + unit0 + j % UNITS] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float wr = us[kk][u];
      const float wz = us[kk][UNITS + u];
      const float wn = us[kk][2 * UNITS + u];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = hs[rg + ROW_GROUPS * i][kk];
        acc[i][0] = fmaf(a, wr, acc[i][0]);
        acc[i][1] = fmaf(a, wz, acc[i][1]);
        acc[i][2] = fmaf(a, wn, acc[i][2]);
      }
    }
    __syncthreads();
  }

  const int unit = unit0 + u;
  const float br = bh[unit], bz = bh[H + unit], bn = bh[2 * H + unit];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + rg + ROW_GROUPS * i;
    if (row >= B) continue;
    const float* x = xg + (size_t)row * H3;
    const float r = 1.f / (1.f + expf(-(x[unit] + (acc[i][0] + br))));
    const float z = 1.f / (1.f + expf(-(x[H + unit] + (acc[i][1] + bz))));
    const float n = tanhf(x[2 * H + unit] + r * (acc[i][2] + bn));
    const float h = h_prev[(size_t)row * H + unit];
    const float h_new = (1.f - z) * n + z * h;
    h_out[(size_t)row * H + unit] = mask[row] > 0.f ? h_new : h;
  }
}

}  // namespace

// Enqueues the whole scan: T step grids on `stream`. Pointers are device
// pointers to contiguous fp32 tensors: xg (T, B, 3H), mask (T, B),
// uh (H, 3H), bh (3H,), h0 (B, H), out (T, B, H). H must be a multiple of
// UNITS. Returns 0 or the first cudaGetLastError() code.
extern "C" int gru_fwd_launch(const void* xg, const void* mask, const void* uh,
                              const void* bh, const void* h0, void* out,
                              int T, int B, int H, int reverse, void* stream) {
  if (H % UNITS != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xg_f = static_cast<const float*>(xg);
  const float* mask_f = static_cast<const float*>(mask);
  float* out_f = static_cast<float*>(out);
  const dim3 grid(H / UNITS, (B + ROWS - 1) / ROWS);
  const float* h_prev = static_cast<const float*>(h0);
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    float* h_t = out_f + (size_t)t * B * H;
    gru_step_kernel<<<grid, THREADS, 0, s>>>(
        xg_f + (size_t)t * B * 3 * H, mask_f + (size_t)t * B,
        static_cast<const float*>(uh), static_cast<const float*>(bh),
        h_prev, h_t, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    h_prev = h_t;
  }
  return 0;
}
