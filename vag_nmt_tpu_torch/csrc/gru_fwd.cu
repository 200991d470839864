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
// Design: one persistent cooperative launch per scan, a grid-wide barrier
// (cooperative_groups grid sync, whose state the runtime keeps per launch)
// between time steps. The TPU kernel keeps all of Uh (3 MB at H=512 fp32)
// resident in VMEM; here it is split by hidden unit over the CTAs: CTA
// (x, y) owns unit tile y (UB units and all three of their gate columns, so
// the gate algebra needs nothing from other CTAs) and loads its H x 3*UB
// slice of Uh into shared memory once per launch. Per step it walks the row
// blocks x, x + gridDim.x, ... (RB rows each) and streams their rows of the
// previous state through a STAGES-deep cp.async ring of KC-deep chunks.
// Those rows were written by other CTAs in the previous step of this
// launch, so they are read through L2 only (cp.async.cg, __ldcg), never
// through the non-coherent read-only path; xg, mask, Uh and bh are
// read-only for the whole launch. Each thread owns R rows x 2 units x 3
// gates, its operands float4 loads from shared memory (the state along k,
// Uh in k pairs). The tiling (R, RB, UB, KC, the grid) is planned in
// ops/gru_kernel.py::gru_fwd_plan; the launcher checks that the grid is
// co-resident and refuses the launch otherwise. Every output is written by
// one thread with its sum taken in a fixed k order, so results do not
// change from run to run. Measured at the decode shape (PERF.md), about
// half of a step is the FMAs, a quarter the shared-memory operand loads
// (they do not overlap the FMAs), the rest the state's loads, the epilogue
// and the barrier: ~42% of the bound. Tensor-core products, which reuse
// each loaded operand many more times, are the next step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// The ring depth and row padding come from ops/gru_kernel.py (GRU_STAGES,
// GRU_PAD), which plans the shared memory they take.
#if !defined(VAG_GRU_STAGES) || !defined(VAG_GRU_PAD)
#error "build with -DVAG_GRU_STAGES=... -DVAG_GRU_PAD=... (ops/_build.py)"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int STAGES = VAG_GRU_STAGES;  // depth of the state-chunk ring
constexpr int PAD = VAG_GRU_PAD;        // floats after each staged row
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Shared memory: us, Uh's slice in k pairs: float 12 * (p * UG + up) +
// 6 * kk + 2 * g + j holds Uh[2p + kk, g*H + unit0 + 2*up + j], so three
// float4 loads give a thread its 2 units x 3 gates for two k; then STAGES
// buffers of RB x (KC + PAD) state rows.
template <int R>
__global__ void __launch_bounds__(MAX_THREADS, 1)
gru_fwd_persistent(const float* __restrict__ xg,    // (T, B, 3H)
                   const float* __restrict__ mask,  // (T, B)
                   const float* __restrict__ uh,    // (H, 3H)
                   const float* __restrict__ bh,    // (3H,)
                   const float* h0,                 // (B, H)
                   float* out,                      // (T, B, H)
                   int T, int B, int H, int reverse, int RB, int UB, int KC) {
  constexpr int U = 2;            // units a thread
  constexpr int W = 6 * U;        // floats of Uh per thread and k pair
  extern __shared__ __align__(16) float smem[];
  const int UG = UB / U;          // unit groups per tile
  const int RG = RB / R;          // row groups per block
  const int HS = KC + PAD;        // staged row stride
  const int NC = H / KC;          // chunks per step
  const int NT = blockDim.x;      // RG * UG
  const int tid = threadIdx.x;
  const int up = tid % UG;
  const int rg = tid / UG;
  const int unit0 = blockIdx.y * UB;
  const int u = unit0 + U * up;   // this thread's first unit
  const int n_rb = (B + RB - 1) / RB;
  const size_t H3 = 3 * (size_t)H;
  float* us = smem;
  float* hs = smem + (size_t)H * 3 * UB;

  for (int i = tid; i < H * 3 * UB; i += NT) {
    const int kp = i / (W * UG), p = (i / W) % UG, c = i % W;
    const int k = 2 * kp + c / (3 * U), g = (c % (3 * U)) / U, j = c % U;
    us[i] = uh[(size_t)k * H3 + (size_t)g * H + unit0 + U * p + j];
  }
  float b[3][U];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int j = 0; j < U; ++j) b[g][j] = bh[g * H + u + j];
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const float* hp = step == 0
        ? h0 : out + (size_t)(reverse ? t + 1 : t - 1) * B * H;
    float* ho = out + (size_t)t * B * H;
    const float* xt = xg + (size_t)t * B * H3;
    for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
      const int row0 = rb * RB;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = row0 + rg + RG * i;
        if (row < B) {
#pragma unroll
          for (int g = 0; g < 3; ++g)
            prefetch_l2(xt + (size_t)row * H3 + (size_t)g * H + u);
        }
      }
      // This thread's 16-byte pieces of a chunk: rows r0, r0 + rstep, ...
      // at column 4 * q4 of the chunk (NT is a multiple of KC / 4).
      const int q4 = tid % (KC / 4), r0 = tid / (KC / 4), rstep = NT / (KC / 4);
      auto load_chunk = [&](int c) {
        float* dst = hs + (size_t)(c % STAGES) * RB * HS + 4 * q4;
        const float* src = hp + (size_t)c * KC + 4 * q4;
        for (int r = r0; r < RB; r += rstep) {
          const int row = row0 + r;
          cp_async16(dst + r * HS, src + (size_t)(row < B ? row : 0) * H,
                     row < B ? 16 : 0);
        }
      };
#pragma unroll
      for (int c = 0; c < STAGES - 1; ++c) {
        if (c < NC) load_chunk(c);
        cp_async_commit();
      }

      float acc[R][3][U];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int j = 0; j < U; ++j) acc[i][g][j] = 0.f;

      for (int c = 0; c < NC; ++c) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (c + STAGES - 1 < NC) load_chunk(c + STAGES - 1);
        cp_async_commit();
        const float* hrow = hs + (size_t)(c % STAGES) * RB * HS + rg * HS;
        const int rstride = RG * HS;
        const float4* uk = reinterpret_cast<const float4*>(us)
            + ((size_t)c * KC / 2 * UG + up) * (W / 4);
#pragma unroll 2
        for (int kq = 0; kq < KC; kq += 4) {
          float4 hv[R];
#pragma unroll
          for (int i = 0; i < R; ++i)
            hv[i] = *reinterpret_cast<const float4*>(hrow + i * rstride + kq);
#pragma unroll
          for (int q = 0; q < 2; ++q) {   // k pairs kq + 2q, kq + 2q + 1
            const float4* w4 = uk + (size_t)(kq / 2 + q) * UG * (W / 4);
            float4 wv[W / 4];
#pragma unroll
            for (int m = 0; m < W / 4; ++m) wv[m] = w4[m];
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
              for (int i = 0; i < R; ++i) {
                const float a = comp(hv[i], 2 * q + kk);
#pragma unroll
                for (int g = 0; g < 3; ++g)
#pragma unroll
                  for (int j = 0; j < U; ++j) {
                    const int e = 3 * U * kk + U * g + j;
                    acc[i][g][j] = fmaf(a, comp(wv[e / 4], e % 4), acc[i][g][j]);
                  }
              }
          }
        }
      }
      cp_async_wait<0>();

      // Epilogue, E rows at a time: every input first (one round trip to L2
      // per E rows, not per row: the stores below may alias them for the
      // compiler), then the gates, the carry and the write of out[t].
      constexpr int E = R < 4 ? R : 4;
#pragma unroll
      for (int i0 = 0; i0 < R; i0 += E) {
        float xs[E][3][U], hh[E][U];
        bool keep[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int row = min(row0 + rg + RG * (i0 + e), B - 1);
          const float* x = xt + (size_t)row * H3 + u;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float2 v = *reinterpret_cast<const float2*>(x + (size_t)g * H);
            xs[e][g][0] = v.x;
            xs[e][g][1] = v.y;
          }
          const float2 v = __ldcg(reinterpret_cast<const float2*>(hp + (size_t)row * H + u));
          hh[e][0] = v.x;
          hh[e][1] = v.y;
          keep[e] = mask[(size_t)t * B + row] > 0.f;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = i0 + e, row = row0 + rg + RG * i;
          if (row >= B) continue;
          float o[U];
#pragma unroll
          for (int j = 0; j < U; ++j) {
            const float r = 1.f / (1.f + expf(-(xs[e][0][j] + (acc[i][0][j] + b[0][j]))));
            const float z = 1.f / (1.f + expf(-(xs[e][1][j] + (acc[i][1][j] + b[1][j]))));
            const float n = tanhf(xs[e][2][j] + r * (acc[i][2][j] + b[2][j]));
            const float h_new = (1.f - z) * n + z * hh[e][j];
            o[j] = keep[e] ? h_new : hh[e][j];
          }
          *reinterpret_cast<float2*>(ho + (size_t)row * H + u) = make_float2(o[0], o[1]);
        }
      }
      __syncthreads();   // the next row block refills the ring
    }
    if (step + 1 < T) grid.sync();
  }
}

template <int R>
int launch(const float* xg, const float* mask, const float* uh,
           const float* bh, const float* h0, float* out, int T, int B, int H,
           int reverse, int RB, int UB, int KC, int GX, cudaStream_t s) {
  const int threads = (RB / R) * (UB / 2);
  // The layout above; ops/gru_kernel.py::gru_fwd_smem_bytes plans by it.
  const size_t smem = sizeof(float) * ((size_t)H * 3 * UB
                                       + (size_t)STAGES * RB * (KC + PAD));
  auto kern = gru_fwd_persistent<R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                         smem)) != cudaSuccess)
    return (int)e;
  const dim3 grid(GX, H / UB);
  if ((long long)grid.x * grid.y > (long long)per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&xg, &mask, &uh, &bh, &h0, &out, &T, &B, &H, &reverse,
                  &RB, &UB, &KC};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), grid,
                                  dim3(threads), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The card's limits the plan is made for: SM count and the opt-in shared
// memory of one block, in bytes.
extern "C" int gru_fwd_limits(int* n_sms, int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return (int)e;
}

// Enqueues the whole scan as one cooperative grid of (GX, H / UB) CTAs of
// (RB / R) * (UB / 2) threads on `stream`. Pointers are device pointers to
// contiguous fp32 tensors: xg (T, B, 3H), mask (T, B), uh (H, 3H),
// bh (3H,), h0 (B, H), out (T, B, H). The plan (R rows a thread in
// {1, 2, 4, 8}, RB, UB, KC, GX) comes from gru_fwd_plan. Returns 0,
// cudaErrorInvalidValue for a malformed plan,
// cudaErrorCooperativeLaunchTooLarge when the grid is not co-resident, or
// the launch's error code.
extern "C" int gru_fwd_launch(const void* xg, const void* mask, const void* uh,
                              const void* bh, const void* h0, void* out,
                              int T, int B, int H, int reverse, int R, int RB,
                              int UB, int KC, int GX, void* stream) {
  const int threads = R > 0 && UB > 0 ? (RB / R) * (UB / 2) : 0;
  if (threads <= 0 || threads > MAX_THREADS || RB % R || UB % 2 || H % UB ||
      KC % 4 || H % KC || threads % (KC / 4) || GX <= 0)
    return (int)cudaErrorInvalidValue;
  const float* a[5] = {static_cast<const float*>(xg),
                       static_cast<const float*>(mask),
                       static_cast<const float*>(uh),
                       static_cast<const float*>(bh),
                       static_cast<const float*>(h0)};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return launch<1>(a[0], a[1], a[2], a[3], a[4], o, T, B, H, reverse, RB, UB, KC, GX, s);
    case 2: return launch<2>(a[0], a[1], a[2], a[3], a[4], o, T, B, H, reverse, RB, UB, KC, GX, s);
    case 4: return launch<4>(a[0], a[1], a[2], a[3], a[4], o, T, B, H, reverse, RB, UB, KC, GX, s);
    case 8: return launch<8>(a[0], a[1], a[2], a[3], a[4], o, T, B, H, reverse, RB, UB, KC, GX, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
