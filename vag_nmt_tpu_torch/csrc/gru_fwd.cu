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
//
// The L2 path (L2W): where no tiling holds its Uh slice in shared memory
// (H >= 1280 on this card), the plan keeps the slices in a device buffer
// wl2 of 3 H^2 floats in the same packed layout, one copy a unit tile: the
// CTAs of unit tile y pack a share of its slice each, a grid sync, then
// each stage of the cp.async ring carries, beside the chunk's state rows,
// the slice's KC-deep chunk (3 KC UB floats, contiguous in the packed
// layout) copied from L2 (cp.async.cg), which the product reads as the
// resident path reads its slice.
// Widths that are no multiple of 16 are zero-padded by the wrapper
// (ops/gru_kernel.py), which is exact: a padded unit stays 0.
//
// The bf16-stream instance (-DVAG_BF16=1, build gru_fwd_bf16_fma) is
// kernel 2b for scans that need no gradient, the bf16 decode's encoder:
// its sums run in the plain version's k order, so its states are the plain
// version's bit for bit where cuBLAS sums in k order (training's kernel
// 2b, csrc/gru_fwd_bf16.cu, sums on the tensor cores; PERF.md). As
// pallas_gru.py's bf16 streams under compute_dtype="bfloat16", xg arrives
// and the states leave in bf16, the carry and the gate math stay fp32, and
// hg is bf16(h) @ bf16(Uh) + bh with fp32 sums (each thread's FMA chain
// over k = 0, 1, ..., H - 1; the products of bf16 values are exact in
// fp32). Its epilogue takes the plain version's operations
// (ops/gru_kernel.py) in their order, each rounded (no contraction into an
// FMA), with the same expf and tanhf, so its states differ from the plain
// version's only where the two products' fp32 sums round apart
// (chip_smoke.py's phase 19 prints the share of identical states): a state
// one bf16 ulp apart feeds the next step's product and spreads along the
// recurrence. The wrapper passes Uh rounded to bf16 (in fp32, so the
// slice, its layout and the FMA loop are the fp32 instance's: products of
// bf16 values are exact in fp32; rounding it in the slice's packing loop
// instead measured 0.1 ms slower a call on the H100) and h0 rounded; the
// carry goes through hc (2, B, H) fp32, and the rounded states the product
// stages through ps (2, B, H), both written by the epilogue (slot step %
// 2), since the bf16 out cannot carry the fp32 state.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#if defined(VAG_BF16) && VAG_BF16
#define VAG_GRU_BF16 1
#include <cuda_bf16.h>
typedef __nv_bfloat16 st_t;   // the streams' type
#else
#define VAG_GRU_BF16 0
typedef float st_t;
#endif

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

// Two consecutive stream elements as fp32, and their store.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
#if VAG_GRU_BF16
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
#endif

// Shared memory: us, Uh's slice in k pairs: float 12 * (p * UG + up) +
// 6 * kk + 2 * g + j holds Uh[2p + kk, g*H + unit0 + 2*up + j], so three
// float4 loads give a thread its 2 units x 3 gates for two k; then STAGES
// buffers of RB x (KC + PAD) state rows. With L2W the slice lives in wl2
// (unit tile y's at y * H * 3 * UB) and each ring stage is RB x (KC + PAD)
// state rows, then the slice's chunk of 3 * KC * UB floats.
template <int R, bool L2W>
__global__ void __launch_bounds__(MAX_THREADS, 1)
gru_fwd_persistent(const st_t* __restrict__ xg,     // (T, B, 3H)
                   const float* __restrict__ mask,  // (T, B)
                   const float* __restrict__ uh,    // (H, 3H)
                   const float* __restrict__ bh,    // (3H,)
                   const float* h0,                 // (B, H)
                   st_t* out,                       // (T, B, H)
                   float* wl2,                      // (3 H^2,) with L2W
                   int T, int B, int H, int reverse, int RB, int UB, int KC
#if VAG_GRU_BF16
                   , float* hc, float* ps, const float* h0r   // (2, B, H) x 2, (B, H)
#endif
                   ) {
  constexpr int U = 2;            // units a thread
  constexpr int W = 6 * U;        // floats of Uh per thread and k pair
  extern __shared__ __align__(16) float smem[];
  const int UG = UB / U;          // unit groups per tile
  const int RG = RB / R;          // row groups per block
  const int HS = KC + PAD;        // staged row stride
  const int SF = RB * HS + (L2W ? 3 * KC * UB : 0);   // floats a ring stage
  const int NC = H / KC;          // chunks per step
  const int NT = blockDim.x;      // RG * UG
  const int tid = threadIdx.x;
  const int up = tid % UG;
  const int rg = tid / UG;
  const int unit0 = blockIdx.y * UB;
  const int u = unit0 + U * up;   // this thread's first unit
  const int n_rb = (B + RB - 1) / RB;
  const size_t H3 = 3 * (size_t)H;
  float* us = L2W ? wl2 + (size_t)blockIdx.y * H * 3 * UB : smem;
  float* hs = L2W ? smem : smem + (size_t)H * 3 * UB;

  cg::grid_group grid = cg::this_grid();
  // The slice in the packed layout; with L2W the unit tile's CTAs share it.
  const int pack0 = L2W ? blockIdx.x * NT + tid : tid;
  const int pack_step = L2W ? gridDim.x * NT : NT;
  for (int i = pack0; i < H * 3 * UB; i += pack_step) {
    const int kp = i / (W * UG), p = (i / W) % UG, c = i % W;
    const int k = 2 * kp + c / (3 * U), g = (c % (3 * U)) / U, j = c % U;
    us[i] = uh[(size_t)k * H3 + (size_t)g * H + unit0 + U * p + j];
  }
  float b[3][U];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int j = 0; j < U; ++j) b[g][j] = bh[g * H + u + j];
  if (L2W) {
    __threadfence();
    grid.sync();     // every share of the slices packed
  } else {
    __syncthreads();
  }

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
#if VAG_GRU_BF16
    // the product's rows (bf16-rounded) and the carry (fp32) of the step before
    const size_t prev = (size_t)((step + 1) % 2) * B * H, cur = (size_t)(step % 2) * B * H;
    const float* hp = step == 0 ? h0r : ps + prev;
    const float* hcar = step == 0 ? h0 : hc + prev;
#else
    const float* hp = step == 0
        ? h0 : out + (size_t)(reverse ? t + 1 : t - 1) * B * H;
    const float* hcar = hp;
#endif
    st_t* ho = out + (size_t)t * B * H;
    const st_t* xt = xg + (size_t)t * B * H3;
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
        float* dst = hs + (size_t)(c % STAGES) * SF + 4 * q4;
        const float* src = hp + (size_t)c * KC + 4 * q4;
        for (int r = r0; r < RB; r += rstep) {
          const int row = row0 + r;
          cp_async16(dst + r * HS, src + (size_t)(row < B ? row : 0) * H,
                     row < B ? 16 : 0);
        }
        if (L2W) {
          float* wd = hs + (size_t)(c % STAGES) * SF + RB * HS;
          const float* ws = us + (size_t)c * 3 * KC * UB;
          for (int i = 4 * tid; i < 3 * KC * UB; i += 4 * NT)
            cp_async16(wd + i, ws + i, 16);
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
        const float* hrow = hs + (size_t)(c % STAGES) * SF + rg * HS;
        const int rstride = RG * HS;
        const float4* uk = L2W
            ? reinterpret_cast<const float4*>(hs + (size_t)(c % STAGES) * SF
                                              + RB * HS) + (size_t)up * (W / 4)
            : reinterpret_cast<const float4*>(us)
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
          const st_t* x = xt + (size_t)row * H3 + u;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float2 v = load2(x + (size_t)g * H);
            xs[e][g][0] = v.x;
            xs[e][g][1] = v.y;
          }
          const float2 v = __ldcg(reinterpret_cast<const float2*>(hcar + (size_t)row * H + u));
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
#if VAG_GRU_BF16
            // gru_gate_algebra's operations in torch's order, each rounded
            float hg[3];
#pragma unroll
            for (int g = 0; g < 3; ++g)
              hg[g] = __fadd_rn(acc[i][g][j], b[g][j]);
            const float r = 1.f / (1.f + expf(-__fadd_rn(xs[e][0][j], hg[0])));
            const float z = 1.f / (1.f + expf(-__fadd_rn(xs[e][1][j], hg[1])));
            const float n = tanhf(__fadd_rn(xs[e][2][j], __fmul_rn(r, hg[2])));
            const float h_new = __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), n),
                                          __fmul_rn(z, hh[e][j]));
#else
            const float r = 1.f / (1.f + expf(-(xs[e][0][j] + (acc[i][0][j] + b[0][j]))));
            const float z = 1.f / (1.f + expf(-(xs[e][1][j] + (acc[i][1][j] + b[1][j]))));
            const float n = tanhf(xs[e][2][j] + r * (acc[i][2][j] + b[2][j]));
            const float h_new = (1.f - z) * n + z * hh[e][j];
#endif
            o[j] = keep[e] ? h_new : hh[e][j];
          }
          store2(ho + (size_t)row * H + u, o[0], o[1]);
#if VAG_GRU_BF16
          const size_t oc = cur + (size_t)row * H + u;
          *reinterpret_cast<float2*>(hc + oc) = make_float2(o[0], o[1]);
          *reinterpret_cast<float2*>(ps + oc) =
              __bfloat1622float2(__floats2bfloat162_rn(o[0], o[1]));
#endif
        }
      }
      __syncthreads();   // the next row block refills the ring
    }
    if (step + 1 < T) grid.sync();
  }
}

template <int R, bool L2W>
int launch(const st_t* xg, const float* mask, const float* uh,
           const float* bh, const float* h0, st_t* out, float* wl2, int T,
           int B, int H, int reverse, int RB, int UB, int KC, int GX,
           cudaStream_t s
#if VAG_GRU_BF16
           , float* hc, float* ps, const float* h0r
#endif
           ) {
  const int threads = (RB / R) * (UB / 2);
  // The layout above; ops/gru_kernel.py::gru_fwd_smem_bytes plans by it.
  const size_t smem = sizeof(float) * (
      L2W ? (size_t)STAGES * (RB * (KC + PAD) + 3 * KC * UB)
          : (size_t)H * 3 * UB + (size_t)STAGES * RB * (KC + PAD));
  auto kern = gru_fwd_persistent<R, L2W>;
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
  void* args[] = {&xg, &mask, &uh, &bh, &h0, &out, &wl2, &T, &B, &H,
                  &reverse, &RB, &UB, &KC
#if VAG_GRU_BF16
                  , &hc, &ps, &h0r
#endif
                  };
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
// contiguous fp32 tensors (xg and out bf16 in the bf16 instance, which
// also takes hc, ps (2, B, H) fp32 scratch and h0r, h0 rounded to bf16,
// in fp32): xg (T, B, 3H), mask (T, B), uh (H, 3H),
// bh (3H,), h0 (B, H), out (T, B, H). The plan (R rows a thread in
// {1, 2, 4, 8}, RB, UB, KC, GX, and l2: Uh's slices in wl2, a scratch
// buffer of 3 H^2 floats, else null) comes from gru_fwd_plan. Returns 0,
// cudaErrorInvalidValue for a malformed plan,
// cudaErrorCooperativeLaunchTooLarge when the grid is not co-resident, or
// the launch's error code.
extern "C" int gru_fwd_launch(const void* xg, const void* mask, const void* uh,
                              const void* bh, const void* h0, void* out,
                              void* wl2, int T, int B, int H, int reverse,
                              int R, int RB, int UB, int KC, int GX, int l2,
                              void* stream
#if VAG_GRU_BF16
                              , void* hc, void* ps, const void* h0r
#endif
                              ) {
  const int threads = R > 0 && UB > 0 ? (RB / R) * (UB / 2) : 0;
  if (threads <= 0 || threads > MAX_THREADS || RB % R || UB % 2 || H % UB ||
      KC % 4 || H % KC || threads % (KC / 4) || GX <= 0 ||
      (l2 && wl2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const st_t* x = static_cast<const st_t*>(xg);
  const float* a[5] = {nullptr,
                       static_cast<const float*>(mask),
                       static_cast<const float*>(uh),
                       static_cast<const float*>(bh),
                       static_cast<const float*>(h0)};
  st_t* o = static_cast<st_t*>(out);
  float* w = static_cast<float*>(wl2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if VAG_GRU_BF16
  if (hc == nullptr || ps == nullptr || h0r == nullptr) return (int)cudaErrorInvalidValue;
#define VAG_GRU_EXTRA , static_cast<float*>(hc), static_cast<float*>(ps), \
                        static_cast<const float*>(h0r)
#else
#define VAG_GRU_EXTRA
#endif
#define VAG_GRU_CASE(RR)                                                    \
  case RR:                                                                  \
    return l2 ? launch<RR, true>(x, a[1], a[2], a[3], a[4], o, w, T, B,     \
                                 H, reverse, RB, UB, KC, GX, s VAG_GRU_EXTRA) \
              : launch<RR, false>(x, a[1], a[2], a[3], a[4], o, w, T, B,    \
                                  H, reverse, RB, UB, KC, GX, s VAG_GRU_EXTRA);
  switch (R) {
    VAG_GRU_CASE(1)
    VAG_GRU_CASE(2)
    VAG_GRU_CASE(4)
    VAG_GRU_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VAG_GRU_CASE
#undef VAG_GRU_EXTRA
}
