// Masked GRU forward recurrence on bf16 streams for Hopper (sm_90a), plain C
// interface: kernel 2b (built with -DVAG_BF16=1, ops/_build.py's
// gru_fwd_bf16).
//
// Replaces: vag_nmt_tpu/ops/pallas_gru.py, _fwd_kernel under
// compute_dtype="bfloat16" (entry pallas_gru_scan, its bf16 streams:
// :114-140, :397-421), the encoder's bi-GRU recurrence in bf16 training
// and in a bf16 decode.
//
// Computes, for t over T steps (descending when reverse), from the fp32
// carry h (h0 at the scan's first step):
//   hg  = bf16(h) @ bf16(Uh) + bh          (B, 3H), bf16 x bf16 -> fp32
//   r   = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//   h'  = (1 - z) * n + z * h;  h = mask[t] > 0 ? h' : h;  out[t] = bf16(h)
// with xg = x @ Wi + bi computed outside (one large matmul) and arriving in
// bf16; the carry and the gate math stay fp32.
//
// Bound on this card: at B=64, T=24, H=512 the products are 2.4 GFLOP
// (2.4 us at the bf16 tensor rate) against ~8 MB of streams and weights
// (2.4 us of HBM); every step waits for the one before, so a call is the
// T steps' latency (chip_smoke.py's _gru_fwd_bf16_bound).
//
// Design: one persistent cooperative grid of one CTA a SM, a grid sync
// between time steps, each step one of dec_scan.cuh's per-step products
// (the engine of the decoder scans' recurrences and of gru_bwd.cu's carry)
// on gate tiles: a tile holds a block of ub units with their r, z and n
// columns, so the gate algebra needs nothing from other CTAs. Uh's bf16
// slices stay resident in shared memory for the launch (or, where the
// plan says they do not fit, in the launch's L2 buffer wl2); each warp
// loads its rows of the fp32 carry straight from L2, rounds them to bf16
// as they arrive and runs mma.sync m16n8k16 against the slice with fp32
// accumulators, the warps' k-slices added in a fixed order in the
// epilogue, which runs the cell and the mask in fp32 (gru_gate_algebra's
// operations in torch's order, each rounded: no contraction into an FMA)
// and writes the carry (slot step % 2 of the (2, B, H) buffer) and the
// bf16 state. xg[t + 1] goes to L2 during step t. Every output has one
// owner and a fixed sum order, so a second call repeats the first bit for
// bit; the sums run in the mma's order, not the plain version's. The
// tiling is ops/gru_kernel.py's gru_fwd_bf16_plan (launch ints), the
// product's constants dec_scan.cuh's -D defines. The wrapper zero-pads a
// width that is no multiple of 16 (exact: a padded unit stays 0).
//
// Both directions of the bi-GRU in one grid (gru_fwd_pair's plan): the
// two scans are independent, so each takes its own range of CTAs (its
// product's cta0) and a step of both is one grid sync: at B = 64 a step is
// latency, not work, so the second direction rides along.

#include "dec_scan.cuh"

#if !VAG_SCAN_BF16
#error "gru_fwd_bf16.cu is the bf16-stream instance: build with -DVAG_BF16=1"
#endif

namespace {

namespace cg = cooperative_groups;
using namespace vag::scan;

constexpr int MAX_DIRS = 2;

// One scan of the grid: its streams, carry and product.
struct Scan {
  const sx_t* xg;               // (T, B, 3H) bf16
  const float *bh, *h0;         // (3H,), (B, H)
  sx_t* out;                    // (T, B, H) bf16
  float* carry;                 // (2, B, H): the fp32 carry, slot step % 2
  int reverse;
  Prod p;                       // hg = h @ Uh on gate tiles
};

struct FwdArgs {
  Scan d[MAX_DIRS];
  int n;                        // scans
  const float* mask;            // (T, B)
  int T, B, H;
  int scratch_off;
  float* wl2;                   // the slices the plan puts in L2, or null
};

// Step s's time index of scan d.
__device__ __forceinline__ int step_t(const FwdArgs& a, const Scan& d, int s) {
  return d.reverse ? a.T - 1 - s : s;
}

// Brings scan d's xg[t] into L2 ahead of its step's epilogue: a 128-byte
// line a thread, across the grid.
__device__ __forceinline__ void prefetch_xg(const FwdArgs& a, const Scan& d, int t) {
  constexpr int PER = 128 / sizeof(sx_t);
  const size_t n = (size_t)a.B * 3 * a.H, lines = (n + PER - 1) / PER;
  const sx_t* x = d.xg + (size_t)t * n;
  for (size_t i = blockIdx.x * THREADS + threadIdx.x; i < lines;
       i += (size_t)gridDim.x * THREADS)
    asm volatile("prefetch.global.L2 [%0];" :: "l"(x + PER * i));
}

// The new state of one unit: gru_gate_algebra's operations in torch's
// order, each rounded, from the gate pre-activations and the carry h.
__device__ __forceinline__ float cell_rn(float xr, float xz, float xn, float hr,
                                         float hz, float hn, float h) {
  const float r = 1.f / (1.f + expf(-__fadd_rn(xr, hr)));
  const float z = 1.f / (1.f + expf(-__fadd_rn(xz, hz)));
  const float n = tanhf(__fadd_rn(xn, __fmul_rn(r, hn)));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), n), __fmul_rn(z, h));
}

// Step s of scan d on its CTAs (the others return at once).
template <bool GENERAL>
__device__ __forceinline__ void scan_step(const FwdArgs& a, const Scan& d, int s,
                                          float* smem, float* scratch) {
  const int B = a.B, H = a.H;
  const size_t H3 = 3 * (size_t)H;
  const int t = step_t(a, d, s);
  const float* hp = s == 0 ? d.h0 : d.carry + (size_t)((s + 1) & 1) * B * H;
  float* hc = d.carry + (size_t)(s & 1) * B * H;
  sx_t* ho = d.out + (size_t)t * B * H;
  const sx_t* xt = d.xg + (size_t)t * B * H3;
  const float* mt = a.mask + (size_t)t * B;
  product<GENERAL>(d.p, hp, H, B, smem, a.wl2, scratch,
                   [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
    const int ub = d.p.ub, rt = d.p.rt;
    for (int i = threadIdx.x; i < rt * ub; i += THREADS) {
      const int r = i / ub, uu = i % ub, row = row0 + r, u = ct * ub + uu;
      if (row >= B || u >= H) continue;
      float hg[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        hg[k] = __fadd_rn(tile_sum(part, KS, MT, NI, r, k * ub + uu),
                          __ldg(d.bh + k * H + u));
      const sx_t* x = xt + (size_t)row * H3 + u;
      const size_t o = (size_t)row * H + u;
      const float h = __ldcg(hp + o);
      const float v = __ldg(mt + row) > 0.f
          ? cell_rn(ldx(x), ldx(x + H), ldx(x + 2 * H), hg[0], hg[1], hg[2], h)
          : h;
      hc[o] = v;
      ho[o] = __float2bfloat16_rn(v);
    }
  });
}

// GENERAL: see dec_scan.cuh's product.
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1) gru_fwd_bf16_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem + a.scratch_off;
  cg::grid_group grid = cg::this_grid();
  // the scans' loops unrolled: a.d indexed by constants stays in the
  // parameter space
#pragma unroll
  for (int k = 0; k < MAX_DIRS; ++k) {
    if (k >= a.n) break;
    prefetch_xg(a, a.d[k], step_t(a, a.d[k], 0));
    load_slice(a.d[k].p, smem, a.wl2);   // a CTA reads only its own slices
  }
  __syncthreads();
  for (int s = 0; s < a.T; ++s) {
#pragma unroll
    for (int k = 0; k < MAX_DIRS; ++k) {
      if (k >= a.n) break;
      if (s + 1 < a.T) prefetch_xg(a, a.d[k], step_t(a, a.d[k], s + 1));
      scan_step<GENERAL>(a, a.d[k], s, smem, scratch);
    }
    if (s + 1 < a.T) grid.sync();
  }
}

}  // namespace

// n scans (1, or 2: the bi-GRU's directions) of one shape. Device
// pointers to contiguous tensors, arrays of one a scan: xg (T, B, 3H)
// bf16, uh (H, 3H) bf16 (the product's operand, uh rounded), bh (3H,) and
// h0 (B, H) fp32; outputs out (T, B, H) bf16 and carry (2, B, H) fp32
// scratch; reverse: scan t = T - 1 .. 0. mask (T, B) fp32, shared. plan:
// n_plan ints from ops/gru_kernel.py's gru_fwd_bf16_plan or
// gru_fwd_pair_plan (launch_args): the grid's CTAs, the scratch region's
// float offset, the dynamic shared memory in bytes, the floats of the
// weight buffer wl2, then each scan's product's ub, nt, rt, nr, col_tiles,
// cs, cta0, woff, l2off (disjoint CTA ranges). wl2: that many device
// floats, or null when the plan puts no slice in L2. Enqueues one
// cooperative grid on stream; returns 0, cudaErrorInvalidValue for a
// malformed plan or shape, cudaErrorCooperativeLaunchTooLarge for a grid
// that is not co-resident, or the launch's error.
extern "C" int gru_fwd_bf16_launch(int n, const void* const* xg, const void* mask,
                                   const void* const* uh, const void* const* bh,
                                   const void* const* h0, void* const* out,
                                   void* const* carry, const int* reverse, int T, int B,
                                   int H, const int* plan, int n_plan, void* wl2,
                                   void* stream) {
  if (n < 1 || n > MAX_DIRS || n_plan != 4 + 9 * n || T < 1 || B < 1 || H < 1 ||
      plan[3] < 0 || (plan[3] > 0 && wl2 == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{};
  a.n = n;
  a.mask = static_cast<const float*>(mask);
  a.T = T; a.B = B; a.H = H;
  a.scratch_off = plan[1];
  a.wl2 = static_cast<float*>(wl2);
  const int ctas = plan[0], smem_bytes = plan[2], H3 = 3 * H;
  if (ctas < 1 || a.scratch_off % 4 != 0) return (int)cudaErrorInvalidValue;
  Prod ps[MAX_DIRS];
  for (int k = 0; k < n; ++k) {
    Scan& d = a.d[k];
    d.xg = static_cast<const sx_t*>(xg[k]);
    d.bh = static_cast<const float*>(bh[k]);
    d.h0 = static_cast<const float*>(h0[k]);
    d.out = static_cast<sx_t*>(out[k]);
    d.carry = static_cast<float*>(carry[k]);
    d.reverse = reverse[k];
    const int* v = plan + 4 + 9 * k;
    d.p = ps[k] = Prod{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], H, H3, H,
                       static_cast<const sx_t*>(uh[k]), H3, 0};
    if (d.p.ub == 0 || !prod_ok(d.p, ctas, a.scratch_off, plan[3]) ||
        (long long)4 * (a.scratch_off + prod_part_floats(d.p)) > smem_bytes ||
        (k > 0 && d.p.cta0 < ps[k - 1].cta0 + ps[k - 1].cs * ps[k - 1].nr))
      return (int)cudaErrorInvalidValue;
  }
  void (*kern)(FwdArgs) = plan_general(ps, n, plan[3]) ? &gru_fwd_bf16_kernel<true>
                                                      : &gru_fwd_bf16_kernel<false>;
  return launch_cooperative(kern, a, ctas, smem_bytes, static_cast<cudaStream_t>(stream));
}
