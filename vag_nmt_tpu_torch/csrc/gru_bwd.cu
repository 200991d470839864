// Masked GRU backward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces: vag_nmt_tpu/ops/pallas_gru.py, _bwd_kernel (called from
// _bwd_call, the custom VJP of pallas_gru_scan): the encoder bi-GRU's
// gradient in training.
//
// Given the forward's inputs, its states and the cotangent g of the
// states, walks time against the scan order:
//   hg   = h_prev @ Uh + bh;  r, z, n from xg[t] and hg
//   dh  += g[t];  dh_cell = dh * m[t]   (a masked step sends all grad to
//                                        the carry, and dxg[t] = 0 there)
//   dxg[t] = [da_r, da_z, da_n];  dhg = [da_r, da_z, da_n * r]
//   dh   = dh_cell * z + dh * (1 - m) + dhg @ Uh^T
// and returns dxg, dh0 = the final dh, dUh = sum_t h_prev^T dhg and
// dbh = sum_t,b dhg. h_prev is h0 at the scan's first step and the state
// of the step before (in scan order) elsewhere, read where the forward
// left it (no copy).
//
// Bound on this card at B=64, T=24, H=512: the three products (recompute,
// dhg @ Uh^T, h_prev^T dhg), 3 * 2 * T*B*H*3H = 7.2 GFLOP, run as three
// TF32 products each on the tensor cores (3xTF32): 21.7 GFLOP at 495
// TFLOP/s, 0.044 ms (0.11 ms on the fp32 cores); its streams (xg, hs, g
// in, dxg out, ~21 MB) need ~6 us of HBM. Bound by operations.
//
// Design: three grids a call, whatever T, each named gru_bwd_* (phase 8's
// profile sums the kernel's device time by that name):
//   1. gru_bwd_recompute: HG = h_prev @ Uh for every step at once, as
//      streamed 64 x 64 3xTF32 tiles (dec_scan.cuh's run_jobs): h0's rows
//      and the states' rows are two jobs. bh is added where HG is read.
//   2. gru_bwd_carry: the reverse recurrence, one persistent cooperative
//      grid of one CTA a SM, as the decoder scans' (dec_scan.cuh). Uh^T's
//      columns, sliced by output unit and read transposed from the
//      row-major uh, stay resident in shared memory for the launch (or,
//      where the plan says they do not fit, in a buffer read through L2).
//      The first step of the walk is its cell backward alone (no carry
//      yet); then each step is one product and one grid sync: a CTA's
//      (rows, units) tile of dhg[t_prev] @ Uh^T, with, in its epilogue,
//      dh = base + acc, dh += g[t] and step t's masked cell backward for
//      those units, which writes dxg[t], dhg[t] and base (the carry's
//      direct part) for the next step; after the last step the epilogue
//      writes dh0 = base + acc. Other CTAs read dhg[t] after the sync
//      through L2 only (load4's __ldcg).
//   3. gru_bwd_wgrad: dUh = h_prev^T @ dHG over all T*B rows (streamed
//      tiles, transposed A, the rows in the two segments of grid 1), and
//      in the CTAs after the tiles dbh as column sums in a fixed order.
// Every output has one owner and a fixed sum order (no atomics), so a
// second call repeats the first bit for bit. The tiling of the carry is
// ops/gru_kernel.py's gru_bwd_plan (launch ints), its constants
// dec_scan.cuh's -D defines.
//
// The bf16-stream instance (-DVAG_BF16=1, pallas_gru.py's bf16 streams):
// xg, hs and g arrive in bf16 and dxg leaves in bf16; Uh arrives as bf16
// (the kernel's product operand, jnp's uh.astype(bf16)), its slices held as
// bf16 in shared memory; the three products are bf16 x bf16 -> fp32
// (dec_scan.cuh), the cell backward, the carry and dUh, dbh, dh0 fp32.

#include "dec_scan.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace vag::scan;

struct CarryArgs {
  const sx_t *xg, *hs, *g;      // bf16 instance: the bf16 streams
  const float *mask, *bh, *h0, *hg;
  sx_t* dxg;
  float *dhg, *base, *dh0;
  int T, B, H, reverse;
  Prod p;
  int scratch_off;
  float* wl2;   // the weight slices the plan puts in L2, or null
};

// Step s of the reverse walk: the scan's last step first.
__device__ __forceinline__ int walk(const CarryArgs& a, int s) {
  return a.reverse ? s : a.T - 1 - s;
}

// Element i of the state step t of the forward scan started from: h0
// (fp32) at its first step, else the state of the step before in scan
// order (the stream's type).
__device__ __forceinline__ float hprev(const CarryArgs& a, int t, size_t i) {
  if (t == (a.reverse ? a.T - 1 : 0)) return __ldg(a.h0 + i);
  return ldx(a.hs + (size_t)(a.reverse ? t + 1 : t - 1) * a.B * a.H + i);
}

// Step t's cell backward for (row, u) from the carry into it: dh = carry +
// g[t]; writes dxg[t], dhg[t] and base = dh_cell z + dh (1 - m).
__device__ __forceinline__ void cell_bwd(const CarryArgs& a, int t, int row, int u,
                                         float carry) {
  const int B = a.B, H = a.H;
  const size_t oh = ((size_t)t * B + row) * H + u;
  const size_t o = ((size_t)t * B + row) * 3 * H + u;
  const float dh = carry + ldx(a.g + oh);
  float dx[3], dhg[3];
  a.base[(size_t)row * H + u] = gru_unit_bwd_masked(
      ldx(a.xg + o), ldx(a.xg + o + H), ldx(a.xg + o + 2 * H),
      __ldg(a.hg + o) + __ldg(a.bh + u), __ldg(a.hg + o + H) + __ldg(a.bh + H + u),
      __ldg(a.hg + o + 2 * H) + __ldg(a.bh + 2 * H + u),
      hprev(a, t, (size_t)row * H + u), dh, __ldg(a.mask + (size_t)t * B + row),
      dx, dhg);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    stx(a.dxg + o + k * H, dx[k]);
    a.dhg[o + k * H] = dhg[k];
  }
}

// Brings step t's streams that no earlier grid read (xg[t], g[t]) into L2
// ahead of the step's epilogue: a 128-byte line a thread, across the grid.
__device__ __forceinline__ void prefetch_step(const CarryArgs& a, int t) {
  constexpr int PER = 128 / sizeof(sx_t);   // elements a 128-byte line
  const size_t n3 = (size_t)a.B * 3 * a.H, n1 = (size_t)a.B * a.H;
  const size_t l3 = (n3 + PER - 1) / PER, l1 = (n1 + PER - 1) / PER;
  const sx_t* xg = a.xg + (size_t)t * n3;
  const sx_t* g = a.g + (size_t)t * n1;
  for (size_t i = blockIdx.x * THREADS + threadIdx.x; i < l3 + l1;
       i += (size_t)gridDim.x * THREADS) {
    const sx_t* p = i < l3 ? xg + PER * i : g + PER * (i - l3);
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
  }
}

// GENERAL: see dec_scan.cuh's product.
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1) gru_bwd_carry_kernel(const CarryArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem + a.scratch_off;
  const int T = a.T, B = a.B, H = a.H;
  cg::grid_group grid = cg::this_grid();
  prefetch_step(a, walk(a, 0));
  if (T > 1) prefetch_step(a, walk(a, 1));
  load_slice(a.p, smem, a.wl2);
  // the walk's first step: no carry yet
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
  for (int i = gtid; i < B * H; i += gstride) cell_bwd(a, walk(a, 0), i / H, i % H, 0.f);
  __syncthreads();
  grid.sync();
  for (int s = 1; s <= T; ++s) {
    if (s + 1 < T) prefetch_step(a, walk(a, s + 1));
    // dh = base + dhg[t_prev] @ Uh^T: the carry into step walk(s), or dh0
    product<GENERAL>(a.p, a.dhg + (size_t)walk(a, s - 1) * B * 3 * H, 3 * H, B, smem,
                     a.wl2, scratch,
                     [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int nt = a.p.nt, rt = a.p.rt;
      for (int i = threadIdx.x; i < rt * nt; i += THREADS) {
        const int r = i / nt, j = i % nt, row = row0 + r, u = ct * nt + j;
        if (row >= B || u >= H) continue;
        const size_t o = (size_t)row * H + u;
        const float dh = __ldcg(a.base + o) + tile_sum(part, KS, MT, NI, r, j);
        if (s < T) cell_bwd(a, walk(a, s), row, u, dh);
        else a.dh0[o] = dh;
      }
    });
    if (s < T) grid.sync();
  }
}

// dbh's columns: CTA c (after the wgrad tiles) takes columns [32 c, 32 c +
// 32), one a lane; warp w sums rows w, w + WARPS, ... in row order, then
// lane l of warp 0 adds the warps' sums in warp order.
struct ColSums {
  const float* x;   // dHG (rows, cols)
  int rows, cols, first_cta;
  float* out;
};

__device__ void column_sums(const ColSums& c) {
  constexpr int U = 8;   // loads a thread keeps in flight
  __shared__ float part[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = ((int)blockIdx.x - c.first_cta) * 32 + lane;
  float acc = 0.f;
  if (col < c.cols) {
    for (int r0 = warp; r0 < c.rows; r0 += WARPS * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * WARPS;
        v[u] = r < c.rows ? __ldg(c.x + (size_t)r * c.cols + col) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + u * WARPS < c.rows) acc += v[u];
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < c.cols) {
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += part[w][lane];
    c.out[col] = sum;
  }
}

// Three CTAs a SM (the tiles' 72 KB rings fit): measured 1.3% faster than
// two a call at (B, T) = (64, 24) (PERF.md).
__global__ void __launch_bounds__(THREADS, 3) gru_bwd_recompute_kernel(const Jobs js) {
  run_jobs(js);
}

__global__ void __launch_bounds__(THREADS, 2) gru_bwd_wgrad_kernel(const Jobs js,
                                                                   const ColSums cs) {
  if ((int)blockIdx.x < cs.first_cta) run_jobs(js);
  else column_sums(cs);
}

// Grid 3: js's tiles, then the column sums' CTAs.
int launch_wgrad(const Jobs& js, ColSums cs, cudaStream_t s) {
  int tiles = 0;
  for (int i = 0; i < js.n; ++i) tiles += job_tiles(js.j[i]);
  cs.first_cta = tiles;
  const int smem = (int)sizeof(float) * GSTAGES * GSTAGE;
  cudaError_t e = cudaFuncSetAttribute(
      gru_bwd_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gru_bwd_wgrad_kernel<<<tiles + (cs.cols + 31) / 32, THREADS, smem, s>>>(js, cs);
  return (int)cudaGetLastError();
}

}  // namespace

// Device pointers to contiguous fp32 tensors. Inputs: xg (T, B, 3H), mask
// (T, B), uh (H, 3H), bh (3H,), hs (T, B, H): the forward's states, h0
// (B, H), g (T, B, H): cotangent of the states. Scratch: hg, dhg (T, B,
// 3H), base (B, H). Outputs, all written: dxg (T, B, 3H), dh0 (B, H), duh
// (H, 3H), dbh (3H,). reverse: the forward scanned t = T - 1 .. 0. plan:
// n_plan ints from ops/gru_kernel.py's GruBwdPlan.launch_args: the carry
// grid's CTAs, the scratch region's float offset, the dynamic shared
// memory in bytes, the floats of the weight buffer wl2, then the product's
// ub, nt, rt, nr, col_tiles, cs, cta0, woff, l2off. wl2: that many device
// floats, or null when the plan puts no slice in L2. Enqueues three grids
// (the recompute, the carry, the weight grads); returns 0,
// cudaErrorInvalidValue for a malformed plan or shape,
// cudaErrorCooperativeLaunchTooLarge for a carry grid that is not
// co-resident, or the launch's error.
extern "C" int gru_bwd_launch(const void* xg, const void* mask, const void* uh,
                              const void* bh, const void* hs, const void* h0,
                              const void* g, void* hg, void* dhg, void* base,
                              void* dxg, void* dh0, void* duh, void* dbh, int T,
                              int B, int H, int reverse, const int* plan,
                              int n_plan, void* wl2, void* stream) {
  if (n_plan != 4 + 9 || T < 1 || B < 1 || H < 1 || plan[3] < 0 ||
      (plan[3] > 0 && wl2 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto X = [](const void* p) { return static_cast<const sx_t*>(p); };
  auto M = [](void* p) { return static_cast<float*>(p); };
  const int H3 = 3 * H, ctas = plan[0], smem_bytes = plan[2];
  CarryArgs a{};
  a.xg = X(xg); a.mask = F(mask); a.bh = F(bh); a.hs = X(hs); a.h0 = F(h0);
  a.g = X(g); a.hg = F(hg);
  a.dxg = static_cast<sx_t*>(dxg); a.dhg = M(dhg); a.base = M(base); a.dh0 = M(dh0);
  a.T = T; a.B = B; a.H = H; a.reverse = reverse;
  a.scratch_off = plan[1];
  a.wl2 = M(wl2);
  const int* v = plan + 4;
  a.p = Prod{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], H3, H, H, X(uh), H3, 1};
  if (ctas < 1 || a.p.ub != 0 || !prod_ok(a.p, ctas, a.scratch_off, plan[3]) ||
      a.scratch_off % 4 != 0 ||
      (long long)4 * (a.scratch_off + prod_part_floats(a.p)) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The scan's first step (h0's rows) and the others (the states' rows):
  // their h_prev, and their rows of HG and dHG.
  const int tf = reverse ? T - 1 : 0;
  const float* hs_rows = reinterpret_cast<const float*>(a.hs + (reverse ? (size_t)B * H : 0));
  const size_t first_row = (size_t)tf * B, rest_row = reverse ? 0 : B;
  // 1. HG = h_prev @ Uh
  Jobs pre{};
  pre.n = 2;
  const float* xs[2] = {a.h0, hs_rows};
  const int ms[2] = {B, (T - 1) * B};
  const size_t rows0[2] = {first_row, rest_row};
  for (int i = 0; i < 2; ++i) {
    Job& j = pre.j[i];
    j.nseg = 1; j.a[0] = xs[i]; j.lda[0] = H; j.kd[0] = H;
    j.b[0] = reinterpret_cast<const float*>(X(uh)); j.ldb[0] = H3;
    j.M = ms[i]; j.N = H3; j.out = M(hg) + rows0[i] * H3; j.ldo = H3;
    j.batch = 1; j.epi = STORE;
#if VAG_SCAN_BF16
    j.abf[0] = i;   // the states' rows are the bf16 stream, h0's fp32
    j.bbf[0] = 1;
    j.rnd = 1;
#endif
  }
  VAG_CHECK(launch_jobs(gru_bwd_recompute_kernel, pre, s));
  // 2. the carry
  void (*kern)(CarryArgs) = plan_general(&a.p, 1, plan[3]) ? &gru_bwd_carry_kernel<true>
                                                           : &gru_bwd_carry_kernel<false>;
  const int rc = launch_cooperative(kern, a, ctas, smem_bytes, s);
  if (rc != 0) return rc;
  // 3. dUh = h_prev^T @ dHG over all rows, h0's segment first; dbh
  Jobs post{};
  post.n = 1;
  Job& w = post.j[0];
  w.nseg = 2; w.ta = 1;
  for (int i = 0; i < 2; ++i) {
    w.a[i] = xs[i]; w.lda[i] = H; w.kd[i] = ms[i];
    w.b[i] = a.dhg + rows0[i] * H3; w.ldb[i] = H3;
#if VAG_SCAN_BF16
    w.abf[i] = i;
#endif
  }
#if VAG_SCAN_BF16
  w.rnd = 1;   // bf16(h_prev)^T @ bf16(dhg), summed (and kept) in fp32
#endif
  w.M = H; w.N = H3; w.out = M(duh); w.ldo = H3; w.batch = 1; w.epi = STORE;
  return launch_wgrad(post, ColSums{a.dhg, T * B, H3, 0, M(dbh)}, s);
}
