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
// The bf16-stream instance (kernel 3b, -DVAG_BF16=1, pallas_gru.py's bf16
// streams): xg, hs and g arrive in bf16 and dxg leaves in bf16; Uh arrives
// as bf16 (the kernel's product operand, jnp's uh.astype(bf16)), and so
// does h0 rounded (the products' operand; the cell reads h0 in fp32). Its
// three products are bf16 x bf16 -> fp32, the cell backward, the carry and
// dUh, dbh, dh0 fp32. The grids:
//   1. gru_bwd_recompute_tiles: HG = h_prev @ Uh for every step at once on
//      bf16_tile.cuh's tiles (gate tiles: a block of units' r, z and n
//      columns), whose epilogue takes hg = HG + bh and computes every
//      coefficient of the masked cell backward that does not depend on dh
//      (common.cuh's gru_unit_coef: c_r, c_z, c_n, c_nr and the carry's
//      share, the mask folded in) into coef (T, B, 5H);
//   2. the carry as above, its epilogue now a few loads and multiplies,
//      no transcendental on the serial path: dh = base + acc + g[t], dxg =
//      dh [c_r, c_z, c_n], dhg = dh [c_r, c_z, c_nr] (fp32, and a bf16 copy
//      for grid 3), base = dh c_share;
//   3. gru_bwd_wgrad_tiles: dUh = bf16(h_prev)^T @ bf16(dHG) on the same
//      tiles, and dbh as column sums of the fp32 dHG.
// The bf16 instance also takes both directions of the bi-GRU in one call
// (gru_bwd_pair's plan): each scan's carry on its own range of CTAs (its
// product's cta0) with one grid sync a step of both, and the two scans'
// tiles in one launch each for grids 1 and 3.

#include "dec_scan.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace vag::scan;

// Scans a call takes: the bf16 instance one or both directions of the
// bi-GRU, the fp32 instance one.
constexpr int MAX_DIRS = VAG_SCAN_BF16 ? 2 : 1;

// One scan's walk.
struct CarryArgs {
  const sx_t *xg, *hs, *g;      // bf16 instance: the bf16 streams
  const float *mask, *bh, *h0;
  const float* hg;              // fp32: HG; bf16: coef (T, B, 5H)
  sx_t* dxg;
  float *dhg, *base, *dh0;
  int T, B, H, reverse;
  Prod p;
#if VAG_SCAN_BF16
  __nv_bfloat16* dhgb;          // dhg's bf16 copy, grid 3's operand
#endif
};

// The carry grid: its scans on disjoint CTA ranges.
struct CarryGrid {
  CarryArgs d[MAX_DIRS];
  int n, scratch_off;
  float* wl2;   // the weight slices the plan puts in L2, or null
};

// Step s of the reverse walk: the scan's last step first.
__device__ __forceinline__ int walk(const CarryArgs& a, int s) {
  return a.reverse ? s : a.T - 1 - s;
}

#if VAG_SCAN_BF16
// Step t's cell backward for (row, u) from the carry into it and the
// recompute's coefficients: dh = carry + g[t]; writes dxg[t], dhg[t] (and
// its bf16 copy) and base, the carry's direct part.
__device__ __forceinline__ void cell_bwd(const CarryArgs& a, int t, int row, int u,
                                         float carry) {
  const int B = a.B, H = a.H;
  const size_t oh = ((size_t)t * B + row) * H + u;
  const size_t o = ((size_t)t * B + row) * 3 * H + u;
  const float* c = a.hg + ((size_t)t * B + row) * 5 * H + u;
  const float dh = carry + ldx(a.g + oh);
  const float cr = __ldg(c), cz = __ldg(c + H);
  const float dr = dh * cr, dz = dh * cz;
  stx(a.dxg + o, dr);
  stx(a.dxg + o + H, dz);
  stx(a.dxg + o + 2 * H, dh * __ldg(c + 2 * H));
  const float dn = dh * __ldg(c + 3 * H);
  a.dhg[o] = dr;
  a.dhg[o + H] = dz;
  a.dhg[o + 2 * H] = dn;
  a.dhgb[o] = __float2bfloat16_rn(dr);
  a.dhgb[o + H] = __float2bfloat16_rn(dz);
  a.dhgb[o + 2 * H] = __float2bfloat16_rn(dn);
  a.base[(size_t)row * H + u] = dh * __ldg(c + 4 * H);
}

// Brings step t's streams that the carry reads (coef[t], g[t]) into L2
// ahead of the step's epilogue: a 128-byte line a thread, across the grid.
__device__ __forceinline__ void prefetch_step(const CarryArgs& a, int t) {
  const size_t n5 = (size_t)a.B * 5 * a.H, n1 = (size_t)a.B * a.H;
  const size_t l5 = (n5 + 31) / 32, l1 = (n1 + 63) / 64;
  const float* c = a.hg + (size_t)t * n5;
  const sx_t* g = a.g + (size_t)t * n1;
  for (size_t i = blockIdx.x * THREADS + threadIdx.x; i < l5 + l1;
       i += (size_t)gridDim.x * THREADS) {
    const void* p = i < l5 ? static_cast<const void*>(c + 32 * i)
                           : static_cast<const void*>(g + 64 * (i - l5));
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
  }
}
#else
// Element i of the state step t of the forward scan started from: h0
// (fp32) at its first step, else the state of the step before in scan
// order.
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
#endif

// GENERAL: see dec_scan.cuh's product. The scans' loops are unrolled, so
// g.d is indexed by constants and stays in the parameter space.
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1) gru_bwd_carry_kernel(const CarryGrid g) {
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem + g.scratch_off;
  const int T = g.d[0].T, B = g.d[0].B, H = g.d[0].H;
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
#pragma unroll
  for (int k = 0; k < MAX_DIRS; ++k) {
    if (k >= g.n) break;
    const CarryArgs& a = g.d[k];
    prefetch_step(a, walk(a, 0));
    if (T > 1) prefetch_step(a, walk(a, 1));
    load_slice(a.p, smem, g.wl2);
    // the walk's first step: no carry yet
    for (int i = gtid; i < B * H; i += gstride) cell_bwd(a, walk(a, 0), i / H, i % H, 0.f);
  }
  __syncthreads();
  grid.sync();
  for (int s = 1; s <= T; ++s) {
#pragma unroll
    for (int k = 0; k < MAX_DIRS; ++k) {
      if (k >= g.n) break;
      const CarryArgs& a = g.d[k];
      if (s + 1 < T) prefetch_step(a, walk(a, s + 1));
      // dh = base + dhg[t_prev] @ Uh^T: the carry into step walk(s), or dh0
      product<GENERAL>(a.p, a.dhg + (size_t)walk(a, s - 1) * B * 3 * H, 3 * H, B, smem,
                       g.wl2, scratch,
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
    }
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

#if VAG_SCAN_BF16
namespace bt = vag::bt;

__global__ void __launch_bounds__(bt::THREADS, 3)
    gru_bwd_recompute_tiles_kernel(const bt::Jobs js) {
  bt::run(js);
}

// Each scan's dbh: its column sums' CTAs after the ones before.
struct ColSumsN {
  ColSums c[MAX_DIRS];
  int n;
};

__global__ void __launch_bounds__(bt::THREADS, 3)
    gru_bwd_wgrad_tiles_kernel(const bt::Jobs js, const ColSumsN cs) {
  if ((int)blockIdx.x < cs.c[0].first_cta) bt::run(js);
  else if (cs.n == 1 || (int)blockIdx.x < cs.c[1].first_cta) column_sums(cs.c[0]);
  else column_sums(cs.c[1]);
}

// Grid 3: js's tiles, then each scan's column sums' CTAs.
int launch_wgrad(const bt::Jobs& js, ColSumsN cs, cudaStream_t s) {
  int ctas = 0;
  for (int i = 0; i < js.n; ++i) ctas += bt::job_tiles(js.j[i]);
  for (int k = 0; k < cs.n; ++k) {
    cs.c[k].first_cta = ctas;
    ctas += (cs.c[k].cols + 31) / 32;
  }
  const int smem = (int)bt::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      gru_bwd_wgrad_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gru_bwd_wgrad_tiles_kernel<<<ctas, bt::THREADS, smem, s>>>(js, cs);
  return (int)cudaGetLastError();
}
#else
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
#endif

}  // namespace

// n scans of one shape (the bf16 instance: 1, or 2, the bi-GRU's
// directions; the fp32 instance: 1). Device pointers to contiguous
// tensors, arrays of one a scan: inputs xg (T, B, 3H), uh (H, 3H), bh
// (3H,), hs (T, B, H): the forward's states, h0 (B, H), g (T, B, H): the
// states' cotangent; scratch hg, dhg (T, B, 3H), base (B, H); outputs, all
// written, dxg (T, B, 3H), dh0 (B, H), duh (H, 3H), dbh (3H,); reverse:
// the forward scanned t = T - 1 .. 0. mask (T, B), shared. fp32 tensors
// but in the bf16 build xg, hs, g, dxg and uh (bf16), hg (T, B, 5H) for
// the coefficients, and after the stream the scratch dhgb (T, B, 3H) bf16
// and h0b, h0 rounded to bf16, arrays too. plan: n_plan ints from
// ops/gru_kernel.py's gru_bwd_plan or gru_bwd_pair_plan (launch_args):
// the carry grid's CTAs, the scratch region's float offset, the dynamic
// shared memory in bytes, the floats of the weight buffer wl2, then each
// scan's product's ub, nt, rt, nr, col_tiles, cs, cta0, woff, l2off
// (disjoint CTA ranges). wl2: that many device floats, or null when the
// plan puts no slice in L2. Enqueues three grids (the recompute, the
// carry, the weight grads); returns 0, cudaErrorInvalidValue for a
// malformed plan or shape, cudaErrorCooperativeLaunchTooLarge for a carry
// grid that is not co-resident, or the launch's error.
extern "C" int gru_bwd_launch(int n, const void* const* xg, const void* mask,
                              const void* const* uh, const void* const* bh,
                              const void* const* hs, const void* const* h0,
                              const void* const* g, void* const* hg, void* const* dhg,
                              void* const* base, void* const* dxg, void* const* dh0,
                              void* const* duh, void* const* dbh, const int* reverse,
                              int T, int B, int H, const int* plan, int n_plan,
                              void* wl2, void* stream
#if VAG_SCAN_BF16
                              , void* const* dhgb, const void* const* h0b
#endif
                              ) {
  if (n < 1 || n > MAX_DIRS || n_plan != 4 + 9 * n || T < 1 || B < 1 || H < 1 ||
      plan[3] < 0 || (plan[3] > 0 && wl2 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto X = [](const void* p) { return static_cast<const sx_t*>(p); };
  auto M = [](void* p) { return static_cast<float*>(p); };
  const int H3 = 3 * H, ctas = plan[0], smem_bytes = plan[2];
  CarryGrid cg_{};
  cg_.n = n;
  cg_.scratch_off = plan[1];
  cg_.wl2 = M(wl2);
  if (ctas < 1 || cg_.scratch_off % 4 != 0) return (int)cudaErrorInvalidValue;
  Prod ps[MAX_DIRS];
  for (int k = 0; k < n; ++k) {
    CarryArgs& a = cg_.d[k];
    a.xg = X(xg[k]); a.mask = F(mask); a.bh = F(bh[k]); a.hs = X(hs[k]);
    a.h0 = F(h0[k]); a.g = X(g[k]); a.hg = F(hg[k]);
    a.dxg = static_cast<sx_t*>(dxg[k]); a.dhg = M(dhg[k]); a.base = M(base[k]);
    a.dh0 = M(dh0[k]);
    a.T = T; a.B = B; a.H = H; a.reverse = reverse[k];
    const int* v = plan + 4 + 9 * k;
    a.p = ps[k] = Prod{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], H3, H, H,
                       X(uh[k]), H3, 1};
    if (a.p.ub != 0 || !prod_ok(a.p, ctas, cg_.scratch_off, plan[3]) ||
        (long long)4 * (cg_.scratch_off + prod_part_floats(a.p)) > smem_bytes ||
        (k > 0 && a.p.cta0 < ps[k - 1].cta0 + ps[k - 1].cs * ps[k - 1].nr))
      return (int)cudaErrorInvalidValue;
#if VAG_SCAN_BF16
    if (dhgb[k] == nullptr || h0b[k] == nullptr) return (int)cudaErrorInvalidValue;
    a.dhgb = static_cast<__nv_bfloat16*>(dhgb[k]);
#endif
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Each scan's first step (h0's rows) and its others (the states' rows):
  // their h_prev, and their rows of HG and dHG.
  const int ms[2] = {B, (T - 1) * B};
  auto rows0 = [&](int k, int i) -> size_t {
    return i == 0 ? (size_t)(reverse[k] ? T - 1 : 0) * B : reverse[k] ? 0 : (size_t)B;
  };
#if VAG_SCAN_BF16
  auto rows_of = [&](int k, int i) -> const bt::bf16* {
    return i == 0 ? static_cast<const bt::bf16*>(h0b[k])
                  : cg_.d[k].hs + (reverse[k] ? (size_t)B * H : 0);
  };
  // 1. HG = h_prev @ Uh + bh on gate tiles, the coefficients in the epilogue
  bt::Jobs pre{};
  pre.n = 2 * n;
  for (int k = 0; k < n; ++k) {
    const CarryArgs& a = cg_.d[k];
    for (int i = 0; i < 2; ++i) {
      bt::Job& j = pre.j[2 * k + i];
      const size_t r0 = rows0(k, i);
      j.nseg = 1;
      j.s[0] = bt::Seg{rows_of(k, i), a.p.w, H, H3, H};
      j.M = ms[i]; j.N = H; j.epi = bt::GRU_COEF;
      j.out = M(hg[k]) + r0 * 5 * H; j.ldo = 5 * H; j.add = a.bh;
      j.xg = a.xg + r0 * H3; j.m = a.mask + r0;
      j.h = i ? nullptr : a.h0;   // h0 in fp32; the states are A's rows
    }
  }
  VAG_CHECK(bt::launch(gru_bwd_recompute_tiles_kernel, pre, s));
#else
  auto rows_of = [&](int k, int i) -> const float* {
    return i == 0 ? cg_.d[k].h0 : cg_.d[k].hs + (reverse[k] ? (size_t)B * H : 0);
  };
  // 1. HG = h_prev @ Uh
  Jobs pre{};
  pre.n = 2;
  for (int i = 0; i < 2; ++i) {
    Job& j = pre.j[i];
    j.nseg = 1; j.a[0] = rows_of(0, i); j.lda[0] = H; j.kd[0] = H;
    j.b[0] = cg_.d[0].p.w; j.ldb[0] = H3;
    j.M = ms[i]; j.N = H3; j.out = M(hg[0]) + rows0(0, i) * H3; j.ldo = H3;
    j.batch = 1; j.epi = STORE;
  }
  VAG_CHECK(launch_jobs(gru_bwd_recompute_kernel, pre, s));
#endif
  // 2. the carry
  void (*kern)(CarryGrid) = plan_general(ps, n, plan[3]) ? &gru_bwd_carry_kernel<true>
                                                        : &gru_bwd_carry_kernel<false>;
  const int rc = launch_cooperative(kern, cg_, ctas, smem_bytes, s);
  if (rc != 0) return rc;
#if VAG_SCAN_BF16
  // 3. dUh = bf16(h_prev)^T @ bf16(dHG) over all rows, h0's segment first;
  // dbh from the fp32 dHG
  bt::Jobs post{};
  post.n = n;
  ColSumsN cs{};
  cs.n = n;
  for (int k = 0; k < n; ++k) {
    bt::Job& w = post.j[k];
    w.nseg = 2; w.ta = 1;
    for (int i = 0; i < 2; ++i)
      w.s[i] = bt::Seg{rows_of(k, i), cg_.d[k].dhgb + rows0(k, i) * H3, H, H3, ms[i]};
    w.M = H; w.N = H3; w.out = M(duh[k]); w.ldo = H3; w.epi = bt::STORE;
    cs.c[k] = ColSums{cg_.d[k].dhg, T * B, H3, 0, M(dbh[k])};
  }
  return launch_wgrad(post, cs, s);
#else
  // 3. dUh = h_prev^T @ dHG over all rows, h0's segment first; dbh
  Jobs post{};
  post.n = 1;
  Job& w = post.j[0];
  w.nseg = 2; w.ta = 1;
  for (int i = 0; i < 2; ++i) {
    w.a[i] = rows_of(0, i); w.lda[i] = H; w.kd[i] = ms[i];
    w.b[i] = cg_.d[0].dhg + rows0(0, i) * H3; w.ldb[i] = H3;
  }
  w.M = H; w.N = H3; w.out = M(duh[0]); w.ldo = H3; w.batch = 1; w.epi = STORE;
  return launch_wgrad(post, ColSums{cg_.d[0].dhg, T * B, H3, 0, M(dbh[0])}, s);
#endif
}
