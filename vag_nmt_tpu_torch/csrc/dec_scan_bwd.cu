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
// Bound on this card at B=64, T=Tt=24, full width: the forward's products
// twice (the input grads and the weight grads) in 3xTF32 on the tensor
// cores, and the attention's dw, energies and context sums on the fp32
// cores; bound by operations (chip_smoke.py's _dec_scan_bound).
//
// Design. The carry runs in one persistent cooperative grid, one CTA per
// SM, as the forward's (dec_scan_fwd.cu): the transposed recurrent weights
// it needs (wi2^T, uh2^T, ua^T, uh1^T, read from the row-major weights)
// stay resident in shared memory, split by output column (or, where the
// plan says they do not fit, in a buffer read through L2). What does not
// feed the carry runs in grids of its own, six grids a call, each named
// dec_scan_bwd_*:
//   1-2. dpre, then dpre @ ws^T and dpre @ wc^T as streamed 64 x 64 tiles
//        over all Tt*B rows;
//   3.   the recurrence: GRU2's cell backward of the last step, then per
//        step four phases with a grid sync after each:
//     (A) dc = dc_ro + dxg2 @ wi2^T and ds~ = ds~2 + dhg2 @ uh2^T, on
//         disjoint CTAs;
//     (B) the attention backward, a row taken by att_parts CTAs (each
//         computes the row's dw and dscore, and its share of the A
//         columns' energies): writes dscore, dq and the row's dva term;
//     (C) ds~ += dq @ ua^T with GRU1's cell backward in the epilogue:
//         writes dxg1, dhg1 and the carry's share ds~ z1;
//     (D) ds = ds~ z1 + dhg1 @ uh1^T with the previous step's GRU2 cell
//         backward in the epilogue (ds0 at the first step);
//   4.   the ten weight grads as products over the Tt*B rows and dctx =
//        sum_t w_t^T dc_t as a product per sentence (streamed tiles);
//   5.   dctx_proj in one pass over (b, j, a), summing over t from the
//        last step with the energies recomputed, and the bias grads' row
//        blocks;
//   6.   the bias grads: each column's row blocks added in block order.
// Every output has one owner and a fixed sum order (no atomics), so a
// second call repeats the first bit for bit. The tiling is ops/dec_scan.py's
// dec_scan_plan.
//
// The bf16 instance (-DVAG_BF16=1) takes the forward's bf16 copies of s,
// s~ and c (under bf16 the backward runs on the replay's residuals:
// dec_scan_fwd.cu), writes bf16 copies of dpre, dxg2, dhg2, dq and dhg1
// beside them (the recurrence's products read those, dec_scan.cuh), and
// runs the readout terms and the weight grads on bf16_tile.cuh's m16n8k16
// tiles of the copies, summed in fp32, each grad rounded to bf16 once;
// dctx stays a grid of fp32 (3xTF32) products: seven grids a call.

#include "dec_scan.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace vag::scan;
using vag::tanh_fast;
using vag::warp_sum;

enum { P_DC = 0, P_DST = 1, P_DSTQ = 2, P_DS = 3 };

struct BwdArgs {
  const float *s, *st, *c, *w, *q, *hg1, *xg2, *hg2, *ctxp, *mask, *va;
  const sx_t *xg1, *ctx;        // bf16 instance: the bf16 streams
  sx_t *dxg1, *dctx;            // and their grads
  float *dty, *ds0, *dctxp;
  float *dbh1, *dva, *dbi2, *dbh2;
  sx_t *duh1, *dua, *dwi2, *duh2, *dws, *dwc;   // the weights' type
  float *ds_ro, *dc, *dxg2, *dhg2, *dhg1, *dq, *dva_rows, *dsc, *dstp, *dst,
      *dsp, *colsum;
  int Tt, B, T, H, A, C, R;
  Prod p[4];
  int att_parts, scratch_off, colsum_rows;
  float* wl2;                   // the weight slices the plan puts in L2
  unsigned long long* timers;   // 4 Tt + 2 barrier stamps, or null
#if VAG_SCAN_BF16
  // the forward's bf16 copies of s, s~, c (the weight grads' operands)
  const __nv_bfloat16 *sb, *stb, *cb;
  // bf16 copies the epilogues write beside dpre, dxg2, dhg2, dhg1, dq
  __nv_bfloat16 *dpreb, *dxg2b, *dhg2b, *dhg1b, *dqb;
#endif
};

// GRU2's cell backward of step t for (row, u): dh = ds + ds_ro[t]; writes
// dxg2[t], dhg2[t] and the carry's share ds~2 = dh z2 (dstp).
__device__ __forceinline__ void gru2_bwd(const BwdArgs& g, int t, int row, int u,
                                         float ds) {
  const int B = g.B, H = g.H, H3 = 3 * H;
  const size_t o = ((size_t)t * B + row) * H3 + u;
  const size_t oh = ((size_t)t * B + row) * H + u;
  const float dh = ds + __ldcg(g.ds_ro + oh);
  float dx[3], dhg[3];
  g.dstp[(size_t)row * H + u] = gru_unit_bwd(
      __ldg(g.xg2 + o), __ldg(g.xg2 + o + H), __ldg(g.xg2 + o + 2 * H),
      __ldg(g.hg2 + o), __ldg(g.hg2 + o + H), __ldg(g.hg2 + o + 2 * H),
      __ldg(g.st + oh), dh, dx, dhg);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.dxg2[o + k * H] = dx[k];
    g.dhg2[o + k * H] = dhg[k];
#if VAG_SCAN_BF16
    g.dxg2b[o + k * H] = __float2bfloat16_rn(dx[k]);
    g.dhg2b[o + k * H] = __float2bfloat16_rn(dhg[k]);
#endif
  }
}

#if VAG_SCAN_BF16
// dw_j = dc . ctx_j for the bf16 ctx (C a multiple of 8, ctx 16-byte
// aligned): eight columns a lane from one 16-byte load a position, kept in
// bf16 until used, so a lane's loads of one batch cover twice the columns
// of the four-wide path for the same registers and its chain of batches is
// half as long. dcs: dc in shared memory; dws: the row's dw.
__device__ __forceinline__ void dw_bf16(const BwdArgs& g, int b, const float* dcs,
                                        float* dws) {
  const int B = g.B, T = g.T, C = g.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = warp; j0 < T; j0 += WARPS * JB) {
    float acc[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) acc[jj] = 0.f;
    for (int k0 = 8 * lane; k0 < C; k0 += 1024) {
      uint4 x[JB][4];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + jj * WARPS;
          x[jj][u] = load8(g.ctx, C, b * T + j, j < T ? B * T : 0, k0 + 256 * u, C);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + 256 * u;
        if (k >= C) break;
        const float4 d0 = *reinterpret_cast<const float4*>(dcs + k);
        const float4 d1 = *reinterpret_cast<const float4*>(dcs + k + 4);
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const uint4 v = x[jj][u];
          acc[jj] += d0.x * bf_lo(v.x) + d0.y * bf_hi(v.x) + d0.z * bf_lo(v.y) +
                     d0.w * bf_hi(v.y) + d1.x * bf_lo(v.z) + d1.y * bf_hi(v.z) +
                     d1.z * bf_lo(v.w) + d1.w * bf_hi(v.w);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const float e = warp_sum(acc[jj]);
      if (lane == 0 && j0 + jj * WARPS < T) dws[j0 + jj * WARPS] = e;
    }
  }
}
#endif

// Phase (B) for step t: item i = b * att_parts + part. Each CTA of a row
// computes the row's dw and dscore, then its part's A columns: energies
// recomputed on tanh_fast, dq and the row's dva term. Shared
// (att_floats_bwd): dc (C, zero-padded to a multiple of 4), w (T),
// dw / dscore (T), q (A), va (A), the mask (T).
__device__ void attention_bwd(const BwdArgs& g, int t, float* sm) {
  const int B = g.B, T = g.T, A = g.A, C = g.C, P = g.att_parts;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T4 = round_up(T, 4), A4 = round_up(A, 4);
  float* dcs = sm;
  float* wv = dcs + round_up(C, 4);
  float* dws = wv + T4;
  float* qs = dws + T4;
  float* vs = qs + A4;
  float* msk = vs + A4;
  const bool vc = C % 4 == 0 && al16(g.ctx);
#if VAG_SCAN_BF16
  const bool c8 = C % 8 == 0 && al16(g.ctx);
#endif
  const size_t tB = (size_t)t * B;
  for (int item = blockIdx.x; item < B * P; item += gridDim.x) {
    const int b = item / P, part = item % P;
    for (int i = tid; i < round_up(C, 4); i += THREADS)
      dcs[i] = i < C ? __ldcg(g.dc + (tB + b) * C + i) : 0.f;
    for (int i = tid; i < T; i += THREADS) {
      wv[i] = __ldg(g.w + (tB + b) * T + i);
      msk[i] = __ldg(g.mask + (size_t)b * T + i);
    }
    for (int i = tid; i < A; i += THREADS) {
      qs[i] = __ldg(g.q + (tB + b) * A + i);
      vs[i] = __ldg(g.va + i);
    }
    __syncthreads();
#if VAG_SCAN_BF16
    if (c8) dw_bf16(g, b, dcs, dws);
    else
#endif
    // dw_j = dc . ctx_j: a warp takes JB positions at once, all their ctx
    // loads of a 512-column chunk in flight before the first product
    for (int j0 = warp; j0 < T; j0 += WARPS * JB) {
      float acc[JB];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) acc[jj] = 0.f;
      for (int k0 = 4 * lane; k0 < C; k0 += 512) {
        float4 x[JB][4];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + jj * WARPS;
            x[jj][u] = load4(g.ctx, C, b * T + j, j < T ? B * T : 0, k0 + 128 * u, C, vc);
          }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + 128 * u;
          if (k >= C) break;
          const float4 d = *reinterpret_cast<const float4*>(dcs + k);
#pragma unroll
          for (int jj = 0; jj < JB; ++jj)
            acc[jj] += d.x * x[jj][u].x + d.y * x[jj][u].y + d.z * x[jj][u].z +
                       d.w * x[jj][u].w;
        }
      }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const float e = warp_sum(acc[jj]);
        if (lane == 0 && j0 + jj * WARPS < T) dws[j0 + jj * WARPS] = e;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float swdw = 0.f;
      for (int j = lane; j < T; j += 32) swdw += wv[j] * dws[j];
      swdw = warp_sum(swdw);
      for (int j = lane; j < T; j += 32) {
        dws[j] = msk[j] > 0.f ? wv[j] * (dws[j] - swdw) : 0.f;
        if (part == 0) g.dsc[(tB + b) * T + j] = dws[j];
      }
    }
    __syncthreads();
    const int per = (A + P - 1) / P;
    const int end = min(A, (part + 1) * per);
    for (int a = part * per + tid; a < end; a += THREADS) {
      const float qa = qs[a], vaa = vs[a];
      const float* cp = g.ctxp + (size_t)b * T * A + a;
      float dqa = 0.f, dvaa = 0.f;
      for (int j0 = 0; j0 < T; j0 += ATT_BATCH) {
        float x[ATT_BATCH];
#pragma unroll
        for (int u = 0; u < ATT_BATCH; ++u)
          x[u] = j0 + u < T ? __ldg(cp + (size_t)(j0 + u) * A) : 0.f;
#pragma unroll
        for (int u = 0; u < ATT_BATCH; ++u) {
          if (j0 + u < T) {
            const float e = tanh_fast(x[u] + qa), ds = dws[j0 + u];
            dqa += ds * vaa * (1.f - e * e);
            dvaa += e * ds;
          }
        }
      }
      g.dq[(tB + b) * A + a] = dqa;
      g.dva_rows[(tB + b) * A + a] = dvaa;
#if VAG_SCAN_BF16
      g.dqb[(tB + b) * A + a] = __float2bfloat16_rn(dqa);
#endif
    }
    __syncthreads();   // the next item refills the shared row
  }
}

// GENERAL: see dec_scan.cuh's product.
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1) dec_scan_bwd_kernel(const BwdArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem + g.scratch_off;
  const int Tt = g.Tt, B = g.B, H = g.H, A = g.A, C = g.C;
  const int H3 = 3 * H;
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
  cg::grid_group grid = cg::this_grid();
  int n_stamp = 0;
  stamp(g.timers, n_stamp++);
  for (int i = 0; i < 4; ++i) load_slice(g.p[i], smem, g.wl2);
  // GRU2's cell backward of the last step (no carry yet)
  for (int i = gtid; i < B * H; i += gstride) gru2_bwd(g, Tt - 1, i / H, i % H, 0.f);
  __syncthreads();
  grid.sync();
  stamp(g.timers, n_stamp++);

  for (int t = Tt - 1; t >= 0; --t) {
    const size_t tB = (size_t)t * B;
    // (A) dc += dxg2 @ wi2^T;  ds~ = ds~2 + dhg2 @ uh2^T
    product<GENERAL>(g.p[P_DC], g.dxg2 + tB * H3, H3, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int nt = g.p[P_DC].nt, rt = g.p[P_DC].rt;
      for (int i = threadIdx.x; i < rt * nt; i += THREADS) {
        const int r = i / nt, j = i % nt, row = row0 + r, col = ct * nt + j;
        if (row >= B || col >= C) continue;
        float* d = g.dc + (tB + row) * C + col;
        *d = __ldcg(d) + tile_sum(part, KS, MT, NI, r, j);
      }
    });
    product<GENERAL>(g.p[P_DST], g.dhg2 + tB * H3, H3, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int nt = g.p[P_DST].nt, rt = g.p[P_DST].rt;
      for (int i = threadIdx.x; i < rt * nt; i += THREADS) {
        const int r = i / nt, j = i % nt, row = row0 + r, u = ct * nt + j;
        if (row >= B || u >= H) continue;
        const size_t o = (size_t)row * H + u;
        g.dst[o] = __ldcg(g.dstp + o) + tile_sum(part, KS, MT, NI, r, j);
      }
    });
    grid.sync();
    stamp(g.timers, n_stamp++);
    // (B) the attention backward: dscore, dq, the rows' dva terms
    attention_bwd(g, t, scratch);
    grid.sync();
    stamp(g.timers, n_stamp++);
    // (C) ds~ += dq @ ua^T, GRU1's cell backward: dxg1, dhg1, ds~ z1
    product<GENERAL>(g.p[P_DSTQ], g.dq + tB * A, A, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int nt = g.p[P_DSTQ].nt, rt = g.p[P_DSTQ].rt;
      for (int i = threadIdx.x; i < rt * nt; i += THREADS) {
        const int r = i / nt, j = i % nt, row = row0 + r, u = ct * nt + j;
        if (row >= B || u >= H) continue;
        const size_t oh = (size_t)row * H + u, o = (tB + row) * H3 + u;
        const float dh = __ldcg(g.dst + oh) + tile_sum(part, KS, MT, NI, r, j);
        float dx[3], dhg[3];
        g.dsp[oh] = gru_unit_bwd(
            ldx(g.xg1 + o), ldx(g.xg1 + o + H), ldx(g.xg1 + o + 2 * H),
            __ldg(g.hg1 + o), __ldg(g.hg1 + o + H), __ldg(g.hg1 + o + 2 * H),
            __ldg(g.s + tB * H + oh), dh, dx, dhg);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          stx(g.dxg1 + o + k * H, dx[k]);
          g.dhg1[o + k * H] = dhg[k];
#if VAG_SCAN_BF16
          g.dhg1b[o + k * H] = __float2bfloat16_rn(dhg[k]);
#endif
        }
      }
    });
    grid.sync();
    stamp(g.timers, n_stamp++);
    // (D) ds = ds~ z1 + dhg1 @ uh1^T, then GRU2's cell backward of step t - 1
    product<GENERAL>(g.p[P_DS], g.dhg1 + tB * H3, H3, B, smem, g.wl2, scratch,
            [&](int ct, int row0, const float* part, int KS, int MT, int NI) {
      const int nt = g.p[P_DS].nt, rt = g.p[P_DS].rt;
      for (int i = threadIdx.x; i < rt * nt; i += THREADS) {
        const int r = i / nt, j = i % nt, row = row0 + r, u = ct * nt + j;
        if (row >= B || u >= H) continue;
        const size_t oh = (size_t)row * H + u;
        const float ds = __ldcg(g.dsp + oh) + tile_sum(part, KS, MT, NI, r, j);
        if (t > 0) gru2_bwd(g, t - 1, row, u, ds);
        else g.ds0[oh] = ds;
      }
    });
    grid.sync();
    stamp(g.timers, n_stamp++);
  }
}

// dpre = g (1 - t^2), the readout's cotangent (dty), over n values.
__global__ void dec_scan_bwd_dpre_kernel(const float* __restrict__ g, const float* __restrict__ t,
                            float* __restrict__ dty, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dty[i] = g[i] * (1.f - t[i] * t[i]);
}

#if VAG_SCAN_BF16
// The same, and its bf16 copy (the readout terms' and ws / wc grads'
// operand).
__global__ void dec_scan_bwd_dpre_bf16_kernel(const float* __restrict__ g,
                                              const float* __restrict__ t,
                                              float* __restrict__ dty,
                                              __nv_bfloat16* __restrict__ dtyb, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = g[i] * (1.f - t[i] * t[i]);
  dty[i] = v;
  dtyb[i] = __float2bfloat16_rn(v);
}

// The bf16 instance's grids of bf16 tiles (bf16_tile.cuh): the readout
// terms, and the weight grads.
__global__ void __launch_bounds__(vag::bt::THREADS, 3)
    dec_scan_bwd_readout_tiles_kernel(const vag::bt::Jobs js) {
  vag::bt::run(js);
}
__global__ void __launch_bounds__(vag::bt::THREADS, 3)
    dec_scan_bwd_wgrad_tiles_kernel(const vag::bt::Jobs js) {
  vag::bt::run(js);
}
#endif

// The bias grads' columns: dhg1, dxg2, dhg2 (3H each), then the dva terms
// (A): the source column and its output.
__device__ __forceinline__ void bias_column(const BwdArgs& g, int col,
                                            const float*& src, int& ld, float*& out) {
  const int H3 = 3 * g.H, blk = col < 3 * H3 ? col / H3 : 3;
  const int c = blk < 3 ? col - blk * H3 : col - 3 * H3;
  const float* srcs[4] = {g.dhg1, g.dxg2, g.dhg2, g.dva_rows};
  float* outs[4] = {g.dbh1, g.dbi2, g.dbh2, g.dva};
  src = srcs[blk] + c;
  ld = blk < 3 ? H3 : g.A;
  out = outs[blk] + c;
}

// After the recurrence, beside the weight grads' grid: dctx_proj[b, j, a]
// = sum over t from the last of dscore va (1 - e^2), the energies
// recomputed on tanh_fast; and the bias grads' row blocks, each block of
// colsum_rows rows summed in row order into colsum.
__global__ void __launch_bounds__(THREADS) dec_scan_bwd_tail_kernel(const BwdArgs g) {
  const int Tt = g.Tt, B = g.B, T = g.T, A = g.A, rows = Tt * B;
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
  for (size_t i = gtid; i < (size_t)B * T * A; i += gstride) {
    const int a = (int)(i % A), j = (int)(i / A % T), b = (int)(i / ((size_t)T * A));
    const float cp = __ldg(g.ctxp + i), vaa = __ldg(g.va + a);
    float acc = 0.f;
    for (int t0 = Tt - 1; t0 >= 0; t0 -= ATT_BATCH) {
      float qv[ATT_BATCH], dv[ATT_BATCH];
#pragma unroll
      for (int u = 0; u < ATT_BATCH; ++u) {
        const size_t tb = (size_t)(t0 - u) * B + b;
        qv[u] = t0 - u >= 0 ? __ldg(g.q + tb * A + a) : 0.f;
        dv[u] = t0 - u >= 0 ? __ldg(g.dsc + tb * T + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < ATT_BATCH; ++u) {
        if (t0 - u >= 0) {
          const float e = tanh_fast(cp + qv[u]);
          acc += dv[u] * vaa * (1.f - e * e);
        }
      }
    }
    g.dctxp[i] = acc;
  }
  const int NC = 9 * g.H + A, CR = g.colsum_rows, NP = (rows + CR - 1) / CR;
  for (int i = gtid; i < NP * NC; i += gstride) {
    const int pb = i / NC, col = i % NC;
    const float* src;
    int ld;
    float* out;
    bias_column(g, col, src, ld, out);
    float acc = 0.f;
    for (int r = pb * CR; r < min(rows, (pb + 1) * CR); ++r)
      acc += __ldg(src + (size_t)r * ld);
    g.colsum[i] = acc;
  }
}

// The bias grads: each column's row blocks added in block order.
__global__ void dec_scan_bwd_colsum_kernel(const BwdArgs g) {
  const int NC = 9 * g.H + g.A, rows = g.Tt * g.B;
  const int NP = (rows + g.colsum_rows - 1) / g.colsum_rows;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= NC) return;
  const float* src;
  int ld;
  float* out;
  bias_column(g, col, src, ld, out);
  float acc = 0.f;
  for (int pb = 0; pb < NP; ++pb) acc += g.colsum[(size_t)pb * NC + col];
  *out = acc;
}

// The readout terms' and the weight grads' grids of streamed tiles
// (dec_scan.cuh's run_jobs).
__global__ void __launch_bounds__(THREADS, 2) dec_scan_bwd_readout_kernel(const Jobs js) {
  run_jobs(js);
}
__global__ void __launch_bounds__(THREADS, 2) dec_scan_bwd_wgrad_kernel(const Jobs js) {
  run_jobs(js);
}

}  // namespace

// Device pointers to contiguous fp32 tensors. Inputs: g, t (Tt, B, R); the
// forward's residuals s (Tt + 1, B, H), st (Tt, B, H), c (Tt, B, C),
// w (Tt, B, T), q (Tt, B, A), hg1, xg2, hg2 (Tt, B, 3H); xg1 (Tt, B, 3H),
// ctx (B, T, C), ctxp (B, T, A), mask (B, T); weights uh1, ua, va, wi2,
// uh2, ws, wc as in dec_scan_fwd_launch. Outputs, all written: dty
// (Tt, B, R), dxg1 (Tt, B, 3H), ds0 (B, H), dctx (B, T, C), dctxp
// (B, T, A), and the weight grads duh1, dbh1, dua, dva, dwi2, dbi2, duh2,
// dbh2, dws, dwc in the weights' shapes. Scratch: ds_ro (Tt, B, H), dc
// (Tt, B, C), dxg2, dhg2, dhg1 (Tt, B, 3H), dq and dva_rows (Tt, B, A), dsc
// (Tt, B, T), dstp, dst, dsp (B, H), colsum (ceil(Tt B / colsum_rows),
// 9H + A). plan: n_plan ints from ops/dec_scan.py's launch_args: the
// grid's CTAs, the attention's parts a row, the scratch region's float
// offset, the dynamic shared memory in bytes, the floats of the weight
// buffer wl2, the rows of a column-sum block, then for each product (dc,
// dst, dstq, ds) ub, nt, rt, nr, col_tiles, cs, cta0, woff, l2off. wl2:
// that many device floats, or null when the plan puts no slice in L2.
// timers: null, or 4 Tt + 2 uint64 for the recurrence's barrier stamps
// (entry, weights loaded and GRU2's first cell backward, the end of each
// step's four phases). bf16 build, after colsum: the forward's bf16 copies
// sb (Tt + 1, B, H), stb (Tt, B, H), cb (Tt, B, C), and bf16 scratch
// dpreb (Tt, B, R), dxg2b, dhg2b, dhg1b (Tt, B, 3H), dqb (Tt, B, A).
// Enqueues six grids: dpre, the readout terms (streamed tiles), the
// recurrence (one cooperative grid), the weight grads and dctx (streamed
// tiles), dctx_proj with the bias grads' row blocks, the bias grads (the
// bf16 build seven: dctx a grid of its own); returns 0, cudaErrorInvalidValue for a
// malformed plan, cudaErrorCooperativeLaunchTooLarge for a grid that is
// not co-resident, or the launch's error.
extern "C" int dec_scan_bwd_launch(
    const void* g_in, const void* t_out, const void* s, const void* st,
    const void* c, const void* w, const void* q, const void* hg1,
    const void* xg2, const void* hg2, const void* xg1, const void* ctx,
    const void* ctxp, const void* mask, const void* uh1, const void* ua,
    const void* va, const void* wi2, const void* uh2, const void* ws,
    const void* wc, void* dty, void* dxg1, void* ds0, void* dctx, void* dctxp,
    void* duh1, void* dbh1, void* dua, void* dva, void* dwi2, void* dbi2,
    void* duh2, void* dbh2, void* dws, void* dwc, void* ds_ro, void* dc,
    void* dxg2, void* dhg2, void* dhg1, void* dq, void* dva_rows, void* dsc,
    void* dstp, void* dst, void* dsp, void* colsum,
#if VAG_SCAN_BF16
    const void* sb, const void* stb, const void* cb, void* dpreb, void* dxg2b,
    void* dhg2b, void* dhg1b, void* dqb,
#endif
    int Tt, int B, int T, int H, int A, int C, int R, const int* plan, int n_plan,
    void* wl2, void* timers, void* stream) {
  if (n_plan != 6 + 4 * 9 || Tt < 1 || B < 1 || T < 1 || H < 1 || A < 1 ||
      C < 1 || R < 1 || plan[4] < 0 || (plan[4] > 0 && wl2 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto X = [](const void* p) { return static_cast<const sx_t*>(p); };
  auto M = [](void* p) { return static_cast<float*>(p); };
  auto MX = [](void* p) { return static_cast<sx_t*>(p); };
  BwdArgs g{};
  g.s = F(s); g.st = F(st); g.c = F(c);
  g.w = F(w); g.q = F(q); g.hg1 = F(hg1); g.xg2 = F(xg2); g.hg2 = F(hg2);
  g.xg1 = X(xg1); g.ctx = X(ctx); g.ctxp = F(ctxp); g.mask = F(mask);
  g.va = F(va);
  g.dty = M(dty); g.dxg1 = MX(dxg1); g.ds0 = M(ds0); g.dctx = MX(dctx);
  g.dctxp = M(dctxp); g.duh1 = MX(duh1); g.dbh1 = M(dbh1); g.dua = MX(dua);
  g.dva = M(dva); g.dwi2 = MX(dwi2); g.dbi2 = M(dbi2); g.duh2 = MX(duh2);
  g.dbh2 = M(dbh2); g.dws = MX(dws); g.dwc = MX(dwc); g.ds_ro = M(ds_ro);
  g.dc = M(dc); g.dxg2 = M(dxg2); g.dhg2 = M(dhg2); g.dhg1 = M(dhg1);
  g.dq = M(dq); g.dva_rows = M(dva_rows); g.dsc = M(dsc); g.dstp = M(dstp);
  g.dst = M(dst); g.dsp = M(dsp); g.colsum = M(colsum);
  g.Tt = Tt; g.B = B; g.T = T; g.H = H; g.A = A; g.C = C; g.R = R;
  g.timers = static_cast<unsigned long long*>(timers);
  g.wl2 = M(wl2);
#if VAG_SCAN_BF16
  g.sb = X(sb); g.stb = X(stb); g.cb = X(cb);
  g.dpreb = MX(dpreb); g.dxg2b = MX(dxg2b); g.dhg2b = MX(dhg2b);
  g.dhg1b = MX(dhg1b); g.dqb = MX(dqb);
#endif
  const int ctas = plan[0], smem_bytes = plan[3];
  g.att_parts = plan[1];
  g.scratch_off = plan[2];
  g.colsum_rows = plan[5];
  const int H3 = 3 * H;
  // (weights read transposed, W's row stride, K, output columns) of dc,
  // dst, dstq, ds
  const sx_t* wts[4] = {X(wi2), X(uh2), X(ua), X(uh1)};
  const int ldw[4] = {H3, H3, A, H3}, K[4] = {H3, H3, A, H3}, cols[4] = {C, H, H, H};
  int scratch_need = att_floats_bwd(T, A, C);   // the attention backward's row
  for (int i = 0; i < 4; ++i) {
    const int* v = plan + 6 + 9 * i;
    g.p[i] = Prod{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], K[i], cols[i],
                  H, wts[i], ldw[i], 1};
    if (!prod_ok(g.p[i], ctas, g.scratch_off, plan[4]) || g.p[i].ub != 0)
      return (int)cudaErrorInvalidValue;
    scratch_need = max(scratch_need, prod_part_floats(g.p[i]));
  }
  if (ctas < 1 || g.att_parts < 1 || g.colsum_rows < 1 || g.scratch_off % 4 != 0 ||
      (long long)4 * (g.scratch_off + scratch_need) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int rows = Tt * B, n = rows * R;
#if VAG_SCAN_BF16
  namespace bt = vag::bt;
  // 1. dpre and its bf16 copy; 2. the readout terms ds_ro = dpre @ ws^T
  // and dc = dpre @ wc^T over all rows on bf16 tiles (dc gains each
  // step's dxg2 @ wi2^T in phase (A))
  dec_scan_bwd_dpre_bf16_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, cs>>>(
      F(g_in), F(t_out), g.dty, g.dpreb, n);
  VAG_CHECK(cudaGetLastError());
  bt::Jobs pre{};
  pre.n = 2;
  for (int i = 0; i < 2; ++i) {
    bt::Job& j = pre.j[i];
    j.nseg = 1;
    j.s[0] = bt::Seg{g.dpreb, X(i ? wc : ws), R, R, R};
    j.tb = 1; j.M = rows; j.N = i ? C : H; j.epi = bt::STORE;
    j.out = i ? g.dc : g.ds_ro; j.ldo = j.N;
  }
  VAG_CHECK(bt::launch(dec_scan_bwd_readout_tiles_kernel, pre, cs));
#else
  // 1. dpre; 2. the readout terms ds_ro = dpre @ ws^T and dc = dpre @ wc^T
  // over all rows (dc gains each step's dxg2 @ wi2^T in phase (A))
  dec_scan_bwd_dpre_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, cs>>>(
      F(g_in), F(t_out), g.dty, n);
  VAG_CHECK(cudaGetLastError());
  Jobs pre{};
  pre.n = 2;
  for (int i = 0; i < 2; ++i) {
    Job& j = pre.j[i];
    j.nseg = 1; j.a[0] = g.dty; j.lda[0] = R; j.kd[0] = R;
    j.b[0] = reinterpret_cast<const float*>(X(i ? wc : ws)); j.ldb[0] = R; j.tb = 1;
    j.M = rows; j.N = i ? C : H; j.out = i ? g.dc : g.ds_ro; j.ldo = j.N;
    j.batch = 1; j.epi = STORE;
  }
  VAG_CHECK(launch_jobs(dec_scan_bwd_readout_kernel, pre, cs));
#endif
  // 3. the recurrence
  void (*kern)(BwdArgs) = plan_general(g.p, 4, plan[4]) ? &dec_scan_bwd_kernel<true>
                                                     : &dec_scan_bwd_kernel<false>;
  const int rc = launch_cooperative(kern, g, ctas, smem_bytes, cs);
  if (rc != 0) return rc;
#if VAG_SCAN_BF16
  // 4. the weight grads over all rows on bf16 tiles of the bf16 copies
  // (bf16 x bf16, summed in fp32, rounded to bf16 once), then dctx[b] =
  // w[:, b]^T dc[:, b] in fp32 products (the JAX package's w * dc), in
  // ctx's type, as streamed 3xTF32 tiles
  bt::Jobs post{};
  post.n = 6;
  const bt::bf16* Xb[6] = {g.cb, g.sb, g.cb, g.stb, g.stb, g.sb + (size_t)B * H};
  const bt::bf16* Yb[6] = {g.dxg2b, g.dhg1b, g.dpreb, g.dhg2b, g.dqb, g.dpreb};
  sx_t* O[6] = {g.dwi2, g.duh1, g.dwc, g.duh2, g.dua, g.dws};
  const int Mx[6] = {C, H, C, H, H, H}, Ny[6] = {H3, H3, R, H3, A, R};
  for (int i = 0; i < 6; ++i) {
    bt::Job& j = post.j[i];
    j.nseg = 1;
    j.s[0] = bt::Seg{Xb[i], Yb[i], Mx[i], Ny[i], rows};
    j.ta = 1; j.M = Mx[i]; j.N = Ny[i]; j.epi = bt::STORE;
    j.outb = O[i]; j.ldo = Ny[i];
  }
  VAG_CHECK(bt::launch(dec_scan_bwd_wgrad_tiles_kernel, post, cs));
  Jobs dj{};
  dj.n = 1;
  Job& d = dj.j[0];
  d.nseg = 1; d.a[0] = g.w; d.lda[0] = B * T; d.kd[0] = Tt; d.ta = 1;
  d.b[0] = g.dc; d.ldb[0] = B * C;
  d.M = T; d.N = C; d.out = reinterpret_cast<float*>(g.dctx); d.ldo = C; d.epi = STORE;
  d.batch = B; d.a_bs = T; d.b_bs = C; d.o_bs = (long long)T * C;
  d.obf = 1;
  VAG_CHECK(launch_jobs(dec_scan_bwd_wgrad_kernel, dj, cs));
#else
  // 4. the weight grads over all rows, and dctx[b] = w[:, b]^T dc[:, b]
  Jobs post{};
  post.n = 7;
  const float* Xa[6] = {g.c, g.s, g.c, g.st, g.st, g.s + (size_t)B * H};
  const float* Y[6] = {g.dxg2, g.dhg1, g.dty, g.dhg2, g.dq, g.dty};
  sx_t* O[6] = {g.dwi2, g.duh1, g.dwc, g.duh2, g.dua, g.dws};
  const int Mx[6] = {C, H, C, H, H, H}, Ny[6] = {H3, H3, R, H3, A, R};
  for (int i = 0; i < 6; ++i) {
    Job& j = post.j[i];
    j.nseg = 1; j.a[0] = Xa[i]; j.lda[0] = Mx[i]; j.kd[0] = rows; j.ta = 1;
    j.b[0] = Y[i]; j.ldb[0] = Ny[i];
    j.M = Mx[i]; j.N = Ny[i]; j.out = reinterpret_cast<float*>(O[i]); j.ldo = Ny[i];
    j.batch = 1; j.epi = STORE;
  }
  // dctx = w^T dc: fp32 products (the JAX package's w * dc), in ctx's type
  Job& d = post.j[6];
  d.nseg = 1; d.a[0] = g.w; d.lda[0] = B * T; d.kd[0] = Tt; d.ta = 1;
  d.b[0] = g.dc; d.ldb[0] = B * C;
  d.M = T; d.N = C; d.out = reinterpret_cast<float*>(g.dctx); d.ldo = C; d.epi = STORE;
  d.batch = B; d.a_bs = T; d.b_bs = C; d.o_bs = (long long)T * C;
  VAG_CHECK(launch_jobs(dec_scan_bwd_wgrad_kernel, post, cs));
#endif
  // 5. dctx_proj and the bias grads' row blocks; 6. the bias grads
  int dev = 0, sms = 0;
  VAG_CHECK(cudaGetDevice(&dev));
  VAG_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  dec_scan_bwd_tail_kernel<<<sms * 4, THREADS, 0, cs>>>(g);
  VAG_CHECK(cudaGetLastError());
  const int NC = 9 * H + A;
  dec_scan_bwd_colsum_kernel<<<(NC + THREADS - 1) / THREADS, THREADS, 0, cs>>>(g);
  VAG_CHECK(cudaGetLastError());
  return 0;
}
