// Kernel 1b: the fused readout GEMM -> per-row log-sum-exp + top-K of the
// bf16 decode, for Hopper (sm_90a), plain C interface. Built only with
// -DVAG_BF16=1 (readout_topk_bf16, readout_topk_k16_bf16).
//
// Replaces: vag_nmt_tpu/ops/pallas_readout_topk.py, _kernel (entry
// fused_readout_topk) on bf16 t and W (:357-371: the JAX package's bf16
// decode and VAG_FRT_GEMM_DTYPE=bf16), at full slot depth K and in its
// shallow-slot watermark mode (slot depth SK < K). For each of R rows, with
// t (R, E) and W (E, V) bf16, b (V,) and every output fp32:
//   logits = t @ W + b          (bf16 x bf16 products, fp32 sums)
//   banned ids floored to -3e38, vals/idx = the row's top-K (ties to the
//   smaller id), lse = log-sum-exp of the same logits;
// the contract of readout_topk.cu's launch (shallow slots, the per-step
// recovery, passes above 16, vocab slices with id_base and lse_parts),
// which the fp32 builds keep.
//
// Bound on this card: 2 R E V operations at the bf16 tensor rate, 2.62
// GFLOP at R=640, E=256, V=8000: 2.65 us at 989 TFLOP/s; W's 4.1 MB at 3.35
// TB/s, 1.2 us (chip_smoke.py's _readout_bf16_bound).
//
// Design: the grid of readout_topk.cu, (row tiles of BM = 64 rows) x (vocab
// splits of whole BN = 128-column tiles), the splits, tiles and lane map
// ops/readout_topk.py's (-D defines). A CTA is warp-specialised:
//  - a producer warp loads the row tile's t once (kept resident, KC boxes of
//    64 depths; where E is too deep for that, an A box with each stage) and
//    streams W's column tiles by TMA into a STAGES-deep ring of stages of
//    one 64-column box, 64 deep (hopper_mma.cuh), a tile's first half of
//    columns over the whole depth, then its second;
//  - a wgmma warpgroup sums each half's 16-deep steps in ascending depth
//    (m64n64k16) into fp32 accumulators, and hands the tile's logits
//    (without bias) to one of two logits buffers in shared memory;
//  - 16 fold warps fold buffer i while the warpgroup computes tile i + 1
//    (the fold's chains of dependent operations want the warps: 16 fold
//    warps take 0.6 of the time 8 did on an H100). A lane is
//    (split, (col % 64) / 4): a fold thread holds 4 columns of every 64 of
//    its split for RPT = 2 rows and folds, per element in column
//    order: bias, ban floor, online (max, sum-exp), running top-SK
//    (insert<SK>, early reject against the SK-th slot), watermark. The
//    products take no SK, so a depth-K call and a shallow call see the same
//    logits bit for bit; only the fold and the merges are instantiated per
//    SK.
// The merges run on the fold warps, a half-warp a row, with shuffles: the
// lane merge (max and watermark by reduction, sum-exp added in lane order,
// the top-K as K rounds of a tournament of the 16 lanes' heads) writes the
// split's partials; the last CTA of the row tile to take its arrival ticket
// merges the splits the same way, each lane one split of every 16 (all of a
// split's partials loaded at once: one L2 latency a row, not one an
// entry), the sum in split index order (never in arrival order, so results
// repeat bit for bit), lse = M + log(sum s_i exp(m_i - M)), and sets its
// counter back to 0. The counters are ops/topk.py's buffer per (device, stream) or per
// captured graph. Shallow slots, passes and the per-step recovery are
// readout_topk.cu's (see its head): the watermark flags, the keys of a
// pass (the fold's filter at depth, the lane merge's with shallow slots)
// and the rerun of the marked row tiles at depth K.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

#if !defined(VAG_BM) || !defined(VAG_BN) || !defined(VAG_LANE_PERIOD) || \
    !defined(VAG_CPT) || !defined(VAG_MAX_K) || !defined(VAG_STAGES) || !defined(VAG_RESIDENT_KC)
#error "build through vag_nmt_tpu_torch/ops/_build.py (VAG_BM, VAG_BN, VAG_LANE_PERIOD, VAG_CPT, VAG_MAX_K, VAG_STAGES, VAG_RESIDENT_KC)"
#endif

using vag::better;
using vag::insert;
using vag::hm::A_BOX_BYTES;
using vag::hm::BBox;
using vag::hm::BOX_K;
using vag::hm::bf16;

constexpr float FLOOR = -3.0e38f;
constexpr int BM = VAG_BM;             // rows per CTA (64: one wgmma M)
constexpr int BN = VAG_BN;             // columns of a tile (128: two W boxes)
constexpr int LP = VAG_LANE_PERIOD;    // columns of one lane period (64)
constexpr int CPT = VAG_CPT;           // columns of a lane per period (4)
constexpr int MAX_K = VAG_MAX_K;
constexpr int STAGES = VAG_STAGES;     // the W ring
constexpr int FOLD = 512;              // fold threads: warps 0-15
constexpr int MMA0 = FOLD;             // the wgmma warpgroup: warps 16-19
constexpr int PROD0 = FOLD + 128;      // the producer warp: warp 20
constexpr int THREADS = PROD0 + 32;
constexpr int TX = LP / CPT;           // 16 lanes a row a split: a half-warp
constexpr int RPT = BM / (FOLD / TX);  // 2 rows a fold thread
constexpr int HALVES = BN / LP;        // lane periods a tile
constexpr int LS = BN + 4;             // row stride (floats) of a logits buffer
constexpr int W_BOXES = BN / 64;       // a tile's halves, one W box each
constexpr int ACC = 64 / 2;            // accumulators a wgmma thread (m64n64)

static_assert(BM == 64 && BN == 128, "two m64n64 wgmma halves a column tile");
static_assert(CPT == 4 && TX == 16 && LP % CPT == 0 && BN % LP == 0, "lanes: float4 of a period");
static_assert(FOLD % TX == 0 && BM % (FOLD / TX) == 0, "fold: whole rows");

// Shared memory, from a 1024-byte boundary: t resident (kc boxes), the ring,
// two logits buffers, the barriers and the last-CTA flag.
struct Layout {
  int ring, stage, logits, bars, total;
};
__host__ __device__ constexpr Layout layout(int kc, bool resident) {
  Layout l{};
  l.ring = resident ? kc * A_BOX_BYTES : 0;
  l.stage = BBox<64>::BYTES + (resident ? 0 : A_BOX_BYTES);
  l.logits = l.ring + STAGES * l.stage;
  l.bars = l.logits + 2 * BM * LS * (int)sizeof(float);
  l.total = l.bars + (2 * STAGES + 5) * 8 + 16;
  return l;
}
constexpr int SMEM_LIMIT = 232448;     // 227 KB a block
// t's row tile stays resident up to RESIDENT_KC boxes of depth, deeper it
// travels with W's stages. ops/readout_topk.py makes that choice; the
// build holds it to this layout: the deepest resident tile fits, one box
// more would not, and a streamed tile fits at any depth.
constexpr int RESIDENT_KC = VAG_RESIDENT_KC;
static_assert(layout(RESIDENT_KC, true).total + 1024 <= SMEM_LIMIT &&
              layout(RESIDENT_KC + 1, true).total + 1024 > SMEM_LIMIT,
              "VAG_RESIDENT_KC: the deepest resident row tile of t");
static_assert(layout(1, false).total + 1024 <= SMEM_LIMIT, "a streamed t fits");

struct Params {
  const bf16 *t, *w;
  const float* b;
  const uint8_t* ban;
  const uint8_t* live;          // per-step recovery: flagged live rows mark
  uint8_t* tile_mark;           // (row tiles,) recovery marks
  unsigned long long* counts;   // (2,) flagged live rows, recovering calls
  float *part_v, *part_m, *part_s, *part_w;
  int* part_i;
  unsigned int* arrivals;       // (row tiles,) zero between launches
  float *vals, *lse;
  float* lse_parts;             // (R, 2) the row's max and sum of exp(x - max), or null
  int *idx, *viol;
  int R, E, V, K, n_split, split_cols;
  int tma_t, tma_w;             // TMA, or the copy path
  int resident;                 // t's row tile kept in shared memory
  int shallow;                  // SK < K: watermark, viol (and marks)
  int rerun;                    // the recovery's depth-K rerun
  int kout, kofs;               // passes: vals/idx row stride, this pass's first entry
  int id_base;                  // added to the ids written to idx (a vocab slice's v0)
};

__device__ __forceinline__ int id_out(int i, int base) {
  return i == INT_MAX ? INT_MAX : i + base;
}
__device__ __forceinline__ int id_in(int i, int base) {
  return i == INT_MAX ? INT_MAX : i - base;
}

// Drops a sorted list's head, an empty slot entering at the end.
template <int N>
__device__ __forceinline__ void pop(float (&v)[N], int (&i)[N]) {
#pragma unroll
  for (int k = 0; k + 1 < N; ++k) {
    v[k] = v[k + 1];
    i[k] = i[k + 1];
  }
  v[N - 1] = FLOOR;
  i[N - 1] = INT_MAX;
}

// The best of the half-warp's (v, i) by `better`, on every lane of it.
__device__ __forceinline__ void best16(float& v, int& i) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o, TX);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o, TX);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, TX));
  return v;
}
// s += the half-warp's terms in lane order 0..n-1 (n <= 16), on every lane.
__device__ __forceinline__ float add16(float s, float term, int n) {
#pragma unroll
  for (int j = 0; j < TX; ++j) {
    const float x = __shfl_sync(0xffffffffu, term, j, TX);
    if (j < n) s = __fadd_rn(s, x);
  }
  return s;
}

__device__ __forceinline__ void fold_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FOLD) : "memory");
}

// PASS: one pass of K > MAX_K (readout_topk.cu's head): lists MAX_K wide
// (p.K), entries [kofs, kofs + MAX_K) of each row's top-K written at row
// stride kout, only candidates strictly after the row's entry kofs - 1
// taken (in the fold at depth, in the lane merge with shallow slots), the
// flags of the last pass alone.
template <int SK, bool PASS>
__global__ void __launch_bounds__(THREADS, 1)
readout_topk_kernel(const __grid_constant__ CUtensorMap mt,
                    const __grid_constant__ CUtensorMap mw, const Params p) {
  static_assert(1 <= SK && SK <= MAX_K, "slot depth 1..MAX_K");
  using namespace vag::hm;
  const int tid = threadIdx.x;
  const int kout = PASS ? p.kout : p.K, kofs = PASS ? p.kofs : 0;
  const bool filt = PASS && kofs > 0;
  const bool last_pass = !PASS || kofs + p.K >= kout;
  const int tile = blockIdx.x;
  if (p.rerun) {
    if (tile == 0 && blockIdx.y == 0 && tid == 0 && kofs == 0) {
      int any = 0;
      for (int i = 0; i < gridDim.x; ++i) any |= p.tile_mark[i];
      if (any) atomicAdd(&p.counts[1], 1ull);
    }
    if (p.tile_mark[tile] == 0) return;   // every CTA of the row tile
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = vag::hm::align1024(smem_raw);
  const int kc_n = (p.E + BOX_K - 1) / BOX_K;
  const Layout L = layout(kc_n, p.resident);
  uint8_t* ring = smem + L.ring;
  float* logits = reinterpret_cast<float*>(smem + L.logits);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* tfull = empty + STAGES;
  uint64_t* lfull = tfull + 1;   // [2]
  uint64_t* lempty = lfull + 2;  // [2]
  int* last = reinterpret_cast<int*>(lempty + 2);

  const int row0 = tile * BM;
  const int col_begin = blockIdx.y * p.split_cols;
  const int col_end = min(p.V, col_begin + p.split_cols);
  const int n_ct = col_end > col_begin ? (col_end - col_begin + BN - 1) / BN : 0;
  const int n_q = n_ct * W_BOXES * kc_n;   // stages: (tile, half, depth chunk)
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);     // the wgmma warps
    }
    bar_init(tfull, 1);
    for (int i = 0; i < 2; ++i) {
      bar_init(&lfull[i], 4);     // the wgmma warps
      bar_init(&lempty[i], FOLD / 32);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= PROD0) {
    // The producer warp: t's row tile, then W's stages.
    const int lane = tid & 31;
    if (p.resident) {
      if (!p.tma_t)
        for (int kc = 0; kc < kc_n; ++kc)
          copy_box<64>(smem + kc * A_BOX_BYTES, p.t, p.R, p.E, p.E, kc * BOX_K, row0);
      __syncwarp();
      if (lane == 0) {
        bar_expect(tfull, p.tma_t ? kc_n * A_BOX_BYTES : 0);
        if (p.tma_t)
          for (int kc = 0; kc < kc_n; ++kc)
            tma_load(smem + kc * A_BOX_BYTES, &mt, tfull, kc * BOX_K, row0);
      }
    }
    for (int q = 0; q < n_q; ++q) {
      const int s = q % STAGES;
      uint8_t* st = ring + s * L.stage;
      if (q >= STAGES) bar_wait(&empty[s], ((q / STAGES) - 1) & 1);
      const int c0 = col_begin + (q / kc_n) * 64, k0 = (q % kc_n) * BOX_K;
      const bool a_here = !p.resident;
      if (a_here && !p.tma_t)
        copy_box<64>(st + BBox<64>::BYTES, p.t, p.R, p.E, p.E, k0, row0);
      if (!p.tma_w) copy_box<64>(st, p.w, p.E, p.V, p.V, c0, k0);
      __syncwarp();
      if (lane == 0) {
        bar_expect(&full[s], (p.tma_w ? BBox<64>::BYTES : 0) +
                                 (a_here && p.tma_t ? A_BOX_BYTES : 0));
        if (p.tma_w) tma_load(st, &mw, &full[s], c0, k0);
        if (a_here && p.tma_t) tma_load(st + BBox<64>::BYTES, &mt, &full[s], k0, row0);
      }
    }
    return;
  }

  if (tid >= MMA0) {
    // The wgmma warpgroup: a column tile's logits into buffer ct % 2, one
    // 64-column half at a time.
    const int t = tid - MMA0;
    if (p.resident) bar_wait(tfull, 0);
    for (int ct = 0; ct < n_ct; ++ct) {
      const int buf = ct & 1;
      float* lg = logits + buf * BM * LS;
      for (int h = 0; h < W_BOXES; ++h) {
        float d[ACC];
#pragma unroll
        for (int i = 0; i < ACC; ++i) d[i] = 0.f;
        fence_acc(d);
        const int q0 = (ct * W_BOXES + h) * kc_n;
        for (int kc = 0; kc < kc_n; ++kc) {
          const int q = q0 + kc, s = q % STAGES;
          bar_wait(&full[s], (q / STAGES) & 1);
          const uint32_t st = smem_u32(ring + s * L.stage);
          const uint32_t a = p.resident ? smem_u32(smem + kc * A_BOX_BYTES)
                                        : st + BBox<64>::BYTES;
          mma_stage<64, 1>(d, a, st);
          wg_wait<1>();   // stage q - 1's products are done: its stage is free
          if (kc > 0) warp_arrive(&empty[(q - 1) % STAGES]);
        }
        wg_wait<0>();
        fence_acc(d);
        warp_arrive(&empty[(q0 + kc_n - 1) % STAGES]);
        if (h == 0 && ct >= 2) bar_wait(&lempty[buf], ((ct >> 1) - 1) & 1);
#pragma unroll
        for (int i = 0; i < ACC; i += 2)
          *reinterpret_cast<float2*>(&lg[acc_row(t, i) * LS + 64 * h + acc_col(t, i)]) =
              make_float2(d[i], d[i + 1]);
      }
      warp_arrive(&lfull[buf]);
    }
    return;
  }

  // The fold warps: thread (rq, gq) keeps lane gq of rows rq + 32 r.
  const int gq = tid % TX, rq = tid / TX;
  float sv[RPT][SK], m[RPT], s[RPT], wmark[RPT];
  int si[RPT][SK];
  float key_v[RPT];   // PASS: the rows' keys
  int key_i[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (PASS) {
      const int row = min(row0 + rq + r * (FOLD / TX), p.R - 1);
      key_v[r] = filt ? __ldcg(p.vals + (size_t)row * kout + kofs - 1) : 0.f;
      key_i[r] = filt ? id_in(__ldcg(p.idx + (size_t)row * kout + kofs - 1), p.id_base) : 0;
    }
    m[r] = FLOOR;
    s[r] = 0.f;
    wmark[r] = FLOOR;
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      sv[r][k] = FLOOR;
      si[r][k] = INT_MAX;
    }
  }
  for (int ct = 0; ct < n_ct; ++ct) {
    const int buf = ct & 1;
    const int c0 = col_begin + ct * BN;
    float bias[HALVES][CPT];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + h * LP + gq * CPT + j;
        bias[h][j] = col < col_end ? __ldg(p.b + col) : 0.f;
      }
    bar_wait(&lfull[buf], (ct >> 1) & 1);
    const float* lg = logits + buf * BM * LS;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int lr = rq + r * (FOLD / TX);
      const int row = row0 + lr;
      if (row >= p.R) continue;
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const int cl = h * LP + gq * CPT;
        const float4 a4 = *reinterpret_cast<const float4*>(&lg[lr * LS + cl]);
        const float av[CPT] = {a4.x, a4.y, a4.z, a4.w};
        float x[CPT];
        float tmax = FLOOR;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = c0 + cl + j;
          x[j] = FLOOR;
          if (col < col_end) {
            x[j] = __fadd_rn(av[j], bias[h][j]);
            if (p.ban != nullptr && p.ban[(size_t)row * p.V + col]) x[j] = FLOOR;
            tmax = fmaxf(tmax, x[j]);
          }
        }
        const float m_new = fmaxf(m[r], tmax);
        float acc_s = __fmul_rn(s[r], expf(m[r] - m_new));
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = c0 + cl + j;
          if (col < col_end) {
            acc_s = __fadd_rn(acc_s, expf(x[j] - m_new));
            const bool in = !filt || p.shallow || better(key_v[r], key_i[r], x[j], col);
            const float out = in && better(x[j], col, sv[r][SK - 1], si[r][SK - 1])
                                  ? insert<SK>(sv[r], si[r], x[j], col)
                                  : x[j];
            wmark[r] = fmaxf(wmark[r], out);
          }
        }
        m[r] = m_new;
        s[r] = acc_s;
      }
    }
    vag::hm::warp_arrive(&lempty[buf]);
  }

  // The lane merge, a half-warp a row: the split's partials.
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + rq + r * (FOLD / TX);
    const float M = max16(m[r]);
    const float W = max16(wmark[r]);
    const float S = add16(0.f, __fmul_rn(s[r], expf(m[r] - M)), TX);
    if (filt) {   // shallow slots: only candidates strictly after the key
#pragma unroll
      for (int k = 0; k < SK; ++k)
        if (!better(key_v[r], key_i[r], sv[r][0], si[r][0])) pop<SK>(sv[r], si[r]);
    }
    const size_t o = (size_t)blockIdx.y * p.R + row;
    const bool mine = gq == 0 && row < p.R;
    for (int k = 0; k < p.K; ++k) {
      float bv = sv[r][0];
      int bi = si[r][0];
      best16(bv, bi);
      if (sv[r][0] == bv && si[r][0] == bi) pop<SK>(sv[r], si[r]);
      if (mine) {
        p.part_v[o * p.K + k] = bv;
        p.part_i[o * p.K + k] = bi;
      }
    }
    if (mine) {
      p.part_m[o] = M;
      p.part_s[o] = S;
      if (p.shallow) p.part_w[o] = W;
    }
  }
  __threadfence();   // the partials, before the ticket
  fold_sync();
  if (tid == 0)
    *last = atomicAdd(&p.arrivals[tile], 1u) == (unsigned int)(p.n_split - 1);
  fold_sync();
  if (!*last) return;
  __threadfence();

  // The last CTA of the row tile: the splits, a half-warp a row, lane j
  // taking splits j, j + 16, ...; the sums in split index order.
  for (int lr = rq; lr < BM; lr += FOLD / TX) {
    const int row = row0 + lr;
    const bool in = row < p.R;
    float bv[MAX_K];
    int bi[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      bv[k] = FLOOR;
      bi[k] = INT_MAX;
    }
    float M = FLOOR, W = FLOOR;
    float m0 = FLOOR, s0 = 0.f;   // the lane's first split's (max, sum)
    for (int sp = gq; sp < p.n_split && in; sp += TX) {
      const size_t o = (size_t)sp * p.R + row;
      float xv[MAX_K];
      int xi[MAX_K];
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {   // every load in flight at once
        xv[k] = k < p.K ? __ldcg(p.part_v + o * p.K + k) : FLOOR;
        xi[k] = k < p.K ? __ldcg(p.part_i + o * p.K + k) : INT_MAX;
      }
      const float m = __ldcg(p.part_m + o), s = __ldcg(p.part_s + o);
      if (p.shallow) W = fmaxf(W, __ldcg(p.part_w + o));
      if (sp == gq) {
        m0 = m;
        s0 = s;
      }
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (better(xv[k], xi[k], bv[MAX_K - 1], bi[MAX_K - 1]))
          insert<MAX_K>(bv, bi, xv[k], xi[k]);
      M = fmaxf(M, m);
    }
    M = max16(M);
    W = max16(W);
    float S = 0.f;
    for (int sp0 = 0; sp0 < p.n_split; sp0 += TX) {
      const int sp = sp0 + gq;
      const size_t o = (size_t)sp * p.R + row;
      float term = 0.f;
      if (in && sp < p.n_split)
        term = sp0 == 0 ? __fmul_rn(s0, expf(m0 - M))
                        : __fmul_rn(__ldcg(p.part_s + o), expf(__ldcg(p.part_m + o) - M));
      S = add16(S, term, min(TX, p.n_split - sp0));
    }
    const int kk = kout - kofs - 1;   // the row's K-th entry in this pass
    float kv = FLOOR;
    const bool mine = gq == 0 && in;
    for (int k = 0; k < p.K; ++k) {
      float v = bv[0];
      int i = bi[0];
      best16(v, i);
      if (bv[0] == v && bi[0] == i) pop<MAX_K>(bv, bi);
      if (k == kk) kv = v;
      if (mine && kofs + k < kout) {
        p.vals[(size_t)row * kout + kofs + k] = v;
        p.idx[(size_t)row * kout + kofs + k] = id_out(i, p.id_base);
      }
    }
    if (mine) {
      p.lse[row] = M + logf(S);
      if (p.lse_parts != nullptr) {
        p.lse_parts[2 * (size_t)row] = M;
        p.lse_parts[2 * (size_t)row + 1] = S;
      }
      if (p.shallow && last_pass) {
        const int flag = W >= kv ? 1 : 0;
        p.viol[row] = flag;
        if (flag && p.live != nullptr && p.live[row]) {
          p.tile_mark[tile] = 1;
          atomicAdd(&p.counts[0], 1ull);
        }
      }
    }
  }
  if (tid == 0) p.arrivals[tile] = 0;   // ready for the next launch
}

struct Maps {
  CUtensorMap t, w;
};

template <int SK, bool PASS = false>
cudaError_t grid(const Params& p, const Maps& m, cudaStream_t stream) {
  const int kc_n = (p.E + BOX_K - 1) / BOX_K;
  const int smem = layout(kc_n, p.resident).total + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      readout_topk_kernel<SK, PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 g((p.R + BM - 1) / BM, p.n_split);
  readout_topk_kernel<SK, PASS><<<g, THREADS, smem, stream>>>(m.t, m.w, p);
  return cudaGetLastError();
}

cudaError_t grid_sk(const Params& p, const Maps& m, int sk, cudaStream_t stream) {
  switch (sk) {
    case 1: return grid<1>(p, m, stream);
    case 2: return grid<2>(p, m, stream);
    case 3: return grid<3>(p, m, stream);
    case 4: return grid<4>(p, m, stream);
    case 5: return grid<5>(p, m, stream);
    case 6: return grid<6>(p, m, stream);
    case 7: return grid<7>(p, m, stream);
    case 8: return grid<8>(p, m, stream);
#if VAG_MAX_K > 8
    case 9: return grid<9>(p, m, stream);
    case 10: return grid<10>(p, m, stream);
    case 11: return grid<11>(p, m, stream);
    case 12: return grid<12>(p, m, stream);
    case 13: return grid<13>(p, m, stream);
    case 14: return grid<14>(p, m, stream);
    case 15: return grid<15>(p, m, stream);
    case 16: return grid<16>(p, m, stream);
#endif
    default: return cudaErrorInvalidValue;
  }
}

#if VAG_MAX_K > 8
// A pass's grid: slot depth sk with shallow slots, else MAX_K (filtered).
cudaError_t grid_pass(const Params& p, const Maps& m, int sk, cudaStream_t stream) {
  switch (sk) {
    case 1: return grid<1, true>(p, m, stream);
    case 2: return grid<2, true>(p, m, stream);
    case 3: return grid<3, true>(p, m, stream);
    case 4: return grid<4, true>(p, m, stream);
    case 5: return grid<5, true>(p, m, stream);
    case 6: return grid<6, true>(p, m, stream);
    case 7: return grid<7, true>(p, m, stream);
    case 8: return grid<8, true>(p, m, stream);
    case 9: return grid<9, true>(p, m, stream);
    case 10: return grid<10, true>(p, m, stream);
    case 11: return grid<11, true>(p, m, stream);
    case 12: return grid<12, true>(p, m, stream);
    case 13: return grid<13, true>(p, m, stream);
    case 14: return grid<14, true>(p, m, stream);
    case 15: return grid<15, true>(p, m, stream);
    case 16: return grid<16, true>(p, m, stream);
    default: return cudaErrorInvalidValue;
  }
}
#endif

}  // namespace

// readout_topk.cu's readout_topk_launch on bf16 t (R, E) and w (E, V); every
// other argument, and the contract, as there.
extern "C" int readout_topk_launch(const void* t, const void* w, const void* b,
                                   const void* ban, void* part_v, void* part_i,
                                   void* part_m, void* part_s, void* part_w,
                                   void* arrivals, void* vals, void* idx,
                                   void* lse, void* lse_parts, void* viol,
                                   const void* live,
                                   void* tile_mark, void* counts, int R,
                                   int E, int V, int K, int SK, int n_split,
                                   int split_cols, int id_base, void* stream) {
  const bool passes = K > MAX_K;
#if VAG_MAX_K == 8
  if (passes) return (int)cudaErrorInvalidValue;   // the MAX_K = 16 build's
#endif
  if (R < 1 || E < 1 || V < 1 || K < 1 || K > V || SK < 1 || SK > K ||
      (passes && SK < K && SK > MAX_K) || (!passes && K > MAX_K) ||
      split_cols % BN != 0 || (long long)n_split * split_cols < V ||
      (long long)(n_split - 1) * split_cols >= V || arrivals == nullptr)
    return (int)cudaErrorInvalidValue;
  if (SK < K && (part_w == nullptr || viol == nullptr ||
                 (live != nullptr && (tile_mark == nullptr || counts == nullptr))))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.t = static_cast<const bf16*>(t);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.ban = static_cast<const uint8_t*>(ban);
  p.live = SK < K ? static_cast<const uint8_t*>(live) : nullptr;
  p.tile_mark = static_cast<uint8_t*>(tile_mark);
  p.counts = static_cast<unsigned long long*>(counts);
  p.part_v = static_cast<float*>(part_v);
  p.part_i = static_cast<int*>(part_i);
  p.part_m = static_cast<float*>(part_m);
  p.part_s = static_cast<float*>(part_s);
  p.part_w = static_cast<float*>(part_w);
  p.arrivals = static_cast<unsigned int*>(arrivals);
  p.vals = static_cast<float*>(vals);
  p.idx = static_cast<int*>(idx);
  p.lse = static_cast<float*>(lse);
  p.lse_parts = static_cast<float*>(lse_parts);
  p.viol = static_cast<int*>(viol);
  p.R = R;
  p.E = E;
  p.V = V;
  p.K = K;
  p.n_split = n_split;
  p.split_cols = split_cols;
  p.resident = (E + BOX_K - 1) / BOX_K <= RESIDENT_KC;
  p.shallow = SK < K;
  p.rerun = 0;
  p.kout = K;
  p.kofs = 0;
  p.id_base = id_base;
  Maps m;
  bool tt, tw;
  VAG_CHECK(vag::hm::tensor_map(&m.t, &tt, t, R, E, E, 64, BM));
  VAG_CHECK(vag::hm::tensor_map(&m.w, &tw, w, E, V, V, 64, BOX_K));
  p.tma_t = tt;
  p.tma_w = tw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool recover = p.live != nullptr;
  if (recover)
    VAG_CHECK(cudaMemsetAsync(p.tile_mark, 0, (R + BM - 1) / BM, st));
  if (!passes) {
    VAG_CHECK(grid_sk(p, m, SK, st));
    if (recover) {
      Params d = p;              // depth K on the marked row tiles
      d.shallow = 0;
      d.live = nullptr;
      d.rerun = 1;
      VAG_CHECK(grid_sk(d, m, K, st));
    }
    return 0;
  }
#if VAG_MAX_K > 8
  // K > MAX_K: ceil(K / MAX_K) passes (part_v / part_i MAX_K wide), the
  // recovery's rerun in passes at depth too.
  p.K = MAX_K;
  for (int kofs = 0; kofs < K; kofs += MAX_K) {
    p.kofs = kofs;
    VAG_CHECK(grid_pass(p, m, p.shallow ? SK : MAX_K, st));
  }
  if (recover) {
    Params d = p;
    d.shallow = 0;
    d.live = nullptr;
    d.rerun = 1;
    for (int kofs = 0; kofs < K; kofs += MAX_K) {
      d.kofs = kofs;
      VAG_CHECK(grid_pass(d, m, MAX_K, st));
    }
  }
#endif
  return 0;
}

// Two instances (ops/readout_topk.py): MAX_K = 8 for K <= 8, the beam-5
// path's, and MAX_K = 16 for K > 8 (above 16 in passes).
static_assert(MAX_K == 8 || MAX_K == 16, "grid_sk instantiates 1 <= SK <= MAX_K");
