// The Hopper product engine of the bf16 decode's kernels 1b
// (readout_topk_bf16.cu) and 7b (dec_step_bf16.cu): TMA tiled copies into a
// ring of shared-memory stages, one mbarrier per stage and a producer warp,
// and wgmma.mma_async m64nNk16 on bf16 operands from shared memory into
// fp32 accumulators in registers. Built only with -DVAG_BF16=1.
//
// Operands, both row-major bf16 as the port holds them:
//  A (M, K), the activations: K-major boxes of 64 depths (one 128-byte row)
//    x 64 rows, 128-byte swizzle;
//  B (K, N), the weights (in, out) or W: MN-major boxes of BW = 64 or 32
//    columns (one 128- or 64-byte row, 128- or 64-byte swizzle) x 64
//    depths. wgmma reads a 16-bit MN-major B through its transpose bit, so
//    no weight has a transposed copy.
// A tile's B is NB boxes side by side (N = NB * BW): column blocks anywhere
// in B (a gate tile's r, z and n columns of one block of units are three
// boxes H apart). Each 16-deep step is one wgmma over the tile, the steps
// in ascending depth into one fp32 accumulator per output: every product
// of bf16 values exact, only the sums round.
//
// Tensor maps are built on the host for each call (tensor_map, through
// cudaGetDriverEntryPoint: no -lcuda) and passed by value as
// __grid_constant__ parameters, so a captured graph records them and
// nothing per call lives in device memory. TMA needs 16-byte-aligned rows,
// base and box starts (a box at a column off a multiple of 8 faults): an
// operand without them (a width no multiple of 8, a pointer off a 16-byte
// boundary, boxes at such columns) takes the second load path, the producer
// warp's element-wise copies into the same swizzled layout (copy_box),
// fenced to the async proxy before the stage's barrier completes.
// Out-of-range rows, columns and depths read as zero on both paths.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vag {
namespace hm {

typedef __nv_bfloat16 bf16;

constexpr int BOX_K = 64;       // depths of a box: A's row of 128 bytes, B's rows
constexpr int A_BOX_BYTES = BOX_K * 64 * 2;   // 64 rows x 64 depths

template <int BW>
struct BBox {
  static_assert(BW == 64 || BW == 32, "B boxes of 64 (128-byte swizzle) or 32 columns");
  static constexpr int BYTES = BOX_K * BW * 2;
  static constexpr int ROW = BW * 2;                 // bytes of a depth row
  static constexpr int LAYOUT = BW == 64 ? 1 : 2;    // wgmma: 128B / 64B swizzle
};

// ---- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major bf16 matrix (rows, cols) of row stride ld, boxes of
// box_cols x box_rows (box_cols * 2 bytes the swizzle's width). *tma: false
// where TMA cannot take it (rows or base off 16 bytes: the copy path), the
// map then zero. Returns an error where the driver refuses an eligible map.
inline cudaError_t tensor_map(CUtensorMap* m, bool* tma, const void* base, int rows,
                              int cols, int ld, int box_cols, int box_rows) {
  *m = CUtensorMap{};
  *tma = reinterpret_cast<uintptr_t>(base) % 16 == 0 && ((size_t)ld * 2) % 16 == 0 &&
         rows >= 1 && cols >= 1;
  if (!*tma) return cudaSuccess;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                         dim, stride, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: barriers, copies -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The dynamic shared memory from its first 1024-byte boundary (the
// swizzled boxes' alignment; a kernel asks for 1024 bytes more).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
// After the inits, before any thread uses the barriers (then a CTA barrier).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival, and `bytes` more for the phase's copies to complete.
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ bool bar_try(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  while (!bar_try(b, parity)) {
  }
}
// The warp's lanes are done with their shared-memory accesses: lane 0
// arrives for the warp (barriers that count warps).
__device__ __forceinline__ void warp_arrive(uint64_t* b) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(b);
}

// Generic-proxy writes to shared memory, visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// Byte offset of byte `off` of a box under the swizzle of rows of `row`
// bytes (128: 128-byte swizzle, 16-byte chunks XOR the row mod 8; 64:
// 64-byte swizzle, chunks XOR (row / 2) mod 4), as TMA writes it into a
// 1024-byte-aligned stage.
template <int ROW>
__device__ __forceinline__ int swz(int off) {
  return off ^ (((off >> 7) & (ROW == 128 ? 7 : 3)) << 4);
}

// The copy path: box [c0, c0 + bw) x [r0, r0 + 64) of a row-major bf16
// matrix (rows, cols, ld) into dst as TMA would write it, zero outside; by
// the calling warp's 32 lanes, then fenced to the async proxy (the caller
// arrives on the stage's barrier after a __syncwarp).
template <int BW>
__device__ __forceinline__ void copy_box(uint8_t* dst, const bf16* src, int rows, int cols,
                                         int ld, int c0, int r0) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < BOX_K * BW; i += 32) {
    const int r = i / BW, c = i % BW;
    const int gr = r0 + r, gc = c0 + c;
    const bf16 v = gr >= 0 && gr < rows && gc >= 0 && gc < cols
                       ? src[(size_t)gr * ld + gc]
                       : __float2bfloat16_rn(0.f);
    *reinterpret_cast<bf16*>(dst + swz<BW * 2>(r * BW * 2 + c * 2)) = v;
  }
  fence_async_smem();
}

// One box, by TMA (lane 0; counted in the barrier's expected bytes) or by
// the copy path (every lane).
template <int BW>
__device__ __forceinline__ void load_box(bool tma, uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, const bf16* src, int rows,
                                         int cols, int ld, int c0, int r0) {
  if (tma) {
    if ((threadIdx.x & 31) == 0) tma_load(dst, map, bar, c0, r0);
  } else {
    copy_box<BW>(dst, src, rows, cols, ld, c0, r0);
  }
}

// ---- device: wgmma --------------------------------------------------------

// Shared-memory matrix descriptor: start, leading and stride byte offsets,
// swizzle layout (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t start, uint32_t lbo, uint32_t sbo,
                                         uint32_t layout) {
  return (uint64_t)((start & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
// A (K-major, 128-byte swizzle): 8-row groups 1024 bytes apart; depth step
// kk of a box starts 32 bytes further.
__device__ __forceinline__ uint64_t desc_a(uint32_t box, int kk) {
  return desc(box + 32 * kk, 16, 1024, 1);
}
// B (MN-major): boxes of BW columns BBox::BYTES apart (leading), 8-depth
// groups 8 rows apart (stride); depth step kk starts 16 rows further.
template <int BW>
__device__ __forceinline__ uint64_t desc_b(uint32_t box0, int kk) {
  using B = BBox<BW>;
  return desc(box0 + 16 * B::ROW * kk, B::BYTES, 8 * B::ROW, B::LAYOUT);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32, N / 2 a thread) += A (64 x 16) B (16 x N): bf16, A
// K-major and B MN-major (imm-trans-b 1), from shared memory.
template <int N>
struct Mma;

// clang-format off
template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// clang-format on

// One BOX_K-deep stage: four 16-deep steps of A box `a` (64 rows) against
// the NB boxes of B from `b`, each one wgmma over the tile, in ascending
// depth; committed as one group. The warp converges first (.aligned: a
// barrier wait's spin may leave its lanes apart). The caller fences the
// accumulators (fence_acc) before the first stage and after the last wait,
// never between: an instruction that writes them while the products are
// in flight serializes the products.
template <int BW, int NB>
__device__ __forceinline__ void mma_stage(float (&d)[BW * NB / 2], uint32_t a, uint32_t b) {
  __syncwarp();
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BOX_K / 16; ++kk) Mma<BW * NB>::run(d, desc_a(a, kk), desc_b<BW>(b, kk));
  wg_commit();
}

// The accumulator fragment of m64nNk16: element i of thread t (of the
// warpgroup) is row 16 (t / 32) + (t % 32) / 4 + 8 ((i % 4) / 2) and
// column 8 (i / 4) + 2 (t % 4) + i % 2 of the tile.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i & 3) >> 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

}  // namespace hm
}  // namespace vag
