// Tensor-core helpers shared by the kernels that run fp32 products as three
// TF32 products (3xTF32) on mma.sync from a cp.async ring in shared memory
// (readout_topk.cu, dec_step.cu): the asynchronous copies, the TF32 split
// of an fp32 operand rounded to nearest with ties away (cvt.rna's rounding,
// done on the bits) and the m16n8k8 product with fp32 accumulators; and,
// for their bf16 instances, the m16n8k16 bf16 product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#if defined(VAG_BF16) && VAG_BF16
#include <cuda_bf16.h>
#endif

namespace vag {

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// TF32 rounding of x, to nearest with ties away from zero (cvt.rna's), on
// the bits: add half of the last kept bit to the magnitude, clear the 13
// dropped ones (two integer operations at full rate; cvt runs at a fraction
// of it).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32: big = rna(x), small = rna(x - big); x - big
// is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

#if defined(VAG_BF16) && VAG_BF16
// The bf16 instances of kernels 1 and 7 (-DVAG_BF16=1): bf16 operands
// staged at 2 bytes, one m16n8k16 product with fp32 accumulators where
// the fp32 builds run 3xTF32. A bf16 value is the high half of its float,
// so every product is exact and only the sums round.

// Two bf16 from anywhere in one register, lo in the low half (a B
// fragment's pair of depths, which are a row apart in a row-major chunk).
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16& lo,
                                              const __nv_bfloat16& hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16_k16(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One bf16 into shared memory where no 4-byte copy fits (rows off a
// 4-byte boundary): a plain load and store, visible to the consumers
// after the __syncthreads that follows the ring's wait.
__device__ __forceinline__ void copy_bf16(__nv_bfloat16* smem,
                                          const __nv_bfloat16* gmem, bool in) {
  *smem = in ? *gmem : __float2bfloat16_rn(0.f);
}
#endif

}  // namespace vag
