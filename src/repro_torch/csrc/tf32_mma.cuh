// Device helpers shared by the tensor-core kernels (sm_90a): cp.async
// staging (16-byte, and 16- or 4-byte with zero fill), the TF32 split of
// a float32 value, and one mma.sync.m16n8k8 TF32 product.
//
// 3xTF32: a float32 operand x is split as hi = tf32_rna(x) and
// lo = tf32_rna(x - hi); a product a*b is taken as a_lo*b_hi + a_hi*b_lo
// + a_hi*b_hi (small terms first) and loses only a_lo*b_lo, about 2^-22
// of |a*b|.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C/D (16 x 8):          c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copies `bytes` (16 or 0) from src and zero-fills the rest of the 16.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Copies `bytes` (4 or 0) from src and zero-fills the rest of the 4.
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(uint32_t raw, uint32_t& hi,
                                           uint32_t& lo) {
  const float v = __uint_as_float(raw);
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// hi = tf32_rna(x) by integer rounding (the same bits as cvt.rna for a
// finite x, in two integer operations instead of a conversion), lo = x - hi
// as raw float32 bits: the tensor core reads only a TF32 operand's top 19
// bits, so lo enters truncated, within 2^-11 of itself.
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
