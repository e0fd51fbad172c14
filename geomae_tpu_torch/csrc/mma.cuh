// Tensor-core helpers of the bf16 kernels: warp-level mma.sync
// m16n8k16 and m16n8k8 (bf16 in, f32 accumulate), ldmatrix fragment loads
// from shared memory, and 16-, 8- and 4-byte cp.async copies from device
// memory.
//
// Fragments of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A [16 x 16], row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g,
//     2t+8..), a3 (g+8, 2t+8..);
//   B [16 x 8] (k x n): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C [16 x 8]: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// Of m16n8k8 (a contraction over 8): A [16 x 8] a0 (g, 2t..2t+1), a1
// (g+8, 2t..); B [8 x 8] b0 (k 2t..2t+1, n g); C as above.
// ldmatrix_x4 loads four 8 x 8 bf16 matrices whose rows lanes 0-7, 8-15,
// 16-23 and 24-31 address; register i holds row g, columns 2t..2t+1 of
// matrix i (with .trans: of matrix i transposed).  ldmatrix_x2 loads the
// first two, whose rows lanes 0-7 and 8-15 address.
//
// Shared-memory tiles are bf16 rows padded by 8 elements (16 bytes): with
// a row stride of 72, 136 or 264 elements the 8 rows an ldmatrix phase
// reads start 4 banks apart and hit 32 distinct banks; at 40, 56 or 104
// (heads of 32, 48 and 96) they start 20, 28 or 20 banks apart, also 8
// distinct groups of four.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace geomae {

constexpr int kPad = 8;   // bf16 elements of padding per shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b, one m16n8k16 product with an f32 accumulator
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, one m16n8k8 product with an f32 accumulator
__device__ __forceinline__ void mma_bf16_1688(float (&d)[4],
                                              const uint32_t (&a)[2],
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 16 bytes from device memory to shared memory, bypassing L1; with
// valid false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes from device memory to shared memory, through L1 (.cg copies
// 16 bytes only), both addresses 8-byte aligned: the heads of 12 bf16
// channels, which start 24 bytes apart; with valid false nothing is read
// and the 8 bytes are zero-filled
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes from device memory to shared memory, through L1, both
// addresses 4-byte aligned: the heads of 6 and 2 bf16 channels, which
// start 12 and 4 bytes apart; with valid false nothing is read and the 4
// bytes are zero-filled
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two f32 values as one register of two bf16 (lo in the low half), and back
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

}  // namespace geomae
