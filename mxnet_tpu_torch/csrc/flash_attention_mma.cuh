// The Hopper instructions the bf16 flash-attention kernels are built from
// (flash_attention_fwd.cu, flash_attention_bwd.cu), as inline PTX for
// sm_90a: asynchronous 16- and 4-byte copies into shared memory
// (cp.async), 8x8 matrix loads from shared memory into mma fragments
// (ldmatrix, plain and transposed), the m16n8k16 bf16 tensor-core product
// with f32 accumulation (mma.sync), and the pack of two f32 values into a
// bf16x2 register.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 registers of two bf16:
//     a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)   a2 (g, 2t+8..)   a3 (g+8, 2t+8..)
//   B (16 x 8, column major), 2 registers: b0 (k 2t..2t+1, n g),
//     b1 (k 2t+8.., n g)
//   C, D (16 x 8, f32), 4 values: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// ldmatrix.x4: lanes 8i..8i+7 give the row addresses of matrix i, and
// register i of lane l holds row l/4, columns 2(l%4)..+1 of matrix i (with
// .trans: rows 2(l%4)..+1 of column l/4).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mxtpu {

// the CTA's dynamic shared memory (the launch's third argument)
template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ __align__(16) unsigned char mxtpu_dyn_smem[];
  return reinterpret_cast<T*>(mxtpu_dyn_smem);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are zero-filled and not read
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes, likewise (src_bytes 0 or 4)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b over one 16 x 8 x 16 step: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (to nearest even), lo in the low half: the
// element of the lower column of an mma fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mxtpu
