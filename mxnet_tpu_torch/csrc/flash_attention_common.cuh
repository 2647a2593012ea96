// Device functions shared by the flash-attention forward and backward
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu): dtype
// conversion and the dropout keep mask. The backward regenerates the
// forward's mask from the same function, so the two cannot drift.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mxtpu {

constexpr int kLanesPerRow = 4;  // threads sharing one query (or key) row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T and back: the value a product in T's dtype would see
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// pallas_attention.py:_dropout_keep, uint32 arithmetic wrapping mod 2^32
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             uint32_t q_pos, uint32_t k_pos,
                                             uint32_t thresh) {
  uint32_t h = q_pos * 0x9E3779B1u + k_pos * 0x85EBCA6Bu + seed +
               bh * 0xC2B2AE35u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h <= thresh;
}

// sum of the four lanes that share a row (all four end with the same bits)
__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

}  // namespace mxtpu
