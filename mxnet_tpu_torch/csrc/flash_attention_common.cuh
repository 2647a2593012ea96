// Device functions shared by the flash-attention forward and backward
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu): the dropout
// keep mask, the quad reductions, and the tile machinery of the
// bf16 tensor-core kernels (swizzled shared-memory tiles, their loads and
// stores, and the two warp-level products built on mma.sync). The backward
// regenerates the forward's mask from the same function, so the two cannot
// drift.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_mma.cuh"

namespace mxtpu {

constexpr int kLanesPerRow = 4;  // threads sharing one query (or key) row
constexpr float kLog2e = 1.4426950408889634f;  // the tensor-core kernels
constexpr float kLn2 = 0.6931471805599453f;    // take exp in base 2

// a bf16 given by its bits, as f32 (exact)
__device__ __forceinline__ float bf16_bits(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
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

// ---------------------------------------------------------------------------
// bf16 tiles for the tensor-core kernels. A tile holds ROWS rows of the
// head dim padded to C 16-byte chunks (8 bf16 each), zero past S and D, as
// raw bf16 bits. Chunk c of row r sits at chunk swz<C>(r, c): XOR-swizzled
// so that the 8 row addresses of one ldmatrix (8 rows, one logical chunk)
// fall in 8 different 16-byte bank groups, with no padding.

template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(C == 4 || C % 8 == 0, "head dim padded to 32, 64 or 128");
  // 128-byte rows and wider: the row's low 3 bits; 64-byte rows (two rows
  // per 128 bytes): bits 1-2 of the row
  return r * C + (C == 4 ? (c ^ ((r >> 1) & 3)) : (c ^ (r & 7)));
}

// True when every row of every (B, H, S, D) operand starts on 16 bytes and
// D is a multiple of 8: the tiles then move as 16-byte cp.async copies and
// 16-byte stores; otherwise as 2-byte loads and stores (same kernel, the
// ALIGNED template flag). ptrs: n base pointers; strides: 3 element
// strides (batch, head, seq) of each, in the same order.
inline bool tiles_aligned(const void* const* ptrs, const long long* strides,
                          int n, int D) {
  if (D % 8) return false;
  for (int i = 0; i < n; ++i) {
    if (ptrs[i] && (reinterpret_cast<uintptr_t>(ptrs[i]) & 15)) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 8) return false;
  }
  return true;
}

// rows [r0, r0 + ROWS) of an (S, D) bf16 matrix with row stride ld
// (elements) into a tile, by the NT threads of the CTA. ALIGNED: cp.async
// (the caller commits and waits); else plain loads, done on return.
template <int ROWS, int C, bool ALIGNED, int NT>
__device__ __forceinline__ void load_tile(uint16_t* tile,
                                          const uint16_t* src, long long ld,
                                          int r0, int S, int D) {
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int row = r0 + r;
    uint16_t* dst = tile + swz<C>(r, c) * 8;
    if constexpr (ALIGNED) {
      const bool ok = row < S && c * 8 < D;
      cp_async_16(dst, ok ? src + row * ld + c * 8 : src, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 8 + 2 * e;
        const uint32_t lo =
            (row < S && d < D) ? src[row * ld + d] : 0u;
        const uint32_t hi =
            (row < S && d + 1 < D) ? src[row * ld + d + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// N f32 values v[i0 ..] into dst by cp.async, zero past S (the caller
// commits and waits)
template <int N, int NT>
__device__ __forceinline__ void load_row_values(float* dst, const float* v,
                                                int i0, int S) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const bool ok = i0 + i < S;
    cp_async_4(dst + i, ok ? v + i0 + i : v, ok ? 4 : 0);
  }
}

// a tile's rows [0, ROWS) to rows [r0, r0 + ROWS) of an (S, D) bf16 matrix,
// by the NT threads of the CTA (the tile is complete: the caller synced)
template <int ROWS, int C, bool ALIGNED, int NT>
__device__ __forceinline__ void store_tile(const uint16_t* tile,
                                           uint16_t* dst, long long ld,
                                           int r0, int S, int D) {
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int row = r0 + r;
    if (row >= S || c * 8 >= D) continue;
    const uint16_t* src = tile + swz<C>(r, c) * 8;
    if constexpr (ALIGNED) {
      *reinterpret_cast<uint4*>(dst + row * ld + c * 8) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < D; ++e)
        dst[row * ld + c * 8 + e] = src[e];
    }
  }
}

// A fragments of the 16 tile rows from r0 at k-step ks (head-dim columns
// 16 ks .. 16 ks + 15), by one warp
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile,
                                       int r0, int ks, int lane) {
  ldmatrix_x4(a, tile + swz<C>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                2 * ks + (lane >> 4)) * 8);
}

// s += A B^T by one warp: A (16 x 8C) given as the fragments of every
// k-step, B the tile's NB 8-row blocks (rows n, the head dim as k): the
// product of 16 query rows with NB * 8 keys (q k^T), and its kin
template <int C, int NB>
__device__ __forceinline__ void mma_abt(float (&s)[NB][4],
                                        uint32_t (&a)[C / 2][4],
                                        const uint16_t* b, int lane) {
#pragma unroll
  for (int kp = 0; kp < C / 4; ++kp) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t f[4];  // b0, b1 of k-steps 2 kp and 2 kp + 1
      ldmatrix_x4(f, b + swz<C>(nb * 8 + (lane & 7), 4 * kp + (lane >> 3)) *
                             8);
      mma_bf16(s[nb], a[2 * kp], f[0], f[1]);
      mma_bf16(s[nb], a[2 * kp + 1], f[2], f[3]);
    }
  }
}

// the same with A read from its tile (rows a_r0 ..) one k-step pair at a
// time, for head dims whose fragments would not fit in registers
template <int C, int NB>
__device__ __forceinline__ void mma_abt(float (&s)[NB][4],
                                        const uint16_t* a_tile, int a_r0,
                                        const uint16_t* b, int lane) {
#pragma unroll
  for (int kp = 0; kp < C / 4; ++kp) {
    uint32_t a0[4], a1[4];
    load_a<C>(a0, a_tile, a_r0, 2 * kp, lane);
    load_a<C>(a1, a_tile, a_r0, 2 * kp + 1, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t f[4];
      ldmatrix_x4(f, b + swz<C>(nb * 8 + (lane & 7), 4 * kp + (lane >> 3)) *
                             8);
      mma_bf16(s[nb], a0, f[0], f[1]);
      mma_bf16(s[nb], a1, f[2], f[3]);
    }
  }
}

// o += P V by one warp: P (16 x 8NB) in the accumulator layout of mma_abt,
// rounded to bf16 here and used in registers as the A operand; V the
// tile's first 8NB rows (k) by its head dim (n), read with ldmatrix.trans
template <int C, int NB>
__device__ __forceinline__ void mma_pv(float (&o)[C][4], float (&p)[NB][4],
                                       const uint16_t* v, int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < C / 2; ++np) {
      uint32_t f[4];  // b0, b1 of head-dim blocks 2 np and 2 np + 1
      ldmatrix_x4_trans(
          f, v + swz<C>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        2 * np + (lane >> 4)) * 8);
      mma_bf16(o[2 * np], a, f[0], f[1]);
      mma_bf16(o[2 * np + 1], a, f[2], f[3]);
    }
  }
}

// a warp's 16 x 8C accumulator (rows r0 + lane/4 and + 8) into a tile as
// bf16, rows divided by div_lo and div_hi
template <int C>
__device__ __forceinline__ void stage_acc(uint16_t* tile, float (&o)[C][4],
                                          int r0, int lane, float div_lo,
                                          float div_hi) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < C; ++nd) {
    *reinterpret_cast<uint32_t*>(tile + swz<C>(r0 + g, nd) * 8 + 2 * t) =
        pack_bf16(o[nd][0] / div_lo, o[nd][1] / div_lo);
    *reinterpret_cast<uint32_t*>(tile + swz<C>(r0 + g + 8, nd) * 8 + 2 * t) =
        pack_bf16(o[nd][2] / div_hi, o[nd][3] / div_hi);
  }
}

// max and sum over the four lanes of a quad (the lanes that share a row of
// an mma accumulator)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace mxtpu
