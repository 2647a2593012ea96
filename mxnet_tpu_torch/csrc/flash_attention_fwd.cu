// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by mxnet_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _flash_fwd, pl.pallas_call at :195). Same contract:
//   out = softmax(q k^T * scale) v  over (B, H, S, D), optional causal mask,
//   lse = m + log(l) per query row (-inf for a fully masked row),
//   dropout masks the numerator only (inverted scaling in the output
//   division, lse un-dropped), with the bit-exact murmur3-finalizer counter
//   hash _dropout_keep over (seed, b*H+h, q_pos, k_pos), the seed read
//   from device memory at kernel start (a replayed CUDA graph then takes
//   each step's seed, which a captured op advances on the card),
//   denominator max(l, 1e-30), P rounded to v's dtype before the PV product,
//   f32 accumulation, out in q's dtype, lse in f32.
//
// Bound on this card: at serving shape (B 8, H 12, S 384, D 64, bf16) the
// two products are 4*B*H*S^2*D = 3.6 GFLOP (3.7 us at 989 TFLOP/s on the
// tensor cores) and q, k, v, out move 18.9 MB (5.6 us at 3.35 TB/s): the
// kernel is bound by bytes, and the design keeps the (S, S) score matrix
// out of device memory, reading q once and k, v once per 64-row q block.
//
// Two variants, chosen by dtype (the wrapper counts each):
//
// bf16, flash_fwd_mma_kernel (FlashAttention-2 on the tensor cores): one
// CTA of 4 warps per (b*H + h, 64-row q block); each warp owns 16 query
// rows. Q is staged once in shared memory and read as mma A fragments by
// ldmatrix. 64-key K and V tiles stay bf16 in XOR-swizzled shared memory
// and arrive by 16-byte cp.async copies in a 2-stage ring, so the next
// tile's load overlaps this tile's products. S = Q K^T by
// mma.sync.m16n8k16 (bf16 in, f32 accumulate); the online softmax runs on
// the accumulator fragments in base 2 (one multiply, one add and one EX2 a
// score; row max and sum over the 4 lanes of a quad; l sums the unrounded
// f32 p), with masks only in a tile at an edge (ragged S, the causal
// diagonal); the dropout hash is computed per fragment element from its
// (q_pos, k_pos); P, rounded to bf16, is reused in registers as the A
// operand of P V, with V's B fragments from ldmatrix.trans. The output
// tile is staged through shared memory and leaves as 16-byte stores. The
// head dim is padded (zero-filled, in shared memory only) to 32, 64 or 128.
// Rows that do not start on 16 bytes, or D not a multiple of 8, take
// 2-byte loads and stores in the same kernel (the ALIGNED flag). 64 x 64
// tiles: at S 384, B*H 96 the grid is 576 CTAs of 40 KB of shared memory
// (D 64); held to 102 registers (5 CTAs an SM) it runs as one wave. Holding
// Q's fragments in registers instead cost an occupancy step and time
// (PERF.md).
//
// f32, flash_fwd_kernel (TF32 would keep about 3 digits, above the f32
// tolerance of 1e-4): one CTA of 256 threads per (b*H + h, 64-row q block);
// four neighbouring lanes own one query row and each holds a quarter of
// its q and output accumulator in registers; a score is the sum of the
// four partial dot products (two xor shuffles). 32-key K/V tiles staged in
// shared memory as f32; FP32 FMAs.
#include "flash_attention_common.cuh"

namespace {

using namespace mxtpu;

constexpr int kBlockQ = 64;                  // query rows per CTA
constexpr int kBlockK = 32;                  // keys per shared-memory tile
constexpr int kThreads = kBlockQ * kLanesPerRow;

// element strides of (batch, head, seq) for q, k, v, out; head dim stride 1
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// DQ: head-dim elements per lane (the head dim padded to 4*DQ)
template <int DQ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int S, int D,
                     Strides st, float scale, int causal, int dropout,
                     float keep_prob,
                     const uint32_t* __restrict__ seed_p, uint32_t thresh) {
  // the dropout seed, read on the card (a graph replay takes its value)
  const uint32_t seed = dropout ? *seed_p : 0u;
  constexpr int kDP = kLanesPerRow * DQ;  // padded head dim
  constexpr int kLD = DQ + 4;  // padded quarter row (16-byte aligned)
  __shared__ __align__(16) float ks[kBlockK][kLanesPerRow][kLD];
  __shared__ __align__(16) float vs[kBlockK][kLanesPerRow][kLD];

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const int q_pos = q0 + row;
  const bool row_live = q_pos < S;

  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];

  float qr[DQ];
  float acc[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    qr[c] = (row_live && d < D) ? qb[q_pos * st.q[2] + d] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // causal: key tiles past this q block's last row see an all-zero P
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    for (int i = tid; i < kBlockK * kDP; i += kThreads) {
      const int j = i / kDP;
      const int d = i % kDP;
      const int k_pos = k0 + j;
      const bool ok = k_pos < S && d < D;
      ks[j][d / DQ][d % DQ] = ok ? kb[k_pos * st.k[2] + d] : 0.f;
      vs[j][d / DQ][d % DQ] = ok ? vb[k_pos * st.v[2] + d] : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float m_cur = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][sub][0]);
      float part = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < DQ / 4; ++c4) {
        const float4 kv = kr[c4];
        part = fmaf(qr[4 * c4 + 0], kv.x, part);
        part = fmaf(qr[4 * c4 + 1], kv.y, part);
        part = fmaf(qr[4 * c4 + 2], kv.z, part);
        part = fmaf(qr[4 * c4 + 3], kv.w, part);
      }
      float sv = row_sum(part) * scale;
      const int k_pos = k0 + j;
      if (k_pos >= S || (causal && k_pos > q_pos)) sv = -INFINITY;
      s[j] = sv;
      m_cur = fmaxf(m_cur, sv);
    }

    const float m_new = fmaxf(m, m_cur);
    const bool live = isfinite(m_new);  // guard fully masked rows
    const float m_safe = live ? m_new : 0.f;
    const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = live ? expf(s[j] - m_safe) : 0.f;
      p_sum += p;
      float p_v = p;
      if (dropout && !dropout_keep(seed, (uint32_t)bh, (uint32_t)q_pos,
                                   (uint32_t)(k0 + j), thresh))
        p_v = 0.f;
      s[j] = p_v;
    }
    l = alpha * l + p_sum;
    m = m_new;

#pragma unroll
    for (int c = 0; c < DQ; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][sub][0]);
#pragma unroll
      for (int c4 = 0; c4 < DQ / 4; ++c4) {
        const float4 vv = vr[c4];
        acc[4 * c4 + 0] = fmaf(s[j], vv.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(s[j], vv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(s[j], vv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(s[j], vv.w, acc[4 * c4 + 3]);
      }
    }
    __syncthreads();  // the tile is reloaded next iteration
  }

  if (!row_live) return;
  const float denom = fmaxf(l, 1e-30f);
  const float o_denom = dropout ? denom * keep_prob : denom;
  float* ob = out + b * st.o[0] + h * st.o[1] + q_pos * st.o[2];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    if (d < D) ob[d] = acc[c] / o_denom;
  }
  if (sub == 0)
    lse[(long long)bh * S + q_pos] = isfinite(m) ? m + logf(denom) : -INFINITY;
}

constexpr int kMmaWarps = 4;  // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per CTA
constexpr int kMmaKeys = 64;              // keys per K/V tile

// bf16 tensor-core forward. C: 16-byte chunks of the padded head dim.
// Up to head dim 64, 5 CTAs an SM (<= 102 registers): the serving grid of
// 576 CTAs then runs as one wave.
template <int C, bool ALIGNED>
__global__ void __launch_bounds__(kMmaThreads, C <= 8 ? 5 : 1)
    flash_fwd_mma_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         uint16_t* __restrict__ out, float* __restrict__ lse,
                         int H, int S, int D, Strides st, float scale,
                         int causal, int dropout, float keep_prob,
                         const uint32_t* __restrict__ seed_p, uint32_t thresh) {
  // the dropout seed, read on the card (a graph replay takes its value)
  const uint32_t seed = dropout ? *seed_p : 0u;
  constexpr int NB = kMmaKeys / 8;         // 8-key blocks of a tile
  constexpr int kTile = kMmaKeys * C * 8;  // elements of a K or V tile
  uint16_t* qs = dyn_smem<uint16_t>();     // Q, then the output tile
  uint16_t* ks = qs + kMmaRows * C * 8;    // K ring, 2 stages
  uint16_t* vs = ks + 2 * kTile;           // V ring, 2 stages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kMmaRows;
  const uint16_t* qb = q + b * st.q[0] + h * st.q[1];
  const uint16_t* kb = k + b * st.k[0] + h * st.k[1];
  const uint16_t* vb = v + b * st.v[0] + h * st.v[1];

  // causal: key tiles past this q block's last row see an all-zero P
  const int k_end = causal ? min(S, q0 + kMmaRows) : S;
  const int n_tiles = (k_end + kMmaKeys - 1) / kMmaKeys;

  load_tile<kMmaRows, C, ALIGNED, kMmaThreads>(qs, qb, st.q[2], q0, S, D);
  load_tile<kMmaKeys, C, ALIGNED, kMmaThreads>(ks, kb, st.k[2], 0, S, D);
  load_tile<kMmaKeys, C, ALIGNED, kMmaThreads>(vs, vb, st.v[2], 0, S, D);
  cp_async_commit();

  float o[C][4];  // output accumulator, rows g and g + 8
#pragma unroll
  for (int nd = 0; nd < C; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max, base-2 units
  float l[2] = {0.f, 0.f};
  const int row = q0 + warp * 16 + g;  // q_pos of rows g; g + 8 is row + 8
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // the next tile flies while this one computes
      const int nxt = (stage ^ 1) * kTile;
      load_tile<kMmaKeys, C, ALIGNED, kMmaThreads>(
          ks + nxt, kb, st.k[2], (t + 1) * kMmaKeys, S, D);
      load_tile<kMmaKeys, C, ALIGNED, kMmaThreads>(
          vs + nxt, vb, st.v[2], (t + 1) * kMmaKeys, S, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    mma_abt<C, NB>(s, qs, warp * 16, ks + stage * kTile, lane);  // Q K^T

    // scores in base-2 units, y = x scale log2(e), so that p = 2^(y - m)
    // is one add and one EX2; masked (-inf) only in a tile at an edge
    // (ragged S, the causal diagonal). Element e of block nb: row
    // row + 8 (e / 2), key k0 + 8 nb + 2 t4 + e % 2
    const int k0 = t * kMmaKeys;
    const bool edge =
        k0 + kMmaKeys > S || (causal && k0 + kMmaKeys - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = s[nb][e] * sl2;
        if (edge) {
          const int qp = row + 8 * (e >> 1);
          const int kp = k0 + nb * 8 + 2 * t4 + (e & 1);
          if (kp >= S || (causal && kp > qp)) y = -INFINITY;
        }
        s[nb][e] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }
    }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // a row masked so far keeps y = -inf, so p = 0 with m_safe = 0
      m_safe[r] = isfinite(m_new) ? m_new : 0.f;
      alpha[r] = isfinite(m[r]) ? exp2f(m[r] - m_safe[r]) : 0.f;
      m[r] = m_new;
    }
    float p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(s[nb][e] - m_safe[r]);
        p_sum[r] += p;  // l sums the unrounded, un-dropped p
        const bool keep =
            !dropout || dropout_keep(seed, (uint32_t)bh,
                                     (uint32_t)(row + 8 * r),
                                     (uint32_t)(k0 + nb * 8 + 2 * t4 +
                                                (e & 1)),
                                     thresh);
        s[nb][e] = keep ? p : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + row_sum(p_sum[r]);
#pragma unroll
    for (int nd = 0; nd < C; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
    mma_pv<C, NB>(o, s, vs + stage * kTile, lane);  // P in v's dtype
    __syncthreads();  // this stage is refilled two tiles on
  }

  // epilogue: O / denominator through shared memory (Q's tile is free)
  float denom[2], o_denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    denom[r] = fmaxf(l[r], 1e-30f);
    o_denom[r] = dropout ? denom[r] * keep_prob : denom[r];
  }
  stage_acc<C>(qs, o, warp * 16, lane, o_denom[0], o_denom[1]);
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row + 8 * r;
      if (qp < S)
        lse[(long long)bh * S + qp] =
            isfinite(m[r]) ? m[r] * kLn2 + logf(denom[r]) : -INFINITY;
    }
  }
  __syncthreads();
  store_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      qs, out + b * st.o[0] + h * st.o[1], st.o[2], q0, S, D);
}

template <int C, bool ALIGNED>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int S, int D, const Strides& st,
               float scale, int causal, int dropout, float keep_prob,
               const uint32_t* seed, uint32_t thresh, cudaStream_t stream) {
  // Q (the output tile after) and two stages each of K and V
  constexpr int kSmem = (kMmaRows + 4 * kMmaKeys) * C * 16;
  auto kernel = flash_fwd_mma_kernel<C, ALIGNED>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kMmaRows - 1) / kMmaRows, B * H);
  kernel<<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), lse, H,
      S, D, st, scale, causal, dropout, keep_prob, seed, thresh);
  return (int)cudaGetLastError();
}

template <bool ALIGNED>
int launch_mma_d(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int H, int S, int D, const Strides& st,
                 float scale, int causal, int dropout, float keep_prob,
                 const uint32_t* seed, uint32_t thresh, cudaStream_t stream) {
  if (D <= 32)
    return launch_mma<4, ALIGNED>(q, k, v, out, lse, B, H, S, D, st, scale,
                                  causal, dropout, keep_prob, seed, thresh,
                                  stream);
  if (D <= 64)
    return launch_mma<8, ALIGNED>(q, k, v, out, lse, B, H, S, D, st, scale,
                                  causal, dropout, keep_prob, seed, thresh,
                                  stream);
  return launch_mma<16, ALIGNED>(q, k, v, out, lse, B, H, S, D, st, scale,
                                 causal, dropout, keep_prob, seed, thresh,
                                 stream);
}

template <int DQ>
void launch(const void* q, const void* k, const void* v, void* out,
            float* lse, int B, int H, int S, int D, const Strides& st,
            float scale, int causal, int dropout, float keep_prob,
            const uint32_t* seed, uint32_t thresh, cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<DQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, S, D, st,
      scale, causal, dropout, keep_prob, seed, thresh);
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int S, int D, const Strides& st,
               float scale, int causal, int dropout, float keep_prob,
               const uint32_t* seed, uint32_t thresh, cudaStream_t stream) {
  if (D <= 32)
    launch<8>(q, k, v, out, lse, B, H, S, D, st, scale, causal,
                     dropout, keep_prob, seed, thresh, stream);
  else if (D <= 64)
    launch<16>(q, k, v, out, lse, B, H, S, D, st, scale, causal,
                      dropout, keep_prob, seed, thresh, stream);
  else
    launch<32>(q, k, v, out, lse, B, H, S, D, st, scale, causal,
                      dropout, keep_prob, seed, thresh, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FP32 kernel), 1 = bfloat16 (the tensor-core
// kernel). strides: 12 element strides, (batch, head, seq) of q, k, v, out
// in that order. lse: (B, H, S) float32, contiguous. Returns the
// cudaError_t of the launch (0 on success).
int mxtpu_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int dtype, int B, int H,
                              int S, int D, const long long* strides,
                              float scale, int causal, int dropout,
                              float keep_prob, const unsigned int* seed,
                              unsigned int thresh, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > 128 || B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_f32(q, k, v, out, l, B, H, S, D, st, scale, causal,
                      dropout, keep_prob, seed, thresh, s);
  const void* ptrs[4] = {q, k, v, out};
  if (tiles_aligned(ptrs, strides, 4, D))
    return launch_mma_d<true>(q, k, v, out, l, B, H, S, D, st, scale, causal,
                              dropout, keep_prob, seed, thresh, s);
  return launch_mma_d<false>(q, k, v, out, l, B, H, S, D, st, scale, causal,
                             dropout, keep_prob, seed, thresh, s);
}

// 1 when the bf16 launchers (forward and backward alike) stage the tiles of
// these n operands with 16-byte copies, 0 for 2-byte loads: the rule they
// apply themselves (tiles_aligned), so that a caller can ask which staging
// a call takes. strides: 3 per operand, as tiles_aligned takes them.
int mxtpu_flash_attention_tiles_aligned(const void* const* ptrs,
                                        const long long* strides, int n,
                                        int D) {
  return tiles_aligned(ptrs, strides, n, D) ? 1 : 0;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
