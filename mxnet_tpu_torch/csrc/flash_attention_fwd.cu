// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by mxnet_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _flash_fwd, pl.pallas_call at :195). Same contract:
//   out = softmax(q k^T * scale) v  over (B, H, S, D), optional causal mask,
//   lse = m + log(l) per query row (-inf for a fully masked row),
//   dropout masks the numerator only (inverted scaling in the output
//   division, lse un-dropped), with the bit-exact murmur3-finalizer counter
//   hash _dropout_keep over (seed, b*H+h, q_pos, k_pos),
//   denominator max(l, 1e-30), P rounded to v's dtype before the PV product,
//   f32 accumulation, out in q's dtype, lse in f32.
//
// Bound on this card: at serving shape (B 8, H 12, S 384, D 64, bf16) the
// two products are 4*B*H*S^2*D = 3.6 GFLOP (3.7 us at 989 TFLOP/s on the
// tensor cores) and q, k, v, out move 18.9 MB (5.6 us at 3.35 TB/s): the
// kernel is bound by bytes, and the design keeps the (S, S) score matrix
// out of device memory, reading q once and k, v once per 64-row q block.
//
// Design (simple and correct first): one CTA of 256 threads per (b*H + h,
// 64-row q block). Four neighbouring lanes own one query row; each holds a
// quarter of the row's q and of its output accumulator in registers, and a
// score is the sum of the four partial dot products (two xor shuffles, so
// all four lanes hold bit-identical scores and softmax state). A loop over
// 32-key K/V tiles staged in shared memory takes the place of the TPU's
// sequential third grid axis; the online-softmax m, l and the accumulator
// stay in f32 registers. Shared rows are padded so that the four lanes of a
// row group read four different bank groups with 16-byte loads. The ragged
// ends of S and of D are masked in the kernel, so nothing is padded in
// device memory. Tensor cores (mma.sync / wgmma), TMA and a tuned tile
// shape are later work.
#include "flash_attention_common.cuh"

namespace {

using namespace mxtpu;  // to_f32, from_f32, dropout_keep, row_sum

constexpr int kBlockQ = 64;                  // query rows per CTA
constexpr int kBlockK = 32;                  // keys per shared-memory tile
constexpr int kThreads = kBlockQ * kLanesPerRow;

// element strides of (batch, head, seq) for q, k, v, out; head dim stride 1
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// DQ: head-dim elements per lane (the head dim padded to 4*DQ)
template <typename T, int DQ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int S, int D,
                     Strides st, float scale, int causal, int dropout,
                     float keep_prob, uint32_t seed, uint32_t thresh) {
  constexpr int kDP = kLanesPerRow * DQ;  // padded head dim
  constexpr int kLD = DQ + 4;             // padded quarter row (16-byte aligned)
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

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];

  float qr[DQ];
  float acc[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    qr[c] = (row_live && d < D) ? to_f32(qb[q_pos * st.q[2] + d]) : 0.f;
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
      ks[j][d / DQ][d % DQ] = ok ? to_f32(kb[k_pos * st.k[2] + d]) : 0.f;
      vs[j][d / DQ][d % DQ] = ok ? to_f32(vb[k_pos * st.v[2] + d]) : 0.f;
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
      s[j] = to_f32(from_f32<T>(p_v));  // P in v's dtype before PV
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
  T* ob = out + b * st.o[0] + h * st.o[1] + q_pos * st.o[2];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    if (d < D) ob[d] = from_f32<T>(acc[c] / o_denom);
  }
  if (sub == 0)
    lse[(long long)bh * S + q_pos] = isfinite(m) ? m + logf(denom) : -INFINITY;
}

template <typename T, int DQ>
void launch(const void* q, const void* k, const void* v, void* out,
            float* lse, int B, int H, int S, int D, const Strides& st,
            float scale, int causal, int dropout, float keep_prob,
            uint32_t seed, uint32_t thresh, cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, DQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, S, D, st, scale,
      causal, dropout, keep_prob, seed, thresh);
}

template <typename T>
void launch_d(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int S, int D, const Strides& st,
              float scale, int causal, int dropout, float keep_prob,
              uint32_t seed, uint32_t thresh, cudaStream_t stream) {
  if (D <= 32)
    launch<T, 8>(q, k, v, out, lse, B, H, S, D, st, scale, causal, dropout,
                 keep_prob, seed, thresh, stream);
  else if (D <= 64)
    launch<T, 16>(q, k, v, out, lse, B, H, S, D, st, scale, causal, dropout,
                  keep_prob, seed, thresh, stream);
  else
    launch<T, 32>(q, k, v, out, lse, B, H, S, D, st, scale, causal, dropout,
                  keep_prob, seed, thresh, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, seq) of q, k, v, out in that order. lse: (B, H, S) float32,
// contiguous. Returns the cudaError_t of the launch (0 on success).
int mxtpu_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int dtype, int B, int H,
                              int S, int D, const long long* strides,
                              float scale, int causal, int dropout,
                              float keep_prob, unsigned int seed,
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
    launch_d<float>(q, k, v, out, l, B, H, S, D, st, scale, causal, dropout,
                    keep_prob, seed, thresh, s);
  else
    launch_d<__nv_bfloat16>(q, k, v, out, l, B, H, S, D, st, scale, causal,
                            dropout, keep_prob, seed, thresh, s);
  return (int)cudaGetLastError();
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
