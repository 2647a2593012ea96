// Flash-attention backward (FlashAttention-2) for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/ops/flash_attention.py).
//
// Replaces the two TPU kernels launched by
// mxnet_tpu/ops/pallas_attention.py:_flash_bwd:
//   _bwd_dq_kernel  (pl.pallas_call at :387) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (pl.pallas_call at :407) -> flash_bwd_dkv_kernel
// Same contract, over (B, H, S, D) with optional causal mask and the
// forward's counter-hash dropout mask (flash_attention_common.cuh):
//   delta = rowsum(dO * O)                       f32, per query row
//   P     = exp(q k^T * scale - lse)             0 where masked or lse = -inf
//   dP    = dO v^T      (kept pairs / (1 - p) under dropout, else 0)
//   dS    = P * (dP - delta) * scale             rounded to the inputs' dtype
//   dQ    = dS k,  dK = dS^T q
//   dV    = P_d^T dO    (P_d = kept P / (1 - p), rounded to dO's dtype)
// with f32 accumulation and dq, dk, dv in the inputs' dtype. No (S, S)
// matrix reaches device memory: P is recomputed per tile from q, k and lse.
//
// The TPU kernels carry dq / dk, dv in VMEM scratch across a sequential
// third grid axis. CUDA blocks run in no order, so here a loop inside the
// block takes that axis's place and each output row is owned by one block:
// two kernels, no atomics, and the same bits from run to run.
//
// Bound on this card: at the training shape (B 8, H 12, S 384, D 64, bf16)
// dq moves 24 MB and does 6*D operations per (q, k) pair (three products),
// dk/dv moves 28 MB and does 8*D per pair (four products): 7 and 8.5 us of
// bytes at 3.35 TB/s against 5.5 and 7.3 us on the tensor cores. Both are
// bound by bytes; the design reads every operand once per 64-row block and
// keeps P, dP and dS in registers.
//
// Design (simple and correct first), the forward kernel's layout turned to
// the backward: one CTA of 256 threads per (b*H + h, 64-row block). Four
// neighbouring lanes own one row and each holds a quarter of the head dim in
// registers. In flash_bwd_dq_kernel the owned rows are queries (q, dO and
// the dq accumulator in registers) and 32-key K/V tiles stream through
// shared memory; its prologue also computes delta and writes it for the
// second kernel. In flash_bwd_dkv_kernel the owned rows are keys (k, v and
// the dk, dv accumulators in registers) and 32-row Q/dO tiles with their
// lse and delta stream through shared memory, so the transposed products
// dS^T q and P_d^T dO need no transposed tile: each thread adds its own
// key's column of dS and P_d. Ragged ends of S and D are masked in the
// kernels. Tensor cores (mma.sync / wgmma) and TMA are later work.
#include "flash_attention_common.cuh"

namespace {

using namespace mxtpu;  // to_f32, from_f32, round_to, dropout_keep, row_sum

constexpr int kBlockR = 64;  // rows a CTA owns (queries for dq, keys for dkv)
constexpr int kBlockT = 32;  // streamed rows per shared-memory tile
constexpr int kThreads = kBlockR * kLanesPerRow;

// element strides of (batch, head, seq); every head dim has stride 1
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

// Stage `kBlockT` rows starting at `r0` of two (S, D) matrices into shared
// memory as f32, zero beyond S and D.
template <typename T, int DQ>
__device__ __forceinline__ void load_tiles(
    float (*as)[kLanesPerRow][DQ + 4], float (*bs)[kLanesPerRow][DQ + 4],
    const T* a, long long a_stride, const T* b, long long b_stride, int r0,
    int S, int D) {
  constexpr int kDP = kLanesPerRow * DQ;
  for (int i = threadIdx.x; i < kBlockT * kDP; i += kThreads) {
    const int j = i / kDP;
    const int d = i % kDP;
    const int r = r0 + j;
    const bool ok = r < S && d < D;
    as[j][d / DQ][d % DQ] = ok ? to_f32(a[r * a_stride + d]) : 0.f;
    bs[j][d / DQ][d % DQ] = ok ? to_f32(b[r * b_stride + d]) : 0.f;
  }
}

// partial dot products of the lane's quarter row with two shared rows
template <int DQ>
__device__ __forceinline__ void dot2(const float* x, const float* xs,
                                     const float* y, const float* ys,
                                     float* xd, float* yd) {
  const float4* xr = reinterpret_cast<const float4*>(xs);
  const float4* yr = reinterpret_cast<const float4*>(ys);
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < DQ / 4; ++c4) {
    const float4 xv = xr[c4];
    const float4 yv = yr[c4];
    a = fmaf(x[4 * c4 + 0], xv.x, a);
    a = fmaf(x[4 * c4 + 1], xv.y, a);
    a = fmaf(x[4 * c4 + 2], xv.z, a);
    a = fmaf(x[4 * c4 + 3], xv.w, a);
    b = fmaf(y[4 * c4 + 0], yv.x, b);
    b = fmaf(y[4 * c4 + 1], yv.y, b);
    b = fmaf(y[4 * c4 + 2], yv.z, b);
    b = fmaf(y[4 * c4 + 3], yv.w, b);
  }
  *xd = a;
  *yd = b;
}

// acc += s * (shared row)
template <int DQ>
__device__ __forceinline__ void axpy(float* acc, float s, const float* rs) {
  const float4* r = reinterpret_cast<const float4*>(rs);
#pragma unroll
  for (int c4 = 0; c4 < DQ / 4; ++c4) {
    const float4 rv = r[c4];
    acc[4 * c4 + 0] = fmaf(s, rv.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(s, rv.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(s, rv.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(s, rv.w, acc[4 * c4 + 3]);
  }
}

// dQ and delta. DQ: head-dim elements per lane (head dim padded to 4*DQ).
template <typename T, int DQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta, int H, int S, int D,
                        Strides st, float scale, int causal, int dropout,
                        float keep_prob, uint32_t seed, uint32_t thresh) {
  constexpr int kLD = DQ + 4;  // padded quarter row (16-byte aligned)
  __shared__ __align__(16) float ks[kBlockT][kLanesPerRow][kLD];
  __shared__ __align__(16) float vs[kBlockT][kLanesPerRow][kLD];

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockR;
  const int q_pos = q0 + row;
  const bool row_live = q_pos < S;

  const T* qb = q + b * st.q[0] + h * st.q[1] + q_pos * st.q[2];
  const T* gb = dout + b * st.g[0] + h * st.g[1] + q_pos * st.g[2];
  const T* ob = out + b * st.o[0] + h * st.o[1] + q_pos * st.o[2];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];

  float qr[DQ], gr[DQ], acc[DQ];
  float dpart = 0.f;
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    const bool ok = row_live && d < D;
    qr[c] = ok ? to_f32(qb[d]) : 0.f;
    gr[c] = ok ? to_f32(gb[d]) : 0.f;
    const float o = ok ? to_f32(ob[d]) : 0.f;
    dpart = fmaf(gr[c], o, dpart);
    acc[c] = 0.f;
  }
  // delta = rowsum(dO * O); unchanged by dropout, since O = P_d V
  const float dl = row_sum(dpart);
  const float l = row_live ? lse[(long long)bh * S + q_pos] : -INFINITY;
  const bool lse_live = isfinite(l);  // a fully masked row has P = 0
  if (row_live && sub == 0) delta[(long long)bh * S + q_pos] = dl;

  // causal: key tiles past this q block's last row see an all-zero P
  const int k_end = causal ? min(S, q0 + kBlockR) : S;
  const int n_tiles = (k_end + kBlockT - 1) / kBlockT;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockT;
    load_tiles<T, DQ>(ks, vs, kb, st.k[2], vb, st.v[2], k0, S, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockT; ++j) {
      float sp, dpp;
      dot2<DQ>(qr, &ks[j][sub][0], gr, &vs[j][sub][0], &sp, &dpp);
      const float s = row_sum(sp) * scale;
      float dp = row_sum(dpp);
      const int k_pos = k0 + j;
      const bool masked = k_pos >= S || (causal && k_pos > q_pos);
      const float p = (lse_live && !masked) ? expf(s - l) : 0.f;
      if (dropout)
        dp = dropout_keep(seed, (uint32_t)bh, (uint32_t)q_pos,
                          (uint32_t)k_pos, thresh)
                 ? dp / keep_prob
                 : 0.f;
      // dS in k's dtype before dS k
      const float ds = round_to<T>(p * (dp - dl) * scale);
      axpy<DQ>(acc, ds, &ks[j][sub][0]);
    }
    __syncthreads();  // the tile is reloaded next iteration
  }

  if (!row_live) return;
  T* dqb = dq + b * st.dq[0] + h * st.dq[1] + q_pos * st.dq[2];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    if (d < D) dqb[d] = from_f32<T>(acc[c]);
  }
}

// dK and dV; reads the delta that flash_bwd_dq_kernel wrote.
template <typename T, int DQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H,
                         int S, int D, Strides st, float scale, int causal,
                         int dropout, float keep_prob, uint32_t seed,
                         uint32_t thresh) {
  constexpr int kLD = DQ + 4;
  __shared__ __align__(16) float qs[kBlockT][kLanesPerRow][kLD];
  __shared__ __align__(16) float gs[kBlockT][kLanesPerRow][kLD];
  __shared__ float ls[kBlockT];   // lse of the tile's query rows
  __shared__ float dls[kBlockT];  // delta of the tile's query rows

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kBlockR;
  const int k_pos = k0 + row;
  const bool row_live = k_pos < S;

  const T* kb = k + b * st.k[0] + h * st.k[1] + k_pos * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[1] + k_pos * st.v[2];
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* gb = dout + b * st.g[0] + h * st.g[1];

  float kr[DQ], vr[DQ], dk_acc[DQ], dv_acc[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    const bool ok = row_live && d < D;
    kr[c] = ok ? to_f32(kb[d]) : 0.f;
    vr[c] = ok ? to_f32(vb[d]) : 0.f;
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  // causal: query tiles that end before this k block's first key see P = 0
  const int t0 = causal ? k0 / kBlockT : 0;
  const int n_tiles = (S + kBlockT - 1) / kBlockT;

  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * kBlockT;
    load_tiles<T, DQ>(qs, gs, qb, st.q[2], gb, st.g[2], q0, S, D);
    if (tid < kBlockT) {
      const int qp = q0 + tid;
      ls[tid] = qp < S ? lse[(long long)bh * S + qp] : -INFINITY;
      dls[tid] = qp < S ? delta[(long long)bh * S + qp] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kBlockT; ++i) {
      float sp, dpp;
      dot2<DQ>(kr, &qs[i][sub][0], vr, &gs[i][sub][0], &sp, &dpp);
      const float s = row_sum(sp) * scale;
      float dp = row_sum(dpp);
      const int q_pos = q0 + i;
      const float l = ls[i];  // -inf past S and for fully masked rows
      const bool masked = !row_live || (causal && k_pos > q_pos);
      const float p = (isfinite(l) && !masked) ? expf(s - l) : 0.f;
      float p_d = p;
      if (dropout) {
        const bool keep = dropout_keep(seed, (uint32_t)bh, (uint32_t)q_pos,
                                       (uint32_t)k_pos, thresh);
        p_d = keep ? p / keep_prob : 0.f;
        dp = keep ? dp / keep_prob : 0.f;
      }
      // P_d in dO's dtype before P_d^T dO; dS in q's dtype before dS^T q
      axpy<DQ>(dv_acc, round_to<T>(p_d), &gs[i][sub][0]);
      const float ds = round_to<T>(p * (dp - dls[i]) * scale);
      axpy<DQ>(dk_acc, ds, &qs[i][sub][0]);
    }
    __syncthreads();
  }

  if (!row_live) return;
  T* dkb = dk + b * st.dk[0] + h * st.dk[1] + k_pos * st.dk[2];
  T* dvb = dv + b * st.dv[0] + h * st.dv[1] + k_pos * st.dv[2];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    if (d < D) {
      dkb[d] = from_f32<T>(dk_acc[c]);
      dvb[d] = from_f32<T>(dv_acc[c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, S, D;
  Strides st;
  float scale;
  int causal, dropout;
  float keep_prob;
  uint32_t seed, thresh;
  cudaStream_t stream;
};

template <typename T, int DQ>
void launch_dq(const Args& a) {
  const dim3 grid((a.S + kBlockR - 1) / kBlockR, a.B * a.H);
  flash_bwd_dq_kernel<T, DQ><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dq), a.delta,
      a.H, a.S, a.D, a.st, a.scale, a.causal, a.dropout, a.keep_prob, a.seed,
      a.thresh);
}

template <typename T, int DQ>
void launch_dkv(const Args& a) {
  const dim3 grid((a.S + kBlockR - 1) / kBlockR, a.B * a.H);
  flash_bwd_dkv_kernel<T, DQ><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.S, a.D,
      a.st, a.scale, a.causal, a.dropout, a.keep_prob, a.seed, a.thresh);
}

template <typename T>
void launch_t(const Args& a, bool dkv) {
  if (a.D <= 32)
    dkv ? launch_dkv<T, 8>(a) : launch_dq<T, 8>(a);
  else if (a.D <= 64)
    dkv ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
  else
    dkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
}

int run(const Args& a, int dtype, bool dkv) {
  if (a.B < 1 || a.H < 1 || a.S < 1 || a.D < 1 || a.D > 128 ||
      a.B * a.H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_t<float>(a, dkv);
  else
    launch_t<__nv_bfloat16>(a, dkv);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int H, int S, int D,
               const long long* strides, float scale, int causal, int dropout,
               float keep_prob, unsigned int seed, unsigned int thresh,
               void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.S = S; a.D = D;
  long long* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o,
                       a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.scale = scale; a.causal = causal; a.dropout = dropout;
  a.keep_prob = keep_prob; a.seed = seed; a.thresh = thresh;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// head, seq) of q, k, v, out, dout, dq, dk, dv in that order. lse, delta:
// (B, H, S) float32, contiguous. Each returns the cudaError_t of its launch
// (0 on success).

// Writes dq and delta; reads q, k, v, out, dout, lse.
int mxtpu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, int dtype,
    int B, int H, int S, int D, const long long* strides, float scale,
    int causal, int dropout, float keep_prob, unsigned int seed,
    unsigned int thresh, void* stream) {
  return run(make_args(q, k, v, out, dout, lse, delta, dq, nullptr, nullptr,
                       B, H, S, D, strides, scale, causal, dropout, keep_prob,
                       seed, thresh, stream),
             dtype, false);
}

// Writes dk and dv; reads q, k, v, dout, lse and the delta written by
// mxtpu_flash_attention_bwd_dq on the same stream before it.
int mxtpu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int H, int S, int D, const long long* strides, float scale, int causal,
    int dropout, float keep_prob, unsigned int seed, unsigned int thresh,
    void* stream) {
  return run(make_args(q, k, v, nullptr, dout, lse,
                       const_cast<void*>(delta), nullptr, dk, dv, B, H, S, D,
                       strides, scale, causal, dropout, keep_prob, seed,
                       thresh, stream),
             dtype, true);
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
