// Flash-attention backward (FlashAttention-2) for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/ops/flash_attention.py).
//
// Replaces the two TPU kernels launched by
// mxnet_tpu/ops/pallas_attention.py:_flash_bwd:
//   _bwd_dq_kernel  (pl.pallas_call at :387) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (pl.pallas_call at :407) -> flash_bwd_dkv_kernel
// Same contract, over (B, H, S, D) with optional causal mask and the
// forward's counter-hash dropout mask (flash_attention_common.cuh), its
// seed read from device memory at kernel start (the forward's seed tensor,
// so a replayed CUDA graph draws each step's mask):
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
// Two variants, chosen by dtype (the wrapper counts each):
//
// bf16, flash_bwd_dq_mma_kernel and flash_bwd_dkv_mma_kernel, on the
// tensor cores with the forward's tile machinery (flash_attention_common
// .cuh): 4 warps per CTA, 16 owned rows per warp, cp.async double
// buffering of the streamed tiles, XOR-swizzled bf16 shared memory,
// ldmatrix / ldmatrix.trans, mma.sync.m16n8k16 with f32 accumulators, exp
// in base 2 and masks only in edge tiles. In the dq kernel a CTA owns 64
// queries: the prologue stages Q, dO and O, computes delta = rowsum(dO * O)
// and writes it; per 64-key tile (32 at head dim 128) S = Q K^T and
// dP = dO V^T are two products into registers, P and dS are formed on the
// fragments, and dS (rounded to bf16) is the register A operand of
// dQ += dS K (K by ldmatrix.trans). Q's and dO's fragments are held in
// registers up to head dim 64. In the dk/dv kernel a CTA owns 64 keys: per
// tile of 32 queries with their lse and delta, S^T = K Q^T and
// dP^T = V dO^T (K and V read as A fragments from shared memory), then
// P_d^T and dS^T (rounded to bf16) are the A operands of dV += P_d^T dO
// and dK += dS^T Q. dK and dV take 64 f32 registers (D 64); 32-query tiles
// and 3 CTAs an SM were the fastest of the shapes tried (PERF.md).
//
// f32, flash_bwd_dq_kernel and flash_bwd_dkv_kernel (TF32 would keep about
// 3 digits, above the f32 tolerance), the FP32 forward's layout turned to
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
// kernels of both variants.
#include "flash_attention_common.cuh"

namespace {

using namespace mxtpu;

constexpr int kBlockR = 64;  // rows a CTA owns (queries for dq, keys for dkv)
constexpr int kBlockT = 32;  // streamed rows per shared-memory tile
constexpr int kThreads = kBlockR * kLanesPerRow;

// element strides of (batch, head, seq); every head dim has stride 1
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

// Stage `kBlockT` rows starting at `r0` of two (S, D) matrices into shared
// memory as f32, zero beyond S and D.
template <int DQ>
__device__ __forceinline__ void load_tiles(
    float (*as)[kLanesPerRow][DQ + 4], float (*bs)[kLanesPerRow][DQ + 4],
    const float* a, long long a_stride, const float* b, long long b_stride,
    int r0,
    int S, int D) {
  constexpr int kDP = kLanesPerRow * DQ;
  for (int i = threadIdx.x; i < kBlockT * kDP; i += kThreads) {
    const int j = i / kDP;
    const int d = i % kDP;
    const int r = r0 + j;
    const bool ok = r < S && d < D;
    as[j][d / DQ][d % DQ] = ok ? a[r * a_stride + d] : 0.f;
    bs[j][d / DQ][d % DQ] = ok ? b[r * b_stride + d] : 0.f;
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
template <int DQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ out,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ delta, int H, int S, int D,
                        Strides st, float scale, int causal, int dropout,
                        float keep_prob,
                        const uint32_t* __restrict__ seed_p, uint32_t thresh) {
  // the dropout seed, read on the card (a graph replay takes its value)
  const uint32_t seed = dropout ? *seed_p : 0u;
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

  const float* qb = q + b * st.q[0] + h * st.q[1] + q_pos * st.q[2];
  const float* gb = dout + b * st.g[0] + h * st.g[1] + q_pos * st.g[2];
  const float* ob = out + b * st.o[0] + h * st.o[1] + q_pos * st.o[2];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];

  float qr[DQ], gr[DQ], acc[DQ];
  float dpart = 0.f;
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    const bool ok = row_live && d < D;
    qr[c] = ok ? qb[d] : 0.f;
    gr[c] = ok ? gb[d] : 0.f;
    const float o = ok ? ob[d] : 0.f;
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
    load_tiles<DQ>(ks, vs, kb, st.k[2], vb, st.v[2], k0, S, D);
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
      axpy<DQ>(acc, p * (dp - dl) * scale, &ks[j][sub][0]);  // dS k
    }
    __syncthreads();  // the tile is reloaded next iteration
  }

  if (!row_live) return;
  float* dqb = dq + b * st.dq[0] + h * st.dq[1] + q_pos * st.dq[2];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    if (d < D) dqb[d] = acc[c];
  }
}

// dK and dV; reads the delta that flash_bwd_dq_kernel wrote.
template <int DQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H,
                         int S, int D, Strides st, float scale, int causal,
                         int dropout, float keep_prob,
                         const uint32_t* __restrict__ seed_p,
                         uint32_t thresh) {
  // the dropout seed, read on the card (a graph replay takes its value)
  const uint32_t seed = dropout ? *seed_p : 0u;
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

  const float* kb = k + b * st.k[0] + h * st.k[1] + k_pos * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[1] + k_pos * st.v[2];
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* gb = dout + b * st.g[0] + h * st.g[1];

  float kr[DQ], vr[DQ], dk_acc[DQ], dv_acc[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    const bool ok = row_live && d < D;
    kr[c] = ok ? kb[d] : 0.f;
    vr[c] = ok ? vb[d] : 0.f;
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  // causal: query tiles that end before this k block's first key see P = 0
  const int t0 = causal ? k0 / kBlockT : 0;
  const int n_tiles = (S + kBlockT - 1) / kBlockT;

  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * kBlockT;
    load_tiles<DQ>(qs, gs, qb, st.q[2], gb, st.g[2], q0, S, D);
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
      axpy<DQ>(dv_acc, p_d, &gs[i][sub][0]);                        // P_d^T dO
      axpy<DQ>(dk_acc, p * (dp - dls[i]) * scale, &qs[i][sub][0]);  // dS^T q
    }
    __syncthreads();
  }

  if (!row_live) return;
  float* dkb = dk + b * st.dk[0] + h * st.dk[1] + k_pos * st.dk[2];
  float* dvb = dv + b * st.dv[0] + h * st.dv[1] + k_pos * st.dv[2];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    const int d = sub * DQ + c;
    if (d < D) {
      dkb[d] = dk_acc[c];
      dvb[d] = dv_acc[c];
    }
  }
}

constexpr int kMmaWarps = 4;             // 16 owned rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // rows a CTA owns
// keys per K/V tile of the dq kernel: 32 at head dim 128, where S and dP
// take 32 registers fewer and dQ's 64 still fit without spills
__host__ __device__ constexpr int dq_keys(int C) { return C == 16 ? 32 : 64; }
constexpr int kMmaQueries = 32;           // queries per Q/dO tile (dk/dv)

// bf16 dQ and delta. C: 16-byte chunks of the padded head dim.
template <int C, bool ALIGNED>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const uint16_t* __restrict__ q,
                            const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v,
                            const uint16_t* __restrict__ out,
                            const uint16_t* __restrict__ dout,
                            const float* __restrict__ lse,
                            uint16_t* __restrict__ dq,
                            float* __restrict__ delta, int H, int S, int D,
                            Strides st, float scale, int causal, int dropout,
                            float keep_prob,
                            const uint32_t* __restrict__ seed_p,
                            uint32_t thresh) {
  // the dropout seed, read on the card (a graph replay takes its value)
  const uint32_t seed = dropout ? *seed_p : 0u;
  constexpr int KT = dq_keys(C);
  constexpr int NB = KT / 8;
  constexpr int kTile = KT * C * 8;  // elements of a K or V tile
  static_assert(4 * KT >= kMmaRows, "O's tile fits in the K and V rings");
  constexpr bool kHold = C <= 8;  // Q and dO fragments in registers
  uint16_t* qs = dyn_smem<uint16_t>();  // Q, then the dQ tile
  uint16_t* gs = qs + kMmaRows * C * 8;  // dO
  uint16_t* ks = gs + kMmaRows * C * 8;  // K ring (O's tile at first)
  uint16_t* vs = ks + 2 * kTile;        // V ring
  float* ls = reinterpret_cast<float*>(vs + 2 * kTile);  // lse of the rows
  float* dls = ls + kMmaRows;                               // their delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kMmaRows;
  const uint16_t* kb = k + b * st.k[0] + h * st.k[1];
  const uint16_t* vb = v + b * st.v[0] + h * st.v[1];

  // causal: key tiles past this q block's last row see an all-zero P
  const int k_end = causal ? min(S, q0 + kMmaRows) : S;
  const int n_tiles = (k_end + KT - 1) / KT;

  load_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, S, D);
  load_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      gs, dout + b * st.g[0] + h * st.g[1], st.g[2], q0, S, D);
  load_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      ks, out + b * st.o[0] + h * st.o[1], st.o[2], q0, S, D);
  load_row_values<kMmaRows, kMmaThreads>(ls, lse + (long long)bh * S, q0, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    // delta = rowsum(dO * O), unchanged by dropout since O = P_d V: two
    // threads a row, half the chunks each
    const int r = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    float part = 0.f;
    for (int c = half * (C / 2); c < (half + 1) * (C / 2); ++c) {
      const uint16_t* gr = gs + swz<C>(r, c) * 8;
      const uint16_t* orow = ks + swz<C>(r, c) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        part = fmaf(bf16_bits(gr[e]), bf16_bits(orow[e]), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      dls[r] = part;
      if (q0 + r < S) delta[(long long)bh * S + q0 + r] = part;
    }
  }
  __syncthreads();  // delta is read below; O's tile takes K and V now
  load_tile<KT, C, ALIGNED, kMmaThreads>(ks, kb, st.k[2], 0, S, D);
  load_tile<KT, C, ALIGNED, kMmaThreads>(vs, vb, st.v[2], 0, S, D);
  cp_async_commit();

  const int row = q0 + warp * 16 + g;  // q_pos of rows g; g + 8 is row + 8
  const float sl2 = scale * kLog2e;
  const float inv_keep = 1.f / keep_prob;
  float lr[2], dlr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // lse in base-2 units, +inf for a fully masked row (lse -inf) so that
    // its P = 2^(-inf) = 0; rows past S read 0 from the zero fill, and
    // their dQ is never stored
    const float l = ls[warp * 16 + g + 8 * r];
    lr[r] = isfinite(l) ? l * kLog2e : INFINITY;
    dlr[r] = dls[warp * 16 + g + 8 * r];
  }
  uint32_t qf[kHold ? C / 2 : 1][4], gf[kHold ? C / 2 : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kq = 0; kq < C / 2; ++kq) {
      load_a<C>(qf[kq], qs, warp * 16, kq, lane);
      load_a<C>(gf[kq], gs, warp * 16, kq, lane);
    }
  }
  float acc[C][4];
#pragma unroll
  for (int nd = 0; nd < C; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      const int nxt = (stage ^ 1) * kTile;
      load_tile<KT, C, ALIGNED, kMmaThreads>(
          ks + nxt, kb, st.k[2], (t + 1) * KT, S, D);
      load_tile<KT, C, ALIGNED, kMmaThreads>(
          vs + nxt, vb, st.v[2], (t + 1) * KT, S, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* kt = ks + stage * kTile;
    const uint16_t* vt = vs + stage * kTile;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
    }
    if constexpr (kHold) {
      mma_abt<C, NB>(s, qf, kt, lane);   // S = Q K^T
      mma_abt<C, NB>(dp, gf, vt, lane);  // dP = dO V^T
    } else {
      mma_abt<C, NB>(s, qs, warp * 16, kt, lane);
      mma_abt<C, NB>(dp, gs, warp * 16, vt, lane);
    }
    const int k0 = t * KT;
    // masks only in a tile at an edge (ragged S, the causal diagonal)
    const bool edge =
        k0 + KT > S || (causal && k0 + KT - 1 > q0);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qp = row + 8 * r;
        const int kp = k0 + nb * 8 + 2 * t4 + (e & 1);
        float p = exp2f(fmaf(s[nb][e], sl2, -lr[r]));
        if (edge && (kp >= S || (causal && kp > qp))) p = 0.f;
        float d = dp[nb][e];
        if (dropout)
          d = dropout_keep(seed, (uint32_t)bh, (uint32_t)qp, (uint32_t)kp,
                           thresh)
                  ? d * inv_keep
                  : 0.f;
        s[nb][e] = p * (d - dlr[r]) * scale;  // dS, to bf16 in mma_pv
      }
    }
    mma_pv<C, NB>(acc, s, kt, lane);  // dQ += dS K
    __syncthreads();                  // this stage is refilled next
  }

  stage_acc<C>(qs, acc, warp * 16, lane, 1.f, 1.f);
  __syncthreads();
  store_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      qs, dq + b * st.dq[0] + h * st.dq[1], st.dq[2], q0, S, D);
}

// bf16 dK and dV; reads the delta that flash_bwd_dq_mma_kernel wrote. Up
// to head dim 64, 3 CTAs an SM (<= 168 registers).
template <int C, bool ALIGNED>
__global__ void __launch_bounds__(kMmaThreads, C <= 8 ? 3 : 1)
    flash_bwd_dkv_mma_kernel(const uint16_t* __restrict__ q,
                             const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v,
                             const uint16_t* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             uint16_t* __restrict__ dk,
                             uint16_t* __restrict__ dv, int H, int S, int D,
                             Strides st, float scale, int causal, int dropout,
                             float keep_prob,
                             const uint32_t* __restrict__ seed_p,
                             uint32_t thresh) {
  // the dropout seed, read on the card (a graph replay takes its value)
  const uint32_t seed = dropout ? *seed_p : 0u;
  constexpr int T = kMmaQueries;
  constexpr int NB = T / 8;
  constexpr int kOwn = kMmaRows * C * 8;  // elements of the K or V tile
  constexpr int kTileT = T * C * 8;       // of one Q or dO tile
  uint16_t* ks = dyn_smem<uint16_t>();  // K, then the dK tile
  uint16_t* vs = ks + kOwn;             // V, then the dV tile
  uint16_t* qs = vs + kOwn;             // Q ring, 2 stages
  uint16_t* gs = qs + 2 * kTileT;       // dO ring
  float* ls = reinterpret_cast<float*>(gs + 2 * kTileT);  // lse ring
  float* dls = ls + 2 * T;                                  // delta ring

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kMmaRows;
  const uint16_t* qb = q + b * st.q[0] + h * st.q[1];
  const uint16_t* gb = dout + b * st.g[0] + h * st.g[1];
  const float* lb = lse + (long long)bh * S;
  const float* db = delta + (long long)bh * S;

  // causal: query tiles that end before this k block's first key see P = 0
  const int t_first = causal ? k0 / T : 0;
  const int n_tiles = (S + T - 1) / T;

  load_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      ks, k + b * st.k[0] + h * st.k[1], st.k[2], k0, S, D);
  load_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      vs, v + b * st.v[0] + h * st.v[1], st.v[2], k0, S, D);
  auto load_q = [&](int t, int stage) {
    load_tile<T, C, ALIGNED, kMmaThreads>(qs + stage * kTileT, qb, st.q[2],
                                          t * T, S, D);
    load_tile<T, C, ALIGNED, kMmaThreads>(gs + stage * kTileT, gb, st.g[2],
                                          t * T, S, D);
    load_row_values<T, kMmaThreads>(ls + stage * T, lb, t * T, S);
    load_row_values<T, kMmaThreads>(dls + stage * T, db, t * T, S);
  };
  load_q(t_first, 0);
  cp_async_commit();

  const int key = k0 + warp * 16 + g;  // k_pos of rows g; g + 8 is key + 8
  const float sl2 = scale * kLog2e;
  const float inv_keep = 1.f / keep_prob;
  float dka[C][4], dva[C][4];
#pragma unroll
  for (int nd = 0; nd < C; ++nd) {
    dka[nd][0] = dka[nd][1] = dka[nd][2] = dka[nd][3] = 0.f;
    dva[nd][0] = dva[nd][1] = dva[nd][2] = dva[nd][3] = 0.f;
  }

  for (int t = t_first; t < n_tiles; ++t) {
    const int stage = (t - t_first) & 1;
    if (t + 1 < n_tiles) {
      load_q(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* qt = qs + stage * kTileT;
    const uint16_t* gt = gs + stage * kTileT;
    const float* lt = ls + stage * T;
    const float* dlt = dls + stage * T;

    float sp[NB][4], dp[NB][4];  // S^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      sp[nb][0] = sp[nb][1] = sp[nb][2] = sp[nb][3] = 0.f;
      dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
    }
    mma_abt<C, NB>(sp, ks, warp * 16, qt, lane);  // S^T = K Q^T
    mma_abt<C, NB>(dp, vs, warp * 16, gt, lane);  // dP^T = V dO^T
    // masks only in a tile at an edge (ragged S, the causal diagonal)
    const bool edge =
        (t + 1) * T > S || (causal && k0 + kMmaRows - 1 > t * T);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = key + 8 * (e >> 1);
        const int qi = nb * 8 + 2 * t4 + (e & 1);
        const int qp = t * T + qi;
        // lse in base-2 units, +inf for a fully masked row (lse -inf) so
        // that its P = 2^(-inf) = 0
        const float l = isfinite(lt[qi]) ? lt[qi] * kLog2e : INFINITY;
        float p = exp2f(fmaf(sp[nb][e], sl2, -l));
        if (edge && (qp >= S || (causal && kp > qp))) p = 0.f;
        float p_d = p;
        float d = dp[nb][e];
        if (dropout) {
          const bool keep = dropout_keep(seed, (uint32_t)bh, (uint32_t)qp,
                                         (uint32_t)kp, thresh);
          p_d = keep ? p * inv_keep : 0.f;
          d = keep ? d * inv_keep : 0.f;
        }
        sp[nb][e] = p_d;                        // P_d^T, to bf16 in mma_pv
        dp[nb][e] = p * (d - dlt[qi]) * scale;  // dS^T, likewise
      }
    }
    mma_pv<C, NB>(dva, sp, gt, lane);  // dV += P_d^T dO
    mma_pv<C, NB>(dka, dp, qt, lane);  // dK += dS^T Q
    __syncthreads();                   // this stage is refilled next
  }

  stage_acc<C>(ks, dka, warp * 16, lane, 1.f, 1.f);
  stage_acc<C>(vs, dva, warp * 16, lane, 1.f, 1.f);
  __syncthreads();
  store_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      ks, dk + b * st.dk[0] + h * st.dk[1], st.dk[2], k0, S, D);
  store_tile<kMmaRows, C, ALIGNED, kMmaThreads>(
      vs, dv + b * st.dv[0] + h * st.dv[1], st.dv[2], k0, S, D);
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
  const uint32_t* seed;  // on the card; read only under dropout
  uint32_t thresh;
  cudaStream_t stream;
};

template <int DQ>
void launch_dq(const Args& a) {
  const dim3 grid((a.S + kBlockR - 1) / kBlockR, a.B * a.H);
  flash_bwd_dq_kernel<DQ><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.out),
      static_cast<const float*>(a.dout), a.lse, static_cast<float*>(a.dq),
      a.delta,
      a.H, a.S, a.D, a.st, a.scale, a.causal, a.dropout, a.keep_prob, a.seed,
      a.thresh);
}

template <int DQ>
void launch_dkv(const Args& a) {
  const dim3 grid((a.S + kBlockR - 1) / kBlockR, a.B * a.H);
  flash_bwd_dkv_kernel<DQ><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
      a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.S,
      a.D,
      a.st, a.scale, a.causal, a.dropout, a.keep_prob, a.seed, a.thresh);
}

template <typename KernelT>
int set_smem(KernelT kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C, bool ALIGNED>
int launch_mma(const Args& a, bool dkv) {
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows, a.B * a.H);
  int err;
  if (!dkv) {
    // Q, dO, two stages each of K and V; lse and delta of the rows
    constexpr int kSmem =
        (2 * kMmaRows + 4 * dq_keys(C)) * C * 16 + 2 * kMmaRows * 4;
    auto kernel = flash_bwd_dq_mma_kernel<C, ALIGNED>;
    if ((err = set_smem(kernel, kSmem))) return err;
    kernel<<<grid, kMmaThreads, kSmem, a.stream>>>(
        static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
        static_cast<const uint16_t*>(a.v),
        static_cast<const uint16_t*>(a.out),
        static_cast<const uint16_t*>(a.dout), a.lse,
        static_cast<uint16_t*>(a.dq), a.delta, a.H, a.S, a.D, a.st, a.scale,
        a.causal, a.dropout, a.keep_prob, a.seed, a.thresh);
  } else {
    // K, V; two stages each of Q, dO, lse and delta
    constexpr int T = kMmaQueries;
    constexpr int kSmem = (2 * kMmaRows + 4 * T) * C * 16 + 4 * T * 4;
    auto kernel = flash_bwd_dkv_mma_kernel<C, ALIGNED>;
    if ((err = set_smem(kernel, kSmem))) return err;
    kernel<<<grid, kMmaThreads, kSmem, a.stream>>>(
        static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
        static_cast<const uint16_t*>(a.v),
        static_cast<const uint16_t*>(a.dout), a.lse, a.delta,
        static_cast<uint16_t*>(a.dk), static_cast<uint16_t*>(a.dv), a.H,
        a.S, a.D, a.st, a.scale, a.causal, a.dropout, a.keep_prob, a.seed,
        a.thresh);
  }
  return (int)cudaGetLastError();
}

template <bool ALIGNED>
int launch_mma_d(const Args& a, bool dkv) {
  if (a.D <= 32) return launch_mma<4, ALIGNED>(a, dkv);
  if (a.D <= 64) return launch_mma<8, ALIGNED>(a, dkv);
  return launch_mma<16, ALIGNED>(a, dkv);
}

void launch_f32(const Args& a, bool dkv) {
  if (a.D <= 32)
    dkv ? launch_dkv<8>(a) : launch_dq<8>(a);
  else if (a.D <= 64)
    dkv ? launch_dkv<16>(a) : launch_dq<16>(a);
  else
    dkv ? launch_dkv<32>(a) : launch_dq<32>(a);
}

int run(const Args& a, int dtype, bool dkv) {
  if (a.B < 1 || a.H < 1 || a.S < 1 || a.D < 1 || a.D > 128 ||
      a.B * a.H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch_f32(a, dkv);
    return (int)cudaGetLastError();
  }
  const void* ptrs[8] = {a.q, a.k, a.v, a.out, a.dout, a.dq, a.dk, a.dv};
  long long strides[24];
  const long long* src[8] = {a.st.q, a.st.k, a.st.v, a.st.o,
                             a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) strides[3 * t + i] = src[t][i];
  return tiles_aligned(ptrs, strides, 8, a.D) ? launch_mma_d<true>(a, dkv)
                                               : launch_mma_d<false>(a, dkv);
}

Args make_args(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int H, int S, int D,
               const long long* strides, float scale, int causal, int dropout,
               float keep_prob, const unsigned int* seed, unsigned int thresh,
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

// dtype: 0 = float32 (the FP32 kernels), 1 = bfloat16 (the tensor-core
// kernels). strides: 24 element strides, (batch, head, seq) of q, k, v,
// out, dout, dq, dk, dv in that order. lse, delta: (B, H, S) float32,
// contiguous. Each returns the cudaError_t of its launch (0 on success).

// Writes dq and delta; reads q, k, v, out, dout, lse.
int mxtpu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, int dtype,
    int B, int H, int S, int D, const long long* strides, float scale,
    int causal, int dropout, float keep_prob, const unsigned int* seed,
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
    int dropout, float keep_prob, const unsigned int* seed, unsigned int thresh,
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
