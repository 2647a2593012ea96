// BatchNorm training, forward (K1) and backward (K2), for Hopper (sm_90a),
// CUDA C++ with a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/kernels/norm.py).
//
// Replaces the TPU kernels mxnet_tpu/kernels/norm.py:_fwd_kernel (:112,
// launched by _fwd_pallas :157) and _bwd_kernel (:202, launched by
// _bwd_pallas :245). The plain versions, whose results these kernels
// repeat, are mxnet_tpu_torch/ops/nn.py:_bn_train_impl and _bn_train_bwd.
//
// The tensor is read as (outer, C, inner) around its channel axis: NHWC is
// (N*H*W, C, 1), NCHW is (N, C, H*W). A "row" is one (outer, inner) pair,
// rows = outer * inner, and every statistic is a sum over the rows of one
// channel.
//
// The TPU kernels carried the per-channel sums in VMEM scratch across a
// sequential grid axis (phase 0: sums, phase 1: normalize). CTAs here run
// in parallel and in no order, so each pass is its own launch:
//   partials  CTA (channel tile, row chunk) sums its chunk's rows of its
//             channels in f32 and writes one partial per channel and chunk;
//   combine   one warp per channel adds the partials in a fixed order and
//             derives the per-channel coefficients;
//   apply     CTA (channel tile, row chunk) writes out (K1) or dx (K2).
// No atomics: a launch geometry always sums in the same order, and the
// bits repeat from run to run. The geometry (norm.py:launch_geometry) is a
// function of the shape, the dtype, the card's SM count and whether the
// rows start on 16 bytes, nothing else; it also chooses the path, which the
// launchers take from their `vec` argument.
//
// Bound on this card: bytes. Read once, K1 moves x in and out out, K2 x and
// dy in and dx out: 3.24 and 4.85 ms over ResNet-50's 53 sites at batch 256
// (bf16, 3.35 TB/s). One pass cannot hold x between the reductions and the
// apply at these sizes: one site's x is 12.8-411 MB, the card's shared
// memory 132 x 227 KB = 30 MB and its registers 33 MB. So the design's own
// floor is 3 passes over x for K1 (x twice, out once) and 5 for K2 (x, dy
// twice, dx once): 4.86 and 8.08 ms. What the design does to approach it:
//  - channels last with every row on 16 bytes (C % 8 == 0 in bf16, C % 4
//    in f32, aligned base pointers: launch_geometry decides), the main
//    path: each thread loads and stores 16 bytes (8 bf16 or 4 f32
//    channels of one row) and keeps its channels' sums in registers; a CTA
//    covers whole rows, or slabs of 256 bf16 channels (one warp per
//    512-byte slab), so no two CTAs split a 128-byte line; K1 keeps 8 and K2
//    4 independent 16-byte loads of each input in flight a thread (128
//    bytes); offsets are 64-bit once, for the chunk's base, and 32-bit in it;
//  - in the default f32-elementwise mode the per-channel algebra is folded
//    into coefficients by the combine: K1 out = fma(x - s, a, b), K2
//    dx = fma(a, dy, fma(b, x - m, c)) with x centred on the batch mean m in
//    f32 first: a subtraction and two fused multiply-adds an element in
//    place of the plain version's dozen operations and two divisions;
//  - the apply pass visits the row chunks in the reverse of the partials
//    pass's order, so it starts on what the partials pass read last, still
//    in the 50 MB L2 (most of x at the sites of 14x14x256 and below);
//  - every other shape (channels not last, C not a multiple of the vector,
//    a misaligned view) takes the scalar kernels: channels last, 32
//    channels of 8 rows a CTA; else one channel a CTA over the inner axis.
//
// Arithmetic: the elementwise dtype `ew` is f32, or bf16 when LOW (x is
// bf16 under MXTPU_BN_COMPUTE=bf16). LOW repeats the plain version's
// operations one by one, each an _rn intrinsic rounded to bf16 (the
// rounding is the contract there); the f32 mode differs from the plain
// version by the fused multiply-adds and the folding, well inside the f32
// tolerance. The f32 accumulations may differ by their order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 32;                    // channels/CTA, scalar, last
constexpr int kRowLanes = kThreads / kTileC;  // rows in flight, same
constexpr int kUnroll = 8;                    // loads in flight, scalar
constexpr int kSlabLanes = 32;                // 16-byte lanes of a slab
constexpr int kFwdVecUnroll = 8;              // 16-byte loads in flight, K1
constexpr int kBwdVecUnroll = 4;              // of x and of dy, K2
constexpr int kCombineThreads = 256;          // one warp per channel
constexpr int kCombineChannels = kCombineThreads / 32;

__device__ __forceinline__ float load_elem(const float* __restrict__ p,
                                          long long i) {
  return p[i];
}
__device__ __forceinline__ float load_elem(
    const __nv_bfloat16* __restrict__ p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_elem(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, long long i,
                                           float v) {
  p[i] = __float2bfloat16_rn(v);
}

// v rounded to the elementwise dtype: bf16 when LOW, else f32 as it is
template <bool LOW>
__device__ __forceinline__ float ew(float v) {
  return LOW ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// 16 bytes of T as f32 values, and back (bf16: element 0 in the low half
// of the first word; the packing rounds to nearest even)
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_f32(const uint4& u, float (&f)[N]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 from_f32(const float (&f)[N]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void to_f32(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 from_f32(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// ---------------------------------------------------------------------------
// The per-element arithmetic, shared by the vector and the scalar kernels.
// Per-channel terms come from the combine's coefficients (coef[k * C + c]).
// ---------------------------------------------------------------------------

// K1 partials: sums of xf = ew(x - s) and xf^2 (the square in f32)
template <bool LOW>
__device__ __forceinline__ void fwd_stats(float x, float s, float& a,
                                          float& b) {
  const float xf = ew<LOW>(__fsub_rn(x, s));
  a += xf;
  b = fmaf(xf, xf, b);
}

// K1 apply, the combine's (s, scale, offset): f32 out = fma(x - s, scale,
// offset); LOW out = ew(ew(ew(x - s) * scale) + offset)
struct FwdCoef {
  float s, a, b;
};
__device__ __forceinline__ FwdCoef fwd_coef(const float* __restrict__ coef,
                                            int C, int c) {
  return {coef[2 * C + c], coef[c], coef[C + c]};
}
template <bool LOW>
__device__ __forceinline__ float fwd_apply(float x, const FwdCoef& k) {
  const float xf = ew<LOW>(__fsub_rn(x, k.s));
  if (!LOW) return fmaf(xf, k.a, k.b);
  return ew<LOW>(__fadd_rn(ew<LOW>(__fmul_rn(xf, k.a)), k.b));
}

// K2's per-channel terms. f32 mode: the batch mean m (partials: sums of dy
// and dy * (x - m); apply: dx = fma(a, dy, fma(b, x - m, c)), a, b, c from
// the combine). LOW: the plain version's xf = ew(x - s_ew),
// xhat = ew(ew(xf - mc) * inv_ew), mc = ew(mean - shift) taken in f32
// first; then the plain version's dx step by step.
template <bool LOW>
struct BwdCoef;
template <>
struct BwdCoef<false> {
  float m, a, b, c;
  __device__ static BwdCoef load(const float* __restrict__ coef,
                                 const float* __restrict__ mean, int C, int c,
                                 bool apply) {
    if (!apply) return {mean[c], 0.f, 0.f, 0.f};
    return {coef[3 * C + c], coef[c], coef[C + c], coef[2 * C + c]};
  }
  __device__ void stats(float x, float dy, float& sa, float& sb) const {
    sa += dy;
    sb = fmaf(dy, __fsub_rn(x, m), sb);
  }
  __device__ float apply(float x, float dy) const {
    return fmaf(a, dy, fmaf(b, __fsub_rn(x, m), c));
  }
};
template <>
struct BwdCoef<true> {
  float s_ew, mc, inv_ew, gi, db, dg, n, dm_n, dv2;
  __device__ static BwdCoef load(const float* __restrict__ coef,
                                 const float* __restrict__ shift,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ inv,
                                 const float* __restrict__ dmean,
                                 const float* __restrict__ dvar, float n_ew,
                                 int C, int c, bool apply) {
    BwdCoef k;
    k.s_ew = ew<true>(shift[c]);
    k.mc = ew<true>(__fsub_rn(mean[c], shift[c]));
    k.inv_ew = ew<true>(inv[c]);
    k.n = n_ew;
    if (apply) {
      k.gi = coef[c];
      k.db = coef[C + c];
      k.dg = coef[2 * C + c];
      k.dm_n = dmean ? ew<true>(__fdiv_rn(ew<true>(dmean[c]), n_ew)) : 0.f;
      k.dv2 = dvar ? ew<true>(__fmul_rn(ew<true>(dvar[c]), 2.f)) : 0.f;
    } else {
      k.gi = k.db = k.dg = k.dm_n = k.dv2 = 0.f;
    }
    return k;
  }
  __device__ void stats(float x, float dy, float& sa, float& sb) const {
    const float xf = ew<true>(__fsub_rn(x, s_ew));
    const float xhat = ew<true>(__fmul_rn(ew<true>(__fsub_rn(xf, mc)),
                                          inv_ew));
    sa += dy;
    sb += ew<true>(__fmul_rn(dy, xhat));
  }
  // dx = ew(gi * ew(dy - ew(ew(db + ew(xhat * dg)) / n)))
  //    + ew(ew(dmean / n) + ew(ew(ew(2 dvar) * ew(xf - mc)) / n))
  __device__ float apply(float x, float dy) const {
    const float xf = ew<true>(__fsub_rn(x, s_ew));
    const float xc = ew<true>(__fsub_rn(xf, mc));
    const float xhat = ew<true>(__fmul_rn(xc, inv_ew));
    float t = ew<true>(__fmul_rn(xhat, dg));
    t = ew<true>(__fadd_rn(db, t));
    t = ew<true>(__fdiv_rn(t, n));
    t = ew<true>(__fsub_rn(dy, t));
    t = ew<true>(__fmul_rn(gi, t));
    float u = ew<true>(__fmul_rn(dv2, xc));
    u = ew<true>(__fdiv_rn(u, n));
    u = ew<true>(__fadd_rn(dm_n, u));
    return ew<true>(__fadd_rn(t, u));
  }
};

// The per-channel terms of K2 for channel c, either mode.
struct BwdArgs {
  const float* coef;
  const float* shift;
  const float* mean;
  const float* inv;
  const float* dmean;
  const float* dvar;
  float n_ew;
};
template <bool LOW>
__device__ __forceinline__ BwdCoef<LOW> bwd_coef(const BwdArgs& p, int C,
                                                 int c, bool apply);
template <>
__device__ __forceinline__ BwdCoef<false> bwd_coef<false>(const BwdArgs& p,
                                                          int C, int c,
                                                          bool apply) {
  return BwdCoef<false>::load(p.coef, p.mean, C, c, apply);
}
template <>
__device__ __forceinline__ BwdCoef<true> bwd_coef<true>(const BwdArgs& p,
                                                        int C, int c,
                                                        bool apply) {
  return BwdCoef<true>::load(p.coef, p.shift, p.mean, p.inv, p.dmean, p.dvar,
                             p.n_ew, C, c, apply);
}

// ---------------------------------------------------------------------------
// The vector path: channels last, 16-byte rows
// ---------------------------------------------------------------------------

// lanes: 16-byte columns of a row (C / N); slab: lanes of one CTA's part
// of a row (min(lanes, 32)); row_lanes: rows a CTA takes at a time
// (256 / slab). rows_per_chunk * lanes < 2^31: offsets in a chunk are int.
struct VGeom {
  long long rows;
  int c, lanes, slab, row_lanes, rows_per_chunk, chunks;
};

// This thread's 16-byte lane and first row of chunk `chunk`.
struct VSlice {
  int lane, rl, nrows;
  bool active;
  long long base;  // index in 16-byte units of (the chunk's row 0, lane)
  __device__ VSlice(const VGeom& g, int chunk) {
    const int t = threadIdx.x;
    lane = blockIdx.x * g.slab + t % g.slab;
    rl = t / g.slab;
    active = rl < g.row_lanes && lane < g.lanes;
    const long long r0 = (long long)chunk * g.rows_per_chunk;
    const long long left = g.rows - r0;
    nrows = left < 0 ? 0 : left < g.rows_per_chunk ? (int)left
                                                   : g.rows_per_chunk;
    base = r0 * g.lanes + lane;
  }
};

// Visit the slice's rows, U loads of each input in flight before their
// use: op.load(i), op.use(in, i) with i the 16-byte offset from the base.
template <int U, typename Op>
__device__ __forceinline__ void for_vec_rows(const VGeom& g, const VSlice& s,
                                             Op& op) {
  if (!s.active) return;
  const int step = g.row_lanes * g.lanes;
  const int end = s.nrows * g.lanes;
  int i = s.rl * g.lanes;
  for (; i + (U - 1) * step < end; i += U * step) {
    typename Op::In in[U];
#pragma unroll
    for (int j = 0; j < U; ++j) in[j] = op.load(i + j * step);
#pragma unroll
    for (int j = 0; j < U; ++j) op.use(in[j], i + j * step);
  }
  for (; i < end; i += step) op.use(op.load(i), i);
}

// Sum each channel's (a, b) over the CTA's row lanes in a fixed order and
// write the chunk's partials: part[chunk * C + c], part[(chunks + chunk) *
// C + c].
template <int N>
__device__ __forceinline__ void write_vec_partials(const VGeom& g,
                                                   const VSlice& s,
                                                   const float (&a)[N],
                                                   const float (&b)[N],
                                                   float* __restrict__ part,
                                                   int chunk) {
  __shared__ float red[2][kThreads * N];
  const int t = threadIdx.x;
#pragma unroll
  for (int v = 0; v < N; ++v) {
    red[0][t * N + v] = s.active ? a[v] : 0.f;
    red[1][t * N + v] = s.active ? b[v] : 0.f;
  }
  __syncthreads();
  const int width = g.slab * N;
  for (int ch = t; ch < width; ch += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < g.row_lanes; ++r) {
      sa += red[0][r * width + ch];
      sb += red[1][r * width + ch];
    }
    const int c = blockIdx.x * width + ch;
    if (c < g.c) {
      part[(long long)chunk * g.c + c] = sa;
      part[(long long)(g.chunks + chunk) * g.c + c] = sb;
    }
  }
}

template <typename T, bool LOW>
struct VFwdStats {
  static constexpr int N = Pack<T>::N;
  using In = uint4;
  const uint4* __restrict__ x;
  float s[N], a[N], b[N];
  __device__ uint4 load(int i) const { return x[i]; }
  __device__ void use(const uint4& u, int) {
    float f[N];
    Pack<T>::to_f32(u, f);
#pragma unroll
    for (int v = 0; v < N; ++v) fwd_stats<LOW>(f[v], s[v], a[v], b[v]);
  }
};

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_partials_vec_kernel(VGeom g, const T* __restrict__ x,
                               const float* __restrict__ shift,
                               float* __restrict__ part) {
  constexpr int N = Pack<T>::N;
  const int chunk = blockIdx.y;
  const VSlice s(g, chunk);
  VFwdStats<T, LOW> op;
  op.x = reinterpret_cast<const uint4*>(x) + s.base;
#pragma unroll
  for (int v = 0; v < N; ++v) {
    op.s[v] = s.active ? ew<LOW>(shift[s.lane * N + v]) : 0.f;
    op.a[v] = op.b[v] = 0.f;
  }
  for_vec_rows<kFwdVecUnroll>(g, s, op);
  write_vec_partials<N>(g, s, op.a, op.b, part, chunk);
}

template <typename T, bool LOW>
struct VFwdApply {
  static constexpr int N = Pack<T>::N;
  using In = uint4;
  const uint4* __restrict__ x;
  uint4* __restrict__ out;
  FwdCoef k[N];
  __device__ uint4 load(int i) const { return x[i]; }
  __device__ void use(const uint4& u, int i) {
    float f[N];
    Pack<T>::to_f32(u, f);
#pragma unroll
    for (int v = 0; v < N; ++v) f[v] = fwd_apply<LOW>(f[v], k[v]);
    out[i] = Pack<T>::from_f32(f);
  }
};

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_apply_vec_kernel(VGeom g, const T* __restrict__ x,
                            const float* __restrict__ coef,
                            T* __restrict__ out) {
  constexpr int N = Pack<T>::N;
  const VSlice s(g, g.chunks - 1 - (int)blockIdx.y);  // reverse: L2-warm
  if (!s.active) return;
  VFwdApply<T, LOW> op;
  op.x = reinterpret_cast<const uint4*>(x) + s.base;
  op.out = reinterpret_cast<uint4*>(out) + s.base;
#pragma unroll
  for (int v = 0; v < N; ++v) op.k[v] = fwd_coef(coef, g.c, s.lane * N + v);
  for_vec_rows<kFwdVecUnroll>(g, s, op);
}

struct XDy {
  uint4 x, dy;
};

template <typename T, bool LOW>
struct VBwdStats {
  static constexpr int N = Pack<T>::N;
  using In = XDy;
  const uint4* __restrict__ x;
  const uint4* __restrict__ dy;
  BwdCoef<LOW> k[N];
  float a[N], b[N];
  __device__ XDy load(int i) const { return {x[i], dy[i]}; }
  __device__ void use(const XDy& u, int) {
    float fx[N], fd[N];
    Pack<T>::to_f32(u.x, fx);
    Pack<T>::to_f32(u.dy, fd);
#pragma unroll
    for (int v = 0; v < N; ++v) k[v].stats(fx[v], fd[v], a[v], b[v]);
  }
};

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_partials_vec_kernel(VGeom g, const T* __restrict__ x,
                               const T* __restrict__ dy, BwdArgs p,
                               float* __restrict__ part) {
  constexpr int N = Pack<T>::N;
  const int chunk = blockIdx.y;
  const VSlice s(g, chunk);
  VBwdStats<T, LOW> op;
  op.x = reinterpret_cast<const uint4*>(x) + s.base;
  op.dy = reinterpret_cast<const uint4*>(dy) + s.base;
#pragma unroll
  for (int v = 0; v < N; ++v) {
    op.k[v] = bwd_coef<LOW>(p, g.c, s.active ? s.lane * N + v : 0, false);
    op.a[v] = op.b[v] = 0.f;
  }
  for_vec_rows<kBwdVecUnroll>(g, s, op);
  write_vec_partials<N>(g, s, op.a, op.b, part, chunk);
}

template <typename T, bool LOW>
struct VBwdApply {
  static constexpr int N = Pack<T>::N;
  using In = XDy;
  const uint4* __restrict__ x;
  const uint4* __restrict__ dy;
  uint4* __restrict__ dx;
  BwdCoef<LOW> k[N];
  __device__ XDy load(int i) const { return {x[i], dy[i]}; }
  __device__ void use(const XDy& u, int i) {
    float fx[N], fd[N];
    Pack<T>::to_f32(u.x, fx);
    Pack<T>::to_f32(u.dy, fd);
#pragma unroll
    for (int v = 0; v < N; ++v) fx[v] = k[v].apply(fx[v], fd[v]);
    dx[i] = Pack<T>::from_f32(fx);
  }
};

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_apply_vec_kernel(VGeom g, const T* __restrict__ x,
                            const T* __restrict__ dy, BwdArgs p,
                            T* __restrict__ dx) {
  constexpr int N = Pack<T>::N;
  const VSlice s(g, g.chunks - 1 - (int)blockIdx.y);  // reverse: L2-warm
  if (!s.active) return;
  VBwdApply<T, LOW> op;
  op.x = reinterpret_cast<const uint4*>(x) + s.base;
  op.dy = reinterpret_cast<const uint4*>(dy) + s.base;
  op.dx = reinterpret_cast<uint4*>(dx) + s.base;
#pragma unroll
  for (int v = 0; v < N; ++v) op.k[v] = bwd_coef<LOW>(p, g.c, s.lane * N + v, true);
  for_vec_rows<kBwdVecUnroll>(g, s, op);
}

// ---------------------------------------------------------------------------
// The scalar path: any C, any layout, any alignment
// ---------------------------------------------------------------------------

struct Geom {
  long long rows, inner, rows_per_chunk;
  int c, chunks;
};

template <bool LAST>
__device__ __forceinline__ long long offset(const Geom& g, long long r,
                                            int c) {
  if (LAST) return r * g.c + c;
  const long long o = r / g.inner;
  return (o * g.c + c) * g.inner + (r - o * g.inner);
}

// This thread's channel and its rows [r0, r1) of chunk `chunk`, with a step.
template <bool LAST>
struct Slice {
  int c, step;
  long long r0, r1;
  __device__ Slice(const Geom& g, int chunk) {
    const long long start = (long long)chunk * g.rows_per_chunk;
    r1 = start + g.rows_per_chunk < g.rows ? start + g.rows_per_chunk
                                           : g.rows;
    if (LAST) {
      c = blockIdx.x * kTileC + threadIdx.x % kTileC;
      r0 = start + threadIdx.x / kTileC;
      step = kRowLanes;
    } else {
      c = blockIdx.x;
      r0 = start + threadIdx.x;
      step = kThreads;
    }
  }
  __device__ bool active(const Geom& g) const { return c < g.c; }
};

// Visit the slice's elements, kUnroll loads in flight before their use.
template <bool LAST, typename Op>
__device__ __forceinline__ void for_rows(const Geom& g, const Slice<LAST>& s,
                                         Op& op) {
  if (!s.active(g)) return;
  long long r = s.r0;
  const long long span = (long long)(kUnroll - 1) * s.step;
  for (; r + span < s.r1; r += (long long)kUnroll * s.step) {
    long long off[kUnroll];
    typename Op::In in[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      off[j] = offset<LAST>(g, r + (long long)j * s.step, s.c);
      in[j] = op.load(off[j]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) op.use(in[j], off[j]);
  }
  for (; r < s.r1; r += s.step) {
    const long long o = offset<LAST>(g, r, s.c);
    op.use(op.load(o), o);
  }
}

// Sum (a, b) over the CTA's row lanes in a fixed order and write the
// chunk's partials: part[chunk * C + c] and part[(chunks + chunk) * C + c].
template <bool LAST>
__device__ __forceinline__ void write_partials(const Geom& g,
                                               const Slice<LAST>& s, float a,
                                               float b,
                                               float* __restrict__ part) {
  __shared__ float red[2][kThreads];
  float sa = 0.f, sb = 0.f;
  if (LAST) {
    red[0][threadIdx.x] = a;
    red[1][threadIdx.x] = b;
    __syncthreads();
    if (threadIdx.x >= kTileC) return;
#pragma unroll
    for (int j = 0; j < kRowLanes; ++j) {
      sa += red[0][j * kTileC + threadIdx.x];
      sb += red[1][j * kTileC + threadIdx.x];
    }
  } else {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, d);
      b += __shfl_down_sync(0xffffffffu, b, d);
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red[0][warp] = a;
      red[1][warp] = b;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    for (int j = 0; j < kThreads / 32; ++j) {
      sa += red[0][j];
      sb += red[1][j];
    }
  }
  if (!s.active(g)) return;
  part[(long long)blockIdx.y * g.c + s.c] = sa;
  part[(long long)(g.chunks + blockIdx.y) * g.c + s.c] = sb;
}

template <typename T, bool LOW>
struct FwdStats {
  using In = float;
  const T* __restrict__ x;
  float s, a = 0.f, b = 0.f;
  __device__ float load(long long o) const { return load_elem(x, o); }
  __device__ void use(float v, long long) { fwd_stats<LOW>(v, s, a, b); }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_partials_kernel(Geom g, const T* __restrict__ x,
                           const float* __restrict__ shift,
                           float* __restrict__ part) {
  const Slice<LAST> s(g, blockIdx.y);
  FwdStats<T, LOW> op{x, s.active(g) ? ew<LOW>(shift[s.c]) : 0.f};
  for_rows<LAST>(g, s, op);
  write_partials<LAST>(g, s, op.a, op.b, part);
}

template <typename T, bool LOW>
struct FwdApply {
  using In = float;
  const T* __restrict__ x;
  T* __restrict__ out;
  FwdCoef k;
  __device__ float load(long long o) const { return load_elem(x, o); }
  __device__ void use(float v, long long o) {
    store_elem(out, o, fwd_apply<LOW>(v, k));
  }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_apply_kernel(Geom g, const T* __restrict__ x,
                        const float* __restrict__ coef, T* __restrict__ out) {
  const Slice<LAST> s(g, g.chunks - 1 - (int)blockIdx.y);  // reverse
  if (!s.active(g)) return;
  FwdApply<T, LOW> op{x, out, fwd_coef(coef, g.c, s.c)};
  for_rows<LAST>(g, s, op);
}

template <typename T, bool LOW>
struct BwdStats {
  using In = float2;
  const T* __restrict__ x;
  const T* __restrict__ dy;
  BwdCoef<LOW> k;
  float a = 0.f, b = 0.f;
  __device__ float2 load(long long o) const {
    return make_float2(load_elem(x, o), load_elem(dy, o));
  }
  __device__ void use(float2 v, long long) { k.stats(v.x, v.y, a, b); }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_partials_kernel(Geom g, const T* __restrict__ x,
                           const T* __restrict__ dy, BwdArgs p,
                           float* __restrict__ part) {
  const Slice<LAST> s(g, blockIdx.y);
  BwdStats<T, LOW> op{x, dy,
                      bwd_coef<LOW>(p, g.c, s.active(g) ? s.c : 0, false)};
  for_rows<LAST>(g, s, op);
  write_partials<LAST>(g, s, op.a, op.b, part);
}

template <typename T, bool LOW>
struct BwdApply {
  using In = float2;
  const T* __restrict__ x;
  const T* __restrict__ dy;
  T* __restrict__ dx;
  BwdCoef<LOW> k;
  __device__ float2 load(long long o) const {
    return make_float2(load_elem(x, o), load_elem(dy, o));
  }
  __device__ void use(float2 v, long long o) {
    store_elem(dx, o, k.apply(v.x, v.y));
  }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_apply_kernel(Geom g, const T* __restrict__ x,
                        const T* __restrict__ dy, BwdArgs p,
                        T* __restrict__ dx) {
  const Slice<LAST> s(g, g.chunks - 1 - (int)blockIdx.y);  // reverse
  if (!s.active(g)) return;
  BwdApply<T, LOW> op{x, dy, dx, bwd_coef<LOW>(p, g.c, s.c, true)};
  for_rows<LAST>(g, s, op);
}

// ---------------------------------------------------------------------------
// The combine passes (both paths): one warp per channel. Lane l adds the
// partials of chunks l, l + 32, ... in order, then the warp adds its lanes
// in a fixed tree; every lane returns the channel's two sums, or false past
// the last channel.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool sum_partials(int C, int chunks,
                                             const float* __restrict__ part,
                                             int& c, float& s1, float& s2) {
  c = blockIdx.x * kCombineChannels + threadIdx.x / 32;
  if (c >= C) return false;
  s1 = 0.f;
  s2 = 0.f;
  for (int k = threadIdx.x % 32; k < chunks; k += 32) {
    s1 += part[(long long)k * C + c];
    s2 += part[(long long)(chunks + k) * C + c];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, d);
    s2 += __shfl_xor_sync(0xffffffffu, s2, d);
  }
  return true;
}

// mean, var, inv per channel, and the normalize's coefficients in `ew`:
// coef[c] = gamma*inv, coef[C + c] = beta - mean_c*gamma*inv,
// coef[2C + c] = the shift in `ew`
template <bool LOW>
__global__ void __launch_bounds__(kCombineThreads)
    bn_fwd_combine_kernel(int C, int chunks, const float* __restrict__ part,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const float* __restrict__ shift, float n, float eps,
                          float* __restrict__ mean, float* __restrict__ var,
                          float* __restrict__ inv, float* __restrict__ coef) {
  int c;
  float s1, s2;
  if (!sum_partials(C, chunks, part, c, s1, s2) || threadIdx.x % 32) return;
  const float mean_c = __fdiv_rn(s1, n);
  float v = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean_c, mean_c));
  v = v < 0.f ? 0.f : v;  // NaN stays NaN, as in clamp_min
  const float iv = __frsqrt_rn(__fadd_rn(v, eps));
  const float s_ew = ew<LOW>(shift[c]);
  mean[c] = __fadd_rn(mean_c, s_ew);
  var[c] = v;
  inv[c] = iv;
  coef[c] = ew<LOW>(__fmul_rn(gamma[c], iv));
  coef[C + c] =
      ew<LOW>(__fsub_rn(beta[c], __fmul_rn(__fmul_rn(mean_c, gamma[c]), iv)));
  coef[2 * C + c] = s_ew;
}

// dbeta, dgamma per channel, and dx's coefficients.
// f32 mode: the partials are sums of dy and dy*(x - mean); dgamma = inv *
// the second; dx = a*dy + b*(x - mean) + c with a = gamma*inv, b = (2 dvar
// - a*dgamma*inv)/n, c = (dmean - a*dbeta)/n (folded in double), and
// coef = [a, b, c, mean]. LOW: coef = [gamma*inv, dbeta, dgamma] in `ew`.
template <bool LOW>
__global__ void __launch_bounds__(kCombineThreads)
    bn_bwd_combine_kernel(int C, int chunks, const float* __restrict__ part,
                          const float* __restrict__ gamma, BwdArgs p,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta,
                          float* __restrict__ coef) {
  int c;
  float db, dg;
  if (!sum_partials(C, chunks, part, c, db, dg) || threadIdx.x % 32) return;
  const float gi = __fmul_rn(gamma[c], p.inv[c]);
  if (LOW) {
    dbeta[c] = db;
    dgamma[c] = dg;
    coef[c] = ew<LOW>(gi);
    coef[C + c] = ew<LOW>(db);
    coef[2 * C + c] = ew<LOW>(dg);
    return;
  }
  dg = __fmul_rn(p.inv[c], dg);
  dbeta[c] = db;
  dgamma[c] = dg;
  const double n = p.n_ew;
  const double dm = p.dmean ? p.dmean[c] : 0.0;
  const double dv2 = p.dvar ? 2.0 * p.dvar[c] : 0.0;
  coef[c] = gi;
  coef[C + c] = (float)((dv2 - (double)gi * dg * p.inv[c]) / n);
  coef[2 * C + c] = (float)((dm - (double)gi * db) / n);
  coef[3 * C + c] = p.mean[c];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// What the 16-byte kernels' loads need: channels last, whole 16-byte lanes
// per row, every tensor's base on 16 bytes (then every row starts on 16
// bytes). A call that asks for them elsewhere is refused, not run.
bool vector_refused(const void* const* ptrs, int n, int c, long long inner,
                    int x_bf16) {
  if (inner != 1 || c % (x_bf16 ? 8 : 4)) return true;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return true;
  return false;
}

Geom make_geom(long long outer, int c, long long inner, int chunks) {
  Geom g;
  g.rows = outer * inner;
  g.inner = inner;
  g.c = c;
  g.chunks = chunks;
  g.rows_per_chunk = (g.rows + chunks - 1) / chunks;
  return g;
}

dim3 grid_of(const Geom& g) {
  const int tiles = g.inner == 1 ? (g.c + kTileC - 1) / kTileC : g.c;
  return dim3(tiles, g.chunks);
}

// false when a chunk's offsets would not fit an int
bool make_vgeom(const Geom& g, int x_bf16, VGeom& v) {
  v.rows = g.rows;
  v.c = g.c;
  v.lanes = g.c / (x_bf16 ? 8 : 4);
  v.slab = v.lanes < kSlabLanes ? v.lanes : kSlabLanes;
  v.row_lanes = kThreads / v.slab;
  v.chunks = g.chunks;
  if (g.rows_per_chunk * v.lanes + (long long)kFwdVecUnroll * kThreads *
                                       v.lanes >= (1LL << 31))
    return false;
  v.rows_per_chunk = (int)g.rows_per_chunk;
  return true;
}

dim3 vgrid_of(const VGeom& v) {
  return dim3((v.lanes + v.slab - 1) / v.slab, v.chunks);
}

dim3 combine_grid(int c) {
  return dim3((c + kCombineChannels - 1) / kCombineChannels);
}

template <typename T, bool LOW>
cudaError_t fwd(const Geom& g, bool vec, const void* x, const float* gamma,
                const float* beta, const float* shift, void* out, float* mean,
                float* var, float* inv, float* work, float n, float eps,
                cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  float* coef = work + 2LL * g.chunks * g.c;
  VGeom v;
  if (vec && !make_vgeom(g, sizeof(T) == 2, v)) return cudaErrorInvalidValue;
  if (vec)
    bn_fwd_partials_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, shift, work);
  else if (g.inner == 1)
    bn_fwd_partials_kernel<T, LOW, true>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, shift, work);
  else
    bn_fwd_partials_kernel<T, LOW, false>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, shift, work);
  bn_fwd_combine_kernel<LOW><<<combine_grid(g.c), kCombineThreads, 0, st>>>(
      g.c, g.chunks, work, gamma, beta, shift, n, eps, mean, var, inv, coef);
  if (vec)
    bn_fwd_apply_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, coef, op);
  else if (g.inner == 1)
    bn_fwd_apply_kernel<T, LOW, true>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, coef, op);
  else
    bn_fwd_apply_kernel<T, LOW, false>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, coef, op);
  return cudaGetLastError();
}

template <typename T, bool LOW>
cudaError_t bwd(const Geom& g, bool vec, const void* x, const void* dy,
                const float* gamma, BwdArgs p, void* dx, float* dgamma,
                float* dbeta, float* work, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* coef = work + 2LL * g.chunks * g.c;
  p.coef = coef;
  VGeom v;
  if (vec && !make_vgeom(g, sizeof(T) == 2, v)) return cudaErrorInvalidValue;
  if (vec)
    bn_bwd_partials_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, dyp, p, work);
  else if (g.inner == 1)
    bn_bwd_partials_kernel<T, LOW, true>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, dyp, p, work);
  else
    bn_bwd_partials_kernel<T, LOW, false>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, dyp, p, work);
  bn_bwd_combine_kernel<LOW><<<combine_grid(g.c), kCombineThreads, 0, st>>>(
      g.c, g.chunks, work, gamma, p, dgamma, dbeta, coef);
  if (vec)
    bn_bwd_apply_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, dyp, p, dxp);
  else if (g.inner == 1)
    bn_bwd_apply_kernel<T, LOW, true>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, dyp, p, dxp);
  else
    bn_bwd_apply_kernel<T, LOW, false>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, dyp, p, dxp);
  return cudaGetLastError();
}

bool bad_geometry(long long outer, int c, long long inner, int chunks,
                  int x_bf16, int ew_low) {
  return outer < 1 || c < 1 || inner < 1 || chunks < 1 || chunks > 65535 ||
         (ew_low && !x_bf16);
}

}  // namespace

extern "C" {

// K1. x: (outer, C, inner), f32 or bf16 (x_bf16); gamma, beta, shift: f32
// (C,). Writes out (x's dtype and shape), mean, var, inv (f32 (C,)).
// work: f32 scratch of (2 * chunks + 4) * C. vec: take the 16-byte kernels
// (launch_geometry's choice; cudaErrorInvalidValue where they cannot run).
// ew_low: the elementwise dtype is bf16 (x must be bf16). n: rows per
// channel. Returns the cudaError_t of the launches (0 on success).
int mxtpu_bn_train_fwd(const void* x, const void* gamma, const void* beta,
                       const void* shift, void* out, void* mean, void* var,
                       void* inv, void* work, long long outer, int c,
                       long long inner, int chunks, int vec, int x_bf16,
                       int ew_low, float n, float eps, void* stream) {
  const void* ptrs[2] = {x, out};
  if (bad_geometry(outer, c, inner, chunks, x_bf16, ew_low) || !x ||
      !gamma || !beta || !shift || !out || !mean || !var || !inv || !work ||
      (vec && vector_refused(ptrs, 2, c, inner, x_bf16)))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(outer, c, inner, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* sh = static_cast<const float*>(shift);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  float* iv = static_cast<float*>(inv);
  float* w = static_cast<float*>(work);
  cudaError_t err;
  if (!x_bf16)
    err = fwd<float, false>(g, vec, x, ga, be, sh, out, m, v, iv, w, n, eps,
                            st);
  else if (!ew_low)
    err = fwd<__nv_bfloat16, false>(g, vec, x, ga, be, sh, out, m, v, iv, w,
                                    n, eps, st);
  else
    err = fwd<__nv_bfloat16, true>(g, vec, x, ga, be, sh, out, m, v, iv, w,
                                   n, eps, st);
  return (int)err;
}

// K2. x, dy: (outer, C, inner) in x's dtype; gamma, mean, inv, shift: f32
// (C,); dmean, dvar: f32 (C,) cotangents of the batch statistics, or null
// for zeros. Writes dx (x's dtype and shape), dgamma, dbeta (f32 (C,)).
// work: f32 scratch of (2 * chunks + 4) * C. vec: as for K1. n_ew: the rows per channel as
// the elementwise dtype holds the number. Returns the cudaError_t of the
// launches.
int mxtpu_bn_train_bwd(const void* x, const void* dy, const void* gamma,
                       const void* mean, const void* inv, const void* shift,
                       const void* dmean, const void* dvar, void* dx,
                       void* dgamma, void* dbeta, void* work, long long outer,
                       int c, long long inner, int chunks, int vec,
                       int x_bf16, int ew_low, float n_ew, void* stream) {
  const void* ptrs[3] = {x, dy, dx};
  if (bad_geometry(outer, c, inner, chunks, x_bf16, ew_low) || !x || !dy ||
      !gamma || !mean || !inv || !shift || !dx || !dgamma || !dbeta ||
      !work || (vec && vector_refused(ptrs, 3, c, inner, x_bf16)))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(outer, c, inner, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const BwdArgs p{nullptr,
                  static_cast<const float*>(shift),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(inv),
                  static_cast<const float*>(dmean),
                  static_cast<const float*>(dvar),
                  n_ew};
  float* dga = static_cast<float*>(dgamma);
  float* dbe = static_cast<float*>(dbeta);
  float* w = static_cast<float*>(work);
  cudaError_t err;
  if (!x_bf16)
    err = bwd<float, false>(g, vec, x, dy, ga, p, dx, dga, dbe, w, st);
  else if (!ew_low)
    err = bwd<__nv_bfloat16, false>(g, vec, x, dy, ga, p, dx, dga, dbe, w,
                                    st);
  else
    err = bwd<__nv_bfloat16, true>(g, vec, x, dy, ga, p, dx, dga, dbe, w, st);
  return (int)err;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
