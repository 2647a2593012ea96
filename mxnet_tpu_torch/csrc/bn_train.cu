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
// (N*H*W, C, 1), NCHW is (N, C, H*W). Every statistic is a sum over one
// channel's outer * inner elements. The TPU kernels carried the sums in
// VMEM scratch across a sequential grid axis (phase 0: sums, phase 1:
// normalize); CTAs here run in parallel and in no order. No atomics: a
// launch geometry always sums in the same order, and the bits repeat from
// run to run. The geometry (norm.py:launch_geometry) is a function of the
// shape, the dtype, the card's SM count and shared memory and whether the
// bases start on 16 bytes, nothing else; it chooses one of four regimes,
// which the launchers take from their `regime` argument and refuse where it
// cannot run:
//
//  0 last     channels last (inner == 1), any C or alignment: partials
//             (32 channels of 8 rows a CTA), combine, apply; 3 launches.
//  1 vector   channels last, every row on 16 bytes: the same three passes
//             with 16-byte loads and stores; 3 launches.
//  2 planes   channels not last, a channel too large for shared memory:
//             partials over (channel, range of planes), then one apply pass
//             whose CTAs each add their channel's partials in the combine's
//             fixed order; 2 launches.
//  3 resident channels not last, a channel's x (K1), or x and dy (K2), held
//             in the shared memory of one CTA or of a cluster of 2-8: one
//             launch reads HBM once, sums, adds the CTAs' sums through
//             distributed shared memory in rank order, and writes out or dx
//             from shared memory.
//
// Bound on this card: bytes. Read once, K1 moves x in and out out, K2 x and
// dy in and dx out (3.24 and 4.85 ms over ResNet-50's 53 sites at batch
// 256, bf16, 3.35 TB/s). Regimes 0-2 read x again between the sums and the
// apply: 3 passes for K1 (x twice, out once), 5 for K2 (x, dy twice, dx
// once). Regime 3 moves the read-once bytes. What each does about it:
//  - vector: each thread loads and stores 16 bytes (8 bf16 or 4 f32
//    channels of one row) and keeps its channels' sums in registers; a CTA
//    covers whole rows, or slabs of 256 bf16 channels (one warp per 512-byte
//    slab), so no two CTAs split a 128-byte line; K1 keeps 8 and K2 4
//    independent 16-byte loads of each input in flight a thread (128
//    bytes); offsets are 64-bit once, for the chunk's base, and 32-bit in it;
//  - planes and resident walk a channel as its planes' 16-byte slots (see
//    "The NCHW path"): one aligned 16-byte load or store a slot, the same
//    loads in flight a thread as the vector path, no division per element;
//    the resident regime copies its share into shared memory by cp.async,
//    every copy in flight at once, and sums and normalizes it from there
//    (a thread reads back the slots it copied);
//  - in the default f32-elementwise mode the per-channel algebra is folded
//    into coefficients: K1 out = fma(x - s, a, b), K2
//    dx = fma(a, dy, fma(b, x - m, c)) with x centred on the batch mean m in
//    f32 first: a subtraction and two fused multiply-adds an element in
//    place of the plain version's dozen operations and two divisions;
//  - the apply pass of regimes 0-2 visits the chunks in the reverse of the
//    partials pass's order, so it starts on what the partials pass read
//    last, still in the 50 MB L2.
//
// Arithmetic: the elementwise dtype `ew` is f32, or bf16 when LOW (x is
// bf16 under MXTPU_BN_COMPUTE=bf16). LOW repeats the plain version's
// operations one by one, each an _rn intrinsic rounded to bf16 (the
// rounding is the contract there); the f32 mode differs from the plain
// version by the fused multiply-adds and the folding, well inside the f32
// tolerance. The f32 accumulations may differ by their order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

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
constexpr int kMaxCluster = 8;                // CTAs a resident channel
constexpr int kSmemUnroll = 4;                // slots in flight, shared
constexpr int kSmemStatic = 1024;             // resident: static shared, at most
constexpr int kMaxCards = 64;                 // cards a process launches on

// the regimes (launch_geometry's order)
enum Regime { kLast = 0, kVector = 1, kPlanes = 2, kResident = 3 };

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
// The per-element arithmetic, shared by every regime. Per-channel terms come
// from the coefficients of the channel's sums (fwd_finish, bwd_finish).
// ---------------------------------------------------------------------------

// K1 partials: sums of xf = ew(x - s) and xf^2 (the square in f32)
template <bool LOW>
__device__ __forceinline__ void fwd_stats(float x, float s, float& a,
                                          float& b) {
  const float xf = ew<LOW>(__fsub_rn(x, s));
  a += xf;
  b = fmaf(xf, xf, b);
}

// K1 apply, the channel's (s, scale, offset): f32 out = fma(x - s, scale,
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

// K1's per-channel step from the sums s1 (of xf) and s2 (of xf^2): the
// statistics st = (mean, var, inv) and the apply's coefficients in `ew`,
// k = (gamma*inv, beta - mean_c*gamma*inv, the shift in `ew`)
template <bool LOW>
__device__ __forceinline__ void fwd_finish(float s1, float s2, float gamma,
                                           float beta, float shift, float n,
                                           float eps, float (&st)[3],
                                           float (&k)[3]) {
  const float mean_c = __fdiv_rn(s1, n);
  float v = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean_c, mean_c));
  v = v < 0.f ? 0.f : v;  // NaN stays NaN, as in clamp_min
  const float iv = __frsqrt_rn(__fadd_rn(v, eps));
  const float s_ew = ew<LOW>(shift);
  st[0] = __fadd_rn(mean_c, s_ew);
  st[1] = v;
  st[2] = iv;
  k[0] = ew<LOW>(__fmul_rn(gamma, iv));
  k[1] = ew<LOW>(__fsub_rn(beta, __fmul_rn(__fmul_rn(mean_c, gamma), iv)));
  k[2] = s_ew;
}

// The per-channel inputs of K2, either mode; coef: the combine's
// coefficients of regimes 0 and 1 (coef[k * C + c]).
struct BwdArgs {
  const float* coef;
  const float* shift;
  const float* mean;
  const float* inv;
  const float* dmean;
  const float* dvar;
  float n_ew;
};

// K2's per-channel terms. f32 mode: the batch mean m (partials: sums of dy
// and dy * (x - m); apply: dx = fma(a, dy, fma(b, x - m, c)), a, b, c from
// bwd_finish). LOW: the plain version's xf = ew(x - s_ew),
// xhat = ew(ew(xf - mc) * inv_ew), mc = ew(mean - shift) taken in f32
// first; then the plain version's dx step by step. make(p, ch, k): k the
// three coefficients of bwd_finish (the apply), or null (the partials).
template <bool LOW>
struct BwdCoef;
template <>
struct BwdCoef<false> {
  float m, a, b, c;
  __device__ static BwdCoef make(const BwdArgs& p, int ch, const float* k) {
    if (!k) return {p.mean[ch], 0.f, 0.f, 0.f};
    return {p.mean[ch], k[0], k[1], k[2]};
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
  __device__ static BwdCoef make(const BwdArgs& p, int ch, const float* k) {
    BwdCoef r;
    r.s_ew = ew<true>(p.shift[ch]);
    r.mc = ew<true>(__fsub_rn(p.mean[ch], p.shift[ch]));
    r.inv_ew = ew<true>(p.inv[ch]);
    r.n = p.n_ew;
    if (k) {
      r.gi = k[0];
      r.db = k[1];
      r.dg = k[2];
      r.dm_n = p.dmean ? ew<true>(__fdiv_rn(ew<true>(p.dmean[ch]), p.n_ew))
                       : 0.f;
      r.dv2 = p.dvar ? ew<true>(__fmul_rn(ew<true>(p.dvar[ch]), 2.f)) : 0.f;
    } else {
      r.gi = r.db = r.dg = r.dm_n = r.dv2 = 0.f;
    }
    return r;
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

// The terms of channel c with the combine's coefficients from p.coef
// (apply) or without them (partials): regimes 0 and 1.
template <bool LOW>
__device__ __forceinline__ BwdCoef<LOW> bwd_coef(const BwdArgs& p, int C,
                                                 int c, bool apply) {
  if (!apply) return BwdCoef<LOW>::make(p, c, nullptr);
  const float k[3] = {p.coef[c], p.coef[C + c], p.coef[2 * C + c]};
  return BwdCoef<LOW>::make(p, c, k);
}

// K2's per-channel step from the sums db (of dy) and dg (f32: of dy*(x -
// mean); LOW: of dy*xhat): dgamma, dbeta and the apply's coefficients.
// f32 mode: dgamma = inv * dg; dx = a*dy + b*(x - mean) + c with a =
// gamma*inv, b = (2 dvar - a*dgamma*inv)/n, c = (dmean - a*dbeta)/n (folded
// in double), k = (a, b, c). LOW: k = (gamma*inv, dbeta, dgamma) in `ew`.
template <bool LOW>
__device__ __forceinline__ void bwd_finish(float db, float dg, float gamma,
                                           const BwdArgs& p, int c,
                                           float& dgamma, float& dbeta,
                                           float (&k)[3]) {
  const float gi = __fmul_rn(gamma, p.inv[c]);
  if (LOW) {
    dbeta = db;
    dgamma = dg;
    k[0] = ew<LOW>(gi);
    k[1] = ew<LOW>(db);
    k[2] = ew<LOW>(dg);
    return;
  }
  dg = __fmul_rn(p.inv[c], dg);
  dbeta = db;
  dgamma = dg;
  const double n = p.n_ew;
  const double dm = p.dmean ? p.dmean[c] : 0.0;
  const double dv2 = p.dvar ? 2.0 * p.dvar[c] : 0.0;
  k[0] = gi;
  k[1] = (float)((dv2 - (double)gi * dg * p.inv[c]) / n);
  k[2] = (float)((dm - (double)gi * db) / n);
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
// The scalar path: channels last, any C, any alignment
// ---------------------------------------------------------------------------

struct Geom {
  long long rows, rows_per_chunk;
  int c, chunks;
};

// This thread's channel and its rows [r0, r1) of chunk `chunk`, with a step.
struct Slice {
  int c, step;
  long long r0, r1;
  __device__ Slice(const Geom& g, int chunk) {
    const long long start = (long long)chunk * g.rows_per_chunk;
    r1 = start + g.rows_per_chunk < g.rows ? start + g.rows_per_chunk
                                           : g.rows;
    c = blockIdx.x * kTileC + threadIdx.x % kTileC;
    r0 = start + threadIdx.x / kTileC;
    step = kRowLanes;
  }
  __device__ bool active(const Geom& g) const { return c < g.c; }
};

// Visit the slice's elements, kUnroll loads in flight before their use.
template <typename Op>
__device__ __forceinline__ void for_rows(const Geom& g, const Slice& s,
                                         Op& op) {
  if (!s.active(g)) return;
  long long r = s.r0;
  const long long span = (long long)(kUnroll - 1) * s.step;
  for (; r + span < s.r1; r += (long long)kUnroll * s.step) {
    long long off[kUnroll];
    typename Op::In in[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      off[j] = (r + (long long)j * s.step) * g.c + s.c;
      in[j] = op.load(off[j]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) op.use(in[j], off[j]);
  }
  for (; r < s.r1; r += s.step) {
    const long long o = r * g.c + s.c;
    op.use(op.load(o), o);
  }
}

// Sum (a, b) over the CTA's row lanes in a fixed order and write the
// chunk's partials: part[chunk * C + c] and part[(chunks + chunk) * C + c].
__device__ __forceinline__ void write_partials(const Geom& g, const Slice& s,
                                               float a, float b,
                                               float* __restrict__ part) {
  __shared__ float red[2][kThreads];
  float sa = 0.f, sb = 0.f;
  red[0][threadIdx.x] = a;
  red[1][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.x >= kTileC) return;
#pragma unroll
  for (int j = 0; j < kRowLanes; ++j) {
    sa += red[0][j * kTileC + threadIdx.x];
    sb += red[1][j * kTileC + threadIdx.x];
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

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_partials_kernel(Geom g, const T* __restrict__ x,
                           const float* __restrict__ shift,
                           float* __restrict__ part) {
  const Slice s(g, blockIdx.y);
  FwdStats<T, LOW> op{x, s.active(g) ? ew<LOW>(shift[s.c]) : 0.f};
  for_rows(g, s, op);
  write_partials(g, s, op.a, op.b, part);
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

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_apply_kernel(Geom g, const T* __restrict__ x,
                        const float* __restrict__ coef, T* __restrict__ out) {
  const Slice s(g, g.chunks - 1 - (int)blockIdx.y);  // reverse
  if (!s.active(g)) return;
  FwdApply<T, LOW> op{x, out, fwd_coef(coef, g.c, s.c)};
  for_rows(g, s, op);
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

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_partials_kernel(Geom g, const T* __restrict__ x,
                           const T* __restrict__ dy, BwdArgs p,
                           float* __restrict__ part) {
  const Slice s(g, blockIdx.y);
  BwdStats<T, LOW> op{x, dy,
                      bwd_coef<LOW>(p, g.c, s.active(g) ? s.c : 0, false)};
  for_rows(g, s, op);
  write_partials(g, s, op.a, op.b, part);
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

template <typename T, bool LOW>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_apply_kernel(Geom g, const T* __restrict__ x,
                        const T* __restrict__ dy, BwdArgs p,
                        T* __restrict__ dx) {
  const Slice s(g, g.chunks - 1 - (int)blockIdx.y);  // reverse
  if (!s.active(g)) return;
  BwdApply<T, LOW> op{x, dy, dx, bwd_coef<LOW>(p, g.c, s.c, true)};
  for_rows(g, s, op);
}

// ---------------------------------------------------------------------------
// The NCHW path (regimes 2 and 3): channels not last, inner > 1.
//
// Channel c is N = outer planes of `inner` elements, plane n at byte
// (n * C + c) * pb of each tensor (pb = inner * itemsize; every base on 16
// bytes: the wrappers copy a view that is not). A plane is walked as the
// 16-byte slots of its span [floor16(start), ceil16(end)), kc slots a plane
// (the most any plane of the shape needs: pb / 16 when pb % 16 == 0, else
// room for the largest head offset, 16 - gcd(pb, 16) bytes). An "item" is
// one (plane, slot), numbered i = n * kc + k over the channel; a CTA takes
// a range of items (a chunk of the planes regime, a cluster rank's share of
// the resident one) and its thread t the items i0 + t + 256 j, stepping
// (plane, slot) by (qs, rs), 256 = qs * kc + rs: no division but one a
// thread to start. Every load is one aligned 16-byte load. A head or tail
// slot also holds bytes of the neighbouring plane: they are read (an
// aligned 16-byte load stays inside its page and the allocation's granule)
// but neither summed nor written; such a slot is stored element by element,
// a slot past the plane's end not loaded at all. With pb % 16 == 0
// (ALIGNED) every slot is whole: no masks.
// ---------------------------------------------------------------------------

struct PGeom {
  long long items;  // outer * kc: the channel's items
  long long per;    // items a CTA of the channel takes (the last: the rest)
  int c, pb, kc;
  int qs, rs;  // kThreads = qs * kc + rs
  int ctas;    // CTAs a channel: planes' chunks, or the resident cluster
};

struct Cursor {
  long long n;  // plane (image)
  int k;        // slot in the plane
};

__device__ __forceinline__ Cursor cursor_at(long long i, int kc) {
  Cursor u;
  u.n = i / kc;
  u.k = (int)(i - u.n * kc);
  return u;
}

// the item kThreads further on
__device__ __forceinline__ void advance(const PGeom& g, Cursor& u) {
  u.k += g.rs;
  u.n += g.qs;
  if (u.k >= g.kc) {
    u.k -= g.kc;
    ++u.n;
  }
}

// One slot: its byte offset from the base (a multiple of 16) and the
// plane's bytes in it, [lo, hi) (whole: lo <= 0 and hi >= 16; past the
// plane's end: hi <= 0).
struct Item {
  long long off;
  int lo, hi;
};

template <bool ALIGNED>
__device__ __forceinline__ Item item_at(const PGeom& g, int c,
                                        const Cursor& u) {
  const long long start = (u.n * g.c + c) * (long long)g.pb;
  if (ALIGNED) return {start + 16LL * u.k, 0, 16};
  const int head = (int)(start & 15);
  return {start - head + 16LL * u.k, head - 16 * u.k,
          head + g.pb - 16 * u.k};
}

// element v of the slot belongs to the plane
template <typename T, bool ALIGNED>
__device__ __forceinline__ bool in_plane(const Item& it, int v) {
  constexpr int kBytes = (int)sizeof(T);
  return ALIGNED || (it.lo <= v * kBytes && v * kBytes < it.hi);
}

template <bool ALIGNED>
__device__ __forceinline__ uint4 load_slot(const void* base, const Item& it) {
  if (!ALIGNED && it.hi <= 0) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(static_cast<const char*>(base) +
                                         it.off);
}

template <typename T, bool ALIGNED>
__device__ __forceinline__ void store_slot(T* base, const Item& it,
                                           const float (&f)[Pack<T>::N]) {
  char* p = reinterpret_cast<char*>(base) + it.off;
  if (ALIGNED || (it.lo <= 0 && it.hi >= 16)) {
    *reinterpret_cast<uint4*>(p) = Pack<T>::from_f32(f);
    return;
  }
  T* e = reinterpret_cast<T*>(p);
#pragma unroll
  for (int v = 0; v < Pack<T>::N; ++v)
    if (in_plane<T, false>(it, v)) store_elem(e, v, f[v]);
}

// Visit this thread's items of [i0, i1), U loads in flight before their
// use, the last fewer than U too (a small CTA share is all tail):
// op.load(item, slot), op.use(in, item, slot), slot = i - i0 (the item's
// place in a resident CTA's shared memory).
template <int U, bool ALIGNED, typename Op>
__device__ __forceinline__ void for_items(const PGeom& g, int c, long long i0,
                                          long long i1, Op& op) {
  const int t = threadIdx.x;
  const long long left = i1 - i0 - t;
  if (left <= 0) return;
  const int cnt = (int)((left + kThreads - 1) / kThreads);
  Cursor u = cursor_at(i0 + t, g.kc);
  int slot = t;
  int j = 0;
  for (; j + U <= cnt; j += U) {
    Item it[U];
    typename Op::In in[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      it[q] = item_at<ALIGNED>(g, c, u);
      advance(g, u);
    }
#pragma unroll
    for (int q = 0; q < U; ++q) in[q] = op.load(it[q], slot + q * kThreads);
#pragma unroll
    for (int q = 0; q < U; ++q) op.use(in[q], it[q], slot + q * kThreads);
    slot += U * kThreads;
  }
  const int rest = cnt - j;
  if (rest <= 0) return;
  Item it[U];
  typename Op::In in[U];
#pragma unroll
  for (int q = 0; q < U; ++q)
    if (q < rest) {
      it[q] = item_at<ALIGNED>(g, c, u);
      advance(g, u);
    }
#pragma unroll
  for (int q = 0; q < U; ++q)
    if (q < rest) in[q] = op.load(it[q], slot + q * kThreads);
#pragma unroll
  for (int q = 0; q < U; ++q)
    if (q < rest) op.use(in[q], it[q], slot + q * kThreads);
}

// (a, b) summed over the CTA in a fixed order: a shuffle tree in each warp,
// then the warps in order; thread 0 holds the sums.
__device__ __forceinline__ void block_sum(float& a, float& b) {
  __shared__ float red[2][kThreads / 32];
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
  a = 0.f;
  b = 0.f;
  for (int j = 0; j < kThreads / 32; ++j) {
    a += red[0][j];
    b += red[1][j];
  }
}

// The channel's items of CTA `q`: [q * per, min((q + 1) * per, items)).
__device__ __forceinline__ long long items_end(const PGeom& g, long long i0) {
  return i0 + g.per < g.items ? i0 + g.per : g.items;
}

// The per-channel sums of the partials of `chunks` chunks, added by one warp
// in the combine's fixed order: lane l the chunks l, l + 32, ... in order,
// then the lanes in a fixed tree; every lane returns them.
__device__ __forceinline__ void sum_partials_of(int C, int chunks,
                                                const float* __restrict__ part,
                                                int c, float& s1, float& s2) {
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
}

// Resident: the CTA's slots of `src` into shared memory by cp.async (16
// bytes each, no registers held; a slot past its plane's end is left
// unwritten: nothing of it is summed or stored).
template <bool ALIGNED>
struct PCopy {
  using In = int;
  const void* src;
  uint4* dst;
  __device__ int load(const Item& it, int slot) const {
    if (ALIGNED || it.hi > 0) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + slot);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(static_cast<const char*>(src) + it.off)
                   : "memory");
    }
    return 0;
  }
  __device__ void use(int, const Item&, int) const {}
};

// this thread's cp.async copies complete (it reads back only its own)
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, bool LOW, bool ALIGNED, bool KEPT>
struct PFwdStats {
  static constexpr int N = Pack<T>::N;
  using In = uint4;
  const T* x;
  const uint4* kept;  // KEPT: read the slots from here, not from x
  float s, a, b;
  __device__ uint4 load(const Item& it, int slot) const {
    return KEPT ? kept[slot] : load_slot<ALIGNED>(x, it);
  }
  __device__ void use(const uint4& w, const Item& it, int) {
    float f[N];
    Pack<T>::to_f32(w, f);
#pragma unroll
    for (int v = 0; v < N; ++v)
      if (in_plane<T, ALIGNED>(it, v)) fwd_stats<LOW>(f[v], s, a, b);
  }
};

template <typename T, bool LOW, bool ALIGNED, bool KEPT>
struct PFwdApply {
  static constexpr int N = Pack<T>::N;
  using In = uint4;
  const T* x;
  const uint4* kept;  // KEPT: read the slots from here, not from x
  T* out;
  FwdCoef k;
  __device__ uint4 load(const Item& it, int slot) const {
    return KEPT ? kept[slot] : load_slot<ALIGNED>(x, it);
  }
  __device__ void use(const uint4& w, const Item& it, int) const {
    float f[N];
    Pack<T>::to_f32(w, f);
#pragma unroll
    for (int v = 0; v < N; ++v) f[v] = fwd_apply<LOW>(f[v], k);
    store_slot<T, ALIGNED>(out, it, f);
  }
};

template <typename T, bool LOW, bool ALIGNED, bool KEPT>
struct PBwdStats {
  static constexpr int N = Pack<T>::N;
  using In = XDy;
  const T* x;
  const T* dy;
  const uint4* kept_x;  // KEPT: the resident CTA's slots of x and of dy
  const uint4* kept_dy;
  BwdCoef<LOW> k;
  float a, b;
  __device__ XDy load(const Item& it, int slot) const {
    if (KEPT) return {kept_x[slot], kept_dy[slot]};
    return {load_slot<ALIGNED>(x, it), load_slot<ALIGNED>(dy, it)};
  }
  __device__ void use(const XDy& w, const Item& it, int) {
    float fx[N], fd[N];
    Pack<T>::to_f32(w.x, fx);
    Pack<T>::to_f32(w.dy, fd);
#pragma unroll
    for (int v = 0; v < N; ++v)
      if (in_plane<T, ALIGNED>(it, v)) k.stats(fx[v], fd[v], a, b);
  }
};

template <typename T, bool LOW, bool ALIGNED, bool KEPT>
struct PBwdApply {
  static constexpr int N = Pack<T>::N;
  using In = XDy;
  const T* x;
  const T* dy;
  const uint4* kept_x;
  const uint4* kept_dy;
  T* dx;
  BwdCoef<LOW> k;
  __device__ XDy load(const Item& it, int slot) const {
    if (KEPT) return {kept_x[slot], kept_dy[slot]};
    return {load_slot<ALIGNED>(x, it), load_slot<ALIGNED>(dy, it)};
  }
  __device__ void use(const XDy& w, const Item& it, int) const {
    float fx[N], fd[N];
    Pack<T>::to_f32(w.x, fx);
    Pack<T>::to_f32(w.dy, fd);
#pragma unroll
    for (int v = 0; v < N; ++v) fx[v] = k.apply(fx[v], fd[v]);
    store_slot<T, ALIGNED>(dx, it, fx);
  }
};

// The cluster's (a, b): each CTA's sums, in its `sums`, added in rank order
// through distributed shared memory (every CTA of the cluster gets the same
// bits). Called by thread 0 between two cluster barriers.
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cl,
                                            float* sums, float& s1,
                                            float& s2) {
  s1 = 0.f;
  s2 = 0.f;
  for (int r = 0; r < (int)cl.num_blocks(); ++r) {
    const float* p = cl.map_shared_rank(sums, r);
    s1 += p[0];
    s2 += p[1];
  }
}

// K1, resident: grid (C, cluster), cluster (1, cluster); rank r copies the
// channel's items [r * per, ...) into dynamic shared memory (all of its
// copies in flight at once), sums them from there, and normalizes them.
// Two CTAs an SM (launch_geometry sizes the share for it).
template <typename T, bool LOW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2)
    bn_fwd_resident_kernel(PGeom g, const T* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const float* __restrict__ shift,
                           T* __restrict__ out, float* __restrict__ mean,
                           float* __restrict__ var, float* __restrict__ inv,
                           float n, float eps) {
  extern __shared__ uint4 slots[];
  __shared__ float sums[2];
  __shared__ float kk[3];
  cg::cluster_group cl = cg::this_cluster();
  const int c = blockIdx.x;
  const int rank = (int)cl.block_rank();
  const long long i0 = rank * g.per, i1 = items_end(g, i0);
  const PCopy<ALIGNED> cp{x, slots};
  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, cp);
  copies_done();
  PFwdStats<T, LOW, ALIGNED, true> st{x, slots, ew<LOW>(shift[c]), 0.f, 0.f};
  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, st);
  block_sum(st.a, st.b);
  if (threadIdx.x == 0) {
    sums[0] = st.a;
    sums[1] = st.b;
  }
  cl.sync();
  if (threadIdx.x == 0) {
    float s1, s2, stat[3], k[3];
    cluster_sum(cl, sums, s1, s2);
    fwd_finish<LOW>(s1, s2, gamma[c], beta[c], shift[c], n, eps, stat, k);
    if (rank == 0) {
      mean[c] = stat[0];
      var[c] = stat[1];
      inv[c] = stat[2];
    }
    kk[0] = k[0];
    kk[1] = k[1];
    kk[2] = k[2];
  }
  cl.sync();  // kk for every thread; no CTA leaves while its sums are read
  const PFwdApply<T, LOW, ALIGNED, true> ap{x, slots, out,
                                            {kk[2], kk[0], kk[1]}};
  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, ap);
}

// K1, planes: grid (C, chunks); partials part[q * C + c], part[(chunks + q)
// * C + c] of chunk q, as the combine of regimes 0 and 1 reads them.
template <typename T, bool LOW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_planes_partials_kernel(PGeom g, const T* __restrict__ x,
                                  const float* __restrict__ shift,
                                  float* __restrict__ part) {
  const int c = blockIdx.x, q = blockIdx.y;
  const long long i0 = q * g.per, i1 = items_end(g, i0);
  PFwdStats<T, LOW, ALIGNED, false> st{x, nullptr, ew<LOW>(shift[c]), 0.f,
                                       0.f};
  for_items<kFwdVecUnroll, ALIGNED>(g, c, i0, i1, st);
  block_sum(st.a, st.b);
  if (threadIdx.x == 0) {
    part[(long long)q * g.c + c] = st.a;
    part[(long long)(g.ctas + q) * g.c + c] = st.b;
  }
}

// K1, planes: each CTA adds its channel's partials (the combine's order),
// chunk 0's writes the statistics, and all normalize their chunk, in the
// reverse of the partials' order (L2-warm).
template <typename T, bool LOW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_planes_apply_kernel(PGeom g, const T* __restrict__ x,
                               const float* __restrict__ part,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               const float* __restrict__ shift,
                               T* __restrict__ out, float* __restrict__ mean,
                               float* __restrict__ var,
                               float* __restrict__ inv, float n, float eps) {
  __shared__ float kk[3];
  const int c = blockIdx.x;
  const int q = g.ctas - 1 - (int)blockIdx.y;
  if (threadIdx.x < 32) {
    float s1, s2;
    sum_partials_of(g.c, g.ctas, part, c, s1, s2);
    if (threadIdx.x == 0) {
      float stat[3], k[3];
      fwd_finish<LOW>(s1, s2, gamma[c], beta[c], shift[c], n, eps, stat, k);
      if (q == 0) {
        mean[c] = stat[0];
        var[c] = stat[1];
        inv[c] = stat[2];
      }
      kk[0] = k[0];
      kk[1] = k[1];
      kk[2] = k[2];
    }
  }
  __syncthreads();
  const long long i0 = q * g.per, i1 = items_end(g, i0);
  const PFwdApply<T, LOW, ALIGNED, false> ap{x, nullptr, out,
                                             {kk[2], kk[0], kk[1]}};
  for_items<kFwdVecUnroll, ALIGNED>(g, c, i0, i1, ap);
}

// K2, resident: as K1's, with x's slots then dy's in shared memory.
template <typename T, bool LOW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2)
    bn_bwd_resident_kernel(PGeom g, const T* __restrict__ x,
                           const T* __restrict__ dy,
                           const float* __restrict__ gamma, BwdArgs p,
                           T* __restrict__ dx, float* __restrict__ dgamma,
                           float* __restrict__ dbeta) {
  extern __shared__ uint4 slots[];
  __shared__ float sums[2];
  __shared__ float kk[3];
  cg::cluster_group cl = cg::this_cluster();
  const int c = blockIdx.x;
  const int rank = (int)cl.block_rank();
  const long long i0 = rank * g.per, i1 = items_end(g, i0);
  const PCopy<ALIGNED> cpx{x, slots}, cpdy{dy, slots + g.per};
  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, cpx);
  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, cpdy);
  copies_done();
  PBwdStats<T, LOW, ALIGNED, true> st{
      x, dy, slots, slots + g.per, BwdCoef<LOW>::make(p, c, nullptr), 0.f,
      0.f};
  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, st);
  block_sum(st.a, st.b);
  if (threadIdx.x == 0) {
    sums[0] = st.a;
    sums[1] = st.b;
  }
  cl.sync();
  if (threadIdx.x == 0) {
    float s1, s2, dg, db, k[3];
    cluster_sum(cl, sums, s1, s2);
    bwd_finish<LOW>(s1, s2, gamma[c], p, c, dg, db, k);
    if (rank == 0) {
      dgamma[c] = dg;
      dbeta[c] = db;
    }
    kk[0] = k[0];
    kk[1] = k[1];
    kk[2] = k[2];
  }
  cl.sync();
  const float k[3] = {kk[0], kk[1], kk[2]};
  const PBwdApply<T, LOW, ALIGNED, true> ap{
      x, dy, slots, slots + g.per, dx, BwdCoef<LOW>::make(p, c, k)};
  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, ap);
}

template <typename T, bool LOW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_planes_partials_kernel(PGeom g, const T* __restrict__ x,
                                  const T* __restrict__ dy, BwdArgs p,
                                  float* __restrict__ part) {
  const int c = blockIdx.x, q = blockIdx.y;
  const long long i0 = q * g.per, i1 = items_end(g, i0);
  PBwdStats<T, LOW, ALIGNED, false> st{
      x, dy, nullptr, nullptr, BwdCoef<LOW>::make(p, c, nullptr), 0.f, 0.f};
  for_items<kBwdVecUnroll, ALIGNED>(g, c, i0, i1, st);
  block_sum(st.a, st.b);
  if (threadIdx.x == 0) {
    part[(long long)q * g.c + c] = st.a;
    part[(long long)(g.ctas + q) * g.c + c] = st.b;
  }
}

template <typename T, bool LOW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_planes_apply_kernel(PGeom g, const T* __restrict__ x,
                               const T* __restrict__ dy,
                               const float* __restrict__ part,
                               const float* __restrict__ gamma, BwdArgs p,
                               T* __restrict__ dx, float* __restrict__ dgamma,
                               float* __restrict__ dbeta) {
  __shared__ float kk[3];
  const int c = blockIdx.x;
  const int q = g.ctas - 1 - (int)blockIdx.y;
  if (threadIdx.x < 32) {
    float s1, s2;
    sum_partials_of(g.c, g.ctas, part, c, s1, s2);
    if (threadIdx.x == 0) {
      float dg, db, k[3];
      bwd_finish<LOW>(s1, s2, gamma[c], p, c, dg, db, k);
      if (q == 0) {
        dgamma[c] = dg;
        dbeta[c] = db;
      }
      kk[0] = k[0];
      kk[1] = k[1];
      kk[2] = k[2];
    }
  }
  __syncthreads();
  const long long i0 = q * g.per, i1 = items_end(g, i0);
  const float k[3] = {kk[0], kk[1], kk[2]};
  const PBwdApply<T, LOW, ALIGNED, false> ap{
      x, dy, nullptr, nullptr, dx, BwdCoef<LOW>::make(p, c, k)};
  for_items<kBwdVecUnroll, ALIGNED>(g, c, i0, i1, ap);
}

// ---------------------------------------------------------------------------
// The combine passes of regimes 0 and 1: one warp per channel, the channel's
// coefficients into coef[k * C + c].
// ---------------------------------------------------------------------------

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
  const int c = blockIdx.x * kCombineChannels + threadIdx.x / 32;
  if (c >= C) return;
  float s1, s2;
  sum_partials_of(C, chunks, part, c, s1, s2);
  if (threadIdx.x % 32) return;
  float st[3], k[3];
  fwd_finish<LOW>(s1, s2, gamma[c], beta[c], shift[c], n, eps, st, k);
  mean[c] = st[0];
  var[c] = st[1];
  inv[c] = st[2];
  coef[c] = k[0];
  coef[C + c] = k[1];
  coef[2 * C + c] = k[2];
}

// dbeta, dgamma per channel, and dx's coefficients (bwd_finish's k)
template <bool LOW>
__global__ void __launch_bounds__(kCombineThreads)
    bn_bwd_combine_kernel(int C, int chunks, const float* __restrict__ part,
                          const float* __restrict__ gamma, BwdArgs p,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta,
                          float* __restrict__ coef) {
  const int c = blockIdx.x * kCombineChannels + threadIdx.x / 32;
  if (c >= C) return;
  float db, dg;
  sum_partials_of(C, chunks, part, c, db, dg);
  if (threadIdx.x % 32) return;
  float k[3];
  bwd_finish<LOW>(db, dg, gamma[c], p, c, dgamma[c], dbeta[c], k);
  coef[c] = k[0];
  coef[C + c] = k[1];
  coef[2 * C + c] = k[2];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool all_aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

// What each regime needs (a call that asks for one elsewhere is refused,
// not run): vector, channels last, whole 16-byte lanes per row, every base
// on 16 bytes (then every row starts on 16 bytes); last, channels last;
// planes and resident, channels not last and every base on 16 bytes.
bool regime_refused(int regime, const void* const* ptrs, int n, int c,
                    long long inner, int chunks, int x_bf16) {
  switch (regime) {
    case kLast:
      return inner != 1;
    case kVector:
      return inner != 1 || c % (x_bf16 ? 8 : 4) || !all_aligned16(ptrs, n);
    case kPlanes:
      return inner < 2 || !all_aligned16(ptrs, n);
    case kResident:
      return inner < 2 || chunks > kMaxCluster || !all_aligned16(ptrs, n);
    default:
      return true;
  }
}

Geom make_geom(long long outer, int c, int chunks) {
  Geom g;
  g.rows = outer;
  g.c = c;
  g.chunks = chunks;
  g.rows_per_chunk = (g.rows + chunks - 1) / chunks;
  return g;
}

dim3 grid_of(const Geom& g) {
  return dim3((g.c + kTileC - 1) / kTileC, g.chunks);
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

// 16-byte slots a plane of pb bytes needs at most (norm.py:plane_slots)
long long plane_slots(long long pb) {
  if (pb % 16 == 0) return pb / 16;
  const long long low = pb & -pb;  // gcd(pb, 16): pb % 16 != 0
  return (pb + 16 - low + 15) / 16;
}

// false when a CTA's items would not fit an int
bool make_pgeom(long long outer, int c, long long inner, int esize,
                int ctas, PGeom& g) {
  const long long pb = inner * esize;
  if (pb >= (1LL << 30)) return false;
  g.c = c;
  g.pb = (int)pb;
  g.kc = (int)plane_slots(pb);
  g.qs = kThreads / g.kc;
  g.rs = kThreads % g.kc;
  g.items = outer * g.kc;
  g.ctas = ctas;
  g.per = (g.items + ctas - 1) / ctas;
  return g.per < (1LL << 30);
}

// A resident kernel's dynamic shared memory limit on each card: 0 until
// its first launch there, then the card's opt-in maximum less kSmemStatic
// (static storage: zero before the first launch).
struct SmemLimit {
  std::atomic<int> bytes[kMaxCards];
};

// Raises `kernel`'s limit on the current card once, at its first launch
// there, and refuses `bytes` past it.
cudaError_t allow_smem(SmemLimit& limit, const void* kernel,
                       long long bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxCards) return cudaErrorInvalidDevice;
  int most = limit.bytes[dev].load(std::memory_order_acquire);
  if (!most) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - kSmemStatic);
    if (err != cudaSuccess) return err;
    most = optin - kSmemStatic;
    limit.bytes[dev].store(most, std::memory_order_release);
  }
  return bytes > most ? cudaErrorInvalidValue : cudaSuccess;
}

// One launch of grid (C, cluster) in clusters of (1, cluster).
template <typename... Exp, typename... Act>
cudaError_t launch_cluster(SmemLimit& limit, void (*kernel)(Exp...),
                           const PGeom& g, long long smem, cudaStream_t st,
                           Act&&... args) {
  const cudaError_t err = allow_smem(limit, (const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.c, g.ctas, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = g.ctas;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
}

template <typename T, bool LOW, bool A>
cudaError_t fwd_nchw(const PGeom& g, int regime, const T* x,
                     const float* gamma, const float* beta,
                     const float* shift, T* out, float* mean, float* var,
                     float* inv, float* part, float n, float eps,
                     cudaStream_t st) {
  static SmemLimit limit;
  if (regime == kResident)
    return launch_cluster(limit, bn_fwd_resident_kernel<T, LOW, A>, g,
                          g.per * 16, st, g, x, gamma, beta, shift, out, mean,
                          var, inv, n, eps);
  const dim3 grid(g.c, g.ctas);
  bn_fwd_planes_partials_kernel<T, LOW, A>
      <<<grid, kThreads, 0, st>>>(g, x, shift, part);
  bn_fwd_planes_apply_kernel<T, LOW, A><<<grid, kThreads, 0, st>>>(
      g, x, part, gamma, beta, shift, out, mean, var, inv, n, eps);
  return cudaGetLastError();
}

template <typename T, bool LOW, bool A>
cudaError_t bwd_nchw(const PGeom& g, int regime, const T* x, const T* dy,
                     const float* gamma, const BwdArgs& p, T* dx,
                     float* dgamma, float* dbeta, float* part,
                     cudaStream_t st) {
  static SmemLimit limit;
  if (regime == kResident)
    return launch_cluster(limit, bn_bwd_resident_kernel<T, LOW, A>, g,
                          2 * g.per * 16, st, g, x, dy, gamma, p, dx, dgamma,
                          dbeta);
  const dim3 grid(g.c, g.ctas);
  bn_bwd_planes_partials_kernel<T, LOW, A>
      <<<grid, kThreads, 0, st>>>(g, x, dy, p, part);
  bn_bwd_planes_apply_kernel<T, LOW, A><<<grid, kThreads, 0, st>>>(
      g, x, dy, part, gamma, p, dx, dgamma, dbeta);
  return cudaGetLastError();
}

template <typename T, bool LOW>
cudaError_t fwd(long long outer, int c, long long inner, int chunks,
                int regime, const void* x, const float* gamma,
                const float* beta, const float* shift, void* out,
                float* mean, float* var, float* inv, float* work, float n,
                float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (regime == kPlanes || regime == kResident) {
    PGeom pg;
    if (!make_pgeom(outer, c, inner, sizeof(T), chunks, pg))
      return cudaErrorInvalidValue;
    if (pg.pb % 16 == 0)
      return fwd_nchw<T, LOW, true>(pg, regime, xp, gamma, beta, shift, op,
                                    mean, var, inv, work, n, eps, st);
    return fwd_nchw<T, LOW, false>(pg, regime, xp, gamma, beta, shift, op,
                                   mean, var, inv, work, n, eps, st);
  }
  const Geom g = make_geom(outer, c, chunks);
  float* coef = work + 2LL * g.chunks * g.c;
  VGeom v;
  const bool vec = regime == kVector;
  if (vec && !make_vgeom(g, sizeof(T) == 2, v)) return cudaErrorInvalidValue;
  if (vec)
    bn_fwd_partials_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, shift, work);
  else
    bn_fwd_partials_kernel<T, LOW>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, shift, work);
  bn_fwd_combine_kernel<LOW><<<combine_grid(g.c), kCombineThreads, 0, st>>>(
      g.c, g.chunks, work, gamma, beta, shift, n, eps, mean, var, inv, coef);
  if (vec)
    bn_fwd_apply_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, coef, op);
  else
    bn_fwd_apply_kernel<T, LOW>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, coef, op);
  return cudaGetLastError();
}

template <typename T, bool LOW>
cudaError_t bwd(long long outer, int c, long long inner, int chunks,
                int regime, const void* x, const void* dy,
                const float* gamma, BwdArgs p, void* dx, float* dgamma,
                float* dbeta, float* work, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  if (regime == kPlanes || regime == kResident) {
    PGeom pg;
    if (!make_pgeom(outer, c, inner, sizeof(T), chunks, pg))
      return cudaErrorInvalidValue;
    if (pg.pb % 16 == 0)
      return bwd_nchw<T, LOW, true>(pg, regime, xp, dyp, gamma, p, dxp,
                                    dgamma, dbeta, work, st);
    return bwd_nchw<T, LOW, false>(pg, regime, xp, dyp, gamma, p, dxp, dgamma,
                                   dbeta, work, st);
  }
  const Geom g = make_geom(outer, c, chunks);
  float* coef = work + 2LL * g.chunks * g.c;
  p.coef = coef;
  VGeom v;
  const bool vec = regime == kVector;
  if (vec && !make_vgeom(g, sizeof(T) == 2, v)) return cudaErrorInvalidValue;
  if (vec)
    bn_bwd_partials_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, dyp, p, work);
  else
    bn_bwd_partials_kernel<T, LOW>
        <<<grid_of(g), kThreads, 0, st>>>(g, xp, dyp, p, work);
  bn_bwd_combine_kernel<LOW><<<combine_grid(g.c), kCombineThreads, 0, st>>>(
      g.c, g.chunks, work, gamma, p, dgamma, dbeta, coef);
  if (vec)
    bn_bwd_apply_vec_kernel<T, LOW>
        <<<vgrid_of(v), kThreads, 0, st>>>(v, xp, dyp, p, dxp);
  else
    bn_bwd_apply_kernel<T, LOW>
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
// work: f32 scratch of (2 * chunks + 4) * C. regime: launch_geometry's
// (0 last, 1 vector, 2 planes, 3 resident; cudaErrorInvalidValue where it
// cannot run); chunks: its chunks (resident: the cluster's CTAs). ew_low:
// the elementwise dtype is bf16 (x must be bf16). n: elements per channel.
// Returns the cudaError_t of the launches (0 on success).
int mxtpu_bn_train_fwd(const void* x, const void* gamma, const void* beta,
                       const void* shift, void* out, void* mean, void* var,
                       void* inv, void* work, long long outer, int c,
                       long long inner, int chunks, int regime, int x_bf16,
                       int ew_low, float n, float eps, void* stream) {
  const void* ptrs[2] = {x, out};
  if (bad_geometry(outer, c, inner, chunks, x_bf16, ew_low) || !x ||
      !gamma || !beta || !shift || !out || !mean || !var || !inv || !work ||
      regime_refused(regime, ptrs, 2, c, inner, chunks, x_bf16))
    return (int)cudaErrorInvalidValue;
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
    err = fwd<float, false>(outer, c, inner, chunks, regime, x, ga, be, sh,
                            out, m, v, iv, w, n, eps, st);
  else if (!ew_low)
    err = fwd<__nv_bfloat16, false>(outer, c, inner, chunks, regime, x, ga,
                                    be, sh, out, m, v, iv, w, n, eps, st);
  else
    err = fwd<__nv_bfloat16, true>(outer, c, inner, chunks, regime, x, ga, be,
                                   sh, out, m, v, iv, w, n, eps, st);
  return (int)err;
}

// K2. x, dy: (outer, C, inner) in x's dtype; gamma, mean, inv, shift: f32
// (C,); dmean, dvar: f32 (C,) cotangents of the batch statistics, or null
// for zeros. Writes dx (x's dtype and shape), dgamma, dbeta (f32 (C,)).
// work: f32 scratch of (2 * chunks + 4) * C. regime, chunks: as for K1.
// n_ew: the elements per channel as the elementwise dtype holds the number.
// Returns the cudaError_t of the launches.
int mxtpu_bn_train_bwd(const void* x, const void* dy, const void* gamma,
                       const void* mean, const void* inv, const void* shift,
                       const void* dmean, const void* dvar, void* dx,
                       void* dgamma, void* dbeta, void* work, long long outer,
                       int c, long long inner, int chunks, int regime,
                       int x_bf16, int ew_low, float n_ew, void* stream) {
  const void* ptrs[3] = {x, dy, dx};
  if (bad_geometry(outer, c, inner, chunks, x_bf16, ew_low) || !x || !dy ||
      !gamma || !mean || !inv || !shift || !dx || !dgamma || !dbeta ||
      !work || regime_refused(regime, ptrs, 3, c, inner, chunks, x_bf16))
    return (int)cudaErrorInvalidValue;
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
    err = bwd<float, false>(outer, c, inner, chunks, regime, x, dy, ga, p, dx,
                            dga, dbe, w, st);
  else if (!ew_low)
    err = bwd<__nv_bfloat16, false>(outer, c, inner, chunks, regime, x, dy,
                                    ga, p, dx, dga, dbe, w, st);
  else
    err = bwd<__nv_bfloat16, true>(outer, c, inner, chunks, regime, x, dy, ga,
                                   p, dx, dga, dbe, w, st);
  return (int)err;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
