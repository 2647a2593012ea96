// BatchNorm training, forward (K1) and backward (K2), for Hopper (sm_90a),
// CUDA C++ with a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/kernels/norm.py).
//
// Replaces the TPU kernels mxnet_tpu/kernels/norm.py:_fwd_kernel (:112,
// launched by _fwd_pallas :157) and _bwd_kernel (:202, launched by
// _bwd_pallas :245). The plain versions, whose arithmetic these kernels
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
// No atomics: a shape always sums in the same order, and the bits repeat
// from run to run. The chunking depends on the shape alone (norm.py:
// launch_geometry).
//
// Channels last (inner == 1): a CTA takes 32 consecutive channels and 8 rows
// at a time, a warp reading 32 consecutive elements of one row. Otherwise a
// CTA takes one channel and its 256 threads walk consecutive positions of
// the inner axis. Each thread issues 8 independent loads before it uses
// them, which keeps enough bytes in flight to approach the memory rate.
//
// Bound on this card: bytes. K1 reads x twice (partials, apply) and writes
// out once; K2 reads x and dy twice and writes dx once. The per-channel
// partials are a few KB. Making the passes fast (16-byte vector loads, one
// pass that keeps x in shared memory when a chunk fits) is later work.
//
// Arithmetic: the elementwise dtype `ew` is f32, or bf16 when LOW (x is
// bf16 under MXTPU_BN_COMPUTE=bf16). Every elementwise operation of the
// plain version is one _rn intrinsic here, its result rounded to `ew`, so
// that the compiler contracts nothing into a fused multiply-add the plain
// version does not have; only the f32 accumulations may differ, by their
// order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 32;                    // channels/CTA, channels last
constexpr int kRowLanes = kThreads / kTileC;  // rows in flight, same
constexpr int kUnroll = 8;                    // loads in flight per thread
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

// This thread's channel and its rows [r0, r1) with a step.
template <bool LAST>
struct Slice {
  int c, step;
  long long r0, r1;
  __device__ explicit Slice(const Geom& g) {
    const long long start = (long long)blockIdx.y * g.rows_per_chunk;
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

// The combine passes: one warp per channel. Lane l adds the partials of
// chunks l, l + 32, ... in order, then the warp adds its lanes in a fixed
// tree; every lane returns the channel's two sums, or false past the last
// channel.
__device__ __forceinline__ bool sum_partials(const Geom& g,
                                             const float* __restrict__ part,
                                             int& c, float& s1, float& s2) {
  c = blockIdx.x * kCombineChannels + threadIdx.x / 32;
  if (c >= g.c) return false;
  s1 = 0.f;
  s2 = 0.f;
  for (int k = threadIdx.x % 32; k < g.chunks; k += 32) {
    s1 += part[(long long)k * g.c + c];
    s2 += part[(long long)(g.chunks + k) * g.c + c];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, d);
    s2 += __shfl_xor_sync(0xffffffffu, s2, d);
  }
  return true;
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

// sums of xf = ew(x - shift) and xf^2 (the square in f32)
template <typename T, bool LOW>
struct FwdStats {
  using In = float;
  const T* __restrict__ x;
  float shift, a = 0.f, b = 0.f;
  __device__ float load(long long o) const { return load_elem(x, o); }
  __device__ void use(float v, long long) {
    const float xf = ew<LOW>(__fsub_rn(v, shift));
    a += xf;
    b = fmaf(xf, xf, b);
  }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_partials_kernel(Geom g, const T* __restrict__ x,
                           const float* __restrict__ shift,
                           float* __restrict__ part) {
  const Slice<LAST> s(g);
  FwdStats<T, LOW> op{x, s.active(g) ? ew<LOW>(shift[s.c]) : 0.f};
  for_rows<LAST>(g, s, op);
  write_partials<LAST>(g, s, op.a, op.b, part);
}

// mean, var, inv per channel, and the normalize's coefficients in `ew`:
// coef[c] = gamma*inv, coef[C + c] = beta - mean_c*gamma*inv,
// coef[2C + c] = the shift in `ew`
template <bool LOW>
__global__ void __launch_bounds__(kCombineThreads)
    bn_fwd_combine_kernel(Geom g, const float* __restrict__ part,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const float* __restrict__ shift, float n, float eps,
                          float* __restrict__ mean, float* __restrict__ var,
                          float* __restrict__ inv, float* __restrict__ coef) {
  int c;
  float s1, s2;
  if (!sum_partials(g, part, c, s1, s2) || threadIdx.x % 32) return;
  const float mean_c = __fdiv_rn(s1, n);
  float v = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean_c, mean_c));
  v = v < 0.f ? 0.f : v;  // NaN stays NaN, as in clamp_min
  const float iv = __frsqrt_rn(__fadd_rn(v, eps));
  const float s_ew = ew<LOW>(shift[c]);
  mean[c] = __fadd_rn(mean_c, s_ew);
  var[c] = v;
  inv[c] = iv;
  coef[c] = ew<LOW>(__fmul_rn(gamma[c], iv));
  coef[g.c + c] =
      ew<LOW>(__fsub_rn(beta[c], __fmul_rn(__fmul_rn(mean_c, gamma[c]), iv)));
  coef[2 * g.c + c] = s_ew;
}

// out = ew(ew(xf * scale) + offset), cast to x's dtype
template <typename T, bool LOW>
struct FwdApply {
  using In = float;
  const T* __restrict__ x;
  T* __restrict__ out;
  float shift, scale, off;
  __device__ float load(long long o) const { return load_elem(x, o); }
  __device__ void use(float v, long long o) {
    const float xf = ew<LOW>(__fsub_rn(v, shift));
    const float y = ew<LOW>(__fmul_rn(xf, scale));
    store_elem(out, o, ew<LOW>(__fadd_rn(y, off)));
  }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_apply_kernel(Geom g, const T* __restrict__ x,
                        const float* __restrict__ coef, T* __restrict__ out) {
  const Slice<LAST> s(g);
  if (!s.active(g)) return;
  FwdApply<T, LOW> op{x, out, coef[2 * g.c + s.c], coef[s.c],
                      coef[g.c + s.c]};
  for_rows<LAST>(g, s, op);
}

// ---------------------------------------------------------------------------
// K2: backward
// ---------------------------------------------------------------------------

// Per-channel terms both backward passes recompute x-hat from:
// xf = ew(x - s_ew), xhat = ew(ew(xf - mc) * inv_ew), with
// mc = ew(mean - shift) taken in f32 first.
struct Centre {
  float s_ew, mc, inv_ew;
};

template <bool LOW>
__device__ __forceinline__ Centre centre(const float* __restrict__ shift,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ inv,
                                         int c) {
  return {ew<LOW>(shift[c]), ew<LOW>(__fsub_rn(mean[c], shift[c])),
          ew<LOW>(inv[c])};
}

// sums of dy and ew(dy * xhat)
template <typename T, bool LOW>
struct BwdStats {
  using In = float2;
  const T* __restrict__ x;
  const T* __restrict__ dy;
  Centre k;
  float a = 0.f, b = 0.f;
  __device__ float2 load(long long o) const {
    return make_float2(load_elem(x, o), load_elem(dy, o));
  }
  __device__ void use(float2 v, long long) {
    const float xf = ew<LOW>(__fsub_rn(v.x, k.s_ew));
    const float xhat = ew<LOW>(__fmul_rn(ew<LOW>(__fsub_rn(xf, k.mc)),
                                         k.inv_ew));
    a += v.y;
    b += ew<LOW>(__fmul_rn(v.y, xhat));
  }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_partials_kernel(Geom g, const T* __restrict__ x,
                           const T* __restrict__ dy,
                           const float* __restrict__ shift,
                           const float* __restrict__ mean,
                           const float* __restrict__ inv,
                           float* __restrict__ part) {
  const Slice<LAST> s(g);
  BwdStats<T, LOW> op{x, dy, s.active(g) ? centre<LOW>(shift, mean, inv, s.c)
                                         : Centre{0.f, 0.f, 0.f}};
  for_rows<LAST>(g, s, op);
  write_partials<LAST>(g, s, op.a, op.b, part);
}

// dbeta, dgamma per channel, and dx's coefficients in `ew`:
// coef[c] = gamma*inv, coef[C + c] = dbeta, coef[2C + c] = dgamma
template <bool LOW>
__global__ void __launch_bounds__(kCombineThreads)
    bn_bwd_combine_kernel(Geom g, const float* __restrict__ part,
                          const float* __restrict__ gamma,
                          const float* __restrict__ inv,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta,
                          float* __restrict__ coef) {
  int c;
  float db, dg;
  if (!sum_partials(g, part, c, db, dg) || threadIdx.x % 32) return;
  dbeta[c] = db;
  dgamma[c] = dg;
  coef[c] = ew<LOW>(__fmul_rn(gamma[c], inv[c]));
  coef[g.c + c] = ew<LOW>(db);
  coef[2 * g.c + c] = ew<LOW>(dg);
}

// dx = ew(gi * ew(dy - ew(ew(db + ew(xhat * dg)) / n)))
//    + ew(ew(dmean / n) + ew(ew(ew(2 dvar) * ew(xf - mc)) / n))
template <typename T, bool LOW>
struct BwdApply {
  using In = float2;
  const T* __restrict__ x;
  const T* __restrict__ dy;
  T* __restrict__ dx;
  Centre k;
  float gi, db, dg, n, dm_n, dv2;
  __device__ float2 load(long long o) const {
    return make_float2(load_elem(x, o), load_elem(dy, o));
  }
  __device__ void use(float2 v, long long o) {
    const float xf = ew<LOW>(__fsub_rn(v.x, k.s_ew));
    const float xc = ew<LOW>(__fsub_rn(xf, k.mc));
    const float xhat = ew<LOW>(__fmul_rn(xc, k.inv_ew));
    float t = ew<LOW>(__fmul_rn(xhat, dg));
    t = ew<LOW>(__fadd_rn(db, t));
    t = ew<LOW>(__fdiv_rn(t, n));
    t = ew<LOW>(__fsub_rn(v.y, t));
    t = ew<LOW>(__fmul_rn(gi, t));
    float u = ew<LOW>(__fmul_rn(dv2, xc));
    u = ew<LOW>(__fdiv_rn(u, n));
    u = ew<LOW>(__fadd_rn(dm_n, u));
    store_elem(dx, o, ew<LOW>(__fadd_rn(t, u)));
  }
};

template <typename T, bool LOW, bool LAST>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_apply_kernel(Geom g, const T* __restrict__ x,
                        const T* __restrict__ dy,
                        const float* __restrict__ shift,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const float* __restrict__ dmean,
                        const float* __restrict__ dvar,
                        const float* __restrict__ coef, float n_ew,
                        T* __restrict__ dx) {
  const Slice<LAST> s(g);
  if (!s.active(g)) return;
  const int c = s.c;
  const float dm_n =
      dmean ? ew<LOW>(__fdiv_rn(ew<LOW>(dmean[c]), n_ew)) : 0.f;
  const float dv2 = dvar ? ew<LOW>(__fmul_rn(ew<LOW>(dvar[c]), 2.f)) : 0.f;
  BwdApply<T, LOW> op{x,       dy,           dx,
                      centre<LOW>(shift, mean, inv, c),
                      coef[c], coef[g.c + c], coef[2 * g.c + c],
                      n_ew,    dm_n,          dv2};
  for_rows<LAST>(g, s, op);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

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

template <typename T, bool LOW, bool LAST>
void fwd(const Geom& g, const void* x, const float* gamma, const float* beta,
         const float* shift, void* out, float* mean, float* var, float* inv,
         float* work, float n, float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  float* coef = work + 2LL * g.chunks * g.c;
  bn_fwd_partials_kernel<T, LOW, LAST>
      <<<grid_of(g), kThreads, 0, st>>>(g, xp, shift, work);
  bn_fwd_combine_kernel<LOW>
      <<<(g.c + kCombineChannels - 1) / kCombineChannels, kCombineThreads,
         0, st>>>(g, work, gamma, beta, shift, n, eps, mean, var, inv, coef);
  bn_fwd_apply_kernel<T, LOW, LAST>
      <<<grid_of(g), kThreads, 0, st>>>(g, xp, coef, static_cast<T*>(out));
}

template <typename T, bool LOW, bool LAST>
void bwd(const Geom& g, const void* x, const void* dy, const float* gamma,
         const float* mean, const float* inv, const float* shift,
         const float* dmean, const float* dvar, void* dx, float* dgamma,
         float* dbeta, float* work, float n_ew, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  float* coef = work + 2LL * g.chunks * g.c;
  bn_bwd_partials_kernel<T, LOW, LAST>
      <<<grid_of(g), kThreads, 0, st>>>(g, xp, dyp, shift, mean, inv, work);
  bn_bwd_combine_kernel<LOW>
      <<<(g.c + kCombineChannels - 1) / kCombineChannels, kCombineThreads,
         0, st>>>(g, work, gamma, inv, dgamma, dbeta, coef);
  bn_bwd_apply_kernel<T, LOW, LAST><<<grid_of(g), kThreads, 0, st>>>(
      g, xp, dyp, shift, mean, inv, dmean, dvar, coef, n_ew,
      static_cast<T*>(dx));
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
// work: f32 scratch of (2 * chunks + 3) * C. ew_low: the elementwise dtype
// is bf16 (x must be bf16). n: rows per channel. Returns the cudaError_t of
// the launches (0 on success).
int mxtpu_bn_train_fwd(const void* x, const void* gamma, const void* beta,
                       const void* shift, void* out, void* mean, void* var,
                       void* inv, void* work, long long outer, int c,
                       long long inner, int chunks, int x_bf16, int ew_low,
                       float n, float eps, void* stream) {
  if (bad_geometry(outer, c, inner, chunks, x_bf16, ew_low) || !x ||
      !gamma || !beta || !shift || !out || !mean || !var || !inv || !work)
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
  const bool last = inner == 1;
#define MXTPU_BN_FWD(T, LOW)                                                \
  (last ? fwd<T, LOW, true>(g, x, ga, be, sh, out, m, v, iv, w, n, eps, st) \
        : fwd<T, LOW, false>(g, x, ga, be, sh, out, m, v, iv, w, n, eps, st))
  if (!x_bf16)
    MXTPU_BN_FWD(float, false);
  else if (!ew_low)
    MXTPU_BN_FWD(__nv_bfloat16, false);
  else
    MXTPU_BN_FWD(__nv_bfloat16, true);
#undef MXTPU_BN_FWD
  return (int)cudaGetLastError();
}

// K2. x, dy: (outer, C, inner) in x's dtype; gamma, mean, inv, shift: f32
// (C,); dmean, dvar: f32 (C,) cotangents of the batch statistics, or null
// for zeros. Writes dx (x's dtype and shape), dgamma, dbeta (f32 (C,)).
// work: f32 scratch of (2 * chunks + 3) * C. n_ew: the rows per channel as
// the elementwise dtype holds the number. Returns the cudaError_t of the
// launches.
int mxtpu_bn_train_bwd(const void* x, const void* dy, const void* gamma,
                       const void* mean, const void* inv, const void* shift,
                       const void* dmean, const void* dvar, void* dx,
                       void* dgamma, void* dbeta, void* work, long long outer,
                       int c, long long inner, int chunks, int x_bf16,
                       int ew_low, float n_ew, void* stream) {
  if (bad_geometry(outer, c, inner, chunks, x_bf16, ew_low) || !x || !dy ||
      !gamma || !mean || !inv || !shift || !dx || !dgamma || !dbeta || !work)
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(outer, c, inner, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sh = static_cast<const float*>(shift);
  const float* dm = static_cast<const float*>(dmean);
  const float* dv = static_cast<const float*>(dvar);
  float* dga = static_cast<float*>(dgamma);
  float* dbe = static_cast<float*>(dbeta);
  float* w = static_cast<float*>(work);
  const bool last = inner == 1;
#define MXTPU_BN_BWD(T, LOW)                                                 \
  (last ? bwd<T, LOW, true>(g, x, dy, ga, m, iv, sh, dm, dv, dx, dga, dbe, w, \
                            n_ew, st)                                         \
        : bwd<T, LOW, false>(g, x, dy, ga, m, iv, sh, dm, dv, dx, dga, dbe,   \
                             w, n_ew, st))
  if (!x_bf16)
    MXTPU_BN_BWD(float, false);
  else if (!ew_low)
    MXTPU_BN_BWD(__nv_bfloat16, false);
  else
    MXTPU_BN_BWD(__nv_bfloat16, true);
#undef MXTPU_BN_BWD
  return (int)cudaGetLastError();
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
