// Fused optimizer ladder for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by mxnet_tpu_torch/kernels/opt.py).
//
// Replaces the TPU kernel mxnet_tpu/kernels/opt.py:_ladder_kernel (launched
// by _ladder_pallas, pl.pallas_call at :176). One elementwise pass over
// every parameter of a bucket, in the order of Optimizer._fused_param_step:
//   g (-> f32 under multi-precision) * rescale -> * global-norm scale ->
//   clip -> rule (SGD, NAG, Signum, Adam, AdamW) -> new master / weight,
//   new state leaves, and under multi-precision the bf16 weight copy.
// All math is f32. The multiplies and adds are written with the _rn
// intrinsics so that the compiler does not contract them into fused
// multiply-adds: the plain PyTorch version rounds after every operation, and
// the two then agree to the last bit on the same card.
//
// IN PLACE: the kernel overwrites the master (or f32 weight), every state
// leaf and the low-precision weight. This is the port's form of the JAX
// package's buffer donation; the gradient is only read.
//
// ONE LAUNCH PER BUCKET (the reference's one jit per bucket,
// mxnet_tpu/optimizer/optimizer.py:_fused_jitted, its multi-tensor-apply
// analog). A bucket is one rule, one gradient dtype and one state count;
// its tensors travel in a table passed BY VALUE as the kernel's parameter
// (__grid_constant__, up to kMaxEntries tensors in 31 KB of the 32 764
// bytes sm_90 takes since CUDA 12.1): nothing is allocated or copied from
// the host, and the launch stays capturable in a CUDA graph. A longer list
// is split by the wrapper into as many launches as it needs. Each entry
// carries its pointers, its size, whether all its pointers are 16-byte
// aligned, the first chunk it owns, and every scalar that depends on its
// own lr, wd or update count (lr, wd, 1 - beta1^t, 1 - beta2^t, Adam's
// lr_t, Signum's lr * wd_lh). The wrapper computes those on the host in
// f32 exactly as the per-parameter entry point of the first port did
// (libm's powf, then f32 products): each element's result is bit for bit
// that kernel's for the same scalars.
//
// Work split: every tensor is cut into chunks of kChunk elements, one CTA
// a chunk; a CTA finds its tensor by a binary search over the entries'
// first chunks, uniform across the CTA. BERT-base's 110 M elements make
// 13 500 CTAs (several waves of 132 SMs), and a 768-element bias is one
// chunk of a launch instead of a launch of its own.
//
// Bound on this card: bytes. The gradient is read once, the master and each
// state leaf are read and written once, the bf16 weight is written once, and
// the f32 gradient never exists in device memory. AdamW under
// multi-precision moves 28 bytes per element (g 2, master 4 + 4, m and v
// 8 + 8, weight 2). Each thread moves two groups of four elements at a time
// with 16-byte (f32) and 8-byte (bf16) accesses, all loads of both groups
// issued before the math; at eight 256-thread CTAs an SM that keeps over
// 100 KB in flight an SM. A tensor whose pointers are not all 16-byte
// aligned, and the last < 4 elements of a tensor, take the scalar path in
// the same kernel (a branch uniform per CTA).
//
// A second entry point, for launches captured in a CUDA graph
// (gluon.TrainStep): the table keeps only what a replay may not change
// (pointers, sizes, first chunks, alignment flags) by value, and the
// per-tensor scalars and rescale are read from a small f32 buffer in device
// memory, kScalarStride floats an entry (lr, wd, 1 - beta1^t, 1 - beta2^t,
// lr_t, c1, rescale, unused), which the host refills before each replay. The
// values are the ones the by-value entry would carry, so the two entries
// give the same bits.
//
// The global-norm pre-pass of clip_global_norm is here too, over the same
// table: sum over the bucket of (g (-> f32) * rescale)^2 in f32, what
// Optimizer._fused_sqnorm and the reference's _fused_norm_jitted compute.
// kNormBlocks CTAs stride over the chunks and each writes one f32 partial
// through a fixed-order shuffle tree; a one-CTA finish sums the partials in
// a fixed order into the bucket's f32. No atomics: two runs give the same
// bits. Bound: bytes (the gradient read once).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Rule { kSGD = 0, kNAG = 1, kSignum = 2, kAdam = 3, kAdamW = 4 };

constexpr int kThreads = 256;
constexpr int kChunk = 8192;        // elements of one tensor per CTA
constexpr int kUnroll = 2;          // groups of four a thread loads at once
constexpr int kMaxEntries = 384;    // tensors per launch
constexpr int kNormBlocks = 1024;   // CTAs (and partials) of a norm launch
constexpr int kScalarStride = 8;    // floats an entry in the scalar buffer

struct Ladder {
  int rule;
  int has_state;  // SGD / NAG / Signum: a momentum leaf exists
  int gn;         // multiply by the global-norm scale
  int clip_on;    // clip to [-clip, clip]
  float lr, wd, rescale, gscale, clip;
  float h0;    // momentum (SGD, NAG, Signum) or beta1 (Adam, AdamW)
  float h1;    // beta2
  float eps;   // Adam / AdamW epsilon
  float c0;    // Signum: 1 - momentum; Adam, AdamW: 1 - beta1
  float c1;    // Signum: lr * wd_lh;   Adam, AdamW: 1 - beta2
  float b1c;   // 1 - beta1^t
  float b2c;   // 1 - beta2^t
  float lr_t;  // Adam: lr * sqrt(1 - beta2^t) / (1 - beta1^t)
};

// One tensor of a launch. The layout is kernels/opt.py's ENTRY dtype.
struct Entry {
  float* w;                // f32 master (multi-precision) or f32 weight
  const void* g;           // gradient: bf16 under multi-precision, else f32
  float* s0;               // state leaves, null when unused
  float* s1;
  __nv_bfloat16* w_lp;     // bf16 weight under multi-precision, else null
  long long n;             // elements
  float lr, wd, b1c, b2c, lr_t, c1;  // this tensor's scalars (Ladder's)
  int chunk0;              // first chunk (CTA) of this tensor in the launch
  int vec;                 // 1: every pointer 16-byte aligned
};
static_assert(sizeof(Entry) == 80, "Entry must match kernels/opt.py ENTRY");

struct Table {
  Ladder p;                // the bucket's scalars; per-tensor ones unused
  int n_entries;
  int n_chunks;
  int n_state;             // leaves in use (0, 1 or 2)
  Entry e[kMaxEntries];
};
static_assert(sizeof(Table) <= 32764, "the table must fit a kernel parameter");

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);  // 0 and NaN pass through
}

// One element of the ladder; w, s0, s1 are updated in place.
__device__ __forceinline__ void ladder(const Ladder& p, float g, float& w,
                                       float& s0, float& s1) {
  g = __fmul_rn(g, p.rescale);
  if (p.gn) g = __fmul_rn(g, p.gscale);
  if (p.clip_on) g = fminf(fmaxf(g, -p.clip), p.clip);
  switch (p.rule) {
    case kSGD: {
      g = __fadd_rn(g, __fmul_rn(p.wd, w));
      if (!p.has_state) {
        w = __fsub_rn(w, __fmul_rn(p.lr, g));
      } else {
        const float mom =
            __fsub_rn(__fmul_rn(p.h0, s0), __fmul_rn(p.lr, g));
        w = __fadd_rn(w, mom);
        s0 = mom;
      }
      break;
    }
    case kNAG: {
      g = __fadd_rn(g, __fmul_rn(p.wd, w));
      if (!p.has_state) {
        w = __fsub_rn(w, __fmul_rn(p.lr, g));
      } else {
        const float lg = __fmul_rn(p.lr, g);
        const float mom = __fsub_rn(__fmul_rn(p.h0, s0), lg);
        w = __fsub_rn(__fadd_rn(w, __fmul_rn(p.h0, mom)), lg);
        s0 = mom;
      }
      break;
    }
    case kSignum: {
      g = __fadd_rn(g, __fmul_rn(p.wd, w));
      if (!p.has_state) {
        w = __fsub_rn(w, __fmul_rn(p.lr, sign_of(g)));
      } else {
        const float mom =
            __fsub_rn(__fmul_rn(p.h0, s0), __fmul_rn(p.c0, g));
        w = __fsub_rn(__fadd_rn(w, __fmul_rn(p.lr, sign_of(mom))),
                      __fmul_rn(p.c1, w));
        s0 = mom;
      }
      break;
    }
    case kAdam: {
      g = __fadd_rn(g, __fmul_rn(p.wd, w));
      const float m = __fadd_rn(__fmul_rn(p.h0, s0), __fmul_rn(p.c0, g));
      const float v =
          __fadd_rn(__fmul_rn(p.h1, s1), __fmul_rn(__fmul_rn(p.c1, g), g));
      w = __fsub_rn(w, __fdiv_rn(__fmul_rn(p.lr_t, m),
                                 __fadd_rn(__fsqrt_rn(v), p.eps)));
      s0 = m;
      s1 = v;
      break;
    }
    default: {  // kAdamW: decoupled weight decay
      const float m = __fadd_rn(__fmul_rn(p.h0, s0), __fmul_rn(p.c0, g));
      const float v =
          __fadd_rn(__fmul_rn(p.h1, s1), __fmul_rn(__fmul_rn(p.c1, g), g));
      const float mhat = __fdiv_rn(m, p.b1c);
      const float vhat = __fdiv_rn(v, p.b2c);
      const float upd =
          __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), p.eps)),
                    __fmul_rn(p.wd, w));
      w = __fsub_rn(w, __fmul_rn(p.lr, upd));
      s0 = m;
      s1 = v;
      break;
    }
  }
}

// four consecutive elements, 16 bytes of f32 or 8 bytes of bf16 at a time
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The entry that owns chunk c: the last one whose first chunk is <= c.
// c is the same for every thread of the CTA, so is every load here.
__device__ __forceinline__ int find_entry(const Table& t, int c) {
  int lo = 0, hi = t.n_entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.e[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// GT: gradient dtype. MP: `w` is the f32 master and `w_lp` the bf16 weight
// written from it; without MP `w` is the f32 weight itself and w_lp unused.
// One CTA updates one chunk of one tensor.
// scal: null takes each tensor's scalars (and the bucket's rescale) from
// the table; else row i of the device buffer holds entry i's, rescale
// included (a branch uniform across the launch).
template <typename GT, bool MP>
__global__ void __launch_bounds__(kThreads)
    opt_ladder_kernel(const __grid_constant__ Table t,
                      const float* __restrict__ scal) {
  const int c = blockIdx.x;
  const int i = find_entry(t, c);
  const Entry& e = t.e[i];
  Ladder p = t.p;
  if (scal == nullptr) {
    p.lr = e.lr; p.wd = e.wd; p.b1c = e.b1c; p.b2c = e.b2c;
    p.lr_t = e.lr_t; p.c1 = e.c1;
  } else {
    const float* r = scal + (size_t)i * kScalarStride;
    p.lr = r[0]; p.wd = r[1]; p.b1c = r[2]; p.b2c = r[3];
    p.lr_t = r[4]; p.c1 = r[5]; p.rescale = r[6];
  }
  const int n_state = t.n_state;
  const long long base = (long long)(c - e.chunk0) * kChunk;
  const long long left = e.n - base;
  const int len = left < kChunk ? (int)left : kChunk;
  float* __restrict__ w = e.w + base;
  const GT* __restrict__ g = static_cast<const GT*>(e.g) + base;
  float* __restrict__ s0 = n_state > 0 ? e.s0 + base : nullptr;
  float* __restrict__ s1 = n_state > 1 ? e.s1 + base : nullptr;
  __nv_bfloat16* __restrict__ w_lp = MP ? e.w_lp + base : nullptr;
  int tail = 0;  // first element of the scalar path
  if (e.vec) {
    const int vlen = len & ~3;
    for (int k = threadIdx.x * 4; k < vlen; k += kThreads * 4 * kUnroll) {
      float wv[kUnroll][4], gv[kUnroll][4], av[kUnroll][4], bv[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = k + u * kThreads * 4;
        if (j < vlen) {
          load4(w + j, wv[u]);
          load4(g + j, gv[u]);
          if (n_state > 0) load4(s0 + j, av[u]);
          if (n_state > 1) load4(s1 + j, bv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = k + u * kThreads * 4;
        if (j < vlen) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float a = n_state > 0 ? av[u][q] : 0.f;
            float b = n_state > 1 ? bv[u][q] : 0.f;
            ladder(p, gv[u][q], wv[u][q], a, b);
            av[u][q] = a;
            bv[u][q] = b;
          }
          store4(w + j, wv[u]);
          if (n_state > 0) store4(s0 + j, av[u]);
          if (n_state > 1) store4(s1 + j, bv[u]);
          if (MP) store4(w_lp + j, wv[u]);
        }
      }
    }
    tail = vlen;
  }
  for (int j = tail + threadIdx.x; j < len; j += kThreads) {
    float wv = w[j];
    float a = n_state > 0 ? s0[j] : 0.f;
    float b = n_state > 1 ? s1[j] : 0.f;
    ladder(p, load1(g + j), wv, a, b);
    w[j] = wv;
    if (n_state > 0) s0[j] = a;
    if (n_state > 1) s1[j] = b;
    if (MP) w_lp[j] = __float2bfloat16(wv);
  }
}

// fixed-order sum of the CTA's values into thread 0
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.f;
  if (warp == 0) {
    x = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float sq_rescaled(float g, float rescale) {
  const float x = __fmul_rn(g, rescale);
  return __fmul_rn(x, x);
}

// One partial of sum((g * rescale)^2) per CTA, over the chunks c =
// blockIdx.x, blockIdx.x + gridDim.x, ...: a fixed assignment, so the
// partials repeat their bits.
template <typename GT>
__global__ void __launch_bounds__(kThreads)
    opt_sqnorm_partial_kernel(const __grid_constant__ Table t, float rescale,
                              float* __restrict__ partials) {
  float acc = 0.f;
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    const Entry& e = t.e[find_entry(t, c)];
    const long long base = (long long)(c - e.chunk0) * kChunk;
    const long long left = e.n - base;
    const int len = left < kChunk ? (int)left : kChunk;
    const GT* __restrict__ g = static_cast<const GT*>(e.g) + base;
    int tail = 0;
    if (e.vec) {
      const int vlen = len & ~3;
      for (int k = threadIdx.x * 4; k < vlen; k += kThreads * 4 * kUnroll) {
        float gv[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = k + u * kThreads * 4;
          if (j < vlen) load4(g + j, gv[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = k + u * kThreads * 4;
          if (j < vlen) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc = __fadd_rn(acc, sq_rescaled(gv[u][q], rescale));
          }
        }
      }
      tail = vlen;
    }
    for (int j = tail + threadIdx.x; j < len; j += kThreads)
      acc = __fadd_rn(acc, sq_rescaled(load1(g + j), rescale));
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// out[0] = the n partials summed in a fixed order, by one CTA
__global__ void __launch_bounds__(kThreads)
    opt_sqnorm_finish_kernel(const float* __restrict__ partials, int n,
                             float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads)
    acc = __fadd_rn(acc, partials[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

// Copies the host entries into t and checks them: sizes, the chunk plan
// (each entry's first chunk follows the previous entry's chunks), the
// pointers the launch needs, and that a tensor marked vec is aligned.
// Returns false on anything the kernels cannot run.
bool fill_table(Table& t, const void* entries, int n_entries, bool ladder,
                bool mp, int n_state) {
  if (n_entries < 1 || n_entries > kMaxEntries || entries == nullptr)
    return false;
  memcpy(t.e, entries, sizeof(Entry) * (size_t)n_entries);
  t.n_entries = n_entries;
  t.n_state = n_state;
  long long chunks = 0;
  for (int i = 0; i < n_entries; ++i) {
    const Entry& e = t.e[i];
    if (e.n < 1 || e.chunk0 != chunks || e.g == nullptr) return false;
    uintptr_t bits = (uintptr_t)e.g;
    if (ladder) {
      if (e.w == nullptr || (mp && e.w_lp == nullptr) ||
          (n_state > 0 && e.s0 == nullptr) ||
          (n_state > 1 && e.s1 == nullptr))
        return false;
      bits |= (uintptr_t)e.w | (uintptr_t)e.s0 | (uintptr_t)e.s1 |
              (uintptr_t)e.w_lp;
    }
    if (e.vec && (bits & 15) != 0) return false;
    chunks += (e.n + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return false;
  }
  t.n_chunks = (int)chunks;
  return true;
}

// Checks and fills the table, then launches the ladder kernel; scalars as
// opt_ladder_kernel's scal.
int launch_ladder(const void* entries, int n_entries, int mp, int rule,
                  int n_state, int gn, int clip_on, float rescale,
                  float gscale, float clip, float h0, float h1, float h2,
                  const float* scalars, void* stream) {
  Table t;  // 31 KB on the calling thread's stack
  if (rule < 0 || rule > 4 || n_state < 0 || n_state > 2 ||
      ((rule == kAdam || rule == kAdamW) && n_state != 2))
    return (int)cudaErrorInvalidValue;
  if (!fill_table(t, entries, n_entries, true, mp != 0, n_state))
    return (int)cudaErrorInvalidValue;
  Ladder& p = t.p;
  p.rule = rule;
  p.has_state = n_state > 0;
  p.gn = gn;
  p.clip_on = clip_on;
  p.rescale = rescale; p.gscale = gscale; p.clip = clip;
  p.h0 = h0; p.h1 = h1; p.eps = h2;
  p.c0 = 1.f - h0;
  p.lr = p.wd = p.c1 = p.b1c = p.b2c = p.lr_t = 0.f;  // per tensor
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mp)
    opt_ladder_kernel<__nv_bfloat16, true>
        <<<t.n_chunks, kThreads, 0, s>>>(t, scalars);
  else
    opt_ladder_kernel<float, false>
        <<<t.n_chunks, kThreads, 0, s>>>(t, scalars);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One bucket's update (up to kMaxEntries tensors), in place, in one
// launch. entries: n_entries Entry records on the host (kernels/opt.py
// builds them: pointers, sizes, first chunks, alignment flags, per-tensor
// scalars). mp: multi-precision (bf16 gradient and weight, f32 master);
// rule: 0 SGD, 1 NAG, 2 Signum, 3 Adam, 4 AdamW; n_state: leaves in use;
// h0, h1, h2: momentum / beta1, wd_lh / beta2, epsilon. Returns the
// cudaError_t of the launch (0 on success).
int mxtpu_opt_ladder_bucket(const void* entries, int n_entries, int mp,
                            int rule, int n_state, int gn, int clip_on,
                            float rescale, float gscale, float clip,
                            float h0, float h1, float h2, void* stream) {
  return launch_ladder(entries, n_entries, mp, rule, n_state, gn, clip_on,
                       rescale, gscale, clip, h0, h1, h2, nullptr, stream);
}

// The same update with each entry's scalars and rescale read at run time
// from `scalars` in device memory (kScalarStride f32 an entry, row i for
// entry i; the entries' own scalar fields are ignored), so that a launch
// captured in a CUDA graph takes the values of each replay. No global-norm
// scale (TrainStep runs no clip_global_norm).
int mxtpu_opt_ladder_bucket_dev(const void* entries, int n_entries, int mp,
                                int rule, int n_state, int clip_on,
                                float clip, float h0, float h1, float h2,
                                const float* scalars, void* stream) {
  if (scalars == nullptr) return (int)cudaErrorInvalidValue;
  return launch_ladder(entries, n_entries, mp, rule, n_state, 0, clip_on,
                       0.f, 0.f, clip, h0, h1, h2, scalars, stream);
}

// The partial sums of sum((g * rescale)^2) over up to kMaxEntries
// gradients (entries as above; only g, n, chunk0 and vec are read): writes
// min(chunks, kNormBlocks) f32 partials at `partials`.
int mxtpu_opt_sqnorm_bucket(const void* entries, int n_entries, int bf16,
                            float rescale, float* partials, void* stream) {
  Table t;
  memset(&t.p, 0, sizeof(t.p));  // the ladder's scalars: unused here
  if (partials == nullptr ||
      !fill_table(t, entries, n_entries, false, false, 0))
    return (int)cudaErrorInvalidValue;
  const int blocks = t.n_chunks < kNormBlocks ? t.n_chunks : kNormBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    opt_sqnorm_partial_kernel<__nv_bfloat16>
        <<<blocks, kThreads, 0, s>>>(t, rescale, partials);
  else
    opt_sqnorm_partial_kernel<float>
        <<<blocks, kThreads, 0, s>>>(t, rescale, partials);
  return (int)cudaGetLastError();
}

// out[0] = sum of n partials, in a fixed order.
int mxtpu_opt_sqnorm_finish(const float* partials, int n, float* out,
                            void* stream) {
  if (partials == nullptr || out == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  opt_sqnorm_finish_kernel<<<1, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      partials, n, out);
  return (int)cudaGetLastError();
}

// the constants kernels/opt.py plans with; it checks them at load
int mxtpu_opt_entry_size() { return (int)sizeof(Entry); }
int mxtpu_opt_table_capacity() { return kMaxEntries; }
int mxtpu_opt_chunk() { return kChunk; }
int mxtpu_opt_norm_blocks() { return kNormBlocks; }
int mxtpu_opt_scalar_stride() { return kScalarStride; }

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
