// Fused optimizer ladder for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by mxnet_tpu_torch/kernels/opt.py).
//
// Replaces the TPU kernel mxnet_tpu/kernels/opt.py:_ladder_kernel (launched
// by _ladder_pallas, pl.pallas_call at :176). One elementwise pass per
// parameter, in the order of Optimizer._fused_param_step:
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
// Bound on this card: bytes. The gradient is read once, the master and each
// state leaf are read and written once, the bf16 weight is written once, and
// the f32 gradient never exists in device memory. AdamW under
// multi-precision moves 28 bytes per element (g 2, master 4 + 4, m and v
// 8 + 8, weight 2). Each thread moves four elements with 16-byte (f32) and
// 8-byte (bf16) accesses; a tail that does not fill four, or a pointer that
// is not 16-byte aligned, takes the scalar path. Scalars that depend only
// on the step (Adam's bias corrections) are computed once per launch on the
// host, in f32. One launch per parameter; one launch per bucket through a
// pointer table is later speed work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Rule { kSGD = 0, kNAG = 1, kSignum = 2, kAdam = 3, kAdamW = 4 };

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride loop above this

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

// GT: gradient dtype. MP: `w` is the f32 master and `w_lp` the bf16 weight
// written from it; without MP `w` is the f32 weight itself and w_lp unused.
// n_state: leaves in use (0, 1 or 2). VEC: 4 (aligned pointers) or 1.
template <typename GT, bool MP, int VEC>
__global__ void __launch_bounds__(kThreads)
    opt_ladder_kernel(Ladder p, float* __restrict__ w,
                      const GT* __restrict__ g, float* __restrict__ s0,
                      float* __restrict__ s1,
                      __nv_bfloat16* __restrict__ w_lp, int n_state,
                      long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x * VEC;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
       i < n; i += stride) {
    if (VEC == 4 && i + 4 <= n) {
      float wv[4], gv[4], av[4] = {0.f, 0.f, 0.f, 0.f},
                          bv[4] = {0.f, 0.f, 0.f, 0.f};
      load4(w + i, wv);
      load4(g + i, gv);
      if (n_state > 0) load4(s0 + i, av);
      if (n_state > 1) load4(s1 + i, bv);
#pragma unroll
      for (int j = 0; j < 4; ++j) ladder(p, gv[j], wv[j], av[j], bv[j]);
      store4(w + i, wv);
      if (n_state > 0) store4(s0 + i, av);
      if (n_state > 1) store4(s1 + i, bv);
      if (MP) store4(w_lp + i, wv);
    } else {  // the masked tail (and every element when VEC == 1)
      const long long end = i + VEC < n ? i + VEC : n;
      for (long long j = i; j < end; ++j) {
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
  }
}

template <typename GT, bool MP>
void launch(const Ladder& p, float* w, const void* g, float* s0, float* s1,
            void* w_lp, int n_state, long long n, cudaStream_t stream) {
  const uintptr_t bits = (uintptr_t)w | (uintptr_t)g | (uintptr_t)s0 |
                         (uintptr_t)s1 | (uintptr_t)w_lp;
  const bool aligned = (bits & 15) == 0;
  const int vec = aligned ? 4 : 1;
  long long blocks = (n + (long long)kThreads * vec - 1) / (kThreads * vec);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const GT* gp = static_cast<const GT*>(g);
  __nv_bfloat16* lp = static_cast<__nv_bfloat16*>(w_lp);
  if (aligned)
    opt_ladder_kernel<GT, MP, 4><<<(int)blocks, kThreads, 0, stream>>>(
        p, w, gp, s0, s1, lp, n_state, n);
  else
    opt_ladder_kernel<GT, MP, 1><<<(int)blocks, kThreads, 0, stream>>>(
        p, w, gp, s0, s1, lp, n_state, n);
}

}  // namespace

extern "C" {

// One parameter's update, in place. w: f32 master (mp) or f32 weight;
// g: gradient, bf16 under mp else f32; s0, s1: f32 state leaves (null when
// unused; n_state says how many are in use); w_lp: bf16 weight under mp,
// else null. rule: 0 SGD, 1 NAG, 2 Signum, 3 Adam, 4 AdamW. h0, h1, h2:
// momentum / beta1, wd_lh / beta2, epsilon. t: this parameter's update
// count. Returns the cudaError_t of the launch (0 on success).
int mxtpu_opt_ladder(void* w, const void* g, void* s0, void* s1, void* w_lp,
                     long long n, int mp, int rule, int n_state, int gn,
                     int clip_on, float lr, float wd, float t, float rescale,
                     float gscale, float clip, float h0, float h1, float h2,
                     void* stream) {
  if (n < 1 || rule < 0 || rule > 4 || n_state < 0 || n_state > 2 ||
      w == nullptr || g == nullptr || (mp && w_lp == nullptr) ||
      (n_state > 0 && s0 == nullptr) || (n_state > 1 && s1 == nullptr) ||
      ((rule == kAdam || rule == kAdamW) && n_state != 2))
    return (int)cudaErrorInvalidValue;
  Ladder p;
  p.rule = rule;
  p.has_state = n_state > 0;
  p.gn = gn;
  p.clip_on = clip_on;
  p.lr = lr; p.wd = wd; p.rescale = rescale; p.gscale = gscale;
  p.clip = clip;
  p.h0 = h0; p.h1 = h1; p.eps = h2;
  p.c0 = 1.f - h0;
  p.c1 = rule == kSignum ? lr * h1 : 1.f - h1;
  // the step-dependent scalars, once per launch, in f32
  p.b1c = 1.f - powf(h0, t);
  p.b2c = 1.f - powf(h1, t);
  p.lr_t = lr * sqrtf(p.b2c) / p.b1c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wp = static_cast<float*>(w);
  float* a = n_state > 0 ? static_cast<float*>(s0) : nullptr;
  float* b = n_state > 1 ? static_cast<float*>(s1) : nullptr;
  if (mp)
    launch<__nv_bfloat16, true>(p, wp, g, a, b, w_lp, n_state, n, s);
  else
    launch<float, false>(p, wp, g, a, b, nullptr, n_state, n, s);
  return (int)cudaGetLastError();
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
