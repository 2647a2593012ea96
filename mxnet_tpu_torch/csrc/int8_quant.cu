// Q1: symmetric int8 quantization for Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded with ctypes by mxnet_tpu_torch/kernels/int8.py).
//
// Replaces no Pallas kernel: the JAX package quantizes with XLA,
// mxnet_tpu/contrib/quantization.py:_q (:40), reached from
// QuantizedDense.forward (:261), QuantizedConv2D.forward (:308), quantize
// (:53), quantize_v2 (:71, :79), requantize (:113) and _req (:423). One
// elementwise pass:
//
//   optional clip of x to [lo, hi];
//   scale = 127 / max(|lo|, |hi|, 1e-20)        (f32, a true division);
//   q = saturate(round_half_even(x * scale), -127, 127) as int8;
//   info = (-127 / scale, 127 / scale, scale).
//
// lo and hi are read from device memory, so a launch captured in a CUDA
// graph replays without a host read; on the dynamic-range path the wrapper
// feeds them from torch.aminmax on the card. Rounding is rintf (half to
// even, as jnp.round), not roundf (half away from zero). The multiply and
// the divisions are written with the _rn intrinsics, so that the codes are
// bit for bit those of the f32 reference.
//
// Bound on this card: bytes (4 read and 1 written an element). Each thread
// reads 16 floats as four 16-byte loads and writes their 16 codes as one
// 16-byte store where x and q both start on 16 bytes; the rest (and any
// misaligned tensor) takes the scalar loop of the same kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint32_t code(float x, float lo, float hi,
                                         float s, int clip) {
  if (clip) x = fminf(fmaxf(x, lo), hi);
  float r = rintf(__fmul_rn(x, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(
      static_cast<int>(r))));
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                    const float* __restrict__ lohi, float* __restrict__ info,
                    long long n, int clip, int vec) {
  const float lo = lohi[0], hi = lohi[1];
  const float s =
      __fdiv_rn(127.f, fmaxf(fmaxf(fabsf(lo), fabsf(hi)), 1e-20f));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float amax = __fdiv_rn(127.f, s);
    info[0] = -amax;
    info[1] = amax;
    info[2] = s;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = n / 16;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uint4* q16 = reinterpret_cast<uint4*>(q);
    for (long long i = tid; i < groups; i += stride) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __ldg(x4 + 4 * i + j);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = code(v[j].x, lo, hi, s, clip) |
               (code(v[j].y, lo, hi, s, clip) << 8) |
               (code(v[j].z, lo, hi, s, clip) << 16) |
               (code(v[j].w, lo, hi, s, clip) << 24);
      q16[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    done = groups * 16;
  }
  for (long long i = done + tid; i < n; i += stride)
    q[i] = static_cast<int8_t>(code(__ldg(x + i), lo, hi, s, clip));
}

}  // namespace

extern "C" {

// x: n f32; q: n int8; lohi: 2 f32 (lo, hi) on the card; info: 3 f32 out.
// clip: clip x to [lo, hi] first. Returns cudaGetLastError() of the launch.
int mxtpu_int8_quantize(const void* x, void* q, const void* lohi, void* info,
                        long long n, int clip, void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const long long items = vec ? n / 16 + n % 16 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quantize_kernel<<<static_cast<int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<const float*>(lohi), static_cast<float*>(info), n, clip,
      vec);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
