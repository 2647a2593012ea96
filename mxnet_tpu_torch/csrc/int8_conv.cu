// Q2: int8 x int8 -> int32 convolution as an implicit GEMM for Hopper
// (sm_90a), CUDA C++ with a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/kernels/int8.py).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA,
// conv_general_dilated with preferred_element_type=int32 in
// QuantizedConv2D.forward (mxnet_tpu/contrib/quantization.py:311) and
// quantized_conv (:563), dot_general in QuantizedDense.forward (:262) and
// quantized_fully_connected (:597). PyTorch has no int8 convolution on the
// card. A Dense layer is a 1x1 convolution over a 1x1 plane here.
//
// x is NCHW int8 (N, C, H, W), w is OIHW int8 (O, C/G, KH, KW), with
// stride, zero padding, dilation and G groups. For group g the GEMM is
// out[m, o] = sum_k A[m, k] * B[k, o] with m = (n, oh, ow) the output
// pixel, o an output channel of the group and k = (c, r, s) in OIHW order,
// so that B's rows are w's rows as they lie in memory. Padding and the
// tail of K past the last multiple of 64 are zero codes in shared memory,
// as XLA pads xq. The epilogue writes either the raw int32 sums (the
// registry ops) or f32: f32(acc) / (xscale * wscale[o]) + bias[o], ReLU
// where the layer's activation is relu, written with the _rn intrinsics so
// that the result is bit for bit the f32 reference's (a true division, no
// fused multiply-add). Integer sums are exact: any order gives the same
// bits.
//
// Design (the first, simple kernel; a wgmma/TMA pipeline with Q1 fused into
// the operand load is later work): a CTA of 4 warps computes a 64 x 64
// tile of (pixels x channels) over K in steps of 64. Each thread gathers
// 32 bytes of one A row (im2col on the fly: the (c, r, s) of each k is
// stepped, not divided) and 32 bytes of one B row into shared memory rows
// of 80 bytes (64 + 16 of padding: the fragment reads below hit 32
// different banks), then each warp runs mma.sync.m16n8k32.s8.s8.s32 on
// its 32 x 32 quarter, two k-steps a tile. Bound on this card: at the
// main path's shapes, operations (int8 tensor cores, 1979 TOPS dense) for
// the 3x3 convolutions and bytes for the 1x1 ones at small batch; this
// design is held back by its byte-wise gathers and the sync between the
// loads and the products.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64, kThreads = 128;
constexpr int kRow = 80;  // bytes of a shared-memory row: 64 + 16 padding

struct ConvParams {
  const int8_t* x;
  const int8_t* w;
  void* out;
  const float* xscale;  // 1 f32 (the f32 epilogue)
  const float* wscale;  // O f32
  const float* bias;    // O f32 or null
  int N, C, H, W, O, KH, KW, OH, OW;
  int sh, sw, ph, pw, dh, dw, G;
  int Cg, Og, K, M;
  int f32_out, relu, wvec, pointwise;
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads) conv_kernel(const ConvParams p) {
  __shared__ __align__(16) uint8_t As[kBM * kRow];
  __shared__ __align__(16) uint8_t Bs[kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int plane = p.OH * p.OW, khw = p.KH * p.KW;

  // the loader's row (A: an output pixel, B: an output channel) and half
  // (k offset 0 or 32 within the tile)
  const int lr = tid >> 1, lh = tid & 1;
  const int am = m0 + lr;
  const bool a_ok = am < p.M;
  int an = 0, aoh = 0, aow = 0;
  if (a_ok) {
    an = am / plane;
    const int rem = am - an * plane;
    aoh = rem / p.OW;
    aow = rem - aoh * p.OW;
  }
  const int ih0 = aoh * p.sh - p.ph, iw0 = aow * p.sw - p.pw;
  const int8_t* xb = p.x + (static_cast<long long>(an) * p.C +
                            static_cast<long long>(g) * p.Cg) *
                               p.H * p.W;
  const int bo = n0 + lr;
  const bool b_ok = bo < p.Og;
  const int8_t* wr =
      p.w + (static_cast<long long>(g) * p.Og + (b_ok ? bo : 0)) * p.K;

  const int wm = warp & 1, wn = warp >> 1;
  const int gq = lane >> 2, tq = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    const int kb = k0 + 32 * lh;
    uint32_t av[8], bv[8];
    // A: 32 codes of row lr, im2col on the fly
    if (p.pointwise) {
      // 1x1, no padding: k is the channel and every tap is inside
      const int8_t* src = xb + static_cast<long long>(ih0) * p.W + iw0;
      const long long cs = static_cast<long long>(p.H) * p.W;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = kb + 4 * j + b;
          const int8_t v = (a_ok && k < p.K) ? src[k * cs] : 0;
          word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * b);
        }
        av[j] = word;
      }
    } else {
      int c = kb / khw;
      const int rs = kb - c * khw;
      int r = rs / p.KW;
      int s = rs - r * p.KW;
      int k = kb;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          int8_t v = 0;
          if (a_ok && k < p.K) {
            const int ih = ih0 + r * p.dh, iw = iw0 + s * p.dw;
            if (static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                static_cast<unsigned>(iw) < static_cast<unsigned>(p.W))
              v = xb[(static_cast<long long>(c) * p.H + ih) * p.W + iw];
          }
          word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * b);
          ++k;
          if (++s == p.KW) {
            s = 0;
            if (++r == p.KH) {
              r = 0;
              ++c;
            }
          }
        }
        av[j] = word;
      }
    }
    // B: 32 codes of weight row bo
    if (p.wvec && b_ok && kb + 32 <= p.K) {
      const uint4 lo = *reinterpret_cast<const uint4*>(wr + kb);
      const uint4 hi = *reinterpret_cast<const uint4*>(wr + kb + 16);
      bv[0] = lo.x; bv[1] = lo.y; bv[2] = lo.z; bv[3] = lo.w;
      bv[4] = hi.x; bv[5] = hi.y; bv[6] = hi.z; bv[7] = hi.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = kb + 4 * j + b;
          const int8_t v = (b_ok && k < p.K) ? wr[k] : 0;
          word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * b);
        }
        bv[j] = word;
      }
    }
    __syncthreads();  // the previous tile's fragments are read
    uint4* as = reinterpret_cast<uint4*>(As + lr * kRow + 32 * lh);
    uint4* bs = reinterpret_cast<uint4*>(Bs + lr * kRow + 32 * lh);
    as[0] = make_uint4(av[0], av[1], av[2], av[3]);
    as[1] = make_uint4(av[4], av[5], av[6], av[7]);
    bs[0] = make_uint4(bv[0], bv[1], bv[2], bv[3]);
    bs[1] = make_uint4(bv[4], bv[5], bv[6], bv[7]);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* r0 = As + (wm * 32 + mi * 16 + gq) * kRow + ks * 32 +
                            tq * 4;
        af[mi][0] = lds32(r0);
        af[mi][1] = lds32(r0 + 8 * kRow);
        af[mi][2] = lds32(r0 + 16);
        af[mi][3] = lds32(r0 + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* c0 = Bs + (wn * 32 + ni * 8 + gq) * kRow + ks * 32 +
                            tq * 4;
        bf[ni][0] = lds32(c0);
        bf[ni][1] = lds32(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  const float xs = p.f32_out ? *p.xscale : 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mi * 16 + gq + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + ni * 8 + tq * 2 + (e & 1);
        if (m >= p.M || col >= p.Og) continue;
        const int o = g * p.Og + col;
        const int n = m / plane;
        const long long idx =
            (static_cast<long long>(n) * p.O + o) * plane + (m - n * plane);
        const int a = acc[mi][ni][e];
        if (!p.f32_out) {
          static_cast<int*>(p.out)[idx] = a;
          continue;
        }
        float y = __fdiv_rn(__int2float_rn(a), __fmul_rn(xs, p.wscale[o]));
        if (p.bias) y = __fadd_rn(y, p.bias[o]);
        if (p.relu) y = fmaxf(y, 0.f);
        static_cast<float*>(p.out)[idx] = y;
      }
}

}  // namespace

extern "C" {

// x (N, C, H, W) int8, w (O, C/G, KH, KW) int8, out (N, O, OH, OW) int32
// (f32_out 0) or f32 (f32_out 1: xscale 1 f32, wscale O f32, bias O f32 or
// null, relu). All contiguous on the card. Returns cudaGetLastError() of
// the launch.
int mxtpu_int8_conv(const void* x, const void* w, void* out,
                    const void* xscale, const void* wscale, const void* bias,
                    int N, int C, int H, int W, int O, int KH, int KW, int OH,
                    int OW, int sh, int sw, int ph, int pw, int dh, int dw,
                    int G, int f32_out, int relu, void* stream) {
  ConvParams p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.xscale = static_cast<const float*>(xscale);
  p.wscale = static_cast<const float*>(wscale);
  p.bias = static_cast<const float*>(bias);
  p.N = N; p.C = C; p.H = H; p.W = W; p.O = O; p.KH = KH; p.KW = KW;
  p.OH = OH; p.OW = OW; p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw;
  p.dh = dh; p.dw = dw; p.G = G;
  p.Cg = C / G; p.Og = O / G; p.K = p.Cg * KH * KW; p.M = N * OH * OW;
  p.f32_out = f32_out; p.relu = relu;
  p.wvec = (p.K % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  p.pointwise = KH == 1 && KW == 1 && ph == 0 && pw == 0;
  const dim3 grid((p.M + kBM - 1) / kBM, (p.Og + kBN - 1) / kBN, G);
  conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
