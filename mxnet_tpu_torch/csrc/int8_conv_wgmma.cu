// Q2 on wgmma: int8 x int8 -> int32 convolution as an implicit GEMM for
// Hopper (sm_90a) over channels-last codes, CUDA C++ with a plain C
// interface (loaded with ctypes by mxnet_tpu_torch/kernels/int8.py).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA,
// conv_general_dilated with preferred_element_type=int32 in
// QuantizedConv2D.forward (mxnet_tpu/contrib/quantization.py:311) and
// quantized_conv (:563), dot_general in QuantizedDense.forward (:262) and
// quantized_fully_connected (:597). It takes every site whose C/G is a
// multiple of 16; int8_conv.cu (the gather variant) takes the rest.
//
// x is int8 (N, C, H, W) stored channels-last (NHWC, as Q1 writes it), w is
// int8 (O, C/G, KH, KW) stored (O, KH, KW, C/G): for group g the GEMM is
// out[m, o] = sum_k A[m, k] * B[k, o] with m = (n, oh, ow) and k = (r, s, c),
// c innermost. A 16-byte run of A's row is then 16 input channels of one
// input pixel, and B is the weight as [O, K], K-major, so both operands are
// K-major, the only layout wgmma's s8 form takes. Integer sums are exact:
// this order gives the bits of any other.
//
// Bound on this card: bytes for most of ResNet-50's sites (the f32 output,
// 4 bytes an element, is most of them), int8 operations for the 3x3
// convolutions at large batch. Design:
//  - a CTA computes a BM x 64 tile (BM 64 or 128 output pixels, 64 output
//    channels of one group) over a range of K in 128-byte steps
//    (one 128-byte-swizzled row: 128 codes), through a ring of 4 stages
//    (2 where the tile's K is one or two steps) of (A tile, B tile) in
//    shared memory;
//  - warpgroup 0 produces: B by one 2-D TMA box of the [O, K] weight a
//    stage (rows and K past the end read as zeros); A by 16-byte cp.async
//    copies, each thread one chunk column of BM / 16 rows, zero-filled for
//    padded taps, pixels past M and K past its end, written in TMA's
//    128-byte swizzle (chunk c of row r at c ^ (r % 8)). A thread keeps
//    up to 3 stages of copies in flight (1 in a ring of 2), and marks a
//    stage full once its copies of that stage have landed
//    (cp.async.wait_group, then a proxy fence so that wgmma's reads see
//    them, then its arrival on the stage's mbarrier);
//  - each consumer warpgroup runs m64n64k32 wgmma on its 64 rows, four a
//    stage, one stage's products in flight while the next waits, and frees
//    a stage once the products that read it are done;
//  - the epilogue stages the tile channel-major in the ring's shared memory
//    and writes the NCHW output along the plane, 16-byte stores where the
//    plane is a multiple of 4: f32(acc) / (xscale * wscale[o]) + bias[o],
//    ReLU, with the _rn intrinsics (bit for bit the f32 reference's and
//    int8_conv.cu's), or the raw int32 sums;
//  - split-K: where the tiles are too few to fill the card, grid z also
//    splits K; each split writes its int32 sums to a workspace and a second
//    kernel adds them (exact in any order) and runs the epilogue once.
// A CTA of BM 64 is 2 warpgroups and fits twice on an SM (one's epilogue
// runs beside the other's products); BM 128 is 3 warpgroups, once an SM.
#include "hopper_common.cuh"

using namespace mxtpu_hopper;

namespace {

// A ring of S stages. A producer thread keeps kLag stages of copies in
// flight past the one it marks full: stage i is freed once stage i + 1 is
// full (the consumers keep one stage's products in flight), so the
// producer, waiting for stage i - S to be freed before it fills stage i,
// must have marked stage i - S + 1 full by then: kLag <= S - 2. Where a
// tile's K is one or two steps (1x1 convolutions of up to 256 channels,
// most of them bound by their output's bytes) a ring of 2 leaves room for
// more CTAs an SM; elsewhere 4
constexpr int kBK = 128;  // codes (bytes) of K a stage
constexpr int kBN = 64;   // output channels of a tile
constexpr int kShortK = 2;

struct Params {
  const int8_t* x;      // NHWC codes
  void* out;            // NCHW int32 or f32, or the split workspace
  const float* xscale;  // 1 f32 (the f32 epilogue)
  const float* wscale;  // O f32
  const float* bias;    // O f32 or null
  int N, C, H, W, O, KH, KW, OH, OW, sh, sw, ph, pw, dh, dw, G;
  int Cg, Og, K, M, plane;
  int nk, kt_per, split;
  int mode;             // 0: int32 sums, 1: f32 epilogue, 2: split partials
  int relu;
  long long out_elems;  // N * O * plane: one split's partials
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f32(a) / den + bias, ReLU, with den = xscale * wscale[o] (f32)
__device__ __forceinline__ float epilogue(int a, float den, bool has_bias,
                                          float bias, int relu) {
  float y = __fdiv_rn(__int2float_rn(a), den);
  if (has_bias) y = __fadd_rn(y, bias);
  if (relu) y = fmaxf(y, 0.f);
  return y;
}

template <int BM, int S>
struct Smem {
  static constexpr int kA = 0;
  static constexpr int kABytes = BM * kBK;
  static constexpr int kB = kA + S * kABytes;
  static constexpr int kBBytes = kBN * kBK;
  static constexpr int kStageRow = BM + 4;  // words of a staged channel
  // the epilogue stages the tile over the ring
  static constexpr int kRing = kB + S * kBBytes;
  static constexpr int kStaged = kBN * kStageRow * 4;
  static constexpr int kBar = kRing > kStaged ? kRing : kStaged;
  static constexpr int kChan = kBar + 2 * S * 8;  // kBN dens, kBN biases
  static constexpr int kBytes = 1024 + kChan + 2 * kBN * 4;
};

template <int BM, int S>
__global__ void __launch_bounds__(128 * (1 + BM / 64), BM == 64 ? 2 : 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                      const Params p) {
  using L = Smem<BM, S>;
  constexpr int kStages = S, kLag = S - 2;
  constexpr int kConsumers = 128 * (BM / 64);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int g = blockIdx.z / p.split, sp = blockIdx.z % p.split;
  const int kt0 = sp * p.kt_per;
  const int nkt = min(p.nk, kt0 + p.kt_per) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128 + 1);  // the producers, and the TMA's bytes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: A by cp.async, B by TMA ----
    constexpr int kRows = BM / 16;
    const int j = tid & 7;                        // this thread's chunk
    const uint32_t chunk = ((j ^ ((tid >> 3) & 7)) << 4);
    int ih0[kRows], iw0[kRows], base[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + (tid >> 3) + 16 * i;
      if (m < p.M) {
        const int n = m / p.plane, rem = m - n * p.plane;
        const int oh = rem / p.OW, ow = rem - oh * p.OW;
        ih0[i] = oh * p.sh - p.ph;
        iw0[i] = ow * p.sw - p.pw;
        base[i] = n * p.H * p.W * p.C + g * p.Cg;
      } else {
        ih0[i] = -(1 << 28);  // every tap outside: zeros
        iw0[i] = 0;
        base[i] = 0;
      }
    }
    // (r, s, c) of this thread's first k, stepped by kBK a stage
    int k = kt0 * kBK + 16 * j;
    int tap = k / p.Cg;
    int c = k - tap * p.Cg;
    int r = tap / p.KW;
    int s = tap - r * p.KW;
    const uint32_t a_ring = smem_u32(smem + L::kA);
    for (int i = 0; i < nkt; ++i) {
      const int st = i % kStages;
      mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(&full[st], L::kBBytes);
        tma_load_2d(smem + L::kB + st * L::kBBytes, &tw, &full[st],
                    (kt0 + i) * kBK, g * p.Og + n0);
      }
      const uint32_t a_tile = a_ring + st * L::kABytes;
      const bool k_ok = r < p.KH;
      const int dy = r * p.dh, dx = s * p.dw;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int ih = ih0[q] + dy, iw = iw0[q] + dx;
        const bool ok = k_ok && static_cast<unsigned>(ih) <
                                    static_cast<unsigned>(p.H) &&
                        static_cast<unsigned>(iw) <
                            static_cast<unsigned>(p.W);
        const int8_t* src =
            ok ? p.x + base[q] + (ih * p.W + iw) * p.C + c : p.x;
        cp_async16(a_tile + ((tid >> 3) + 16 * q) * kBK + chunk, src,
                   ok ? 16 : 0);
      }
      cp_async_commit();
      c += kBK;
      while (c >= p.Cg && r < p.KH) {
        c -= p.Cg;
        if (++s == p.KW) {
          s = 0;
          ++r;
        }
      }
      if (i >= kLag) {
        cp_async_wait<kLag>();
        fence_proxy_async();
        mbar_arrive(&full[(i - kLag) % kStages]);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int i = max(0, nkt - kLag); i < nkt; ++i)
      mbar_arrive(&full[i % kStages]);
    return;
  }

  // ---- consumers: 64 rows a warpgroup ----
  const int cw = wg - 1;
  const int t = threadIdx.x - 128;
  const int o_base = g * p.Og + n0;
  float* den = reinterpret_cast<float*>(smem + L::kChan);
  float* bsh = den + kBN;
  if (t < kBN) {  // the tile's channels, read by the epilogue
    const bool ok = p.mode == 1 && n0 + t < p.Og;
    den[t] = ok ? __fmul_rn(*p.xscale, p.wscale[o_base + t]) : 1.f;
    bsh[t] = ok && p.bias ? p.bias[o_base + t] : 0.f;
  }
  int acc[kBN / 2];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) acc[e] = 0;
  const uint8_t* a_ring = smem + L::kA + cw * 64 * kBK;
  const uint8_t* b_ring = smem + L::kB;
  for (int i = 0; i < nkt; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8_n64(acc, sw128_desc(a_ring + st * L::kABytes + 32 * kk, 16),
                   sw128_desc(b_ring + st * L::kBBytes + 32 * kk, 16),
                   i > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: the tile channel-major in the ring, then out ----
  named_barrier(1, kConsumers);  // every consumer's products are done
  int* stage = reinterpret_cast<int*>(smem);
  {
    const int lane = tid & 31;
    const int row = cw * 64 + 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
    for (int b = 0; b < kBN / 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * b + 2 * (lane & 3) + (e & 1);
        stage[col * L::kStageRow + row + (e >> 1) * 8] = acc[4 * b + e];
      }
  }
  named_barrier(1, kConsumers);
  const bool has_bias = p.bias != nullptr;
  const int* __restrict__ staged = stage;
  int* __restrict__ outi =
      static_cast<int*>(p.out) + (p.mode == 2 ? sp * p.out_elems : 0);
  float* __restrict__ outf = static_cast<float*>(p.out);
  if (p.plane % 4 == 0) {
    // 4 pixels of one plane a thread, the same 4 (the consumers are a
    // multiple of BM / 4) for kSteps of the tile's channels: one 16-byte
    // load and store each
    constexpr int kStep = kConsumers / (BM / 4), kSteps = kBN / kStep;
    const int m4 = t % (BM / 4), m = m0 + 4 * m4;
    if (m >= p.M) return;
    const int n = m / p.plane;
    const int ol0 = t / (BM / 4);
    long long at = (static_cast<long long>(n) * p.O + o_base + ol0) *
                       p.plane + (m - n * p.plane);
#pragma unroll
    for (int it = 0; it < kSteps; ++it, at += kStep * p.plane) {
      const int ol = ol0 + it * kStep;
      if (n0 + ol >= p.Og) break;
      const int4 a =
          *reinterpret_cast<const int4*>(staged + ol * L::kStageRow + 4 * m4);
      if (p.mode == 1) {
        const float d = den[ol], b = bsh[ol];
        *reinterpret_cast<float4*>(outf + at) = make_float4(
            epilogue(a.x, d, has_bias, b, p.relu),
            epilogue(a.y, d, has_bias, b, p.relu),
            epilogue(a.z, d, has_bias, b, p.relu),
            epilogue(a.w, d, has_bias, b, p.relu));
      } else {
        *reinterpret_cast<int4*>(outi + at) = a;
      }
    }
  } else if (p.plane > 1) {
    // one pixel a thread, the same one (the consumers are a multiple of
    // BM) for kSteps of the tile's channels; a warp stores along the plane
    constexpr int kStep = kConsumers / BM, kSteps = kBN / kStep;
    const int ml = t % BM, m = m0 + ml;
    if (m >= p.M) return;
    const int n = m / p.plane;
    const int ol0 = t / BM;
    long long at = (static_cast<long long>(n) * p.O + o_base + ol0) *
                       p.plane + (m - n * p.plane);
#pragma unroll 4
    for (int it = 0; it < kSteps; ++it, at += kStep * p.plane) {
      const int ol = ol0 + it * kStep;
      if (n0 + ol >= p.Og) break;
      const int a = staged[ol * L::kStageRow + ml];
      if (p.mode == 1)
        outf[at] = epilogue(a, den[ol], has_bias, bsh[ol], p.relu);
      else
        outi[at] = a;
    }
  } else {
    // a plane of one pixel (the Dense): a warp stores along the channels
    for (int idx = t; idx < kBN * BM; idx += kConsumers) {
      const int ol = idx % kBN, m = m0 + idx / kBN;
      if (m >= p.M || n0 + ol >= p.Og) continue;
      const long long at = static_cast<long long>(m) * p.O + o_base + ol;
      const int a = staged[ol * L::kStageRow + (m - m0)];
      if (p.mode == 1)
        outf[at] = epilogue(a, den[ol], has_bias, bsh[ol], p.relu);
      else
        outi[at] = a;
    }
  }
}

// the split partials' sum, then the epilogue: out[i] = f(sum_s ws[s][i]),
// four elements a thread where the count allows
__global__ void __launch_bounds__(256)
    splitk_epilogue_kernel(const int* __restrict__ ws, void* out, int split,
                           long long elems, int plane, int O,
                           const float* xscale, const float* wscale,
                           const float* bias, int f32_out, int relu) {
  const float xs = f32_out ? *xscale : 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long quads = elems % 4 == 0 ? elems / 4 : 0;
  for (long long i = tid; i < quads; i += stride) {
    int4 a = reinterpret_cast<const int4*>(ws)[i];
    for (int s = 1; s < split; ++s) {
      const int4 b = reinterpret_cast<const int4*>(ws + s * elems)[i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    if (!f32_out) {
      reinterpret_cast<int4*>(out)[i] = a;
      continue;
    }
    const int v[4] = {a.x, a.y, a.z, a.w};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = static_cast<int>(((4 * i + e) / plane) % O);
      y[e] = epilogue(v[e], __fmul_rn(xs, wscale[o]), bias != nullptr,
                      bias ? bias[o] : 0.f, relu);
    }
    reinterpret_cast<float4*>(out)[i] = make_float4(y[0], y[1], y[2], y[3]);
  }
  for (long long i = 4 * quads + tid; i < elems; i += stride) {
    int a = ws[i];
    for (int s = 1; s < split; ++s) a += ws[s * elems + i];
    if (!f32_out) {
      static_cast<int*>(out)[i] = a;
      continue;
    }
    const int o = static_cast<int>((i / plane) % O);
    static_cast<float*>(out)[i] =
        epilogue(a, __fmul_rn(xs, wscale[o]), bias != nullptr,
                 bias ? bias[o] : 0.f, relu);
  }
}

// The [O, K] int8 weight as a 2-D map (K, O) read in boxes of 128 x 64 (a
// stage's B tile), 128-byte swizzled; rows past O and K past its end read as
// zeros.
int encode_weight(CUtensorMap* map, const void* w, int O, int K) {
  EncodeTiledFn fn;
  int err = encode_fn(&fn);
  if (err) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(O)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kBK, kBN};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                  const_cast<void*>(w), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int BM, int S>
int launch_ring(const CUtensorMap& tw, const Params& p, cudaStream_t stream) {
  constexpr int smem = Smem<BM, S>::kBytes;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_wgmma_kernel<BM, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((p.M + BM - 1) / BM, (p.Og + kBN - 1) / kBN,
                  p.G * p.split);
  conv_wgmma_kernel<BM, S>
      <<<grid, 128 * (1 + BM / 64), smem, stream>>>(tw, p);
  return cudaGetLastError();
}

template <int BM>
int launch(const CUtensorMap& tw, const Params& p, cudaStream_t stream) {
  return p.kt_per <= kShortK ? launch_ring<BM, 2>(tw, p, stream)
                             : launch_ring<BM, 4>(tw, p, stream);
}

}  // namespace

extern "C" {

// x: int8 (N, C, H, W) stored NHWC; w: int8 (O, C/G, KH, KW) stored
// (O, KH, KW, C/G); C/G a multiple of 16, both on 16 bytes. out: (N, O, OH,
// OW) contiguous, int32 (f32_out 0) or f32 (f32_out 1: xscale 1 f32, wscale
// O f32, bias O f32 or null, relu). The tile bm x 64 (bm 64 or 128) and
// split (K cut into ``split`` nonempty ranges); with split > 1, ws is int32
// scratch of split x N x O x OH x OW and a second kernel finishes. Returns
// 0, a cudaError_t, or an encode error (mxtpu_cuda_error_string).
int mxtpu_int8_conv_wgmma(const void* x, const void* w, void* out, void* ws,
                          const void* xscale, const void* wscale,
                          const void* bias, int N, int C, int H, int W, int O,
                          int KH, int KW, int OH, int OW, int sh, int sw,
                          int ph, int pw, int dh, int dw, int G, int bm,
                          int split, int f32_out, int relu, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.xscale = static_cast<const float*>(xscale);
  p.wscale = static_cast<const float*>(wscale);
  p.bias = static_cast<const float*>(bias);
  p.N = N; p.C = C; p.H = H; p.W = W; p.O = O; p.KH = KH; p.KW = KW;
  p.OH = OH; p.OW = OW; p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw;
  p.dh = dh; p.dw = dw; p.G = G;
  p.Cg = G > 0 ? C / G : 0;
  p.Og = G > 0 ? O / G : 0;
  p.K = p.Cg * KH * KW;
  p.M = N * OH * OW;
  p.plane = OH * OW;
  p.nk = (p.K + kBK - 1) / kBK;
  p.split = split;
  p.kt_per = split > 0 ? (p.nk + split - 1) / split : 0;
  p.relu = relu;
  p.out_elems = static_cast<long long>(N) * O * p.plane;
  const long long x_elems = static_cast<long long>(N) * C * H * W;
  if (G < 1 || C % G || O % G || p.Cg % 16 || p.M < 1 || p.K < 1 ||
      (bm != 64 && bm != 128) || split < 1 ||
      (split - 1) * p.kt_per >= p.nk || (split > 1 && !ws) ||
      x_elems >= (1LL << 31) || G * split > 65535 ||
      (f32_out && (!xscale || !wscale)) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tw;
  int err = encode_weight(&tw, w, O, p.K);
  if (err) return err;
  p.out = split > 1 ? ws : out;
  p.mode = split > 1 ? 2 : (f32_out ? 1 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bm == 64 ? launch<64>(tw, p, st) : launch<128>(tw, p, st);
  if (err || split == 1) return err;
  const long long items = p.out_elems % 4 == 0 ? p.out_elems / 4
                                               : p.out_elems;
  long long blocks = (items + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  splitk_epilogue_kernel<<<static_cast<int>(blocks), 256, 0, st>>>(
      static_cast<const int*>(ws), out, split, p.out_elems, p.plane, O,
      p.xscale, p.wscale, p.bias, f32_out, relu);
  return cudaGetLastError();
}

const char* mxtpu_cuda_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
