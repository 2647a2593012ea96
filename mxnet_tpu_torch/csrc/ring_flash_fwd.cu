// One forward hop of the flash ring (K6) for Hopper (sm_90a), CUDA C++ with
// a plain C interface (loaded with ctypes by mxnet_tpu_torch/ops/ring_hop.py).
//
// Replaces, on the ring's bf16 path, the hop of
// mxnet_tpu/parallel/ring_attention.py:_ring_flash_fwd_impl (:119), which
// runs ops/pallas_attention.py:_flash_fwd (:179) per hop and merges the
// partials by their logsumexp. Contract (ring_hop_fwd_reference): the
// position's local Q shard (B, H, S, D) attends to the visiting K/V block
// (same shape); the hop's partial, in f32 and never rounded, merges
// exactly into the position's running state
//   lse = logaddexp(lse_a, lse_b)
//   out = exp(lse_a - lse) * out_a + exp(lse_b - lse) * out_b
// held as acc (f32, (B, H, S, D), contiguous) and lse (f32, (B, H, S)).
// ``first``: the state is empty and not read. ``last``: the merged output
// goes to ``out`` in bf16 (any (batch, head, seq) strides, e.g. the (B, S,
// H, D) memory the ring returns) and acc is not written; lse always takes
// the merged value. Causal: the diagonal hop, keys k <= query q.
//
// Bound on this card: 4 * B * H * S^2 * D operations a hop (QK^T and PV;
// about half on the causal diagonal) at 989 TFLOP/s on the tensor cores;
// at the ring's shard (1 x 12 x 8192 x 64) that is 0.208 ms a hop against
// 0.026 ms for its bytes (q, k, v read once, the f32 state read and
// written), so operations bound it.
//
// Design: one CTA per (b * H + h, 64 query rows per consumer warpgroup):
// three consumer warpgroups at D 64 (192 rows, 160 registers each), two at
// D 128 (128 rows, 240 registers), and a producer warpgroup that gives up
// its registers (setmaxnreg 24) and whose one thread issues the TMA loads,
// Q once and then the K and V tiles of 128 keys into a ring of three
// shared-memory stages, each with a "full" mbarrier (its TMA bytes) and an
// "empty" one (every consumer thread arrives). Each consumer warpgroup
// computes S = Q K^T by wgmma m64n128k16 with both operands in swizzled
// shared memory (K-major) and O += P V by wgmma m64n64k16 with P, rounded
// to bf16, in registers as the A operand (the accumulator layout of S is
// the A layout, so no shuffle) and V MN-major from shared memory. Each
// step issues S of the next tile and P V of this one back to back, then
// runs the next tile's online softmax (base 2, one FFMA and one MUFU.EX2 a
// score; masks only in a tile at the ragged edge or the causal diagonal;
// tiles above the diagonal are not loaded) while P V is on the tensor
// cores. The epilogue is the merge: it reads the rows' running (out,
// lse), merges this hop's (O / l, m + log l) into them and writes back,
// or on the last hop writes the bf16 output and the final lse. Ragged S:
// TMA fills rows past S with zeros, scores past S are masked, rows past S
// are not written. Head dims 64 and 128 (two 64-wide halves).
#include "hopper_common.cuh"

namespace {

using namespace mxtpu_hopper;

constexpr int kBlockN = 128;   // keys a K/V tile
constexpr int kStages = 3;     // K/V tiles in flight

// consumer warpgroups (64 query rows each) and their registers: three at
// D 64 (S 64, O 32 and P 32 registers a thread fit in 160), two at D 128
template <int D>
struct Groups {
  static constexpr int kN = D == 64 ? 3 : 2;
  static constexpr int kRegs = D == 64 ? 160 : 240;
  static constexpr int kBlockM = 64 * kN;         // query rows a CTA
  static constexpr int kThreads = 128 * (kN + 1);  // and the producer's
};

template <int D>
struct Layout {
  static constexpr int kHalves = D / 64;
  static constexpr int kQHalf = Groups<D>::kBlockM * kTileRowBytes;
  static constexpr int kKVHalf = kBlockN * kTileRowBytes;  // 16 KB
  static constexpr int kQBytes = kHalves * kQHalf;
  static constexpr int kKVBytes = kHalves * kKVHalf;       // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct FwdArgs {
  float* acc;
  float* lse;
  __nv_bfloat16* out;
  long long out_st[3];  // (batch, head, seq) element strides of out
  int H, S;
  float scale_log2;     // the softmax scale times log2(e)
  int causal, first, last;
};

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float mx = fmaxf(a, b);
  if (mx == -INFINITY) return -INFINITY;
  return mx + log1pf(expf(-fabsf(a - b)));
}

// S = Q K^T over the head dim, 16 at a time (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[64], const uint8_t* q,
                                        const uint8_t* k) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int hh = kk / 4, off = (kk % 4) * 32;
    wgmma_ss_n128<0, 0>(sc, sw128_desc(q + hh * L::kQHalf + off, 16),
                        sw128_desc(k + hh * L::kKVHalf + off, 16), kk > 0);
  }
}

// O += P V over a tile's keys, 16 at a time, per 64-wide half
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 64][32],
                                         const uint32_t (&pf)[8][4],
                                         const uint8_t* v) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
      wgmma_rs_n64<1>(o[hh], pf[kk],
                      sw128_desc(v + hh * L::kKVHalf + kk * 2048, L::kKVHalf),
                      1);
}

// The online softmax of one tile in base 2: masks (the ragged edge, the
// causal diagonal), the new row maxima, p = 2^(s * scale - m) in place of
// s, l = l * corr + the thread's row sums of the unrounded p; corr, the
// factor that takes O to the new maxima, is returned for the caller.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], int n0,
                                             int r_wg, int row0, int lane,
                                             const FwdArgs& a,
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2]) {
  const bool edge =
      n0 + kBlockN > a.S || (a.causal && n0 + kBlockN - 1 > r_wg);
  float mx[2] = {m_run[0], m_run[1]};  // raw scores (scale > 0)
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int col = n0 + 8 * i + 2 * (lane % 4) + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (col >= a.S || (a.causal && col > row)) sc[4 * i + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
    }
  float neg_base[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 1));
    mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 2));
    const float base = mx[jj] == -INFINITY ? 0.f : mx[jj] * a.scale_log2;
    corr[jj] = fast_exp2(m_run[jj] * a.scale_log2 - base);
    m_run[jj] = mx[jj];
    l_run[jj] *= corr[jj];
    neg_base[jj] = -base;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          fast_exp2(fmaf(sc[4 * i + e], a.scale_log2, neg_base[e >> 1]));
      l_run[e >> 1] += p;
      sc[4 * i + e] = p;
    }
}

// O to the new row maxima (the factor from softmax_tile)
template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 64][32],
                                          const float (&corr)[2]) {
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] *= corr[(i >> 1) & 1];
    fence_regs(o[hh]);
  }
}

template <int D>
__global__ void __launch_bounds__(Groups<D>::kThreads, 1)
    ring_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const FwdArgs a) {
  using L = Layout<D>;
  constexpr int kBlockM = Groups<D>::kBlockM;
  constexpr int kConsumerThreads = 128 * Groups<D>::kN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // the heaviest query blocks (the causal diagonal's last) first
  const int m_blk = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int m0 = m_blk * kBlockM;
  int n_tiles = (a.S + kBlockN - 1) / kBlockN;
  if (a.causal) n_tiles = min(n_tiles, (m0 + kBlockM - 1) / kBlockN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int hh = 0; hh < L::kHalves; ++hh)
        tma_load_4d(smem + L::kQ + hh * L::kQHalf, &tq, q_full, hh * 64, m0,
                    h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kKVBytes);
        for (int hh = 0; hh < L::kHalves; ++hh) {
          tma_load_4d(smem + L::kK + s * L::kKVBytes + hh * L::kKVHalf, &tk,
                      &full[s], hh * 64, j * kBlockN, h, b);
          tma_load_4d(smem + L::kV + s * L::kKVBytes + hh * L::kKVHalf, &tv,
                      &full[s], hh * 64, j * kBlockN, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    setmaxnreg_inc<Groups<D>::kRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r_wg = m0 + 64 * cw;                       // the group's rows
    const int row0 = r_wg + 16 * (tid / 32) + lane / 4;  // + 8 * jj
    const uint8_t* q_tile = smem + L::kQ + cw * 64 * kTileRowBytes;

    float o[L::kHalves][32];
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's columns; summed at the end
    float corr[2];
    float sc[64];
    uint32_t pf[8][4];

    // S of the first tile, its softmax
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s<D>(sc, q_tile, smem + L::kK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, 0, r_wg, row0, lane, a, m_run, l_run, corr);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // every step but the last issues S of the next tile and P V of this
    // one, then runs the next tile's softmax while P V is on the tensor
    // cores; no wgmma sits in a branch (ptxas serialises the pipeline
    // around one). O goes to this tile's maxima before the step's
    // products: no other instruction may touch an accumulator between a
    // step's products and their wait
    for (int j = 0; j + 1 < n_tiles; ++j) {
      rescale_o<D>(o, corr);
      const int s1 = (j + 1) % kStages;
      mbar_wait(&full[s1], ((j + 1) / kStages) & 1);
      wgmma_fence();
      issue_s<D>(sc, q_tile, smem + L::kK + s1 * L::kKVBytes);
      wgmma_commit();
      issue_pv<D>(o, pf, smem + L::kV + (j % kStages) * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile(sc, (j + 1) * kBlockN, r_wg, row0, lane, a, m_run, l_run,
                   corr);
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) fence_regs(o[hh]);
      mbar_arrive(&empty[j % kStages]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
    // the last tile's P V
    rescale_o<D>(o, corr);
    wgmma_fence();
    issue_pv<D>(o, pf, smem + L::kV + ((n_tiles - 1) % kStages) * L::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh) fence_regs(o[hh]);

    // ---- epilogue: the merge into the running state ----
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float l = l_run[jj];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * jj;
      if (row >= a.S) continue;
      const float lse_b =
          l > 0.f ? (m_run[jj] * a.scale_log2 + log2f(l)) * kLn2 : -INFINITY;
      float w_a = 0.f, w_b = l > 0.f ? 1.f / l : 0.f, lse_new = lse_b;
      const long long rs = static_cast<long long>(bh) * a.S + row;
      if (!a.first) {
        const float lse_a = a.lse[rs];
        lse_new = logaddexp(lse_a, lse_b);
        const float safe = lse_new == -INFINITY ? 0.f : lse_new;
        w_a = lse_a == -INFINITY ? 0.f : expf(lse_a - safe);
        w_b = lse_b == -INFINITY ? 0.f : expf(lse_b - safe) * w_b;
      }
      float* acc_row = a.acc + rs * D;
      __nv_bfloat16* out_row =
          a.out + b * a.out_st[0] + h * a.out_st[1] + row * a.out_st[2];
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = hh * 64 + 8 * i + 2 * (lane % 4);
          float v0 = o[hh][4 * i + 2 * jj] * w_b;
          float v1 = o[hh][4 * i + 2 * jj + 1] * w_b;
          if (!a.first) {
            const float2 prev = *reinterpret_cast<const float2*>(acc_row + col);
            v0 = fmaf(w_a, prev.x, v0);
            v1 = fmaf(w_a, prev.y, v1);
          }
          if (a.last)
            *reinterpret_cast<__nv_bfloat162*>(out_row + col) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(acc_row + col) = make_float2(v0, v1);
        }
      if (lane % 4 == 0) a.lse[rs] = lse_new;
    }
  }
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const FwdArgs& a, int B, int H, int S,
           cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ring_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + Groups<D>::kBlockM - 1) / Groups<D>::kBlockM, B * H);
  ring_fwd_kernel<D><<<grid, Groups<D>::kThreads, smem, stream>>>(tq, tk, tv,
                                                                  a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: bf16 (B, H, S, D) with 12 element strides (batch, head, seq) of
// q, k, v, out in that order (unit stride in D; TMA needs bases and strides
// on 16 bytes, the wrapper checks). acc: f32 (B, H, S, D) contiguous (read
// unless first, written unless last; may be null when both). lse: f32
// (B, H, S) contiguous. out: bf16, written when last. D: 64 or 128.
// Returns 0, a cudaError_t, or an encode error (mxtpu_ring_hop_error_string).
int mxtpu_ring_flash_fwd(const void* q, const void* k, const void* v,
                         void* acc, void* lse, void* out, int B, int H, int S,
                         int D, const long long* strides, float scale,
                         int causal, int first, int last, void* stream) {
  if (B < 1 || H < 1 || S < 1 || (D != 64 && D != 128) || B * H > 65535 ||
      (!(first && last) && !acc) || (last && !out) || !lse)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = encode_bhsd(&tq, q, B, H, S, D, strides,
                        D == 64 ? Groups<64>::kBlockM : Groups<128>::kBlockM);
  if (!err) err = encode_bhsd(&tk, k, B, H, S, D, strides + 3, kBlockN);
  if (!err) err = encode_bhsd(&tv, v, B, H, S, D, strides + 6, kBlockN);
  if (err) return err;
  FwdArgs a;
  a.acc = static_cast<float*>(acc);
  a.lse = static_cast<float*>(lse);
  a.out = static_cast<__nv_bfloat16*>(out);
  for (int i = 0; i < 3; ++i) a.out_st[i] = strides[9 + i];
  a.H = H;
  a.S = S;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  a.first = first;
  a.last = last;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(tq, tk, tv, a, B, H, S, st)
                 : launch<128>(tq, tk, tv, a, B, H, S, st);
}

const char* mxtpu_ring_hop_error_string(int code) { return error_string(code); }

}  // extern "C"
