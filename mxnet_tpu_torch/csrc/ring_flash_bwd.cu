// One backward hop of the flash ring (K6) for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/ops/ring_hop.py).
//
// Replaces, on the ring's bf16 path, the hop of
// mxnet_tpu/parallel/ring_attention.py:_ring_flash_vjp_bwd (:210), which
// runs ops/pallas_attention.py:_flash_bwd (:361) per hop with the ring's
// global out and lse and adds the gradients. Contract
// (ring_hop_bwd_reference), one launch a hop: q, dout (the position's) and
// the visiting k, v, bf16 (B, H, S, D); lse and delta = rowsum(dO * O) of
// the position, f32 (B, H, S) (delta comes from a pre-pass run once per
// position per backward, plain PyTorch, a reduction over D: it does not
// change around the ring, so no hop recomputes it); P = exp(q k^T * scale
// - lse) (0 where lse is -inf), dS = P * (dO v^T - delta) * scale rounded
// to bf16, P rounded to bf16 for dV; then, in place, into f32 sums
//   dq += dS k       (the position's, by atomics: the order of the sums,
//                     and so the last bits, vary from run to run)
//   dk += dS^T q,  dv += P^T dO   (the visiting block's travelling sums:
//                     each key tile has one CTA, a plain load-add-store)
//
// Bound on this card: 2.5 times the forward's 4 * B * H * S^2 * D
// operations (five products of 2 * D each per (q, k) pair; about half on
// the causal diagonal) at 989 TFLOP/s: 0.521 ms a hop at the ring's shard
// (1 x 12 x 8192 x 64), against 0.060 ms for its bytes (q, k, v, dout,
// lse, delta read once, the f32 sums read and written).
//
// Design: one CTA of three warpgroups per (b * H + h, 128 keys); it walks
// the query tiles of 64 rows (from the diagonal on, on the causal hop).
// Warpgroup 0 is the producer (setmaxnreg 24): one thread loads the CTA's
// K and V tiles once by TMA and then Q and dO tiles into a ring of two
// stages (a "full" and an "empty" mbarrier each); its warp's 32 lanes copy
// the tile's lse (times log2 e, +inf past S or for a -inf row, so P is 0
// there) and delta into the stage and arrive on the same barrier.
// Warpgroups 1 and 2 (240 registers) own 64 keys each and keep their dK
// and dV in f32 registers across the walk. Per tile each computes S^T =
// K Q^T and dP^T = V dO^T by wgmma m64n64k16 (K-major, both operands in
// shared memory), P^T and dS^T in registers, then dV += P^T dO and dK +=
// dS^T Q by wgmma with P^T and dS^T as the register A operand (the
// accumulator's layout) and dO, Q MN-major from shared memory. dS^T goes
// to a double-buffered swizzled tile in shared memory; after a barrier of
// the two consumer groups, one of them (alternating by tile, so that both
// do as much) computes dQ = dS K for the tile's 64 queries over the CTA's
// 128 keys by wgmma with both operands MN-major from shared memory, writes
// it to shared memory in the swizzled boxes of an f32 tensor map of dq and
// adds it into dq by TMA (cp.reduce.async.bulk.tensor .add: the f32 adds
// happen in the L2, a box at a time, not as red.global.add from each
// thread).
// The epilogue adds dK, dV into dk, dv. Ragged S: TMA fills rows past S
// with zeros, P is 0 for keys and queries past S, rows past S are not
// written. Head dims 64 and 128 (two 64-wide halves).
#include "hopper_common.cuh"

namespace {

using namespace mxtpu_hopper;

constexpr int kBlockN = 128;   // keys a CTA (two consumer warpgroups)
constexpr int kBlockM = 64;    // queries a tile
constexpr int kStages = 2;     // Q/dO tiles in flight
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;

template <int D>
struct Layout {
  static constexpr int kHalves = D / 64;
  static constexpr int kKVHalf = kBlockN * kTileRowBytes;  // 16 KB
  static constexpr int kQHalf = kBlockM * kTileRowBytes;   // 8 KB
  static constexpr int kKVBytes = kHalves * kKVHalf;       // K or V
  static constexpr int kQBytes = kHalves * kQHalf;         // Q or dO tile
  static constexpr int kDSBytes = kBlockN * kTileRowBytes; // dS^T, 128 x 64
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDS = kDO + kStages * kQBytes;
  static constexpr int kDQBytes = kBlockM * D * 4;          // dQ, f32
  static constexpr int kDQ = kDS + 2 * kDSBytes;           // one a group
  static constexpr int kLse = kDQ + 2 * kDQBytes;          // [stage][64] f32
  static constexpr int kDelta = kLse + kStages * kBlockM * 4;
  static constexpr int kBar = kDelta + kStages * kBlockM * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct BwdArgs {
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int H, S;
  float scale, scale_log2;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    ring_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq,
                    const BwdArgs a) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);

  const int n_blk = blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int n0 = n_blk * kBlockN;
  const int t_end = (a.S + kBlockM - 1) / kBlockM;
  // the causal hop: query tiles wholly before the CTA's first key are
  // masked out and skipped
  const int t_begin = a.causal ? n0 / kBlockM : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: warp 0; thread 0 issues the TMA loads ----
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKVBytes);
        for (int hh = 0; hh < L::kHalves; ++hh) {
          tma_load_4d(smem + L::kK + hh * L::kKVHalf, &tk, kv_full, hh * 64,
                      n0, h, b);
          tma_load_4d(smem + L::kV + hh * L::kKVHalf, &tv, kv_full, hh * 64,
                      n0, h, b);
        }
      }
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const long long row0 = static_cast<long long>(bh) * a.S;
        for (int r = lane; r < kBlockM; r += 32) {
          const int q = t * kBlockM + r;
          float l2 = INFINITY, dl = 0.f;
          if (q < a.S) {
            const float l = a.lse[row0 + q];
            l2 = l == -INFINITY ? INFINITY : l * kLog2e;
            dl = a.delta[row0 + q];
          }
          lse_s[s * kBlockM + r] = l2;
          delta_s[s * kBlockM + r] = dl;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::kQBytes);
          for (int hh = 0; hh < L::kHalves; ++hh) {
            tma_load_4d(smem + L::kQ + s * L::kQBytes + hh * L::kQHalf, &tq,
                        &full[s], hh * 64, t * kBlockM, h, b);
            tma_load_4d(smem + L::kDO + s * L::kQBytes + hh * L::kQHalf,
                        &tdo, &full[s], hh * 64, t * kBlockM, h, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys a warpgroup ----
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int row_in = 16 * (tid / 32) + lane / 4;  // + 8 * jj
    const int k_wg = n0 + 64 * cw;                  // first key of the group
    const uint8_t* k_rows = smem + L::kK + cw * 64 * kTileRowBytes;
    const uint8_t* v_rows = smem + L::kV + cw * 64 * kTileRowBytes;

    float dk[L::kHalves][32], dv[L::kHalves][32];
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[hh][i] = dv[hh][i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* q_tile = smem + L::kQ + s * L::kQBytes;
      const uint8_t* do_tile = smem + L::kDO + s * L::kQBytes;
      const int m0 = t * kBlockM;

      // S^T = K Q^T and dP^T = V dO^T over the head dim
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hh = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(st, sw128_desc(k_rows + hh * L::kKVHalf + off, 16),
                           sw128_desc(q_tile + hh * L::kQHalf + off, 16),
                           kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hh = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dpt,
                           sw128_desc(v_rows + hh * L::kKVHalf + off, 16),
                           sw128_desc(do_tile + hh * L::kQHalf + off, 16),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T: rows are keys, columns queries
      const float* lse_t = lse_s + s * kBlockM;
      const float* delta_t = delta_s + s * kBlockM;
      const bool causal_tile = a.causal && m0 < k_wg + 64;
      uint32_t pf[4][4], dsf[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int col = 8 * i + 2 * (lane % 4);  // query within the tile
          const int key = k_wg + row_in + 8 * (e >> 1);
          float p[2], ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = fast_exp2(fmaf(st[4 * i + e + c], a.scale_log2,
                                     -lse_t[col + c]));
            if (key >= a.S || (causal_tile && m0 + col + c < key)) x = 0.f;
            p[c] = x;
            ds[c] = x * (dpt[4 * i + e + c] - delta_t[col + c]) * a.scale;
          }
          // 16-column block i / 2, register (i % 2) * 2 + e / 2
          pf[i / 2][(i % 2) * 2 + (e >> 1)] = pack_bf16(p[0], p[1]);
          dsf[i / 2][(i % 2) * 2 + (e >> 1)] = pack_bf16(ds[0], ds[1]);
        }

      // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) {
        fence_regs(dv[hh]);
        fence_regs(dk[hh]);
      }
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh) {
          wgmma_rs_n64<1>(dv[hh], pf[kq],
                          sw128_desc(do_tile + hh * L::kQHalf + kq * 2048,
                                     L::kQHalf),
                          1);
          wgmma_rs_n64<1>(dk[hh], dsf[kq],
                          sw128_desc(q_tile + hh * L::kQHalf + kq * 2048,
                                     L::kQHalf),
                          1);
        }
      wgmma_commit();

      // dS^T into the tile's buffer: key row r, query chunk c at chunk
      // c ^ (r % 8) (the swizzle TMA writes and wgmma reads)
      uint8_t* ds_buf = smem + L::kDS + (it % 2) * L::kDSBytes;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 64 * cw + row_in + 8 * jj;
          const int off = r * kTileRowBytes + (((i ^ (r % 8)) * 16)) +
                          (lane % 4) * 4;
          *reinterpret_cast<uint32_t*>(ds_buf + off) =
              dsf[i / 2][(i % 2) * 2 + jj];
        }
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) {
        fence_regs(dv[hh]);
        fence_regs(dk[hh]);
      }
      mbar_arrive(&empty[s]);  // Q and dO of this stage are read
      fence_proxy_async();
      named_barrier(1, kConsumerThreads);

      if ((it & 1) == cw) {
        // dQ = dS K for the tile's 64 queries over the CTA's 128 keys
        float dqa[L::kHalves][32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
          for (int hh = 0; hh < L::kHalves; ++hh)
            wgmma_ss_n64<1, 1>(
                dqa[hh], sw128_desc(ds_buf + kk * 2048, L::kDSBytes),
                sw128_desc(smem + L::kK + hh * L::kKVHalf + kk * 2048,
                           L::kKVHalf),
                kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh) fence_regs(dqa[hh]);
        // dQ through shared memory (32-float boxes, 128-byte swizzled, as
        // the f32 map of dq reads them) and one TMA add a box into dq
        uint8_t* dq_buf = smem + L::kDQ + cw * L::kDQBytes;
        if (tid == 0) bulk_wait_read();  // this group's last adds read it
        named_barrier(2 + cw, 128);
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int r = row_in + 8 * jj;
              const int box = 2 * hh + i / 4;
              const int chunk = 2 * (i % 4) + (lane % 4) / 2;
              *reinterpret_cast<float2*>(
                  dq_buf + box * (kBlockM * 128) + r * 128 +
                  ((chunk ^ (r % 8)) * 16) + (lane % 2) * 8) =
                  make_float2(dqa[hh][4 * i + 2 * jj],
                              dqa[hh][4 * i + 2 * jj + 1]);
            }
        fence_proxy_async();
        named_barrier(2 + cw, 128);
        if (tid == 0) {
#pragma unroll
          for (int box = 0; box < D / 32; ++box)
            tma_reduce_add_3d(&tdq, dq_buf + box * (kBlockM * 128), box * 32,
                              m0, bh);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait();

    // ---- epilogue: dK, dV into the travelling sums (one owner a tile) ----
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int key = k_wg + row_in + 8 * jj;
      if (key >= a.S) continue;
      const long long off = (static_cast<long long>(bh) * a.S + key) * D;
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = hh * 64 + 8 * i + 2 * (lane % 4);
          float2* pk = reinterpret_cast<float2*>(a.dk + off + col);
          float2* pv = reinterpret_cast<float2*>(a.dv + off + col);
          float2 x = *pk, y = *pv;
          x.x += dk[hh][4 * i + 2 * jj];
          x.y += dk[hh][4 * i + 2 * jj + 1];
          y.x += dv[hh][4 * i + 2 * jj];
          y.y += dv[hh][4 * i + 2 * jj + 1];
          *pk = x;
          *pv = y;
        }
    }
  }
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const CUtensorMap& tdo,
           const CUtensorMap& tdq, const BwdArgs& a, int B, int H, int S,
           cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ring_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockN - 1) / kBlockN, B * H);
  ring_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, tdq,
                                                        a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout: bf16 (B, H, S, D) with 12 element strides (batch, head,
// seq) of q, k, v, dout in that order (unit stride in D; TMA needs bases
// and strides on 16 bytes, the wrapper checks). lse, delta: f32 (B, H, S)
// contiguous. dq, dk, dv: f32 (B, H, S, D) contiguous, added into. D: 64
// or 128. Returns 0, a cudaError_t, or an encode error
// (mxtpu_ring_hop_error_string).
int mxtpu_ring_flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, int B, int H, int S,
                         int D, const long long* strides, float scale,
                         int causal, void* stream) {
  if (B < 1 || H < 1 || S < 1 || (D != 64 && D != 128) || B * H > 65535 ||
      !lse || !delta || !dq || !dk || !dv)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = encode_bhsd(&tq, q, B, H, S, D, strides, kBlockM);
  if (!err) err = encode_bhsd(&tk, k, B, H, S, D, strides + 3, kBlockN);
  if (!err) err = encode_bhsd(&tv, v, B, H, S, D, strides + 6, kBlockN);
  if (!err) err = encode_bhsd(&tdo, dout, B, H, S, D, strides + 9, kBlockM);
  if (!err) err = encode_f32_rows(&tdq, dq, B * H, S, D, kBlockM);
  if (err) return err;
  BwdArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.H = H;
  a.S = S;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(tq, tk, tv, tdo, tdq, a, B, H, S, st)
                 : launch<128>(tq, tk, tv, tdo, tdq, a, B, H, S, st);
}

const char* mxtpu_ring_hop_error_string(int code) { return error_string(code); }

}  // extern "C"
