// Flash-attention forward for Hopper (sm_90a), the bf16 instance: q, k, v
// and O in bf16, lse, m and l in float32, both products on the bf16 tensor
// cores.
//
// Replaces the TPU kernel flexdm_tpu/ops/attention.py:_flash_fwd_kernel for
// bf16 inputs (the JAX package's --dtype bfloat16), with the contract of
// the float32 kernel flash_attention_fwd.cu: softmax(q k^T / sqrt(Dh) +
// bias) v by an online softmax over key tiles, O (B, H, S, Dh), and the row
// logsumexp, max m and sum l (B, H, S) that the backward kernels rebuild p
// from.  Masking is the float32 kernel's: the finite -1e9 key bias (a fully
// masked row averages V over its S real keys), the causal band replaced by
// -1e9 on absolute positions, keys past S excluded outright.
//
// Arithmetic.  S = Q K^T is mma.sync.m16n8k16 on the exact bf16 operands,
// summed in float32; the scale, bias, masks, the online softmax (m, l, the
// rescale of the accumulator) and the final division stay float32.  P
// enters O += P V as a bf16 operand (rounded to nearest even from the
// float32 p; l sums the float32 p), the one rounding that the TPU kernel,
// which keeps p in float32, does not do.  O is rounded to bf16 once, at
// the end.  The CPU emulation of this arithmetic in
// tests/test_torch_attention_bf16.py meets the card's bar (one bf16 ulp
// plus 2^-8 of max|O| against the plain version) with P in one bf16 term,
// so P is not split.
//
// What bounds it.  At the training shape (256, 8, 50, 32) the useful work
// is 0.66 GFLOP and the traffic 27 MB (q, k, v, O in bf16; lse, m, l in
// float32): 0.008 ms at 3.35 TB/s against 0.0007 ms at the bf16 peak, so
// bytes bound it; measured 0.016 ms on an H100 at 700 W (chip_smoke.py;
// the float32 kernel 0.047 ms), 2048 blocks of one key tile each, where
// the latency of the load -> two products -> store chain shows.  At
// (64, 8, 500, 32) 0.159 ms against a bound of 0.021 ms (float32 kernel
// 0.461 ms); what holds it there (the per-score float32 softmax work, the
// rate of MMA instructions) is not measured yet.
//
// Design (the float32 kernel's tiling, with bf16 tiles and fragments).
//   * One block per (batch, head, 64 query rows) of 4 warps; each warp owns
//     16 rows and loops over all key tiles of 64 keys.
//   * Q fragments are loaded once (ldmatrix) and kept in registers: Dh / 4
//     registers a lane.
//   * K/V tiles arrive by 16-byte cp.async into a two-stage ring (one stage
//     when S fits one tile), rows padded to Dh + 8 bf16 (mma_bf16.cuh),
//     rows past S zero-filled; the tile's key bias goes beside it.
//   * K, row-major, is the .col B operand of Q K^T by a plain ldmatrix; V
//     is the B operand of P V by ldmatrix.trans.  P goes from the score
//     accumulators to the A operand in registers (acc_to_a).
//   * A warp whose 16 rows all lie past S skips the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int DH>
struct FwdTileBf16 {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kRows = 16 * kWarps;  // query rows per block
  static constexpr int kKeys = 64;           // keys per K/V tile
  static constexpr int kLd = DH + kPadBf16;
  static constexpr int kOwnBytes = kRows * kLd * 2;  // Q
  // K, V (bf16) and the key bias (float32).
  static constexpr int kStageBytes = 2 * kKeys * kLd * 2 + kKeys * 4;
  static_assert(kOwnBytes % 16 == 0 && kStageBytes % 16 == 0,
                "stages must stay 16-byte aligned");
  static constexpr int bytes(int stages) {
    return kOwnBytes + stages * kStageBytes;
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const uint8_t* __restrict__ key_mask,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ row_max, float* __restrict__ row_sum,
                      int H, int S, int causal, float scale) {
  using T = FwdTileBf16<DH>;
  constexpr int BK = T::kKeys;
  constexpr int LD = T::kLd;
  constexpr int NT = BK / 8;   // score n-tiles per key tile
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int NO = DH / 8;   // n-tiles of O
  constexpr int kBiasPerThread = (BK + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows][LD]
  // Stage i & 1 of the ring: K [BK][LD], V [BK][LD], key bias [BK].
  auto k_tile = [&](int i) {
    return reinterpret_cast<bf16*>(smem + T::kOwnBytes +
                                   (i & 1) * T::kStageBytes);
  };
  auto bias_tile = [&](int i) {
    return reinterpret_cast<float*>(k_tile(i) + 2 * BK * LD);
  };

  const int q0 = blockIdx.x * T::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * S;  // row of (b,h,0)
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = tid / 32 * 16;  // the warp's first row in the block
  const bool active = q0 + r0 < S;

  const int n_tiles = (S + BK - 1) / BK;
  auto load_kv = [&](int i) {
    load_rows_bf16<BK, DH, kThreads>(k_tile(i), k + head * DH, i * BK, S, tid);
    load_rows_bf16<BK, DH, kThreads>(k_tile(i) + BK * LD, v + head * DH,
                                     i * BK, S, tid);
  };
  load_rows_bf16<T::kRows, DH, kThreads>(q_s, q + head * DH, q0, S, tid);
  load_kv(0);
  cp_async_commit();
  for (int j = tid; j < BK; j += kThreads)
    bias_tile(0)[j] = key_bias(key_mask, b, S, j);

  // The lane's rows are g (index 0) and g + 8 (index 1) of the warp's 16.
  uint32_t qf[KS][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc[NO][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * BK;
    float next_bias[kBiasPerThread];
    if (i + 1 < n_tiles) {
      load_kv(i + 1);
#pragma unroll
      for (int n = 0; n < kBiasPerThread; ++n) {
        const int j = tid + n * kThreads;
        if (j < BK) next_bias[n] = key_bias(key_mask, b, S, k0 + BK + j);
      }
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile i (and Q) landed for every thread

    const bf16* k_s = k_tile(i);
    const bf16* v_s = k_s + BK * LD;
    const float* bias_s = bias_tile(i);
    const int n_keys = min(BK, S - k0);
    if (active) {
      if (i == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          frag_a<LD>(qf[ks], q_s, r0, 16 * ks, lane);
      }
      // s = q k^T for the warp's 16 rows and the tile's BK keys.
      float sc[NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kb[4];
          frag_bt<LD>(kb, k_s, 8 * j, 16 * ks, lane);
          mma_bf16_x2(sc[j], sc[j + 1], qf[ks], kb);
        }
      }

      // Scale, bias and masks; the tile's row max.  sc[j][e] is row
      // g + 8 * (e >> 1), key 8 j + 2 t + (e & 1) of the tile.
      float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          float s;
          if (kj >= n_keys) {
            s = -CUDART_INF_F;
          } else if (causal && k0 + kj > row) {
            s = kMaskedScore;
          } else {
            s = sc[j][e] * scale + bias_s[kj];
          }
          sc[j][e] = s;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s);
        }
      }
      // Online softmax.  The tile's first key exists, so every row's max is
      // finite after the first tile; alpha is 0 on the first tile.
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = tile_max[hh];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[hh], x);
        alpha[hh] = expf(m[hh] - m_new);
        m[hh] = m_new;
      }
      float p_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[j][e] - m[e >> 1]);
          sc[j][e] = p;
          p_sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = p_sum[hh];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        l[hh] = l[hh] * alpha[hh] + x;
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // O += P V, P (bf16) straight from the score accumulators.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t vb[4];
          frag_b_trans<LD>(vb, v_s, 16 * kk, 8 * n, lane);
          mma_bf16_x2(acc[n], acc[n + 1], pa, vb);
        }
      }
    }
    if (i + 1 < n_tiles) {
#pragma unroll
      for (int n = 0; n < kBiasPerThread; ++n) {
        const int j = tid + n * kThreads;
        if (j < BK) bias_tile(i + 1)[j] = next_bias[n];
      }
    }
    __syncthreads();  // stage i is consumed before tile i + 2 overwrites it
  }

  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    if (row >= S) continue;
    const float inv_l = 1.f / l[hh];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(o + (head + row) * DH + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * hh] * inv_l, acc[n][2 * hh + 1] * inv_l);
    if (t == 0) {
      lse[head + row] = m[hh] + logf(l[hh]);
      row_max[head + row] = m[hh];
      row_sum[head + row] = l[hh];
    }
  }
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const uint8_t* key_mask, bf16* o, float* lse,
                   float* row_max, float* row_sum, int B, int H, int S,
                   int causal, cudaStream_t stream) {
  using T = FwdTileBf16<DH>;
  static const cudaError_t attr =
      allow_smem(flash_fwd_bf16_kernel<DH>, T::bytes(2));
  if (attr != cudaSuccess) return attr;
  const int bytes = T::bytes(S > T::kKeys ? 2 : 1);
  const dim3 grid((S + T::kRows - 1) / T::kRows, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_fwd_bf16_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, o, lse, row_max, row_sum, H, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, S, Dh) bf16, contiguous, 16-byte aligned.  key_mask:
// (B, S) bool (one byte per key, nonzero = attend) or null for "all keys
// valid".  lse, row_max, row_sum: (B, H, S) float32.  Returns the
// cudaError_t of the launch.
extern "C" int flexdm_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* o, void* lse, void* row_max, void* row_sum, int B, int H, int S,
    int Dh, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* ob = static_cast<bf16*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* mf = static_cast<float*>(row_max);
  auto* sf = static_cast<float*>(row_sum);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch<32>(qb, kb, vb, mask, ob, lf, mf, sf, B, H, S, causal, st);
      break;
    case 64:
      err = launch<64>(qb, kb, vb, mask, ob, lf, mf, sf, B, H, S, causal, st);
      break;
    case 128:
      err = launch<128>(qb, kb, vb, mask, ob, lf, mf, sf, B, H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
