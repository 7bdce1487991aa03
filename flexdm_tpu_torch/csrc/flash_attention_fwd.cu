// Flash-attention forward for Hopper (sm_90a), float32 in and out, both
// products on the tensor cores.
//
// Replaces the TPU kernel flexdm_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_forward).  Same contract: for every (batch, head,
// query row) it computes softmax(q k^T / sqrt(Dh) + bias) v with an online
// softmax over key tiles (running max m, running sum l, accumulator in
// f32) and writes O (B, H, S, Dh), the row logsumexp (B, H, S), and the
// row max m and row sum l (B, H, S) that the backward kernels rebuild the
// probabilities from (p = exp(s - m) / l; see flash_attention_bwd.cu for
// why lse alone is not enough).
//
// Masking follows the plain reference (_attention_xla), not the padded TPU
// path:
//   * a key whose mask entry is false gets the FINITE additive bias -1e9,
//     so a fully masked row averages V over the S real keys instead of
//     producing NaN: every score of the row rounds to exactly -1e9 in
//     float32 (|q.k| / sqrt(Dh) < 32), so m = -1e9 and l = S exactly;
//   * with `causal`, a key after the query row (absolute positions) gets the
//     score -1e9 (replaced, like jnp.where in the reference);
//   * keys at index >= S (the ragged tail of the last tile) are excluded
//     outright (score -inf, p = 0): nothing is padded in device memory.
//
// Arithmetic.  S = Q K^T and O += P V are mma.sync.m16n8k8 with TF32
// operands split hi + lo, three MMAs per k-step summed from zero and added
// to the FP32 accumulator (mma3 in mma_tf32.cuh): float32-level accuracy
// (~1e-6), where one TF32 pass misses the 2e-5 gate of the card checks
// (tests/test_torch_attention.py emulates both).
//
// What bounded the previous design.  It ran on the FMA pipes, one query row
// at a time per warp, and every FMA read its two operands as separate 4-byte
// shared loads (q_s[r][d] and k_s[j][d] for a score, p_s[j] and v_s[j][c]
// for P V): ~200 warp-wide shared loads per query row at Dh=32, and an SM
// issues about one per clock.  At (B, H, S, Dh) = (256, 8, 50, 32) that is
// ~26 M loads, ~0.11 ms on 132 SMs at ~1.75 GHz (measured 0.119 ms); at
// (8, 8, 650, 32) ~0.49 ms (measured 0.419 ms, 2% slower than plain
// PyTorch).  It also staged each head's K/V once per 16-row query tile.
//
// What bounds this one.  An m16n8k8 MMA does 1024 multiply-adds for two
// 4-byte shared loads of its B fragment, so shared memory is no longer the
// limit; the split costs about four integer or FP32 instructions per
// operand value beside each three MMAs.  Measured on an H100 at 700 W
// (tools/torch_fwd_bench.py; PERF.md), against plain PyTorch, which the
// kernel beats at every shape:
//   * (256, 8, 50, 32), the training shape: ~0.046 ms for 2048 blocks of
//     64 rows, one K/V tile each (each head's K/V is read once), against
//     a bound of 0.016 ms (53.7 MB at 3.35 TB/s).  Neither bytes (~35% of
//     the memory rate) nor instruction issue bound it: with ~220 registers
//     a thread, two blocks (8 warps) fit on an SM, too few to hide the
//     latency of the dependent MMA and exp chains.  Four blocks per SM
//     (128 registers) measured 15% faster here but slower at S=650 and at
//     the serving shape; overlapping the next block's loads with this
//     one's compute (a persistent grid) measured no faster.
//   * (8, 8, 650, 32): ~0.12 ms for 704 blocks of 11 key tiles, ~11 GFLOP
//     of split-TF32 MMA work (3.46 GFLOP useful), ~95 TFLOP/s: bound by
//     the issue of the MMAs and the split, as the backward kernels are.
//   * (8, 8, 50, 32), the serving shape: 64 blocks, ~6 us: launch latency.
//
// Design.
//   * One block per (batch, head, 64 query rows) of 4 warps; each warp owns
//     16 rows and loops over all key tiles of 64 keys (32 at Dh=128), so a
//     head's K/V is read once per 64 query rows, once at S <= 64.  32- and
//     16-row tiles (FLEXDM_FWD_WARPS 2, 1) measured slower at all three
//     shapes, the serving shape's 64 blocks included.
//   * Q stays in registers: each warp splits its Q fragments into hi and lo
//     once and reuses them for every key tile (Dh registers; at Dh=128,
//     off the main path, Q stays in shared memory and is split per tile).
//   * K/V tiles arrive by 16-byte cp.async into a two-stage ring (tile i+1
//     loads while tile i computes; one stage when S fits one tile), rows
//     padded to Dh + 4 floats (conflict-free fragment loads), rows past S
//     zero-filled by the copy; the key bias of each tile goes beside it.
//     Splitting each tile into hi and lo once in shared memory, instead of
//     in every warp's registers, measured within +-4%: not kept.
//   * The online softmax runs on the accumulator fragments: a lane holds
//     rows g and g + 8, so a row's max and sum take two __shfl_xor within
//     its quad.  P then serves as the A operand of P V with no data
//     movement (from_acc, with V loaded in the same permuted key order).
//   * A warp whose 16 rows all lie past S skips the arithmetic.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "mma_tf32.cuh"

// Warps per block, 16 query rows each: 4 (64-row tiles) by default; 1 and 2
// build the 16- and 32-row variants that the tile measurement compares.
#ifndef FLEXDM_FWD_WARPS
#define FLEXDM_FWD_WARPS 4
#endif

namespace {

constexpr int kWarps = FLEXDM_FWD_WARPS;
static_assert(kWarps == 1 || kWarps == 2 || kWarps == 4,
              "1, 2 or 4 warps per block");
constexpr int kThreads = kWarps * 32;

template <int DH>
struct FwdTile {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kRows = 16 * kWarps;           // query rows per block
  static constexpr int kKeys = DH <= 64 ? 64 : 32;    // keys per K/V tile
  static constexpr int kLd = DH + kPad;
  static constexpr bool kQInRegs = DH <= 64;
  static constexpr int kOwnFloats = kRows * kLd;                // Q
  static constexpr int kStageFloats = 2 * kKeys * kLd + kKeys;  // K, V, bias
};


template <int DH>
// The minimum of one block per SM lets ptxas keep more values in registers
// (222 at Dh=32, against 178 without the hint; two blocks per SM either
// way): 8-20% faster at the main-path shapes (tools/torch_fwd_bench.py).
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ key_mask,
                 float* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ row_max, float* __restrict__ row_sum,
                 int H, int S, int causal, float scale) {
  using T = FwdTile<DH>;
  constexpr int BK = T::kKeys;
  constexpr int LD = T::kLd;
  constexpr int NT = BK / 8;  // score n-tiles per key tile (k-steps of P V)
  constexpr int KS = DH / 8;  // k-steps of Q K^T (n-tiles of O)
  constexpr int kBiasPerThread = (BK + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;  // [kRows][LD]
  // Stage i & 1 of the ring: K [BK][LD], V [BK][LD], key bias [BK].
  auto stage = [&](int i) {
    return smem + T::kOwnFloats + (i & 1) * T::kStageFloats;
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
    load_rows<BK, DH, kThreads>(stage(i), k + head * DH, i * BK, S, tid);
    load_rows<BK, DH, kThreads>(stage(i) + BK * LD, v + head * DH, i * BK, S,
                                tid);
  };
  load_rows<T::kRows, DH, kThreads>(q_s, q + head * DH, q0, S, tid);
  load_kv(0);
  cp_async_commit();
  for (int j = tid; j < BK; j += kThreads)
    stage(0)[2 * BK * LD + j] = key_bias(key_mask, b, S, j);

  // The lane's rows are g (index 0) and g + 8 (index 1) of the warp's 16.
  FragA qf[T::kQInRegs ? KS : 1];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc[KS][4] = {};
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

    const float* k_s = stage(i);
    const float* v_s = k_s + BK * LD;
    const float* bias_s = v_s + BK * LD;
    const int n_keys = min(BK, S - k0);
    if (active) {
      if constexpr (T::kQInRegs) {
        if (i == 0) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            qf[ks] = load_a<LD>(q_s, r0, 8 * ks, g, t);
        }
      }
      // s = q k^T for the warp's 16 rows and the tile's BK keys.
      float sc[NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        FragA qa;
        if constexpr (T::kQInRegs) {
          qa = qf[ks];
        } else {
          qa = load_a<LD>(q_s, r0, 8 * ks, g, t);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma3(sc[j], qa, load_bt<LD>(k_s, 8 * j, 8 * ks, g, t));
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
      for (int n = 0; n < KS; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // O += P V, P straight from the score accumulators.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const FragA pa = from_acc(sc[j]);
#pragma unroll
        for (int n = 0; n < KS; ++n)
          mma3(acc[n], pa, load_b_paired<LD>(v_s, 8 * j, 8 * n, g, t));
      }
    }
    if (i + 1 < n_tiles) {
#pragma unroll
      for (int n = 0; n < kBiasPerThread; ++n) {
        const int j = tid + n * kThreads;
        if (j < BK) stage(i + 1)[2 * BK * LD + j] = next_bias[n];
      }
    }
    __syncthreads();  // stage i is consumed before tile i + 2 overwrites it
  }

  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(o + (head + row) * DH + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hh] / l[hh], acc[n][2 * hh + 1] / l[hh]);
    if (t == 0) {
      lse[head + row] = m[hh] + logf(l[hh]);
      row_max[head + row] = m[hh];
      row_sum[head + row] = l[hh];
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const uint8_t* key_mask, float* o, float* lse,
                   float* row_max, float* row_sum, int B, int H, int S,
                   int causal, cudaStream_t stream) {
  using T = FwdTile<DH>;
  static const cudaError_t attr =
      allow_smem(flash_fwd_kernel<DH>, smem_bytes<T>(2));
  if (attr != cudaSuccess) return attr;
  const int bytes = smem_bytes<T>(S > T::kKeys ? 2 : 1);
  const dim3 grid((S + T::kRows - 1) / T::kRows, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_fwd_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, o, lse, row_max, row_sum, H, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, S, Dh) float32, contiguous, 16-byte aligned.
// key_mask: (B, S) bool (one byte per key, nonzero = attend) or null for
// "all keys valid".  lse, row_max, row_sum: (B, H, S) float32.  Returns the
// cudaError_t of the launch.
extern "C" int flexdm_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* key_mask,
                                          void* o, void* lse, void* row_max,
                                          void* row_sum, int B, int H, int S,
                                          int Dh, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* mf = static_cast<float*>(row_max);
  auto* sf = static_cast<float*>(row_sum);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch<32>(qf, kf, vf, mask, of, lf, mf, sf, B, H, S, causal, st);
      break;
    case 64:
      err = launch<64>(qf, kf, vf, mask, of, lf, mf, sf, B, H, S, causal, st);
      break;
    case 128:
      err = launch<128>(qf, kf, vf, mask, of, lf, mf, sf, B, H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
