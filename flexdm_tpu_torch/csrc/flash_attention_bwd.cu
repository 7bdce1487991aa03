// Flash-attention backward for Hopper (sm_90a), float32 in and out, every
// product on the tensor cores.
//
// Replaces the TPU kernels of flexdm_tpu/ops/attention.py:
//   * _flash_bwd_dq_kernel and _flash_bwd_dq_stream_kernel -> the dq kernel
//     here, which also computes delta = rowsum(dO * O) (the XLA glue of
//     _attention_pallas_bwd) for its rows and writes it for the dkv kernel;
//   * _flash_bwd_dkv_kernel and _flash_bwd_dkv_stream_kernel -> the dkv
//     kernel here.
// The TPU needed the stream variants because its resident form kept whole
// (S, Dh) arrays in VMEM and overflowed the 16 MB limit from S=4096.  These
// kernels keep only tiles in shared memory and loop over the other axis
// inside the block, so one kernel covers every S.
//
// Contract (the plain version is attention_reference_backward in
// ops/attention.py, written out as the formulas autograd computes):
//   p     = softmax(s),  s = q k^T / sqrt(Dh) + bias, causal band replaced
//   delta = rowsum(dO * O)
//   ds    = p * (dO v^T - delta), and 0 where the causal band replaced s
//           (the replacement is a jnp.where / masked_fill: no gradient)
//   dq    = scale * ds k,   dk = scale * ds^T q,   dv = p^T dO
//
// p is rebuilt as exp(s - m) / l from the forward's row max m and row sum l,
// NOT as exp(s - lse).  In a fully masked row every score is -1e9 + q.k,
// which rounds to exactly -1e9 in float32 for |q.k| < 32 (the spacing of
// floats at 1e9 is 64), so lse = m + log(l) also rounds to m and
// exp(s - lse) would give p = 1 for every key, where the softmax gives 1/S.
// Here s rounds to -1e9 = m as well, the forward summed l = S, and
// exp(0) / S = 1/S.  The TPU kernels rebuild p from lse and differ from
// their own plain path there; these follow the plain path.  Masking is the
// forward's: finite -1e9 for masked keys, causal band replaced by -1e9 on
// absolute positions, keys at index >= S excluded outright.  The scores are
// summed in another order than the forward's FMA loop (on the tensor
// cores, below), so p is the forward's p to ~1e-6 relative, not bit for
// bit.
//
// Arithmetic.  Every product (q k^T, dO v^T, ds k, ds^T q, p^T dO) is
// mma.sync.m16n8k8 with TF32 operands and FP32 accumulators, with each
// operand split as it enters registers: hi = tf32(a), lo = tf32(a - hi),
// and a b ~ lo hi' + hi lo' + hi hi' (three MMAs per k-step, summed from
// zero on the tensor core and added to the accumulator in FP32; see mma3
// in mma_tf32.cuh, which both attention sources share).  A single TF32
// pass keeps ~3 decimal digits and misses the 1e-4 gate of the card checks
// by 10x (tests/test_torch_attention_backward.py emulates both); the
// split's error is ~1e-6, that of an FP32 FMA loop.
//
// What bounded the previous design (FMA pipes, one output element per lane)
// was shared memory: every FMA read both operands as separate 4-byte
// shared loads, about two warp-wide LDS.32 per warp-wide FMA, and an SM
// issues about one LDS.32 per clock against four FMAs, so the kernels ran
// at about an eighth of the FP32 rate.  At (B, H, S, Dh) = (256, 8, 50, 32)
// that is ~583 M FMAs (dq) -> ~36 M warp loads -> ~0.16 ms on 132 SMs at
// 1.755 GHz (measured 0.1664 ms), and ~0.96 G FMAs (dk/dv, measured
// 0.2028 ms); at (1, 2, 4096, 64) ~1.7 ms each (measured 1.47 and 1.85 ms).
//
// What bounds this one.  An m16n8k8 MMA does 1024 multiply-adds for two
// 4-byte shared loads of its B fragment, so shared memory is no longer the
// limit; the split costs four integer or FP32 instructions per operand
// value and the k-step add four FADDs per three MMAs, about five
// instructions beside every MMA.
//   * (1, 2, 4096, 64): ~39 (dq) and ~52 (dkv) GFLOP of TF32 MMA with the
//     split, on 128 blocks of 8 warps, one block per SM.  Issue bound: the
//     split's instructions and the MMAs of two warps per SM sub-partition,
//     ~110 TFLOP/s of MMA work, about a fifth of the TF32 peak.  Four
//     parts (16 warps) measured no faster than two, so it is not latency.
//   * (256, 8, 50, 32): ~4 (dq) and ~6 (dkv) GFLOP of MMA work and ~79 MB
//     of traffic per kernel over 2048 blocks of 64 rows or keys; registers
//     (125-143 per thread) allow 2 blocks per SM, so ~8 waves of short
//     load -> compute -> store chains: bound by latency, at ~1 TB/s.
//
// Design.
//   * Tiles: 64 query rows per dq block and 64 keys per dkv block, in 4
//     groups of 16 rows or keys.  Each group has two warps (kParts): warp
//     part 0 takes the first half of every tile of the other axis (32 of
//     the 64 keys of a K/V tile, or of the rows of a Q/dO tile), part 1
//     the second half, each keeping its partial dq (or dk, dv) in
//     registers; at the end part 1's sums are added to part 0's through
//     shared memory, in that order.  Every output element is written once
//     by one thread: no atomics, deterministic.  Two parts doubled the
//     warps per SM at S=4096 (one warp per sub-partition left the MMAs'
//     latency exposed) and halved the score registers.  32-row tiles (256
//     blocks at S=4096) measured 4% slower than 64 at S=4096 and ~30%
//     slower at S=50.  Q/dO tiles (dkv) are 64 rows, 32 at Dh=128
//     (registers).
//   * p and ds go from the accumulator layout to the A operand without
//     moving: a lane holds columns 2t and 2t+1 of each 8-column n-tile and
//     uses them as k = t and k = t+4, and the B operand of that product is
//     loaded with the same k order (rows 2t and 2t+1).  The sum over k is
//     the same; no shared-memory round trip, no shuffles.
//   * Shared tiles are row-major with rows padded to Dh+4 floats: a
//     fragment load has lane (g = lane/4, t = lane%4) read row g, column t
//     (bank 4g + t) or row 2t (+1), column g (bank 8t + g (+4)), both 32
//     different banks, so every fragment load is conflict-free.  16-byte
//     row alignment is kept for cp.async.
//   * Loads: the block's own Q/dO (dq) or K/V (dkv) and each tile of the
//     other axis go through 16-byte cp.async (row statistics through 4-byte
//     cp.async: rows of (B, H, S) are not 16-byte aligned) into a two-stage
//     ring, so tile i+1 loads while tile i computes; rows past S are
//     zero-filled by the copy.  A launch whose loop has one tile gets one
//     stage of shared memory.  Above 48 KB the block's dynamic shared
//     memory is opted into (Dh >= 64, or two stages at Dh=32).
//   * Causal dq stops at the block's last row: later keys are replaced for
//     every row of the block, so their ds is exactly 0.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace {

// A block has kGroups x kParts warps.  Warp w owns the rows (dq) or keys
// (dkv) of group w % kGroups, 16 each, and takes part w / kGroups of every
// tile of the other axis; the parts' partial sums are added at the end.
constexpr int kGroups = 4;
constexpr int kParts = 2;
constexpr int kThreads = kGroups * kParts * 32;

// Adds the partial sums of a group's kParts warps into part 0, in part
// order, through shared memory (buf: (kParts - 1) x kGroups x NT x 128
// floats, free on entry; every thread of the block calls this).
template <int NT>
__device__ __forceinline__ void sum_parts(float (&acc)[NT][4], float* buf,
                                          int group, int part, int lane) {
  if (part > 0) {
    float* dst = buf + ((part - 1) * kGroups + group) * NT * 128;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(n * 4 + e) * 32 + lane] = acc[n][e];
  }
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < kParts; ++p) {
      const float* src = buf + ((p - 1) * kGroups + group) * NT * 128;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += src[(n * 4 + e) * 32 + lane];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// dq (and delta): one block per (batch, head, 64-row q-tile), 16 rows per
// group.  Per 64-key K/V tile, each warp takes its part's 64 / kParts keys:
// s = q k^T and dO v^T, p and ds in registers, then dq += ds k.
// ---------------------------------------------------------------------------

template <int DH>
struct DqTile {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kRows = 16 * kGroups;  // query rows per block
  static constexpr int kKeys = 64;            // keys per K/V tile
  static constexpr int kPartKeys = kKeys / kParts;
  static constexpr int kLd = DH + kPad;
  static constexpr int kOwnFloats = 2 * kRows * kLd;            // Q, dO
  static constexpr int kStageFloats = 2 * kKeys * kLd + kKeys;  // K, V, bias
  static_assert((kParts - 1) * kRows * DH <= kOwnFloats + kStageFloats,
                "the parts' sums must fit in one stage's shared memory");
};

template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 32 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ key_mask,
                    const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ row_max,
                    const float* __restrict__ row_sum,
                    float* __restrict__ delta, float* __restrict__ dq, int H,
                    int S, int causal, float scale) {
  using T = DqTile<DH>;
  constexpr int BK = T::kKeys;
  constexpr int PK = T::kPartKeys;
  constexpr int LD = T::kLd;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [kRows][LD]
  float* do_s = q_s + T::kRows * LD;  // [kRows][LD]
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
  const int group = tid / 32 % kGroups;
  const int part = tid / 32 / kGroups;
  const int r0 = group * 16;  // the warp's first row in the block
  const int c0 = part * PK;   // the warp's first key in each tile

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + T::kRows, S) + BK - 1) / BK);
  auto load_kv = [&](int i) {
    load_rows<BK, DH, kThreads>(stage(i), k + head * DH, i * BK, S, tid);
    load_rows<BK, DH, kThreads>(stage(i) + BK * LD, v + head * DH, i * BK, S,
                                tid);
  };

  load_rows<T::kRows, DH, kThreads>(q_s, q + head * DH, q0, S, tid);
  load_rows<T::kRows, DH, kThreads>(do_s, dout + head * DH, q0, S, tid);
  load_kv(0);
  cp_async_commit();
  if (tid < BK) stage(0)[2 * BK * LD + tid] = key_bias(key_mask, b, S, tid);

  // Row statistics of the lane's rows g and g + 8.  A row past S gets
  // inv_l = 0, so its p and ds are 0.
  float m[2], inv_l[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    const bool real = row < S;
    float part_sum = 0.f;
    if (real) {
      const float* o_row = o + (head + row) * DH;
      const float* d_row = dout + (head + row) * DH;
#pragma unroll
      for (int c = 4 * t; c < DH; c += 16) {
        const float4 x = *reinterpret_cast<const float4*>(o_row + c);
        const float4 y = *reinterpret_cast<const float4*>(d_row + c);
        part_sum = fmaf(x.x, y.x, part_sum);
        part_sum = fmaf(x.y, y.y, part_sum);
        part_sum = fmaf(x.z, y.z, part_sum);
        part_sum = fmaf(x.w, y.w, part_sum);
      }
    }
    part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
    part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 2);
    dlt[hh] = part_sum;
    m[hh] = real ? row_max[head + row] : 0.f;
    inv_l[hh] = real ? 1.f / row_sum[head + row] : 0.f;
    if (real && t == 0 && part == 0) delta[head + row] = part_sum;
  }

  float acc[DH / 8][4] = {};  // the part's dq of rows r0 .. r0 + 16, unscaled
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * BK;
    float next_bias = 0.f;
    if (i + 1 < n_tiles) {
      load_kv(i + 1);
      if (tid < BK) next_bias = key_bias(key_mask, b, S, k0 + BK + tid);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile i (and Q, dO) landed for every thread

    const float* k_s = stage(i);
    const float* v_s = k_s + BK * LD;
    const float* bias_s = v_s + BK * LD;
    const int n_keys = min(BK, S - k0);
    if (q0 + r0 < S && c0 < n_keys) {
      float sc[PK / 8][4] = {}, dp[PK / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) {
        const FragA qa = load_a<LD>(q_s, r0, 8 * ks, g, t);
        const FragA da = load_a<LD>(do_s, r0, 8 * ks, g, t);
#pragma unroll
        for (int j = 0; j < PK / 8; ++j) {
          mma3(sc[j], qa, load_bt<LD>(k_s, c0 + 8 * j, 8 * ks, g, t));
          mma3(dp[j], da, load_bt<LD>(v_s, c0 + 8 * j, 8 * ks, g, t));
        }
      }
#pragma unroll
      for (int j = 0; j < PK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = c0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          float ds = 0.f;
          if (kj < n_keys) {
            const bool replaced = causal && k0 + kj > row;
            const float s =
                replaced ? kMaskedScore : sc[j][e] * scale + bias_s[kj];
            const float p = expf(s - m[e >> 1]) * inv_l[e >> 1];
            ds = replaced ? 0.f : p * (dp[j][e] - dlt[e >> 1]);
          }
          sc[j][e] = ds;
        }
      }
#pragma unroll
      for (int j = 0; j < PK / 8; ++j) {
        const FragA a = from_acc(sc[j]);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          mma3(acc[n], a, load_b_paired<LD>(k_s, c0 + 8 * j, 8 * n, g, t));
      }
    }
    if (tid < BK && i + 1 < n_tiles)
      stage(i + 1)[2 * BK * LD + tid] = next_bias;
    __syncthreads();  // stage i is consumed before tile i + 2 overwrites it
  }

  sum_parts(acc, smem, group, part, lane);
  if (part > 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(dq + (head + row) * DH + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (batch, head, 64-key k-tile), 16 keys per group.
// Per Q/dO tile, each warp takes its part's rows: s^T = k q^T and v dO^T,
// p^T and ds^T in registers, then dv += p^T dO and dk += ds^T q.
// ---------------------------------------------------------------------------

template <int DH>
struct DkvTile {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kKeys = 16 * kGroups;        // keys per block
  static constexpr int kRows = DH <= 64 ? 64 : 32;  // rows per Q/dO tile
  static constexpr int kPartRows = kRows / kParts;
  static constexpr int kLd = DH + kPad;
  static constexpr int kOwnFloats = 2 * kKeys * kLd;  // K, V
  // Q, dO, and the rows' m, l, delta.
  static constexpr int kStageFloats = 2 * kRows * kLd + 3 * kRows;
  static_assert(kPartRows % 8 == 0, "a part is whole k-steps of rows");
  static_assert((kParts - 1) * kKeys * DH <= kOwnFloats + kStageFloats,
                "the parts' sums must fit in one stage's shared memory");
};

template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 32 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ key_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ row_max,
                     const float* __restrict__ row_sum,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int S, int causal,
                     float scale) {
  using T = DkvTile<DH>;
  constexpr int BQ = T::kRows;
  constexpr int PR = T::kPartRows;
  constexpr int LD = T::kLd;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [kKeys][LD]
  float* v_s = k_s + T::kKeys * LD;  // [kKeys][LD]
  // Stage i & 1 of the ring: Q [BQ][LD], dO [BQ][LD], m, l, delta [BQ].
  auto stage = [&](int i) {
    return smem + T::kOwnFloats + (i & 1) * T::kStageFloats;
  };

  const int k0 = blockIdx.x * T::kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * S;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int group = tid / 32 % kGroups;
  const int part = tid / 32 / kGroups;
  const int kr0 = group * 16;  // the warp's first key in the block
  const int c0 = part * PR;    // the warp's first row in each tile

  const int n_tiles = (S + BQ - 1) / BQ;
  auto load_q = [&](int i) {
    float* st = stage(i);
    load_rows<BQ, DH, kThreads>(st, q + head * DH, i * BQ, S, tid);
    load_rows<BQ, DH, kThreads>(st + BQ * LD, dout + head * DH, i * BQ, S,
                                tid);
    float* stats = st + 2 * BQ * LD;
    load_vec<BQ, kThreads>(stats, row_max + head, i * BQ, S, tid);
    load_vec<BQ, kThreads>(stats + BQ, row_sum + head, i * BQ, S, tid);
    load_vec<BQ, kThreads>(stats + 2 * BQ, delta + head, i * BQ, S, tid);
  };

  load_rows<T::kKeys, DH, kThreads>(k_s, k + head * DH, k0, S, tid);
  load_rows<T::kKeys, DH, kThreads>(v_s, v + head * DH, k0, S, tid);
  load_q(0);
  cp_async_commit();

  // The lane's keys g and g + 8.
  bool kreal[2];
  float kbias[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kr0 + g + 8 * hh;
    kreal[hh] = key < S;
    kbias[hh] = key_bias(key_mask, b, S, key);
  }

  // The part's dk (unscaled) and dv of keys kr0 .. kr0 + 16.
  float acc_dk[DH / 8][4] = {}, acc_dv[DH / 8][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int i0 = i * BQ;
    if (i + 1 < n_tiles) load_q(i + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile i (and K, V) landed for every thread

    const float* q_s = stage(i);
    const float* do_s = q_s + BQ * LD;
    const float* m_s = do_s + BQ * LD;
    const float* l_s = m_s + BQ;
    const float* delta_s = l_s + BQ;
    const int n_rows = min(BQ, S - i0);
    if (k0 + kr0 < S && c0 < n_rows) {
      float sc[PR / 8][4] = {}, dp[PR / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) {
        const FragA ka = load_a<LD>(k_s, kr0, 8 * ks, g, t);
        const FragA va = load_a<LD>(v_s, kr0, 8 * ks, g, t);
#pragma unroll
        for (int j = 0; j < PR / 8; ++j) {
          mma3(sc[j], ka, load_bt<LD>(q_s, c0 + 8 * j, 8 * ks, g, t));
          mma3(dp[j], va, load_bt<LD>(do_s, c0 + 8 * j, 8 * ks, g, t));
        }
      }
#pragma unroll
      for (int j = 0; j < PR / 8; ++j) {
        const int ri = c0 + 8 * j + 2 * t;
        const float2 mm = *reinterpret_cast<const float2*>(m_s + ri);
        const float2 ll = *reinterpret_cast<const float2*>(l_s + ri);
        const float2 dd = *reinterpret_cast<const float2*>(delta_s + ri);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const int key = k0 + kr0 + g + 8 * (e >> 1);
          float p = 0.f, ds = 0.f;
          if (ri + c < n_rows && kreal[e >> 1]) {
            const bool replaced = causal && key > i0 + ri + c;
            const float s = replaced ? kMaskedScore
                                     : sc[j][e] * scale + kbias[e >> 1];
            p = expf(s - (c ? mm.y : mm.x)) * (1.f / (c ? ll.y : ll.x));
            ds = replaced ? 0.f : p * (dp[j][e] - (c ? dd.y : dd.x));
          }
          sc[j][e] = p;
          dp[j][e] = ds;
        }
      }
#pragma unroll
      for (int j = 0; j < PR / 8; ++j) {
        const FragA pa = from_acc(sc[j]);
        const FragA sa = from_acc(dp[j]);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          mma3(acc_dv[n], pa,
               load_b_paired<LD>(do_s, c0 + 8 * j, 8 * n, g, t));
          mma3(acc_dk[n], sa,
               load_b_paired<LD>(q_s, c0 + 8 * j, 8 * n, g, t));
        }
      }
    }
    __syncthreads();  // stage i is consumed before tile i + 2 overwrites it
  }

  sum_parts(acc_dk, smem, group, part, lane);
  sum_parts(acc_dv, smem, group, part, lane);
  if (part > 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!kreal[hh]) continue;
    const size_t key_row = head + k0 + kr0 + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dk + key_row * DH + c) = make_float2(
          acc_dk[n][2 * hh] * scale, acc_dk[n][2 * hh + 1] * scale);
      *reinterpret_cast<float2*>(dv + key_row * DH + c) =
          make_float2(acc_dv[n][2 * hh], acc_dv[n][2 * hh + 1]);
    }
  }
}

template <int DH>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const uint8_t* key_mask, const float* o,
                      const float* dout, const float* row_max,
                      const float* row_sum, float* delta, float* dq, int B,
                      int H, int S, int causal, cudaStream_t stream) {
  using T = DqTile<DH>;
  static const cudaError_t attr =
      allow_smem(flash_bwd_dq_kernel<DH>, smem_bytes<T>(2));
  if (attr != cudaSuccess) return attr;
  const int bytes = smem_bytes<T>(S > T::kKeys ? 2 : 1);
  const dim3 grid((S + T::kRows - 1) / T::kRows, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dq_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, o, dout, row_max, row_sum, delta, dq, H, S, causal,
      scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const uint8_t* key_mask, const float* dout,
                       const float* row_max, const float* row_sum,
                       const float* delta, float* dk, float* dv, int B, int H,
                       int S, int causal, cudaStream_t stream) {
  using T = DkvTile<DH>;
  static const cudaError_t attr =
      allow_smem(flash_bwd_dkv_kernel<DH>, smem_bytes<T>(2));
  if (attr != cudaSuccess) return attr;
  const int bytes = smem_bytes<T>(S > T::kRows ? 2 : 1);
  const dim3 grid((S + T::kKeys - 1) / T::kKeys, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dkv_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, dout, row_max, row_sum, delta, dk, dv, H, S, causal,
      scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int S) {
  return B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// All tensors float32 and contiguous: q, k, v, o, dout, dq, dk, dv are
// (B, H, S, Dh) and 16-byte aligned; row_max, row_sum (from the forward)
// and delta are (B, H, S).  key_mask: (B, S) bool (nonzero = attend) or
// null.  Each entry returns the cudaError_t of its launch.

// Writes dq and delta = rowsum(dout * o).  Run it before the dkv entry on
// the same stream: dkv reads delta.
extern "C" int flexdm_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* o, const void* dout, const void* row_max, const void* row_sum,
    void* delta, void* dq, int B, int H, int S, int Dh, int causal,
    void* stream) {
  if (bad_shape(B, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* of = static_cast<const float*>(o);
  const auto* df = static_cast<const float*>(dout);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  auto* deltaf = static_cast<float*>(delta);
  auto* dqf = static_cast<float*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch_dq<32>(qf, kf, vf, mask, of, df, mf, sf, deltaf, dqf, B, H,
                          S, causal, st);
      break;
    case 64:
      err = launch_dq<64>(qf, kf, vf, mask, of, df, mf, sf, deltaf, dqf, B, H,
                          S, causal, st);
      break;
    case 128:
      err = launch_dq<128>(qf, kf, vf, mask, of, df, mf, sf, deltaf, dqf, B,
                           H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Writes dk and dv; reads the delta written by flexdm_flash_attention_bwd_dq.
extern "C" int flexdm_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* row_max, const void* row_sum,
    const void* delta, void* dk, void* dv, int B, int H, int S, int Dh,
    int causal, void* stream) {
  if (bad_shape(B, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* df = static_cast<const float*>(dout);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  const auto* deltaf = static_cast<const float*>(delta);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch_dkv<32>(qf, kf, vf, mask, df, mf, sf, deltaf, dkf, dvf, B,
                           H, S, causal, st);
      break;
    case 64:
      err = launch_dkv<64>(qf, kf, vf, mask, df, mf, sf, deltaf, dkf, dvf, B,
                           H, S, causal, st);
      break;
    case 128:
      err = launch_dkv<128>(qf, kf, vf, mask, df, mf, sf, deltaf, dkf, dvf, B,
                            H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
