// Flash-attention backward for Hopper (sm_90a), the bf16 instance: q, k,
// v, O, dO, dq, dk and dv in bf16, m, l and delta in float32, every product
// on the bf16 tensor cores.
//
// Replaces, for bf16 inputs, the TPU kernels of flexdm_tpu/ops/attention.py:
//   * _flash_bwd_dq_kernel and _flash_bwd_dq_stream_kernel -> the dq kernel
//     here, which also computes delta = rowsum(dO * O) in float32 from the
//     bf16 dO and O (the XLA glue of _attention_pallas_bwd);
//   * _flash_bwd_dkv_kernel and _flash_bwd_dkv_stream_kernel -> the dkv
//     kernel here.
// One kernel of each covers every S, as in the float32 pair
// (flash_attention_bwd.cu), whose contract, masking and tiling these keep:
// p = exp(s - m) / l from the forward's m and l (not exp(s - lse): a fully
// masked row keeps p = 1/S), ds = p (dO v^T - delta) and 0 where the causal
// band replaced s, dq = scale ds k, dk = scale ds^T q, dv = p^T dO.
//
// Arithmetic.  Every product (q k^T, dO v^T, ds k, k q^T, v dO^T, p^T dO,
// ds^T q) is mma.sync.m16n8k16 with bf16 operands and float32 sums.  q, k,
// v, O and dO enter exactly; p and ds are computed in float32 and enter the
// products that consume them as bf16 operands, the one rounding the TPU
// kernels, which keep p and ds in float32, do not do.  dq, dk and dv are
// rounded to bf16 once.  The CPU emulation in
// tests/test_torch_attention_bf16.py meets the card's bar (one bf16 ulp
// plus 2^-8 of the largest gradient) with p and ds in one bf16 term each,
// so neither is split.
//
// What bounds it.  At the training shape (256, 8, 50, 32) each kernel moves
// ~40 MB (six bf16 (B, H, S, Dh) tensors and three float32 row vectors)
// and does 1.0 (dq) or 1.3 (dk/dv) GFLOP: bytes bound it (0.012 ms at
// 3.35 TB/s); measured 0.042 (dq) and 0.038 ms (dk/dv) on an H100 at
// 700 W (chip_smoke.py; float32 kernels 0.076 each), over 2048 blocks of
// short load -> compute -> store chains, so latency does in practice.  At
// (1, 2, 4096, 64) the products take over: 0.144 and 0.192 ms against
// 0.013 and 0.017 ms at the bf16 peak, on 128 blocks of 8 warps.
//
// Design (the float32 kernels' tiling, with bf16 tiles and fragments).
//   * dq: one block per (batch, head, 64 query rows) in 4 groups of 16
//     rows; each group has two warps (kParts), part 0 taking keys 0..31 of
//     every 64-key K/V tile and part 1 keys 32..63, each keeping its partial
//     dq in registers; part 1's sums are added to part 0's through shared
//     memory at the end, in that order (no atomics, deterministic).
//   * dk/dv: one block per (batch, head, 64 keys) in 4 groups of 16 keys,
//     two parts splitting the rows of every Q/dO tile (64 rows, 32 at
//     Dh=128).  It computes s^T = k q^T and dp^T = v dO^T, so p^T and ds^T
//     are already in the accumulator layout of rows = keys, and become the
//     A operands of dv += p^T dO and dk += ds^T q in registers (acc_to_a)
//     with no transposed fragment loads of A.  q and dO, row-major, are
//     the B operands of those two products by ldmatrix.trans.
//   * Tiles arrive by 16-byte cp.async into a two-stage ring (the row
//     statistics by 4-byte cp.async); rows padded to Dh + 8 bf16
//     (mma_bf16.cuh); rows past S zero-filled.
//   * Causal dq stops at the block's last row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

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

// Rows r, r + 8 of an accumulator set (lane's g, g + 8), scaled, as bf16
// pairs into a (rows, DH) bf16 array at row index ``row`` (hh = 0 or 1).
template <int DH>
__device__ __forceinline__ void store_row(bf16* dst, size_t row,
                                          const float (&acc)[DH / 8][4],
                                          int hh, int t, float scale) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
    *reinterpret_cast<uint32_t*>(dst + row * DH + 8 * n + 2 * t) = pack_bf16(
        acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
}

// ---------------------------------------------------------------------------
// dq (and delta): one block per (batch, head, 64-row q-tile), 16 rows per
// group.  Per 64-key K/V tile, each warp takes its part's 32 keys: s = q k^T
// and dO v^T, p and ds in registers, then dq += ds k.
// ---------------------------------------------------------------------------

template <int DH>
struct DqTileBf16 {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kRows = 16 * kGroups;  // query rows per block
  static constexpr int kKeys = 64;            // keys per K/V tile
  static constexpr int kPartKeys = kKeys / kParts;
  static constexpr int kLd = DH + kPadBf16;
  static constexpr int kOwnBytes = 2 * kRows * kLd * 2;  // Q, dO
  // K, V (bf16) and the key bias (float32).
  static constexpr int kStageBytes = 2 * kKeys * kLd * 2 + kKeys * 4;
  static_assert(kPartKeys % 16 == 0, "a part is whole k16 steps of keys");
  static_assert(kOwnBytes % 16 == 0 && kStageBytes % 16 == 0,
                "stages must stay 16-byte aligned");
  static_assert((kParts - 1) * kRows * DH * 4 <= kOwnBytes + kStageBytes,
                "the parts' sums must fit in one stage's shared memory");
  static constexpr int bytes(int stages) {
    return kOwnBytes + stages * kStageBytes;
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 32 ? 2 : 1)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const uint8_t* __restrict__ key_mask,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_sum,
                         float* __restrict__ delta, bf16* __restrict__ dq,
                         int H, int S, int causal, float scale) {
  using T = DqTileBf16<DH>;
  constexpr int BK = T::kKeys;
  constexpr int PK = T::kPartKeys;
  constexpr int LD = T::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows][LD]
  bf16* do_s = q_s + T::kRows * LD;           // [kRows][LD]
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
  const int group = tid / 32 % kGroups;
  const int part = tid / 32 / kGroups;
  const int r0 = group * 16;  // the warp's first row in the block
  const int c0 = part * PK;   // the warp's first key in each tile

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + T::kRows, S) + BK - 1) / BK);
  auto load_kv = [&](int i) {
    load_rows_bf16<BK, DH, kThreads>(k_tile(i), k + head * DH, i * BK, S, tid);
    load_rows_bf16<BK, DH, kThreads>(k_tile(i) + BK * LD, v + head * DH,
                                     i * BK, S, tid);
  };

  load_rows_bf16<T::kRows, DH, kThreads>(q_s, q + head * DH, q0, S, tid);
  load_rows_bf16<T::kRows, DH, kThreads>(do_s, dout + head * DH, q0, S, tid);
  load_kv(0);
  cp_async_commit();
  if (tid < BK) bias_tile(0)[tid] = key_bias(key_mask, b, S, tid);

  // Row statistics of the lane's rows g and g + 8; delta in float32 from
  // the bf16 O and dO rows, 8 columns per lane per pass.  A row past S gets
  // inv_l = 0, so its p and ds are 0.
  float m[2], inv_l[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    const bool real = row < S;
    float part_sum = 0.f;
    if (real) {
      const bf16* o_row = o + (head + row) * DH;
      const bf16* d_row = dout + (head + row) * DH;
#pragma unroll
      for (int c = 8 * t; c < DH; c += 32) {
        const uint4 x = *reinterpret_cast<const uint4*>(o_row + c);
        const uint4 y = *reinterpret_cast<const uint4*>(d_row + c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          __nv_bfloat162 xb, yb;
          memcpy(&xb, &xs[w], 4);
          memcpy(&yb, &ys[w], 4);
          const float2 xf = __bfloat1622float2(xb);
          const float2 yf = __bfloat1622float2(yb);
          part_sum = fmaf(xf.x, yf.x, part_sum);
          part_sum = fmaf(xf.y, yf.y, part_sum);
        }
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

    const bf16* k_s = k_tile(i);
    const bf16* v_s = k_s + BK * LD;
    const float* bias_s = bias_tile(i);
    const int n_keys = min(BK, S - k0);
    if (q0 + r0 < S && c0 < n_keys) {
      float sc[PK / 8][4] = {}, dp[PK / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t qa[4], da[4];
        frag_a<LD>(qa, q_s, r0, 16 * ks, lane);
        frag_a<LD>(da, do_s, r0, 16 * ks, lane);
#pragma unroll
        for (int j = 0; j < PK / 8; j += 2) {
          uint32_t kb[4], vb[4];
          frag_bt<LD>(kb, k_s, c0 + 8 * j, 16 * ks, lane);
          frag_bt<LD>(vb, v_s, c0 + 8 * j, 16 * ks, lane);
          mma_bf16_x2(sc[j], sc[j + 1], qa, kb);
          mma_bf16_x2(dp[j], dp[j + 1], da, vb);
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
      // dq += ds k: ds (bf16) from the accumulators, k by ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < PK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DH / 8; n += 2) {
          uint32_t kb[4];
          frag_b_trans<LD>(kb, k_s, c0 + 16 * kk, 8 * n, lane);
          mma_bf16_x2(acc[n], acc[n + 1], a, kb);
        }
      }
    }
    if (tid < BK && i + 1 < n_tiles) bias_tile(i + 1)[tid] = next_bias;
    __syncthreads();  // stage i is consumed before tile i + 2 overwrites it
  }

  sum_parts(acc, reinterpret_cast<float*>(smem), group, part, lane);
  if (part > 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    if (row < S) store_row<DH>(dq, head + row, acc, hh, t, scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (batch, head, 64-key k-tile), 16 keys per group.
// Per Q/dO tile, each warp takes its part's rows: s^T = k q^T and v dO^T,
// p^T and ds^T in registers, then dv += p^T dO and dk += ds^T q.
// ---------------------------------------------------------------------------

template <int DH>
struct DkvTileBf16 {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kKeys = 16 * kGroups;        // keys per block
  static constexpr int kRows = DH <= 64 ? 64 : 32;  // rows per Q/dO tile
  static constexpr int kPartRows = kRows / kParts;
  static constexpr int kLd = DH + kPadBf16;
  static constexpr int kOwnBytes = 2 * kKeys * kLd * 2;  // K, V
  // Q, dO (bf16), and the rows' m, l, delta (float32).
  static constexpr int kStageBytes = 2 * kRows * kLd * 2 + 3 * kRows * 4;
  static_assert(kPartRows % 16 == 0, "a part is whole k16 steps of rows");
  static_assert(kOwnBytes % 16 == 0 && kStageBytes % 16 == 0,
                "stages must stay 16-byte aligned");
  static_assert((kParts - 1) * kKeys * DH * 4 <= kOwnBytes + kStageBytes,
                "the parts' sums must fit in one stage's shared memory");
  static constexpr int bytes(int stages) {
    return kOwnBytes + stages * kStageBytes;
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 32 ? 2 : 1)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const uint8_t* __restrict__ key_mask,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int S, int causal, float scale) {
  using T = DkvTileBf16<DH>;
  constexpr int BQ = T::kRows;
  constexpr int PR = T::kPartRows;
  constexpr int LD = T::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kKeys][LD]
  bf16* v_s = k_s + T::kKeys * LD;            // [kKeys][LD]
  // Stage i & 1 of the ring: Q [BQ][LD], dO [BQ][LD], m, l, delta [BQ].
  auto q_tile = [&](int i) {
    return reinterpret_cast<bf16*>(smem + T::kOwnBytes +
                                   (i & 1) * T::kStageBytes);
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
    bf16* st = q_tile(i);
    load_rows_bf16<BQ, DH, kThreads>(st, q + head * DH, i * BQ, S, tid);
    load_rows_bf16<BQ, DH, kThreads>(st + BQ * LD, dout + head * DH, i * BQ,
                                     S, tid);
    float* stats = reinterpret_cast<float*>(st + 2 * BQ * LD);
    load_vec<BQ, kThreads>(stats, row_max + head, i * BQ, S, tid);
    load_vec<BQ, kThreads>(stats + BQ, row_sum + head, i * BQ, S, tid);
    load_vec<BQ, kThreads>(stats + 2 * BQ, delta + head, i * BQ, S, tid);
  };

  load_rows_bf16<T::kKeys, DH, kThreads>(k_s, k + head * DH, k0, S, tid);
  load_rows_bf16<T::kKeys, DH, kThreads>(v_s, v + head * DH, k0, S, tid);
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

    const bf16* q_s = q_tile(i);
    const bf16* do_s = q_s + BQ * LD;
    const float* m_s = reinterpret_cast<const float*>(do_s + BQ * LD);
    const float* l_s = m_s + BQ;
    const float* delta_s = l_s + BQ;
    const int n_rows = min(BQ, S - i0);
    if (k0 + kr0 < S && c0 < n_rows) {
      float sc[PR / 8][4] = {}, dp[PR / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t ka[4], va[4];
        frag_a<LD>(ka, k_s, kr0, 16 * ks, lane);
        frag_a<LD>(va, v_s, kr0, 16 * ks, lane);
#pragma unroll
        for (int j = 0; j < PR / 8; j += 2) {
          uint32_t qb[4], db[4];
          frag_bt<LD>(qb, q_s, c0 + 8 * j, 16 * ks, lane);
          frag_bt<LD>(db, do_s, c0 + 8 * j, 16 * ks, lane);
          mma_bf16_x2(sc[j], sc[j + 1], ka, qb);
          mma_bf16_x2(dp[j], dp[j + 1], va, db);
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
      // dv += p^T dO and dk += ds^T q: p^T, ds^T (bf16) from the
      // accumulators, dO and q by ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < PR / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DH / 8; n += 2) {
          uint32_t db[4], qb[4];
          frag_b_trans<LD>(db, do_s, c0 + 16 * kk, 8 * n, lane);
          frag_b_trans<LD>(qb, q_s, c0 + 16 * kk, 8 * n, lane);
          mma_bf16_x2(acc_dv[n], acc_dv[n + 1], pa, db);
          mma_bf16_x2(acc_dk[n], acc_dk[n + 1], sa, qb);
        }
      }
    }
    __syncthreads();  // stage i is consumed before tile i + 2 overwrites it
  }

  float* buf = reinterpret_cast<float*>(smem);
  sum_parts(acc_dk, buf, group, part, lane);
  sum_parts(acc_dv, buf, group, part, lane);
  if (part > 0) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!kreal[hh]) continue;
    const size_t key_row = head + k0 + kr0 + g + 8 * hh;
    store_row<DH>(dk, key_row, acc_dk, hh, t, scale);
    store_row<DH>(dv, key_row, acc_dv, hh, t, 1.f);
  }
}

template <int DH>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                      const uint8_t* key_mask, const bf16* o,
                      const bf16* dout, const float* row_max,
                      const float* row_sum, float* delta, bf16* dq, int B,
                      int H, int S, int causal, cudaStream_t stream) {
  using T = DqTileBf16<DH>;
  static const cudaError_t attr =
      allow_smem(flash_bwd_dq_bf16_kernel<DH>, T::bytes(2));
  if (attr != cudaSuccess) return attr;
  const int bytes = T::bytes(S > T::kKeys ? 2 : 1);
  const dim3 grid((S + T::kRows - 1) / T::kRows, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dq_bf16_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, o, dout, row_max, row_sum, delta, dq, H, S, causal,
      scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const uint8_t* key_mask, const bf16* dout,
                       const float* row_max, const float* row_sum,
                       const float* delta, bf16* dk, bf16* dv, int B, int H,
                       int S, int causal, cudaStream_t stream) {
  using T = DkvTileBf16<DH>;
  static const cudaError_t attr =
      allow_smem(flash_bwd_dkv_bf16_kernel<DH>, T::bytes(2));
  if (attr != cudaSuccess) return attr;
  const int bytes = T::bytes(S > T::kRows ? 2 : 1);
  const dim3 grid((S + T::kKeys - 1) / T::kKeys, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dkv_bf16_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, dout, row_max, row_sum, delta, dk, dv, H, S, causal,
      scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int S) {
  return B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, H, S, Dh) bf16, contiguous, 16-byte
// aligned; row_max, row_sum (from the forward) and delta: (B, H, S)
// float32.  key_mask: (B, S) bool (nonzero = attend) or null.  Each entry
// returns the cudaError_t of its launch.

// Writes dq and delta = rowsum(dout * o).  Run it before the dkv entry on
// the same stream: dkv reads delta.
extern "C" int flexdm_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* o, const void* dout, const void* row_max, const void* row_sum,
    void* delta, void* dq, int B, int H, int S, int Dh, int causal,
    void* stream) {
  if (bad_shape(B, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* ob = static_cast<const bf16*>(o);
  const auto* db = static_cast<const bf16*>(dout);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  auto* deltaf = static_cast<float*>(delta);
  auto* dqb = static_cast<bf16*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch_dq<32>(qb, kb, vb, mask, ob, db, mf, sf, deltaf, dqb, B, H,
                          S, causal, st);
      break;
    case 64:
      err = launch_dq<64>(qb, kb, vb, mask, ob, db, mf, sf, deltaf, dqb, B, H,
                          S, causal, st);
      break;
    case 128:
      err = launch_dq<128>(qb, kb, vb, mask, ob, db, mf, sf, deltaf, dqb, B,
                           H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Writes dk and dv; reads the delta written by
// flexdm_flash_attention_bwd_dq_bf16.
extern "C" int flexdm_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* row_max, const void* row_sum,
    const void* delta, void* dk, void* dv, int B, int H, int S, int Dh,
    int causal, void* stream) {
  if (bad_shape(B, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* db = static_cast<const bf16*>(dout);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  const auto* deltaf = static_cast<const float*>(delta);
  auto* dkb = static_cast<bf16*>(dk);
  auto* dvb = static_cast<bf16*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch_dkv<32>(qb, kb, vb, mask, db, mf, sf, deltaf, dkb, dvb, B,
                           H, S, causal, st);
      break;
    case 64:
      err = launch_dkv<64>(qb, kb, vb, mask, db, mf, sf, deltaf, dkb, dvb, B,
                           H, S, causal, st);
      break;
    case 128:
      err = launch_dkv<128>(qb, kb, vb, mask, db, mf, sf, deltaf, dkb, dvb, B,
                            H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
