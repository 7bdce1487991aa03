// Flash-attention backward for Hopper (sm_90a), the bf16 instance: q, k,
// v, O, dO, dq, dk and dv in bf16, m, l and delta in float32, every product
// a warpgroup wgmma on the bf16 tensor cores.
//
// Replaces, for bf16 inputs, the TPU kernels of flexdm_tpu/ops/attention.py:
//   * _flash_bwd_dq_kernel and _flash_bwd_dq_stream_kernel -> the dq kernel
//     here, which also computes delta = rowsum(dO * O) in float32 from the
//     bf16 dO and O (the XLA glue of _attention_pallas_bwd);
//   * _flash_bwd_dkv_kernel and _flash_bwd_dkv_stream_kernel -> the dkv
//     kernel here.
// One kernel of each covers every S, as in the float32 pair
// (flash_attention_bwd.cu), whose contract and masking these keep:
// p = exp(s - m) / l from the forward's m and l (not exp(s - lse): a fully
// masked row keeps p = 1/S), ds = p (dO v^T - delta) and 0 where the causal
// band replaced s, dq = scale ds k, dk = scale ds^T q, dv = p^T dO.
//
// Arithmetic.  Every product is wgmma.mma_async m64nNk16 with bf16
// operands and float32 sums (wgmma_bf16.cuh).  q, k, v, O and dO enter
// exactly; p and ds are computed in float32 and enter the products that
// consume them as bf16 register operands, the one rounding the TPU kernels,
// which keep p and ds in float32, do not do.  dq, dk and dv are rounded to
// bf16 once.  The CPU emulation in tests/test_torch_attention_bf16.py
// follows these rounding points and the tile sums below, and meets the
// card's bar (one bf16 ulp plus 2^-8 of the largest gradient).
//
// What bounds it.  The bytes and products bound neither kernel: at the
// training shape (256, 8, 50, 32) each moves ~40 MB and does 1.0 (dq) or
// 1.3 (dk/dv) GFLOP (0.012 ms at 3.35 TB/s); at (64, 8, 500, 32) 0.030 and
// 0.033 ms of bytes and products; at (1, 2, 4096, 64) 0.013 and 0.017 ms
// at the bf16 peak.  What does is the work per score outside the tensor
// cores (the exponential, the masks, ds) and the latency of each tile's
// chain (copy -> scores -> p, ds -> product), which only other warpgroups
// on the SM can hide.  An earlier mma.sync design lost to the library
// call at S = 500 and 4096 through fragment loads, a block-wide sync per
// tile and mma.sync's rate.
//
// Design.
//   * A consumer warpgroup owns 64 query rows (dq) or 64 keys (dk/dv): the
//     wgmma M.  dq computes s = q k^T and dp = dO v^T as SS products (q, dO
//     and k, v tiles in shared memory, all K-major), forms ds in the
//     accumulators, and adds ds k as an RS product (ds in registers, k
//     MN-major by the transpose bit).  dk/dv computes s^T = k q^T and
//     dp^T = v dO^T (SS, k and v its own tiles), so p^T and ds^T arrive with
//     keys as rows and become the register A operands of dv += p^T dO and
//     dk += ds^T q (RS, dO and q MN-major).  No transposed copy, no
//     ldmatrix.
//   * The other axis comes in tiles of 32 (keys for dq at Dh = 32, 64
//     above; Q/dO rows for dk/dv), the N of the score products: s and dp
//     then take 16 registers each, and at Dh = 32 three blocks share an
//     SM.  Scores are
//     kept in log2 units, so p is one ex2; a tile wholly inside the key
//     range and the causal band skips the per-score checks; p is formed
//     while dp is still on the tensor cores, and dk/dv's dv product runs
//     while ds is formed.
//   * One producer warp feeds the block by TMA: the warpgroup's own two
//     tiles once, then the other axis' tiles into a ring of 4 stages, each
//     with its row vectors (dq: the key bias; dk/dv: m, 1/l, delta) loaded
//     by the warp's lanes before they wait for the stage.  A stage's full
//     mbarrier completes on the TMA bytes and the lanes' arrivals, its
//     empty mbarrier on the 128 arrivals of the warpgroup that consumed
//     it: no block-wide sync in the loop.
//   * Tensor maps over (B H, S, Dh) views, passed as __grid_constant__
//     parameters (nothing is written to device memory per call): rows past
//     S arrive as zeros, never as the next head's.
//   * NWG = 2 consumer warpgroups share a block when the grid is small
//     (fewer than 264 blocks, two per SM of an H100, with at least two
//     tiles to split): they take the tiles of the other axis alternately,
//     and warpgroup 1's sums are added to warpgroup 0's through shared
//     memory at the end, in that order.  The producer is then a whole
//     warpgroup that gives its registers to the consumers (setmaxnreg).
//     No atomics: every dq, dk and dv element is summed in a fixed order,
//     so a second call is bitwise equal.
//   * Causal dq stops at the block's last row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kWarpgroup = 128;
// Scores are kept in log2 units (s log2 e), so p = 2^(x - m log2 e) / l is
// one ex2.  A replaced or masked score is -1e9 log2 e, which rounds to the
// same float as a fully masked row's m log2 e: such a row keeps p = 1/l.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedLog2 = kMaskedScore * kLog2e;
constexpr int kTile = 64;  // rows or keys a consumer warpgroup owns
// Keys per K/V tile of the dq kernel and Q/dO rows per tile of the dk/dv
// kernel: the N of the score products.  32 keeps s, dp (or s^T, dp^T) at 16
// registers each, so more warpgroups share an SM; dq at Dh >= 64 does
// better with 64 (measured at (1, 2, 4096, 64)).
constexpr int dq_keys(int dh) { return dh == 32 ? 32 : 64; }
constexpr int kDkvRows = 32;
// Stages of the ring: deep enough that a stage's refill (its row vectors'
// loads, then the TMA copy) stays ahead of the consumers.
constexpr int kRingStages = 4;
// Below this many blocks of one warpgroup (two per SM of an H100), a block
// runs two consumer warpgroups that split the loop.
constexpr int kSplitBelowBlocks = 264;

// Registers a thread of the producer and of a consumer warpgroup keep when
// a block has two consumer warpgroups and a whole producer warpgroup: 168
// each at launch (65536 over 384 threads), then 40 and 232 (setmaxnreg).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Blocks an SM must be able to hold: at Dh = 32 the work per score outside
// the tensor cores and each tile's latency set the time, and three blocks
// an SM (at most 128 registers a thread) measured faster than fewer; else
// one.
constexpr int min_blocks(int dh, int nwg) { return dh == 32 && nwg == 1 ? 3 : 1; }

constexpr int round_up_1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// Threads of a block with NWG consumer warpgroups: one producer warp after
// a single consumer warpgroup (its registers stay under the 255 a thread
// may have), a whole producer warpgroup after two, whose registers go to
// the consumers.
constexpr int threads(int nwg) {
  return nwg == 1 ? kWarpgroup + 32 : (nwg + 1) * kWarpgroup;
}

// Consumer warpgroups per block: 2 for a small grid with tiles to split.
int consumer_groups(long long blocks, int tiles) {
  return tiles >= 2 && blocks < kSplitBelowBlocks ? 2 : 1;
}

// 2^x (ex2.approx; a result below the smallest normal float is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulators of n8 blocks 2 kk, 2 kk + 1 as the bf16 A operand of the
// k16 step kk.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R],
                                         int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// The hand-over of partial sums between consumer warpgroups through
// shared memory (slots of R x 128 floats, free once every consumer has left
// its loop): put_sums writes a warpgroup's accumulators into a slot,
// add_sums adds a slot into the accumulators, both in register order.
template <int R>
__device__ __forceinline__ void put_sums(const float (&acc)[R], float* buf,
                                         int slot, int lane128) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    buf[(slot * R + r) * kWarpgroup + lane128] = acc[r];
}

template <int R>
__device__ __forceinline__ void add_sums(float (&acc)[R], const float* buf,
                                         int slot, int lane128) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc[r] += buf[(slot * R + r) * kWarpgroup + lane128];
}

// Row 16 w + g + 8 hh of an m64nDH accumulator set, scaled, as bf16 pairs
// into row ``row`` of a (rows, DH) bf16 array.
template <int DH>
__device__ __forceinline__ void store_row(bf16* dst, size_t row,
                                          const float (&acc)[DH / 2], int hh,
                                          int t, float scale) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + row * DH + 8 * j + 2 * t) = pack_bf16(
        acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = shared_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// dq (and delta): one block per (batch, head, 64 query rows).  Per K/V
// tile: s = q k^T and dp = dO v^T, ds in registers, then dq += ds k.
// ---------------------------------------------------------------------------

template <int DH, int NWG>
struct DqPlan {
  using Own = SwizzledTile<DH, kTile>;  // Q, dO
  static constexpr int kKeys = dq_keys(DH);  // keys per K/V tile
  using Kv = SwizzledTile<DH, kKeys>;   // K, V of a stage
  static constexpr int kStages = kRingStages;
  static constexpr int kThreads = threads(NWG);
  static constexpr int kOwnBytes = 2 * Own::kBytes;
  // K, V, and the key bias (float32, log2 units).
  static constexpr int kStageBytes = round_up_1024(2 * Kv::kBytes + kKeys * 4);
  static constexpr int kBarOffset = kOwnBytes + kStages * kStageBytes;
  // 1024 bytes of slack to align the base, then one own barrier and a full
  // and an empty barrier per stage.
  static constexpr int kBytes = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
  static_assert(kStages % NWG == 0, "a stage serves one warpgroup");
  static_assert((NWG - 1) * kTile * DH * 4 <= kStages * kStageBytes,
                "the warpgroups' sums must fit in the ring");
};

template <int DH, int NWG>
__global__ void __launch_bounds__(DqPlan<DH, NWG>::kThreads,
                                  min_blocks(DH, NWG))
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const uint8_t* __restrict__ key_mask,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_sum,
                         float* __restrict__ delta, bf16* __restrict__ dq,
                         int H, int S, int causal, float scale) {
  using P = DqPlan<DH, NWG>;
  using Own = typename P::Own;
  using Kv = typename P::Kv;
  constexpr int BK = P::kKeys;
  constexpr int ST = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + Own::kBytes;
  auto stage = [&](int s) { return smem + P::kOwnBytes + s * P::kStageBytes; };
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + ST;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const size_t head = static_cast<size_t>(bh) * S;  // row of (b, h, 0)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, S) + BK - 1) / BK);

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // Producer: Q and dO once, then K, V and the key bias per stage.
    // Its first warp does the work.
    if (NWG > 1) regs_dec<kProducerRegs>();
    if (warp > NWG * 4) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(own_full, P::kOwnBytes);
      tma_tile<DH, kTile>(q_s, &q_map, own_full, q0, bh);
      tma_tile<DH, kTile>(do_s, &do_map, own_full, q0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      // The mask is read before the wait, so its latency overlaps it.
      float kb[BK / 32];
#pragma unroll
      for (int j = 0; j < BK / 32; ++j)
        kb[j] = key_bias(key_mask, b, S, i * BK + 32 * j + lane) * kLog2e;
      mbar_wait(&empty[s], (i / ST & 1) ^ 1);
      unsigned char* st = stage(s);
      // The copies first, then the bias (its loads may still be in
      // flight); each lane arrives once its share is stored.
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * Kv::kBytes);
        tma_tile<DH, BK>(st, &k_map, &full[s], i * BK, bh);
        tma_tile<DH, BK>(st + Kv::kBytes, &v_map, &full[s], i * BK, bh);
      }
      float* bias = reinterpret_cast<float*>(st + 2 * Kv::kBytes);
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) bias[32 * j + lane] = kb[j];
      mbar_arrive(&full[s]);
    }
    return;
  }

  // Consumers.  Thread 128 wg + 32 w + 4 g + t holds rows 16 w + g and
  // 16 w + g + 8 of the block's 64.
  if (NWG > 1) regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;

  // Row statistics (m in log2 units); delta in float32 from the bf16 O and
  // dO rows, 8 columns per lane per pass.  A row past S gets inv_l = 0, so
  // its p and ds are 0.
  float m[2], inv_l[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * w + g + 8 * hh;
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
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 xb, yb;
          memcpy(&xb, &xs[e], 4);
          memcpy(&yb, &ys[e], 4);
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
    m[hh] = real ? row_max[head + row] * kLog2e : 0.f;
    inv_l[hh] = real ? 1.f / row_sum[head + row] : 0.f;
    if (real && t == 0 && wg == 0) delta[head + row] = part_sum;
  }

  float acc[DH / 2] = {};  // dq of the block's rows, unscaled
  mbar_wait(own_full, 0);
  const uint32_t q_addr = shared_addr(q_s);
  const uint32_t do_addr = shared_addr(do_s);
  for (int i = wg; i < n_tiles; i += NWG) {
    const int s = i % ST;
    mbar_wait(&full[s], i / ST & 1);
    const uint32_t k_addr = shared_addr(stage(s));
    const uint32_t v_addr = k_addr + Kv::kBytes;
    const float* bias_s =
        reinterpret_cast<const float*>(stage(s) + 2 * Kv::kBytes);

    float sc[BK / 2], dp[BK / 2];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_ss(sc, Own::k_major(q_addr, ks), Kv::k_major(k_addr, ks), ks);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_ss(dp, Own::k_major(do_addr, ks), Kv::k_major(v_addr, ks), ks);
    wgmma_commit();

    // p from s while dp is still on the tensor cores, then ds.  A tile of
    // 64 real keys wholly inside the causal band (every tile when not
    // causal) needs no per-score checks.
    const int k0 = i * BK;
    const int n_keys = min(BK, S - k0);
    const bool interior =
        n_keys == BK && !(causal && k0 + BK - 1 > q0);
    const float c1 = scale * kLog2e;
    wgmma_wait<1>();
    fence_regs(sc);
    if (interior) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 bl = *reinterpret_cast<const float2*>(bias_s + 8 * j +
                                                           2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] =
              exp2_approx(fmaf(sc[4 * j + e], c1, e & 1 ? bl.y : bl.x) -
                          m[e >> 1]) *
              inv_l[e >> 1];
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          const int row = q0 + 16 * w + g + 8 * (e >> 1);
          float p = 0.f;
          if (kj < n_keys) {
            const float x = causal && k0 + kj > row
                                ? kMaskedLog2
                                : fmaf(sc[4 * j + e], c1, bias_s[kj]);
            p = exp2_approx(x - m[e >> 1]) * inv_l[e >> 1];
          }
          sc[4 * j + e] = p;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t + (e & 1);
        const int row = q0 + 16 * w + g + 8 * (e >> 1);
        const bool live =
            interior || (kj < n_keys && !(causal && k0 + kj > row));
        sc[4 * j + e] =
            live ? sc[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]) : 0.f;
      }
    }
    // dq += ds k: ds (bf16) from the accumulators, k MN-major.
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      acc_to_a(a[kk], sc, kk);
      fence_regs(a[kk]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, a[kk], Kv::mn_major(k_addr, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  // Warpgroups 1 .. NWG - 1 hand their sums to warpgroup 0, which adds
  // them in that order.
  if (NWG > 1) {
    float* buf = reinterpret_cast<float*>(stage(0));
    named_sync(1, NWG * kWarpgroup);
    if (wg > 0) put_sums(acc, buf, wg - 1, tid % kWarpgroup);
    named_sync(1, NWG * kWarpgroup);
    if (wg > 0) return;
    for (int p = 1; p < NWG; ++p) add_sums(acc, buf, p - 1, tid % kWarpgroup);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * w + g + 8 * hh;
    if (row < S) store_row<DH>(dq, head + row, acc, hh, t, scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (batch, head, 64 keys).  Per Q/dO tile: s^T = k q^T
// and dp^T = v dO^T, p^T and ds^T in registers, then dv += p^T dO and
// dk += ds^T q.
// ---------------------------------------------------------------------------

template <int DH, int NWG>
struct DkvPlan {
  static constexpr int kRows = kDkvRows;  // rows per Q/dO tile
  using Own = SwizzledTile<DH, kTile>;               // K, V
  using Qt = SwizzledTile<DH, kRows>;                // Q, dO of a stage
  static constexpr int kStages = kRingStages;
  static constexpr int kThreads = threads(NWG);
  static constexpr int kOwnBytes = 2 * Own::kBytes;
  // Q, dO, and the rows' m (log2 units), 1/l, delta (float32).
  static constexpr int kStageBytes =
      round_up_1024(2 * Qt::kBytes + 3 * kRows * 4);
  static constexpr int kBarOffset = kOwnBytes + kStages * kStageBytes;
  static constexpr int kBytes = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
  static_assert(kStages % NWG == 0, "a stage serves one warpgroup");
  static_assert((NWG - 1) * kTile * DH * 2 * 4 <= kStages * kStageBytes,
                "the warpgroups' sums must fit in the ring");
};

template <int DH, int NWG>
__global__ void __launch_bounds__(DkvPlan<DH, NWG>::kThreads,
                                  min_blocks(DH, NWG))
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const uint8_t* __restrict__ key_mask,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int S, int causal, float scale) {
  using P = DkvPlan<DH, NWG>;
  using Own = typename P::Own;
  using Qt = typename P::Qt;
  constexpr int BQ = P::kRows;
  constexpr int ST = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + Own::kBytes;
  auto stage = [&](int s) { return smem + P::kOwnBytes + s * P::kStageBytes; };
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + ST;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const size_t head = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_tiles = (S + BQ - 1) / BQ;

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // Producer: K and V once, then Q, dO and the row vectors per stage.
    // Its first warp does the work.
    if (NWG > 1) regs_dec<kProducerRegs>();
    if (warp > NWG * 4) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(own_full, P::kOwnBytes);
      tma_tile<DH, kTile>(k_s, &k_map, own_full, k0, bh);
      tma_tile<DH, kTile>(v_s, &v_map, own_full, k0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      // The rows' statistics are read before the wait, so their latency
      // overlaps it.
      float mx[BQ / 32], il[BQ / 32], dl[BQ / 32];
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        const int row = i * BQ + 32 * j + lane;
        const bool real = row < S;
        mx[j] = real ? row_max[head + row] * kLog2e : 0.f;
        il[j] = real ? 1.f / row_sum[head + row] : 0.f;
        dl[j] = real ? delta[head + row] : 0.f;
      }
      mbar_wait(&empty[s], (i / ST & 1) ^ 1);
      unsigned char* st = stage(s);
      // The copies first, then the statistics (their loads may still be
      // in flight); each lane arrives once its share is stored.
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * Qt::kBytes);
        tma_tile<DH, BQ>(st, &q_map, &full[s], i * BQ, bh);
        tma_tile<DH, BQ>(st + Qt::kBytes, &do_map, &full[s], i * BQ, bh);
      }
      float* stats = reinterpret_cast<float*>(st + 2 * Qt::kBytes);
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        stats[32 * j + lane] = mx[j];
        stats[BQ + 32 * j + lane] = il[j];
        stats[2 * BQ + 32 * j + lane] = dl[j];
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // Consumers.  Thread 128 wg + 32 w + 4 g + t holds keys 16 w + g and
  // 16 w + g + 8 of the block's 64.
  if (NWG > 1) regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;

  bool kreal[2];
  float kbias[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + 16 * w + g + 8 * hh;
    kreal[hh] = key < S;
    kbias[hh] = key_bias(key_mask, b, S, key) * kLog2e;
  }

  // dk (unscaled) and dv of the block's keys.
  float acc_dk[DH / 2] = {}, acc_dv[DH / 2] = {};
  mbar_wait(own_full, 0);
  const uint32_t k_addr = shared_addr(k_s);
  const uint32_t v_addr = shared_addr(v_s);
  for (int i = wg; i < n_tiles; i += NWG) {
    const int s = i % ST;
    mbar_wait(&full[s], i / ST & 1);
    const uint32_t q_addr = shared_addr(stage(s));
    const uint32_t do_addr = q_addr + Qt::kBytes;
    const float* m_s =
        reinterpret_cast<const float*>(stage(s) + 2 * Qt::kBytes);
    const float* il_s = m_s + BQ;
    const float* delta_s = il_s + BQ;

    float sc[BQ / 2], dp[BQ / 2];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_ss(sc, Own::k_major(k_addr, ks), Qt::k_major(q_addr, ks), ks);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_ss(dp, Own::k_major(v_addr, ks), Qt::k_major(do_addr, ks), ks);
    wgmma_commit();

    // p^T from s^T while dp^T is still on the tensor cores, then ds^T.  A
    // tile of real rows and keys wholly inside the causal band (every tile
    // when not causal) needs no per-score checks.
    const int i0 = i * BQ;
    const int n_rows = min(BQ, S - i0);
    const bool interior = n_rows == BQ && k0 + kTile <= S &&
                          !(causal && k0 + kTile - 1 > i0);
    const float c1 = scale * kLog2e;
    wgmma_wait<1>();
    fence_regs(sc);
    if (interior) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int ri = 8 * j + 2 * t;
        const float2 mm = *reinterpret_cast<const float2*>(m_s + ri);
        const float2 il = *reinterpret_cast<const float2*>(il_s + ri);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] =
              exp2_approx(fmaf(sc[4 * j + e], c1, kbias[e >> 1]) -
                          (e & 1 ? mm.y : mm.x)) *
              (e & 1 ? il.y : il.x);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int ri = 8 * j + 2 * t;
        const float2 mm = *reinterpret_cast<const float2*>(m_s + ri);
        const float2 il = *reinterpret_cast<const float2*>(il_s + ri);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const int key = k0 + 16 * w + g + 8 * (e >> 1);
          float p = 0.f;
          if (ri + c < n_rows && kreal[e >> 1]) {
            const float x = causal && key > i0 + ri + c
                                ? kMaskedLog2
                                : fmaf(sc[4 * j + e], c1, kbias[e >> 1]);
            p = exp2_approx(x - (c ? mm.y : mm.x)) * (c ? il.y : il.x);
          }
          sc[4 * j + e] = p;
        }
      }
    }
    // dv += p^T dO (p^T as bf16 from the accumulators, dO MN-major) runs
    // while ds^T is formed.
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a(pa[kk], sc, kk);
      fence_regs(pa[kk]);
    }
    fence_regs(acc_dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(acc_dv, pa[kk], Qt::mn_major(do_addr, 16 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // dp^T (committed before dv)
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int ri = 8 * j + 2 * t;
      const float2 dd = *reinterpret_cast<const float2*>(delta_s + ri);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        const int key = k0 + 16 * w + g + 8 * (e >> 1);
        const bool live = interior || (ri + c < n_rows && kreal[e >> 1] &&
                                       !(causal && key > i0 + ri + c));
        dp[4 * j + e] =
            live ? sc[4 * j + e] * (dp[4 * j + e] - (c ? dd.y : dd.x)) : 0.f;
      }
    }
    // dk += ds^T q: ds^T (bf16) from the accumulators, q MN-major.
    uint32_t sa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a(sa[kk], dp, kk);
      fence_regs(sa[kk]);
    }
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(acc_dk, sa[kk], Qt::mn_major(q_addr, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) fence_regs(pa[kk]);
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(&empty[s]);
  }

  // Warpgroups 1 .. NWG - 1 hand their sums to warpgroup 0, which adds
  // them in that order.
  if (NWG > 1) {
    float* buf = reinterpret_cast<float*>(stage(0));
    const int lane128 = tid % kWarpgroup;
    named_sync(1, NWG * kWarpgroup);
    if (wg > 0) {
      put_sums(acc_dk, buf, 2 * (wg - 1), lane128);
      put_sums(acc_dv, buf, 2 * (wg - 1) + 1, lane128);
    }
    named_sync(1, NWG * kWarpgroup);
    if (wg > 0) return;
    for (int p = 1; p < NWG; ++p) {
      add_sums(acc_dk, buf, 2 * (p - 1), lane128);
      add_sums(acc_dv, buf, 2 * (p - 1) + 1, lane128);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!kreal[hh]) continue;
    const size_t key_row = head + k0 + 16 * w + g + 8 * hh;
    store_row<DH>(dk, key_row, acc_dk, hh, t, scale);
    store_row<DH>(dv, key_row, acc_dv, hh, t, 1.f);
  }
}

// Sets every instance's dynamic shared memory limit to what it uses, at
// any size (a launch of these kernels with the default limit failed with
// cudaErrorInvalidValue on the card).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH, int NWG>
cudaError_t launch_dq_groups(const bf16* q, const bf16* k, const bf16* v,
                             const uint8_t* key_mask, const bf16* o,
                             const bf16* dout, const float* row_max,
                             const float* row_sum, float* delta, bf16* dq,
                             int B, int H, int S, int causal,
                             cudaStream_t stream) {
  using P = DqPlan<DH, NWG>;
  static const cudaError_t attr =
      set_smem(flash_bwd_dq_bf16_kernel<DH, NWG>, P::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[4];
  cudaError_t err = rows_map<DH, kTile>(&maps[0], q, B * H, S);
  if (err == cudaSuccess) err = rows_map<DH, P::kKeys>(&maps[1], k, B * H, S);
  if (err == cudaSuccess) err = rows_map<DH, P::kKeys>(&maps[2], v, B * H, S);
  if (err == cudaSuccess) err = rows_map<DH, kTile>(&maps[3], dout, B * H, S);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dq_bf16_kernel<DH, NWG><<<grid, P::kThreads, P::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], key_mask, o, dout, row_max, row_sum,
      delta, dq, H, S, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                      const uint8_t* key_mask, const bf16* o,
                      const bf16* dout, const float* row_max,
                      const float* row_sum, float* delta, bf16* dq, int B,
                      int H, int S, int causal, cudaStream_t stream) {
  const int blocks = (S + kTile - 1) / kTile;
  const int tiles = (S + dq_keys(DH) - 1) / dq_keys(DH);
  if (consumer_groups(static_cast<long long>(blocks) * B * H, tiles) == 2)
    return launch_dq_groups<DH, 2>(q, k, v, key_mask, o, dout, row_max,
                                   row_sum, delta, dq, B, H, S, causal,
                                   stream);
  return launch_dq_groups<DH, 1>(q, k, v, key_mask, o, dout, row_max,
                                 row_sum, delta, dq, B, H, S, causal, stream);
}

template <int DH, int NWG>
cudaError_t launch_dkv_groups(const bf16* q, const bf16* k, const bf16* v,
                              const uint8_t* key_mask, const bf16* dout,
                              const float* row_max, const float* row_sum,
                              const float* delta, bf16* dk, bf16* dv, int B,
                              int H, int S, int causal, cudaStream_t stream) {
  using P = DkvPlan<DH, NWG>;
  static const cudaError_t attr =
      set_smem(flash_bwd_dkv_bf16_kernel<DH, NWG>, P::kBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[4];
  cudaError_t err = rows_map<DH, P::kRows>(&maps[0], q, B * H, S);
  if (err == cudaSuccess) err = rows_map<DH, kTile>(&maps[1], k, B * H, S);
  if (err == cudaSuccess) err = rows_map<DH, kTile>(&maps[2], v, B * H, S);
  if (err == cudaSuccess) err = rows_map<DH, P::kRows>(&maps[3], dout, B * H, S);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dkv_bf16_kernel<DH, NWG><<<grid, P::kThreads, P::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], key_mask, row_max, row_sum, delta,
      dk, dv, H, S, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const uint8_t* key_mask, const bf16* dout,
                       const float* row_max, const float* row_sum,
                       const float* delta, bf16* dk, bf16* dv, int B, int H,
                       int S, int causal, cudaStream_t stream) {
  const int blocks = (S + kTile - 1) / kTile;
  const int tiles = (S + kDkvRows - 1) / kDkvRows;
  if (consumer_groups(static_cast<long long>(blocks) * B * H, tiles) == 2)
    return launch_dkv_groups<DH, 2>(q, k, v, key_mask, dout, row_max,
                                    row_sum, delta, dk, dv, B, H, S, causal,
                                    stream);
  return launch_dkv_groups<DH, 1>(q, k, v, key_mask, dout, row_max, row_sum,
                                  delta, dk, dv, B, H, S, causal, stream);
}

bool bad_shape(int B, int H, int S) {
  return B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, H, S, Dh) bf16, contiguous, 16-byte
// aligned; row_max, row_sum (from the forward) and delta: (B, H, S)
// float32.  key_mask: (B, S) bool (nonzero = attend) or null.  Each entry
// returns the cudaError_t of its launch (cudaErrorNotSupported if the
// CUDA driver cannot encode tensor maps).

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
