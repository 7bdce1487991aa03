// Flash-attention forward for Hopper (sm_90a), the bf16 instance: q, k, v
// and O in bf16, lse, m and l in float32, both products warpgroup wgmma on
// the bf16 tensor cores over TMA-fed tiles.
//
// Replaces the TPU kernel flexdm_tpu/ops/attention.py:_flash_fwd_kernel for
// bf16 inputs (the JAX package's --dtype bfloat16), with the contract of
// the float32 kernel flash_attention_fwd.cu: softmax(q k^T / sqrt(Dh) +
// bias) v by an online softmax over key tiles, O (B, H, S, Dh), and the row
// logsumexp, max m and sum l (B, H, S), in natural-log units, that the
// backward kernels rebuild p from.  Masking is the float32 kernel's: the
// finite -1e9 key bias (a fully masked row averages V over its S real
// keys), the causal band replaced by -1e9 on absolute positions (the tiles
// above the diagonal are not skipped: a row whose in-band keys are all
// masked ties with them and averages V over all S keys), keys past S
// excluded outright.
//
// Arithmetic.  S = Q K^T is wgmma on the exact bf16 operands, summed in
// float32.  Scores are kept in log2 units: x = s (scale log2 e) + bias
// log2 e is one FFMA, p = 2^(x - m2) one ex2, m2 the running row max of x.
// The online softmax (m2, l, the rescale of the accumulator) and the final
// division stay float32.  P enters O += P V as a bf16 operand (rounded to
// nearest even from the float32 p; l sums the float32 p), the one rounding
// that the TPU kernel, which keeps p in float32, does not do.  O is rounded
// to bf16 once, at the end; m = m2 ln 2 and lse = m + log l are written in
// natural-log units.  The CPU emulation of this arithmetic in
// tests/test_torch_attention_bf16.py meets the card's bar (one bf16 ulp plus
// 2^-8 of max|O| against the plain version).
//
// What bounds it on an H100 (132 SMs, 1980 MHz SM clock, 3.35 TB/s, 989
// TFLOP/s bf16).  At the crello_flat training shape (64, 8, 500, 32): the
// bytes (q, k, v, O in bf16; lse, m, l in float32) 0.0205 ms, the products
// (4 S^2 Dh per head) 0.0166 ms, the 128 million exponentials on the SFU
// (16 a clock an SM) 0.031 ms, and every float32 instruction per score
// another 0.0038 ms of issue (128 lanes a clock an SM): the exponentials
// and the work per score bound it, not the loads.  At (256, 8, 500, 32)
// four times each (exponentials 0.122 ms, bytes 0.082 ms).  At the
// training shape (256, 8, 50, 32) one key tile per block: the bytes
// (0.0082 ms) and the latency of each block's load -> product -> softmax ->
// product -> store chain, which only other blocks on the SM hide.
//
// Design.
//   * Instances are tile widths DH = 32, 64 and 128 ("Dh = 32" below names
//     the instance); the head dim is a runtime value from 1 to 128, run on
//     the smallest width that holds its row, zero-filled by TMA, its scale
//     1/sqrt(Dh) and its stores Dh wide (hopper.cuh, "Head dims").
//   * One consumer warpgroup owns 64 query rows (the wgmma M) and walks
//     every key tile of 64 keys.  Q arrives once by TMA.  S = Q K^T is an SS
//     product (Q and K K-major); O += P V an RS product, P packed to bf16
//     from the score accumulators, V read MN-major through the transpose
//     bit.  No mma.sync, no ldmatrix.
//   * One producer warp keeps the K/V tiles in flight by TMA in a ring
//     (3 stages, 2 at Dh = 128 for shared memory), each tile's key bias,
//     already in log2 units, loaded by its lanes beside it.  A stage's full
//     mbarrier completes on the TMA bytes and the lanes' arrivals, its
//     empty mbarrier on the consumers' 128 arrivals: no block-wide sync in
//     the key loop.  Tensor maps over (B H, S, Dh) views, passed as
//     __grid_constant__ parameters: rows past S arrive as zeros, never as
//     the next head's.
//   * Per score on a tile of 64 attended keys inside the causal band: one
//     FMNMX on the raw score, one FFMA and one ex2 (p = 2^(s scale log2 e -
//     m2)), one FADD into the lane's row sum, half a bf16 pack.  The
//     producer marks such tiles (a warp vote on their key bias).  Another
//     tile adds one FFMA for x = s scale log2 e + bias log2 e, and the
//     key-range and causal checks run only on the tiles with keys past S or
//     crossing the diagonal.  A row's max takes two shuffles a tile; its sum
//     is kept per lane and reduced once.
//   * Tensor cores overlap the softmax (intra-warpgroup pipelining): tile
//     i's S = Q K^T and tile i - 1's O += P V are issued together; the
//     softmax of tile i runs while P V is still on the tensor cores, and O
//     is rescaled once that product has landed.  It gained ~2% over
//     waiting for P V first (ptxas schedules most of the softmax after the
//     wait all the same); what did gain was blocks an SM: four of 160
//     threads at Dh = 32 (95 registers) against three (118) took (64, 8,
//     500, 32) from 0.090 to 0.079 ms and (256, 8, 50, 32) from 0.0155 to
//     0.0128 ms on an H100 at 700 W (tools/torch_fwd_bench.py).  Two
//     consumer warpgroups taking turns were not chosen: at S <= 64 (the
//     Ours-EXP paths) a block has one key tile and nothing to take turns
//     on, and blocks of one warpgroup already interleave on an SM.
//   * No atomics, every sum in a fixed order: a second call is bitwise
//     equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "wgmma_bf16.cuh"

namespace {

constexpr int kRows = 64;                 // query rows per block (wgmma M)
constexpr int kKeys = 64;                 // keys per K/V tile
constexpr int kThreads = kWarpgroup + 32;  // consumers, then the producer

template <int DH>
struct FwdPlan {
  using Own = SwizzledTile<DH, kRows>;  // Q
  using Kv = SwizzledTile<DH, kKeys>;   // K, V of a stage
  static constexpr int kStages = DH == 128 ? 2 : 3;
  // K, V, the key bias (float32, log2 units) and a word that says whether
  // every key of the tile is attended.
  static constexpr int kStageBytes =
      round_up_1024(2 * Kv::kBytes + kKeys * 4 + 4);
  // Blocks an SM must hold: four at Dh = 32 (at most 96 registers a
  // thread; faster than three at S = 50 and 500), three at Dh = 64, two at
  // Dh = 128.
  static constexpr int kMinBlocks = DH == 32 ? 4 : DH == 64 ? 3 : 2;
  // 1024 bytes of slack to align the base, Q, then ``stages`` stages.
  static constexpr int bytes(int stages) {
    return 1024 + Own::kBytes + stages * kStageBytes;
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads, FwdPlan<DH>::kMinBlocks)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const uint8_t* __restrict__ key_mask,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ row_max, float* __restrict__ row_sum,
                      int H, int S, int ld, int causal, float scale_log2) {
  using P = FwdPlan<DH>;
  using Own = typename P::Own;
  using Kv = typename P::Kv;
  constexpr int BK = kKeys;
  constexpr int ST = P::kStages;
  // Q's barrier, then a full and an empty barrier per stage.
  __shared__ uint64_t bars[1 + 2 * ST];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;
  auto stage = [&](int s) { return smem + Own::kBytes + s * P::kStageBytes; };
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const size_t head = static_cast<size_t>(bh) * S;  // row of (b, h, 0)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_tiles = (S + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: Q once, then K, V and the key bias per stage.
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, Own::kBytes);
      tma_tile<DH, kRows>(q_s, &q_map, q_full, q0, bh);
    }
    for (int i = 0, s = 0, phase = 0; i < n_tiles; ++i) {
      // The mask is read before the wait, so its latency overlaps it.
      float kb[BK / 32];
#pragma unroll
      for (int j = 0; j < BK / 32; ++j)
        kb[j] = key_bias(key_mask, b, S, i * BK + 32 * j + lane) * kLog2e;
      mbar_wait(&empty[s], phase ^ 1);
      unsigned char* st = stage(s);
      // The copies first, then the bias; each lane arrives once its share
      // is stored.
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * Kv::kBytes);
        tma_tile<DH, BK>(st, &k_map, &full[s], i * BK, bh);
        tma_tile<DH, BK>(st + Kv::kBytes, &v_map, &full[s], i * BK, bh);
      }
      float* bias = reinterpret_cast<float*>(st + 2 * Kv::kBytes);
      bool attended = true;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        bias[32 * j + lane] = kb[j];
        attended = attended && kb[j] == 0.f;
      }
      attended = __all_sync(0xffffffffu, attended);
      if (lane == 0) bias[BK] = attended ? 1.f : 0.f;
      mbar_arrive(&full[s]);
      if (++s == ST) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers.  Thread 32 w + 4 g + t holds rows 16 w + g and 16 w + g + 8
  // of the block's 64: sc[4 j + e] is row 16 w + g + 8 (e >> 1), key
  // 8 j + 2 t + (e & 1) of the tile.
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + 16 * warp + g;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
  float l[2] = {0.f, 0.f};                      // the lane's share of the sum
  float acc[DH / 2] = {};                       // O, unnormalised
  float sc[BK / 2];                             // scores, then p
  uint32_t pa[BK / 16][4];                      // P (bf16) for P V
  // The descriptors of Q and of stage 0's K and V; a stage's are stage 0's
  // moved by whole stages.
  const uint64_t q_desc = Own::k_major(shared_addr(q_s), 0);
  const uint64_t k_desc = Kv::k_major(shared_addr(stage(0)), 0);
  const uint64_t v_desc = Kv::mn_major(shared_addr(stage(0)) + Kv::kBytes, 0);
  constexpr uint32_t kStageStep = P::kStageBytes >> 4;

  // S = Q K^T of the tile in stage s into sc (one commit group).
  auto issue_scores = [&](int s) {
    const uint64_t kd = k_desc + s * kStageStep;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_ss(sc, q_desc + Own::k_step(ks), kd + Kv::k_step(ks), ks);
    wgmma_commit();
  };
  // O += P V of the tile in stage s (one commit group).
  auto issue_pv = [&](int s) {
    const uint64_t vd = v_desc + s * kStageStep;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, pa[kk], vd + Kv::mn_step(16 * kk));
    wgmma_commit();
  };
  // The online softmax of tile i (in stage s) on sc: the new row max (log2
  // units), p = 2^(x - m2) into sc, the lane's row sums; returns the
  // rescale factors of the earlier sums in ``alpha``.  A tile whose keys
  // are all attended and inside the causal band has x = s scale log2 e, so
  // its max is the raw scores' max scaled and p = 2^(s scale log2 e - m2)
  // is one FFMA and one ex2; another tile first forms x = s scale log2 e +
  // bias log2 e and, if it has keys past S or crosses the causal diagonal,
  // the per-score checks.  A row's 16 scores go through four chains each
  // (c = 2 (j & 1) + (e & 1)) for the max and the sum, not one.
  auto softmax = [&](int i, int s, float (&alpha)[2]) {
    const int k0 = i * BK;
    const int n_keys = min(BK, S - k0);
    const float* bias_s =
        reinterpret_cast<const float*>(stage(s) + 2 * Kv::kBytes);
    const bool checks = n_keys < BK || (causal && k0 + BK - 1 > q0);
    // p = 2^(sc mul - m2): mul is scale log2 e on raw scores, 1 on x.
    float mul = scale_log2;
    if (checks || bias_s[BK] == 0.f) {
      mul = 1.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 bl = *reinterpret_cast<const float2*>(bias_s + 8 * j +
                                                           2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] =
              fmaf(sc[4 * j + e], scale_log2, e & 1 ? bl.y : bl.x);
      }
      if (checks) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = 8 * j + 2 * t + (e & 1);
            if (kj >= n_keys)
              sc[4 * j + e] = -CUDART_INF_F;
            else if (causal && k0 + kj > row0 + 8 * (e >> 1))
              sc[4 * j + e] = kMaskedLog2;
          }
        }
      }
    }
    float mx[2][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = mx[e >> 1][2 * (j & 1) + (e & 1)];
        x = j < 2 ? sc[4 * j + e] : fmaxf(x, sc[4 * j + e]);
      }
    }
    // The tile's first key exists, so every row's max is finite after the
    // first tile; alpha is 0 on the first tile.  Scaling by mul > 0 keeps
    // the max: fl(mul max s) = max fl(mul s).
    float neg_m[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      x = fmaxf(m[hh], x * mul);
      alpha[hh] = exp2_approx(m[hh] - x);
      m[hh] = x;
      neg_m[hh] = -x;
    }
    float ps[2][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(sc[4 * j + e], mul, neg_m[e >> 1]));
        sc[4 * j + e] = p;
        float& sum = ps[e >> 1][2 * (j & 1) + (e & 1)];
        sum = j < 2 ? p : sum + p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      l[hh] = l[hh] * alpha[hh] +
              ((ps[hh][0] + ps[hh][1]) + (ps[hh][2] + ps[hh][3]));
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], sc, kk);
  };
  auto fence_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
  };

  float alpha[2];
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  fence_regs(sc);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0, 0, alpha);
  pack_p();
  // Stage s of tile i, its phase, and the stage of tile i - 1.
  int s = 0, phase = 0;
  for (int i = 1; i < n_tiles; ++i) {
    const int prev = s;
    if (++s == ST) {
      s = 0;
      phase ^= 1;
    }
    mbar_wait(&full[s], phase);
    fence_regs(sc);
    fence_p();
    fence_regs(acc);
    wgmma_fence();
    issue_scores(s);
    issue_pv(prev);
    wgmma_wait<1>();  // the scores (committed before P V)
    fence_regs(sc);
    softmax(i, s, alpha);
    // The softmax stays ahead of the wait for P V: the fences need its
    // results.
    fence_regs(sc);
    fence_regs(l);
    fence_regs(alpha);
    wgmma_wait<0>();  // P V of tile i - 1
    fence_p();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
    }
    pack_p();
  }
  fence_p();
  fence_regs(acc);
  wgmma_fence();
  issue_pv(s);
  wgmma_wait<0>();
  fence_p();
  fence_regs(acc);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    store_row<DH>(o, head + row, ld, acc, hh, t, 1.f / sum);
    if (t == 0) {
      const float mn = m[hh] * kLn2;
      lse[head + row] = mn + logf(sum);
      row_max[head + row] = mn;
      row_sum[head + row] = sum;
    }
  }
}

// The launch on tiles DH wide of tensors ld wide (head dim Dh).
template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const uint8_t* key_mask, bf16* o, float* lse,
                   float* row_max, float* row_sum, int B, int H, int S,
                   int Dh, int ld, int causal, cudaStream_t stream) {
  using P = FwdPlan<DH>;
  static const cudaError_t attr =
      set_smem(flash_fwd_bf16_kernel<DH>, P::bytes(P::kStages));
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[3];
  const int BH = B * H;
  cudaError_t err = rows_map<DH, kRows>(&maps[0], q, BH, S, ld);
  if (err == cudaSuccess) err = rows_map<DH, kKeys>(&maps[1], k, BH, S, ld);
  if (err == cudaSuccess) err = rows_map<DH, kKeys>(&maps[2], v, BH, S, ld);
  if (err != cudaSuccess) return err;
  // A short sequence needs fewer stages than the ring has (and so less
  // shared memory a block).
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int bytes = P::bytes(n_tiles < P::kStages ? n_tiles : P::kStages);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  // The backward's c1: the same x from the same scores.
  const float scale_log2 = softmax_scale(Dh, kLog2e);
  flash_fwd_bf16_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], key_mask, o, lse, row_max, row_sum, H, S,
      ld, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, S, ld) bf16, contiguous, 16-byte aligned, ld = Dh
// rounded up to a multiple of 8 (16 bytes) with columns Dh .. ld - 1 of q,
// k and v zero (a padded copy; hopper.cuh, "Head dims"); 1 <= Dh <= 128.
// key_mask:
// (B, S) bool (one byte per key, nonzero = attend) or null for "all keys
// valid".  lse, row_max, row_sum: (B, H, S) float32.  Returns the
// cudaError_t of the launch (cudaErrorNotSupported if the CUDA driver
// cannot encode tensor maps).
extern "C" int flexdm_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* o, void* lse, void* row_max, void* row_sum, int B, int H, int S,
    int Dh, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535 ||
      bad_head_dim(Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = row_width(Dh, 8);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* ob = static_cast<bf16*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* mf = static_cast<float*>(row_max);
  auto* sf = static_cast<float*>(row_sum);
  auto st = static_cast<cudaStream_t>(stream);
#define FLEXDM_FWD_W(w)                                                   \
  launch<w>(qb, kb, vb, mask, ob, lf, mf, sf, B, H, S, Dh, ld, causal, st)
  const int width = tile_width(ld);
  return static_cast<int>(width == 32   ? FLEXDM_FWD_W(32)
                          : width == 64 ? FLEXDM_FWD_W(64)
                                        : FLEXDM_FWD_W(128));
#undef FLEXDM_FWD_W
}
