// Flash-attention forward for Hopper (sm_90a), float32 in and out, both
// products warpgroup wgmma on the TF32 tensor cores with each operand split
// into two TF32 terms, over tiles that TMA brings in.
//
// Replaces the TPU kernel flexdm_tpu/ops/attention.py:_flash_fwd_kernel
// (:77-113, launched by _flash_forward, :329).  Same contract: for every
// (batch, head, query row) it computes softmax(q k^T / sqrt(Dh) + bias) v
// with an online softmax over key tiles and writes O (B, H, S, Dh), the row
// logsumexp (B, H, S), and the row max m and row sum l (B, H, S), in
// natural-log units, that the backward kernels rebuild the probabilities
// from (p = exp(s - m) / l; see flash_attention_bwd.cu for why lse alone is
// not enough).
//
// Masking follows the plain reference (_attention_xla), not the padded TPU
// path:
//   * a key whose mask entry is false gets the FINITE additive bias -1e9,
//     so a fully masked row averages V over the S real keys instead of
//     producing NaN: every score of the row rounds to the same float, so
//     p = 1 for each of its S keys and l = S exactly;
//   * with `causal`, a key after the query row (absolute positions) gets the
//     score -1e9 (replaced, like jnp.where in the reference).  The tiles
//     above the diagonal are still visited: a row whose in-band keys are
//     all masked ties with them and averages V over all S keys;
//   * keys at index >= S (the ragged tail of the last tile) are excluded
//     outright (p = 0): nothing is padded in device memory.
//
// Arithmetic (wgmma_tf32.cuh, "Split TF32").  S = Q K^T and O += P V are
// wgmma.mma_async m64nNk8 with TF32 operands and float32 sums, each operand
// split once into hi = tf32(x) and lo = x - hi and a product computed as
// lo hi' + hi lo' + hi hi', the small terms of all k8 steps first.  Each
// tile's P V is summed from zero on the tensor cores and added to O's
// running sum in float32 (second_product, as the backward's ds k): the
// tensor cores cut their float32 sums toward zero, and chained over the key
// tiles those cuts would bias O (the backward's key-bias gradient failed
// chip_smoke.py's 1e-5 gate that way before this order).  Scores are in
// log2 units: x = s (scale log2 e) + bias log2 e is one FFMA and p =
// 2^(x - m2) one ex2, m2 the running row max of x; m = m2 ln 2 and
// lse = m + log l are written in natural-log units (a fully masked row's
// m2 = -1e9 log2 e gives back exactly -1e9).  A single TF32 pass keeps ~3
// decimal digits and misses the card's 2e-5 bar
// (tests/test_torch_attention.py emulates both;
// tests/test_torch_attention_tf32_wgmma.py emulates this kernel on its own
// tile layouts).
//
// What bounded the previous design (mma.sync.m16n8k8 on 4 warps, cp.async,
// the split in registers): at (256, 8, 50, 32) latency, ~220 registers a
// thread left two blocks an SM, too few warps to hide the dependent MMA ->
// exp -> MMA chain (0.0469 ms against a bound of 0.016); at S >= 500 the
// issue of the MMAs and of the split: every warp re-split each K and V
// fragment it loaded, about four instructions a value beside every three
// MMAs, ~95 TFLOP/s of MMA work (0.4574 ms at (64, 8, 500, 32)).
//
// What bounds this one on an H100 (132 SMs, 495 TFLOP/s TF32, 3.35 TB/s).
// The split triples the tensor work: at (64, 8, 500, 32) 3 x 16.4 GFLOP,
// 0.099 ms at the TF32 peak, beside 128 M exponentials (0.031 ms on the
// SFUs) and 0.040 ms of bytes; at (256, 8, 500, 32) four times each.  Per
// key tile of 64 keys (Dh = 32) a stream issues 12 m64n64k8 and 24
// m64n32k8 wgmmas (768 clocks of tensor work at the peak); beside them
// ~720 instructions a thread: the softmax of 64 x 64 scores, the split of
// p into A fragments (three instructions a value), the float32 adds and
// the descriptors; and the splitters' pass over K and V.  Measured on an
// H100 at 700 W (tools/torch_fwd_bench.py, PERF.md), 0.27 ms at
// (64, 8, 500, 32): the split's tensor floor is 36% of that, and the
// consumers' key loop (617 SASS instructions a warp a tile, 720 on the
// last) fills about 29% of the issue slots at 1980 MHz, an estimate that
// leaves out the splitters; the reasons of its stalls are not measured
// (no ncu).  At (256, 8, 50, 32)
// an item is one head's 50 keys, one tile: ~0.034 ms against 0.016 ms of
// bytes, each stream's ring prefetching the next item's tiles while this
// one computes.
//
// Design (the backward's dq kernel without dp and ds).
//   * Instances are tile widths DH = 32, 64 and 128 ("Dh = 32" below names
//     the instance); the head dim is a runtime value from 1 to 128, run on
//     the smallest width that holds its row, zero-filled by TMA, its scale
//     1/sqrt(Dh) and its stores Dh wide (hopper.cuh, "Head dims").  Dh 1-32
//     takes 32: at Dh = 16 the score products do twice the tensor work.
//   * An item is 64 query rows of one head (the wgmma M).  A block, one an
//     SM (persistent: the grid is the SMs), runs one or two streams, each a
//     consumer warpgroup taking the items first, first + stride, ..., and
//     one splitter warpgroup whose halves serve the streams.  Two streams
//     where there are more items than SMs and two streams' tiles fit (Dh <=
//     64), else one: 384 or 256 threads.
//   * Q arrives once an item by TMA and is split once; at Dh = 32 the
//     consumers hold its hi and lo as register A fragments (RS score
//     products) and the next item's Q lands at once; at Dh >= 64 it stays
//     in shared memory (SS).  Keeping it in shared memory at Dh = 32 too
//     measured 14% slower at S = 500.
//   * K/V tiles of 64 keys at Dh = 32 (m64n64k8 score products; 32 keys
//     measured 13% slower at S = 500, the tile's fixed costs paid twice as
//     often), 32 at Dh = 64 and 16 at Dh = 128 (registers and shared
//     memory), the N of S = Q K^T, arrive by TMA into the stream's ring
//     (tensor maps over (B H, S, Dh) views, __grid_constant__; rows past S
//     arrive as zeros, never as the next head's), refilled by the
//     consumers' thread 0 as soon as its warpgroup has emptied a stage,
//     across items.  The splitters write K's hi over the landed tile and
//     its lo beside it, and V's hi and lo only transposed (TF32 wgmma reads
//     both operands K-major, and P V reduces over V's rows), rows at
//     acc_order so that P enters as the A operand straight from the score
//     accumulators; then the tile's key bias in log2 units (the (B, S) byte
//     mask is not 16-byte aligned for a tensor map at S = 50).  A stage's
//     full mbarrier completes on the splitters' arrivals after a proxy
//     fence.  P V takes 32 keys a product (its A fragments, hi and lo, are
//     32 registers).
//   * Two streams take turns issuing their score products (Turns), so one
//     stream's products run while the other forms p.  Without the turns,
//     with P V inside them too (6% slower), forming the second half's p
//     while the first half's P V runs (2-3% slower), and one m64n64k8
//     product of P_hi against V's hi and lo side by side (fewer wgmmas, but
//     its 48 accumulators spilled): none measured faster.
//   * Descriptors: a product's first k8 step's, then one add a step
//     (desc_add), the warp index made warp-uniform (__shfl_sync) for the
//     compiler: 7% fewer instructions in the key loop, ~5% faster at
//     S = 500.
//   * A tile of real keys wholly inside the causal band (every tile but the
//     last when not causal) skips the per-score checks.  causal is a
//     template parameter, so non-causal launches carry no band checks.
//     The write before the products is a select in both paths (a branch
//     around values that feed a product made ptxas serialise every wgmma
//     of the backward's dk/dv kernel, C7520).
//   * A row's max takes two shuffles a tile; its sum is kept per lane and
//     reduced once, at the end.  Every O element is summed by one thread in
//     a fixed order: no atomics, a second call is bitwise equal.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

// Streams (consumer warpgroups) a block can run: two where two streams'
// tiles fit in shared memory (Dh <= 64).  At Dh = 64 the two-stream
// instances spill 76 and 100 bytes and still win: crello_scaled's
// (2048, 8, 50, 64) took 0.52 ms on two streams, 0.67 on one (H100, in
// turns, tools/torch_fwd_bench.py).
template <int DH>
constexpr int kMaxFwdStreams = DH == 128 ? 1 : 2;

// Keys per K/V tile, the N of S = Q K^T: 64 at Dh = 32 (m64n64k8 score
// products, half the tiles' fixed costs a key), else the backward's 32, 16
// at Dh = 128 (shared memory).
__host__ __device__ constexpr int fwd_keys(int dh) {
  return dh == 32 ? 64 : other_rows(dh);
}
// Keys a P V product takes: its A fragments (hi and lo) are 32 registers.
__host__ __device__ constexpr int pv_keys(int keys) {
  return keys < 32 ? keys : 32;
}

template <int DH, int NS>
struct FwdPlan {
  static constexpr int kKeys = fwd_keys(DH);  // keys per K/V tile
  static constexpr int kStreams = NS;
  static constexpr int kSplitters = kWarpgroup / kStreams;  // per stream
  static constexpr bool kOwnInRegs = DH == 32;  // Q fragments
  using Own = F32Tile<DH, kTile>;               // Q, Q lo
  using Kv = F32Tile<DH, kKeys>;                // K, K lo, V as landed
  using Vt = TransposedTile<DH, kKeys>;         // V^T hi, lo
  static constexpr int kOwnBytes = 2 * Own::kBytes;
  static constexpr int kStageBytes = 3 * Kv::kBytes + 2 * Vt::kBytes;
  static constexpr int kStages =
      ring_stages(NS, kOwnBytes, kStageBytes, kKeys * 4);
  static_assert(kStages >= 1, "a stage fits");
  static constexpr int kStreamBytes = kOwnBytes + kStages * kStageBytes;
  // The streams' tiles, their stages' key biases, then their barriers.
  static constexpr int kVecOffset = kStreams * kStreamBytes;
  static constexpr int kBarOffset =
      kVecOffset + kStreams * kStages * kKeys * 4;
  // 1024 bytes of slack to align the base.
  static constexpr int kBytes =
      1024 + kBarOffset + kStreams * barrier_bytes(kStages);
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

template <int DH, int NS, bool CAUSAL>
__global__ void __launch_bounds__(threads(NS), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const uint8_t* __restrict__ key_mask,
                 float* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ row_max, float* __restrict__ row_sum,
                 int H, int S, int ld, float scale_log2, int n_items) {
  using P = FwdPlan<DH, NS>;
  using Kv = typename P::Kv;
  using Vt = typename P::Vt;
  constexpr int BK = P::kKeys;
  constexpr int ST = P::kStages;
  constexpr int OT = P::Own::kBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);

  const int tid = threadIdx.x;
  // Warp-uniform to the compiler, so that it can keep the stream, its
  // tiles' addresses and the products' descriptors in uniform registers.
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const bool splitter = warp >= 4 * NS;
  // The thread's stream, and its index among the stream's threads.
  const int sid = splitter ? (tid - 4 * NS * 32) / P::kSplitters : warp / 4;
  const int lt = splitter ? (tid - 4 * NS * 32) % P::kSplitters : tid % 128;
  // The stream's own tiles (Q, Q lo), ring, key biases, barriers.
  unsigned char* q_s = smem + sid * P::kStreamBytes;
  auto stage = [&](int r) { return q_s + P::kOwnBytes + r * P::kStageBytes; };
  float* bias_v =
      reinterpret_cast<float*>(smem + P::kVecOffset) + sid * ST * BK;
  Barriers bar(smem + P::kBarOffset + sid * barrier_bytes(ST), ST);

  const int blocks = (S + kTile - 1) / kTile;  // query blocks of a head
  const int n_t = (S + BK - 1) / BK;          // K/V tiles of an item
  const int stride = gridDim.x * NS;
  const int first = blockIdx.x * NS + sid;

  // Copies (by the consumers' thread 0): an item's Q, and the tile at the
  // cursor into the stage just emptied (tile g + ST to tile g's).
  auto load_own = [&](int it) {
    const Item item = item_at(it, blocks);
    mbar_arrive_expect_tx(bar.own_loaded, OT);
    tma_f32_tile<DH, kTile>(q_s, &q_map, bar.own_loaded, item.row0, item.bh);
  };
  Cursor cur(first, blocks);
  auto load_next = [&](int r) {
    if (cur.item >= n_items) return;
    mbar_arrive_expect_tx(&bar.loaded[r], 2 * Kv::kBytes);
    tma_f32_tile<DH, BK>(stage(r), &k_map, &bar.loaded[r], cur.tile * BK,
                         cur.bh);
    tma_f32_tile<DH, BK>(stage(r) + 2 * Kv::kBytes, &v_map, &bar.loaded[r],
                         cur.tile * BK, cur.bh);
    if (++cur.tile == n_t) cur.next_item(stride, blocks);
  };

  if (tid == 0) {
    for (int x = 0; x < NS; ++x)
      Barriers(smem + P::kBarOffset + x * barrier_bytes(ST), ST)
          .init(ST, P::kSplitters);
    mbar_init_fence();
  }
  __syncthreads();
  if (!splitter && lt == 0 && first < n_items) {
    load_own(first);
    for (int x = 0; x < ST; ++x) load_next(x);
  }

  if (splitter) {
    // Splitters: per item its Q, then each landed K/V tile.
    int g = 0;
    for (int it = first, k = 0; it < n_items; it += stride, ++k) {
      const int b = item_at(it, blocks).bh / H;
      mbar_wait(bar.own_loaded, k & 1);
      split_tile<DH, kTile, false, P::kSplitters>(q_s, q_s + OT, nullptr,
                                                  nullptr, lt);
      fence_proxy_async();
      mbar_arrive(bar.own_ready);
      for (int j = 0; j < n_t; ++j, ++g) {
        const int r = g % ST;
        // The mask is read before the wait, so its latency overlaps it.
        const float kb =
            lt < BK ? key_bias(key_mask, b, S, j * BK + lt) * kLog2e : 0.f;
        mbar_wait(&bar.loaded[r], g / ST & 1);
        unsigned char* st = stage(r);
        unsigned char* vt = st + 3 * Kv::kBytes;
        split_tile<DH, BK, false, P::kSplitters>(st, st + Kv::kBytes, nullptr,
                                                 nullptr, lt);
        split_tile<DH, BK, true, P::kSplitters, false>(
            st + 2 * Kv::kBytes, nullptr, vt, vt + Vt::kBytes, lt);
        if (lt < BK) bias_v[r * BK + lt] = kb;
        fence_proxy_async();
        mbar_arrive(&bar.full[r]);
      }
    }
    return;
  }

  // Consumers.  Thread 32 w + 4 g + t of its warpgroup holds rows 16 w + g
  // and 16 w + g + 8 of the item's 64: sc[4 jj + e] is row 16 w + g +
  // 8 (e >> 1), key 8 jj + 2 t + (e & 1) of the tile.
  const int w = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const uint32_t q_addr = shared_addr(q_s);
  constexpr int kFrags = P::kOwnInRegs ? DH / 8 : 1;
  uint32_t q_hi[kFrags][4], q_lo[kFrags][4];
  const Turns<NS> turns{sid};
  turns.open();
  int gt = 0;  // the stream's tiles consumed
  for (int it = first, k = 0; it < n_items; it += stride, ++k) {
    const Item item = item_at(it, blocks);
    const int q0 = item.row0;
    const size_t head = static_cast<size_t>(item.bh) * S;  // row (b, h, 0)

    mbar_wait(bar.own_ready, k & 1);
    if constexpr (P::kOwnInRegs) {
      // Q lives in registers from here: its tile takes the next item's.
      load_own_frags<DH>(q_hi, q_lo, q_s, q_s + OT, w, g, t);
      named_sync(1 + sid, kWarpgroup);
      if (lt == 0 && it + stride < n_items) load_own(it + stride);
    }

    float m2[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
    float l[2] = {0.f, 0.f};  // the lane's share of the row sums
    float acc[DH / 2] = {};   // O, unnormalised
    for (int j = 0; j < n_t; ++j, ++gt) {
      const int r = gt % ST;
      mbar_wait(&bar.full[r], gt / ST & 1);
      const uint32_t k_addr = shared_addr(stage(r));
      const uint32_t vt_addr = k_addr + 3 * Kv::kBytes;
      const float* bias_s = bias_v + r * BK;

      float sc[BK / 2];
      fence_regs(sc);
      turns.take();
      wgmma_fence();
      score_product<DH, BK, P::kOwnInRegs>(sc, q_hi, q_lo, q_addr,
                                           q_addr + OT, k_addr,
                                           k_addr + Kv::kBytes);
      wgmma_commit();
      turns.give();
      wgmma_wait<0>();
      fence_regs(sc);

      // x = s scale log2 e + bias log2 e.  A tile of real keys wholly
      // inside the causal band needs no per-score checks; elsewhere keys
      // past S get -inf (p = 0) and replaced scores -1e9 log2 e.
      const int k0 = j * BK;
      const int n_keys = min(BK, S - k0);
      const bool interior = n_keys == BK && !(CAUSAL && k0 + BK - 1 > q0);
      if (interior) {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          const float2 bl =
              *reinterpret_cast<const float2*>(bias_s + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * jj + e] =
                fmaf(sc[4 * jj + e], scale_log2, e & 1 ? bl.y : bl.x);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          const float2 bl =
              *reinterpret_cast<const float2*>(bias_s + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = 8 * jj + 2 * t + (e & 1);
            const int row = q0 + 16 * w + g + 8 * (e >> 1);
            const bool replaced = CAUSAL && k0 + kj > row;
            const float x = replaced ? kMaskedLog2
                                     : fmaf(sc[4 * jj + e], scale_log2,
                                            e & 1 ? bl.y : bl.x);
            sc[4 * jj + e] = kj < n_keys ? x : -CUDART_INF_F;
          }
        }
      }

      // Online softmax.  The first tile holds key 0, so every row's max is
      // finite after it; alpha is 0 on the first tile.  A row's scores go
      // through two chains each for the max and the sum.
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx[2];
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = sc[4 * jj + 2 * hh + c];
            mx[c] = jj == 0 ? x : fmaxf(mx[c], x);
          }
        }
        float x = fmaxf(mx[0], mx[1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        x = fmaxf(m2[hh], x);
        alpha[hh] = exp2_approx(m2[hh] - x);
        m2[hh] = x;
      }
      float ps[2][2];
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(sc[4 * jj + e] - m2[e >> 1]);
          sc[4 * jj + e] = p;
          float& sum = ps[e >> 1][e & 1];
          sum = jj == 0 ? p : sum + p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] = l[hh] * alpha[hh] + (ps[hh][0] + ps[hh][1]);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
      }

      // O += P V: P from the accumulators, V transposed (V^T hi, lo), in
      // products of 32 keys.
      constexpr int KH = pv_keys(BK);
#pragma unroll
      for (int h = 0; h < BK / KH; ++h) {
        uint32_t a_hi[KH / 8][4], a_lo[KH / 8][4];
        acc_frags<KH>(a_hi, a_lo, sc, h * KH / 8);
        second_product<DH, KH, BK>(acc, a_hi, a_lo, vt_addr,
                                   vt_addr + Vt::kBytes, h * KH / 8);
      }
      // Stage r is consumed (every product reading it has completed, every
      // thread has read its biases): it takes the stream's next tile.
      named_sync(1 + sid, kWarpgroup);
      if (lt == 0) load_next(r);
    }
    if constexpr (!P::kOwnInRegs) {
      // The products read Q from its tile up to here.
      if (lt == 0 && it + stride < n_items) load_own(it + stride);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + 16 * w + g + 8 * hh;
      if (row >= S) continue;
      const float inv = 1.f / sum;
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c < ld)
          *reinterpret_cast<float2*>(o + (head + row) * ld + c) =
              make_float2(acc[4 * jj + 2 * hh] * inv,
                          acc[4 * jj + 2 * hh + 1] * inv);
      }
      if (t == 0) {
        const float mn = m2[hh] * kLn2;
        lse[head + row] = mn + logf(sum);
        row_max[head + row] = mn;
        row_sum[head + row] = sum;
      }
    }
  }
  turns.close([&](int x) {
    return n_t * stream_items(blockIdx.x * NS + x, stride, n_items);
  });
}

template <int DH, int NS, bool CAUSAL>
cudaError_t launch_streams(const CUtensorMap (&maps)[3],
                           const uint8_t* key_mask, float* o, float* lse,
                           float* row_max, float* row_sum, int H, int S,
                           int Dh, int ld, int items, cudaStream_t stream) {
  using P = FwdPlan<DH, NS>;
  static const cudaError_t attr =
      set_smem(flash_fwd_kernel<DH, NS, CAUSAL>, P::kBytes);
  if (attr != cudaSuccess) return attr;
  const int grid = min(sm_count(), (items + NS - 1) / NS);
  // The backward's c1: the same x from the same scores.
  const float scale_log2 = softmax_scale(Dh, kLog2e);
  flash_fwd_kernel<DH, NS, CAUSAL><<<grid, threads(NS), P::kBytes, stream>>>(
      maps[0], maps[1], maps[2], key_mask, o, lse, row_max, row_sum, H, S,
      ld, scale_log2, items);
  return cudaGetLastError();
}

// The launch on tiles DH wide of tensors ld wide (head dim Dh).
template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const uint8_t* key_mask, float* o, float* lse,
                   float* row_max, float* row_sum, int B, int H, int S,
                   int Dh, int ld, int causal, cudaStream_t stream) {
  constexpr int kKeys = fwd_keys(DH);
  constexpr int NS = kMaxFwdStreams<DH>;
  CUtensorMap maps[3];
  const int BH = B * H;
  cudaError_t err = f32_rows_map<DH, kTile>(&maps[0], q, BH, S, ld);
  if (err == cudaSuccess) err = f32_rows_map<DH, kKeys>(&maps[1], k, BH, S, ld);
  if (err == cudaSuccess) err = f32_rows_map<DH, kKeys>(&maps[2], v, BH, S, ld);
  if (err != cudaSuccess) return err;
  const int items = B * H * ((S + kTile - 1) / kTile);
  const bool two = streams_for(items, NS) == 2;
#define FLEXDM_FWD(ns, c)                                                   \
  launch_streams<DH, ns, c>(maps, key_mask, o, lse, row_max, row_sum, H, S, \
                            Dh, ld, items, stream)
  if (causal) return two ? FLEXDM_FWD(NS, true) : FLEXDM_FWD(1, true);
  return two ? FLEXDM_FWD(NS, false) : FLEXDM_FWD(1, false);
#undef FLEXDM_FWD
}

}  // namespace

// q, k, v, o: (B, H, S, ld) float32, contiguous, 16-byte aligned, ld = Dh
// rounded up to a multiple of 4 (16 bytes) with columns Dh .. ld - 1 of q,
// k and v zero (a padded copy; hopper.cuh, "Head dims"); 1 <= Dh <= 128.
// key_mask: (B, S) bool (one byte per key, nonzero = attend) or null for
// "all keys valid".  lse, row_max, row_sum: (B, H, S) float32.  Returns the
// cudaError_t of the launch (cudaErrorNotSupported if the CUDA driver
// cannot encode tensor maps).
extern "C" int flexdm_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* key_mask,
                                          void* o, void* lse, void* row_max,
                                          void* row_sum, int B, int H, int S,
                                          int Dh, int causal, void* stream) {
  if (bad_shape(B, H, S) || bad_head_dim(Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = row_width(Dh, 4);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* mf = static_cast<float*>(row_max);
  auto* sf = static_cast<float*>(row_sum);
  auto st = static_cast<cudaStream_t>(stream);
#define FLEXDM_FWD_W(w)                                                   \
  launch<w>(qf, kf, vf, mask, of, lf, mf, sf, B, H, S, Dh, ld, causal, st)
  const int width = tile_width(ld);
  return static_cast<int>(width == 32   ? FLEXDM_FWD_W(32)
                          : width == 64 ? FLEXDM_FWD_W(64)
                                        : FLEXDM_FWD_W(128));
#undef FLEXDM_FWD_W
}
