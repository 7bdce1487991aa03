// Flash-attention backward for Hopper (sm_90a), float32 in and out, every
// product a warpgroup wgmma on the TF32 tensor cores with each operand split
// into two TF32 terms, over tiles that TMA brings in.
//
// Replaces the TPU kernels of flexdm_tpu/ops/attention.py:
//   * _flash_bwd_dq_kernel (:116-153; pallas_call :383) and
//     _flash_bwd_dq_stream_kernel (:217-251; :451) -> the dq kernel here,
//     which also computes delta = rowsum(dO * O) (the XLA glue of
//     _attention_pallas_bwd) for its rows and writes it for the dkv kernel;
//   * _flash_bwd_dkv_kernel (:156-206; :407) and
//     _flash_bwd_dkv_stream_kernel (:254-293; :475) -> the dkv kernel here.
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
// summed in another order than the forward's, so p is the forward's p to
// ~1e-6 relative, not bit for bit.
//
// Arithmetic.  Every product (q k^T, dO v^T, ds k, ds^T q, p^T dO) is
// wgmma.mma_async m64nNk8 with TF32 operands and float32 accumulators, each
// operand split once into hi = tf32(x) and lo = x - hi and a b computed as
// lo hi' + hi lo' + hi hi' (wgmma_tf32.cuh).  A single TF32 pass keeps ~3
// decimal digits and misses the 1e-4 gate of the card checks by 10x
// (tests/test_torch_attention_backward.py emulates both;
// tests/test_torch_attention_tf32_wgmma.py emulates this kernel's split on
// its own tile layouts).  The tensor cores' float32 sums are not rounded to
// nearest (each wgmma's sum is cut toward zero): chained over every tile of
// the other axis they would bias dq, dk and dv, and the key bias's gradient
// (0 in exact arithmetic: the rows of ds sum to 0) would gather that bias.
// So each tile's ds k, ds^T q and p^T dO is summed from zero on the tensor
// cores (12 wgmmas at most) and added to the running sums in float32, and
// every product takes the small terms (lo hi', hi lo') of all its k8 steps
// before the large ones (hi hi'), whose cuts are then the only ones at the
// sum's full size.  With each step's three terms in turn, the crello
// Ours-EXP step's key-bias gradient differed from the CPU's by 1.5e-5 on
// the card, over the 1e-5 of chip_smoke.py's step-parity gate; in this
// order the gate holds.  p is one ex2 of scores in log2 units
// (2^(s log2 e - m log2 e) / l): a masked or replaced score is -1e9 log2 e,
// the same float as a fully masked row's m log2 e, so that row keeps 1/l.
//
// What bounded the previous design (mma.sync.m16n8k8, cp.async, 8 warps a
// block): issue.  The split took four integer or float32 instructions per
// operand value, every warp split every fragment it loaded (the B fragments
// of a tile once per row group, the block's own Q/dO or K/V again for every
// tile), and the k-step add took four FADDs per three MMAs: about five
// instructions beside every MMA, ~110 TFLOP/s of MMA work, a fifth of the
// TF32 peak, at (1, 2, 4096, 64); 11-15x the bound at (64, 8, 500, 32).  At
// (256, 8, 50, 32) registers (125-143) held it to 2 blocks an SM: latency.
//
// What bounds this one.  The split triples the tensor work: at (64, 8, 500,
// 32) 74 (dq) and 98 (dk/dv) GFLOP of TF32 products, 0.149 and 0.199 ms at
// the 495 TFLOP/s peak; at (1, 2, 4096, 64) 39 and 52 GFLOP.  Beside them
// the SM issues, per tile and stream, the exponentials, masks and ds of
// 64 x 32 scores, the split of p and ds into A fragments (three
// instructions a value) and the float32 adds, and the splitters' pass over
// the tile; where the score products read both operands from shared memory
// (SS: dk/dv, dq at Dh >= 64) an m64n32k8 reads 3 KB for 17 clocks of
// tensor work, above the 128 bytes a clock shared memory gives.  No one of
// the tensor cores, the issue slots or shared memory is saturated alone:
// each tile is a chain (copy, split, products, p, ds, products) that the
// other stream's tile overlaps.
//
// Design.
//   * Instances are tile widths DH = 32, 64 and 128 ("Dh = 32" below names
//     the instance); the head dim is a runtime value from 1 to 128, run on
//     the smallest width that holds its row, zero-filled by TMA, its scale
//     1/sqrt(Dh), its delta summed and its stores made over its own columns
//     (hopper.cuh, "Head dims").
//   * An item is 64 query rows (dq) or 64 keys (dk/dv) of one head: the
//     wgmma M.  A block, one an SM, runs one or two streams, each a
//     consumer warpgroup taking the items first, first + stride, ... of the
//     launch (persistent: the grid is the SMs), and one splitter warpgroup
//     whose halves serve the streams.  Two streams where there are more
//     items than SMs and two streams' tiles fit (dq at Dh <= 64, dk/dv at
//     Dh = 32), else one: 384 or 256 threads, so at most 168 or 255
//     registers.  (setmaxnreg did not raise ptxas's allocation over the
//     launch bound: two 256-thread blocks an SM gave every thread 128
//     registers and serialised, spilling products.)
//   * The other axis comes in tiles of 32 keys (dq) or Q/dO rows (dk/dv),
//     16 at Dh = 128: the N of the score products.  TMA copies each tile
//     (tensor maps over (B H, S, Dh) views, __grid_constant__; rows past S
//     arrive as zeros, never as the next head's) into a stage of the
//     stream's ring; the splitters write hi over it in place, lo beside it,
//     and the transposed hi and lo of K (dq) or of Q and dO (dk/dv) that
//     ds k, ds^T q and p^T dO read (TF32 wgmma reads both operands K-major
//     only), the rows in the k order of the accumulator-made A operand
//     (acc_order), in 16-byte stores; then the row vectors (dq: key bias;
//     dk/dv: m, 1/l, delta, by threads: rows of (B, H, S) are not 16-byte
//     aligned for a tensor map at S = 50).  Per stage a TMA mbarrier and a
//     full mbarrier (the splitters' arrivals, after a proxy fence).  The
//     consumer's thread 0 refills the stage its warpgroup has just emptied
//     (after the warpgroup's named barrier) with the stream's next tile,
//     across items, so the next item's tiles land and split while this one
//     ends.  An item's own tiles (Q, dO or K, V) land once and are split
//     once; dq at Dh = 32 holds their hi and lo as register A fragments (RS
//     score products; the next item's own tiles load as soon as they are
//     read), else they stay in shared memory (SS) until the item ends.
//   * Two streams take turns issuing their score products (Turns), so one
//     stream's products run while the other forms p and ds.
//   * dq: s = q k^T and dp = dO v^T, p formed while dp is on the tensor
//     cores, ds, then ds k from ds's accumulators (no data moved) into a
//     temporary set, added to dq.  dk/dv: s^T = k q^T and dp^T = v dO^T, so
//     p^T and ds^T arrive with keys as rows; then p^T dO and ds^T q, one
//     after the other.  Second products go in chunks of 32 columns.
//   * dk/dv forms p and ds without branches: a branch around the values
//     that feed its next products made ptxas serialise every wgmma of the
//     kernel (C7520), where dq's last write before its product is a
//     select.  dq keeps its fast path for tiles wholly inside S and the
//     causal band.  causal is a template parameter, so non-causal launches
//     carry no band checks.
//   * Ring stages a stream (ring_stages, shared memory): dq 3 / 1 / 2 at
//     Dh 32 / 64 / 128 with two streams, 4 / 3 / 2 with one; dk/dv 2 with
//     two streams, 4 / 2 / 1 with one.
//   * Every dq, dk and dv element is summed by one thread in a fixed order:
//     no atomics, a second call is bitwise equal.
//   * Causal dq stops at the item's last row: later keys are replaced for
//     every row of the item, so their ds is exactly 0.  dk/dv visits every
//     tile: a fully masked row's p = 1/S reaches dv through replaced keys.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

// Streams (consumer warpgroups) a block can run: two where two streams'
// tiles fit in shared memory (dq at Dh <= 64, dk/dv at Dh = 32).
template <int DH>
constexpr int kMaxDqStreams = DH == 128 ? 1 : 2;
template <int DH>
constexpr int kMaxDkvStreams = DH == 32 ? 2 : 1;

// ---------------------------------------------------------------------------
// dq (and delta).  An item is 64 query rows of one head.  Per K/V tile:
// s = q k^T and dp = dO v^T, ds in registers, then dq += ds k.
// ---------------------------------------------------------------------------

template <int DH, int NS>
struct DqPlan {
  static constexpr int kKeys = other_rows(DH);  // keys per K/V tile
  static constexpr int kStreams = NS;
  static constexpr int kSplitters = kWarpgroup / kStreams;  // per stream
  static constexpr bool kOwnInRegs = DH == 32;  // Q, dO fragments
  using Own = F32Tile<DH, kTile>;               // Q, Q lo, dO, dO lo
  using Kv = F32Tile<DH, kKeys>;                // K, K lo, V, V lo
  using Kt = TransposedTile<DH, kKeys>;         // K^T hi, lo
  static constexpr int kOwnBytes = 4 * Own::kBytes;
  static constexpr int kStageBytes = 4 * Kv::kBytes + 2 * Kt::kBytes;
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

// K/V tiles of a dq item (causal: up to the item's last row).
__device__ __forceinline__ int dq_tiles(int q0, int S, int causal, int bk) {
  const int n = (S + bk - 1) / bk;
  return causal ? min(n, (min(q0 + kTile, S) + bk - 1) / bk) : n;
}

template <int DH, int NS, bool CAUSAL>
__global__ void __launch_bounds__(threads(NS), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const uint8_t* __restrict__ key_mask,
                    const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ row_max,
                    const float* __restrict__ row_sum,
                    float* __restrict__ delta, float* __restrict__ dq, int H,
                    int S, int ld, float scale, int n_items) {
  using P = DqPlan<DH, NS>;
  constexpr bool causal = CAUSAL;
  using Kv = typename P::Kv;
  using Kt = typename P::Kt;
  constexpr int BK = P::kKeys;
  constexpr int ST = P::kStages;
  constexpr int OT = P::Own::kBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool splitter = warp >= 4 * NS;
  // The thread's stream, and its index among the stream's threads.
  const int sid = splitter ? (tid - 4 * NS * 32) / P::kSplitters : warp / 4;
  const int lt = splitter ? (tid - 4 * NS * 32) % P::kSplitters : tid % 128;
  // The stream's own tiles (Q, Q lo, dO, dO lo), ring, key biases, barriers.
  unsigned char* q_s = smem + sid * P::kStreamBytes;
  unsigned char* do_s = q_s + 2 * OT;
  auto stage = [&](int r) { return q_s + P::kOwnBytes + r * P::kStageBytes; };
  float* bias_v = reinterpret_cast<float*>(smem + P::kVecOffset) + sid * ST * BK;
  Barriers bar(smem + P::kBarOffset + sid * barrier_bytes(ST), ST);

  const int blocks = (S + kTile - 1) / kTile;  // query blocks of a head
  const int stride = gridDim.x * NS;
  const int first = blockIdx.x * NS + sid;

  // Copies (by the consumers' thread 0): an item's Q and dO, and the tile
  // at the cursor into the next stage of the ring.
  auto load_own = [&](int it) {
    const Item item = item_at(it, blocks);
    mbar_arrive_expect_tx(bar.own_loaded, 2 * OT);
    tma_f32_tile<DH, kTile>(q_s, &q_map, bar.own_loaded, item.row0, item.bh);
    tma_f32_tile<DH, kTile>(do_s, &do_map, bar.own_loaded, item.row0, item.bh);
  };
  // Stage r: each copy goes to the stage just emptied (tile g + ST to
  // tile g's).
  Cursor cur(first, blocks);
  auto load_next = [&](int r) {
    if (cur.item >= n_items) return;
    mbar_arrive_expect_tx(&bar.loaded[r], 2 * Kv::kBytes);
    tma_f32_tile<DH, BK>(stage(r), &k_map, &bar.loaded[r], cur.tile * BK,
                         cur.bh);
    tma_f32_tile<DH, BK>(stage(r) + 2 * Kv::kBytes, &v_map, &bar.loaded[r],
                         cur.tile * BK, cur.bh);
    if (++cur.tile == dq_tiles(cur.row0, S, causal, BK))
      cur.next_item(stride, blocks);
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
    // Splitters: per item its Q and dO, then each landed K/V tile.
    int g = 0;
    for (int it = first, k = 0; it < n_items; it += stride, ++k) {
      const Item item = item_at(it, blocks);
      const int b = item.bh / H;
      mbar_wait(bar.own_loaded, k & 1);
      split_tile<DH, kTile, false, P::kSplitters>(q_s, q_s + OT, nullptr,
                                                  nullptr, lt);
      split_tile<DH, kTile, false, P::kSplitters>(do_s, do_s + OT, nullptr,
                                                  nullptr, lt);
      fence_proxy_async();
      mbar_arrive(bar.own_ready);
      const int n_t = dq_tiles(item.row0, S, causal, BK);
      for (int j = 0; j < n_t; ++j, ++g) {
        const int r = g % ST;
        // The mask is read before the wait, so its latency overlaps it.
        const float kb =
            lt < BK ? key_bias(key_mask, b, S, j * BK + lt) * kLog2e : 0.f;
        mbar_wait(&bar.loaded[r], g / ST & 1);
        unsigned char* st = stage(r);
        unsigned char* kt = st + 4 * Kv::kBytes;
        split_tile<DH, BK, true, P::kSplitters>(st, st + Kv::kBytes, kt,
                                                kt + Kt::kBytes, lt);
        split_tile<DH, BK, false, P::kSplitters>(
            st + 2 * Kv::kBytes, st + 3 * Kv::kBytes, nullptr, nullptr, lt);
        if (lt < BK) bias_v[r * BK + lt] = kb;
        fence_proxy_async();
        mbar_arrive(&bar.full[r]);
      }
    }
    return;
  }

  // Consumers.  Thread 32 w + 4 g + t of its warpgroup holds rows 16 w + g
  // and 16 w + g + 8 of the item's 64.
  const int w = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c1 = scale * kLog2e;  // scores in log2 units
  const uint32_t q_addr = shared_addr(q_s);
  const uint32_t do_addr = shared_addr(do_s);
  constexpr int kFrags = P::kOwnInRegs ? DH / 8 : 1;
  uint32_t q_hi[kFrags][4], q_lo[kFrags][4], d_hi[kFrags][4], d_lo[kFrags][4];
  const Turns<NS> turns{sid};
  turns.open();
  int gt = 0;  // the stream's tiles consumed
  for (int it = first, k = 0; it < n_items; it += stride, ++k) {
    const Item item = item_at(it, blocks);
    const int q0 = item.row0;
    const size_t head = static_cast<size_t>(item.bh) * S;  // row (b, h, 0)
    // Row statistics (m in log2 units); delta in float32 from the O and dO
    // rows.  A row past S gets inv_l = 0, so its p and ds are 0.
    float m2[2], inv_l[2], dlt[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * w + g + 8 * hh;
      const bool real = row < S;
      float part_sum = 0.f;
      if (real) {
        const float* o_row = o + (head + row) * ld;
        const float* d_row = dout + (head + row) * ld;
#pragma unroll
        for (int c = 4 * t; c < DH; c += 16) {
          if (c >= ld) break;
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
      m2[hh] = real ? row_max[head + row] * kLog2e : 0.f;
      inv_l[hh] = real ? 1.f / row_sum[head + row] : 0.f;
      if (real && t == 0) delta[head + row] = part_sum;
    }

    mbar_wait(bar.own_ready, k & 1);
    if constexpr (P::kOwnInRegs) {
      // Q and dO live in registers from here: their tiles take the next
      // item's.
      load_own_frags<DH>(q_hi, q_lo, q_s, q_s + OT, w, g, t);
      load_own_frags<DH>(d_hi, d_lo, do_s, do_s + OT, w, g, t);
      named_sync(1 + sid, kWarpgroup);
      if (lt == 0 && it + stride < n_items) load_own(it + stride);
    }

    float acc[DH / 2] = {};  // dq of the item's rows, unscaled
    const int n_t = dq_tiles(q0, S, causal, BK);
    for (int j = 0; j < n_t; ++j, ++gt) {
      const int r = gt % ST;
      mbar_wait(&bar.full[r], gt / ST & 1);
      const uint32_t k_addr = shared_addr(stage(r));
      const uint32_t v_addr = k_addr + 2 * Kv::kBytes;
      const uint32_t kt_addr = k_addr + 4 * Kv::kBytes;
      const float* bias_s = bias_v + r * BK;

      float sc[BK / 2], dp[BK / 2];
      fence_regs(sc);
      fence_regs(dp);
      turns.take();
      wgmma_fence();
      score_product<DH, BK, P::kOwnInRegs>(sc, q_hi, q_lo, q_addr,
                                           q_addr + OT, k_addr,
                                           k_addr + Kv::kBytes);
      wgmma_commit();
      score_product<DH, BK, P::kOwnInRegs>(dp, d_hi, d_lo, do_addr,
                                           do_addr + OT, v_addr,
                                           v_addr + Kv::kBytes);
      wgmma_commit();
      turns.give();

      // p from s while dp is still on the tensor cores, then ds.  A tile of
      // real keys wholly inside the causal band (every tile but the last
      // when not causal) needs no per-score checks.
      const int k0 = j * BK;
      const int n_keys = min(BK, S - k0);
      const bool interior = n_keys == BK && !(causal && k0 + BK - 1 > q0);
      wgmma_wait<1>();
      fence_regs(sc);
      if (interior) {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          const float2 bl =
              *reinterpret_cast<const float2*>(bias_s + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * jj + e] =
                exp2_approx(fmaf(sc[4 * jj + e], c1, e & 1 ? bl.y : bl.x) -
                            m2[e >> 1]) *
                inv_l[e >> 1];
        }
      } else {
        // Keys past S get p = 0 (their zero-filled scores keep the
        // exponential finite), replaced scores -1e9 log2 e.
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          const float2 bl =
              *reinterpret_cast<const float2*>(bias_s + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = 8 * jj + 2 * t + (e & 1);
            const int row = q0 + 16 * w + g + 8 * (e >> 1);
            const bool replaced = causal & (k0 + kj > row);
            const float x = replaced ? kMaskedLog2
                                     : fmaf(sc[4 * jj + e], c1,
                                            e & 1 ? bl.y : bl.x);
            const float p = exp2_approx(x - m2[e >> 1]) * inv_l[e >> 1];
            sc[4 * jj + e] = kj < n_keys ? p : 0.f;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // ds (0 where the causal band replaced s; p is 0 past S).
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * jj + 2 * t + (e & 1);
          const int row = q0 + 16 * w + g + 8 * (e >> 1);
          const bool replaced = causal & (k0 + kj > row);
          sc[4 * jj + e] =
              replaced ? 0.f
                       : sc[4 * jj + e] * (dp[4 * jj + e] - dlt[e >> 1]);
        }
      }
      // dq += ds k: ds from the accumulators, k transposed (K^T hi, lo).
      uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
      acc_frags<BK>(a_hi, a_lo, sc);
      second_product<DH, BK>(acc, a_hi, a_lo, kt_addr, kt_addr + Kt::kBytes);
      // Stage r is consumed (every product reading it has completed, every
      // thread has read its biases): it takes the stream's next tile.
      named_sync(1 + sid, kWarpgroup);
      if (lt == 0) load_next(r);
    }
    if constexpr (!P::kOwnInRegs) {
      // The products read Q and dO from their tiles up to here.
      if (lt == 0 && it + stride < n_items) load_own(it + stride);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * w + g + 8 * hh;
      if (row >= S) continue;
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c < ld)
          *reinterpret_cast<float2*>(dq + (head + row) * ld + c) =
              make_float2(acc[4 * jj + 2 * hh] * scale,
                          acc[4 * jj + 2 * hh + 1] * scale);
      }
    }
  }
  turns.close([&](int x) {
    int n = 0;  // causal items differ in length
    for (int it = blockIdx.x * NS + x; it < n_items; it += stride)
      n += dq_tiles(item_at(it, blocks).row0, S, causal, BK);
    return n;
  });
}

// ---------------------------------------------------------------------------
// dk, dv.  An item is 64 keys of one head.  Per Q/dO tile: s^T = k q^T and
// dp^T = v dO^T, p^T and ds^T in registers, then dv += p^T dO and
// dk += ds^T q.
// ---------------------------------------------------------------------------

template <int DH, int NS>
struct DkvPlan {
  static constexpr int kRows = other_rows(DH);  // rows per Q/dO tile
  static constexpr int kStreams = NS;
  static constexpr int kSplitters = kWarpgroup / kStreams;
  using Own = F32Tile<DH, kTile>;        // K, K lo, V, V lo
  using Qt = F32Tile<DH, kRows>;         // Q, Q lo, dO, dO lo
  using Tt = TransposedTile<DH, kRows>;  // Q^T, dO^T hi and lo
  static constexpr int kOwnBytes = 4 * Own::kBytes;
  static constexpr int kStageBytes = 4 * Qt::kBytes + 4 * Tt::kBytes;
  static constexpr int kStages =
      ring_stages(NS, kOwnBytes, kStageBytes, 3 * kRows * 4);
  static_assert(kStages >= 1, "a stage fits");
  static constexpr int kStreamBytes = kOwnBytes + kStages * kStageBytes;
  // The streams' tiles, their stages' m (log2 units), 1/l and delta, then
  // their barriers.
  static constexpr int kVecOffset = kStreams * kStreamBytes;
  static constexpr int kBarOffset =
      kVecOffset + kStreams * kStages * 3 * kRows * 4;
  static constexpr int kBytes =
      1024 + kBarOffset + kStreams * barrier_bytes(kStages);
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

template <int DH, int NS, bool CAUSAL>
__global__ void __launch_bounds__(threads(NS), 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const uint8_t* __restrict__ key_mask,
                     const float* __restrict__ row_max,
                     const float* __restrict__ row_sum,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int S, int ld,
                     float scale, int n_items) {
  using P = DkvPlan<DH, NS>;
  constexpr bool causal = CAUSAL;
  using Qt = typename P::Qt;
  using Tt = typename P::Tt;
  constexpr int BQ = P::kRows;
  constexpr int ST = P::kStages;
  constexpr int OT = P::Own::kBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool splitter = warp >= 4 * NS;
  const int sid = splitter ? (tid - 4 * NS * 32) / P::kSplitters : warp / 4;
  const int lt = splitter ? (tid - 4 * NS * 32) % P::kSplitters : tid % 128;
  // The stream's own tiles (K, K lo, V, V lo), ring, row statistics,
  // barriers.
  unsigned char* k_s = smem + sid * P::kStreamBytes;
  unsigned char* v_s = k_s + 2 * OT;
  auto stage = [&](int r) { return k_s + P::kOwnBytes + r * P::kStageBytes; };
  float* stats_v =
      reinterpret_cast<float*>(smem + P::kVecOffset) + sid * ST * 3 * BQ;
  Barriers bar(smem + P::kBarOffset + sid * barrier_bytes(ST), ST);

  const int blocks = (S + kTile - 1) / kTile;  // key blocks of a head
  const int n_t = (S + BQ - 1) / BQ;          // Q/dO tiles of an item
  const int stride = gridDim.x * NS;
  const int first = blockIdx.x * NS + sid;

  auto load_own = [&](int it) {
    const Item item = item_at(it, blocks);
    mbar_arrive_expect_tx(bar.own_loaded, 2 * OT);
    tma_f32_tile<DH, kTile>(k_s, &k_map, bar.own_loaded, item.row0, item.bh);
    tma_f32_tile<DH, kTile>(v_s, &v_map, bar.own_loaded, item.row0, item.bh);
  };
  Cursor cur(first, blocks);
  auto load_next = [&](int r) {
    if (cur.item >= n_items) return;
    mbar_arrive_expect_tx(&bar.loaded[r], 2 * Qt::kBytes);
    tma_f32_tile<DH, BQ>(stage(r), &q_map, &bar.loaded[r], cur.tile * BQ,
                         cur.bh);
    tma_f32_tile<DH, BQ>(stage(r) + 2 * Qt::kBytes, &do_map, &bar.loaded[r],
                         cur.tile * BQ, cur.bh);
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
    // Splitters: per item its K and V, then each landed Q/dO tile and its
    // rows' statistics.
    int g = 0;
    for (int it = first, k = 0; it < n_items; it += stride, ++k) {
      const size_t head = static_cast<size_t>(item_at(it, blocks).bh) * S;
      mbar_wait(bar.own_loaded, k & 1);
      split_tile<DH, kTile, false, P::kSplitters>(k_s, k_s + OT, nullptr,
                                                  nullptr, lt);
      split_tile<DH, kTile, false, P::kSplitters>(v_s, v_s + OT, nullptr,
                                                  nullptr, lt);
      fence_proxy_async();
      mbar_arrive(bar.own_ready);
      for (int j = 0; j < n_t; ++j, ++g) {
        const int r = g % ST;
        // The statistics are read before the wait, so their latency
        // overlaps it.
        const int row = j * BQ + lt;
        const bool real = lt < BQ && row < S;
        const float mx = real ? row_max[head + row] * kLog2e : 0.f;
        const float il = real ? 1.f / row_sum[head + row] : 0.f;
        const float dl = real ? delta[head + row] : 0.f;
        mbar_wait(&bar.loaded[r], g / ST & 1);
        unsigned char* st = stage(r);
        unsigned char* tq = st + 4 * Qt::kBytes;
        unsigned char* tdo = tq + 2 * Tt::kBytes;
        split_tile<DH, BQ, true, P::kSplitters>(st, st + Qt::kBytes, tq,
                                                tq + Tt::kBytes, lt);
        split_tile<DH, BQ, true, P::kSplitters>(st + 2 * Qt::kBytes,
                                                st + 3 * Qt::kBytes, tdo,
                                                tdo + Tt::kBytes, lt);
        if (lt < BQ) {
          float* stats = stats_v + r * 3 * BQ;
          stats[lt] = mx;
          stats[BQ + lt] = il;
          stats[2 * BQ + lt] = dl;
        }
        fence_proxy_async();
        mbar_arrive(&bar.full[r]);
      }
    }
    return;
  }

  // Consumers.  Thread 32 w + 4 g + t of its warpgroup holds keys 16 w + g
  // and 16 w + g + 8 of the item's 64.
  const int w = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c1 = scale * kLog2e;  // scores in log2 units
  const uint32_t k_addr = shared_addr(k_s);
  const uint32_t v_addr = shared_addr(v_s);
  // K and V stay in shared memory (SS score products): their register
  // fragments beside dk's and dv's sums would take ~200 registers of 168.
  uint32_t no_frags[1][4];
  const Turns<NS> turns{sid};
  turns.open();
  int gt = 0;  // the stream's tiles consumed
  for (int it = first, k = 0; it < n_items; it += stride, ++k) {
    const Item item = item_at(it, blocks);
    const int k0 = item.row0;
    const int b = item.bh / H;
    const size_t head = static_cast<size_t>(item.bh) * S;
    bool kreal[2];
    float kbias[2];  // log2 units
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + 16 * w + g + 8 * hh;
      kreal[hh] = key < S;
      kbias[hh] = key_bias(key_mask, b, S, key) * kLog2e;
    }

    mbar_wait(bar.own_ready, k & 1);

    // dk (unscaled) and dv of the item's keys.
    float acc_dk[DH / 2] = {}, acc_dv[DH / 2] = {};
    for (int j = 0; j < n_t; ++j, ++gt) {
      const int r = gt % ST;
      mbar_wait(&bar.full[r], gt / ST & 1);
      const uint32_t q_addr = shared_addr(stage(r));
      const uint32_t do_addr = q_addr + 2 * Qt::kBytes;
      const uint32_t tq_addr = q_addr + 4 * Qt::kBytes;
      const uint32_t tdo_addr = tq_addr + 2 * Tt::kBytes;
      // The rows' statistics into registers before the products are
      // issued: the SS products' operand reads keep shared memory busy, and
      // loads issued behind them took most of the time p takes.
      const float* m_s = stats_v + r * 3 * BQ;
      float2 mm[BQ / 8], il[BQ / 8], dd[BQ / 8];
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const int ri = 8 * jj + 2 * t;
        mm[jj] = *reinterpret_cast<const float2*>(m_s + ri);
        il[jj] = *reinterpret_cast<const float2*>(m_s + BQ + ri);
        dd[jj] = *reinterpret_cast<const float2*>(m_s + 2 * BQ + ri);
      }

      float sc[BQ / 2], dp[BQ / 2];
      fence_regs(sc);
      fence_regs(dp);
      // The descriptors are made per tile next to their wgmma: hoisted out
      // of the loop (K's and V's never change, nor Q's and dO's in a
      // one-stage ring), they took up to 128 registers and dk/dv at
      // Dh = 128 spilled.  (Not in dq: there the hoisting pays at Dh = 64
      // and costs no spill.)
      uint32_t ka = k_addr, va = v_addr, qa = q_addr, da = do_addr;
      asm volatile("" : "+r"(ka), "+r"(va), "+r"(qa), "+r"(da));
      turns.take();
      wgmma_fence();
      score_product<DH, BQ, false>(sc, no_frags, no_frags, ka, ka + OT, qa,
                                   qa + Qt::kBytes);
      wgmma_commit();
      score_product<DH, BQ, false>(dp, no_frags, no_frags, va, va + OT, da,
                                   da + Qt::kBytes);
      wgmma_commit();
      turns.give();

      // p^T from s^T while dp^T is still on the tensor cores, then ds^T.
      const int i0 = j * BQ;
      const int n_rows = min(BQ, S - i0);
      wgmma_wait<1>();
      fence_regs(sc);
      // Branch-free (bitwise conditions, selects): a branch around values
      // that feed the next products made ptxas serialise every wgmma of the
      // kernel (C7520).  Rows or keys past S have a score of 0 (zero-filled
      // tiles), so their exponential is finite before it is dropped.
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const int ri = 8 * jj + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const int key = k0 + 16 * w + g + 8 * (e >> 1);
          const bool replaced = causal & (key > i0 + ri + c);
          const float x =
              replaced ? kMaskedLog2 : fmaf(sc[4 * jj + e], c1, kbias[e >> 1]);
          const float p = exp2_approx(x - (c ? mm[jj].y : mm[jj].x)) *
                          (c ? il[jj].y : il[jj].x);
          sc[4 * jj + e] = (ri + c < n_rows) & kreal[e >> 1] ? p : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const int ri = 8 * jj + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const int key = k0 + 16 * w + g + 8 * (e >> 1);
          const bool replaced = causal & (key > i0 + ri + c);
          dp[4 * jj + e] =
              replaced ? 0.f
                       : sc[4 * jj + e] *
                             (dp[4 * jj + e] - (c ? dd[jj].y : dd[jj].x));
        }
      }
      // dv += p^T dO and dk += ds^T q (dO and q transposed), one after the
      // other, nothing formed while a product is in flight.
      {
        uint32_t a_hi[BQ / 8][4], a_lo[BQ / 8][4];
        acc_frags<BQ>(a_hi, a_lo, sc);
        second_product<DH, BQ>(acc_dv, a_hi, a_lo, tdo_addr,
                               tdo_addr + Tt::kBytes);
      }
      {
        uint32_t a_hi[BQ / 8][4], a_lo[BQ / 8][4];
        acc_frags<BQ>(a_hi, a_lo, dp);
        second_product<DH, BQ>(acc_dk, a_hi, a_lo, tq_addr,
                               tq_addr + Tt::kBytes);
      }
      // Stage r is consumed: it takes the stream's next tile.
      named_sync(1 + sid, kWarpgroup);
      if (lt == 0) load_next(r);
    }
    // The products read K and V from their tiles up to here (the last
    // tile's named barrier).
    if (lt == 0 && it + stride < n_items) load_own(it + stride);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!kreal[hh]) continue;
      const size_t key_row = head + k0 + 16 * w + g + 8 * hh;
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c >= ld) continue;
        *reinterpret_cast<float2*>(dk + key_row * ld + c) =
            make_float2(acc_dk[4 * jj + 2 * hh] * scale,
                        acc_dk[4 * jj + 2 * hh + 1] * scale);
        *reinterpret_cast<float2*>(dv + key_row * ld + c) =
            make_float2(acc_dv[4 * jj + 2 * hh], acc_dv[4 * jj + 2 * hh + 1]);
      }
    }
  }
  turns.close([&](int x) {
    return n_t * stream_items(blockIdx.x * NS + x, stride, n_items);
  });
}

template <int DH, int NS, bool CAUSAL>
cudaError_t launch_dq_streams(const CUtensorMap (&maps)[4],
                              const uint8_t* key_mask, const float* o,
                              const float* dout, const float* row_max,
                              const float* row_sum, float* delta, float* dq,
                              int H, int S, int Dh, int ld, int items,
                              cudaStream_t stream) {
  using P = DqPlan<DH, NS>;
  static const cudaError_t attr =
      set_smem(flash_bwd_dq_kernel<DH, NS, CAUSAL>, P::kBytes);
  if (attr != cudaSuccess) return attr;
  const int grid = min(sm_count(), (items + NS - 1) / NS);
  flash_bwd_dq_kernel<DH, NS, CAUSAL>
      <<<grid, threads(NS), P::kBytes, stream>>>(
          maps[0], maps[1], maps[2], maps[3], key_mask, o, dout, row_max,
          row_sum, delta, dq, H, S, ld, softmax_scale(Dh), items);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const uint8_t* key_mask, const float* o,
                      const float* dout, const float* row_max,
                      const float* row_sum, float* delta, float* dq, int B,
                      int H, int S, int Dh, int ld, int causal,
                      cudaStream_t stream) {
  constexpr int kKeys = other_rows(DH);
  constexpr int NS = kMaxDqStreams<DH>;
  CUtensorMap maps[4];
  const int BH = B * H;
  cudaError_t err = f32_rows_map<DH, kTile>(&maps[0], q, BH, S, ld);
  if (err == cudaSuccess) err = f32_rows_map<DH, kKeys>(&maps[1], k, BH, S, ld);
  if (err == cudaSuccess) err = f32_rows_map<DH, kKeys>(&maps[2], v, BH, S, ld);
  if (err == cudaSuccess)
    err = f32_rows_map<DH, kTile>(&maps[3], dout, BH, S, ld);
  if (err != cudaSuccess) return err;
  const int items = B * H * ((S + kTile - 1) / kTile);
  const bool two = streams_for(items, NS) == 2;
#define FLEXDM_DQ(ns, c)                                                   \
  launch_dq_streams<DH, ns, c>(maps, key_mask, o, dout, row_max, row_sum, \
                               delta, dq, H, S, Dh, ld, items, stream)
  if (causal) return two ? FLEXDM_DQ(NS, true) : FLEXDM_DQ(1, true);
  return two ? FLEXDM_DQ(NS, false) : FLEXDM_DQ(1, false);
#undef FLEXDM_DQ
}

template <int DH, int NS, bool CAUSAL>
cudaError_t launch_dkv_streams(const CUtensorMap (&maps)[4],
                               const uint8_t* key_mask, const float* row_max,
                               const float* row_sum, const float* delta,
                               float* dk, float* dv, int H, int S, int Dh,
                               int ld, int items, cudaStream_t stream) {
  using P = DkvPlan<DH, NS>;
  static const cudaError_t attr =
      set_smem(flash_bwd_dkv_kernel<DH, NS, CAUSAL>, P::kBytes);
  if (attr != cudaSuccess) return attr;
  const int grid = min(sm_count(), (items + NS - 1) / NS);
  flash_bwd_dkv_kernel<DH, NS, CAUSAL>
      <<<grid, threads(NS), P::kBytes, stream>>>(
          maps[0], maps[1], maps[2], maps[3], key_mask, row_max, row_sum,
          delta, dk, dv, H, S, ld, softmax_scale(Dh), items);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const uint8_t* key_mask, const float* dout,
                       const float* row_max, const float* row_sum,
                       const float* delta, float* dk, float* dv, int B, int H,
                       int S, int Dh, int ld, int causal,
                       cudaStream_t stream) {
  constexpr int kRows = other_rows(DH);
  constexpr int NS = kMaxDkvStreams<DH>;
  CUtensorMap maps[4];
  const int BH = B * H;
  cudaError_t err = f32_rows_map<DH, kRows>(&maps[0], q, BH, S, ld);
  if (err == cudaSuccess) err = f32_rows_map<DH, kTile>(&maps[1], k, BH, S, ld);
  if (err == cudaSuccess) err = f32_rows_map<DH, kTile>(&maps[2], v, BH, S, ld);
  if (err == cudaSuccess)
    err = f32_rows_map<DH, kRows>(&maps[3], dout, BH, S, ld);
  if (err != cudaSuccess) return err;
  const int items = B * H * ((S + kTile - 1) / kTile);
  const bool two = streams_for(items, NS) == 2;
#define FLEXDM_DKV(ns, c)                                                 \
  launch_dkv_streams<DH, ns, c>(maps, key_mask, row_max, row_sum, delta, \
                                dk, dv, H, S, Dh, ld, items, stream)
  if (causal) return two ? FLEXDM_DKV(NS, true) : FLEXDM_DKV(1, true);
  return two ? FLEXDM_DKV(NS, false) : FLEXDM_DKV(1, false);
#undef FLEXDM_DKV
}

}  // namespace

// All tensors float32 and contiguous: q, k, v, o, dout, dq, dk, dv are
// (B, H, S, ld) and 16-byte aligned, ld = Dh rounded up to a multiple of 4
// (16 bytes) with columns Dh .. ld - 1 of q, k, v, o and dout zero (a padded
// copy; hopper.cuh, "Head dims"), 1 <= Dh <= 128; row_max, row_sum (from the
// forward)
// and delta are (B, H, S).  key_mask: (B, S) bool (nonzero = attend) or
// null.  Each entry returns the cudaError_t of its launch
// (cudaErrorNotSupported if the CUDA driver cannot encode tensor maps).

// Writes dq and delta = rowsum(dout * o).  Run it before the dkv entry on
// the same stream: dkv reads delta.
extern "C" int flexdm_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* o, const void* dout, const void* row_max, const void* row_sum,
    void* delta, void* dq, int B, int H, int S, int Dh, int causal,
    void* stream) {
  if (bad_shape(B, H, S) || bad_head_dim(Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = row_width(Dh, 4);
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
#define FLEXDM_DQ_W(w)                                                   \
  launch_dq<w>(qf, kf, vf, mask, of, df, mf, sf, deltaf, dqf, B, H, S, Dh, \
               ld, causal, st)
  const int width = tile_width(ld);
  return static_cast<int>(width == 32   ? FLEXDM_DQ_W(32)
                          : width == 64 ? FLEXDM_DQ_W(64)
                                        : FLEXDM_DQ_W(128));
#undef FLEXDM_DQ_W
}

// Writes dk and dv; reads the delta written by flexdm_flash_attention_bwd_dq.
extern "C" int flexdm_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* row_max, const void* row_sum,
    const void* delta, void* dk, void* dv, int B, int H, int S, int Dh,
    int causal, void* stream) {
  if (bad_shape(B, H, S) || bad_head_dim(Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = row_width(Dh, 4);
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
#define FLEXDM_DKV_W(w)                                                   \
  launch_dkv<w>(qf, kf, vf, mask, df, mf, sf, deltaf, dkf, dvf, B, H, S, Dh, \
                ld, causal, st)
  const int width = tile_width(ld);
  return static_cast<int>(width == 32   ? FLEXDM_DKV_W(32)
                          : width == 64 ? FLEXDM_DKV_W(64)
                                        : FLEXDM_DKV_W(128));
#undef FLEXDM_DKV_W
}
