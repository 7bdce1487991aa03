// Flash-attention backward for head dims above 128 on Hopper (sm_90a),
// float32 in and out: the dq kernel (with delta) and the dk/dv kernel, every
// product a warpgroup wgmma on the TF32 tensor cores with each operand split
// once into two TF32 terms, over 32-column chunks of the row that TMA
// brings in.
//
// Replaces, at Dh > 128 in float32, the TPU kernels of
// flexdm_tpu/ops/attention.py:
//   * _flash_bwd_dq_kernel (:116-153; pallas_call :383) and its S >= 4096
//     stream variant _flash_bwd_dq_stream_kernel (:217-251; :451) ->
//     flash_bwd_dq_wide_kernel, which also computes delta = rowsum(dO * O)
//     (the XLA glue of _attention_pallas_bwd) and writes it for dk/dv;
//   * _flash_bwd_dkv_kernel (:156-206; :407) and
//     _flash_bwd_dkv_stream_kernel (:254-293; :475) ->
//     flash_bwd_dkv_wide_kernel.
// The TPU kernels take the whole Dh as one block.  Here shared memory and
// registers do not grow with Dh: one kernel covers every S and every Dh
// above 128, with no upper limit (ops/attention.py:head_dim_plan sends them
// here; the bf16 instances are csrc/flash_attention_wide.cu's).
//
// Contract (flash_attention_bwd.cu's, unchanged): p = exp(s - m) / l from
// the forward's row max m and row sum l, not from lse (a fully masked row
// keeps p = 1/S); s = q k^T / sqrt(Dh) + bias, the FINITE bias -1e9 on a
// masked key, the causal band replaced by -1e9 (ds = 0 there), keys at
// index >= S excluded outright; delta = rowsum(dO * O) over the full row;
// ds = p (dO v^T - delta); dq = scale ds k, dk = scale ds^T q, dv = p^T dO.
// The scale is 1/sqrt(Dh), never a chunk or block width.  Rows are ld = Dh
// rounded up to 4 floats, columns Dh .. ld - 1 zero (a padded copy made by
// ops/attention.py); the tensor maps fill columns past ld and rows past S
// with zeros, which change no score and no gradient column below Dh.
//
// What bounds it on an H100 (132 SMs, 3.35 TB/s, 495 TFLOP/s TF32).  At the
// latent-2048 training shape (256, 8, 50, 256) each kernel must move 630 MB
// (0.188 ms); its split-TF32 products are 23.6 GFLOP (dq) and 31.5 (dk/dv),
// 0.048 and 0.064 ms at the peak, 0.078 and 0.104 with S padded to 64: bytes
// first.  The previous design (mma.sync on cp.async chunks, a block per
// output column block) spent 4.9x and 7.5x the bound: 255 registers and
// spills left 2 blocks of 4 warps an SM to hide every chunk's wait, each
// column block recomputed the scores (2x in dq, 4x in dk/dv at Dh 256), and
// every warp re-split each fragment it loaded.  This one spends 1.9x (dq)
// and 3.1x (dk/dv) there (PERF.md).  What is left is the chunk pipeline
// itself (tools/torch_wide_bwd_phases.py): a chunk's split (three 16-byte
// units a splitter thread) and its hand-over (the consumers' barrier and
// refill) take about as long as its 24 score wgmmas, the own tiles are
// copied and split again for every tile of the other axis, and three
// stages of 48 KB are all that fit beside the transposed tiles.

// Design (the chunk pipeline is csrc/wide_tf32.cuh's, shared with the float32
// wide forward, csrc/flash_attention_fwd_wide.cu).
//   * An item is 64 rows of one head (query rows for dq, keys for dk/dv):
//     the wgmma M, and one column block of its outputs, 256 columns of dq
//     or 128 of dk and dv (one accumulator set of 128 registers a thread
//     either way; dk and dv at 256 would need 256).  So the scores are
//     computed once a row at Dh <= 256 in dq, twice in dk/dv at Dh 256, and
//     once more per further block.  A block, one an SM, is one consumer
//     warpgroup and one splitter warpgroup (256 threads, so up to 255
//     registers; two consumer warpgroups would leave 168, fewer than an
//     item's sums); it takes the items blockIdx.x, + gridDim.x, ... of the
//     launch, column block fastest, so neighbouring SMs share a row's reads
//     through L2.  Every output element is summed by one thread in a fixed
//     order: no atomics, a second call is bitwise equal.
//   * The other axis comes in tiles of 32 keys (dq) or query rows (dk/dv),
//     and each tile's row in chunks of 32 columns (one 128-byte swizzled TMA
//     box): a stage of the ring holds the chunk of both own tiles (Q and dO,
//     or K and V, 64 rows) and of both other tiles (K and V, or Q and dO, 32
//     rows).  Tensor maps are __grid_constant__ over (B H, S, ld) views, so
//     rows past S and columns past ld arrive as zeros, never as the next
//     head's.  Three stages of 48 KB (the tiles' hi in place and lo beside
//     them) and the transposed tiles fill the 227 KB.
//   * The splitter warpgroup splits every landed chunk once, in shared
//     memory (hi = tf32(x) in place, lo = x - hi beside it), and writes the
//     chunks of the item's column block transposed (TF32 wgmma reads both
//     operands K-major only) into the tile's K^T (dq) or Q^T and dO^T
//     (dk/dv), the rows in the k order of the accumulator-made A operand
//     (acc_order), in the 128-byte swizzled K-major layout, with a unit
//     order that keeps every load and store of the split free of bank
//     conflicts (OtherUnit); with them the tile's vectors (key bias;
//     or m, 1/l, delta) and, at an item's first tile, the item's (its rows'
//     m and 1/l; or its keys' biases).  dq's splitters also sum delta from
//     the dO chunks they split and O read beside them, so the consumers
//     read nothing from device memory at an item's start, where its latency
//     would not be hidden (~8 us an item at S = 50 on an H100).  They write
//     these once the consumers have finished the previous tile's second
//     products (the t_free mbarrier); the other chunks run ahead.  A
//     chunk's four tiles split as one unit a thread (own A, own B, and one
//     of the other two).
//   * Products.  The score products (q k^T and dO v^T, or k q^T and v dO^T)
//     take a chunk's k8 steps as SS m64n32k8 wgmmas, chained over the row's
//     chunks in two accumulator sets, the small terms (lo hi' + hi lo') and
//     the large (hi hi'), added in float32 when the row is done
//     (chunk_score_product): the tensor cores cut their float32 sums toward
//     zero, and this keeps the large terms' cuts the only ones at the sum's
//     full size, as the narrow kernels' small-first order does (with each
//     step's three terms in turn the crello step's key-bias gradient missed
//     its gate there).  The consumer keeps one chunk's products in flight
//     while it waits for the previous chunk's, then hands that stage back:
//     its thread 0 refills it with the stream's next chunk, across tiles
//     and items, so the next item's chunks land while this one ends.  Then
//     p and ds in registers, branch-free (a branch around values feeding
//     the next products serialises every wgmma, C7520), and dq += ds k, or
//     dv += p^T dO and dk += ds^T q, from the accumulators as RS wgmmas on
//     the transposed tiles, 32 columns at a time, each summed from zero and
//     added in float32 (second_product).
//   * Causal dq stops at the item's last row (later keys are replaced for
//     every row: ds = 0); dk/dv visits every tile (a fully masked row's
//     p = 1/S reaches dv through replaced keys).  causal is a template
//     parameter.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wide_tf32.cuh"

namespace {

constexpr int kDqCols = 256;  // column block of dq
constexpr int kDkvCols = 128;  // column block of dk and dv

// dq: the tile's key biases; the item's rows' m (log2 units) and 1/l.
// dk/dv: the tile's rows' m, 1/l and delta; the item's keys' biases.
using DqPlan = WidePlan<kDqCols, 1, 1, 2>;
using DkvPlan = WidePlan<kDkvCols, 2, 3, 1>;

// ---------------------------------------------------------------------------
// dq (and delta).  An item is 64 query rows and a 256-column block of dq.
// Per key tile: s = q k^T and dp = dO v^T over the row's chunks, ds in
// registers, then dq += ds k.
// ---------------------------------------------------------------------------

template <bool CAUSAL>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const uint8_t* __restrict__ key_mask,
                         const float* __restrict__ o,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_sum,
                         float* __restrict__ delta, float* __restrict__ dq,
                         int H, int S, int ld, int n_cb, float scale,
                         int n_items) {
  using P = DqPlan;
  constexpr bool causal = CAUSAL;
  extern __shared__ unsigned char smem_raw[];
  const WideBlock<P, true, CAUSAL> blk(align_1024(smem_raw), S, ld, n_cb,
                                       n_items);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lt = tid % kWarpgroup;
  const bool splitter = warp >= 4;

  if (tid == 0) {
    blk.bar.init(P::kStages);
    mbar_init_fence();
  }
  __syncthreads();

  if (splitter) {
    // The key bias (log2 units) of the tile's keys; the item's rows' m
    // (log2 units) and 1/l (0 past S: p and ds are 0 there).
    blk.template split_all<1, 2>(
        lt,
        [&](const WideItem& item, int j, int x, float (&v)[1]) {
          v[0] = x < kOther ? key_bias(key_mask, item.bh / H, S,
                                       j * kOther + x) * kLog2e
                            : 0.f;
        },
        [&](const WideItem& item, int x, float (&v)[2]) {
          const size_t row = static_cast<size_t>(item.bh) * S + item.row0 + x;
          const bool real = x < kTile && item.row0 + x < S;
          v[0] = real ? row_max[row] * kLog2e : 0.f;
          v[1] = real ? 1.f / row_sum[row] : 0.f;
        },
        DqRows{o, delta, ld});
    return;
  }

  ChunkCursor cur = blk.start(blockIdx.x);
  auto refill = [&](int r) {
    blk.load(cur, r, &q_map, &do_map, &k_map, &v_map);
  };
  auto free_tile = [&](int) { mbar_arrive(blk.bar.t_free); };
  if (lt == 0)
    for (int r = 0; r < P::kStages; ++r) refill(r);

  // Thread 32 w + 4 g + t holds rows 16 w + g and 16 w + g + 8 of the
  // item's 64.
  const int w = warp;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c1 = scale * kLog2e;  // scores in log2 units
  const float* vec_s = blk.vec();  // key biases, the rows' m, 1/l, delta
  const float* bias_s = vec_s;
  const uint32_t kt_addr = shared_addr(blk.transposed(0));
  int s = 0;  // the stream's chunks consumed
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const WideItem item = wide_item(it, blk.blocks, n_cb);
    const int q0 = item.row0;
    const size_t head = static_cast<size_t>(item.bh) * S;  // row (b, h, 0)
    float acc[kDqCols / 2] = {};  // dq of the rows' column block, unscaled
    const int n_t = blk.tiles(q0);
    for (int j = 0; j < n_t; ++j) {
      float sd[2][kOther / 2];  // s (or s^T), dp (or dp^T)
      blk.scores(sd, s, lt, refill);
      float (&sc)[kOther / 2] = sd[0];
      float (&dp)[kOther / 2] = sd[1];
      // The rows' m (log2 units), 1/l and delta, as the splitters wrote
      // them with the item's first tile (read every tile: a branch here
      // would reach the products).  A row past S has 1/l = 0, so its p and
      // ds are 0.
      float m2[2], inv_l[2], dlt[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = 16 * w + g + 8 * hh;
        m2[hh] = vec_s[P::kItemVec + rr];
        inv_l[hh] = vec_s[P::kItemVec + kTile + rr];
        dlt[hh] = vec_s[P::kDelta + rr];
      }
      // p and ds, branch-free: keys past S get p = 0 (their zero-filled
      // scores keep the exponential finite), replaced scores -1e9 log2 e.
      const int k0 = j * kOther;
      const int n_keys = min(kOther, S - k0);
#pragma unroll
      for (int jj = 0; jj < kOther / 8; ++jj) {
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
          const float d = p * (dp[4 * jj + e] - dlt[e >> 1]);
          sc[4 * jj + e] = (kj < n_keys) & !replaced ? d : 0.f;
        }
      }
      // dq += ds k: ds from the accumulators, k transposed (K^T hi, lo).
      uint32_t a_hi[kOther / 8][4], a_lo[kOther / 8][4];
      acc_frags<kOther>(a_hi, a_lo, sc);
      second_product<kDqCols, kOther, kOther, P::T>(
          acc, a_hi, a_lo, kt_addr, kt_addr + P::T::kBytes);
      // K^T and the vectors are read: the splitters may write the next
      // tile's (and item's).
      blk.release(lt, free_tile, 0);
    }

    const int c0 = item.cb * kDqCols;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * w + g + 8 * hh;
      if (row >= S) continue;
      float* dq_row = dq + (head + row) * ld + c0;
#pragma unroll
      for (int jj = 0; jj < kDqCols / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c0 + c < ld)
          *reinterpret_cast<float2*>(dq_row + c) =
              make_float2(acc[4 * jj + 2 * hh] * scale,
                          acc[4 * jj + 2 * hh + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv.  An item is 64 keys and a 128-column block of dk and dv.  Per
// tile of 32 query rows: s^T = k q^T and dp^T = v dO^T over the row's
// chunks, p^T and ds^T in registers, then dv += p^T dO and dk += ds^T q.
// ---------------------------------------------------------------------------

template <bool CAUSAL>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const uint8_t* __restrict__ key_mask,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int S, int ld, int n_cb, float scale,
                          int n_items) {
  using P = DkvPlan;
  constexpr bool causal = CAUSAL;
  extern __shared__ unsigned char smem_raw[];
  const WideBlock<P, false, CAUSAL> blk(align_1024(smem_raw), S, ld, n_cb,
                                        n_items);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lt = tid % kWarpgroup;
  const bool splitter = warp >= 4;

  if (tid == 0) {
    blk.bar.init(P::kStages);
    mbar_init_fence();
  }
  __syncthreads();

  if (splitter) {
    // m (log2 units), 1/l and delta of the tile's rows; the key bias (log2
    // units) of the item's keys.
    blk.template split_all<3, 1>(
        lt,
        [&](const WideItem& item, int j, int x, float (&v)[3]) {
          const size_t head = static_cast<size_t>(item.bh) * S;
          const int row = j * kOther + x;
          const bool real = x < kOther && row < S;
          v[0] = real ? row_max[head + row] * kLog2e : 0.f;
          v[1] = real ? 1.f / row_sum[head + row] : 0.f;
          v[2] = real ? delta[head + row] : 0.f;
        },
        [&](const WideItem& item, int x, float (&v)[1]) {
          v[0] = key_bias(key_mask, item.bh / H, S, item.row0 + x) * kLog2e;
        },
        DqRows{});
    return;
  }

  ChunkCursor cur = blk.start(blockIdx.x);
  auto refill = [&](int r) {
    blk.load(cur, r, &k_map, &v_map, &q_map, &do_map);
  };
  auto free_tile = [&](int) { mbar_arrive(blk.bar.t_free); };
  if (lt == 0)
    for (int r = 0; r < P::kStages; ++r) refill(r);

  // Thread 32 w + 4 g + t holds keys 16 w + g and 16 w + g + 8 of the
  // item's 64.
  const int w = warp;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c1 = scale * kLog2e;  // scores in log2 units
  const float* stats = blk.vec();  // the tile's rows' m, 1/l, delta; keys'
                                   // biases
  const uint32_t tq_addr = shared_addr(blk.transposed(0));
  const uint32_t tdo_addr = shared_addr(blk.transposed(1));
  int s = 0;  // the stream's chunks consumed
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const WideItem item = wide_item(it, blk.blocks, n_cb);
    const int k0 = item.row0;
    const size_t head = static_cast<size_t>(item.bh) * S;
    bool kreal[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) kreal[hh] = k0 + 16 * w + g + 8 * hh < S;

    // dk (unscaled) and dv of the keys' column block.
    float acc_dk[kDkvCols / 2] = {}, acc_dv[kDkvCols / 2] = {};
    const int n_t = blk.tiles(k0);
    for (int j = 0; j < n_t; ++j) {
      float sd[2][kOther / 2];  // s (or s^T), dp (or dp^T)
      blk.scores(sd, s, lt, refill);
      float (&sc)[kOther / 2] = sd[0];
      float (&dp)[kOther / 2] = sd[1];
      // The keys' biases (log2 units), as the splitters wrote them with the
      // item's first tile (read every tile: a branch here would reach the
      // products).
      float kbias[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        kbias[hh] = stats[P::kItemVec + 16 * w + g + 8 * hh];
      // p^T and ds^T, branch-free; rows or keys past S have a score of 0
      // (zero-filled tiles), so their exponential is finite before it is
      // dropped.
      const int i0 = j * kOther;
      const int n_rows = min(kOther, S - i0);
#pragma unroll
      for (int jj = 0; jj < kOther / 8; ++jj) {
        const int ri = 8 * jj + 2 * t;
        const float2 mm = *reinterpret_cast<const float2*>(stats + ri);
        const float2 il =
            *reinterpret_cast<const float2*>(stats + kOther + ri);
        const float2 dd =
            *reinterpret_cast<const float2*>(stats + 2 * kOther + ri);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const int key = k0 + 16 * w + g + 8 * (e >> 1);
          const bool replaced = causal & (key > i0 + ri + c);
          const float x =
              replaced ? kMaskedLog2 : fmaf(sc[4 * jj + e], c1, kbias[e >> 1]);
          float p = exp2_approx(x - (c ? mm.y : mm.x)) * (c ? il.y : il.x);
          p = (ri + c < n_rows) & kreal[e >> 1] ? p : 0.f;
          const float d = p * (dp[4 * jj + e] - (c ? dd.y : dd.x));
          sc[4 * jj + e] = p;
          dp[4 * jj + e] = replaced ? 0.f : d;
        }
      }
      // dv += p^T dO and dk += ds^T q (dO and q transposed), one after the
      // other.
      {
        uint32_t a_hi[kOther / 8][4], a_lo[kOther / 8][4];
        acc_frags<kOther>(a_hi, a_lo, sc);
        second_product<kDkvCols, kOther, kOther, P::T>(
            acc_dv, a_hi, a_lo, tdo_addr, tdo_addr + P::T::kBytes);
      }
      {
        uint32_t a_hi[kOther / 8][4], a_lo[kOther / 8][4];
        acc_frags<kOther>(a_hi, a_lo, dp);
        second_product<kDkvCols, kOther, kOther, P::T>(
            acc_dk, a_hi, a_lo, tq_addr, tq_addr + P::T::kBytes);
      }
      // Q^T, dO^T and the statistics are read: the splitters may write the
      // next tile's.
      blk.release(lt, free_tile, 0);
    }

    const int c0 = item.cb * kDkvCols;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!kreal[hh]) continue;
      const size_t key_row = (head + k0 + 16 * w + g + 8 * hh) * ld + c0;
#pragma unroll
      for (int jj = 0; jj < kDkvCols / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c0 + c >= ld) continue;
        *reinterpret_cast<float2*>(dk + key_row + c) =
            make_float2(acc_dk[4 * jj + 2 * hh] * scale,
                        acc_dk[4 * jj + 2 * hh + 1] * scale);
        *reinterpret_cast<float2*>(dv + key_row + c) =
            make_float2(acc_dv[4 * jj + 2 * hh], acc_dv[4 * jj + 2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

template <bool CAUSAL>
cudaError_t launch_dq_wide(const CUtensorMap (&maps)[4],
                           const uint8_t* key_mask, const float* o,
                           const float* row_max,
                           const float* row_sum, float* delta, float* dq,
                           int H, int S, int Dh, int ld, int items,
                           cudaStream_t stream) {
  static const cudaError_t attr =
      set_smem(flash_bwd_dq_wide_kernel<CAUSAL>, DqPlan::kBytes);
  if (attr != cudaSuccess) return attr;
  // maps: Q, dO (own), K, V (other).
  flash_bwd_dq_wide_kernel<CAUSAL>
      <<<min(sm_count(), items), kWideThreads, DqPlan::kBytes, stream>>>(
          maps[0], maps[2], maps[3], maps[1], key_mask, o, row_max, row_sum,
          delta, dq, H, S, ld, (ld + kDqCols - 1) / kDqCols,
          softmax_scale(Dh), items);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t launch_dkv_wide(const CUtensorMap (&maps)[4],
                            const uint8_t* key_mask, const float* row_max,
                            const float* row_sum, const float* delta,
                            float* dk, float* dv, int H, int S, int Dh,
                            int ld, int items, cudaStream_t stream) {
  static const cudaError_t attr =
      set_smem(flash_bwd_dkv_wide_kernel<CAUSAL>, DkvPlan::kBytes);
  if (attr != cudaSuccess) return attr;
  // maps: K, V (own), Q, dO (other).
  flash_bwd_dkv_wide_kernel<CAUSAL>
      <<<min(sm_count(), items), kWideThreads, DkvPlan::kBytes, stream>>>(
          maps[2], maps[0], maps[1], maps[3], key_mask, row_max, row_sum,
          delta, dk, dv, H, S, ld, (ld + kDkvCols - 1) / kDkvCols,
          softmax_scale(Dh), items);
  return cudaGetLastError();
}

}  // namespace

// The C entry points, with the other backward entries' arguments.  q, k,
// v, o, dout, dq, dk, dv: (B, H, S, ld) float32, contiguous, 16-byte
// aligned, ld = Dh rounded up to 4 with columns Dh .. ld - 1 of q, k, v, o
// and dout zero; any Dh >= 1 (ops/attention.py sends Dh > 128).  key_mask:
// (B, S) bool (nonzero = attend) or null.  row_max, row_sum (from the
// forward) and delta: (B, H, S) float32.  Each returns the cudaError_t of
// its launch (cudaErrorNotSupported if the CUDA driver cannot encode tensor
// maps).

// Writes dq and delta = rowsum(dout * o).  Run it before the dkv entry on
// the same stream: dkv reads delta.
extern "C" int flexdm_flash_attention_bwd_dq_wide(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* o, const void* dout, const void* row_max, const void* row_sum,
    void* delta, void* dq, int B, int H, int S, int Dh, int causal,
    void* stream) {
  const int ld = Dh < 1 ? 0 : row_width(Dh, 4);
  const int items = ld == 0 ? 0 : wide_items(B, H, S, ld, kDqCols);
  if (items == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const cudaError_t err = wide_maps(maps, q, dout, k, v, B * H, S, ld);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* of = static_cast<const float*>(o);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  auto* deltaf = static_cast<float*>(delta);
  auto* dqf = static_cast<float*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      causal ? launch_dq_wide<true>(maps, mask, of, mf, sf, deltaf, dqf, H,
                                    S, Dh, ld, items, st)
             : launch_dq_wide<false>(maps, mask, of, mf, sf, deltaf, dqf, H,
                                     S, Dh, ld, items, st));
}

// Writes dk and dv; reads the delta written by
// flexdm_flash_attention_bwd_dq_wide.
extern "C" int flexdm_flash_attention_bwd_dkv_wide(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* row_max, const void* row_sum,
    const void* delta, void* dk, void* dv, int B, int H, int S, int Dh,
    int causal, void* stream) {
  const int ld = Dh < 1 ? 0 : row_width(Dh, 4);
  const int items = ld == 0 ? 0 : wide_items(B, H, S, ld, kDkvCols);
  if (items == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const cudaError_t err = wide_maps(maps, k, v, q, dout, B * H, S, ld);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  const auto* deltaf = static_cast<const float*>(delta);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      causal ? launch_dkv_wide<true>(maps, mask, mf, sf, deltaf, dkf, dvf, H,
                                     S, Dh, ld, items, st)
             : launch_dkv_wide<false>(maps, mask, mf, sf, deltaf, dkf, dvf, H,
                                      S, Dh, ld, items, st));
}
