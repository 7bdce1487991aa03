// Flash-attention forward for head dims above 128 on Hopper (sm_90a), both
// dtypes: the float32 instance on split-TF32 warpgroup wgmma over 32-column
// chunks of the row that TMA brings in and a splitter warpgroup splits
// once, the bf16 instance on bf16 warpgroup wgmma over 64-column chunks that
// a producer warp keeps in flight by TMA.  No mma.sync, no cp.async.
//
// Replaces, at Dh > 128, the TPU kernel flexdm_tpu/ops/attention.py:
// _flash_fwd_kernel (:77-113, launched by _flash_forward at :329), which
// takes the whole Dh as one block.  Here shared memory and registers do not
// grow with Dh: one kernel a dtype covers every S and every Dh above 128,
// with no upper limit (ops/attention.py:head_dim_plan sends them here).
//
// Contract (the narrow forwards', unchanged): O = softmax(q k^T / sqrt(Dh)
// + bias) v by an online softmax over key tiles, and the row lse, max m and
// sum l (B, H, S), float32, in natural-log units, from which both wide
// backward kernels rebuild p = exp(s - m) / l.  The scale is 1/sqrt(Dh),
// never a chunk or block width.  A masked key gets the FINITE bias -1e9,
// so a fully masked row averages V over its S keys (l = S); keys at index
// >= S are excluded outright (their zero-filled scores are set to -inf);
// with `causal` (a template parameter) a key after its query row (absolute
// positions) gets the score -1e9, and the tiles above the diagonal are
// still visited.  Rows are ld = Dh rounded up to 16 bytes, columns Dh ..
// ld - 1 zero (a padded copy made by ops/attention.py); the tensor maps fill
// columns past ld and rows past S with zeros.  Scores are kept in log2
// units: x = s (scale log2 e) + bias log2 e, p = 2^(x - m2), and m = m2 ln 2
// is written (a fully masked row's m2 = -1e9 log2 e gives back exactly
// -1e9).  No atomics, every sum in a fixed order: a second call is bitwise
// equal.  bf16: q, k, v and O in bf16, P enters P V as a bf16 operand
// (rounded to nearest even from the float32 p; l sums the float32 p), O is
// rounded once; lse, m and l stay float32.
//
// What bounds it on an H100 (132 SMs, 3.35 TB/s, 495 TFLOP/s TF32, 989
// bf16).  At the latent-2048 training shape (256, 8, 50, 256) the forward
// must move 419 MB in float32 (0.125 ms) and 210 MB in bf16 (0.063 ms); its
// products are 5.2 GFLOP (0.011 ms in TF32, three times that split; 0.005 ms
// in bf16): bytes.  The previous design (mma.sync on cp.async chunks, a
// block per 128-column block of O) spent 3.6x (float32) and 2.7x (bf16)
// that bound on an H100 at 700 W (PERF.md): every column block recomputed
// the scores over the whole row (q and k read twice at Dh 256), each chunk
// was waited for in turn behind two block-wide barriers with only other
// blocks on the SM to hide it, and in float32 every warp split each
// fragment it loaded, at 255 registers with spills.  Here the scores are
// computed once a row at Dh <= 256, the chunks of the next tiles and items
// are in flight while a tile computes, and each float32 value is split
// once: 1.9x (float32) and 1.3x (bf16) the bound there on the same card
// (PERF.md).
//
// Design.
//   * An item is 64 query rows of one head (the wgmma M) and one column
//     block of O of 256 columns (O in 128 float32 registers a thread of one
//     warpgroup): one column block at Dh <= 256, two at Dh 512, whose
//     scores, m and l are computed alike, bitwise (the same products in the
//     same order), and column block 0 writes m, l and lse.  Persistent
//     blocks, one an SM, take the items blockIdx.x, + gridDim.x, ..., column
//     block fastest, so the ring runs ahead into the next item (at S = 50
//     an item has one or two key tiles).
//   * float32 (flash_fwd_wide_kernel): wide_tf32.cuh's chunk pipeline, as
//     the wide dq kernel (flash_attention_bwd_wide.cu) runs it, with one
//     score product: a consumer and a splitter warpgroup; key tiles of 32
//     keys (the wgmma N), each tile's row in 32-column chunks (one
//     128-byte swizzled TMA box each), a stage holding the chunk of Q (64
//     rows) and of the tile's K and V (32 keys), hi and lo (32 KB; V only
//     in the item's column block), five stages beside the V^T tile ((256,
//     32) hi and lo, 64 KB).  The splitters split each landed chunk once (Q
//     and K in place; V only transposed, into V^T at acc_order, since TF32
//     wgmma reads both operands K-major) and write the tile's key biases
//     (log2 units) behind t_free.  The consumers chain q k^T over the row's
//     chunks as SS m64n32k8 wgmmas in two sums, small and large terms
//     (chunk_score_product), then the online softmax in registers,
//     branch-free (a branch around values feeding the next products
//     serialises every wgmma, C7520), the rescale of O by alpha once a
//     tile, and O += P V from the score accumulators as RS wgmmas on V^T, 32
//     columns at a time, each summed from zero and added in float32
//     (second_product).
//   * bf16 (flash_fwd_wide_bf16_kernel): PR 18's forward
//     (flash_attention_fwd_bf16.cu) widened.  One consumer warpgroup and
//     one producer warp.  The producer keeps a ring of stages, each a
//     64-column chunk of Q (64 rows) and of K (a tile of 64 keys), 16 KB,
//     and two buffers of the tile's V over the item's column block (64 keys
//     by 256 columns, 32 KB, four 64-column boxes) with the tile's key
//     biases in log2 units beside them, full in turn.  q k^T is an SS
//     m64n64k16 wgmma chained over the row's chunks (stages handed back on
//     an empty mbarrier as their products complete); the softmax as in
//     float32; O += P V an RS product, P packed to bf16 from the score
//     accumulators, V read MN-major through the transpose bit, two
//     m64n128k16 halves a k16 step.  Q streams with K, so at S > 64 it is
//     read once a key tile (from L2); at S <= 64, the Ours-EXP paths, an
//     item has one tile and reads Q once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "wgmma_bf16.cuh"
#include "wide_tf32.cuh"

namespace {

constexpr int kFwdCols = 256;  // column block of O

// ---------------------------------------------------------------------------
// float32
// ---------------------------------------------------------------------------

// The tile's key biases (log2 units); no item vectors; V^T.
using FwdPlan = WidePlan<kFwdCols, 1, 1, 0, true>;

template <bool CAUSAL>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const uint8_t* __restrict__ key_mask,
                      float* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ row_max,
                      float* __restrict__ row_sum, int H, int S, int ld,
                      int n_cb, float scale_log2, int n_items) {
  using P = FwdPlan;
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
    // The key bias (log2 units) of the tile's keys.
    blk.template split_all<1, 0>(
        lt,
        [&](const WideItem& item, int j, int x, float (&v)[1]) {
          v[0] = x < kOther ? key_bias(key_mask, item.bh / H, S,
                                       j * kOther + x) * kLog2e
                            : 0.f;
        },
        [](const WideItem&, int, float (&)[1]) {}, DqRows{});
    return;
  }

  ChunkCursor cur = blk.start(blockIdx.x);
  auto refill = [&](int r) {
    blk.load(cur, r, &q_map, nullptr, &k_map, &v_map);
  };
  auto free_tile = [&](int) { mbar_arrive(blk.bar.t_free); };
  if (lt == 0)
    for (int r = 0; r < P::kStages; ++r) refill(r);

  // Thread 32 w + 4 g + t holds rows 16 w + g and 16 w + g + 8 of the
  // item's 64: sc[4 jj + e] is row 16 w + g + 8 (e >> 1), key 8 jj + 2 t +
  // (e & 1) of the tile.
  const int w = warp;
  const int g = lane / 4;
  const int t = lane % 4;
  const float* bias_s = blk.vec();  // the tile's key biases
  const uint32_t vt_addr = shared_addr(blk.transposed(0));
  int s = 0;  // the stream's chunks consumed
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const WideItem item = wide_item(it, blk.blocks, n_cb);
    const int q0 = item.row0;
    const size_t head = static_cast<size_t>(item.bh) * S;  // row (b, h, 0)
    float m2[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
    float l[2] = {0.f, 0.f};  // the lane's share of the row sums
    float acc[kFwdCols / 2] = {};  // O of the column block, unnormalised
    const int n_t = blk.tiles(q0);
    for (int j = 0; j < n_t; ++j) {
      float sd[1][kOther / 2];
      blk.scores(sd, s, lt, refill);
      float (&sc)[kOther / 2] = sd[0];
      // x = s scale log2 e + bias log2 e, branch-free: replaced scores
      // -1e9 log2 e, keys past S -inf (p = 0; their zero-filled scores keep
      // x finite before the select).
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
          const bool replaced = CAUSAL & (k0 + kj > row);
          const float x = replaced ? kMaskedLog2
                                   : fmaf(sc[4 * jj + e], scale_log2,
                                          e & 1 ? bl.y : bl.x);
          sc[4 * jj + e] = kj < n_keys ? x : -CUDART_INF_F;
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
        for (int jj = 0; jj < kOther / 8; ++jj) {
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
      for (int jj = 0; jj < kOther / 8; ++jj) {
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
      for (int n = 0; n < kFwdCols / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
      }
      // O += P V: P from the accumulators, V transposed (V^T hi, lo).
      uint32_t a_hi[kOther / 8][4], a_lo[kOther / 8][4];
      acc_frags<kOther>(a_hi, a_lo, sc);
      second_product<kFwdCols, kOther, kOther, P::T>(
          acc, a_hi, a_lo, vt_addr, vt_addr + P::T::kBytes);
      // V^T and the biases are read: the splitters may write the next
      // tile's.
      blk.release(lt, free_tile, 0);
    }

    const int c0 = item.cb * kFwdCols;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + 16 * w + g + 8 * hh;
      if (row >= S) continue;
      const float inv = 1.f / sum;
      float* o_row = o + (head + row) * ld + c0;
#pragma unroll
      for (int jj = 0; jj < kFwdCols / 8; ++jj) {
        const int c = 8 * jj + 2 * t;
        if (c0 + c < ld)
          *reinterpret_cast<float2*>(o_row + c) =
              make_float2(acc[4 * jj + 2 * hh] * inv,
                          acc[4 * jj + 2 * hh + 1] * inv);
      }
      if (item.cb == 0 && t == 0) {
        const float mn = m2[hh] * kLn2;
        lse[head + row] = mn + logf(sum);
        row_max[head + row] = mn;
        row_sum[head + row] = sum;
      }
    }
  }
}

template <bool CAUSAL>
cudaError_t launch_fwd_wide(const CUtensorMap (&maps)[4],
                            const uint8_t* key_mask, float* o, float* lse,
                            float* row_max, float* row_sum, int H, int S,
                            int Dh, int ld, int items, cudaStream_t stream) {
  static const cudaError_t attr =
      set_smem(flash_fwd_wide_kernel<CAUSAL>, FwdPlan::kBytes);
  if (attr != cudaSuccess) return attr;
  // maps: Q (own), K, V (other).
  flash_fwd_wide_kernel<CAUSAL>
      <<<min(sm_count(), items), kWideThreads, FwdPlan::kBytes, stream>>>(
          maps[0], maps[2], maps[3], key_mask, o, lse, row_max, row_sum, H,
          S, ld, (ld + kFwdCols - 1) / kFwdCols, softmax_scale(Dh, kLog2e),
          items);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

constexpr int kBKeys = 64;   // keys a tile: the N of the scores
constexpr int kBChunk = 64;  // columns a chunk: one 128-byte TMA box
constexpr int kBThreads = kWarpgroup + 32;  // consumers, the producer warp

// The bf16 forward's shared memory at ``stages`` ring stages: the ring
// (16 KB a stage: a chunk of Q, one of K), two V buffers (32 KB each),
// their key biases, then the barriers (per stage full and empty, per V
// buffer full and empty), with the alignment slack.
constexpr int bf16_fwd_bytes(int stages) {
  return 1024 + stages * 16384 + 2 * 32768 + 2 * kBKeys * 4 +
         (2 * stages + 4) * 8;
}

struct Bf16Plan {
  using Chunk = SwizzledTile<kBChunk, kTile>;      // Q, or K: 64 rows
  using VHalf = SwizzledTile<2 * kBChunk, kBKeys>;  // 128 columns of V
  static constexpr int kVBoxes = kFwdCols / kBChunk;
  static constexpr int kStageBytes = 2 * Chunk::kBytes;  // Q, K
  static constexpr int kVBytes = 2 * VHalf::kBytes;      // 256 columns
  static_assert(kStageBytes == 16384 && kVBytes == 32768,
                "bf16_fwd_bytes's sizes");
  // As many stages as fit, at most 8 (two key tiles of Dh 256 ahead).
  static constexpr int kStages =
      (kSmemLimit - bf16_fwd_bytes(0)) / (kStageBytes + 16) < 8
          ? (kSmemLimit - bf16_fwd_bytes(0)) / (kStageBytes + 16)
          : 8;
  static_assert(kStages >= 2, "two stages fit");
  static constexpr int kVOffset = kStages * kStageBytes;
  static constexpr int kBiasOffset = kVOffset + 2 * kVBytes;
  static constexpr int kBarOffset = kBiasOffset + 2 * kBKeys * 4;
  static constexpr int kBytes = bf16_fwd_bytes(kStages);
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

template <bool CAUSAL>
__global__ void __launch_bounds__(kBThreads, 1)
flash_fwd_wide_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const uint8_t* __restrict__ key_mask,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           float* __restrict__ row_max,
                           float* __restrict__ row_sum, int H, int S, int ld,
                           int n_cb, float scale_log2, int n_items) {
  using P = Bf16Plan;
  using Chunk = P::Chunk;
  using VHalf = P::VHalf;
  constexpr int ST = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto stage = [&](int r) { return smem + r * P::kStageBytes; };
  auto v_buf = [&](int b) { return smem + P::kVOffset + b * P::kVBytes; };
  float* bias_v = reinterpret_cast<float*>(smem + P::kBiasOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* empty = full + ST;
  uint64_t* v_full = empty + ST;
  uint64_t* v_empty = v_full + 2;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int blocks = (S + kTile - 1) / kTile;  // row blocks of a head
  const int n_chunks = (ld + kBChunk - 1) / kBChunk;
  const int n_t = (S + kBKeys - 1) / kBKeys;  // key tiles of an item

  if (tid == 0) {
    for (int r = 0; r < ST; ++r) {
      mbar_init(&full[r], 1);
      mbar_init(&empty[r], kWarpgroup);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&v_full[b], 32);
      mbar_init(&v_empty[b], kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // The producer: per item, per key tile, the tile's V over the column
    // block with its key biases, then the row's chunks of Q and K.
    for (int it = blockIdx.x, r = 0, gc = 0, gv = 0; it < n_items;
         it += gridDim.x) {
      const WideItem item = wide_item(it, blocks, n_cb);
      const int b = item.bh / H;
      for (int i = 0; i < n_t; ++i, ++gv) {
        // The mask is read before the wait, so its latency overlaps it.
        float kb[kBKeys / 32];
#pragma unroll
        for (int x = 0; x < kBKeys / 32; ++x)
          kb[x] = key_bias(key_mask, b, S, i * kBKeys + 32 * x + lane) *
                  kLog2e;
        const int vb = gv % 2;
        mbar_wait(&v_empty[vb], (gv / 2 & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&v_full[vb], P::kVBytes);
#pragma unroll
          for (int x = 0; x < P::kVBoxes; ++x)
            tma_load_3d(v_buf(vb) + x * Chunk::kBytes, &v_map, &v_full[vb],
                        item.cb * kFwdCols + x * kBChunk, i * kBKeys,
                        item.bh);
        }
#pragma unroll
        for (int x = 0; x < kBKeys / 32; ++x)
          bias_v[vb * kBKeys + 32 * x + lane] = kb[x];
        mbar_arrive(&v_full[vb]);
        for (int c = 0; c < n_chunks; ++c, ++gc) {
          mbar_wait(&empty[r], (gc / ST & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[r], P::kStageBytes);
            tma_load_3d(stage(r), &q_map, &full[r], c * kBChunk, item.row0,
                        item.bh);
            tma_load_3d(stage(r) + Chunk::kBytes, &k_map, &full[r],
                        c * kBChunk, i * kBKeys, item.bh);
          }
          if (++r == ST) r = 0;
        }
      }
    }
    return;
  }

  // Consumers.  Thread 32 w + 4 g + t holds rows 16 w + g and 16 w + g + 8
  // of the item's 64: sc[4 j + e] is row 16 w + g + 8 (e >> 1), key
  // 8 j + 2 t + (e & 1) of the tile; acc[h][4 j + e] the same rows, column
  // 128 h + 8 j + 2 t + (e & 1) of the column block.
  const int w = warp;
  const int g = lane / 4;
  const int t = lane % 4;
  const uint32_t ring_addr = shared_addr(smem);
  const uint32_t v_addr = shared_addr(v_buf(0));
  constexpr uint32_t kStageStep = P::kStageBytes >> 4;
  constexpr uint32_t kVStep = P::kVBytes >> 4;
  int gc = 0, gv = 0;  // chunks and key tiles consumed
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const WideItem item = wide_item(it, blocks, n_cb);
    const int q0 = item.row0;
    const size_t head = static_cast<size_t>(item.bh) * S;  // row (b, h, 0)
    float m2[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 units
    float l[2] = {0.f, 0.f};  // the lane's share of the row sums
    float acc[2][kFwdCols / 4] = {};  // O of the column block, unnormalised
    for (int i = 0; i < n_t; ++i, ++gv) {
      // S = Q K^T over the row's chunks, one chunk's products in flight
      // while the previous chunk's complete; a stage goes back once its
      // products have completed.
      float sc[kBKeys / 2];
      // The products of the stream's gc-th chunk (the tile's first starts
      // the sum).
      auto issue = [&](int first) {
        const int r = gc % ST;
        mbar_wait(&full[r], gc / ST & 1);
        const uint64_t qd = Chunk::k_major(ring_addr, 0) + r * kStageStep;
        const uint64_t kd = qd + (Chunk::kBytes >> 4);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBChunk / 16; ++ks)
          wgmma_ss(sc, qd + Chunk::k_step(ks), kd + Chunk::k_step(ks),
                   ks > 0 || !first);
        wgmma_commit();
        ++gc;
      };
      fence_regs(sc);
      issue(1);
      for (int c = 1; c < n_chunks; ++c) {
        issue(0);
        wgmma_wait<1>();
        mbar_arrive(&empty[(gc - 2) % ST]);
      }
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&empty[(gc - 1) % ST]);

      // The tile's V and key biases.
      const int vb = gv % 2;
      mbar_wait(&v_full[vb], gv / 2 & 1);
      const float* bias_s = bias_v + vb * kBKeys;
      // x = s scale log2 e + bias log2 e, branch-free, as in float32.
      const int k0 = i * kBKeys;
      const int n_keys = min(kBKeys, S - k0);
#pragma unroll
      for (int j = 0; j < kBKeys / 8; ++j) {
        const float2 bl =
            *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          const int row = q0 + 16 * w + g + 8 * (e >> 1);
          const bool replaced = CAUSAL & (k0 + kj > row);
          const float x = replaced ? kMaskedLog2
                                   : fmaf(sc[4 * j + e], scale_log2,
                                          e & 1 ? bl.y : bl.x);
          sc[4 * j + e] = kj < n_keys ? x : -CUDART_INF_F;
        }
      }
      // Online softmax; a row's 16 scores go through four chains each
      // (c = 2 (j & 1) + (e & 1)) for the max and the sum.
      float alpha[2];
      float mx[2][4];
#pragma unroll
      for (int j = 0; j < kBKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = mx[e >> 1][2 * (j & 1) + (e & 1)];
          x = j < 2 ? sc[4 * j + e] : fmaxf(x, sc[4 * j + e]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x =
            fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        x = fmaxf(m2[hh], x);
        alpha[hh] = exp2_approx(m2[hh] - x);
        m2[hh] = x;
      }
      float ps[2][4];
#pragma unroll
      for (int j = 0; j < kBKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(sc[4 * j + e] - m2[e >> 1]);
          sc[4 * j + e] = p;
          float& sum = ps[e >> 1][2 * (j & 1) + (e & 1)];
          sum = j < 2 ? p : sum + p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] = l[hh] * alpha[hh] +
                ((ps[hh][0] + ps[hh][1]) + (ps[hh][2] + ps[hh][3]));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int n = 0; n < kFwdCols / 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][4 * n + e] *= alpha[e >> 1];
        }
      }
      // O += P V: P packed to bf16 from the accumulators, V MN-major.
      uint32_t pa[kBKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBKeys / 16; ++kk) {
        acc_to_a(pa[kk], sc, kk);
        fence_regs(pa[kk]);
      }
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
      const uint64_t vd = VHalf::mn_major(v_addr, 0) + vb * kVStep;
#pragma unroll
      for (int kk = 0; kk < kBKeys / 16; ++kk) {
        wgmma_rs(acc[0], pa[kk], vd + VHalf::mn_step(16 * kk));
        wgmma_rs(acc[1], pa[kk],
                 vd + (VHalf::kBytes >> 4) + VHalf::mn_step(16 * kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
#pragma unroll
      for (int kk = 0; kk < kBKeys / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&v_empty[vb]);
    }

    const int c0 = item.cb * kFwdCols;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + 16 * w + g + 8 * hh;
      if (row >= S) continue;
      const float inv = 1.f / sum;
      bf16* o_row = o + (head + row) * ld + c0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kFwdCols / 16; ++j) {
          const int c = kFwdCols / 2 * h + 8 * j + 2 * t;
          if (c0 + c < ld)
            *reinterpret_cast<uint32_t*>(o_row + c) =
                pack_bf16(acc[h][4 * j + 2 * hh] * inv,
                          acc[h][4 * j + 2 * hh + 1] * inv);
        }
      }
      if (item.cb == 0 && t == 0) {
        const float mn = m2[hh] * kLn2;
        lse[head + row] = mn + logf(sum);
        row_max[head + row] = mn;
        row_sum[head + row] = sum;
      }
    }
  }
}

template <bool CAUSAL>
cudaError_t launch_fwd_wide_bf16(const CUtensorMap (&maps)[3],
                                 const uint8_t* key_mask, bf16* o, float* lse,
                                 float* row_max, float* row_sum, int H, int S,
                                 int Dh, int ld, int items,
                                 cudaStream_t stream) {
  static const cudaError_t attr =
      set_smem(flash_fwd_wide_bf16_kernel<CAUSAL>, Bf16Plan::kBytes);
  if (attr != cudaSuccess) return attr;
  flash_fwd_wide_bf16_kernel<CAUSAL>
      <<<min(sm_count(), items), kBThreads, Bf16Plan::kBytes, stream>>>(
          maps[0], maps[1], maps[2], key_mask, o, lse, row_max, row_sum, H,
          S, ld, (ld + kFwdCols - 1) / kFwdCols, softmax_scale(Dh, kLog2e),
          items);
  return cudaGetLastError();
}

}  // namespace

// The C entry points, with the narrow forwards' arguments.  q, k, v, o:
// (B, H, S, ld) float32 (the plain name) or bf16 (``_bf16``), contiguous,
// 16-byte aligned, ld = Dh rounded up to 16 bytes with columns Dh .. ld - 1
// of q, k and v zero; any Dh >= 1 (ops/attention.py sends Dh > 128).
// key_mask: (B, S) bool (nonzero = attend) or null.  lse, row_max,
// row_sum: (B, H, S) float32.  Each returns the cudaError_t of its launch
// (cudaErrorNotSupported if the CUDA driver cannot encode tensor maps).

extern "C" int flexdm_flash_attention_fwd_wide(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* o, void* lse, void* row_max, void* row_sum, int B, int H, int S,
    int Dh, int causal, void* stream) {
  const int ld = Dh < 1 ? 0 : row_width(Dh, 4);
  const int items = ld == 0 ? 0 : wide_items(B, H, S, ld, kFwdCols);
  if (items == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const cudaError_t err = wide_maps(maps, q, nullptr, k, v, B * H, S, ld);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* mf = static_cast<float*>(row_max);
  auto* sf = static_cast<float*>(row_sum);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      causal ? launch_fwd_wide<true>(maps, mask, of, lf, mf, sf, H, S, Dh,
                                     ld, items, st)
             : launch_fwd_wide<false>(maps, mask, of, lf, mf, sf, H, S, Dh,
                                      ld, items, st));
}

extern "C" int flexdm_flash_attention_fwd_wide_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* o, void* lse, void* row_max, void* row_sum, int B, int H, int S,
    int Dh, int causal, void* stream) {
  const int ld = Dh < 1 ? 0 : row_width(Dh, 8);
  const int items = ld == 0 ? 0 : wide_items(B, H, S, ld, kFwdCols);
  if (items == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const int BH = B * H;
  cudaError_t err = rows_map<kBChunk, kTile>(&maps[0], q, BH, S, ld);
  if (err == cudaSuccess)
    err = rows_map<kBChunk, kBKeys>(&maps[1], k, BH, S, ld);
  if (err == cudaSuccess)
    err = rows_map<kBChunk, kBKeys>(&maps[2], v, BH, S, ld);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* ob = static_cast<bf16*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* mf = static_cast<float*>(row_max);
  auto* sf = static_cast<float*>(row_sum);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      causal ? launch_fwd_wide_bf16<true>(maps, mask, ob, lf, mf, sf, H, S,
                                          Dh, ld, items, st)
             : launch_fwd_wide_bf16<false>(maps, mask, ob, lf, mf, sf, H, S,
                                           Dh, ld, items, st));
}
