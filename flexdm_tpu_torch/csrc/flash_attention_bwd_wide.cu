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

// Design.
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

#include "wgmma_tf32.cuh"

namespace {

constexpr int kChunk = 32;    // columns a chunk: one 128-byte TMA box
constexpr int kOther = 32;    // rows of an other-axis tile: the N
constexpr int kDqCols = 256;  // column block of dq
constexpr int kDkvCols = 128;  // column block of dk and dv
constexpr int kWideThreads = 2 * kWarpgroup;  // consumers, splitters

// Ring stages of ``stage_bytes`` beside ``fixed_bytes`` of tiles and
// vectors in a block's shared memory (with the alignment slack and the
// barriers), at most 4.
constexpr int wide_stages(int stage_bytes, int fixed_bytes) {
  const int n = (kSmemLimit - 1024 - fixed_bytes - 8) / (stage_bytes + 16);
  return n < 4 ? n : 4;
}

// Shared memory of a kernel whose column block is DC wide, with NT
// transposed tiles (K^T; or Q^T, dO^T), NV vectors over a tile's rows and
// NI over an item's (then delta's, used by dq).
template <int DC, int NT, int NV, int NI>
struct WidePlan {
  using Own = F32Tile<kChunk, kTile>;     // a chunk of Q, dO (or K, V)
  using Oth = F32Tile<kChunk, kOther>;    // a chunk of K, V (or Q, dO)
  // A transposed tile of the column block: (DC, kOther), K-major in the
  // 128-byte swizzled layout (store_transposed); chunk i at rows 32 i.
  using T = F32Tile<kOther, DC>;
  static constexpr int kChunksPerBlock = DC / kChunk;
  // A stage: own A, own B, other A, other B, each its hi then its lo.
  static constexpr int kOwnA = 0;
  static constexpr int kOwnB = 2 * Own::kBytes;
  static constexpr int kOthA = 4 * Own::kBytes;
  static constexpr int kOthB = kOthA + 2 * Oth::kBytes;
  static constexpr int kStageBytes = kOthB + 2 * Oth::kBytes;
  static constexpr int kLoadBytes = 2 * Own::kBytes + 2 * Oth::kBytes;
  static constexpr int kTBytes = NT * 2 * T::kBytes;
  // Vectors (floats): the tile's, the item's, delta.
  static constexpr int kItemVec = NV * kOther;
  static constexpr int kDelta = kItemVec + NI * kTile;
  static constexpr int kVecBytes = (kDelta + kTile) * 4;
  static constexpr int kStages =
      wide_stages(kStageBytes, kTBytes + kVecBytes);
  static_assert(kStages >= 2, "two stages fit");
  static constexpr int kTOffset = kStages * kStageBytes;
  static constexpr int kVecOffset = kTOffset + kTBytes;
  static constexpr int kBarOffset = kVecOffset + kVecBytes;
  static constexpr int kBytes = 1024 + kBarOffset + (2 * kStages + 1) * 8;
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

// dq: the tile's key biases; the item's rows' m (log2 units) and 1/l.
// dk/dv: the tile's rows' m, 1/l and delta; the item's keys' biases.
using DqPlan = WidePlan<kDqCols, 1, 1, 2>;
using DkvPlan = WidePlan<kDkvCols, 2, 3, 1>;

// What the dq splitters read for an item's rows to sum delta = rowsum(dO
// O): its O (beside the dO chunks they split) and where delta goes.
struct DqRows {
  const float* o;
  float* delta;
  int ld;
};

// The ring's barriers: per stage loaded (TMA bytes) and full (the
// splitters' arrivals), and t_free (the consumers' thread 0, once a tile):
// the tile's second products have completed and its vectors are read, so
// the splitters may write the next tile's transposed chunks and vectors.
struct WideBarriers {
  uint64_t* loaded;
  uint64_t* full;
  uint64_t* t_free;
  __device__ WideBarriers(unsigned char* at, int stages)
      : loaded(reinterpret_cast<uint64_t*>(at)),
        full(loaded + stages),
        t_free(full + stages) {}
  __device__ void init(int stages) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], kWarpgroup);
    }
    mbar_init(t_free, 1);
  }
};

// An item: head bh, its 64 rows from row0, column block cb.  Items run
// column block fastest, then the row block, then the head.
struct WideItem {
  int bh, row0, cb;
};
__device__ __forceinline__ WideItem wide_item(int it, int blocks, int n_cb) {
  const int rest = it / n_cb;
  return {rest / blocks, rest % blocks * kTile, it % n_cb};
}

// Other-axis tiles of an item: every tile of the head, or with ``causal_dq``
// the key tiles up to the item's last row.
__device__ __forceinline__ int wide_tiles(int row0, int S, bool causal_dq) {
  const int n = (S + kOther - 1) / kOther;
  return causal_dq ? min(n, (min(row0 + kTile, S) + kOther - 1) / kOther)
                   : n;
}

// The chunks a block's consumer thread 0 copies, in the order the
// splitters and consumers take them: per item, per tile, per chunk.
struct ChunkCursor {
  int item, tile, chunk, tiles;
  WideItem at;
};

// The splitters' unit of a landed chunk (an F32Tile<kChunk, ROWS>): the
// rows r0 + 2m (m < 4), columns c .. c + 3, 16 bytes a row.  A thread
// loads all its units of a chunk before it splits any, so their loads are
// in flight together; then each value x is split into hi = tf32(x) over
// the tile in place and lo = x - hi into ``lo`` (the same layout).
template <int ROWS>
__device__ __forceinline__ void load_unit(float4 (&x)[4],
                                          const unsigned char* tile, int r0,
                                          int c) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    x[m] = *reinterpret_cast<const float4*>(
        tile + F32Tile<kChunk, ROWS>::offset(r0 + 2 * m, c));
}

template <int ROWS>
__device__ __forceinline__ void split_unit(const float4 (&x)[4],
                                           unsigned char* tile,
                                           unsigned char* lo, int r0, int c,
                                           uint32_t (&h)[4][4],
                                           uint32_t (&l)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int off = F32Tile<kChunk, ROWS>::offset(r0 + 2 * m, c);
    split_tf32(x[m].x, h[m][0], l[m][0]);
    split_tf32(x[m].y, h[m][1], l[m][1]);
    split_tf32(x[m].z, h[m][2], l[m][2]);
    split_tf32(x[m].w, h[m][3], l[m][3]);
    *reinterpret_cast<uint4*>(tile + off) =
        make_uint4(h[m][0], h[m][1], h[m][2], h[m][3]);
    *reinterpret_cast<uint4*>(lo + off) =
        make_uint4(l[m][0], l[m][1], l[m][2], l[m][3]);
  }
}

// The own tiles' unit of thread lt (split_tile's for 64 rows): rows
// 8 (lt / 16) + lt / 8 % 2 + 2m, columns 4 (lt % 8) ..; the 8 threads of a
// quarter warp read one row's 8 swizzled 16-byte chunks.
struct OwnUnit {
  int r0, c;
  __device__ explicit OwnUnit(int lt) : r0(8 * (lt / 16) + lt / 8 % 2),
                                        c(4 * (lt % 8)) {}
};

// The other tiles' unit of thread idx (0 .. 63): columns 4 cq .. of the
// rows r0 + 2m (m < 4) of row group rg, r0 = 8 (rg / 2) + rg % 2, whose k
// positions acc_order(r0 + 2m) = 4 rg + m make one 16-byte chunk of a
// transposed row.  The 8 threads of a quarter warp take cq = 0 .. 7 and the
// row groups 0, 6, 1, 7, 4, 2, 5, 3 (by cq) xor idx / 8: their 16-byte
// loads and in-place stores fall in the swizzle slots cq ^ (rg % 2) ^ 2m,
// and their transposed stores in rg ^ (n % 8) = rg ^ 4 (cq % 2) ^ e, 8
// different slots each, so no access of the split has a bank conflict
// (split_tile's transposed stores into a TransposedTile hit 2 slots of 8).
struct OtherUnit {
  int rg, r0, c;
  __device__ explicit OtherUnit(int idx)
      : rg(((0x35247160u >> (4 * (idx % 8))) & 7) ^ (idx / 8)),
        r0(8 * (rg / 2) + rg % 2),
        c(4 * (idx % 8)) {}
};

// The split terms of an other tile's unit written transposed into rows
// 0 .. 31 of an F32Tile<kOther, DC> (``t_hi``, ``t_lo``): element (r, n)
// of the chunk at row n, k position acc_order(r), the K-major B operand
// second_product reads.
__device__ __forceinline__ void store_transposed(const OtherUnit& u,
                                                 const uint32_t (&h)[4][4],
                                                 const uint32_t (&l)[4][4],
                                                 unsigned char* t_hi,
                                                 unsigned char* t_lo) {
  using Dst = F32Tile<kOther, kOther>;  // rows 0 .. 31 of the column block's
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int to = Dst::offset(u.c + e, 4 * u.rg);
    *reinterpret_cast<uint4*>(t_hi + to) =
        make_uint4(h[0][e], h[1][e], h[2][e], h[3][e]);
    *reinterpret_cast<uint4*>(t_lo + to) =
        make_uint4(l[0][e], l[1][e], l[2][e], l[3][e]);
  }
}

// Everything both kernels share: the block's place, its shared memory and
// barriers, the copies, and the splitters' loop.
template <class P, bool kDq, bool CAUSAL>
struct WideBlock {
  unsigned char* smem;
  WideBarriers bar;
  int S, n_chunks, blocks, n_cb, n_items;

  __device__ WideBlock(unsigned char* base, int S_, int ld, int n_cb_,
                       int n_items_)
      : smem(base),
        bar(base + P::kBarOffset, P::kStages),
        S(S_),
        n_chunks((ld + kChunk - 1) / kChunk),
        blocks((S_ + kTile - 1) / kTile),
        n_cb(n_cb_),
        n_items(n_items_) {}

  __device__ __forceinline__ unsigned char* stage(int r) const {
    return smem + r * P::kStageBytes;
  }
  __device__ __forceinline__ unsigned char* transposed(int i) const {
    return smem + P::kTOffset + i * 2 * P::T::kBytes;
  }
  __device__ __forceinline__ float* vec() const {
    return reinterpret_cast<float*>(smem + P::kVecOffset);
  }
  __device__ __forceinline__ int tiles(int row0) const {
    return wide_tiles(row0, S, kDq && CAUSAL);
  }

  __device__ __forceinline__ ChunkCursor start(int first) const {
    ChunkCursor cur{first, 0, 0, 0, wide_item(first, blocks, n_cb)};
    if (first < n_items) cur.tiles = tiles(cur.at.row0);
    return cur;
  }

  // Copies the cursor's chunk (own tiles: 64 rows of the item; other
  // tiles: the tile's 32 rows) into stage r and steps the cursor.
  __device__ __forceinline__ void load(ChunkCursor& cur, int r, const CUtensorMap* own_a,
                       const CUtensorMap* own_b, const CUtensorMap* oth_a,
                       const CUtensorMap* oth_b) const {
    if (cur.item >= n_items) return;
    unsigned char* st = stage(r);
    uint64_t* b = &bar.loaded[r];
    const int col = cur.chunk * kChunk;
    mbar_arrive_expect_tx(b, P::kLoadBytes);
    tma_load_3d(st + P::kOwnA, own_a, b, col, cur.at.row0, cur.at.bh);
    tma_load_3d(st + P::kOwnB, own_b, b, col, cur.at.row0, cur.at.bh);
    tma_load_3d(st + P::kOthA, oth_a, b, col, cur.tile * kOther, cur.at.bh);
    tma_load_3d(st + P::kOthB, oth_b, b, col, cur.tile * kOther, cur.at.bh);
    if (++cur.chunk < n_chunks) return;
    cur.chunk = 0;
    if (++cur.tile < cur.tiles) return;
    cur.tile = 0;
    cur.item += gridDim.x;
    if (cur.item < n_items) {
      cur.at = wide_item(cur.item, blocks, n_cb);
      cur.tiles = tiles(cur.at.row0);
    }
  }

  // The splitters (threads lt = 0 .. 127 of the second warpgroup): every
  // landed chunk split in place, the column block's other-axis chunks also
  // transposed (B too with kTransB), the tile's vectors
  // (``tile_vec(item, tile, lt, v)``, NV floats of row lt < kOther) and, at
  // the item's first tile, the item's (``item_vec(item, lt, v)``, NI floats
  // of row lt < kTile): written at the tile's first chunk of the column
  // block, once the consumers are done with the previous tile's.  Their
  // reads come before the waits, to overlap them.  With kDq they also sum
  // each item's delta at its first tile, from the dO chunks as they land
  // (own B) and O read beside them, in a fixed order (each thread's 4 rows
  // by 4 columns a chunk, the chunks in turn, then the 8 threads of a row
  // by shuffles), for the consumers and, from column block 0, to
  // ``rows.delta``.
  template <bool kTransB, int NV, int NI, class TileVec, class ItemVec>
  __device__ __forceinline__ void split_all(int lt, TileVec tile_vec,
                                            ItemVec item_vec,
                                            const DqRows& rows) const {
    using Own = typename P::Own;
    using Oth = typename P::Oth;
    constexpr int CPB = P::kChunksPerBlock;
    // The thread's units: one of each own tile, one of other tile A (the
    // first half of the threads) or B (the second).
    const OwnUnit own(lt);
    const bool half_a = lt < kWarpgroup / 2;
    const OtherUnit oth(lt % (kWarpgroup / 2));
    const int oth_at = half_a ? P::kOthA : P::kOthB;
    int s = 0;
    for (int it = blockIdx.x, g = 0; it < n_items; it += gridDim.x) {
      const WideItem item = wide_item(it, blocks, n_cb);
      const size_t head = static_cast<size_t>(item.bh) * S;
      const int n_t = tiles(item.row0);
      const int c_first = item.cb * CPB;
      float iv[NI];
      item_vec(item, lt, iv);
      for (int j = 0; j < n_t; ++j, ++g) {
        float v[NV];
        tile_vec(item, j, lt, v);
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // dq: dO . O of the rows
        for (int c = 0; c < n_chunks; ++c, ++s) {
          const int r = s % P::kStages;
          const bool sum_delta = kDq && j == 0;
          float4 o4[4];
          if (sum_delta) {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int row = item.row0 + own.r0 + 2 * m;
              const int col = c * kChunk + own.c;
              o4[m] = row < S && col < rows.ld
                          ? *reinterpret_cast<const float4*>(
                                rows.o + (head + row) * rows.ld + col)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
          mbar_wait(&bar.loaded[r], s / P::kStages & 1);
          unsigned char* st = stage(r);
          float4 xa[4], xb[4], xo[4];
          load_unit<kTile>(xa, st + P::kOwnA, own.r0, own.c);
          load_unit<kTile>(xb, st + P::kOwnB, own.r0, own.c);
          load_unit<kOther>(xo, st + oth_at, oth.r0, oth.c);
          if (sum_delta) {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              part[m] = fmaf(xb[m].x, o4[m].x, part[m]);
              part[m] = fmaf(xb[m].y, o4[m].y, part[m]);
              part[m] = fmaf(xb[m].z, o4[m].z, part[m]);
              part[m] = fmaf(xb[m].w, o4[m].w, part[m]);
            }
          }
          uint32_t h[4][4], l[4][4];
          split_unit<kTile>(xa, st + P::kOwnA, st + P::kOwnA + Own::kBytes,
                            own.r0, own.c, h, l);
          split_unit<kTile>(xb, st + P::kOwnB, st + P::kOwnB + Own::kBytes,
                            own.r0, own.c, h, l);
          split_unit<kOther>(xo, st + oth_at, st + oth_at + Oth::kBytes,
                             oth.r0, oth.c, h, l);
          const int cib = c - c_first;  // the chunk in the column block
          if (cib >= 0 && cib < CPB) {
            if (cib == 0) {
              // The consumers are done with the previous tile's transposed
              // chunks and vectors.
              if (g > 0) mbar_wait(bar.t_free, (g - 1) & 1);
              if (lt < kOther) {
#pragma unroll
                for (int i = 0; i < NV; ++i) vec()[i * kOther + lt] = v[i];
              }
              if (j == 0 && lt < kTile) {
#pragma unroll
                for (int i = 0; i < NI; ++i)
                  vec()[P::kItemVec + i * kTile + lt] = iv[i];
              }
            }
            // Other tile A always goes transposed (K^T; Q^T), B with
            // kTransB (dO^T): warp-uniform.
            if (half_a || kTransB) {
              unsigned char* t = transposed(half_a ? 0 : 1) + cib * Oth::kBytes;
              store_transposed(oth, h, l, t, t + P::T::kBytes);
            }
          }
          if (sum_delta && c == n_chunks - 1) {
            // The row's 8 threads (consecutive lanes, lt % 8 = 0 .. 7) add
            // their sums;
            // the block's first chunk has been passed, so the consumers are
            // done with the previous item's delta.
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              float x = part[m];
              x += __shfl_xor_sync(0xffffffffu, x, 1);
              x += __shfl_xor_sync(0xffffffffu, x, 2);
              x += __shfl_xor_sync(0xffffffffu, x, 4);
              const int row = own.r0 + 2 * m;
              if (lt % 8 == 0) {
                vec()[P::kDelta + row] = x;
                if (item.cb == 0 && item.row0 + row < S)
                  rows.delta[head + item.row0 + row] = x;
              }
            }
          }
          fence_proxy_async();
          mbar_arrive(&bar.full[r]);
        }
      }
    }
  }

  // Hands stage r back once every consumer warp is done with it (a named
  // barrier of the consumer warps); thread 0 refills it (``refill(r)``).
  // Every warp waits: with warps 1-3 only arriving, they can reach the next
  // release first (their products need not wait for warp 0's), and their
  // second arrivals complete the barrier without warp 0, which then waits
  // for good (a hang on the card).
  template <class Refill>
  __device__ __forceinline__ void release(int lt, Refill& refill,
                                          int r) const {
    named_sync(1, kWarpgroup);
    if (lt == 0) refill(r);
  }

  // Issues the score products of the stream's ``s``-th chunk (stage
  // s % kStages, once split): the tile's first chunk starts the sums.
  __device__ __forceinline__ void issue_chunk(
      float (&sc_small)[kOther / 2], float (&sc_large)[kOther / 2],
      float (&dp_small)[kOther / 2], float (&dp_large)[kOther / 2], int s,
      int first) const {
    using Own = typename P::Own;
    using Oth = typename P::Oth;
    const int r = s % P::kStages;
    mbar_wait(&bar.full[r], s / P::kStages & 1);
    const uint32_t st = shared_addr(stage(r));
    wgmma_fence();
    chunk_score_product<kOther>(sc_small, sc_large, st + P::kOwnA,
                                st + P::kOwnA + Own::kBytes, st + P::kOthA,
                                st + P::kOthA + Oth::kBytes, first);
    chunk_score_product<kOther>(dp_small, dp_large, st + P::kOwnB,
                                st + P::kOwnB + Own::kBytes, st + P::kOthB,
                                st + P::kOthB + Oth::kBytes, first);
    wgmma_commit();
  }

  // The consumers' score products of one tile: s = own_a oth_a^T and
  // dp = own_b oth_b^T over the row's chunks, from the stream's ``s``-th
  // chunk on (``s`` is advanced), one chunk's products in flight while the
  // previous chunk's complete.  A stage is handed back once every product
  // reading it has completed in every consumer warp (release).  The
  // consumers read the stages only through their
  // products (async proxy, as the copy), and no shared load of theirs is in
  // flight here (tools/torch_sass_hazards.py, "tma"), so no proxy fence
  // stands before the copy.  On return sc and dp hold the tile's scores
  // (large + small terms).
  template <class Refill>
  __device__ __forceinline__ void scores(float (&sc)[kOther / 2],
                                         float (&dp)[kOther / 2], int& s,
                                         int lt, Refill& refill) const {
    float sc_small[kOther / 2], sc_large[kOther / 2];
    float dp_small[kOther / 2], dp_large[kOther / 2];
    fence_regs(sc_small);
    fence_regs(sc_large);
    fence_regs(dp_small);
    fence_regs(dp_large);
    issue_chunk(sc_small, sc_large, dp_small, dp_large, s++, 1);
    for (int c = 1; c < n_chunks; ++c) {
      issue_chunk(sc_small, sc_large, dp_small, dp_large, s++, 0);
      wgmma_wait<1>();
      release(lt, refill, (s - 2) % P::kStages);
    }
    wgmma_wait<0>();
    fence_regs(sc_small);
    fence_regs(sc_large);
    fence_regs(dp_small);
    fence_regs(dp_large);
    release(lt, refill, (s - 1) % P::kStages);
#pragma unroll
    for (int i = 0; i < kOther / 2; ++i) {
      sc[i] = sc_large[i] + sc_small[i];
      dp[i] = dp_large[i] + dp_small[i];
    }
  }
};

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
    blk.template split_all<false, 1, 2>(
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
      float sc[kOther / 2], dp[kOther / 2];
      blk.scores(sc, dp, s, lt, refill);
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
    blk.template split_all<true, 3, 1>(
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
      float sc[kOther / 2], dp[kOther / 2];
      blk.scores(sc, dp, s, lt, refill);
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

// A launch's items (B H row blocks x column blocks of ``cols``), or 0 if
// they do not fit an int.
int wide_items(int B, int H, int S, int ld, int cols) {
  if (bad_shape(B, H, S)) return 0;
  const long long n = static_cast<long long>(B) * H *
                      ((S + kTile - 1) / kTile) * ((ld + cols - 1) / cols);
  return n > INT_MAX ? 0 : static_cast<int>(n);
}

// The maps of the own tensors (64-row boxes) and the other tensors (32-row
// boxes), one 32-column chunk a box.
cudaError_t wide_maps(CUtensorMap (&maps)[4], const void* own_a,
                      const void* own_b, const void* oth_a, const void* oth_b,
                      int BH, int S, int ld) {
  cudaError_t err = f32_rows_map<kChunk, kTile>(&maps[0], own_a, BH, S, ld);
  if (err == cudaSuccess)
    err = f32_rows_map<kChunk, kTile>(&maps[1], own_b, BH, S, ld);
  if (err == cudaSuccess)
    err = f32_rows_map<kChunk, kOther>(&maps[2], oth_a, BH, S, ld);
  if (err == cudaSuccess)
    err = f32_rows_map<kChunk, kOther>(&maps[3], oth_b, BH, S, ld);
  return err;
}

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
