// The chunk pipeline of the float32 wide kernels (head dims above 128) on
// Hopper (sm_90a): the forward (flash_attention_fwd_wide.cu) and the dq and
// dk/dv kernels (flash_attention_bwd_wide.cu).  Products are
// wgmma_tf32.cuh's split-TF32 warpgroup products; mbarriers, TMA and the
// tensor-map encode are hopper.cuh's.
//
// An item is 64 rows of one head (query rows for the forward and dq, keys
// for dk/dv): the wgmma M, and one column block of its outputs (DC columns
// of O, dq, or dk and dv).  A block, one an SM, is one consumer warpgroup
// and one splitter warpgroup (256 threads, up to 255 registers); it takes
// the items blockIdx.x, + gridDim.x, ... of the launch, column block
// fastest, so neighbouring SMs share a row's reads through L2.
//
// The other axis comes in tiles of 32 keys (the forward, dq) or query rows
// (dk/dv), and each tile's row in chunks of 32 columns, one 128-byte
// swizzled TMA box each.  A stage of the ring holds the chunk of the own
// tiles (Q; Q and dO; K and V: 64 rows) and of both other tiles (K and V;
// Q and dO: 32 rows), each tile's hi in place and its lo beside it.  Tensor
// maps are __grid_constant__ over (B H, S, ld) views, so rows past S and
// columns past ld arrive as zeros, never as the next head's.  The
// consumers' thread 0 refills a stage once every consumer warp is done with
// it, with the stream's next chunk, across tiles and items, so the next
// item's chunks land while this one ends.
//
// The splitter warpgroup splits every landed chunk once, in shared memory
// (hi = tf32(x) in place, lo = x - hi beside it), and writes the chunks of
// the item's column block transposed (TF32 wgmma reads both operands
// K-major only) into the tile's transposed tiles (K^T for dq; Q^T and dO^T
// for dk/dv; V^T for the forward), rows at acc_order, in the 128-byte
// swizzled K-major layout, with a unit order that keeps every load and
// store of the split free of bank conflicts (OtherUnit); with them the
// tile's vectors and, at an item's first tile, the item's.  It writes
// those once the consumers have finished the previous tile's second
// products (the t_free mbarrier); the other chunks run ahead.
//
// Score products take a chunk's k8 steps as SS m64n32k8 wgmmas, chained over
// the row's chunks in two accumulator sets, the small terms (lo hi' + hi
// lo') and the large (hi hi'), added in float32 when the row is done
// (chunk_score_product; wgmma_tf32.cuh says why).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kChunk = 32;    // columns a chunk: one 128-byte TMA box
constexpr int kOther = 32;    // rows of an other-axis tile: the N
constexpr int kWideThreads = 2 * kWarpgroup;  // consumers, splitters

// Ring stages of ``stage_bytes`` beside ``fixed_bytes`` of tiles and
// vectors in a block's shared memory (with the alignment slack and the
// barriers), at most ``most``.
constexpr int wide_stages(int stage_bytes, int fixed_bytes, int most) {
  const int n = (kSmemLimit - 1024 - fixed_bytes - 8) / (stage_bytes + 16);
  return n < most ? n : most;
}

// Shared memory of a kernel whose column block is DC wide, with NT
// transposed tiles, NV vectors over a tile's rows and NI over an item's
// (then delta's, used by dq).  FWD: the forward's stage, one own tile (Q)
// whose chunk is split in place, other tile A (K) split in place only and
// other tile B (V) only transposed, and only in the column block (where
// alone it is copied); else the backward's, two own tiles, both other
// tiles split in place, A transposed and B with NT == 2 (dk/dv's dO^T).
template <int DC, int NT, int NV, int NI, bool FWD = false>
struct WidePlan {
  using Own = F32Tile<kChunk, kTile>;     // a chunk of Q, dO (or K, V)
  using Oth = F32Tile<kChunk, kOther>;    // a chunk of K, V (or Q, dO)
  // A transposed tile of the column block: (DC, kOther), K-major in the
  // 128-byte swizzled layout (store_transposed); chunk i at rows 32 i.
  using T = F32Tile<kOther, DC>;
  static constexpr int kChunksPerBlock = DC / kChunk;
  static constexpr int kOwnTiles = FWD ? 1 : 2;
  static constexpr bool kTransA = !FWD;
  static constexpr bool kInPlaceB = !FWD;
  static constexpr bool kTransB = FWD || NT == 2;
  static constexpr bool kBEverywhere = !FWD;
  // A stage: the own tiles, other A, other B, each its hi then its lo.
  static constexpr int kOwnA = 0;
  static constexpr int kOwnB = 2 * Own::kBytes;  // with two own tiles
  static constexpr int kOthA = kOwnTiles * 2 * Own::kBytes;
  static constexpr int kOthB = kOthA + 2 * Oth::kBytes;
  static constexpr int kStageBytes = kOthB + 2 * Oth::kBytes;
  // The bytes a chunk's copies bring: other tile B's last.
  static constexpr int kLoadBytes = kOwnTiles * Own::kBytes + 2 * Oth::kBytes;
  static constexpr int kTBytes = NT * 2 * T::kBytes;
  // Vectors (floats): the tile's, the item's, delta.
  static constexpr int kItemVec = NV * kOther;
  static constexpr int kDelta = kItemVec + NI * kTile;
  static constexpr int kVecBytes = (kDelta + kTile) * 4;
  // The forward's 32 KB stages: five fit beside V^T (2% faster than four
  // at (256, 8, 50, 256) on an H100 at 700 W); the backward's 48 KB ones:
  // three.
  static constexpr int kStages =
      wide_stages(kStageBytes, kTBytes + kVecBytes, FWD ? 5 : 4);
  static_assert(kStages >= 2, "two stages fit");
  static constexpr int kTOffset = kStages * kStageBytes;
  static constexpr int kVecOffset = kTOffset + kTBytes;
  static constexpr int kBarOffset = kVecOffset + kVecBytes;
  static constexpr int kBytes = 1024 + kBarOffset + (2 * kStages + 1) * 8;
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

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
// in flight together; then each value x is split into hi = tf32(x) and lo
// = x - hi (split_regs), written over the tile in place and into ``lo``
// (the same layout) by split_unit.
template <int ROWS>
__device__ __forceinline__ void load_unit(float4 (&x)[4],
                                          const unsigned char* tile, int r0,
                                          int c) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    x[m] = *reinterpret_cast<const float4*>(
        tile + F32Tile<kChunk, ROWS>::offset(r0 + 2 * m, c));
}

__device__ __forceinline__ void split_regs(const float4 (&x)[4],
                                           uint32_t (&h)[4][4],
                                           uint32_t (&l)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    split_tf32(x[m].x, h[m][0], l[m][0]);
    split_tf32(x[m].y, h[m][1], l[m][1]);
    split_tf32(x[m].z, h[m][2], l[m][2]);
    split_tf32(x[m].w, h[m][3], l[m][3]);
  }
}

template <int ROWS>
__device__ __forceinline__ void split_unit(const float4 (&x)[4],
                                           unsigned char* tile,
                                           unsigned char* lo, int r0, int c,
                                           uint32_t (&h)[4][4],
                                           uint32_t (&l)[4][4]) {
  split_regs(x, h, l);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int off = F32Tile<kChunk, ROWS>::offset(r0 + 2 * m, c);
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

// Everything the wide kernels share: the block's place, its shared memory
// and barriers, the copies, the splitters' loop and the consumers' score
// products.  kDq: dq's causal tiles and its delta.
template <class P, bool kDq, bool CAUSAL>
struct WideBlock {
  // Score products a chunk: s = own_a oth_a^T, and dp = own_b oth_b^T
  // with two own tiles.
  static constexpr int NP = P::kOwnTiles;
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
  // The index of chunk c in column block cb (in the block: 0 .. CPB - 1).
  static __device__ __forceinline__ int in_block(int c, int cb) {
    return c - cb * P::kChunksPerBlock;
  }

  __device__ __forceinline__ ChunkCursor start(int first) const {
    ChunkCursor cur{first, 0, 0, 0, wide_item(first, blocks, n_cb)};
    if (first < n_items) cur.tiles = tiles(cur.at.row0);
    return cur;
  }

  // Copies the cursor's chunk (own tiles: 64 rows of the item; other
  // tiles: the tile's 32 rows; other tile B outside the column block only
  // with kBEverywhere) into stage r and steps the cursor.
  __device__ __forceinline__ void load(ChunkCursor& cur, int r,
                                       const CUtensorMap* own_a,
                                       const CUtensorMap* own_b,
                                       const CUtensorMap* oth_a,
                                       const CUtensorMap* oth_b) const {
    if (cur.item >= n_items) return;
    unsigned char* st = stage(r);
    uint64_t* b = &bar.loaded[r];
    const int col = cur.chunk * kChunk;
    const int cib = in_block(cur.chunk, cur.at.cb);
    const bool with_b =
        P::kBEverywhere || (cib >= 0 && cib < P::kChunksPerBlock);
    mbar_arrive_expect_tx(
        b, P::kLoadBytes - (with_b ? 0 : P::Oth::kBytes));
    tma_load_3d(st + P::kOwnA, own_a, b, col, cur.at.row0, cur.at.bh);
    if constexpr (NP == 2)
      tma_load_3d(st + P::kOwnB, own_b, b, col, cur.at.row0, cur.at.bh);
    tma_load_3d(st + P::kOthA, oth_a, b, col, cur.tile * kOther, cur.at.bh);
    if (with_b)
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
  // landed chunk split in place (other tile B with kInPlaceB), the column
  // block's other-axis chunks also transposed (A with kTransA, B with
  // kTransB), the tile's vectors (``tile_vec(item, tile, lt, v)``, NV
  // floats of row lt < kOther) and, at the item's first tile, the item's
  // (``item_vec(item, lt, v)``, NI floats of row lt < kTile): written at the
  // tile's first chunk of the column block, once the consumers are done
  // with the previous tile's.  Their reads come before the waits, to
  // overlap them.  With kDq they also sum each item's delta at its first
  // tile, from the dO chunks as they land (own B) and O read beside them,
  // in a fixed order (each thread's 4 rows by 4 columns a chunk, the chunks
  // in turn, then the 8 threads of a row by shuffles), for the consumers
  // and, from column block 0, to ``rows.delta``.
  template <int NV, int NI, class TileVec, class ItemVec>
  __device__ __forceinline__ void split_all(int lt, TileVec tile_vec,
                                            ItemVec item_vec,
                                            const DqRows& rows) const {
    using Own = typename P::Own;
    using Oth = typename P::Oth;
    constexpr int CPB = P::kChunksPerBlock;
    // The thread's units: one of each own tile, one of other tile A (the
    // first half of the threads) or B (the second): warp-uniform.
    const OwnUnit own(lt);
    const bool half_a = lt < kWarpgroup / 2;
    const OtherUnit oth(lt % (kWarpgroup / 2));
    const int oth_at = half_a ? P::kOthA : P::kOthB;
    const bool oth_in_place = half_a || P::kInPlaceB;
    const bool oth_trans = half_a ? P::kTransA : P::kTransB;
    // Other tile A always goes to transposed tile 0 (K^T; Q^T), B to the
    // next one (dO^T; the forward's V^T, its only one).
    unsigned char* const oth_t = transposed(half_a || !P::kTransA ? 0 : 1);
    int s = 0;
    for (int it = blockIdx.x, g = 0; it < n_items; it += gridDim.x) {
      const WideItem item = wide_item(it, blocks, n_cb);
      const size_t head = static_cast<size_t>(item.bh) * S;
      const int n_t = tiles(item.row0);
      float iv[NI > 0 ? NI : 1];
      if constexpr (NI > 0) item_vec(item, lt, iv);
      for (int j = 0; j < n_t; ++j, ++g) {
        float v[NV];
        tile_vec(item, j, lt, v);
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // dq: dO . O of the rows
        for (int c = 0; c < n_chunks; ++c, ++s) {
          const int r = s % P::kStages;
          const bool sum_delta = kDq && j == 0;
          const int cib = in_block(c, item.cb);  // the chunk in the block
          const bool block_chunk = cib >= 0 && cib < CPB;
          // The thread's other tile landed (B only in the column block
          // without kBEverywhere).
          const bool oth_landed = half_a || P::kBEverywhere || block_chunk;
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
          if constexpr (NP == 2)
            load_unit<kTile>(xb, st + P::kOwnB, own.r0, own.c);
          if (oth_landed) load_unit<kOther>(xo, st + oth_at, oth.r0, oth.c);
          if constexpr (kDq) {
            if (sum_delta) {
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                part[m] = fmaf(xb[m].x, o4[m].x, part[m]);
                part[m] = fmaf(xb[m].y, o4[m].y, part[m]);
                part[m] = fmaf(xb[m].z, o4[m].z, part[m]);
                part[m] = fmaf(xb[m].w, o4[m].w, part[m]);
              }
            }
          }
          uint32_t h[4][4], l[4][4];
          split_unit<kTile>(xa, st + P::kOwnA, st + P::kOwnA + Own::kBytes,
                            own.r0, own.c, h, l);
          if constexpr (NP == 2)
            split_unit<kTile>(xb, st + P::kOwnB, st + P::kOwnB + Own::kBytes,
                              own.r0, own.c, h, l);
          if (oth_in_place)
            split_unit<kOther>(xo, st + oth_at, st + oth_at + Oth::kBytes,
                               oth.r0, oth.c, h, l);
          else if (oth_landed)
            split_regs(xo, h, l);
          if (block_chunk) {
            if (cib == 0) {
              // The consumers are done with the previous tile's transposed
              // chunks and vectors.
              if (g > 0) mbar_wait(bar.t_free, (g - 1) & 1);
              if (lt < kOther) {
#pragma unroll
                for (int i = 0; i < NV; ++i) vec()[i * kOther + lt] = v[i];
              }
              if (NI > 0 && j == 0 && lt < kTile) {
#pragma unroll
                for (int i = 0; i < NI; ++i)
                  vec()[P::kItemVec + i * kTile + lt] = iv[i];
              }
            }
            if (oth_trans) {
              unsigned char* t = oth_t + cib * Oth::kBytes;
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
  __device__ __forceinline__ void issue_chunk(float (&small)[NP][kOther / 2],
                                              float (&large)[NP][kOther / 2],
                                              int s, int first) const {
    using Own = typename P::Own;
    using Oth = typename P::Oth;
    const int r = s % P::kStages;
    mbar_wait(&bar.full[r], s / P::kStages & 1);
    const uint32_t st = shared_addr(stage(r));
    wgmma_fence();
    chunk_score_product<kOther>(small[0], large[0], st + P::kOwnA,
                                st + P::kOwnA + Own::kBytes, st + P::kOthA,
                                st + P::kOthA + Oth::kBytes, first);
    if constexpr (NP == 2)
      chunk_score_product<kOther>(small[1], large[1], st + P::kOwnB,
                                  st + P::kOwnB + Own::kBytes, st + P::kOthB,
                                  st + P::kOthB + Oth::kBytes, first);
    wgmma_commit();
  }

  // The consumers' score products of one tile: sc[0] = own_a oth_a^T (and
  // sc[1] = own_b oth_b^T) over the row's chunks, from the stream's
  // ``s``-th chunk on (``s`` is advanced), one chunk's products in flight
  // while the previous chunk's complete.  A stage is handed back once every
  // product reading it has completed in every consumer warp (release).
  // The consumers read the stages only through their products (async
  // proxy, as the copy), and no shared load of theirs is in flight here
  // (tools/torch_sass_hazards.py, "tma"), so no proxy fence stands before
  // the copy.  On return sc holds the tile's scores (large + small terms).
  template <class Refill>
  __device__ __forceinline__ void scores(float (&sc)[NP][kOther / 2], int& s,
                                         int lt, Refill& refill) const {
    float small[NP][kOther / 2], large[NP][kOther / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_regs(small[p]);
      fence_regs(large[p]);
    }
    issue_chunk(small, large, s++, 1);
    for (int c = 1; c < n_chunks; ++c) {
      issue_chunk(small, large, s++, 0);
      wgmma_wait<1>();
      release(lt, refill, (s - 2) % P::kStages);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_regs(small[p]);
      fence_regs(large[p]);
    }
    release(lt, refill, (s - 1) % P::kStages);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < kOther / 2; ++i) sc[p][i] = large[p][i] + small[p][i];
    }
  }
};

// A launch's items (B H row blocks x column blocks of ``cols``), or 0 if
// they do not fit an int.
inline int wide_items(int B, int H, int S, int ld, int cols) {
  if (bad_shape(B, H, S)) return 0;
  const long long n = static_cast<long long>(B) * H *
                      ((S + kTile - 1) / kTile) * ((ld + cols - 1) / cols);
  return n > INT_MAX ? 0 : static_cast<int>(n);
}

// The maps of the own tensors (64-row boxes) and the other tensors (32-row
// boxes), one 32-column chunk a box (own_b null: none).
inline cudaError_t wide_maps(CUtensorMap (&maps)[4], const void* own_a,
                             const void* own_b, const void* oth_a,
                             const void* oth_b, int BH, int S, int ld) {
  cudaError_t err = f32_rows_map<kChunk, kTile>(&maps[0], own_a, BH, S, ld);
  if (err == cudaSuccess && own_b != nullptr)
    err = f32_rows_map<kChunk, kTile>(&maps[1], own_b, BH, S, ld);
  if (err == cudaSuccess)
    err = f32_rows_map<kChunk, kOther>(&maps[2], oth_a, BH, S, ld);
  if (err == cudaSuccess)
    err = f32_rows_map<kChunk, kOther>(&maps[3], oth_b, BH, S, ld);
  return err;
}

}  // namespace
