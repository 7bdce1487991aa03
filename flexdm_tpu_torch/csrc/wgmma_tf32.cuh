// Building blocks of the float32 wgmma attention kernels (sm_90a), the
// forward (flash_attention_fwd.cu) and the backward
// (flash_attention_bwd.cu): float32 tiles as TMA writes them, the split of
// each value into two TF32 terms, the transposed tiles that the products
// reduced over the other axis read, warpgroup products (wgmma.mma_async
// m64nNk8, TF32 operands, float32 accumulators), and the persistent streams
// of 64-row items both kernels run.  mbarriers, TMA, fences and the
// tensor-map encode are hopper.cuh's, shared with the bf16 kernels.
//
// Split TF32.  A TF32 operand keeps 10 bits of mantissa, about three decimal
// digits; one TF32 pass misses the card checks' 1e-4 by ~10x.  Each value x
// is split once, where it is laid out for the tensor cores, into hi =
// tf32(x), rounded to nearest (ties away) on the low 13 bits of the float32
// word and those bits cleared, an exact TF32 value, and lo = x - hi, exact
// in float32, of which the tensor cores read the top 19 bits: lo loses at
// most 2^-11 of itself, 2^-22 of x, whether they truncate or round it.  A
// product a b is lo hi' + hi lo' + hi hi' (three wgmmas; lo lo' is below
// float32's rounding).  Three instructions a value.  The tensor cores'
// float32 sums are not rounded to nearest (each wgmma's sum is cut toward
// zero), so a product takes the small terms of all its k8 steps before the
// large ones, whose cuts are then the only ones at the sum's full size, and
// a product chained over the tiles of the other axis (O += P V, dq += ds k,
// ...) is summed from zero a tile and added to its running sum in float32
// (second_product): chained on the tensor cores the cuts would bias it.
//
// Shared layouts (every tile starts on a 1024-byte boundary):
//   * F32Tile<DH, ROWS>: a (ROWS, DH) float32 tile (DH the tile width; a
//     smaller head dim lands zero-filled: hopper.cuh, "Head dims") as TMA
//     writes it with
//     CU_TENSOR_MAP_SWIZZLE_128B: DH / 32 column blocks, each a row-major
//     (ROWS, 32) array of 128-byte rows, the 16-byte chunk c of row r at
//     chunk c ^ (r % 8).  Read K-major (its columns are the product's k
//     axis): 8-row core groups SBO = 1024 bytes apart, the k8 step ks
//     32 (ks % 4) bytes into column block ks / 4.  Its split writes hi over
//     the tile in place and lo into a second tile of the same layout (a
//     tile read only transposed, the forward's V, skips both).
//   * TransposedTile<N, K>: (N, K) float32, K-major, no swizzle ("interleave"
//     canonical layout): core matrices of 8 rows by 16 bytes, each 128
//     contiguous bytes, along k LBO = 128 bytes apart, along n SBO = 32 K
//     bytes apart; the k8 step ks starts 256 ks bytes in.  TF32 wgmma reads
//     both operands K-major only (no transpose bits for 32-bit types), so a
//     product reduced over the rows of a tile (ds k, p^T dO, ds^T q) reads
//     the tile transposed into one of these, written by the split.  Row kp
//     of an 8-row group of the source tile goes to k position
//     acc_order(kp): see below.
//
// Accumulators of m64nNk8 (thread 32 w + 4 g + t of the warpgroup): d[4 j +
// e] holds row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1).  The TF32
// A fragment of a k8 step (registers) holds a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4) of the warp's 16 rows.  An accumulator n8 block
// j becomes the A operand of k8 step j without moving: a0, a1, a2, a3 =
// d[4j], d[4j + 2], d[4j + 1], d[4j + 3], so its k index kk is accumulator
// column 2 kk (kk < 4) or 2 (kk - 4) + 1; the B tile of that product holds
// source row r at k position acc_order(r) = 8 (r / 8) + 4 (r % 2) +
// (r % 8) / 2, and the sum over k is the same.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The split
// ---------------------------------------------------------------------------

// A float32 word rounded to TF32 (to nearest, ties away), low 13 bits clear.
__device__ __forceinline__ uint32_t tf32_bits(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo exactly, hi an exact TF32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(__float_as_uint(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Accumulator n8 block j of ``d`` as the split A operand of k8 step j.
template <int R>
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
                                              const float (&d)[R], int j) {
  split_tf32(d[4 * j + 0], hi[0], lo[0]);
  split_tf32(d[4 * j + 2], hi[1], lo[1]);
  split_tf32(d[4 * j + 1], hi[2], lo[2]);
  split_tf32(d[4 * j + 3], hi[3], lo[3]);
}

// The k position of row r of a source tile in a TransposedTile read by a
// product whose A operand comes from accumulators (acc_to_a_tf32).
__host__ __device__ constexpr int acc_order(int r) {
  return 8 * (r / 8) + 4 * (r % 2) + r % 8 / 2;
}

// ---------------------------------------------------------------------------
// Shared tiles
// ---------------------------------------------------------------------------

// Descriptor fields: start address (>> 4), LBO, SBO, layout (0 no swizzle,
// 1 128-byte swizzle).  A descriptor's address field adds without carry,
// shared addresses staying below 2^18.
__device__ __forceinline__ uint64_t tf32_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}

// ``desc`` moved by ``step`` 16-byte units: one add on its low word (the
// products of a tile take their k8 steps' descriptors so, from the tile's
// first one, rather than masking and shifting each address again).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t step) {
  return (desc & 0xFFFFFFFF00000000ull) |
         (static_cast<uint32_t>(desc) + step);
}

// A (ROWS, DH) float32 tile in the 128-byte swizzled layout TMA writes.
template <int DH, int ROWS>
struct F32Tile {
  static_assert(DH == 32 || DH == 64 || DH == 128, "tile width 32, 64 or 128");
  static_assert(ROWS % 8 == 0, "whole 8-row core groups");
  static constexpr int kCols = 32;  // floats per column block (128 bytes)
  static constexpr int kBlocks = DH / kCols;
  static constexpr int kBlockBytes = ROWS * 128;
  static constexpr int kBytes = kBlocks * kBlockBytes;
  static_assert(kBlockBytes % 1024 == 0, "blocks keep the swizzle phase");

  // Byte offset of element (r, c).
  static __host__ __device__ constexpr int offset(int r, int c) {
    return c / kCols * kBlockBytes + r * 128 +
           ((c % kCols / 4) ^ (r % 8)) * 16 + c % 4 * 4;
  }
  // The tile read K-major from its first k8 step; the k8 step ``ks``
  // (columns 8 ks .. 8 ks + 8) starts k_step(ks) 16-byte units later.
  static __device__ __forceinline__ uint64_t k_major(uint32_t base) {
    return tf32_desc(base, 16, 1024, 1);
  }
  static __host__ __device__ constexpr uint32_t k_step(int ks) {
    return (ks / 4 * kBlockBytes + ks % 4 * 32) >> 4;
  }
};

// An (N, K) float32 tile, K-major, in the interleaved (unswizzled) layout.
template <int N, int K>
struct TransposedTile {
  static_assert(N % 8 == 0 && K % 8 == 0, "whole core matrices");
  static constexpr int kSbo = 32 * K;  // bytes between 8-row groups
  static constexpr int kBytes = N * K * 4;
  static_assert(kBytes % 1024 == 0, "tiles stay 1024-byte aligned");

  // Byte offset of element (n, k).
  static __host__ __device__ constexpr int offset(int n, int k) {
    return n / 8 * kSbo + k / 4 * 128 + n % 8 * 16 + k % 4 * 4;
  }
  // The tile read K-major from row 0 and its first k8 step; rows n0 .. of
  // the k8 step ``ks`` start step(n0, ks) 16-byte units later.
  static __device__ __forceinline__ uint64_t k_major(uint32_t base) {
    return tf32_desc(base, 128, kSbo, 0);
  }
  static __host__ __device__ constexpr uint32_t step(int n0, int ks) {
    return (n0 / 8 * kSbo + 256 * ks) >> 4;
  }
};

// Splits a landed F32Tile<DH, ROWS> ``tile`` in place into its hi terms,
// writing the lo terms into ``lo`` (same layout) and, with TRANSPOSE, the
// hi and lo terms transposed into the TransposedTile<DH, ROWS>s ``t_hi`` and
// ``t_lo``, row r of the tile at k position acc_order(r).  Without
// IN_PLACE only the transposed terms are written (``lo`` unused).  Run by
// THREADS threads (``tid`` 0 .. THREADS - 1).  A unit of work is 4 columns
// of the 4 rows of one parity of an 8-row group: rows r0 + 2m, whose k
// positions acc_order(r0) + m are consecutive, so each transposed column
// goes out as one 16-byte store.  Eight consecutive units are the 8 chunks
// of one column block, so their 16-byte loads and in-place stores hit 8
// different chunk slots.
template <int DH, int ROWS, bool TRANSPOSE, int THREADS, bool IN_PLACE = true>
__device__ __forceinline__ void split_tile(unsigned char* tile,
                                           unsigned char* lo,
                                           unsigned char* t_hi,
                                           unsigned char* t_lo, int tid) {
  static_assert(TRANSPOSE || IN_PLACE, "a split writes some terms");
  using T = F32Tile<DH, ROWS>;
  using Tt = TransposedTile<DH, ROWS>;
  constexpr int kUnits = ROWS * DH / 16;
#pragma unroll
  for (int n = 0; n < (kUnits + THREADS - 1) / THREADS; ++n) {
    const int u = tid + THREADS * n;
    if (kUnits % THREADS != 0 && u >= kUnits) break;
    const int rest = u / 16;
    const int c = 4 * (rest / (ROWS / 8) * 8 + u % 8);  // first column
    const int r0 = 8 * (rest % (ROWS / 8)) + u / 8 % 2;  // first row
    uint32_t h[4][4], l[4][4];  // [row m][column e]
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int off = T::offset(r0 + 2 * m, c);
      const float4 x = *reinterpret_cast<const float4*>(tile + off);
      split_tf32(x.x, h[m][0], l[m][0]);
      split_tf32(x.y, h[m][1], l[m][1]);
      split_tf32(x.z, h[m][2], l[m][2]);
      split_tf32(x.w, h[m][3], l[m][3]);
      if (IN_PLACE) {
        *reinterpret_cast<uint4*>(tile + off) =
            make_uint4(h[m][0], h[m][1], h[m][2], h[m][3]);
        *reinterpret_cast<uint4*>(lo + off) =
            make_uint4(l[m][0], l[m][1], l[m][2], l[m][3]);
      }
    }
    if (TRANSPOSE) {
      const int kp = acc_order(r0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int to = Tt::offset(c + e, kp);
        *reinterpret_cast<uint4*>(t_hi + to) =
            make_uint4(h[0][e], h[1][e], h[2][e], h[3][e]);
        *reinterpret_cast<uint4*>(t_lo + to) =
            make_uint4(l[0][e], l[1][e], l[2][e], l[3][e]);
      }
    }
  }
}

// Rows [row0, row0 + ROWS) of head ``head`` of a (B H, S, DH) map into an
// F32Tile<DH, ROWS> (one box per column block).
template <int DH, int ROWS>
__device__ __forceinline__ void tma_f32_tile(unsigned char* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int row0,
                                             int head) {
  using T = F32Tile<DH, ROWS>;
#pragma unroll
  for (int blk = 0; blk < T::kBlocks; ++blk)
    tma_load_3d(dst + blk * T::kBlockBytes, map, bar, blk * T::kCols, row0,
                head);
}

// ---------------------------------------------------------------------------
// Warpgroup products
// ---------------------------------------------------------------------------

// d (+)= A B, m64n16k8, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n32k8, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n32k8, A (TF32 values) in registers, B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k8, A (TF32 values) in registers, B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Persistent streams and split products (the forward and dq, dk/dv kernels)
// ---------------------------------------------------------------------------
//
// An item is 64 rows (queries, or keys for dk/dv) of one head: the wgmma M.
// A block, one an SM, runs one or two streams, each a consumer warpgroup
// taking the items first, first + stride, ... of the launch, and one
// splitter warpgroup whose halves serve the streams.  Per stream: the
// item's own tiles, a ring of stages of the other axis's tiles that TMA
// fills, and the barriers below.

constexpr int kTile = 64;  // rows or keys an item has: the wgmma M
// Keys per K/V tile (forward, dq) and rows per Q/dO tile (dk/dv): the N of
// the score products.
__host__ __device__ constexpr int other_rows(int dh) {
  return dh == 128 ? 16 : 32;
}
// Columns of O, dq, dk, dv a chained second product writes (its temporary
// accumulator set holds 16 registers).
constexpr int kChunkCols = 32;
// Shared memory a block may use.
constexpr int kSmemLimit = 232448;
// A block has ``streams`` consumer warpgroups and one splitter warpgroup.
__host__ __device__ constexpr int threads(int streams) {
  return (streams + 1) * kWarpgroup;
}

// A stream's barriers: its own tiles landed (TMA bytes) and split, then per
// ring stage landed and split (full).  The consumer refills a stage it has
// just emptied, so there is no empty barrier.
struct Barriers {
  uint64_t* own_loaded;
  uint64_t* own_ready;
  uint64_t* loaded;
  uint64_t* full;
  __device__ Barriers(unsigned char* at, int stages)
      : own_loaded(reinterpret_cast<uint64_t*>(at)),
        own_ready(own_loaded + 1),
        loaded(own_loaded + 2),
        full(loaded + stages) {}
  __device__ void init(int stages, int splitters) {
    mbar_init(own_loaded, 1);
    mbar_init(own_ready, splitters);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], splitters);
    }
  }
};

__host__ __device__ constexpr int barrier_bytes(int stages) {
  return (2 + 2 * stages) * 8;
}

// Register A fragments (hi, lo) of rows 16 w + g (+ 8) of an own tile.
// Before the tile takes the next item's (a TMA copy issued by one thread
// after a named barrier), every reading thread runs fence_proxy_async():
// the loads go through the generic proxy and the copy writes through the
// async proxy, which neither the barrier nor program order keeps behind
// loads still in flight.  Without the fence a warp's loads still queued at
// the barrier could read the next item's rows; the dq kernel's two-stream
// instances at Dh 32 did, in 22 of 120000 calls at (33, 8, 70, 32) on an
// H100 (tools/torch_sass_hazards.py reports the pattern, "tma").
template <int DH>
__device__ __forceinline__ void load_own_frags(uint32_t (&hi)[DH / 8][4],
                                               uint32_t (&lo)[DH / 8][4],
                                               const unsigned char* tile,
                                               const unsigned char* lo_tile,
                                               int w, int g, int t) {
  using T = F32Tile<DH, kTile>;
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off =
          T::offset(16 * w + g + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1));
      hi[ks][i] = *reinterpret_cast<const uint32_t*>(tile + off);
      lo[ks][i] = *reinterpret_cast<const uint32_t*>(lo_tile + off);
    }
    fence_regs(hi[ks]);
    fence_regs(lo[ks]);
  }
}

// d = A B^T over DH (a score product, N = the rows of the other-axis tile
// ``b`` / ``b_lo``), split: A from the register fragments own_hi / own_lo
// with REGS, else from the own tile ``a`` / ``a_lo`` in shared memory.
// Issued, not waited.
template <int DH, int N, bool REGS, int F>
__device__ __forceinline__ void score_product(
    float (&d)[N / 2], const uint32_t (&own_hi)[F][4],
    const uint32_t (&own_lo)[F][4], uint32_t a, uint32_t a_lo, uint32_t b,
    uint32_t b_lo) {
  using A = F32Tile<DH, kTile>;
  using B = F32Tile<DH, N>;
  // The small terms of every k8 step first, then the large ones (see "Split
  // TF32" at the top).
  const uint64_t ah = A::k_major(a), al = A::k_major(a_lo);
  const uint64_t bh = B::k_major(b), bl = B::k_major(b_lo);
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
    const uint64_t bh_k = desc_add(bh, B::k_step(ks));
    const uint64_t bl_k = desc_add(bl, B::k_step(ks));
    if constexpr (REGS) {
      wgmma_tf32_rs(d, own_lo[ks], bh_k, ks > 0);
      wgmma_tf32_rs(d, own_hi[ks], bl_k, 1);
    } else {
      wgmma_tf32_ss(d, desc_add(al, A::k_step(ks)), bh_k, ks > 0);
      wgmma_tf32_ss(d, desc_add(ah, A::k_step(ks)), bl_k, 1);
    }
  }
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
    const uint64_t bh_k = desc_add(bh, B::k_step(ks));
    if constexpr (REGS)
      wgmma_tf32_rs(d, own_hi[ks], bh_k, 1);
    else
      wgmma_tf32_ss(d, desc_add(ah, A::k_step(ks)), bh_k, 1);
  }
}

// acc += P T, P the (64, K) accumulators split into A fragments (hi, lo),
// T the (DH, K) transposed tile ``t`` / ``t_lo`` (k8 steps j0 .. of a
// TransposedTile<DH, KT>): in chunks of kChunkCols columns, each summed from
// zero in ``tmp`` and added in float32.  Every product has completed on
// return.
template <int DH, int K, int KT = K>
__device__ __forceinline__ void second_product(
    float (&acc)[DH / 2], const uint32_t (&p_hi)[K / 8][4],
    const uint32_t (&p_lo)[K / 8][4], uint32_t t, uint32_t t_lo,
    int j0 = 0) {
  using Tt = TransposedTile<DH, KT>;
  constexpr int C = kChunkCols;
  const uint64_t th = Tt::k_major(t), tl = Tt::k_major(t_lo);
#pragma unroll
  for (int c = 0; c < DH / C; ++c) {
    float tmp[C / 2];
    fence_regs(tmp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      wgmma_tf32_rs(tmp, p_lo[j], desc_add(th, Tt::step(c * C, j0 + j)),
                    j > 0);
      wgmma_tf32_rs(tmp, p_hi[j], desc_add(tl, Tt::step(c * C, j0 + j)), 1);
    }
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
      wgmma_tf32_rs(tmp, p_hi[j], desc_add(th, Tt::step(c * C, j0 + j)), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tmp);
#pragma unroll
    for (int r = 0; r < C / 2; ++r) acc[c * C / 2 + r] += tmp[r];
  }
}

// The split A fragments of the K / 8 k8 steps of an accumulator set from
// its n8 block j0 on.
template <int K, int R>
__device__ __forceinline__ void acc_frags(uint32_t (&hi)[K / 8][4],
                                          uint32_t (&lo)[K / 8][4],
                                          const float (&d)[R], int j0 = 0) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    acc_to_a_tf32(hi[j], lo[j], d, j0 + j);
    fence_regs(hi[j]);
    fence_regs(lo[j]);
  }
}

// A stream's work: items (head bh, block of 64 rows or keys) first, first +
// stride, ... of the n_items = BH * blocks of a launch, in that order.
struct Item {
  int bh, row0;
};
__device__ __forceinline__ Item item_at(int it, int blocks) {
  return {it / blocks, it % blocks * kTile};
}

// The next tile a stream's consumer thread 0 copies into the stage its
// consumers have just emptied: it walks the same items as the stream's
// consumers and splitters, stepping (head, row block) by the stride (no
// division a tile: the refill is on the consumers' path).
struct Cursor {
  int item, bh, row0, tile;
  __device__ Cursor(int first, int blocks)
      : item(first), bh(first / blocks), row0(first % blocks * kTile),
        tile(0) {}
  // Once an item (the divisions are by the same values every time).
  __device__ void next_item(int stride, int blocks) {
    item += stride;
    bh += stride / blocks;
    row0 += stride % blocks * kTile;
    if (row0 >= blocks * kTile) {
      row0 -= blocks * kTile;
      ++bh;
    }
    tile = 0;
  }
};

// Two streams take turns on the tensor cores: a stream issues a tile's
// score products only in its turn (named barrier kTurn + its index, both
// consumer warpgroups), then hands the turn over, so one stream's products
// run while the other forms p (and ds), instead of both at once.  Stream 1
// opens by handing stream 0 the first turn; a stream with fewer tiles
// takes empty turns until the other is done, and stream 0 takes a last one,
// so every arrival meets its wait.  One stream: nothing to do.
constexpr int kTurn = 3;  // named barriers kTurn, kTurn + 1
template <int NS>
struct Turns {
  int sid;  // the stream
  __device__ void open() const {
    if (NS == 2 && sid == 1) named_arrive(kTurn, 2 * kWarpgroup);
  }
  __device__ void take() const {
    if (NS == 2) named_sync(kTurn + sid, 2 * kWarpgroup);
  }
  __device__ void give() const {
    if (NS == 2) named_arrive(kTurn + 1 - sid, 2 * kWarpgroup);
  }
  // ``tiles(x)``: the tiles of the block's stream x.
  template <typename Tiles>
  __device__ void close(Tiles tiles) const {
    if (NS != 2) return;
    for (int x = tiles(sid), most = max(tiles(0), tiles(1)); x < most; ++x) {
      take();
      give();
    }
    if (sid == 0) take();
  }
};

// Items a stream gets: first, first + stride, ... below n_items.
__device__ __forceinline__ int stream_items(int first, int stride,
                                            int n_items) {
  return first < n_items ? (n_items - 1 - first) / stride + 1 : 0;
}

// Ring stages a stream gets out of a block's shared memory, at most 4.
constexpr int ring_stages(int streams, int own_bytes, int stage_bytes,
                          int vec_bytes) {
  const int per_stage = streams * (stage_bytes + vec_bytes + 16);
  const int n = (kSmemLimit - 1024 - streams * (own_bytes + 16)) / per_stage;
  return n < 4 ? n : 4;
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// The SMs of the current device (the grid of a persistent launch).
inline int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 132;
  return sms;
}

// Streams a launch runs per block: two where there are more items than
// SMs (and a Dh with a two-stream instance), so an SM overlaps two items
// where one stream would run them in turn; else one, so that every SM has
// an item (at (1, 2, 4096, 64), 128 items, two streams would leave half
// the SMs idle).
inline int streams_for(int items, int max_streams) {
  return max_streams > 1 && items > sm_count() ? 2 : 1;
}

// Shapes the launches take: the items (B H (S / 64) blocks of 64 rows or
// keys) counted in an int.
inline bool bad_shape(int B, int H, int S) {
  return B <= 0 || H <= 0 || S <= 0 ||
         static_cast<long long>(B) * H * ((S + kTile - 1) / kTile) > INT_MAX;
}

// The map of a contiguous (BH, S, ld) float32 tensor (ld <= DH, a multiple
// of 4) read in F32Tile<DH, ROWS> tiles.  Rows past S and columns past ld
// come back as zeros, never as the next row's or head's.
template <int DH, int ROWS>
cudaError_t f32_rows_map(CUtensorMap* map, const void* base, int BH, int S,
                         int ld) {
  return encode_rows_map(map, base, BH, S, ld, 4,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         F32Tile<DH, ROWS>::kCols, ROWS,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
