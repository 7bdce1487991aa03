// Building blocks of the float32 wgmma attention kernels (sm_90a): float32
// tiles as TMA writes them, the split of each value into two TF32 terms,
// the transposed tiles that the products reduced over the other axis read,
// and warpgroup products (wgmma.mma_async m64nNk8, TF32 operands, float32
// accumulators).  mbarriers, TMA, fences and the tensor-map encode are
// hopper.cuh's, shared with the bf16 kernels.
//
// Split TF32.  A TF32 operand keeps 10 bits of mantissa, about three decimal
// digits; one TF32 pass misses the card checks' 1e-4 by ~10x.  Each value x
// is split once, where it is laid out for the tensor cores, into hi =
// tf32(x), rounded to nearest (ties away) on the low 13 bits of the float32
// word and those bits cleared, an exact TF32 value, and lo = x - hi, exact
// in float32, of which the tensor cores read the top 19 bits: lo loses at
// most 2^-11 of itself, 2^-22 of x, whether they truncate or round it.  A
// product a b is lo hi' + hi lo' + hi hi' (three wgmmas, the small terms
// first; lo lo' is below float32's rounding).  Three instructions a value.
//
// Shared layouts (every tile starts on a 1024-byte boundary):
//   * F32Tile<DH, ROWS>: a (ROWS, DH) float32 tile as TMA writes it with
//     CU_TENSOR_MAP_SWIZZLE_128B: DH / 32 column blocks, each a row-major
//     (ROWS, 32) array of 128-byte rows, the 16-byte chunk c of row r at
//     chunk c ^ (r % 8).  Read K-major (its columns are the product's k
//     axis): 8-row core groups SBO = 1024 bytes apart, the k8 step ks
//     32 (ks % 4) bytes into column block ks / 4.  Its split writes hi over
//     the tile in place and lo into a second tile of the same layout.
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

// A (ROWS, DH) float32 tile in the 128-byte swizzled layout TMA writes.
template <int DH, int ROWS>
struct F32Tile {
  static_assert(DH == 32 || DH == 64 || DH == 128, "head dim 32, 64 or 128");
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
  // The k8 step ``ks`` (columns 8 ks .. 8 ks + 8) read K-major.
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int ks) {
    return tf32_desc(base + ks / 4 * kBlockBytes + ks % 4 * 32, 16, 1024, 1);
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
  // Rows n0 .. of the k8 step ``ks`` read K-major.
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int n0,
                                                     int ks) {
    return tf32_desc(base + n0 / 8 * kSbo + 256 * ks, 128, kSbo, 0);
  }
};

// Splits a landed F32Tile<DH, ROWS> ``tile`` in place into its hi terms,
// writing the lo terms into ``lo`` (same layout) and, with TRANSPOSE, the
// hi and lo terms transposed into the TransposedTile<DH, ROWS>s ``t_hi`` and
// ``t_lo``, row r of the tile at k position acc_order(r).  Run by THREADS
// threads (``tid`` 0 .. THREADS - 1).  A unit of work is 4 columns of the 4
// rows of one parity of an 8-row group: rows r0 + 2m, whose k positions
// acc_order(r0) + m are consecutive, so each transposed column goes out as
// one 16-byte store.  Eight consecutive units are the 8 chunks of one
// column block, so their 16-byte loads and in-place stores hit 8 different
// chunk slots.
template <int DH, int ROWS, bool TRANSPOSE, int THREADS>
__device__ __forceinline__ void split_tile(unsigned char* tile,
                                           unsigned char* lo,
                                           unsigned char* t_hi,
                                           unsigned char* t_lo, int tid) {
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
      *reinterpret_cast<uint4*>(tile + off) =
          make_uint4(h[m][0], h[m][1], h[m][2], h[m][3]);
      *reinterpret_cast<uint4*>(lo + off) =
          make_uint4(l[m][0], l[m][1], l[m][2], l[m][3]);
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

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// The map of a contiguous (BH, S, DH) float32 tensor read in F32Tile<DH,
// ROWS> tiles.  Rows past S come back as zeros, never as the next head's.
template <int DH, int ROWS>
cudaError_t f32_rows_map(CUtensorMap* map, const void* base, int BH, int S) {
  return encode_rows_map(map, base, BH, S, DH, 4,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         F32Tile<DH, ROWS>::kCols, ROWS,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
