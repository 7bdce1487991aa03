// Building blocks of the Hopper-native bf16 kernels (sm_90a): the swizzled
// shared layout of bf16 tiles that TMA writes, and warpgroup products
// (wgmma.mma_async m64nNk16, bf16 operands, float32 accumulators) with the
// shared-memory matrix descriptors that read that layout.  The mbarriers,
// TMA copies, fences and the tensor-map encode are hopper.cuh's, shared with
// the float32 kernels.
//
// Shared layout.  A (rows, DH) bf16 tile (DH the tile width, 32, 64 or 128;
// a smaller head dim lands zero-filled: hopper.cuh, "Head dims") is stored
// as DH / 64 column blocks (one at DH = 32 and 64, two at DH = 128), each a
// row-major (rows, C) array with C = min(DH, 64) columns (64 or 128 bytes a
// row), swizzled as TMA writes it with CU_TENSOR_MAP_SWIZZLE_64B (DH = 32)
// or _128B: the 16-byte
// chunk c of row r lands at chunk c ^ (r / 2 % 4) (64 B) or c ^ (r % 8)
// (128 B).  Every tile starts on a 1024-byte boundary, so the swizzle's
// phase is the address's own and the descriptors' base offset is 0.
// The same tile serves wgmma both ways:
//   * K-major (the tile's columns are the product's k axis: q k^T, k q^T):
//     8-row core groups SBO = 8 W' bytes apart (W' = row bytes), LBO
//     unused, and the k16 step ks starts 32 ks bytes into its column block;
//   * MN-major (the tile's rows are the k axis: ds k, p^T dO, ds^T q), by
//     the transpose bit that 16-bit types allow: 8-row groups SBO = 8 W'
//     apart, the 64-column blocks LBO = one block apart, and the k16 step
//     starting at row r0 starts r0 W' bytes in.
//
// Accumulators of m64nNk16 (thread 32 w + 4 g + t of the warpgroup):
// d[4 j + e] holds row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1).
// Two adjacent n8 blocks j = 2 kk, 2 kk + 1, rounded to bf16 and packed in
// pairs, are the register A operand of the k16 step kk (acc_to_a: the
// m16n8k16 A layout, which each warp of the warpgroup keeps).
//
// Scores in log2 units.  The kernels keep s log2 e, so a probability is
// one ex2 (exp2_approx).  A replaced or masked score is -1e9 log2 e
// (kMaskedLog2), which rounds to the same float as a fully masked row's
// max m log2 e, and m = -1e9 survives the trip to log2 units and back
// (m2 ln 2 log2 e == m2 in float32): such a row keeps p = 1/l.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Two floats rounded to bf16 (to nearest even), ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
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

// Row 16 w + g + 8 hh of an m64nDH accumulator set, scaled, as bf16 pairs
// into row ``row`` of a (rows, ld) bf16 array (ld <= DH, a multiple of 8):
// the columns below ld.
template <int DH>
__device__ __forceinline__ void store_row(bf16* dst, size_t row, int ld,
                                          const float (&acc)[DH / 2], int hh,
                                          int t, float scale) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c < ld)
      *reinterpret_cast<uint32_t*>(dst + row * ld + c) = pack_bf16(
          acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Shared tiles
// ---------------------------------------------------------------------------

// A (ROWS, DH) bf16 tile in the swizzled layout above.
template <int DH, int ROWS>
struct SwizzledTile {
  static_assert(DH == 32 || DH == 64 || DH == 128, "tile width 32, 64 or 128");
  static_assert(ROWS % 16 == 0, "whole k16 steps of rows");
  static constexpr int kCols = DH < 64 ? DH : 64;   // columns per block
  static constexpr int kRowBytes = kCols * 2;       // 64 or 128
  static constexpr int kBlocks = DH / kCols;        // 1 or 2
  static constexpr int kBlockBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kBlocks * kBlockBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128, B64
  static_assert(kBlockBytes % 1024 == 0, "blocks keep the swizzle phase");

  // Descriptor fields: start address (>> 4), LBO, SBO, layout.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr,
                                                  uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(lbo >> 4) << 16 |
           static_cast<uint64_t>(8 * kRowBytes >> 4) << 32 | kLayout << 62;
  }
  // How far (in the descriptors' 16-byte units) the k16 step ``ks`` read
  // K-major, and the k16 step starting at row ``r0`` read MN-major, start
  // from the tile's first: a descriptor's address field adds without carry,
  // shared addresses staying below 2^18.
  static __host__ __device__ constexpr uint64_t k_step(int ks) {
    return (16 * ks / kCols * kBlockBytes + 16 * ks % kCols * 2) >> 4;
  }
  static __host__ __device__ constexpr uint64_t mn_step(int r0) {
    return r0 * kRowBytes >> 4;
  }
  // The k16 step ``ks`` of the tile read K-major (k = its columns).
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int ks) {
    return desc(base, 16) + k_step(ks);
  }
  // The k16 step starting at row ``r0`` of the tile read MN-major (k = its
  // rows, n = its columns).
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base,
                                                      int r0) {
    return desc(base, kBlockBytes) + mn_step(r0);
  }
};

// Rows [row0, row0 + ROWS) of head ``head`` of a (B H, S, DH) map into a
// SwizzledTile<DH, ROWS> (one box per column block).
template <int DH, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int row0, int head) {
  using T = SwizzledTile<DH, ROWS>;
#pragma unroll
  for (int blk = 0; blk < T::kBlocks; ++blk)
    tma_load_3d(dst + blk * T::kBlockBytes, map, bar, blk * T::kCols, row0,
                head);
}

// d (+)= A B, m64n32k16, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n32k16, A (bf16 pairs) in registers, B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n64k16, A (bf16 pairs) in registers, B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n128k16, A (bf16 pairs) in registers, B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The map of a contiguous (BH, S, ld) bf16 tensor (ld <= DH, a multiple of
// 8) read in (ROWS, DH) tiles of SwizzledTile<DH, ROWS> (boxes of one column
// block).  Rows past S and columns past ld come back as zeros, never as the
// next row's or head's.
template <int DH, int ROWS>
cudaError_t rows_map(CUtensorMap* map, const void* base, int BH, int S,
                     int ld) {
  using T = SwizzledTile<DH, ROWS>;
  return encode_rows_map(map, base, BH, S, ld, 2,
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, T::kCols, ROWS,
                         T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace
