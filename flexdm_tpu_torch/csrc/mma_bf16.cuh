// Building blocks of the bf16 flash-attention kernels (sm_90a): bf16 tiles
// by cp.async, ldmatrix fragment loads, and bf16 tensor-core products on
// mma.sync.m16n8k16 with float32 accumulators.  The masking constants, the
// cp.async primitives and allow_smem come from mma_tf32.cuh, unchanged.
//
// bf16 x bf16 products are exact in float32, so a product of bf16 operands
// needs no split (the float32 kernels split each TF32 operand in three
// products); the operands' own rounding is the only rounding.  Accumulation
// stays on the tensor core across k-steps: the tolerances of the bf16
// instances are bf16-level (2^-8 of the largest output), far above the
// tensor core's float32 accumulation error.
//
// Fragment layout of mma.sync.m16n8k16 (bf16), lane = 4 g + t; each 32-bit
// register packs two bf16, the lower column (or k) in the low half:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So the C tiles of two adjacent n8 tiles are, rounded to bf16 and packed
// in pairs, the A operand of one k16 step (acc_to_a): no data moves.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and each lane receives (row g, columns 2t,
// 2t + 1) of every matrix, or with .trans (rows 2t, 2t + 1, column g).
// Shared tiles are row-major with rows padded to Dh + 8 bf16 (kPadBf16): a
// row is a whole number of 16-byte chunks (cp.async, ldmatrix), and the
// eight rows of one 8 x 8 matrix fall in eight different 16-byte bank
// groups at Dh = 32, 64 and 128 (row strides of 80, 144 and 272 bytes), so
// every ldmatrix is conflict-free.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "mma_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPadBf16 = 8;  // bf16 of padding per shared row (16 bytes)

// Rows [row0, row0 + ROWS) of a (S, DH) bf16 slice into a
// [ROWS][DH + kPadBf16] tile by a block of THREADS threads, 16 bytes per
// copy; rows >= S are zero-filled.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void load_rows_bf16(bf16* tile, const bf16* src,
                                               int row0, int S, int tid) {
  constexpr int kChunks = DH / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "tile not a whole number "
                                               "of copies per thread");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / kChunks, c = i % kChunks * 8;
    const bool real = row0 + r < S;
    const bf16* from =
        real ? src + static_cast<size_t>(row0 + r) * DH + c : src;
    cp_async16(reinterpret_cast<float*>(tile + r * (DH + kPadBf16) + c),
               reinterpret_cast<const float*>(from), real);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b on the bf16 tensor cores, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d0 += a b(n-tile 0), d1 += a b(n-tile 1), with b as frag_bt or
// frag_b_trans load it.
__device__ __forceinline__ void mma_bf16_x2(float (&d0)[4], float (&d1)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[4]) {
  mma_bf16(d0, a, b[0], b[1]);
  mma_bf16(d1, a, b[2], b[3]);
}

// Two floats rounded to bf16 (to nearest even), ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// A = tile[r0 .. r0+16)[c0 .. c0+16) of a row-major bf16 tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  const int row = r0 + lane % 8 + 8 * (lane / 8 % 2);
  const int col = c0 + 8 * (lane / 16);
  ldmatrix_x4(a, tile + row * LD + col);
}

// B of one k16 step for the n8 tiles n0 and n0 + 8 where B(k, n) =
// tile[n][k] (the tile's rows are the n axis: K in q k^T).  b[0], b[1]
// serve n-tile n0, b[2], b[3] n-tile n0 + 8.
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile,
                                        int n0, int k0, int lane) {
  const int row = n0 + lane % 8 + 8 * (lane / 16);
  const int col = k0 + 8 * (lane / 8 % 2);
  ldmatrix_x4(b, tile + row * LD + col);
}

// B of one k16 step for the n8 tiles n0 and n0 + 8 where B(k, n) =
// tile[k][n] (the tile's rows are the k axis: V in p v), by ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int k0, int n0,
                                             int lane) {
  const int row = k0 + lane % 8 + 8 * (lane / 8 % 2);
  const int col = n0 + 8 * (lane / 16);
  ldmatrix_x4_trans(b, tile + row * LD + col);
}

// The accumulators of the n8 tiles c0 (columns 0..7) and c1 (8..15) as the
// bf16 A operand of one k16 step over those 16 columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace
