// Building blocks of the float32 flash-attention forward (sm_90a): cp.async
// tile copies and split-TF32 tensor-core products on mma.sync.m16n8k8.  (The
// float32 backward runs the same split on wgmma: wgmma_tf32.cuh.)
//
// Split TF32.  A TF32 operand keeps 10 bits of mantissa, about three decimal
// digits; one TF32 pass misses the float32-level tolerances of the card
// checks by ~10x (tests/test_torch_attention_backward.py and
// tests/test_torch_attention.py emulate both).  So each operand value x is
// split as it enters registers: hi = tf32(x), lo = tf32(x - hi), and
// a b ~ lo hi' + hi lo' + hi hi' (three MMAs, the small terms first; lo lo'
// is below float32's rounding).  The three products of one k-step are
// summed from zero on the tensor core and added to the accumulator with a
// float32 add (mma3): the tensor core's own float32 accumulation is not
// round-to-nearest, and accumulating every k-step there measured 5x the
// error against plain PyTorch and, in the training step, turned the
// key-bias gradient (exactly 0 in exact arithmetic) into 2e-5 of noise.
//
// Fragment layout of mma.sync.m16n8k8 (tf32), lane = 4 g + t:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// Shared tiles are row-major with rows padded to Dh + kPad floats: a
// fragment load then has lane (g, t) read row g, column t (bank 4g + t) or
// row 2t (+1), column g (bank 8t + g (+4)), 32 different banks either way,
// and rows stay 16-byte aligned for cp.async.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "attention_mask.cuh"

namespace {

constexpr int kPad = 4;  // floats of padding per shared row
constexpr int kStaticSmemLimit = 48 * 1024;

// ---------------------------------------------------------------------------
// Asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !real (src is not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a (S, DH) slice into a [ROWS][DH + kPad] tile
// by a block of THREADS threads; rows >= S are zero-filled.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          int row0, int S, int tid) {
  constexpr int kChunks = DH / 4;
  static_assert(ROWS * kChunks % THREADS == 0, "tile not a whole number "
                                               "of copies per thread");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / kChunks, c = i % kChunks * 4;
    const bool real = row0 + r < S;
    const float* from =
        real ? src + static_cast<size_t>(row0 + r) * DH + c : src;
    cp_async16(tile + r * (DH + kPad) + c, from, real);
  }
}

// ---------------------------------------------------------------------------
// Split-TF32 tensor-core products
// ---------------------------------------------------------------------------

// An operand fragment as hi + lo, each TF32.  TF32 rounding is round to
// nearest, ties away, on the low 13 bits of the float32 word (the rounding
// of cvt.rna.tf32.f32): add half of the dropped range and let the tensor
// core, which reads only the upper 19 bits, drop the rest (8-22% faster
// than cvt.rna.tf32.f32 on the H100, which is not a full-rate
// instruction).  hi is masked, so x - hi is exact.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo[i] = __float_as_uint(x - __uint_as_float(hi[i])) + 0x1000u;
  }
};
using FragA = Split<4>;
using FragB = Split<2>;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in three TF32 products, summed from zero and added in float32.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += c[e];
}

// A = tile[r0 .. r0+16)[c0 .. c0+8) of a row-major tile.
template <int LD>
__device__ __forceinline__ FragA load_a(const float* tile, int r0, int c0,
                                        int g, int t) {
  const float* p = tile + (r0 + g) * LD + c0 + t;
  FragA f;
  f.set(0, p[0]);
  f.set(1, p[8 * LD]);
  f.set(2, p[4]);
  f.set(3, p[8 * LD + 4]);
  return f;
}

// B = (tile[n0 .. n0+8)[k0 .. k0+8))^T: column n of B is row n0 + n.
template <int LD>
__device__ __forceinline__ FragB load_bt(const float* tile, int n0, int k0,
                                         int g, int t) {
  const float* p = tile + (n0 + g) * LD + k0 + t;
  FragB f;
  f.set(0, p[0]);
  f.set(1, p[4]);
  return f;
}

// B = tile[k0 .. k0+8)[n0 .. n0+8) in the k order of from_acc: a lane's
// b0, b1 are rows k0 + 2t, k0 + 2t + 1.
template <int LD>
__device__ __forceinline__ FragB load_b_paired(const float* tile, int k0,
                                               int n0, int g, int t) {
  const float* p = tile + (k0 + 2 * t) * LD + n0 + g;
  FragB f;
  f.set(0, p[0]);
  f.set(1, p[LD]);
  return f;
}

// An accumulator n-tile (16 x 8) as the A operand of the next product: the
// lane's columns 2t and 2t + 1 serve as k = t and k = t + 4, so the sum over
// k is the same as long as B is loaded with load_b_paired.  No data moves.
__device__ __forceinline__ FragA from_acc(const float (&c)[4]) {
  FragA f;
  f.set(0, c[0]);
  f.set(1, c[2]);
  f.set(2, c[1]);
  f.set(3, c[3]);
  return f;
}

// Shared memory of a launch: the block's own tiles (Tile::kOwnFloats) and
// one stage of the ring (Tile::kStageFloats), or two when the loop has more
// than one tile.
template <typename Tile>
constexpr int smem_bytes(int stages) {
  return (Tile::kOwnFloats + stages * Tile::kStageFloats) *
         static_cast<int>(sizeof(float));
}

// Above 48 KB a block's dynamic shared memory must be opted into, once per
// kernel instance.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
