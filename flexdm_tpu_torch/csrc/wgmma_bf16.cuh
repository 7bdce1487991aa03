// Building blocks of the Hopper-native bf16 kernels (sm_90a): tiles by TMA
// (cp.async.bulk.tensor) completed on mbarriers, their swizzled shared
// layout, and warpgroup products (wgmma.mma_async m64nNk16, bf16 operands,
// float32 accumulators) with the shared-memory matrix descriptors that read
// that layout.  The host side encodes the tensor maps through the CUDA
// runtime's entry point into the CUDA driver, so the library links against
// nothing but cudart.
//
// Shared layout.  A (rows, Dh) bf16 tile is stored as Dh / 64 column blocks
// (one at Dh = 32 and 64, two at Dh = 128), each a row-major (rows, W) array
// with W = min(Dh, 64) columns (64 or 128 bytes a row), swizzled as TMA
// writes it with CU_TENSOR_MAP_SWIZZLE_64B (Dh = 32) or _128B: the 16-byte
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

#include "mma_tf32.cuh"  // kMaskedScore, key_bias

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroup = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskedLog2 = kMaskedScore * kLog2e;

// 2^x (ex2.approx; a result below the smallest normal float is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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
// into row ``row`` of a (rows, DH) bf16 array.
template <int DH>
__device__ __forceinline__ void store_row(bf16* dst, size_t row,
                                          const float (&acc)[DH / 2], int hh,
                                          int t, float scale) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + row * DH + 8 * j + 2 * t) = pack_bf16(
        acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
}

constexpr int round_up_1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// ---------------------------------------------------------------------------
// Shared tiles
// ---------------------------------------------------------------------------

// A (ROWS, DH) bf16 tile in the swizzled layout above.
template <int DH, int ROWS>
struct SwizzledTile {
  static_assert(DH == 32 || DH == 64 || DH == 128, "head dim 32, 64 or 128");
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

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after ``p`` (dynamic shared memory is
// allocated with 1024 bytes of slack for it).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = shared_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

// Arrives and adds ``bytes`` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Adds ``bytes`` to the transactions the current phase waits for, without
// arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity ``parity`` has completed.  A wait that
// never ends (a fault in the pipeline) traps after ~2^28 tries, seconds
// where a real wait takes microseconds, so it fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completes ``bar``'s transactions with the box's bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

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

// Named barrier over the first ``threads`` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Moves registers between warpgroups (every warp of the warpgroup runs it):
// the producer gives up what it does not need, the consumers take it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Warpgroup products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulators across
// the asynchronous products that own them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// The same for register A operands: their values are made before the
// wgmma.fence that precedes the products reading them.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---------------------------------------------------------------------------
// Host: shared memory and tensor maps
// ---------------------------------------------------------------------------

// Sets an instance's dynamic shared memory limit to what it uses, at any
// size (a launch with the default limit failed with cudaErrorInvalidValue
// on the card, even below 48 KB).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, through the runtime (no
// -lcuda); null if the CUDA driver has none.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Makes a CUDA context current on the calling thread, once a thread.
// cuTensorMapEncodeTiled needs one and fails with CUDA_ERROR_INVALID_VALUE
// without it: a thread can reach the kernels before any runtime call of
// its own has bound the primary context (autograd's device thread, its
// outputs served from the caching allocator, did on the card).  Where the
// thread has a current context, the runtime keeps it.
inline cudaError_t bind_context() {
  thread_local const cudaError_t err = cudaFree(nullptr);
  return err;
}

// The map of a contiguous (BH, S, DH) bf16 tensor read in (ROWS, DH) tiles
// of SwizzledTile<DH, ROWS> (boxes of one column block).  Rows past S come
// back as zeros, never as the next head's rows.
template <int DH, int ROWS>
cudaError_t rows_map(CUtensorMap* map, const void* base, int BH, int S) {
  using T = SwizzledTile<DH, ROWS>;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(S) * DH * 2};
  const cuuint32_t box[3] = {T::kCols, ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
