// Hopper (sm_90a) building blocks shared by the wgmma attention kernels of
// both dtypes (wgmma_bf16.cuh, wgmma_tf32.cuh): shared addresses, mbarriers,
// tiles by TMA (cp.async.bulk.tensor), named barriers, register hand-over
// between warpgroups (setmaxnreg), the fences and groups of warpgroup
// products, and on the host the tensor-map encode through the CUDA runtime's
// entry point into the CUDA driver (so a library links against nothing but
// cudart), after a CUDA context is bound to the calling thread.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_mask.cuh"

namespace {

constexpr int kWarpgroup = 128;

// Scores in log2 units: a probability is one ex2.  A replaced or masked
// score is -1e9 log2 e (kMaskedLog2), which rounds to the same float as a
// fully masked row's max m log2 e, so such a row keeps p = 1/l.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskedLog2 = kMaskedScore * kLog2e;

// 2^x (ex2.approx; a result below the smallest normal float is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int round_up_1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

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

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma operand reads, TMA writes) of the block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier over the first ``threads`` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at named barrier ``id`` (of ``threads`` threads) without waiting.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// Warpgroup products: fences and groups
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

// The same for register A operands: their values are made before the
// wgmma.fence that precedes the products reading them.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---------------------------------------------------------------------------
// Host: head dims, shared memory and tensor maps
// ---------------------------------------------------------------------------

// Head dims.  The tile layouts of each dtype are instantiated at W = 32, 64
// and 128 columns; the head dim Dh (1 .. 128) is a runtime value.  A
// tensor's rows are ld = Dh rounded up to 16 bytes (``per16`` elements: 4
// float32, 8 bf16), the row stride TMA needs: where ld > Dh the caller hands
// in a zero-padded copy (ops/attention.py).  A call takes the smallest W >=
// ld; TMA fills its columns from ld on with zeros, which change no score, no
// O, no delta and no gradient column below Dh.  The softmax scale is
// 1/sqrt(Dh), never 1/sqrt(W).  Stores write the columns below ld only.
constexpr int kMaxHeadDim = 128;

inline int row_width(int dh, int per16) {
  return (dh + per16 - 1) / per16 * per16;
}

// The tile width W of a row width ld <= 128: 32, 64 or 128.
inline int tile_width(int ld) { return ld <= 32 ? 32 : ld <= 64 ? 64 : 128; }

inline bool bad_head_dim(int dh) { return dh < 1 || dh > kMaxHeadDim; }

// 1/sqrt(Dh) times ``mul`` (log2 e for scores kept in log2 units), as every
// kernel of a forward and its backward take it: the same x from the same
// scores.
inline float softmax_scale(int dh, float mul = 1.f) {
  return 1.0f / sqrtf(static_cast<float>(dh)) * mul;
}

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

// The map of a contiguous (BH, S, ld) tensor of ``elem_bytes``-byte
// ``type`` elements read in boxes of ``box_cols`` columns by ``box_rows``
// rows of one head, written to shared memory with ``swizzle``.  Rows past S
// and columns past ld come back as zeros, never as the next row's or
// head's: a tile of W > ld columns (a column block wholly past ld too)
// lands whole, its columns from ld on zero.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int BH,
                                   int S, int ld, int elem_bytes,
                                   CUtensorMapDataType type, int box_cols,
                                   int box_rows, CUtensorMapSwizzle swizzle) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(ld) * elem_bytes,
      static_cast<cuuint64_t>(S) * ld * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res =
      encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
