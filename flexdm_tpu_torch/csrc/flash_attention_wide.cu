// Flash-attention backward for head dims above 128 on Hopper (sm_90a), the
// bf16 instances: the dq kernel (with delta) and the dk/dv kernel, every
// product on the bf16 tensor cores (mma.sync), over tiles that cp.async
// brings in.  The wide forward of both dtypes is
// csrc/flash_attention_fwd_wide.cu's and the float32 dq and dk/dv
// csrc/flash_attention_bwd_wide.cu's (wgmma on TMA-fed chunks).
//
// Replaces, at Dh > 128 in bf16, the TPU kernels of
// flexdm_tpu/ops/attention.py:
//   * _flash_bwd_dq_kernel (:116-153, :383) and its S >= 4096 stream
//     variant _flash_bwd_dq_stream_kernel (:217-251, :451) ->
//     flash_bwd_dq_wide_kernel, which also computes delta = rowsum(dO * O)
//     (the XLA glue of _attention_pallas_bwd) and writes it for the dk/dv
//     kernel;
//   * _flash_bwd_dkv_kernel (:156-206, :407) and
//     _flash_bwd_dkv_stream_kernel (:254-293, :475) ->
//     flash_bwd_dkv_wide_kernel.
// The TPU kernels take the whole Dh as one block (_full_spec / _row_spec).
// The port's other instances (flash_attention_{fwd,bwd}{,_bf16}.cu) hold a
// row of up to 128 columns in their tiles and accumulators; these take
// every Dh (ops/attention.py:head_dim_plan sends Dh > 128 here), with no
// upper limit: shared memory and registers do not grow with Dh.
//
// Contract: the other instances', unchanged.  p = softmax(s), s = q k^T /
// sqrt(Dh) + bias; a masked key gets the FINITE bias -1e9, so a fully
// masked row averages V over its S keys (every score rounds to -1e9: l = S
// in the forward, p = 1/S here); with `causal` a key after its query row
// (absolute positions) gets the score -1e9 (replaced: no gradient), and
// dk/dv still visits the tiles above the diagonal, where such a row puts
// weight; keys at index >= S are excluded outright.  p = exp(s - m) / l
// from the forward's row max m and row sum l (flash_attention_bwd.cu says
// why not from lse); delta = rowsum(dO * O), ds = p (dO v^T - delta) (0
// where the band replaced s), dq = scale ds k, dk = scale ds^T q,
// dv = p^T dO.  The scale is 1/sqrt(Dh), never taken from a chunk or block
// width.  Sums are float32; p and ds enter their products as bf16
// operands, and dq, dk and dv are rounded to bf16 once; delta stays
// float32.
//
// Rows.  A tensor's rows are ld = Dh rounded up to 8 bf16 elements (16
// bytes), columns Dh .. ld - 1 zero (a padded copy made by
// ops/attention.py where ld > Dh), so every copy is 16 bytes; a copy past
// ld or past S lands as zeros, which change no score and no gradient
// column below Dh.
//
// Design (a simple kernel that is right first; see PERF.md for its times).
//   * Output column blocks.  A block of 4 warps owns 64 rows of one head
//     (query rows in dq, keys in dk/dv), 16 a warp, and one column block of
//     its outputs: 128 columns of dq, 64 of dk and dv (two accumulators).
//     The grid is heads x row tiles x column blocks, the column block
//     fastest, so the blocks that share a head's rows run side by side and
//     read them through L2.  Every output element is written by one thread
//     of one block: no atomics, so a second call is bitwise equal.
//   * Scores over the full Dh.  Each block computes its 16 x 64 score
//     tiles (q k^T and dO v^T) over every column of the row, in chunks of
//     64 columns that cp.async brings into a two-stage ring (chunk c + 1
//     lands while chunk c is multiplied), with the other axis's tile of 64
//     keys (or rows).  So each column block recomputes the scores: at
//     Dh = 256, 2x in dq, 4x in dk/dv.
//   * Products: mma.sync.m16n8k16 (bf16 products are exact in float32),
//     with ldmatrix fragment loads.  p and ds go from the score
//     accumulators into the A operand of their product with no data
//     movement (two n8 tiles make one k16 A fragment).
//   * Shared rows are padded (8 bf16) so that every fragment load is free
//     of bank conflicts and rows stay 16-byte aligned.  No TMA and no
//     wgmma: the async proxy is not used, so the hazards that
//     tools/torch_sass_hazards.py looks for cannot arise.
//
// What bounds it on an H100 (132 SMs, 3.35 TB/s, 989 TFLOP/s bf16).  At the
// latent-2048 training shape (256, 8, 50, 256) each kernel must move 315 MB
// (0.094 ms) against 3.9 (dq) and 5.2 (dk/dv) GFLOP of products: bytes.
// The kernels read their inputs 1.5x (dq) and 2x (dk/dv at four column
// blocks) and wait for each chunk in turn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

#include "attention_mask.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // a block's rows (queries, or keys)
constexpr int kTile = 64;           // keys (or rows) a tile of the other axis
constexpr int kNT = kTile / 8;      // score n-tiles of a warp
constexpr int kOutCols = 128;       // column block of dq
constexpr int kKvCols = 64;         // column block of dk and dv

// Element type, chunk width and padding.
struct Wide {
  using T = bf16;
  static constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunk = 64;           // Dh columns a chunk
  static constexpr int kPad = kPer16;         // elements a shared row
  static constexpr int kLdc = kChunk + kPad;  // chunk tile row stride
  static constexpr int kChunkElems = kRows * kLdc;
};

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !real (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool real) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(real ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of one head's
// (S, ld) slice into a [ROWS][LDS] shared tile; rows past S and columns
// past ld zero-filled.
template <typename T, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(T* tile, const T* src, int ld,
                                          int row0, int S, int col0,
                                          int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = COLS / kPer;
  static_assert(ROWS * kChunks % kThreads == 0,
                "a tile is a whole number of copies a thread");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / kChunks, c = i % kChunks * kPer;
    const bool real = row0 + r < S && col0 + c < ld;
    const T* from =
        real ? src + static_cast<size_t>(row0 + r) * ld + col0 + c : src;
    cp_async16(tile + r * LDS + c, from, real);
  }
}

// Entries [row0, row0 + kTile) of a length-S vector; past S zero-filled.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int S, int tid) {
  if (tid < kTile) {
    const bool real = row0 + tid < S;
    cp_async4(dst + tid, real ? src + row0 + tid : src, real);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core products
// ---------------------------------------------------------------------------

// Fragment layouts of m16n8k16, lane = 4 g + t (each 32-bit register two
// bf16, the lower k in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//   So the C tiles of two adjacent n8 tiles are, rounded to
//   bf16 and packed in pairs, the A operand of one k16 step (acc_to_a).
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// tile[n][k]: b[0], b[1] serve n-tile n0, b[2], b[3] n-tile n0 + 8.
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile,
                                        int n0, int k0, int lane) {
  const int row = n0 + lane % 8 + 8 * (lane / 16);
  const int col = k0 + 8 * (lane / 8 % 2);
  ldmatrix_x4(b, tile + row * LD + col);
}

// B of one k16 step for the n8 tiles n0 and n0 + 8 where B(k, n) =
// tile[k][n], by ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int k0, int n0,
                                             int lane) {
  const int row = k0 + lane % 8 + 8 * (lane / 8 % 2);
  const int col = n0 + 8 * (lane / 16);
  ldmatrix_x4_trans(b, tile + row * LD + col);
}

__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// sc[j] += A[r0 .. r0+16)[0 .. kChunk) B[8j .. 8j+8)[0 .. kChunk)^T for the
// warp's kNT score tiles; A and B are chunk tiles (row stride kLdc).
__device__ __forceinline__ void chunk_scores(float (&sc)[kNT][4],
                                             const bf16* a, const bf16* b,
                                             int r0, int lane) {
#pragma unroll
  for (int ks = 0; ks < Wide::kChunk / 16; ++ks) {
    uint32_t fa[4];
    frag_a<Wide::kLdc>(fa, a, r0, 16 * ks, lane);
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t fb[4];
      frag_bt<Wide::kLdc>(fb, b, 8 * j, 16 * ks, lane);
      mma_bf16(sc[j], fa, fb[0], fb[1]);
      mma_bf16(sc[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[n] += P B[0 .. kTile)[8n .. 8n+8) for n < NC: P the warp's score
// tiles (16 x kTile, as from chunk_scores), B a [kTile][LD] tile.
template <int LD, int NC>
__device__ __forceinline__ void tile_product(float (&acc)[NC][4],
                                             const float (&p)[kNT][4],
                                             const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t pa[4];
    acc_to_a(pa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < NC; n += 2) {
      uint32_t fb[4];
      frag_b_trans<LD>(fb, b, 16 * kk, 8 * n, lane);
      mma_bf16(acc[n], pa, fb[0], fb[1]);
      mma_bf16(acc[n + 1], pa, fb[2], fb[3]);
    }
  }
}

// Two adjacent output elements (col even, ld a multiple of 16 bytes).
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// dO . O over a row of ld bf16 elements: lane t of the quad takes 16 bytes
// at a time, every fourth; the quad's sums are added by shuffles.  The
// order is fixed, so every block of a row gets the same float.
__device__ __forceinline__ float row_dot(const bf16* x, const bf16* y,
                                         int ld, int t) {
  float sum = 0.f;
  for (int c = 8 * t; c < ld; c += 32) {
    const uint4 a = *reinterpret_cast<const uint4*>(x + c);
    const uint4 b = *reinterpret_cast<const uint4*>(y + c);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 ap, bp;
      memcpy(&ap, &av[i], sizeof(ap));
      memcpy(&bp, &bv[i], sizeof(bp));
      const float2 af = __bfloat1622float2(ap);
      const float2 bf = __bfloat1622float2(bp);
      sum = fmaf(af.x, bf.x, sum);
      sum = fmaf(af.y, bf.y, sum);
    }
  }
  return sum;
}

// The block's place in the grid: column block fastest, then the row tile,
// then the head (b H + h).
struct Place {
  int cb, row0;
  size_t bh;
  __device__ __forceinline__ Place(int n_cb, int n_tiles) {
    const int id = blockIdx.x;
    cb = id % n_cb;
    row0 = id / n_cb % n_tiles * kRows;
    bh = static_cast<size_t>(id / n_cb / n_tiles);
  }
};

// ---------------------------------------------------------------------------
// dq (and delta from column block 0): per key tile, s = q k^T and dO v^T
// over the full row in chunks, then ds, then dq[:, cb] += ds k[:, cb].
// ---------------------------------------------------------------------------

struct DqSmem {
  using W = Wide;
  static constexpr int kLdk = kOutCols + W::kPad;
  // Two stages of {Q, dO, K, V} chunks, the K column block, the key bias.
  static constexpr int kBytes =
      (8 * W::kChunkElems + kTile * kLdk) *
          static_cast<int>(sizeof(typename W::T)) +
      kTile * 4;
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const uint8_t* __restrict__ key_mask,
                              const bf16* __restrict__ o,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ row_max,
                              const float* __restrict__ row_sum,
                              float* __restrict__ delta,
                              bf16* __restrict__ dq, int H,
                              int S, int ld, int n_cb, int causal, float scale) {
  using W = Wide;
  using T = typename W::T;
  constexpr int LDC = W::kLdc;
  constexpr int LDK = DqSmem::kLdk;
  constexpr int NC = kOutCols / 8;
  constexpr int E = W::kChunkElems;
  extern __shared__ __align__(16) unsigned char smem[];
  T* chunks = reinterpret_cast<T*>(smem);  // stage s: Q, dO, K, V
  T* k_s = chunks + 8 * E;                 // [kTile][LDK]
  float* bias_s = reinterpret_cast<float*>(k_s + kTile * LDK);  // [kTile]

  const int n_qt = (S + kRows - 1) / kRows;
  const Place at(n_cb, n_qt);
  const int q0 = at.row0;
  const int c0 = at.cb * kOutCols;
  const int b = static_cast<int>(at.bh / H);
  const size_t head = at.bh * S;
  const T* qh = q + head * ld;
  const T* kh = k + head * ld;
  const T* vh = v + head * ld;
  const T* dh = dout + head * ld;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = tid / 32 * 16;
  const bool active = q0 + r0 < S;

  int n_tiles = (S + kTile - 1) / kTile;
  // Later keys are replaced for every row of the block: their ds is 0.
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRows, S) + kTile - 1) / kTile);
  const int n_chunks = (ld + W::kChunk - 1) / W::kChunk;
  auto load_chunk = [&](int c, int k0) {
    T* st = chunks + (c & 1) * 4 * E;
    const int col = c * W::kChunk;
    load_tile<T, kRows, W::kChunk, LDC>(st, qh, ld, q0, S, col, tid);
    load_tile<T, kRows, W::kChunk, LDC>(st + E, dh, ld, q0, S, col, tid);
    load_tile<T, kTile, W::kChunk, LDC>(st + 2 * E, kh, ld, k0, S, col, tid);
    load_tile<T, kTile, W::kChunk, LDC>(st + 3 * E, vh, ld, k0, S, col, tid);
  };

  // Row statistics of the lane's rows g and g + 8, delta over the full
  // row.  A row past S gets inv_l = 0, so its p and ds are 0.
  float m[2], inv_l[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    const bool real = row < S;
    float sum = real ? row_dot(o + (head + row) * ld, dh + row * ld, ld, t)
                     : 0.f;
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dlt[hh] = sum;
    m[hh] = real ? row_max[head + row] : 0.f;
    inv_l[hh] = real ? 1.f / row_sum[head + row] : 0.f;
    if (real && t == 0 && at.cb == 0) delta[head + row] = sum;
  }

  float acc[NC][4] = {};  // dq[:, cb] of the warp's rows, unscaled
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kTile;
    load_chunk(0, k0);
    load_tile<T, kTile, kOutCols, LDK>(k_s, kh, ld, k0, S, c0, tid);
    cp_async_commit();
    if (tid < kTile) bias_s[tid] = key_bias(key_mask, b, S, k0 + tid);
    float sc[kNT][4] = {}, dp[kNT][4] = {};
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(c + 1, k0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const T* st = chunks + (c & 1) * 4 * E;
        chunk_scores(sc, st, st + 2 * E, r0, lane);
        chunk_scores(dp, st + E, st + 3 * E, r0, lane);
      }
      __syncthreads();
    }
    if (active) {
      const int n_keys = min(kTile, S - k0);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          float ds = 0.f;
          if (kj < n_keys) {
            const bool replaced = causal && k0 + kj > row;
            const float s =
                replaced ? kMaskedScore : sc[j][e] * scale + bias_s[kj];
            const float p = expf(s - m[e >> 1]) * inv_l[e >> 1];
            ds = replaced ? 0.f : p * (dp[j][e] - dlt[e >> 1]);
          }
          sc[j][e] = ds;
        }
      }
      tile_product<LDK, NC>(acc, sc, k_s, lane);
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    if (row >= S) continue;
    T* dq_row = dq + (head + row) * ld;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (col < ld)
        store2(dq_row + col, acc[n][2 * hh] * scale,
               acc[n][2 * hh + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: per tile of 64 query rows, s^T = k q^T and v dO^T over the full
// row in chunks, then p^T and ds^T, then dv[:, cb] += p^T dO[:, cb] and
// dk[:, cb] += ds^T q[:, cb].
// ---------------------------------------------------------------------------

struct DkvSmem {
  using W = Wide;
  static constexpr int kLdb = kKvCols + W::kPad;
  // Two stages of {K, Q, V, dO} chunks, the Q and dO column blocks, the
  // rows' m, l and delta.
  static constexpr int kBytes =
      (8 * W::kChunkElems + 2 * kTile * kLdb) *
          static_cast<int>(sizeof(typename W::T)) +
      3 * kTile * 4;
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const uint8_t* __restrict__ key_mask,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ row_max,
                               const float* __restrict__ row_sum,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int H,
                               int S, int ld, int n_cb, int causal, float scale) {
  using W = Wide;
  using T = typename W::T;
  constexpr int LDC = W::kLdc;
  constexpr int LDB = DkvSmem::kLdb;
  constexpr int NC = kKvCols / 8;
  constexpr int E = W::kChunkElems;
  extern __shared__ __align__(16) unsigned char smem[];
  T* chunks = reinterpret_cast<T*>(smem);  // stage s: K, Q, V, dO
  T* q_s = chunks + 8 * E;                 // [kTile][LDB]
  T* do_s = q_s + kTile * LDB;             // [kTile][LDB]
  float* m_s = reinterpret_cast<float*>(do_s + kTile * LDB);  // [kTile]
  float* l_s = m_s + kTile;
  float* delta_s = l_s + kTile;

  const int n_kt = (S + kRows - 1) / kRows;
  const Place at(n_cb, n_kt);
  const int k0 = at.row0;
  const int c0 = at.cb * kKvCols;
  const int b = static_cast<int>(at.bh / H);
  const size_t head = at.bh * S;
  const T* qh = q + head * ld;
  const T* kh = k + head * ld;
  const T* vh = v + head * ld;
  const T* dh = dout + head * ld;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kr0 = tid / 32 * 16;  // the warp's first key in the block
  const bool active = k0 + kr0 < S;

  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_chunks = (ld + W::kChunk - 1) / W::kChunk;
  auto load_chunk = [&](int c, int i0) {
    T* st = chunks + (c & 1) * 4 * E;
    const int col = c * W::kChunk;
    load_tile<T, kRows, W::kChunk, LDC>(st, kh, ld, k0, S, col, tid);
    load_tile<T, kTile, W::kChunk, LDC>(st + E, qh, ld, i0, S, col, tid);
    load_tile<T, kRows, W::kChunk, LDC>(st + 2 * E, vh, ld, k0, S, col, tid);
    load_tile<T, kTile, W::kChunk, LDC>(st + 3 * E, dh, ld, i0, S, col, tid);
  };

  // The lane's keys g and g + 8.
  bool kreal[2];
  float kbias[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kr0 + g + 8 * hh;
    kreal[hh] = key < S;
    kbias[hh] = key_bias(key_mask, b, S, key);
  }

  // dk[:, cb] (unscaled) and dv[:, cb] of the warp's keys.
  float acc_dk[NC][4] = {}, acc_dv[NC][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int i0 = i * kTile;
    load_chunk(0, i0);
    load_tile<T, kTile, kKvCols, LDB>(q_s, qh, ld, i0, S, c0, tid);
    load_tile<T, kTile, kKvCols, LDB>(do_s, dh, ld, i0, S, c0, tid);
    load_vec(m_s, row_max + head, i0, S, tid);
    load_vec(l_s, row_sum + head, i0, S, tid);
    load_vec(delta_s, delta + head, i0, S, tid);
    cp_async_commit();
    float sc[kNT][4] = {}, dp[kNT][4] = {};
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(c + 1, i0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const T* st = chunks + (c & 1) * 4 * E;
        chunk_scores(sc, st, st + E, kr0, lane);
        chunk_scores(dp, st + 2 * E, st + 3 * E, kr0, lane);
      }
      __syncthreads();
    }
    if (active) {
      const int n_rows = min(kTile, S - i0);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int ri = 8 * j + 2 * t;
        const float2 mm = *reinterpret_cast<const float2*>(m_s + ri);
        const float2 ll = *reinterpret_cast<const float2*>(l_s + ri);
        const float2 dd = *reinterpret_cast<const float2*>(delta_s + ri);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          const int key = k0 + kr0 + g + 8 * (e >> 1);
          float p = 0.f, ds = 0.f;
          if (ri + c < n_rows && kreal[e >> 1]) {
            const bool replaced = causal && key > i0 + ri + c;
            const float s = replaced ? kMaskedScore
                                     : sc[j][e] * scale + kbias[e >> 1];
            p = expf(s - (c ? mm.y : mm.x)) * (1.f / (c ? ll.y : ll.x));
            ds = replaced ? 0.f : p * (dp[j][e] - (c ? dd.y : dd.x));
          }
          sc[j][e] = p;
          dp[j][e] = ds;
        }
      }
      tile_product<LDB, NC>(acc_dv, sc, do_s, lane);
      tile_product<LDB, NC>(acc_dk, dp, q_s, lane);
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!kreal[hh]) continue;
    const size_t key_row = head + k0 + kr0 + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (col < ld) {
        store2(dk + key_row * ld + col, acc_dk[n][2 * hh] * scale,
               acc_dk[n][2 * hh + 1] * scale);
        store2(dv + key_row * ld + col, acc_dv[n][2 * hh],
               acc_dv[n][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// Blocks of a launch: heads x row tiles x column blocks of ``cols``, or 0
// if that does not fit a 1-D grid.
int grid_blocks(int B, int H, int S, int ld, int cols) {
  const long long n = static_cast<long long>(B) * H * ((S + kRows - 1) / kRows) *
                      ((ld + cols - 1) / cols);
  return n > INT_MAX ? 0 : static_cast<int>(n);
}

bool bad_call(int B, int H, int S, int Dh) {
  return B <= 0 || H <= 0 || S <= 0 || Dh <= 0;
}

// Sets an instance's dynamic shared memory limit to what it uses, once.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int launch_dq(const void* q, const void* k, const void* v,
              const void* key_mask, const void* o, const void* dout,
              const void* row_max, const void* row_sum, void* delta, void* dq,
              int B, int H, int S, int Dh, int causal, void* stream) {
  using W = Wide;
  using T = typename W::T;
  if (bad_call(B, H, S, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kBytes = DqSmem::kBytes;
  static const cudaError_t attr =
      set_smem(flash_bwd_dq_wide_bf16_kernel, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int ld = (Dh + W::kPer16 - 1) / W::kPer16 * W::kPer16;
  const int blocks = grid_blocks(B, H, S, ld, kOutCols);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dq_wide_bf16_kernel<<<blocks, kThreads, kBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
      static_cast<float*>(delta), static_cast<T*>(dq), H, S, ld,
      (ld + kOutCols - 1) / kOutCols, causal,
      1.0f / sqrtf(static_cast<float>(Dh)));
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv(const void* q, const void* k, const void* v,
               const void* key_mask, const void* dout, const void* row_max,
               const void* row_sum, const void* delta, void* dk, void* dv,
               int B, int H, int S, int Dh, int causal, void* stream) {
  using W = Wide;
  using T = typename W::T;
  if (bad_call(B, H, S, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kBytes = DkvSmem::kBytes;
  static const cudaError_t attr =
      set_smem(flash_bwd_dkv_wide_bf16_kernel, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int ld = (Dh + W::kPer16 - 1) / W::kPer16 * W::kPer16;
  const int blocks = grid_blocks(B, H, S, ld, kKvCols);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_wide_bf16_kernel<<<blocks, kThreads, kBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<const T*>(dout), static_cast<const float*>(row_max),
      static_cast<const float*>(row_sum), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, S, ld,
      (ld + kKvCols - 1) / kKvCols, causal,
      1.0f / sqrtf(static_cast<float>(Dh)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry points of the bf16 backward, with the other backward entries'
// arguments (the float32 backward's are flash_attention_bwd_wide.cu's, the
// wide forward's flash_attention_fwd_wide.cu's).  q, k, v, o, dout, dq, dk,
// dv: (B, H, S, ld) bf16, contiguous, 16-byte aligned, ld = Dh rounded up
// to 8 with columns Dh .. ld - 1 of q, k, v, o and dout zero; any Dh >= 1
// (ops/attention.py sends Dh > 128).  key_mask: (B, S) bool (nonzero =
// attend) or null.  row_max, row_sum, delta: (B, H, S) float32.  Each
// returns the cudaError_t of its launch.  The dq entry writes delta =
// rowsum(dout * o); run it before the dkv entry on the same stream, which
// reads it.

extern "C" int flexdm_flash_attention_bwd_dq_wide_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* o, const void* dout, const void* row_max, const void* row_sum,
    void* delta, void* dq, int B, int H, int S, int Dh, int causal,
    void* stream) {
  return launch_dq(q, k, v, key_mask, o, dout, row_max, row_sum, delta, dq,
                   B, H, S, Dh, causal, stream);
}

extern "C" int flexdm_flash_attention_bwd_dkv_wide_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* row_max, const void* row_sum,
    const void* delta, void* dk, void* dv, int B, int H, int S, int Dh,
    int causal, void* stream) {
  return launch_dkv(q, k, v, key_mask, dout, row_max, row_sum, delta, dk,
                    dv, B, H, S, Dh, causal, stream);
}
