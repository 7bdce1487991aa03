// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel flexdm_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_forward).  Same contract: for every (batch, head,
// query row) it computes softmax(q k^T / sqrt(Dh) + bias) v with an online
// softmax over key tiles (running max m, running sum l, accumulator acc in
// f32) and writes O (B, H, S, Dh), the row logsumexp (B, H, S), and the
// row max m and row sum l (B, H, S) that the backward kernels rebuild the
// probabilities from (p = exp(s - m) / l; see flash_attention_bwd.cu for
// why lse alone is not enough).
//
// Masking follows the plain reference (_attention_xla), not the padded TPU
// path:
//   * a key whose mask entry is false gets the FINITE additive bias -1e9,
//     so a fully masked row averages V over the S real keys instead of
//     producing NaN;
//   * with `causal`, a key after the query row (absolute positions) gets the
//     score -1e9 (replaced, like jnp.where in the reference);
//   * keys at index >= S (the ragged tail of the last tile) are excluded
//     outright (score -inf, p = 0): nothing is padded in device memory.
//
// What bounds it on the H100.  At the serving shape (B=8, H=8, S=50,
// Dh=32) the whole call moves ~0.4 MB and does ~10 MFLOP: it is a
// latency-bound launch, far from both the memory and the FP32 roofline.
// One block per (batch, head, 64-row q-tile) would give 64 blocks for 132
// SMs, so the q-tile here is 16 rows (4 warps x 4 rows): 256 blocks at the
// serving shape, each staging its head's K/V tile in shared memory once
// (12.8 KB at S=50) and reading it from there for all 16 rows.  Scores are
// computed key-parallel (one key per lane, K rows padded to Dh+1 floats so
// the 32 lanes hit 32 different banks), P.V dim-parallel (one output column
// per lane), so no lane holds a whole Dh-vector of q or acc.  Plain FMA
// pipes, no tensor cores: wgmma, TMA and warp specialisation are left for
// a later, larger-shape tuning pass.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr float kMaskedScore = -1e9f;

template <int DH>
struct TileShape {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  // Keys per shared-memory tile: 64 keeps K+V at 33 KB for Dh=64; Dh=128
  // halves it to stay under the 48 KB static shared-memory limit.
  static constexpr int kBlockK = DH <= 64 ? 64 : 32;
  static constexpr int kKeysPerLane = kBlockK / 32;
  static constexpr int kDimsPerLane = DH / 32;
  static constexpr int kKStride = DH + 1;  // bank-conflict-free K rows
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ key_mask,
                 float* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ row_max, float* __restrict__ row_sum,
                 int H, int S, int causal, float scale) {
  using T = TileShape<DH>;
  constexpr int BK = T::kBlockK;
  __shared__ float q_s[kBlockQ][DH];
  __shared__ float k_s[BK][T::kKStride];
  __shared__ float v_s[BK][DH];
  __shared__ float bias_s[BK];
  __shared__ float p_s[kWarps][BK];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * S;  // row of (b,h,0)
  const float* qh = q + head * DH;
  const float* kh = k + head * DH;
  const float* vh = v + head * DH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kBlockQ * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    const int row = q0 + r;
    q_s[r][c] = row < S ? qh[static_cast<size_t>(row) * DH + c] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][T::kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < T::kDimsPerLane; ++e) acc[rr][e] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      const int key = k0 + r;
      const bool real = key < S;
      const size_t off = static_cast<size_t>(key) * DH + c;
      k_s[r][c] = real ? kh[off] : 0.f;
      v_s[r][c] = real ? vh[off] : 0.f;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      const bool keep = key < S && (key_mask == nullptr ||
                                    key_mask[static_cast<size_t>(b) * S + key]);
      bias_s[tid] = keep ? 0.f : kMaskedScore;
    }
    __syncthreads();

    // Keys of this tile that exist; the tile's first key always does, so
    // every row's running max is finite after the first tile.
    const int n_keys = min(BK, S - k0);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = q0 + r;
      float s[T::kKeysPerLane];
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < T::kKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        const int key = k0 + j;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) dot = fmaf(q_s[r][d], k_s[j][d], dot);
        float score;
        if (j >= n_keys) {
          score = -CUDART_INF_F;
        } else if (causal && key > row) {
          score = kMaskedScore;
        } else {
          score = dot * scale + bias_s[j];
        }
        s[t] = score;
        tile_max = fmaxf(tile_max, score);
      }
      tile_max = warp_max(tile_max);
      const float m_new = fmaxf(m[rr], tile_max);
      const float alpha = expf(m[rr] - m_new);  // 0 on the first tile
      float p_sum = 0.f;
#pragma unroll
      for (int t = 0; t < T::kKeysPerLane; ++t) {
        const float p = expf(s[t] - m_new);
        p_s[warp][lane + 32 * t] = p;
        p_sum += p;
      }
      l[rr] = l[rr] * alpha + warp_sum(p_sum);
      m[rr] = m_new;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < T::kDimsPerLane; ++e) {
        const int c = lane + 32 * e;
        float a = acc[rr][e] * alpha;
        for (int j = 0; j < n_keys; ++j) a = fmaf(p_s[warp][j], v_s[j][c], a);
        acc[rr][e] = a;
      }
      __syncwarp();  // p_s is rewritten by the next row
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= S) continue;
    float* orow = o + (head + row) * DH;
#pragma unroll
    for (int e = 0; e < T::kDimsPerLane; ++e)
      orow[lane + 32 * e] = acc[rr][e] / l[rr];
    if (lane == 0) {
      lse[head + row] = m[rr] + logf(l[rr]);
      row_max[head + row] = m[rr];
      row_sum[head + row] = l[rr];
    }
  }
}

template <int DH>
void launch(const float* q, const float* k, const float* v,
            const uint8_t* key_mask, float* o, float* lse, float* row_max,
            float* row_sum, int B, int H, int S, int causal,
            cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_fwd_kernel<DH><<<grid, kThreads, 0, stream>>>(
      q, k, v, key_mask, o, lse, row_max, row_sum, H, S, causal, scale);
}

}  // namespace

// q, k, v, o: (B, H, S, Dh) float32, contiguous.  key_mask: (B, S) bool
// (one byte per key, nonzero = attend) or null for "all keys valid".
// lse, row_max, row_sum: (B, H, S) float32.  Returns the cudaError_t of
// the launch.
extern "C" int flexdm_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* key_mask,
                                          void* o, void* lse, void* row_max,
                                          void* row_sum, int B, int H, int S,
                                          int Dh, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  auto* mf = static_cast<float*>(row_max);
  auto* sf = static_cast<float*>(row_sum);
  auto st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32:
      launch<32>(qf, kf, vf, mask, of, lf, mf, sf, B, H, S, causal, st);
      break;
    case 64:
      launch<64>(qf, kf, vf, mask, of, lf, mf, sf, B, H, S, causal, st);
      break;
    case 128:
      launch<128>(qf, kf, vf, mask, of, lf, mf, sf, B, H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
