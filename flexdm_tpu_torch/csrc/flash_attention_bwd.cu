// Flash-attention backward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels of flexdm_tpu/ops/attention.py:
//   * _flash_bwd_dq_kernel and _flash_bwd_dq_stream_kernel -> the dq kernel
//     here, which also computes delta = rowsum(dO * O) (the XLA glue of
//     _attention_pallas_bwd) for its rows and writes it for the dkv kernel;
//   * _flash_bwd_dkv_kernel and _flash_bwd_dkv_stream_kernel -> the dkv
//     kernel here.
// The TPU needed the stream variants because its resident form kept whole
// (S, Dh) arrays in VMEM and overflowed the 16 MB limit from S=4096.  These
// kernels keep only tiles in shared memory and loop over the other axis
// inside the block, so one kernel covers every S.
//
// Contract (the plain version is attention_reference_backward in
// ops/attention.py, written out as the formulas autograd computes):
//   p     = softmax(s),  s = q k^T / sqrt(Dh) + bias, causal band replaced
//   delta = rowsum(dO * O)
//   ds    = p * (dO v^T - delta), and 0 where the causal band replaced s
//           (the replacement is a jnp.where / masked_fill: no gradient)
//   dq    = scale * ds k,   dk = scale * ds^T q,   dv = p^T dO
//
// p is rebuilt as exp(s - m) / l from the forward's row max m and row sum l,
// NOT as exp(s - lse).  In a fully masked row every score is -1e9 + q.k,
// which rounds to exactly -1e9 in float32 (the spacing of floats at 1e9 is
// 64), so lse = m + log(l) also rounds to m and exp(s - lse) gives p = 1 for
// every key, where the softmax gives 1/S.  The TPU kernels rebuild p from
// lse and differ from their own plain path there; these follow the plain
// path.  Masking is the forward's, bit for bit (same score expression and
// summation order): finite -1e9 for masked keys, causal band replaced by
// -1e9 on absolute positions, keys at index >= S excluded outright.
//
// What bounds it on the H100.  At the training shape (B=256, H=8, S=50,
// Dh=32) each (b, h) is a 50x50 problem: ~0.5 MFLOP and ~40 KB, so the
// kernels are bound by latency and by shared-memory traffic, far from the
// FP32 and memory rooflines.  The design keeps blocks many and small
// (16-row q-tiles and 16-key k-tiles: 8192 blocks each at that shape) and
// every shared-memory access conflict-free: rows whose elements are read
// by consecutive lanes at a fixed column are padded to Dh+1 floats.  Plain
// FMA pipes, no tensor cores, no atomics: every output element is written
// by exactly one thread, so results are deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskedScore = -1e9f;
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// ---------------------------------------------------------------------------
// dq (and delta): one block per (batch, head, 16-row q-tile).  Each warp owns
// 4 query rows.  The block stages its Q and dO rows once, then loops over
// K/V tiles in shared memory.  Per row: scores and dO.v^T one key per lane
// (K and V rows padded to Dh+1), then dq += ds.K one output column per lane.
// ---------------------------------------------------------------------------

constexpr int kDqRowsPerWarp = 4;
constexpr int kDqBlockQ = kWarps * kDqRowsPerWarp;

template <int DH>
struct DqShape {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kBlockK = DH <= 64 ? 64 : 32;
  static constexpr int kKeysPerLane = kBlockK / 32;
  static constexpr int kDimsPerLane = DH / 32;
  static constexpr int kStride = DH + 1;
  static constexpr int kSmemFloats = 2 * kDqBlockQ * DH       // q, dO
                                     + 2 * kBlockK * kStride  // k, v
                                     + kBlockK                // key bias
                                     + kWarps * kBlockK;      // ds per warp
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ key_mask,
                    const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ row_max,
                    const float* __restrict__ row_sum,
                    float* __restrict__ delta, float* __restrict__ dq, int H,
                    int S, int causal, float scale) {
  using T = DqShape<DH>;
  constexpr int BK = T::kBlockK;
  constexpr int R = kDqRowsPerWarp;
  extern __shared__ float smem[];
  float* q_s = smem;                       // [kDqBlockQ][DH]
  float* do_s = q_s + kDqBlockQ * DH;      // [kDqBlockQ][DH]
  float* k_s = do_s + kDqBlockQ * DH;      // [BK][DH + 1]
  float* v_s = k_s + BK * T::kStride;      // [BK][DH + 1]
  float* bias_s = v_s + BK * T::kStride;   // [BK]
  float* ds_s = bias_s + BK;               // [kWarps][BK]

  const int q0 = blockIdx.x * kDqBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * S;  // row of (b,h,0)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kDqBlockQ * DH; i += kThreads) {
    const int row = q0 + i / DH;
    const size_t off = (head + row) * DH + i % DH;
    q_s[i] = row < S ? q[off] : 0.f;
    do_s[i] = row < S ? dout[off] : 0.f;
  }

  // Row statistics.  A row past S gets inv_l = 0, so its p and ds are 0.
  float m[R], inv_l[R], dlt[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int row = q0 + warp * R + rr;
    float part = 0.f;
    if (row < S) {
#pragma unroll
      for (int e = 0; e < T::kDimsPerLane; ++e) {
        const size_t off = (head + row) * DH + lane + 32 * e;
        part = fmaf(dout[off], o[off], part);
      }
    }
    dlt[rr] = warp_sum(part);
    m[rr] = row < S ? row_max[head + row] : 0.f;
    inv_l[rr] = row < S ? 1.f / row_sum[head + row] : 0.f;
    if (row < S && lane == 0) delta[head + row] = dlt[rr];
  }

  float acc[R][T::kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int e = 0; e < T::kDimsPerLane; ++e) acc[rr][e] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      const int key = k0 + r;
      const bool real = key < S;
      const size_t off = (head + key) * DH + c;
      k_s[r * T::kStride + c] = real ? k[off] : 0.f;
      v_s[r * T::kStride + c] = real ? v[off] : 0.f;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      const bool keep = key < S && (key_mask == nullptr ||
                                    key_mask[static_cast<size_t>(b) * S + key]);
      bias_s[tid] = keep ? 0.f : kMaskedScore;
    }
    __syncthreads();

    const int n_keys = min(BK, S - k0);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int r = warp * R + rr;
      const int row = q0 + r;
#pragma unroll
      for (int t = 0; t < T::kKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        const int key = k0 + j;
        float dot = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          dot = fmaf(q_s[r * DH + d], k_s[j * T::kStride + d], dot);
          dpv = fmaf(do_s[r * DH + d], v_s[j * T::kStride + d], dpv);
        }
        float ds = 0.f;
        if (j < n_keys) {
          const bool replaced = causal && key > row;
          const float s = replaced ? kMaskedScore : dot * scale + bias_s[j];
          const float p = expf(s - m[rr]) * inv_l[rr];
          ds = replaced ? 0.f : p * (dpv - dlt[rr]);
        }
        ds_s[warp * BK + j] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < T::kDimsPerLane; ++e) {
        const int c = lane + 32 * e;
        float a = acc[rr][e];
        for (int j = 0; j < n_keys; ++j)
          a = fmaf(ds_s[warp * BK + j], k_s[j * T::kStride + c], a);
        acc[rr][e] = a;
      }
      __syncwarp();  // ds_s is rewritten by the next row
    }
  }

#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int row = q0 + warp * R + rr;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < T::kDimsPerLane; ++e)
      dq[(head + row) * DH + lane + 32 * e] = acc[rr][e] * scale;
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (batch, head, 16-key k-tile).  Each warp owns 4 keys
// and keeps their dk and dv rows in registers (one column per lane).  The
// block loops over 32-row Q/dO tiles: per key, scores and dO.v^T one query
// row per lane (Q and dO rows padded to Dh+1), then dv += p^T dO and
// dk += ds^T Q one output column per lane.
// ---------------------------------------------------------------------------

constexpr int kDkvKeysPerWarp = 4;
constexpr int kDkvBlockK = kWarps * kDkvKeysPerWarp;
constexpr int kDkvBlockQ = 32;  // one query row per lane

template <int DH>
struct DkvShape {
  static_assert(DH % 32 == 0, "head dim must be a multiple of 32");
  static constexpr int kDimsPerLane = DH / 32;
  static constexpr int kStride = DH + 1;
  static constexpr int kSmemFloats = 2 * kDkvBlockK * DH        // k, v
                                     + 2 * kDkvBlockQ * kStride  // q, dO
                                     + 3 * kDkvBlockQ            // m, 1/l, delta
                                     + 2 * kWarps * kDkvBlockQ;  // p, ds
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ key_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ row_max,
                     const float* __restrict__ row_sum,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int S, int causal,
                     float scale) {
  using T = DkvShape<DH>;
  constexpr int BQ = kDkvBlockQ;
  constexpr int KPW = kDkvKeysPerWarp;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [kDkvBlockK][DH]
  float* v_s = k_s + kDkvBlockK * DH;       // [kDkvBlockK][DH]
  float* q_s = v_s + kDkvBlockK * DH;       // [BQ][DH + 1]
  float* do_s = q_s + BQ * T::kStride;      // [BQ][DH + 1]
  float* m_s = do_s + BQ * T::kStride;      // [BQ]
  float* inv_l_s = m_s + BQ;                // [BQ]
  float* delta_s = inv_l_s + BQ;            // [BQ]
  float* p_s = delta_s + BQ;                // [kWarps][BQ]
  float* ds_s = p_s + kWarps * BQ;          // [kWarps][BQ]

  const int k0 = blockIdx.x * kDkvBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * S;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kDkvBlockK * DH; i += kThreads) {
    const int key = k0 + i / DH;
    const size_t off = (head + key) * DH + i % DH;
    k_s[i] = key < S ? k[off] : 0.f;
    v_s[i] = key < S ? v[off] : 0.f;
  }

  bool real[KPW];
  float kbias[KPW];
  float acc_dk[KPW][T::kDimsPerLane], acc_dv[KPW][T::kDimsPerLane];
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    const int key = k0 + warp * KPW + kk;
    real[kk] = key < S;
    const bool keep = real[kk] &&
        (key_mask == nullptr || key_mask[static_cast<size_t>(b) * S + key]);
    kbias[kk] = keep ? 0.f : kMaskedScore;
#pragma unroll
    for (int e = 0; e < T::kDimsPerLane; ++e) {
      acc_dk[kk][e] = 0.f;
      acc_dv[kk][e] = 0.f;
    }
  }

  for (int i0 = 0; i0 < S; i0 += BQ) {
    __syncthreads();  // the previous tile is consumed (and k_s is staged)
    for (int i = tid; i < BQ * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      const int row = i0 + r;
      const size_t off = (head + row) * DH + c;
      q_s[r * T::kStride + c] = row < S ? q[off] : 0.f;
      do_s[r * T::kStride + c] = row < S ? dout[off] : 0.f;
    }
    if (tid < BQ) {
      const int row = i0 + tid;
      m_s[tid] = row < S ? row_max[head + row] : 0.f;
      inv_l_s[tid] = row < S ? 1.f / row_sum[head + row] : 0.f;
      delta_s[tid] = row < S ? delta[head + row] : 0.f;
    }
    __syncthreads();

    const int n_rows = min(BQ, S - i0);
    const int row = i0 + lane;
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) {
      const int j = warp * KPW + kk;
      const int key = k0 + j;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        dot = fmaf(q_s[lane * T::kStride + d], k_s[j * DH + d], dot);
        dpv = fmaf(do_s[lane * T::kStride + d], v_s[j * DH + d], dpv);
      }
      float p = 0.f, ds = 0.f;
      if (lane < n_rows && real[kk]) {
        const bool replaced = causal && key > row;
        const float s = replaced ? kMaskedScore : dot * scale + kbias[kk];
        p = expf(s - m_s[lane]) * inv_l_s[lane];
        ds = replaced ? 0.f : p * (dpv - delta_s[lane]);
      }
      p_s[warp * BQ + lane] = p;
      ds_s[warp * BQ + lane] = ds;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < T::kDimsPerLane; ++e) {
        const int c = lane + 32 * e;
        float a_v = acc_dv[kk][e], a_k = acc_dk[kk][e];
        for (int i = 0; i < n_rows; ++i) {
          a_v = fmaf(p_s[warp * BQ + i], do_s[i * T::kStride + c], a_v);
          a_k = fmaf(ds_s[warp * BQ + i], q_s[i * T::kStride + c], a_k);
        }
        acc_dv[kk][e] = a_v;
        acc_dk[kk][e] = a_k;
      }
      __syncwarp();  // p_s and ds_s are rewritten by the next key
    }
  }

#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    if (!real[kk]) continue;
    const size_t key_row = head + k0 + warp * KPW + kk;
#pragma unroll
    for (int e = 0; e < T::kDimsPerLane; ++e) {
      dk[key_row * DH + lane + 32 * e] = acc_dk[kk][e] * scale;
      dv[key_row * DH + lane + 32 * e] = acc_dv[kk][e];
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be opted into, once per
// kernel instance.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const uint8_t* key_mask, const float* o,
                      const float* dout, const float* row_max,
                      const float* row_sum, float* delta, float* dq, int B,
                      int H, int S, int causal, cudaStream_t stream) {
  constexpr int bytes = DqShape<DH>::kSmemFloats * sizeof(float);
  static const cudaError_t attr = allow_smem(flash_bwd_dq_kernel<DH>, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kDqBlockQ - 1) / kDqBlockQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dq_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, o, dout, row_max, row_sum, delta, dq, H, S, causal,
      scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const uint8_t* key_mask, const float* dout,
                       const float* row_max, const float* row_sum,
                       const float* delta, float* dk, float* dv, int B, int H,
                       int S, int causal, cudaStream_t stream) {
  constexpr int bytes = DkvShape<DH>::kSmemFloats * sizeof(float);
  static const cudaError_t attr = allow_smem(flash_bwd_dkv_kernel<DH>, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kDkvBlockK - 1) / kDkvBlockK, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  flash_bwd_dkv_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, key_mask, dout, row_max, row_sum, delta, dk, dv, H, S, causal,
      scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int S) {
  return B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// All tensors float32 and contiguous: q, k, v, o, dout, dq, dk, dv are
// (B, H, S, Dh); row_max, row_sum (from the forward) and delta are
// (B, H, S).  key_mask: (B, S) bool (nonzero = attend) or null.  Each entry
// returns the cudaError_t of its launch.

// Writes dq and delta = rowsum(dout * o).  Run it before the dkv entry on
// the same stream: dkv reads delta.
extern "C" int flexdm_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* o, const void* dout, const void* row_max, const void* row_sum,
    void* delta, void* dq, int B, int H, int S, int Dh, int causal,
    void* stream) {
  if (bad_shape(B, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* of = static_cast<const float*>(o);
  const auto* df = static_cast<const float*>(dout);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  auto* deltaf = static_cast<float*>(delta);
  auto* dqf = static_cast<float*>(dq);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch_dq<32>(qf, kf, vf, mask, of, df, mf, sf, deltaf, dqf, B, H,
                          S, causal, st);
      break;
    case 64:
      err = launch_dq<64>(qf, kf, vf, mask, of, df, mf, sf, deltaf, dqf, B, H,
                          S, causal, st);
      break;
    case 128:
      err = launch_dq<128>(qf, kf, vf, mask, of, df, mf, sf, deltaf, dqf, B,
                           H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Writes dk and dv; reads the delta written by flexdm_flash_attention_bwd_dq.
extern "C" int flexdm_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* row_max, const void* row_sum,
    const void* delta, void* dk, void* dv, int B, int H, int S, int Dh,
    int causal, void* stream) {
  if (bad_shape(B, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mask = static_cast<const uint8_t*>(key_mask);
  const auto* df = static_cast<const float*>(dout);
  const auto* mf = static_cast<const float*>(row_max);
  const auto* sf = static_cast<const float*>(row_sum);
  const auto* deltaf = static_cast<const float*>(delta);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 32:
      err = launch_dkv<32>(qf, kf, vf, mask, df, mf, sf, deltaf, dkf, dvf, B,
                           H, S, causal, st);
      break;
    case 64:
      err = launch_dkv<64>(qf, kf, vf, mask, df, mf, sf, deltaf, dkf, dvf, B,
                           H, S, causal, st);
      break;
    case 128:
      err = launch_dkv<128>(qf, kf, vf, mask, df, mf, sf, deltaf, dkf, dvf, B,
                            H, S, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
