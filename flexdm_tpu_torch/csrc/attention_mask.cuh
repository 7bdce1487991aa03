// The attention kernels' masking, shared by every source: the finite key
// bias of a masked key and the score that replaces one outside the causal
// band.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kMaskedScore = -1e9f;

// The additive bias of a key: 0 if attended, the finite -1e9 if masked or
// past S (callers exclude keys past S outright where it matters).
__device__ __forceinline__ float key_bias(const uint8_t* key_mask, int b,
                                          int S, int key) {
  const bool keep = key < S && (key_mask == nullptr ||
                                key_mask[static_cast<size_t>(b) * S + key]);
  return keep ? 0.f : kMaskedScore;
}

}  // namespace
