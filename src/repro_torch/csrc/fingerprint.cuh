// Chunk fingerprint arithmetic shared by csrc/fingerprint.cu and
// csrc/codec.cu (one definition, so the fused codec kernels give the same
// lane sums as the plain fingerprint kernel).
//
// A chunk is [R, 128] 32-bit words; lane j of the chunk accumulates
//     sum_r word[r, j] * row_weight(r)   (mod 2^32)
// with row_weight(r) = mix32((r + 1) * 0x9E3779B1) | 1, r the row index
// inside the chunk.  Modular sums give the same bits in any order, so
// blocks may combine their partial lane sums in any order: the fused codec
// kernels add them with atomicAdd, the fingerprint kernel through a
// thread-block cluster's shared memory.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr uint32_t kGold = 0x9E3779B1u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t row_weight(int r) {
  return mix32(static_cast<uint32_t>(r + 1) * kGold) | 1u;
}

// acc += x * w, lane by lane (x holds lanes 4*quad .. 4*quad+3 of a row).
__device__ __forceinline__ void add_weighted(uint4& acc, const uint4 x,
                                             uint32_t w) {
  acc.x += x.x * w;
  acc.y += x.y * w;
  acc.z += x.z * w;
  acc.w += x.w * w;
}

// Sum the partial lane sums of the block's kWarps warps (thread t of a
// warp holds lanes 4*(t%32) .. +3) and add them to out[0..127] with
// atomicAdd.  Every thread of the block must call it.
template <int kWarps>
__device__ __forceinline__ void block_add_lanes(uint4 acc, uint32_t* out) {
  __shared__ uint4 part[kWarps][32];
  const int quad = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  part[warp][quad] = acc;
  __syncthreads();
  if (warp == 0) {
    for (int s = 1; s < kWarps; ++s) {
      const uint4 p = part[s][quad];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    uint32_t* o = out + 4 * quad;
    atomicAdd(o + 0, acc.x);
    atomicAdd(o + 1, acc.y);
    atomicAdd(o + 2, acc.z);
    atomicAdd(o + 3, acc.w);
  }
}

}  // namespace
