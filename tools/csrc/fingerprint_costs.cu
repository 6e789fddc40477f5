// Variants of the chunk-fingerprint kernel that take its costs apart, for
// tools/profile_torch_mlstm_fp.py --costs (built there with nvcc; not part
// of the port's library).  One kernel, parametrized by what it varies:
//   * rows_per_block: the grid (256 rows a block gives one 4 MiB chunk 32
//     blocks, as the first port's kernel did; 32 rows gives 256);
//   * U: independent 16-byte row loads in flight a warp (1 or 4);
//   * store_partial: each block stores its 128 lane sums to its own 512
//     bytes instead of atomicAdd onto the chunk's 128 words (no combine:
//     the lanes are not the fingerprint, the time is the point);
//   * memset: the output zeroed by cudaMemsetAsync before the launch.
// The arithmetic is csrc/fingerprint.cuh's; block_add_lanes is the first
// port's combine (the fused codec kernels' first port used it too).

#include "../../src/repro_torch/csrc/fingerprint.cuh"

namespace {

// Sum the partial lane sums of the block's kWarps warps (thread t of a
// warp holds lanes 4*(t%32) .. +3) and add them to out[0..127] with
// atomicAdd.  Every thread of the block must call it.
__device__ __forceinline__ void block_add_lanes(uint4 acc, uint32_t* out) {
  __shared__ uint4 part[kWarps][32];
  const int quad = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  part[warp][quad] = acc;
  __syncthreads();
  if (warp == 0) {
    for (int s = 1; s < kWarps; ++s) add4(acc, part[s][quad]);
    uint32_t* o = out + 4 * quad;
    atomicAdd(o + 0, acc.x);
    atomicAdd(o + 1, acc.y);
    atomicAdd(o + 2, acc.z);
    atomicAdd(o + 3, acc.w);
  }
}

template <int U>
__global__ void __launch_bounds__(kThreads)
fp_variant_kernel(const uint4* __restrict__ words, uint32_t* __restrict__ out,
                  int R, int rows_per_block, int store_partial) {
  const int c = blockIdx.y;
  const int quad = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  const uint4* base = words + (size_t)c * R * (kLanes / 4) + quad;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int r = r0 + warp; r < r1; r += kWarps * U) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * kWarps;
      x[u] = rr < r1 ? base[(size_t)rr * (kLanes / 4)] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      add_weighted(acc, x[u], row_weight(r + u * kWarps));
  }
  if (store_partial) {
    __shared__ uint4 part[kWarps][32];
    part[warp][quad] = acc;
    __syncthreads();
    if (warp == 0) {
      for (int s = 1; s < kWarps; ++s) {
        acc.x += part[s][quad].x;
        acc.y += part[s][quad].y;
        acc.z += part[s][quad].z;
        acc.w += part[s][quad].w;
      }
      reinterpret_cast<uint4*>(out)[((size_t)c * gridDim.x + blockIdx.x) * 32 +
                                    quad] = acc;
    }
  } else {
    block_add_lanes(acc, out + (size_t)c * kLanes);
  }
}

}  // namespace

// out: [C, 128] words, or [C, blocks, 128] with store_partial.
extern "C" int fp_variant_launch(const void* words, void* out, int C, int R,
                                 int rows_per_block, int unroll,
                                 int store_partial, int memset,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + rows_per_block - 1) / rows_per_block, C);
  if (memset) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(uint32_t) * kLanes * (size_t)C *
                    (store_partial ? grid.x : 1), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (unroll == 4)
    fp_variant_kernel<4><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(words), static_cast<uint32_t*>(out), R,
        rows_per_block, store_partial);
  else
    fp_variant_kernel<1><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(words), static_cast<uint32_t*>(out), R,
        rows_per_block, store_partial);
  return static_cast<int>(cudaGetLastError());
}
