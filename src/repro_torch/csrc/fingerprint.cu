// Per-chunk lane fingerprints of raw words, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fingerprint.py:fingerprint_lanes
// (pallas_call body _fp_kernel).  For words [C, R, 128] (uint32 bits) it
// computes, for each chunk c and lane j,
//     out[c, j] = sum_r w[c, r, j] * (mix32((r + 1) * 0x9E3779B1) | 1)
// with wrapping uint32 arithmetic (csrc/fingerprint.cuh).  Modular
// addition is associative and commutative, so any reduction order gives
// the same bits as the reference.
//
// What bounds it: bytes.  The kernel reads each word once and does two
// integer operations on it.  A 4 MiB KV leaf of the paper consumer (one
// registry chunk, [1, 8192, 128] words) takes about 1.25 us at the H100
// data sheet's 3.35 TB/s.
//
// What the design does about it: the TPU kernel streams a chunk's rows
// through one core as a sequential grid axis.  Here a chunk's rows are cut
// into runs of kRowsPerBlock rows, one block each, so a single chunk
// already spreads over 32 SMs.  Each warp reads one 512-byte row per step
// (16 bytes a thread, neighbouring threads on neighbouring addresses); a
// row's weight is computed in registers, never loaded.  The block sums its
// warps in shared memory and adds its 128 lane sums to the output with
// atomicAdd, which is exact for uint32.

#include "fingerprint.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps; a warp covers the 128 lanes of a row
constexpr int kRowSteps = kThreads / 32;
constexpr int kRowsPerBlock = 256;

// words [C, R, 128] as uint4 [C, R, 32]; out [C, 128], zeroed.
__global__ void __launch_bounds__(kThreads)
fingerprint_lanes_kernel(const uint4* __restrict__ words,
                         uint32_t* __restrict__ out, int R) {
  const int c = blockIdx.y;
  const int quad = threadIdx.x & 31;   // lanes 4*quad .. 4*quad+3
  const int step = threadIdx.x >> 5;   // row offset inside a step
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(R, r0 + kRowsPerBlock);
  const uint4* base = words + (size_t)c * R * (kLanes / 4);
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int r = r0 + step; r < r1; r += kRowSteps)
    add_weighted(acc, base[(size_t)r * (kLanes / 4) + quad], row_weight(r));
  block_add_lanes<kRowSteps>(acc, out + (size_t)c * kLanes);
}

}  // namespace

// words: [C, R, 128] 32-bit words, 16-byte aligned; out: [C, 128].
// Returns the CUDA error code of the memset and launch (0 on success).
extern "C" int fingerprint_lanes_launch(const void* words, void* out, int C,
                                        int R, void* stream) {
  if (C < 1 || C > 65535 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(uint32_t) * kLanes * (size_t)C, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, C);
  fingerprint_lanes_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(words), static_cast<uint32_t*>(out), R);
  return static_cast<int>(cudaGetLastError());
}
