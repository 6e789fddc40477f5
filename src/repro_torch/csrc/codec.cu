// Fused chunk fingerprint + delta encoding, for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/codec.py:
//   * xor_fp_lanes  (pallas_call body _xor_fp_kernel): for words
//     cur, par [C, R, 128] it writes the fingerprint lanes of cur [C, 128]
//     and the XOR words cur ^ par [C, R, 128];
//   * int8_fp_lanes (pallas_call body _int8_fp_kernel): for R even it
//     writes the fingerprint lanes of cur and the blockwise int8
//     quantization of the float32 delta cur - par: 256-float quant blocks
//     (two rows each), q [C, R/2, 256] int8 and scale [C, R/2] float32.
// The lane sums are csrc/fingerprint.cuh's, so the fingerprints equal the
// plain fingerprint kernel's bit for bit.
//
// The quantizer is repro/optim/compression.py:_quant, to the bit:
//   d     = __fsub_rn(cur, par)           (never contracted into an FMA)
//   scale = max(__fmul_rn(max|d|, 1/127), 1e-12)   (both maxima keep NaN)
//   q     = clip(rint(__fdiv_rn(d, scale)), -127, 127), NaN -> 0
// rint rounds half to even, as jnp.round does.  A NaN scale is written as
// the quiet NaN 0x7FC00000, the NaN the reference stores for NaNs made by
// numpy or x86 arithmetic (the card's own arithmetic makes 0x7FFFFFFF).
// The build must not use --use_fast_math: its division is not IEEE.
//
// What bounds them: bytes.  Each reads cur and par once and writes its
// outputs once, with a few integer and float operations per word.  At the
// paper consumer's fold shape (one 4 MiB chunk, [1, 8192, 128] words) the
// XOR kernel moves 12,583,424 bytes (3.756 us at the H100 data sheet's
// 3.35 TB/s) and the int8 kernel, which stores q as int8, 9,454,080
// bytes (2.822 us).
//
// What the design does about it: the TPU kernels walk a chunk's rows as a
// sequential grid axis and carry the lane sums in VMEM scratch.  Here a
// chunk's rows are cut into tiles of 16 rows, one block each, over a flat
// grid of C * tiles blocks, so a single 4 MiB chunk spreads over 512
// blocks (about four per SM, enough loads in flight to keep the memory
// busy) and a serving leaf of 1024 small chunks over 1024 blocks.  Every load
// and store of words is 16 bytes a thread, neighbouring threads on
// neighbouring addresses; row weights are computed in registers.  In the
// int8 kernel one quant block belongs to one warp: each thread holds 8 of
// its 256 deltas, the warp takes the block maximum by butterfly shuffles
// (every lane ends with the same value), and each thread writes its 8
// int8 values as two 4-byte stores.  Blocks add their lane sums with
// uint32 atomicAdd (csrc/fingerprint.cuh); there are no float atomics.

#include "fingerprint.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;  // rows per block (even: quant blocks never straddle)
constexpr float kInv127 = 0x1.020408p-7f;       // float32(1) / float32(127)
constexpr float kScaleFloor = 0x1.197998p-40f;  // float32(1e-12)
constexpr uint32_t kQuietNaN = 0x7FC00000u;

// max that returns NaN when either side is NaN (jnp.max / jnp.maximum)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ int8_t quantize(float d, float scale) {
  const float x = rintf(__fdiv_rn(d, scale));
  if (x != x) return 0;  // XLA converts NaN to 0
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(x, -127.f), 127.f)));
}

__device__ __forceinline__ float delta(uint32_t cur, uint32_t par) {
  return __fsub_rn(__uint_as_float(cur), __uint_as_float(par));
}

// cur, par, xr: [C, R, 128] words as uint4 [C, R, 32]; lanes [C, 128], zeroed.
__global__ void __launch_bounds__(kThreads)
xor_fp_kernel(const uint4* __restrict__ cur, const uint4* __restrict__ par,
              uint32_t* __restrict__ lanes, uint4* __restrict__ xr, int R,
              int tiles) {
  const int c = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kTileRows;
  const int r1 = min(R, r0 + kTileRows);
  const int quad = threadIdx.x & 31;
  const size_t base = (size_t)c * R * (kLanes / 4) + quad;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int r = r0 + (threadIdx.x >> 5); r < r1; r += kWarps) {
    const size_t i = base + (size_t)r * (kLanes / 4);
    const uint4 a = cur[i];
    const uint4 b = par[i];
    xr[i] = make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    add_weighted(acc, a, row_weight(r));
  }
  block_add_lanes<kWarps>(acc, lanes + (size_t)c * kLanes);
}

// cur, par: [C, R, 128] words (R even); lanes [C, 128], zeroed;
// q [C, R/2, 256] int8; scale [C, R/2].
__global__ void __launch_bounds__(kThreads)
int8_fp_kernel(const uint4* __restrict__ cur, const uint4* __restrict__ par,
               uint32_t* __restrict__ lanes, int8_t* __restrict__ q,
               float* __restrict__ scale, int R, int tiles) {
  const int c = blockIdx.x / tiles;
  const int nb = R / 2;  // quant blocks per chunk
  const int b0 = (blockIdx.x % tiles) * (kTileRows / 2);
  const int b1 = min(nb, b0 + kTileRows / 2);
  const int quad = threadIdx.x & 31;
  const size_t base = (size_t)c * R * (kLanes / 4) + quad;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int b = b0 + (threadIdx.x >> 5); b < b1; b += kWarps) {
    const int r = 2 * b;
    const size_t i0 = base + (size_t)r * (kLanes / 4);
    const size_t i1 = i0 + kLanes / 4;
    const uint4 c0 = cur[i0], c1 = cur[i1];
    const uint4 p0 = par[i0], p1 = par[i1];
    add_weighted(acc, c0, row_weight(r));
    add_weighted(acc, c1, row_weight(r + 1));
    const float d[8] = {delta(c0.x, p0.x), delta(c0.y, p0.y),
                        delta(c0.z, p0.z), delta(c0.w, p0.w),
                        delta(c1.x, p1.x), delta(c1.y, p1.y),
                        delta(c1.z, p1.z), delta(c1.w, p1.w)};
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) m = nan_max(m, fabsf(d[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = nan_max(__fmul_rn(m, kInv127), kScaleFloor);
    int8_t* qb = q + ((size_t)c * nb + b) * 256;
    *reinterpret_cast<char4*>(qb + 4 * quad) =
        make_char4(quantize(d[0], s), quantize(d[1], s), quantize(d[2], s),
                   quantize(d[3], s));
    *reinterpret_cast<char4*>(qb + 128 + 4 * quad) =
        make_char4(quantize(d[4], s), quantize(d[5], s), quantize(d[6], s),
                   quantize(d[7], s));
    if (quad == 0)
      scale[(size_t)c * nb + b] = s != s ? __uint_as_float(kQuietNaN) : s;
  }
  block_add_lanes<kWarps>(acc, lanes + (size_t)c * kLanes);
}

cudaError_t grid_for(int C, int R, int* tiles, int* blocks) {
  if (C < 1 || R < 1) return cudaErrorInvalidValue;
  *tiles = (R + kTileRows - 1) / kTileRows;
  if ((long long)C * *tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  *blocks = C * *tiles;
  return cudaSuccess;
}

}  // namespace

// cur, par, xr: [C, R, 128] 32-bit words, 16-byte aligned; lanes [C, 128].
// Returns the CUDA error code of the memset and launch (0 on success).
extern "C" int xor_fp_lanes_launch(const void* cur, const void* par,
                                   void* lanes, void* xr, int C, int R,
                                   void* stream) {
  int tiles, blocks;
  cudaError_t err = grid_for(C, R, &tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(lanes, 0, sizeof(uint32_t) * kLanes * (size_t)C, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  xor_fp_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint4*>(cur), static_cast<const uint4*>(par),
      static_cast<uint32_t*>(lanes), static_cast<uint4*>(xr), R, tiles);
  return static_cast<int>(cudaGetLastError());
}

// cur, par: [C, R, 128] 32-bit words, 16-byte aligned, R even;
// lanes [C, 128]; q [C, R/2, 256] int8, 4-byte aligned; scale [C, R/2].
extern "C" int int8_fp_lanes_launch(const void* cur, const void* par,
                                    void* lanes, void* q, void* scale, int C,
                                    int R, void* stream) {
  if (R % 2) return static_cast<int>(cudaErrorInvalidValue);
  int tiles, blocks;
  cudaError_t err = grid_for(C, R, &tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(lanes, 0, sizeof(uint32_t) * kLanes * (size_t)C, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_fp_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint4*>(cur), static_cast<const uint4*>(par),
      static_cast<uint32_t*>(lanes), static_cast<int8_t*>(q),
      static_cast<float*>(scale), R, tiles);
  return static_cast<int>(cudaGetLastError());
}
