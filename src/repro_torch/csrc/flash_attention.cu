// Train/prefill GQA attention with causal and local-window masks, for
// sm_90a.  Two routes, chosen by the wrapper from (dtype, D) alone:
//
//   * bf16 with D % 16 == 0 (every bf16 head dim the models use: 64 for
//     smollm_360m, 256 for recurrentgemma_2b): flash_wgmma_kernel, on the
//     tensor cores (wgmma) with K/V tiles brought in by TMA;
//   * float32, and bf16 with another D: flash_attention_kernel, on the
//     float32 pipes.  Float32 stays off the tensor cores on purpose: their
//     float32 input is TF32 (10-bit mantissa), which is exactly the error
//     the paper consumer's card-vs-CPU training check must catch.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (pallas_call body _attn_kernel).  Same function: s = q.k^T in float32,
// scaled by sm_scale, the mask keeps key j for query i
// where i >= j (causal) and i - j < window (window > 0), masked scores are
// NEG_INF = -0.7 * FLT_MAX (finite, never -inf), the online softmax runs
// in float32 with (acc, m, l) per query row, and the output is
// acc / max(l, 1e-37) in q's dtype.  sm_scale comes from the wrapper:
// 1/sqrt(D) rounded in float32 (ref.attn_scale), as the plain version
// scales; the TPU kernel rounds 1/sqrt(D) from double, at most one ulp
// away.  The float32 route scales q before the product, as the plain
// version does; the wgmma route multiplies the float32 score after it
// (s = sm_scale * (q.k)), one rounding away from the plain version.
//
// What bounds it: at the training shapes, bytes on paper and neither in
// practice.  smollm_360m's layer (q [8,128,15,64], k/v [8,128,5,64],
// bf16, causal) moves 5.2 MB (1.6 us at 3.35 TB/s) and does about 252
// MFLOP of causal work (0.25 us on the bf16 tensor cores); at
// recurrentgemma_2b's 2304-token prefill ([2,2304,10,256] over one kv
// head, window 2048) the work is 54 GFLOP, 54 us on the tensor cores:
// operations.
//
// The wgmma route (flash_wgmma_kernel).  One CTA per (64 query rows, query
// head, batch row): one warpgroup of 4 warps, 16 rows a warp, which is
// wgmma's M of 64.  Not two warpgroups over 128 rows: at D 256 the output
// accumulator alone is 128 floats a thread, and at the serving prefill
// (Sq 32) or the smollm train shape (Sq 128: 240 CTAs of 64 rows on 132
// SMs) a 128-row tile would leave SMs idle.
//  * Tiles.  Q [64 x D] is loaded once and K, V [64 keys x D] per kv tile,
//    all by TMA through 4-D tensor maps over the [B, S, H, D] tensors as
//    they are, in boxes of 64 columns (128 bytes of bf16) with the
//    128-byte swizzle: D 256 is four boxes, D <= 64 one box whose columns
//    past D the TMA zero-fills without reading them.  One layout serves
//    every D % 16 == 0 (48 and 80 too, which no narrower swizzle fits); at
//    D 16 and 32 it costs shared memory and products on zero columns, not
//    bytes from device memory, and no model runs bf16 at those widths.
//    A ragged tile is
//    zero-filled within its batch row (the map's S dimension ends there),
//    so nothing of the next row is read, and nothing is transposed.  The
//    maps are encoded on the host in the launch function
//    (csrc/hopper.cuh: cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint, since the library links no libcuda) and
//    passed as __grid_constant__ params.
//  * Ring.  K and V tiles go into stages with one mbarrier each for K and
//    for V (expect_tx of the tile's bytes): 2 stages up to D 192, one at
//    D 256, where a CTA then takes 99 KB and two CTAs share an SM (one's
//    softmax runs while the other's products use the tensor cores).
//    Thread 0 is the producer: it refills a stage's K once every warp has
//    computed S from it, and its V once every warp is past P.V, so the
//    next tile's K lands during this tile's softmax and P.V.
//  * S = Q.K^T: wgmma m64n64k16, bf16 x bf16 into float32, both operands
//    K-major in shared memory, 4 steps a box (columns past D are zero and
//    add nothing).
//  * Online softmax on the accumulator fragments in registers: a thread
//    holds 16 scores of each of two rows, and the row max needs shuffles
//    only among the 4 threads that share a row.  The row sum l is kept
//    per thread (each thread's share of the row; the four share m and the
//    correction) and summed over the four at the end.
//  * O += P.V: wgmma m64n64k16 per 64-column box of V, with P from
//    registers as the A operand (the score fragment is already in A's
//    layout) and V as an MN-major B operand.  P is split into P_hi =
//    bf16(P) and P_lo = bf16(P - P_hi), two wgmma into the same
//    accumulator: P keeps about 16 bits, not 8 (rounding every softmax
//    weight to bf16 would add about 2^-9 relative error per weight to a
//    bf16 logits check that has less than 2x room).  V's columns past D
//    are zero, and so are those of the product: they are not stored.
//  * Output: acc times one reciprocal of max(l, 1e-37) a row (one rounding
//    away from the float32 route's division); rows past Sq (the serving
//    prefill has Sq 32 in a 64-row tile) are masked at the store.
//
// The float32 route (flash_attention_kernel), unchanged: one block per (q
// tile of 64 rows, q head, batch row), four warps of 16 rows each (up to
// head_dim 128; see below for 256).  The kv tiles of 64 keys are walked
// in order through shared memory, widened to float32 on load (K rows
// padded to D + 1 floats, so the 32 lanes' key reads fall in 32 banks).
// Each lane scores two keys against its warp's 16 rows, the warp reduces
// the row max and sum by butterflies, writes p to shared memory, and each
// lane then accumulates its head-dimension columns of p.V for the 16
// rows.  Head dimension 256: a lane keeps ROWS rows of DPL = D / 32
// output columns in registers, and the block's tiles are float32 in
// shared memory.  At ROWS 16 and D 256 that would be 128 accumulators a
// lane and 213,248 bytes of shared memory a block, so above head_dim 128
// a warp takes 8 rows (a block 32 query rows): 64 accumulators and
// 172,288 bytes.
//
// Both routes: GQA and MQA need nothing of their own (a block reads kv
// head h / (H / Hkv)); tiles wholly above the diagonal or wholly before
// the window are skipped, as the TPU kernel's `run` predicate does.  No
// atomics and a fixed walk: the sums' order is a pure function of the
// shape, so two launches give the same bits (replay's bit-exact
// verification needs that).
//
// Masking subtleties (both routes):
//  * A row's first processed tile can be entirely masked (a window band
//    that starts inside the tile).  m then stays NEG_INF, every p is
//    exp(0) = 1 and l, acc gather garbage; the next tile with a real
//    score has corr = exp(NEG_INF - m) = 0, which wipes them, as in the
//    reference.  Nothing here is ever -inf, so no NaN can arise.
//  * Keys past Sk (a ragged last tile) are out of the function: their
//    p is 0 and their K/V rows are zero-filled.
//  * A row with no valid key at all (window > 0 and Sq > Sk) gets the
//    reference's uniform softmax over all Sk keys: a q tile holding such
//    a row walks every kv tile.
//  * No fast-math: expf, not __expf, to stay near the plain version.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

constexpr float kNegInf = -0x1.666664p+127f;  // float32(-0.7 * FLT_MAX)
constexpr int kBlockK = 64;                   // keys per kv tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in floats: q tile [block_q][D] (scaled), K tile
// [kBlockK][D + 1], V tile [kBlockK][D], p [kWarps][rows][kBlockK].
__host__ __device__ constexpr int smem_floats(int D, int block_q) {
  return block_q * D + kBlockK * (D + 1) + kBlockK * D + block_q * kBlockK;
}

// q [B, Sq, H, D]; k, v [B, Sk, Hkv, D]; out [B, Sq, H, D].
// DPL = head-dimension columns per lane (D <= 32 * DPL); kRows = query
// rows per warp.
template <typename T, int DPL, int kRows>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int Hkv, int D, int causal, int window,
                       float scale) {
  constexpr int kBlockQ = kWarps * kRows;  // query rows per block
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * D;
  float* vs = ks + kBlockK * (D + 1);
  float* ps = vs + kBlockK * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q_last = min(q0 + kBlockQ, Sq) - 1;  // last real row of the tile

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int qp = q0 + r;
    qs[e] = qp < Sq ? to_f32(q[((b * Sq + qp) * H + h) * D + d]) * scale
                    : 0.f;
  }

  // kv tiles to walk: those holding a key that some row of the tile keeps
  const int nk = (Sk + kBlockK - 1) / kBlockK;
  int t_lo = 0;
  int t_hi = nk;
  const bool empty_row = window > 0 && q_last - (Sk - 1) >= window;
  if (!empty_row) {
    if (causal) t_hi = min(nk, q_last / kBlockK + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / kBlockK;
  }

  const int r0 = warp * kRows;  // this warp's first row in the tile
  const float* qw = qs + r0 * D;
  float* pw = ps + r0 * kBlockK;
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the last tile's K/V reads are done; q is stored
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int kp = k0 + r;
      const size_t src = ((b * Sk + kp) * Hkv + kvh) * D + d;
      ks[r * (D + 1) + d] = kp < Sk ? to_f32(k[src]) : 0.f;
      vs[e] = kp < Sk ? to_f32(v[src]) : 0.f;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 against the warp's rows
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s0[i] = s1[i] = 0.f;
    const float* ka = ks + lane * (D + 1);
    const float* kb = ks + (lane + 32) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a = ka[d];
      const float c = kb[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float x = qw[i * D + d];
        s0[i] = fmaf(x, a, s0[i]);
        s1[i] = fmaf(x, c, s1[i]);
      }
    }

    const int kpa = k0 + lane;
    const int kpb = kpa + 32;
    const bool in_a = kpa < Sk;
    const bool in_b = kpb < Sk;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + r0 + i;
      const bool ok_a =
          (!causal || qp >= kpa) && (window <= 0 || qp - kpa < window);
      const bool ok_b =
          (!causal || qp >= kpb) && (window <= 0 || qp - kpb < window);
      const float xa = ok_a ? s0[i] : kNegInf;
      const float xb = ok_b ? s1[i] : kNegInf;
      float mx = fmaxf(in_a ? xa : kNegInf, in_b ? xb : kNegInf);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float pa = in_a ? expf(xa - m_new) : 0.f;
      const float pb = in_b ? expf(xb - m_new) : 0.f;
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
      pw[i * kBlockK + lane] = pa;
      pw[i * kBlockK + lane + 32] = pb;
    }
    __syncwarp();

    const int k_end = min(kBlockK, Sk - k0);
    for (int key = 0; key < k_end; ++key) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < D ? vs[key * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = pw[i * kBlockK + key];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncwarp();  // p is read before the next tile writes it
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) out[((b * Sq + qp) * H + h) * D + d] =
          from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DPL, int kRows>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr int kBlockQ = kWarps * kRows;
  // above 48 KB a block's shared memory must be opted into, once per
  // instantiation (at the largest D it serves), before any graph capture
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DPL, kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * smem_floats(32 * DPL, kBlockQ)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const size_t smem = sizeof(float) * smem_floats(D, kBlockQ);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, DPL, kRows><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                     int window, float scale, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1:
      return launch<T, 1, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                              window, scale, stream);
    case 2:
      return launch<T, 2, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                              window, scale, stream);
    case 3:
      return launch<T, 3, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                              window, scale, stream);
    case 4:
      return launch<T, 4, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                              window, scale, stream);
    default:  // 128 < D <= 256
      return launch<T, 8, 8>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                             window, scale, stream);
  }
}

// ---------------------------------------------------------------------------
// The wgmma route: bf16, D % 16 == 0.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;   // query rows per CTA: wgmma's M
constexpr int kWgKeys = 64;   // keys per kv tile: the N of S = Q.K^T
constexpr int kBoxCols = 64;  // head-dim columns per TMA box (128 bytes)
constexpr uint32_t kBoxBytes = 64 * 128;  // one [64 rows x 64 cols] box
constexpr int kWgThreads = 128;

// K/V ring depth: 2 stages up to D 192; at D 256 one stage, so that a CTA
// takes 99 KB of shared memory and two CTAs share an SM (one's softmax
// runs while the other's products use the tensor cores)
__host__ __device__ constexpr int wg_stages(int nb) { return nb == 4 ? 1 : 2; }

// shared memory of a CTA: 1 KB of slack to align the tiles to the
// 128-byte swizzle's 1024-byte period, Q (NB boxes), then per stage K and
// V (NB boxes each)
__host__ __device__ constexpr int wg_smem_bytes(int nb) {
  return 1024 + static_cast<int>(kBoxBytes) * nb * (1 + 2 * wg_stages(nb));
}

// K or V of kv tile t (NB boxes) into shared memory at dst, on one barrier
template <int NB>
__device__ __forceinline__ void issue_tile(const CUtensorMap* map,
                                           uint32_t bar, uint32_t dst,
                                           int kvh, int t, int b) {
  mbar_expect_tx(bar, NB * kBoxBytes);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    tma_load(dst + j * kBoxBytes, map, bar, j * kBoxCols, kvh, t * kWgKeys,
             b);
}

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D] bf16 through their maps; out
// [B, Sq, H, D] bf16.  NB = 64-column boxes covering D.
//
// Fragment layout (wgmma's accumulator): thread `lane` of warp w holds, for
// each 8-column block i of a 64-wide product, d[4i + e] at row
// 16w + lane / 4 + 8 * (e / 2) and column 8i + 2 * (lane % 4) + e % 2.
template <int NB>
__global__ void __launch_bounds__(kWgThreads, NB == 4 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int Hkv, int D, int causal, int window, float scale) {
  constexpr int kStages = wg_stages(NB);
  extern __shared__ uint8_t smem_raw[];
  // Q, then K and V of each stage: each on its own barrier, so that K's
  // stage is refilled as soon as S is computed, while P.V still reads V
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t tile_bytes = kBoxBytes * NB;
  const uint32_t bar_q = smem_u32(&bars[0]);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q_last = min(q0 + kWgRows, Sq) - 1;

  // kv tiles to walk, as in the float32 route
  const int nk = (Sk + kWgKeys - 1) / kWgKeys;
  int t_lo = 0;
  int t_hi = nk;
  const bool empty_row = window > 0 && q_last - (Sk - 1) >= window;
  if (!empty_row) {
    if (causal) t_hi = min(nk, q_last / kWgKeys + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / kWgKeys;
  }

  // stage s: K at q_s + tile_bytes * (1 + 2s) on bars[1 + 2s], V right
  // after it on bars[2 + 2s]
  if (tid == 0) {
    for (const CUtensorMap* map : {&qmap, &kmap, &vmap})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, tile_bytes);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(q_s + j * kBoxBytes, &qmap, bar_q, j * kBoxCols, h, q0, b);
    for (int i = 0; i < kStages && t_lo + i < t_hi; ++i) {
      const uint32_t k_s = q_s + tile_bytes * (1 + 2 * i);
      issue_tile<NB>(&kmap, smem_u32(&bars[1 + 2 * i]), k_s, kvh, t_lo + i,
                     b);
      issue_tile<NB>(&vmap, smem_u32(&bars[2 + 2 * i]), k_s + tile_bytes,
                     kvh, t_lo + i, b);
    }
  }

  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  float o[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % kStages;
    const uint32_t k_s = q_s + tile_bytes * (1 + 2 * s);
    const uint32_t v_s = k_s + tile_bytes;
    const uint32_t parity = (it / kStages) & 1;
    mbar_wait(smem_u32(&bars[1 + 2 * s]), parity);
    __syncwarp();

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
    // all 4 * NB steps: Q's and K's columns past D are zero-filled, and
    // adding their zero products leaves every sum as it is
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss(sc, smem_desc(q_s + off, 16, 1024),
               smem_desc(k_s + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    __syncthreads();  // every warp is done reading K of stage s
    if (tid == 0 && t + kStages < t_hi)
      issue_tile<NB>(&kmap, smem_u32(&bars[1 + 2 * s]), k_s, kvh,
                     t + kStages, b);

    // scale, mask, row max
    const int k0 = t * kWgKeys;
    const bool interior = k0 + kWgKeys <= Sk &&
                          (!causal || k0 + kWgKeys - 1 <= q0) &&
                          (window <= 0 || q0 + kWgRows - 1 - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col0 + (e & 1);
        const int qp = row0 + 8 * (e >> 1);
        float x = sc[4 * i + e] * scale;
        if (!interior) {
          const bool ok = key < Sk && (!causal || qp >= key) &&
                          (window <= 0 || qp - key < window);
          x = ok ? x : kNegInf;
        }
        sc[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col0 + (e & 1);
        const float p = key < Sk ? expf(sc[4 * i + e] - m[e >> 1]) : 0.f;
        sc[4 * i + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= corr[(i >> 1) & 1];

    // P as wgmma's A fragment for key step kk (keys 16kk .. 16kk + 15):
    // register r holds columns of block 2kk + r / 2, row half r % 2
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 2 * kk + (r >> 1);
        const int e = 2 * (r & 1);
        const float a = sc[4 * i + e];
        const float c = sc[4 * i + e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][r] = bf16x2_bits(hi);
        pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(o[j]);
    mbar_wait(smem_u32(&bars[2 + 2 * s]), parity);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = smem_desc(v_s + j * kBoxBytes + kk * 2048, 1024,
                                      1024);
        wgmma_rs(o[j], ph[kk], dv);
        wgmma_rs(o[j], pl[kk], dv);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(o[j]);

    __syncthreads();  // every warp is done reading V of stage s
    if (tid == 0 && t + kStages < t_hi)
      issue_tile<NB>(&vmap, smem_u32(&bars[2 + 2 * s]), v_s, kvh,
                     t + kStages, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-37f);  // one division a row
    __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = kBoxCols * j + 8 * i + col0;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o[j][4 * i + 2 * r] * inv,
                                    o[j][4 * i + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// a 4-D map over a contiguous bf16 [batch, seq, heads, D] tensor, boxes of
// 64 columns x 1 head x 64 rows x 1 batch row, 128-byte swizzle; reads
// past D or past seq are zero-filled
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D,
                int heads, int seq, int batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBoxCols, 1, kWgRows, 1};
  return encode_bf16_map(fn, map, ptr, 4, dims, strides, box);
}

template <int NB>
cudaError_t launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km,
                         const CUtensorMap& vm, void* out, int B, int Sq,
                         int Sk, int H, int Hkv, int D, int causal,
                         int window, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg_smem_bytes(NB));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + kWgRows - 1) / kWgRows, H, B);
  flash_wgmma_kernel<NB><<<grid, kWgThreads, wg_smem_bytes(NB), stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// The float32 route.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out
// share it).  Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > kMaxHeadDim || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal, window,
                          scale, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                                  window, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The wgmma route: q, k, v and out bf16, contiguous, 16-byte aligned,
// D % 16 == 0 and D <= 256.  Returns the CUDA error code of the launch
// (0 on success); cudaErrorNotSupported when the driver offers no
// cuTensorMapEncodeTiled or refuses a map.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int Sq, int Sk, int H, int Hkv,
                                            int D, int causal, int window,
                                            float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || D < 16 ||
      D > kMaxHeadDim || D % 16 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!encode_map(fn, &qm, q, D, H, Sq, B) ||
      !encode_map(fn, &km, k, D, Hkv, Sk, B) ||
      !encode_map(fn, &vm, v, D, Hkv, Sk, B))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + kBoxCols - 1) / kBoxCols) {
    case 1:
      return static_cast<int>(launch_wgmma<1>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
    case 2:
      return static_cast<int>(launch_wgmma<2>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
    case 3:
      return static_cast<int>(launch_wgmma<3>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
    default:
      return static_cast<int>(launch_wgmma<4>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
  }
}
