// Train/prefill GQA attention with causal and local-window masks, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (pallas_call body _attn_kernel).  Same function: q is scaled by
// sm_scale first, s = q.k^T in float32, the mask keeps key j for query i
// where i >= j (causal) and i - j < window (window > 0), masked scores are
// NEG_INF = -0.7 * FLT_MAX (finite, never -inf), the online softmax runs
// in float32 with (acc, m, l) per query row, and the output is
// acc / max(l, 1e-37) in q's dtype.  sm_scale comes from the wrapper:
// 1/sqrt(D) rounded in float32 (ref.attn_scale), as the plain version
// scales; the TPU kernel rounds 1/sqrt(D) from double, at most one ulp
// away.
//
// What bounds it: at the training shapes, bytes on paper and neither in
// practice.  smollm_360m's layer (q [8,128,15,64], k/v [8,128,5,64],
// bf16, causal) moves 5.2 MB (1.6 us at 3.35 TB/s) and does about 252
// MFLOP of causal work (0.25 us on the bf16 tensor cores).  This first
// design multiplies on the float32 pipes, not the tensor cores, so its
// floor is the float32 rate (67 TFLOP/s: about 4 us there), and a block
// spends most of its time on shared-memory traffic.
//
// What the design does: one block per (q tile of 64 rows, q head, batch
// row), four warps of 16 rows each (up to head_dim 128; see below for
// 256).  The kv tiles of 64 keys are walked
// in order through shared memory, widened to float32 on load (K rows
// padded to D + 1 floats, so the 32 lanes' key reads fall in 32 banks).
// Each lane scores two keys against its warp's 16 rows, the warp reduces
// the row max and sum by butterflies, writes p to shared memory, and each
// lane then accumulates its head-dimension columns of p.V for the 16
// rows.  GQA: the block reads kv head h / (H / Hkv).  Tiles wholly above
// the diagonal or wholly before the window are skipped, as the TPU
// kernel's `run` predicate does.  No atomics and a fixed walk: the sums'
// order is a pure function of the shape, so two launches give the same
// bits (replay's bit-exact verification needs that).
//
// Head dimension 256 (recurrentgemma_2b): a lane keeps ROWS rows of
// DPL = D / 32 output columns in registers, and the block's tiles are
// float32 in shared memory.  At ROWS 16 and D 256 that would be 128
// accumulators a lane and 213,248 bytes of shared memory a block, so above
// head_dim 128 a warp takes 8 rows (a block 32 query rows): 64
// accumulators and 172,288 bytes.  One block then fills an SM's shared
// memory, so this shape runs one block (4 warps) an SM.  Up to 128 the
// kernel is the same code at ROWS 16 as before, with the same sums.
// Multi-query attention (10 query heads over 1 kv head) needs nothing of
// its own: each block reads kv head h / (H / Hkv).
//
// Masking subtleties:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Returns the CUDA error code of the launch (0 on success).
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
