// Single-token (decode) GQA attention over a KV cache, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:decode_attention
// (pallas_call body _decode_kernel): flash-decode with an online softmax
// in float32.  Slots are valid where 0 <= k_pos <= q_pos; the result is
// acc / max(l, 1e-37).
//
// What bounds it: bytes.  A call reads the K and V cache once and does
// 4*H*S*D flops on them.  At the paper consumer's shapes (B=1, S=2048,
// Hkv=4, D=32, float32) that is 2 MiB per layer, about 0.63 us at the
// H100 data sheet's 3.35 TB/s, against 2 MFLOP (about 0.03 us at 67
// TFLOP/s float32).
//
// What the design does about it: the TPU kernel walks the sequence as a
// sequential grid axis on one core.  Here the sequence is split across
// warps (split-KV), so that hundreds of warps pull the cache at once.
// Each warp owns one (batch row, kv head, run of keys); its lanes span the
// head dimension, so one key row is one coalesced load, and the g query
// heads that share the kv head are all scored against that one read (GQA
// reuse).  A warp skips the K/V rows of masked slots, so a half-empty
// cache costs only the k_pos reads of its empty slots.  A second kernel
// combines the splits' (m, l, acc) per query head, in split order, with
// no atomics: the result is the same bits on every launch, which replay's
// bit-exact verification needs.
//
// Masked scores are NEG_INF = -0.7 * FLT_MAX, as in the reference, not
// -inf.  A masked slot would add exp(NEG_INF - m) = 0 once m is a real
// score, so skipping it changes nothing, and a split whose keys are all
// masked ends with (m, l, acc) = (NEG_INF, 0, 0), which the
// combine weighs by exp(NEG_INF - M) = 0.  With no valid slot at all the
// kernel returns 0; attn_decode writes the current slot before attention,
// so it never asks for that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -0x1.666664p+127f;  // float32(-0.7 * FLT_MAX)
constexpr int kWarps = 4;                     // warps (= splits) per block
constexpr int kMaxGroup = 8;                  // query heads per kv head
constexpr int kMaxDimPerLane = 4;             // head_dim <= 128

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

// One warp = one split of one (batch row, kv head).
// q [B, H, D]; k, v [B, S, Hkv, D]; q_pos [B]; k_pos [B, S].
// part_acc [B, H, n_split, D]; part_ml [B, H, n_split, 2] = (m, l).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ q_pos,
                    const int32_t* __restrict__ k_pos,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int H, int Hkv, int D, int split_len, int n_split,
                    float scale) {
  const int lane = threadIdx.x & 31;
  const int split = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (split >= n_split) return;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int g = H / Hkv;
  const int s0 = split * split_len;
  const int s1 = min(S, s0 + split_len);
  const int qp = q_pos[b];

  float qr[kMaxGroup][kMaxDimPerLane];
  float acc[kMaxGroup][kMaxDimPerLane];
  float m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDimPerLane; ++j) {
      const int d = lane + 32 * j;
      float x = 0.f;
      if (h < g && d < D) {
        // q * scale in float32, rounded to the cache type (the reference
        // contracts in the cache's type with float32 accumulation)
        x = to_f32(from_f32<T>(
            to_f32(q[((size_t)b * H + kvh * g + h) * D + d]) * scale));
      }
      qr[h][j] = x;
      acc[h][j] = 0.f;
    }
  }

  for (int s = s0; s < s1; ++s) {
    const int kp = k_pos[(size_t)b * S + s];
    if (kp < 0 || kp > qp) continue;  // masked: exp(NEG_INF - m) adds nothing
    const size_t row = (((size_t)b * S + s) * Hkv + kvh) * D;
    float kr[kMaxDimPerLane], vr[kMaxDimPerLane];
#pragma unroll
    for (int j = 0; j < kMaxDimPerLane; ++j) {
      const int d = lane + 32 * j;
      kr[j] = d < D ? to_f32(k[row + d]) : 0.f;
      vr[j] = d < D ? to_f32(v[row + d]) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h < g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxDimPerLane; ++j) dot = fmaf(qr[h][j], kr[j], dot);
        // butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float m_new = fmaxf(m[h], dot);
        const float corr = expf(m[h] - m_new);
        const float p = expf(dot - m_new);
        l[h] = l[h] * corr + p;
#pragma unroll
        for (int j = 0; j < kMaxDimPerLane; ++j)
          acc[h][j] = acc[h][j] * corr + p * vr[j];
        m[h] = m_new;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    if (h < g) {
      const size_t p = ((size_t)b * H + kvh * g + h) * n_split + split;
#pragma unroll
      for (int j = 0; j < kMaxDimPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < D) part_acc[p * D + d] = acc[h][j];
      }
      if (lane == 0) {
        part_ml[2 * p] = m[h];
        part_ml[2 * p + 1] = l[h];
      }
    }
  }
}

// One block per (batch row, query head): combine the splits in order.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int D,
                                      int n_split) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float M = kNegInf;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f;
  for (int i = 0; i < n_split; ++i) L += ml[2 * i + 1] * expf(ml[2 * i] - M);
  const float denom = fmaxf(L, 1e-37f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f;
    for (int i = 0; i < n_split; ++i)
      A += part_acc[(bh * n_split + i) * D + d] * expf(ml[2 * i] - M);
    out[bh * D + d] = from_f32<T>(A / denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* q_pos, const int32_t* k_pos,
                   float* part_acc, float* part_ml, void* out, int B, int S,
                   int H, int Hkv, int D, int split_len, int n_split,
                   float scale, cudaStream_t stream) {
  const dim3 grid(B * Hkv, (n_split + kWarps - 1) / kWarps);
  decode_split_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, part_acc, part_ml, S, H, Hkv,
      D, split_len, n_split, scale);
  const int threads = D <= 32 ? 32 : (D <= 64 ? 64 : 128);
  decode_combine_kernel<T><<<B * H, threads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), D, n_split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k,
                                       const void* v, const int32_t* q_pos,
                                       const int32_t* k_pos, float* part_acc,
                                       float* part_ml, void* out, int B, int S,
                                       int H, int Hkv, int D, int split_len,
                                       int n_split, float scale,
                                       void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxGroup || D > 32 * kMaxDimPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, q_pos, k_pos, part_acc, part_ml, out, B, S,
                        H, Hkv, D, split_len, n_split, scale, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, q_pos, k_pos, part_acc, part_ml, out,
                                B, S, H, Hkv, D, split_len, n_split, scale,
                                st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
