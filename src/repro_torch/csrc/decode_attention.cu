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
// TFLOP/s float32).  At recurrentgemma_2b's serving decode (B=8, S=128,
// Hkv=1, D=256, bf16) it is 1 MiB per layer, about 0.31 us.
//
// What the design does about it: the TPU kernel walks the sequence as a
// sequential grid axis on one core.  Here the sequence is split across
// warps (split-KV), so that hundreds of warps pull the cache at once.
// Each warp owns one (batch row, kv head, run of keys); its lanes span the
// head dimension, so one key row is one coalesced load, and the query
// heads that share the kv head are all scored against that one read (GQA
// reuse).  A lane keeps its share of q and of the running p.V for every
// head of the group in registers: G heads of DPL columns each.  Up to
// head_dim 128 a warp takes up to 8 heads of 4 columns; above it (head_dim
// 256, recurrentgemma's 10 heads over one kv head) a warp takes 5 heads of
// 8 columns, and a group larger than the tile is split over gridDim.z, so
// each tile reads the kv head's K/V rows once (twice in all at group 10)
// and a lane holds 80 floats of q and p.V, not 160.  A warp skips the K/V
// rows of masked slots, so a half-empty cache costs only the k_pos reads
// of its empty slots.  A second kernel
// combines the splits' (m, l, acc) per query head, in split order, with
// no atomics: the result is the same bits on every launch, which replay's
// bit-exact verification needs.
//
// Masked scores are NEG_INF = -0.7 * FLT_MAX, as in the reference, not
// -inf.  A masked slot would add exp(NEG_INF - m) = 0 once m is a real
// score, so skipping it changes nothing, and a split whose keys are all
// masked ends with (m, l, acc) = (NEG_INF, 0, 0), which the
// combine weighs by exp(NEG_INF - M) = 0.  A split with a valid slot ends
// with l >= 1, so the combined L is 0 exactly when the (batch row, kv
// head) has no valid slot at all.  There every score of the reference is
// NEG_INF and its softmax is uniform: the combine kernel then returns the
// mean of V over all S slots, sum_s (1/S) * v[s] in slot order with 1/S
// rounded to the cache type, as the plain version computes it.  The
// model never asks for that (attn_decode writes the current slot before
// attention), so that slow loop costs nothing on the main path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -0x1.666664p+127f;  // float32(-0.7 * FLT_MAX)
constexpr int kWarps = 4;                     // warps (= splits) per block
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

// One warp = one split of one (batch row, kv head, tile of G query heads).
// q [B, H, D]; k, v [B, S, Hkv, D]; q_pos [B]; k_pos [B, S].
// part_acc [B, H, n_split, D]; part_ml [B, H, n_split, 2] = (m, l).
// G = query heads per tile, DPL = head-dimension columns per lane.
template <typename T, int G, int DPL>
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
  const int hq = kvh * g + blockIdx.z * G;  // this tile's first query head
  const int gt = min(G, g - static_cast<int>(blockIdx.z) * G);  // its heads

  float qr[G][DPL];
  float acc[G][DPL];
  float m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      float x = 0.f;
      if (h < gt && d < D) {
        // q * scale in float32, rounded to the cache type (the reference
        // contracts in the cache's type with float32 accumulation)
        x = to_f32(from_f32<T>(
            to_f32(q[((size_t)b * H + hq + h) * D + d]) * scale));
      }
      qr[h][j] = x;
      acc[h][j] = 0.f;
    }
  }

  for (int s = s0; s < s1; ++s) {
    const int kp = k_pos[(size_t)b * S + s];
    if (kp < 0 || kp > qp) continue;  // masked: exp(NEG_INF - m) adds nothing
    const size_t row = (((size_t)b * S + s) * Hkv + kvh) * D;
    float kr[DPL], vr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      kr[j] = d < D ? to_f32(k[row + d]) : 0.f;
      vr[j] = d < D ? to_f32(v[row + d]) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h < gt) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) dot = fmaf(qr[h][j], kr[j], dot);
        // butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float m_new = fmaxf(m[h], dot);
        const float corr = expf(m[h] - m_new);
        const float p = expf(dot - m_new);
        l[h] = l[h] * corr + p;
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          acc[h][j] = acc[h][j] * corr + p * vr[j];
        m[h] = m_new;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h < gt) {
      const size_t p = ((size_t)b * H + hq + h) * n_split + split;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
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
// v [B, S, Hkv, D] is read only for a row with no valid slot.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      const T* __restrict__ v,
                                      T* __restrict__ out, int S, int H,
                                      int Hkv, int D, int n_split) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float M = kNegInf;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f;
  for (int i = 0; i < n_split; ++i) L += ml[2 * i + 1] * expf(ml[2 * i] - M);
  if (L == 0.f) {  // no valid slot: uniform softmax, the mean of V
    const size_t b = bh / H;
    const int kvh = static_cast<int>(bh % H) / (H / Hkv);
    const float p = to_f32(from_f32<T>(1.f / static_cast<float>(S)));
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float A = 0.f;
      for (int s = 0; s < S; ++s)
        A = fmaf(p, to_f32(v[((b * S + s) * Hkv + kvh) * D + d]), A);
      out[bh * D + d] = from_f32<T>(A);
    }
    return;
  }
  const float denom = fmaxf(L, 1e-37f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f;
    for (int i = 0; i < n_split; ++i)
      A += part_acc[(bh * n_split + i) * D + d] * expf(ml[2 * i] - M);
    out[bh * D + d] = from_f32<T>(A / denom);
  }
}

template <typename T, int G, int DPL>
void launch_split(const void* q, const void* k, const void* v,
                  const int32_t* q_pos, const int32_t* k_pos,
                  float* part_acc, float* part_ml, int B, int S, int H,
                  int Hkv, int D, int split_len, int n_split, float scale,
                  cudaStream_t stream) {
  const int g = H / Hkv;
  const dim3 grid(B * Hkv, (n_split + kWarps - 1) / kWarps, (g + G - 1) / G);
  decode_split_kernel<T, G, DPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, part_acc, part_ml, S, H, Hkv,
      D, split_len, n_split, scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* q_pos, const int32_t* k_pos,
                   float* part_acc, float* part_ml, void* out, int B, int S,
                   int H, int Hkv, int D, int split_len, int n_split,
                   float scale, cudaStream_t stream) {
  if (D <= 128) {
    launch_split<T, 8, 4>(q, k, v, q_pos, k_pos, part_acc, part_ml, B, S, H,
                          Hkv, D, split_len, n_split, scale, stream);
  } else {
    launch_split<T, 5, 8>(q, k, v, q_pos, k_pos, part_acc, part_ml, B, S, H,
                          Hkv, D, split_len, n_split, scale, stream);
  }
  const int threads = D <= 32 ? 32 : (D <= 64 ? 64 : 128);
  decode_combine_kernel<T><<<B * H, threads, 0, stream>>>(
      part_acc, part_ml, static_cast<const T*>(v), static_cast<T*>(out), S,
      H, Hkv, D, n_split);
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
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > kMaxHeadDim)
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
