// RG-LRU recurrence (griffin / recurrentgemma) over a sequence, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru.py:rglru (pallas_call body
// _rglru_kernel).  Same function, in float32 throughout:
//   log_at = c * sigmoid(gate_a) * log_sigmoid(a_param)
//   a_t    = exp(log_at)
//   beta   = sqrt(max(1 - exp(2 * log_at), 1e-12))
//   h_t    = a_t * h_{t-1} + beta * (sigmoid(gate_x) * x_t)
// with h_seq written in x's dtype and h_last in float32.  The product and
// the sum of the last line are two roundings (__fmul_rn, __fadd_rn: no FMA
// contraction), as the plain version computes them; h_seq is a rounded
// copy of the state and is never read back.  No fast math: expf, sqrtf,
// log1pf and an IEEE division in the sigmoid.  log_sigmoid is
// min(x, 0) - log1p(exp(-|x|)), accurate for large |x| (the reference's
// -softplus(-x)).
//
// What bounds it: bytes.  Each (b, t, w) reads x, gate_a and gate_x once
// and writes h once, with about 20 operations on them, far below the
// H100's 295 operations a byte.  At launch.serve's prefill (B 8, S 32,
// W 2560, bf16) the call must move 5,416,960 bytes: 1.62 us at 3.35 TB/s.
//
// What the design does: the TPU kernel walks the sequence as a sequential
// grid axis, keeping h in VMEM scratch between grid steps.  Hopper runs
// blocks in no order, so the sequence loop moves inside the thread: each
// thread owns one (b, w) channel and carries h in a register over all S
// steps; neighbouring threads take neighbouring w, so every load and
// store of a step is coalesced.  The gate terms do not depend on h, so a
// thread loads kUnroll steps ahead and computes their (a_t, gated) before
// the dependent chain runs through them.  One thread per channel gives
// only B * W / 64 blocks (320 at B 8, 80 at B 2): the chunked two-pass
// scan that would fill 132 SMs at small B is a later step.  No atomics and
// a fixed walk: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kUnroll = 8;    // steps loaded ahead of the dependent chain

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

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// x, ga, gx, hs [B, S, W]; a [W] float32; h0 [B, W] float32 or null;
// h_last [B, W] float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ ga,
             const T* __restrict__ gx, const float* __restrict__ a,
             const float* __restrict__ h0, T* __restrict__ hs,
             float* __restrict__ h_last, int S, int W, float c) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t b = blockIdx.y;
  const float log_a = log_sigmoid(a[w]);
  float h = h0 != nullptr ? h0[b * W + w] : 0.f;
  const size_t base = b * (size_t)S * W + w;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float at[kUnroll], g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = 0.f;
      g[u] = 0.f;
      if (t0 + u < S) {
        const size_t i = base + (size_t)(t0 + u) * W;
        const float xv = to_f32(x[i]);
        const float r = sigmoid(to_f32(ga[i]));
        const float iv = sigmoid(to_f32(gx[i]));
        const float log_at = __fmul_rn(__fmul_rn(c, r), log_a);
        at[u] = expf(log_at);
        const float one_minus = __fsub_rn(1.f, expf(__fmul_rn(2.f, log_at)));
        const float beta = sqrtf(fmaxf(one_minus, 1e-12f));
        g[u] = __fmul_rn(beta, __fmul_rn(iv, xv));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(at[u], h), g[u]);
        hs[base + (size_t)(t0 + u) * W] = from_f32<T>(h);
      }
    }
  }
  h_last[b * W + w] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* ga, const void* gx,
                   const float* a, const float* h0, void* hs, float* h_last,
                   int B, int S, int W, float c, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ga),
      static_cast<const T*>(gx), a, h0, static_cast<T*>(hs), h_last, S, W,
      c);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, gate_a, gate_x and h_seq share it).
// h0 may be null (zeros).  Returns the CUDA error code of the launch.
extern "C" int rglru_launch(int dtype, const void* x, const void* ga,
                            const void* gx, const float* a, const float* h0,
                            void* hs, float* h_last, int B, int S, int W,
                            float c, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, ga, gx, a, h0, hs, h_last, B, S, W, c, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, ga, gx, a, h0, hs, h_last, B, S, W, c,
                                st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
