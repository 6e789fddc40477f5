// sLSTM recurrence (xLSTM, arXiv:2405.04517 §2.2) from a fresh state, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/slstm.py:slstm (pallas_call body
// _slstm_kernel).  Same function, in float32 throughout, per step t and
// head h with h_{t-1} the head's previous output (hb wide):
//   z_g = x_g[t] + sum_i h_{t-1}[i] * r_g[h][i][:]      (g = i, f, z, o)
//   m_t = max(z_f + m, z_i)
//   c   = exp(z_f + m - m_t) * c + exp(z_i - m_t) * tanh(z_z)
//   n   = exp(z_f + m - m_t) * n + exp(z_i - m_t)
//   h_t = sigmoid(z_o) * c / max(n, 1e-6)
// from c = 0, n = 1, h = 0, m = 0, with h_seq written in x's dtype.  No fast
// math: expf, tanhf and IEEE divisions.
//
// What bounds it: the recurrence.  At the train shape (B 8, S 128, W 1024,
// H 4, hb 256, bf16) the call moves about 14.7 MB (4.4 us at 3.35 TB/s)
// and does about 2.1 GFLOP of float32 (32 us at 67 TFLOP/s), but step t
// needs all of h_{t-1}: the S steps run one after another, each a
// [1,hb]x[hb,hb] matvec per gate.
//
// What the design does: the TPU kernel keeps a head's four r blocks (1 MiB
// of float32 at hb 256) in VMEM; a block's shared memory holds 227 KB.  So
// one block owns one (b, head) and walks the S steps: one thread per output
// column j, h_{t-1} in shared memory (double-buffered, so one barrier a
// step), and r_g[h][:, j] read from L2 on every step, neighbouring threads
// on neighbouring columns (coalesced), 16 rows of each r column loaded
// before their products are summed, so that the loads overlap.  Each
// thread sums its four dot products over i in order, so two launches give
// the same bits.  The step is bound by the L2 reads of r and by latency;
// keeping r spread over the shared memory of an 8-block cluster is the
// later, fast design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxHb = 512;   // one thread per column of a head
constexpr int kAhead = 16;    // rows of r loaded ahead of their sums

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
  return 1.f / (1.f + expf(-x));
}

// x_* and hs [B, S, W]; r_* [H, hb, hb] float32.  Block (head, b); thread
// j < hb owns column j of the head.
template <typename T>
__global__ void __launch_bounds__(kMaxHb)
slstm_kernel(const T* __restrict__ xi, const T* __restrict__ xf,
             const T* __restrict__ xz, const T* __restrict__ xo,
             const float* __restrict__ ri, const float* __restrict__ rf,
             const float* __restrict__ rz, const float* __restrict__ ro,
             T* __restrict__ hs, int S, int W, int hb) {
  extern __shared__ float h_buf[];  // [2][hb]: h_{t-1}, h_t
  const int head = blockIdx.x;
  const size_t b = blockIdx.y;
  const int j = threadIdx.x;
  const bool live = j < hb;
  const size_t roff = (size_t)head * hb * hb + j;  // r_g[head][0][j]
  const size_t col = (size_t)head * hb + j;
  float c = 0.f, n = 1.f, m = 0.f;
  if (live) h_buf[j] = 0.f;
  __syncthreads();
  for (int t = 0; t < S; ++t) {
    const float* h_prev = h_buf + (t & 1) * hb;
    float* h_next = h_buf + ((t + 1) & 1) * hb;
    if (live) {
      const size_t xoff = (b * S + t) * (size_t)W + col;
      float zi = 0.f, zf = 0.f, zz = 0.f, zo = 0.f;
      for (int i0 = 0; i0 < hb; i0 += kAhead) {
        // all kAhead rows of the four r columns in flight before the sums
        float a[kAhead], f[kAhead], z[kAhead], o[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const size_t ro_i = roff + (size_t)min(i0 + u, hb - 1) * hb;
          a[u] = ri[ro_i];
          f[u] = rf[ro_i];
          z[u] = rz[ro_i];
          o[u] = ro[ro_i];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (i0 + u < hb) {
            const float hv = h_prev[i0 + u];
            zi = fmaf(hv, a[u], zi);
            zf = fmaf(hv, f[u], zf);
            zz = fmaf(hv, z[u], zz);
            zo = fmaf(hv, o[u], zo);
          }
        }
      }
      zi = to_f32(xi[xoff]) + zi;
      zf = to_f32(xf[xoff]) + zf;
      zz = to_f32(xz[xoff]) + zz;
      zo = to_f32(xo[xoff]) + zo;
      const float m_new = fmaxf(zf + m, zi);
      const float ie = expf(zi - m_new);
      const float fe = expf(zf + m - m_new);
      c = fe * c + ie * tanhf(zz);
      n = fe * n + ie;
      const float h = sigmoid(zo) * c / fmaxf(n, 1e-6f);
      m = m_new;
      h_next[j] = h;
      hs[xoff] = from_f32<T>(h);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* xi, const void* xf, const void* xz,
                   const void* xo, const float* ri, const float* rf,
                   const float* rz, const float* ro, void* hs, int B, int S,
                   int H, int hb, cudaStream_t stream) {
  const int threads = (hb + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)hb * sizeof(float);
  slstm_kernel<T><<<dim3(H, B), threads, smem, stream>>>(
      static_cast<const T*>(xi), static_cast<const T*>(xf),
      static_cast<const T*>(xz), static_cast<const T*>(xo), ri, rf, rz, ro,
      static_cast<T*>(hs), S, H * hb, hb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the four x_* and h_seq share it); r_*
// float32 [H, hb, hb].  Returns the CUDA error code of the launch.
extern "C" int slstm_launch(int dtype, const void* xi, const void* xf,
                            const void* xz, const void* xo, const float* ri,
                            const float* rf, const float* rz,
                            const float* ro, void* hs, int B, int S, int H,
                            int hb, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hb < 1 || hb > kMaxHb || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(xi, xf, xz, xo, ri, rf, rz, ro, hs, B, S, H, hb, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(xi, xf, xz, xo, ri, rf, rz, ro, hs, B, S, H,
                                hb, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
