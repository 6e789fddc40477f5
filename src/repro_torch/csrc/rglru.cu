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
// What bounds it: bytes, then the gate arithmetic.  Each (b, t, w) reads
// x, gate_a and gate_x and writes h: at the 2304-token prompt (B 2, W
// 2560, bf16) 94,402,560 bytes, 28.2 us at 3.35 TB/s.  The accurate exps,
// log1p, sqrt and divisions make the gates many instructions an element;
// only h_t = a_t * h_{t-1} + gated_t depends on the step before, two
// roundings a step.
//
// What the design does: the TPU kernel walks the sequence as a sequential
// grid axis.  The first port gave each (b, w) channel one thread that
// computed its gates and walked its chain: B * W threads (5120 at B 2), a
// few warps an SM, each waiting on its own chain.  Here the gates, which
// do not depend on h, are spread over (b, chunk, w), and the chain is
// walked in chunk order by a warp that only walks:
//   * a block owns one batch row and kChannels channels; the sequence is
//     cut into chunks of kProducers * U * 2 steps (the plan,
//     kernels/rglru.py:scan_plan, from the shape alone);
//   * warps 1..kProducers compute (a_t, gated) for one chunk, each lane
//     U steps of one channel (neighbouring lanes on neighbouring w: every
//     load is one 32-byte sector or more), into one of two shared-memory
//     buffers, with the next chunk's inputs loaded into registers while
//     this one's gates are computed;
//   * warp 0 walks the chunk before from the other buffer, carrying h
//     from chunk to chunk in a register, into a third buffer: it touches
//     shared memory only, so it never waits behind the producers' global
//     loads; the producers store that chunk's h_seq a round later, and the
//     walker h_last after the last chunk.  One barrier a round.
// The carry across chunks is therefore the sequential state itself, not
// a chained decay product: the walk's roundings are the plain version's,
// step for step, and the kernel gives its bits.  (A chunk-parallel chain,
// h_in(k+1) = A_k * h_in(k) + l_k with A_k = prod a_t, rounds
// differently; with a_t near 1 the float32 plain version itself lies
// further from the exact scan than RGLRU_TOL allows, so only its own
// rounding sequence meets that tolerance: tests/test_torch_scan_plan.py.)
// No atomics and a fixed walk: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 16;               // channels a block walks
constexpr int kRowsPerWarp = 32 / kChannels;  // steps one warp load covers
constexpr int kProducers = 7;               // warps computing the gates
constexpr int kThreads = 32 * (kProducers + 1);
constexpr int kWalkAhead = 8;               // gates read ahead of the chain

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

// 1 / (1 + exp(-x)), the quotient correctly rounded (__frcp_rn is the
// IEEE reciprocal: the same bits as an IEEE division of 1)
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// x, ga, gx, hs [B, S, W]; a [W] float32; h0 [B, W] float32 or null;
// h_last [B, W] float32.  Grid (ceil(W / kChannels), B); chunks of
// kProducers * U * kRowsPerWarp steps.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ ga,
                  const T* __restrict__ gx, const float* __restrict__ a,
                  const float* __restrict__ h0, T* __restrict__ hs,
                  float* __restrict__ h_last, int S, int W, float c) {
  constexpr int kChunk = kProducers * U * kRowsPerWarp;
  __shared__ float2 ag_s[2][kChunk][kChannels];  // (a_t, gated)
  __shared__ float h_s[2][kChunk][kChannels];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ch = lane % kChannels;
  const int w = blockIdx.x * kChannels + ch;
  const bool live = w < W;
  const size_t b = blockIdx.y;
  const size_t base = b * (size_t)S * W + w;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  // round k: the producers compute chunk k's gates and store chunk k - 2's
  // h_seq; the walker runs chunk k - 1
  if (warp > 0) {
    // a producer: steps s(u) = ((warp - 1) * U + u) * kRowsPerWarp + row
    // of every chunk, for channel ch
    const int s0 = (warp - 1) * U * kRowsPerWarp + lane / kChannels;
    // a dead lane reads a live channel, a step past S the last step: every
    // load is in bounds, no branch around it; only the stores are masked
    const size_t row0 = b * (size_t)S * W + min(w, W - 1);
    const T* xb = x + row0;
    const T* gab = ga + row0;
    const T* gxb = gx + row0;
    const float log_a = log_sigmoid(a[min(w, W - 1)]);
    T xr[U], ar[U], gr[U];
    auto load = [&](int chunk) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int off = min(chunk * kChunk + s0 + u * kRowsPerWarp, S - 1) * W;
        xr[u] = xb[off];
        ar[u] = gab[off];
        gr[u] = gxb[off];
      }
    };
    load(0);
    for (int k = 0; k <= n_chunks + 1; ++k) {
      if (k < n_chunks) {
        float xv[U], av[U], gv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          xv[u] = to_f32(xr[u]);
          av[u] = to_f32(ar[u]);
          gv[u] = to_f32(gr[u]);
        }
        if (k + 1 < n_chunks) load(k + 1);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = s0 + u * kRowsPerWarp;
          const float r = sigmoid(av[u]);
          const float iv = sigmoid(gv[u]);
          const float log_at = __fmul_rn(__fmul_rn(c, r), log_a);
          const float one_minus = __fsub_rn(1.f, expf(__fmul_rn(2.f, log_at)));
          const float beta = sqrtf(fmaxf(one_minus, 1e-12f));
          const float2 ag =
              make_float2(expf(log_at), __fmul_rn(beta, __fmul_rn(iv, xv[u])));
          if (k * kChunk + s < S) ag_s[k & 1][s][ch] = ag;
        }
      }
      if (k >= 2) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = s0 + u * kRowsPerWarp;
          const int t = (k - 2) * kChunk + s;
          if (live && t < S)
            hs[base + (size_t)t * W] = from_f32<T>(h_s[k & 1][s][ch]);
        }
      }
      __syncthreads();
    }
  } else {
    // the walker: lane ch carries channel w's state through every chunk,
    // touching shared memory only
    const bool walks = live && lane < kChannels;
    float h = walks && h0 != nullptr ? h0[b * W + w] : 0.f;
    for (int k = 0; k <= n_chunks + 1; ++k) {
      if (k > 0 && k <= n_chunks && walks) {
        const int n = min(kChunk, S - (k - 1) * kChunk);
        float2(*agt)[kChannels] = ag_s[(k - 1) & 1];
        float(*ht)[kChannels] = h_s[(k - 1) & 1];
        for (int s0 = 0; s0 < n; s0 += kWalkAhead) {
          float2 ag[kWalkAhead];
#pragma unroll
          for (int u = 0; u < kWalkAhead; ++u)
            ag[u] = agt[min(s0 + u, n - 1)][ch];
#pragma unroll
          for (int u = 0; u < kWalkAhead; ++u) {
            if (s0 + u < n) {
              h = __fadd_rn(__fmul_rn(ag[u].x, h), ag[u].y);
              ht[s0 + u][ch] = h;
            }
          }
        }
      }
      __syncthreads();
    }
    if (walks) h_last[b * W + w] = h;
  }
}

template <typename T, int U>
cudaError_t launch(const void* x, const void* ga, const void* gx,
                   const float* a, const float* h0, void* hs, float* h_last,
                   int B, int S, int W, float c, cudaStream_t stream) {
  const dim3 grid((W + kChannels - 1) / kChannels, B);
  rglru_scan_kernel<T, U><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ga),
      static_cast<const T*>(gx), a, h0, static_cast<T*>(hs), h_last, S, W,
      c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_u(int u, const void* x, const void* ga, const void* gx,
                     const float* a, const float* h0, void* hs,
                     float* h_last, int B, int S, int W, float c,
                     cudaStream_t stream) {
  switch (u) {
    case 1: return launch<T, 1>(x, ga, gx, a, h0, hs, h_last, B, S, W, c,
                                stream);
    case 2: return launch<T, 2>(x, ga, gx, a, h0, hs, h_last, B, S, W, c,
                                stream);
    case 4: return launch<T, 4>(x, ga, gx, a, h0, hs, h_last, B, S, W, c,
                                stream);
    case 8: return launch<T, 8>(x, ga, gx, a, h0, hs, h_last, B, S, W, c,
                                stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, gate_a, gate_x and h_seq share it).
// h0 may be null (zeros).  steps_per_lane (1, 2, 4 or 8) sets the chunk,
// kProducers * 2 * steps_per_lane steps (kernels/rglru.py:scan_plan).
// Returns the CUDA error code of the launch.
extern "C" int rglru_launch(int dtype, const void* x, const void* ga,
                            const void* gx, const float* a, const float* h0,
                            void* hs, float* h_last, int B, int S, int W,
                            int steps_per_lane, float c, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535 ||
      static_cast<long long>(S) * W > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_u<float>(steps_per_lane, x, ga, gx, a, h0, hs, h_last, B, S,
                          W, c, st);
  } else if (dtype == 1) {
    err = launch_u<__nv_bfloat16>(steps_per_lane, x, ga, gx, a, h0, hs,
                                  h_last, B, S, W, c, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
