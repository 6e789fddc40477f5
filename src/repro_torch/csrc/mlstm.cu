// Chunkwise-parallel mLSTM (xLSTM, arXiv:2405.04517 §2.3) from a fresh
// state, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/mlstm.py:mlstm (pallas_call body
// _mlstm_kernel).  Same function, in float32 throughout.  Per (b, head) and
// chunk of T steps, with b_t the inclusive cumsum of log_sigmoid(f) in the
// chunk, F = b_{T-1}, q scaled by 1/sqrt(D) and m_in, C [Dv,Dk], n [Dk]
// the state carried from the chunk before (NEG_INF, 0, 0 at the start):
//   m_t   = max(b_t + m_in, max_{j<=t} (b_t - b_j + logi_j))
//   S_tj  = (q_t . k_j) * exp(b_t - b_j + logi_j - m_t),  j <= t
//   e_t   = exp(b_t + m_in - m_t)
//   h_t   = (sum_j S_tj v_j + e_t C q_t)
//           / max(|sum_j S_tj + e_t n . q_t|, exp(-m_t))
//   m_out = max(F + m_in, max_j (F - b_j + logi_j))
//   w_j   = exp(F - b_j + logi_j - m_out),  g = exp(F + m_in - m_out)
//   C     = g C + sum_j w_j v_j k_j^T,  n = g n + sum_j w_j k_j
// with h written in q's dtype (the TPU kernel's output dtype; the
// reference's jnp recurrence returns float32).  No fast math: expf, log1pf
// and IEEE divisions.
//
// What bounds it: operations.  At the train shape (B 8, S 128, H 4, D 512,
// bf16: one chunk) the call moves about 16.8 MB (5.0 us at 3.35 TB/s); the
// two [T,T] products over the kept (t, j <= t) pairs are 0.54 GFLOP of
// float32 (8.1 us at 67 TFLOP/s).  Every chunk after the first adds the
// products with C (4 T D^2 operations a chunk).
//
// What the design does: the TPU kernel walks the chunks of one (b, head)
// as a sequential grid axis and keeps C (1 MiB of float32 at D 512) in
// VMEM.  A block's shared memory holds 227 KB, so the work is cut three
// ways, in three launches on one stream:
//   1. gates: one block per (b, head) walks the chunks in order and
//      writes b_t, w_j, each chunk's m_in and g (scalars only: the m
//      recurrence does not depend on q, k or v);
//   2. scores: one block per (b, head, chunk, 32 rows of t) computes its
//      rows of S from q.k over D in tiles of 64 (float32 in shared memory,
//      a 4 x 4 register tile a thread), the rows' m_t, e_t and sum_j S_tj;
//      every chunk at once;
//   3. output and state: one block per (b, head, 32 rows of C) walks the
//      chunks in order with its rows of C [32, D] and all of n in shared
//      memory: h for its 32 v-dims, then its rows of the C update (k read
//      in tiles of rows).  The rows of C evolve independently; n is kept
//      by every block of a (b, head), the same bits in each.
// The first chunk skips the products with C and n (both are 0 and e_t is
// 0), the last skips the state update (nothing reads it).  Every sum runs
// in a fixed order and nothing is atomic: two launches give the same bits.
// Tensor cores (wgmma on bf16 tiles) are the later, fast design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxT = 128;       // chunk length
constexpr int kMaxD = 512;       // head dim
constexpr int kThreads = 256;
constexpr int kRows = 32;        // rows of t a scores block; rows of C a block
constexpr int kKT = 64;          // depth of a q / k tile
constexpr int kBufFloats = kMaxT * (kKT + 1);  // q tile, or k rows of D
constexpr int kDK = kMaxD / kThreads;          // dk columns a thread owns

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

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// ig, fg [B, S, H] float32.  Writes bcum, w [BH, S] and m_in, decay
// [BH, nc]; row bh = b * H + head.  Block bh; the gates of a chunk are
// loaded and their log_sigmoid taken by one thread a step, the cumsum runs
// in order in thread 0.
__global__ void __launch_bounds__(kMaxT)
mlstm_gates_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                   float* __restrict__ bcum, float* __restrict__ w,
                   float* __restrict__ m_in_out, float* __restrict__ decay,
                   int S, int H, int T) {
  __shared__ float b_s[kMaxT], li_s[kMaxT], red[kMaxT / 32];
  const int bh = blockIdx.x;
  const size_t b = bh / H;
  const int head = bh % H;
  const int nc = S / T;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float m_in = -0.7f * 3.40282347e38f;  // NEG_INF
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * T;
    if (t < T) {
      b_s[t] = log_sigmoid(fg[(b * S + s0 + t) * H + head]);
      li_s[t] = ig[(b * S + s0 + t) * H + head];
    }
    __syncthreads();
    if (t == 0) {
      float acc = 0.f;
      for (int j = 0; j < T; ++j) {
        acc = acc + b_s[j];
        b_s[j] = acc;
      }
    }
    __syncthreads();
    const float F = b_s[T - 1];
    // max_j (F - b_j + logi_j): exact in any order
    float mx = t < T ? (F - b_s[t]) + li_s[t] : -3.40282347e38f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    for (int i = 0; i < kMaxT / 32; ++i) mx = fmaxf(mx, red[i]);
    const float m_out = fmaxf(F + m_in, mx);
    if (t < T) {
      bcum[(size_t)bh * S + s0 + t] = b_s[t];
      w[(size_t)bh * S + s0 + t] = expf(((F - b_s[t]) + li_s[t]) - m_out);
    }
    if (t == 0) {
      m_in_out[(size_t)bh * nc + c] = m_in;
      decay[(size_t)bh * nc + c] = expf((F + m_in) - m_out);
    }
    m_in = m_out;
    __syncthreads();
  }
}

// Block (row tile, chunk, bh): rows t0 .. t0+31 of the chunk's S, all
// columns j < T (zeros above the diagonal).
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
mlstm_scores_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                    const float* __restrict__ ig,
                    const float* __restrict__ bcum,
                    const float* __restrict__ m_in_arr,
                    float* __restrict__ s_out, float* __restrict__ mrow,
                    float* __restrict__ inter, float* __restrict__ rowsum,
                    int S, int H, int D, int T, float scale) {
  __shared__ float qs[kRows][kKT + 1];
  __shared__ float ks[kBufFloats];  // [kMaxT][kKT + 1], later S rows
  __shared__ float b_s[kMaxT], li_s[kMaxT], m_s[kRows];
  const int t0 = blockIdx.x * kRows;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const size_t b = bh / H;
  const int head = bh % H;
  const int nc = S / T;
  const int s0 = c * T;
  const int rows = min(kRows, T - t0);
  const int jmax = t0 + rows;  // columns that can be kept
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float m_in = m_in_arr[(size_t)bh * nc + c];
  for (int j = tid; j < jmax; j += kThreads) {
    b_s[j] = bcum[(size_t)bh * S + s0 + j];
    li_s[j] = ig[(b * S + s0 + j) * H + head];
  }
  __syncthreads();
  // the rows' stabilizers: one warp a row, max over j <= t (exact in any
  // order)
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int t = t0 + r;
    float mx = -3.40282347e38f;
    for (int j = lane; j <= t; j += 32)
      mx = fmaxf(mx, (b_s[t] - b_s[j]) + li_s[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) m_s[r] = fmaxf(b_s[t] + m_in, mx);
  }
  // q.k over D: thread (tr, lane) holds rows tr + 8a and columns lane + 32e
  float acc[4][4] = {};
  const int tr = tid >> 5;
  for (int dk0 = 0; dk0 < D; dk0 += kKT) {
    const int kt = min(kKT, D - dk0);
    for (int e = tid; e < kRows * kKT; e += kThreads) {
      const int r = e / kKT, kk = e % kKT;
      qs[r][kk] = (r < rows && kk < kt)
          ? to_f32(q[((b * S + s0 + t0 + r) * H + head) * D + dk0 + kk]) * scale
          : 0.f;
    }
    for (int e = tid; e < kMaxT * kKT; e += kThreads) {
      const int j = e / kKT, kk = e % kKT;
      ks[j * (kKT + 1) + kk] = (j < jmax && kk < kt)
          ? to_f32(k[((b * S + s0 + j) * H + head) * D + dk0 + kk])
          : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[tr + 8 * i][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = ks[(lane + 32 * i) * (kKT + 1) + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(a[i], bv[e], acc[i][e]);
    }
    __syncthreads();
  }
  // decay-weighted, masked scores; rows also kept in shared memory
  float* ss = ks;  // [kRows][kMaxT + 1]
  float* out = s_out + ((size_t)bh * nc + c) * T * T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 8 * i;
    if (r >= rows) continue;
    const int t = t0 + r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane + 32 * e;
      if (j >= T) continue;
      float s = 0.f;
      if (j <= t) s = acc[i][e] * expf(((b_s[t] - b_s[j]) + li_s[j]) - m_s[r]);
      ss[r * (kMaxT + 1) + j] = s;
      out[(size_t)t * T + j] = s;
    }
  }
  __syncthreads();
  if (tid < rows) {
    const int t = t0 + tid;
    float sum = 0.f;
    for (int j = 0; j < T; ++j) sum += ss[tid * (kMaxT + 1) + j];
    const size_t o = (size_t)bh * S + s0 + t;
    rowsum[o] = sum;
    mrow[o] = m_s[tid];
    inter[o] = expf((b_s[t] + m_in) - m_s[tid]);
  }
}

__host__ __device__ inline size_t out_smem_floats(int T, int D) {
  return (size_t)kRows * (D + 1) + D + (size_t)T * T + (size_t)T * kRows
      + kBufFloats + 5 * (size_t)T;
}

// Block (32 v-dims, bh): walks the chunks in order.
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
mlstm_out_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, const float* __restrict__ s_in,
                 const float* __restrict__ mrow,
                 const float* __restrict__ inter,
                 const float* __restrict__ rowsum,
                 const float* __restrict__ w, const float* __restrict__ decay,
                 Tin* __restrict__ h_out, int S, int H, int D, int T,
                 float scale) {
  extern __shared__ float smem[];
  float* Cs = smem;                        // [kRows][D + 1]
  float* ns = Cs + kRows * (D + 1);        // [D]
  float* Ss = ns + D;                      // [T][T]
  float* vs = Ss + T * T;                  // [T][kRows]
  float* buf = vs + T * kRows;             // q tile [T][kKT+1] or k rows
  float* e_s = buf + kBufFloats;           // [T] each
  float* rs_s = e_s + T;
  float* m_s = rs_s + T;
  float* w_s = m_s + T;
  float* qn_s = w_s + T;
  const int dv0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const size_t b = bh / H;
  const int head = bh % H;
  const int nc = S / T;
  const int tid = threadIdx.x, lane = tid & 31, tg = tid >> 5;
  const bool dv_ok = dv0 + lane < D;
  for (int e = tid; e < kRows * (D + 1); e += kThreads) Cs[e] = 0.f;
  for (int e = tid; e < D; e += kThreads) ns[e] = 0.f;
  const int jt = min(T, kBufFloats / D);  // k rows a tile of the update

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * T;
    const size_t vec = (size_t)bh * S + s0;
    const float* sc = s_in + ((size_t)bh * nc + c) * T * T;
    for (int e = tid; e < T * T; e += kThreads) Ss[e] = sc[e];
    for (int e = tid; e < T * kRows; e += kThreads) {
      const int j = e / kRows, d = e % kRows;
      vs[e] = dv0 + d < D
          ? to_f32(v[((b * S + s0 + j) * H + head) * D + dv0 + d]) : 0.f;
    }
    for (int t = tid; t < T; t += kThreads) {
      e_s[t] = inter[vec + t];
      rs_s[t] = rowsum[vec + t];
      m_s[t] = mrow[vec + t];
      w_s[t] = w[vec + t];
    }
    // q C^T and q.n from the carried state (both 0 in the first chunk)
    float qc[kMaxT / 8] = {};
    if (c > 0) {
      float qn = 0.f;
      for (int dk0 = 0; dk0 < D; dk0 += kKT) {
        const int kt = min(kKT, D - dk0);
        __syncthreads();
        for (int e = tid; e < T * kKT; e += kThreads) {
          const int t = e / kKT, kk = e % kKT;
          buf[t * (kKT + 1) + kk] = kk < kt
              ? to_f32(q[((b * S + s0 + t) * H + head) * D + dk0 + kk]) * scale
              : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < kt; ++kk) {
          const float cv = Cs[lane * (D + 1) + dk0 + kk];
#pragma unroll
          for (int i = 0; i < kMaxT / 8; ++i) {
            const int t = tg + 8 * i;
            if (t < T) qc[i] = fmaf(buf[t * (kKT + 1) + kk], cv, qc[i]);
          }
        }
        if (tid < T)
          for (int kk = 0; kk < kt; ++kk)
            qn = fmaf(buf[tid * (kKT + 1) + kk], ns[dk0 + kk], qn);
      }
      if (tid < T) qn_s[tid] = qn;
    }
    __syncthreads();
    // h for this block's 32 v-dims
#pragma unroll
    for (int i = 0; i < kMaxT / 8; ++i) {
      const int t = tg + 8 * i;
      if (t >= T) continue;
      float num = 0.f;
      for (int j = 0; j <= t; ++j)
        num = fmaf(Ss[t * T + j], vs[j * kRows + lane], num);
      float den = rs_s[t];
      if (c > 0) {
        num = num + e_s[t] * qc[i];
        den = den + e_s[t] * qn_s[t];
      }
      den = fmaxf(fabsf(den), expf(-m_s[t]));
      if (dv_ok)
        h_out[((b * S + s0 + t) * H + head) * D + dv0 + lane] =
            from_f32<Tin>(num / den);
    }
    if (c == nc - 1) break;
    // state update: this block's rows of C, and all of n
    __syncthreads();
    for (int e = tid; e < T * kRows; e += kThreads) vs[e] *= w_s[e / kRows];
    float ac[kDK][kRows] = {};
    float an[kDK] = {};
    for (int j0 = 0; j0 < T; j0 += jt) {
      const int jn = min(jt, T - j0);
      __syncthreads();
      for (int e = tid; e < jn * D; e += kThreads) {
        const int j = e / D, d = e % D;
        buf[e] = to_f32(k[((b * S + s0 + j0 + j) * H + head) * D + d]);
      }
      __syncthreads();
      for (int j = 0; j < jn; ++j) {
        const float wj = w_s[j0 + j];
#pragma unroll
        for (int u = 0; u < kDK; ++u) {
          const int dk = tid + kThreads * u;
          if (dk >= D) continue;
          const float kv = buf[j * D + dk];
          an[u] = fmaf(wj, kv, an[u]);
#pragma unroll
          for (int d = 0; d < kRows; ++d)
            ac[u][d] = fmaf(vs[(j0 + j) * kRows + d], kv, ac[u][d]);
        }
      }
    }
    const float g = decay[(size_t)bh * nc + c];
#pragma unroll
    for (int u = 0; u < kDK; ++u) {
      const int dk = tid + kThreads * u;
      if (dk >= D) continue;
      ns[dk] = g * ns[dk] + an[u];
#pragma unroll
      for (int d = 0; d < kRows; ++d)
        Cs[d * (D + 1) + dk] = g * Cs[d * (D + 1) + dk] + ac[u][d];
    }
    __syncthreads();
  }
}

template <typename Tin>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ig, const float* fg, void* h, float* bcum,
                   float* w, float* m_in, float* decay, float* scores,
                   float* mrow, float* inter, float* rowsum, int B, int S,
                   int H, int D, int T, float scale, cudaStream_t stream) {
  const int BH = B * H, nc = S / T;
  const Tin* qt = static_cast<const Tin*>(q);
  const Tin* kt = static_cast<const Tin*>(k);
  mlstm_gates_kernel<<<BH, kMaxT, 0, stream>>>(ig, fg, bcum, w, m_in, decay,
                                               S, H, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_scores_kernel<Tin><<<dim3((T + kRows - 1) / kRows, nc, BH), kThreads,
                             0, stream>>>(qt, kt, ig, bcum, m_in, scores,
                                          mrow, inter, rowsum, S, H, D, T,
                                          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = out_smem_floats(T, D) * sizeof(float);
  static size_t smem_allowed = 48 * 1024;  // raised once, before any capture
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(
        mlstm_out_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(out_smem_floats(kMaxT, kMaxD) * sizeof(float)));
    if (err != cudaSuccess) return err;
    smem_allowed = out_smem_floats(kMaxT, kMaxD) * sizeof(float);
  }
  mlstm_out_kernel<Tin><<<dim3((D + kRows - 1) / kRows, BH), kThreads, smem,
                          stream>>>(qt, kt, static_cast<const Tin*>(v),
                                    scores, mrow, inter, rowsum, w, decay,
                                    static_cast<Tin*>(h), S, H, D, T, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and h share it); i/f gates
// float32 [B, S, H]; scratch float32: bcum, w, mrow, inter, rowsum
// [B*H, S], m_in, decay [B*H, S/T], scores [B*H, S/T, T, T].  Returns the
// CUDA error code of the launches.
extern "C" int mlstm_launch(int dtype, const void* q, const void* k,
                            const void* v, const float* ig, const float* fg,
                            void* h, float* bcum, float* w, float* m_in,
                            float* decay, float* scores, float* mrow,
                            float* inter, float* rowsum, int B, int S, int H,
                            int D, int T, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > kMaxD || T < 1 || T > kMaxT
      || S % T != 0 || B * H > 65535 || S / T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, ig, fg, h, bcum, w, m_in, decay, scores,
                        mrow, inter, rowsum, B, S, H, D, T, scale, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, ig, fg, h, bcum, w, m_in, decay,
                                scores, mrow, inter, rowsum, B, S, H, D, T,
                                scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
