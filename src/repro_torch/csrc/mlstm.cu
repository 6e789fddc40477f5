// Chunkwise-parallel mLSTM (xLSTM, arXiv:2405.04517 §2.3) from a fresh
// state, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/mlstm.py:mlstm (pallas_call body
// _mlstm_kernel).  Same function, accumulated in float32.  Per (b, head) and
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
// Two routes, chosen by the wrapper from (dtype, D) alone
// (kernels/mlstm.py:route):
//   * bf16 with D % 64 == 0 (xlstm_350m's head dim 512): the wgmma route,
//     the chunk products on the tensor cores with tiles brought by TMA;
//   * float32, and bf16 with another D: the float32 route, three launches
//     on the CUDA cores (kept from the first port: TF32 products would
//     break the float32 tolerance and the model check's float32 limits).
//
// What bounds it.  At the train shape (B 8, S 128, H 4, D 512, bf16: one
// chunk) the call moves about 16.8 MB (5.0 us at 3.35 TB/s); the two
// [T,T] products over the kept (t, j <= t) pairs are 0.54 GFLOP (8.1 us on
// the float32 pipes at 67 TFLOP/s, 0.5 us on the bf16 tensor cores), and
// every chunk after the first adds the products with C (4 T D^2
// operations a chunk).  On the tensor cores: bytes.
//
// The wgmma route.  bf16 products are exact in float32, so q.k^T goes to
// wgmma as it is, with scale applied to the float32 accumulator (one
// rounding away from the plain version's (q scale).k).  Every float32
// operand of a product (S, the carried C, w o V) goes to wgmma as bf16 hi
// + lo (hi = bf16(x), lo = bf16(x - hi): about 16 bits), two products into
// one float32 accumulator, as P.V in csrc/flash_attention.cu.  q, k and v
// come by TMA through 5-D maps that see [B, S, H, D] as (D, H, T, S/T, B),
// so rows past a chunk's end are zero-filled; boxes of 64 columns, 128-byte
// swizzle.
//   * One chunk (the main path: launch.train runs S 128 in one chunk of
//     128): one launch, the output pass alone.  A CTA takes 64 rows of the
//     chunk and up to 256 of v's columns (xl-train: 32 (b, head) x 2 row
//     tiles x 2 column halves = 128 CTAs, one wave), computes the chunk's
//     gates and the rows' stabilizers itself, then for each key tile at or
//     below the diagonal S = Q K^T, the decay weights and the mask on the
//     fragments, and o += S V.  No [T,T] scratch.
//   * More chunks: a state pass, then the output pass over every chunk at
//     once.  The state pass walks each (b, head)'s chunks in order, a CTA
//     per 64 rows of C and 256 of its columns in float32 accumulators,
//     C <- g C + (w o V)^T K with the plain version's recurrence, and
//     writes each chunk's incoming C (bf16 hi and lo), n and m.  The
//     output pass of a later chunk starts its accumulator from
//     e_t scale q C^T (C read by TMA in two stages) and adds q.n to the
//     denominator.
// Both routes: every sum runs in a fixed order and nothing is atomic, so
// two launches give the same bits; h is written in q's dtype.
//
// The float32 route's design: the TPU kernel walks the chunks of one (b,
// head) as a sequential grid axis and keeps C (1 MiB of float32 at D 512)
// in VMEM.  A block's shared memory holds 227 KB, so the work is cut three
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
// 0), the last skips the state update (nothing reads it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

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

// ---------------------------------------------------------------------------
// The wgmma route: bf16 q, k, v with D % 64 == 0 and D <= 512.
// ---------------------------------------------------------------------------

constexpr int kWgM = 64;             // rows of a tile: wgmma's M, a TMA box
constexpr int kWgThreads = 128;      // one warpgroup
constexpr uint32_t kBox = 64 * 128;  // one [64 rows x 64 columns] bf16 box
constexpr int kMaxBoxes = 4;         // 64-column boxes of an accumulator
constexpr float kNegInf = -0x1.666664p+127f;  // float32(-0.7 * FLT_MAX)

// The plan of a call, from its shape alone (kernels/mlstm.py:mlstm_plan
// mirrors it): nb boxes of 64 columns cover D; the output pass gives a CTA
// nv of them of v's columns (at most 4, and 2 when it also reads the
// carried C, whose hi and lo tiles then need the shared memory), the state
// pass a CTA nk of k's columns.
struct WgPlan {
  int nb, nrt, nc, nv, n_dv, nk, n_dk;
};

__host__ __device__ inline WgPlan wg_plan(int S, int D, int T) {
  WgPlan p;
  p.nb = D / 64;
  p.nrt = (T + kWgM - 1) / kWgM;
  p.nc = S / T;
  const int cap = p.nc == 1 ? kMaxBoxes : 2;
  p.n_dv = (p.nb + cap - 1) / cap;
  p.nv = (p.nb + p.n_dv - 1) / p.n_dv;
  p.n_dk = (p.nb + kMaxBoxes - 1) / kMaxBoxes;
  p.nk = (p.nb + p.n_dk - 1) / p.n_dk;
  return p;
}

// dynamic shared memory: 1 KB of slack to align the tiles to the 128-byte
// swizzle's 1024-byte period; the output pass holds Q and K (nb boxes
// each), V (nv boxes) and, after the first chunk, two stages of C's hi and
// lo tiles (nv boxes each); the state pass two stages of a chunk's K
// (nrt x nk boxes) and V (nrt boxes)
__host__ __device__ inline int wg_out_smem(const WgPlan& p) {
  return 1024 + static_cast<int>(kBox) *
                    (2 * p.nb + p.nv + (p.nc > 1 ? 4 * p.nv : 0));
}
__host__ __device__ inline int wg_state_smem(const WgPlan& p) {
  return 1024 + static_cast<int>(kBox) * 2 * p.nrt * (p.nk + 1);
}

// byte offset of element (row, col) in a [64 x 64] bf16 box under the
// 128-byte swizzle (box 1024-byte aligned): a row's 16-byte pieces are
// permuted by the row's index mod 8
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ float box_at(const uint8_t* box, int row,
                                        int col) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(box + swz(row, col)));
}

// The chunk's gates, in both passes with the same bits: b_s[t] is the
// inclusive cumsum of log_sigmoid(f) (a warp shuffle scan, then the warps'
// totals in order: a fixed order), li_s[t] = logi_t.  `first` indexes step
// 0 of the chunk in ig / fg [B, S, H].  Every thread calls it.
__device__ __forceinline__ void chunk_gates(const float* __restrict__ ig,
                                            const float* __restrict__ fg,
                                            size_t first, int H, int T,
                                            float* b_s, float* li_s,
                                            float* tot_s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float x = 0.f;
  if (t < T) {
    x = log_sigmoid(fg[first + static_cast<size_t>(t) * H]);
    li_s[t] = ig[first + static_cast<size_t>(t) * H];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = y + x;
  }
  if (lane == 31) tot_s[warp] = x;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off = off + tot_s[w];
  if (t < T) b_s[t] = off + x;
  __syncthreads();
}

// The output pass.  CTA (64 rows of chunk c x NV boxes of v's columns, c,
// b * H + head); one warpgroup.  Accumulator fragments as in
// csrc/flash_attention.cu: thread `lane` of warp w holds, for each 8-column
// block i of a 64-wide product, d[4i + e] at row 16w + lane / 4 + 8(e / 2)
// and column 8i + 2(lane % 4) + e % 2.
//   * After the first chunk: q.n (float32, from Q in shared memory) and
//     o = e_t * (scale * q C^T) on wgmma, C as bf16 hi + lo tiles written
//     by the state pass, streamed over k's columns in two stages.
//   * For each key tile at or below the diagonal: S = Q K^T on wgmma
//     (bf16 in, float32 out), then on the fragments
//     s = (scale * S) * exp(b_t - b_j + logi_j - m_t) for j <= t < T, else
//     0; the row sums in float32; o += S V with S as bf16 hi + lo (P.V of
//     csrc/flash_attention.cu).
//   * h = o / max(|rowsum + e_t scale q.n|, exp(-m_t)), in bf16.
template <int NV>
__global__ void __launch_bounds__(kWgThreads, 1)
mlstm_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const float* __restrict__ ig, const float* __restrict__ fg,
                   const float* __restrict__ n_in,
                   const float* __restrict__ m_in_arr,
                   __nv_bfloat16* __restrict__ h, int S, int H, int D, int T,
                   float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];  // Q, K, V, C stage 0, stage 1
  __shared__ float b_s[kMaxT], li_s[kMaxT], m_s[kWgM], e_s[kWgM],
      qn_s[kWgM], tot_s[kWgThreads / 32];
  const WgPlan p = wg_plan(S, D, T);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  const uint8_t* q_p = smem_raw + (q_s - raw);
  const uint32_t k_s = q_s + p.nb * kBox;
  const uint32_t v_s = k_s + p.nb * kBox;
  const uint32_t c_s = v_s + NV * kBox;  // stage s: hi boxes, then lo boxes
  const uint32_t bar_q = smem_u32(&bars[0]), bar_k = smem_u32(&bars[1]),
                 bar_v = smem_u32(&bars[2]);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = blockIdx.x / p.n_dv;
  const int vb0 = (blockIdx.x % p.n_dv) * NV;  // first box of v's columns
  const int nv = min(NV, p.nb - vb0);
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H, head = bh % H;
  const int t0 = rt * kWgM;
  const bool carried = c > 0;
  // C_c's rows in the state buffer: hi, then lo R rows further
  const int R = gridDim.z * (p.nc - 1) * D;
  const int c_row = ((bh * (p.nc - 1)) + c - 1) * D + vb0 * 64;

  // every product and load below takes all NV boxes of v's columns, so
  // that no branch lies between a wgmma fence and its commit (ptxas would
  // serialize the products): in a last slice with boxes past D, V's are
  // zero-filled and C's rows belong to no column that is stored
  auto issue_c = [&](int s, int kb) {
    const uint32_t dst = c_s + s * 2 * NV * kBox;
    const uint32_t bar = smem_u32(&bars[3 + s]);
    mbar_expect_tx(bar, 2 * NV * kBox);
    for (int j = 0; j < NV; ++j) {
      tma_load_2d(dst + j * kBox, &cmap, bar, 64 * kb, c_row + 64 * j);
      tma_load_2d(dst + (NV + j) * kBox, &cmap, bar, 64 * kb,
                  R + c_row + 64 * j);
    }
  };

  if (tid == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    if (carried) prefetch_map(&cmap);
    for (int i = 0; i < 5; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, p.nb * kBox);
    for (int j = 0; j < p.nb; ++j)
      tma_load_5d(q_s + j * kBox, &qmap, bar_q, 64 * j, head, t0, c, b);
    mbar_expect_tx(bar_k, p.nb * kBox);
    for (int j = 0; j < p.nb; ++j)
      tma_load_5d(k_s + j * kBox, &kmap, bar_k, 64 * j, head, 0, c, b);
    mbar_expect_tx(bar_v, NV * kBox);
    for (int j = 0; j < NV; ++j)
      tma_load_5d(v_s + j * kBox, &vmap, bar_v, 64 * (vb0 + j), head, 0, c, b);
    if (carried)
      for (int s = 0; s < 2 && s < p.nb; ++s) issue_c(s, s);
  }

  chunk_gates(ig, fg, (static_cast<size_t>(b) * S + c * T) * H + head, H, T,
              b_s, li_s, tot_s);
  const float m_in = carried ? m_in_arr[static_cast<size_t>(bh) * p.nc + c]
                             : kNegInf;
  // the rows' stabilizers: two threads a row, each over every other j <= t
  // (a max: exact in any order)
  {
    const int i = tid >> 1, t = t0 + i;
    float mx = -3.40282347e38f;
    if (t < T)
      for (int j = tid & 1; j <= t; j += 2)
        mx = fmaxf(mx, (b_s[t] - b_s[j]) + li_s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    if ((tid & 1) == 0) {
      const float bt = t < T ? b_s[t] : 0.f;
      const float m = fmaxf(bt + m_in, mx);
      m_s[i] = m;
      e_s[i] = expf((bt + m_in) - m);
    }
  }
  __syncthreads();

  const int rl0 = warp * 16 + (lane >> 2);  // local rows rl0, rl0 + 8
  const int col0 = 2 * (lane & 3);
  float o[NV][32];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;

  mbar_wait(bar_q, 0);
  __syncwarp();
  if (carried) {
    // q.n: two threads a row, each over half of k's columns, in order
    const float* n_c =
        n_in + (static_cast<size_t>(bh) * (p.nc - 1) + c - 1) * D;
    const int i = tid >> 1, half = tid & 1;
    float part = 0.f;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      part = fmaf(box_at(q_p + (d >> 6) * kBox, i, d & 63), n_c[d], part);
    const float other = __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) qn_s[i] = part + other;
    // q C^T over k's columns, box by box, C as hi + lo
    for (int kb = 0; kb < p.nb; ++kb) {
      const int s = kb & 1;
      const uint32_t cs = c_s + s * 2 * NV * kBox;
      mbar_wait(smem_u32(&bars[3 + s]), (kb >> 1) & 1);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NV; ++j) fence_regs(o[j]);
      wg_fence();
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = smem_desc(q_s + kb * kBox + kk * 32, 16, 1024);
          wgmma_ss(o[j], da, smem_desc(cs + j * kBox + kk * 32, 16, 1024), 1);
          wgmma_ss(o[j], da,
                   smem_desc(cs + (NV + j) * kBox + kk * 32, 16, 1024), 1);
        }
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int j = 0; j < NV; ++j) fence_regs(o[j]);
      __syncthreads();  // every warp is done reading stage s
      if (tid == 0 && kb + 2 < p.nb) issue_c(s, kb + 2);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[j][i] = e_s[rl0 + 8 * ((i >> 1) & 1)] * (o[j][i] * scale);
  }

  float rs[2] = {0.f, 0.f};  // this thread's share of each row's sum
  for (int kt = 0; kt <= rt; ++kt) {
    mbar_wait(bar_k, kt & 1);
    __syncwarp();
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
    // unrolled to the most boxes, with an exit: no loop back-edge between
    // the fence and the commit, which would serialize the products
#pragma unroll
    for (int bx = 0; bx < kMaxD / 64; ++bx) {
      if (bx >= p.nb) break;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = bx * kBox + kk * 32;
        wgmma_ss(sc, smem_desc(q_s + off, 16, 1024),
                 smem_desc(k_s + off, 16, 1024), 1);
      }
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    __syncthreads();  // every warp is done reading K
    if (tid == 0 && kt < rt) {
      mbar_expect_tx(bar_k, p.nb * kBox);
      for (int j = 0; j < p.nb; ++j)
        tma_load_5d(k_s + j * kBox, &kmap, bar_k, 64 * j, head,
                  kWgM * (kt + 1), c, b);
    }
    // decay weights and the causal mask, on the fragments
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kWgM * kt + 8 * i + col0 + (e & 1);
        const int rl = rl0 + 8 * (e >> 1);
        const int t = t0 + rl;
        float x = 0.f;
        if (j <= t && t < T)
          x = (sc[4 * i + e] * scale) *
              expf(((b_s[t] - b_s[j]) + li_s[j]) - m_s[rl]);
        sc[4 * i + e] = x;
        rs[e >> 1] += x;
      }
    }
    // S as wgmma's A fragment for key step kk (keys 16kk .. 16kk + 15),
    // bf16 hi and lo: register r holds columns of block 2kk + r / 2, row
    // half r % 2
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 2 * kk + (r >> 1);
        const int e = 2 * (r & 1);
        const float a = sc[4 * i + e];
        const float d = sc[4 * i + e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, d);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][r] = bf16x2_bits(hi);
        pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, d - hf.y));
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) fence_regs(o[j]);
    mbar_wait(bar_v, kt & 1);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = smem_desc(v_s + j * kBox + kk * 2048, 1024, 1024);
        wgmma_rs(o[j], ph[kk], dv);
        wgmma_rs(o[j], pl[kk], dv);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < NV; ++j) fence_regs(o[j]);
    __syncthreads();  // every warp is done reading V
    if (tid == 0 && kt < rt) {
      mbar_expect_tx(bar_v, NV * kBox);
      for (int j = 0; j < NV; ++j)
        tma_load_5d(v_s + j * kBox, &vmap, bar_v, 64 * (vb0 + j), head,
                  kWgM * (kt + 1), c, b);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = rl0 + 8 * r;
    const int t = t0 + rl;
    if (t >= T) continue;
    float den = rs[r];
    if (carried) den = den + e_s[rl] * (scale * qn_s[rl]);
    den = fmaxf(fabsf(den), expf(-m_s[rl]));
    __nv_bfloat16* dst =
        h + ((static_cast<size_t>(b) * S + c * T + t) * H + head) * D +
        64 * vb0;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j >= nv) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + col0;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[j][4 * i + 2 * r] / den,
                                  o[j][4 * i + 2 * r + 1] / den);
      }
    }
  }
}

// The state pass (more than one chunk).  CTA (64 rows of C, i.e. of v's
// columns, x nk boxes of k's columns, b * H + head); one warpgroup walks
// the chunks in order with its tile of C in float32 accumulators:
//   C <- g C + (w o V)^T K
// on wgmma (A = (w o V)^T from registers as bf16 hi + lo, B = the chunk's
// K tile, MN-major), and n <- g n + sum_j w_j k_j (the CTAs of the first
// row tile, float32 on the CUDA cores).  After chunk c it writes C_{c+1}
// as bf16 hi and lo, n_{c+1} and m_{c+1}: what the output pass of chunk
// c + 1 reads.  The chunks' K and V tiles come by TMA in two stages.
template <int NK>
__global__ void __launch_bounds__(kWgThreads, 1)
mlstm_state_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ ig, const float* __restrict__ fg,
                   __nv_bfloat16* __restrict__ cstate,
                   float* __restrict__ n_out, float* __restrict__ m_out_arr,
                   int S, int H, int D, int T) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float b_s[kMaxT], li_s[kMaxT], w_s[kMaxT],
      tot_s[kWgThreads / 32], red_s[kWgThreads / 32];
  const WgPlan p = wg_plan(S, D, T);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* base_p = smem_raw + (base - raw);
  const uint32_t stage_bytes = kBox * p.nrt * (NK + 1);
  // stage s: K boxes (row tile rt, box j) at (rt * NK + j), V box of row
  // tile rt at (nrt * NK + rt)
  auto k_off = [&](int s, int rt, int j) {
    return s * stage_bytes + (rt * NK + j) * kBox;
  };
  auto v_off = [&](int s, int rt) {
    return s * stage_bytes + (p.nrt * NK + rt) * kBox;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vt = blockIdx.x / p.n_dk;  // box of v's columns: rows of C
  const int kb0 = (blockIdx.x % p.n_dk) * NK;
  const int nk = min(NK, p.nb - kb0);
  const int bh = blockIdx.y;
  const int b = bh / H, head = bh % H;
  const size_t R = static_cast<size_t>(gridDim.y) * (p.nc - 1) * D;

  auto issue = [&](int s, int c) {
    const uint32_t bar = smem_u32(&bars[s]);
    mbar_expect_tx(bar, p.nrt * (nk + 1) * kBox);
    for (int rt = 0; rt < p.nrt; ++rt) {
      for (int j = 0; j < nk; ++j)
        tma_load_5d(base + k_off(s, rt, j), &kmap, bar, 64 * (kb0 + j), head,
                  kWgM * rt, c, b);
      tma_load_5d(base + v_off(s, rt), &vmap, bar, 64 * vt, head, kWgM * rt,
                c, b);
    }
  };

  if (tid == 0) {
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    for (int i = 0; i < 2; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < 2 && s < p.nc - 1; ++s) issue(s, s);

  const int rl0 = warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float acc[NK][32];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float n_acc[2] = {0.f, 0.f};  // n at k's columns 64 kb0 + 2 tid + u
  float m_in = kNegInf;

  for (int c = 0; c < p.nc - 1; ++c) {
    const int s = c & 1;
    chunk_gates(ig, fg, (static_cast<size_t>(b) * S + c * T) * H + head, H,
                T, b_s, li_s, tot_s);
    const float F = b_s[T - 1];
    float mx = tid < T ? (F - b_s[tid]) + li_s[tid] : -3.40282347e38f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red_s[warp] = mx;
    __syncthreads();
    for (int w = 0; w < kWgThreads / 32; ++w) mx = fmaxf(mx, red_s[w]);
    const float m_out = fmaxf(F + m_in, mx);
    if (tid < T) w_s[tid] = expf(((F - b_s[tid]) + li_s[tid]) - m_out);
    const float g = expf((F + m_in) - m_out);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= g;

    mbar_wait(smem_u32(&bars[s]), (c >> 1) & 1);
    __syncwarp();
    for (int rt = 0; rt < p.nrt; ++rt) {
      // (w o V)^T as A fragments: rows are v's columns (this CTA's box),
      // columns the chunk's steps j = 64 rt + 16 kk + ...
      const uint8_t* vbox = base_p + v_off(s, rt);
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int dv = rl0 + 8 * (r & 1);
          const int jl = 16 * kk + 8 * (r >> 1) + col0;
          const int j = kWgM * rt + jl;
          const float a = j < T ? w_s[j] * box_at(vbox, jl, dv) : 0.f;
          const float d = j + 1 < T ? w_s[j + 1] * box_at(vbox, jl + 1, dv)
                                    : 0.f;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, d);
          const float2 hf = __bfloat1622float2(hi);
          ah[kk][r] = bf16x2_bits(hi);
          al[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, d - hf.y));
        }
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) fence_regs(acc[j]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kWgM * rt + 16 * kk >= T) break;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          if (j >= nk) break;
          const uint64_t db =
              smem_desc(base + k_off(s, rt, j) + kk * 2048, 1024, 1024);
          wgmma_rs(acc[j], ah[kk], db);
          wgmma_rs(acc[j], al[kk], db);
        }
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int j = 0; j < NK; ++j) fence_regs(acc[j]);
    }
    // n: the CTAs of the first box of v's columns, two of k's columns a
    // thread, the steps in order
    const size_t row0 = (static_cast<size_t>(bh) * (p.nc - 1) + c) * D;
    if (vt == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int dk = 2 * tid + u;  // within this CTA's nk boxes
        if (dk >= 64 * nk) continue;
        float sum = 0.f;
        for (int j = 0; j < T; ++j)
          sum = fmaf(w_s[j],
                     box_at(base_p + k_off(s, j >> 6, dk >> 6), j & 63,
                            dk & 63),
                     sum);
        n_acc[u] = g * n_acc[u] + sum;
        n_out[row0 + 64 * kb0 + dk] = n_acc[u];
      }
    }
    // C_{c+1} as bf16 hi and lo
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      if (j >= nk) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int dv = 64 * vt + rl0 + 8 * r;
          const int dk = 64 * (kb0 + j) + 8 * i + col0;
          const float x0 = acc[j][4 * i + 2 * r];
          const float x1 = acc[j][4 * i + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          __nv_bfloat16* dst = cstate + (row0 + dv) * D + dk;
          *reinterpret_cast<__nv_bfloat162*>(dst) = hi;
          *reinterpret_cast<__nv_bfloat162*>(dst + R * D) =
              __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
        }
      }
    }
    if (blockIdx.x == 0 && tid == 0)
      m_out_arr[static_cast<size_t>(bh) * p.nc + c + 1] = m_out;
    m_in = m_out;
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && c + 2 < p.nc - 1) issue(s, c + 2);
  }
}

// above 48 KB a kernel's shared memory must be opted into: raised once per
// kernel to the most its launches have asked for (the first call of a
// shape comes before any capture)
template <typename K>
cudaError_t opt_in(K kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int NV>
cudaError_t launch_out(const WgPlan& p, const CUtensorMap& qm,
                       const CUtensorMap& km, const CUtensorMap& vm,
                       const CUtensorMap& cm, const float* ig,
                       const float* fg, const float* n_state,
                       const float* m_state, void* h, int BH, int S, int H,
                       int D, int T, float scale, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const int smem = wg_out_smem(p);
  cudaError_t err = opt_in(mlstm_wgmma_kernel<NV>, smem, &allowed);
  if (err != cudaSuccess) return err;
  mlstm_wgmma_kernel<NV><<<dim3(p.nrt * p.n_dv, p.nc, BH), kWgThreads, smem,
                           stream>>>(
      qm, km, vm, cm, ig, fg, n_state, m_state,
      static_cast<__nv_bfloat16*>(h), S, H, D, T, scale);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_state(const WgPlan& p, const CUtensorMap& km,
                         const CUtensorMap& vm, const float* ig,
                         const float* fg, void* cstate, float* n_state,
                         float* m_state, int BH, int S, int H, int D, int T,
                         cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const int smem = wg_state_smem(p);
  cudaError_t err = opt_in(mlstm_state_kernel<NK>, smem, &allowed);
  if (err != cudaSuccess) return err;
  mlstm_state_kernel<NK><<<dim3(p.nb * p.n_dk, BH), kWgThreads, smem,
                           stream>>>(
      km, vm, ig, fg, static_cast<__nv_bfloat16*>(cstate), n_state, m_state,
      S, H, D, T);
  return cudaGetLastError();
}

// the 5-D map over a contiguous bf16 [B, S, H, D] tensor seen as (D, H, T,
// S / T, B), boxes of 64 columns x 1 head x 64 rows x 1 chunk x 1 batch row
// (coordinates: column, head, row in the chunk, chunk, batch row): rows
// past a chunk's T steps are zero-filled, so a tile never reads the next
// chunk
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                 int S, int H, int D, int T) {
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(S / T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {row, row * H, row * H * T, row * H * S};
  const cuuint32_t box[5] = {64, 1, kWgM, 1, 1};
  return encode_bf16_map(fn, map, ptr, 5, dims, strides, box);
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

// The wgmma route's plan, as the launch computes it: writes nb, nrt, nc,
// nv, n_dv, nk, n_dk, the output pass's CTAs and shared-memory bytes, then
// the state pass's (0 and 0 for one chunk) to out[0..10].
extern "C" int mlstm_wgmma_plan(int B, int S, int H, int D, int T, int* out) {
  if (B < 1 || H < 1 || D < 64 || D > kMaxD || D % 64 != 0 || T < 1 ||
      T > kMaxT || S < T || S % T != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgPlan p = wg_plan(S, D, T);
  const int vals[11] = {p.nb, p.nrt, p.nc, p.nv, p.n_dv, p.nk, p.n_dk,
                        p.nrt * p.n_dv * p.nc * B * H, wg_out_smem(p),
                        p.nc > 1 ? p.nb * p.n_dk * B * H : 0,
                        p.nc > 1 ? wg_state_smem(p) : 0};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

// The wgmma route: q, k, v and h bf16 [B, S, H, D], contiguous, 16-byte
// aligned, D % 64 == 0 and D <= 512; gates float32 [B, S, H].  With more
// than one chunk, scratch cstate bf16 [2, B*H, S/T - 1, D, D] (C's hi,
// then lo), n_state float32 [B*H, S/T - 1, D], m_state float32 [B*H,
// S/T]; with one chunk they may be null.  Launches the state pass (more
// than one chunk), then the output pass.  Returns the CUDA error code of
// the launches (0 on success); cudaErrorNotSupported when the driver
// offers no cuTensorMapEncodeTiled or refuses a map.
extern "C" int mlstm_wgmma_launch(const void* q, const void* k, const void* v,
                                  const float* ig, const float* fg, void* h,
                                  void* cstate, float* n_state,
                                  float* m_state, int B, int S, int H, int D,
                                  int T, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 64 || D > kMaxD || D % 64 != 0 ||
      T < 1 || T > kMaxT || S % T != 0 || B * H > 65535 || S / T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(h) |
       reinterpret_cast<uintptr_t>(cstate)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgPlan p = wg_plan(S, D, T);
  if (p.nc > 1 && (cstate == nullptr || n_state == nullptr ||
                   m_state == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm, cm;
  std::memset(&cm, 0, sizeof(cm));  // read only after the first chunk
  if (!encode_rows(fn, &qm, q, B, S, H, D, T) ||
      !encode_rows(fn, &km, k, B, S, H, D, T) ||
      !encode_rows(fn, &vm, v, B, S, H, D, T))
    return static_cast<int>(cudaErrorNotSupported);
  const int BH = B * H;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (p.nc > 1) {
    const cuuint64_t dims[2] = {
        static_cast<cuuint64_t>(D),
        static_cast<cuuint64_t>(2) * BH * (p.nc - 1) * D};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
    const cuuint32_t box[2] = {64, kWgM};
    if (dims[1] > 0x7fffffffull ||
        !encode_bf16_map(fn, &cm, cstate, 2, dims, strides, box))
      return static_cast<int>(cudaErrorNotSupported);
    switch (p.nk) {
      case 1:
        err = launch_state<1>(p, km, vm, ig, fg, cstate, n_state, m_state,
                              BH, S, H, D, T, st);
        break;
      case 2:
        err = launch_state<2>(p, km, vm, ig, fg, cstate, n_state, m_state,
                              BH, S, H, D, T, st);
        break;
      case 3:
        err = launch_state<3>(p, km, vm, ig, fg, cstate, n_state, m_state,
                              BH, S, H, D, T, st);
        break;
      default:
        err = launch_state<4>(p, km, vm, ig, fg, cstate, n_state, m_state,
                              BH, S, H, D, T, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (p.nv) {
    case 1:
      err = launch_out<1>(p, qm, km, vm, cm, ig, fg, n_state, m_state, h, BH,
                          S, H, D, T, scale, st);
      break;
    case 2:
      err = launch_out<2>(p, qm, km, vm, cm, ig, fg, n_state, m_state, h, BH,
                          S, H, D, T, scale, st);
      break;
    case 3:
      err = launch_out<3>(p, qm, km, vm, cm, ig, fg, n_state, m_state, h, BH,
                          S, H, D, T, scale, st);
      break;
    default:
      err = launch_out<4>(p, qm, km, vm, cm, ig, fg, n_state, m_state, h, BH,
                          S, H, D, T, scale, st);
  }
  return static_cast<int>(err);
}
