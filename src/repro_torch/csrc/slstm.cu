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
// from c = 0, n = 1, h = 0, m = 0, with h_seq written in x's dtype.  Each
// dot product is fmaf over i = 0 .. hb-1 in order, then x is added; the
// cell update rounds each product, sum and quotient as the plain version
// does (__fmul_rn, __fadd_rn, __fdiv_rn: no contraction).  No fast math:
// expf, tanhf and IEEE divisions.  Both routes below share this
// arithmetic, so they give the same bits.
//
// What bounds it: the recurrence.  At the train shape (B 8, S 128, W 1024,
// H 4, hb 256, bf16) the call moves about 14.7 MB (4.4 us at 3.35 TB/s)
// and does about 2.2 GFLOP of float32 (32 us at 67 TFLOP/s), but step t
// needs all of h_{t-1}: the S steps run one after another, each a
// [rows,hb]x[hb,hb] product per gate whose every output is a chain of hb
// dependent fmaf (1024 cycles at hb 256).  Within a step, shared memory
// is the limit: every warp reads the whole of h (one word a lane per
// value) besides its own r columns.
//
// What the design does: the TPU kernel keeps a head's four r blocks (1 MiB
// of float32 at hb 256) in VMEM; a block's shared memory holds 227 KB.
//
//   * The cluster route (slstm_cluster_kernel): one thread-block cluster
//     per (head, group of batch rows); CTA `rank` of the cluster holds
//     columns [rank * cols, (rank + 1) * cols) of the head's four r blocks
//     in its shared memory for the whole sequence, loaded once before
//     step 0 (at the train shape 16 CTAs of 16 columns, 66 KB each, a
//     cluster of more than 8 CTAs).  Each thread owns one column and two
//     of its gates (its two r columns interleaved, float4 loads) and sums
//     their dot products for every row of the group at once: each r value
//     read feeds every row, each h value two gates; batches of rows load
//     ahead of their products (four in flight at one or two rows).  The
//     partner lane holds the column's other two gates: one shuffle a gate
//     and row, then each lane updates the cells of half the rows, its
//     state in registers.  The lanes then send their column of h_t into
//     every CTA's double-buffered h with st.async, which counts the bytes
//     on the receiving CTA's mbarrier; a CTA starts step t + 1 when all
//     of h_t has arrived.  No cluster barrier a step: a CTA overwrites a
//     peer's h_{t-1} (with h_{t+1}) only after it has that peer's part of
//     h_t, which the peer sends after its step t products read h_{t-1}.
//     The plan
//     (kernels/slstm.py:slstm_plan) picks the cluster, the columns a CTA
//     and the batch grouping from the shape alone.
//   * The L2 route (slstm_l2_kernel), where a head's r slice does not fit a
//     cluster's shared memory (hb 512: 4 MiB a head): one block per
//     (head, b), one thread per column, h double-buffered in shared memory,
//     r_g[h][:, j] read from L2 on every step, 16 rows ahead.
//
// No atomics; every sum runs in a fixed order: two launches give the same
// bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHb = 512;       // one thread per column of a head (L2)
constexpr int kAhead = 16;        // rows of r loaded ahead of their sums (L2)
constexpr int kMaxCluster = 16;   // CTAs a cluster (above 8: non-portable)
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kLoadAhead = 16;    // r loads in flight a thread (cluster)

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

// One step of a cell from its four gate pre-activations; updates (c, n, m)
// and returns h, rounding as the plain version (ref.naive_slstm) does.
__device__ __forceinline__ float cell(float zi, float zf, float zz, float zo,
                                      float& c, float& n, float& m) {
  const float fm = __fadd_rn(zf, m);
  const float m_new = fmaxf(fm, zi);
  const float ie = expf(__fsub_rn(zi, m_new));
  const float fe = expf(__fsub_rn(fm, m_new));
  c = __fadd_rn(__fmul_rn(fe, c), __fmul_rn(ie, tanhf(zz)));
  n = __fadd_rn(__fmul_rn(fe, n), ie);
  m = m_new;
  const float sig = __frcp_rn(__fadd_rn(1.f, expf(-zo)));  // = 1 / (...)
  return __fdiv_rn(__fmul_rn(sig, c), fmaxf(n, 1e-6f));
}

// ---- the L2 route ----------------------------------------------------------

// x_* and hs [B, S, W]; r_* [H, hb, hb] float32.  Block (head, b); thread
// j < hb owns column j of the head.
template <typename T>
__global__ void __launch_bounds__(kMaxHb)
slstm_l2_kernel(const T* __restrict__ xi, const T* __restrict__ xf,
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
      const float h = cell(__fadd_rn(to_f32(xi[xoff]), zi),
                           __fadd_rn(to_f32(xf[xoff]), zf),
                           __fadd_rn(to_f32(xz[xoff]), zz),
                           __fadd_rn(to_f32(xo[xoff]), zo), c, n, m);
      h_next[j] = h;
      hs[xoff] = from_f32<T>(h);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_l2(const void* xi, const void* xf, const void* xz,
                      const void* xo, const float* ri, const float* rf,
                      const float* rz, const float* ro, void* hs, int B,
                      int S, int H, int hb, cudaStream_t stream) {
  const int threads = (hb + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)hb * sizeof(float);
  slstm_l2_kernel<T><<<dim3(H, B), threads, smem, stream>>>(
      static_cast<const T*>(xi), static_cast<const T*>(xf),
      static_cast<const T*>(xz), static_cast<const T*>(xo), ri, rf, rz, ro,
      static_cast<T*>(hs), S, H * hb, hb);
  return cudaGetLastError();
}

// ---- the cluster route -----------------------------------------------------

// Rows of h padded to a multiple of 32; a thread's two r columns
// interleaved [i][2] and padded by 4 floats, so that its float4 loads are
// aligned and the 8 threads of a load phase start on 8 different 4-bank
// groups.  Shared memory: two mbarriers (16 bytes), r, then h.
__host__ __device__ __forceinline__ int padded_hb(int hb) {
  return (hb + 31) / 32 * 32;
}
__host__ __device__ __forceinline__ int pair_stride(int hb) {
  return 2 * padded_hb(hb) + 4;
}
__host__ __device__ __forceinline__ size_t cluster_smem_floats(int hb,
                                                               int cols,
                                                               int rp) {
  return 4 + (size_t)2 * cols * pair_stride(hb) +
         (size_t)2 * padded_hb(hb) * rp;
}

// Selects v[k] for a run-time k < N without indexing a register array.
template <int N>
__device__ __forceinline__ float pick(const float* v, int k) {
  float out = v[0];
#pragma unroll
  for (int q = 1; q < N; ++q) out = k == q ? v[q] : out;
  return out;
}

// The dot products of kI rows i0 .. i0 + kI - 1 for a thread's two gates:
// r from its interleaved pair of columns, h broadcast to every thread.
template <int RP, int kI>
struct Batch {
  float4 r[kI / 2];
  float4 h[kI * RP / 4];
  __device__ __forceinline__ void load(const float* r_pair, const float* h,
                                       int i0) {
#pragma unroll
    for (int q = 0; q < kI / 2; ++q)
      r[q] = *reinterpret_cast<const float4*>(r_pair + 2 * i0 + 4 * q);
#pragma unroll
    for (int q = 0; q < kI * RP / 4; ++q)
      this->h[q] = *reinterpret_cast<const float4*>(h + i0 * RP + 4 * q);
  }
  __device__ __forceinline__ void fma(float (*acc)[RP]) const {
    const float* rv = reinterpret_cast<const float*>(r);
    const float* hv = reinterpret_cast<const float*>(h);
#pragma unroll
    for (int u = 0; u < kI; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int q = 0; q < RP; ++q)
          acc[e][q] = fmaf(hv[u * RP + q], rv[2 * u + e], acc[e][q]);
      }
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// this CTA's mbarrier `bar` expects `bytes` more for its current phase,
// and counts this thread's arrival
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// waits for the phase of parity `parity` to complete; a phase that never
// completes (bytes miscounted) traps after about 10 s instead of hanging
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

// RP rows of h to a [hbp][RP] buffer of another CTA (shared::cluster
// addresses), each store counted on that CTA's mbarrier
template <int RP>
__device__ __forceinline__ void send_h(uint32_t addr, uint32_t bar,
                                       const float* h) {
  if constexpr (RP == 1) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
        "[%2];" ::"r"(addr), "f"(h[0]), "r"(bar) : "memory");
  } else if constexpr (RP == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
        "{%1, %2}, [%3];" ::"r"(addr), "f"(h[0]), "f"(h[1]), "r"(bar)
        : "memory");
  } else {
#pragma unroll
    for (int q = 0; q < RP / 4; ++q) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
          "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr + 16 * q),
          "f"(h[4 * q]), "f"(h[4 * q + 1]), "f"(h[4 * q + 2]),
          "f"(h[4 * q + 3]), "r"(bar) : "memory");
    }
  }
}

// x_* and hs [B, S, W]; r_* [H, hb, hb] float32.  Grid (cluster, H,
// groups), cluster (cluster, 1, 1); group g holds batch rows [g * rows,
// min(B, (g + 1) * rows)), rows <= RP.  Thread 2 * j + q owns column
// rank * cols + j, gates 2q and 2q + 1, and the cells of rows q, q + 2,
// ... of that column.  h_{t-1} sits in buffer t & 1; every CTA's threads
// send their h_t rows into every CTA's buffer (t + 1) & 1 with st.async,
// and mbarrier (t + 1) & 1 of the receiving CTA counts the bytes.
template <typename T, int RP>
__global__ void __launch_bounds__(2 * 64)
slstm_cluster_kernel(const T* __restrict__ xi, const T* __restrict__ xf,
                     const T* __restrict__ xz, const T* __restrict__ xo,
                     const float* __restrict__ ri,
                     const float* __restrict__ rf,
                     const float* __restrict__ rz,
                     const float* __restrict__ ro, T* __restrict__ hs, int B,
                     int S, int hb, int cols, int rows) {
  constexpr int kI = RP == 8 ? 4 : 8;     // rows of a load batch
  constexpr int kStages = RP <= 2 ? 4 : 2;  // batches in flight
  constexpr int kPasses = (RP + 1) / 2;   // cells a lane updates
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int head = blockIdx.y;
  const int b0 = blockIdx.z * rows;
  const int n_rows = min(rows, B - b0);
  const int W = gridDim.y * hb;
  const int c0 = rank * cols;
  const int tid = threadIdx.x;
  const int j = tid / 2;
  const int q = tid % 2;  // gates 2q, 2q + 1
  const int col = c0 + j;
  const bool live = j < cols && col < hb;
  const int hbp = padded_hb(hb);
  const int stride = pair_stride(hb);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* r_s = smem + 4;
  float* h_buf = r_s + (size_t)2 * cols * stride;
  const uint32_t bytes = hb * RP * sizeof(float);  // h_t, every column

  // the CTA's columns of the four r blocks, once (rows past hb zero),
  // kLoadAhead loads in flight a thread, float4s where the columns are
  // whole float4s; h_{-1} = 0 in both buffers; both mbarriers armed for
  // their first fill
  const bool aligned = ((reinterpret_cast<uintptr_t>(ri) |
                         reinterpret_cast<uintptr_t>(rf) |
                         reinterpret_cast<uintptr_t>(rz) |
                         reinterpret_cast<uintptr_t>(ro)) % 16) == 0;
  const int vec =
      aligned && cols % 4 == 0 && c0 + cols <= hb && hb % 4 == 0 ? 4 : 1;
  const int units = 4 * hbp * (cols / vec);
  for (int e0 = tid; e0 < units; e0 += kLoadAhead * blockDim.x) {
    float v[kLoadAhead][4];
#pragma unroll
    for (int u = 0; u < kLoadAhead; ++u) {
      const int e = e0 + u * blockDim.x;
      const int jj = e % (cols / vec) * vec;
      const int i = e / (cols / vec) % hbp;
      const int g = e / ((cols / vec) * hbp);
      const float* src = (g == 0 ? ri : g == 1 ? rf : g == 2 ? rz : ro) +
                         ((size_t)head * hb + min(i, hb - 1)) * hb + c0 + jj;
      const bool in = e < units && i < hb && c0 + jj < hb;
      if (vec == 4) {
        const float4 w = in ? *reinterpret_cast<const float4*>(src)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[u][0] = w.x;
        v[u][1] = w.y;
        v[u][2] = w.z;
        v[u][3] = w.w;
      } else {
        v[u][0] = in ? *src : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadAhead; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= units) break;
      const int jj = e % (cols / vec) * vec;
      const int i = e / (cols / vec) % hbp;
      const int g = e / ((cols / vec) * hbp);
      for (int k = 0; k < vec; ++k)
        r_s[((jj + k) * 2 + g / 2) * stride + 2 * i + g % 2] = v[u][k];
    }
  }
  for (int e = tid; e < 2 * hbp * RP; e += blockDim.x) h_buf[e] = 0.f;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_addr(bars + k)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    expect_bytes(smem_addr(bars + 1), bytes);  // h_0, read at step 1
    expect_bytes(smem_addr(bars + 0), bytes);  // h_1, read at step 2
  }
  cluster.sync();  // every CTA's buffers and mbarriers are ready

  const T* x_a = q == 0 ? xi : xz;  // gate 2q
  const T* x_b = q == 0 ? xf : xo;  // gate 2q + 1
  const int partner = (threadIdx.x % 32) ^ 1;
  const float* r_pair = r_s + (size_t)min(tid, 2 * cols - 1) * stride;
  // this column's rows of h, and the mbarriers, in shared::cluster space
  const uint32_t h_col = smem_addr(h_buf + (size_t)min(col, hb - 1) * RP);
  const uint32_t bar0 = smem_addr(bars);
  const size_t x_off = (size_t)head * hb + col;
  // the cell of row q + 2p, p < kPasses
  float c[kPasses], n[kPasses], m[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    c[p] = 0.f;
    n[p] = 1.f;
    m[p] = 0.f;
  }
  for (int t = 0; t < S; ++t) {
    if (t > 0) {
      // h_{t-1} from every CTA; then re-arm this buffer for h_{t+1}
      wait_phase(bar0 + 8 * (t & 1), ((t - 1) / 2) & 1);
      if (tid == 0 && t + 2 < S) expect_bytes(bar0 + 8 * (t & 1), bytes);
    }
    // this step's x, in flight during the products
    T xa[RP], xb[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const size_t o = ((size_t)(b0 + min(r, n_rows - 1)) * S + t) * W +
                       min(x_off, (size_t)W - 1);
      xa[r] = x_a[o];
      xb[r] = x_b[o];
    }
    const float* h_prev = h_buf + (t & 1) * hbp * RP;
    float acc[2][RP];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int r = 0; r < RP; ++r) acc[e][r] = 0.f;
    }
    // kStages batches in flight: the loads of the batch kStages - 1
    // ahead go out before each batch's products (hbp is a multiple of
    // kStages * kI)
    Batch<RP, kI> st[kStages];
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k)
      st[k].load(r_pair, h_prev, k * kI);
    for (int i0 = 0; i0 < hbp; i0 += kStages * kI) {
#pragma unroll
      for (int k = 0; k < kStages; ++k) {
        const int ahead = i0 + (k + kStages - 1) * kI;
        if (ahead < hbp)
          st[(k + kStages - 1) % kStages].load(r_pair, h_prev, ahead);
        st[k].fma(acc);
      }
    }
    float za[RP], zb[RP];  // this lane's gates 2q, 2q + 1, every row
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      za[r] = __fadd_rn(to_f32(xa[r]), acc[0][r]);
      zb[r] = __fadd_rn(to_f32(xb[r]), acc[1][r]);
    }
    // the partner lane holds the other two gates: each lane sends the
    // partner's rows (1 - q) + 2p and takes its own rows q + 2p
    float h_mine[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int give = min(1 - q + 2 * p, RP - 1);
      const int keep = min(q + 2 * p, RP - 1);
      const float oa = __shfl_sync(0xffffffffu, pick<RP>(za, give), partner);
      const float ob = __shfl_sync(0xffffffffu, pick<RP>(zb, give), partner);
      const float ma = pick<RP>(za, keep), mb = pick<RP>(zb, keep);
      // one straight-line cell a pass, so that the passes interleave
      h_mine[p] = cell(q == 0 ? ma : oa, q == 0 ? mb : ob, q == 0 ? oa : ma,
                       q == 0 ? ob : mb, c[p], n[p], m[p]);
    }
    float h_out[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const float h = __shfl_sync(0xffffffffu, h_mine[r / 2],
                                  ((threadIdx.x % 32) & ~1) | (r % 2));
      h_out[r] = r < n_rows ? h : 0.f;
    }
    if (t + 1 < S && live) {
      // lane q of the column sends its rows to CTAs q, q + 2, ...
      const uint32_t buf = h_col + ((t + 1) & 1) * hbp * RP * sizeof(float);
      const uint32_t bar = bar0 + 8 * ((t + 1) & 1);
      for (int p = q; p < n_cta; p += 2) {
        uint32_t remote, remote_bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(remote) : "r"(buf), "r"(p));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(remote_bar) : "r"(bar), "r"(p));
        send_h<RP>(remote, remote_bar, h_out);
      }
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = q + 2 * p;
      if (live && r < n_rows)
        hs[((size_t)(b0 + r) * S + t) * W + x_off] = from_f32<T>(h_mine[p]);
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still signal it
}

// above 48 KB a block's shared memory must be opted into, and clusters of
// more than 8 CTAs too
template <typename K>
cudaError_t opt_in(K kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, int RP>
cudaLaunchConfig_t cluster_config(int B, int H, int hb, int cluster,
                                  int cols, int rows, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, (B + rows - 1) / rows);
  cfg.blockDim = dim3((2 * cols + 31) / 32 * 32);
  cfg.dynamicSmemBytes = sizeof(float) * cluster_smem_floats(hb, cols, RP);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int RP>
cudaError_t launch_cluster(const void* xi, const void* xf, const void* xz,
                           const void* xo, const float* ri, const float* rf,
                           const float* rz, const float* ro, void* hs, int B,
                           int S, int H, int hb, int cluster, int cols,
                           int rows, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into, once per
  // instantiation, before any graph capture
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = opt_in(slstm_cluster_kernel<T, RP>);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config<T, RP>(B, H, hb, cluster, cols, rows, stream, attr);
  return cudaLaunchKernelEx(
      &cfg, slstm_cluster_kernel<T, RP>, static_cast<const T*>(xi),
      static_cast<const T*>(xf), static_cast<const T*>(xz),
      static_cast<const T*>(xo), ri, rf, rz, ro, static_cast<T*>(hs), B, S,
      hb, cols, rows);
}

template <typename T>
cudaError_t launch(int cluster, int cols, int rows, const void* xi,
                   const void* xf, const void* xz, const void* xo,
                   const float* ri, const float* rf, const float* rz,
                   const float* ro, void* hs, int B, int S, int H, int hb,
                   cudaStream_t stream) {
  if (cluster == 0)
    return launch_l2<T>(xi, xf, xz, xo, ri, rf, rz, ro, hs, B, S, H, hb,
                        stream);
#define SLSTM_CLUSTER(RP)                                                   \
  launch_cluster<T, RP>(xi, xf, xz, xo, ri, rf, rz, ro, hs, B, S, H, hb, \
                        cluster, cols, rows, stream)
  if (rows <= 1) return SLSTM_CLUSTER(1);
  if (rows <= 2) return SLSTM_CLUSTER(2);
  if (rows <= 4) return SLSTM_CLUSTER(4);
  return SLSTM_CLUSTER(8);
#undef SLSTM_CLUSTER
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the four x_* and h_seq share it); r_*
// float32 [H, hb, hb].  The plan (cluster, cols, rows) comes from
// kernels/slstm.py:slstm_plan: cluster 0 takes the L2 route (hb <= 512);
// else clusters of `cluster` CTAs of `cols` columns each (cluster * cols
// >= hb > (cluster - 1) * cols) over groups of `rows` <= 8 batch rows,
// whose shared memory must fit a block.  Returns the CUDA error code of
// the launch.
extern "C" int slstm_launch(int dtype, const void* xi, const void* xf,
                            const void* xz, const void* xo, const float* ri,
                            const float* rf, const float* rz,
                            const float* ro, void* hs, int B, int S, int H,
                            int hb, int cluster, int cols, int rows,
                            void* stream) {
  if (B < 1 || S < 1 || H < 1 || hb < 1 || hb > kMaxHb || B > 65535 ||
      H > 65535 || cluster < 0 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 0) {
    const int rp = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
    if (rows < 1 || rows > 8 || cols < 1 || cols > 64 ||
        cluster * cols < hb || (cluster - 1) * cols >= hb ||
        sizeof(float) * cluster_smem_floats(hb, cols, rp) >
            static_cast<size_t>(kMaxSmem) ||
        (B + rows - 1) / rows > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(cluster, cols, rows, xi, xf, xz, xo, ri, rf, rz, ro,
                        hs, B, S, H, hb, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(cluster, cols, rows, xi, xf, xz, xo, ri, rf,
                                rz, ro, hs, B, S, H, hb, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// How many clusters of the plan's shape the card holds at once
// (cudaOccupancyMaxActiveClusters), for the plan's measurements
// (tools/profile_torch_scan.py); negative: the query's CUDA error.
extern "C" int slstm_max_active_clusters(int B, int H, int hb, int cluster,
                                         int cols, int rows) {
  const int rp = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
  cudaLaunchAttribute attr[1];
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define SLSTM_OCCUPANCY(RP)                                                 \
  if (rp == RP) {                                                           \
    err = opt_in(slstm_cluster_kernel<float, RP>);                          \
    if (err == cudaSuccess) {                                               \
      cudaLaunchConfig_t cfg = cluster_config<float, RP>(                   \
          B, H, hb, cluster, cols, rows, nullptr, attr);                    \
      err = cudaOccupancyMaxActiveClusters(                                 \
          &n, slstm_cluster_kernel<float, RP>, &cfg);                       \
    }                                                                       \
  }
  SLSTM_OCCUPANCY(1)
  SLSTM_OCCUPANCY(2)
  SLSTM_OCCUPANCY(4)
  SLSTM_OCCUPANCY(8)
#undef SLSTM_OCCUPANCY
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
