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
// Hkv=1, D=256, bf16) it is 1 MiB per layer, about 0.31 us.  At these
// sizes a call is as short as a launch, so what a call costs is mostly
// how many device entries it makes and how long their dependent steps
// are.
//
// What the design does about it: one launch, no workspace in device
// memory.  The TPU kernel walks the sequence as a sequential grid axis
// on one core; here the keys of one (batch row, kv head, tile of query
// heads) are split over a thread-block cluster (the plan in
// kernels/decode_attention.py:decode_plan picks its size, up to 8 CTAs,
// from the shape alone).  Each CTA takes a contiguous run of keys and
// each of its 8 warps a contiguous sub-run.
//  * Loads.  A key row is read by LPK lanes with 16-byte loads (`vec`
//    elements a lane: 4 float32 or 8 bf16), so a warp has 32 / LPK keys
//    in flight a load, and a few loads (R) of one lane are issued before
//    any is used: D 32 float32 is 8 lanes a key and 4 keys a load, D 256
//    bf16 is 32 lanes a key.  A head dim whose rows are not a multiple of
//    16 bytes is read one element a lane.  The loads are branch-free:
//    their addresses are clamped to valid rows and columns, and what is
//    read for nothing is zeroed or never used, so a lane's loads are all
//    in flight before the first is used.
//  * Masks.  A warp reads the k_pos of 32 keys at once (the next 32 are in
//    flight while it works on these) and turns them into a ballot mask;
//    the valid slots are compacted, in slot order, into a list in shared
//    memory, and the warp's lanes read only those: a masked slot's K/V row
//    is never read, and a ring whose slots are mostly masked costs as few
//    loads as it has valid slots.
//  * Heads.  The query heads of a kv head go in tiles of 1 to 5, one
//    cluster a tile: a tile scores all its heads against one read of each
//    key (GQA reuse), and more tiles re-read the keys (from L2) but give
//    each warp less to do.  The plan takes the tiling whose warps score
//    the fewest (key, head) pairs within one wave of CTAs.
//  * Scores and softmax.  Each key's dot product with every query head of
//    the tile is summed
//    over its LPK lanes by butterflies, so every lane of the key sees the
//    same bits.  Each group of LPK lanes then keeps its own online softmax
//    (m, l, acc) over the keys it reads, one max update per R keys.
//  * Combining, in a fixed order and with no atomics: the lane groups of
//    a warp by butterflies; the warps of a CTA in warp order through
//    shared memory; the CTAs of the cluster in rank order through
//    distributed shared memory (cluster.map_shared_rank, barrier.cluster).
//    The final combine reads every rank's partial; its (head, column)
//    outputs are spread over the cluster's CTAs, each output summed over
//    the ranks in rank order.  A second cluster barrier keeps every CTA's
//    shared memory alive until those reads are done.  The plan and the
//    order are pure functions of the shape, so every launch gives the same
//    bits, which replay's bit-exact verification needs.
//
// Masked scores are NEG_INF = -0.7 * FLT_MAX, as in the reference, not
// -inf.  A masked slot would add exp(NEG_INF - m) = 0 once m is a real
// score, so skipping it changes nothing, and a lane group, warp or CTA
// whose keys are all masked ends with (m, l, acc) = (NEG_INF, 0, 0),
// which the combine weighs by exp(NEG_INF - M) = 0.  A partial with a
// valid slot ends with l >= 1, so the combined L is 0 exactly when the
// (batch row, kv head) has no valid slot at all.  There every score of
// the reference is NEG_INF and its softmax is uniform: the kernel then
// returns the mean of V over all S slots, sum_s (1/S) * v[s] in slot
// order with 1/S rounded to the cache type, as the plain version
// computes it.  The model never asks for that (attn_decode writes the
// current slot before attention), so that slow loop costs nothing on the
// main path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -0x1.666664p+127f;  // float32(-0.7 * FLT_MAX)
constexpr int kWarps = 8;                     // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxHeads = 5;                  // query heads per tile
constexpr int kMaxCluster = 8;                // CTAs per cluster (portable)

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

// VEC consecutive elements of a row, widened to float32: one 16-byte load
// for VEC 4 (float32) or 8 (bf16)
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float* x);
template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p, float* x) {
  x[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float* x) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* x) {
  x[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* x) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// One cluster per (batch row, kv head, tile of query heads): grid
// (cluster, B * Hkv, head tiles), cluster (cluster, 1, 1).
// q [B, H, D]; k, v [B, S, Hkv, D]; q_pos [B]; k_pos [B, S]; out [B, H, D].
// A lane holds NV runs of VEC columns: column (sl + j * LPK) * VEC + e for
// sub-lane sl = lane % LPK; lanes lane / LPK read different keys.  R = loads
// of one lane in flight before the first is used.  Every loop over heads,
// keys and shuffle steps has a compile-time trip count, so the compiler
// interleaves the keys' and heads' shuffle chains.  GM = heads of the
// tile (the plan's heads_per_tile); in the last tile, heads past the
// query group are computed on q = 0 and not stored, so no branch splits
// the heads.
template <typename T, int VEC, int NV, int R, int LPK, int GM>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int32_t* __restrict__ q_pos,
                      const int32_t* __restrict__ k_pos, T* __restrict__ out,
                      int S, int H, int Hkv, int D, int keys_per_warp,
                      int heads_per_tile, float scale) {
  constexpr int CPL = VEC * NV;  // columns a lane holds
  constexpr int kpl = 32 / LPK;  // keys a load
  extern __shared__ float smem[];
  const int G = heads_per_tile;
  // per warp: acc [G][D], then (m, l) [G][2]; then the CTA's own partial;
  // then each warp's list of valid slots [32]; then the ranks' weights
  // [kMaxCluster][G] and the cluster's sums [G]
  float* w_acc = smem;
  float* w_ml = w_acc + kWarps * G * D;
  float* c_acc = w_ml + kWarps * G * 2;
  float* c_ml = c_acc + G * D;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y % Hkv;
  const int g = H / Hkv;
  const int hq = kvh * g + blockIdx.z * G;  // this tile's first query head
  const int gt = min(G, g - static_cast<int>(blockIdx.z) * G);  // its heads
  const int kg = lane / LPK;
  const int sl = lane % LPK;
  const int qp = q_pos[b];
  const int w0 = min(S, (rank * kWarps + warp) * keys_per_warp);
  const int w1 = min(S, w0 + keys_per_warp);
  int* const slot_lists = reinterpret_cast<int*>(c_ml + G * 2);
  int* const slots = slot_lists + warp * 32;
  float* const r_w = reinterpret_cast<float*>(slot_lists + kWarps * 32);
  // the first 32 k_pos of this warp, in flight while q is read
  int kp = w0 + lane < w1 ? k_pos[static_cast<size_t>(b) * S + w0 + lane]
                          : -1;

  // Loads are branch-free, so that a lane's loads are all in flight before
  // the first is used: a column past D reads column 0 and a head past the
  // tile reads head 0, and both are zeroed after the load.
  float qr[GM][CPL], acc[GM][CPL], m[GM], l[GM];
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    const T* qh = q + (static_cast<size_t>(b) * H + hq + (h < gt ? h : 0)) * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int d = (sl + j * LPK) * VEC;
      load_row<T, VEC>(qh + (d < D ? d : 0), &qr[h][j * VEC]);
    }
  }
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = (sl + j * LPK) * VEC + e;
        // q * scale in float32, rounded to the cache type (the reference
        // contracts in the cache's type with float32 accumulation)
        const float x = qr[h][j * VEC + e];
        qr[h][j * VEC + e] =
            h < gt && d < D ? to_f32(from_f32<T>(x * scale)) : 0.f;
        acc[h][j * VEC + e] = 0.f;
      }
    }
  }

  for (int base = w0; base < w1; base += 32) {
    const bool ok_lane = kp >= 0 && kp <= qp;
    const unsigned valid = __ballot_sync(0xffffffffu, ok_lane);
    const int n_valid = __popc(valid);
    if (ok_lane) slots[__popc(valid & ((1u << lane) - 1u))] = base + lane;
    __syncwarp();
    const int next = base + 32 + lane;
    kp = next < w1 ? k_pos[static_cast<size_t>(b) * S + next] : -1;
    for (int i0 = 0; i0 < n_valid; i0 += kpl * R) {
      // a lane group past the valid slots reads the first valid slot's
      // row (its score is never used); columns past D read column 0 (q is
      // 0 there, and those columns of acc are never stored)
      float kr[R][CPL], vr[R][CPL];
      bool ok[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int idx = i0 + i * kpl + kg;
        ok[i] = idx < n_valid;
        const size_t row =
            ((static_cast<size_t>(b) * S + slots[ok[i] ? idx : 0]) * Hkv +
             kvh) * D;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int d = (sl + j * LPK) * VEC;
          load_row<T, VEC>(k + row + (d < D ? d : 0), &kr[i][j * VEC]);
          load_row<T, VEC>(v + row + (d < D ? d : 0), &vr[i][j * VEC]);
        }
      }
#pragma unroll
      for (int h = 0; h < GM; ++h) {
        float sc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) dot = fmaf(qr[h][c], kr[i][c], dot);
          // butterfly within the key's lanes: each lane ends with the same
          // bits (a + b == b + a)
#pragma unroll
          for (int off = LPK >> 1; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          sc[i] = dot;
        }
        float mx = m[h];
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (ok[i]) mx = fmaxf(mx, sc[i]);
        const float corr = expf(m[h] - mx);
        float lsum = l[h] * corr;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[h][c] *= corr;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = ok[i] ? expf(sc[i] - mx) : 0.f;
          lsum += p;
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            acc[h][c] = fmaf(p, vr[i][c], acc[h][c]);
        }
        l[h] = lsum;
        m[h] = mx;
      }
    }
    __syncwarp();  // the list is read before the next block rewrites it
  }

  // lane groups of the warp, by butterflies in a fixed tree
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float M = fmaxf(m[h], mo);
      const float ca = expf(m[h] - M);
      const float cb = expf(mo - M);
      l[h] = l[h] * ca + lo * cb;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[h][c], off);
        acc[h][c] = acc[h][c] * ca + ao * cb;
      }
      m[h] = M;
    }
  }
  if (kg == 0) {  // lanes 0 .. LPK - 1 hold the warp's partial
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      if (h < gt) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int d = (sl + j * LPK) * VEC + e;
            if (d < D) w_acc[(warp * G + h) * D + d] = acc[h][j * VEC + e];
          }
        }
        if (lane == 0) {
          w_ml[(warp * G + h) * 2] = m[h];
          w_ml[(warp * G + h) * 2 + 1] = l[h];
        }
      }
    }
  }
  __syncthreads();

  // the CTA's warps, in warp order: each warp's weight exp(m - M), once a
  // head (it replaces the warp's m), then every column
  if (tid < gt) {
    const int h = tid;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_ml[(w * G + h) * 2]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(w_ml[(w * G + h) * 2] - M);
      w_ml[(w * G + h) * 2] = c;
      L += w_ml[(w * G + h) * 2 + 1] * c;
    }
    c_ml[2 * h] = M;
    c_ml[2 * h + 1] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < gt * D; idx += kThreads) {
    const int h = idx / D;
    const int d = idx - h * D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      A += w_acc[(w * G + h) * D + d] * w_ml[(w * G + h) * 2];
    c_acc[h * D + d] = A;
  }
  cluster.sync();  // every CTA's partial is written and visible

  // the cluster's CTAs, in rank order: each rank's weight exp(M_r - M), once
  // a head in every CTA, then the outputs, spread over the CTAs
  if (tid < gt) {
    const int h = tid;
    float mr[kMaxCluster], lr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const float* ml = cluster.map_shared_rank(c_ml, r < n_cta ? r : 0);
      mr[r] = ml[2 * h];
      lr[r] = ml[2 * h + 1];
    }
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_cta) M = fmaxf(M, mr[r]);
    float L = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < n_cta) {
        const float c = expf(mr[r] - M);
        r_w[r * G + h] = c;
        L += lr[r] * c;
      }
    }
    r_w[kMaxCluster * G + h] = L;
  }
  __syncthreads();
  for (int idx = rank * kThreads + tid; idx < gt * D;
       idx += n_cta * kThreads) {
    const int h = idx / D;
    const int d = idx - h * D;
    float A = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_cta)
        A += cluster.map_shared_rank(c_acc, r)[h * D + d] * r_w[r * G + h];
    const float L = r_w[kMaxCluster * G + h];
    T* dst = out + (static_cast<size_t>(b) * H + hq + h) * D + d;
    if (L == 0.f) {  // no valid slot: uniform softmax, the mean of V
      const float p = to_f32(from_f32<T>(1.f / static_cast<float>(S)));
      float V = 0.f;
      for (int s = 0; s < S; ++s)
        V = fmaf(p,
                 to_f32(v[((static_cast<size_t>(b) * S + s) * Hkv + kvh) * D +
                          d]),
                 V);
      *dst = from_f32<T>(V);
    } else {
      *dst = from_f32<T>(A / fmaxf(L, 1e-37f));
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its partial
}

template <typename T, int VEC, int NV, int R, int LPK, int GM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* q_pos, const int32_t* k_pos, void* out,
                   int B, int S, int H, int Hkv, int D, int cluster,
                   int keys_per_warp, int heads_per_tile, int n_tiles,
                   float scale, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B * Hkv, n_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      sizeof(float) * (kWarps + 1) * heads_per_tile * (D + 2) +
      sizeof(int) * kWarps * 32 +
      sizeof(float) * (kMaxCluster + 1) * heads_per_tile;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, decode_cluster_kernel<T, VEC, NV, R, LPK, GM>,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(out), S, H, Hkv,
      D, keys_per_warp, heads_per_tile, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  The plan
// (cluster, keys_per_warp, heads_per_tile, n_tiles, lanes_per_key, vec)
// comes from kernels/decode_attention.py:decode_plan; a plan that does not
// cover the cache or the heads, or a vec the dtype and D do not allow, is
// refused.  Returns the CUDA error code of the launch (0 on success).
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const int32_t* q_pos, const int32_t* k_pos, void* out, int B, int S,
    int H, int Hkv, int D, int cluster, int keys_per_warp,
    int heads_per_tile, int n_tiles, int lanes_per_key, int vec, float scale,
    void* stream) {
  const int g = Hkv > 0 ? H / Hkv : 0;
  const int lpk = lanes_per_key;
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > kMaxHeadDim || B * Hkv > 65535 || cluster < 1 ||
      cluster > kMaxCluster || keys_per_warp < 1 ||
      static_cast<long long>(cluster) * kWarps * keys_per_warp < S ||
      heads_per_tile < 1 || heads_per_tile > kMaxHeads ||
      heads_per_tile * n_tiles < g || lpk < 1 || lpk > 32 ||
      (lpk & (lpk - 1)) != 0 || D % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = lpk * vec;  // columns one run of the key's lanes covers
#define DECODE_LAUNCH(T, VEC, NV, R, LPK, GM)                             \
  launch<T, VEC, NV, R, LPK, GM>(q, k, v, q_pos, k_pos, out, B, S, H, Hkv, \
                                 D, cluster, keys_per_warp, heads_per_tile, \
                                 n_tiles, scale, st)
// up to 2 heads a tile, twice the loads in flight: the registers that
// more heads would take
#define DECODE_HEADS(T, VEC, NV, R, LPK)                             \
  switch (heads_per_tile) {                                          \
    case 1: err = DECODE_LAUNCH(T, VEC, NV, 2 * R, LPK, 1); break;   \
    case 2: err = DECODE_LAUNCH(T, VEC, NV, 2 * R, LPK, 2); break;   \
    case 3: err = DECODE_LAUNCH(T, VEC, NV, R, LPK, 3); break;       \
    case 4: err = DECODE_LAUNCH(T, VEC, NV, R, LPK, 4); break;       \
    default: err = DECODE_LAUNCH(T, VEC, NV, R, LPK, 5); break;      \
  }
#define DECODE_LANES(T, VEC, R)                   \
  switch (lpk) {                                  \
    case 4: DECODE_HEADS(T, VEC, 1, R, 4) break;  \
    case 8: DECODE_HEADS(T, VEC, 1, R, 8) break;  \
    case 16: DECODE_HEADS(T, VEC, 1, R, 16) break; \
    default: DECODE_HEADS(T, VEC, 1, R, 32) break; \
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4 && lpk >= 4 && D <= cols) {
    DECODE_LANES(float, 4, 8)
  } else if (dtype == 0 && vec == 4 && lpk == 32 && D <= 2 * cols) {
    DECODE_HEADS(float, 4, 2, 4, 32)
  } else if (dtype == 0 && vec == 1 && lpk == 32) {
    DECODE_HEADS(float, 1, 8, 2, 32)
  } else if (dtype == 1 && vec == 8 && lpk >= 4 && D <= cols) {
    DECODE_LANES(__nv_bfloat16, 8, 4)
  } else if (dtype == 1 && vec == 1 && lpk == 32) {
    DECODE_HEADS(__nv_bfloat16, 1, 8, 2, 32)
  }
#undef DECODE_LANES
#undef DECODE_HEADS
#undef DECODE_LAUNCH
  return static_cast<int>(err);
}
