// Chunk fingerprint arithmetic and the cluster combine of partial lanes,
// shared by csrc/fingerprint.cu and csrc/codec.cu (one definition, so the
// fused codec kernels give the same lane sums as the plain fingerprint
// kernel and combine them the same way).
//
// A chunk is [R, 128] 32-bit words; lane j of the chunk accumulates
//     sum_r word[r, j] * row_weight(r)   (mod 2^32)
// with row_weight(r) = mix32((r + 1) * 0x9E3779B1) | 1, r the row index
// inside the chunk.  Modular sums give the same bits in any order, so a
// kernel may cut a chunk's rows and lanes over CTAs and add the partial
// sums in any order: the warps of a CTA through shared memory, the CTAs
// of a thread-block cluster through the first CTA's shared memory
// (lanes_arm, lanes_out).  No kernel adds lanes with atomics: hundreds of
// CTAs adding onto the same 128 words serialize (PERF.md section 6).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"  // smem_u32 and the mbarrier helpers

namespace {

constexpr int kLanes = 128;
constexpr int kRowQuads = kLanes / 4;  // 16-byte pieces of a row
constexpr int kThreads = 256;          // every lane kernel's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // CTAs of a cluster (above 8: non-portable)
constexpr uint32_t kGold = 0x9E3779B1u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t row_weight(int r) {
  return mix32(static_cast<uint32_t>(r + 1) * kGold) | 1u;
}

// acc += x * w, lane by lane (x holds lanes 4*quad .. 4*quad+3 of a row).
__device__ __forceinline__ void add_weighted(uint4& acc, const uint4 x,
                                             uint32_t w) {
  acc.x += x.x * w;
  acc.y += x.y * w;
  acc.z += x.z * w;
  acc.w += x.w * w;
}

__device__ __forceinline__ void add4(uint4& acc, const uint4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// Sum over the lanes of a warp that hold the same piece (lane % pieces):
// afterwards lanes 0 .. pieces-1 hold the warp's sums.
__device__ __forceinline__ void warp_sum_pieces(uint4& acc, int pieces) {
  for (int o = pieces; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// The first CTA's shared memory for its peers' lanes, and its mbarrier.
struct LaneInbox {
  uint4 peer[kMaxCluster][kRowQuads];
  alignas(8) uint64_t bar;
};

// Before a kernel's loads, in every thread of a cluster of n_cta > 1 CTAs
// (a no-op for one CTA): the first CTA arms its mbarrier for `pieces`
// 16-byte lane words from each peer, and every thread arrives on the
// cluster barrier.  lanes_out waits on that barrier after the loads, so
// no peer sends to the mbarrier before it exists, and no CTA waits for
// the others before its own loads are done.
__device__ __forceinline__ void lanes_arm(LaneInbox& in, uint32_t rank,
                                          uint32_t n_cta, int pieces) {
  if (n_cta < 2) return;
  if (rank == 0 && threadIdx.x == 0) {
    mbar_init(smem_u32(&in.bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(smem_u32(&in.bar), (n_cta - 1) * pieces * 16);
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// After the loads, in every thread of the CTA.  warp_lanes[w][p] holds
// warp w's partial lanes of piece p; the warps form `groups` runs of
// kWarps / groups consecutive warps, group g summing the CTA's g-th
// chunk (groups > 1 only without a cluster).  Thread t < groups * pieces
// sums its group's warps for piece t % pieces.  In a cluster, the other
// CTAs push their sums into the first CTA's inbox with st.async, counted
// on its mbarrier, and the first CTA adds them in rank order.  The first
// CTA then writes group g's piece p to out[g * kRowQuads + p] for g below
// n_groups.  Each output word is written once, by one thread.
__device__ __forceinline__ void lanes_out(
    const uint4 (*warp_lanes)[kRowQuads], LaneInbox& in, uint32_t rank,
    uint32_t n_cta, int pieces, int groups, int n_groups, uint4* out) {
  __syncthreads();
  if (n_cta > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  const int t = threadIdx.x;
  if (t >= groups * pieces) return;
  const int g = t / pieces;
  const int p = t % pieces;
  const int wpg = kWarps / groups;
  uint4 acc = warp_lanes[g * wpg][p];
  for (int w = 1; w < wpg; ++w) add4(acc, warp_lanes[g * wpg + w][p]);
  if (rank != 0) {
    // to the first CTA's peer[rank][t], counted on its mbarrier
    uint32_t dst, dst_bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                 : "=r"(dst)
                 : "r"(smem_u32(&in.peer[rank][t])));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                 : "=r"(dst_bar)
                 : "r"(smem_u32(&in.bar)));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst),
        "r"(acc.x), "r"(acc.y), "r"(acc.z), "r"(acc.w), "r"(dst_bar)
        : "memory");
    return;
  }
  if (n_cta > 1) {
    uint32_t done = 0;
    const long long start = clock64();
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(&in.bar))
          : "memory");
      if (!done && clock64() - start > 20000000000LL) __trap();
    }
    for (uint32_t k = 1; k < n_cta; ++k) add4(acc, in.peer[k][t]);
  }
  if (g < n_groups) out[g * kRowQuads + p] = acc;
}

// Launches `kernel` on `grid` CTAs of kThreads in clusters of `cluster`
// consecutive CTAs along x (a plain launch for 1).  Returns the launch's
// CUDA error.
template <typename... Params, typename... Args>
cudaError_t launch_in_clusters(void (*kernel)(Params...), dim3 grid,
                               int cluster, cudaStream_t st, Args... args) {
  if (cluster == 1) {
    kernel<<<grid, kThreads, 0, st>>>(args...);
    return cudaGetLastError();
  }
  if (cluster > 8) {
    // clusters above 8 CTAs are allowed once per kernel
    static const void* allowed[16];
    static int n_allowed = 0;
    bool known = false;
    for (int i = 0; i < n_allowed; ++i)
      known |= allowed[i] == reinterpret_cast<const void*>(kernel);
    if (!known) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      if (n_allowed < 16)
        allowed[n_allowed++] = reinterpret_cast<const void*>(kernel);
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
