// Per-chunk lane fingerprints of raw words, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fingerprint.py:fingerprint_lanes
// (pallas_call body _fp_kernel).  For words [C, R, 128] (uint32 bits) it
// computes, for each chunk c and lane j,
//     out[c, j] = sum_r w[c, r, j] * (mix32((r + 1) * 0x9E3779B1) | 1)
// with wrapping uint32 arithmetic (csrc/fingerprint.cuh).  Modular
// addition is associative and commutative, so any reduction order gives
// the same bits as the reference.
//
// What bounds it: bytes.  The kernel reads each word once and does two
// integer operations on it.  A 4 MiB KV leaf of the paper consumer (one
// registry chunk, [1, 8192, 128] words) takes about 1.25 us at the H100
// data sheet's 3.35 TB/s; a small leaf (xlstm_350m's norm vectors, [1, 8,
// 128]) is all launch.
//
// What the design does about it: one launch, no memset before it, and no
// global atomics or second pass after it.  The TPU kernel streams a
// chunk's rows through one core as a sequential grid axis.  Here a CTA
// owns a slice of a chunk's lanes over a run of its rows, and the slices
// and runs of every chunk are CTAs of their own, chosen on the host
// (kernels/fingerprint.py:fingerprint_plan) from the shape: wide slices
// (256 bytes of each row) where there are chunks enough to fill the
// card, narrow ones (32 bytes, one memory sector of each row) where one
// chunk must spread over every SM (the 4 MiB chunk: 16 slices x 16 runs
// of 512 rows, 256 CTAs), whole rows where the work is too small to fill
// it.  `pieces` threads read a row's slice, 16 bytes each,
// with kUnroll independent loads in flight a thread; a row's weight is
// computed in registers, never loaded.  A slice's partial lanes are summed
// by warp shuffles, then the warps in shared memory; the runs of a slice
// form one thread-block cluster (up to 16 CTAs), whose CTAs push their
// lanes into the first CTA's shared memory with st.async, counted on its
// mbarrier (no cluster barrier after the loads); the first CTA adds them
// in rank order and writes the slice's lanes.  A single run is a plain
// launch with no cluster.  Each output lane is written
// once, by one thread.
//
// Why: the first port (a memset, then 32 blocks of 256 rows adding their
// lanes to the chunk's 128 words with atomicAdd) took 7.00 us a call at
// one 4 MiB chunk, 0.80 of it the memset; 256 blocks with atomicAdd took
// 7.66, 256 blocks that only stored their partials 2.13; a last-arriving
// block combining 16 to 256 partials through a ticket took 5.4 to 7.4
// (the fence, the ticket and the partials' loads are round trips to L2 in
// series after the last block's loads).  tools/csrc/fingerprint_costs.cu
// and tools/profile_torch_mlstm_fp.py, H100 80GB HBM3 at 700 W.

#include "fingerprint.cuh"

namespace {

constexpr int kUnroll = 4;  // rows in flight a thread

// words [C, R, 128] as uint4 [C, R, 32]; out [C, 128] as uint4 [C, 32].
// Grid (runs, 32 / pieces, C) in clusters of (runs, 1, 1): CTA (k, s, c)
// sums 16-byte pieces s * pieces .. + pieces - 1 of chunk c's rows
// [k * rows_per_cta, + rows_per_cta) below R; thread t reads piece
// s * pieces + t % pieces of rows r0 + t / pieces + (256 / pieces)(u + 4 it).
__global__ void __launch_bounds__(kThreads)
fingerprint_lanes_kernel(const uint4* __restrict__ words,
                         uint4* __restrict__ out, int R, int rows_per_cta,
                         int pieces) {
  __shared__ uint4 warp_lanes[kWarps][kRowQuads];
  __shared__ LaneInbox inbox;  // the first CTA's
  const uint32_t rank = cluster_rank();
  const uint32_t n_cta = cluster_ctas();
  const int c = blockIdx.z;
  const int piece = threadIdx.x % pieces;
  const int rows_per_round = kThreads / pieces;
  lanes_arm(inbox, rank, n_cta, pieces);
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(R, r0 + rows_per_cta);
  const uint4* base = words + static_cast<size_t>(c) * R * kRowQuads +
                      blockIdx.y * pieces + piece;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int r = r0 + threadIdx.x / pieces; r < r1;
       r += rows_per_round * kUnroll) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * rows_per_round;
      x[u] = rr < r1 ? __ldg(base + static_cast<size_t>(rr) * kRowQuads)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      add_weighted(acc, x[u], row_weight(r + u * rows_per_round));
  }
  // the warp's threads of each piece, then the warps and the cluster
  warp_sum_pieces(acc, pieces);
  const int lane = threadIdx.x & 31;
  if (lane < pieces) warp_lanes[threadIdx.x >> 5][lane] = acc;
  lanes_out(warp_lanes, inbox, rank, n_cta, pieces, 1, 1,
            out + static_cast<size_t>(c) * kRowQuads + blockIdx.y * pieces);
}

}  // namespace

// words: [C, R, 128] 32-bit words, 16-byte aligned; out: [C, 128].  The
// plan: slices of `pieces` 16-byte pieces of a row (a divisor of 32), each
// chunk's rows in `runs` CTAs of rows_per_cta rows (covering R), the runs
// of a slice one cluster (1..16 CTAs).  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fingerprint_lanes_launch(const void* words, void* out, int C,
                                        int R, int rows_per_cta, int runs,
                                        int pieces, void* stream) {
  if (C < 1 || C > 65535 || R < 1 || rows_per_cta < 1 || runs < 1 ||
      runs > kMaxCluster || pieces < 1 || pieces > kRowQuads ||
      kRowQuads % pieces != 0 ||
      static_cast<long long>(runs) * rows_per_cta < R)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_in_clusters(
      fingerprint_lanes_kernel, dim3(runs, kRowQuads / pieces, C), runs,
      static_cast<cudaStream_t>(stream), static_cast<const uint4*>(words),
      static_cast<uint4*>(out), R, rows_per_cta, pieces));
}
