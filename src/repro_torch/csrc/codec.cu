// Fused chunk fingerprint + delta encoding, for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/codec.py:
//   * xor_fp_lanes  (pallas_call body _xor_fp_kernel): for words
//     cur, par [C, R, 128] it writes the fingerprint lanes of cur [C, 128]
//     and the XOR words cur ^ par [C, R, 128];
//   * int8_fp_lanes (pallas_call body _int8_fp_kernel): it writes the
//     fingerprint lanes of cur and the blockwise int8 quantization of the
//     float32 delta cur - par: 256-float quant blocks (two rows each; an
//     odd R's missing last row reads as zeros), q [C, ceil(R/2), 256]
//     int8 and scale [C, ceil(R/2)] float32.
// The lane sums and their cluster combine are csrc/fingerprint.cuh's, so
// the fingerprints equal the plain fingerprint kernel's bit for bit.
//
// The quantizer is repro/optim/compression.py:_quant, to the bit:
//   d     = __fsub_rn(cur, par)           (never contracted into an FMA)
//   scale = max(__fmul_rn(max|d|, 1/127), 1e-12)   (both maxima keep NaN)
//   q     = clip(rint(__fdiv_rn(d, scale)), -127, 127), NaN -> 0
// rint rounds half to even, as jnp.round does.  A NaN scale is written as
// the quiet NaN 0x7FC00000, the NaN the reference stores for NaNs made by
// numpy or x86 arithmetic (the card's own arithmetic makes 0x7FFFFFFF).
// The build must not use --use_fast_math: its division is not IEEE.
//
// What bounds them.  Bytes, by the data sheet: each reads cur and par
// once and writes its outputs once, with a few operations a word.  At the
// paper consumer's fold shape (one 4 MiB chunk, [1, 8192, 128] words) the
// XOR kernel moves 12,583,424 bytes (3.756 us at the H100 data sheet's
// 3.35 TB/s) and the int8 kernel, which stores q as int8, 9,454,080
// bytes (2.822 us); a trainer leaf of 64 chunks of 64 KiB the same.
// Small leaves ([1, 8, 128]) are all launch.  On the card the int8
// kernel is bound by each quant block's chain of dependent steps (its
// loads, the maximum's eight steps and five shuffles, eight IEEE
// divisions, the stores): one CTA's warps working through the blocks of
// a run one after another take about 1.2 us a block, so the plans give a
// warp one block and fill the card with warps.
//
// What the design does about it: one launch a call, no memset before it
// and no fill of the outputs (kernels/codec.py allocates them with
// build.empty_written), every output word written once, no atomics.  The
// grid is flat, chosen on the host from the shape (kernels/codec.py:
// codec_plan): CTA x = (group * slices + slice) * runs + run, the runs of
// a slice one thread-block cluster of up to 16 CTAs.
//   * xor_fp_lanes takes the fingerprint kernel's design: every XOR word
//     depends on one input word, so a CTA owns a slice of a chunk's lanes
//     (`pieces` 16-byte pieces of each row) over a run of its rows, writes
//     its slice of cur ^ par and sums its partial lanes; the runs of a
//     slice push their lanes to the first CTA with st.async
//     (csrc/fingerprint.cuh).  Where a chunk is too short to keep a
//     CTA's 256 threads busy (the serving grid's 4-row chunks), a CTA
//     takes `groups` chunks, 256 / groups threads each.
//   * int8_fp_lanes cannot slice the lanes: a quant block is two whole
//     rows and its scale is the maximum over all 256 deltas.  One warp
//     owns a quant block: each thread holds 8 of its deltas, the warp
//     takes the maximum by butterfly shuffles (every lane ends with the
//     same value), and each thread writes its 8 int8 values as two 4-byte
//     stores.  A CTA owns a run of whole quant blocks of one chunk, or
//     `groups` whole short chunks (8 / groups warps each), so no quant
//     block is split between CTAs and no warp idles on the serving grid;
//     a chunk's runs form one cluster and combine their lanes as above.
//     One chunk of 4096 quant blocks (the fold's) needs more CTAs than a
//     cluster holds, so it takes the split route: q and scale from plain
//     CTAs (512 at the fold, no lanes), then the wrapper launches the
//     fingerprint kernel over cur, which is still in L2 (two device
//     entries, no combine).
// Row weights are computed in registers; every load and store of words
// is 16 bytes a thread, neighbouring threads on neighbouring addresses.
// Integer sums give the same bits in any order, so two launches give the
// same bits.
//
// Why (tools/profile_torch_codec.py on an H100 80GB HBM3 at 700 W; PERF.md
// section 6): the first port (a memset, then blocks of 16 rows, each
// adding its lanes to the chunk's 128 words with atomicAdd: 512 blocks
// and 512 atomics on each lane word at one 4 MiB chunk, then
// deterministic mode's fill of every output) took 19.7-19.9 and
// 20.2-20.3 us a call at the fold.  At the fold the int8 kernel's routes
// measured: the split route 6.9 us; clusters of 4 to 16 CTAs whose first
// CTAs added their lanes with atomics after a memset 7.1-7.2 us (512
// CTAs each adding its own, 16.7); one 16-CTA cluster 32-41 us.  Zero
// deltas (quantize): the division's range check sends a zero dividend
// down a slow path, and the fold's mostly unchanged chunk took 8.7 us a
// call dividing them, 6.9 with a branch around each division, 6.65 with
// no branch (1 divided in its place) and a block of zeros skipping its
// divisions; the branch had cost every trainer leaf about 0.2 us
// (5.15 -> 4.9 us at [64, 128, 128]).

#include "fingerprint.cuh"

namespace {

constexpr float kInv127 = 0x1.020408p-7f;       // float32(1) / float32(127)
constexpr float kScaleFloor = 0x1.197998p-40f;  // float32(1e-12)
constexpr uint32_t kQuietNaN = 0x7FC00000u;
constexpr int kQBlock = 256;  // floats of a quant block: two rows

// max that returns NaN when either side is NaN (jnp.max / jnp.maximum)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// A zero delta quantizes to 0 for every scale (0 / s is +-0 for s >= 1e-12
// or inf, NaN for a NaN s, and both give 0).  It divides 1 in its place,
// since the division's range check sends a zero dividend down its slow
// path, and selects 0 after: no branch, so the compiler interleaves a
// thread's eight divisions (the header).
__device__ __forceinline__ int8_t quantize(float d, float scale) {
  const float x = rintf(__fdiv_rn(d != 0.f ? d : 1.f, scale));
  const int8_t q =
      static_cast<int8_t>(static_cast<int>(fminf(fmaxf(x, -127.f), 127.f)));
  return d == 0.f || x != x ? 0 : q;  // XLA converts NaN to 0
}

__device__ __forceinline__ float delta(uint32_t cur, uint32_t par) {
  return __fsub_rn(__uint_as_float(cur), __uint_as_float(par));
}

__device__ __forceinline__ uint4 xor4(const uint4 a, const uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// cur, par, xr: [C, R, 128] words as uint4 [C, R, 32]; lanes [C, 32]
// uint4.  CTA x = (group * slices + slice) * runs + run; thread t of the
// CTA serves its chunk group's t / (256 / groups)-th chunk, piece
// slice * pieces + t' % pieces of rows r0 + t' / pieces + k (256 / groups
// / pieces), t' = t % (256 / groups), below the run's end.
__global__ void __launch_bounds__(kThreads)
xor_fp_kernel(const uint4* __restrict__ cur, const uint4* __restrict__ par,
              uint4* __restrict__ lanes, uint4* __restrict__ xr, int C, int R,
              int rows_per_cta, int runs, int pieces, int groups) {
  __shared__ uint4 warp_lanes[kWarps][kRowQuads];
  __shared__ LaneInbox inbox;  // the first CTA's
  const uint32_t rank = cluster_rank();
  const uint32_t n_cta = cluster_ctas();
  lanes_arm(inbox, rank, n_cta, pieces);
  const int slices = kRowQuads / pieces;
  const int run = blockIdx.x % runs;
  const int slice = blockIdx.x / runs % slices;
  const int c0 = blockIdx.x / runs / slices * groups;
  const int tpg = kThreads / groups;  // threads a chunk
  const int c = c0 + threadIdx.x / tpg;
  const int t = threadIdx.x % tpg;
  const int per_round = tpg / pieces;
  const int r0 = run * rows_per_cta;
  const int r1 = c < C ? min(R, r0 + rows_per_cta) : r0;
  const size_t base = static_cast<size_t>(c) * R * kRowQuads +
                      slice * pieces + t % pieces;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int r = r0 + t / pieces; r < r1; r += per_round) {
    const size_t i = base + static_cast<size_t>(r) * kRowQuads;
    const uint4 a = __ldg(cur + i);
    xr[i] = xor4(a, __ldg(par + i));
    add_weighted(acc, a, row_weight(r));
  }
  warp_sum_pieces(acc, pieces);
  const int lane = threadIdx.x & 31;
  if (lane < pieces) warp_lanes[threadIdx.x >> 5][lane] = acc;
  lanes_out(warp_lanes, inbox, rank, n_cta, pieces, groups,
            min(groups, C - c0),
            lanes + static_cast<size_t>(c0) * kRowQuads + slice * pieces);
}

// cur, par: [C, R, 128] words as uint4 [C, R, 32]; lanes [C, 32] uint4;
// q [C, nb, 256] int8, scale [C, nb] with nb = ceil(R / 2).  CTA x =
// group * runs + run; warp w serves its chunk group's w / (8 / groups)-th
// chunk, quant blocks run * bpc + w % (8 / groups) + k (8 / groups) below
// the run's end.  kFingerprint false (the split route): q and scale
// only.
template <bool kFingerprint>
__global__ void __launch_bounds__(kThreads)
int8_fp_kernel(const uint4* __restrict__ cur, const uint4* __restrict__ par,
               uint4* __restrict__ lanes, int8_t* __restrict__ q,
               float* __restrict__ scale, int C, int R, int bpc, int runs,
               int groups) {
  __shared__ uint4 warp_lanes[kFingerprint ? kWarps : 1][kRowQuads];
  __shared__ LaneInbox inbox;  // the first CTA's
  const uint32_t rank = cluster_rank();
  const uint32_t n_cta = cluster_ctas();
  if (kFingerprint) lanes_arm(inbox, rank, n_cta, kRowQuads);
  const int nb = (R + 1) / 2;
  const int run = blockIdx.x % runs;
  const int c0 = blockIdx.x / runs * groups;
  const int wpg = kWarps / groups;  // warps a chunk
  const int warp = threadIdx.x >> 5;
  const int quad = threadIdx.x & 31;
  const int c = c0 + warp / wpg;
  const int b0 = run * bpc;
  const int b1 = c < C ? min(nb, b0 + bpc) : b0;
  const uint4* cw = cur + static_cast<size_t>(c) * R * kRowQuads + quad;
  const uint4* pw = par + static_cast<size_t>(c) * R * kRowQuads + quad;
  int8_t* qc = q + static_cast<size_t>(c) * nb * kQBlock + 4 * quad;
  float* sc = scale + static_cast<size_t>(c) * nb;
  uint4 acc = make_uint4(0, 0, 0, 0);
  // warp-uniform: every lane of a warp takes the same blocks
  for (int b = b0 + warp % wpg; b < b1; b += wpg) {
    const size_t i = static_cast<size_t>(2 * b) * kRowQuads;
    const bool second = 2 * b + 1 < R;  // odd R: row R reads as zeros
    const uint4 c0v = __ldg(cw + i);
    const uint4 p0v = __ldg(pw + i);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const uint4 c1v = second ? __ldg(cw + i + kRowQuads) : zero;
    const uint4 p1v = second ? __ldg(pw + i + kRowQuads) : zero;
    if (kFingerprint) {
      add_weighted(acc, c0v, row_weight(2 * b));
      add_weighted(acc, c1v, row_weight(2 * b + 1));
    }
    const float d[8] = {delta(c0v.x, p0v.x), delta(c0v.y, p0v.y),
                        delta(c0v.z, p0v.z), delta(c0v.w, p0v.w),
                        delta(c1v.x, p1v.x), delta(c1v.y, p1v.y),
                        delta(c1v.z, p1v.z), delta(c1v.w, p1v.w)};
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) m = nan_max(m, fabsf(d[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = nan_max(__fmul_rn(m, kInv127), kScaleFloor);
    int8_t* qb = qc + static_cast<size_t>(b) * kQBlock;
    char4 lo = make_char4(0, 0, 0, 0), hi = lo;
    if (m != 0.f) {  // warp-uniform; an unchanged block is all zeros
      lo = make_char4(quantize(d[0], s), quantize(d[1], s), quantize(d[2], s),
                      quantize(d[3], s));
      hi = make_char4(quantize(d[4], s), quantize(d[5], s), quantize(d[6], s),
                      quantize(d[7], s));
    }
    *reinterpret_cast<char4*>(qb) = lo;
    *reinterpret_cast<char4*>(qb + kLanes) = hi;
    if (quad == 0) sc[b] = s != s ? __uint_as_float(kQuietNaN) : s;
  }
  if (!kFingerprint) return;
  warp_lanes[warp][quad] = acc;
  lanes_out(warp_lanes, inbox, rank, n_cta, kRowQuads, groups,
            min(groups, C - c0), lanes + static_cast<size_t>(c0) * kRowQuads);
}

// the grid of a plan: CTAs = runs * slices * ceil(C / groups)
bool plan_ok(int C, int R, int rows_per_cta, int runs, int pieces,
             int groups, long long* ctas) {
  if (C < 1 || R < 1 || rows_per_cta < 1 || runs < 1 || pieces < 1 ||
      pieces > kRowQuads || kRowQuads % pieces != 0 ||
      (groups != 1 && groups != 2 && groups != 4 && groups != 8) ||
      (groups > 1 && runs > 1) ||
      static_cast<long long>(runs) * rows_per_cta < R)
    return false;
  *ctas = static_cast<long long>(runs) * (kRowQuads / pieces) *
          ((C + groups - 1) / groups);
  return *ctas <= 0x7FFFFFFFLL;
}

}  // namespace

// cur, par, xr: [C, R, 128] 32-bit words, 16-byte aligned; lanes [C, 128].
// The plan (kernels/codec.py:CodecPlan): slices of `pieces` 16-byte
// pieces of a row (a divisor of 32); each chunk's rows in `runs` runs of
// rows_per_cta rows (covering R), the runs of a slice one cluster (1..16
// CTAs); `groups` chunks a CTA (1, 2, 4 or 8; more than 1 only with one
// run).  Returns the CUDA error code of the launch (0 on success).
extern "C" int xor_fp_lanes_launch(const void* cur, const void* par,
                                   void* lanes, void* xr, int C, int R,
                                   int rows_per_cta, int runs, int pieces,
                                   int groups, void* stream) {
  long long ctas;
  if (runs > kMaxCluster ||
      !plan_ok(C, R, rows_per_cta, runs, pieces, groups, &ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_in_clusters(
      xor_fp_kernel, dim3(static_cast<unsigned>(ctas)), runs,
      static_cast<cudaStream_t>(stream), static_cast<const uint4*>(cur),
      static_cast<const uint4*>(par), static_cast<uint4*>(lanes),
      static_cast<uint4*>(xr), C, R, rows_per_cta, runs, pieces, groups));
}

// cur, par: [C, R, 128] 32-bit words, 16-byte aligned; lanes [C, 128];
// q [C, ceil(R/2), 256] int8, 4-byte aligned; scale [C, ceil(R/2)].  The
// plan: each chunk's rows in `runs` runs of rows_per_cta rows (even,
// covering R) and `groups` as for xor_fp_lanes; without `split` the runs
// of a chunk are one cluster (1..16 CTAs) that writes the lanes, with it
// the runs are plain CTAs that write q and scale only (any number of
// runs) and the lanes are left to the caller.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int int8_fp_lanes_launch(const void* cur, const void* par,
                                    void* lanes, void* q, void* scale, int C,
                                    int R, int rows_per_cta, int runs,
                                    int groups, int split, void* stream) {
  long long ctas;
  if (rows_per_cta % 2 || (!split && runs > kMaxCluster) ||
      !plan_ok(C, R, rows_per_cta, runs, kRowQuads, groups, &ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_in_clusters(
      split ? int8_fp_kernel<false> : int8_fp_kernel<true>,
      dim3(static_cast<unsigned>(ctas)), split ? 1 : runs,
      static_cast<cudaStream_t>(stream), static_cast<const uint4*>(cur),
      static_cast<const uint4*>(par), static_cast<uint4*>(lanes),
      static_cast<int8_t*>(q), static_cast<float*>(scale), C, R,
      rows_per_cta / 2, runs, groups));
}
