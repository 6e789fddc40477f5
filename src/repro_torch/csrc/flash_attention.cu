// Train/prefill GQA attention with causal and local-window masks, for
// sm_90a.  Two routes, both on the tensor cores, chosen by the wrapper
// from (dtype, D) alone:
//
//   * bf16 with D % 16 == 0 (every bf16 head dim the models use: 64 for
//     smollm_360m, 256 for recurrentgemma_2b): flash_wgmma_kernel, bf16
//     products (wgmma) with K/V tiles brought in by TMA;
//   * float32, and bf16 with another D: flash_tf32x3_kernel, "3 x TF32".
//     One TF32 product rounds each float32 input to a 10-bit mantissa,
//     which is exactly the error the paper consumer's card-vs-CPU training
//     check must catch; so each operand x is held as hi = tf32(x) and lo =
//     tf32(x - hi) (round to nearest, ties away), and each product is
//     lo.hi + hi.lo + hi.hi into a float32 accumulator: about 22 bits of
//     each input, within the float32 check of the plain version where one
//     TF32 product misses it by 20-170x.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (pallas_call body _attn_kernel).  Same function: s = q.k^T in float32,
// scaled by sm_scale, the mask keeps key j for query i
// where i >= j (causal) and i - j < window (window > 0), masked scores are
// NEG_INF = -0.7 * FLT_MAX (finite, never -inf), the online softmax runs
// in float32 with (acc, m, l) per query row, and the output is
// acc / max(l, 1e-37) in q's dtype.  sm_scale comes from the wrapper:
// 1/sqrt(D) rounded in float32 (ref.attn_scale), as the plain version
// scales; the TPU kernel rounds 1/sqrt(D) from double, at most one ulp
// away.  The tf32x3 route scales q before the product, as the plain
// version does; the wgmma route multiplies the float32 score after it
// (s = sm_scale * (q.k)), one rounding away from the plain version.
//
// What bounds it: at the training shapes, bytes on paper and neither in
// practice.  smollm_360m's layer (q [8,128,15,64], k/v [8,128,5,64],
// bf16, causal) moves 5.2 MB (1.6 us at 3.35 TB/s) and does about 252
// MFLOP of causal work (0.25 us on the bf16 tensor cores); at
// recurrentgemma_2b's 2304-token prefill ([2,2304,10,256] over one kv
// head, window 2048) the work is 54 GFLOP, 54 us on the tensor cores:
// operations.  The float32 training shapes are smaller still (the paper
// consumer's [8,128,8,32] causal: 3 MB and 68 MFLOP, 1 us even on the
// float32 pipes): a call is a chain of dependent steps per CTA, and the
// tf32x3 route's design is about shortening it.
//
// The wgmma route (flash_wgmma_kernel).  One CTA per (64 query rows, query
// head, batch row): one warpgroup of 4 warps, 16 rows a warp, which is
// wgmma's M of 64.  Not two warpgroups over 128 rows: at D 256 the output
// accumulator alone is 128 floats a thread, and at the serving prefill
// (Sq 32) or the smollm train shape (Sq 128: 240 CTAs of 64 rows on 132
// SMs) a 128-row tile would leave SMs idle.
//  * Tiles.  Q [64 x D] is loaded once and K, V [64 keys x D] per kv tile,
//    all by TMA through 4-D tensor maps over the [B, S, H, D] tensors as
//    they are, in boxes of 64 columns (128 bytes of bf16) with the
//    128-byte swizzle: D 256 is four boxes, D <= 64 one box whose columns
//    past D the TMA zero-fills without reading them.  One layout serves
//    every D % 16 == 0 (48 and 80 too, which no narrower swizzle fits); at
//    D 16 and 32 it costs shared memory and products on zero columns, not
//    bytes from device memory, and no model runs bf16 at those widths.
//    A ragged tile is
//    zero-filled within its batch row (the map's S dimension ends there),
//    so nothing of the next row is read, and nothing is transposed.  The
//    maps are encoded on the host in the launch function
//    (csrc/hopper.cuh: cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint, since the library links no libcuda) and
//    passed as __grid_constant__ params.
//  * Ring.  K and V tiles go into stages with one mbarrier each for K and
//    for V (expect_tx of the tile's bytes): 2 stages up to D 192, one at
//    D 256, where a CTA then takes 99 KB and two CTAs share an SM (one's
//    softmax runs while the other's products use the tensor cores).
//    Thread 0 is the producer: it refills a stage's K once every warp has
//    computed S from it, and its V once every warp is past P.V, so the
//    next tile's K lands during this tile's softmax and P.V.
//  * S = Q.K^T: wgmma m64n64k16, bf16 x bf16 into float32, both operands
//    K-major in shared memory, 4 steps a box (columns past D are zero and
//    add nothing).
//  * Online softmax on the accumulator fragments in registers: a thread
//    holds 16 scores of each of two rows, and the row max needs shuffles
//    only among the 4 threads that share a row.  The row sum l is kept
//    per thread (each thread's share of the row; the four share m and the
//    correction) and summed over the four at the end.
//  * O += P.V: wgmma m64n64k16 per 64-column box of V, with P from
//    registers as the A operand (the score fragment is already in A's
//    layout) and V as an MN-major B operand.  P is split into P_hi =
//    bf16(P) and P_lo = bf16(P - P_hi), two wgmma into the same
//    accumulator: P keeps about 16 bits, not 8 (rounding every softmax
//    weight to bf16 would add about 2^-9 relative error per weight to a
//    bf16 logits check that has less than 2x room).  V's columns past D
//    are zero, and so are those of the product: they are not stored.
//  * Output: acc times one reciprocal of max(l, 1e-37) a row (one rounding
//    away from a division an element); rows past Sq (the serving
//    prefill has Sq 32 in a 64-row tile) are masked at the store.
//
// The tf32x3 route (flash_tf32x3_kernel).  One CTA per (64 query rows,
// query head, batch row), as on the wgmma route; its tiles are sized by
// a plan that depends on D alone (tf_groups, tf_keys, tf_prefetch;
// kernels/flash_attention.py:flash_f32_plan mirrors it).
//  * Two warpgroups up to D 128.  At the float32 paths' shapes a CTA
//    walks one to four kv tiles, each a chain of loads, S, softmax and
//    P.V with one warp to a scheduler; so warpgroup g takes tiles t_lo +
//    g, t_lo + g + 2, ..., each with its own K/V^T buffers and its own
//    (m, l, o), and warpgroup 0 merges the two at the end (both rescaled
//    to the larger m).  Above D 128 the output accumulator alone is up to
//    128 registers a thread, and one warpgroup walks every tile.
//  * Tiles.  Q [64 x D] is loaded once by every thread, scaled in
//    float32, split into hi and lo and stored K-major, 128-byte swizzled,
//    in 32-column boxes (128 bytes of float32); columns past D are zero.
//    K and V^T come in per kv tile of 32 keys (16 at D 256, where Q's hi
//    and lo alone take 128 KB: 230,400 bytes a CTA), loaded by the
//    threads as 4-byte values (a warp reads a row's 128 contiguous
//    bytes), split, and stored: K K-major as it lies, V transposed (tf32
//    wgmma takes only K-major operands, so V^T [D x keys]).  Up to D 128
//    the next tile's loads are issued into registers before this tile's
//    products and stored after them; above, two rows at a time.  TMA is
//    not used: every element passes through a thread for its split.
//  * S = Q.K^T: wgmma m64nNk8 .tf32 (N = the tile's keys), both operands
//    from shared memory, three passes of 4 steps a box: lo.hi, hi.lo,
//    then hi.hi, the small terms first, each box into a fresh float32
//    accumulator and the boxes summed on the CUDA cores (see P.V below
//    for why).
//  * Online softmax as on the wgmma route; a row's kept keys are one
//    range [lo, hi] computed once, so a masked tile costs two compares
//    an element.
//  * O += P.V: wgmma m64n32k8 .tf32 per 32-column piece of D, P from
//    registers (hi and lo), V^T from shared memory, the same three
//    passes, into an accumulator that starts at 0 each tile; o = o * corr
//    + that tile's sum is then taken on the CUDA cores.  The tensor
//    cores' float32 accumulation truncates: one accumulator carried
//    through every tile drifted the output toward zero by 1.3e-5 of
//    itself at whisper's encoder (1500 keys; a CPU emulation that
//    truncates each k-step's sum, and the card's 3e-6 to 6e-6 errors and
//    whisper's float32 gradient gate, agreed), 2.8e-7 with the fresh
//    accumulator.
//    tf32's A fragment holds columns c and c + 4 of a step's 8
//    where the score fragment holds 2c and 2c + 1, so V^T stores the keys
//    of each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 and P's
//    fragment is the score registers reordered: the sum over keys is
//    permuted, the same way at every shape.
//  * Output: acc / max(l, 1e-37), a division per element as the first
//    float32 kernel divided; a thread's two neighbouring columns in one
//    store where D is even.
//
// Both routes: GQA and MQA need nothing of their own (a block reads kv
// head h / (H / Hkv)); tiles wholly above the diagonal or wholly before
// the window are skipped, as the TPU kernel's `run` predicate does.  No
// atomics and a fixed walk: the sums' order is a pure function of the
// shape, so two launches give the same bits (replay's bit-exact
// verification needs that).
//
// Masking subtleties (both routes; on the tf32x3 route also in each
// warpgroup's own state, which the merge weighs by exp(m - max m)):
//  * A row's first processed tile can be entirely masked (a window band
//    that starts inside the tile).  m then stays NEG_INF, every p is
//    exp(0) = 1 and l, acc gather garbage; the next tile with a real
//    score has corr = exp(NEG_INF - m) = 0, which wipes them, as in the
//    reference.  Nothing here is ever -inf, so no NaN can arise.
//  * Keys past Sk (a ragged last tile) are out of the function: their
//    p is 0 and their K/V rows are zero-filled.
//  * A row with no valid key at all (window > 0 and Sq > Sk) gets the
//    reference's uniform softmax over all Sk keys: a q tile holding such
//    a row walks every kv tile.
//  * No fast-math: expf, not __expf, to stay near the plain version.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

constexpr float kNegInf = -0x1.666664p+127f;  // float32(-0.7 * FLT_MAX)
constexpr int kMaxHeadDim = 256;

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

// ---------------------------------------------------------------------------
// The wgmma route: bf16, D % 16 == 0.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;   // query rows per CTA: wgmma's M
constexpr int kWgKeys = 64;   // keys per kv tile: the N of S = Q.K^T
constexpr int kBoxCols = 64;  // head-dim columns per TMA box (128 bytes)
constexpr uint32_t kBoxBytes = 64 * 128;  // one [64 rows x 64 cols] box
constexpr int kWgThreads = 128;

// K/V ring depth: 2 stages up to D 192; at D 256 one stage, so that a CTA
// takes 99 KB of shared memory and two CTAs share an SM (one's softmax
// runs while the other's products use the tensor cores)
__host__ __device__ constexpr int wg_stages(int nb) { return nb == 4 ? 1 : 2; }

// shared memory of a CTA: 1 KB of slack to align the tiles to the
// 128-byte swizzle's 1024-byte period, Q (NB boxes), then per stage K and
// V (NB boxes each)
__host__ __device__ constexpr int wg_smem_bytes(int nb) {
  return 1024 + static_cast<int>(kBoxBytes) * nb * (1 + 2 * wg_stages(nb));
}

// K or V of kv tile t (NB boxes) into shared memory at dst, on one barrier
template <int NB>
__device__ __forceinline__ void issue_tile(const CUtensorMap* map,
                                           uint32_t bar, uint32_t dst,
                                           int kvh, int t, int b) {
  mbar_expect_tx(bar, NB * kBoxBytes);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    tma_load(dst + j * kBoxBytes, map, bar, j * kBoxCols, kvh, t * kWgKeys,
             b);
}

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D] bf16 through their maps; out
// [B, Sq, H, D] bf16.  NB = 64-column boxes covering D.
//
// Fragment layout (wgmma's accumulator): thread `lane` of warp w holds, for
// each 8-column block i of a 64-wide product, d[4i + e] at row
// 16w + lane / 4 + 8 * (e / 2) and column 8i + 2 * (lane % 4) + e % 2.
template <int NB>
__global__ void __launch_bounds__(kWgThreads, NB == 4 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int Hkv, int D, int causal, int window, float scale) {
  constexpr int kStages = wg_stages(NB);
  extern __shared__ uint8_t smem_raw[];
  // Q, then K and V of each stage: each on its own barrier, so that K's
  // stage is refilled as soon as S is computed, while P.V still reads V
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t tile_bytes = kBoxBytes * NB;
  const uint32_t bar_q = smem_u32(&bars[0]);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q_last = min(q0 + kWgRows, Sq) - 1;

  // kv tiles to walk: those holding a key that some row of the tile keeps
  const int nk = (Sk + kWgKeys - 1) / kWgKeys;
  int t_lo = 0;
  int t_hi = nk;
  const bool empty_row = window > 0 && q_last - (Sk - 1) >= window;
  if (!empty_row) {
    if (causal) t_hi = min(nk, q_last / kWgKeys + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / kWgKeys;
  }

  // stage s: K at q_s + tile_bytes * (1 + 2s) on bars[1 + 2s], V right
  // after it on bars[2 + 2s]
  if (tid == 0) {
    for (const CUtensorMap* map : {&qmap, &kmap, &vmap})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, tile_bytes);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(q_s + j * kBoxBytes, &qmap, bar_q, j * kBoxCols, h, q0, b);
    for (int i = 0; i < kStages && t_lo + i < t_hi; ++i) {
      const uint32_t k_s = q_s + tile_bytes * (1 + 2 * i);
      issue_tile<NB>(&kmap, smem_u32(&bars[1 + 2 * i]), k_s, kvh, t_lo + i,
                     b);
      issue_tile<NB>(&vmap, smem_u32(&bars[2 + 2 * i]), k_s + tile_bytes,
                     kvh, t_lo + i, b);
    }
  }

  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  float o[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int s = it % kStages;
    const uint32_t k_s = q_s + tile_bytes * (1 + 2 * s);
    const uint32_t v_s = k_s + tile_bytes;
    const uint32_t parity = (it / kStages) & 1;
    mbar_wait(smem_u32(&bars[1 + 2 * s]), parity);
    __syncwarp();

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
    // all 4 * NB steps: Q's and K's columns past D are zero-filled, and
    // adding their zero products leaves every sum as it is
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss(sc, smem_desc(q_s + off, 16, 1024),
               smem_desc(k_s + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    __syncthreads();  // every warp is done reading K of stage s
    if (tid == 0 && t + kStages < t_hi)
      issue_tile<NB>(&kmap, smem_u32(&bars[1 + 2 * s]), k_s, kvh,
                     t + kStages, b);

    // scale, mask, row max
    const int k0 = t * kWgKeys;
    const bool interior = k0 + kWgKeys <= Sk &&
                          (!causal || k0 + kWgKeys - 1 <= q0) &&
                          (window <= 0 || q0 + kWgRows - 1 - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col0 + (e & 1);
        const int qp = row0 + 8 * (e >> 1);
        float x = sc[4 * i + e] * scale;
        if (!interior) {
          const bool ok = key < Sk && (!causal || qp >= key) &&
                          (window <= 0 || qp - key < window);
          x = ok ? x : kNegInf;
        }
        sc[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col0 + (e & 1);
        const float p = key < Sk ? expf(sc[4 * i + e] - m[e >> 1]) : 0.f;
        sc[4 * i + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= corr[(i >> 1) & 1];

    // P as wgmma's A fragment for key step kk (keys 16kk .. 16kk + 15):
    // register r holds columns of block 2kk + r / 2, row half r % 2
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 2 * kk + (r >> 1);
        const int e = 2 * (r & 1);
        const float a = sc[4 * i + e];
        const float c = sc[4 * i + e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][r] = bf16x2_bits(hi);
        pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(o[j]);
    mbar_wait(smem_u32(&bars[2 + 2 * s]), parity);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = smem_desc(v_s + j * kBoxBytes + kk * 2048, 1024,
                                      1024);
        wgmma_rs(o[j], ph[kk], dv);
        wgmma_rs(o[j], pl[kk], dv);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(o[j]);

    __syncthreads();  // every warp is done reading V of stage s
    if (tid == 0 && t + kStages < t_hi)
      issue_tile<NB>(&vmap, smem_u32(&bars[2 + 2 * s]), v_s, kvh,
                     t + kStages, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-37f);  // one division a row
    __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = kBoxCols * j + 8 * i + col0;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o[j][4 * i + 2 * r] * inv,
                                    o[j][4 * i + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// a 4-D map over a contiguous bf16 [batch, seq, heads, D] tensor, boxes of
// 64 columns x 1 head x 64 rows x 1 batch row, 128-byte swizzle; reads
// past D or past seq are zero-filled
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D,
                int heads, int seq, int batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBoxCols, 1, kWgRows, 1};
  return encode_bf16_map(fn, map, ptr, 4, dims, strides, box);
}

template <int NB>
cudaError_t launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km,
                         const CUtensorMap& vm, void* out, int B, int Sq,
                         int Sk, int H, int Hkv, int D, int causal,
                         int window, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg_smem_bytes(NB));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + kWgRows - 1) / kWgRows, H, B);
  flash_wgmma_kernel<NB><<<grid, kWgThreads, wg_smem_bytes(NB), stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tf32x3 route: float32, and bf16 with D % 16 != 0.
// ---------------------------------------------------------------------------

constexpr int kTfRows = 64;  // query rows per CTA: wgmma's M

// The plan (mirrored by flash_attention.py:flash_f32_plan): D padded to
// `cols` = NB 32-column boxes in shared memory (128 bytes of float32, the
// 128-byte swizzle's row); warpgroups a CTA (two up to D 128, taking kv
// tiles in turn, each with its own K and V^T buffers and its own softmax
// state, merged at the end); keys per kv tile; whether the next tile's K
// and V wait in registers while this tile's products run.  V^T's rows
// hold max(keys, 32) key slots (a whole swizzle row).
__host__ __device__ constexpr int tf_groups(int cols) {
  return cols <= 128 ? 2 : 1;
}
__host__ __device__ constexpr int tf_keys(int cols) {
  return cols <= 224 ? 32 : 16;
}
__host__ __device__ constexpr bool tf_prefetch(int cols) { return cols <= 128; }
__host__ __device__ constexpr int tf_vt_keys(int cols) {
  return tf_keys(cols) < 32 ? 32 : tf_keys(cols);
}
// 1 KB of slack to align to the swizzle's 1024-byte period, then hi and lo
// of Q [64 x cols], and of each warpgroup's K [keys x cols] and V^T
// [cols x vt_keys]
__host__ __device__ constexpr int tf_smem_bytes(int cols) {
  return 1024 + 2 * 4 * (kTfRows * cols +
                         tf_groups(cols) * (tf_keys(cols) * cols +
                                            cols * tf_vt_keys(cols)));
}

// byte offset of element (row, col) of a K-major tile of `rows` rows,
// boxes of 32 columns one after another, 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  return static_cast<uint32_t>((col >> 5) * rows * 128 + row * 128 +
                               ((((col & 31) >> 2) ^ (row & 7)) << 4) +
                               ((col & 3) << 2));
}

// x as tf32 hi + lo, stored at byte offset `off` of the hi and lo tiles
__device__ __forceinline__ void put_split(uint8_t* hi, uint8_t* lo,
                                          uint32_t off, float x) {
  const float h = tf32_rna(x);
  *reinterpret_cast<float*>(hi + off) = h;
  *reinterpret_cast<float*>(lo + off) = tf32_rna(x - h);
}

// two neighbouring outputs in one store (8-byte float2, 4-byte bf16x2)
__device__ __forceinline__ void store_pair(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x0,
                                           float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

// a barrier of one warpgroup's 128 threads (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// q [B, Sq, H, D], k/v [B, Sk, Hkv, D], out [B, Sq, H, D], all of type T
// (float, or bf16 widened to float on load).  NB = 32-column boxes of D.
//
// Fragment layouts: the accumulator as on the wgmma route (d[4i + e] at
// row 16w + lane / 4 + 8 * (e / 2), column 8i + 2 * (lane % 4) + e % 2);
// tf32's A operand from registers takes, for key step i, columns
// lane % 4 and lane % 4 + 4 of the step's 8, where the accumulator holds
// 2 * (lane % 4) and + 1.  So V^T holds the keys of each group of 8 in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (key 8i + j in slot 8i + j / 2 + 4 (j % 2)),
// and P's fragment is the score fragment's registers in another order: the
// sum over keys is permuted, the same way at every shape.
template <typename T, int NB>
__global__ void __launch_bounds__(128 * tf_groups(32 * NB), 1)
flash_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int Sq,
                    int Sk, int H, int Hkv, int D, int causal, int window,
                    float scale) {
  constexpr int kCols = 32 * NB;
  constexpr int kGroups = tf_groups(kCols);
  constexpr int kKeys = tf_keys(kCols);
  constexpr int kVtKeys = tf_vt_keys(kCols);
  constexpr bool kPrefetch = tf_prefetch(kCols);
  constexpr int kLoadRows = kKeys / 4;  // rows of a kv tile a warp loads
  constexpr uint32_t kQBytes = kTfRows * kCols * 4;
  constexpr uint32_t kKBytes = kKeys * kCols * 4;
  constexpr uint32_t kVtBytes = kCols * kVtKeys * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const q_hi = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) &
                                    1023u);
  uint8_t* const q_lo = q_hi + kQBytes;

  const int tid = threadIdx.x;
  const int group = tid >> 7;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // within the warpgroup
  const int q0 = blockIdx.x * kTfRows;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q_last = min(q0 + kTfRows, Sq) - 1;
  uint8_t* const k_hi = q_lo + kQBytes + group * 2 * (kKBytes + kVtBytes);
  uint8_t* const k_lo = k_hi + kKBytes;
  uint8_t* const vt_hi = k_lo + kKBytes;
  uint8_t* const vt_lo = vt_hi + kVtBytes;

  // kv tiles to walk, as on the wgmma route; warpgroup g takes t_lo + g,
  // t_lo + g + kGroups, ...
  const int nk = (Sk + kKeys - 1) / kKeys;
  int t_lo = 0;
  int t_hi = nk;
  const bool empty_row = window > 0 && q_last - (Sk - 1) >= window;
  if (!empty_row) {
    if (causal) t_hi = min(nk, q_last / kKeys + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / kKeys;
  }

  // row 4i + warp of a kv tile's K and V as this thread loads it
  // (columns lane + 32j); keys past Sk and columns past D are zero
  auto load_row = [&](int t, int i, float (&kx)[NB], float (&vx)[NB]) {
    const int kp = t * kKeys + 4 * i + warp;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = lane + 32 * j;
      const bool in = kp < Sk && c < D;
      const size_t src = ((b * Sk + kp) * Hkv + kvh) * D + c;
      kx[j] = in ? to_f32(k[src]) : 0.f;
      vx[j] = in ? to_f32(v[src]) : 0.f;
    }
  };
  // ... split into hi and lo: K as it lies (K-major for S = Q.K^T), V
  // transposed (K-major for O = P.V) with its keys in slot order
  auto store_row = [&](int i, const float (&kx)[NB], const float (&vx)[NB]) {
    const int r = 4 * i + warp;
    const int slot = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = lane + 32 * j;
      put_split(k_hi, k_lo, swz(r, c, kKeys), kx[j]);
      put_split(vt_hi, vt_lo, swz(c, slot, kCols), vx[j]);
    }
  };
  // with the prefetch, the next tile waits here during this tile's
  // products; without it (D > 128, where the output accumulator alone is
  // up to 128 registers), two rows at a time go to shared memory, both
  // loaded before either is stored
  float kr[kPrefetch ? kLoadRows : 1][NB], vr[kPrefetch ? kLoadRows : 1][NB];
  auto load = [&](int t) {
#pragma unroll
    for (int i = 0; i < (kPrefetch ? kLoadRows : 0); ++i)
      load_row(t, i, kr[i], vr[i]);
  };

  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  // each row's kept keys: lo_key <= key <= hi_key
  int lo_key[2], hi_key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    hi_key[r] = causal ? min(qp, Sk - 1) : Sk - 1;
    lo_key[r] = window > 0 ? qp - window + 1 : 0;
  }
  if (kPrefetch && t_lo + group < t_hi) load(t_lo + group);
  // Q, scaled in float32 before its split (as the plain version scales),
  // by every thread of the CTA; columns past D are zero, and so add
  // nothing to a product.  Its loads go out with the first kv tile's, a
  // batch of rows (up to 32 values a thread) loaded before any is stored
  {
    constexpr int kWarps = 4 * kGroups;
    constexpr int kRows = kTfRows / kWarps;    // a warp's rows of Q
    constexpr int kBatch = NB <= 4 ? kRows : 4;  // rows loaded together
    const int w = tid >> 5;
#pragma unroll 1
    for (int i0 = 0; i0 < kRows; i0 += kBatch) {
      float x[kBatch][NB];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int qp = q0 + kWarps * (i0 + i) + w;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int c = lane + 32 * j;
          x[i][j] = qp < Sq && c < D
                        ? to_f32(q[((b * Sq + qp) * H + h) * D + c])
                        : 0.f;
        }
      }
      // scaled only here: a product next to its load would wait for it
      // before the next load is issued
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          put_split(q_hi, q_lo, swz(kWarps * (i0 + i) + w, lane + 32 * j,
                                    kTfRows), x[i][j] * scale);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // Q is in place for both warpgroups

  // the softmax state, set only now: up to D 256 the output accumulator
  // is 128 registers, which Q's loads above need
  float o[NB][16];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int t = t_lo + group; t < t_hi; t += kGroups) {
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) store_row(i, kr[i], vr[i]);
      if (t + kGroups < t_hi) load(t + kGroups);  // lands during products
    } else {
#pragma unroll 1
      for (int i = 0; i < kLoadRows; i += 2) {
        float kx[2][NB], vx[2][NB];
        load_row(t, i, kx[0], vx[0]);
        load_row(t, i + 1, kx[1], vx[1]);
        store_row(i, kx[0], vx[0]);
        store_row(i + 1, kx[1], vx[1]);
      }
    }
    // the generic proxy's stores, before the async proxy (wgmma) reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(group);

    // S = Q.K^T as lo.hi + hi.lo + hi.hi, small terms first, over every
    // column of the boxes (those past D are zero and add nothing): each
    // 32-column box into a fresh accumulator (two in turn, the next box's
    // products running while the last one's are added), the boxes summed
    // on the CUDA cores, so that no truncating tensor-core sum runs longer
    // than 12 steps
    float sc[kKeys / 2];
    {
      float part[2][kKeys / 2];
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        float (&acc)[kKeys / 2] = part[bx & 1];
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) acc[i] = 0.f;
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          const uint32_t qa = smem_u32(pass == 0 ? q_lo : q_hi) +
                              bx * (kTfRows * 128);
          const uint32_t kb = smem_u32(pass == 1 ? k_lo : k_hi) +
                              bx * (kKeys * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_tf32_ss(acc, smem_desc(qa + kk * 32, 16, 1024),
                          smem_desc(kb + kk * 32, 16, 1024),
                          pass > 0 || kk > 0);
        }
        wg_commit();
        if (bx > 0) {
          wg_wait<1>();
          float (&done)[kKeys / 2] = part[(bx - 1) & 1];
          fence_regs(done);
#pragma unroll
          for (int i = 0; i < kKeys / 2; ++i)
            sc[i] = bx == 1 ? done[i] : sc[i] + done[i];
        }
      }
      wg_wait_all();
      float (&last)[kKeys / 2] = part[(NB - 1) & 1];
      fence_regs(last);
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i)
        sc[i] = NB == 1 ? last[i] : sc[i] + last[i];
    }

    // mask, row max, online softmax: as on the wgmma route, the score
    // already scaled
    const int k0 = t * kKeys;
    const bool interior = k0 + kKeys <= Sk &&
                          (!causal || k0 + kKeys - 1 <= q0) &&
                          (window <= 0 || q0 + kTfRows - 1 - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col0 + (e & 1);
        const int r = e >> 1;
        float x = sc[4 * i + e];
        if (!interior) {
          x = key >= lo_key[r] && key <= hi_key[r] ? x : kNegInf;
        }
        sc[4 * i + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + col0 + (e & 1);
        const float p = key < Sk ? expf(sc[4 * i + e] - m[e >> 1]) : 0.f;
        sc[4 * i + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];

    // P as tf32 hi + lo in A's fragment order: (row, key 2c), (row + 8,
    // key 2c), (row, key 2c + 1), (row + 8, key 2c + 1)
    uint32_t ph[kKeys / 8][4], pl[kKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = sc[4 * i + ((r & 1) << 1) + (r >> 1)];
        const float hi = tf32_rna(p);
        ph[i][r] = __float_as_uint(hi);
        pl[i][r] = __float_as_uint(tf32_rna(p - hi));
      }
    }

    // this tile's P.V as lo.hi + hi.lo + hi.hi, in 32-column pieces of D
    // (two at a time: 32 registers), into a fresh accumulator, then o =
    // o * corr + it on the CUDA cores: the tensor cores' float32
    // accumulation truncates, and a sum carried through every tile there
    // (1500 keys at whisper's encoder) drifts toward zero, by about 1e-5
    // of the output
#pragma unroll
    for (int j0 = 0; j0 < NB; j0 += 2) {
      constexpr int kPieces = NB < 2 ? NB : 2;
      float pv[kPieces][16];
#pragma unroll
      for (int jj = 0; jj < kPieces; ++jj) {
#pragma unroll
        for (int i = 0; i < 16; ++i) pv[jj][i] = 0.f;
        fence_regs(pv[jj]);
      }
      wg_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t vb = smem_u32(pass == 1 ? vt_lo : vt_hi);
#pragma unroll
        for (int jj = 0; jj < kPieces; ++jj) {
          if (j0 + jj >= NB) continue;
#pragma unroll
          for (int i = 0; i < kKeys / 8; ++i) {
            const uint32_t addr = vb + (i >> 2) * (kCols * 128) +
                                  (j0 + jj) * 32 * 128 + (i & 3) * 32;
            wgmma_tf32_rs(pv[jj], pass == 0 ? pl[i] : ph[i],
                          smem_desc(addr, 16, 1024));
          }
        }
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int jj = 0; jj < kPieces; ++jj) {
        if (j0 + jj >= NB) continue;
        fence_regs(pv[jj]);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          o[j0 + jj][i] = fmaf(o[j0 + jj][i], corr[(i >> 1) & 1], pv[jj][i]);
      }
    }
    group_sync(group);  // the warpgroup is done with its K and V^T
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kGroups == 2) {
    // warpgroup 1 hands its (m, l, o) over through its own buffers, value
    // n of its thread i at float 128 n + i (the thread of warpgroup 0 with
    // the same index holds the same rows and columns); warpgroup 0
    // rescales both to the larger m and adds them: a part whose rows saw
    // no kept key (m = NEG_INF) gets weight 0, and a row that no part kept
    // a key of averages V, as in the reference
    float* const xfer = reinterpret_cast<float*>(q_lo + kQBytes +
                                                 2 * (kKBytes + kVtBytes)) +
                        (tid & 127);
    if (group == 1) {
      xfer[0] = m[0];
      xfer[128] = m[1];
      xfer[256] = l[0];
      xfer[384] = l[1];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) xfer[128 * (4 + 16 * j + i)] = o[j][i];
    }
    __syncthreads();
    if (group == 1) return;
    float f0[2], f1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xfer[128 * r];
      const float mm = fmaxf(m[r], m1);
      f0[r] = expf(m[r] - mm);
      f1[r] = expf(m1 - mm);
      l[r] = l[r] * f0[r] + xfer[128 * (2 + r)] * f1[r];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        o[j][i] = o[j][i] * f0[r] + xfer[128 * (4 + 16 * j + i)] * f1[r];
      }
  }
  // acc / max(l, 1e-37), a division per element as the first float32
  // kernel divided; a thread's two neighbouring columns in one store where
  // D is even
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-37f);
    T* dst = out + ((b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * j + 8 * i + col0;
        const float x0 = o[j][4 * i + 2 * r] / denom;
        const float x1 = o[j][4 * i + 2 * r + 1] / denom;
        if (col + 1 < D && D % 2 == 0) {
          store_pair(dst + col, x0, x1);
        } else {
          if (col < D) dst[col] = from_f32<T>(x0);
          if (col + 1 < D) dst[col + 1] = from_f32<T>(x1);
        }
      }
    }
  }
}

template <typename T, int NB>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int H, int Hkv,
                          int D, int causal, int window, float scale,
                          cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tf32x3_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tf_smem_bytes(32 * NB));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + kTfRows - 1) / kTfRows, H, B);
  flash_tf32x3_kernel<T, NB>
      <<<grid, 128 * tf_groups(32 * NB), tf_smem_bytes(32 * NB), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, D,
          causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tf32x3(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Sk, int H, int Hkv,
                            int D, int causal, int window, float scale,
                            cudaStream_t stream) {
#define TF32X3_CASE(nb)                                                     \
  case nb:                                                                  \
    return launch_tf32x3<T, nb>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal, \
                                window, scale, stream);
  switch ((D + 31) / 32) {
    TF32X3_CASE(1)
    TF32X3_CASE(2)
    TF32X3_CASE(3)
    TF32X3_CASE(4)
    TF32X3_CASE(5)
    TF32X3_CASE(6)
    TF32X3_CASE(7)
    default:
      return launch_tf32x3<T, 8>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                                 window, scale, stream);
  }
#undef TF32X3_CASE
}

}  // namespace

// The wgmma route: q, k, v and out bf16, contiguous, 16-byte aligned,
// D % 16 == 0 and D <= 256.  Returns the CUDA error code of the launch
// (0 on success); cudaErrorNotSupported when the driver offers no
// cuTensorMapEncodeTiled or refuses a map.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int Sq, int Sk, int H, int Hkv,
                                            int D, int causal, int window,
                                            float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || D < 16 ||
      D > kMaxHeadDim || D % 16 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!encode_map(fn, &qm, q, D, H, Sq, B) ||
      !encode_map(fn, &km, k, D, Hkv, Sk, B) ||
      !encode_map(fn, &vm, v, D, Hkv, Sk, B))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + kBoxCols - 1) / kBoxCols) {
    case 1:
      return static_cast<int>(launch_wgmma<1>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
    case 2:
      return static_cast<int>(launch_wgmma<2>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
    case 3:
      return static_cast<int>(launch_wgmma<3>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
    default:
      return static_cast<int>(launch_wgmma<4>(qm, km, vm, out, B, Sq, Sk, H,
                                              Hkv, D, causal, window, scale,
                                              st));
  }
}

// The tf32x3 route: float32, and bf16 with D % 16 != 0.  dtype: 0 =
// float32, 1 = bfloat16 (q, k, v and out share it).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_attention_tf32x3_launch(int dtype, const void* q,
                                             const void* k, const void* v,
                                             void* out, int B, int Sq, int Sk,
                                             int H, int Hkv, int D, int causal,
                                             int window, float scale,
                                             void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > kMaxHeadDim || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_tf32x3<float>(
        q, k, v, out, B, Sq, Sk, H, Hkv, D, causal, window, scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_tf32x3<__nv_bfloat16>(
        q, k, v, out, B, Sq, Sk, H, Hkv, D, causal, window, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tf32x3 route's plan for head dim D, as its launch takes it: out[0..4]
// = cols, warpgroups, keys a kv tile, the prefetch (0 or 1) and the
// dynamic shared memory of a CTA in bytes (flash_attention.py:
// flash_f32_plan is held to it).  Returns cudaErrorInvalidValue for a D
// the route does not take, else 0.
extern "C" int flash_attention_tf32x3_plan(int D, int* out) {
  if (D < 1 || D > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = 32 * ((D + 31) / 32);
  out[0] = cols;
  out[1] = tf_groups(cols);
  out[2] = tf_keys(cols);
  out[3] = tf_prefetch(cols) ? 1 : 0;
  out[4] = tf_smem_bytes(cols);
  return 0;
}
