// Small-M matmuls for decode on Hopper (sm_90a), two kernels:
//
//   K3  mm_bf16: out[M, N] = bf16(x[M, K] @ w[K, N])            (bf16 w)
//   K4  qmm8:    out[M, N] = bf16((x[M, K] @ w_q[K, N]) * scale[N]) (int8 w)
//
// both with float32 accumulation, x bf16; M <= 32 for K3, M <= 128 for K4.
//
// Replace the Pallas TPU kernels competesmoe_tpu/ops/matvec.py
// `small_m_matmul` / `_mm_kernel` (K3) and `quant_small_m_matmul` /
// `_qmm_kernel` (K4).
//
// What bounds them: weight bytes. At decode (M = 1..40) every weight byte
// is read once and feeds 2*M multiply-adds, far below the card's compute
// rate, so both kernels are weight streams. The TPU kernels carry an f32
// sum in scratch across a sequential K grid axis; Hopper blocks run in
// parallel and carry nothing, so each block loops over its own K range,
// and where the output alone gives too few blocks to fill 132 SMs, K is
// split across blocks. Neither uses atomics: results repeat bit for bit.
//
// Both compute out^T[N, M] = W^T[N, K] x^T on the tensor cores, the weight
// rows as the row operand:
//   * wgmma m64nNk16 (bf16, f32 accumulation), one warpgroup a block for
//     its 64 weight rows (outputs), with x^T the narrow operand: N = 8 NT
//     columns cover every row of x at once, so every weight byte is read
//     once whatever M. Nothing is loaded into registers but the
//     accumulator (4 NT floats a thread). (mma.sync m16n8k16 fed by
//     ldmatrix was slower for K3 at every M: every warp loaded the same x
//     fragments, and at M 32 the loads held the ring back.)
//   * A ring of shared-memory stages of 128 K: one producer thread asks the
//     copy engine for each stage as boxes of 2D tensor maps
//     (tensor_maps.cuh) on the stage's full barrier, as soon as the
//     consumers release it (its empty barrier, once the products that read
//     it are done), so several stages of loads are in flight per block.
//     Rows beyond N or M and columns beyond K arrive as zeros. One box is
//     one request: copies of single 256-byte rows left K3 bound by the copy
//     engine's request rate (time grew with the number of copies, not
//     bytes). The weights are read under an evict-first L2 policy and x
//     under evict-last: x is staged with every stage, from L2 (every block
//     reads it), because the whole of it does not fit (512 KB at M 32,
//     K 8192).
//   * Split K inside one launch (`finish`): the S <= 8 blocks that share a
//     block of output rows and split K are one thread-block cluster. Each
//     writes its f32 partial tile into its drained ring; after a cluster
//     barrier, rank r sums rows [64 r / S, 64 (r + 1) / S) of every rank's
//     tile through distributed shared memory in rank order 0..S-1 (the
//     ranks' values loaded together, then added), rounds to bf16 and
//     stores. No second launch and no f32 partials in device memory. An
//     unsplit K (qkv and gate_up at the 5.1B shapes) stores its
//     accumulators straight from registers: the round trip through shared
//     memory and the cluster's barriers took time that grew with M.
//
// K3 (the port's bf16 decoder stores nn.Linear.weight as [N, K] and passes
// its transposed view, so each output's K values are contiguous; the
// kernel reads that storage in place): both operands are K-major boxes
// (64 columns, 128-byte rows, the 128-byte swizzle that wgmma reads) that
// the tensor cores read themselves, a ring of 4 stages of 128 K, 4 boxes a
// stage (two of 64 weight rows, two of the 8 NT rows of x); NT = 1..4 by
// M = 1..32 in steps of 8. What bounds it now (PERF.md): device memory, as
// for torch.matmul; the smallest projection (o_proj) least close to it,
// where launch and ramp weigh most.
//
// K4 keeps JAX's weight layout, int8 w_q [K, N] with N contiguous (the
// decoder, `from_jax_params` and the non-kernel path all read it; no
// second, transposed copy), and JAX's arithmetic: each int8 weight is
// converted to bf16, which holds every value of [-128, 127] exactly, and
// multiplied with the exact bf16 x on the tensor cores; the scale is
// applied once per output in the f32 epilogue. x is not quantized. The
// design on top of the above:
//   * A block takes 128 outputs: a stage is one int8 box of 64 K rows x
//     128 columns (128-byte rows in the 128-byte swizzle) and one x box of
//     64 K. Two consumer warpgroups, one for each 64 outputs, each convert
//     their half of the box and multiply it. (64 outputs a block, 64-byte
//     rows, one warpgroup, streamed no faster and converted half as fast.)
//   * A warpgroup converts its int8 half into a bf16 tile [64 K][64 n] in
//     the 128-byte swizzle, each thread 16 bytes at a time with masks and
//     one bf16x2 subtraction per pair (`int8x4_to_bf16`: 7 instructions
//     per 4 bytes, no int->float conversions, no byte permutes), stored
//     with 16-byte vector stores (`tiles::sts128`: nvcc split the uint4
//     stores into 4-byte ones, 4-way bank conflicts that made the
//     conversion take most of a stage), once per byte per call; then
//     `fence.proxy.async` and the warpgroup's barrier. That tile is
//     wgmma's A operand read MN-major (stored [k][n], the transpose bit),
//     so the conversion keeps the bytes' order and needs no transpose; it
//     writes a word's bytes 0, 2 | 1, 3 as pairs, so tile column i holds
//     output sigma(i) (bits 0 and 1 exchanged), which the epilogue undoes.
//     Building the A fragments straight in registers (WgmmaRS) would need
//     single bytes of 16 different K rows per thread, one load each; the
//     shared-memory tile takes 16-byte loads and stores, conflict-free.
//   * Two converted tiles alternate: stage s is converted while the
//     products of stage s - 1 run on the tensor cores; the wait for those
//     products and the warpgroup's barrier come after the conversion, so
//     one barrier a stage guards both tiles.
//   * NT 8-row tiles of x cover every row of x in one pass, one launch
//     per call, whatever M up to 128: M 1-8 pads to the wgmma width 8,
//     9-16 to 16, 17-24 to 24, 25-32 to 32, 33-40 to 40 (the verify tick
//     of 8 slots x (1 + 4) tokens), 41-64 to 64 and 65-128 to 128 (the
//     prefill groups of 64 and 128 rows).
// What bounds it now (PERF.md): each warpgroup's serial chain a stage
// (wait for the box, convert, fence and barrier, issue), about 900 cycles
// for 8 KB of weights, so the stream needs several blocks an SM: a
// shallow ring up to M 40 (three blocks an SM) and K splits for 1.5
// blocks an SM. Even the copies alone, with no conversion or product,
// reach only about 60% of the card's memory rate with these boxes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tensor_maps.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows3 = 64;                     // weight rows per block
constexpr int kConsumers = 4;                  // one warpgroup
constexpr int kThreads3 = 32 * (kConsumers + 1);   // and a producer warp
constexpr int kBoxK = 64;                      // K columns of a copy's box
constexpr int kStageK = 2 * kBoxK;             // K columns per stage
constexpr int kMaxSplits = 8;                  // portable cluster size

// ------------------------------------------------- the end of K3 and K4

// Column `i` of a K4 tile holds output n0 + sigma(i): the conversion
// writes the bf16 of a word's bytes 0, 2, 1, 3 in that order (bits 0 and 1
// of the column exchanged).
__device__ __forceinline__ int sigma(int i) {
  return (i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1);
}

// The block's accumulators, OUT rows of out^T from n0 (consumer warp w:
// rows 16 w + g (+ 8), through `sigma` for K4; x rows 8 nt + 2 t (+ 1)),
// times the per-output scale (K4) and rounded to bf16: stored straight
// from registers for an unsplit K, otherwise summed across the cluster's
// ranks through the drained ring `red` ([8 NT][OUT] f32). Every thread of
// the block calls it; the consumers are its first OUT / 16 warps.
template <int NT, int OUT, bool kInt8>
__device__ __forceinline__ void finish(const float (&acc)[NT][4], float* red,
                                       const float* __restrict__ scale,
                                       bf16* __restrict__ out, int n0,
                                       int rows, int M, int N, int split,
                                       int splits) {
  constexpr int kWarps = OUT / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  int row[2];                        // the outputs of the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row[h] = kInt8 ? sigma(16 * warp + g + 8 * h) : 16 * warp + g + 8 * h;
  if (splits == 1) {
    // no other split: the accumulators go straight out
    if (warp < kWarps) {
      float s[2] = {1.0f, 1.0f};
      if constexpr (kInt8)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row[h] < rows) s[h] = scale[n0 + row[h]];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = row[e >> 1];
          const int m = 8 * nt + 2 * t + (e & 1);
          if (i < rows && m < M)
            out[(size_t)m * N + n0 + i] =
                __float2bfloat16_rn(kInt8 ? acc[nt][e] * s[e >> 1] : acc[nt][e]);
        }
    }
    return;
  }
  __syncthreads();          // the ring is drained: it takes the partials
  if (warp < kWarps) {
    // red[m][i] for x row m, output n0 + i
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * nt + 2 * t + (e & 1)) * OUT + row[e >> 1]] = acc[nt][e];
  }

  // rank `split` sums its rows of every rank's partial tile, in rank
  // order; the ranks' values are loaded together, then added
  tiles::cluster_sync();
  const int i0 = OUT * split / splits, i1 = OUT * (split + 1) / splits;
  const int span = i1 - i0;
  for (int e = threadIdx.x; e < span * M; e += blockDim.x) {
    const int i = i0 + e % span, m = e / span;
    if (i >= rows) continue;
    const float* part = red + m * OUT + i;
    float parts[kMaxSplits];
#pragma unroll
    for (int rank = 0; rank < kMaxSplits; ++rank)
      if (rank < splits) parts[rank] = tiles::ld_cluster_f32(part, rank);
    float sum = 0.0f;
#pragma unroll
    for (int rank = 0; rank < kMaxSplits; ++rank)
      if (rank < splits) sum += parts[rank];
    if constexpr (kInt8) sum *= scale[n0 + i];
    out[(size_t)m * N + n0 + i] = __float2bfloat16_rn(sum);
  }
  tiles::cluster_sync();    // no block leaves while another reads its tile
}

// ------------------------------------------------------------------ K3
constexpr int kStages = 4;                     // the ring's depth
constexpr int kMaxM3 = 32;

// Shared memory of K3 for NT 8-row tiles of x, from its first 1024-byte
// boundary (the 128-byte swizzle needs it): the ring, each stage two
// boxes of 64 weight rows x 64 columns and two of 8 NT x rows x 64
// columns (128-byte rows, swizzled), then each stage's full and empty
// barriers. Once the ring is drained it holds the partial tile [8 NT][64]
// f32.
template <int NT>
struct Geo3 {
  static constexpr int WBOX = kRows3 * kBoxK * 2;
  static constexpr int XBOX = 8 * NT * kBoxK * 2;
  static constexpr int STAGE = 2 * WBOX + 2 * XBOX;
  static constexpr int BARS = kStages * STAGE;
  static constexpr int SMEM = BARS + 2 * kStages * 8 + 1024;
};

template <int NT>
__global__ void __launch_bounds__(kThreads3)
mm_bf16_kernel(const __grid_constant__ CUtensorMap wmap,   // w's [N, K]
               const __grid_constant__ CUtensorMap xmap,   // x [M, K]
               bf16* __restrict__ out,                     // [M, N]
               int M, int K, int N, int chunk) {
  typedef Geo3<NT> G;
  extern __shared__ unsigned char smem3_raw[];
  unsigned char* smem3 =
      smem3_raw + ((1024u - tiles::smem_u32(smem3_raw)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem3 + G::BARS);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kRows3;
  const int rows = min(kRows3, N - n0);
  // the cluster is the grid's y extent: this block's rank is its split
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_begin = split * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int stages = k_end > k_begin ? (k_end - k_begin + kStageK - 1) / kStageK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tiles::mbar_init(&full[s]);
      tiles::mbar_init(&empty[s], kConsumers);
    }
  }
  __syncthreads();

  float acc[NT][4];      // warp w: weight rows 16 w + g (+ 8), x rows 8 nt + 2 t (+ 1)
  if (warp == kConsumers) {
    // producer: stage `it` into slot it % kStages once the consumers are
    // done with stage it - kStages. Rows beyond N or M and columns beyond
    // K arrive as zeros (the tensor maps' bounds).
    if (lane == 0) {
      tma::prefetch(&wmap);
      tma::prefetch(&xmap);
      const uint64_t once = tma::evict_first(), shared = tma::evict_last();
      for (int it = 0; it < stages; ++it) {
        const int slot = it % kStages;
        if (it >= kStages) tiles::mbar_wait(&empty[slot], (it / kStages - 1) & 1);
        const int k0 = k_begin + it * kStageK;
        unsigned char* stage = smem3 + slot * G::STAGE;
        tiles::mbar_expect(&full[slot], G::STAGE);
        for (int b = 0; b < 2; ++b) {
          tma::box(stage + b * G::WBOX, &wmap, k0 + b * kBoxK, n0, &full[slot],
                   once);
          tma::box(stage + 2 * G::WBOX + b * G::XBOX, &xmap, k0 + b * kBoxK, 0,
                   &full[slot], shared);
        }
      }
    }
  } else {
    // consumers, one warpgroup: per stage 8 products m64 x (8 NT) x k16,
    // both operands read by the tensor cores from the swizzled boxes; a
    // stage is released once the products after it are issued
    tiles::zero(acc);
    for (int it = 0; it < stages; ++it) {
      const int slot = it % kStages;
      tiles::mbar_wait(&full[slot], (it / kStages) & 1);
      const bf16* stage = reinterpret_cast<const bf16*>(smem3 + slot * G::STAGE);
      tiles::wgmma_fence();
#pragma unroll
      for (int box = 0; box < 2; ++box) {
        const uint64_t a = tiles::block_desc<64>(stage + box * G::WBOX / 2);
        const uint64_t b =
            tiles::block_desc<64>(stage + (2 * G::WBOX + box * G::XBOX) / 2);
#pragma unroll
        for (int kk = 0; kk < kBoxK / 16; ++kk)       // 16 columns: 32 bytes
          tiles::WgmmaSS<8 * NT>::run(acc, a + 2 * kk, b + 2 * kk, 1);
      }
      tiles::wgmma_commit();
      tiles::wgmma_wait<1>();              // stage it - 1's products are done
      tiles::pin(acc);
      __syncwarp();
      if (it > 0 && lane == 0) tiles::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    tiles::wgmma_wait<0>();
    tiles::pin(acc);
  }
  finish<NT, kRows3, false>(acc, reinterpret_cast<float*>(smem3), nullptr,
                            out, n0, rows, M, N, split, splits);
}

// ------------------------------------------------------------------ K4
constexpr int kOut4 = 128;                     // outputs per block
constexpr int kGroups4 = kOut4 / 64;           // consumer warpgroups, 64 outputs each
constexpr int kThreads4 = 128 * kGroups4 + 32; // and a producer warp
constexpr int kStageK4 = 64;                   // K rows per stage
constexpr int kMaxM4 = 128;

// Shared memory of K4 for NT 8-row tiles of x, from its first 1024-byte
// boundary: the ring, each stage one int8 box [64 K][128 n] (128-byte
// rows, 128-byte swizzle) and one x box [8 NT][64 K] (likewise), as many
// stages as fit 40 KB up to M 40 (4 at M 1-8, 3 at M 33-40: three blocks
// an SM, which beat a deeper ring at two) and 72 KB above (4 at M 41-64,
// 3 at M 65-128: two blocks an SM); then each warpgroup's two converted
// bf16 tiles [64 K][64 n] (128-byte swizzle); then the barriers.
// Once the ring is drained, it and the tiles hold the partial tile
// [8 NT][128] f32.
template <int NT>
struct Geo4 {
  static_assert(kStageK4 == kBoxK, "a stage takes one x box");
  static constexpr int WBOX = kStageK4 * kOut4;
  static constexpr int XBOX = 8 * NT * kBoxK * 2;
  static constexpr int STAGE = WBOX + XBOX;
  static constexpr int FIT = (NT <= 5 ? 40 : 72) * 1024 / STAGE;
  static constexpr int STAGES = FIT < 2 ? 2 : FIT > 8 ? 8 : FIT;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int TILE = kStageK4 * 64 * 2;
  static constexpr int BARS = RING + 2 * kGroups4 * TILE;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
  static_assert(8 * NT * kOut4 * 4 <= BARS, "the partial tile fits");
};

// Four signed bytes b0..b3 (w's bytes, low first) as two bf16 pairs,
// exactly: (b0, b2) in `r.x` and (b1, b3) in `r.y`, the first of each in
// the lower half. For a byte b with sign bit h and low bits l, the bf16
// 0x4300 | l is 128 + l and 0x4300 | h << 7 is 128 + 128 h, and their
// difference l - 128 h = b is an integer of [-128, 127], which bf16 holds
// exactly: two masks and one bf16x2 subtraction a pair, no int->float
// conversions and no byte permutes.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  uint2 r;
  const uint32_t hi = w >> 8;
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(r.x)
      : "r"((w & 0x007F007Fu) | 0x43004300u), "r"((w & 0x00800080u) | 0x43004300u));
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(r.y)
      : "r"((hi & 0x007F007Fu) | 0x43004300u), "r"((hi & 0x00800080u) | 0x43004300u));
  return r;
}

// Warpgroup `wg`'s barrier (the other warpgroup and the producer warp do
// not take part); named barriers 1 and 2.
__device__ __forceinline__ void group_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

template <int NT>
__global__ void __launch_bounds__(kThreads4)
qmm8_kernel(const __grid_constant__ CUtensorMap wmap,   // int8 w [K, N]
            const __grid_constant__ CUtensorMap xmap,   // bf16 x [M, K]
            const float* __restrict__ scale,            // [N]
            bf16* __restrict__ out,                     // [M, N]
            int M, int K, int N, int chunk) {
  typedef Geo4<NT> G;
  extern __shared__ unsigned char smem4_raw[];
  unsigned char* smem4 =
      smem4_raw + ((1024u - tiles::smem_u32(smem4_raw)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4 + G::BARS);
  uint64_t* empty = full + G::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;                       // consumer warpgroup
  const int n0 = blockIdx.x * kOut4;
  const int rows = min(kOut4, N - n0);
  // the cluster is the grid's y extent: this block's rank is its split
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_first = split * chunk;
  const int k_stop = min(K, k_first + chunk);
  const int n_stages = k_stop > k_first ? (k_stop - k_first + kStageK4 - 1) / kStageK4 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      tiles::mbar_init(&full[s]);
      tiles::mbar_init(&empty[s], 4 * kGroups4);
    }
  }
  __syncthreads();

  float acc[NT][4];      // warp w: tile columns 16 (w % 4) + g (+ 8) of its warpgroup, x rows 8 nt + 2 t (+ 1)
  if (warp == 4 * kGroups4) {
    // producer: stage `it` into slot it % STAGES once the consumers are
    // done with stage it - STAGES
    if (lane == 0) {
      tma::prefetch(&wmap);
      tma::prefetch(&xmap);
      const uint64_t w_policy = tma::evict_first();
      const uint64_t x_policy = tma::evict_last();
      for (int it = 0; it < n_stages; ++it) {
        const int slot = it % G::STAGES;
        if (it >= G::STAGES)
          tiles::mbar_wait(&empty[slot], (it / G::STAGES - 1) & 1);
        const int k0 = k_first + it * kStageK4;
        unsigned char* stage = smem4 + slot * G::STAGE;
        tiles::mbar_expect(&full[slot], G::STAGE);
        tma::box(stage, &wmap, n0, k0, &full[slot], w_policy);
        tma::box(stage + G::WBOX, &xmap, k0, 0, &full[slot], x_policy);
      }
    }
  } else {
    // consumers, a warpgroup for each 64 outputs: per stage, convert its
    // half of the int8 box into its bf16 tile (it & 1) while the products
    // of stage it - 1 run, wait for those, publish the tile, release stage
    // it - 1's slot and issue 4 products m64 x (8 NT) x k16 (A the
    // converted tile, MN-major; B x's box, K-major)
    const int tid = threadIdx.x % 128;
    bf16* tiles_wg = reinterpret_cast<bf16*>(smem4 + G::RING + wg * 2 * G::TILE);
    tiles::zero(acc);
    for (int it = 0; it < n_stages; ++it) {
      const int slot = it % G::STAGES;
      tiles::mbar_wait(&full[slot], (it / G::STAGES) & 1);
      const unsigned char* stage = smem4 + slot * G::STAGE;
      bf16* wb = tiles_wg + (it & 1) * (G::TILE / 2);
      // 64 rows x the warpgroup's 4 chunks of 16 bytes, 2 a thread; a
      // quarter warp takes one chunk of 8 rows in a row: 8 distinct
      // 16-byte columns of the swizzled box and of the tile
#pragma unroll
      for (int r = 0; r < kStageK4 * 4 / 128; ++r) {
        const int u = tid + 128 * r;
        const int k = (u & 7) + 8 * (u >> 5), c = (u >> 3) & 3;
        const uint4 q = *reinterpret_cast<const uint4*>(
            stage + k * kOut4 + 16 * ((4 * wg + c) ^ (k & 7)));
        const uint2 b0 = int8x4_to_bf16(q.x), b1 = int8x4_to_bf16(q.y);
        const uint2 b2 = int8x4_to_bf16(q.z), b3 = int8x4_to_bf16(q.w);
        tiles::sts128(wb + tiles::block_offset<64>(k, 16 * c), b0.x, b0.y, b1.x,
                      b1.y);
        tiles::sts128(wb + tiles::block_offset<64>(k, 16 * c + 8), b2.x, b2.y,
                      b3.x, b3.y);
      }
      tiles::wgmma_wait<0>();              // stage it - 1's products are done
      tiles::pin(acc);
      tiles::fence_async_proxy();
      group_sync(wg);                      // the tile is whole; tile it - 1 is free
      if (it > 0 && lane == 0) tiles::mbar_arrive(&empty[(it - 1) % G::STAGES]);
      tiles::wgmma_fence();
      const uint64_t a = tiles::block_desc<64>(wb);
      const uint64_t b = tiles::block_desc<64>(
          reinterpret_cast<const bf16*>(stage + G::WBOX));
#pragma unroll
      for (int kk = 0; kk < kStageK4 / 16; ++kk)   // 16 K rows: 2048 bytes of A
        tiles::WgmmaSS<8 * NT>::template run<1>(acc, a + 128 * kk, b + 2 * kk, 1);
      tiles::wgmma_commit();
    }
    tiles::wgmma_wait<0>();
    tiles::pin(acc);
  }
  finish<NT, kOut4, true>(acc, reinterpret_cast<float*>(smem4), scale, out, n0,
                          rows, M, N, split, splits);
}

template <int NT>
int launch_mm(const void* x, const void* w, void* out, int M, int K, int N,
              int splits, int chunk, cudaStream_t stream) {
  int err = tiles::prepare<mm_bf16_kernel<NT>>(Geo3<NT>::SMEM);
  if (err) return err;
  CUtensorMap wmap, xmap;
  if (!tma::bf16_map(&wmap, w, N, K, kRows3) ||
      !tma::bf16_map(&xmap, x, M, K, 8 * NT))
    return static_cast<int>(cudaErrorInvalidValue);
  return tiles::launch_clusters(mm_bf16_kernel<NT>, kRows3, kThreads3, Geo3<NT>::SMEM,
                         N, splits, stream, wmap, xmap,
                         static_cast<bf16*>(out), M, K, N, chunk);
}

template <int NT>
int launch_qmm(const void* x, const void* w, const void* scale, void* out,
               int M, int K, int N, int splits, int chunk,
               cudaStream_t stream) {
  int err = tiles::prepare<qmm8_kernel<NT>>(Geo4<NT>::SMEM);
  if (err) return err;
  CUtensorMap wmap, xmap;
  if (!tma::matrix_map(&wmap, w, K, N, kStageK4, kOut4, 1,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tma::bf16_map(&xmap, x, M, K, 8 * NT))
    return static_cast<int>(cudaErrorInvalidValue);
  return tiles::launch_clusters(qmm8_kernel<NT>, kOut4, kThreads4, Geo4<NT>::SMEM, N,
                         splits, stream, wmap, xmap,
                         static_cast<const float*>(scale),
                         static_cast<bf16*>(out), M, K, N, chunk);
}

// Shared checks of both entry points: a chunk of whole stages, at most 8
// splits (one cluster), and the splits cover K.
bool splits_ok(int K, int splits, int chunk, int stage) {
  return chunk >= 1 && chunk % stage == 0 && splits >= 1 &&
         splits <= kMaxSplits && static_cast<long long>(splits) * chunk >= K;
}

}  // namespace

// C entry point of K3 (bound with ctypes). x: bf16 [M, K]; w: the storage
// of bf16 w[K, N] as a contiguous [N, K]; out: bf16 [M, N]. Requires
// 1 <= M <= 32, K % 8 == 0, 16-byte aligned x and w, chunk a multiple of
// 128, 1 <= splits <= 8 and splits * chunk >= K. Returns
// cudaGetLastError() (or the launch's error).
extern "C" int mm_bf16_launch(const void* x, const void* w, void* out, int M,
                              int K, int N, int splits, int chunk,
                              void* stream_ptr) {
  if (M < 1 || M > kMaxM3 || N < 1 || K % 8 != 0 ||
      !splits_ok(K, splits, chunk, kStageK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch ((M + 7) / 8) {
    case 1: return launch_mm<1>(x, w, out, M, K, N, splits, chunk, stream);
    case 2: return launch_mm<2>(x, w, out, M, K, N, splits, chunk, stream);
    case 3: return launch_mm<3>(x, w, out, M, K, N, splits, chunk, stream);
    default: return launch_mm<4>(x, w, out, M, K, N, splits, chunk, stream);
  }
}

// C entry point of K4. x: bf16 [M, K]; w: int8 [K, N], N contiguous;
// scale: f32 [N]; out: bf16 [M, N]. Requires 1 <= M <= 128, K % 8 == 0,
// N % 16 == 0, 16-byte aligned x and w, chunk a multiple of 64,
// 1 <= splits <= 8 and splits * chunk >= K. One launch; returns the
// launch's error.
extern "C" int qmm8_launch(const void* x, const void* w, const void* scale,
                           void* out, int M, int K, int N, int splits,
                           int chunk, void* stream_ptr) {
  if (M < 1 || M > kMaxM4 || N < 16 || N % 16 != 0 || K % 8 != 0 ||
      !splits_ok(K, splits, chunk, kStageK4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nt = (M + 7) / 8;
  if (nt <= 1) return launch_qmm<1>(x, w, scale, out, M, K, N, splits, chunk, stream);
  if (nt <= 2) return launch_qmm<2>(x, w, scale, out, M, K, N, splits, chunk, stream);
  if (nt <= 3) return launch_qmm<3>(x, w, scale, out, M, K, N, splits, chunk, stream);
  if (nt <= 4) return launch_qmm<4>(x, w, scale, out, M, K, N, splits, chunk, stream);
  if (nt <= 5) return launch_qmm<5>(x, w, scale, out, M, K, N, splits, chunk, stream);
  if (nt <= 8) return launch_qmm<8>(x, w, scale, out, M, K, N, splits, chunk, stream);
  return launch_qmm<16>(x, w, scale, out, M, K, N, splits, chunk, stream);
}
