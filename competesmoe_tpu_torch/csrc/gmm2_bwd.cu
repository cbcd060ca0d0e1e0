// The backward of K1 (the fused grouped ReLU double GEMM) over the same
// expert-aligned row tiles, for Hopper (sm_90a). It replaces what JAX
// computes for K1's backward: competesmoe_tpu/ops/gmm_fused.py `_bwd`,
// jax.vjp of `grouped_ffn_kv`, i.e. XLA's ragged_dot VJP (no Pallas
// kernel), in its contract: bf16 operands, float32 accumulation, every
// product rounded to bf16.
//
// Per padded row p of expert e = tile_expert[p / 256] (a valid row when
// p - aoff[e] < gsize[e]; ops/gmm_fused.py `aligned_layout_full`):
//     do[p]  = bf16(g[slot[p] / k] * wflat[slot[p]])   (0 on padding rows)
//     h[p]   = bf16(xs[p] keys[e])          hr[p] = relu(h[p])
//     dh[p]  = bf16(do[p] values[e]^T) where h[p] > 0, else 0
//     dxs[p] = bf16(dh[p] keys[e]^T)
// and per expert
//     dkeys[e]   = f32(bf16(sum_p xs[p]^T dh[p]))
//     dvalues[e] = f32(bf16(sum_p hr[p]^T do[p]))
// rounded to bf16 once, after the whole group is summed, as XLA's
// ragged_dot_general writes them before JAX converts them to float32.
//
// What bounds them: at the 154M layer (S' = 540,672 padded rows, D 512,
// E 64, ES 128, k 8) both are bound by bytes (chip_smoke.py: 0.44 and
// 0.27 ms at 3.35 TB/s; their products need 0.21 and 0.14 ms of the
// tensor cores). dX reads xs, gathers do (g's rows: 553 MB as padded
// rows, g itself is 67 MB, but a token's row is read by k experts at
// different times) and writes dxs, hr and dh; dW reads xs, hr and dh and
// gathers do again. A gather of g's rows from an SM runs at about 8 GB/s
// (dW's producer needs 3200 cycles to issue one 16 KB stage of it), so
// the gather has to be spread over every SM and kept off the consumers'
// path.
//
// The design, K1's forward shape (csrc/gmm2_fused.cu), with helpers from
// mma_tiles.cuh and tensor_maps.cuh: a producer warpgroup and two consumer
// warpgroups a block, persistent blocks, a ring of stages on full / empty
// mbarriers that the producer keeps filled while the consumers compute,
// no barrier of the whole block after the start.
//   * The producer's thread 0 issues each stage's 2D tensor-map boxes
//     (128-byte swizzle). For do its 128 threads copy g's rows raw with
//     16-byte cp.async copies straight to their swizzled places (16 zero
//     bytes on padding rows), and each thread's copies arrive on the
//     stage's full barrier as they land (cp.async.mbarrier.arrive): the
//     producer never waits for its own copies.
//   * The consumers scale do in registers: ldmatrix of g's raw rows,
//     bf16(g w) with the row's weight (0 on padding rows), and the result
//     is the A operand of a register-A wgmma. Nothing is written to shared
//     memory for wgmma to read, so no proxy fence sits on their path (one
//     a stage, as an earlier version scaled do in place, held dW's
//     dvalues blocks at about 4,600 cycles a stage).
//   * gmm2_bwd_dx_kernel: a unit is 128 rows (half a tile: one expert),
//     64 a consumer warpgroup; block b takes units b, b + grid, ..., so
//     neighbouring blocks work on one expert and find its weights in L2.
//     For each 128 columns of ES: h on wgmma (xs K-major, keys MN-major)
//     over D / 64 stages; rounded, its sign kept as a 64-bit mask a
//     thread, hr written from registers; then dh = do values^T over D /
//     64 stages (values K-major), masked, rounded, written, and kept in
//     registers as the bf16 A operand of the last product (`tiles::as_a`,
//     ES / 8 registers a thread); then dxs = dh keys^T, 64 output columns
//     at a time, one stage of keys per 128 ES. The ring has 4 stages of 32
//     KB. Above ES 128 (HC > 1) the consumers take 224 registers a thread
//     from the producer warpgroup's share (`setmaxnreg`): dh alone is 32
//     HC of them; ES 128 (the 154M layer) fits the 168 the launch gives.
//   * gmm2_bwd_dw_kernel: both weight gradients as out[D][ES] = L^T R over
//     an expert's rows, L = xs, R = dh (dkeys) or L = do, R = hr (dvalues,
//     stored transposed). A block owns a 128 x 128 tile (D rows, ES
//     columns) of both: consumer warpgroup 0 sums dkeys' (shared-memory
//     wgmma, both operands MN-major), warpgroup 1 dvalues' (do^T from
//     registers, ldmatrix transposed), over the same stages of 64 rows, so
//     every block gathers its 128 columns of g's rows and the gather is
//     spread over the whole card. Balance across experts whatever their
//     sizes: the grid is `groups` x T blocks (T = (D / 128) (ES / 128)
//     tiles); group j takes the 256-row tiles [j A / groups, (j + 1) A /
//     groups) of the aligned rows (A = aoff[E] / 256), the T blocks of a
//     group the same rows at once (so they share xs, dh, hr and g's rows
//     in L2). An expert that lies inside one group's rows is summed and
//     rounded by its block; a group cut inside an expert writes its
//     float32 partial tiles to a workspace (at most two of each gradient
//     a block), and gmm2_bwd_dw_sum_kernel then adds an expert's partials
//     in group order and rounds once (and writes the zeros of experts
//     without rows). The cut points depend only on aoff and the grid, so
//     a second run gives the same bytes; no atomics. The ring has 2
//     stages of 64 KB (a 128-row stage would be 128 KB: one stage, no
//     ring).
//
// Variants (chip_variants.py, at the 154M layer; NVIDIA H100 80GB HBM3,
// 700 W; in turns with the kernel as built, which read 565-574 us for dW
// and 736-738 us for dX): dW with 3 stages 670 us, stages of 32 rows 652
// (4 of them: 609-610), half the groups 922-931, the gather by one-row
// tensor-map boxes 634-636, one wait for dvalues' products a stage 584, a
// 256-byte L2 prefetch on the gather 568-570; dX with 6 stages 754.
// Readings: dW with no products 669, without the gather 417, with do read
// as a [S', D] operand by the copy engine (do written once by dX) 420, dX
// also writing do 1025 (so writing do once costs dX more than it saves
// dW); dX's bare copy stream 725.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tensor_maps.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 256;                // rows per expert-aligned tile
constexpr int kBox = 64 * 64 * 2;         // a [64][64] bf16 box: 8 KB
constexpr int kMaxES = 512;
constexpr int kMaxE = 512;                // dW keeps aoff and gsize in shared memory
constexpr int kThreads = 384;             // a producer and two consumer warpgroups

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A register of two bf16 of g (the lower half first) scaled by w0 and w1
// and rounded: two slot gradients bf16(g w).
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float w0, float w1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return tiles::pack_bf16(f.x * w0, f.y * w1);
}

// A warpgroup's 64 x 8 NT accumulators rounded to bf16 and stored as rows
// of `out` (row pitch `ld` elements) from column `col0`: rows g and g + 8
// of each warp's 16 (`rows` points at row g), 16-byte stores after a
// transpose within each quad of lanes.
template <int NT, int NA>
__device__ __forceinline__ void store_rows(bf16* rows, size_t ld, int col0,
                                           const float (&acc)[NA][4], int t) {
  static_assert(NT % 4 == 0 && NT <= NA, "n-tiles");
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NT / 4; ++j) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = tiles::pack_bf16(acc[4 * j + i][2 * h], acc[4 * j + i][2 * h + 1]);
      tiles::quad_transpose(v, t);
      *reinterpret_cast<uint4*>(rows + 8 * h * ld + col0 + 8 * (4 * j + t)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
}

// The ring's bookkeeping, as K1's forward keeps it: stage `it` lives in
// slot it % STAGES; the producer waits for the slot's previous use to be
// released, a consumer for the stage to land.
template <int STAGES>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int it = 0;
  __device__ int produce() {
    const int slot = it % STAGES;
    if (it >= STAGES) tiles::mbar_wait(&empty[slot], (it / STAGES - 1) & 1);
    ++it;
    return slot;
  }
  __device__ int consume() {
    const int slot = it % STAGES;
    tiles::mbar_wait(&full[slot], (it / STAGES) & 1);
    ++it;
    return slot;
  }
  __device__ void release(int slot, int lane) {
    __syncwarp();
    if (lane == 0) tiles::mbar_arrive(&empty[slot]);
  }
};

// ---- dX -------------------------------------------------------------------
//
// A unit's stages, in order, for each 128 columns c of ES: D / 64 "h"
// stages (the xs box [128][64] of D columns kd, keys[e]'s boxes [64 D][64
// ES] x 2), D / 64 "dh" stages (do [128][64] gathered, values[e]'s boxes
// [64 ES][64 D] x 2); then for each 64 output columns nd of D, HC "dx"
// stages (keys[e]'s boxes [64 D][64 ES] x 2).

constexpr int kDxRows = 128;                        // rows of a unit
constexpr int kDxRowBytes = kDxRows * 64 * 2;       // the xs / do part: 16 KB

template <int HC>   // ES = 128 HC
struct DxGeo {
  static constexpr int ES = 128 * HC;
  static constexpr int SLOT = kDxRowBytes + 2 * kBox;   // 32 KB
  // 4, not the 6 that fit: 2% faster (chip_variants.py `dx_ring_6`)
  static constexpr int STAGES = 4;
  static constexpr int BARS = STAGES * SLOT;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
};

template <int HC>
__global__ void __launch_bounds__(kThreads, 1)
gmm2_bwd_dx_kernel(const __grid_constant__ CUtensorMap xmap,   // xs [S, D]
                   const __grid_constant__ CUtensorMap kmap,   // keys [E D, ES]
                   const __grid_constant__ CUtensorMap vmap,   // values [E ES, D]
                   const bf16* __restrict__ g, const int* __restrict__ slot,
                   const bf16* __restrict__ wflat,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ aoff, const int* __restrict__ gsize,
                   int k, int D, int units, bf16* __restrict__ dxs,
                   bf16* __restrict__ hr_out, bf16* __restrict__ dh_out) {
  typedef DxGeo<HC> G;
  constexpr int ES = G::ES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - tiles::smem_u32(smem_raw)) & 1023u);
  Ring<G::STAGES> ring{reinterpret_cast<uint64_t*>(smem + G::BARS),
                       reinterpret_cast<uint64_t*>(smem + G::BARS) + G::STAGES};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  const int KD = D / 64;

  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      tiles::mbar_init(&ring.full[s], 1 + 128);
      tiles::mbar_init(&ring.empty[s], 8);    // the consumers' warps
    }
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread 0 issues the boxes; for a dh stage every
    // thread also copies do's rows raw from g (its 16-byte chunk tid % 8 of
    // rows tid / 8 + 16 j of the unit, 16 zero bytes on padding rows), and
    // the barrier counts its copies as they land (the consumers scale
    // them). Every stage: thread 0's bytes and 128 more arrivals.
    if constexpr (HC > 1) tiles::regs_dec<56>();
    const CUtensorMap *xm = &xmap, *km = &kmap, *vm = &vmap;
    uint64_t once = 0, keep = 0;
    if (tid == 0) {
      tma::prefetch(xm);
      tma::prefetch(km);
      tma::prefetch(vm);
      once = tma::evict_first();
      keep = tma::evict_last();
    }
    const int ch = tid % 8, r0 = tid / 8;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int row0 = u * kDxRows;
      const int e = tile_expert[row0 / kTile];
      const int lo = aoff[e], n = gsize[e];
      int token[8];
      uint32_t valid = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = row0 + r0 + 16 * j;
        token[j] = slot[p] / k;
        valid |= uint32_t(p - lo < n) << j;
      }
      for (int c = 0; c < HC; ++c) {
        for (int kd = 0; kd < KD; ++kd) {               // h
          const int s = ring.produce();
          if (tid == 0) {
            unsigned char* st = smem + s * G::SLOT;
            tiles::mbar_expect(&ring.full[s], G::SLOT);
            tma::box(st, xm, kd * 64, row0, &ring.full[s], once);
            for (int b = 0; b < 2; ++b)
              tma::box(st + kDxRowBytes + b * kBox, km, c * 128 + b * 64,
                       e * D + kd * 64, &ring.full[s], keep);
            tiles::mbar_arrive_n(&ring.full[s], 128);
          }
        }
        for (int kd = 0; kd < KD; ++kd) {               // dh
          const int s = ring.produce();
          unsigned char* st = smem + s * G::SLOT;
          if (tid == 0) {
            tiles::mbar_expect(&ring.full[s], 2 * kBox);
            for (int b = 0; b < 2; ++b)
              tma::box(st + kDxRowBytes + b * kBox, vm, kd * 64,
                       e * ES + c * 128 + b * 64, &ring.full[s], keep);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
            tiles::cp_async16_zfill(
                st + 2 * tiles::block_offset<64>(r0 + 16 * j, 8 * ch),
                g + (size_t)token[j] * D + kd * 64 + 8 * ch, (valid >> j) & 1);
          tiles::cp_async_mbar_arrive(&ring.full[s]);
        }
      }
      for (int nd = 0; nd < KD; ++nd)
        for (int c = 0; c < HC; ++c) {                  // dx
          const int s = ring.produce();
          if (tid == 0) {
            unsigned char* st = smem + s * G::SLOT;
            tiles::mbar_expect(&ring.full[s], 2 * kBox);
            for (int b = 0; b < 2; ++b)
              tma::box(st + kDxRowBytes + b * kBox, km, c * 128 + b * 64,
                       e * D + nd * 64, &ring.full[s], keep);
            tiles::mbar_arrive_n(&ring.full[s], 128);
          }
        }
    }
    return;
  }

  // ---- consumer warpgroup cw: rows 64 cw .. 64 cw + 63 of each unit;
  // warp w's rows 16 (w % 4) + g8 (+ 8)
  if constexpr (HC > 1) tiles::regs_inc<224>();
  const int cw = wg - 1, g8 = lane >> 2, t = lane & 3;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const size_t my_row =
        (size_t)u * kDxRows + 64 * cw + 16 * (warp % 4) + g8;
    // the weights of this thread's rows my_row and my_row + 8 (0 on
    // padding rows), read now, used after the h stages
    float w_row[2];
    {
      const int e = tile_expert[u * kDxRows / kTile];
      const int lo = aoff[e], n = gsize[e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = static_cast<int>(my_row) + 8 * h;
        w_row[h] = p - lo < n ? __bfloat162float(wflat[slot[p]]) : 0.0f;
      }
    }
    uint64_t hmask[HC];             // h > 0, bit 4 n + i of acc[n][i]
    uint32_t dha[HC][8][4];         // dh, bf16 pairs: the A operand
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      float acc[16][4];             // 64 rows x 128 columns
      tiles::zero(acc);
      for (int kd = 0; kd < KD; ++kd) {   // h += xs keys[e]: keys MN-major
        const int s = ring.consume();
        const bf16* st = reinterpret_cast<const bf16*>(smem + s * G::SLOT);
        const uint64_t a = tiles::block_desc<64>(st + cw * 64 * 64);
        const uint64_t b0 = tiles::block_desc<64>(st + kDxRowBytes / 2);
        const uint64_t b1 = tiles::block_desc<64>(st + (kDxRowBytes + kBox) / 2);
        tiles::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tiles::WgmmaSS<64>::template run<0, 1, 0>(acc, a + 2 * kk, b0 + 128 * kk, 1);
          tiles::WgmmaSS<64>::template run<0, 1, 8>(acc, a + 2 * kk, b1 + 128 * kk, 1);
        }
        tiles::wgmma_commit();
        tiles::wgmma_wait<0>();
        tiles::pin(acc);
        ring.release(s, lane);
      }
      // h rounded to bf16 (the relu mask comes from the rounded value),
      // then relu: hr
      hmask[c] = 0;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float h = round_bf16(acc[n][i]);
          if (h > 0.0f) hmask[c] |= uint64_t(1) << (4 * n + i);
          acc[n][i] = fmaxf(h, 0.0f);
        }
      store_rows<16>(hr_out + my_row * ES, ES, c * 128, acc, t);
      tiles::zero(acc);
      for (int kd = 0; kd < KD; ++kd) {   // dh += do values[e]^T: values K-major
        const int s = ring.consume();
        const bf16* st = reinterpret_cast<const bf16*>(smem + s * G::SLOT);
        // do = bf16(g w) as A registers: g's raw rows by ldmatrix, lane L
        // row (L / 8 & 1) 8 + L % 8 and k-chunk L / 16 of the warp's 16
        // rows, scaled by the row's weight
        uint32_t a[4][4];
        const int arow = 64 * cw + 16 * (warp % 4) + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tiles::ldsm_x4<false>(a[kk], st + tiles::block_offset<64>(
                                           arow, 8 * (2 * kk + (lane >> 4))));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[kk][i] = scale_pair(a[kk][i], w_row[i & 1], w_row[i & 1]);
        }
        const uint64_t b0 = tiles::block_desc<64>(st + kDxRowBytes / 2);
        const uint64_t b1 = tiles::block_desc<64>(st + (kDxRowBytes + kBox) / 2);
        tiles::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tiles::WgmmaRS<64>::template run<0, 0>(acc, a[kk], b0 + 2 * kk);
          tiles::WgmmaRS<64>::template run<8, 0>(acc, a[kk], b1 + 2 * kk);
        }
        tiles::wgmma_commit();
        tiles::wgmma_wait<0>();
        tiles::pin(acc);
        ring.release(s, lane);
      }
      // dh = bf16(do values^T) where h > 0: written, and kept as A
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[n][i] = (hmask[c] >> (4 * n + i)) & 1 ? round_bf16(acc[n][i]) : 0.0f;
      store_rows<16>(dh_out + my_row * ES, ES, c * 128, acc, t);
      tiles::as_a(dha[c], acc);
      tiles::pin(dha[c]);
    }
    for (int nd = 0; nd < KD; ++nd) {     // dxs = dh keys[e]^T: keys K-major
      float acc[8][4];                    // 64 rows x 64 output columns
      tiles::zero(acc);
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int s = ring.consume();
        const bf16* st = reinterpret_cast<const bf16*>(smem + s * G::SLOT);
        tiles::wgmma_fence();
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const uint64_t bk = tiles::block_desc<64>(st + (kDxRowBytes + b * kBox) / 2);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            tiles::WgmmaRS<64>::template run<0, 0>(acc, dha[c][4 * b + kk], bk + 2 * kk);
        }
        tiles::wgmma_commit();
        tiles::wgmma_wait<0>();
        tiles::pin(acc);
        ring.release(s, lane);
      }
      store_rows<8>(dxs + my_row * D, D, nd * 64, acc, t);
    }
  }
}

template <int HC>
int launch_dx(const void* xs, const void* g, const void* slot,
              const void* wflat, const void* keys, const void* values,
              const void* tile_expert, const void* aoff, const void* gsize,
              void* dxs, void* hr, void* dh, int S, int D, int E, int k,
              cudaStream_t stream) {
  typedef DxGeo<HC> G;
  const int set = tiles::prepare<gmm2_bwd_dx_kernel<HC>>(G::SMEM);
  if (set != 0) return set;
  CUtensorMap xmap, kmap, vmap;
  if (!tma::bf16_map(&xmap, xs, S, D, kDxRows) ||
      !tma::bf16_map(&kmap, keys, E * D, G::ES, 64) ||
      !tma::bf16_map(&vmap, values, E * G::ES, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int units = S / kDxRows;
  const int grid = units < sms ? units : sms;
  gmm2_bwd_dx_kernel<HC><<<grid, kThreads, G::SMEM, stream>>>(
      xmap, kmap, vmap, static_cast<const bf16*>(g),
      static_cast<const int*>(slot), static_cast<const bf16*>(wflat),
      static_cast<const int*>(tile_expert), static_cast<const int*>(aoff),
      static_cast<const int*>(gsize), k, D, units, static_cast<bf16*>(dxs),
      static_cast<bf16*>(hr), static_cast<bf16*>(dh));
  return static_cast<int>(cudaGetLastError());
}

// ---- dW -------------------------------------------------------------------
//
// Both gradients as out[D][ES] = L^T R summed over an expert's rows:
// dkeys[e] = xs^T dh and dvalues[e]^T = do^T hr. Block (group, mt, nt)
// owns D rows mt 128 .. mt 128 + 127 and ES columns nt 128 .. nt 128 + 127
// of both: consumer warpgroup 0 sums dkeys' tile, warpgroup 1 dvalues'
// (two m64 accumulators each), over the same stages. A stage is kDwStep
// rows: xs's and do's [kDwStep][64] boxes x 2 (D columns), dh's and hr's
// x 2 (ES columns), all MN-major (the rows are the contraction). do's
// rows are g's, gathered raw, so every block gathers its share of them.

constexpr int kDwStep = 64;                   // rows a stage
constexpr int kDwBox = kDwStep * 64 * 2;      // a [kDwStep][64] bf16 box
constexpr int kDwBM = 128;                    // D rows of a block's tiles

struct DwGeo {
  // the parts of a stage: xs, do (gathered), dh, hr, each 2 boxes
  static constexpr int XS = 0, DO = 2 * kDwBox, DH = 4 * kDwBox, HR = 6 * kDwBox;
  static constexpr int SLOT = 8 * kDwBox;            // 64 KB
  // 2, not the 3 that fit: 15% faster (chip_variants.py `dw_ring_3`)
  static constexpr int STAGES = 2;
  static constexpr int BARS = STAGES * SLOT;
  // each stage's rows' slots and the 4-byte words of wflat that hold
  // their weights, copied beside g's rows
  static constexpr int ROWTAB = BARS + 2 * STAGES * 8;
  static constexpr int META = ROWTAB + STAGES * kDwStep * 8;   // aoff, gsize
  static constexpr int SMEM = META + 2 * (kMaxE + 1) * 4 + 1024;
};

// The blocks of a group: one per (D / 128) x (ES / 128) tile of the pair.
__host__ __device__ inline int dw_tiles(int D, int ES) {
  return (D / kDwBM) * (ES / 128);
}

__device__ __forceinline__ int group_start(int j, int A, int groups) {
  return static_cast<int>((long long)j * A / groups);
}

// An expert's rows within a group's tiles [lo, hi): `piece` walks them in
// expert order. mode 0: the expert's whole group (the final sum); 1: a
// continuation of an expert begun before lo (workspace slot 0); 2: an
// expert begun here and ended after hi (workspace slot 1).
struct Piece {
  int e = -1, row0 = 0, steps = 0, mode = 0;
};

__device__ __forceinline__ bool next_piece(Piece& p, const int* aoff,
                                           const int* gsize, int E, int lo,
                                           int hi) {
  for (int e = lo < hi ? p.e + 1 : E; e < E; ++e) {
    const int c0 = aoff[e] / kTile, c1 = aoff[e + 1] / kTile;
    if (c0 >= hi) break;
    if (c1 <= lo || c1 == c0) continue;
    const int t0 = c0 > lo ? c0 : lo, t1 = c1 < hi ? c1 : hi;
    const int end = min(t1 * kTile, aoff[e] + gsize[e]);
    p.e = e;
    p.row0 = t0 * kTile;
    p.steps = (end - p.row0 + kDwStep - 1) / kDwStep;
    p.mode = t0 > c0 ? 1 : (t1 < c1 ? 2 : 0);
    return true;
  }
  p.e = E;
  return false;
}

// The workspace's partial tile `slot` (0, 1) of gradient `grad` (0 dkeys,
// 1 dvalues, laid out as the output: [128 ES][128 D] for dvalues) of block
// `block`.
__host__ __device__ inline size_t dw_partial(int block, int grad, int slot) {
  return (size_t)((2 * block + grad) * 2 + slot) * kDwBM * 128;
}

__global__ void __launch_bounds__(kThreads, 1)
gmm2_bwd_dw_kernel(const __grid_constant__ CUtensorMap xmap,   // xs [S, D]
                   const __grid_constant__ CUtensorMap hmap,   // hr [S, ES]
                   const __grid_constant__ CUtensorMap dhmap,  // dh [S, ES]
                   const bf16* __restrict__ g, const int* __restrict__ slot,
                   const bf16* __restrict__ wflat,
                   const int* __restrict__ aoff_g,
                   const int* __restrict__ gsize_g, int k, int D, int ES,
                   int E, int groups, float* __restrict__ dkeys,
                   float* __restrict__ dvalues, float* __restrict__ ws) {
  typedef DwGeo G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - tiles::smem_u32(smem_raw)) & 1023u);
  Ring<G::STAGES> ring{reinterpret_cast<uint64_t*>(smem + G::BARS),
                       reinterpret_cast<uint64_t*>(smem + G::BARS) + G::STAGES};
  int* slot_tab = reinterpret_cast<int*>(smem + G::ROWTAB);   // [STAGES][kDwStep]
  uint32_t* w_tab = reinterpret_cast<uint32_t*>(slot_tab + G::STAGES * kDwStep);
  int* aoff = reinterpret_cast<int*>(smem + G::META);
  int* gsize = aoff + kMaxE + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  const int T = dw_tiles(D, ES), NT = ES / 128;
  const int grp = blockIdx.x / T, mt = blockIdx.x % T / NT, nt = blockIdx.x % NT;

  for (int i = tid; i <= E; i += kThreads) {
    aoff[i] = aoff_g[i];
    if (i < E) gsize[i] = gsize_g[i];
  }
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      // thread 0's bytes and the copies of the 128 producer threads
      tiles::mbar_init(&ring.full[s], 1 + 128);
      tiles::mbar_init(&ring.empty[s], 8);
    }
  }
  __syncthreads();
  const int A = aoff[E] / kTile;
  const int lo = group_start(grp, A, groups), hi = group_start(grp + 1, A, groups);

  if (wg == 0) {
    // ---- producer (its registers go to the consumers): thread 0 issues
    // the boxes of xs, dh and hr; every thread copies its 16-byte chunk ch
    // = lane % 16 of g's row (128 columns) for stage rows r0 + 2 j, j < 8
    // (16 zero bytes on padding rows), and the lane with chunk 0 the row's
    // slot and the wflat word that holds its weight; the barrier counts
    // each thread's copies as they land. The consumers scale do.
    tiles::regs_dec<56>();
    constexpr int PASSES = kDwStep / 8;
    const int ch = lane % 16, r0 = kDwStep / 4 * warp + lane / 16;
    const int col = mt * kDwBM + 8 * ch;
    // s / k as a multiply-high (exact for s < 2^32 / k)
    const unsigned long long kdiv = ((1ull << 32) + k - 1) / k;
    const uint32_t* wwords = reinterpret_cast<const uint32_t*>(wflat);
    uint64_t once = 0;
    if (tid == 0) {
      tma::prefetch(&xmap);
      tma::prefetch(&hmap);
      tma::prefetch(&dhmap);
      once = tma::evict_first();
    }
    // piece p, step s_cur now; piece q, step s_next after it, whose slots
    // are read a step ahead
    Piece p, q;
    int s_cur = 0, s_next = 0;
    bool have = next_piece(p, aoff, gsize, E, lo, hi);
    q = p;
    int cur_slot[PASSES], next_slot[PASSES];
    if (have) {
#pragma unroll
      for (int j = 0; j < PASSES; ++j) next_slot[j] = slot[p.row0 + r0 + 2 * j];
    }
    while (have) {
      const int row = p.row0 + kDwStep * s_cur;
      const int lo_e = aoff[p.e], n_e = gsize[p.e];
#pragma unroll
      for (int j = 0; j < PASSES; ++j) cur_slot[j] = next_slot[j];
      s_next = s_cur + 1;
      if (s_next == q.steps) {
        have = next_piece(q, aoff, gsize, E, lo, hi);
        s_next = 0;
      }
      if (have) {
#pragma unroll
        for (int j = 0; j < PASSES; ++j)
          next_slot[j] = slot[q.row0 + kDwStep * s_next + r0 + 2 * j];
      }
      const int sl = ring.produce();
      unsigned char* st = smem + sl * G::SLOT;
      if (tid == 0) {
        tiles::mbar_expect(&ring.full[sl], 6 * kDwBox);
        for (int b = 0; b < 2; ++b) {
          tma::box(st + G::XS + b * kDwBox, &xmap, mt * kDwBM + b * 64, row,
                   &ring.full[sl], once);
          tma::box(st + G::DH + b * kDwBox, &dhmap, nt * 128 + b * 64, row,
                   &ring.full[sl], once);
          tma::box(st + G::HR + b * kDwBox, &hmap, nt * 128 + b * 64, row,
                   &ring.full[sl], once);
        }
      }
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        const int r = r0 + 2 * j;
        const uint32_t s = cur_slot[j];
        tiles::cp_async16_zfill(
            st + G::DO + (ch / 8) * kDwBox + 2 * tiles::block_offset<64>(r, 8 * (ch % 8)),
            g + (size_t)((s * kdiv) >> 32) * D + col, row + r - lo_e < n_e);
        if (ch == 0) {
          tiles::cp_async4(&slot_tab[sl * kDwStep + r], slot + row + r);
          tiles::cp_async4(&w_tab[sl * kDwStep + r], wwords + s / 2);
        }
      }
      tiles::cp_async_mbar_arrive(&ring.full[sl]);
      p = q;
      s_cur = s_next;
    }
    return;
  }

  // ---- consumer warpgroup cw: dkeys (0) or dvalues (1); its m-tile j
  // holds D rows 64 j .. 64 j + 63 of the tile, in n-tiles 16 j .. 16 j + 15
  tiles::regs_inc<224>();
  const int cw = wg - 1, g8 = lane >> 2, t = lane & 3;
  const bool is_dv = cw == 1;
  Piece p;
  while (next_piece(p, aoff, gsize, E, lo, hi)) {
    float acc[32][4];
    tiles::zero(acc);
    const int lo_e = aoff[p.e], n_e = gsize[p.e];
    for (int s = 0; s < p.steps; ++s) {
      const int sl = ring.consume();
      unsigned char* stage = smem + sl * G::SLOT;
      const bf16* st = reinterpret_cast<const bf16*>(stage);
      const uint64_t b0 = tiles::block_desc<64>(st + (is_dv ? G::HR : G::DH) / 2);
      const uint64_t b1 = b0 + kDwBox / 16;
      if (is_dv) {
        // do^T = bf16(g w)^T as A registers: g's raw rows by ldmatrix,
        // transposed (the stage's rows are the contraction): lane L row
        // 16 kk + 8 (L / 16) + L % 8 and D chunk 2 (warp % 4) + (L / 8 & 1)
        // of m-tile j; element k of a register scaled by row k's weight
        // (0 on padding rows): rows 16 kk + 2t + {0, 1, 8, 9}
        const int row = p.row0 + kDwStep * s;
#pragma unroll
        for (int kk = 0; kk < kDwStep / 16; ++kk) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * kk + 2 * t + (i & 1) + 8 * (i >> 1);
            const int sr = slot_tab[sl * kDwStep + r];
            const uint32_t word = w_tab[sl * kDwStep + r];
            w[i] = row + r - lo_e < n_e
                       ? __uint_as_float((sr & 1 ? word >> 16 : word) << 16)
                       : 0.0f;
          }
          const int krow = 16 * kk + 8 * (lane >> 4) + (lane & 7);
          const int chunk = 2 * (warp % 4) + ((lane >> 3) & 1);
          uint32_t a[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            tiles::ldsm_x4<true>(a[j], stage + G::DO + j * kDwBox +
                                           2 * tiles::block_offset<64>(krow, 8 * chunk));
            a[j][0] = scale_pair(a[j][0], w[0], w[1]);
            a[j][1] = scale_pair(a[j][1], w[0], w[1]);
            a[j][2] = scale_pair(a[j][2], w[2], w[3]);
            a[j][3] = scale_pair(a[j][3], w[2], w[3]);
          }
          tiles::wgmma_fence();
          tiles::WgmmaRS<64>::template run<0, 1>(acc, a[0], b0 + 128 * kk);
          tiles::WgmmaRS<64>::template run<8, 1>(acc, a[0], b1 + 128 * kk);
          tiles::WgmmaRS<64>::template run<16, 1>(acc, a[1], b0 + 128 * kk);
          tiles::WgmmaRS<64>::template run<24, 1>(acc, a[1], b1 + 128 * kk);
          tiles::wgmma_commit();
          tiles::wgmma_wait<0>();   // a is rewritten by the next k-step
        }
      } else {
        const uint64_t a0 = tiles::block_desc<64>(st + G::XS / 2);
        const uint64_t a1 = a0 + kDwBox / 16;
        tiles::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDwStep / 16; ++kk) {   // 16 rows: 2 KB on
          tiles::WgmmaSS<64>::template run<1, 1, 0>(acc, a0 + 128 * kk, b0 + 128 * kk, 1);
          tiles::WgmmaSS<64>::template run<1, 1, 8>(acc, a0 + 128 * kk, b1 + 128 * kk, 1);
          tiles::WgmmaSS<64>::template run<1, 1, 16>(acc, a1 + 128 * kk, b0 + 128 * kk, 1);
          tiles::WgmmaSS<64>::template run<1, 1, 24>(acc, a1 + 128 * kk, b1 + 128 * kk, 1);
        }
        tiles::wgmma_commit();
        tiles::wgmma_wait<0>();
      }
      tiles::pin(acc);
      ring.release(sl, lane);
    }
    // the expert's sum rounded to bf16 once (stored as float32), or a
    // float32 partial in the workspace; both laid out as the output
    // (dvalues' tile transposed: [128 ES][128 D])
    const bool fin = p.mode == 0;
    float* base;
    int ld;
    if (fin) {
      base = is_dv ? dvalues + ((size_t)p.e * ES + nt * 128) * D + mt * kDwBM
                   : dkeys + ((size_t)p.e * D + mt * kDwBM) * ES + nt * 128;
      ld = is_dv ? D : ES;
    } else {
      base = ws + dw_partial(blockIdx.x, cw, p.mode - 1);
      ld = 128;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = 64 * j + 16 * (warp % 4) + g8;
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[16 * j + n8][2 * h], v1 = acc[16 * j + n8][2 * h + 1];
          if (fin) {
            v0 = round_bf16(v0);
            v1 = round_bf16(v1);
          }
          const int n = 8 * n8 + 2 * t;
          if (is_dv) {
            base[(size_t)n * ld + m + 8 * h] = v0;
            base[(size_t)(n + 1) * ld + m + 8 * h] = v1;
          } else {
            *reinterpret_cast<float2*>(base + (size_t)(m + 8 * h) * ld + n) =
                make_float2(v0, v1);
          }
        }
    }
  }
}

// The second pass: block (e, tile, gradient). An expert without rows gets
// zeros; an expert that one group summed is left as gmm2_bwd_dw_kernel
// wrote it; an expert cut by the groups gets its partials added in group
// order (the first group's slot 1, then each later group's slot 0) and
// rounded once.
__global__ void __launch_bounds__(256)
gmm2_bwd_dw_sum_kernel(const int* __restrict__ aoff,
                       const int* __restrict__ gsize, int D, int ES, int E,
                       int groups, const float* __restrict__ ws,
                       float* __restrict__ dkeys, float* __restrict__ dvalues) {
  const int T = dw_tiles(D, ES), NT = ES / 128;
  const int grad = blockIdx.x % 2, tau = blockIdx.x / 2 % T, e = blockIdx.x / 2 / T;
  const int mt = tau / NT, nt = tau % NT;
  const int A = aoff[E] / kTile;
  const int c0 = aoff[e] / kTile, c1 = aoff[e + 1] / kTile;
  const bool empty = gsize[e] == 0;
  int first = 0;
  if (!empty) {
    while (group_start(first + 1, A, groups) <= c0) ++first;
    if (c1 <= group_start(first + 1, A, groups)) return;
  }
  float* out = grad ? dvalues + ((size_t)e * ES + nt * 128) * D + mt * kDwBM
                    : dkeys + ((size_t)e * D + mt * kDwBM) * ES + nt * 128;
  const int ld = grad ? D : ES;
  for (int i = 4 * threadIdx.x; i < kDwBM * 128; i += 4 * 256) {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!empty) {
      sum = *reinterpret_cast<const float4*>(
          ws + dw_partial(first * T + tau, grad, 1) + i);
      for (int j = first + 1; j < groups && group_start(j, A, groups) < c1; ++j) {
        if (group_start(j + 1, A, groups) == group_start(j, A, groups)) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            ws + dw_partial(j * T + tau, grad, 0) + i);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      sum = make_float4(round_bf16(sum.x), round_bf16(sum.y),
                        round_bf16(sum.z), round_bf16(sum.w));
    }
    *reinterpret_cast<float4*>(out + (size_t)(i / 128) * ld + i % 128) = sum;
  }
}

// The grid of gmm2_bwd_dw_kernel: groups of T blocks, as many as fit one
// block an SM (at least one group).
int dw_groups(int D, int ES) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int groups = sms / dw_tiles(D, ES);
  return groups > 0 ? groups : 1;
}

int launch_dw(const void* xs, const void* hr, const void* dh, const void* g,
              const void* slot, const void* wflat, const void* aoff,
              const void* gsize, void* dkeys, void* dvalues, void* ws, int S,
              int D, int ES, int E, int k, cudaStream_t stream) {
  typedef DwGeo G;
  const int set = tiles::prepare<gmm2_bwd_dw_kernel>(G::SMEM);
  if (set != 0) return set;
  CUtensorMap xmap, hmap, dhmap;
  if (!tma::bf16_map(&xmap, xs, S, D, kDwStep) ||
      !tma::bf16_map(&hmap, hr, S, ES, kDwStep) ||
      !tma::bf16_map(&dhmap, dh, S, ES, kDwStep))
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = dw_tiles(D, ES);
  const int groups = dw_groups(D, ES);
  gmm2_bwd_dw_kernel<<<groups * T, kThreads, G::SMEM, stream>>>(
      xmap, hmap, dhmap, static_cast<const bf16*>(g),
      static_cast<const int*>(slot), static_cast<const bf16*>(wflat),
      static_cast<const int*>(aoff), static_cast<const int*>(gsize), k, D,
      ES, E, groups, static_cast<float*>(dkeys), static_cast<float*>(dvalues),
      static_cast<float*>(ws));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm2_bwd_dw_sum_kernel<<<E * T * 2, 256, 0, stream>>>(
      static_cast<const int*>(aoff), static_cast<const int*>(gsize), D, ES, E,
      groups, static_cast<const float*>(ws), static_cast<float*>(dkeys),
      static_cast<float*>(dvalues));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). Shapes: xs bf16 [S, D]; g bf16
// [T, D]; slot int32 [S] (the flat top-k slot feeding each padded row, any
// valid slot on padding rows); wflat bf16 [T k]; keys bf16 [E, D, ES];
// values bf16 [E, ES, D]; tile_expert int32 [S / 256]; aoff int32 [E + 1]
// (the aligned start of each expert's rows); gsize int32 [E]; dxs bf16
// [S, D]; hr, dh bf16 [S, ES]; dkeys float32 [E, D, ES]; dvalues float32
// [E, ES, D]; ws float32 [gmm2_bwd_dw_workspace(D, ES)] (dW's partial
// tiles; its size depends on the shapes and the card only). Requires S %
// 256 == 0, D % 128 == 0, ES % 128 == 0, ES <= 512, E <= 512 (dW) and
// 16-byte aligned pointers. Each launch returns its error.
extern "C" int gmm2_bwd_dx_launch(const void* xs, const void* g,
                                  const void* slot, const void* wflat,
                                  const void* keys, const void* values,
                                  const void* tile_expert, const void* aoff,
                                  const void* gsize, void* dxs, void* hr,
                                  void* dh, int S, int D, int ES, int E, int k,
                                  void* stream_ptr) {
  if (S % kTile != 0 || D % 128 != 0 || ES % 128 != 0 || ES > kMaxES ||
      S < 0 || E < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (ES / 128) {
    case 1: return launch_dx<1>(xs, g, slot, wflat, keys, values, tile_expert, aoff, gsize, dxs, hr, dh, S, D, E, k, stream);
    case 2: return launch_dx<2>(xs, g, slot, wflat, keys, values, tile_expert, aoff, gsize, dxs, hr, dh, S, D, E, k, stream);
    case 3: return launch_dx<3>(xs, g, slot, wflat, keys, values, tile_expert, aoff, gsize, dxs, hr, dh, S, D, E, k, stream);
    default: return launch_dx<4>(xs, g, slot, wflat, keys, values, tile_expert, aoff, gsize, dxs, hr, dh, S, D, E, k, stream);
  }
}

// Floats of dW's workspace: two partial tiles of each gradient a block of
// its grid.
extern "C" long long gmm2_bwd_dw_workspace(int D, int ES) {
  if (D < 128 || D % 128 != 0 || ES < 128 || ES % 128 != 0) return 0;
  return (long long)dw_partial(dw_groups(D, ES) * dw_tiles(D, ES), 0, 0);
}

extern "C" int gmm2_bwd_dw_launch(const void* xs, const void* hr,
                                  const void* dh, const void* g,
                                  const void* slot, const void* wflat,
                                  const void* aoff, const void* gsize,
                                  void* dkeys, void* dvalues, void* ws, int S,
                                  int D, int ES, int E, int k,
                                  void* stream_ptr) {
  if (S % kTile != 0 || D % 128 != 0 || ES % 128 != 0 || ES > kMaxES ||
      S < kTile || E < 1 || E > kMaxE || k < 1 || k > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(xs, hr, dh, g, slot, wflat, aoff, gsize, dkeys, dvalues,
                   ws, S, D, ES, E, k, static_cast<cudaStream_t>(stream_ptr));
}
