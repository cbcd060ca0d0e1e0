// Causal flash attention for Hopper (sm_90a), forward and backward (K2):
//     o = softmax(q k^T * sm_scale, causal) v        on [B*h, T, p] bf16
// with the row log-sum-exp saved by the forward for the backward.
//
// Replaces the Pallas TPU flash attention that competesmoe_tpu/models/lm.py
// `FastRopeAttention.__call__` reaches with attn_backend='flash'
// (jax.experimental.pallas.ops.tpu.flash_attention: `_flash_attention_impl`
// forward, `_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`).
//
// What bounds it: at the 154M shape (B 64, h 4, T 1024, p 82) the forward
// reads q, k, v and writes o, 172 MB against 4.4e10 causal FLOP: bytes and
// operations are close (51 vs 44 us at the card's peaks); dK/dV does 8 and
// dQ 6 FLOP per causal (query, key) pair and feature on the same bytes, so
// both backward kernels are bound by operations (89 and 67 us). All three
// keep the [T, T] scores out of device memory, which is what the TPU
// kernels do too, and skip every key tile above the diagonal. Tiles are 64
// rows; a warpgroup (4 warps) owns one tile of one (batch, head), each warp
// 16 of its rows, and walks the tiles it meets: blocks carry nothing
// between them, so the TPU's sequential grid axis becomes this loop. Head size 82 is no multiple of the tensor cores' 16: tiles sit
// in shared memory padded with zeros to P = 32, 64, 96 or 128 columns (by
// template); copies and stores keep to the true p, so device memory is
// never padded.
//
// Forward (one block per pair of query tiles, two warpgroups, one per
// tile; the key tiles up to the diagonal in order, each staged once for
// both): S = Q K^T comes out of the tensor cores as registers; the online
// softmax runs there in base 2 (running max of S scale log2e per row, over
// the lane's quad; each lane sums its own columns, the quad's sums are
// added once at the end); P = 2^(S scale log2e - max) is rounded to bf16
// pairs that are the A operand of O += P V, as the einsum path rounds
// `probs.astype(v.dtype)`; the O accumulator (48 f32 a thread at P 96)
// stays in registers for the whole loop and is rescaled there. V is the
// MN-major operand of its stored tile. At the end o = O / l and the
// natural-log lse = (max + log2 l) ln 2, which the backward reads. Sharing
// the key tiles between two query tiles halves the moves and the L2 reads
// per product; it beat one query tile a block at the 154M shape, but only
// at two blocks an SM (128 registers a thread; at one block it is much
// slower: chip_variants.py, PERF.md).
//
// Backward, as the TPU splits it: delta = rowsum(dO * o) in plain PyTorch;
// `flash_bwd_dkv` (one block per key tile, looping over the query tiles at
// and below the diagonal) and `flash_bwd_dq` (one block per query tile,
// looping over the key tiles up to the diagonal). Each gradient is summed
// by one warp in a fixed order: no atomics, so results repeat bit for bit
// (the forward's too). P is rounded to bf16 before dV += P^T dO and dS
// before its two products (the usual flash-attention choice). A block's
// work is small, so what counts is what it wastes between tensor-core
// instructions. The design of all three (helpers in mma_tiles.cuh):
//   * wgmma m64nNk16 issued by the kernel; the backward's block is one
//     warpgroup, the forward's two. The
//     tensor cores read both operands of S and dP from shared memory, once
//     for all 64 rows (mma.sync or WMMA make every warp read the whole
//     streamed tile for its 16 rows, which bound those versions by shared
//     memory). The accumulator layout is documented, so the accumulators
//     (O; dK and dV; dQ) stay in registers for the whole loop, and so do
//     the scores: S and dP come out of the tensor cores as registers,
//     become P and dS there (exp2), are rounded to bf16 pairs that already
//     are the A operand of the next product, and never touch shared memory.
//   * dK/dV computes the transposes, S^T = K Q^T and dP^T = V dO^T, so
//     that the warp's rows are its keys: P^T and dS^T are then the A
//     operands of dV += P^T dO and dK += dS^T Q, and lse and delta index
//     the columns (the tile's 64 values of each are staged in shared
//     memory beside the tile). dQ is the untransposed form.
//   * Products in flight while the arithmetic runs: S and dP are two
//     groups, the exponentials run under dP, dV is issued as soon as P is
//     there and dS's arithmetic runs under it.
//   * Loads. A 164-byte row is only 4-byte aligned, so neither a tensor map
//     nor a 16-byte copy can place rows where wgmma wants them, and 4-byte
//     cp.async straight into the tiles cost more issue time than all the
//     arithmetic (measured: half of a tile's cycles). But 64 rows of the
//     contiguous [T, p] matrix are one dense 10,496-byte run that starts
//     16-byte aligned: one thread asks the copy engine for it (cp.async.bulk,
//     counted on an mbarrier), it lands in a staging area while the block
//     works on the tile before, and the block then moves it into the
//     swizzled tile with conflict-free 4-byte shared-memory loads and
//     stores. A ragged last tile, a T p that is no multiple of 8 or
//     pointers that are not 16-byte aligned take 4-byte cp.async into the
//     same staging area, odd p plain 2-byte loads. The pad columns are
//     zeroed once, the rows beyond T of a last tile when it is moved.
//   * The causal comparison runs on the diagonal tile and on a last tile
//     with rows beyond T (in the forward and in dQ, the diagonal tile is
//     the only such tile); every other tile takes a path without it.
//   * Shared memory at P 96: 74,768 bytes (forward: four tiles, two
//     staging areas), 75,792 (backward). dK/dV needs 249 registers a
//     thread (two blocks an SM); dQ fits the 168 that three blocks allow
//     and the forward the 128 that two blocks of two warpgroups allow, so
//     one block's loads and exponentials hide behind another's products.
//     Heaviest blocks first in the grid (the forward puts its pairs of
//     query tiles on the grid's slow axis, so every head's longest rows
//     start before any short ones).
// What bounds them now (cycle counts of one block, PERF.md): moving the
// staged rows into the tiles (a quarter of a tile's time), the tensor
// cores waiting on a single warpgroup's serial phases, and the
// exponentials. 128-row tiles would halve the moves per product; a second
// warpgroup that loads while the first multiplies would hide them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_tiles.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kB = 64;              // query / key rows per tile
constexpr int kWarps = 4;           // 16 tile rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry: swizzled tiles and staging areas of 64 x P bf16
// each, buffers of 64 lse and 64 delta values (backward), the copies'
// barrier and room to start the tiles 1024-byte aligned.
template <int P> struct Geo {
  static constexpr int SWZ = kB * P * 2;    // a swizzled tile (mma_tiles.cuh)
  static constexpr int STATS = 2 * kB * 4;  // lse and delta of one tile
  // forward: two Q tiles, K and V tiles and two staging areas
  static constexpr int FWD = 6 * SWZ + 16 + 1024;
  // backward: four tiles, two staging areas, the stats (two buffers in
  // dK/dV, one in dQ)
  static constexpr int DKV = 6 * SWZ + 2 * STATS + 16 + 1024;
  static constexpr int DQ = 6 * SWZ + STATS + 16 + 1024;
  static constexpr int NT = P / 8;          // 8-column output tiles
};

// ---- shared pieces -------------------------------------------------------

// The kernels' dynamic shared memory, from its first 1024-byte boundary
// (the swizzled tiles need it).
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char tile_smem[];
  return tile_smem + ((1024u - tiles::smem_u32(tile_smem)) & 1023u);
}

// What a thread needs to fill its share of a swizzled tile of P columns a
// row at a time: warp w takes rows w, w + 4, ..., and lane l word l of the
// row's first 64 columns and word l of the rest. Rows 8 apart swizzle
// alike, so the offsets of rows w and w + 4 serve all sixteen.
template <int P>
struct RowCopy {
  static constexpr int W0 = tiles::block_cols<P, 0>();
  static constexpr int W1 = tiles::block_cols<P, 1>();
  int warp, lane;
  int off0[2], off1[2];      // element offsets of (w, 2l), (w + 4, 2l): block 0, 1

  __device__ __forceinline__ RowCopy()
      : warp(threadIdx.x / 32 % kWarps), lane(threadIdx.x % 32) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      off0[par] = tiles::tile_offset<P>(warp + 4 * par, (2 * lane) % W0);
      off1[par] = W1 > 0 ? tiles::tile_offset<P>(warp + 4 * par,
                                                 W0 + (2 * lane) % (W1 + !W1))
                         : 0;
    }
  }

  // The lane's word of row w + 4 n in block 0 and in block 1.
  __device__ __forceinline__ uint32_t* word0(bf16* tile, int n) const {
    return reinterpret_cast<uint32_t*>(tile + off0[n & 1] + (n >> 1) * 8 * W0);
  }
  __device__ __forceinline__ uint32_t* word1(bf16* tile, int n) const {
    return reinterpret_cast<uint32_t*>(tile + off1[n & 1] + (n >> 1) * 8 * W1);
  }
};

// This thread's index in its warpgroup: the moves below are a
// warpgroup's work.
__device__ __forceinline__ int wg_thread() { return threadIdx.x % kThreads; }

// Rows [row0, row0 + 64) of a contiguous [T, p] matrix, as they lie in
// device memory, into a staging area of 64 p elements, by a warpgroup:
// 4-byte cp.async where p is even and the pointers are 4-byte aligned
// (`width` >= 4), else plain 2-byte loads.
__device__ __forceinline__ void stage_rows(unsigned char* stage, const bf16* mat,
                                           int row0, int T, int p, int width) {
  const int elems = max(0, min(kB, T - row0)) * p;
  const bf16* src = mat + (size_t)row0 * p;
  if (width >= 4) {
    for (int i = wg_thread(); i < elems / 2; i += kThreads)
      tiles::cp_async4(stage + 4 * i, src + 2 * i);
  } else {
    for (int i = wg_thread(); i < elems; i += kThreads)
      reinterpret_cast<bf16*>(stage)[i] = src[i];
  }
}

// Whether the 64 rows from row0 go by one bulk copy: whole tiles where
// `copy_width` found every tile 16-byte aligned.
__device__ __forceinline__ bool bulk_tile(int row0, int T, int width) {
  return width == 16 && T - row0 >= kB;
}

// The tiles of rows [row0, row0 + 64) of two matrices into the two staging
// areas: a bulk copy each, asked for by one thread and counted on `bar`,
// or `stage_rows` by everyone.
__device__ __forceinline__ void stage_pair(unsigned char* stage0,
                                           unsigned char* stage1,
                                           const bf16* mat0, const bf16* mat1,
                                           int row0, int T, int p, int width,
                                           uint64_t* bar) {
  if (bulk_tile(row0, T, width)) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = kB * p * 2;
      tiles::mbar_expect(bar, 2 * bytes);
      tiles::bulk_copy(stage0, mat0 + (size_t)row0 * p, bytes, bar);
      tiles::bulk_copy(stage1, mat1 + (size_t)row0 * p, bytes, bar);
    }
  } else {
    stage_rows(stage0, mat0, row0, T, p, width);
    stage_rows(stage1, mat1, row0, T, p, width);
  }
}

// Wait for what `stage_pair` and this thread's cp.async copies brought;
// `phase` is the barrier's parity, flipped by every bulk pair awaited.
__device__ __forceinline__ void await_pair(int row0, int T, int width,
                                           uint64_t* bar, uint32_t& phase) {
  tiles::cp_async_wait<0>();
  if (bulk_tile(row0, T, width)) {
    tiles::mbar_wait(bar, phase);
    phase ^= 1;
  }
}

// The staged rows into a swizzled tile of P columns whose pad columns are
// zero already; rows from `rows` on become zeros. For even p a row goes a
// word a lane, read and written without bank conflicts, eight rows' loads
// ahead of their stores; loads and stores are PTX on 32-bit shared-memory
// addresses (base plus constant), the stores predicated, so that no branch
// and no 64-bit address arithmetic comes between them. A lane beyond the
// row's words loads what lies behind the row (still inside the block's
// shared memory) and stores nothing.
template <int P>
__device__ __forceinline__ void unstage(const RowCopy<P>& rc, bf16* tile,
                                        const unsigned char* stage, int rows,
                                        int p) {
  constexpr int W0 = RowCopy<P>::W0, W1 = RowCopy<P>::W1;
  if (p % 2 == 0) {
    const int words = p / 2, lane = rc.lane;
    const uint32_t step = 4 * kWarps * words;           // bytes from row to row
    const uint32_t t0 = tiles::smem_u32(tile);
    const uint32_t d0[2] = {t0 + 2 * rc.off0[0], t0 + 2 * rc.off0[1]};
    const uint32_t d1[2] = {t0 + 2 * rc.off1[0], t0 + 2 * rc.off1[1]};
    const int in0 = 2 * lane < W0 && lane < words;
    const int in1 = W1 > 0 && 2 * lane < W1 && W0 / 2 + lane < words;
    uint32_t src = tiles::smem_u32(stage) + 4 * (rc.warp * words + lane);
#pragma unroll
    for (int n0 = 0; n0 < kB / kWarps; n0 += 8) {
      uint32_t v0[8], v1[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v0[i] = tiles::lds32(src);
        if (W1 > 0) v1[i] = tiles::lds32(src + 2 * W0);
        src += step;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + i;
        const bool live = rc.warp + kWarps * n < rows;
        tiles::sts32_if(d0[n & 1] + (n >> 1) * 16 * W0, live ? v0[i] : 0u, in0);
        if (W1 > 0)
          tiles::sts32_if(d1[n & 1] + (n >> 1) * 16 * W1, live ? v1[i] : 0u,
                          in1);
      }
    }
  } else {
    const bf16* e = reinterpret_cast<const bf16*>(stage);
    for (int i = wg_thread(); i < kB * p; i += kThreads)
      tile[tiles::tile_offset<P>(i / p, i % p)] =
          i < rows * p ? e[i] : __float2bfloat16_rn(0.0f);
  }
}

// Zero the pad columns [p, P) of a tile, once: no copy writes them.
template <int P>
__device__ __forceinline__ void zero_pad(const RowCopy<P>& rc, bf16* tile,
                                         int p) {
  constexpr int W0 = RowCopy<P>::W0, W1 = RowCopy<P>::W1;
  if (p % 2 == 0) {
    const int words = p / 2, lane = rc.lane;
    const bool pad0 = 2 * lane < W0 && lane >= words;
    const bool pad1 = W1 > 0 && 2 * lane < W1 && W0 / 2 + lane >= words;
#pragma unroll
    for (int n = 0; n < kB / kWarps; ++n) {
      if (pad0) *rc.word0(tile, n) = 0u;
      if (pad1) *rc.word1(tile, n) = 0u;
    }
  } else {
    const int pad = P - p;
    for (int i = wg_thread(); i < kB * pad; i += kThreads)
      tile[tiles::tile_offset<P>(i / pad, p + i % pad)] =
          __float2bfloat16_rn(0.0f);
  }
}

// lse and delta of rows [row0, row0 + 64) into stats[0..64) and
// stats[64..128): threads 0-63 copy lse, 64-127 delta; zeros beyond T.
__device__ __forceinline__ void copy_stats(float* stats, const float* lse,
                                           const float* delta, int row0, int T) {
  const int i = threadIdx.x % kB, row = row0 + i;
  const float* src = threadIdx.x < kB ? lse : delta;
  if (row < T) tiles::cp_async4(stats + threadIdx.x, src + row);
  else stats[threadIdx.x] = 0.0f;
}

// Whether query `qi` attends to key `kv`, both inside the sequence.
__device__ __forceinline__ bool attends(int kv, int qi, int T) {
  return kv <= qi && qi < T && kv < T;
}

// P = exp(S scale - lse), computed as 2^(S scale log2e - lse log2e).
__device__ __forceinline__ float prob(float s, float scale_log2,
                                      float lse_log2) {
  return tiles::ex2(fmaf(s, scale_log2, -lse_log2));
}

// dS = P (dP - delta) scale
__device__ __forceinline__ float ds_of(float pv, float dp, float delta,
                                       float scale) {
  return pv * (dp - delta) * scale;
}

// The warp's 16 accumulator rows, from row0, into a bf16 [T, p] matrix;
// 4-byte stores where `pairs` (p even, 4-byte aligned output).
template <int P>
__device__ __forceinline__ void store_acc(bf16* out,
                                          const float (&acc)[P / 8][4],
                                          int row0, int T, int p, bool pairs,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= T) continue;
    bf16* o = out + (size_t)row * p;
#pragma unroll
    for (int n = 0; n < P / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (pairs) {
        if (col < p)
          *reinterpret_cast<uint32_t*>(o + col) =
              tiles::pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
      } else {
        if (col < p) o[col] = __float2bfloat16_rn(acc[n][2 * h]);
        if (col + 1 < p) o[col + 1] = __float2bfloat16_rn(acc[n][2 * h + 1]);
      }
    }
  }
}

// ---- forward --------------------------------------------------------------

// Two consumer warpgroups, one per 64-row query tile of the block's 128
// rows, share every staged K and V tile (warpgroup 0 moves K into its tile,
// warpgroup 1 V); each runs its own online softmax and O. 128 registers a
// thread: two blocks an SM.
template <int P>
__global__ void __launch_bounds__(2 * kThreads, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int p, float scale,
                 int width) {
  typedef Geo<P> G;
  constexpr int NT = G::NT, TILE = G::SWZ / 2;
  unsigned char* smem = aligned_smem();
  bf16* qs = reinterpret_cast<bf16*>(smem);      // two Q tiles
  bf16* ks = qs + 2 * TILE;
  bf16* vs = qs + 3 * TILE;
  unsigned char* stage0 = smem + 4 * G::SWZ;     // staging: Q0, then K tiles
  unsigned char* stage1 = smem + 5 * G::SWZ;     // staging: Q1, then V tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 6 * G::SWZ);
  uint32_t phase = 0;
  const RowCopy<P> rc;

  const int wg = threadIdx.x / kThreads;
  const int warp = threadIdx.x / 32 % kWarps, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qp = gridDim.y - 1 - blockIdx.y;     // longest rows first
  const int qt = 2 * qp + wg;                    // this warpgroup's tile
  // key tiles 0..last: the diagonal of the block's second tile, or the
  // sequence's last tile
  const int n_tiles = (T + kB - 1) / kB;
  const int last = min(2 * qp + 1, n_tiles - 1);
  const size_t base = (size_t)bh * T * p;
  const float scale_log2 = scale * kLog2e;
  bf16* my_q = qs + wg * TILE;
  unsigned char* my_stage = wg == 0 ? stage0 : stage1;

  auto fetch = [&](int j) {       // key tile j: K by warpgroup 0, V by 1
    if (bulk_tile(j * kB, T, width)) {
      if (threadIdx.x == 0) {
        const uint32_t bytes = kB * p * 2;
        tiles::mbar_expect(bar, 2 * bytes);
        tiles::bulk_copy(stage0, k + base + (size_t)j * kB * p, bytes, bar);
        tiles::bulk_copy(stage1, v + base + (size_t)j * kB * p, bytes, bar);
      }
    } else {
      stage_rows(my_stage, (wg == 0 ? k : v) + base, j * kB, T, p, width);
    }
    tiles::cp_async_commit();
  };

  // each warpgroup's Q tile through its staging area, once, by cp.async
  // (or plain loads)
  if (threadIdx.x == 0) tiles::mbar_init(bar);
  stage_rows(my_stage, q + base, qt * kB, T, p, width);
  tiles::cp_async_commit();
  if (p < P) {
    zero_pad<P>(rc, my_q, p);
    zero_pad<P>(rc, wg == 0 ? ks : vs, p);
  }
  tiles::cp_async_wait<0>();
  __syncthreads();
  unstage<P>(rc, my_q, my_stage, T - qt * kB, p);
  __syncthreads();                         // the staging is free again
  fetch(0);

  // per row of the lane (g, g + 8): the running max of S scale log2e and
  // the lane's share of the running sum (its 16 columns of each tile)
  const int qi0 = qt * kB + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o_acc[NT][4];                      // the warp's 16 queries x P, f32
  tiles::zero(o_acc);

  for (int j = 0; j <= last; ++j) {
    await_pair(j * kB, T, width, bar, phase);
    __syncthreads();     // tile j is staged; everyone is done with j - 1
    unstage<P>(rc, wg == 0 ? ks : vs, my_stage, T - j * kB, p);
    tiles::fence_async_proxy();
    __syncthreads();     // the tiles are whole; the staging is free again

    // warpgroup 0 has no work on the block's last tile, 2 qp + 1: it is
    // above that warpgroup's diagonal
    const bool active = j <= qt;
    float s[kB / 8][4];                    // S: 16 queries x 64 keys
    if (active) {
      tiles::wgmma_fence();
      tiles::wgmma_nt<P>(s, my_q, ks);           // S = Q K^T
      tiles::wgmma_commit();
    }
    // asked for while the tensor cores work; lands under this tile's work
    if (j < last) fetch(j + 1);
    if (!active) continue;
    tiles::wgmma_wait<0>();
    tiles::pin(s);
    if (j == qt) {                         // the diagonal tile, also the last
#pragma unroll
      for (int n = 0; n < kB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!attends(j * kB + 8 * n + 2 * t + (e & 1), qi0 + 8 * (e >> 1), T))
            s[n][e] = -INFINITY;
    }
    // online softmax in base 2: the rows' new max (over the lane's quad),
    // the rescale of what came before, P = 2^(S scale log2e - max)
    float mu[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kB / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      mu[h] = m_new == -INFINITY ? 0.0f : m_new;    // a row with no key yet
      alpha[h] = tiles::ex2(m[h] - mu[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < kB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = tiles::ex2(fmaf(s[n][e], scale_log2, -mu[e >> 1]));
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];
    uint32_t pa[kB / 16][4];
    tiles::as_a(pa, s);                    // P rounded to bf16 pairs
    tiles::pin(pa);
    tiles::pin(o_acc);
    tiles::wgmma_fence();
    tiles::wgmma_nn<P>(o_acc, pa, vs);           // O += P V
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::pin(o_acc);
  }
  // the rows' sums over the quad; o = O / l; lse = (max + log2 l) ln 2
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / l[h];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] *= inv[e >> 1];
  store_acc<P>(o + base, o_acc, qt * kB + warp * 16, T, p, width >= 4, lane);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qi0 + 8 * h < T)
        lse[(size_t)bh * T + qi0 + 8 * h] = (m[h] + log2f(l[h])) * kLn2;
}

// ---- backward: dK and dV -------------------------------------------------

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int p, float scale,
                     int width) {
  typedef Geo<P> G;
  constexpr int NT = G::NT, TILE = G::SWZ / 2;
  unsigned char* smem = aligned_smem();
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE;
  bf16* qs = ks + 2 * TILE;
  bf16* dos = ks + 3 * TILE;
  unsigned char* stage0 = smem + 4 * G::SWZ;     // staging: K then Q tiles
  unsigned char* stage1 = smem + 5 * G::SWZ;     // staging: V then dO tiles
  float* stats = reinterpret_cast<float*>(smem + 6 * G::SWZ);    // two buffers
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 6 * G::SWZ + 2 * G::STATS);
  uint32_t phase = 0;
  const RowCopy<P> rc;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int kt = blockIdx.x;             // low tiles have the most work
  const int k0 = kt * kB;
  const size_t base = (size_t)bh * T * p;
  const size_t row_base = (size_t)bh * T;
  const int n_qt = (T + kB - 1) / kB;
  const float scale_log2 = scale * kLog2e;

  auto fetch = [&](int it, int buf) {      // query tile `it` into the staging
    stage_pair(stage0, stage1, q + base, dout + base, it * kB, T, p, width, bar);
    copy_stats(stats + buf * 2 * kB, lse + row_base, delta + row_base, it * kB, T);
    tiles::cp_async_commit();
  };

  if (threadIdx.x == 0) tiles::mbar_init(bar);
  __syncthreads();
  stage_pair(stage0, stage1, k + base, v + base, k0, T, p, width, bar);
  tiles::cp_async_commit();
  if (p < P)
    for (int i = 0; i < 4; ++i) zero_pad<P>(rc, ks + i * TILE, p);
  await_pair(k0, T, width, bar, phase);
  __syncthreads();
  unstage<P>(rc, ks, stage0, T - k0, p);
  unstage<P>(rc, vs, stage1, T - k0, p);
  __syncthreads();                         // the staging is free again
  fetch(kt, 0);

  float dk_acc[NT][4], dv_acc[NT][4];    // the warp's 16 keys x P, f32
  tiles::zero(dk_acc);
  tiles::zero(dv_acc);
  const int key0 = k0 + warp * 16 + g;   // key of c0 and c1; c2, c3: key0 + 8

  for (int it = kt; it < n_qt; ++it) {
    const int buf = (it - kt) & 1, q0 = it * kB;
    await_pair(q0, T, width, bar, phase);
    __syncthreads();     // tile `it` is staged; everyone is done with it - 1
    const float* lse_s = stats + buf * 2 * kB;
    const float* delta_s = lse_s + kB;

    unstage<P>(rc, qs, stage0, T - q0, p);
    unstage<P>(rc, dos, stage1, T - q0, p);
    tiles::fence_async_proxy();
    __syncthreads();     // the tiles are whole; the staging is free again

    // S^T and dP^T as two groups, so that the exponentials run while the
    // tensor cores are on dP^T, and dS^T's arithmetic while they are on dV
    float st[kB / 8][4], dpt[kB / 8][4];   // S^T, dP^T: 16 keys x 64 queries
    tiles::wgmma_fence();
    tiles::wgmma_nt<P>(st, ks, qs);              // S^T = K Q^T
    tiles::wgmma_commit();
    tiles::wgmma_nt<P>(dpt, vs, dos);            // dP^T = V dO^T
    tiles::wgmma_commit();
    // asked for while the tensor cores work; lands under this tile's work
    if (it + 1 < n_qt) fetch(it + 1, buf ^ 1);
    tiles::wgmma_wait<1>();
    tiles::pin(st);
    // the comparison only where the tile meets the diagonal or the end
    const bool edge = it == kt || q0 + kB > T;
#pragma unroll
    for (int n = 0; n < kB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);   // the query: lse is its
        st[n][e] = prob(st[n][e], scale_log2, lse_s[col] * kLog2e);
        if (edge && !attends(key0 + 8 * (e >> 1), q0 + col, T)) st[n][e] = 0.0f;
      }
    uint32_t pa[kB / 16][4], dsa[kB / 16][4];
    tiles::as_a(pa, st);
    tiles::pin(pa);
    tiles::pin(dv_acc);
    tiles::wgmma_fence();
    tiles::wgmma_nn<P>(dv_acc, pa, dos);         // dV += P^T dO
    tiles::wgmma_commit();
    tiles::wgmma_wait<1>();                      // dP^T is there
    tiles::pin(dpt);
#pragma unroll
    for (int n = 0; n < kB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)                  // a masked P is 0: so is dS
        dpt[n][e] = ds_of(st[n][e], dpt[n][e],
                          delta_s[8 * n + 2 * t + (e & 1)], scale);
    tiles::as_a(dsa, dpt);
    tiles::pin(dsa);
    tiles::pin(dk_acc);
    tiles::wgmma_fence();
    tiles::wgmma_nn<P>(dk_acc, dsa, qs);         // dK += dS^T Q
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::pin(dv_acc);
    tiles::pin(dk_acc);
  }
  store_acc<P>(dk + base, dk_acc, k0 + warp * 16, T, p, width >= 4, lane);
  store_acc<P>(dv + base, dv_acc, k0 + warp * 16, T, p, width >= 4, lane);
}

// ---- backward: dQ ----------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int T, int p, float scale, int width) {
  typedef Geo<P> G;
  constexpr int NT = G::NT, TILE = G::SWZ / 2;
  unsigned char* smem = aligned_smem();
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + TILE;
  bf16* ks = qs + 2 * TILE;
  bf16* vs = qs + 3 * TILE;
  unsigned char* stage0 = smem + 4 * G::SWZ;     // staging: Q then K tiles
  unsigned char* stage1 = smem + 5 * G::SWZ;     // staging: dO then V tiles
  float* stats = reinterpret_cast<float*>(smem + 6 * G::SWZ);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 6 * G::SWZ + G::STATS);
  uint32_t phase = 0;
  const RowCopy<P> rc;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int q0 = qt * kB;
  const size_t base = (size_t)bh * T * p;
  const size_t row_base = (size_t)bh * T;
  const float scale_log2 = scale * kLog2e;

  auto fetch = [&](int j) {                // key tile `j` into the staging
    stage_pair(stage0, stage1, k + base, v + base, j * kB, T, p, width, bar);
    tiles::cp_async_commit();
  };

  if (threadIdx.x == 0) tiles::mbar_init(bar);
  __syncthreads();
  stage_pair(stage0, stage1, q + base, dout + base, q0, T, p, width, bar);
  copy_stats(stats, lse + row_base, delta + row_base, q0, T);
  tiles::cp_async_commit();
  if (p < P)
    for (int i = 0; i < 4; ++i) zero_pad<P>(rc, qs + i * TILE, p);
  await_pair(q0, T, width, bar, phase);
  __syncthreads();
  unstage<P>(rc, qs, stage0, T - q0, p);
  unstage<P>(rc, dos, stage1, T - q0, p);
  __syncthreads();                         // the staging is free again
  fetch(0);

  // loop-invariant: the lse and delta of this lane's two rows (g, g + 8)
  const int qi0 = q0 + warp * 16 + g;
  const float lse_log2[2] = {stats[warp * 16 + g] * kLog2e,
                             stats[warp * 16 + g + 8] * kLog2e};
  const float dl[2] = {stats[kB + warp * 16 + g], stats[kB + warp * 16 + g + 8]};

  float dq_acc[NT][4];                   // the warp's 16 queries x P, f32
  tiles::zero(dq_acc);

  for (int j = 0; j <= qt; ++j) {
    await_pair(j * kB, T, width, bar, phase);
    __syncthreads();     // tile j is staged; everyone is done with j - 1
    unstage<P>(rc, ks, stage0, T - j * kB, p);
    unstage<P>(rc, vs, stage1, T - j * kB, p);
    tiles::fence_async_proxy();
    __syncthreads();     // the tiles are whole; the staging is free again

    float s[kB / 8][4], dp[kB / 8][4];     // S, dP: 16 queries x 64 keys
    tiles::wgmma_fence();
    tiles::wgmma_nt<P>(s, qs, ks);               // S = Q K^T
    tiles::wgmma_commit();
    tiles::wgmma_nt<P>(dp, dos, vs);             // dP = dO V^T
    tiles::wgmma_commit();
    // asked for while the tensor cores work; lands under this tile's work
    if (j < qt) fetch(j + 1);
    tiles::wgmma_wait<1>();                      // exponentials under dP
    tiles::pin(s);
    const bool edge = j == qt;             // the diagonal tile, also the last
#pragma unroll
    for (int n = 0; n < kB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;                      // row g or g + 8
        s[n][e] = prob(s[n][e], scale_log2, lse_log2[h]);
        if (edge && !attends(j * kB + 8 * n + 2 * t + (e & 1), qi0 + 8 * h, T))
          s[n][e] = 0.0f;
      }
    tiles::wgmma_wait<0>();
    tiles::pin(dp);
#pragma unroll
    for (int n = 0; n < kB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)                  // a masked P is 0: so is dS
        dp[n][e] = ds_of(s[n][e], dp[n][e], dl[e >> 1], scale);
    uint32_t dsa[kB / 16][4];
    tiles::as_a(dsa, dp);
    tiles::pin(dsa);
    tiles::pin(dq_acc);
    tiles::wgmma_fence();
    tiles::wgmma_nn<P>(dq_acc, dsa, ks);         // dQ += dS K
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::pin(dq_acc);
  }
  store_acc<P>(dq + base, dq_acc, q0 + warp * 16, T, p, width >= 4, lane);
}

// Raise a kernel's dynamic shared-memory limit once, on its first launch
// (outside any CUDA-graph capture, since callers warm up before capturing).
template <auto Kernel>
int prepare(int smem) {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  return err;
}

// How a kernel may copy its tiles, as a width in bytes: 16 where every
// 64-row tile of every (batch, head) starts 16-byte aligned (T p a
// multiple of 8: whole tiles then go by bulk copies), 4 where only p is
// even, else 2.
int copy_width(std::initializer_list<const void*> ptrs, int T, int p) {
  uintptr_t bits = 0;
  for (const void* ptr : ptrs) bits |= reinterpret_cast<uintptr_t>(ptr);
  if (p % 2 == 0 && (T * p) % 8 == 0 && bits % 16 == 0) return 16;
  return p % 2 == 0 && bits % 4 == 0 ? 4 : 2;
}

template <int P>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int T, int p, float scale, cudaStream_t stream) {
  int err = prepare<flash_fwd_kernel<P>>(Geo<P>::FWD);
  if (err) return err;
  // pairs of query tiles on y, heaviest first, so that every (batch,
  // head)'s longest rows start before any short ones
  const dim3 grid(BH, ((T + kB - 1) / kB + 1) / 2);
  flash_fwd_kernel<P><<<grid, 2 * kThreads, Geo<P>::FWD, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), T, p, scale,
      copy_width({q, k, v, o}, T, p));
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int BH, int T,
        int p, float scale, cudaStream_t stream) {
  int err = prepare<flash_bwd_dkv_kernel<P>>(Geo<P>::DKV);
  if (err) return err;
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_bwd_dkv_kernel<P><<<grid, kThreads, Geo<P>::DKV, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, p, scale,
      copy_width({q, k, v, dout, dk, dv}, T, p));
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int BH, int T, int p,
       float scale, cudaStream_t stream) {
  int err = prepare<flash_bwd_dq_kernel<P>>(Geo<P>::DQ);
  if (err) return err;
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_bwd_dq_kernel<P><<<grid, kThreads, Geo<P>::DQ, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dqp), T, p, scale,
      copy_width({q, k, v, dout, dqp}, T, p));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int T, int p) { return BH < 1 || T < 1 || p < 1 || p > 128; }

}  // namespace

// C entry points (bound with ctypes). q, k, v, o, dout, dq, dk, dv: bf16
// [BH, T, p] contiguous; lse, delta: f32 [BH, T]. 1 <= p <= 128 (tiles are
// padded to 32, 64, 96 or 128 columns in shared memory). Each returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
#define FLASH_DISPATCH(CALL)                         \
  if (bad_shape(BH, T, p)) return static_cast<int>(cudaErrorInvalidValue); \
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);             \
  if (p <= 32) return CALL(32);                      \
  if (p <= 64) return CALL(64);                      \
  if (p <= 96) return CALL(96);                      \
  return CALL(128);

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int T, int p,
                                float scale, void* stream_ptr) {
#define CALL_FWD(P) fwd<P>(q, k, v, o, lse, BH, T, p, scale, stream)
  FLASH_DISPATCH(CALL_FWD)
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int BH, int T, int p,
                                    float scale, void* stream_ptr) {
#define CALL_DKV(P) dkv<P>(q, k, v, dout, lse, delta, dk, dv, BH, T, p, scale, stream)
  FLASH_DISPATCH(CALL_DKV)
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_out, int BH, int T, int p,
                                   float scale, void* stream_ptr) {
#define CALL_DQ(P) dq<P>(q, k, v, dout, lse, delta, dq_out, BH, T, p, scale, stream)
  FLASH_DISPATCH(CALL_DQ)
}
