// Fused grouped ReLU double GEMM over expert-aligned row tiles (K1), for
// Hopper (sm_90a):
//     out[r, :] = bf16( bf16(relu(xs[r, :] @ keys[e])) @ values[e] )
// where e = tile_expert[r / 256]: the rows are laid out so that each
// 256-row tile belongs to one expert (ops/gmm_fused.py `aligned_layout`).
//
// Replaces the Pallas TPU kernel competesmoe_tpu/ops/gmm_fused.py
// `gmm2_fused_aligned` / `_gmm2_kernel`.
//
// What bounds it: at the 154M shape (S' = 540,672 rows, D 512, ES 128)
// the kernel must move 1.14 GB (xs in, out back, the f32 weights) against
// 1.42e11 FLOP, so the card's floor is the bytes (about 0.34 ms at
// 3.35 TB/s; the tensor cores need 0.14 ms). What keeps it off device
// memory is the hidden activation: h [rows, ES] is never written out. The
// weights arrive as f32 flax parameters; the wrapper rounds them to bf16
// once per call (round to nearest even, as the kernel did on the fly
// before), which the kernel's time includes. The TPU kernel promotes xs to
// f32 against f32 weights instead, so the two differ by the weights' bf16
// rounding: a relative error of about 2^-9 per product, which the checks
// bound by 2^-6 * max|plain| on the output. h is rounded to xs's dtype
// (bf16) before the second product, as `_gmm2_kernel` does with
// `.astype(xs_ref.dtype)`.
//
// The design (helpers in mma_tiles.cuh and tensor_maps.cuh):
//   * A block takes half a 256-row tile with two consumer warpgroups of 64
//     rows each, which share every staged weight tile; a producer warp
//     keeps the copies in flight. (A whole tile with four warpgroups reads
//     the weights from L2 half as often, but was 3% slower:
//     chip_variants.py, PERF.md.) Blocks are persistent, one an SM: block
//     b takes units b, b + grid, ..., so neighbouring blocks work on
//     neighbouring rows and find the expert's weights in L2, and the ring
//     runs on from one unit into the next with no launch or ramp between
//     them.
//   * Everything arrives by 2D tensor-map copies (one request a box) into
//     a ring of 32 KB stages (6 at ES 128) on full / empty mbarriers:
//     first, for each 64 columns of D, the unit's xs box [128][64] and
//     keys[e]'s box [64 D][128 ES]; then, for each 64 output columns,
//     values[e]'s box [ES][64]. All land in the 128-byte swizzle that
//     wgmma reads. A warpgroup releases a stage once its products are
//     done (keeping one stage's products in flight while it issued the
//     next stage's gained nothing, PERF.md).
//   * h = relu(xs keys[e]) on wgmma m64n64k16 (xs K-major, keys MN-major
//     through the transpose bit), its f32 accumulator (64 registers) in
//     registers; relu and the bf16 rounding there, and the rounded pairs
//     are already the A operand of the second product (`tiles::as_a`):
//     h never touches shared memory.
//   * out = h values[e] in output chunks of 64 columns (32 accumulator
//     registers, values MN-major), a register-A wgmma per 16 ES rows;
//     each chunk is rounded to bf16 and goes out as 16-byte stores after
//     a transpose within each quad of lanes (no staging in shared
//     memory).
//   * ES of 256 to 512 keep h in 64 to 128 registers a thread (at four
//     warpgroups a block, ES 256 spilled; the 154M shape has ES 128). h is
//     computed 128 ES columns at a time, xs streamed once for each.
// Padding rows compute harmless values, as in JAX. No atomics: a second
// run gives the same bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tensor_maps.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 256;          // rows per expert-aligned tile
constexpr int kChunk = 64;          // D columns of a stage (both products)
constexpr int kHC = 128;            // ES columns of h computed at once
constexpr int kMaxES = 512;
constexpr int kRingBytes = 192 * 1024;

// Geometry for ES = 128 HC: GROUPS consumer warpgroups of 64 rows, a unit
// of ROWS rows (half a tile); the ring's stages: the xs box [ROWS][64] and the keys box
// [64][128] of the first product, or the values box(es) [ES][64] of the
// second, in a slot of SLOT bytes, STAGES of them.
template <int HC>
struct Geo {
  static constexpr int GROUPS = 2;
  static constexpr int ROWS = 64 * GROUPS;
  static constexpr int THREADS = 128 * GROUPS + 32;
  static constexpr int XS = ROWS * kChunk * 2;
  static constexpr int KEYS = kChunk * kHC * 2;
  static constexpr int VALUES = 128 * HC * kChunk * 2;
  static constexpr int SLOT = XS + KEYS > VALUES ? XS + KEYS : VALUES;
  static constexpr int STAGES = kRingBytes / SLOT;
  static constexpr int BARS = STAGES * SLOT;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
};

// Four 32-bit words across a quad of lanes (t = lane & 3), transposed:
// before, lane t holds word t of the quad's four 8-column n-tiles, v[i]
// from n-tile i; after, lane t holds the four words of n-tile t, in order.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool b0 = t & 1, b1 = t & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, b0 ? v[0] : v[1], 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, b0 ? v[2] : v[3], 1);
  if (b0) { v[0] = r0; v[2] = r1; } else { v[1] = r0; v[3] = r1; }
  r0 = __shfl_xor_sync(0xffffffffu, b1 ? v[0] : v[2], 2);
  r1 = __shfl_xor_sync(0xffffffffu, b1 ? v[1] : v[3], 2);
  if (b1) { v[0] = r0; v[1] = r1; } else { v[2] = r0; v[3] = r1; }
}

template <int HC>
__global__ void __launch_bounds__(Geo<HC>::THREADS, 1)
gmm2_kernel(const __grid_constant__ CUtensorMap xmap,   // xs [S, D]
            const __grid_constant__ CUtensorMap kmap,   // keys [E D, ES] bf16
            const __grid_constant__ CUtensorMap vmap,   // values [E ES, D] bf16
            const int* __restrict__ tile_expert, bf16* __restrict__ out,
            int units, int D, int vbox_rows) {
  typedef Geo<HC> G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - tiles::smem_u32(smem_raw)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BARS);
  uint64_t* empty = full + G::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = D / kChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      tiles::mbar_init(&full[s]);
      tiles::mbar_init(&empty[s], 4 * G::GROUPS);
    }
  }
  __syncthreads();

  if (warp == 4 * G::GROUPS) {
    // producer: every unit's stages in the consumers' order, each into
    // slot it % STAGES once the consumers are done with stage it - STAGES
    if (lane == 0) {
      tma::prefetch(&xmap);
      tma::prefetch(&kmap);
      tma::prefetch(&vmap);
      const uint64_t once = tma::evict_first(), shared = tma::evict_last();
      int it = 0;
      auto slot_for = [&](uint32_t bytes) {
        const int slot = it % G::STAGES;
        if (it >= G::STAGES) tiles::mbar_wait(&empty[slot], (it / G::STAGES - 1) & 1);
        tiles::mbar_expect(&full[slot], bytes);
        ++it;
        return slot;
      };
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int row0 = u * G::ROWS;
        const int e = tile_expert[row0 / kTile];
        for (int c = 0; c < HC; ++c)
          for (int k = 0; k < chunks; ++k) {
            const int slot = slot_for(G::XS + G::KEYS);
            unsigned char* stage = smem + slot * G::SLOT;
            tma::box(stage, &xmap, k * kChunk, row0, &full[slot], once);
            for (int b = 0; b < 2; ++b)
              tma::box(stage + G::XS + b * (G::KEYS / 2), &kmap,
                       c * kHC + b * 64, e * D + k * kChunk, &full[slot],
                       shared);
          }
        for (int d = 0; d < chunks; ++d) {
          const int slot = slot_for(G::VALUES);
          unsigned char* stage = smem + slot * G::SLOT;
          for (int b = 0; b * vbox_rows < 128 * HC; ++b)
            tma::box(stage + b * vbox_rows * kChunk * 2, &vmap, d * kChunk,
                     e * 128 * HC + b * vbox_rows, &full[slot], shared);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each unit; warp
  // w's rows 16 (w % 4) + g (+ 8) of those
  int it = 0;
  auto take = [&]() {           // the next stage, once it has landed
    const int slot = it % G::STAGES;
    tiles::mbar_wait(&full[slot], (it / G::STAGES) & 1);
    ++it;
    return slot;
  };
  auto give = [&](int slot) {   // its products are done: release it
    __syncwarp();
    if (lane == 0) tiles::mbar_arrive(&empty[slot]);
  };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    uint32_t ha[HC][kHC / 16][4];          // h, bf16 pairs: the A operand
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      float acc[kHC / 8][4];               // 64 rows x 128 ES columns
      tiles::zero(acc);
      for (int k = 0; k < chunks; ++k) {
        const int slot = take();
        const bf16* stage = reinterpret_cast<const bf16*>(smem + slot * G::SLOT);
        const uint64_t a = tiles::block_desc<64>(stage + wg * 64 * kChunk);
        const uint64_t b0 = tiles::block_desc<64>(stage + G::XS / 2);
        const uint64_t b1 = tiles::block_desc<64>(stage + (G::XS + G::KEYS / 2) / 2);
        tiles::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {   // 16 D columns: 32 bytes of xs, 16 keys rows
          tiles::WgmmaSS<64>::template run<0, 1, 0>(acc, a + 2 * kk, b0 + 128 * kk, 1);
          tiles::WgmmaSS<64>::template run<0, 1, 8>(acc, a + 2 * kk, b1 + 128 * kk, 1);
        }
        tiles::wgmma_commit();
        tiles::wgmma_wait<0>();
        tiles::pin(acc);
        give(slot);
      }
      // relu, then bf16 pairs that are the next product's A registers
#pragma unroll
      for (int n = 0; n < kHC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = fmaxf(acc[n][e], 0.0f);
      tiles::as_a(ha[c], acc);
      tiles::pin(ha[c]);
    }
    bf16* out_rows = out + ((size_t)u * G::ROWS + 64 * wg + 16 * (warp % 4) + g) * D;
    for (int d = 0; d < chunks; ++d) {
      const int slot = take();
      const bf16* stage = reinterpret_cast<const bf16*>(smem + slot * G::SLOT);
      const uint64_t b = tiles::block_desc<64>(stage);
      float acc[kChunk / 8][4];            // 64 rows x 64 output columns
      tiles::zero(acc);
      tiles::wgmma_fence();
#pragma unroll
      for (int c = 0; c < HC; ++c)
#pragma unroll
        for (int kk = 0; kk < kHC / 16; ++kk)        // 16 ES rows: 2048 bytes of values
          tiles::WgmmaRS<64>::template run<0>(acc, ha[c][kk],
                                               b + 128 * (kHC / 16 * c + kk));
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::pin(acc);
      give(slot);
      // rows g and g + 8: bf16 pairs, transposed within the quad so that
      // lane t holds 8 consecutive columns of n-tile 4 j + t
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = tiles::pack_bf16(acc[4 * j + i][2 * h], acc[4 * j + i][2 * h + 1]);
          quad_transpose(v, t);
          *reinterpret_cast<uint4*>(out_rows + (size_t)8 * h * D + d * kChunk +
                                    8 * (4 * j + t)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
    }
  }
}

template <int HC>
int launch(const void* xs, const void* keys, const void* values,
           const void* tile_expert, void* out, int S, int D, int E,
           cudaStream_t stream) {
  typedef Geo<HC> G;
  // raise the shared-memory limit once, on the first launch (outside any
  // CUDA-graph capture)
  static const cudaError_t set = cudaFuncSetAttribute(
      gmm2_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int ES = 128 * HC;
  const int vbox_rows = ES <= 256 ? ES : ES / 2;   // a box has at most 256 rows
  CUtensorMap xmap, kmap, vmap;
  if (!tma::bf16_map(&xmap, xs, S, D, G::ROWS) ||
      !tma::bf16_map(&kmap, keys, E * D, ES, kChunk) ||
      !tma::bf16_map(&vmap, values, E * ES, D, vbox_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int units = S / G::ROWS;
  const int grid = units < sms ? units : sms;
  gmm2_kernel<HC><<<grid, G::THREADS, G::SMEM, stream>>>(
      xmap, kmap, vmap, static_cast<const int*>(tile_expert),
      static_cast<bf16*>(out), units, D, vbox_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). xs: bf16 [S, D]; keys: bf16 [E, D,
// ES]; values: bf16 [E, ES, D]; tile_expert: int32 [S / 256] with entries
// in [0, E); out: bf16 [S, D]. Requires S % 256 == 0, D % 128 == 0,
// ES % 128 == 0, ES <= 512 and 16-byte aligned pointers. Returns the
// launch's error.
extern "C" int gmm2_launch(const void* xs, const void* keys,
                           const void* values, const void* tile_expert,
                           void* out, int S, int D, int ES, int E,
                           void* stream_ptr) {
  if (S % kTile != 0 || D % 128 != 0 || ES % kHC != 0 || ES > kMaxES ||
      S < 0 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (ES / kHC) {
    case 1: return launch<1>(xs, keys, values, tile_expert, out, S, D, E, stream);
    case 2: return launch<2>(xs, keys, values, tile_expert, out, S, D, E, stream);
    case 3: return launch<3>(xs, keys, values, tile_expert, out, S, D, E, stream);
    default: return launch<4>(xs, keys, values, tile_expert, out, S, D, E, stream);
  }
}
