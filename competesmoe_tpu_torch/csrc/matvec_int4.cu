// Packed-int4 small-M matmul (K5) for Hopper (sm_90a):
//     out[M, N] = bf16((x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale[N])
// with x bf16 [M <= 128, K], float32 accumulation and scale f32 [N]; the
// weights w_packed[K/2, N] (N contiguous) hold two signed 4-bit weights a
// byte: the low nibble is row k of the original [K, N] matrix, the high
// nibble row k + K/2 (models/decoder.py pack_int4's split-half layout, as
// JAX's QuantDense, `from_jax_params` and the plain path hold it; no
// second copy, no repacking).
//
// Replaces the Pallas TPU kernel competesmoe_tpu/ops/matvec.py
// `quant_small_m_matmul_int4` / `_qmm4_kernel`, and computes its function:
// each nibble is sign-extended and converted to bf16 exactly (bf16 holds
// every value of [-8, 7]), x stays exact bf16, the products are summed in
// float32 and the scale is applied once per output in a float32
// epilogue.
//
// What bounds it: the packed weight bytes. One decode step of the 5.1B
// decoder streams 56.6 MB of them, and every byte feeds 4 M multiply-adds:
// up to M 40 the card's memory rate is the limit by far; at M 128 the
// tensor cores' (about 29 us against 21 us of bytes for one layer's four
// projections). So every weight byte is read once per call, whatever M,
// in one launch, and the nibbles reach the tensor cores without a trip
// through shared memory:
//   * out^T[N, M] = W^T x^T on wgmma m64nNk16 (bf16, f32 accumulation),
//     the weights the 64-row A operand FROM REGISTERS and x^T the narrow
//     B operand (K-major, from shared memory), padded to the wgmma width:
//     8 at M 1-8, then 16, 24, 32, 40 (the verify tick of 8 slots x
//     (1 + 4) tokens), 64 and 128 (prefill groups; two n64 products).
//     Every row of x goes through the block in one pass.
//   * A block's consumer warpgroup owns 128 outputs, one 128-byte row of a
//     weight box, as two m64 tiles. Its thread (warp w, lane 4 g + t)
//     reads the 4-byte word 8 w + g of box rows 2t, 2t + 1, 2t + 8 and
//     2t + 9 of each 16-row k-step, and the word's four bytes are the
//     outputs of its A rows: tile 0 rows g and g + 8, tile 1 rows g and
//     g + 8 (of its warp's 16). So four 4-byte loads give the thread every
//     A register of both tiles, for the low and the high nibbles: nothing
//     is read twice or left over, and in the 128-byte swizzle the warp's
//     loads touch each bank once. Output n0 + 4 (8 w + g) + j is tile
//     j / 2, row g + 8 (j % 2); the epilogue writes the four as one 8-byte
//     store. (K4 converts its int8 weights into a bf16 tile in shared
//     memory instead, about 9 bytes of shared-memory traffic per weight
//     byte; here it is 2.)
//   * Nibbles to bf16 without int->float conversions (`to_bf16`): a byte
//     permute pairs the bytes of rows k and k + 1, a mask puts the nibble
//     n into the mantissa of the bf16 128 (0x4300 | (n ^ 8) = 136 + v for
//     the signed value v) and one bf16x2 subtraction of 136 leaves v
//     exactly: about 3 instructions per register of two weights.
//   * A k-step's four products (two tiles x low and high nibbles against
//     x[:, k] and x[:, K/2 + k]) go out as soon as it is converted, into
//     registers of its own: the four k-steps of a stage hold four sets,
//     the stage's products are one group, and the stage is released once
//     they are done. wgmma reads its A registers asynchronously, and
//     rewriting registers that a running product may still read (a
//     double buffer across stages) made ptxas serialize every product
//     (C7513), which was slower.
//   * The weights arrive by 2D tensor-map boxes (tensor_maps.cuh; one box
//     is one request) of 64 packed rows x 128 bytes, with the matching x
//     boxes x[:, k0:k0+64] and x[:, K/2+k0:K/2+k0+64] (two maps over x's
//     halves, zeros beyond K/2), on a ring of stages and full / empty
//     mbarriers fed by one producer thread; the weights under an
//     evict-first L2 policy, x under evict-last (every block reads it).
//   * Where the output blocks alone do not fill the card, the blocks that
//     share a block of outputs split K and form one thread-block cluster.
//     Rank r owns a share of the outputs: every rank writes its f32
//     partial sums of them from registers into the owner's receive tile
//     (distributed shared memory stores), and after one cluster barrier
//     the owner adds the ranks' sums in rank order 0..S-1, four outputs at
//     a time, scales and rounds them (`finish`). (Reading the other ranks'
//     tiles instead needed a second barrier and a round trip: about 1.4 us
//     more a layer at M 1, 9 us at M 128.) No second launch, no f32
//     partials in device memory and no atomics: a second run gives the
//     same bytes. An unsplit K stores straight from registers.
// What bounds it now (PERF.md): at M 1 to 40 a fixed cost of about 2.9 us
// a launch (a launch with no stages at all: 1.2 us of it any kernel's
// launch in a CUDA graph, about 1 us the cluster's barriers), the copy
// stream (about 80% of the memory rate with these boxes), and the
// conversion, about 2 integer instructions a weight byte, which the
// stream does not hide (about 8 us of a layer's four projections at
// M 1); at M 128 the x boxes, which every block of 128 outputs reads again
// from L2 (four times the weight bytes).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tensor_maps.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kOut = 128;          // outputs of a block: a weight box row
constexpr int kThreads = 128 + 32; // a consumer warpgroup and a producer warp
constexpr int kStageK = 64;        // packed rows of a stage: one x box a half
constexpr int kMaxM = 128;
constexpr int kMaxSplits = 8;      // portable cluster size

// Shared memory for NT 8-row tiles of x, from its first 1024-byte boundary
// (the 128-byte swizzle needs it): the ring, each stage one int8 box
// [64 K/2][128 n] and the x boxes of both halves [8 NT][64 K] (128-byte
// rows, 128-byte swizzle), as many stages as fit 64 KB (6 at M 1-8; two
// to six stages in flight streamed alike); then the tile that receives the
// cluster's partial sums of this rank's outputs, [S][8 NT][4 ceil(32 / S)]
// f32 for S splits (other ranks write it while this one may still stream,
// so it is not the ring); then each stage's full and empty barriers.
template <int NT>
struct Geo {
  static constexpr int WBOX = kStageK * kOut;
  static constexpr int XBOX = 8 * NT * 64 * 2;
  static constexpr int STAGE = WBOX + 2 * XBOX;
  static constexpr int FIT = 64 * 1024 / STAGE;
  static constexpr int STAGES = FIT < 2 ? 2 : FIT > 8 ? 8 : FIT;
  static constexpr int RECV = STAGES * STAGE;
  static constexpr int BARS = RECV + 8 * NT * (kOut + 4 * kMaxSplits) * 4;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
};

// The exact bf16 pair of the two nibbles n in bits 0-3 and 16-19 of `r`
// (other bits ignored): 0x4300 | (n ^ 8) is the bf16 128 + (n ^ 8) = 136 + v
// for the signed value v = (n ^ 8) - 8 (what (b << 28) >> 28 and b >> 4
// give on a signed byte b), and one bf16x2 subtraction of 136 leaves v.
__device__ __forceinline__ uint32_t to_bf16(uint32_t r) {
  uint32_t v = (r & 0x000F000Fu) ^ 0x43084308u;
  asm("sub.rn.bf16x2 %0, %0, %1;\n" : "+r"(v) : "r"(0x43084308u));
  return v;
}

// Words w0 and w1 of box rows k and k + 1 at the thread's column (bytes:
// tile 0 row r, tile 0 row r + 8, tile 1 row r, tile 1 row r + 8) as the A
// registers E (row r) and E + 1 (row r + 8) of the k pair, for each tile
// and for the low [0] and the high [1] nibbles.
template <int E>
__device__ __forceinline__ void unpack(uint32_t w0, uint32_t w1,
                                       uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
    // bytes 2 tile, 2 tile + 1 of w0, then of w1: each 16-bit half a k
    const uint32_t r = __byte_perm(w0, w1, tile ? 0x7632 : 0x5410);
    a[tile][0][E] = to_bf16(r);
    a[tile][0][E + 1] = to_bf16(r >> 8);
    a[tile][1][E] = to_bf16(r >> 4);
    a[tile][1][E + 1] = to_bf16(r >> 12);
  }
}

// d (+)= A b^T for one k-step: A from registers, b the [8 NT][16] slice
// of an x box at descriptor `b` (K-major); NT 8 and 16 as n64 products
// (rows 64 j on: 8 KB further into the box).
template <int NT>
__device__ __forceinline__ void product(float (&d)[NT][4],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NT <= 5) {
    tiles::WgmmaRS<8 * NT>::template run<0, 0>(d, a, b);
  } else {
    static_assert(NT == 8 || NT == 16, "x widths above 40 are 64 or 128");
    tiles::WgmmaRS<64>::template run<0, 0>(d, a, b);
    if constexpr (NT == 16) tiles::WgmmaRS<64>::template run<8, 0>(d, a, b + 512);
  }
}

// The block's accumulators, scaled and rounded to bf16: consumer thread
// (warp w, lane 4 g + t) holds outputs i .. i + 3, i = 32 w + 4 g (tile 0
// rows g, g + 8, tile 1 rows g, g + 8), for x rows 8 nt + 2 t (+ 1). Stored
// straight from registers for an unsplit K. Otherwise rank r of the S in
// the cluster owns the quads of outputs [32 r / S, 32 (r + 1) / S): every
// rank writes its partial sums of them into the owner's receive tile
// `recv` ([S][8 NT][4 ceil(32 / S)] f32, by distributed shared memory),
// and after one cluster barrier the owner adds the ranks' sums in rank
// order, a thread for each quad of outputs walking the rows of x. Every
// thread of the block calls it.
template <int NT>
__device__ __forceinline__ void finish(const float (&acc)[2][NT][4],
                                       float* recv,
                                       const float* __restrict__ scale,
                                       bf16* __restrict__ out, int n0,
                                       int rows, int M, int N, int split,
                                       int splits) {
  const int t = threadIdx.x & 3;
  const int i = 4 * (threadIdx.x / 4);
  const bool consumer = threadIdx.x < 128;
  if (splits == 1) {
    // no other split: the accumulators go straight out
    if (consumer && i < rows) {
      const float4 s = *reinterpret_cast<const float4*>(scale + n0 + i);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int m = 8 * nt + 2 * t + p;
          if (m < M)
            *reinterpret_cast<uint2*>(out + (size_t)m * N + n0 + i) = make_uint2(
                tiles::pack_bf16(acc[0][nt][p] * s.x, acc[0][nt][2 + p] * s.y),
                tiles::pack_bf16(acc[1][nt][p] * s.z, acc[1][nt][2 + p] * s.w));
        }
    }
    return;
  }
  const int stride = 4 * ((32 + splits - 1) / splits);   // floats a row
  tiles::cluster_wait();    // every block of the cluster has started
  if (consumer) {
    // recv[split][m][4 (i / 4 - first quad of owner r)] of owner r
    const int quad = i / 4, owner = ((quad + 1) * splits - 1) / 32;
    float* mine = recv + split * 8 * NT * stride + 4 * (quad - 32 * owner / splits);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int m = 8 * nt + 2 * t + p;
        if (m < M)
          tiles::st_cluster_f32x4(
              mine + m * stride, owner,
              make_float4(acc[0][nt][p], acc[0][nt][2 + p], acc[1][nt][p],
                          acc[1][nt][2 + p]));
      }
  }
  tiles::cluster_sync();    // every rank's sums are in place
  const int q0 = 32 * split / splits, quads = 32 * (split + 1) / splits - q0;
  const int o = 4 * (q0 + threadIdx.x % quads);
  if (o < rows && threadIdx.x < kThreads / quads * quads) {
    const float4 s = *reinterpret_cast<const float4*>(scale + n0 + o);
    const float* part = recv + o - 4 * q0;
    for (int m = threadIdx.x / quads; m < M; m += kThreads / quads) {
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int rank = 0; rank < splits; ++rank) {
        const float4 v = *reinterpret_cast<const float4*>(
            part + (rank * 8 * NT + m) * stride);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<uint2*>(out + (size_t)m * N + n0 + o) =
          make_uint2(tiles::pack_bf16(sum.x * s.x, sum.y * s.y),
                     tiles::pack_bf16(sum.z * s.z, sum.w * s.w));
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
qmm4_kernel(const __grid_constant__ CUtensorMap wmap,   // int8 w [K/2, N]
            const __grid_constant__ CUtensorMap xlo,    // x[:, :K/2]
            const __grid_constant__ CUtensorMap xhi,    // x[:, K/2:]
            const float* __restrict__ scale,            // [N]
            bf16* __restrict__ out,                     // [M, N]
            int M, int K2, int N, int chunk) {
  typedef Geo<NT> G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - tiles::smem_u32(smem_raw)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BARS);
  uint64_t* empty = full + G::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kOut;
  const int rows = min(kOut, N - n0);
  // the cluster is the grid's y extent: this block's rank is its split
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_first = split * chunk;
  const int k_stop = min(K2, k_first + chunk);
  const int n_stages =
      k_stop > k_first ? (k_stop - k_first + kStageK - 1) / kStageK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      tiles::mbar_init(&full[s]);
      tiles::mbar_init(&empty[s], 4);
    }
  }
  __syncthreads();
  // the first half of the barrier after which `finish` may write into the
  // other blocks of the cluster (all of them have started)
  if (splits > 1) tiles::cluster_arrive_relaxed();

  float acc[2][NT][4];   // [m64 tile][x rows 8 nt .. 8 nt + 7][C fragment]
  if (warp == 4) {
    // producer: stage `it` into slot it % STAGES once the consumers are
    // done with stage it - STAGES
    if (lane == 0) {
      tma::prefetch(&wmap);
      tma::prefetch(&xlo);
      tma::prefetch(&xhi);
      const uint64_t w_policy = tma::evict_first();
      const uint64_t x_policy = tma::evict_last();
      for (int it = 0; it < n_stages; ++it) {
        const int slot = it % G::STAGES;
        if (it >= G::STAGES)
          tiles::mbar_wait(&empty[slot], (it / G::STAGES - 1) & 1);
        const int k0 = k_first + it * kStageK;
        unsigned char* stage = smem + slot * G::STAGE;
        tiles::mbar_expect(&full[slot], G::STAGE);
        tma::box(stage, &wmap, n0, k0, &full[slot], w_policy);
        tma::box(stage + G::WBOX, &xlo, k0, 0, &full[slot], x_policy);
        tma::box(stage + G::WBOX + G::XBOX, &xhi, k0, 0, &full[slot],
                 x_policy);
      }
    }
  } else {
    // consumers, one warpgroup: per k-step of 16 packed rows, four 4-byte
    // loads give the A registers of both tiles and nibble halves, and its
    // four products go out; a stage's 16 products are one group, and the
    // stage is released once they are done
    const int g = lane >> 2, t = lane & 3;
    const int q = 8 * warp + g;           // the thread's word of a box row
    // byte offsets of its word in box rows 2t and 2t + 1 (swizzled)
    const uint32_t even =
        2 * t * kOut + ((((q >> 2) ^ (2 * t)) << 4) | ((q & 3) << 2));
    const uint32_t odd =
        (2 * t + 1) * kOut + ((((q >> 2) ^ (2 * t + 1)) << 4) | ((q & 3) << 2));
    tiles::zero(acc[0]);
    tiles::zero(acc[1]);
    for (int it = 0; it < n_stages; ++it) {
      const int slot = it % G::STAGES;
      tiles::mbar_wait(&full[slot], (it / G::STAGES) & 1);
      const unsigned char* stage = smem + slot * G::STAGE;
      const uint32_t wbox = tiles::smem_u32(stage);
      const bf16* xs = reinterpret_cast<const bf16*>(stage + G::WBOX);
      uint32_t a[kStageK / 16][2][2][4];   // [k-step][tile][low, high nibbles][register]
      const uint64_t lo = tiles::block_desc<64>(xs);
      const uint64_t hi = tiles::block_desc<64>(xs + G::XBOX / 2);
#pragma unroll
      for (int kk = 0; kk < kStageK / 16; ++kk) {   // 16 columns: 32 bytes
        const uint32_t row = wbox + kk * 16 * kOut;
        unpack<0>(tiles::lds32(row + even), tiles::lds32(row + odd), a[kk]);
        unpack<2>(tiles::lds32(row + even + 8 * kOut),
                  tiles::lds32(row + odd + 8 * kOut), a[kk]);
        tiles::wgmma_fence();
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          product<NT>(acc[tile], a[kk][tile][0], lo + 2 * kk);
          product<NT>(acc[tile], a[kk][tile][1], hi + 2 * kk);
        }
      }
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::pin(acc[0]);
      tiles::pin(acc[1]);
      __syncwarp();
      if (lane == 0) tiles::mbar_arrive(&empty[slot]);
    }
  }
  finish<NT>(acc, reinterpret_cast<float*>(smem + G::RECV), scale, out, n0,
             rows, M, N, split, splits);
}

template <int NT>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K2, int N, int splits, int chunk, cudaStream_t stream) {
  typedef Geo<NT> G;
  int err = tiles::prepare<qmm4_kernel<NT>>(G::SMEM);
  if (err) return err;
  CUtensorMap wmap, xlo, xhi;
  if (!tma::matrix_map(&wmap, w, K2, N, kStageK, kOut, 1,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tma::matrix_map(&xlo, x, M, K2, 8 * NT, 64, 2,
                       CU_TENSOR_MAP_SWIZZLE_128B, 2 * K2) ||
      !tma::matrix_map(&xhi, static_cast<const bf16*>(x) + K2, M, K2, 8 * NT,
                       64, 2, CU_TENSOR_MAP_SWIZZLE_128B, 2 * K2))
    return static_cast<int>(cudaErrorInvalidValue);
  return tiles::launch_clusters(qmm4_kernel<NT>, kOut, kThreads, G::SMEM, N,
                                splits, stream, wmap, xlo, xhi,
                                static_cast<const float*>(scale),
                                static_cast<bf16*>(out), M, K2, N, chunk);
}

}  // namespace

// C entry point (bound with ctypes). x: bf16 [M, 2 K2]; w: int8 [K2, N],
// N contiguous; scale: f32 [N]; out: bf16 [M, N]. Requires 1 <= M <= 128,
// K2 % 8 == 0, N % 16 == 0, 16-byte aligned x, w and scale, chunk a
// multiple of 64, 1 <= splits <= 8 and splits * chunk >= K2. One launch;
// returns the launch's error.
extern "C" int qmm4_launch(const void* x, const void* w, const void* scale,
                           void* out, int M, int K2, int N, int splits,
                           int chunk, void* stream_ptr) {
  if (M < 1 || M > kMaxM || K2 < 8 || K2 % 8 != 0 || N < 16 || N % 16 != 0 ||
      chunk < 1 || chunk % kStageK != 0 || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(splits) * chunk < K2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nt = (M + 7) / 8;
  if (nt <= 1) return launch<1>(x, w, scale, out, M, K2, N, splits, chunk, stream);
  if (nt <= 2) return launch<2>(x, w, scale, out, M, K2, N, splits, chunk, stream);
  if (nt <= 3) return launch<3>(x, w, scale, out, M, K2, N, splits, chunk, stream);
  if (nt <= 4) return launch<4>(x, w, scale, out, M, K2, N, splits, chunk, stream);
  if (nt <= 5) return launch<5>(x, w, scale, out, M, K2, N, splits, chunk, stream);
  if (nt <= 8) return launch<8>(x, w, scale, out, M, K2, N, splits, chunk, stream);
  return launch<16>(x, w, scale, out, M, K2, N, splits, chunk, stream);
}
