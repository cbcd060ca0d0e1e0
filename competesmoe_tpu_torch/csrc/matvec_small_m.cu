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
// K3 (the port's bf16 decoder stores nn.Linear.weight as [N, K] and passes
// its transposed view, so each output's K values are contiguous; the
// kernel reads that storage in place) computes out^T[N, M] = W[N, K] x^T on
// the tensor cores, the weight rows as the row operand:
//   * wgmma m64nNk16 (bf16, f32 accumulation), one warpgroup a block for
//     its 64 weight rows, with x^T the narrow operand: N = 8, 16, 24 or 32
//     columns cover every row of x at once, so every weight byte is read
//     once whatever M. Both operands are K-major boxes in shared memory
//     that the tensor cores read themselves: nothing is loaded into
//     registers but the accumulator (4 NT floats a thread). (mma.sync
//     m16n8k16 fed by ldmatrix was slower at every M: every warp loaded
//     the same x fragments, and at M 32 the loads held the ring back.)
//   * A ring of 4 shared-memory stages of 128 K columns: one producer
//     thread asks the copy engine for each stage as four boxes of 2D
//     tensor maps (64 columns, 128-byte rows, the 128-byte swizzle that
//     wgmma reads; two of 64 weight rows, two of the 8 NT rows of x) on
//     the stage's full barrier, as soon as the consumers release it (its
//     empty barrier, once the products that read it are done), so up to 4
//     stages of loads are in flight per block. Rows beyond N or M and
//     columns beyond K arrive as zeros. One box is one request: copies of
//     single 256-byte rows left the kernel bound by the copy engine's
//     request rate (time grew with the number of copies, not bytes). The
//     weights are read under an evict-first L2 policy and x under
//     evict-last: x is staged with every stage, from L2 (every block
//     reads it), because the whole of it does not fit (512 KB at M 32,
//     K 8192).
//   * Split K inside one launch: the S <= 8 blocks that share a block of
//     output rows and split K are one thread-block cluster. Each writes its
//     f32 partial tile into its drained ring; after a cluster barrier,
//     rank r sums rows [64 r / S, 64 (r + 1) / S) of every rank's tile
//     through distributed shared memory in rank order 0..S-1 (the ranks'
//     values loaded together, then added), rounds to bf16 and stores. No
//     second launch and no f32 partials in device memory. An unsplit K
//     (qkv and gate_up at the 5.1B shapes) stores its accumulators
//     straight from registers: the round trip through shared memory and
//     the cluster's barriers took time that grew with M.
// What bounds it now (PERF.md): device memory, as for torch.matmul; the
// smallest projection (o_proj) least close to it, where launch and ramp
// weigh most.

// K4's weight layout is JAX's [K, N] int8, N contiguous. As in K5
// (csrc/matvec_int4.cu), each thread owns 16 consecutive output columns
// and reads them with one 16-byte load per K row; 4 K-lanes per block
// split the block's K range and are summed in shared memory in a fixed
// order. x rows for the block's K range are staged once in shared memory
// as f32; rows of x come in groups of 8 per block (grid.z), a larger M
// re-reads the weights once per group. Where K is split across blocks
// (grid.y), each split writes f32 partial sums and a second, deterministic
// pass adds them in order. Bytes become floats without int->float
// conversions: (b ^ 0x80) is the offset-binary code of the signed byte,
// OR-ed into the mantissa of 2^23; subtracting 2^23 + 128 gives the value
// exactly. The scale is applied once per output in the epilogue, as in the
// TPU kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------------ K3
constexpr int kRows3 = 64;                     // weight rows per block
constexpr int kConsumers = 4;                  // one warpgroup
constexpr int kThreads3 = 32 * (kConsumers + 1);   // and a producer warp
constexpr int kBoxK = 64;                      // K columns of a copy's box
constexpr int kStageK = 2 * kBoxK;             // K columns per stage
constexpr int kStages = 4;                     // the ring's depth
constexpr int kMaxSplits = 8;                  // portable cluster size
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

// L2 policies: the weights are read once and go first; x is read by
// every block and stays.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// One box of a 2D tensor map (coordinates: column, row) into shared
// memory by the copy engine, counted on `bar`, under an L2 policy.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, uint64_t* bar,
                                        uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          tiles::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(tiles::smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

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
  float* red = reinterpret_cast<float*>(smem3);   // after the ring drains
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
      prefetch_map(&wmap);
      prefetch_map(&xmap);
      const uint64_t once = evict_first(), shared = evict_last();
      for (int it = 0; it < stages; ++it) {
        const int slot = it % kStages;
        if (it >= kStages) tiles::mbar_wait(&empty[slot], (it / kStages - 1) & 1);
        const int k0 = k_begin + it * kStageK;
        unsigned char* stage = smem3 + slot * G::STAGE;
        tiles::mbar_expect(&full[slot], G::STAGE);
        for (int b = 0; b < 2; ++b) {
          tma_box(stage + b * G::WBOX, &wmap, k0 + b * kBoxK, n0, &full[slot],
                  once);
          tma_box(stage + 2 * G::WBOX + b * G::XBOX, &xmap, k0 + b * kBoxK, 0,
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
  const int g = lane >> 2, t = lane & 3;
  if (splits == 1) {
    // no other split: the accumulators go straight out
    if (warp < kConsumers)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * warp + g + 8 * (e >> 1);
          const int m = 8 * nt + 2 * t + (e & 1);
          if (i < rows && m < M)
            out[(size_t)m * N + n0 + i] = __float2bfloat16_rn(acc[nt][e]);
        }
    return;
  }
  __syncthreads();          // the ring is drained: it takes the partials
  if (warp < kConsumers) {
    // red[m][i] for x row m, weight row i
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * nt + 2 * t + (e & 1)) * kRows3 + 16 * warp + g + 8 * (e >> 1)] =
            acc[nt][e];
  }

  // rank `split` sums its rows of every rank's partial tile, in rank
  // order; the ranks' values are loaded together, then added
  tiles::cluster_sync();
  const int i0 = kRows3 * split / splits, i1 = kRows3 * (split + 1) / splits;
  const int span = i1 - i0;
  for (int e = threadIdx.x; e < span * M; e += kThreads3) {
    const int i = i0 + e % span, m = e / span;
    if (i >= rows) continue;
    const float* part = red + m * kRows3 + i;
    float parts[kMaxSplits];
#pragma unroll
    for (int rank = 0; rank < kMaxSplits; ++rank)
      if (rank < splits) parts[rank] = tiles::ld_cluster_f32(part, rank);
    float sum = 0.0f;
#pragma unroll
    for (int rank = 0; rank < kMaxSplits; ++rank)
      if (rank < splits) sum += parts[rank];
    out[(size_t)m * N + n0 + i] = __float2bfloat16_rn(sum);
  }
  tiles::cluster_sync();    // no block leaves while another reads its tile
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda); null where the driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a contiguous bf16 [rows, cols] matrix read in boxes
// of `box_rows` rows x 64 columns, 128-byte swizzled, zeros beyond its
// bounds. False if the driver refuses it.
bool box_map(CUtensorMap* map, const void* base, int rows, int cols,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBoxK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------------ K4
constexpr int kMaxRows = 8;                         // rows of x (grid.z)
constexpr int kThreadsN = 32;                       // threads along N
constexpr int kLanesK = 4;                          // K-lanes per block
constexpr int kColsPerThread = 16;                  // one 16-byte load
constexpr int kBlockN4 = kThreadsN * kColsPerThread;   // 512 columns
constexpr int kUnroll = 4;                          // rows in flight a lane
constexpr int kMaxChunk = 256;                      // K rows per split

__device__ __forceinline__ float byte_to_float(uint32_t bits) {
  // bits holds a signed byte in its low 8 bits (higher bits ignored)
  const uint32_t code = (bits & 0xFFu) ^ 0x4B000080u;  // 2^23 + (b ^ 0x80)
  return __uint_as_float(code) - 8388736.0f;           // - (2^23 + 128)
}

template <int MT>
__global__ void __launch_bounds__(kThreadsN * kLanesK)
qmm8_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
            const int8_t* __restrict__ w,           // [K, N]
            const float* __restrict__ scale,        // [N]
            float* __restrict__ partial,            // [splits, M, N] or null
            __nv_bfloat16* __restrict__ out,        // [M, N]
            int M, int K, int N, int chunk) {
  __shared__ __align__(16) float xs[kMaxChunk * MT];
  __shared__ __align__(16) float red[kLanesK * kBlockN4];

  const int tx = threadIdx.x;                       // 0..31 along N
  const int ty = threadIdx.y;                       // K-lane
  const int tid = ty * kThreadsN + tx;
  const int nthreads = kThreadsN * kLanesK;
  const int n0 = blockIdx.x * kBlockN4 + tx * kColsPerThread;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int rows = min(MT, M - m0);
  const int kbeg = split * chunk;
  const int kend = min(K, kbeg + chunk);
  const int klen = kend - kbeg;

  // x[m0:m0+MT, kbeg:kend] as f32: xs[kk*MT + m]
  for (int i = tid; i < klen * MT; i += nthreads) {
    const int kk = i / MT;
    const int m = i - kk * MT;
    xs[i] = m < rows ? __bfloat162float(
                           x[static_cast<size_t>(m0 + m) * K + kbeg + kk])
                     : 0.f;
  }
  __syncthreads();

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int k = kbeg + ty; k < kend; k += kLanesK * kUnroll) {
      uint4 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kr = k + u * kLanesK;
        wv[u] = kr < kend ? __ldg(reinterpret_cast<const uint4*>(
                                w + static_cast<size_t>(kr) * N + n0))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kr = k + u * kLanesK;
        if (kr < kend) {          // uniform across the warp (same ty)
          const float* xrow = xs + (kr - kbeg) * MT;
          float xv[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) xv[m] = xrow[m];
          const uint32_t words[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const float wf = byte_to_float(words[c >> 2] >> (8 * (c & 3)));
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][c] = fmaf(xv[m], wf, acc[m][c]);
          }
        }
      }
    }
  }

  // sum the K-lanes row by row in shared memory, in lane order
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      red[ty * kBlockN4 + tx * kColsPerThread + c] = acc[m][c];
    __syncthreads();
    if (m >= rows) continue;      // uniform across the block
    const size_t row = static_cast<size_t>(m0 + m);
    for (int col = tid; col < kBlockN4; col += nthreads) {
      const int n = blockIdx.x * kBlockN4 + col;
      if (n >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < kLanesK; ++l) s += red[l * kBlockN4 + col];
      if (partial != nullptr)
        partial[(static_cast<size_t>(split) * M + row) * N + n] = s;
      else
        out[row * N + n] = __float2bfloat16(s * scale[n]);
    }
  }
}

// K4's second pass: add the splits in order, apply the scale and round to
// bf16
__global__ void splitk_reduce(const float* __restrict__ partial,
                              const float* __restrict__ scale,   // or null
                              __nv_bfloat16* __restrict__ out, int splits,
                              int M, int N) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += partial[j * total + i];
  if (scale != nullptr) s *= scale[i % N];
  out[i] = __float2bfloat16(s);
}

int reduce(const void* partial, const void* scale, void* out, int splits,
           int M, int N, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((total + threads - 1) / threads);
  splitk_reduce<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), splits, M, N);
  return static_cast<int>(cudaGetLastError());
}

// Raise a kernel's dynamic shared-memory limit once, on its first launch
// (outside any CUDA-graph capture, since callers warm up before capturing).
template <auto Kernel>
int prepare(int smem) {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  return err;
}

// K3's grid: a block per 64 weight rows (x) and K split (y); the splits of
// a block of rows are one cluster.
template <int NT>
int launch_mm(const void* x, const void* w, void* out, int M, int K, int N,
              int splits, int chunk, cudaStream_t stream) {
  int err = prepare<mm_bf16_kernel<NT>>(Geo3<NT>::SMEM);
  if (err) return err;
  CUtensorMap wmap, xmap;
  if (!box_map(&wmap, w, N, K, kRows3) || !box_map(&xmap, x, M, K, 8 * NT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kRows3 - 1) / kRows3, splits, 1);
  cfg.blockDim = dim3(kThreads3, 1, 1);
  cfg.dynamicSmemBytes = Geo3<NT>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, mm_bf16_kernel<NT>, wmap, xmap, static_cast<bf16*>(out), M, K,
      N, chunk));
}

template <int MT>
void launch_qmm(const void* x, const void* w, const void* scale,
                void* partial, void* out, int M, int K, int N, int splits,
                int chunk, cudaStream_t stream) {
  const dim3 grid((N + kBlockN4 - 1) / kBlockN4, splits, (M + MT - 1) / MT);
  const dim3 block(kThreadsN, kLanesK);
  qmm8_kernel<MT><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale),
      splits > 1 ? static_cast<float*>(partial) : nullptr,
      static_cast<__nv_bfloat16*>(out), M, K, N, chunk);
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
  if (M < 1 || M > kMaxM3 || N < 1 || K % 8 != 0 || chunk < 1 ||
      chunk % kStageK != 0 || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(splits) * chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch ((M + 7) / 8) {
    case 1: return launch_mm<1>(x, w, out, M, K, N, splits, chunk, stream);
    case 2: return launch_mm<2>(x, w, out, M, K, N, splits, chunk, stream);
    case 3: return launch_mm<3>(x, w, out, M, K, N, splits, chunk, stream);
    default: return launch_mm<4>(x, w, out, M, K, N, splits, chunk, stream);
  }
}

// C entry point of K4. x: bf16 [M, K]; w: int8 [K, N]; scale: f32 [N];
// partial: f32 [splits, M, N] scratch (unused when splits == 1); out: bf16
// [M, N]. Requires N % 16 == 0, 16-byte aligned w, 1 <= chunk <= 256 and
// splits * chunk >= K. Returns cudaGetLastError().
extern "C" int qmm8_launch(const void* x, const void* w, const void* scale,
                           void* partial, void* out, int M, int K, int N,
                           int splits, int chunk, void* stream_ptr) {
  if (M < 1 || N % kColsPerThread != 0 || chunk < 1 || chunk > kMaxChunk ||
      static_cast<long long>(splits) * chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M == 1) {
    launch_qmm<1>(x, w, scale, partial, out, M, K, N, splits, chunk, stream);
  } else if (M == 2) {
    launch_qmm<2>(x, w, scale, partial, out, M, K, N, splits, chunk, stream);
  } else if (M <= 4) {
    launch_qmm<4>(x, w, scale, partial, out, M, K, N, splits, chunk, stream);
  } else {
    launch_qmm<kMaxRows>(x, w, scale, partial, out, M, K, N, splits, chunk,
                         stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return reduce(partial, scale, out, splits, M, N, stream);
}
