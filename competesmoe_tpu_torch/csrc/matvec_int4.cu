// Packed-int4 small-M matmul for Hopper (sm_90a):
//     out[M, N] = bf16((x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale[N])
// where w_packed[K/2, N] holds two signed 4-bit weights per byte: the low
// nibble is row k of the original [K, N] matrix, the high nibble row
// k + K/2 (models/decoder.py pack_int4's split-half layout).
//
// Replaces the Pallas TPU kernel competesmoe_tpu/ops/matvec.py
// `quant_small_m_matmul_int4` / `_qmm4_kernel`.
//
// What bounds it: weight bytes. At decode (M = 1..8) every packed byte is
// read once and feeds 2*M multiply-adds, far below the card's compute
// rate, so the kernel is a weight stream. The design follows from that:
//   * Each thread reads 8 consecutive packed bytes (8 output columns) of
//     a row with one 8-byte load; a warp reads 256 contiguous bytes.
//   * The TPU kernel carries its f32 sum in scratch across a sequential K
//     grid axis. Hopper blocks run in parallel and carry nothing, so each
//     block loops over its own K range instead, and 4 K-lanes per block
//     split that range; the lanes' partial sums are combined in shared
//     memory in a fixed order.
//   * At M = 1 a 3072-wide output gives only 12 blocks of 256 columns,
//     far short of 132 SMs. The K dimension is therefore split across
//     blocks (grid.y). Each split writes f32 partial sums; a second,
//     deterministic pass adds the splits in order and applies the scale
//     (no atomics, so results do not change from run to run).
//   * Nibbles are decoded without int->float conversions (a quarter-rate
//     instruction): (nibble ^ 8) is the offset-binary code of the signed
//     value, OR-ing it into the mantissa of 2^23 and subtracting 2^23 + 8
//     yields exactly the sign-extended value that (v << 28) >> 28 (low)
//     and v >> 4 (high) give on a signed int.
//   * x rows for the block's K range are staged once in shared memory as
//     f32, so each weight byte costs one shared load per row of x.
// Rows of x beyond 8 are handled by grid.z (8 rows per block), which
// re-reads the weights per group of 8 rows; decode uses M <= 8.
//
// Accumulation is float32 and the scale is applied once per output in the
// epilogue, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsN = 32;                 // threads along N: one warp
constexpr int kLanesK = 4;                    // K-lanes per block
constexpr int kColsPerThread = 8;             // one 8-byte load per row
constexpr int kBlockN = kThreadsN * kColsPerThread;   // 256 columns
constexpr int kUnroll = 4;                    // rows in flight per lane
constexpr int kMaxRows = 8;                   // rows of x per block
constexpr int kMaxChunk = 256;                // packed rows per K split
constexpr int kSmemFloats = kLanesK * kMaxRows * kBlockN;   // 32 KB

static_assert(2 * kMaxChunk * kMaxRows <= kSmemFloats,
              "x staging must fit in the reduction buffer");

__device__ __forceinline__ float nibble_to_float(uint32_t bits) {
  // bits holds a nibble in its low 4 bits (higher bits ignored)
  const uint32_t code = (bits & 0xFu) ^ 0x4B000008u;   // 2^23 + (nibble^8)
  return __uint_as_float(code) - 8388616.0f;           // - (2^23 + 8)
}

template <int MT>
__global__ void __launch_bounds__(kThreadsN * kLanesK)
qmm4_kernel(const __nv_bfloat16* __restrict__ x,   // [M, 2*K2]
            const int8_t* __restrict__ w,           // [K2, N]
            const float* __restrict__ scale,        // [N]
            float* __restrict__ partial,            // [splits, M, N] or null
            __nv_bfloat16* __restrict__ out,        // [M, N]
            int M, int K2, int N, int chunk) {
  __shared__ __align__(16) float smem[kSmemFloats];

  const int tx = threadIdx.x;                       // 0..31 along N
  const int ty = threadIdx.y;                       // K-lane
  const int tid = ty * kThreadsN + tx;
  const int nthreads = kThreadsN * kLanesK;
  const int n0 = blockIdx.x * kBlockN + tx * kColsPerThread;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int rows = min(MT, M - m0);
  const int kbeg = split * chunk;
  const int kend = min(K2, kbeg + chunk);
  const int klen = kend - kbeg;
  const size_t K = 2 * static_cast<size_t>(K2);

  // Stage x[m0:m0+MT, kbeg:kend] (low half) and the matching high-half
  // columns as f32: xs[(kk*2 + half)*MT + m].
  float* xs = smem;
  for (int i = tid; i < klen * MT; i += nthreads) {
    const int kk = i / MT;
    const int m = i - kk * MT;
    float lo = 0.f, hi = 0.f;
    if (m < rows) {
      const __nv_bfloat16* xr = x + (m0 + m) * K + kbeg + kk;
      lo = __bfloat162float(xr[0]);
      hi = __bfloat162float(xr[K2]);
    }
    xs[(kk * 2) * MT + m] = lo;
    xs[(kk * 2 + 1) * MT + m] = hi;
  }
  __syncthreads();

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0.f;

  if (n0 < N) {
    for (int k = kbeg + ty; k < kend; k += kLanesK * kUnroll) {
      uint2 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kr = k + u * kLanesK;
        wv[u] = kr < kend
                    ? __ldg(reinterpret_cast<const uint2*>(
                          w + static_cast<size_t>(kr) * N + n0))
                    : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kr = k + u * kLanesK;
        if (kr < kend) {          // uniform across the warp (same ty)
          const float* xrow = xs + (kr - kbeg) * 2 * MT;
          float xl[MT], xh[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            xl[m] = xrow[m];
            xh[m] = xrow[MT + m];
          }
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const uint32_t word = c < 4 ? wv[u].x : wv[u].y;
            const int sh = 8 * (c & 3);
            const float lo = nibble_to_float(word >> sh);
            const float hi = nibble_to_float(word >> (sh + 4));
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][c] = fmaf(xh[m], hi, fmaf(xl[m], lo, acc[m][c]));
          }
        }
      }
    }
  }
  __syncthreads();   // xs is dead; reuse smem for the K-lane reduction

  // red[(ty*MT + m)*kBlockN + col]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      smem[(ty * MT + m) * kBlockN + tx * kColsPerThread + c] = acc[m][c];
  __syncthreads();

  for (int e = tid; e < MT * kBlockN; e += nthreads) {
    const int m = e / kBlockN;
    const int col = e - m * kBlockN;
    const int n = blockIdx.x * kBlockN + col;
    if (m >= rows || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < kLanesK; ++l) s += smem[(l * MT + m) * kBlockN + col];
    const size_t row = static_cast<size_t>(m0 + m);
    if (partial != nullptr) {
      partial[(static_cast<size_t>(split) * M + row) * N + n] = s;
    } else {
      out[row * N + n] = __float2bfloat16(s * scale[n]);
    }
  }
}

__global__ void qmm4_reduce(const float* __restrict__ partial,
                            const float* __restrict__ scale,
                            __nv_bfloat16* __restrict__ out, int splits,
                            int M, int N) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += partial[j * total + i];
  out[i] = __float2bfloat16(s * scale[i % N]);
}

template <int MT>
void launch(const void* x, const void* w, const void* scale, void* partial,
            void* out, int M, int K2, int N, int splits, int chunk,
            cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits, (M + MT - 1) / MT);
  const dim3 block(kThreadsN, kLanesK);
  qmm4_kernel<MT><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale),
      splits > 1 ? static_cast<float*>(partial) : nullptr,
      static_cast<__nv_bfloat16*>(out), M, K2, N, chunk);
}

}  // namespace

// C entry point (bound with ctypes). x: bf16 [M, 2*K2]; w: int8 [K2, N];
// scale: f32 [N]; partial: f32 [splits, M, N] scratch (unused when
// splits == 1); out: bf16 [M, N]. Requires N % 8 == 0, 8-byte aligned w,
// 1 <= chunk <= 256 and splits * chunk >= K2. Returns cudaGetLastError().
extern "C" int qmm4_launch(const void* x, const void* w, const void* scale,
                           void* partial, void* out, int M, int K2, int N,
                           int splits, int chunk, void* stream_ptr) {
  if (chunk < 1 || chunk > kMaxChunk || N % kColsPerThread != 0 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M == 1) {
    launch<1>(x, w, scale, partial, out, M, K2, N, splits, chunk, stream);
  } else if (M == 2) {
    launch<2>(x, w, scale, partial, out, M, K2, N, splits, chunk, stream);
  } else if (M <= 4) {
    launch<4>(x, w, scale, partial, out, M, K2, N, splits, chunk, stream);
  } else {
    launch<kMaxRows>(x, w, scale, partial, out, M, K2, N, splits, chunk,
                     stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  qmm4_reduce<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), splits, M, N);
  return static_cast<int>(cudaGetLastError());
}
