// Small-M matmuls for decode on Hopper (sm_90a), two kernels:
//
//   K3  mm_bf16: out[M, N] = bf16(x[M, K] @ w[K, N])            (bf16 w)
//   K4  qmm8:    out[M, N] = bf16((x[M, K] @ w_q[K, N]) * scale[N]) (int8 w)
//
// both with float32 accumulation, x bf16, M <= 128.
//
// Replace the Pallas TPU kernels competesmoe_tpu/ops/matvec.py
// `small_m_matmul` / `_mm_kernel` (K3) and `quant_small_m_matmul` /
// `_qmm_kernel` (K4).
//
// What bounds them: weight bytes. At decode (M = 1..40) every weight byte
// is read once and feeds 2*M multiply-adds, far below the card's compute
// rate, so both kernels are weight streams. The design follows K5
// (csrc/matvec_int4.cu):
//   * The TPU kernels carry an f32 sum in scratch across a sequential K
//     grid axis. Hopper blocks run in parallel and carry nothing, so each
//     block loops over its own K range. Where the output alone gives too
//     few blocks to fill 132 SMs, K is split across blocks (grid.y); each
//     split writes f32 partial sums and a second, deterministic pass adds
//     them in order (no atomics: results do not change from run to run).
//   * Weights are read with 16-byte loads, neighbouring threads on
//     neighbouring addresses.
//   * Rows of x come in groups of 8 per block (grid.z); a larger M
//     re-reads the weights once per group (from L2 where they fit).
//
// K3's weight layout. The public function keeps JAX's [K, N], but the
// port's bf16 decoder stores nn.Linear.weight as [N, K] and passes its
// transposed view, so each output's K values are contiguous. The kernel
// reads that storage in place: a warp owns 4 outputs and walks K, each
// lane taking 8 consecutive bf16 (16 bytes) per output and step, then the
// warp's lanes are summed with shuffles. x is staged in shared memory in
// K chunks of 2048 (at M = 32 and K = 8192, x alone is 512 KB).
//
// K4's weight layout is JAX's [K, N] int8, N contiguous. As in K5, each
// thread owns 16 consecutive output columns and reads them with one
// 16-byte load per K row; 4 K-lanes per block split the block's K range
// and are summed in shared memory in a fixed order. x rows for the
// block's K range are staged once in shared memory as f32. Bytes become
// floats without int->float conversions: (b ^ 0x80) is the offset-binary
// code of the signed byte, OR-ed into the mantissa of 2^23; subtracting
// 2^23 + 128 gives the value exactly. The scale is applied once per output
// in the epilogue, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 8;        // rows of x per block (grid.z groups)

// ------------------------------------------------------------------ K3
constexpr int kWarps3 = 4;                          // warps per block
constexpr int kOutPerWarp = 4;                      // outputs per warp
constexpr int kBlockN3 = kWarps3 * kOutPerWarp;     // 16 outputs per block
constexpr int kVec = 8;                             // bf16 per 16-byte load
constexpr int kWarpK = 32 * kVec;                   // 256 K per warp step
constexpr int kStageK = 2048;                       // x staging chunk

__device__ __forceinline__ void bf16x8_to_float(const uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <int MT>
__global__ void __launch_bounds__(32 * kWarps3)
mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
               const __nv_bfloat16* __restrict__ wt,  // [N, K] (w's storage)
               float* __restrict__ partial,           // [splits, M, N] or null
               __nv_bfloat16* __restrict__ out,       // [M, N]
               int M, int K, int N, int chunk) {
  __shared__ __align__(16) __nv_bfloat16 xs[MT * kStageK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_base = blockIdx.x * kBlockN3 + warp * kOutPerWarp;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int rows = min(MT, M - m0);
  const int kbeg = split * chunk;
  const int kend = min(K, kbeg + chunk);

  float acc[MT][kOutPerWarp];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j) acc[m][j] = 0.f;

  for (int ks = kbeg; ks < kend; ks += kStageK) {
    const int klen = min(kStageK, kend - ks);
    const int vecs = klen / kVec;                 // K % 8 == 0
    __syncthreads();                              // the last chunk is used
    for (int i = tid; i < MT * vecs; i += 32 * kWarps3) {
      const int m = i / vecs;
      const int v = i - m * vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < rows)
        val = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m0 + m) * K + ks + v * kVec);
      *reinterpret_cast<uint4*>(xs + m * kStageK + v * kVec) = val;
    }
    __syncthreads();

    for (int kk = lane * kVec; kk < klen; kk += kWarpK) {
      float wf[kOutPerWarp][kVec];
#pragma unroll
      for (int j = 0; j < kOutPerWarp; ++j) {
        const int n = n_base + j;
        uint4 wv = make_uint4(0u, 0u, 0u, 0u);
        if (n < N)
          wv = __ldg(reinterpret_cast<const uint4*>(
              wt + static_cast<size_t>(n) * K + ks + kk));
        bf16x8_to_float(wv, wf[j]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xf[kVec];
        bf16x8_to_float(
            *reinterpret_cast<const uint4*>(xs + m * kStageK + kk), xf);
#pragma unroll
        for (int j = 0; j < kOutPerWarp; ++j)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[m][j] = fmaf(xf[e], wf[j][e], acc[m][j]);
      }
    }
  }

  // sum the warp's lanes (fixed butterfly order), lane 0 writes
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
      acc[m][j] = v;
    }
  if (lane != 0) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= rows) break;
    const size_t row = static_cast<size_t>(m0 + m);
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j) {
      const int n = n_base + j;
      if (n >= N) continue;
      if (partial != nullptr)
        partial[(static_cast<size_t>(split) * M + row) * N + n] = acc[m][j];
      else
        out[row * N + n] = __float2bfloat16(acc[m][j]);
    }
  }
}

// ------------------------------------------------------------------ K4
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

// the second pass of both kernels: add the splits in order, apply the
// scale (K4) and round to bf16
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

template <int MT>
void launch_mm(const void* x, const void* w, void* partial, void* out, int M,
               int K, int N, int splits, int chunk, cudaStream_t stream) {
  const dim3 grid((N + kBlockN3 - 1) / kBlockN3, splits, (M + MT - 1) / MT);
  mm_bf16_kernel<MT><<<grid, 32 * kWarps3, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      splits > 1 ? static_cast<float*>(partial) : nullptr,
      static_cast<__nv_bfloat16*>(out), M, K, N, chunk);
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
// of bf16 w[K, N] as a contiguous [N, K]; partial: f32 [splits, M, N]
// scratch (unused when splits == 1); out: bf16 [M, N]. Requires K % 8 == 0,
// 16-byte aligned x and w, chunk a multiple of 256 and splits * chunk >= K.
// Returns cudaGetLastError().
extern "C" int mm_bf16_launch(const void* x, const void* w, void* partial,
                              void* out, int M, int K, int N, int splits,
                              int chunk, void* stream_ptr) {
  if (M < 1 || K % kVec != 0 || chunk < 1 || chunk % kWarpK != 0 ||
      static_cast<long long>(splits) * chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M == 1) {
    launch_mm<1>(x, w, partial, out, M, K, N, splits, chunk, stream);
  } else if (M == 2) {
    launch_mm<2>(x, w, partial, out, M, K, N, splits, chunk, stream);
  } else if (M <= 4) {
    launch_mm<4>(x, w, partial, out, M, K, N, splits, chunk, stream);
  } else {
    launch_mm<kMaxRows>(x, w, partial, out, M, K, N, splits, chunk, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return reduce(partial, nullptr, out, splits, M, N, stream);
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
