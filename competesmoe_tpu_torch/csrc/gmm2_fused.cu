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
// the kernel moves 1.14 GB (xs in, out back, the f32 weights) against
// 1.42e11 FLOP, so the card's floor is the bytes (about 0.34 ms at
// 3.35 TB/s). What keeps it off device memory is the hidden activation:
// h [rows, ES] is never written out. The design:
//   * One block takes 128 rows (half a tile, so 2 blocks per tile and
//     4,224 blocks at the 154M shape, enough to fill 132 SMs) and all D
//     output columns. It computes h = relu(xs_tile @ keys[e]) for the
//     whole ES width first, keeps it in shared memory as bf16 (34 KB at
//     ES 128), then h @ values[e] in column chunks of 128. Splitting D
//     across blocks instead would recompute h once per split; keeping all
//     of D in the block reads every xs row once.
//   * The TPU keeps an expert's weights in VMEM across neighbouring tiles.
//     Here each block reads its expert's keys and values again (256 KB in
//     f32); neighbouring blocks of one expert find them in the 50 MB L2,
//     so device memory sees them about once per expert.
//   * Tensor cores (WMMA bf16 16x16x16, f32 accumulation). The weights
//     arrive as f32 (flax params) and are rounded to bf16 when staged into
//     shared memory. The TPU kernel promotes xs to f32 against f32
//     weights instead, so the two differ by the weights' bf16 rounding:
//     a relative error of about 2^-9 per product, which the checks bound
//     by 2^-6 * max|plain| on the output.
//   * h is rounded to xs's dtype (bf16) before the second product, as
//     `_gmm2_kernel` does with `.astype(xs_ref.dtype)`.
// Operands are staged with plain synchronous loads; cp.async/TMA
// pipelining and wgmma are later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 256;          // rows per expert-aligned tile
constexpr int kBM = 128;            // rows per block
constexpr int kBN = 128;            // columns per output chunk (h and out)
constexpr int kKC = 64;             // contraction chunk of the first GEMM
constexpr int kWarps = 8;           // 4 x 2 warp grid over a 128 x 128 chunk
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;             // bf16 row padding (keeps WMMA ldm % 8)
constexpr int kMaxES = 512;

constexpr int kXsLd = kKC + kPad;   // xs chunk [kBM][kXsLd]
constexpr int kWLd = kBN + kPad;    // weight chunk [rows][kWLd]

__host__ __device__ constexpr int align128(int b) { return (b + 127) & ~127; }

__host__ __device__ constexpr int smem_bytes(int es) {
  // h [kBM][es + kPad] bf16 | union{ xs chunk + keys chunk, values chunk }
  // | per-warp f32 staging [16][16]
  return align128(kBM * (es + kPad) * 2)
       + align128(kBM * kXsLd * 2 + kKC * kWLd * 2 > kBN * kWLd * 2
                      ? kBM * kXsLd * 2 + kKC * kWLd * 2
                      : kBN * kWLd * 2)
       + kWarps * 16 * 16 * 4;
}

__device__ __forceinline__ uint2 f4_to_bf16x4(float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&a);
  r.y = *reinterpret_cast<uint32_t*>(&b);
  return r;
}

// Stage a [rows x 128] f32 block of a row-major matrix (leading dim ld)
// into shared memory as bf16 with leading dim kWLd.
__device__ __forceinline__ void stage_weights(bf16* dst, const float* src,
                                              int rows, int ld) {
  const int vecs = rows * (kBN / 4);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    const int r = i / (kBN / 4);
    const int c = (i % (kBN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + (size_t)r * ld + c);
    *reinterpret_cast<uint2*>(dst + r * kWLd + c) = f4_to_bf16x4(v);
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

__global__ void __launch_bounds__(kThreads)
gmm2_kernel(const bf16* __restrict__ xs, const float* __restrict__ keys,
            const float* __restrict__ values,
            const int* __restrict__ tile_expert, bf16* __restrict__ out,
            int D, int ES) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h = reinterpret_cast<bf16*>(smem);
  unsigned char* region = smem + align128(kBM * (ES + kPad) * 2);
  bf16* xs_c = reinterpret_cast<bf16*>(region);
  bf16* k_c = reinterpret_cast<bf16*>(region + kBM * kXsLd * 2);
  bf16* v_c = reinterpret_cast<bf16*>(region);
  float* stage_all = reinterpret_cast<float*>(
      region + align128(kBM * kXsLd * 2 + kKC * kWLd * 2 > kBN * kWLd * 2
                            ? kBM * kXsLd * 2 + kKC * kWLd * 2
                            : kBN * kWLd * 2));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;            // 32-row band of the 128-row block
  const int wn = warp % 2;            // 64-column band of a 128-col chunk
  float* stage = stage_all + warp * 256;
  const int hld = ES + kPad;

  const size_t row0 = (size_t)blockIdx.x * kBM;
  const int e = tile_expert[row0 / kTile];
  const float* keys_e = keys + (size_t)e * D * ES;
  const float* values_e = values + (size_t)e * ES * D;
  const bf16* xs_b = xs + row0 * D;
  bf16* out_b = out + row0 * D;

  Acc acc[2][4];

  // ---- h = relu(xs @ keys[e]) -> bf16, kept in shared memory ----
  for (int n0 = 0; n0 < ES; n0 += kBN) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < D; k0 += kKC) {
      __syncthreads();
      for (int i = threadIdx.x; i < kBM * (kKC / 8); i += kThreads) {
        const int r = i / (kKC / 8);
        const int c = (i % (kKC / 8)) * 8;
        *reinterpret_cast<uint4*>(xs_c + r * kXsLd + c) =
            *reinterpret_cast<const uint4*>(xs_b + (size_t)r * D + k0 + c);
      }
      stage_weights(k_c, keys_e + (size_t)k0 * ES + n0, kKC, ES);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        FragA a[2];
        FragB b;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], xs_c + (wm * 32 + i * 16) * kXsLd + kk,
                                 kXsLd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(b, k_c + kk * kWLd + wn * 64 + j * 16, kWLd);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
    }
    // relu + round to bf16 into h (per fragment through the warp's staging)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = lane / 2, c = (lane % 2) * 8;
        bf16* dst = h + (wm * 32 + i * 16 + r) * hld + n0 + wn * 64 + j * 16 + c;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          dst[t] = __float2bfloat16_rn(fmaxf(stage[r * 16 + c + t], 0.0f));
        __syncwarp();
      }
  }

  // ---- out = h @ values[e], 128 output columns at a time ----
  for (int c0 = 0; c0 < D; c0 += kBN) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < ES; k0 += kBN) {
      __syncthreads();    // h complete / previous chunk consumed
      stage_weights(v_c, values_e + (size_t)k0 * D + c0, kBN, D);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kBN; kk += 16) {
        FragA a[2];
        FragB b;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], h + (wm * 32 + i * 16) * hld + k0 + kk,
                                 hld);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(b, v_c + kk * kWLd + wn * 64 + j * 16, kWLd);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = lane / 2, c = (lane % 2) * 8;
        __align__(16) bf16 vals[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) vals[t] = __float2bfloat16_rn(stage[r * 16 + c + t]);
        *reinterpret_cast<uint4*>(
            out_b + (size_t)(wm * 32 + i * 16 + r) * D + c0 + wn * 64 + j * 16 + c) =
            *reinterpret_cast<const uint4*>(vals);
        __syncwarp();
      }
  }
}

}  // namespace

// C entry point (bound with ctypes). xs: bf16 [S, D]; keys: f32 [E, D, ES];
// values: f32 [E, ES, D]; tile_expert: int32 [S / 256] with entries in
// [0, E); out: bf16 [S, D]. Requires S % 256 == 0, D % 128 == 0,
// ES % 128 == 0, ES <= 512 and 16-byte aligned pointers.
// Returns cudaGetLastError().
extern "C" int gmm2_launch(const void* xs, const void* keys,
                           const void* values, const void* tile_expert,
                           void* out, int S, int D, int ES,
                           void* stream_ptr) {
  if (S % kTile != 0 || D % kBN != 0 || ES % kBN != 0 || ES > kMaxES || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  // raise the shared-memory limit once, to what the largest ES needs, on
  // the first launch (outside any CUDA-graph capture)
  static const cudaError_t err = cudaFuncSetAttribute(
      gmm2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = smem_bytes(ES);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  gmm2_kernel<<<S / kBM, kThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const float*>(keys),
      static_cast<const float*>(values), static_cast<const int*>(tile_expert),
      static_cast<bf16*>(out), D, ES);
  return static_cast<int>(cudaGetLastError());
}
