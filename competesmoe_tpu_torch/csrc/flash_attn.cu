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
// operations are close (51 vs 44 us at the card's peaks). The design keeps
// the [T, T] scores out of device memory, which is what the TPU kernel
// does too, and skips every key tile above the diagonal:
//   * One block of 4 warps takes 64 query rows of one (batch, head); each
//     warp owns 16 rows. The block walks the key tiles of 64 up to its
//     diagonal with an online softmax in f32 (running max m and sum l per
//     row). Blocks carry nothing between them, so the TPU's sequential
//     key-grid axis becomes this loop.
//   * Head size 82 is no multiple of the tensor cores' 16. Tiles are held
//     in shared memory padded with zeros to 96 columns (P = 32, 64, 96 or
//     128 by template); loads and stores are masked to the true p, so
//     device memory is never padded.
//   * Products run on tensor cores (WMMA bf16 16x16x16, f32 accumulation).
//     The probabilities are rounded to bf16 before the P v product, as the
//     einsum path rounds `probs.astype(v.dtype)`. The output accumulator
//     lives in shared memory (f32), where the per-row rescale by
//     exp(m_old - m_new) is a plain loop.
//   * Backward, as the TPU splits it: delta = rowsum(dO * o) in plain
//     PyTorch; `flash_bwd_dkv` (one block per 64-key tile, looping over the
//     query tiles at and below the diagonal) and `flash_bwd_dq` (one block
//     per 64-query tile, looping over the key tiles up to the diagonal).
//     Each gradient is summed by one block in a fixed order: no atomics,
//     so results repeat bit for bit. dS is rounded to bf16 before its two
//     products (the usual flash-attention choice).
// Tiles are staged with plain loads; cp.async/TMA pipelining and wgmma,
// and register-resident accumulators, are later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kB = 64;              // query / key rows per tile
constexpr int kWarps = 4;           // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kSLd = kB + 4;        // f32 score rows
constexpr int kPLd = kB + 8;        // bf16 probability rows

__host__ __device__ constexpr int align128(int b) { return (b + 127) & ~127; }

template <int P> struct Geo {
  static constexpr int LD = P + 8;          // bf16 tile rows
  static constexpr int OLD = P + 4;         // f32 accumulator rows
  static constexpr int TILE = align128(kB * LD * 2);
  static constexpr int ACC = align128(kB * OLD * 4);
  static constexpr int SCORES = align128(kWarps * 16 * kSLd * 4);
  static constexpr int PROBS = align128(kB * kPLd * 2);
  static constexpr int ROWS = align128(2 * kB * 4);
  static constexpr int FWD = 3 * TILE + SCORES + PROBS + ACC;
  static constexpr int DKV = 4 * TILE + 2 * ACC + 2 * SCORES + 2 * PROBS + ROWS;
  static constexpr int DQ = 4 * TILE + ACC + 2 * SCORES + PROBS + ROWS;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

// Rows [row0, row0 + 64) of a contiguous [T, p] matrix into a [64][LD]
// shared tile, zero-filled beyond p columns and beyond T rows. The source
// rows are contiguous, so consecutive threads read consecutive addresses.
template <int P>
__device__ void load_tile(bf16* dst, const bf16* src, int row0, int T, int p) {
  constexpr int LD = Geo<P>::LD;
  const int rows = max(0, min(kB, T - row0));
  const bf16* s = src + (size_t)row0 * p;
  if ((p & 1) == 0) {
    const int words = rows * p / 2;
    const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(s);
    for (int i = threadIdx.x; i < words; i += kThreads) {
      const int r = (2 * i) / p, c = (2 * i) % p;
      *reinterpret_cast<__nv_bfloat162*>(dst + r * LD + c) = s2[i];
    }
  } else {
    for (int i = threadIdx.x; i < rows * p; i += kThreads)
      dst[(i / p) * LD + i % p] = s[i];
  }
  const bf16 zero = __float2bfloat16_rn(0.0f);
  if (P > p)
    for (int i = threadIdx.x; i < rows * (P - p); i += kThreads)
      dst[(i / (P - p)) * LD + p + i % (P - p)] = zero;
  for (int i = threadIdx.x; i < (kB - rows) * P; i += kThreads)
    dst[(rows + i / P) * LD + i % P] = zero;
}

// out[16 x 64] (f32, ld kSLd) = A_rows[16 x P] @ B_rows[64 x P]^T
template <int P>
__device__ __forceinline__ void qk_t(float* out, const bf16* a, const bf16* b) {
  constexpr int LD = Geo<P>::LD;
#pragma unroll
  for (int n = 0; n < kB / 16; ++n) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < P; kk += 16) {
      ARow fa;
      BCol fb;
      wmma::load_matrix_sync(fa, a + kk, LD);
      wmma::load_matrix_sync(fb, b + n * 16 * LD + kk, LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, kSLd, wmma::mem_row_major);
  }
}

// acc[16 x P] (f32 in shared memory, ld OLD) += A[16 x 64] @ B[64 x P];
// A is bf16 with leading dim kPLd, row-major (a_col false) or the
// transpose of a row-major [64][kPLd] block (a_col true); B row-major.
template <int P, bool ACOL>
__device__ __forceinline__ void acc_av(float* acc_s, const bf16* a,
                                       const bf16* b) {
  constexpr int LD = Geo<P>::LD;
  constexpr int OLD = Geo<P>::OLD;
#pragma unroll
  for (int n = 0; n < P / 16; ++n) {
    Acc acc;
    wmma::load_matrix_sync(acc, acc_s + n * 16, OLD, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      BRow fb;
      wmma::load_matrix_sync(fb, b + kk * LD + n * 16, LD);
      if (ACOL) {
        ACol fa;
        wmma::load_matrix_sync(fa, a + kk * kPLd, kPLd);
        wmma::mma_sync(acc, fa, fb, acc);
      } else {
        ARow fa;
        wmma::load_matrix_sync(fa, a + kk, kPLd);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(acc_s + n * 16, acc, OLD, wmma::mem_row_major);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int p, float scale) {
  typedef Geo<P> G;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + G::TILE);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * G::TILE);
  float* scores = reinterpret_cast<float*>(smem + 3 * G::TILE);
  bf16* probs = reinterpret_cast<bf16*>(smem + 3 * G::TILE + G::SCORES);
  float* oacc = reinterpret_cast<float*>(smem + 3 * G::TILE + G::SCORES + G::PROBS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int q0 = qt * kB;
  const size_t base = (size_t)bh * T * p;
  const int qi = q0 + warp * 16 + r;

  float* s_w = scores + warp * 16 * kSLd;
  bf16* p_w = probs + warp * 16 * kPLd;
  float* o_w = oacc + warp * 16 * G::OLD;

  load_tile<P>(qs, q + base, q0, T, p);
  for (int c = half * (P / 2); c < (half + 1) * (P / 2); ++c) o_w[r * G::OLD + c] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int j = 0; j <= qt; ++j) {
    __syncthreads();
    load_tile<P>(ks, k + base, j * kB, T, p);
    load_tile<P>(vs, v + base, j * kB, T, p);
    __syncthreads();
    qk_t<P>(s_w, qs + warp * 16 * G::LD, ks);
    __syncwarp();
    float* srow = s_w + r * kSLd + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int kv = j * kB + half * 32 + c;
      const float s = (kv <= qi && kv < T) ? srow[c] * scale : -INFINITY;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float sum = 0.0f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float pv = __expf(srow[c] - m_new);
      sum += pv;
      p_w[r * kPLd + half * 32 + c] = __float2bfloat16_rn(pv);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    for (int c = half * (P / 2); c < (half + 1) * (P / 2); ++c) o_w[r * G::OLD + c] *= alpha;
    __syncwarp();
    acc_av<P, false>(o_w, p_w, vs);
    __syncwarp();
  }

  if (qi < T) {
    const float inv = 1.0f / l;
    for (int c = half * (P / 2); c < (half + 1) * (P / 2) && c < p; ++c)
      o[base + (size_t)qi * p + c] = __float2bfloat16_rn(o_w[r * G::OLD + c] * inv);
    if (half == 0) lse[(size_t)bh * T + qi] = m + logf(l);
  }
}

// Rows of lse and delta for one query tile into shared memory.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse, const float* delta,
                                          size_t row_base, int q0, int T) {
  if (threadIdx.x < kB) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < T ? lse[row_base + qi] : 0.0f;
    delta_s[threadIdx.x] = qi < T ? delta[row_base + qi] : 0.0f;
  }
}

// For the warp's 16 query rows against one key tile: P from the scores
// and the saved lse, dS = P * (dP - delta) * scale; both rounded to bf16
// into [64][kPLd] blocks at the warp's rows.
__device__ __forceinline__ void probs_and_ds(
    const float* s_w, const float* dp_w, const float* lse_s,
    const float* delta_s, bf16* p_rows, bf16* ds_rows, int qi, int kv0,
    int T, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;
  const float L = lse_s[warp * 16 + r], dl = delta_s[warp * 16 + r];
#pragma unroll 8
  for (int c = half * 32; c < half * 32 + 32; ++c) {
    const int kv = kv0 + c;
    const bool valid = kv <= qi && qi < T && kv < T;
    const float pv = valid ? __expf(s_w[r * kSLd + c] * scale - L) : 0.0f;
    const float ds = pv * (dp_w[r * kSLd + c] - dl) * scale;
    if (p_rows) p_rows[(warp * 16 + r) * kPLd + c] = __float2bfloat16_rn(pv);
    ds_rows[(warp * 16 + r) * kPLd + c] = __float2bfloat16_rn(ds);
  }
}

// Write the warp's 16 rows of an f32 accumulator to a bf16 [T, p] output.
template <int P>
__device__ __forceinline__ void store_rows(bf16* out, const float* acc_w,
                                           int row, int T, int p) {
  const int lane = threadIdx.x % 32, r = lane / 2, half = lane % 2;
  if (row + r >= T) return;
  for (int c = half * (P / 2); c < (half + 1) * (P / 2) && c < p; ++c)
    out[(size_t)(row + r) * p + c] =
        __float2bfloat16_rn(acc_w[r * Geo<P>::OLD + c]);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int p, float scale) {
  typedef Geo<P> G;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* cur = smem;
  bf16* ks = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  bf16* vs = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  bf16* qs = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  bf16* dos = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  float* dk_acc = reinterpret_cast<float*>(cur); cur += G::ACC;
  float* dv_acc = reinterpret_cast<float*>(cur); cur += G::ACC;
  float* scores = reinterpret_cast<float*>(cur); cur += G::SCORES;
  float* dps = reinterpret_cast<float*>(cur); cur += G::SCORES;
  bf16* probs = reinterpret_cast<bf16*>(cur); cur += G::PROBS;
  bf16* dss = reinterpret_cast<bf16*>(cur); cur += G::PROBS;
  float* lse_s = reinterpret_cast<float*>(cur);
  float* delta_s = lse_s + kB;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2;
  const int bh = blockIdx.y;
  const int kt = blockIdx.x;             // low tiles have the most work
  const int k0 = kt * kB;
  const size_t base = (size_t)bh * T * p;
  const int n_qt = (T + kB - 1) / kB;

  load_tile<P>(ks, k + base, k0, T, p);
  load_tile<P>(vs, v + base, k0, T, p);
  for (int i = threadIdx.x; i < kB * G::OLD; i += kThreads) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }
  float* s_w = scores + warp * 16 * kSLd;
  float* dp_w = dps + warp * 16 * kSLd;

  for (int it = kt; it < n_qt; ++it) {
    const int q0 = it * kB;
    __syncthreads();
    load_tile<P>(qs, q + base, q0, T, p);
    load_tile<P>(dos, dout + base, q0, T, p);
    load_rows(lse_s, delta_s, lse, delta, (size_t)bh * T, q0, T);
    __syncthreads();
    qk_t<P>(s_w, qs + warp * 16 * G::LD, ks);      // S  = Q K^T
    qk_t<P>(dp_w, dos + warp * 16 * G::LD, vs);    // dP = dO V^T
    __syncwarp();
    probs_and_ds(s_w, dp_w, lse_s, delta_s, probs, dss, q0 + warp * 16 + r,
                 k0, T, scale);
    __syncthreads();
    // the warp's 16 key rows: dV += P^T dO, dK += dS^T Q
    acc_av<P, true>(dv_acc + warp * 16 * G::OLD, probs + warp * 16, dos);
    acc_av<P, true>(dk_acc + warp * 16 * G::OLD, dss + warp * 16, qs);
  }
  __syncwarp();
  store_rows<P>(dk + base, dk_acc + warp * 16 * G::OLD, k0 + warp * 16, T, p);
  store_rows<P>(dv + base, dv_acc + warp * 16 * G::OLD, k0 + warp * 16, T, p);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int T, int p, float scale) {
  typedef Geo<P> G;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* cur = smem;
  bf16* qs = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  bf16* dos = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  bf16* ks = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  bf16* vs = reinterpret_cast<bf16*>(cur); cur += G::TILE;
  float* dq_acc = reinterpret_cast<float*>(cur); cur += G::ACC;
  float* scores = reinterpret_cast<float*>(cur); cur += G::SCORES;
  float* dps = reinterpret_cast<float*>(cur); cur += G::SCORES;
  bf16* dss = reinterpret_cast<bf16*>(cur); cur += G::PROBS;
  float* lse_s = reinterpret_cast<float*>(cur);
  float* delta_s = lse_s + kB;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2;
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int q0 = qt * kB;
  const size_t base = (size_t)bh * T * p;

  load_tile<P>(qs, q + base, q0, T, p);
  load_tile<P>(dos, dout + base, q0, T, p);
  load_rows(lse_s, delta_s, lse, delta, (size_t)bh * T, q0, T);
  for (int i = threadIdx.x; i < kB * G::OLD; i += kThreads) dq_acc[i] = 0.0f;
  float* s_w = scores + warp * 16 * kSLd;
  float* dp_w = dps + warp * 16 * kSLd;
  float* dq_w = dq_acc + warp * 16 * G::OLD;

  for (int j = 0; j <= qt; ++j) {
    __syncthreads();
    load_tile<P>(ks, k + base, j * kB, T, p);
    load_tile<P>(vs, v + base, j * kB, T, p);
    __syncthreads();
    qk_t<P>(s_w, qs + warp * 16 * G::LD, ks);
    qk_t<P>(dp_w, dos + warp * 16 * G::LD, vs);
    __syncwarp();
    probs_and_ds(s_w, dp_w, lse_s, delta_s, nullptr, dss, q0 + warp * 16 + r,
                 j * kB, T, scale);
    __syncwarp();
    acc_av<P, false>(dq_w, dss + warp * 16 * kPLd, ks);    // dQ += dS K
    __syncwarp();
  }
  store_rows<P>(dq + base, dq_w, q0 + warp * 16, T, p);
}

// Raise a kernel's dynamic shared-memory limit once, on its first launch
// (outside any CUDA-graph capture, since callers warm up before capturing).
template <auto Kernel>
int prepare(int smem) {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  return err;
}

template <int P>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int T, int p, float scale, cudaStream_t stream) {
  int err = prepare<flash_fwd_kernel<P>>(Geo<P>::FWD);
  if (err) return err;
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_fwd_kernel<P><<<grid, kThreads, Geo<P>::FWD, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), T, p, scale);
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
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, p, scale);
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
      static_cast<bf16*>(dqp), T, p, scale);
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
