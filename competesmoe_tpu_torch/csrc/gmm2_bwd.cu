// The backward of K1 (the fused grouped ReLU double GEMM) over the same
// expert-aligned row tiles, for Hopper (sm_90a), in the contract of XLA's
// ragged_dot VJP that JAX's K1 takes (competesmoe_tpu/ops/gmm_fused.py
// `_bwd`, through `grouped_ffn_kv`): bf16 operands, float32 accumulation,
// every product rounded to bf16.
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
// Two kernels, helpers from mma_tiles.cuh and tensor_maps.cuh:
//   * gmm2_bwd_dx_kernel: a block per half tile (128 rows, two consumer
//     warpgroups of 64 rows each, sharing every staged weight box). For
//     each 128 columns of ES it recomputes h on wgmma (xs K-major, keys
//     MN-major), rounds it, keeps its sign mask (64 bits a thread), writes
//     hr; gathers the slot gradients do itself (16-byte loads of g, the
//     weight multiplied in float32, zero on padding rows) into a swizzled
//     shared tile, multiplies them by values^T (K-major), masks, writes dh
//     to global memory and to shared memory, where the last products read
//     it: dxs = dh keys^T, 64 output columns at a time.
//   * gmm2_bwd_dw_kernel: a block per (expert, 128 x 128 output tile of
//     dkeys or dvalues). It walks the expert's rows 64 at a time (both
//     operands MN-major: xs and dh, or hr and the regathered do) and keeps
//     the f32 sums in registers; an expert without rows writes zeros. No
//     atomics anywhere: a second run gives the same bytes.
// Every step stages its boxes (2D tensor-map copies into the 128-byte
// swizzle) in one of two 32 KB stages: the copies of step s + 1 are in
// flight while step s computes. Simple and correct first; the producer
// warp, deeper rings and persistent blocks of K1's forward are not here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tensor_maps.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 256;                // rows per expert-aligned tile
constexpr int kRows = 128;                // rows of a dX block
constexpr int kThreads = 256;             // two warpgroups
constexpr int kBox = 64 * 64 * 2;         // a [64][64] bf16 box: 8 KB
constexpr int kHalf = 2 * kBox;           // 16 KB
constexpr int kStage = 2 * kHalf;         // 32 KB
constexpr int kMaxES = 512;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight columns of a row's slot gradient from `col`: bf16(g[token] * w),
// zero on a padding row.
__device__ __forceinline__ uint4 slot_grad8(const bf16* __restrict__ g, int D,
                                            int token, float w, bool valid,
                                            int col) {
  if (!valid) return make_uint4(0u, 0u, 0u, 0u);
  const uint4 raw =
      *reinterpret_cast<const uint4*>(g + (size_t)token * D + col);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    o[i] = tiles::pack_bf16(f.x * w, f.y * w);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
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

// ---- dX -------------------------------------------------------------------
//
// Steps of a block, for each 128-column chunk c of ES: D / 64 "h" steps
// (xs box [128][64] and keys[e] boxes [64 D][64 ES] x 2), then D / 64 "dh"
// steps (the gathered do [128][64] and values[e] boxes [64 ES][64 D] x 2);
// then, for each 64 output columns of D, ES / 128 "dx" steps (keys[e]
// boxes [64 D][64 ES] x 2 against dh in shared memory).

template <int HC>   // ES = 128 HC
struct DxGeo {
  static constexpr int ES = 128 * HC;
  static constexpr int DH = kRows * ES * 2;           // dh in shared memory
  static constexpr int SMEM = 2 * kStage + DH + 2 * 8 + 1024;
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
                   int k, int D, bf16* __restrict__ dxs,
                   bf16* __restrict__ hr_out, bf16* __restrict__ dh_out) {
  typedef DxGeo<HC> G;
  constexpr int ES = G::ES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - tiles::smem_u32(smem_raw)) & 1023u);
  bf16* dhs = reinterpret_cast<bf16*>(smem + 2 * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kStage + G::DH);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g8 = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int e = tile_expert[row0 / kTile];
  const int KD = D / 64;
  const int n_hdh = 2 * HC * KD;             // the h and dh steps
  const int n_steps = n_hdh + KD * HC;

  if (tid == 0) {
    tiles::mbar_init(&full[0]);
    tiles::mbar_init(&full[1]);
  }
  __syncthreads();

  // the four rows of the do tile this thread gathers: 16-byte chunk tid % 8
  // of rows tid / 8 + 32 i
  int token[4];
  float weight[4];
  bool valid[4];
  {
    const int lo = aoff[e], n = gsize[e];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = row0 + tid / 8 + 32 * i;
      const int s = slot[p];
      valid[i] = p - lo < n;
      token[i] = s / k;
      weight[i] = __bfloat162float(wflat[s]);
    }
  }

  // the maps by address (kernel parameters: the copy engine reads them
  // there, so no lambda copies them)
  const CUtensorMap *xm = &xmap, *km = &kmap, *vm = &vmap;
  uint64_t once = 0, keep = 0;
  if (tid == 0) {
    once = tma::evict_first();
    keep = tma::evict_last();
  }
  auto issue = [&](int s) {       // thread 0: step s's copies into stage s & 1
    unsigned char* st = smem + (s & 1) * kStage;
    uint64_t* bar = &full[s & 1];
    if (s < n_hdh) {
      const int c = s / (2 * KD), r = s % (2 * KD), kd = r % KD;
      if (r < KD) {
        tiles::mbar_expect(bar, kStage);
        tma::box(st, xm, kd * 64, row0, bar, once);
        for (int b = 0; b < 2; ++b)
          tma::box(st + kHalf + b * kBox, km, c * 128 + b * 64,
                   e * D + kd * 64, bar, keep);
      } else {
        tiles::mbar_expect(bar, kHalf);
        for (int b = 0; b < 2; ++b)
          tma::box(st + kHalf + b * kBox, vm, kd * 64,
                   e * ES + c * 128 + b * 64, bar, keep);
      }
    } else {
      const int s2 = s - n_hdh, nd = s2 / HC, c = s2 % HC;
      tiles::mbar_expect(bar, kHalf);
      for (int b = 0; b < 2; ++b)
        tma::box(st + kHalf + b * kBox, km, c * 128 + b * 64,
                 e * D + nd * 64, bar, keep);
    }
  };

  const size_t my_row = (size_t)row0 + 64 * wg + 16 * (warp % 4) + g8;
  float acc[16][4];                 // 64 rows x 128 columns
  uint64_t hmask = 0;               // h > 0, bit 4 n + i of acc[n][i]
  if (tid == 0) {
    tma::prefetch(xm);
    tma::prefetch(km);
    tma::prefetch(vm);
    issue(0);
  }
  for (int s = 0; s < n_steps; ++s) {
    if (tid == 0 && s + 1 < n_steps) issue(s + 1);
    unsigned char* st = smem + (s & 1) * kStage;
    const bf16* stb = reinterpret_cast<const bf16*>(st);
    const bool hdh = s < n_hdh;
    const int c = hdh ? s / (2 * KD) : (s - n_hdh) % HC;
    const int r = hdh ? s % (2 * KD) : 0;
    const int kd = r % KD;
    const bool h_step = hdh && r < KD, dh_step = hdh && r >= KD;
    if (dh_step) {                  // the slot gradients of D columns kd
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tid / 8 + 32 * i, ch = tid % 8;
        const uint4 v = slot_grad8(g, D, token[i], weight[i], valid[i],
                                   kd * 64 + 8 * ch);
        tiles::sts128(st + 2 * tiles::block_offset<64>(row, 8 * ch), v.x,
                      v.y, v.z, v.w);
      }
      tiles::fence_async_proxy();
    }
    tiles::mbar_wait(&full[s & 1], (s >> 1) & 1);
    __syncthreads();
    if ((h_step || dh_step) && kd == 0) tiles::zero(acc);
    if (!hdh && c == 0) tiles::zero(acc);
    tiles::wgmma_fence();
    if (hdh) {
      const uint64_t a = tiles::block_desc<64>(stb + wg * 64 * 64);
      const uint64_t b0 = tiles::block_desc<64>(stb + kHalf / 2);
      const uint64_t b1 = tiles::block_desc<64>(stb + (kHalf + kBox) / 2);
      if (h_step) {                 // h += xs keys[e]: keys MN-major
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tiles::WgmmaSS<64>::template run<0, 1, 0>(acc, a + 2 * kk, b0 + 128 * kk, 1);
          tiles::WgmmaSS<64>::template run<0, 1, 8>(acc, a + 2 * kk, b1 + 128 * kk, 1);
        }
      } else {                      // dh += do values[e]^T: values K-major
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tiles::WgmmaSS<64>::template run<0, 0, 0>(acc, a + 2 * kk, b0 + 2 * kk, 1);
          tiles::WgmmaSS<64>::template run<0, 0, 8>(acc, a + 2 * kk, b1 + 2 * kk, 1);
        }
      }
    } else {                        // dxs += dh keys[e]^T: keys K-major
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const uint64_t a = tiles::block_desc<64>(
            dhs + (2 * c + b) * kRows * 64 + wg * 64 * 64);
        const uint64_t bk = tiles::block_desc<64>(stb + (kHalf + b * kBox) / 2);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tiles::WgmmaSS<64>::template run<0, 0, 0>(acc, a + 2 * kk, bk + 2 * kk, 1);
      }
    }
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::pin(acc);

    if (h_step && kd == KD - 1) {
      // h rounded to bf16 (the relu mask comes from the rounded value),
      // then relu: hr
      hmask = 0;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float h = round_bf16(acc[n][i]);
          if (h > 0.0f) hmask |= uint64_t(1) << (4 * n + i);
          acc[n][i] = fmaxf(h, 0.0f);
        }
      store_rows<16>(hr_out + my_row * ES, ES, c * 128, acc, t);
    }
    if (dh_step && kd == KD - 1) {
      // dh = bf16(do values^T) where h > 0
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[n][i] = (hmask >> (4 * n + i)) & 1 ? round_bf16(acc[n][i]) : 0.0f;
      store_rows<16>(dh_out + my_row * ES, ES, c * 128, acc, t);
      // and into shared memory: K-major blocks of 64 columns for dxs
      const int lr = 64 * wg + 16 * (warp % 4) + g8;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c * 128 + 8 * n + 2 * t;
          bf16* blk = dhs + (col / 64) * kRows * 64;
          *reinterpret_cast<uint32_t*>(
              blk + tiles::block_offset<64>(lr + 8 * h, col % 64)) =
              tiles::pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
        }
      tiles::fence_async_proxy();
    }
    if (!hdh && c == HC - 1) {
      const int nd = (s - n_hdh) / HC;
      store_rows<8>(dxs + my_row * D, D, nd * 64, acc, t);
    }
    __syncthreads();                // stage s & 1 is free for step s + 2
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
  if (!tma::bf16_map(&xmap, xs, S, D, kRows) ||
      !tma::bf16_map(&kmap, keys, E * D, G::ES, 64) ||
      !tma::bf16_map(&vmap, values, E * G::ES, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  gmm2_bwd_dx_kernel<HC><<<S / kRows, kThreads, G::SMEM, stream>>>(
      xmap, kmap, vmap, static_cast<const bf16*>(g),
      static_cast<const int*>(slot), static_cast<const bf16*>(wflat),
      static_cast<const int*>(tile_expert), static_cast<const int*>(aoff),
      static_cast<const int*>(gsize), k, D, static_cast<bf16*>(dxs),
      static_cast<bf16*>(hr), static_cast<bf16*>(dh));
  return static_cast<int>(cudaGetLastError());
}

// ---- dW -------------------------------------------------------------------
//
// Block b: expert b / J, job b % J of J = 2 (D / 128) (ES / 128): the first
// half are the 128 x 128 tiles of dkeys[e] ([D][ES] = xs^T dh), the second
// those of dvalues[e] ([ES][D] = hr^T do). Warpgroup w takes output rows
// 64 w .. 64 w + 63 of the tile. A step is 64 rows of the expert: the box
// pair of the left operand ([64 rows][64 columns] x 2, the output rows of
// the two warpgroups) and of the right one (the tile's 128 columns).

constexpr int kDwSmem = 2 * kStage + 2 * 8 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
gmm2_bwd_dw_kernel(const __grid_constant__ CUtensorMap xmap,   // xs [S, D]
                   const __grid_constant__ CUtensorMap hmap,   // hr [S, ES]
                   const __grid_constant__ CUtensorMap dhmap,  // dh [S, ES]
                   const bf16* __restrict__ g, const int* __restrict__ slot,
                   const bf16* __restrict__ wflat,
                   const int* __restrict__ aoff, const int* __restrict__ gsize,
                   int k, int D, int ES, float* __restrict__ dkeys,
                   float* __restrict__ dvalues) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - tiles::smem_u32(smem_raw)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kStage);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g8 = lane >> 2, t = lane & 3;
  const int JK = (D / 128) * (ES / 128);
  const int e = blockIdx.x / (2 * JK);
  int j = blockIdx.x % (2 * JK);
  const bool is_dk = j < JK;
  int mb, nb;
  if (is_dk) {
    mb = j / (ES / 128);
    nb = j % (ES / 128);
  } else {
    j -= JK;
    mb = j / (D / 128);
    nb = j % (D / 128);
  }
  const int lo = aoff[e], n = gsize[e];
  const int n_steps = (n + 63) / 64;

  if (tid == 0) {
    tiles::mbar_init(&full[0]);
    tiles::mbar_init(&full[1]);
  }
  __syncthreads();

  const CUtensorMap* left = is_dk ? &xmap : &hmap;
  const CUtensorMap* right = &dhmap;
  uint64_t once = 0;
  if (tid == 0) once = tma::evict_first();
  auto issue = [&](int s) {
    unsigned char* st = smem + (s & 1) * kStage;
    uint64_t* bar = &full[s & 1];
    const int row = lo + 64 * s;
    tiles::mbar_expect(bar, is_dk ? kStage : kHalf);
    for (int b = 0; b < 2; ++b) {
      tma::box(st + b * kBox, left, mb * 128 + b * 64, row, bar, once);
      if (is_dk)
        tma::box(st + kHalf + b * kBox, right, nb * 128 + b * 64, row, bar,
                 once);
    }
  };

  float acc[16][4];
  tiles::zero(acc);
  if (tid == 0 && n_steps > 0) {
    tma::prefetch(left);
    tma::prefetch(right);
    issue(0);
  }
  for (int s = 0; s < n_steps; ++s) {
    if (tid == 0 && s + 1 < n_steps) issue(s + 1);
    unsigned char* st = smem + (s & 1) * kStage;
    const bf16* stb = reinterpret_cast<const bf16*>(st);
    if (!is_dk) {                   // do of the tile's 128 columns of D
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tid / 16 + 16 * i, cc = tid % 16;
        const int p = lo + 64 * s + r;
        const int sl = slot[p];
        const uint4 v = slot_grad8(g, D, sl / k, __bfloat162float(wflat[sl]),
                                   p - lo < n, nb * 128 + 8 * cc);
        tiles::sts128(st + kHalf + (cc / 8) * kBox +
                          2 * tiles::block_offset<64>(r, 8 * (cc % 8)),
                      v.x, v.y, v.z, v.w);
      }
      tiles::fence_async_proxy();
    }
    tiles::mbar_wait(&full[s & 1], (s >> 1) & 1);
    __syncthreads();
    tiles::wgmma_fence();
    {
      // both operands MN-major: [64 rows (the contraction)][64 columns]
      const uint64_t a = tiles::block_desc<64>(stb + wg * 64 * 64);
      const uint64_t b0 = tiles::block_desc<64>(stb + kHalf / 2);
      const uint64_t b1 = tiles::block_desc<64>(stb + (kHalf + kBox) / 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        tiles::WgmmaSS<64>::template run<1, 1, 0>(acc, a + 128 * kk, b0 + 128 * kk, 1);
        tiles::WgmmaSS<64>::template run<1, 1, 8>(acc, a + 128 * kk, b1 + 128 * kk, 1);
      }
    }
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::pin(acc);
    __syncthreads();                // stage s & 1 is free for step s + 2
  }

  // rounded to bf16 once, stored as float32
  float* out = is_dk ? dkeys + (size_t)e * D * ES : dvalues + (size_t)e * ES * D;
  const int ld = is_dk ? ES : D;
  const int m = mb * 128 + 64 * wg + 16 * (warp % 4) + g8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (size_t)(m + 8 * h) * ld + nb * 128 +
                                 8 * nt + 2 * t) =
          make_float2(round_bf16(acc[nt][2 * h]), round_bf16(acc[nt][2 * h + 1]));
}

}  // namespace

// C entry points (bound with ctypes). Shapes: xs bf16 [S, D]; g bf16
// [T, D]; slot int32 [S] (the flat top-k slot feeding each padded row, any
// valid slot on padding rows); wflat bf16 [T k]; keys bf16 [E, D, ES];
// values bf16 [E, ES, D]; tile_expert int32 [S / 256]; aoff int32 [E + 1]
// (the aligned start of each expert's rows); gsize int32 [E]; dxs bf16
// [S, D]; hr, dh bf16 [S, ES]; dkeys float32 [E, D, ES]; dvalues float32
// [E, ES, D]. Requires S % 256 == 0, D % 128 == 0, ES % 128 == 0,
// ES <= 512 and 16-byte aligned pointers. Each returns its launch's error.
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

extern "C" int gmm2_bwd_dw_launch(const void* xs, const void* hr,
                                  const void* dh, const void* g,
                                  const void* slot, const void* wflat,
                                  const void* aoff, const void* gsize,
                                  void* dkeys, void* dvalues, int S, int D,
                                  int ES, int E, int k, void* stream_ptr) {
  if (S % kTile != 0 || D % 128 != 0 || ES % 128 != 0 || ES > kMaxES ||
      S < kTile || E < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int set = tiles::prepare<gmm2_bwd_dw_kernel>(kDwSmem);
  if (set != 0) return set;
  CUtensorMap xmap, hmap, dhmap;
  if (!tma::bf16_map(&xmap, xs, S, D, 64) ||
      !tma::bf16_map(&hmap, hr, S, ES, 64) ||
      !tma::bf16_map(&dhmap, dh, S, ES, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = E * 2 * (D / 128) * (ES / 128);
  gmm2_bwd_dw_kernel<<<blocks, kThreads, kDwSmem,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      xmap, hmap, dhmap, static_cast<const bf16*>(g),
      static_cast<const int*>(slot), static_cast<const bf16*>(wflat),
      static_cast<const int*>(aoff), static_cast<const int*>(gsize), k, D, ES,
      static_cast<float*>(dkeys), static_cast<float*>(dvalues));
  return static_cast<int>(cudaGetLastError());
}
