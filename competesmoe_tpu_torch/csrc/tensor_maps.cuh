// Tensor-map (TMA) copies for Hopper kernels (sm_90a): the host side
// encodes a CUtensorMap for a 2D row-major matrix, read in boxes; the
// device side asks the copy engine for one box into shared memory,
// counted on an mbarrier (mma_tiles.cuh `mbar_expect` / `mbar_wait`),
// under an L2 eviction policy. One box is one request, whatever its
// bytes. A box lands in the swizzle its map names, which for the 128-byte
// swizzle and 64-column bf16 boxes is the tile layout of mma_tiles.cuh.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace tma {

// L2 policies: data read once goes first; data every block reads stays.
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
__device__ __forceinline__ void box(void* dst, const CUtensorMap* map,
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

__device__ __forceinline__ void prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda); null where the driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// The tensor map of a row-major [rows, cols] matrix of `elem_bytes`-byte
// elements (bf16 or int8), `pitch` elements from one row to the next
// (default: contiguous, `cols`), read in boxes of `box_rows` rows x
// `box_cols` columns in the given swizzle; zeros beyond its bounds. The
// base must be 16-byte aligned and the row pitch a multiple of 16 bytes.
// False if cuTensorMapEncodeTiled refuses it.
inline bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols,
                       int box_rows, int box_cols, int elem_bytes,
                       CUtensorMapSwizzle swizzle, int pitch = 0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(pitch > 0 ? pitch : cols) * elem_bytes};
  const cuuint32_t boxdim[2] = {static_cast<cuuint32_t>(box_cols),
                                static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map,
                elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                2, const_cast<void*>(base), dims, strides, boxdim, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 matrix in boxes of `box_rows` rows x 64 columns (128-byte rows,
// the 128-byte swizzle that wgmma reads).
inline bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows) {
  return matrix_map(map, base, rows, cols, box_rows, 64, 2,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace tma
