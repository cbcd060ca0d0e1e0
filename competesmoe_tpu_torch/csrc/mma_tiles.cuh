// Warpgroup-level building blocks for Hopper kernels that issue their own
// tensor-core instructions (wgmma, sm_90a) on bf16 tiles in shared memory:
//   * copies from global to shared memory: 4-byte cp.async in groups,
//     16-byte cp.async with zero fill whose landing an mbarrier counts,
//     and bulk copies by the copy engine counted on an mbarrier;
//   * ldmatrix (a k-step's A registers from a tile) and setmaxnreg (a
//     warpgroup handing registers to another);
//   * a cluster's barrier (whole, or its two halves), reads and writes of
//     another block's shared memory, and the host side of a launch whose
//     grid's y extent is one cluster;
//   * the swizzled tile layout that wgmma reads without bank conflicts and
//     that a warp fills, a row at a time, without bank conflicts either;
//   * wgmma.mma_async m64nNk16 (bf16 operands, f32 accumulation), its
//     descriptors, fences and the products a warpgroup that owns 64 rows
//     needs: C = A X^T (both from shared memory, either of them MN-major
//     through wgmma's transpose bits) and C += A X or A X^T (A from
//     registers, X MN-major or K-major).
//
// Register layouts of m64nNk16 for the warpgroup's thread 32 w + lane,
// lane = 4 g + t: warp w holds rows 16 w .. 16 w + 15 of the 64.
//   C, 8-column tile n: c[n][0] (row g, col 8n + 2t)   c[n][1] (col 8n + 2t + 1)
//                       c[n][2] (row g + 8, col 8n + 2t) c[n][3] (col 8n + 2t + 1)
//   A, 16 columns (one k-step): a0 (row g, cols 2t, 2t+1)  a1 (row g + 8, same)
//                               a2 (row g, cols 2t+8, 2t+9) a3 (row g + 8, same)
// so two neighbouring C tiles (16 columns), rounded to bf16 pairs, are one A
// k-step: a0 = (c0, c1) and a1 = (c2, c3) of the first tile, a2 and a3 the
// same of the second. A product's result feeds the next product from
// registers.
//
// A tile of 64 rows and P columns (P = 32, 64, 96 or 128) is stored as
// column blocks: 64 columns wide with 128-byte rows and the 128-byte
// swizzle, then, for what is left, 32 columns with 64-byte rows and the
// 64-byte swizzle. Within a block a row is contiguous, and the swizzle
// exchanges its 16-byte chunks by the row's number (chunk ^= row & 7, or
// chunk ^= (row / 2) & 3 for 64-byte rows; tile bases are 1024-byte aligned,
// so the row's number is in the address bits the hardware reads). One stored
// block serves both ways a product can take it:
//   K-major  (its rows are the operand's M or N, its columns the
//             contraction: C = A X^T): a k-step is 32 bytes on in the row;
//   MN-major (its rows are the contraction, its columns the output's:
//             C += A X): a k-step is 16 rows on.
// In both, the descriptor's stride offset is 8 rows of the block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous 4-byte copy from global to shared memory; both addresses
// 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// One asynchronous 16-byte copy from global to shared memory through L2
// (both addresses 16-byte aligned); 16 zero bytes instead where `valid` is
// false (the source is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(valid ? 16 : 0)
               : "memory");
}

// An arrival on `bar` once every cp.async this thread issued before it has
// landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- bulk copies (the copy engine) and their barrier ---------------------------
//
// One thread asks for a run of bytes to be copied from global to shared
// memory (both 16-byte aligned, a multiple of 16 bytes); the copy engine
// moves it without further instructions and counts the bytes on an mbarrier
// in shared memory, on which the block's threads wait.

// Initialise the barrier for `count` arriving threads (one by default);
// call from one thread, then synchronise the block.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive (with release semantics: this thread's earlier reads and writes of
// shared memory are done before the phase can complete).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// `n` arrivals at once.
__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(n)
               : "memory");
}

// Arrive and announce `bytes` of copies that will complete on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the barrier's phase of the given parity to complete; traps
// rather than spinning for ever if the bytes never arrive.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// ---- thread-block clusters ------------------------------------------------

// Every thread of every block of the cluster arrives, then waits for all
// (release / acquire: shared-memory writes before it are visible to the
// cluster's reads after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Raise a kernel's dynamic shared-memory limit once, on its first launch
// (outside any CUDA-graph capture, since callers warm up before capturing).
template <auto Kernel>
int prepare(int smem) {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  return err;
}

// A kernel on a grid of a block per `out` outputs (x) and K split (y);
// the splits of a block of outputs are one cluster.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int out, int threads, int smem,
                    int N, int splits, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + out - 1) / out, splits, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// The two halves of a cluster barrier, for work between them: every
// thread arrives (relaxed: no memory ordering), and later waits for all.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// A float in the shared memory of block `rank` of the cluster, at the
// address `p` has in this block's shared memory.
__device__ __forceinline__ float ld_cluster_f32(const void* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// Store four floats (16-byte aligned) into the shared memory of block
// `rank` of the cluster, at the address `p` has in this block's shared
// memory (visible there after the next cluster barrier).
__device__ __forceinline__ void st_cluster_f32x4(void* p, uint32_t rank,
                                                 float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// A word of shared memory at a 32-bit shared-space address.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Store 16 bytes to shared memory at a 16-byte aligned address as one
// vector store (nvcc may otherwise split a uint4 store into four 4-byte
// ones, which the swizzled layouts turn into bank conflicts).
__device__ __forceinline__ void sts128(void* p, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory into registers (ldmatrix):
// lane L gives the address of row L % 8 of matrix L / 8 (16 bytes); r[i]
// is matrix i, lane 4 g + t holding row g, columns 2t and 2t + 1 (with
// `trans`, column g, rows 2t and 2t + 1). On a tile of the layout below,
// K-major (rows = M, columns = K), matrices (rows 0-7, k 0-7), (8-15, 0-7),
// (0-7, 8-15), (8-15, 8-15) are the A registers of a k-step; MN-major
// (rows = K), the same four with rows and columns exchanged, with `trans`.
template <bool Trans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (Trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

// A warpgroup gives back registers (down to N a thread) or takes more (up
// to N) from the SM's pool (sm_90a); every warp of the warpgroup calls it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Store a word to shared memory where `pred` is not 0 (a predicated store,
// no branch).
__device__ __forceinline__ void sts32_if(uint32_t addr, uint32_t v, int pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p st.shared.b32 [%0], %1;\n"
      "}\n" ::"r"(addr),
      "r"(v), "r"(pred)
      : "memory");
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special function unit.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
}

// 64 x 16 KS accumulators (KS pairs of n-tiles) rounded to bf16 as the A
// registers of the next product's KS k-steps.
template <int KS>
__device__ __forceinline__ void as_a(uint32_t (&a)[KS][4],
                                     const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

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

// ---- the tile layout ---------------------------------------------------------

constexpr int kTileRows = 64;

// Width of column block B (0 or 1) of a tile with P columns; 0 if absent.
template <int P, int B>
__host__ __device__ constexpr int block_cols() {
  static_assert(P == 32 || P == 64 || P == 96 || P == 128, "tile width");
  return B == 0 ? (P >= 64 ? 64 : 32) : P - (P >= 64 ? 64 : P);
}

// Element offset of (r, c) inside a block of W columns (64 or 32).
template <int W>
__device__ __forceinline__ int block_offset(int r, int c) {
  static_assert(W == 64 || W == 32, "block width");
  const int row = W == 64 ? r & 7 : (r >> 1) & 3;
  return r * W + ((((c >> 3) ^ row) << 3) | (c & 7));
}

// Element offset of (r, c) in a tile of 64 rows and P columns.
template <int P>
__device__ __forceinline__ int tile_offset(int r, int c) {
  constexpr int W0 = block_cols<P, 0>(), W1 = block_cols<P, 1>();
  if constexpr (W1 > 0) {
    if (c >= W0) return kTileRows * W0 + block_offset<W1>(r, c - W0);
  }
  return block_offset<W0>(r, c);
}

// ---- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor of a block of W columns: address and
// stride offset (8 rows) in units of 16 bytes, the leading offset unused
// (one swizzle atom wide), the swizzle mode 1 (128 bytes) or 2 (64 bytes).
template <int W>
__device__ __forceinline__ uint64_t block_desc(const bf16* block) {
  return static_cast<uint64_t>((smem_u32(block) & 0x3FFFF) >> 4) |
         (uint64_t(1) << 16) | (static_cast<uint64_t>(W) << 32) |
         (static_cast<uint64_t>(W == 64 ? 1 : 2) << 62);
}

// Writes to shared memory by this thread (stores, cp.async) become visible
// to wgmma's reads; call before the barrier that publishes them.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving uses of registers that an asynchronous
// wgmma reads or writes across its fence or its wait.
template <int NT>
__device__ __forceinline__ void pin(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[n][e])::"memory");
}

template <int KS>
__device__ __forceinline__ void pin(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e])::"memory");
}

// d[64 x N] (+)= a[64 x 16] b[16 x N] on the n-tiles OFF .. OFF + N / 8 of
// d, both operands in shared memory; `accumulate` 0 overwrites those
// n-tiles. An operand is K-major by default; TA (TB) 1 reads A (B) as
// MN-major, stored [k][m] ([k][n]): wgmma's transpose bits, which bf16
// operands allow. N = 8, 16, 24, 32, 40, 64 or 128.
template <int N>
struct WgmmaSS;

// d[64 x N] += a[64 x 16] b[16 x N] on the n-tiles OFF .. OFF + N / 8 of d, a
// from registers, b in shared memory, MN-major (stored [k][n]) by default
// or K-major with TB 0. N = 8, 16, 24, 32, 40 or 64.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<8> {
  template <int TA = 0, int TB = 0, int OFF = 0, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    static_assert(OFF + 1 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, %8;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<16> {
  template <int TA = 0, int TB = 0, int OFF = 0, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    static_assert(OFF + 2 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<24> {
  template <int TA = 0, int TB = 0, int OFF = 0, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    static_assert(OFF + 3 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, %12, %13, p, 1, 1, %15, %16;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<32> {
  template <int TA = 0, int TB = 0, int OFF = 0, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    static_assert(OFF + 4 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<40> {
  template <int TA = 0, int TB = 0, int OFF = 0, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    static_assert(OFF + 5 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19"
        "}, %20, %21, p, 1, 1, %23, %24;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<64> {
  template <int TA = 0, int TB = 0, int OFF = 0, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    static_assert(OFF + 8 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
          "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
          "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct WgmmaSS<128> {
  template <int TA = 0, int TB = 0, int OFF = 0, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    static_assert(OFF + 16 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
          "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
          "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]),
          "+f"(d[OFF + 8][0]), "+f"(d[OFF + 8][1]), "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]),
          "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]), "+f"(d[OFF + 9][2]), "+f"(d[OFF + 9][3]),
          "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]), "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]),
          "+f"(d[OFF + 11][0]), "+f"(d[OFF + 11][1]), "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3]),
          "+f"(d[OFF + 12][0]), "+f"(d[OFF + 12][1]), "+f"(d[OFF + 12][2]), "+f"(d[OFF + 12][3]),
          "+f"(d[OFF + 13][0]), "+f"(d[OFF + 13][1]), "+f"(d[OFF + 13][2]), "+f"(d[OFF + 13][3]),
          "+f"(d[OFF + 14][0]), "+f"(d[OFF + 14][1]), "+f"(d[OFF + 14][2]), "+f"(d[OFF + 14][3]),
          "+f"(d[OFF + 15][0]), "+f"(d[OFF + 15][1]), "+f"(d[OFF + 15][2]), "+f"(d[OFF + 15][3])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};


template <>
struct WgmmaRS<8> {
  template <int OFF, int TB = 1, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    static_assert(OFF + 1 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<16> {
  template <int OFF, int TB = 1, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    static_assert(OFF + 2 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<24> {
  template <int OFF, int TB = 1, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    static_assert(OFF + 3 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, %18;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<32> {
  template <int OFF, int TB = 1, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    static_assert(OFF + 4 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<40> {
  template <int OFF, int TB = 1, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    static_assert(OFF + 5 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19"
        "}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, %26;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<64> {
  template <int OFF, int TB = 1, int NT>
  static __device__ __forceinline__ void run(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    static_assert(OFF + 8 <= NT, "n-tiles out of range");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
          "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
          "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

// c[64 x 64] = a x^T over P columns; a and x tiles of 64 rows, P columns.
template <int P>
__device__ __forceinline__ void wgmma_nt(float (&c)[8][4], const bf16* a,
                                         const bf16* x) {
  constexpr int W0 = block_cols<P, 0>(), W1 = block_cols<P, 1>();
  const uint64_t a0 = block_desc<W0>(a), x0 = block_desc<W0>(x);
#pragma unroll
  for (int kk = 0; kk < W0 / 16; ++kk)        // 16 columns on: 32 bytes
    WgmmaSS<64>::run(c, a0 + kk * 2, x0 + kk * 2, kk > 0);
  if constexpr (W1 > 0) {
    const uint64_t a1 = block_desc<W1>(a + kTileRows * W0);
    const uint64_t x1 = block_desc<W1>(x + kTileRows * W0);
#pragma unroll
    for (int kk = 0; kk < W1 / 16; ++kk)
      WgmmaSS<64>::run(c, a1 + kk * 2, x1 + kk * 2, 1);
  }
}

// c[64 x P] += a[64 x 64] x; a from registers (four k-steps), x a tile of
// 64 rows (the contraction) and P columns: one instruction per column
// block and k-step.
template <int P>
__device__ __forceinline__ void wgmma_nn(float (&c)[P / 8][4],
                                         const uint32_t (&a)[4][4],
                                         const bf16* x) {
  constexpr int W0 = block_cols<P, 0>(), W1 = block_cols<P, 1>();
  const uint64_t x0 = block_desc<W0>(x);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)              // 16 rows on: W * 32 bytes
    WgmmaRS<W0>::template run<0>(c, a[kk], x0 + kk * (W0 * 2));
  if constexpr (W1 > 0) {
    const uint64_t x1 = block_desc<W1>(x + kTileRows * W0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<W1>::template run<W0 / 8>(c, a[kk], x1 + kk * (W1 * 2));
  }
}

}  // namespace tiles
