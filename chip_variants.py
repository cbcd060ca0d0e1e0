#!/usr/bin/env python3
"""Design variants of K5 and of K1's backward against the kernels as
built (one CUDA GPU).

    python3 chip_variants.py [--only k5|k1bwd]

K5. A variant is either an edit of csrc/matvec_int4.cu, compiled from an
edited copy in a temporary directory as chip_faults.py compiles its
faults (the checkout's sources are not touched), or a changed attribute
of ops/matvec.py (a geometry the wrapper passes to the kernel). Every
variant is first held to chip_smoke.py's K5 check (`small_m_compare` at
the four decode projection shapes and M 1, 8, 40 and 128), then timed
beside the kernel as built, in turns (as built, variant, variant, as
built), from CUDA-graph replays rotating through 256 MB of weight copies
as chip_smoke.py times K5: one decoder layer's four projections at M 1,
8, 40 and 128.

- `smem_tile_route`: K4's route, the nibbles converted into bf16 tiles in
  shared memory that wgmma reads as A, in place of A registers built by
  each thread;
- `splits_for_one_block_an_sm`: K splits that aim for one block an SM
  instead of one and a half.

Readings, timed the same way but not checks of a design (their results
are wrong by construction), show what bounds the kernel:

- `copy_stream`: the same launches, boxes and ring with no conversion and
  no products (the bare copy stream);
- `convert_only`: the conversion without the products (its registers
  folded into one accumulator, so that it is not optimized away);
- `empty`: the same launches with no stages (launch, prologue and the
  cluster's epilogue);
- `empty_unsplit`: `empty` with every K unsplit (no cluster epilogue);
- and, for scale, a tiny PyTorch kernel a graph node (the floor of any
  launch in these CUDA graphs).

K1's backward (csrc/gmm2_bwd.cu: gmm2_bwd_dx, gmm2_bwd_dw). A variant is
an edit of the source, compiled the same way, first held to chip_smoke.py's
`k1_bwd_compare` (the edge groups, the check shapes and the 154M layer),
then timed with the kernel as built in turns at the 154M layer as
chip_smoke.py times it (its own kernel only):

- `dw_ring_3`: dW's ring of 3 stages instead of 2;
- `dw_step_32`, `dw_step_32_ring_4`: dW's stages of 32 rows instead of
  64, 2 or 4 of them;
- `dw_dv_one_wait`: dvalues' products of a stage waited for once, not
  after each k-step;
- `dw_gather_l2_256`: dW's gather copies with a 256-byte L2 prefetch;
- `dw_groups_half`: half as many groups (each over twice the rows: fewer
  partial tiles, coarser balance, half the card);
- `dw_gather_tma_rows`: dW's gather of g's rows by the copy engine
  (one-row tensor-map boxes of 64 columns that land in the 128-byte
  swizzle by their address) instead of 16-byte cp.async copies;
- `dx_ring_6`: dX's ring of 6 stages instead of 4.

Readings (wrong results by construction, not checked):

- `dw_copy_stream`, `dx_copy_stream`: the kernel's copies, gathers and
  stores with no products (the bare copy stream);
- `dw_no_gather`: dW without its gather of g's rows, what the gather
  costs; `dw_copy_stream_no_gather` without both;
- `dw_do_by_copy` and `dx_writes_do`: do written once by dX and read by
  dW's copy engine instead of gathered twice: dW reading a [S', D] bf16
  operand by tensor-map boxes (xs's, the same bytes) in place of its
  gather, and dX also writing each scaled do register (into dxs, the
  same bytes);
- `dw_cycles`: dW's phases in one block, clock64() sums a stage (each
  consumer warpgroup: waiting for the stage, computing; the producer:
  waiting for a slot, issuing).

It prints one line per variant and reading and a `variants` JSON line,
and exits non-zero if a variant or a kernel as built fails its check.
"""

import argparse
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

import chip_faults as cf
import chip_smoke as cs

_SMEM_ROUTE = r'''      // K4's route: the stage's nibbles into four bf16 tiles [64 K][64 n]
      // in shared memory (low and high nibbles x the two m64 tiles; tile
      // column 16 w + 8 h + g holds output 32 w + 4 g + 2 tile + h, as the
      // register route's A rows do), then products with A read MN-major
      bf16* tl = reinterpret_cast<bf16*>(smem + G::TILES);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int u = threadIdx.x + 128 * r;   // 256 items of 32 bytes
        const int k = u >> 2, wq = u & 3;      // box row, words 8 wq .. 8 wq + 7
        const uint4 c0 = *reinterpret_cast<const uint4*>(
            stage + k * kOut + 16 * ((2 * wq) ^ (k & 7)));
        const uint4 c1 = *reinterpret_cast<const uint4*>(
            stage + k * kOut + 16 * ((2 * wq + 1) ^ (k & 7)));
        const uint32_t wd[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {          // byte j: tile j / 2, h = j % 2
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            // byte j of words 2 p and 2 p + 1 in bits 0-7 and 16-23
            const uint32_t r2 = __byte_perm(wd[2 * p], wd[2 * p + 1],
                                            0x1100 * (4 + j) + 0x11 * j);
            lo[p] = to_bf16(r2);
            hi[p] = to_bf16(r2 >> 4);
          }
          const int col = 16 * wq + 8 * (j & 1);
          tiles::sts128(tl + (j >> 1) * 4096 + tiles::block_offset<64>(k, col),
                        lo[0], lo[1], lo[2], lo[3]);
          tiles::sts128(tl + (2 + (j >> 1)) * 4096 + tiles::block_offset<64>(k, col),
                        hi[0], hi[1], hi[2], hi[3]);
        }
      }
      tiles::fence_async_proxy();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      const uint64_t lo = tiles::block_desc<64>(xs);
      const uint64_t hi = tiles::block_desc<64>(xs + G::XBOX / 2);
      tiles::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 16; ++kk)
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          tiles::WgmmaSS<8 * NT>::template run<1>(
              acc[tile], tiles::block_desc<64>(tl + tile * 4096) + 128 * kk,
              lo + 2 * kk, 1);
          tiles::WgmmaSS<8 * NT>::template run<1>(
              acc[tile], tiles::block_desc<64>(tl + (2 + tile) * 4096) + 128 * kk,
              hi + 2 * kk, 1);
        }
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::pin(acc[0]);
      tiles::pin(acc[1]);
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
'''


def _smem_route(text: str) -> str:
    """The register route's consumer body (its A registers through the
    products' wait) replaced by _SMEM_ROUTE."""
    a = text.index("      uint32_t a[kStageK / 16][2][2][4];")
    end = "      tiles::pin(acc[1]);\n      __syncwarp();"
    b = text.index(end) + len("      tiles::pin(acc[1]);\n")
    return text[:a] + _SMEM_ROUTE + text[b:]


_NO_STAGES = [("(k_stop - k_first + kStageK - 1) / kStageK : 0;", "0 : 0;")]

# name -> edits of csrc/matvec_int4.cu ((text, replacement) pairs or
# functions of the text), or {ops/matvec.py attribute: value}, or both as
# (edits, attributes); readings are timed unchecked
VARIANTS = {
    "smem_tile_route": [
        ("  static constexpr int BARS = RECV + 8 * NT * (kOut + 4 * kMaxSplits) * 4;",
         "  static constexpr int TILES = RECV + 8 * NT * (kOut + 4 * kMaxSplits) * 4;\n"
         "  static constexpr int BARS = TILES + 4 * 64 * 64 * 2;"),
        _smem_route],
    "splits_for_one_block_an_sm": {"_K5_GEOMETRY": (128, 64, 1.0)},
}
READINGS = {
    "copy_stream": [
        ("        unpack<0>(tiles::lds32(row + even), tiles::lds32(row + odd), a[kk]);\n"
         "        unpack<2>(tiles::lds32(row + even + 8 * kOut),\n"
         "                  tiles::lds32(row + odd + 8 * kOut), a[kk]);\n", ""),
        ("          product<NT>(acc[tile], a[kk][tile][0], lo + 2 * kk);\n"
         "          product<NT>(acc[tile], a[kk][tile][1], hi + 2 * kk);\n", "")],
    "convert_only": [
        ("          product<NT>(acc[tile], a[kk][tile][0], lo + 2 * kk);\n"
         "          product<NT>(acc[tile], a[kk][tile][1], hi + 2 * kk);\n",
         "          acc[tile][0][0] += __uint_as_float((a[kk][tile][0][0] ^ "
         "a[kk][tile][0][1] ^ a[kk][tile][0][2] ^ a[kk][tile][0][3] ^ "
         "a[kk][tile][1][0] ^ a[kk][tile][1][1] ^ a[kk][tile][1][2] ^ "
         "a[kk][tile][1][3]) & 0x3fffffffu);\n")],
    "empty": _NO_STAGES,
    "empty_unsplit": (_NO_STAGES, {"_K5_GEOMETRY": (128, 64, 0.01)}),
}
M_TIMED = (1, 8, 40, 128)


def _in_kernel(kernel: str, fn):
    """An edit of gmm2_bwd.cu applied to one kernel's part of the text: dX
    (up to the dW section) or dW (from it)."""
    def edit(text):
        cut = text.index("// ---- dW ----")
        if kernel == "dx":
            return fn(text[:cut]) + text[cut:]
        return text[:cut] + fn(text[cut:])
    return edit


def _no_products(part: str) -> str:
    out, n = re.subn(r"tiles::Wgmma(SS|RS)<64>::template run<[^;]*;", ";",
                     part)
    if n == 0:
        raise AssertionError("no products to take out")
    return out


_DW_GATHER = """        tiles::cp_async16_zfill(
            st + G::DO + (ch / 8) * kDwBox + 2 * tiles::block_offset<64>(r, 8 * (ch % 8)),
            g + (size_t)((s * kdiv) >> 32) * D + col, row + r - lo_e < n_e);
"""
_DW_EXPECT = "        tiles::mbar_expect(&ring.full[sl], 6 * kDwBox);\n"
# dW's gather by the copy engine: one-row tensor-map boxes of g (64
# columns, 128 bytes, landing in the 128-byte swizzle by their address)
_TMA_ROWS = [
    ("""                   const __grid_constant__ CUtensorMap dhmap,  // dh [S, ES]
                   const bf16* __restrict__ g, const int* __restrict__ slot,
                   const bf16* __restrict__ wflat,
                   const int* __restrict__ aoff_g,""",
     """                   const __grid_constant__ CUtensorMap dhmap,  // dh [S, ES]
                   const __grid_constant__ CUtensorMap gmap,
                   const bf16* __restrict__ g, const int* __restrict__ slot,
                   const bf16* __restrict__ wflat,
                   const int* __restrict__ aoff_g,"""),
    ("""      !tma::bf16_map(&dhmap, dh, S, ES, kDwStep))""",
     """      !tma::bf16_map(&dhmap, dh, S, ES, kDwStep) ||
      !tma::bf16_map(&gmap, g, S, D, 1))"""),
    ("  CUtensorMap xmap, hmap, dhmap;\n  if (!tma::bf16_map(&xmap, xs, S, D, kDwStep)",
     "  CUtensorMap xmap, hmap, dhmap, gmap;\n  if (!tma::bf16_map(&xmap, xs, S, D, kDwStep)"),
    ("      xmap, hmap, dhmap, static_cast<const bf16*>(g),",
     "      xmap, hmap, dhmap, gmap, static_cast<const bf16*>(g),"),
    ("    uint64_t once = 0;\n    if (tid == 0) {\n      tma::prefetch(&xmap);",
     "    uint64_t once = tma::evict_first();\n    if (tid == 0) {\n      tma::prefetch(&xmap);"),
    (_DW_GATHER, """        if (ch % 8 == 0)
          tma::box(st + G::DO + (ch / 8) * kDwBox + 128 * r, &gmap, col,
                   static_cast<int>((s * kdiv) >> 32), &ring.full[sl], once);
"""),
    ("""#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        const int r = r0 + 2 * j;""", """      if (ch % 8 == 0)   // expect_tx without an arrival
        asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::
                     "r"(tiles::smem_u32(&ring.full[sl])), "r"(PASSES * 128) : "memory");
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        const int r = r0 + 2 * j;"""),
]

_DV_ONE_WAIT = ("""          tiles::WgmmaRS<64>::template run<24, 1>(acc, a[1], b1 + 128 * kk);
          tiles::wgmma_commit();
          tiles::wgmma_wait<0>();   // a is rewritten by the next k-step
""", """          tiles::WgmmaRS<64>::template run<24, 1>(acc, a[1], b1 + 128 * kk);
""")


def _gather_asm(qualifiers: str) -> str:
    """dW's gather copy with other cp.async qualifiers (an L2 prefetch
    size)."""
    return f"""        asm volatile("cp.async.cg.shared.global{qualifiers} [%0], [%1], 16, %2;" ::
                     "r"(tiles::smem_u32(st + G::DO + (ch / 8) * kDwBox +
                                         2 * tiles::block_offset<64>(r, 8 * (ch % 8)))),
                     "l"(__cvta_generic_to_global(g + (size_t)((s * kdiv) >> 32) * D + col)),
                     "r"(row + r - lo_e < n_e ? 16 : 0) : "memory");
"""


# name -> (kernel timed, edits of csrc/gmm2_bwd.cu)
K1BWD_VARIANTS = {
    "dw_gather_l2_256": ("dw", [(_DW_GATHER, _gather_asm(".L2::256B"))]),
    "dw_ring_3": ("dw", [("  static constexpr int STAGES = 2;\n",
                          "  static constexpr int STAGES = 3;\n")]),
    "dw_step_32": ("dw", [("constexpr int kDwStep = 64; ", "constexpr int kDwStep = 32; ")]),
    "dw_step_32_ring_4": ("dw", [
        ("constexpr int kDwStep = 64; ", "constexpr int kDwStep = 32; "),
        ("  static constexpr int STAGES = 2;\n", "  static constexpr int STAGES = 4;\n")]),
    "dw_groups_half": ("dw", [("  const int groups = sms / dw_tiles(D, ES);",
                               "  const int groups = sms / dw_tiles(D, ES) / 2;")]),
    "dw_gather_tma_rows": ("dw", _TMA_ROWS),
    # a k-step's do registers kept apart (a[kk]), one wait a stage
    "dw_dv_one_wait": ("dw", [
        _DV_ONE_WAIT,
        ("""      } else {
        const uint64_t a0 = tiles::block_desc<64>(st + G::XS / 2);""", """        tiles::wgmma_commit();
        tiles::wgmma_wait<0>();
      } else {
        const uint64_t a0 = tiles::block_desc<64>(st + G::XS / 2);""")]),
    "dx_ring_6": ("dx", [("  static constexpr int STAGES = 4;\n",
                          "  static constexpr int STAGES = 6;\n")]),
}
K1BWD_READINGS = {
    "dw_copy_stream": ("dw", [_in_kernel("dw", _no_products)]),
    "dx_copy_stream": ("dx", [_in_kernel("dx", _no_products)]),
    "dw_no_gather": ("dw", [(_DW_GATHER, "")]),
    "dw_copy_stream_no_gather": ("dw", [(_DW_GATHER, ""),
                                        _in_kernel("dw", _no_products)]),
    "dw_do_by_copy": ("dw", [
        (_DW_GATHER, ""),
        (_DW_EXPECT, """        tiles::mbar_expect(&ring.full[sl], 8 * kDwBox);
        for (int b = 0; b < 2; ++b)
          tma::box(st + G::DO + b * kDwBox, &xmap, mt * kDwBM + b * 64, row,
                   &ring.full[sl], once);
""")]),
    "dx_writes_do": ("dx", [
        ("""            a[kk][i] = scale_pair(a[kk][i], w_row[i & 1], w_row[i & 1]);
""", """            a[kk][i] = scale_pair(a[kk][i], w_row[i & 1], w_row[i & 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint32_t*>(
                dxs + (my_row + 8 * (i & 1)) * D + kd * 64 + 16 * kk + 2 * t +
                8 * (i >> 1)) = a[kk][i];
""")]),
}

# dW's phases in one block of group 5 (its first tile), summed over its
# stages with clock64() into a device array that gmm2_bwd_dw_cycles reads:
# each consumer warpgroup's waiting for a stage and computing (dkeys at 0,
# dvalues at 8; stages at 2 and 10; the whole loop at 3 and 11), the
# producer's waiting for a slot and issuing (4, 5)
_CYCLES_BLOCK = 5 * 4
_CYCLES = [
    ('#include "tensor_maps.cuh"\n',
     '#include "tensor_maps.cuh"\n\n__device__ unsigned long long gmm2_dw_cycles[16];\n'
     f"#define CYC_ON (blockIdx.x == {_CYCLES_BLOCK})\n"),
    ("""      const int sl = ring.consume();
      unsigned char* stage = smem + sl * G::SLOT;
""", """      const long long c0 = clock64();
      const int sl = ring.consume();
      const long long c1 = clock64();
      unsigned char* stage = smem + sl * G::SLOT;
"""),
    ("""      tiles::pin(acc);
      ring.release(sl, lane);
""", """      tiles::pin(acc);
      if ((tid & 127) == 0 && CYC_ON) {
        unsigned long long* pc = gmm2_dw_cycles + (is_dv ? 8 : 0);
        pc[0] += c1 - c0; pc[1] += clock64() - c1; pc[2] += 1;
      }
      ring.release(sl, lane);
"""),
    ("""  const bool is_dv = cw == 1;
  Piece p;
""", """  const bool is_dv = cw == 1;
  const long long cstart = clock64();
  Piece p;
"""),
    ("""
}

// The second pass: block (e, tile, gradient).""", """
  if ((tid & 127) == 0 && CYC_ON)
    gmm2_dw_cycles[(is_dv ? 8 : 0) + 3] += clock64() - cstart;
}

// The second pass: block (e, tile, gradient)."""),
    ("""      const int sl = ring.produce();
      unsigned char* st = smem + sl * G::SLOT;
      if (tid == 0) {""", """      const long long c0 = clock64();
      const int sl = ring.produce();
      const long long c1 = clock64();
      unsigned char* st = smem + sl * G::SLOT;
      if (tid == 0) {"""),
    ("""      tiles::cp_async_mbar_arrive(&ring.full[sl]);
""", """      tiles::cp_async_mbar_arrive(&ring.full[sl]);
      if (tid == 0 && CYC_ON) {
        gmm2_dw_cycles[4] += c1 - c0;
        gmm2_dw_cycles[5] += clock64() - c1;
      }
"""),
    (lambda text: text + """
extern "C" int gmm2_bwd_dw_cycles(void* out, int clear) {
  if (clear) {
    static const unsigned long long zero[16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(gmm2_dw_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, gmm2_dw_cycles, sizeof(gmm2_dw_cycles)));
}
"""),
]


def dw_cycles(lib_path, dw_args):
    """One launch of gmm2_bwd_dw built with _CYCLES: per-stage cycles of
    its phases in a dkeys and a dvalues block (group 5)."""
    import ctypes

    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    cf.use_library("gmm2_bwd", lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.gmm2_bwd_dw_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gf.gmm2_bwd_dw(*dw_args)
    torch.cuda.synchronize()
    lib.gmm2_bwd_dw_cycles(None, 1)
    gf.gmm2_bwd_dw(*dw_args)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    lib.gmm2_bwd_dw_cycles(ctypes.addressof(buf), 0)
    cf.use_library("gmm2_bwd", None)
    out = dict(producer_wait=buf[4] / max(buf[2], 1),
               producer_issue=buf[5] / max(buf[2], 1))
    for kind, o in (("dkeys", 0), ("dvalues", 8)):
        n = max(buf[o + 2], 1)
        out[kind] = dict(stages=buf[o + 2], wait=buf[o] / n,
                         compute=buf[o + 1] / n, loop=buf[o + 3])
    return out


def _edited(src: str, name: str, edits):
    text = src
    for edit in edits:
        if callable(edit):
            text = edit(text)
            continue
        old, new = edit
        if text.count(old) != 1:
            raise AssertionError(f"{name}: the edited text occurs "
                                 f"{text.count(old)} times")
        text = text.replace(old, new)
    return text


def edited_sources(tmp: Path, source: str, changes):
    """Write and compile the edited copies of csrc/<source>.cu (name ->
    edits, or (edits, attributes)); returns name -> library."""
    from competesmoe_tpu_torch import _kernels

    src = (_kernels.CSRC / f"{source}.cu").read_text()
    jobs, libs = [], {}
    for name, change in changes.items():
        edits = change[0] if isinstance(change, tuple) else change
        if isinstance(edits, dict):
            continue
        path = tmp / f"{name}.cu"
        path.write_text(_edited(src, name, edits))
        libs[name] = tmp / f"lib{name}.so"
        jobs.append((path, libs[name]))
    _kernels.compile_sources(jobs, verbose=True)
    return libs


def k5_operands(g):
    """x and the rotating weight copies at the four decode projections for
    every M of M_TIMED, as chip_smoke.phase_small_m times them."""
    ops = {}
    for m in M_TIMED:
        for _, k, n in cs.DECODE_SHAPES:
            x, (q, scale) = cs._small_m_operands("quant_small_m_matmul_int4",
                                                 g, m, k, n)
            copies = [q] + [q.clone() for _ in range(max(
                0, -(-256 * 2 ** 20 // q.numel()) - 1))]
            ops[(m, k, n)] = [(x, c, scale) for c in copies]
    return ops


def four_projections(fn, ops):
    """Four-projection µs per M."""
    return {m: sum(cs.time_launches(fn, args, 40)
                   for (mm, _, _), args in ops.items() if mm == m) * 1e3
            for m in M_TIMED}


def k5_ok():
    import torch
    g = torch.Generator(device="cuda").manual_seed(99)
    for _, k, n in cs.DECODE_SHAPES:
        for m in M_TIMED:
            err, tol, repeats, _, _ = cs.small_m_compare(
                "quant_small_m_matmul_int4", g, m, k, n)
            if not (err <= tol and repeats):
                return False
    return True


def apply(name, libs):
    """Route K5's wrapper to a variant or reading: an edited library and/or
    module attributes; returns what undoes it."""
    from competesmoe_tpu_torch.ops import matvec
    change = {**VARIANTS, **READINGS}[name]
    attrs = change[1] if isinstance(change, tuple) else (
        change if isinstance(change, dict) else {})
    old = {a: getattr(matvec, a) for a in attrs}
    for a, v in attrs.items():
        setattr(matvec, a, v)
    if name in libs:
        cf.use_library("matvec_int4", libs[name])

    def undo():
        for a, v in old.items():
            setattr(matvec, a, v)
        cf.use_library("matvec_int4", None)
    return undo


def _us(runs):
    return [[round(t[m], 2) for m in M_TIMED] for t in runs]


def k1_bwd_ok():
    """chip_smoke's K1-backward checks: the edge groups, the check shapes
    and the 154M layer."""
    rows = [r for _, part in cs.k1_bwd_checks(0) for r in part]
    rows += cs.k1_bwd_compare(*cs.k1_bwd_inputs(0, cs.K1_SHAPE))
    return all(r["ok"] for r in rows)


def k1_bwd_variants(report, failures):
    """Every K1-backward variant and reading against the kernels as built,
    in turns, at the 154M layer (µs of the kernel each edits)."""
    from competesmoe_tpu_torch.ops import gmm_fused as gf

    if not k1_bwd_ok():
        failures.append("K1's backward as built fails its check")
    dx_args, dw_args, _, _, _ = cs.k1_bwd_args(*cs.k1_bwd_inputs(
        0, cs.K1_SHAPE))
    timed = {"dx": (gf.gmm2_bwd_dx, dx_args), "dw": (gf.gmm2_bwd_dw, dw_args)}
    changes = {**K1BWD_VARIANTS, **K1BWD_READINGS}
    tmp = Path(tempfile.mkdtemp(prefix="chip_variants_k1bwd_"))
    try:
        libs = edited_sources(tmp, "gmm2_bwd", {
            **{n: c[1] for n, c in changes.items()}, "dw_cycles": _CYCLES})
        report["dw_cycles"] = dw_cycles(libs["dw_cycles"], dw_args)
        cs.log(f"dW cycles a stage in a block of group 5: "
               f"{json.dumps(report['dw_cycles'])}")
        for name, (kernel, _) in changes.items():
            fn, args = timed[kernel]
            us = lambda: cs.time_launches(fn, [args] * 4, 20) * 1e3  # noqa: E731
            built = [us()]
            cf.use_library("gmm2_bwd", libs[name])
            ok = k1_bwd_ok() if name in K1BWD_VARIANTS else None
            variant = [us(), us()]
            cf.use_library("gmm2_bwd", None)
            built.append(us())
            kind = "variants" if name in K1BWD_VARIANTS else "readings"
            report[kind][name] = dict(kernel=kernel, ok=ok,
                                      variant_us=variant, as_built_us=built)
            verdict = ("not checked" if ok is None
                       else "pass" if ok else "FAIL")
            cs.log(f"{name}: checks {verdict}; {kernel} at the 154M layer "
                   f"{[round(t, 1) for t in variant]} µs, as built "
                   f"{[round(t, 1) for t in built]} µs")
            if ok is False:
                failures.append(f"variant {name} fails its check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k5", "k1bwd"),
                    help="run one kernel's variants (default: both)")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    from competesmoe_tpu_torch import _kernels
    from competesmoe_tpu_torch.ops import matvec

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"device: {card}")
    report = dict(card=card, variants={}, readings={})
    failures = []
    if a.only != "k5":
        _kernels.build(["gmm2_fused", "gmm2_bwd"])
        k1_bwd_variants(report, failures)
    if a.only == "k1bwd":
        print("variants " + json.dumps(report), flush=True)
        for f in failures:
            print(f"chip_variants: {f}", file=sys.stderr)
        return 1 if failures else 0
    _kernels.build(["matvec_int4"])
    ops = k5_operands(torch.Generator(device="cuda").manual_seed(5))
    if not k5_ok():
        failures.append("the kernel as built fails its check")
    tmp = Path(tempfile.mkdtemp(prefix="chip_variants_"))
    try:
        libs = edited_sources(tmp, "matvec_int4", {**VARIANTS, **READINGS})
        for name in list(VARIANTS) + list(READINGS):
            times = lambda: four_projections(  # noqa: E731
                matvec.quant_small_m_matmul_int4, ops)
            built = [times()]
            undo = apply(name, libs)
            ok = k5_ok() if name in VARIANTS else None
            variant = [times(), times()]
            undo()
            built.append(times())
            kind = "variants" if name in VARIANTS else "readings"
            report[kind][name] = dict(ok=ok, variant_us=variant,
                                      as_built_us=built)
            verdict = ("not checked" if ok is None
                       else "pass" if ok else "FAIL")
            cs.log(f"{name}: checks {verdict}; four projections at M "
                   f"{list(M_TIMED)}: {_us(variant)}, as built {_us(built)} "
                   f"(µs)")
            if ok is False:
                failures.append(f"variant {name} fails its check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tiny = torch.zeros(16, device="cuda")
    report["graph_node_us"] = cs.time_launches(
        lambda t: t.add_(1.0), [(tiny,)] * 64, 40) * 1e3
    cs.log(f"a tiny PyTorch kernel a graph node: "
           f"{report['graph_node_us']:.2f} µs")
    print("variants " + json.dumps(report), flush=True)
    for f in failures:
        print(f"chip_variants: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
