#!/usr/bin/env python3
"""Design variants of K5 against the kernel as built (one CUDA GPU).

    python3 chip_variants.py

A variant is either an edit of csrc/matvec_int4.cu, compiled from an
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

It prints one line per variant and reading and a `variants` JSON line,
and exits non-zero if a variant or the kernel as built fails its check.
"""

import json
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


def edited_sources(tmp: Path):
    """Write and compile the edited copies; returns name -> library."""
    from competesmoe_tpu_torch import _kernels

    src = (_kernels.CSRC / "matvec_int4.cu").read_text()
    jobs, libs = [], {}
    for name, change in {**VARIANTS, **READINGS}.items():
        edits = change[0] if isinstance(change, tuple) else change
        if isinstance(edits, dict):
            continue
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
        path = tmp / f"{name}.cu"
        path.write_text(text)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    from competesmoe_tpu_torch import _kernels
    from competesmoe_tpu_torch.ops import matvec

    card = cs.card_line()
    cs.log(f"device: {card}")
    _kernels.build(["matvec_int4"])
    ops = k5_operands(torch.Generator(device="cuda").manual_seed(5))
    report = dict(card=card, variants={}, readings={})
    failures = []
    if not k5_ok():
        failures.append("the kernel as built fails its check")
    tmp = Path(tempfile.mkdtemp(prefix="chip_variants_"))
    try:
        libs = edited_sources(tmp)
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
