#!/usr/bin/env python3
"""Design variants of K4 and K1 against the kernels as built (one CUDA
GPU).

    python3 chip_variants.py

A variant is either a small edit of a kernel source, compiled from an
edited copy in a temporary directory as chip_faults.py compiles its
faults (the checkout's sources are not touched), or a changed attribute
of a wrapper's module (a geometry the wrapper passes to the kernel). Every
variant is first held to the checks of chip_smoke.py (K4: `small_m_compare`
at the decode shapes and M 1, 8, 40 and 128; K1: `k1_compare` at the 154M
layer shape and the K1 check shapes), then timed beside the kernel as
built, in turns (as built, variant, variant, as built), from CUDA-graph
replays as chip_smoke.py times kernels:

- K4, one decoder layer's four projections at M 8 and 40: the ring of
  72 KB (two blocks an SM) at every M instead of 40 KB (three) up to M 40;
  K splits that aim for one block an SM instead of one and a half;
- K1 at the 154M layer shape, its bf16 weight cast included: blocks of
  a whole tile (four consumer warpgroups, the weights from L2 half as
  often) instead of half a tile (two); a ring of 4 stages instead of 6.

K3, for reference, is timed at M 8 beside K4 in the same call. It prints
one line per variant and a `variants` JSON line, and exits non-zero if a
variant or the kernel as built fails its check.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

import chip_faults as cf
import chip_smoke as cs

# name -> (kernel source, [(text, replacement), ...]) or
# (kernel source, {module attribute: value}) for ops/matvec.py or
# ops/gmm_fused.py
VARIANTS = {
    "k4_ring_72k_at_every_m": ("matvec_small_m", [(
        "(NT <= 5 ? 40 : 72) * 1024 / STAGE", "72 * 1024 / STAGE")]),
    "k4_splits_for_one_block_an_sm": ("matvec_small_m", {
        "_K4_GEOMETRY": (128, 64, 1.0)}),
    "k1_blocks_of_a_whole_tile": ("gmm2_fused", [(
        "static constexpr int GROUPS = 2;",
        "static constexpr int GROUPS = HC == 1 ? 4 : 2;")]),
    "k1_ring_of_4": ("gmm2_fused", [(
        "constexpr int kRingBytes = 192 * 1024;",
        "constexpr int kRingBytes = 128 * 1024;")]),
}
K4_M = (8, 40)


def k4_operands(g):
    """x and the rotating weight copies at the four decode projections
    for every M of K4_M, as chip_smoke.phase_small_m times them."""
    ops = {}
    for m in K4_M:
        for _, k, n in cs.DECODE_SHAPES:
            x, (q, scale) = cs._small_m_operands("quant_small_m_matmul", g, m,
                                                 k, n)
            copies = [q] + [q.clone() for _ in range(max(
                0, -(-256 * 2 ** 20 // q.numel()) - 1))]
            ops[(m, k, n)] = [(x, c, scale) for c in copies]
    return ops


def four_projections(fn, ops):
    """Four-projection µs per M."""
    return {m: sum(cs.time_launches(fn, args, 40)
                   for (mm, _, _), args in ops.items() if mm == m) * 1e3
            for m in sorted({m for m, _, _ in ops})}


def k4_ok():
    import torch
    g = torch.Generator(device="cuda").manual_seed(99)
    for _, k, n in cs.DECODE_SHAPES:
        for m in (1, 8, 40, 128):
            err, tol, repeats, _, _ = cs.small_m_compare(
                "quant_small_m_matmul", g, m, k, n)
            if not (err <= tol and repeats):
                return False
    return True


def k1_ok():
    return all(r["ok"] for r in cf.k1_rows())


def apply(src, change):
    """Route `src`'s wrapper to a variant: an edited library (a path) or
    module attributes (a dict); returns what undoes it."""
    from competesmoe_tpu_torch.ops import gmm_fused, matvec
    if isinstance(change, dict):
        module = matvec if src == "matvec_small_m" else gmm_fused
        old = {a: getattr(module, a) for a in change}
        for a, v in change.items():
            setattr(module, a, v)
        return lambda: [setattr(module, a, v) for a, v in old.items()]
    cf.use_library(src, change)
    return lambda: cf.use_library(src, None)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    from competesmoe_tpu_torch import _kernels
    from competesmoe_tpu_torch.ops import gmm_fused as gf
    from competesmoe_tpu_torch.ops import matvec

    card = cs.card_line()
    cs.log(f"device: {card}")
    _kernels.build(["matvec_small_m", "gmm2_fused"])
    g = torch.Generator(device="cuda").manual_seed(5)
    ops = k4_operands(g)
    xs, keys, values, te, _ = cs.k1_inputs(0)
    k1_args = [(xs, keys, values, te)] * 4

    def times(src):
        if src == "matvec_small_m":
            return four_projections(matvec.quant_small_m_matmul, ops)
        return cs.time_launches(gf.gmm2_fused_aligned, k1_args, 20) * 1e3

    k3_ops = {}
    for _, k, n in cs.DECODE_SHAPES:
        x, (w,) = cs._small_m_operands("small_m_matmul", g, 8, k, n)
        store = w.t()
        copies = [store] + [store.clone() for _ in range(max(
            0, -(-256 * 2 ** 20 // (store.numel() * 2)) - 1))]
        k3_ops[(8, k, n)] = [(x, c.t()) for c in copies]
    report = dict(card=card, reference=dict(
        k3_m8=four_projections(matvec.small_m_matmul, k3_ops)[8]),
        variants={})
    failures = []
    if not (k4_ok() and k1_ok()):
        failures.append("the kernels as built fail their checks")
    tmp = Path(tempfile.mkdtemp(prefix="chip_variants_"))
    try:
        libs = cf.build_faults(tmp, {
            name: (src, change) for name, (src, change) in VARIANTS.items()
            if not isinstance(change, dict)})
        for name, (src, change) in VARIANTS.items():
            built = [times(src)]
            undo = apply(src, libs.get(name, change))
            ok = k4_ok() if src == "matvec_small_m" else k1_ok()
            variant = [times(src), times(src)]
            undo()
            built.append(times(src))
            report["variants"][name] = dict(ok=ok, variant_us=variant,
                                            as_built_us=built)
            cs.log(f"{name}: checks {'pass' if ok else 'FAIL'}; variant "
                   f"{variant}, as built {built} (µs)")
            if not ok:
                failures.append(f"variant {name} fails its check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log(f"reference: {report['reference']}")
    print("variants " + json.dumps(report), flush=True)
    for f in failures:
        print(f"chip_variants: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
