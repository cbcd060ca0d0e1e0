#!/usr/bin/env python3
"""Design variants of K2's forward and K3 against the kernels as built
(one CUDA GPU).

    python3 chip_variants.py

Each variant is a small edit of a kernel source, compiled from an edited
copy in a temporary directory as chip_faults.py compiles its faults; the
checkout's sources are not touched. Every variant is first held to the
checks of chip_smoke.py (K3: `small_m_compare` at the decode shapes;
K2: `k2_compare` at every K2 shape), then timed beside the kernel as
built and the library call, in turns (as built, variant, variant, as
built), from CUDA-graph replays as chip_smoke.py times kernels:

- K3, one decoder layer's four projections at M 1, 8 and 32 beside
  torch.matmul: a ring of 3 or 6 stages instead of 4; no L2 policies on
  the copies; an unsplit K that still sums through shared memory and
  the cluster's barriers, as the splits do;
- K2's forward at the 154M shape beside scaled_dot_product_attention:
  one block of two warpgroups an SM instead of two.

It prints one line per variant and a `variants` JSON line, and exits
non-zero if a variant or the kernel as built fails its check.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

import chip_faults as cf
import chip_smoke as cs

_HINT = ('"::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\\n"',
         '"::bytes [%0], [%1, {%2, %3}], [%4];\\n"')
# name -> (kernel source, [(text, replacement), ...])
VARIANTS = {
    "k3_ring_3": ("matvec_small_m", [("constexpr int kStages = 4;",
                                      "constexpr int kStages = 3;")]),
    "k3_ring_6": ("matvec_small_m", [("constexpr int kStages = 4;",
                                      "constexpr int kStages = 6;")]),
    "k3_no_l2_policy": ("matvec_small_m", [_HINT]),
    "k3_one_split_through_cluster": ("matvec_small_m", [
        ("  if (splits == 1) {", "  if (false) {")]),
    "k2_fwd_one_block_an_sm": (
        "flash_attn", [("__launch_bounds__(2 * kThreads, 2)",
                        "__launch_bounds__(2 * kThreads, 1)")]),
}
K3_M = (1, 8, 32)


def k3_operands(g):
    """x and the rotating weight copies at the four decode projections
    for every M of K3_M, as chip_smoke.phase_small_m times them."""
    import torch
    ops = {}
    for m in K3_M:
        for _, k, n in cs.DECODE_SHAPES:
            x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            wt = torch.randn(n, k, generator=g,
                             device="cuda").to(torch.bfloat16)
            copies = [wt] + [wt.clone() for _ in range(max(
                0, -(-256 * 2 ** 20 // (wt.numel() * 2)) - 1))]
            ops[(m, k, n)] = [(x, c.t()) for c in copies]
    return ops


def k3_times(fn, ops):
    """Four-projection µs per M."""
    return {m: sum(cs.time_launches(fn, args, 40)
                   for (mm, _, _), args in ops.items() if mm == m) * 1e3
            for m in K3_M}


def k3_ok():
    import torch
    g = torch.Generator(device="cuda").manual_seed(99)
    for _, k, n in cs.DECODE_SHAPES:
        for m in (1, 2, 3, 8, 17, 32):
            err, tol, repeats, _, _ = cs.small_m_compare("small_m_matmul", g,
                                                         m, k, n)
            if not (err <= tol and repeats):
                return False
    return True


def k2_ok():
    return all(c["ok"] for _, args in cf.k2_inputs()
               for c in cs.k2_compare(*args))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    from competesmoe_tpu_torch import _kernels
    from competesmoe_tpu_torch.ops import flash_attention as fa
    from competesmoe_tpu_torch.ops import matvec

    card = cs.card_line()
    cs.log(f"device: {card}")
    _kernels.build(["matvec_small_m", "flash_attn"])
    g = torch.Generator(device="cuda").manual_seed(5)
    ops = k3_operands(g)
    B, h, T, p = cs.K2_SHAPES[0]
    qkv = [torch.randn(B, h, T, p, generator=g, device="cuda")
           .to(torch.bfloat16) for _ in range(3)]
    k2_args = [(*qkv, p ** -0.5)] * 4

    def times(src):
        if src == "matvec_small_m":
            return k3_times(matvec.small_m_matmul, ops)
        return cs.time_launches(fa.flash_attention_fwd, k2_args, 20) * 1e3

    report = dict(card=card, library=dict(
        torch_matmul=k3_times(torch.matmul, ops),
        sdpa_fwd=cs.time_launches(
            lambda q, k, v, s: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True), k2_args, 20) * 1e3), variants={})
    failures = []
    if not (k3_ok() and k2_ok()):
        failures.append("the kernels as built fail their checks")
    tmp = Path(tempfile.mkdtemp(prefix="chip_variants_"))
    try:
        libs = cf.build_faults(tmp, VARIANTS)
        for name, (src, _) in VARIANTS.items():
            built = [times(src)]
            cf.use_library(src, libs[name])
            ok = k3_ok() if src == "matvec_small_m" else k2_ok()
            variant = [times(src), times(src)]
            cf.use_library(src, None)
            built.append(times(src))
            report["variants"][name] = dict(ok=ok, variant_us=variant,
                                            as_built_us=built)
            cs.log(f"{name}: checks {'pass' if ok else 'FAIL'}; variant "
                   f"{variant}, as built {built} (µs)")
            if not ok:
                failures.append(f"variant {name} fails its check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log(f"library: {report['library']}")
    print("variants " + json.dumps(report), flush=True)
    for f in failures:
        print(f"chip_variants: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
