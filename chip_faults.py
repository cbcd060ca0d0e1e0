#!/usr/bin/env python3
"""Planted faults against the checks of chip_smoke.py (one CUDA GPU).

    python3 chip_faults.py

Each fault is a small edit of a kernel source (csrc/flash_attn.cu, K2,
csrc/gmm2_fused.cu, K1, csrc/matvec_small_m.cu, K3 and K4, or
csrc/matvec_int4.cu, K5), compiled
from an edited copy in a temporary directory (csrc/'s headers are found
through the build's include path); the checkout's sources are not
touched. K2's forward faults: the causal comparison off by one, O not
rescaled when a row's max grows, and a forward that is not causal at all
(for the small-LM check). K2's backward faults: the last key tile's block
adds nothing to its dK and dV, the causal comparison off by one, dQ's dS
without its scale, the path without the comparison taken on the diagonal
tile (dK/dV, dQ), and lse and delta read by key instead of by query in
the transposed dK/dV kernel. K3's faults: the last K split of a cluster
adds nothing, and the cluster's reduction leaves out rank 0's partial
sums. K4's faults: the scale applied twice, -128 converted as -127 (as if
the weights were symmetric; every other byte right), the last 64-K stage
of each split dropped, and the cluster's reduction leaving out the last
rank (the reduction is the code K3 and K4 share). K5's faults: the high
nibble read unsigned, the low and high halves swapped against x, the last
64-row stage of each split dropped, the cluster's sum without its last
rank, two neighbouring outputs exchanged in the epilogue (tile rows g and
g + 8), and the scale skipped on the first block of outputs. K1's faults: the tiles
of expert 0 written as zeros, the relu skipped on the second 64 columns
of h, and the expert of the next tile taken for the second half of a
256-row tile (a block takes half a tile). Three more faults are planted
in the Python of the checkpoint path (CHECKPOINT_FAULTS, swapped in for
the check and back): two tower experts swapped by the converter,
`gate_kernel` taken without its transpose, and the second of two shards
skipped by the loader. The script

  1. reads the honest kernels' small-LM gaps: the small LM of chip_smoke.py
     takes 3 optimizer steps on the card and on the CPU from the same
     weights, for seeds 0-4 (the readings behind SMALL_LM_LOSS_TOL and
     SMALL_LM_GRAD_TOL);
  2. loads each faulty library in place of the honest one and runs the
     checks of chip_smoke.py that should catch it:
     - K2 faults: `k2_compare` at every K2 shape, each tensor judged by
       the element-wise tile rule and, for comparison, by the old bound
       (2^-6 or 2^-5 x the largest |plain|);
     - K1 faults: `k1_compare` at the 154M layer shape and at
       chip_smoke's K1 check shapes (ES 256, 384, 512);
     - small-LM faults: `small_lm_gaps` of 3 steps (seed 0) against the
       CPU;
     - K3, K4 and K5 faults: `small_m_compare` at the four decode
       projection shapes (M 1 and 8; 40 for K4; 40 and 128 for K5), and
       `small_engine_check`, the small served model's card-vs-CPU logits
       and engine streams (bf16 for K3, int8 for K4, int4 for K5); both
       checks also run on the honest kernels first;
     - checkpoint faults: `small_checkpoint_check` (a small model written
       in two shards, reloaded in bf16 and with --load-4bit, every
       tensor held to the writer's), honest first.

It prints one line per fault and check and a `faults` JSON line, and
exits non-zero if an honest run fails its check or a fault passes any
check that is meant to catch it.
"""

import ctypes
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs

# name -> (kernel source, [(text, replacement), ...], checks meant to
# catch it)
FAULTS = {
    "dkv_skips_last_key_tile": (
        "flash_attn",
        [("    tiles::as_a(pa, st);\n",
          "    if (kt == n_qt - 1) tiles::zero(st);\n"
          "    tiles::as_a(pa, st);\n")],
        ("k2",)),
    "fwd_mask_off_by_one": (
        "flash_attn",
        [("          if (!attends(j * kB + 8 * n + 2 * t + (e & 1), qi0 + 8 * (e >> 1), T))",
          "          if (!attends(j * kB + 8 * n + 2 * t + (e & 1), qi0 + 8 * (e >> 1) + 1, T))")],
        ("k2",)),
    "fwd_skips_alpha_rescale": (
        "flash_attn",
        [("for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];",
          "for (int e = 0; e < 4; ++e) o_acc[n][e] *= 1.0f;")],
        ("k2",)),
    "bwd_mask_off_by_one": (
        "flash_attn",
        [("  return kv <= qi && qi < T && kv < T;",
          "  return kv < qi && qi < T && kv < T;")],
        ("k2",)),
    "dq_missing_scale": (
        "flash_attn",
        [("dp[n][e] = ds_of(s[n][e], dp[n][e], dl[e >> 1], scale);",
          "dp[n][e] = ds_of(s[n][e], dp[n][e], dl[e >> 1], 1.0f);")],
        ("k2",)),
    "dkv_fast_path_on_diagonal": (
        "flash_attn",
        [("    const bool edge = it == kt || q0 + kB > T;",
          "    const bool edge = q0 + kB > T;")],
        ("k2",)),
    "dq_fast_path_on_diagonal": (
        "flash_attn",
        [("    const bool edge = j == qt; ",
          "    const bool edge = j == qt && q0 + kB > T; ")],
        ("k2",)),
    "dkv_stats_by_key": (
        "flash_attn",
        [("lse_s[col] * kLog2e);",
          "lse_s[warp * 16 + g + 8 * (e >> 1)] * kLog2e);"),
         ("                          delta_s[8 * n + 2 * t + (e & 1)], scale);",
          "                          delta_s[warp * 16 + g + 8 * ((e >> 1) & 1)],"
          " scale);")],
        ("k2",)),
    "fwd_not_causal": (
        "flash_attn",
        [("  const int last = min(2 * qp + 1, n_tiles - 1);",
          "  const int last = n_tiles - 1;"),
         ("    const bool active = j <= qt;",
          "    const bool active = true;"),
         ("    if (j == qt) {                         // the diagonal tile",
          "    if (j == last) {                       // the diagonal tile"),
         ("          if (!attends(j * kB + 8 * n + 2 * t + (e & 1), qi0 + 8 * (e >> 1), T))",
          "          if (j * kB + 8 * n + 2 * t + (e & 1) >= T)")],
        ("small_lm",)),
    "k1_drops_expert_0": (
        "gmm2_fused",
        [("              make_uint4(v[0], v[1], v[2], v[3]);",
          "              tile_expert[u * G::ROWS / kTile] == 0\n"
          "                  ? make_uint4(0u, 0u, 0u, 0u)\n"
          "                  : make_uint4(v[0], v[1], v[2], v[3]);")],
        ("k1", "small_lm")),
    "k1_skips_relu_on_a_chunk": (
        "gmm2_fused",
        [("for (int e = 0; e < 4; ++e) acc[n][e] = fmaxf(acc[n][e], 0.0f);",
          "for (int e = 0; e < 4; ++e)\n"
          "          acc[n][e] = n < 8 ? fmaxf(acc[n][e], 0.0f) : acc[n][e];")],
        ("k1",)),
    "k1_second_half_takes_next_expert": (
        "gmm2_fused",
        [("        const int e = tile_expert[row0 / kTile];",
          "        const int e = tile_expert[(row0 + kTile / 2) / kTile];")],
        ("k1",)),
    "k3_skips_last_k_split": (
        "matvec_small_m",
        [("  const int k_end = min(K, k_begin + chunk);",
          "  const int k_end = split > 0 && split == splits - 1\n"
          "                        ? k_begin : min(K, k_begin + chunk);")],
        ("k3", "small_engine_bf16")),
    "k3_cluster_drops_a_rank": (
        "matvec_small_m",
        [("      if (rank < splits) sum += parts[rank];",
          "      if (rank > 0 && rank < splits) sum += parts[rank];")],
        ("k3", "small_engine_bf16")),
    "k4_scale_twice": (
        "matvec_small_m",
        [("if (row[h] < rows) s[h] = scale[n0 + row[h]];",
          "if (row[h] < rows) s[h] = scale[n0 + row[h]] * scale[n0 + row[h]];"),
         ("if constexpr (kInt8) sum *= scale[n0 + i];",
          "if constexpr (kInt8) sum *= scale[n0 + i] * scale[n0 + i];")],
        ("k4", "small_engine_int8")),
    "k4_converts_minus_128_as_minus_127": (
        "matvec_small_m",
        [("0x43004300u), \"r\"((hi & 0x00800080u) | 0x43004300u));\n"
          "  return r;",
          "0x43004300u), \"r\"((hi & 0x00800080u) | 0x43004300u));\n"
          "  asm(\"max.bf16x2 %0, %0, %1;\\n\" : \"+r\"(r.x) : \"r\"(0xC2FEC2FEu));\n"
          "  asm(\"max.bf16x2 %0, %0, %1;\\n\" : \"+r\"(r.y) : \"r\"(0xC2FEC2FEu));\n"
          "  return r;")],
        ("k4",)),
    "k4_drops_last_k_stage": (
        "matvec_small_m",
        [("(k_stop - k_first + kStageK4 - 1) / kStageK4 : 0;",
          "(k_stop - k_first + kStageK4 - 1) / kStageK4 - 1 : 0;")],
        ("k4", "small_engine_int8")),
    "k4_cluster_drops_a_rank": (
        "matvec_small_m",
        [("      if (rank < splits) sum += parts[rank];",
          "      if (rank + 1 < splits) sum += parts[rank];")],
        ("k4", "small_engine_int8")),
    "k5_high_nibble_unsigned": (
        "matvec_int4",
        [("template <int E>\n__device__ __forceinline__ void unpack(",
          "__device__ __forceinline__ uint32_t unsigned_bf16(uint32_t r) {\n"
          "  uint32_t v = (r & 0x000F000Fu) | 0x43004300u;\n"
          "  asm(\"sub.rn.bf16x2 %0, %0, %1;\\n\" : \"+r\"(v) : \"r\"(0x43004300u));\n"
          "  return v;\n"
          "}\n\n"
          "template <int E>\n__device__ __forceinline__ void unpack("),
         ("    a[tile][1][E] = to_bf16(r >> 4);\n"
          "    a[tile][1][E + 1] = to_bf16(r >> 12);",
          "    a[tile][1][E] = unsigned_bf16(r >> 4);\n"
          "    a[tile][1][E + 1] = unsigned_bf16(r >> 12);")],
        ("k5", "small_engine_int4")),
    "k5_halves_swapped": (
        "matvec_int4",
        [("          product<NT>(acc[tile], a[kk][tile][0], lo + 2 * kk);\n"
          "          product<NT>(acc[tile], a[kk][tile][1], hi + 2 * kk);",
          "          product<NT>(acc[tile], a[kk][tile][0], hi + 2 * kk);\n"
          "          product<NT>(acc[tile], a[kk][tile][1], lo + 2 * kk);")],
        ("k5", "small_engine_int4")),
    "k5_drops_last_k_stage": (
        "matvec_int4",
        [("k_stop > k_first ? (k_stop - k_first + kStageK - 1) / kStageK : 0;",
          "k_stop > k_first ? (k_stop - k_first + kStageK - 1) / kStageK - 1 : 0;")],
        ("k5", "small_engine_int4")),
    "k5_cluster_drops_last_rank": (
        "matvec_int4",
        [("for (int rank = 0; rank < splits; ++rank) {",
          "for (int rank = 0; rank + 1 < splits; ++rank) {")],
        ("k5",)),
    "k5_outputs_off_by_one_row": (
        "matvec_int4",
        [("tiles::pack_bf16(acc[0][nt][p] * s.x, acc[0][nt][2 + p] * s.y),",
          "tiles::pack_bf16(acc[0][nt][2 + p] * s.x, acc[0][nt][p] * s.y),"),
         ("make_float4(acc[0][nt][p], acc[0][nt][2 + p], acc[1][nt][p],",
          "make_float4(acc[0][nt][2 + p], acc[0][nt][p], acc[1][nt][p],")],
        ("k5", "small_engine_int4")),
    "k5_skips_scale_on_a_block": (
        "matvec_int4",
        [("      const float4 s = *reinterpret_cast<const float4*>(scale + n0 + i);",
          "      const float4 s = n0 == 0 ? make_float4(1.0f, 1.0f, 1.0f, 1.0f)\n"
          "          : *reinterpret_cast<const float4*>(scale + n0 + i);"),
         ("    const float4 s = *reinterpret_cast<const float4*>(scale + n0 + o);",
          "    const float4 s = n0 == 0 ? make_float4(1.0f, 1.0f, 1.0f, 1.0f)\n"
          "        : *reinterpret_cast<const float4*>(scale + n0 + o);")],
        ("k5", "small_engine_int4")),
}


def _swap_tower_experts(loader, builder):
    """The converter stacks layer 0's tower experts 0 and 1 swapped."""
    real = builder.convert_siglip_tower

    def planted(*args, **kwargs):
        out = real(*args, **kwargs)
        for k in ("experts_w1", "experts_b1", "experts_w2", "experts_b2"):
            t = out[f"layers.0.moelayer.{k}"]
            out[f"layers.0.moelayer.{k}"] = t[[1, 0, *range(2, len(t))]]
        return out
    return builder, "convert_siglip_tower", planted


def _gate_not_transposed(loader, builder):
    """`gate.weight` [E, in] taken as `gate_kernel` without the
    transpose."""
    return loader, "_t", lambda w: w.contiguous()


def _second_shard_skipped(loader, builder):
    """The loader reads the first shard of two and skips the second."""
    real = loader.load_file

    def planted(path, device=None):
        return {} if "00002-of-00002" in str(path) else real(path, device)
    return loader, "load_file", planted


# Python faults of the checkpoint path, each a function of (hf_loader,
# builder) -> (module, attribute, planted value), caught by
# chip_smoke.small_checkpoint_check (the first step of the checkpoint
# phase)
CHECKPOINT_FAULTS = {
    "tower_experts_swapped": _swap_tower_experts,
    "gate_kernel_not_transposed": _gate_not_transposed,
    "second_shard_skipped": _second_shard_skipped,
}
# K3/K4/K5 shapes of the kernel check: the decode projections at these M
K34_CHECK_M = {"small_m_matmul": (1, 8), "quant_small_m_matmul": (1, 8, 40),
               "quant_small_m_matmul_int4": (1, 8, 40, 128)}
SEEDS = range(5)


def build_faults(tmp: Path, faults=None):
    """Compile every edited source of `faults` (name -> (source, edits,
    ...); default FAULTS) at once; returns name -> library."""
    from competesmoe_tpu_torch import _kernels

    jobs, libs = [], {}
    for name, (src, edits, *_) in (faults or FAULTS).items():
        text = (_kernels.CSRC / f"{src}.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the edited text occurs "
                                     f"{text.count(old)} times in {src}.cu")
            text = text.replace(old, new)
        path = tmp / f"{name}.cu"
        path.write_text(text)
        libs[name] = tmp / f"lib{name}.so"
        jobs.append((path, libs[name]))
    _kernels.compile_sources(jobs)
    return libs


def use_library(src: str, path=None):
    """Route the wrappers of csrc/<src>.cu to the library at `path`, or
    back to the honest one when `path` is None."""
    from competesmoe_tpu_torch import _kernels
    from competesmoe_tpu_torch.ops import flash_attention as fa
    from competesmoe_tpu_torch.ops import gmm_fused as gf
    from competesmoe_tpu_torch.ops import matvec as mv

    _kernels._LIBS.pop(src, None)
    if path is not None:
        lib = ctypes.CDLL(str(path))
        {"flash_attn": fa._bind, "gmm2_fused": gf._bind,
         "matvec_small_m": mv._bind_small_m, "matvec_int4": mv._bind}[src](lib)
        _kernels._LIBS[src] = lib


def _g(gaps, key):
    """One gap per step, to 3 significant digits."""
    return [float(f"{d[key]:.3g}") for d in gaps]


def _verdict(ok: bool) -> str:
    return "passes" if ok else "FAILS"


def k2_inputs():
    import torch
    g = torch.Generator(device="cuda").manual_seed(202)
    for B, h, T, p in cs.K2_SHAPES:
        q, k, v, do = (torch.randn(B, h, T, p, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        yield (B, h, T, p), (q, k, v, do, p ** -0.5)


def k34_rows(name: str):
    """`small_m_compare` at the decode projection shapes: one row per shape
    and M, with ok = (max_abs_err <= tol and a second run repeats)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for label, k, n in cs.DECODE_SHAPES:
        for m in K34_CHECK_M[name]:
            err, tol, repeats, _, _ = cs.small_m_compare(name, g, m, k, n)
            rows.append(dict(proj=label, m=m, max_abs_err=err, tol=tol,
                             repeats=repeats, ok=err <= tol and repeats))
    return rows


def k1_rows():
    """`k1_compare` at the 154M layer shape and at every K1 check shape:
    one row each, with ok = (max_abs_err <= tol and a second run
    repeats)."""
    rows = []
    xs, keys, values, te, _ = cs.k1_inputs(0)
    checks = [(cs.K1_SHAPE, *cs.k1_compare(xs, keys, values, te))]
    del xs, keys, values, te
    for shape, err, tol, repeats in checks + cs.k1_checks(0):
        rows.append(dict(shape=shape, max_abs_err=err, tol=tol,
                         repeats=repeats, ok=err <= tol and repeats))
    return rows


def checkpoint_ok(fault=None):
    """(passed, message) of chip_smoke's small checkpoint check, with the
    checkpoint fault `fault` (a CHECKPOINT_FAULTS name) planted for its
    duration. Any exception counts as caught."""
    from competesmoe_tpu_torch.models import builder, hf_loader

    undo = None
    if fault is not None:
        module, attr, planted = CHECKPOINT_FAULTS[fault](hf_loader, builder)
        undo = (module, attr, getattr(module, attr))
        setattr(module, attr, planted)
    try:
        cs.small_checkpoint_check(0)
        return True, "passes"
    except Exception as e:  # noqa: BLE001 - any failure is the catch
        return False, f"{type(e).__name__}: {str(e)[:140]}"
    finally:
        if undo is not None:
            setattr(*undo)


def small_engine_ok(kind: str):
    """(passed, message) of chip_smoke's small served-model check."""
    try:
        cs.small_engine_check(kind, 0)
        return True, "passes"
    except AssertionError as e:
        return False, str(e)[:160]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 1
    from competesmoe_tpu_torch import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"device: {card}")
    t0 = time.perf_counter()
    _kernels.build()
    tmp = Path(tempfile.mkdtemp(prefix="chip_faults_"))
    failures, report = [], dict(card=card, honest_small_lm=[], faults={})
    try:
        libs = build_faults(tmp)
        cs.log(f"build: honest and {len(libs)} faulty libraries in "
               f"{time.perf_counter() - t0:.1f} s")

        ref0 = init0 = None
        for seed in SEEDS:
            cpu = cs.small_lm_task(seed, "cpu")
            init = {k: v.clone() for k, v in cpu.model.state_dict().items()}
            card_rows = cs.small_lm_steps(cs.small_lm_task(seed, "cuda",
                                                           init))
            ref = cs.small_lm_steps(cpu)
            gaps = cs.small_lm_gaps(ref, card_rows)
            if seed == 0:
                ref0, init0 = ref, init
            report["honest_small_lm"].append(dict(seed=seed, steps=gaps))
            cs.log(f"honest small LM seed {seed}: flips "
                   f"{[d['flips'] for d in gaps]}, loss gaps "
                   f"{_g(gaps, 'loss_gap')}, "
                   f"grad_norm gaps "
                   f"{_g(gaps, 'grad_gap')}")
            if not all(d["ok"] for d in gaps):
                failures.append(f"honest small LM, seed {seed}: {gaps}")
        hs = [d for r in report["honest_small_lm"] for d in r["steps"]]
        cs.log(f"honest small LM over seeds {list(SEEDS)}: largest loss gap "
               f"{max(d['loss_gap'] for d in hs):.3g} (tol "
               f"{cs.SMALL_LM_LOSS_TOL}), largest grad_norm gap "
               f"{max(d['grad_gap'] for d in hs):.3g} (tol "
               f"{cs.SMALL_LM_GRAD_TOL})")

        for kind, name in cs.SERVED_KERNEL.items():
            rows = k34_rows(name)
            ok, msg = small_engine_ok(kind)
            report[f"honest_{name}"] = dict(rows=rows, small_engine=msg)
            worst = max(r["max_abs_err"] / r["tol"] for r in rows)
            cs.log(f"honest {name}: worst {worst:.3g} of its tolerance; "
                   f"small {kind} engine check {msg}")
            if not (ok and all(r["ok"] for r in rows)):
                failures.append(f"honest {name}: {rows} {msg}")

        for name, (src, _, checks) in FAULTS.items():
            use_library(src, libs[name])
            failed, rows = {}, {}
            if "k2" in checks:
                rows["k2"] = []
                for shape, args in k2_inputs():
                    for c in cs.k2_compare(*args):
                        rows["k2"].append(dict(c, shape=list(shape)))
                        cs.log(f"{name}: {c['tensor']:3s} at {shape} worst "
                               f"{c['worst']:.3g} of its tolerance -> "
                               f"{_verdict(c['ok'])} (old rule: "
                               f"{_verdict(c['old_rule_ok'])})")
                failed["k2"] = not all(c["ok"] for c in rows["k2"])
            if "k1" in checks:
                rows["k1"] = k1_rows()
                failed["k1"] = not all(r["ok"] for r in rows["k1"])
                for r in rows["k1"]:
                    cs.log(f"{name}: K1 at {r['shape']} max_abs_err "
                           f"{r['max_abs_err']:.4g}, tol {r['tol']:.4g}, "
                           f"repeats {r['repeats']} -> {_verdict(r['ok'])}")
            if "small_lm" in checks:
                gaps = cs.small_lm_gaps(ref0, cs.small_lm_steps(
                    cs.small_lm_task(0, "cuda", init0)))
                rows["small_lm"] = gaps
                failed["small_lm"] = not all(d["ok"] for d in gaps)
                cs.log(f"{name}: small LM loss gaps {_g(gaps, 'loss_gap')}, "
                       f"grad_norm gaps {_g(gaps, 'grad_gap')} -> "
                       f"{_verdict(not failed['small_lm'])}")
            for check, kernel in (("k3", "small_m_matmul"),
                                  ("k4", "quant_small_m_matmul"),
                                  ("k5", "quant_small_m_matmul_int4")):
                if check in checks:
                    rows[check] = k34_rows(kernel)
                    failed[check] = not all(r["ok"] for r in rows[check])
                    worst = max(r["max_abs_err"] / r["tol"]
                                for r in rows[check])
                    cs.log(f"{name}: {kernel} worst {worst:.3g} of its "
                           f"tolerance -> {_verdict(not failed[check])}")
            for kind in cs.SERVED_KERNEL:
                check = f"small_engine_{kind}"
                if check in checks:
                    ok, msg = small_engine_ok(kind)
                    rows[check] = msg
                    failed[check] = not ok
                    cs.log(f"{name}: small {kind} engine check -> "
                           f"{_verdict(ok)} ({msg})")
            use_library(src, None)
            report["faults"][name] = dict(failed=failed, **rows)
            for check, f in failed.items():
                if not f:
                    failures.append(f"fault {name} passed the {check} check")

        ok, msg = checkpoint_ok()
        report["honest_checkpoint"] = msg
        cs.log(f"honest small checkpoint check: {msg}")
        if not ok:
            failures.append(f"honest checkpoint check: {msg}")
        for name in CHECKPOINT_FAULTS:
            ok, msg = checkpoint_ok(name)
            report["faults"][name] = dict(failed={"checkpoint": not ok},
                                          checkpoint=msg)
            cs.log(f"{name}: small checkpoint check -> {_verdict(ok)} "
                   f"({msg})")
            if ok:
                failures.append(f"fault {name} passed the checkpoint check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("faults " + json.dumps(report), flush=True)
    for f in failures:
        print(f"chip_faults: {f}", file=sys.stderr)
    cs.log(f"chip_faults: {'FAILED' if failures else 'every fault caught'} "
           f"in {time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
