#!/usr/bin/env python3
"""Planted kernel faults against the checks of chip_smoke.py (one CUDA GPU).

    python3 chip_faults.py

Each fault is a small edit of a kernel source (csrc/flash_attn.cu, K2,
csrc/gmm2_fused.cu, K1, or csrc/matvec_small_m.cu, K3 and K4), compiled
from an edited copy in a temporary directory; the checkout's sources are
not touched. The script

  1. reads the honest kernels' small-LM gaps: the small LM of chip_smoke.py
     takes 3 optimizer steps on the card and on the CPU from the same
     weights, for seeds 0-4 (the readings behind SMALL_LM_LOSS_TOL and
     SMALL_LM_GRAD_TOL);
  2. loads each faulty library in place of the honest one and runs the
     checks of chip_smoke.py that should catch it:
     - K2 faults: `k2_compare` at both K2 shapes, each tensor judged by
       the element-wise tile rule and, for comparison, by the old bound
       (2^-6 or 2^-5 x the largest |plain|);
     - the K1 fault: `k1_compare` at the 154M layer shape;
     - small-LM faults: `small_lm_gaps` of 3 steps (seed 0) against the
       CPU;
     - K3 and K4 faults: `small_m_compare` at the four decode projection
       shapes (M 1 and 8, and 40 for K4), and `small_engine_check`, the
       small served model's card-vs-CPU logits and engine streams (bf16
       for K3, int8 for K4); both checks also run on the honest kernels
       first.

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
        [("  for (int it = kt; it < n_qt; ++it) {",
          "  for (int it = kt; it < n_qt && kt < n_qt - 1; ++it) {")],
        ("k2",)),
    "fwd_mask_off_by_one": (
        "flash_attn",
        [("(kv <= qi && kv < T) ? srow[c] * scale",
          "(kv <= qi + 1 && kv < T) ? srow[c] * scale")],
        ("k2",)),
    "bwd_mask_off_by_one": (
        "flash_attn",
        [("const bool valid = kv <= qi && qi < T && kv < T;",
          "const bool valid = kv < qi && qi < T && kv < T;")],
        ("k2",)),
    "dq_missing_scale": (
        "flash_attn",
        [("const float ds = pv * (dp_w[r * kSLd + c] - dl) * scale;",
          "const float ds = pv * (dp_w[r * kSLd + c] - dl) * "
          "(p_rows ? scale : 1.0f);")],
        ("k2",)),
    "fwd_not_causal": (
        "flash_attn",
        [("  float m = -INFINITY, l = 0.0f;\n\n"
          "  for (int j = 0; j <= qt; ++j) {",
          "  float m = -INFINITY, l = 0.0f;\n\n"
          "  for (int j = 0; j < (int)gridDim.x; ++j) {"),
         ("(kv <= qi && kv < T) ? srow[c] * scale",
          "(kv < T) ? srow[c] * scale")],
        ("small_lm",)),
    "k1_drops_expert_0": (
        "gmm2_fused",
        [("vals[t] = __float2bfloat16_rn(stage[r * 16 + c + t]);",
          "vals[t] = __float2bfloat16_rn(e == 0 ? 0.0f : "
          "stage[r * 16 + c + t]);")],
        ("k1", "small_lm")),
    "k3_skips_last_k_split": (
        "matvec_small_m",
        [("  const int kend = min(K, kbeg + chunk);\n\n"
          "  float acc[MT][kOutPerWarp];",
          "  const int kend = split > 0 && split == (int)gridDim.y - 1\n"
          "                       ? kbeg : min(K, kbeg + chunk);\n\n"
          "  float acc[MT][kOutPerWarp];")],
        ("k3", "small_engine_bf16")),
    "k4_scale_twice": (
        "matvec_small_m",
        [("out[row * N + n] = __float2bfloat16(s * scale[n]);",
          "out[row * N + n] = __float2bfloat16(s * scale[n] * scale[n]);"),
         ("if (scale != nullptr) s *= scale[i % N];",
          "if (scale != nullptr) s *= scale[i % N] * scale[i % N];")],
        ("k4", "small_engine_int8")),
}
# K3/K4 shapes of the kernel check: the decode projections at these M
K34_CHECK_M = {"small_m_matmul": (1, 8), "quant_small_m_matmul": (1, 8, 40)}
SEEDS = range(5)


def build_faults(tmp: Path):
    """Compile every faulty source at once; returns fault -> library."""
    from competesmoe_tpu_torch import _kernels

    jobs, libs = [], {}
    for name, (src, edits, _) in FAULTS.items():
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
         "matvec_small_m": mv._bind_small_m}[src](lib)
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
    and M, with ok = (max_abs_err <= tol)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for label, k, n in cs.DECODE_SHAPES:
        for m in K34_CHECK_M[name]:
            err, tol, _, _ = cs.small_m_compare(name, g, m, k, n)
            rows.append(dict(proj=label, m=m, max_abs_err=err, tol=tol,
                             ok=err <= tol))
    return rows


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

        for name, kind in (("small_m_matmul", "bf16"),
                           ("quant_small_m_matmul", "int8")):
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
                xs, keys, values, te, _ = cs.k1_inputs(0)
                err, tol = cs.k1_compare(xs, keys, values, te)
                rows["k1"] = dict(max_abs_err=err, tol=tol, ok=err <= tol)
                failed["k1"] = not err <= tol
                cs.log(f"{name}: K1 max_abs_err {err:.4g}, tol {tol:.4g} "
                       f"-> {_verdict(err <= tol)}")
                del xs, keys, values, te
            if "small_lm" in checks:
                gaps = cs.small_lm_gaps(ref0, cs.small_lm_steps(
                    cs.small_lm_task(0, "cuda", init0)))
                rows["small_lm"] = gaps
                failed["small_lm"] = not all(d["ok"] for d in gaps)
                cs.log(f"{name}: small LM loss gaps {_g(gaps, 'loss_gap')}, "
                       f"grad_norm gaps {_g(gaps, 'grad_gap')} -> "
                       f"{_verdict(not failed['small_lm'])}")
            for check, kernel in (("k3", "small_m_matmul"),
                                  ("k4", "quant_small_m_matmul")):
                if check in checks:
                    rows[check] = k34_rows(kernel)
                    failed[check] = not all(r["ok"] for r in rows[check])
                    worst = max(r["max_abs_err"] / r["tol"]
                                for r in rows[check])
                    cs.log(f"{name}: {kernel} worst {worst:.3g} of its "
                           f"tolerance -> {_verdict(not failed[check])}")
            for kind in ("bf16", "int8"):
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
