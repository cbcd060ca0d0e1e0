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
256-row tile (a block takes half a tile). K1's backward faults
(csrc/gmm2_bwd.cu): the relu mask dropped from dh, padding rows' slot
gradients not zeroed, the last tile of each expert's group skipped in dW,
and dW stored without its bf16 rounding. A router fault (ROUTER_FAULTS,
swapped in and back): smoe_sigmoid's weights left unnormalised. Three more faults are planted
in the Python of the checkpoint path (CHECKPOINT_FAULTS, swapped in for
the check and back): two tower experts swapped by the converter,
`gate_kernel` taken without its transpose, and the second of two shards
skipped by the loader. Three more are planted in the engine's features
(ENGINE_FAULTS): the unpark's suffix written one position late, the
final chunk's logits taken at the chunk's last slot, and the park key
without the pixel hash. Four more are planted in the captured decode
programs and the windowed read (CAPTURE_FAULTS): admission rebinding the
per-slot temperature and top_p tensors instead of writing into the
captured buffers, a captured step leaving the cache's pos buffer
unadvanced, the window's slice one key late against its mask, and the
launch accounting counting the capture only. The script

  1. reads the honest kernels' small-LM gaps: the small LM of chip_smoke.py
     takes 3 optimizer steps on the card and on the CPU from the same
     weights (the CPU taking the card's top-k choices), for each of its
     six routers and seeds 0-4 (the readings behind SMALL_LM_LOSS_TOL,
     SMALL_LM_GRAD_TOL, SMALL_LM_FLIP_SHARE and SMALL_LM_FLIP_GAP);
  2. loads each faulty library in place of the honest one and runs the
     checks of chip_smoke.py that should catch it:
     - K2 faults: `k2_compare` at every K2 shape, each tensor judged by
       the element-wise tile rule and, for comparison, by the old bound
       (2^-6 or 2^-5 x the largest |plain|);
     - K1 faults: `k1_compare` at the 154M layer shape and at
       chip_smoke's K1 check shapes (ES 256, 384, 512);
     - K1 backward faults: `k1_bwd_compare` on the edge groups, at the
       check shapes and at the 154M layer shape, honest first;
     - the router fault: `router_weights_check`, honest first;
     - small-LM faults: `small_lm_gaps` of 3 steps (seed 0) against the
       CPU;
     - K3, K4 and K5 faults: `small_m_compare` at the four decode
       projection shapes (M 1 and 8; 40 for K4; 40 and 128 for K5), and
       `small_engine_check`, the small served model's card-vs-CPU logits
       and engine streams (bf16 for K3, int8 for K4, int4 for K5); both
       checks also run on the honest kernels first;
     - checkpoint faults: `small_checkpoint_check` (a small model written
       in two shards, reloaded in bf16 and with --load-4bit, every
       tensor held to the writer's), honest first;
     - engine-feature faults: `small_engine_features_check` (chunked
       prefill and the prefix cache on a small int4 model against
       engines without them), honest first; the unpark fault also
       against `multiturn_check` at the full 5.1B width and depth
       (random int4 weights, FEATURES' engine: turn 2 against its parked
       row's continuation), honest first. The other two do not show
       there: its prompts carry no image, and the phase's long prompt
       fills its last chunk;
     - capture faults: `small_captured_check` (a small int4 model's
       engine and solo streams captured against eager, its launches
       through replays, windowed against full decoding), honest first.

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
    # K1's backward (csrc/gmm2_bwd.cu). Taking the relu mask from the f32
    # accumulator instead of the bf16-rounded h is no fault to plant:
    # rounding to nearest keeps the sign, and bf16 keeps f32's exponent
    # range, so the two masks are the same bits
    "k1bwd_relu_mask_dropped": (
        "gmm2_bwd",
        [("          acc[n][i] = (hmask >> (4 * n + i)) & 1 ? round_bf16(acc[n][i]) : 0.0f;",
          "          acc[n][i] = round_bf16(acc[n][i]);")],
        ("k1_bwd",)),
    "k1bwd_padding_do_not_zeroed": (
        "gmm2_bwd",
        [("  if (!valid) return make_uint4(0u, 0u, 0u, 0u);\n", "")],
        ("k1_bwd",)),
    "k1bwd_dw_skips_last_tile": (
        "gmm2_bwd",
        [("  const int n_steps = (n + 63) / 64;",
          "  const int n_steps = max(0, ((n + 255) / 256 - 1) * 4);")],
        ("k1_bwd",)),
    "k1bwd_dw_not_rounded": (
        "gmm2_bwd",
        [("          make_float2(round_bf16(acc[nt][2 * h]), round_bf16(acc[nt][2 * h + 1]));",
          "          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);")],
        ("k1_bwd",)),
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
def _unnormalised_sigmoid_route(self, x, logits):
    """PretrainSigmoidNorm.route with its weights left unnormalised."""
    from competesmoe_tpu_torch.ops import routing as R
    weights, sel, _ = R.topk_sigmoid(logits, self.topk)
    return weights, sel, R.sigmoid(logits)


# name -> fn(pretrain_layers module) -> (object, attribute, planted value):
# router faults, swapped in for `router_weights_check` and back
ROUTER_FAULTS = {
    "router_weights_unnormalised":
        lambda pl: (pl.PretrainSigmoidNorm, "route",
                    _unnormalised_sigmoid_route),
}


def router_ok(fault=None):
    """(passed, message) of chip_smoke's router weights check, with the
    ROUTER_FAULTS fault `fault` planted for its duration."""
    from competesmoe_tpu_torch.moe import pretrain_layers

    undo = None
    if fault is not None:
        obj, attr, planted = ROUTER_FAULTS[fault](pretrain_layers)
        undo = (obj, attr, obj.__dict__[attr])
        setattr(obj, attr, planted)
    try:
        cs.router_weights_check(0)
        return True, "passes"
    except Exception as e:  # noqa: BLE001 - any failure is the catch
        return False, f"{type(e).__name__}: {str(e)[:140]}"
    finally:
        if undo is not None:
            setattr(*undo)


CHECKPOINT_FAULTS = {
    "tower_experts_swapped": _swap_tower_experts,
    "gate_kernel_not_transposed": _gate_not_transposed,
    "second_shard_skipped": _second_shard_skipped,
}
def _unpark_one_late(engine):
    """The unpark's suffix written (and its positions taken) one position
    after the parked length."""
    real = engine.DecodeEngine._unpark_admit

    def planted(self, pslots, pos0, *rest):
        return real(self, pslots, pos0 + 1, *rest)
    return engine.DecodeEngine, "_unpark_admit", planted


def _chunk_logits_at_last_slot(engine):
    """The final chunk's first-token logits taken at the chunk's last slot
    (a pad slot when the chunk is partial), not its last real token."""
    def planted(self, ids, mask):
        out = self.model(self._dev(ids), None,
                         attention_mask=self._dev(mask), cache=self._stage)
        self._stage = out.cache
        return out.logits[:, -1]
    return engine.DecodeEngine, "_chunk_prefill", planted


def _park_key_without_pixels(engine):
    """Parked conversations keyed by their tokens alone: a follow-up with
    another image reuses the first image's row."""
    return engine.DecodeEngine, "_px_hash", staticmethod(lambda px: None)


# Python faults of the engine's features, each a function of the engine
# module -> (object, attribute, planted value), caught by
# chip_smoke.small_engine_features_check
ENGINE_FAULTS = {
    "unpark_suffix_one_late": _unpark_one_late,
    "chunk_logits_at_last_slot": _chunk_logits_at_last_slot,
    "park_key_without_pixel_hash": _park_key_without_pixels,
}
def _temps_rebound():
    """Admission rebinds the per-slot temperature and top_p tensors (as
    the engine did before its steps were captured) instead of writing
    into the buffers a captured step reads."""
    from competesmoe_tpu_torch.serve import engine
    real = engine.DecodeEngine._insert

    def planted(self, *args):
        self._temps_dev = self._temps_dev.clone()
        self._topps_dev = self._topps_dev.clone()
        return real(self, *args)
    return engine.DecodeEngine, "_insert", planted


def _pos_unadvanced_in_capture():
    """A captured step returns its advanced positions in a new tensor and
    leaves the cache's pos buffer where it was (eager steps advance it)."""
    import torch

    from competesmoe_tpu_torch.models import decoder
    real = decoder.DecoderLM.forward

    def planted(self, *args, pos_in_place=False, **kwargs):
        return real(self, *args, pos_in_place=pos_in_place and not
                    torch.cuda.is_current_stream_capturing(), **kwargs)
    return decoder.DecoderLM, "forward", planted


def _window_one_key_late():
    """The windowed read takes slots 1..w instead of 0..w-1: off by one
    key against the mask."""
    from competesmoe_tpu_torch.models import decoder
    return decoder, "_window", lambda t, w: t[:, 1:w + 1]


def _capture_counted_only():
    """The launch accounting keeps the counts a capture made and adds
    nothing at replays."""
    from competesmoe_tpu_torch.utils import cuda_graph
    return cuda_graph, "take_back_launches", lambda run, wrappers: (run(),
                                                                    [])


# Python faults of the captured decode programs and the windowed read,
# each a function -> (object, attribute, planted value), caught by
# chip_smoke.small_captured_check
CAPTURE_FAULTS = {
    "insert_rebinds_temps": _temps_rebound,
    "captured_pos_unadvanced": _pos_unadvanced_in_capture,
    "window_one_key_late": _window_one_key_late,
    "launches_counted_at_capture_only": _capture_counted_only,
}
# the ENGINE_FAULTS that chip_smoke.multiturn_check must catch at full size
FULL_SIZE_ENGINE_FAULTS = ("unpark_suffix_one_late",)
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
         "gmm2_bwd": gf._bind_bwd,
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


def k1_bwd_rows():
    """`k1_bwd_compare` on the edge groups, at the K1 check shapes and at
    the 154M layer shape: one row per shape and gradient."""
    rows = []
    checks = cs.k1_bwd_checks(0) + [("the 154M layer", cs.k1_bwd_compare(
        *cs.k1_bwd_inputs(0, cs.K1_SHAPE)))]
    for label, part in checks:
        rows += [dict(r, shape=label) for r in part]
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


def _planted(fault):
    """Plant the ENGINE_FAULTS fault `fault` (None: nothing); returns the
    undo (object, attribute, honest value) or None."""
    from competesmoe_tpu_torch.serve import engine

    if fault is None:
        return None
    obj, attr, planted = ENGINE_FAULTS[fault](engine)
    undo = (obj, attr, obj.__dict__[attr])
    setattr(obj, attr, planted)
    return undo


def full_multiturn_ok(model, fault=None):
    """(passed, message) of chip_smoke's multi-turn check on the full-size
    `model` through FEATURES' engine, with `fault` planted for its
    duration. Any exception counts as caught."""
    import numpy as np

    undo = _planted(fault)
    engine = cs.record_first_logits(cs.features_engine(model))
    path = cs.MainPath(model.language_model)
    try:
        r = cs.multiturn_check(model, engine, np.random.default_rng(11),
                               path)
        return True, (f"passes (first-token gaps "
                      f"{[round(g, 4) for g in r['first_logits_gap']]})")
    except Exception as e:  # noqa: BLE001 - any failure is the catch
        return False, f"{type(e).__name__}: {str(e)[:140]}"
    finally:
        engine.shutdown()
        path.fw.remove()
        if undo is not None:
            setattr(*undo)
        cs.free_card()


def engine_features_ok(fault=None):
    """(passed, message) of chip_smoke's small engine-features check, with
    the ENGINE_FAULTS fault `fault` planted for its duration. Any
    exception counts as caught."""
    undo = _planted(fault)
    try:
        cs.small_engine_features_check(0)
        return True, "passes"
    except Exception as e:  # noqa: BLE001 - any failure is the catch
        return False, f"{type(e).__name__}: {str(e)[:140]}"
    finally:
        if undo is not None:
            setattr(*undo)


def captured_ok(fault=None):
    """(passed, message) of chip_smoke's small captured-programs check,
    with the CAPTURE_FAULTS fault `fault` planted for its duration. Any
    exception counts as caught."""
    undo = None
    if fault is not None:
        obj, attr, planted = CAPTURE_FAULTS[fault]()
        undo = (obj, attr, obj.__dict__[attr])
        setattr(obj, attr, planted)
    try:
        r = cs.small_captured_check(0)
        return True, f"passes (window logits gap {r['window_logits_gap']:.4g})"
    except Exception as e:  # noqa: BLE001 - any failure is the catch
        return False, f"{type(e).__name__}: {str(e)[:140]}"
    finally:
        if undo is not None:
            setattr(*undo)
        cs.free_card()


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
        for router in cs.SMALL_LM_ROUTERS:
            flags = ["-moe_name", router]
            for seed in SEEDS:
                cpu = cs.small_lm_task(seed, "cpu", flags=flags)
                init = {k: v.clone()
                        for k, v in cpu.model.state_dict().items()}
                choices = []
                with cs.routed_as(record=choices):
                    card_rows = cs.small_lm_steps(
                        cs.small_lm_task(seed, "cuda", init, flags))
                with cs.routed_as(replay=choices) as seen:
                    ref = cs.small_lm_steps(cpu)
                gaps = cs.small_lm_gaps(ref, card_rows)
                if seed == 0 and router == "competesmoe":
                    ref0, init0 = ref, init
                share = seen["flipped"] / seen["rows"]
                report["honest_small_lm"].append(dict(
                    router=router, seed=seed, steps=gaps, topk=seen))
                cs.log(f"honest small LM {router} seed {seed}: flips "
                       f"{[d['flips'] for d in gaps]}, loss gaps "
                       f"{_g(gaps, 'loss_gap')}, grad_norm gaps "
                       f"{_g(gaps, 'grad_gap')}; top-k rows the CPU would "
                       f"choose otherwise {seen['flipped']} of "
                       f"{seen['rows']}, score gap {seen['gap']:.3g}")
                if not (all(d["ok"] for d in gaps)
                        and share <= cs.SMALL_LM_FLIP_SHARE
                        and seen["gap"] <= cs.SMALL_LM_FLIP_GAP[router]):
                    failures.append(f"honest small LM {router}, seed "
                                    f"{seed}: {gaps} {seen}")
        hs = [d for r in report["honest_small_lm"] for d in r["steps"]]
        ts = [dict(r["topk"], limit=cs.SMALL_LM_FLIP_GAP[r["router"]])
              for r in report["honest_small_lm"]]
        cs.log(f"honest small LM over seeds {list(SEEDS)} and routers "
               f"{list(cs.SMALL_LM_ROUTERS)}: largest loss gap "
               f"{max(d['loss_gap'] for d in hs):.3g} (tol "
               f"{cs.SMALL_LM_LOSS_TOL}), largest grad_norm gap "
               f"{max(d['grad_gap'] for d in hs):.3g} (tol "
               f"{cs.SMALL_LM_GRAD_TOL}), largest share of top-k rows "
               f"chosen otherwise "
               f"{max(t['flipped'] / t['rows'] for t in ts):.3%} (limit "
               f"{cs.SMALL_LM_FLIP_SHARE:.0%}), largest score gap over "
               f"its router's limit {max(t['gap'] / t['limit'] for t in ts):.3g}")

        for kind, name in cs.SERVED_KERNEL.items():
            rows = k34_rows(name)
            ok, msg = small_engine_ok(kind)
            report[f"honest_{name}"] = dict(rows=rows, small_engine=msg)
            worst = max(r["max_abs_err"] / r["tol"] for r in rows)
            cs.log(f"honest {name}: worst {worst:.3g} of its tolerance; "
                   f"small {kind} engine check {msg}")
            if not (ok and all(r["ok"] for r in rows)):
                failures.append(f"honest {name}: {rows} {msg}")
        rows = k1_bwd_rows()
        report["honest_k1_bwd"] = rows
        cs.log(f"honest K1 backward: largest off share "
               f"{max(r['off_share'] for r in rows):.2e} (allowed "
               f"{cs.K1_BWD_OFF_SHARE})")
        if not all(r["ok"] for r in rows):
            failures.append(f"honest K1 backward: {rows}")

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
            if "k1_bwd" in checks:
                rows["k1_bwd"] = k1_bwd_rows()
                failed["k1_bwd"] = not all(r["ok"] for r in rows["k1_bwd"])
                for r in rows["k1_bwd"]:
                    cs.log(f"{name}: K1 backward at {r['shape']} "
                           f"{r['tensor']} max_abs_err "
                           f"{r['max_abs_err']:.4g}, off share "
                           f"{r['off_share']:.2e}, bf16 "
                           f"{r['bf16_rounded']} -> {_verdict(r['ok'])}")
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

        ok, msg = router_ok()
        report["honest_router"] = msg
        cs.log(f"honest router weights check: {msg}")
        if not ok:
            failures.append(f"honest router weights check: {msg}")
        for name in ROUTER_FAULTS:
            ok, msg = router_ok(name)
            report["faults"][name] = dict(failed={"router": not ok},
                                          router=msg)
            cs.log(f"{name}: router weights check -> {_verdict(ok)} ({msg})")
            if ok:
                failures.append(f"fault {name} passed the router check")
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
        ok, msg = engine_features_ok()
        report["honest_engine_features"] = msg
        cs.log(f"honest small engine-features check: {msg}")
        if not ok:
            failures.append(f"honest engine-features check: {msg}")
        for name in ENGINE_FAULTS:
            ok, msg = engine_features_ok(name)
            report["faults"][name] = dict(
                failed={"engine_features": not ok}, engine_features=msg)
            cs.log(f"{name}: small engine-features check -> "
                   f"{_verdict(ok)} ({msg})")
            if ok:
                failures.append(f"fault {name} passed the engine-features "
                                f"check")
        ok, msg = captured_ok()
        report["honest_captured"] = msg
        cs.log(f"honest small captured check: {msg}")
        if not ok:
            failures.append(f"honest captured check: {msg}")
        for name in CAPTURE_FAULTS:
            ok, msg = captured_ok(name)
            report["faults"][name] = dict(failed={"captured": not ok},
                                          captured=msg)
            cs.log(f"{name}: small captured check -> {_verdict(ok)} "
                   f"({msg})")
            if ok:
                failures.append(f"fault {name} passed the captured check")
        model = cs.build_served("int4", 0, "cuda")
        ok, msg = full_multiturn_ok(model)
        report["honest_full_multiturn"] = msg
        cs.log(f"honest full-size multi-turn check: {msg}")
        if not ok:
            failures.append(f"honest full-size multi-turn check: {msg}")
        for name in FULL_SIZE_ENGINE_FAULTS:
            ok, msg = full_multiturn_ok(model, name)
            report["faults"][name]["failed"]["full_multiturn"] = not ok
            report["faults"][name]["full_multiturn"] = msg
            cs.log(f"{name}: full-size multi-turn check -> {_verdict(ok)} "
                   f"({msg})")
            if ok:
                failures.append(f"fault {name} passed the full-size "
                                f"multi-turn check")
        del model
        cs.free_card()
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
