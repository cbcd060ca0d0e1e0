#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (competesmoe_tpu_torch).

    python3 chip_smoke.py [--seed 0] [--profile]

Needs one CUDA GPU; exits non-zero on any failure. Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of the port from csrc/ (one nvcc per
     source, all started together);
  3. kernels, each against its plain PyTorch version on the same inputs
     on the card, timed on the device (CUDA graphs of launches, median of
     replays) beside its bound (bytes at 3.35 TB/s or operations at 989
     TFLOP/s bf16, whichever is larger):
     - the small-M decode matmuls at the four decode projection shapes
       of the 5.1B decoder: K5 (packed int4) with M in {1, 8}, K3 (bf16)
       with M in {1, 8, 32}, K4 (int8) with M in {1, 8, 32, 40, 128}, and
       at other row counts for correctness only (3, 40 and 128 for K5; 3
       and 17 for K3 and K4); tolerance one bf16 ulp at the largest output,
       2^-7 * max|ref|; launches rotate through 256 MB of weight copies,
       as decode reads its weights; torch.matmul (K3) and
       torch._weight_int8pack_mm where this torch implements it on CUDA
       (K4) as library yardsticks;
     - K1, the fused grouped ReLU double GEMM, at the 154M layer shape
       (65,536 tokens x top-8 over 64 experts of 128, skewed groups with
       empty experts; tolerance 2^-6 * max|ref|: the kernel rounds the f32
       expert weights to bf16 for the tensor cores);
     - K2, causal flash attention forward, dK/dV and dQ, at B 64, h 4,
       T 1024, p 82 (the 154M shape) and at B 8, h 4, T 256, p 64, element
       by element: |kernel - plain| <= 2^-6 |plain| + 2^-5 rms(plain over
       the element's (b, h, 64-row tile)) for o, dQ, dK and dV (the
       kernels round P and dS to bf16), and |lse - plain| <= 1e-3; beside
       `scaled_dot_product_attention` forward and forward + backward
       (CUDA graphs, as the kernels) as the library yardstick;
  4. small LM: a CompeteSMoE LM with d_model 128, 2 layers, 8 experts of
     128, top-2 and head size 82 takes 3 optimizer steps from the same
     weights on the card (K1, K2) and on the CPU (plain versions), with
     0, 2 and 1 competing layers; losses agree within SMALL_LM_LOSS_TOL
     and grad_norm within SMALL_LM_GRAD_TOL of the CPU's (a few times the
     gaps seen over several seeds, and planted kernel faults exceed them:
     chip_faults.py);
  5. LM training (main path of the training slice): the 154M CompeteSMoE
     configuration of sweeps/slimpajama_moe_no_attmoe_154M_competesmoe.yaml
     at full width and depth with -moe.impl fused and
     -transformer.attn_backend flash, through the CLI's task, for 8 steps
     at batch 64 x 1024 (one microbatch) from step 0 of its flip schedule;
     losses finite, and per step K1 launches = 16 - competing layers and
     16 launches of each K2 kernel;
  6. serving (main path of the serving slice): CompeteSMoE-5.1B (SigLIP
     MoE tower, MoE projector, Phi-3.5-mini decoder) with random weights
     from --seed, quantized with the worker's --load-4bit (int4 decoder,
     int8 lm_head, NF4 tower) and an int8 KV cache, after a small model of
     the same kind is held against the CPU; one image+text prompt, 32
     greedy tokens through stream_generate, K5 launched 4 projections x
     32 layers per decode step;
  7. server: the model worker over HTTP on 127.0.0.1 answers three text
     prompts;
  8. batched serving (main path of the engine slice): a small model of
     each served kind (bf16 with matvec_kernel: K3; --load-8bit with an
     int8 KV cache: K4) runs the same 6 greedy requests through
     DecodeEngine(n_slots=4, spec_k=2) on the card and on the CPU; then
     CompeteSMoE-5.1B at full depth, random weights from --seed, through
     DecodeEngine as the worker builds it (make_engine): (1) --load-8bit,
     int8 KV, 8 slots, --speculative 4 (K4 at every decode and verify
     projection), then the worker over HTTP with --engine-slots 4
     --speculative 4 answering 3 concurrent requests; (2) bf16, 8 slots,
     pipeline depth 2 (K3). Each takes 8 concurrent requests (2 with a
     224 px image) and 4 more once slots retire, 32 new tokens each; K3 or
     K4 launches must equal 4 x 32 x the forwards whose rows the kernel
     takes, every other kernel 0;
  9. with --profile: torch.profiler over two more training steps, over
     decode steps of the served model and over engine ticks (device busy
     share and the kernels that take the time).
Each main path is driven with every launch count set to 0 just before it
and read just after. The last lines are the kernels JSON, the card line
and the result JSON.
"""

import argparse
import dataclasses
import gc
import json
import math
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path
from urllib import request as urlrequest

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
DECODE_SHAPES = (("qkv_proj", 3072, 9216), ("o_proj", 3072, 3072),
                 ("gate_up_proj", 3072, 16384), ("down_proj", 8192, 3072))
# the 154M configuration, field for field
# (sweeps/slimpajama_moe_no_attmoe_154M_competesmoe.yaml), on the
# synthetic corpus, with the two kernel flags
SWEEP_154M = (
    "-task synthetic_transformer -moe_name competesmoe "
    "-max_compete_in_iter 3 -balance_loss_coef 0.01 "
    "-balance_loss_coef_comp 0.01 -in_topk 0 -router_loss_coef 0.001 "
    "-hybrid 1 -tribrid 0 -router_theta 0.2 -is_cosine 0 -is_norm_weight 0 "
    "-scale_weight 1 -norm_sigmoid 0 -balance_affinity 1 -warm_up 0.0 "
    "-rate_flip 0.07 -state_size 512 -transformer.encoder_n_layers 16 "
    "-transformer.n_heads 4 -dropout 0.0 -lr 0.00025 -lm.unroll 1024 "
    "-grad_clip 0.1 -amp 1 -save_interval 10000 -stop_after 100000 "
    "-moe.n_experts 64 -moe.expert_size 128 -pkm.n_heads 8 "
    "-lr_sched.type cos -transformer.head_projection_size 82 "
    "-transformer.universal.group_size 16 -wd 0.01 -batch_size 64 "
    "-lm.eval.enabled 0 -moe.impl fused -transformer.attn_backend flash"
).split()
# K1 at the 154M layer: 64 x 1024 tokens, top-8 of 64 experts of 128
K1_SHAPE = dict(T=65536, D=512, E=64, ES=128, k=8)
K2_SHAPES = ((64, 4, 1024, 82), (8, 4, 256, 64))    # (B, h, T, p)
LM_STEPS = 8                       # 154M training steps of the main path
# small LM, card against CPU per step: |loss gap| (absolute) and
# |grad_norm gap| / grad_norm; a few times the largest honest gaps that
# chip_faults.py reads over seeds 0-4 (PERF.md), and below the gaps of
# its planted faults
SMALL_LM_LOSS_TOL = 5e-3
SMALL_LM_GRAD_TOL = 2e-3
# name -> (source, TPU kernel it replaces)
KERNELS = {
    "quant_small_m_matmul_int4": ("competesmoe_tpu_torch/csrc/matvec_int4.cu",
                                  "competesmoe_tpu/ops/matvec.py:144"),
    "small_m_matmul": ("competesmoe_tpu_torch/csrc/matvec_small_m.cu",
                       "competesmoe_tpu/ops/matvec.py:75"),
    "quant_small_m_matmul": ("competesmoe_tpu_torch/csrc/matvec_small_m.cu",
                             "competesmoe_tpu/ops/matvec.py:90"),
    "gmm2_fused_aligned": ("competesmoe_tpu_torch/csrc/gmm2_fused.cu",
                           "competesmoe_tpu/ops/gmm_fused.py:67"),
    "flash_attention_fwd": ("competesmoe_tpu_torch/csrc/flash_attn.cu",
                            "competesmoe_tpu/models/lm.py:255"),
    "flash_attention_bwd_dkv": ("competesmoe_tpu_torch/csrc/flash_attn.cu",
                                "competesmoe_tpu/models/lm.py:255"),
    "flash_attention_bwd_dq": ("competesmoe_tpu_torch/csrc/flash_attn.cu",
                               "competesmoe_tpu/models/lm.py:255"),
}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def wrappers():
    """The kernel wrappers by name; each carries its `launches` count."""
    from competesmoe_tpu_torch.ops import flash_attention as fa
    from competesmoe_tpu_torch.ops import gmm_fused, matvec
    return {"quant_small_m_matmul_int4": matvec.quant_small_m_matmul_int4,
            "small_m_matmul": matvec.small_m_matmul,
            "quant_small_m_matmul": matvec.quant_small_m_matmul,
            "gmm2_fused_aligned": gmm_fused.gmm2_fused_aligned,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(got, want):
    """(max |got - want|, max |want|) in float32."""
    import torch
    if not torch.isfinite(got.float()).all():
        return float("inf"), float(want.float().abs().max())
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()))


def time_launches(fn, args_list, reps: int) -> float:
    """Device ms per call: the calls fn(*args) for every args in args_list
    are captured into one CUDA graph (so host launch overhead is out of
    the measurement), the graph is replayed `reps` times between CUDA
    events, and the median replay time is divided by len(args_list)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up outside capture
        for args in args_list[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in args_list:
            fn(*args)
    graph.replay()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) \
        / len(args_list)


def k1_inputs(seed: int):
    """K1's operands at the 154M layer shape with skewed groups (a
    decreasing boost on the gate logits) and 4 empty experts:
    (xs, keys, values, tile_expert, group sizes)."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    T, D, E, ES, k = (K1_SHAPE[n] for n in ("T", "D", "E", "ES", "k"))
    g = torch.Generator(device="cuda").manual_seed(seed + 101)
    scale = (2.0 / 16) ** 0.5            # the LM's MoE weight_scale
    x = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    keys = torch.randn(E, D, ES, generator=g, device="cuda") * (
        D ** -0.5 * scale)
    values = torch.randn(E, ES, D, generator=g, device="cuda") * (
        (E * ES) ** -0.5 * scale)
    logits = torch.randn(T, E, generator=g, device="cuda")
    logits += torch.linspace(3.0, 0.0, E, device="cuda")
    logits[:, E - 4:] = float("-inf")
    sel = logits.topk(k, dim=-1).indices
    _, tok, tile_expert, _ = gf.aligned_layout(sel, E)
    return (x[tok], keys, values, tile_expert,
            torch.bincount(sel.reshape(-1), minlength=E))


def k1_compare(xs, keys, values, tile_expert):
    """K1 against its plain version: (max_abs_err, tol), tolerance
    2^-6 * max|plain| (the kernel rounds the f32 weights to bf16)."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf
    got = gf.gmm2_fused_aligned(xs, keys, values, tile_expert)
    want = gf.gmm2_fused_aligned_reference(xs, keys, values, tile_expert)
    torch.cuda.synchronize()
    err, top = rel_err(got, want)
    return err, 2.0 ** -6 * top


def phase_k1(seed: int, reps: int = 20):
    """K1 at the 154M layer shape against its plain version, then timed."""
    from competesmoe_tpu_torch.ops import gmm_fused as gf

    D, E, ES, k = (K1_SHAPE[n] for n in ("D", "E", "ES", "k"))
    xs, keys, values, tile_expert, sizes = k1_inputs(seed)
    err, tol = k1_compare(xs, keys, values, tile_expert)
    log(f"K1 gmm2_fused_aligned [S'={xs.shape[0]}, D={D}] E={E} ES={ES}: "
        f"groups {int(sizes.min())}..{int(sizes.max())} rows, "
        f"{int((sizes == 0).sum())} empty; max_abs_err {err:.4g} "
        f"(tol {tol:.4g})")
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version: {err} "
                             f"> {tol}")
    args = (xs, keys, values, tile_expert)
    ms = time_launches(gf.gmm2_fused_aligned, [args] * 4, reps)
    plain_ms = time_launches(gf.gmm2_fused_aligned_reference, [args], 5)
    nbytes = 2 * xs.numel() * 2 + (keys.numel() + values.numel()) * 4 \
        + tile_expert.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * xs.shape[0] * D * ES)
    log(f"K1 kernel {ms * 1e3:.1f} us  plain {plain_ms * 1e3:.1f} us  "
        f"bound {bound_ms * 1e3:.1f} us ({bound_by})  "
        f"{bound_ms / ms:.1%} of bound")
    return dict(name="gmm2_fused_aligned", rows=int(xs.shape[0]), D=D,
                E=E, ES=ES, k=k, empty_experts=int((sizes == 0).sum()),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _sdpa_ms(q, k, v, do, reps: int):
    """scaled_dot_product_attention forward, and forward + backward (all
    three gradients) less the forward, in ms: CUDA-graph replays, as the
    kernels are timed."""
    import torch
    import torch.nn.functional as F

    fwd = time_launches(
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
        [(q, k, v)] * 4, reps)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd_bwd(q, k, v, do):
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return torch.autograd.grad(out, (q, k, v), do)

    both = time_launches(fwd_bwd, [(*leaves, do)] * 4, reps)
    return fwd, both - fwd


K2_TILE = 64


def tile_tolerance(want, rel: float = 2.0 ** -6, frac: float = 2.0 ** -5):
    """Element-wise tolerance for a [B, h, T, p] attention tensor:
    rel * |want| + frac * rms(want over the element's (b, h, 64-row
    tile)). Rows of causal attention differ in scale by orders of
    magnitude (o's first rows, dK/dV's first keys), so one bound taken
    from the largest element would hide a wrong tile of small rows."""
    import torch
    import torch.nn.functional as F

    w = want.float()
    B, h, T, p = w.shape
    nt = -(-T // K2_TILE)
    pad = nt * K2_TILE - T
    sq = F.pad(w.square(), (0, 0, 0, pad)).reshape(B, h, nt, K2_TILE * p)
    rows = torch.full((nt,), K2_TILE, device=w.device)
    rows[-1] -= pad
    rms = (sq.sum(-1) / (rows * p)).sqrt()
    rms = rms.repeat_interleave(K2_TILE, dim=-1)[..., :T, None]
    return rel * w.abs() + frac * rms


def k2_compare(q, k, v, do, scale):
    """K2's three kernels against the plain forward and backward on the
    same bf16 inputs. Returns one row per compared tensor: kernel,
    tensor, max_abs_err, worst (largest |err| / tolerance), ok, and
    old_rule_ok (whether the bound 2^-6 (o) or 2^-5 (gradients) x the
    largest |plain| would have passed it)."""
    import torch

    from competesmoe_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dq_ref, dk_ref, dv_ref = fa._bwd_reference(q, k, v, do, lse, delta,
                                               scale)
    torch.cuda.synchronize()
    out = []
    lse_err = float((lse - lse_ref).abs().max())
    if not math.isfinite(lse_err):
        lse_err = float("inf")
    out.append(dict(kernel="flash_attention_fwd", tensor="lse",
                    max_abs_err=lse_err, worst=lse_err / 1e-3,
                    ok=lse_err <= 1e-3, old_rule_ok=lse_err <= 1e-3))
    for kernel, tensor, got, want, old in (
            ("flash_attention_fwd", "o", o, o_ref, 2.0 ** -6),
            ("flash_attention_bwd_dkv", "dk", dk, dk_ref, 2.0 ** -5),
            ("flash_attention_bwd_dkv", "dv", dv, dv_ref, 2.0 ** -5),
            ("flash_attention_bwd_dq", "dq", dq, dq_ref, 2.0 ** -5)):
        diff = (got.float() - want.float()).abs()
        if not torch.isfinite(diff).all():
            diff = torch.full_like(diff, float("inf"))
        err = float(diff.max())
        ratio = torch.where(diff == 0, torch.zeros_like(diff),
                            diff / tile_tolerance(want))
        worst = float(ratio.max())
        out.append(dict(kernel=kernel, tensor=tensor, max_abs_err=err,
                        worst=worst, ok=worst <= 1.0,
                        old_rule_ok=err <= old * float(
                            want.float().abs().max())))
    return out


def phase_k2(seed: int, reps: int = 20):
    """K2's three kernels against the plain forward and backward at the
    154M attention shape and one other; rows keyed by kernel name, timed
    at the first (154M) shape."""
    import torch

    from competesmoe_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed + 202)
    rows = {}
    for si, (B, h, T, p) in enumerate(K2_SHAPES):
        q, k, v, do = (torch.randn(B, h, T, p, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        scale = p ** -0.5
        for c in k2_compare(q, k, v, do, scale):
            log(f"K2 {c['kernel']:24s} {c['tensor']:3s} [B={B} h={h} T={T} "
                f"p={p}] max_abs_err {c['max_abs_err']:.4g}, worst "
                f"{c['worst']:.3f} of its tolerance")
            if not c["ok"]:
                raise AssertionError(
                    f"{c['kernel']} ({c['tensor']}) at {(B, h, T, p)} "
                    f"disagrees with its plain version: {c}")
            row = rows.setdefault(c["kernel"], dict(max_abs_err=0.0))
            if c["tensor"] != "lse":
                row["max_abs_err"] = max(row["max_abs_err"],
                                         c["max_abs_err"])
        if si:
            continue
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        delta = (do.float() * o.float()).sum(-1)
        BH, pairs_ = B * h, T * (T + 1) / 2
        fwd_args = [(q, k, v, scale)]
        bwd_args = [(q, k, v, do, lse, delta, scale)]
        plain_fwd = time_launches(fa.flash_attention_fwd_reference,
                                  fwd_args, 5)
        plain_bwd = time_launches(fa._bwd_reference, bwd_args, 5)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do, reps)
        qkv_bytes, row_bytes = BH * T * p * 2, BH * T * 4
        for name, fn, args, nbytes, ops, plain, lib in (
                ("flash_attention_fwd", fa.flash_attention_fwd, fwd_args,
                 4 * qkv_bytes + row_bytes, 4 * p * pairs_ * BH, plain_fwd,
                 lib_fwd),
                ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
                 bwd_args, 6 * qkv_bytes + 2 * row_bytes,
                 8 * p * pairs_ * BH, plain_bwd, lib_bwd),
                ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
                 bwd_args, 5 * qkv_bytes + 2 * row_bytes,
                 6 * p * pairs_ * BH, plain_bwd, lib_bwd)):
            ms = time_launches(fn, args * 4, reps)
            bound_ms, bound_by = bound(nbytes, ops)
            rows[name].update(name=name, shape=[B, h, T, p], ms=ms,
                              plain_ms=plain, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib)
            log(f"K2 {name:24s} kernel {ms * 1e3:.1f} us  plain "
                f"{plain * 1e3:.1f} us  sdpa {lib * 1e3:.1f} us  bound "
                f"{bound_ms * 1e3:.1f} us ({bound_by})  "
                f"{bound_ms / ms:.1%} of bound")
    log("K2 plain times: the plain backward computes dQ, dK and dV "
        "together, and sdpa's backward all three gradients; both stand in "
        "the dK/dV and the dQ rows")
    return rows


def _task(flags):
    """The CLI's code path: parse the dotted flags, build the task."""
    from competesmoe_tpu_torch.train.lm_task import get_task
    from competesmoe_tpu_torch.utils.argparser import build_parser
    a = build_parser().parse(flags)
    return get_task(a.task)(a)


SMALL_LM_FLAGS = (
    "-task synthetic_transformer -stop_after 12 -batch_size 4 "
    "-lm.unroll 64 -lm.vocab_size 512 -state_size 128 "
    "-transformer.encoder_n_layers 2 -transformer.n_heads 2 "
    "-transformer.head_projection_size 82 -moe.n_experts 8 "
    "-moe.expert_size 128 -pkm.n_heads 2 -moe.impl fused "
    "-transformer.attn_backend flash -rate_flip 0.5 -warm_up 0.0 "
    "-max_compete_in_iter 2 -hybrid 1 -router_theta 0.2 "
    "-router_loss_coef 0.001 -balance_affinity 1 -wd 0.01 "
    "-grad_clip 0.1 -amp 1 -valid_interval 0 "
    "-run_dir runs/chip_smoke -name small_lm").split()


def small_lm_task(seed: int, device: str, weights=None):
    """The small LM's task on `device`, with `weights` (a state dict)
    loaded when given."""
    task = _task(SMALL_LM_FLAGS + ["-seed", str(seed), "-device", device])
    if weights is not None:
        task.model.load_state_dict(weights)
    return task


def small_lm_steps(task, n: int = 3):
    """`n` optimizer steps; each step's metrics as floats."""
    rows = []
    for _ in range(n):
        task.state, m = task.train_step(task.state, task.fetch_batch())
        rows.append({k: float(v) for k, v in m.items()})
    return rows


def small_lm_gaps(cpu_rows, card_rows):
    """Per step: competing layers, |loss gap| (absolute), |grad_norm gap|
    / grad_norm, and ok (both within their tolerance, the same flips)."""
    out = []
    for c, g in zip(cpu_rows, card_rows):
        dl = abs(g["loss/total"] - c["loss/total"])
        dg = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
        out.append(dict(
            flips=int(c["competesmoe/n_flip_layers"]), loss_gap=dl,
            grad_gap=dg, ok=(dl <= SMALL_LM_LOSS_TOL
                             and dg <= SMALL_LM_GRAD_TOL
                             and g["competesmoe/n_flip_layers"]
                             == c["competesmoe/n_flip_layers"])))
    return out


def small_lm_check():
    """A small CompeteSMoE LM of the 154M kind takes 3 optimizer steps on
    the card (K1, K2) and on the CPU (plain versions) from the same
    weights and batches (seed 0); steps 0-2 have 0, 2 and 1 competing
    layers. Per step the loss agrees within SMALL_LM_LOSS_TOL and
    grad_norm within SMALL_LM_GRAD_TOL (bf16 activations; K1 rounds the
    f32 expert weights to bf16, K2 rounds P and dS)."""
    cpu = small_lm_task(0, "cpu")
    gpu = small_lm_task(0, "cuda", cpu.model.state_dict())
    counts0 = read_counts()
    card = small_lm_steps(gpu)
    counts = {k: v - counts0[k] for k, v in read_counts().items()}
    ref = small_lm_steps(cpu)
    gaps = small_lm_gaps(ref, card)
    for c, g, d in zip(ref, card, gaps):
        log(f"small LM step (flips {d['flips']}): loss card "
            f"{g['loss/total']:.6f} cpu {c['loss/total']:.6f} (gap "
            f"{d['loss_gap']:.3g}, tol {SMALL_LM_LOSS_TOL}); grad_norm card "
            f"{g['grad_norm']:.6f} cpu {c['grad_norm']:.6f} (gap "
            f"{d['grad_gap']:.3g} of it, tol {SMALL_LM_GRAD_TOL})")
    if not all(d["ok"] for d in gaps):
        raise AssertionError(f"small LM disagrees: {gaps}")
    flips = [d["flips"] for d in gaps]
    if flips != [0, 2, 1]:
        raise AssertionError(f"small LM: flip counts {flips} != [0, 2, 1]")
    want = {"gmm2_fused_aligned": sum(2 - f for f in flips),
            "flash_attention_fwd": 6, "flash_attention_bwd_dkv": 6,
            "flash_attention_bwd_dq": 6, "quant_small_m_matmul_int4": 0,
            "small_m_matmul": 0, "quant_small_m_matmul": 0}
    if counts != want:
        raise AssertionError(f"small LM launches {counts} != {want}")
    log(f"small LM: card launches {counts}")
    return gaps


def phase_lm(seed: int, steps: int = LM_STEPS):
    """The training slice's main path: the 154M configuration through the
    CLI's task for `steps` steps from step 0, one microbatch per step."""
    import torch

    run = REPO / "runs" / "chip_smoke" / "lm154m"
    (run / "log_trainer.jsonl").unlink(missing_ok=True)
    t0 = time.perf_counter()
    task = _task(SWEEP_154M + [
        "-seed", str(seed), "-device", "cuda", "-run_dir", str(run.parent),
        "-name", run.name, "-log_interval", "1", "-valid_interval", "0"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in task.model.parameters())
    L = task.cfg.n_layers
    log(f"lm: {n_params / 1e6:.2f}M parameters, {L} layers, built on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    flips = [sum(task.schedule.is_flip(li, s) for li in range(L))
             for s in range(steps)]
    if not (min(flips) == 0 < max(flips)):
        raise AssertionError(f"steps 0..{steps - 1} need a competing and "
                             f"a non-competing step; flips {flips}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                            # main path starts here
    t0 = time.perf_counter()
    task.train(n_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()                    # main path ends here
    peak = torch.cuda.max_memory_allocated()
    recs = [json.loads(line) for line in
            (run / "log_trainer.jsonl").read_text().splitlines()]
    if [r["step"] for r in recs] != list(range(steps)):
        raise AssertionError(f"lm: logged steps {[r['step'] for r in recs]}")
    for r, f in zip(recs, flips):
        if not math.isfinite(r["loss/total"]):
            raise AssertionError(f"lm: non-finite loss at step {r['step']}")
        if int(r["competesmoe/n_flip_layers"]) != f:
            raise AssertionError(f"lm: step {r['step']} flips "
                                 f"{r['competesmoe/n_flip_layers']} != {f}")
    want = {"gmm2_fused_aligned": sum(L - f for f in flips),
            "flash_attention_fwd": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "quant_small_m_matmul_int4": 0, "small_m_matmul": 0,
            "quant_small_m_matmul": 0}
    if counts != want:
        raise AssertionError(f"lm launches {counts} != {want}")
    ms = [r["timing/ms_per_step_wall"] for r in recs]
    tokens = task.a.batch_size * task.a.lm.unroll
    steady = statistics.median(ms[1:])        # the first step warms up
    for r, f in zip(recs, flips):
        log(f"lm step {r['step']}: flips {f}, loss {r['loss/total']:.4f} "
            f"(ce {r['loss/ce']:.4f}), grad_norm {r['grad_norm']:.4f}, "
            f"agreement {r['competesmoe/router_agreement']:.3f}, "
            f"{r['timing/ms_per_step_wall']:.1f} ms")
    summary = dict(
        params=n_params, steps=steps, flips=flips,
        launches=counts, wall_s=wall, ms_per_step=ms,
        ms_per_step_median_after_first=steady,
        ms_per_step_no_flip=[m for m, f in zip(ms[1:], flips[1:]) if not f],
        ms_per_step_flip=[m for m, f in zip(ms[1:], flips[1:]) if f],
        tokens_per_s=tokens / (steady / 1e3), peak_mem_gib=peak / 2 ** 30,
        losses=[r["loss/total"] for r in recs])
    log(f"lm: {steps} steps in {wall:.1f} s; median {steady:.1f} ms/step "
        f"after the first ({summary['tokens_per_s']:.0f} tok/s); peak "
        f"memory {summary['peak_mem_gib']:.2f} GiB; launches {counts}")
    return task, summary


def profile_train(task, steps: int = 2):
    """torch.profiler over `steps` more training steps: wall time, device
    kernel time (so the busy share) and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train(n_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _busy(prof, wall, steps, "train")


def _busy(prof, wall, steps, what):
    import torch
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((dev_us, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    log(f"profile: {steps} {what} steps, wall {wall_ms:.2f} ms/step, "
        f"device kernels {busy_ms:.3f} ms/step, busy share "
        f"{busy_ms / wall_ms:.1%}")
    for dev_us, count, name in kernels[:12]:
        log(f"  {dev_us / 1e3 / steps:8.3f} ms/step  {count // steps:5d} "
            f"launches/step  {name[:90]}")
    return dict(wall_ms_per_step=wall_ms, device_ms_per_step=busy_ms,
                busy_share=busy_ms / wall_ms,
                top=[dict(ms_per_step=d / 1e3 / steps,
                          launches_per_step=c // steps, kernel=n[:120])
                     for d, c, n in kernels[:12]])


class WordTok:
    """Word-level stand-in tokenizer (no tokenizer package is needed):
    ids are assigned to words on first sight, starting at 3."""

    bos_token_id = None
    eos_token_id = 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.vocab, self.inv = {}, {}

    def __call__(self, text):
        ids = []
        for w in text.split():
            if w not in self.vocab:
                i = 3 + len(self.vocab) % (self.vocab_size - 3)
                self.vocab[w] = i
                self.inv[i] = w
            ids.append(self.vocab[w])
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.inv.get(int(i), f"<{int(i)}>") for i in ids
                        if not (skip_special_tokens and int(i) < 3))


SMALL_HF = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, mm_hidden_size=64,
                vision_config=dict(hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   image_size=28, patch_size=14))


def card_vs_cpu_logits(card, cpu, seed: int):
    """A 12-token prompt with a 28 px image, prefilled and decoded for 4
    greedy steps (the card's tokens feed both) on the card and on the CPU
    from the same weights: (max |card - cpu| over the 5 logit rows,
    tolerance 3% of the CPU's largest magnitude); a non-finite card logit
    counts as an infinite error."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, (1, 12))
    ids[0, 3] = -200
    px = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)
    logits, fed = {}, None
    with torch.no_grad():
        for key, model in (("card", card), ("cpu", cpu)):
            dev = model.device
            cache = KVCache.create(model.language_model.cfg, 1, 64, dev)
            out = model(torch.as_tensor(ids, device=dev),
                        torch.as_tensor(px, device=dev), cache=cache)
            rows, feed = [out.logits[:, -1].float().cpu()], []
            for i in range(4):
                t = rows[-1].argmax(-1) if fed is None else fed[i]
                feed.append(t)
                out = model(t.to(dev)[:, None], None, cache=out.cache)
                rows.append(out.logits[:, -1].float().cpu())
            fed = feed
            logits[key] = torch.stack(rows)
    err = float((logits["card"] - logits["cpu"]).abs().max())
    if not torch.isfinite(logits["card"]).all():
        err = float("inf")
    return err, 0.03 * float(logits["cpu"].abs().max())


def small_model_check(seed: int):
    """A small model of the served kind (int4 decoder whose projections
    tile the kernel, int8 KV) on the card against the same weights on the
    CPU: the card runs K5 at every decode projection, the CPU the plain
    halves contraction. Decode logits must agree within 3% of their
    largest magnitude (bf16 activations, the scale applied before vs
    after the f32 sum)."""
    import torch

    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, apply_load_4bit, build_llava, llava_config_from_hf)
    from competesmoe_tpu_torch.models.llava import LlavaModel
    from competesmoe_tpu_torch.ops.matvec import quant_small_m_matmul_int4

    cfg = llava_config_from_hf(dict(HF_5P1B, **SMALL_HF), "llava_phi",
                               torch.bfloat16)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, kv_quant="int8"))
    cpu = apply_load_4bit(build_llava(cfg, seed=seed, device="cpu"))
    gpu = LlavaModel(cpu.cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    launches0 = quant_small_m_matmul_int4.launches
    err, tol = card_vs_cpu_logits(gpu, cpu, seed)
    kernel_launches = quant_small_m_matmul_int4.launches - launches0
    log(f"small model (card vs CPU, 5 logit rows): max_abs_err {err:.4g} "
        f"tol {tol:.4g}; K5 launches on the card {kernel_launches}")
    if not err <= tol:
        raise AssertionError(f"small model disagrees: {err} > {tol}")
    # prefill (15 rows) and each of the 4 decode steps: 4 projections x 2
    if kernel_launches != 4 * 2 * 5:
        raise AssertionError(f"small model: expected 40 K5 launches, got "
                             f"{kernel_launches}")


def phase_model(seed: int, new_tokens: int = 32):
    import torch

    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, apply_load_4bit, build_llava, llava_config_from_hf)
    from competesmoe_tpu_torch.models.llava import stream_generate

    cfg = llava_config_from_hf(HF_5P1B, "llava_phi", torch.bfloat16)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, kv_quant="int8"))
    t0 = time.perf_counter()
    model = apply_load_4bit(build_llava(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.state_dict().values())
    log(f"model: {n_params / 1e9:.3f}B stored values built and quantized "
        f"in {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")

    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.decoder.vocab_size, (1, 48)).astype(np.int32)
    ids[0, 8] = -200
    px = rng.uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32)

    def run(n):
        t_start = time.perf_counter()
        chunks, t_first = [], None
        for c in stream_generate(model, ids, px, max_new_tokens=n,
                                 temperature=0.0):
            if t_first is None:
                t_first = time.perf_counter()
            chunks.append(c)
        t_end = time.perf_counter()
        return np.concatenate(chunks, axis=1), t_first - t_start, \
            t_end - t_first

    run(4)                                   # warm-up: lazy inits
    reset_counts()                           # main path starts here
    toks, ttft, rest = run(new_tokens)
    counts = read_counts()                   # main path ends here
    launches = counts["quant_small_m_matmul_int4"]
    steps = toks.shape[1] - 1
    L = cfg.decoder.num_hidden_layers
    if toks.shape != (1, new_tokens) or toks.min() < 0 or \
            toks.max() >= cfg.decoder.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} {toks}")
    if launches != 4 * L * steps or sum(counts.values()) != launches:
        raise AssertionError(f"launches {counts}: K5 must be 4 x {L} layers "
                             f"x {steps} decode steps, the others 0")
    tok_s = steps / rest
    log(f"generate: {new_tokens} greedy tokens, TTFT {ttft * 1e3:.1f} ms, "
        f"decode {tok_s:.2f} tok/s ({rest / steps * 1e3:.2f} ms/token), K5 "
        f"launches {launches} = {launches // steps} per decode step")
    log(f"tokens: {toks[0].tolist()}")
    return model, launches, dict(ttft_ms=ttft * 1e3, decode_tok_s=tok_s,
                                 ms_per_token=rest / steps * 1e3,
                                 decode_steps=steps, layers=L)


def profile_decode(model, seed: int, steps: int = 8):
    """torch.profiler over `steps` decode steps of the served model: host
    wall time per step, device kernel time per step (so the device's busy
    share) and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from competesmoe_tpu_torch.models.decoder import KVCache

    rng = np.random.default_rng(seed)
    vocab = model.cfg.decoder.vocab_size
    ids = torch.as_tensor(rng.integers(3, vocab, (1, 32)), device="cuda")
    cache = KVCache.create(model.language_model.cfg, 1, 128, "cuda")
    with torch.no_grad():
        out = model(ids, None, cache=cache)
        tok = out.logits[:, -1].argmax(-1)
        for _ in range(2):                     # warm-up steps
            out = model(tok[:, None], None, cache=out.cache)
            tok = out.logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                out = model(tok[:, None], None, cache=out.cache)
                tok = out.logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return _busy(prof, wall, steps, "decode")


def start_worker(generate_fn, extra_status_fn=None):
    """The model worker on a free port of 127.0.0.1, serving in the
    background: (HTTP server, port)."""
    from competesmoe_tpu_torch.serve.model_worker import (ModelWorker,
                                                          serve_worker)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worker = ModelWorker(None, f"http://127.0.0.1:{port}", ["smoke"],
                         generate_fn, register=False,
                         extra_status_fn=extra_status_fn)
    return serve_worker(worker, "127.0.0.1", port, background=True), port


def post_stream(port: int, prompt: str, max_new_tokens: int = 16):
    """One /worker_generate_stream request: its JSON chunks."""
    req = urlrequest.Request(
        f"http://127.0.0.1:{port}/worker_generate_stream",
        data=json.dumps({"prompt": prompt,
                         "max_new_tokens": max_new_tokens}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urlrequest.urlopen(req, timeout=300) as r:
        body = r.read()
    return [json.loads(p) for p in body.split(b"\0") if p]


def phase_server(model):
    from competesmoe_tpu_torch.eval.llava_adapter import TorchLlava
    from competesmoe_tpu_torch.ops.matvec import quant_small_m_matmul_int4
    from competesmoe_tpu_torch.serve.model_worker import (
        torch_llava_generate_fn)

    adapter = TorchLlava(model, WordTok(model.cfg.decoder.vocab_size),
                         max_new_tokens=16)
    httpd, port = start_worker(torch_llava_generate_fn(adapter))
    launches0 = quant_small_m_matmul_int4.launches
    try:
        for prompt in ("what color is the cat", "describe the image please",
                       "hello there how are you"):
            t0 = time.perf_counter()
            chunks = post_stream(port, prompt)
            if not chunks or any(c["error_code"] != 0 for c in chunks):
                raise AssertionError(f"server error for {prompt!r}: "
                                     f"{chunks[-1:]}")
            log(f"server: {prompt!r} -> {len(chunks)} chunks in "
                f"{time.perf_counter() - t0:.2f} s, last "
                f"{chunks[-1]['text'][:60]!r}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = quant_small_m_matmul_int4.launches - launches0
    log(f"server: K5 launches over the three requests {launches}")
    if launches == 0:
        raise AssertionError("the worker's requests never launched K5")


# the small-M decode matmuls: tag, the rows of x at which each is timed
# at the four decode projections, and the rows checked for correctness
# only at o_proj (other groupings of the kernels' 8-row blocks)
SMALL_M = {"quant_small_m_matmul_int4": ("K5", (1, 8), (3, 40, 128)),
           "small_m_matmul": ("K3", (1, 8, 32), (3, 17)),
           "quant_small_m_matmul": ("K4", (1, 8, 32, 40, 128), (3, 17))}


def _small_m_operands(name, g, m, k, n):
    """x and the weight arguments of K5 (nibble-packed int4 [K/2, N] and
    an f32 scale), K3 (the [K, N] view of a contiguous [N, K] bf16 matrix,
    as the decoder passes weight.t()) or K4 (int8 [K, N] and an f32
    scale)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import pack_int4
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    if name == "small_m_matmul":
        wt = torch.randn(n, k, generator=g, device="cuda").to(torch.bfloat16)
        return x, (wt.t(),)
    int4 = name == "quant_small_m_matmul_int4"
    q = torch.randint(-8 if int4 else -127, 8 if int4 else 128, (k, n),
                      generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
    return x, (pack_int4(q) if int4 else q, scale)


def _int8pack_mm():
    """torch._weight_int8pack_mm as a K4 yardstick (x, int8 [N, K], bf16
    scale [N]), or (None, why) where this torch lacks it on CUDA."""
    import torch
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch has no _weight_int8pack_mm"
    try:
        fn(torch.zeros(8, 256, device="cuda", dtype=torch.bfloat16),
           torch.zeros(256, 256, device="cuda", dtype=torch.int8),
           torch.ones(256, device="cuda", dtype=torch.bfloat16))
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"_weight_int8pack_mm on CUDA: {str(e).splitlines()[0]}"
    return fn, ""


def small_m_compare(name: str, g, m: int, k: int, n: int):
    """K5, K3 or K4 against its plain version on fresh operands:
    (max_abs_err, tol = 2^-7 * max|plain|, x, weight arguments); a wrong
    shape counts as an infinite error."""
    import torch

    from competesmoe_tpu_torch.ops import matvec
    x, w = _small_m_operands(name, g, m, k, n)
    got = getattr(matvec, name)(x, *w)
    want = getattr(matvec, name + "_reference")(x, *w)
    torch.cuda.synchronize()
    err, top = rel_err(got, want)
    if got.shape != want.shape:
        err = float("inf")
    return err, 2.0 ** -7 * top, x, w


def phase_small_m(reps: int = 60):
    """K5, K3 and K4 against their plain versions at the decode projection
    shapes, timed beside their bounds, plain versions and library calls
    (torch.matmul for K3, torch._weight_int8pack_mm for K4, none computes
    K5's packed int4); the launches rotate through 256 MB of weight
    copies, as decode reads its weights."""
    import torch

    from competesmoe_tpu_torch.ops import matvec

    g = torch.Generator(device="cuda").manual_seed(1234)
    int8pack, int8pack_why = _int8pack_mm()
    if int8pack is None:
        log(f"K4 library yardstick: n/a ({int8pack_why})")
    rows, max_err = [], {name: 0.0 for name in SMALL_M}

    def check(name, m, k, n, label, timed):
        fn = getattr(matvec, name)
        ref = getattr(matvec, name + "_reference")
        err, tol, x, w = small_m_compare(name, g, m, k, n)
        tag = SMALL_M[name][0]
        if not err <= tol:
            raise AssertionError(f"{tag} {label} M={m}: max_abs_err {err} > "
                                 f"tol {tol}")
        max_err[name] = max(max_err[name], err)
        if not timed:
            log(f"{tag} {label:13s} M={m:<3d} [{k}x{n}] err {err:.3g} "
                f"(tol {tol:.3g}), correctness only")
            return
        store = w[0].t() if tag == "K3" else w[0]    # the weight's storage
        copies = [store] + [store.clone() for _ in range(
            max(0, -(-256 * 2 ** 20 // (store.numel() * store.element_size()))
                - 1))]
        args = [(x, c.t()) if tag == "K3" else (x, c, w[1]) for c in copies]
        ms = time_launches(fn, args, reps)
        plain_ms = time_launches(ref, args, reps)
        lib_ms = None
        if tag == "K3":
            lib_ms = time_launches(torch.matmul, args, reps)
        elif tag == "K4" and int8pack is not None:
            s16 = w[1].to(torch.bfloat16)
            lib_ms = time_launches(int8pack, [(x, c.t().contiguous(), s16)
                                              for c in copies], reps)
        wbytes = sum(t.numel() * t.element_size() for t in (store, *w[1:]))
        nbytes = m * k * 2 + wbytes + m * n * 2
        bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
        rows.append(dict(kernel=name, proj=label, m=m, k=k, n=n,
                         bytes=nbytes, max_abs_err=err, tol=tol, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         roofline_share=bound_ms / ms))
        lib = f"{lib_ms * 1e3:.2f} us" if lib_ms is not None else "n/a"
        log(f"{tag} {label:13s} M={m:<3d} [{k}x{n}] err {err:.3g} (tol "
            f"{tol:.3g})  kernel {ms * 1e3:.2f} us  plain "
            f"{plain_ms * 1e3:.2f} us  library {lib}  bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by})  {bound_ms / ms:.1%} of "
            f"bound")
        del copies, args

    for name, (_, timed_m, check_m) in SMALL_M.items():
        for label, k, n in DECODE_SHAPES:
            for m in timed_m:
                check(name, m, k, n, label, timed=True)
        for m in check_m:
            check(name, m, 3072, 3072, "o_proj", timed=False)
    return rows, max_err, int8pack_why


def small_m_summary(rows, name, launches, max_err, m):
    """One kernels-line row: one decoder layer's four projections at `m`
    rows (1 for the solo decode step, 8 for the engine tick)."""
    sel = [r for r in rows if r["kernel"] == name and r["m"] == m]
    lib = [r["library_ms"] for r in sel]
    return dict(name=name, launches=launches, max_abs_err=max_err,
                ms=sum(r["ms"] for r in sel),
                plain_ms=sum(r["plain_ms"] for r in sel),
                bound_ms=sum(r["bound_ms"] for r in sel), bound_by="bytes",
                library_ms=None if None in lib else sum(lib))


class ForwardRows:
    """Records (batch, length) of every forward of a decoder, from a
    forward pre-hook: the forwards a phase must account for."""

    def __init__(self, decoder):
        self.rows = []
        self._h = decoder.register_forward_pre_hook(self._hook,
                                                    with_kwargs=True)

    def _hook(self, module, args, kwargs):
        x = args[0] if args and args[0] is not None else (
            kwargs.get("input_ids") if kwargs.get("input_ids") is not None
            else kwargs["inputs_embeds"])
        self.rows.append((int(x.shape[0]), int(x.shape[1])))

    def remove(self):
        self._h.remove()


def matvec_launches(decoder, rows) -> int:
    """The K3/K4 launches the forwards `rows` [(B, T)] must make: one per
    matvec projection and forward whose M = B*T its kernel takes."""
    from competesmoe_tpu_torch.models.decoder import PallasDense, QuantDense
    from competesmoe_tpu_torch.ops.matvec import (MAX_QUANT_M, MAX_SMALL_M,
                                                  small_m_viable)
    n = 0
    for mod in decoder.modules():
        if isinstance(mod, PallasDense):
            k, out, cap = mod.in_features, mod.out_features, MAX_SMALL_M
        elif (isinstance(mod, QuantDense) and mod.matvec_kernel
              and mod.mode == "int8"):
            k, out, cap = mod.in_features, mod.features, MAX_QUANT_M
        else:
            continue
        n += sum(small_m_viable(b * t, k, out, max_m=cap) for b, t in rows)
    return n


def served_config(kind: str, small: bool):
    """The 5.1B configuration (or its small geometry) with matvec_kernel:
    'bf16' (K3) or 'int8' (--load-8bit semantics with an int8 KV cache:
    K4)."""
    import torch

    from competesmoe_tpu_torch.models.builder import (HF_5P1B,
                                                      llava_config_from_hf)
    cfg = llava_config_from_hf(dict(HF_5P1B, **SMALL_HF) if small
                               else HF_5P1B, "llava_phi", torch.bfloat16)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, matvec_kernel=True,
        kv_quant="int8" if kind == "int8" else None))


def build_served(kind: str, seed: int, device: str, small: bool = False):
    from competesmoe_tpu_torch.models.builder import (apply_load_8bit,
                                                      build_llava)
    model = build_llava(served_config(kind, small), seed=seed, device=device)
    return apply_load_8bit(model) if kind == "int8" else model


def engine_requests(rng, vocab: int, n_text: int, n_image: int,
                    px_size: int, lengths=(20, 150)):
    """Prompts whose n-grams repeat (so drafts hit): a random phrase of
    3-6 tokens tiled to a length in `lengths`; image prompts are 48
    tokens with the sentinel at position 8."""
    out = []
    for _ in range(n_image):
        ids = rng.integers(3, vocab, 48).astype(np.int32)
        ids[8] = -200
        out.append((ids, rng.uniform(-1, 1, (1, px_size, px_size, 3))
                    .astype(np.float32)))
    for _ in range(n_text):
        phrase = rng.integers(3, vocab, int(rng.integers(3, 7)))
        out.append((np.resize(phrase, int(rng.integers(*lengths)))
                    .astype(np.int32), None))
    return out


def drive_ticks(engine, reqs, max_new: int):
    """Submit `reqs` to an engine with run_thread=False and tick until all
    are done; returns each request's tokens."""
    made = [engine._make_request(ids, px, max_new_tokens=max_new)
            for ids, px in reqs]
    for _ in range(100 * max_new):
        if all(r.done for r in made):
            break
        engine._tick()
    engine._tick()                     # deliver what a pipeline still holds
    if not all(r.done for r in made):
        raise AssertionError("engine did not finish its requests")
    return [list(r.emitted) for r in made]


def small_engine_check(kind: str, seed: int):
    """A small model of the served kind (matvec_kernel; 'bf16' runs K3,
    'int8' K4) on the card against the same weights on the CPU: decode
    logits of a teacher-forced stream within 3% of their largest
    magnitude; the same 6 greedy requests through DecodeEngine(n_slots=4,
    spec_k=2) give equal streams, or, where they part, the CPU's top-2
    margin at that step lies within that tolerance; the card's K3/K4
    launches equal the count its forwards' shapes call for."""
    import torch

    from competesmoe_tpu_torch.models.llava import LlavaModel
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    name = "small_m_matmul" if kind == "bf16" else "quant_small_m_matmul"
    cpu = build_served(kind, seed, "cpu", small=True)
    gpu = LlavaModel(cpu.cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    counts0 = read_counts()
    fw = ForwardRows(gpu.language_model)
    err, tol = card_vs_cpu_logits(gpu, cpu, seed)
    if not err <= tol:
        raise AssertionError(f"small {kind} model disagrees: {err} > {tol}")

    rng = np.random.default_rng(seed + 1)
    reqs = engine_requests(rng, 512, 5, 1, 28, lengths=(10, 40))
    streams = {}
    for key, model in (("card", gpu), ("cpu", cpu)):
        engine = DecodeEngine(model, n_slots=4, max_len=128, spec_k=2,
                              run_thread=False)
        streams[key] = drive_ticks(engine, reqs, 12)
    parted = []
    for (rids, rpx), a, b in zip(reqs, streams["card"], streams["cpu"]):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            if len(a) != len(b):
                raise AssertionError(f"stream lengths {len(a)} != {len(b)}")
            continue
        full = np.concatenate([rids, np.asarray(b[:j], np.int32)])[None]
        with torch.no_grad():
            last = cpu(torch.as_tensor(full), None if rpx is None
                       else torch.as_tensor(rpx)).logits[0, -1].float()
        top2 = last.topk(2).values
        margin = float(top2[0] - top2[1])
        parted.append(dict(step=j, margin=margin))
        if margin > tol:
            raise AssertionError(f"small {kind} engine streams part at step "
                                 f"{j} where the CPU's top-2 margin {margin}"
                                 f" exceeds the logit tolerance {tol}")
    fw.remove()
    counts = {k: v - counts0[k] for k, v in read_counts().items()}
    want = matvec_launches(gpu.language_model, fw.rows)
    if counts[name] != want or sum(counts.values()) != want:
        raise AssertionError(f"small {kind} model launches {counts}, "
                             f"{name} must be {want}, the others 0")
    log(f"small {kind} model (card vs CPU): logits max_abs_err {err:.4g} "
        f"tol {tol:.4g}; engine (4 slots, spec_k 2, 6 requests): "
        f"{sum(a == b for a, b in zip(streams['card'], streams['cpu']))}/6 "
        f"streams equal, parted {parted}; {name} launches {want} over "
        f"{len(fw.rows)} forwards")
    return dict(kind=kind, max_abs_err=err, tol=tol, parted=parted,
                launches=want)


def phase_engine(kind: str, seed: int, new_tokens: int = 32):
    """The engine slice's main path at full width: CompeteSMoE-5.1B
    through DecodeEngine as the worker builds it. 'int8': --load-8bit,
    int8 KV, 8 slots, --speculative 4 (pipeline 1); 'bf16': 8 slots,
    pipeline 2. 8 requests from threads at once (2 with an image; 6
    greedy, one at temperature 0.7, one at 0.7 with top_p 0.9), then 4
    more once a slot retires; `new_tokens` each."""
    import threading

    import torch

    from competesmoe_tpu_torch.serve.model_worker import make_engine

    name = "small_m_matmul" if kind == "bf16" else "quant_small_m_matmul"
    spec = 4 if kind == "int8" else 0
    t0 = time.perf_counter()
    model = build_served(kind, seed, "cuda")
    torch.cuda.synchronize()
    L = model.cfg.decoder.num_hidden_layers
    log(f"engine {kind}: 5.1B built in {time.perf_counter() - t0:.1f} s; "
        f"device memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    vocab = model.cfg.decoder.vocab_size
    rng = np.random.default_rng(seed + 7)
    reqs = engine_requests(rng, vocab, 6, 2, 224)
    reqs += engine_requests(rng, vocab, 4, 0, 224)
    sampling = [(0.0, 1.0)] * 6 + [(0.7, 1.0), (0.7, 0.9)] + [(0.0, 1.0)] * 4
    order = [2, 0, 3, 1, 4, 5, 6, 7, 8, 9, 10, 11]  # images among the first

    engine = make_engine(model, 8, 512, speculative=spec, engine_pipeline=2)
    # warm-up: one short request (lazy inits, the first kernel loads)
    list(engine.submit(reqs[2][0][:24], max_new_tokens=4))
    fw = ForwardRows(model.language_model)
    results, first_done = {}, threading.Event()

    def client(i):
        ids, px = reqs[i]
        temp, topp = sampling[i]
        t_sub = time.perf_counter()
        toks, t_first = [], None
        for tok in engine.submit(ids, px, max_new_tokens=new_tokens,
                                 temperature=temp, top_p=topp, eos_ids=[2]):
            if t_first is None:
                t_first = time.perf_counter()
            toks.append(tok)
        results[i] = dict(tokens=toks, ttft=t_first - t_sub,
                          end=time.perf_counter())
        first_done.set()

    reset_counts()                           # main path starts here
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in order[:8]]
    for th in threads:
        th.start()
    first_done.wait(timeout=600)
    later = [threading.Thread(target=client, args=(i,)) for i in order[8:]]
    for th in later:
        th.start()
    for th in threads + later:
        th.join(timeout=600)
    torch.cuda.synchronize()
    counts = read_counts()                   # main path ends here
    fw.remove()
    wall = max(r["end"] for r in results.values()) - t_start
    stats = engine.stats()
    engine.shutdown()
    if engine.error is not None or len(results) != 12:
        raise AssertionError(f"engine {kind}: error {engine.error!r}, "
                             f"{len(results)} of 12 requests finished")
    for i, r in results.items():
        toks = r["tokens"]
        if not toks or min(toks) < 0 or max(toks) >= vocab or not (
                len(toks) == new_tokens
                or (toks[-1] == 2 and len(toks) <= new_tokens)):
            raise AssertionError(f"engine {kind}: request {i} bad stream "
                                 f"{toks}")
    want = matvec_launches(model.language_model, fw.rows)
    if counts[name] != want or sum(counts.values()) != want:
        raise AssertionError(f"engine {kind} launches {counts}: {name} must "
                             f"be {want} (4 x {L} x viable forwards), the "
                             f"others 0")
    ticks = [(b, t) for b, t in fw.rows if b == 8]
    n_tok = sum(len(r["tokens"]) for r in results.values())
    ttft = sorted(r["ttft"] for r in results.values())
    summary = dict(
        kind=kind, slots=8, spec_k=spec, pipeline=engine._pipeline_depth,
        requests=12, tokens=n_tok, wall_s=wall, tok_s=n_tok / wall,
        ttft_p50_ms=statistics.median(ttft) * 1e3, ttft_max_ms=ttft[-1] * 1e3,
        forwards=len(fw.rows), ticks=len(ticks),
        verify_ticks=sum(t > 1 for _, t in ticks),
        launches=counts[name],
        launches_per_tick=matvec_launches(model.language_model, ticks)
        / max(len(ticks), 1),
        prefill_rows=sorted({b * t for b, t in fw.rows if b != 8}),
        stats=stats)
    log(f"engine {kind}: 12 requests, {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tok/s aggregate; TTFT p50 "
        f"{summary['ttft_p50_ms']:.1f} ms, max {ttft[-1] * 1e3:.1f} ms; "
        f"{len(ticks)} ticks ({summary['verify_ticks']} verify), "
        f"{stats.get('engine_spec_tokens_per_step', 'n/a')} tokens per "
        f"verify tick; {name} launches {counts[name]} = 4 x {L} x "
        f"{want // (4 * L)} viable forwards "
        f"({summary['launches_per_tick']:.1f} per tick); prefill rows "
        f"{summary['prefill_rows']}")
    return model, summary


def profile_engine(model, kind: str, seed: int, ticks: int = 8):
    """torch.profiler over `ticks` engine ticks of 8 live slots (driven in
    this thread): host wall time per tick, device kernel time per tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    spec = 4 if kind == "int8" else 0
    engine = DecodeEngine(model, n_slots=8, max_len=512, spec_k=spec,
                          pipeline_depth=1 if spec else 2, run_thread=False)
    rng = np.random.default_rng(seed + 9)
    for ids, px in engine_requests(rng, model.cfg.decoder.vocab_size, 8, 0,
                                   224, lengths=(20, 40)):
        engine._make_request(ids, px, max_new_tokens=64)
    with torch.no_grad():
        for _ in range(3):
            engine._tick()                    # admission and warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                engine._tick()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    engine.shutdown()
    return _busy(prof, wall, ticks, f"engine {kind}")


def phase_engine_server(model):
    """The worker with --engine-slots 4 --speculative 4 over the
    --load-8bit model, over HTTP: 3 concurrent requests."""
    import threading

    from competesmoe_tpu_torch.eval.llava_adapter import TorchLlava
    from competesmoe_tpu_torch.ops.matvec import quant_small_m_matmul
    from competesmoe_tpu_torch.serve.model_worker import (engine_generate_fn,
                                                          make_engine)

    adapter = TorchLlava(model, WordTok(model.cfg.decoder.vocab_size),
                         max_new_tokens=16, speculative=4)
    engine = make_engine(model, 4, 512, speculative=4, engine_pipeline=2)
    httpd, port = start_worker(engine_generate_fn(adapter, engine),
                               engine.stats)
    launches0 = quant_small_m_matmul.launches
    prompts = ("what color is the cat what color is the cat",
               "describe the image please describe the image",
               "hello there how are you hello there how are you")
    out = {}

    def client(i):
        t0 = time.perf_counter()
        out[i] = (post_stream(port, prompts[i]), time.perf_counter() - t0)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.shutdown()
    stats = engine.stats()
    for i in range(3):
        chunks, dt = out.get(i, ([], 0.0))
        if not chunks or any(c["error_code"] != 0 for c in chunks):
            raise AssertionError(f"engine server error for {prompts[i]!r}: "
                                 f"{chunks[-1:]}")
        log(f"engine server: {prompts[i][:24]!r}... -> {len(chunks)} chunks "
            f"in {dt:.2f} s")
    launches = quant_small_m_matmul.launches - launches0
    log(f"engine server: K4 launches over the three requests {launches}; "
        f"{stats}")
    if launches == 0 or engine.error is not None:
        raise AssertionError("the engine worker's requests never launched "
                             "K4")


def free_card():
    """Return the memory of the models just deleted to the card: a model
    still reachable from a reference cycle (the HTTP server's handler
    closures) lives until the collector runs."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile training steps, decode steps and "
                         "engine ticks")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from competesmoe_tpu_torch import _kernels

    # float32 products stay float32 (no TF32) in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    log(f"build: {', '.join(_kernels.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    small_rows, small_err, int8pack_why = phase_small_m()
    print("kernel_shapes " + json.dumps({
        "card": card, "rows": small_rows,
        "k4_library": int8pack_why or "torch._weight_int8pack_mm"}),
        flush=True)
    k1 = phase_k1(a.seed)
    k2 = phase_k2(a.seed)
    small_lm_check()
    task, lm = phase_lm(a.seed)
    if a.profile:
        lm["profile"] = profile_train(task)
    del task
    free_card()
    print("lm_summary " + json.dumps(dict(lm, card=card)), flush=True)
    small_model_check(a.seed)
    model, k5_launches, summary = phase_model(a.seed)
    phase_server(model)
    if a.profile:
        summary["profile"] = profile_decode(model, a.seed)
    print("model_summary " + json.dumps(dict(summary, card=card)),
          flush=True)
    del model
    free_card()
    small = [small_engine_check(kind, a.seed) for kind in ("bf16", "int8")]
    engines = {}
    for kind in ("int8", "bf16"):
        model, engines[kind] = phase_engine(kind, a.seed)
        if kind == "int8":
            phase_engine_server(model)
        if a.profile:
            engines[kind]["profile"] = profile_engine(model, kind, a.seed)
        del model
        free_card()
    print("engine_summary " + json.dumps(dict(small=small, card=card,
                                              **engines)), flush=True)
    rows = [small_m_summary(small_rows, name, launches, small_err[name], m)
            for name, launches, m in (
                ("quant_small_m_matmul_int4", k5_launches, 1),
                ("small_m_matmul", engines["bf16"]["launches"], 8),
                ("quant_small_m_matmul", engines["int8"]["launches"], 8))]
    for row in [k1] + [k2[n] for n in ("flash_attention_fwd",
                                       "flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq")]:
        rows.append(dict(name=row["name"],
                         launches=lm["launches"][row["name"]],
                         max_abs_err=row["max_abs_err"], ms=row["ms"],
                         plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                         bound_by=row["bound_by"],
                         library_ms=row["library_ms"]))
    print(json.dumps({"kernels": [
        dict(name=r["name"], route="cuda", source=KERNELS[r["name"]][0],
             replaces=KERNELS[r["name"]][1],
             **{k: r[k] for k in ("launches", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")})
        for r in rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
