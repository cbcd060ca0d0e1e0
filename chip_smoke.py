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
       of the 5.1B decoder: K5 (packed int4) and K4 (int8) with M in {1,
       8, 32, 40, 128}, K3 (bf16) with M in {1, 8, 32}, and at other row
       counts for correctness only (2, 3, 9, 17, 33 and 64 for K5; 2, 3
       and 17 for K3; 3, 9, 17, 33 and 64 for K4: every wgmma width and
       ragged last rows); K5's nibbles and K4's int8 weights hold every
       value, -8 and -128 too; tolerance one bf16 ulp at the largest
       output, 2^-7 * max|ref|; each kernel run twice gives the same
       bytes; launches rotate through 256 MB of weight copies, as decode
       reads its weights; library yardsticks where this torch implements
       them on CUDA: torch._weight_int4pack_mm (K5; each group of K takes
       the column's scale and zero 0, and it must first agree with the
       plain version within the same tolerance), torch.matmul (K3) and
       torch._weight_int8pack_mm (K4);
     - K1, the fused grouped ReLU double GEMM, at the 154M layer shape
       (65,536 tokens x top-8 over 64 experts of 128, skewed groups with
       empty experts; tolerance 2^-6 * max|ref|: the kernel reads the f32
       expert weights rounded to bf16, a cast inside its timed call), and
       for correctness only at ES 256, 384 and 512 (K1_CHECK_SHAPES: h
       in 64 to 128 registers); run twice it gives the same bytes;
     - K1's backward (csrc/gmm2_bwd.cu: gmm2_bwd_dx, which recomputes h
       and writes dxs and the bf16 hr and dh, and gmm2_bwd_dw, which sums
       each expert's dkeys and dvalues and rounds them to bf16 once), held
       with the per-token sums against fused_grouped_ffn_kv_bwd_reference
       (JAX's ragged_dot VJP) on groups of 0, 1, 255, 256 and 257 rows,
       at K1_CHECK_SHAPES and at the 154M layer (at most K1_BWD_OFF_SHARE
       of a gradient's elements beyond 2^-7 |plain| + 2^-9 max|plain|,
       none beyond 2^-4 max|plain|; dkeys and dvalues bf16 values; two
       runs give the same bytes); timed at the 154M layer beside their
       plain versions, their bounds and torch._grouped_mm on the same
       products;
     - K2, causal flash attention forward, dK/dV and dQ, at B 64, h 4,
       T 1024, p 82 (the 154M shape), at B 8, h 4, T 256, p 64, and at the
       shapes that take the kernels' other paths (a ragged last tile, odd
       p, p 128, T below one tile), element by element: |kernel - plain|
       <= 2^-6 |plain| + 2^-5 rms(plain over the element's (b, h, 64-row
       tile)) for o, dQ, dK and dV (the kernels round P and dS to bf16),
       and |lse - plain| <= 1e-3; each kernel run twice gives the same
       bytes; timed at the 154M shape beside
       `scaled_dot_product_attention` forward and forward + backward
       (CUDA graphs, as the kernels) as the library yardstick, and beside
       the plain `delta = rowsum(dO * o)` that precedes the two kernels;
  4. routers and small LMs: every pretrain router's weights sum to 1 per
     token on the card; then a small LM with d_model 128, 2 layers, 8
     experts of 128, top-2 and head size 82, for CompeteSMoE and each of
     the five other routers, takes 3 optimizer steps from the same
     weights on the card (K1 and its backward kernels, K2) and on the CPU
     (plain versions), CompeteSMoE with 0, 2 and 1 competing layers; the
     CPU takes the card's top-k choices, and the rows where it would have
     chosen otherwise must be at most SMALL_LM_FLIP_SHARE of them, each
     within SMALL_LM_FLIP_GAP of its own choice; losses agree within
     SMALL_LM_LOSS_TOL and grad_norm within SMALL_LM_GRAD_TOL of the
     CPU's (a few times the
     gaps seen over several seeds, and planted kernel faults exceed them:
     chip_faults.py); then on the card 2 steps of the CompeteSMoE LM, a
     save through the task's Saver, a fresh task that resumes from it and
     the third step: losses and grad norms equal the uninterrupted run's,
     bit for bit;
  5. LM training (main path of the training slice): the 154M CompeteSMoE
     configuration of sweeps/slimpajama_moe_no_attmoe_154M_competesmoe.yaml
     at full width and depth with -moe.impl fused and
     -transformer.attn_backend flash, through the CLI's task, for 8 steps
     at batch 64 x 1024 (one microbatch) from step 0 of its flip schedule;
     losses finite, and per step K1 and each of its two backward kernels
     launch 16 - competing layers times, each K2 kernel 16 times; then the
     two other routers with 154M sweeps, field for field
     (sweeps/slimpajama_moe_no_attmoe_154M_deepseekv3.yaml and
     sweeps/slimpajama_moe_no_attmoe_154M_final.yaml, smoe_sigmoid) with
     the same two flags, 4 steps each, K1, its backward kernels and K2 at
     all 16 layers of every step (ms/step, tokens/s, peak memory);
  6. checkpoint and serving (main paths of the checkpoint and serving
     slices): a small model written in two shards and reloaded (bf16 and
     --load-4bit) equal to its writer, tensor for tensor; then
     CompeteSMoE-5.1B (SigLIP MoE tower, MoE projector, Phi-3.5-mini
     decoder) at full depth with random bf16 weights from --seed, written
     with save_hf_checkpoint into a temporary directory (names and shapes
     held to tests/fixtures/golden_5p1b_keys.json), loaded back in bf16
     (every tensor equal to the writer's), then loaded as the worker's
     --load-4bit --kv-quant int8 does (int4 decoder, int8 lm_head, NF4
     tower; every tensor equal to the writer quantized in place), with a
     `checkpoint_summary` line (bytes, seconds and GB/s of the write and of
     each load, each load's peak device memory, the host's peak resident
     memory); after a small model of the same kind is held against the
     CPU (solo, and through DecodeEngine as in 8), the loaded model
     answers one image+text prompt with 32 greedy tokens through
     stream_generate, equal to the writer's, K5 launched 4 projections x
     32 layers per decode step; then the same model through DecodeEngine
     as the worker builds it with --engine-slots 8 --speculative 4 (K5 at
     every decode, verify and prefill projection whose rows it takes, as
     in 8);
  7. server: the model worker over HTTP on 127.0.0.1 answers three text
     prompts;
  8. batched serving (main path of the engine slice): a small model of
     each served kind (bf16 with matvec_kernel: K3; --load-8bit with an
     int8 KV cache: K4; --load-4bit with an int8 KV cache: K5, before 6)
     runs the same 6 greedy requests through DecodeEngine(n_slots=4,
     spec_k=2) on the card and on the CPU; then
     CompeteSMoE-5.1B at full depth, random weights from --seed, through
     DecodeEngine as the worker builds it (make_engine): (1) --load-8bit,
     int8 KV, 8 slots, --speculative 4 (K4 at every decode and verify
     projection), then the worker over HTTP with --engine-slots 4
     --speculative 4 answering 3 concurrent requests; (2) bf16, 8 slots,
     pipeline depth 2 (K3). Each takes 8 concurrent requests (2 with a
     224 px image) and 4 more once slots retire, 32 new tokens each (the
     int4 engine of 6 too); K3, K4 or K5 launches must equal 4 x 32 x the
     forwards whose rows the kernel takes, every other kernel 0;
  9. the engine's features (main path of the serving features), on 6's
     loaded --load-4bit --kv-quant int8 model, through engines built as
     the worker builds them with --engine-slots 8 --engine-max-len 2048
     --speculative 4 --spec-adaptive --engine-prefix-cache 4
     --engine-prefill-chunk 128 --engine-warmup 32,128,256 (FEATURES):
     warmup's programs and seconds and an 8-request burst's TTFT with and
     without it; 4 two-turn conversations (4 prefix-cache hits, turn 2's
     first-token logits and tokens against an engine without the cache);
     a 1,536-token prompt beside 6 live streams (its first-token logits
     against the model's own cache filled in the same chunks, its tokens
     against an unchunked engine's, the longest gap of a live stream with
     and without chunking); adaptive speculation on a repetitive and a
     random mix (the random one must suppress verify ticks); the
     controller, a worker on the engine and the OpenAI API over HTTP (3
     chat completions against the engine's own output). First-token
     logits agree within 3% of the reference's largest where both sides
     take K5; streams of one prompt on two engines may part only where
     the top-2 margin is within 3% of the largest logit of the stream so
     far. The reference engines and forwards run outside the main path's
     windows: K5 launches on the main path must equal 4 x 32 x its viable
     forwards (chunks and unparks included), K3 and K4 0. Before 6,
     `small_engine_features_check`
     holds chunked prefill and the prefix cache on a small int4 model
     against engines without them (chip_faults.py plants three faults
     against it);
 10. captured decode programs: every serving step above replays a CUDA
     graph (utils/cuda_graph.py: the engine's step_plain, step_nucleus,
     spec_plain and spec_nucleus, the solo scan and verify programs), and
     launch counts add each replay's launches. Before 6,
     `small_captured_check` holds a small int4 model's engine (spec_k 3;
     pipeline 2) and solo streams, greedy and sampled, captured against
     eager token for token, its K5 launches through replays against its
     forwards, and windowed against full decoding (chip_faults.py plants
     four faults against it). After 6, the 5.1B solo decode in
     SOLO_CASES (greedy and sampled from a seed, with and without 4
     drafts verified a forward), captured and eager (equal tokens; tok/s
     of each; every solo capture's seconds and graph-pool bytes), and one
     profiled replay of the decode step must show qmm4_kernel 4 x 32
     times. After each engine of 6 and 8, its 12 requests through two
     engines of its flags stepped in this thread from one seed, captured
     and eager: equal streams, tok/s of each, the captures' seconds and
     pool bytes, and one profiled replay of step_plain showing the kind's
     kernel 4 x 32 times. In 9, plain ticks of 8 live slots at max_len
     512 and 2048, captured and eager: host and kernel ms, copy kernels'
     ms. Then the window A/B at the decoder (JAX's tools/bench_decode.py
     --window): one int4 decode step of 8 rows over a 2048-slot cache
     with about 300 live positions, captured with attn_window 384 and
     without, timed from replays with one profiled replay each: equal
     tokens, logits within 3%;
 11. with --profile: torch.profiler over two more training steps (with
     K1's, its backward's and K2's shares of a step by name, the float32
     GEMM kernels', and, through profiler ranges around their forward and
     backward, the competition step's dense pass and the float32
     lm_head), over decode steps of the
     served model and over engine ticks, captured and eager (with K3's,
     K4's or K5's share; device busy share and the kernels that take the
     time), and over 9's two speculation mixes.
Each main path (or each window of one) is driven with every launch count
set to 0 just before it and read just after. The last lines are the
kernels JSON, the card line and the result JSON.
"""

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import resource
import shutil
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
# (timed), then correctness only: the kernel's other instantiations (ES
# 256, 384 and 512)
K1_SHAPE = dict(T=65536, D=512, E=64, ES=128, k=8)
K1_CHECK_SHAPES = (dict(T=1024, D=256, E=8, ES=256, k=2),
                   dict(T=1024, D=128, E=8, ES=384, k=2),
                   dict(T=768, D=256, E=8, ES=512, k=2))
# K1's backward, for correctness only, beside K1_CHECK_SHAPES: a layer
# whose groups take the tiles' edges (k 1)
K1_BWD_EDGES = dict(T=1025, D=256, E=8, ES=128, k=1,
                    counts=(0, 1, 255, 256, 257, 0, 128, 128))
# K1's backward against fused_grouped_ffn_kv_bwd_reference: both compute
# the same bf16 roundings, so most elements agree bit for bit; a few round
# the other way where float32 sums in another order straddle a bf16
# rounding (and a relu mask flips where h rounds that close to 0), and
# their consumers carry it. At most this share of a gradient's elements
# may be off by more than 2^-7 |plain| + 2^-9 max|plain|, and none by more
# than 2^-4 max|plain|; dkeys and dvalues must hold bf16 values. The
# honest kernels read at most 1.3e-5 (dX at the 154M layer; 0 elsewhere),
# and the planted faults that this rule catches 0.28 or more
# (chip_faults.py); one wrong 64 x 128 tile of dkeys at the 154M layer is
# 2e-3
K1_BWD_OFF_SHARE = 1e-4
# (B, h, T, p): the 154M shape (timed), then correctness only: 16-byte
# copies; a ragged last tile; odd p (plain loads); p 128; T below one tile
K2_SHAPES = ((64, 4, 1024, 82), (8, 4, 256, 64), (2, 2, 200, 82),
             (2, 1, 130, 33), (1, 2, 320, 128), (1, 1, 40, 82))
LM_STEPS = 8                       # 154M training steps of the main path
# the two other routers with 154M sweeps, field for field, with the two
# kernel flags: sweeps/slimpajama_moe_no_attmoe_154M_deepseekv3.yaml and
# sweeps/slimpajama_moe_no_attmoe_154M_final.yaml (smoe_sigmoid, MoEUT's
# baseline); on the synthetic corpus, ROUTER_STEPS steps each
_SWEEP_154M_COMMON = (
    "-task synthetic_transformer -balance_loss_coef 0.01 -state_size 512 "
    "-transformer.encoder_n_layers 16 -transformer.n_heads 4 -dropout 0.0 "
    "-lr 0.00025 -lm.unroll 1024 -grad_clip 0.1 -amp 1 "
    "-save_interval 10000 -stop_after 100000 -moe.n_experts 64 "
    "-moe.expert_size 128 -pkm.n_heads 8 -lr_sched.type cos "
    "-transformer.head_projection_size 82 "
    "-transformer.universal.group_size 16 -wd 0.01 -batch_size 64 "
    "-n_microbatch 1 -lm.eval.enabled 0 -moe.impl fused "
    "-transformer.attn_backend flash").split()
ROUTER_SWEEPS = {name: ["-moe_name", name] + _SWEEP_154M_COMMON
                 for name in ("deepseekv3", "smoe_sigmoid")}
ROUTER_STEPS = 4
# small LM, card against CPU per step: |loss gap| (absolute) and
# |grad_norm gap| / grad_norm; a few times the largest honest gaps that
# chip_faults.py reads over seeds 0-4 (PERF.md), and below the gaps of
# its planted faults
SMALL_LM_LOSS_TOL = 5e-3
SMALL_LM_GRAD_TOL = 2e-3
# the CPU takes the card's top-k choices (`routed_as`). Of a router's
# top-k rows over the 3 steps at most SMALL_LM_FLIP_SHARE may be rows where
# the CPU's own scores pick another set (honest readings of chip_faults.py
# over seeds 0-4: at most 1.28%, CompeteSMoE; 0.78% for the others), and
# on each such row the CPU's score of the card's weakest choice must lie
# within SMALL_LM_FLIP_GAP[router] x |the CPU's k-th best score| below
# that k-th best: a power of two 3 to 5 times the router's largest honest
# reading (0.0078, 0.0131, 0.166, 0.0166, 0.0597, 0.0094 in this order:
# XMoE's cosine gate at temperature 0.3 turns a few bf16 roundings of its
# logits into a large step of probability)
SMALL_LM_FLIP_SHARE = 0.04
SMALL_LM_FLIP_GAP = {"competesmoe": 2.0 ** -5, "smoe_sigmoid": 2.0 ** -4,
                     "xmoe": 2.0 ** -1, "smoe_perturbed": 2.0 ** -4,
                     "deepseekv2": 2.0 ** -2, "deepseekv3": 2.0 ** -5}
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
    # K1's backward: XLA's ragged_dot VJP in JAX (no Pallas backward)
    "gmm2_bwd_dx": ("competesmoe_tpu_torch/csrc/gmm2_bwd.cu",
                    "competesmoe_tpu/ops/gmm_fused.py:223"),
    "gmm2_bwd_dw": ("competesmoe_tpu_torch/csrc/gmm2_bwd.cu",
                    "competesmoe_tpu/ops/gmm_fused.py:223"),
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
    """The kernel wrappers by name; each carries its `launches` count (a
    captured program's replays add its launches: utils/cuda_graph.py)."""
    from competesmoe_tpu_torch.utils.cuda_graph import kernel_wrappers
    return kernel_wrappers()


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


def k1_inputs(seed: int, shape=K1_SHAPE):
    """K1's operands (default: at the 154M layer shape) with skewed groups
    (a decreasing boost on the gate logits) and 4 empty experts:
    (xs, keys, values, tile_expert, group sizes)."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    T, D, E, ES, k = (shape[n] for n in ("T", "D", "E", "ES", "k"))
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
    lay = gf.aligned_layout_full(sel, E)
    return (x[lay.tok_padded], keys, values, lay.tile_expert,
            torch.bincount(sel.reshape(-1), minlength=E))


def k1_compare(xs, keys, values, tile_expert):
    """K1 against its plain version: (max_abs_err, tol, repeats), tolerance
    2^-6 * max|plain| (the kernel rounds the f32 weights to bf16);
    `repeats`: a second run gave the same bytes."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf
    got = gf.gmm2_fused_aligned(xs, keys, values, tile_expert)
    again = gf.gmm2_fused_aligned(xs, keys, values, tile_expert)
    want = gf.gmm2_fused_aligned_reference(xs, keys, values, tile_expert)
    torch.cuda.synchronize()
    err, top = rel_err(got, want)
    repeats = torch.equal(got.view(torch.int16), again.view(torch.int16))
    return err, 2.0 ** -6 * top, repeats


def k1_checks(seed: int):
    """`k1_compare` at every K1 check shape: (shape, max_abs_err, tol,
    repeats) rows."""
    rows = []
    for shape in K1_CHECK_SHAPES:
        xs, keys, values, tile_expert, _ = k1_inputs(seed, shape)
        rows.append((shape, *k1_compare(xs, keys, values, tile_expert)))
    return rows


def phase_k1(seed: int, reps: int = 20):
    """K1 at the 154M layer shape against its plain version, then timed."""
    from competesmoe_tpu_torch.ops import gmm_fused as gf

    D, E, ES, k = (K1_SHAPE[n] for n in ("D", "E", "ES", "k"))
    for shape, err, tol, repeats in k1_checks(seed):
        log(f"K1 {shape}: max_abs_err {err:.4g} (tol {tol:.4g}), repeats "
            f"{repeats}, correctness only")
        if not (err <= tol and repeats):
            raise AssertionError(f"K1 at {shape}: max_abs_err {err} (tol "
                                 f"{tol}), repeats {repeats}")
    xs, keys, values, tile_expert, sizes = k1_inputs(seed)
    err, tol, repeats = k1_compare(xs, keys, values, tile_expert)
    log(f"K1 gmm2_fused_aligned [S'={xs.shape[0]}, D={D}] E={E} ES={ES}: "
        f"groups {int(sizes.min())}..{int(sizes.max())} rows, "
        f"{int((sizes == 0).sum())} empty; max_abs_err {err:.4g} "
        f"(tol {tol:.4g}), repeats {repeats}")
    if not (err <= tol and repeats):
        raise AssertionError(f"K1 disagrees with its plain version: {err} "
                             f"> {tol}, or a second run gave other bytes")
    args = (xs, keys, values, tile_expert)
    ms = time_launches(gf.gmm2_fused_aligned, [args] * 4, reps)
    plain_ms = time_launches(gf.gmm2_fused_aligned_reference, [args], 5)
    nbytes = 2 * xs.numel() * 2 + (keys.numel() + values.numel()) * 4 \
        + tile_expert.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4.0 * xs.shape[0] * D * ES)
    log(f"K1 kernel {ms * 1e3:.1f} us (the bf16 cast of the weights "
        f"included)  plain {plain_ms * 1e3:.1f} us  "
        f"bound {bound_ms * 1e3:.1f} us ({bound_by})  "
        f"{bound_ms / ms:.1%} of bound")
    return dict(name="gmm2_fused_aligned", rows=int(xs.shape[0]), D=D,
                E=E, ES=ES, k=k, empty_experts=int((sizes == 0).sum()),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def k1_bwd_inputs(seed: int, shape):
    """The backward's operands: (x [T, D] bf16, sel [T, k], weights [T, k]
    f32, keys, values f32, g [T, D] bf16), the LM's weight scales; skewed
    groups with 4 empty experts as `k1_inputs`, or, with `counts` in the
    shape, exactly counts[e] rows for expert e (k 1)."""
    import torch

    T, D, E, ES, k = (shape[n] for n in ("T", "D", "E", "ES", "k"))
    g = torch.Generator(device="cuda").manual_seed(seed + 303)
    scale = (2.0 / 16) ** 0.5            # the LM's MoE weight_scale
    x = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    keys = torch.randn(E, D, ES, generator=g, device="cuda") * (
        D ** -0.5 * scale)
    values = torch.randn(E, ES, D, generator=g, device="cuda") * (
        (E * ES) ** -0.5 * scale)
    if "counts" in shape:
        ids = torch.repeat_interleave(
            torch.arange(E, device="cuda"),
            torch.tensor(shape["counts"], device="cuda"))
        sel = ids[torch.randperm(T * k, generator=g, device="cuda")]
        sel = sel.reshape(T, k)
    else:
        logits = torch.randn(T, E, generator=g, device="cuda")
        logits += torch.linspace(3.0, 0.0, E, device="cuda")
        logits[:, E - 4:] = float("-inf")
        sel = logits.topk(k, dim=-1).indices
    w = torch.softmax(torch.randn(T, k, generator=g, device="cuda"), -1)
    gout = torch.randn(T, D, generator=g, device="cuda").to(torch.bfloat16)
    return x, sel, w, keys, values, gout


def k1_bwd_compare(x, sel, w, keys, values, g):
    """K1's backward on the card (the forward's layout and bf16 weights,
    `gmm2_bwd_dx` then `gmm2_bwd_dw`, the per-token sums) against
    `fused_grouped_ffn_kv_bwd_reference` on the same inputs: one row per
    gradient with max_abs_err, top (max |plain|), off_share (the share of
    elements off by more than 2^-7 |plain| + 2^-9 top), repeats (a second
    run gave the same bytes), bf16_rounded (dkeys and dvalues hold bf16
    values) and ok (off_share <= K1_BWD_OFF_SHARE, max_abs_err <= 2^-4
    top, repeats, bf16_rounded)."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    _, lay, gathered, k16, v16 = gf._forward(x, sel, w, keys, values)
    got = gf.fused_grouped_ffn_kv_bwd(x, sel, w, lay, gathered, k16, v16, g)
    again = gf.fused_grouped_ffn_kv_bwd(x, sel, w, lay, gathered, k16, v16,
                                        g)
    want = gf.fused_grouped_ffn_kv_bwd_reference(x, sel, w, keys, values, g)
    torch.cuda.synchronize()
    rows = []
    for name, a, b, c in zip(("dx", "dweights", "dkeys", "dvalues"), got,
                             want, again):
        a, b = a.float(), b.float()
        top = float(b.abs().max())
        diff = (a - b).abs()
        if not torch.isfinite(diff).all():
            diff = torch.full_like(diff, float("inf"))
        err = float(diff.max())
        off = float((diff > 2.0 ** -7 * b.abs() + 2.0 ** -9 * top)
                    .float().mean())
        repeats = torch.equal(a, c.float())
        rounded = name not in ("dkeys", "dvalues") or torch.equal(
            a, a.to(torch.bfloat16).float())
        rows.append(dict(tensor=name, max_abs_err=err, top=top,
                         off_share=off, repeats=repeats,
                         bf16_rounded=rounded,
                         ok=(off <= K1_BWD_OFF_SHARE
                             and err <= 2.0 ** -4 * top and repeats
                             and rounded)))
    return rows


def k1_bwd_checks(seed: int):
    """`k1_bwd_compare` on the edge groups and at every K1 check shape:
    (label, rows) pairs."""
    out = []
    for shape in (K1_BWD_EDGES,) + K1_CHECK_SHAPES:
        label = ("groups of 0, 1, 255, 256, 257 rows" if "counts" in shape
                 else f"ES {shape['ES']}")
        out.append((label, k1_bwd_compare(*k1_bwd_inputs(seed, shape))))
    return out


def _log_bwd_rows(label, rows):
    for r in rows:
        log(f"K1 backward {label}: {r['tensor']:8s} max_abs_err "
            f"{r['max_abs_err']:.4g} (max |plain| {r['top']:.4g}), "
            f"off share {r['off_share']:.2e}, repeats {r['repeats']}, "
            f"bf16 {r['bf16_rounded']}")
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"K1's backward at {label} disagrees with "
                             f"fused_grouped_ffn_kv_bwd_reference: {rows}")


def grouped_mm_ms(xs, do, k16, v16, hr, dh, aoff, reps: int):
    """torch._grouped_mm on the products of each backward kernel, in ms
    (CUDA-graph replays): dX's three (h = xs keys, dh = do values^T, dxs
    = dh keys^T) and dW's two (xs^T dh, hr^T do) over the aligned rows.
    (None, None, why) where this torch lacks it or refuses them."""
    import torch

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, None, "torch._grouped_mm is absent"
    offs = aoff[1:].to(torch.int32)
    kt = k16.transpose(1, 2).contiguous()
    vt = v16.transpose(1, 2).contiguous()

    def dx_products():
        fn(xs, k16, offs=offs)
        fn(fn(do, vt, offs=offs), kt, offs=offs)

    def dw_products():
        fn(xs.t(), dh, offs=offs)
        fn(hr.t(), do, offs=offs)

    try:
        return (time_launches(dx_products, [()], reps),
                time_launches(dw_products, [()], reps), None)
    except Exception as e:  # noqa: BLE001 - a yardstick only
        return None, None, f"{type(e).__name__}: {str(e)[:160]}"


def phase_k1_bwd(seed: int, reps: int = 20):
    """K1's two backward kernels against the plain backward, on the edge
    groups and the check shapes, then at the 154M layer shape, where each
    kernel is timed (CUDA-graph replays) beside its plain version, its
    bound and torch._grouped_mm on its products."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    for label, rows in k1_bwd_checks(seed):
        _log_bwd_rows(label, rows)
    D, E, ES, k = (K1_SHAPE[n] for n in ("D", "E", "ES", "k"))
    x, sel, w, keys, values, g = k1_bwd_inputs(seed, K1_SHAPE)
    rows = k1_bwd_compare(x, sel, w, keys, values, g)
    _log_bwd_rows("the 154M layer", rows)
    err = {r["tensor"]: r["max_abs_err"] for r in rows}
    _, lay, _, k16, v16 = gf._forward(x, sel, w, keys, values)
    slot, aoff, gsize = lay.slot_padded, lay.aoff, lay.gsize
    wflat = w.to(torch.bfloat16).reshape(-1).contiguous()
    xs = x[lay.tok_padded]
    dx_args = (xs, g, slot, wflat, k16, v16, lay.tile_expert, aoff, gsize, k)
    dxs, hr, dh = gf.gmm2_bwd_dx(*dx_args)
    dw_args = (xs, hr, dh, g, slot, wflat, lay.tile_expert, aoff, gsize, k)
    S = xs.shape[0]
    valid = int(sel.numel())
    do = gf._slot_grads(S, g, slot, wflat, k, lay.tile_expert, aoff, gsize,
                        torch.bfloat16)
    lib_dx, lib_dw, why = grouped_mm_ms(xs, do, k16, v16, hr, dh, lay.aoff,
                                        reps)
    if why:
        log(f"K1 backward library yardstick n/a: {why}")
    del do
    out = {}
    # bytes: each input read once and each output written once, over the
    # rows each kernel reads: dX every padded row (it computes them all:
    # xs, slot, the bf16 weights, g and wflat; dxs, hr, dh), dW each
    # expert's rows rounded up to its 64-row steps (xs, hr, dh, slot; g,
    # wflat; dkeys, dvalues in float32); operations: the products' 2 x
    # rows x D x ES each, over every padded row for dX and over the rows
    # that hold slots for dW
    small = wflat.numel() * 2 + g.numel() * 2
    dw_rows = int(((gsize.long() + 63) // 64 * 64).sum())
    for name, fn, plain_fn, args, nbytes, ops, lib, e in (
            ("gmm2_bwd_dx", gf.gmm2_bwd_dx, gf.gmm2_bwd_dx_reference,
             dx_args, xs.numel() * 2 + S * 4 + small + 2 * k16.numel() * 2
             + xs.numel() * 2 + 2 * S * ES * 2, 3 * 2.0 * S * D * ES,
             lib_dx, err["dx"]),
            ("gmm2_bwd_dw", gf.gmm2_bwd_dw, gf.gmm2_bwd_dw_reference,
             dw_args, dw_rows * (D * 2 + 2 * ES * 2 + 4) + small
             + 2 * E * D * ES * 4, 2 * 2.0 * valid * D * ES, lib_dw,
             max(err["dkeys"], err["dvalues"]))):
        ms = time_launches(fn, [args] * 4, reps)
        plain_ms = time_launches(plain_fn, [args], 5)
        bound_ms, bound_by = bound(nbytes, ops)
        out[name] = dict(name=name, rows=S, D=D, E=E, ES=ES, k=k,
                         max_abs_err=e, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib, library_why=why)
        log(f"K1 backward {name} [S'={S}, D={D}] E={E} ES={ES}: kernel "
            f"{ms * 1e3:.1f} us  plain {plain_ms * 1e3:.1f} us  "
            f"_grouped_mm {'n/a' if lib is None else f'{lib * 1e3:.1f} us'}"
            f"  bound {bound_ms * 1e3:.1f} us ({bound_by})  "
            f"{bound_ms / ms:.1%} of bound")
    return out


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
    tensor, max_abs_err, worst (largest |err| / tolerance), repeats (a
    second run of the kernel gave the same bytes), ok (within the
    tolerance, and repeats), and old_rule_ok (whether the bound 2^-6 (o)
    or 2^-5 (gradients) x the largest |plain| would have passed it)."""
    import torch

    from competesmoe_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
    delta = fa.rowsum_delta(do, o)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dq_ref, dk_ref, dv_ref = fa._bwd_reference(q, k, v, do, lse, delta,
                                               scale)
    # every sum is taken in a fixed order: a second run, same bytes
    o2, lse2 = fa.flash_attention_fwd(q, k, v, scale)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    same = {"o": torch.equal(o.view(torch.int16), o2.view(torch.int16)),
            "lse": torch.equal(lse.view(torch.int32), lse2.view(torch.int32)),
            "dk": torch.equal(dk.view(torch.int16), dk2.view(torch.int16)),
            "dv": torch.equal(dv.view(torch.int16), dv2.view(torch.int16)),
            "dq": torch.equal(dq.view(torch.int16), dq2.view(torch.int16))}
    out = []
    lse_err = float((lse - lse_ref).abs().max())
    if not math.isfinite(lse_err):
        lse_err = float("inf")
    out.append(dict(kernel="flash_attention_fwd", tensor="lse",
                    max_abs_err=lse_err, worst=lse_err / 1e-3,
                    repeats=same["lse"], ok=lse_err <= 1e-3 and same["lse"],
                    old_rule_ok=lse_err <= 1e-3))
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
        repeats = same.get(tensor, True)
        out.append(dict(kernel=kernel, tensor=tensor, max_abs_err=err,
                        worst=worst, repeats=repeats,
                        ok=worst <= 1.0 and repeats,
                        old_rule_ok=err <= old * float(
                            want.float().abs().max())))
    return out


def phase_k2(seed: int, reps: int = 20):
    """K2's three kernels against the plain forward and backward at every
    shape of K2_SHAPES; rows keyed by kernel name, timed at the first
    (154M) shape, where the plain delta = rowsum(dO * o) that the backward
    computes before its two kernels is timed too (`delta_ms`)."""
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
                f"{c['worst']:.3f} of its tolerance"
                + ("" if c["repeats"] else "; a second run DIFFERS"))
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
        delta = fa.rowsum_delta(do, o)
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
        delta_ms = time_launches(fa.rowsum_delta, [(do, o)] * 4, reps)
        bwd_ms = sum(rows[n]["ms"] for n in ("flash_attention_bwd_dkv",
                                             "flash_attention_bwd_dq"))
        for n in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
            rows[n]["delta_ms"] = delta_ms
        log(f"K2 delta = rowsum(dO * o), plain PyTorch: "
            f"{delta_ms * 1e3:.1f} us = {delta_ms / (bwd_ms + delta_ms):.1%}"
            f" of the backward (dK/dV + dQ {bwd_ms * 1e3:.1f} us; sdpa's "
            f"backward {lib_bwd * 1e3:.1f} us, {bwd_ms / lib_bwd:.2f}x)")
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


def small_lm_task(seed: int, device: str, weights=None, flags=()):
    """The small LM's task on `device` (more `flags` after the small LM's
    own), with `weights` (a state dict) loaded when given."""
    task = _task(SMALL_LM_FLAGS + ["-seed", str(seed), "-device", device,
                                   *flags])
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


# the routers the small LM check runs: CompeteSMoE (with its competition
# steps) and the five other pretrain routers (no competition)
SMALL_LM_ROUTERS = ("competesmoe", "smoe_sigmoid", "xmoe", "smoe_perturbed",
                    "deepseekv2", "deepseekv3")


@contextlib.contextmanager
def routed_as(record=None, replay=None):
    """Every top-k choice of the port's routers (`ops.routing.top_k`, which
    each router and the competition step call once a forward) appended
    to `record`, or, with `replay`, taken from it in the same order: the
    scores' own choice is computed and compared, then the recorded
    indices are used, with their scores gathered (so gradients flow as
    through top_k). Yields a dict: rows (of every replayed choice),
    flipped (rows whose expert set differs) and gap (the largest, over
    flipped rows, of the scores' k-th best less their score of the
    replayed set's weakest expert, over |the k-th best|)."""
    import torch

    from competesmoe_tpu_torch.ops import routing

    honest = routing.top_k
    calls = iter(replay) if replay is not None else None
    seen = dict(rows=0, flipped=0, gap=0.0)

    def top_k(scores, k):
        values, idx = honest(scores, k)
        if record is not None:
            record.append(idx.detach().cpu())
        if calls is not None:
            want = next(calls).to(idx.device)
            same = (torch.sort(want, -1).values
                    == torch.sort(idx, -1).values).all(-1)
            got = torch.gather(scores, -1, want)
            with torch.no_grad():
                kth = values[..., -1].float()
                gap = (kth - got.float().min(-1).values) / kth.abs()
                seen["rows"] += same.numel()
                seen["flipped"] += int((~same).sum())
                if not same.all():
                    seen["gap"] = max(seen["gap"], float(gap[~same].max()))
            idx, values = want, got
        return values, idx

    routing.top_k = top_k
    try:
        yield seen
    finally:
        routing.top_k = honest


def small_lm_check():
    """`small_lm_router_check` for every router of SMALL_LM_ROUTERS:
    {router: per-step gaps}."""
    return {name: small_lm_router_check(name) for name in SMALL_LM_ROUTERS}


def small_lm_router_check(name: str):
    """A small LM of the 154M kind with router `name` takes 3 optimizer
    steps on the card (K1 and its backward kernels, K2) and on the CPU
    (plain versions) from the same weights and batches (seed 0); for
    CompeteSMoE steps 0-2 have 0, 2 and 1 competing layers. Per step the
    loss agrees within SMALL_LM_LOSS_TOL and grad_norm within
    SMALL_LM_GRAD_TOL (bf16 activations; K1 rounds the f32 expert weights
    to bf16, K2 rounds P and dS). The CPU takes the card's top-k choices
    (`routed_as`): a gate whose top scores lie within a rounding of each
    other (bf16 probabilities, a cosine gate at temperature 0.3) may pick
    another expert on the other device, a discrete change no tolerance of
    the kernels covers; the rows where the CPU would have picked another
    set are counted: at most SMALL_LM_FLIP_SHARE of the rows, each within
    SMALL_LM_FLIP_GAP[name] of the CPU's own choice. For CompeteSMoE the
    Saver's save and restore is held too."""
    flags = ["-moe_name", name]
    cpu = small_lm_task(0, "cpu", flags=flags)
    init = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    gpu = small_lm_task(0, "cuda", init, flags)
    choices = []
    counts0 = read_counts()
    with routed_as(record=choices):
        card = small_lm_steps(gpu)
    counts = {k: v - counts0[k] for k, v in read_counts().items()}
    if name == "competesmoe":
        small_lm_resume_check(init, card)
    with routed_as(replay=choices) as seen:
        ref = small_lm_steps(cpu)
    gaps = small_lm_gaps(ref, card)
    for c, g, d in zip(ref, card, gaps):
        log(f"small LM {name} step (flips {d['flips']}): loss card "
            f"{g['loss/total']:.6f} cpu {c['loss/total']:.6f} (gap "
            f"{d['loss_gap']:.3g}, tol {SMALL_LM_LOSS_TOL}); grad_norm card "
            f"{g['grad_norm']:.6f} cpu {c['grad_norm']:.6f} (gap "
            f"{d['grad_gap']:.3g} of it, tol {SMALL_LM_GRAD_TOL})")
    share = seen["flipped"] / seen["rows"]
    log(f"small LM {name}: in {len(choices)} top-k choices of 3 steps "
        f"({seen['rows']} rows), the CPU would have picked another set in "
        f"{seen['flipped']} rows ({share:.3%}, limit "
        f"{SMALL_LM_FLIP_SHARE:.0%}); it took the card's; the CPU's k-th "
        f"best score lies above its score of the card's weakest choice by "
        f"at most {seen['gap']:.3g} of it (limit "
        f"{SMALL_LM_FLIP_GAP[name]:.3g})")
    if not (share <= SMALL_LM_FLIP_SHARE
            and seen["gap"] <= SMALL_LM_FLIP_GAP[name]):
        raise AssertionError(f"small LM {name}: the card chose another "
                             f"top-k set than the CPU on {share:.3%} of the "
                             f"rows, with a score gap of {seen['gap']:.3g}")
    if not all(d["ok"] for d in gaps):
        raise AssertionError(f"small LM {name} disagrees: {gaps}")
    flips = [d["flips"] for d in gaps]
    if flips != ([0, 2, 1] if name == "competesmoe" else [0, 0, 0]):
        raise AssertionError(f"small LM {name}: flip counts {flips}")
    fused = sum(2 - f for f in flips)
    want = {"gmm2_fused_aligned": fused, "gmm2_bwd_dx": fused,
            "gmm2_bwd_dw": fused, "flash_attention_fwd": 6,
            "flash_attention_bwd_dkv": 6, "flash_attention_bwd_dq": 6,
            "quant_small_m_matmul_int4": 0, "small_m_matmul": 0,
            "quant_small_m_matmul": 0}
    if counts != want:
        raise AssertionError(f"small LM {name} launches {counts} != {want}")
    log(f"small LM {name}: card launches {counts}")
    for d in gaps:
        d.update(topk_rows=seen["rows"], topk_flips=seen["flipped"],
                 topk_gap=seen["gap"])
    return gaps


def router_weights_check(seed: int):
    """Every pretrain router's routing weights on the card sum to 1 per
    token (DeepSeek-V3: its routed_scaling_factor), within bf16 rounding
    (2^-6), from random bf16 inputs through the layer's own gate."""
    import torch

    from competesmoe_tpu_torch.moe.registry import PRETRAIN_MOE_REGISTRY

    g = torch.Generator(device="cuda").manual_seed(seed + 404)
    x = torch.randn(4, 64, 128, generator=g, device="cuda").to(
        torch.bfloat16)
    for name, cls in sorted(PRETRAIN_MOE_REGISTRY.items()):
        layer = cls(128, 8, 128, 2, device="cuda")
        layer.reset_parameters(g)
        with torch.no_grad():
            weights, sel, _ = layer.route(x, layer.compute_gate(x))
        want = getattr(layer, "routed_scaling_factor", 1.0)
        err = float((weights.float().sum(-1) - want).abs().max())
        log(f"router {name}: weights sum to {want} within {err:.3g}")
        if not err <= 2.0 ** -6 * want or sel.shape[-1] != 2:
            raise AssertionError(f"router {name}: weights sum off by {err}")


def small_lm_resume_check(init, card):
    """The Saver on the card: the small LM from `init` takes 2 steps and
    saves them; a fresh task in the same run directory resumes from that
    checkpoint (model, optimizer state, sampler, flip schedule) and takes
    the third. Every step's loss and grad_norm must equal, bit for bit,
    those of the uninterrupted card run `card` (K1 and K2 are
    deterministic, and so is the rest of the step)."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        flags = ["-run_dir", str(tmp), "-name", "resume"]
        first = small_lm_task(0, "cuda", init, flags)
        rows = small_lm_steps(first, 2)
        saved = first.saver.save(first.state.step)
        del first
        second = small_lm_task(0, "cuda", flags=flags)
        if second.state.step != 2 or second.sampler.pos != 2:
            raise AssertionError(f"small LM resume: step "
                                 f"{second.state.step}, sampler "
                                 f"{second.sampler.pos} after restoring "
                                 f"{saved.name}")
        rows += small_lm_steps(second, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ("loss/total", "grad_norm", "competesmoe/n_flip_layers")
    got = [[r[k] for k in keys] for r in rows]
    want = [[r[k] for k in keys] for r in card]
    log(f"small LM save/restore on the card: 2 steps, {saved.name}, a "
        f"fresh task restored, 1 step: {got} (uninterrupted {want})")
    if got != want:
        raise AssertionError(f"small LM after save/restore {got} != the "
                             f"uninterrupted run {want}")


def phase_lm(seed: int, steps: int = LM_STEPS):
    """The training slice's main path: the 154M CompeteSMoE configuration
    through the CLI's task for `steps` steps from step 0, one microbatch
    per step."""
    return train_154m("competesmoe", SWEEP_154M, seed, steps)


def phase_router(name: str, seed: int, steps: int = ROUTER_STEPS):
    """A router's 154M sweep (ROUTER_SWEEPS) through the CLI's task for
    `steps` steps: K1, its backward kernels and K2 at every layer."""
    return train_154m(name, ROUTER_SWEEPS[name], seed, steps)


def train_154m(name: str, flags, seed: int, steps: int):
    """`steps` training steps of the 154M configuration `flags` (router
    `name`) through the CLI's task from step 0. Losses must be finite, the
    logged flips must equal the schedule's (none without one), and per
    step K1 and each of its backward kernels launch 16 - competing layers
    times, each K2 kernel 16 times, every other kernel never."""
    import torch

    run = REPO / "runs" / "chip_smoke" / f"lm154m_{name}"
    (run / "log_trainer.jsonl").unlink(missing_ok=True)
    t0 = time.perf_counter()
    task = _task(flags + [
        "-seed", str(seed), "-device", "cuda", "-run_dir", str(run.parent),
        "-name", run.name, "-log_interval", "1", "-valid_interval", "0"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in task.model.parameters())
    L = task.cfg.n_layers
    log(f"lm {name}: {n_params / 1e6:.2f}M parameters, {L} layers, built "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    if task.schedule is not None:
        flips = [sum(task.schedule.is_flip(li, s) for li in range(L))
                 for s in range(steps)]
        if not (min(flips) == 0 < max(flips)):
            raise AssertionError(f"steps 0..{steps - 1} need a competing "
                                 f"and a non-competing step; flips {flips}")
    else:
        flips = [0] * steps
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
        raise AssertionError(f"lm {name}: logged steps "
                             f"{[r['step'] for r in recs]}")
    for r, f in zip(recs, flips):
        if not math.isfinite(r["loss/total"]):
            raise AssertionError(f"lm {name}: non-finite loss at step "
                                 f"{r['step']}")
        if int(r["competesmoe/n_flip_layers"]) != f:
            raise AssertionError(f"lm {name}: step {r['step']} flips "
                                 f"{r['competesmoe/n_flip_layers']} != {f}")
    fused = sum(L - f for f in flips)
    want = {"gmm2_fused_aligned": fused, "gmm2_bwd_dx": fused,
            "gmm2_bwd_dw": fused, "flash_attention_fwd": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "quant_small_m_matmul_int4": 0, "small_m_matmul": 0,
            "quant_small_m_matmul": 0}
    if counts != want:
        raise AssertionError(f"lm {name} launches {counts} != {want}")
    ms = [r["timing/ms_per_step_wall"] for r in recs]
    tokens = task.a.batch_size * task.a.lm.unroll
    steady = statistics.median(ms[1:])        # the first step warms up
    for r, f in zip(recs, flips):
        log(f"lm {name} step {r['step']}: flips {f}, loss "
            f"{r['loss/total']:.4f} (ce {r['loss/ce']:.4f}), grad_norm "
            f"{r['grad_norm']:.4f}, {r['timing/ms_per_step_wall']:.1f} ms")
    summary = dict(
        router=name, params=n_params, steps=steps, flips=flips,
        launches=counts, wall_s=wall, ms_per_step=ms,
        ms_per_step_median_after_first=steady,
        ms_per_step_no_flip=[m for m, f in zip(ms[1:], flips[1:]) if not f],
        ms_per_step_flip=[m for m, f in zip(ms[1:], flips[1:]) if f],
        tokens_per_s=tokens / (steady / 1e3), peak_mem_gib=peak / 2 ** 30,
        losses=[r["loss/total"] for r in recs])
    log(f"lm {name}: {steps} steps in {wall:.1f} s; median {steady:.1f} "
        f"ms/step after the first ({summary['tokens_per_s']:.0f} tok/s); "
        f"peak memory {summary['peak_mem_gib']:.2f} GiB; launches {counts}")
    return task, summary


def profile_train(task, steps: int = 2):
    """torch.profiler over `steps` more training steps: wall time, device
    kernel time (so the busy share), the kernels that take it, and the
    device time of TRAIN_RANGES (each function wrapped, for the window, so
    that its forward and its backward run inside profiler ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with train_ranges(task), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train(n_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _busy(prof, wall, steps, "train", TRAIN_GROUPS,
                 [label for label, _ in TRAIN_RANGES])


# kernel-name fragments whose device time a profile sums by label
TRAIN_GROUPS = {"K2 backward (dK/dV + dQ)": ("flash_bwd_dkv_kernel",
                                             "flash_bwd_dq_kernel"),
                "K2 forward": ("flash_fwd_kernel",),
                "K1 (without its weight casts)": ("gmm2_kernel",),
                "K1 backward (dX + dW)": ("gmm2_bwd_dx_kernel",
                                          "gmm2_bwd_dw_kernel")}
# (label, where): the functions whose device time a training profile
# reads through ranges, forward and backward: the competition step's
# dense all-experts pass (float32 products) and the float32 lm_head
TRAIN_RANGES = (("competition dense pass", "expert_compute.dense_all_experts_kv"),
                ("lm_head (float32)", "model.output"))
# fragments of the names of cuBLAS / CUTLASS GEMM kernels on 16-bit
# operands; a GEMM kernel whose name holds none takes float32 ones
LOW_PRECISION = ("bf16", "f16", "hgemm", "bgemm", "s16816", "h16816")


@functools.lru_cache(maxsize=None)
def _range_mark():
    """An identity autograd function that opens a profiler range when the
    gradient of a ranged function's output arrives and closes it when the
    last of its inputs' gradients has been computed: the function's
    backward, in a range of its own."""
    import torch
    from torch.autograd.profiler import record_function

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, state, side):
            ctx.state, ctx.side = state, side
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            st = ctx.state
            if ctx.side == "out" and st.get("range") is None:
                st["range"] = record_function(st["label"] + " (backward)")
                st["range"].__enter__()
            elif ctx.side == "in":
                st["left"] -= 1
                if st["left"] == 0 and st.get("range") is not None:
                    st["range"].__exit__(None, None, None)
            return grad, None, None

    return Mark


def _ranged(fn, label: str):
    """`fn` with its forward in the profiler range `label` and its
    backward in `label (backward)`."""
    import torch
    from torch.autograd.profiler import record_function

    mark = _range_mark()

    def run(*args, **kwargs):
        st = {"label": label, "left": 0}

        def mark_in(a):
            if torch.is_tensor(a) and a.requires_grad and \
                    torch.is_grad_enabled():
                st["left"] += 1
                return mark.apply(a, st, "in")
            return a

        args = [mark_in(a) for a in args]
        with record_function(label):
            out = fn(*args, **kwargs)

        def mark_out(t):
            if torch.is_tensor(t) and t.requires_grad and \
                    torch.is_grad_enabled():
                return mark.apply(t, st, "out")
            return t

        if isinstance(out, tuple):
            return tuple(mark_out(t) for t in out)
        return mark_out(out)

    return run


@contextlib.contextmanager
def train_ranges(task):
    """TRAIN_RANGES wrapped for the block (module attributes and the
    model's output head), and put back after it."""
    from competesmoe_tpu_torch.ops import expert_compute

    undo = []
    for label, where in TRAIN_RANGES:
        owner, attr = where.split(".")
        obj = {"expert_compute": expert_compute,
               "model": task.model}[owner]
        if owner == "model":
            obj = getattr(obj, attr)
            attr = "forward"
        undo.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, _ranged(getattr(obj, attr), label))
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


ENGINE_GROUPS = {"K3": ("mm_bf16_kernel",), "K4": ("qmm8_kernel",),
                 "K5": ("qmm4_kernel",)}
# PyTorch's copy and conversion kernels (the attention's one bf16 copy of
# each layer's K and V, among others)
COPY_GROUP = {"copy kernels": ("copy_kernel",)}


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block when `enabled` (yields it), else
    nothing (yields None)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def _busy(prof, wall, steps, what, groups=None, ranges=()):
    """Wall and device-kernel ms per step of a profiled window, the busy
    share, the 12 kernels that take the most device time, and, for each
    label of `groups`, the device time of the kernels whose names hold
    one of its fragments (ms per step and share of the step's wall time);
    for each label of `ranges`, the device time of the kernels launched
    inside its profiler ranges, forward and backward (`_ranged`), and, in
    a training profile, the float32 GEMM kernels' time."""
    import torch
    kernels, in_ranges = [], {}
    labels = set(ranges) | {label + " (backward)" for label in ranges}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # a range's mirror on the device timeline is no kernel
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.key not in labels:
            kernels.append((dev_us, ev.count, ev.key))
    # a range's kernels: the device time of the kernels launched inside it
    # (its CPU event's total, one event a call); its span: how long its
    # mirror on the device timeline lasts, gaps included (key_averages
    # would merge the two)
    for ev in (prof.events() if labels else ()):
        if ev.name in labels:
            label = ev.name.replace(" (backward)", "")
            part = "backward" if ev.name.endswith("(backward)") \
                else "forward"
            if ev.device_type != torch.autograd.DeviceType.CPU:
                part += " span"
            sums = in_ranges.setdefault(label, {})
            sums[part] = sums.get(part, 0.0) + (
                ev.device_time_total if hasattr(ev, "device_time_total")
                else ev.cuda_time_total)
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    log(f"profile: {steps} {what} steps, wall {wall_ms:.2f} ms/step, "
        f"device kernels {busy_ms:.3f} ms/step, busy share "
        f"{busy_ms / wall_ms:.1%}")
    for dev_us, count, name in kernels[:12]:
        log(f"  {dev_us / 1e3 / steps:8.3f} ms/step  {count // steps:5d} "
            f"launches/step  {name[:90]}")
    named = {}
    for label, fragments in (groups or {}).items():
        ms = sum(d for d, _, n in kernels
                 if any(f in n for f in fragments)) / 1e3 / steps
        named[label] = dict(ms_per_step=ms, share_of_wall=ms / wall_ms,
                            share_of_device=ms / busy_ms)
        log(f"  {label}: {ms:.3f} ms/step = {ms / wall_ms:.1%} of the step, "
            f"{ms / busy_ms:.1%} of its device time")
    ranged = {}
    for label in ranges:
        part = {k: v / 1e3 / steps for k, v in in_ranges.get(label,
                                                              {}).items()}
        fwd, bwd = part.get("forward", 0.0), part.get("backward", 0.0)
        ranged[label] = dict(part, ms_per_step=fwd + bwd)
        log(f"  range {label}: kernels {fwd + bwd:.3f} ms/step (forward "
            f"{fwd:.3f}, backward {bwd:.3f}); spans on the device: forward "
            f"{part.get('forward span', 0.0):.3f}, backward "
            f"{part.get('backward span', 0.0):.3f}")
    if ranges:
        f32 = sum(d for d, _, n in kernels if "gemm" in n.lower()
                  and not any(f in n.lower() for f in LOW_PRECISION))
        named["float32 GEMMs (by kernel name)"] = dict(
            ms_per_step=f32 / 1e3 / steps,
            share_of_wall=f32 / 1e3 / steps / wall_ms,
            share_of_device=f32 / 1e3 / steps / busy_ms)
        log(f"  float32 GEMM kernels: {f32 / 1e3 / steps:.3f} ms/step")
    return dict(wall_ms_per_step=wall_ms, device_ms_per_step=busy_ms,
                busy_share=busy_ms / wall_ms, groups=named, ranges=ranged,
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


MANIFEST = REPO / "tests" / "fixtures" / "golden_5p1b_keys.json"


def differing(got, want):
    """Names whose tensors differ between two state dicts (missing on one
    side, or another dtype, shape or any bit)."""
    import torch
    bad = sorted(set(got) ^ set(want))
    return bad + [k for k in sorted(want) if k in got and not (
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and torch.equal(got[k], want[k]))]


def small_checkpoint_check(seed: int):
    """The checkpoint path at SMALL_HF's geometry on the card: a bf16 model
    from `seed` exported and written in two shards (half the tensors each,
    with config.json), loaded back in bf16 (every tensor equal, bit for
    bit) and with --load-4bit --kv-quant int8 (every tensor equal to the
    writer quantized in place)."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, apply_load_4bit, build_llava, load_pretrained_model)
    from competesmoe_tpu_torch.models.hf_export import (
        export_llava_checkpoint)
    from competesmoe_tpu_torch.models.safetensors_io import save_file

    writer = build_llava(served_config("int4", small=True), seed, "cuda")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_small_ckpt_"))
    try:
        sd = export_llava_checkpoint(writer)
        names = sorted(sd)
        for i, part in enumerate((names[:len(names) // 2],
                                  names[len(names) // 2:])):
            save_file({k: sd[k] for k in part},
                      tmp / f"model-0000{i + 1}-of-00002.safetensors")
        (tmp / "config.json").write_text(json.dumps(dict(HF_5P1B,
                                                         **SMALL_HF)))
        loaded = load_pretrained_model(tmp, device="cuda")[1]
        bad = differing(loaded.state_dict(), writer.state_dict())
        if bad:
            raise AssertionError(f"small checkpoint: {len(bad)} tensors "
                                 f"differ after the bf16 reload: {bad[:6]}")
        quant = load_pretrained_model(tmp, load_4bit=True, kv_quant="int8",
                                      device="cuda")[1]
        apply_load_4bit(writer)
        bad = differing(quant.state_dict(), writer.state_dict())
        if bad or quant.cfg != writer.cfg:
            raise AssertionError(f"small checkpoint: --load-4bit differs "
                                 f"from the writer quantized: {bad[:6]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    log(f"small checkpoint (card): {len(names)} tensors in two shards, "
        "the bf16 and the --load-4bit reloads equal the writer, bit for bit")


def phase_checkpoint(seed: int, new_tokens: int = 32):
    """The checkpoint path at the full 5.1B geometry: build the bf16 model
    from `seed`, write it with save_hf_checkpoint (config.json = HF_5P1B),
    hold the written names and shapes to the released layout
    (tests/fixtures/golden_5p1b_keys.json), load it back in bf16 (every
    tensor equal, bit for bit), then quantize the writer in place as the
    solo phase used to build its model (--load-4bit, int8 KV) and take its
    greedy tokens, load the checkpoint with --load-4bit --kv-quant int8
    (every tensor and the config equal to the quantized writer's) and
    return that model with the writer's tokens. The checkpoint lives in a
    temporary directory, removed at the end whether or not a check
    failed."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, apply_load_4bit, build_llava, load_pretrained_model)
    from competesmoe_tpu_torch.models.hf_export import save_hf_checkpoint
    from competesmoe_tpu_torch.models.safetensors_io import read_header

    small_checkpoint_check(seed)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    cfg = served_config("int4", small=False)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    ckpt = tmp / "competesmoe-5.1b"
    try:
        t0 = time.perf_counter()
        writer = build_llava(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        log(f"checkpoint: 5.1B bf16 built in {time.perf_counter() - t0:.1f}"
            f" s")
        t0 = time.perf_counter()
        path = save_hf_checkpoint(writer, cfg, ckpt, hf_config=HF_5P1B)
        write_s = time.perf_counter() - t0
        nbytes = path.stat().st_size
        layout = {k: v["shape"] for k, v in read_header(path).items()
                  if k != "__metadata__"}
        manifest = json.loads(MANIFEST.read_text())["keys"]
        if layout != manifest:
            diff = sorted(k for k in set(layout) | set(manifest)
                          if layout.get(k) != manifest.get(k))
            raise AssertionError(f"written layout differs from the 5.1B "
                                 f"manifest at {len(diff)} names: {diff[:6]}")
        log(f"checkpoint: wrote {nbytes / 1e9:.3f} GB in {write_s:.1f} s; "
            f"{len(layout)} names and shapes equal the released layout")

        def load(**kw):
            free_card()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = load_pretrained_model(ckpt, device="cuda", **kw)[1]
            torch.cuda.synchronize()
            return (model, time.perf_counter() - t0,
                    torch.cuda.max_memory_allocated() - base)

        loaded, bf16_s, bf16_peak = load()
        bad = differing(loaded.state_dict(), writer.state_dict())
        if bad:
            raise AssertionError(f"bf16 reload: {len(bad)} tensors differ "
                                 f"from the writer's: {bad[:6]}")
        log(f"checkpoint: bf16 load in {bf16_s:.1f} s, every tensor equal "
            f"to the writer's")
        del loaded
        apply_load_4bit(writer)
        want = greedy_run(writer, *model_prompt(seed, cfg.decoder.vocab_size),
                          new_tokens)[0][0].tolist()
        model, q_s, q_peak = load(load_4bit=True, kv_quant="int8")
        bad = differing(model.state_dict(), writer.state_dict())
        if bad or model.cfg != writer.cfg:
            raise AssertionError(f"--load-4bit: {len(bad)} tensors differ "
                                 f"from the quantized writer's: {bad[:6]}")
        del writer
        free_card()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    summary = dict(
        bytes_written=nbytes, tensors=len(layout), write_s=write_s,
        write_gb_s=nbytes / write_s / 1e9, load_bf16_s=bf16_s,
        load_bf16_gb_s=nbytes / bf16_s / 1e9, load_4bit_s=q_s,
        load_4bit_gb_s=nbytes / q_s / 1e9,
        load_bf16_peak_device_gib=bf16_peak / 2 ** 30,
        load_4bit_peak_device_gib=q_peak / 2 ** 30,
        host_peak_rss_gib_before=rss0 / 2 ** 30,
        host_peak_rss_gib=rss / 2 ** 30, card=card_line())
    log(f"checkpoint: --load-4bit --kv-quant int8 in {q_s:.1f} s, every "
        f"tensor equal to the quantized writer's; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    print("checkpoint_summary " + json.dumps(summary), flush=True)
    return model, want


def model_prompt(seed: int, vocab: int):
    """The solo phase's prompt: 48 tokens with the image sentinel at 8,
    and a 224 px image."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (1, 48)).astype(np.int32)
    ids[0, 8] = -200
    px = rng.uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32)
    return ids, px


def greedy_run(model, ids, px, n: int, temperature: float = 0.0,
               top_p: float = 1.0, seed=None, cuda_graphs: bool = True,
               speculative: int = 0):
    """`n` tokens through stream_generate, greedy unless `temperature`
    (drawn from a generator seeded with `seed`), verifying `speculative`
    prompt-lookup drafts a forward when above 0: (tokens [1, n], seconds
    to the first chunk, seconds from it to the last). On the card the
    decode and verify steps replay captured programs unless
    cuda_graphs=False."""
    import torch

    from competesmoe_tpu_torch.models.llava import stream_generate

    gen = (None if seed is None
           else torch.Generator(device=model.device).manual_seed(seed))
    t_start = time.perf_counter()
    chunks, t_first = [], None
    for c in stream_generate(model, ids, px, max_new_tokens=n,
                             temperature=temperature, top_p=top_p,
                             generator=gen, cuda_graphs=cuda_graphs,
                             speculative=speculative):
        if t_first is None:
            t_first = time.perf_counter()
        chunks.append(c)
    t_end = time.perf_counter()
    return np.concatenate(chunks, axis=1), t_first - t_start, \
        t_end - t_first


def phase_model(seed: int, model, want_tokens=None, new_tokens: int = 32):
    """The serving slice's main path: `model` (the 5.1B checkpoint loaded
    with --load-4bit --kv-quant int8) answers one image+text prompt with
    `new_tokens` greedy tokens through stream_generate; they must equal
    `want_tokens` when given (the tokens of the model that wrote the
    checkpoint)."""
    cfg = model.cfg
    ids, px = model_prompt(seed, cfg.decoder.vocab_size)
    # warm-up: lazy inits, and the captures of the request's bucket (one
    # scan program per chunk size)
    greedy_run(model, ids, px, new_tokens)
    reset_counts()                           # main path starts here
    toks, ttft, rest = greedy_run(model, ids, px, new_tokens)
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
    if want_tokens is not None and toks[0].tolist() != want_tokens:
        raise AssertionError(f"the loaded checkpoint's tokens {toks[0]} != "
                             f"those of the model that wrote it "
                             f"{want_tokens}")
    tok_s = steps / rest
    log(f"generate: {new_tokens} greedy tokens, TTFT {ttft * 1e3:.1f} ms, "
        f"decode {tok_s:.2f} tok/s ({rest / steps * 1e3:.2f} ms/token), K5 "
        f"launches {launches} = {launches // steps} per decode step")
    log(f"tokens: {toks[0].tolist()} (equal to the writer's: "
        f"{want_tokens is not None})")
    # one profiled replay of the captured one-step program holds the
    # kernels a forward launches
    per_replay = replay_kernel_count(solo_program(model, ("scan", 1)),
                                     "qmm4_kernel", 4 * L)
    if per_replay != 4 * L:
        raise AssertionError(f"a profiled replay of the solo decode step "
                             f"launched qmm4_kernel {per_replay} times, not "
                             f"4 x {L}")
    log(f"generate: one profiled replay of the captured decode step shows "
        f"qmm4_kernel {per_replay} times (4 x {L})")
    return launches, dict(ttft_ms=ttft * 1e3, decode_tok_s=tok_s,
                          ms_per_token=rest / steps * 1e3,
                          decode_steps=steps, layers=L,
                          qmm4_per_replay=per_replay)


def solo_program(model, head: tuple):
    """The first captured solo program whose key starts with `head`
    (models/llava.py `_SoloCaches`)."""
    solo = model._solo_caches
    return next(prog for key, prog in solo.programs.items()
                if key[1:1 + len(head)] == head)[-1]


def replay_kernels(program):
    """{kernel name: (launches, device µs)} of one replay of the captured
    `program`, as torch.profiler traces the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        program()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            out[ev.key] = (ev.count, dev_us)
    return out


def replay_kernel_count(program, fragment: str, want: int) -> int:
    """The launches of kernels whose names hold `fragment` in one replay of
    the captured `program`. The profiler now and then loses kernel records
    of a replay (once 95 of 128, where 16 profiled replays of the same
    program in a run of their own each showed 128), so a replay that shows
    fewer than `want` is profiled again, up to 3 times; a replay cannot
    launch fewer nodes than it captured, and more is never retried."""
    for _ in range(3):
        n = sum(c for key, (c, _) in replay_kernels(program).items()
                if fragment in key)
        if n >= want:
            break
    return n


# the solo cases held captured against eager: (tag, temperature, top_p,
# drafts verified a forward)
SOLO_CASES = (("greedy", 0.0, 1.0, 0), ("sampled", 0.8, 0.9, 0),
              ("speculative 4", 0.0, 1.0, 4),
              ("speculative 4 sampled", 0.8, 0.9, 4))


def solo_vs_eager(model, seed: int, new_tokens: int = 32):
    """The solo phase's prompt through stream_generate in SOLO_CASES
    (sampled ones from a generator seeded with `seed`): the captured
    programs (a first run captures what the case needs: scan programs,
    and verify programs under speculation) and the eager steps
    (cuda_graphs=False) on the same card give equal tokens; returns each
    side's decode tok/s and every solo capture's seconds and pool
    bytes."""
    ids, px = model_prompt(seed, model.cfg.decoder.vocab_size)
    res = {}
    for tag, temp, top_p, spec in SOLO_CASES:
        greedy_run(model, ids, px, new_tokens, temp, top_p, seed,
                   speculative=spec)
        runs = {graphs: greedy_run(model, ids, px, new_tokens, temp, top_p,
                                   seed, cuda_graphs=graphs,
                                   speculative=spec)
                for graphs in (False, True)}
        eager, captured = runs[False][0], runs[True][0]
        if not np.array_equal(eager, captured):
            raise AssertionError(f"solo {tag}: captured tokens "
                                 f"{captured[0].tolist()} != eager "
                                 f"{eager[0].tolist()}")
        res[tag] = {("captured" if g else "eager"): dict(
            ttft_ms=r[1] * 1e3, decode_tok_s=(new_tokens - 1) / r[2])
            for g, r in runs.items()}
        log(f"solo {tag} ({card_line()}): captured and eager tokens equal; "
            f"decode {res[tag]['captured']['decode_tok_s']:.2f} tok/s "
            f"captured, {res[tag]['eager']['decode_tok_s']:.2f} eager")
    res["programs"] = [
        dict(program=f"{key[1]}{list(key[2:])}", seconds=got[-1].seconds,
             pool_bytes=got[-1].pool_bytes)
        for key, got in model._solo_caches.programs.items()]
    if not any(r["program"].startswith("verify") for r in res["programs"]):
        raise AssertionError("the speculative solo runs never verified a "
                             "draft through a captured verify program")
    log("solo programs captured: " + ", ".join(
        f"{r['program']} {r['seconds']:.2f} s {r['pool_bytes'] / 2**20:.0f} "
        f"MiB" for r in res["programs"]))
    return res


def profile_decode(model, seed: int, steps: int = 8,
                   cuda_graphs: bool = True):
    """torch.profiler over `steps` greedy decode steps of the served model
    as the solo path runs them (`make_scan_decode` one step at a time over
    a solo cache; captured programs unless cuda_graphs=False): host wall
    time per step, device kernel time per step (so the device's busy
    share) and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from competesmoe_tpu_torch.models.llava import (_prefill, _solo_caches,
                                                    make_scan_decode)

    rng = np.random.default_rng(seed)
    vocab = model.cfg.decoder.vocab_size
    ids = rng.integers(3, vocab, (1, 32))
    solo = _solo_caches(model)
    cache = solo.take(model, 1, 128)
    step = make_scan_decode(model, 1, cuda_graphs=cuda_graphs)
    try:
        last, _ = _prefill(model, ids, None, np.ones_like(ids), 128, cache)
        tok = last.argmax(-1)
        for _ in range(2):                     # warm-up (and capture)
            tok = step(tok, cache)[0][:, 0]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = step(tok, cache)[0][:, 0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        solo.give_back(cache)
    what = "captured" if cuda_graphs else "eager"
    return _busy(prof, wall, steps, f"decode ({what})")


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
SMALL_M = {"quant_small_m_matmul_int4": ("K5", (1, 8, 32, 40, 128),
                                         (2, 3, 9, 17, 33, 64)),
           "small_m_matmul": ("K3", (1, 8, 32), (2, 3, 17)),
           "quant_small_m_matmul": ("K4", (1, 8, 32, 40, 128),
                                    (3, 9, 17, 33, 64))}


def _small_m_operands(name, g, m, k, n):
    """x and the weight arguments of K5 (nibble-packed int4 [K/2, N]
    holding every nibble value, -8 and 7 too, and an f32 scale), K3 (the
    [K, N] view of a contiguous [N, K] bf16 matrix, as the decoder passes
    weight.t()) or K4 (int8 [K, N] holding every int8 value, -128 too, and
    an f32 scale)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import pack_int4
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    if name == "small_m_matmul":
        wt = torch.randn(n, k, generator=g, device="cuda").to(torch.bfloat16)
        return x, (wt.t(),)
    int4 = name == "quant_small_m_matmul_int4"
    q = torch.randint(-8 if int4 else -128, 8 if int4 else 128, (k, n),
                      generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    if int4:
        q.view(-1)[:16] = torch.arange(-8, 8, device="cuda").to(torch.int8)
    else:
        q.view(-1)[:256] = torch.arange(-128, 128, device="cuda").to(
            torch.int8)
        q[:, -1] = minus_128_column(x[0])
    scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
    return x, (pack_int4(q) if int4 else q, scale)


def minus_128_column(x0):
    """An int8 weight column that makes -128 count for x's row `x0`: -128
    where x0 > 0, -127 elsewhere. Its product with x0 mostly cancels,
    while the -128 entries alone carry about 0.4 K x0's weight, so a
    kernel that reads -128 as anything else is off by many times the
    one-ulp tolerance there (read as -127: 2^-7 of its own output
    elsewhere, never more)."""
    import torch
    return torch.where(x0 > 0, -128, -127).to(torch.int8)


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


# K quantization group of the K5 yardstick torch._weight_int4pack_mm
INT4PACK_GROUP = 128


def int4pack_operands(w_packed, scale):
    """K5's operands as torch._weight_int4pack_mm's: the unsigned nibbles
    v + 8 of W^T [N, K] in pairs (even k in the high nibble), converted by
    torch._convert_weight_to_int4pack, and for every group of
    INT4PACK_GROUP rows of K the column's scale (bf16) with zero 0. The
    library dequantizes (u - 8) * scale + zero = v * scale in bf16 and
    multiplies with float32 accumulation: JAX's non-kernel int4 formula
    (the weights times the scale in bf16, then the product)."""
    import torch

    from competesmoe_tpu_torch.ops.matvec import unpack_int4_halves
    lo, hi = unpack_int4_halves(w_packed)
    u = (torch.cat([lo, hi]).to(torch.int32) + 8).t().contiguous()
    w4 = torch._convert_weight_to_int4pack(
        ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    groups = u.shape[1] // INT4PACK_GROUP
    s16 = scale.to(torch.bfloat16)[None, :].expand(groups, -1)
    return w4, torch.stack([s16, torch.zeros_like(s16)], dim=2).contiguous()


def _int4pack_mm():
    """torch._weight_int4pack_mm as a K5 yardstick (x, int4pack weights,
    group size, scales and zeros), or (None, why) where this torch lacks it
    on CUDA."""
    import torch
    fn = getattr(torch, "_weight_int4pack_mm", None)
    if fn is None or getattr(torch, "_convert_weight_to_int4pack",
                             None) is None:
        return None, "torch has no _weight_int4pack_mm"
    try:
        w4, sz = int4pack_operands(
            torch.zeros(128, 256, device="cuda", dtype=torch.int8),
            torch.ones(256, device="cuda"))
        fn(torch.zeros(8, 256, device="cuda", dtype=torch.bfloat16), w4,
           INT4PACK_GROUP, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"_weight_int4pack_mm on CUDA: {str(e).splitlines()[0]}"
    return fn, ""


def small_m_compare(name: str, g, m: int, k: int, n: int):
    """K5, K3 or K4 against its plain version on fresh operands:
    (max_abs_err, tol = 2^-7 * max|plain|, repeats, x, weight arguments);
    a wrong shape counts as an infinite error; `repeats`: a second run of
    the kernel gave the same bytes."""
    import torch

    from competesmoe_tpu_torch.ops import matvec
    x, w = _small_m_operands(name, g, m, k, n)
    got = getattr(matvec, name)(x, *w)
    again = getattr(matvec, name)(x, *w)
    want = getattr(matvec, name + "_reference")(x, *w)
    torch.cuda.synchronize()
    err, top = rel_err(got, want)
    if got.shape != want.shape:
        err = float("inf")
    repeats = torch.equal(got.view(torch.int16), again.view(torch.int16))
    return err, 2.0 ** -7 * top, repeats, x, w


def phase_small_m(reps: int = 60):
    """K5, K3 and K4 against their plain versions at the decode projection
    shapes, timed beside their bounds, plain versions and library calls
    (torch._weight_int4pack_mm for K5, torch.matmul for K3,
    torch._weight_int8pack_mm for K4; K5's is timed only where it agrees
    with the plain version within the kernel's tolerance); the launches
    rotate through 256 MB of weight copies, as decode reads its
    weights."""
    import torch

    from competesmoe_tpu_torch.ops import matvec

    g = torch.Generator(device="cuda").manual_seed(1234)
    int8pack, int8pack_why = _int8pack_mm()
    if int8pack is None:
        log(f"K4 library yardstick: n/a ({int8pack_why})")
    int4pack, int4pack_why = _int4pack_mm()
    if int4pack is None:
        log(f"K5 library yardstick: n/a ({int4pack_why})")
    rows, max_err = [], {name: 0.0 for name in SMALL_M}

    def check(name, m, k, n, label, timed):
        fn = getattr(matvec, name)
        ref = getattr(matvec, name + "_reference")
        err, tol, repeats, x, w = small_m_compare(name, g, m, k, n)
        tag = SMALL_M[name][0]
        if not err <= tol:
            raise AssertionError(f"{tag} {label} M={m}: max_abs_err {err} > "
                                 f"tol {tol}")
        if not repeats:
            raise AssertionError(f"{tag} {label} M={m}: a second run gave "
                                 "other bytes")
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
        elif tag == "K5" and int4pack is not None:
            lib_args = [(x, w4, INT4PACK_GROUP, sz) for w4, sz in
                        (int4pack_operands(c, w[1]) for c in copies)]
            lib_err, _ = rel_err(int4pack(*lib_args[0]), ref(x, *w))
            if lib_err <= tol:
                lib_ms = time_launches(int4pack, lib_args, reps)
            else:
                log(f"K5 library yardstick at {label} M={m}: n/a (differs "
                    f"from the plain version by {lib_err:.3g} > {tol:.3g})")
            del lib_args
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
    return rows, max_err, dict(K4=int8pack_why, K5=int4pack_why)


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
    """Records (batch, length) of every forward of a decoder while
    `active`: the forwards a phase must account for. One forward pre-hook
    a decoder, installed with its first recorder and kept, hands each
    forward to the recorders attached at that moment; a forward seen
    while a step is captured is handed over at each replay of the
    captured program instead (`on_replay`). So a recorder must exist on
    a decoder before its programs are captured: it sees the replays of
    every program captured since the decoder's first recorder."""

    def __init__(self, decoder):
        self.rows = []
        self.active = True
        self._recorders = decoder.__dict__.get("_forward_recorders")
        if self._recorders is None:
            self._recorders = decoder.__dict__["_forward_recorders"] = []
            decoder.register_forward_pre_hook(
                functools.partial(ForwardRows._hook, self._recorders),
                with_kwargs=True)
        self._recorders.append(self)

    @staticmethod
    def _hook(recorders, module, args, kwargs):
        from competesmoe_tpu_torch.utils.cuda_graph import on_replay
        x = args[0] if args and args[0] is not None else (
            kwargs.get("input_ids") if kwargs.get("input_ids") is not None
            else kwargs["inputs_embeds"])
        row = (int(x.shape[0]), int(x.shape[1]))

        def record():
            for rec in list(recorders):
                if rec.active:
                    rec.rows.append(row)
        if not on_replay(record):
            record()

    def remove(self):
        self.active = False
        if self in self._recorders:
            self._recorders.remove(self)


def matvec_launches(decoder, rows) -> int:
    """The K3/K4/K5 launches the forwards `rows` [(B, T)] must make: one
    per matvec projection (bf16 PallasDense: K3; int8 QuantDense with
    matvec_kernel: K4; int4 QuantDense: K5) and forward whose M = B*T its
    kernel takes."""
    from competesmoe_tpu_torch.models.decoder import PallasDense, QuantDense
    from competesmoe_tpu_torch.ops.matvec import (MAX_QUANT_M, MAX_SMALL_M,
                                                  small_m_viable,
                                                  small_m_viable_int4)
    n = 0
    for mod in decoder.modules():
        if isinstance(mod, PallasDense):
            k, out = mod.in_features, mod.out_features
            n += sum(small_m_viable(b * t, k, out, max_m=MAX_SMALL_M)
                     for b, t in rows)
        elif isinstance(mod, QuantDense) and mod.mode == "int4":
            n += sum(small_m_viable_int4(b * t, mod.in_features, mod.features)
                     for b, t in rows)
        elif isinstance(mod, QuantDense) and mod.matvec_kernel:
            n += sum(small_m_viable(b * t, mod.in_features, mod.features,
                                    max_m=MAX_QUANT_M) for b, t in rows)
    return n


# the kernel of each served kind's decode projections
SERVED_KERNEL = {"bf16": "small_m_matmul", "int8": "quant_small_m_matmul",
                 "int4": "quant_small_m_matmul_int4"}


def served_config(kind: str, small: bool):
    """The 5.1B configuration (or its small geometry) as served: 'bf16'
    with matvec_kernel (K3), 'int8' with matvec_kernel and an int8 KV cache
    (--load-8bit: K4) or 'int4' with an int8 KV cache (--load-4bit:
    K5)."""
    import torch

    from competesmoe_tpu_torch.models.builder import (HF_5P1B,
                                                      llava_config_from_hf)
    cfg = llava_config_from_hf(dict(HF_5P1B, **SMALL_HF) if small
                               else HF_5P1B, "llava_phi", torch.bfloat16)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, matvec_kernel=kind != "int4",
        kv_quant=None if kind == "bf16" else "int8"))


def build_served(kind: str, seed: int, device: str, small: bool = False):
    from competesmoe_tpu_torch.models.builder import (apply_load_4bit,
                                                      apply_load_8bit,
                                                      build_llava)
    model = build_llava(served_config(kind, small), seed=seed, device=device)
    return {"int8": apply_load_8bit, "int4": apply_load_4bit}.get(
        kind, lambda m: m)(model)


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
    """A small model of the served kind ('bf16' runs K3, 'int8' K4, 'int4'
    K5: SMALL_HF's projections tile each kernel) on the card against the
    same weights on the CPU: decode logits of a teacher-forced stream
    within 3% of their largest magnitude; the same 6 greedy requests
    through DecodeEngine(n_slots=4, spec_k=2) give equal streams, or,
    where they part, the CPU's top-2 margin at that step lies within 3%
    of the largest logit of the stream so far (`agree`); the card's
    K3/K4/K5 launches equal the count its forwards' shapes call for."""
    from competesmoe_tpu_torch.models.llava import LlavaModel
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    name = SERVED_KERNEL[kind]
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
    parted = [agree(cpu, rids, rpx, a, b, f"small {kind} engine request {i}")
              for i, ((rids, rpx), a, b) in enumerate(
                  zip(reqs, streams["card"], streams["cpu"]))]
    parted = [p for p in parted if p]
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


def phase_engine(kind: str, seed: int, new_tokens: int = 32, model=None):
    """The engine slice's main path at full width: CompeteSMoE-5.1B
    through DecodeEngine as the worker builds it. 'int8': --load-8bit,
    int8 KV, 8 slots, --speculative 4 (pipeline 1); 'int4': --load-4bit
    (`model`: the solo phase's), int8 KV, 8 slots, --speculative 4; 'bf16':
    8 slots, pipeline 2. 8 requests from threads at once (2 with an image;
    6 greedy, one at temperature 0.7, one at 0.7 with top_p 0.9), then 4
    more once a slot retires; `new_tokens` each."""
    import threading

    import torch

    from competesmoe_tpu_torch.serve.model_worker import make_engine

    name = SERVED_KERNEL[kind]
    spec = 0 if kind == "bf16" else 4
    t0 = time.perf_counter()
    if model is None:
        model = build_served(kind, seed, "cuda")
        torch.cuda.synchronize()
        log(f"engine {kind}: 5.1B built in {time.perf_counter() - t0:.1f} "
            f"s; device memory "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    L = model.cfg.decoder.num_hidden_layers
    vocab = model.cfg.decoder.vocab_size
    rng = np.random.default_rng(seed + 7)
    reqs = engine_requests(rng, vocab, 6, 2, 224)
    reqs += engine_requests(rng, vocab, 4, 0, 224)
    sampling = [(0.0, 1.0)] * 6 + [(0.7, 1.0), (0.7, 0.9)] + [(0.0, 1.0)] * 4
    order = [2, 0, 3, 1, 4, 5, 6, 7, 8, 9, 10, 11]  # images among the first

    engine = make_engine(model, 8, 512, speculative=spec, engine_pipeline=2)
    # the recorder exists before the captures (it sees their replays)
    fw = ForwardRows(model.language_model)
    fw.active = False
    # warm-up, as the worker's --engine-warmup 32: lazy inits, the first
    # kernel loads, and the captures of the engine's step programs
    w = engine.warmup(prompt_buckets=(32,))
    log(f"engine {kind}: warmup captured {w['captured']} in "
        f"{w['seconds']} s")
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
    fw.active = True
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
        stats=stats, captured=w["captured"])
    log(f"engine {kind} ({card_line()}): 12 requests, {n_tok} tokens in "
        f"{wall:.2f} s = {n_tok / wall:.1f} tok/s aggregate; TTFT p50 "
        f"{summary['ttft_p50_ms']:.1f} ms, max {ttft[-1] * 1e3:.1f} ms; "
        f"{len(ticks)} ticks ({summary['verify_ticks']} verify), "
        f"{stats.get('engine_spec_tokens_per_step', 'n/a')} tokens per "
        f"verify tick; {name} launches {counts[name]} = 4 x {L} x "
        f"{want // (4 * L)} viable forwards "
        f"({summary['launches_per_tick']:.1f} per tick); prefill rows "
        f"{summary['prefill_rows']}")
    return model, summary


# the sampling of phase_engine's 12 requests: 6 greedy, one at
# temperature 0.7, one at 0.7 with top_p 0.9, then 4 greedy
SAMPLING = [(0.0, 1.0)] * 6 + [(0.7, 1.0), (0.7, 0.9)] + [(0.0, 1.0)] * 4


def engine_vs_eager(model, kind: str, seed: int, new_tokens: int = 32):
    """phase_engine's 12 requests through two engines of this kind's
    flags (8 slots, max_len 512; int4 and int8 --speculative 4, bf16
    pipeline 2), stepped in this thread from the same seed after
    warmup(32): one replaying its captured programs, one eager
    (cuda_graphs=False). Every stream, greedy and sampled, must be equal
    token for token. Returns each side's tok/s, ticks and wall time; then
    one profiled replay of the captured plain step must show the kind's
    kernel 4 x 32 times."""
    import torch

    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    spec = 0 if kind == "bf16" else 4
    vocab = model.cfg.decoder.vocab_size
    L = model.cfg.decoder.num_hidden_layers
    rng = np.random.default_rng(seed + 7)
    reqs = engine_requests(rng, vocab, 6, 2, 224)
    reqs += engine_requests(rng, vocab, 4, 0, 224)
    res, streams = {}, {}
    for graphs in (False, True):
        engine = DecodeEngine(model, n_slots=8, max_len=512, spec_k=spec,
                              pipeline_depth=1 if spec else 2,
                              run_thread=False, cuda_graphs=graphs,
                              rng_seed=seed)
        engine.warmup(prompt_buckets=(32,))
        made = [engine._make_request(ids, px, max_new_tokens=new_tokens,
                                     temperature=t, top_p=p, eos_ids=[2])
                for (ids, px), (t, p) in zip(reqs, SAMPLING)]
        torch.cuda.synchronize()
        t0, ticks = time.perf_counter(), 0
        while not all(r.done for r in made) and ticks < 100 * new_tokens:
            engine._tick()
            ticks += 1
        engine._tick()                 # deliver what a pipeline holds
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        streams[graphs] = [list(r.emitted) for r in made]
        n = sum(len(x) for x in streams[graphs])
        side = "captured" if graphs else "eager"
        res[side] = dict(tokens=n, ticks=ticks, wall_s=wall, tok_s=n / wall)
        if graphs:
            fragment = {"bf16": "mm_bf16_kernel", "int8": "qmm8_kernel",
                        "int4": "qmm4_kernel"}[kind]
            per_replay = replay_kernel_count(engine._programs["step_plain"],
                                             fragment, 4 * L)
            if per_replay != 4 * L:
                raise AssertionError(f"engine {kind}: a profiled replay of "
                                     f"step_plain launched {fragment} "
                                     f"{per_replay} times, not 4 x {L}")
            res["programs"] = {name: dict(seconds=prog.seconds,
                                          pool_bytes=prog.pool_bytes)
                               for name, prog in engine._programs.items()}
            res[f"{fragment}_per_replay"] = per_replay
        engine.shutdown()
        del engine
        free_card()
    if streams[True] != streams[False]:
        bad = [i for i, (a, b) in enumerate(zip(streams[True],
                                                  streams[False])) if a != b]
        raise AssertionError(f"engine {kind}: captured streams differ from "
                             f"eager ones at requests {bad}")
    log(f"engine {kind} captured vs eager ({card_line()}): 12 streams equal "
        f"(2 sampled); {res['captured']['tok_s']:.1f} tok/s captured, "
        f"{res['eager']['tok_s']:.1f} eager ({res['captured']['ticks']} / "
        f"{res['eager']['ticks']} ticks); programs "
        + ", ".join(f"{k} {v['seconds']:.2f} s {v['pool_bytes'] / 2**20:.0f}"
                    f" MiB" for k, v in res["programs"].items()))
    return res


def small_captured_check(seed: int):
    """A small --load-4bit model (int8 KV; SMALL_HF's projections tile K5)
    on the card, captured programs against the eager path:
    1. DecodeEngine(n_slots=4, max_len=160) with spec_k 3, then with
       pipeline depth 2: 6 requests (greedy, temperature and nucleus rows;
       two admitted once slots retire) give equal streams captured and
       eager from the same seed, and the captured run's K5 launches equal
       4 x 2 x the viable forwards it recorded (replays included);
    2. stream_generate in SOLO_CASES (greedy and sampled, with and
       without 4 drafts verified a forward; a seeded generator), 16
       tokens of a repeating prompt: captured equal to eager;
    3. the windowed KV read at the decoder: prompts of 30-40 tokens in a
       256-slot cache, 6 greedy steps with attn_window 64 and without:
       equal tokens, logits within 3% of the largest (`logits_gap`)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    model = build_served("int4", seed, "cuda", small=True)
    L = model.cfg.decoder.num_hidden_layers
    vocab = model.cfg.decoder.vocab_size
    rng = np.random.default_rng(seed + 3)
    reqs = engine_requests(rng, vocab, 6, 0, 28, lengths=(10, 40))
    sampling = [(0.0, 1.0), (0.8, 1.0), (0.0, 1.0), (0.9, 0.8), (0.0, 1.0),
                (1.0, 1.0)]
    for opts in (dict(spec_k=3), dict(pipeline_depth=2)):
        streams = {}
        for graphs in (False, True):
            engine = DecodeEngine(model, n_slots=4, max_len=160,
                                  run_thread=False, cuda_graphs=graphs,
                                  rng_seed=seed, **opts)
            fw = ForwardRows(model.language_model)
            counts0 = read_counts()
            made = [engine._make_request(ids, px, max_new_tokens=12,
                                         temperature=t, top_p=p)
                    for (ids, px), (t, p) in zip(reqs, sampling)]
            for _ in range(600):
                if all(r.done for r in made):
                    break
                engine._tick()
            engine._tick()
            fw.remove()
            streams[graphs] = [list(r.emitted) for r in made]
            counts = {k: v - counts0[k] for k, v in read_counts().items()}
            want = matvec_launches(model.language_model, fw.rows)
            if graphs and (counts["quant_small_m_matmul_int4"] != want
                           or sum(counts.values()) != want):
                raise AssertionError(f"small captured engine {opts}: "
                                     f"launches {counts}, K5 must be {want}"
                                     f" (4 x {L} x viable forwards)")
            engine.shutdown()
        if streams[True] != streams[False]:
            raise AssertionError(f"small captured engine {opts}: streams "
                                 f"{streams[True]} != eager "
                                 f"{streams[False]}")
    ids = reqs[0][0][None]                    # a repeating phrase
    for _, temp, top_p, spec in SOLO_CASES:
        runs = [greedy_run(model, ids, None, 16, temp, top_p, seed,
                           cuda_graphs=graphs, speculative=spec)[0]
                for graphs in (False, True, True)]
        if not all(np.array_equal(r, runs[0]) for r in runs):
            raise AssertionError(f"small captured solo (temperature {temp},"
                                 f" top_p {top_p}, speculative {spec}): "
                                 f"{runs}")
    lm = model.language_model
    lens = rng.integers(30, 41, 2)
    x = np.zeros((2, int(lens.max())), np.int64)
    mask = np.zeros_like(x)
    for i, n in enumerate(lens):
        x[i, :n] = rng.integers(3, vocab, n)
        mask[i, :n] = 1
    runs = {}
    with torch.no_grad():
        for window in (None, 64):
            cache = KVCache.create(lm.cfg, 2, 256, "cuda")
            logits, cache, _ = lm(torch.as_tensor(x, device="cuda"),
                                  attention_mask=torch.as_tensor(
                                      mask, device="cuda"), cache=cache)
            tok = logits[torch.arange(2, device="cuda"),
                         torch.as_tensor(lens - 1, device="cuda")].argmax(-1)
            rows, toks = [], []
            for _ in range(6):
                logits, cache, _ = lm(tok[:, None], cache=cache,
                                      attn_window=window)
                rows.append(logits[:, 0].float().cpu())
                tok = logits[:, 0].argmax(-1)
                toks.append(tok.cpu())
            runs[window] = (torch.stack(toks), torch.stack(rows))
    gap, tol = logits_gap(runs[64][1], runs[None][1])
    if not torch.equal(runs[64][0], runs[None][0]) or not gap <= tol:
        raise AssertionError(f"small windowed decode: tokens "
                             f"{runs[64][0].tolist()} vs "
                             f"{runs[None][0].tolist()}, logits gap {gap} "
                             f"(3%: {tol})")
    log(f"small captured check (card, int4, 2 layers): engine streams "
        f"equal captured and eager (spec_k 3; pipeline 2), K5 launches "
        f"through replays as the forwards need; solo streams (greedy, "
        f"sampled, speculative) equal; windowed decode tokens equal, "
        f"logits gap {gap:.4g} (3%: {tol:.4g})")
    del model
    free_card()
    return dict(window_logits_gap=gap, window_tol=tol)


# the decoder's windowed KV read at the 5.1B geometry (JAX's
# tools/bench_decode.py --window): rows, cache slots, live prompt lengths
WINDOW_AB = dict(rows=8, max_len=2048, lengths=(290, 311))


def phase_window(model, seed: int, reps: int = 20):
    """JAX's `tools/bench_decode.py --window` A/B on the card, at the
    decoder of `model` (the served --load-4bit --kv-quant int8 5.1B): 8
    rows of a 2048-slot cache hold about 300 live positions (prompts of
    290-310 tokens); one greedy decode step is captured twice, reading
    the whole cache and with attn_window = the live prefix plus the step,
    rounded up to 128. Each replay repeats the same step (the cache's pos
    is not advanced), timed on the device (median of `reps` replays),
    with the kernels of one profiled replay (total and copy kernels). The
    tokens must be equal and the logits within 3% of the largest."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache
    from competesmoe_tpu_torch.utils.cuda_graph import capture

    lm = model.language_model
    vocab = model.cfg.decoder.vocab_size
    rng = np.random.default_rng(seed + 13)
    B = WINDOW_AB["rows"]
    lens = rng.integers(*WINDOW_AB["lengths"], B)
    x = np.zeros((B, int(lens.max())), np.int64)
    mask = np.zeros_like(x)
    for i, n in enumerate(lens):
        x[i, :n] = rng.integers(3, vocab, n)
        mask[i, :n] = 1
    window = -(-(int(lens.max()) + 1) // 128) * 128
    cache = KVCache.create(lm.cfg, B, WINDOW_AB["max_len"], "cuda")
    with torch.no_grad():
        logits, cache, _ = lm(torch.as_tensor(x, device="cuda"),
                              attention_mask=torch.as_tensor(mask,
                                                             device="cuda"),
                              cache=cache)
        cur = logits[torch.arange(B, device="cuda"),
                     cache.pos - 1].argmax(-1)
    res, outs = dict(card=card_line(), rows=B, max_len=cache.max_len,
                     live=lens.tolist(), window=window), {}
    for name, win in (("full", None), ("window", window)):
        def step(win=win):
            with torch.no_grad():
                out, _, _ = lm(cur[:, None], cache=cache, attn_window=win)
            return out[:, 0].argmax(-1), out[:, 0].float()

        program = capture(step)
        program()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            program()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        kernels = replay_kernels(program)
        outs[name] = [t.clone().cpu() for t in program.outputs]
        res[name] = dict(
            ms=statistics.median(s.elapsed_time(e) for s, e in pairs),
            kernel_ms=sum(us for _, us in kernels.values()) / 1e3,
            copy_ms=sum(us for k, (_, us) in kernels.items()
                        if "copy_kernel" in k) / 1e3,
            capture_s=program.seconds, pool_bytes=program.pool_bytes)
        del program
    gap, tol = logits_gap(outs["window"][1], outs["full"][1])
    res.update(tokens_equal=bool(torch.equal(outs["window"][0],
                                             outs["full"][0])),
               logits_gap=gap, logits_tol=tol)
    log(f"window A/B ({res['card']}): int4 decode step, {B} rows, cache "
        f"{cache.max_len}, live {int(lens.min())}-{int(lens.max())}: "
        f"{res['full']['ms']:.3f} ms reading the whole cache "
        f"({res['full']['copy_ms']:.3f} ms of copies), "
        f"{res['window']['ms']:.3f} ms with attn_window {window} "
        f"({res['window']['copy_ms']:.3f} ms of copies); tokens "
        f"{'equal' if res['tokens_equal'] else 'DIFFER'}, logits gap "
        f"{gap:.4g} (3%: {tol:.4g})")
    if not res["tokens_equal"] or not gap <= tol:
        raise AssertionError(f"window A/B: tokens {outs['window'][0]} vs "
                             f"{outs['full'][0]}, logits gap {gap} > {tol}")
    return res


def profile_engine(model, kind: str, seed: int, ticks: int = 8,
                   cuda_graphs: bool = True):
    """torch.profiler over `ticks` engine ticks of 8 live slots (driven in
    this thread; captured programs unless cuda_graphs=False): host wall
    time per tick, device kernel time per tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    spec = 0 if kind == "bf16" else 4
    engine = DecodeEngine(model, n_slots=8, max_len=512, spec_k=spec,
                          pipeline_depth=1 if spec else 2, run_thread=False,
                          cuda_graphs=cuda_graphs)
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
    what = "captured" if cuda_graphs else "eager"
    return _busy(prof, wall, ticks, f"engine {kind} ({what})",
                 ENGINE_GROUPS)


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


# ---------------------------------------------------------------------------
# The engine's features: prefix cache, chunked prefill, adaptive
# speculation, warmup, and the front ends over HTTP
# ---------------------------------------------------------------------------

# the worker's --engine-slots 8 --engine-max-len 2048 --speculative 4
# --spec-adaptive --engine-prefix-cache 4 --engine-prefill-chunk 128
FEATURES = dict(engine_slots=8, engine_max_len=2048, speculative=4,
                engine_pipeline=2, prefix_cache=4, prefill_chunk=128,
                spec_adaptive=True)
WARMUP_BUCKETS = (32, 128, 256)


def features_engine(model, **over):
    """The DecodeEngine the worker builds with FEATURES' flags (`over`
    replaces some of them), through make_engine."""
    from competesmoe_tpu_torch.serve.model_worker import make_engine
    return make_engine(model, **dict(FEATURES, **over))


def settle(engine):
    """Wait until the engine thread comes round to an idle tick: every
    forward of the requests it served has been launched."""
    engine._idle.clear()
    if not engine._idle.wait(timeout=60) or engine.error is not None:
        raise AssertionError(f"the engine did not come to rest: "
                             f"{engine.error!r}")


class MainPath:
    """A phase's main path when comparison runs interleave with it: each
    `window(engine)` sets every launch count to 0 as it opens and reads
    the counts as it closes (once `engine` is at rest), adding them up;
    the decoder's forwards are recorded only inside a window."""

    def __init__(self, decoder):
        self.counts = dict.fromkeys(read_counts(), 0)
        self.fw = ForwardRows(decoder)
        self.fw.active = False

    @contextlib.contextmanager
    def window(self, engine):
        reset_counts()
        self.fw.active = True
        try:
            yield
            settle(engine)
        finally:
            self.fw.active = False
            for k, v in read_counts().items():
                self.counts[k] += v


def padded_forward(model, ids, cache, width: int):
    """One forward of the text tokens `ids` continuing `cache`, padded to
    `width` rows with mask 0 (the pads write to the cache's dump slot),
    as the engine pads a chunk or a suffix; returns (the logits of the
    last real token, the cache)."""
    import torch

    dev = model.device
    x = np.zeros((1, width), np.int64)
    x[0, :len(ids)] = ids
    mask = (np.arange(width) < len(ids)).astype(np.int64)[None]
    with torch.no_grad():
        out = model(torch.as_tensor(x, device=dev), None,
                    attention_mask=torch.as_tensor(mask, device=dev),
                    cache=cache)
    return out.logits[0, len(ids) - 1].float().cpu(), out.cache


def chunked_first_logits(model, ids, chunk: int):
    """The next-token logits after a text prompt prefilled through the
    model's own KV cache (of the model's kind, sized to the prompt plus a
    dump slot) in forwards of `chunk` tokens, the last one padded: the
    route of the engine's chunked prefill (K5 at M `chunk`) without its
    staging row, slot and splice."""
    from competesmoe_tpu_torch.models.decoder import KVCache

    ids = np.asarray(ids, np.int64)
    cache = KVCache.create(model.language_model.cfg, 1, len(ids) + 1,
                           model.device)
    for i in range(0, len(ids), chunk):
        last, cache = padded_forward(model, ids[i:i + chunk], cache, chunk)
    return last


def parked_rows(engine, convs):
    """Copies of the parked rows of finished conversations [(prompt,
    answer)]: each found by the key prompt + answer[:-1] (the last token
    was never fed) and held to the length that key implies. Returns
    [(KVCache of the one row at that length, length)]."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache

    park, rows = engine._park, []
    for ids, answer in convs:
        key = tuple(int(t) for t in ids) + tuple(int(t) for t in answer[:-1])
        found = [i for i, m in enumerate(engine._park_meta)
                 if m is not None and m["ids"] == key]
        if len(found) != 1 or engine._park_meta[found[0]]["len"] != len(key):
            raise AssertionError(f"a conversation of {len(key)} tokens is "
                                 f"parked {len(found)} times, or at another "
                                 f"length")
        sl = slice(found[0], found[0] + 1)
        rows.append((KVCache(
            k=park.k[:, sl].clone(), v=park.v[:, sl].clone(),
            pos=torch.tensor([len(key)], device=park.k.device),
            k_scale=(None if park.k_scale is None
                     else park.k_scale[:, sl].clone()),
            v_scale=(None if park.v_scale is None
                     else park.v_scale[:, sl].clone())), len(key)))
    return rows


def continued_first_logits(model, row, n_parked: int, ids):
    """The next-token logits after `ids`, continued from a copy of its
    parked row (`n_parked` positions) by one forward of the suffix padded
    to a power of two of at least 32 rows: the route of the engine's
    unpark (K5, whose rows do not depend on the others of a launch)
    without its gather, group and splice."""
    suffix = np.asarray(ids[n_parked:], np.int64)
    width = max(32, 1 << (len(suffix) - 1).bit_length())
    return padded_forward(model, suffix, row, width)[0]


def reference_margin(model, ids, px, tokens):
    """(top-2 margin, tolerance) of the model's next-token logits after
    `ids` + `tokens`, from one forward through a KV cache of the model's
    own kind (int8 where it serves int8); the tolerance is 3% of the
    largest logit magnitude over the rows that predict the stream's
    tokens up to this one (the rule of the small engine checks: 3% of
    the largest magnitude over a stream's logit rows)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache

    dev = model.device
    full = np.concatenate([np.asarray(ids, np.int64),
                           np.asarray(tokens, np.int64)])[None]
    n_img = int(np.sum(full == -200))         # image sentinels
    length = full.shape[1] + n_img * (model.cfg.num_image_tokens - 1)
    cache = KVCache.create(model.language_model.cfg, 1, length + 1, dev)
    with torch.no_grad():
        rows = model(torch.as_tensor(full, device=dev),
                     None if px is None else torch.as_tensor(px, device=dev),
                     cache=cache).logits[0, -(len(tokens) + 1):].float()
    top2 = rows[-1].topk(2).values
    return float(top2[0] - top2[1]), 0.03 * float(rows.abs().max())


def agree(model, ids, px, got, want, what: str):
    """Two greedy streams of one prompt: None when equal; else they may
    part only where the reference stream's (`want`'s) top-2 margin lies
    within the logit tolerance (a near tie that a different kernel shape
    or tick kind may break either way). Returns the parting step, margin
    and tolerance, or raises."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if j is None:
        if len(got) != len(want):
            raise AssertionError(f"{what}: stream lengths {len(got)} != "
                                 f"{len(want)}")
        return None
    margin, tol = reference_margin(model, ids, px, want[:j])
    if margin > tol:
        raise AssertionError(f"{what}: the streams part at step {j} where "
                             f"the top-2 margin {margin:.4g} exceeds the "
                             f"tolerance {tol:.4g}")
    return dict(step=j, margin=margin, tol=tol)


def prompt_key(ids, px):
    return (np.asarray(ids, np.int32).tobytes(),
            None if px is None else np.asarray(px).tobytes())


def record_first_logits(engine):
    """Make `engine` record each admitted request's first-token logits
    (what `_insert` samples from) in `engine.first_logits`, by prompt and
    image; returns the engine."""
    engine.first_logits, pending = {}, []
    insert, emit = engine._insert, engine._emit_admission

    def recording_insert(rows, slots, last, temps, topps):
        pending.append(last.float().cpu())
        return insert(rows, slots, last, temps, topps)

    def recording_emit(toks, reqs):
        last = pending.pop()
        for i, r in enumerate(reqs):
            engine.first_logits[prompt_key(r.ids, r.pixel_values)] = last[i]
        return emit(toks, reqs)

    engine._insert, engine._emit_admission = recording_insert, recording_emit
    return engine


def first_logits(engine, ids, px=None):
    """One prompt's first-token logits as `engine` recorded them."""
    return engine.first_logits[prompt_key(ids, px)]


def logits_gap(got, want):
    """(max |got - want|, 3% of the largest |want|)."""
    return float((got - want).abs().max()), 0.03 * float(want.abs().max())


def hold_gaps(gaps, what: str):
    for i, (g, t) in enumerate(gaps):
        if not g <= t:
            raise AssertionError(f"{what} {i}: first-token logits differ by "
                                 f"{g:.4g} > {t:.4g} (3% of the largest)")


def timed_clients(engine, reqs, max_new: int, started=None):
    """Submit each (ids, px) from its own thread at once: per request its
    tokens, submit time and each token's arrival time (filled in as they
    come). `started`, when given, is set once every stream has its first
    token."""
    import threading

    out = [dict(tokens=[], t_sub=0.0, times=[]) for _ in reqs]

    def client(i):
        ids, px = reqs[i]
        o = out[i]
        o["t_sub"] = time.perf_counter()
        for tok in engine.submit(ids, px, max_new_tokens=max_new):
            o["times"].append(time.perf_counter())
            o["tokens"].append(tok)
            if started is not None and all(x["times"] for x in out):
                started.set()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    return threads, out


def join_clients(engine, threads, out, what: str):
    for th in threads:
        th.join(timeout=900)
    if engine.error is not None or any(th.is_alive() for th in threads):
        raise AssertionError(f"{what}: engine error {engine.error!r} or a "
                             f"client still waiting")
    return out


def ttfts_ms(out):
    return sorted((o["times"][0] - o["t_sub"]) * 1e3 for o in out)


def text_prompts(rng, vocab: int, n: int, lengths):
    return [(rng.integers(3, vocab, int(rng.integers(*lengths)))
             .astype(np.int32), None) for _ in range(n)]


def burst_ttft(engine, reqs, what):
    threads, out = timed_clients(engine, reqs, 16)
    out = join_clients(engine, threads, out, what)
    t = ttfts_ms(out)
    return dict(ttft_p50_ms=statistics.median(t), ttft_max_ms=t[-1])


def longest_gap_ms(engine, shorts, long_req, max_new_short: int,
                   what: str):
    """6 short streams decode; once each has its first token the long
    prompt is submitted. Returns (the long prompt's tokens, the longest
    gap between two tokens of a short stream while the long prompt waited
    for its first token, in ms, the long prompt's TTFT in ms)."""
    import threading

    started = threading.Event()
    threads, out = timed_clients(engine, shorts, max_new_short, started)
    if not started.wait(timeout=600):
        raise AssertionError(f"{what}: the short streams never started")
    lthreads, lout = timed_clients(engine, [long_req], 16)
    join_clients(engine, lthreads, lout, what)
    join_clients(engine, threads, out, what)
    t0, t1 = lout[0]["t_sub"], lout[0]["times"][0]
    gaps = [b - a for o in out for a, b in zip(o["times"], o["times"][1:])
            if b >= t0 and a <= t1]
    if not gaps:
        raise AssertionError(f"{what}: no short stream was live while the "
                             f"long prompt prefilled")
    return lout[0]["tokens"], max(gaps) * 1e3, (t1 - t0) * 1e3


def tick_cost(model, max_len: int, seed: int, ticks: int = 8,
              cuda_graphs: bool = True):
    """torch.profiler over `ticks` plain engine ticks with 8 live slots at
    `max_len` (each tick ends in its tokens' read, which waits for the
    device; captured programs unless cuda_graphs=False): host and
    device-kernel ms per tick, and the copy kernels' share (`_busy`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    engine = DecodeEngine(model, n_slots=8, max_len=max_len,
                          run_thread=False, cuda_graphs=cuda_graphs)
    rng = np.random.default_rng(seed)
    for ids, px in text_prompts(rng, model.cfg.decoder.vocab_size, 8,
                                (20, 40)):
        engine._make_request(ids, px, max_new_tokens=64)
    with torch.no_grad():
        for _ in range(3):
            engine._tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                engine._tick()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    engine.shutdown()
    what = "captured" if cuda_graphs else "eager"
    return _busy(prof, wall, ticks,
                 f"engine-tick (max_len {max_len}, {what})", COPY_GROUP)


def route_gap(model, seed: int):
    """Last-position logits of one 100-token prompt through the int4
    projections' two routes: alone (100 rows: K5) and as the first of two
    copies (200 rows: the plain formula, weights rounded to bf16 after
    the scale). Returns (max |K5 - plain|, 3% of the largest |plain|)."""
    import torch

    ids = np.random.default_rng(seed).integers(
        3, model.cfg.decoder.vocab_size, (1, 100))
    x = torch.as_tensor(ids, device=model.device)
    with torch.no_grad():
        one = model(x, None).logits[0, -1].float()
        two = model(x.repeat(2, 1), None).logits[0, -1].float()
    return float((one - two).abs().max()), 0.03 * float(two.abs().max())


def multiturn_check(model, engine, rng, path):
    """4 text conversations on `engine` (FEATURES' prefix cache; turn 1:
    150-250 tokens, 32 new; turn 2: turn 1, its answer and 40 new tokens,
    two conversations at a time, so each unpark is at most 2 x 64 rows),
    their traffic in windows of the main `path`: each conversation parked
    once at the length its key implies; 4 prefix-cache hits; turn 2's
    first-token logits within 3% of its parked row continued by the
    model's own forward (`continued_first_logits`); its tokens against an
    engine without a prefix cache (`agree`), whose first-token logits are
    printed beside. Returns the numbers."""
    import threading

    vocab = model.cfg.decoder.vocab_size
    turn1 = text_prompts(rng, vocab, 4, (150, 251))
    with path.window(engine):
        threads, out1 = timed_clients(engine, turn1, 32)
        out1 = join_clients(engine, threads, out1, "turn 1")
    turn2 = [(np.concatenate([ids, np.asarray(o["tokens"], np.int32),
                              rng.integers(3, vocab, 40).astype(np.int32)]),
              None) for (ids, _), o in zip(turn1, out1)]
    parked = parked_rows(engine, [(ids, o["tokens"])
                                  for (ids, _), o in zip(turn1, out1)])
    hits0 = engine.stats()["engine_prefix_cache_hits"]
    with path.window(engine):
        started = threading.Event()
        threads, out2 = timed_clients(engine, turn2[:2], 32, started)
        if not started.wait(timeout=600):
            raise AssertionError("turn 2: the first two never started")
        later, out2b = timed_clients(engine, turn2[2:], 32)
        out2 = (join_clients(engine, threads, out2, "turn 2")
                + join_clients(engine, later, out2b, "turn 2"))
    hits = engine.stats()["engine_prefix_cache_hits"] - hits0
    if hits != 4:
        raise AssertionError(f"multi-turn: {hits} prefix-cache hits, not 4")
    gaps = [logits_gap(first_logits(engine, ids),
                       continued_first_logits(model, row, n, ids))
            for (row, n), (ids, _) in zip(parked, turn2)]
    del parked
    hold_gaps(gaps, "turn 2 (against its parked row) of conversation")
    cold = record_first_logits(features_engine(model, prefix_cache=0))
    threads, ref2 = timed_clients(cold, turn2, 32)
    ref2 = join_clients(cold, threads, ref2, "turn 2 without the cache")
    cold_gaps = [logits_gap(first_logits(engine, ids),
                            first_logits(cold, ids))[0] for ids, _ in turn2]
    cold.shutdown()
    del cold
    free_card()
    parted = [agree(model, ids, None, o["tokens"], r["tokens"],
                    f"turn 2 of conversation {i}")
              for i, ((ids, _), o, r) in enumerate(zip(turn2, out2, ref2))]
    t_hit, t_cold = ttfts_ms(out2), ttfts_ms(ref2)
    res = dict(
        hits=hits, turn1_lengths=[len(i) for i, _ in turn1],
        turn2_lengths=[len(i) for i, _ in turn2],
        turn2_ttft_cache_ms=t_hit, turn2_ttft_no_cache_ms=t_cold,
        parted=[p for p in parted if p],
        first_logits_gap=[g for g, _ in gaps],
        first_logits_tol=[t for _, t in gaps],
        first_logits_gap_no_cache=cold_gaps)
    log(f"engine features: multi-turn {hits} prefix hits; turn-2 TTFT "
        f"p50 {statistics.median(t_hit):.1f} ms with the cache, "
        f"{statistics.median(t_cold):.1f} ms without (prompts "
        f"{res['turn2_lengths']} tokens); first-token logits "
        f"apart from their parked rows' continuation by "
        f"{[f'{g:.4g}' for g, _ in gaps]} (3% of the largest: "
        f"{[f'{t:.4g}' for _, t in gaps]}), from the engine without the "
        f"cache by {[f'{g:.4g}' for g in cold_gaps]}; streams equal "
        f"{sum(p is None for p in parted)}/4, parted "
        f"{res['parted']}")
    return res


def phase_engine_features(seed: int, model, profile: bool = False):
    """The serving slice's engine features on `model` (the 5.1B checkpoint
    loaded with --load-4bit --kv-quant int8), through engines built as
    the worker builds them with FEATURES' flags:
    1. warmup(WARMUP_BUCKETS): its programs and seconds; the TTFT of an
       8-request burst on a fresh engine without warmup, then on the
       warmed engine;
    2. multi-turn: 4 text conversations (turn 1: 150-250 tokens, 32 new;
       turn 2: turn 1, its answer and 40 new tokens, two conversations at
       a time): each parked once at the length its key implies, 4
       prefix-cache hits; turn 2's first-token logits against its parked
       row continued by the model's own forward, its tokens against an
       engine without a prefix cache, TTFT with and without;
    3. long prompt: a 1,536-token prompt (12 chunks of 128) submitted
       while 6 short streams decode: its first-token logits against the
       model's own cache filled in the same chunks, its tokens against an
       unchunked engine's, and the longest gap of a live stream with and
       without chunking;
    4. adaptive speculation: 8 repetitive and 8 random prompts, each mix
       on a fresh engine: tok/s and suppressed verify ticks (with
       `profile`, torch.profiler over each mix: its device busy share);
    5. the controller, a worker on the warmed engine and the OpenAI API
       over HTTP on 127.0.0.1: 3 chat completions (one streamed), their
       text against the engine's own output for the rendered prompts.
    First-token logits of a featured admission and its reference, which
    take the same projection route (K5, padded as the engine pads) from
    the same cache contents, agree within 3% of the reference's largest
    magnitude; against an engine without the feature they are printed
    only (its K/V of the answer came from chunks, not decode ticks, and
    a 32-layer model with random weights carries that difference to the
    logits). Streams
    of one prompt on two engines may part only where the top-2 margin is
    within the logit tolerance (`agree`). The main path is the FEATURES
    engines' own traffic (1 after the fresh engine, 2-5 without their
    references), read in windows (`MainPath`): K5 launches must equal 4 x
    32 x its viable forwards, K3 and K4 0."""
    vocab = model.cfg.decoder.vocab_size
    L = model.cfg.decoder.num_hidden_layers
    chunk = FEATURES["prefill_chunk"]
    rng = np.random.default_rng(seed + 11)
    res = dict(card=card_line(), flags=FEATURES)
    path = MainPath(model.language_model)
    t_phase = time.perf_counter()

    # 1. warmup, and a burst's TTFT without and with it
    burst = text_prompts(rng, vocab, 8, (100, 250))
    fresh = features_engine(model)
    res["burst_no_warmup"] = burst_ttft(fresh, burst, "burst (no warmup)")
    fresh.shutdown()
    del fresh
    free_card()
    engine = record_first_logits(features_engine(model))
    with path.window(engine):
        w = engine.warmup(prompt_buckets=WARMUP_BUCKETS)
        res["burst_after_warmup"] = burst_ttft(engine, burst,
                                               "burst (after warmup)")
    res["warmup"] = dict(programs=w["programs"], seconds=w["seconds"],
                         captured=w["captured"])
    log(f"engine features ({res['card']}): warmup "
        f"{len(w['programs'])} programs in {w['seconds']} s: "
        f"{w['programs']}; captured {w['captured']}")
    log(f"engine features: 8-request burst TTFT p50/max "
        f"{res['burst_no_warmup']['ttft_p50_ms']:.1f}/"
        f"{res['burst_no_warmup']['ttft_max_ms']:.1f} ms on a fresh engine "
        f"without warmup, {res['burst_after_warmup']['ttft_p50_ms']:.1f}/"
        f"{res['burst_after_warmup']['ttft_max_ms']:.1f} ms after warmup")

    # 2. multi-turn through the prefix cache
    res["multiturn"] = multiturn_check(model, engine, rng, path)

    # 3. a long prompt beside live streams, chunked and not
    shorts = text_prompts(rng, vocab, 6, (30, 61))
    long_req = (rng.integers(3, vocab, 1536).astype(np.int32), None)
    with path.window(engine):
        got, gap, ttft = longest_gap_ms(engine, shorts, long_req, 64,
                                        "long prompt (chunked)")
    lgap, ltol = logits_gap(first_logits(engine, long_req[0]),
                            chunked_first_logits(model, long_req[0], chunk))
    hold_gaps([(lgap, ltol)], "the long prompt")
    unchunked = record_first_logits(features_engine(model,
                                                    prefill_chunk=0))
    want, gap0, ttft0 = longest_gap_ms(unchunked, shorts, long_req, 64,
                                       "long prompt (unchunked)")
    ugap, _ = logits_gap(first_logits(engine, long_req[0]),
                         first_logits(unchunked, long_req[0]))
    unchunked.shutdown()
    del unchunked
    free_card()
    part = agree(model, long_req[0], None, got, want, "the long prompt")
    res["long_prompt"] = dict(
        tokens=1536, chunks=1536 // chunk,
        longest_gap_chunked_ms=gap, longest_gap_unchunked_ms=gap0,
        ttft_chunked_ms=ttft, ttft_unchunked_ms=ttft0, parted=part,
        first_logits_gap=lgap, first_logits_tol=ltol,
        first_logits_gap_unchunked=ugap)
    log(f"engine features: 1,536-token prompt beside 6 live streams: "
        f"longest gap of a live stream {gap:.1f} ms chunked (12 x 128), "
        f"{gap0:.1f} ms unchunked; its TTFT {ttft:.1f} / {ttft0:.1f} ms; "
        f"first-token logits apart from the chunked reference by "
        f"{lgap:.4g} (3%: {ltol:.4g}), from the unchunked engine (the "
        f"plain int4 formula) by {ugap:.4g}; tokens "
        f"{'equal' if part is None else f'parted {part}'}")

    # 4. adaptive speculation on two mixes
    res["adaptive"] = {}
    mixes = {"repetitive": engine_requests(rng, vocab, 8, 0, 224,
                                           lengths=(40, 120)),
             "random": text_prompts(rng, vocab, 8, (40, 120))}
    for mix, reqs in mixes.items():
        eng = features_engine(model)
        with path.window(eng), profiled(profile) as prof:
            t0 = time.perf_counter()
            threads, out = timed_clients(eng, reqs, 48)
            out = join_clients(eng, threads, out, f"{mix} mix")
            wall = time.perf_counter() - t0
        st = eng.stats()
        eng.shutdown()
        n = sum(len(o["tokens"]) for o in out)
        res["adaptive"][mix] = dict(
            tokens=n, wall_s=wall, tok_s=n / wall,
            suppressed_ticks=st["engine_spec_suppressed_ticks"],
            verify_calls=st["engine_spec_verify_calls"],
            tokens_per_verify=st["engine_spec_tokens_per_step"],
            tps_verify=st["engine_spec_tps_verify"],
            tps_plain=st["engine_spec_tps_plain"])
        if prof is not None:
            res["adaptive"][mix]["profile"] = _busy(
                prof, wall, 1, f"{mix} mix (the whole run)", ENGINE_GROUPS)
        log(f"engine features: {mix} mix, 8 x 48 tokens: "
            f"{n / wall:.1f} tok/s, {st['engine_spec_verify_calls']} "
            f"verify ticks ({st['engine_spec_tokens_per_step']} tokens "
            f"each), {st['engine_spec_suppressed_ticks']} suppressed")
    del eng
    free_card()
    if res["adaptive"]["random"]["suppressed_ticks"] == 0:
        raise AssertionError("the random mix suppressed no verify tick")

    # 5. the front ends over HTTP
    res["http"] = phase_frontends(model, engine, path)
    engine.shutdown()
    del engine
    free_card()
    counts, rows_fw = path.counts, path.fw.rows
    path.fw.remove()
    want_k5 = matvec_launches(model.language_model, rows_fw)
    if counts["quant_small_m_matmul_int4"] != want_k5 or \
            sum(counts.values()) != want_k5:
        raise AssertionError(f"engine features launches {counts}: K5 must "
                             f"be {want_k5} (4 x {L} x viable forwards), "
                             f"the others 0")
    rows = {}
    for b, t in rows_fw:
        rows[b * t] = rows.get(b * t, 0) + 1
    res.update(launches=want_k5, forwards=len(rows_fw),
               rows=dict(sorted(rows.items())),
               seconds=time.perf_counter() - t_phase)
    log(f"engine features: K5 launches on the main path {want_k5} = 4 x "
        f"{L} x {want_k5 // (4 * L)} viable forwards of {len(rows_fw)} (M: "
        f"{res['rows']}); phase {res['seconds']:.1f} s")
    res["tick"] = {f"{ml} {what}": tick_cost(model, ml, seed,
                                             cuda_graphs=what == "captured")
                   for ml in (512, 2048) for what in ("captured", "eager")}
    res["route_gap"] = route_gap(model, seed)
    log(f"engine features: a plain tick with 8 live slots: host "
        + ", ".join(f"{t['wall_ms_per_step']:.1f} ms with "
                    f"{t['device_ms_per_step']:.2f} ms of kernels "
                    f"({t['groups']['copy kernels']['ms_per_step']:.2f} ms "
                    f"of copies, {8e3 / t['wall_ms_per_step']:.1f} tok/s) "
                    f"at max_len {key}" for key, t in res["tick"].items())
        + f"; one prompt's logits through K5 (100 rows) and the plain "
        f"int4 formula (200 rows) apart by {res['route_gap'][0]:.4g} (3%: "
        f"{res['route_gap'][1]:.4g})")
    return res


def phase_frontends(model, engine, path):
    """The port's controller, a model worker on `engine` registered with
    it, and the OpenAI API, all on 127.0.0.1, with phase_server's stand-in
    tokenizer: 3 chat completions one after another (the second
    streamed), in a window of the main `path`. The worker's submissions
    are recorded: each completion's text must be its tokens' text, and
    its tokens must agree with the engine's own output for the rendered
    prompt, asked for after the HTTP requests (outside the window)
    through the same generate function."""
    from competesmoe_tpu_torch.eval.llava_adapter import TorchLlava
    from competesmoe_tpu_torch.serve.controller import serve_controller
    from competesmoe_tpu_torch.serve.model_worker import (ModelWorker,
                                                          engine_generate_fn,
                                                          serve_worker)
    from competesmoe_tpu_torch.serve.openai_api import (_render_prompt,
                                                        serve_openai_api)

    tok = WordTok(model.cfg.decoder.vocab_size)
    adapter = TorchLlava(model, tok, max_new_tokens=16)
    submitted, submit = [], engine.submit

    def recording_submit(ids, *args, **kwargs):
        toks = []
        submitted.append((np.asarray(ids), toks))
        for t in submit(ids, *args, **kwargs):
            toks.append(t)
            yield t

    engine.submit = recording_submit
    gen_fn = engine_generate_fn(adapter, engine)
    ports = []
    for _ in range(3):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    caddr = f"http://127.0.0.1:{ports[0]}"
    _, chttpd = serve_controller("127.0.0.1", ports[0], background=True)
    worker = ModelWorker(caddr, f"http://127.0.0.1:{ports[1]}", ["smoke"],
                         gen_fn, register=True)
    whttpd = serve_worker(worker, "127.0.0.1", ports[1], background=True)
    ohttpd = serve_openai_api(caddr, "127.0.0.1", ports[2],
                              background=True)
    api = f"http://127.0.0.1:{ports[2]}/v1/chat/completions"
    chats = [[{"role": "user", "content": "what color is the cat"}],
             [{"role": "system", "content": "answer briefly"},
              {"role": "user", "content": "describe the image please"}],
             [{"role": "user", "content": "hello there"},
              {"role": "assistant", "content": "hello how are you"},
              {"role": "user", "content": "tell me a story"}]]
    for messages in chats:
        # every word gets its id now: a later first sight would change
        # how an emitted id decodes between the HTTP and the direct text
        tok(_render_prompt("phi35", messages)[0])
    texts, seconds = [], []
    try:
        with path.window(engine):
            for i, messages in enumerate(chats):
                body = {"model": "smoke", "messages": messages,
                        "max_tokens": 16, "temperature": 0.0,
                        "stream": i == 1}
                t0 = time.perf_counter()
                req = urlrequest.Request(
                    api, data=json.dumps(body).encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                with urlrequest.urlopen(req, timeout=300) as r:
                    raw = r.read().decode()
                seconds.append(time.perf_counter() - t0)
                if i == 1:
                    text = ""
                    lines = [x[6:] for x in raw.splitlines()
                             if x.startswith("data: ")]
                    if lines[-1] != "[DONE]":
                        raise AssertionError(f"SSE stream without [DONE]: "
                                             f"{raw[-200:]!r}")
                    for payload in lines[:-1]:
                        ch = json.loads(payload)
                        if "error" in ch:
                            raise AssertionError(f"SSE error {ch}")
                        text += ch["choices"][0]["delta"].get("content", "")
                else:
                    text = json.loads(raw)["choices"][0]["message"]["content"]
                texts.append(text)
    finally:
        for h in (ohttpd, whttpd, chttpd):
            h.shutdown()
            h.server_close()
    if len(submitted) != 3:
        raise AssertionError(f"the worker made {len(submitted)} engine "
                             f"submissions for 3 completions")
    rows = []
    for i, messages in enumerate(chats):
        prompt, images, stop = _render_prompt("phi35", messages)
        params = {"prompt": prompt, "images": images, "max_new_tokens": 16,
                  "temperature": 0.0, "stop": [stop]}
        want_text = list(gen_fn(params))[-1]
        ids, got = submitted[i]
        _, want = submitted[3 + i]
        if list(ids) != adapter.tokenizer_ids_for_prompt(prompt, False):
            raise AssertionError(f"completion {i}: the worker's prompt is "
                                 f"not the rendered template's")
        part = agree(model, ids, None, got, want, f"completion {i}")
        if part is None and texts[i] != want_text:
            raise AssertionError(f"completion {i}: HTTP text "
                                 f"{texts[i]!r} != the engine's "
                                 f"{want_text!r}")
        rows.append(dict(chars=len(texts[i]), tokens=len(got),
                         seconds=seconds[i], equal=texts[i] == want_text,
                         parted=part))
    engine.submit = submit
    log(f"engine features: 3 chat completions over HTTP (controller, "
        f"worker, OpenAI API; one streamed) in "
        f"{', '.join(f'{s:.2f}' for s in seconds)} s; equal to the "
        f"engine's own text: {[r['equal'] for r in rows]}")
    return rows


def small_engine_features_check(seed: int, device: str = "cuda"):
    """The engine's features on a small int4 model (SMALL_HF; K5 at every
    projection whose rows it takes) on the card, against engines without
    them on the card: each request's first-token logits within 3% of the
    plain admission's largest magnitude, and where streams part, the CPU
    model's top-2 margin after the reference stream within the same
    tolerance:
    - chunked prefill (chunk 16) of three prompts whose last chunk is
      partial (40, 45 and 61 tokens) beside two short streams, against
      grouped admission;
    - the prefix cache (4 slots): three text conversations and one with
      an image, whose turn 2 each hit, against cold admission; the image
      conversation's turn 2 with another image, admitted beside them,
      must not hit, and its tokens must be a cold engine's for that
      image.
    Catches an unpark suffix written at the wrong position, a chunk's
    logits taken at a pad slot and a park key without the pixel hash
    (chip_faults.py)."""
    from competesmoe_tpu_torch.models.llava import LlavaModel
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    cpu = build_served("int4", seed, "cpu", small=True)
    gpu = LlavaModel(cpu.cfg, device=device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed + 5)
    px = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)
    px_other = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)

    def engine(n_slots=4, **kw):
        return record_first_logits(DecodeEngine(
            gpu, n_slots=n_slots, max_len=256, spec_k=2, run_thread=False,
            **kw))

    def check(reqs, got, want, what, featured, plain):
        """First-token logits within 3% of the plain admission's largest
        magnitude, then the streams."""
        for i, (ids, p) in enumerate(reqs):
            err, tol = logits_gap(first_logits(featured, ids, p),
                                  first_logits(plain, ids, p))
            if not err <= tol:
                raise AssertionError(f"{what} {i}: first-token logits "
                                     f"differ by {err:.4g} > {tol:.4g}")
        for i, ((ids, p), a, b) in enumerate(zip(reqs, got, want)):
            agree(cpu, ids, p, a, b, f"{what} {i}")

    chunked = ([(rng.integers(3, 512, n).astype(np.int32), None)
                for n in (40, 45, 61)]
               + [(rng.integers(3, 512, n).astype(np.int32), None)
                  for n in (7, 12)])
    featured, plain = engine(prefill_chunk=16), engine()
    check(chunked, drive_ticks(featured, chunked, 10),
          drive_ticks(plain, chunked, 10), "chunked prefill", featured,
          plain)

    turn1 = [(rng.integers(3, 512, n).astype(np.int32), None)
             for n in (20, 33, 9)]
    img = rng.integers(3, 512, 12).astype(np.int32)
    img[2] = -200
    turn1.append((img, px))
    parked = engine(n_slots=5, prefix_cache_slots=4)
    out1 = drive_ticks(parked, turn1, 6)
    turn2 = [(np.concatenate([ids, np.asarray(o, np.int32),
                              rng.integers(3, 512, 5).astype(np.int32)]), p)
             for (ids, p), o in zip(turn1, out1)]
    # the image conversation's turn 2 with another image, admitted with
    # the others while every turn-1 row is still parked
    turn2.append((turn2[3][0], px_other))
    got = drive_ticks(parked, turn2, 8)
    hits = parked.stats()["engine_prefix_cache_hits"]
    if hits != 4:
        raise AssertionError(f"prefix cache: {hits} hits for 4 follow-ups "
                             f"and one with another image (must be 4)")
    plain = engine()
    check(turn2, got, drive_ticks(plain, turn2, 8), "unpark", parked, plain)
    log("small engine features (card, int4, chunk 16 and 4 park slots "
        "against engines without them): passed")


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

    t_main = time.perf_counter()
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
    small_rows, small_err, library_why = phase_small_m()
    print("kernel_shapes " + json.dumps({
        "card": card, "rows": small_rows,
        "k4_library": library_why["K4"] or "torch._weight_int8pack_mm",
        "k5_library": library_why["K5"] or "torch._weight_int4pack_mm"}),
        flush=True)
    k1 = phase_k1(a.seed)
    k1_bwd = phase_k1_bwd(a.seed)
    k2 = phase_k2(a.seed)
    router_weights_check(a.seed)
    small_lm = small_lm_check()
    task, lm = phase_lm(a.seed)
    if a.profile:
        lm["profile"] = profile_train(task)
    del task
    free_card()
    lm["routers"] = {}
    for name in ROUTER_SWEEPS:
        task, lm["routers"][name] = phase_router(name, a.seed)
        del task
        free_card()
    lm["small_lm"] = small_lm
    print("lm_summary " + json.dumps(dict(lm, card=card)), flush=True)
    small_model_check(a.seed)
    small = [small_engine_check("int4", a.seed)]
    small_engine_features_check(a.seed)
    graphs = dict(card=card, small=small_captured_check(a.seed))
    model, want_tokens = phase_checkpoint(a.seed)
    k5_launches, summary = phase_model(a.seed, model, want_tokens)
    graphs["solo"] = solo_vs_eager(model, a.seed)
    phase_server(model)
    if a.profile:
        summary["profile"] = {
            what: profile_decode(model, a.seed,
                                 cuda_graphs=what == "captured")
            for what in ("captured", "eager")}
    print("model_summary " + json.dumps(dict(summary, card=card)),
          flush=True)
    # the same int4 model through the engine: K5 at M 8, 40 and prefill
    # groups
    engines = {}
    _, engines["int4"] = phase_engine("int4", a.seed, model=model)
    graphs["engine_int4"] = engine_vs_eager(model, "int4", a.seed)
    if a.profile:
        engines["int4"]["profile"] = {
            what: profile_engine(model, "int4", a.seed,
                                 cuda_graphs=what == "captured")
            for what in ("captured", "eager")}
    # the same model through the engine's features
    features = phase_engine_features(a.seed, model, a.profile)
    print("engine_features_summary " + json.dumps(features), flush=True)
    graphs["window"] = phase_window(model, a.seed)
    del model
    free_card()
    small += [small_engine_check(kind, a.seed) for kind in ("bf16", "int8")]
    for kind in ("int8", "bf16"):
        model, engines[kind] = phase_engine(kind, a.seed)
        if kind == "int8":
            phase_engine_server(model)
        graphs[f"engine_{kind}"] = engine_vs_eager(model, kind, a.seed)
        if a.profile:
            engines[kind]["profile"] = {
                what: profile_engine(model, kind, a.seed,
                                     cuda_graphs=what == "captured")
                for what in ("captured", "eager")}
        del model
        free_card()
    print("engine_summary " + json.dumps(dict(small=small, card=card,
                                              **engines)), flush=True)
    print("graphs_summary " + json.dumps(graphs), flush=True)
    rows = [small_m_summary(small_rows, name, launches, small_err[name], m)
            for name, launches, m in (
                ("quant_small_m_matmul_int4",
                 k5_launches + engines["int4"]["launches"]
                 + features["launches"], 1),
                ("small_m_matmul", engines["bf16"]["launches"], 8),
                ("quant_small_m_matmul", engines["int8"]["launches"], 8))]
    for row in [k1, k1_bwd["gmm2_bwd_dx"], k1_bwd["gmm2_bwd_dw"]] + [
            k2[n] for n in ("flash_attention_fwd",
                                       "flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq")]:
        rows.append(dict(name=row["name"],
                         launches=lm["launches"][row["name"]],
                         max_abs_err=row["max_abs_err"], ms=row["ms"],
                         plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                         bound_by=row["bound_by"],
                         library_ms=row["library_ms"]))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_main:.1f} s")
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
