#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (competesmoe_tpu_torch).

    python3 chip_smoke.py [--seed 0] [--profile]
                          [--only lm_rest|parallel|sharded]

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
       runs give the same bytes); at the 154M layer one backward under
       torch.cuda.set_sync_debug_mode("error") (no host synchronisation);
       timed at the 154M layer beside their plain versions, their bounds
       and torch._grouped_mm on the same products, then again under
       balanced routing (K1_BALANCED, printed only);
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
     all 16 layers of every step (ms/step, tokens/s, peak memory); each
     of the three cells then takes two more steps under torch.profiler
     (`profile_cell`, printed only: K1's backward kernels' ms a step, the
     steps' ms and losses, and `profile_train`'s busy share and kernels);
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
 11. with --profile: torch.profiler over decode steps of the
     served model and over engine ticks, captured and eager (with K3's,
     K4's or K5's share; device busy share and the kernels that take the
     time), over 9's two speculation mixes, and over the last step of 12;
 12. multimodal training (main path of the multimodal training slice),
     after the card is freed: a small model (SMALL_HF, bf16) takes 3 sft
     steps on the card and on the CPU from the same weights and batch,
     with 8-bit moments and 1 microbatch, then bf16 moments and 2
     (SMALL_MM_RUNS), the CPU taking the card's top-k choices; losses and
     grad norms within SMALL_MM_LOSS_TOL and SMALL_MM_GRAD_TOL, routerloss
     > 0 exactly on the competing layers; probes of the step's parts
     (`mm_probes`: microbatch scaling, per-group clipping, 8-bit moments,
     labels over image blocks); a resume through cli.train_mm.train equal
     bit for bit to an uninterrupted run; then CompeteSMoE-5.1B at full
     width and depth, random bf16 weights from --seed, through
     cli.train_mm.train with the sft recipe's flags (MM_FULL_FLAGS: rows
     of 2048, grad-accum 2, remat, 8-bit moments) for MM_STEPS steps of
     MM_BATCH rows on a stated schedule, then MM_LORA_STEPS LoRA steps:
     per step wall ms, tokens/s, losses, grad_norm, the competing layers
     and their routerloss, peak GiB; every number finite, the three
     parameter groups move, and no launch of K1-K5 (none lies on the
     path; `mm_train_summary` line).
 13. evaluation (main path of the eval slice), through cli/eval_mm.run
     with a word-level stand-in tokenizer (EvalTok) and seeded arrays in
     place of decoded images (ArrayImage: the card machine has no PIL):
     before 6, `small_eval_check` writes a small --load-4bit model as a
     checkpoint that the CLI loads on the card and on the CPU, and runs
     generate_until solo and engine-backed, loglikelihood,
     --return-id-experts and a two-rank --merge-dir merge on both (answers
     card vs CPU and engine vs solo under the parting rule of 8,
     loglikelihoods within 3% of the CPU's and against the model's own
     label splice, telemetry against the router's recomputed choices, the
     merge equal to the single run; chip_faults.py plants six faults
     against it); after 10, on 6's loaded 5.1B model, `phase_eval`: 48
     POPE-shaped documents with 224 px images (POPE's prompt, 16 new
     tokens, exact_match) through solo batch 1 with --speculative 4 (the
     reference answers), solo batch 4, --engine-slots 8 and solo batch 4
     with --return-id-experts, and 32 yes/no loglikelihood documents (half
     text-only) at batch 8; answers against the reference's under the
     parting rule, telemetry on every tower layer and the projector,
     loglikelihoods against the label splice, K5 launches = 4 x 32 x the
     forwards whose rows it takes (`eval_summary` line).
 14. the decoder's options and the CLIP tower (main paths of the options
     slice): after 3, K5 at the Mistral-7B and MPT-7B projection shapes
     (M 1 and 8) beside its bound and torch._weight_int4pack_mm
     (`k5_new_shapes` line); before 6, `small_options_check` (a small
     CLIP + windowed GQA model's cache path against its no-cache path
     and the CPU, a small MPT against an ALiBi forward written apart and
     its deferred decode against its no-cache forward, int4 on the card
     against the CPU, folded copies against their originals, per-layer
     and deferred engines against the stacked engine through parks and
     unparks, w8a8's int32 products against exact ones;
     chip_faults.py plants six faults against it). 6's checkpoint
     carries Phi-3.5-mini's published sliding_window 262144 in its
     config.json (the served tokens equal the writer's, which has none).
     After 13, on 6's loaded 5.1B: solo captured runs with deferred
     decode and with a per-layer cache (tokens equal the default's), 12
     requests through a per-layer and a stacked int4 engine (equal
     streams), fold_norm_scales on a copy and w8a8 on the bf16 weights
     as --load-8bit's int8 model (parting from int4 and int8 only under
     the parting rule) (`options_summary` line); the full-size
     loglikelihood bound settled in float32 (`eval_bound_summary`);
     then a CuMo-class LLaVA at full width (HF_CUMO: the CLIP-ViT-L/14-336
     tower with MoE MLPs, the MoE projector, Mistral-7B's config.json
     with sliding_window 4096) written as a checkpoint in the
     reference's layout, loaded with --load-4bit --kv-quant int8, a
     336 px image prompt solo (K5 7 x 32 a decode step) and a
     5,000-token prompt through an engine of 8 slots, 8192 positions and
     chunks of 128 beside 3 image streams (first-token logits against
     the no-cache windowed forward, tokens against solo stream_generate;
     `cumo_summary`); then MPT-7B at full width through export_mpt and
     convert_mpt, int4, a 512-token prompt and 32 greedy steps (K5 4 x
     32 a step), with and without deferred decode (`mpt_summary`).
     After the small option checks, `small_routers_check`: each router
     of MM_ROUTERS and Mixtral's block as a layer against its definition
     written apart (`router_definition`), then a small LLaVA per router
     and a small Mixtral-decoder LLaVA on the card against the CPU (the
     CPU replaying the card's top-k choices): logits within 3%, one sft
     step's loss within 5e-3 and grad_norm within 0.2%, the routing
     telemetry against its selections, and for Mixtral 8 captured decode
     tokens equal to eager ones (chip_faults.py plants five faults
     against it). After the 5.1B sft (`mm_train_summary`), the 5.1B with
     each of the five routers through cli.train_mm.train (a warm-up and
     2 timed sft steps, 4 x 2048 rows, remat, grad-accum 2, 8-bit
     moments; `smoe_sigmoidgating` written as a checkpoint naming it and
     loaded back first) and a telemetry forward (`mm_routers_summary`).
     After MPT, the CLIP + Mixtral-8x7B cell (HF_CUMO_MIXTRAL, 12 of 32
     layers) written layer by layer, loaded with --load-4bit --kv-quant
     int8 (experts bf16), a 336 px image prompt solo (K5 4 x 12 a decode
     step; a profiled replay shows qmm4_kernel 48 times) and 12 requests
     through an 8-slot engine of 2048 positions, captured beside eager
     (`mixtral_summary`).
 15. the rest of the LM stack (main path of the LM-options slice), last
     (`phase_lm_rest`; `--only lm_rest` runs it alone after the build):
     the small LM of 4 with each option of SMALL_REST_CASES (MoA with its
     four expert banks and a v size of its own, ACT with 3 ponder steps,
     the XL carry over two windows, layer drop at p 0 and 1, remat) takes
     3 steps on the card and on the CPU from the same weights (the CPU
     replaying the card's top-k choices, MoA's banks too): losses within
     SMALL_LM_LOSS_TOL, grad norms within SMALL_LM_GRAD_TOL, launches by
     `small_rest_launches` (K2 0 on MoA), remat equal to no remat bit for
     bit; the XL carry's second window against one forward over both
     windows (`xl_consistency_check`); a small task's validation
     telemetry against its routers' recomputed selections; K2 at the
     battery's bucket lengths T 127 and 1023 against its plain version,
     timed beside it (K2_BATTERY_SHAPES). Then the 154M sweep field for
     field through its own task, slimpajama_transformer, over 8 jsonl.gz
     shards written from the seed (vocab from 2), 6 steps with
     validation at step 3, the async logger, -log tb and a profiler trace
     of step 4, then test() with the zero-shot battery over hellaswag-,
     piqa-, ai2arc- and lambada-format files of 64 documents (K1 and K2
     launches per step, in validation and in the battery as `_lm_want`
     says; the telemetry against the routers), then with -moe.att.enable 1
     (in two microbatches: MoA's dense attention does not fit the card at
     one) and with -remat 1, 4 steps each (K2 0 under MoA; remat launches
     every forward kernel twice, its step-0 loss equal to the plain run's
     and its peak memory lower) (`lm_rest_summary` line).
 16. parallel training (main path of the parallelism slice), before 15
     (`phase_parallel`; `--only parallel` runs it alone after the build):
     ranks are processes on this one card over gloo (NCCL refuses two
     ranks on a device; gloo moves CUDA tensors through host memory), each
     rank's compute on the card. 2 ranks: the small LM of 4 with
     -n_expert_shards 2 (expert parallel, K1 as the local compute) and
     with -moe.impl fused (the banks gathered at use), Mixtral's balance
     over both ranks' rows, sharded 8-bit Adam (one shard cut would split
     a block), the 154M sweep (SWEEP_154M at PAR_154M_BATCH rows) for
     PAR_154M_STEPS steps three ways (PAR_154M_RUNS: expert parallel;
     gathered experts; FSDP over 'data'), and cli.train_mm.train with
     --n-expert 2 on small_mm_config; 4 ranks: the small LM 2 x 2 (expert
     + data parallel), then with -fsdp -fsdp.min_size 1024. Each against
     one process on the card taking the ranks' top-k choices (the small
     LM's and small mm's tolerances and replay rule; the parameters after
     3 steps within PAR_PARAM_TOL of the update); every rank launches K1
     and its backward kernels 16 - the competing layers a 154M step and
     each K2 kernel 16 (per rank: ms a step, tokens/s, peak GiB, bytes
     through each collective a step); then NCCL at one rank runs each
     collective the port uses (`parallel_summary` line).
 17. sharded serving and sequence parallelism (main path of the second
     parallelism slice), after 16 (`phase_sharded`; `--only sharded` runs
     it alone after the build), 2 ranks on this card over gloo: K3 at each
     rank's shard of the 5.1B's decode projections (TP_SHARD_SHAPES, M 1
     and 4) against
     its plain version, timed beside its bound and torch.matmul; then one
     process on the card makes the references; then the ranks run (a) the
     model worker with --mesh 1x2 --engine-slots 4 (build_serving, eager:
     gloo collectives cannot be captured) over the 5.1B at full width,
     bf16 (K3 on each shard) and --load-4bit (K5, quantized projections
     replicated): three HTTP answers from rank 0, tokens equal to one
     process's engine or parting only under the parting rule, a profiled
     decode step of each rank with 4 x 32 kernel launches; cli/eval_mm
     --mesh 1x2 on a few documents; (b) the --ep-shards 2 placement on
     the int4 5.1B with image prompts (the tower's all-to-all at prefill)
     and on HF_CUMO_MIXTRAL cut to 4 layers (all-to-all every step),
     towers and projectors in float32, through the engine, against one process whose MoE layers take the
     grouped path (tokens under the parting rule at 3%, each image's
     projector output within EP_FEATURE_TOL); (c) the 154M sweep with
     -n_seq_shards 2 for SEQ_154M_STEPS steps: losses within
     SMALL_LM_LOSS_TOL and grad norms within SMALL_LM_GRAD_TOL of one
     process's (flash attention), K1 and its backward launched, K2 not
     (the ring replaces it). tokens/s, ms a step and the
     bytes through each collective (`sharded_summary` line). NCCL across
     cards is written and unrun.
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
# and the planted faults that this rule catches 0.031 or more (dW's gather
# skipping a row's last 16 bytes; the others 0.088 or more; chip_faults.py);
# one wrong 64 x 128 tile of dkeys at the 154M layer is 2e-3
K1_BWD_OFF_SHARE = 1e-4
# K1's backward timed a second time at the 154M layer, printed only: routing
# that favours no expert (no bias on the gate logits, no empty expert)
K1_BALANCED = dict(K1_SHAPE, balanced=True)
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
    groups with 4 empty experts as `k1_inputs`, or, with `balanced` in the
    shape, gate logits without a bias, or, with `counts` in the shape,
    exactly counts[e] rows for expert e (k 1)."""
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
        if not shape.get("balanced"):
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


def k1_bwd_args(x, sel, w, keys, values, g):
    """The two backward kernels' operands over the forward's layout: (dX's
    arguments, dW's arguments with hr and dh from one dX launch, the
    layout, the forward's bf16 keys and values)."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    k = sel.shape[-1]
    _, lay, _, k16, v16 = gf._forward(x, sel, w, keys, values)
    slot, aoff, gsize = lay.slot_padded, lay.aoff, lay.gsize
    wflat = w.to(torch.bfloat16).reshape(-1).contiguous()
    xs = x[lay.tok_padded]
    dx_args = (xs, g, slot, wflat, k16, v16, lay.tile_expert, aoff, gsize, k)
    _, hr, dh = gf.gmm2_bwd_dx(*dx_args)
    dw_args = (xs, hr, dh, g, slot, wflat, lay.tile_expert, aoff, gsize, k)
    return dx_args, dw_args, lay, k16, v16


def k1_bwd_sync_free(x, sel, w, keys, values, g):
    """One call of the backward on the card (`fused_grouped_ffn_kv_bwd`)
    under torch.cuda.set_sync_debug_mode("error"): raises if anything in
    it makes the host wait for the card."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    _, lay, gathered, k16, v16 = gf._forward(x, sel, w, keys, values)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gf.fused_grouped_ffn_kv_bwd(x, sel, w, lay, gathered, k16, v16, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_k1_bwd(seed: int, reps: int = 20):
    """K1's two backward kernels against the plain backward, on the edge
    groups and the check shapes, then at the 154M layer shape, where the
    backward must not synchronise with the host and each kernel is timed
    (CUDA-graph replays) beside its plain version, its bound and
    torch._grouped_mm on its products; then both kernels are timed again
    under balanced routing (K1_BALANCED, printed only)."""
    import torch

    from competesmoe_tpu_torch.ops import gmm_fused as gf

    for label, rows in k1_bwd_checks(seed):
        _log_bwd_rows(label, rows)
    D, E, ES, k = (K1_SHAPE[n] for n in ("D", "E", "ES", "k"))
    x, sel, w, keys, values, g = k1_bwd_inputs(seed, K1_SHAPE)
    rows = k1_bwd_compare(x, sel, w, keys, values, g)
    _log_bwd_rows("the 154M layer", rows)
    k1_bwd_sync_free(x, sel, w, keys, values, g)
    log("K1 backward at the 154M layer under set_sync_debug_mode('error'): "
        "no host synchronisation")
    err = {r["tensor"]: r["max_abs_err"] for r in rows}
    dx_args, dw_args, lay, k16, v16 = k1_bwd_args(x, sel, w, keys, values, g)
    xs, _, slot, wflat, _, _, _, aoff, gsize, _ = dx_args
    _, hr, dh = dw_args[:3]
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
            f"{bound_ms / ms:.1%} of bound"
            + ("" if lib is None else f"  {ms / lib:.3f} x _grouped_mm"))
    del dx_args, dw_args, lay, xs, hr, dh
    dx_args, dw_args, _, _, _ = k1_bwd_args(*k1_bwd_inputs(seed, K1_BALANCED))
    gsize = dx_args[8]
    for name, fn, args in (("gmm2_bwd_dx", gf.gmm2_bwd_dx, dx_args),
                           ("gmm2_bwd_dw", gf.gmm2_bwd_dw, dw_args)):
        out[name]["balanced_ms"] = time_launches(fn, [args] * 4, reps)
        log(f"K1 backward {name} under balanced routing (groups "
            f"{int(gsize.min())}..{int(gsize.max())} rows): kernel "
            f"{out[name]['balanced_ms'] * 1e3:.1f} us (printed only)")
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


def profile_cell(task, name: str):
    """Printed only: `profile_train` over two more steps of a training
    cell, with K1's backward kernels' device ms a step, the profiled
    steps' wall ms and their losses (the run's log)."""
    prof = profile_train(task)
    log_path = REPO / "runs" / "chip_smoke" / f"lm154m_{name}" \
        / "log_trainer.jsonl"
    recs = [json.loads(line)
            for line in log_path.read_text().splitlines()][-2:]
    k1b = {label: prof["groups"][label]["ms_per_step"]
           for label in ("K1 backward dX", "K1 backward dW (both passes)")}
    prof["steps"] = [dict(step=r["step"], loss=r["loss/total"],
                          ms=r["timing/ms_per_step_wall"]) for r in recs]
    log(f"lm {name} profiled steps {[r['step'] for r in recs]}: K1 "
        f"backward dX {k1b['K1 backward dX']:.3f} ms/step, dW "
        f"{k1b['K1 backward dW (both passes)']:.3f} ms/step; losses "
        f"{[round(r['loss/total'], 4) for r in recs]}; "
        f"{[round(r['timing/ms_per_step_wall'], 1) for r in recs]} ms "
        f"(printed only)")
    return prof


# kernel-name fragments whose device time a profile sums by label
TRAIN_GROUPS = {"K2 backward (dK/dV + dQ)": ("flash_bwd_dkv_kernel",
                                             "flash_bwd_dq_kernel"),
                "K2 forward": ("flash_fwd_kernel",),
                "K1 (without its weight casts)": ("gmm2_kernel",),
                "K1 backward (dX + dW)": ("gmm2_bwd_dx_kernel",
                                          "gmm2_bwd_dw_kernel",
                                          "gmm2_bwd_dw_sum_kernel"),
                "K1 backward dX": ("gmm2_bwd_dx_kernel",),
                "K1 backward dW (both passes)": ("gmm2_bwd_dw_kernel",
                                                 "gmm2_bwd_dw_sum_kernel")}
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

    logits, fed = {}, None
    for key, model in (("card", card), ("cpu", cpu)):
        logits[key], fed = logit_rows(model, seed, fed)
    err = float((logits["card"] - logits["cpu"]).abs().max())
    if not torch.isfinite(logits["card"]).all():
        err = float("inf")
    return err, 0.03 * float(logits["cpu"].abs().max())


def logit_rows(model, seed: int, fed=None):
    """`card_vs_cpu_logits`' run on one model: (the 5 logit rows [5, V] on
    the CPU, the 4 tokens fed, `fed` when given, else its greedy ones)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, (1, 12))
    ids[0, 3] = -200
    px = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
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
    return torch.stack(rows), feed


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
# microsoft/Phi-3.5-mini-instruct's config.json
PHI35_SLIDING_WINDOW = 262144


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
        # Phi-3.5-mini's published config.json carries sliding_window
        # 262144, and a LLaVA config written from it keeps the field
        path = save_hf_checkpoint(writer, cfg, ckpt, hf_config=dict(
            HF_5P1B, sliding_window=PHI35_SLIDING_WINDOW))
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
        windowless = dataclasses.replace(model.cfg, decoder=dataclasses.replace(
            model.cfg.decoder, sliding_window=None))
        if bad or windowless != writer.cfg or \
                model.cfg.decoder.sliding_window != PHI35_SLIDING_WINDOW:
            raise AssertionError(f"--load-4bit: {len(bad)} tensors differ "
                                 f"from the quantized writer's: {bad[:6]}, "
                                 f"or the config {model.cfg.decoder}")
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
                                     "qmm4_kernel", 4 * L,
                                     "the solo decode step")
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


# cycles of the spin kernel (torch.cuda._sleep, about 10 ms at the H100's
# clock) run before and after a profiled replay, inside the window
REPLAY_PAD_CYCLES = 20_000_000
# tiny spin kernels that open a profiled window, and the host's wait for
# the profiler to record before any of them
REPLAY_LEAD_IN = 256
REPLAY_HOST_WAIT_S = 0.05


def replay_kernels(program):
    """{kernel name: (launches, device µs)} of one replay of the captured
    `program`, from the device records torch.profiler holds, counted one
    by one. On the card the profiler has dropped the first device records
    of a window (a replay's first K3 launch, with the spin kernel before
    it, whatever the spin's length) and `key_averages` has dropped one of
    a replay's 128 K4 records that `events` held (an engine's check read
    127 of 128 that way, run after run): so the host waits for
    the profiler to record, a lead-in of tiny spin kernels opens the
    window, and the replay runs between two spin kernels of about 10 ms;
    spin kernels are left out of the result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(REPLAY_HOST_WAIT_S)
        for _ in range(REPLAY_LEAD_IN):
            torch.cuda._sleep(100)
        torch.cuda._sleep(REPLAY_PAD_CYCLES)
        program()
        torch.cuda._sleep(REPLAY_PAD_CYCLES)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in ev.name):
            count, us = out.get(ev.name, (0, 0.0))
            out[ev.name] = (count + 1, us + ev.time_range.elapsed_us())
    return out


def replay_kernel_count(program, fragment: str, want: int, what: str) -> int:
    """`want`, once a profiled replay of the captured `program` shows
    exactly `want` launches of kernels whose names hold `fragment`. The
    profiler now and then loses kernel records of a replay (95 of 128
    once; 127 of 128 in three profiles running once, before the replay
    was padded), so a replay that shows fewer is profiled again, up to 5
    times; a replay cannot launch fewer nodes than it captured, and more
    is never retried. Raises, naming `what` and every reading, when no
    profile shows `want`."""
    seen = []
    for _ in range(5):
        seen.append(sum(c for key, (c, _) in replay_kernels(program).items()
                        if fragment in key))
        if seen[-1] >= want:
            break
    if seen[-1] != want:
        raise AssertionError(f"{what}: profiled replays launched {fragment} "
                             f"{seen} times, not {want}")
    return want


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


def phase_small_m(reps: int = 60, kernels=None, shapes=DECODE_SHAPES):
    """K5, K3 and K4 (or `kernels`, entries of SMALL_M's form) against
    their plain versions at the decode projection `shapes`, timed beside
    their bounds, plain versions and library calls
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
    kernels = kernels or SMALL_M
    rows, max_err = [], {name: 0.0 for name in kernels}

    def check(name, m, k, n, label, timed):
        fn = getattr(matvec, name)
        ref = getattr(matvec, name + "_reference")
        err, tol, repeats, x, w = small_m_compare(name, g, m, k, n)
        tag = kernels[name][0]
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

    for name, (_, timed_m, check_m) in kernels.items():
        for label, k, n in shapes:
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
                                             fragment, 4 * L,
                                             f"engine {kind} step_plain")
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


def reference_margin(model, ids, px, tokens, share: float = 0.03):
    """(top-2 margin, tolerance) of the model's next-token logits after
    `ids` + `tokens`, from one forward through a KV cache of the model's
    own kind (int8 where it serves int8); the tolerance is `share` (3%)
    of the largest logit magnitude over the rows that predict the
    stream's tokens up to this one (the rule of the small engine checks:
    3% of the largest magnitude over a stream's logit rows)."""
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
    return float(top2[0] - top2[1]), share * float(rows.abs().max())


def agree(model, ids, px, got, want, what: str, share: float = 0.03):
    """Two greedy streams of one prompt: None when equal; else they may
    part only where the reference stream's (`want`'s) top-2 margin lies
    within the logit tolerance (`share` of the largest logit magnitude: a
    near tie that a different kernel shape or tick kind may break either
    way). Returns the parting step, margin and tolerance, or raises."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if j is None:
        if len(got) != len(want):
            raise AssertionError(f"{what}: stream lengths {len(got)} != "
                                 f"{len(want)}")
        return None
    margin, tol = reference_margin(model, ids, px, want[:j], share)
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


# ---------------------------------------------------------------------------
# Multimodal training (main path of the multimodal training slice)
# ---------------------------------------------------------------------------

# The 5.1B sft run, as cli/train_mm takes it: the recipe's flags
# (scripts/train/phi35mini/siglip/sft.sh: stage sft, 4 experts top-2,
# lr 4e-6, warmup 0.03, rows padded to 2048) with --grad-accum 2 --bf16
# --remat --opt-state-8bit, at MM_BATCH rows a step (the recipe's 5 rows do
# not split into 2 microbatches), for MM_STEPS steps. The schedule is
# stated, not the recipe's: MM_STEPS steps in all (the LR's cosine and the
# flip schedule span them), rate_flip 0.5 with up to 28 competing layers a
# step (the 27 tower layers and the projector), schedule seed MM_SEED; it
# makes 13, 11, 13 and 14 tower layers compete on steps 0-3 and the
# projector on steps 0, 1 and 3.
MM_BATCH = 4
MM_STEPS = 4
MM_SEED = 3
MM_LORA_STEPS = 2
MM_FULL_FLAGS = (
    "--stage sft --model-max-length 2048 --grad-accum 2 --bf16 --remat "
    "--opt-state-8bit --learning-rate 4e-6 --warmup-ratio 0.03 "
    "--rate-flip 0.5 --max-compete-in-iter 28 --save-interval 0 "
    "--log-interval 1").split()
# small multimodal model, card against CPU per step (bf16 weights): |loss
# gap| (absolute) and |grad_norm gap| / grad_norm, a few times the largest
# honest gaps chip_faults.py reads over seeds 0-4 (PERF.md); the CPU takes
# the card's top-k choices (`routed_as`): at most SMALL_MM_FLIP_SHARE of
# the rows may be ones where the CPU's own scores pick another set, each
# within SMALL_MM_FLIP_GAP of its own k-th best
SMALL_MM_LOSS_TOL = 5e-3
SMALL_MM_GRAD_TOL = 5e-3
SMALL_MM_FLIP_SHARE = 0.08
SMALL_MM_FLIP_GAP = 2.0 ** -5
# (8-bit moments, microbatches) of the small card-vs-CPU runs
SMALL_MM_RUNS = ((True, 1), (False, 2))


class ChatTok(WordTok):
    """WordTok with a BOS (id 1) before every encoding and chat markers
    (<|user|>, <|end|>, ...) as words of their own, the properties of the
    Phi-3.5 tokenizer that preprocess_phi35's round arithmetic relies on;
    pad id 0."""

    bos_token_id = 1
    pad_token_id = 0
    _WORDS = __import__("re").compile(r"<\|[a-z]+\|>|\S+?(?=<\|)|\S+")

    def __call__(self, text):
        ids = [1] + self.__class__.__bases__[0].__call__(
            self, " ".join(self._WORDS.findall(text))).input_ids
        return type("Enc", (), {"input_ids": ids})()


class MMConversations:
    """LLaVA-format conversations from a seed, tokenized by the dataset's
    own preprocessor (`preprocess_phi35`) with `tok` (a ChatTok): rows
    with an image
    carry seeded pixels in [-1, 1] (the processor's range), every
    `text_every`-th row has none. The dataset protocol `cli.train_mm.train`
    takes: `__len__`, `__getitem__`, `modality_lengths`."""

    def __init__(self, tok, n: int, words: tuple, image_size: int,
                 seed: int, max_len: int, text_every: int = 3):
        rng = np.random.default_rng(seed)
        vocab = [f"w{i}" for i in range(400)]
        self.tok, self.max_len, self.size = tok, max_len, image_size
        self.seed = seed
        self.records = []
        for i in range(n):
            def say(lo, hi):
                return " ".join(rng.choice(vocab, int(rng.integers(lo, hi))))
            image = i % text_every != text_every - 1
            conv = [{"from": "human",
                     "value": ("<image>\n" if image else "") + say(*words)},
                    {"from": "gpt", "value": say(*words)},
                    {"from": "human", "value": say(*words)},
                    {"from": "gpt", "value": say(*words)}]
            self.records.append((conv, image))

    def __len__(self):
        return len(self.records)

    @property
    def modality_lengths(self):
        return [sum(len(c["value"].split()) for c in conv) * (1 if im else -1)
                for conv, im in self.records]

    def __getitem__(self, i):
        from competesmoe_tpu_torch.data.mm_data import preprocess_phi35
        conv, image = self.records[i]
        d = preprocess_phi35([conv], self.tok, has_image=image,
                             model_max_length=self.max_len)
        out = {"input_ids": d["input_ids"][0], "labels": d["labels"][0]}
        if image:
            rng = np.random.default_rng((self.seed, i))
            out["image"] = rng.uniform(
                -1, 1, (self.size, self.size, 3)).astype(np.float32)
        return out


def mm_args(flags, out_dir):
    from competesmoe_tpu_torch.cli.train_mm import build_argparser
    return build_argparser().parse_args(list(flags)
                                        + ["--output-dir", str(out_dir)])


def small_mm_config():
    import torch

    from competesmoe_tpu_torch.models.builder import (HF_5P1B,
                                                      llava_config_from_hf)
    return llava_config_from_hf(dict(HF_5P1B, **SMALL_HF), "llava_phi",
                                torch.bfloat16)


def small_mm_batch(seed: int, vocab: int = 512, rows: int = 4,
                   length: int = 40):
    """Rows alternate image (sentinel at 2) and text-only (a zero image, as
    the collator pads one), so the two halves of the batch hold as many
    supervised labels each; the first 4 labels of a row are masked."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (rows, length)).astype(np.int64)
    labels = ids.copy()
    labels[:, :4] = -100
    px = rng.uniform(-1, 1, (rows, 28, 28, 3)).astype(np.float32)
    for r in range(0, rows, 2):
        ids[r, 2] = -200
        labels[r, 2] = -100
        px[r + 1] = 0.0
    return {"input_ids": ids, "labels": labels,
            "attention_mask": np.ones((rows, length), np.int64),
            "images": px}


def small_mm_steps(model, state_8bit: bool, n_micro: int, batch,
                   steps: int = 3):
    """`steps` sft steps of mm_task's step on `model`'s device from step
    0: each step's metrics as floats (per-layer ones as lists)."""
    from competesmoe_tpu_torch.train.mm_task import (
        MMTrainConfig, MMTrainState, batch_to, build_mm_schedules,
        make_mm_optimizer, make_mm_train_step)
    tcfg = MMTrainConfig(stage="sft", learning_rate=1e-3, warmup_ratio=0.0,
                         total_steps=10, rate_flip=0.5,
                         max_compete_in_iter=3, schedule_seed=1,
                         opt_state_8bit=state_8bit)
    model.set_flip_schedules(*build_mm_schedules(model.cfg, tcfg))
    opt = make_mm_optimizer(tcfg)
    state = MMTrainState.create(model, opt)
    step = make_mm_train_step(model, opt, n_microbatch=n_micro)
    rows = []
    for _ in range(steps):
        state, m = step(state, batch_to(batch, model.device))
        rows.append({k: (v.tolist() if v.numel() > 1 else float(v))
                     for k, v in m.items()})
    return rows


def _competed(row):
    return [li for li, c in enumerate(row["vision/is_comp"]) if c] + (
        ["projector"] if row["projector/is_comp"] else [])


def _routerloss_on_flips(row, what: str):
    """routerloss > 0 exactly on the layers that competed."""
    rl = list(row["vision/routerloss"]) + [row["projector/routerloss"]]
    comp = list(row["vision/is_comp"]) + [row["projector/is_comp"]]
    if [r > 0 for r in rl] != [c > 0 for c in comp]:
        raise AssertionError(f"{what}: routerloss {rl} where the layers "
                             f"competed {comp}")


def small_mm_card_vs_cpu(seed: int):
    """A small multimodal model (SMALL_HF, bf16) takes 3 sft steps on the
    card and on the CPU from the same weights and batch, for each of
    SMALL_MM_RUNS; the CPU takes the card's top-k choices. Returns the
    per-step gaps."""
    import torch

    from competesmoe_tpu_torch.models.builder import build_llava
    from competesmoe_tpu_torch.models.llava import LlavaModel

    cfg = small_mm_config()
    cpu0 = build_llava(cfg, seed=seed, device="cpu")
    init = {k: v.clone() for k, v in cpu0.state_dict().items()}
    batch = small_mm_batch(seed)
    out = []
    for state_8bit, n_micro in SMALL_MM_RUNS:
        what = f"small mm train (8-bit {state_8bit}, accum {n_micro})"
        card = LlavaModel(cfg, device="cuda")
        card.load_state_dict(init)
        cpu = LlavaModel(cfg, device="cpu")
        cpu.load_state_dict(init)
        choices = []
        with routed_as(record=choices):
            got = small_mm_steps(card, state_8bit, n_micro, batch)
        with routed_as(replay=choices) as seen:
            want = small_mm_steps(cpu, state_8bit, n_micro, batch)
        share = seen["flipped"] / seen["rows"]
        for i, (g, c) in enumerate(zip(got, want)):
            _routerloss_on_flips(g, f"{what} card step {i}")
            dl = abs(g["loss/total"] - c["loss/total"])
            dg = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
            ok = (dl <= SMALL_MM_LOSS_TOL and dg <= SMALL_MM_GRAD_TOL
                  and _competed(g) == _competed(c)
                  and math.isfinite(g["loss/total"]))
            log(f"{what} step {i} (competed {_competed(g)}): loss card "
                f"{g['loss/total']:.6f} cpu {c['loss/total']:.6f} (gap "
                f"{dl:.3g}, tol {SMALL_MM_LOSS_TOL}); grad_norm card "
                f"{g['grad_norm']:.6f} cpu {c['grad_norm']:.6f} (gap "
                f"{dg:.3g}, tol {SMALL_MM_GRAD_TOL})")
            out.append(dict(run=what, step=i, competed=_competed(g),
                            loss_gap=dl, grad_gap=dg, ok=ok,
                            topk_share=share, topk_gap=seen["gap"]))
            if not ok:
                raise AssertionError(f"{what} step {i}: card and CPU "
                                     f"disagree: {out[-1]}")
        log(f"{what}: the CPU would have picked another top-k set in "
            f"{seen['flipped']} of {seen['rows']} rows ({share:.3%}, limit "
            f"{SMALL_MM_FLIP_SHARE:.0%}), score gap {seen['gap']:.3g} "
            f"(limit {SMALL_MM_FLIP_GAP:.3g})")
        if not (share <= SMALL_MM_FLIP_SHARE
                and seen["gap"] <= SMALL_MM_FLIP_GAP):
            raise AssertionError(f"{what}: top-k choices part on {share:.3%}"
                                 f" of the rows, gap {seen['gap']:.3g}")
        if not any(_competed(g) for g in got):
            raise AssertionError(f"{what}: no step competed")
        del card, cpu
        free_card()
    return out


def mm_probes(seed: int):
    """Checks of the training step's parts on the card, each against its
    definition: (1) microbatches: a batch of two halves with as many
    supervised labels each gives grad_norm within 5% with 1 and with 2
    microbatches (the mean of the halves' gradients); (2) the optimizer
    clips each group by its own norm: with eps 1e6 the first update is
    -lr * clipped g / 1e6, held to g * min(1, 1 / |g_group|) per group;
    (3) 8-bit moments: quantize-dequantize of nu is within half a code of
    sqrt(nu) per element, of mu within half a code; (4) the loss ignores
    image positions: labels that leave the image token unmasked come back
    IGNORE over the whole image block."""
    import torch

    from competesmoe_tpu_torch.models.builder import build_llava
    from competesmoe_tpu_torch.train import quant_opt
    from competesmoe_tpu_torch.train.lm_trainer import OptConfig
    from competesmoe_tpu_torch.train.mm_task import MMOptimizer

    cfg = small_mm_config()
    model = build_llava(cfg, seed=seed, device="cuda")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = small_mm_batch(seed + 1)
    norms = []
    for n_micro in (1, 2):
        model.load_state_dict(init)
        norms.append(small_mm_steps(model, False, n_micro, batch,
                                    steps=1)[0]["grad_norm"])
    ratio = norms[1] / norms[0]
    log(f"mm probe: grad_norm with 1 and 2 microbatches {norms} "
        f"(ratio {ratio:.4f})")
    if not abs(ratio - 1.0) <= 0.05:
        raise AssertionError(f"microbatch gradients: grad_norm {norms}")

    g = torch.Generator(device="cuda").manual_seed(seed)
    want_norm = {"projector": 4.0, "vision": 0.5, "decoder": 2.0}
    names = {"projector": "mm_projector.w", "vision": "vision_tower.w",
             "decoder": "language_model.w"}
    params = {n: torch.zeros(64, device="cuda") for n in names.values()}
    grads = {}
    for grp, n in names.items():
        v = torch.randn(64, generator=g, device="cuda")
        grads[n] = v / v.norm() * want_norm[grp]
    c = OptConfig(lr=1.0, lr_sched="constant", grad_clip=1.0,
                  adam_eps=1e6)
    opt = MMOptimizer({grp: c for grp in names})
    opt.apply(params, grads, opt.init(params))
    for grp, n in names.items():
        want = grads[n] * min(1.0, 1.0 / want_norm[grp])
        err = float((-params[n] * 1e6 - want).abs().max())
        if not err <= 1e-3 * float(want.abs().max()):
            raise AssertionError(f"optimizer: group {grp} update off its "
                                 f"own clip by {err}")
    log("mm probe: each group clipped by its own norm")

    x = torch.rand(4, 1000, generator=g, device="cuda")
    nu = 10.0 ** (-8 * x)
    leaf = quant_opt.quantize_sqrt(nu, 256)
    back = quant_opt.dequantize_sqrt(leaf, 256)
    code = quant_opt._unblocked(
        leaf.scale[..., None].expand(*leaf.scale.shape, 256), 1000)
    if not bool(((back.sqrt() - nu.sqrt()).abs() <= 0.5001 * code).all()):
        raise AssertionError("8-bit nu is not within half a code of "
                             "sqrt(nu)")
    mu = torch.randn(4, 1000, generator=g, device="cuda")
    leaf = quant_opt.quantize_signed(mu, 256)
    code = quant_opt._unblocked(
        leaf.scale[..., None].expand(*leaf.scale.shape, 256), 1000)
    if not bool(((quant_opt.dequantize_signed(leaf, 256) - mu).abs()
                 <= 0.5001 * code).all()):
        raise AssertionError("8-bit mu is not within half a code")
    log("mm probe: 8-bit moments within half a code of sqrt(nu) and mu")

    ids = torch.as_tensor(batch["input_ids"][:1], device="cuda")
    labels = ids.clone()
    labels[0, 2] = 7          # the image token left unmasked
    px = torch.as_tensor(batch["images"][:1], device="cuda")
    with torch.no_grad():
        out = model(ids, px, labels=labels, train=False)
    P = cfg.num_image_tokens
    block = out.labels[0, 2:2 + P]
    if not bool((block == -100).all()) or not torch.equal(
            out.labels[0, 2 + P:], labels[0, 3:3 + out.labels.shape[1]
                                          - 2 - P]):
        raise AssertionError("the spliced labels keep image positions or "
                             "move the text's")
    log("mm probe: the image block's labels are ignored, the text's kept")
    del model
    free_card()
    return dict(grad_norm_micro_ratio=ratio)


def small_mm_resume_check(seed: int):
    """The trainer's Saver on the card through cli.train_mm.train: a small
    model takes 3 steps (sft, 8-bit moments, 2 microbatches, a checkpoint
    every 2 steps); a run stopped after its checkpoint at step 2 and a
    fresh model resumed from it (weights, 8-bit moments, step, sampler
    position) take step 3. Every step's loss and grad_norm equal the
    uninterrupted run's, bit for bit."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.cli.train_mm import train
    from competesmoe_tpu_torch.models.builder import build_llava

    cfg = small_mm_config()
    tok = ChatTok(cfg.decoder.vocab_size)
    data = MMConversations(tok, 6, (4, 12), 28, seed, 64)
    flags = ["--stage", "sft", "--num-train-steps", "3", "--save-interval",
             "2", "--opt-state-8bit", "--grad-accum", "2",
             "--per-device-batch-size", "2", "--model-max-length", "64",
             "--rate-flip", "0.5", "--max-compete-in-iter", "3",
             "--learning-rate", "1e-3", "--warmup-ratio", "0",
             "--seed", str(seed), "--log-interval", "100"]
    init = build_llava(cfg, seed=seed, device="cuda").state_dict()

    class Stop(Exception):
        pass

    def run(out_dir, stop_at=None, resume=False):
        rows = []

        def on_step(step, state, m, seconds):
            rows.append([float(m["loss/total"]), float(m["grad_norm"])])
            if step == stop_at:
                raise Stop()

        model = build_llava(cfg, seed=seed + 1, device="cuda")
        model.load_state_dict(init)
        try:
            train(mm_args(flags + (["--resume"] if resume else []),
                          out_dir), model, data, tok, on_step=on_step)
        except Stop:
            pass
        return rows

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mm_resume_"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight = run(tmp / "straight")
        first = run(tmp / "resumed", stop_at=2)
        second = run(tmp / "resumed", resume=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    got = first[:2] + second
    log(f"small mm save/restore on the card: 2 steps, model-2, a fresh "
        f"model resumed, 1 step: {got} (uninterrupted {straight})")
    if got != straight:
        raise AssertionError(f"small mm training after save/restore {got} "
                             f"!= the uninterrupted run {straight}")


def small_mm_train_check(seed: int):
    """The small checks of the multimodal training path (chip_faults.py
    plants faults against them)."""
    gaps = small_mm_card_vs_cpu(seed)
    probes = mm_probes(seed)
    small_mm_resume_check(seed)
    return dict(card_vs_cpu=gaps, **probes)


def _mm_row(step, m, seconds, tokens, peak):
    """One step's printed numbers; `peak` in bytes above what earlier
    phases still hold."""
    competed = [li for li, c in enumerate(m["vision/is_comp"].tolist())
                if c] + (["projector"] if float(m["projector/is_comp"])
                         else [])
    rl = m["vision/routerloss"].tolist() + [float(m["projector/routerloss"])]
    return dict(step=step, wall_ms=seconds * 1e3,
                tokens_per_s=tokens / seconds,
                loss=float(m["loss/total"]), aux_mlp=float(m["loss/aux_mlp"]),
                aux_clip=float(m["loss/aux_clip"]),
                grad_norm=float(m["grad_norm"]), competed=competed,
                routerloss={str(c): rl[c if c != "projector" else -1]
                            for c in competed},
                routerloss_elsewhere=max(
                    [r for i, r in enumerate(rl)
                     if (i if i < len(rl) - 1 else "projector")
                     not in competed] or [0.0]),
                peak_gib=peak / 2 ** 30)


def phase_mm_train(seed: int, lora: bool = True, profile: bool = False):
    """The multimodal training slice's main path: CompeteSMoE-5.1B at full
    width and depth, bf16 weights from `seed`, through cli.train_mm.train
    with MM_FULL_FLAGS for MM_STEPS steps at MM_BATCH rows of 2048
    positions, on conversations from `preprocess_phi35` (`ChatTok`; image
    rows with seeded 224 px pixels, every third row text-only); then
    MM_LORA_STEPS LoRA steps (r 128, alpha 256) on the trained model.
    Every number finite; the projector's, the tower's and the decoder's
    weights move; routerloss > 0 exactly on the layers that competed;
    the tower competes on at least two steps and the projector too. No
    kernel of K1-K5 lies on this path: every launch count stays 0. With
    `profile`, torch.profiler takes the last full step (printed only:
    busy share, the kernels that take the time)."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.cli.train_mm import train
    from competesmoe_tpu_torch.models.builder import (HF_5P1B, build_llava,
                                                      llava_config_from_hf)

    free_card()
    held = torch.cuda.memory_allocated()
    log(f"mm train: {held / 2 ** 30:.2f} GiB of device memory still held "
        f"by earlier phases")
    cfg = llava_config_from_hf(HF_5P1B, "llava_phi", torch.bfloat16)
    t0 = time.perf_counter()
    model = build_llava(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    log(f"mm train: 5.1B bf16 built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    probes = {
        "projector": model.mm_projector.moelayer.experts_w1,
        "vision": model.vision_tower.layers[0].moelayer.experts_w1,
        "decoder": model.language_model.layers[0].self_attn.qkv_proj.weight}
    before = {k: p.detach()[0, :64].clone() for k, p in probes.items()}
    tok = ChatTok(cfg.decoder.vocab_size)
    data = MMConversations(tok, 12, (150, 400), cfg.vision.image_size, seed,
                           2048)
    tokens = MM_BATCH * cfg.tokenizer_model_max_length
    out = dict(card=card_line(), batch=MM_BATCH, steps=MM_STEPS,
               flags=" ".join(MM_FULL_FLAGS), rows=[], lora_rows=[],
               held_before_gib=held / 2 ** 30)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mm_"))

    prof = []

    def on_step(rows, profile_last=False):
        def record(step, state, m, seconds):
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_step[0]
            row = _mm_row(step, m, wall, tokens,
                          torch.cuda.max_memory_allocated() - held)
            rows.append(row)
            log(f"mm train step {step}: {json.dumps(row)}")
            if prof:
                prof.pop().__exit__(None, None, None)
                out["profile"] = _busy(prof_ctx[0], wall, 1, "mm train")
                log(f"mm train profile of step {step}: "
                    f"{json.dumps(out['profile'])}")
            elif profile_last and step == MM_STEPS - 2:
                from torch.profiler import ProfilerActivity
                prof_ctx[:] = [torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA])]
                prof.append(prof_ctx[0])
                prof_ctx[0].__enter__()
            torch.cuda.reset_peak_memory_stats()
            t_step[0] = time.perf_counter()
        return record

    prof_ctx = [None]

    t_step = [0.0]
    try:
        reset_counts()
        flags = MM_FULL_FLAGS + [
            "--per-device-batch-size", str(MM_BATCH), "--num-train-steps",
            str(MM_STEPS), "--seed", str(MM_SEED)]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_step[0] = time.perf_counter()
        train(mm_args(flags, tmp / "full"), model, data, tok,
              on_step=on_step(out["rows"], profile), final_save=False)
        counts = read_counts()
        if lora:
            free_card()
            torch.cuda.reset_peak_memory_stats()
            t_step[0] = time.perf_counter()
            train(mm_args(flags[:-4] + [
                "--num-train-steps", str(MM_LORA_STEPS), "--seed",
                str(MM_SEED), "--lora-enable", "--lora-r", "128",
                "--lora-alpha", "256", "--learning-rate", "2e-4"],
                tmp / "lora"), model, data, tok,
                on_step=on_step(out["lora_rows"]), final_save=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in out["rows"] + out["lora_rows"]:
        nums = [row[k] for k in ("loss", "aux_mlp", "aux_clip", "grad_norm")]
        nums += list(row["routerloss"].values())
        if not all(math.isfinite(v) for v in nums):
            raise AssertionError(f"mm train: a number is not finite: {row}")
    for row in out["rows"]:
        if (any(v <= 0 for v in row["routerloss"].values())
                or row["routerloss_elsewhere"] != 0):
            raise AssertionError(f"mm train: routerloss is not > 0 exactly "
                                 f"on the competing layers: {row}")
    tower = sum(1 for r in out["rows"] if any(c != "projector"
                                              for c in r["competed"]))
    proj = sum(1 for r in out["rows"] if "projector" in r["competed"])
    if tower < 2 or proj < 2:
        raise AssertionError(f"mm train: the tower competed on {tower} and "
                             f"the projector on {proj} steps (want >= 2)")
    moved = {k: not torch.equal(before[k], p.detach()[0, :64])
             for k, p in probes.items()}
    if not all(moved.values()):
        raise AssertionError(f"mm train: weights did not move: {moved}")
    if any(counts.values()):
        raise AssertionError(f"mm train launched kernels: {counts}")
    out["moved"] = moved
    out["launches"] = counts
    del model, probes
    free_card()
    return out


# ---------------------------------------------------------------------------
# Evaluation (cli/eval_mm): the lmms interface on the card
# ---------------------------------------------------------------------------

# words of POPE's questions, in order of length: a doc's context grows
# with its index, so the collator's sort reverses the docs' order
EVAL_OBJECTS = ("cat", "dog", "cake", "chair", "person", "bottle",
                "handbag", "umbrella", "motorcycle", "dining table",
                "traffic light", "baseball glove")
# the small check's routes and its tasks (POPE's prompt and exact_match,
# plus ANLS without its threshold: a score that moves with every answer)
SMALL_EVAL_GEN_DOCS = 7
SMALL_EVAL_LL_DOCS = 5
SMALL_EVAL_NEW_TOKENS = 8
# the 5.1B phase: POPE-shaped generation and a yes/no loglikelihood task
EVAL_GEN_DOCS = 48
EVAL_LL_DOCS = 32
EVAL_LL_BATCH = 8
EVAL_WARMUP_DOCS = 8
# loglikelihood totals on the card against the CPU's: within 3% of the
# CPU's magnitude. A route's totals against the label splice's on its
# device: within 2 x 3% of the largest |logit| of the scored rows a
# target token (3% of the largest logit is the engine checks' tolerance
# for two forwards of other shapes; a log-probability moves by at most
# twice its logits' largest move)
EVAL_LL_TOL = 0.03
EVAL_LOGIT_TOL = 0.03
# the same at the 5.1B's full depth in bf16: forwards of other shapes part
# by up to 7% of the largest logit there (PERF.md §6-7, the engine
# features), and the image rows at batch 8 read 12.1% off the splice; in
# float32 the same documents read within 1e-4 of the 3% bound at batch 8
# and 1, image rows too (`settle_eval_bound`): bf16 rounding, no offset
EVAL_FULL_LOGIT_TOL = 0.08


class ArrayImage:
    """The images' counterpart of WordTok: the card machine has no PIL, so
    no image is decoded on the card. A seeded uint8 HWC array at the image
    processor's size, which `ImageProcessorConfig.preprocess` reads as it
    reads a PIL image: convert() returns the image itself, resize()
    returns it at its own size and raises at any other."""

    def __init__(self, seed: int, size: int):
        rng = np.random.default_rng(seed)
        self.array = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        self.size = (size, size)

    def convert(self, mode):
        return self

    def resize(self, size, resample=None):
        if tuple(size) != self.size:
            raise ValueError(f"an ArrayImage of {self.size} cannot become "
                             f"{tuple(size)}: no image is resized here")
        return self

    def __array__(self, dtype=None, copy=None):
        return self.array if dtype is None else self.array.astype(dtype)


class EvalTok(WordTok):
    """WordTok as the eval adapter's tokenizer: phi's `<|...|>` markers are
    words of their own, and every id decodes (an id that no word took as
    `<id>`, which encodes back to that id), so an answer's text gives back
    its tokens (`tokens_of`). `eos` sets the id that ends an answer."""

    _WORDS = __import__("re").compile(r"<\|[a-z]+\|>|\S+?(?=<\|)|\S+")
    _ID = __import__("re").compile(r"<(\d+)>")

    def __init__(self, vocab_size: int, eos: int = 2):
        super().__init__(vocab_size)
        self.eos_token_id = eos

    def __call__(self, text):
        ids = []
        for w in self._WORDS.findall(text):
            m = self._ID.fullmatch(w)
            ids += ([int(m.group(1))] if m
                    else super().__call__(w).input_ids)
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.inv.get(int(i), f"<{int(i)}>") for i in ids)

    def tokens_of(self, text: str):
        return self(text).input_ids


def pope_docs(seed: int, n: int, size: int, text_every: int = 0):
    """POPE-shaped documents: 'Is there a <object> in the image?' with a
    yes/no answer and an ArrayImage of `size` px (every `text_every`-th doc
    without one when text_every > 0); doc i's object is the i-th shortest
    (cycling), so contexts grow with the index."""
    rng = np.random.default_rng(seed)
    return [{"question": f"Is there a {EVAL_OBJECTS[i % len(EVAL_OBJECTS)]}"
                         f" in the image?",
             "answer": str(rng.choice(["yes", "no"])),
             "image": (None if text_every and i % text_every == 1
                       else ArrayImage(seed * 1000 + i, size))}
            for i in range(n)]


def register_eval_tasks(prefix: str, gen_docs, ll_docs, anls: bool,
                        new_tokens: int = 16):
    """Register `<prefix>_gen` (POPE's registration with these docs: its
    prompt suffix and exact_match; `new_tokens` new tokens, POPE's 16 by
    default; ANLS without its threshold when `anls`) and `<prefix>_ll` (a
    loglikelihood task on the same prompt scoring each doc's `target`,
    accuracy = the greedy flag); returns their names."""
    from competesmoe_tpu_torch.eval import register_task
    from competesmoe_tpu_torch.eval import tasks_builtin  # noqa: F401
    from competesmoe_tpu_torch.eval.task import get_task_config

    pope = get_task_config("pope")
    metrics = list(pope.metric_list) + ([{"metric": "anls",
                                          "aggregation": "mean",
                                          "threshold": 0.0}] if anls else [])
    register_task(f"{prefix}_gen", dataclasses.replace(
        pope, task=f"{prefix}_gen", dataset_path=None, docs=gen_docs,
        metric_list=metrics,
        generation_kwargs=dict(pope.generation_kwargs,
                               max_new_tokens=new_tokens)))
    register_task(f"{prefix}_ll", dataclasses.replace(
        pope, task=f"{prefix}_ll", dataset_path=None, docs=ll_docs,
        output_type="loglikelihood", doc_to_target=lambda d: d["target"],
        generation_kwargs={}, filter_list=[],
        metric_list=[{"metric": "accuracy", "aggregation": "mean"}]))
    return f"{prefix}_gen", f"{prefix}_ll"


def eval_args(**flags):
    """cli/eval_mm's arguments: `flags` as --flag values (True: a bare
    switch)."""
    from competesmoe_tpu_torch.cli.eval_mm import parse_args
    argv = []
    for k, v in flags.items():
        if v is False or v is None:
            continue
        argv.append("--" + k.replace("_", "-"))
        if v is not True:
            argv.append(str(v))
    return parse_args(argv)


def eval_run(tok, model=None, **flags):
    """One cli/eval_mm run (printing the CLI's table), its results."""
    from competesmoe_tpu_torch.cli.eval_mm import run
    with contextlib.redirect_stdout(sys.stderr):
        return run(eval_args(**flags), model=model, tokenizer=tok)[0]


def texts(results, task):
    """{doc_id: answer} of a generate_until task."""
    return {s["doc_id"]: s["resps"][0] for s in results["samples"][task]}


def doc_prompt(model, tok, task: str, doc_id: int):
    """(prompt ids, pixels [1, H, W, 3] or None) of a task's document as
    the adapter builds them."""
    from competesmoe_tpu_torch.eval import TorchLlava
    from competesmoe_tpu_torch.eval.task import get_task_config
    from competesmoe_tpu_torch.multimodal.mm_utils import process_images
    cfg = get_task_config(task)
    doc = cfg.docs[doc_id]
    vis = cfg.doc_to_visual(doc)
    lm = TorchLlava(model, tok)
    ids = np.asarray(lm._build_prompt(cfg.doc_to_text(doc), bool(vis)))
    return ids, (process_images(vis[:1], lm.image_processor) if vis
                 else None)


def answers_part(model, tok, task, got, want, what: str):
    """Two routes' answers {doc_id: text} to a task: for each document None
    where the texts are equal; else their tokens may part only where the
    reference's (`want`'s, on `model`) top-2 margin lies within the logit
    tolerance (`reference_margin`), a stream that stops counting as
    parting where it stops. Returns {doc_id: (step, margin, tol)} of the
    parted documents, or raises."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: documents {sorted(got)} != "
                             f"{sorted(want)}")
    parted = {}
    for d in sorted(want):
        if got[d] == want[d]:
            continue
        a, b = tok.tokens_of(got[d]), tok.tokens_of(want[d])
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        ids, px = doc_prompt(model, tok, task, d)
        margin, tol = reference_margin(model, ids, px, b[:j])
        if margin > tol:
            raise AssertionError(
                f"{what}, doc {d}: {got[d]!r} parts from {want[d]!r} at "
                f"step {j} where the top-2 margin {margin:.4g} exceeds "
                f"{tol:.4g}")
        parted[d] = (j, round(margin, 5), round(tol, 5))
    return parted


def spliced_loglikelihood(model, tok, task: str, doc_id: int,
                          logit_tol: float = EVAL_LOGIT_TOL):
    """(total log-probability, greedy, tolerance) of a loglikelihood
    document's target from the model's own label splice: prompt + target
    as labels with the prompt ignored, each label scored by the logits one
    position before it (the image token counts as its P positions). One
    forward at batch 1, float32 log_softmax; the tolerance is 2 x
    `logit_tol` x the largest |logit| of the scored rows a token."""
    import torch

    from competesmoe_tpu_torch.constants import IGNORE_INDEX
    from competesmoe_tpu_torch.eval.task import get_task_config
    ids, px = doc_prompt(model, tok, task, doc_id)
    cfg = get_task_config(task)
    target = tok(cfg.doc_to_target(cfg.docs[doc_id])).input_ids
    dev = model.device
    full = torch.as_tensor(np.concatenate([ids, target])[None], device=dev)
    labels = torch.as_tensor([[IGNORE_INDEX] * len(ids) + target],
                             device=dev)
    with torch.no_grad():
        out = model(full, None if px is None else torch.as_tensor(
            px, device=dev), labels=labels)
    lp = torch.log_softmax(out.logits[0, :-1].float(), -1)
    lab = out.labels[0, 1:]
    keep = lab != IGNORE_INDEX
    if int(keep.sum()) != len(target):
        raise AssertionError(f"{task} doc {doc_id}: the splice kept "
                             f"{int(keep.sum())} of {len(target)} labels")
    rows = out.logits[0, :-1][keep].float()
    lp, lab = lp[keep], lab[keep]
    return (float(lp.gather(-1, lab[:, None]).sum()),
            bool((lp.argmax(-1) == lab).all()),
            2 * logit_tol * float(rows.abs().max()) * len(target))


def hold_loglikelihoods(got, want, what: str, greedy: bool = False):
    """{doc_id: (ll, greedy)} against a reference's {doc_id: (ll, greedy)}
    (tolerance EVAL_LL_TOL x |ll|) or {doc_id: (ll, greedy, tolerance)}:
    finite and within the tolerance, and with `greedy` the same greedy
    flags (a reference on the same device). Returns the largest gap in
    units of its tolerance."""
    worst = 0.0
    for d, ref in want.items():
        ll, is_greedy = ref[:2]
        tol = ref[2] if len(ref) > 2 else EVAL_LL_TOL * abs(ll)
        g = got[d][0]
        gap = abs(g - ll) / max(tol, 1e-12)
        if not (math.isfinite(g) and gap <= 1.0):
            raise AssertionError(f"{what}, doc {d}: loglikelihood {g:.5g} "
                                 f"against {ll:.5g} (gap {abs(g - ll):.4g} "
                                 f"> tolerance {tol:.4g})")
        if greedy and bool(got[d][1]) != is_greedy:
            raise AssertionError(f"{what}, doc {d}: greedy {got[d][1]} "
                                 f"against {is_greedy}")
        worst = max(worst, gap)
    return worst


def lls(results, task):
    """{doc_id: (ll, greedy)} of a loglikelihood task."""
    return {s["doc_id"]: tuple(s["resps"][0])
            for s in results["samples"][task]}


def hold_telemetry(model, px, sample, what: str):
    """A batch-1 answer's routing telemetry against the router's own
    choices recomputed from the same pixels on `model`: per layer of the
    tower and the projector, the top-1 (top-2) histogram is the
    bincount of the first (second) largest gate probability, where a
    token whose probabilities tie may count on either side (each such
    token may move the L1 distance by 2); every histogram sums to the
    routed tokens and every entropy lies in [0, ln E]. Returns the
    layers checked."""
    import torch
    with torch.no_grad():
        _, _, v_auxes, p_aux = model.encode_images(
            torch.as_tensor(px, device=model.device), return_id_experts=True)
    n = 0
    for part, auxes in (("logs_metrics_vision", v_auxes),
                        ("logs_metrics_mlp", [p_aux])):
        tele = sample[part] or {}
        if sorted(tele) != sorted(f"layer_{i}" for i in range(len(auxes))):
            raise AssertionError(f"{what}: {part} has layers "
                                 f"{sorted(tele)[:4]}, not {len(auxes)}")
        for li, aux in enumerate(auxes):
            rec = tele[f"layer_{li}"]
            p = aux.gate_softmax.float().reshape(-1,
                                                 aux.gate_softmax.shape[-1])
            E = p.shape[-1]
            vals, order = p.sort(-1, descending=True)
            ties = [(vals[:, 0] == vals[:, 1]),
                    (vals[:, 0] == vals[:, 1]) | (vals[:, 1] == vals[:, 2])]
            for k, key in enumerate(("top1_hist", "top2_hist")):
                want = torch.bincount(order[:, k], minlength=E).tolist()
                dist = sum(abs(a - b) for a, b in zip(rec[key], want))
                if dist > 2 * int(ties[k].sum()) or \
                        sum(rec[key]) != p.shape[0]:
                    raise AssertionError(
                        f"{what}: {part} layer {li} {key} {rec[key]} "
                        f"against the router's {want} ({int(ties[k].sum())}"
                        f" tied tokens, {p.shape[0]} routed)")
            if not 0.0 <= rec["entropy"] <= math.log(E) + 1e-6:
                raise AssertionError(f"{what}: {part} layer {li} entropy "
                                     f"{rec['entropy']} outside [0, ln {E}]")
            n += 1
    return n


def merged_equal(merged, single, tasks, what: str):
    """A two-rank merge against the single run: every metric within 1e-9
    relative, every document's answer equal. (A bootstrap stderr resamples
    the per-document scores in the order they come, rank by rank after a
    merge, so the stderrs differ.)"""
    for t in tasks:
        a, b = merged["results"][t], single["results"][t]
        if sorted(a) != sorted(b) or any(
                abs(a[k] - b[k]) > 1e-9 * max(abs(b[k]), 1e-12)
                for k in b if not k.endswith("_stderr")):
            raise AssertionError(f"{what}: merged {t} {a} != single {b}")
        # rank shards cross through JSON: compare both as JSON values
        got, want = ({s["doc_id"]: json.loads(json.dumps(s["resps"]))
                      for s in r["samples"][t]} for r in (merged, single))
        if got != want:
            raise AssertionError(f"{what}: merged {t} answers differ")
    if merged.get("merged_ranks") != 2:
        raise AssertionError(f"{what}: {merged.get('merged_ranks')} ranks "
                             f"merged")


def small_eval_check(seed: int):
    """cli/eval_mm on a small --load-4bit --kv-quant int8 model (SMALL_HF,
    written as a checkpoint to a temporary directory and loaded by the
    CLI), on the card and on the CPU, with EvalTok (its eos: the token the
    CPU's greedy answers emit most after their first, so answers stop
    early) and ArrayImages. Tasks: 7 POPE-shaped docs (every third without
    an image) and 5 loglikelihood docs, those of 0, 2 and 4 whose targets
    are the CPU's own 3 greedy tokens. Routes on each device: solo (batch
    2: generate_until, then loglikelihood), engine-backed (--engine-slots
    2), batch 1 with --return-id-experts, and ranks 1 then 0 of two with
    --merge-dir. Checks: no answer holds the eos; the card's answers equal
    the CPU's or part only under the parting rule (`answers_part`, the
    CPU model the reference); the engine's answers equal the solo route's
    on each device (same rule); loglikelihood totals within EVAL_LL_TOL
    of the CPU's, and each route's against the label splice on its device
    (`spliced_loglikelihood`: the bound of EVAL_LOGIT_TOL, the same greedy
    flags); the CPU's greedy targets score greedy; telemetry against the
    router's own choices (`hold_telemetry`); the merge equal to the
    batch-1 run; the card's routes launch K5 and no other kernel."""
    import collections
    import tempfile

    import torch

    from competesmoe_tpu_torch.eval import Instance, TorchLlava
    from competesmoe_tpu_torch.eval.task import get_task_config
    from competesmoe_tpu_torch.models.builder import (HF_5P1B, build_llava,
                                                      load_pretrained_model)
    from competesmoe_tpu_torch.models.hf_export import save_hf_checkpoint

    cfg = served_config("int4", small=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_small_eval_"))
    t_start = time.perf_counter()
    try:
        writer = build_llava(cfg, seed, "cuda")
        save_hf_checkpoint(writer, cfg, tmp / "ckpt",
                           hf_config=dict(HF_5P1B, **SMALL_HF))
        del writer
        models = {dev: load_pretrained_model(tmp / "ckpt", load_4bit=True,
                                             kv_quant="int8", device=dev)[1]
                  for dev in ("cuda", "cpu")}
        vocab, size = cfg.decoder.vocab_size, cfg.vision.image_size
        tok = EvalTok(vocab)
        gen_docs = pope_docs(seed, SMALL_EVAL_GEN_DOCS, size, text_every=3)
        ll_docs = pope_docs(seed + 1, SMALL_EVAL_LL_DOCS, size,
                            text_every=2)
        for d in ll_docs:
            d["target"] = f"{d['answer']} it is"
        gen, ll = register_eval_tasks("small_eval", gen_docs, ll_docs, True,
                                      SMALL_EVAL_NEW_TOKENS)
        # the CPU's greedy answers at batch 1: the commonest token after
        # an answer's first becomes the eos (answers then stop early), and
        # the first 3 tokens of ll docs 0, 2 and 4 become their targets
        probe = TorchLlava(models["cpu"], tok, max_new_tokens=3)
        cfg_ll = get_task_config(ll)
        reqs = [Instance(request_type="generate_until", arguments=(
            cfg_ll.doc_to_text(d), {"max_new_tokens": k},
            cfg_ll.doc_to_visual(d)), idx=0, metadata=("probe", i, 1))
            for k, docs in ((SMALL_EVAL_NEW_TOKENS, gen_docs), (3, ll_docs))
            for i, d in enumerate(docs)]
        answers = [tok.tokens_of(a) for a in probe.generate_until(reqs)]
        tok.eos_token_id = collections.Counter(
            t for a in answers[:len(gen_docs)] for t in a[1:]
        ).most_common(1)[0][0]
        greedy_docs = []
        for i in range(0, len(ll_docs), 2):
            target = answers[len(gen_docs) + i]
            if target and tok.eos_token_id not in target:
                ll_docs[i]["target"] = tok.decode(target)
                greedy_docs.append(i)
        common_flags = dict(model_dir=tmp / "ckpt", load_4bit=True,
                            kv_quant="int8",
                            max_new_tokens=SMALL_EVAL_NEW_TOKENS,
                            world_size=1, rank=0)
        routes = {}
        for dev in ("cuda", "cpu"):
            flags = dict(common_flags, device=dev)
            res = {}

            def route(name, tasks, **more):
                reset_counts()
                out = eval_run(tok, tasks=",".join(tasks),
                               output_path=tmp / f"{dev}_{name}.json",
                               **dict(flags, **more))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts = read_counts()
                    k5 = counts["quant_small_m_matmul_int4"]
                    if k5 == 0 or sum(counts.values()) != k5:
                        raise AssertionError(f"small eval {name} on the "
                                             f"card: launches {counts}")
                res[name] = out

            route("solo", (gen, ll), batch_size=2)
            route("engine", (gen,), engine_slots=2, engine_max_len=256)
            route("telemetry", (gen, ll), batch_size=1,
                  return_id_experts=True)
            md = tmp / f"merge_{dev}"
            for rank in (1, 0):
                route(f"rank{rank}", (gen, ll), batch_size=1,
                      world_size=2, rank=rank, merge_dir=md)
            for name, r in res.items():      # answers stop before the eos
                for d, text in texts(r, gen).items():
                    if tok.eos_token_id in tok.tokens_of(text):
                        raise AssertionError(f"small eval {name} ({dev}), "
                                             f"doc {d}: {text!r} holds the "
                                             f"eos")
            if res["rank1"].get("partial_rank") != 1:
                raise AssertionError("small eval: rank 1 did not return "
                                     "its partial results")
            merged_equal(res["rank0"], res["telemetry"], (gen, ll),
                         f"small eval merge ({dev})")
            # the engine's answers are the solo route's
            parted = answers_part(models[dev], tok, gen,
                                  texts(res["engine"], gen),
                                  texts(res["solo"], gen),
                                  f"small eval engine vs solo ({dev})")
            res["engine_parted"] = parted
            # each route's loglikelihoods against the label splice: totals
            # within EVAL_LL_TOL, the same greedy flags
            spliced = {d: spliced_loglikelihood(models[dev], tok, ll, d)
                       for d in range(len(ll_docs))}
            res["ll_gap_splice"] = max(
                hold_loglikelihoods(lls(res[r], ll), spliced,
                                    f"small eval {r} ll vs splice ({dev})",
                                    greedy=True)
                for r in ("solo", "telemetry"))
            if dev == "cpu" and (len(greedy_docs) < 2 or not all(
                    spliced[d][1] for d in greedy_docs)):
                raise AssertionError(f"small eval: the CPU's greedy answers "
                                     f"{[ll_docs[d]['target'] for d in greedy_docs]}"
                                     f" do not score greedy in the splice")
            # telemetry of each answer with an image
            n_layers = 0
            for s in res["telemetry"]["samples"][gen]:
                _, px = doc_prompt(models[dev], tok, gen, s["doc_id"])
                if px is not None:
                    n_layers += hold_telemetry(
                        models[dev], px, s,
                        f"small eval telemetry ({dev}) doc {s['doc_id']}")
            res["telemetry_layers"] = n_layers
            routes[dev] = res
        cpu, card = routes["cpu"], routes["cuda"]
        for d in greedy_docs:
            if not lls(cpu["solo"], ll)[d][1]:
                raise AssertionError(f"small eval: ll doc {d}'s target "
                                     f"{ll_docs[d]['target']!r}, the CPU's "
                                     f"own greedy answer, is not greedy")
        parted = {name: answers_part(models["cpu"], tok, gen,
                                     texts(card[name], gen),
                                     texts(cpu[name], gen),
                                     f"small eval {name} card vs CPU")
                  for name in ("solo", "engine", "telemetry")}
        ll_gap = max(hold_loglikelihoods(lls(card[r], ll), lls(cpu[r], ll),
                                         f"small eval {r} ll card vs CPU")
                     for r in ("solo", "telemetry"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = dict(
        seconds=time.perf_counter() - t_start, eos=tok.eos_token_id,
        greedy_docs=greedy_docs,
        card_vs_cpu_parted={k: len(v) for k, v in parted.items()},
        engine_vs_solo_parted={dev: len(routes[dev]["engine_parted"])
                               for dev in routes},
        ll_card_vs_cpu_of_tol=ll_gap,
        ll_vs_splice_of_tol={dev: routes[dev]["ll_gap_splice"]
                          for dev in routes},
        telemetry_layers={dev: routes[dev]["telemetry_layers"]
                          for dev in routes})
    log(f"small eval (card vs CPU, cli/eval_mm, --load-4bit): "
        f"{json.dumps(summary)}")
    free_card()
    return summary


def eval_route_stats(results, tasks, tok, model, seconds: float):
    """Documents/s, generated tok/s, and for loglikelihood requests/s and
    scored positions/s (each request's prompt + target rounded up to the
    adapter's pad quantum, + P - 1 with an image) of one route."""
    from competesmoe_tpu_torch.eval import TorchLlava
    from competesmoe_tpu_torch.eval.task import get_task_config
    docs = sum(len(results["samples"][t]) for t in tasks)
    stats = dict(seconds=seconds, docs=docs, docs_s=docs / seconds)
    gen = [t for t in tasks
           if get_task_config(t).output_type == "generate_until"]
    if gen:
        n = sum(len(tok.tokens_of(s["resps"][0]))
                for t in gen for s in results["samples"][t])
        stats.update(generated_tokens=n, tok_s=n / seconds)
    else:
        lm = TorchLlava(model, tok)
        P = model.cfg.num_image_tokens
        positions = 0
        for t in tasks:
            cfg = get_task_config(t)
            for doc in cfg.docs:
                vis = cfg.doc_to_visual(doc)
                n = len(lm._build_prompt(cfg.doc_to_text(doc), bool(vis))) \
                    + len(tok(cfg.doc_to_target(doc)).input_ids)
                positions += lm._quantize(n) + (P - 1 if vis else 0)
        stats.update(requests_s=docs / seconds, positions=positions,
                     positions_s=positions / seconds)
    return stats


def phase_eval(seed: int, model):
    """The eval slice's main path at full width: `model` (the 5.1B
    checkpoint loaded with --load-4bit --kv-quant int8) through
    cli/eval_mm.run with EvalTok and ArrayImages (no image decoding on the
    card). Tasks: EVAL_GEN_DOCS POPE-shaped documents with 224 px images
    (POPE's registration: prompt suffix, max_new_tokens 16, exact_match)
    and EVAL_LL_DOCS yes/no loglikelihood documents, half text-only.
    Routes, each after an untimed one over its first EVAL_WARMUP_DOCS
    documents (captures): solo at batch 1 with --speculative 4 (the
    reference answers), solo at batch 4, --engine-slots 8, solo at batch 4
    with --return-id-experts, and the loglikelihood task at batch
    EVAL_LL_BATCH. Each route is a window of the main path (counts set to
    0 as it opens, read as it closes; the decoder's forwards recorded
    inside). Checks: every route's answers against the reference's
    (equal, or parting under the parting rule); telemetry on every
    answer, for every tower layer and the projector (histograms sum to
    the routed tokens, entropies in [0, ln E]); every loglikelihood
    total against the label splice within EVAL_FULL_LOGIT_TOL's bound
    (`spliced_loglikelihood`); K5 launches = 4 x 32 per
    forward whose rows it takes, the other kernels 0. Returns (K5
    launches, the `eval_summary` dict)."""
    import tempfile

    import torch

    L = model.cfg.decoder.num_hidden_layers
    size = model.cfg.vision.image_size
    tok = EvalTok(model.cfg.decoder.vocab_size)
    ll_docs = pope_docs(seed + 5, EVAL_LL_DOCS, size, text_every=2)
    for d in ll_docs:
        d["target"] = d["answer"]
    gen, ll = register_eval_tasks("card_eval",
                                  pope_docs(seed + 4, EVAL_GEN_DOCS, size),
                                  ll_docs, False)
    # the solo programs captured so far predate this phase's recorder:
    # drop them, so that every replay in the windows is recorded
    model.__dict__.pop("_solo_caches", None)
    free_card()
    fw = ForwardRows(model.language_model)
    fw.active = False
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    routes = {"solo_b1_spec4": dict(tasks=gen, batch_size=1, speculative=4),
              "solo_b4": dict(tasks=gen, batch_size=4),
              "engine_8": dict(tasks=gen, engine_slots=8,
                               engine_max_len=512),
              "solo_b4_telemetry": dict(tasks=gen, batch_size=4,
                                        return_id_experts=True),
              "loglikelihood_b8": dict(tasks=ll, batch_size=EVAL_LL_BATCH)}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    results, stats, counts = {}, {}, {}
    try:
        for name, flags in routes.items():  # captures and first launches
            eval_run(tok, model, limit=EVAL_WARMUP_DOCS, world_size=1,
                     rank=0, output_path=tmp / f"warm_{name}.json", **flags)
        for name, flags in routes.items():
            reset_counts()                   # a window of the main path
            fw.active = True
            t0 = time.perf_counter()
            results[name] = eval_run(tok, model, world_size=1, rank=0,
                                     output_path=tmp / f"{name}.json",
                                     **flags)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            fw.active = False
            for k, v in read_counts().items():   # the window closes
                counts[k] = counts.get(k, 0) + v
            stats[name] = eval_route_stats(results[name], [flags["tasks"]],
                                           tok, model, seconds)
    finally:
        fw.remove()
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    want = matvec_launches(model.language_model, fw.rows)
    k5 = counts["quant_small_m_matmul_int4"]
    if k5 != want or sum(counts.values()) != k5:
        raise AssertionError(f"eval launches {counts}: K5 must be {want} "
                             f"(4 x {L} x viable forwards), the others 0")
    ref = texts(results["solo_b1_spec4"], gen)
    if len(ref) != EVAL_GEN_DOCS:
        raise AssertionError(f"eval: {len(ref)} answers of {EVAL_GEN_DOCS}")
    agreement = {}
    for name in ("solo_b4", "engine_8", "solo_b4_telemetry"):
        got = texts(results[name], gen)
        parted = answers_part(model, tok, gen, got, ref,
                              f"eval {name} vs solo_b1_spec4")
        agreement[name] = dict(
            equal_share=sum(got[d] == ref[d] for d in ref) / len(ref),
            parted=parted)
    # telemetry: every answer (4 images a batch), every layer
    n_tele = 0
    for s in results["solo_b4_telemetry"]["samples"][gen]:
        for part, want_layers in (("logs_metrics_vision",
                                   model.cfg.vision.num_hidden_layers),
                                  ("logs_metrics_mlp", 1)):
            tele = s[part] or {}
            if len(tele) != want_layers:
                raise AssertionError(f"eval telemetry doc {s['doc_id']}: "
                                     f"{part} has {len(tele)} layers, not "
                                     f"{want_layers}")
            for li, rec in tele.items():
                n_exp = len(rec["top1_hist"])
                tokens = sum(rec["top1_hist"])
                if tokens % model.cfg.num_image_tokens or tokens == 0 or \
                        sum(rec["top2_hist"]) != tokens or not (
                        0.0 <= rec["entropy"] <= math.log(n_exp) + 1e-6):
                    raise AssertionError(f"eval telemetry doc "
                                         f"{s['doc_id']} {part} {li}: "
                                         f"{rec}")
                n_tele += 1
    # loglikelihoods: finite and below 0, each against the label splice
    got_ll = lls(results["loglikelihood_b8"], ll)
    if len(got_ll) != EVAL_LL_DOCS or not all(
            math.isfinite(v) and v < 0 for v, _ in got_ll.values()):
        raise AssertionError(f"eval loglikelihoods {got_ll}")
    splice_gap = hold_loglikelihoods(
        got_ll, {d: spliced_loglikelihood(model, tok, ll, d,
                                          EVAL_FULL_LOGIT_TOL)
                 for d in got_ll}, "eval loglikelihood vs splice")
    t_tele, t_plain = (stats["solo_b4_telemetry"]["seconds"],
                       stats["solo_b4"]["seconds"])
    summary = dict(
        card=card_line(), images="ArrayImage: no image decoding on the card",
        tokenizer="EvalTok (word-level stand-in)",
        routes=stats, agreement={k: dict(v, parted={str(d): p for d, p in
                                                    v["parted"].items()})
                                 for k, v in agreement.items()},
        return_id_experts_cost=t_tele / t_plain - 1,
        telemetry_layers=n_tele, ll_vs_splice_of_tol=splice_gap,
        k5_launches=k5, viable_forwards=want // (4 * L),
        peak_gib=peak / 2 ** 30, base_gib=base / 2 ** 30,
        exact_match={k: r["results"][gen]["exact_match"]
                     for k, r in results.items() if gen in r["results"]},
        ll_accuracy=results["loglikelihood_b8"]["results"][ll]["accuracy"],
        seconds=time.perf_counter() - t_phase)
    log(f"eval ({summary['card']}): " + "; ".join(
        f"{k} {v['docs_s']:.2f} docs/s"
        + (f", {v['tok_s']:.1f} tok/s" if "tok_s" in v else
           f", {v['requests_s']:.2f} req/s, {v['positions_s']:.0f} pos/s")
        for k, v in stats.items())
        + f"; answers equal to solo_b1_spec4: "
        + ", ".join(f"{k} {v['equal_share']:.0%}"
                    for k, v in agreement.items())
        + f"; K5 launches {k5} = 4 x {L} x {want // (4 * L)}")
    return k5, summary


# ---------------------------------------------------------------------------
# The decoder's options, the CLIP tower, MPT
# ---------------------------------------------------------------------------

# A CuMo-class LLaVA (SURVEY.md): the CLIP-ViT-L/14-336 tower
# (openai/clip-vit-large-patch14-336: 24 layers, 1024 wide, 16 heads,
# 336 px, patch 14, 576 patches) with MoE MLPs of 4 experts, top-2, the
# MoE projector, and the mistralai/Mistral-7B-v0.1 decoder as its
# config.json gives it (hidden 4096, 32 layers, 32 heads over 8 KV
# heads, intermediate 14336, vocab 32000, rope_theta 10000, 32768
# positions, sliding_window 4096). Cut: random weights from --seed; the
# context length is set to the engine's 8192 slots.
HF_CUMO = dict(
    model_type="mistral", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=32768, sliding_window=4096,
    tie_word_embeddings=False,
    mm_vision_tower="openai/clip-vit-large-patch14-336", mm_hidden_size=1024,
    mm_projector_type="moe", moe_name="smoe", num_experts=4, num_selected=2,
    clip_smoe=True, mlp_smoe=True, scales=[1],
    vision_config=dict(hidden_size=1024, intermediate_size=4096,
                       num_hidden_layers=24, num_attention_heads=16,
                       image_size=336, patch_size=14),
    tokenizer_model_max_length=8192)
# the same families at a small width: GQA, window 16 under prompts of 100
CUMO_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, sliding_window=16,
                  mm_hidden_size=64,
                  vision_config=dict(hidden_size=64, intermediate_size=128,
                                     num_hidden_layers=2,
                                     num_attention_heads=2, image_size=28,
                                     patch_size=14))
# --engine-slots 8 --engine-max-len 8192 --engine-prefill-chunk 128
CUMO_ENGINE = dict(engine_slots=8, engine_max_len=8192, prefill_chunk=128)
CUMO_LONG = 5000              # a text prompt past the 4096-token window
# the mosaicml/mpt-7b geometry: d_model 4096, 32 heads, 32 layers,
# expansion 4, vocab 50432, no bias, ALiBi, tied embeddings, LayerNorm
# without bias (eps 1e-5), max_seq_len 2048
MPT_7B = dict(vocab_size=50432, hidden_size=4096, num_hidden_layers=32,
              num_attention_heads=32, num_key_value_heads=32,
              expansion_ratio=4, max_position_embeddings=2048,
              rms_norm_eps=1e-5, use_alibi=True,
              norm_type="layernorm_nobias", mlp_type="gelu",
              tie_word_embeddings=True, fused_qkv=True)
MPT_SMALL = dict(MPT_7B, vocab_size=512, hidden_size=256,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=4)
MPT_PROMPT = 512
# K5 at the projections of the two new decoders (k_proj = v_proj and
# gate_proj = up_proj in Mistral; one of each is timed)
K5_NEW_SHAPES = (("mistral q/o", 4096, 4096), ("mistral k/v", 4096, 1024),
                 ("mistral gate/up", 4096, 14336),
                 ("mistral down", 14336, 4096), ("mpt qkv", 4096, 12288),
                 ("mpt o", 4096, 4096), ("mpt up", 4096, 16384),
                 ("mpt down", 16384, 4096))
K5_PER_LAYER = {"mistral": (("mistral q/o", 2), ("mistral k/v", 2),
                            ("mistral gate/up", 2), ("mistral down", 1)),
                "mpt": (("mpt qkv", 1), ("mpt o", 1), ("mpt up", 1),
                        ("mpt down", 1))}


def k5_new_shapes(reps: int = 60):
    """K5 at the Mistral and MPT projection shapes, M 1 and 8, against its
    plain version, timed beside its bound and torch._weight_int4pack_mm
    (a measurement; no redesign). Returns the rows and each decoder
    layer's sums."""
    rows = phase_small_m(reps, kernels={"quant_small_m_matmul_int4": (
        "K5", (1, 8), ())}, shapes=K5_NEW_SHAPES)[0]
    layers = {}
    for model, parts in K5_PER_LAYER.items():
        for m in (1, 8):
            sel = [(r, n) for label, n in parts for r in rows
                   if r["proj"] == label and r["m"] == m]
            lib = [r["library_ms"] for r, _ in sel]
            layers[f"{model}_m{m}"] = dict(
                ms=sum(r["ms"] * n for r, n in sel),
                plain_ms=sum(r["plain_ms"] * n for r, n in sel),
                bound_ms=sum(r["bound_ms"] * n for r, n in sel),
                library_ms=None if None in lib else sum(
                    x * n for x, (_, n) in zip(lib, sel)))
    for key, v in layers.items():
        log(f"K5 {key}: one layer's projections {v['ms'] * 1e3:.2f} us, "
            f"bound {v['bound_ms'] * 1e3:.2f} us "
            f"({v['bound_ms'] / v['ms']:.1%}), plain "
            f"{v['plain_ms'] * 1e3:.2f} us, library "
            + (f"{v['library_ms'] * 1e3:.2f} us" if v["library_ms"]
               is not None else "n/a"))
    return dict(rows=rows, layers=layers, card=card_line())


def with_decoder(model, **changes):
    """Set decoder options on a LlavaModel in place (its config and its
    decoder's) and drop its solo programs, which were captured under the
    old options; returns the previous decoder config."""
    old = model.language_model.cfg
    new = dataclasses.replace(old, **changes)
    model.language_model.cfg = new
    model.cfg = dataclasses.replace(model.cfg, decoder=new)
    model.__dict__.pop("_solo_caches", None)
    return old


def set_quant_mode(model, mode: str):
    """Every int8 QuantDense of the decoder in `mode` ('int8' or 'w8a8':
    the same int8 weights), with its config; drops the solo programs."""
    from competesmoe_tpu_torch.models.decoder import QuantDense
    for mod in model.language_model.modules():
        if isinstance(mod, QuantDense) and mod.mode in ("int8", "w8a8"):
            mod.mode = mode
    with_decoder(model, quant=mode)


def decode_rows(model, ids, px=None, steps: int = 4, feed=None):
    """Logit rows [steps + 1, V] of one prompt through the model's own KV
    cache: the prefill's last row, then `steps` greedy steps (or the
    tokens `feed`). Returns (rows, the tokens fed)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache

    dev = model.device
    ids = np.asarray(ids, np.int64)[None]
    n_img = int(np.sum(ids == -200))
    length = ids.shape[1] + n_img * (model.cfg.num_image_tokens - 1)
    cache = KVCache.create(model.language_model.cfg, 1, length + steps + 1,
                           dev)
    with torch.no_grad():
        out = model(torch.as_tensor(ids, device=dev),
                    None if px is None else torch.as_tensor(px, device=dev),
                    cache=cache)
        rows, fed = [out.logits[0, -1].float().cpu()], []
        for i in range(steps):
            t = int(rows[-1].argmax()) if feed is None else int(feed[i])
            fed.append(t)
            out = model(torch.tensor([[t]], device=dev), None,
                        cache=out.cache)
            rows.append(out.logits[0, -1].float().cpu())
    return torch.stack(rows), fed


def no_cache_rows(model, ids, px, fed):
    """The same rows as `decode_rows` from one forward without a cache
    over the prompt and the fed tokens (the no-cache mask path)."""
    import torch

    dev = model.device
    full = np.concatenate([np.asarray(ids, np.int64),
                           np.asarray(fed, np.int64)])[None]
    with torch.no_grad():
        out = model(torch.as_tensor(full, device=dev),
                    None if px is None else torch.as_tensor(px, device=dev))
    return out.logits[0, -(len(fed) + 1):].float().cpu()


def small_cumo_check(seed: int):
    """The CuMo-class families at CUMO_SMALL (CLIP MoE tower, GQA decoder
    with window 16, --load-4bit, int8 KV) on a 100-token prompt with a
    28 px image, 4 greedy steps: the card's cache path against its
    no-cache path (the window on both masks) and against the CPU, within
    3% of the largest logit; without the window the rows move by more
    than 3% (the window bites). K5 at every decode projection."""
    import torch

    from competesmoe_tpu_torch.models.builder import (
        apply_load_4bit, build_llava, llava_config_from_hf)
    from competesmoe_tpu_torch.models.llava import LlavaModel
    from competesmoe_tpu_torch.models.vision import CLIPSMoEVisionTower
    from competesmoe_tpu_torch.ops.matvec import quant_small_m_matmul_int4

    cfg = llava_config_from_hf(dict(HF_CUMO, **CUMO_SMALL), "llava-mistral",
                               torch.bfloat16)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, kv_quant="int8"))
    cpu = apply_load_4bit(build_llava(cfg, seed=seed, device="cpu"))
    card = LlavaModel(cpu.cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    assert isinstance(card.vision_tower, CLIPSMoEVisionTower)
    rng = np.random.default_rng(seed + 21)
    ids = rng.integers(3, 512, 100)
    ids[5] = -200
    px = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)
    k5 = quant_small_m_matmul_int4.launches
    rows, fed = decode_rows(card, ids, px)
    k5 = quant_small_m_matmul_int4.launches - k5
    gaps = dict(cache_vs_no_cache=logits_gap(rows, no_cache_rows(card, ids,
                                                               px, fed)),
                card_vs_cpu=logits_gap(rows, decode_rows(cpu, ids, px,
                                                       feed=fed)[0]))
    with_decoder(card, sliding_window=None)
    unwindowed = logits_gap(decode_rows(card, ids, px, feed=fed)[0], rows)
    with_decoder(card, sliding_window=16)
    log(f"small CuMo-class (card, window 16, 100 + 3 tokens): " + "; ".join(
        f"{k} {g:.4g} (tol {t:.4g})" for k, (g, t) in gaps.items())
        + f"; without the window {unwindowed[0]:.4g}; K5 {k5}")
    for k, (g, t) in gaps.items():
        if not g <= t:
            raise AssertionError(f"small CuMo-class {k}: {g} > {t}")
    if not unwindowed[0] > unwindowed[1]:
        raise AssertionError(f"small CuMo-class: the window moves the rows "
                             f"by {unwindowed[0]} <= 3% ({unwindowed[1]})")
    # 4 decode steps x 7 projections x 2 layers (the prefill's 103 rows
    # take the plain halves)
    if k5 != 4 * 7 * 2:
        raise AssertionError(f"small CuMo-class: K5 launched {k5} times, "
                             f"not 56")
    return {k: g / t for k, (g, t) in gaps.items()}


def mpt_model(geometry: dict, seed: int, device: str, deferred=False,
              dtype=None):
    """An MPT DecoderLM of `geometry` with random weights from `seed`."""
    import torch

    from competesmoe_tpu_torch.models.builder import init_random_
    from competesmoe_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    cfg = DecoderConfig(**geometry, deferred_decode=deferred,
                        dtype=dtype or torch.bfloat16)
    return init_random_(DecoderLM(cfg, device=device), seed)


def mpt_reference_logits(model, ids):
    """MPT's forward written out apart from the port (float32): bias-free
    LayerNorm, the fused Wqkv, the ALiBi bias -slope_h x (i - j) with
    slope_h = 2^(-8 (h + 1) / H) (H a power of two), a causal softmax,
    the exact-GELU MLP and the tied head. [T, V] for ids [T]."""
    import torch

    cfg = model.cfg
    d, H = cfg.hidden_size, cfg.num_attention_heads
    p = d // H
    sd = {k: v.float() for k, v in model.state_dict().items()}

    def ln(x, w):
        return torch.nn.functional.layer_norm(x, (d,), w, None,
                                              cfg.rms_norm_eps)

    T = len(ids)
    x = sd["embed_tokens.weight"][torch.as_tensor(ids, device=model.
                                                  embed_tokens.weight.device)]
    i = torch.arange(T, device=x.device, dtype=torch.float32)
    slopes = 2.0 ** (-8.0 * torch.arange(1, H + 1, device=x.device) / H)
    bias = -slopes[:, None, None] * (i[:, None] - i[None, :])
    causal = i[None, :] <= i[:, None]
    for li in range(cfg.num_hidden_layers):
        pre = f"layers.{li}."
        h = ln(x, sd[pre + "input_layernorm.weight"])
        q, k, v = (h @ sd[pre + "self_attn.qkv_proj.weight"].T).split(d, -1)
        q, k, v = (t.reshape(T, H, p).transpose(0, 1) for t in (q, k, v))
        s = q @ k.transpose(1, 2) / math.sqrt(p) + bias
        s = s.masked_fill(~causal, float("-inf")).softmax(-1)
        o = (s @ v).transpose(0, 1).reshape(T, d)
        x = x + o @ sd[pre + "self_attn.o_proj.weight"].T
        h = ln(x, sd[pre + "post_attention_layernorm.weight"])
        h = torch.nn.functional.gelu(h @ sd[pre + "mlp.up_proj.weight"].T)
        x = x + h @ sd[pre + "mlp.down_proj.weight"].T
    return ln(x, sd["norm.weight"]) @ sd["embed_tokens.weight"].T


def mpt_decode(model, ids, steps: int, feed=None):
    """Prefill `ids` and take `steps` greedy steps (or feed `feed`)
    through the model's KV cache: (logit rows [steps + 1, V], tokens)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache

    dev = model.embed_tokens.weight.device
    cache = KVCache.create(model.cfg, 1, len(ids) + steps + 1, dev)
    with torch.no_grad():
        logits, cache, _ = model(torch.as_tensor(np.asarray(ids)[None],
                                                 device=dev), cache=cache)
        rows, toks = [logits[0, -1].float()], []
        for i in range(steps):
            t = int(rows[-1].argmax()) if feed is None else int(feed[i])
            toks.append(t)
            logits, cache, _ = model(torch.tensor([[t]], device=dev),
                                     cache=cache)
            rows.append(logits[0, -1].float())
    return torch.stack(rows).cpu(), toks


def small_mpt_check(seed: int):
    """MPT at a small width on the card: in float32, the port's logits
    against `mpt_reference_logits` and its cache decode, with and
    without deferred decode, against its own no-cache forward (within
    1e-3 of the largest logit); then bf16 with int4 projections, card
    (K5) against the CPU, deferred too (within 3%)."""
    import torch

    from competesmoe_tpu_torch.models.builder import quantize_decoder_to_int8
    from competesmoe_tpu_torch.models.decoder import DecoderLM

    rng = np.random.default_rng(seed + 22)
    ids = rng.integers(0, 512, 40)
    gaps = {}
    for deferred in (False, True):
        f32 = mpt_model(MPT_SMALL, seed, "cuda", deferred, torch.float32)
        rows, toks = mpt_decode(f32, ids, 6)
        with torch.no_grad():
            full = f32(torch.as_tensor(np.concatenate([ids, toks])[None],
                                       device="cuda"))[0][0].float()
        ref = mpt_reference_logits(f32, np.concatenate([ids, toks]))
        tag = "deferred" if deferred else "cache"
        gaps[f"f32 no-cache vs reference"] = logits_gap(full.cpu(),
                                                        ref.cpu())
        gaps[f"f32 {tag} vs no-cache"] = logits_gap(rows, full[-7:].cpu())
        cpu = quantize_decoder_to_int8(mpt_model(MPT_SMALL, seed, "cpu",
                                                 deferred), bits=4)
        card = DecoderLM(cpu.cfg, device="cuda")
        card.load_state_dict(cpu.state_dict())
        rows, toks = mpt_decode(card, ids, 6)
        gaps[f"int4 {tag} card vs cpu"] = logits_gap(
            rows, mpt_decode(cpu, ids, 6, feed=toks)[0])
    log("small MPT (card): " + "; ".join(f"{k} {g:.4g} (tol {t:.4g})"
                                         for k, (g, t) in gaps.items()))
    for k, (g, t) in gaps.items():
        tol = t if k.startswith("int4") else t / 30   # 1e-3 of the largest
        if not g <= tol:
            raise AssertionError(f"small MPT {k}: {g} > {tol}")
    return {k: g / t for k, (g, t) in gaps.items()}


def w8a8_exact_check():
    """w8a8's int32 products on the card at decode and prefill row counts
    against an exact float64 product of the same int8 operands: K 8192,
    a row of 127s against a column of 127s with one 126 gives an odd sum
    near 1.3e8, which float32 cannot hold."""
    import torch

    from competesmoe_tpu_torch.models.decoder import w8a8_accumulate

    g = torch.Generator().manual_seed(5)
    K, N = 8192, 256
    q = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    q[:, 0] = 127
    q[9, 0] = 126
    worst = 0
    for m in (1, 8, 17, 40, 128):
        x = torch.randn((m, K), generator=g).to(torch.bfloat16)
        x[0] = 3.0
        acc, amax = w8a8_accumulate(x.to("cuda"), q.to("cuda"))
        x8 = torch.round(x.float() * (127.0 / amax.cpu())).clamp(-127, 127)
        want = (x8.double() @ q.double()).long()
        if not torch.equal(acc.cpu().long(), want):
            raise AssertionError(f"w8a8 at M {m}: the int32 products differ "
                                 f"from the exact ones by up to "
                                 f"{int((acc.cpu().long() - want).abs().max())}")
        worst = max(worst, int(want.abs().max()))
    log(f"w8a8 (card): int32 products exact at M 1-128 (sums up to {worst})")


def fold_check(seed: int):
    """fold_norm_scales on the card, on a small model whose norm weights
    are drawn in [0.7, 1.3], against a folded copy (no-cache logits):
    float32 within 1e-4 of the largest logit, int8 within 3% (the fold
    requantizes; JAX's own test holds int8 to 0.1); int4, whose
    requantization onto 15 levels a column loses more, is reported
    only."""
    import copy

    import torch

    from competesmoe_tpu_torch.models.builder import (apply_load_4bit,
                                                      apply_load_8bit,
                                                      build_llava)
    from competesmoe_tpu_torch.models.decoder import RMSNorm, fold_norm_scales

    rng = np.random.default_rng(seed + 23)
    ids = torch.as_tensor(rng.integers(3, 512, (2, 24)), device="cuda")
    gaps = {}
    for kind, quantize in (("float32", None), ("int8", apply_load_8bit),
                           ("int4", apply_load_4bit)):
        cfg = served_config("int4", small=True)
        dtype = torch.float32 if kind == "float32" else torch.bfloat16
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, dtype=dtype))
        model = build_llava(cfg, seed=seed, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(seed)
        with torch.no_grad():
            for mod in model.language_model.modules():
                if isinstance(mod, RMSNorm):
                    mod.weight.copy_(0.7 + 0.6 * torch.rand(
                        mod.weight.shape, generator=g, device="cuda"))
        if quantize is not None:
            quantize(model)
        folded = copy.deepcopy(model.language_model)
        fold_norm_scales(folded)
        with torch.no_grad():
            want = model.language_model(ids)[0].float().cpu()
            got = folded(ids)[0].float().cpu()
        gaps[kind] = logits_gap(got, want)
        del model, folded
    log("fold_norm_scales (card): " + "; ".join(
        f"{k} {g:.4g} (3%: {t:.4g})" for k, (g, t) in gaps.items()))
    if not gaps["float32"][0] <= gaps["float32"][1] / 300:
        raise AssertionError(f"fold float32: {gaps['float32']}")
    if not gaps["int8"][0] <= gaps["int8"][1]:
        raise AssertionError(f"fold int8: {gaps['int8']}")
    return {k: g / t for k, (g, t) in gaps.items()}


def option_engines_check(seed: int):
    """Per-layer caches and deferred decode through the engine on a small
    --load-4bit model: two rounds (prompts, then turn-2 follow-ups that
    unpark) through engines with prefill chunks of 16 and 2 parked rows,
    stacked, per-layer and deferred: every first-token logit row of the
    per-layer engine equals the stacked engine's bit for bit and its
    streams are equal; the deferred engine's streams agree (the parting
    rule) and its first-token logits lie within 3%."""
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    model = build_served("int4", seed, "cuda", small=True)
    rng = np.random.default_rng(seed + 24)
    first = [np.resize(rng.integers(3, 512, int(rng.integers(3, 6))),
                       n).astype(np.int32) for n in (40, 12, 45, 9)]
    out = {}
    for name, opt in (("stacked", {}),
                      ("per_layer", dict(cache_layout="per_layer")),
                      ("deferred", dict(deferred_decode=True))):
        old = with_decoder(model, **opt)
        engine = record_first_logits(DecodeEngine(
            model, n_slots=4, max_len=256, prefill_chunk=16,
            prefix_cache_slots=2, run_thread=False))
        turn1 = drive_ticks(engine, [(p, None) for p in first], 8)
        follow = [np.concatenate([p, np.asarray(s, np.int32),
                                  np.asarray([7, 8, 9, 10], np.int32)])
                  for p, s in zip(first, turn1)]
        turn2 = drive_ticks(engine, [(p, None) for p in follow], 8)
        out[name] = dict(streams=turn1 + turn2, hits=engine._prefix_hits,
                         first=[first_logits(engine, p)
                                for p in first + follow])
        model.language_model.cfg = old
        model.cfg = dataclasses.replace(model.cfg, decoder=old)
    base = out["stacked"]
    pl = out["per_layer"]
    if pl["streams"] != base["streams"] or not all(
            bool((a == b).all()) for a, b in zip(pl["first"],
                                                 base["first"])):
        raise AssertionError("per-layer engine differs from the stacked "
                             "engine")
    if pl["hits"] != base["hits"] or base["hits"] < 2:
        raise AssertionError(f"prefix hits {pl['hits']} / {base['hits']}")
    prompts = first + follow
    parted = [agree(model, p, None, g, w, f"deferred engine {i}")
              for i, (p, g, w) in enumerate(zip(
                  prompts, out["deferred"]["streams"], base["streams"]))]
    gaps = [logits_gap(a, b) for a, b in zip(out["deferred"]["first"],
                                             base["first"])]
    hold_gaps(gaps, "deferred engine")
    log(f"option engines (card): per-layer first logits and streams equal "
        f"the stacked engine's ({base['hits']} unparks); deferred parted "
        f"{sum(p is not None for p in parted)} of {len(parted)} streams, "
        f"first-token gaps up to {max(g / t for g, t in gaps):.3g} of 3%")


def small_options_check(seed: int):
    """The small checks of this section, before the full-size phases
    (chip_faults.py plants six faults against them)."""
    return dict(cumo=small_cumo_check(seed), mpt=small_mpt_check(seed),
                fold=fold_check(seed), engines=option_engines_check(seed),
                w8a8=w8a8_exact_check())


def clip_tower_hf(tower, prefix: str):
    """A CLIPSMoEVisionTower's weights under the names `convert_clip_tower`
    reads (HF CLIP's, MoE MLPs as `moelayer.experts.<i>.fc1/fc2` with
    `moelayer.gate`): the writer's side of a CLIP checkpoint, which the
    port's export refuses (ROADMAP §3)."""
    from competesmoe_tpu_torch.models.hf_export import (_copy,
                                                        _unstack_expert_mlps)
    sd = tower.state_dict()
    out = {prefix + "embeddings.patch_embedding.weight":
           sd["embeddings.patch_embedding.weight"],
           prefix + "embeddings.class_embedding":
           sd["embeddings.class_embedding"],
           prefix + "embeddings.position_embedding.weight":
           sd["embeddings.position_embedding"]}
    _copy(out, prefix + "pre_layrnorm", sd, "pre_layrnorm")
    for li in range(tower.cfg.num_hidden_layers):
        p, q = f"layers.{li}.", f"{prefix}encoder.layers.{li}."
        for n in ("layer_norm1", "layer_norm2"):
            _copy(out, q + n, sd, p + n)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _copy(out, q + f"self_attn.{n}", sd, p + f"self_attn.{n}")
        _unstack_expert_mlps(out, sd, p + "moelayer.", q,
                             sequential_naming=False)
    return out


def phase_cumo(seed: int, new_tokens: int = 32):
    """The CuMo-class model at full width (HF_CUMO): built in bf16 from
    `seed`, written as a safetensors checkpoint in the reference's layout
    (CLIP names as convert_clip_tower reads them) into a directory named
    for Mistral, loaded through load_pretrained_model with --load-4bit
    --kv-quant int8. Solo: a 336 px image prompt, `new_tokens` greedy
    tokens, captured; K5 7 x 32 a decode step. Engine (CUMO_ENGINE): a
    CUMO_LONG-token text prompt (chunked, past the window) decodes
    `new_tokens` beside 3 image streams; K5 7 x 32 per viable forward.
    The long prompt's first-token logits against the decoder's no-cache
    forward over the same ids: at most a fifth of their gap to the
    forward without the window (the gaps, and the gap to the model's own
    int8 cache in the same chunks, are reported: bf16 and KV rounding
    through 32 random layers); `cumo_float32_window` holds the window's
    semantics to 3% without rounding; the long prompt's tokens against
    solo stream_generate's (the parting rule). Returns (K5 launches, the
    `cumo_summary` dict); the model is deleted."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.models.builder import (build_llava,
                                                      llava_config_from_hf,
                                                      load_pretrained_model)
    from competesmoe_tpu_torch.models.hf_export import (
        export_decoder, export_mlpmoe_projector)
    from competesmoe_tpu_torch.models.safetensors_io import save_file
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    t_phase = time.perf_counter()
    cfg = llava_config_from_hf(HF_CUMO, "llava-mistral-cumo",
                               torch.bfloat16)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cumo_"))
    ckpt = tmp / "llava-mistral-7b-clip-cumo"
    ckpt.mkdir()
    try:
        t0 = time.perf_counter()
        writer = build_llava(cfg, seed=seed, device="cuda")
        with torch.no_grad():
            sd = clip_tower_hf(writer.vision_tower,
                               "model.vision_tower.vision_tower.")
            sd.update(export_mlpmoe_projector(writer.mm_projector,
                                              "model.mm_projector."))
            sd.update(export_decoder(writer.language_model, cfg.decoder,
                                     "model."))
            path = save_file(sd, ckpt / "model.safetensors")
        (ckpt / "config.json").write_text(json.dumps(HF_CUMO))
        write_s, nbytes = time.perf_counter() - t0, path.stat().st_size
        del sd, writer
        free_card()
        t0 = time.perf_counter()
        model = load_pretrained_model(ckpt, load_4bit=True, kv_quant="int8",
                                      device="cuda")[1]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dec = model.cfg.decoder
    L = dec.num_hidden_layers
    if not (model.cfg.vision.tower_type == "clip" and not dec.fused_qkv
            and dec.sliding_window == HF_CUMO["sliding_window"]
            and dec.quant == "int4" and dec.kv_quant == "int8"
            and dec.num_key_value_heads == HF_CUMO["num_key_value_heads"]):
        raise AssertionError(f"CuMo-class config as loaded: {model.cfg}")
    log(f"CuMo-class: wrote {nbytes / 1e9:.2f} GB in {write_s:.1f} s, "
        f"--load-4bit --kv-quant int8 in {load_s:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    # solo: a 336 px image prompt, captured
    size = model.cfg.vision.image_size
    rng = np.random.default_rng(seed + 30)
    ids = rng.integers(3, dec.vocab_size, (1, 48)).astype(np.int32)
    ids[0, 8] = -200
    px = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    greedy_run(model, ids, px, new_tokens)          # captures
    reset_counts()                                  # main path starts
    toks, ttft, rest = greedy_run(model, ids, px, new_tokens)
    counts = read_counts()                          # main path ends
    steps = toks.shape[1] - 1
    solo_k5 = counts["quant_small_m_matmul_int4"]
    if solo_k5 != 7 * L * steps or sum(counts.values()) != solo_k5:
        raise AssertionError(f"CuMo-class solo launches {counts}: K5 must "
                             f"be 7 x {L} x {steps}")
    solo = dict(ttft_ms=ttft * 1e3, decode_tok_s=steps / rest,
                k5_per_step=solo_k5 // steps)
    log(f"CuMo-class solo: TTFT {ttft * 1e3:.1f} ms, {steps / rest:.2f} "
        f"tok/s, K5 {solo_k5 // steps} a decode step")
    # engine: the long prompt beside 3 image streams
    long_ids = rng.integers(3, dec.vocab_size, CUMO_LONG).astype(np.int32)
    reqs = [(long_ids, None)] + [
        (np.concatenate([rng.integers(3, dec.vocab_size, 8), [-200],
                         rng.integers(3, dec.vocab_size, 39)]).astype(
                             np.int32),
         rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32))
        for _ in range(3)]
    engine = record_first_logits(DecodeEngine(
        model, n_slots=CUMO_ENGINE["engine_slots"],
        max_len=CUMO_ENGINE["engine_max_len"],
        prefill_chunk=CUMO_ENGINE["prefill_chunk"], pipeline_depth=2,
        run_thread=False))
    fw = ForwardRows(model.language_model)
    fw.active = False
    drive_ticks(engine, [reqs[1]], 4)               # captures
    fw.active = True
    reset_counts()                                  # main path starts
    t0 = time.perf_counter()
    streams = drive_ticks(engine, reqs, new_tokens)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    counts = read_counts()                          # main path ends
    fw.remove()
    want = matvec_launches(model.language_model, fw.rows)
    eng_k5 = counts["quant_small_m_matmul_int4"]
    if eng_k5 != want or sum(counts.values()) != eng_k5:
        raise AssertionError(f"CuMo-class engine launches {counts}: K5 "
                             f"must be {want} (7 x {L} x viable forwards)")
    got = first_logits(engine, long_ids)
    del engine
    free_card()
    # the long prompt's first-token logits against the no-cache forward,
    # windowed and not: the served int8 cache (KV rounding through 32
    # random layers) must read far closer to the windowed one
    with torch.no_grad():
        ids_t = torch.as_tensor(long_ids[None], device="cuda",
                                dtype=torch.long)
        ref = model.language_model(ids_t)[0][0, -1].float().cpu()
        with_decoder(model, sliding_window=None)
        unwindowed = model.language_model(ids_t)[0][0, -1].float().cpu()
        with_decoder(model, sliding_window=dec.sliding_window)
    gaps = dict(engine_vs_own_cache=logits_gap(
        got, chunked_first_logits(model, long_ids,
                                  CUMO_ENGINE["prefill_chunk"])),
        engine_vs_no_cache=logits_gap(got, ref),
        engine_vs_unwindowed=logits_gap(got, unwindowed))
    if not gaps["engine_vs_no_cache"][0] * 5 < \
            gaps["engine_vs_unwindowed"][0]:
        raise AssertionError(f"CuMo-class long prompt: the engine's logits "
                             f"are not far closer to the windowed no-cache "
                             f"forward than to the unwindowed one: {gaps}")
    solo_long = greedy_run(model, long_ids[None], None, new_tokens)[0][0]
    parted = agree(model, long_ids, None, streams[0], solo_long.tolist(),
                   "CuMo-class long stream vs solo")
    summary = dict(
        card=card_line(), checkpoint_gb=nbytes / 1e9, write_s=write_s,
        load_4bit_s=load_s, solo=solo, engine_s=engine_s,
        engine_tok_s=sum(len(s) for s in streams) / engine_s,
        engine_k5=eng_k5, viable_forwards=want // (7 * L),
        long_first_logits_of_tol={k: g / t for k, (g, t) in gaps.items()},
        long_parted=parted, seconds=time.perf_counter() - t_phase)
    del model
    free_card()
    summary["float32_window"] = cumo_float32_window(seed, long_ids)
    log(f"CuMo-class engine: {engine_s:.2f} s for the long prompt and 3 "
        f"image streams, K5 {eng_k5} = 7 x {L} x {want // (7 * L)}; long "
        f"prompt's first-token logits (share of 3% of the largest): "
        + ", ".join(f"{k} {g / t:.3g}" for k, (g, t) in gaps.items())
        + f"; long stream vs solo: {'equal' if parted is None else parted}")
    return solo_k5 + eng_k5, summary


def cumo_float32_window(seed: int, ids):
    """The window's semantics at full width without rounding: HF_CUMO's
    decoder in float32 (random weights from `seed`, no KV quantization),
    `ids` prefilled through its cache in the engine's chunks against one
    forward without a cache (the no-cache mask), windowed (within 3% of
    the largest logit) and not (more than 3 x 3% away)."""
    import torch

    from competesmoe_tpu_torch.models.builder import (decoder_config_from_hf,
                                                      init_random_)
    from competesmoe_tpu_torch.models.decoder import DecoderLM, KVCache

    cfg = decoder_config_from_hf(HF_CUMO, "llava-mistral", torch.float32)
    model = init_random_(DecoderLM(cfg, device="cuda"), seed)
    ids = np.asarray(ids, np.int64)
    C = CUMO_ENGINE["prefill_chunk"]
    cache = KVCache.create(cfg, 1, len(ids) + 1, "cuda")
    with torch.no_grad():
        for i in range(0, len(ids), C):
            part = ids[i:i + C]
            x = np.zeros((1, C), np.int64)
            x[0, :len(part)] = part
            mask = torch.as_tensor((np.arange(C) < len(part))[None],
                                   device="cuda")
            logits, cache, _ = model(torch.as_tensor(x, device="cuda"),
                                     attention_mask=mask, cache=cache)
        cached = logits[0, len(part) - 1].float().cpu()
        ids_t = torch.as_tensor(ids[None], device="cuda")
        ref = model(ids_t)[0][0, -1].float().cpu()
        model.cfg = dataclasses.replace(cfg, sliding_window=None)
        unwindowed = model(ids_t)[0][0, -1].float().cpu()
    del model, cache
    free_card()
    gaps = dict(cache_vs_no_cache=logits_gap(cached, ref),
                cache_vs_unwindowed=logits_gap(cached, unwindowed))
    log("CuMo-class decoder in float32, the long prompt's first-token "
        "logits through the cache in chunks (share of 3% of the largest): "
        + ", ".join(f"{k} {g / t:.3g}" for k, (g, t) in gaps.items()))
    g, t = gaps["cache_vs_no_cache"]
    if not g <= t:
        raise AssertionError(f"float32 CuMo-class decoder: the cache path "
                             f"reads {g:.4g} from the windowed no-cache "
                             f"forward (> {t:.4g})")
    g, t = gaps["cache_vs_unwindowed"]
    if not g > 3 * t:
        raise AssertionError(f"float32 CuMo-class decoder: without the "
                             f"window the logits move only {g:.4g}")
    return {k: g / t for k, (g, t) in gaps.items()}


def phase_mpt(seed: int, new_tokens: int = 32):
    """MPT-7B at full width (MPT_7B): a DecoderLM with random bf16 weights
    from `seed`, written as an HF MptForCausalLM state dict by export_mpt,
    read back through convert_mpt into a second DecoderLM (every tensor
    equal), quantized to int4 (the tied embeddings stay bf16); a
    MPT_PROMPT-token prompt, then `new_tokens` greedy steps through the
    KV cache, K5 4 x 32 a step; then the same with deferred decode:
    equal tokens (or parting under the parting rule, reported). Returns
    (K5 launches, the `mpt_summary` dict); the model is deleted."""
    import torch

    from competesmoe_tpu_torch.models.builder import (_load_converted,
                                                      quantize_decoder_to_int8)
    from competesmoe_tpu_torch.models.decoder import DecoderLM
    from competesmoe_tpu_torch.models.hf_export import export_mpt
    from competesmoe_tpu_torch.models.hf_loader import convert_mpt

    t_phase = time.perf_counter()
    src = mpt_model(MPT_7B, seed, "cuda")
    cfg = src.cfg
    model = DecoderLM(cfg, device="meta")
    with torch.no_grad():
        hf = export_mpt(src, cfg)
        _load_converted(model, {k: v.clone() for k, v in
                                convert_mpt(hf, cfg).items()}, "cuda")
        bad = differing(model.state_dict(), src.state_dict())
    if bad:
        raise AssertionError(f"MPT export -> convert: {bad[:6]} differ")
    n_hf = len(hf)
    del hf, src
    free_card()
    quantize_decoder_to_int8(model, bits=4)
    L = cfg.num_hidden_layers
    ids = np.random.default_rng(seed + 31).integers(0, cfg.vocab_size,
                                                    MPT_PROMPT)
    runs = {}
    for deferred in (False, True):
        model.cfg = dataclasses.replace(model.cfg, deferred_decode=deferred)
        mpt_decode(model, ids[:64], 2)                  # first launches
        torch.cuda.synchronize()
        reset_counts()                                  # main path starts
        t0 = time.perf_counter()
        rows, toks = mpt_decode(model, ids, new_tokens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()                          # main path ends
        k5 = counts["quant_small_m_matmul_int4"]
        if k5 != 4 * L * new_tokens or sum(counts.values()) != k5:
            raise AssertionError(f"MPT launches {counts}: K5 must be 4 x "
                                 f"{L} x {new_tokens}")
        runs[deferred] = dict(rows=rows, toks=toks, k5=k5, seconds=seconds)
    base, dfr = runs[False], runs[True]
    j = next((i for i, (a, b) in enumerate(zip(dfr["toks"], base["toks"]))
              if a != b), None)
    parted = None
    if j is not None:
        top2 = base["rows"][j].topk(2).values
        margin = float(top2[0] - top2[1])
        tol = 0.03 * float(base["rows"][:j + 1].abs().max())
        if margin > tol:
            raise AssertionError(f"MPT deferred decode parts at step {j} "
                                 f"where the top-2 margin {margin:.4g} > "
                                 f"{tol:.4g}")
        parted = dict(step=j, margin=margin, tol=tol)
    summary = dict(card=card_line(), hf_tensors=n_hf,
                   k5_per_step=base["k5"] // new_tokens,
                   ms_per_step=base["seconds"] / (new_tokens + 1) * 1e3,
                   deferred_ms_per_step=dfr["seconds"] / (new_tokens + 1)
                   * 1e3, deferred_parted=parted,
                   tokens_equal=dfr["toks"] == base["toks"],
                   seconds=time.perf_counter() - t_phase)
    log(f"MPT-7B int4 (eager steps): prompt {MPT_PROMPT} + {new_tokens} "
        f"steps, {summary['ms_per_step']:.2f} ms a forward, K5 "
        f"{summary['k5_per_step']} a step; deferred "
        f"{summary['deferred_ms_per_step']:.2f} ms, tokens "
        f"{'equal' if parted is None else parted}")
    del model
    free_card()
    return base["k5"] + dfr["k5"], summary


def phase_serving_options(seed: int, model, want_tokens, new_tokens=32):
    """The decoder's serving options on the loaded 5.1B (`model`,
    --load-4bit --kv-quant int8; `want_tokens`: its greedy tokens of
    `model_prompt`): solo captured greedy runs with a per-layer cache
    (tokens equal to the default) and with deferred decode (parting from
    the default only under the parting rule: it adds the self column's
    share apart, rounded to bf16), then 12
    requests through int4 engines with a stacked and a per-layer cache
    (equal streams); a copy with fold_norm_scales (int4 requantized;
    parting from the default only under the parting rule); then the
    writer's bf16 weights (`served_config` from `seed`, equal to the bf16
    load) as --load-8bit's int8 model and the same weights in w8a8 mode
    (parting from int8 only under the rule). Returns (K5 launches of the
    per-layer engine, the `options_summary` dict)."""
    import copy

    import torch

    from competesmoe_tpu_torch.models.builder import apply_load_8bit
    from competesmoe_tpu_torch.models.decoder import fold_norm_scales
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    t_phase = time.perf_counter()
    ids, px = model_prompt(seed, model.cfg.decoder.vocab_size)
    L = model.cfg.decoder.num_hidden_layers
    out = {}
    for name, opt in (("deferred", dict(deferred_decode=True)),
                      ("per_layer", dict(cache_layout="per_layer"))):
        old = with_decoder(model, **opt)
        greedy_run(model, ids, px, new_tokens)           # captures
        toks, _, rest = greedy_run(model, ids, px, new_tokens)
        with_decoder(model, **{k: getattr(old, k) for k in opt})
        out[name] = dict(tok_s=(new_tokens - 1) / rest,
                         equal=toks[0].tolist() == want_tokens)
        # a per-layer cache computes the same products in the same
        # order; deferred decode adds the self column's share apart, in
        # bf16, so it may part at a near tie (the parting rule)
        if name == "per_layer" and not out[name]["equal"]:
            raise AssertionError(f"5.1B solo {name}: tokens {toks[0]} != "
                                 f"the default's {want_tokens}")
        out[name]["parted"] = agree(model, ids[0], px, toks[0].tolist(),
                                    want_tokens, f"5.1B solo {name}")
    reqs = engine_requests(np.random.default_rng(seed + 32),
                           model.cfg.decoder.vocab_size, 10, 2, 224)
    streams, k5 = {}, 0
    for name, opt in (("stacked", {}),
                      ("per_layer", dict(cache_layout="per_layer"))):
        old = with_decoder(model, **opt)
        engine = DecodeEngine(model, n_slots=8, max_len=512,
                              run_thread=False)
        fw = ForwardRows(model.language_model)      # before the captures
        fw.active = False
        drive_ticks(engine, reqs[:2], 4)                 # captures
        fw.active = True
        reset_counts()                                   # main path starts
        streams[name] = drive_ticks(engine, reqs, new_tokens)
        counts = read_counts()                           # main path ends
        fw.remove()
        want = matvec_launches(model.language_model, fw.rows)
        if counts["quant_small_m_matmul_int4"] != want:
            raise AssertionError(f"5.1B {name} engine launches {counts}, "
                                 f"K5 must be {want}")
        if name == "per_layer":
            k5 = want
        del engine
        with_decoder(model, cache_layout=old.cache_layout)
        free_card()
    if streams["per_layer"] != streams["stacked"]:
        raise AssertionError("5.1B per-layer engine streams differ from "
                             "the stacked engine's")
    folded = copy.deepcopy(model)
    fold_norm_scales(folded.language_model)
    folded.cfg = dataclasses.replace(folded.cfg,
                                     decoder=folded.language_model.cfg)
    toks = greedy_run(folded, ids, px, new_tokens)[0][0].tolist()
    out["folded"] = dict(parted=agree(model, ids[0], px, toks, want_tokens,
                                      "5.1B folded vs int4"))
    del folded
    free_card()
    m8 = apply_load_8bit(build_llava_served_bf16(seed))
    toks8 = greedy_run(m8, ids, px, new_tokens)[0][0].tolist()
    set_quant_mode(m8, "w8a8")
    greedy_run(m8, ids, px, new_tokens)                  # captures
    toks, _, rest = greedy_run(m8, ids, px, new_tokens)
    w8a8_tok_s = (new_tokens - 1) / rest
    set_quant_mode(m8, "int8")
    out["w8a8"] = dict(tok_s=w8a8_tok_s, parted=agree(
        m8, ids[0], px, toks[0].tolist(), toks8, "5.1B w8a8 vs int8"))
    del m8
    free_card()
    summary = dict(card=card_line(), solo=out,
                   engine_streams_equal=True, per_layer_engine_k5=k5,
                   seconds=time.perf_counter() - t_phase)
    log(f"5.1B serving options: per-layer solo tokens equal the "
        f"default's ({out['per_layer']['tok_s']:.1f} tok/s), deferred "
        f"{out['deferred']['parted'] or 'equal'} "
        f"({out['deferred']['tok_s']:.1f} tok/s); per-layer engine streams "
        f"equal the stacked engine's (K5 {k5}); folded "
        f"{out['folded']['parted'] or 'equal'}; w8a8 "
        f"{out['w8a8']['parted'] or 'equal'} vs int8 "
        f"({w8a8_tok_s:.1f} tok/s)")
    return k5, summary


def build_llava_served_bf16(seed: int):
    """The 5.1B writer's bf16 weights from `seed` (equal to the bf16
    load of phase_checkpoint's checkpoint), int8 KV, on the card."""
    from competesmoe_tpu_torch.models.builder import build_llava
    return build_llava(served_config("int4", small=False), seed=seed,
                       device="cuda")


def settle_eval_bound(seed: int):
    """The full-size loglikelihood bound (ROADMAP §3): phase_eval's
    EVAL_LL_DOCS documents on the 5.1B in float32 (the writer's weights
    from `seed` before rounding to bf16), at batch EVAL_LL_BATCH and at
    batch 1, each total against the model's own label splice: image rows
    and text rows, as a share of the splice's 3% tolerance. Both batches
    must hold EVAL_LOGIT_TOL (3%); the summary says how far each row
    class reads."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.models.builder import build_llava

    cfg = served_config("int4", small=False)
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, dtype=torch.float32),
        projector=dataclasses.replace(cfg.projector, dtype=torch.float32),
        decoder=dataclasses.replace(cfg.decoder, dtype=torch.float32,
                                    kv_quant=None))
    model = build_llava(cfg, seed=seed, device="cuda")
    tok = EvalTok(cfg.decoder.vocab_size)
    ll_docs = pope_docs(seed + 5, EVAL_LL_DOCS, cfg.vision.image_size,
                        text_every=2)
    for d in ll_docs:
        d["target"] = d["answer"]
    _, ll = register_eval_tasks("card_eval_f32", [], ll_docs, False)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_f32_"))
    t0 = time.perf_counter()
    try:
        splice = {d: spliced_loglikelihood(model, tok, ll, d,
                                           EVAL_LOGIT_TOL)
                  for d in range(EVAL_LL_DOCS)}
        out = {}
        for batch in (EVAL_LL_BATCH, 1):
            got = lls(eval_run(tok, model, tasks=ll, batch_size=batch,
                               world_size=1, rank=0,
                               output_path=tmp / f"b{batch}.json"), ll)
            gaps = {d: abs(got[d][0] - splice[d][0]) / splice[d][2]
                    for d in splice}
            image = [g for d, g in gaps.items()
                     if ll_docs[d].get("image") is not None]
            text = [g for d, g in gaps.items()
                    if ll_docs[d].get("image") is None]
            out[f"b{batch}"] = dict(image_max=max(image),
                                    text_max=max(text))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model
    free_card()
    summary = dict(card=card_line(), float32=out,
                   seconds=time.perf_counter() - t0)
    log("eval bound in float32 (share of the 3% tolerance): " + "; ".join(
        f"batch {k[1:]} image rows {v['image_max']:.3g}, text rows "
        f"{v['text_max']:.3g}" for k, v in out.items()))
    worst = max(max(v.values()) for v in out.values())
    if not worst <= 1.0:
        raise AssertionError(f"float32 loglikelihoods part from the splice "
                             f"by {worst:.3g} of the 3% tolerance: an "
                             f"offset, not rounding")
    return summary


# ---------------------------------------------------------------------------
# The multimodal routers and Mixtral's MoE decoder
# ---------------------------------------------------------------------------

# the five routers of moe/layers.py beside smoe and competesmoe
MM_ROUTERS = ("smoe_sigmoidgating", "xmoe", "smoe_perturbed", "smoe_share",
              "deepseekv3")
# one small sft step card against CPU (the CPU replaying the card's top-k
# choices, the flips within SMALL_MM_FLIP_SHARE and SMALL_MM_FLIP_GAP):
# |loss gap| and |grad_norm gap| / grad_norm
SMALL_ROUTER_LOSS_TOL = 5e-3
SMALL_ROUTER_GRAD_TOL = 2e-3
# router_definition_check: max |layer - definition| / max |definition| by
# the layer's activation dtype, and the score by which a choice of the
# layer may fall short of an expert it left out (a near tie)
ROUTER_DEF_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
ROUTER_TIE = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
# the 5.1B sft step of each router: one warm-up step, then timed ones
MM_ROUTER_STEPS = 3
# the decoder fields of mistralai/Mixtral-8x7B-v0.1's config.json (vocab
# 32000, hidden 4096, intermediate 14336, 32 heads over 8 KV heads, 8
# local experts, 2 a token, rope_theta 1e6, rms_norm_eps 1e-5, 32768
# positions, no sliding window, untied head) under HF_CUMO's
# CLIP-ViT-L/14-336 MoE tower and MoE projector. Cut: 12 of its 32 layers
# (one layer is 1.451 B parameters, so all 32 take 93 GB in bf16; JAX
# quantizes no expert either) and random weights from --seed.
HF_CUMO_MIXTRAL = dict(
    HF_CUMO, model_type="mixtral", num_hidden_layers=12, rope_theta=1e6,
    sliding_window=None, num_local_experts=8, num_experts_per_tok=2,
    tokenizer_model_max_length=2048)
MIXTRAL_SMALL = dict(HF_CUMO_MIXTRAL, **dict(CUMO_SMALL,
                                             sliding_window=None))
# the Mixtral cell's engine: slots, max_len, requests (of them with an
# image), tokens a request
MIXTRAL_ENGINE = dict(slots=8, max_len=2048, requests=12, images=4,
                      new_tokens=32)


def router_definition(name: str, layer, x, sel):
    """The output of router `name` on x [B, N, d] from the definitions of
    the reference's layers, in float64 on the CPU from `layer`'s weights,
    routed by `sel` (the layer's own choices): (output, the scores the
    choices are the top-k of). Written apart from moe/layers.py: the gate
    (x Wg; the cosine routers' reduced x against expert embeddings renormed
    to 1.5 / (norm + theta), the input's norm offset by theta in the
    perturbed one, softmax at temperature 0.3), the combine weights
    (renormalised top-k; the cosine routers' softmax of the chosen
    scores), the experts (Linear, exact GELU, Linear; Mixtral's
    silu(x w1) * (x w3) then w2) and the shared expert (the last; 0.5 x
    shared + 0.5 x routed for smoe_share, shared + routed for
    deepseekv3)."""
    import torch
    import torch.nn.functional as F

    w = {k: v.detach().double().cpu() for k, v in layer.named_parameters()}
    x = x.detach().double().cpu()
    sel = sel.detach().long().cpu()
    if name == "mixtral":
        def expert(e):
            return (F.silu(x @ w["experts_w1"][e]) * (x @ w["experts_w3"][e])
                    ) @ w["experts_w2"][e]
    else:
        def expert(e):
            h = F.gelu(x @ w["experts_w1"][e] + w["experts_b1"][e])
            return h @ w["experts_w2"][e] + w["experts_b2"][e]
    if name in ("xmoe", "smoe_perturbed"):
        theta = 0.1 if name == "smoe_perturbed" else 0.0
        r = x @ w["inp_reduction"]
        emb = w["expert_embeddings"]
        emb = emb * (1.5 / (emb.norm(dim=-1, keepdim=True) + theta))
        rn = r.norm(dim=-1, keepdim=True)
        r = r / (rn + theta) if theta else r / rn.clamp(min=1e-4)
        scores = torch.softmax(r @ emb.t() / 0.3, dim=-1)
        weights = torch.softmax(scores.gather(-1, sel), dim=-1)
    else:
        logits = x @ w["gate_kernel"]
        scores = (torch.sigmoid(logits) if name == "smoe_sigmoidgating"
                  else torch.softmax(logits, dim=-1))
        top = scores.gather(-1, sel)
        weights = top / top.sum(dim=-1, keepdim=True)
    routed_experts = scores.shape[-1]
    outs = torch.stack([expert(e) for e in range(routed_experts)], dim=-2)
    picked = outs.gather(-2, sel[..., None].expand(*sel.shape,
                                                   outs.shape[-1]))
    out = (picked * weights[..., None]).sum(dim=-2)
    if name == "smoe_share":
        out = 0.5 * expert(routed_experts) + 0.5 * out
    elif name == "deepseekv3":
        out = expert(routed_experts) + out
    return out, scores


def top_k_consistent(scores, sel, tie: float) -> bool:
    """Every row's chosen experts score at least as high as any expert it
    left out, less `tie`."""
    import torch

    chosen = torch.zeros_like(scores, dtype=torch.bool).scatter_(
        -1, sel.long(), True)
    kth = scores.gather(-1, sel.long()).min(dim=-1).values
    other = scores.masked_fill(chosen, float("-inf")).max(dim=-1).values
    return bool((kth >= other - tie).all())


def router_definition_check(seed: int):
    """Each router of MM_ROUTERS and Mixtral's block, a layer of width 64
    (128 expert hidden; 4 experts, Mixtral 8; weights N(0, 0.1) from
    `seed`) on the card, against `router_definition`: float32
    activations (Mixtral bf16, which its grouped products take on the
    card); its choices the top-k of the definition's scores (near ties
    excepted) and its output within ROUTER_DEF_TOL of the definition's.
    Returns {router: relative error}."""
    import torch

    from competesmoe_tpu_torch.models.builder import init_random_
    from competesmoe_tpu_torch.moe.registry import get_moe

    out = {}
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name in MM_ROUTERS + ("mixtral",):
        mixtral = name == "mixtral"
        layer = get_moe(name)(64, 64, n_experts=8 if mixtral else 4,
                              n_selected=2, expert_hidden_dim=128,
                              device="cuda")
        init_random_(layer, seed, std=0.1)
        x = torch.randn((2, 48, 64), generator=g, device="cuda")
        if mixtral:
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            got, aux = layer(x, return_id_experts=True)
        want, scores = router_definition(name, layer, x,
                                         aux.selected_experts)
        dt = str(x.dtype).split(".")[-1]
        err = float((got.double().cpu() - want).abs().max()
                    / want.abs().max())
        out[name] = err
        if not top_k_consistent(scores, aux.selected_experts.cpu(),
                                ROUTER_TIE[dt]):
            raise AssertionError(f"router {name}: the layer's choices are "
                                 f"not the top-k of its definition's scores")
        if not err <= ROUTER_DEF_TOL[dt]:
            raise AssertionError(f"router {name}: output {err:.3g} x max "
                                 f"off its definition (tol "
                                 f"{ROUTER_DEF_TOL[dt]})")
    log(f"router definitions ({card_line()}): " + ", ".join(
        f"{k} {v:.3g}" for k, v in out.items()))
    return out


def small_router_config(name: str):
    """The small multimodal model (SMALL_HF, SigLIP) with router `name` in
    the tower and the projector, or, for 'mixtral', MIXTRAL_SMALL (a CLIP
    tower, smoe, a 2-layer Mixtral decoder of 8 experts); bf16."""
    import torch

    from competesmoe_tpu_torch.models.builder import llava_config_from_hf
    if name == "mixtral":
        return llava_config_from_hf(MIXTRAL_SMALL, "llava-mixtral",
                                    torch.bfloat16)
    cfg = small_mm_config()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, moe_name=name),
        projector=dataclasses.replace(cfg.projector, moe_name=name))


def telemetry_consistent(auxes, what: str):
    """The eval adapter's telemetry of `auxes` against their selections:
    top-1 histograms count the first choices, a top-2 histogram exists
    exactly where two experts are chosen, and the choices are the top-k
    of the reported distribution (near ties excepted)."""
    import torch

    from competesmoe_tpu_torch.eval.llava_adapter import routing_telemetry
    tele = routing_telemetry(auxes)
    for li, aux in enumerate(auxes):
        row = tele[f"layer_{li}"]
        sel = aux.selected_experts.reshape(-1, aux.selected_experts.shape[
            -1]).cpu()
        probs = aux.gate_softmax.reshape(-1, aux.gate_softmax.shape[-1])
        n = probs.shape[-1]
        if (row["top1_hist"] != torch.bincount(sel[:, 0], minlength=n)
                .tolist()
                or (row["top2_hist"] is None) != (sel.shape[1] == 1)
                or not top_k_consistent(probs.float().cpu(), sel, 2.0 ** -6)):
            raise AssertionError(f"{what} layer {li}: telemetry {row} does "
                                 f"not match the selections")
    return tele


def small_router_check(name: str, seed: int):
    """A small model of `small_router_config(name)` on the card against
    the same weights on the CPU, the CPU replaying the card's top-k
    choices (`routed_as`): 5 logit rows (prefill with an image and 4
    greedy steps) within 3% of the largest; one sft step's loss within
    SMALL_ROUTER_LOSS_TOL and grad_norm within SMALL_ROUTER_GRAD_TOL, the
    CPU's own choices parting on at most SMALL_MM_FLIP_SHARE of the rows
    within SMALL_MM_FLIP_GAP; the card's routing telemetry consistent
    with its selections; for Mixtral 8 greedy tokens of a captured decode
    equal to eager ones. Returns the gaps."""
    import torch

    from competesmoe_tpu_torch.models.builder import build_llava
    from competesmoe_tpu_torch.models.llava import LlavaModel

    cfg = small_router_config(name)
    cpu = build_llava(cfg, seed=seed, device="cpu")
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = LlavaModel(cfg, device="cuda")
    card.load_state_dict(init)
    choices = []
    with routed_as(record=choices):
        rows_card, fed = logit_rows(card, seed)
    with routed_as(replay=choices):
        rows_cpu, _ = logit_rows(cpu, seed, fed)
    err = float((rows_card - rows_cpu).abs().max())
    tol = 0.03 * float(rows_cpu.abs().max())
    if not (torch.isfinite(rows_card).all() and err <= tol):
        raise AssertionError(f"small {name}: card logits {err:.4g} off the "
                             f"CPU's (tol {tol:.4g})")
    batch = small_mm_batch(seed)
    choices = []
    with routed_as(record=choices):
        got = small_mm_steps(card, False, 1, batch, steps=1)[0]
    cpu.load_state_dict(init)
    with routed_as(replay=choices) as seen:
        want = small_mm_steps(cpu, False, 1, batch, steps=1)[0]
    dl = abs(got["loss/total"] - want["loss/total"])
    dg = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    share = seen["flipped"] / max(seen["rows"], 1)
    res = dict(logits_err=err, logits_tol=tol, loss_gap=dl, grad_gap=dg,
               topk_share=share, topk_gap=seen["gap"])
    log(f"small {name} (card vs CPU): logits {err:.4g} (tol {tol:.4g}); "
        f"sft step loss {got['loss/total']:.6f} vs {want['loss/total']:.6f}"
        f" (gap {dl:.3g}, tol {SMALL_ROUTER_LOSS_TOL}), grad_norm gap "
        f"{dg:.3g} (tol {SMALL_ROUTER_GRAD_TOL}); the CPU's own top-k "
        f"differs on {share:.3%} of the rows, score gap {seen['gap']:.3g}")
    if not (math.isfinite(got["loss/total"]) and dl <= SMALL_ROUTER_LOSS_TOL
            and dg <= SMALL_ROUTER_GRAD_TOL
            and share <= SMALL_MM_FLIP_SHARE
            and seen["gap"] <= SMALL_MM_FLIP_GAP):
        raise AssertionError(f"small {name}: the sft step's card and CPU "
                             f"disagree: {res}")
    card.load_state_dict(init)
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(3, 512, (2, 20))
    ids[:, 4] = -200
    px = rng.uniform(-1, 1, (2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        out = card(torch.as_tensor(ids, device="cuda"),
                   torch.as_tensor(px, device="cuda"),
                   return_id_experts=True)
    telemetry_consistent(out.vision_auxes + [out.projector_aux],
                         f"small {name}")
    if name == "mixtral":
        ids1, px1 = ids[:1].astype(np.int32), px[:1]
        greedy_run(card, ids1, px1, 8)                      # captures
        captured = greedy_run(card, ids1, px1, 8)[0]
        eager = greedy_run(card, ids1, px1, 8, cuda_graphs=False)[0]
        if not np.array_equal(captured, eager):
            raise AssertionError(f"small Mixtral: captured decode "
                                 f"{captured.tolist()} != eager "
                                 f"{eager.tolist()}")
        res["captured_tokens"] = captured[0].tolist()
        log(f"small Mixtral: 8 captured decode tokens equal the eager ones")
    del card, cpu
    free_card()
    return res


def small_routers_check(seed: int):
    """`router_definition_check`, then `small_router_check` for each of
    MM_ROUTERS and the small Mixtral-decoder model (chip_faults.py plants
    router faults against these)."""
    out = dict(definitions=router_definition_check(seed))
    for name in MM_ROUTERS + ("mixtral",):
        out[name] = small_router_check(name, seed)
    return out


def _router_row(step, m, seconds, tokens, peak):
    return dict(step=step, wall_ms=seconds * 1e3,
                tokens_per_s=tokens / seconds,
                loss=float(m["loss/total"]), aux_mlp=float(m["loss/aux_mlp"]),
                aux_clip=float(m["loss/aux_clip"]),
                grad_norm=float(m["grad_norm"]), peak_gib=peak / 2 ** 30)


def phase_mm_routers(seed: int):
    """The 5.1B (HF_5P1B, full width and depth, bf16 weights from `seed`)
    with each router of MM_ROUTERS in its tower and projector, built from
    its config (JAX cannot load four of them from a checkpoint either;
    `smoe_sigmoidgating` is written as a checkpoint whose config.json
    names it and loaded back first), through cli.train_mm.train with
    MM_FULL_FLAGS at MM_BATCH rows of 2048 positions for MM_ROUTER_STEPS
    steps (the first a warm-up). Every number finite, within the 80 GB
    card; the projector's, the tower's and the decoder's weights move;
    then one `return_id_experts` forward of 2 image rows whose telemetry
    matches its selections. No kernel of K1-K5 on this path. Returns
    {router: summary}."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.cli.train_mm import train
    from competesmoe_tpu_torch.models.builder import (HF_5P1B, build_llava,
                                                      llava_config_from_hf,
                                                      load_pretrained_model)
    from competesmoe_tpu_torch.models.hf_export import save_hf_checkpoint

    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_routers_"))
    try:
        for name in MM_ROUTERS:
            free_card()
            held = torch.cuda.memory_allocated()
            hf = dict(HF_5P1B, moe_name=name)
            cfg = llava_config_from_hf(hf, "llava_phi", torch.bfloat16)
            t0 = time.perf_counter()
            model = build_llava(cfg, seed=seed, device="cuda")
            torch.cuda.synchronize()
            res = dict(build_s=time.perf_counter() - t0, rows=[])
            if name == "smoe_sigmoidgating":
                ckpt = tmp / "llava-phi-sigmoidgating"
                t0 = time.perf_counter()
                path = save_hf_checkpoint(model, cfg, ckpt, hf_config=hf)
                res["write_s"] = time.perf_counter() - t0
                res["checkpoint_gb"] = path.stat().st_size / 1e9
                del model
                free_card()
                t0 = time.perf_counter()
                model = load_pretrained_model(ckpt, dtype=torch.bfloat16,
                                              device="cuda")[1]
                torch.cuda.synchronize()
                res["load_s"] = time.perf_counter() - t0
                shutil.rmtree(ckpt)
                if model.cfg.projector.moe_name != name:
                    raise AssertionError(f"{name}: loaded {model.cfg}")
            probes = {
                "projector": model.mm_projector.moelayer.experts_w1,
                "vision": model.vision_tower.layers[0].moelayer.experts_w1,
                "decoder": model.language_model.layers[
                    0].self_attn.qkv_proj.weight}
            before = {k: p.detach()[0, :64].clone()
                      for k, p in probes.items()}
            tok = ChatTok(cfg.decoder.vocab_size)
            data = MMConversations(tok, 12, (150, 400),
                                   cfg.vision.image_size, seed, 2048)
            tokens = MM_BATCH * cfg.tokenizer_model_max_length
            t_step = [0.0]

            def record(step, state, m, seconds):
                torch.cuda.synchronize()
                row = _router_row(step, m, time.perf_counter() - t_step[0],
                                  tokens,
                                  torch.cuda.max_memory_allocated() - held)
                res["rows"].append(row)
                torch.cuda.reset_peak_memory_stats()
                t_step[0] = time.perf_counter()

            reset_counts()
            flags = MM_FULL_FLAGS + [
                "--per-device-batch-size", str(MM_BATCH),
                "--num-train-steps", str(MM_ROUTER_STEPS), "--seed",
                str(MM_SEED), "--moe-name", name]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t_step[0] = time.perf_counter()
            train(mm_args(flags, tmp / name), model, data, tok,
                  on_step=record, final_save=False)
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            for row in res["rows"]:
                nums = [row[k] for k in ("loss", "aux_mlp", "aux_clip",
                                         "grad_norm")]
                if not all(math.isfinite(v) for v in nums):
                    raise AssertionError(f"{name}: a number is not finite: "
                                         f"{row}")
                if row["peak_gib"] * 2 ** 30 + held > 80e9:
                    raise AssertionError(f"{name}: past the card's 80 GB: "
                                         f"{row}")
            moved = {k: not torch.equal(before[k], p.detach()[0, :64])
                     for k, p in probes.items()}
            if not all(moved.values()):
                raise AssertionError(f"{name}: weights did not move: "
                                     f"{moved}")
            if any(counts.values()):
                raise AssertionError(f"{name} launched kernels: {counts}")
            timed = res["rows"][1:]
            res.update(
                ms_per_step=float(np.mean([r["wall_ms"] for r in timed])),
                tokens_per_s=float(np.mean([r["tokens_per_s"]
                                            for r in timed])),
                peak_gib=max(r["peak_gib"] for r in res["rows"]),
                held_gib=held / 2 ** 30, moved=moved, launches=counts,
                last_peak_gib=peak / 2 ** 30)
            rng = np.random.default_rng(seed + 5)
            ids = rng.integers(3, cfg.decoder.vocab_size, (2, 64))
            ids[:, 8] = -200
            px = rng.uniform(-1, 1, (2, cfg.vision.image_size,
                                     cfg.vision.image_size, 3)).astype(
                                         np.float32)
            with torch.no_grad():
                o = model(torch.as_tensor(ids, device="cuda"),
                          torch.as_tensor(px, device="cuda"),
                          return_id_experts=True)
            tele = telemetry_consistent(o.vision_auxes + [o.projector_aux],
                                        f"5.1B {name}")
            last = tele[f"layer_{len(tele) - 1}"]
            res["projector_telemetry"] = dict(
                entropy=last["entropy"], top1_hist=last["top1_hist"],
                top2_hist=last["top2_hist"])
            log(f"5.1B {name} sft ({card_line()}): "
                f"{res['ms_per_step']:.1f} ms a step over steps 1-"
                f"{MM_ROUTER_STEPS - 1}, {res['tokens_per_s']:.0f} tok/s, "
                f"peak {res['peak_gib']:.2f} GiB above {res['held_gib']:.2f}"
                f"; losses {[round(r['loss'], 5) for r in res['rows']]}, "
                f"aux_mlp {res['rows'][-1]['aux_mlp']:.4g}, aux_clip "
                f"{res['rows'][-1]['aux_clip']:.4g}; projector telemetry "
                f"{res['projector_telemetry']}")
            out[name] = res
            del model, probes, o
            free_card()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def mixtral_layer_hf(layer, q: str):
    """A Mixtral `DecoderLayer`'s weights under HF Mixtral's names at layer
    prefix `q`: the writer's side of the checkpoint (the port's export
    refuses a MoE decoder, as JAX's fails on one)."""
    sd = layer.state_dict()
    out = {f"{q}{n}.weight": sd[f"{n}.weight"] for n in (
        "input_layernorm", "post_attention_layernorm", "self_attn.q_proj",
        "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj")}
    bp = q + "block_sparse_moe."
    out[bp + "gate.weight"] = sd["moe.gate_kernel"].t()
    for w in ("w1", "w3", "w2"):
        for j, t in enumerate(sd[f"moe.experts_{w}"]):
            out[f"{bp}experts.{j}.{w}.weight"] = t.t()
    return out


def write_mixtral_checkpoint(path: Path, hf: dict, seed: int):
    """HF_CUMO_MIXTRAL's checkpoint in the reference's layout, one shard a
    part, streamed: the tower, the projector, the embeddings and head,
    then each decoder layer is built on the card with random weights
    (its own seed from `seed`), written and dropped, so the card never
    holds more than one layer. Returns the bytes written."""
    import torch

    from competesmoe_tpu_torch.models.builder import (init_random_,
                                                      llava_config_from_hf)
    from competesmoe_tpu_torch.models.decoder import DecoderLayer
    from competesmoe_tpu_torch.models.hf_export import \
        export_mlpmoe_projector
    from competesmoe_tpu_torch.models.projector import VisionProjector
    from competesmoe_tpu_torch.models.safetensors_io import save_file
    from competesmoe_tpu_torch.models.vision import CLIPSMoEVisionTower

    cfg = llava_config_from_hf(hf, "llava-mixtral", torch.bfloat16)
    dec = cfg.decoder
    path.mkdir(parents=True)
    shards = []

    def shard(sd):
        with torch.no_grad():
            shards.append(save_file(
                sd, path / f"model-{len(shards):05d}.safetensors"))

    tower = init_random_(CLIPSMoEVisionTower(cfg.vision, "cuda"), seed)
    shard(clip_tower_hf(tower, "model.vision_tower.vision_tower."))
    del tower
    proj = init_random_(VisionProjector(cfg.projector, "cuda"), seed + 1)
    shard(export_mlpmoe_projector(proj, "model.mm_projector."))
    del proj
    g = torch.Generator(device="cuda").manual_seed(seed + 2)

    def normal(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(
            torch.bfloat16)
    shard({"model.embed_tokens.weight": normal(dec.vocab_size,
                                               dec.hidden_size),
           "model.norm.weight": torch.ones(dec.hidden_size,
                                           dtype=torch.bfloat16,
                                           device="cuda"),
           "lm_head.weight": normal(dec.vocab_size, dec.hidden_size)})
    for li in range(dec.num_hidden_layers):
        layer = init_random_(DecoderLayer(dec, "cuda"), seed + 3 + li)
        shard(mixtral_layer_hf(layer, f"model.layers.{li}."))
        del layer
    (path / "config.json").write_text(json.dumps(hf))
    return sum(p.stat().st_size for p in shards)


def mixtral_requests(rng, vocab: int, size: int):
    """MIXTRAL_ENGINE's requests: `images` 48-token prompts with the image
    sentinel at 8 and a `size` px image, the rest text of 20-150 tokens."""
    n_img, n = MIXTRAL_ENGINE["images"], MIXTRAL_ENGINE["requests"]
    return engine_requests(rng, vocab, n - n_img, n_img, size)


def phase_mixtral(seed: int):
    """The CLIP + Mixtral-8x7B cell (HF_CUMO_MIXTRAL) at full width:
    written by `write_mixtral_checkpoint` into TMPDIR, loaded through
    load_pretrained_model with --load-4bit --kv-quant int8 (the experts
    and the gate stay bf16, as in JAX; K5 at q, k, v and o). Solo: a 336
    px image prompt, 32 greedy tokens, captured (main path: K5 4 x 12 a
    decode step) beside eager (equal, or parting only under the parting
    rule); one profiled replay of the captured decode step shows
    qmm4_kernel 4 x 12 times. Engine (MIXTRAL_ENGINE): 12 requests of 32
    tokens, 4 with an image, captured (main path: K5 4 x 12 a viable
    forward) beside eager, every stream equal or parting under the rule.
    Returns (K5 launches, the `mixtral_summary` dict)."""
    import tempfile

    import torch

    from competesmoe_tpu_torch.models.builder import load_pretrained_model
    from competesmoe_tpu_torch.models.decoder import QuantDense
    from competesmoe_tpu_torch.serve.engine import DecodeEngine

    t_phase = time.perf_counter()
    free_card()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mixtral_"))
    ckpt = tmp / "llava-mixtral-8x7b-clip-cut12"
    try:
        t0 = time.perf_counter()
        nbytes = write_mixtral_checkpoint(ckpt, HF_CUMO_MIXTRAL, seed)
        write_s = time.perf_counter() - t0
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = load_pretrained_model(ckpt, load_4bit=True, kv_quant="int8",
                                      device="cuda")[1]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dec = model.cfg.decoder
    L = dec.num_hidden_layers
    lay = model.language_model.layers[0]
    if not (dec.moe_name == "mixtral" and dec.quant == "int4"
            and dec.kv_quant == "int8" and L == 12
            and model.cfg.vision.tower_type == "clip"
            and isinstance(lay.self_attn.q_proj, QuantDense)
            and lay.moe.experts_w1.dtype == torch.bfloat16
            and tuple(lay.moe.experts_w1.shape) == (8, 4096, 14336)):
        raise AssertionError(f"Mixtral cell as loaded: {model.cfg}")
    held = torch.cuda.memory_allocated()
    log(f"Mixtral cell ({card_line()}): wrote {nbytes / 1e9:.2f} GB in "
        f"{write_s:.1f} s, --load-4bit --kv-quant int8 in {load_s:.1f} s "
        f"(peak {load_peak / 2 ** 30:.2f} GiB); the model holds "
        f"{held / 2 ** 30:.2f} GiB")
    size = model.cfg.vision.image_size
    rng = np.random.default_rng(seed + 40)
    ids = rng.integers(3, dec.vocab_size, (1, 48)).astype(np.int32)
    ids[0, 8] = -200
    px = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    n = MIXTRAL_ENGINE["new_tokens"]
    greedy_run(model, ids, px, n)                   # captures
    reset_counts()                                  # main path starts
    toks, ttft, rest = greedy_run(model, ids, px, n)
    counts = read_counts()                          # main path ends
    steps = toks.shape[1] - 1
    solo_k5 = counts["quant_small_m_matmul_int4"]
    if solo_k5 != 4 * L * steps or sum(counts.values()) != solo_k5:
        raise AssertionError(f"Mixtral solo launches {counts}: K5 must be "
                             f"4 x {L} x {steps}")
    eager, e_ttft, e_rest = greedy_run(model, ids, px, n, cuda_graphs=False)
    solo_parted = agree(model, ids[0], px, toks[0].tolist(),
                        eager[0].tolist(), "Mixtral solo captured vs eager")
    per_replay = replay_kernel_count(solo_program(model, ("scan", 1)),
                                     "qmm4_kernel", 4 * L,
                                     "the Mixtral solo decode step")
    solo = dict(ttft_ms=ttft * 1e3, decode_tok_s=steps / rest,
                eager_ttft_ms=e_ttft * 1e3, eager_tok_s=steps / e_rest,
                k5_per_step=solo_k5 // steps, qmm4_per_replay=per_replay,
                parted=solo_parted)
    log(f"Mixtral solo: TTFT {ttft * 1e3:.1f} ms, {steps / rest:.2f} tok/s "
        f"captured ({steps / e_rest:.2f} eager), K5 {solo_k5 // steps} a "
        f"decode step, a profiled replay shows qmm4_kernel {per_replay} "
        f"times; captured vs eager: "
        f"{'equal' if solo_parted is None else solo_parted}")
    reqs = mixtral_requests(np.random.default_rng(seed + 41),
                            dec.vocab_size, size)
    engine_res, streams = {}, {}
    fw = ForwardRows(model.language_model)
    fw.active = False
    for graphs in (True, False):
        engine = DecodeEngine(model, n_slots=MIXTRAL_ENGINE["slots"],
                              max_len=MIXTRAL_ENGINE["max_len"],
                              run_thread=False, cuda_graphs=graphs,
                              rng_seed=seed)
        drive_ticks(engine, reqs[:1], 4)            # warm-up, captures
        if graphs:
            fw.rows.clear()
            fw.active = True
            reset_counts()                          # main path starts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams[graphs] = drive_ticks(engine, reqs, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        side = "captured" if graphs else "eager"
        tokens = sum(len(s) for s in streams[graphs])
        engine_res[side] = dict(wall_s=wall, tokens=tokens,
                                tok_s=tokens / wall)
        if graphs:
            counts = read_counts()                  # main path ends
            fw.active = False
            want = matvec_launches(model.language_model, fw.rows)
            eng_k5 = counts["quant_small_m_matmul_int4"]
            if eng_k5 != want or sum(counts.values()) != eng_k5:
                raise AssertionError(f"Mixtral engine launches {counts}: K5"
                                     f" must be {want} (4 x {L} x viable "
                                     f"forwards)")
            engine_res["k5"] = eng_k5
            engine_res["viable_forwards"] = want // (4 * L)
        engine.shutdown()
        del engine
        free_card()
    fw.remove()
    parted = [agree(model, ids_, px_, streams[True][i], streams[False][i],
                    f"Mixtral engine request {i} captured vs eager")
              for i, (ids_, px_) in enumerate(reqs)]
    engine_res["parted"] = [p for p in parted if p is not None]
    log(f"Mixtral engine ({MIXTRAL_ENGINE}): "
        f"{engine_res['captured']['tok_s']:.1f} tok/s captured, "
        f"{engine_res['eager']['tok_s']:.1f} eager; K5 {eng_k5} = 4 x {L} x "
        f"{engine_res['viable_forwards']}; streams parted: "
        f"{engine_res['parted'] or 'none'}")
    summary = dict(card=card_line(), checkpoint_gb=nbytes / 1e9,
                   write_s=write_s, load_4bit_s=load_s,
                   load_peak_gib=load_peak / 2 ** 30,
                   held_gib=held / 2 ** 30, solo=solo, engine=engine_res,
                   seconds=time.perf_counter() - t_phase)
    del model
    free_card()
    return solo_k5 + eng_k5, summary


# ---------------------------------------------------------------------------
# the rest of the LM stack: MoA, ACT, the XL carry, layer drop, remat, the
# streaming task, telemetry, loggers, the profiler and the QA battery
# ---------------------------------------------------------------------------

# the main path of this slice: the 154M sweep field for field through its
# own task over local shards, LM_REST_STEPS steps, validation at step 3,
# the async logger, a profiler trace of step 4; then its test() with the
# zero-shot battery; MoA and remat runs LM_REST_SIDE_STEPS steps each
LM_REST_FLAGS = SWEEP_154M + [
    "-task", "slimpajama_transformer", "-valid_interval", "3",
    "-valid_batches", "2", "-log_async", "1", "-log", "tb",
    "-profile.start_step", "4", "-profile.n_steps", "1", "-log_interval",
    "1", "-lm.n_shards", "8", "-lm.tokenizer_n_files", "2"]
LM_REST_STEPS = 6
LM_REST_SIDE_STEPS = 4
# MoA's dense einsum attention and all-expert mixes keep about 3 GB a
# layer for the backward at 64 x 1024 (the first chip run ran out of the
# card's 80 GB): its run takes the same batch in two microbatches
LM_REST_SIDE = {"moa": ["-moe.att.enable", "1", "-n_microbatch", "2"],
                "remat": ["-remat", "1"]}
# the written corpus: 8 jsonl.gz shards of LM_REST_DOCS documents of 40 to
# 200 words drawn (Zipf 1.1) from 4,000 pseudo-words; about 700 windows of
# 1025 tokens, more than 64 x 6 (every window of a run is a new one)
LM_REST_SHARDS = 8
LM_REST_DOCS = 600
# each QA file holds LM_REST_QA_DOCS documents; hellaswag contexts reach
# 700 words and piqa's are short, so the battery fills buckets from 128
# to max_len 1024 (K2 at T = 127 and 1023) without cutting a document at
# max_len; the tasks in the order the battery scores them
LM_REST_QA = ("lambada", "hellaswag", "piqa", "ai2arc")
LM_REST_QA_DOCS = 64
# K2 at the battery's shortest and longest bucket lengths (T = L - 1),
# against its plain version and timed beside it
K2_BATTERY_SHAPES = ((32, 4, 127, 82), (8, 4, 1023, 82))
# the small LM of SMALL_LM_FLAGS (K1 takes d and ES in multiples of 128)
# with each option, 3 steps (0, 2 and 1 competing layers) on the card and
# on the CPU from the same weights and batches, at T 128
SMALL_REST_CASES = {
    "moa": dict(att_moe=True, att_v_size=64),
    "act": dict(act_max_steps=3, act_loss=0.01),
    "xl": dict(n_prev_states=1),
    "drop0": dict(p_drop_layer=0.0),
    "drop1": dict(p_drop_layer=1.0),
    "remat": dict(remat=True),
}
SMALL_REST_T = 128


def _small_rest_model(case: str, seed: int, device: str, weights=None):
    """The small LM's model with SMALL_REST_CASES[case] on `device`, its
    flip schedule SMALL_LM_FLAGS's; weights from `seed` or `weights`."""
    from competesmoe_tpu_torch.models.lm import MoELanguageModel
    from competesmoe_tpu_torch.moe.schedule import build_flip_schedule
    from competesmoe_tpu_torch.train.lm_task import lm_config_from
    from competesmoe_tpu_torch.utils.argparser import build_parser

    a = build_parser().parse(SMALL_LM_FLAGS + ["-seed", str(seed)])
    cfg = dataclasses.replace(lm_config_from(a), **SMALL_REST_CASES[case])
    sched = build_flip_schedule(cfg.n_layers, a.stop_after, a.warm_up,
                                a.rate_flip, a.max_compete_in_iter, seed=seed)
    model = MoELanguageModel(cfg, flip_schedule=sched, device=device)
    if weights is None:
        return model.init_weights(seed)
    model.load_state_dict(weights)
    return model


def small_rest_rows(model, case: str, batches, seed: int):
    """Per step s: the loss (CE + aux) and the gradient norm of one
    forward and backward at step s (no optimizer update), and the
    competing layers. The XL case runs the batch's first window (no
    gradient) and takes its loss on the second with the carried state."""
    import torch

    from competesmoe_tpu_torch.models.lm import lm_loss_fn
    from competesmoe_tpu_torch.train.lm_trainer import global_norm

    dev = model.output.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    T = SMALL_REST_T
    rows = []
    for s, b in enumerate(batches):
        model.zero_grad(set_to_none=True)
        b = b.to(dev)
        state = None
        if case == "xl":
            with torch.no_grad():
                state = model(b[:, :T], step=s, train=True)[1]["state"]
            b = b[:, T:]
        else:
            b = b[:, :T + 1]
        logits, aux = model(b[:, :-1], step=s, train=True, state=state,
                            generator=gen)
        ce, _ = lm_loss_fn(logits, b[:, 1:])
        loss = ce + aux["total_aux_loss"]
        loss.backward()
        gn = global_norm([p.grad for p in model.parameters()
                          if p.grad is not None])
        # a competing layer once (ACT: its first ponder step's key)
        comp = [v for k, v in aux.items() if k.endswith("mlp_is_comp")
                and ("ponder" not in k or "/ponder0/" in k)]
        rows.append({"loss/total": float(loss.detach()),
                     "grad_norm": float(gn),
                     "competesmoe/n_flip_layers": float(sum(comp))})
    return rows


def small_rest_launches(case: str, flips, L: int = 2):
    """The small case's kernel launches over its steps: K1 and its
    backward kernels at every non-competing layer call, K2 at every
    attention call (forward) and its backward where one runs; ACT calls
    each block act_max_steps times; remat runs every block's forward
    again in the backward; the XL case's first window is a forward only,
    and its second window attends over the carried prefix by einsum; MoA
    never reaches K2."""
    fused = sum(L - f for f in flips)
    steps = len(flips)
    calls = SMALL_REST_CASES[case].get("act_max_steps", 0) or 1
    k1, k1b, k2, k2b = calls * fused, calls * fused, calls * L * steps, \
        calls * L * steps
    if case == "remat":
        k1, k2 = 2 * fused, 2 * L * steps
    if case == "xl":
        k1, k2, k2b = 2 * fused, L * steps, 0
    if case == "moa":
        k2 = k2b = 0
    return {"gmm2_fused_aligned": k1, "gmm2_bwd_dx": k1b,
            "gmm2_bwd_dw": k1b, "flash_attention_fwd": k2,
            "flash_attention_bwd_dkv": k2b, "flash_attention_bwd_dq": k2b,
            "quant_small_m_matmul_int4": 0, "small_m_matmul": 0,
            "quant_small_m_matmul": 0}


def xl_consistency_check(seed: int, card: str = "cuda"):
    """The XL carry on the card against the same tokens in one window: a
    float32 small LM (plain MoE and einsum attention, no kernel), window 2
    with window 1's carried state against the second half of one forward
    over both windows; logits within 1e-4 of the largest |logit| (the
    same function; sums over keys taken in another order)."""
    import torch

    from competesmoe_tpu_torch.models.lm import LMConfig, MoELanguageModel

    cfg = LMConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
                   head_dim=82, n_experts=8, expert_size=128, moe_topk=2,
                   moe_name="smoe", moe_impl="dense", attn_backend="einsum",
                   n_prev_states=1)
    model = MoELanguageModel(cfg, device=card).init_weights(seed)
    g = torch.Generator(device=card).manual_seed(seed + 55)
    toks = torch.randint(0, 512, (4, 2 * SMALL_REST_T), generator=g,
                         device=card)
    T = SMALL_REST_T
    with torch.no_grad():
        state = model(toks[:, :T])[1]["state"]
        carried = model(toks[:, T:], state=state)[0]
        whole = model(toks)[0][:, T:]
    err = float((carried - whole).abs().max())
    tol = 1e-4 * float(whole.abs().max())
    log(f"XL carry on the card: window 2 with the carried state against "
        f"one forward over both windows: max |diff| {err:.3g} (tol "
        f"{tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"XL carry: window 2 differs from the whole "
                             f"forward by {err} (tol {tol})")
    return dict(max_abs_err=err, tol=tol)


def telemetry_consistent_lm(task, what: str):
    """The task's last validation telemetry (`expert_usage`, one histogram
    a layer) against the bincount of each layer's router selections,
    recomputed on the same batch by calling every MoE layer's gate and
    route on its input: equal, layer for layer."""
    import torch

    from competesmoe_tpu_torch.data.lm_data import \
        SequentialMultibatchSampler

    a = task.a
    sampler = SequentialMultibatchSampler(len(task.valid_dataset),
                                          a.batch_size)
    for _ in range(a.valid_batches):
        idx = next(sampler)
    batch = torch.from_numpy(task.valid_dataset.batch(idx).astype(
        np.int64)).to(task.device)
    inputs = []
    hooks = [b.moe.register_forward_pre_hook(
        lambda mod, args, kw: inputs.append((mod, args[0])),
        with_kwargs=True) for b in task.model.blocks]
    try:
        with torch.no_grad():
            task.model(batch[:, :-1], train=False)
            hists = []
            for mod, x in inputs:
                sel = mod.route(x, mod.compute_gate(x))[1]
                hists.append(np.bincount(sel.reshape(-1).cpu().numpy(),
                                         minlength=task.cfg.n_experts))
    finally:
        for h in hooks:
            h.remove()
    got = task.expert_usage
    bad = [li for li, h in enumerate(hists)
           if not np.array_equal(got.get(f"layer{li}"), h)]
    log(f"{what}: telemetry of {len(got)} layers against the routers' "
        f"recomputed selections: {len(hists) - len(bad)} equal")
    if bad or len(got) != len(hists):
        raise AssertionError(f"{what}: telemetry differs from the routers' "
                             f"selections at layers {bad}")
    return len(hists)


def small_lm_rest_check(seed: int, card: str = "cuda"):
    """The small LM (SMALL_LM_FLAGS' geometry) with each option of
    SMALL_REST_CASES: 3 steps on the card (K1 and its backward kernels,
    K2) and on the CPU from the same weights and batches, the CPU taking
    the card's top-k choices (`routed_as`: MoA's banks too); per step the
    loss within SMALL_LM_LOSS_TOL, grad_norm within SMALL_LM_GRAD_TOL and
    the same competing layers, at most SMALL_LM_FLIP_SHARE of top-k rows
    chosen otherwise; launches as `small_rest_launches` says (MoA: K2 0);
    remat's losses and grad norms equal drop0's (no drop, no remat) bit
    for bit on the card. Then `xl_consistency_check`, and a small task's
    validation telemetry against its routers (`telemetry_consistent_lm`).
    `card` names the device the checks hold against the CPU."""
    import torch

    g = torch.Generator().manual_seed(seed + 77)
    batches = [torch.randint(0, 512, (4, 2 * SMALL_REST_T + 1), generator=g)
               for _ in range(3)]
    out, card_rows = {}, {}
    for case in SMALL_REST_CASES:
        cpu = _small_rest_model(case, seed, "cpu")
        gpu = _small_rest_model(case, seed, card, {
            k: v.to(card) for k, v in cpu.state_dict().items()})
        choices = []
        counts0 = read_counts()
        with routed_as(record=choices):
            rows = small_rest_rows(gpu, case, batches, seed)
        counts = {k: v - counts0[k] for k, v in read_counts().items()}
        with routed_as(replay=choices) as seen:
            ref = small_rest_rows(cpu, case, batches, seed)
        gaps = small_lm_gaps(ref, rows)
        flips = [d["flips"] for d in gaps]
        share = seen["flipped"] / max(seen["rows"], 1)
        want = small_rest_launches(case, flips)
        log(f"small LM {case}: losses card "
            f"{[round(r['loss/total'], 5) for r in rows]} cpu "
            f"{[round(r['loss/total'], 5) for r in ref]}; loss gaps "
            f"{[f'{d['loss_gap']:.2g}' for d in gaps]}, grad_norm gaps "
            f"{[f'{d['grad_gap']:.2g}' for d in gaps]}; flips {flips}; "
            f"top-k rows chosen otherwise {seen['flipped']} of "
            f"{seen['rows']} (gap {seen['gap']:.3g}); launches {counts}")
        if not all(math.isfinite(r["loss/total"]) for r in rows):
            raise AssertionError(f"small LM {case}: non-finite loss {rows}")
        if not all(d["ok"] for d in gaps) or flips != [0, 2, 1]:
            raise AssertionError(f"small LM {case} disagrees: {gaps}")
        if share > SMALL_LM_FLIP_SHARE:
            raise AssertionError(f"small LM {case}: the card chose another "
                                 f"top-k set on {share:.3%} of the rows")
        if counts != want:
            raise AssertionError(f"small LM {case} launches {counts} != "
                                 f"{want}")
        card_rows[case] = rows
        out[case] = dict(gaps=gaps, launches=counts, topk_rows=seen["rows"],
                         topk_flips=seen["flipped"], topk_gap=seen["gap"])
        del cpu, gpu
    keys = ("loss/total", "grad_norm")
    remat = [[r[k] for k in keys] for r in card_rows["remat"]]
    plain = [[r[k] for k in keys] for r in card_rows["drop0"]]
    log(f"small LM remat against no remat on the card: {remat} vs {plain}")
    if remat != plain:
        raise AssertionError(f"small LM: remat's steps {remat} differ from "
                             f"the steps without it {plain}")
    out["xl_consistency"] = xl_consistency_check(seed, card)
    task = small_lm_task(seed, card, flags=["-valid_batches", "1",
                                              "-name", "small_rest"])
    task.validate()
    out["telemetry_layers"] = telemetry_consistent_lm(task, "small LM")
    task.logger.close()
    return out


def k2_battery_shapes(seed: int, reps: int = 20):
    """K2's forward (and backward) at K2_BATTERY_SHAPES against its plain
    version by `k2_compare`'s rule, the forward timed beside the plain
    forward and `scaled_dot_product_attention`; rows by shape."""
    import torch

    from competesmoe_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed + 303)
    rows = []
    for B, h, T, p in K2_BATTERY_SHAPES:
        q, k, v, do = (torch.randn(B, h, T, p, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        checks = k2_compare(q, k, v, do, p ** -0.5)
        bad = [c for c in checks if not c["ok"]]
        if bad:
            raise AssertionError(f"K2 at {(B, h, T, p)} disagrees with its "
                                 f"plain version: {bad}")
        args = [(q, k, v, p ** -0.5)]
        ms = time_launches(fa.flash_attention_fwd, args * 4, reps)
        plain = time_launches(fa.flash_attention_fwd_reference, args, 5)
        lib, _ = _sdpa_ms(q, k, v, do, reps)
        BH, pairs = B * h, T * (T + 1) / 2
        bound_ms, bound_by = bound(4 * BH * T * p * 2 + BH * T * 4,
                                   4 * p * pairs * BH)
        rows.append(dict(shape=[B, h, T, p], ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bound_ms,
                         bound_by=bound_by, worst=max(c["worst"]
                                                      for c in checks)))
        log(f"K2 forward at the battery's [B={B} h={h} T={T} p={p}]: "
            f"kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, sdpa "
            f"{lib * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({bound_by}); worst {rows[-1]['worst']:.3f} of its tolerance "
            f"(forward and backward)")
    return rows


def write_lm_rest_data(root: Path, seed: int):
    """The corpus shards and the QA files of the phase, from `seed`:
    LM_REST_SHARDS jsonl.gz shards of LM_REST_DOCS documents, and
    hellaswag-, piqa-, ai2arc- and lambada-format files of LM_REST_QA_DOCS
    documents over the same pseudo-words. Returns (shard glob, {flag:
    path})."""
    import gzip

    rng = np.random.default_rng(seed + 808)
    syl = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]
    words = set()
    while len(words) < 4000:
        words.add("".join(rng.choice(syl, size=int(rng.integers(1, 4)))))
    words = np.array(sorted(words))
    zipf = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    zipf /= zipf.sum()

    def text(lo, hi):
        return " ".join(rng.choice(words, size=int(rng.integers(lo, hi)),
                                   p=zipf))

    (root / "shards").mkdir(parents=True, exist_ok=True)
    for s in range(LM_REST_SHARDS):
        with gzip.open(root / "shards" / f"shard_{s:02d}.jsonl.gz",
                       "wt") as f:
            for _ in range(LM_REST_DOCS):
                f.write(json.dumps({"text": text(40, 200)}) + "\n")
    n = LM_REST_QA_DOCS
    qa = root / "qa"
    qa.mkdir(exist_ok=True)

    def jsonl(name, rows):
        (qa / name).write_text("".join(json.dumps(r) + "\n" for r in rows))
        return str(qa / name)

    def choice_q():
        labels = "ABCD"
        return {"question": {"stem": text(10, 100), "choices": [
            {"label": c, "text": text(1, 8)} for c in labels]},
            "answerKey": labels[int(rng.integers(4))]}

    (qa / "piqa-labels.lst").write_text(
        "\n".join(str(int(rng.integers(2))) for _ in range(n)))
    paths = {
        "hellaswag": jsonl("hellaswag.jsonl", [dict(
            activity_label=text(1, 3), ctx_a=text(20, 700), ctx_b=text(5, 20),
            endings=[text(5, 20) for _ in range(4)],
            label=int(rng.integers(4))) for _ in range(n)]),
        "piqa": jsonl("piqa.jsonl", [dict(goal=text(10, 50),
                                          sol1=text(5, 30),
                                          sol2=text(5, 30))
                                     for _ in range(n)]),
        "ai2arc": jsonl("arc.jsonl", [choice_q() for _ in range(n)]),
        "lambada": jsonl("lambada.jsonl", [dict(text=text(20, 560))
                                           for _ in range(n)]),
    }
    flags = ["-lm.eval.enabled", "1"]
    for name, path in paths.items():
        flags += [f"-lm.eval.{name}.enabled", "1",
                  f"-lm.eval.{name}.path", path]
    flags += ["-lm.eval.piqa.labels_path", str(qa / "piqa-labels.lst")]
    return str(root / "shards" / "*.jsonl.gz"), flags


def _lm_rest_task(name: str, extra, seed: int, root: Path, shards: str,
                  qa_flags=()):
    run = root / name
    shutil.rmtree(run, ignore_errors=True)
    return _task(LM_REST_FLAGS + [
        "-seed", str(seed), "-device", "cuda", "-run_dir", str(root),
        "-name", name, "-lm.shards", shards, "-lm.cache_dir",
        str(root / "cache"), *qa_flags, *extra])


def _train_window(task, steps: int):
    """`steps` training steps from step 0 with the launch counts set to 0
    just before and read just after: (flips, counts, wall s, peak GiB)."""
    import torch

    L = task.cfg.n_layers
    flips = [sum(task.schedule.is_flip(li, s) for li in range(L))
             for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    task.train(n_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    return flips, counts, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def _lm_want(flips, L, forwards=0, remat=False, moa=False, micro=1):
    """Launches of training steps with `flips` competing layers of L, and
    `forwards` more model forwards without a gradient (validation, the
    battery): K1 and its backward kernels at every non-competing layer of
    a step, K1 forward at every layer of a forward without gradient; K2's
    three kernels at every layer of a step and its forward at every layer
    of a forward, none under MoA; remat runs each forward kernel of a step
    twice (the backward recomputes the block); `micro` microbatches run
    every layer of a step that many times."""
    fused = micro * sum(L - f for f in flips)
    k2 = 0 if moa else micro * L * len(flips)
    extra = L * forwards
    return {"gmm2_fused_aligned": (2 if remat else 1) * fused + extra,
            "gmm2_bwd_dx": fused, "gmm2_bwd_dw": fused,
            "flash_attention_fwd": (2 if remat else 1) * k2 + extra,
            "flash_attention_bwd_dkv": k2, "flash_attention_bwd_dq": k2,
            "quant_small_m_matmul_int4": 0, "small_m_matmul": 0,
            "quant_small_m_matmul": 0}


def _records(task):
    path = task.run_dir / "log_trainer.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()]


def lm_rest_main(seed: int, root: Path, shards: str, qa_flags):
    """The slice's main path: the 154M sweep through slimpajama_transformer
    over the written shards, LM_REST_STEPS steps (validation at step 3,
    K1 and K2 forward only there: 2 batches and the telemetry forward),
    then test() with the zero-shot battery (K1 and K2 forward only, once
    a layer per model forward). Telemetry against the routers."""
    import torch

    from competesmoe_tpu_torch.data import native_loader
    from competesmoe_tpu_torch.eval import lm_zeroshot

    t0 = time.perf_counter()
    task = _lm_rest_task("main", [], seed, root, shards, qa_flags)
    build_s = time.perf_counter() - t0
    L = task.cfg.n_layers
    flips, counts, wall, peak = _train_window(task, LM_REST_STEPS)
    valid_forwards = task.a.valid_batches + 1        # + the telemetry
    want = _lm_want(flips, L, valid_forwards)
    if counts != want:
        raise AssertionError(f"lm_rest main launches {counts} != {want}")
    valid_ms = []
    validate = task.validate

    def timed_validate():
        t = time.perf_counter()
        ppl = validate()
        torch.cuda.synchronize()
        valid_ms.append(1e3 * (time.perf_counter() - t))
        return ppl

    task.validate = timed_validate
    spans, forwards, lengths = [], [0], set()
    score_seqs = lm_zeroshot.LMZeroShotEvaluator.score_sequences
    score = lm_zeroshot.LMZeroShotEvaluator.score

    def timed_scores(self, seqs):
        t = time.perf_counter()
        res = score_seqs(self, seqs)
        spans.append(time.perf_counter() - t)
        return res

    def counted_score(self, tokens, mask):
        forwards[0] += 1
        lengths.add(tokens.shape[1])
        return score(self, tokens, mask)

    lm_zeroshot.LMZeroShotEvaluator.score_sequences = timed_scores
    lm_zeroshot.LMZeroShotEvaluator.score = counted_score
    reset_counts()
    try:
        res = task.test()
        torch.cuda.synchronize()
    finally:
        lm_zeroshot.LMZeroShotEvaluator.score_sequences = score_seqs
        lm_zeroshot.LMZeroShotEvaluator.score = score
    test_counts = read_counts()
    if not {128, 1024} <= lengths:
        raise AssertionError(f"lm_rest: the battery's buckets "
                             f"{sorted(lengths)} miss 128 or 1024")
    n_fwd = valid_forwards + forwards[0]
    want_test = _lm_want([], L, n_fwd)
    if test_counts != want_test:
        raise AssertionError(f"lm_rest test() launches {test_counts} != "
                             f"{want_test}")
    # the last validation (test()'s) ran on these weights
    telemetry_consistent_lm(task, "lm_rest main")
    task.logger.close()
    recs = _records(task)
    steps = [r for r in recs if "loss/total" in r]
    if [r["step"] for r in steps] != list(range(LM_REST_STEPS)):
        raise AssertionError(f"lm_rest: logged steps {steps}")
    if not all(math.isfinite(r["loss/total"]) for r in steps):
        raise AssertionError("lm_rest: non-finite loss")
    for r, f in zip(steps, flips):
        if int(r["competesmoe/n_flip_layers"]) != f:
            raise AssertionError(f"lm_rest: step {r['step']} flips")
    ms = [r["timing/ms_per_step_wall"] for r in steps]
    steady = statistics.median(ms[1:])
    tokens = task.a.batch_size * task.a.lm.unroll
    telemetry = sorted({k for r in recs for k in r
                        if k.startswith("expert_usage/")})
    plots = [r for r in recs if "plots" in r]
    qa = {}
    for name, sec in zip(LM_REST_QA, spans):
        n = res[f"{name}/n_docs"]
        qa[name] = dict(accuracy=res[f"{name}/accuracy"], n_docs=n,
                        seconds=sec, docs_per_s=n / sec)
    ppl = res["valid/perplexity"]
    trace = getattr(task, "trace_path", None)
    if trace is None or not Path(trace).exists():
        raise AssertionError("lm_rest: no profiler trace written")
    if not (math.isfinite(ppl) and len(telemetry) == 2 * L and plots):
        raise AssertionError(f"lm_rest: perplexity {ppl}, telemetry keys "
                             f"{len(telemetry)}, plots {len(plots)}")
    summary = dict(
        steps=LM_REST_STEPS, flips=flips, launches=counts,
        test_launches=test_counts, test_forwards=n_fwd,
        battery_lengths=sorted(lengths),
        build_s=build_s, wall_s=wall, ms_per_step=ms,
        ms_per_step_median_after_first=steady,
        tokens_per_s=tokens / (steady / 1e3),
        ms_per_load=[r["timing/ms_per_load"] for r in steps],
        native_loader=native_loader.native_available(),
        windows=len(task.dataset),
        vocab=task.dataset.tokenizer.get_vocab_size(),
        peak_mem_gib=peak, valid_perplexity=ppl, valid_ms=valid_ms,
        telemetry_keys=telemetry, qa=qa, trace=str(trace),
        losses=[r["loss/total"] for r in steps])
    log(f"lm_rest main: {build_s:.1f} s to build (corpus {len(task.dataset)}"
        f" windows, vocab {summary['vocab']}, native loader "
        f"{summary['native_loader']}); {LM_REST_STEPS} steps in {wall:.1f} "
        f"s, ms (competing layers) {[(round(m, 1), f) for m, f in zip(ms, flips)]}"
        f" (step 4 profiled), median {steady:.1f} ms/step after the first "
        f"({summary['tokens_per_s']:.0f} tok/s), ms_per_load "
        f"{[round(x, 3) for x in summary['ms_per_load']]}, peak "
        f"{peak:.2f} GiB; launches {counts}")
    log(f"lm_rest main test(): perplexity {ppl:.2f} in "
        f"{[round(x, 1) for x in valid_ms]} ms; {forwards[0]} battery "
        f"forwards at lengths {sorted(lengths)}; " + "; ".join(
            f"{k} accuracy {v['accuracy']:.3f} ({v['n_docs']} docs, "
            f"{v['docs_per_s']:.1f} docs/s)" for k, v in qa.items())
        + f"; telemetry keys {len(telemetry)}; trace {trace}")
    del task
    free_card()
    return summary


def lm_rest_side(name: str, seed: int, root: Path, shards: str):
    """The 154M sweep with LM_REST_SIDE[name], LM_REST_SIDE_STEPS steps,
    no validation and no trace: MoA launches K1 at every non-competing
    layer and K2 never; remat launches every forward kernel twice."""
    task = _lm_rest_task(name, LM_REST_SIDE[name] + [
        "-valid_interval", "0", "-profile.start_step", "-1"], seed, root,
        shards)
    L = task.cfg.n_layers
    flips, counts, wall, peak = _train_window(task, LM_REST_SIDE_STEPS)
    want = _lm_want(flips, L, remat=name == "remat", moa=name == "moa",
                    micro=task.a.n_microbatch)
    if counts != want:
        raise AssertionError(f"lm_rest {name} launches {counts} != {want}")
    task.logger.close()
    steps = [r for r in _records(task) if "loss/total" in r]
    if not all(math.isfinite(r["loss/total"]) for r in steps):
        raise AssertionError(f"lm_rest {name}: non-finite loss")
    ms = [r["timing/ms_per_step_wall"] for r in steps]
    summary = dict(steps=LM_REST_SIDE_STEPS, flips=flips, launches=counts,
                   wall_s=wall, ms_per_step=ms,
                   ms_per_step_median_after_first=statistics.median(ms[1:]),
                   peak_mem_gib=peak, losses=[r["loss/total"] for r in steps])
    log(f"lm_rest {name}: {LM_REST_SIDE_STEPS} steps, ms (competing "
        f"layers) {[(round(m, 1), f) for m, f in zip(ms, flips)]}, median "
        f"{summary['ms_per_step_median_after_first']:.1f} ms/step after the "
        f"first, peak {peak:.2f} GiB, losses "
        f"{[round(x, 4) for x in summary['losses']]}; launches {counts}")
    del task
    free_card()
    return summary


def phase_lm_rest(seed: int):
    """The rest of the LM stack (see the module docstring, phase 15)."""
    t0 = time.perf_counter()
    out = dict(small=small_lm_rest_check(seed),
               k2_battery=k2_battery_shapes(seed))
    free_card()
    root = REPO / "runs" / "chip_smoke" / "lm_rest"
    shutil.rmtree(root, ignore_errors=True)
    shards, qa_flags = write_lm_rest_data(root, seed)
    out["main"] = lm_rest_main(seed, root, shards, qa_flags)
    for name in LM_REST_SIDE:
        out[name] = lm_rest_side(name, seed, root, shards)
    main, remat = out["main"], out["remat"]
    log(f"lm_rest remat: step 0 loss {remat['losses'][0]!r} (without remat "
        f"{main['losses'][0]!r}); peak {remat['peak_mem_gib']:.2f} GiB "
        f"against {main['peak_mem_gib']:.2f} GiB")
    if remat["losses"][0] != main["losses"][0]:
        raise AssertionError("lm_rest: remat's step 0 loss differs from "
                             "the run without remat")
    if not remat["peak_mem_gib"] < main["peak_mem_gib"]:
        raise AssertionError("lm_rest: remat's peak memory is not lower")
    out["seconds"] = time.perf_counter() - t0
    log(f"lm_rest: every check passed in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# parallel training: ranks that share the card over gloo
# ---------------------------------------------------------------------------

# the 154M sweep at 2 ranks: global rows of 1024 (cut from 64: both ranks'
# activations, the expert-parallel buffers, 2 x T_loc x 8 slots of 512, and
# gloo's host copies of them must fit one card and a run of the phase)
PAR_154M_BATCH = 8
PAR_154M_STEPS = 4
PAR_154M_RUNS = {
    # (i) experts sharded, tokens by all-to-all, K1 as the local compute
    "ep": ["-n_expert_shards", "2", "-moe.impl", "auto"],
    # (ii) experts sharded, gathered where they are read, K1
    "fused": ["-n_expert_shards", "2", "-moe.impl", "fused"],
    # (iii) dense parameters sharded over 'data' (2), K1
    "fsdp": ["-fsdp", "1"],
}
# the small LM of SMALL_LM_FLAGS (8 experts of 128 so that K1 runs) over
# ranks: (world, name, flags); each against one process on the card
PAR_SMALL_RUNS = (
    (2, "ep2", ["-n_expert_shards", "2", "-moe.impl", "auto"]),
    (2, "fused2", ["-n_expert_shards", "2", "-moe.impl", "fused"]),
    (4, "ep2x2", ["-n_expert_shards", "2", "-moe.impl", "auto"]),
    (4, "ep2x2_fsdp", ["-n_expert_shards", "2", "-moe.impl", "auto",
                       "-fsdp", "1", "-fsdp.min_size", "1024"]))
# the parameters after 3 steps: |multi-rank - one process| over |one
# process - the initial weights| (all parameters as one vector)
PAR_PARAM_TOL = 5e-2
PAR_MM_FLAGS = ("--stage sft --model-max-length 64 --grad-accum 2 "
                "--rate-flip 0.5 --max-compete-in-iter 3 "
                "--learning-rate 1e-4 --warmup-ratio 0.0 --log-interval 1 "
                "--save-interval 0 --num-train-steps 3 --seed 1").split()


def _par_tmp(name: str) -> str:
    import tempfile
    return tempfile.mkdtemp(prefix=f"chip_smoke_par_{name}_")


def par_small_lm(name: str, flags, steps: int = 3):
    """A rank's run of the small LM with `flags` over the process group:
    its metrics, its top-k choices, its launches, and (rank 0) the full
    parameters after the steps."""
    import torch

    from competesmoe_tpu_torch.parallel.mesh import full_state_dict
    task = small_lm_task(0, "cuda", flags=["-run_dir", _par_tmp(name),
                                           *flags])
    choices = []
    reset_counts()
    with routed_as(record=choices), task._ep_scope():
        rows = small_lm_steps(task, steps)
    counts = read_counts()
    params = {k: v.float().cpu() for k, v in
              full_state_dict(task.model).items()}
    torch.cuda.synchronize()
    task.logger.close()
    return dict(rows=rows, choices=choices, launches=counts,
                params=params if task.mesh.rank == 0 else None,
                mesh=(task.mesh.shape["data"], task.mesh.shape["expert"]),
                ep=task._use_ep)


def _replay_of(ranks, mesh_shape, ep: bool):
    """One process's replay of the ranks' recorded top-k choices: a
    router's choices ([b, n, k]) of every rank's rows in rank order; the
    expert-parallel competition step's ([T, k] of a data row's tokens, the
    same on the row's ranks) one per data row."""
    import torch
    n_data, n_exp = mesh_shape
    out = []
    for calls in zip(*ranks):
        if calls[0].dim() == 3 or not ep:
            out.append(torch.cat(calls))
        else:
            out.append(torch.cat([calls[d * n_exp] for d in range(n_data)]))
    return out


def _params_gap(got, want, init) -> float:
    num = sum(float((got[k] - want[k]).double().norm() ** 2) for k in want)
    den = sum(float((want[k] - init[k]).double().norm() ** 2) for k in want)
    return math.sqrt(num / max(den, 1e-30))


def small_parallel_check(ranks_by_world):
    """Each PAR_SMALL_RUNS run against the small LM in one process on the
    card (-moe.impl fused, K1), from the same seed, the one process taking
    the ranks' top-k choices (`routed_as`): per step the loss within
    SMALL_LM_LOSS_TOL and grad_norm within SMALL_LM_GRAD_TOL, the same
    competing layers, the rows chosen otherwise at most
    SMALL_LM_FLIP_SHARE (each within SMALL_LM_FLIP_GAP), the parameters
    after 3 steps within PAR_PARAM_TOL; every rank reports the same
    metrics, and each rank launches K1 and its backward kernels 2 - the
    competing layers a step and each K2 kernel 2."""
    import torch
    out = {}
    for world, name, flags in PAR_SMALL_RUNS:
        ranks = [r[f"small_{name}"] for r in ranks_by_world[world]]
        what = f"parallel small LM {name} ({world} ranks)"
        got = ranks[0]["rows"]
        for r in ranks[1:]:
            if r["rows"] != got:
                raise AssertionError(f"{what}: ranks report other metrics: "
                                     f"{r['rows']} != {got}")
        replay = _replay_of([r["choices"] for r in ranks],
                            ranks[0]["mesh"], ranks[0]["ep"])
        single = small_lm_task(0, "cuda", flags=[
            "-run_dir", _par_tmp(name), "-moe.impl", "fused"])
        init = {k: v.float().cpu().clone()
                for k, v in single.model.state_dict().items()}
        with routed_as(replay=replay) as seen:
            want = small_lm_steps(single)
        params = {k: v.float().cpu() for k, v in
                  single.model.state_dict().items()}
        del single
        gaps = small_lm_gaps(want, got)
        share = seen["flipped"] / max(seen["rows"], 1)
        pgap = _params_gap(ranks[0]["params"], params, init)
        flips = [d["flips"] for d in gaps]
        for r in ranks:
            fused = sum(2 - f for f in flips)
            wl = {"gmm2_fused_aligned": fused, "gmm2_bwd_dx": fused,
                  "gmm2_bwd_dw": fused, "flash_attention_fwd": 6,
                  "flash_attention_bwd_dkv": 6, "flash_attention_bwd_dq": 6,
                  "quant_small_m_matmul_int4": 0, "small_m_matmul": 0,
                  "quant_small_m_matmul": 0}
            if r["launches"] != wl:
                raise AssertionError(f"{what}: a rank's launches "
                                     f"{r['launches']} != {wl}")
        for g, w, d in zip(got, want, gaps):
            log(f"{what} step (flips {d['flips']}): loss {g['loss/total']:.6f}"
                f" one process {w['loss/total']:.6f} (gap {d['loss_gap']:.3g},"
                f" tol {SMALL_LM_LOSS_TOL}); grad_norm {g['grad_norm']:.6f} "
                f"one process {w['grad_norm']:.6f} (gap {d['grad_gap']:.3g},"
                f" tol {SMALL_LM_GRAD_TOL})")
        log(f"{what}: parameters after 3 steps {pgap:.3g} of the update "
            f"apart (tol {PAR_PARAM_TOL}); top-k rows chosen otherwise "
            f"{seen['flipped']} of {seen['rows']} ({share:.3%}), gap "
            f"{seen['gap']:.3g}; launches a rank {ranks[0]['launches']}")
        ok = (all(d["ok"] for d in gaps) and pgap <= PAR_PARAM_TOL
              and share <= SMALL_LM_FLIP_SHARE
              and seen["gap"] <= SMALL_LM_FLIP_GAP["competesmoe"]
              and max(flips) > 0)
        if not ok:
            raise AssertionError(f"{what} disagrees with one process: "
                                 f"{gaps}, params {pgap:.3g}, top-k {share}"
                                 f" / {seen['gap']}")
        out[name] = dict(world=world, steps=gaps, params_gap=pgap,
                         topk_share=share, topk_gap=seen["gap"],
                         launches_per_rank=ranks[0]["launches"])
        free_card()
    return out


def par_154m(name: str, flags, steps: int = PAR_154M_STEPS):
    """A rank's run of the 154M sweep (SWEEP_154M at PAR_154M_BATCH rows)
    with `flags` through the CLI's task: per step its wall ms (the card
    synchronised), and over the steps its launches, the bytes each
    collective sent from it, its peak memory; rank 0 also the logged
    losses and competing layers."""
    import torch

    from competesmoe_tpu_torch.parallel import collectives as C
    run = Path(_par_tmp(name))
    task = _task(SWEEP_154M + [
        "-batch_size", str(PAR_154M_BATCH), "-seed", "0", "-device",
        "cuda", "-run_dir", str(run), "-name", name, "-log_interval", "1",
        "-valid_interval", "0", *flags])
    L = task.cfg.n_layers
    flips = [sum(task.schedule.is_flip(li, s) for li in range(L))
             for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.reset_bytes()
    reset_counts()                            # main path starts here
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        task.train(n_steps=1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()                    # main path ends here
    peak = torch.cuda.max_memory_allocated()
    task.logger.close()
    out = dict(flips=flips, ms_per_step=ms, launches=counts,
               bytes_per_step={k: v / steps for k, v in C.BYTES.items()},
               peak_gib=peak / 2 ** 30, layers=L,
               tokens=PAR_154M_BATCH * task.a.lm.unroll,
               mesh=dict(task.mesh.shape))
    if task.mesh.rank == 0:
        recs = [json.loads(line) for line in
                (run / name / "log_trainer.jsonl").read_text().splitlines()]
        out["losses"] = [r["loss/total"] for r in recs]
        out["grad_norms"] = [r["grad_norm"] for r in recs]
        out["logged_flips"] = [int(r["competesmoe/n_flip_layers"])
                               for r in recs]
    shutil.rmtree(run, ignore_errors=True)
    return out


def parallel_154m_check(ranks):
    """The three 154M runs at 2 ranks: finite losses, the logged competing
    layers the schedule's (at least one step competing), and per rank and
    step K1 and its backward kernels 16 - the competing layers, each K2
    kernel 16 (PERF.md §2); per rank the ms a step, tokens/s, peak GiB and
    the bytes through each collective a step."""
    out = {}
    for name in PAR_154M_RUNS:
        runs = [r[f"lm154m_{name}"] for r in ranks]
        head = runs[0]
        L, flips, steps = head["layers"], head["flips"], len(head["flips"])
        if head["logged_flips"] != flips or not max(flips):
            raise AssertionError(f"parallel 154M {name}: flips "
                                 f"{head['logged_flips']} (schedule {flips})")
        if not all(math.isfinite(x) for x in head["losses"]):
            raise AssertionError(f"parallel 154M {name}: losses "
                                 f"{head['losses']}")
        fused = sum(L - f for f in flips)
        want = {"gmm2_fused_aligned": fused, "gmm2_bwd_dx": fused,
                "gmm2_bwd_dw": fused, "flash_attention_fwd": L * steps,
                "flash_attention_bwd_dkv": L * steps,
                "flash_attention_bwd_dq": L * steps,
                "quant_small_m_matmul_int4": 0, "small_m_matmul": 0,
                "quant_small_m_matmul": 0}
        per_rank = []
        for i, r in enumerate(runs):
            if r["launches"] != want:
                raise AssertionError(f"parallel 154M {name} rank {i} "
                                     f"launches {r['launches']} != {want}")
            steady = statistics.median(r["ms_per_step"][1:])
            row = dict(rank=i, ms_per_step=r["ms_per_step"],
                       ms_median_after_first=steady,
                       tokens_per_s=r["tokens"] / (steady / 1e3),
                       peak_gib=r["peak_gib"],
                       bytes_per_step=r["bytes_per_step"],
                       launches=r["launches"])
            per_rank.append(row)
            log(f"parallel 154M {name} rank {i} (mesh {r['mesh']}): "
                f"{steady:.1f} ms/step after the first "
                f"({row['tokens_per_s']:.0f} tok/s of the global batch), "
                f"peak {r['peak_gib']:.2f} GiB, bytes a step "
                f"{ {k: int(v) for k, v in r['bytes_per_step'].items()} }, "
                f"launches {r['launches']}")
        log(f"parallel 154M {name}: competing layers by step {flips}, "
            f"losses {[round(x, 4) for x in head['losses']]}")
        out[name] = dict(flags=PAR_154M_RUNS[name], flips=flips,
                         losses=head["losses"], ranks=per_rank,
                         batch=PAR_154M_BATCH, steps=steps)
    return out


def par_mm(flags, rows_per_rank: int = 2):
    """A rank's run of a small multimodal model (small_mm_config: the
    5.1B's CompeteSMoE tower and projector, mlp2 experts, bf16) through
    cli.train_mm.train over the process group: per-step metrics and its
    top-k choices."""
    import torch

    from competesmoe_tpu_torch.cli.train_mm import train
    from competesmoe_tpu_torch.models.builder import build_llava
    cfg = small_mm_config()
    model = build_llava(cfg, seed=MM_SEED, device="cuda")
    tok = ChatTok(cfg.decoder.vocab_size)
    data = MMConversations(tok, 16, (4, 10), cfg.vision.image_size,
                           seed=MM_SEED, max_len=64)
    a = mm_args(PAR_MM_FLAGS + ["--per-device-batch-size",
                                str(rows_per_rank), *flags],
                _par_tmp("mm"))
    rows, choices = [], []

    def on_step(step, state, metrics, seconds):
        rows.append({k: (v.tolist() if v.numel() > 1 else float(v))
                     for k, v in metrics.items()})
    with routed_as(record=choices):
        train(a, model, data, tok, on_step=on_step, final_save=False)
    del model
    torch.cuda.synchronize()
    return dict(rows=rows, choices=choices)


def parallel_mm_check(ranks):
    """cli.train_mm.train with --n-expert 2 at 2 ranks against one process
    on the card (the same global batch of 4 rows, taking the ranks' top-k
    choices): per step the loss within SMALL_MM_LOSS_TOL, grad_norm within
    SMALL_MM_GRAD_TOL, the same competing layers, and the rows chosen
    otherwise within SMALL_MM_FLIP_SHARE and SMALL_MM_FLIP_GAP."""
    runs = [r["mm"] for r in ranks]
    got = runs[0]["rows"]
    if runs[1]["rows"] != got:
        raise AssertionError("parallel mm: the ranks report other metrics")
    replay = _replay_of([r["choices"] for r in runs], (1, 2), True)
    with routed_as(replay=replay) as seen:
        want = par_mm([], rows_per_rank=4)["rows"]
    share = seen["flipped"] / max(seen["rows"], 1)
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        dl = abs(g["loss/total"] - w["loss/total"])
        dg = abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
        ok = (dl <= SMALL_MM_LOSS_TOL and dg <= SMALL_MM_GRAD_TOL
              and _competed(g) == _competed(w))
        log(f"parallel mm step {i} (competed {_competed(g)}): loss "
            f"{g['loss/total']:.6f} one process {w['loss/total']:.6f} (gap "
            f"{dl:.3g}, tol {SMALL_MM_LOSS_TOL}); grad_norm "
            f"{g['grad_norm']:.6f} one process {w['grad_norm']:.6f} (gap "
            f"{dg:.3g}, tol {SMALL_MM_GRAD_TOL})")
        out.append(dict(step=i, competed=_competed(g), loss_gap=dl,
                        grad_gap=dg, ok=ok))
    log(f"parallel mm: top-k rows chosen otherwise {seen['flipped']} of "
        f"{seen['rows']} ({share:.3%}), gap {seen['gap']:.3g}")
    if not (all(d["ok"] for d in out) and share <= SMALL_MM_FLIP_SHARE
            and seen["gap"] <= SMALL_MM_FLIP_GAP
            and any(d["competed"] for d in out)):
        raise AssertionError(f"parallel mm disagrees: {out}, top-k {share}")
    return dict(steps=out, topk_share=share, topk_gap=seen["gap"])


def _mixtral_aux_inputs():
    import torch
    g = torch.Generator().manual_seed(5)
    return torch.randn(4, 16, 64, generator=g)


def _mixtral_layer():
    from competesmoe_tpu_torch.models.builder import init_random_
    from competesmoe_tpu_torch.moe import get_moe
    layer = get_moe("mixtral")(64, 64, n_experts=8, n_selected=2,
                               device="cuda")
    return init_random_(layer, seed=5, std=0.2)


def par_aux():
    """A rank's Mixtral layer (top-1 balance over the flattened tokens, a
    statistic of every rank's rows) over its rows, the world as the batch
    axis: its balance loss."""
    from competesmoe_tpu_torch.parallel import distributed_ops as D
    from competesmoe_tpu_torch.parallel.mesh import make_mesh, put_batch
    mesh = make_mesh()
    x = put_batch(_mixtral_aux_inputs(), mesh).cuda()
    with D.use_batch_axis(mesh.axis("world")):
        _, aux = _mixtral_layer()(x, train=True)
    return float(aux.losses["balance_loss"])


def _adam8_shapes():
    """(name, shape, shard dim): a cut along a dim the 8-bit blocks do not
    run along, one along the block dim at a multiple of 256, and one that
    would split a block (384 / 2)."""
    return (("rows", (8, 512), 0), ("aligned", (4, 1024), 1),
            ("split", (16, 384), 1))


def _adam8_run(shard_axis=None, steps: int = 3):
    import torch

    from competesmoe_tpu_torch.train.lm_trainer import (OptConfig,
                                                        make_optimizer)
    params, shards = {}, {}
    for n, shape, dim in _adam8_shapes():
        p = torch.full(shape, 0.5, device="cuda")
        if shard_axis is not None:
            k = shape[dim] // shard_axis.size
            p = p.narrow(dim, shard_axis.index * k, k).clone()
            shards[n] = (shard_axis, dim)
        params[n] = p
    # no clipping: the global norm's sum over the shards is added in
    # another order than one process's, and a last-bit change of the
    # clipped gradient can move a moment across a code's rounding edge
    opt = make_optimizer(OptConfig(lr=1e-2, grad_clip=0.0, state_8bit=True,
                                   total_steps=10))
    state = opt.init(params, shards=shards or None)
    g = torch.Generator(device="cuda").manual_seed(7)
    for _ in range(steps):
        grads = {}
        for n, shape, dim in _adam8_shapes():
            full = torch.randn(shape, generator=g, device="cuda")
            if shard_axis is not None:
                k = shape[dim] // shard_axis.size
                full = full.narrow(dim, shard_axis.index * k, k).clone()
            grads[n] = full
        opt.apply(params, grads, state)
    return {n: p.cpu() for n, p in params.items()}


def par_adam8():
    """A rank's 3 steps of the LM optimizer with 8-bit moments on its
    shards of _adam8_shapes."""
    from competesmoe_tpu_torch.parallel.mesh import make_mesh
    return _adam8_run(make_mesh().axis("world"))


def parallel_parts_check(ranks):
    """Mixtral's balance at 2 ranks equals one process's over all rows (a
    per-rank statistic would not); sharded 8-bit Adam's parameters, put
    together, equal the unsharded run's."""
    import torch
    _, aux = _mixtral_layer()(_mixtral_aux_inputs().cuda(), train=True)
    want = float(aux.losses["balance_loss"])
    got = [r["aux"] for r in ranks]
    log(f"parallel aux: Mixtral's balance at 2 ranks {got}, one process "
        f"{want}")
    if not all(abs(g - want) <= 1e-5 * abs(want) for g in got):
        raise AssertionError(f"parallel aux: balance {got} != {want}")
    full = _adam8_run()
    gaps = {}
    for n, _, dim in _adam8_shapes():
        cat = torch.cat([r["adam8"][n] for r in ranks], dim)
        gaps[n] = float((cat - full[n]).abs().max())
    log(f"parallel 8-bit Adam: |sharded - unsharded| after 3 steps {gaps}")
    if max(gaps.values()) > 0.0:
        raise AssertionError(f"parallel 8-bit Adam: sharded != unsharded "
                             f"{gaps}")
    return dict(balance=got, balance_one=want, adam8_gap=gaps)


def nccl_world1_check():
    """NCCL at one rank on the card: each collective the port uses (the
    calls of parallel/collectives.py over a group) runs and returns its
    input. NCCL over several ranks needs a card each: one card cannot
    show it."""
    import tempfile

    import torch
    import torch.distributed as dist

    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel.distributed import (DistributedEnv,
                                                            initialize)
    from competesmoe_tpu_torch.parallel.mesh import Axis
    d = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    initialize(DistributedEnv(), "cuda", init_method=f"file://{d}/init",
               backend="nccl")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        axis = Axis("world", 1, 0, (0,), dist.group.WORLD)
        x = torch.randn(8, 16, device="cuda")
        done = {}
        for name, fn in (
                ("all_to_all", lambda: C.all_to_all(x, axis)),
                ("all_gather", lambda: C.all_gather(x, axis, 1)),
                ("reduce_scatter", lambda: C.reduce_scatter(x, axis, 0)),
                ("all_reduce", lambda: C.all_reduce(x, axis)),
                ("all_reduce_max", lambda: C.raw_all_reduce_max(x, axis))):
            got = fn()
            torch.cuda.synchronize()
            done[name] = bool(torch.equal(got, x))
        flat = [x.clone(), torch.ones(3, device="cuda")]
        C.all_reduce_(flat, axis)
        done["all_reduce_flat"] = bool(torch.equal(flat[0], x))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    log(f"NCCL at one rank: {done} (NCCL across ranks needs a card for "
        f"each; {torch.cuda.device_count()} card(s) here)")
    if not all(done.values()):
        raise AssertionError(f"NCCL collectives at one rank: {done}")
    return done


def _parallel_rank(rank: int, world: int, init: str, out: str, jobs):
    """A rank of phase_parallel: the process group from its environment
    (gloo: the ranks share the card), then `jobs` [(key, function name,
    kwargs)], each result saved for the parent."""
    import os
    import traceback

    import torch
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        plant = os.environ.get("CHIP_SMOKE_PLANT")
        if plant:
            import chip_faults
            chip_faults.apply_parallel_plant(plant)
        from competesmoe_tpu_torch.parallel.distributed import (detect_env,
                                                                initialize)
        initialize(detect_env(), "cuda", init_method=f"file://{init}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res = {}
        for key, fn, kwargs in jobs:
            res[key] = globals()[fn](**kwargs)
            dist.barrier()
        torch.save(res, Path(out) / f"rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(out, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_ranks(world: int, jobs, timeout: float = 600.0):
    """Run `jobs` on `world` ranks, processes on this card over gloo;
    every rank's results (any rank's failure raises, and every process
    is stopped)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, world, str(out / "init"), str(out), jobs))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
            if p.exitcode not in (0, None):
                break               # a rank failed: stop the others
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        errs = "\n".join((out / f"rank{r}.err").read_text()
                         for r, _ in bad if (out / f"rank{r}.err").exists())
        raise AssertionError(f"parallel ranks failed {bad}:\n{errs}")
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)
    return res


def small_parallel_phase(more2=()):
    """The small checks of phase_parallel (chip_faults.py plants faults
    against them): 2 ranks run the PAR_SMALL_RUNS of 2, Mixtral's balance
    and sharded 8-bit Adam (and the jobs `more2`), 4 ranks the runs of 4;
    then small_parallel_check and parallel_parts_check. Returns (summary,
    each world's ranks' results)."""
    t0 = time.perf_counter()
    jobs2 = [(f"small_{n}", "par_small_lm", dict(name=n, flags=f))
             for w, n, f in PAR_SMALL_RUNS if w == 2]
    jobs2 += [("aux", "par_aux", {}), ("adam8", "par_adam8", {}),
              *more2]
    jobs4 = [(f"small_{n}", "par_small_lm", dict(name=n, flags=f))
             for w, n, f in PAR_SMALL_RUNS if w == 4]
    ranks = {2: spawn_ranks(2, jobs2)}
    t2 = time.perf_counter()
    ranks[4] = spawn_ranks(4, jobs4)
    t4 = time.perf_counter()
    summary = dict(small=small_parallel_check(ranks),
                   parts=parallel_parts_check(ranks[2]),
                   seconds=dict(ranks2=t2 - t0, ranks4=t4 - t2))
    return summary, ranks


def phase_parallel(card: str):
    """Data, FSDP and expert parallelism of the LM trainer and
    cli/train_mm with ranks that share the card over gloo: 2 ranks run
    the small LM (expert parallel; gathered experts), Mixtral's balance
    and sharded 8-bit Adam, the 154M sweep three ways (PAR_154M_RUNS) and
    cli.train_mm --n-expert 2; 4 ranks run the small LM 2 x 2 (expert +
    data parallel, then with FSDP); each against one process on the card;
    then NCCL at one rank. Returns the summary and the 154M runs' K1 and
    K2 launches summed over ranks (the phase's main path)."""
    t0 = time.perf_counter()
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "compute_mode", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(f"parallel: backend gloo, 2 and 4 ranks sharing one card: "
        f"{res.stdout.strip()}")
    jobs2 = [(f"lm154m_{n}", "par_154m", dict(name=n, flags=f))
             for n, f in PAR_154M_RUNS.items()]
    jobs2 += [("mm", "par_mm", dict(flags=["--n-expert", "2"]))]
    summary, ranks = small_parallel_phase(jobs2)
    summary.update(card=card, compute_mode=res.stdout.strip(),
                   backend="gloo", ranks_per_card=[2, 4])
    summary["lm154m"] = parallel_154m_check(ranks[2])
    summary["mm"] = parallel_mm_check(ranks[2])
    summary["nccl_world1"] = nccl_world1_check()
    launches = {}
    for name in PAR_154M_RUNS:
        for r in ranks[2]:
            for k, v in r[f"lm154m_{name}"]["launches"].items():
                launches[k] = launches.get(k, 0) + v
    summary.update(launches_154m=launches, seconds=dict(
        total=time.perf_counter() - t0, **summary.pop("seconds")),
        not_run="the 5.1B sft recipe at 2 ranks: one rank alone takes "
                "55.45 GiB of the card (PERF.md), two do not fit")
    log(f"parallel: phase passed in {summary['seconds']['total']:.1f} s")
    free_card()
    return summary, launches


# ---------------------------------------------------------------------------
# Sharded serving and sequence parallelism (phase_sharded): 2 ranks that
# share the card over gloo
# ---------------------------------------------------------------------------

# K3 at each rank's shard of Phi-3.5-mini's decode projections under
# --mesh 1x2 (32 MHA heads of 96: qkv 3072 -> 3 x 16 heads, o from 16
# heads, gate_up 3072 -> 2 x 4096, down from 4096)
TP_SHARD_SHAPES = (("qkv_proj/2", 3072, 4608), ("o_proj/2", 1536, 3072),
                   ("gate_up_proj/2", 3072, 8192), ("down_proj/2", 4096,
                                                    3072))
SHARDED_PROMPTS = ("what color is the cat on the mat",
                   "describe the picture in a few words please",
                   "hello there how are you doing today")
SHARDED_NEW_TOKENS = 12
SHARDED_SLOTS = 4
SHARDED_MAX_LEN = 1024           # an image prompt splices 729 tokens
# the Mixtral decoder of HF_CUMO_MIXTRAL at full width, its depth cut to 4
MIXTRAL_EP_LAYERS = 4
# the 154M sweep on the ring: -n_seq_shards 2 (each rank half of each
# row's 1024 tokens), K1 as the local MoE compute, K2 not launched
SEQ_154M_FLAGS = ["-moe.impl", "fused", "-transformer.attn_backend",
                  "flash"]
SEQ_154M_STEPS = 4
# the runs of phase_sharded, in their order
SHARDED_KEYS = ("tp_bf16", "eval", "tp_int4", "ep_tower", "ep_mixtral",
                "seq_154m")
# the expert-parallel engines against one process whose MoE layers take
# the grouped path (`impl='grouped'`), as each rank's do: each image's
# projector output within this share of its largest magnitude, the
# streams under the parting rule at 3%. The towers and projectors of
# these runs compute in float32 (`_f32_tower`). In bf16 a rounding apart
# anywhere in a tower's 24-27 MoE layers moves the projector output by
# 0.62-0.88 of its largest magnitude on the H100, as far as one
# process's default path (dense where E <= 2k) lies from its grouped
# path (0.65-0.74), and the image streams part beyond 3% (PERF.md). In
# float32 the EP runs read 0.0056-0.0060 and that control 0.0084-0.0121,
# which is read beside them; the bound is four times the control's
# largest reading
EP_FEATURE_TOL = 0.05
_RANK_MODELS = {}          # a rank's models, kept from one job to the next


def _rank_model(kind: str, seed: int):
    """A rank's 5.1B model of `kind` ('bf16' with K3, 'int4'), built once
    from the seed and kept for the rank's later jobs."""
    if kind not in _RANK_MODELS:
        _RANK_MODELS.clear()
        free_card()
        _RANK_MODELS[kind] = build_served(kind, seed, "cuda")
    return _RANK_MODELS[kind]


def _prompt_ids(model, tok):
    """SHARDED_PROMPTS as the worker tokenizes them (the tokenizer assigns
    word ids in this order, on every side that compares)."""
    from competesmoe_tpu_torch.eval.llava_adapter import TorchLlava
    lm = TorchLlava(model, tok)
    return [np.asarray(lm.tokenizer_ids_for_prompt(p, False), np.int32)
            for p in SHARDED_PROMPTS]


def _profile_step(engine, nth: int, out: dict):
    """Time the engine's device step `nth` - 1 on this rank (`step_ms`,
    the host clock to the card's synchronise) and profile step `nth`
    (every rank takes the same steps) as `replay_kernels` profiles a
    replay (a host wait and a lead-in of spin kernels first, spin kernels
    left out): its kernels {name: launches} in `out`, the wrappers'
    launches over the step under "wrappers" and the host ops with the
    most self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    orig, seen = engine._step, [0]

    def step(kind, nucleus):
        seen[0] += 1
        if seen[0] == nth - 1:               # the step before: its wall
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig(kind, nucleus)
            torch.cuda.synchronize()
            out["step_ms"] = (time.perf_counter() - t0) * 1e3
            return res
        if seen[0] != nth:
            return orig(kind, nucleus)
        torch.cuda.synchronize()
        before = read_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(REPLAY_HOST_WAIT_S)
            for _ in range(REPLAY_LEAD_IN):
                torch.cuda._sleep(100)
            torch.cuda._sleep(REPLAY_PAD_CYCLES)
            res = orig(kind, nucleus)
            torch.cuda._sleep(REPLAY_PAD_CYCLES)
            torch.cuda.synchronize()
        out["wrappers"] = {k: v - before[k] for k, v in read_counts().items()}
        # where the host's time went: the ops with the most self time
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        out["top_host_ms"] = {e.key: round(e.self_cpu_time_total / 1e3, 3)
                              for e in ops[:8]}
        for ev in prof.events():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in ev.name):
                out[ev.name] = out.get(ev.name, 0) + 1
        return res
    engine._step = step


def _record_submits(engine, got: dict):
    """Record each request's tokens by its prompt ids (rank 0)."""
    orig = engine.submit

    def submit(ids, **kw):
        toks = got[tuple(int(t) for t in ids)] = []   # the last one's
        for t in orig(ids, **kw):
            toks.append(t)
            yield t
    engine.submit = submit


def sh_worker(kind: str, seed: int):
    """A rank of `model_worker --mesh 1x2 --engine-slots 4` over the 5.1B
    of `kind` (the worker's own build_serving, from a model built from the
    seed and EvalTok): rank 0 answers SHARDED_PROMPTS over HTTP, three at
    once, the other rank follows its ticks. Per rank: the launches over
    the requests, a profiled decode step's kernels and the bytes through
    each collective; rank 0 also the tokens, the answers and the wall."""
    import threading

    import torch

    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.serve import model_worker as W
    model = _rank_model(kind, seed)
    tok = EvalTok(model.cfg.decoder.vocab_size)
    ids = _prompt_ids(model, tok)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    a = W.parse_args(["--device", "cuda", "--no-register", "--mesh", "1x2",
                      "--engine-slots", str(SHARDED_SLOTS),
                      "--engine-max-len", str(SHARDED_MAX_LEN),
                      "--max-new-tokens", str(SHARDED_NEW_TOKENS),
                      "--tokenizer", "unused"])
    served = W.build_serving(a, model=model, tokenizer=tok,
                             model_name="competesmoe-5.1b")
    prof, got = {}, {}
    _profile_step(served.engine, 4, prof)
    C.reset_bytes()
    torch.cuda.synchronize()
    reset_counts()                            # main path starts here
    out = dict(heads=model.language_model.layers[0].self_attn.n_heads)
    if not served.lead:
        served.follow()
        torch.cuda.synchronize()
        out.update(counts=read_counts(), profiled=prof, bytes=dict(C.BYTES))
        return out
    _record_submits(served.engine, got)
    httpd = W.serve_worker(served.worker, "127.0.0.1", port,
                           background=True)
    answers = {}

    def client(i):
        answers[i] = post_stream(port, SHARDED_PROMPTS[i],
                                 SHARDED_NEW_TOKENS)
    try:
        # a first request takes the first uses (allocator blocks, library
        # handles) out of the timed window; its launches count
        post_stream(port, SHARDED_PROMPTS[0], 2)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(SHARDED_PROMPTS))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.close()
    torch.cuda.synchronize()
    out.update(counts=read_counts(), profiled=prof, bytes=dict(C.BYTES),
               wall_s=wall, tokens=[got.get(tuple(int(t) for t in x))
                                    for x in ids],
               answers=[answers.get(i) for i in range(len(ids))],
               error=repr(served.engine.error))
    return out


def sh_eval(seed: int):
    """cli/eval_mm --mesh 1x2 on the bf16 5.1B (placed by the worker's
    job already): rank 0 scores SH_EVAL tasks, the other rank makes its
    model calls in lockstep. Rank 0's results."""
    import torch
    model = _rank_model("bf16", seed)
    tok = EvalTok(model.cfg.decoder.vocab_size)
    gen, ll = _sh_eval_tasks(seed, model.cfg.vision.image_size)
    from competesmoe_tpu_torch.cli.eval_mm import run
    reset_counts()
    with contextlib.redirect_stdout(sys.stderr):
        res = run(eval_args(tasks=f"{gen},{ll}", mesh="1x2", device="cuda",
                            batch_size=2, max_new_tokens=8,
                            output_path=str(Path(_par_tmp("sh_eval"))
                                            / "results.json")),
                  model=model, tokenizer=tok)
    torch.cuda.synchronize()
    if not res:                               # a follower: no results
        return dict(counts=read_counts())
    res = res[0]
    return dict(counts=read_counts(), answers=texts(res, gen),
                ll={s["doc_id"]: s["resps"][0] for s in
                    res["samples"][ll]})


def _sh_eval_tasks(seed: int, size: int):
    gen_docs = pope_docs(seed + 70, 4, size, text_every=2)
    ll_docs = pope_docs(seed + 71, 3, size, text_every=2)
    for d in ll_docs:
        d["target"] = f"{d['answer']} it is"
    return register_eval_tasks("sh_eval", gen_docs, ll_docs, False, 8)


def _image_requests(model, seed: int, n_text: int = 2, n_image: int = 2):
    rng = np.random.default_rng(seed + 80)
    return engine_requests(rng, model.cfg.decoder.vocab_size, n_text,
                           n_image, model.cfg.vision.image_size,
                           lengths=(20, 60))


def _engine_streams(model, reqs, mesh=None, eos_ids=None):
    """Greedy SHARDED_NEW_TOKENS-token streams of `reqs` (ending at
    `eos_ids`), as `submit` would yield them, from an eager DecodeEngine
    of SHARDED_SLOTS slots (a mesh's over gloo cannot be captured, and
    one process's runs the same steps) ticked here with every request
    made before the first tick, so its admission groups are the same in
    every run; rank 0's streams, None on the other ranks."""
    from competesmoe_tpu_torch.serve.engine import DecodeEngine
    eng = DecodeEngine(model, n_slots=SHARDED_SLOTS,
                       max_len=SHARDED_MAX_LEN, mesh=mesh,
                       cuda_graphs=False, run_thread=False)
    if mesh is not None and mesh.rank != 0:
        eng.follow()
        return None
    made = [eng._make_request(ids, px, max_new_tokens=SHARDED_NEW_TOKENS,
                              eos_ids=eos_ids) for ids, px in reqs]
    try:
        for _ in range(100 * SHARDED_NEW_TOKENS):
            if eng.error is not None or all(r.done for r in made):
                break
            eng._tick()
        eng._tick()                    # deliver what a pipeline still holds
    finally:
        eng.shutdown()
    if eng.error is not None or not all(r.done for r in made):
        raise AssertionError(f"engine did not finish: {eng.error!r}")
    streams = []
    for r in made:
        toks = []
        while (t := r.out.get_nowait()) is not None:
            toks.append(t)
        streams.append(toks)
    return streams


def _f32_tower(cfg):
    """`cfg` with its vision tower and projector in float32."""
    import torch
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, dtype=torch.float32),
        projector=dataclasses.replace(cfg.projector, dtype=torch.float32))


def _ep_model(which: str, seed: int):
    """The models of the --ep-shards 2 runs, random weights from the seed,
    --load-4bit, tower and projector in float32 (`_f32_tower`): 'tower'
    the 5.1B; 'mixtral' HF_CUMO_MIXTRAL at full width cut to 4 layers
    (the experts and the gate stay bf16; K5 at q, k, v and o)."""
    import torch

    from competesmoe_tpu_torch.models.builder import (apply_load_4bit,
                                                      build_llava,
                                                      llava_config_from_hf)
    if which == "tower":
        cfg = served_config("int4", small=False)
    else:
        cfg = llava_config_from_hf(
            dict(HF_CUMO_MIXTRAL, num_hidden_layers=MIXTRAL_EP_LAYERS),
            "llava_mixtral", torch.bfloat16)
    return apply_load_4bit(build_llava(_f32_tower(cfg), seed=seed,
                                       device="cuda"))


def sh_ep(which: str, seed: int):
    """--ep-shards 2's placement (`shard_llava_ep`) over `_ep_model`:
    'tower' the int4 5.1B (its MoE tower and projector by all-to-all at
    prefill) on image and text prompts, 'mixtral' the 4-layer Mixtral
    decoder (all-to-all every step) through the engine. Rank 0's streams and each image's projector
    output (`_image_features`); every rank's launches and bytes over the
    engine's run."""
    import torch

    from competesmoe_tpu_torch.parallel import collectives as C
    from competesmoe_tpu_torch.parallel.ep_context import set_ep_mesh
    from competesmoe_tpu_torch.parallel.mesh import make_mesh
    from competesmoe_tpu_torch.parallel.tensor_parallel import shard_llava_ep
    _RANK_MODELS.clear()
    free_card()
    model = _ep_model(which, seed)
    mesh = make_mesh(n_expert=2)
    shard_llava_ep(model, mesh)
    reqs = _image_requests(model, seed)
    C.reset_bytes()
    reset_counts()                            # main path starts here
    try:
        t0 = time.perf_counter()
        streams = _engine_streams(model, reqs, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, sent = read_counts(), dict(C.BYTES)   # main path ends here
        feats = _image_features(model, reqs)  # every rank: the all-to-all
    finally:
        set_ep_mesh(None)
    out = dict(counts=counts, bytes=sent, streams=streams, wall_s=wall,
               feats=feats if mesh.rank == 0 else None)
    _RANK_MODELS.clear()
    del model
    free_card()
    return out


def sh_seq_154m(seed: int):
    """The 154M sweep at PAR_154M_BATCH rows with SEQ_154M_FLAGS and
    -n_seq_shards 2 through the CLI's task for SEQ_154M_STEPS steps (the
    competition steps of its schedule included): par_154m's readings."""
    _RANK_MODELS.clear()
    free_card()
    return par_154m("seq", SEQ_154M_FLAGS + ["-n_seq_shards", "2"],
                    steps=SEQ_154M_STEPS)


def stream_margins(model, ids, px, stream):
    """`reference_margin` at every step of a greedy `stream` from one
    teacher-forced forward: per step j (0..len(stream)), the top-2 margin
    of the logits that predict token j and the largest logit magnitude
    over the rows that predict tokens 0..j (`agree_by_margins` scales it
    by its share)."""
    import torch

    from competesmoe_tpu_torch.models.decoder import KVCache

    dev = model.device
    full = np.concatenate([np.asarray(ids, np.int64),
                           np.asarray(stream, np.int64)])[None]
    n_img = int(np.sum(full == -200))         # image sentinels
    length = full.shape[1] + n_img * (model.cfg.num_image_tokens - 1)
    cache = KVCache.create(model.language_model.cfg, 1, length + 1, dev)
    with torch.no_grad():
        rows = model(torch.as_tensor(full, device=dev),
                     None if px is None else torch.as_tensor(px, device=dev),
                     cache=cache).logits[0, -(len(stream) + 1):].float()
    top2 = rows.topk(2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]).tolist(),
            torch.cummax(rows.abs().amax(dim=-1), dim=0).values.tolist())


def parting(margins, got, want, share: float):
    """Where `got` parts from `want` (None when equal): the step, the
    reference's top-2 margin there and the tolerance (`share` of its
    largest logit), from `stream_margins` of `want`."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if j is None and len(got) == len(want):
        return None
    if j is None:
        j = min(len(got), len(want))        # a stream that stops parts there
    return dict(step=j, margin=margins[0][j], tol=share * margins[1][j])


def agree_by_margins(margins, got, want, what: str, share: float = 0.03):
    """`agree` with the reference's margins taken beforehand
    (`stream_margins` of `want`), so the reference model need not stay
    on the card: None when equal; else the parting step, margin and
    tolerance, or raises."""
    part = parting(margins, got, want, share)
    if part is not None and part["margin"] > part["tol"]:
        raise AssertionError(f"{what}: the streams part at step "
                             f"{part['step']} where the top-2 margin "
                             f"{part['margin']:.4g} exceeds the tolerance "
                             f"{part['tol']:.4g}")
    return part


def _ref_streams(model, reqs, eos_ids=None):
    """One process's streams of `reqs` and each one's margins."""
    streams = _engine_streams(model, reqs, eos_ids=eos_ids)
    return dict(reqs=reqs, streams=streams,
                margins=[stream_margins(model, ids, px, s)
                         for (ids, px), s in zip(reqs, streams)])


def _image_features(model, reqs):
    """Each image request's projector output (`encode_images` of its
    pixels alone) as float32 on the host."""
    import torch
    with torch.no_grad():
        return [model.encode_images(torch.as_tensor(
            px, device=model.device))[0].float().cpu()
            for _, px in reqs if px is not None]


def _ep_reference(model, reqs):
    """One process's reference for an expert-parallel engine: the streams,
    margins and image features with every MoE layer on the grouped path
    (the arithmetic each rank of --ep-shards runs on its slots); beside
    them, the control: the default path's (dense where E <= 2k) streams
    and features."""
    from competesmoe_tpu_torch.moe.layers import MoeLayerBase
    control = dict(streams=_engine_streams(model, reqs),
                   feats=_image_features(model, reqs))
    layers = [m for m in model.modules() if isinstance(m, MoeLayerBase)]
    impls = [m.impl for m in layers]
    for m in layers:
        m.impl = "grouped"
    try:
        ref = _ref_streams(model, reqs)
        ref["feats"] = _image_features(model, reqs)
    finally:
        for m, impl in zip(layers, impls):
            m.impl = impl
    ref["control"] = control
    return ref


def _sh_references(seed: int, keys=SHARDED_KEYS):
    """One process on the card, for the runs named in `keys`: the bf16
    and int4 5.1B engines on SHARDED_PROMPTS, cli/eval_mm on the SH_EVAL
    tasks, the int4 5.1B and the 4-layer Mixtral engines of `_ep_model`
    on the image prompts (`_ep_reference`), each stream's margins for the
    parting rule, and the 154M sweep with flash attention. Every model is
    freed before the ranks start."""
    import torch
    refs = {}
    for kind in ("bf16", "int4"):
        if f"tp_{kind}" not in keys and not (kind == "bf16"
                                             and "eval" in keys):
            continue
        model = build_served(kind, seed, "cuda")
        tok = EvalTok(model.cfg.decoder.vocab_size)
        if f"tp_{kind}" in keys:
            refs[f"tp_{kind}"] = _ref_streams(
                model, [(x, None) for x in _prompt_ids(model, tok)],
                eos_ids=[tok.eos_token_id])
        if kind == "bf16" and "eval" in keys:
            # a fresh tokenizer, as the ranks' eval run has
            tok = EvalTok(model.cfg.decoder.vocab_size)
            gen, ll = _sh_eval_tasks(seed, model.cfg.vision.image_size)
            res = eval_run(tok, model, tasks=f"{gen},{ll}", device="cuda",
                           batch_size=2, max_new_tokens=8,
                           output_path=str(Path(_par_tmp("sh_eval1"))
                                           / "results.json"))
            answers = texts(res, gen)
            margins = {}
            for d, text in answers.items():
                ids, px = doc_prompt(model, tok, gen, d)
                margins[d] = stream_margins(model, ids, px,
                                            tok.tokens_of(text))
            refs["eval"] = dict(answers=answers, margins=margins, tok=tok,
                                ll={s["doc_id"]: s["resps"][0]
                                    for s in res["samples"][ll]})
        del model
        free_card()
    for which in ("tower", "mixtral"):
        if f"ep_{which}" not in keys:
            continue
        model = _ep_model(which, seed)
        refs[f"ep_{which}"] = _ep_reference(model,
                                            _image_requests(model, seed))
        del model
        free_card()
    torch.cuda.synchronize()
    if "seq_154m" in keys:
        refs["seq_154m"] = par_154m("seq1", SEQ_154M_FLAGS,
                                    steps=SEQ_154M_STEPS)
        free_card()
    return refs


def _streams_agree(ref, got, what):
    """Each stream equal to the reference's or parting only under the
    parting rule at 3% (`agree_by_margins`): the parted steps."""
    return [agree_by_margins(m, g, w, f"{what} request {i}")
            for i, (g, w, m) in enumerate(zip(got, ref["streams"],
                                              ref["margins"]))]


def _tp_check(ranks, refs, kind, name, frag):
    """(a): the worker --mesh 1x2 runs of `kind` against one process."""
    dec = served_config("bf16", small=False).decoder
    L, h = dec.num_hidden_layers, dec.num_attention_heads
    runs = [r[f"tp_{kind}"] for r in ranks]
    head, ref = runs[0], refs[f"tp_{kind}"]
    if any(a is None or not a or a[-1]["error_code"] != 0
           for a in head["answers"]):
        raise AssertionError(f"worker answers: {head['answers']}")
    parted = _streams_agree(ref, head["tokens"],
                            f"TP {kind} (1 x 2) vs one process")
    # bf16 shards the heads, quantized projections replicate
    want_heads = h // 2 if kind == "bf16" else h
    per_rank = []
    for i, r in enumerate(runs):
        if r["heads"] != want_heads:
            raise AssertionError(f"rank {i}: layer 0 holds {r['heads']} "
                                 f"heads")
        # the wrappers' count over the profiled step, exactly; the
        # profiler's records of it (which have dropped a window's first
        # records, `replay_kernels`) at most 2 fewer
        prof = r["profiled"]
        step = sum(c for k, c in prof.items()
                   if k != "wrappers" and frag in k)
        counted = prof.get("wrappers", {}).get(name, 0)
        if counted != 4 * L or not 4 * L - 2 <= step <= 4 * L:
            raise AssertionError(f"rank {i}: a profiled decode step "
                                 f"launched {name} {counted} times and the "
                                 f"profile shows {frag} {step} times, not "
                                 f"4 x {L}")
        if r["counts"][name] == 0 or any(
                v for k, v in r["counts"].items() if k != name):
            raise AssertionError(f"rank {i} launches {r['counts']}")
        per_rank.append(dict(rank=i, launches=r["counts"][name],
                             profiled_step=step, step_launches=counted,
                             step_ms=prof.get("step_ms"),
                             top_host_ms=prof.get("top_host_ms"),
                             bytes=r["bytes"]))
    n_tok = sum(len(t) for t in head["tokens"])
    equal = head["tokens"] == ref["streams"]
    log(f"sharded: worker --mesh 1x2 {kind}: 3 HTTP answers, {n_tok} tokens "
        f"in {head['wall_s']:.2f} s ({n_tok / head['wall_s']:.1f} tok/s over "
        f"gloo, eager), tokens "
        f"{'equal to' if equal else 'parting under the rule from'} one "
        f"process's; {name} per rank {[r['launches'] for r in per_rank]}, "
        f"a profiled decode step {4 * L} on each rank; a step "
        f"{[round(r['step_ms'] or 0, 1) for r in per_rank]} ms, its host "
        f"ops {per_rank[0]['top_host_ms']}")
    return dict(parted=parted, tokens=n_tok, wall_s=head["wall_s"],
                tok_s=n_tok / head["wall_s"], ranks=per_rank, equal=equal)


def _eval_check(ranks, refs):
    """(a): cli/eval_mm --mesh 1x2 against one process: each answer equal
    or parting under the parting rule (as `answers_part`)."""
    ev, ref = ranks[0]["eval"], refs["eval"]
    if sorted(ev["answers"]) != sorted(ref["answers"]):
        raise AssertionError(f"documents {sorted(ev['answers'])} != "
                             f"{sorted(ref['answers'])}")
    tok, parted = ref["tok"], {}
    for d, want in ref["answers"].items():
        got = ev["answers"][d]
        if got != want:
            parted[d] = agree_by_margins(
                ref["margins"][d], tok.tokens_of(got), tok.tokens_of(want),
                f"eval_mm --mesh 1x2 vs one process, doc {d}", 0.03)
    gap = max(abs(ev["ll"][d][0] - ref["ll"][d][0]) for d in ref["ll"])
    log(f"sharded: cli/eval_mm --mesh 1x2: {len(ref['answers'])} answers "
        f"(parted {parted}), loglikelihood totals within {gap:.4g} of one "
        f"process's")
    return dict(parted=parted, docs=len(ref["answers"]), ll_max_gap=gap,
                launches=[r["eval"]["counts"]["small_m_matmul"]
                          for r in ranks])


def _feature_gap(got, want):
    """max |got - want| over the images, as a share of the largest
    |want|."""
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / top


def _ep_check(ranks, refs, which):
    """(b): the --ep-shards 2 engine runs against one process on the
    grouped path (`_ep_reference`): each image's projector output within
    EP_FEATURE_TOL, the streams under the parting rule at 3%; the
    control (one process's default path against its grouped path) is
    read beside them."""
    runs = [r[f"ep_{which}"] for r in ranks]
    ref = refs[f"ep_{which}"]
    n_tok = sum(len(t) for t in runs[0]["streams"])
    wall = runs[0]["wall_s"]
    log(f"sharded: --ep-shards 2 {which}: {n_tok} tokens in {wall:.2f} s "
        f"({n_tok / wall:.1f} tok/s), all-to-all bytes per rank "
        f"{[r['bytes'].get('all_to_all', 0) for r in runs]}")
    if not all(r["bytes"].get("all_to_all", 0) > 0 for r in runs):
        raise AssertionError(f"no all-to-all {[r['bytes'] for r in runs]}")
    gap = _feature_gap(runs[0]["feats"], ref["feats"])
    control = ref["control"]
    control_gap = _feature_gap(control["feats"], ref["feats"])
    control_parted = [parting(m, g, w, 0.03) for g, w, m in zip(
        control["streams"], ref["streams"], ref["margins"])]
    log(f"sharded: --ep-shards 2 {which}: image features within {gap:.4g} "
        f"of one process's grouped path (tol {EP_FEATURE_TOL:.4g}); "
        f"control: one process's default path within {control_gap:.4g}, "
        f"its streams part {control_parted}")
    if not gap <= EP_FEATURE_TOL:
        raise AssertionError(f"EP {which}: image features {gap:.4g} of the "
                             f"largest off one process's grouped path")
    parted = _streams_agree(ref, runs[0]["streams"],
                            f"EP {which} vs one process")
    log(f"sharded: --ep-shards 2 {which}: parted {parted}")
    return dict(parted=parted, tokens=n_tok, wall_s=wall, tok_s=n_tok / wall,
                feature_gap=gap, control_feature_gap=control_gap,
                control_parted=control_parted,
                equal=runs[0]["streams"] == ref["streams"],
                launches=[r["counts"]["quant_small_m_matmul_int4"]
                          for r in runs],
                bytes=[r["bytes"] for r in runs])


def _seq_check(ranks, refs):
    """(c): the 154M sweep with -n_seq_shards 2 against one process."""
    runs = [r["seq_154m"] for r in ranks]
    ref = refs["seq_154m"]
    gaps = [abs(a - b) for a, b in zip(runs[0]["losses"], ref["losses"])]
    grad_gaps = [abs(a - b) / b for a, b in zip(runs[0]["grad_norms"],
                                                ref["grad_norms"])]
    flips = runs[0]["flips"]
    fused = sum(runs[0]["layers"] - f for f in flips)
    steady = [statistics.median(r["ms_per_step"][1:]) for r in runs]
    one_ms = statistics.median(ref["ms_per_step"][1:])
    log(f"sharded: 154M -n_seq_shards 2: losses {runs[0]['losses']} vs one "
        f"process {ref['losses']} (max gap {max(gaps):.3g}), grad norms "
        f"{runs[0]['grad_norms']} vs {ref['grad_norms']} (max share "
        f"{max(grad_gaps):.3g}), "
        f"{steady[0]:.1f} ms/step after the first (one process "
        f"{one_ms:.1f}), bytes a step "
        f"{ {k: int(v) for k, v in runs[0]['bytes_per_step'].items()} }, "
        f"launches {[r['launches'] for r in runs]}")
    if not (max(gaps) <= SMALL_LM_LOSS_TOL
            and max(grad_gaps) <= SMALL_LM_GRAD_TOL):
        raise AssertionError(f"losses {runs[0]['losses']} vs one process "
                             f"{ref['losses']}: gaps {gaps}; grad norms "
                             f"{runs[0]['grad_norms']} vs "
                             f"{ref['grad_norms']}: shares {grad_gaps}")
    if not max(flips):
        raise AssertionError(f"no competition step in {flips}")
    for i, r in enumerate(runs):
        c = r["launches"]
        if (c["gmm2_fused_aligned"] != fused or c["gmm2_bwd_dx"] != fused
                or c["gmm2_bwd_dw"] != fused
                or any(c[k] for k in ("flash_attention_fwd",
                                      "flash_attention_bwd_dkv",
                                      "flash_attention_bwd_dq"))):
            raise AssertionError(f"rank {i} launches {c}: K1 {fused}, K2 0")
    return dict(losses=runs[0]["losses"], one_process=ref["losses"],
                gaps=gaps, grad_norms=runs[0]["grad_norms"],
                one_process_grad_norms=ref["grad_norms"],
                grad_gaps=grad_gaps, flips=flips, ms_median_after_first=steady,
                one_process_ms=one_ms,
                bytes_per_step=[r["bytes_per_step"] for r in runs],
                peak_gib=[r["peak_gib"] for r in runs],
                launches=[r["launches"] for r in runs])


def sharded_check(ranks, refs, keys=SHARDED_KEYS):
    """The phase's checks and readings (see phase_sharded) of the runs
    named in `keys`. Every check runs; the failures of all of them raise
    together at the end."""
    out, failures = {}, []
    checks = [("tp_bf16", lambda: _tp_check(ranks, refs, "bf16",
                                            "small_m_matmul",
                                            "mm_bf16_kernel")),
              ("tp_int4", lambda: _tp_check(ranks, refs, "int4",
                                            "quant_small_m_matmul_int4",
                                            "qmm4_kernel")),
              ("eval", lambda: _eval_check(ranks, refs)),
              ("ep_tower", lambda: _ep_check(ranks, refs, "tower")),
              ("ep_mixtral", lambda: _ep_check(ranks, refs, "mixtral")),
              ("seq_154m", lambda: _seq_check(ranks, refs))]
    for key, check in checks:
        if key not in keys:
            continue
        try:
            out[key] = check()
        except AssertionError as e:
            failures.append(f"{key}: {e}")
            log(f"sharded: {key} FAILED: {e}")
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_sharded(card: str, seed: int, keys=SHARDED_KEYS):
    """Sharded serving and the ring on 2 ranks sharing the card over gloo
    (NCCL across cards is written and unrun): (a) the 5.1B at full width
    served by the worker with --mesh 1x2 --engine-slots 4, bf16 (K3 on
    each rank's shard) and --load-4bit (K5; quantized projections
    replicate): three
    HTTP answers from rank 0, greedy tokens equal to one process's engine
    or parting only under the parting rule, a profiled decode step of each
    rank with its 4 x 32 kernel launches; cli/eval_mm --mesh 1x2 on a few
    documents; (b) --ep-shards 2: the int4 5.1B on image prompts (the
    tower's all-to-all at prefill) and the 4-layer Mixtral decoder through
    the engine, towers and projectors in float32, against one process on the grouped path (image features
    within EP_FEATURE_TOL, tokens at 3%); (c) the 154M sweep with
    -n_seq_shards 2 for 4 steps: losses within SMALL_LM_LOSS_TOL and
    grad norms within SMALL_LM_GRAD_TOL of one process's, K1 forward and
    backward launched, K2 not; (e) K3 at each TP shard shape against its plain
    version, timed beside its bound and torch.matmul. `keys`: the runs
    to make (chip_faults.py makes some of them with a fault planted).
    Returns (summary, launches of the main paths summed over ranks)."""
    t0 = time.perf_counter()
    rows, k3_err, _ = phase_small_m(
        kernels={"small_m_matmul": ("K3", (1, SHARDED_SLOTS), ())},
        shapes=TP_SHARD_SHAPES)
    refs = _sh_references(seed, keys)
    t_ref = time.perf_counter()
    jobs = [("tp_bf16", "sh_worker", dict(kind="bf16", seed=seed)),
            ("eval", "sh_eval", dict(seed=seed)),
            ("tp_int4", "sh_worker", dict(kind="int4", seed=seed)),
            ("ep_tower", "sh_ep", dict(which="tower", seed=seed)),
            ("ep_mixtral", "sh_ep", dict(which="mixtral", seed=seed)),
            ("seq_154m", "sh_seq_154m", dict(seed=seed))]
    ranks = spawn_ranks(2, [j for j in jobs if j[0] in keys])
    t_ranks = time.perf_counter()
    summary = sharded_check(ranks, refs, keys)
    launches = {}
    for r in ranks:
        for key in keys:
            counts = r[key]["launches" if key == "seq_154m" else "counts"]
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    summary.update(card=card, backend="gloo", ranks=2, k3_shards=rows,
                   k3_max_abs_err=k3_err["small_m_matmul"],
                   launches=launches, not_run=(
                       "NCCL across cards (written: batch_isend_irecv ring "
                       "shifts, captured TP ticks; one card here)"),
                   seconds=dict(references=t_ref - t0,
                                ranks=t_ranks - t_ref,
                                total=time.perf_counter() - t0))
    log(f"sharded: phase passed in {summary['seconds']['total']:.1f} s")
    return summary, launches


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
    ap.add_argument("--only", choices=["lm_rest", "parallel", "sharded"],
                    help="run this phase alone (after the build), print its "
                         "summary and stop")
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
    if a.only == "lm_rest":
        print("lm_rest_summary " + json.dumps(dict(phase_lm_rest(a.seed),
                                                   card=card)), flush=True)
        log(f"chip_smoke --only lm_rest: passed in "
            f"{time.perf_counter() - t_main:.1f} s")
        return 0
    if a.only == "parallel":
        print("parallel_summary " + json.dumps(phase_parallel(card)[0]),
              flush=True)
        log(f"chip_smoke --only parallel: passed in "
            f"{time.perf_counter() - t_main:.1f} s")
        return 0
    if a.only == "sharded":
        print("sharded_summary " + json.dumps(
            phase_sharded(card, a.seed)[0]), flush=True)
        log(f"chip_smoke --only sharded: passed in "
            f"{time.perf_counter() - t_main:.1f} s")
        return 0
    small_rows, small_err, library_why = phase_small_m()
    print("kernel_shapes " + json.dumps({
        "card": card, "rows": small_rows,
        "k4_library": library_why["K4"] or "torch._weight_int8pack_mm",
        "k5_library": library_why["K5"] or "torch._weight_int4pack_mm"}),
        flush=True)
    print("k5_new_shapes " + json.dumps(k5_new_shapes()), flush=True)
    k1 = phase_k1(a.seed)
    k1_bwd = phase_k1_bwd(a.seed)
    k2 = phase_k2(a.seed)
    router_weights_check(a.seed)
    small_lm = small_lm_check()
    task, lm = phase_lm(a.seed)
    lm["profile"] = profile_cell(task, "competesmoe")
    del task
    free_card()
    lm["routers"] = {}
    for name in ROUTER_SWEEPS:
        task, lm["routers"][name] = phase_router(name, a.seed)
        lm["routers"][name]["profile"] = profile_cell(task, name)
        del task
        free_card()
    lm["small_lm"] = small_lm
    print("lm_summary " + json.dumps(dict(lm, card=card)), flush=True)
    small_model_check(a.seed)
    small = [small_engine_check("int4", a.seed)]
    small_engine_features_check(a.seed)
    graphs = dict(card=card, small=small_captured_check(a.seed))
    small_eval = small_eval_check(a.seed)
    small_options = small_options_check(a.seed)
    small_routers = small_routers_check(a.seed)
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
    eval_k5, eval_summary = phase_eval(a.seed, model)
    eval_summary["small"] = small_eval
    print("eval_summary " + json.dumps(eval_summary), flush=True)
    options_k5, options = phase_serving_options(a.seed, model, want_tokens)
    options["small"] = small_options
    print("options_summary " + json.dumps(options), flush=True)
    del model
    free_card()
    print("eval_bound_summary " + json.dumps(settle_eval_bound(a.seed)),
          flush=True)
    cumo_k5, cumo = phase_cumo(a.seed)
    print("cumo_summary " + json.dumps(cumo), flush=True)
    mpt_k5, mpt = phase_mpt(a.seed)
    print("mpt_summary " + json.dumps(mpt), flush=True)
    mixtral_k5, mixtral = phase_mixtral(a.seed)
    print("mixtral_summary " + json.dumps(mixtral), flush=True)
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
    free_card()
    mm = dict(small=small_mm_train_check(a.seed))
    mm.update(phase_mm_train(a.seed, profile=a.profile))
    print("mm_train_summary " + json.dumps(mm), flush=True)
    print("mm_routers_summary " + json.dumps(dict(
        card=card, small=small_routers, full=phase_mm_routers(a.seed))),
        flush=True)
    free_card()
    parallel, par_launches = phase_parallel(card)
    print("parallel_summary " + json.dumps(parallel), flush=True)
    free_card()
    sharded, sh_launches = phase_sharded(card, a.seed)
    print("sharded_summary " + json.dumps(sharded), flush=True)
    # last: its profiler trace and 154M runs touch no replay check after it
    free_card()
    print("lm_rest_summary " + json.dumps(dict(phase_lm_rest(a.seed),
                                               card=card)), flush=True)
    small_err["small_m_matmul"] = max(small_err["small_m_matmul"],
                                      sharded["k3_max_abs_err"])
    rows = [small_m_summary(small_rows, name, launches, small_err[name], m)
            for name, launches, m in (
                ("quant_small_m_matmul_int4",
                 k5_launches + engines["int4"]["launches"]
                 + features["launches"] + eval_k5 + options_k5 + cumo_k5
                 + mpt_k5 + mixtral_k5
                 + sh_launches["quant_small_m_matmul_int4"], 1),
                ("small_m_matmul", engines["bf16"]["launches"]
                 + sh_launches["small_m_matmul"], 8),
                ("quant_small_m_matmul", engines["int8"]["launches"], 8))]
    for row in [k1, k1_bwd["gmm2_bwd_dx"], k1_bwd["gmm2_bwd_dw"]] + [
            k2[n] for n in ("flash_attention_fwd",
                                       "flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq")]:
        # the 154M CompeteSMoE cell's launches and the parallel 154M
        # runs', every rank's (phase_parallel, and the ring's in
        # phase_sharded: K2 0 there)
        rows.append(dict(name=row["name"],
                         launches=lm["launches"][row["name"]]
                         + par_launches[row["name"]]
                         + sh_launches[row["name"]],
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
