"""Multimodal training entry point, the `moe-train` role (port of
competesmoe_tpu/cli/train_mm.py), on one device or several ranks.

Wires the LLaVA data pipeline, the 3-stage recipe, the flip schedules, the
Saver and the metric logger into a loop with gradient accumulation,
resume and optional LoRA training:

  python -m competesmoe_tpu_torch.cli.train_mm \\
    --data-path llava_665k.json --image-folder images/ \\
    --tokenizer microsoft/Phi-3.5-mini-instruct --model-dir phi35-siglip/ \\
    --stage sft --grad-accum 2 --remat --opt-state-8bit ...

`main` builds the file-backed dataset and a `transformers` tokenizer and
calls `train`, which takes any dataset object (`__len__`, `__getitem__`,
`modality_lengths`) and tokenizer object (`pad_token_id`). Runs on the
card unless `--device cpu`.

Several ranks (`python -m torch.distributed.run --nproc-per-node N -m
competesmoe_tpu_torch.cli.train_mm ...`, or a SLURM job): the process
group comes from the scheduler's environment (`parallel.distributed.
initialize`), the ranks form JAX's ('data', 'expert') grid with
`--n-expert` ranks on the expert axis, and the global batch is
`--per-device-batch-size` x ranks, each rank keeping its rows of each
accumulation microbatch. `--n-expert > 1` shards the expert banks and
dispatches the tokens and the competition step over that axis
(`parallel/expert_parallel.py`); `--fsdp` (the default, as in JAX) shards
the dense parameters of at least 2^16 elements over 'data'. One rank is
the unsharded layout. Only rank 0 logs and writes the checkpoint (the
gathered full state).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

VERSIONS = ["phi35", "phi3", "v1", "llama_2", "mpt", "smollm", "plain"]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    # data
    ap.add_argument("--data-path", default="")
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--tokenizer", default="", help="HF tokenizer name/dir")
    ap.add_argument("--version", default="phi35", choices=VERSIONS)
    ap.add_argument("--image-aspect-ratio", default="pad")
    ap.add_argument("--model-max-length", type=int, default=2048)
    # model
    ap.add_argument("--model-dir", default="",
                    help="HF checkpoint dir to initialize from "
                         "(builder.load_pretrained_model)")
    ap.add_argument("--moe-name", default="competesmoe")
    ap.add_argument("--num-experts", type=int, default=4)
    ap.add_argument("--num-selected", type=int, default=2)
    ap.add_argument("--clip-smoe", action="store_true", default=True)
    ap.add_argument("--mlp-smoe", action="store_true", default=True)
    # schedule / losses (sft.sh defaults)
    ap.add_argument("--rate-flip", type=float, default=0.05)
    ap.add_argument("--warm-up", type=float, default=0.0)
    ap.add_argument("--max-compete-in-iter", type=int, default=2)
    ap.add_argument("--balance-loss-coef", type=float, default=0.01)
    ap.add_argument("--router-z-loss-coef", type=float, default=0.001)
    # train
    ap.add_argument("--stage", default="sft",
                    choices=["pretrain", "pft", "sft"])
    ap.add_argument("--learning-rate", type=float, default=4e-6)
    ap.add_argument("--mm-projector-lr", type=float, default=None)
    ap.add_argument("--per-device-batch-size", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--allow-tiny-dataset", action="store_true",
                    help="permit datasets smaller than one batch by "
                         "cycling samples (smoke tests only)")
    ap.add_argument("--num-train-steps", type=int, default=1000)
    ap.add_argument("--warmup-ratio", type=float, default=0.03)
    ap.add_argument("--save-interval", type=int, default=500)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="run eval loss on --eval-data-path every N steps")
    ap.add_argument("--eval-data-path", default="")
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--output-dir", default="runs/mm")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--output-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    # sharding
    ap.add_argument("--n-expert", type=int, default=1,
                    help="expert-parallel axis size; ranks / n_expert "
                         "becomes the data axis")
    ap.add_argument("--fsdp", action="store_true", default=True,
                    help="fully shard dense params over the data axis "
                         "(one rank: the unsharded layout)")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--profile-start-step", type=int, default=-1,
                    help="take a torch.profiler trace of steps "
                         "[N, N + --profile-n-steps)")
    ap.add_argument("--profile-n-steps", type=int, default=5)
    ap.add_argument("--opt-state-8bit", action="store_true",
                    help="hold Adam mu/nu blockwise in 8 bits "
                         "(train/quant_opt.py)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each decoder layer's activations in "
                         "backward (torch.utils.checkpoint)")
    # LoRA training
    ap.add_argument("--lora-enable", action="store_true")
    ap.add_argument("--lora-r", type=int, default=128)
    ap.add_argument("--lora-alpha", type=float, default=256)
    return ap


def check_ported(a) -> None:
    """Refuse what the port does not run, with its ROADMAP item: every
    flag of JAX's CLI runs. `--moe-name` is parsed and, as in JAX, chooses
    nothing: the router is the checkpoint config.json's `moe_name`
    (ROADMAP §3)."""


class _CycleSampler:
    """Smoke runs (--allow-tiny-dataset): one batch an epoch, the dataset
    cycled to fill it."""

    def __init__(self, n: int, batch: int):
        self.n, self.batch, self.epoch = n, batch, 0

    def __iter__(self):
        idxs = list(range(self.n))
        reps = -(-self.batch // len(idxs))
        self.epoch += 1
        yield (idxs * reps)[:self.batch]


def train(a, model, dataset, tokenizer, eval_dataset=None,
          on_step: Optional[Callable] = None, final_save: bool = True):
    """The training loop over `dataset` with the loaded `model` (its
    weights are trained in place). `on_step(step, state, metrics,
    seconds)` is called after each step. Returns the final MMTrainState.
    Inside a step nothing is read from the device but the loss, once.
    Over several ranks `model` is this rank's (built on its device with
    the same weights on every rank); it is sharded here."""
    from ..parallel.distributed import detect_env, initialize
    from ..parallel.ep_context import use_expert_parallel
    from ..parallel.mesh import make_mesh, put_batch, shard_params

    check_ported(a)
    out_dir = Path(a.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = model.device
    initialize(detect_env(), device)
    # experts over 'expert', everything else data parallel; the batch is
    # global (per-device batch x ranks), each rank keeping its rows
    mesh = make_mesh(n_expert=a.n_expert)
    master = mesh.rank == 0
    if mesh.is_distributed:
        shard_params(model, mesh, fsdp=a.fsdp, ep=a.n_expert > 1)
    ep_scope = (use_expert_parallel(mesh) if a.n_expert > 1
                else contextlib.nullcontext())
    with ep_scope:
        return _train(a, model, dataset, tokenizer, eval_dataset, on_step,
                      final_save, out_dir, device, mesh, master, put_batch)


def _train(a, model, dataset, tokenizer, eval_dataset, on_step, final_save,
           out_dir, device, mesh, master, put_batch):
    from ..data.mm_data import LengthGroupedSampler, SupervisedCollator
    from ..train.checkpoint import Saver
    from ..train.lm_trainer import OptConfig, make_optimizer
    from ..train.logger import ElapsedTimeMeter, MetricLogger, NullLogger
    from ..train.lora import (apply_lora, init_lora_params, lora_scaling,
                              make_mm_lora_train_step)
    from ..train.mm_task import (MMTrainConfig, MMTrainState, batch_to,
                                 build_mm_schedules, make_mm_eval_step,
                                 make_mm_optimizer, make_mm_train_step)

    cfg = model.cfg
    if a.remat:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, remat=True))
        model.cfg = cfg
        model.language_model.cfg = cfg.decoder
    tcfg = MMTrainConfig(
        stage=a.stage, learning_rate=a.learning_rate,
        mm_projector_lr=a.mm_projector_lr, warmup_ratio=a.warmup_ratio,
        total_steps=a.num_train_steps, rate_flip=a.rate_flip,
        warm_up=a.warm_up, max_compete_in_iter=a.max_compete_in_iter,
        schedule_seed=a.seed, opt_state_8bit=a.opt_state_8bit)
    model.set_flip_schedules(*build_mm_schedules(cfg, tcfg))

    batch_size = a.per_device_batch_size * mesh.size
    if len(dataset) >= batch_size:
        sampler = LengthGroupedSampler(dataset.modality_lengths, batch_size,
                                       seed=a.seed)
    elif not a.allow_tiny_dataset:
        raise ValueError(
            f"dataset ({len(dataset)}) is smaller than one global batch "
            f"({batch_size} = {a.per_device_batch_size} x {mesh.size} "
            f"ranks): a real run would silently train on repeated "
            f"samples. Shrink --per-device-batch-size, or pass "
            f"--allow-tiny-dataset for smoke tests.")
    else:
        print(f"dataset ({len(dataset)}) < batch {batch_size}; cycling "
              "samples", flush=True)
        sampler = _CycleSampler(len(dataset), batch_size)
    img = (cfg.vision.image_size, cfg.vision.image_size, 3)
    collator = SupervisedCollator(
        pad_token_id=getattr(tokenizer, "pad_token_id", None) or 0,
        pad_to=a.model_max_length, image_shape=img)

    if a.lora_enable:
        lora = init_lora_params(
            model, a.lora_r, torch.Generator().manual_seed(a.seed))
        optimizer = make_optimizer(OptConfig(
            lr=a.learning_rate, lr_sched="constant", grad_clip=1.0,
            weight_decay=0.0))
        state = MMTrainState.create(lora, optimizer)
        step_fn = make_mm_lora_train_step(
            model, optimizer, lora_scaling(a.lora_r, a.lora_alpha),
            n_microbatch=a.grad_accum, mesh=mesh)
    else:
        optimizer = make_mm_optimizer(tcfg)
        state = MMTrainState.create(model, optimizer)
        step_fn = make_mm_train_step(model, optimizer,
                                     n_microbatch=a.grad_accum, mesh=mesh)

    saver = Saver(out_dir / "checkpoint", save_interval=a.save_interval,
                  writer=master)
    # the sampler's epoch and the batches drawn from its current pass, so
    # a resumed run continues with the batch that comes next
    pos = {"epoch": sampler.epoch, "consumed": 0}
    saver["state"] = state
    saver["sampler"] = dict(pos)
    start_step = 0
    if a.resume and saver.latest_step() is not None:
        start_step = saver.restore()
        pos = dict(saver["sampler"])
        print(f"resumed from step {start_step}", flush=True)
    sampler.epoch = pos["epoch"] - (1 if pos["consumed"] else 0)
    batches = iter(sampler)
    for _ in range(pos["consumed"]):
        next(batches)

    eval_step = None
    if a.eval_interval and eval_dataset is not None:
        eval_step = make_mm_eval_step(model, mesh=mesh)
    logger = (MetricLogger(out_dir, stdout_interval=a.log_interval)
              if master else NullLogger())
    meter = ElapsedTimeMeter()
    prof = None
    prof_start = a.profile_start_step
    prof_end = prof_start + a.profile_n_steps if prof_start >= 0 else -1

    for step in range(start_step, a.num_train_steps):
        if step == prof_start and master:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA]
                if device.type == "cuda" else []))
            prof.__enter__()
        try:
            idx = next(batches)
            pos["consumed"] += 1
        except StopIteration:
            batches = iter(sampler)
            idx = next(batches)
            pos["consumed"] = 1
        pos["epoch"] = sampler.epoch
        batch = batch_to(put_batch(collator([dataset[i] for i in idx]),
                                   mesh, a.grad_accum), device)
        t0 = time.perf_counter()
        with meter:
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss/total"])
        seconds = time.perf_counter() - t0
        if prof is not None and step == prof_end - 1:
            prof.__exit__(None, None, None)
            trace = out_dir / "trace"
            trace.mkdir(exist_ok=True)
            prof.export_chrome_trace(str(trace / f"steps_{prof_start}.json"))
            prof = None
        if step % a.log_interval == 0:
            logged = {k: float(v) for k, v in metrics.items()
                      if v.numel() == 1}
            logged["time_per_iteration"] = meter.mean_ms / 1000.0
            logger.log(step, logged)
            meter.reset()
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}")
        if on_step is not None:
            on_step(step, state, metrics, seconds)
        if (eval_step is not None and step > 0
                and step % a.eval_interval == 0):
            losses = []
            n_eval = min(a.eval_batches, len(eval_dataset) // batch_size)
            # LoRA runs evaluate with the trained adapters folded in
            with (apply_lora(model, state.params,
                             lora_scaling(a.lora_r, a.lora_alpha))
                  if a.lora_enable else contextlib.nullcontext()):
                for bi in range(n_eval):
                    ev = collator([eval_dataset[j] for j in
                                   range(bi * batch_size,
                                         (bi + 1) * batch_size)])
                    losses.append(float(eval_step(batch_to(
                        put_batch(ev, mesh), device))))
            logger.log(step, {"eval/loss": float(np.mean(losses))})
        saver["sampler"] = dict(pos)
        saver.tick(step + 1)
    if prof is not None:
        prof.__exit__(None, None, None)
    if final_save:
        saver["sampler"] = dict(pos)
        saver.save(a.num_train_steps)
    logger.close()
    return state


def main(argv=None):
    a = build_argparser().parse_args(argv)
    check_ported(a)
    if not a.model_dir:
        raise SystemExit("--model-dir pointing at an HF-format checkpoint "
                         "is required (see models/builder.py)")
    if not a.data_path or not a.tokenizer:
        raise SystemExit("--data-path and --tokenizer are required")
    from transformers import AutoTokenizer

    from ..data.mm_data import LazySupervisedDataset
    from ..device import resolve_device
    from ..models.builder import load_pretrained_model
    from ..parallel.distributed import detect_env, rank_device

    tokenizer = AutoTokenizer.from_pretrained(a.tokenizer)
    _, model, image_processor, _ = load_pretrained_model(
        a.model_dir, dtype=torch.bfloat16 if a.bf16 else torch.float32,
        device=rank_device(detect_env(), resolve_device(a.device)))

    def dataset(path):
        return LazySupervisedDataset(
            path, a.image_folder, tokenizer,
            image_processor=image_processor, version=a.version,
            image_aspect_ratio=a.image_aspect_ratio,
            model_max_length=a.model_max_length)

    eval_dataset = (dataset(a.eval_data_path)
                    if a.eval_interval and a.eval_data_path else None)
    train(a, model, dataset(a.data_path), tokenizer, eval_dataset)


if __name__ == "__main__":
    main()
