"""LM pretraining task (port of the synthetic-corpus part of
competesmoe_tpu/train/lm_task.py): the flags, the config mapping and the
train/validate loop of `SyntheticTransformerTask`.

The flip schedule is built from (`stop_after`, `warm_up`, `rate_flip`,
`max_compete_in_iter`, `seed`) exactly as in JAX, so both packages make
the same layers compete at the same steps. Weights are drawn on the
device from `-seed`. The task runs on `-device` (default cuda).

Checkpoints: a `Saver` under `<run_dir>/<name>/checkpoint` holds the
model, the optimizer state, the sampler, the args and the flip schedule;
training saves every `-save_interval` steps and at `-stop_after`. A task
resumes from the newest checkpoint there, or from `-restore` (a step, a
`model-<step>` directory or a checkpoint directory); a restored flip
schedule that differs from the rebuilt one replaces it.

Not ported here (each raises NotImplementedError naming its ROADMAP
item, or is absent): meshes, FSDP, expert and sequence parallelism
(`-n_expert_shards`, `-n_seq_shards`, `-fsdp`), the preemption job
record, the streaming corpora and the other tasks, W&B and TensorBoard
logging, the zero-shot QA battery, profiler traces.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.lm_data import SequentialMultibatchSampler, SyntheticLMDataset
from ..device import resolve_device
from ..models.lm import LMConfig, MoELanguageModel
from ..moe.config import MoEArgs
from ..moe.schedule import (build_flip_schedule, schedule_from_dict,
                            schedule_to_dict)
from ..utils.argparser import ArgumentParser, DotDict, args
from .checkpoint import Saver
from .lm_trainer import (OptConfig, TrainState, make_eval_step,
                         make_optimizer, make_train_step)
from .logger import ElapsedTimeMeter, MetricLogger, device_memory_stats

TASK_REGISTRY: Dict[str, type] = {}


def task(name: str):
    def decorate(cls):
        TASK_REGISTRY[name] = cls
        return cls
    return decorate


def get_task(name: str) -> type:
    try:
        return TASK_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown task {name!r}; registered: "
                         f"{', '.join(sorted(TASK_REGISTRY))} (the streaming "
                         "corpora are ROADMAP open item 1.1)") from None


@args
def _task_args(parser: ArgumentParser):
    parser.add_argument("-task", default="synthetic_transformer")
    parser.add_argument("-name", default="run")
    parser.add_argument("-run_dir", default="runs")
    parser.add_argument("-device", default="cuda")
    parser.add_argument("-seed", default=0)
    parser.add_argument("-restore", default="",
                        parser=parser.str_or_none_parser)
    parser.add_argument("-test_only", default=False)
    parser.add_argument("-stop_after", default=1000)
    parser.add_argument("-batch_size", default=64)
    parser.add_argument("-n_microbatch", default=1)
    parser.add_argument("-lr", default=2.5e-4)
    parser.add_argument("-lr_sched.type", default="cos",
                        choice=["cos", "constant"])
    parser.add_argument("-lr_warmup", default=0)
    parser.add_argument("-grad_clip", default=0.25)
    parser.add_argument("-wd", default=0.0)
    parser.add_argument("-opt.state_8bit", default=False)
    parser.add_argument("-amp", default=True)  # bf16 activations
    parser.add_argument("-save_interval", default=1000)
    parser.add_argument("-keep_last", default=2)
    parser.add_argument("-log_interval", default=10)
    parser.add_argument("-valid_interval", default=500)
    parser.add_argument("-valid_batches", default=10)
    parser.add_argument("-n_expert_shards", default=1)
    parser.add_argument("-n_seq_shards", default=1)
    parser.add_argument("-fsdp", default=False)
    parser.add_argument("-remat", default=False)
    parser.add_argument("-log", default="tb", choice=["tb", "wandb"])
    # lm
    parser.add_argument("-lm.unroll", default=1024)
    parser.add_argument("-lm.vocab_size", default=8000)
    parser.add_argument("-lm.eval.enabled", default=True)
    # transformer
    parser.add_argument("-state_size", default=512)
    parser.add_argument("-transformer.encoder_n_layers", default=16)
    parser.add_argument("-transformer.n_heads", default=4)
    parser.add_argument("-transformer.head_projection_size", default="none",
                        parser=parser.int_or_none_parser)
    parser.add_argument("-transformer.attn_backend", default="auto",
                        choice=["auto", "einsum", "flash"])
    parser.add_argument("-transformer.universal.group_size", default=1)
    parser.add_argument("-transformer.universal.group_type", default="abab",
                        choice=["abab", "aabb"])
    parser.add_argument("-dropout", default=0.0)
    parser.add_argument("-rope.rotate_fraction", default=0.5)
    parser.add_argument("-rope.base", default=10000.0)
    parser.add_argument("-moe.att.enable", default=False)
    # moe
    parser.add_argument("-moe_name", default="competesmoe")
    parser.add_argument("-moe.n_experts", default=64)
    parser.add_argument("-moe.expert_size", default=128)
    parser.add_argument("-pkm.n_heads", default=8)
    parser.add_argument("-moe.impl", default="auto",
                        choice=["auto", "dense", "grouped", "ep", "fused"])
    parser.add_argument("-balance_loss_coef", default=0.01)
    parser.add_argument("-balance_loss_coef_comp", default=0.01)
    parser.add_argument("-router_z_loss_coef", default=0.001)
    parser.add_argument("-router_loss_coef", default=0.01)
    parser.add_argument("-max_compete_in_iter", default=2)
    parser.add_argument("-warm_up", default=0.05)
    parser.add_argument("-rate_flip", default=0.07)
    parser.add_argument("-router_theta", default=0.1)
    parser.add_argument("-scale_weight", default=1.0)
    parser.add_argument("-hybrid", default=False)
    parser.add_argument("-tribrid", default=False)
    parser.add_argument("-in_topk", default=False)
    parser.add_argument("-balance_affinity", default=False)
    parser.add_argument("-is_cosine", default=False)
    parser.add_argument("-is_norm_weight", default=False)
    parser.add_argument("-norm_sigmoid", default=False)


def moe_args_from(a: DotDict) -> MoEArgs:
    return MoEArgs(
        balance_loss_coef=a.balance_loss_coef,
        balance_loss_coef_comp=a.balance_loss_coef_comp,
        router_z_loss_coef=a.router_z_loss_coef,
        router_loss_coef=a.router_loss_coef,
        max_compete_in_iter=a.max_compete_in_iter,
        warm_up=a.warm_up, rate_flip=a.rate_flip,
        router_theta=a.router_theta, scale_weight=a.scale_weight,
        hybrid=a.hybrid, tribrid=a.tribrid, in_topk=a.in_topk,
        balance_affinity=a.balance_affinity, is_cosine=a.is_cosine,
        is_norm_weight=a.is_norm_weight, norm_sigmoid=a.norm_sigmoid,
        schedule_seed=a.seed,
    ).validate()


def lm_config_from(a: DotDict) -> LMConfig:
    return LMConfig(
        vocab_size=a.lm.vocab_size, d_model=a.state_size,
        n_layers=a.transformer.encoder_n_layers,
        n_heads=a.transformer.n_heads,
        head_dim=a.transformer.head_projection_size,
        dropout=a.dropout, moe_name=a.moe_name,
        n_experts=a.moe.n_experts, expert_size=a.moe.expert_size,
        moe_topk=a.pkm.n_heads, moe_args=moe_args_from(a),
        moe_impl=a.moe.impl,
        rotate_fraction=a.rope.rotate_fraction, rope_base=a.rope.base,
        att_moe=a.moe.att.enable,
        attn_backend=a.transformer.attn_backend,
        universal_group_size=a.transformer.universal.group_size,
        universal_group_type=a.transformer.universal.group_type,
        remat=bool(a.remat),
        dtype=torch.bfloat16 if a.amp else torch.float32,
    )


def _not_ported(a: DotDict) -> None:
    for flag, bad, item in (
            ("n_expert_shards", a.n_expert_shards > 1, "1.7 (parallelism)"),
            ("n_seq_shards", a.n_seq_shards > 1, "1.7 (ring attention)"),
            ("fsdp", a.fsdp, "1.7 (parallelism)"),
            ("log", a.log == "wandb", "1.1 (W&B logging)")):
        if bad:
            raise NotImplementedError(f"-{flag} is not ported: ROADMAP open "
                                      f"item {item}")


@task("synthetic_transformer")
class SyntheticTransformerTask:
    """LM pretraining on the synthetic corpus (the offline stand-in for
    the reference's streaming-corpus tasks)."""

    def __init__(self, a: DotDict):
        _not_ported(a)
        self.a = a
        self.device = resolve_device(a.device)
        self.run_dir = Path(a.run_dir) / a.name
        self.logger = MetricLogger(self.run_dir,
                                   stdout_interval=a.log_interval)
        self.dataset = SyntheticLMDataset(a.lm.vocab_size, a.lm.unroll,
                                          n_windows=1 << 16, seed=a.seed)
        self.valid_dataset = SyntheticLMDataset(a.lm.vocab_size, a.lm.unroll,
                                                n_windows=1 << 10,
                                                seed=a.seed + 1)
        self.sampler = SequentialMultibatchSampler(
            n_items=len(self.dataset), batch_size=a.batch_size)
        self.cfg = lm_config_from(a)
        self.schedule = None
        if self.cfg.moe_name == "competesmoe" and not a.test_only:
            self.schedule = build_flip_schedule(
                self.cfg.n_layers, a.stop_after, a.warm_up, a.rate_flip,
                a.max_compete_in_iter, seed=a.seed)
        self.model = MoELanguageModel(self.cfg, flip_schedule=self.schedule,
                                      device=self.device).init_weights(a.seed)
        self.optimizer = make_optimizer(OptConfig(
            lr=a.lr, lr_sched=a.lr_sched.type, warmup_steps=a.lr_warmup,
            total_steps=a.stop_after, grad_clip=a.grad_clip,
            weight_decay=a.wd, state_8bit=a.opt.state_8bit))
        self.state = TrainState.create(self.model, self.optimizer)
        self.train_step = make_train_step(self.model, self.optimizer,
                                          n_microbatch=a.n_microbatch)
        self.eval_step = make_eval_step(self.model)

        self.saver = Saver(self.run_dir / "checkpoint",
                           save_interval=a.save_interval,
                           keep_last=a.keep_last)
        self.saver["model"] = self.model
        self.saver["optimizer"] = self.state.opt_state
        self.saver["sampler"] = self.sampler
        self.saver["args"] = ArgumentParser.namespace_to_dict(a)
        if self.schedule is not None:
            self.saver["flip_schedule"] = schedule_to_dict(self.schedule)
        if a.restore:
            self.restore(a.restore)
        elif self.saver.latest_step() is not None:
            self.restore()

    # -- checkpoint --

    def restore(self, path_or_step=None) -> int:
        """Accepts a step number, a `model-<step>` checkpoint path, or a
        checkpoint directory (the reference's `--restore <ckpt_path>`)."""
        step = None
        if isinstance(path_or_step, str) and path_or_step:
            p = Path(path_or_step)
            if p.exists():
                if p.name.startswith("model-"):
                    # point the saver at the foreign checkpoint dir
                    self.saver.dir = p.parent
                    step = int(p.name.split("-", 1)[1])
                else:
                    self.saver.dir = p
            else:
                step = int(path_or_step)
        restored = self.saver.restore(step)
        self.state.step = restored
        # The competition schedule is part of the training state: a
        # resumed run keeps the ORIGINAL schedule even if stop_after
        # changed (the reference keeps prob_flips as a buffer).
        if self.schedule is not None and "flip_schedule" in self.saver:
            saved = schedule_from_dict(self.saver["flip_schedule"])
            if not np.array_equal(saved.flips, self.schedule.flips):
                print("restoring original flip schedule from checkpoint")
                self.schedule = saved
                self.model.set_flip_schedule(saved)
                self.saver["flip_schedule"] = schedule_to_dict(saved)
        print(f"restored checkpoint at step {restored}")
        return restored

    def fetch_batch(self) -> torch.Tensor:
        batch = self.dataset.batch(next(self.sampler))
        return torch.from_numpy(batch.astype(np.int64)).to(
            self.device, non_blocking=True)

    def validate(self) -> float:
        total_nll, total_tok = 0.0, 0
        sampler = SequentialMultibatchSampler(
            n_items=len(self.valid_dataset), batch_size=self.a.batch_size)
        for _ in range(self.a.valid_batches):
            batch = torch.from_numpy(self.valid_dataset.batch(
                next(sampler)).astype(np.int64)).to(self.device)
            nll, n = self.eval_step(batch)
            total_nll += float(nll)
            total_tok += int(n)
        return math.exp(total_nll / max(total_tok, 1))

    def train(self, n_steps: Optional[int] = None) -> None:
        """Train from the current step to `stop_after`, or for `n_steps`
        steps. The step number selects the flips and the learning rate.
        Saves every `save_interval` steps, and at `stop_after`."""
        a = self.a
        start = self.state.step
        end = a.stop_after if n_steps is None else min(a.stop_after,
                                                       start + n_steps)
        iter_meter = ElapsedTimeMeter()
        prev = None                    # one-step-lagged NaN guard
        wall_t0, wall_steps = time.perf_counter(), 0
        for step in range(start, end):
            batch = self.fetch_batch()
            with iter_meter:
                self.state, metrics = self.train_step(self.state, batch)
            if prev is not None:
                _check_finite(*prev)
            prev = (step, metrics)
            wall_steps += 1
            if step % a.log_interval == 0 or step == end - 1:
                logm = {k: float(v) for k, v in metrics.items()}
                prev = None
                _check_finite(step, logm)
                tokens = a.batch_size * a.lm.unroll
                wall_ms = 1e3 * (time.perf_counter() - wall_t0) / wall_steps
                logm.update({
                    "timing/ms_per_step_wall": wall_ms,
                    "timing/ms_per_iter": iter_meter.mean_ms,
                    "timing/ms_per_token": wall_ms / tokens,
                    "step_tokens_per_second": tokens / (wall_ms / 1000.0),
                })
                logm.update(device_memory_stats())
                self.logger.log(step, logm)
                iter_meter.reset()
                wall_t0, wall_steps = time.perf_counter(), 0
            if a.valid_interval and step and step % a.valid_interval == 0:
                self.logger.log(step, {"valid/perplexity": self.validate()},
                                to_stdout=True)
                wall_t0, wall_steps = time.perf_counter(), 0
            self.saver.tick(step + 1)
        if prev is not None:
            _check_finite(*prev)
        if end == a.stop_after:
            self.saver.save(a.stop_after)

    def test(self) -> Dict[str, float]:
        return {"valid/perplexity": self.validate()}


def _check_finite(step: int, metrics) -> None:
    loss = float(metrics["loss/total"])
    if not math.isfinite(loss):
        raise FloatingPointError(
            f"non-finite loss at step {step}: "
            f"{ {k: float(v) for k, v in metrics.items()} }")
