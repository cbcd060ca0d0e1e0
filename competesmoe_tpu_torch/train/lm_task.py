"""LM pretraining task (port of competesmoe_tpu/train/lm_task.py): the
flags, the config mapping, the eight tasks and their train / validate /
test loop.

Tasks: `synthetic_transformer` (the arithmetic corpus), `mixture_
transformer` (the latent-mode Markov corpus), `chunked_transformer`
(uint16 chunk directories under `-lm.data_dir`), and the streaming
corpora `c4_`, `slimpajama_`, `pes2o_` and `thestack_transformer`
(`data/streaming.py`: shards by URL, or the local files of `-lm.shards`,
a vocab trained on the first `-lm.tokenizer_n_files` shards, chunks of
uint16 tokens under `-lm.cache_dir`).

The flip schedule is built from (`stop_after`, `warm_up`, `rate_flip`,
`max_compete_in_iter`, `seed`) exactly as in JAX, so both packages make
the same layers compete at the same steps. Weights are drawn on the
device from `-seed`, and so are the model's random draws (MoA's
dropouts). The task runs on `-device` (default cuda).

Training: a background thread walks its own copy of the sampler and
assembles the next batches (`timing/ms_per_load` is the wait for one);
the checkpointed sampler is re-pinned to the consumed step before every
saver tick, so a resume replays nothing and skips nothing. Validation
logs the perplexity and, from its last batch, each layer's expert-usage
histogram, entropy and share of used experts, and a heatmap
(`train/plots.py`). `-profile.start_step` / `-profile.n_steps` write a
torch.profiler trace of those steps under `<run_dir>/<name>/trace`.
`-log tb` mirrors the metrics to TensorBoard, `-log wandb` to W&B where
the package is installed, `-log_async 1` writes them from a thread.
`test()` adds the zero-shot QA battery (`-lm.eval.*`,
`eval/lm_zeroshot.py`, `data/qa_datasets.py`) to the perplexity.

Checkpoints: a `Saver` under `<run_dir>/<name>/checkpoint` holds the
model, the optimizer state, the sampler, the args and the flip schedule;
training saves every `-save_interval` steps and at `-stop_after`. A task
resumes from the newest checkpoint there, or from `-restore` (a step, a
`model-<step>` directory or a checkpoint directory); a restored flip
schedule that differs from the rebuilt one replaces it.

Several ranks (`python -m torch.distributed.run --nproc-per-node N -m
competesmoe_tpu_torch.cli.main ...`, or a SLURM job): `parallel.
distributed.initialize` makes the process group from the scheduler's
environment (NCCL when each rank has a card, gloo when ranks share one or
run on the CPU), and the ranks form JAX's ('data', 'expert') grid with
`-n_expert_shards` ranks on the expert axis. Every rank builds the same
weights and the same global batch from `-seed`; it keeps its rows
(`parallel.mesh.put_batch`) in training, validation and the perplexity of
`test()` (the QA battery runs whole on every rank). `-n_expert_shards > 1`
with `-moe.impl auto|ep` shards the expert banks and dispatches the
tokens by all-to-all (`parallel/expert_parallel.py`); with `fused`,
`grouped` or `dense` the banks are sharded and gathered where they are
read, as are the dense parameters under `-fsdp` (over 'data', those of at
least `-fsdp.min_size` elements). Metrics are reduced over the ranks and
only rank 0 logs and writes; the Saver's checkpoint is the gathered full
state, so it restores at any world size. A preemptible job
(`SLURM_RESTART_COUNT`) records its checkpoint directory under
`-job_record_dir`, and a restart resumes from the recorded one.
`-n_seq_shards N > 1` adds a 'seq' axis of N ranks (JAX's ('data',
'expert', 'seq') mesh): the ranks of a row block split its sequence, and
attention runs as a ring over them (`parallel/ring_attention.py`);
`-lm.unroll` must divide by N.
"""

from __future__ import annotations

import copy
import math
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.lm_data import (SequentialMultibatchSampler, SyntheticLMDataset,
                            open_chunk_dir)
from ..device import resolve_device
from ..models.lm import LMConfig, MoELanguageModel
from ..moe.config import MoEArgs
from ..moe.schedule import (build_flip_schedule, schedule_from_dict,
                            schedule_to_dict)
from ..utils.argparser import ArgumentParser, DotDict, args
from ..parallel.mesh import make_mesh, put_batch, seq_block, shard_params
from .checkpoint import FullState, Saver
from .lm_trainer import (OptConfig, TrainState, make_eval_step,
                         make_optimizer, make_train_step)
from .logger import (AsyncMetricLogger, ElapsedTimeMeter, MetricLogger,
                     NullLogger, device_memory_stats)

TASK_REGISTRY: Dict[str, type] = {}
QA_TASKS = ("lambada", "blimp", "cbt", "hellaswag", "piqa", "ai2arc",
            "openbookqa", "race", "siqa", "winogrande", "commonsenseqa")


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
                         f"{', '.join(sorted(TASK_REGISTRY))}") from None


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
    parser.add_argument("-fsdp.min_size", default=65536)
    # preemption auto-resume (training_helper.py:159-182 job records)
    parser.add_argument("-job_record_dir", default="jobs")
    parser.add_argument("-remat", default=False)
    # anomaly detection in the backward (JAX: jax_debug_nans)
    parser.add_argument("-nan_detect", default=False)
    # a torch.profiler trace of steps [start, start + n)
    parser.add_argument("-profile.start_step", default=-1)
    parser.add_argument("-profile.n_steps", default=5)
    parser.add_argument("-log", default="tb", choice=["tb", "wandb"])
    parser.add_argument("-wandb.project", default="competesmoe_tpu")
    parser.add_argument("-log_async", default=False)
    # lm
    parser.add_argument("-lm.unroll", default=1024)
    parser.add_argument("-lm.vocab_size", default=8000)
    parser.add_argument("-lm.data_dir", default="")
    # streaming corpora (c4/slimpajama/pes2o/thestack tasks)
    parser.add_argument("-lm.cache_dir", default="./cache")
    parser.add_argument("-lm.n_shards", default=1)
    parser.add_argument("-lm.valid_n_shards", default=1)
    parser.add_argument("-lm.token_limit", default="none",
                        parser=parser.int_or_none_parser)
    # comma / glob list of LOCAL shard files; overrides the remote spec
    parser.add_argument("-lm.shards", default="")
    parser.add_argument("-lm.tokenizer_algo", default="unigram",
                        choice=["unigram", "bpe"])
    parser.add_argument("-lm.tokenizer_n_files", default="none",
                        parser=parser.int_or_none_parser)
    parser.add_argument("-lm.thestack_languages", default="python")
    # mixture_transformer (the latent-mode Markov corpus)
    parser.add_argument("-lm.mixture.n_modes", default=16)
    parser.add_argument("-lm.mixture.coherence", default=0.85)
    parser.add_argument("-lm.mixture.zipf_alpha", default=1.2)
    # the zero-shot QA battery of test()
    parser.add_argument("-lm.eval.enabled", default=True)
    parser.add_argument("-lm.eval.pad_quantum", default=128)
    for qa in QA_TASKS:
        parser.add_argument(f"-lm.eval.{qa}.enabled", default=False)
        parser.add_argument(f"-lm.eval.{qa}.path", default="")
    parser.add_argument("-lm.eval.piqa.labels_path", default="")
    parser.add_argument("-lm.eval.siqa.labels_path", default="")
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
    # MoA attention
    parser.add_argument("-moe.att.enable", default=False)
    parser.add_argument("-moe.att.n_experts", default=4)
    parser.add_argument("-moe.att.k", default=2)
    parser.add_argument("-moe.att.q_expert", default=True)
    parser.add_argument("-moe.att.k_expert", default=True)
    parser.add_argument("-moe.att.v_expert", default=True)
    parser.add_argument("-moe.att.o_expert", default=True)
    parser.add_argument("-moe.att.v_size", default="none",
                        parser=parser.int_or_none_parser)
    parser.add_argument("-moe.att.drop_expert", default=0.0)
    parser.add_argument("-moe.att.selection_dropout", default=0.0)
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
        att_moe=a.moe.att.enable, att_n_experts=a.moe.att.n_experts,
        att_k=a.moe.att.k, att_q_expert=a.moe.att.q_expert,
        att_k_expert=a.moe.att.k_expert, att_v_expert=a.moe.att.v_expert,
        att_o_expert=a.moe.att.o_expert, att_v_size=a.moe.att.v_size,
        att_expert_dropout=a.moe.att.drop_expert,
        att_selection_dropout=a.moe.att.selection_dropout,
        attn_backend=a.transformer.attn_backend,
        universal_group_size=a.transformer.universal.group_size,
        universal_group_type=a.transformer.universal.group_type,
        remat=bool(a.remat),
        dtype=torch.bfloat16 if a.amp else torch.float32,
    )


@task("synthetic_transformer")
class SyntheticTransformerTask:
    """LM pretraining on the synthetic corpus (the offline stand-in for
    the reference's streaming-corpus tasks); the other tasks change only
    `create_datasets`."""

    def __init__(self, a: DotDict):
        self.a = a
        from ..parallel.distributed import (detect_env, initialize,
                                            rank_device)
        self.denv = detect_env()
        device = resolve_device(a.device)
        initialize(self.denv, device)
        self.device = rank_device(self.denv, device)
        self.mesh = make_mesh(n_expert=a.n_expert_shards,
                              n_seq=a.n_seq_shards)
        if a.n_seq_shards > 1 and a.lm.unroll % a.n_seq_shards != 0:
            raise ValueError(
                f"-lm.unroll {a.lm.unroll} must divide by "
                f"-n_seq_shards {a.n_seq_shards} (ring attention blocks)")
        if a.batch_size % self.mesh.size != 0:
            raise ValueError(
                f"-batch_size {a.batch_size} must be divisible by the "
                f"number of devices ({self.mesh.size}); the global batch "
                f"is sharded over the full mesh")
        if a.moe.impl == "ep" and a.n_expert_shards <= 1:
            raise ValueError("-moe.impl ep requires -n_expert_shards > 1")
        # route the MoE dispatch through the all-to-all path; scoped to
        # this task's loops (`_ep_scope`)
        self._use_ep = (a.n_expert_shards > 1
                        and a.moe.impl in ("auto", "ep"))
        self.is_master = self.mesh.rank == 0
        self.run_dir = Path(a.run_dir) / a.name
        logger_cls = AsyncMetricLogger if a.log_async else MetricLogger
        self.logger = (logger_cls(self.run_dir, use_wandb=a.log == "wandb",
                                  wandb_project=a.wandb.project,
                                  run_name=a.name,
                                  stdout_interval=a.log_interval)
                       if self.is_master else NullLogger())
        self.dataset, self.valid_dataset = self.create_datasets()
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
        if self.mesh.is_distributed:
            shard_params(self.model, self.mesh, fsdp=a.fsdp,
                         fsdp_min_size=a.fsdp.min_size, ep=self._use_ep)
        self.generator = None
        if self.model.draws:
            self.generator = torch.Generator(
                device=self.device).manual_seed(a.seed)
        self.optimizer = make_optimizer(OptConfig(
            lr=a.lr, lr_sched=a.lr_sched.type, warmup_steps=a.lr_warmup,
            total_steps=a.stop_after, grad_clip=a.grad_clip,
            weight_decay=a.wd, state_8bit=a.opt.state_8bit))
        self.state = TrainState.create(self.model, self.optimizer)
        self.train_step = make_train_step(self.model, self.optimizer,
                                          n_microbatch=a.n_microbatch,
                                          generator=self.generator,
                                          mesh=self.mesh)
        self.eval_step = make_eval_step(self.model, mesh=self.mesh)
        self.expert_usage: Dict[str, np.ndarray] = {}

        # preemption auto-resume (training_helper.py:159-182): a restarted
        # scheduler job reads its job record to find the checkpoint
        # directory of the interrupted run, even when the run name changed
        from ..parallel.distributed import is_restart, run_identifier
        ckpt_dir = self.run_dir / "checkpoint"
        record = Path(a.job_record_dir) / run_identifier(self.denv)
        if is_restart(self.denv) and record.exists():
            recorded = Path(record.read_text().strip())
            if recorded.exists():
                print(f"restart detected; resuming from job record "
                      f"{recorded}")
                ckpt_dir = recorded
        self.saver = Saver(ckpt_dir, save_interval=a.save_interval,
                           keep_last=a.keep_last, writer=self.is_master)
        self.saver["model"] = FullState(self.model)
        self.saver["optimizer"] = FullState(self.state.opt_state,
                                            self.model)
        self.saver["sampler"] = self.sampler
        self.saver["args"] = ArgumentParser.namespace_to_dict(a)
        if self.schedule is not None:
            self.saver["flip_schedule"] = schedule_to_dict(self.schedule)
        if a.restore:
            self.restore(a.restore)
        elif self.saver.latest_step() is not None:
            self.restore()
        if self.denv.is_preemptible and self.denv.is_master:
            record.parent.mkdir(parents=True, exist_ok=True)
            record.write_text(str(ckpt_dir))

    def _ep_scope(self, seq: bool = True):
        """The parallel-dispatch context of this task's loops: expert
        parallelism (all-to-all MoE dispatch) and/or sequence parallelism
        (ring attention over the 'seq' axis; `seq=False` for the QA
        battery, whose sequences every rank runs whole)."""
        import contextlib
        stack = contextlib.ExitStack()
        if self._use_ep:
            from ..parallel.ep_context import use_expert_parallel
            stack.enter_context(use_expert_parallel(self.mesh))
        if seq and "seq" in self.mesh.axis_names:
            from ..parallel.seq_context import use_sequence_parallel
            stack.enter_context(use_sequence_parallel(self.mesh))
        return stack

    def _rows(self, windows: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch."""
        return put_batch(windows, self.mesh, self.a.n_microbatch)

    # -- data --

    def create_datasets(self):
        a = self.a
        train = SyntheticLMDataset(a.lm.vocab_size, a.lm.unroll,
                                   n_windows=1 << 16, seed=a.seed)
        valid = SyntheticLMDataset(a.lm.vocab_size, a.lm.unroll,
                                   n_windows=1 << 10, seed=a.seed + 1)
        return train, valid

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

    # -- loops --

    def _device_batch(self, windows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(windows.astype(np.int64)).to(
            self.device, non_blocking=True)

    def fetch_batch(self) -> torch.Tensor:
        return self._device_batch(self._rows(
            self.dataset.batch(next(self.sampler))))

    @torch.no_grad()
    def validate(self) -> float:
        with self._ep_scope():
            return self._validate()

    def _validate(self) -> float:
        total_nll, total_tok = 0.0, 0
        sampler = SequentialMultibatchSampler(
            n_items=len(self.valid_dataset), batch_size=self.a.batch_size)
        batch = None
        for _ in range(self.a.valid_batches):
            batch = torch.from_numpy(put_batch(self.valid_dataset.batch(
                next(sampler)), self.mesh).astype(np.int64)).to(self.device)
            nll, n = self.eval_step(batch)
            total_nll += float(nll)
            total_tok += int(n)
        if batch is not None:
            self._log_expert_usage(batch)
        return math.exp(total_nll / max(total_tok, 1))

    def _log_expert_usage(self, batch: torch.Tensor) -> None:
        """Eval-time routing telemetry of `batch`: per layer, the expert
        histogram of the router's selections (kept in `expert_usage`),
        the share of experts used and the entropy of the usage, and a
        heatmap of every layer's usage."""
        try:
            _, aux = self.model(seq_block(batch[:, :-1], self.mesh),
                                train=False,
                                return_id_experts=True)
        except Exception as e:  # noqa: BLE001 - telemetry must not end a run
            # warn once instead of dropping telemetry silently
            if not getattr(self, "_telemetry_warned", False):
                self._telemetry_warned = True
                print(f"expert-usage telemetry failed "
                      f"({type(e).__name__}: {e}); disabled for this run",
                      flush=True)
            return
        metrics = {}
        usage_rows = {}
        self.expert_usage = {}
        from ..parallel.collectives import raw_all_reduce
        world = self.mesh.axis("world")
        for key, val in aux.items():
            if key.endswith("/selected_experts") and val is not None:
                layer = key.split("/")[0]
                counts = torch.zeros(self.cfg.n_experts, dtype=torch.long,
                                     device=val.device)
                counts.index_add_(0, val.reshape(-1).long(),
                                  torch.ones_like(val.reshape(-1).long()))
                # the histogram of the global batch's rows
                hist = raw_all_reduce(counts, world).cpu().numpy()
                self.expert_usage[layer] = hist
                frac = hist / max(hist.sum(), 1)
                usage_rows[layer] = frac
                metrics[f"expert_usage/{layer}_nonzero_frac"] = float(
                    (hist > 0).mean())
                p = np.clip(frac, 1e-12, None)
                metrics[f"expert_usage/{layer}_entropy"] = float(
                    -(p * np.log(p)).sum())
        if metrics:
            self.logger.log(int(self.state.step), metrics, to_stdout=False)
        if usage_rows and self.is_master:
            from .plots import Heatmap, log_plots
            order = sorted(usage_rows,
                           key=lambda k: int(k.replace("layer", "") or 0))
            mat = np.stack([usage_rows[k] for k in order])
            log_plots(self.logger, int(self.state.step), {
                "expert_usage/heatmap": Heatmap(
                    map=mat, xlabel="expert", ylabel="layer",
                    y_marks=order)})

    def train(self, n_steps: Optional[int] = None) -> None:
        """Train from the current step to `stop_after`, or for `n_steps`
        steps. The step number selects the flips and the learning rate.
        Saves every `save_interval` steps, and at `stop_after`."""
        a = self.a
        start = self.state.step
        end = a.stop_after if n_steps is None else min(a.stop_after,
                                                       start + n_steps)
        iter_meter = ElapsedTimeMeter()
        load_meter = ElapsedTimeMeter()   # wait for the next batch
        # rank 0 alone takes the trace
        prof_start = a.profile.start_step if self.is_master else -1
        prof_end = prof_start + a.profile.n_steps if prof_start >= 0 else -1
        prof = None

        # the producer walks its own sampler copy; the checkpointed
        # sampler is re-pinned to the consumed step before each save. It
        # assembles numpy windows only: every torch and CUDA call stays on
        # this thread (a profiled replay later in a process whose other
        # thread had made CUDA calls lost a kernel record on the card)
        q: queue.Queue = queue.Queue(maxsize=2)
        stop_evt = threading.Event()
        prod_sampler = copy.copy(self.sampler)

        def produce():
            try:
                for _ in range(start, end):
                    item = self._rows(self.dataset.batch(
                        next(prod_sampler)))
                    while not stop_evt.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop_evt.is_set():
                        return
            except Exception as e:  # noqa: BLE001 - raised by the consumer
                q.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        prev = None                    # one-step-lagged NaN guard
        wall_t0, wall_steps = time.perf_counter(), 0
        try:
            for step in range(start, end):
                if step == prof_start:
                    prof = _start_profiler(self.device)
                if step == prof_end and prof is not None:
                    self._stop_profiler(prof)
                    prof = None
                    # the trace's export is not a step's time
                    wall_t0, wall_steps = time.perf_counter(), 0
                with load_meter:
                    batch = q.get()
                    if isinstance(batch, Exception):
                        raise batch
                    batch = self._device_batch(batch)
                with iter_meter, self._ep_scope():
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
                    wall_ms = 1e3 * (time.perf_counter() - wall_t0) \
                        / wall_steps
                    logm.update({
                        "timing/ms_per_step_wall": wall_ms,
                        "timing/ms_per_iter": iter_meter.mean_ms,
                        "timing/ms_per_load": load_meter.mean_ms,
                        "timing/ms_per_token": wall_ms / tokens,
                        "step_tokens_per_second": tokens / (wall_ms / 1000.0),
                    })
                    logm.update(device_memory_stats())
                    self.logger.log(step, logm)
                    iter_meter.reset()
                    load_meter.reset()
                    wall_t0, wall_steps = time.perf_counter(), 0
                if a.valid_interval and step and step % a.valid_interval == 0:
                    self.logger.log(step, {"valid/perplexity":
                                           self.validate()}, to_stdout=True)
                    wall_t0, wall_steps = time.perf_counter(), 0
                # the producer's copy runs ahead by the queue's depth
                self.sampler.pos = step + 1
                self.saver.tick(step + 1)
            if prev is not None:
                _check_finite(*prev)
            if end == a.stop_after:
                self.saver.save(a.stop_after)
        finally:
            if prof is not None:
                self._stop_profiler(prof)
            stop_evt.set()
            producer.join(timeout=30)

    def _stop_profiler(self, prof) -> Path:
        prof.stop()
        out = self.run_dir / "trace"
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
        self.trace_path = path
        print(f"profiler trace written to {path}", flush=True)
        return path

    def test(self) -> Dict[str, float]:
        res = {"valid/perplexity": self.validate()}
        with self._ep_scope(seq=False):
            res.update(self.run_downstream_evals())
        return res

    # -- the zero-shot QA battery --

    def _qa_encode(self):
        """Tokenizer for QA prompts: the streaming corpus vocab when the
        task has one, else a stable hash of each word (synthetic and
        chunked runs)."""
        tok = getattr(self.dataset, "tokenizer", None)
        if tok is not None:
            return lambda s: tok.encode(s).ids
        import zlib
        v = self.a.lm.vocab_size

        def hash_encode(s: str):
            return [(zlib.crc32(w.encode()) % (v - 1)) + 1
                    for w in s.split()]
        return hash_encode

    def run_downstream_evals(self) -> Dict[str, float]:
        a = self.a
        if not a.lm.eval.enabled:
            return {}
        from ..data import qa_datasets as qa
        from ..eval.lm_zeroshot import LMZeroShotEvaluator, lambada_accuracy

        encode = self._qa_encode()
        ev = LMZeroShotEvaluator(self.model,
                                 pad_quantum=a.lm.eval.pad_quantum,
                                 max_len=a.lm.unroll)
        res: Dict[str, float] = {}
        if a.lm.eval.lambada.enabled:
            items = qa.lambada_items(
                qa.ensure_file(a.lm.eval.lambada.path, "lambada",
                               a.lm.cache_dir), encode)
            for k, v in lambada_accuracy(ev, items).items():
                res[f"lambada/{k}"] = v
        simple = {
            "hellaswag": lambda: qa.hellaswag_docs(
                qa.ensure_file(a.lm.eval.hellaswag.path, "hellaswag",
                               a.lm.cache_dir), encode),
            "piqa": lambda: qa.piqa_docs(
                qa.ensure_file(a.lm.eval.piqa.path, "piqa", a.lm.cache_dir),
                qa.ensure_file(a.lm.eval.piqa.labels_path, "piqa_labels",
                               a.lm.cache_dir), encode),
            "ai2arc": lambda: qa.arc_docs(a.lm.eval.ai2arc.path, encode),
            "openbookqa": lambda: qa.openbookqa_docs(
                a.lm.eval.openbookqa.path, encode),
            "commonsenseqa": lambda: qa.commonsenseqa_docs(
                a.lm.eval.commonsenseqa.path, encode),
            "winogrande": lambda: qa.winogrande_docs(
                a.lm.eval.winogrande.path, encode),
            "siqa": lambda: qa.siqa_docs(
                a.lm.eval.siqa.path, a.lm.eval.siqa.labels_path, encode),
            "race": lambda: qa.race_docs(a.lm.eval.race.path, encode),
            "cbt": lambda: qa.cbt_docs(a.lm.eval.cbt.path, encode),
            "blimp": lambda: qa.blimp_docs(a.lm.eval.blimp.path, encode),
        }
        for name, load in simple.items():
            if not getattr(a.lm.eval, name).enabled:
                continue
            for k, v in ev.evaluate(load()).items():
                res[f"{name}/{k}"] = v
        return res


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _check_finite(step: int, metrics) -> None:
    loss = float(metrics["loss/total"])
    if not math.isfinite(loss):
        raise FloatingPointError(
            f"non-finite loss at step {step}: "
            f"{ {k: float(v) for k, v in metrics.items()} }")


class _StreamingTransformerTask(SyntheticTransformerTask):
    """LM pretraining over a streaming shard corpus (the reference's
    {c4,slimpajama,pes2o,thestack}_transformer tasks): shards are fetched
    or read locally (`-lm.shards`), a Unigram vocab is trained on the
    first shards, and tokens are written to uint16 mmap chunks."""

    SPEC_NAME = None  # streaming spec class name, set by subclasses

    def _make_spec(self):
        from ..data import streaming
        a = self.a
        if a.lm.shards:
            import glob
            shards: list = []
            for part in a.lm.shards.split(","):
                hits = sorted(glob.glob(part))
                shards.extend(hits if hits else [part])
            return streaming.LocalShardSpec(shards=shards)
        return getattr(streaming, self.SPEC_NAME)(**self._spec_kwargs())

    def _spec_kwargs(self):
        return {}

    def create_datasets(self):
        from ..data.streaming import ChunkedLMCorpus, LocalShardSpec
        a = self.a
        spec = self._make_spec()
        cache = Path(a.lm.cache_dir) / type(self).__name__
        kw = dict(vocab_size=a.lm.vocab_size, token_limit=a.lm.token_limit,
                  algo=a.lm.tokenizer_algo,
                  tokenizer_n_files=a.lm.tokenizer_n_files)
        train = ChunkedLMCorpus(spec, a.lm.unroll, cache, split="train",
                                n_shards=a.lm.n_shards, **kw)
        if isinstance(spec, LocalShardSpec):
            valid = train  # local shards carry no validation split
        else:
            valid = ChunkedLMCorpus(spec, a.lm.unroll, cache,
                                    split="validation",
                                    n_shards=a.lm.valid_n_shards, **kw)
        return train, valid


@task("c4_transformer")
class C4TransformerTask(_StreamingTransformerTask):
    SPEC_NAME = "C4Spec"


@task("slimpajama_transformer")
class SlimPajamaTransformerTask(_StreamingTransformerTask):
    SPEC_NAME = "SlimPajamaSpec"


@task("pes2o_transformer")
class PES2OTransformerTask(_StreamingTransformerTask):
    SPEC_NAME = "PES2OSpec"


@task("thestack_transformer")
class TheStackTransformerTask(_StreamingTransformerTask):
    SPEC_NAME = "TheStackSpec"

    def _spec_kwargs(self):
        return {"languages": self.a.lm.thestack_languages}


@task("mixture_transformer")
class MixtureTransformerTask(SyntheticTransformerTask):
    """LM pretraining on the latent-mode Markov mixture corpus
    (`data.lm_data.SyntheticMixtureLMDataset`), where expert
    specialisation per mode is what lowers the loss."""

    def create_datasets(self):
        from ..data.lm_data import SyntheticMixtureLMDataset
        a = self.a
        kw = dict(n_modes=a.lm.mixture.n_modes,
                  coherence=a.lm.mixture.coherence,
                  zipf_alpha=a.lm.mixture.zipf_alpha)
        train = SyntheticMixtureLMDataset(
            a.lm.vocab_size, a.lm.unroll, n_windows=1 << 20, seed=a.seed,
            **kw)
        # the same language (modes and permutations), held-out windows
        valid = SyntheticMixtureLMDataset(
            a.lm.vocab_size, a.lm.unroll, n_windows=1 << 10,
            seed=a.seed + 7919, **kw)
        valid.perms = train.perms
        return train, valid


@task("chunked_transformer")
class ChunkedTransformerTask(SyntheticTransformerTask):
    """LM pretraining over pre-tokenized uint16 mmap chunk directories
    (`-lm.data_dir` with `train/` and optionally `valid/`, each written by
    `data.lm_data.tokenize_to_chunks`)."""

    def create_datasets(self):
        a = self.a
        if not a.lm.data_dir:
            raise ValueError("chunked_transformer requires -lm.data_dir")
        d = Path(a.lm.data_dir)
        train = open_chunk_dir(d / "train", a.lm.unroll)
        valid_dir = d / "valid"
        valid = (open_chunk_dir(valid_dir, a.lm.unroll)
                 if valid_dir.exists() else train)
        return train, valid
