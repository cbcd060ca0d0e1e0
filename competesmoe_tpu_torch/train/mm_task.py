"""Multimodal (LLaVA-style) training: the 3-stage CompeteSMoE recipe (port
of competesmoe_tpu/train/mm_task.py).

- stage "pretrain": only the mm projector trains (lr 1e-3 unless
  mm_projector_lr is given); the tower's and the decoder's gradients are
  still computed (they count in `grad_norm`) but not applied;
- stage "pft": the whole model trains;
- stage "sft": the whole model trains, the projector at mm_projector_lr
  when given, with the competition schedules installed.

The optimizer is JAX's `optax.multi_transform` written out: each of the
groups `projector`, `vision` and `decoder` has its own chain,
clip_by_global_norm(grad_clip) -> adamw (float or 8-bit moments) -> the
group's LR schedule (linear warm-up into cosine), so each group is clipped
by its own norm. The schedules chain the tower's layers first, then the
projector (`build_mm_schedules`).

`make_mm_train_step` runs `n_microbatch` forward/backward passes over
slices of the batch, all at the same step (so with the same flips). With
more than one, the gradients are summed in float32 buffers and scaled by
1/n; with one they stay in the parameters' dtype. Parameters and moments
are updated in place. The step reads nothing back from the device:
metrics are device tensors.

Over several ranks (`mesh`), each rank holds its rows of each microbatch
and its shards of the parameters; its objective is its share of the
global loss (its label tokens' cross-entropy over the global count, 1/world
of its aux losses), gradients are summed over the ranks that hold a copy
(`parallel.mesh.reduce_gradients`), and the metrics are the global ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..moe.schedule import FlipSchedule, build_flip_schedule
from ..parallel import collectives as C
from ..parallel import distributed_ops
from ..parallel.mesh import named_params, reduce_gradients, shard_axes
from .lm_trainer import (AdamState, OptConfig, apply_adam_, global_norm,
                         make_lr_schedule)

@dataclasses.dataclass(frozen=True)
class MMTrainConfig:
    stage: str = "sft"               # pretrain | pft | sft
    learning_rate: float = 4e-6
    mm_projector_lr: Optional[float] = None
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    lr_sched: str = "cos"
    # Adam's moments blockwise in 8 bits (train/quant_opt.py)
    opt_state_8bit: bool = False
    # CompeteSMoE schedule
    rate_flip: float = 0.05
    warm_up: float = 0.0
    max_compete_in_iter: int = 2
    schedule_seed: int = 0


def build_mm_schedules(cfg, tcfg: MMTrainConfig
                       ) -> Tuple[Optional[FlipSchedule],
                                  Optional[FlipSchedule]]:
    """Chained schedules: the tower's layers 0..V-1, then the projector as
    layer V (None where the part does not compete)."""
    needs = []
    if cfg.vision.moe_name == "competesmoe":
        needs.append("vision")
    if (cfg.projector.projector_type == "moe"
            and cfg.projector.moe_name == "competesmoe"):
        needs.append("projector")
    if not needs:
        return None, None
    n_vision = cfg.vision.num_hidden_layers if "vision" in needs else 0
    n_total = n_vision + (1 if "projector" in needs else 0)
    full = build_flip_schedule(
        n_total, tcfg.total_steps, tcfg.warm_up, tcfg.rate_flip,
        tcfg.max_compete_in_iter, seed=tcfg.schedule_seed)
    vis = proj = None
    if "vision" in needs:
        vis = FlipSchedule(step_warm=full.step_warm,
                           flip_steps=full.flip_steps,
                           flips=full.flips[:n_vision])
    if "projector" in needs:
        proj = FlipSchedule(step_warm=full.step_warm,
                            flip_steps=full.flip_steps,
                            flips=full.flips[n_vision:])
    return vis, proj


def param_group(name: str) -> str:
    top = name.split(".", 1)[0]
    if top == "mm_projector":
        return "projector"
    if top == "vision_tower":
        return "vision"
    return "decoder"


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    return {k: param_group(k) for k, _ in model.named_parameters()}


class MMOptimizer:
    """Per-group clip -> adamw -> LR schedule; a group mapped to None is
    frozen (optax.set_to_zero)."""

    def __init__(self, groups: Dict[str, Optional[OptConfig]]):
        self.groups = groups
        self.schedules = {g: make_lr_schedule(c)
                          for g, c in groups.items() if c is not None}

    def init(self, params: Dict[str, torch.Tensor], axes=None,
             shards=None) -> Dict:
        """`axes`: quant_opt.quant_axes of the model, for 8-bit moments;
        `shards`: {name: (mesh axis, dim)} of the sharded parameters."""
        state = {}
        shards = shards or {}
        for g, c in self.groups.items():
            mine = {k: p for k, p in params.items() if param_group(k) == g}
            if c is None or not mine:
                state[g] = None
            elif c.state_8bit:
                from .quant_opt import QuantAdamState
                state[g] = QuantAdamState.init(mine, axes=axes,
                                               shards=shards)
            else:
                # the moments in the parameters' dtype, as optax keeps them
                state[g] = AdamState(
                    count=0, mu={k: torch.zeros_like(p)
                                 for k, p in mine.items()},
                    nu={k: torch.zeros_like(p) for k, p in mine.items()},
                    shards={k: a for k, (a, _) in shards.items()
                            if k in mine})
        return state

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: Dict) -> None:
        for g, c in self.groups.items():
            if state.get(g) is None:
                continue
            mine = {k: p for k, p in params.items() if param_group(k) == g}
            apply_adam_(mine, grads, state[g], c, self.schedules[g])


def group_config(tcfg: MMTrainConfig, lr: float) -> OptConfig:
    return OptConfig(
        lr=lr, lr_sched="cos" if tcfg.lr_sched == "cos" else "constant",
        warmup_steps=int(tcfg.warmup_ratio * tcfg.total_steps),
        total_steps=tcfg.total_steps, final_lr_fraction=0.0,
        grad_clip=tcfg.grad_clip, adam_b1=0.9, adam_b2=0.999,
        adam_eps=1e-8, weight_decay=tcfg.weight_decay,
        state_8bit=tcfg.opt_state_8bit)


def make_mm_optimizer(tcfg: MMTrainConfig) -> MMOptimizer:
    base_lr = tcfg.learning_rate
    proj_lr = tcfg.mm_projector_lr or base_lr
    if tcfg.stage == "pretrain":
        return MMOptimizer({
            "projector": group_config(
                tcfg, proj_lr if tcfg.mm_projector_lr else 1e-3),
            "vision": None, "decoder": None})
    return MMOptimizer({"projector": group_config(tcfg, proj_lr),
                        "vision": group_config(tcfg, base_lr),
                        "decoder": group_config(tcfg, base_lr)})


@dataclasses.dataclass
class MMTrainState:
    """The trained parameters (a module: the model, or LoRA's factors),
    the optimizer state and the step. `state_dict` / `load_state_dict`
    make it a Saver element."""

    params: torch.nn.Module
    opt_state: Dict
    step: int = 0

    @classmethod
    def create(cls, params: torch.nn.Module, optimizer) -> "MMTrainState":
        from .quant_opt import quant_axes
        return cls(params=params,
                   opt_state=optimizer.init(named_params(params),
                                            axes=quant_axes(params),
                                            shards=shard_axes(params)),
                   step=0)

    def state_dict(self) -> Dict:
        """The full state (gathered where sharded: every rank calls it),
        under the names an unsharded run gives it."""
        from .checkpoint import FullState
        opt = self.opt_state

        def full(s):
            return FullState(s, self.params).state_dict()
        return {"params": FullState(self.params).state_dict(),
                "step": self.step,
                "opt": ({g: full(s) if s is not None else None
                         for g, s in opt.items()}
                        if isinstance(opt, dict) else full(opt))}

    @torch.no_grad()
    def load_state_dict(self, d: Dict) -> None:
        from .checkpoint import FullState
        FullState(self.params).load_state_dict(d["params"])
        if isinstance(self.opt_state, dict):
            for g, s in self.opt_state.items():
                if s is not None:
                    FullState(s, self.params).load_state_dict(d["opt"][g])
        else:
            FullState(self.opt_state, self.params).load_state_dict(d["opt"])
        self.step = int(d["step"])


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A collator's numpy batch as tensors on `device` (ids and labels
    int64, images float32)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = torch.as_tensor(np.asarray(v))
        t = t.float() if k == "images" else t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _split(batch: Dict[str, torch.Tensor], n: int):
    b = batch["input_ids"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def _layer_metrics(out) -> Dict[str, torch.Tensor]:
    """Per-layer competition telemetry: which tower layers and whether the
    projector competed, and their routerloss."""
    m = {}
    if out.vision_auxes:
        losses = [a.losses for a in out.vision_auxes]
        if all("is_comp" in l for l in losses):
            m["vision/is_comp"] = torch.stack([l["is_comp"] for l in losses])
            m["vision/routerloss"] = torch.stack([l["routerloss"]
                                                  for l in losses])
    if out.projector_aux is not None and "is_comp" in \
            out.projector_aux.losses:
        m["projector/is_comp"] = out.projector_aux.losses["is_comp"]
        m["projector/routerloss"] = out.projector_aux.losses["routerloss"]
    return m


def _objective(out, world):
    """(the tensor to differentiate, the metrics) of one microbatch's
    LlavaOutput. Over several ranks (`world`): this rank's share of the
    global loss (its label tokens' cross-entropy sum over the global
    count, 1/world of its aux losses, which are means over its rows), and
    metrics that sum over the ranks to the global values."""
    metrics = {"loss/aux_mlp": out.aux_mlp.detach(),
               "loss/aux_clip": out.aux_clip.detach(),
               **{k: v.detach() for k, v in _layer_metrics(out).items()}}
    if world is None or world.size == 1:
        metrics["loss/total"] = out.loss.detach()
        return out.loss, metrics
    n_all = C.raw_all_reduce(out.n_tokens, world)
    share = (out.ce * (out.n_tokens / n_all)
             + (out.loss - out.ce) / world.size)
    metrics = {k: v / world.size for k, v in metrics.items()}
    metrics["loss/total"] = share.detach()
    return share, metrics


def _reduce_metrics(metrics: Dict[str, torch.Tensor], world
                    ) -> Dict[str, torch.Tensor]:
    """Sum the ranks' shares of the metrics (one collective)."""
    if world is None or world.size == 1:
        return metrics
    keys = sorted(metrics)
    flat = torch.cat([metrics[k].float().reshape(-1) for k in keys])
    flat = C.raw_all_reduce(flat, world, op="metrics")
    out, off = {}, 0
    for k in keys:
        n = metrics[k].numel()
        out[k] = flat[off:off + n].reshape(metrics[k].shape)
        off += n
    return out


def accumulate_grads(forward: Callable, params: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor], n_microbatch: int,
                     buffers: Dict[str, torch.Tensor], world=None):
    """Run `forward(microbatch) -> LlavaOutput` with a backward of its loss
    over `n_microbatch` slices; return (gradients, metrics). One slice
    leaves the gradients in the parameters' dtype (zeros where none
    reached a parameter); more sum them into the float32 `buffers`
    (filled on first use) and scale them by 1/n. `world`: the axis of
    every rank when this rank holds only its rows (`_objective`); the
    gradients are then this rank's, to be reduced by the caller."""
    for p in params.values():
        p.grad = None
    if n_microbatch == 1:
        loss, metrics = _objective(forward(batch), world)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        return grads, _reduce_metrics(metrics, world)
    if not buffers:
        buffers.update({k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()})
    else:
        for b in buffers.values():
            b.zero_()
    acc = None
    for mb in _split(batch, n_microbatch):
        loss, cur = _objective(forward(mb), world)
        loss.backward()
        with torch.no_grad():
            for k, p in params.items():
                if p.grad is not None:
                    buffers[k].add_(p.grad)
                    p.grad = None
        acc = cur if acc is None else {k: acc[k] + cur[k] for k in acc}
    inv = 1.0 / n_microbatch
    with torch.no_grad():
        for b in buffers.values():
            b.mul_(inv)
    return dict(buffers), _reduce_metrics({k: v * inv for k, v in
                                           acc.items()}, world)


def make_mm_train_step(model, optimizer: MMOptimizer,
                       n_microbatch: int = 1, mesh=None) -> Callable:
    """`train_step(state, batch) -> (state, metrics)`: batch holds
    input_ids, labels, attention_mask and images as tensors on the
    model's device (`batch_to`; over a `mesh` of several ranks, this
    rank's rows, `parallel.mesh.put_batch(..., n_microbatch)`). Metrics:
    loss/total, loss/aux_mlp, loss/aux_clip, grad_norm (over every
    gradient, before clipping), and the per-layer competition telemetry
    of `_layer_metrics`."""
    buffers: Dict[str, torch.Tensor] = {}
    world = mesh.axis("world") if mesh is not None else None

    def forward(mb, step):
        with distributed_ops.use_batch_axis(world):
            return model(mb["input_ids"], mb.get("images"),
                         labels=mb["labels"],
                         attention_mask=mb["attention_mask"], step=step,
                         train=True)

    def step_fn(state: MMTrainState, batch: Dict[str, torch.Tensor]):
        params = named_params(model)
        grads, metrics = accumulate_grads(
            lambda mb: forward(mb, state.step), params, batch, n_microbatch,
            buffers, world)
        if mesh is not None:
            reduce_gradients(model, mesh, grads)
        axes = {k: a for k, (a, _) in shard_axes(model).items()}
        metrics["grad_norm"] = global_norm(grads.values(),
                                           [axes.get(k) for k in grads])
        optimizer.apply(params, grads, state.opt_state)
        del grads
        state.step += 1
        return state, metrics

    return step_fn


def make_mm_eval_step(model, mesh=None) -> Callable:
    """`eval_step(batch) -> loss` (a device scalar) for eval during
    training; over a `mesh` of several ranks, batch is this rank's rows
    and the loss the global one."""
    world = mesh.axis("world") if mesh is not None else None

    @torch.no_grad()
    def step_fn(batch):
        with distributed_ops.use_batch_axis(world):
            out = model(batch["input_ids"], batch.get("images"),
                        labels=batch["labels"],
                        attention_mask=batch["attention_mask"], train=False)
        loss, _ = _objective(out, world)
        return _reduce_metrics({"loss": loss}, world)["loss"]

    return step_fn
