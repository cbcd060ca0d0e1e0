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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..moe.schedule import FlipSchedule, build_flip_schedule
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

    def init(self, params: Dict[str, torch.Tensor], axes=None) -> Dict:
        """`axes`: quant_opt.quant_axes of the model, for 8-bit moments."""
        state = {}
        for g, c in self.groups.items():
            mine = {k: p for k, p in params.items() if param_group(k) == g}
            if c is None or not mine:
                state[g] = None
            elif c.state_8bit:
                from .quant_opt import QuantAdamState
                state[g] = QuantAdamState.init(mine, axes=axes)
            else:
                # the moments in the parameters' dtype, as optax keeps them
                state[g] = AdamState(
                    count=0, mu={k: torch.zeros_like(p)
                                 for k, p in mine.items()},
                    nu={k: torch.zeros_like(p) for k, p in mine.items()})
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
                   opt_state=optimizer.init(dict(params.named_parameters()),
                                            axes=quant_axes(params)),
                   step=0)

    def state_dict(self) -> Dict:
        opt = self.opt_state
        return {"params": self.params.state_dict(), "step": self.step,
                "opt": ({g: s.state_dict() if s is not None else None
                         for g, s in opt.items()}
                        if isinstance(opt, dict) else opt.state_dict())}

    @torch.no_grad()
    def load_state_dict(self, d: Dict) -> None:
        self.params.load_state_dict(d["params"])
        if isinstance(self.opt_state, dict):
            for g, s in self.opt_state.items():
                if s is not None:
                    s.load_state_dict(d["opt"][g])
        else:
            self.opt_state.load_state_dict(d["opt"])
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


def accumulate_grads(forward: Callable, params: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor], n_microbatch: int,
                     buffers: Dict[str, torch.Tensor]):
    """Run `forward(microbatch) -> LlavaOutput` with a backward of its loss
    over `n_microbatch` slices; return (gradients, metrics). One slice
    leaves the gradients in the parameters' dtype (zeros where none
    reached a parameter); more sum them into the float32 `buffers`
    (filled on first use) and scale them by 1/n."""
    for p in params.values():
        p.grad = None
    if n_microbatch == 1:
        out = forward(batch)
        out.loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        metrics = {"loss/total": out.loss.detach(),
                   "loss/aux_mlp": out.aux_mlp.detach(),
                   "loss/aux_clip": out.aux_clip.detach(),
                   **{k: v.detach() for k, v in _layer_metrics(out).items()}}
        return grads, metrics
    if not buffers:
        buffers.update({k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()})
    else:
        for b in buffers.values():
            b.zero_()
    acc = None
    for mb in _split(batch, n_microbatch):
        out = forward(mb)
        out.loss.backward()
        with torch.no_grad():
            for k, p in params.items():
                if p.grad is not None:
                    buffers[k].add_(p.grad)
                    p.grad = None
        cur = {"loss/total": out.loss.detach(),
               "loss/aux_mlp": out.aux_mlp.detach(),
               "loss/aux_clip": out.aux_clip.detach(),
               **{k: v.detach() for k, v in _layer_metrics(out).items()}}
        acc = cur if acc is None else {k: acc[k] + cur[k] for k in acc}
    inv = 1.0 / n_microbatch
    with torch.no_grad():
        for b in buffers.values():
            b.mul_(inv)
    return dict(buffers), {k: v * inv for k, v in acc.items()}


def make_mm_train_step(model, optimizer: MMOptimizer,
                       n_microbatch: int = 1) -> Callable:
    """`train_step(state, batch) -> (state, metrics)`: batch holds
    input_ids, labels, attention_mask and images as tensors on the
    model's device (`batch_to`). Metrics: loss/total, loss/aux_mlp,
    loss/aux_clip, grad_norm (over every gradient, before clipping), and
    the per-layer competition telemetry of `_layer_metrics`."""
    buffers: Dict[str, torch.Tensor] = {}

    def forward(mb, step):
        return model(mb["input_ids"], mb.get("images"), labels=mb["labels"],
                     attention_mask=mb["attention_mask"], step=step,
                     train=True)

    def step_fn(state: MMTrainState, batch: Dict[str, torch.Tensor]):
        params = dict(model.named_parameters())
        grads, metrics = accumulate_grads(
            lambda mb: forward(mb, state.step), params, batch, n_microbatch,
            buffers)
        metrics["grad_norm"] = global_norm(grads.values())
        optimizer.apply(params, grads, state.opt_state)
        del grads
        state.step += 1
        return state, metrics

    return step_fn


def make_mm_eval_step(model) -> Callable:
    """`eval_step(batch) -> loss` (a device scalar) for eval during
    training."""

    @torch.no_grad()
    def step_fn(batch):
        return model(batch["input_ids"], batch.get("images"),
                     labels=batch["labels"],
                     attention_mask=batch["attention_mask"],
                     train=False).loss

    return step_fn
