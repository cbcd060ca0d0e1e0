"""LM pretraining step: optimizer, LR schedule, train and eval steps (port
of competesmoe_tpu/train/lm_trainer.py).

The optax chain of the JAX trainer is written out, not taken from
torch.optim, so that the same gradients give the same update:

- `clip_by_global_norm(grad_clip)`: the gradients are scaled by
  max_norm / norm only when norm >= max_norm (no epsilon added, unlike
  `torch.nn.utils.clip_grad_norm_`);
- `adam` (or `adamw` when weight_decay > 0, decaying every parameter, no
  mask): moments mu, nu; bias corrections 1 - b^count; update
  mu_hat / (sqrt(nu_hat) + eps) (+ wd * param); step -lr(count) * update;
- `cosine_decay_schedule(lr, total - warmup, alpha=final_lr_fraction)`,
  joined after a linear warmup from 0 when warmup_steps > 0.

Parameters and the moments are updated in place (JAX builds new trees;
in place saves a copy of the 154M parameters and both moments per step).
`make_train_step` runs `n_microbatch` forward/backward passes over slices
of the batch, all at the same step (so with the same flips), sums their
gradients in the parameters' `.grad` and takes one optimizer step with
their mean. Metric names are JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from ..models.lm import MoELanguageModel, lm_loss_fn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """The reference sweep's optimizer block (lr 2.5e-4, cosine schedule,
    warmup, grad clip)."""

    lr: float = 2.5e-4
    lr_sched: str = "cos"          # 'cos' | 'constant'
    warmup_steps: int = 0
    total_steps: int = 100_000
    final_lr_fraction: float = 0.1
    grad_clip: float = 0.25
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    state_8bit: bool = False


def make_lr_schedule(cfg: OptConfig) -> Callable[[int], float]:
    """step -> learning rate, optax's cosine/constant schedules and the
    linear-warmup join written out."""
    if cfg.lr_sched == "constant":
        def base(step):
            return cfg.lr
    elif cfg.lr_sched == "cos":
        decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
        alpha = cfg.final_lr_fraction

        def base(step):
            frac = min(step, decay_steps) / decay_steps
            cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
            return cfg.lr * ((1.0 - alpha) * cosine + alpha)
    else:
        raise ValueError(f"unknown lr_sched {cfg.lr_sched!r}")
    if cfg.warmup_steps <= 0:
        return base
    w = cfg.warmup_steps

    def joined(step):
        if step < w:
            return cfg.lr * min(step, w) / w
        return base(step - w)
    return joined


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    def direction(self, name: str, g: torch.Tensor, count: int, b1: float,
                  b2: float, eps: float) -> torch.Tensor:
        """Update `name`'s moments in place with `g` at Adam step `count`
        (1-based) and return mu_hat / (sqrt(nu_hat) + eps). A moment of a
        low-precision dtype is updated in float32 and rounded once into
        its store."""
        mu, nu = self.mu[name], self.nu[name]
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count
        if mu.dtype == torch.float32:
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m, v = mu, nu
        else:
            g32 = g.float()
            m = mu.float().mul_(b1).add_(g32, alpha=1.0 - b1)
            v = nu.float().mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
            mu.copy_(m)
            nu.copy_(v)
        return (m / c1) / (torch.sqrt(v / c2) + eps)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, d: Dict) -> None:
        """Copy saved moments into this state's tensors (their devices
        stay); the parameter names must match."""
        for key in ("mu", "nu"):
            mine, saved = getattr(self, key), d[key]
            if set(mine) != set(saved):
                raise KeyError(f"optimizer state {key}: saved names differ "
                               f"from the model's: "
                               f"{sorted(set(mine) ^ set(saved))[:8]}")
            for name, t in mine.items():
                t.copy_(saved[name])
        self.count = int(d["count"])


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: scale by max_norm / norm only when
    norm >= max_norm (no epsilon)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, t, t / norm.to(t.dtype) * max_norm)
            for t in grads]


class Optimizer:
    """clip_by_global_norm -> adam/adamw with the LR schedule (the optax
    chain of `make_optimizer` in JAX). `state_8bit` holds the moments
    blockwise in 8 bits (train/quant_opt.py)."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)

    def init(self, params: Dict[str, torch.Tensor], axes=None):
        """`axes`: quant_opt.quant_axes of the model, for 8-bit moments."""
        if self.cfg.state_8bit:
            from .quant_opt import QuantAdamState
            return QuantAdamState.init(params, axes=axes)
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()})

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state) -> None:
        """One update of `params` and `state` in place from `grads`
        (which have already been reduced over microbatches)."""
        apply_adam_(params, grads, state, self.cfg, self.schedule)


@torch.no_grad()
def apply_adam_(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state, cfg: OptConfig,
                schedule: Callable[[int], float]) -> None:
    """clip (cfg.grad_clip > 0) -> adam(w) -> -lr(count) of one group of
    parameters, in place, with `state` an AdamState or a QuantAdamState.
    The direction is cast to the gradient's dtype, as optax's update
    stays in it."""
    names = list(params)
    g = [grads[k] for k in names]
    if cfg.grad_clip > 0:
        g = clip_by_global_norm(g, cfg.grad_clip)
    count = state.count + 1
    lr = schedule(state.count)
    for k, gk in zip(names, g):
        p = params[k]
        u = state.direction(k, gk, count, cfg.adam_b1, cfg.adam_b2,
                            cfg.adam_eps).to(gk.dtype)
        if cfg.weight_decay > 0:
            u = u + cfg.weight_decay * p
        p.add_(u, alpha=-lr)
    state.count = count


def make_optimizer(cfg: OptConfig) -> Optimizer:
    return Optimizer(cfg)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


@dataclasses.dataclass
class TrainState:
    model: MoELanguageModel
    opt_state: AdamState
    step: int = 0

    @classmethod
    def create(cls, model: MoELanguageModel, optimizer: Optimizer):
        from .quant_opt import quant_axes
        return cls(model=model,
                   opt_state=optimizer.init(dict(model.named_parameters()),
                                            axes=quant_axes(model)),
                   step=0)


def make_train_step(model: MoELanguageModel, optimizer: Optimizer,
                    ignore_index: int = -100, n_microbatch: int = 1,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable:
    """`train_step(state, tokens) -> (state, metrics)`; tokens [B, T+1]
    int on the model's device: inputs tokens[:, :-1], targets
    tokens[:, 1:]. Metrics are 0-dim device tensors (read them with
    float(); that synchronises). `generator` feeds the model's random
    draws (layer drop, MoA's dropouts), where it has any."""

    def loss_for(step: int, tokens: torch.Tensor):
        logits, aux = model(tokens[:, :-1], step=step, train=True,
                            generator=generator)
        ce, n_tok = lm_loss_fn(logits, tokens[:, 1:], ignore_index)
        total = ce + aux["total_aux_loss"]
        # distillation health: router-vs-competition top-k agreement,
        # summed over the layers that flipped this step
        zero = torch.zeros((), dtype=torch.float32, device=total.device)
        agree = sum((v for k, v in aux.items()
                     if k.endswith("router_agreement")), zero)
        ncomp = sum((v for k, v in aux.items() if k.endswith("is_comp")),
                    zero)
        total.backward()
        return (total.detach(), ce.detach(), aux["total_aux_loss"].detach(),
                n_tok, agree, ncomp)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        b = tokens.shape[0]
        if b % n_microbatch:
            raise ValueError(f"batch {b} not divisible by {n_microbatch} "
                             f"microbatches")
        acc = None
        for mb in tokens.reshape(n_microbatch, b // n_microbatch,
                                 *tokens.shape[1:]):
            out = loss_for(state.step, mb)
            acc = out if acc is None else tuple(a + o for a, o in
                                                zip(acc, out))
        inv = 1.0 / n_microbatch
        grads = {k: (p.grad * inv if n_microbatch > 1 else p.grad)
                 if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        total, ce, reg = acc[0] * inv, acc[1] * inv, acc[2] * inv
        n_tok = acc[3]
        # every microbatch sees the same step, hence the same flips
        agree, ncomp = acc[4] * inv, acc[5] * inv
        grad_norm = global_norm(grads.values())
        optimizer.apply(params, grads, state.opt_state)
        for p in params.values():
            p.grad = None
        metrics = {
            "loss/total": total,
            "loss/ce": ce,
            "loss/reg": reg,
            "n_tokens": n_tok,
            "grad_norm": grad_norm,
            # -1 on steps where no layer competed
            "competesmoe/router_agreement": torch.where(
                ncomp > 0, agree / torch.clamp(ncomp, min=1.0),
                torch.full_like(ncomp, -1.0)),
            "competesmoe/n_flip_layers": ncomp,
        }
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(model: MoELanguageModel,
                   ignore_index: int = -100) -> Callable:
    """`eval_step(tokens) -> (sum_nll, n_tokens)` for perplexity."""

    @torch.no_grad()
    def step_fn(tokens):
        logits, _ = model(tokens[:, :-1], train=False)
        ce, n_tok = lm_loss_fn(logits, tokens[:, 1:], ignore_index)
        return ce * n_tok, n_tok

    return step_fn
