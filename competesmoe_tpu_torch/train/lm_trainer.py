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

Over several ranks (`mesh`, `parallel/mesh.py`), each rank holds its rows
of the global batch (`put_batch`) and its shards of the parameters. Its
objective is its share of the global loss: its tokens' cross-entropy sum
over the global token count, plus 1/world of its aux losses (each a mean
over its rows, or, where a statistic spans rows, the global value through
`parallel/distributed_ops`), so the ranks' objectives sum to the global
loss. `mesh.reduce_gradients` then sums every gradient over the ranks
that hold a copy of its parameter (replicated ones over the world, expert
banks over 'data'); `global_norm` counts each shard once; the reported
losses are the global ones. With a 'seq' axis (`-n_seq_shards`) the
ranks of a row block split its sequence: each takes its block of the
inputs and of the targets (shifted before the split, so a block's last
target is the next block's first token), and the batch axis spans every
rank (`parallel.distributed_ops`, the token statistics over 'seq').
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
    """Adam's count and float moments per parameter name. `shards`: the
    mesh axis of each sharded parameter (its moments are shards too), so
    that clipping counts each shard once."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    shards: Dict[str, object] = dataclasses.field(default_factory=dict)

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


def clip_by_global_norm(grads, max_norm: float, axes=None):
    """optax.clip_by_global_norm: scale by max_norm / norm only when
    norm >= max_norm (no epsilon). `axes`: see `global_norm`."""
    norm = global_norm(grads, axes)
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

    def init(self, params: Dict[str, torch.Tensor], axes=None,
             shards=None):
        """`axes`: quant_opt.quant_axes of the model, for 8-bit moments;
        `shards`: {name: (mesh axis, dim)} of the sharded parameters
        (`parallel.mesh.shard_axes`)."""
        if self.cfg.state_8bit:
            from .quant_opt import QuantAdamState
            return QuantAdamState.init(params, axes=axes, shards=shards)
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            shards={k: a for k, (a, _) in (shards or {}).items()})

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
        g = clip_by_global_norm(g, cfg.grad_clip,
                                [state.shards.get(k) for k in names])
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


def global_norm(tensors, axes=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    `axes`: per tensor, None, or the mesh axis it is a shard over: its
    squares are summed over that axis's ranks, so the norm is the full
    tensors' on every rank."""
    tensors = list(tensors)
    if not axes or all(a is None for a in axes):
        return torch.sqrt(sum(torch.sum(t.float() * t.float())
                              for t in tensors))
    from ..parallel import collectives as C
    local, over = 0.0, {}
    for t, a in zip(tensors, axes):
        sq = torch.sum(t.float() * t.float())
        if a is None:
            local = local + sq
        else:
            over.setdefault(a.name, [a, 0.0])[1] += sq
    for a, sq in over.values():
        local = local + C.raw_all_reduce(sq, a, op="grad_norm")
    return torch.sqrt(local)


@dataclasses.dataclass
class TrainState:
    model: MoELanguageModel
    opt_state: AdamState
    step: int = 0

    @classmethod
    def create(cls, model: MoELanguageModel, optimizer: Optimizer):
        from ..parallel.mesh import named_params, shard_axes
        from .quant_opt import quant_axes
        return cls(model=model,
                   opt_state=optimizer.init(named_params(model),
                                            axes=quant_axes(model),
                                            shards=shard_axes(model)),
                   step=0)


def _seq_scope(mesh):
    """Sequence parallelism for a mesh with a 'seq' axis."""
    import contextlib
    if mesh is None or mesh.shape.get("seq", 1) == 1:
        return contextlib.nullcontext()
    from ..parallel.seq_context import use_sequence_parallel
    return use_sequence_parallel(mesh)


def make_train_step(model: MoELanguageModel, optimizer: Optimizer,
                    ignore_index: int = -100, n_microbatch: int = 1,
                    generator: Optional[torch.Generator] = None,
                    mesh=None) -> Callable:
    """`train_step(state, tokens) -> (state, metrics)`; tokens [B, T+1]
    int on the model's device: inputs tokens[:, :-1], targets
    tokens[:, 1:] (over a `mesh` of several ranks: this rank's rows,
    `put_batch(..., n_microbatch)`). Metrics are 0-dim device tensors
    (read them with float(); that synchronises). `generator` feeds the
    model's random draws (layer drop, MoA's dropouts), where it has
    any."""
    from ..parallel import collectives as C
    from ..parallel import distributed_ops
    from ..parallel.mesh import named_params, reduce_gradients, shard_axes

    from ..parallel.mesh import seq_block

    dist_ = mesh is not None and mesh.is_distributed
    world = mesh.axis("world") if dist_ else None
    seq = mesh.axis("seq") if dist_ and "seq" in mesh.shape else None
    shard_of = {k: a for k, (a, _) in shard_axes(model).items()}

    def loss_for(step: int, tokens: torch.Tensor):
        # the backward's recomputes (remat, the competition step's
        # checkpoint) run under the forward's contexts too
        with distributed_ops.use_batch_axis(world, tokens=seq), \
                _seq_scope(mesh):
            return _loss_for(step, tokens)

    def _loss_for(step: int, tokens: torch.Tensor):
        inputs = seq_block(tokens[:, :-1], mesh)
        targets = seq_block(tokens[:, 1:], mesh)
        logits, aux = model(inputs, step=step, train=True,
                            generator=generator)
        ce, n_tok = lm_loss_fn(logits, targets, ignore_index)
        reg = aux["total_aux_loss"]
        if dist_:
            # this rank's share of the global loss: its tokens' sum over
            # the global count, 1/world of its aux (means over its rows)
            n_all = C.raw_all_reduce(n_tok, world)
            ce = ce * (n_tok / n_all)
            reg = reg / world.size
        total = ce + reg
        # distillation health: router-vs-competition top-k agreement,
        # summed over the layers that flipped this step
        zero = torch.zeros((), dtype=torch.float32, device=total.device)
        agree = sum((v for k, v in aux.items()
                     if k.endswith("router_agreement")), zero)
        ncomp = sum((v for k, v in aux.items() if k.endswith("is_comp")),
                    zero)
        total.backward()
        if dist_:
            n_tok, agree = n_all, agree / world.size
        return (total.detach(), ce.detach(), reg.detach(), n_tok, agree,
                ncomp)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        params = named_params(model)
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
        if dist_:
            reduce_gradients(model, mesh, grads)
            # the global losses: the sum of the ranks' shares
            summed = C.raw_all_reduce(torch.stack(
                [acc[0], acc[1], acc[2], acc[4]]), world, op="metrics")
            acc = (summed[0], summed[1], summed[2], acc[3], summed[3],
                   acc[5])
        total, ce, reg = acc[0] * inv, acc[1] * inv, acc[2] * inv
        n_tok = acc[3]
        # every microbatch sees the same step, hence the same flips
        agree, ncomp = acc[4] * inv, acc[5] * inv
        grad_norm = global_norm(grads.values(),
                                [shard_of.get(k) for k in grads])
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
                   ignore_index: int = -100, mesh=None) -> Callable:
    """`eval_step(tokens) -> (sum_nll, n_tokens)` for perplexity; over a
    `mesh` of several ranks, tokens are this rank's rows and the sums are
    the global ones."""
    from ..parallel import collectives as C
    from ..parallel.mesh import seq_block
    world = mesh.axis("world") if mesh is not None else None

    @torch.no_grad()
    def step_fn(tokens):
        with _seq_scope(mesh):
            logits, _ = model(seq_block(tokens[:, :-1], mesh), train=False)
        ce, n_tok = lm_loss_fn(logits, seq_block(tokens[:, 1:], mesh),
                               ignore_index)
        if world is not None and world.size > 1:
            both = C.raw_all_reduce(torch.stack(
                [ce * n_tok, n_tok.to(ce.dtype)]), world, op="metrics")
            return both[0], both[1].round().long()
        return ce * n_tok, n_tok

    return step_fn
