"""LoRA training for the multimodal model (port of
competesmoe_tpu/train/lora.py).

The low-rank factors live apart from the frozen model, in a `LoRAParams`
module, and fold into the adapted weights during the step:
W_eff = W + (alpha / r) * (A @ B) in JAX's [in, out] orientation, which is
(A @ B)^T against an nn.Linear weight. The fold is installed as a
parametrization of each adapted weight for the forward and backward of
the step (so a checkpointed layer's recompute sees it too) and removed
after; gradients reach only A and B.

`default_lora_filter` targets every nn.Linear outside the vision tower and
the projector, and never the lm_head: the reference's
`find_all_linear_names`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from .mm_task import MMTrainState, accumulate_grads
from .lm_trainer import global_norm

_EXCLUDE_TOP = ("vision_tower", "mm_projector")


def default_lora_filter(name: str, module: nn.Module) -> bool:
    return (isinstance(module, nn.Linear)
            and name.split(".", 1)[0] not in _EXCLUDE_TOP
            and "lm_head" not in name.split("."))


class LoRAParams(nn.Module):
    """Factors `a` [in, r] and `b` [r, out] per adapted module name."""

    def __init__(self, names: List[str], a: List[torch.Tensor],
                 b: List[torch.Tensor]):
        super().__init__()
        self.names = list(names)
        self.a = nn.ParameterList(nn.Parameter(t) for t in a)
        self.b = nn.ParameterList(nn.Parameter(t) for t in b)

    def factors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {n: {"a": a, "b": b}
                for n, a, b in zip(self.names, self.a, self.b)}

    @torch.no_grad()
    def load_factors(self, tree: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Copy factors keyed by module name (convert.from_jax_lora)."""
        if set(tree) != set(self.names):
            raise KeyError(f"LoRA names differ: "
                           f"{sorted(set(tree) ^ set(self.names))[:6]}")
        for n, a, b in zip(self.names, self.a, self.b):
            a.copy_(tree[n]["a"])
            b.copy_(tree[n]["b"])


def init_lora_params(model: nn.Module, rank: int,
                     generator: torch.Generator,
                     filter_fn: Callable = default_lora_filter,
                     dtype: torch.dtype = torch.float32) -> LoRAParams:
    """A ~ N(0, 1/rank), B = 0 (the PEFT init: step 0 reproduces the base
    model exactly), drawn from `generator` in module order, on the
    model's device."""
    names, a, b = [], [], []
    for name, mod in model.named_modules():
        if not filter_fn(name, mod):
            continue
        d_out, d_in = mod.weight.shape
        names.append(name)
        a.append((torch.randn((d_in, rank), generator=generator,
                              dtype=dtype, device=generator.device)
                  / rank ** 0.5).to(mod.weight.device))
        b.append(torch.zeros((rank, d_out), dtype=dtype,
                             device=mod.weight.device))
    return LoRAParams(names, a, b)


def lora_scaling(rank: int, alpha: float) -> float:
    return alpha / rank


class _Fold(nn.Module):
    def __init__(self, a, b, scaling: float):
        super().__init__()
        self.a, self.b, self.scaling = a, b, scaling

    def forward(self, w):
        delta = (self.a @ self.b) * self.scaling
        return w + delta.t().to(w.dtype)


@contextlib.contextmanager
def apply_lora(model: nn.Module, lora: LoRAParams, scaling: float):
    """W_eff = W + scaling * (A @ B)^T at every adapted weight, for the
    duration of the `with` block (forward and backward), where the
    model's own parameters take no gradient."""
    mods = dict(model.named_modules())
    grad_flags = {p: p.requires_grad for p in model.parameters()}
    for p in grad_flags:
        p.requires_grad_(False)
    from ..parallel.mesh import sharded_holder
    try:
        for n, a, b in zip(lora.names, lora.a, lora.b):
            shards = sharded_holder(mods[n], "weight")
            if shards is not None:
                # a weight gathered at use (parallel/mesh.py) folds after
                # the gather
                shards.folds["weight"] = _Fold(a, b, scaling)
            else:
                parametrize.register_parametrization(
                    mods[n], "weight", _Fold(a, b, scaling), unsafe=True)
        yield model
    finally:
        for n in lora.names:
            shards = sharded_holder(mods[n], "weight")
            if shards is not None:
                shards.folds.pop("weight", None)
            elif parametrize.is_parametrized(mods[n], "weight"):
                parametrize.remove_parametrizations(
                    mods[n], "weight", leave_parametrized=False)
        for p, flag in grad_flags.items():
            p.requires_grad_(flag)


def make_mm_lora_train_step(model: nn.Module, optimizer, scaling: float,
                            n_microbatch: int = 1, mesh=None) -> Callable:
    """`train_step(state, batch) -> (state, metrics)` where state.params
    is the LoRAParams module and `optimizer` a lm_trainer.Optimizer
    (clip_by_global_norm(1.0) -> adamw(lr, wd 0) in the CLI); the same
    microbatching, metrics and ranks as mm_task.make_mm_train_step (the
    factors are replicated: their gradients sum over every rank)."""
    from ..parallel import distributed_ops
    from ..parallel.mesh import reduce_gradients
    buffers: Dict[str, torch.Tensor] = {}
    world = mesh.axis("world") if mesh is not None else None

    def step_fn(state: MMTrainState, batch: Dict[str, torch.Tensor]):
        lora = state.params
        params = dict(lora.named_parameters())

        def forward(mb):
            with distributed_ops.use_batch_axis(world):
                return model(mb["input_ids"], mb.get("images"),
                             labels=mb["labels"],
                             attention_mask=mb["attention_mask"],
                             step=state.step, train=True)

        with apply_lora(model, lora, scaling):
            grads, metrics = accumulate_grads(forward, params, batch,
                                              n_microbatch, buffers, world)
        if mesh is not None:
            reduce_gradients(lora, mesh, grads)
        metrics["grad_norm"] = global_norm(grads.values())
        optimizer.apply(params, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return step_fn
