"""Adaptive Computation Time wrapper (port of competesmoe_tpu/models/act.py):
`ACTBlock` ponders a block up to `max_steps` times per token.

A sigmoid halting unit (`halting`: Linear(D, 1), weight 0 and bias 1 at
init, read in float32) accumulates probability mass; a token stops
contributing once it crosses `threshold`, and the output is the
halting-weighted mix of the intermediate states. The loop always runs
`max_steps` block applications with masks, as JAX's static loop does.
The aux loss is the blocks' aux losses plus `act_loss_coef` times the
ponder cost mean(N(t) + remainder); the blocks' named losses come back as
`ponder{i}/<name>` with `ponder_cost` beside them. The wrapped block's
routing telemetry is not passed on (JAX's ACTBlock returns none).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..moe.layers import MoEAux


class ACTBlock(nn.Module):
    def __init__(self, block: nn.Module, d_model: int, max_steps: int = 4,
                 threshold: float = 0.99, act_loss_coef: float = 0.0,
                 device=None):
        super().__init__()
        self.block = block
        self.halting = nn.Linear(d_model, 1, device=device)
        self.max_steps = max_steps
        self.threshold = threshold
        self.act_loss_coef = act_loss_coef

    @property
    def norm1(self):
        """The wrapped block's first norm (the Transformer-XL carry saves
        each layer's normalised input)."""
        return self.block.norm1

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator = None) -> None:
        self.halting.weight.zero_()
        self.halting.bias.fill_(1.0)

    def draw_noise(self, x, prev_state, g):
        """One draw of the block's noise for each ponder step."""
        return [self.block.draw_noise(x, prev_state, g)
                for _ in range(self.max_steps)]

    def forward(self, x, step=None, train: bool = False, flips=None,
                prev_state=None, pos_offset: int = 0,
                return_id_experts: bool = False, noise=None):
        B, T, _ = x.shape
        acc = torch.zeros((B, T), dtype=torch.float32, device=x.device)
        remainders = torch.zeros_like(acc)
        n_updates = torch.zeros_like(acc)
        out = torch.zeros_like(x)
        state = x
        total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        losses: Dict[str, torch.Tensor] = {}
        for step_i in range(self.max_steps):
            p = torch.sigmoid(self.halting(state.float())[..., 0])
            still = acc < self.threshold
            last = step_i == self.max_steps - 1
            crossing = still & ((acc + p >= self.threshold) | last)
            use_p = torch.where(crossing, 1.0 - acc, p)
            use_p = torch.where(still, use_p, torch.zeros_like(use_p))

            new_state, aux = self.block(state, step, train, flips,
                                        prev_state, pos_offset,
                                        return_id_experts,
                                        noise[step_i] if noise else None)
            out = out + use_p[..., None].to(x.dtype) * new_state
            remainders = remainders + torch.where(
                crossing, 1.0 - acc, torch.zeros_like(acc))
            n_updates = n_updates + still.float()
            acc = acc + use_p
            state = new_state
            total_aux = total_aux + aux.aux_loss
            for k, v in aux.losses.items():
                losses[f"ponder{step_i}/{k}"] = v

        ponder_cost = torch.mean(n_updates + remainders)
        total = total_aux + self.act_loss_coef * ponder_cost
        losses["ponder_cost"] = ponder_cost.detach()
        return out, MoEAux(aux_loss=total, losses=losses)
