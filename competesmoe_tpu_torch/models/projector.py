"""Multimodal projector: MoE / linear / mlpNx_gelu / identity (port of
competesmoe_tpu/models/projector.py)."""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn as nn

from ..device import resolve_device
from ..moe.config import MoEArgs
from ..moe.layers import gelu_exact, zero_aux
from ..moe.registry import get_moe


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    projector_type: str = "moe"        # moe | linear | mlpNx_gelu | identity
    mm_hidden_size: int = 1152
    hidden_size: int = 3072
    n_scales: int = 1
    moe_name: str = "smoe"
    num_experts: int = 4
    num_selected: int = 2
    moe_args: MoEArgs = MoEArgs()
    dtype: torch.dtype = torch.float32

    @property
    def mm_channels(self) -> int:
        return self.mm_hidden_size * self.n_scales


def _moe_layer(cfg: ProjectorConfig, device):
    return get_moe(cfg.moe_name)(
        cfg.mm_channels, cfg.hidden_size, n_experts=cfg.num_experts,
        n_selected=cfg.num_selected, args=cfg.moe_args, device=device,
        dtype=cfg.dtype)


class MLPMoE(nn.Module):
    """MoE projector: experts Linear(mm_channels, d) -> GELU -> Linear."""

    def __init__(self, cfg: ProjectorConfig, device=None):
        super().__init__()
        self.moelayer = _moe_layer(cfg, device)

    def forward(self, x, *, step=None, train=False, return_id_experts=False):
        return self.moelayer(x, step=step, train=train,
                             return_id_experts=return_id_experts)


def mlp_depth(projector_type: str) -> int:
    """N of an 'mlpNx_gelu' projector type (0 for another type)."""
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    return int(m.group(1)) if m else 0


class VisionProjector(nn.Module):
    """Dispatch on projector_type. Returns (y, MoEAux). 'mlpNx_gelu' is N
    Linear layers `mlp_0` ... `mlp_{N-1}` (JAX's names) with an exact GELU
    between each two."""

    def __init__(self, cfg: ProjectorConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        t = cfg.projector_type
        if t == "moe":
            # named `moelayer` to match the released checkpoints' paths
            self.moelayer = _moe_layer(cfg, device)
        elif t == "linear":
            self.fc = nn.Linear(cfg.mm_channels, cfg.hidden_size,
                                device=device, dtype=cfg.dtype)
        elif mlp_depth(t):
            for i in range(mlp_depth(t)):
                self.add_module(f"mlp_{i}", nn.Linear(
                    cfg.mm_channels if i == 0 else cfg.hidden_size,
                    cfg.hidden_size, device=device, dtype=cfg.dtype))
        elif t != "identity":
            raise ValueError(f"Unknown projector type: {t}")

    def set_flip_schedule(self, schedule=None) -> None:
        """Give a competing MoE layer row 0 of `schedule` (a one-row
        moe.schedule.FlipSchedule) and its warm-up; None: no
        competition."""
        moe = getattr(self, "moelayer", None)
        if hasattr(moe, "step_warm"):
            moe.flip_schedule = schedule.flips[0] if schedule else None
            moe.step_warm = schedule.step_warm if schedule else 0

    def forward(self, x, *, step=None, train=False, return_id_experts=False):
        t = self.cfg.projector_type
        if t == "moe":
            return self.moelayer(x, step=step, train=train,
                                 return_id_experts=return_id_experts)
        if t == "linear":
            return self.fc(x), zero_aux(x)
        if t == "identity":
            return x, zero_aux(x)
        h = x
        for i in range(mlp_depth(t)):
            if i > 0:
                h = gelu_exact(h)
            h = getattr(self, f"mlp_{i}")(h)
        return h, zero_aux(h)
