"""The multimodal MoE layers with 2-layer Linear/act/Linear experts (port
of competesmoe_tpu/moe/layers.py: SMoE, and CompeteSMoE with its
competition step).

Parameters keep the JAX layout: the gate kernel is [in, E] and the
experts are stacked tensors `experts_w1` [E, in, h], `experts_b1` [E, h],
`experts_w2` [E, h, out], `experts_b2` [E, out]. Layers return
`(output, MoEAux)`. Constructors leave the weights uninitialised, like
`torch.empty`; fill them with `models.builder.init_random_` or
`load_state_dict`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..device import resolve_device
from ..ops import expert_compute as ec
from ..ops.expert_compute import gelu_tanh
from ..ops import losses as L
from ..ops import routing as R
from .config import MoEArgs
from .registry import register_moe


def gelu_exact(x):
    """torch.nn.GELU() default: the exact erf form."""
    return F.gelu(x)


def quick_gelu(x):
    """x * sigmoid(1.702 x) as XLA rounds it: 1.702 taken in x's dtype
    (a weakly typed constant), the sigmoid stepwise."""
    c = torch.full((), 1.702, dtype=x.dtype, device=x.device)
    return x * R.sigmoid(c * x)


_ACTIVATIONS = {"gelu": gelu_exact, "gelu_tanh": gelu_tanh,
                "quick_gelu": quick_gelu}


@dataclasses.dataclass
class MoEAux:
    """Auxiliary outputs of a MoE layer.

    aux_loss: coefficient-scaled scalar for the task loss.
    losses: named detached scalar components.
    gate_softmax: [.., N, E] routing distribution (f32) for telemetry.
    selected_experts: [.., N, k] chosen expert ids.
    """

    aux_loss: torch.Tensor
    losses: Dict[str, torch.Tensor]
    gate_softmax: Optional[torch.Tensor] = None
    selected_experts: Optional[torch.Tensor] = None


def zero_aux(x: torch.Tensor) -> MoEAux:
    return MoEAux(aux_loss=torch.zeros((), dtype=torch.float32,
                                       device=x.device), losses={})


class MoeLayerBase(nn.Module):
    """Shared parameters and helpers: gate in -> E without bias; experts
    Linear(in, h) -> act -> Linear(h, out)."""

    def __init__(self, in_dim: int, out_dim: int, n_experts: int = 4,
                 n_selected: int = 2, args: MoEArgs = MoEArgs(),
                 impl: str = "auto", gate_bias: bool = False,
                 expert_hidden_dim: Optional[int] = None,
                 expert_act: str = "gelu", *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if gate_bias:
            raise NotImplementedError("gate_bias is not ported")
        if expert_act not in _ACTIVATIONS:
            raise ValueError(f"unknown expert_act {expert_act!r}")
        self.in_dim, self.out_dim = in_dim, out_dim
        self.n_experts, self.n_selected = n_experts, n_selected
        self.args, self.impl = args, impl
        self.act = _ACTIVATIONS[expert_act]
        h = expert_hidden_dim or out_dim
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.gate_kernel = nn.Parameter(torch.empty(in_dim, n_experts, **kw))
        self.experts_w1 = nn.Parameter(torch.empty(n_experts, in_dim, h, **kw))
        self.experts_b1 = nn.Parameter(torch.empty(n_experts, h, **kw))
        self.experts_w2 = nn.Parameter(torch.empty(n_experts, h, out_dim,
                                                   **kw))
        self.experts_b2 = nn.Parameter(torch.empty(n_experts, out_dim, **kw))

    def gate_logits(self, x):
        return x @ self.gate_kernel.to(x.dtype)

    def ffn(self, x3d, sel, weights):
        """Dispatch + combine over the selected experts. x3d: [B, N, D]."""
        b, n, d = x3d.shape
        out = ec.moe_ffn_mlp2(
            x3d.reshape(b * n, d), sel.reshape(b * n, -1),
            weights.reshape(b * n, -1).to(x3d.dtype), self.experts_w1,
            self.experts_b1, self.experts_w2, self.experts_b2,
            activation=self.act, impl=self.impl)
        return out.reshape(b, n, self.out_dim)

    def combine_loss(self, sel, gate_softmax, gate_logits):
        """balance * coef + z * coef."""
        balance = L.switch_balance_loss(gate_softmax, sel, self.n_experts)
        zl = L.z_loss(gate_logits)
        aux = (balance * self.args.balance_loss_coef
               + zl * self.args.router_z_loss_coef)
        return aux, balance, zl


@register_moe("smoe")
class SMoELayer(MoeLayerBase):
    """Vanilla top-k softmax gating with post-top-k renormalisation."""

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        logits = self.gate_logits(x)
        weights, sel, gate_softmax = R.topk_softmax(logits, self.n_selected)
        weights = R.normalize_weights(weights, x.dtype)
        out = self.ffn(x, sel, weights)
        aux = zero_aux(x)
        if train or return_id_experts:
            total, balance, zl = self.combine_loss(sel, gate_softmax, logits)
            aux = MoEAux(aux_loss=total,
                         losses={"balance_loss": balance.detach(),
                                 "router_z_loss": zl.detach()},
                         gate_softmax=gate_softmax.detach(),
                         selected_experts=sel)
        return out, aux


def competes_at(schedule, step_warm: int, step) -> bool:
    """Whether a layer with flip row `schedule` competes at global `step`:
    not in warm-up, not past the schedule's end, else its flip at
    step - step_warm. Decided on the host from a Python int step and the
    numpy row, so no device value is read."""
    rel = int(step) - step_warm
    return 0 <= rel < len(schedule) and bool(schedule[rel])


@register_moe("competesmoe")
class CompeteSMoELayer(MoeLayerBase):
    """CompeteSMoE. On a scheduled flip step in training, ALL experts run,
    each is scored by its response affinity mean(softplus(out)), the top-k
    of the affinity route the token, and the affinity distribution is
    distilled into the router (MSE); otherwise the learned router routes.

    `flip_schedule` is this layer's row of the numpy flip schedule
    (`moe.schedule.build_flip_schedule`) and `step_warm` its warm-up
    prefix; `flips` passed to forward overrides the row. The competition
    branch is recomputed in backward (torch.utils.checkpoint), as JAX
    rematerialises it, so the all-expert outputs do not stay alive."""

    def __init__(self, *args, flip_schedule=None, step_warm: int = 0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.flip_schedule = flip_schedule
        self.step_warm = step_warm

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        # the router's policy is always computed
        logits = self.gate_logits(x)
        gate_weights, gate_sel, gate_softmax = R.topk_softmax(
            logits, self.n_selected)
        gate_weights = R.normalize_weights(gate_weights, x.dtype)
        schedule = flips if flips is not None else self.flip_schedule
        if (train and step is not None and schedule is not None
                and competes_at(schedule, self.step_warm, step)):
            return self._competition_branch(x, gate_softmax, gate_sel)
        out = self.ffn(x, gate_sel, gate_weights)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if train or return_id_experts:
            total, balance, zl = self.combine_loss(gate_sel, gate_softmax,
                                                   logits)
        else:
            total = balance = zl = zero
        losses = {"balance_loss": balance.detach(),
                  "router_z_loss": zl.detach(), "routerloss": zero,
                  "diversity_loss": zero, "router_agreement": zero,
                  "is_comp": zero}
        return out, MoEAux(aux_loss=total, losses=losses,
                           gate_softmax=gate_softmax.detach(),
                           selected_experts=gate_sel)

    def _competition_branch(self, x, gate_softmax, gate_sel):
        out, total, comp = torch.utils.checkpoint.checkpoint(
            self._competition, x, gate_softmax, gate_sel,
            use_reentrant=False)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        losses = {"balance_loss": comp["balance_loss"],
                  "router_z_loss": zero,
                  "routerloss": comp["routerloss"],
                  "diversity_loss": comp["diversity_loss"],
                  "router_agreement": comp["router_agreement"],
                  "is_comp": torch.ones((), dtype=torch.float32,
                                        device=x.device)}
        return out, MoEAux(aux_loss=total, losses=losses,
                           gate_softmax=comp["affinity_softmax"],
                           selected_experts=comp["selected_experts"])

    def _competition(self, x, gate_softmax, gate_sel):
        """The all-expert competition policy: (output, coefficient-scaled
        aux loss, detached components)."""
        b, n, d = x.shape
        k = self.n_selected
        affinity, topk_outputs, sel = ec.competition_all_experts_mlp2(
            x.reshape(b * n, d), self.experts_w1, self.experts_b1,
            self.experts_w2, self.experts_b2, self.act, k, impl=self.impl)
        affinity = affinity.reshape(b, n, self.n_experts)
        topk_outputs = topk_outputs.reshape(b, n, k, self.out_dim)
        sel = sel.reshape(b, n, k)
        affinity_softmax = R.softmax_f32(affinity)
        # sigmoid is monotone: sel (top-k of the raw affinity) stands;
        # only the combine weights pass through it
        scores = R.sigmoid(affinity) if self.args.norm_sigmoid else affinity
        aw = R.normalize_weights(torch.gather(scores, -1, sel), x.dtype)
        out = torch.sum(topk_outputs * aw[..., None].to(topk_outputs.dtype),
                        dim=-2)
        aff_sg = affinity_softmax.detach()
        routerloss = L.router_mse_loss(gate_softmax, aff_sg)
        if self.args.hybrid:
            routerloss = routerloss + L.router_mse_loss(
                torch.gather(gate_softmax, -1, sel),
                torch.gather(aff_sg, -1, sel)) * self.args.router_theta
        div = L.diversity_loss(topk_outputs)
        balance = L.switch_balance_loss(affinity_softmax, sel,
                                        self.n_experts)
        total = (routerloss * self.args.router_loss_coef
                 + div * self.args.diversity_loss_coef
                 + balance * self.args.bal_comp_loss_coef)
        comp = {"balance_loss": balance.detach(),
                "routerloss": routerloss.detach(),
                "diversity_loss": div.detach(),
                "router_agreement": L.topk_agreement(gate_sel, sel).detach(),
                "affinity_softmax": aff_sg, "selected_experts": sel}
        return out, total, comp
