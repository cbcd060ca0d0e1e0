"""The pretrain tree's MoE layers with MoEUT-style stacked keys/values
experts and ReLU activation (port of competesmoe_tpu/moe/pretrain_layers.py:
`MoEUTBase`, `PretrainSMoE` and `PretrainCompeteSMoE`).

Parameters keep the JAX layout, which K1 reads as it is: `w_gate` [E, d],
`keys` [E, d, expert_size], `values` [E, expert_size, v] (plus `bias`
[E, expert_size] and `o_bias` [v] with `bias=True`). Layers return
`(output, MoEAux)` with the JAX aux-loss key names.

CompeteSMoE's competition step: JAX picks the branch with a `lax.cond` on
the flip schedule inside the compiled step. Here the schedule is host data,
so the branch is a plain `if` on a Python bool per (layer, step), and the
competition branch runs under `torch.utils.checkpoint` (JAX remats it): its
all-expert outputs, E/k times the sparse activations, are recomputed in
the backward instead of being kept.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import expert_compute as ec
from ..ops import losses as L
from ..ops import routing as R
from .config import MoEArgs
from .layers import MoEAux, zero_aux
from .registry import register_pretrain_moe


class MoEUTBase(nn.Module):
    """Base MoE with stacked expert tensors (ref layers/moe/moe.py:35-454).

    keys:   [E, d, expert_size]   init N(0, d^-0.5 * weight_scale)
    values: [E, expert_size, v]   init N(0, (E*expert_size)^-0.5 * weight_scale)
    w_gate: [E, d]                init N(0, d^-0.5 * weight_scale)
    top-k = n_heads ("pkm heads"). Built uninitialised on `device` (cuda
    unless asked otherwise); `reset_parameters(generator)` draws the JAX
    init distributions.
    """

    div = 1.0

    def __init__(self, dmodel: int, n_experts: int, expert_size: int,
                 n_heads: int, args: MoEArgs = MoEArgs(),
                 v_dim: Optional[int] = None, weight_scale: float = 1.0,
                 bias: bool = False, impl: str = "auto", *, device=None):
        super().__init__()
        self.dmodel, self.n_experts = dmodel, n_experts
        self.expert_size, self.n_heads = expert_size, n_heads
        self.args, self.weight_scale, self.impl = args, weight_scale, impl
        self.out_dim = v_dim if v_dim is not None else dmodel
        kw = dict(device=resolve_device(device), dtype=torch.float32)
        self.w_gate = nn.Parameter(torch.empty(n_experts, dmodel, **kw))
        self.keys = nn.Parameter(torch.empty(n_experts, dmodel, expert_size,
                                             **kw))
        self.values = nn.Parameter(torch.empty(n_experts, expert_size,
                                               self.out_dim, **kw))
        self.bias = self.o_bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(n_experts, expert_size,
                                                 **kw))
            self.o_bias = nn.Parameter(torch.empty(self.out_dim, **kw))

    @property
    def topk(self) -> int:
        return self.n_heads

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        d, e = self.dmodel, self.expert_size
        s = self.weight_scale
        for t, std in ((self.w_gate, d ** -0.5 * s), (self.keys, d ** -0.5 * s),
                       (self.values, (self.n_experts * e) ** -0.5 * s)):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device) * std)
        for t in (self.bias, self.o_bias):
            if t is not None:
                t.zero_()

    # torch.relu itself, so that `fused_path_available`'s identity check
    # passes and impl='fused' reaches K1. JAX's MoEUTBase wraps jax.nn.relu
    # in a function of its own, which fails the same check, so there
    # impl='fused' silently takes ragged_dot (ROADMAP section 3).
    activation = staticmethod(torch.relu)

    def compute_gate(self, x):
        return x @ self.w_gate.t().to(x.dtype)

    def route(self, x, logits):
        """f32 softmax -> top-k -> normalize (moe.py:373-393,418-424)."""
        weights, sel, gate_softmax = R.topk_softmax(logits, self.topk)
        return R.normalize_weights(weights, x.dtype), sel, gate_softmax

    def ffn(self, x3d, sel, weights):
        b, n, d = x3d.shape
        out = ec.moe_ffn_kv(
            x3d.reshape(b * n, d), sel.reshape(b * n, -1),
            weights.reshape(b * n, -1).to(x3d.dtype), self.keys, self.values,
            activation=self.activation, b1=self.bias, impl=self.impl)
        out = out.reshape(b, n, self.out_dim)
        if self.o_bias is not None:
            out = out + self.o_bias.to(out.dtype)
        return out

    def _ebalance(self, logits, train: bool) -> torch.Tensor:
        """mlp_ebalance reg: entropy balance * coef / div (moe.py:443-445)."""
        if not train:
            return torch.zeros((), dtype=torch.float32, device=logits.device)
        return L.entropy_balance_loss(logits) * (
            self.args.balance_loss_coef / self.div)

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        logits = self.compute_gate(x)
        weights, sel, gate_softmax = self.route(x, logits)
        out = self.ffn(x, sel, weights)
        aux = zero_aux(x)
        if train:
            bal = self._ebalance(logits, train)
            aux = MoEAux(aux_loss=bal, losses={"mlp_ebalance": bal.detach()})
        if return_id_experts:
            aux.gate_softmax = gate_softmax.detach()
            aux.selected_experts = sel
        return out, aux


@register_pretrain_moe("smoe")
class PretrainSMoE(MoEUTBase):
    """Vanilla softmax top-k on CVMM-style experts (ref smoe.py:38-264)."""


@register_pretrain_moe("competesmoe")
class PretrainCompeteSMoE(MoEUTBase):
    """CompeteSMoE on stacked keys/values experts
    (ref layers/moe/competesmoe.py:37-616). On a flip step the layer runs
    all experts, routes by their affinity and distils that routing into
    the gate; elsewhere it is the learned router."""

    def __init__(self, *args, flip_schedule: Optional[np.ndarray] = None,
                 step_warm: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.flip_schedule = flip_schedule
        self.step_warm = step_warm

    def compute_gate(self, x):
        """Optional cosine / norm-weight gate normalization
        (competesmoe.py:456-464)."""
        self.args.validate()
        w = self.w_gate
        if self.args.is_cosine or self.args.is_norm_weight:
            w = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                         keepdim=True),
                                min=1e-12)
        if self.args.is_cosine:
            x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                         keepdim=True),
                                min=1e-12)
        return x @ w.t().to(x.dtype)

    def route(self, x, logits):
        """router_policy (competesmoe.py:465-490)."""
        if self.args.norm_sigmoid:
            gate_softmax = R.softmax_f32(logits)
            raw, sel = R.top_k(logits, self.topk)
            weights = torch.sigmoid(raw / self.args.scale_weight)
        else:
            weights, sel, gate_softmax = R.topk_softmax(logits, self.topk)
        return R.normalize_weights(weights, x.dtype), sel, gate_softmax

    def is_comp(self, step, flips=None) -> bool:
        """Does this layer compete at global `step`? A host-side read of
        the numpy schedule; never during warm-up or past its end."""
        schedule = flips if flips is not None else self.flip_schedule
        if schedule is None or step is None:
            return False
        rel = int(step) - self.step_warm
        return 0 <= rel < len(schedule) and bool(schedule[rel])

    def _router_branch(self, x, logits, gate_weights, gate_sel, gate_softmax,
                       train: bool):
        out = self.ffn(x, gate_sel, gate_weights)
        bal = self._ebalance(logits, train)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        losses = {"mlp_ebalance": bal.detach(), "mlp_router_loss": zero,
                  "mlp_comp_diver_loss": zero, "mlp_comp_ebalance": zero,
                  "mlp_router_agreement": zero, "mlp_is_comp": zero}
        return out, MoEAux(aux_loss=bal, losses=losses,
                           gate_softmax=gate_softmax.detach(),
                           selected_experts=gate_sel)

    def _competition(self, x, gate_softmax, gate_sel):
        """The competition step (competesmoe.py:546-593): all experts run,
        the affinity routes, and the router is distilled towards it."""
        a = self.args
        b, n, d = x.shape
        k = self.topk
        affinity, topk_outputs, sel = ec.competition_all_experts_kv(
            x.reshape(b * n, d), self.keys, self.values, self.activation, k,
            b1=self.bias, impl=self.impl)
        affinity = affinity.reshape(b, n, self.n_experts)
        topk_outputs = topk_outputs.reshape(b, n, k, self.out_dim)
        sel = sel.reshape(b, n, k)
        affinity_softmax = R.softmax_f32(affinity)
        aw = R.normalize_weights(torch.gather(affinity, -1, sel), x.dtype)
        out = torch.sum(topk_outputs * aw[..., None].to(topk_outputs.dtype),
                        dim=-2)
        if self.o_bias is not None:
            out = out + self.o_bias.to(out.dtype)

        div_loss = L.diversity_loss(topk_outputs)
        aff_sg = affinity_softmax.detach()
        if a.in_topk or a.hybrid or a.tribrid:
            in_topk = L.router_mse_loss(torch.gather(gate_softmax, -1, sel),
                                        torch.gather(aff_sg, -1, sel))
        if a.in_topk:
            router_loss = in_topk
        elif a.hybrid or a.tribrid:
            router_loss = (L.router_mse_loss(gate_softmax, aff_sg)
                           + in_topk * a.router_theta)
            if a.tribrid:
                router_loss = router_loss + L.router_mse_loss(
                    torch.gather(gate_softmax, -1, gate_sel),
                    torch.gather(aff_sg, -1, gate_sel)) * a.router_theta
        else:
            router_loss = L.router_mse_loss(gate_softmax, aff_sg)
        total = (router_loss * a.router_loss_coef
                 + div_loss * a.balance_loss_coef_comp / 2)
        comp_ebal = torch.zeros((), dtype=torch.float32, device=x.device)
        if a.balance_affinity:
            # the reference passes the softmaxed affinity through the
            # entropy balance (which log-softmaxes again): replicated
            comp_ebal = L.entropy_balance_loss(affinity_softmax) * (
                a.balance_loss_coef_comp / 2)
            total = total + comp_ebal
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        losses = {
            "mlp_ebalance": zero,
            "mlp_router_loss": (router_loss * a.router_loss_coef).detach(),
            "mlp_comp_diver_loss": (div_loss * a.balance_loss_coef_comp
                                    / 2).detach(),
            "mlp_comp_ebalance": comp_ebal.detach(),
            # distillation health: does the router's top-k match the
            # competition outcome on this flip step?
            "mlp_router_agreement": L.topk_agreement(gate_sel, sel).detach(),
            "mlp_is_comp": torch.ones((), dtype=torch.float32,
                                      device=x.device),
        }
        return out, MoEAux(aux_loss=total, losses=losses,
                           gate_softmax=aff_sg, selected_experts=sel)

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        logits = self.compute_gate(x)
        gate_weights, gate_sel, gate_softmax = self.route(x, logits)
        if not (train and self.is_comp(step, flips)):
            return self._router_branch(x, logits, gate_weights, gate_sel,
                                       gate_softmax, train)
        return checkpoint(self._competition, x, gate_softmax, gate_sel,
                          use_reentrant=False)
