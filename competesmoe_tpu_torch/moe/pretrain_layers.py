"""The pretrain tree's MoE layers with MoEUT-style stacked keys/values
experts and ReLU activation (port of competesmoe_tpu/moe/pretrain_layers.py:
`MoEUTBase` and the seven routers `PretrainSMoE`, `PretrainSigmoidNorm`,
`PretrainXMoE`, `PretrainPerturbed`, `PretrainDeepSeekV2`,
`PretrainDeepSeekV3` and `PretrainCompeteSMoE`). Every router's experts
are relu keys/values without a bias, so `impl='fused'` takes K1 on the
card for all of them.

Parameters keep the JAX layout, which K1 reads as it is: `w_gate` [E, d],
`keys` [E, d, expert_size], `values` [E, expert_size, v] (plus `bias`
[E, expert_size] and `o_bias` [v] with `bias=True`); the cosine routers
add `expert_sel` [E/2, d] and `expert_embeddings` [E, E/2], the DeepSeek
ones the shared expert's `keys_shared` [1, d, es] and `values_shared`
[1, es, v] (and V3 `e_score_correction_bias` [E], declared and unused,
as in JAX). Layers return `(output, MoEAux)` with the JAX aux-loss key
names.

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

    def ffn(self, x3d, sel, weights, with_o_bias: bool = True):
        b, n, d = x3d.shape
        out = ec.moe_ffn_kv(
            x3d.reshape(b * n, d), sel.reshape(b * n, -1),
            weights.reshape(b * n, -1).to(x3d.dtype), self.keys, self.values,
            activation=self.activation, b1=self.bias, impl=self.impl)
        out = out.reshape(b, n, self.out_dim)
        if with_o_bias and self.o_bias is not None:
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


@register_pretrain_moe("smoe_sigmoid")
class PretrainSigmoidNorm(MoEUTBase):
    """MoEUT sigmoid selection: top-k over sigmoid(logits), normalized
    (ref smoeut_norm.py:36-150); `gate_softmax` of the aux is the
    sigmoid."""

    def route(self, x, logits):
        weights, sel, _ = R.topk_sigmoid(logits, self.topk)
        return (R.normalize_weights(weights, x.dtype), sel,
                R.sigmoid(logits))


class _PretrainCosineBase(MoEUTBase):
    """Cosine gate over a reduced projection (ref xmoe.py:37-155):
    `expert_sel` [E/2, d] projects x, `expert_embeddings` [E, E/2]
    (orthogonal at gain 0.32 when theta is 0, else N(0, 0.02)) are
    rescaled to norm 1.5 / (norm + theta) without a gradient through the
    scale; softmax at `temperature`, top-k, softmax of the k."""

    theta = 0.0
    temperature = 0.3

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        red = self.n_experts // 2
        kw = dict(device=self.keys.device, dtype=torch.float32)
        self.expert_sel = nn.Parameter(torch.empty(red, self.dmodel, **kw))
        self.expert_embeddings = nn.Parameter(
            torch.empty(self.n_experts, red, **kw))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        super().reset_parameters(g)
        t = self.expert_sel
        t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                * self.dmodel ** -0.5 * self.weight_scale)
        t = self.expert_embeddings
        if self.theta == 0.0:
            nn.init.orthogonal_(t, gain=0.32, generator=g)
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * 0.02)

    def compute_gate(self, x):
        reduced = x @ self.expert_sel.t().to(x.dtype)
        emb = self.expert_embeddings
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        emb_n = emb * (1.5 / (norm + self.theta)).detach()
        if self.theta > 0.0:
            xf = reduced.float()
            xn = xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
                       + self.theta)
            logits = (xn @ emb_n.float().t()).to(reduced.dtype)
        else:
            logits = R.cosine_logits(reduced, emb_n)
        return R.make_finite(logits)

    def route(self, x, logits):
        gate_softmax = R.softmax_f32(logits / self.temperature).to(x.dtype)
        raw, sel = R.top_k(gate_softmax, self.topk)
        weights = torch.softmax(raw.float(), dim=-1).to(x.dtype)
        return weights, sel, gate_softmax


@register_pretrain_moe("xmoe")
class PretrainXMoE(_PretrainCosineBase):
    """XMoE on CVMM-style experts (ref xmoe.py:37-226)."""


@register_pretrain_moe("smoe_perturbed")
class PretrainPerturbed(_PretrainCosineBase):
    """Perturbed cosine gating, theta=0.1 (ref smoe_perturbed.py:39-226)."""

    theta = 0.1


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in a's dtype with float32 accumulation: one bf16 matmul on
    the card (cuBLAS accumulates in float32), widened operands on the
    CPU."""
    if a.device.type == "cuda":
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


class _SharedExpertBase(MoEUTBase):
    """DeepSeek-style routed experts + an always-on shared expert
    (ref deepseekv2.py:38-181, deepseekv3.py:39-190): `keys_shared` [1, d,
    es] and `values_shared` [1, es, v], es = expert_size x
    n_shared_experts, computed as two dense bf16 products (JAX computes
    them outside Pallas)."""

    def __init__(self, *args, n_shared_experts: int = 1,
                 routed_scaling_factor: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_shared_experts = n_shared_experts
        self.routed_scaling_factor = routed_scaling_factor
        es = self.expert_size * n_shared_experts
        kw = dict(device=self.keys.device, dtype=torch.float32)
        self.keys_shared = nn.Parameter(torch.empty(1, self.dmodel, es, **kw))
        self.values_shared = nn.Parameter(torch.empty(1, es, self.out_dim,
                                                      **kw))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        super().reset_parameters(g)
        es = self.keys_shared.shape[-1]
        for t, std in ((self.keys_shared, self.dmodel ** -0.5),
                       (self.values_shared, es ** -0.5)):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * std * self.weight_scale)

    def _shared_out(self, x):
        h = torch.relu(_mm(x, self.keys_shared[0].to(x.dtype)))
        return _mm(h, self.values_shared[0].to(x.dtype))

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        logits = self.compute_gate(x)
        weights, sel, gate_softmax = self.route(x, logits)
        out = self.ffn(x, sel, weights, with_o_bias=False)
        out = out + self._shared_out(x)
        if self.o_bias is not None:
            out = out + self.o_bias.to(out.dtype)
        aux = zero_aux(x)
        if train:
            bal = self._ebalance(logits, train)
            aux = MoEAux(aux_loss=bal, losses={"mlp_ebalance": bal.detach()})
        if return_id_experts:
            aux.gate_softmax = gate_softmax.detach()
            aux.selected_experts = sel
        return out, aux


@register_pretrain_moe("deepseekv2")
class PretrainDeepSeekV2(_SharedExpertBase):
    """Top-k over raw logits, softmax-over-top-k weights, + shared expert
    (ref deepseekv2.py:147-181)."""

    def route(self, x, logits):
        weights, sel, gate_softmax = R.topk_logits_softmax_weights(
            logits, self.topk)
        return weights.to(x.dtype), sel, gate_softmax


@register_pretrain_moe("deepseekv3")
class PretrainDeepSeekV3(_SharedExpertBase):
    """Sigmoid scoring, normalized with a +1e-20 denominator, scaled by
    routed_scaling_factor, + shared expert (ref deepseekv3.py:142-190).
    `e_score_correction_bias` [E] is declared for checkpoint parity and,
    as in the reference's forward, not applied."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.e_score_correction_bias = nn.Parameter(torch.empty(
            self.n_experts, device=self.keys.device, dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        super().reset_parameters(g)
        self.e_score_correction_bias.zero_()

    def route(self, x, logits):
        weights, sel = R.top_k(R.sigmoid(logits), self.topk)
        denom = weights.sum(dim=-1, keepdim=True) + 1e-20
        weights = weights / denom * self.routed_scaling_factor
        return weights, sel, R.softmax_f32(logits)


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
