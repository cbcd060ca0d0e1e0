"""The multimodal MoE layers (port of competesmoe_tpu/moe/layers.py: all
eight routers of JAX's registry). Seven have 2-layer Linear/act/Linear
experts: SMoE, sigmoid gating, XMoE and perturbed cosine gating (a cosine
gate in a reduced space), the two shared-expert variants, and CompeteSMoE
with its competition step. The eighth, `mixtral`, is HF Mixtral's own
sparse block with SwiGLU experts, the MoE decoder's FFN.

Parameters keep the JAX layout and names, so `convert.from_jax_params`
carries them across as they are: the gate kernel is [in, E] (`gate_bias`
[E] with gate_bias=True, created and, as in JAX, read by no layer); the
experts are stacked tensors `experts_w1` [E, in, h], `experts_b1` [E, h],
`experts_w2` [E, h, out], `experts_b2` [E, out]; the cosine gate has
`inp_reduction` [in, E/2] and `expert_embeddings` [E, E/2] and no gate
kernel; the shared-expert gate is [in, E-1]; Mixtral's experts are
`experts_w1` / `experts_w3` [E, d, h] and `experts_w2` [E, h, d] without
biases. Layers return `(output, MoEAux)`. Constructors leave the weights
uninitialised, like `torch.empty`; fill them with
`models.builder.init_random_` or `load_state_dict`.
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
    Linear(in, h) -> act -> Linear(h, out). Subclasses with other
    parameters override `_gate_params` or `_expert_params`."""

    def __init__(self, in_dim: int, out_dim: int, n_experts: int = 4,
                 n_selected: int = 2, args: MoEArgs = MoEArgs(),
                 impl: str = "auto", gate_bias: bool = False,
                 expert_hidden_dim: Optional[int] = None,
                 expert_act: str = "gelu", *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if expert_act not in _ACTIVATIONS:
            raise ValueError(f"unknown expert_act {expert_act!r}")
        self.in_dim, self.out_dim = in_dim, out_dim
        self.n_experts, self.n_selected = n_experts, n_selected
        self.args, self.impl = args, impl
        self.act = _ACTIVATIONS[expert_act]
        self.hidden_dim = expert_hidden_dim or out_dim
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._gate_params(gate_bias, kw)
        self._expert_params(kw)

    def _gate_params(self, gate_bias: bool, kw) -> None:
        """`gate_kernel` [in, E], and with gate_bias a `gate_bias` [E]
        (zeros from `init_random_`) that no layer adds to its logits, as
        in JAX, whose layers call `gate_logits` without it."""
        self.gate_kernel = nn.Parameter(torch.empty(self.in_dim,
                                                    self.n_experts, **kw))
        self.gate_bias = (nn.Parameter(torch.empty(self.n_experts, **kw))
                          if gate_bias else None)

    def _expert_params(self, kw) -> None:
        e, h = self.n_experts, self.hidden_dim
        self.experts_w1 = nn.Parameter(torch.empty(e, self.in_dim, h, **kw))
        self.experts_b1 = nn.Parameter(torch.empty(e, h, **kw))
        self.experts_w2 = nn.Parameter(torch.empty(e, h, self.out_dim, **kw))
        self.experts_b2 = nn.Parameter(torch.empty(e, self.out_dim, **kw))

    def gate_logits(self, x):
        return x @ self.gate_kernel.to(x.dtype)

    def ffn(self, x3d, sel, weights, experts=None):
        """Dispatch + combine over the selected experts. x3d: [B, N, D];
        `experts`: (w1, b1, w2, b2), the layer's own when None."""
        w1, b1, w2, b2 = experts or (self.experts_w1, self.experts_b1,
                                     self.experts_w2, self.experts_b2)
        b, n, d = x3d.shape
        out = ec.moe_ffn_mlp2(
            x3d.reshape(b * n, d), sel.reshape(b * n, -1),
            weights.reshape(b * n, -1).to(x3d.dtype), w1, b1, w2, b2,
            activation=self.act, impl=self.impl)
        return out.reshape(b, n, self.out_dim)

    def combine_loss(self, sel, gate_softmax, gate_logits,
                     n_experts: Optional[int] = None):
        """balance * coef + z * coef, the balance over `n_experts` (the
        layer's when None)."""
        from ..parallel.distributed_ops import token_axis
        balance = L.switch_balance_loss(gate_softmax, sel,
                                        n_experts or self.n_experts,
                                        axis=token_axis())
        zl = L.z_loss(gate_logits)
        aux = (balance * self.args.balance_loss_coef
               + zl * self.args.router_z_loss_coef)
        return aux, balance, zl

    def routed_aux(self, x, sel, gate_softmax, logits, train: bool,
                   return_id_experts: bool,
                   n_experts: Optional[int] = None) -> MoEAux:
        """The aux of a learned router: balance and z-loss (detached
        components), the f32 routing distribution and the choices, in
        training or for telemetry; else zeros."""
        if not (train or return_id_experts):
            return zero_aux(x)
        total, balance, zl = self.combine_loss(sel, gate_softmax, logits,
                                               n_experts)
        return MoEAux(aux_loss=total,
                      losses={"balance_loss": balance.detach(),
                              "router_z_loss": zl.detach()},
                      gate_softmax=gate_softmax.detach().float(),
                      selected_experts=sel)


@register_moe("smoe")
class SMoELayer(MoeLayerBase):
    """Vanilla top-k softmax gating with post-top-k renormalisation."""

    route = staticmethod(R.topk_softmax)

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        logits = self.gate_logits(x)
        weights, sel, gate_softmax = self.route(logits, self.n_selected)
        weights = R.normalize_weights(weights, x.dtype)
        out = self.ffn(x, sel, weights)
        return out, self.routed_aux(x, sel, gate_softmax, logits, train,
                                    return_id_experts)


@register_moe("smoe_sigmoidgating")
class SMoESigmoidGating(SMoELayer):
    """Top-k over sigmoid(logits), renormalised; the f32 softmax is kept
    for the aux losses."""

    route = staticmethod(R.topk_sigmoid)


def softmax_stepwise(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` in x's dtype: exp(x - max) and its normalisation,
    each step rounded to that dtype (torch.softmax rounds once)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


@register_moe("xmoe")
class XMoELayer(MoeLayerBase):
    """XMoE: cosine-similarity routing in a reduced space. `inp_reduction`
    [in, E/2] projects x; `expert_embeddings` [E, E/2] are rescaled to
    norm 1.5 / (norm + theta), the scale without a gradient (the
    functional form of the reference's in-place renorm); softmax at
    temperature 0.3 in float32, rounded to x's dtype, top-k of it, softmax
    of the k in x's dtype. No gate kernel (and so no gate bias)."""

    theta = 0.0

    def _gate_params(self, gate_bias: bool, kw) -> None:
        red = self.n_experts // 2
        self.inp_reduction = nn.Parameter(torch.empty(self.in_dim, red,
                                                      **kw))
        self.expert_embeddings = nn.Parameter(torch.empty(self.n_experts,
                                                          red, **kw))

    def gate_logits(self, x):
        reduced = x @ self.inp_reduction.to(x.dtype)
        emb = self.expert_embeddings
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        emb_n = emb * (1.5 / (norm + self.theta)).detach()
        if self.theta > 0.0:
            # perturbed cosine: the input norm is offset by theta, in
            # float32, instead of clamped at eps
            xf = reduced.float()
            xn = xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
                       + self.theta)
            logits = (xn @ emb_n.float().t()).to(reduced.dtype)
        else:
            logits = R.cosine_logits(reduced, emb_n)
        return R.make_finite(logits)

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        logits = self.gate_logits(x)
        # the temperature is a weakly typed constant: taken in x's dtype
        t = torch.full((), self.args.xmoe_temperature, dtype=logits.dtype,
                       device=logits.device)
        gate_softmax = R.softmax_f32(logits / t).to(x.dtype)
        raw, sel = R.top_k(gate_softmax, self.n_selected)
        out = self.ffn(x, sel, softmax_stepwise(raw))
        return out, self.routed_aux(x, sel, gate_softmax, logits, train,
                                    return_id_experts)


@register_moe("smoe_perturbed")
class PerturbedCosineGating(XMoELayer):
    """Perturbed cosine gating: theta 0.1 in the input norm's and the
    embedding renorm's denominators."""

    theta = 0.1


@register_moe("smoe_share")
class SharedExpertV2(MoeLayerBase):
    """Expert E-1 is always on; the gate [in, E-1] routes top-(k-1) among
    the first E-1 (balance over E-1); the output is 0.5 x shared + 0.5 x
    routed, which keeps the sparse-upcycled output range."""

    def _gate_params(self, gate_bias: bool, kw) -> None:
        self.gate_kernel = nn.Parameter(torch.empty(
            self.in_dim, self.n_experts - 1, **kw))

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        n = self.n_experts - 1
        w1, b1, w2, b2 = (self.experts_w1, self.experts_b1, self.experts_w2,
                          self.experts_b2)
        logits = self.gate_logits(x)
        weights, sel, gate_softmax = R.topk_softmax(logits,
                                                    self.n_selected - 1)
        weights = R.normalize_weights(weights, x.dtype)
        routed = self.ffn(x, sel, weights, (w1[:n], b1[:n], w2[:n], b2[:n]))
        b, t, d = x.shape
        shared = ec.dense_all_experts_mlp2(
            x.reshape(b * t, d), w1[n:], b1[n:], w2[n:], b2[n:],
            activation=self.act).reshape(b, t, self.out_dim)
        out = self._combine(shared, routed)
        return out, self.routed_aux(x, sel, gate_softmax, logits, train,
                                    return_id_experts, n_experts=n)

    def _combine(self, shared, routed):
        return 0.5 * shared + 0.5 * routed


@register_moe("deepseekv3")
class SharedExpertV3(SharedExpertV2):
    """As smoe_share, with the additive combine shared + routed."""

    def _combine(self, shared, routed):
        return shared + routed


@register_moe("mixtral")
class MixtralMoELayer(MoeLayerBase):
    """HF Mixtral's sparse MoE block with the reference's forward: the
    checkpoint's gate and SwiGLU experts (w1 gate, w3 up, w2 down, no
    biases) kept as they are, top-k of the f32 softmax renormalised, the
    sorted grouped products of `expert_compute.moe_ffn_swiglu`, and a
    router z-loss plus a top-1 balance loss over the flattened tokens."""

    def _expert_params(self, kw) -> None:
        e, d, h = self.n_experts, self.in_dim, self.hidden_dim
        self.experts_w1 = nn.Parameter(torch.empty(e, d, h, **kw))
        self.experts_w3 = nn.Parameter(torch.empty(e, d, h, **kw))
        self.experts_w2 = nn.Parameter(torch.empty(e, h, self.out_dim, **kw))

    def forward(self, x, *, step=None, train: bool = False,
                return_id_experts: bool = False, flips=None):
        e, d = self.n_experts, self.in_dim
        logits = self.gate_logits(x)
        weights, sel, gate_softmax = R.topk_softmax(logits, self.n_selected)
        weights = R.normalize_weights(weights, x.dtype)
        b, n, _ = x.shape
        out = ec.moe_ffn_swiglu(
            x.reshape(b * n, d), sel.reshape(b * n, -1),
            weights.reshape(b * n, -1).to(x.dtype), self.experts_w1,
            self.experts_w3, self.experts_w2, impl=self.impl)
        out = out.reshape(b, n, self.out_dim)
        if not (train or return_id_experts):
            return out, zero_aux(x)
        # the reference flattens [B, N] before the density means, unlike
        # the tower's and projector's layers, which keep the batch dim: so
        # over several ranks they are the means of every rank's rows
        from ..parallel.distributed_ops import batch_axis
        balance = L.switch_balance_loss(gate_softmax.reshape(b * n, e),
                                        sel.reshape(b * n, -1), e,
                                        axis=batch_axis())
        zl = L.z_loss(logits)
        return out, MoEAux(
            aux_loss=(balance * self.args.balance_loss_coef
                      + zl * self.args.router_z_loss_coef),
            losses={"balance_loss": balance.detach(),
                    "router_z_loss": zl.detach()},
            gate_softmax=gate_softmax.detach(), selected_experts=sel)


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
