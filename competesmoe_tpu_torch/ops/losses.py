"""Auxiliary MoE routing losses (port of competesmoe_tpu/ops/losses.py).

JAX computes each over the global batch. Over several ranks, a statistic
whose reduced dim spans rows of the batch held by other ranks reduces
across them before its nonlinearity (`parallel/distributed_ops.py` says
which do); the others are per row or per token, and a rank's share of
them is exact.

Serving needs these too: prefill asks for routing telemetry
(`return_id_experts=True`), which runs the layers' `combine_loss`. The
pretrain routers use the entropy balance, and CompeteSMoE's competition
step the diversity and router-distillation losses.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def z_loss(gate_logits: torch.Tensor) -> torch.Tensor:
    """Router z-loss: mean(logsumexp(logits, -1)^2)."""
    z = torch.logsumexp(gate_logits.float(), dim=-1)
    return torch.mean(z * z)


def switch_balance_loss(gate_softmax: torch.Tensor,
                        selected_experts: torch.Tensor,
                        n_experts: int, axis=None) -> torch.Tensor:
    """Switch-style balance loss over the FIRST selected expert only:
    mean(mean_tokens(softmax) * mean_tokens(one_hot(top1))) * E^2. `axis`:
    when the token dim holds rows of the batch that other ranks share
    (`parallel.distributed_ops`), the two means run over every rank's
    tokens before their product."""
    from ..parallel.distributed_ops import mean_over_batch
    density_proxy = mean_over_batch(gate_softmax.float(), -2, axis)
    one_hot = F.one_hot(selected_experts[..., 0].long(), n_experts).float()
    density = mean_over_batch(one_hot, -2, axis)
    return torch.mean(density_proxy * density) * float(n_experts ** 2)


def topk_agreement(sel_router: torch.Tensor,
                   sel_affinity: torch.Tensor) -> torch.Tensor:
    """Mean per-token overlap |router top-k ∩ affinity top-k| / k."""
    m = (sel_router[..., :, None] == sel_affinity[..., None, :]).any(dim=-1)
    return m.float().mean()


def entropy_from_logprobs(logp: torch.Tensor) -> torch.Tensor:
    """-(l * exp(l)).sum(-1)."""
    return -torch.sum(logp * torch.exp(logp), dim=-1)


def entropy(probs: torch.Tensor, eps: Optional[float] = None
            ) -> torch.Tensor:
    """-(p * log(max(p, eps))).sum(-1); eps defaults to the dtype's
    machine epsilon."""
    if eps is None:
        eps = float(torch.finfo(probs.dtype).eps)
    return -torch.sum(torch.log(torch.clamp(probs, min=eps)) * probs,
                      dim=-1)


def log_mean(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """log(mean(exp(x))) along `dim` in float32."""
    x = x.float()
    return torch.logsumexp(x, dim=dim) - math.log(x.shape[dim])


def entropy_balance_loss(gate_logits: torch.Tensor) -> torch.Tensor:
    """MoEUT entropy balance over [..., T, E] logits: minus the mean
    entropy of the token-averaged routing distribution (the token average
    over every rank of `distributed_ops.token_axis()` when the sequence is
    split)."""
    from ..parallel import distributed_ops
    logp = torch.log_softmax(gate_logits.float(), dim=-1)
    return -torch.mean(entropy_from_logprobs(distributed_ops.log_mean(
        logp, dim=-2, axis=distributed_ops.token_axis())))


def diversity_loss(topk_expert_outputs: torch.Tensor) -> torch.Tensor:
    """Mean pairwise cosine similarity of the top-k experts' outputs
    [..., K, D], the diagonal zeroed but kept in the mean's K*K
    denominator (as the reference does)."""
    x = topk_expert_outputs.float()
    k = x.shape[-2]
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                         min=1e-12)
    sim = torch.einsum("...kd,...jd->...kj", xn, xn)
    sim = sim * (1.0 - torch.eye(k, dtype=sim.dtype, device=sim.device))
    return torch.mean(sim)


def router_mse_loss(gate_softmax: torch.Tensor,
                    affinity_softmax: torch.Tensor) -> torch.Tensor:
    """Router-distillation MSE between the gate and the (detached by the
    caller) affinity distributions, in float32."""
    d = gate_softmax.float() - affinity_softmax.float()
    return torch.mean(d * d)
