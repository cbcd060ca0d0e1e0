"""Auxiliary MoE routing losses (port of competesmoe_tpu/ops/losses.py).

Serving needs these too: prefill asks for routing telemetry
(`return_id_experts=True`), which runs the layers' `combine_loss`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def z_loss(gate_logits: torch.Tensor) -> torch.Tensor:
    """Router z-loss: mean(logsumexp(logits, -1)^2)."""
    z = torch.logsumexp(gate_logits.float(), dim=-1)
    return torch.mean(z * z)


def switch_balance_loss(gate_softmax: torch.Tensor,
                        selected_experts: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Switch-style balance loss over the FIRST selected expert only:
    mean(mean_tokens(softmax) * mean_tokens(one_hot(top1))) * E^2."""
    density_proxy = gate_softmax.float().mean(dim=-2)
    one_hot = F.one_hot(selected_experts[..., 0].long(), n_experts).float()
    density = one_hot.mean(dim=-2)
    return torch.mean(density_proxy * density) * float(n_experts ** 2)


def topk_agreement(sel_router: torch.Tensor,
                   sel_affinity: torch.Tensor) -> torch.Tensor:
    """Mean per-token overlap |router top-k ∩ affinity top-k| / k."""
    m = (sel_router[..., :, None] == sel_affinity[..., None, :]).any(dim=-1)
    return m.float().mean()
