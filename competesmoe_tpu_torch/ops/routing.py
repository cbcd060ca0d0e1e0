"""Top-k routing primitives (port of competesmoe_tpu/ops/routing.py).

`torch.topk` leaves the order of tied values unspecified, while
`jax.lax.top_k` breaks ties toward the lower index. Ties are common with
bf16 logits, so `top_k` here is a stable descending sort: equal scores
keep their index order, which is the JAX order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis: values sorted descending, ties broken
    toward the lower index (jax.lax.top_k semantics)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis computed in float32 (stays float32)."""
    return torch.softmax(logits.float(), dim=-1)


def normalize_weights(weights: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`w / w.sum(-1, keepdim=True)`; with `dtype` the denominator is cast
    first (the reference's `torch.sum(...).to(x.dtype)`)."""
    denom = weights.sum(dim=-1, keepdim=True)
    if dtype is not None:
        denom = denom.to(dtype)
    return weights / denom


def topk_softmax(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standard SMoE gating: f32 softmax then top-k of the probabilities.
    Returns (weights, selected_experts, gate_softmax)."""
    gate_softmax = softmax_f32(logits)
    weights, selected = top_k(gate_softmax, k)
    return weights, selected, gate_softmax
