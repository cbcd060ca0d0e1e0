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


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * (out * (1 - out))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA computes it: 1 / (1 + exp(-x)), each step
    rounded to x's dtype (torch.sigmoid rounds once, and differs by a
    bf16 ulp on about a third of bf16 inputs, enough to flip a top-k
    tie); its gradient g * s * (1 - s) in that dtype, as JAX's rule."""
    return _Sigmoid.apply(x)


def topk_sigmoid(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoEUT-style gating: top-k over sigmoid(logits) in the logits' dtype;
    the f32 softmax is still returned for aux losses. Returns (weights,
    selected_experts, gate_softmax)."""
    gate_softmax = softmax_f32(logits)
    weights, selected = top_k(sigmoid(logits), k)
    return weights, selected, gate_softmax


def topk_logits_softmax_weights(logits: torch.Tensor, k: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """DeepSeek-V2-style: top-k over the raw logits, weights = the f32
    softmax over the k selected logits. Returns (weights,
    selected_experts, gate_softmax)."""
    gate_softmax = softmax_f32(logits)
    raw, selected = top_k(logits, k)
    return torch.softmax(raw.float(), dim=-1), selected, gate_softmax


def cosine_logits(x_reduced: torch.Tensor, expert_embeddings: torch.Tensor,
                  eps: float = 1e-4) -> torch.Tensor:
    """XMoE cosine-similarity logits: the projected inputs normalised in
    float32 (norm clamped below at `eps`) against the (already
    renormalised) expert embeddings, cast back to the inputs' dtype."""
    xf = x_reduced.float()
    norm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    xn = xf / torch.clamp(norm, min=eps)
    return (xn @ expert_embeddings.float().t()).to(x_reduced.dtype)


def make_finite(scores: torch.Tensor) -> torch.Tensor:
    """Non-finite scores replaced by their row's smallest finite score (a
    row with none: 0). Per row, as in JAX, so that one token's NaN cannot
    change another token's routing."""
    ok = torch.isfinite(scores)
    inf = torch.full_like(scores, float("inf"))
    min_ok = torch.amin(torch.where(ok, scores, inf), dim=-1, keepdim=True)
    min_ok = torch.where(torch.isfinite(min_ok), min_ok,
                         torch.zeros_like(min_ok))
    return torch.where(ok, scores, min_ok)
