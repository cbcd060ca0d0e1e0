"""Expert computation (port of the single-device part of
competesmoe_tpu/ops/expert_compute.py): 2-layer Linear/act/Linear experts
(the multimodal tree) and MoEUT-style stacked keys/values experts (the
pretrain tree).

Paths, picked exactly as in JAX: compute ALL experts densely and gather
the top-k when E <= 2k, else sort the token slots by expert and run one
GEMM per expert over its contiguous slice; for keys/values experts on
CUDA tensors, `impl='fused'` takes the K1 pipeline of `gmm_fused.py` or
raises where JAX's rule refuses the experts. Contractions accumulate in float32 and cast back to the input
dtype, as JAX's `preferred_element_type=float32` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The default activation, as `jax.nn.gelu`'s default (tanh form)."""
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class GroupedSel:
    """Sorted dispatch metadata.

    perm:        [T*k] slot permutation such that sel.ravel()[perm] is sorted
    inv_perm:    [T*k] rank of each slot in sorted order
    token_ids:   [T*k] source row in x for each sorted slot (= perm // k)
    sel_sorted:  [T*k] expert id of each sorted slot
    group_sizes: [E]   slots assigned to each expert
    """

    perm: torch.Tensor
    inv_perm: torch.Tensor
    token_ids: torch.Tensor
    sel_sorted: torch.Tensor
    group_sizes: torch.Tensor


def sort_by_expert(sel: torch.Tensor, n_experts: int) -> GroupedSel:
    """Grouped-dispatch metadata from a top-k selection [..., k], with
    stable-sort semantics (equal expert ids keep slot order)."""
    k = sel.shape[-1]
    sel_flat = sel.reshape(-1).long()
    perm = torch.argsort(sel_flat, stable=True)
    # counted by a scatter-add, not torch.bincount, whose CUDA version
    # reads the largest id back to the host
    sizes = torch.zeros(n_experts, dtype=torch.int64, device=sel.device)
    sizes.index_add_(0, sel_flat, torch.ones_like(sel_flat))
    return GroupedSel(perm=perm, inv_perm=torch.argsort(perm),
                      token_ids=perm // k, sel_sorted=sel_flat[perm],
                      group_sizes=sizes)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation, output in a.dtype, b rounded to
    a.dtype first: JAX's `_ragged_dot` (bf16 activations against f32
    weights, output in the activations' dtype), as XLA computes it."""
    return torch.matmul(a.float(), b.to(a.dtype).float()).to(a.dtype)


def combine_topk(expert_outputs: torch.Tensor, sel: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """[T, E, v], [T, k], [T, k] -> [T, v] weighted sum of the selected
    experts' outputs."""
    gathered = gather_topk_outputs(expert_outputs, sel)
    return torch.sum(gathered * weights[..., None].to(expert_outputs.dtype),
                     dim=-2)


def gather_topk_outputs(expert_outputs: torch.Tensor,
                        sel: torch.Tensor) -> torch.Tensor:
    """[T, E, v], [T, k] -> [T, k, v]."""
    idx = sel.long()[..., None].expand(*sel.shape, expert_outputs.shape[-1])
    return torch.gather(expert_outputs, -2, idx)


def dense_all_experts_mlp2(x: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor,
                           activation: Activation = gelu_tanh) -> torch.Tensor:
    """Run ALL experts on every token.
    x: [T, d]; w1: [E, d, h]; b1: [E, h]; w2: [E, h, v]; b2: [E, v]
    -> [T, E, v]"""
    h = torch.einsum("td,edh->teh", x.float(), w1.float()).to(x.dtype)
    h = activation(h + b1[None].to(h.dtype))
    out = torch.einsum("teh,ehv->tev", h.float(), w2.float()).to(x.dtype)
    return out + b2[None].to(out.dtype)


def grouped_ffn_mlp2(x: torch.Tensor, sel: torch.Tensor,
                     weights: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     activation: Activation = gelu_tanh) -> torch.Tensor:
    """Sparse MoE FFN: sort slots by expert, one GEMM pair per expert over
    its contiguous slice, then an inverse-permutation gather and a
    weighted per-token reduce. x: [T, d]; sel/weights: [T, k] -> [T, v]."""
    T, k = sel.shape
    gs = sort_by_expert(sel, w1.shape[0])
    xs = x[gs.token_ids]
    o = torch.empty((xs.shape[0], w2.shape[-1]), dtype=x.dtype,
                    device=x.device)
    start = 0
    for e, size in enumerate(gs.group_sizes.tolist()):
        if size:
            rows = slice(start, start + size)
            h = activation(_mm_f32(xs[rows], w1[e]) + b1[e].to(x.dtype))
            o[rows] = _mm_f32(h, w2[e]) + b2[e].to(x.dtype)
        start += size
    o = o[gs.inv_perm].reshape(T, k, -1)
    out = torch.einsum("tkv,tk->tv", o.float(), weights.to(o.dtype).float())
    return out.to(x.dtype)


def moe_ffn_mlp2(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, activation: Activation = gelu_tanh,
                 impl: str = "auto") -> torch.Tensor:
    """MoE FFN dispatcher: impl 'auto' | 'dense' | 'grouped'. 'auto'
    computes all experts densely when E <= 2k, else takes the grouped
    path (competesmoe_tpu/ops/expert_compute.py:344-350)."""
    if impl == "auto":
        impl = "dense" if w1.shape[0] <= 2 * sel.shape[-1] else "grouped"
    if impl == "dense":
        outs = dense_all_experts_mlp2(x, w1, b1, w2, b2, activation)
        return combine_topk(outs, sel, weights)
    if impl == "grouped":
        return grouped_ffn_mlp2(x, sel, weights, w1, b1, w2, b2, activation)
    raise NotImplementedError(
        f"impl={impl!r} is not ported (the expert-parallel 'ep' path waits "
        "for the parallelism slice)")


# ---------------------------------------------------------------------------
# Keys/values experts (the pretrain tree)
# ---------------------------------------------------------------------------

def dense_all_experts_kv(x: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor, activation: Activation,
                         b1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run ALL experts on every token. x: [T, d]; keys: [E, d, e];
    values: [E, e, v] -> [T, E, v]. h is rounded to x's dtype before the
    bias and the activation, as in JAX."""
    h = torch.einsum("td,edh->teh", x.float(), keys.float()).to(x.dtype)
    if b1 is not None:
        h = h + b1[None].to(h.dtype)
    h = activation(h)
    out = torch.einsum("teh,ehv->tev", h.float(), values.float())
    return out.to(x.dtype)


def grouped_ffn_kv(x: torch.Tensor, sel: torch.Tensor,
                   weights: torch.Tensor, keys: torch.Tensor,
                   values: torch.Tensor, activation: Activation,
                   b1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse MoE FFN with stacked keys/values: sort the slots by expert,
    one GEMM pair per expert over its contiguous slice (h rounded to x's
    dtype, as ragged_dot's output), then an inverse-permutation gather and
    a weighted per-token reduce. x: [T, d]; sel/weights: [T, k] -> [T, v].
    Differentiable."""
    T, k = sel.shape
    gs = sort_by_expert(sel, keys.shape[0])
    sizes = gs.group_sizes.tolist()
    # torch.split, not slicing: its backward is one concatenation, where
    # each slice's backward would write a full-size zero gradient
    parts = []
    for e, xe in enumerate(x[gs.token_ids].split(sizes)):
        if sizes[e]:
            h = _mm_f32(xe, keys[e])
            if b1 is not None:
                h = h + b1[e].to(h.dtype)
            parts.append(_mm_f32(activation(h), values[e]))
    o = torch.cat(parts)[gs.inv_perm].reshape(T, k, -1)
    out = torch.einsum("tkv,tk->tv", o.float(), weights.to(o.dtype).float())
    return out.to(x.dtype)


def moe_ffn_kv(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
               keys: torch.Tensor, values: torch.Tensor,
               activation: Activation, b1: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
    """MoE FFN dispatcher (keys/values experts): impl 'auto' | 'dense' |
    'grouped' | 'fused' (competesmoe_tpu/ops/expert_compute.py:275-311).
    'fused' on CUDA tensors runs K1 (`gmm_fused.fused_grouped_ffn_kv`),
    and raises NotImplementedError with the reason where JAX's rule
    (`gmm_fused.fused_path_refusal`) refuses the experts; on CPU tensors
    it takes 'grouped', as JAX does off the TPU. 'auto' is dense when
    E <= 2k, else grouped."""
    if impl == "ep":
        raise NotImplementedError(
            "impl='ep' (expert-parallel all-to-all) is not ported: ROADMAP "
            "open item 1.7, parallelism")
    if impl == "fused" and x.device.type == "cuda":
        from .gmm_fused import fused_grouped_ffn_kv, fused_path_refusal
        why = fused_path_refusal(x, keys, activation, b1)
        if why is not None:
            raise NotImplementedError(
                f"impl='fused' cannot run K1 here: {why}; use impl "
                f"'grouped' or 'dense'")
        return fused_grouped_ffn_kv(x, sel, weights, keys, values)
    if impl == "fused":
        impl = "grouped"
    if impl == "auto":
        impl = "dense" if keys.shape[0] <= 2 * sel.shape[-1] else "grouped"
    if impl == "dense":
        outs = dense_all_experts_kv(x, keys, values, activation, b1=b1)
        return combine_topk(outs, sel, weights)
    if impl == "grouped":
        return grouped_ffn_kv(x, sel, weights, keys, values, activation,
                              b1=b1)
    raise ValueError(f"unknown impl {impl!r}")


def competition_all_experts_kv(x: torch.Tensor, keys: torch.Tensor,
                               values: torch.Tensor, activation: Activation,
                               topk: int, b1: Optional[torch.Tensor] = None,
                               impl: str = "auto"):
    """CompeteSMoE competition step: x [T, d] -> (affinity [T, E],
    topk_outputs [T, k, v], sel [T, k]). affinity = mean(softplus(expert
    output)) per expert; sel = top-k of the affinity, ties toward the
    lower index."""
    if impl == "ep":
        raise NotImplementedError(
            "impl='ep' (expert-parallel competition) is not ported: "
            "ROADMAP open item 1.7, parallelism")
    from .routing import top_k
    outs = dense_all_experts_kv(x, keys, values, activation, b1=b1)
    affinity = F.softplus(outs).mean(dim=-1)
    _, sel = top_k(affinity, topk)
    return affinity, gather_topk_outputs(outs, sel), sel
