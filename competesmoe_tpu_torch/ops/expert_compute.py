"""Expert computation (port of the single-device part of
competesmoe_tpu/ops/expert_compute.py): 2-layer Linear/act/Linear experts
(the multimodal tree), Mixtral's SwiGLU experts (the MoE decoder) and
MoEUT-style stacked keys/values experts (the pretrain tree).

Paths, picked exactly as in JAX: compute ALL experts densely and gather
the top-k when E <= 2k, else sort the token slots by expert and run one
GEMM per expert over its contiguous slice, or, under an active
expert-parallel mesh, send the slots to the ranks that hold their experts
(`parallel.expert_parallel`) (Mixtral's SwiGLU experts
always take the grouped path, on the card as grouped products over
device-side offsets); for keys/values experts on
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


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum in a's dtype with float32 accumulation (JAX's
    `preferred_element_type=float32` then a cast to a's dtype). Operands
    of one low-precision dtype on the card make one product at that width
    (cuBLAS accumulates in float32), so neither a float32 GEMM nor float32
    copies for autograd; otherwise the operands are widened first (a
    bf16 x against float32 weights promotes to float32 in JAX too)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype != torch.float32:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(a.dtype)


def dense_all_experts_mlp2(x: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor,
                           activation: Activation = gelu_tanh) -> torch.Tensor:
    """Run ALL experts on every token.
    x: [T, d]; w1: [E, d, h]; b1: [E, h]; w2: [E, h, v]; b2: [E, v]
    -> [T, E, v]"""
    h = _einsum("td,edh->teh", x, w1)
    h = activation(h + b1[None].to(h.dtype))
    out = _einsum("teh,ehv->tev", h, w2)
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


def _silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as XLA computes it: x * sigmoid(x), each step rounded
    to x's dtype (`routing.sigmoid`)."""
    from .routing import sigmoid
    return x * sigmoid(x)


def _grouped_mm(xs: torch.Tensor, w: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    """One grouped product on the card: rows [offs[e-1], offs[e]) of xs
    [M, d] times w[e] [d, n], float32 accumulation, output in xs's dtype,
    the weights rounded to it first (the `_mm_f32` rule). The offsets stay
    on the device, so nothing reads the group sizes back to the host and
    the product can run inside a captured CUDA graph. This is a PyTorch
    grouped product, not a port of a TPU kernel: JAX computes these
    products with XLA's ragged_dot."""
    return torch._grouped_mm(xs, w.to(xs.dtype), offs=offs)


def grouped_ffn_swiglu(x: torch.Tensor, sel: torch.Tensor,
                       weights: torch.Tensor, w1: torch.Tensor,
                       w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Sparse MoE FFN with Mixtral's SwiGLU experts, per expert
    `w2 @ (silu(w1 @ x) * (w3 @ x))` without biases: sort the slots by
    expert, the three products over each expert's contiguous rows, then
    an inverse-permutation gather and a float32-accumulated weighted
    reduce cast to x's dtype (JAX's `grouped_ffn_swiglu`). x: [T, d];
    sel/weights: [T, k]; w1/w3: [E, d, h]; w2: [E, h, v] -> [T, v].

    On CUDA tensors the products are grouped products over device-side
    offsets (`_grouped_mm`), which never synchronise with the host;
    elsewhere one product per expert with rows, as JAX's ragged_dot on
    the CPU. Both round as `_mm_f32`. Differentiable."""
    T, k = sel.shape
    gs = sort_by_expert(sel, w1.shape[0])
    xs = x[gs.token_ids]
    if x.is_cuda:
        offs = torch.cumsum(gs.group_sizes, 0).to(torch.int32)
        h = _silu(_grouped_mm(xs, w1, offs)) * _grouped_mm(xs, w3, offs)
        o = _grouped_mm(h, w2, offs)
    else:
        sizes = gs.group_sizes.tolist()
        parts = []
        for e, xe in enumerate(xs.split(sizes)):
            if sizes[e]:
                h = _silu(_mm_f32(xe, w1[e])) * _mm_f32(xe, w3[e])
                parts.append(_mm_f32(h, w2[e]))
        o = torch.cat(parts)
    o = o[gs.inv_perm].reshape(T, k, -1)
    out = torch.einsum("tkv,tk->tv", o.float(), weights.to(o.dtype).float())
    return out.to(x.dtype)


def _ep_mesh(impl: str):
    """The active expert-parallel mesh, if this impl should use it: 'ep'
    demands one (raises without it), 'auto' takes it whenever
    `parallel.ep_context` has one with an expert axis > 1
    (competesmoe_tpu/ops/expert_compute.py:257-272)."""
    if impl not in ("auto", "ep"):
        return None
    from ..parallel import ep_context
    mesh = ep_context.current_ep_mesh()
    if impl == "ep" and mesh is None:
        raise ValueError(
            "impl='ep' requires an active expert-parallel mesh; wrap the "
            "call in parallel.ep_context.use_expert_parallel(mesh)")
    return mesh


def moe_ffn_swiglu(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                   w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """MoE FFN dispatcher for Mixtral's SwiGLU experts: the grouped path,
    as in JAX (competesmoe_tpu/ops/expert_compute.py:314-328), which has
    no dense branch for them; the all-to-all under an active
    expert-parallel mesh."""
    mesh = _ep_mesh(impl)
    if mesh is not None:
        from ..parallel import ep_context
        from ..parallel.expert_parallel import make_ep_ffn_swiglu
        data_axis, expert_axis = ep_context.ep_axes()
        fn = make_ep_ffn_swiglu(mesh, data_axis=data_axis,
                                expert_axis=expert_axis)
        return fn(x, sel, weights, w1, w3, w2)
    return grouped_ffn_swiglu(x, sel, weights, w1, w3, w2)


def moe_ffn_mlp2(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, activation: Activation = gelu_tanh,
                 impl: str = "auto") -> torch.Tensor:
    """MoE FFN dispatcher: impl 'auto' | 'dense' | 'grouped' | 'ep'.
    'auto' computes all experts densely when E <= 2k, else takes the
    grouped path (competesmoe_tpu/ops/expert_compute.py:331-350); with an
    active expert-parallel mesh 'auto' and 'ep' dispatch by all-to-all."""
    mesh = _ep_mesh(impl)
    if mesh is not None:
        from ..parallel import ep_context
        from ..parallel.expert_parallel import make_ep_ffn_mlp2
        data_axis, expert_axis = ep_context.ep_axes()
        fn = make_ep_ffn_mlp2(mesh, activation, data_axis=data_axis,
                              expert_axis=expert_axis)
        return fn(x, sel, weights, w1, b1, w2, b2)
    if impl in ("auto", "ep"):
        impl = "dense" if w1.shape[0] <= 2 * sel.shape[-1] else "grouped"
    if impl == "dense":
        outs = dense_all_experts_mlp2(x, w1, b1, w2, b2, activation)
        return combine_topk(outs, sel, weights)
    if impl == "grouped":
        return grouped_ffn_mlp2(x, sel, weights, w1, b1, w2, b2, activation)
    raise ValueError(f"unknown impl {impl!r}")


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
    E <= 2k, else grouped. With an active expert-parallel mesh
    (`parallel.ep_context`) 'auto' and 'ep' dispatch the tokens over the
    expert axis by all-to-all (`parallel.expert_parallel`); 'ep' without
    one raises, as in JAX."""
    mesh = _ep_mesh(impl)
    if mesh is not None:
        from ..parallel import ep_context
        from ..parallel.expert_parallel import make_ep_ffn_kv
        data_axis, expert_axis = ep_context.ep_axes()
        fn = make_ep_ffn_kv(mesh, activation, data_axis=data_axis,
                            expert_axis=expert_axis,
                            with_bias=b1 is not None)
        args = (x, sel, weights, keys, values)
        return fn(*args, b1) if b1 is not None else fn(*args)
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
    if impl in ("auto", "ep"):
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
    lower index. With an active expert-parallel mesh the all-expert pass
    runs sharded (`parallel.expert_parallel.make_ep_all_experts_kv`) and
    returns this rank's rows."""
    mesh = _ep_mesh(impl)
    if mesh is not None:
        from ..parallel import ep_context
        from ..parallel.expert_parallel import make_ep_all_experts_kv
        data_axis, expert_axis = ep_context.ep_axes()
        fn = make_ep_all_experts_kv(mesh, activation, topk,
                                    data_axis=data_axis,
                                    expert_axis=expert_axis,
                                    with_bias=b1 is not None)
        args = (x, keys, values)
        return fn(*args, b1) if b1 is not None else fn(*args)
    from .routing import top_k
    outs = dense_all_experts_kv(x, keys, values, activation, b1=b1)
    affinity = F.softplus(outs).mean(dim=-1)
    _, sel = top_k(affinity, topk)
    return affinity, gather_topk_outputs(outs, sel), sel


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus` as XLA computes it: max(x, 0) + log1p(exp(-|x|)),
    each step rounded to x's dtype (F.softplus rounds once, and differs
    by a bf16 ulp on many bf16 inputs, enough to flip the top-2 of 4
    affinities); its gradient g * exp(x - softplus(x)) in that dtype, as
    jnp.logaddexp's rule."""
    return _Softplus.apply(x)


def affinity_mean(outs: torch.Tensor) -> torch.Tensor:
    """mean(softplus(outs), -1) as jnp.mean computes it on a low-precision
    input: the sum in float32, divided in float32, rounded to the input's
    dtype once."""
    sp = softplus(outs)
    return (sp.float().sum(dim=-1) / sp.shape[-1]).to(outs.dtype)


def competition_all_experts_mlp2(x: torch.Tensor, w1: torch.Tensor,
                                 b1: torch.Tensor, w2: torch.Tensor,
                                 b2: torch.Tensor, activation: Activation,
                                 topk: int, impl: str = "auto"):
    """Competition step for 2-layer Linear/act/Linear experts, replicated
    layout: x [T, d] -> (affinity [T, E], topk_outputs [T, k, v],
    sel [T, k]); affinity = mean(softplus(expert output)) per expert in
    x's dtype, sel = top-k of the raw affinity, ties toward the lower
    index. With an active expert-parallel mesh it runs sharded and
    returns this rank's rows."""
    mesh = _ep_mesh(impl)
    if mesh is not None:
        from ..parallel import ep_context
        from ..parallel.expert_parallel import make_ep_all_experts_mlp2
        data_axis, expert_axis = ep_context.ep_axes()
        fn = make_ep_all_experts_mlp2(mesh, activation, topk,
                                      data_axis=data_axis,
                                      expert_axis=expert_axis)
        return fn(x, w1, b1, w2, b2)
    from .routing import top_k
    outs = dense_all_experts_mlp2(x, w1, b1, w2, b2, activation)
    affinity = affinity_mean(outs)
    _, sel = top_k(affinity, topk)
    return affinity, gather_topk_outputs(outs, sel), sel
