"""Fused grouped ReLU double GEMM for the MoE FFN (port of
competesmoe_tpu/ops/gmm_fused.py, kernel K1).

The slots of a top-k selection are sorted by expert and each expert's
group is padded to a multiple of TILE rows (`aligned_layout`), so every
256-row tile belongs to one expert, `tile_expert[t]`. The kernel then
computes `relu(xs @ keys[e]) @ values[e]` tile by tile with the hidden
activation kept on chip; the combine gathers each slot's row back and
sums the k rows of a token with their routing weights.

`gmm2_fused_aligned` launches the Hopper kernel of `csrc/gmm2_fused.cu`
for CUDA tensors (built by `_kernels.py`; the f32 weights are rounded to
bf16 once per call, inside the wrapper) and runs its plain PyTorch
version, `gmm2_fused_aligned_reference`, for CPU tensors.
`fused_grouped_ffn_kv` is the differentiable pipeline; its backward
recomputes through `expert_compute.grouped_ffn_kv` in plain PyTorch, as
the JAX custom VJP recomputes through XLA's ragged_dot (no Pallas
backward exists to port).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _kernels

TILE = 256


def gmm2_fused_aligned_reference(xs: torch.Tensor, keys: torch.Tensor,
                                 values: torch.Tensor,
                                 tile_expert: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: per tile, h = relu(xs @ keys[e]) in
    float32 (xs promoted to the weights' type, as the TPU kernel's dot
    promotes), rounded to xs's dtype, then h @ values[e] in float32,
    stored in xs's dtype."""
    S, D = xs.shape
    e = tile_expert.long()
    x3 = xs.reshape(S // TILE, TILE, D).float()
    h = torch.relu(torch.bmm(x3, keys[e].float())).to(xs.dtype)
    o = torch.bmm(h.float(), values[e].float())
    return o.reshape(S, -1).to(xs.dtype)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm2_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.gmm2_launch.restype = ctypes.c_int


def gmm2_fused_aligned(xs: torch.Tensor, keys: torch.Tensor,
                       values: torch.Tensor,
                       tile_expert: torch.Tensor) -> torch.Tensor:
    """relu double GEMM over expert-aligned rows.

    xs: [S', D] with rows [t*TILE, (t+1)*TILE) all belonging to expert
    tile_expert[t]; keys: [E, D, ES]; values: [E, ES, D]; tile_expert:
    [S'/TILE] int32. Returns [S', D] in xs's dtype. On CUDA: bf16 xs,
    float32 keys/values, D and ES multiples of 128, ES <= 512; the
    kernel reads the weights rounded to bf16 (nearest even), cast here
    once per call."""
    if xs.device.type == "cpu":
        return gmm2_fused_aligned_reference(xs, keys, values, tile_expert)
    if xs.device.type != "cuda" or any(
            t.device != xs.device for t in (keys, values, tile_expert)):
        raise ValueError("xs, keys, values and tile_expert must share one "
                         "CUDA device")
    if (xs.dtype != torch.bfloat16 or keys.dtype != torch.float32
            or values.dtype != torch.float32
            or tile_expert.dtype != torch.int32):
        raise TypeError(f"expected bf16 xs, f32 keys/values, int32 "
                        f"tile_expert; got {xs.dtype}, {keys.dtype}, "
                        f"{values.dtype}, {tile_expert.dtype}")
    if xs.dim() != 2 or keys.dim() != 3 or values.dim() != 3:
        raise ValueError("expected xs [S, D], keys [E, D, ES], values "
                         "[E, ES, D]")
    S, D = xs.shape
    E, _, ES = keys.shape
    if (keys.shape[1] != D or tuple(values.shape) != (E, ES, D)
            or tuple(tile_expert.shape) != (S // TILE,) or S % TILE
            or D % 128 or ES % 128 or ES > 512):
        raise ValueError(f"bad shapes xs {tuple(xs.shape)}, keys "
                         f"{tuple(keys.shape)}, values "
                         f"{tuple(values.shape)}, tile_expert "
                         f"{tuple(tile_expert.shape)}")
    if not all(t.is_contiguous() for t in (xs, keys, values, tile_expert)) \
            or any(t.data_ptr() % 16 for t in (xs, keys, values)):
        raise ValueError("xs, keys, values and tile_expert must be "
                         "contiguous and 16-byte aligned")
    lib = _kernels.load("gmm2_fused", _bind)
    keys16 = keys.to(torch.bfloat16)
    values16 = values.to(torch.bfloat16)
    out = torch.empty_like(xs)
    rc = lib.gmm2_launch(xs.data_ptr(), keys16.data_ptr(),
                         values16.data_ptr(), tile_expert.data_ptr(),
                         out.data_ptr(), S, D, ES, E,
                         torch.cuda.current_stream(xs.device).cuda_stream)
    _kernels.check(rc, "gmm2 fused")
    gmm2_fused_aligned.launches += 1
    return out


gmm2_fused_aligned.launches = 0


def aligned_layout(sel: torch.Tensor, n_experts: int):
    """Group-aligned dispatch metadata (JAX `_aligned_layout`).

    Returns (gs, tok_padded [S'], tile_expert [S'/TILE], shift [E]):
      S' = a TILE-aligned static bound on the padded slot count,
      tok_padded[p] = token row feeding padded slot p (an arbitrary valid
                      row on padding positions, never read back),
      shift[e] = padded position - sorted position for expert e's rows.
    Bit for bit the arrays JAX builds: the per-group rolls there are this
    one gather, t_ext[(p - shift[e_of_p[p]]) mod S'].
    """
    from .expert_compute import sort_by_expert

    S = sel.numel()
    dev = sel.device
    gs = sort_by_expert(sel, n_experts)
    sizes = gs.group_sizes.to(torch.int64)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    bounds = torch.cat([zero, torch.cumsum(sizes, 0)])
    aligned = (sizes + TILE - 1) // TILE * TILE
    aoff = torch.cat([zero, torch.cumsum(aligned, 0)])
    s_pad = (S + TILE - 1) // TILE * TILE + n_experts * TILE
    shift = aoff[:n_experts] - bounds[:n_experts]
    # expert of every padded position: +1 at each group start
    steps = torch.zeros(s_pad, dtype=torch.int64, device=dev)
    steps.index_add_(0, aoff[1:n_experts],
                     torch.ones(n_experts - 1, dtype=torch.int64,
                                device=dev))
    e_of_p = torch.cumsum(steps, 0)
    tile_expert = e_of_p.reshape(-1, TILE)[:, 0].to(torch.int32)
    t_ext = torch.zeros(s_pad, dtype=torch.int64, device=dev)
    t_ext[:S] = gs.token_ids
    pos = torch.arange(s_pad, device=dev)
    tok_padded = t_ext[(pos - shift[e_of_p]) % s_pad]
    return gs, tok_padded, tile_expert, shift


def fused_grouped_ffn_kv_fwd(x: torch.Tensor, sel: torch.Tensor,
                             weights: torch.Tensor, keys: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """Aligned gather -> K1 -> combine: the contract of
    `expert_compute.grouped_ffn_kv` with relu experts. x: [T, D];
    sel/weights: [T, k] -> [T, D] in x's dtype."""
    T, D = x.shape
    k = sel.shape[-1]
    gs, tok_padded, tile_expert, shift = aligned_layout(sel, keys.shape[0])
    xs = x[tok_padded]
    o = gmm2_fused_aligned(xs, keys, values, tile_expert)
    # flat slot j sits at padded position inv_perm[j] + shift[sel[j]]
    idx = gs.inv_perm + shift[sel.reshape(-1).long()]
    gathered = o[idx].reshape(T, k, -1)
    out = torch.einsum("tkv,tk->tv", gathered.float(),
                       weights.to(o.dtype).float())
    return out.to(x.dtype)


class _FusedGroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sel, weights, keys, values):
        ctx.save_for_backward(x, sel, weights, keys, values)
        return fused_grouped_ffn_kv_fwd(x, sel, weights, keys, values)

    @staticmethod
    def backward(ctx, g):
        from .expert_compute import grouped_ffn_kv
        x, sel, weights, keys, values = ctx.saved_tensors
        need = [ctx.needs_input_grad[i] for i in (0, 2, 3, 4)]
        if not any(need):
            return None, None, None, None, None
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip((x, weights, keys, values), need)]
            out = grouped_ffn_kv(leaves[0], sel, leaves[1], leaves[2],
                                 leaves[3], torch.relu)
            wanted = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wanted, g))
        dx, dw, dk, dv = (next(got) if n else None for n in need)
        return dx, None, dw, dk, dv


def fused_grouped_ffn_kv(x: torch.Tensor, sel: torch.Tensor,
                         weights: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """Differentiable fused MoE FFN: forward through K1, backward by
    recomputing the grouped formulation (one forward recompute, as with
    remat; deterministic, no atomics)."""
    return _FusedGroupedFFN.apply(x, sel, weights, keys, values)


def fused_path_refusal(x: torch.Tensor, keys: torch.Tensor, activation,
                       b1=None) -> Optional[str]:
    """Why K1 cannot run these experts, or None when it can. JAX's rule:
    relu experts without a bias, D and ES multiples of 128."""
    if activation is not torch.relu:
        return (f"activation {getattr(activation, '__name__', activation)!r}"
                f" is not torch.relu")
    if b1 is not None:
        return "the experts have a bias (b1)"
    if x.shape[-1] % 128 or keys.shape[-1] % 128:
        return (f"d_model {x.shape[-1]} and expert size {keys.shape[-1]} "
                f"must both be multiples of 128")
    return None


def fused_path_available(x: torch.Tensor, keys: torch.Tensor,
                         activation) -> bool:
    """JAX's rule (`fused_path_refusal`), on the accelerator: here a CUDA
    tensor, where JAX asks for a TPU."""
    return (x.device.type == "cuda"
            and fused_path_refusal(x, keys, activation) is None)
