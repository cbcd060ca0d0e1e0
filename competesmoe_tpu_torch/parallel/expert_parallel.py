"""Expert-parallel MoE dispatch: experts sharded over the mesh's `expert`
axis, tokens exchanged by all-to-all (port of
competesmoe_tpu/parallel/expert_parallel.py).

Each rank holds its rows of the batch ([T_loc, d] tokens) and its
E / n_ep experts. Dataflow per rank (capacity-based, as JAX's
`_ep_dispatch`):

  1. route: each token-slot's expert id maps to (shard, local id);
  2. pack: the slots bound for shard s are ranked within s (a stable sort
     by shard) and written into a [n_ep, cap, d] send buffer; a slot of
     rank >= cap drops; cap defaults to the lossless T_loc * k;
  3. all-to-all over the expert axis (payload and local expert ids);
  4. the shard's experts over every received slot; padding slots run
     through local expert 0 and their outputs are never read;
  5. all-to-all back; each slot reads its output at [shard, rank], and
     the routing weights combine them in float32.

The competition (all-expert) step gathers the tokens of the data row
(`in_specs P('data')` in JAX), runs this shard's experts densely on them,
all-gathers the affinities ([T, E], small), takes the global top-k, keeps
the selected outputs that live here, and sums over the shards; each rank
keeps its rows. Every collective a gradient crosses is an autograd
function of `collectives` whose backward is the single-device gradient.

When every rank of the expert axis holds the same tokens (serving,
`ep_context.replicated_tokens()`), each rank dispatches its block of them
(padded to equal blocks) and all-gathers the outputs (`_replicated`).

On CUDA tensors the keys/values experts' local compute is K1
(`ops/gmm_fused.fused_grouped_ffn_kv`, each received slot its own token
with weight 1) where `fused_path_refusal` allows it (relu, no bias, D and
ES multiples of 128), else the port's grouped path, as on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import expert_compute as ec
from ..ops import routing as R
from . import collectives as C
from .mesh import Mesh


def _ep_dispatch(x, sel, weights, compute_local, v_dim, axis,
                 n_experts_global, capacity=None):
    """pack -> all-to-all -> local compute -> all-to-all -> combine.

    x: [T_loc, d]; sel/weights: [T_loc, k]; compute_local(flat_x [N, d],
    flat_eid [N]) -> [N, v_dim] runs this shard's experts. Every rank of
    the axis must pass the same T_loc."""
    T, d = x.shape
    k = sel.shape[-1]
    n_ep = axis.size
    e_loc = n_experts_global // n_ep
    slots = T * k
    cap = capacity or slots
    dev = x.device

    sel_flat = sel.reshape(-1).long()
    dest = sel_flat // e_loc                       # target shard
    local_eid = sel_flat % e_loc

    # rank of each slot within its destination shard
    order = torch.argsort(dest, stable=True)
    counts = torch.zeros(n_ep, dtype=torch.long, device=dev)
    counts.index_add_(0, dest, torch.ones_like(dest))
    offsets = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(slots, device=dev) - offsets[dest[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    # pack the send buffers; a slot over capacity writes to a spare row
    # past the end, which is never sent
    in_cap = rank < cap
    pos = torch.where(in_cap, dest * cap + rank,
                      torch.full_like(rank, n_ep * cap))
    x_rep = x[torch.arange(slots, device=dev) // k]
    send_x = x.new_zeros((n_ep * cap + 1, d)).index_put((pos,), x_rep)
    send_eid = torch.zeros(n_ep * cap + 1, dtype=torch.long,
                           device=dev).index_put((pos,), local_eid)

    recv_x = C.all_to_all(send_x[:-1], axis)
    recv_eid = C.raw_all_to_all(send_eid[:-1], axis)
    out_local = compute_local(recv_x, recv_eid)
    recv_back = C.all_to_all(out_local, axis)

    # combine: each slot reads its output back from [dest shard, rank];
    # dropped slots contribute zero
    safe = dest * cap + torch.clamp(rank, max=cap - 1)
    slot_out = recv_back[safe]
    slot_out = torch.where(in_cap[:, None], slot_out,
                           torch.zeros((), dtype=slot_out.dtype, device=dev))
    slot_out = slot_out.reshape(T, k, v_dim)
    out = torch.einsum("tkv,tk->tv", slot_out.float(),
                       weights.to(slot_out.dtype).float())
    return out.to(x.dtype)


def _replicated(dispatch, axis):
    """dispatch(x, sel, weights) over tokens that every rank of `axis`
    holds: each rank runs its block of them (the tokens padded to a
    multiple of the axis size; padding rows route to expert 0 with weight
    0) and the outputs are gathered."""
    from . import ep_context

    def run(x, sel, weights):
        if not ep_context.replicated_tokens():
            return dispatch(x, sel, weights)
        T, n = x.shape[0], axis.size
        blk = -(-T // n)
        pad = blk * n - T
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
            sel = torch.cat([sel, sel.new_zeros((pad, sel.shape[1]))])
            weights = torch.cat([weights,
                                 weights.new_zeros((pad, weights.shape[1]))])
        rows = slice(axis.index * blk, (axis.index + 1) * blk)
        out = dispatch(x[rows], sel[rows], weights[rows])
        return C.raw_all_gather(out, axis, 0)[:T]
    return run


def _kv_local(keys, values, activation, b1):
    """The keys/values experts of this shard over received slots: K1 on
    CUDA where JAX's rule allows it, else the grouped path."""
    from ..ops.gmm_fused import fused_grouped_ffn_kv, fused_path_refusal

    def compute_local(flat_x, flat_eid):
        ones = torch.ones((flat_x.shape[0], 1), dtype=flat_x.dtype,
                          device=flat_x.device)
        if flat_x.is_cuda and fused_path_refusal(flat_x, keys, activation,
                                                 b1) is None:
            return fused_grouped_ffn_kv(flat_x, flat_eid[:, None], ones,
                                        keys, values)
        return ec.grouped_ffn_kv(flat_x, flat_eid[:, None], ones, keys,
                                 values, activation, b1=b1)
    return compute_local


def make_ep_ffn_kv(mesh: Mesh, activation: Callable,
                   capacity: Optional[int] = None,
                   data_axis: str = "data", expert_axis: str = "expert",
                   with_bias: bool = False):
    """Expert-parallel MoE FFN with MoEUT keys/values experts: fn(x
    [T_loc, d], sel [T_loc, k], weights [T_loc, k], keys [E_loc, d, h],
    values [E_loc, h, v][, b1 [E_loc, h]]) -> [T_loc, v], over this rank's
    rows and its shard of the banks."""
    axis = mesh.axis(expert_axis)

    def ep_ffn(x, sel, weights, keys, values, *rest):
        b1 = rest[0] if with_bias else None
        return _replicated(lambda x, sel, weights: _ep_dispatch(
            x, sel, weights, _kv_local(keys, values, activation, b1),
            values.shape[-1], axis, keys.shape[0] * axis.size, capacity),
            axis)(x, sel, weights)

    return ep_ffn


def make_ep_ffn_mlp2(mesh: Mesh, activation: Callable,
                     capacity: Optional[int] = None,
                     data_axis: str = "data", expert_axis: str = "expert"):
    """Expert-parallel MoE FFN with the multimodal tree's 2-layer
    Linear/act/Linear experts: fn(x, sel, weights, w1 [E_loc, d, h],
    b1 [E_loc, h], w2 [E_loc, h, v], b2 [E_loc, v]) -> [T_loc, v]."""
    axis = mesh.axis(expert_axis)

    def ep_ffn(x, sel, weights, w1, b1, w2, b2):
        def compute_local(flat_x, flat_eid):
            ones = torch.ones((flat_x.shape[0], 1), dtype=x.dtype,
                              device=x.device)
            return ec.grouped_ffn_mlp2(flat_x, flat_eid[:, None], ones,
                                       w1, b1, w2, b2, activation)

        return _replicated(lambda x, sel, weights: _ep_dispatch(
            x, sel, weights, compute_local, w2.shape[-1], axis,
            w1.shape[0] * axis.size, capacity), axis)(x, sel, weights)

    return ep_ffn


def make_ep_ffn_swiglu(mesh: Mesh, capacity: Optional[int] = None,
                       data_axis: str = "data",
                       expert_axis: str = "expert"):
    """Expert-parallel MoE FFN with Mixtral's SwiGLU experts: fn(x, sel,
    weights, w1 [E_loc, d, h], w3 [E_loc, d, h], w2 [E_loc, h, v]) ->
    [T_loc, v]."""
    axis = mesh.axis(expert_axis)

    def ep_ffn(x, sel, weights, w1, w3, w2):
        def compute_local(flat_x, flat_eid):
            ones = torch.ones((flat_x.shape[0], 1), dtype=x.dtype,
                              device=x.device)
            return ec.grouped_ffn_swiglu(flat_x, flat_eid[:, None], ones,
                                         w1, w3, w2)

        return _replicated(lambda x, sel, weights: _ep_dispatch(
            x, sel, weights, compute_local, w2.shape[-1], axis,
            w1.shape[0] * axis.size, capacity), axis)(x, sel, weights)

    return ep_ffn


def _competition_combine(outs_loc, affinity_of, axis, topk):
    """Shared tail of the sharded competition step.

    outs_loc: [T_blk, E_loc, v] this shard's expert outputs on the data
    row's tokens. Returns this rank's rows of (affinity [T, E],
    topk_outputs [T, k, v], sel [T, k])."""
    e_loc = outs_loc.shape[1]
    aff_loc = affinity_of(outs_loc)
    # [T_blk, E]: small (affinities, not activations), the only gather
    affinity = C.all_gather(aff_loc, axis, dim=1)
    _, sel = R.top_k(affinity, topk)
    local_sel = sel - axis.index * e_loc
    valid = (local_sel >= 0) & (local_sel < e_loc)
    safe = torch.clamp(local_sel, 0, e_loc - 1)
    tk = ec.gather_topk_outputs(outs_loc, safe)
    tk = torch.where(valid[..., None], tk,
                     torch.zeros((), dtype=tk.dtype, device=tk.device))
    # each selected output lives on exactly one shard: the sum over the
    # shards is exact, and each rank keeps its rows of it
    tk = C.reduce_scatter(tk, axis, dim=0)
    n = tk.shape[0]
    rows = slice(axis.index * n, (axis.index + 1) * n)
    return affinity[rows], tk, sel[rows]


def _kv_affinity(outs):
    return torch.nn.functional.softplus(outs).mean(dim=-1)


def make_ep_all_experts_kv(mesh: Mesh, activation: Callable, topk: int,
                           data_axis: str = "data",
                           expert_axis: str = "expert",
                           with_bias: bool = False):
    """Sharded CompeteSMoE competition step (keys/values experts):
    fn(x [T_loc, d], keys [E_loc, d, h], values [E_loc, h, v][, b1]) ->
    this rank's rows of (affinity [T, E], topk_outputs [T, k, v],
    sel [T, k]), as `expert_compute.competition_all_experts_kv` computes
    them over the whole batch."""
    axis = mesh.axis(expert_axis)

    def comp(x, keys, values, *rest):
        b1 = rest[0] if with_bias else None
        x_blk = C.all_gather(x, axis, dim=0)
        outs = ec.dense_all_experts_kv(x_blk, keys, values, activation,
                                       b1=b1)
        return _competition_combine(outs, _kv_affinity, axis, topk)

    return comp


def make_ep_all_experts_mlp2(mesh: Mesh, activation: Callable, topk: int,
                             data_axis: str = "data",
                             expert_axis: str = "expert"):
    """Sharded competition step for 2-layer Linear/act/Linear experts:
    fn(x [T_loc, d], w1, b1, w2, b2) -> this rank's rows of (affinity,
    topk_outputs, sel); the affinity in x's dtype (`affinity_mean`)."""
    axis = mesh.axis(expert_axis)

    def comp(x, w1, b1, w2, b2):
        x_blk = C.all_gather(x, axis, dim=0)
        outs = ec.dense_all_experts_mlp2(x_blk, w1, b1, w2, b2, activation)
        return _competition_combine(outs, ec.affinity_mean, axis, topk)

    return comp
