"""The collectives of the port's parallel paths, over one axis of a mesh
(`parallel/mesh.py` `Axis`: a process group and its size), with the
autograd rules that JAX's single-device math gives them:

- `all_to_all` (tiled, equal splits along dim 0): its backward is the
  same all-to-all;
- `all_gather(x, axis, dim)`: every rank gets the concatenation along
  `dim`; its backward sums the ranks' cotangents and keeps this rank's
  part (a reduce-scatter): each rank's cotangent covers only what that
  rank used;
- `reduce_scatter(x, axis, dim)`: the sum over the ranks, this rank's
  part along `dim`; its backward is an all-gather;
- `all_reduce(x, axis)`: the sum over the ranks; its backward is the same
  sum (each rank used the sum, so every use feeds every summand);
- `ring_shift(x, axis)`: JAX's `lax.ppermute` with perm i -> i+1 (mod
  n): this rank sends x to the next rank of the axis and returns the
  previous rank's; its backward shifts the cotangent the other way.

An axis without a process group (size 1, or none) is the identity. NCCL
takes the single-tensor collectives; over gloo, which stages CUDA tensors
through host memory, a reduce-scatter is an all-reduce and a slice and
an all-gather goes through the list form of `dist.all_gather`; a ring
shift is a `batch_isend_irecv` pair over NCCL and, over gloo, a send and
a receive of host copies. `BYTES`
counts the bytes each collective sends from this rank (`reset_bytes`
zeroes it), for the per-step traffic that `chip_smoke.py` prints.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

BYTES: collections.Counter = collections.Counter()


def reset_bytes() -> None:
    BYTES.clear()


def _trivial(axis) -> bool:
    """No collective: no axis, or one without a process group (a mesh
    gives an axis of one rank none)."""
    return axis is None or axis.group is None


def _count(op: str, t: torch.Tensor) -> None:
    BYTES[op] += t.numel() * t.element_size()


def _nccl(axis) -> bool:
    return dist.get_backend(axis.group) == "nccl"


# -- the raw collectives (no autograd) --------------------------------------

def raw_all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    if _trivial(axis):
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("all_to_all", x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def raw_all_gather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    if _trivial(axis):
        return x
    x = x.movedim(dim, 0).contiguous()
    _count("all_gather", x)
    if _nccl(axis):
        out = torch.empty((axis.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=axis.group)
    else:
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        out = torch.cat(parts)
    return out.movedim(0, dim)


def raw_all_reduce(x: torch.Tensor, axis,
                   op: str = "all_reduce") -> torch.Tensor:
    if _trivial(axis):
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    _count(op, out)
    dist.all_reduce(out, group=axis.group)
    return out


def raw_reduce_scatter(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    if _trivial(axis):
        return x
    n = x.shape[dim] // axis.size
    if x.shape[dim] != n * axis.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {axis.size} ranks")
    if _nccl(axis):
        xm = x.movedim(dim, 0).contiguous()
        _count("reduce_scatter", xm)
        out = torch.empty((n, *xm.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xm, group=axis.group)
        return out.movedim(0, dim)
    full = raw_all_reduce(x, axis, op="reduce_scatter")
    return full.narrow(dim, axis.index * n, n).contiguous()


def raw_ring_shift(x: torch.Tensor, axis, step: int = 1) -> torch.Tensor:
    """Send x to the rank `step` places on along the axis (mod its size)
    and return what the rank `step` places back sent."""
    if _trivial(axis):
        return x
    n = axis.size
    dst = axis.ranks[(axis.index + step) % n]
    src = axis.ranks[(axis.index - step) % n]
    x = x.contiguous()
    _count("ring_shift", x)
    if _nccl(axis):
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, dst, group=axis.group),
            dist.P2POp(dist.irecv, out, src, group=axis.group)])
        for r in reqs:
            r.wait()
        return out
    # gloo: host copies; the send is posted before the receive, so a ring
    # of blocking receives cannot wait on itself
    host = x.detach().cpu()
    got = torch.empty_like(host)
    req = dist.isend(host, dst, group=axis.group)
    dist.recv(got, src, group=axis.group)
    req.wait()
    return got.to(x.device)


# -- autograd ---------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return raw_all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return raw_all_to_all(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return raw_all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return raw_reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return raw_reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return raw_all_gather(g, ctx.axis, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return raw_all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return raw_all_reduce(g, ctx.axis), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return raw_ring_shift(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return raw_ring_shift(g, ctx.axis, -1), None


def ring_shift(x: torch.Tensor, axis) -> torch.Tensor:
    """JAX's `lax.ppermute(x, axis, [(i, (i + 1) % n)])`: the previous
    rank's x; the gradient flows back to the rank that sent it."""
    return x if _trivial(axis) else _RingShift.apply(x, axis)


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """Tiled all-to-all along dim 0 (equal splits): block j of this
    rank's x goes to rank j, and block i of the output came from rank i
    (`lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)`)."""
    return x if _trivial(axis) else _AllToAll.apply(x, axis)


def all_gather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    return x if _trivial(axis) else _AllGather.apply(x, axis, dim)


def reduce_scatter(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    return x if _trivial(axis) else _ReduceScatter.apply(x, axis, dim)


def all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    return x if _trivial(axis) else _AllReduce.apply(x, axis)


def all_reduce_(tensors, axis, op: Optional[str] = None) -> None:
    """Sum a list of tensors over `axis` in place, as one flat buffer per
    dtype (one collective where a loop would make one each); no
    autograd."""
    if _trivial(axis) or not tensors:
        return
    by_dtype = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _count(op or "all_reduce", flat)
        dist.all_reduce(flat, group=axis.group)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def raw_all_reduce_max(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise max over the ranks of `axis` (no autograd)."""
    if _trivial(axis):
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out
