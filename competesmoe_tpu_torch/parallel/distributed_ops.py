"""Statistics over the global batch when its rows are spread over ranks
(the reference's moe_pretrain_model/framework/helpers/distributed_ops.py;
JAX needs none of it: its `jit` computes over the global batch, see
competesmoe_tpu/ops/losses.py:59-64).

A training step that holds only this rank's rows activates the group of
the ranks that hold the rest (`use_batch_axis`, the world); a loss whose
statistic spans batch rows passes `batch_axis()` to `mean_over_batch` or
`log_mean`, which reduce over that group *before* the nonlinearity, so
every rank computes the global value. The reductions are differentiable (their backward sums
the ranks' cotangents, `collectives.all_reduce`), and each rank adds
1/world of the loss to its objective, so the ranks' sum is the global
loss and its gradient.

Under sequence parallelism the ranks of the 'seq' axis hold the other
tokens of the same rows: the batch axis (`use_batch_axis`) is then every
rank (data x expert x seq), and a statistic over the tokens of each row
reduces over `token_axis()`, the 'seq' axis: the entropy balance's
log-mean (the pretrain routers, MoA, the competition step's
`balance_affinity`) and the multimodal layers' switch balance.

Which aux losses span rows (ops/losses.py): Mixtral's top-1 balance
flattens [B, N] first (`moe/layers.py` `MixtralMoELayer`), so its two
density means do. The pretrain entropy balance (also MoA's and the
competition step's `balance_affinity`) log-means over the tokens of each
row, the multimodal tree's balance keeps the batch dim, and the z-loss,
the router-distillation MSE and the diversity loss are token means: a
rank's share of those is exact without any collective.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

from . import collectives as C

_BATCH_AXIS = None
_TOKEN_AXIS = None


def batch_axis():
    """The axis whose ranks hold the other rows (and tokens) of the
    batch, or None."""
    return _BATCH_AXIS


def token_axis():
    """The axis whose ranks hold the other tokens of this rank's rows
    (the 'seq' axis), or None."""
    return _TOKEN_AXIS


def _nontrivial(axis):
    return axis if axis is not None and axis.size > 1 else None


@contextmanager
def use_batch_axis(axis, tokens=None):
    """Activate the batch axis and, under sequence parallelism, the token
    axis (`tokens`)."""
    global _BATCH_AXIS, _TOKEN_AXIS
    prev = _BATCH_AXIS, _TOKEN_AXIS
    _BATCH_AXIS, _TOKEN_AXIS = _nontrivial(axis), _nontrivial(tokens)
    try:
        yield
    finally:
        _BATCH_AXIS, _TOKEN_AXIS = prev


def mean_over_batch(x: torch.Tensor, dim: int, axis=None) -> torch.Tensor:
    """x.mean(dim) over the rows of every rank of `axis` (ranks hold
    equal numbers of rows); this rank's mean when `axis` is None."""
    m = x.mean(dim=dim)
    if axis is None:
        return m
    return C.all_reduce(m, axis) / axis.size


def log_mean(x: torch.Tensor, dim: int = 0, axis=None) -> torch.Tensor:
    """log(mean(exp(x))) along `dim` in float32, over the rows of every
    rank of `axis` (the reference's distributed branch: a max over the
    ranks, then the mean of exp(x - max) reduced across them); this
    rank's when `axis` is None."""
    x = x.float()
    if axis is None:
        return torch.logsumexp(x, dim=dim) - math.log(x.shape[dim])
    xmax = C.raw_all_reduce_max(x.detach().amax(dim=dim, keepdim=True), axis)
    e = torch.exp(x - xmax).mean(dim=dim)
    return torch.log(C.all_reduce(e, axis) / axis.size) + xmax.squeeze(dim)
