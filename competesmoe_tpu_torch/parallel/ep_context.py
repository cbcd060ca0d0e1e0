"""Process-global expert-parallel context (port of
competesmoe_tpu/parallel/ep_context.py).

The training task (or a test) activates expert parallelism for the process
with `set_ep_mesh` / `use_expert_parallel`, and `ops.expert_compute.moe_ffn_*`
and `competition_all_experts_*` consult `current_ep_mesh()` at each call:
with an active mesh whose `expert` axis is > 1, `impl='auto'` (and
`impl='ep'`) dispatch through the all-to-all path of
`parallel.expert_parallel`, over this rank's shards of the expert banks.
`replicated_tokens=True` (serving: every rank runs the same tokens) makes
each rank dispatch only its block of them and gather the outputs.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from .mesh import Mesh

_EP_MESH: Optional[Mesh] = None
_DATA_AXIS = "data"
_EXPERT_AXIS = "expert"
_REPLICATED = False


def set_ep_mesh(mesh: Optional[Mesh], data_axis: str = "data",
                expert_axis: str = "expert",
                replicated_tokens: bool = False) -> None:
    """Activate (or with None, deactivate) expert parallelism globally."""
    global _EP_MESH, _DATA_AXIS, _EXPERT_AXIS, _REPLICATED
    if mesh is not None and expert_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {expert_axis!r} "
                         f"axis")
    _EP_MESH = mesh
    _DATA_AXIS = data_axis
    _EXPERT_AXIS = expert_axis
    _REPLICATED = bool(replicated_tokens)


def current_ep_mesh() -> Optional[Mesh]:
    """The active EP mesh, or None if the expert axis is trivial/absent."""
    if _EP_MESH is not None and _EP_MESH.shape[_EXPERT_AXIS] > 1:
        return _EP_MESH
    return None


def ep_axes() -> tuple:
    return _DATA_AXIS, _EXPERT_AXIS


def replicated_tokens() -> bool:
    """Do all ranks of the expert axis hold the same tokens?"""
    return _REPLICATED


@contextmanager
def use_expert_parallel(mesh: Mesh, data_axis: str = "data",
                        expert_axis: str = "expert",
                        replicated_tokens: bool = False):
    """Scoped activation (tests, a task's loops, a serving call)."""
    prev = (_EP_MESH, _DATA_AXIS, _EXPERT_AXIS, _REPLICATED)
    set_ep_mesh(mesh, data_axis, expert_axis, replicated_tokens)
    try:
        yield
    finally:
        set_ep_mesh(*prev)
