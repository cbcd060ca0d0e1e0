"""Process-global sequence-parallel mesh context (port of
competesmoe_tpu/parallel/seq_context.py).

The counterpart of `ep_context` for the 'seq' axis: while a mesh whose
'seq' axis has more than one rank is active, `models.lm.
FastRopeAttention` runs plain causal self-attention as a ring
(`parallel/ring_attention.py`) over this rank's block of the sequence,
and `models.decoder.DecoderLM` its padded form where JAX does.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from .mesh import Mesh

_SEQ_MESH: Optional[Mesh] = None
_SEQ_AXIS = "seq"


def set_seq_mesh(mesh: Optional[Mesh], seq_axis: str = "seq") -> None:
    global _SEQ_MESH, _SEQ_AXIS
    if mesh is not None and seq_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {seq_axis!r} axis")
    _SEQ_MESH = mesh
    _SEQ_AXIS = seq_axis


def current_seq_mesh() -> Optional[Mesh]:
    """The active mesh, or None when its seq axis is trivial or absent."""
    if _SEQ_MESH is not None and _SEQ_MESH.shape[_SEQ_AXIS] > 1:
        return _SEQ_MESH
    return None


def seq_axis() -> str:
    return _SEQ_AXIS


def active():
    """(the active mesh, this rank's `seq_axis()` Axis of it), or None."""
    mesh = current_seq_mesh()
    return None if mesh is None else (mesh, mesh.axis(_SEQ_AXIS))


@contextmanager
def use_sequence_parallel(mesh: Mesh, seq_axis: str = "seq"):
    prev, prev_axis = _SEQ_MESH, _SEQ_AXIS
    set_seq_mesh(mesh, seq_axis)
    try:
        yield
    finally:
        set_seq_mesh(prev, prev_axis)
