"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit) and the roofline bound of a piece of work:
the larger of its bytes over the memory rate and its operations over the
bf16 tensor-core rate."""

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card needs for `ops` operations that move
    `nbytes` bytes."""
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)

