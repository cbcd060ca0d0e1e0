"""PyTorch/CUDA port of competesmoe_tpu for NVIDIA Hopper (H100).

The JAX package `competesmoe_tpu` stays the reference; this package
mirrors its subpackage and module names (`ops/`, `moe/`, `models/`,
`serve/`, ...) and imports neither JAX nor anything from it. Every Pallas
TPU kernel on a ported path becomes a hand-written Hopper kernel under
`csrc/`, with a plain PyTorch version beside it in the same module.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from .device import resolve_device  # noqa: F401
