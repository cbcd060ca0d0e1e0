"""Serving-worker model adapter (the lmms eval interface waits)."""

from .llava_adapter import TorchLlava  # noqa: F401
