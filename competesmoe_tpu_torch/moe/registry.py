"""String-keyed registry of the multimodal MoE layers (port of
competesmoe_tpu/moe/registry.py; the pretrain zoo's registry waits for
the LM training slice)."""

from __future__ import annotations

from typing import Dict, Type

MOE_REGISTRY: Dict[str, type] = {}


def register_moe(*names):
    def decorate(cls):
        for name in names:
            existing = MOE_REGISTRY.get(name)
            if existing is not None and existing is not cls:
                raise ValueError(
                    f"MoE name {name!r} already registered to {existing!r}")
            MOE_REGISTRY[name] = cls
        return cls
    return decorate


def get_moe(name: str) -> Type:
    try:
        return MOE_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown multimodal MoE {name!r}. Registered: "
            f"{', '.join(sorted(MOE_REGISTRY))}") from None
