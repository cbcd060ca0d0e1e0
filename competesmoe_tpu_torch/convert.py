"""Carry weights from the JAX package into the port.

`from_jax_params(tree)` takes a flax param tree as nested dicts of numpy
arrays (with or without the outer {"params": ...}) and returns a
`state_dict` for the port's module of the same shape (LlavaModel,
DecoderLM, a vision tower, a MoE layer, the pretraining LM
MoELanguageModel, ...):

  * flax Dense `kernel` [in, out]         -> nn.Linear `weight` [out, in]
  * flax Conv `kernel` [kh, kw, in, out]  -> nn.Conv2d `weight`
                                             [out, in, kh, kw]
  * flax LayerNorm `scale`                -> nn.LayerNorm `weight`
  * flax Embed `embedding`                -> nn.Embedding `weight`
  * `layers_<i>`, `blocks_<i>`            -> `layers.<i>`, `blocks.<i>`

Everything a kernel reads keeps the JAX layout and passes through as is:
QuantDense `kernel_q` (packed [K/2, N] in int4 mode) and `scale`, the
stacked experts `experts_w1` [E, in, h] etc., the MoE `gate_kernel`
[in, E], RMSNorm `weight`, the vision `position_embedding`, and the
pretrain MoE's `keys` [E, d, ES], `values` [E, ES, d] and `w_gate` [E, d]
(the layouts K1 reads).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^(.*)_(\d+)$")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes: no direct torch path
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _name(key: str) -> str:
    m = _LAYER.match(key)
    if m and m.group(1) in ("layers", "blocks"):
        return f"{m.group(1)}.{m.group(2)}"
    return key


def _is_tree(node) -> bool:
    return isinstance(node, Mapping) or hasattr(node, "items")


def from_jax_params(tree) -> Dict[str, torch.Tensor]:
    if _is_tree(tree) and set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix: str):
        keys = set(node.keys())
        if "kernel" in keys and not _is_tree(node["kernel"]):
            k = np.asarray(node["kernel"])
            k = k.T if k.ndim == 2 else k.transpose(3, 2, 0, 1)
            out[prefix + "weight"] = _tensor(np.ascontiguousarray(k))
            if "bias" in keys:
                out[prefix + "bias"] = _tensor(node["bias"])
            return
        if "scale" in keys and "kernel_q" not in keys:      # LayerNorm
            out[prefix + "weight"] = _tensor(node["scale"])
            if "bias" in keys:
                out[prefix + "bias"] = _tensor(node["bias"])
            return
        if keys == {"embedding"}:
            out[prefix + "weight"] = _tensor(node["embedding"])
            return
        for key, child in node.items():
            name = prefix + _name(key)
            if _is_tree(child):
                walk(child, name + ".")
            else:
                out[name] = _tensor(child)

    walk(tree, "")
    return out
