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

Other names pass through as they are (`mlp_<i>` of an mlpNx_gelu
projector, CLIP's `class_embedding` and `pre_layrnorm`, MPT's bias-free
LayerNorm `weight`). Everything a kernel reads keeps the JAX layout and
passes through as is:
QuantDense `kernel_q` (packed [K/2, N] in int4 mode) and `scale`, the
stacked experts `experts_w1` [E, in, h] etc. (Mixtral's `experts_w1`,
`experts_w3` [E, d, h] and `experts_w2` [E, h, d] under a decoder
layer's `moe`), the MoE `gate_kernel` [in, E] ([in, E-1] for the
shared-expert routers) and `gate_bias` [E], the cosine routers'
`inp_reduction` [in, E/2] and `expert_embeddings` [E, E/2], RMSNorm
`weight`, the vision `position_embedding`, and the
pretrain MoE's `keys` [E, d, ES], `values` [E, ES, d] and `w_gate` [E, d]
(the layouts K1 reads), and the MoA banks' `w_gate` [H*E, d] and
`experts` [H, E, in, out] (`models/moa.py`). ACT's `halting` Dense
becomes a Linear like any other, and a block ACT wraps sits under
`blocks.<i>.block`, as in the flax tree.

`from_jax_lora(tree)` carries a JAX LoRA factor tree across the same way.
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


def from_jax_lora(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA factor tree ({'a/b/.../kernel': {'a', 'b'}}, see
    competesmoe_tpu/train/lora.py) keyed by the port's module names, for
    `train.lora.LoRAParams.load_factors`. The factors keep their
    [in, r] and [r, out] layouts."""
    out = {}
    for key, ab in tree.items():
        parts = key.split("/")
        if parts[-1] != "kernel":
            raise ValueError(f"not a LoRA kernel path: {key!r}")
        name = ".".join(_name(p) for p in parts[:-1])
        out[name] = {"a": _tensor(ab["a"]), "b": _tensor(ab["b"])}
    return out
