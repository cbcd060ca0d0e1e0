"""Blockwise 8-bit Adam state (port of competesmoe_tpu/train/quant_opt.py).

Adam's moments are held in 8 bits between steps and dequantized, updated
in float32 and quantized again at each step; the update direction itself
is computed in float32:

* mu (signed): blockwise absmax linear int8 along the parameter's LAST
  dim, `scale = max|x| / 127` per block, `q = round(x / scale)`;
* nu (non-negative): sqrt(nu) stored as uint8 codes, `scale =
  max(sqrt(nu)) / 255` per block, squared back on dequantization;
* the codes keep the parameter's exact shape, the scales have shape
  `shape[:-1] + (ceil(d / block),)`; a ragged last dim is padded only
  inside the quantizer;
* parameters with fewer than `min_quant_size` elements keep float
  moments in their own dtype;
* blocks run along the dim that is last in JAX's layout of the
  parameter: an nn.Linear or nn.Conv2d weight keeps its output dim first
  here and last in flax, so its moments are quantized along dim 0
  (`quant_axes`), and the codes and scales take that dim last.

A sharded parameter (`parallel/mesh.py`) is quantized in blocks of the
whole tensor, as JAX quantizes its global array: a shard whose cut does
not run along the block dim, or cuts it at a multiple of the block, holds
its own blocks exactly; one that would split a block (its block dim cut
at a length that is not a multiple of 256) gathers its gradient and keeps
the moments of the whole tensor, and its direction is its part of the
whole one (`QuantAdamState.full`).

`QuantAdamState` is the 8-bit variant of the trainers' `AdamState`
(train/lm_trainer.py): the LM trainer's `-opt.state_8bit` and the
multimodal trainer's `--opt-state-8bit` hold their moments in it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

BLOCK = 256
MIN_QUANT_SIZE = 4096


@dataclasses.dataclass
class QuantLeaf:
    """One quantized moment: codes in the parameter's shape (int8 for mu,
    uint8 for sqrt(nu)) and float32 blockwise scales."""

    q: torch.Tensor
    scale: torch.Tensor


Moment = Union[QuantLeaf, torch.Tensor]


def _blocked(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """[..., d] -> ([..., nb, block] zero-padded, d)."""
    d = x.shape[-1]
    nb = -(-d // block)
    pad = nb * block - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], nb, block), d


def _unblocked(xb: torch.Tensor, d: int) -> torch.Tensor:
    return xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])[..., :d]


def quantize_signed(x: torch.Tensor, block: int = BLOCK) -> QuantLeaf:
    xb, d = _blocked(x.float(), block)
    scale = xb.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.round(xb / safe[..., None]).to(torch.int8)
    return QuantLeaf(q=_unblocked(q, d).contiguous(), scale=scale)


def dequantize_signed(leaf: QuantLeaf, block: int = BLOCK) -> torch.Tensor:
    qb, d = _blocked(leaf.q.float(), block)
    return _unblocked(qb * leaf.scale[..., None], d)


def quantize_sqrt(x: torch.Tensor, block: int = BLOCK) -> QuantLeaf:
    """Non-negative x stored as uint8 codes of sqrt(x)."""
    rb, d = _blocked(torch.sqrt(x.float()), block)
    scale = rb.amax(dim=-1) / 255.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.round(rb / safe[..., None]).to(torch.uint8)
    return QuantLeaf(q=_unblocked(q, d).contiguous(), scale=scale)


def dequantize_sqrt(leaf: QuantLeaf, block: int = BLOCK) -> torch.Tensor:
    qb, d = _blocked(leaf.q.float(), block)
    r = _unblocked(qb * leaf.scale[..., None], d)
    return r * r


def quantizable(p: torch.Tensor, min_quant_size: int = MIN_QUANT_SIZE
                ) -> bool:
    return (p.is_floating_point() and p.numel() >= min_quant_size
            and p.dim() >= 1)


def quant_axes(model: torch.nn.Module) -> Dict[str, int]:
    """Parameter name -> the dim that is last in JAX's layout, where it is
    not the last here: dim 0 (output features) of nn.Linear and nn.Conv2d
    weights."""
    axes = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
            axes[f"{name}.weight" if name else "weight"] = 0
    return axes


@dataclasses.dataclass
class QuantAdamState:
    """Adam's count and moments, mu and nu per parameter name as a
    QuantLeaf (or a float tensor for a small parameter). `axes[name]` is
    the dim a parameter's blocks run along (the last by default)."""

    count: int
    mu: Dict[str, Moment]
    nu: Dict[str, Moment]
    block: int = BLOCK
    axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    # {name: mesh axis} of the sharded parameters, and {name: (axis,
    # dim)} of those whose moments are the whole tensor's (a shard cut
    # would split a block)
    shards: Dict[str, object] = dataclasses.field(default_factory=dict)
    full: Dict[str, Tuple[object, int]] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def init(cls, params: Dict[str, torch.Tensor], block: int = BLOCK,
             min_quant_size: int = MIN_QUANT_SIZE,
             axes: Dict[str, int] = None,
             shards: Dict[str, Tuple[object, int]] = None
             ) -> "QuantAdamState":
        axes = {k: a for k, a in (axes or {}).items() if k in params}
        shards = {k: v for k, v in (shards or {}).items() if k in params}
        mu, nu, full = {}, {}, {}
        for k, p in params.items():
            shape = tuple(p.shape)
            if k in shards:
                ax, dim = shards[k]
                shape = shape[:dim] + (shape[dim] * ax.size,) + \
                    shape[dim + 1:]
            if quantizable(torch.empty(shape, device="meta",
                                       dtype=p.dtype), min_quant_size):
                bdim = axes.get(k, -1) % p.dim()
                if k in shards and shards[k][1] == bdim and \
                        p.shape[bdim] % block:
                    full[k] = shards[k]
                else:
                    shape = tuple(p.shape)
                z = torch.zeros(shape, dtype=torch.float32,
                                device=p.device).movedim(bdim, -1)
                mu[k] = quantize_signed(z, block)
                nu[k] = quantize_sqrt(z, block)
            else:
                mu[k], nu[k] = torch.zeros_like(p), torch.zeros_like(p)
        return cls(count=0, mu=mu, nu=nu, block=block, axes=axes,
                   shards={k: a for k, (a, _) in shards.items()}, full=full)

    def direction(self, name: str, g: torch.Tensor, count: int, b1: float,
                  b2: float, eps: float) -> torch.Tensor:
        """Dequantize `name`'s moments, update them with `g` at Adam step
        `count` (1-based), store them quantized again, and return the
        float32 direction mu_hat / (sqrt(nu_hat) + eps)."""
        mu_leaf, nu_leaf = self.mu[name], self.nu[name]
        quant = isinstance(mu_leaf, QuantLeaf)
        axis = self.axes.get(name, -1) if quant else -1
        whole = self.full.get(name)
        if whole is not None:
            from ..parallel.collectives import raw_all_gather
            g = raw_all_gather(g, whole[0], whole[1])
        g32 = g.float().movedim(axis, -1)
        mu = (dequantize_signed(mu_leaf, self.block) if quant
              else mu_leaf.float())
        nu = (dequantize_sqrt(nu_leaf, self.block) if quant
              else nu_leaf.float())
        mu = b1 * mu + (1.0 - b1) * g32
        nu = b2 * nu + (1.0 - b2) * g32 * g32
        # bias corrections in float32, as JAX computes them
        one, n = np.float32(1.0), np.float32(count)
        mu_hat = mu / float(one - np.float32(b1) ** n)
        nu_hat = nu / float(one - np.float32(b2) ** n)
        out = mu_hat / (torch.sqrt(nu_hat) + eps)
        if quant:
            self.mu[name] = quantize_signed(mu, self.block)
            self.nu[name] = quantize_sqrt(nu, self.block)
        else:
            mu_leaf.copy_(mu)
            nu_leaf.copy_(nu)
        out = out.movedim(-1, axis)
        if whole is not None:
            ax, dim = whole
            n = out.shape[dim] // ax.size
            out = out.narrow(dim, ax.index * n, n)
        return out

    def state_dict(self) -> Dict:
        def flat(tree):
            return {k: ({"q": v.q, "scale": v.scale}
                        if isinstance(v, QuantLeaf) else v)
                    for k, v in tree.items()}
        return {"count": self.count, "block": self.block,
                "mu": flat(self.mu), "nu": flat(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, d: Dict) -> None:
        """Copy saved moments into this state's tensors (their devices
        stay); the parameter names and formats must match."""
        for key in ("mu", "nu"):
            mine, saved = getattr(self, key), d[key]
            if set(mine) != set(saved):
                raise KeyError(f"optimizer state {key}: saved names differ "
                               f"from the model's: "
                               f"{sorted(set(mine) ^ set(saved))[:8]}")
            for name, t in mine.items():
                if isinstance(t, QuantLeaf):
                    t.q.copy_(saved[name]["q"])
                    t.scale.copy_(saved[name]["scale"])
                else:
                    t.copy_(saved[name])
        self.count = int(d["count"])


def state_bytes(state) -> int:
    """Bytes held by an optimizer state's moments (QuantLeaf-aware)."""
    total = 0
    for tree in (state.mu, state.nu):
        for v in tree.values():
            for t in ((v.q, v.scale) if isinstance(v, QuantLeaf) else (v,)):
                total += t.numel() * t.element_size()
    return total
