"""Tensor- and expert-parallel serving: the placements of
`mesh.llava_param_shardings` and `mesh.ep_param_shardings` applied to a
loaded model, in place (the port's side of JAX's `jax.device_put(params,
shardings)` in serve/model_worker.py and cli/eval_mm.py).

JAX places the arrays and XLA inserts the collectives. Here every rank
runs the same calls on the same (replicated) tokens and holds its part of
each sharded weight (`apply_shardings`, each fused projection part by
part), and the modules do the collectives themselves:

- an attention whose projections shard holds its heads' rows of q, k
  and v, its columns of `o_proj` and a KV cache of its KV heads; its
  output sums over the axis before `o_proj`'s bias. Otherwise the
  attention and its cache replicate;
- an MLP whose projections shard holds its intermediate features' rows
  and `down_proj`'s columns, summed the same way;
- a sharded `lm_head` is column-parallel: each rank computes its block
  of the vocabulary and the logits are gathered before sampling;
- a quantized projection (`QuantDense`: `kernel_q`, `scale`) replicates,
  as JAX's spec shards only `kernel` and `bias`, and its output is not
  summed;
- a MoE FFN's expert banks shard over 'model' (JAX's spec) and dispatch
  by all-to-all over that axis (`expert_parallel`, tokens replicated);
- the vision tower and projector replicate.

The 'data' axis of a tensor-parallel mesh splits the slots of the
engine's KV cache (`kv_cache_sharding`); the weights replicate over it.

`shard_llava_ep` is expert-parallel serving: every expert bank of the
tower, projector and (Mixtral) decoder keeps this rank's shard, the rest
replicates, and `set_ep_mesh(..., replicated_tokens=True)` makes the MoE
layers dispatch this rank's block of the (replicated) tokens by
all-to-all and gather the outputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from .mesh import (Mesh, decoder_param_shardings, ep_param_shardings,
                   llava_param_shardings, split_entry)


@torch.no_grad()
def apply_shardings(model: nn.Module, specs: Dict[str, Tuple],
                    mesh: Mesh) -> None:
    """Keep this rank's part of every parameter `specs` shards (specs of
    the unplaced model, by name), in place; an nn.Linear's feature
    counts follow its weight."""
    for mname, mod in model.named_modules():
        for pname, t in list(mod._parameters.items()):
            spec = specs.get(f"{mname}.{pname}" if mname else pname, ())
            for dim, entry in enumerate(spec):
                if entry is not None:
                    axis = mesh.axis(getattr(entry, "axis", entry))
                    t = split_entry(t, dim, entry, axis)
                    setattr(mod, pname, nn.Parameter(t, requires_grad=False))
        if isinstance(mod, nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape


def _row_parallel(module: nn.Module, proj: nn.Linear, axis) -> None:
    """`module`'s output sums over `axis` after `proj`, then adds `proj`'s
    bias (taken off the projection: it adds once)."""
    module.tp_axis = axis
    if proj.bias is not None:
        module.out_bias = proj.bias.detach()
        proj.bias = None


@torch.no_grad()
def shard_decoder(decoder, mesh: Mesh, specs=None) -> None:
    """Tensor-parallel placement of a DecoderLM over `mesh`'s 'model'
    axis, in place: `decoder_param_shardings` (or `specs`, the decoder's
    share of a larger model's) applied, and each module whose row-parallel
    projection sharded told to sum over the axis (see the module's
    docstring)."""
    axis = mesh.axis("model")
    if axis.group is None:
        return
    if specs is None:
        specs = decoder_param_shardings(mesh, decoder)
    apply_shardings(decoder, specs, mesh)
    for i, layer in enumerate(decoder.layers):
        attn = layer.self_attn
        if specs.get(f"layers.{i}.self_attn.o_proj.weight"):
            _row_parallel(attn, attn.o_proj, axis)
            attn.n_heads //= axis.size
            attn.n_kv_heads //= axis.size
            attn.head_offset = axis.index * attn.n_heads
        mlp = getattr(layer, "mlp", None)
        if mlp is not None and specs.get(f"layers.{i}.mlp.down_proj.weight"):
            _row_parallel(mlp, mlp.down_proj, axis)
    if specs.get("lm_head.weight"):
        decoder.head_axis = axis


def shard_llava(model, mesh: Mesh):
    """`llava_param_shardings` applied: the decoder tensor-parallel over
    'model', the tower and projector replicated. A MoE decoder's banks
    dispatch over 'model' (`set_ep_mesh(mesh, expert_axis='model',
    replicated_tokens=True)`, which this enters for the process). The
    mesh is kept as `model.tp_mesh`; a placed model is left as it is."""
    if getattr(model, "tp_mesh", None) is not None:
        return model
    model.tp_mesh = mesh
    prefix = "language_model."
    specs = llava_param_shardings(mesh, model)
    shard_decoder(model.language_model, mesh,
                  {k[len(prefix):]: v for k, v in specs.items()
                   if k.startswith(prefix)})
    if model.language_model.cfg.moe_name is not None:
        from .ep_context import set_ep_mesh
        set_ep_mesh(mesh, data_axis="data", expert_axis="model",
                    replicated_tokens=True)
    _drop_programs(model)
    return model


def shard_llava_ep(model, mesh: Mesh):
    """`ep_param_shardings` applied: every expert bank keeps this rank's
    shard over 'expert', the rest replicates; the process's MoE layers
    then dispatch by all-to-all (`set_ep_mesh`, tokens replicated)."""
    from .ep_context import set_ep_mesh
    if mesh.axis("expert").group is not None:
        apply_shardings(model, ep_param_shardings(mesh, model), mesh)
    set_ep_mesh(mesh, replicated_tokens=True)
    _drop_programs(model)
    return model


def _drop_programs(model) -> None:
    """Captured solo programs were taken before the placement."""
    caches = getattr(model, "_solo_caches", None)
    if caches is not None:
        model._solo_caches = None

