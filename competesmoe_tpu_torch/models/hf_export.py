"""Port model -> HF checkpoint export (port of
competesmoe_tpu/models/hf_export.py; the inverse of `hf_loader`).

Writes the reference's released-checkpoint layout
(`model.vision_tower.vision_tower.*`, `model.mm_projector.*`,
`model.layers.*`, `lm_head.weight`), so a user of the reference loads
weights produced here with no glue code. The port's Linear, LayerNorm,
RMSNorm and conv weights already have the torch layouts and pass through;
the stacked experts (`experts_w1` [E, in, h] ...) unstack into
`moelayer.experts.<i>.(fc1|fc2)` (tower) or `moelayer.experts.<i>.(0|2)`
(projector Sequential), and `gate_kernel` [in, E] becomes `gate.weight`
[E, in]. Each tensor keeps its dtype and device: the exported dict holds
views of the model's weights, and `save_hf_checkpoint` writes them one at
a time. Export a model before quantizing it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from .decoder import DecoderConfig
from .safetensors_io import save_file
from .vision import VisionConfig

StateDict = Dict[str, torch.Tensor]


def _weights(module: nn.Module) -> Mapping[str, torch.Tensor]:
    sd = module.state_dict()
    quantized = [k for k in sd if k.endswith("kernel_q")]
    if quantized:
        raise ValueError(f"cannot export quantized weights ({quantized[0]}, "
                         "...): export the model before quantizing it")
    return sd


def _copy(out: StateDict, dst: str, sd: Mapping, src: str) -> None:
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def export_decoder(decoder: nn.Module, cfg: DecoderConfig,
                   prefix: str = "model.") -> StateDict:
    """`DecoderLM` -> HF llama-family state dict (inverse of
    hf_loader.convert_decoder)."""
    sd = _weights(decoder)
    out: StateDict = {prefix + "embed_tokens.weight":
                      sd["embed_tokens.weight"],
                      prefix + "norm.weight": sd["norm.weight"]}
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    for li in range(cfg.num_hidden_layers):
        p, q = f"layers.{li}.", f"{prefix}layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            _copy(out, q + n, sd, p + n)
        names = (("qkv_proj",) if cfg.fused_qkv
                 else ("q_proj", "k_proj", "v_proj")) + ("o_proj",)
        for n in names:
            _copy(out, q + f"self_attn.{n}", sd, p + f"self_attn.{n}")
        names = (("gate_up_proj",) if cfg.fused_qkv
                 else ("gate_proj", "up_proj")) + ("down_proj",)
        for n in names:
            _copy(out, q + f"mlp.{n}", sd, p + f"mlp.{n}")
    return out


def _unstack_expert_mlps(out: StateDict, sd: Mapping, src: str, dst: str,
                         sequential_naming: bool) -> None:
    """Inverse of hf_loader._stack_expert_mlps: `src` names the port's
    `moelayer.` tensors, `dst` the HF module. sequential_naming=True
    emits the projector's Sequential indices (0/2), else fc1/fc2."""
    w1, b1 = sd[src + "experts_w1"], sd[src + "experts_b1"]
    w2, b2 = sd[src + "experts_w2"], sd[src + "experts_b2"]
    n1, n2 = ("0", "2") if sequential_naming else ("fc1", "fc2")
    for i in range(w1.shape[0]):
        base = f"{dst}moelayer.experts.{i}."
        out[base + f"{n1}.weight"] = w1[i].t()
        out[base + f"{n1}.bias"] = b1[i]
        out[base + f"{n2}.weight"] = w2[i].t()
        out[base + f"{n2}.bias"] = b2[i]
    out[f"{dst}moelayer.gate.weight"] = sd[src + "gate_kernel"].t()


def export_siglip_tower(tower: nn.Module, cfg: VisionConfig,
                        prefix: str = "vision_model.") -> StateDict:
    """`SiglipSMoEVisionTower` -> SigLIP state dict (inverse of
    hf_loader.convert_siglip_tower)."""
    sd = _weights(tower)
    out: StateDict = {}
    _copy(out, prefix + "embeddings.patch_embedding", sd,
          "embeddings.patch_embedding")
    out[prefix + "embeddings.position_embedding.weight"] = \
        sd["embeddings.position_embedding"]
    for li in range(cfg.num_hidden_layers):
        p, q = f"layers.{li}.", f"{prefix}encoder.layers.{li}."
        for n in ("layer_norm1", "layer_norm2"):
            _copy(out, q + n, sd, p + n)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _copy(out, q + f"self_attn.{n}", sd, p + f"self_attn.{n}")
        if cfg.moe_name is None:
            for n in ("fc1", "fc2"):
                _copy(out, q + f"mlp.{n}", sd, p + f"mlp.{n}")
        else:
            _unstack_expert_mlps(out, sd, p + "moelayer.", q,
                                 sequential_naming=False)
    return out


def export_mlpmoe_projector(projector: nn.Module,
                            prefix: str = "mm_projector.") -> StateDict:
    """MoE `VisionProjector` -> `moelayer.experts.<i>.{0,2}` state dict
    (inverse of hf_loader.convert_mlpmoe_projector)."""
    out: StateDict = {}
    _unstack_expert_mlps(out, _weights(projector), "moelayer.", prefix,
                         sequential_naming=True)
    return out


def export_plain_projector(projector: nn.Module,
                           prefix: str = "mm_projector.") -> StateDict:
    """Linear (or identity) `VisionProjector` -> its state dict."""
    sd = _weights(projector)
    if projector.cfg.projector_type == "identity":
        return {}
    if projector.cfg.projector_type != "linear":
        raise NotImplementedError(
            f"projector type {projector.cfg.projector_type!r} is not "
            "ported: ROADMAP §1 item 1.2 (the mlpNx_gelu projector)")
    return {prefix + "weight": sd["fc.weight"], prefix + "bias": sd["fc.bias"]}


def export_llava_checkpoint(model: nn.Module, cfg=None) -> StateDict:
    """`LlavaModel` -> the released-5.1B flat state-dict layout."""
    cfg = cfg or model.cfg
    out: StateDict = {}
    out.update(export_siglip_tower(model.vision_tower, cfg.vision,
                                   prefix="model.vision_tower.vision_tower."))
    if cfg.projector.projector_type == "moe":
        out.update(export_mlpmoe_projector(model.mm_projector,
                                           prefix="model.mm_projector."))
    else:
        out.update(export_plain_projector(model.mm_projector,
                                          prefix="model.mm_projector."))
    out.update(export_decoder(model.language_model, cfg.decoder,
                              prefix="model."))
    return out


def save_hf_checkpoint(model: nn.Module, cfg, out_dir,
                       hf_config: Optional[dict] = None) -> Path:
    """Write `model.safetensors` (and `config.json` when `hf_config` is
    given) in the reference layout; the result loads with
    `builder.load_pretrained_model` and with the reference's loading
    path. Unlike JAX's writer, which widens bf16 to float32 because numpy
    has no bf16, each tensor keeps its dtype; the values are the same."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        path = save_file(export_llava_checkpoint(model, cfg),
                         out_dir / "model.safetensors")
    if hf_config is not None:
        (out_dir / "config.json").write_text(json.dumps(hf_config,
                                                        indent=1))
    return path
