"""Model configuration from HF-style config dicts, random weights from a
seed, and the serving-time weight quantizers (port of the config and
quantization parts of competesmoe_tpu/models/builder.py; the checkpoint
loader waits).

The quantizers work in place on the port's modules and on whatever device
the weights live, computing exactly what the JAX builder computes on its
param trees:
  * `quantize_decoder_to_int8(decoder, bits)` swaps every decoder
    projection for a `QuantDense` (per-output-channel int8, or int4
    nibble-packed in the split-half layout; the lm_head stays int8);
  * `quantize_int8_weight_only(module)` rounds every large 2-D weight onto
    the per-output-channel int8 grid, storage dtype unchanged;
  * `quantize_nf4_weight_only(module)` rounds every large 2-D weight onto
    the NF4 grid with per-64-value absmax scales, in the flax [in, out]
    element order, storage dtype unchanged.
`apply_load_8bit` and `apply_load_4bit` are the worker's `--load-8bit` and
`--load-4bit`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn

from ..moe.config import MoEArgs
from .decoder import DecoderConfig, QuantDense, RMSNorm, pack_int4
from .llava import LlavaConfig, LlavaModel
from .projector import ProjectorConfig
from .vision import VisionConfig

# The CompeteSMoE-5.1B geometry (tools/bench_e2e_mm.py): SigLIP-so400m
# tower (27 layers, d 1152) with MoE MLPs, MoE projector, Phi-3.5-mini
# decoder (32 layers, d 3072, vocab 32064); 4 experts, top-2, routed by
# CompeteSMoE.
HF_5P1B = dict(
    model_type="llava_phi", vocab_size=32064, hidden_size=3072,
    intermediate_size=8192, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=32, rms_norm_eps=1e-5,
    max_position_embeddings=131072,
    original_max_position_embeddings=4096,
    mm_hidden_size=1152, mm_projector_type="moe", moe_name="competesmoe",
    num_experts=4, num_selected=2, clip_smoe=True, mlp_smoe=True,
    scales=[1],
    vision_config=dict(hidden_size=1152, intermediate_size=4304,
                       num_hidden_layers=27, num_attention_heads=16,
                       image_size=224, patch_size=14),
    tokenizer_model_max_length=2048)


def decoder_config_from_hf(cfg: Dict, model_name: str = "",
                           dtype: torch.dtype = torch.bfloat16
                           ) -> DecoderConfig:
    name = model_name.lower()
    fused = not any(k in name for k in ("mistral", "llama", "smollm",
                                        "mixtral"))
    if cfg.get("model_type") in ("mistral", "llama", "mixtral"):
        fused = False
    rs = cfg.get("rope_scaling") or {}
    moe_kw = {}
    if cfg.get("model_type") == "mixtral" or "num_local_experts" in cfg:
        moe_kw = dict(moe_name="mixtral",
                      num_experts=cfg.get("num_local_experts", 8),
                      num_selected=cfg.get("num_experts_per_tok", 2),
                      moe_args=moe_args_from_hf(cfg))
    return DecoderConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads",
                                    cfg["num_attention_heads"]),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        original_max_position_embeddings=cfg.get(
            "original_max_position_embeddings",
            cfg.get("max_position_embeddings", 4096)),
        rope_scaling_type=rs.get("type") or rs.get("rope_type"),
        rope_short_factor=tuple(rs["short_factor"])
        if "short_factor" in rs else None,
        rope_long_factor=tuple(rs["long_factor"])
        if "long_factor" in rs else None,
        sliding_window=cfg.get("sliding_window"),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        fused_qkv=fused, dtype=dtype, **moe_kw)


def moe_args_from_hf(cfg: Dict) -> MoEArgs:
    return MoEArgs(
        balance_loss_coef=cfg.get("balance_loss_coef", 0.01),
        router_z_loss_coef=cfg.get("router_z_loss_coef", 0.001),
        rate_flip=cfg.get("rate_flip", 0.05),
        warm_up=cfg.get("warm_up", 0.0),
        max_compete_in_iter=cfg.get("max_compete_in_iter", 2),
        router_loss_coef=cfg.get("router_loss_coef", 0.01),
        diversity_loss_coef=cfg.get("diversity_loss_coef", 0.01),
        bal_comp_loss_coef=cfg.get("bal_comp_loss_coef", 0.01),
        router_theta=cfg.get("router_theta", 1.0),
        hybrid=cfg.get("hybrid", False))


def llava_config_from_hf(cfg: Dict, model_name: str = "",
                         dtype: torch.dtype = torch.bfloat16
                         ) -> LlavaConfig:
    vision_cfg_d = cfg.get("vision_config", {})
    moe_name = cfg.get("moe_name", "smoe")
    moe_args = moe_args_from_hf(cfg)
    clip_smoe = cfg.get("clip_smoe", True)
    mlp_smoe = cfg.get("mlp_smoe", True)
    tower_name = str(cfg.get("mm_vision_tower", "")).lower()
    is_clip = "clip" in tower_name and "siglip" not in tower_name
    defaults = ((1024, 4096, 24, 16, 336) if is_clip
                else (1152, 4304, 27, 16, 224))
    vis = VisionConfig(
        hidden_size=vision_cfg_d.get("hidden_size", defaults[0]),
        intermediate_size=vision_cfg_d.get("intermediate_size",
                                           defaults[1]),
        num_hidden_layers=vision_cfg_d.get("num_hidden_layers",
                                           defaults[2]),
        num_attention_heads=vision_cfg_d.get("num_attention_heads",
                                             defaults[3]),
        image_size=vision_cfg_d.get("image_size", defaults[4]),
        patch_size=vision_cfg_d.get("patch_size", 14),
        layer_norm_eps=vision_cfg_d.get(
            "layer_norm_eps", 1e-5 if is_clip else 1e-6),
        hidden_act=vision_cfg_d.get(
            "hidden_act", "quick_gelu" if is_clip else "gelu_tanh"),
        use_cls_token=is_clip,
        tower_type="clip" if is_clip else "siglip",
        moe_name=moe_name if clip_smoe else None,
        num_experts=cfg.get("num_experts", 4),
        num_selected=cfg.get("num_selected", 2),
        moe_args=moe_args, dtype=dtype)
    scales = cfg.get("scales", [1])
    proj = ProjectorConfig(
        projector_type=cfg.get("mm_projector_type",
                               "moe" if mlp_smoe else "mlp2x_gelu"),
        mm_hidden_size=cfg.get("mm_hidden_size", vis.hidden_size),
        hidden_size=cfg["hidden_size"], n_scales=len(scales),
        moe_name=moe_name, num_experts=cfg.get("num_experts", 4),
        num_selected=cfg.get("num_selected", 2), moe_args=moe_args,
        dtype=dtype)
    dec = decoder_config_from_hf(cfg, model_name, dtype)
    merge = cfg.get("mm_patch_merge_type", "flat")
    if merge not in ("flat", None):
        raise NotImplementedError(
            f"mm_patch_merge_type={merge!r} is not supported (only the "
            "reference's shipped 'flat' layout is)")
    return LlavaConfig(
        vision=vis, projector=proj, decoder=dec,
        tokenizer_model_max_length=cfg.get("tokenizer_model_max_length",
                                           2048))


# ---------------------------------------------------------------------------
# Random weights
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0, std: float = 0.02
                 ) -> nn.Module:
    """Fill every parameter in place from a torch.Generator on the
    weights' device, one tensor at a time (no host round trip): norm
    weights 1, biases 0, other weights N(0, std). Build the model
    unquantized and quantize after (e.g. `apply_load_4bit`)."""
    g = None
    for mod in model.modules():
        for name, t in mod.named_parameters(recurse=False):
            if g is None:
                g = torch.Generator(device=t.device).manual_seed(seed)
            if isinstance(mod, (nn.LayerNorm, RMSNorm)) and name == "weight":
                t.fill_(1.0)
            elif name == "bias":
                t.zero_()
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=t.device,
                                    dtype=torch.float32) * std)
    return model


def build_llava(cfg: LlavaConfig, seed: int = 0, device=None) -> LlavaModel:
    """A LlavaModel with random weights from `seed`, built on `device`
    (cuda unless asked otherwise)."""
    return init_random_(LlavaModel(cfg, device=device), seed)


# ---------------------------------------------------------------------------
# Serving-time quantization (load_4bit)
# ---------------------------------------------------------------------------

_DECODER_QUANT_MODULES = ("qkv_proj", "q_proj", "k_proj", "v_proj",
                          "o_proj", "gate_up_proj", "gate_proj",
                          "up_proj", "down_proj", "lm_head")


@torch.no_grad()
def quantize_decoder_to_int8(decoder: nn.Module, bits: int = 8
                             ) -> nn.Module:
    """Replace the decoder's projections (nn.Linear, PallasDense among
    them) by QuantDense in place: per-output-channel symmetric int8, or
    with bits=4 int4 values in [-7, 7] nibble-packed in the split-half
    layout (the lm_head stays int8). Every projection but the lm_head
    keeps the decoder's `matvec_kernel`, as JAX's `_make_dense` passes it.
    Updates `decoder.cfg.quant`."""
    qmax = 7 if bits == 4 else 127
    matvec = bool(getattr(getattr(decoder, "cfg", None), "matvec_kernel",
                          False))
    for parent in list(decoder.modules()):
        for name, child in list(parent.named_children()):
            if name not in _DECODER_QUANT_MODULES or \
                    not isinstance(child, nn.Linear):
                continue
            int4 = bits == 4 and name != "lm_head"
            mq = qmax if int4 else 127
            w = child.weight.float().t()                     # [in, out]
            scale = torch.clamp(w.abs().amax(dim=0), min=1e-8) / mq
            q = torch.round(w / scale[None, :]).clamp(-mq, mq).to(torch.int8)
            qd = QuantDense(child.in_features, child.out_features,
                            mode="int4" if int4 else "int8",
                            use_bias=child.bias is not None,
                            device=w.device, dtype=child.weight.dtype,
                            matvec_kernel=matvec and name != "lm_head")
            qd.kernel_q.copy_(pack_int4(q) if int4 else q)
            qd.scale.copy_(scale)
            if child.bias is not None:
                qd.bias.copy_(child.bias)
            setattr(parent, name, qd)
    if hasattr(decoder, "cfg"):
        decoder.cfg = dataclasses.replace(
            decoder.cfg, quant="int4" if bits == 4 else "int8")
    return decoder


@torch.no_grad()
def quantize_int8_weight_only(module: nn.Module, min_size: int = 1024
                              ) -> nn.Module:
    """Round every nn.Linear / nn.Embedding weight with at least
    `min_size` values onto the per-output-channel symmetric int8 grid in
    place (scale = max|w| over each flax [in, out] column / 127), storage
    dtype unchanged, as the JAX builder's `quantize_int8_weight_only`."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)) and \
                mod.weight.numel() >= min_size:
            w = mod.weight.float()
            # flax columns: a Linear's outputs (rows of weight [out, in]),
            # an Embedding's features (columns of weight [vocab, dim])
            dim = 1 if isinstance(mod, nn.Linear) else 0
            scale = torch.clamp(w.abs().amax(dim=dim, keepdim=True) / 127.0,
                                min=1e-12)
            mod.weight.copy_(torch.round(w / scale).clamp(-127, 127) * scale)
    return module


_NF4_GRID = (-1.0, -0.6961928009986877, -0.5250730514526367,
             -0.39491748809814453, -0.28444138169288635,
             -0.18477343022823334, -0.09105003625154495, 0.0,
             0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
             0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
             0.7229568362236023, 1.0)


def _nf4_values(w: torch.Tensor, block: int) -> torch.Tensor:
    """Blockwise NF4 round trip of a float32 tensor (flattened order)."""
    grid = torch.tensor(_NF4_GRID, dtype=torch.float32, device=w.device)
    flat = w.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    absmax = torch.clamp(blocks.abs().amax(dim=1, keepdim=True), min=1e-12)
    idx = torch.argmin((blocks / absmax)[..., None].sub(grid).abs(), dim=-1)
    return (grid[idx] * absmax).reshape(-1)[:flat.numel()].reshape(w.shape)


@torch.no_grad()
def quantize_nf4_weight_only(module: nn.Module, block: int = 64,
                             min_size: int = 1024) -> nn.Module:
    """Round every nn.Linear / nn.Embedding weight with at least
    `min_size` values onto the NF4 grid in place (per-`block` absmax
    scaling), storage dtype unchanged. Blocks run over the flax [in, out]
    element order, so the values match the JAX builder's."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear) and mod.weight.numel() >= min_size:
            wt = mod.weight.float().t().contiguous()         # flax layout
            mod.weight.copy_(_nf4_values(wt, block).t())
        elif isinstance(mod, nn.Embedding) and \
                mod.weight.numel() >= min_size:
            mod.weight.copy_(_nf4_values(mod.weight.float(), block))
    return module


def apply_load_4bit(model: LlavaModel) -> LlavaModel:
    """The worker's `--load-4bit`: decoder to packed int4 (lm_head int8),
    vision tower and projector NF4 value-quantized. In place."""
    quantize_decoder_to_int8(model.language_model, bits=4)
    quantize_nf4_weight_only(model.vision_tower)
    quantize_nf4_weight_only(model.mm_projector)
    model.cfg = dataclasses.replace(model.cfg,
                                    decoder=model.language_model.cfg)
    return model


def apply_load_8bit(model: LlavaModel) -> LlavaModel:
    """The worker's `--load-8bit`: decoder to int8 QuantDense (lm_head
    included), vision tower and projector int8 value-quantized. In
    place."""
    quantize_decoder_to_int8(model.language_model, bits=8)
    quantize_int8_weight_only(model.vision_tower)
    quantize_int8_weight_only(model.mm_projector)
    model.cfg = dataclasses.replace(model.cfg,
                                    decoder=model.language_model.cfg)
    return model
