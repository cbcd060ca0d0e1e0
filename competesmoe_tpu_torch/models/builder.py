"""Model configuration from HF-style config dicts, random weights from a
seed, the checkpoint loader and the serving-time weight quantizers (port
of competesmoe_tpu/models/builder.py).

`load_pretrained_model(model_path, ...)` reads a released-layout
checkpoint directory (`config.json` and `*.safetensors` or `*.bin`
weights; a LoRA adapter over a base when the name says `lora`), converts
it with `convert_llava_checkpoint` and loads it into a `LlavaModel` built
on the meta device, so no weight is drawn and then overwritten.

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
import json
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from ..moe.config import MoEArgs
from ..multimodal.mm_utils import ImageProcessorConfig
from .decoder import DecoderConfig, QuantDense, RMSNorm, pack_int4
from .hf_loader import (ReadTracker, _strip_prefix, convert_clip_tower,
                        convert_decoder, convert_mlpmoe_projector,
                        convert_siglip_tower, load_torch_state_dict)
from .llava import LlavaConfig, LlavaModel
from .projector import ProjectorConfig
from .safetensors_io import load_file
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
    weights 1, biases (a MoE layer's `gate_bias` too, as JAX's zeros
    initializer) 0, other weights N(0, std). Build the model unquantized
    and quantize after (e.g. `apply_load_4bit`)."""
    g = None
    for mod in model.modules():
        for name, t in mod.named_parameters(recurse=False):
            if g is None:
                g = torch.Generator(device=t.device).manual_seed(seed)
            if isinstance(mod, (nn.LayerNorm, RMSNorm)) and name == "weight":
                t.fill_(1.0)
            elif name in ("bias", "gate_bias"):
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
def quantize_decoder_to_int8(decoder: nn.Module, bits: int = 8,
                             w8a8: bool = False) -> nn.Module:
    """Replace the decoder's projections (nn.Linear, PallasDense among
    them) by QuantDense in place: per-output-channel symmetric int8, or
    with bits=4 int4 values in [-7, 7] nibble-packed in the split-half
    layout (the lm_head stays int8). `w8a8` (bits 8) keeps the same int8
    weights and runs every projection, the lm_head too, in w8a8 mode,
    as JAX's model with quant='w8a8' runs the tree this function makes.
    Every projection but the lm_head keeps the decoder's `matvec_kernel`,
    as JAX's `_make_dense` passes it. Updates `decoder.cfg.quant`."""
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
            mode = "int4" if int4 else ("w8a8" if w8a8 else "int8")
            qd = QuantDense(child.in_features, child.out_features,
                            mode=mode, use_bias=child.bias is not None,
                            device=w.device, dtype=child.weight.dtype,
                            matvec_kernel=matvec and name != "lm_head")
            qd.kernel_q.copy_(pack_int4(q) if int4 else q)
            qd.scale.copy_(scale)
            if child.bias is not None:
                qd.bias.copy_(child.bias)
            setattr(parent, name, qd)
    if hasattr(decoder, "cfg"):
        decoder.cfg = dataclasses.replace(
            decoder.cfg,
            quant="int4" if bits == 4 else ("w8a8" if w8a8 else "int8"))
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


# ---------------------------------------------------------------------------
# Checkpoint loading (reference builder.py:29-184)
# ---------------------------------------------------------------------------

# Routers whose parameters JAX's converters do not read: the cosine gate's
# `inp_reduction` and `expert_embeddings`, the shared-expert gate [in, E-1]
UNLOADABLE_ROUTERS = ("xmoe", "smoe_perturbed", "smoe_share", "deepseekv3")


def check_loadable(cfg: LlavaConfig) -> None:
    """Refuse a checkpoint whose tower or projector router JAX's loader
    cannot give its parameters (ROADMAP §3): JAX's builder loads such a
    checkpoint, and its model then fails at the first forward."""
    used = {cfg.vision.moe_name}
    if cfg.projector.projector_type == "moe":
        used.add(cfg.projector.moe_name)
    bad = sorted(used & set(UNLOADABLE_ROUTERS))
    if bad:
        raise NotImplementedError(
            f"loading a checkpoint routed by {', '.join(bad)}: the JAX "
            "package's converters read no `inp_reduction` or "
            "`expert_embeddings` (xmoe, smoe_perturbed) and take the gate "
            "as [in, E] where the shared-expert routers have [in, E-1] "
            "(smoe_share, deepseekv3), so its loaded model fails at its "
            "first forward (ROADMAP §3); build the model from its config "
            "(`build_llava`) instead")


def convert_llava_checkpoint(sd, cfg: LlavaConfig) -> Dict[str, torch.Tensor]:
    """Released-checkpoint state dict -> `LlavaModel` state dict (a router
    of `UNLOADABLE_ROUTERS` is refused, `check_loadable`)."""
    check_loadable(cfg)
    vision_sd = _strip_prefix(sd, "model.vision_tower.vision_tower.")
    proj_sd = _strip_prefix(sd, "model.mm_projector.")
    convert_tower = (convert_clip_tower if cfg.vision.tower_type == "clip"
                     else convert_siglip_tower)
    parts = {
        "vision_tower": convert_tower(vision_sd, cfg.vision, prefix=""),
        "mm_projector": convert_mlpmoe_projector(
            proj_sd, cfg.projector.num_experts, prefix="")
        if cfg.projector.projector_type == "moe" else
        _convert_plain_projector(proj_sd, cfg.projector),
        "language_model": convert_decoder(sd, cfg.decoder, prefix="model."),
    }
    return {f"{part}.{k}": v for part, psd in parts.items()
            for k, v in psd.items()}


def _convert_plain_projector(sd, pcfg: ProjectorConfig
                             ) -> Dict[str, torch.Tensor]:
    """A linear projector's `weight`/`bias`, or an mlpNx_gelu one's
    Sequential Linears (`0.`, `2.`, ...) as `mlp_0`, `mlp_1`, ... in
    Sequential order (JAX sorts the names as text, the same order below
    ten layers)."""
    if pcfg.projector_type == "linear":
        return {"fc.weight": sd["weight"], "fc.bias": sd["bias"]}
    seq = sorted((int(k.split(".")[0]) for k in sd if k.endswith(".weight")))
    out = {}
    for i, idx in enumerate(seq):
        out[f"mlp_{i}.weight"] = sd[f"{idx}.weight"]
        out[f"mlp_{i}.bias"] = sd[f"{idx}.bias"]
    return out


def merge_lora_checkpoint(base_sd, lora_path) -> Dict[str, torch.Tensor]:
    """Merge a PEFT LoRA checkpoint into the base state dict (the
    reference's PeftModel.from_pretrained + merge_and_unload, done as
    W <- W + (alpha / r) * B @ A in float32), after overlaying
    `non_lora_trainables.bin` (mm projector etc.) with the reference's
    prefix stripping. Merged and overlaid tensors come out float32 on
    the device of the base tensor they replace (or the CPU)."""
    lora_path = Path(lora_path)
    sd = dict(base_sd)
    some = next(iter(sd.values()), None)
    dev = some.device if some is not None else torch.device("cpu")

    nlt_file = lora_path / "non_lora_trainables.bin"
    if nlt_file.exists():
        nlt = torch.load(nlt_file, map_location="cpu", weights_only=True)
        nlt = {(k[len("base_model."):] if k.startswith("base_model.")
                else k): v for k, v in nlt.items()}
        if any(k.startswith("model.model.") for k in nlt):
            nlt = {(k[len("model."):] if k.startswith("model.") else k): v
                   for k, v in nlt.items()}
        for k, v in nlt.items():
            sd[k] = v.to(dev, torch.float32)

    acfg = json.loads((lora_path / "adapter_config.json").read_text())
    scaling = acfg["lora_alpha"] / acfg["r"]
    st_file = lora_path / "adapter_model.safetensors"
    if st_file.exists():
        adapter = load_file(st_file, dev)
    else:
        adapter = torch.load(lora_path / "adapter_model.bin",
                             map_location=dev, weights_only=True)
    merged = 0
    for k, a in adapter.items():
        if ".lora_A." not in k:
            continue
        b = adapter[k.replace(".lora_A.", ".lora_B.")]
        # peft keys: base_model.model.<target>.lora_{A,B}.weight
        target = k.split(".lora_A.")[0]
        for pre in ("base_model.model.", "base_model."):
            if target.startswith(pre):
                target = target[len(pre):]
                break
        wk = target + ".weight"
        if wk not in sd:
            raise KeyError(f"LoRA target {wk!r} not in base checkpoint")
        delta = scaling * (b.float() @ a.float())
        sd[wk] = sd[wk].float() + delta.to(sd[wk].device)
        merged += 1
    if merged == 0:
        raise ValueError(f"no lora_A/lora_B pairs found in {lora_path}")
    return sd


@torch.no_grad()
def _load_converted(model: nn.Module, sd: Dict[str, torch.Tensor],
                    device: torch.device) -> None:
    """Load a converted state dict into `model` (built on the meta device)
    by assignment, each tensor cast to its parameter's dtype on `device`;
    a missing, extra or misshapen tensor raises, naming it."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint does not fit the model: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"unexpected {extra[:8]}"
                       f"{'...' if len(extra) > 8 else ''}")
    bad = [(k, tuple(sd[k].shape), tuple(w.shape)) for k, w in want.items()
           if sd[k].shape != w.shape]
    if bad:
        raise ValueError(f"checkpoint shapes do not fit the model "
                         f"(name, checkpoint, model): {bad[:8]}")
    model.load_state_dict(
        {k: sd[k].to(device=device, dtype=w.dtype).contiguous()
         for k, w in want.items()}, strict=True, assign=True)
    left = [k for k, t in model.state_dict().items() if t.is_meta]
    if left:
        raise RuntimeError(f"tensors left unloaded: {left[:8]}")


def _tokenizer(model_path: Path):
    """The directory's HF tokenizer, or None when it holds no tokenizer
    files or `transformers` is absent (read from local files only)."""
    names = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model",
             "vocab.json")
    if not any((model_path / n).exists() for n in names):
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    return AutoTokenizer.from_pretrained(str(model_path),
                                         local_files_only=True)


def load_pretrained_model(model_path, model_name: Optional[str] = None,
                          model_base: Optional[str] = None,
                          load_8bit: bool = False, load_4bit: bool = False,
                          kv_quant: Optional[str] = None,
                          dtype: torch.dtype = torch.bfloat16, device=None
                          ) -> Tuple[object, LlavaModel, ImageProcessorConfig,
                                     int]:
    """(tokenizer, model, image_processor, context_len): the reference
    builder's return contract without JAX's separate params tree, since
    the module holds its weights.

    Reads `config.json` (from `model_base` for a LoRA adapter, whose own
    config.json wins when present), loads the weights on `device` (cuda
    unless the caller asks for another; no CPU fallback), merges a LoRA
    adapter when `model_name` contains 'lora' and `model_base` is given,
    converts and loads into a model built on the meta device (every
    parameter must come from the checkpoint; a checkpoint tensor that no
    parameter takes is named in a warning), then applies `load_8bit`
    (int8 decoder, tower and projector int8 value-quantized) or
    `load_4bit` (packed int4 decoder with an int8 lm_head, tower and
    projector NF4 value-quantized) and `kv_quant` ('int8' KV cache). The
    tokenizer is None when the directory holds none or `transformers` is
    absent."""
    if load_8bit and load_4bit:
        raise ValueError("load_8bit and load_4bit exclude each other")
    device = resolve_device(device)
    model_path = Path(model_path)
    model_name = model_name or model_path.name
    is_lora = "lora" in model_name.lower() and model_base is not None
    if "lora" in model_name.lower() and model_base is None:
        warnings.warn("`lora` is in the model name but no model_base was "
                      "provided (reference builder.py:52)")
    cfg_dir = Path(model_base) if is_lora else model_path
    cfg_file = model_path / "config.json"
    if not cfg_file.exists():
        cfg_file = cfg_dir / "config.json"
    hf_cfg = json.loads(cfg_file.read_text())
    cfg = llava_config_from_hf(hf_cfg, model_name, dtype)
    if kv_quant:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, kv_quant=kv_quant))
    sd = load_torch_state_dict(cfg_dir, device)
    if is_lora:
        sd = merge_lora_checkpoint(sd, model_path)
    sd = ReadTracker(sd)
    converted = convert_llava_checkpoint(sd, cfg)
    if sd.unread():
        warnings.warn(f"checkpoint tensors the model does not take: "
                      f"{sd.unread()[:8]}")
    del sd
    model = LlavaModel(cfg, device="meta")
    _load_converted(model, converted, device)
    del converted
    if load_8bit:
        apply_load_8bit(model)
    elif load_4bit:
        apply_load_4bit(model)
    image_processor = ImageProcessorConfig(size=cfg.vision.image_size)
    context_len = hf_cfg.get("max_sequence_length",
                             hf_cfg.get("tokenizer_model_max_length", 2048))
    return _tokenizer(model_path), model, image_processor, context_len
