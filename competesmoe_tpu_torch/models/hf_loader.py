"""HF checkpoint -> port state dict conversion (port of
competesmoe_tpu/models/hf_loader.py).

Covers the weight-loading paths of the reference's builder for what the
port models:
- decoder LMs of the llama family (Phi-3.5 fused, Llama / Mistral /
  SmolLM split projections), Mixtral's MoE decoder (`block_sparse_moe`)
  and MPT (`convert_mpt`);
- the SigLIP and CLIP vision towers, dense or MoE, including sparse
  upcycling (a dense MLP replicated into every expert, a fresh N(0, 0.02)
  gate) and the already-MoE layout of the released CompeteSMoE-5.1B
  (`moelayer.experts.<i>`);
- the MoE projector, trained or upcycled from a dense 2-layer one.

Each converter takes a flat {name: tensor} state dict (from
`load_torch_state_dict`) and returns a port `state_dict` under the names
of the port's modules, in the layouts `convert.py` documents: HF
[out, in] Linear weights, LayerNorm weights and conv weights
[out, in, kh, kw] pass through unchanged; expert MLPs are stacked as
`experts_w1` [E, in, h], `experts_b1` [E, h], `experts_w2` [E, h, out],
`experts_b2` [E, out]; `gate.weight` [E, in] becomes `gate_kernel`
[in, E]; Mixtral's `experts.<j>.w1|w3|w2.weight` stack transposed into
`experts_w1` / `experts_w3` [E, d, h] and `experts_w2` [E, h, d], one
layer at a time, each expert's tensor released from a `ReadTracker` as
soon as it is stacked (so a loaded checkpoint is never held twice on the
device). Tensors stay on their device and in their dtype; the fresh gates
of upcycling are float32, drawn from `np.random.default_rng(42)` in JAX's
order, so both packages draw the same values.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from .decoder import DecoderConfig
from .safetensors_io import load_file
from .vision import VisionConfig

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path, device: Optional[Union[str, torch.device]]
                          = None) -> StateDict:
    """{name: tensor} of a `.safetensors` or `.bin` file, or of a
    directory's sorted `*.safetensors` shards (else its sorted `*.bin`
    files, read with `torch.load(weights_only=True)`), each tensor on
    `device` (the CPU when None) in its stored dtype."""
    p = Path(path)
    if p.is_dir():
        files = sorted(p.glob("*.safetensors")) or sorted(p.glob("*.bin"))
        if not files:
            found = sorted(f.name for f in p.iterdir())
            raise FileNotFoundError(
                f"{p} holds no *.safetensors or *.bin weights (found: "
                f"{', '.join(found) or 'nothing'})")
    elif p.exists():
        files = [p]
    else:
        raise FileNotFoundError(f"no checkpoint at {p}")
    out: StateDict = {}
    for f in files:
        if f.suffix == ".safetensors":
            out.update(load_file(f, device))
        else:
            sd = torch.load(f, map_location="cpu", weights_only=True,
                            mmap=True)
            dev = torch.device("cpu" if device is None else device)
            out.update({k: v.to(dev, copy=True) for k, v in sd.items()})
    return out


class _Prefixed(Mapping):
    """The entries of a state dict under `prefix`, with the prefix taken
    off their names: a view, so every lookup reads the parent."""

    def __init__(self, sd: Mapping, prefix: str):
        self._sd, self._prefix = sd, prefix

    def __getitem__(self, key: str):
        return self._sd[self._prefix + key]

    def release(self, key: str) -> None:
        _release(self._sd, self._prefix + key)

    def __contains__(self, key) -> bool:
        return self._prefix + key in self._sd

    def __iter__(self):
        n = len(self._prefix)
        return (k[n:] for k in self._sd if k.startswith(self._prefix))

    def __len__(self) -> int:
        return sum(1 for _ in self)


class ReadTracker(dict):
    """A state dict that records the names read from it, so a loader can
    tell which tensors of a checkpoint no converter took."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key: str):
        self.read.add(key)
        return super().__getitem__(key)

    def release(self, key: str) -> None:
        """Drop a tensor that has been read (and copied), so that its
        memory can go before the conversion ends."""
        self.read.add(key)
        self.pop(key, None)

    def unread(self):
        return sorted(set(self) - self.read)


def _release(sd: Mapping, key: str) -> None:
    """Release `key` from a state dict that can (`ReadTracker`)."""
    release = getattr(sd, "release", None)
    if release is not None:
        release(key)


def _strip_prefix(sd: Mapping, prefix: str) -> Mapping:
    return _Prefixed(sd, prefix) if prefix else sd


def _copy(out: StateDict, dst: str, m: Mapping, src: str) -> None:
    """An HF Linear or norm (weight, and bias when it has one) as it is."""
    out[f"{dst}.weight"] = m[f"{src}.weight"]
    if f"{src}.bias" in m:
        out[f"{dst}.bias"] = m[f"{src}.bias"]


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.t().contiguous()


def _fresh_gate(rng: np.random.Generator, in_dim: int, n_experts: int,
                like: torch.Tensor) -> torch.Tensor:
    """N(0, 0.02) [in, E] float32 on `like`'s device (JAX's draw)."""
    g = rng.normal(0.0, 0.02, (in_dim, n_experts)).astype(np.float32)
    return torch.from_numpy(g).to(like.device)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def convert_decoder(sd: Mapping, cfg: DecoderConfig,
                    prefix: str = "model.") -> StateDict:
    """HF llama-family state dict -> `DecoderLM` state dict."""
    m = _strip_prefix(sd, prefix)
    out: StateDict = {"embed_tokens.weight": m["embed_tokens.weight"],
                      "norm.weight": m["norm.weight"]}
    if not cfg.tie_word_embeddings:
        head_key = "lm_head.weight"
        if head_key in sd:
            out[head_key] = sd[head_key]
        elif head_key in m:
            out[head_key] = m[head_key]
        else:
            raise KeyError("lm_head.weight not found")
    for li in range(cfg.num_hidden_layers):
        p = f"layers.{li}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            _copy(out, p + n, m, p + n)
        names = (("qkv_proj",) if cfg.fused_qkv
                 else ("q_proj", "k_proj", "v_proj")) + ("o_proj",)
        for n in names:
            _copy(out, p + f"self_attn.{n}", m, p + f"self_attn.{n}")
        if (p + "block_sparse_moe.gate.weight") in m:
            out.update(_convert_mixtral_block(m, p, cfg.num_experts))
            continue
        names = (("gate_up_proj",) if cfg.fused_qkv
                 else ("gate_proj", "up_proj")) + ("down_proj",)
        for n in names:
            _copy(out, p + f"mlp.{n}", m, p + f"mlp.{n}")
    return out


def _convert_mixtral_block(m: Mapping, p: str, n_experts: int) -> StateDict:
    """HF Mixtral's `block_sparse_moe` of layer prefix `p` -> the port's
    `moe.` tensors (the reference keeps these exact tensors and rewires
    only the forward): each expert's [out, in] weight transposed into
    one stacked tensor, its sources released as soon as it is built."""
    bp = p + "block_sparse_moe."
    out = {f"{p}moe.gate_kernel": _t(m[bp + "gate.weight"])}
    for w in ("w1", "w3", "w2"):
        keys = [f"{bp}experts.{j}.{w}.weight" for j in range(n_experts)]
        out[f"{p}moe.experts_{w}"] = torch.stack([m[k].t() for k in keys])
        for k in keys:
            _release(m, k)
    return out


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def _stack_expert_mlps(get, n_experts: int) -> StateDict:
    """Stack per-expert fc1/fc2 (or Sequential 0/2) into the port's
    expert tensors."""
    def stack(fc, kind, transpose):
        ts = [get(i, fc, kind) for i in range(n_experts)]
        return torch.stack([t.t() if transpose else t for t in ts])
    return {"experts_w1": stack("fc1", "weight", True),
            "experts_b1": stack("fc1", "bias", False),
            "experts_w2": stack("fc2", "weight", True),
            "experts_b2": stack("fc2", "bias", False)}


def convert_siglip_tower(sd: Mapping, cfg: VisionConfig,
                         prefix: str = "vision_model.",
                         upcycle: bool = False,
                         rng: Optional[np.random.Generator] = None
                         ) -> StateDict:
    """SigLIP vision state dict -> `SiglipSMoEVisionTower` state dict.

    upcycle=True: the state dict is a *dense* tower; each block's MLP is
    replicated into all experts and a fresh N(0, 0.02) gate is drawn.
    Otherwise a MoE tower reads `moelayer.experts.<i>.(fc1|fc2)` keys
    (trained MoE checkpoints, e.g. the released 5.1B)."""
    m = _strip_prefix(sd, prefix)
    rng = rng or np.random.default_rng(42)
    out: StateDict = {
        "embeddings.patch_embedding.weight":
            m["embeddings.patch_embedding.weight"],
        "embeddings.patch_embedding.bias":
            m["embeddings.patch_embedding.bias"],
        "embeddings.position_embedding":
            m["embeddings.position_embedding.weight"],
    }
    _convert_vision_layers(m, cfg, out, upcycle, rng)
    return out


def _convert_vision_layers(m: Mapping, cfg: VisionConfig, out: StateDict,
                           upcycle: bool, rng: np.random.Generator) -> None:
    """HF `encoder.layers.<i>` blocks into the port's `layers.<i>`, with
    dense MLPs kept, replicated into all experts (upcycling), or read
    from a trained `moelayer.experts.<i>` checkpoint."""
    for li in range(cfg.num_hidden_layers):
        src, dst = f"encoder.layers.{li}.", f"layers.{li}."
        for n in ("layer_norm1", "layer_norm2"):
            _copy(out, dst + n, m, src + n)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _copy(out, dst + f"self_attn.{n}", m, src + f"self_attn.{n}")
        if cfg.moe_name is None:
            for n in ("fc1", "fc2"):
                _copy(out, dst + f"mlp.{n}", m, src + f"mlp.{n}")
            continue
        if upcycle:
            def get(i, fc, kind, src=src):
                return m[f"{src}mlp.{fc}.{kind}"]
        else:
            def get(i, fc, kind, src=src):
                return m[f"{src}moelayer.experts.{i}.{fc}.{kind}"]
        moe = _stack_expert_mlps(get, cfg.num_experts)
        gate_key = f"{src}moelayer.gate.weight"
        if gate_key in m and not upcycle:
            moe["gate_kernel"] = _t(m[gate_key])
        else:
            moe["gate_kernel"] = _fresh_gate(
                rng, cfg.hidden_size, cfg.num_experts, moe["experts_w1"])
        out.update({f"{dst}moelayer.{k}": v for k, v in moe.items()})


def convert_clip_tower(sd: Mapping, cfg: VisionConfig,
                       prefix: str = "vision_model.", upcycle: bool = False,
                       rng: Optional[np.random.Generator] = None
                       ) -> StateDict:
    """CLIP vision state dict -> `CLIPSMoEVisionTower` state dict: the
    SigLIP conversion with CLIP's class token
    (`embeddings.class_embedding`, a bare [D] parameter), bias-free patch
    conv, P+1 positions and `pre_layrnorm`; a state dict nested under
    `vision_model.` (HF CLIPVisionModel) is read through it."""
    m = _strip_prefix(sd, prefix)
    if ("embeddings.class_embedding" not in m
            and any(k.startswith("vision_model.") for k in m)):
        m = _Prefixed(m, "vision_model.")
    rng = rng or np.random.default_rng(42)
    out: StateDict = {
        "embeddings.patch_embedding.weight":
            m["embeddings.patch_embedding.weight"],
        "embeddings.class_embedding": m["embeddings.class_embedding"],
        "embeddings.position_embedding":
            m["embeddings.position_embedding.weight"],
    }
    _copy(out, "pre_layrnorm", m, "pre_layrnorm")
    _convert_vision_layers(m, cfg, out, upcycle, rng)
    return out


# ---------------------------------------------------------------------------
# Projector
# ---------------------------------------------------------------------------

def convert_mlpmoe_projector(sd: Mapping, n_experts: int,
                             prefix: str = "mm_projector.",
                             upcycle_from: Optional[Mapping] = None,
                             rng: Optional[np.random.Generator] = None
                             ) -> StateDict:
    """MoE projector weights -> the `VisionProjector` state dict
    (`moelayer.*`).

    Trained layout: `moelayer.experts.<i>.{0,2}.weight/bias` (Sequential
    Linear-GELU-Linear). upcycle_from: a dense 2-layer projector state
    dict (`0.weight`, `2.weight`, ...) replicated into every expert, with
    a fresh gate."""
    rng = rng or np.random.default_rng(42)
    m = _strip_prefix(sd, prefix)

    def idx(fc):
        return "0" if fc == "fc1" else "2"

    if upcycle_from is not None:
        def get(i, fc, kind):
            return upcycle_from[f"{idx(fc)}.{kind}"]
    else:
        def get(i, fc, kind):
            return m[f"moelayer.experts.{i}.{idx(fc)}.{kind}"]
    moe = _stack_expert_mlps(get, n_experts)
    gate_key = "moelayer.gate.weight"
    if gate_key in m and upcycle_from is None:
        moe["gate_kernel"] = _t(m[gate_key])
    else:
        moe["gate_kernel"] = _fresh_gate(
            rng, moe["experts_w1"].shape[1], n_experts, moe["experts_w1"])
    return {f"moelayer.{k}": v for k, v in moe.items()}


def convert_mpt(sd: Mapping, cfg: DecoderConfig,
                prefix: str = "transformer.") -> StateDict:
    """HF MptForCausalLM state dict -> `DecoderLM` state dict for an MPT
    config (fused Wqkv, bias-free LayerNorm, ALiBi, GELU FFN, usually
    tied embeddings)."""
    m = _strip_prefix(sd, prefix)
    out: StateDict = {"embed_tokens.weight": m["wte.weight"],
                      "norm.weight": m["norm_f.weight"]}
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    for li in range(cfg.num_hidden_layers):
        p, q = f"blocks.{li}.", f"layers.{li}."
        out[q + "input_layernorm.weight"] = m[p + "norm_1.weight"]
        out[q + "post_attention_layernorm.weight"] = m[p + "norm_2.weight"]
        out[q + "self_attn.qkv_proj.weight"] = m[p + "attn.Wqkv.weight"]
        out[q + "self_attn.o_proj.weight"] = m[p + "attn.out_proj.weight"]
        out[q + "mlp.up_proj.weight"] = m[p + "ffn.up_proj.weight"]
        out[q + "mlp.down_proj.weight"] = m[p + "ffn.down_proj.weight"]
    return out
