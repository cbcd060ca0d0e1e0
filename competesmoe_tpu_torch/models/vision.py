"""SigLIP and CLIP vision towers with MoE MLP blocks, and the S²
multi-scale functions, in PyTorch (port of
competesmoe_tpu/models/vision.py).

Pixel batches keep the JAX layout [B, H, W, C] at the public functions.
A tower returns the hidden state ENTERING the last block (the
reference's `encoder_states[-1]`, CLIP's select_layer -2), while the last
block's aux losses still count; CLIP adds a class token and a
pre-layernorm, and its 'patch' features drop the class token. Linear
weights use PyTorch's [out, in] layout; `convert` maps the flax kernels.
The S² functions (`split_chessboard`, `merge_chessboard`,
`multiscale_features`) are functions of a tower, as in JAX, where no
model calls them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..moe.config import MoEArgs
from ..moe.layers import MoEAux, gelu_exact, gelu_tanh, quick_gelu, zero_aux
from ..moe.registry import get_moe


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """SigLIP/CLIP vision-transformer geometry (HF config fields)."""

    hidden_size: int = 1152            # siglip-so400m
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_tanh"      # gelu_pytorch_tanh
    use_cls_token: bool = False
    tower_type: str = "siglip"
    moe_name: Optional[str] = None     # None -> dense MLP blocks
    num_experts: int = 4
    num_selected: int = 2
    moe_args: MoEArgs = MoEArgs()
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name in ("gelu_tanh", "gelu_pytorch_tanh"):
        return gelu_tanh
    return gelu_exact


def _expert_act(name: str) -> str:
    if "tanh" in name:
        return "gelu_tanh"
    return "quick_gelu" if name == "quick_gelu" else "gelu"


class VisionAttention(nn.Module):
    """MHA with biased projections (HF SiglipAttention layout)."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        kw = dict(device=device, dtype=cfg.dtype)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)

    def forward(self, x):
        h = self.cfg.num_attention_heads
        d = self.cfg.hidden_size
        p = d // h
        shape = (*x.shape[:-1], h, p)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(scores * (p ** -0.5), dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                           v.float()).to(x.dtype)
        return self.out_proj(out.reshape(*x.shape[:-1], d))


class VisionMLP(nn.Module):
    """fc1 -> act -> fc2 (HF SiglipMLP layout)."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.act = _act(cfg.hidden_act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class VisionEncoderLayer(nn.Module):
    """Pre-LN block; the MLP is dense or a registry MoE layer."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=cfg.dtype)
        self.self_attn = VisionAttention(cfg, device)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps, **kw)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps, **kw)
        if cfg.moe_name is not None:
            self.moelayer = get_moe(cfg.moe_name)(
                cfg.hidden_size, cfg.hidden_size,
                n_experts=cfg.num_experts, n_selected=cfg.num_selected,
                args=cfg.moe_args, expert_hidden_dim=cfg.intermediate_size,
                expert_act=_expert_act(cfg.hidden_act), **kw)
        else:
            self.mlp = VisionMLP(cfg, device)

    def forward(self, x, *, step=None, train=False, return_id_experts=False,
                flips=None):
        """`flips`: this layer's row of the flip schedule, for a competing
        MoE layer."""
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.layer_norm2(x)
        if self.cfg.moe_name is not None:
            kw = {} if flips is None else {"flips": flips}
            out, aux = self.moelayer(h, step=step, train=train,
                                     return_id_experts=return_id_experts,
                                     **kw)
        else:
            out, aux = self.mlp(h), zero_aux(h)
        return x + out, aux


class SiglipVisionEmbeddings(nn.Module):
    """Conv patch embedding + learned positions, no CLS token."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        self.patch_embedding = nn.Conv2d(
            cfg.num_channels, cfg.hidden_size, kernel_size=cfg.patch_size,
            stride=cfg.patch_size, **kw)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.num_patches, cfg.hidden_size, **kw))

    def forward(self, pixel_values):
        """pixel_values: [B, H, W, C] -> [B, P, D]."""
        w = self.patch_embedding.weight
        patches = self.patch_embedding(
            pixel_values.to(w.dtype).permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)
        return patches + self.position_embedding[None].to(patches.dtype)


class _Tower(nn.Module):
    """The encoder stack shared by both towers: per-layer competition
    schedules and the penultimate-state readout."""

    def _build_layers(self, cfg: VisionConfig, device) -> None:
        self.cfg = cfg
        self.flip_schedule = None
        self.layers = nn.ModuleList(VisionEncoderLayer(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))

    def set_flip_schedule(self, schedule=None) -> None:
        """Competition schedule of the tower (a moe.schedule.FlipSchedule
        with a row per layer; None: no competition): each competing layer
        takes its warm-up here and its row with each call."""
        self.flip_schedule = schedule
        for layer in self.layers:
            moe = getattr(layer, "moelayer", None)
            if hasattr(moe, "step_warm"):
                moe.step_warm = schedule.step_warm if schedule else 0

    def _encode(self, x, step, train, return_id_experts):
        """(the state entering the last layer, mean aux loss, auxes)."""
        penultimate = x
        auxes: List[MoEAux] = []
        for li, layer in enumerate(self.layers):
            flips = (self.flip_schedule.flips[li]
                     if self.flip_schedule is not None else None)
            penultimate = x
            x, aux = layer(x, step=step, train=train,
                           return_id_experts=return_id_experts, flips=flips)
            auxes.append(aux)
        total = sum((a.aux_loss for a in auxes),
                    torch.zeros((), dtype=torch.float32, device=x.device))
        return penultimate, total / max(len(auxes), 1), auxes


class SiglipSMoEVisionTower(_Tower):
    """SigLIP ViT with MoE MLP blocks; returns (features, mean aux loss,
    per-layer aux list)."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embeddings = SiglipVisionEmbeddings(cfg, device)
        self._build_layers(cfg, device)

    def forward(self, pixel_values, *, step=None, train=False,
                return_id_experts=False):
        return self._encode(self.embeddings(pixel_values), step, train,
                            return_id_experts)


class CLIPVisionEmbeddings(nn.Module):
    """CLIP: class token + bias-free conv patches + P+1 learned
    positions."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        self.patch_embedding = nn.Conv2d(
            cfg.num_channels, cfg.hidden_size, kernel_size=cfg.patch_size,
            stride=cfg.patch_size, bias=False, **kw)
        self.class_embedding = nn.Parameter(
            torch.empty(cfg.hidden_size, **kw))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.num_patches + 1, cfg.hidden_size, **kw))

    def forward(self, pixel_values):
        """pixel_values: [B, H, W, C] -> [B, 1 + P, D]."""
        w = self.patch_embedding.weight
        patches = self.patch_embedding(
            pixel_values.to(w.dtype).permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(
            patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding[None].to(x.dtype)


class CLIPSMoEVisionTower(_Tower):
    """CLIP ViT with (optionally MoE) MLP blocks, `pre_layrnorm` (HF's
    spelling) before the stack, and the 'patch' (class token dropped) or
    'cls_patch' feature select; returns (features, mean aux loss,
    per-layer aux list)."""

    def __init__(self, cfg: VisionConfig, device=None,
                 select_feature: str = "patch"):
        super().__init__()
        if select_feature not in ("patch", "cls_patch"):
            raise ValueError(f"bad select_feature {select_feature!r}")
        device = resolve_device(device)
        self.select_feature = select_feature
        self.embeddings = CLIPVisionEmbeddings(cfg, device)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps,
                                         device=device, dtype=cfg.dtype)
        self._build_layers(cfg, device)

    def forward(self, pixel_values, *, step=None, train=False,
                return_id_experts=False):
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        feats, total, auxes = self._encode(x, step, train,
                                           return_id_experts)
        if self.select_feature == "patch":
            feats = feats[:, 1:]
        return feats, total, auxes


# ---------------------------------------------------------------------------
# S² multi-scale (scaling_on_scales)
# ---------------------------------------------------------------------------

def split_chessboard(x: torch.Tensor, num_split: int) -> torch.Tensor:
    """[B, H, W, C] -> [n*n*B, H/n, W/n, C], tile-major."""
    b, h, w, c = x.shape
    hs, ws = h // num_split, w // num_split
    x = x.reshape(b, num_split, hs, num_split, ws, c)
    return x.permute(1, 3, 0, 2, 4, 5).reshape(num_split * num_split * b,
                                               hs, ws, c)


def merge_chessboard(x: torch.Tensor, num_split: int) -> torch.Tensor:
    """Inverse of split_chessboard on feature grids."""
    bn, h, w, c = x.shape
    b = bn // (num_split * num_split)
    x = x.reshape(num_split, num_split, b, h, w, c)
    return x.permute(2, 0, 3, 1, 4, 5).reshape(b, num_split * h,
                                               num_split * w, c)


def _resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C] as `jax.image.resize(...,
    'bilinear')`: half-pixel centres (align_corners=False), and when it
    shrinks a triangle kernel widened by the scale (antialias=True)."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def multiscale_features(tower_fn, pixel_values: torch.Tensor,
                        scales: Tuple[int, ...] = (1, 3),
                        base_size: Optional[int] = None) -> torch.Tensor:
    """S² forward: per scale s, resize to s * base, split into s² tiles,
    run the tower on them as one batch, merge the tiles' feature grids
    and resize them to the base grid; then concatenate the scales'
    channels. tower_fn: [N, H, W, C] -> [N, P, D] patch features. Returns
    [B, P, D * len(scales)]."""
    b, h, w, c = pixel_values.shape
    base = base_size or h
    grids = []
    base_grid = None
    for s in scales:
        img = (pixel_values if s * base == h
               else _resize_bilinear(pixel_values, s * base))
        tiles = split_chessboard(img, s) if s > 1 else img
        feats = tower_fn(tiles)
        n, p, d = feats.shape
        side = int(round(p ** 0.5))
        feats = feats.reshape(n, side, side, d)
        if s > 1:
            feats = merge_chessboard(feats, s)
        if base_grid is None:
            base_grid = feats.shape[1]
        if feats.shape[1] != base_grid:
            feats = _resize_bilinear(feats, base_grid)
        grids.append(feats)
    return torch.cat(grids, dim=-1).reshape(b, base_grid * base_grid, -1)
