"""MoEUT-style Transformer language model (port of
competesmoe_tpu/models/lm.py).

- token embedding scaled by sqrt(d_model);
- pre-LN blocks: x + attn(ln(x)); x + moe(ln(x));
- FastRope attention: q/k/v/out projections without bias, partial rotary
  embedding (`rotate_fraction` of each head, rotate-half convention),
  causal; attn_backend 'flash' runs K2 (`ops/flash_attention.py`),
  'einsum' the plain softmax(q k^T) v;
- MoE FFN from the pretrain registry, with the flip-schedule row of each
  layer *position* passed per call;
- universal layer sharing `abab` / `aabb`; final LayerNorm and an untied
  output head with bias.

Module and parameter names follow the flax tree (`embedding`,
`blocks.<i>.attn.{q,k,v,out}`, `blocks.<i>.moe.{w_gate,keys,values}`,
`blocks.<i>.norm1/norm2`, `out_norm`, `output`), so `convert.
from_jax_params` carries JAX weights over. LayerNorm epsilon is flax's
1e-6. `init_weights(seed)` draws the JAX init distributions on the
model's device with a torch.Generator, one tensor at a time.

Not ported (each raises NotImplementedError naming its ROADMAP item):
MoA attention (`att_moe`), ACT pondering, the Transformer-XL context carry
(`n_prev_states`), stochastic layer drop, per-block remat and ring
attention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..moe.config import MoEArgs
from ..moe.pretrain_layers import MoEUTBase, PretrainCompeteSMoE
from ..moe.registry import get_pretrain_moe
from ..moe.schedule import FlipSchedule
from ..ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX LMConfig's fields (transformer_lm_mixin.py:20-105 and the
    154M sweep), with a torch dtype for the activations."""

    vocab_size: int = 8000
    d_model: int = 512
    n_layers: int = 16
    n_heads: int = 4
    head_dim: Optional[int] = None       # default d_model // n_heads
    dropout: float = 0.0
    # MoE
    moe_name: str = "competesmoe"
    n_experts: int = 64
    expert_size: int = 128
    moe_topk: int = 8                    # pkm.n_heads
    moe_args: MoEArgs = MoEArgs()
    moe_impl: str = "auto"
    # RoPE
    rotate_fraction: float = 0.5
    rope_base: float = 10000.0
    # 'einsum' (plain), 'flash' (K2) or 'auto' (resolve_attn_backend)
    attn_backend: str = "auto"
    # universal transformer sharing
    universal_group_size: int = 1        # 1 -> no sharing
    universal_group_type: str = "abab"
    # not ported (raise when set): MoA, XL context carry, layer drop, ACT,
    # remat
    att_moe: bool = False
    n_prev_states: int = 0
    p_drop_layer: float = 0.0
    act_max_steps: int = 0
    remat: bool = False
    # misc
    preln: bool = True
    norm_before_output: bool = True
    layer_std_constant: float = 2.0      # moe.layer_std_constant
    dtype: torch.dtype = torch.float32   # activation dtype (bf16 under amp)

    @property
    def proj_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_order(self) -> list:
        """Map layer position -> unique-layer index (abab/aabb sharing)."""
        g, n = self.universal_group_size, self.n_layers
        if g <= 1:
            return list(range(n))
        if n % g != 0:
            raise ValueError("n_layers must be divisible by universal group "
                             "size")
        reps = n // g
        if self.universal_group_type == "abab":
            return list(range(g)) * reps
        if self.universal_group_type == "aabb":
            return sum([[i] * reps for i in range(g)], [])
        raise ValueError(f"bad group type {self.universal_group_type}")

    @property
    def n_unique_layers(self) -> int:
        return len(set(self.layer_order()))


_NOT_PORTED = (
    ("att_moe", "MoA attention (models/moa.py)"),
    ("act_max_steps", "ACT pondering (models/act.py)"),
    ("n_prev_states", "the Transformer-XL context carry"),
    ("p_drop_layer", "stochastic layer drop"),
    ("remat", "per-block remat"),
)


def _check_ported(cfg: LMConfig) -> None:
    for field, what in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"LMConfig.{field}: {what} is not ported (ROADMAP open "
                "item 1.1)")
    if not cfg.preln:
        raise NotImplementedError("post-LN blocks are not ported (ROADMAP "
                                  "open item 1.1)")


def resolve_attn_backend(backend: str, seq_len: int, head_dim: int,
                         platform: Optional[str] = None) -> str:
    """JAX's rule with `cuda` in the place of `tpu`: 'auto' is 'flash' only
    on the accelerator at T >= 2048 with a head dim that is a multiple of
    128; explicit settings pass through."""
    if backend != "auto":
        return backend
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform == "cuda" and seq_len >= 2048 and head_dim % 128 == 0:
        return "flash"
    return "einsum"


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_sin_cos(n_rotate: int, seq_len: int, base: float, offset: int = 0,
                 dtype=torch.float32, device=None):
    """Non-interleaved RoPE tables: freqs repeated as cat(freqs, freqs),
    so rotate_half pairs dim i with i + n/2. inv_freq is computed in numpy
    float32, as in JAX."""
    inv_freq = 1.0 / (base ** (np.arange(0, n_rotate, 2, dtype=np.float32)
                               / n_rotate))
    t = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                     device=device)
    freqs = torch.outer(t, torch.as_tensor(inv_freq, device=device))
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb).to(dtype), torch.cos(emb).to(dtype)


def apply_partial_rope(x: torch.Tensor, sin: torch.Tensor,
                       cos: torch.Tensor, n_rotate: int) -> torch.Tensor:
    """Rotate the first n_rotate dims of each head; pass the rest."""
    if n_rotate == 0:
        return x
    r, nr = x[..., :n_rotate], x[..., n_rotate:]
    r = r * cos + rotate_half(r) * sin
    return torch.cat([r, nr], dim=-1) if nr.shape[-1] else r


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: epsilon 1e-6, statistics in float32, output in the
    activation dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None):
        super().__init__(dim, eps=1e-6, device=device, dtype=torch.float32)
        self.out_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.out_dtype)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax Dense with `dtype`: input and kernel cast to it."""
    w = layer.weight.to(dtype)
    b = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), w, b)


class FastRopeAttention(nn.Module):
    """Causal MHA with partial rotary embedding, no projection biases."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, p, d = cfg.n_heads, cfg.proj_dim, cfg.d_model
        self.q = nn.Linear(d, h * p, bias=False, device=device)
        self.k = nn.Linear(d, h * p, bias=False, device=device)
        self.v = nn.Linear(d, h * p, bias=False, device=device)
        self.out = nn.Linear(h * p, d, bias=False, device=device)

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        """Pre-LN init: std = sqrt(c / (n_layers * fan_in)) times a normal
        truncated to [-2, 2]."""
        for lin in (self.q, self.k, self.v, self.out):
            fan_in = lin.weight.shape[1]
            std = math.sqrt(self.cfg.layer_std_constant
                            / (self.cfg.n_layers * fan_in))
            nn.init.trunc_normal_(lin.weight, 0.0, 1.0, -2.0, 2.0,
                                  generator=g)
            lin.weight.mul_(std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h, p = cfg.n_heads, cfg.proj_dim
        n_rotate = int(cfg.rotate_fraction * p)
        n_rotate -= n_rotate % 2
        B, T, _ = x.shape
        q = _dense(x, self.q, cfg.dtype).reshape(B, T, h, p)
        k = _dense(x, self.k, cfg.dtype).reshape(B, T, h, p)
        v = _dense(x, self.v, cfg.dtype).reshape(B, T, h, p)
        if n_rotate > 0:
            sin, cos = rope_sin_cos(n_rotate, T, cfg.rope_base,
                                    dtype=q.dtype, device=x.device)
            sin, cos = sin[None, :, None, :], cos[None, :, None, :]
            q = apply_partial_rope(q, sin, cos, n_rotate)
            k = apply_partial_rope(k, sin, cos, n_rotate)
        # [B, h, T, p]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        backend = resolve_attn_backend(cfg.attn_backend, T, p,
                                       platform=x.device.type)
        if backend == "flash":
            out = flash_attention(q, k, v, causal=True,
                                  sm_scale=1.0 / math.sqrt(p))
        elif backend == "einsum":
            scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
            scores = scores / math.sqrt(p)
            causal = torch.ones(T, T, dtype=torch.bool,
                                device=x.device).tril()
            scores = scores.masked_fill(~causal, float("-inf"))
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", probs.float(),
                               v.float()).to(x.dtype)
        else:
            raise ValueError(f"unknown attn_backend {backend!r}")
        out = out.transpose(1, 2).reshape(B, T, h * p)
        return _dense(out, self.out, cfg.dtype)


class MoETransformerBlock(nn.Module):
    """Pre-LN block: attention + registry MoE FFN."""

    def __init__(self, cfg: LMConfig, step_warm: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = FastRopeAttention(cfg, device=device)
        moe_cls = get_pretrain_moe(cfg.moe_name)
        kw = {"step_warm": step_warm} if issubclass(
            moe_cls, PretrainCompeteSMoE) else {}
        self.moe = moe_cls(cfg.d_model, cfg.n_experts, cfg.expert_size,
                           cfg.moe_topk, args=cfg.moe_args,
                           weight_scale=math.sqrt(cfg.layer_std_constant
                                                  / cfg.n_layers),
                           impl=cfg.moe_impl, device=device, **kw)
        self.norm1 = LayerNorm(cfg.d_model, cfg.dtype, device=device)
        self.norm2 = LayerNorm(cfg.d_model, cfg.dtype, device=device)

    def forward(self, x, step=None, train: bool = False, flips=None,
                return_id_experts: bool = False):
        x = x + self.attn(self.norm1(x))
        kwargs = {"flips": flips} if isinstance(
            self.moe, PretrainCompeteSMoE) else {}
        moe_out, aux = self.moe(self.norm2(x), step=step, train=train,
                                return_id_experts=return_id_experts,
                                **kwargs)
        return x + moe_out, aux


class MoELanguageModel(nn.Module):
    """embedding -> n_layers blocks (with optional sharing) -> norm ->
    output head. Built uninitialised on `device` (cuda unless asked
    otherwise); call `init_weights(seed)` or `load_state_dict`."""

    def __init__(self, cfg: LMConfig,
                 flip_schedule: Optional[FlipSchedule] = None, device=None):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.flip_schedule = flip_schedule
        step_warm = flip_schedule.step_warm if flip_schedule else 0
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                      device=device)
        self.blocks = nn.ModuleList(
            MoETransformerBlock(cfg, step_warm=step_warm, device=device)
            for _ in range(cfg.n_unique_layers))
        if cfg.norm_before_output:
            self.out_norm = LayerNorm(cfg.d_model, cfg.dtype, device=device)
        self.output = nn.Linear(cfg.d_model, cfg.vocab_size, bias=True,
                                device=device)

    def set_flip_schedule(self, schedule: FlipSchedule) -> None:
        """Compete by `schedule` from now on (a restored run's own)."""
        self.flip_schedule = schedule
        for mod in self.modules():
            if isinstance(mod, PretrainCompeteSMoE):
                mod.step_warm = schedule.step_warm

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "MoELanguageModel":
        """The JAX init distributions, drawn on the model's device."""
        g = torch.Generator(device=self.output.weight.device).manual_seed(
            seed)
        d = self.cfg.d_model
        for t in (self.embedding.weight, self.output.weight):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * d ** -0.5)
        self.output.bias.zero_()
        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (FastRopeAttention, MoEUTBase)):
                mod.reset_parameters(g)
        return self

    def forward(self, tokens: torch.Tensor, *, step=None,
                train: bool = False, return_id_experts: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens: [B, T] -> (logits [B, T, V] float32, aux dict with one
        entry per layer and aux key, plus `total_aux_loss`)."""
        cfg = self.cfg
        net = self.embedding(tokens).to(cfg.dtype)
        net = net * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
        aux_losses: Dict[str, torch.Tensor] = {}
        total_aux = torch.zeros((), dtype=torch.float32, device=net.device)
        for li, ui in enumerate(cfg.layer_order()):
            flips = (self.flip_schedule.flips[li]
                     if self.flip_schedule is not None else None)
            net, aux = self.blocks[ui](net, step, train, flips,
                                       return_id_experts)
            if return_id_experts and aux.selected_experts is not None:
                aux_losses[f"layer{li}/selected_experts"] = \
                    aux.selected_experts
                aux_losses[f"layer{li}/gate_softmax"] = aux.gate_softmax
            total_aux = total_aux + aux.aux_loss
            for key, val in aux.losses.items():
                aux_losses[f"layer{li}/{key}"] = val
        if cfg.norm_before_output:
            net = self.out_norm(net)
        logits = self.output(net.float())
        aux_losses["total_aux_loss"] = total_aux
        return logits, aux_losses


def lm_loss_fn(logits: torch.Tensor, targets: torch.Tensor,
               ignore_index: int = -100):
    """Token-mean cross-entropy with ignore_index masking -> (loss,
    n_valid)."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    n = torch.clamp(valid.sum(), min=1)
    return nll.sum() / n, n
