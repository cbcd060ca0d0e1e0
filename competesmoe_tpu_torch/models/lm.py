"""MoEUT-style Transformer language model (port of
competesmoe_tpu/models/lm.py).

- token embedding scaled by sqrt(d_model);
- pre-LN blocks: x + attn(ln(x)); x + moe(ln(x)). `preln=False` changes
  nothing: JAX declares the flag and reads it nowhere (ROADMAP §3);
- FastRope attention: q/k/v/out projections without bias, partial rotary
  embedding (`rotate_fraction` of each head, rotate-half convention),
  causal; attn_backend 'flash' runs K2 (`ops/flash_attention.py`),
  'einsum' the plain softmax(q k^T) v. With `att_moe` the block's
  attention is MoA (`models/moa.py`), which is always einsum;
- MoE FFN from the pretrain registry, with the flip-schedule row of each
  layer *position* passed per call;
- universal layer sharing `abab` / `aabb`; final LayerNorm and an untied
  output head with bias;
- the Transformer-XL carry (`n_prev_states > 0`): `forward(state=...)`
  takes each layer position's carried block [B, S, D] and returns the
  new one (each layer's normalised input, detached) under
  `aux["state"]`; queries sit at positions S.. and see the whole carried
  prefix (the einsum path, as in JAX: flash takes only the plain square
  causal case);
- stochastic layer drop (`p_drop_layer`, training only): a token keeps a
  block's output where a uniform draw is >= p, else its input;
- ACT (`act_max_steps > 0`): every block wrapped in `models/act.py`'s
  ACTBlock;
- per-block remat (`remat`, ignored under ACT as in JAX): each block runs
  under `torch.utils.checkpoint` and is recomputed in backward. The
  competition step is decided on the host from the step number, so the
  recompute takes the same branch.

Sequence parallelism (`parallel.seq_context.use_sequence_parallel`, a
mesh with a 'seq' axis): each rank holds its block of every row's
sequence, and rotary positions are global (block offset + local index).
Plain causal attention (no carried prefix, no mask) runs as a K/V ring
(`parallel/ring_attention.py`) before the flash branch, as in JAX, so K2
is not launched there; an attention JAX does not send through the ring
(the XL carry, MoA) gathers the sequence's K/V over 'seq' and attends its
own query rows (`seq_gather_kv`). A carried state is each rank's block.

Every random draw (layer drop, MoA's dropouts) comes from the
`generator=` the caller passes to `forward`, and is drawn outside the
recomputed region, so remat replays the same masks. Training with any of
them above 0 and no generator raises.

Module and parameter names follow the flax tree (`embedding`,
`blocks.<i>.attn.{q,k,v,out}`, `blocks.<i>.moe.{w_gate,keys,values}`,
`blocks.<i>.norm1/norm2`, `out_norm`, `output`; MoA's
`blocks.<i>.attn.<name>_bank.{w_gate,experts}`; ACT's
`blocks.<i>.block.*` and `blocks.<i>.halting`), so `convert.
from_jax_params` carries JAX weights over. LayerNorm epsilon is flax's
1e-6. `init_weights(seed)` draws the JAX init distributions on the
model's device with a torch.Generator, one tensor at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..moe.config import MoEArgs
from ..moe.pretrain_layers import MoEUTBase, PretrainCompeteSMoE
from ..moe.registry import get_pretrain_moe
from ..moe.schedule import FlipSchedule
from ..ops.flash_attention import flash_attention
from ..parallel import seq_context
from .act import ACTBlock
from .moa import FullMoeRopeAttention


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
    # MoA: expert-bank attention projections (the -moe.att.* flags)
    att_moe: bool = False
    att_n_experts: int = 4
    att_k: int = 2
    att_q_expert: bool = True
    att_k_expert: bool = True
    att_v_expert: bool = True
    att_o_expert: bool = True
    att_v_size: Optional[int] = None
    att_expert_dropout: float = 0.0
    att_selection_dropout: float = 0.0
    # universal transformer sharing
    universal_group_size: int = 1        # 1 -> no sharing
    universal_group_type: str = "abab"
    # Transformer-XL carry; 0 = off (the shipped sweeps' setting)
    n_prev_states: int = 0
    # stochastic layer drop (training only)
    p_drop_layer: float = 0.0
    # ACT pondering: 0 = off; > 0 wraps every block in an ACTBlock
    act_max_steps: int = 0
    act_loss: float = 0.0
    # per-block remat (ignored when ACT wraps the blocks)
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

    def forward(self, x: torch.Tensor, attend_to=None, pos_offset: int = 0,
                mask=None) -> torch.Tensor:
        """attend_to: an optional [B, S, D] source of keys and values
        (the carried prefix and x): queries at positions pos_offset..,
        keys from position 0. Under a seq mesh x and attend_to are this
        rank's blocks and pos_offset the global carried length."""
        cfg = self.cfg
        h, p = cfg.n_heads, cfg.proj_dim
        n_rotate = int(cfg.rotate_fraction * p)
        n_rotate -= n_rotate % 2
        kv_src = attend_to if attend_to is not None else x
        B, T, _ = x.shape
        q = _dense(x, self.q, cfg.dtype).reshape(B, T, h, p)
        k = _dense(kv_src, self.k, cfg.dtype).reshape(B, -1, h, p)
        v = _dense(kv_src, self.v, cfg.dtype).reshape(B, -1, h, p)
        seq = seq_context.active()
        q_off = pos_offset
        if seq is not None:
            mesh, axis = seq
            q_off = pos_offset + axis.index * T
            if attend_to is None and mask is None:
                # JAX's ring branch comes before the flash branch
                if n_rotate > 0:
                    q = _rope(q, n_rotate, cfg.rope_base, q_off)
                    k = _rope(k, n_rotate, cfg.rope_base, q_off)
                from ..parallel.ring_attention import make_ring_attention
                from ..parallel.seq_context import seq_axis
                out = make_ring_attention(mesh, seq_axis())(q, k, v)
                return _dense(out.reshape(B, T, h * p), self.out, cfg.dtype)
            k, v = seq_gather_kv(k, v, T, axis)
        S = k.shape[1]
        if n_rotate > 0:
            q = _rope(q, n_rotate, cfg.rope_base, q_off)
            k = _rope(k, n_rotate, cfg.rope_base, 0)
        # [B, h, T, p]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        backend = resolve_attn_backend(cfg.attn_backend, T, p,
                                       platform=x.device.type)
        if backend not in ("flash", "einsum"):
            raise ValueError(f"unknown attn_backend {backend!r}")
        if (backend == "flash" and attend_to is None and mask is None
                and seq is None):
            out = flash_attention(q, k, v, causal=True,
                                  sm_scale=1.0 / math.sqrt(p))
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
            scores = scores / math.sqrt(p)
            # causal over the suffix; the carried prefix fully visible
            causal = causal_mask(T, S, q_off if seq is not None else S - T,
                                 x.device)
            if mask is not None:
                causal = causal & mask
            scores = scores.masked_fill(~causal, float("-inf"))
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", probs.float(),
                               v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, T, h * p)
        return _dense(out, self.out, cfg.dtype)


def _rope(t: torch.Tensor, n_rotate: int, base: float, offset: int):
    """Partial rotary embedding of t [B, T, h, p] at positions offset.."""
    sin, cos = rope_sin_cos(n_rotate, t.shape[1], base, offset=offset,
                            dtype=t.dtype, device=t.device)
    return apply_partial_rope(t, sin[None, :, None], cos[None, :, None],
                              n_rotate)


def causal_mask(T: int, S: int, q0: int, device) -> torch.Tensor:
    """[T, S] bool: query t, at key position q0 + t, sees the keys at or
    before it (so a carried prefix before q0 is fully visible)."""
    qpos = torch.arange(T, device=device)[:, None] + q0
    return torch.arange(S, device=device)[None, :] <= qpos


def seq_gather_kv(k: torch.Tensor, v: torch.Tensor, T: int, axis):
    """The whole sequence's keys and values from this rank's blocks: k, v
    [B, S_loc + T, ...] hold this rank's block of a carried prefix, then
    of x (S_loc may be 0); each part is gathered over `axis` in rank
    order, prefix first. The gather's backward returns each rank its part
    of the gradient."""
    from ..parallel import collectives as C
    s_loc = k.shape[1] - T

    def whole(t):
        parts = [C.all_gather(t[:, :s_loc].contiguous(), axis, 1)] \
            if s_loc else []
        parts.append(C.all_gather(t[:, s_loc:].contiguous(), axis, 1))
        return torch.cat(parts, dim=1)
    return whole(k), whole(v)


class MoETransformerBlock(nn.Module):
    """Pre-LN block: attention (FastRope, or MoA with `att_moe`) + registry
    MoE FFN."""

    def __init__(self, cfg: LMConfig, step_warm: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = (FullMoeRopeAttention(cfg, device=device) if cfg.att_moe
                     else FastRopeAttention(cfg, device=device))
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

    def draw_noise(self, x, prev_state, g: torch.Generator):
        """MoA's dropout draws for a call on x (and the carried prefix)."""
        if not self.cfg.att_moe:
            return None
        attend_to = (torch.cat([prev_state, x], dim=1)
                     if prev_state is not None else None)
        return self.attn.draw_noise(x, attend_to, g)

    def forward(self, x, step=None, train: bool = False, flips=None,
                prev_state=None, pos_offset: int = 0,
                return_id_experts: bool = False, noise=None):
        ninput = self.norm1(x)
        attend_to = None
        if prev_state is not None:
            # carried states were normalised when saved
            attend_to = torch.cat([prev_state, ninput], dim=1)
        att_aux = None
        if self.cfg.att_moe:
            attn_out, att_aux = self.attn(ninput, attend_to, pos_offset,
                                          train=train, noise=noise)
        else:
            attn_out = self.attn(ninput, attend_to, pos_offset)
        x = x + attn_out
        kwargs = {"flips": flips} if isinstance(
            self.moe, PretrainCompeteSMoE) else {}
        moe_out, aux = self.moe(self.norm2(x), step=step, train=train,
                                return_id_experts=return_id_experts,
                                **kwargs)
        if att_aux is not None:
            aux = dataclasses.replace(
                aux, aux_loss=aux.aux_loss + att_aux.aux_loss,
                losses={**aux.losses, **att_aux.losses})
        return x + moe_out, aux


class MoELanguageModel(nn.Module):
    """embedding -> n_layers blocks (with optional sharing) -> norm ->
    output head. Built uninitialised on `device` (cuda unless asked
    otherwise); call `init_weights(seed)` or `load_state_dict`."""

    def __init__(self, cfg: LMConfig,
                 flip_schedule: Optional[FlipSchedule] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.flip_schedule = flip_schedule
        step_warm = flip_schedule.step_warm if flip_schedule else 0
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                      device=device)
        blocks = [MoETransformerBlock(cfg, step_warm=step_warm,
                                      device=device)
                  for _ in range(cfg.n_unique_layers)]
        if cfg.act_max_steps > 0:
            blocks = [ACTBlock(b, cfg.d_model, max_steps=cfg.act_max_steps,
                               act_loss_coef=cfg.act_loss, device=device)
                      for b in blocks]
        self.blocks = nn.ModuleList(blocks)
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

    @property
    def draws(self) -> bool:
        """Does a training forward draw random numbers?"""
        cfg = self.cfg
        return cfg.p_drop_layer > 0.0 or (cfg.att_moe and (
            cfg.att_expert_dropout > 0.0 or cfg.att_selection_dropout > 0.0))

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
            elif isinstance(mod, (FastRopeAttention, FullMoeRopeAttention,
                                  MoEUTBase, ACTBlock)):
                mod.reset_parameters(g)
        return self

    def forward(self, tokens: torch.Tensor, *, step=None,
                train: bool = False, state: Optional[List] = None,
                return_id_experts: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens: [B, T] -> (logits [B, T, V] float32, aux dict with one
        entry per layer and aux key, plus `total_aux_loss`, and the new
        carried `state` with n_prev_states > 0)."""
        cfg = self.cfg
        draws = train and self.draws
        if draws and generator is None:
            raise ValueError("training with p_drop_layer or MoA dropout "
                             "draws random numbers: pass generator=")
        remat = (cfg.remat and cfg.act_max_steps == 0
                 and torch.is_grad_enabled())
        net = self.embedding(tokens).to(cfg.dtype)
        net = net * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
        aux_losses: Dict[str, torch.Tensor] = {}
        total_aux = torch.zeros((), dtype=torch.float32, device=net.device)
        new_state = []
        pos_offset = 0
        if cfg.n_prev_states > 0 and state is not None:
            # the global carried length (each rank holds its block)
            seq = seq_context.active()
            pos_offset = state[0].shape[1] * (1 if seq is None
                                              else seq[1].size)
        for li, ui in enumerate(cfg.layer_order()):
            block = self.blocks[ui]
            flips = (self.flip_schedule.flips[li]
                     if self.flip_schedule is not None else None)
            prev = None
            if cfg.n_prev_states > 0:
                prev = state[li] if state is not None else None
                # this layer's normalised input, carried to the next window
                new_state.append(block.norm1(net).detach())
            noise = block.draw_noise(net, prev, generator) if draws else None
            args = (net, step, train, flips, prev, pos_offset,
                    return_id_experts, noise)
            if remat:
                net_o, aux = checkpoint(block, *args, use_reentrant=False)
            else:
                net_o, aux = block(*args)
            if return_id_experts and aux.selected_experts is not None:
                aux_losses[f"layer{li}/selected_experts"] = \
                    aux.selected_experts
                aux_losses[f"layer{li}/gate_softmax"] = aux.gate_softmax
            if train and cfg.p_drop_layer > 0.0:
                keep = torch.rand(net_o[..., :1].shape, generator=generator,
                                  device=net.device) >= cfg.p_drop_layer
                net = torch.where(keep, net_o, net)
            else:
                net = net_o
            total_aux = total_aux + aux.aux_loss
            for key, val in aux.losses.items():
                aux_losses[f"layer{li}/{key}"] = val
        if cfg.norm_before_output:
            net = self.out_norm(net)
        logits = self.output(net.float())
        aux_losses["total_aux_loss"] = total_aux
        if cfg.n_prev_states > 0:
            aux_losses["state"] = new_state
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
