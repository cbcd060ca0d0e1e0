"""HF-style causal decoder (Phi-3.5 / llama family) in PyTorch (port of
competesmoe_tpu/models/decoder.py).

Covers what serving the CompeteSMoE-5.1B decoder needs: RMSNorm with an
exact 1/sqrt, plain and Phi-3 longrope rotary tables, MHA/GQA with fused
(`qkv_proj`/`gate_up_proj`) or split projections, the SiLU-gated MLP, a
stacked KV cache (bf16 or int8 with per-(slot, head) scales) and
weight-quantized projections (`QuantDense` int8 / packed int4).

Every int4 projection at a decode shape goes through K5 of
`ops/matvec.py`. With `matvec_kernel`, the bf16 projections (`PallasDense`)
go through K3 and the int8 ones (`QuantDense`) through K4 at the shapes
the kernels take, on CUDA tensors. All other contractions are plain tensor
code with float32 accumulation, as JAX leaves them to XLA; on the card the
attention's operands stay at the cache's width (bf16, or int8 converted
to bf16 in the layer's one copy of K and of V). `attn_window` reads only
the first slots of the cache, as JAX's does. The KV cache is updated in
place (the JAX version returns a new buffer; here the in-place write
saves a copy of the cache per step), and so, on request, are its
positions (a captured step's state must stay where it is).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..moe.config import MoEArgs
from ..moe.layers import MoEAux, zero_aux
from ..ops.matvec import (MAX_QUANT_M, quant_small_m_matmul,
                          quant_small_m_matmul_int4, small_m_matmul,
                          small_m_viable, small_m_viable_int4,
                          unpack_int4_halves)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int = 4096
    rope_scaling_type: Optional[str] = None
    rope_short_factor: Optional[Tuple[float, ...]] = None
    rope_long_factor: Optional[Tuple[float, ...]] = None
    partial_rotary_factor: float = 1.0
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    fused_qkv: bool = False
    remat: bool = False
    attention_bias: bool = False
    use_alibi: bool = False
    norm_type: str = "rmsnorm"
    mlp_type: str = "silu_glu"
    expansion_ratio: int = 4
    moe_name: Optional[str] = None
    num_experts: int = 8
    num_selected: int = 2
    moe_args: MoEArgs = MoEArgs()
    # 'int8' (w8a16) | 'int4' (packed w4a16; lm_head stays int8)
    quant: Optional[str] = None
    # 'int8': K/V stored as int8 with per (layer, batch, slot, head) scales
    kv_quant: Optional[str] = None
    norm_folded: bool = False
    deferred_decode: bool = False
    matvec_kernel: bool = False
    cache_layout: str = "stacked"
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def phi35_mini_config(dtype: torch.dtype = torch.bfloat16) -> DecoderConfig:
    """microsoft/Phi-3.5-mini-instruct geometry (the CompeteSMoE-5.1B
    decoder)."""
    short = (1.0,) * 48
    long = (1.0799999237060547, 1.0999999046325684, 1.1199998855590820,
            1.1399998664855957, 1.1599998474121094, 1.1799998283386230,
            1.1999998092651367, 1.2199997901916504, 1.2399997711181641,
            1.2599997520446777, 1.2799997329711914, 1.2999997138977051,
            1.3199996948242188, 1.3399996757507324, 1.3599996566772461,
            1.3799996376037598, 1.3999996185302734, 1.4199995994567871,
            1.4399995803833008, 1.4599995613098145, 1.4799995422363281,
            1.4999995231628418, 1.5199995040893555, 1.5399994850158691,
            1.5599994659423828, 1.5799994468688965, 1.5999994277954102,
            1.6199994087219238, 1.6399993896484375, 1.6599993705749512,
            1.6799993515014648, 1.6999993324279785, 1.7199993133544922,
            1.7399992942810059, 1.7599992752075195, 1.7799992561340332,
            1.7999992370605469, 1.8199992179870605, 1.8399991989135742,
            1.8599991798400879, 1.8799991607666016, 1.8999991416931152,
            1.9199991226196289, 1.9399991035461426, 1.9599990844726562,
            1.9799990653991699, 1.9999990463256836, 2.0999990701675415)
    return DecoderConfig(
        vocab_size=32064, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, rms_norm_eps=1e-5, rope_theta=10000.0,
        max_position_embeddings=131072,
        original_max_position_embeddings=4096,
        rope_scaling_type="longrope", rope_short_factor=short,
        rope_long_factor=long, fused_qkv=True, tie_word_embeddings=False,
        dtype=dtype)


def check_supported(cfg: DecoderConfig) -> None:
    """Raise for decoder options this slice does not port."""
    unported = {
        "use_alibi": cfg.use_alibi, "sliding_window": cfg.sliding_window,
        "deferred_decode": cfg.deferred_decode,
        "cache_layout='per_layer'": cfg.cache_layout != "stacked",
        "norm_folded": cfg.norm_folded, "quant='w8a8'": cfg.quant == "w8a8",
        "remat": cfg.remat, "moe_name (MoE decoder)": cfg.moe_name,
        "norm_type": cfg.norm_type != "rmsnorm",
        "mlp_type": cfg.mlp_type != "silu_glu",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"decoder options not ported yet: {', '.join(bad)} (ROADMAP: "
            "decoder options left for later slices)")
    if cfg.quant not in (None, "int8", "int4"):
        raise ValueError(f"unknown quant {cfg.quant!r}")
    if cfg.kv_quant not in (None, "int8"):
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r}")


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device,
                                               dtype=dtype))

    def forward(self, x):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        # exact 1/sqrt, as the JAX version (rsqrt is an approximation)
        xf = xf / torch.sqrt(var + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: DecoderConfig, long: bool, device: torch.device):
    """(inverse frequencies as a float32 tensor on `device`, attention
    factor), built once: a host-to-device copy in every forward would
    synchronise the stream and stall the engine's pipelined ticks."""
    rot = int(cfg.head_dim * cfg.partial_rotary_factor)
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, rot, 2,
                                                   dtype=np.float64) / rot))
    attn_factor = 1.0
    if cfg.rope_scaling_type in ("longrope", "su"):
        factors = np.asarray(cfg.rope_long_factor if long
                             else cfg.rope_short_factor, np.float64)
        inv_freq = inv_freq / factors
        scale = (cfg.max_position_embeddings
                 / cfg.original_max_position_embeddings)
        if scale > 1.0:
            attn_factor = math.sqrt(
                1.0 + math.log(scale)
                / math.log(cfg.original_max_position_embeddings))
    return (torch.as_tensor(inv_freq.astype(np.float32), device=device),
            attn_factor)


def rope_tables(cfg: DecoderConfig, positions: torch.Tensor,
                seq_len_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (float32) for positions [..., T]: plain RoPE or
    Phi-3 longrope (short/long per-dim factors chosen by the runtime
    context, times the sqrt(1 + log(s)/log(orig)) attention factor)."""
    inv, attn_factor = _inv_freq(
        cfg, seq_len_cap > cfg.original_max_position_embeddings,
        positions.device)
    freqs = positions[..., None].float() * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * attn_factor, torch.sin(emb) * attn_factor


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, D]; cos/sin: [B, T, rot] (HF non-interleaved)."""
    rot = cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    out = (xr * cos[:, :, None, :].to(x.dtype)
           + rotated * sin[:, :, None, :].to(x.dtype))
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


@dataclasses.dataclass
class KVCache:
    """Stacked cache: k/v [L, B, max_len, kv_heads, head_dim] (dtype or
    int8), pos [B] current length per sequence, and in int8 mode per
    (L, B, slot, kv-head) dequant scales."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @classmethod
    def create(cls, cfg: DecoderConfig, batch: int, max_len: int,
               device=None) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        pos = torch.zeros((batch,), dtype=torch.long, device=device)
        if cfg.kv_quant == "int8":
            return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       pos=pos,
                       k_scale=torch.zeros(shape[:-1], dtype=cfg.dtype,
                                           device=device),
                       v_scale=torch.zeros(shape[:-1], dtype=cfg.dtype,
                                           device=device))
        return cls(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   pos=pos)


def _quantize_kv(x: torch.Tensor):
    """Per (token, head) symmetric int8: x [B, T, hk, d] ->
    (int8 values, scales [B, T, hk] in x.dtype)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(x.dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [K, N] -> nibble-packed int8 [K//2, N]:
    rows [0, K/2) in the low nibble, rows [K/2, K) in the high nibble
    (split-half, so packed weights interchange with the JAX package)."""
    K = q.shape[0]
    q32 = q.to(torch.int32)
    packed = (q32[: K // 2] & 0x0F) | ((q32[K // 2:] & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8)


class QuantDense(nn.Module):
    """Weight-quantized dense layer for inference.

    Buffers keep the JAX layout: `kernel_q` int8 [in, out] ('int8') or
    nibble-packed [in/2, out] ('int4'), and a per-output-channel f32
    `scale` [out]. In int4 mode a CUDA input at a `small_m_viable_int4`
    shape (every decode-step projection) runs K5; any other input computes
    JAX's non-kernel halves contraction. In int8 mode with
    `matvec_kernel`, a CUDA input at a `small_m_viable(..., MAX_QUANT_M)`
    shape (decode steps and speculative verify steps) runs K4; any other
    input dequantizes the weight in its dtype before the dot, as JAX
    does."""

    def __init__(self, in_features: int, features: int, mode: str = "int8",
                 use_bias: bool = False, *, device=None,
                 dtype: torch.dtype = torch.bfloat16,
                 matvec_kernel: bool = False):
        super().__init__()
        self.matvec_kernel = matvec_kernel
        if mode not in ("int8", "int4"):
            raise NotImplementedError(f"QuantDense mode {mode!r} is not "
                                      "ported")
        if mode == "int4" and in_features % 2:
            raise ValueError("int4 mode needs an even input dim")
        self.in_features, self.features, self.mode = (in_features, features,
                                                      mode)
        rows = in_features // 2 if mode == "int4" else in_features
        self.register_buffer("kernel_q", torch.empty(
            rows, features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(
            features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device,
                                              dtype=dtype))
                     if use_bias else None)

    def forward(self, x):
        lead = x.shape[:-1]
        m = int(np.prod(lead)) if lead else 1
        if self.mode == "int4":
            if x.is_cuda and small_m_viable_int4(m, self.in_features,
                                                 self.features):
                y = quant_small_m_matmul_int4(
                    x.reshape(m, self.in_features).contiguous(),
                    self.kernel_q, self.scale).reshape(*lead, self.features)
            else:
                lo, hi = unpack_int4_halves(self.kernel_q)
                h = self.in_features // 2
                sc = self.scale[None, :].to(x.dtype)
                y = (x[..., :h].float() @ (lo.to(x.dtype) * sc).float()
                     + x[..., h:].float() @ (hi.to(x.dtype) * sc).float())
        elif (self.matvec_kernel and x.is_cuda
              and small_m_viable(m, self.in_features, self.features,
                                 max_m=MAX_QUANT_M)):
            y = quant_small_m_matmul(
                x.reshape(m, self.in_features).contiguous(), self.kernel_q,
                self.scale).reshape(*lead, self.features)
        else:
            wd = self.kernel_q.to(x.dtype) * self.scale[None, :].to(x.dtype)
            y = x.float() @ wd.float()
        y = y.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class PallasDense(nn.Linear):
    """nn.Linear that sends small-M (decode-step) products on CUDA tensors
    to K3 (port of JAX's `PallasDense`; the parameters are nn.Linear's, so
    weights load and quantize as for any nn.Linear). K3 reads the [N, K]
    weight in place through its [K, N] view `weight.t()`. Any other input
    computes JAX's non-kernel formula: the weight cast to x's dtype, a
    float32 product, the result cast back."""

    def forward(self, x):
        lead = x.shape[:-1]
        m = int(np.prod(lead)) if lead else 1
        if x.is_cuda and small_m_viable(m, self.in_features,
                                        self.out_features):
            y = small_m_matmul(x.reshape(m, self.in_features).contiguous(),
                               self.weight.t()).reshape(*lead,
                                                        self.out_features)
        else:
            y = F.linear(x.float(),
                         self.weight.to(x.dtype).float()).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _make_dense(cfg: DecoderConfig, in_features: int, features: int,
                use_bias: bool = False, device=None) -> nn.Module:
    if cfg.quant:
        return QuantDense(in_features, features, mode=cfg.quant,
                          use_bias=use_bias, device=device, dtype=cfg.dtype,
                          matvec_kernel=cfg.matvec_kernel)
    if cfg.matvec_kernel:
        return PallasDense(in_features, features, bias=use_bias,
                           device=device, dtype=cfg.dtype)
    return nn.Linear(in_features, features, bias=use_bias, device=device,
                     dtype=cfg.dtype)


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        kvd = cfg.num_key_value_heads * cfg.head_dim
        b = cfg.attention_bias
        if cfg.fused_qkv:
            self.qkv_proj = _make_dense(cfg, d, d + 2 * kvd, b, device)
        else:
            self.q_proj = _make_dense(cfg, d, d, b, device)
            self.k_proj = _make_dense(cfg, d, kvd, b, device)
            self.v_proj = _make_dense(cfg, d, kvd, b, device)
        self.o_proj = _make_dense(cfg, d, d, b, device)

    def _proj(self, x):
        cfg = self.cfg
        if cfg.fused_qkv:
            kvd = cfg.num_key_value_heads * cfg.head_dim
            return self.qkv_proj(x).split(
                [cfg.hidden_size, kvd, kvd], dim=-1)
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)

    def forward(self, x, cos, sin, mask=None,
                cache: Optional[KVCache] = None, cache_idx=None,
                layer_idx: int = 0, attn_window: Optional[int] = None):
        """mask: [B, Tq, Tk] bool (True = attend). With a cache, this
        layer writes its K/V at `cache_idx` [B, T] (pad tokens point at
        the dump slot max_len-1) and attends over its cache slice, cut to
        its first `attn_window` slots when that is below max_len (the
        windowed KV read: every valid position lies below the window, so
        the keys cut off are masked ones). Decode attention is plain
        matmul + softmax, as JAX leaves it to XLA."""
        cfg = self.cfg
        B, T, _ = x.shape
        h, hk, p = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        q, k, v = self._proj(x)
        q = apply_rope(q.reshape(B, T, h, p), cos, sin)
        k = apply_rope(k.reshape(B, T, hk, p), cos, sin)
        v = v.reshape(B, T, hk, p)

        k_scale = v_scale = None
        if cache is not None:
            b_idx = torch.arange(B, device=x.device)[:, None]
            if cache.k_scale is not None:
                kq, k_s = _quantize_kv(k)
                vq, v_s = _quantize_kv(v)
                cache.k[layer_idx][b_idx, cache_idx] = kq
                cache.v[layer_idx][b_idx, cache_idx] = vq
                cache.k_scale[layer_idx][b_idx, cache_idx] = k_s
                cache.v_scale[layer_idx][b_idx, cache_idx] = v_s
                # the scales fold into the small score / prob tensors
                k_scale = cache.k_scale[layer_idx]
                v_scale = cache.v_scale[layer_idx]
            else:
                cache.k[layer_idx][b_idx, cache_idx] = k
                cache.v[layer_idx][b_idx, cache_idx] = v
            k, v = cache.k[layer_idx], cache.v[layer_idx]
            if attn_window is not None and attn_window < k.shape[1]:
                k, v = _window(k, attn_window), _window(v, attn_window)
                if k_scale is not None:
                    k_scale = _window(k_scale, attn_window)
                    v_scale = _window(v_scale, attn_window)

        # GQA: group the query heads per KV head instead of repeating K/V
        q = q.reshape(B, T, hk, h // hk, p)
        out = _attend(q, k, v, k_scale, v_scale, mask, x.dtype)
        return self.o_proj(out.reshape(B, T, h * p))


def _window(t: torch.Tensor, attn_window: int) -> torch.Tensor:
    """The first `attn_window` slots of a layer's cache slice [B, S, ...]
    (a view: the attention's one copy of K and V reads only these)."""
    return t[:, :attn_window]


def _mm_f32(a, b):
    """Batched a @ b with float32 accumulation and a float32 result. On
    the card bf16 operands stay at their width (bmm's out_dtype); the CPU
    widens them first (its bmm has no out_dtype), which rounds nothing:
    every product of two bf16 values is exact in float32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _attend(q, k, v, k_scale, v_scale, mask, dtype):
    """Attention of q [B, T, hk, rep, p] over k, v [B, S, hk, p], JAX's
    einsums with preferred_element_type=float32: K and V (int8 converted
    to `dtype`, or as stored) are copied once each into the [B, hk, S, p]
    layout a batched product reads, the int8 scales fold into the scores
    and the probabilities, and the products accumulate in float32, so no
    float32 copy of the cache is made. Returns [B, T, hk, rep, p] in
    `dtype`."""
    B, T, hk, rep, p = q.shape
    S = k.shape[1]

    def heads_major(t):
        # the layer's one copy of K or V: the conversion and the permute
        # in one kernel
        out = torch.empty((B, hk, S, p), dtype=dtype, device=t.device)
        return out.copy_(t.permute(0, 2, 1, 3)).view(B * hk, S, p)

    kb, vb = heads_major(k), heads_major(v)
    qb = q.to(dtype).permute(0, 2, 3, 1, 4).reshape(B * hk, rep * T, p)
    scores = _mm_f32(qb, kb.transpose(1, 2)).view(B, hk, rep, T, S)
    if k_scale is not None:
        scores = scores * k_scale.float().movedim(1, -1)[
            :, :, None, None, :]
    scores = scores / math.sqrt(p)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float().movedim(1, -1)[:, :, None, None, :]
    probs = probs.to(dtype).view(B * hk, rep * T, S)
    out = _mm_f32(probs, vb).to(dtype).view(B, hk, rep, T, p)
    return out.permute(0, 3, 1, 2, 4)


class DecoderMLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, i = cfg.hidden_size, cfg.intermediate_size
        if cfg.fused_qkv:  # phi3 layout pairs fused attn with gate_up_proj
            self.gate_up_proj = _make_dense(cfg, d, 2 * i, device=device)
        else:
            self.gate_proj = _make_dense(cfg, d, i, device=device)
            self.up_proj = _make_dense(cfg, d, i, device=device)
        self.down_proj = _make_dense(cfg, i, d, device=device)

    def forward(self, x):
        if self.cfg.fused_qkv:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=cfg.dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.self_attn = DecoderAttention(cfg, device)
        self.mlp = DecoderMLP(cfg, device)

    def forward(self, x, cos, sin, mask=None, cache=None, cache_idx=None,
                layer_idx: int = 0, attn_window: Optional[int] = None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask=mask,
                               cache=cache, cache_idx=cache_idx,
                               layer_idx=layer_idx, attn_window=attn_window)
        h = self.post_attention_layernorm(x)
        return x + self.mlp(h), zero_aux(h)


class DecoderLM(nn.Module):
    """embed -> layers -> norm -> lm_head.

    forward modes: full sequence without a cache ([B, T] inputs), prefill
    with a cache, and decode (T = 1) against the cache. `inputs_embeds`
    bypasses the embedding (the LLaVA image splice feeds embeddings).

    With a cache, `attn_window` (below max_len) makes every layer attend
    over the cache's first `attn_window` slots only, the mask built over
    as many keys; the caller's contract is pos + T <= attn_window, and
    then the tokens are those of the whole cache. `pos_in_place` advances
    `cache.pos` in place and returns `cache` itself, so a captured step
    writes the new positions into the same buffer; otherwise the returned
    cache holds a new pos tensor."""

    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=device, dtype=cfg.dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        if not cfg.tie_word_embeddings:
            if cfg.quant:
                # int4 keeps the lm_head at int8, as in JAX (vocab widths
                # do not tile the int4 kernel)
                self.lm_head = QuantDense(cfg.hidden_size, cfg.vocab_size,
                                          mode="int8", **kw)
            else:
                self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                         bias=False, **kw)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids).to(self.cfg.dtype)

    def forward(self, input_ids=None, *, inputs_embeds=None,
                attention_mask=None, position_ids=None,
                cache: Optional[KVCache] = None,
                attn_window: Optional[int] = None,
                pos_in_place: bool = False):
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = inputs_embeds
        B, T, _ = x.shape
        dev = x.device

        cache_idx = None
        if cache is not None:
            valid = (attention_mask.long() if attention_mask is not None
                     else torch.ones((B, T), dtype=torch.long, device=dev))
            cum = torch.cumsum(valid, dim=1) - 1
            kv_len = cache.max_len
            # pad tokens write to the dump slot kv_len-1, so their K/V
            # never shadow real positions
            cache_idx = torch.where(
                valid.bool(),
                torch.clamp(cache.pos[:, None] + cum, max=kv_len - 1),
                kv_len - 1)
            qpos = cache.pos[:, None] + torch.clamp(cum, min=0)
            if position_ids is None:
                position_ids = qpos
            if attn_window is not None and attn_window < kv_len:
                # the windowed read's keys; validity is the caller's
                # contract (pos + T <= attn_window)
                kv_len = attn_window
            mask = (torch.arange(kv_len, device=dev)[None, None]
                    <= qpos[:, :, None])
        else:
            if position_ids is None:
                position_ids = torch.arange(T, device=dev)[None].expand(B, T)
            mask = position_ids[:, None, :] <= position_ids[:, :, None]
            if attention_mask is not None:
                mask = mask & attention_mask[:, None, :].bool()
        cos, sin = rope_tables(
            cfg, position_ids, cache.max_len if cache is not None else T)

        total_aux = torch.zeros((), dtype=torch.float32, device=dev)
        auxes: List[MoEAux] = []
        for li, layer in enumerate(self.layers):
            x, aux = layer(x, cos, sin, mask, cache, cache_idx, li,
                           attn_window)
            total_aux = total_aux + aux.aux_loss
            auxes.append(aux)

        x = self.norm(x)
        # logits in float32, as the JAX lm_head on an f32 input
        if cfg.tie_word_embeddings:
            logits = x.float() @ self.embed_tokens.weight.float().T
        elif cfg.quant:
            logits = self.lm_head(x.float())
        else:
            logits = F.linear(x.float(), self.lm_head.weight.float())

        new_cache = None
        if cache is not None:
            advance = (attention_mask.long().sum(dim=-1)
                       if attention_mask is not None
                       else torch.full((B,), T, dtype=torch.long,
                                       device=dev))
            if pos_in_place:
                cache.pos.add_(advance)
                new_cache = cache
            else:
                new_cache = dataclasses.replace(cache,
                                                pos=cache.pos + advance)
        return logits, new_cache, {"total_aux_loss": total_aux,
                                   "layers": auxes}
