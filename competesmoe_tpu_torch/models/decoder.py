"""HF-style causal decoder (Phi-3.5 / llama family) in PyTorch (port of
competesmoe_tpu/models/decoder.py).

Covers every option of JAX's `DecoderConfig`: RMSNorm with an exact
1/sqrt or MPT's bias-free LayerNorm (either may be folded into the next
projection, `fold_norm_scales`), plain and Phi-3 longrope rotary tables
or ALiBi, MHA/GQA with fused (`qkv_proj`/`gate_up_proj`) or split
projections, the SiLU-gated or MPT's GELU MLP or a MoE FFN from the
multimodal registry (`moe_name`, Mixtral's `mixtral` block among them,
whose aux losses the forward sums), a sliding window on every
mask path, a stacked or per-layer KV cache (bf16 or int8 with per-(slot,
head) scales), deferred decode writes, and weight-quantized projections
(`QuantDense` int8 / packed int4 / w8a8).

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

Sequence parallelism (an active `parallel.seq_context` mesh, training
without a cache): each rank holds its block of the spliced sequence and
its positions and validity. Where JAX takes the masked ring (no sliding
window, no ALiBi, as many KV heads as query heads) the attention runs
`parallel.ring_attention.make_ring_attention_masked` and no dense mask
is built; otherwise it gathers the sequence's K/V, positions and validity
over 'seq' and attends its own query rows.

Tensor parallelism (`parallel/tensor_parallel.py` places the weights):
an attention whose heads are sharded holds `n_heads` / `n_kv_heads` of
them and sums its output over `tp_axis` before `o_proj`'s bias (`MLP`
the same after `down_proj`); a column-parallel lm_head's logits are
gathered; a cache from `DecoderLM.new_cache` holds the KV heads the
attention holds. A cache made with `rows` (the mesh's 'data' axis) holds this rank's block of the slots: a forward over it runs
those rows of its inputs and gathers every rank's logits.
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
import torch.utils.checkpoint

from ..device import resolve_device
from ..moe.config import MoEArgs
from ..moe.layers import MoEAux, zero_aux
from ..moe.registry import get_moe
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
    # 'int8' (w8a16) | 'int4' (packed w4a16; lm_head stays int8) |
    # 'w8a8' (int8 weights, activations quantized per row; lm_head too)
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
    """Raise for unknown option values (an unknown `moe_name` raises in
    the registry)."""
    known = {"quant": (None, "int8", "int4", "w8a8"),
             "kv_quant": (None, "int8"),
             "norm_type": ("rmsnorm", "layernorm_nobias"),
             "mlp_type": ("silu_glu", "gelu"),
             "cache_layout": ("stacked", "per_layer")}
    for field, values in known.items():
        if getattr(cfg, field) not in values:
            raise ValueError(f"unknown {field} {getattr(cfg, field)!r}")


class RMSNorm(nn.Module):
    """`folded`: the weight was folded into the next projection
    (`fold_norm_scales`) and is not read; the parameter stays, so
    checkpoints keep their names."""

    def __init__(self, dim: int, eps: float, *, device=None,
                 dtype: torch.dtype = torch.float32, folded: bool = False):
        super().__init__()
        self.eps = eps
        self.folded = folded
        self.weight = nn.Parameter(torch.empty(dim, device=device,
                                               dtype=dtype))

    def normalize(self, xf):
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        # exact 1/sqrt, as the JAX version (rsqrt is an approximation)
        return xf / torch.sqrt(var + self.eps)

    def forward(self, x):
        xf = self.normalize(x.float())
        if self.folded:
            return xf.to(x.dtype)
        return (xf * self.weight.float()).to(x.dtype)


class LayerNormNoBias(RMSNorm):
    """MPT's bias-free LayerNorm (no_bias=True)."""

    def normalize(self, xf):
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
        return (xf - mean) / torch.sqrt(var + self.eps)


def make_norm(cfg: DecoderConfig, foldable: bool = False,
              device=None) -> RMSNorm:
    cls = (LayerNormNoBias if cfg.norm_type == "layernorm_nobias"
           else RMSNorm)
    return cls(cfg.hidden_size, cfg.rms_norm_eps, device=device,
               dtype=cfg.dtype, folded=cfg.norm_folded and foldable)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Standard ALiBi geometric slopes (HF build_mpt_alibi_tensor)."""
    n = 2 ** math.ceil(math.log2(n_heads))
    base = 2.0 ** (-8.0 / n)
    slopes = np.power(base, np.arange(1, n + 1))
    if n != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _alibi_slopes(n_heads: int, n_kv: int, device: torch.device):
    """The slopes as a float32 [hk, rep] tensor on `device`, built once
    (a captured step must not copy from the host)."""
    return torch.as_tensor(alibi_slopes(n_heads), device=device).reshape(
        n_kv, n_heads // n_kv)


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
    """k/v (dtype or int8), pos [B] current length per sequence, and in
    int8 mode per (layer, B, slot, kv-head) dequant scales. The 'stacked'
    layout holds each as one [L, B, max_len, kv_heads, head_dim] tensor,
    'per_layer' as a tuple of L [B, max_len, kv_heads, head_dim] tensors;
    `k[i]` is layer i's buffer under either, and `layer_parts` gives
    code that copies rows one view per part with a leading layer axis."""

    k: object
    v: object
    pos: torch.Tensor
    k_scale: object = None
    v_scale: object = None
    # tensor-parallel serving's 'data' axis (`parallel.mesh.Axis`): the
    # cache holds this rank's block of the batch's rows
    rows: object = None

    @property
    def per_layer(self) -> bool:
        return isinstance(self.k, tuple)

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]

    @property
    def batch(self) -> int:
        return self.k[0].shape[0]

    def buffers(self) -> list:
        """The cache tensors in order k, v (, k_scale, v_scale)."""
        return [b for b in (self.k, self.v, self.k_scale, self.v_scale)
                if b is not None]

    def local(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The rows of a whole batch's `t` [B, ...] this cache holds."""
        if self.rows is None or t is None:
            return t
        n = t.shape[0] // self.rows.size
        return t[self.rows.index * n:(self.rows.index + 1) * n]

    @classmethod
    def create(cls, cfg: DecoderConfig, batch: int, max_len: int,
               device=None, rows=None,
               kv_heads: Optional[int] = None) -> "KVCache":
        """`rows`: an axis whose ranks split the batch's rows (this rank
        holds its block), as JAX's `kv_cache_sharding` puts the slots on
        'data'; `kv_heads`: the KV heads a slot holds (the config's by
        default; `DecoderLM.new_cache` gives a tensor-parallel rank's)."""
        if rows is not None and rows.size > 1:
            if batch % rows.size:
                raise ValueError(f"{batch} cache rows do not divide over the "
                                 f"{rows.size} ranks of '{rows.name}'")
            batch //= rows.size
        else:
            rows = None
        shape = (batch, max_len, kv_heads or cfg.num_key_value_heads,
                 cfg.head_dim)
        L = cfg.num_hidden_layers

        def buf(shp, dtype):
            if cfg.cache_layout == "per_layer":
                return tuple(torch.zeros(shp, dtype=dtype, device=device)
                             for _ in range(L))
            return torch.zeros((L,) + shp, dtype=dtype, device=device)

        pos = torch.zeros((batch,), dtype=torch.long, device=device)
        if cfg.kv_quant == "int8":
            return cls(k=buf(shape, torch.int8), v=buf(shape, torch.int8),
                       pos=pos, k_scale=buf(shape[:-1], cfg.dtype),
                       v_scale=buf(shape[:-1], cfg.dtype), rows=rows)
        return cls(k=buf(shape, cfg.dtype), v=buf(shape, cfg.dtype), pos=pos,
                   rows=rows)


def layer_parts(buf) -> List[torch.Tensor]:
    """A cache buffer as views with a leading layer axis: the stacked
    tensor itself, or each per-layer tensor as a [1, B, ...] view, so one
    indexed copy `part[:, rows] = ...` serves both layouts."""
    return [b[None] for b in buf] if isinstance(buf, tuple) else [buf]


def take_rows(buf, idx):
    """The rows `idx` of a cache buffer, in its layout (a copy)."""
    if isinstance(buf, tuple):
        return tuple(b[idx] for b in buf)
    return buf[:, idx]


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
    does. In w8a8 mode (JAX's, computed in XLA there) the activations are
    quantized per row on the fly and the int8 x int8 product accumulates
    in int32 exactly (`w8a8_accumulate`)."""

    def __init__(self, in_features: int, features: int, mode: str = "int8",
                 use_bias: bool = False, *, device=None,
                 dtype: torch.dtype = torch.bfloat16,
                 matvec_kernel: bool = False):
        super().__init__()
        self.matvec_kernel = matvec_kernel
        if mode not in ("int8", "int4", "w8a8"):
            raise ValueError(f"unknown QuantDense mode {mode!r}")
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
        if self.mode == "w8a8":
            acc, amax = w8a8_accumulate(x, self.kernel_q)
            y = acc.float() * (amax / 127.0) * self.scale
        elif self.mode == "int4":
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


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> int32, exact. torch._int_mm takes
    more than 16 rows on CUDA, so fewer are padded with zero rows."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = F.pad(a, (0, 0, 0, 24 - m))
    return torch._int_mm(a, b)[:m]


def w8a8_accumulate(x: torch.Tensor, kernel_q: torch.Tensor):
    """JAX's w8a8 activation quantization and product: x [..., K] to int8
    per row (scale 127 / max|row|, round half to even), then the int8
    product with `kernel_q` [K, N] accumulated in int32. Returns (acc
    int32 [..., N], amax float32 [..., 1]). The sums reach 127 * 127 * K,
    past float32's exact integers, so the product is an integer one."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    xs = x.float() * (127.0 / torch.clamp(amax, min=1e-8))
    x8 = torch.round(xs).clamp(-127, 127).to(torch.int8)
    lead, k = x8.shape[:-1], x8.shape[-1]
    acc = _int8_mm(x8.reshape(-1, k).contiguous(), kernel_q)
    return acc.reshape(*lead, kernel_q.shape[1]), amax


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
        # tensor parallel (`parallel.tensor_parallel`): the heads held, the
        # first one's index, the axis the output sums over, and o_proj's
        # bias, added after the sum
        self.n_heads, self.n_kv_heads = (cfg.num_attention_heads,
                                         cfg.num_key_value_heads)
        self.head_offset = 0
        self.tp_axis = None
        self.out_bias = None

    def _proj(self, x):
        cfg = self.cfg
        if cfg.fused_qkv:
            qd = self.n_heads * cfg.head_dim
            kvd = self.n_kv_heads * cfg.head_dim
            return self.qkv_proj(x).split([qd, kvd, kvd], dim=-1)
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)

    def _out(self, out):
        """o_proj, summed over the tensor-parallel axis before its bias."""
        y = self.o_proj(out)
        return _tp_sum(y, self.tp_axis, self.out_bias)

    def forward(self, x, cos, sin, mask=None,
                cache: Optional[KVCache] = None, cache_idx=None,
                layer_idx: int = 0, attn_window: Optional[int] = None,
                pending: Optional[list] = None, seq=None):
        """mask: [B, Tq, Tk] bool (True = attend). With a cache, this
        layer writes its K/V at `cache_idx` [B, T] (pad tokens point at
        the dump slot max_len-1) and attends over its cache slice, cut to
        its first `attn_window` slots when that is below max_len (the
        windowed KV read: every valid position lies below the window, so
        the keys cut off are masked ones). With `pending` (deferred
        decode, T == 1) it writes nothing: it attends over the cache plus
        the current token's K/V as a self column at the end of the key
        axis, and appends what to write to `pending` (int8 KV: the self
        term is quantized and dequantized, as the cache would hold it).
        With ALiBi, `cos` carries the query positions [B, T, 1]. Decode
        attention is plain matmul + softmax, as JAX leaves it to XLA.
        `seq` (sequence parallel, no cache): ('ring', mesh, qpos, kvalid)
        for the masked ring, or ('gather', axis) to attend over the
        sequence's gathered K/V with `mask` [B, T, S]."""
        cfg = self.cfg
        B, T, _ = x.shape
        h, hk, p = self.n_heads, self.n_kv_heads, cfg.head_dim
        q, k, v = self._proj(x)
        q = q.reshape(B, T, h, p)
        k = k.reshape(B, T, hk, p)
        v = v.reshape(B, T, hk, p)
        if not cfg.use_alibi:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if seq is not None and seq[0] == "ring":
            from ..parallel.ring_attention import make_ring_attention_masked
            from ..parallel.seq_context import seq_axis
            _, mesh, qpos, kvalid = seq
            out = make_ring_attention_masked(mesh, seq_axis())(
                q, k, v, qpos, qpos, kvalid)
            return self._out(out.reshape(B, T, h * p))
        if seq is not None:
            from ..parallel import collectives as C
            k = C.all_gather(k.contiguous(), seq[1], 1)
            v = C.all_gather(v.contiguous(), seq[1], 1)

        k_scale = v_scale = self_kv = None
        if cache is not None:
            quant = cache.k_scale is not None
            if quant:
                kq, k_s = _quantize_kv(k)
                vq, v_s = _quantize_kv(v)
            if pending is not None:
                if quant:
                    pending.append((kq, vq, k_s, v_s))
                    self_kv = (kq.to(x.dtype) * k_s[..., None].to(x.dtype),
                               vq.to(x.dtype) * v_s[..., None].to(x.dtype))
                else:
                    pending.append((k, v))
                    self_kv = (k, v)
            else:
                b_idx = torch.arange(B, device=x.device)[:, None]
                if quant:
                    cache.k[layer_idx][b_idx, cache_idx] = kq
                    cache.v[layer_idx][b_idx, cache_idx] = vq
                    cache.k_scale[layer_idx][b_idx, cache_idx] = k_s
                    cache.v_scale[layer_idx][b_idx, cache_idx] = v_s
                else:
                    cache.k[layer_idx][b_idx, cache_idx] = k
                    cache.v[layer_idx][b_idx, cache_idx] = v
            if quant:
                # the scales fold into the small score / prob tensors
                k_scale = cache.k_scale[layer_idx]
                v_scale = cache.v_scale[layer_idx]
            k, v = cache.k[layer_idx], cache.v[layer_idx]
            if attn_window is not None and attn_window < k.shape[1]:
                k, v = _window(k, attn_window), _window(v, attn_window)
                if k_scale is not None:
                    k_scale = _window(k_scale, attn_window)
                    v_scale = _window(v_scale, attn_window)

        alibi = None
        if cfg.use_alibi:
            slopes = _alibi_slopes(cfg.num_attention_heads,
                                   cfg.num_key_value_heads, x.device)
            kv0 = self.head_offset // (h // hk)
            alibi = (cos[:, :, 0], slopes[kv0:kv0 + hk])
        # GQA: group the query heads per KV head instead of repeating K/V
        q = q.reshape(B, T, hk, h // hk, p)
        out = _attend(q, k, v, k_scale, v_scale, mask, x.dtype,
                      self_kv=self_kv, alibi=alibi)
        return self._out(out.reshape(B, T, h * p))


def _tp_sum(y: torch.Tensor, axis, bias) -> torch.Tensor:
    """A row-parallel projection's output: the sum over `axis` (none for
    a replicated one), then the bias."""
    if axis is not None:
        from ..parallel import collectives as C
        y = C.all_reduce(y, axis)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _window(t: torch.Tensor, attn_window: int) -> torch.Tensor:
    """The first `attn_window` slots of a layer's cache slice [B, S, ...]
    (a view: the attention's one copy of K and V reads only these)."""
    return t[:, :attn_window]


class _MatmulF32(torch.autograd.Function):
    """a @ b (2-D or batched 3-D) with float32 accumulation and a float32
    result: JAX's product of operands widened to float32 (or its einsum
    with preferred_element_type=float32). On the card operands of one
    low-precision dtype stay at their width (mm/bmm's out_dtype, which
    has no autograd rule of its own); the CPU widens them first, which
    rounds nothing: every product of two bf16 values is exact in float32.
    The backward is JAX's: each operand's gradient is a float32 product
    of the float32 cotangent with the other operand, rounded to the
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype == b.dtype and a.dtype != torch.float32:
            mm = torch.bmm if a.dim() == 3 else torch.mm
            return mm(a, b, out_dtype=torch.float32)
        return torch.matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def _mm_f32(a, b):
    """a @ b with float32 accumulation and a float32 result
    (`_MatmulF32`)."""
    return _MatmulF32.apply(a, b)


def _attend(q, k, v, k_scale, v_scale, mask, dtype, self_kv=None,
            alibi=None):
    """Attention of q [B, T, hk, rep, p] over k, v [B, S, hk, p], JAX's
    einsums with preferred_element_type=float32: K and V (int8 converted
    to `dtype`, or as stored) are copied once each into the [B, hk, S, p]
    layout a batched product reads, the int8 scales fold into the scores
    and the probabilities, and the products accumulate in float32, so no
    float32 copy of the cache is made. `self_kv` (deferred decode): the
    current tokens' (k, v) [B, T, hk, p], a score column after the cached
    keys whose output adds separately, as in JAX. `alibi`: (query
    positions [B, T] float32, slopes [hk, rep]); the bias is -slope x
    (qpos - kpos) with kpos the key's slot (0 for the self column).
    Returns [B, T, hk, rep, p] in `dtype`."""
    B, T, hk, rep, p = q.shape
    S = k.shape[1]

    def heads_major(t):
        # the layer's one copy of K or V: the conversion and the permute
        # in one kernel
        n = t.shape[1]
        out = torch.empty((B, hk, n, p), dtype=dtype, device=t.device)
        return out.copy_(t.permute(0, 2, 1, 3)).view(B * hk, n, p)

    kb, vb = heads_major(k), heads_major(v)
    qb = q.to(dtype).permute(0, 2, 3, 1, 4).reshape(B * hk, rep * T, p)
    scores = _mm_f32(qb, kb.transpose(1, 2)).view(B, hk, rep, T, S)
    if k_scale is not None:
        scores = scores * k_scale.float().movedim(1, -1)[
            :, :, None, None, :]
    if self_kv is not None:
        ks, vs = (heads_major(t) for t in self_kv)
        n_self = ks.shape[1]
        scores = torch.cat([scores, _mm_f32(qb, ks.transpose(1, 2)).view(
            B, hk, rep, T, n_self)], dim=-1)
    scores = scores / math.sqrt(p)
    if alibi is not None:
        qpos, slopes = alibi
        kpos = torch.arange(S, dtype=torch.float32, device=q.device)
        dist = qpos[:, :, None] - kpos[None, None, :]
        if self_kv is not None:
            dist = torch.cat([dist, torch.zeros_like(dist[:, :, :n_self])],
                             dim=-1)
        scores = scores - (slopes[None, :, :, None, None]
                           * dist[:, None, None, :, :])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    if self_kv is not None:
        probs, self_probs = probs[..., :S], probs[..., S:]
    if v_scale is not None:
        probs = probs * v_scale.float().movedim(1, -1)[:, :, None, None, :]
    probs = probs.to(dtype).reshape(B * hk, rep * T, S)
    out = _mm_f32(probs, vb).to(dtype).view(B, hk, rep, T, p)
    if self_kv is not None:
        out = out + _mm_f32(self_probs.to(dtype).reshape(
            B * hk, rep * T, n_self), vs).to(dtype).view(B, hk, rep, T, p)
    return out.permute(0, 3, 1, 2, 4)


class DecoderMLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, i = cfg.hidden_size, cfg.intermediate_size
        if cfg.mlp_type == "gelu":   # MPT ffn: up -> exact gelu -> down
            i = cfg.expansion_ratio * d
            self.up_proj = _make_dense(cfg, d, i, device=device)
        elif cfg.fused_qkv:  # phi3 layout pairs fused attn with gate_up_proj
            self.gate_up_proj = _make_dense(cfg, d, 2 * i, device=device)
        else:
            self.gate_proj = _make_dense(cfg, d, i, device=device)
            self.up_proj = _make_dense(cfg, d, i, device=device)
        self.down_proj = _make_dense(cfg, i, d, device=device)
        # tensor parallel: the axis down_proj's output sums over, and its
        # bias (`parallel.tensor_parallel`)
        self.tp_axis = None
        self.out_bias = None

    def forward(self, x):
        if self.cfg.mlp_type == "gelu":
            h = F.gelu(self.up_proj(x))
        else:
            if self.cfg.fused_qkv:
                gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
            else:
                gate, up = self.gate_proj(x), self.up_proj(x)
            h = F.silu(gate) * up
        return _tp_sum(self.down_proj(h), self.tp_axis, self.out_bias)


class DecoderLayer(nn.Module):
    """Attention, then the dense MLP (`mlp`) or, with `cfg.moe_name`, a MoE
    FFN of the registry (`moe`, JAX's `layers_<i>/moe`) with the
    decoder's width, `intermediate_size` experts and dtype."""

    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # the input norm folds into qkv, the post-attention norm into the
        # dense MLP's first projection (not into an MoE FFN: the router
        # and every expert would each have to absorb it)
        self.input_layernorm = make_norm(cfg, True, device)
        self.post_attention_layernorm = make_norm(
            cfg, cfg.moe_name is None, device)
        self.self_attn = DecoderAttention(cfg, device)
        if cfg.moe_name is not None:
            self.moe = get_moe(cfg.moe_name)(
                cfg.hidden_size, cfg.hidden_size, n_experts=cfg.num_experts,
                n_selected=cfg.num_selected, args=cfg.moe_args,
                expert_hidden_dim=cfg.intermediate_size, device=device,
                dtype=cfg.dtype)
        else:
            self.mlp = DecoderMLP(cfg, device)

    def forward(self, x, cos, sin, mask=None, cache=None, cache_idx=None,
                layer_idx: int = 0, attn_window: Optional[int] = None,
                pending: Optional[list] = None, step=None,
                train: bool = False, seq=None):
        """Returns (x, the FFN's MoEAux); `step` and `train` reach a MoE
        FFN (its aux losses are computed in training only)."""
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask=mask,
                               cache=cache, cache_idx=cache_idx,
                               layer_idx=layer_idx, attn_window=attn_window,
                               pending=pending, seq=seq)
        h = self.post_attention_layernorm(x)
        if self.cfg.moe_name is not None:
            out, aux = self.moe(h, step=step, train=train)
            return x + out, aux
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
    cache holds a new pos tensor. Every mask is built from position
    tensors on the device (`cache.pos`, `position_ids`), never from host
    values, so a captured step's mask follows its positions. With
    `deferred_decode`, a decode step over a stacked cache writes every
    layer's K/V in one indexed copy after the last layer. `step` and
    `train` reach a MoE FFN; the third output's `total_aux_loss` sums
    its layers' aux losses."""

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
        # the final norm folds into the lm_head; tied embeddings are also
        # the input table, so they cannot absorb it
        self.norm = make_norm(cfg, not cfg.tie_word_embeddings, device)
        # tensor parallel: the axis of a column-parallel lm_head
        self.head_axis = None
        if not cfg.tie_word_embeddings:
            if cfg.quant:
                # int4 keeps the lm_head at int8, as in JAX (vocab widths
                # do not tile the int4 kernel); w8a8 keeps it w8a8
                self.lm_head = QuantDense(
                    cfg.hidden_size, cfg.vocab_size,
                    mode="w8a8" if cfg.quant == "w8a8" else "int8", **kw)
            else:
                self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                         bias=False, **kw)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids).to(self.cfg.dtype)

    def new_cache(self, batch: int, max_len: int, device=None,
                  rows=None) -> KVCache:
        """A KV cache for this decoder: a slot holds the KV heads its
        attention holds (a tensor-parallel rank's share where the heads
        shard)."""
        return KVCache.create(self.cfg, batch, max_len, device, rows=rows,
                              kv_heads=self.layers[0].self_attn.n_kv_heads)

    def forward(self, input_ids=None, *, inputs_embeds=None,
                attention_mask=None, position_ids=None,
                cache: Optional[KVCache] = None,
                attn_window: Optional[int] = None,
                pos_in_place: bool = False, step=None, train: bool = False):
        cfg = self.cfg
        if cache is not None and cache.rows is not None:
            # the cache holds this rank's block of the rows: run those,
            # gather every rank's logits at the end
            input_ids, inputs_embeds, attention_mask, position_ids = (
                cache.local(t) for t in (input_ids, inputs_embeds,
                                         attention_mask, position_ids))
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = inputs_embeds
        B, T, _ = x.shape
        dev = x.device
        sw = cfg.sliding_window

        cache_idx = None
        seq = None
        n_seq = 1
        deferred = (cfg.deferred_decode and cache is not None and T == 1
                    and not cache.per_layer)
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
            kpos = torch.arange(kv_len, device=dev)[None, None]
            qpos = qpos[:, :, None]
            # deferred: the cached slots strictly precede the current
            # token, whose own column (valid iff the token is) comes last
            mask = kpos < qpos if deferred else kpos <= qpos
            if sw:
                mask = mask & (kpos > qpos - sw)
            if deferred:
                mask = torch.cat([mask, valid[:, :, None].bool()], dim=-1)
        else:
            from ..parallel import seq_context
            sp = seq_context.active()
            n_seq = 1 if sp is None else sp[1].size
            if position_ids is None:
                first = 0 if sp is None else sp[1].index * T
                position_ids = (first + torch.arange(T, device=dev))[
                    None].expand(B, T)
            valid = (attention_mask.bool() if attention_mask is not None
                     else None)
            kpos, kvalid = position_ids, valid
            if (sp is not None and not sw and not cfg.use_alibi
                    and cfg.num_attention_heads == cfg.num_key_value_heads):
                # JAX's masked ring: no dense mask; positions and validity
                # travel round the ring with their K/V
                seq = ("ring", sp[0], position_ids,
                       valid if valid is not None
                       else torch.ones((B, T), dtype=torch.bool, device=dev))
                mask = None
            else:
                if sp is not None:
                    # this rank's query rows over the whole sequence
                    from ..parallel import collectives as C
                    kpos = C.raw_all_gather(position_ids.contiguous(),
                                            sp[1], 1)
                    if valid is not None:
                        kvalid = C.raw_all_gather(
                            valid.to(torch.uint8).contiguous(), sp[1],
                            1).bool()
                    seq = ("gather", sp[1])
                qpos = position_ids[:, :, None]
                kp = kpos[:, None, :]
                mask = kp <= qpos
                if sw:
                    mask = mask & (kp > qpos - sw)
                if kvalid is not None:
                    mask = mask & kvalid[:, None, :]
        if cfg.use_alibi:
            # no rotary tables: the positions ride to the attention's
            # distance term in `cos`
            cos = position_ids.float()[..., None]
            sin = torch.zeros_like(cos)
        else:
            cos, sin = rope_tables(
                cfg, position_ids,
                cache.max_len if cache is not None else T * n_seq)

        total_aux = torch.zeros((), dtype=torch.float32, device=dev)
        auxes: List[MoEAux] = []
        pending = [] if deferred else None
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for li, layer in enumerate(self.layers):
            if remat:
                # one checkpoint per layer: its activations are recomputed
                # in backward, only the layer's input stays
                x, aux = torch.utils.checkpoint.checkpoint(
                    layer, x, cos, sin, mask, None, None, li, attn_window,
                    None, step, train, seq, use_reentrant=False)
            else:
                x, aux = layer(x, cos, sin, mask, cache, cache_idx, li,
                               attn_window, pending, step, train, seq)
            total_aux = total_aux + aux.aux_loss
            auxes.append(aux)
        if pending:
            # one write for every layer's K/V of the step
            b_idx = torch.arange(B, device=dev)[:, None]
            for i, buf in enumerate(cache.buffers()):
                buf[:, b_idx, cache_idx] = torch.stack([p[i]
                                                        for p in pending])

        x = self.norm(x)
        # logits in float32, as the JAX lm_head on an f32 input
        if cfg.quant and not cfg.tie_word_embeddings:
            logits = self.lm_head(x.float())
        else:
            head = (self.embed_tokens.weight if cfg.tie_word_embeddings
                    else self.lm_head.weight)
            logits = _mm_f32(x.reshape(-1, x.shape[-1]), head.t()).reshape(
                *x.shape[:-1], -1)
            if self.head_axis is not None:
                # a column-parallel lm_head: every rank's vocabulary block
                from ..parallel import collectives as C
                logits = C.all_gather(logits, self.head_axis, dim=-1)
        if cache is not None and cache.rows is not None:
            from ..parallel import collectives as C
            logits = C.all_gather(logits, cache.rows, dim=0)

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


# ---------------------------------------------------------------------------
# Serving-mode weight transforms
# ---------------------------------------------------------------------------

def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: int8 [K//2, N] -> sign-extended int8 [K, N]
    (the whole matrix; compute paths use the halves)."""
    return torch.cat(unpack_int4_halves(p), dim=0)


@torch.no_grad()
def _fold_into_dense(proj: nn.Module, w: torch.Tensor) -> None:
    """Absorb a per-input-channel scale w [in] into a projection in place:
    an nn.Linear (or PallasDense) weight is scaled in float32 and cast
    back; a QuantDense int8 or int4 kernel is dequantized, scaled per
    input channel and requantized per output channel (JAX's
    `_fold_into_dense`; round half to even on both sides)."""
    wf32 = w.float()
    if not isinstance(proj, QuantDense):
        proj.weight.copy_(proj.weight.float() * wf32[None, :])
        return
    packed = proj.mode == "int4"
    kq = unpack_int4(proj.kernel_q) if packed else proj.kernel_q
    qmax = 7 if packed else 127
    wf = kq.float() * proj.scale.float()[None, :] * wf32[:, None]
    s_new = torch.clamp(wf.abs().amax(dim=0), min=1e-8) / qmax
    q = torch.round(wf / s_new[None, :]).clamp(-qmax, qmax).to(torch.int8)
    proj.kernel_q.copy_(pack_int4(q) if packed else q)
    proj.scale.copy_(s_new)


@torch.no_grad()
def fold_norm_scales(decoder: DecoderLM) -> DecoderLM:
    """Fold every foldable norm's weight into the following projection,
    reset it to ones and mark the norm folded, in place (JAX's
    `fold_norm_scales` on a param tree, which the caller pairs with a
    model built with norm_folded=True): input_layernorm -> qkv (or
    q/k/v); post_attention_layernorm -> gate_up (or gate and up, or MPT's
    up), unless the FFN is an MoE; the final norm -> lm_head, unless the
    embeddings are tied. Works on bf16, int8 and int4 projections (an
    int4 model's lm_head is int8). Sets `decoder.cfg.norm_folded`."""
    cfg = decoder.cfg

    def fold(norm, projs):
        for proj in projs:
            _fold_into_dense(proj, norm.weight)
        norm.weight.fill_(1.0)
        norm.folded = True

    for layer in decoder.layers:
        attn = layer.self_attn
        fold(layer.input_layernorm,
             [attn.qkv_proj] if hasattr(attn, "qkv_proj")
             else [attn.q_proj, attn.k_proj, attn.v_proj])
        if cfg.moe_name is None:
            fold(layer.post_attention_layernorm,
                 [getattr(layer.mlp, n) for n in ("gate_up_proj",
                                                  "gate_proj", "up_proj")
                  if hasattr(layer.mlp, n)])
    if not cfg.tie_word_embeddings:
        fold(decoder.norm, [decoder.lm_head])
    decoder.cfg = dataclasses.replace(cfg, norm_folded=True)
    return decoder
