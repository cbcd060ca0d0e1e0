"""MoA, Mixture-of-Attention (port of competesmoe_tpu/models/moa.py):
`AttentionExpertBank` and `FullMoeRopeAttention`.

Each of the q/k/v/o projections is an expert bank routed per token and
per head: gate logits [B, T, H, E] (computed in the activation dtype,
read in float32), optional expert dropout (dropped experts masked to
-inf before the top-k), top-k per head (`ops.routing.top_k`, jax.lax's
tie rule), and the sigmoid of the ORIGINAL logits at the chosen ids as
combine weights. As in JAX, tokens go through ALL experts of a head with
one einsum, and the outputs are mixed with the top-k weights scattered
into a dense [B, T, H, E] mixture: the same function as the sparse
gather, and the same gradients.

Attention is JAX's dense einsum (causal over the suffix, the carried
prefix of the Transformer-XL carry fully visible); MoA never reaches
flash, so K2 launches no time on a MoA layer. q and k are each scaled by
p^-1/4 before RoPE.

Randomness (`att_selection_dropout`, `att_expert_dropout`) is drawn
before the attention runs, by `draw_noise` from a generator the caller
passes, and handed in as tensors: a block recomputed under remat then
sees the same masks. Train with either above 0 and no noise raises.

Balance: with train and `balance_loss_coef`, each bank adds
`att_entropy_balance(logits) * coef / 10` (the is_att `div = 10`), logged
as `att_{name}_ebalance`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..moe.layers import MoEAux
from ..ops import losses as L
from ..ops import routing as R

NAMES = ("q", "k", "v", "o")


def att_entropy_balance(logits: torch.Tensor) -> torch.Tensor:
    """Entropy balance with the head dim kept: logits [B, T, H, E] ->
    [B, H, T, E], log-mean over the tokens, entropy per [B, H], mean."""
    return L.entropy_balance_loss(logits.transpose(1, 2))


def renormed_rows_(w: torch.Tensor, std: float, g: torch.Generator):
    """N(0, std) rows renormed to unit norm, then scaled so the global
    std is the mean row std of the draw (JAX `_renormed_rows_init`)."""
    x = torch.randn(w.shape, generator=g, device=w.device) * std
    std_t = torch.std(x, dim=-1, keepdim=True, correction=0)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    w.copy_(x * (std_t / torch.std(x, correction=0)))


class AttentionExpertBank(nn.Module):
    """One projection's expert bank: `w_gate` [H*E, d_sel] and `experts`
    [H, E, in, out] (the JAX layout, carried by `convert.from_jax_params`
    as it is)."""

    def __init__(self, n_heads: int, n_experts: int, d_sel: int,
                 in_size: int, out_size: int, topk: int = 2,
                 std_gate: float = 0.02, std_expert: float = 0.02,
                 expert_dropout: float = 0.0, selection_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.n_heads, self.n_experts, self.topk = n_heads, n_experts, topk
        self.std_gate, self.std_expert = std_gate, std_expert
        self.expert_dropout = expert_dropout
        self.selection_dropout = selection_dropout
        self.dtype = dtype
        self.w_gate = nn.Parameter(torch.empty(n_heads * n_experts, d_sel,
                                               device=device))
        self.experts = nn.Parameter(torch.empty(n_heads, n_experts, in_size,
                                                out_size, device=device))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        renormed_rows_(self.w_gate, self.std_gate, g)
        self.experts.copy_(torch.randn(self.experts.shape, generator=g,
                                       device=self.experts.device)
                           * self.std_expert)

    def draw_noise(self, x: torch.Tensor, g: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
        """Uniform draws for the two dropouts at x [B, T, d_sel]."""
        noise = {}
        if self.selection_dropout > 0.0:
            noise["sel"] = torch.rand(x.shape, generator=g, device=x.device)
        if self.expert_dropout > 0.0:
            b, t = x.shape[:2]
            noise["drop"] = torch.rand((b, t, self.n_heads, self.n_experts),
                                       generator=g, device=x.device)
        return noise

    def select(self, x: torch.Tensor, train: bool = False,
               noise: Optional[Dict[str, torch.Tensor]] = None):
        """x [B, T, d_sel] -> (idx [B, T, H, k], sigmoid weights
        [B, T, H, k] in the activation dtype, logits [B, T, H, E] f32)."""
        noise = noise or {}
        if train and self.selection_dropout > 0.0:
            if "sel" not in noise:
                raise ValueError("selection_dropout needs noise from "
                                 "draw_noise(generator)")
            keep = noise["sel"] < 1.0 - self.selection_dropout
            x = torch.where(keep, x / (1.0 - self.selection_dropout),
                            torch.zeros_like(x))
        logits = (x @ self.w_gate.t().to(x.dtype)).float()
        b, t, _ = logits.shape
        logits = logits.reshape(b, t, self.n_heads, self.n_experts)
        sel_logits = logits
        if train and self.expert_dropout > 0.0:
            if "drop" not in noise:
                raise ValueError("expert_dropout needs noise from "
                                 "draw_noise(generator)")
            sel_logits = logits.masked_fill(
                noise["drop"] < self.expert_dropout, float("-inf"))
        _, idx = R.top_k(sel_logits, self.topk)
        val = torch.sigmoid(torch.gather(logits, -1, idx)).to(self.dtype)
        return idx, val, logits

    def _mix(self, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        """Top-k weights scattered into a dense [B, T, H, E] mixture."""
        one_hot = F.one_hot(idx, self.n_experts).to(val.dtype)
        return torch.einsum("bthk,bthke->bthe", val, one_hot)

    def project(self, x, idx, val) -> torch.Tensor:
        """x [B, T, in] -> [B, T, H, out]: each head's output is the
        sigmoid-weighted sum of its selected experts' projections."""
        w = self.experts.to(x.dtype)
        y_all = torch.einsum("bti,heio->btheo", x.float(), w.float())
        mix = self._mix(idx, val).float()
        return torch.einsum("btheo,bthe->btho", y_all, mix).to(x.dtype)

    def project_out(self, res, idx, val) -> torch.Tensor:
        """res [B, T, H, in] -> [B, T, out]: summed over heads and top-k.
        The mixture weights scale res before the product (JAX scales the
        [B, T, H, E, out] products after it): the same sum, one product
        of [B*T, H*E*in] by [H*E*in, out], and a saved operand of in/out
        the size."""
        w = self.experts.to(res.dtype).float()
        mixed = torch.einsum("bthe,bthi->bthei",
                             self._mix(idx, val).float(), res.float())
        return torch.einsum("bthei,heio->bto", mixed, w).to(res.dtype)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class FullMoeRopeAttention(nn.Module):
    """MoA attention block: expert banks for q/k/v/o (plain dense
    projections `<name>_dense` where `att_<name>_expert` is off), partial
    RoPE, causal dense attention. Returns (output [B, T, D], MoEAux)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        h, p = cfg.n_heads, cfg.proj_dim
        self.v_proj = cfg.att_v_size or p
        self.std_in = math.sqrt(1.0 / cfg.d_model)
        self.std_out = math.sqrt(1.0 / (h * self.v_proj))
        self.is_expert = {"q": cfg.att_q_expert, "k": cfg.att_k_expert,
                          "v": cfg.att_v_expert, "o": cfg.att_o_expert}
        sizes = {"q": (cfg.d_model, p), "k": (cfg.d_model, p),
                 "v": (cfg.d_model, self.v_proj),
                 "o": (self.v_proj, cfg.d_model)}
        for name in NAMES:
            in_size, out_size = sizes[name]
            std = self.std_out if name == "o" else self.std_in
            if self.is_expert[name]:
                setattr(self, f"{name}_bank", AttentionExpertBank(
                    h, cfg.att_n_experts, cfg.d_model, in_size, out_size,
                    topk=cfg.att_k, std_gate=self.std_in, std_expert=std,
                    expert_dropout=cfg.att_expert_dropout,
                    selection_dropout=cfg.att_selection_dropout,
                    dtype=cfg.dtype, device=device))
            else:
                fan_in = h * in_size if name == "o" else in_size
                fan_out = cfg.d_model if name == "o" else h * out_size
                setattr(self, f"{name}_dense",
                        nn.Linear(fan_in, fan_out, bias=False,
                                  device=device))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        for name in NAMES:
            if self.is_expert[name]:
                getattr(self, f"{name}_bank").reset_parameters(g)
            else:
                lin = getattr(self, f"{name}_dense")
                std = self.std_out if name == "o" else self.std_in
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=g,
                                             device=lin.weight.device) * std)

    def draw_noise(self, x: torch.Tensor, attend_to: Optional[torch.Tensor],
                   g: torch.Generator) -> Dict[str, Dict]:
        """Each bank's dropout draws at its selection source's shape."""
        kv_src = attend_to if attend_to is not None else x
        return {name: getattr(self, f"{name}_bank").draw_noise(
            kv_src if name in ("k", "v") else x, g)
            for name in NAMES if self.is_expert[name]}

    def _project(self, name, src, sels, B, T):
        if self.is_expert[name]:
            idx, val, _ = sels[name]
            return getattr(self, f"{name}_bank").project(src, idx, val)
        out = _dense(src, getattr(self, f"{name}_dense"), self.cfg.dtype)
        return out.reshape(B, T, self.cfg.n_heads, -1)

    def forward(self, x: torch.Tensor, attend_to=None, pos_offset: int = 0,
                mask=None, train: bool = False, noise=None
                ) -> Tuple[torch.Tensor, MoEAux]:
        from ..parallel import seq_context
        from .lm import (apply_partial_rope, causal_mask, rope_sin_cos,
                         seq_gather_kv)

        cfg = self.cfg
        h, p = cfg.n_heads, cfg.proj_dim
        kv_src = attend_to if attend_to is not None else x
        B, T, _ = x.shape
        S = kv_src.shape[1]
        noise = noise or {}

        # k and v select from the source side, q and o from the queries
        sels = {}
        aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        losses = {}
        for name in NAMES:
            if not self.is_expert[name]:
                continue
            src = kv_src if name in ("k", "v") else x
            sels[name] = getattr(self, f"{name}_bank").select(
                src, train, noise.get(name))
            if train and cfg.moe_args.balance_loss_coef:
                bal = att_entropy_balance(sels[name][2]) * (
                    cfg.moe_args.balance_loss_coef / 10.0)
                aux_loss = aux_loss + bal
                losses[f"att_{name}_ebalance"] = bal.detach()

        sqrt_scale = torch.tensor(float(p), dtype=torch.float32) ** -0.25
        q = self._project("q", x, sels, B, T) * sqrt_scale.to(x.dtype)
        k = self._project("k", kv_src, sels, B, S)
        k = k * sqrt_scale.to(k.dtype)
        v = self._project("v", kv_src, sels, B, S)

        # under a seq mesh: this rank's query rows over the whole
        # sequence's keys (`lm.seq_gather_kv`), at global positions
        seq = seq_context.active()
        q0 = pos_offset
        if seq is not None:
            q0 = pos_offset + seq[1].index * T
            k, v = seq_gather_kv(k, v, T, seq[1])
            S = k.shape[1]
        n_rotate = int(cfg.rotate_fraction * p)
        n_rotate -= n_rotate % 2
        if n_rotate > 0:
            sin, cos = rope_sin_cos(n_rotate, T, cfg.rope_base,
                                    offset=q0, dtype=q.dtype,
                                    device=x.device)
            q = apply_partial_rope(q, sin[None, :, None], cos[None, :, None],
                                   n_rotate)
            sin0, cos0 = rope_sin_cos(n_rotate, S, cfg.rope_base,
                                      dtype=k.dtype, device=x.device)
            k = apply_partial_rope(k, sin0[None, :, None],
                                   cos0[None, :, None], n_rotate)

        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float())
        causal = causal_mask(T, S, q0 if seq is not None else S - T,
                             x.device)
        if mask is not None:
            causal = causal & mask
        scores = scores.masked_fill(~causal, float("-inf"))
        # probs in v's dtype times v, summed in float32 (a bf16 product
        # keeps only bf16 probs for its backward)
        probs = torch.softmax(scores, dim=-1).to(vh.dtype)
        res = torch.einsum("bhqk,bhkd->bhqd", probs, vh).to(x.dtype)
        res = res.transpose(1, 2)                   # [B, T, H, v_proj]

        if self.is_expert["o"]:
            idx, val, _ = sels["o"]
            out = self.o_bank.project_out(res, idx, val)
        else:
            out = _dense(res.reshape(B, T, h * self.v_proj), self.o_dense,
                         cfg.dtype)
        return out, MoEAux(aux_loss=aux_loss, losses=losses)
