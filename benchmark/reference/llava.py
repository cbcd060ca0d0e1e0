"""Plain float32 reference of a served CompeteSMoE-5.1B-style model: a
SigLIP tower with top-k MoE MLP blocks, a MoE projector, the image splice
and a Phi-3 decoder, over the benchmark's seeded weights
(`reference.weights`) with the roundings its configuration states
(`reference.quant`): int4 decoder projections, an int8 lm_head, NF4 tower
projections and an int8 KV cache.

Every product runs in float32 with TF32 off. The decoder runs a whole
sequence at once with a causal mask; the cache's rounding is applied to
every key and value, as a cache that held them would. Layers run one at a
time over all sequences, each layer's weights drawn again from the seed,
so the reference fits beside nothing else.

Definitions followed (HF SigLIP, LLaVA, Phi-3; CompeteSMoE at inference):
- tower: conv patches + learned positions; pre-LN blocks (LayerNorm eps
  1e-6), multi-head attention with biases, a MoE MLP (softmax over the
  gate's logits, top-k, weights renormalised; experts fc1 -> tanh-GELU ->
  fc2); the output is the state entering the last block (LLaVA's
  select_layer -2);
- projector: the same MoE with Linear -> exact GELU -> Linear experts;
- splice: the image token's place takes the image's patch rows;
- decoder: RMSNorm (eps from the config), fused qkv, RoPE (theta from the
  config, rotate-half), causal softmax attention, o_proj, SiLU-gated MLP,
  a final RMSNorm and the lm_head.
Norm weights are 1 and biases 0, as the weights are made.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import quant
from .weights import TOWER, PROJECTOR, DECODER, Geometry, draw

IMAGE_TOKEN = -200


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x):
    """x rounded per row onto float8 e4m3 with a scale of its largest
    magnitude over 448 (the control's activations)."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) / 448
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _moe(x, gate, experts, k: int, act, lin=lambda t: t):
    """Top-k softmax MoE over x [N, d]: gate [E, d]; experts [(w1, w2)]
    with w1 [h, d], w2 [out, h] (biases 0); `lin` rounds each expert
    product's input."""
    probs = torch.softmax(x @ gate.t(), dim=-1)
    top, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = top[:, :k] / top[:, :k].sum(dim=-1, keepdim=True)
    sel = sel[:, :k]
    out = torch.zeros(x.shape[0], experts[0][1].shape[0], device=x.device)
    for e, (w1, w2) in enumerate(experts):
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel():
            y = lin(act(lin(x[rows]) @ w1.t())) @ w2.t()
            out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def _attention(q, k, v, causal: bool):
    """q, k, v [N, h, p] -> [N, h * p], softmax(q k^T / sqrt(p)) v."""
    n, h, p = q.shape
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(p)
    if causal:
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                     device=q.device).triu(1), float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                        v).reshape(n, h * p)


def _rms(x, eps):
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _rope(x, pos, theta: float):
    """Rotate-half RoPE of x [N, h, p] at positions pos [N]."""
    p = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, p, 2, dtype=torch.float64,
                                        device=x.device) / p))
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cos(torch.cat([ang, ang], -1)).float()[:, None]
    sin = torch.sin(torch.cat([ang, ang], -1)).float()[:, None]
    x1, x2 = x[..., :p // 2], x[..., p // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


class Reference:
    """The reference model of geometry `g` over the weights of `seed`.
    `kv_bits` is the cache's width (8 as configured); `act` rounds every
    projection's input: 'f32' not at all, 'bf16' (a witness of the
    configured arithmetic) or 'fp8' (a control, a step below it)."""

    def __init__(self, hf_config: dict, seed: int, device, kv_bits: int = 8,
                 eps_vision: float = 1e-6, act: str = "f32"):
        _no_tf32()
        self.lin = {"f32": lambda t: t, "fp8": _fp8,
                    "bf16": lambda t: t.bfloat16().float()}[act]
        self.g = Geometry.from_hf(hf_config)
        self.seed = seed
        self.device = torch.device(device)
        self.kv_qmax = (1 << (kv_bits - 1)) - 1
        self.eps_vision = eps_vision

    def _draw(self, name):
        return {k: v.float() for k, v in
                draw(self.g, self.seed, name, self.device).items()}

    @torch.no_grad()
    def image_features(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, H, W, 3] -> projector rows [N, P, d], float32."""
        return self.projector(self.tower(pixels))

    @torch.no_grad()
    def tower(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, H, W, 3] -> the state entering the tower's last
        block [N, P, v_d], float32."""
        g = self.g
        emb = self._draw("tower.embeddings")
        conv = emb[TOWER + "embeddings.patch_embedding.weight"]
        x = F.conv2d(pixels.float().permute(0, 3, 1, 2), conv,
                     stride=g.patch).flatten(2).transpose(1, 2)
        x = x + emb[TOWER + "embeddings.position_embedding.weight"][None]
        n, P, d = x.shape
        x = x.reshape(n * P, d)
        for li in range(g.v_layers - 1):       # the state entering the last
            p = f"{TOWER}encoder.layers.{li}."
            att = self._draw(f"tower.{li}.attention")
            exp = self._draw(f"tower.{li}.experts")
            h = F.layer_norm(x, (d,), eps=self.eps_vision)
            h = self.lin(h)
            q, k, v = (h @ quant.nf4(att[p + f"self_attn.{m}.weight"]).t()
                       for m in ("q_proj", "k_proj", "v_proj"))
            hp = d // g.v_heads
            out = torch.cat([_attention(*(t[i * P:(i + 1) * P].reshape(
                P, g.v_heads, hp) for t in (q, k, v)), causal=False)
                for i in range(n)])
            x = x + self.lin(out) @ quant.nf4(
                att[p + "self_attn.out_proj.weight"]).t()
            h = F.layer_norm(x, (d,), eps=self.eps_vision)
            experts = [(exp[p + f"moelayer.experts.{e}.fc1.weight"],
                        exp[p + f"moelayer.experts.{e}.fc2.weight"])
                       for e in range(g.experts)]
            x = x + _moe(h, att[p + "moelayer.gate.weight"], experts,
                         g.top_k, lambda t: F.gelu(t, approximate="tanh"),
                         self.lin)
        return x.reshape(n, P, d)

    @torch.no_grad()
    def projector(self, feats: torch.Tensor) -> torch.Tensor:
        """Tower features [N, P, v_d] -> projector rows [N, P, d]."""
        g = self.g
        n, P, d = feats.shape
        x = feats.reshape(n * P, d)
        pj = self._draw("projector")
        experts = [(pj[PROJECTOR + f"moelayer.experts.{e}.0.weight"],
                    pj[PROJECTOR + f"moelayer.experts.{e}.2.weight"])
                   for e in range(g.experts)]
        y = _moe(x, pj[PROJECTOR + "moelayer.gate.weight"], experts,
                 g.top_k, F.gelu, self.lin)
        return y.reshape(n, P, g.d)

    @torch.no_grad()
    def served_logits(self, seqs: Sequence[dict]) -> List[torch.Tensor]:
        """For each {'ids': prompt ids with at most one IMAGE_TOKEN,
        'pixels': [1, H, W, 3] or None, 'tokens': served tokens, and
        optionally 'image_rows': [P, d] to splice in place of the image's
        own}, the logits [len(tokens), vocab] that predict each served
        token from the prompt and the tokens before it, float32."""
        g = self.g
        embed = draw(g, self.seed, "embed", self.device)[
            DECODER + "embed_tokens.weight"]
        with_img = [i for i, s in enumerate(seqs)
                    if IMAGE_TOKEN in np.asarray(s["ids"])
                    and s.get("image_rows") is None]
        feats = {i: s["image_rows"].float() for i, s in enumerate(seqs)
                 if s.get("image_rows") is not None}
        if with_img:
            px = torch.as_tensor(np.concatenate([
                np.asarray(seqs[i]["pixels"], np.float32).reshape(
                    -1, g.image, g.image, 3) for i in with_img]),
                device=self.device)
            feats.update(zip(with_img, self.image_features(px)))
        xs, reads = [], []
        for i, s in enumerate(seqs):
            ids = np.asarray(s["ids"], np.int64)
            toks = np.asarray(s["tokens"], np.int64)
            text = np.concatenate([ids, toks[:-1]])
            safe = torch.as_tensor(np.where(text == IMAGE_TOKEN, 0, text),
                                   device=self.device)
            x = embed[safe].float()
            prompt = len(ids)
            if i in feats:
                j = int(np.nonzero(text == IMAGE_TOKEN)[0][0])
                x = torch.cat([x[:j], feats[i], x[j + 1:]])
                prompt += feats[i].shape[0] - 1
            xs.append(x)
            reads.append(torch.arange(prompt - 1, prompt - 1 + len(toks),
                                      device=self.device))
        del embed
        hd, kvd = g.head_dim, g.kv_heads * g.head_dim
        for li in range(g.layers):
            p = f"{DECODER}layers.{li}."
            w = draw(g, self.seed, f"decoder.{li}", self.device)
            qkv = quant.per_channel(w[p + "self_attn.qkv_proj.weight"], 7)
            o = quant.per_channel(w[p + "self_attn.o_proj.weight"], 7)
            gu = quant.per_channel(w[p + "mlp.gate_up_proj.weight"], 7)
            down = quant.per_channel(w[p + "mlp.down_proj.weight"], 7)
            del w
            for i, x in enumerate(xs):
                n = x.shape[0]
                pos = torch.arange(n, device=self.device)
                y = self.lin(_rms(x, g.eps)) @ qkv.t()
                q = y[:, :g.d].reshape(n, g.heads, hd)
                k = y[:, g.d:g.d + kvd].reshape(n, g.kv_heads, hd)
                v = y[:, g.d + kvd:].reshape(n, g.kv_heads, hd)
                q, k = _rope(q, pos, g.rope_theta), _rope(k, pos, g.rope_theta)
                k, v = (quant.kv_round(t, self.kv_qmax) for t in (k, v))
                rep = g.heads // g.kv_heads
                k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
                x = x + self.lin(_attention(q, k, v, causal=True)) @ o.t()
                gate, up = (self.lin(_rms(x, g.eps)) @ gu.t()).chunk(2, -1)
                xs[i] = x + self.lin(F.silu(gate) * up) @ down.t()
            del qkv, o, gu, down
        head = quant.per_channel(draw(g, self.seed, "lm_head", self.device)[
            "lm_head.weight"], 127)
        return [self.lin(_rms(x[r], g.eps)) @ head.t()
                for x, r in zip(xs, reads)]


def token_gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """At each position, (best logit - the token's logit) / the row's
    largest |logit|: how far below the reference's best a served token
    lies, as a share of the row's scale."""
    t = torch.as_tensor(list(tokens), device=logits.device)
    best = logits.max(dim=-1).values
    got = logits.gather(1, t[:, None])[:, 0]
    return (best - got) / logits.abs().max(dim=-1).values


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / |want| of each row (the last axis a row)."""
    got, want = got.float(), want.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1)
