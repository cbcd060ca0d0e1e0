"""Seeded random weights of a LLaVA-style checkpoint in its released
layout (the names the CompeteSMoE-5.1B checkpoint uses), made on the
device.

The benchmark makes these tensors and hands the same ones to the program
(through its checkpoint converter) and to the plain reference. Weights
come in chunks: each chunk holds the random matrices of one part (a
decoder layer, a tower layer's attention, a tower layer's experts, ...),
drawn by one `torch.randn` call from a generator seeded by (seed, chunk
index), so any chunk can be drawn again alone and comes out the same.
Norm weights are 1 and biases 0, made apart from the chunks: the
quantized program drops its bf16 matrices, and a chunk that a norm kept
alive would hold them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch

STD = 0.02
DECODER = "model."
TOWER = "model.vision_tower.vision_tower."
PROJECTOR = "model.mm_projector."


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The sizes a weight layout needs, read from an HF-style config."""

    vocab: int
    d: int
    ffn: int
    layers: int
    heads: int
    kv_heads: int
    eps: float
    rope_theta: float
    v_d: int
    v_ffn: int
    v_layers: int
    v_heads: int
    image: int
    patch: int
    experts: int
    top_k: int
    v_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d // self.heads

    @property
    def patches(self) -> int:
        return (self.image // self.patch) ** 2

    @classmethod
    def from_hf(cls, hf: dict) -> "Geometry":
        v = hf["vision_config"]
        return cls(vocab=hf["vocab_size"], d=hf["hidden_size"],
                   ffn=hf["intermediate_size"],
                   layers=hf["num_hidden_layers"],
                   heads=hf["num_attention_heads"],
                   kv_heads=hf.get("num_key_value_heads",
                                   hf["num_attention_heads"]),
                   eps=hf.get("rms_norm_eps", 1e-5),
                   rope_theta=hf.get("rope_theta", 10000.0),
                   v_d=v["hidden_size"], v_ffn=v["intermediate_size"],
                   v_layers=v["num_hidden_layers"],
                   v_heads=v["num_attention_heads"],
                   image=v["image_size"], patch=v["patch_size"],
                   experts=hf["num_experts"], top_k=hf["num_selected"])


def chunks(g: Geometry) -> List[Tuple[str, List[Tuple[str, tuple]]]]:
    """[(chunk name, [(tensor name, shape), ...])] of every random matrix,
    in a fixed order; a chunk's index seeds its generator."""
    kvd = g.kv_heads * g.head_dim
    out = [("embed", [(DECODER + "embed_tokens.weight", (g.vocab, g.d))]),
           ("lm_head", [("lm_head.weight", (g.vocab, g.d))])]
    for li in range(g.layers):
        p = f"{DECODER}layers.{li}."
        out.append((f"decoder.{li}", [
            (p + "self_attn.qkv_proj.weight", (g.d + 2 * kvd, g.d)),
            (p + "self_attn.o_proj.weight", (g.d, g.d)),
            (p + "mlp.gate_up_proj.weight", (2 * g.ffn, g.d)),
            (p + "mlp.down_proj.weight", (g.d, g.ffn))]))
    out.append(("tower.embeddings", [
        (TOWER + "embeddings.patch_embedding.weight",
         (g.v_d, 3, g.patch, g.patch)),
        (TOWER + "embeddings.position_embedding.weight",
         (g.patches, g.v_d))]))
    for li in range(g.v_layers):
        p = f"{TOWER}encoder.layers.{li}."
        out.append((f"tower.{li}.attention", [
            (p + f"self_attn.{n}.weight", (g.v_d, g.v_d))
            for n in ("q_proj", "k_proj", "v_proj", "out_proj")]
            + [(p + "moelayer.gate.weight", (g.experts, g.v_d))]))
        experts = []
        for e in range(g.experts):
            experts += [(p + f"moelayer.experts.{e}.fc1.weight",
                         (g.v_ffn, g.v_d)),
                        (p + f"moelayer.experts.{e}.fc2.weight",
                         (g.v_d, g.v_ffn))]
        out.append((f"tower.{li}.experts", experts))
    proj = [(PROJECTOR + "moelayer.gate.weight", (g.experts, g.v_d))]
    for e in range(g.experts):
        proj += [(PROJECTOR + f"moelayer.experts.{e}.0.weight", (g.d, g.v_d)),
                 (PROJECTOR + f"moelayer.experts.{e}.2.weight", (g.d, g.d))]
    out.append(("projector", proj))
    return out


def constants(g: Geometry) -> List[Tuple[str, tuple, float]]:
    """[(tensor name, shape, value)]: norm weights (1) and biases (0)."""
    out = [(DECODER + "norm.weight", (g.d,), 1.0)]
    for li in range(g.layers):
        p = f"{DECODER}layers.{li}."
        out += [(p + "input_layernorm.weight", (g.d,), 1.0),
                (p + "post_attention_layernorm.weight", (g.d,), 1.0)]
    out.append((TOWER + "embeddings.patch_embedding.bias", (g.v_d,), 0.0))
    for li in range(g.v_layers):
        p = f"{TOWER}encoder.layers.{li}."
        for n in ("layer_norm1", "layer_norm2"):
            out += [(p + f"{n}.weight", (g.v_d,), 1.0),
                    (p + f"{n}.bias", (g.v_d,), 0.0)]
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out.append((p + f"self_attn.{n}.bias", (g.v_d,), 0.0))
        for e in range(g.experts):
            out += [(p + f"moelayer.experts.{e}.fc1.bias", (g.v_ffn,), 0.0),
                    (p + f"moelayer.experts.{e}.fc2.bias", (g.v_d,), 0.0)]
    for e in range(g.experts):
        out += [(PROJECTOR + f"moelayer.experts.{e}.0.bias", (g.d,), 0.0),
                (PROJECTOR + f"moelayer.experts.{e}.2.bias", (g.d,), 0.0)]
    return out


def chunk_seed(seed: int, index: int) -> int:
    """The generator seed of chunk `index` under run seed `seed` (any
    whole number; the result fits the generator's 64 bits)."""
    return (int(seed) * 1_000_003 + index * 7_919 + 1) % (2 ** 63)


def draw_chunk(g: Geometry, seed: int, index: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} of chunk `index`: N(0, STD) drawn in float32 by one
    call, rounded to `dtype`; each tensor a view of the chunk."""
    _, specs = chunks(g)[index]
    n = sum(_numel(s) for _, s in specs)
    gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, index))
    flat = (torch.randn(n, generator=gen, device=device,
                        dtype=torch.float32) * STD).to(dtype)
    out, at = {}, 0
    for name, shape in specs:
        k = _numel(shape)
        out[name] = flat[at:at + k].view(shape)
        at += k
    return out


def chunk_index(g: Geometry, name: str) -> int:
    return [c for c, _ in chunks(g)].index(name)


def draw(g: Geometry, seed: int, name: str, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Chunk `name` (see `chunks`) drawn alone."""
    return draw_chunk(g, seed, chunk_index(g, name), device, dtype)


def iter_checkpoint(g: Geometry, seed: int, device,
                    dtype=torch.bfloat16) -> Iterator[Tuple[str,
                                                            torch.Tensor]]:
    """Every tensor of the checkpoint, chunk by chunk, then the
    constants."""
    for i in range(len(chunks(g))):
        yield from draw_chunk(g, seed, i, device, dtype).items()
    for name, shape, value in constants(g):
        yield name, torch.full(shape, value, device=device, dtype=dtype)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
