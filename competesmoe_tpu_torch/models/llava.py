"""LLaVA-style multimodal model and generation in PyTorch (port of
competesmoe_tpu/models/llava.py).

Vision tower -> projector -> decoder with the static-shape image-token
splice, and eager KV-cache generation: `stream_generate` yields token
chunks on the 1, 1, 2, 4, ..., chunk_max schedule with the prompt padded
to a power-of-two bucket, as the JAX version does. `speculative=K`
verifies K prompt-lookup drafts per forward (`speculative_accept`): greedy
tokens equal sequential greedy decoding, sampled ones follow the
step-by-step distribution. Random draws come from explicit
`torch.Generator`s. Training losses come with a later slice.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..device import resolve_device
from ..utils.cuda_graph import capture, copy_from_host
from .decoder import DecoderConfig, DecoderLM, KVCache
from .projector import ProjectorConfig, VisionProjector
from .vision import SiglipSMoEVisionTower, VisionConfig


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    vision: VisionConfig = VisionConfig()
    projector: ProjectorConfig = ProjectorConfig()
    decoder: DecoderConfig = DecoderConfig()
    image_token_index: int = IMAGE_TOKEN_INDEX
    tokenizer_model_max_length: Optional[int] = 2048

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches


def splice_image_tokens(input_ids: torch.Tensor, text_embeds: torch.Tensor,
                        image_features: torch.Tensor,
                        labels: Optional[torch.Tensor] = None,
                        attention_mask: Optional[torch.Tensor] = None,
                        image_token_index: int = IMAGE_TOKEN_INDEX
                        ) -> Dict[str, torch.Tensor]:
    """Static-shape multi-image splice.

    input_ids: [B, L] with up to M `image_token_index` per row;
    text_embeds: [B, L, D]; image_features: [B, P, D] or [B, M, P, D] —
    the m-th image token of a row is replaced by image m's P rows.
    Returns embeds [B, L - M + M*P, D], labels, attention_mask and
    position_ids; rows with fewer images are right-padded."""
    B, L = input_ids.shape
    dev = input_ids.device
    if image_features.dim() == 3:
        image_features = image_features[:, None]
    M, P = image_features.shape[1], image_features.shape[2]
    D = text_embeds.shape[-1]
    Lout = L - M + M * P

    is_img = input_ids == image_token_index
    n_img = is_img.sum(dim=1)
    attention_mask = (torch.ones((B, L), dtype=torch.bool, device=dev)
                      if attention_mask is None else attention_mask.bool())
    if labels is None:
        labels = torch.full((B, L), IGNORE_INDEX, dtype=torch.long,
                            device=dev)

    # positions of each row's image tokens in order; missing -> L
    j_in = torch.arange(L, device=dev)[None, :]
    keys = torch.where(is_img, j_in, L + j_in)
    order = torch.sort(keys, dim=1).values[:, :M]
    p = torch.where(order < L, order, L)
    m_idx = torch.arange(M, device=dev)[None, :]
    starts = torch.where(p < L, p + m_idx * (P - 1), Lout + P)   # [B, M]

    j = torch.arange(Lout, device=dev)[None, :]
    jm = j[:, :, None]
    sb = starts[:, None, :]
    in_block = (jm >= sb) & (jm < sb + P)                          # [B,Lout,M]
    in_image = in_block.any(dim=-1)
    m_sel = torch.argmax(in_block.int(), dim=-1)
    n_full_before = (jm >= sb + P).sum(dim=-1)
    text_idx = torch.clamp(j - n_full_before * (P - 1), 0, L - 1)  # [B,Lout]

    emb_text = torch.gather(text_embeds, 1,
                            text_idx[..., None].expand(B, Lout, D))
    img_off = torch.clamp(j - torch.gather(starts, 1, m_sel), 0, P - 1)
    flat_idx = m_sel * P + img_off
    feats = image_features.reshape(B, M * P, -1)
    emb_img = torch.gather(feats, 1, flat_idx[..., None].expand(B, Lout, D))
    embeds = torch.where(in_image[..., None], emb_img.to(emb_text.dtype),
                         emb_text)

    new_labels = torch.where(in_image, IGNORE_INDEX,
                             torch.gather(labels, 1, text_idx))
    new_mask = torch.where(in_image, True,
                           torch.gather(attention_mask, 1, text_idx))
    real_len = (L - n_img + n_img * P)[:, None]
    tail = j >= real_len
    new_mask = torch.where(tail, False, new_mask)
    new_labels = torch.where(tail, IGNORE_INDEX, new_labels)
    embeds = torch.where(tail[..., None], torch.zeros_like(embeds), embeds)
    position_ids = torch.clamp(torch.cumsum(new_mask.long(), dim=1) - 1,
                               min=0)
    return {"embeds": embeds, "labels": new_labels,
            "attention_mask": new_mask, "position_ids": position_ids}


@dataclasses.dataclass
class LlavaOutput:
    logits: torch.Tensor
    loss: Optional[torch.Tensor]
    aux_mlp: torch.Tensor
    aux_clip: torch.Tensor
    labels: Optional[torch.Tensor] = None
    vision_auxes: Any = None
    projector_aux: Any = None
    cache: Optional[KVCache] = None
    aux_llm: Any = 0.0


class LlavaModel(nn.Module):
    """Vision tower -> projector -> decoder with image splice. Built on
    `cuda` unless `device` says otherwise; weights start uninitialised
    (see models.builder.init_random_ and convert.from_jax_params)."""

    def __init__(self, cfg: LlavaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vision_tower = SiglipSMoEVisionTower(cfg.vision, device)
        self.mm_projector = VisionProjector(cfg.projector, device)
        self.language_model = DecoderLM(cfg.decoder, device)

    @property
    def device(self) -> torch.device:
        return self.language_model.embed_tokens.weight.device

    def encode_images(self, pixel_values, *, step=None, train=False,
                      return_id_experts=False):
        """pixel_values [B, H, W, C] (one image per row) -> features
        [B, P, D] ready for splice_image_tokens. Multi-tile batches
        [B, M, H, W, C] wait for the anyres image mode."""
        if pixel_values.dim() != 4:
            raise NotImplementedError("multi-tile pixel batches are not "
                                      "ported yet (anyres image mode)")
        feats, aux_clip, v_auxes = self.vision_tower(
            pixel_values, step=step, train=train,
            return_id_experts=return_id_experts)
        dtype = self.language_model.cfg.dtype
        proj, p_aux = self.mm_projector(feats.to(dtype), step=step,
                                        train=train,
                                        return_id_experts=return_id_experts)
        return proj.to(dtype), aux_clip, v_auxes, p_aux

    def forward(self, input_ids, pixel_values=None, labels=None,
                attention_mask=None, *, step=None, train=False,
                return_id_experts=False, cache=None,
                pos_in_place: bool = False) -> LlavaOutput:
        """`pos_in_place`: with a cache, advance its pos in place (see
        DecoderLM.forward)."""
        if labels is not None:
            raise NotImplementedError("the training loss is not ported "
                                      "yet (ROADMAP: multimodal training)")
        lm = self.language_model
        zero = torch.zeros((), dtype=torch.float32, device=input_ids.device)
        if pixel_values is None:
            logits, new_cache, _ = lm(torch.clamp(input_ids, min=0),
                                      attention_mask=attention_mask,
                                      cache=cache, pos_in_place=pos_in_place)
            return LlavaOutput(logits=logits, loss=None, aux_mlp=zero,
                               aux_clip=zero, cache=new_cache)

        img_feats, aux_clip, v_auxes, p_aux = self.encode_images(
            pixel_values, step=step, train=train,
            return_id_experts=return_id_experts)
        text_embeds = lm.embed(torch.clamp(input_ids, min=0))
        text_embeds = torch.where(
            (input_ids == self.cfg.image_token_index)[..., None],
            torch.zeros_like(text_embeds), text_embeds)
        sp = splice_image_tokens(input_ids, text_embeds, img_feats, None,
                                 attention_mask, self.cfg.image_token_index)
        maxlen = self.cfg.tokenizer_model_max_length
        embeds, sp_labels = sp["embeds"], sp["labels"]
        sp_mask, sp_pos = sp["attention_mask"], sp["position_ids"]
        if maxlen is not None and embeds.shape[1] > maxlen:
            embeds, sp_labels = embeds[:, :maxlen], sp_labels[:, :maxlen]
            sp_mask, sp_pos = sp_mask[:, :maxlen], sp_pos[:, :maxlen]
        logits, new_cache, _ = lm(
            inputs_embeds=embeds, attention_mask=sp_mask,
            position_ids=sp_pos if cache is None else None, cache=cache,
            pos_in_place=pos_in_place)
        return LlavaOutput(
            logits=logits, loss=None, aux_mlp=p_aux.aux_loss,
            aux_clip=aux_clip, labels=sp_labels, aux_llm=zero,
            vision_auxes=v_auxes if return_id_experts else None,
            projector_aux=p_aux if return_id_experts else None,
            cache=new_cache)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def _pad_prompt_bucket(input_ids, attention_mask, enabled: bool,
                       lo: int = 32):
    """Right-pad prompts to a power-of-two length bucket (mask 0: pads
    land in the cache dump slot, token-exact)."""
    ids = np.asarray(input_ids)
    B, L = ids.shape
    mask = (np.ones_like(ids) if attention_mask is None
            else np.asarray(attention_mask))
    if not enabled:
        return ids, mask, L
    Lb = lo
    while Lb < L:
        Lb *= 2
    if Lb == L:
        return ids, mask, L
    pad = Lb - L
    ids = np.concatenate([ids, np.zeros((B, pad), ids.dtype)], axis=1)
    mask = np.concatenate([mask, np.zeros((B, pad), mask.dtype)], axis=1)
    return ids, mask, Lb


def _nucleus(scaled: torch.Tensor, top_p) -> torch.Tensor:
    """Mask to -inf the logits outside the top-p nucleus over the last
    axis; `top_p` is a float or a tensor broadcasting against
    scaled[..., :1] (one value per row)."""
    srt = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    ci = torch.clamp((cum < top_p).sum(dim=-1, keepdim=True),
                     max=scaled.shape[-1] - 1)
    cutoff = torch.gather(srt, -1, ci)
    return torch.where(scaled < cutoff, float("-inf"), scaled)


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """One draw per row from softmax(logits) over the last axis
    (Gumbel-max, as jax.random.categorical; -inf logits are never drawn
    unless a whole row is -inf). No host synchronisation."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor,
                topps: torch.Tensor, generator: Optional[torch.Generator],
                nucleus: bool) -> torch.Tensor:
    """Per-row sampling on the device: greedy where temps <= 0, else a
    draw at the row's temperature, restricted to its top-p nucleus when
    `nucleus` (the engine's step and insert)."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    if nucleus:
        scaled = _nucleus(scaled, topps[:, None])
    drawn = _categorical(scaled, generator)
    return torch.where(temps > 0, drawn, greedy)


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_p: float = 1.0
                 ) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature / nucleus sampling."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p < 1.0:
        logits = _nucleus(logits, top_p)
    return _categorical(logits, generator)


@torch.no_grad()
def _prefill(model: LlavaModel, input_ids, pixel_values, attention_mask,
             max_len: int, cache: Optional[KVCache] = None):
    """Prefill into `cache` (a fresh one of `max_len` slots when None;
    its pos advances in place)."""
    dev = model.device
    B = input_ids.shape[0]
    if cache is None:
        cache = KVCache.create(model.language_model.cfg, B, max_len, dev)
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=dev)
    mask = torch.as_tensor(attention_mask, device=dev)
    px = (torch.as_tensor(pixel_values, dtype=torch.float32, device=dev)
          if pixel_values is not None else None)
    out = model(ids, px, attention_mask=mask, cache=cache,
                return_id_experts=px is not None, pos_in_place=True)
    last = out.logits[torch.arange(B, device=dev), out.cache.pos - 1]
    return last, out


def _host(tokens: torch.Tensor) -> np.ndarray:
    """Token ids as a fresh int32 host array (callers write into it)."""
    return tokens.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# The solo path's captured decode programs
# ---------------------------------------------------------------------------

class _SoloCaches:
    """The solo path's KV caches on the card and the decode programs
    captured over them (one set per model). A request takes a cache of its
    (batch, max_len) bucket for its whole generation and gives it back at
    the end. The cache stays allocated across requests because its
    addresses are baked into its programs, so a second request of the
    bucket replays them without a capture; a bucket holds more than one
    cache only while its requests overlap (the worker's
    --limit-model-concurrency). Each cache's programs share one graph
    pool: they never run at the same time."""

    def __init__(self):
        self.lock = threading.Lock()
        self.free: Dict[Tuple[int, int], List[KVCache]] = {}
        self.owned: Dict[int, KVCache] = {}
        self.programs: Dict[tuple, Any] = {}
        self.pools: Dict[int, Any] = {}

    def take(self, model: LlavaModel, batch: int, max_len: int) -> KVCache:
        with self.lock:
            free = self.free.setdefault((batch, max_len), [])
            if free:
                cache = free.pop()
            else:
                cache = KVCache.create(model.language_model.cfg, batch,
                                       max_len, model.device)
                self.owned[id(cache)] = cache
                self.pools[id(cache)] = torch.cuda.graph_pool_handle()
        cache.pos.zero_()
        return cache

    def give_back(self, cache: KVCache) -> None:
        with self.lock:
            self.free[(cache.k.shape[1], cache.max_len)].append(cache)

    def program(self, cache: KVCache, key: tuple, build):
        """The program `key` over `cache`, captured by `build(pool)` at its
        first use."""
        if self.owned.get(id(cache)) is not cache:
            raise ValueError("a captured decode runs over a cache of the "
                             "solo path's own (stream_generate, generate)")
        full = (id(cache),) + key
        got = self.programs.get(full)
        if got is None:
            got = self.programs[full] = build(self.pools[id(cache)])
        return got


_SOLO_LOCK = threading.Lock()


def _solo_caches(model: LlavaModel) -> _SoloCaches:
    with _SOLO_LOCK:
        solo = getattr(model, "_solo_caches", None)
        if solo is None:
            solo = model._solo_caches = _SoloCaches()
    return solo


def _captured(model: LlavaModel, cuda_graphs: bool) -> bool:
    return cuda_graphs and model.device.type == "cuda"


def _drawing_from(program, own: torch.Generator, device: torch.device,
                  generator: Optional[torch.Generator]):
    """Replay `program`, whose draws come from its own generator `own`, as
    if it drew from `generator` (the device's default one when None, as
    torch.rand without one): `own` takes the caller's seed and offset
    before the replay and hands the advanced offset back after it, so
    the draws and the caller's generator follow the eager steps. Both are
    host-side values: nothing synchronises."""
    if generator is None:
        generator = torch.cuda.default_generators[device.index or 0]
    own.set_state(generator.get_state())
    out = program()
    generator.set_state(own.get_state())
    return out


def make_scan_decode(model: LlavaModel, n_tokens: int,
                     temperature: float = 0.0, top_p: float = 1.0,
                     cuda_graphs: bool = True):
    """fn(first_token [B], cache, generator) -> (tokens [B, n_tokens],
    cache): n_tokens decode steps with sampling on the device; cache.pos
    advances in place. On the card (unless cuda_graphs=False) the steps
    replay a program captured over `cache`, which must be one of the solo
    path's own (`stream_generate`, `generate`), one program per (cache,
    n_tokens, temperature, top_p) whatever generator the caller draws
    from, as JAX jits one scan per (model, n_tokens, temperature, top_p);
    elsewhere they run eagerly in a plain loop."""

    def steps(token, cache, generator):
        toks = []
        for _ in range(n_tokens):
            out = model(token[:, None], None, cache=cache, pos_in_place=True)
            token = sample_token(out.logits[:, 0], generator, temperature,
                                 top_p)
            toks.append(token)
        return torch.stack(toks, dim=1)

    @torch.no_grad()
    def decode(first_token, cache, generator=None):
        if not _captured(model, cuda_graphs):
            return steps(first_token, cache, generator), cache
        dev = first_token.device

        def build(pool):
            cur = torch.zeros_like(first_token)
            own = torch.Generator(device=dev)
            return cur, own, capture(lambda: steps(cur, cache, own),
                                     state=(cur, cache.pos),
                                     generators=(own,), pool=pool)

        cur, own, program = _solo_caches(model).program(
            cache, ("scan", n_tokens, temperature, top_p), build)
        cur.copy_(first_token)
        toks = _drawing_from(program, own, dev, generator)
        return toks.clone(), cache
    return decode


def speculative_accept(logits: torch.Tensor, drafts: torch.Tensor,
                       temps: torch.Tensor, topps: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       nucleus: bool):
    """Speculative accept / resample over a batch of rows.

    logits [S, 1+k, V] from one forward over [cur, k drafts]; returns
    (toks [S, 1+k], n_acc [S]) where toks[s, :n_acc[s]+1] are the emitted
    tokens. Rows with temps <= 0 verify greedily (the longest draft prefix
    equal to the argmax: the same tokens as sequential greedy decoding);
    rows with temps > 0 run speculative sampling with the point-mass
    drafter (accept d_j with probability p_j(d_j); on the first rejection
    draw from p_j with d_j removed; a bonus draw from p_k when all k
    accept), so the emitted tokens follow step-by-step sampling, the
    nucleus filter applied per position when `nucleus`."""
    S, k = drafts.shape
    drafts = drafts.long()
    greedy = torch.argmax(logits, dim=-1)
    match = (drafts == greedy[:, :-1]).long()
    n_acc_g = torch.cumprod(match, dim=-1).sum(dim=-1)

    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None, None]
    if nucleus:
        scaled = _nucleus(scaled, topps[:, None, None])
    p = torch.softmax(scaled, dim=-1)
    p_d = torch.gather(p[:, :-1], -1, drafts[..., None])[..., 0]
    u = torch.rand((S, k), generator=generator, device=logits.device)
    n_acc_s = torch.cumprod((u < p_d).long(), dim=-1).sum(dim=-1)
    masked = scaled[:, :-1].scatter(-1, drafts[..., None], float("-inf"))
    resid = _categorical(masked, generator)
    bonus = _categorical(scaled[:, -1], generator)
    idx = torch.arange(k + 1, device=logits.device)[None]
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    repl = torch.cat([resid, bonus[:, None]], dim=1)
    out_s = torch.where(idx < n_acc_s[:, None], drafts_pad, repl)

    is_sampled = temps > 0
    n_acc = torch.where(is_sampled, n_acc_s, n_acc_g)
    toks = torch.where(is_sampled[:, None], out_s, greedy)
    return toks, n_acc


@torch.no_grad()
def verify_step(model: LlavaModel, tokens: torch.Tensor, cache: KVCache,
                temps: torch.Tensor, topps: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                nucleus: bool = False):
    """Speculative verification, greedy and sampled (JAX's
    make_verify_step and make_sampled_verify_step in one):
    (toks [B, 1+k], n_acc [B]). `tokens` is each row's current token
    followed by k drafts; one forward writes all 1+k positions' K/V,
    `speculative_accept` decides per row by its temperature, and cache.pos
    advances in place by 1 + n_acc only: the rejected tail sits beyond
    pos, is never attended, and is overwritten by the next step."""
    out = model(tokens, None, cache=cache, pos_in_place=True)
    toks, n_acc = speculative_accept(out.logits, tokens[:, 1:], temps, topps,
                                     generator, nucleus=nucleus)
    cache.pos.sub_(tokens.shape[1] - 1 - n_acc)
    return toks, n_acc


def _make_verify(model: LlavaModel, cache: KVCache, spec: int,
                 temperature: float, top_p: float,
                 generator: Optional[torch.Generator], cuda_graphs: bool):
    """fn(tokens np [1, 1+spec]) -> (toks np [1+spec], n_acc): the solo
    path's verify step over `cache`. On the card it replays a program
    captured per (cache, spec, nucleus), temperature and top_p riding in
    device buffers as JAX's sampled verify takes them at run time, and its
    draws following `generator` (`_drawing_from`)."""
    dev = model.device
    nucleus = temperature > 0.0 and top_p < 1.0
    if not _captured(model, cuda_graphs):
        temps = torch.full((1,), temperature, device=dev)
        topps = torch.full((1,), top_p, device=dev)

        def eager(tokens):
            got, n_acc = verify_step(
                model, torch.as_tensor(tokens, dtype=torch.long, device=dev),
                cache, temps, topps, generator, nucleus=nucleus)
            return _host(got)[0], int(n_acc[0])
        return eager
    def build(pool):
        toks = torch.zeros((1, 1 + spec), dtype=torch.long, device=dev)
        temps = torch.zeros((1,), device=dev)
        topps = torch.ones((1,), device=dev)
        own = torch.Generator(device=dev)
        return toks, temps, topps, own, capture(
            lambda: verify_step(model, toks, cache, temps, topps, own,
                                nucleus=nucleus),
            state=(cache.pos,), generators=(own,), pool=pool)

    toks, temps, topps, own, program = _solo_caches(model).program(
        cache, ("verify", spec, nucleus), build)

    def replay(tokens):
        copy_from_host(toks, tokens)
        temps.fill_(temperature)
        topps.fill_(top_p)
        got, n_acc = _drawing_from(program, own, dev, generator)
        return _host(got)[0], int(n_acc[0])
    return replay


def _spec_chunks(model: LlavaModel, input_ids: np.ndarray,
                 cur: torch.Tensor, cache: KVCache, max_new: int, spec: int,
                 temperature: float = 0.0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 cuda_graphs: bool = True):
    """Speculative decode loop (B == 1): yields np [1, n] chunks of new
    tokens after the first. Prompt-lookup drafts come from
    serve/speculative.py; an iteration with no recurring n-gram takes a
    plain decode step."""
    from ..serve.speculative import ngram_draft

    dev = model.device
    verify = _make_verify(model, cache, spec, temperature, top_p, generator,
                          cuda_graphs)
    step = make_scan_decode(model, 1, temperature, top_p, cuda_graphs)
    hist = [int(t) for t in input_ids[0].tolist() if int(t) >= 0]
    cur_i = int(cur[0])
    hist.append(cur_i)
    produced = 1
    while produced < max_new:
        draft = ngram_draft(hist, spec)
        if draft is None:
            toks, cache = step(torch.tensor([cur_i], device=dev), cache,
                               generator)
            emit = _host(toks)[0]
        else:
            got, n_acc = verify(np.concatenate([[cur_i], draft])[None])
            emit = got[: n_acc + 1]
        emit = emit[: max_new - produced]
        produced += len(emit)
        cur_i = int(emit[-1])
        hist.extend(int(t) for t in emit)
        yield emit[None].astype(np.int32).copy()


def _bucketed(model, input_ids, pixel_values, attention_mask,
              max_new_tokens, spec, pad_to_bucket):
    """(ids, mask, cache length) of a request: the prompt padded to its
    bucket, and room for the image tokens, the new tokens and the drafts
    (rounded up to 128 with the bucket)."""
    input_ids, attention_mask, L = _pad_prompt_bucket(
        input_ids, attention_mask, pad_to_bucket)
    P = model.cfg.num_image_tokens if pixel_values is not None else 0
    prompt_len = L - 1 + P if pixel_values is not None else L
    max_len = prompt_len + max_new_tokens + spec
    if pad_to_bucket:
        max_len = -(-max_len // 128) * 128
    return input_ids, attention_mask, max_len


def stream_generate(model: LlavaModel, input_ids: np.ndarray,
                    pixel_values: Optional[np.ndarray],
                    attention_mask: Optional[np.ndarray] = None,
                    max_new_tokens: int = 64, temperature: float = 0.0,
                    top_p: float = 1.0, eos_token_id: Optional[int] = None,
                    stop_token_ids: Optional[List[int]] = None,
                    generator: Optional[torch.Generator] = None,
                    chunk_max: int = 8, speculative: int = 0,
                    pad_to_bucket: bool = True, cuda_graphs: bool = True):
    """Incremental generation: yields np.ndarray token chunks [B, n] as
    they are produced (first chunk right after prefill). Chunk sizes
    follow 1, 1, 2, 4, ..., chunk_max. Rows stop after a stop/eos token;
    later positions of a finished row repeat its stop id, and the
    generator returns once every row has stopped.

    speculative=K > 0 (B == 1 only; ignored otherwise) verifies K
    prompt-lookup drafts per forward and yields 1..K+1 tokens per chunk
    after the first.

    On the card the decode and verify steps replay captured CUDA graphs
    (`make_scan_decode`) over a cache the model keeps for the request's
    bucket; cuda_graphs=False runs them eagerly, the same function."""
    B = input_ids.shape[0]
    spec = int(speculative) if (speculative and B == 1) else 0
    orig_ids = np.asarray(input_ids)      # unpadded: the drafts' history
    ids, mask, max_len = _bucketed(model, input_ids, pixel_values,
                                   attention_mask, max_new_tokens, spec,
                                   pad_to_bucket)
    solo = _solo_caches(model) if _captured(model, cuda_graphs) else None
    cache = solo.take(model, B, max_len) if solo else None
    try:
        last_logits, out = _prefill(model, ids, pixel_values, mask, max_len,
                                    cache)
        cache = out.cache
        stops = set(stop_token_ids or [])
        if eos_token_id is not None:
            stops.add(int(eos_token_id))
        stop_arr = np.asarray(sorted(stops)) if stops else None

        def cut(chunk: np.ndarray, finished: np.ndarray):
            if stop_arr is None:
                return chunk, finished, False
            for b in range(chunk.shape[0]):
                if finished[b]:
                    chunk[b, :] = stop_arr[0]
                    continue
                hits = np.isin(chunk[b], stop_arr)
                if hits.any():
                    fi = int(hits.argmax())
                    chunk[b, fi + 1:] = chunk[b, fi]
                    finished[b] = True
            return chunk, finished, bool(finished.all())

        cur = sample_token(last_logits, generator, temperature, top_p)
        finished = np.zeros(B, bool)
        produced = 1
        chunk_np, finished, done = cut(_host(cur[:, None]), finished)
        yield chunk_np
        if done:
            return
        if spec:
            for emit in _spec_chunks(model, orig_ids, cur, cache,
                                     max_new_tokens, spec, temperature,
                                     top_p, generator, cuda_graphs):
                chunk_np, finished, done = cut(emit, finished)
                yield chunk_np
                if done:
                    return
            return
        size = 1
        while produced < max_new_tokens:
            n = min(size, max_new_tokens - produced)
            toks, cache = make_scan_decode(model, n, temperature, top_p,
                                           cuda_graphs)(cur, cache,
                                                        generator)
            cur = toks[:, -1]
            produced += n
            chunk_np, finished, done = cut(_host(toks), finished)
            yield chunk_np
            if done:
                return
            size = min(size * 2, chunk_max)
    finally:
        if solo:
            solo.give_back(cache)


def generate(model: LlavaModel, input_ids: np.ndarray,
             pixel_values: Optional[np.ndarray],
             attention_mask: Optional[np.ndarray] = None,
             max_new_tokens: int = 64, temperature: float = 0.0,
             top_p: float = 1.0, eos_token_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             stop_token_ids: Optional[List[int]] = None,
             speculative: int = 0, pad_to_bucket: bool = True,
             cuda_graphs: bool = True
             ) -> Tuple[np.ndarray, LlavaOutput]:
    """Prefill + decode; returns (generated ids [B, <= max_new_tokens],
    the prefill output with routing telemetry). Decoding stops once every
    row has produced a stop/eos token. speculative=K (B == 1 and more than
    one new token only) verifies K prompt-lookup drafts per forward. On
    the card the steps replay captured programs, as in `stream_generate`
    (cuda_graphs=False: eagerly)."""
    B = input_ids.shape[0]
    spec = int(speculative) if (speculative and B == 1
                                and max_new_tokens > 1) else 0
    orig_ids = np.asarray(input_ids)
    ids, mask, max_len = _bucketed(model, input_ids, pixel_values,
                                   attention_mask, max_new_tokens, spec,
                                   pad_to_bucket)
    solo = _solo_caches(model) if _captured(model, cuda_graphs) else None
    cache = solo.take(model, B, max_len) if solo else None
    try:
        last_logits, out = _prefill(model, ids, pixel_values, mask, max_len,
                                    cache)
        cache = out.cache
        stops = set(stop_token_ids or [])
        if eos_token_id is not None:
            stops.add(int(eos_token_id))
        cur = sample_token(last_logits, generator, temperature, top_p)
        if spec:
            parts = [_host(cur[:, None])]
            if not (stops and int(parts[0][0, 0]) in stops):
                for emit in _spec_chunks(model, orig_ids, cur, cache,
                                         max_new_tokens, spec, temperature,
                                         top_p, generator, cuda_graphs):
                    parts.append(emit)
                    if stops and np.isin(emit, list(stops)).any():
                        break
            all_toks = np.concatenate(parts, axis=1)
            if stops:
                stop_mask = np.isin(all_toks, list(stops))
                first_stop = np.where(stop_mask.any(1), stop_mask.argmax(1),
                                      all_toks.shape[1])
                all_toks = all_toks[:, :min(int(first_stop.max()) + 1,
                                            all_toks.shape[1])]
            return all_toks, out
        step = make_scan_decode(model, 1, temperature, top_p, cuda_graphs)
        tokens = []
        finished = np.zeros(input_ids.shape[0], bool)
        for _ in range(max_new_tokens):
            cur_np = _host(cur)
            tokens.append(cur_np)
            if stops:
                finished |= np.isin(cur_np, list(stops))
                if finished.all():
                    break
            if len(tokens) == max_new_tokens:
                break
            toks, cache = step(cur, cache, generator)
            cur = toks[:, 0]
        return np.stack(tokens, axis=1), out
    finally:
        if solo:
            solo.give_back(cache)
