"""LLaVA model adapter for the eval harness (port of
competesmoe_tpu/eval/llava_adapter.py).

Re-design of `evaluate/lmms_eval/models/llava.py:69-572`: batched
`generate_until` with conversation templates + `process_images` +
`tokenizer_image_token`, solo or through the continuous-batching
DecodeEngine, `loglikelihood` scoring, and post-hoc per-layer routing
telemetry (gate-softmax entropy, top-1/top-2 expert histograms —
llava.py:497-537). The serving worker uses the same adapter for its
model, tokenizer, image processor and stop ids.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import IMAGE_TOKEN_INDEX
from ..models.llava import LlavaModel, generate
from ..multimodal.conversation import conv_templates
from ..multimodal.mm_utils import (
    ImageProcessorConfig,
    process_images,
    tokenizer_image_token,
)
from .collator import Collator
from .instance import Instance


def routing_telemetry(auxes) -> Dict[str, Any]:
    """Per-layer routing stats from a list of MoEAux
    (models/llava.py:497-537 scrape)."""
    out: Dict[str, Any] = {}
    for li, aux in enumerate(auxes or []):
        if aux is None or aux.gate_softmax is None:
            continue
        p = aux.gate_softmax.detach().float().cpu().numpy().astype(
            np.float64)
        p = p.reshape(-1, p.shape[-1])
        eps = 1e-12
        entropy = float((-p * np.log(p + eps)).sum(-1).mean())
        sel = aux.selected_experts.detach().cpu().numpy()
        sel = sel.reshape(-1, sel.shape[-1])
        n_exp = p.shape[-1]
        top1 = np.bincount(sel[:, 0], minlength=n_exp).tolist()
        top2 = (np.bincount(sel[:, 1], minlength=n_exp).tolist()
                if sel.shape[1] > 1 else None)
        out[f"layer_{li}"] = {
            "entropy": entropy,
            "top1_hist": top1,
            "top2_hist": top2,
            "losses": {k: float(v) for k, v in aux.losses.items()},
        }
    return out


class TorchLlava:
    """The `lmms`-style model interface (api/model.py:18-203) over
    models.llava.LlavaModel, which holds its own weights."""

    def __init__(self, model: LlavaModel, tokenizer,
                 image_processor: Optional[ImageProcessorConfig] = None,
                 conv_template: str = "phi35", batch_size: int = 1,
                 max_new_tokens: int = 128,
                 stop_token_ids: Optional[List[int]] = None,
                 speculative: int = 0,
                 engine_slots: int = 0, engine_max_len: int = 0,
                 engine_pipeline: int = 1, mesh=None):
        self.model = model
        self.tokenizer = tokenizer
        self.image_processor = image_processor or ImageProcessorConfig(
            size=model.cfg.vision.image_size)
        self.conv_template = conv_template
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.stop_token_ids = stop_token_ids or []
        # prompt-lookup speculative decoding for greedy batch-1 eval
        # (models/llava.generate speculative=K): VQA answers quote the
        # prompt, the regime where drafts accept
        self.speculative = speculative
        # engine_slots > 0: generate_until runs through the
        # continuous-batching DecodeEngine — N requests share one batched
        # decode step instead of Collator-batch generates (token-exact
        # against the solo path)
        self.engine_slots = engine_slots
        self.engine_max_len = engine_max_len
        # pipelined tick dispatch (serve/engine.py); forced to 1 when
        # speculating
        self.engine_pipeline = engine_pipeline
        self._engine = None
        self.time_inference: List[float] = []
        # a sharded model (`cli/eval_mm --mesh`): rank 0 scores the
        # documents and every model call runs on each rank in lockstep
        # (`parallel/lockstep.py`); the others wait in follow()
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._calls = {"generate": self._generate_rows,
                       "score": self._score_rows,
                       "engine": self._start_engine}
        self._lockstep = None
        self._graphs = True
        if self.mesh is not None:
            from ..parallel.lockstep import Lockstep
            from ..serve.model_worker import graphs_for
            self._graphs = graphs_for(self.mesh, model.device)
            self._lockstep = Lockstep(self._calls)

    def _run(self, name: str, *args, **kw):
        if self._lockstep is not None:
            return self._lockstep.call(name, *args, **kw)
        return self._calls[name](*args, **kw)

    def follow(self) -> None:
        """A follower rank: make rank 0's model calls until its close()."""
        self._lockstep.follow()

    # -- prompt building --

    def _build_prompt(self, context: str, has_image: bool) -> List[int]:
        conv = conv_templates[self.conv_template].copy()
        text = context
        if has_image and "<image>" not in text:
            text = "<image>\n" + text
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        return tokenizer_image_token(prompt, self.tokenizer)

    def tokenizer_ids_for_prompt(self, prompt: str,
                                 has_image: bool) -> List[int]:
        """Tokenize an already-templated prompt (serve worker path)."""
        if has_image:
            return tokenizer_image_token(prompt, self.tokenizer)
        return list(self.tokenizer(prompt).input_ids)

    def _pad_batch(self, id_lists: List[List[int]]):
        pad = getattr(self.tokenizer, "pad_token_id", 0) or 0
        L = max(len(x) for x in id_lists)
        ids = np.full((len(id_lists), L), pad, np.int32)
        mask = np.zeros((len(id_lists), L), np.int32)
        for b, x in enumerate(id_lists):
            ids[b, :len(x)] = x
            mask[b, :len(x)] = 1
        return ids, mask

    def _stop_ids(self) -> List[int]:
        eos = getattr(self.tokenizer, "eos_token_id", None)
        return ([eos] if eos is not None else []) + self.stop_token_ids

    def _text(self, row) -> str:
        """Generated ids -> the answer: cut at the first eos or stop id,
        decoded, and the phi '<|end|>' leftover cleaned
        (reference llava.py:553)."""
        row = [int(t) for t in row]
        for stop in self._stop_ids():
            if stop in row:
                row = row[:row.index(stop)]
        text = self.tokenizer.decode(row, skip_special_tokens=True)
        return text.split("<|end|>")[0].strip()

    # -- request types --

    def _start_engine(self):
        """The DecodeEngine of generate_until (a follower rank runs its
        ticks until rank 0's engine stops)."""
        from ..serve.engine import DecodeEngine
        max_len = (self.engine_max_len
                   or self.model.cfg.tokenizer_model_max_length
                   or 2048)
        self._engine = DecodeEngine(
            self.model, n_slots=self.engine_slots, max_len=max_len,
            spec_k=self.speculative,
            pipeline_depth=(1 if self.speculative
                            else self.engine_pipeline),
            mesh=self.mesh, cuda_graphs=self._graphs)
        if self.mesh is not None and self.mesh.rank != 0:
            self._engine.follow()
            self._engine = None

    def _get_engine(self):
        if self._engine is None:
            self._run("engine")
        return self._engine

    def _stop_engine(self) -> None:
        if self._engine is not None:
            self._engine.shutdown()
            self._engine = None

    def close(self) -> None:
        """Stop the engine's thread, if generate_until started one, and
        release the follower ranks."""
        self._stop_engine()
        if self._lockstep is not None and self._lockstep.lead:
            self._lockstep.stop()
            self._lockstep = None

    def _generate_until_engine(self,
                               requests: List[Instance]) -> List[str]:
        """generate_until through the continuous-batching engine: all
        requests enqueue at once; the engine keeps `engine_slots` of
        them decoding in one batched step."""
        from concurrent.futures import ThreadPoolExecutor

        engine = self._get_engine()
        eos_ids = self._stop_ids()

        def run_one(r: Instance) -> str:
            ctx, gen_kwargs, visual = (r.arguments[0],
                                       r.arguments[1] or {},
                                       r.arguments[2])
            has_image = bool(visual)
            ids = np.asarray(self._build_prompt(ctx, has_image), np.int32)
            px = (process_images([visual[0]], self.image_processor)
                  if has_image else None)
            row = list(engine.submit(
                ids, pixel_values=px,
                max_new_tokens=gen_kwargs.get("max_new_tokens",
                                              self.max_new_tokens),
                temperature=gen_kwargs.get("temperature", 0.0),
                top_p=gen_kwargs.get("top_p", 1.0),
                eos_ids=eos_ids))
            return self._text(row)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=max(self.engine_slots * 2,
                                                2)) as pool:
            ordered = list(pool.map(run_one, requests))
        if engine.error is not None:
            raise RuntimeError("eval engine died") from engine.error
        if self.mesh is not None:
            # its ticks' broadcasts would interleave with the next call's
            self._stop_engine()
        self.time_inference.append(time.perf_counter() - t0)
        for inst, resp in zip(requests, ordered):
            inst.resps.append(resp)
        return ordered

    def generate_until(self, requests: List[Instance],
                       return_id_experts: bool = False) -> List[str]:
        # routing telemetry needs the prefill's per-layer auxes, which
        # the batched engine does not surface: return_id_experts runs
        # take the solo path, as JAX's adapter does
        if self.engine_slots and not return_id_experts:
            return self._generate_until_engine(requests)
        collator = Collator(
            requests,
            sort_fn=lambda r: -len(r.arguments[0]),
            batch_size=self.batch_size)
        results: List[str] = []
        for chunk in collator:
            ctxs = [r.arguments[0] for r in chunk]
            gen_kwargs = chunk[0].arguments[1] or {}
            visuals = [r.arguments[2] for r in chunk]
            has_image = any(v for v in visuals)
            id_lists = [self._build_prompt(c, bool(v))
                        for c, v in zip(ctxs, visuals)]
            ids, mask = self._pad_batch(id_lists)
            px = None
            if has_image:
                # a chunk may mix image and text-only requests (e.g.
                # MMMU docs without figures): text-only rows get a zero
                # image whose features the splice never reads (their
                # rows contain no image token)
                rows = [i for i, v in enumerate(visuals) if v]
                px_rows = process_images([visuals[i][0] for i in rows],
                                         self.image_processor)
                px = np.zeros((len(visuals),) + px_rows.shape[1:],
                              px_rows.dtype)
                px[rows] = px_rows
            t0 = time.perf_counter()
            toks, out = self._run(
                "generate", ids, px, np.asarray(mask),
                gen_kwargs.get("max_new_tokens", self.max_new_tokens),
                gen_kwargs.get("temperature", 0.0),
                gen_kwargs.get("top_p", 1.0))
            self.time_inference.append(time.perf_counter() - t0)
            for b, row in enumerate(toks):
                results.append(self._text(row))
                if return_id_experts:
                    chunk[b].logs_metrics_vision = routing_telemetry(
                        out.vision_auxes)
                    pa = out.projector_aux
                    chunk[b].logs_metrics_mlp = routing_telemetry(
                        [pa] if pa is not None else [])
        ordered = collator.get_original(results)
        for inst, resp in zip(requests, ordered):
            inst.resps.append(resp)
        return ordered

    # loglikelihood: batched, with sequence lengths rounded up to
    # `pad_quantum`, so that a few bucket shapes serve every request (the
    # reference's pad_quantum trick, lm_eval_mixin.py:82-95)
    pad_quantum: int = 64

    def _generate_rows(self, ids, px, mask, max_new_tokens, temperature,
                       top_p):
        return generate(
            self.model, ids, px, attention_mask=mask,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p,
            eos_token_id=getattr(self.tokenizer, "eos_token_id", None),
            stop_token_ids=self.stop_token_ids,
            speculative=self.speculative, cuda_graphs=self._graphs)

    def _score(self, ids, attn, px, tgt_tok, tgt_mask):
        return self._run("score", ids, attn, px, tgt_tok, tgt_mask)

    @torch.no_grad()
    def _score_rows(self, ids, attn, px, tgt_tok, tgt_mask):
        """(total log-probability of the masked targets, whether each is
        the greedy choice) per row; log_softmax in float32."""
        dev = self.model.device
        out = self.model(
            torch.as_tensor(ids, dtype=torch.long, device=dev),
            None if px is None else torch.as_tensor(px, device=dev),
            attention_mask=torch.as_tensor(attn, device=dev))
        lp = torch.log_softmax(out.logits.float(), -1)
        tgt = torch.as_tensor(tgt_tok, dtype=torch.long, device=dev)
        m = torch.as_tensor(tgt_mask, device=dev)
        tok_lp = torch.gather(lp, -1, tgt[..., None])[..., 0]
        total = (tok_lp * m).sum(-1)
        greedy = torch.where(m > 0, lp.argmax(-1) == tgt,
                             torch.ones_like(tgt, dtype=torch.bool)
                             ).all(-1)
        return total.cpu().numpy(), greedy.cpu().numpy()

    def _quantize(self, n: int) -> int:
        q = self.pad_quantum
        return max(q, ((n + q - 1) // q) * q)

    def loglikelihood(self, requests: List[Instance],
                      return_id_experts: bool = False
                      ) -> List[Tuple[float, bool]]:
        prepped = []
        for req in requests:
            ctx, target, visuals = req.arguments
            prompt_ids = self._build_prompt(ctx, bool(visuals))
            tgt_ids = list(self.tokenizer(target).input_ids)
            bos = getattr(self.tokenizer, "bos_token_id", None)
            if tgt_ids and bos is not None and tgt_ids[0] == bos:
                tgt_ids = tgt_ids[1:]
            prepped.append((prompt_ids, tgt_ids, visuals))

        results: List = [None] * len(requests)
        buckets: Dict[Tuple[int, bool], List[int]] = {}
        for i, (p, t, v) in enumerate(prepped):
            L = self._quantize(len(p) + len(t))
            buckets.setdefault((L, bool(v)), []).append(i)

        P = self.model.cfg.num_image_tokens
        pad = getattr(self.tokenizer, "pad_token_id", 0) or 0
        for (L, has_image), idxs in buckets.items():
            for s in range(0, len(idxs), self.batch_size):
                batch = idxs[s:s + self.batch_size]
                B = len(batch)
                L_out = L + (P - 1 if has_image else 0)
                ids = np.full((B, L), pad, np.int32)
                attn = np.zeros((B, L), np.int32)
                tgt_tok = np.zeros((B, L_out), np.int32)
                tgt_mask = np.zeros((B, L_out), np.float32)
                imgs = []
                for row, i in enumerate(batch):
                    p, t, v = prepped[i]
                    full = (p + t)[:L]
                    ids[row, :len(full)] = full
                    attn[row, :len(full)] = 1
                    # the image token becomes P positions in the logits
                    off = P - 1 if has_image and \
                        IMAGE_TOKEN_INDEX in p else 0
                    start = len(p) + off
                    for j, tok in enumerate(t):
                        pos = start + j - 1  # logits[pos] predict pos+1
                        if 0 <= pos < L_out:
                            tgt_tok[row, pos] = tok
                            tgt_mask[row, pos] = 1.0
                    if has_image:
                        imgs.append(v[0])
                px = (process_images(imgs, self.image_processor)
                      if has_image else None)
                t0 = time.perf_counter()
                total, greedy = self._score(ids, attn, px, tgt_tok,
                                            tgt_mask)
                self.time_inference.append(time.perf_counter() - t0)
                for row, i in enumerate(batch):
                    results[i] = (float(total[row]), bool(greedy[row]))
        for req, res in zip(requests, results):
            req.resps.append(res)
        return results
