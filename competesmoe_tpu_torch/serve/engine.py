"""Continuous-batching decode engine (port of the core of
competesmoe_tpu/serve/engine.py).

A decode step at small batch is bound by weight bytes, so batching
requests into one step costs little more than serving one. The engine
gives serving that batching dynamically:

- a fixed pool of `n_slots` sequences shares ONE KV cache
  [L, n_slots, max_len, hk, d], updated in place (JAX donates it);
- arriving requests are admitted in GROUPS: pending prompts that share a
  pow-2 length bucket (and image shape) prefill as one padded batch (the
  row count pow-2 padded, at most `max_prefill_batch` rows), and every row
  is spliced into its free slot with its first token sampled;
- slots retire on eos or max tokens and are reusable at once; dead slots
  ride along in the step (their writes clamp into their own rows) and the
  host ignores their tokens; a consumer that abandons its iterator cancels
  its request at the next token boundary;
- per-slot temperature and top_p ride as device vectors, so greedy and
  sampled requests share one step; the nucleus (top_p < 1) variant runs
  only while such a request is live;
- one tick runs `steps_per_call` decode steps with sampling on the device;
- `pipeline_depth=2` issues tick N+1 before reading tick N's tokens: the
  tokens are copied to pinned host memory without blocking and read after
  an event, so host dispatch overlaps device execution. Emission uses the
  slot -> request snapshot taken at issue time, so a slot retired and
  reused in between never receives the old sequence's tokens;
- `spec_k > 0` verifies k prompt-lookup drafts per slot in one forward
  (`models.llava.speculative_accept`; `draft_fn` may replace the
  drafter): greedy slots emit exactly the sequential greedy tokens.

Random draws come from one `torch.Generator` on the model's device, seeded
by `rng_seed`. The prefix cache, chunked prefill, adaptive speculation,
warmup and meshes are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..constants import IMAGE_TOKEN_INDEX
from ..models.decoder import KVCache
from ..models.llava import _prefill, sample_rows, verify_step

_UNPORTED = "not ported yet (ROADMAP §1 item 5: {})"


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class _Request:
    ids: np.ndarray                 # [L] int32 prompt
    pixel_values: Optional[np.ndarray]
    max_new_tokens: int
    temperature: float
    top_p: float
    eos_ids: frozenset
    out: "queue.Queue[Optional[int]]" = field(
        default_factory=lambda: queue.Queue())
    slot: int = -1
    produced: int = 0
    done: bool = False
    # set by the consumer (iterator abandoned); the engine retires the
    # slot at the next token boundary
    cancelled: bool = False
    emitted: List[int] = field(default_factory=list)


class DecodeEngine:
    """Slot-based continuous batching around one LlavaModel.

    submit() enqueues a request and returns an iterator of token ids that
    streams as the engine decodes; the engine thread owns every device
    call. run_thread=False leaves stepping to the caller (`_tick()`)."""

    def __init__(self, model, n_slots: int = 8, max_len: int = 2048,
                 steps_per_call: int = 1, rng_seed: int = 0,
                 run_thread: bool = True, max_prefill_batch: int = 4,
                 mesh=None, prefix_cache_slots: int = 0, spec_k: int = 0,
                 draft_fn=None, prefill_chunk: int = 0,
                 spec_adaptive: bool = False, pipeline_depth: int = 1):
        for value, what in (
                (mesh is not None, "tensor- and expert-parallel engines"),
                (prefix_cache_slots, "the engine's prefix cache"),
                (prefill_chunk, "chunked prefill"),
                (spec_adaptive, "adaptive speculation (spec_adaptive)")):
            if value:
                raise NotImplementedError(_UNPORTED.format(what))
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.steps_per_call = steps_per_call
        self.max_prefill_batch = max_prefill_batch
        self._spec_k = int(spec_k)
        # draft_fn(history_tokens: list[int], k) -> Optional[np.ndarray]
        # replaces the prompt-lookup drafter
        self._draft_fn = draft_fn
        self._spec_calls = 0
        self._spec_accepted = 0
        self._spec_tokens = 0   # emitted by verify ticks only
        self._pipeline_depth = max(1, int(pipeline_depth))
        if self._pipeline_depth > 1 and self._spec_k:
            raise ValueError(
                "pipeline_depth > 1 requires spec_k == 0: drafts are "
                "built from emitted history, which pipelining observes "
                "one call late")
        # [(host tokens [rows, k], ready event or None, row -> request)]
        self._inflight: List[tuple] = []
        self._requests: "queue.Queue[_Request]" = queue.Queue()
        self._live: Dict[int, _Request] = {}
        self._free = list(range(n_slots))
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._cache = KVCache.create(self.cfg.decoder, n_slots, max_len,
                                     self.device)
        self._cur = torch.zeros((n_slots,), dtype=torch.long,
                                device=self.device)
        self._temps = np.zeros((n_slots,), np.float32)
        self._topps = np.ones((n_slots,), np.float32)
        self._temps_dev = self._dev(self._temps)
        self._topps_dev = self._dev(self._topps)
        self.error: Optional[Exception] = None
        self._tokens_emitted = 0
        self._started = time.monotonic()
        self._stop = threading.Event()
        self._woken = threading.Event()
        self._thread = None
        if run_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # -- host <-> device without synchronising the stream -----------------

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the model's device. On a card the copy goes
        through pinned memory and does not block: a plain copy would
        synchronise the stream, and so wait for every queued tick."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor):
        """(host copy, event) started now; `_read` waits for it."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _read(host: torch.Tensor, ev) -> np.ndarray:
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    # -- admission ----------------------------------------------------------

    def _run_prefill(self, bucket: int, ids, px, mask):
        """Admission prefill. Text groups use a bucket+1-length cache
        (slot `bucket` is the pad dump), so the transient rows and the
        insert scale with the prompt bucket, not max_len; image groups
        keep max_len (the spliced sequence exceeds the token bucket)."""
        max_len = (min(bucket + 1, self.max_len) if px is None
                   else self.max_len)
        return _prefill(self.model, ids, px, mask, max_len)

    def _admit_group(self, bucket: int, reqs: List[_Request]):
        """Prefill `reqs` (same prompt bucket and image shape) as ONE
        padded batch and splice every row into a free slot. Prompts
        right-pad to `bucket` with mask 0 (padding lands in the cache dump
        slot); the batch pads to a pow-2 row count by repeating row 0,
        whose copies are not spliced."""
        nb = len(reqs)
        nbp = _bucket(nb, lo=1)
        ids = np.zeros((nbp, bucket), np.int64)
        mask = np.zeros((nbp, bucket), np.int64)
        for i, req in enumerate(reqs):
            ids[i, :len(req.ids)] = req.ids
            mask[i, :len(req.ids)] = 1
        ids[nb:] = ids[0]
        mask[nb:] = mask[0]
        px = None
        if reqs[0].pixel_values is not None:
            rows = [np.asarray(r.pixel_values, np.float32) for r in reqs]
            px = self._dev(np.concatenate(rows + [rows[0]] * (nbp - nb),
                                          axis=0))
        last, out = self._run_prefill(bucket, self._dev(ids), px,
                                      self._dev(mask))
        slots = [self._free.pop() for _ in reqs]
        temps = np.asarray([r.temperature for r in reqs], np.float32)
        topps = np.asarray([r.top_p for r in reqs], np.float32)
        toks = self._insert(out.cache, slots, last[:nb], temps, topps)
        for req, slot in zip(reqs, slots):
            req.slot = slot
            self._live[slot] = req
        self._emit_admission(toks, reqs)

    def _insert(self, rows: KVCache, slots: List[int], last: torch.Tensor,
                temps: np.ndarray, topps: np.ndarray) -> torch.Tensor:
        """Splice prefilled rows into their slots in place and sample each
        row's first token (always the nucleus form: one vocab sort per
        admitted request). Rows may be shorter than the engine cache; the
        slice beyond them keeps the previous occupant's stale K/V, which is
        never attended before the step that overwrites it."""
        nb = len(slots)
        idx = self._dev(np.asarray(slots, np.int64))
        n = rows.k.shape[2]
        c = self._cache
        c.k[:, idx, :n] = rows.k[:, :nb]
        c.v[:, idx, :n] = rows.v[:, :nb]
        if c.k_scale is not None:
            c.k_scale[:, idx, :n] = rows.k_scale[:, :nb]
            c.v_scale[:, idx, :n] = rows.v_scale[:, :nb]
        c.pos[idx] = rows.pos[:nb]
        self._temps[slots] = temps
        self._topps[slots] = topps
        self._temps_dev = self._dev(self._temps)
        self._topps_dev = self._dev(self._topps)
        toks = sample_rows(last, self._dev(temps), self._dev(topps),
                           self._gen, nucleus=True)
        self._cur[idx] = toks
        return toks

    def _emit_admission(self, toks: torch.Tensor, reqs: List[_Request]):
        """First-token delivery for an admission group: synchronous at
        pipeline depth 1; otherwise the tokens join the in-flight queue
        (FIFO: they drain before the same request's step tokens)."""
        if self._pipeline_depth > 1:
            self._inflight.append((*self._to_host(toks[:, None]),
                                   dict(enumerate(reqs))))
            if len(self._inflight) >= self._pipeline_depth:
                self._drain_one()
            return
        toks = self._read(*self._to_host(toks))
        for i, req in enumerate(reqs):
            self._emit(req, int(toks[i]))

    def _admit(self):
        while self._free and not self._requests.empty():
            pending: List[_Request] = []
            while len(pending) < len(self._free):
                try:
                    pending.append(self._requests.get_nowait())
                except queue.Empty:
                    break
            if not pending:
                return
            live = []
            for req in pending:
                if req.cancelled:
                    req.done = True
                    req.out.put(None)
                else:
                    live.append(req)
            groups: Dict[Any, List[_Request]] = {}
            for req in live:
                pxkey = (None if req.pixel_values is None
                         else np.asarray(req.pixel_values).shape)
                groups.setdefault(
                    (_bucket(len(req.ids)), pxkey), []).append(req)
            cap = self.max_prefill_batch
            for (bucket, _), reqs in groups.items():
                for i in range(0, len(reqs), cap):
                    self._admit_group(bucket, reqs[i:i + cap])

    # -- engine thread ------------------------------------------------------

    def _emit(self, req: _Request, token: int):
        if req.done:
            return
        if req.cancelled:
            req.done = True
            req.out.put(None)
            self._live.pop(req.slot, None)
            self._free.append(req.slot)
            return
        req.produced += 1
        self._tokens_emitted += 1
        req.emitted.append(token)
        req.out.put(token)
        if token in req.eos_ids or req.produced >= req.max_new_tokens:
            req.done = True
            req.out.put(None)
            self._live.pop(req.slot, None)
            self._free.append(req.slot)

    def _loop(self):
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — surface to all waiters
            self.error = e
            self._release_waiters()

    def _release_waiters(self):
        """Unblock every consumer, live or queued (after an engine error
        or at shutdown)."""
        self._inflight.clear()   # undelivered pipelined tokens are moot
        for req in list(self._live.values()):
            req.done = True
            req.out.put(None)
        while not self._requests.empty():
            try:
                self._requests.get_nowait().out.put(None)
            except queue.Empty:
                break

    def _run(self):
        while not self._stop.is_set():
            self._tick()
        self._drain_all()   # deliver in-flight tokens before shutdown

    @torch.no_grad()
    def _tick(self):
        """One engine iteration: admit pending requests, then one batched
        step (a verify step when spec_k > 0 and some slot has a draft).
        Called only from the engine thread, or from tests with
        run_thread=False."""
        self._admit()
        if not self._live:
            # pipelined calls issued before the last retirement may still
            # hold undelivered tokens: flush before idling
            self._drain_all()
            self._woken.wait(timeout=0.05)
            self._woken.clear()
            return
        nucleus = any(self._topps[r.slot] < 1.0 and self._temps[r.slot] > 0
                      for r in self._live.values())
        if self._spec_k:
            drafts = self._collect_drafts()
            if drafts is not None:
                self._tick_spec(drafts, nucleus)
                return
        cur, cache, toks = self._cur, self._cache, []
        for _ in range(self.steps_per_call):
            out = self.model(cur[:, None], None, cache=cache)
            cur = sample_rows(out.logits[:, 0], self._temps_dev,
                              self._topps_dev, self._gen, nucleus)
            cache = out.cache
            toks.append(cur)
        self._cur, self._cache = cur, cache
        self._inflight.append((*self._to_host(torch.stack(toks, dim=1)),
                               dict(self._live)))
        if len(self._inflight) >= self._pipeline_depth:
            self._drain_one()

    def _drain_one(self):
        """Read the oldest in-flight call and emit its tokens to the
        requests that were live when it was ISSUED (retired-then-reused
        slots must not receive the old sequence's tokens: _emit's done
        guard drops the retirees)."""
        host, ev, snap = self._inflight.pop(0)
        toks = self._read(host, ev)               # [rows, k]
        for k in range(toks.shape[1]):
            for row, req in snap.items():
                self._emit(req, int(toks[row, k]))

    def _drain_all(self):
        while self._inflight:
            self._drain_one()

    def _collect_drafts(self) -> Optional[np.ndarray]:
        """Prompt-lookup draft per live slot (host side). Returns
        [n_slots, k] or None when no slot produced a draft."""
        from .speculative import ngram_draft

        k = self._spec_k
        draft = self._draft_fn or ngram_draft
        drafts = np.zeros((self.n_slots, k), np.int64)
        found = 0
        for slot, req in self._live.items():
            d = draft(list(int(t) for t in req.ids) + req.emitted, k)
            if d is not None:
                drafts[slot] = d
                found += 1
        return drafts if found else None

    def _tick_spec(self, drafts: np.ndarray, nucleus: bool):
        """Speculative step: verify every slot's drafts in ONE forward
        over [cur, k drafts] (`verify_step` keeps each slot's verified
        prefix live) and emit the accepted run per slot."""
        toks, n_acc, self._cache = verify_step(
            self.model, torch.cat([self._cur[:, None], self._dev(drafts)],
                                  dim=1),
            self._cache, self._temps_dev, self._topps_dev, self._gen,
            nucleus=nucleus)
        self._cur = torch.gather(toks, 1, n_acc[:, None])[:, 0]
        toks = self._read(*self._to_host(toks))            # [n_slots, 1+k]
        n_acc = self._read(*self._to_host(n_acc))
        self._spec_calls += 1
        before = self._tokens_emitted
        for slot, req in list(self._live.items()):
            self._spec_accepted += int(n_acc[slot])
            for i in range(int(n_acc[slot]) + 1):
                self._emit(req, int(toks[slot, i]))
        self._spec_tokens += self._tokens_emitted - before

    # -- public API --------------------------------------------------------

    def _make_request(self, ids: np.ndarray,
                      pixel_values: Optional[np.ndarray] = None,
                      max_new_tokens: int = 128, temperature: float = 0.0,
                      top_p: float = 1.0,
                      eos_ids: Optional[List[int]] = None) -> _Request:
        """Check capacity against the spliced length (each <image>
        sentinel expands to num_image_tokens embeddings), build and
        enqueue a request."""
        n_img = int(np.sum(np.asarray(ids) == IMAGE_TOKEN_INDEX))
        p_img = int(getattr(self.cfg, "num_image_tokens", 0) or 0)
        expanded = len(ids) + n_img * max(p_img - 1, 0)
        if expanded + max_new_tokens + self._spec_k > self.max_len:
            raise ValueError(
                f"prompt {len(ids)} (expanded {expanded} with {n_img} "
                f"image(s) x {p_img} tokens) + max_new {max_new_tokens} "
                f"(+ spec_k {self._spec_k}) exceeds engine max_len "
                f"{self.max_len}")
        req = _Request(ids=np.asarray(ids, np.int32),
                       pixel_values=pixel_values,
                       max_new_tokens=max_new_tokens,
                       temperature=temperature, top_p=top_p,
                       eos_ids=frozenset(eos_ids or []))
        self._requests.put(req)
        self._woken.set()
        return req

    def submit(self, ids: np.ndarray,
               pixel_values: Optional[np.ndarray] = None,
               max_new_tokens: int = 128, temperature: float = 0.0,
               top_p: float = 1.0,
               eos_ids: Optional[List[int]] = None) -> Iterator[int]:
        """Enqueue a prompt; yields sampled token ids as they decode."""
        req = self._make_request(ids, pixel_values, max_new_tokens,
                                 temperature, top_p, eos_ids)
        try:
            while True:
                tok = req.out.get()
                if tok is None:
                    return
                yield tok
        finally:
            # abandoning the iterator retires the slot at the next token
            # boundary instead of decoding to max_new_tokens
            req.cancelled = True

    def warmup(self, *args, **kwargs):
        """JAX compiles each program shape ahead of traffic here; the
        port runs eagerly and has no such step yet (CUDA graphs of the
        tick are queued speed work)."""
        raise NotImplementedError(_UNPORTED.format("engine warmup"))

    def stats(self) -> dict:
        """Slot and throughput telemetry, merged into /worker_get_status."""
        elapsed = max(time.monotonic() - self._started, 1e-9)
        out = {
            "engine_slots_live": len(self._live),
            "engine_slots_free": len(self._free),
            "engine_queued": self._requests.qsize(),
            "engine_tokens_emitted": self._tokens_emitted,
            "engine_tokens_per_sec_lifetime": round(
                self._tokens_emitted / elapsed, 2),
        }
        if self._spec_k:
            out.update(
                engine_spec_verify_calls=self._spec_calls,
                engine_spec_accepted_drafts=self._spec_accepted,
                # over verify-tick emissions only
                engine_spec_tokens_per_step=round(
                    self._spec_tokens / max(self._spec_calls, 1), 2))
        return out

    def shutdown(self):
        self._stop.set()
        self._woken.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # consumers blocked on out.get() must not hang past shutdown
        self._release_waiters()
