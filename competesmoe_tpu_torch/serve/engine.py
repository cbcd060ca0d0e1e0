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
  drafter): greedy slots emit exactly the sequential greedy tokens;
- `spec_adaptive=True` measures the realized tokens/s of verify ticks and
  of plain ticks (an asymmetric EWMA per arm), runs the faster arm and
  probes the other every `spec_probe_interval` same-arm ticks, so traffic
  that drafts poorly is not slowed by speculation;
- `prefix_cache_slots > 0` parks the cache row of each retiring
  conversation in a side buffer keyed by (token prefix, pixel hash); a
  follow-up prompt that extends a parked conversation gathers the row,
  prefills only the suffix and splices it into its slot (hits batched by
  suffix bucket), so a multi-turn follow-up's TTFT does not grow with the
  history. Retirements are copied as one group at the top of the next
  tick, one indexed copy per cache tensor;
- `prefill_chunk > 0` prefills text prompts longer than the chunk one
  chunk per tick into a 1-row staging cache, with a decode step for the
  live slots between chunks, so one long prompt does not stall every
  stream for its whole prefill; image prompts keep grouped admission;
- `warmup()` drives tiny requests through every path serving reaches;
- on the card each tick's device step replays a captured CUDA graph (the
  counterpart of JAX's jitted programs `_step_plain`, `_step_nucleus`,
  `_spec_plain` and `_spec_nucleus`), captured at its first use over the
  engine's persistent cache and its static state: the current tokens,
  the per-slot temperature and top_p, the positions and the drafts.
  Admission, unparks, park flushes and chunked prefill stay eager and
  write into those buffers in place. `cuda_graphs=False` runs the same
  step eagerly, for comparison; on the CPU it always runs eagerly.

Random draws come from one `torch.Generator` on the model's device, seeded
by `rng_seed`. Tensor- and expert-parallel engines (`mesh`) are not ported
yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
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
from ..utils.cuda_graph import Program, capture, copy_from_host

_UNPORTED = "not ported yet (ROADMAP §1 item 1.7: {})"


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
    # prefix-cache bookkeeping: the cache length right after prefill, and
    # every emitted token (the last one is never fed back, so the row
    # holds K/V for emitted[:-1])
    base_len: int = -1
    emitted: List[int] = field(default_factory=list)


class DecodeEngine:
    """Slot-based continuous batching around one LlavaModel.

    submit() enqueues a request and returns an iterator of token ids that
    streams as the engine decodes; the engine thread owns every device
    call, captures and replays included. run_thread=False leaves stepping
    to the caller (`_tick()`). cuda_graphs=False runs the ticks' steps
    eagerly on the card (the comparison for the captured programs)."""

    def __init__(self, model, n_slots: int = 8, max_len: int = 2048,
                 steps_per_call: int = 1, rng_seed: int = 0,
                 run_thread: bool = True, max_prefill_batch: int = 4,
                 mesh=None, prefix_cache_slots: int = 0, spec_k: int = 0,
                 draft_fn=None, prefill_chunk: int = 0,
                 spec_adaptive: bool = False,
                 spec_probe_interval: int = 32, clock=time.monotonic,
                 pipeline_depth: int = 1, cuda_graphs: bool = True):
        if mesh is not None:
            raise NotImplementedError(_UNPORTED.format(
                "tensor- and expert-parallel engines"))
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
        # the two-armed bandit over tick modes: a verify tick is one
        # forward for at most 1+k tokens a slot, a plain tick scans
        # steps_per_call tokens a slot, so speculation can lose throughput
        # even when every draft is accepted if only some slots draft. The
        # gate is the measured tokens/s of each arm, not the acceptance
        # rate; `clock` is injectable for deterministic tests.
        self._spec_adaptive = bool(spec_adaptive)
        self._spec_probe_interval = int(spec_probe_interval)
        self._clock = clock
        self._arm_tps = {"verify": None, "plain": None}
        self._arm_streak = ("verify", 0)   # (last chosen arm, run length)
        self._spec_suppressed_ticks = 0
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
        # the verify step's drafts, written before each verify tick
        self._drafts_dev = (torch.zeros((n_slots, self._spec_k),
                                        dtype=torch.long, device=self.device)
                            if self._spec_k else None)
        # the captured step programs by JAX's names (see _step); their
        # graphs share one memory pool: they run one at a time
        self._graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._programs: Dict[str, Program] = {}
        self._graph_pool = None
        # chunked prefill: the in-flight long prompt, the queue behind it
        # and its 1-row staging cache
        self._pf_chunk_n = int(prefill_chunk)
        self._pf_state: Optional[dict] = None
        self._pf_queue: List[_Request] = []
        self._stage = (KVCache.create(self.cfg.decoder, 1, max_len,
                                      self.device)
                       if self._pf_chunk_n > 0 else None)
        # prefix cache: parked rows, their keys, and the retirements whose
        # rows the next tick copies in one group (before _admit can reuse
        # their slots)
        self._park_n = int(prefix_cache_slots)
        self._park = (KVCache.create(self.cfg.decoder, self._park_n,
                                     max_len, self.device)
                      if self._park_n > 0 else None)
        self._park_meta: List[Optional[dict]] = [None] * self._park_n
        self._park_clock = 0
        self._park_pending: List[tuple] = []
        self._prefix_hits = 0
        self.error: Optional[Exception] = None
        self._tokens_emitted = 0
        self._hold_admission = False   # warmup(): bursts admit as one group
        self._started = time.monotonic()
        self._stop = threading.Event()
        self._woken = threading.Event()
        # set each time a tick finds nothing to do (nothing live, nothing
        # in flight, no prefill work): the engine thread is past the end
        # of every token-emitting tick. A request's end fires inside
        # _emit mid-tick, so "every request done" is not quiescence: the
        # bandit's bookkeeping of that tick is still ahead. _warm_drain
        # waits on this.
        self._idle = threading.Event()
        self._thread = None
        if run_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # -- host <-> device without synchronising the stream -----------------

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A host array in a new tensor on the model's device, copied
        without synchronising the stream (`copy_from_host`)."""
        arr = np.ascontiguousarray(arr)
        out = torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                          device=self.device)
        copy_from_host(out, arr)
        return out

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
        p_img = int(getattr(self.cfg, "num_image_tokens", 0) or 0)
        for req, slot in zip(reqs, slots):
            req.slot = slot
            # the spliced length, from the host (the formula of the
            # capacity check): reading the cache's pos would synchronise
            n_img = int(np.sum(req.ids == IMAGE_TOKEN_INDEX))
            req.base_len = len(req.ids) + n_img * max(p_img - 1, 0)
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
        copy_from_host(self._temps_dev, self._temps)
        copy_from_host(self._topps_dev, self._topps)
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

    @staticmethod
    def _last_real(logits: torch.Tensor, mask: torch.Tensor):
        """The logits of each row's last real token of a continue-prefill:
        indexed by position WITHIN the input (the cache's pos is not the
        input's length there), at sum(mask) - 1."""
        n_real = mask.sum(dim=-1)
        return logits[torch.arange(logits.shape[0], device=logits.device),
                      n_real - 1]

    # -- prefix cache -------------------------------------------------------

    @staticmethod
    def _px_hash(px) -> Optional[int]:
        return None if px is None else hash(np.asarray(px).tobytes())

    def _find_park(self, req: _Request) -> Optional[int]:
        """The longest parked conversation that is a strict prefix of the
        request's prompt, with the same pixel hash and an image-free
        suffix."""
        ids = tuple(int(t) for t in req.ids)
        pxh = self._px_hash(req.pixel_values)
        best, best_n = None, 0
        for idx, meta in enumerate(self._park_meta):
            if meta is None or meta["pxhash"] != pxh:
                continue
            n = len(meta["ids"])
            if n <= best_n or n >= len(ids) or meta["ids"] != ids[:n]:
                continue
            suffix = ids[n:]
            if IMAGE_TOKEN_INDEX in suffix:
                continue
            # the headroom of _make_request: verify steps write
            # pos..pos+k, so a reused admission at the limit would clamp
            # accepted drafts' K/V into the dump slot
            if (meta["len"] + len(suffix) + req.max_new_tokens
                    + self._spec_k > self.max_len):
                continue
            best, best_n = idx, n
        return best

    def _unpark_admit(self, pslots: np.ndarray, pos0: np.ndarray,
                      ids: np.ndarray, mask: np.ndarray, slots: List[int],
                      temps: np.ndarray, topps: np.ndarray) -> torch.Tensor:
        """Reuse admission: gather the parked rows `pslots` (one indexed
        copy per cache tensor), set each row's pos to its parked length
        (junk past it from dead ride-along steps is never attended),
        continue-prefill the padded suffixes, splice the first len(slots)
        rows into `slots` and sample their first tokens."""
        idx = self._dev(pslots)
        park = self._park
        rows = KVCache(
            k=park.k[:, idx], v=park.v[:, idx], pos=self._dev(pos0),
            k_scale=(park.k_scale[:, idx] if park.k_scale is not None
                     else None),
            v_scale=(park.v_scale[:, idx] if park.v_scale is not None
                     else None))
        mask_d = self._dev(mask)
        out = self.model(self._dev(ids), None, attention_mask=mask_d,
                         cache=rows)
        last = self._last_real(out.logits, mask_d)
        return self._insert(out.cache, slots, last[:len(slots)], temps,
                            topps)

    def _admit_reused_group(self, bucket: int, hits: List[tuple]):
        """Admit prefix-cache hits (same suffix bucket) with one
        `_unpark_admit`; the batch pads to a pow-2 row count by repeating
        row 0, as `_admit_group` does. `hits` is [(req, park_idx), ...]."""
        nb = len(hits)
        nbp = _bucket(nb, lo=1)
        ids = np.zeros((nbp, bucket), np.int64)
        mask = np.zeros((nbp, bucket), np.int64)
        pos0 = np.zeros((nbp,), np.int64)
        pslots = np.zeros((nbp,), np.int64)
        for i, (req, pidx) in enumerate(hits):
            meta = self._park_meta[pidx]
            suffix = req.ids[len(meta["ids"]):]
            ids[i, :len(suffix)] = suffix
            mask[i, :len(suffix)] = 1
            pos0[i] = meta["len"]
            pslots[i] = pidx
        ids[nb:] = ids[0]
        mask[nb:] = mask[0]
        pos0[nb:] = pos0[0]
        pslots[nb:] = pslots[0]
        slots = [self._free.pop() for _ in hits]
        temps = np.asarray([r.temperature for r, _ in hits], np.float32)
        topps = np.asarray([r.top_p for r, _ in hits], np.float32)
        toks = self._unpark_admit(pslots, pos0, ids, mask, slots, temps,
                                  topps)
        for (req, pidx), slot in zip(hits, slots):
            meta = self._park_meta[pidx]
            req.slot = slot
            req.base_len = meta["len"] + len(req.ids) - len(meta["ids"])
            self._live[slot] = req
            self._prefix_hits += 1
        self._emit_admission(toks, [req for req, _ in hits])

    def _park_row(self, req: _Request):
        """Queue a retiring slot's row for prefix reuse; `_flush_parks`
        copies it at the top of the next tick, before the slot can be
        reused. The last emitted token was never fed, so the row holds
        K/V for prompt + emitted[:-1]."""
        fed = req.emitted[:-1]
        parked_len = req.base_len + len(fed)
        if parked_len + 1 >= self.max_len:
            return
        key = tuple(int(t) for t in req.ids) + tuple(fed)
        pidx = self._park_clock % self._park_n
        self._park_clock += 1
        self._park_meta[pidx] = {"ids": key, "len": parked_len,
                                 "pxhash": self._px_hash(req.pixel_values)}
        self._park_pending.append((pidx, req.slot))

    def _flush_parks(self):
        """Copy every row queued since the last tick into the park buffer:
        one indexed copy per cache tensor for the whole group. A park
        index queued twice (the clock wrapped within one flush) keeps the
        newest row, matching the meta that survived."""
        if not self._park_pending:
            return
        newest = {}
        for pidx, slot in self._park_pending:
            newest[pidx] = slot
        self._park_pending.clear()
        pidx = self._dev(np.asarray(list(newest), np.int64))
        lidx = self._dev(np.asarray(list(newest.values()), np.int64))
        park, c = self._park, self._cache
        park.k[:, pidx] = c.k[:, lidx]
        park.v[:, pidx] = c.v[:, lidx]
        if park.k_scale is not None:
            park.k_scale[:, pidx] = c.k_scale[:, lidx]
            park.v_scale[:, pidx] = c.v_scale[:, lidx]

    # -- chunked prefill ----------------------------------------------------

    def _chunk_prefill(self, ids: np.ndarray, mask: np.ndarray):
        """Continue-prefill one chunk [1, C] into the staging row (pos
        carries across chunks; pad writes land in the dump slot); returns
        the logits of the chunk's last real token."""
        mask_d = self._dev(mask)
        out = self.model(self._dev(ids), None, attention_mask=mask_d,
                         cache=self._stage)
        self._stage = out.cache
        return self._last_real(out.logits, mask_d)

    def _pf_start(self):
        """Begin the next queued chunked prefill when the staging row is
        idle and a slot is free (reserved now, so the finished row always
        has a home)."""
        while self._pf_state is None and self._pf_queue and self._free:
            req = self._pf_queue.pop(0)
            if req.cancelled:
                req.done = True
                req.out.put(None)
                continue
            slot = self._free.pop()
            self._stage = dataclasses.replace(
                self._stage, pos=torch.zeros((1,), dtype=torch.long,
                                             device=self.device))
            self._pf_state = {"req": req, "slot": slot, "cursor": 0}

    def _pf_step(self):
        """Prefill ONE chunk of the in-flight long prompt; after the last
        one, splice the staged row into its reserved slot and sample the
        first token (`_insert`, as grouped admission)."""
        st = self._pf_state
        req: _Request = st["req"]
        if req.cancelled:
            self._free.append(st["slot"])
            req.done = True
            req.out.put(None)
            self._pf_state = None
            return
        C = self._pf_chunk_n
        chunk = req.ids[st["cursor"]: st["cursor"] + C]
        ids = np.zeros((1, C), np.int64)
        mask = np.zeros((1, C), np.int64)
        ids[0, :len(chunk)] = chunk
        mask[0, :len(chunk)] = 1
        last = self._chunk_prefill(ids, mask)
        st["cursor"] += len(chunk)
        if st["cursor"] < len(req.ids):
            return
        slot = st["slot"]
        toks = self._insert(self._stage, [slot], last,
                            np.asarray([req.temperature], np.float32),
                            np.asarray([req.top_p], np.float32))
        req.slot = slot
        req.base_len = len(req.ids)
        self._live[slot] = req
        self._pf_state = None
        self._emit_admission(toks, [req])

    def _admit(self):
        # warmup() holds admission while it enqueues a burst so that the
        # burst admits as one group; checked in the loop condition, so a
        # tick landing mid-enqueue cannot split it
        while (not self._hold_admission and self._free
               and not self._requests.empty()):
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
            cap = self.max_prefill_batch
            if self._park_n:
                cold = []
                reuse: Dict[int, List[tuple]] = {}
                for req in live:
                    pidx = self._find_park(req)
                    if pidx is None:
                        cold.append(req)
                        continue
                    n = len(self._park_meta[pidx]["ids"])
                    reuse.setdefault(_bucket(len(req.ids) - n), []).append(
                        (req, pidx))
                for b, hits in reuse.items():
                    for i in range(0, len(hits), cap):
                        self._admit_reused_group(b, hits[i:i + cap])
                live = cold
            if self._pf_chunk_n:
                # long text prompts prefill a chunk a tick between decode
                # steps instead of stalling the live streams
                rest = []
                for req in live:
                    if (req.pixel_values is None
                            and len(req.ids) > self._pf_chunk_n):
                        self._pf_queue.append(req)
                    else:
                        rest.append(req)
                live = rest
            groups: Dict[Any, List[_Request]] = {}
            for req in live:
                pxkey = (None if req.pixel_values is None
                         else np.asarray(req.pixel_values).shape)
                groups.setdefault(
                    (_bucket(len(req.ids)), pxkey), []).append(req)
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
            if self._park_n and req.base_len >= 0:
                self._park_row(req)
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
        """Unblock every consumer: live, queued, and chunked prefill in
        flight or queued (after an engine error or at shutdown)."""
        self._inflight.clear()   # undelivered pipelined tokens are moot
        for req in list(self._live.values()):
            req.done = True
            req.out.put(None)
        if self._pf_state is not None:
            req = self._pf_state["req"]
            req.done = True
            req.out.put(None)
            self._pf_state = None
        for req in self._pf_queue:
            req.done = True
            req.out.put(None)
        self._pf_queue.clear()
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
        """One engine iteration: copy the rows parked since the last tick,
        admit pending requests, prefill one chunk of a long prompt, then
        one batched step (a verify step when spec_k > 0, the bandit
        allows it and some slot has a draft). Called only from the engine
        thread, or from tests with run_thread=False."""
        if self._park_n:
            self._flush_parks()   # before _admit can reuse source slots
        self._admit()
        if self._pf_chunk_n:
            self._pf_start()
            if self._pf_state is not None:
                self._pf_step()      # one chunk per tick
        if not self._live:
            # pipelined calls issued before the last retirement may still
            # hold undelivered tokens: flush before idling
            self._drain_all()
            if self._pf_state is None and not self._pf_queue:
                self._idle.set()
                self._woken.wait(timeout=0.05)
                self._woken.clear()
            return
        nucleus = any(self._topps[r.slot] < 1.0 and self._temps[r.slot] > 0
                      for r in self._live.values())
        # On a card the interval from t0 to _spec_record's clock holds the
        # tick's device work: speculation forces pipeline depth 1, so both
        # a verify tick and a plain tick read their tokens to the host
        # (which waits for the device) before the tick is recorded.
        t0 = self._clock() if self._spec_k else 0.0
        tried_verify = False
        if self._spec_k and self._spec_gate():
            tried_verify = True
            drafts = self._collect_drafts()
            if drafts is not None:
                before = self._tokens_emitted
                self._tick_spec(drafts, nucleus)
                self._spec_record("verify", self._tokens_emitted - before,
                                  t0)
                return
        toks = self._step("step", nucleus)
        before = self._tokens_emitted
        self._inflight.append((*self._to_host(toks), dict(self._live)))
        if len(self._inflight) >= self._pipeline_depth:
            self._drain_one()
        if self._spec_k:
            # a verify-chosen tick that found no drafts charges the plain
            # scan it ran to the verify arm: that is what choosing verify
            # was worth on this traffic. Not instantly up: the tick ran at
            # the plain scan's rate, and letting it lift the verify
            # estimate would latch verify on draft-sparse traffic.
            self._spec_record("verify" if tried_verify else "plain",
                              self._tokens_emitted - before, t0,
                              instant_up=not tried_verify)

    def _decode_steps(self, nucleus: bool) -> torch.Tensor:
        """`steps_per_call` decode steps over every slot with sampling on
        the device: the current tokens and the positions advance in place.
        Returns the tokens [n_slots, steps_per_call]."""
        cur, toks = self._cur, []
        for _ in range(self.steps_per_call):
            out = self.model(cur[:, None], None, cache=self._cache,
                             pos_in_place=True)
            cur = sample_rows(out.logits[:, 0], self._temps_dev,
                              self._topps_dev, self._gen, nucleus)
            toks.append(cur)
        self._cur.copy_(cur)
        return torch.stack(toks, dim=1)

    def _verify(self, nucleus: bool):
        """One verify forward over every slot's [cur, k drafts]
        (`verify_step` keeps each slot's verified prefix live); the current
        tokens advance in place. Returns (toks [n_slots, 1+k], n_acc)."""
        toks, n_acc = verify_step(
            self.model, torch.cat([self._cur[:, None], self._drafts_dev],
                                  dim=1),
            self._cache, self._temps_dev, self._topps_dev, self._gen,
            nucleus=nucleus)
        self._cur.copy_(torch.gather(toks, 1, n_acc[:, None])[:, 0])
        return toks, n_acc

    def _step(self, kind: str, nucleus: bool):
        """The tick's device step, `kind` 'step' (`_decode_steps`) or
        'spec' (`_verify`), with or without the nucleus filter. On the card
        it replays the program of JAX's name (`step_plain`,
        `step_nucleus`, `spec_plain`, `spec_nucleus`), captured at its first
        use (warmup() reaches every one serving does); elsewhere, or with
        cuda_graphs=False, it runs eagerly."""
        def run():
            return (self._decode_steps(nucleus) if kind == "step"
                    else self._verify(nucleus))

        if not self._graphs:
            return run()
        name = f"{kind}_{'nucleus' if nucleus else 'plain'}"
        program = self._programs.get(name)
        if program is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            program = self._programs[name] = capture(
                run, state=(self._cur, self._cache.pos),
                generators=(self._gen,), pool=self._graph_pool)
        return program()

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

    def _spec_gate(self) -> bool:
        """The bandit's choice: True when a verify tick should run
        (always, unless spec_adaptive). Prefers the arm with the higher
        tokens/s estimate; an unmeasured arm is measured first (verify
        before plain); after spec_probe_interval same-arm ticks the other
        arm is probed once, so a parked speculator comes back when the
        traffic turns repetitive again."""
        if not self._spec_adaptive:
            return True
        v, p = self._arm_tps["verify"], self._arm_tps["plain"]
        if v is None:
            choice = True
        elif p is None:
            choice = False
        else:
            choice = v >= p
        arm = "verify" if choice else "plain"
        last, run = self._arm_streak
        if arm == last and run >= self._spec_probe_interval:
            choice = not choice
        if not choice:
            self._spec_suppressed_ticks += 1
        return choice

    def _spec_record(self, arm: str, tokens: int, t0: float,
                     instant_up: bool = True) -> None:
        """Feed one tick's realized tokens/s into the bandit: an
        asymmetric EWMA, up at once (one good probe re-enables a parked
        arm) and down smoothly (one slow tick does not park a healthy
        one); `instant_up=False` when the tick did not run the charged
        arm's step."""
        if not self._spec_adaptive:
            return
        tps = tokens / max(self._clock() - t0, 1e-9)
        cur = self._arm_tps[arm]
        if cur is None:
            self._arm_tps[arm] = tps
        elif instant_up:
            self._arm_tps[arm] = max(tps, 0.8 * cur + 0.2 * tps)
        else:
            self._arm_tps[arm] = 0.8 * cur + 0.2 * tps
        last, run = self._arm_streak
        self._arm_streak = (arm, run + 1 if arm == last else 1)

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
        over [cur, k drafts] (`_verify`) and emit the accepted run per
        slot."""
        copy_from_host(self._drafts_dev, drafts)
        toks, n_acc = self._step("spec", nucleus)
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

    # -- warmup ------------------------------------------------------------

    def _warm_drain(self, reqs: List[_Request]) -> None:
        """Run the engine until every warmup request retires and the
        engine is quiescent. With the engine thread this blocks on the
        output queues and then on the thread's idle event; with
        run_thread=False it ticks here."""
        if self._thread is None:
            while self.error is None and not all(r.done for r in reqs):
                self._tick()
            self._drain_all()
        else:
            for r in reqs:
                while r.out.get() is not None:
                    pass
            # a request ends inside _emit, mid-tick: wait until the
            # thread reaches the idle branch before touching its state
            self._idle.clear()
            while self.error is None and not self._idle.wait(timeout=1.0):
                pass
        if self.error is not None:
            raise RuntimeError("engine failed during warmup") from self.error

    def warmup(self, prompt_buckets=(32,), burst_sizes=None,
               sampled: bool = True, image_shapes=()) -> dict:
        """Drive tiny requests through every path serving reaches, so no
        live request pays a first use.

        On the card the ticks' device steps are captured CUDA graphs, and
        warmup's ticks capture every one serving reaches (JAX's warmup
        compiles the same programs). The rest of the first launch of each
        path costs too: the first call of a kernel builds its library
        (`_kernels.build`, an nvcc run per source), the first matmul of
        prefill rows above the small-M kernels' M 128 creates the cuBLAS
        handle and picks its algorithm, and the caching allocator reserves
        the blocks of each new shape. The requests go through the NORMAL
        admission and step path, so the shapes are exactly those of
        serving:

        - a burst prefill and splice per (prompt bucket, pow-2 burst rows
          up to max_prefill_batch); `_hold_admission` makes each burst
          admit as one group;
        - the plain decode step, and the nucleus step when sampled=True;
        - verify ticks when spec_k > 0 (drafts forced through a temporary
          draft_fn);
        - chunked prefill when prefill_chunk > 0 (a text bucket above the
          chunk only ever admits that way, so its bursts are skipped);
        - park and unpark (suffix-only prefill) when prefix_cache_slots >
          0;
        - image-group prefill for each pixel_values shape in
          `image_shapes`.

        Afterwards draft_fn and spec_adaptive are restored, the park slots
        cleared and stats() reset, so telemetry counts real traffic only.
        Returns {"programs": [...], "seconds": float, "captured": {...}}:
        the paths under the program names of the JAX engine's warmup, and
        the captured step programs by JAX's names with each capture's
        seconds and graph-pool bytes (empty off the card).
        """
        t0 = time.monotonic()
        span = max(2, self.cfg.decoder.vocab_size - 12)
        p_img = int(getattr(self.cfg, "num_image_tokens", 0) or 0)
        if burst_sizes is None:
            cap = max(1, min(self.max_prefill_batch, self.n_slots))
            burst_sizes, size = [], 1
            while size <= cap:
                burst_sizes.append(size)
                size *= 2
            if burst_sizes[-1] != cap:
                # a non-pow-2 cap still pads to the next pow-2 row count
                burst_sizes.append(cap)
        buckets = sorted({_bucket(int(b)) for b in prompt_buckets})
        programs: List[str] = []
        old_draft = self._draft_fn
        # the bandit must not gate warmup: its first ticks carry the
        # first-use costs, and charging them to an arm could pick plain
        # during the forced-draft pass and leave verify unwarmed
        old_adaptive = self._spec_adaptive
        self._spec_adaptive = False

        def _ids(length: int, salt: int) -> np.ndarray:
            # distinct per (bucket, row): an accidental prefix hit between
            # passes would send a burst row through the unpark path
            return (11 + (salt * 7919 + np.arange(length)) % span
                    ).astype(np.int32)

        def _wlen(bucket):
            # chunking routes on the raw length (> chunk): a bucket above
            # the chunk still admits bursts of lengths up to the chunk
            if self._pf_chunk_n and bucket > self._pf_chunk_n:
                return self._pf_chunk_n
            return bucket

        def _quiescent():
            # warmup changes engine-thread state (_draft_fn, _park_meta,
            # _hold_admission) from the caller's thread; safe only while
            # the engine has nothing live, queued or in flight
            assert (not self._live and self._requests.empty()
                    and not self._inflight and self._pf_state is None
                    and not self._pf_queue), \
                "warmup changed engine state while the engine was active"

        def _burst(length, size, temp, topp, max_new=2, img_shape=None):
            _quiescent()
            self._hold_admission = True
            reqs = []
            for i in range(size):
                ids = _ids(length, length * 131 + i)
                px = None
                if img_shape is not None:
                    ids[min(1, length - 1)] = IMAGE_TOKEN_INDEX
                    px = np.zeros(img_shape, np.float32)
                reqs.append(self._make_request(
                    ids, pixel_values=px, max_new_tokens=max_new,
                    temperature=temp, top_p=topp))
            self._hold_admission = False
            self._woken.set()
            self._warm_drain(reqs)
            return reqs

        try:
            variants = [(0.0, 1.0, "plain")]
            if sampled:
                variants.append((0.7, 0.9, "nucleus"))
            for temp, topp, tag in variants:
                # plain and nucleus ticks must not become verify ticks
                _quiescent()
                self._draft_fn = lambda history, k: None
                for bucket in buckets:
                    if bucket + 2 + self._spec_k > self.max_len:
                        continue
                    wl = _wlen(bucket)
                    if _bucket(wl) == bucket:
                        for size in burst_sizes:
                            _burst(wl, size, temp, topp)
                            programs.append(
                                f"prefill[b{bucket} x{size}]+step:{tag}")
                    for shape in image_shapes:
                        # image prompts never chunk: the full bucket
                        if (bucket + max(p_img - 1, 0) + 2
                                + self._spec_k > self.max_len):
                            continue
                        for size in burst_sizes:
                            _burst(bucket, size, temp, topp,
                                   img_shape=shape)
                            programs.append(
                                f"img_prefill[b{bucket} x{size} "
                                f"{tuple(shape)}]:{tag}")
                if self._spec_k:
                    _quiescent()
                    self._draft_fn = (
                        lambda history, k: np.full((k,), 11, np.int32))
                    _burst(_wlen(buckets[0]), 1, temp, topp,
                           max_new=self._spec_k + 2)
                    programs.append(f"spec_verify:{tag}")
            self._draft_fn = lambda history, k: None
            if self._pf_chunk_n:
                n = self._pf_chunk_n + 1
                if n + 2 + self._spec_k <= self.max_len:
                    _quiescent()
                    self._warm_drain([self._make_request(
                        _ids(n, 997), max_new_tokens=2)])
                    programs.append(f"chunked_prefill[{self._pf_chunk_n}]")
            if self._park_n:
                # one reuse shape per (pow-2 hit rows, suffix bucket): each
                # burst size up to the park capacity
                for size in [b for b in burst_sizes if b <= self._park_n]:
                    # scrub between passes: a previous pass's parked rows
                    # would prefix-hit this pass's first turns
                    self._park_meta = [None] * self._park_n
                    self._park_pending.clear()
                    firsts = _burst(_wlen(buckets[0]), size, 0.0, 1.0,
                                    max_new=4)
                    self._hold_admission = True
                    follows = []
                    for j, first in enumerate(firsts):
                        follow = np.concatenate(
                            [first.ids, np.asarray(first.emitted, np.int32),
                             _ids(8, 499 + 13 * j)])
                        if len(follow) + 2 + self._spec_k > self.max_len:
                            continue
                        follows.append(self._make_request(
                            follow, max_new_tokens=2))
                    self._hold_admission = False
                    self._woken.set()
                    if follows:
                        self._warm_drain(follows)
                        programs.append(f"park+unpark x{len(follows)}")
        finally:
            self._spec_adaptive = old_adaptive
            self._draft_fn = old_draft
            self._hold_admission = False
            # scrub: telemetry and the prefix cache count real traffic
            self._park_meta = [None] * self._park_n
            self._park_pending.clear()
            self._park_clock = 0
            self._prefix_hits = 0
            self._spec_calls = self._spec_accepted = self._spec_tokens = 0
            # warmup's drafts are synthetic and its ticks carry first-use
            # costs: the bandit starts again from no estimates
            self._arm_tps = {"verify": None, "plain": None}
            self._arm_streak = ("verify", 0)
            self._spec_suppressed_ticks = 0
            self._tokens_emitted = 0
            self._started = time.monotonic()
        return {"programs": programs,
                "seconds": round(time.monotonic() - t0, 3),
                "captured": {name: {"seconds": round(p.seconds, 3),
                                    "pool_bytes": p.pool_bytes}
                             for name, p in self._programs.items()}}

    def stats(self) -> dict:
        """Slot and throughput telemetry, merged into /worker_get_status
        (the keys of the JAX engine's stats)."""
        elapsed = max(time.monotonic() - self._started, 1e-9)
        out = {
            "engine_slots_live": len(self._live),
            "engine_slots_free": len(self._free),
            "engine_queued": self._requests.qsize(),
            "engine_tokens_emitted": self._tokens_emitted,
            "engine_tokens_per_sec_lifetime": round(
                self._tokens_emitted / elapsed, 2),
            "engine_prefix_cache_hits": self._prefix_hits,
        }
        if self._pf_chunk_n:
            out["engine_chunked_prefill_queued"] = (
                len(self._pf_queue) + (self._pf_state is not None))
        if self._spec_k:
            out.update(
                engine_spec_verify_calls=self._spec_calls,
                engine_spec_accepted_drafts=self._spec_accepted,
                # over verify-tick emissions only
                engine_spec_tokens_per_step=round(
                    self._spec_tokens / max(self._spec_calls, 1), 2))
            if self._spec_adaptive:
                tps = {arm: (None if v is None else round(v, 1))
                       for arm, v in self._arm_tps.items()}
                out.update(
                    engine_spec_tps_verify=tps["verify"],
                    engine_spec_tps_plain=tps["plain"],
                    engine_spec_suppressed_ticks=self._spec_suppressed_ticks)
        return out

    def shutdown(self):
        self._stop.set()
        self._woken.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # consumers blocked on out.get() must not hang past shutdown
        self._release_waiters()
