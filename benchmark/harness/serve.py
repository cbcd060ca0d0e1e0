"""A serving cell: a LLaVA configuration served by the port's
`DecodeEngine` as the worker builds it, under a closed-loop mix.

Set-up: the benchmark's seeded weights (`reference.weights`, made on the
device) go through the port's checkpoint converter into a `LlavaModel`,
which takes the configuration's deployment quantization (`--load-4bit`,
`--kv-quant int8`); `make_engine` builds the engine; `DecodeEngine.warmup`
and bursts of the mix's own shapes (the prompt buckets warmup leaves out)
warm every program and prefill shape the mix reaches. Then the clients
start, staggered, and the window opens `ramp_s` after the first request.

In the window each client thread sends its next request through
`DecodeEngine.submit` as soon as its last one has finished, and stamps
every token as it arrives. At the window's close the clients stop and the
engine shuts down; requests still in flight are abandoned.

The output check (`output_check`), once the program is freed: greedy
requests that finished in the window, the longest, the longest with an
image and others drawn from the seed up to the mix's `check_tokens`, go
through the plain float32 reference (`reference.llava`). Two numbers are
held to the configuration's limits: the widest gap, as a share of the
row's largest logit, by which a served token's logit lies below the
reference's best (the reference's decoder taking the program's own
projector rows for an image, `ImageRows`), and, over the images compared,
the largest of each image's median row error of those projector rows
against the reference's own tower and projector.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from . import spec, stats
from .trace import ForwardLog, Trace, decoder_rows, tower_rows

SAMPLE_EVERY_S = 0.02


def log(t_start: float, msg: str) -> None:
    print(f"[{time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def bucket(n: int, lo: int = 32) -> int:
    """The engine's prompt bucket: the power of two from `lo` at or above
    n (`serve.engine._bucket`)."""
    b = lo
    while b < n:
        b *= 2
    return b


def build_model(cfg: dict, seed: int, device):
    """The served model: seeded weights in the released layout through the
    port's converter, loaded into a LlavaModel built on the meta device,
    then the deployment's quantization. Only the program holds the weights
    afterwards."""
    from competesmoe_tpu_torch.models import builder
    from competesmoe_tpu_torch.models.llava import LlavaModel

    from reference.weights import Geometry, iter_checkpoint

    hf, dep = cfg["hf_config"], cfg["deployment"]
    mcfg = builder.llava_config_from_hf(hf, "", torch.bfloat16)
    if dep.get("kv_quant"):
        mcfg = dataclasses.replace(mcfg, decoder=dataclasses.replace(
            mcfg.decoder, kv_quant=dep["kv_quant"]))
    sd = dict(iter_checkpoint(Geometry.from_hf(hf), seed, device))
    converted = builder.convert_llava_checkpoint(sd, mcfg)
    del sd
    model = LlavaModel(mcfg, device="meta")
    want = model.state_dict()
    model.load_state_dict({k: converted[k].contiguous() for k in want},
                          strict=True, assign=True)
    del converted, want
    if dep.get("load_4bit"):
        builder.apply_load_4bit(model)
    return model


def make_engine(model, cfg: dict):
    from competesmoe_tpu_torch.serve.model_worker import make_engine as mk
    dep = cfg["deployment"]
    return mk(model, dep["engine_slots"], dep["engine_max_len"],
              speculative=dep.get("speculative", 0),
              engine_pipeline=dep.get("engine_pipeline", 2))


def _burst(engine, reqs) -> None:
    """Send `reqs` [(ids, pixels, temperature, top_p)] so that they admit
    as one group (as `DecodeEngine.warmup` does) and wait for them."""
    engine._hold_admission = True
    made = [engine._make_request(ids, px, max_new_tokens=2, temperature=t,
                                 top_p=p) for ids, px, t, p in reqs]
    engine._hold_admission = False
    engine._woken.set()
    for r in made:
        while r.out.get() is not None:
            pass


def warm(engine, plan, cfg: dict) -> dict:
    """Every prefill shape and decode program the mix reaches, before the
    window: `warmup` for the prompt buckets it takes, bursts of 1, 2 and
    4 rows (plain and, where the mix samples, nucleus) for the rest."""
    dep = cfg["deployment"]
    max_len, patches = dep["engine_max_len"], engine.cfg.num_image_tokens
    shapes = plan.shapes
    sampled = any(s.sampled for s in shapes)
    size = plan.params.get("image_size")
    img_shape = (1, size, size, 3)
    keys = {(bucket(s.prompt), s.image) for s in shapes}
    taken = sorted({b for b, _ in keys if b + 2 <= max_len})
    info = engine.warmup(
        prompt_buckets=taken, sampled=sampled,
        image_shapes=[img_shape] if any(s.image for s in shapes) else ())
    rest = sorted(k for k in keys if k[0] not in taken or (
        k[1] and k[0] + patches + 1 > max_len))
    rng = np.random.default_rng(0)
    variants = [(0.0, 1.0)] + ([(0.7, 0.9)] if sampled else [])
    for b, image in rest:
        n = max(s.prompt for s in shapes
                if bucket(s.prompt) == b and s.image == image)
        for t, p in variants:
            for rows in (1, 2, 4):
                reqs = []
                for _ in range(rows):
                    ids = rng.integers(3, engine.cfg.decoder.vocab_size,
                                       n).astype(np.int32)
                    px = None
                    if image:
                        ids[1] = -200
                        px = np.zeros(img_shape, np.float32)
                    reqs.append((ids, px, t, p))
                _burst(engine, reqs)
    info["bursts"] = [list(k) for k in rest]
    return info


class Client(threading.Thread):
    """One closed-loop client: from `start`, send the next request of its
    plan as soon as the last one has finished, until `stop`."""

    def __init__(self, engine, plan, client: int, start: float,
                 stop: threading.Event, out: List[stats.Record],
                 patches: int):
        super().__init__(daemon=True)
        self.engine, self.plan, self.client = engine, plan, client
        self.start_at, self.stop, self.out = start, stop, out
        self.patches = patches

    def run(self):
        while time.perf_counter() < self.start_at:
            if self.stop.wait(max(0.0, self.start_at - time.perf_counter())):
                return
        while not self.stop.is_set():
            req = self.plan.next(self.client)
            rec = stats.Record(
                index=req.index, client=self.client, sent=0.0,
                prompt=len(req.ids) + (self.patches - 1 if req.shape.image
                                       else 0),
                max_new=req.shape.output, greedy=req.temperature <= 0,
                image=req.shape.image)
            rec.sent = time.perf_counter()
            it = self.engine.submit(req.ids, req.pixels,
                                    max_new_tokens=req.shape.output,
                                    temperature=req.temperature,
                                    top_p=req.top_p)
            try:
                for tok in it:
                    rec.times.append(time.perf_counter())
                    rec.tokens.append(int(tok))
                    if self.stop.is_set():
                        break
            except Exception as e:  # noqa: BLE001 - a failed request
                rec.failed, rec.error = True, repr(e)
            finally:
                it.close()
            if (not rec.finished and not self.stop.is_set()
                    and not rec.failed):
                rec.failed, rec.error = True, "ended early"
            self.out.append(rec)


@dataclasses.dataclass
class Served:
    records: List[stats.Record]
    w0: float
    w1: float
    trace: Optional[Trace] = None
    decoder_rows: List[tuple] = dataclasses.field(default_factory=list)
    tower_rows: List[tuple] = dataclasses.field(default_factory=list)
    live_slots: List[int] = dataclasses.field(default_factory=list)
    engine_error: Optional[str] = None
    trace_window: Optional[tuple] = None


def serve(engine, plan, seconds: float, traced: bool, logs=None) -> Served:
    """The ramp and the window (see the module docstring). With `traced`,
    the mix's first `trace_s` seconds of the window run under
    torch.profiler, recording the host operations of every thread (the
    engine's own among them), and the engine's live slots are sampled
    through them."""
    records: List[stats.Record] = []
    stop = threading.Event()
    params = plan.params
    t0 = time.perf_counter() + 0.05
    patches = engine.cfg.num_image_tokens
    clients = [Client(engine, plan, c, t0 + plan.start_offset(c), stop,
                      records, patches) for c in range(plan.clients)]
    for c in clients:
        c.start()
    w0 = t0 + params["ramp_s"]
    w1 = w0 + seconds
    out = Served(records=records, w0=w0, w1=w1)
    _sleep_until(w0)
    if traced:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
        prof.__enter__()
        p0 = time.perf_counter()
        while time.perf_counter() < p0 + params["trace_s"]:
            out.live_slots.append(engine.stats()["engine_slots_live"])
            time.sleep(SAMPLE_EVERY_S)
        p1 = time.perf_counter()
        prof.__exit__(None, None, None)
        dec, tow = logs
        out.decoder_rows = dec.between(p0, p1)
        out.tower_rows = tow.between(p0, p1)
        out.trace_window = (p0, p1)
    _sleep_until(w1)
    stop.set()
    engine.shutdown()
    for c in clients:
        c.join(timeout=30)
    if any(c.is_alive() for c in clients):
        raise RuntimeError("a client did not stop after the window")
    if engine.error is not None:
        out.engine_error = repr(engine.error)
    if traced:
        out.trace = Trace.read(prof)
    return out


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


def sample_for_check(records, seed: int, tokens: int) -> List[stats.Record]:
    """Greedy requests that finished: the longest, the longest with an
    image, then others in an order drawn from the seed, until `tokens`
    served tokens are in."""
    done = [r for r in records if r.finished and r.greedy]
    if not done:
        return []

    def longest(rs):
        return max(rs, key=lambda r: (len(r.tokens), r.prompt, -r.index))
    out = [longest(done)]
    images = [r for r in done if r.image and r is not out[0]]
    if images and not out[0].image:
        out.append(longest(images))
    rest = [r for r in done if all(r is not o for o in out)]
    order = np.random.default_rng([int(seed) % (2 ** 63), 2]).permutation(
        len(rest))
    n = sum(len(r.tokens) for r in out)
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


class ImageRows:
    """The projector rows of every image the program encodes while
    `active`, as the program made them (on the device, in its dtype), each
    beside a fingerprint of its pixels; `rows_for(pixels)` finds an
    image's. The output check splices these rows into the reference's
    decoder: the tower at random weights carries rounding far apart (see
    `output_check`), so the decoder follows the program's own image rows,
    and the tower and projector are checked by themselves."""

    def __init__(self, model):
        self.items = []
        self.active = False
        encode = model.encode_images

        def recorded(pixel_values, **kw):
            out = encode(pixel_values, **kw)
            if self.active:
                self.items.append((_fingerprint(pixel_values),
                                   out[0].detach()))
            return out
        model.encode_images = recorded

    def rows_for(self, pixels: np.ndarray):
        want = _fingerprint(torch.as_tensor(pixels, dtype=torch.float32))
        for fp, rows in self.items:
            hit = (fp.cpu() == want).all(dim=-1).nonzero()
            if len(hit):
                return rows[int(hit[0, 0])]
        raise KeyError("no image rows recorded for a sampled request")


def _fingerprint(px: torch.Tensor) -> torch.Tensor:
    """A few pixel values of each image of a batch [N, H, W, C]."""
    return px[:, :2, :2, :].reshape(px.shape[0], -1).float().clone()


# the controls: the reference in the program's place, one step below a
# precision the configuration states: its int8 cache as int4 (the
# decoder's number), its bf16 activations as float8 at every projection's
# input (the tower's and projector's number); and a witness of the
# configured arithmetic (bf16 at every projection's input)
CONTROLS = {"kv4": {"kv_bits": 4}, "fp8": {"act": "fp8"},
            "bf16": {"act": "bf16"}}
# images the tower's number compares at least, where the window has them
TOWER_IMAGES = 8


def output_check(cfg: dict, plan, seed: int, sample, device, image_rows,
                 records=(), controls=()) -> dict:
    """What the output check compares, from the float32 reference:

    - `gaps`: each sampled request's `token_gaps`, its prompt's image
      spliced from the program's own projector rows;
    - `image_errors`: `row_errors` [images, patches] of the program's
      projector rows against the reference's own tower and projector, for
      the sampled image requests and further finished image requests, up
      to TOWER_IMAGES images;
    and for each control named in `controls` (see CONTROLS) the same two
    for the tokens and the rows the control puts in the program's place."""
    from reference.llava import Reference, row_errors, token_gaps

    def request(r):
        return plan.request(r.client, (r.index - r.client) // plan.clients)

    seqs = []
    for r in sample:
        req = request(r)
        seqs.append({"ids": req.ids, "pixels": req.pixels,
                     "tokens": r.tokens,
                     "image_rows": (None if req.pixels is None
                                    else image_rows.rows_for(req.pixels))})
    imaged = [r for r in sample if r.image]
    imaged += [r for r in records if r.image and r.finished
               and r not in imaged][:max(0, TOWER_IMAGES - len(imaged))]
    pixels = [request(r).pixels for r in imaged]
    got_rows = [image_rows.rows_for(p) for p in pixels]
    px = (torch.as_tensor(np.concatenate(pixels), device=device)
          if pixels else None)
    hf = cfg["hf_config"]

    def run(ref):
        return (ref.served_logits(seqs),
                ref.image_features(px) if px is not None else None)

    want, want_rows = run(Reference(hf, seed, device))
    out = {"gaps": [token_gaps(w, s["tokens"]) for w, s in zip(want, seqs)],
           "image_errors": (row_errors(torch.stack(got_rows).to(device),
                                       want_rows)
                            if got_rows else None), "controls": {}}
    for name in controls:
        logits, rows = run(Reference(hf, seed, device, **CONTROLS[name]))
        out["controls"][name] = {
            "gaps": [token_gaps(w, g.argmax(dim=-1).tolist())
                     for w, g in zip(want, logits)],
            "image_errors": (row_errors(rows, want_rows)
                             if rows is not None else None)}
    return out


def numbers(check: dict) -> dict:
    """The two compared numbers of an `output_check` (or a control's part
    of it): the widest token gap, and the worst image's median row error
    (each image's median over its patches, the largest over the
    images)."""
    gaps = check["gaps"]
    errs = check["image_errors"]
    return {"widest_gap": (max(float(g.max()) for g in gaps) if gaps
                           else float("inf")),
            "worst_image_median_err": (
                float(errs.float().median(dim=-1).values.max())
                if errs is not None else None)}


def run(bm: dict, cell: dict, seed: int, seconds: float, trace: bool,
        device="cuda", cfg: Optional[dict] = None,
        params: Optional[dict] = None, t_start: Optional[float] = None,
        controls=()) -> dict:
    """One run of a serving cell; returns the pieces of the result line
    (see main.py), with the output check's whole reading (`check`, and
    the requests it sampled, `sample`). `controls` (names of CONTROLS)
    are read beside the program in the same check."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg = cfg or spec.config(bm, cell["config"])
    params = params or spec.traffic(cell["traffic"])
    kind = spec.traffic_kind(params["kind"])
    plan = kind.Plan(params, seed, cfg["hf_config"]["vocab_size"])
    model = build_model(cfg, seed, device)
    log(t_start, "model built")
    logs = None
    if trace:
        logs = (ForwardLog(model.language_model, decoder_rows),
                ForwardLog(model.vision_tower, tower_rows))
    rows = ImageRows(model)
    engine = make_engine(model, cfg)
    warm_info = warm(engine, plan, cfg)
    rows.active = True
    log(t_start, f"warmed: {len(warm_info['programs'])} warmup paths, "
        f"bursts {warm_info['bursts']}")
    served = serve(engine, plan, seconds, trace, logs)
    rows.active = False
    log(t_start, "window closed")
    setup_s = served.w0 - t_start
    mem = (torch.cuda.max_memory_allocated()
           if torch.device(device).type == "cuda" else 0)
    n_slots = engine.n_slots
    del engine, model, logs
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    window = stats.window_metrics(served.records, served.w0, served.w1)
    for r in [r for r in served.records if r.failed][:3]:
        log(t_start, f"request {r.index} failed: {r.error}")
    sample = sample_for_check(served.records, seed, params["check_tokens"])
    limits = cfg["check"]
    check = (output_check(cfg, plan, seed, sample, device, rows,
                          served.records, controls) if sample else None)
    got = (numbers(check) if check is not None
           else {"widest_gap": float("inf"), "worst_image_median_err": None})
    log(t_start, f"reference checked {len(sample)} requests")
    images = any(s.image for s in plan.shapes)
    checks = {"widest_gap": {"value": got["widest_gap"],
                             "limit": limits["widest_gap"]}}
    if images:
        checks["worst_image_median_err"] = {
            "value": got["worst_image_median_err"],
            "limit": limits["worst_image_median_err"]}
    checks.update(
        sampled_tokens={"value": sum(len(r.tokens) for r in sample),
                        "limit": params["check_tokens"]},
        failed_requests={"value": window["failed"], "limit": 0},
        engine_errors={"value": int(served.engine_error is not None),
                       "limit": 0})
    rows_err = got["worst_image_median_err"]
    correct = (got["widest_gap"] <= limits["widest_gap"]
               and (not images or (rows_err is not None and rows_err
                                   <= limits["worst_image_median_err"]))
               and window["failed"] == 0 and served.engine_error is None
               and checks["sampled_tokens"]["value"]
               >= params["check_tokens"])
    from reference.weights import Geometry
    return dict(correct=correct, window=window, setup_s=setup_s,
                geometry=Geometry.from_hf(cfg["hf_config"]),
                memory_peak_bytes=mem, served=served, checks=checks,
                n_slots=n_slots, plan=plan, cfg=cfg, warm=warm_info,
                check=check, sample=sample)
