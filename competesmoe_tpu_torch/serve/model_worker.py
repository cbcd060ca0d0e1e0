"""Model worker: serves streaming generation from a PyTorch LLaVA model
(port of the solo path of competesmoe_tpu/serve/model_worker.py).

Stdlib HTTP: semaphore-limited streaming `/worker_generate_stream` (JSON
chunks terminated by \\0, FastChat protocol), `/worker_get_status`,
optional controller registration with a heartbeat thread. Requests stream
through `stream_generate` one at a time, or, with `--engine-slots`, share
the batched steps of a `DecodeEngine` (prefix cache, chunked prefill,
adaptive speculation and warmup by flag). Tensor- and expert-parallel
serving wait for ROADMAP §1 item 1.7.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, List, Optional
from urllib import request as urlrequest

import numpy as np

from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..multimodal.mm_utils import load_image_from_base64, process_images


class ModelWorker:
    def __init__(self, controller_addr: Optional[str], worker_addr: str,
                 model_names: List[str], generate_fn,
                 limit_model_concurrency: int = 5,
                 register: bool = True, extra_status_fn=None):
        """generate_fn(params: dict) -> iterator of partial text strings.
        extra_status_fn() -> dict is merged into /worker_get_status (the
        DecodeEngine's slot and throughput telemetry)."""
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:6]
        self.model_names = model_names
        self.generate_fn = generate_fn
        self.extra_status_fn = extra_status_fn
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self._queue_lock = threading.Lock()
        self.queue_length = 0
        self._hb_thread = None
        if register and controller_addr:
            self.register_to_controller()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True)
            self._hb_thread.start()

    def get_status(self) -> dict:
        status = {"model_names": self.model_names, "speed": 1,
                  "queue_length": self.queue_length}
        if self.extra_status_fn is not None:
            status.update(self.extra_status_fn())
        return status

    def register_to_controller(self) -> None:
        data = {"worker_name": self.worker_addr, "check_heart_beat": True,
                "worker_status": self.get_status()}
        req = urlrequest.Request(
            self.controller_addr + "/register_worker",
            data=json.dumps(data).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req, timeout=10) as r:
            if r.status != 200:
                raise RuntimeError(f"controller registration failed: "
                                   f"HTTP {r.status}")

    def _heartbeat_loop(self) -> None:
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                data = {"worker_name": self.worker_addr,
                        "queue_length": self.queue_length}
                req = urlrequest.Request(
                    self.controller_addr + "/receive_heart_beat",
                    data=json.dumps(data).encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                with urlrequest.urlopen(req, timeout=5) as r:
                    if not json.loads(r.read()).get("exist", False):
                        self.register_to_controller()
            except OSError:
                # controller unreachable: keep beating, it may come back
                pass

    def _add_queue(self, n: int) -> None:
        with self._queue_lock:
            self.queue_length += n

    def generate_stream(self, params: dict) -> Iterator[bytes]:
        self._add_queue(1)
        acquired = self.semaphore.acquire(timeout=60)
        try:
            if not acquired:
                yield json.dumps({"text": "server overloaded",
                                  "error_code": 1}).encode() + b"\0"
                return
            for text in self.generate_fn(params):
                yield json.dumps({"text": text,
                                  "error_code": 0}).encode() + b"\0"
        except Exception as e:  # noqa: BLE001 — report errors to client
            yield json.dumps({"text": f"error: {e}",
                              "error_code": 1}).encode() + b"\0"
        finally:
            if acquired:
                self.semaphore.release()
            self._add_queue(-1)


def _stop_list(stop) -> list:
    """Normalize params['stop'] to a list of strings."""
    if not stop:
        return []
    if isinstance(stop, str):
        return [stop]
    return [s for s in stop if s]


def _cut_at_stops(text: str, stops: list):
    """Truncate at the EARLIEST stop occurrence; (text, hit)."""
    hit = False
    for s in stops:
        i = text.find(s)
        if i >= 0:
            text = text[:i]
            hit = True
    return text, hit


def torch_llava_generate_fn(adapter,
                            default_speculative: Optional[int] = None):
    """A worker generate_fn over an eval.TorchLlava adapter: prompt and
    optional base64 images in, incremental text out. Tokens stream as
    `stream_generate` produces them; a client that disconnects abandons
    the generator, which cancels the remaining decode steps. A request's
    `speculative` (else `default_speculative`, else the adapter's)
    verifies that many prompt-lookup drafts per forward."""
    from ..models.llava import stream_generate

    if default_speculative is None:
        default_speculative = adapter.speculative

    def fn(params: dict) -> Iterator[str]:
        prompt = params["prompt"]
        images = params.get("images") or []
        max_new = int(params.get("max_new_tokens", 128))
        temperature = float(params.get("temperature", 0.0))
        top_p = float(params.get("top_p", 1.0))
        spec = int(params.get("speculative", default_speculative))
        stops = _stop_list(params.get("stop"))
        ids = adapter.tokenizer_ids_for_prompt(prompt, bool(images))
        px = None
        if images:
            pil = [load_image_from_base64(b) for b in images]
            px = process_images(pil, adapter.image_processor)
        arr = np.asarray([ids], np.int32)
        tokens: list = []
        for chunk in stream_generate(
                adapter.model, arr, px, max_new_tokens=max_new,
                temperature=temperature, top_p=top_p,
                eos_token_id=getattr(adapter.tokenizer, "eos_token_id",
                                     None),
                stop_token_ids=adapter.stop_token_ids, speculative=spec):
            tokens.extend(int(t) for t in chunk[0])
            text = adapter.tokenizer.decode(tokens,
                                            skip_special_tokens=True)
            text = text.split("<|end|>")[0]
            text, hit = _cut_at_stops(text, stops)
            yield text
            if hit:
                return
    return fn


def engine_generate_fn(adapter, engine):
    """A worker generate_fn backed by the continuous-batching DecodeEngine
    (serve/engine.py): concurrent requests share one batched decode step;
    temperature and top_p ride per slot on the engine's sampler."""

    def fn(params: dict) -> Iterator[str]:
        prompt = params["prompt"]
        images = params.get("images") or []
        ids = adapter.tokenizer_ids_for_prompt(prompt, bool(images))
        px = None
        if images:
            pil = [load_image_from_base64(b) for b in images]
            px = np.asarray(process_images(pil, adapter.image_processor))
        eos = set(adapter.stop_token_ids or [])
        if getattr(adapter.tokenizer, "eos_token_id", None) is not None:
            eos.add(int(adapter.tokenizer.eos_token_id))
        stops = _stop_list(params.get("stop"))
        tokens: list = []
        for tok in engine.submit(
                np.asarray(ids, np.int32), pixel_values=px,
                max_new_tokens=int(params.get("max_new_tokens", 128)),
                temperature=float(params.get("temperature", 0.0)),
                top_p=float(params.get("top_p", 1.0)),
                eos_ids=sorted(eos)):
            tokens.append(tok)
            text = adapter.tokenizer.decode(tokens,
                                            skip_special_tokens=True)
            text = text.split("<|end|>")[0]
            text, hit = _cut_at_stops(text, stops)
            yield text
            if hit:
                return
    return fn


def make_engine(model, engine_slots: int, engine_max_len: int = 2048,
                speculative: int = 0, engine_pipeline: int = 2,
                prefix_cache: int = 0, prefill_chunk: int = 0,
                spec_adaptive: bool = False):
    """The DecodeEngine the worker's --engine-slots builds: spec_k =
    --speculative (pipeline depth --engine-pipeline, forced to 1 under
    speculation: drafts need the freshest emitted history),
    --engine-prefix-cache parked rows, --engine-prefill-chunk and
    --spec-adaptive."""
    from .engine import DecodeEngine
    return DecodeEngine(model, n_slots=engine_slots, max_len=engine_max_len,
                        prefix_cache_slots=prefix_cache, spec_k=speculative,
                        spec_adaptive=spec_adaptive,
                        pipeline_depth=1 if speculative else engine_pipeline,
                        prefill_chunk=prefill_chunk)


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/worker_get_status":
                self._json(200, worker.get_status())
            elif self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream(data):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

    return Handler


def serve_worker(worker: ModelWorker, host: str = "0.0.0.0",
                 port: int = 21002, background: bool = False):
    """Serve the worker over HTTP. background=True returns the running
    server (stop it with .shutdown() and .server_close())."""
    httpd = ThreadingHTTPServer((host, port), make_handler(worker))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    httpd.serve_forever()


# what a checkpoint directory holds beside config.json: weight shards and
# the index files of sharded checkpoints
_WEIGHT_PATTERNS = ("*.safetensors", "*.bin", "*.pt",
                    "*.safetensors.index.json", "*.bin.index.json")


def weight_files(model_path) -> List[str]:
    """Names of the weight files (or shard index files) in a
    --model-path directory, sorted; empty for a geometry-only directory."""
    from pathlib import Path
    root = Path(model_path)
    return sorted({f.name for pat in _WEIGHT_PATTERNS
                   for f in root.glob(pat)})


def add_model_args(ap) -> None:
    """The flags that choose and load the served model (the worker's and
    the chat CLI's)."""
    ap.add_argument("--model-path", default=None,
                    help="checkpoint directory in the released layout "
                         "(config.json and *.safetensors or *.bin "
                         "weights), loaded; a directory with only "
                         "config.json serves its geometry with random "
                         "weights from --seed; default: CompeteSMoE-5.1B's "
                         "geometry with random weights")
    ap.add_argument("--model-name", default=None,
                    help="the name the worker serves under; default: the "
                         "checkpoint directory's name, else "
                         "competesmoe-5.1b")
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer directory (needs `transformers`); "
                         "default: the tokenizer found in --model-path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--load-8bit", action="store_true",
                    help="int8 decoder (lm_head included), tower and "
                         "projector int8 value-quantized")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--kv-quant", default="", choices=["", "int8"])


def load_model(a):
    """(model, tokenizer, model name) from the flags of `add_model_args`:
    the checkpoint of --model-path loaded on --device
    (`load_pretrained_model`: --load-8bit / --load-4bit / --kv-quant), or,
    for a directory with only config.json or no --model-path at all, that
    geometry (default: CompeteSMoE-5.1B's) with random weights from
    --seed."""
    import dataclasses
    from pathlib import Path

    import torch

    from ..models.builder import (HF_5P1B, apply_load_4bit, apply_load_8bit,
                                  build_llava, llava_config_from_hf,
                                  load_pretrained_model)

    if a.load_8bit and a.load_4bit:
        raise SystemExit("--load-8bit and --load-4bit exclude each other")
    weights = weight_files(a.model_path) if a.model_path else []
    if not (a.tokenizer or weights):
        raise SystemExit("--tokenizer is needed unless --model-path holds "
                         "a checkpoint to take the tokenizer from")
    model_name = a.model_name or (Path(a.model_path).name if weights
                                  else "competesmoe-5.1b")
    tokenizer = None
    if weights:
        tokenizer, model, _, _ = load_pretrained_model(
            a.model_path, load_8bit=a.load_8bit,
            load_4bit=a.load_4bit, kv_quant=a.kv_quant or None,
            dtype=torch.bfloat16, device=a.device)
    else:
        hf_cfg = (json.loads((Path(a.model_path) / "config.json")
                             .read_text()) if a.model_path else HF_5P1B)
        cfg = llava_config_from_hf(hf_cfg, model_name, torch.bfloat16)
        if a.kv_quant:
            cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, kv_quant=a.kv_quant))
        model = build_llava(cfg, seed=a.seed, device=a.device)
        if a.load_8bit:
            apply_load_8bit(model)
        elif a.load_4bit:
            apply_load_4bit(model)
    if tokenizer is None or a.tokenizer:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(a.tokenizer or a.model_path)
    return model, tokenizer, model_name


def main(argv=None):
    """Worker launch CLI: load the model (`load_model`); optionally
    register with a controller; serve."""
    import argparse

    from ..eval.llava_adapter import TorchLlava

    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--controller-address",
                    default="http://localhost:21001")
    ap.add_argument("--worker-address", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--conv-template", default="phi35")
    ap.add_argument("--limit-model-concurrency", type=int, default=5)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--engine-slots", type=int, default=0,
                    help="serve through the continuous-batching "
                         "DecodeEngine with this many sequence slots; "
                         "0 = one stream_generate per request")
    ap.add_argument("--engine-max-len", type=int, default=2048)
    ap.add_argument("--engine-prefill-chunk", type=int, default=0,
                    help="chunked prefill: long text prompts prefill N "
                         "tokens per engine tick (decode steps for the "
                         "live slots run between chunks) instead of "
                         "stalling every stream for the whole prefill")
    ap.add_argument("--engine-prefix-cache", type=int, default=0,
                    help="park this many retired conversation rows for "
                         "prefix reuse (multi-turn TTFT; costs N extra "
                         "cache rows of device memory)")
    ap.add_argument("--speculative", type=int, default=0,
                    help="prompt-lookup speculative decoding: verify K "
                         "drafts per forward (solo path and engine)")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="with --engine-slots and --speculative: measure "
                         "the realized tokens/s of verify ticks and of "
                         "plain ticks, run the faster and probe the other "
                         "now and then (default: always speculate)")
    ap.add_argument("--engine-pipeline", type=int, default=2,
                    help="with --engine-slots: issue tick N+1 before "
                         "reading tick N's tokens; forced to 1 under "
                         "--speculative")
    ap.add_argument("--engine-warmup", default="",
                    help="comma-separated prompt-length buckets (e.g. "
                         "'64,512,1024') to drive through every engine "
                         "path before serving (DecodeEngine.warmup): "
                         "kernel builds, cuBLAS handles and allocator "
                         "blocks then come before the first request")
    for flag in ("--mesh", "--ep-shards"):
        ap.add_argument(flag, default="", help="not ported yet")
    ap.add_argument("--no-register", action="store_true")
    a = ap.parse_args(argv)
    refused = [f for f in ("--mesh", "--ep-shards")
               if getattr(a, f[2:].replace("-", "_")) not in ("", "0")]
    if refused:
        raise SystemExit(f"{', '.join(refused)}: not ported (ROADMAP §1 "
                         "item 1.7: parallelism)")
    model, tokenizer, model_name = load_model(a)
    adapter = TorchLlava(model, tokenizer, conv_template=a.conv_template,
                         max_new_tokens=a.max_new_tokens,
                         speculative=a.speculative)
    if a.engine_slots > 0:
        engine = make_engine(model, a.engine_slots, a.engine_max_len,
                             a.speculative, a.engine_pipeline,
                             prefix_cache=a.engine_prefix_cache,
                             prefill_chunk=a.engine_prefill_chunk,
                             spec_adaptive=a.spec_adaptive)
        if a.engine_warmup:
            buckets = [int(x) for x in a.engine_warmup.split(",") if x]
            w = engine.warmup(prompt_buckets=buckets)
            print(f"engine warmup: {len(w['programs'])} programs in "
                  f"{w['seconds']} s", flush=True)
            if w["captured"]:
                print(f"engine programs captured: {w['captured']}",
                      flush=True)
        gen_fn = engine_generate_fn(adapter, engine)
        concurrency = max(a.limit_model_concurrency, a.engine_slots)
        extra_status = engine.stats
    else:
        gen_fn = torch_llava_generate_fn(adapter)
        concurrency = a.limit_model_concurrency
        extra_status = None
    worker = ModelWorker(
        None if a.no_register else a.controller_address,
        a.worker_address or f"http://localhost:{a.port}", [model_name],
        gen_fn, limit_model_concurrency=concurrency,
        extra_status_fn=extra_status)
    print(f"worker {worker.worker_id} serving {model_name} on "
          f"{a.host}:{a.port}", flush=True)
    serve_worker(worker, a.host, a.port)


if __name__ == "__main__":
    main()
