#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (competesmoe_tpu_torch).

    python3 chip_smoke.py [--seed 0] [--profile]

Needs one CUDA GPU; exits non-zero on any failure. Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of the serving path from csrc/ (nvcc);
  3. kernel: the packed-int4 decode matmul (K5) at the four decode
     projection shapes of the 5.1B decoder, M in {1, 8}, against its plain
     PyTorch version (tolerance: one bf16 ulp at the largest output,
     2^-7 * max|ref|), timed on the device (a CUDA graph of launches that
     rotate through 256 MB of weight copies, so every launch reads its
     weights from device memory as decode does; median of 60 replays),
     beside its bytes-over-bandwidth bound at 3.35 TB/s;
  4. model: CompeteSMoE-5.1B (SigLIP-so400m MoE tower, MoE projector,
     Phi-3.5-mini decoder) with random weights from --seed, quantized
     with the worker's --load-4bit (int4 decoder, int8 lm_head, NF4 tower)
     and an int8 KV cache; a small model of the same kind is first held
     against the same weights on the CPU. One image+text prompt, 32
     greedy tokens through stream_generate; the kernel's launch count
     must be 4 projections x 32 layers per decode step;
  5. server: the model worker over HTTP on 127.0.0.1 answers three text
     prompts;
  6. with --profile: torch.profiler over decode steps of the served
     model (device busy share and the kernels that take the time).
The last lines are the kernels JSON, the card line and the result JSON.
"""

import argparse
import dataclasses
import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path
from urllib import request as urlrequest

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
DECODE_SHAPES = (("qkv_proj", 3072, 9216), ("o_proj", 3072, 3072),
                 ("gate_up_proj", 3072, 16384), ("down_proj", 8192, 3072))
KERNEL_SOURCE = "competesmoe_tpu_torch/csrc/matvec_int4.cu"
KERNEL_REPLACES = "competesmoe_tpu/ops/matvec.py:144"


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def time_launches(fn, args_list, reps: int) -> float:
    """Device ms per call: the calls fn(*args) for every args in args_list
    are captured into one CUDA graph (so host launch overhead is out of
    the measurement), the graph is replayed `reps` times between CUDA
    events, and the median replay time is divided by len(args_list)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up outside capture
        for args in args_list[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in args_list:
            fn(*args)
    graph.replay()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) \
        / len(args_list)


def phase_kernel(reps: int = 60):
    import torch

    from competesmoe_tpu_torch.models.decoder import pack_int4
    from competesmoe_tpu_torch.ops.matvec import (
        quant_small_m_matmul_int4, quant_small_m_matmul_int4_reference)

    g = torch.Generator(device="cuda").manual_seed(1234)
    rows, max_err = [], 0.0

    def check(m, k, n, label, timed):
        nonlocal max_err
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        q = torch.randint(-8, 8, (k, n), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        w = pack_int4(q)
        scale = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-3
        got = quant_small_m_matmul_int4(x, w, scale)
        want = quant_small_m_matmul_int4_reference(x, w, scale)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * float(want.float().abs().max())
        if not (got.shape == want.shape and err <= tol
                and torch.isfinite(got.float()).all()):
            raise AssertionError(f"K5 {label} M={m}: max_abs_err {err} > "
                                 f"tol {tol}")
        max_err = max(max_err, err)
        if not timed:
            return
        wbytes = w.numel()
        copies = [w] + [w.clone() for _ in range(
            max(0, -(-256 * 2 ** 20 // wbytes) - 1))]
        ms = time_launches(quant_small_m_matmul_int4,
                           [(x, c, scale) for c in copies], reps)
        plain_ms = time_launches(quant_small_m_matmul_int4_reference,
                                 [(x, c, scale) for c in copies], reps)
        nbytes = m * k * 2 + wbytes + n * 4 + m * n * 2
        ops = 2 * m * k * n
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= ops / BF16_OPS_PER_S else "operations")
        rows.append(dict(proj=label, m=m, k=k, n=n, bytes=nbytes,
                         max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         roofline_share=bound_ms / ms))
        log(f"K5 {label:13s} M={m:<3d} [{k}x{n}] err {err:.3g} (tol "
            f"{tol:.3g})  kernel {ms * 1e3:.2f} us  plain "
            f"{plain_ms * 1e3:.2f} us  bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})  {bound_ms / ms:.1%} of bound")
        del copies

    for label, k, n in DECODE_SHAPES:
        for m in (1, 8):
            check(m, k, n, label, timed=True)
    for m in (3, 40, 128):     # the other row groupings of the kernel
        check(m, 3072, 3072, "o_proj", timed=False)
    return rows, max_err


class WordTok:
    """Word-level stand-in tokenizer (no tokenizer package is needed):
    ids are assigned to words on first sight, starting at 3."""

    bos_token_id = None
    eos_token_id = 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.vocab, self.inv = {}, {}

    def __call__(self, text):
        ids = []
        for w in text.split():
            if w not in self.vocab:
                i = 3 + len(self.vocab) % (self.vocab_size - 3)
                self.vocab[w] = i
                self.inv[i] = w
            ids.append(self.vocab[w])
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.inv.get(int(i), f"<{int(i)}>") for i in ids
                        if not (skip_special_tokens and int(i) < 3))


def small_model_check(seed: int):
    """A small model of the served kind (int4 decoder whose projections
    tile the kernel, int8 KV) on the card against the same weights on the
    CPU: the card runs K5 at every decode projection, the CPU the plain
    halves contraction. Decode logits must agree within 3% of their
    largest magnitude (bf16 activations, the scale applied before vs
    after the f32 sum)."""
    import torch

    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, apply_load_4bit, build_llava, llava_config_from_hf)
    from competesmoe_tpu_torch.models.decoder import KVCache
    from competesmoe_tpu_torch.models.llava import LlavaModel
    from competesmoe_tpu_torch.ops.matvec import quant_small_m_matmul_int4

    small = dict(HF_5P1B, vocab_size=512, hidden_size=256,
                 intermediate_size=512, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4,
                 mm_hidden_size=64,
                 vision_config=dict(hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=2,
                                    num_attention_heads=2, image_size=28,
                                    patch_size=14))
    cfg = llava_config_from_hf(small, "llava_phi", torch.bfloat16)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, kv_quant="int8"))
    cpu = apply_load_4bit(build_llava(cfg, seed=seed, device="cpu"))
    gpu = LlavaModel(cpu.cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, (1, 12))
    ids[0, 3] = -200
    px = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)
    logits, fed = {}, None
    launches0 = quant_small_m_matmul_int4.launches
    with torch.no_grad():
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            dev = torch.device(name)
            cache = KVCache.create(model.language_model.cfg, 1, 64, dev)
            out = model(torch.as_tensor(ids, device=dev),
                        torch.as_tensor(px, device=dev), cache=cache)
            rows, feed = [out.logits[:, -1].float().cpu()], []
            for i in range(4):   # the card's greedy tokens feed both
                t = rows[-1].argmax(-1) if fed is None else fed[i]
                feed.append(t)
                out = model(t.to(dev)[:, None], None, cache=out.cache)
                rows.append(out.logits[:, -1].float().cpu())
            fed = feed
            logits[name] = torch.stack(rows)
    kernel_launches = quant_small_m_matmul_int4.launches - launches0
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    tol = 0.03 * float(logits["cpu"].abs().max())
    log(f"small model (card vs CPU, 5 logit rows): max_abs_err {err:.4g} "
        f"tol {tol:.4g}; K5 launches on the card {kernel_launches}")
    if not (torch.isfinite(logits["cuda"]).all() and err <= tol):
        raise AssertionError(f"small model disagrees: {err} > {tol}")
    # prefill (15 rows) and each of the 4 decode steps: 4 projections x 2
    if kernel_launches != 4 * 2 * 5:
        raise AssertionError(f"small model: expected 40 K5 launches, got "
                             f"{kernel_launches}")


def phase_model(seed: int, new_tokens: int = 32):
    import torch

    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, apply_load_4bit, build_llava, llava_config_from_hf)
    from competesmoe_tpu_torch.models.llava import stream_generate
    from competesmoe_tpu_torch.ops.matvec import quant_small_m_matmul_int4

    cfg = llava_config_from_hf(HF_5P1B, "llava_phi", torch.bfloat16)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, kv_quant="int8"))
    t0 = time.perf_counter()
    model = apply_load_4bit(build_llava(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.state_dict().values())
    log(f"model: {n_params / 1e9:.3f}B stored values built and quantized "
        f"in {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")

    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.decoder.vocab_size, (1, 48)).astype(np.int32)
    ids[0, 8] = -200
    px = rng.uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32)

    def run(n):
        t_start = time.perf_counter()
        chunks, t_first = [], None
        for c in stream_generate(model, ids, px, max_new_tokens=n,
                                 temperature=0.0):
            if t_first is None:
                t_first = time.perf_counter()
            chunks.append(c)
        t_end = time.perf_counter()
        return np.concatenate(chunks, axis=1), t_first - t_start, \
            t_end - t_first

    run(4)                                   # warm-up: lazy inits
    quant_small_m_matmul_int4.launches = 0   # main path starts here
    toks, ttft, rest = run(new_tokens)
    launches = quant_small_m_matmul_int4.launches
    steps = toks.shape[1] - 1
    L = cfg.decoder.num_hidden_layers
    if toks.shape != (1, new_tokens) or toks.min() < 0 or \
            toks.max() >= cfg.decoder.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} {toks}")
    if launches != 4 * L * steps:
        raise AssertionError(f"K5 launches {launches} != 4 x {L} layers x "
                             f"{steps} decode steps")
    tok_s = steps / rest
    log(f"generate: {new_tokens} greedy tokens, TTFT {ttft * 1e3:.1f} ms, "
        f"decode {tok_s:.2f} tok/s ({rest / steps * 1e3:.2f} ms/token), K5 "
        f"launches {launches} = {launches // steps} per decode step")
    log(f"tokens: {toks[0].tolist()}")
    return model, launches, dict(ttft_ms=ttft * 1e3, decode_tok_s=tok_s,
                                 ms_per_token=rest / steps * 1e3,
                                 decode_steps=steps, layers=L)


def profile_decode(model, seed: int, steps: int = 8):
    """torch.profiler over `steps` decode steps of the served model: host
    wall time per step, device kernel time per step (so the device's busy
    share) and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from competesmoe_tpu_torch.models.decoder import KVCache

    rng = np.random.default_rng(seed)
    vocab = model.cfg.decoder.vocab_size
    ids = torch.as_tensor(rng.integers(3, vocab, (1, 32)), device="cuda")
    cache = KVCache.create(model.language_model.cfg, 1, 128, "cuda")
    with torch.no_grad():
        out = model(ids, None, cache=cache)
        tok = out.logits[:, -1].argmax(-1)
        for _ in range(2):                     # warm-up steps
            out = model(tok[:, None], None, cache=out.cache)
            tok = out.logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                out = model(tok[:, None], None, cache=out.cache)
                tok = out.logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((dev_us, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    log(f"profile: {steps} decode steps, wall {wall_ms:.2f} ms/step, "
        f"device kernels {busy_ms:.3f} ms/step, busy share "
        f"{busy_ms / wall_ms:.1%}")
    for dev_us, count, name in kernels[:10]:
        log(f"  {dev_us / 1e3 / steps:8.3f} ms/step  {count // steps:5d} "
            f"launches/step  {name[:90]}")
    return dict(wall_ms_per_step=wall_ms, device_ms_per_step=busy_ms,
                busy_share=busy_ms / wall_ms,
                top=[dict(ms_per_step=d / 1e3 / steps,
                          launches_per_step=c // steps, kernel=n[:120])
                     for d, c, n in kernels[:10]])


def phase_server(model):
    from competesmoe_tpu_torch.eval.llava_adapter import TorchLlava
    from competesmoe_tpu_torch.ops.matvec import quant_small_m_matmul_int4
    from competesmoe_tpu_torch.serve.model_worker import (
        ModelWorker, serve_worker, torch_llava_generate_fn)

    adapter = TorchLlava(model, WordTok(model.cfg.decoder.vocab_size),
                         max_new_tokens=16)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worker = ModelWorker(None, f"http://127.0.0.1:{port}", ["smoke"],
                         torch_llava_generate_fn(adapter), register=False)
    httpd = serve_worker(worker, "127.0.0.1", port, background=True)
    launches0 = quant_small_m_matmul_int4.launches
    try:
        for prompt in ("what color is the cat", "describe the image please",
                       "hello there how are you"):
            req = urlrequest.Request(
                f"http://127.0.0.1:{port}/worker_generate_stream",
                data=json.dumps({"prompt": prompt,
                                 "max_new_tokens": 16}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urlrequest.urlopen(req, timeout=300) as r:
                body = r.read()
            chunks = [json.loads(p) for p in body.split(b"\0") if p]
            if not chunks or any(c["error_code"] != 0 for c in chunks):
                raise AssertionError(f"server error for {prompt!r}: "
                                     f"{chunks[-1:]}")
            log(f"server: {prompt!r} -> {len(chunks)} chunks in "
                f"{time.perf_counter() - t0:.2f} s, last "
                f"{chunks[-1]['text'][:60]!r}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = quant_small_m_matmul_int4.launches - launches0
    log(f"server: K5 launches over the three requests {launches}")
    if launches == 0:
        raise AssertionError("the worker's requests never launched K5")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile decode steps of the served model")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from competesmoe_tpu_torch.ops import matvec

    card = card_line()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    matvec.build(verbose=True)
    log(f"build: matvec_int4.cu in {time.perf_counter() - t0:.1f} s")
    rows, max_err = phase_kernel()
    print("kernel_shapes " + json.dumps({"card": card, "rows": rows}),
          flush=True)
    small_model_check(a.seed)
    model, launches, summary = phase_model(a.seed)
    phase_server(model)
    if a.profile:
        summary["profile"] = profile_decode(model, a.seed)
    print("model_summary " + json.dumps(dict(summary, card=card)),
          flush=True)
    m1 = [r for r in rows if r["m"] == 1]
    print(json.dumps({"kernels": [{
        "name": "quant_small_m_matmul_int4", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        # one decoder layer's four decode projections at M = 1
        "ms": sum(r["ms"] for r in m1),
        "plain_ms": sum(r["plain_ms"] for r in m1),
        "bound_ms": sum(r["bound_ms"] for r in m1),
        "bound_by": "bytes", "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
