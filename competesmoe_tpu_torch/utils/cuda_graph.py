"""Decode steps captured as CUDA graphs.

JAX runs every device step of serving as one compiled program: the
engine's donated jitted step and verify step, the solo decode's jitted
scan. The port's counterpart is a CUDA graph. `capture(step)` records the
kernels of one call of `step()` once, over buffers that never move (the
KV cache, the current tokens, the per-slot sampling parameters, the
positions), and the returned `Program` replays them with one launch, so
host dispatch no longer paces the step. `step` takes no arguments: it
reads its inputs from those buffers and writes its state back into them
in place, and every call of the program returns the same output tensors,
rewritten.

How a capture runs:

- `step` runs once eagerly on a side stream first, so one-time setup
  (a kernel's first-launch `cudaFuncSetAttribute`, cuBLAS handles, the
  rotary tables) happens outside capture. The tensors in `state` and the
  generators are then put back as they were: the warm-up leaves nothing
  behind but cache writes at or past each row's position, which the
  replay writes again before anything reads them;
- the capture runs in "thread_local" mode, so host work in other threads
  (the HTTP handlers beside the engine thread) cannot invalidate it, and
  one capture at a time runs in the process;
- random draws from each generator are registered with the graph, so
  every replay draws fresh numbers and advances the generator exactly as
  the eager step would: the sampled streams equal the eager ones.

A capture that fails raises. Nothing falls back to running eagerly.

Launch accounting: each kernel wrapper counts its Python calls in
`.launches`. A capture calls each wrapper once for every launch it
records but launches nothing, so `capture` takes those counts back and
each replay adds them again: a count still counts kernels launched. Code
that watches a step's Python-side events (a forward hook that records the
shapes a run must account for) registers through `on_replay` while a
capture is under way, and its callback then runs at every replay.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

# one capture at a time in the process (PyTorch's rule for graphs)
_CAPTURE_LOCK = threading.Lock()
_ACTIVE = threading.local()


def kernel_wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of the port by name; each counts its
    `launches`."""
    from ..ops import flash_attention as fa
    from ..ops import gmm_fused, matvec
    return {"quant_small_m_matmul_int4": matvec.quant_small_m_matmul_int4,
            "small_m_matmul": matvec.small_m_matmul,
            "quant_small_m_matmul": matvec.quant_small_m_matmul,
            "gmm2_fused_aligned": gmm_fused.gmm2_fused_aligned,
            "gmm2_bwd_dx": gmm_fused.gmm2_bwd_dx,
            "gmm2_bwd_dw": gmm_fused.gmm2_bwd_dw,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq}


def copy_from_host(dst: torch.Tensor, arr) -> None:
    """Write a host array into a program's input buffer in place. On a
    card the copy goes through pinned memory and does not block: a plain
    copy would synchronise the stream, and so wait for every queued
    replay."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=dst.device.type == "cuda")


def on_replay(fn: Callable[[], None]) -> bool:
    """While this thread captures a program, run `fn` at every replay of
    that program and return True; otherwise return False, and the caller
    records its event itself."""
    callbacks = getattr(_ACTIVE, "callbacks", None)
    if callbacks is None:
        return False
    callbacks.append(fn)
    return True


def take_back_launches(run: Callable, wrappers: Sequence[Callable]):
    """Call `run()` (a capture) and return (its result, [(wrapper, the
    launches it counted during the call)]), taking those counts back off
    the wrappers: a capture records kernels and launches none."""
    before = [w.launches for w in wrappers]
    result = run()
    counted = []
    for w, b in zip(wrappers, before):
        n = w.launches - b
        if n:
            w.launches -= n
            counted.append((w, n))
    return result, counted


class Program:
    """A captured step: calling it replays the graph on the current
    stream, adds the captured launches to their wrappers' counts, runs
    the `on_replay` callbacks, and returns the step's output tensors
    (the same tensors at every call). `seconds` is the capture's host
    time and `pool_bytes` the device memory its graph pool added."""

    def __init__(self, graph, outputs, launches: List[Tuple[Callable, int]],
                 callbacks: List[Callable[[], None]], seconds: float = 0.0,
                 pool_bytes: int = 0):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.callbacks = callbacks
        self.seconds = seconds
        self.pool_bytes = pool_bytes

    def __call__(self):
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        for fn in self.callbacks:
            fn()
        return self.outputs


def capture(step: Callable[[], object], *, state: Sequence[torch.Tensor] = (),
            generators: Sequence[torch.Generator] = (), pool=None
            ) -> Program:
    """Capture `step()` as a CUDA graph (see the module docstring): warm it
    up eagerly on a side stream, restore `state` (tensors the step updates
    in place) and `generators`, then capture it on the graph pool `pool`
    (a `torch.cuda.graph_pool_handle()` that programs over the same
    buffers share, or None for a pool of its own). Raises if anything in
    the step cannot be captured."""
    gens = [g for g in generators if g is not None]
    with _CAPTURE_LOCK:
        saved = [t.clone() for t in state]
        rng = [g.get_state() for g in gens]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        for g, s in zip(gens, rng):
            g.set_state(s)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)

        def run():
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                return step()

        _ACTIVE.callbacks = callbacks = []
        try:
            outputs, launches = take_back_launches(
                run, list(kernel_wrappers().values()))
        finally:
            _ACTIVE.callbacks = None
        torch.cuda.synchronize()
        return Program(graph, outputs, launches, callbacks,
                       seconds=time.perf_counter() - t0,
                       pool_bytes=torch.cuda.memory_reserved() - reserved)
