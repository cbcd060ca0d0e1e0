"""What a traced run reads: the profiler's device records over the traced
window, and the shapes of the forwards that ran in it.

- `ForwardLog` records the host time, the leading shape and the kernel
  launches of every call of a module: each of the port's kernel wrappers
  counts its launches (`utils.cuda_graph.kernel_wrappers`), and a call's
  launches are what its wrappers counted while it ran. A call made while
  the program captures a CUDA graph is recorded at each replay of that
  graph instead, with the launches the capture counted, through the
  program's `utils.cuda_graph.on_replay`; so a log must be attached before
  the program captures (the method of `chip_smoke.ForwardRows`).
- `Trace.read(prof)` takes every device record (kernels, copies,
  sets), counted one by one from `prof.events()`, as `chip_smoke`'s
  `replay_kernels` does, and leaves out the device-side mirrors of host
  ranges, which span gaps. Busy time is the union of the records'
  intervals; idle gaps are named by the innermost host operation that was
  under way at their middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import time
from collections import defaultdict
from typing import Callable, List, Tuple


class ForwardLog:
    """(host time, shape, launches) of each call of `module`: `shape_of(args,
    kwargs)` gives the shape to record, and launches are {wrapper name:
    kernel launches the call made}, the wrappers that made none left
    out."""

    def __init__(self, module, shape_of: Callable):
        from competesmoe_tpu_torch.utils.cuda_graph import kernel_wrappers
        self.rows: List[Tuple[float, tuple, dict]] = []
        self._wrappers = kernel_wrappers()
        self._open: List[Tuple[tuple, dict]] = []
        self._handles = [
            module.register_forward_pre_hook(
                functools.partial(ForwardLog._enter, self, shape_of),
                with_kwargs=True),
            module.register_forward_hook(
                functools.partial(ForwardLog._exit, self))]

    def _counts(self) -> dict:
        return {k: w.launches for k, w in self._wrappers.items()}

    @staticmethod
    def _enter(log, shape_of, module, args, kwargs):
        log._open.append((shape_of(args, kwargs), log._counts()))

    @staticmethod
    def _exit(log, module, args, output):
        from competesmoe_tpu_torch.utils.cuda_graph import on_replay
        shape, before = log._open.pop()
        launches = {k: n - before[k] for k, n in log._counts().items()
                    if n != before[k]}

        def record():
            log.rows.append((time.perf_counter(), shape, launches))
        if not on_replay(record):
            record()

    def between(self, t0: float, t1: float) -> List[tuple]:
        """(shape, launches) of the calls recorded in [t0, t1)."""
        return [(s, n) for t, s, n in self.rows if t0 <= t < t1]


def decoder_rows(args, kwargs) -> tuple:
    """(batch, tokens) of a decoder call: ids first, or `inputs_embeds`."""
    x = args[0] if args and args[0] is not None else (
        kwargs.get("input_ids") if kwargs.get("input_ids") is not None
        else kwargs["inputs_embeds"])
    return int(x.shape[0]), int(x.shape[1])


def tower_rows(args, kwargs) -> tuple:
    """(images,) of a vision tower call."""
    x = args[0] if args else kwargs["pixel_values"]
    return (int(x.shape[0]),)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]     # (name, start us, dur us)
    device_ops: List[list]
    idle_gaps: List[list]

    @classmethod
    def read(cls, prof) -> "Trace":
        """The trace of a finished profile; its window runs from the
        first record's start to the last one's end, host and device."""
        import torch
        dev, host = [], []
        for ev in prof.events():
            if getattr(ev, "is_user_annotation", False):
                continue
            tr = ev.time_range
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if tr.end > tr.start:
                    dev.append((ev.name, float(tr.start), float(tr.end)))
            elif tr.end > tr.start:
                host.append((float(tr.start), float(tr.end), ev.name))
        dev.sort(key=lambda r: r[1])
        busy, spans = 0.0, []
        for _, s, e in dev:
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        busy = sum(e - s for s, e in spans) / 1e6
        by_name = defaultdict(float)
        for name, s, e in dev:
            by_name[name] += (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1],
                        spans[i + 1][0]) for i in range(len(spans) - 1)),
                      reverse=True)[:10]
        host.sort()
        starts = [h[0] for h in host]
        named = []
        for g, s, e in gaps:
            mid = (s + e) / 2
            cover = [h for h in host[:bisect.bisect_right(starts, mid)]
                     if h[1] >= mid]
            what = (min(cover, key=lambda h: h[1] - h[0])[2] if cover
                    else "no host operation")
            named.append([f"during {what}", g / 1e6])
        ends = [e for _, _, e in dev] + [h[1] for h in host]
        starts_all = [s for _, s, _ in dev] + starts
        window_s = ((max(ends) - min(starts_all)) / 1e6 if ends else 0.0)
        return cls(window_s=window_s, busy_s=busy,
                   kernels=[(n, s, e - s) for n, s, e in dev],
                   device_ops=[[n, t] for n, t in top], idle_gaps=named)

    def kernel_time(self, fragments) -> Tuple[int, float]:
        """(records, seconds) of kernels whose names hold a fragment."""
        hits = [d for n, _, d in self.kernels
                if any(f in n for f in fragments)]
        return len(hits), sum(hits) / 1e6
