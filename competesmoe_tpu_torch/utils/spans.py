"""Spans and counters of the port's host code, on `time.perf_counter()`:
the clock a benchmark's window and its clients' token stamps use.

- `span(name, **attrs)`: a context manager that records the span's name,
  start, end, parent (the span open on the same thread when it began)
  and attributes. While a torch profiler is active it also enters a
  `torch.profiler.record_function` range of the same name, so the span
  sits in the profiler's trace beside the device records. With none
  active it enters no range: a range costs several microseconds even
  then, the check a flag read.
- `request(rid)`: one record per request, stamped with its submit time;
  the serving engine stamps when its admission group started (`admit`)
  and when its first token was put on its queue (`first`).
- `launch(kind, device)`: one record per launch of device work (a
  serving engine's decode step, kind 'step'; an admission group's prefill
  and splice, 'admit'): the host time it began and, on a CUDA device,
  its device seconds from a pair of CUDA events recorded on the stream
  before and after the work (`Launch.end`). `Launch.done` reads them once
  the work has finished, without waiting for it; off the card they stay
  None.

Records go into the rings of one process-global `Recorder` (`RECORDER`),
each of bounded length, so a long-running server does not grow: the
oldest records drop first. Readers pick records by time.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start: float
    end: float
    attrs: Dict[str, Any]


class RequestRecord:
    """A request's submit time, the start of its admission group and the
    time its first token was queued (None until they happen)."""

    __slots__ = ("rid", "submit", "admit", "first")

    def __init__(self, rid: int, submit: float):
        self.rid, self.submit = rid, submit
        self.admit: Optional[float] = None
        self.first: Optional[float] = None


class Launch:
    """One launch of device work: its kind, the host time it began, and
    its device seconds (None until `done` reads them, and off the
    card)."""

    __slots__ = ("kind", "start", "device_s", "_pair", "_pool")

    def __init__(self, kind: str, start: float, pair, pool):
        self.kind, self.start = kind, start
        self.device_s: Optional[float] = None
        self._pair, self._pool = pair, pool

    @property
    def pending(self) -> bool:
        """True while the device time is still to be read."""
        return self._pair is not None

    def end(self) -> "Launch":
        """Record the end of the work on the stream."""
        if self._pair is not None:
            self._pair[1].record()
        return self

    def done(self) -> bool:
        """Read the device time if the work has finished (an event query,
        which does not wait); True once there is nothing left to read."""
        if self._pair is None:
            return True
        a, b = self._pair
        if not b.query():
            return False
        self.device_s = a.elapsed_time(b) / 1e3
        self._pair = None
        self._pool.extend((a, b))
        return True


class _Open:
    """The context of one span (see `Recorder.span`)."""

    __slots__ = ("_rec", "name", "attrs", "id", "parent", "start", "_range")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> "_Open":
        rec = self._rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(rec._ids)
        stack.append(self.id)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        rec = self._rec
        rec._stack().pop()
        rec.spans.append(Span(self.id, self.parent, self.name, self.start,
                              end, self.attrs))


class Recorder:
    """Bounded rings of spans, request records and launches (the newest
    `spans`, `requests` and `launches` of each)."""

    def __init__(self, spans: int = 1 << 16, requests: int = 1 << 14,
                 launches: int = 1 << 16):
        self.spans: "collections.deque[Span]" = collections.deque(
            maxlen=spans)
        self.requests: "collections.deque[RequestRecord]" = (
            collections.deque(maxlen=requests))
        self.launches: "collections.deque[Launch]" = collections.deque(
            maxlen=launches)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._events: list = []     # CUDA timing events free for reuse

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **attrs) -> _Open:
        return _Open(self, name, attrs)

    def request(self, rid: int) -> RequestRecord:
        rec = RequestRecord(rid, time.perf_counter())
        self.requests.append(rec)
        return rec

    def launch(self, kind: str, device) -> Launch:
        """A launch beginning now; on a CUDA device its first event is
        recorded on the current stream."""
        pair = None
        if torch.device(device).type == "cuda":
            pair = (self._event(), self._event())
            pair[0].record()
        out = Launch(kind, time.perf_counter(), pair, self._events)
        self.launches.append(out)
        return out

    def _event(self):
        try:
            return self._events.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def between(self, ring: str, t0: float, t1: float) -> list:
        """The records of ring `ring` ('spans', 'requests', 'launches')
        whose time lies in [t0, t1): a span's or a launch's start, a
        request's admission."""
        key = "admit" if ring == "requests" else "start"
        out = []
        for r in tuple(getattr(self, ring)):
            t = getattr(r, key)
            if t is not None and t0 <= t < t1:
                out.append(r)
        return out


RECORDER = Recorder()
span = RECORDER.span
request = RECORDER.request
launch = RECORDER.launch
