"""Rank 0 leads, the other ranks follow: every call rank 0 makes on a
sharded model, the others make too, in the same order, with the same
arguments, so the model's collectives pair up (the multi-controller
counterpart of JAX's one process calling a jitted function on sharded
arrays: serve/model_worker.py's solo path, cli/eval_mm.py --mesh).

`Lockstep(fns)` on every rank, with the same named functions. Rank 0
calls `call(name, ...)` (a function's result) or `stream(name, ...)` (a
generator's items); the others sit in `follow()` until rank 0's `stop()`.
Each call's name and arguments go over a CPU gloo group (the world's, or
one made for it when the world is NCCL). A stream also broadcasts, before
each further item, whether rank 0's consumer still wants it, so a client
that leaves early ends the generation on every rank at the same step.
Calls are serialised by a lock: one at a time on every rank.
"""

from __future__ import annotations

import inspect
import threading
from typing import Callable, Dict, Optional

import torch.distributed as dist


def control_group():
    """A CPU group of every rank for small broadcasts: the world's group
    when it is gloo, else a new gloo group (every rank makes it, in the
    same order)."""
    return (None if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))


def from_lead(obj, group):
    """Rank 0's `obj` on every rank of `group` (a `control_group()`); the
    other ranks' `obj` is ignored."""
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


class Lockstep:
    def __init__(self, fns: Dict[str, Callable], group=None):
        self.fns = dict(fns)
        self.group = control_group() if group is None else group
        self.lead = dist.get_rank() == 0
        self._lock = threading.Lock()

    def _bcast(self, obj=None):
        return from_lead(obj, self.group)

    def call(self, name: str, *args, **kw):
        """Rank 0: run `name` here and on every follower."""
        with self._lock:
            self._bcast((name, args, kw))
            return self.fns[name](*args, **kw)

    def stream(self, name: str, *args, **kw):
        """Rank 0: iterate the generator `name` here and on every
        follower, one item at a time."""
        with self._lock:
            self._bcast((name, args, kw))
            gen = self.fns[name](*args, **kw)
            ended = False
            try:
                for item in gen:
                    yield item
                    self._bcast(True)
                ended = True
            finally:
                if not ended:
                    self._bcast(False)
                    gen.close()

    def stop(self) -> None:
        """Rank 0: release the followers."""
        with self._lock:
            self._bcast(None)

    def follow(self, on_result: Optional[Callable] = None) -> None:
        """A follower: make rank 0's calls until its stop()."""
        while True:
            msg = self._bcast()
            if msg is None:
                return
            name, args, kw = msg
            out = self.fns[name](*args, **kw)
            if inspect.isgenerator(out):
                for _ in out:
                    if not self._bcast():
                        out.close()
                        break
            elif on_result is not None:
                on_result(name, out)
