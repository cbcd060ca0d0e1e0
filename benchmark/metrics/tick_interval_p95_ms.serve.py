"""The engine tick in the chat cell: the 95th percentile of the host time
between consecutive decode step launches in the part of a traced run's
window after the profiler stopped, from the program's span recorder; an
interval that holds an `engine.idle` wait (nothing live) is left out."""

import bisect

from harness.spec import metric
from harness.stats import percentile

LAYER = "engine tick (serve/engine.py _tick)"
MOVES = "tpot_p95_ms"


def read(run):
    got = metric("queue_wait_p90_ms.serve").recorder(run)
    if got is None:
        return None
    rec, t0, t1 = got
    steps = sorted(w.start for w in rec.between("launches", t0, t1)
                   if w.kind == "step")
    idle = sorted(s.start for s in rec.between("spans", t0, t1)
                  if s.name == "engine.idle")
    gaps = []
    for a, b in zip(steps, steps[1:]):
        i = bisect.bisect_left(idle, a)
        if i < len(idle) and idle[i] < b:
            continue
        gaps.append((b - a) * 1e3)
    return percentile(gaps, 95) if gaps else None
