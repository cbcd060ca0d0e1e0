"""Prefill and first token in the chat cell: the 90th percentile, over
the requests whose admission group started in the part of a traced
run's window after the profiler stopped, of that group's start -> the
request's first token on its queue, from the program's span recorder."""

from harness.spec import metric
from harness.stats import percentile

LAYER = ("prefill and first token (serve/engine.py _admit_group, _insert, "
         "_emit_admission)")
MOVES = "ttft_p90_ms"


def read(run):
    got = metric("queue_wait_p90_ms.serve").recorder(run)
    if got is None:
        return None
    rec, t0, t1 = got
    waits = [(r.first - r.admit) * 1e3
             for r in rec.between("requests", t0, t1) if r.first is not None]
    return percentile(waits, 90) if waits else None
