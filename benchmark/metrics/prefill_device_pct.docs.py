"""Prefill's device share in the document cell: the admission groups'
device spans (the time between the CUDA events the engine records on the
stream before and after each group's prefill and splice), summed over
the groups that started in the part of a traced run's window after the
profiler stopped, over that part's length; from the program's span
recorder. None off the card."""

from harness.spec import metric

LAYER = "prefill (serve/engine.py _admit_group, models/llava.py, QuantDense)"
MOVES = "serve_tok_s.docs"


def read(run):
    got = metric("queue_wait_p90_ms.serve").recorder(run)
    if got is None:
        return None
    rec, t0, t1 = got
    times = [w.device_s for w in rec.between("launches", t0, t1)
             if w.kind == "admit" and w.device_s is not None]
    return 100.0 * sum(times) / (t1 - t0) if times else None
