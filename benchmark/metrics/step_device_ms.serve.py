"""The decode step's device time in the chat cell: the median, over the
decode steps launched in the part of a traced run's window after the
profiler stopped, of the time between the CUDA events the engine records
on the stream just before and just after the step (a captured program's
replay), from the program's span recorder. None off the card."""

import statistics

from harness.spec import metric

LAYER = "decode step (models/decoder.py, the captured step_* programs)"
MOVES = "tpot_p95_ms"


def read(run):
    got = metric("queue_wait_p90_ms.serve").recorder(run)
    if got is None:
        return None
    rec, t0, t1 = got
    times = [w.device_s * 1e3 for w in rec.between("launches", t0, t1)
             if w.kind == "step" and w.device_s is not None]
    return statistics.median(times) if times else None
