"""The engine's admission wait in the chat cell: the 90th percentile, over
the requests whose admission group started in the part of a traced
run's window after the profiler stopped, of submit (`_make_request`, on
the client's thread) -> the start of that group, from the program's span
recorder (`competesmoe_tpu_torch.utils.spans`).

`recorder(run)` gives the other span readers that part of the window."""

from harness.stats import percentile

LAYER = "engine admission (serve/engine.py _admit)"
MOVES = "ttft_p90_ms"


def recorder(run):
    """(the program's recorder, t0, t1): from the profiler's stop to the
    window's end; None where the run was not traced or the program
    records no spans."""
    served = run.served
    w1 = getattr(served, "w1", None)
    if served.trace_window is None or w1 is None:
        return None
    try:
        from competesmoe_tpu_torch.utils.spans import RECORDER
    except ImportError:
        return None
    return RECORDER, served.trace_window[1], w1


def read(run):
    got = recorder(run)
    if got is None:
        return None
    rec, t0, t1 = got
    waits = [(r.admit - r.submit) * 1e3
             for r in rec.between("requests", t0, t1)]
    return percentile(waits, 90) if waits else None
