"""Share of the traced window in which no operation ran on the device:
1 - (union of the device records' intervals) / (the window), from the
profiler's trace of a serving cell."""

LAYER = "device"
MOVES = "serve_tok_s"


def read(run):
    t = run.served.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
