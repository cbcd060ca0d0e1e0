"""`device_idle_pct.serve` in the document cell: the share of the traced
window in which no operation ran on the device, read as
`device_idle_pct.serve` reads it, moving that cell's own throughput
entry."""

from harness.spec import metric

LAYER = "device"
MOVES = "serve_tok_s.docs"


def read(run):
    return metric("device_idle_pct.serve").read(run)
