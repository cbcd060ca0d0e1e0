"""`slot_occupancy_pct.serve` in the document cell: the share of the
engine's slots that hold a live request, read as
`slot_occupancy_pct.serve` reads it, moving that cell's own throughput
entry."""

from harness.spec import metric

LAYER = "engine (serve/engine.py)"
MOVES = "serve_tok_s.docs"


def read(run):
    return metric("slot_occupancy_pct.serve").read(run)
