"""`mfu.serve` in the document cell: the whole window's share of the card's
roofline, read as `mfu.serve` reads it, moving that cell's own
throughput entry."""

from harness.spec import metric

LAYER = "whole step (models/llava.py, models/decoder.py)"
MOVES = "serve_tok_s.docs"


def read(run):
    return metric("mfu.serve").read(run)
