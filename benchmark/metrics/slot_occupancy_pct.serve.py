"""Mean share of the engine's slots that hold a live request, sampled
from `DecodeEngine.stats()["engine_slots_live"]` every 20 ms through the
traced window of a serving cell."""

LAYER = "engine (serve/engine.py)"
MOVES = "serve_tok_s"


def read(run):
    live = run.served.live_slots
    if not live:
        return None
    return 100.0 * sum(live) / (len(live) * run.n_slots)
