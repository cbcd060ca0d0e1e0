"""End-to-end serving metrics over a window, from the client's clock.

Each request record holds its send time, the time each of its tokens
reached the client, and whether it failed. A failed request counts as
missing every limit: its latency is infinite in every tail it enters.
Tails are taken over all requests, never over medians of pieces.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence


@dataclasses.dataclass
class Record:
    index: int
    client: int
    sent: float
    prompt: int                      # prompt positions, image rows included
    max_new: int
    greedy: bool
    image: bool = False
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    failed: bool = False
    error: str = ""

    @property
    def finished(self) -> bool:
        return not self.failed and len(self.tokens) == self.max_new


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value at or above
    q% of the values (inf when one of those is a failure)."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def window_metrics(records: Sequence[Record], w0: float, w1: float) -> dict:
    """serve_tok_s: tokens that reached clients in [w0, w1) over the
    window's seconds; ttft_p50_ms, ttft_p90_ms and ttft_p95_ms over
    requests whose first token came in the window (and failed requests
    sent in it); tpot_p95_ms over requests whose last token came in the
    window, (last - first) / (tokens - 1); attempted: requests sent in the
    window; failed: those of them that failed."""
    tokens = sum(1 for r in records for t in r.times if w0 <= t < w1)
    ttft, tpot, attempted, failed = [], [], 0, 0
    for r in records:
        sent_in = w0 <= r.sent < w1
        attempted += sent_in
        if r.failed:
            failed += sent_in
            if sent_in:
                ttft.append(math.inf)
                tpot.append(math.inf)
            continue
        if r.times and w0 <= r.times[0] < w1:
            ttft.append((r.times[0] - r.sent) * 1e3)
        if r.finished and len(r.times) > 1 and w0 <= r.times[-1] < w1:
            tpot.append((r.times[-1] - r.times[0]) * 1e3
                        / (len(r.times) - 1))
    out = {"serve_tok_s": tokens / (w1 - w0), "attempted": attempted,
           "failed": failed, "n_ttft": len(ttft), "n_tpot": len(tpot)}
    for q in (50, 90, 95):
        out[f"ttft_p{q}_ms"] = percentile(ttft, q) if ttft else None
    out["tpot_p95_ms"] = percentile(tpot, 95) if tpot else None
    return out
