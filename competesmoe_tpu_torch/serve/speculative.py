"""Prompt-lookup speculative decoding: host-side n-gram drafting (a numpy
copy of competesmoe_tpu/serve/speculative.py).

A decode step at small batch is bound by weight bytes, so a verify step
that feeds K+1 tokens through the same weights costs about as much as a
1-token step. Speculative decoding drafts K tokens cheaply, verifies them
all in one forward, and keeps the longest prefix that matches the model's
own greedy choices, emitting 1..K+1 tokens per step with the same tokens
as sequential greedy decoding.

The drafts come from prompt lookup (n-gram continuation): find the most
recent earlier occurrence of the current suffix n-gram and propose the
tokens that followed it. Verification lives in `models.llava`
(`speculative_accept`, the verify steps); the solo path enables it with
`stream_generate(..., speculative=K)` and the engine with
`DecodeEngine(spec_k=K)`.
"""

from typing import Optional, Sequence

import numpy as np

__all__ = ["ngram_draft"]


def ngram_draft(ids: Sequence[int], k: int, max_ngram: int = 3,
                min_ngram: int = 1) -> Optional[np.ndarray]:
    """Propose `k` draft tokens by prompt lookup.

    Searches `ids` (prompt + tokens generated so far, host ints) for the
    most recent earlier occurrence of the longest suffix n-gram
    (`max_ngram` down to `min_ngram`) and returns a copy of the `k`
    tokens that followed it, padded with the last available token when
    the match sits near the end.  Returns None when no n-gram recurs —
    the caller should then fall back to a plain decode step (or verify a
    zero draft; both cost the same on a bandwidth-bound step).

    Negative ids (the image-token sentinel spliced out before decode) are
    masked out of matching and never proposed.
    """
    ids = np.asarray(ids, dtype=np.int64).ravel()
    L = ids.shape[0]
    if L < 2 or k <= 0:
        return None
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pat = ids[L - n:]
        if (pat < 0).any():
            continue
        # windows of length n starting at 0..L-n-1 (strictly before the
        # suffix start, though overlap with it is fine and useful for
        # token runs): compare against the suffix pattern.
        win = np.lib.stride_tricks.sliding_window_view(ids[:L - 1], n)
        hits = np.flatnonzero((win == pat).all(axis=1))
        if hits.size == 0:
            continue
        start = int(hits[-1]) + n          # continuation start
        cont = ids[start:start + k]
        cont = cont[cont >= 0]
        if cont.size == 0:
            continue
        if cont.size < k:                  # pad: repeat the last token
            cont = np.concatenate(
                [cont, np.full(k - cont.size, cont[-1], np.int64)])
        return cont.astype(np.int32)
    return None
