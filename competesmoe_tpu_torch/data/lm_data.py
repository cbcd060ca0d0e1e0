"""LM pretraining data for the synthetic task (numpy-only copies of
`SyntheticLMDataset` and `SequentialMultibatchSampler` from
competesmoe_tpu/data/lm_data.py): the same seed and indices give the same
batches in both packages. The streaming corpora and the token-chunk
datasets wait (ROADMAP open item 1.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


class SyntheticLMDataset:
    """Deterministic synthetic corpus (arithmetic token sequences) for
    smoke tests and offline benchmarking — stands in for the streaming
    C4/SlimPajama/peS2o sets when there is no network."""

    def __init__(self, vocab_size: int, unroll_len: int,
                 n_windows: int = 65536, seed: int = 0):
        self.vocab_size = vocab_size
        self.unroll_len = unroll_len
        self.n_windows = n_windows
        self.seed = seed

    def __len__(self) -> int:
        return self.n_windows

    def __getitem__(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        start = rng.integers(0, self.vocab_size)
        stride = rng.integers(1, 7)
        seq = (start + stride * np.arange(self.unroll_len + 1))
        return (seq % self.vocab_size).astype(np.int32)

    def batch(self, indices: np.ndarray) -> np.ndarray:
        return np.stack([self[int(i)] for i in indices])


@dataclasses.dataclass
class SequentialMultibatchSampler:
    """Checkpointable sequential sampler: batch lane b walks its own
    contiguous stripe of the dataset (framework/loader/sampler.py
    `MultibatchSequentialSampler` semantics — deterministic, resumable).
    """

    n_items: int
    batch_size: int
    pos: int = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        stripe = self.n_items // self.batch_size
        if stripe == 0:
            raise ValueError("dataset smaller than batch size")
        offsets = np.arange(self.batch_size) * stripe
        idx = offsets + (self.pos % stripe)
        self.pos += 1
        return idx

    def state_dict(self) -> Dict:
        return {"pos": self.pos}

    def load_state_dict(self, d: Dict) -> None:
        self.pos = int(d["pos"])
