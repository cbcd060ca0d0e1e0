"""LM pretraining data (numpy-only copy of competesmoe_tpu/data/lm_data.py):
tokenized uint16 mmap chunks cut into `unroll_len + 1` windows, the
synthetic corpora, stateful samplers, the vocab-train-then-tokenize flow
and the variable-length collate. The same seed, indices and files give
the same batches and chunk bytes in both packages.

`tokenizers` (HF, a byte-level BPE stands in for SentencePiece) is
imported inside the functions that need it, so the package imports
without it. `TokenChunkDataset.batch` gathers through the repo's native
C++ assembler (`data/native_loader.py`) where it builds, else numpy.
Batches are global: nothing here slices work per rank.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

import numpy as np

TOKEN_DTYPE = np.uint16


class TokenChunkDataset:
    """Fixed-window views over one or more uint16 token mmap chunks.

    Layout mirrors the reference's `{name}/tokenized/...bin` chunks
    (chunked_setencepiece_lm_dataset.py:218-301): each chunk is a flat
    uint16 array; windows of `unroll_len + 1` tokens are cut per chunk
    (no window crosses a chunk boundary).
    """

    def __init__(self, chunk_paths: Sequence[os.PathLike], unroll_len: int):
        self.unroll_len = unroll_len
        self.window = unroll_len + 1
        self.chunks: List[np.memmap] = []
        self.cum_windows = [0]
        for p in chunk_paths:
            arr = np.memmap(p, dtype=TOKEN_DTYPE, mode="r")
            self.chunks.append(arr)
            self.cum_windows.append(
                self.cum_windows[-1] + len(arr) // self.window)
        if self.cum_windows[-1] == 0:
            raise ValueError("no complete windows in the given chunks")

    def __len__(self) -> int:
        return self.cum_windows[-1]

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self):
            raise IndexError(i)
        ci = int(np.searchsorted(self.cum_windows, i, side="right")) - 1
        off = (i - self.cum_windows[ci]) * self.window
        return np.asarray(self.chunks[ci][off:off + self.window],
                          dtype=np.int32)

    def batch(self, indices: np.ndarray) -> np.ndarray:
        """Batch gather through the native C++ assembler when available
        (native/dataloader.cpp), else per-window numpy."""
        from .native_loader import assemble_batch, native_available
        if not native_available():
            return np.stack([self[int(i)] for i in indices])
        indices = np.asarray(indices, np.int64)
        chunk_ids = (np.searchsorted(self.cum_windows, indices,
                                     side="right") - 1).astype(np.int64)
        local_ids = indices - np.asarray(self.cum_windows)[chunk_ids]
        return assemble_batch(self.chunks, chunk_ids, local_ids,
                              self.window)


class BackgroundFetcher:
    """Background-thread batch prefetcher (the reference's
    StoppingParallelProducer role, framework/task/simple_task.py:175-180)."""

    def __init__(self, fetch_fn, depth: int = 2):
        import queue
        import threading
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    item = fetch_fn()
                except Exception as e:  # surface errors to the consumer
                    self._q.put(e)
                    return
                self._q.put(item)

        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()

    def get(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass


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


class SyntheticMixtureLMDataset:
    """Latent-mode Markov language: a synthetic corpus where ROUTING
    QUALITY matters, built for the CompeteSMoE-vs-SMoE algorithm A/B
    (docs/science.md).

    Each window draws a latent mode m ~ Uniform(K); tokens then follow
    mode m's successor rule: with prob `coherence` the next token is
    `perm_m[cur]` (a mode-specific random permutation of the vocab),
    else an iid Zipf(alpha) sample. Every mode shares the same Zipfian
    marginal, so the mode is identifiable ONLY from transition context —
    an MoE FFN minimizes loss by devoting expert capacity per mode, which
    makes expert selection (the thing CompeteSMoE claims to improve)
    causally tied to achievable perplexity. Windows are deterministic in
    (seed, index) and never repeat across indices: no epoch effects, both
    A/B arms see byte-identical data at the same step.

    `mode_of(i)` exposes the latent mode for per-mode validation splits.
    """

    def __init__(self, vocab_size: int, unroll_len: int,
                 n_windows: int = 1 << 16, seed: int = 0,
                 n_modes: int = 16, coherence: float = 0.85,
                 zipf_alpha: float = 1.2):
        self.vocab_size = vocab_size
        self.unroll_len = unroll_len
        self.n_windows = n_windows
        self.seed = seed
        self.n_modes = n_modes
        self.coherence = coherence
        master = np.random.default_rng(seed ^ 0x5EED)
        self.perms = np.stack([master.permutation(vocab_size)
                               for _ in range(n_modes)])
        # shared Zipfian marginal (ranks fixed across modes)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -zipf_alpha
        self.marginal = p / p.sum()

    def __len__(self) -> int:
        return self.n_windows

    def mode_of(self, i: int) -> int:
        return int(np.random.default_rng(
            self.seed * 1_000_003 + i).integers(self.n_modes))

    def __getitem__(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        mode = int(rng.integers(self.n_modes))
        perm = self.perms[mode]
        n = self.unroll_len + 1
        noise = rng.choice(self.vocab_size, size=n, p=self.marginal)
        coherent = rng.random(n) < self.coherence
        seq = np.empty(n, np.int64)
        seq[0] = noise[0]
        for t in range(1, n):
            seq[t] = perm[seq[t - 1]] if coherent[t] else noise[t]
        return seq.astype(np.int32)

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


@dataclasses.dataclass
class InfiniteRandomSampler:
    """Seeded random-with-replacement sampler (framework/loader/sampler.py
    `InfiniteSampler` role), checkpointable via the draw counter."""

    n_items: int
    batch_size: int
    seed: int = 0
    pos: int = 0

    def __next__(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, self.pos))
        self.pos += 1
        return rng.integers(0, self.n_items, size=self.batch_size)

    def __iter__(self):
        return self

    def state_dict(self) -> Dict:
        return {"pos": self.pos, "seed": self.seed}

    def load_state_dict(self, d: Dict) -> None:
        self.pos = int(d["pos"])
        self.seed = int(d["seed"])


# ---------------------------------------------------------------------------
# Tokenization (vocab train -> mmap chunks)
# ---------------------------------------------------------------------------

def train_tokenizer(texts: Iterator[str], vocab_size: int,
                    save_path: os.PathLike):
    """Train a byte-level BPE vocab on an iterator of documents (the role of
    the reference's SentencePiece training on the first shards,
    chunked_setencepiece_lm_dataset.py:38-130)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<eos>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(texts, trainer)
    tok.save(str(save_path))
    return tok


def load_tokenizer(path: os.PathLike):
    from tokenizers import Tokenizer
    return Tokenizer.from_file(str(path))


def tokenize_to_chunks(texts: Iterator[str], tokenizer, out_dir: os.PathLike,
                       chunk_tokens: int = 2**24,
                       eos_id: int = 0) -> List[Path]:
    """Tokenize documents into flat uint16 chunk files, one <eos> between
    documents (the mmap-chunk writer role,
    chunked_setencepiece_lm_dataset.py:218-301)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    buf: List[int] = []
    paths: List[Path] = []

    def flush():
        if not buf:
            return
        p = out_dir / f"chunk_{len(paths):05d}.bin"
        np.asarray(buf, dtype=TOKEN_DTYPE).tofile(p)
        paths.append(p)
        buf.clear()

    for doc in texts:
        ids = tokenizer.encode(doc).ids
        buf.extend(ids)
        buf.append(eos_id)
        if len(buf) >= chunk_tokens:
            flush()
    flush()
    manifest = {"chunks": [p.name for p in paths]}
    (out_dir / "manifest.json").write_text(json.dumps(manifest))
    return paths


def open_chunk_dir(d: os.PathLike, unroll_len: int) -> TokenChunkDataset:
    d = Path(d)
    manifest = json.loads((d / "manifest.json").read_text())
    return TokenChunkDataset([d / name for name in manifest["chunks"]],
                             unroll_len)


@dataclasses.dataclass
class BucketedSampler:
    """Length-bucketed batch sampler (framework/loader/sampler.py
    `BucketedSampler` role): groups indices of similar length to minimize
    padding; deterministic per epoch, checkpointable."""

    lengths: list
    batch_size: int
    bucket_size_mult: int = 100
    seed: int = 0
    epoch: int = 0
    drop_last: bool = True

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        order = rng.permutation(len(self.lengths))
        bucket = self.batch_size * self.bucket_size_mult
        for s in range(0, len(order), bucket):
            chunk = sorted(order[s:s + bucket],
                           key=lambda i: self.lengths[i])
            batches = [chunk[i:i + self.batch_size]
                       for i in range(0, len(chunk), self.batch_size)]
            if self.drop_last and batches and \
                    len(batches[-1]) < self.batch_size:
                batches.pop()
            rng.shuffle(batches)
            for b in batches:
                yield np.asarray(b)

    def state_dict(self):
        return {"epoch": self.epoch, "seed": self.seed}

    def load_state_dict(self, d):
        self.epoch = int(d["epoch"])
        self.seed = int(d["seed"])


def var_length_collate(samples, pad_value: int = 0,
                       ignore_index: int = -100):
    """Pad a list of {key: 1-D array} dicts to the batch max per key
    (framework/loader/collate.py `VarLengthCollate` role). 'labels' pads
    with ignore_index, everything else with pad_value; emits
    '<key>_len' arrays with the true lengths."""
    out = {}
    keys = samples[0].keys()
    for k in keys:
        arrs = [np.asarray(s[k]) for s in samples]
        if arrs[0].ndim == 0:
            out[k] = np.stack(arrs)
            continue
        max_len = max(a.shape[0] for a in arrs)
        fill = ignore_index if k == "labels" else pad_value
        batch = np.full((len(arrs), max_len) + arrs[0].shape[1:], fill,
                        arrs[0].dtype)
        for i, a in enumerate(arrs):
            batch[i, :a.shape[0]] = a
        out[k] = batch
        out[f"{k}_len"] = np.asarray([a.shape[0] for a in arrs],
                                     np.int32)
    return out
