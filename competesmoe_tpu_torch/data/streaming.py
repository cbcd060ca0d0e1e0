"""Streaming shard corpora (numpy-only copy of
competesmoe_tpu/data/streaming.py): URL or file shards -> a
SentencePiece-style Unigram vocab -> uint16 mmap token chunks ->
`unroll_len + 1` windows.

- shards are gzip / zstd / plain jsonl files (TheStack: parquet),
  reachable by URL or local path; a remote shard is downloaded to the
  cache once (atomic .tmp rename). The cache key of a URL is
  `crc32(url dir)_<name>`, stable across processes (JAX keys by Python's
  per-process `hash`);
- the vocab is trained on the first `tokenizer_n_files` shards with HF
  `tokenizers`' Unigram trainer (byte fallback, <STORY_SEP> between
  documents), imported inside the functions that need it;
- each shard is tokenized to a flat uint16 `chunk_{i:05d}.bin` (atomic
  rename; a re-run skips chunks that exist), read through
  `data.lm_data.TokenChunkDataset`.

The specs keep the reference's URL schemes and SlimPajama's and
TheStack's seeded shard orders (rng(123)), so a rebuild reads the same
shards in the same order; `url_base` and `LocalShardSpec` point them at
local files.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import json
import os
import urllib.request
import zlib
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from .lm_data import TOKEN_DTYPE, TokenChunkDataset

STORY_SEP = "<STORY_SEP>"


# ---------------------------------------------------------------------------
# shard IO
# ---------------------------------------------------------------------------

def fetch_to_cache(url: str, cache_dir: os.PathLike,
                   headers: Optional[dict] = None) -> Path:
    """Local path for a shard; downloads once if `url` is remote
    (training_helper fs_cache role, atomic rename). `headers` carries
    auth (e.g. the HF_TOKEN bearer gated datasets need, thestack.py)."""
    if "://" not in url:
        return Path(url)
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    name = url.split("?")[0].rsplit("/", 1)[-1]
    # disambiguate same-named shards from different URL dirs
    key = f"{zlib.crc32(url.rsplit('/', 1)[0].encode()):08x}_{name}"
    dst = cache_dir / key
    if dst.exists():
        return dst
    tmp = dst.with_suffix(dst.suffix + ".tmp")
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req) as r, open(tmp, "wb") as f:
        while True:
            block = r.read(1 << 20)
            if not block:
                break
            f.write(block)
    os.rename(tmp, dst)
    return dst


def shard_lines(path: os.PathLike) -> Iterator[str]:
    """Lines of a .gz / .zst / plain shard."""
    p = str(path)
    if p.endswith(".zst"):
        import zstandard
        with open(p, "rb") as f:
            reader = zstandard.ZstdDecompressor().stream_reader(f)
            for line in io.TextIOWrapper(reader, encoding="utf-8"):
                yield line
    elif p.endswith(".gz"):
        with gzip.open(p, "rt", encoding="utf-8") as f:
            yield from f
    else:
        with open(p, "r", encoding="utf-8") as f:
            yield from f


def parse_jsonl_text(line: str) -> str:
    return json.loads(line)["text"]


# ---------------------------------------------------------------------------
# dataset URL specs (reference-verbatim schemes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardSpec:
    """Abstract shard addressing: index -> URL per split."""

    url_base: Optional[str] = None   # override for local/offline use

    def get_url(self, index: int, split: str) -> str:
        raise NotImplementedError

    def get_n_shards(self, split: str) -> int:
        raise NotImplementedError

    def headers(self) -> dict:
        return {}

    def iter_records(self, path: os.PathLike,
                     parse: Callable[[str], str]) -> Iterator[str]:
        """Document texts of one local shard file."""
        for line in shard_lines(path):
            yield parse(line)


@dataclasses.dataclass
class LocalShardSpec(ShardSpec):
    """A directory (or explicit list) of local shard files; the offline
    path used by tests and pre-downloaded corpora."""

    shards: Sequence[str] = ()

    def get_url(self, index: int, split: str) -> str:
        return str(self.shards[index])

    def get_n_shards(self, split: str) -> int:
        return len(self.shards)


_C4_URL = ("https://huggingface.co/datasets/allenai/c4/resolve/"
           "1ddc917116b730e1859edef32896ec5c16be51d0/"
           "{name}/c4-{split}.{index:05d}-of-{n_shards:05d}.json.gz")
_C4_N_SHARDS = {
    "en": {"train": 1024, "validation": 8},
    "realnewslike": {"train": 512, "validation": 1},
    "en.noblocklist": {"train": 1024, "validation": 8},
    "en.noclean": {"train": 7168, "validation": 64},
}


@dataclasses.dataclass
class C4Spec(ShardSpec):
    """allenai/c4 (ref c4.py:8-31)."""

    variant: str = "en"

    def get_url(self, index: int, split: str) -> str:
        url = (self.url_base or _C4_URL)
        return url.format(name=self.variant, split=split, index=index,
                          n_shards=_C4_N_SHARDS[self.variant][split])

    def get_n_shards(self, split: str) -> int:
        return _C4_N_SHARDS[self.variant][split]


_SLIMPAJAMA_URL = ("https://huggingface.co/datasets/cerebras/"
                   "SlimPajama-627B/resolve/main/{split}/chunk{chunk}/"
                   "example_{type}_{index}.jsonl.zst")
_SLIMPAJAMA_CHUNKS = {
    "train": {1: 5912, 2: 5911, 3: 5919, 4: 5917, 5: 5933,
              6: 5915, 7: 5906, 8: 5921, 9: 5920, 10: 5912},
    "validation": {1: 6279, 2: 6278, 3: 6286, 4: 6284, 5: 6301},
    "test": {1: 6282, 2: 6273, 3: 6289, 4: 6288, 5: 6279},
}
_SLIMPAJAMA_TYPE = {"train": "train", "validation": "holdout",
                    "test": "holdout"}


@dataclasses.dataclass
class SlimPajamaSpec(ShardSpec):
    """cerebras/SlimPajama-627B with the reference's seeded shard-order
    permutation (slimpajama.py:21-57, rng seed 123)."""

    _map: dict = dataclasses.field(default_factory=dict, repr=False)

    def _ensure_map(self, split: str):
        if split in self._map:
            return
        indices, chunks = [], []
        for chunk, cnt in _SLIMPAJAMA_CHUNKS[split].items():
            indices += list(range(cnt))
            chunks += [chunk] * cnt
        rng = np.random.default_rng(123)
        perm = rng.permutation(len(indices)).tolist()
        self._map[split] = {"indices": [indices[i] for i in perm],
                            "chunks": [chunks[i] for i in perm]}

    def get_url(self, index: int, split: str) -> str:
        self._ensure_map(split)
        m = self._map[split]
        url = self.url_base or _SLIMPAJAMA_URL
        return url.format(split=split, chunk=m["chunks"][index],
                          index=m["indices"][index],
                          type=_SLIMPAJAMA_TYPE[split])

    def get_n_shards(self, split: str) -> int:
        self._ensure_map(split)
        return len(self._map[split]["indices"])


_PES2O_URL = ("https://huggingface.co/datasets/allenai/peS2o/resolve/main/"
              "data/{name}/{split}-{index:05d}-of-{n_shards:05d}.json.gz")
_PES2O_N_SHARDS = {"v1": {"train": 20, "validation": 2},
                   "v2": {"train": 20, "validation": 2}}


@dataclasses.dataclass
class PES2OSpec(ShardSpec):
    """allenai/peS2o (ref pes2o.py:9-31; the snapshot hardcodes a cluster
    path — the public HF layout is used here)."""

    variant: str = "v2"

    def get_url(self, index: int, split: str) -> str:
        url = self.url_base or _PES2O_URL
        return url.format(name=self.variant, split=split, index=index,
                          n_shards=_PES2O_N_SHARDS[self.variant][split])

    def get_n_shards(self, split: str) -> int:
        return _PES2O_N_SHARDS[self.variant][split]


_THESTACK_CNT_PER_LANG = {
    "python": 206, "html": 802, "c++": 214, "rust": 40,
    "javascript": 499, "scala": 17, "haskell": 7, "assembly": 3,
}
_THESTACK_URL = ("https://huggingface.co/datasets/bigcode/the-stack/"
                 "resolve/main/data/{lang}/train-{index:05d}-of-"
                 "{cnt:05d}.parquet")


@dataclasses.dataclass
class TheStackSpec(ShardSpec):
    """bigcode/the-stack parquet shards (ref thestack.py:9-110): per-
    language rng(123) shard permutation, 10% validation split, languages
    round-robin interleaved (mix_ids). Gated dataset — needs HF_TOKEN."""

    languages: str = "python"
    _ids: dict = dataclasses.field(default_factory=dict, repr=False)

    def _ensure_ids(self):
        if self._ids:
            return
        langs = sorted(l.strip() for l in self.languages.split(",")
                       if l.strip())
        rng = np.random.default_rng(123)
        lang_ids = {lang: rng.permutation(
            _THESTACK_CNT_PER_LANG[lang]).tolist() for lang in langs}
        valid_size = {lang: max(int(_THESTACK_CNT_PER_LANG[lang] * 0.1), 1)
                      for lang in langs}

        def mix(ids):
            res, i, last = [], 0, -1
            while last != len(res):
                last = len(res)
                for lang in sorted(ids):
                    if i < len(ids[lang]):
                        res.append((lang, ids[lang][i]))
                i += 1
            return res

        self._ids = {
            "validation": mix({l: lang_ids[l][:valid_size[l]]
                               for l in langs}),
            "train": mix({l: lang_ids[l][valid_size[l]:] for l in langs}),
        }

    def get_url(self, index: int, split: str) -> str:
        self._ensure_ids()
        lang, idx = self._ids[split][index]
        url = self.url_base or _THESTACK_URL
        return url.format(lang=lang, index=idx,
                          cnt=_THESTACK_CNT_PER_LANG[lang])

    def get_n_shards(self, split: str) -> int:
        self._ensure_ids()
        return len(self._ids[split])

    def headers(self) -> dict:
        token = os.environ.get("HF_TOKEN")
        return {"Authorization": f"Bearer {token}"} if token else {}

    def iter_records(self, path, parse):
        if str(path).endswith(".parquet"):
            import pandas as pd
            df = pd.read_parquet(path)
            for content in df["content"]:
                yield content
            return
        yield from super().iter_records(path, parse)


# ---------------------------------------------------------------------------
# vocab training (SentencePiece algorithm via HF tokenizers)
# ---------------------------------------------------------------------------

def train_unigram_tokenizer(texts: Iterator[str], vocab_size: int,
                            save_path: os.PathLike):
    """Train a SentencePiece-style Unigram LM tokenizer (the reference
    trains `sentencepiece` with vocab 8000 on the first shards,
    chunked_setencepiece_lm_dataset.py:142-176; the binary isn't in this
    image so the same algorithm runs through HF tokenizers)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        trainers

    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    trainer = trainers.UnigramTrainer(
        vocab_size=vocab_size,
        special_tokens=["<eos>", STORY_SEP, "<unk>"],
        unk_token="<unk>", shrinking_factor=0.75, n_sub_iterations=2)
    tok.train_from_iterator(texts, trainer)
    tok.save(str(save_path))
    return tok


# ---------------------------------------------------------------------------
# the chunked corpus
# ---------------------------------------------------------------------------

class ChunkedLMCorpus:
    """spec + cache_dir -> trained vocab + tokenized chunk files + windows.

    Mirrors ChunkedSentencepieceLMDataset's lifecycle: idempotent vocab
    train, per-shard tokenize-to-chunk with atomic rename and skip-if-
    present, then fixed-window reads. `token_limit` bounds how many shards
    are tokenized (the reference's token-limit estimation role).
    """

    TOKENIZER_N_FILES = 10

    def __init__(self, spec: ShardSpec, unroll_len: int,
                 cache_dir: os.PathLike, split: str = "train",
                 vocab_size: int = 8000,
                 n_shards: Optional[int] = None,
                 token_limit: Optional[int] = None,
                 parse: Callable[[str], str] = parse_jsonl_text,
                 tokenizer_n_files: Optional[int] = None,
                 algo: str = "unigram"):
        self.spec = spec
        self.split = split
        self.unroll_len = unroll_len
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.parse = parse
        self.vocab_size = vocab_size
        self.algo = algo
        self._tok_files = tokenizer_n_files or self.TOKENIZER_N_FILES

        self.tokenizer = self._ensure_tokenizer()
        self.eos_id = self.tokenizer.token_to_id("<eos>") or 0

        total = spec.get_n_shards(split)
        n = min(n_shards or total, total)
        self.chunk_paths = self._tokenize_shards(n, token_limit)
        self.windows = TokenChunkDataset(self.chunk_paths, unroll_len)

    # -- vocab --

    def _ensure_tokenizer(self):
        from tokenizers import Tokenizer

        path = self.cache_dir / f"tokenizer-{self.algo}-{self.vocab_size}.json"
        if path.exists():
            return Tokenizer.from_file(str(path))

        def texts():
            n = min(self._tok_files, self.spec.get_n_shards("train"))
            for i in range(n):
                local = fetch_to_cache(self.spec.get_url(i, "train"),
                                       self.cache_dir / "shards",
                                       headers=self.spec.headers())
                for txt in self.spec.iter_records(local, self.parse):
                    if txt:
                        yield txt + STORY_SEP

        if self.algo == "unigram":
            return train_unigram_tokenizer(texts(), self.vocab_size, path)
        from .lm_data import train_tokenizer
        return train_tokenizer(texts(), self.vocab_size, path)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text).ids

    # -- chunks --

    def _tokenize_shards(self, n: int, token_limit: Optional[int]
                         ) -> List[Path]:
        out_dir = self.cache_dir / f"tokenized-{self.split}"
        out_dir.mkdir(parents=True, exist_ok=True)
        paths: List[Path] = []
        total_tokens = 0
        for i in range(n):
            dst = out_dir / f"chunk_{i:05d}.bin"
            if not dst.exists():
                local = fetch_to_cache(self.spec.get_url(i, self.split),
                                       self.cache_dir / "shards",
                                       headers=self.spec.headers())
                tmp = dst.with_suffix(".tmp")
                with open(tmp, "wb") as f:
                    for txt in self.spec.iter_records(local, self.parse):
                        if not txt:
                            continue
                        ids = self.encode(txt + STORY_SEP)
                        np.asarray(ids, TOKEN_DTYPE).tofile(f)
                os.rename(tmp, dst)
            paths.append(dst)
            total_tokens += dst.stat().st_size // 2
            if token_limit is not None and total_tokens >= token_limit:
                break
        return paths

    # -- dataset protocol --

    def __len__(self):
        return len(self.windows)

    def __getitem__(self, i):
        return self.windows[i]

    def batch(self, indices):
        return self.windows.batch(indices)
