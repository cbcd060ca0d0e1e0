"""Dataset "lite" shrinker: embedding-based coreset selection.

Re-design of the reference's `evaluate/tools/lite/` pipeline
(embed.py + shrinker/EmbedShrinker.py + sampling_methods/kcenter_greedy.py):
embed every doc of an eval task, then pick a diverse subset with k-center
greedy (deterministic: the first center is index 0, matching
kcenter_greedy.py:66 "ind = 0  # To avoid randomness"), so large
benchmarks can be run as representative "lite" splits.

The reference embeds with CLIP+BGE network checkpoints; here the embedder
is pluggable: `hashed_bow_embedder` is a deterministic offline default
(feature-hashed bag of words + coarse image thumbnail), and any
callable(doc) -> np.ndarray works (e.g. a vision-tower embedder).

The port's own copy of competesmoe_tpu/eval/lite.py: it imports neither
JAX nor that package.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np


def kcenter_greedy(X: np.ndarray, n: int, start: int = 0) -> np.ndarray:
    """Greedy k-center coreset (sampling_methods/kcenter_greedy.py:43-80):
    start from `start`, then repeatedly add the point farthest from the
    selected set (euclidean). Returns the selected indices in order."""
    X = np.asarray(X, np.float32)
    if X.ndim == 3:  # [N, 1, D] cache layout (EmbedShrinker.py:38-41)
        X = X.reshape(X.shape[0], -1)
    n = min(int(n), X.shape[0])
    if n <= 0:
        return np.zeros((0,), np.int64)
    selected = [int(start)]
    d = np.linalg.norm(X - X[start], axis=1)
    d[start] = -1.0  # never re-select (ref asserts uniqueness, :73)
    for _ in range(n - 1):
        ind = int(np.argmax(d))
        selected.append(ind)
        d = np.minimum(d, np.linalg.norm(X - X[ind], axis=1))
        d[ind] = -1.0
    return np.asarray(selected, np.int64)


def hashed_bow_embedder(dim: int = 256, image_bins: int = 16
                        ) -> Callable[[dict], np.ndarray]:
    """Offline embedder: feature-hashed bag-of-words over every string
    field plus a coarse grayscale thumbnail of the first PIL image field.
    Deterministic (md5 hashing), no model downloads — the stand-in for the
    reference's ClipBgeEmbedder on a host without network access."""

    def embed(doc: dict) -> np.ndarray:
        text_vec = np.zeros(dim, np.float32)
        img_vec = np.zeros(image_bins, np.float32)
        for v in doc.values():
            if isinstance(v, str):
                for w in v.lower().split():
                    h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                    text_vec[h % dim] += 1.0
            elif hasattr(v, "convert") and hasattr(v, "resize"):
                thumb = np.asarray(
                    v.convert("L").resize((4, 4))).astype(np.float32)
                img_vec[:16] = thumb.reshape(-1) / 255.0
        norm = np.linalg.norm(text_vec)
        if norm > 0:
            text_vec /= norm
        return np.concatenate([text_vec, img_vec])

    return embed


def embed_task(docs: Sequence[dict],
               embed_fn: Optional[Callable] = None,
               cache_path: Optional[str] = None,
               task_name: str = "task") -> np.ndarray:
    """Embed every doc (embed.py role), with the reference's
    `<task>_embed.npy` cache convention."""
    if cache_path is not None:
        cached = Path(cache_path) / f"{task_name}_embed.npy"
        if cached.exists():
            return np.load(cached)
    embed_fn = embed_fn or hashed_bow_embedder()
    X = np.stack([np.asarray(embed_fn(d), np.float32) for d in docs])
    if cache_path is not None:
        Path(cache_path).mkdir(parents=True, exist_ok=True)
        np.save(Path(cache_path) / f"{task_name}_embed.npy", X)
    return X


def shrink_task(task_name: str, num_items: float,
                docs: Optional[Sequence[dict]] = None,
                embed_fn: Optional[Callable] = None,
                cache_path: Optional[str] = None,
                output_path: Optional[str] = None) -> List[int]:
    """EmbedShrinker.shrink (EmbedShrinker.py:33-55): embed, k-center
    select `num_items` (a fraction when < 1.0), return selected doc ids
    (and write them as JSON when `output_path` is given; the reference
    pushes a HF dataset split instead)."""
    if docs is None:
        from .task import ConfigurableTask, get_task_config
        docs = ConfigurableTask(get_task_config(task_name)).docs
    X = embed_task(docs, embed_fn, cache_path, task_name)
    n = int(len(docs) * num_items) if num_items < 1.0 else int(num_items)
    idx = kcenter_greedy(X, n).tolist()
    if output_path is not None:
        out = Path(output_path)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{task_name}_lite.json").write_text(
            json.dumps({"task": task_name, "n": len(idx),
                        "indices": idx}))
    return idx


def main(argv=None):
    """CLI mirroring tools/lite/shrink.py arguments."""
    import argparse

    p = argparse.ArgumentParser(description="lite dataset shrinker")
    p.add_argument("--tasks", required=True,
                   help="comma-separated task names")
    p.add_argument("--num_items", required=True,
                   help="count (or fraction < 1.0); one value or one per "
                        "task")
    p.add_argument("--embed_cache_path", default=None)
    p.add_argument("--output_path", default="lite_out")
    a = p.parse_args(argv)
    tasks = a.tasks.split(",")
    nums = [float(x) for x in a.num_items.split(",")]
    if len(nums) == 1:
        nums = nums * len(tasks)
    if len(nums) != len(tasks):
        raise SystemExit("one num_items for all tasks or one per task")
    for t, n in zip(tasks, nums):
        idx = shrink_task(t, n, cache_path=a.embed_cache_path,
                          output_path=a.output_path)
        print(f"{t}: selected {len(idx)} docs -> "
              f"{a.output_path}/{t}_lite.json")


if __name__ == "__main__":
    main()
