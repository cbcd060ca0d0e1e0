"""Closed-loop serving traffic: a fixed number of clients, each sending its
next request as soon as its last one has finished.

A mix file (`benchmark/traffic/<name>.json`, "kind": "closed_loop") gives:

- `clients`; `pool` (request shapes in one cycle), `block` (the pool's
  blocks, 16 by default) and `layout_seed`;
- `prompt_tokens` and `output_tokens`: {"dist": "lognormal", "median",
  "sigma", "min", "max"} or {"dist": "uniform", "min", "max"};
- `image_share`, `image_size`, `image_at` (where the image token sits);
- `sampled_share`, `temperature`, `top_p` (the rest decode greedily);
- `stagger_s` (client c sends its first request c x stagger_s after the
  first), `ramp_s` (from the first request to the window's start);
- `check_tokens` (served tokens the output check samples at least);
  `trace_s` (the traced slice of a --trace 1 run, at the window's start).

The pool's shapes do not depend on the run's seed: lengths are the pool's
quantiles of their distribution, spread by `layout_seed` so that every
block of `block` consecutive shapes holds one length from each of
`block` strata of each distribution, and the mix's shares of images and
sampled requests exactly (as near as `block` allows). The seed orders the
blocks and the shapes within each block, once per cycle, and draws every
token id and pixel. So two seeds send the same sizes in another order,
and any stretch of a few blocks, such as the requests of one window,
holds nearly the same mix.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional

import numpy as np

IMAGE_TOKEN = -200


@dataclasses.dataclass(frozen=True)
class Shape:
    prompt: int            # prompt ids, the image token among them
    output: int
    image: bool
    sampled: bool


@dataclasses.dataclass
class Request:
    index: int             # the request's number in the run
    client: int
    shape: Shape
    ids: np.ndarray
    pixels: Optional[np.ndarray]
    temperature: float
    top_p: float


def _quantiles(dist: dict, n: int) -> List[int]:
    """n stratified draws of `dist`: its quantiles at (i + 0.5) / n."""
    lo, hi = dist["min"], dist["max"]
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        vals = lo + u * (hi - lo)
    elif dist["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        vals = np.exp(np.log(dist["median"]) + dist["sigma"] * z)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return [int(v) for v in np.clip(np.round(vals), lo, hi)]


def pool(params: dict) -> List[Shape]:
    """The mix's request shapes, the same for every seed, in blocks (see
    the module docstring)."""
    n, size = params["pool"], params.get("block", 16)
    if n % size:
        raise ValueError(f"pool {n} is not a whole number of blocks of "
                         f"{size}")
    blocks = n // size
    rng = np.random.default_rng(params["layout_seed"])

    def spread(values):
        """Sorted values -> an order in which each block takes one value
        of each of `size` strata, in a random place of the block."""
        strata = np.sort(np.asarray(values)).reshape(size, blocks)
        out = np.stack([row[rng.permutation(blocks)] for row in strata], 1)
        return np.stack([row[rng.permutation(size)] for row in out]
                        ).reshape(n)

    def shares(share):
        k = round(share * size)
        return np.stack([rng.permutation(size) < k
                         for _ in range(blocks)]).reshape(n)

    prompts = spread(_quantiles(params["prompt_tokens"], n))
    outputs = spread(_quantiles(params["output_tokens"], n))
    images = shares(params.get("image_share", 0.0))
    sampled = shares(params.get("sampled_share", 0.0))
    return [Shape(int(prompts[i]), int(outputs[i]), bool(images[i]),
                  bool(sampled[i])) for i in range(n)]


class Plan:
    """The requests of one run: `next(client)` gives a client's next
    request. Deterministic from (params, seed)."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.params = params
        self.seed = int(seed) % (2 ** 63)
        self.vocab = vocab
        self.shapes = pool(params)
        self.clients = params["clients"]
        self._sent = [0] * self.clients
        self._orders = {}

    def _order(self, cycle: int) -> np.ndarray:
        """The pool's order in `cycle`: its blocks, and the shapes within
        each block, permuted by the seed."""
        if cycle not in self._orders:
            size = self.params.get("block", 16)
            rng = np.random.default_rng([self.seed, cycle])
            blocks = len(self.shapes) // size
            self._orders[cycle] = np.concatenate(
                [b * size + rng.permutation(size)
                 for b in rng.permutation(blocks)])
        return self._orders[cycle]

    def request(self, client: int, j: int) -> Request:
        """Client `client`'s j-th request."""
        k = j * self.clients + client
        n = len(self.shapes)
        shape = self.shapes[self._order(k // n)[k % n]]
        rng = np.random.default_rng([self.seed, 1, k])
        ids = rng.integers(3, self.vocab, shape.prompt).astype(np.int32)
        px = None
        if shape.image:
            ids[min(self.params.get("image_at", 1), shape.prompt - 1)] = \
                IMAGE_TOKEN
            s = self.params["image_size"]
            px = rng.uniform(-1.0, 1.0, (1, s, s, 3)).astype(np.float32)
        p = self.params
        return Request(index=k, client=client, shape=shape, ids=ids,
                       pixels=px,
                       temperature=p["temperature"] if shape.sampled else 0.0,
                       top_p=p["top_p"] if shape.sampled else 1.0)

    def next(self, client: int) -> Request:
        j = self._sent[client]
        self._sent[client] += 1
        return self.request(client, j)

    def start_offset(self, client: int) -> float:
        return client * self.params["stagger_s"]
