"""Sort/group/batch helper with original-order restore
(re-design of evaluate/lmms_eval/utils.py `Collator`).

The port's own copy of competesmoe_tpu/eval/collator.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


class Collator:
    """Sorts requests by a key (e.g. prompt length, for padding
    efficiency), yields batches, and restores original order on output."""

    def __init__(self, requests: List[Any], sort_fn: Callable[[Any], Any],
                 group_fn: Callable[[Any], Any] = None,
                 batch_size: int = 1):
        self._requests = list(enumerate(requests))
        self.sort_fn = sort_fn
        self.group_fn = group_fn or (lambda x: 0)
        self.batch_size = batch_size
        self._order: List[int] = []

    def __iter__(self) -> Iterator[List[Any]]:
        groups = {}
        for i, req in self._requests:
            groups.setdefault(self.group_fn(req), []).append((i, req))
        self._order = []
        for _, items in sorted(groups.items(), key=lambda kv: str(kv[0])):
            items.sort(key=lambda ir: self.sort_fn(ir[1]))
            for s in range(0, len(items), self.batch_size):
                chunk = items[s:s + self.batch_size]
                self._order.extend(i for i, _ in chunk)
                yield [r for _, r in chunk]

    def get_original(self, results: List[Any]) -> List[Any]:
        """Map batched outputs (concatenated in iteration order) back to
        the original request order."""
        assert len(results) == len(self._order), (
            f"{len(results)} results for {len(self._order)} requests")
        out = [None] * len(self._requests)
        for res, i in zip(results, self._order):
            out[i] = res
        return out
