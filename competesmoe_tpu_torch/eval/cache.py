"""SQLite response cache for evaluation requests.

Re-design of `evaluate/lmms_eval/api/model.py:18-203` (`CacheHook` /
`CachingLMM`): wraps a model adapter so repeated requests (re-runs,
resumed sweeps) hit a persistent sqlite store keyed by a hash of the
request type + arguments.

The port's own copy of competesmoe_tpu/eval/cache.py: it imports neither
JAX nor that package.
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
import threading
from typing import Any, List


def _key(reqtype: str, arguments) -> str:
    def default(o):
        # PIL images and arrays hash by bytes
        if hasattr(o, "tobytes"):
            return hashlib.sha1(o.tobytes()).hexdigest()
        return repr(o)
    payload = json.dumps([reqtype, arguments], default=default,
                         sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()


class CachingLM:
    """Wraps an adapter exposing generate_until/loglikelihood."""

    def __init__(self, lm, cache_path: str):
        self.lm = lm
        self._conn = sqlite3.connect(cache_path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS cache (k TEXT PRIMARY KEY, "
            "v TEXT)")
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _get(self, key: str):
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM cache WHERE k=?", (key,)).fetchone()
        return json.loads(row[0]) if row else None

    def _put(self, key: str, value) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO cache VALUES (?, ?)",
                (key, json.dumps(value)))
            self._conn.commit()

    def _dispatch(self, reqtype: str, requests: List[Any],
                  **kwargs) -> List[Any]:
        results: List[Any] = [None] * len(requests)
        missing = []
        for i, req in enumerate(requests):
            cached = self._get(_key(reqtype, req.arguments))
            if cached is not None:
                self.hits += 1
                results[i] = tuple(cached) if reqtype == "loglikelihood" \
                    else cached
                req.resps.append(results[i])
            else:
                self.misses += 1
                missing.append(i)
        if missing:
            sub = [requests[i] for i in missing]
            fresh = getattr(self.lm, reqtype)(sub, **kwargs)
            for i, val in zip(missing, fresh):
                results[i] = val
                self._put(_key(reqtype, requests[i].arguments), val)
        return results

    def generate_until(self, requests, **kwargs):
        return self._dispatch("generate_until", requests, **kwargs)

    def loglikelihood(self, requests, **kwargs):
        return self._dispatch("loglikelihood", requests, **kwargs)

    def __getattr__(self, name):
        return getattr(self.lm, name)
