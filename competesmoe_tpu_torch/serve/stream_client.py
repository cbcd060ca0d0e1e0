"""Client-side helper for the worker/controller streaming protocol (a copy
of competesmoe_tpu/serve/stream_client.py).

The reference protocol frames a generation stream as \\0-delimited JSON
objects with a cumulative "text" field (FastChat convention,
moe_model/serve/model_worker.py generate_stream). Every front end that
CONSUMES the stream (OpenAI API, web chat) parses it the same way —
this is the one implementation. The controller's proxy re-yields raw
bytes and keeps its own pass-through loop.
"""

from __future__ import annotations

import json
from typing import Iterator
from urllib import request as urlrequest

__all__ = ["iter_worker_stream"]


def iter_worker_stream(url: str, payload: dict,
                       timeout: int = 600) -> Iterator[dict]:
    """POST `payload` to a worker/controller stream endpoint and yield
    each \\0-delimited JSON message as a dict (incrementally — messages
    surface as the upstream flushes them, not after EOF)."""
    req = urlrequest.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urlrequest.urlopen(req, timeout=timeout) as r:
        buf = b""
        while True:
            block = r.read(4096)
            if not block:
                break
            buf += block
            while b"\0" in buf:
                part, buf = buf.split(b"\0", 1)
                if part:
                    yield json.loads(part)
