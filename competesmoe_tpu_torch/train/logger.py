"""Metrics logging (port of the JSONL part of
competesmoe_tpu/train/logger.py): `MetricLogger` appends one JSON record
per call to `<log_dir>/log_trainer.jsonl` and prints a line at the stdout
interval. TensorBoard, W&B and the async logger wait (ROADMAP open item
1.1).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir, stdout_interval: int = 1):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "log_trainer.jsonl", "a")
        self.stdout_interval = stdout_interval

    def log(self, step: int, metrics: Dict[str, float],
            to_stdout: Optional[bool] = None) -> None:
        rec = {"step": int(step), "time": time.time()}
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                continue
        rec.update(scalars)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        show = to_stdout if to_stdout is not None else (
            self.stdout_interval and step % self.stdout_interval == 0)
        if show:
            parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(scalars.items())
                             if not k.startswith("layer"))
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        self._jsonl.close()


def device_memory_stats() -> Dict[str, float]:
    """Peak and in-use CUDA memory in MB (empty without a GPU)."""
    import torch
    if not torch.cuda.is_available():
        return {}
    return {"memory/peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "memory/in_use_mb": torch.cuda.memory_allocated() / 2 ** 20}


class ElapsedTimeMeter:
    """Accumulating wall-clock meter."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        self._t0 = None

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total / max(self.count, 1)

    def reset(self):
        self.total = 0.0
        self.count = 0
