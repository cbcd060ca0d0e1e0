"""Metrics logging (port of competesmoe_tpu/train/logger.py): a JSONL
history, and TensorBoard and W&B mirrors.

`MetricLogger` appends one JSON record per call to
`<log_dir>/log_trainer.jsonl` (always the machine-readable record) and
prints a line at the stdout interval. With `use_tensorboard` it mirrors
the scalars through tensorboardX into `<log_dir>/tb`, and with
`use_wandb` through W&B; each is imported when the logger is made, and a
missing package leaves that sink off (W&B prints one "wandb unavailable"
line, as in JAX). `AsyncMetricLogger` writes from a background thread so
the train loop never waits on the sinks. `device_memory_stats` reads the
CUDA allocator.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir, use_tensorboard: bool = True,
                 use_wandb: bool = False, wandb_project: str = "",
                 run_name: str = "", stdout_interval: int = 1):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "log_trainer.jsonl", "a")
        self.stdout_interval = stdout_interval
        self._tb = None
        self._wandb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(str(self.dir / "tb"))
            except ImportError:
                self._tb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(
                    project=wandb_project or "competesmoe_tpu",
                    name=run_name or self.dir.name,
                    dir=str(self.dir), resume="allow")
            except Exception as e:
                print(f"wandb unavailable ({type(e).__name__}: {e}); "
                      "metrics continue to JSONL/TB", flush=True)
                self._wandb = None

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
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        show = to_stdout if to_stdout is not None else (
            self.stdout_interval and step % self.stdout_interval == 0)
        if show:
            parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(scalars.items())
                             if not k.startswith("layer"))
            print(f"[step {step}] {parts}", flush=True)

    def write_record(self, rec: Dict) -> None:
        """One JSON line into the history (a plots record)."""
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The logger of a rank other than 0 in a multi-rank run: it writes
    nothing."""

    _tb = _wandb = None

    def log(self, step, metrics, to_stdout=None) -> None:
        pass

    def write_record(self, rec) -> None:
        pass

    def close(self) -> None:
        pass


class AsyncMetricLogger(MetricLogger):
    """MetricLogger with a background writer thread so TB/W&B/JSONL IO
    never blocks the train step (the reference's AsyncLogger process,
    visualize/plot.py:619-977, as a thread — sufficient since the writes
    are IO-bound)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._q: queue.Queue = queue.Queue(maxsize=256)
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, dict):
                MetricLogger.write_record(self, item)
                continue
            step, metrics, to_stdout = item
            MetricLogger.log(self, step, metrics, to_stdout)

    def log(self, step, metrics, to_stdout=None):
        self._q.put((int(step), dict(metrics), to_stdout))

    def write_record(self, rec):
        self._q.put(rec)

    def close(self):
        self._q.put(None)
        self._t.join(timeout=10)
        MetricLogger.close(self)


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
