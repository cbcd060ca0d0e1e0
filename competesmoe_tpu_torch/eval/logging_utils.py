"""Experiment-tracking sink for eval results.

Re-design of `evaluate/lmms_eval/logging_utils.py:69` (WandbLogger):
posts per-task results and per-sample tables to wandb when the package is
importable, and always writes the same tables as JSON files so offline
runs keep the artifacts.

The port's own copy of competesmoe_tpu/eval/logging_utils.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class EvalResultsLogger:
    def __init__(self, output_dir, use_wandb: bool = False,
                 wandb_project: str = "", run_name: str = "",
                 wandb_args: Optional[dict] = None):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(
                    project=wandb_project or "competesmoe_tpu-eval",
                    name=run_name or None, **(wandb_args or {}))
            except Exception as e:
                print(f"wandb unavailable ({type(e).__name__}: {e}); "
                      "writing eval tables to JSON only", flush=True)

    def log_results(self, results: Dict[str, Any],
                    log_samples: bool = False) -> Path:
        """Persist the evaluator's results dict; mirror to W&B tables
        (logging_utils.py log_eval_result/log_eval_samples roles)."""
        stamp = time.strftime("%Y%m%d_%H%M%S")
        out = self.dir / f"results_{stamp}.json"
        payload = {"results": results.get("results", {}),
                   "groups": results.get("groups", {}),
                   "time_inference": results.get("time_inference")}
        if log_samples:
            payload["samples"] = results.get("samples", {})
        out.write_text(json.dumps(payload, indent=1, default=str))
        if self._wandb is not None:
            import wandb
            flat = {}
            for task, metrics in payload["results"].items():
                for metric, value in metrics.items():
                    if isinstance(value, (int, float)):
                        flat[f"{task}/{metric}"] = value
            self._wandb.log(flat)
            cols = ["task", "metric", "value", "stderr"]
            table = wandb.Table(columns=cols)
            for task, metrics in payload["results"].items():
                for metric, value in metrics.items():
                    if metric.endswith("_stderr"):
                        continue
                    if isinstance(value, (int, float)):
                        table.add_data(task, metric, value,
                                       metrics.get(f"{metric}_stderr"))
            self._wandb.log({"evaluation/results": table})
            if log_samples:
                for task, samples in payload.get("samples", {}).items():
                    st = wandb.Table(columns=["doc_id", "filtered"])
                    for s in samples[:512]:
                        st.add_data(s.get("doc_id"),
                                    str(s.get("filtered")))
                    self._wandb.log({f"samples/{task}": st})
        return out

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
