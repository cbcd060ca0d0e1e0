"""Named-element checkpoint registry, the `Saver` (port of
competesmoe_tpu/train/checkpoint.py).

- elements are registered by name (`saver["model"] = model`);
- an element whose `state_dict()` holds tensors (a module, the optimizer
  state) is written to `<name>.pt` with `torch.save` and read back with
  `torch.load(weights_only=True)` onto the tensors it replaces; one whose
  `state_dict()` holds plain values (the sampler) goes to `<name>.json`,
  as does a plain value (the run's args, the flip schedule);
- `save(step)` writes `model-<step>/` with a `META.json` into a temporary
  directory and renames it into place, so a reader never sees half a
  checkpoint; `keep_last` bounds how many stay;
- `tick(step)` saves every `save_interval` steps; `latest_step()` finds
  where to resume.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class _NpEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def _holds_tensors(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return True
    if isinstance(tree, dict):
        return any(_holds_tensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_holds_tensors(v) for v in tree)
    return False


class Saver:
    """Checkpoint registry with interval ticks and retention."""

    def __init__(self, ckpt_dir, save_interval: Optional[int] = None,
                 keep_last: int = 2):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_interval = save_interval
        self.keep_last = keep_last
        self._elements: Dict[str, Any] = {}

    def __setitem__(self, name: str, element: Any) -> None:
        self._elements[name] = element

    def __getitem__(self, name: str) -> Any:
        return self._elements[name]

    def __contains__(self, name: str) -> bool:
        return name in self._elements

    # -- save/load --

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"model-{step}"

    def save(self, step: int) -> Path:
        out = self._step_dir(step)
        tmp = self.dir / f".tmp-model-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta: Dict[str, str] = {}
        for name, el in self._elements.items():
            if hasattr(el, "state_dict"):
                state = el.state_dict()
                if _holds_tensors(state):
                    torch.save(state, tmp / f"{name}.pt")
                    meta[name] = "torch"
                else:
                    (tmp / f"{name}.json").write_text(
                        json.dumps(state, cls=_NpEncoder))
                    meta[name] = "json"
            else:
                (tmp / f"{name}.json").write_text(
                    json.dumps(el, cls=_NpEncoder))
                meta[name] = "json_value"
        (tmp / "META.json").write_text(json.dumps({"step": step,
                                                   "elements": meta}))
        if out.exists():
            shutil.rmtree(out)
        tmp.rename(out)  # atomic publish
        self._retain()
        return out

    def _retain(self) -> None:
        steps = self.saved_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def saved_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("model-*"):
            try:
                steps.append(int(p.name.split("-", 1)[1]))
            except ValueError:
                continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.saved_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> int:
        """Load every registered element that the checkpoint holds: a
        stateful element through its `load_state_dict`, a plain value by
        replacing it (read it back with `self[name]`). Returns the
        step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        src = self._step_dir(step)
        if not (src / "META.json").exists():
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.dir}")
        meta = json.loads((src / "META.json").read_text())
        for name, kind in meta["elements"].items():
            if name not in self._elements:
                continue
            el = self._elements[name]
            if kind == "torch":
                el.load_state_dict(torch.load(src / f"{name}.pt",
                                              map_location="cpu",
                                              weights_only=True))
            elif kind == "json":
                el.load_state_dict(
                    json.loads((src / f"{name}.json").read_text()))
            else:
                self._elements[name] = json.loads(
                    (src / f"{name}.json").read_text())
        return step

    def tick(self, step: int) -> Optional[Path]:
        """Save if `step` hits the interval."""
        if self.save_interval and step > 0 and step % self.save_interval == 0:
            return self.save(step)
        return None
