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

Over several ranks every rank calls `save` and `restore` at the same
steps: each element's state is gathered on every rank (`FullState` wraps
a sharded model or optimizer state: the full tensors under the names an
unsharded run gives them), only the `writer` (rank 0) writes, and the
ranks wait for the write before going on. A checkpoint so written is
today's format whatever the world size, and restores at any other: each
rank loads the whole state and keeps its shards.
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


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class FullState:
    """A Saver element over a model or an optimizer state that may hold
    shards (`parallel/mesh.py`): `state_dict` is the full state under the
    names an unsharded run gives it (every rank gathers it),
    `load_state_dict` keeps this rank's shards of a full state. `model`:
    the model whose placements an optimizer state's moments follow."""

    def __init__(self, element, model=None):
        self.element, self.model = element, model

    def state_dict(self):
        from ..parallel import mesh as M
        if self.model is None:
            return M.full_state_dict(self.element)
        return _opt_state(self.element, M.placements(self.model), True)

    @torch.no_grad()
    def load_state_dict(self, d) -> None:
        from ..parallel import mesh as M
        if self.model is None:
            M.load_full_state_dict(self.element, d)
        else:
            self.element.load_state_dict(
                _opt_state(d, M.placements(self.model), False,
                           like=self.element))


def _opt_state(state, place, gather: bool, like=None):
    """An optimizer state's moments gathered to full tensors (gather) or
    cut to this rank's shards (a full state, in the layout of `like`).
    A QuantLeaf's codes and scales hold the block dim last: a shard along
    another dim cuts them at that dim's place in that layout; the moments
    of a parameter that keeps them whole (`QuantAdamState.full`) pass."""
    from ..parallel import collectives as C
    from ..parallel.mesh import _shard_of
    src = state.state_dict() if gather else state
    whole = getattr(like if like is not None else state, "full", {})
    axes = getattr(like if like is not None else state, "axes", {})
    out = {k: v for k, v in src.items() if k not in ("mu", "nu")}
    for key in ("mu", "nu"):
        tree = {}
        for name, v in src[key].items():
            p = place.get(name)
            if p is None or p.axis is None or name in whole:
                tree[name] = v
                continue
            dim = p.dim
            if isinstance(v, dict):          # a QuantLeaf's q and scale
                nd = len(p.full_shape)
                b = axes.get(name, -1) % nd
                dim = nd - 1 if dim == b else (dim if dim < b else dim - 1)
            cut = ((lambda t: C.raw_all_gather(t, p.axis, dim)) if gather
                   else (lambda t: _shard_of(t, p.axis, dim)))
            tree[name] = ({f: cut(t) for f, t in v.items()}
                          if isinstance(v, dict) else cut(v))
        out[key] = tree
    return out


class Saver:
    """Checkpoint registry with interval ticks and retention."""

    def __init__(self, ckpt_dir, save_interval: Optional[int] = None,
                 keep_last: int = 2, writer: bool = True):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.writer = writer
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
        states = {name: el.state_dict() for name, el in
                  self._elements.items() if hasattr(el, "state_dict")}
        if not self.writer:
            _barrier()
            return out
        tmp = self.dir / f".tmp-model-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta: Dict[str, str] = {}
        for name, el in self._elements.items():
            if name in states:
                state = states[name]
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
        _barrier()
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
