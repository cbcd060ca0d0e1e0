"""Where the harness finds what BENCHMARK.json names: a cell's
configuration file, its traffic mix and the generator of the mix's kind,
and each per-layer metric's reader. Every one is found by its name, so a
later configuration, mix or metric is a new file and a new entry, and no
file here changes."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
_MODULES: Dict[Path, ModuleType] = {}


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell(bm: dict, name: str) -> dict:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                   f"{', '.join(w['name'] for w in bm['workloads'])})")


def config(bm: dict, name: str) -> dict:
    """The configuration's file (`file` of its entry), as data."""
    for c in bm["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _load(path: Path, prefix: str) -> ModuleType:
    if path not in _MODULES:
        if not path.exists():
            raise FileNotFoundError(f"no file {path}")
        mod_name = prefix + re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def traffic_kind(kind: str) -> ModuleType:
    """The generator of a mix's `kind`: traffic/kinds/<kind>.py."""
    return _load(BENCH / "traffic" / "kinds" / f"{kind}.py", "bench_kind_")


def metric(name: str) -> ModuleType:
    """A per-layer metric's reader: metrics/<name>.py."""
    return _load(BENCH / "metrics" / f"{name}.py", "bench_metric_")


def end_to_end(bm: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those that list it, and
    those that list no cells."""
    return [m for m in bm["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bm: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and,
    where a metric lists no cells, every cell that reports the end-to-end
    metric it moves."""
    e2e = {m["name"] for m in end_to_end(bm, cell_name)}
    return [m for m in bm["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
