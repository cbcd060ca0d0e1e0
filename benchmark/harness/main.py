"""One run of one cell: `python benchmark/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>`, from the root of a checkout.

The cell's configuration file names its runner (`"runner": "serve"` is
`harness/serve.py`). An end-to-end metric named `<quantity>.<qualifier>`
reports the runner's `<quantity>`: the qualifier only tells apart the
entries of cells whose runs spread differently, each with its own bound.
The run prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device` (and, traced, `breakdown`), and last `checks`: each number the
output check compared, with its limit. The same numbers are the last lines
of standard error. Without a CUDA device, or with fewer than the cell
asks for, or when the process holds JAX or the JAX package once the
window has closed, it prints no result and exits with another code than
0.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from types import SimpleNamespace

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "competesmoe_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (competesmoe_tpu_torch is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card() -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(res.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(run: dict, bm: dict, cell: dict, trace: bool,
                device: dict) -> dict:
    """The result object of a finished run (see the module docstring)."""
    metrics = {}
    if not trace:
        for m in spec.end_to_end(bm, cell["name"]):
            quantity = m["name"].split(".")[0]
            v = (run["setup_s"] if quantity == "setup_s"
                 else run["window"].get(quantity))
            if v is None:
                raise RuntimeError(f"the run measured no {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(**run)
        for m in spec.per_layer(bm, cell["name"]):
            v = spec.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(run["correct"]),
           "attempted": run["window"]["attempted"],
           "failed": run["window"]["failed"], "metrics": metrics,
           "device": dict(device, count=cell["chips"],
                          memory_peak_bytes=run["memory_peak_bytes"])}
    t = run["served"].trace if trace else None
    if t is not None:
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": t.idle_gaps}
    out["checks"] = run["checks"]
    return out


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch
    bm = spec.load_benchmark()
    cell = spec.cell(bm, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 3
    cfg = spec.config(bm, cell["config"])
    runner = importlib.import_module(f"harness.{cfg['runner']}")
    run = runner.run(bm, cell, args.seed, args.seconds, bool(args.trace),
                     device="cuda", cfg=cfg, t_start=t_start)
    line = result_line(run, bm, cell, bool(args.trace), card())
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark runs the "
              "PyTorch port alone", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
