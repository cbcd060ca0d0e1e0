"""Sweep-YAML launcher (port of competesmoe_tpu/cli/run_sweep.py): reads a
W&B-sweep-style yaml (`parameters: {flag: {value: ...} | {values: [...]}}`)
and launches `competesmoe_tpu_torch.cli.main` with the resolved flags.
Grid values expand to one run per combination with `--grid` (else the
first combination runs). Flags after the file are appended to every run
(a later flag wins), e.g. the local shards of a streaming task:

    python -m competesmoe_tpu_torch.cli.run_sweep \
        sweeps/slimpajama_moe_no_attmoe_154M_competesmoe.yaml \
        -- -lm.shards 'data/slimpajama/*.jsonl.zst' -stop_after 1000

PyYAML is imported when a sweep is parsed.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
from typing import Dict, List


def parse_sweep(path: str) -> List[Dict[str, str]]:
    import yaml
    with open(path) as f:
        sweep = yaml.safe_load(f)
    params = sweep.get("parameters", {})
    fixed, grids = {}, {}
    for k, v in params.items():
        if isinstance(v, dict) and "value" in v:
            fixed[k] = v["value"]
        elif isinstance(v, dict) and "values" in v:
            grids[k] = v["values"]
        else:
            fixed[k] = v
    if not grids:
        return [fixed]
    combos = []
    keys = sorted(grids)
    for vals in itertools.product(*(grids[k] for k in keys)):
        d = dict(fixed)
        d.update(dict(zip(keys, vals)))
        combos.append(d)
    return combos


def to_argv(cfg: Dict) -> List[str]:
    argv = []
    for k, v in cfg.items():
        argv.extend([f"-{k}", str(v)])
    return argv


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sweep_yaml")
    ap.add_argument("--grid", action="store_true",
                    help="run every grid combination sequentially")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("extra", nargs="*", default=[])
    a = ap.parse_args(argv)
    runs = parse_sweep(a.sweep_yaml)
    if not a.grid:
        runs = runs[:1]
    for i, cfg in enumerate(runs):
        cmd = [sys.executable, "-m", "competesmoe_tpu_torch.cli.main",
               *to_argv(cfg), *a.extra]
        print(f"[sweep {i + 1}/{len(runs)}] {' '.join(cmd)}")
        if not a.dry_run:
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
