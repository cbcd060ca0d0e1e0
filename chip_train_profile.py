#!/usr/bin/env python3
"""chip_smoke.py's 154M CompeteSMoE training cell in several checkouts, in
turns, on one CUDA GPU: to set a change beside its parent.

    python3 chip_train_profile.py TREE [TREE ...]

Each TREE is an unpacked checkout (for example the parent commit from
`git archive`). In each, in the order given and each in a process of its
own, this checkout's chip_smoke.py (copied into the tree, so that it runs
the tree's package) trains the cell for LM_STEPS steps (`phase_lm`) and
profiles two more (`profile_cell`). It prints one `train_profile` JSON
line a tree: the median ms of steps 1-7, the losses of every step, the
profiled steps' ms and losses, each TRAIN_GROUPS label's device ms a step
and the busy share; it exits non-zero if a tree's run fails.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
COPY = "_chip_smoke_train_profile.py"
CHILD = """
import json, sys
sys.path.insert(0, {tree!r})
import torch
import _chip_smoke_train_profile as cs
from competesmoe_tpu_torch import _kernels
torch.backends.cuda.matmul.allow_tf32 = False
_kernels.build(["gmm2_fused", "gmm2_bwd", "flash_attn"])
task, lm = cs.phase_lm(0)
prof = cs.profile_cell(task, "competesmoe")
print("train_profile " + json.dumps(dict(
    tree={tree!r}, card=cs.card_line(),
    median_ms_after_first=lm["ms_per_step_median_after_first"],
    losses=lm["losses"], profiled=prof["steps"],
    groups={{k: v["ms_per_step"] for k, v in prof["groups"].items()}},
    busy_share=prof["busy_share"])), flush=True)
"""


def main():
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    failed = []
    for tree in trees:
        shutil.copy(REPO / "chip_smoke.py", tree / COPY)
        res = subprocess.run([sys.executable, "-c",
                              CHILD.format(tree=str(tree))], cwd=tree,
                             capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("train_profile ")]
        if res.returncode != 0 or not lines:
            failed.append(str(tree))
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            continue
        print(lines[-1], flush=True)
        row = json.loads(lines[-1].split(" ", 1)[1])
        k1b = row["groups"]["K1 backward (dX + dW)"]
        print(f"{tree.name}: {row['median_ms_after_first']:.1f} ms/step "
              f"(steps 1-7); steps 8-9 "
              f"{[round(s['ms'], 1) for s in row['profiled']]} ms, losses "
              f"{[round(s['loss'], 6) for s in row['profiled']]}; K1's "
              f"backward {k1b:.3f} ms a step; busy "
              f"{row['busy_share']:.1%}", flush=True)
    for tree in failed:
        print(f"chip_train_profile: {tree} failed", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
