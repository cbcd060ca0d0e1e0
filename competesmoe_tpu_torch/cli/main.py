"""Pretraining entry point (port of competesmoe_tpu/cli/main.py): parse the
dotted flags, look up the task, train or test.

    python -m competesmoe_tpu_torch.cli.main -task synthetic_transformer \\
        -stop_after 100 [-device cpu] ...

Runs on the GPU unless `-device cpu` (or `--device cpu`) is given.
"""

from __future__ import annotations

import json


def main(argv=None) -> None:
    from ..train.lm_task import get_task
    from ..utils.argparser import build_parser

    a = build_parser().parse(argv)
    t = get_task(a.task)(a)
    if a.test_only:
        print(json.dumps(t.test()))
    else:
        t.train()


if __name__ == "__main__":
    main()
