#!/usr/bin/env python3
"""Run one cell of the benchmark of competesmoe_tpu_torch once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout; see harness/main.py for what it prints.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# caches at fixed paths inside the checkout (the kernels' own build
# directory, competesmoe_tpu_torch/_build, is there already)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path[:0] = [HERE, ROOT]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
