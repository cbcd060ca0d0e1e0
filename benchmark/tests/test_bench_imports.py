"""What the benchmark loads: no module whose top-level name, compared
whole, is jax, jaxlib, flax or the JAX package competesmoe_tpu (the port,
competesmoe_tpu_torch, begins with that name and passes); and the
reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from harness.main import FORBIDDEN, forbidden_modules

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

_PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str):
    code = _PROBE.format(bench=BENCH, root=ROOT, body=body)
    env = dict(os.environ, USE_FLAX="0", USE_JAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    body = """
from harness import main, serve, spec, stats, trace, peaks
import calibrate
bm = spec.load_benchmark()
for m in bm["per_layer"]:
    spec.metric(m["name"])
for w in bm["workloads"]:
    spec.traffic_kind(spec.traffic(w["traffic"])["kind"])
from competesmoe_tpu_torch.models import builder, llava
from competesmoe_tpu_torch.serve import engine, model_worker
from competesmoe_tpu_torch.utils import cuda_graph
from reference import llava as ref, quant, weights
"""
    names = _top_level(body)
    assert "competesmoe_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level("from reference import llava, quant, weights")
    assert "torch" in names
    assert not names & ({"competesmoe_tpu_torch", "harness"} | set(FORBIDDEN))


def test_names_compare_whole(monkeypatch):
    fake = dict(sys.modules)
    fake["competesmoe_tpu_torch.models"] = sys
    monkeypatch.setattr(sys, "modules", fake)
    assert forbidden_modules() == []
    fake["competesmoe_tpu.ops"] = sys
    fake["jaxlib"] = sys
    assert forbidden_modules() == ["competesmoe_tpu", "jaxlib"]
