"""BENCHMARK.json's shape, the files it names, discovery by name, and the
result line a run prints."""

import json
import math
import re
import shutil
from types import SimpleNamespace

import pytest

from harness import main as hm
from harness import spec
from harness.stats import Record
from harness.trace import Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BM = spec.load_benchmark()


def test_keys_and_names():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["benchmark"]
    assert 1 <= BM["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BM[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    e2e = {m["name"] for m in BM["end_to_end"]}
    assert "setup_s" in e2e
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert m["moves"] in e2e


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BM["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_what_it_must():
    for w in BM["workloads"]:
        e2e = [m["name"] for m in spec.end_to_end(BM, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(BM, w["name"])
        for m in spec.per_layer(BM, w["name"]):
            assert m["moves"] in e2e
        spec.traffic_kind(spec.traffic(w["traffic"])["kind"])


def test_metric_files_agree_with_the_entries():
    for m in BM["per_layer"]:
        mod = spec.metric(m["name"])
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_a_new_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bm = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    (bench / "metrics" / "dummy_count.serve.py").write_text(
        "LAYER = 'engine (serve/engine.py)'\nMOVES = 'serve_tok_s'\n\n"
        "def read(run):\n    return 7.0\n")
    mix = dict(spec.traffic("chat-closed32"), clients=2)
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    bm["per_layer"].append({"name": "dummy_count.serve", "unit": "1",
                            "better": "higher", "source": "program_counter",
                            "layer": "engine (serve/engine.py)",
                            "moves": "serve_tok_s"})
    bm["workloads"].append({"name": "dummy-cell",
                            "config": "competesmoe-5.1b-int4",
                            "traffic": "dummy-mix", "chips": 1, "why": "x"})
    for m in bm["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dummy-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    monkeypatch.setattr(spec, "BENCH", bench)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "_MODULES", {})
    got = spec.load_benchmark(tmp_path / "BENCHMARK.json")
    names = [m["name"] for m in spec.per_layer(got, "dummy-cell")]
    assert "dummy_count.serve" in names
    assert spec.metric("dummy_count.serve").read(None) == 7.0
    assert spec.traffic("dummy-mix")["clients"] == 2
    assert spec.config(got, spec.cell(got, "dummy-cell")["config"])
    line = hm.result_line(_fake_run(), got, spec.cell(got, "dummy-cell"),
                          True, {"platform": "gpu", "kind": "x"})
    assert line["metrics"]["dummy_count.serve"] == {"value": 7.0,
                                                    "unit": "1"}


def _fake_run():
    from reference.weights import Geometry
    cfg = spec.config(BM, "competesmoe-5.1b-int4")
    r = Record(index=0, client=0, sent=0.0, prompt=300, max_new=3,
               greedy=True)
    r.times, r.tokens = [0.5, 0.6, 0.7], [4, 5, 6]
    trace = Trace(window_s=1.0, busy_s=0.8,
                  kernels=[("qmm4_kernel<...>", 0.0, 100.0)] * 128,
                  device_ops=[["qmm4_kernel<...>", 0.0128]],
                  idle_gaps=[["during cudaGraphLaunch", 0.01]])
    served = SimpleNamespace(records=[r], trace=trace,
                             decoder_rows=[((32, 1), {
                                 "quant_small_m_matmul_int4": 128})],
                             tower_rows=[],
                             live_slots=[32, 31], trace_window=(0.0, 1.0))
    return dict(correct=True, setup_s=80.0, memory_peak_bytes=1 << 34,
                window={"serve_tok_s": 300.0, "ttft_p50_ms": 250.0,
                        "ttft_p90_ms": 380.0, "ttft_p95_ms": 400.0,
                        "tpot_p95_ms": 110.0, "attempted": 10, "failed": 0},
                served=served, n_slots=32,
                geometry=Geometry.from_hf(cfg["hf_config"]),
                checks={"widest_gap": {"value": 0.01, "limit": 0.05}})


@pytest.mark.parametrize("workload", [w["name"] for w in BM["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line(trace, workload):
    cell = spec.cell(BM, workload)
    line = hm.result_line(_fake_run(), BM, cell, trace,
                          {"platform": "gpu", "kind": "NVIDIA H100"})
    text = json.dumps(line)
    back = json.loads(text)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    d = back["device"]
    assert d["platform"] == "gpu" and d["count"] == 1
    assert d["memory_peak_bytes"] == 1 << 34
    want = ({m["name"] for m in spec.per_layer(BM, cell["name"])} if trace
            else {m["name"] for m in spec.end_to_end(BM, cell["name"])})
    assert set(back["metrics"]) == want
    for v in back["metrics"].values():
        assert math.isfinite(v["value"])
    if trace:
        assert d["busy_s"] == 0.8 and d["window_s"] == 1.0
        assert set(back["breakdown"]) == {"device_ops", "idle_gaps"}
        if "k5_roofline" in want:
            assert 0 < back["metrics"]["k5_roofline"]["value"] <= 100
    else:
        assert "breakdown" not in back
        # an entry `<quantity>.<qualifier>` reports the run's <quantity>
        for name, v in back["metrics"].items():
            q = name.split(".")[0]
            assert v["value"] == (80.0 if q == "setup_s"
                                  else _fake_run()["window"][q])
