"""The readers of the program's span recorder (`competesmoe_tpu_torch.
utils.spans`): on synthetic records, each reads only the part of a traced
window after the profiler stopped, the tick interval leaves out an
interval holding an idle wait, and each reads None without records, in
an untraced run and where the program has no recorder. A whole traced
serving run at a small size on the CPU gives numbers from the three
host-time readers and None from the two device readers."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from harness import serve, spec

from competesmoe_tpu_torch.utils import spans

HOST = ("queue_wait_p90_ms.serve", "first_token_p90_ms.serve",
        "tick_interval_p95_ms.serve")
DEVICE = ("step_device_ms.serve", "prefill_device_pct.docs")

# the traced run's profiled part ends at P1; its window at W1
P1, W1 = 100.0, 110.0


def _run(trace_window=(97.0, P1), w1=W1):
    return SimpleNamespace(served=SimpleNamespace(trace_window=trace_window,
                                                  w1=w1))


def _read(name, run):
    return spec.metric(name).read(run)


def _request(rec, submit, admit, first):
    r = spans.RequestRecord(len(rec.requests), submit)
    r.admit, r.first = admit, first
    rec.requests.append(r)


def _launch(rec, kind, start, device_s=None):
    w = spans.Launch(kind, start, None, [])
    w.device_s = device_s
    rec.launches.append(w)


def _idle(rec, start):
    rec.spans.append(spans.Span(len(rec.spans), None, "engine.idle", start,
                                start + 0.05, {}))


@pytest.fixture
def rec(monkeypatch):
    r = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", r)
    return r


def test_admission_readers_take_the_requests_admitted_after_the_profiler(
        rec):
    # admitted while profiled, and after the window: left out
    _request(rec, 98.0, 99.0, 99.5)
    _request(rec, 109.0, 111.0, 111.5)
    # ten admitted in the span: waits 10..100 ms, first tokens 1..10 ms
    for i in range(1, 11):
        t = 100.0 + i * 0.5
        _request(rec, t - i * 0.01, t, t + i * 0.001)
    # admitted, no first token yet: a wait, no first-token time
    _request(rec, 107.0, 107.2, None)
    waits = sorted([i * 10.0 for i in range(1, 11)] + [200.0])
    got = _read("queue_wait_p90_ms.serve", _run())
    assert got == pytest.approx(waits[9])
    assert _read("first_token_p90_ms.serve", _run()) == pytest.approx(9.0)


def test_tick_interval_leaves_out_intervals_that_hold_an_idle_wait(rec):
    # four runs of launches 100 ms apart, 2.1 s between runs with an idle
    # wait in each gap, and one launch before the span
    starts = [99.9] + [100.0 + 3 * k + 0.1 * i for k in range(4)
                       for i in range(10)]
    for t in starts:
        _launch(rec, "step", t)
    _launch(rec, "admit", 100.05)        # not a step
    for k in range(3):
        _idle(rec, 101.5 + 3 * k)
    got = _read("tick_interval_p95_ms.serve", _run())
    assert got == pytest.approx(100.0)
    rec.spans.clear()
    assert _read("tick_interval_p95_ms.serve", _run()) > 1000.0


def test_device_readers_sum_and_median_the_events_times(rec):
    for i, d in enumerate([0.1, 0.12, 0.11, 0.3]):
        _launch(rec, "step", 100.5 + i, device_s=d)
    _launch(rec, "step", 99.0, device_s=5.0)        # profiled: left out
    _launch(rec, "admit", 101.0, device_s=0.5)
    _launch(rec, "admit", 102.0, device_s=1.5)
    _launch(rec, "admit", 110.5, device_s=9.0)      # after the window
    assert _read("step_device_ms.serve", _run()) == pytest.approx(115.0)
    assert _read("prefill_device_pct.docs", _run()) == pytest.approx(20.0)


def test_device_readers_read_none_off_the_card(rec):
    _launch(rec, "step", 101.0)
    _launch(rec, "admit", 101.5)
    assert all(_read(m, _run()) is None for m in DEVICE)


@pytest.mark.parametrize("name", HOST + DEVICE)
def test_none_without_records_untraced_or_without_a_recorder(
        rec, monkeypatch, name):
    assert _read(name, _run()) is None
    _request(rec, 100.5, 101.0, 101.2)
    _launch(rec, "step", 101.0, device_s=0.1)
    _launch(rec, "step", 101.1, device_s=0.1)
    _launch(rec, "admit", 101.0, device_s=0.1)
    assert _read(name, _run()) is not None
    assert _read(name, _run(trace_window=None)) is None
    monkeypatch.setitem(sys.modules, "competesmoe_tpu_torch.utils.spans",
                        None)
    assert _read(name, _run()) is None


def test_a_traced_small_run_on_the_cpu():
    from small_cell import CELL, CFG, MIX

    torch.set_num_threads(4)
    t = time.perf_counter()
    run = serve.run({}, CELL, 2 ** 31 + 11, 3.0, True, device="cpu",
                    cfg=CFG, params=dict(MIX, trace_s=0.5))
    served = run["served"]
    assert served.trace_window[0] > t and served.trace_window[1] < served.w1
    ctx = SimpleNamespace(**run)
    for name in HOST:
        v = _read(name, ctx)
        assert v is not None and 0 <= v < 3000, name
    assert all(_read(name, ctx) is None for name in DEVICE)
