"""The window's arithmetic: rates over all the window's time, tails over
all its requests, failures as misses."""

import math

from harness.stats import Record, percentile, window_metrics


def _stream(times, sent=0.0, max_new=None):
    r = Record(index=0, client=0, sent=sent, prompt=10,
               max_new=max_new or len(times), greedy=True)
    r.times = list(times)
    r.tokens = [1] * len(times)
    return r


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = [_stream([i * 0.01 for i in range(1000)])]
    stalled = [_stream([i * 0.01 + (2.0 if i >= 500 else 0.0)
                        for i in range(1000)])]
    a = window_metrics(steady, 1.0, 9.0)["serve_tok_s"]
    b = window_metrics(stalled, 1.0, 9.0)["serve_tok_s"]
    assert math.isclose(a, 100.0, rel_tol=1e-9)
    assert b < a * 0.8


def test_p95_is_over_all_requests():
    recs = [_stream([0.5 + i / 1000.0, 0.6 + i / 1000.0], sent=0.5)
            for i in range(100)]
    m = window_metrics(recs, 0.0, 10.0)
    ttft = sorted((r.times[0] - r.sent) * 1e3 for r in recs)
    assert m["n_ttft"] == 100
    assert math.isclose(m["ttft_p95_ms"], ttft[94])
    assert math.isclose(m["ttft_p90_ms"], ttft[89])
    assert math.isclose(m["ttft_p50_ms"], ttft[49])
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([1.0] * 19 + [50.0], 95) == 1.0
    assert percentile([1.0] * 18 + [50.0, 60.0], 95) == 50.0
    assert percentile([1.0] * 9 + [50.0], 90) == 1.0
    assert percentile([1.0] * 8 + [50.0, 60.0], 90) == 50.0


def test_failed_requests_miss_every_limit():
    recs = [_stream([0.5 + i / 100, 0.6 + i / 100], sent=0.5 + i / 100)
            for i in range(10)]
    bad = _stream([], sent=1.0, max_new=5)
    bad.failed = True
    m = window_metrics(recs + [bad], 0.0, 10.0)
    assert m["failed"] == 1 and m["attempted"] == 11
    assert m["ttft_p95_ms"] == math.inf and m["tpot_p95_ms"] == math.inf


def test_tpot_counts_requests_that_finish_in_the_window():
    done = _stream([1.0, 1.1, 1.2, 1.3])                 # 100 ms a token
    cut = _stream([1.0, 1.5], max_new=10)                # did not finish
    late = _stream([8.0, 12.0])                          # ends after
    m = window_metrics([done, cut, late], 0.0, 10.0)
    assert m["n_tpot"] == 1
    assert math.isclose(m["tpot_p95_ms"], 100.0)
