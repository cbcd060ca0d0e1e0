"""The span and counter recorder (`utils/spans.py`) and the serving
engine's spans, on a small random LLaVA model.

A scripted engine run (`run_thread=False`) nests every engine span under
`engine.tick` with the right parent, stamps each admitted request's
submit, admission-group start and first token in that order under one id,
and counts in `stats()` exactly the decode steps, admission groups and
prefill rows it ran. The rings keep their newest records. Under a torch
profiler recording every thread, the engine thread's spans are
`record_function` ranges of the same names; with no profiler active, no
range is entered. On the card (marker `gpu`), a decode step's device time
is read from its CUDA events without a synchronising call, and lies
within the host interval that held the step.

The file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_spans.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from competesmoe_tpu_torch.constants import IMAGE_TOKEN_INDEX
from competesmoe_tpu_torch.models.builder import (HF_5P1B, build_llava,
                                                  llava_config_from_hf)
from competesmoe_tpu_torch.serve.engine import DecodeEngine
from competesmoe_tpu_torch.utils import spans

SMALL = dict(HF_5P1B, vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, mm_hidden_size=32,
             vision_config=dict(hidden_size=32, intermediate_size=64,
                                num_hidden_layers=1, num_attention_heads=2,
                                image_size=28, patch_size=14))

# each engine span's possible parents
PARENTS = {
    "engine.tick": {None},
    "engine.admit": {"engine.tick"},
    "engine.admit_group": {"engine.admit"},
    "engine.step": {"engine.tick"},
    # at pipeline depth 2 an admission group drains the oldest call
    "engine.drain": {"engine.tick", "engine.admit_group"},
    "engine.wait_device": {"engine.drain", "engine.admit_group"},
    "engine.idle": {"engine.tick"},
}


def _model(device="cpu", dtype=torch.float32):
    return build_llava(llava_config_from_hf(SMALL, "llava_phi", dtype),
                       device=device)


@pytest.fixture(scope="module")
def model():
    return _model()


def _ids(n, salt):
    return (3 + (salt * 31 + np.arange(n)) % 100).astype(np.int32)


def _image_ids(n, salt):
    ids = _ids(n, salt)
    ids[1] = IMAGE_TOKEN_INDEX
    return ids


def _scripted(engine, reqs, ticks=200):
    """Submit `reqs` [(ids, pixels, max_new)] and tick until every one is
    done and one idle tick has passed; returns (requests, t0, t1)."""
    t0 = time.perf_counter()
    made = [engine._make_request(ids, px, max_new_tokens=n)
            for ids, px, n in reqs]
    for _ in range(ticks):
        if all(r.done for r in made):
            break
        engine._tick()
    engine._tick()
    assert all(r.done for r in made)
    return made, t0, time.perf_counter()


def _traffic():
    px = np.random.default_rng(0).normal(size=(1, 28, 28, 3)).astype(
        np.float32)
    return [(_ids(5, 1), None, 4), (_ids(9, 2), None, 3),
            (_image_ids(6, 3), px, 5), (_ids(40, 4), None, 4),
            (_ids(12, 5), None, 2)]


ENGINES = {"depth1": dict(), "depth2": dict(pipeline_depth=2),
           "chunk8-park2": dict(prefill_chunk=8, prefix_cache_slots=2)}


@pytest.mark.parametrize("opts", list(ENGINES.values()), ids=list(ENGINES))
def test_engine_spans_nest_under_the_tick(model, opts):
    """Every engine span of a scripted run has a parent its layer allows,
    lies inside that parent in time, and descends from an engine.tick;
    admission groups, steps and an idle wait all occur."""
    engine = DecodeEngine(model, n_slots=2, max_len=96, run_thread=False,
                          **opts)
    _, t0, t1 = _scripted(engine, _traffic())
    got = [s for s in spans.RECORDER.between("spans", t0, t1)
           if s.name.startswith("engine.")]
    by_id = {s.id: s for s in got}
    names = {s.name for s in got}
    assert {"engine.tick", "engine.admit", "engine.admit_group",
            "engine.step", "engine.drain", "engine.idle"} <= names
    for s in got:
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) in PARENTS[s.name], s
        if parent is not None:
            assert parent.start <= s.start <= s.end <= parent.end
        while parent is not None and parent.name != "engine.tick":
            parent = by_id.get(parent.parent)
        assert s.name == "engine.tick" or parent is not None


@pytest.mark.parametrize("opts", list(ENGINES.values()), ids=list(ENGINES))
def test_requests_are_stamped_in_order_under_one_id(model, opts):
    """Each request's record reads submit <= admission-group start <=
    first token, and its id is on the admission group span (the first
    chunk's, for a chunked prompt) that holds that start."""
    engine = DecodeEngine(model, n_slots=2, max_len=96, run_thread=False,
                          **opts)
    made, t0, t1 = _scripted(engine, _traffic())
    groups = [s for s in spans.RECORDER.between("spans", t0, t1)
              if s.name == "engine.admit_group"]
    assert len({r.rid for r in made}) == len(made)
    for req in made:
        rec = req.rec
        assert rec.rid == req.rid
        assert rec.submit <= rec.admit <= rec.first <= t1
        holding = [g for g in groups if req.rid in g.attrs["rids"]]
        assert holding
        first = min(holding, key=lambda g: g.start)
        assert first.start <= rec.admit <= first.end


def test_stats_count_the_ticks_groups_and_rows_of_a_scripted_run(model):
    """Three text prompts of one bucket and an image prompt, submitted
    before the first tick, admit as two groups of 3 and 1 rows; answers
    of 3 tokens take two decode steps after the admission's first token;
    the idle tick launches none. The queue wait is the records' sum."""
    engine = DecodeEngine(model, n_slots=4, max_len=96, run_thread=False)
    px = np.zeros((1, 28, 28, 3), np.float32)
    reqs = [(_ids(5, 1), None, 3), (_ids(9, 2), None, 3),
            (_ids(17, 3), None, 3), (_image_ids(6, 4), px, 3)]
    made, _, _ = _scripted(engine, reqs)
    st = engine.stats()
    assert st["engine_ticks"] == 2
    assert st["engine_admit_groups"] == 2
    assert st["engine_prefill_rows"] == 4
    assert st["engine_queue_wait_s"] == pytest.approx(
        sum(r.rec.admit - r.rec.submit for r in made))
    assert "engine_tokens_per_sec_lifetime" not in st
    engine.warmup(prompt_buckets=(32,), sampled=False)
    st = engine.stats()
    assert (st["engine_ticks"], st["engine_admit_groups"],
            st["engine_prefill_rows"], st["engine_queue_wait_s"]) == (
                0, 0, 0, 0.0)


def test_rings_drop_their_oldest_records_at_their_bound():
    rec = spans.Recorder(spans=3, requests=2, launches=2)
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
        rec.request(i)
        rec.launch(f"k{i}", "cpu").end()
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4"]
    assert [r.rid for r in rec.requests] == [3, 4]
    assert [w.kind for w in rec.launches] == ["k3", "k4"]
    assert all(w.device_s is None and w.done() for w in rec.launches)


def test_between_picks_records_by_time():
    rec = spans.Recorder()
    with rec.span("a"):
        pass
    r = rec.request(7)
    mid = time.perf_counter()
    with rec.span("b"):
        pass
    r.admit = time.perf_counter()
    end = time.perf_counter()
    assert [s.name for s in rec.between("spans", mid, end)] == ["b"]
    assert rec.between("requests", mid, end) == [r]
    assert rec.between("requests", 0.0, mid) == []


def test_profiler_ranges_hold_the_engine_threads_spans(model):
    """Under a profiler recording every thread, the engine thread's spans
    appear as record_function ranges of the same names."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    engine = DecodeEngine(model, n_slots=2, max_len=96)
    try:
        engine.warmup(prompt_buckets=(32,), sampled=False)
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            got = list(engine.submit(_ids(7, 9), max_new_tokens=4))
    finally:
        engine.shutdown()
    assert engine.error is None and len(got) == 4
    assert not engine._thread.is_alive()
    names = {e.name for e in prof.events()}
    assert {"engine.tick", "engine.admit", "engine.admit_group",
            "engine.step", "engine.drain"} <= names


def test_no_range_is_entered_without_a_profiler(model, monkeypatch):
    """With no profiler active a scripted run enters no record_function
    range; with the profiler's flag up, every span enters one."""
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans._profiler, "record_function", Range)
    engine = DecodeEngine(model, n_slots=2, max_len=96, run_thread=False)
    _, t0, t1 = _scripted(engine, _traffic()[:2])
    assert entered == []
    monkeypatch.setattr(spans._profiler, "_is_profiler_enabled", True)
    _, t0, t1 = _scripted(engine, _traffic()[:2])
    recorded = [s.name for s in spans.RECORDER.between("spans", t0, t1)
                if s.name.startswith("engine.")]
    assert recorded and sorted(entered) == sorted(recorded)


def test_spans_of_two_threads_keep_their_own_parents():
    """Spans opened on two threads at once take their parents from their
    own thread."""
    rec = spans.Recorder()
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with rec.span(f"outer{tag}"):
            barrier.wait()
            with rec.span(f"inner{tag}"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    by_name = {s.name: s for s in rec.spans}
    for tag in "ab":
        assert by_name[f"inner{tag}"].parent == by_name[f"outer{tag}"].id


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_step_device_time_is_read_without_a_sync_inside_its_tick():
    """A pipelined engine's decode steps, replayed CUDA graphs: each
    step's device time is read from its events while ticks run under the
    sync detector, and lies inside the host interval from its launch to
    the end of the next tick, which read its tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    engine = DecodeEngine(_model("cuda", torch.bfloat16), n_slots=4,
                          max_len=64, pipeline_depth=2, run_thread=False)
    reqs = [engine._make_request(_ids(n, n), max_new_tokens=12)
            for n in (5, 9, 17)]
    engine._tick()                           # admission, the first capture
    engine._tick()
    ticks = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(6):
            t0 = time.perf_counter()
            engine._tick()
            ticks.append((t0, time.perf_counter()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps = spans.RECORDER.between("launches", ticks[0][0], ticks[-1][1])
    steps = [w for w in steps if w.kind == "step"]
    assert len(steps) == 6
    for i, w in enumerate(steps[:-1]):
        assert w.device_s is not None and w.device_s > 0
        assert ticks[i][0] <= w.start
        assert w.device_s <= ticks[i + 1][1] - w.start
    for _ in range(20):
        engine._tick()
    assert all(r.done and len(r.emitted) == 12 for r in reqs)
    assert steps[-1].device_s is not None
