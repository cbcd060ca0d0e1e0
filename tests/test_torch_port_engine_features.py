"""Parity of the PyTorch port's DecodeEngine features with the JAX package's:
chunked prefill, the prefix cache, adaptive speculation and warmup, driven
tick by tick on the CPU with the same weights (`convert.from_jax_params`)
and the same numpy traffic from a seed; and the worker's flags that turn
them on. Greedy tokens must be identical, and so must every stats value
that does not depend on the wall clock.
"""

import dataclasses
import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.serve import engine as jengine
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.serve import engine as tengine
from tests.test_llava import tiny_llava_cfg
from tests.test_torch_port_models import IMG, port_llava_cfg
from tests.test_torch_port_serving import _drive


@pytest.fixture(scope="module")
def tiny_engine_model():
    """A copy of test_torch_port_serving's fixture of the same name (the
    model of tests/test_engine.py), its parameters initialised under
    jax.jit, which takes a third of the time: the JAX model and the
    port's model with the same weights."""
    cfg = tiny_llava_cfg(moe=False)
    jm = jllava.LlavaModel(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray([[5, IMG, 7, 8]], jnp.int32),
                              jnp.zeros((1, 28, 28, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = tllava.LlavaModel(port_llava_cfg(cfg), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jm, params, model


@pytest.fixture(scope="module")
def tiny_engine_model_int4(tiny_engine_model):
    """A copy of test_torch_port_serving's fixture: the engine model
    served as the worker's --load-4bit with an int8 KV cache, JAX's
    builder transforms against the port's apply_load_4bit."""
    jm, params, _ = tiny_engine_model
    cfg = dataclasses.replace(jm.cfg, decoder=dataclasses.replace(
        jm.cfg.decoder, kv_quant="int8"))
    model = tllava.LlavaModel(port_llava_cfg(cfg), device="cpu")
    model.load_state_dict(from_jax_params(params))
    tbuilder.apply_load_4bit(model)
    p = params["params"]
    params = {"params": {
        "language_model": jbuilder.quantize_decoder_to_int8(
            p["language_model"], bits=4),
        **jbuilder.quantize_nf4_weight_only(
            {k: v for k, v in p.items() if k != "language_model"})}}
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, quant="int4"))
    assert model.language_model.layers[0].self_attn.qkv_proj.mode == "int4"
    return jllava.LlavaModel(cfg), params, model


def _tick_clock():
    """A clock that advances by 1 per reading. A tick with speculation
    reads it twice (its start and its record), so each arm's tokens/s
    estimate is its tokens per tick: the bandit's choices are arithmetic,
    the same on both engines."""
    c = itertools.count()
    return lambda: float(next(c))


def _garbage_draft(history, k):
    """Drafts the tiny model essentially never predicts."""
    return np.full(k, 61, np.int32)


def _chunk_traffic(seed=31):
    """Short text prompts beside prompts longer than a 16-token chunk (23,
    40 and 37 tokens: partial last chunks); the last three arrive while
    the first decode."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 60, n).astype(np.int32), None, m)
            for n, m in ((5, 6), (23, 5), (9, 6), (40, 5), (37, 4))]


def _multiturn(engine, seed=30):
    """Three conversations (one with an image) of two turns each: turn 2
    is turn 1's prompt, its reply and 3 new tokens. With 2 park slots the
    third retirement evicts the first, so the first conversation's
    follow-up misses while the image one and the last one hit together
    (one grouped unpark); a fourth follow-up repeats the image
    conversation with another image and must not hit. Returns every
    request's tokens."""
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    px_other = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    turn1 = [(rng.integers(1, 60, 8).astype(np.int32), None, 3),
             (np.array([5, IMG, 7, 8, 9], np.int32), px, 6),
             (rng.integers(1, 60, 12).astype(np.int32), None, 4)]
    out1 = _drive(engine, turn1, first=3)
    turn2 = [(np.concatenate([ids, np.asarray(out, np.int32),
                              rng.integers(1, 60, 3).astype(np.int32)]),
              p, 5) for (ids, p, _), out in zip(turn1, out1)]
    turn2 = turn2[1:] + turn2[:1] + [(turn2[1][0], px_other, 4)]
    return out1 + _drive(engine, turn2, first=2)


def _repetitive_traffic(seed=33):
    rng = np.random.default_rng(seed)
    return [(np.tile(rng.integers(1, 60, 3), 4).astype(np.int32), None, 12)
            for _ in range(3)]


# the port's own stats() counters, beside the JAX engine's keys
COUNTERS = ("engine_ticks", "engine_admit_groups", "engine_prefill_rows",
            "engine_queue_wait_s")


def _same_stats(te, je):
    """The port's stats() equal the JAX engine's over every key JAX
    reports but its wall-clock rate, which the port does not report; the
    port adds only its counters."""
    want, got = je.stats(), te.stats()
    want.pop("engine_tokens_per_sec_lifetime")
    assert "engine_tokens_per_sec_lifetime" not in got
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == set(COUNTERS)


def _counted(engine):
    """Counts of the port engine's decode steps, admission groups and
    their rows, taken around the methods that run them (a group, a
    prefix-cache group, a prefill chunk)."""
    n = {"engine_ticks": 0, "engine_admit_groups": 0,
         "engine_prefill_rows": 0}

    def around(name, rows=None):
        fn = getattr(engine, name)

        def wrapped(*a):
            if rows is None:
                n["engine_ticks"] += 1
            else:
                n["engine_admit_groups"] += 1
                n["engine_prefill_rows"] += rows(a)
            return fn(*a)
        setattr(engine, name, wrapped)
    around("_step")
    around("_admit_group", lambda a: len(a[1]))
    around("_admit_reused_group", lambda a: len(a[1]))
    around("_chunk_prefill", lambda a: 1)
    return n


CASES = {
    "chunk16": (dict(prefill_chunk=16), "chunk"),
    "chunk16-spec2": (dict(prefill_chunk=16, spec_k=2), "chunk"),
    "chunk16-int4": (dict(prefill_chunk=16, load_4bit=True), "chunk"),
    "park2": (dict(prefix_cache_slots=2), "multiturn"),
    "park2-pipeline2": (dict(prefix_cache_slots=2, pipeline_depth=2),
                        "multiturn"),
    "adaptive-garbage": (dict(spec_k=3, draft_fn=_garbage_draft,
                              steps_per_call=4, spec_adaptive=True,
                              spec_probe_interval=6), "repetitive"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_features_match_jax_tick_by_tick(request, case):
    """Two slots; the port's greedy streams equal JAX's engine token for
    token, and so do the stats (prefix hits, chunked-prefill queue,
    verify calls, accepted drafts, suppressed ticks and each arm's
    tokens/s under one fake clock per engine)."""
    opts, traffic = CASES[case]
    opts = dict(opts)
    jm, params, model = request.getfixturevalue(
        "tiny_engine_model_int4" if opts.pop("load_4bit", False)
        else "tiny_engine_model")
    if opts.get("spec_adaptive"):
        engines = (jengine.DecodeEngine(jm, params, n_slots=2, max_len=96,
                                        run_thread=False,
                                        clock=_tick_clock(), **opts),
                   tengine.DecodeEngine(model, n_slots=2, max_len=96,
                                        run_thread=False,
                                        clock=_tick_clock(), **opts))
    else:
        engines = (jengine.DecodeEngine(jm, params, n_slots=2, max_len=96,
                                        run_thread=False, **opts),
                   tengine.DecodeEngine(model, n_slots=2, max_len=96,
                                        run_thread=False, **opts))
    counted = _counted(engines[1])
    if traffic == "multiturn":
        want, got = (_multiturn(e) for e in engines)
    else:
        reqs = {"chunk": _chunk_traffic(),
                "repetitive": _repetitive_traffic()}[traffic]
        want, got = (_drive(e, reqs) for e in engines)
    je, te = engines
    assert got == want
    _same_stats(te, je)
    st = te.stats()
    assert {k: st[k] for k in counted} == counted
    assert counted["engine_ticks"] > 0
    assert counted["engine_prefill_rows"] >= counted[
        "engine_admit_groups"] > 0
    assert st["engine_queue_wait_s"] >= 0.0
    if traffic == "multiturn":
        assert st["engine_prefix_cache_hits"] == 2
    if opts.get("prefill_chunk"):
        assert st["engine_chunked_prefill_queued"] == 0
    if case == "adaptive-garbage":
        assert st["engine_spec_suppressed_ticks"] > 0
        assert st["engine_spec_tps_plain"] > st["engine_spec_tps_verify"]


def _run(engine, ids, px=None, max_new=6):
    """One request through an engine with run_thread=False."""
    req = engine._make_request(ids, px, max_new_tokens=max_new)
    for _ in range(200):
        if req.done:
            break
        engine._tick()
    engine._tick()
    assert req.done
    return list(req.emitted)


def _cold(model, ids, px=None, max_new=6):
    return _run(tengine.DecodeEngine(model, n_slots=2, max_len=96,
                                     run_thread=False), ids, px, max_new)


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

def test_prefix_cache_prefills_only_the_suffix(tiny_engine_model):
    """Turn 2 extends a parked conversation: one `_unpark_admit` of the
    32-token suffix bucket and no cold prefill; tokens equal a cold
    engine's."""
    _, _, model = tiny_engine_model
    p1 = np.arange(1, 9, dtype=np.int32)
    engine = tengine.DecodeEngine(model, n_slots=2, max_len=96,
                                  run_thread=False, prefix_cache_slots=2)
    reply1 = _run(engine, p1)
    assert engine.stats()["engine_prefix_cache_hits"] == 0
    p2 = np.concatenate([p1, np.asarray(reply1, np.int32),
                         np.asarray([30, 31, 32], np.int32)])
    calls = []
    unpark, prefill = engine._unpark_admit, engine._run_prefill

    def spy_unpark(pslots, pos0, ids, *rest):
        calls.append(("unpark", ids.shape, int(pos0[0])))
        return unpark(pslots, pos0, ids, *rest)

    def spy_prefill(bucket, ids, px, mask):
        calls.append(("cold", tuple(ids.shape)))
        return prefill(bucket, ids, px, mask)

    engine._unpark_admit, engine._run_prefill = spy_unpark, spy_prefill
    reply2 = _run(engine, p2)
    assert engine.stats()["engine_prefix_cache_hits"] == 1
    # the parked row holds p1 and reply1[:-1]: 8 + 5 positions
    assert calls == [("unpark", (1, 32), 13)], calls
    assert reply2 == _cold(model, p2)


def test_prefix_cache_grouped_reuse_is_one_call(tiny_engine_model):
    """Three simultaneous follow-ups admit through ONE `_unpark_admit`
    padded to 4 rows; the three retirements were copied to the park
    buffer by one flush; every stream equals a cold engine's."""
    _, _, model = tiny_engine_model
    prompts = [np.arange(1 + 7 * i, 9 + 7 * i, dtype=np.int32) % 60 + 1
               for i in range(3)]
    engine = tengine.DecodeEngine(model, n_slots=4, max_len=96,
                                  run_thread=False, prefix_cache_slots=4)
    flushes, flush = [], engine._flush_parks

    def spy_flush():
        if engine._park_pending:
            flushes.append(len(engine._park_pending))
        flush()

    engine._flush_parks = spy_flush
    outs = _drive(engine, [(p, None, 5) for p in prompts], first=3)
    engine._tick()
    assert not engine._park_pending and sum(flushes) == 3
    assert len(flushes) < 3        # retirements of one tick share a copy
    follow = [np.concatenate([p, np.asarray(o, np.int32),
                              np.asarray([40 + i, 41], np.int32)])
              for i, (p, o) in enumerate(zip(prompts, outs))]
    calls, unpark = [], engine._unpark_admit

    def spy(pslots, pos0, ids, *rest):
        calls.append(ids.shape)
        return unpark(pslots, pos0, ids, *rest)

    engine._unpark_admit = spy
    outs2 = _drive(engine, [(f, None, 5) for f in follow], first=3)
    assert engine.stats()["engine_prefix_cache_hits"] == 3
    assert calls == [(4, 32)], calls
    assert outs2 == [_cold(model, f, max_new=5) for f in follow]


def test_prefix_cache_image_conversation_needs_the_same_image(
        tiny_engine_model):
    """A conversation that began with an image reuses its parked row only
    for the same pixels: the same tokens with another image admit cold
    and equal a cold engine's tokens for that image."""
    _, _, model = tiny_engine_model
    rng = np.random.default_rng(9)
    px = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    px_other = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    p1 = np.array([5, IMG, 7, 8, 9], np.int32)
    engine = tengine.DecodeEngine(model, n_slots=2, max_len=96,
                                  run_thread=False, prefix_cache_slots=2)
    reply1 = _run(engine, p1, px, 4)
    p2 = np.concatenate([p1, np.asarray(reply1, np.int32),
                         np.asarray([20, 21], np.int32)])
    reply2 = _run(engine, p2, px, 4)
    assert engine.stats()["engine_prefix_cache_hits"] == 1
    other = _run(engine, p2, px_other, 4)
    assert engine.stats()["engine_prefix_cache_hits"] == 1
    assert reply2 == _cold(model, p2, px, 4)
    assert other == _cold(model, p2, px_other, 4)


def test_prefix_cache_with_engine_thread_and_pipelining(tiny_engine_model):
    """The threaded, pipelined engine parks at drain-time retirement while
    a later call is in flight; turn 2 through the cache equals a cold
    engine's."""
    _, _, model = tiny_engine_model
    p1 = np.arange(1, 9, dtype=np.int32)
    engine = tengine.DecodeEngine(model, n_slots=2, max_len=96,
                                  pipeline_depth=2, prefix_cache_slots=2)
    try:
        out1 = list(engine.submit(p1, max_new_tokens=6))
        p2 = np.concatenate([p1, np.asarray(out1, np.int32),
                             np.asarray([30, 31, 32], np.int32)])
        out2 = list(engine.submit(p2, max_new_tokens=6))
        assert engine.stats()["engine_prefix_cache_hits"] == 1
        assert engine.error is None
    finally:
        engine.shutdown()
    assert out2 == _cold(model, p2)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def test_chunked_prefill_splits_long_prompts_only(tiny_engine_model):
    """A 23-token prompt at chunk 8 takes 3 chunk forwards (the last one
    7 real tokens of 8) beside a live short stream; a 6-token prompt keeps
    grouped admission. Tokens equal a cold engine's."""
    _, _, model = tiny_engine_model
    rng = np.random.default_rng(21)
    long_p = rng.integers(1, 60, 23).astype(np.int32)
    short_p = rng.integers(1, 60, 6).astype(np.int32)
    engine = tengine.DecodeEngine(model, n_slots=2, max_len=96,
                                  prefill_chunk=8, run_thread=False)
    chunks, chunk_prefill = [], engine._chunk_prefill

    def spy(ids, mask):
        chunks.append(int(mask.sum()))
        return chunk_prefill(ids, mask)

    engine._chunk_prefill = spy
    got = _drive(engine, [(short_p, None, 8), (long_p, None, 6)], first=2)
    assert chunks == [8, 8, 7]
    assert got == [_cold(model, short_p, max_new=8), _cold(model, long_p)]
    assert engine.stats()["engine_chunked_prefill_queued"] == 0


def test_chunked_prefill_cancelled_while_in_flight(tiny_engine_model):
    """Abandoning a request whose chunked prefill runs frees its reserved
    slot and emits nothing."""
    _, _, model = tiny_engine_model
    engine = tengine.DecodeEngine(model, n_slots=1, max_len=96,
                                  prefill_chunk=8, run_thread=False)
    req = engine._make_request(np.arange(1, 21, dtype=np.int32),
                               max_new_tokens=6)
    engine._tick()
    assert engine._pf_state is not None and engine._free == []
    req.cancelled = True
    for _ in range(5):
        engine._tick()
    assert req.done and req.emitted == []
    assert engine._free == [0] and engine._pf_state is None


def test_engine_error_releases_chunked_prefill_waiters(tiny_engine_model):
    """An engine failure unblocks every consumer, the chunked prefill in
    flight and the ones queued behind it included."""
    _, _, model = tiny_engine_model
    engine = tengine.DecodeEngine(model, n_slots=1, max_len=96,
                                  prefill_chunk=8, run_thread=False)
    reqs = [engine._make_request(np.arange(1, 25, dtype=np.int32) + i,
                                 max_new_tokens=4) for i in range(2)]
    engine._admit()
    engine._pf_start()
    assert engine._pf_state is not None and len(engine._pf_queue) == 1
    engine.error = RuntimeError("boom")
    engine._release_waiters()
    for r in reqs:
        assert r.out.get(timeout=5) is None
    assert engine._pf_state is None and not engine._pf_queue


# ---------------------------------------------------------------------------
# adaptive speculation
# ---------------------------------------------------------------------------

def test_adaptive_spec_keeps_good_drafts(tiny_engine_model):
    """An oracle drafter (the cold engine's own tokens) with 1 + k >
    steps_per_call: verify measures faster, the bandit keeps speculating
    after one plain measuring tick, and the tokens are exact."""
    _, _, model = tiny_engine_model
    prompt = np.random.default_rng(17).integers(1, 60, 7).astype(np.int32)
    want = _cold(model, prompt, max_new=12)

    def oracle(hist, k):
        d = want[len(hist) - len(prompt):][:k]
        return np.asarray(d, np.int32) if len(d) == k else None

    engine = tengine.DecodeEngine(
        model, n_slots=1, max_len=96, spec_k=3, draft_fn=oracle,
        steps_per_call=2, spec_adaptive=True, spec_probe_interval=8,
        clock=_tick_clock(), run_thread=False)
    assert _run(engine, prompt, max_new=12) == want
    st = engine.stats()
    assert st["engine_spec_suppressed_ticks"] <= 2
    assert st["engine_spec_tps_verify"] > st["engine_spec_tps_plain"]
    assert st["engine_spec_accepted_drafts"] > 0


def test_adaptive_spec_reprobes_and_recovers(tiny_engine_model):
    """After parking speculation, the bandit probes verify every
    spec_probe_interval same-arm ticks; once the drafter turns good, one
    probe re-enables speculation at once (instant up)."""
    _, _, model = tiny_engine_model
    prompt = np.random.default_rng(19).integers(1, 60, 7).astype(np.int32)
    want = _cold(model, prompt, max_new=24)
    phase = {"bad": True}

    def flaky(hist, k):
        if phase["bad"]:
            return np.full(k, 61, np.int32)
        d = want[len(hist) - len(prompt):][:k]
        return np.asarray(d, np.int32) if len(d) == k else None

    engine = tengine.DecodeEngine(
        model, n_slots=1, max_len=96, spec_k=3, draft_fn=flaky,
        steps_per_call=4, spec_adaptive=True, spec_probe_interval=3,
        clock=_tick_clock(), run_thread=False)
    req = engine._make_request(prompt, max_new_tokens=24)
    for _ in range(20):
        engine._tick()
        if engine._spec_suppressed_ticks >= 2 or req.done:
            break
    assert engine._spec_suppressed_ticks >= 2, "never parked"
    phase["bad"] = False
    recovered = False
    for _ in range(60):
        engine._tick()
        arm, run = engine._arm_streak
        recovered = recovered or (arm == "verify" and run >= 2)
        if req.done:
            break
    assert req.done and req.emitted == want
    assert recovered, "speculation never resumed after a good probe"


def test_spec_record_draftless_tick_decays_not_pins(tiny_engine_model):
    """A verify-chosen tick without drafts runs the plain scan: it is
    charged to verify by the smooth decay, not the instant-up max; a tick
    that ran a verify step keeps instant up."""
    _, _, model = tiny_engine_model
    engine = tengine.DecodeEngine(model, n_slots=1, max_len=32, spec_k=2,
                                  draft_fn=lambda h, k: None,
                                  spec_adaptive=True, clock=_tick_clock(),
                                  run_thread=False)
    engine._arm_tps = {"verify": 2.0, "plain": None}
    engine._spec_record("verify", 10, engine._clock(), instant_up=False)
    assert engine._arm_tps["verify"] == pytest.approx(0.8 * 2.0 + 0.2 * 10)
    engine._spec_record("verify", 10, engine._clock())
    assert engine._arm_tps["verify"] == pytest.approx(10.0)


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------

WARM = dict(n_slots=2, max_len=128, max_prefill_batch=2, spec_k=2,
            prefill_chunk=32, prefix_cache_slots=2, spec_adaptive=True)


def test_warmup_programs_match_jax(tiny_engine_model):
    """warmup() drives the same paths as JAX's, in the same order and
    under the same names (bursts of 1 and 2 rows, plain and nucleus,
    verify, the chunk path, park and unpark); afterwards the stats, the
    park slots and the bandit are scrubbed, and draft_fn and
    spec_adaptive are restored."""
    jm, params, model = tiny_engine_model
    je = jengine.DecodeEngine(jm, params, run_thread=False, **WARM)
    te = tengine.DecodeEngine(model, run_thread=False, **WARM)
    want = je.warmup(prompt_buckets=(16, 64))
    got = te.warmup(prompt_buckets=(16, 64))
    assert got["programs"] == want["programs"]
    assert "chunked_prefill[32]" in got["programs"]
    assert "park+unpark x2" in got["programs"]
    _same_stats(te, je)
    st = te.stats()
    assert all(st[k] == 0 for k in COUNTERS)
    assert st["engine_tokens_emitted"] == 0
    assert st["engine_prefix_cache_hits"] == 0
    assert st["engine_spec_verify_calls"] == 0
    assert st["engine_spec_suppressed_ticks"] == 0
    assert te._park_meta == [None, None] and not te._park_pending
    assert te._spec_adaptive and te._draft_fn is None
    assert te._arm_tps == {"verify": None, "plain": None}
    assert not te._live and not te._inflight and sorted(te._free) == [0, 1]


def test_warmup_on_the_engine_thread_then_serves_exactly(tiny_engine_model):
    """warmup() with the engine thread running (as the worker calls it)
    returns with the engine quiescent; live traffic afterwards (a burst,
    a chunked prompt, a turn-2 prefix hit) equals cold engines' tokens."""
    _, _, model = tiny_engine_model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 60, 20).astype(np.int32) for _ in range(2)]
    long_p = rng.integers(1, 60, 50).astype(np.int32)
    engine = tengine.DecodeEngine(model, pipeline_depth=2, **dict(
        WARM, spec_k=0, spec_adaptive=False, prefix_cache_slots=4))
    try:
        rec = engine.warmup(prompt_buckets=(20,))
        assert rec["programs"] and rec["seconds"] >= 0
        assert engine._idle.is_set() and not engine._inflight
        got, threads = {}, []

        def client(i, ids):
            got[i] = list(engine.submit(ids, max_new_tokens=6))

        for i, ids in enumerate(prompts + [long_p]):
            threads.append(threading.Thread(target=client, args=(i, ids)))
            threads[-1].start()
        for th in threads:
            th.join(timeout=120)
        follow = np.concatenate([prompts[0], np.asarray(got[0], np.int32),
                                 np.asarray([7, 8, 9], np.int32)])
        got[3] = list(engine.submit(follow, max_new_tokens=6))
        assert engine.stats()["engine_prefix_cache_hits"] == 1
        assert engine.error is None
    finally:
        engine.shutdown()
    for i, ids in enumerate(prompts + [long_p, follow]):
        assert got[i] == _cold(model, ids), i


# ---------------------------------------------------------------------------
# the worker's flags
# ---------------------------------------------------------------------------

def test_worker_engine_flags_reach_the_engine(monkeypatch, capsys):
    """--engine-prefill-chunk, --engine-prefix-cache, --spec-adaptive and
    --engine-warmup are accepted, passed to make_engine and the engine,
    and warmup runs before serving with its line printed."""
    import sys
    import types
    from pathlib import Path

    from competesmoe_tpu_torch.serve import model_worker

    class IntTok:
        eos_token_id = None

        def __call__(self, text):
            return types.SimpleNamespace(
                input_ids=[int(w) for w in text.split()])

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path: IntTok())
    monkeypatch.setitem(sys.modules, "transformers", fake)
    made, real = [], model_worker.make_engine

    def spy(*args, **kwargs):
        made.append((args[1:], kwargs))
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(model_worker, "make_engine", spy)
    monkeypatch.setattr(model_worker, "serve_worker",
                        lambda worker, host, port: None)
    ckpt = Path(__file__).parent / "fixtures" / "golden_tiny_ckpt"
    model_worker.main([
        "--model-path", str(ckpt), "--tokenizer", "int-tok", "--device",
        "cpu", "--no-register", "--engine-slots", "2", "--engine-max-len",
        "256", "--speculative", "2", "--engine-prefill-chunk", "64",
        "--engine-prefix-cache", "2", "--spec-adaptive",
        "--engine-warmup", "32,64"])
    (args, kwargs), engine = made
    try:
        assert args == (2, 256, 2, 2)
        assert kwargs == dict(prefix_cache=2, prefill_chunk=64,
                              spec_adaptive=True)
        assert (engine._park_n, engine._pf_chunk_n, engine._spec_k,
                engine._spec_adaptive, engine._pipeline_depth) == (
            2, 64, 2, True, 1)
        assert engine.error is None and engine.stats()[
            "engine_tokens_emitted"] == 0
    finally:
        engine.shutdown()
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("engine warmup:")]
    assert len(line) == 1 and line[0].endswith(" s")
    assert int(line[0].split()[2]) > 0
