"""Parity of the PyTorch port's batched serving slice with the JAX package:
K3 and K4's plain versions against JAX's interpreted Pallas kernels, their
viability rules, the decoder with `matvec_kernel` (bf16 and int8), the
`--load-8bit` quantizers, prompt-lookup drafting, speculative acceptance
and decoding, the DecodeEngine driven tick by tick, and the worker's
engine path over HTTP.

Weights come from the JAX module's init and cross through
`convert.from_jax_params`; inputs are numpy from a seed. Greedy tokens
must be identical; other tolerances are stated with their tests.
"""

import dataclasses
import json
import socket
import threading
from pathlib import Path
from urllib import request as urlrequest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import decoder as jdec
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu.ops import matvec as jmatvec
from competesmoe_tpu.serve import engine as jengine
from competesmoe_tpu.serve import speculative as jspec
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.models import llava as tllava
from competesmoe_tpu_torch.ops import matvec as tmatvec
from competesmoe_tpu_torch.serve import engine as tengine
from competesmoe_tpu_torch.serve import speculative as tspec
from tests.test_llava import tiny_llava_cfg
from tests.test_torch_port_llava import _repetitive_prompt
from tests.test_torch_port_models import (IMG, _prompt, jax_llava_cfg,
                                          port_llava_cfg)
from tests.test_torch_port_ops import close, port_config, t


# ---------------------------------------------------------------------------
# K3 and K4: plain versions against JAX's interpreted Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["k3", "k4"])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_small_m_references_match_pallas_kernels(kernel, m):
    """In the kernels' working type (bf16 out). Both sides sum exact
    products of bf16 (x) and bf16 or int8 (w) values in float32, in
    different orders, so the bf16 outputs may differ by one ulp:
    tolerance 2^-7 * max|JAX|. K3 gets the [K, N] view of a contiguous
    [N, K] weight, as the decoder passes `weight.t()`."""
    k, n = 512, 256
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    xb = t(x).to(torch.bfloat16)
    if kernel == "k3":
        wt = rng.normal(size=(n, k)).astype(np.float32)
        w = t(wt).to(torch.bfloat16).t()
        assert w.stride() == (1, k)
        want = jmatvec.small_m_matmul(jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(wt.T, jnp.bfloat16),
                                      interpret=True)
        fn, args = tmatvec.small_m_matmul, (xb, w)
        ref = tmatvec.small_m_matmul_reference(*args)
    else:
        q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
        scale = rng.uniform(1e-3, 2e-3, size=(n,)).astype(np.float32)
        want = jmatvec.quant_small_m_matmul(jnp.asarray(x, jnp.bfloat16),
                                            jnp.asarray(q),
                                            jnp.asarray(scale),
                                            interpret=True)
        fn, args = tmatvec.quant_small_m_matmul, (xb, t(q), t(scale))
        ref = tmatvec.quant_small_m_matmul_reference(*args)
    before = fn.launches
    got = fn(*args)
    # a CPU tensor runs the plain version, never the kernel
    assert fn.launches == before
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_small_m_viable_matches_jax():
    for m in (1, 3, 8, 31, 32, 33, 40, 41, 64, 127, 128, 136):
        for k, n in ((3072, 9216), (8192, 3072), (3072, 16384),
                     (3072, 32064), (24, 72), (128, 128)):
            for cap in (jmatvec.MAX_SMALL_M, jmatvec.MAX_QUANT_M):
                assert (tmatvec.small_m_viable(m, k, n, max_m=cap)
                        == jmatvec.small_m_viable(m, k, n, max_m=cap)), \
                    (m, k, n, cap)
            assert (tmatvec.small_m_viable(m, k, n)
                    == jmatvec.small_m_viable(m, k, n))
        for cap in (1, 8, 32, 100, 128):
            assert tmatvec._m_ok(m, cap) == jmatvec._m_ok(m, cap)
    assert (tmatvec.MAX_SMALL_M, tmatvec.MAX_QUANT_M) == (
        jmatvec.MAX_SMALL_M, jmatvec.MAX_QUANT_M)


# ---------------------------------------------------------------------------
# the decoder with matvec_kernel, and --load-8bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16-path", "int8"])
def test_matvec_decoder_matches_jax(quant):
    """DecoderLM with matvec_kernel: JAX's PallasDense / int8 QuantDense
    tree loads into the port's PallasDense / QuantDense; on the CPU both
    packages compute the non-kernel formulas. Prefill of a right-padded
    batch, three decode steps and the cache-free forward, float32
    rtol/atol 1e-4."""
    jcfg = dataclasses.replace(jax_llava_cfg().decoder, matvec_kernel=True,
                               quant=quant, attention_bias=True)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 64, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    jm = jdec.DecoderLM(jcfg)
    params = jm.init(jax.random.PRNGKey(12), jnp.asarray(ids))
    pm = tdec.DecoderLM(port_config(jcfg, tdec.DecoderConfig), device="cpu")
    pm.load_state_dict(from_jax_params(params))
    proj = pm.layers[0].self_attn.qkv_proj
    if quant:
        assert isinstance(proj, tdec.QuantDense) and proj.matvec_kernel
        assert not pm.lm_head.matvec_kernel
    else:
        assert isinstance(proj, tdec.PallasDense)
        assert type(pm.lm_head) is torch.nn.Linear

    jl, _, _ = jm.apply(params, jnp.asarray(ids), attention_mask=mask)
    with torch.no_grad():
        tl, _, _ = pm(torch.as_tensor(ids).long(),
                      attention_mask=torch.as_tensor(mask))
    close(jl, tl)
    jcache = jdec.KVCache.create(jcfg, 2, 16)
    tcache = tdec.KVCache.create(pm.cfg, 2, 16, "cpu")
    jl, jcache, _ = jm.apply(params, jnp.asarray(ids),
                             attention_mask=jnp.asarray(mask), cache=jcache)
    with torch.no_grad():
        tl, tcache, _ = pm(torch.as_tensor(ids).long(),
                           attention_mask=torch.as_tensor(mask), cache=tcache)
    close(jl, tl)
    for _ in range(3):
        tok = rng.integers(0, 64, (2, 1)).astype(np.int32)
        jl, jcache, _ = jm.apply(params, jnp.asarray(tok), cache=jcache)
        with torch.no_grad():
            tl, tcache, _ = pm(torch.as_tensor(tok).long(), cache=tcache)
        close(jl, tl)


def test_pallas_dense_bf16_matches_jax():
    """PallasDense in bf16 (the served decoder's type) on the CPU: JAX's
    non-kernel formula (weight cast to x's type, float32 product, bf16
    result) against the port's; the float32 sums differ in order only, so
    the bf16 results may differ by one ulp: 2^-7 * max|JAX|."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 5, 256)).astype(np.float32)
    jl = jdec.PallasDense(128, use_bias=True, dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    params = jl.init(jax.random.PRNGKey(14), xb)
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    want = np.asarray(jl.apply(params, xb).astype(jnp.float32))
    tl = tdec.PallasDense(256, 128, bias=True, device="cpu",
                          dtype=torch.bfloat16)
    tl.load_state_dict({k: v.to(torch.bfloat16) for k, v in
                        from_jax_params(params).items()})
    with torch.no_grad():
        got = tl(t(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_quantize_int8_weight_only_matches_jax():
    from competesmoe_tpu.models.vision import SiglipSMoEVisionTower
    from competesmoe_tpu.models.vision import VisionConfig as JVis
    from competesmoe_tpu_torch.models.vision import (SiglipSMoEVisionTower as
                                                     TTower)
    from competesmoe_tpu_torch.models.vision import VisionConfig as TVis
    jcfg = JVis(hidden_size=48, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, image_size=28, patch_size=14,
                moe_name="competesmoe")
    px = np.zeros((1, 28, 28, 3), np.float32)
    params = SiglipSMoEVisionTower(jcfg).init(jax.random.PRNGKey(15),
                                              jnp.asarray(px))["params"]
    jq = jbuilder.quantize_int8_weight_only(
        jax.tree_util.tree_map(np.asarray, params))
    tower = TTower(port_config(jcfg, TVis), device="cpu")
    tower.load_state_dict(from_jax_params(params))
    tbuilder.quantize_int8_weight_only(tower)
    want = from_jax_params(jq)
    for key, v in tower.state_dict().items():
        np.testing.assert_array_equal(want[key].numpy(), v.numpy(), key)
    assert not torch.equal(want["layers.0.self_attn.q_proj.weight"],
                           from_jax_params(params)[
                               "layers.0.self_attn.q_proj.weight"])


@pytest.fixture(scope="module")
def jax_model():
    cfg = jax_llava_cfg()
    ids, px = _prompt()
    params = jllava.LlavaModel(cfg).init(jax.random.PRNGKey(0), ids, px)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _port_model(jcfg, params):
    model = tllava.LlavaModel(port_llava_cfg(jcfg), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return model


def test_load_8bit_greedy_generation_matches_jax(jax_model):
    """The JAX builder's --load-8bit param transforms against the port's
    apply_load_8bit on the same f32 weights, with matvec_kernel and an
    int8 KV cache: the same state, then the same greedy tokens."""
    cfg, params = jax_model
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, kv_quant="int8", matvec_kernel=True))
    ids, px = _prompt()
    model = _port_model(cfg, params)
    tbuilder.apply_load_8bit(model)
    assert model.cfg.decoder.quant == "int8"
    dec = model.language_model
    assert dec.layers[0].mlp.down_proj.matvec_kernel
    assert not dec.lm_head.matvec_kernel
    p = params["params"]
    jparams = {"params": {
        "language_model": jbuilder.quantize_decoder_to_int8(
            p["language_model"]),
        **jbuilder.quantize_int8_weight_only(
            {k: v for k, v in p.items() if k != "language_model"})}}
    want_sd = from_jax_params(jparams)
    got_sd = model.state_dict()
    assert set(want_sd) == set(got_sd)
    for key, v in want_sd.items():
        if key.endswith("kernel_q"):
            assert torch.equal(v, got_sd[key]), key
        else:
            close(v, got_sd[key], rtol=1e-6, atol=1e-7)
    jcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, quant="int8"))
    want = np.concatenate(list(jllava.stream_generate(
        jllava.LlavaModel(jcfg), jparams, ids, px, max_new_tokens=6)), 1)
    got = np.concatenate(list(tllava.stream_generate(model, ids, px,
                                                     max_new_tokens=6)), 1)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# prompt-lookup drafting and speculative acceptance
# ---------------------------------------------------------------------------

@settings(max_examples=150, deadline=None)
@given(ids=st.lists(st.integers(-2, 5), max_size=40),
       k=st.integers(0, 6), max_ngram=st.integers(1, 4),
       min_ngram=st.integers(1, 2))
def test_ngram_draft_matches_jax(ids, k, max_ngram, min_ngram):
    """Random short-alphabet histories (negative ids stand for the image
    sentinel): the same draft, or None, as JAX's."""
    want = jspec.ngram_draft(ids, k, max_ngram, min_ngram)
    got = tspec.ngram_draft(ids, k, max_ngram, min_ngram)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_ngram_draft_on_repetitive_sequences_matches_jax():
    rng = np.random.default_rng(16)
    for trial in range(200):
        period = int(rng.integers(1, 6))
        base = rng.integers(0, 50, period)
        seq = np.tile(base, 1 + int(rng.integers(1, 8)))
        seq = seq[: len(seq) - int(rng.integers(0, period))]
        if trial % 3 == 0:
            seq = np.concatenate([rng.integers(0, 50, 5), [-200], seq])
        for k in (1, 2, 4):
            want = jspec.ngram_draft(list(seq), k)
            got = tspec.ngram_draft(list(seq), k)
            assert (want is None) == (got is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)


def test_speculative_accept_matches_jax():
    """Greedy rows (temperature 0): the same tokens and accepted counts as
    JAX, in a batch that also holds sampled rows. Sampled rows (their
    random numbers differ by design): the accepted prefix is the draft,
    0 <= n_acc <= k, and a row whose drafts are near certain accepts all
    of them and draws its bonus from a near-certain last position."""
    S, k, V = 6, 3, 16
    rng = np.random.default_rng(17)
    logits = rng.normal(size=(S, k + 1, V)).astype(np.float32) * 3
    drafts = rng.integers(0, V, (S, k)).astype(np.int32)
    greedy = logits.argmax(-1)
    drafts[0] = greedy[0, :k]                      # all accepted
    drafts[1, 0] = greedy[1, 0]                    # first accepted only
    drafts[1, 1] = (greedy[1, 1] + 1) % V
    logits[4, np.arange(k), drafts[4]] = 50.0      # near-certain drafts
    logits[4, k, 7] = 50.0
    temps = np.array([0, 0, 0, 0, 0.8, 1.2], np.float32)
    topps = np.array([1, 1, 0.5, 1, 1, 0.9], np.float32)
    for nucleus in (False, True):
        jt, jn = jllava.speculative_accept(
            jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(temps),
            jnp.asarray(topps), jax.random.PRNGKey(0), nucleus=nucleus)
        tt, tn = tllava.speculative_accept(
            t(logits), t(drafts), t(temps), t(topps),
            torch.Generator().manual_seed(0), nucleus=nucleus)
        jt, jn, tt, tn = (np.asarray(jt), np.asarray(jn), tt.numpy(),
                          tn.numpy())
        g = temps == 0
        np.testing.assert_array_equal(tt[g], jt[g])
        np.testing.assert_array_equal(tn[g], jn[g])
        assert list(tn[:2]) == [k, 1]
        for s in np.flatnonzero(~g):
            assert 0 <= tn[s] <= k
            np.testing.assert_array_equal(tt[s, :tn[s]], drafts[s, :tn[s]])
        assert tn[4] == k and list(tt[4]) == list(drafts[4]) + [7]


def test_sampled_speculative_stream_is_well_formed(jax_model):
    """temperature > 0 with speculation: the right number of in-vocabulary
    tokens, reproducible from the same generator seed."""
    cfg, params = jax_model
    ids, px = _repetitive_prompt(19)
    model = _port_model(cfg, params)
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        runs.append(np.concatenate(list(tllava.stream_generate(
            model, ids, px, max_new_tokens=10, temperature=0.9, top_p=0.8,
            generator=g, speculative=3)), 1))
    assert runs[0].shape == (1, 10)
    assert 0 <= runs[0].min() and runs[0].max() < 64
    np.testing.assert_array_equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# DecodeEngine, driven tick by tick, against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_engine_model():
    """The fixture of tests/test_engine.py: the JAX model and the port's
    model with the same weights."""
    cfg = tiny_llava_cfg(moe=False)
    ids = np.array([[5, IMG, 7, 8]], np.int32)
    px = np.zeros((1, 28, 28, 3), np.float32)
    params = jllava.LlavaModel(cfg).init(jax.random.PRNGKey(0),
                                         jnp.asarray(ids), jnp.asarray(px))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = tllava.LlavaModel(port_llava_cfg(cfg), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jllava.LlavaModel(cfg), params, model


@pytest.fixture(scope="module")
def tiny_engine_model_int4(tiny_engine_model):
    """The engine fixture served as the worker's --load-4bit with an int8
    KV cache: JAX's builder param transforms (int4 decoder, int8 lm_head,
    NF4 tower and projector) against the port's apply_load_4bit on the
    same f32 weights."""
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
    assert model.cfg.decoder.quant == "int4"
    proj = model.language_model.layers[0].self_attn.qkv_proj
    assert isinstance(proj, tdec.QuantDense) and proj.mode == "int4"
    return jllava.LlavaModel(cfg), params, model


def _engine_traffic(seed=20):
    """(ids, pixel_values, max_new) per request: repetitive text prompts
    of several buckets, one image request; requests 3-5 arrive later."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (5, 9, 6, 40, 7):
        base = rng.integers(1, 60, 3)
        out.append((np.resize(base, n).astype(np.int32), None, 6))
    ids = np.array([5, IMG, 7, 8, 9, 5, IMG], np.int32)[:5]
    out.insert(2, (ids, rng.normal(size=(1, 28, 28, 3)).astype(np.float32),
                   5))
    return out


def _drive(engine, traffic, first: int = 3):
    """Submit `first` requests, tick twice, submit the rest, tick until
    every request is done; returns each request's emitted tokens."""
    reqs = [engine._make_request(i, px, max_new_tokens=n)
            for i, px, n in traffic[:first]]
    for _ in range(2):
        engine._tick()
    reqs += [engine._make_request(i, px, max_new_tokens=n)
             for i, px, n in traffic[first:]]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        engine._tick()
    engine._tick()      # drain what pipelining still holds
    assert all(r.done for r in reqs)
    return [list(r.emitted) for r in reqs]


def _last_tokens_draft(history, k):
    """A draft_fn other than prompt lookup: the last k non-negative
    history tokens, or None while there are fewer."""
    toks = [t for t in history if t >= 0][-k:]
    return np.asarray(toks, np.int32) if len(toks) == k else None


@pytest.mark.parametrize("opts", [
    dict(), dict(pipeline_depth=2), dict(spec_k=2),
    dict(spec_k=3, draft_fn=_last_tokens_draft),
    dict(steps_per_call=2, max_prefill_batch=1),
    dict(load_4bit=True), dict(load_4bit=True, spec_k=2)],
    ids=["plain", "pipeline2", "spec2", "spec3-draft_fn", "spc2-batch1",
         "int4-plain", "int4-spec2"])
def test_engine_matches_jax_tick_by_tick(request, opts):
    """Two slots, six requests (one with an image), three of them admitted
    while the first are decoding, so slots retire and are reused. The
    port's greedy streams equal JAX's engine, token for token; `load_4bit`
    serves both as the worker's --load-4bit with an int8 KV cache."""
    opts = dict(opts)
    jm, params, model = request.getfixturevalue(
        "tiny_engine_model_int4" if opts.pop("load_4bit", False)
        else "tiny_engine_model")
    traffic = _engine_traffic()
    je = jengine.DecodeEngine(jm, params, n_slots=2, max_len=96,
                              run_thread=False, **opts)
    te = tengine.DecodeEngine(model, n_slots=2, max_len=96,
                              run_thread=False, **opts)
    want = _drive(je, traffic)
    got = _drive(te, traffic)
    assert [len(g) for g in got] == [n for _, _, n in traffic]
    assert got == want
    if opts.get("spec_k"):
        stats, jstats = te.stats(), je.stats()
        assert stats["engine_spec_verify_calls"] > 0
        for key in ("engine_spec_verify_calls",
                    "engine_spec_accepted_drafts"):
            assert stats[key] == jstats[key]
    if opts.get("spec_k") == 2:
        assert te.stats()["engine_spec_accepted_drafts"] > 0


def test_engine_thread_with_many_concurrent_submitters(tiny_engine_model):
    """The engine thread against more submitting threads than cores, with
    a short interpreter switch interval: every stream ends with exactly
    its token count, the emitted-token count adds up, and every slot is
    free at the end (a lost or misrouted token would break one of these).
    Each join is bounded."""
    import os
    import sys

    _, _, model = tiny_engine_model
    n_threads = (os.cpu_count() or 1) + 4
    rng = np.random.default_rng(23)
    traffic = [(rng.integers(1, 60, int(rng.integers(3, 40))).astype(
        np.int32), int(rng.integers(1, 6))) for _ in range(n_threads)]
    engine = tengine.DecodeEngine(model, n_slots=3, max_len=96,
                                  pipeline_depth=2)
    got = {}

    def client(i):
        ids, n = traffic[i]
        got[i] = list(engine.submit(ids, max_new_tokens=n))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        engine.shutdown()
    # read after the engine thread has stopped: a stream ends before the
    # engine thread returns its slot to the free list
    assert not engine._thread.is_alive()
    stats = engine.stats()
    assert engine.error is None
    assert [len(got[i]) for i in range(n_threads)] == [n for _, n in traffic]
    assert all(0 <= x < 64 for toks in got.values() for x in toks)
    assert stats["engine_tokens_emitted"] == sum(n for _, n in traffic)
    assert stats["engine_slots_free"] == 3
    assert stats["engine_slots_live"] == 0 and stats["engine_queued"] == 0


def test_engine_sampling_and_cancellation(tiny_engine_model):
    """Sampled and nucleus slots beside a greedy one: the greedy stream is
    unchanged, sampled streams have their lengths; a cancelled request
    frees its slot at the next token boundary."""
    jm, params, model = tiny_engine_model
    traffic = _engine_traffic(21)
    want = _drive(jengine.DecodeEngine(jm, params, n_slots=3, max_len=96,
                                       run_thread=False), traffic[:1], 1)
    te = tengine.DecodeEngine(model, n_slots=3, max_len=96,
                              run_thread=False, rng_seed=5)
    g = te._make_request(traffic[0][0], max_new_tokens=6)
    s1 = te._make_request(traffic[1][0], max_new_tokens=6, temperature=0.8)
    s2 = te._make_request(traffic[3][0], max_new_tokens=6, temperature=0.8,
                          top_p=0.5)
    for _ in range(3):
        te._tick()
    s2.cancelled = True
    for _ in range(20):
        te._tick()
    assert g.emitted == want[0]
    assert len(s1.emitted) == 6 and all(0 <= x < 64 for x in s1.emitted)
    assert s2.done and len(s2.emitted) < 6
    assert sorted(te._free) == [0, 1, 2] and not te._live


def test_unported_engine_options_raise(tiny_engine_model):
    """The engine under a one-rank mesh is the one-process engine; the
    worker's --mesh and --ep-shards need as many ranks as they name, as
    JAX's need as many devices, and exclude each other; speculation
    still refuses pipelining."""
    _, _, model = tiny_engine_model
    from competesmoe_tpu_torch.parallel.mesh import make_tp_mesh
    plain = tengine.DecodeEngine(model, n_slots=2, max_len=64,
                                 run_thread=False)
    meshed = tengine.DecodeEngine(model, n_slots=2, max_len=64,
                                  run_thread=False, mesh=make_tp_mesh(1))
    got = []
    for eng in (plain, meshed):
        req = eng._make_request(np.arange(3, 9, dtype=np.int32),
                                max_new_tokens=4)
        while not req.done:
            eng._tick()
        got.append(req.emitted)
    assert got[0] == got[1] and len(got[0]) == 4
    with pytest.raises(ValueError):
        tengine.DecodeEngine(model, n_slots=2, max_len=64, run_thread=False,
                             spec_k=2, pipeline_depth=2)
    from competesmoe_tpu_torch.serve.model_worker import main
    for flag, msg in ((["--mesh", "1x2"], "needs 2 devices, have 1"),
                      (["--ep-shards", "2"], "needs a multiple of 2"),
                      (["--mesh", "1x2", "--ep-shards", "2"],
                       "mutually exclusive")):
        with pytest.raises(SystemExit, match=msg):
            main(["--tokenizer", "unused", "--device", "cpu"] + flag)


def test_worker_loads_a_model_path_that_holds_weights(tmp_path,
                                                     monkeypatch):
    """A --model-path that holds weights is loaded (bf16, as the worker
    serves) and answers over HTTP with the golden checkpoint's recorded
    greedy tokens; a directory with only config.json still builds its
    geometry and reaches the tokenizer load; without --tokenizer and
    without weights the worker exits before building anything."""
    import shutil
    import sys
    import types

    from competesmoe_tpu_torch.serve import model_worker
    ckpt = Path(__file__).parent / "fixtures" / "golden_tiny_ckpt"
    digests = json.loads((ckpt.parent / "golden_tiny_digests.json")
                         .read_text())
    assert model_worker.weight_files(ckpt) == ["model.safetensors"]

    class IntTok:
        """Token ids written as decimal words."""
        eos_token_id = None

        def __call__(self, text):
            return types.SimpleNamespace(
                input_ids=[int(w) for w in text.split()])

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    class ReachedTokenizer(Exception):
        pass

    def from_pretrained(path):
        if path == "int-tok":
            return IntTok()
        raise ReachedTokenizer(path)

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=from_pretrained)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    served, serve = [], model_worker.serve_worker

    def serve_in_background(worker, host, port):
        served.append(serve(worker, host, port, background=True))

    monkeypatch.setattr(model_worker, "serve_worker", serve_in_background)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    model_worker.main(["--model-path", str(ckpt), "--tokenizer", "int-tok",
                       "--device", "cpu", "--no-register", "--host",
                       "127.0.0.1", "--port", str(port)])
    try:
        prompt = " ".join(str(i) for i in digests["prompt_text"])
        req = urlrequest.Request(
            f"http://127.0.0.1:{port}/worker_generate_stream",
            data=json.dumps({"prompt": prompt, "max_new_tokens": 8,
                             "temperature": 0.0}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req, timeout=120) as r:
            chunks = [json.loads(p) for p in r.read().split(b"\0") if p]
    finally:
        served[0].shutdown()
        served[0].server_close()
    assert chunks and all(c["error_code"] == 0 for c in chunks)
    assert chunks[-1]["text"] == " ".join(
        str(t) for t in digests["greedy_tokens_text"])

    shutil.copy(ckpt / "config.json", tmp_path / "config.json")
    assert model_worker.weight_files(tmp_path) == []
    with pytest.raises(ReachedTokenizer, match="tok-dir"):
        model_worker.main(["--tokenizer", "tok-dir", "--model-path",
                           str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--tokenizer is needed"):
        model_worker.main(["--model-path", str(tmp_path), "--device",
                           "cpu"])
    for name in ("shard.bin", "w.pt", "model.safetensors.index.json"):
        (tmp_path / name).write_text("{}")
    assert model_worker.weight_files(tmp_path) == [
        "model.safetensors.index.json", "shard.bin", "w.pt"]


# ---------------------------------------------------------------------------
# the worker's engine path over HTTP
# ---------------------------------------------------------------------------

class _WordTok:
    eos_token_id = None

    def __init__(self):
        self.vocab = {}

    def __call__(self, text):
        ids = [self.vocab.setdefault(w, 1 + len(self.vocab) % 63)
               for w in text.split()]
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids)


def test_worker_engine_over_http(tiny_engine_model):
    """The worker with --engine-slots 2 --speculative 2 semantics: three
    concurrent requests stream through the engine thread; their greedy
    text equals the solo path's; /worker_get_status carries the engine's
    telemetry."""
    from competesmoe_tpu_torch.eval import TorchLlava
    from competesmoe_tpu_torch.multimodal.mm_utils import (
        ImageProcessorConfig)
    from competesmoe_tpu_torch.serve.model_worker import (
        ModelWorker, engine_generate_fn, make_engine, serve_worker,
        torch_llava_generate_fn)
    _, _, model = tiny_engine_model
    tok = _WordTok()
    adapter = TorchLlava(model, tok, ImageProcessorConfig(size=28),
                         max_new_tokens=5)
    engine = make_engine(model, 2, 96, speculative=2)
    assert engine._pipeline_depth == 1 and engine._spec_k == 2
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worker = ModelWorker(None, f"http://127.0.0.1:{port}", ["tiny"],
                         engine_generate_fn(adapter, engine), register=False,
                         extra_status_fn=engine.stats)
    httpd = serve_worker(worker, "127.0.0.1", port, background=True)
    prompts = ["a b c a b c a b", "red cat red cat red", "x y z"]
    solo = torch_llava_generate_fn(adapter)
    want = [list(solo({"prompt": p, "max_new_tokens": 5}))[-1]
            for p in prompts]
    results = {}

    def post(path, data):
        req = urlrequest.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(data).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req, timeout=120) as r:
            return r.read()

    def client(i):
        body = post("/worker_generate_stream",
                    {"prompt": prompts[i], "max_new_tokens": 5})
        results[i] = [json.loads(p) for p in body.split(b"\0") if p]

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        status = json.loads(post("/worker_get_status", {}))
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.shutdown()
    assert engine.error is None
    for i in range(3):
        chunks = results[i]
        assert chunks and all(c["error_code"] == 0 for c in chunks)
        assert chunks[-1]["text"] == want[i]
        assert len(chunks[-1]["text"].split()) == 5
    assert status["engine_tokens_emitted"] == 15
    assert status["engine_spec_verify_calls"] > 0
