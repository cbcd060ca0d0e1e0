"""Parity of the port's decoder options with the JAX package: the sliding
window on the three mask paths (no cache, cache, deferred), MPT (ALiBi,
bias-free LayerNorm, the GELU MLP, tied embeddings; `convert_mpt` and
`export_mpt`), deferred decode and the per-layer cache (solo and through
the engine), `fold_norm_scales` on bf16, int8 and int4 projections, and
w8a8's exact int32 products.

Weights come from the JAX module's init and cross through
`convert.from_jax_params`; inputs are numpy from a seed. Tolerance:
float32 logits rtol/atol 1e-5 unless a test states another.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import decoder as jdec
from competesmoe_tpu.models import hf_export as jexport
from competesmoe_tpu.models import hf_loader as jloader
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import decoder as tdec
from competesmoe_tpu_torch.models import hf_export as texport
from competesmoe_tpu_torch.models import hf_loader as tloader
from tests.test_torch_port_ops import port_config

TOL = dict(rtol=1e-5, atol=1e-5)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def jcfg(**kw):
    """A tiny GQA llama-family decoder (4 query heads over 2 KV heads)."""
    base = jdec.DecoderConfig(
        vocab_size=64, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, original_max_position_embeddings=128,
        dtype=jnp.float32)
    return dataclasses.replace(base, **kw)


def mpt_cfg(**kw):
    """MPT's knobs at a tiny width (MHA, no bias, tied embeddings)."""
    return jcfg(**dict(dict(use_alibi=True, norm_type="layernorm_nobias",
                            mlp_type="gelu", expansion_ratio=4,
                            tie_word_embeddings=True, fused_qkv=True,
                            num_key_value_heads=4), **kw))


def tcfg(cfg, dtype=torch.float32):
    return dataclasses.replace(port_config(cfg, tdec.DecoderConfig),
                               dtype=dtype)


def build(cfg, seed=1):
    """JAX's init of `cfg` (the options that leave the parameters as they
    are reset, so that their cases share one init)."""
    return _init(dataclasses.replace(
        cfg, sliding_window=None, deferred_decode=False, kv_quant=None,
        cache_layout="stacked", norm_folded=False), seed)


@functools.lru_cache(maxsize=None)
def _init(cfg, seed):
    ids = np.random.default_rng(0).integers(0, 64, (2, 6)).astype(np.int32)
    return jdec.DecoderLM(cfg).init(jax.random.PRNGKey(seed), ids)


def port(cfg, params, dtype=torch.float32):
    model = tdec.DecoderLM(tcfg(cfg, dtype), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return model


def jax_decode(cfg, params, ids, n_steps, max_len=32):
    """Greedy prefill + `n_steps` decode steps through JAX's cache:
    (tokens [n_steps + 1, B], the logits of every forward)."""
    model = jdec.DecoderLM(cfg)
    cache = jdec.KVCache.create(cfg, ids.shape[0], max_len)
    logits, cache, _ = model.apply(params, jnp.asarray(ids), cache=cache,
                                   attention_mask=jnp.ones_like(ids))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    toks, rows = [np.asarray(tok)], [np.asarray(logits)]
    for _ in range(n_steps):
        logits, cache, _ = model.apply(params, tok[:, None], cache=cache)
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        rows.append(np.asarray(logits))
    return np.stack(toks), rows


@torch.no_grad()
def port_decode(model, ids, n_steps, max_len=32):
    cache = tdec.KVCache.create(model.cfg, ids.shape[0], max_len)
    ids_t = torch.as_tensor(ids, dtype=torch.long)
    logits, cache, _ = model(ids_t, cache=cache,
                             attention_mask=torch.ones_like(ids_t))
    tok = logits[:, -1].argmax(-1)
    toks, rows = [tok.numpy()], [logits.float().numpy()]
    for _ in range(n_steps):
        logits, cache, _ = model(tok[:, None], cache=cache)
        tok = logits[:, 0].argmax(-1)
        toks.append(tok.numpy())
        rows.append(logits.float().numpy())
    return np.stack(toks), rows


def prompt(seed=2, B=2, L=10):
    return np.random.default_rng(seed).integers(0, 64, (B, L)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# sliding window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["no_cache", "cache", "deferred_int8"])
def test_sliding_window_matches_jax(path):
    """Window 4 under a 10-token prompt and 6 decode steps: the port's
    logits within 1e-5 of JAX's on the path's mask, greedy tokens equal,
    and the window changes the logits (it bites)."""
    kw = dict(sliding_window=4)
    if path.startswith("deferred"):
        kw["deferred_decode"] = True
    if path.endswith("int8"):
        kw["kv_quant"] = "int8"
    cfg = jcfg(**kw)
    params = build(cfg)
    model = port(cfg, params)
    ids = prompt()
    if path == "no_cache":
        pos = np.tile(np.arange(ids.shape[1]), (2, 1))
        mask = np.ones_like(ids)
        mask[1, -2:] = 0
        want = jdec.DecoderLM(cfg).apply(
            params, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
            position_ids=jnp.asarray(pos))[0]
        with torch.no_grad():
            got = model(torch.as_tensor(ids, dtype=torch.long),
                        attention_mask=torch.as_tensor(mask),
                        position_ids=torch.as_tensor(pos))[0]
            unwindowed = port(dataclasses.replace(cfg, sliding_window=None),
                              params)(torch.as_tensor(ids, dtype=torch.long),
                                      attention_mask=torch.as_tensor(mask),
                                      position_ids=torch.as_tensor(pos))[0]
        close(want, got.numpy())
        assert float((got - unwindowed).abs().max()) > 1e-2
        return
    want_toks, want_rows = jax_decode(cfg, params, ids, 6)
    got_toks, got_rows = port_decode(model, ids, 6)
    np.testing.assert_array_equal(want_toks, got_toks)
    for w, g in zip(want_rows, got_rows):
        close(w, g)
    _, plain_rows = port_decode(
        port(dataclasses.replace(cfg, sliding_window=None), params), ids, 6)
    assert max(float(np.abs(p - g).max())
               for p, g in zip(plain_rows[1:], got_rows[1:])) > 1e-2


def test_sliding_window_field_loads_as_jax_loads_it():
    """A 5.1B-style config.json carrying Phi-3.5-mini's published
    `sliding_window: 262144` builds in both packages with the field, and
    the port's logits equal those of the config without it."""
    from competesmoe_tpu.models.builder import \
        decoder_config_from_hf as jfrom_hf
    from competesmoe_tpu_torch.models.builder import (
        HF_5P1B, decoder_config_from_hf)
    hf = dict(HF_5P1B, vocab_size=64, hidden_size=32, intermediate_size=48,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, sliding_window=262144)
    assert jfrom_hf(hf, "llava_phi").sliding_window == 262144
    cfg = decoder_config_from_hf(hf, "llava_phi", torch.float32)
    assert cfg.sliding_window == 262144
    windowed = tdec.DecoderLM(cfg, device="cpu")
    plain = tdec.DecoderLM(dataclasses.replace(cfg, sliding_window=None),
                           device="cpu")
    torch.manual_seed(0)
    for p in plain.parameters():
        torch.nn.init.normal_(p, std=0.2)
    windowed.load_state_dict(plain.state_dict())
    ids = prompt(3)
    a = port_decode(windowed, ids, 4)
    b = port_decode(plain, ids, 4)
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# MPT: ALiBi, bias-free LayerNorm, GELU MLP, tied embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_heads", [4, 6])
def test_alibi_slopes_match_jax(n_heads):
    np.testing.assert_array_equal(jdec.alibi_slopes(n_heads),
                                  tdec.alibi_slopes(n_heads))


def test_mpt_convert_export_and_decode_match_jax():
    """One MPT-layout state dict (JAX's export of its init) through both
    packages' `convert_mpt`: equal tensors, no-cache logits within 1e-5,
    cache decode token-exact with logits within 1e-5; the port's
    `export_mpt` equals JAX's key for key."""
    cfg = mpt_cfg()
    params = build(cfg)["params"]
    sd = {k: np.asarray(v) for k, v in jexport.export_mpt(params,
                                                          cfg).items()}
    jparams = {"params": jloader.convert_mpt(sd, cfg)}
    tsd = tloader.convert_mpt({k: torch.tensor(v) for k, v in sd.items()},
                              tcfg(cfg))
    model = tdec.DecoderLM(tcfg(cfg), device="cpu")
    model.load_state_dict(tsd)
    ids = prompt()
    want = jdec.DecoderLM(cfg).apply(jparams, jnp.asarray(ids))[0]
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long))[0]
    close(want, got.numpy())
    want_toks, want_rows = jax_decode(cfg, jparams, ids, 6)
    got_toks, got_rows = port_decode(model, ids, 6)
    np.testing.assert_array_equal(want_toks, got_toks)
    for w, g in zip(want_rows, got_rows):
        close(w, g)
    out = texport.export_mpt(model, tcfg(cfg))
    assert sorted(out) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(out[k].numpy(), sd[k], k)


@pytest.mark.parametrize("kw", [dict(), dict(deferred_decode=True),
                                dict(kv_quant="int8", deferred_decode=True),
                                dict(sliding_window=5)],
                         ids=["plain", "deferred", "deferred_int8",
                              "window"])
def test_alibi_gqa_decode_matches_jax(kw):
    """ALiBi with GQA (the slopes as [hk, rep]) and the other MPT knobs
    on the cache paths: the deferred self column's distance is 0."""
    cfg = mpt_cfg(num_key_value_heads=2, **kw)
    params = build(cfg)
    want_toks, want_rows = jax_decode(cfg, params, prompt(), 6)
    got_toks, got_rows = port_decode(port(cfg, params), prompt(), 6)
    np.testing.assert_array_equal(want_toks, got_toks)
    for w, g in zip(want_rows, got_rows):
        close(w, g)


# ---------------------------------------------------------------------------
# deferred decode and the per-layer cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("option", [dict(deferred_decode=True),
                                    dict(cache_layout="per_layer"),
                                    dict(cache_layout="per_layer",
                                         deferred_decode=True)],
                         ids=["deferred", "per_layer", "per_layer_deferred"])
def test_deferred_and_per_layer_match_jax_and_default(option, kv_quant):
    """Each option's greedy tokens equal JAX's under the same option and
    the port's default; logits within 1e-5 of both (deferred sums the
    self column apart); JAX turns deferred off on a per-layer cache, and
    so does the port."""
    cfg = jcfg(kv_quant=kv_quant, **option)
    params = build(cfg)
    ids = prompt()
    want_toks, want_rows = jax_decode(cfg, params, ids, 6)
    got_toks, got_rows = port_decode(port(cfg, params), ids, 6)
    base_toks, base_rows = port_decode(
        port(jcfg(kv_quant=kv_quant), params), ids, 6)
    np.testing.assert_array_equal(want_toks, got_toks)
    np.testing.assert_array_equal(base_toks, got_toks)
    for w, g, b in zip(want_rows, got_rows, base_rows):
        close(w, g)
        close(b, g)
    cache = tdec.KVCache.create(tcfg(cfg), 2, 16)
    per_layer = option.get("cache_layout") == "per_layer"
    assert cache.per_layer == per_layer
    assert isinstance(cache.k, tuple) == per_layer


def _llava(**dec_kw):
    """The tiny LLaVA of tests/test_torch_port_models.py (int8 KV), its
    decoder changed by `dec_kw` (options that leave the parameters as
    they are), with JAX's init weights."""
    from competesmoe_tpu_torch.models import llava as tllava
    from tests.test_torch_port_models import jax_llava_cfg, port_llava_cfg
    jc = jax_llava_cfg(kv_quant="int8")
    jc = dataclasses.replace(jc, decoder=dataclasses.replace(jc.decoder,
                                                             **dec_kw))
    model = tllava.LlavaModel(port_llava_cfg(jc), device="cpu")
    model.load_state_dict(_llava_weights())
    return model


@functools.lru_cache(maxsize=None)
def _llava_weights():
    from competesmoe_tpu.models import llava as jllava
    from tests.test_torch_port_models import jax_llava_cfg
    ids = np.ones((1, 9), np.int32)
    ids[0, 2] = jllava.IMAGE_TOKEN_INDEX
    px = np.zeros((1, 28, 28, 3), np.float32)
    params = jax.jit(jllava.LlavaModel(jax_llava_cfg(kv_quant="int8")).init)(
        jax.random.PRNGKey(5), ids, px)
    return from_jax_params(params)


def _run_all(engine, reqs):
    """Requests [(ids, px, max_new)] through an engine stepped here:
    each one's emitted tokens."""
    made = [engine._make_request(ids, px, max_new_tokens=n)
            for ids, px, n in reqs]
    for _ in range(500):
        if all(r.done for r in made):
            break
        engine._tick()
    engine._tick()
    assert all(r.done for r in made)
    return [list(r.emitted) for r in made]


@torch.no_grad()
def _greedy_no_cache(model, ids, px, n):
    """`n` greedy tokens, each from a full forward without a cache (the
    no-cache mask path): the reference for every cache path."""
    ids = list(ids)
    out = []
    for _ in range(n):
        pv = None if px is None else torch.as_tensor(px)
        logits = model(torch.as_tensor([ids], dtype=torch.long), pv).logits
        tok = int(logits[0, -1].argmax())
        out.append(tok)
        ids.append(tok)
    return out


def _traffic(seed=6, n=5):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        ids = rng.integers(1, 64, (9 + 5 * i,)).astype(np.int32)
        px = None
        if i % 2 == 0:
            ids[1] = -200
            px = rng.uniform(-1, 1, (1, 28, 28, 3)).astype(np.float32)
        reqs.append((ids, px, 8))
    return reqs


def test_engine_paths_see_the_window():
    """Window 6 on the tiny LLaVA: grouped admission (image prompts),
    chunked prefill (text prompts past chunk 8), verify ticks (spec 2)
    and a prefix-cache unpark all give
    the tokens of full forwards without a cache, which mask by the
    window on their own path; the window changes them."""
    from competesmoe_tpu_torch.serve.engine import DecodeEngine
    model = _llava(sliding_window=6)
    reqs = _traffic()
    want = [_greedy_no_cache(model, ids, px, n) for ids, px, n in reqs]
    engine = DecodeEngine(model, n_slots=4, max_len=128, run_thread=False,
                          prefill_chunk=8, spec_k=2)
    assert _run_all(engine, reqs) == want
    # turn 2 of a text conversation through the prefix cache's unpark
    engine = DecodeEngine(model, n_slots=2, max_len=128, run_thread=False,
                          prefix_cache_slots=2)
    ids1 = reqs[1][0]
    got1 = _run_all(engine, [(ids1, None, 6)])[0]
    ids2 = np.concatenate([ids1, got1, [5, 9, 11, 3]]).astype(np.int32)
    got2 = _run_all(engine, [(ids2, None, 6)])[0]
    assert engine._prefix_hits == 1
    assert got2 == _greedy_no_cache(model, ids2, None, 6)
    plain = _llava()
    assert [_greedy_no_cache(plain, ids, px, n)
            for ids, px, n in reqs] != want


@pytest.mark.parametrize("option", [dict(deferred_decode=True),
                                    dict(cache_layout="per_layer")],
                         ids=["deferred", "per_layer"])
def test_engine_streams_equal_default(option):
    """The engine with deferred decode or a per-layer cache (admission,
    chunked prefill, verify ticks, parks and unparks) streams the default
    engine's tokens; solo `generate` too."""
    from competesmoe_tpu_torch.models.llava import generate
    from competesmoe_tpu_torch.serve.engine import DecodeEngine
    base, model = _llava(), _llava(**option)
    reqs = _traffic(7)
    kw = dict(n_slots=4, max_len=128, run_thread=False, prefill_chunk=8,
              prefix_cache_slots=2, spec_k=2)
    streams = []
    for m in (model, base):
        engine = DecodeEngine(m, **kw)
        out = _run_all(engine, reqs)
        # turn 2 of the first text conversation unparks its row
        ids2 = np.concatenate([reqs[1][0], out[1], [5, 9, 11]]).astype(
            np.int32)
        streams.append(out + _run_all(engine, [(ids2, None, 6)]))
        assert engine._prefix_hits == 1
    assert streams[0] == streams[1]
    for ids, px, n in reqs[:2]:
        a = generate(model, ids[None], px, max_new_tokens=n)[0]
        b = generate(base, ids[None], px, max_new_tokens=n)[0]
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# fold_norm_scales
# ---------------------------------------------------------------------------

def _randomize_norm_weights(params, seed=3):
    """The norm weights moved off 1 (folding ones is a no-op), as JAX's
    tests/test_serving_opts.py does."""
    key = jax.random.PRNGKey(seed)

    def visit(path, leaf):
        nonlocal key
        if any(getattr(p, "key", "") in ("input_layernorm",
                                         "post_attention_layernorm", "norm")
               for p in path) and leaf.ndim == 1:
            key, sub = jax.random.split(key)
            return leaf + jax.random.uniform(sub, leaf.shape, leaf.dtype,
                                             -0.3, 0.3)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


@pytest.mark.parametrize("family,quant", [
    ("phi", None), ("phi", "int8"), ("phi", "int4"), ("llama", "int4"),
    ("mpt", None), ("mpt", "int8")])
def test_fold_norm_scales_matches_jax(family, quant):
    """The port's in-place fold against JAX's on the same weights: int8
    and int4 `kernel_q` equal, scales within 1 ulp, float weights within
    1 ulp, every folded norm ones (the final norm of tied embeddings
    kept); then the folded models' logits within 1e-5 of JAX's folded
    model and of the unfolded one's."""
    base = dict(phi=jcfg(fused_qkv=True), llama=jcfg(), mpt=mpt_cfg())
    cfg = dataclasses.replace(base[family], quant=quant)
    params = _randomize_norm_weights(build(cfg))
    folded = jdec.fold_norm_scales(params, cfg)
    model = port(cfg, params)
    tdec.fold_norm_scales(model)
    assert model.cfg.norm_folded
    want = from_jax_params(folded)
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        g = got[k]
        if k.endswith("kernel_q"):
            assert torch.equal(w, g), k
        else:
            np.testing.assert_array_max_ulp(w.float().numpy(),
                                            g.float().numpy(), 1)
    assert (model.norm.weight == 1).all() != cfg.tie_word_embeddings
    assert model.norm.folded != cfg.tie_word_embeddings
    ids = jnp.asarray(prompt())
    jfold = jdec.DecoderLM(dataclasses.replace(cfg, norm_folded=True))
    want_logits = jfold.apply(folded, ids)[0]
    with torch.no_grad():
        got_logits = model(torch.as_tensor(np.asarray(ids),
                                           dtype=torch.long))[0]
    close(want_logits, got_logits.numpy())
    if quant is None:
        close(jdec.DecoderLM(cfg).apply(params, ids)[0], got_logits.numpy())


# ---------------------------------------------------------------------------
# w8a8
# ---------------------------------------------------------------------------

def _jax_w8a8_acc(x, kernel_q):
    """JAX's QuantDense w8a8 steps up to the int32 accumulator."""
    amax = jnp.max(jnp.abs(x), axis=-1, keepdims=True).astype(jnp.float32)
    xs = x.astype(jnp.float32) * (127.0 / jnp.maximum(amax, 1e-8))
    x8 = jnp.clip(jnp.round(xs), -127, 127).astype(jnp.int8)
    return jax.lax.dot_general(x8, kernel_q, (((x.ndim - 1,), (0,)),
                                              ((), ())),
                               preferred_element_type=jnp.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_accumulators_exact_and_outputs_match_jax(dtype):
    """K 4096 with a row and a column of one sign reach an odd |acc| >
    2^25, which float32 cannot hold: the port's int32 accumulators equal JAX's
    exactly (and a float32 product of the same operands does not); the
    layer's output is within one rounding of x's dtype of JAX's."""
    rng = np.random.default_rng(8)
    K, N = 4096, 64
    x = rng.normal(size=(2, 5, K)).astype(np.float32)
    x[0, 0] = 2.0                                    # int8 row of 127s
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    q[:, 0] = 127
    q[7, 0] = 126                        # an odd sum past 2^25
    q[::3, 1] = 101
    scale = rng.uniform(1e-3, 2e-3, (N,)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want_acc = np.asarray(_jax_w8a8_acc(jx, jnp.asarray(q)))
    tx = torch.as_tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    acc, amax = tdec.w8a8_accumulate(tx, torch.as_tensor(q))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    assert np.abs(want_acc).max() > 2 ** 24
    x8 = torch.round(tx.float() * (127.0 / amax)).clamp(-127, 127)
    assert not torch.equal((x8 @ torch.as_tensor(q).float()).long(),
                           acc.long())
    jlayer = jdec.QuantDense(N, mode="w8a8")
    want = jlayer.apply({"params": {"kernel_q": jnp.asarray(q),
                                    "scale": jnp.asarray(scale)}}, jx)
    layer = tdec.QuantDense(K, N, mode="w8a8", device="cpu")
    layer.kernel_q.copy_(torch.as_tensor(q))
    layer.scale.copy_(torch.as_tensor(scale))
    with torch.no_grad():
        got = layer(tx)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22
    close(want, got.float().numpy(), rtol=ulp, atol=0)


def test_w8a8_decoder_matches_jax():
    """A w8a8 decoder (its lm_head too) made by the port's
    quantize_decoder_to_int8(w8a8=True) from the float weights, against
    JAX's model with quant='w8a8' over JAX's int8 tree of the same
    weights: logits within 1e-5 and greedy tokens equal through the
    cache."""
    from competesmoe_tpu.models import builder as jbuilder
    from competesmoe_tpu_torch.models import builder as tbuilder
    cfg = jcfg()
    params = build(cfg)
    qcfg = dataclasses.replace(cfg, quant="w8a8")
    qparams = {"params": jbuilder.quantize_decoder_to_int8(
        params["params"], bits=8)}
    model = tbuilder.quantize_decoder_to_int8(port(cfg, params), bits=8,
                                              w8a8=True)
    assert model.cfg.quant == "w8a8" and model.lm_head.mode == "w8a8"
    assert model.layers[0].self_attn.q_proj.mode == "w8a8"
    # JAX's w8a8 tree (its int8 tree) crosses by from_jax_params as is
    loaded = tdec.DecoderLM(tcfg(qcfg), device="cpu")
    loaded.load_state_dict(from_jax_params(qparams))
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    ids = prompt()
    close(jdec.DecoderLM(qcfg).apply(qparams, jnp.asarray(ids))[0],
          model(torch.as_tensor(ids, dtype=torch.long))[0].detach().numpy())
    want_toks, want_rows = jax_decode(qcfg, qparams, ids, 5)
    got_toks, got_rows = port_decode(model, ids, 5)
    np.testing.assert_array_equal(want_toks, got_toks)
    for w, g in zip(want_rows, got_rows):
        close(w, g)
