"""The decoder's windowed KV read (`attn_window`) in the PyTorch port
against the JAX package's, on the CPU.

With a cache, `DecoderLM(..., attn_window=w)` attends over the cache's
first w slots only, the mask built over as many keys; the caller keeps
pos + T <= w. The same weights (`convert.from_jax_params`) and the same
numpy inputs go through JAX's decoder and the port's: prefill of a
left-padded batch, then greedy decode steps with the window, with a
float32 cache and with the int8 cache (per-slot scales sliced with the
values). Tolerance: float32 rtol/atol 1e-4, the decoder parity tests'
(tests/test_torch_port_models.py); the greedy tokens are equal. In the
port alone, windowed decoding gives the tokens of decoding over the whole
cache, as tests/test_kv_quant.py shows for JAX, down to a window that
ends at the last written slot.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import decoder as jdec
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import decoder as tdec
from tests.test_torch_port_ops import close, port_config

B, T, MAX, STEPS = 2, 6, 64, 5


def _jax_cfg(**change):
    """tests/test_kv_quant.py's geometry: GQA, 4 query heads over 2 KV
    heads."""
    return dataclasses.replace(jdec.DecoderConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, original_max_position_embeddings=128,
        fused_qkv=True, dtype=jnp.float32), **change)


def _models(**change):
    jcfg = _jax_cfg(**change)
    ids = np.random.default_rng(0).integers(1, 64, (B, T)).astype(np.int32)
    jm = jdec.DecoderLM(jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids))
    pm = tdec.DecoderLM(port_config(jcfg, tdec.DecoderConfig), device="cpu")
    pm.load_state_dict(from_jax_params(params))
    return jm, params, pm, ids


def _mask():
    """Row 1 left-padded by 2: its tokens start at position 0 of the
    cache all the same."""
    mask = np.ones((B, T), np.int32)
    mask[1, :2] = 0
    return mask


def _port_decode(pm, ids, window, steps=STEPS):
    """Prefill, then `steps` greedy steps with `window`: (tokens
    [steps + 1, B], each step's logits)."""
    cache = tdec.KVCache.create(pm.cfg, B, MAX, "cpu")
    mask = torch.as_tensor(_mask())
    with torch.no_grad():
        logits, cache, _ = pm(torch.as_tensor(ids).long(),
                              attention_mask=mask, cache=cache)
        tok = logits[:, -1].argmax(-1)
        toks, step_logits = [tok.numpy()], []
        for _ in range(steps):
            logits, cache, _ = pm(tok[:, None], cache=cache,
                                  attn_window=window)
            step_logits.append(logits[:, 0].numpy())
            tok = logits[:, 0].argmax(-1)
            toks.append(tok.numpy())
    return np.stack(toks), step_logits, cache


@pytest.mark.parametrize("change", [
    {}, dict(kv_quant="int8"), dict(kv_quant="int8", quant="int4"),
    dict(num_key_value_heads=4)], ids=["f32", "kv8", "int4-kv8", "mha"])
def test_windowed_decode_matches_jax(change):
    """Prefill of 6 tokens (one row left-padded), then 5 greedy decode
    steps with attn_window 16: each step's logits agree with JAX's
    windowed decoder, the tokens and the cache positions are equal."""
    jm, params, pm, ids = _models(**change)
    jcache = jdec.KVCache.create(jm.cfg, B, MAX)
    jl, jcache, _ = jm.apply(params, jnp.asarray(ids),
                             attention_mask=jnp.asarray(_mask()),
                             cache=jcache)
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    want_toks, want_logits = [np.asarray(tok)], []
    for _ in range(STEPS):
        jl, jcache, _ = jm.apply(params, tok[:, None], cache=jcache,
                                 attn_window=16)
        want_logits.append(np.asarray(jl[:, 0]))
        tok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)
        want_toks.append(np.asarray(tok))
    toks, logits, cache = _port_decode(pm, ids, 16)
    for got, want in zip(logits, want_logits):
        close(want, got)
    np.testing.assert_array_equal(toks, np.stack(want_toks))
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("window", [11, 16, 64, 100])
def test_windowed_tokens_equal_unwindowed(kv_quant, window):
    """Windowed decoding gives the tokens and, within the stated
    tolerance, the logits of decoding over the whole 64-slot cache: at a
    window of 11, the last step's own key is the window's last slot; 64
    and 100 do not cut the cache."""
    _, _, pm, ids = _models(kv_quant=kv_quant)
    full_toks, full_logits, _ = _port_decode(pm, ids, None)
    toks, logits, _ = _port_decode(pm, ids, window)
    np.testing.assert_array_equal(toks, full_toks)
    for got, want in zip(logits, full_logits):
        close(want, got)


def test_window_below_the_live_prefix_changes_the_logits():
    """A window that cuts off written keys (below the contract pos + T <=
    attn_window) reads another function: the check above can see a slice
    or mask off by one key."""
    _, _, pm, ids = _models()
    _, full_logits, _ = _port_decode(pm, ids, None)
    _, logits, _ = _port_decode(pm, ids, 10)
    assert np.abs(logits[-1] - full_logits[-1]).max() > 1e-3
