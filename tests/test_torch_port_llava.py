"""Parity of the PyTorch port's LLaVA serving slice with the JAX package
as a whole: greedy generation through `stream_generate` and `generate`
(plain, and with the worker's --load-4bit quantization), stops, sampling,
the worker's preprocessing, and the HTTP worker.

Weights come from the JAX model's init and cross through
`convert.from_jax_params`; inputs are numpy from a seed. Greedy tokens
must be identical.
"""

import base64
import dataclasses
import io
import json
import socket
from urllib import request as urlrequest

import jax
import numpy as np
import pytest
import torch

from competesmoe_tpu.models import builder as jbuilder
from competesmoe_tpu.models import llava as jllava
from competesmoe_tpu_torch.convert import from_jax_params
from competesmoe_tpu_torch.models import builder as tbuilder
from competesmoe_tpu_torch.models import llava as tllava
from tests.test_torch_port_models import (IMG, _prompt, jax_llava_cfg,
                                          port_llava_cfg)
from tests.test_torch_port_ops import close


@pytest.fixture(scope="module")
def jax_model():
    cfg = jax_llava_cfg()
    ids, px = _prompt()
    params = jllava.LlavaModel(cfg).init(jax.random.PRNGKey(0), ids, px)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def port_model(jcfg, params):
    model = tllava.LlavaModel(port_llava_cfg(jcfg), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return model


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _greedy_tokens_jax(cfg, params, ids, px, n):
    model = jllava.LlavaModel(cfg)
    chunks = list(jllava.stream_generate(model, params, ids, px,
                                         max_new_tokens=n))
    return np.concatenate(chunks, axis=1)


@pytest.mark.parametrize("load_4bit", [False, True])
def test_llava_greedy_generation_matches_jax(jax_model, load_4bit):
    """Prefill + 6 greedy tokens through stream_generate. load_4bit: the
    JAX builder's --load-4bit param transforms against the port's
    apply_load_4bit on the same f32 weights, with an int8 KV cache."""
    cfg, params = jax_model
    ids, px = _prompt()
    if load_4bit:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, kv_quant="int8"))
    model = port_model(cfg, params)
    if load_4bit:
        p = params["params"]
        params = {"params": {
            "language_model": jbuilder.quantize_decoder_to_int8(
                p["language_model"], bits=4),
            **jbuilder.quantize_nf4_weight_only(
                {k: v for k, v in p.items() if k != "language_model"})}}
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, quant="int4"))
        tbuilder.apply_load_4bit(model)
        assert model.cfg.decoder.quant == "int4"
        want_sd = from_jax_params(params)
        got_sd = model.state_dict()
        assert set(want_sd) == set(got_sd)
        for key, v in want_sd.items():
            if key.endswith("kernel_q"):
                assert torch.equal(v, got_sd[key]), key
            else:
                close(v, got_sd[key], rtol=1e-6, atol=1e-7)
    want = _greedy_tokens_jax(cfg, params, ids, px, 7)
    chunks = list(tllava.stream_generate(model, ids, px, max_new_tokens=7))
    assert [c.shape[1] for c in chunks] == [1, 1, 2, 3]
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), want)
    toks, out = tllava.generate(model, ids, px, max_new_tokens=7)
    np.testing.assert_array_equal(toks, want)
    assert out.vision_auxes is not None and out.projector_aux is not None


def test_llava_text_prompt_and_stops_match_jax(jax_model):
    """Text-only prompt with right padding in a batch of two; a stop id
    taken from the greedy stream ends both the JAX and the port stream at
    the same chunk."""
    cfg, params = jax_model
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 64, (2, 5)).astype(np.int32)
    mask = np.ones((2, 5), np.int32)
    mask[1, 3:] = 0
    model = port_model(cfg, params)
    jm = jllava.LlavaModel(cfg)
    free = np.concatenate(list(jllava.stream_generate(
        jm, params, ids, None, attention_mask=mask, max_new_tokens=6)), 1)
    got = np.concatenate(list(tllava.stream_generate(
        model, ids, None, attention_mask=mask, max_new_tokens=6)), 1)
    np.testing.assert_array_equal(got, free)
    stop = int(free[0, 2])
    want = list(jllava.stream_generate(jm, params, ids, None,
                                       attention_mask=mask, max_new_tokens=6,
                                       eos_token_id=stop))
    got = list(tllava.stream_generate(model, ids, None, attention_mask=mask,
                                      max_new_tokens=6, eos_token_id=stop))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_sampling():
    """Temperature / nucleus sampling: a nucleus narrower than the top
    token's mass keeps only the argmax; draws follow the softmax."""
    rng = np.random.default_rng(6)
    logits = torch.as_tensor(rng.normal(size=(4, 32)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    greedy = tllava.sample_token(logits)
    assert torch.equal(tllava.sample_token(logits, g, 0.7, 1e-6), greedy)
    skew = torch.full((1, 32), -30.0)
    skew[0, 5] = 0.0
    skew[0, 9] = np.log(3.0)                 # p(9) = 3 * p(5)
    draws = torch.stack([tllava.sample_token(skew, g, 1.0, 1.0)
                         for _ in range(400)])
    assert set(draws.unique().tolist()) <= {5, 9}
    assert 0.65 < float((draws == 9).float().mean()) < 0.85


def _repetitive_prompt(seed=18, B=1):
    """A prompt whose n-grams recur, so that drafts exist, with an
    image."""
    rng = np.random.default_rng(seed)
    ids = np.tile(rng.integers(1, 64, (B, 4)), 3).astype(np.int32)
    ids[:, 2] = IMG
    px = rng.uniform(-1, 1, (B, 28, 28, 3)).astype(np.float32)
    return ids, px


def test_speculative_is_not_ported_yet(jax_model):
    """Speculative greedy decoding (formerly refused here) is ported:
    stream_generate(speculative=2) and generate(speculative=2) are
    token-exact against JAX's and against the port's sequential greedy
    decoding, with chunks of 1..3 tokens after the first."""
    cfg, params = jax_model
    ids, px = _repetitive_prompt()
    model = port_model(cfg, params)
    jm = jllava.LlavaModel(cfg)
    want = np.concatenate(list(jllava.stream_generate(
        jm, params, ids, px, max_new_tokens=12, speculative=2)), 1)
    chunks = list(tllava.stream_generate(model, ids, px, max_new_tokens=12,
                                         speculative=2))
    assert all(1 <= c.shape[1] <= 3 for c in chunks)
    got = np.concatenate(chunks, 1)
    np.testing.assert_array_equal(got, want)
    plain = np.concatenate(list(tllava.stream_generate(
        model, ids, px, max_new_tokens=12)), 1)
    np.testing.assert_array_equal(got, plain)
    toks, _ = tllava.generate(model, ids, px, max_new_tokens=12,
                              speculative=2)
    jtoks, _ = jllava.generate(jm, params, ids, px, max_new_tokens=12,
                               speculative=2)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))


# ---------------------------------------------------------------------------
# the worker over HTTP
# ---------------------------------------------------------------------------

def _png_base64(seed, size=(37, 23)):
    from PIL import Image
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("bos", [None, 1])
def test_mm_utils_match_jax(bos):
    """Worker-side preprocessing: base64 image -> pixels, and prompt ->
    ids around '<image>', exactly as the JAX package does."""
    from competesmoe_tpu.multimodal import mm_utils as jmm
    from competesmoe_tpu_torch.multimodal import mm_utils as tmm
    images = [_png_base64(s) for s in (1, 2)]
    for size in (28, 224):
        want = jmm.process_images(
            [jmm.load_image_from_base64(b) for b in images],
            jmm.ImageProcessorConfig(size=size))
        got = tmm.process_images(
            [tmm.load_image_from_base64(b) for b in images],
            tmm.ImageProcessorConfig(size=size))
        assert got.shape == (2, size, size, 3)
        np.testing.assert_array_equal(want, got)

    tok = _WordTok(bos)
    for prompt in ("<image> describe it", "a <image> b <image> c", "none",
                   "end <image>"):
        want = jmm.tokenizer_image_token(prompt, tok)
        assert tmm.tokenizer_image_token(prompt, tok) == want
        assert want.count(IMG) == prompt.count("<image>")
        assert want[0] == (bos if bos is not None else want[0])


class _WordTok:
    """Word-level stand-in tokenizer; with a BOS id it prepends it to
    every encoding, as HF llama-family tokenizers do."""

    eos_token_id = 0

    def __init__(self, bos_token_id=None):
        self.bos_token_id = bos_token_id
        self.vocab = {}

    def __call__(self, text):
        ids = [self.vocab.setdefault(w, 1 + len(self.vocab) % 63)
               for w in text.split()]
        if self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids if int(i) != 0)


def test_worker_http_on_cpu(jax_model):
    from competesmoe_tpu_torch.eval import TorchLlava
    from competesmoe_tpu_torch.multimodal.mm_utils import (
        ImageProcessorConfig)
    from competesmoe_tpu_torch.serve.model_worker import (
        ModelWorker, serve_worker, torch_llava_generate_fn)
    cfg, params = jax_model
    adapter = TorchLlava(port_model(cfg, params), _WordTok(),
                         ImageProcessorConfig(size=28), max_new_tokens=3)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worker = ModelWorker(None, f"http://127.0.0.1:{port}", ["tiny"],
                         torch_llava_generate_fn(adapter), register=False)
    httpd = serve_worker(worker, "127.0.0.1", port, background=True)
    try:
        def post(path, data):
            req = urlrequest.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(data).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urlrequest.urlopen(req, timeout=60) as r:
                return r.read()

        status = json.loads(post("/worker_get_status", {}))
        assert status["model_names"] == ["tiny"]
        body = post("/worker_generate_stream",
                    {"prompt": "hello red cat", "max_new_tokens": 4})
        chunks = [json.loads(p) for p in body.split(b"\0") if p]
        assert chunks and all(c["error_code"] == 0 for c in chunks)
        body = post("/worker_generate_stream",
                    {"prompt": "<image> what is it", "max_new_tokens": 3,
                     "images": [_png_base64(7)]})
        chunks = [json.loads(p) for p in body.split(b"\0") if p]
        assert chunks and all(c["error_code"] == 0 for c in chunks)
        plain = post("/worker_generate_stream",
                     {"prompt": "a b a b a b", "max_new_tokens": 6})
        spec = post("/worker_generate_stream",
                    {"prompt": "a b a b a b", "max_new_tokens": 6,
                     "speculative": 2})
        last = [[json.loads(p) for p in b.split(b"\0") if p][-1]
                for b in (plain, spec)]
        assert all(c["error_code"] == 0 for c in last)
        assert last[1]["text"] == last[0]["text"]
    finally:
        httpd.shutdown()
        httpd.server_close()
