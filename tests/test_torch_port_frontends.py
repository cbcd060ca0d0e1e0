"""The PyTorch port's serving front ends against the JAX package's: the
conversation templates and the OpenAI API's prompt rendering (byte for
byte), the controller's registry and dispatch, the stream client; and the
port's whole HTTP stack on the CPU (controller, a worker on the
DecodeEngine with its prefix cache, chunked prefill and speculation, the
OpenAI API and the web chat), whose greedy text must equal the worker's
solo path, plus the chat CLI.
"""

import base64
import io
import json
import socket
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import request as urlrequest

import numpy as np
import pytest

from competesmoe_tpu.multimodal import conversation as jconv
from competesmoe_tpu.serve import controller as jcontroller
from competesmoe_tpu.serve import openai_api as japi
from competesmoe_tpu.serve import stream_client as jstream
from competesmoe_tpu_torch.multimodal import conversation as tconv
from competesmoe_tpu_torch.serve import controller as tcontroller
from competesmoe_tpu_torch.serve import openai_api as tapi
from competesmoe_tpu_torch.serve import stream_client as tstream

B64 = base64.b64encode(b"xx").decode()

# message lists for the templates: (role index, text or (text, image));
# an image rides the first message as the reference's gradio flow sends it
DIALOGUES = [
    [(0, "hi"), (1, None)],
    [(0, "what is this"), (1, "a cat"), (0, "and its colour?"), (1, None)],
    [(0, ("<image>\ndescribe it", "img")), (1, None)],
    [(0, ("tell me", "img")), (1, "a dog"), (0, "more"), (1, "")],
]

# OpenAI message lists for _render_prompt
MESSAGES = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "be brief"},
     {"role": "user", "content": "hi"},
     {"role": "assistant", "content": "hello"},
     {"role": "user", "content": "again"}],
    [{"role": "user", "content": [
        {"type": "text", "text": "what is this"},
        {"type": "image_url",
         "image_url": {"url": f"data:image/png;base64,{B64}"}}]}],
    [{"role": "user", "content": "hi"},
     {"role": "assistant", "content": "hello"},
     {"role": "user", "content": [
         {"type": "text", "text": "and this?"},
         {"type": "image_url", "image_url": {"url": B64}},
         {"type": "image_url", "image_url": {"url": B64}}]}],
]


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_conversation_template_renders_as_jax(name):
    """Every template, over text turns, an image first turn (with and
    without its own <image> text) and an empty last message: the same
    prompt string as JAX's; copy() leaves the template untouched."""
    assert sorted(tconv.conv_templates) == sorted(jconv.conv_templates)
    for dialogue in DIALOGUES:
        convs = []
        for mod in (jconv, tconv):
            conv = mod.conv_templates[name].copy()
            for role, msg in dialogue:
                conv.append_message(conv.roles[role], msg)
            convs.append(conv)
        assert convs[1].get_prompt() == convs[0].get_prompt()
        assert tconv.conv_templates[name].messages == []
    t, j = tconv.conv_templates[name], jconv.conv_templates[name]
    assert (t.system, t.roles, t.sep_style.name, t.sep, t.sep2,
            t.version) == (j.system, j.roles, j.sep_style.name, j.sep,
                           j.sep2, j.version)


def test_separator_styles_and_default_match_jax():
    assert [s.name for s in tconv.SeparatorStyle] == [
        s.name for s in jconv.SeparatorStyle]
    assert tconv.default_conversation.version == "phi35"
    from competesmoe_tpu_torch.multimodal import Conversation, conv_templates
    assert conv_templates is tconv.conv_templates
    assert Conversation is tconv.Conversation
    bad = tconv.conv_templates["phi35"].copy()
    bad.sep_style = "nope"
    with pytest.raises(ValueError):
        bad.get_prompt()


@pytest.mark.parametrize("template", ["phi35", "llama_2", "v1", "mpt",
                                      "plain", "phi3", "smollm"])
def test_render_prompt_matches_jax(template):
    """OpenAI messages (system, roles, vision parts in the first and in a
    later turn, data URLs and raw base64) render to JAX's prompt, image
    list and stop string."""
    for messages in MESSAGES:
        assert tapi._render_prompt(template, messages) == \
            japi._render_prompt(template, messages)
    prompt, images, _ = tapi._render_prompt("phi35", MESSAGES[3])
    assert images == [B64, B64]
    assert prompt.index("<image>") > prompt.index("hello")


@pytest.mark.parametrize("template", ["phi35", "v1", "plain"])
def test_rendered_prompt_tokenizes_as_jax_worker(template):
    """What the worker receives from the OpenAI API (a prompt rendered
    through the template, with or without images) tokenizes through
    TorchLlava as through JAX's adapter: the image sentinel where the
    template put <image>."""
    from competesmoe_tpu.eval.llava_adapter import JaxLlava
    from competesmoe_tpu_torch.eval import TorchLlava

    class Tok:
        def __call__(self, text):
            return type("E", (), {"input_ids": [len(w) for w in
                                                text.split()]})()

    model = type("M", (), {"cfg": type("C", (), {"vision": type(
        "V", (), {"image_size": 28})()})()})()
    adapter = TorchLlava(model, Tok(), conv_template=template)
    stub = type("J", (), {"tokenizer": Tok()})()
    for messages in MESSAGES:
        prompt, images, _ = tapi._render_prompt(template, messages)
        ids = adapter.tokenizer_ids_for_prompt(prompt, bool(images))
        assert ids == JaxLlava.tokenizer_ids_for_prompt(stub, prompt,
                                                        bool(images))
        assert ids.count(-200) == len(images)


# ---------------------------------------------------------------------------
# controller and stream client
# ---------------------------------------------------------------------------

def test_controller_registry_and_dispatch_match_jax(monkeypatch):
    """The same registrations, heartbeats and dispatches through both
    controllers: the same models, the same shortest-queue picks, the same
    lottery picks from the same numpy seed, and stale workers dropped
    after CONTROLLER_HEART_BEAT_EXPIRATION."""
    from competesmoe_tpu.constants import (
        CONTROLLER_HEART_BEAT_EXPIRATION as JEXP)
    from competesmoe_tpu_torch.constants import (
        CONTROLLER_HEART_BEAT_EXPIRATION)
    assert CONTROLLER_HEART_BEAT_EXPIRATION == JEXP
    now = [1000.0]
    results = []
    for mod in (jcontroller, tcontroller):
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
        out = []
        for method in ("shortest_queue", "lottery"):
            now[0] = 1000.0
            c = mod.Controller(method)
            out.append(c.register_worker("http://a", True, {
                "model_names": ["m1", "m2"], "speed": 1.0,
                "queue_length": 3}))
            c.register_worker("http://b", True, {
                "model_names": ["m1"], "speed": 2.0, "queue_length": 1})
            c.register_worker("http://c", False, {
                "model_names": ["m3"], "speed": 1.0, "queue_length": 0})
            out.append(c.list_models())
            np.random.seed(5)
            out.append([c.get_worker_address("m1") for _ in range(6)])
            out.append(c.get_worker_address("nope"))
            out.append(c.receive_heart_beat("http://a", 0))
            out.append(c.receive_heart_beat("http://zz", 0))
            now[0] += CONTROLLER_HEART_BEAT_EXPIRATION - 1
            c.receive_heart_beat("http://b", 2)
            now[0] += 2
            c.remove_stale_workers()
            out.append(sorted(c.worker_info))
            out.append({n: (i.queue_length, i.speed)
                        for n, i in sorted(c.worker_info.items())})
        results.append(out)
    assert results[1] == results[0]
    # shortest queue: b's queue / speed grows 0.5 a pick from 0.5 and
    # reaches a's 3 at the sixth, where the first registered wins
    assert results[1][2] == ["http://b"] * 5 + ["http://a"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_stream_client_reassembles_split_messages_as_jax():
    """A stream whose \\0-delimited JSON messages arrive split across
    writes at odd byte boundaries parses into the same dicts as JAX's
    client, in order."""
    msgs = [{"text": "a" * n, "error_code": 0} for n in (1, 5000, 3, 0)]
    raw = b"".join(json.dumps(m).encode() + b"\0" for m in msgs)

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.end_headers()
            for i in range(0, len(raw), 777):
                self.wfile.write(raw[i:i + 777])
                self.wfile.flush()

    port = _free_port()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{port}/x"
        got = list(tstream.iter_worker_stream(url, {"q": 1}, timeout=30))
        want = list(jstream.iter_worker_stream(url, {"q": 1}, timeout=30))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert got == want == msgs


# ---------------------------------------------------------------------------
# the HTTP stack on the CPU
# ---------------------------------------------------------------------------

class WordTok:
    """Whitespace words to ids 1..63; decode writes id i as the word
    't<i>', which encodes back to i, so a reply quoted in the next turn
    tokenizes to the tokens the model emitted."""
    eos_token_id = None

    def __init__(self):
        self.vocab = {}

    def __call__(self, text):
        ids = [int(w[1:]) if w[:1] == "t" and w[1:].isdigit()
               else self.vocab.setdefault(w, 1 + len(self.vocab) % 63)
               for w in text.split()]
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{int(i)}" for i in ids)


@pytest.fixture(scope="module")
def port_model():
    from competesmoe_tpu_torch.models.builder import build_llava
    from tests.test_llava import tiny_llava_cfg
    from tests.test_torch_port_models import port_llava_cfg
    return build_llava(port_llava_cfg(tiny_llava_cfg(moe=False)), seed=3,
                       device="cpu")


@pytest.fixture(scope="module")
def stack(port_model, tmp_path_factory):
    """The port's controller, a worker on a DecodeEngine (2 slots, prefix
    cache, chunk 16, speculation 2) registered with it, the OpenAI API
    and the web chat, on free ports of 127.0.0.1."""
    from competesmoe_tpu_torch.eval import TorchLlava
    from competesmoe_tpu_torch.multimodal.mm_utils import (
        ImageProcessorConfig)
    from competesmoe_tpu_torch.serve.controller import serve_controller
    from competesmoe_tpu_torch.serve.model_worker import (
        ModelWorker, engine_generate_fn, make_engine, serve_worker,
        torch_llava_generate_fn)
    from competesmoe_tpu_torch.serve.web import serve_web

    tok = WordTok()
    adapter = TorchLlava(port_model, tok, ImageProcessorConfig(size=28),
                         max_new_tokens=6)
    engine = make_engine(port_model, 2, 256, speculative=2,
                         prefix_cache=2, prefill_chunk=16)
    cport, wport, oport, webport = (_free_port() for _ in range(4))
    caddr = f"http://127.0.0.1:{cport}"
    _, chttpd = serve_controller("127.0.0.1", cport, background=True)
    worker = ModelWorker(caddr, f"http://127.0.0.1:{wport}", ["tiny"],
                         engine_generate_fn(adapter, engine), register=True,
                         extra_status_fn=engine.stats)
    whttpd = serve_worker(worker, "127.0.0.1", wport, background=True)
    ohttpd = tapi.serve_openai_api(caddr, "127.0.0.1", oport,
                                   conv_template="phi35", background=True)
    log_dir = tmp_path_factory.mktemp("conv_logs")
    webhttpd = serve_web(caddr, "tiny", "127.0.0.1", webport,
                         background=True, log_dir=str(log_dir))
    solo = torch_llava_generate_fn(adapter)
    yield dict(api=f"http://127.0.0.1:{oport}",
               web=f"http://127.0.0.1:{webport}", engine=engine,
               solo=lambda params: list(solo(params))[-1],
               log_dir=log_dir)
    engine.shutdown()
    for h in (webhttpd, ohttpd, whttpd, chttpd):
        h.shutdown()
        h.server_close()


def _post(url, data, timeout=120):
    req = urlrequest.Request(url, data=json.dumps(data).encode(),
                             method="POST",
                             headers={"Content-Type": "application/json"})
    with urlrequest.urlopen(req, timeout=timeout) as r:
        return r.read()


def _sse(url, data):
    """(concatenated content of an SSE completion, chunks, saw [DONE])."""
    body = _post(url, dict(data, stream=True)).decode()
    text, chunks, done = "", [], False
    for line in body.splitlines():
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        if payload == "[DONE]":
            done = True
            break
        ch = json.loads(payload)
        chunks.append(ch)
        choice = ch["choices"][0]
        text += (choice["delta"].get("content", "") if "delta" in choice
                 else choice["text"])
    return text, chunks, done


def _solo_text(stack, messages, max_new):
    prompt, _, stop = tapi._render_prompt("phi35", messages)
    return stack["solo"]({"prompt": prompt, "max_new_tokens": max_new,
                          "stop": [stop]})


def test_openai_api_models_endpoint(stack):
    with urlrequest.urlopen(stack["api"] + "/v1/models", timeout=30) as r:
        d = json.loads(r.read())
    assert d["object"] == "list"
    assert [m["id"] for m in d["data"]] == ["tiny"]


def test_chat_completions_equal_the_solo_path(stack):
    """Three chat completions through API -> controller -> engine worker,
    one streamed (SSE deltas with one role chunk and [DONE]) and a turn 2
    that quotes turn 1's reply (a prefix-cache hit): each text equals the
    worker's solo stream_generate path for the rendered prompt."""
    url = stack["api"] + "/v1/chat/completions"
    hits0 = stack["engine"].stats()["engine_prefix_cache_hits"]
    m1 = [{"role": "user", "content": "hello world red cat what is this"}]
    d = json.loads(_post(url, {"model": "tiny", "messages": m1,
                               "max_tokens": 6, "temperature": 0.0}))
    assert d["object"] == "chat.completion"
    assert d["choices"][0]["finish_reason"] == "stop"
    reply = d["choices"][0]["message"]["content"]
    assert reply == _solo_text(stack, m1, 6) and reply
    m2 = [{"role": "system", "content": "be brief"}] + m1
    text, chunks, done = _sse(url, {"model": "tiny", "messages": m2,
                                    "max_tokens": 6, "temperature": 0.0})
    assert done and text == _solo_text(stack, m2, 6)
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert sum("role" in c["choices"][0]["delta"] for c in chunks) == 1
    m3 = m1 + [{"role": "assistant", "content": reply},
               {"role": "user", "content": "and the dog"}]
    d = json.loads(_post(url, {"model": "tiny", "messages": m3,
                               "max_tokens": 5, "temperature": 0.0}))
    assert d["choices"][0]["message"]["content"] == _solo_text(stack, m3, 5)
    assert stack["engine"].error is None
    assert stack["engine"].stats()["engine_tokens_emitted"] > 0
    # turn 2 of the first conversation reused its parked row
    assert stack["engine"].stats()["engine_prefix_cache_hits"] == hits0 + 1


def test_vision_request_and_stop_list(stack):
    """An image part reaches the worker (the reply equals the solo path
    with the same image); a stop list cuts the reply at the earliest hit."""
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (32, 32), (120, 30, 200)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    url = stack["api"] + "/v1/chat/completions"
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "what is this"},
        {"type": "image_url",
         "image_url": {"url": f"data:image/png;base64,{b64}"}}]}]
    d = json.loads(_post(url, {"model": "tiny", "messages": msgs,
                               "max_tokens": 4, "temperature": 0.0}))
    prompt, images, stop = tapi._render_prompt("phi35", msgs)
    assert d["choices"][0]["message"]["content"] == stack["solo"](
        {"prompt": prompt, "images": images, "max_new_tokens": 4,
         "stop": [stop]})
    base = {"model": "tiny", "max_tokens": 6, "temperature": 0.0,
            "messages": [{"role": "user", "content": "hello world"}]}
    text = json.loads(_post(url, base))["choices"][0]["message"]["content"]
    words = text.split()
    assert len(words) >= 2
    cut = json.loads(_post(url, dict(base, stop=["zzz", words[1]])))
    cut_text = cut["choices"][0]["message"]["content"]
    assert cut_text == text[:text.index(words[1])]


def test_worker_errors_surface_as_api_errors(stack):
    """No worker for the model: a 502 error object, not a completion;
    streamed, an SSE error event and [DONE]; an unknown route 404."""
    url = stack["api"] + "/v1/chat/completions"
    body = {"model": "no-such-model", "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi"}]}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    assert e.value.code == 502 and "error" in json.loads(e.value.read())
    sse = _post(url, dict(body, stream=True)).decode()
    assert '"error"' in sse and sse.rstrip().endswith("data: [DONE]")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(stack["api"] + "/v1/embeddings", {})
    assert e.value.code == 404


def test_legacy_completions_endpoint(stack):
    """/v1/completions takes the raw prompt (no template): the text equals
    the solo path's for that prompt, streamed or not."""
    url = stack["api"] + "/v1/completions"
    body = {"model": "tiny", "prompt": "hello world hello",
            "max_tokens": 5, "temperature": 0.0}
    d = json.loads(_post(url, body))
    assert d["object"] == "text_completion" and d["id"].startswith("cmpl-")
    want = stack["solo"]({"prompt": "hello world hello",
                          "max_new_tokens": 5})
    assert d["choices"][0]["text"] == want
    text, chunks, done = _sse(url, body)
    assert done and text == want
    assert all(c["object"] == "text_completion" for c in chunks)


def test_web_chat_and_conversation_log(stack):
    """The page is served; /models lists the controller's models; /chat
    and /chat_stream answer with the solo path's text for the templated
    conversation and append it to the day's conversation log, as /vote
    does."""
    web = stack["web"]
    with urlrequest.urlopen(web + "/", timeout=30) as r:
        assert b"CompeteSMoE chat" in r.read()
    with urlrequest.urlopen(web + "/models", timeout=30) as r:
        assert json.loads(r.read())["models"] == ["tiny"]
    msgs = [["USER", "red cat red cat"]]
    conv = tconv.conv_templates["phi35"].copy()
    conv.append_message(conv.roles[0], msgs[0][1])
    conv.append_message(conv.roles[1], None)
    params = {"messages": msgs, "model": "tiny", "temperature": 0.0,
              "max_new_tokens": 5}
    want = stack["solo"]({"prompt": conv.get_prompt(), "max_new_tokens": 5,
                          "stop": conv.sep2})
    assert json.loads(_post(web + "/chat", params))["text"] == want
    lines = _post(web + "/chat_stream", params).decode().splitlines()
    assert json.loads(lines[-1])["text"] == want
    assert json.loads(_post(web + "/vote", {"type": "upvote",
                                            "messages": msgs}))["ok"]
    logs = list(stack["log_dir"].glob("*-conv.json"))
    assert len(logs) == 1
    recs = [json.loads(x) for x in logs[0].read_text().splitlines()]
    assert [r["type"] for r in recs] == ["chat", "chat", "upvote"]
    assert recs[0]["state"]["messages"][-1] == ["ASSISTANT", want]


# ---------------------------------------------------------------------------
# the chat CLI
# ---------------------------------------------------------------------------

def test_chat_loop_streams_the_templated_turns(port_model):
    """Two turns typed into chat_loop: each reply equals stream_generate's
    greedy text for the conversation so far rendered through the
    template, and the conversation keeps both replies."""
    from competesmoe_tpu_torch.eval import TorchLlava
    from competesmoe_tpu_torch.models.llava import stream_generate
    from competesmoe_tpu_torch.multimodal.mm_utils import (
        ImageProcessorConfig)
    from competesmoe_tpu_torch.serve.cli import chat_loop

    tok = WordTok()
    adapter = TorchLlava(port_model, tok, ImageProcessorConfig(size=28))
    out = io.StringIO()
    conv = chat_loop(adapter, max_new_tokens=5,
                     in_stream=io.StringIO("red cat\nblue dog\nexit\n"),
                     out_stream=out)
    want = tconv.conv_templates["phi35"].copy()
    replies = []
    for user in ("red cat", "blue dog"):
        want.append_message(want.roles[0], user)
        want.append_message(want.roles[1], None)
        ids = adapter.tokenizer_ids_for_prompt(want.get_prompt(), False)
        toks = np.concatenate(list(stream_generate(
            port_model, np.asarray([ids], np.int32), None,
            max_new_tokens=5)), 1)[0]
        replies.append(tok.decode(toks.tolist()))
        want.messages[-1][1] = replies[-1]
    assert conv.messages == want.messages
    assert out.getvalue().count("ASSISTANT: ") == 2
    for r in replies:
        assert r in out.getvalue()


def test_chat_cli_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    """Without a GPU the CLI raises before loading anything unless
    --device cpu is given."""
    import torch

    from competesmoe_tpu_torch.serve import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--tokenizer", "unused"])
    with pytest.raises(SystemExit, match="--tokenizer is needed"):
        cli.main(["--device", "cpu"])
