"""OpenAI-compatible REST front end for the serving stack (port of
competesmoe_tpu/serve/openai_api.py).

The reference exposes only its own controller/worker protocol; clients,
eval harnesses and gateways speak the OpenAI API. This module bridges the
two on the standard library: `/v1/models`, `/v1/chat/completions` and the
legacy `/v1/completions` (raw prompt), streamed or not. Chat messages are
rendered through the same conversation templates training used
(multimodal/conversation.py: prompt fidelity is what makes served outputs
match eval outputs) and dispatched through the controller, so the API
composes with every worker feature: continuous batching, the prefix
cache, chunked prefill, speculative decoding, quantized runtimes.

Content parts follow the OpenAI vision convention: a message `content`
may be a string or a list of `{"type": "text"}` / `{"type":
"image_url"}` parts; data-URL base64 images are forwarded to the worker
as its `images` field, and each image part gains an `<image>` token in
its own message.

Streaming responses are standard SSE `chat.completion.chunk` deltas
terminated by `data: [DONE]`.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib import request as urlrequest


def _render_prompt(conv_template: str, messages: list
                   ) -> Tuple[str, List[str], Optional[str]]:
    """OpenAI messages -> (prompt, base64 images, stop string)."""
    from ..multimodal.conversation import conv_templates

    conv = conv_templates[conv_template].copy()
    images: List[str] = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        n_imgs_here = 0
        if isinstance(content, list):
            texts = []
            for part in content:
                if part.get("type") == "text":
                    texts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    if "," in url and url.startswith("data:"):
                        images.append(url.split(",", 1)[1])
                    elif url:
                        images.append(url)  # raw base64
                    n_imgs_here += 1
            content = "\n".join(texts)
        if role == "system":
            conv.system = content
            continue
        # one <image> token per image part IN THIS message (the splice
        # consumes them in order; images sent in any turn must land in
        # that turn's text, not only the first)
        missing = n_imgs_here - content.count("<image>")
        if missing > 0:
            content = "<image>\n" * missing + content
        conv.append_message(
            conv.roles[0] if role == "user" else conv.roles[1], content)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt(), images, conv.sep2 or conv.sep


def _worker_stream(controller_addr: str, payload: dict, timeout: int):
    """Yield cumulative-text dicts from the controller's stream proxy
    (null-delimited JSON — see serve/stream_client.py)."""
    from .stream_client import iter_worker_stream

    yield from iter_worker_stream(
        controller_addr + "/worker_generate_stream", payload, timeout)


def make_handler(controller_addr: str, conv_template: str = "phi35",
                 default_model: Optional[str] = None,
                 request_timeout: int = 600):

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _models(self) -> List[str]:
            try:
                urlrequest.urlopen(urlrequest.Request(
                    controller_addr + "/refresh_all_workers",
                    data=b"{}", method="POST"), timeout=10)
                with urlrequest.urlopen(urlrequest.Request(
                        controller_addr + "/list_models", data=b"{}",
                        method="POST"), timeout=10) as r:
                    return json.loads(r.read()).get("models", [])
            except Exception:
                return [default_model] if default_model else []

        def do_GET(self):
            if self.path.rstrip("/") == "/v1/models":
                now = int(time.time())
                return self._json({
                    "object": "list",
                    "data": [{"id": m, "object": "model", "created": now,
                              "owned_by": "competesmoe_tpu_torch"}
                             for m in self._models()]})
            self._json({"error": {"message": f"no route {self.path}",
                                  "type": "invalid_request_error"}}, 404)

        def do_POST(self):
            route = self.path.rstrip("/")
            if route not in ("/v1/chat/completions", "/v1/completions"):
                return self._json(
                    {"error": {"message": f"no route {self.path}",
                               "type": "invalid_request_error"}}, 404)
            # legacy /v1/completions: raw prompt string, no template
            legacy = route == "/v1/completions"
            n = int(self.headers.get("Content-Length", 0))
            try:
                data = json.loads(self.rfile.read(n) or b"{}")
                if legacy:
                    prompt = data.get("prompt", "")
                    if isinstance(prompt, list):
                        prompt = prompt[0] if prompt else ""
                    images, conv_stop = [], None
                else:
                    prompt, images, conv_stop = _render_prompt(
                        conv_template, data.get("messages", []))
            except Exception as e:  # noqa: BLE001 — client error surface
                return self._json(
                    {"error": {"message": str(e),
                               "type": "invalid_request_error"}}, 400)
            model = data.get("model") or default_model
            if not model:
                models = self._models()
                model = models[0] if models else None
            if not model:
                return self._json(
                    {"error": {"message": "no model available",
                               "type": "invalid_request_error"}}, 400)
            stop = data.get("stop")
            stops = ([stop] if isinstance(stop, str) else list(stop or []))
            if conv_stop:
                stops.append(conv_stop)
            payload = {
                "model": model,
                "prompt": prompt,
                "images": images,
                "temperature": float(data.get("temperature", 1.0)),
                "top_p": float(data.get("top_p", 1.0)),
                "max_new_tokens": int(data.get("max_tokens")
                                      or data.get("max_completion_tokens")
                                      or 512),
                # str-or-list; the worker cuts at the earliest hit
                "stop": stops,
            }
            if "speculative" in data:
                # extension: per-request spec K (solo worker path; an
                # engine-mode worker uses its engine-wide spec_k)
                payload["speculative"] = int(data["speculative"])
            rid = ("cmpl-" if legacy else "chatcmpl-") \
                + uuid.uuid4().hex[:24]
            created = int(time.time())
            if data.get("stream"):
                try:
                    return self._stream(rid, created, model, payload,
                                        stops, legacy)
                except Exception:  # noqa: BLE001 — client went away;
                    return          # headers already sent, nothing to do
            try:
                text = ""
                n_chunks = 0
                for msg in _worker_stream(controller_addr, payload,
                                          request_timeout):
                    if msg.get("error_code", 0):
                        # worker/controller-level failure ("No available
                        # worker", overload, model exception): surface
                        # as an API error, never as assistant content
                        return self._json(
                            {"error": {"message": msg.get("text", ""),
                                       "type": "server_error",
                                       "code": msg["error_code"]}}, 502)
                    text = msg.get("text", text)
                    n_chunks += 1
                choice = ({"index": 0, "text": text,
                           "finish_reason": "stop"} if legacy else
                          {"index": 0,
                           "message": {"role": "assistant",
                                       "content": text},
                           "finish_reason": "stop"})
                return self._json({
                    "id": rid,
                    "object": ("text_completion" if legacy
                               else "chat.completion"),
                    "created": created, "model": model,
                    "choices": [choice],
                    # token accounting is not exposed by the worker
                    # protocol; chunk count approximates decode steps
                    "usage": {"prompt_tokens": 0,
                              "completion_tokens": n_chunks,
                              "total_tokens": n_chunks}})
            except Exception as e:  # noqa: BLE001 — upstream failure
                return self._json(
                    {"error": {"message": f"upstream: {e}",
                               "type": "server_error"}}, 502)

        def _stream(self, rid, created, model, payload, stops,
                    legacy=False):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def chunk(delta, finish=None):
                if legacy:
                    choice = {"index": 0,
                              "text": delta.get("content", ""),
                              "finish_reason": finish}
                    obj = "text_completion"
                else:
                    choice = {"index": 0, "delta": delta,
                              "finish_reason": finish}
                    obj = "chat.completion.chunk"
                return ("data: " + json.dumps({
                    "id": rid, "object": obj,
                    "created": created, "model": model,
                    "choices": [choice]}) + "\n\n").encode()

            def sse_error(message):
                # errors after the SSE headers cannot become an HTTP
                # status line; OpenAI streams them as an error event
                self.wfile.write(("data: " + json.dumps(
                    {"error": {"message": message,
                               "type": "server_error"}})
                    + "\n\n").encode())
                self.wfile.write(b"data: [DONE]\n\n")

            if not legacy:
                self.wfile.write(
                    chunk({"role": "assistant", "content": ""}))
            # hold back max(len(stop))-1 chars so a stop string
            # straddling a chunk boundary is never partially streamed —
            # the worker only cuts it on its final chunk
            hold = max((len(s) for s in stops), default=0)
            hold = max(hold - 1, 0)
            sent, final = "", ""
            try:
                for msg in _worker_stream(controller_addr, payload,
                                          request_timeout):
                    if msg.get("error_code", 0):
                        return sse_error(msg.get("text", ""))
                    final = msg.get("text", final)
                    safe = final[: max(0, len(final) - hold)]
                    if len(safe) > len(sent) and safe.startswith(sent):
                        self.wfile.write(
                            chunk({"content": safe[len(sent):]}))
                        self.wfile.flush()
                        sent = safe
            except Exception as e:  # noqa: BLE001 — upstream failure
                return sse_error(f"upstream: {e}")
            if len(final) > len(sent) and final.startswith(sent):
                self.wfile.write(chunk({"content": final[len(sent):]}))
            self.wfile.write(chunk({}, finish="stop"))
            self.wfile.write(b"data: [DONE]\n\n")

    return Handler


def serve_openai_api(controller_addr: str, host: str = "0.0.0.0",
                     port: int = 8000, conv_template: str = "phi35",
                     default_model: Optional[str] = None,
                     background: bool = False,
                     request_timeout: int = 600):
    httpd = ThreadingHTTPServer(
        (host, port),
        make_handler(controller_addr, conv_template, default_model,
                     request_timeout))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    httpd.serve_forever()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="OpenAI-compatible API over the controller")
    ap.add_argument("--controller-address",
                    default="http://localhost:21001")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--conv-template", default="phi35")
    ap.add_argument("--model", default=None,
                    help="default model when requests omit one")
    ap.add_argument("--request-timeout", type=int, default=600,
                    help="seconds to wait on the upstream worker stream")
    a = ap.parse_args(argv)
    print(f"openai api on {a.host}:{a.port} -> {a.controller_address}",
          flush=True)
    serve_openai_api(a.controller_address, a.host, a.port,
                     a.conv_template, a.model,
                     request_timeout=a.request_timeout)


if __name__ == "__main__":
    main()
