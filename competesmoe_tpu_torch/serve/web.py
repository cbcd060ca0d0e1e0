"""Browser chat UI (port of competesmoe_tpu/serve/web.py).

The reference's `moe_model/serve/gradio_web_server.py` on the standard
library: a single-page chat app (image upload as base64, model selector,
regenerate and clear controls) served next to JSON endpoints that proxy to
the controller, plus the reference's vote logging (upvote, downvote and
flag with the whole conversation appended to a daily JSONL conversation
log, gradio_web_server.py `vote_last_response` /
`get_conv_log_filename`).
"""

from __future__ import annotations

import datetime
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib import request as urlrequest

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>CompeteSMoE chat</title>
<style>
 body { font-family: sans-serif; max-width: 760px; margin: 2em auto; }
 #log { border: 1px solid #ccc; padding: 1em; min-height: 300px;
        white-space: pre-wrap; }
 .u { color: #036; } .a { color: #063; }
 textarea { width: 100%; } button { margin-top: .5em; }
 #votes button { font-size: 1.1em; }
</style></head><body>
<h2>CompeteSMoE chat</h2>
<p>Model: <select id="model"></select>
 temperature <input id="temp" type="number" min="0" max="2" step="0.1"
  value="0.2" style="width:4em">
 top_p <input id="topp" type="number" min="0" max="1" step="0.05"
  value="0.7" style="width:4em">
 max tokens <input id="maxtok" type="number" min="1" max="1024"
  value="512" style="width:5em"></p>
<div id="log"></div>
<p><input type="file" id="img" accept="image/*"></p>
<textarea id="msg" rows="3" placeholder="message"></textarea>
<div>
 <button onclick="send()">Send</button>
 <button onclick="regenerate()">&#x1F501; Regenerate</button>
 <button onclick="clearConv()">&#x1F5D1; Clear history</button>
 <span id="votes">
  <button onclick="vote('upvote')">&#x1F44D;</button>
  <button onclick="vote('downvote')">&#x1F44E;</button>
  <button onclick="vote('flag')">&#x2691;</button>
 </span>
 <span id="status"></span>
</div>
<script>
let hist = [];
async function loadModels() {
  const r = await fetch('/models');
  const d = await r.json();
  const sel = document.getElementById('model');
  sel.innerHTML = '';
  for (const m of d.models) {
    const o = document.createElement('option');
    o.value = m; o.textContent = m; sel.appendChild(o);
  }
}
loadModels();
function render() {
  const log = document.getElementById('log');
  log.innerHTML = '';
  for (const [role, text] of hist) {
    const cls = role === 'USER' ? 'u' : 'a';
    log.innerHTML += '<div class="' + cls + '">' + role + ': '
      + text + '</div>';
  }
}
async function imagesB64() {
  const f = document.getElementById('img').files[0];
  if (!f) return [];
  const buf = await f.arrayBuffer();
  return [btoa(String.fromCharCode(...new Uint8Array(buf)))];
}
async function complete() {
  const images = await imagesB64();
  const resp = await fetch('/chat_stream', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({messages: hist, images: images,
      model: document.getElementById('model').value,
      temperature: parseFloat(document.getElementById('temp').value),
      top_p: parseFloat(document.getElementById('topp').value),
      max_new_tokens: parseInt(document.getElementById('maxtok').value)})});
  // newline-delimited JSON lines {text: cumulative}; render as they land
  hist.push(['ASSISTANT', '']);
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    const lines = buf.split('\\n');
    buf = lines.pop();
    for (const line of lines) {
      if (!line.trim()) continue;
      const obj = JSON.parse(line);
      if (obj.error) {
        hist[hist.length - 1][1] = '[error] ' + obj.error;
      } else {
        hist[hist.length - 1][1] = obj.text;
      }
      render();
    }
  }
}
async function send() {
  const msg = document.getElementById('msg').value.trim();
  if (!msg) return;
  document.getElementById('msg').value = '';
  hist.push(['USER', msg]);
  render();
  await complete();
}
async function regenerate() {
  if (hist.length && hist[hist.length - 1][0] === 'ASSISTANT')
    hist.pop();
  render();
  await complete();
}
function clearConv() { hist = []; render(); }
async function vote(kind) {
  await fetch('/vote', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({type: kind, messages: hist,
                          model: document.getElementById('model').value})});
  document.getElementById('status').textContent = 'voted: ' + kind;
}
</script></body></html>
"""


def make_handler(controller_addr: str, model_name: str,
                 conv_template: str = "phi35",
                 log_dir: str = "serve_logs"):
    from ..multimodal.conversation import conv_templates

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/models":
                models = [model_name]
                try:
                    urlrequest.urlopen(urlrequest.Request(
                        controller_addr + "/refresh_all_workers",
                        data=b"{}", method="POST"), timeout=10)
                    with urlrequest.urlopen(urlrequest.Request(
                            controller_addr + "/list_models",
                            data=b"{}", method="POST"), timeout=10) as r:
                        models = json.loads(r.read()).get("models",
                                                          models)
                except Exception:
                    pass
                return self._json({"models": models})
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _conv_log_file(self) -> Path:
            """Daily conv log (gradio_web_server.get_conv_log_filename)."""
            d = Path(log_dir)
            d.mkdir(parents=True, exist_ok=True)
            day = datetime.datetime.now().strftime("%Y-%m-%d")
            return d / f"{day}-conv.json"

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/vote":
                # vote_last_response: {tstamp, type, model, state, ip}
                rec = {"tstamp": round(time.time(), 4),
                       "type": data.get("type", "upvote"),
                       "model": data.get("model", model_name),
                       "state": {"messages": data.get("messages", [])},
                       "ip": self.client_address[0]}
                with open(self._conv_log_file(), "a") as f:
                    f.write(json.dumps(rec) + "\n")
                return self._json({"ok": True})
            if self.path not in ("/chat", "/chat_stream"):
                self.send_response(404)
                self.end_headers()
                return
            conv = conv_templates[conv_template].copy()
            msgs = data.get("messages", [])
            images = data.get("images") or []
            for i, (role, text) in enumerate(msgs):
                if i == 0 and images and "<image>" not in text:
                    text = "<image>\n" + text
                conv.append_message(
                    conv.roles[0] if role == "USER" else conv.roles[1],
                    text)
            conv.append_message(conv.roles[1], None)
            wpayload = {
                "model": data.get("model", model_name),
                "prompt": conv.get_prompt(),
                "images": images,
                # the reference gradio UI's sampling sliders
                # (gradio_web_server.py http_bot payload)
                "temperature": float(data.get("temperature", 0.2)),
                "top_p": float(data.get("top_p", 0.7)),
                "max_new_tokens": int(data.get("max_new_tokens", 512)),
                "stop": conv.sep2 or conv.sep}
            from .stream_client import iter_worker_stream

            stream_url = controller_addr + "/worker_generate_stream"
            text = ""
            if self.path == "/chat_stream":
                # live tokens to the browser (the reference gradio UI
                # streams via yield; here: ndjson lines of cumulative
                # text, connection close delimits the stream)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                try:
                    for msg in iter_worker_stream(stream_url, wpayload,
                                                  timeout=300):
                        text = msg.get("text", text)
                        self.wfile.write(
                            (json.dumps({"text": text}) + "\n").encode())
                        self.wfile.flush()
                except Exception as e:  # noqa: BLE001 — surface it:
                    # headers are out, so the error rides the stream
                    self.wfile.write(
                        (json.dumps({"error": str(e)}) + "\n").encode())
                    return
            else:
                for msg in iter_worker_stream(stream_url, wpayload,
                                              timeout=300):
                    text = msg.get("text", text)
            # conversation state log (the reference appends every round)
            with open(self._conv_log_file(), "a") as f:
                f.write(json.dumps({
                    "tstamp": round(time.time(), 4), "type": "chat",
                    "model": data.get("model", model_name),
                    "state": {"messages": msgs + [["ASSISTANT", text]]},
                    "ip": self.client_address[0]}) + "\n")
            if self.path == "/chat":
                self._json({"text": text})

    return Handler


def serve_web(controller_addr: str, model_name: str,
              host: str = "0.0.0.0", port: int = 7860,
              background: bool = False, log_dir: str = "serve_logs"):
    httpd = ThreadingHTTPServer(
        (host, port), make_handler(controller_addr, model_name,
                                   log_dir=log_dir))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    httpd.serve_forever()
