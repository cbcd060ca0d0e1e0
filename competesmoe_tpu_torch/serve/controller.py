"""Serving controller: worker registry + dispatch + streaming proxy (a copy
of competesmoe_tpu/serve/controller.py).

The reference's `moe_model/serve/controller.py:28-298` on the standard
library: a ThreadingHTTPServer with the same HTTP protocol —

  POST /register_worker    {worker_name, check_heart_beat, worker_status}
  POST /receive_heart_beat {worker_name, queue_length}
  POST /refresh_all_workers
  POST /list_models
  POST /get_worker_address {model}
  POST /worker_generate_stream {model, ...}  (proxied, chunked, \\0-delim)

Dispatch methods: 'lottery' (speed-weighted random) and 'shortest_queue'
(queue length / speed), with heartbeat expiry.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib import request as urlrequest

import numpy as np

from ..constants import CONTROLLER_HEART_BEAT_EXPIRATION

DispatchMethod = ("lottery", "shortest_queue")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in DispatchMethod
        self.dispatch_method = dispatch_method
        self.worker_info: Dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()

    # -- registry (controller.py:77-131) --

    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        if worker_status is None:
            worker_status = self._get_worker_status(worker_name)
        if worker_status is None:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status.get("speed", 1.0),
                queue_length=worker_status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time())
        return True

    def _get_worker_status(self, worker_name: str) -> Optional[dict]:
        try:
            req = urlrequest.Request(worker_name + "/worker_get_status",
                                     data=b"{}", method="POST")
            with urlrequest.urlopen(req, timeout=5) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def refresh_all_workers(self) -> None:
        old = dict(self.worker_info)
        self.worker_info = {}
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                pass

    def receive_heart_beat(self, worker_name: str,
                           queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.worker_info:
                return False
            info = self.worker_info[worker_name]
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
            return True

    def remove_stale_workers(self) -> None:
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self._lock:
            stale = [n for n, i in self.worker_info.items()
                     if i.check_heart_beat and i.last_heart_beat < expire]
            for n in stale:
                del self.worker_info[n]

    def list_models(self) -> List[str]:
        names = set()
        for info in self.worker_info.values():
            names.update(info.model_names)
        return sorted(names)

    # -- dispatch (controller.py:133-192) --

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [(n, i) for n, i in self.worker_info.items()
                          if model_name in i.model_names]
        if not candidates:
            return ""
        if self.dispatch_method == "lottery":
            speeds = np.array([i.speed for _, i in candidates], np.float64)
            if speeds.sum() <= 0:
                return ""
            pt = np.random.choice(len(candidates), p=speeds / speeds.sum())
            return candidates[pt][0]
        # shortest_queue: queue length normalized by speed
        qs = np.array([i.queue_length / max(i.speed, 1e-6)
                       for _, i in candidates])
        idx = int(np.argmin(qs))
        name = candidates[idx][0]
        with self._lock:
            if name in self.worker_info:
                self.worker_info[name].queue_length += 1
        return name

    # -- streaming proxy (controller.py:193-230) --

    def worker_api_generate_stream(self, params: dict):
        addr = self.get_worker_address(params["model"])
        if not addr:
            yield json.dumps({"text": "No available worker",
                              "error_code": 2}).encode() + b"\0"
            return
        req = urlrequest.Request(
            addr + "/worker_generate_stream",
            data=json.dumps(params).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req, timeout=120) as r:
            buf = b""
            while True:
                chunk = r.read(4096)
                if not chunk:
                    break
                buf += chunk
                while b"\0" in buf:
                    part, buf = buf.split(b"\0", 1)
                    if part:
                        yield part + b"\0"


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
            path = self.path
            controller.remove_stale_workers()
            if path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"], data.get("check_heart_beat", True),
                    data.get("worker_status"))
                self._json(200 if ok else 400, {"success": ok})
            elif path == "/receive_heart_beat":
                exists = controller.receive_heart_beat(
                    data["worker_name"], data.get("queue_length", 0))
                self._json(200, {"exist": exists})
            elif path == "/refresh_all_workers":
                controller.refresh_all_workers()
                self._json(200, {})
            elif path == "/list_models":
                self._json(200, {"models": controller.list_models()})
            elif path == "/get_worker_address":
                self._json(200, {"address":
                                 controller.get_worker_address(
                                     data["model"])})
            elif path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.end_headers()
                for chunk in controller.worker_api_generate_stream(data):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            else:
                self._json(404, {"error": f"unknown path {path}"})

    return Handler


def serve_controller(host: str = "0.0.0.0", port: int = 21001,
                     dispatch_method: str = "shortest_queue",
                     background: bool = False):
    controller = Controller(dispatch_method)
    httpd = ThreadingHTTPServer((host, port), make_handler(controller))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return controller, httpd
    httpd.serve_forever()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21001)
    ap.add_argument("--dispatch-method", default="shortest_queue",
                    choices=list(DispatchMethod))
    a = ap.parse_args(argv)
    serve_controller(a.host, a.port, a.dispatch_method)


if __name__ == "__main__":
    main()
