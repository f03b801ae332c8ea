"""HTTP/JSON front door of the serving plane (rank 0).

Own copy of ``horovod_tpu/serving/server.py``: a stdlib
``ThreadingHTTPServer`` on a daemon thread, one handler thread per
in-flight request (the generate call long-polls the request's completion
event, so slow generations occupy a thread, not the engine).

Routes:

* ``POST /v1/generate`` — body ``{"tenant": str, "prompt_ids": [int],
  "max_new_tokens": int, "priority": int?}``; 200 with the generated
  tokens on completion.  Admission shedding is typed: 429 with
  ``{"error": {"type": "rejected", "reason": "queue_full" |
  "tenant_quota", ...}}`` (and a Retry-After header), 400 for
  ``too_long`` and malformed bodies, 503 when the plane is down, 504 when
  the request outlives the long-poll bound.
* ``GET /v1/stats`` — the ``serving``, ``cache`` and ``membership``
  sections of ``metrics_snapshot()``.
* ``GET /v1/trace?id=`` — one request's ordered spans, live or retired.
* ``GET /healthz`` — liveness, the job's size and its membership epoch
  (it shrinks around dead ranks under ``--min-np``).
* ``POST /shutdown`` — orderly drain: the engine broadcasts OP_STOP at
  the next tick and every rank leaves the serve loop.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from horovod_tpu_torch import common as _common
from horovod_tpu_torch.serving.scheduler import (AdmissionError,
                                                 REJECT_TOO_LONG, Scheduler,
                                                 ServeConfig,
                                                 ServingUnavailableError)

_server_lock = threading.Lock()
_server = None  # (ThreadingHTTPServer, bound_port)


def start_server(scheduler: Scheduler, cfg: ServeConfig,
                 engine=None, host: str = "") -> int:
    """Serve the front door from a daemon thread; returns the bound port
    (``cfg.port`` 0 picks a free one).  Idempotent."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    global _server
    with _server_lock:
        if _server is not None:
            return _server[1]

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: dict,
                       headers: Optional[dict] = None):
                payload = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    self._reply(200, {
                        "ok": scheduler.failed is None,
                        "size": (_common.size()
                                 if _common.is_initialized() else 0),
                        "membership_epoch": _common.membership_epoch(),
                    })
                elif path == "/v1/stats":
                    snap = _common.metrics_snapshot()
                    self._reply(200, {k: snap[k] for k in
                                      ("serving", "cache", "membership")})
                elif path == "/v1/trace":
                    from urllib.parse import parse_qs, urlparse

                    query = parse_qs(urlparse(self.path).query)
                    try:
                        request_id = int(query.get("id", [""])[0])
                    except ValueError:
                        self._reply(400, {"error": {
                            "type": "bad_request",
                            "detail": "trace needs a numeric ?id="}})
                        return
                    trace = scheduler.trace(request_id)
                    if trace is None:
                        self._reply(404, {"error": {
                            "type": "not_found", "id": request_id,
                            "detail": "unknown request id (never admitted,"
                                      " or evicted from the bounded trace"
                                      " store)"}})
                        return
                    self._reply(200, trace)
                else:
                    self.send_error(404)

            def do_POST(self):
                path = self.path.split("?")[0]
                if path == "/shutdown":
                    if engine is not None:
                        engine.request_stop()
                    self._reply(200, {"stopping": True})
                    return
                if path != "/v1/generate":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(length) or b"{}")
                    tenant = str(body["tenant"])
                    prompt = [int(t) for t in body["prompt_ids"]]
                    max_new = int(body["max_new_tokens"])
                    priority = int(body.get("priority", 0))
                except (KeyError, TypeError, ValueError) as exc:
                    self._reply(400, {"error": {
                        "type": "bad_request",
                        "detail": f"malformed generate body: {exc}"}})
                    return
                try:
                    req = scheduler.submit(tenant, prompt, max_new,
                                           priority)
                except AdmissionError as exc:
                    code = 400 if exc.reason == REJECT_TOO_LONG else 429
                    self._reply(code, {"error": {
                        "type": "rejected", "reason": exc.reason,
                        "tenant": exc.tenant, "detail": str(exc)}},
                        headers=({"Retry-After": "1"} if code == 429
                                 else None))
                    return
                except ServingUnavailableError as exc:
                    self._reply(503, {"error": {
                        "type": "unavailable", "detail": str(exc)}})
                    return
                if not req.event.wait(cfg.request_timeout_sec):
                    self._reply(504, {"error": {
                        "type": "timeout", "id": req.id,
                        "detail": "generation did not finish within "
                                  f"{cfg.request_timeout_sec:g}s"}})
                    return
                if req.error is not None:
                    self._reply(503, {"error": {
                        "type": "unavailable", "id": req.id,
                        "detail": str(req.error)}})
                    return
                self._reply(200, req.to_result())

            def log_message(self, *args):  # keep request noise off stderr
                pass

        server = ThreadingHTTPServer((host, cfg.port), Handler)
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name="hvd-tpu-serve", daemon=True)
        thread.start()
        _server = (server, server.server_address[1])
        return _server[1]


def stop_server() -> None:
    global _server
    with _server_lock:
        if _server is None:
            return
        server, _ = _server
        _server = None
    server.shutdown()
    server.server_close()


def server_port() -> Optional[int]:
    with _server_lock:
        return _server[1] if _server else None
