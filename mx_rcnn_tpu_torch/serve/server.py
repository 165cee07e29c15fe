"""Stdlib JSON/HTTP front end of the serving engine.

Counterpart of ``mx_rcnn_tpu/serve/server.py``.  A
``ThreadingHTTPServer`` runs one handler thread per connection; those
threads are the concurrent submitters the engine's micro-batcher
gathers.  No TLS, no auth: a process-local or LAN front end.

Endpoints::

    POST /detect   {"image_b64": <base64 of an encoded PNG/JPEG>}
                 | {"pixels_b64": <base64 raw uint8 RGB>, "shape": [h,w,3]}
                   optional: "timeout_ms"
                   → 200 {"detections": [{"class_id", "class", "score",
                                          "box": [x1,y1,x2,y2]}, ...],
                          "latency_ms", "batch_rows"}
                   → 429 shed at admission, 504 deadline expired,
                     400 malformed request, 500 engine failure,
                     411 no Content-Length, 413 body over
                     serve.max_body_mb, 408 body read past its deadline
    GET  /healthz  → 200 liveness and warm buckets (503 once closed, or
                     while the health engine's verdict is CRITICAL)
    GET  /metrics  → 200 the engine's metrics snapshot, its registry, and
                     the time series while a store is active

An ``X-MXR-Trace`` header is parsed by ``obs/trace.py — parse_header``
(a malformed one is a 400) and carried as the request's ``tctx``: the
engine records the request's spans under it, the queue its one
``terminal.<state>`` span, and the handler the ``serve.request`` root,
then closes the trace into the kept ring (``obs/trace.py —
retain_trace`` decides).  While ``obs/health.py`` has an active engine,
``/healthz`` carries its verdict.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from mx_rcnn_tpu_torch.netio import (BodyError, check_timeout_ms,
                                     check_trace_header, read_request_body)
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.health import active_verdict
from mx_rcnn_tpu_torch.obs.profiler import poll_sigusr2
from mx_rcnn_tpu_torch.obs.timeseries import active as active_store
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded, RequestFailed,
                                           ShedError)

logger = logging.getLogger("mx_rcnn_tpu_torch")

TRACE_HEADER = obs_trace.TRACE_HEADER


def check_trace_context(value: Optional[str]
                        ) -> Optional[obs_trace.TraceContext]:
    """An ``X-MXR-Trace`` value → its :class:`TraceContext` (None for
    none).  A malformed one raises ValueError (a :class:`BodyError` for
    one over the length cap or not ascii): a 400, never a default."""
    if check_trace_header(value) is None:
        return None
    return obs_trace.parse_header(value)


def decode_image_payload(body: dict) -> np.ndarray:
    """Request JSON → RGB uint8 (h, w, 3).  Two encodings: base64 of an
    image file (decoded by cv2, else PIL) or base64 of raw pixels with
    their shape.  Anything malformed is a ValueError (a 400)."""
    if "pixels_b64" in body:
        shape = tuple(body.get("shape") or ())
        if (len(shape) != 3 or shape[2] != 3
                or not all(isinstance(d, int) and d >= 1 for d in shape)):
            raise ValueError("pixels_b64 needs shape [h, w, 3], h, w >= 1")
        raw = base64.b64decode(body["pixels_b64"])
        img = np.frombuffer(raw, np.uint8)
        if img.size != int(np.prod(shape)):
            raise ValueError(
                f"pixels_b64 carries {img.size} bytes, shape asks "
                f"{int(np.prod(shape))}")
        return img.reshape(shape)
    if "image_b64" in body:
        return _decode_file(base64.b64decode(body["image_b64"]))
    raise ValueError("request needs image_b64 or pixels_b64")


def _decode_file(raw: bytes) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("cv2 could not decode image_b64")
        return np.ascontiguousarray(img[:, :, ::-1])  # BGR → RGB
    try:
        from PIL import Image
    except ImportError:
        raise ValueError("this server cannot decode image_b64 (neither cv2 "
                         "nor PIL is installed): send pixels_b64 and shape")
    try:
        with Image.open(io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGB"))
    except OSError as e:
        raise ValueError(f"PIL could not decode image_b64: {e}")


def detections_to_json(dets, class_names: Optional[List[str]]) -> list:
    """{class_id: (k, 5)} → the wire list, scores descending."""
    out = []
    for c, arr in sorted(dets.items()):
        name = (class_names[c] if class_names and c < len(class_names)
                else f"cls{c}")
        for x1, y1, x2, y2, score in arr:
            out.append({"class_id": int(c), "class": name,
                        "score": round(float(score), 4),
                        "box": [round(float(v), 2)
                                for v in (x1, y1, x2, y2)]})
    out.sort(key=lambda d: -d["score"])
    return out


class DetectionHandler(BaseHTTPRequestHandler):
    # the server carries .engine, .class_names, .max_body_bytes and
    # .body_deadline_s (make_server)
    protocol_version = "HTTP/1.1"
    # socket read timeout: a stalled client holds a thread at most this
    timeout = 60.0

    def _reply(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True   # the peer left: no one to tell

    def log_message(self, fmt, *args):
        logger.debug("serve http: " + fmt, *args)

    def do_GET(self):
        engine: ServingEngine = self.server.engine
        if self.path == "/healthz":
            h = engine.healthz()
            verdict = active_verdict()
            if verdict is not None:
                # a CRITICAL verdict fails the probe
                h["health"] = verdict
                h["ok"] = h["ok"] and verdict["verdict"] != "CRITICAL"
            self._reply(200 if h["ok"] else 503, h)
        elif self.path == "/metrics":
            snap = engine.metrics.snapshot()
            snap["registry"] = engine.metrics.registry.snapshot()
            store = active_store()
            if store is not None:
                snap["timeseries"] = store.scrape_section()
            self._reply(200, snap)
        else:
            self._reply(404, {"error": f"no such path {self.path!r}"})

    def do_POST(self):
        if self.path != "/detect":
            self._reply(404, {"error": f"no such path {self.path!r}"})
            return
        engine: ServingEngine = self.server.engine
        try:
            body = json.loads(
                read_request_body(self, self.server.max_body_bytes,
                                  self.server.body_deadline_s)
                or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            img = decode_image_payload(body)
            # an inf/NaN timeout dies here as a 400, not in deadline
            # arithmetic
            timeout_ms = check_timeout_ms(body.get("timeout_ms"))
            tctx = check_trace_context(self.headers.get(TRACE_HEADER))
        except BodyError as e:
            self._reply(e.status, {"error": str(e)})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return
        t0 = time.monotonic()
        req = inbound = None
        if tctx is not None:
            # this hop's spans nest under its own root span
            inbound, tctx = tctx, tctx.child(obs_trace.new_span_id())
        try:
            # submit and wait (not engine.detect): the handle carries the
            # batch_rows the reply promises
            req = engine.submit(img, timeout_ms=timeout_ms, tctx=tctx)
            wait_s = None
            if req.deadline is not None:
                wait_s = max(req.deadline - time.monotonic(), 0.0) + 30.0
            dets = req.wait(timeout=wait_s)
        except ShedError:
            self._reply(429, {"error": "overloaded: request shed at "
                                       "admission, retry later"})
            return
        except DeadlineExceeded:
            self._reply(504, {"error": "deadline expired before serve"})
            return
        except (RequestFailed, TimeoutError) as e:
            self._reply(500, {"error": str(e)})
            return
        except ValueError as e:
            # the image cannot be preprocessed: the client's input
            self._reply(400, {"error": str(e)})
            return
        finally:
            if tctx is not None:
                _close_request_trace(tctx, inbound, req, t0)
        self._reply(200, {
            "detections": detections_to_json(dets,
                                             self.server.class_names),
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            "batch_rows": req.batch_rows,
        })


def _close_request_trace(tctx: obs_trace.TraceContext,
                         inbound: obs_trace.TraceContext, req, t0: float
                         ) -> None:
    """This hop's root span, ``serve.request`` (the handler's submit to
    the request's end, under the caller's span), then the trace closed
    into the kept ring."""
    state = req.state if req is not None else "rejected"
    total_ms = (time.monotonic() - t0) * 1e3
    obs_trace.record_span(tctx, "serve.request", total_ms,
                          span_id=tctx.parent, parent=inbound.parent,
                          state=state)
    obs_trace.close_trace(tctx, keep=obs_trace.retain_trace(
        state.upper(), total_ms=total_ms), state=state)


def _sync_devices() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class DetectionServer(ThreadingHTTPServer):
    """The front end; its poll loop (``serve_forever``'s thread) is
    where a SIGUSR2 profiler window opens and closes
    (``obs/profiler.py — poll_sigusr2``)."""

    def service_actions(self):
        poll_sigusr2(_sync_devices)


def make_server(engine: ServingEngine, host: str = "127.0.0.1",
                port: int = 8080, class_names: List[str] = None,
                max_body_mb: float = 64.0) -> ThreadingHTTPServer:
    """Build (not start) the server; ``port=0`` picks a free port (read
    it from ``server.server_address``).  A claimed body over
    ``max_body_mb`` is refused 413 before a byte of it is read."""
    srv = DetectionServer((host, port), DetectionHandler)
    srv.engine = engine
    srv.class_names = list(class_names) if class_names else None
    srv.max_body_bytes = int(max_body_mb * (1 << 20))
    srv.body_deadline_s = 30.0
    return srv
