"""Process-wide metrics registry: counters, gauges, log-bucket
histograms, and the stdlib JSON ``/metrics`` exporter.

Counterpart of ``mx_rcnn_tpu/obs/metrics.py`` (``Histogram``,
``Registry``, ``registry()``, ``ServeMetrics``, ``start_metrics_server``)
with the same bucket edges (40 log-spaced buckets from 0.1 ms to 30 s,
then an open one), the same upper-edge percentile readout and the same
snapshot keys, so the two packages' ``/metrics`` bodies and
load-generator records read alike.  Recording is a dict lookup and a few
float operations under one lock; a snapshot needs no per-sample history.

Names are ``<subsystem>.<metric>[_<unit>]``: ``train.step_ms``,
``loader.decode_ms``, ``snapshot.stall_ms``, ``serve.queue_wait_ms``.
The fit loop, the loaders, the stager and the snapshotter record into
the process registry when ``cfg.obs.enabled``; ``tools/serve.py`` points
the engine's ``ServeMetrics`` at it, so one scrape shows them all.

Not ported: ``LoweringCounter``, which counts XLA lowerings; the port
compiles no program (its kernels' builds and loads are counted by
``kernels.py — load_events``).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger("mx_rcnn_tpu_torch")


class Histogram:
    """Fixed log-spaced-bucket histogram with percentile readout.

    ``percentile`` returns the upper edge of the bucket holding the
    rank, an estimate that never understates.  Not locked itself: the
    :class:`Registry` that owns it records and reads it under its lock.
    """

    def __init__(self, lo: float = 0.1, hi: float = 30_000.0,
                 buckets: int = 40):
        # bounds[i] is the inclusive upper edge of bucket i; the last
        # bucket is open-ended, so no sample is dropped
        self.bounds = np.geomspace(lo, hi, buckets)
        self.counts = np.zeros(buckets + 1, np.int64)
        self.total = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, value: float) -> None:
        i = int(np.searchsorted(self.bounds, value))
        self.counts[i] += 1  # threadlint: disable=TL201 guarded by Registry.lock at every call site (observe/observe_batch)
        self.total += 1      # threadlint: disable=TL201 guarded by Registry.lock at every call site (observe/observe_batch)
        self.sum += value    # threadlint: disable=TL201 guarded by Registry.lock at every call site (observe/observe_batch)
        self.max = max(self.max, value)  # threadlint: disable=TL201 guarded by Registry.lock at every call site (observe/observe_batch)

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100]; None when empty.  The overflow bucket reports
        the largest value seen."""
        if self.total == 0:
            return None
        rank = int(np.ceil(p / 100.0 * self.total))
        rank = min(max(rank, 1), self.total)
        i = int(np.searchsorted(np.cumsum(self.counts), rank))
        if i >= len(self.bounds):
            return float(self.max)
        return float(self.bounds[i])

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.total if self.total else None

    def summary(self) -> Dict:
        """count, mean, p50, p90, p99 and max, rounded to 3 places."""
        pct = {p: self.percentile(p) for p in (50, 90, 99)}
        return {
            "count": self.total,
            "mean": None if self.mean is None else round(self.mean, 3),
            **{f"p{p}": None if v is None else round(v, 3)
               for p, v in pct.items()},
            "max": round(self.max, 3) if self.total else None,
        }


class Registry:
    """Thread-safe named counters, gauges and histograms, created on
    first record; :meth:`snapshot` reads all of them under one lock."""

    def __init__(self):
        self.lock = threading.RLock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self.lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self.lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float, lo: float = 0.1,
                hi: float = 30_000.0, buckets: int = 40) -> None:
        """Record ``value`` into the named histogram (made on first use
        with the given bucket geometry)."""
        with self.lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(lo, hi, buckets)
            h.record(value)

    def counter(self, name: str) -> int:
        with self.lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str) -> Optional[float]:
        with self.lock:
            return self._gauges.get(name)

    def hist(self, name: str) -> Optional[Histogram]:
        with self.lock:
            return self._hists.get(name)

    def names(self) -> Tuple[str, ...]:
        with self.lock:
            return tuple(sorted(set(self._counters) | set(self._gauges)
                                | set(self._hists)))

    def snapshot(self) -> Dict:
        """Every metric in one consistent dict: the ``/metrics`` body."""
        with self.lock:
            return {
                "counters": dict(sorted(self._counters.items())),
                "gauges": {k: round(v, 6) for k, v in
                           sorted(self._gauges.items())},
                "hists": {name: h.summary()
                          for name, h in sorted(self._hists.items())},
            }

    def reset(self, prefix: str = "") -> None:
        """Remove the metrics whose name starts with ``prefix``; they
        come back at zero on their next record.  Call it between phases:
        it is not atomic against concurrent recorders."""
        with self.lock:
            for d in (self._counters, self._gauges, self._hists):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]


# the process-wide registry: train, loader, snapshot and (when the CLIs
# wire it) serve all record here, so one scrape sees them all
_GLOBAL = Registry()


def registry() -> Registry:
    """The process-wide registry."""
    return _GLOBAL


_COUNTERS = ("submitted", "served", "shed", "expired", "failed",
             "batches", "padded_rows")
_HISTS = ("queue_wait_ms", "model_ms", "total_ms")
# the port's own: resize and pad of one request on the caller's thread.
# It stays out of snapshot(), whose keys are the JAX package's.
_PORT_HISTS = ("preprocess_ms",)


class ServeMetrics:
    """The serving engine's counters and latency histograms, names
    prefixed ``serve.`` in a :class:`Registry` (a private one unless one
    is given).

    Every request increments ``submitted`` and then exactly one of
    ``served``, ``shed``, ``expired`` or ``failed``; ``batches`` counts
    dispatches and ``padded_rows`` the dead rows that keep the batch
    shape static.  Histograms, in ms: ``queue_wait_ms`` (admission to
    dispatch), ``model_ms`` (forward and postprocess of a batch),
    ``total_ms`` (admission to response) and the port's
    ``preprocess_ms`` (resize and pad, read with :meth:`summary`).
    ``registry=registry()`` publishes them in the process scrape
    (``tools/serve.py`` does when ``cfg.obs.enabled``).
    """

    PREFIX = "serve."

    def __init__(self, registry: Registry = None):
        self.registry = registry if registry is not None else Registry()
        self.reset()

    def reset(self) -> None:
        """Zero everything.  Call it between traffic phases only."""
        p = self.PREFIX
        with self.registry.lock:
            for k in _COUNTERS + ("rows",):
                self.registry._counters[p + k] = 0
            for h in _HISTS:
                self.registry._hists[p + h] = Histogram()
            # the port's own come back on first record, so that a
            # snapshot holds only what the JAX package's holds until then
            for h in _PORT_HISTS:
                self.registry._hists.pop(p + h, None)

    # every accessor tolerates a missing key: Registry.reset removes
    # entries, and a shared registry may be reset under live traffic

    @property
    def counters(self) -> Dict[str, int]:
        with self.registry.lock:
            return {k: self.registry._counters.get(self.PREFIX + k, 0)
                    for k in _COUNTERS}

    @property
    def hists(self) -> Dict[str, Histogram]:
        with self.registry.lock:
            return {h: self.registry._hists.setdefault(self.PREFIX + h,
                                                       Histogram())
                    for h in _HISTS}

    def count(self, name: str, n: int = 1) -> None:
        self.registry.inc(self.PREFIX + name, n)

    def observe(self, name: str, value_ms: float) -> None:
        self.registry.observe(self.PREFIX + name, value_ms)

    def summary(self, name: str) -> Dict:
        """One histogram's :meth:`Histogram.summary`."""
        with self.registry.lock:
            return self.registry._hists.setdefault(
                self.PREFIX + name, Histogram()).summary()

    def observe_batch(self, rows: int, batch_size: int,
                      model_ms: float) -> None:
        p = self.PREFIX
        with self.registry.lock:
            c = self.registry._counters
            c[p + "batches"] = c.get(p + "batches", 0) + 1
            c[p + "padded_rows"] = (c.get(p + "padded_rows", 0)
                                    + batch_size - rows)
            c[p + "rows"] = c.get(p + "rows", 0) + rows
            self.registry._hists.setdefault(p + "model_ms",
                                            Histogram()).record(model_ms)

    def in_flight(self) -> int:
        """Admitted requests not yet terminal."""
        p = self.PREFIX
        with self.registry.lock:
            c = self.registry._counters
            return c.get(p + "submitted", 0) - (
                c.get(p + "served", 0) + c.get(p + "shed", 0)
                + c.get(p + "expired", 0) + c.get(p + "failed", 0))

    def snapshot(self) -> Dict:
        """Counters, percentiles and occupancy in one consistent dict:
        the ``/metrics`` body and the load generator's source."""
        p = self.PREFIX
        with self.registry.lock:
            cnt = {k: self.registry._counters.get(p + k, 0)
                   for k in _COUNTERS}
            out: Dict = {"counters": cnt}
            for name in _HISTS:
                out[name] = self.registry._hists.setdefault(
                    p + name, Histogram()).summary()
            b = cnt["batches"]
            rows = self.registry._counters.get(p + "rows", 0)
            out["batch_occupancy"] = {
                "batches": b,
                "mean_rows": round(rows / b, 3) if b else None,
                "padded_rows": cnt["padded_rows"],
            }
            out["terminated"] = (cnt["served"] + cnt["shed"]
                                 + cnt["expired"] + cnt["failed"])
            out["in_flight"] = cnt["submitted"] - out["terminated"]
            return out


# ---------------------------------------------------------------------------
# stdlib /metrics exporter
# ---------------------------------------------------------------------------

class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _reply(self, status: int, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        logger.debug("obs metrics http: " + fmt, *args)

    def do_GET(self):
        if self.path == "/metrics":
            snap = self.server.registry.snapshot()
            # with the time-series plane on, one scrape also answers
            # "what moved lately"
            from mx_rcnn_tpu_torch.obs.timeseries import active

            store = active()
            if store is not None:
                snap["timeseries"] = store.scrape_section()
            self._reply(200, snap)
        elif self.path == "/healthz":
            from mx_rcnn_tpu_torch.obs.health import active_verdict

            payload = {"ok": True}
            verdict = active_verdict()
            if verdict is not None:
                payload["ok"] = verdict["verdict"] != "CRITICAL"
                payload["health"] = verdict
            # a CRITICAL verdict fails the probe, as on the serving front
            # end: load balancers read the status code
            self._reply(200 if payload["ok"] else 503, payload)
        else:
            self._reply(404, {"error": f"no such path {self.path!r}"})


def start_metrics_server(reg: Registry = None, host: str = "127.0.0.1",
                         port: int = 0) -> ThreadingHTTPServer:
    """A daemon thread serving JSON ``GET /metrics`` (and ``/healthz``)
    over ``reg`` (default: the process registry).  ``port=0`` picks a
    free port (read it from ``server.server_address``); ``shutdown()``
    and ``server_close()`` stop it."""
    srv = ThreadingHTTPServer((host, port), _MetricsHandler)
    srv.registry = reg if reg is not None else registry()
    t = threading.Thread(target=srv.serve_forever,
                         name="obs-metrics-http", daemon=True)
    t.start()
    logger.info("obs: /metrics on http://%s:%d", *srv.server_address[:2])
    return srv
