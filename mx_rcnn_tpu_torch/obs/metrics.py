"""Serving metrics: counters and log-bucket histograms.

Counterpart of ``mx_rcnn_tpu/obs/metrics.py`` (``Histogram``,
``Registry``, ``ServeMetrics``) with the same bucket edges (40
log-spaced buckets from 0.1 ms to 30 s, then an open one), the same
upper-edge percentile readout and the same ``ServeMetrics.snapshot()``
keys, so the two packages' ``/metrics`` bodies and load-generator
records read alike.  Recording is a dict lookup and a few float
operations under one lock; a snapshot needs no per-sample history.

Only what the serving engine records is here.  The JAX package's gauges,
its per-name readers and its process-wide ``registry()`` feed the
unified obs scrape, which is not ported; ``LoweringCounter`` counts XLA
lowerings, and the port compiles no program.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np


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
        self.counts[i] += 1
        self.total += 1
        self.sum += value
        self.max = max(self.max, value)

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
    """Thread-safe named counters and histograms, created on first
    record; :meth:`snapshot` reads all of them under one lock."""

    def __init__(self):
        self.lock = threading.RLock()
        self._counters: Dict[str, int] = {}
        self._hists: Dict[str, Histogram] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self.lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe(self, name: str, value: float, lo: float = 0.1,
                hi: float = 30_000.0, buckets: int = 40) -> None:
        """Record ``value`` into the named histogram (made on first use
        with the given bucket geometry)."""
        with self.lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(lo, hi, buckets)
            h.record(value)

    def snapshot(self) -> Dict:
        with self.lock:
            return {
                "counters": dict(sorted(self._counters.items())),
                "hists": {name: h.summary()
                          for name, h in sorted(self._hists.items())},
            }

    def reset(self, prefix: str = "") -> None:
        """Remove the metrics whose name starts with ``prefix``; they
        come back at zero on their next record.  Call it between phases:
        it is not atomic against concurrent recorders."""
        with self.lock:
            for d in (self._counters, self._hists):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]


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
            for h in _HISTS + _PORT_HISTS:
                self.registry._hists[p + h] = Histogram()

    # every accessor tolerates a missing key: Registry.reset removes
    # entries, and a shared registry may be reset under live traffic

    @property
    def counters(self) -> Dict[str, int]:
        with self.registry.lock:
            return {k: self.registry._counters.get(self.PREFIX + k, 0)
                    for k in _COUNTERS}

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
