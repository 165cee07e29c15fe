"""Bounded ring-buffer time series over the metrics registry.

Counterpart of ``mx_rcnn_tpu/obs/timeseries.py``.  The registry answers
"what are the totals now"; this store answers "what moved over the last
30 s", the question the health rules (``obs/health.py``) and the flight
recorder (``obs/flightrec.py``) ask.  Off by default; sampling runs on
its own daemon thread, so recorders never see it; memory is a ring of
``capacity`` samples.

One sample is a consistent copy of the registry taken under its lock:
counter totals, gauge values, and each histogram's cumulative bucket
counts and total/sum/max.  Windowed queries difference two samples:

* ``delta(name, window_s)``   — counter increase over the window;
* ``rate(name, window_s)``    — delta over the sampled span;
* ``gauge(name)``             — latest value; ``gauge_max``/``gauge_min``
  scan the window;
* ``pctl(name, p, window_s)`` — the exact windowed percentile, from the
  bucket-count difference (the same upper-edge readout as
  ``Histogram.percentile``, over the window's samples only);
* ``hist_window(name, window_s)`` — count/p50/p99 over the window.

Samples ingested from a remote ``/metrics`` scrape
(:meth:`TimeSeriesStore.append_snapshot`) carry histogram summaries, not
bucket counts; there ``pctl`` falls back to the latest scraped
percentile.

The module's active store (:func:`set_active` / :func:`active`) tells
the ``/metrics`` exporters (``obs/metrics.py``, ``serve/server.py``) to
add a ``"timeseries"`` section; ``CliObs`` sets it when
``cfg.obs.timeseries`` is on.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("mx_rcnn_tpu_torch")


class TimeSeriesStore:
    """Ring buffer of registry samples with windowed queries.

    Thread-safe: the sampler thread appends while query threads (health
    engine, HTTP scrape, flight dump) read; one lock bounds both.  At
    the default 1 s interval and 600-sample capacity the ring holds ten
    minutes; memory is ~(hists × 41 int64 + counters + gauges) per
    sample — a few KB for this repo's metric surface.
    """

    def __init__(self, capacity: int = 600,
                 clock: Callable[[], float] = time.time):
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=self.capacity)
        self._dropped = 0

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def sample(self, reg=None, ts: Optional[float] = None) -> Dict:
        """Take one consistent sample of ``reg`` (default: the process
        registry) and append it.  Runs on the sampler thread — never on
        a recording hot path."""
        if reg is None:
            from mx_rcnn_tpu_torch.obs.metrics import registry as _registry

            reg = _registry()
        ts = self._clock() if ts is None else ts
        with reg.lock:
            counters = dict(reg._counters)
            gauges = dict(reg._gauges)
            # counts.copy() under the registry lock: the cumulative
            # bucket vector is the windowed-percentile substrate
            hists = {name: {"bounds": h.bounds,
                            "counts": h.counts.copy(),
                            "total": int(h.total),
                            "sum": float(h.sum),
                            "max": float(h.max)}
                     for name, h in reg._hists.items()}
        smp = {"ts": ts, "counters": counters, "gauges": gauges,
               "hists": hists}
        self._append(smp)
        return smp

    def append_snapshot(self, snap: Dict, ts: Optional[float] = None,
                        gauge_labels: Optional[Dict[str, Dict]] = None
                        ) -> Dict:
        """Ingest a remote ``/metrics`` snapshot (``Registry.snapshot``
        shape) as one sample: the cross-process path.  Histograms arrive
        as summaries (no bucket counts), so windowed percentiles over
        these samples fall back to the latest summary value."""
        smp = {"ts": self._clock() if ts is None else ts,
               "counters": dict(snap.get("counters", {})),
               "gauges": dict(snap.get("gauges", {})),
               "hists": {name: {"summary": dict(s)}
                         for name, s in snap.get("hists", {}).items()}}
        if gauge_labels:
            smp["labels"] = gauge_labels
        self._append(smp)
        return smp

    def _append(self, smp: Dict) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append(smp)

    # ------------------------------------------------------------------
    # windowed reads
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def window(self, window_s: Optional[float] = None) -> List[Dict]:
        """Samples within the trailing window (all, when None), oldest
        first.  Returns the sample dicts themselves — treat as
        read-only (samples are immutable once appended)."""
        with self._lock:
            out = list(self._buf)
        if window_s is None or not out:
            return out
        cut = out[-1]["ts"] - float(window_s)
        return [s for s in out if s["ts"] >= cut]

    def _edges(self, window_s: Optional[float]
               ) -> Optional[Tuple[Dict, Dict]]:
        w = self.window(window_s)
        if len(w) < 2:
            return None
        return w[0], w[-1]

    def delta(self, name: str, window_s: Optional[float] = None
              ) -> Optional[float]:
        """Counter increase across the window (None: not enough
        samples or the counter never appeared)."""
        e = self._edges(window_s)
        if e is None:
            return None
        a, b = e
        if name not in b["counters"]:
            return None
        return float(b["counters"][name] - a["counters"].get(name, 0))

    def rate(self, name: str, window_s: Optional[float] = None
             ) -> Optional[float]:
        """Counter rate (per second) over the ACTUAL sampled span —
        the span between the window's edge samples, not the nominal
        window length."""
        e = self._edges(window_s)
        if e is None:
            return None
        d = self.delta(name, window_s)
        if d is None:
            return None
        span = e[1]["ts"] - e[0]["ts"]
        if span <= 0:
            return None
        return d / span

    def gauge(self, name: str,
              window_s: Optional[float] = None) -> Optional[float]:
        """Most recent value of the gauge (scanning back for the last
        sample that carried it).  ``window_s`` bounds the scan: a gauge
        whose source stopped reporting longer than the window ago reads
        None — exactly like a source that NEVER reported.  Unbounded
        (the default) preserves the original latest-ever semantics."""
        for smp in reversed(self.window(window_s)):
            if name in smp["gauges"]:
                return float(smp["gauges"][name])
        return None

    def gauge_max(self, name: str, window_s: Optional[float] = None
                  ) -> Optional[float]:
        vals = [s["gauges"][name] for s in self.window(window_s)
                if name in s["gauges"]]
        return max(vals) if vals else None

    def gauge_min(self, name: str, window_s: Optional[float] = None
                  ) -> Optional[float]:
        vals = [s["gauges"][name] for s in self.window(window_s)
                if name in s["gauges"]]
        return min(vals) if vals else None

    def series(self, name: str, window_s: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """(ts, value) pairs for a gauge or counter over the window —
        the canary-comparison / plotting readout."""
        out = []
        for s in self.window(window_s):
            if name in s["gauges"]:
                out.append((s["ts"], float(s["gauges"][name])))
            elif name in s["counters"]:
                out.append((s["ts"], float(s["counters"][name])))
        return out

    def pctl(self, name: str, p: float,
             window_s: Optional[float] = None) -> Optional[float]:
        """Windowed histogram percentile.  With bucket-count samples the
        readout is EXACT for the window (cumulative-count difference,
        bucket-upper-bound estimate); with summary-only samples (remote
        scrapes) it degrades to the latest scraped ``p<P>``."""
        e = self._edges(window_s)
        if e is None:
            w = self.window(window_s)
            e = (w[-1], w[-1]) if w else None
        if e is None:
            return None
        a, b = e
        hb = b["hists"].get(name)
        if hb is None:
            return None
        if "counts" not in hb:  # summary-only (cross-process) sample
            return hb["summary"].get(f"p{int(p)}")
        ha = a["hists"].get(name)
        counts = hb["counts"] - (ha["counts"] if ha is not None
                                 and "counts" in ha else 0)
        total = int(counts.sum())
        if total <= 0:
            return None
        rank = int(np.ceil(p / 100.0 * total))
        rank = min(max(rank, 1), total)
        cum = np.cumsum(counts)
        i = int(np.searchsorted(cum, rank))
        bounds = hb["bounds"]
        if i >= len(bounds):
            return float(hb["max"])  # overflow bucket: observed max
        return float(bounds[i])

    def hist_window(self, name: str,
                    window_s: Optional[float] = None) -> Optional[Dict]:
        """Windowed histogram readout: sample count + p50/p99 over the
        window (summary-shaped, like ``Histogram.summary`` minus
        mean)."""
        e = self._edges(window_s)
        if e is None:
            return None
        a, b = e
        hb = b["hists"].get(name)
        if hb is None:
            return None
        if "counts" not in hb:
            s = dict(hb["summary"])
            s["windowed"] = False
            return s
        ha = a["hists"].get(name)
        prev_total = (ha["total"] if ha is not None
                      and "counts" in ha else 0)
        return {"count": int(hb["total"]) - int(prev_total),
                "p50": self.pctl(name, 50, window_s),
                "p99": self.pctl(name, 99, window_s),
                "max": float(hb["max"]),
                "windowed": True}

    # ------------------------------------------------------------------
    # scrape section
    # ------------------------------------------------------------------

    def scrape_section(self, window_s: float = 60.0) -> Dict:
        """The compact ``"timeseries"`` block the ``/metrics`` exporters
        attach when this store is active: ring occupancy plus windowed
        rates and p99s for everything the window saw move."""
        w = self.window(window_s)
        out: Dict = {"samples": len(self), "capacity": self.capacity,
                     "window_s": float(window_s), "dropped": self.dropped}
        if len(w) >= 2:
            a, b = w[0], w[-1]
            out["span_s"] = round(b["ts"] - a["ts"], 3)
            rates = {}
            for name in b["counters"]:
                r = self.rate(name, window_s)
                if r:
                    rates[name] = round(r, 3)
            out["rates_per_s"] = rates
            p99 = {}
            for name in b["hists"]:
                v = self.pctl(name, 99, window_s)
                if v is not None:
                    p99[name] = round(v, 3)
            out["p99"] = p99
        return out


class Sampler:
    """Daemon thread sampling a registry into a store on an interval.

    ``after_sample`` (optional) runs on the sampler thread after every
    tick — the health engine evaluates there, so sampling + judging is
    ONE thread and the hot paths stay untouched.  Fail-soft: a hook
    exception logs and disables the hook, never kills the sampler (the
    runrec invariant: observability must not take down what it
    observes).
    """

    def __init__(self, store: TimeSeriesStore, interval_s: float = 1.0,
                 reg=None,
                 after_sample: Optional[Callable[[Dict], None]] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.store = store
        self.interval_s = max(float(interval_s), 0.01)
        self._reg = reg
        self._after = after_sample
        # sample timestamp source; None defers to the store's clock
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> Dict:
        """One sample and hook pass (public, so that tests drive the
        cadence without the wall-clock loop)."""
        ts = None if self._clock is None else self._clock()
        smp = self.store.sample(self._reg, ts=ts)
        if self._after is not None:
            try:
                self._after(smp)
            except Exception:
                logger.exception("obs timeseries: after_sample hook "
                                 "failed — hook disabled")
                self._after = None
        return smp

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def start(self) -> "Sampler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="obs-ts-sampler",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, final_sample: bool = True) -> None:
        """Stop the loop (bounded join) and by default take one last
        sample so the ring's tail reflects shutdown state."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(self.interval_s * 2, 1.0))
            self._thread = None
        if final_sample:
            self.tick()


# ---------------------------------------------------------------------------
# active-store registration (the exporter hook)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_ACTIVE: Optional[TimeSeriesStore] = None


def set_active(store: Optional[TimeSeriesStore]) -> None:
    """Publish ``store`` as THE process time-series store: the
    ``/metrics`` exporters include its scrape section, the flight
    recorder dumps its window.  Pass None to clear."""
    global _ACTIVE
    with _active_lock:
        _ACTIVE = store


def active() -> Optional[TimeSeriesStore]:
    with _active_lock:
        return _ACTIVE
