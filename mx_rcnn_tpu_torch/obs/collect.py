"""Cross-process metric collection: N registries → one labeled view.

Counterpart of ``mx_rcnn_tpu/obs/collect.py`` (``RegistrySource``,
``HttpSource``, ``Collector``, ``view_to_snapshot``,
``sources_from_urls``).  Two source kinds, one scrape contract,
``scrape() -> (snapshot, labels) | None``:

* :class:`RegistrySource` — an in-process registry, resolved through a
  callable on every scrape, so that the source follows object churn (a
  relaunched engine's new registry);
* :class:`HttpSource` — a remote ``/metrics`` JSON endpoint (a training
  rank's ``obs.metrics_port`` exporter, a ``tools/serve.py`` front end;
  ``cfg.obs.collect_urls`` lists them).

A failed scrape marks the source ``up: false`` for that collection and
nothing else.  :meth:`Collector.collect` returns::

    {"ts": ..., "up": <n live>, "sources": {
         "rank-0": {"up": true, "labels": {"source": "rank-0", ...},
                    "counters": ..., "gauges": ..., "hists": ...}, ...},
     "agg": {"counters": <summed across live sources>,
             "gauges": {name: {source: value}}}}

Counters sum across sources (each source is a distinct registry); gauges
stay per source.  Not ported: ``collector_for_fleet``, which reads the
fleet router (``serve/fleet.py``), a tier the port does not have yet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from mx_rcnn_tpu_torch.netio import read_limited

logger = logging.getLogger("mx_rcnn_tpu_torch")

ScrapeResult = Optional[Tuple[Dict, Dict]]


class RegistrySource:
    """An in-process registry behind a per-scrape resolver.

    ``resolve() -> (registry, labels) | None`` runs on EVERY scrape:
    returning None means "down right now" (e.g. the replica is mid-
    relaunch); returning a different registry object next time is the
    expected relaunch behavior, not an error.  A bare registry is
    accepted for the static case (tests, the train process's own
    registry).
    """

    def __init__(self, name: str, registry_or_resolve,
                 labels: Optional[Dict] = None):
        self.name = name
        self._static_labels = dict(labels or {})
        if callable(registry_or_resolve):
            self._resolve = registry_or_resolve
        else:
            reg = registry_or_resolve
            self._resolve = lambda: (reg, {})

    def scrape(self) -> ScrapeResult:
        try:
            resolved = self._resolve()
        except Exception:
            logger.exception("obs collect: source %s resolver failed",
                             self.name)
            return None
        if resolved is None:
            return None
        reg, labels = resolved
        if reg is None:
            return None
        snap = reg.snapshot()
        merged = {"source": self.name, **self._static_labels,
                  **(labels or {})}
        return snap, merged


class HttpSource:
    """A remote ``/metrics`` JSON endpoint (the stdlib exporter's or the
    serve front end's response body is ``Registry.snapshot`` shaped).

    Every request carries a hard per-request timeout, and consecutive
    failures open an exponential backoff window during which
    :meth:`scrape` reports down WITHOUT touching the socket.  Together
    they bound what one wedged endpoint can cost the collection loop: a
    host that accepts connections but never answers (half-open after a
    SIGKILL, a hung agent) stalls ONE scrape for ``timeout_s``, then
    costs nothing until its backoff expires — it cannot turn every
    sampler tick into a fleet-wide ``timeout_s`` stall while the other
    sources' data ages.
    """

    def __init__(self, name: str, url: str, timeout_s: float = 2.0,
                 labels: Optional[Dict] = None,
                 backoff_base_s: float = 1.0,
                 backoff_cap_s: float = 30.0,
                 max_bytes: int = 8 << 20):
        self.name = name
        if url.isdigit():  # bare port ("9101") = this host's exporter
            url = f"127.0.0.1:{url}"
        self.url = url if "://" in url else f"http://{url}"
        if not self.url.rstrip("/").endswith("/metrics"):
            self.url = self.url.rstrip("/") + "/metrics"
        self.timeout_s = float(timeout_s)
        self.max_bytes = int(max_bytes)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._static_labels = dict(labels or {})
        self._lock = threading.Lock()
        self._failures = 0           # consecutive, reset on success
        self._skip_until = 0.0       # monotonic deadline of the window

    def failures(self) -> int:
        with self._lock:
            return self._failures

    def scrape(self) -> ScrapeResult:
        with self._lock:
            if time.monotonic() < self._skip_until:
                return None  # backing off: down, and no socket touched
        try:
            with urllib.request.urlopen(self.url,
                                        timeout=self.timeout_s) as r:
                # capped read: a malicious/broken exporter streaming an
                # unbounded body is a typed failure (ResponseTooLarge is
                # a ValueError), counted and backed off like any other
                # capped AND wall-clock bounded: a trickling exporter
                # (one byte per tick never trips the socket timeout)
                # is cut off as ResponseTooSlow, another ValueError
                snap = json.loads(
                    read_limited(r, self.max_bytes, "metrics body",
                                 deadline_s=self.timeout_s * 4.0
                                 ).decode())
        except Exception as e:  # refused / timeout / bad JSON / too big
            with self._lock:
                self._failures += 1
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s
                            * (2.0 ** (self._failures - 1)))
                self._skip_until = time.monotonic() + delay
            logger.debug("obs collect: source %s (%s) down: %s",
                         self.name, self.url, e)
            return None
        with self._lock:
            self._failures = 0
            self._skip_until = 0.0
        if not isinstance(snap, dict):
            return None
        # the serve front end nests the registry under "registry";
        # normalize both shapes to Registry.snapshot
        if "registry" in snap and "counters" not in snap:
            snap = snap["registry"]
        return snap, {"source": self.name, "url": self.url,
                      **self._static_labels}


class Collector:
    """Merge N sources into one labeled view, churn-tolerant.

    Sources add/remove under a lock; :meth:`collect` scrapes every
    source and never raises — a down source is data (``up: false``),
    not an exception.
    """

    def __init__(self, sources: Optional[List] = None,
                 clock: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        self._sources: Dict[str, object] = {}
        # head-local gauge callables (no registry of their own): each
        # returns {name: value} folded into agg.gauges under the "head"
        # source on every collect — how the skew estimator's
        # obs.skew_ms.* gauges reach the timeseries store without a
        # dedicated registry
        self._gauge_fns: List[Callable[[], Dict[str, float]]] = []
        # view-timestamp clock: wall time unless a test gives one
        self._clock = clock
        for s in sources or []:
            self._sources[s.name] = s

    def add(self, source) -> None:
        with self._lock:
            self._sources[source.name] = source

    def add_gauge_fn(self, fn: Callable[[], Dict[str, float]]) -> None:
        with self._lock:
            self._gauge_fns.append(fn)

    def remove(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def collect(self) -> Dict:
        with self._lock:
            sources = list(self._sources.values())
            gauge_fns = list(self._gauge_fns)
        view: Dict = {"ts": round(self._clock(), 6), "sources": {}}
        agg_counters: Dict[str, float] = {}
        agg_gauges: Dict[str, Dict[str, float]] = {}
        up = 0
        for src in sources:
            res = src.scrape()
            if res is None:
                view["sources"][src.name] = {"up": False}
                continue
            snap, labels = res
            up += 1
            view["sources"][src.name] = {
                "up": True, "labels": labels,
                "counters": snap.get("counters", {}),
                "gauges": snap.get("gauges", {}),
                "hists": snap.get("hists", {}),
            }
            for k, v in snap.get("counters", {}).items():
                agg_counters[k] = agg_counters.get(k, 0) + v
            for k, v in snap.get("gauges", {}).items():
                agg_gauges.setdefault(k, {})[src.name] = v
        for fn in gauge_fns:
            try:
                extra = fn()
            except Exception:
                logger.exception("obs collect: gauge fn failed")
                continue
            for k, v in (extra or {}).items():
                agg_gauges.setdefault(k, {})["head"] = float(v)
        view["up"] = up
        view["agg"] = {"counters": agg_counters, "gauges": agg_gauges}
        return view


def view_to_snapshot(view: Dict) -> Dict:
    """Collapse one collected view into a ``Registry.snapshot``-shaped
    dict so windowed judgment can run over a FLEET the same way it runs
    over a process (append these to a
    :class:`~mx_rcnn_tpu_torch.obs.timeseries.TimeSeriesStore`).

    Merge semantics, chosen conservative for SLO rules:

    * counters — the agg SUM (fleet totals; sources are distinct
      registries, so summing cannot double-count);
    * gauges   — the bare name keeps the MIN across sources (a
      readiness gauge judged fleet-wide must reflect the worst source)
      and every per-source value survives as ``name@source``;
    * hist summaries — counts sum; p50/p90/p99/max take the MAX across
      sources (the fleet's tail is its worst source's tail).
    """
    gauges: Dict[str, float] = {}
    for name, by_src in view["agg"]["gauges"].items():
        gauges[name] = min(by_src.values())
        for src, v in by_src.items():
            gauges[f"{name}@{src}"] = v
    hists: Dict[str, Dict] = {}
    for src in view["sources"].values():
        if not src.get("up"):
            continue
        for name, s in src.get("hists", {}).items():
            if name not in hists:
                hists[name] = dict(s)
                continue
            m = hists[name]
            m["count"] = (m.get("count") or 0) + (s.get("count") or 0)
            for k in ("p50", "p90", "p99", "max", "mean"):
                a, b = m.get(k), s.get(k)
                m[k] = b if a is None else (a if b is None else max(a, b))
    return {"counters": dict(view["agg"]["counters"]),
            "gauges": gauges, "hists": hists}


def sources_from_urls(urls: str) -> List[HttpSource]:
    """``cfg.obs.collect_urls`` / ``--url`` parsing: a comma-separated
    list of ``host:port`` or full URLs, optionally ``name=url``."""
    out: List[HttpSource] = []
    for i, item in enumerate(s.strip() for s in urls.split(",")):
        if not item:
            continue
        if "=" in item and "://" not in item.split("=", 1)[0]:
            name, url = item.split("=", 1)
        else:
            name, url = f"source-{i}", item
        out.append(HttpSource(name.strip(), url.strip()))
    return out
