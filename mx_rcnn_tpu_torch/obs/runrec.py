"""Structured run records: ``runs/<id>/events.jsonl`` and a summary.

Counterpart of ``mx_rcnn_tpu/obs/runrec.py``.  Every ``tools/train.py``
(each rank of ``--num_devices N`` too), ``tools/serve.py`` and
``tools/loadgen.py`` run with ``obs.enabled`` writes:

* ``runs/<id>/events.jsonl`` — one JSON object a line, appended live::

      {"ts": <unix seconds>, "event": "<kind>", ...payload}

  The crash contract is line-granular: each line reaches the kernel as
  it is written (line buffering), so a process crash loses nothing; a
  host crash may lose an un-fsynced tail and tear the last line, so
  readers take every whole line as real and a torn last line as the
  crash point.  ``close()`` fsyncs the stream once.  A per-event fsync
  would put disk latency on the training and serving hot paths.
* ``runs/<id>/summary.json`` — one final BENCH-style record
  (``{"metric", "value", "unit", "measured", ...}``) and the closing
  snapshot of the process registry.  It is one document read whole, so
  it goes through ``utils/checkpoint.py — _atomic_write``: a crash while
  it is written leaves no half summary that parses as a finished run.
* ``runs/<id>/trace.json`` and ``runs/<id>/profile/`` — the chrome trace
  and the profiler windows, when those are on (written by ``CliObs``
  and the fit loop).

The record never raises into the run it records: a write failure logs
and disables it.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("mx_rcnn_tpu_torch")


def _jsonable(obj):
    """Fallback serializer: numpy scalars/arrays and anything else that
    sneaks into an event payload degrade to plain types, never a crash."""
    for attr in ("item",):
        if hasattr(obj, attr):
            try:
                return obj.item()
            except Exception:
                pass
    if hasattr(obj, "tolist"):
        try:
            return obj.tolist()
        except Exception:
            pass
    return repr(obj)


class RunRecord:
    """One run directory under ``base_dir`` with a live event stream.

    ``run_id`` defaults to ``<kind>-<utc timestamp>-<pid>`` — unique per
    process without coordination.  Thread-safe: the fit loop, snapshot
    writer and HTTP threads may all emit events.
    """

    def __init__(self, kind: str, base_dir: str = "runs",
                 run_id: Optional[str] = None):
        self.kind = kind
        self.run_id = run_id or "{}-{}-{}".format(
            kind, time.strftime("%Y%m%d-%H%M%S", time.gmtime()),
            os.getpid())
        self.dir = os.path.join(base_dir, self.run_id)
        self.events_path = os.path.join(self.dir, "events.jsonl")
        self.summary_path = os.path.join(self.dir, "summary.json")
        self._lock = threading.Lock()
        self._n = 0
        self._dead = False
        self._listeners = []
        try:
            os.makedirs(self.dir, exist_ok=True)
            # append-only, line-granular (module docstring)
            # persistlint: disable=PL101 append-only event stream with a line-granular crash contract (module docstring): each line is flushed, readers tolerate a torn tail line, close() fsyncs; an atomic rewrite per event would put disk latency on the hot path
            self._f = open(self.events_path, "a", buffering=1)
        except OSError as e:
            logger.warning("obs runrec: cannot open %s (%s) — run record "
                           "disabled", self.events_path, e)
            self._f, self._dead = None, True
        self.event("run_start", kind=kind, pid=os.getpid(),
                   argv=list(sys.argv))

    def add_listener(self, fn) -> None:
        """Register ``fn(event_dict)`` to observe every event as it is
        emitted — the flight recorder (``obs/flightrec.py``) rings the
        run's events into its black box this way, with zero extra
        instrumentation at the emit sites.  Listeners run on the
        emitting thread and must be cheap; exceptions log and never
        propagate into the emitter."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def event(self, event: str, **payload) -> None:
        """Append one event line (flushed immediately); never raises."""
        if self._dead:
            return
        rec = {"ts": round(time.time(), 6), "event": event, **payload}
        try:
            line = json.dumps(rec, default=_jsonable)
        except (TypeError, ValueError) as e:
            logger.warning("obs runrec: unserializable event %r: %s",
                           event, e)
            return
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(rec)
            except Exception:
                logger.exception("obs runrec: event listener failed")
        with self._lock:
            if self._dead:
                return
            try:
                self._f.write(line + "\n")
                self._n += 1
            except OSError as e:
                logger.warning("obs runrec: write failed (%s) — run "
                               "record disabled", e)
                self._dead = True

    @property
    def num_events(self) -> int:
        return self._n

    def finish(self, metric: Optional[str] = None, value=None,
               unit: Optional[str] = None, registry=None,
               **extra) -> Dict:
        """Write the final BENCH-compatible ``summary.json`` (and a
        closing ``run_finish`` event).  ``registry`` (default: the
        process registry) snapshots into the summary under
        ``"metrics"``."""
        if registry is None:
            from mx_rcnn_tpu_torch.obs.metrics import registry as _registry

            registry = _registry()
        self.event("run_finish", metric=metric, value=value)
        summary = {
            "metric": metric or f"{self.kind}_run",
            "value": value,
            "unit": unit,
            "measured": value is not None,
            "run_id": self.run_id,
            "kind": self.kind,
            "events": self._n,
            **extra,
            "metrics": registry.snapshot(),
        }
        try:
            from mx_rcnn_tpu_torch.utils.checkpoint import _atomic_write

            _atomic_write(self.summary_path,
                          json.dumps(summary, indent=1,
                                     default=_jsonable).encode())
        except OSError as e:
            logger.warning("obs runrec: summary write failed: %s", e)
        return summary

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    # the final flush is durable: a run that reported
                    # success must not lose its closing events to a host
                    # crash (the line-granular contract's one fsync)
                    self._f.flush()
                    os.fsync(self._f.fileno())
                except (OSError, ValueError) as e:
                    logger.warning("obs runrec: final event-stream "
                                   "fsync failed (%s) — a host crash "
                                   "may lose the closing events", e)
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
            self._dead = True


class CliObs:
    """The obs wiring ``tools/train.py``, ``tools/serve.py`` and
    ``tools/loadgen.py`` share: the run record, the span trace, the
    ``/metrics`` exporter, the SIGUSR2 profiler toggle, and the
    time-series store with its sampler, health engine and flight
    recorder, with a fail-soft teardown: nothing here may mask the run's
    own exception or fail a run that succeeded.

    Fail-soft is not silent: each piece that fails to start or stop is
    logged, appended to :attr:`failures` and written to the summary as
    ``obs_failures``, so a check of a run reads it there.

    Build with :func:`cli_obs` (None when ``cfg.obs`` is off); pass
    ``.record`` to the run; call :meth:`close` once, from a ``finally``.
    ``rank`` offsets ``obs.metrics_port`` (each rank process of a
    data-parallel run serves its own registry).
    """

    def __init__(self, cfg, kind: str, rank: int = 0):
        self.cfg = cfg
        self.record = RunRecord(kind, base_dir=cfg.obs.run_dir)
        logger.info("obs: run record -> %s", self.record.dir)
        self.failures: List[str] = []
        self._metrics_srv = None
        self._traced = False
        self.store = None
        self.sampler = None
        self.health = None
        self.flight = None
        try:
            from mx_rcnn_tpu_torch.obs import trace as obs_trace

            if cfg.obs.trace:
                obs_trace.enable(cfg.obs.trace_cap)
                self._traced = True
            if cfg.obs.metrics_port:
                from mx_rcnn_tpu_torch.obs.metrics import \
                    start_metrics_server

                self._metrics_srv = start_metrics_server(
                    port=cfg.obs.metrics_port + rank)
            if cfg.obs.sigusr2:
                from mx_rcnn_tpu_torch.obs.profiler import install_sigusr2

                install_sigusr2(self.record.dir)
        except Exception as e:
            self._failed("CLI wiring", e)
        # the sampler drives the ring store and the health engine on one
        # daemon thread; the flight recorder rings the run record's
        # events and arms its triggers
        try:
            if (cfg.obs.timeseries or cfg.obs.health
                    or cfg.obs.flight):
                from mx_rcnn_tpu_torch.obs import timeseries as obs_ts
                from mx_rcnn_tpu_torch.obs.metrics import registry

                self.store = obs_ts.TimeSeriesStore(cfg.obs.ts_capacity)
                obs_ts.set_active(self.store)
                if cfg.obs.flight:
                    from mx_rcnn_tpu_torch.obs import flightrec

                    self.flight = flightrec.FlightRecorder(
                        self.store, self.record.dir,
                        window_s=cfg.obs.flight_window_s,
                        max_events=cfg.obs.flight_events)
                    self.record.add_listener(self.flight.note_event)
                    flightrec.set_active(self.flight)
                    self.flight.arm(
                        signals=threading.current_thread()
                        is threading.main_thread())
                if cfg.obs.health:
                    from mx_rcnn_tpu_torch.obs import health as obs_health

                    self.health = obs_health.HealthEngine(
                        obs_health.default_rules(cfg), self.store,
                        registry=registry(), record=self.record,
                        on_transition=(self.flight.on_health_transition
                                       if self.flight else None))
                    obs_health.set_active_engine(self.health)
                self.sampler = obs_ts.Sampler(
                    self.store, interval_s=cfg.obs.sample_interval_s,
                    after_sample=(self.health.evaluate_sample
                                  if self.health else None))
                self.sampler.start()
        except Exception as e:
            self._failed("time-series wiring", e)

    def _failed(self, what: str, err: BaseException) -> None:
        logger.exception("obs: %s failed; continuing without it", what)
        self.failures.append(f"{what}: {err!r}")
        self.record.event("obs_failure", what=what, error=repr(err))

    def close(self, metric: Optional[str] = None, value=None,
              unit: Optional[str] = None, **extra) -> None:
        """Stop the sampler, export the chrome trace (host spans, merged
        with the newest profiler window's device events when there is
        one), write the summary, undo the process-wide hooks and stop
        the exporter.  Never raises."""
        try:
            if self.sampler is not None:
                # one last sample (and health pass), so the ring's tail
                # is the shutdown state before the summary snapshots it
                self.sampler.stop(final_sample=True)
        except Exception as e:
            self._failed("sampler stop", e)
        try:
            from mx_rcnn_tpu_torch.obs import trace as obs_trace

            if obs_trace.enabled():
                obs_trace.merge_device_trace(
                    os.path.join(self.record.dir, "trace.json"),
                    self.cfg.obs.profile_dir or self.record.dir)
            if self._traced:
                obs_trace.disable()
        except Exception as e:
            self._failed("chrome-trace export", e)
        try:
            self.record.finish(metric=metric, value=value, unit=unit,
                               obs_failures=list(self.failures), **extra)
        except Exception:
            logger.exception("obs: run summary write failed")
        self.record.close()
        try:
            if self.flight is not None:
                from mx_rcnn_tpu_torch.obs import flightrec

                self.flight.disarm()
                flightrec.set_active(None)
            if self.health is not None:
                from mx_rcnn_tpu_torch.obs import health as obs_health

                obs_health.set_active_engine(None)
            if self.store is not None:
                from mx_rcnn_tpu_torch.obs import timeseries as obs_ts

                obs_ts.set_active(None)
        except Exception:
            logger.exception("obs: time-series teardown failed")
        if self._metrics_srv is not None:
            try:
                self._metrics_srv.shutdown()
                self._metrics_srv.server_close()
            except Exception:
                logger.exception("obs: metrics exporter shutdown failed")


def cli_obs(cfg, kind: str, rank: int = 0) -> Optional[CliObs]:
    """:class:`CliObs` when ``cfg.obs.enabled``, else None, so callers
    write ``obs_sess = cli_obs(cfg, "train")`` and guard on None."""
    if getattr(cfg, "obs", None) is not None and cfg.obs.enabled:
        return CliObs(cfg, kind, rank)
    return None
