"""Black-box flight recorder: last-N-seconds postmortem dumps.

Counterpart of ``mx_rcnn_tpu/obs/flightrec.py``.  The recorder keeps the
recent past in memory (bounded, off the hot path) and writes it out only
when something goes wrong:

* **samples** — the ``obs/timeseries.py`` ring is the window; a dump
  takes its trailing ``window_s`` (bucket counts as lists);
* **events**  — a bounded deque fed by ``RunRecord.add_listener``;
* **spans**   — the tail of the ``obs/trace.py`` buffer, when tracing is
  on, and the distributed ring's kept span trees;
* **context** — callables the CLIs register (``tools/serve.py`` the
  engine's ``healthz``, ``tools/train.py`` the step counters), each
  called fail-soft at dump time.

Triggers (:meth:`FlightRecorder.arm` wires all four):

* **crash**       — a chained ``sys.excepthook``;
* **SIGTERM**     — the handler only sets a flag and calls the handler it
  replaced (a training CLI's stop flag keeps working: the interrupt
  checkpoint is still written); a daemon worker writes the dump, and an
  ``atexit`` backstop covers an interpreter that unwinds first.  A
  handler must not do the I/O itself: it runs between two bytecodes of
  the main thread, which may hold the locks the dump needs;
* **lock-watchdog trip** — ``analysis/sanitizer.py`` calls its trip
  listeners when an acquire stalls past the budget;
* **health CRITICAL** — ``CliObs`` points the health engine's transition
  callback here.

Dumps land in ``runs/<id>/flight/<seq>-<reason>/flight.json`` through
``utils/checkpoint.py — _atomic_write`` (a crash during the dump leaves
no torn record), at most one per reason per ``min_gap_s``.  A dump that
cannot be written logs and never takes down the run it records.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore

logger = logging.getLogger("mx_rcnn_tpu_torch")


def _sample_jsonable(smp: Dict) -> Dict:
    """A ring sample with ndarray bucket state → plain JSON types."""
    out = {"ts": smp["ts"], "counters": smp["counters"],
           "gauges": smp["gauges"]}
    hists = {}
    for name, h in smp.get("hists", {}).items():
        if "counts" in h:
            hists[name] = {"counts": h["counts"].tolist(),
                           "bounds": [float(b) for b in h["bounds"]],
                           "total": h["total"], "sum": h["sum"],
                           "max": h["max"]}
        else:
            hists[name] = dict(h)
    out["hists"] = hists
    if "labels" in smp:
        out["labels"] = smp["labels"]
    return out


class FlightRecorder:
    """Bounded in-memory black box with fail-soft durable dumps."""

    def __init__(self, store: TimeSeriesStore, run_dir: str,
                 window_s: float = 120.0, max_events: int = 512,
                 span_tail: int = 500, min_gap_s: float = 5.0,
                 trace_tree_tail: int = 32):
        self.store = store
        self.flight_dir = os.path.join(run_dir, "flight")
        self.window_s = float(window_s)
        self.span_tail = int(span_tail)
        # schema /2: the distributed trace ring's last-N kept span
        # trees ride the dump (a postmortem names the slow/failed
        # requests, not just the aggregate window)
        self.trace_tree_tail = int(trace_tree_tail)
        self.min_gap_s = float(min_gap_s)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(max_events))
        self._context: Dict[str, Callable[[], Dict]] = {}
        self._last_dump: Dict[str, float] = {}
        self._seq = 0
        self.dumps: List[str] = []
        # SIGTERM trigger state: handler flips, worker dumps
        self._term = threading.Event()
        self._term_worker: Optional[threading.Thread] = None
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._armed = False

    # ------------------------------------------------------------------
    # feeds
    # ------------------------------------------------------------------

    def note_event(self, event: Dict) -> None:
        """Ring an event into the black box (the ``RunRecord`` listener
        target — also callable directly by planes with no record)."""
        with self._lock:
            self._events.append(dict(event))

    def add_context(self, name: str, fn: Callable[[], Dict]) -> None:
        """Register a live context provider invoked at dump time (e.g.
        the serving engine's ``healthz``: its queue depths and warm
        buckets at the moment of the dump)."""
        with self._lock:
            self._context[name] = fn

    # ------------------------------------------------------------------
    # the dump
    # ------------------------------------------------------------------

    def dump(self, reason: str, force: bool = False, **extra
             ) -> Optional[str]:
        """Write one flight record; returns its path (None when
        rate-limited or the write failed).  Never raises."""
        now = time.monotonic()
        with self._lock:
            if not force:
                last = self._last_dump.get(reason)
                if last is not None and now - last < self.min_gap_s:
                    return None
            self._last_dump[reason] = now
            self._seq += 1
            seq = self._seq
            events = list(self._events)
            context_fns = dict(self._context)
        record: Dict = {
            # /2: adds "trace_trees" — the distributed trace ring's last
            # N kept span trees (absent when the plane is unarmed)
            "schema": "mx_rcnn_tpu.flight/2",
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "window_s": self.window_s,
            "samples": [_sample_jsonable(s)
                        for s in self.store.window(self.window_s)],
            "events": events,
        }
        try:
            from mx_rcnn_tpu_torch.obs import trace as obs_trace

            if obs_trace.enabled():
                record["spans"] = obs_trace.events()[-self.span_tail:]
        except Exception:
            logger.exception("obs flight: span capture failed")
        try:
            from mx_rcnn_tpu_torch.obs import trace as obs_trace

            if obs_trace.ring() is not None:
                record["trace_trees"] = obs_trace.kept_trees(
                    limit=self.trace_tree_tail)
        except Exception:
            logger.exception("obs flight: trace-tree capture failed")
        ctx: Dict = {}
        for name, fn in context_fns.items():
            try:
                ctx[name] = fn()
            except Exception as e:
                ctx[name] = {"error": repr(e)}
        record["context"] = ctx
        if extra:
            record["extra"] = {k: _best_effort_jsonable(v)
                               for k, v in extra.items()}
        path = os.path.join(self.flight_dir, f"{seq:03d}-{reason}",
                            "flight.json")
        try:
            from mx_rcnn_tpu_torch.utils.checkpoint import _atomic_write

            os.makedirs(os.path.dirname(path), exist_ok=True)
            _atomic_write(path, json.dumps(
                record, default=repr).encode())
        except Exception:
            logger.exception("obs flight: dump write failed (%s)", path)
            return None
        with self._lock:
            self.dumps.append(path)
        logger.warning("obs flight: %s record -> %s", reason, path)
        return path

    # ------------------------------------------------------------------
    # triggers
    # ------------------------------------------------------------------

    def arm(self, signals: bool = True, excepthook: bool = True,
            watchdog: bool = True) -> None:
        """Install the trigger paths (idempotent).  Signal arming only
        works on the main thread — callers off it (tests) pass
        ``signals=False``."""
        if self._armed:
            return
        self._armed = True
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._on_crash
        if watchdog:
            try:
                from mx_rcnn_tpu_torch.analysis import sanitizer

                sanitizer.add_trip_listener(self._on_watchdog_trip)
            except Exception:
                logger.exception("obs flight: watchdog hook failed")
        if signals:
            try:
                self._term_worker = threading.Thread(
                    target=self._term_loop, name="obs-flight-sigterm",
                    daemon=True)
                self._term_worker.start()
                self._prev_sigterm = signal.signal(signal.SIGTERM,
                                                   self._on_sigterm)
                atexit.register(self._atexit_backstop)
            except (ValueError, OSError) as e:
                # not the main thread / unsupported platform
                logger.warning("obs flight: SIGTERM trigger not armed "
                               "(%s)", e)

    def disarm(self) -> None:
        """Undo the process-global hooks (tests; long-lived sessions
        building successive recorders)."""
        if not self._armed:
            return
        self._armed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        try:
            from mx_rcnn_tpu_torch.analysis import sanitizer

            sanitizer.remove_trip_listener(self._on_watchdog_trip)
        except Exception:
            logger.debug("obs flight: watchdog unhook failed")
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None
        self._term.set()  # release the worker

    # -- crash ----------------------------------------------------------

    def _on_crash(self, exc_type, exc, tb) -> None:
        self.dump("crash", error=f"{exc_type.__name__}: {exc}")
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    # -- SIGTERM --------------------------------------------------------

    def _on_sigterm(self, signum, frame) -> None:
        # signal handler: set the flag and chain, nothing else (the
        # worker thread dumps; I/O or the store's lock here could
        # deadlock against whatever the main thread was holding)
        self._term.set()
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)

    def _term_loop(self) -> None:
        self._term.wait()
        if self._armed:
            self.dump("sigterm")

    def _atexit_backstop(self) -> None:
        # the interpreter can unwind before the worker wakes; atexit
        # runs on the main thread after the handler returned, so a
        # pending flag with no dump yet gets one here
        if self._term.is_set() and self._armed:
            with self._lock:
                dumped = any("sigterm" in p for p in self.dumps)
            if not dumped:
                self.dump("sigterm")

    # -- watchdog / health ---------------------------------------------

    def _on_watchdog_trip(self, trip: Dict) -> None:
        self.note_event({"event": "watchdog_trip", **trip})
        self.dump("watchdog", trip=trip)

    def on_health_transition(self, prev: str, new: str,
                             verdict: Dict) -> None:
        """The health engine's transition callback: a CRITICAL entry
        dumps the black box (recoveries and WARNs only ring an
        event)."""
        self.note_event({"event": "health_transition", "prev": prev,
                         "verdict": new,
                         "firing": verdict.get("firing", [])})
        if new == "CRITICAL":
            self.dump("health-critical", firing=verdict.get("firing"))


def _best_effort_jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


# ---------------------------------------------------------------------------
# active-recorder registration (planes trigger without plumbing)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_ACTIVE: Optional[FlightRecorder] = None


def set_active(rec: Optional[FlightRecorder]) -> None:
    global _ACTIVE
    with _active_lock:
        _ACTIVE = rec


def active() -> Optional[FlightRecorder]:
    with _active_lock:
        return _ACTIVE


def trigger(reason: str, **extra) -> Optional[str]:
    """Dump the active recorder, if any: how code without a handle
    asks for a black-box record with one fail-soft call."""
    rec = active()
    if rec is None:
        return None
    return rec.dump(reason, **extra)
