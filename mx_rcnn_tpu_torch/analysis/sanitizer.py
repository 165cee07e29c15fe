"""Runtime lock sanitizer.

Counterpart of ``mx_rcnn_tpu/analysis/sanitizer.py``.  It records the
real lock-acquisition order of a live process and turns three runtime
hazards into reportable (or fatal) events:

* **order inversions** — lock B taken while holding A after some thread
  took A while holding B: the pair can deadlock under the right
  interleaving even if it never has yet;
* **hold-time budget violations** — a lock held longer than
  ``MXRCNN_LOCK_BUDGET_MS`` (the serving locks bound a few dict
  operations; a forward or a disk write under one is a latency cliff);
* **stalls** — an ``acquire`` blocked longer than
  ``MXRCNN_LOCK_STALL_S``: the watchdog thread dumps every thread's
  stack and records the trip (the flight recorder listens).

Zero cost when off: arming patches ``threading.Lock`` and
``threading.RLock`` (:func:`install`), so the package keeps calling
plain ``threading.Lock()``.  Only locks allocated from
``mx_rcnn_tpu_torch`` code are wrapped (the allocation site is checked);
torch's and the standard library's keep their raw locks.  A lock made
before arming stays raw, so the CLIs (``tools/train.py``,
``tools/serve.py``, ``tools/loadgen.py``) arm first thing, before they
import the modules that allocate locks at import (``kernels.py``'s
per-kernel locks).

Arming::

    MXRCNN_THREAD_SANITIZER=1       # record + report
    MXRCNN_THREAD_SANITIZER=strict  # raise on the inverting acquire
    MXRCNN_LOCK_BUDGET_MS=200       # hold-time budget (0 = off)
    MXRCNN_LOCK_STALL_S=30          # watchdog threshold

On exit an armed process prints one ``LOCKSAN_REPORT {json}`` line (and
``LOCKSAN_DIRTY`` after an inversion or a trip).
``threading.Condition()`` needs no patching: its default lock is
``threading.RLock()``, which resolves to the patched factory.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("mx_rcnn_tpu_torch")

# the originals, captured at import: the wrappers and the sanitizer's
# own state use raw locks (a sanitized sanitizer would recurse)
_RAW_LOCK = threading.Lock
_RAW_RLOCK = threading.RLock

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _State:
    """Process-wide sanitizer state (one instance, raw-locked)."""

    def __init__(self):
        self.lock = _RAW_LOCK()
        self.strict = False
        self.budget_ms = 0.0
        self.stall_s = 30.0
        self.installed = False
        self.locks_wrapped = 0
        # first-seen order edges: (held, acquired) -> "file:line in thread"
        self.edges: Dict[Tuple[str, str], str] = {}
        self.inversions: List[Dict] = []
        self.budget_violations: List[Dict] = []
        self.watchdog_trips: List[Dict] = []
        # in-progress blocking acquires: id -> (thread, lockname, t0)
        self.pending: Dict[int, Tuple[str, str, float]] = {}
        self.pending_seq = 0
        self.tls = threading.local()
        self.watchdog: Optional[threading.Thread] = None
        self.watchdog_stop = threading.Event()

    def held(self) -> List[str]:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h


_S = _State()

# watchdog-trip listeners: the flight recorder (obs/flightrec.py)
# registers here so a stalled lock dumps a black-box record alongside
# the stack dump.  Raw-locked (sanitizer-internal state), invoked
# OUTSIDE _S.lock and fail-soft — a listener exception must not kill
# the watchdog thread.
_trip_listeners_lock = _RAW_LOCK()
_trip_listeners: List = []


def add_trip_listener(fn) -> None:
    """Register ``fn(trip_record)`` to run on every watchdog trip."""
    with _trip_listeners_lock:
        if fn not in _trip_listeners:
            _trip_listeners.append(fn)


def remove_trip_listener(fn) -> None:
    with _trip_listeners_lock:
        if fn in _trip_listeners:
            _trip_listeners.remove(fn)


def _notify_trip(rec: Dict) -> None:
    with _trip_listeners_lock:
        listeners = list(_trip_listeners)
    for fn in listeners:
        try:
            fn(rec)
        except Exception:
            logger.exception("lock sanitizer: trip listener failed")


def _site() -> str:
    """Allocation/acquisition site: first frame outside this module and
    the threading module."""
    f = sys._getframe(2)
    skip = (__file__, threading.__file__)
    while f is not None and f.f_code.co_filename in skip:
        f = f.f_back
    if f is None:
        return "?"
    fn = f.f_code.co_filename
    rel = os.path.relpath(fn, os.path.dirname(_PKG_DIR)) \
        if fn.startswith(os.path.dirname(_PKG_DIR)) else fn
    return f"{rel}:{f.f_lineno}"


def _from_package() -> bool:
    """True when the allocating frame lives under mx_rcnn_tpu_torch
    (wrapped); torch's and the standard library's allocations stay
    raw."""
    f = sys._getframe(2)
    skip = (__file__, threading.__file__)
    while f is not None and f.f_code.co_filename in skip:
        f = f.f_back
    return f is not None and f.f_code.co_filename.startswith(
        _PKG_DIR + os.sep)


def _thread_name() -> str:
    """This thread's name, read without ``threading.current_thread()``:
    on a thread the threading module did not start (the autograd
    engine's device threads run the backward of the port's custom
    functions, K3's launch among them), that call builds a dummy
    ``Thread``, whose ``Event`` allocates and takes a lock; inside the
    accounting, under ``_S.lock``, that is a deadlock."""
    ident = threading.get_ident()
    t = threading._active.get(ident)
    return t.name if t is not None else f"native-{ident:x}"


class SanitizerError(RuntimeError):
    """Raised on an order inversion in strict mode."""


class _SanBase:
    """Shared acquire/release accounting for the Lock/RLock wrappers."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self.san_name = name
        self._acquired_at = 0.0
        self._hold_site = ""

    # -- accounting ---------------------------------------------------------

    def _before_acquire(self, blocking: bool) -> Optional[int]:
        pid = None
        if blocking:
            with _S.lock:
                _S.pending_seq += 1
                pid = _S.pending_seq
                _S.pending[pid] = (_thread_name(),
                                   self.san_name, time.monotonic())
        return pid

    def _after_acquire(self, pid: Optional[int], got: bool,
                       order_track: bool) -> None:
        if pid is not None:
            with _S.lock:
                _S.pending.pop(pid, None)
        if not got or not order_track:
            return
        held = _S.held()
        site = _site()
        inversion = None
        with _S.lock:
            # held entries are (instance id, node name): node names are
            # allocation sites (every ServeRequest._lock shares one
            # node), so instance identity is tracked apart, or a
            # same-site pair would shadow its own ordering edge
            for hid, h in held:
                if hid == id(self):
                    continue
                edge = (h, self.san_name)
                rev = (self.san_name, h)
                if rev in _S.edges and edge not in _S.edges:
                    inversion = {
                        "held": h, "acquired": self.san_name,
                        "site": site,
                        "reverse_seen_at": _S.edges[rev],
                        "thread": _thread_name(),
                    }
                    _S.inversions.append(inversion)
                _S.edges.setdefault(
                    edge, f"{site} in {_thread_name()}")
        held.append((id(self), self.san_name))
        self._acquired_at = time.monotonic()
        self._hold_site = site
        if inversion is not None:
            logger.error("lock sanitizer: ORDER INVERSION %s", inversion)
            if _S.strict:
                # undo the acquisition before raising: the caller's
                # with-block body never runs, so nothing would ever
                # release the inner lock — every other thread needing it
                # would hang instead of seeing the leg fail fast
                held.pop()
                self._strict_unwind()
                raise SanitizerError(
                    f"lock-order inversion: acquired {self.san_name!r} "
                    f"while holding {inversion['held']!r} at {site}, but "
                    f"the opposite order was taken at "
                    f"{inversion['reverse_seen_at']}")

    def _after_release(self, order_track: bool) -> None:
        if not order_track:
            return
        held = _S.held()
        for i in range(len(held) - 1, -1, -1):  # most recent acquisition
            if held[i][0] == id(self):
                del held[i]
                break
        if _S.budget_ms > 0 and self._acquired_at:
            ms = (time.monotonic() - self._acquired_at) * 1e3
            if ms > _S.budget_ms:
                rec = {"lock": self.san_name, "held_ms": round(ms, 2),
                       "budget_ms": _S.budget_ms,
                       "acquired_at": self._hold_site,
                       "thread": _thread_name()}
                with _S.lock:
                    _S.budget_violations.append(rec)
                logger.warning("lock sanitizer: hold-time budget "
                               "exceeded %s", rec)

    def _strict_unwind(self) -> None:
        """Release the just-acquired inner lock on a strict-mode raise
        (the RLock wrapper also rolls back its owner/depth)."""
        self._inner.release()

    # -- lock protocol ------------------------------------------------------

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<sanitized {type(self).__name__} {self.san_name}>"


class SanLock(_SanBase):
    """Instrumented non-reentrant lock.  Deliberately does NOT expose
    ``_is_owned``/``_release_save`` — ``threading.Condition`` then uses
    its acquire/release fallbacks, which keep the held-set accurate."""

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        pid = self._before_acquire(blocking and timeout == -1)
        got = self._inner.acquire(blocking, timeout)
        self._after_acquire(pid, got, order_track=True)
        return got

    def release(self) -> None:
        self._after_release(order_track=True)
        self._inner.release()


class SanRLock(_SanBase):
    """Instrumented reentrant lock.  Ordering is tracked on the 0→1
    depth transition only; exposes the ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` trio so ``Condition.wait`` on a
    held RLock stays correct AND tracked."""

    def __init__(self, inner, name: str):
        super().__init__(inner, name)
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        reentrant = self._owner == me
        pid = self._before_acquire(blocking and timeout == -1
                                   and not reentrant)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = me
            self._depth += 1
        self._after_acquire(pid, got, order_track=got and self._depth == 1)
        return got

    __enter__ = _SanBase.__enter__

    def _strict_unwind(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._inner.release()

    def release(self) -> None:
        if self._depth == 1:
            self._after_release(order_track=True)
            self._owner = None
        self._depth -= 1
        self._inner.release()

    # Condition support: full release/restore across a wait()
    def _release_save(self):
        self._after_release(order_track=True)
        depth, self._depth, self._owner = self._depth, 0, None
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, state):
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        self._owner = threading.get_ident()
        self._depth = depth
        self._after_acquire(None, True, order_track=True)

    def _is_owned(self):
        return self._inner._is_owned()


def _make_lock():
    inner = _RAW_LOCK()
    if not _S.installed or not _from_package():
        return inner
    with _S.lock:
        _S.locks_wrapped += 1
    return SanLock(inner, f"Lock@{_site()}")


def _make_rlock():
    inner = _RAW_RLOCK()
    if not _S.installed or not _from_package():
        return inner
    with _S.lock:
        _S.locks_wrapped += 1
    return SanRLock(inner, f"RLock@{_site()}")


# --------------------------------------------------------------------------
# watchdog
# --------------------------------------------------------------------------

def _watchdog_loop(stop: threading.Event) -> None:
    # `stop` is captured per-thread: if uninstall()'s bounded join times
    # out (e.g. the stack dump blocked on a full stderr pipe), the
    # orphan still sees ITS set event and exits when unblocked — a fresh
    # install starts a new thread with a new event, never two live loops
    reported: set = set()   # pending ids already tripped — one trip (and
    # one all-stack dump) per stalled acquire, not one per poll tick
    while not stop.wait(min(_S.stall_s / 4.0, 1.0)):
        now = time.monotonic()
        stuck = []
        with _S.lock:
            reported &= set(_S.pending)   # completed acquires forget
            for pid, (thread, lockname, t0) in _S.pending.items():
                if now - t0 > _S.stall_s and pid not in reported:
                    reported.add(pid)
                    stuck.append({"thread": thread, "lock": lockname,
                                  "waited_s": round(now - t0, 1)})
        for rec in stuck:
            with _S.lock:
                _S.watchdog_trips.append(rec)
            logger.critical(
                "lock sanitizer WATCHDOG: %s blocked %.0fs acquiring %s "
                "— dumping all stacks", rec["thread"], rec["waited_s"],
                rec["lock"])
            try:
                faulthandler.dump_traceback(file=sys.stderr)
            except Exception:
                for tid, frame in sys._current_frames().items():
                    print(f"--- thread {tid} ---", file=sys.stderr)
                    traceback.print_stack(frame, file=sys.stderr)
            _notify_trip(rec)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def install(strict: bool = False, budget_ms: float = 0.0,
            stall_s: float = 30.0) -> None:
    """Arm the sanitizer: patch ``threading.Lock``/``threading.RLock``
    so every lock subsequently allocated from package code is
    instrumented, and start the stall watchdog.  Idempotent."""
    _S.strict = strict
    _S.budget_ms = float(budget_ms)
    _S.stall_s = float(stall_s)
    if _S.installed:
        return   # knobs refreshed above; factories already patched
    _S.installed = True
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    _S.watchdog_stop = threading.Event()
    _S.watchdog = threading.Thread(target=_watchdog_loop,
                                   args=(_S.watchdog_stop,),
                                   name="locksan-watchdog", daemon=True)
    _S.watchdog.start()
    logger.info("lock sanitizer armed (strict=%s budget_ms=%s stall_s=%s)",
                strict, budget_ms, stall_s)


def uninstall() -> None:
    """Restore the raw factories (tests).  Already-wrapped locks stay
    wrapped — only future allocations revert."""
    threading.Lock = _RAW_LOCK
    threading.RLock = _RAW_RLOCK
    _S.installed = False
    try:
        atexit.unregister(_report_at_exit)
    except Exception:
        pass
    _S.watchdog_stop.set()
    if _S.watchdog is not None:
        _S.watchdog.join(timeout=2.0)
    _S.watchdog = None


def reset() -> None:
    """Drop recorded edges/events (tests; keeps the armed state)."""
    with _S.lock:
        _S.edges.clear()
        _S.inversions.clear()
        _S.budget_violations.clear()
        _S.watchdog_trips.clear()
        _S.pending.clear()


def armed() -> bool:
    return _S.installed


def report() -> Dict:
    with _S.lock:
        return {
            "armed": _S.installed,
            "strict": _S.strict,
            "locks_wrapped": _S.locks_wrapped,
            "order_edges": len(_S.edges),
            "inversions": list(_S.inversions),
            "budget_violations": list(_S.budget_violations),
            "watchdog_trips": list(_S.watchdog_trips),
        }


def check_clean() -> bool:
    """True iff no inversion and no watchdog trip was recorded (budget
    violations are advisory — reported, not fatal)."""
    with _S.lock:
        return not _S.inversions and not _S.watchdog_trips


def check_problems() -> List[str]:
    """``--check`` integration for the smoke CLIs: human-readable
    problem strings when the sanitizer is armed and dirty; empty when
    clean or not armed (budget violations are advisory)."""
    if not _S.installed:
        return []
    rep = report()
    out: List[str] = []
    if rep["inversions"]:
        out.append(f"lock sanitizer recorded "
                   f"{len(rep['inversions'])} order inversion(s): "
                   f"{rep['inversions'][:3]}")
    if rep["watchdog_trips"]:
        out.append(f"lock sanitizer watchdog tripped "
                   f"{len(rep['watchdog_trips'])} time(s): "
                   f"{rep['watchdog_trips'][:3]}")
    return out


def maybe_install_from_env() -> bool:
    """CLI hook: arm from ``MXRCNN_THREAD_SANITIZER`` (off/1/strict) and
    register the exit-line reporter.  Returns the armed state."""
    mode = os.environ.get("MXRCNN_THREAD_SANITIZER", "").strip().lower()
    if mode in ("", "0", "off", "false"):
        return False
    budget = float(os.environ.get("MXRCNN_LOCK_BUDGET_MS", "0") or 0)
    stall = float(os.environ.get("MXRCNN_LOCK_STALL_S", "30") or 30)
    install(strict=mode == "strict", budget_ms=budget, stall_s=stall)
    # one report line however many CLIs of one process arm it
    atexit.unregister(_report_at_exit)
    atexit.register(_report_at_exit)
    return True


def _report_at_exit() -> None:
    rep = report()
    print("LOCKSAN_REPORT " + json.dumps(rep), flush=True)
    if not check_clean():
        # atexit cannot change the exit code reliably; the --check modes
        # and the smoke drivers grep for this marker
        print("LOCKSAN_DIRTY", flush=True)
