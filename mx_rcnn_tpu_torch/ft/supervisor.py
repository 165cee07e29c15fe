"""Restart pacing and the crash-loop verdict.

Counterpart of ``mx_rcnn_tpu/ft/supervisor.py — RestartPolicy``, the one
part of that module the serving fleet (``serve/fleet.py``) needs: it
paces each dead replica's relaunch and stops a replica that dies the
same way every time.  The rest of the JAX module, the training
supervisor (``run_crashloop``, ``run_elastic_storm``, ``_Worker``, the
kill schedules and ``measure_snapshot_overhead``), comes with the rest
of ``ft/`` (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Optional, Tuple

logger = logging.getLogger("mx_rcnn_tpu_torch")


class RestartPolicy:
    """Backoff between restarts, and a verdict on a crash loop.

    Consecutive failures without progress back off exponentially
    (``base_s * factor^(n-1)``, capped at ``cap_s``) with a jitter that
    is a pure function of ``(seed, n)`` (sha256), so a schedule is
    reproducible and supervisors with different seeds do not restart in
    step.  ``give_up_after`` consecutive IDENTICAL failures (same
    signature) return ``give_up``: a run that dies the same way every
    time is a bug, not a transient, and restarting it only burns
    capacity.  Progress resets the schedule.

    The gauges ``ft.supervisor.backoff_s``,
    ``ft.supervisor.consecutive_failures`` and ``ft.supervisor.crash_loop``
    go to ``registry`` (the process registry unless one is given; the
    fleet gives each replica a private one).  ``clock`` stamps
    ``ready_at``, the earliest restart instant.  One RLock guards the
    counts: the fleet's health monitor and its relaunch threads record
    on the same policy.
    """

    def __init__(self, base_s: float = 0.25, factor: float = 2.0,
                 cap_s: float = 30.0, jitter_frac: float = 0.25,
                 give_up_after: int = 4, seed: int = 0, registry=None,
                 clock=time.monotonic):
        self.base_s = base_s
        self.factor = factor
        self.cap_s = cap_s
        self.jitter_frac = jitter_frac
        self.give_up_after = give_up_after
        self.seed = seed
        self._clock = clock
        self.ready_at: float = float("-inf")
        self.failures = 0          # consecutive failures without progress
        self.identical = 0         # consecutive identical failures
        self._last_sig: Optional[tuple] = None
        # reentrant: delay_s is called from inside record
        self._lock = threading.RLock()
        if registry is None:
            from mx_rcnn_tpu_torch.obs.metrics import registry as _registry

            registry = _registry()
        self._rec = registry

    def delay_s(self, n_failures: Optional[int] = None) -> float:
        """The backoff before restart attempt ``n_failures`` (1-based;
        the current count by default); 0.0 while there is progress."""
        with self._lock:
            n = self.failures if n_failures is None else n_failures
        if n <= 0:
            return 0.0
        try:
            d = min(self.base_s * self.factor ** (n - 1), self.cap_s)
        except OverflowError:  # past ~1000 failures the power leaves float
            d = self.cap_s
        # jitter in [-jitter_frac, +jitter_frac], the same for (seed, n)
        h = int(hashlib.sha256(f"{self.seed}:{n}".encode()).hexdigest(),
                16) % 10_000
        return d * (1.0 + self.jitter_frac * (h / 5_000.0 - 1.0))

    def record(self, signature: tuple, made_progress: bool
               ) -> Tuple[float, bool]:
        """Record one attempt's outcome; returns ``(delay_s, give_up)``.
        ``signature`` names the failure mode; ``made_progress`` resets
        the schedule."""
        with self._lock:
            if made_progress:
                self.failures = 0
                self.identical = 0
                self._last_sig = None
            else:
                self.failures += 1
                self.identical = (self.identical + 1
                                  if signature == self._last_sig else 1)
                self._last_sig = signature
            give_up = self.identical >= self.give_up_after
            delay = self.delay_s()
            self.ready_at = self._clock() + delay
            failures, identical = self.failures, self.identical
        self._rec.set_gauge("ft.supervisor.backoff_s", delay)
        self._rec.set_gauge("ft.supervisor.consecutive_failures", failures)
        self._rec.set_gauge("ft.supervisor.crash_loop", int(give_up))
        if give_up:
            logger.error(
                "crash-loop verdict: %d consecutive identical failures "
                "(%r): a deterministic fault, not a transient; refusing to "
                "restart", identical, signature)
        return delay, give_up
