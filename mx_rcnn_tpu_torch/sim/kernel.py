"""Discrete-event virtual-time kernel: deterministic heap + seeded RNG.

Counterpart of ``mx_rcnn_tpu/sim/kernel.py``, whole: the same events in
the same order, so a seeded run's decision log is byte-equal to the
JAX package's.

The whole simulator runs on ONE thread against this kernel; nothing in
``sim/`` ever reads a wall clock.  Events are ``(time, seq, fn)`` heap
entries — ``seq`` is a monotonic tiebreaker, so two events scheduled
for the same instant fire in scheduling order, every run, which is what
makes the decision log byte-reproducible.  Randomness comes only from
:meth:`SimKernel.rng` substreams: each named stream seeds a private
``np.random.RandomState`` from ``sha256(seed:name)``, so adding a new
consumer of randomness never perturbs the draws of existing ones (the
same trick ``ft/supervisor.py`` uses for deterministic backoff jitter).

:class:`VirtualClock` is a zero-argument callable returning the current
virtual time — exactly the shape of ``time.monotonic`` — so it plugs
straight into the clock seams of ``TimeSeriesStore``, ``HealthEngine``,
``SchedulerPolicy``, ``RestartPolicy`` and ``Collector``.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
from typing import Callable, List, Tuple

import numpy as np


class VirtualClock:
    """Monotonic virtual time as a ``time.monotonic``-shaped callable.

    Only the kernel advances it (monotonically, to each event's fire
    time); everything else just reads."""

    def __init__(self, t0: float = 0.0):
        self._now = float(t0)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now


class SimKernel:
    """Event heap + clock + named RNG substreams.

    ``at``/``after`` schedule, ``run_until`` drains.  A callback may
    schedule further events (including at the current instant — they
    fire later this drain, after everything already queued for it).
    """

    def __init__(self, seed: int = 0, t0: float = 0.0):
        self.seed = int(seed)
        self.clock = VirtualClock(t0)
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.fired = 0

    # -- randomness --------------------------------------------------------

    def rng(self, name: str) -> np.random.RandomState:
        """A private RandomState for one named consumer, derived from
        ``sha256(seed:name)`` — stable across runs and across unrelated
        code changes."""
        h = hashlib.sha256(f"{self.seed}:{name}".encode()).hexdigest()
        return np.random.RandomState(int(h[:8], 16))

    # -- scheduling --------------------------------------------------------

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at virtual time ``t`` (clamped to now — the
        past is not schedulable)."""
        heapq.heappush(self._heap,
                       (max(float(t), self.clock.now),
                        next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.now + max(float(dt), 0.0), fn)

    def __len__(self) -> int:
        return len(self._heap)

    # -- draining ----------------------------------------------------------

    def run_until(self, t_end: float) -> int:
        """Fire every event with time <= ``t_end`` in deterministic
        order, advancing the clock to each event's instant, then park
        the clock at ``t_end``.  Returns events fired this call."""
        t_end = float(t_end)
        n = 0
        while self._heap and self._heap[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._heap)
            self.clock._now = t
            fn()
            n += 1
        self.clock._now = max(self.clock._now, t_end)
        self.fired += n
        return n

    def run_until_idle(self, t_cap: float) -> int:
        """Drain until the heap empties or the next event lies past
        ``t_cap`` — the post-trace settle pass."""
        n = 0
        while self._heap and self._heap[0][0] <= t_cap:
            n += self.run_until(self._heap[0][0])
        self.fired += 0  # counted inside run_until
        return n
