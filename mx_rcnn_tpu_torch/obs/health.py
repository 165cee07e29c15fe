"""Declarative SLO rules over the time-series windows.

Counterpart of ``mx_rcnn_tpu/obs/health.py``: declarative rules over
``obs/timeseries.py`` windows, a machine-readable verdict, and the exit
codes of the verdicts.  A :class:`Rule` names a query (``kind`` picks
the store readout), a comparison and a severity::

    Rule("serve-p99", metric="serve.total_ms", kind="p99",
         op=">", threshold=1800.0, window_s=30, severity="critical")

Kinds: ``gauge`` (latest value in the window), ``gauge_min``/``gauge_max``
(window scan), ``rate``/``delta`` (counter windows), ``p99``/``p50``
(windowed histogram percentiles), ``ratio`` (``metric="a/b"``, the
windowed ratio of two counter deltas, e.g. the shed fraction).  A
metric the window never saw is no breach (``missing_ok``): the rules
describe subsystems that may be off, and absence judged as failure
would make every partial deployment CRITICAL.

Hysteresis is per rule: ``for_samples`` consecutive breaching
evaluations fire it (one slow scrape never flaps the verdict),
``clear_samples`` consecutive clean ones clear it.

Each evaluation publishes the verdict as gauges (``health.verdict``
0/1/2, ``health.rule.<name>`` 0/1), appends a ``health_transition`` run
record event on each change and calls the transition callback, which
``CliObs`` points at the flight recorder: a CRITICAL transition dumps
the black box.  The active engine (:func:`set_active_engine`) adds its
verdict to ``/healthz`` on both HTTP front ends.

Verdict → exit code: OK=0, WARN=1, CRITICAL=2 (:data:`EXIT_BY_VERDICT`).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore

logger = logging.getLogger("mx_rcnn_tpu_torch")

OK, WARN, CRITICAL = "OK", "WARN", "CRITICAL"
_LEVEL = {OK: 0, WARN: 1, CRITICAL: 2}
EXIT_BY_VERDICT = dict(_LEVEL)

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclass(frozen=True)
class Rule:
    """One SLO: fire ``severity`` when ``<kind>(metric, window_s) <op>
    threshold`` holds for ``for_samples`` consecutive evaluations."""

    name: str
    metric: str           # for kind="ratio": "numerator/denominator"
    kind: str             # gauge|gauge_min|gauge_max|rate|delta|p99|p50|ratio
    op: str               # > >= < <=
    threshold: float
    window_s: float = 30.0
    severity: str = WARN  # WARN or CRITICAL when firing
    for_samples: int = 2  # consecutive breaches to fire (hysteresis)
    clear_samples: int = 2  # consecutive cleans to clear
    missing_ok: bool = True  # absent metric = no judgment, not a breach

    def value(self, store: TimeSeriesStore) -> Optional[float]:
        k = self.kind
        if k == "gauge":
            # Bounded by the rule's window: a gauge whose source died
            # longer than window_s ago reads None (absent), the same
            # judgment as a source that never reported at all.  The
            # unbounded scan used to return the dead source's stale
            # last value forever — a down host read as healthy.
            return store.gauge(self.metric, self.window_s)
        if k == "gauge_min":
            return store.gauge_min(self.metric, self.window_s)
        if k == "gauge_max":
            return store.gauge_max(self.metric, self.window_s)
        if k == "rate":
            return store.rate(self.metric, self.window_s)
        if k == "delta":
            return store.delta(self.metric, self.window_s)
        if k in ("p99", "p50"):
            return store.pctl(self.metric, float(k[1:]), self.window_s)
        if k == "ratio":
            num, den = self.metric.split("/", 1)
            dn = store.delta(num.strip(), self.window_s)
            dd = store.delta(den.strip(), self.window_s)
            if dn is None or dd is None or dd <= 0:
                return None
            return dn / dd
        raise ValueError(f"unknown rule kind {k!r}")


class _RuleState:
    __slots__ = ("breaches", "cleans", "firing")

    def __init__(self):
        self.breaches = 0
        self.cleans = 0
        self.firing = False


class HealthEngine:
    """Evaluate the rule set against a store; publish + notify.

    Driven by the sampler thread (``Sampler(after_sample=engine.
    evaluate_sample)``) or explicitly (:meth:`evaluate`).  All rule
    state lives under one lock; the transition callback and the run
    record's write run outside it (they do I/O).
    """

    def __init__(self, rules: List[Rule], store: TimeSeriesStore,
                 registry=None, record=None,
                 on_transition: Optional[Callable[[str, str, Dict],
                                                  None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rules = list(rules)
        self.store = store
        self._reg = registry
        self._record = record
        self._on_transition = on_transition
        # stamps every verdict; monotonic unless a test gives a clock
        self._clock = clock
        self._lock = threading.Lock()
        self._state = {r.name: _RuleState() for r in self.rules}
        self._verdict = OK
        self._last: Optional[Dict] = None

    # ------------------------------------------------------------------

    def evaluate(self) -> Dict:
        """One pass over every rule; returns (and retains) the verdict
        document.  Never raises: a rule whose query blows up reads as
        value None (missing), logged once per pass."""
        rule_out: List[Dict] = []
        fired: List[str] = []
        worst = OK
        with self._lock:
            for r in self.rules:
                try:
                    v = r.value(self.store)
                except Exception:
                    logger.exception("obs health: rule %s query failed",
                                     r.name)
                    v = None
                st = self._state[r.name]
                if v is None:
                    # absent metric: hold state, judge nothing
                    breach = None
                else:
                    breach = _OPS[r.op](float(v), r.threshold)
                    if breach:
                        st.breaches += 1
                        st.cleans = 0
                        if st.breaches >= r.for_samples:
                            st.firing = True
                    else:
                        st.cleans += 1
                        st.breaches = 0
                        if st.cleans >= r.clear_samples:
                            st.firing = False
                if st.firing:
                    fired.append(r.name)
                    if _LEVEL[r.severity] > _LEVEL[worst]:
                        worst = r.severity
                rule_out.append({
                    "name": r.name, "metric": r.metric, "kind": r.kind,
                    "op": r.op, "threshold": r.threshold,
                    "window_s": r.window_s, "severity": r.severity,
                    "value": None if v is None else round(float(v), 4),
                    "breaching": breach, "firing": st.firing,
                })
            prev = self._verdict
            self._verdict = worst
            verdict = {"verdict": worst, "code": _LEVEL[worst],
                       "previous": prev, "changed": worst != prev,
                       "ts": round(float(self._clock()), 6),
                       "firing": fired, "rules": rule_out}
            self._last = verdict
        self._publish(verdict)
        if verdict["changed"]:
            self._notify(prev, worst, verdict)
        return verdict

    def evaluate_sample(self, _sample: Dict) -> None:
        """``Sampler(after_sample=...)`` adapter."""
        self.evaluate()

    # ------------------------------------------------------------------

    def _publish(self, verdict: Dict) -> None:
        if self._reg is None:
            return
        try:
            self._reg.set_gauge("health.verdict", verdict["code"])
            for r in verdict["rules"]:
                self._reg.set_gauge(f"health.rule.{r['name']}",
                                    1.0 if r["firing"] else 0.0)
        except Exception:
            logger.exception("obs health: gauge publish failed")

    def _notify(self, prev: str, new: str, verdict: Dict) -> None:
        logger.log(logging.WARNING if _LEVEL[new] else logging.INFO,
                   "health verdict %s -> %s (firing: %s)", prev, new,
                   ",".join(verdict["firing"]) or "-")
        if self._record is not None:
            try:
                self._record.event("health_transition", prev=prev,
                                   verdict=new, firing=verdict["firing"])
            except Exception:
                logger.exception("obs health: transition event failed")
        if self._on_transition is not None:
            try:
                self._on_transition(prev, new, verdict)
            except Exception:
                logger.exception("obs health: transition callback "
                                 "failed")

    # ------------------------------------------------------------------

    @property
    def verdict(self) -> str:
        with self._lock:
            return self._verdict

    def last(self) -> Optional[Dict]:
        """The most recent verdict document (None before the first
        evaluation) — the ``/healthz`` enrichment body."""
        with self._lock:
            return self._last

    def exit_code(self) -> int:
        return _LEVEL[self.verdict]


def default_rules(cfg) -> List[Rule]:
    """The stock SLO set over the gauges the planes export, thresholds
    from the run's config; the JAX package's rules, in its order.  Every
    rule is ``missing_ok``: a training run never resolves the serving
    rules, and the fleet, elastic and skew rules wait for planes the
    port has not ported (they read the JAX package's default of one
    fleet replica)."""
    deadline = cfg.serve.default_timeout_ms or 2000.0
    w = cfg.obs.health_window_s
    fleet = getattr(cfg, "fleet", None)
    replicas = fleet.replicas if fleet is not None else 1
    return [
        # p99 at 90% of the request deadline: the tail is about to expire
        Rule("serve-p99-budget", "serve.total_ms", "p99", ">",
             0.9 * deadline, window_s=w, severity=CRITICAL),
        # sustained shedding is capacity, not noise
        Rule("serve-shed-frac", "serve.shed/serve.submitted", "ratio",
             ">", 0.05, window_s=w, severity=WARN),
        # fewer ready replicas than configured; a state readout, so one
        # sample fires and clears it
        Rule("fleet-degraded", "fleet.replicas_ready", "gauge", "<",
             float(replicas), window_s=15.0,
             severity=CRITICAL, for_samples=1, clear_samples=1),
        # resumes should land within the snapshot cadence
        Rule("elastic-recovery", "elastic.recovery_ms", "p99", ">",
             60_000.0, window_s=300.0, severity=WARN),
        # waiting on data more than half the step: the loader sets the pace
        Rule("train-data-wait", "train.data_wait_frac", "gauge", ">",
             0.5, window_s=60.0, severity=WARN),
        # the snapshotter should never hold the step loop for long
        Rule("snapshot-stall", "snapshot.stall_ms", "p99", ">",
             1000.0, window_s=120.0, severity=WARN),
        # past the alarm bound, merged cross-host timelines are estimates
        Rule("trace-skew-drift", "obs.skew_ms.max", "gauge_max", ">",
             float(cfg.obs.skew_alarm_ms), window_s=w, severity=WARN),
    ]


# ---------------------------------------------------------------------------
# active-engine registration (the /healthz enrichment hook)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_ACTIVE: Optional[HealthEngine] = None


def set_active_engine(engine: Optional[HealthEngine]) -> None:
    global _ACTIVE
    with _active_lock:
        _ACTIVE = engine


def active_engine() -> Optional[HealthEngine]:
    with _active_lock:
        return _ACTIVE


def active_verdict() -> Optional[Dict]:
    """The current verdict document, if a health engine is live in this
    process — what ``serve/server.py`` and the ``/metrics`` exporter
    attach to ``/healthz``."""
    eng = active_engine()
    return None if eng is None else eng.last()
