"""The rollout plane: versioned rolling updates, a canary lane with an
online paired gate, and rollback as one verb.

Counterpart of ``mx_rcnn_tpu/serve/rollout.py``, whole.  A fleet that
binds one model for its whole life changes it only by restarting; this
module rolls a new version through a live fleet out of pieces the port
already has:

* **lineage**: an export store records ``version``, ``parent_sha`` and
  ``train_fingerprint`` (``serve/export.py — ExportStore.check_lineage``):
  an unknown parent or a fingerprint mismatch is refused before a
  replica builds;
* **side by side**: an agent pulls the new version's store once
  (``serve/agent.py — ReplicaAgent.rollout_pull``) and holds replicas of
  both versions, each replica tagged with its version
  (``serve/fleet.py — Replica.version``);
* **the canary lane**: the router sends a deterministic share of traffic
  to the canary version (``FleetRouter.set_canary``) and counts each
  version's requests (``fleet.ver.<label>.*``) for the health engine
  (:func:`rollout_rules`), while an :class:`OnlinePairedGate` scores the
  same canvas on both arms and refuses a damaged version with
  :func:`paired_stats`, the CI-inside-+-budget equivalence test;
* **the rolling update**: :class:`RolloutController` drives pull →
  canary → per-host swaps, one replica at a time through the fleet's
  graceful drain, with a timeout a step, so a host killed mid-rollout
  is deferred and brought back in FINALIZE;
* **rollback**: one actuation (``RolloutController.rollback``, also the
  scheduler's verb ``FleetScheduler.rollback``) returns every host to
  the boot version, and a second one is a recorded no-op.

The controller drives the fleet through a small port, so the same
decisions run live (:class:`AgentRolloutPort`, the agents' ``POST
/rollout``) and over simulated hosts in virtual time
(``sim/control.py — SimRolloutPort``)::

    port.sources()                 -> ordered host names
    port.pull(source, url, ver)    -> stats dict | None (host down)
    port.versions(source)          -> {version_label: ready_count} | None
    port.swap_next(source, ver)    -> progress dict | None
    port.rollback(source)          -> progress dict | None
    port.set_canary(ver, fraction) -> None
    port.shadow_pair()             -> (score_v1, score_v2) | None  [opt]

Every decision follows from the port and the injected clock, so under
the simulator the decision log is byte-reproducible, and equal to the
JAX package's.  ``version_label`` is ``serve/fleet.py``'s, re-exported
here where the JAX package defines it.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch.obs.health import CRITICAL, Rule
from mx_rcnn_tpu_torch.obs.trace import correlation_id
from mx_rcnn_tpu_torch.serve.fleet import version_label  # noqa: F401

# rollout phases (the controller's whole state machine)
IDLE = "idle"
PULLING = "pulling"
CANARY = "canary"
ROLLING = "rolling"
FINALIZE = "finalize"
DONE = "done"
ROLLING_BACK = "rolling_back"
ROLLED_BACK = "rolled_back"
_TERMINAL = (DONE, ROLLED_BACK)

# two-sided 97.5% Student-t quantiles, df 1..30 (NIST tables); scipy is
# not a dependency.  df > 30 falls back to the df=30 value — slightly
# WIDER than the true quantile, so the equivalence gate errs
# conservative.  The JAX package's offline accuracy gauntlet
# (tools/gauntlet.py, not ported yet) judges with the same table.
T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571,
        6: 2.447, 7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228,
        11: 2.201, 12: 2.179, 13: 2.160, 14: 2.145, 15: 2.131,
        16: 2.120, 17: 2.110, 18: 2.101, 19: 2.093, 20: 2.086,
        21: 2.080, 22: 2.074, 23: 2.069, 24: 2.064, 25: 2.060,
        26: 2.056, 27: 2.052, 28: 2.048, 29: 2.045, 30: 2.042}


def paired_stats(deltas: Sequence[float], budget: float) -> Dict:
    """The paired-equivalence judgment the online canary gate makes
    (the JAX package's offline accuracy gauntlet, ``tools/gauntlet.py
    paired_compare``, makes the same one):

    * mean delta with a 95% Student-t CI (df = n−1),
    * a two-sided exact binomial sign test p-value (zeros dropped),
    * ``within_budget``: whether the CI lies inside ±``budget`` — the
      equivalence gate (CI-inside-bounds, i.e. TOST-style, NOT a mere
      failure-to-reject).

    One delta proves nothing: ``ci95`` is None and ``within_budget``
    False until n ≥ 2 (and json has no Infinity to say otherwise).
    """
    deltas = [float(d) for d in deltas]
    n = len(deltas)
    mean = float(np.mean(deltas)) if n else 0.0
    if n >= 2:
        sem = float(np.std(deltas, ddof=1)) / math.sqrt(n)
        t = T975.get(n - 1, T975[30])
        ci: Optional[Tuple[float, float]] = (mean - t * sem, mean + t * sem)
    else:
        ci = None
    pos = sum(d > 0 for d in deltas)
    neg = sum(d < 0 for d in deltas)
    m = pos + neg
    # two-sided exact binomial sign test, p = P(#pos as or more extreme)
    if m:
        k = min(pos, neg)
        tail = sum(math.comb(m, i) for i in range(k + 1)) / 2.0 ** m
        sign_p = min(1.0, 2.0 * tail)
    else:
        sign_p = 1.0
    return {
        "n": n,
        "mean_delta": round(mean, 4),
        "ci95": [round(ci[0], 4), round(ci[1], 4)] if ci else None,
        "sign_test_p": round(sign_p, 4),
        "budget": budget,
        "within_budget": bool(ci is not None and -budget <= ci[0]
                              and ci[1] <= budget),
    }


def detection_score(dets) -> float:
    """Scalar shadow-score of one detection result: total confidence
    normalized by (1 + count).  Deliberately sensitive to BOTH failure
    axes a damaged model shows — confidence collapse (garbage weights
    drop the numerator) and box-count explosion (a broken NMS inflates
    the denominator) — while identical arms score identically, so a
    healthy no-op v2's paired deltas are exactly zero."""
    arrays = dets.values() if isinstance(dets, dict) else dets
    total, count = 0.0, 0
    for a in arrays:
        a = np.asarray(a, dtype=np.float64)
        if a.size == 0:
            continue
        if a.ndim == 1:
            a = a[None, :]
        total += float(a[:, -1].sum())
        count += int(a.shape[0])
    return total / (1.0 + count)


class OnlinePairedGate:
    """The canary gate: paired shadow-scores of the SAME input on both
    arms, judged by :func:`paired_stats` once ``min_pairs`` have
    accumulated.  ``refused`` means judged and NOT within ±budget.
    Thread-safe: live shadow samplers add pairs from worker threads
    while the controller reads verdicts."""

    def __init__(self, budget: float = 0.02, min_pairs: int = 12):
        self.budget = float(budget)
        self.min_pairs = int(min_pairs)
        self._lock = threading.Lock()
        self._deltas: List[float] = []

    def add_pair(self, score_base: float, score_canary: float) -> None:
        # delta = (new arm − old arm),
        # so a damaged canary drives the mean NEGATIVE
        with self._lock:
            self._deltas.append(float(score_canary) - float(score_base))

    def pairs(self) -> int:
        with self._lock:
            return len(self._deltas)

    def verdict(self) -> Dict:
        with self._lock:
            deltas = list(self._deltas)
        st = paired_stats(deltas, self.budget)
        judged = st["n"] >= self.min_pairs
        return {**st, "pairs": st["n"], "min_pairs": self.min_pairs,
                "judged": judged,
                "refused": bool(judged and not st["within_budget"])}


def rollout_rules(cfg, version: str) -> List[Rule]:
    """Per-version SLO rules for the REAL ``HealthEngine`` during a
    canary: the canary lane's p99 against the request-deadline budget
    and its failure fraction.  Same missing_ok semantics as the stock
    set — before any canary traffic lands, the rules judge nothing."""
    label = version_label(version)
    deadline = cfg.serve.default_timeout_ms or 2000.0
    w = cfg.obs.health_window_s
    return [
        Rule(f"canary-{label}-p99", f"fleet.ver.{label}.total_ms", "p99",
             ">", 0.9 * deadline, window_s=w, severity=CRITICAL),
        Rule(f"canary-{label}-failfrac",
             f"fleet.ver.{label}.failed/fleet.ver.{label}.dispatched",
             "ratio", ">", 0.02, window_s=w, severity=CRITICAL),
    ]


class RolloutController:
    """Drives one v1→v2 rollout over a fleet port (module docstring has
    the port protocol).  Pump-style: :meth:`step` advances the state
    machine one decision at a time and is safe to call from a wall-clock
    loop (:meth:`run`), a scheduler tick, or the simulator's virtual
    clock — the controller itself never sleeps and never reads the wall
    clock except through the injected ``clock``.

    Decision log: every transition and actuation appends a plain dict to
    ``self.events`` (and echoes through the ``log`` callable) — under
    the sim's virtual clock the log is byte-reproducible and scored by
    the sim gauntlet (``tools/sim.py``).
    """

    def __init__(self, port, cfg, *, version: str, store_url: str = "",
                 gate: OnlinePairedGate = None, health=None,
                 clock: Callable[[], float] = time.monotonic,
                 log: Callable[..., None] = None, record=None):
        self.port = port
        self.cfg = cfg
        self.version = version
        self.store_url = store_url
        self.gate = gate or OnlinePairedGate(
            budget=cfg.rollout.gate_budget,
            min_pairs=cfg.rollout.gate_min_pairs)
        self.health = health          # optional HealthEngine
        self.phase = IDLE
        self.events: List[Dict] = []
        self._clock = clock
        self._log_fn = log
        self._record = record
        self._lock = threading.RLock()
        self._pulled: set = set()
        self._deferred: set = set()   # hosts that timed out a step
        self._pull_started: Dict[str, float] = {}
        self._roll_order: List[str] = []
        self._roll_idx = 0
        self._active: Dict[str, float] = {}  # rolling host -> deadline
        self._canary_hosts: List[str] = []
        self._finalize_started: Optional[float] = None
        self._canary_since: Optional[float] = None
        self._canary_ticks = 0
        self._rollback_reason: Optional[str] = None
        self._rollback_started: Optional[float] = None
        self.rollback_s: Optional[float] = None

    # ------------------------------------------------------------------

    def _corr(self) -> str:
        """Correlation id of the health-sample window this decision
        reacted to: the attached HealthEngine's latest verdict stamp
        when one exists (linking gate refusals / health rollbacks to
        the triggering window), else the controller's own clock.  Both
        are the injected clock under the simulator, so sim decision
        logs stay byte-reproducible."""
        ts = None
        if self.health is not None:
            try:
                last = self.health.last()
                if last:
                    ts = last.get("ts")
            except Exception:
                ts = None
        if ts is None:
            ts = float(self._clock())
        return correlation_id(ts)

    def _log(self, kind: str, **kw) -> None:
        ev = {"kind": kind, "t": round(float(self._clock()), 3),
              "phase": self.phase, "corr": self._corr(), **kw}
        self.events.append(ev)
        if self._log_fn is not None:
            self._log_fn(kind, **{k: v for k, v in ev.items()
                                  if k != "kind"})
        if self._record is not None:
            try:
                self._record.event(f"rollout_{kind}", corr=ev["corr"],
                                   **kw)
            except Exception:
                pass

    def start(self) -> None:
        with self._lock:
            if self.phase != IDLE:
                return
            self.phase = PULLING
            self._log("start", version=self.version,
                      canary_fraction=self.cfg.rollout.canary_fraction)

    # ------------------------------------------------------------------
    # phase handlers (all called under the lock from step())
    # ------------------------------------------------------------------

    def _step_pulling(self, now: float) -> None:
        rc = self.cfg.rollout
        remaining = []
        for source in sorted(self.port.sources()):
            if source in self._pulled or source in self._deferred:
                continue
            self._pull_started.setdefault(source, now)
            res = self.port.pull(source, self.store_url, self.version)
            if res is not None:
                self._pulled.add(source)
                self._log("pulled", source=source,
                          already=bool(res.get("already")))
            elif now - self._pull_started[source] >= rc.step_timeout_s:
                # a host that cannot pull does not block the fleet —
                # FINALIZE re-converges it if it comes back
                self._deferred.add(source)
                self._log("pull_deferred", source=source)
            else:
                remaining.append(source)
        if not remaining:
            self.phase = CANARY
            self._canary_since = now
            # the canary arm needs capacity before the lane opens: the
            # first ``wave`` pulled hosts each warm ONE canary replica
            # (their swap pumps stop there until ROLLING)
            self._canary_hosts = sorted(self._pulled)[
                :max(int(rc.wave), 1)]
            self.port.set_canary(self.version, rc.canary_fraction)
            self._log("canary_open", fraction=rc.canary_fraction,
                      hosts=self._canary_hosts,
                      pulled=len(self._pulled),
                      deferred=sorted(self._deferred))

    def _pump_canary_capacity(self) -> None:
        """Idempotently nudge each canary host until it holds at least
        one READY canary replica; never push past that (the drain half
        of the swap waits for ROLLING)."""
        lbl = version_label(self.version)
        for source in self._canary_hosts:
            versions = self.port.versions(source)
            if versions is None:
                continue
            if {version_label(k): v
                    for k, v in versions.items()}.get(lbl, 0) >= 1:
                continue
            self.port.swap_next(source, self.version)

    def _step_canary(self, now: float) -> None:
        rc = self.cfg.rollout
        self._canary_ticks += 1
        self._pump_canary_capacity()
        if (hasattr(self.port, "shadow_pair")
                and self._canary_ticks % max(1, rc.gate_sample_every) == 0):
            pair = self.port.shadow_pair()
            if pair is not None:
                self.gate.add_pair(pair[0], pair[1])
        if self.health is not None and self.health.verdict == CRITICAL:
            self.rollback("health_critical")
            return
        v = self.gate.verdict()
        if v["judged"] and v["refused"]:
            self._log("gate_refused", **{k: v[k] for k in
                                         ("pairs", "mean_delta", "ci95",
                                          "sign_test_p", "within_budget")})
            self.rollback("gate_refused")
            return
        if v["judged"] and now - self._canary_since >= rc.bake_s:
            self._log("gate_passed", **{k: v[k] for k in
                                        ("pairs", "mean_delta", "ci95",
                                         "sign_test_p", "within_budget")})
            # close the lane: rolling routing is version-blind JSQ, so
            # traffic follows capacity as the waves swap hosts (a lane
            # pinned mostly to v1 would starve the growing v2 pool and
            # overload the shrinking v1 one)
            self.port.set_canary(None, 0.0)
            self.phase = ROLLING
            self._roll_order = sorted(self.port.sources())
            self._roll_idx = 0
            self._active = {}

    def _step_rolling(self, now: float) -> None:
        rc = self.cfg.rollout
        wave = max(int(rc.wave), 1)
        # admit hosts into the rolling window, wave at a time
        while len(self._active) < wave and self._roll_idx < len(self._roll_order):
            source = self._roll_order[self._roll_idx]
            self._roll_idx += 1
            if source in self._deferred:
                continue
            self._active[source] = now + rc.step_timeout_s
            self._log("host_rolling", source=source)
        for source in sorted(self._active):
            res = self.port.swap_next(source, self.version)
            if res is None:
                if now >= self._active[source]:
                    # host stopped answering mid-swap (SIGKILL arm):
                    # defer, FINALIZE re-converges if it returns
                    self._deferred.add(source)
                    self._log("host_deferred", source=source)
                    del self._active[source]
                continue  # retry this host next tick
            if res.get("remaining", 0) <= 0 and not res.get("pending"):
                self._log("host_rolled", source=source)
                del self._active[source]
                continue
            # progress (added/swapped) refreshes the host's step deadline;
            # a pending warm/drain just waits it out
            if res.get("swapped") is not None or res.get("added") is not None:
                self._active[source] = now + rc.step_timeout_s
        if not self._active and self._roll_idx >= len(self._roll_order):
            self.phase = FINALIZE
            self._log("finalize_start", deferred=sorted(self._deferred))

    def _host_consistent(self, versions: Dict, want: str) -> bool:
        """All ready capacity on ``want`` and at least one replica."""
        lbl = version_label(want)
        ready = {version_label(k): v for k, v in versions.items() if v}
        return ready.get(lbl, 0) >= 1 and set(ready) == {lbl}

    def _step_finalize(self, now: float) -> None:
        if self._finalize_started is None:
            self._finalize_started = now
        inconsistent, down = [], []
        for source in sorted(self.port.sources()):
            versions = self.port.versions(source)
            if versions is None:
                down.append(source)
                continue
            if self._host_consistent(versions, self.version):
                continue
            inconsistent.append(source)
            # re-converge: a deferred/relaunched host needs the pull
            # (idempotent — the agent pulls a version ONCE) then swaps
            res = self.port.pull(source, self.store_url, self.version)
            if res is not None:
                self._deferred.discard(source)
                self.port.swap_next(source, self.version)
        if inconsistent:
            return
        if down:
            # a host killed mid-rollout gets one step-timeout of grace
            # to relaunch and be re-converged; past that it is recorded
            # as abandoned (an operator problem, not a hung rollout)
            if now - self._finalize_started < self.cfg.rollout.step_timeout_s:
                return
            self._log("finalize_abandoned", sources=down)
        self.port.set_canary(None, 0.0)
        self.phase = DONE
        self._log("done", version=self.version)

    def _step_rolling_back(self, now: float) -> None:
        pending = []
        for source in sorted(self.port.sources()):
            versions = self.port.versions(source)
            if versions is None:
                continue  # down hosts relaunch on v1 — consistent
            if self._host_consistent(versions, None):
                continue  # boot-only already; anything else (canary
                # replicas, hosts that COMPLETED a swap before the
                # refusal, mixed mid-roll hosts) pumps back to boot
            res = self.port.rollback(source)
            if res is not None and res.get("remaining", 0) > 0:
                pending.append(source)
            elif res is None:
                pending.append(source)
        if not pending:
            self.phase = ROLLED_BACK
            self.rollback_s = round(now - self._rollback_started, 3)
            self._log("rolled_back", reason=self._rollback_reason,
                      rollback_s=self.rollback_s)

    # ------------------------------------------------------------------

    def step(self) -> str:
        """One decision tick; returns the (possibly new) phase."""
        with self._lock:
            now = float(self._clock())
            if self.phase == PULLING:
                self._step_pulling(now)
            elif self.phase == CANARY:
                self._step_canary(now)
            elif self.phase == ROLLING:
                self._step_rolling(now)
            elif self.phase == FINALIZE:
                self._step_finalize(now)
            elif self.phase == ROLLING_BACK:
                self._step_rolling_back(now)
            return self.phase

    def rollback(self, reason: str = "operator") -> Dict:
        """First-class rollback: ONE actuation closes the canary lane
        and orders every host back to the boot version; subsequent
        :meth:`step` ticks pump hosts until all live capacity is v1.
        Idempotent — a second call (operator on top of gate, scheduler
        on top of operator) is a recorded no-op."""
        with self._lock:
            if self.phase in (ROLLING_BACK, ROLLED_BACK):
                self._log("rollback_noop", reason=reason)
                return {"phase": self.phase, "noop": True}
            self._rollback_reason = reason
            self._rollback_started = float(self._clock())
            self.phase = ROLLING_BACK
            self.port.set_canary(self.version, 0.0)
            for source in sorted(self.port.sources()):
                self.port.rollback(source)
            self._log("rollback", reason=reason)
            return {"phase": self.phase, "noop": False, "reason": reason}

    def run(self, timeout_s: float = 600.0,
            sleep: Callable[[float], None] = time.sleep) -> str:
        """The wall-clock loop (live deployments; the sim ticks
        :meth:`step` itself in virtual time)."""
        self.start()
        deadline = float(self._clock()) + timeout_s
        while self.phase not in _TERMINAL:
            self.step()
            if self.phase in _TERMINAL:
                break
            if float(self._clock()) >= deadline:
                self._log("timeout", timeout_s=timeout_s)
                break
            sleep(self.cfg.rollout.settle_s)
        return self.phase

    def status(self) -> Dict:
        with self._lock:
            return {
                "phase": self.phase,
                "version": self.version,
                "pulled": sorted(self._pulled),
                "deferred": sorted(self._deferred),
                "gate": self.gate.verdict(),
                "rollback_reason": self._rollback_reason,
                "rollback_s": self.rollback_s,
                "events": len(self.events),
            }


class AgentRolloutPort:
    """Live port: the controller's verbs over the agent admin HTTP
    surface (``POST /rollout`` on each host, through the same typed
    ``AgentAdmin`` transport the elastic scheduler actuates with).  A
    host that is down or refuses reads as None — the controller's
    defer/re-converge machinery owns the retry policy, not the
    transport."""

    def __init__(self, admin):
        from mx_rcnn_tpu_torch.serve.scheduler import AgentAdminError
        self._admin = admin
        self._err = AgentAdminError
        self._shadow_rr = 0

    def sources(self) -> List[str]:
        return sorted(self._admin.by_source)

    def _call(self, source: str, body: Dict) -> Optional[Dict]:
        try:
            return self._admin.call(source, "/rollout", body)
        except self._err:
            return None

    def pull(self, source: str, url: str, version: str) -> Optional[Dict]:
        return self._call(source, {"op": "pull", "url": url,
                                   "version": version})

    def versions(self, source: str) -> Optional[Dict]:
        res = self._call(source, {"op": "status"})
        return None if res is None else res.get("versions")

    def swap_next(self, source: str, version: str) -> Optional[Dict]:
        return self._call(source, {"op": "swap", "version": version})

    def rollback(self, source: str) -> Optional[Dict]:
        return self._call(source, {"op": "rollback"})

    def set_canary(self, version: Optional[str], fraction: float) -> None:
        for source in self.sources():
            self._call(source, {"op": "canary", "version": version,
                                "fraction": fraction})

    def shadow_pair(self) -> Optional[Tuple[float, float]]:
        """One paired shadow sample from a host holding both arms
        (round-robin so no single host's noise dominates the gate)."""
        sources = self.sources()
        for _ in range(len(sources)):
            source = sources[self._shadow_rr % len(sources)]
            self._shadow_rr += 1
            res = self._call(source, {"op": "shadow"})
            if res is not None and res.get("pair") is not None:
                a, b = res["pair"]
                return float(a), float(b)
        return None
