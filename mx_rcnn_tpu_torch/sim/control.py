"""The harness: SHIPPED control-plane code in the loop, virtual time.

Counterpart of ``mx_rcnn_tpu/sim/control.py``, whole: the same events in
the same order, so a seeded run's decision log is byte-equal to the
JAX package's.

This module wires a :class:`~mx_rcnn_tpu_torch.sim.cluster.SimCluster` to the
REAL production classes through their clock seams:

* a real ``Collector`` (one ``RegistrySource`` per simulated host, one
  ``head`` source) scrapes the hosts every virtual
  ``cfg.sim.scrape_interval_s`` and appends ``view_to_snapshot`` output
  into a real ``TimeSeriesStore`` — the exact path
  ``RemoteBacklogFeed`` / ``tools/obs.py check`` use in production;
* a real ``HealthEngine`` (:func:`sim_rules`) judges every sample;
  CRITICAL/WARN dwell time becomes the SLO-minutes score;
* a real ``FleetScheduler`` (the shipped ``SchedulerPolicy``) decides
  adds/drains off the store; actuation goes through :class:`SimAdmin`,
  which duck-types ``AgentAdmin`` (typed ``last_error``, None on a dead
  host) over ``SimCluster.resize``;
* a real ``RestartPolicy`` (``ft/supervisor.py``) paces crash-looping
  hosts' relaunches and delivers the give-up verdict;
* routing inside the cluster already runs the shipped ``jsq_key``.

The **mistuned red-team arm** (:data:`MISTUNED_OVERRIDES`) runs the
same code with sabotaged knobs: infinite action hysteresis (the deficit
and overload signals never fire), unreachable overload thresholds, a
zero-hysteresis drain with the floor inverted to one replica
fleet-wide.  The gauntlet requires it to measurably breach on at least
one scenario where the shipped tuning does not.

Nothing here reads a wall clock; the decision log is a list of plain
dicts whose canonical JSON bytes are reproducible for a given
(trace, seed) — ``tests/test_torch_sim.py`` pins byte identity.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.ft.supervisor import RestartPolicy
from mx_rcnn_tpu_torch.obs.collect import (Collector, RegistrySource,
                                     view_to_snapshot)
from mx_rcnn_tpu_torch.obs.health import CRITICAL, WARN, HealthEngine, Rule
from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore
from mx_rcnn_tpu_torch.serve.rollout import (DONE, ROLLED_BACK,
                                       OnlinePairedGate,
                                       RolloutController, rollout_rules,
                                       version_label)
from mx_rcnn_tpu_torch.serve.scheduler import AgentAdminError, FleetScheduler
from mx_rcnn_tpu_torch.sim.cluster import READY, SimCluster
from mx_rcnn_tpu_torch.sim.kernel import SimKernel
from mx_rcnn_tpu_torch.sim.score import score_run
from mx_rcnn_tpu_torch.sim.traffic import fleet_capacity_rps, rate_at

logger = logging.getLogger("mx_rcnn_tpu_torch")

# the red-team policy: same code, sabotaged tuning (see module doc)
MISTUNED_OVERRIDES = {
    "crosshost__for_samples": 100_000,   # blind to deficit + overload
    "crosshost__up_shed_ratio": 9.0,     # unreachable (ratio <= 1)
    "crosshost__up_backlog": 1e9,
    "crosshost__idle_samples": 1,        # zero drain hysteresis
    "crosshost__cooldown_s": 0.0,
    "crosshost__min_replicas": 1,        # inverted drain floor
}


def apply_overrides(cfg: Config, overrides: Dict) -> Config:
    """``section__field`` dict → new Config (the trace/arm knob path).
    Values keep the declared field's type via dataclasses.replace."""
    by_section: Dict[str, Dict] = {}
    for key, val in overrides.items():
        section, fname = key.split("__", 1)
        cur = getattr(getattr(cfg, section), fname)
        if cur is not None and not isinstance(val, type(cur)):
            val = type(cur)(val)
        by_section.setdefault(section, {})[fname] = val
    for section, kw in by_section.items():
        cfg = cfg.replace_in(section, **kw)
    return cfg


def sim_rules(cfg: Config) -> List[Rule]:
    """The scenario SLO set over the head's fleet.* surface — the
    judgments production monitoring would page on.  Lost work and
    sustained shedding are CRITICAL; degraded capacity and a fat tail
    are WARN (capacity state, not user-facing damage — yet)."""
    w = cfg.crosshost.window_s
    deadline = cfg.serve.default_timeout_ms or 2000.0
    return [
        Rule("sim-lost-expired", "fleet.expired", "delta", ">", 0.0,
             window_s=w, severity=CRITICAL, for_samples=1,
             clear_samples=3),
        Rule("sim-lost-failed", "fleet.failed", "delta", ">", 0.0,
             window_s=w, severity=CRITICAL, for_samples=1,
             clear_samples=3),
        Rule("sim-shed-frac", "fleet.shed/fleet.submitted", "ratio",
             ">", 0.05, window_s=max(w, 20.0), severity=CRITICAL,
             for_samples=2, clear_samples=2),
        Rule("sim-degraded", "fleet.replicas_ready", "gauge", "<",
             float(cfg.crosshost.target_replicas), window_s=15.0,
             severity=WARN, for_samples=1, clear_samples=1),
        Rule("sim-p99-budget", "fleet.total_ms", "p99", ">",
             0.9 * deadline, window_s=w, severity=WARN),
    ]


class SimAdmin:
    """``AgentAdmin`` duck type over the cluster: ``resize`` + typed
    ``last_error``; a down host answers None exactly like a refused
    socket, and the next tick's deficit re-places on a live agent."""

    def __init__(self, cluster: SimCluster):
        self.cluster = cluster
        self.last_error: Optional[AgentAdminError] = None

    def resize(self, source: str, delta: int) -> Optional[Dict]:
        try:
            index = int(source.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            self.last_error = AgentAdminError(f"bad source {source!r}")
            return None
        result = self.cluster.resize(index, int(delta))
        if result is None:
            self.last_error = AgentAdminError(f"{source} is down")
            return None
        self.last_error = None
        return result


class SimRolloutPort:
    """``RolloutController`` port over the simulated cluster — the
    virtual-time twin of ``AgentRolloutPort``.  Down hosts answer None
    on every verb (the controller's defer/re-converge machinery owns
    retries), and the shadow-pair quality model is deterministic from
    the kernel's ``shadow`` RNG substream: a healthy canary scores
    IDENTICALLY to base (the same program on the same canvas — paired
    deltas exactly zero), while the red-team arm's canary scores
    ``rollout.redteam_damage`` lower plus small jitter, which is
    exactly the kind of silent model damage only the paired gate can
    see (latency and failure metrics stay clean)."""

    def __init__(self, run: "SimRun", version: str, damage: float):
        self.run = run
        self.version = version
        self.damage = float(damage)
        self._rng = run.k.rng("shadow")

    @staticmethod
    def _index(source: str) -> int:
        return int(source.rsplit("-", 1)[1])

    def sources(self) -> List[str]:
        return [h.name for h in self.run.cluster.hosts]

    def pull(self, source: str, url: str, version: str):
        return self.run.cluster.pull_version(self._index(source),
                                             version)

    def versions(self, source: str):
        return self.run.cluster.host_versions(self._index(source))

    def swap_next(self, source: str, version: str):
        return self.run.cluster.swap_replica(self._index(source),
                                             version)

    def rollback(self, source: str):
        return self.run.cluster.rollback_host(self._index(source))

    def set_canary(self, version, fraction: float) -> None:
        self.run.cluster.set_canary(version, fraction)

    def shadow_pair(self):
        for h in self.run.cluster.hosts:
            if not h.up or self.version not in h.pulled:
                continue
            ready = [r for r in h.replicas if r.state == READY]
            if not (any(r.version == self.version for r in ready)
                    and any(r.version != self.version
                            for r in ready)):
                continue
            base = 0.8 + 0.05 * float(self._rng.standard_normal())
            if self.damage:
                canary = (base - self.damage
                          + 0.01 * float(self._rng.standard_normal()))
            else:
                canary = base
            return (round(base, 6), round(canary, 6))
        return None


class SimRun:
    """One arm of the gauntlet: one trace, one config, one seed."""

    def __init__(self, trace: Dict, cfg: Config, label: str = "shipped",
                 arm_overrides: Optional[Dict] = None):
        overrides = dict(trace.get("overrides") or {})
        overrides.update(arm_overrides or {})
        self.cfg = apply_overrides(cfg, overrides)
        self.trace = trace
        self.label = label
        self.k = SimKernel(seed=int(trace["seed"]))
        self.log: List[Dict] = []
        self.cluster = SimCluster(self.k, self.cfg, trace["hosts"],
                                  self._log)
        interval = self.cfg.sim.scrape_interval_s
        horizon = trace["duration_s"] + self.cfg.sim.settle_s
        self.store = TimeSeriesStore(
            capacity=int(horizon / interval) + 16,
            clock=self.k.clock)
        self.collector = Collector(
            [RegistrySource(h.name, h.resolve)
             for h in self.cluster.hosts]
            + [RegistrySource("head", lambda: (self.cluster.head, {}))],
            clock=self.k.clock)
        self._rollout_spec = trace.get("rollout")
        self.rollout: Optional[RolloutController] = None
        rules = sim_rules(self.cfg)
        if self._rollout_spec:
            # per-version canary SLO rules ride in the SAME engine the
            # scorer reads: a canary breach is an SLO breach
            rules = rules + rollout_rules(
                self.cfg, self._rollout_spec["version"])
        self.engine = HealthEngine(rules, self.store,
                                   clock=self.k.clock,
                                   on_transition=self._on_health)
        self.scheduler = FleetScheduler(self.store,
                                        SimAdmin(self.cluster),
                                        self.cfg, clock=self.k.clock)
        self._flap_policies: Dict[int, RestartPolicy] = {}
        self._arr_rng = self.k.rng("arrivals")
        self._bucket_rng = self.k.rng("buckets")
        weights = trace["bucket_weights"]
        self._bucket_shapes = [tuple(b) for b, _ in weights]
        self._bucket_cum = np.cumsum([w for _, w in weights])
        self._replica_rate = (
            fleet_capacity_rps(self.cfg, trace["hosts"])
            / (trace["hosts"]
               * max(int(self.cfg.crosshost.agent_replicas), 1)))
        self.critical_s = 0.0
        self.warn_s = 0.0
        self.wasted_replica_s = 0.0

    # -- logging -----------------------------------------------------------

    def _log(self, kind: str, **kw) -> None:
        entry = {"t": round(self.k.clock.now, 6), "kind": kind}
        entry.update(kw)
        self.log.append(entry)

    def _on_health(self, prev: str, new: str, verdict: Dict) -> None:
        self._log("health", prev=prev, verdict=new,
                  firing=list(verdict["firing"]))

    def _rollout_log(self, kind: str, **kw) -> None:
        kw.pop("t", None)  # the harness stamps its own virtual time
        self._log(f"rollout_{kind}", **kw)

    def _start_rollout(self) -> None:
        ro = self._rollout_spec
        port = SimRolloutPort(self, ro["version"],
                              self.cfg.rollout.redteam_damage)
        self.rollout = RolloutController(
            port, self.cfg, version=ro["version"],
            store_url=ro.get("store_url", "sim://store"),
            gate=OnlinePairedGate(
                budget=self.cfg.rollout.gate_budget,
                min_pairs=self.cfg.rollout.gate_min_pairs),
            health=self.engine, clock=self.k.clock,
            log=self._rollout_log)
        self.scheduler.rollout = self.rollout
        self.rollout.start()

    # -- the scrape/judge/act tick ----------------------------------------

    def _tick(self) -> None:
        now = self.k.clock.now
        self.cluster.refresh_gauges()
        view = self.collector.collect()
        self.store.append_snapshot(view_to_snapshot(view), ts=now)
        verdict = self.engine.evaluate()
        interval = self.cfg.sim.scrape_interval_s
        if verdict["verdict"] == CRITICAL:
            self.critical_s += interval
        elif verdict["verdict"] == WARN:
            self.warn_s += interval
        ready = self.cluster.ready_count()
        needed = max(rate_at(self.trace, now) / self._replica_rate,
                     float(self.cfg.crosshost.min_replicas))
        self.wasted_replica_s += interval * max(ready - needed, 0.0)
        action = self.scheduler.tick()
        if action is not None:
            entry = {k: action.get(k) for k in
                     ("action", "source", "reason", "ready", "target",
                      "corr")}
            result = action.get("result")
            entry["result"] = (dict(result)
                               if isinstance(result, dict) else result)
            if "error" in action:
                entry["error"] = action["error"]
            self._log("action", **entry)
        if (self.rollout is not None
                and self.rollout.phase not in (DONE, ROLLED_BACK)):
            self.rollout.step()
        nxt = now + interval
        if nxt <= self.trace["duration_s"] + self.cfg.sim.settle_s:
            self.k.at(nxt, self._tick)

    # -- arrivals ----------------------------------------------------------

    def _draw_bucket(self) -> Tuple[int, int]:
        u = self._bucket_rng.random_sample()
        i = int(np.searchsorted(self._bucket_cum, u, side="right"))
        return self._bucket_shapes[min(i, len(self._bucket_shapes) - 1)]

    def _arrive(self) -> None:
        now = self.k.clock.now
        if now < self.trace["duration_s"]:
            self.cluster.submit(self._draw_bucket())
        rate = rate_at(self.trace, self.k.clock.now)
        if rate <= 0.0:
            return
        gap = float(self._arr_rng.exponential(1.0 / rate))
        nxt = self.k.clock.now + gap
        if nxt < self.trace["duration_s"]:
            self.k.at(nxt, self._arrive)

    # -- trace events ------------------------------------------------------

    def _install_events(self) -> None:
        if self._rollout_spec:
            self.k.at(float(self._rollout_spec.get("t_start", 10.0)),
                      self._start_rollout)
        for ev in self.trace.get("events", []):
            kind, host = ev["kind"], int(ev["host"])
            if kind == "host_down":
                self.k.at(ev["t"],
                          lambda h=host: self.cluster.host_down(h))
            elif kind == "host_flap":
                self.k.at(ev["t"], lambda h=host: self._flap(h))
            elif kind == "drain_host":
                self.k.at(ev["t"],
                          lambda h=host: self.cluster.drain_host(h))
            else:
                raise ValueError(f"unknown trace event kind {kind!r}")

    def _flap(self, host: int) -> None:
        """One crash of a crash-looping host, paced and judged by the
        SHIPPED RestartPolicy (virtual clock through its seam)."""
        pol = self._flap_policies.get(host)
        if pol is None:
            pol = RestartPolicy(base_s=4.0, factor=2.0, cap_s=60.0,
                                give_up_after=3,
                                seed=int(self.trace["seed"]) + host,
                                registry=self.cluster.head,
                                clock=self.k.clock)
            self._flap_policies[host] = pol
        self.cluster.host_down(host)
        delay, give_up = pol.record(("preempt", host),
                                    made_progress=False)
        self._log("supervisor", host=f"agent-{host}",
                  failures=pol.failures, backoff_s=round(delay, 3),
                  give_up=give_up)
        if give_up:
            return  # crash-loop verdict: stays dead, deficit re-places
        self.k.at(pol.ready_at, lambda: self._flap_relaunch(host))

    def _flap_relaunch(self, host: int) -> None:
        self.cluster.host_up(host)
        # the flapper stays up briefly, then crashes the same way again
        self.k.after(6.0, lambda: self._flap(host))

    # -- run ---------------------------------------------------------------

    def run(self) -> Dict:
        self._install_events()
        self.k.at(0.0, self._tick)
        first_rate = rate_at(self.trace, 0.0)
        if first_rate > 0.0:
            self.k.at(float(self._arr_rng.exponential(1.0 / first_rate)),
                      self._arrive)
        horizon = self.trace["duration_s"] + self.cfg.sim.settle_s
        self.k.run_until(self.trace["duration_s"])
        self.k.run_until(horizon)
        stranded = self.cluster.pending()
        if stranded:
            self._log("settle_timeout", stranded=stranded)
            self.cluster.fail_pending()
        p99 = self.cluster.head.hist("fleet.total_ms")
        p99 = None if p99 is None else p99.percentile(99)
        score = score_run(self.cluster.stats, self.critical_s,
                          self.warn_s, self.wasted_replica_s,
                          self.cluster.wait_ms_max, p99, self.log)
        score["label"] = self.label
        score["events_fired"] = self.k.fired
        if self.rollout is not None:
            census: Dict[str, int] = {}
            for h in self.cluster.hosts:
                if not h.up:
                    continue
                for r in h.replicas:
                    if r.state == READY:
                        lbl = version_label(r.version)
                        census[lbl] = census.get(lbl, 0) + 1
            score["rollout"] = {
                "phase": self.rollout.phase,
                "reason": self.rollout._rollback_reason,
                "rollback_s": self.rollout.rollback_s,
                "gate": self.rollout.gate.verdict(),
                "final_versions": census,
                "per_version": {k: dict(v) for k, v in
                                sorted(self.cluster.ver_stats.items())},
            }
        return score
