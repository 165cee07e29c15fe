"""The gauge-driven fleet scheduler: the control loop over the
cross-host plane.

Counterpart of ``mx_rcnn_tpu/serve/scheduler.py``, whole.  It reads the
observability plane instead of probing on its own:

* :class:`SchedulerPolicy` is pure decision logic: it reads the
  :class:`~mx_rcnn_tpu_torch.obs.timeseries.TimeSeriesStore` that the
  head's :class:`~mx_rcnn_tpu_torch.serve.remote.RemoteBacklogFeed`
  fills (one snapshot a scrape, each agent's gauges labelled
  ``name@agent-i``) and returns at most one action a tick.  Tests drive
  it with synthetic gauge traces and timestamps of their own;
* :class:`AgentAdmin` is the actuator: an action becomes the agent's
  ``POST /replicas``;
* :class:`FleetScheduler` is the thread that joins them, ``tick()`` for
  tests and ``start()`` for a live head.

Signals (windows and thresholds from ``cfg.crosshost``):

* **capacity deficit**: the latest sample's summed
  ``agent.replicas_ready@*`` below the target.  A dead host's gauges
  vanish from the sample (its source reads down), so a SIGKILL shows as
  a deficit within one scrape and the add lands on a surviving agent;
* **overload**: the windowed shed ratio above ``up_shed_ratio`` (the
  worse of the head's ``fleet.*`` and the agents' summed ``serve.*``
  counter deltas: sheds at the head's gate never cross the wire, so the
  feed scrapes the router's registry as source ``head``), or the lane
  backlog per ready replica above ``up_backlog``;
* **idle**: no backlog, no shed and no traffic in the window while
  above ``min_replicas``: capacity is never drained under live load.

Each signal is judged with ``obs/health.py``'s hysteresis:
``for_samples`` consecutive breaches to act, ``idle_samples`` quiet
ticks to shrink, and ``cooldown_s`` after any action, so one noisy tick
(or a replica's ready dip while it relaunches) never flaps the fleet.
The third verb, :meth:`FleetScheduler.rollback`, reaches the
``serve/rollout.py — RolloutController`` attached as
``FleetScheduler.rollout``; with none attached it records
``NoRolloutController``.
"""

from __future__ import annotations

import json
import logging
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.netio import read_limited
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore
from mx_rcnn_tpu_torch.serve.remote import normalize_agent_url

logger = logging.getLogger("mx_rcnn_tpu_torch")

READY_GAUGE = "agent.replicas_ready"
LANE_PREFIX = "lane."
# the backlog feed labels its sources agent-<i> over the ordered URL
# list; the agents' OWN snapshots carry nested per-replica labels
# (``...@router@agent-0``), so the source filter must be exact or a
# single host's capacity would count once per label depth
_AGENT_SRC = re.compile(r"^agent-\d+$")


def _latest(store: TimeSeriesStore) -> Optional[Dict]:
    w = store.window(None)
    return w[-1] if w else None


# decision-log correlation ids live with the rest of the tracing plane
correlation_id = obs_trace.correlation_id


def per_agent_ready(sample: Dict) -> Dict[str, float]:
    """{source: ready replicas} from one sample's labeled gauges.  Only
    sources PRESENT in this sample count — a down agent contributes
    nothing, which is precisely what makes host death legible here."""
    out: Dict[str, float] = {}
    pre = READY_GAUGE + "@"
    for name, v in sample["gauges"].items():
        if (name.startswith(pre)
                and _AGENT_SRC.match(name[len(pre):])):
            out[name[len(pre):]] = float(v)
    return out


def per_agent_backlog(sample: Dict) -> Dict[str, float]:
    """{source: summed lane depth} from ``lane.<h>x<w>.depth@src``."""
    out: Dict[str, float] = {}
    for name, v in sample["gauges"].items():
        if not (name.startswith(LANE_PREFIX) and "@" in name):
            continue
        body, src = name.rsplit("@", 1)
        if not (_AGENT_SRC.match(src) and body.endswith(".depth")):
            continue
        out[src] = out.get(src, 0.0) + float(v)
    return out


class SchedulerPolicy:
    """Pure gauge→action judgment with hysteresis.  ``decide`` returns
    None or one action dict ``{"action": "add"|"drain", "source":
    <agent source name>, "reason": ..., "ready": ..., "target": ...}``.
    """

    def __init__(self, cfg: Config, clock=time.monotonic):
        ch = cfg.crosshost
        self.cfg = cfg
        # cooldown clock: monotonic by default, a virtual one in tests
        self._clock = clock
        # 0 = adopt whatever capacity the fleet reports on the first
        # tick that sees a ready replica (hosts x agent_replicas at a
        # clean boot) — the operator states intent by exception only
        self.target = int(ch.target_replicas)
        self._deficit_streak = 0
        self._over_streak = 0
        self._idle_streak = 0
        self._cooldown_until = float("-inf")

    # -- signal reads ------------------------------------------------------

    def shed_ratio(self, store: TimeSeriesStore) -> float:
        # two vantage points, worst wins: the head's ``fleet.*`` counters
        # see every admission (including sheds taken at the RemoteEngine
        # capacity gate, which never reach an agent), while the summed
        # agent-side ``serve.*`` counters see engine-level shedding
        w = self.cfg.crosshost.window_s
        worst = 0.0
        for pre in ("fleet.", "serve."):
            shed = store.delta(pre + "shed", w)
            sub = store.delta(pre + "submitted", w)
            if not sub or sub <= 0:
                continue
            # an agent death shrinks the summed counters mid-window; a
            # negative delta is an artifact of that, not negative
            # shedding
            worst = max(worst, max(float(shed or 0.0), 0.0) / float(sub))
        return worst

    def traffic(self, store: TimeSeriesStore) -> float:
        """Windowed submitted-request delta (head view, agent fallback)."""
        w = self.cfg.crosshost.window_s
        vals = [store.delta(pre + "submitted", w)
                for pre in ("fleet.", "serve.")]
        vals = [float(v) for v in vals if v is not None]
        return max(vals) if vals else 0.0

    # -- judgment ----------------------------------------------------------

    def decide(self, store: TimeSeriesStore,
               now: float = None) -> Optional[Dict]:
        now = self._clock() if now is None else now
        sample = _latest(store)
        if sample is None:
            return None
        ch = self.cfg.crosshost
        ready_by = per_agent_ready(sample)
        ready = sum(ready_by.values())
        if not ready_by:
            return None  # every agent down: nowhere to act
        if self.target <= 0:
            if ready <= 0:
                return None  # still booting; adopt once capacity shows
            self.target = int(min(max(ready, ch.min_replicas),
                                  ch.max_replicas))
            logger.info("scheduler adopted target=%d from fleet",
                        self.target)
        backlog_by = per_agent_backlog(sample)
        backlog = sum(backlog_by.values())
        shed = self.shed_ratio(store)
        cooldown_s = ch.cooldown_s

        # streaks advance every tick regardless of cooldown — a breach
        # that persists THROUGH the cooldown acts the moment it lifts
        self._deficit_streak = (self._deficit_streak + 1
                                if ready < self.target else 0)
        over = (shed > ch.up_shed_ratio
                or (ready > 0 and backlog / ready > ch.up_backlog))
        self._over_streak = self._over_streak + 1 if over else 0
        # idle means QUIET, not merely comfortable: a fleet absorbing
        # traffic with zero backlog/shed keeps its capacity — trading
        # latency headroom away under live load is an operator call,
        # not a gauge's
        idle = (backlog <= 0 and shed <= 0
                and self.traffic(store) <= 0)
        self._idle_streak = self._idle_streak + 1 if idle else 0

        if now < self._cooldown_until:
            return None

        def acted(action: Dict) -> Dict:
            self._cooldown_until = now + cooldown_s
            self._deficit_streak = self._over_streak = 0
            self._idle_streak = 0
            action.update(ready=ready, target=self.target,
                          corr=correlation_id(sample["ts"]))
            return action

        if self._deficit_streak >= ch.for_samples:
            # re-place lost capacity on the least-loaded LIVE agent
            src = min(sorted(ready_by), key=lambda s: ready_by[s])
            return acted({"action": "add", "source": src,
                          "reason": f"ready {ready:g} < target "
                                    f"{self.target}"})
        if (self._over_streak >= ch.for_samples
                and ready < ch.max_replicas):
            self.target = min(self.target + 1, ch.max_replicas)
            src = min(sorted(ready_by), key=lambda s: ready_by[s])
            return acted({"action": "add", "source": src,
                          "reason": f"shed {shed:.3f} / backlog "
                                    f"{backlog:g} over thresholds"})
        if (self._idle_streak >= ch.idle_samples
                and ready > max(ch.min_replicas, 1)):
            # agents clamp their local fleet at one replica (a live
            # host always keeps a warm engine), so only an agent with
            # something to give back is a drain candidate — refusing
            # here keeps the target honest instead of decrementing it
            # against a resize the agent will reject
            cands = [s for s in sorted(ready_by) if ready_by[s] > 1]
            if cands:
                self.target = max(self.target - 1, ch.min_replicas)
                src = max(cands, key=lambda s: ready_by[s])
                return acted({"action": "drain", "source": src,
                              "reason": f"idle for {self._idle_streak} "
                                        f"samples"})
        return None


class AgentAdminError(RuntimeError):
    """The typed actuation failure: the agent refused, answered
    garbage, or the socket broke.  ``resize`` absorbs it into a None
    result (the next tick's deficit re-places on a live agent), but
    callers that must distinguish — tests, the tick record — read the
    type off :attr:`AgentAdmin.last_error`."""


class AgentAdminTimeout(AgentAdminError):
    """The actuation RPC ran past ``crosshost.admin_timeout_s`` without
    a reply — a hung (accepting-but-not-answering) agent.  Typed so a
    wedged host costs the scheduler exactly one bounded RPC per tick,
    never the tick itself."""


class AgentAdmin:
    """The actuator: source name → agent URL → ``POST /replicas``.
    Source names follow the backlog feed's ``agent-{i}`` convention
    over the same ordered URL list, so policy and actuator agree on
    identity without a registry.

    Every RPC carries a hard per-request deadline (default
    ``cfg.crosshost.admin_timeout_s`` — pass ``timeout_s`` to
    override); expiry raises :class:`AgentAdminTimeout` inside
    :meth:`resize`, which converts it (and every other
    :class:`AgentAdminError`) into a logged None so one hung agent can
    never wedge a :meth:`FleetScheduler.tick`."""

    def __init__(self, agent_urls: List[str], timeout_s: float = 5.0):
        self.by_source = {f"agent-{i}": normalize_agent_url(u)
                          for i, u in enumerate(agent_urls)}
        self.timeout_s = float(timeout_s)
        self.last_error: Optional[AgentAdminError] = None

    @classmethod
    def from_config(cls, agent_urls: List[str],
                    cfg: Config) -> "AgentAdmin":
        return cls(agent_urls, timeout_s=cfg.crosshost.admin_timeout_s)

    def _post(self, url: str, path: str, body: Dict) -> Dict:
        """One admin RPC with the typed-failure contract: timeout →
        :class:`AgentAdminTimeout`, anything else (refused socket,
        non-200, undecodable body) → :class:`AgentAdminError`."""
        headers = {"Content-Type": "application/json"}
        # control-plane verbs carry a trace context when distributed
        # tracing is armed, so the agent records the verb as a span;
        # untraced (sample=0) admin RPCs stay byte-identical
        tctx = obs_trace.admin_trace()
        if tctx is not None:
            headers[obs_trace.TRACE_HEADER] = obs_trace.format_header(
                tctx.child(obs_trace.new_span_id()))
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers=headers)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                return json.loads(read_limited(r, what="admin reply")
                                  .decode())
        except (socket.timeout, TimeoutError) as e:
            raise AgentAdminTimeout(
                f"{url}{path}: no reply within "
                f"{self.timeout_s:g}s") from e
        except urllib.error.URLError as e:
            if isinstance(e.reason, (socket.timeout, TimeoutError)):
                raise AgentAdminTimeout(
                    f"{url}{path}: no reply within "
                    f"{self.timeout_s:g}s") from e
            raise AgentAdminError(f"{url}{path}: {e}") from e
        except (OSError, ValueError) as e:
            raise AgentAdminError(f"{url}{path}: {e}") from e

    def call(self, source: str, path: str, body: Dict) -> Dict:
        """Generic admin RPC to one agent (the rollout plane's
        transport: its controller routes every verb through this).
        Same typed-failure contract as :meth:`resize`, but the error
        PROPAGATES: the rollout
        controller owns retry/defer policy, not the transport."""
        url = self.by_source.get(source)
        if url is None:
            raise AgentAdminError(f"unknown agent source {source!r}")
        return self._post(url, path, body)

    def resize(self, source: str, delta: int) -> Optional[Dict]:
        url = self.by_source.get(source)
        if url is None:
            logger.warning("scheduler: unknown agent source %r", source)
            return None
        try:
            result = self._post(url, "/replicas",
                                {"delta": int(delta)})
        except AgentAdminError as e:
            # the target may have died (or hung) between judgment and
            # actuation; the next tick's deficit picks a live agent
            self.last_error = e
            logger.warning("scheduler: resize %s via %s failed: %s: %s",
                           source, url, type(e).__name__, e)
            return None
        self.last_error = None
        return result


class FleetScheduler:
    """The control loop: judge the store, actuate on an agent, record
    what happened.  ``tick()`` is public and synchronous for tests and
    the bench; ``start()`` runs it on a daemon thread every
    ``crosshost.interval_s``."""

    def __init__(self, store: TimeSeriesStore, admin: AgentAdmin,
                 cfg: Config, record=None, clock=time.monotonic):
        self.policy = SchedulerPolicy(cfg, clock=clock)
        self.store = store
        self.admin = admin
        self.cfg = cfg
        self.record = record
        self.actions: List[Dict] = []
        # tick() runs on the daemon thread; rollback() arrives from
        # whoever holds the controller — one lock covers the shared
        # action history
        self._actions_lock = threading.Lock()
        # an attached rollout controller gives the
        # scheduler its third verb, rollback, next to add/drain
        self.rollout = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self, now: float = None) -> Optional[Dict]:
        action = self.policy.decide(self.store, now)
        if action is None:
            return None
        delta = 1 if action["action"] == "add" else -1
        action["result"] = self.admin.resize(action["source"], delta)
        if (action["result"] is None
                and getattr(self.admin, "last_error", None) is not None):
            # the typed actuation failure rides the action record, so
            # "the agent hung" and "the agent refused" stay legible in
            # scheduler.actions / the flight recorder
            action["error"] = type(self.admin.last_error).__name__
        with self._actions_lock:
            self.actions.append(action)
        logger.info("scheduler: %s on %s (%s) -> %s", action["action"],
                    action["source"], action["reason"],
                    action["result"])
        if self.record is not None:
            self.record.event("fleet_schedule", **{
                k: action[k]
                for k in ("action", "source", "reason", "corr")
                if k in action})
        return action

    def rollback(self, reason: str = "operator") -> Dict:
        """The first-class rollback verb: ONE actuation returns every
        host to the boot version.
        Requires an attached rollout controller (``self.rollout``);
        idempotent the same way the controller is, and recorded in
        ``self.actions`` next to add/drain so the tick history tells
        the whole story."""
        smp = _latest(self.store)
        corr = correlation_id(smp["ts"]) if smp is not None else None
        if self.rollout is None:
            action = {"action": "rollback", "reason": reason,
                      "result": None, "error": "NoRolloutController",
                      "corr": corr}
            with self._actions_lock:
                self.actions.append(action)
            return action
        result = self.rollout.rollback(reason)
        action = {"action": "rollback", "reason": reason,
                  "result": result, "corr": corr}
        with self._actions_lock:
            self.actions.append(action)
        logger.warning("scheduler: rollback (%s) -> %s", reason, result)
        if self.record is not None:
            self.record.event("fleet_schedule", action="rollback",
                              source="*", reason=reason, corr=corr)
        return action

    def start(self) -> "FleetScheduler":
        def loop():
            interval = max(0.05, self.cfg.crosshost.interval_s)
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:
                    logger.exception("scheduler tick failed")
        self._thread = threading.Thread(target=loop,
                                        name="fleet-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
