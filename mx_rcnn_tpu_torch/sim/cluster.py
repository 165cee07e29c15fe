"""Simulated hosts / replicas emulating the agent plane's gauge surface.

Counterpart of ``mx_rcnn_tpu/sim/cluster.py``, whole: the same events in
the same order, so a seeded run's decision log is byte-equal to the
JAX package's.

One :class:`SimHost` stands in for one ``serve/agent.py`` host: it owns
a REAL ``obs.metrics.Registry`` carrying exactly the metric surface the
cross-host backlog feed scrapes — ``agent.replicas_ready``,
``lane.<h>x<w>.depth``, ``serve.submitted/shed/served/expired`` counters
and the ``serve.total_ms`` histogram — so the collector, time-series
store, health rules and scheduler parse simulated hosts through the
same code paths as live ones.  The head keeps its own registry with the
``fleet.*`` counters the router would count.

Request semantics mirror ``serve/fleet.py`` + ``serve/engine.py``:

* routing is batch-aware JSQ via the SHIPPED :func:`~mx_rcnn_tpu_torch.serve.fleet.jsq_key` over ready replicas minus the ones a request already
  tried;
* admission sheds at the per-lane watermark (``serve.shed_watermark``);
  a watermark shed on the JSQ-chosen (least-loaded) replica is a
  TERMINAL fleet shed — the whole fleet is saturated, 429 now;
* the engine pads every micro-batch to ``serve.batch_size`` rows, so a
  dispatch costs the bucket's service draw regardless of occupancy;
* expired requests are cancelled BEFORE dispatch, never consuming a
  batch slot; a request in flight when its deadline passes still serves
  (it was already dispatched) — both exactly the engine's contract;
* replica/host death strands queued + in-flight work, which reroutes on
  the fleet deadline budget up to ``fleet.reroute_retries`` times, then
  fails honestly.

Everything is single-threaded on the kernel's virtual clock; host
registries are real (locked) Registry objects only so the real
collector can scrape them.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.obs.metrics import Registry
from mx_rcnn_tpu_torch.serve.fleet import jsq_key
from mx_rcnn_tpu_torch.serve.rollout import version_label
from mx_rcnn_tpu_torch.sim.kernel import SimKernel

# replica lifecycle (the sim's reduction of serve/fleet.py R_* states)
WARMING, READY, DRAINING, DEAD = "warming", "ready", "draining", "dead"

# request terminals (mirrors serve/queue.py verdicts)
SERVED, SHED, EXPIRED, FAILED = "SERVED", "SHED", "EXPIRED", "FAILED"


class SimRequest:
    __slots__ = ("rid", "bucket", "t_arrive", "deadline", "attempts",
                 "tried", "state", "t_done", "version", "routed")

    def __init__(self, rid: int, bucket: Tuple[int, int],
                 t_arrive: float, deadline: Optional[float]):
        self.rid = rid
        self.bucket = bucket
        self.t_arrive = t_arrive
        self.deadline = deadline     # absolute virtual time, None = never
        self.attempts = 0
        self.tried: set = set()
        self.state: Optional[str] = None
        self.t_done: Optional[float] = None
        # per-version exactly-once accounting: the LAST dispatch
        # target's version owns this request's terminal (mirrors the
        # live router, which counts only requests that reached a
        # replica)
        self.version: Optional[str] = None
        self.routed = False

    def past_deadline(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class SimReplica:
    __slots__ = ("rid", "host", "state", "lanes", "in_flight",
                 "generation", "version")

    def __init__(self, rid: int, host: "SimHost", state: str = READY,
                 version: Optional[str] = None):
        self.rid = rid               # fleet-unique: the JSQ tiebreak id
        self.host = host
        self.state = state
        self.lanes: Dict[Tuple[int, int], Deque[SimRequest]] = {}
        self.in_flight: List[SimRequest] = []
        self.generation = 0
        # export-store version this replica serves (None = the boot
        # store — the sim analog of Replica.version in serve/fleet.py)
        self.version = version

    def lane_depth(self, bucket: Tuple[int, int]) -> int:
        lane = self.lanes.get(bucket)
        return len(lane) if lane is not None else 0

    def depth(self) -> int:
        return (sum(len(q) for q in self.lanes.values())
                + len(self.in_flight))

    def queued(self) -> int:
        return sum(len(q) for q in self.lanes.values())


class SimHost:
    """One simulated agent host: registry + replicas + up/down state."""

    def __init__(self, index: int, boot_replicas: int,
                 next_rid: Callable[[], int]):
        self.index = index
        self.name = f"agent-{index}"
        self.up = True
        self.generation = 0
        self.registry = Registry()
        self.replicas: List[SimReplica] = [
            SimReplica(next_rid(), self) for _ in range(boot_replicas)]
        # rollout plane: versions this host has pulled, and in-progress
        # pulls (version -> virtual completion time).  Both reset on
        # relaunch — a fresh process re-pulls (the live agent's pull is
        # idempotent/resumable for the same reason)
        self.pulled: set = set()
        self.pulling: Dict[str, float] = {}
        # the version scheduler resizes build (the live agent repoints
        # this when a swap completes, so post-rollout adds stay v2)
        self.default_version: Optional[str] = None

    def ready_replicas(self) -> List[SimReplica]:
        return [r for r in self.replicas if r.state == READY]

    def resolve(self):
        """RegistrySource resolver: down host = None, exactly like a
        dead HttpSource — its gauges vanish from the next sample."""
        if not self.up:
            return None
        return self.registry, {"generation": self.generation}


class SimCluster:
    """The simulated fleet: hosts, routing, service, failure injection.

    All mutation happens inside kernel events (single thread, virtual
    time).  ``log`` is the harness's event sink — entries land in the
    deterministic decision log.
    """

    def __init__(self, kernel: SimKernel, cfg: Config, hosts: int,
                 log: Callable[..., None]):
        self.k = kernel
        self.cfg = cfg
        self.log = log
        self._rid = 0

        def next_rid() -> int:
            self._rid += 1
            return self._rid

        self._next_rid = next_rid
        per_host = max(int(cfg.crosshost.agent_replicas), 1)
        self.hosts: List[SimHost] = [
            SimHost(i, per_host, next_rid) for i in range(int(hosts))]
        self.head = Registry()
        self.buckets: List[Tuple[int, int]] = [
            tuple(b) for b in cfg.bucket.shapes]
        base = min(h * w for h, w in self.buckets)
        self._bucket_scale = {b: (b[0] * b[1]) / base
                              for b in self.buckets}
        self._svc_rng = kernel.rng("service")
        self._rot = 0                # JSQ tie-break rotation counter
        self._req_seq = 0
        # exact terminal accounting for the scorer (the head registry
        # carries the same totals; these stay ints with no scrape lag)
        self.stats = {"submitted": 0, "served": 0, "shed": 0,
                      "expired": 0, "failed": 0, "rerouted": 0}
        self.wait_ms_max = 0.0
        # rollout plane: the deterministic canary lane (mirrors
        # FleetRouter.set_canary's fraction accumulator) and exact
        # per-version terminal counts keyed by version label
        self._canary: Optional[Tuple[str, float]] = None
        self._canary_acc = 0.0
        self.ver_stats: Dict[str, Dict[str, int]] = {}

    # -- gauge surface (called by the harness before every scrape) --------

    def refresh_gauges(self) -> None:
        total_ready = 0
        hosts_up = 0
        for h in self.hosts:
            if not h.up:
                continue
            hosts_up += 1
            ready = len(h.ready_replicas())
            total_ready += ready
            h.registry.set_gauge("agent.replicas_ready", float(ready))
            for b in self.buckets:
                depth = sum(r.lane_depth(b) for r in h.replicas
                            if r.state in (READY, DRAINING))
                h.registry.set_gauge(f"lane.{b[0]}x{b[1]}.depth",
                                     float(depth))
        self.head.set_gauge("fleet.replicas_ready", float(total_ready))
        self.head.set_gauge("fleet.hosts_up", float(hosts_up))

    def ready_count(self) -> int:
        return sum(len(h.ready_replicas()) for h in self.hosts
                   if h.up)

    # -- request path ------------------------------------------------------

    def submit(self, bucket: Tuple[int, int]) -> SimRequest:
        now = self.k.clock.now
        self._req_seq += 1
        deadline_ms = self.cfg.serve.default_timeout_ms
        deadline = (now + deadline_ms / 1000.0) if deadline_ms else None
        req = SimRequest(self._req_seq, bucket, now, deadline)
        self.stats["submitted"] += 1
        self.head.inc("fleet.submitted")
        self._dispatch(req)
        return req

    def _candidates(self, req: SimRequest) -> List[SimReplica]:
        out = []
        for h in self.hosts:
            if not h.up:
                continue
            for r in h.replicas:
                if r.state == READY and r.rid not in req.tried:
                    out.append(r)
        return out

    def _dispatch(self, req: SimRequest) -> None:
        """Mirror of ``FleetRouter._dispatch``: deadline first, then
        JSQ over untried ready replicas, then watermark admission."""
        now = self.k.clock.now
        if req.past_deadline(now):
            self._settle(req, EXPIRED)
            return
        cands = self._candidates(req)
        if not cands:
            self._settle(req, FAILED)
            return
        cands = self._canary_lane(cands)
        batch = self.cfg.serve.batch_size
        self._rot += 1
        rot, n = self._rot, len(cands)
        target = min(cands,
                     key=lambda r: jsq_key(r.lane_depth(req.bucket),
                                           r.depth(), r.rid, rot, n,
                                           batch))
        req.tried.add(target.rid)
        req.attempts += 1
        req.version = target.version
        req.routed = True
        self._ver(version_label(req.version))["dispatched"] += 1
        self.head.inc(f"fleet.ver.{version_label(req.version)}"
                      ".dispatched")
        if target.lane_depth(req.bucket) >= self.cfg.serve.shed_watermark:
            # the least-loaded lane is at its watermark: the fleet is
            # saturated — terminal 429, no retry (fleet.py contract)
            target.host.registry.inc("serve.shed")
            self._settle(req, SHED)
            return
        target.host.registry.inc("serve.submitted")
        target.lanes.setdefault(req.bucket, deque()).append(req)
        self._maybe_start(target)

    def _maybe_start(self, r: SimReplica) -> None:
        if r.in_flight or r.state not in (READY, DRAINING):
            self._maybe_finish_drain(r)
            return
        now = self.k.clock.now
        batch_rows: List[SimRequest] = []
        # oldest waiter first (the engine's max_delay contract: no lane
        # starves behind a hot bucket), bucket order breaking ties
        for bucket in sorted(
                r.lanes,
                key=lambda b: ((r.lanes[b][0].t_arrive, b)
                               if r.lanes[b] else (float("inf"), b))):
            lane = r.lanes[bucket]
            while lane and len(batch_rows) < self.cfg.serve.batch_size:
                req = lane.popleft()
                if req.past_deadline(now):
                    # cancelled before dispatch: dead work never
                    # occupies a batch slot (engine contract)
                    r.host.registry.inc("serve.expired")
                    self._settle(req, EXPIRED)
                    continue
                batch_rows.append(req)
            if batch_rows:
                svc = self._service_s(bucket)
                r.in_flight = batch_rows
                self.k.after(svc, lambda rr=r: self._complete(rr))
                return
        self._maybe_finish_drain(r)

    def _service_s(self, bucket: Tuple[int, int]) -> float:
        sim = self.cfg.sim
        base = (sim.service_ms / 1000.0) * self._bucket_scale[bucket]
        jitter = float(self._svc_rng.lognormal(0.0, sim.service_jitter))
        return base * jitter

    def _complete(self, r: SimReplica) -> None:
        now = self.k.clock.now
        rows, r.in_flight = r.in_flight, []
        if r.state == DEAD:
            return  # the death path already rerouted these rows
        for req in rows:
            wait_ms = (now - req.t_arrive) * 1000.0
            self.wait_ms_max = max(self.wait_ms_max, wait_ms)
            r.host.registry.inc("serve.served")
            r.host.registry.observe("serve.total_ms", wait_ms)
            self.head.observe("fleet.total_ms", wait_ms)
            self._settle(req, SERVED)
        self._maybe_start(r)

    def _retry_or_fail(self, req: SimRequest) -> None:
        """Mirror of ``FleetRouter._retry_or_fail``: expiry outranks the
        death verdict; reroutes never extend the deadline."""
        if req.past_deadline(self.k.clock.now):
            self._settle(req, EXPIRED)
            return
        if req.attempts < 1 + max(self.cfg.fleet.reroute_retries, 0):
            self.stats["rerouted"] += 1
            self.head.inc("fleet.rerouted")
            self._dispatch(req)
            return
        self._settle(req, FAILED)

    def _ver(self, label: str) -> Dict[str, int]:
        return self.ver_stats.setdefault(
            label, {"dispatched": 0, "served": 0, "shed": 0,
                    "expired": 0, "failed": 0})

    def _canary_lane(self, cands: List[SimReplica]) -> List[SimReplica]:
        """Mirror of ``FleetRouter._canary_lane``: a deterministic
        fraction accumulator steers every Nth dispatch to the canary
        version; an empty lane falls back to the full candidate set
        (availability outranks canary purity), counted."""
        if self._canary is None:
            return cands
        version, fraction = self._canary
        self._canary_acc += fraction
        take = self._canary_acc >= 1.0
        if take:
            self._canary_acc -= 1.0
        lane = [r for r in cands if (r.version == version) == take]
        if not lane:
            self.head.inc("fleet.canary_fallback")
            return cands
        return lane

    def set_canary(self, version: Optional[str],
                   fraction: float) -> None:
        if version is None:
            self._canary = None
        else:
            self._canary = (version,
                            max(0.0, min(float(fraction), 1.0)))
        self._canary_acc = 0.0
        self.log("set_canary",
                 version=None if version is None
                 else version_label(version),
                 fraction=round(float(fraction), 4))

    def _settle(self, req: SimRequest, state: str) -> None:
        req.state = state
        req.t_done = self.k.clock.now
        key = state.lower()
        self.stats[key] += 1
        self.head.inc(f"fleet.{key}")
        if req.routed:
            lbl = version_label(req.version)
            self._ver(lbl)[key] += 1
            self.head.inc(f"fleet.ver.{lbl}.{key}")
            if state == SERVED:
                self.head.observe(
                    f"fleet.ver.{lbl}.total_ms",
                    (req.t_done - req.t_arrive) * 1000.0)

    # -- failure / actuation events ---------------------------------------

    def host_down(self, index: int) -> None:
        h = self.hosts[index]
        if not h.up:
            return
        h.up = False
        self.log("host_down", host=h.name)
        stranded: List[SimRequest] = []
        for r in h.replicas:
            r.state = DEAD
            stranded.extend(r.in_flight)
            r.in_flight = []
            for bucket in sorted(r.lanes):
                stranded.extend(r.lanes[bucket])
            r.lanes.clear()
        for req in stranded:
            self._retry_or_fail(req)

    def host_up(self, index: int) -> None:
        """Relaunch: fresh process → fresh registry (counters reset —
        the scheduler's negative-delta clamp exists for exactly this),
        replicas rewarm through the cold-join delay."""
        h = self.hosts[index]
        if h.up:
            return
        h.generation += 1
        h.registry = Registry()
        per_host = max(int(self.cfg.crosshost.agent_replicas), 1)
        h.replicas = [SimReplica(self._next_rid(), h, state=WARMING)
                      for _ in range(per_host)]
        # a fresh process boots from the boot store: pulled versions
        # are gone, replicas come up version-less (the FINALIZE
        # convergence path re-pulls and re-swaps them)
        h.pulled = set()
        h.pulling = {}
        h.default_version = None
        h.up = True
        self.log("host_up", host=h.name, generation=h.generation)
        for r in h.replicas:
            self.k.after(self.cfg.sim.warmup_s,
                         lambda rr=r: self._replica_ready(rr))

    def _replica_ready(self, r: SimReplica) -> None:
        if r.state != WARMING or not r.host.up:
            return
        r.state = READY
        self.log("replica_ready", host=r.host.name, replica=r.rid)
        self._maybe_start(r)

    def resize(self, index: int, delta: int) -> Optional[Dict]:
        """The agent's ``POST /replicas`` semantics: +1 warms a new
        replica, -1 drains one — clamped at one live replica per host
        (a live host always keeps a warm engine)."""
        h = self.hosts[index]
        if not h.up:
            return None
        if delta >= 1:
            r = SimReplica(self._next_rid(), h, state=WARMING,
                           version=h.default_version)
            h.replicas.append(r)
            self.k.after(self.cfg.sim.warmup_s,
                         lambda rr=r: self._replica_ready(rr))
            return {"ok": True, "replicas": len(h.replicas)}
        ready = h.ready_replicas()
        if len(ready) <= 1:
            return {"ok": False, "error": "refusing to drain below one "
                                          "replica"}
        # drain the emptiest ready replica (cheapest to finish out)
        r = min(ready, key=lambda x: (x.depth(), x.rid))
        r.state = DRAINING
        self._maybe_finish_drain(r)
        return {"ok": True, "replicas": len(h.replicas)}

    def _maybe_finish_drain(self, r: SimReplica) -> None:
        if (r.state == DRAINING and not r.in_flight
                and r.queued() == 0):
            r.state = DEAD
            if r in r.host.replicas:
                r.host.replicas.remove(r)
            self.log("replica_drained", host=r.host.name,
                     replica=r.rid)

    def drain_host(self, index: int) -> None:
        """Rolling-update step: stop admissions on every replica, let
        queues finish, go dark, relaunch after ``sim.relaunch_s``."""
        h = self.hosts[index]
        if not h.up:
            return
        self.log("drain_host", host=h.name)
        for r in h.replicas:
            if r.state in (READY, WARMING):
                r.state = DRAINING
                self._maybe_finish_drain(r)
        self._watch_drain(index)

    def _watch_drain(self, index: int) -> None:
        h = self.hosts[index]
        if not h.up:
            return
        if any(r.in_flight or r.queued() for r in h.replicas):
            self.k.after(0.5, lambda: self._watch_drain(index))
            return
        h.up = False
        h.replicas = []
        self.log("host_dark", host=h.name)
        self.k.after(self.cfg.sim.relaunch_s,
                     lambda: self.host_up(index))

    # -- rollout plane (SimRolloutPort verbs) ------------------------------

    def pull_version(self, index: int, version: str) -> Optional[Dict]:
        """The agent's ``/rollout op=pull``: idempotent, takes
        ``rollout.pull_s`` virtual seconds the first time (returning
        None while in flight — the controller's retry/defer machinery
        owns the wait, exactly as live)."""
        h = self.hosts[index]
        if not h.up:
            return None
        if version in h.pulled:
            return {"ok": True, "version": version, "already": True}
        now = self.k.clock.now
        t_done = h.pulling.get(version)
        if t_done is None:
            h.pulling[version] = now + self.cfg.rollout.pull_s
            self.log("pull_start", host=h.name,
                     version=version_label(version))
            return None
        if now < t_done:
            return None
        del h.pulling[version]
        h.pulled.add(version)
        self.log("pulled", host=h.name, version=version_label(version))
        return {"ok": True, "version": version, "already": False}

    def host_versions(self, index: int) -> Optional[Dict[str, int]]:
        """``{version_label: ready_count}`` — the agent's rollout
        status surface; None when the host is down."""
        h = self.hosts[index]
        if not h.up:
            return None
        out: Dict[str, int] = {}
        for r in h.replicas:
            if r.state == READY:
                lbl = version_label(r.version)
                out[lbl] = out.get(lbl, 0) + 1
        return out

    def swap_replica(self, index: int, version: str) -> Optional[Dict]:
        """One pump of the agent's rolling replace toward ``version``.
        An unpulled version answers None (a relaunched host lost its
        pull — the controller defers and FINALIZE re-converges)."""
        h = self.hosts[index]
        if not h.up or version not in h.pulled:
            return None
        return self._pump_host(h, version)

    def rollback_host(self, index: int) -> Optional[Dict]:
        """One pump back toward the boot (version-less) store."""
        h = self.hosts[index]
        if not h.up:
            return None
        return self._pump_host(h, None)

    def _pump_host(self, h: SimHost,
                   version: Optional[str]) -> Dict:
        """The agent's ``_pump_toward`` reduced to sim state: add ONE
        warming target replica (bounded to +1 over the boot count),
        then — once a target replica is ready — gracefully drain ONE
        old replica, repeat.  Never drops below one ready replica;
        draining replicas finish their queues (exactly-once)."""
        per_host = max(int(self.cfg.crosshost.agent_replicas), 1)
        tgt = [r for r in h.replicas
               if r.version == version and r.state in (READY, WARMING)]
        tgt_ready = [r for r in tgt if r.state == READY]
        old = [r for r in h.replicas
               if r.version != version and r.state in (READY, WARMING)]
        added = swapped = None
        if len(tgt) < per_host and len(tgt) + len(old) <= per_host:
            r = SimReplica(self._next_rid(), h, state=WARMING,
                           version=version)
            h.replicas.append(r)
            self.k.after(self.cfg.sim.warmup_s,
                         lambda rr=r: self._replica_ready(rr))
            added = r.rid
            self.log("swap_add", host=h.name, replica=r.rid,
                     version=version_label(version))
        elif old and tgt_ready:
            old_ready = [r for r in old if r.state == READY]
            if old_ready:
                victim = min(old_ready,
                             key=lambda x: (x.depth(), x.rid))
                victim.state = DRAINING
                swapped = victim.rid
                self.log("swap_drain", host=h.name,
                         replica=victim.rid,
                         version=version_label(victim.version))
                self._maybe_finish_drain(victim)
        remaining = sum(1 for r in h.replicas
                        if r.version != version
                        and r.state in (READY, WARMING, DRAINING))
        pending = sum(1 for r in h.replicas
                      if r.version == version and r.state == WARMING)
        if remaining == 0 and pending == 0:
            # swap complete: future scheduler resizes build this
            # version (the live agent repoints manager._build_fn)
            h.default_version = version
        return {"remaining": remaining, "pending": pending,
                "added": added, "swapped": swapped}

    # -- quiescence --------------------------------------------------------

    def pending(self) -> int:
        return sum(r.queued() + len(r.in_flight)
                   for h in self.hosts for r in h.replicas)

    def fail_pending(self) -> int:
        """End-of-settle cleanup: anything still queued after the settle
        budget is honestly lost."""
        n = 0
        for h in self.hosts:
            for r in h.replicas:
                for req in list(r.in_flight):
                    self._settle(req, FAILED)
                    n += 1
                r.in_flight = []
                for bucket in sorted(r.lanes):
                    for req in r.lanes[bucket]:
                        self._settle(req, FAILED)
                        n += 1
                r.lanes.clear()
        return n
