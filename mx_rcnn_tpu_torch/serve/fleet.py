"""The serving fleet: a replica manager behind a join-shortest-queue
router.

Counterpart of ``mx_rcnn_tpu/serve/fleet.py``.  N replicas, each a
:class:`~mx_rcnn_tpu_torch.serve.engine.ServingEngine` over a
``Predictor`` of its own on its own cards, behind a router that:

* **spreads load** by batch-aware join-shortest-queue (:func:`jsq_key`):
  first the batch cycles ahead in the request's own bucket lane, so
  same-bucket traffic packs full batches, then the replica's in-flight
  depth, then a rotating index;
* **keeps the engines' overload semantics**: deadlines belong to the
  fleet (a reroute never extends one, and a request that expired while
  being routed ends EXPIRED before it reaches a replica), and JSQ routes
  to the least loaded replica, so its watermark shed means every replica
  is at its watermark: the fleet answers 429;
* **ends every request once, fleet-wide**: a replica that dies FAILs its
  queued work and the router re-dispatches it within its deadline, up to
  ``fleet.reroute_retries`` times, then fails it;
* **ejects and relaunches**: a health loop removes dead replicas from
  the routing set, kills their stranded queue (which reroutes) and
  rebuilds them on the ``ft/supervisor.py — RestartPolicy`` schedule in
  a thread of their own; identical launch failures end in a crash-loop
  verdict.

The port's differences:

* each replica builds its own ``Predictor`` on its card from one shared
  host copy of the weights (the JAX-layout variables tree,
  ``serve/export.py — predictor_from_variables``); a replica whose
  subset holds several cards splits each batch across them when it
  warms by running, and an export-warmed one runs on its subset's first
  card, as in the JAX package;
* an ejected replica drops its engine at once (a scrape reads it down),
  and its relaunch thread joins the dead engine's dispatchers and
  collects it before the new weights go to the card, so a relaunch never
  holds two copies of a replica's model;
* every replica on a card launches on that card's default stream, as a
  single engine does;
* a replica joins from an export store (``warm_from_export``: the store's
  kernel libraries, so a process whose ``_build/`` is empty builds no
  kernel) or by running its warm-up (which builds K1 and K2 where they
  are not built yet).

:class:`FleetRouter` has the engine's ``submit`` / ``detect`` /
``healthz`` / ``metrics`` surface, so ``serve/server.py — make_server``
serves a fleet as it serves an engine.
"""

from __future__ import annotations

import gc
import itertools
import logging
import re
import threading
import time
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.metrics import Registry, ServeMetrics
from mx_rcnn_tpu_torch.obs.metrics import registry as process_registry
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.queue import (EXPIRED, FAILED, SERVED, SHED,
                                           RequestFailed, ServeRequest)

logger = logging.getLogger("mx_rcnn_tpu_torch")

# drain_replica's "any version" (None is a real version: the boot model)
_ANY_VERSION = object()

# replica lifecycle states (healthz-visible)
R_STARTING = "starting"
R_READY = "ready"
R_EJECTED = "ejected"
R_RELAUNCHING = "relaunching"
R_DEAD = "dead"          # crash-loop verdict, or relaunch off


def version_label(version: Optional[str]) -> str:
    """The metric-safe label of a model version, ``base`` for the boot
    model: the ``<label>`` of ``fleet.ver.<label>.*`` (the JAX package
    keeps it in ``serve/rollout.py``)."""
    if not version:
        return "base"
    return re.sub(r"[^0-9A-Za-z_.-]", "_", str(version))


def jsq_key(lane_depth: int, total_depth: int, rid: int, rot: int,
            n_cands: int, batch: int) -> Tuple[int, int, int]:
    """Batch-aware JSQ sort key; the router takes the smallest.
    ``ceil((lane_depth + 1) / batch)`` dispatch cycles until a request
    appended to this lane serves, then the total in-flight depth, then a
    rotating index."""
    cycles = -(-(int(lane_depth) + 1) // int(batch))
    return (cycles, int(total_depth), (int(rid) + int(rot)) % int(n_cands))


class FleetMetrics(ServeMetrics):
    """The router's request accounting: :class:`ServeMetrics`' counters,
    histograms and snapshot under the ``fleet.`` prefix.  Replica engines
    keep their ``serve.`` metrics in private registries, so the two never
    add up in one scrape."""

    PREFIX = "fleet."


class FleetRequest(ServeRequest):
    """The client's handle: one terminal state, fleet-wide.

    ``image`` is the client's raw image (each dispatch preprocesses on
    its replica), a prepared canvas (``prepared``: ``submit_prepared``)
    or a resized uint8 source (``source``: ``submit_source``); it is
    dropped at the terminal transition."""

    __slots__ = ("attempts", "tried", "replica_id", "prepared", "source",
                 "version", "tparent", "history")

    def __init__(self, image: np.ndarray, deadline: Optional[float],
                 now: float, im_info: np.ndarray = None,
                 bucket: Tuple[int, int] = None, prepared: bool = False,
                 source: bool = False):
        super().__init__(image, im_info, bucket, deadline, now)
        self.attempts = 0          # dispatches so far (1 = no reroute)
        self.tried: set = set()    # replica ids dispatched to
        self.replica_id: Optional[int] = None  # the last target
        # one [replica id, dispatch time, end time, inner state] a
        # dispatch (monotonic clock; the end and state once it ended,
        # "ejected" where the replica lost its engine before the send)
        self.history: List[list] = []
        self.version: Optional[str] = None     # the last target's version
        self.prepared = prepared
        self.source = source
        # the span the request's root span nests under (0: this head
        # began the trace)
        self.tparent = 0


class Replica:
    """One managed replica: its engine, lifecycle and restart pacing.

    ``build_fn(replica_id) -> (engine, join)`` builds a warm engine.
    Every state change is made under ``_lock``.  ``version`` (None: the
    boot model) tags the model version this replica serves."""

    version: Optional[str] = None

    def __init__(self, rid: int,
                 build_fn: Callable[[int], Tuple[ServingEngine, Dict]],
                 policy=None):
        from mx_rcnn_tpu_torch.ft.supervisor import RestartPolicy

        self.id = rid
        self.build_fn = build_fn
        self.engine: Optional[ServingEngine] = None
        # an ejected engine, until its relaunch (or close) joins it
        self.dead_engine: Optional[ServingEngine] = None
        self.state = R_STARTING
        self.closed = False        # the manager closed: launches refuse
        self.generation = 0        # successful launches
        self.joins: List[Dict] = []
        self.relaunch_at: Optional[float] = None
        # a private registry: N policies would share the ft.supervisor.*
        # gauge names
        self.policy = policy or RestartPolicy(seed=rid,
                                              registry=Registry())
        self._lock = threading.RLock()

    def launch(self) -> bool:
        """Build and warm the engine (blocking); returns success, and the
        caller paces failures."""
        with self._lock:
            if self.closed:
                return False
            self.state = R_STARTING
        try:
            t0 = time.perf_counter()
            engine, join = self.build_fn(self.id)
        except Exception:
            logger.exception("replica %d launch failed", self.id)
            with self._lock:
                self.engine = None
            return False
        join = dict(join or {})
        join["join_s"] = round(time.perf_counter() - t0, 3)
        join["ready_t"] = time.monotonic()
        with self._lock:
            # the manager closed while this build ran: a late READY would
            # bring back a replica nobody closes
            stale = engine if self.closed else None
            if stale is None:
                self.engine = engine
                self.generation += 1
                self.joins.append(join)
                self.state = R_READY
            else:
                self.state = R_DEAD
        if stale is not None:
            stale.close()
            return False
        logger.info("replica %d ready (generation %d, join %.2fs, %s)",
                    self.id, self.generation, join["join_s"],
                    "export-warm" if join.get("export_root")
                    else "trace-warm")
        return True

    def ready(self) -> bool:
        with self._lock:
            return self.state == R_READY and self.engine is not None

    def depth(self) -> float:
        """The JSQ signal; an unready replica reads infinitely deep."""
        with self._lock:
            if self.state != R_READY or self.engine is None:
                return float("inf")
            return self.engine.depth()

    def describe(self) -> Dict:
        with self._lock:
            eng = self.engine
            d = {"id": self.id, "state": self.state,
                 "generation": self.generation,
                 "version": self.version,
                 "last_join_s": (self.joins[-1]["join_s"]
                                 if self.joins else None)}
            if eng is not None and self.state == R_READY:
                d["depth"] = eng.depth()
                d["programs"] = eng.program_count()
                d["export_root"] = eng._export_root
            return d

    def take_dead_engine(self) -> Optional[ServingEngine]:
        with self._lock:
            eng, self.dead_engine = self.dead_engine, None
        return eng


class ReplicaManager:
    """The replica set: boot, health monitoring, eject, relaunch.

    The health loop (every ``fleet.health_interval_s``) ejects a replica
    whose engine died (closed, or a bucket dispatcher gone), kills its
    stranded queue (FAILED: the router reroutes) and relaunches it on the
    RestartPolicy schedule in a thread of its own, so a slow rebuild never
    blinds the monitor.  A dead generation that served at least one
    request counts as progress for the policy, so a replica that keeps
    dying before its first serve reaches the crash-loop verdict.
    """

    def __init__(self, build_fn: Callable[[int], Tuple[ServingEngine, Dict]],
                 cfg: Config, registry: Registry = None, record=None,
                 replica_cls: type = None):
        if cfg.fleet.replicas < 1:
            raise ValueError(
                f"fleet.replicas must be >= 1, got {cfg.fleet.replicas}")
        self.cfg = cfg
        self._replica_cls = replica_cls or Replica
        self._build_fn = build_fn
        # the version a plain add_replica is tagged with
        self.default_version: Optional[str] = None
        self.replicas = [self._replica_cls(i, build_fn)
                         for i in range(cfg.fleet.replicas)]
        # add/drain change the list only under this lock; readers iterate
        # copies
        self._resize_lock = threading.Lock()
        self._next_rid = cfg.fleet.replicas
        self.registry = registry or process_registry()
        # an optional RunRecord (obs/runrec.py): ejects and rejoins land
        # in its events, and through its listeners in a flight dump
        self.record = record
        self.ejects = 0
        self.relaunches = 0
        # what drained replicas did (engine batches served, warm
        # launches), so the set's totals outlive a rolling swap
        self.retired = {"batches": 0, "generations": 0}
        # the monitor and the relaunch threads bump these concurrently
        self._counts_lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # ---- lifecycle ------------------------------------------------------------

    def start(self) -> "ReplicaManager":
        """Launch every replica, one after another (their warm-ups share
        the host's cores), then start the health monitor."""
        for r in self.replicas:
            if not r.launch():
                self._schedule_relaunch(r, ("boot-failed",),
                                        made_progress=False)
        self._monitor = threading.Thread(target=self._health_loop,
                                         name="fleet-health", daemon=True)
        self._monitor.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout)
        for r in list(self.replicas):
            with r._lock:
                r.closed = True
                eng, r.engine, r.state = r.engine, None, R_DEAD
            for e in (eng, r.take_dead_engine()):
                if e is not None:
                    e.close(timeout)

    # ---- the routing set ------------------------------------------------------

    def ready_replicas(self) -> List[Replica]:
        return [r for r in list(self.replicas) if r.ready()]

    def versions(self) -> Dict[str, int]:
        """Ready replicas per model-version label (``base``: the boot
        version)."""
        out: Dict[str, int] = {}
        for r in self.ready_replicas():
            lbl = version_label(r.version)
            out[lbl] = out.get(lbl, 0) + 1
        return out

    def totals(self) -> Dict[str, int]:
        """Engine batches served and warm launches made by this set,
        drained replicas' included (a rolling swap retires replicas but
        not what they did)."""
        with self._counts_lock:
            batches = self.retired["batches"]
            warms = self.retired["generations"]
        for r in list(self.replicas):
            with r._lock:
                eng = r.engine
                warms += r.generation
            if eng is not None:
                batches += eng.metrics.counters["batches"]
        return {"batches": batches, "warms": warms}

    # ---- resize ---------------------------------------------------------------

    def add_replica(self, build_fn: Callable = None,
                    version: str = None) -> Replica:
        """Grow the set by one replica with a fresh id (ids are never
        reused).  Its launch runs on a thread of its own; a boot failure
        goes to the RestartPolicy schedule.  ``build_fn`` and ``version``
        build it from another store, tagged with that version; by default
        it takes the boot build and ``default_version``."""
        with self._resize_lock:
            rid = self._next_rid
            self._next_rid += 1
            r = self._replica_cls(rid, build_fn or self._build_fn)
            r.version = (version if (version is not None
                                     or build_fn is not None)
                         else self.default_version)
            self.replicas.append(r)
        if self.record is not None:
            self.record.event("fleet_scale", action="add", replica=rid,
                              version=version)

        def boot():
            if not r.launch():
                self._schedule_relaunch(r, ("boot-failed",),
                                        made_progress=False)

        threading.Thread(target=boot, name=f"fleet-add-{rid}",
                         daemon=True).start()
        return r

    def drain_replica(self, rid: int = None,
                      version=_ANY_VERSION) -> Optional[int]:
        """Shrink the set by one replica: out of routing first, then its
        engine drain-closed (queued work is served).  By default the
        highest-id ready replica, of ``version`` when given.  The last
        replica is never drained.  Returns the drained id, or None."""
        with self._resize_lock:
            if len(self.replicas) <= 1:
                return None
            if rid is None:
                cands = [r for r in self.replicas if r.ready()]
                if version is not _ANY_VERSION:
                    cands = [r for r in cands if r.version == version]
                if not cands:
                    return None
                r = max(cands, key=lambda x: x.id)
            else:
                matches = [x for x in self.replicas if x.id == rid]
                if not matches:
                    return None
                r = matches[0]
            self.replicas.remove(r)
        with r._lock:
            r.closed = True
            eng, r.engine, r.state = r.engine, None, R_DEAD
        batches = 0
        for e in (eng, r.take_dead_engine()):
            if e is not None:
                e.close()
                batches += e.metrics.counters["batches"]
        with self._counts_lock:
            self.retired["batches"] += batches
            self.retired["generations"] += r.generation
        # frozen per-replica gauges would read as a live replica forever
        self.registry.reset(f"fleet.replica{r.id}.")
        if self.record is not None:
            self.record.event("fleet_scale", action="drain", replica=r.id)
        return r.id

    # ---- health ---------------------------------------------------------------

    def _health_loop(self) -> None:
        interval = max(self.cfg.fleet.health_interval_s, 0.05)
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:  # the monitor must never die silently
                logger.exception("fleet health tick failed")

    def tick(self, now: float = None) -> None:
        """One health pass (public, so tests drive it without the
        loop)."""
        now = time.monotonic() if now is None else now
        for r in list(self.replicas):
            with r._lock:
                state, eng, due = r.state, r.engine, r.relaunch_at
            if state == R_READY and (eng is None or not eng.alive()):
                self.eject(r, "engine-dead")
            elif state == R_RELAUNCHING and due is not None and now >= due:
                with r._lock:
                    if r.state != R_RELAUNCHING or r.relaunch_at != due:
                        continue  # another pass took it
                    r.relaunch_at = None
                threading.Thread(target=self._relaunch, args=(r,),
                                 name=f"fleet-relaunch-{r.id}",
                                 daemon=True).start()
        self.export_gauges()

    def eject(self, r: Replica, reason: str) -> None:
        """Take a replica out of the routing set, drop its engine, kill
        the engine's stranded queue (FAILED: the router reroutes it), and
        schedule the relaunch."""
        with r._lock:
            if r.state not in (R_READY, R_STARTING):
                return
            r.state = R_EJECTED
            eng, r.engine = r.engine, None
            if eng is not None:
                r.dead_engine = eng
        with self._counts_lock:
            self.ejects += 1
        served = 0
        if eng is not None:
            eng.kill()
            served = eng.metrics.counters["served"]
        logger.warning("replica %d ejected (%s) after serving %d "
                       "requests this generation", r.id, reason, served)
        if self.record is not None:
            self.record.event("fleet_eject", replica=r.id, reason=reason,
                              generation=r.generation, served=served)
        self._schedule_relaunch(r, (reason,), made_progress=served > 0)

    def _schedule_relaunch(self, r: Replica, signature: tuple,
                           made_progress: bool) -> None:
        if not self.cfg.fleet.relaunch:
            with r._lock:
                r.state = R_DEAD
            return
        delay, give_up = r.policy.record(signature, made_progress)
        with r._lock:
            if give_up or r.closed:
                r.state = R_DEAD
                return
            r.state = R_RELAUNCHING
            r.relaunch_at = time.monotonic() + delay

    def _relaunch(self, r: Replica) -> None:
        with self._counts_lock:
            self.relaunches += 1
        # the dead engine's batch in flight finishes, its dispatchers
        # exit, and its model leaves the card before the new one arrives
        dead = r.take_dead_engine()
        if dead is not None:
            dead.close()
            del dead
            gc.collect()
        if r.launch():
            r.policy.record(("rejoined",), made_progress=True)
            logger.info("replica %d rejoined the fleet", r.id)
            if self.record is not None:
                self.record.event("fleet_rejoin", replica=r.id,
                                  generation=r.generation)
        else:
            self._schedule_relaunch(r, ("launch-failed",),
                                    made_progress=False)

    def export_gauges(self) -> None:
        """The fleet's state as registry gauges: replicas and ready
        replicas, ejects, relaunches, and each replica's depth (-1: not
        ready) and generation."""
        g = self.registry.set_gauge
        replicas = list(self.replicas)
        g("fleet.replicas", len(replicas))
        g("fleet.replicas_ready", len(self.ready_replicas()))
        g("fleet.ejects", self.ejects)
        g("fleet.relaunches", self.relaunches)
        for r in replicas:
            d = r.depth()
            g(f"fleet.replica{r.id}.depth",
              -1.0 if d == float("inf") else d)
            g(f"fleet.replica{r.id}.generation", r.generation)


class FleetRouter:
    """The fleet's front end, with a :class:`ServingEngine`'s surface
    (``submit``, ``submit_prepared``, ``submit_source``, ``detect``,
    ``healthz``, ``metrics``, ``close``)."""

    def __init__(self, manager: ReplicaManager, cfg: Config,
                 metrics: FleetMetrics = None):
        self.manager = manager
        self.cfg = cfg
        self.metrics = metrics or FleetMetrics()
        self._rr = itertools.count()  # the JSQ tie-break rotation
        # the head's sampling of distributed traces (0: none, and the hot
        # path pays one None check per seam)
        obs_trace.configure_distributed(
            sample=cfg.obs.trace_sample, ring=cfg.obs.trace_ring,
            slow_pct=cfg.obs.trace_slow_pct)
        # the canary version lane: (version, fraction) or None.  Request
        # k goes to the canary iff floor(k*f) > floor((k-1)*f), so the
        # choice is deterministic
        self._canary_lock = threading.Lock()
        self._canary: Optional[Tuple[str, float]] = None
        self._canary_acc = 0.0

    # ---- the canary lane ---------------------------------------------------

    def set_canary(self, version: Optional[str], fraction: float) -> None:
        """Route ``fraction`` of admitted traffic to replicas of
        ``version`` and the rest elsewhere; ``version=None`` clears the
        lane, and fraction 0.0 starves that version of new work."""
        with self._canary_lock:
            if version is None:
                self._canary = None
            else:
                self._canary = (version,
                                max(0.0, min(1.0, float(fraction))))
            self._canary_acc = 0.0

    def canary(self) -> Optional[Tuple[str, float]]:
        with self._canary_lock:
            return self._canary

    def _canary_lane(self, cands: List[Replica]) -> List[Replica]:
        """The candidates of the lane this request falls in; an empty
        lane falls back to all of them (counted: ``canary_fallback``)."""
        with self._canary_lock:
            if self._canary is None:
                return cands
            version, fraction = self._canary
            self._canary_acc += fraction
            take = self._canary_acc >= 1.0
            if take:
                self._canary_acc -= 1.0
        lane = [r for r in cands if (r.version == version) == take]
        if lane:
            return lane
        self.metrics.count("canary_fallback")
        return cands

    def _count_version(self, freq: FleetRequest, state: str,
                       ms: float = None) -> None:
        """``fleet.ver.<label>.<state>`` for a request that reached a
        replica, under the version of its last dispatch target, in the
        manager's (scraped) registry."""
        if freq.replica_id is None:
            return
        lbl = version_label(freq.version)
        reg = (self.manager.registry
               if self.manager.registry is not None
               else self.metrics.registry)
        reg.inc(f"fleet.ver.{lbl}.{state}")
        if ms is not None:
            reg.observe(f"fleet.ver.{lbl}.total_ms", ms)

    # ---- the request path ----------------------------------------------------

    def _deadline(self, now: float, timeout_ms: float = None):
        t = (self.cfg.serve.default_timeout_ms if timeout_ms is None
             else timeout_ms)
        return now + t / 1000.0 if t and t > 0 else None

    def _admit(self, freq: FleetRequest, tctx) -> FleetRequest:
        self._trace_admit(freq, tctx)
        self.metrics.count("submitted")
        self._dispatch(freq)
        return freq

    def submit(self, img: np.ndarray, timeout_ms: float = None,
               tctx: "obs_trace.TraceContext" = None) -> FleetRequest:
        """Admit one image fleet-wide; the handle has the engine's
        ``wait()`` and states.  ``tctx``: an inbound trace context (None
        lets the head's sampler decide)."""
        now = time.monotonic()
        return self._admit(FleetRequest(img, self._deadline(now, timeout_ms),
                                        now), tctx)

    def submit_prepared(self, data: np.ndarray, im_info: np.ndarray,
                        bucket: Tuple[int, int], timeout_ms: float = None,
                        tctx: "obs_trace.TraceContext" = None
                        ) -> FleetRequest:
        """Admit one preprocessed canvas (the bulk tier's rows) into its
        bucket lane fleet-wide: :meth:`submit`'s routing, deadline,
        reroute and accounting; a reroute offers the same canvas."""
        now = time.monotonic()
        freq = FleetRequest(
            np.asarray(data), self._deadline(now, timeout_ms), now,
            im_info=np.asarray(im_info, np.float32), bucket=tuple(bucket),
            prepared=True)
        return self._admit(freq, tctx)

    def submit_source(self, img: np.ndarray, im_info: np.ndarray,
                      bucket: Tuple[int, int], timeout_ms: float = None,
                      tctx: "obs_trace.TraceContext" = None
                      ) -> FleetRequest:
        """Admit one resized, unnormalised uint8 image whose bucket is
        resolved: :meth:`submit_prepared`'s path, each dispatch offering
        the same source bytes."""
        now = time.monotonic()
        return self._admit(FleetRequest(
            np.asarray(img), self._deadline(now, timeout_ms), now,
            im_info=np.asarray(im_info, np.float32), bucket=tuple(bucket),
            source=True), tctx)

    @staticmethod
    def _trace_admit(freq: FleetRequest,
                     tctx: "obs_trace.TraceContext") -> None:
        """The request's trace root: an inbound context is adopted, else
        the head's sampler decides; an untraced request keeps ``tctx``
        None."""
        if tctx is None:
            tctx = obs_trace.sample_trace()
        if tctx is None:
            return
        root_sid = obs_trace.new_span_id()
        freq.tparent = tctx.parent
        # every attempt and terminal span nests under the root span
        freq.tctx = obs_trace.TraceContext(tctx.trace_id, root_sid,
                                           tctx.hop, tctx.sampled)

    def _finish_trace(self, freq: FleetRequest, state: str) -> None:
        """At the fleet terminal: the root ``request`` span, then the tail
        retention (every non-SERVED or rerouted request kept, the slowest
        SERVED ones)."""
        ctx = freq.tctx
        if ctx is None:
            return
        total_ms = (freq.done_t - freq.enqueue_t) * 1e3
        obs_trace.record_span(ctx, "request", total_ms,
                              span_id=ctx.parent, parent=freq.tparent,
                              state=state, attempts=freq.attempts)
        keep = obs_trace.retain_trace(state.upper(), total_ms=total_ms,
                                      attempts=freq.attempts)
        obs_trace.close_trace(ctx, keep=keep, state=state,
                              attempts=freq.attempts,
                              total_ms=round(total_ms, 3))

    def detect(self, img: np.ndarray, timeout_ms: float = None):
        req = self.submit(img, timeout_ms=timeout_ms)
        wait_s = None
        if req.deadline is not None:
            wait_s = max(req.deadline - time.monotonic(), 0.0) + 30.0
        return req.wait(timeout=wait_s)

    def _route_bucket(self, freq: FleetRequest) -> Tuple[int, int]:
        """The request's bucket from its dims (the engine's pre-admission
        estimate), computed once."""
        if freq.bucket is None:
            from mx_rcnn_tpu_torch.data.image import estimate_bucket

            h, w = freq.image.shape[:2]
            freq.bucket = estimate_bucket(
                h, w, self.cfg.bucket.scale, self.cfg.bucket.max_size,
                [tuple(b) for b in self.cfg.bucket.shapes])
        return freq.bucket

    def _end(self, freq: FleetRequest, state: str, **kw) -> None:
        """Terminate ``freq`` in ``state`` (if not terminal yet) with its
        accounting; a SERVED request's latency goes to ``total_ms``."""
        if freq._finish(state, **kw):
            self.metrics.count(state)
            ms = None
            if state == SERVED:
                ms = (freq.done_t - freq.enqueue_t) * 1e3
                self.metrics.observe("total_ms", ms)
            self._count_version(freq, state, ms=ms)
            self._finish_trace(freq, state)
            freq.image = None

    def _dispatch(self, freq: FleetRequest) -> None:
        """Route (or reroute) one request: the deadline first (a request
        expired while being routed ends EXPIRED and takes no replica
        slot), then batch-aware JSQ over the ready replicas it has not
        tried."""
        now = time.monotonic()
        if freq.expired(now):
            self._end(freq, EXPIRED)
            return
        cands = [r for r in self.manager.ready_replicas()
                 if r.id not in freq.tried]
        if not cands:
            self._end(freq, FAILED, error=RequestFailed(
                "no ready replica to serve this request "
                f"(tried {sorted(freq.tried) or 'none'})"))
            return
        cands = self._canary_lane(cands)
        bucket = self._route_bucket(freq)
        batch = self.cfg.serve.batch_size
        rot = next(self._rr)

        def _score(r: Replica):
            with r._lock:
                eng = r.engine if r.state == R_READY else None
            if eng is None:
                return (float("inf"), float("inf"), 0)
            return jsq_key(eng.bucket_depth(bucket), r.depth(), r.id,
                           rot, len(cands), batch)

        target = min(cands, key=_score)
        freq.tried.add(target.id)
        freq.attempts += 1
        freq.replica_id = target.id
        freq.history.append([target.id, now, None, None])
        freq.version = target.version
        self._count_version(freq, "dispatched")
        with target._lock:
            eng = target.engine if target.state == R_READY else None
        if eng is None:  # lost the race with an eject: try the rest
            freq.history[-1][2:] = [now, "ejected"]
            self._dispatch(freq)
            return
        remaining_ms = (0.0 if freq.deadline is None
                        else max((freq.deadline - now) * 1000.0, 0.001))
        # each dispatch gets its own fleet.attempt span under the root
        kw = {"timeout_ms": remaining_ms}
        if freq.tctx is not None:
            kw["tctx"] = freq.tctx.child(obs_trace.new_span_id())
        if freq.source:
            inner = eng.submit_source(freq.image, freq.im_info, freq.bucket,
                                      **kw)
        elif freq.prepared:
            inner = eng.submit_prepared(freq.image, freq.im_info,
                                        freq.bucket, **kw)
        else:
            inner = eng.submit(freq.image, **kw)
        inner.add_done_callback(
            lambda done, _freq=freq, _eng=eng:
            self._on_inner_done(_freq, done, _eng))

    def _on_inner_done(self, freq: FleetRequest, inner: ServeRequest,
                       eng: ServingEngine = None) -> None:
        """An inner terminal becomes the fleet terminal, or a reroute.
        Runs on the thread that ended the inner request (a dispatcher,
        the health monitor through ``engine.kill``, or the submitter for
        an immediate shed), and is the only place a dispatched fleet
        request ends."""
        state = inner.state
        if freq.history:
            freq.history[-1][2:] = [inner.done_t, state]
        if inner.tctx is not None:
            obs_trace.record_span(
                freq.tctx, "fleet.attempt",
                (inner.done_t - inner.enqueue_t) * 1e3,
                span_id=inner.tctx.parent, replica=freq.replica_id,
                attempt=freq.attempts, state=state)
        if state == SERVED:
            freq.batch_rows = inner.batch_rows
            self._end(freq, SERVED, result=inner.result)
        elif state == SHED:
            if eng is not None and eng._closed:
                # not a watermark shed: the engine was killed or closed
                # while this request was being submitted
                self._retry_or_fail(freq, inner)
                return
            # JSQ chose the least loaded replica: the fleet is saturated
            self._end(freq, SHED)
        elif state == EXPIRED:
            self._end(freq, EXPIRED)
        else:  # FAILED: the replica died under it, or its batch failed
            self._retry_or_fail(freq, inner)

    def _retry_or_fail(self, freq: FleetRequest,
                       inner: ServeRequest) -> None:
        """Re-dispatch a replica failure within the deadline and the
        retry budget.  Past its deadline the request ends EXPIRED: a
        living replica would have cancelled it at take."""
        if freq.expired(time.monotonic()):
            self._end(freq, EXPIRED)
            return
        if freq.attempts < 1 + max(self.cfg.fleet.reroute_retries, 0):
            self.metrics.count("rerouted")
            self._dispatch(freq)
        else:
            self._end(freq, FAILED, error=inner.error)

    # ---- status -----------------------------------------------------------------

    def healthz(self) -> Dict:
        reps = [r.describe() for r in list(self.manager.replicas)]
        ready = sum(1 for r in reps if r["state"] == R_READY)
        canary = self.canary()
        return {
            "ok": ready > 0,
            "fleet": True,
            "replicas": reps,
            "ready": ready,
            "ejects": self.manager.ejects,
            "relaunches": self.manager.relaunches,
            "buckets": [list(b) for b in self.cfg.bucket.shapes],
            "batch_size": self.cfg.serve.batch_size,
            "versions": self.manager.versions(),
            "canary": list(canary) if canary is not None else None,
        }

    def rerouted(self) -> int:
        return self.metrics.registry.counter(
            self.metrics.PREFIX + "rerouted")

    def close(self, timeout: float = 10.0) -> None:
        self.manager.close(timeout)


# ---- assembly (tools/fleet.py, tools/loadgen.py, tools/bulk.py, tests) -----


def default_devices(device="cuda") -> List[torch.device]:
    """The cards a fleet spreads over: every card for ``cuda`` (which
    raises without one), the named card for ``cuda:k``, or the CPU."""
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def partition_devices(n_replicas: int, devices: Sequence = None,
                      per_replica: int = 0) -> List[List]:
    """Split the devices into per-replica subsets: disjoint slices while
    the supply lasts, then replicas wrap around and share (with one card
    every replica runs on it)."""
    devices = list(devices if devices is not None else default_devices())
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    d = len(devices)
    if per_replica <= 0:
        per_replica = max(d // n_replicas, 1)
    per_replica = min(per_replica, d)
    return [[devices[(i * per_replica + j) % d]
             for j in range(per_replica)] for i in range(n_replicas)]


def make_engine_build_fn(cfg: Config, variables, *,
                         export_root: str = None,
                         run_fn_factory: Callable[[int], Callable] = None,
                         devices: Sequence = None, device="cuda"
                         ) -> Callable[[int], Tuple[ServingEngine, Dict]]:
    """The replica ``build_fn``: the replica's device subset, its own
    ``Predictor`` from the shared host ``variables`` (the JAX-layout
    tree, ``quant`` scales included for a quantized fleet), a warm
    engine.  ``export_root`` joins from that store
    (``warm_from_export``); ``run_fn_factory`` (rigs and tests) replaces
    the model path, and then no model is built.  ``devices`` defaults to
    :func:`default_devices` of ``device``."""
    subsets = partition_devices(
        cfg.fleet.replicas,
        devices if devices is not None else default_devices(device),
        cfg.fleet.devices_per_replica)

    def build(rid: int) -> Tuple[ServingEngine, Dict]:
        from mx_rcnn_tpu_torch.serve.export import (ExportStore,
                                                    predictor_from_variables)

        sub = [torch.device(d) for d in subsets[rid % len(subsets)]]
        run_fn = run_fn_factory(rid) if run_fn_factory else None
        if run_fn is not None:
            # the engine reads only the device of its postprocess tables
            predictor = types.SimpleNamespace(device=sub[0],
                                              quant_fingerprint=None)
        else:
            # an export-warmed replica runs on its subset's first card;
            # a subset of several cards splits a batch when warmed by
            # running
            split = sub if len(sub) > 1 and not export_root else None
            predictor = predictor_from_variables(variables, cfg, sub[0],
                                                 devices=split)
        engine = ServingEngine(predictor, cfg, run_fn=run_fn)
        t0 = time.perf_counter()
        if run_fn is not None:
            engine.warmup()
            join = {"stub": True}
        elif export_root:
            join = engine.warm_from_export(ExportStore(export_root))
        else:
            engine.warmup()
            join = {}
        join["warm_s"] = round(time.perf_counter() - t0, 3)
        join["devices"] = len(sub)
        join["device"] = str(sub[0])
        return engine, join

    return build


def build_fleet(cfg: Config, variables, *, export_root: str = None,
                run_fn_factory=None, devices=None, device="cuda",
                registry: Registry = None, record=None) -> FleetRouter:
    """Manager and router in one call, every replica launched and warm.
    ``variables``: the weights as the JAX-layout tree
    (``serve/export.py — predictor_variables`` of a predictor, or an
    export store's ``load_variables()``); None with ``run_fn_factory``."""
    build = make_engine_build_fn(cfg, variables, export_root=export_root,
                                 run_fn_factory=run_fn_factory,
                                 devices=devices, device=device)
    manager = ReplicaManager(build, cfg, registry=registry,
                             record=record).start()
    return FleetRouter(manager, cfg)
