"""The per-host replica agent and the export store's distribution.

Counterpart of ``mx_rcnn_tpu/serve/agent.py``.  The agent is the host
half of the cross-host fleet (``serve/remote.py`` is the head's): one
process a host that

* **joins by pulling the export store once**: :func:`pull_store` is
  sha-verified and resumable (Range requests against
  :func:`make_store_server`; a cut transfer resumes where it stopped, a
  corrupt file is refused and pulled again whole) and lands the store
  on local disk, ``kernels/`` included, so every local replica joins
  from it with ``warm_from_export`` and builds no kernel;
* runs ``crosshost.agent_replicas`` local replicas behind the fleet's
  :class:`~mx_rcnn_tpu_torch.serve.fleet.ReplicaManager`, which ejects
  and relaunches them on the RestartPolicy schedule;
* answers the head: ``GET /healthz`` (the join, the local fleet, the
  kernel builds after the warm and this process's kernel launches),
  ``GET /metrics`` (the merged local view with each bucket's
  ``lane.<h>x<w>.depth``, the head's routing signal), ``GET /trace``,
  and ``POST /prepared`` (one binary frame), ``/frames`` (an envelope),
  ``/prepared_json``, ``/detect``, ``/replicas`` (the scheduler's
  lever) and ``/rollout`` (the rollout plane's verbs: ``pull``,
  ``swap``, ``rollback``, ``canary``, ``shadow``, ``status``, driven by
  ``serve/rollout.py — AgentRolloutPort``).

The port's differences: the JAX agent counts XLA lowerings after its
warm (``agent.lowered_after_warm``); this one counts kernel library
builds (``kernels.load_events()``) and publishes
``agent.kernel_builds_after_warm``.  A pulled version's replicas are
built by ``serve/fleet.py — make_engine_build_fn`` from that store's
bundled weights and join from it (its ``kernels/`` included).

The HTTP front end follows ``serve/server.py``: HTTP/1.1 and a
Content-Length on every reply, so the head's keep-alive connections
last the whole burst.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import shutil
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import quote, unquote

import numpy as np

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.netio import (BodyError, check_timeout_ms,
                                     check_trace_header, read_limited,
                                     read_request_body)
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.metrics import Registry
from mx_rcnn_tpu_torch.serve.export import ExportMismatch, MANIFEST_NAME
from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded, RequestFailed,
                                           ShedError)
from mx_rcnn_tpu_torch.serve.remote import (DTYPE_U8, ENV_EXPIRED, ENV_FAILED,
                                            ENV_SERVED, ENV_SHED, WireFrame,
                                            decode_envelope, decode_frame_ex,
                                            encode_result,
                                            encode_result_envelope,
                                            normalize_agent_url)

logger = logging.getLogger("mx_rcnn_tpu_torch")

FRAME_CTYPE = "application/x-mxrcnn-frame"


# ---------------------------------------------------------------------------
# store distribution: server
# ---------------------------------------------------------------------------

def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def store_index(root: str) -> Dict[str, Dict]:
    """{relpath: {bytes, sha256}} over every committed file in an
    export store (staging suffixes excluded — they are not part of the
    store)."""
    out: Dict[str, Dict] = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith((".tmp", ".part")):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            out[rel] = {"bytes": os.path.getsize(path),
                        "sha256": _sha256_file(path)}
    return out


class _StoreHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    timeout = 60.0  # socket read deadline (stalled-peer backstop)

    def log_message(self, *a):  # quiet: the bench drives many requests
        pass

    def _reply_json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        srv = self.server
        if self.path == "/index":
            self._reply_json(200, {"files": srv.index,
                                   "root": srv.root})
            return
        if not self.path.startswith("/f/"):
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
        rel = unquote(self.path[len("/f/"):])
        if rel not in srv.index:  # also rejects traversal: index is flat
            self._reply_json(404, {"error": f"not in store: {rel}"})
            return
        path = os.path.join(srv.root, rel)
        size = srv.index[rel]["bytes"]
        start = 0
        rng = self.headers.get("Range", "")
        if rng.startswith("bytes=") and rng.endswith("-"):
            try:
                start = min(int(rng[len("bytes="):-1]), size)
            except ValueError:
                start = 0
        with srv.stats_lock:
            srv.requests.append({"rel": rel, "start": start})
        n = size - start
        self.send_response(206 if start else 200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(n))
        if start:
            self.send_header("Content-Range",
                             f"bytes {start}-{size - 1}/{size}")
        self.end_headers()
        with open(path, "rb") as f:
            f.seek(start)
            shutil.copyfileobj(f, self.wfile)


def make_store_server(root: str, host: str = "127.0.0.1",
                      port: int = 0) -> ThreadingHTTPServer:
    """Serve a (frozen) export store for host joins.  The sha index is
    computed once at construction — the store is immutable after
    ``ExportStore.finish`` by the admission discipline, so per-request
    hashing would buy nothing.  ``server.requests`` records every file
    request (the bench's one-transfer-per-host assertion reads it)."""
    srv = ThreadingHTTPServer((host, port), _StoreHandler)
    srv.daemon_threads = True
    srv.root = root
    srv.index = store_index(root)
    srv.stats_lock = threading.Lock()
    srv.requests: List[Dict] = []
    return srv


# ---------------------------------------------------------------------------
# store distribution: pull client
# ---------------------------------------------------------------------------

class StorePullError(RuntimeError):
    """The typed store-join failure: a pulled file failed sha
    verification twice (resume + whole-file re-pull), or the store
    endpoint timed out / refused mid-pull.  Every network failure in
    :func:`pull_store` surfaces as this one type so a joining agent
    fails its join loudly instead of leaking a raw socket error (or
    hanging) out of ``ReplicaAgent.__init__``."""


def pull_store(url: str, dest: str, timeout_s: float = 30.0) -> Dict:
    """Mirror a remote export store into ``dest``: sha-verified,
    resumable, idempotent.

    * files already present with a matching sha are skipped (a host
      that joins again after an agent restart transfers nothing);
    * a leftover ``.part`` staging file resumes with a Range request
      from its current length — the truncated bytes are never
      re-shipped;
    * every completed file is sha-verified BEFORE promotion; a mismatch
      deletes the staging file and re-pulls whole, a second mismatch
      raises :class:`StorePullError`;
    * ``manifest.json`` is pulled LAST — the store-commit discipline
      (manifest = commit point) holds across the wire, so a crash
      mid-pull leaves a store the admission check refuses rather than
      a manifest naming files that never arrived;
    * promotion is fsync → rename → dir-fsync, the tree-wide durable
      write idiom (a host crash after a reported join cannot tear the
      store).
    """
    base = normalize_agent_url(url)
    try:
        with urllib.request.urlopen(base + "/index",
                                    timeout=timeout_s) as r:
            # the index is metadata (relpath -> {bytes, sha}); 16 MB is
            # orders of magnitude above any real store's
            index = json.loads(
                read_limited(r, 16 << 20, "store index").decode())
    except OSError as e:  # timeout, refused, DNS — the join must be
        raise StorePullError(           # typed, not a raw socket error
            f"store index pull from {base} failed "
            f"(timeout_s={timeout_s:g}): {e}") from e
    files = index["files"]
    names = sorted(n for n in files
                   if os.path.basename(n) != MANIFEST_NAME)
    names += sorted(n for n in files
                    if os.path.basename(n) == MANIFEST_NAME)
    stats = {"files": 0, "bytes": 0, "skipped": 0, "resumed": 0,
             "refused": 0}
    t0 = time.perf_counter()
    for rel in names:
        want = files[rel]
        final = os.path.join(dest, rel)
        if (os.path.exists(final)
                and _sha256_file(final) == want["sha256"]):
            stats["skipped"] += 1
            continue
        d = os.path.dirname(final)
        if d:
            os.makedirs(d, exist_ok=True)
        part = final + ".part"
        # finite 2-attempt resume over the .part staging file: the 2nd
        # attempt resumes from the bytes already landed, so an immediate
        # retry is the cheapest recovery and backoff would only delay
        # the join; a 2nd failure raises StorePullError (no flood)
        for attempt in (0, 1):
            start = (os.path.getsize(part) if os.path.exists(part)
                     else 0)
            if start > want["bytes"]:
                os.unlink(part)  # longer than truth: unusable staging
                start = 0
            if start:
                stats["resumed"] += 1
            req = urllib.request.Request(base + "/f/" + quote(rel))
            if start:
                req.add_header("Range", f"bytes={start}-")
            try:
                with urllib.request.urlopen(req,
                                            timeout=timeout_s) as r:
                    # a 200 despite our Range means the server restarted
                    # the file — restart the staging write with it
                    mode = "ab" if (start and r.status == 206) else "wb"
                    with open(part, mode) as f:
                        shutil.copyfileobj(r, f)
                        f.flush()
                        os.fsync(f.fileno())
            except OSError as e:
                if attempt == 0:
                    continue  # one retry rides the resumable .part
                raise StorePullError(
                    f"{rel}: pull from {base} failed "
                    f"(timeout_s={timeout_s:g}): {e}") from e
            if _sha256_file(part) == want["sha256"]:
                os.replace(part, final)
                dir_fd = os.open(d or ".", os.O_RDONLY)
                try:
                    os.fsync(dir_fd)
                finally:
                    os.close(dir_fd)
                stats["files"] += 1
                stats["bytes"] += int(want["bytes"])
                break
            stats["refused"] += 1
            os.unlink(part)
            if attempt == 1:
                raise StorePullError(
                    f"{rel}: sha mismatch after whole-file re-pull "
                    f"(want {want['sha256'][:12]}…)")
    stats["transfer_s"] = round(time.perf_counter() - t0, 3)
    return stats


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------

class ReplicaAgent:
    """One host's serving agent: the local fleet and its join and
    operating surface.

    A non-empty ``cfg.crosshost.store_url`` pulls the export store into
    ``cfg.fleet.export_dir`` first (the one-transfer join); the replicas
    then build through :func:`~mx_rcnn_tpu_torch.serve.fleet.build_fleet`
    from that store.  ``variables`` is the weights' JAX-layout tree;
    None takes the store's own (``ExportStore.load_variables``).
    ``run_fn_factory`` is the rigs' and tests' stand-in model.
    ``device`` places the replicas (``cuda``, ``cuda:k`` or ``cpu``).
    """

    def __init__(self, cfg: Config, variables=None, *,
                 run_fn_factory=None, registry: Registry = None,
                 record=None, class_names: List[str] = None,
                 device="cuda"):
        from mx_rcnn_tpu_torch.serve.fleet import build_fleet

        cfg = cfg.replace_in("fleet",
                             replicas=max(1, cfg.crosshost.agent_replicas))
        self.cfg = cfg
        self.class_names = class_names
        # arm the distributed span ring: agents obey the inbound sampled
        # bit (no sampling of their own), so only the ring and the tail
        # knobs apply here; the head owns obs.trace_sample
        obs_trace.configure_distributed(ring=cfg.obs.trace_ring,
                                        slow_pct=cfg.obs.trace_slow_pct)
        self.registry = registry if registry is not None else Registry()
        self.store_pull: Optional[Dict] = None
        export_root = cfg.fleet.export_dir or None
        if cfg.crosshost.store_url:
            if not export_root:
                raise ValueError("crosshost.store_url needs "
                                 "fleet.export_dir as the local "
                                 "placement target")
            self.store_pull = pull_store(
                cfg.crosshost.store_url, export_root,
                timeout_s=cfg.crosshost.pull_timeout_s)
            logger.info("agent store pull: %s", self.store_pull)
        if variables is None and run_fn_factory is None:
            if not export_root:
                raise ValueError("an agent without variables needs an "
                                 "export store holding them")
            from mx_rcnn_tpu_torch.serve.export import ExportStore

            variables = ExportStore(export_root).load_variables()
        t0 = time.perf_counter()
        self.router = build_fleet(
            cfg, variables,
            export_root=export_root if run_fn_factory is None else None,
            run_fn_factory=run_fn_factory, device=device,
            registry=self.registry, record=record)
        self.manager = self.router.manager
        self.warm_s = round(time.perf_counter() - t0, 3)
        # the rollout plane (serve/rollout.py drives it over POST
        # /rollout): the boot model is version None ('base'); each pulled
        # version keeps its store beside the boot store and a build_fn
        self._variables = variables
        self._run_fn_factory = run_fn_factory
        self._device = device
        self._boot_build_fn = self.manager._build_fn
        self._target_replicas = cfg.fleet.replicas
        self._versions: Dict[str, Dict] = {}
        self._rollout_lock = threading.Lock()
        self._shadow_seq = 0
        # builds from here on are after the warm: a replica the
        # scheduler adds joins from the local store and builds none
        self._builds_at_warm = kernels.load_events()["builds"]

    # -- surfaces ----------------------------------------------------------

    def kernel_builds_after_warm(self) -> int:
        return kernels.load_events()["builds"] - self._builds_at_warm

    def healthz(self) -> Dict:
        h = self.router.healthz()
        totals = self.manager.totals()
        h.update({
            "agent": True,
            "warm_s": self.warm_s,
            "store_pull": self.store_pull,
            "export_root": self.cfg.fleet.export_dir or None,
            "programs": sum(r.describe().get("programs") or 0
                            for r in list(self.manager.replicas)),
            "kernel_builds_after_warm": self.kernel_builds_after_warm(),
            "kernel_load_events": kernels.load_events(),
            "kernel_launches": kernels.launch_counts(),
            "engine_batches": totals["batches"],
            "replica_warms": totals["warms"],
        })
        return h

    def metrics_snapshot(self) -> Dict:
        """The merged local-fleet view as one Registry.snapshot: what
        the head's backlog feed scrapes.  The lane-depth and liveness
        gauges are refreshed into the agent registry first, so every
        scrape carries current routing and scheduling signals."""
        from mx_rcnn_tpu_torch.obs.collect import (collector_for_fleet,
                                                   view_to_snapshot)

        ready = self.manager.ready_replicas()
        for b in self.cfg.bucket.shapes:
            depth = 0
            for r in ready:
                with r._lock:
                    eng = r.engine
                if eng is not None:
                    depth += eng.bucket_depth(tuple(b))
            self.registry.set_gauge(f"lane.{b[0]}x{b[1]}.depth", depth)
        self.registry.set_gauge("agent.replicas_ready", len(ready))
        self.registry.set_gauge("agent.kernel_builds_after_warm",
                                self.kernel_builds_after_warm())
        self.manager.export_gauges()
        return view_to_snapshot(collector_for_fleet(self.router).collect())

    def resize(self, target: int = None, delta: int = None) -> Dict:
        """The scheduler's lever: set (or nudge) the local replica
        count.  Adds launch asynchronously (the reply races the warm-up:
        ``fleet.replicas_ready`` catching up is the signal the scheduler
        watches); drains are synchronous and graceful."""
        cur = len(self.manager.replicas)
        want = cur + int(delta or 0) if target is None else int(target)
        want = max(1, want)
        added, drained = 0, 0
        while len(self.manager.replicas) < want:
            self.manager.add_replica()
            added += 1
        while len(self.manager.replicas) > want:
            if self.manager.drain_replica() is None:
                break
            drained += 1
        return {"replicas": len(self.manager.replicas),
                "ready": len(self.manager.ready_replicas()),
                "added": added, "drained": drained}

    # -- the rollout plane (serve/rollout.py).  Every verb is a pump:
    # cheap, idempotent, and safe for the controller to send again until
    # the host reports done; a controller (or host) killed mid-verb
    # loses no invariant, it just pumps again.

    def rollout_pull(self, url: Optional[str], version: str,
                     train_fingerprint: str = None) -> Dict:
        """Pull a version's export store ONCE into a version-keyed
        sibling of the boot export root, run the LINEAGE admission
        (``ExportStore.check_lineage`` — the boot store's manifest sha
        is the only known parent), and register a per-version build_fn.
        A repeat pull of a known version is a recorded no-op
        (``already``) — the one-transfer-per-host invariant.  ``url``
        empty registers a label-only version (stub agents: same
        run_fn factory, distinct routing version).  The version's
        replicas are built from the pulled store's bundled weights (the
        boot weights when it bundles none) and join from that store.
        ``train_fingerprint``, when given, must be the store's (the
        port's addition: the JAX verb takes none).  A refused lineage
        raises ``ExportMismatch``, which ``POST /rollout`` answers 400."""
        from mx_rcnn_tpu_torch.serve.fleet import version_label

        if not version or not isinstance(version, str):
            raise ValueError("rollout pull needs a version id")
        with self._rollout_lock:
            known = self._versions.get(version)
            if known is not None:
                return {**known.get("pull", {}), "version": version,
                        "already": True}
            if not url:
                # label-only: replicas build exactly like boot ones but
                # carry the version tag (the stub tier has no stores)
                self._versions[version] = {
                    "root": None, "pull": {},
                    "build_fn": self._boot_build_fn}
                return {"version": version, "already": False,
                        "label_only": True}
            boot_root = self.cfg.fleet.export_dir
            if not boot_root:
                raise ValueError("rollout pull needs fleet.export_dir "
                                 "as the local placement root")
            from mx_rcnn_tpu_torch.serve.export import (ExportStore,
                                                        manifest_sha)
            from mx_rcnn_tpu_torch.serve.fleet import make_engine_build_fn

            dest = f"{boot_root.rstrip('/')}@{version_label(version)}"
            pull = pull_store(url, dest,
                              timeout_s=self.cfg.crosshost.pull_timeout_s)
            store = ExportStore(dest)
            known_parents = None
            boot_manifest = os.path.join(boot_root, MANIFEST_NAME)
            if os.path.exists(boot_manifest):
                known_parents = {manifest_sha(boot_root)}
            lineage = store.check_lineage(
                known_parents=known_parents,
                expect_train_fingerprint=train_fingerprint)
            variables = (store.load_variables()
                         if store.manifest().get("variables")
                         else self._variables)
            if self._run_fn_factory is not None:
                build_fn = self._boot_build_fn
            else:
                build_fn = make_engine_build_fn(
                    self.cfg, variables, export_root=dest,
                    device=self._device)
            self._versions[version] = {"root": dest, "pull": pull,
                                       "lineage": lineage,
                                       "build_fn": build_fn}
            logger.info("agent rollout pull %s: %s", version, pull)
            return {**pull, "version": version, "already": False,
                    "lineage": lineage}

    def _pump_toward(self, version: Optional[str], build_fn) -> Dict:
        """One step of the rolling replace toward ``version``: keep the
        replica count at the boot target, never drop below one ready
        replica, and retire the outgoing version one GRACEFUL drain at a
        time (the shipped drain path — queued work finishes serving).
        Max overshoot is one replica (the incoming one warms while its
        victim still serves)."""
        want = self._target_replicas
        replicas = list(self.manager.replicas)
        target = [r for r in replicas if r.version == version]
        old = [r for r in replicas if r.version != version]
        target_ready = [r for r in target if r.ready()]
        starting = [r for r in target if not r.ready()]
        if not old and len(target) >= want and not starting:
            return {"done": True, "remaining": 0}
        if starting:
            return {"pending": True, "remaining": len(old)}
        if old and len(replicas) > want and target_ready:
            victim = max([r for r in old if r.ready()] or old,
                         key=lambda r: r.id)
            rid = self.manager.drain_replica(rid=victim.id)
            return {"swapped": rid, "remaining": max(len(old) - 1, 0)}
        if len(target) < want:
            r = self.manager.add_replica(build_fn=build_fn,
                                         version=version)
            return {"added": r.id, "pending": True,
                    "remaining": len(old)}
        return {"pending": True, "remaining": len(old)}

    def rollout_swap(self, version: str) -> Dict:
        """One rolling-replace step toward a PULLED version (400 via
        ValueError otherwise).  When the host completes, scheduler
        resizes keep building the new version."""
        with self._rollout_lock:
            entry = self._versions.get(version)
            if entry is None:
                raise ValueError(
                    f"version {version!r} not pulled on this host")
            res = self._pump_toward(version, entry["build_fn"])
            if res.get("done"):
                # repoint the default build path: post-rollout resize
                # adds must build v2, not resurrect v1
                self.manager._build_fn = entry["build_fn"]
                self.manager.default_version = version
            return res

    def rollout_rollback(self) -> Dict:
        """One rolling step back to the BOOT version — the first-class
        rollback verb's per-host half.  Idempotent: a host already all
        boot-version reports done without actuating anything."""
        with self._rollout_lock:
            res = self._pump_toward(None, self._boot_build_fn)
            if res.get("done"):
                self.manager._build_fn = self._boot_build_fn
                self.manager.default_version = None
            return res

    def rollout_canary(self, version: Optional[str],
                       fraction: float) -> Dict:
        """Set (or clear) the local router's canary version lane."""
        self.router.set_canary(version or None, float(fraction or 0.0))
        c = self.router.canary()
        return {"canary": list(c) if c is not None else None}

    def rollout_status(self) -> Dict:
        return {"versions": self.manager.versions(),
                "pulled": sorted(self._versions),
                "canary": self.rollout_canary_state(),
                "replicas": len(self.manager.replicas)}

    def rollout_canary_state(self) -> Optional[List]:
        c = self.router.canary()
        return list(c) if c is not None else None

    def rollout_shadow(self) -> Dict:
        """One paired shadow sample: the SAME deterministic canvas
        through one base-arm replica and one canary-arm replica,
        bypassing the router (the canary lane must not skew the pair),
        scored by ``detection_score``.  Returns ``pair: null`` when the
        host does not hold both arms ready — the controller's sampler
        just tries another host."""
        from mx_rcnn_tpu_torch.serve.rollout import detection_score

        c = self.router.canary()
        if c is None:
            return {"pair": None, "reason": "no canary lane"}
        version = c[0]
        base = [r for r in self.manager.ready_replicas()
                if r.version != version]
        canary = [r for r in self.manager.ready_replicas()
                  if r.version == version]
        if not base or not canary:
            return {"pair": None, "reason": "arms not resident"}
        with self._rollout_lock:
            seq = self._shadow_seq
            self._shadow_seq += 1
        bh, bw = min((tuple(b) for b in self.cfg.bucket.shapes),
                     key=lambda b: b[0] * b[1])
        rng = np.random.RandomState(seq % (1 << 31))
        data = (rng.rand(bh, bw, 3) * 255.0).astype(np.float32)
        im_info = np.array([bh, bw, 1.0], np.float32)
        scores = []
        for r in (base[0], canary[0]):
            with r._lock:
                eng = r.engine
            if eng is None:
                return {"pair": None, "reason": "replica raced away"}
            req = eng.submit_prepared(
                data.copy(), im_info.copy(), (bh, bw),
                timeout_ms=self.cfg.serve.default_timeout_ms)
            try:
                dets = req.wait(timeout=30.0)
            except Exception as e:
                return {"pair": None, "reason": f"{type(e).__name__}"}
            scores.append(detection_score(dets))
        return {"pair": [scores[0], scores[1]], "seq": seq}

    def close(self, timeout: float = 10.0) -> None:
        self.router.close(timeout)


# ---------------------------------------------------------------------------
# the agent HTTP front end
# ---------------------------------------------------------------------------

class _AgentHandler(BaseHTTPRequestHandler):
    # the server carries .agent / .connections / .max_body_bytes
    # (see make_agent_server)
    protocol_version = "HTTP/1.1"
    # socket-level read deadline: a head trickling a frame one byte at
    # a time holds one handler thread for at most this long
    timeout = 60.0

    def setup(self):
        super().setup()
        with self.server.stats_lock:
            self.server.connections += 1

    def log_message(self, *a):
        pass

    def _reply_json(self, status: int, payload) -> None:
        body = json.dumps(payload).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # the peer died mid-request (a mid-frame disconnect):
            # there is no one to answer, and an unhandled
            # pipe error here would traceback out of the handler
            self.close_connection = True

    def _reply_frame(self, body: bytes) -> None:
        try:
            self.send_response(200)
            self.send_header("Content-Type", FRAME_CTYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def _read_body(self) -> bytes:
        # 411 absent Content-Length / 413 over cap / 408 trickled past
        # the deadline / 400 short body — the oversized claim is
        # refused before a body byte is read
        return read_request_body(self, self.server.max_body_bytes,
                                 self.server.body_deadline_s)

    def _inbound_ctx(self) -> Optional["obs_trace.TraceContext"]:
        """Parse the ``X-MXR-Trace`` header (JSON verbs).  Absent →
        None (untraced — the back-compat path); malformed → ValueError
        out of parse_header, which the POST error ladder maps to 400
        (typed rejection, never a zero-filled context)."""
        hdr = check_trace_header(self.headers.get(obs_trace.TRACE_HEADER))
        return obs_trace.parse_header(hdr) if hdr is not None else None

    def _close_agent_trace(self, actx, root_sid: int, parent: int,
                           t_recv_us: int, outcome: str) -> None:
        """Record this hop's root span ("agent.request" — every local
        span nests under it) and keep the finished tree in the ring
        (the /trace surface)."""
        t_send = obs_trace.epoch_us()
        obs_trace.record_span(
            actx, "agent.request", (t_send - t_recv_us) / 1e3,
            span_id=root_sid, parent=parent, t1_us=t_send,
            outcome=outcome)
        obs_trace.close_trace(actx, keep=True)

    def _wait_and_reply(self, req, timeout_ms: float, binary: bool,
                        raw_dets: bool = False, ctx=None,
                        root_sid: int = 0, t_recv_us: int = 0) -> None:
        """Block the handler thread on the request handle and map its
        terminal state to the serve/server.py status contract (429
        shed / 504 expired / 500 failed).  ``ctx`` (the inbound trace
        context) makes the binary reply carry the skew-stamp extension
        and closes this hop's span tree."""
        budget = (timeout_ms / 1000.0 + 10.0) if timeout_ms else 60.0
        actx = ctx.child(root_sid) if ctx is not None else None
        try:
            dets = req.wait(timeout=budget)
        except (ShedError, DeadlineExceeded, RequestFailed,
                TimeoutError) as e:
            status = {ShedError: 429, DeadlineExceeded: 504}.get(
                type(e), 500)
            if actx is not None:
                self._close_agent_trace(actx, root_sid, ctx.parent,
                                        t_recv_us, type(e).__name__)
            self._reply_json(status, {"error": str(e) or "shed"})
            return
        if binary:
            ts_pair = None
            if actx is not None:
                self._close_agent_trace(actx, root_sid, ctx.parent,
                                        t_recv_us, "served")
                ts_pair = (t_recv_us, obs_trace.epoch_us())
            self._reply_frame(encode_result(dets, ts_pair=ts_pair))
            return
        if actx is not None:
            self._close_agent_trace(actx, root_sid, ctx.parent,
                                    t_recv_us, "served")
        if raw_dets:
            self._reply_json(200, {"dets_b64": {
                int(c): base64.b64encode(
                    np.ascontiguousarray(a, np.float32).tobytes()).decode()
                for c, a in dets.items()}})
        else:
            from mx_rcnn_tpu_torch.serve.server import detections_to_json

            self._reply_json(200, {"detections": detections_to_json(
                dets, self.server.agent.class_names)})

    @staticmethod
    def _submit_wire_frame(agent, frame: WireFrame, actx):
        """One decoded request frame → a router admission.  v2 u8
        source frames go through ``submit_source`` — the engine runs
        the SAME ``data/image.py pad_normalize`` the head's preprocess
        tail ends with before enqueue, so the canvas is bit-equal to a
        head-built one; fp32 frames admit as prepared rows unchanged.
        A well-formed frame the local router cannot take (unconfigured
        bucket) raises ValueError → 400 / per-frame FAILED."""
        if frame.dtype == DTYPE_U8:
            return agent.router.submit_source(
                frame.data, frame.im_info, frame.bucket,
                timeout_ms=frame.timeout_ms, tctx=actx)
        return agent.router.submit_prepared(
            frame.data, frame.im_info, frame.bucket,
            timeout_ms=frame.timeout_ms, tctx=actx)

    def _serve_envelope(self, agent, frames, decode_ms: float,
                        nbytes: int, t_recv_us: int) -> None:
        """Admit EVERY frame of a coalesced envelope up front (they
        progress concurrently through the local router), wait each to
        its terminal, reply ONE result envelope with a per-frame
        status.  Each frame keeps its own terminal semantics, its own
        trace tree and its own skew stamps — the envelope amortizes
        transport, never accounting."""
        budget = 60.0
        subs = []   # (req | None, err, ctx, actx, root_sid) per frame
        for frame in frames:
            ctx = frame.ctx
            actx = None
            root_sid = 0
            if ctx is not None:
                root_sid = obs_trace.new_span_id()
                actx = ctx.child(root_sid)
                obs_trace.record_span(actx, "agent.decode", decode_ms,
                                      bytes=nbytes,
                                      frames=len(frames))
            if frame.timeout_ms:
                budget = max(budget, frame.timeout_ms / 1000.0 + 10.0)
            try:
                req = self._submit_wire_frame(agent, frame, actx)
                subs.append((req, None, ctx, actx, root_sid))
            except (ValueError, KeyError, TypeError) as e:
                # an unserveable-but-well-formed frame (unconfigured
                # bucket) fails ALONE — its envelope mates still serve
                subs.append((None, str(e), ctx, actx, root_sid))
        entries = []
        for req, err, ctx, actx, root_sid in subs:
            if req is None:
                status, payload, outcome = (ENV_FAILED, err.encode(),
                                            "rejected")
            else:
                try:
                    dets = req.wait(timeout=budget)
                except ShedError:
                    status, payload, outcome = ENV_SHED, b"", "ShedError"
                except DeadlineExceeded:
                    status, payload, outcome = (ENV_EXPIRED, b"",
                                                "DeadlineExceeded")
                except (RequestFailed, TimeoutError) as e:
                    status, payload, outcome = (
                        ENV_FAILED, (str(e) or "failed").encode(),
                        type(e).__name__)
                else:
                    ts_pair = ((t_recv_us, obs_trace.epoch_us())
                               if actx is not None else None)
                    status, payload, outcome = (
                        ENV_SERVED, encode_result(dets, ts_pair=ts_pair),
                        "served")
            if actx is not None:
                self._close_agent_trace(actx, root_sid, ctx.parent,
                                        t_recv_us, outcome)
            entries.append((status, payload))
        self._reply_frame(encode_result_envelope(entries))

    def do_GET(self):  # noqa: N802
        agent = self.server.agent
        try:
            if self.path == "/healthz":
                h = agent.healthz()
                self._reply_json(200 if h.get("ok") else 503, h)
            elif self.path == "/metrics":
                self._reply_json(200, {"registry":
                                       agent.metrics_snapshot()})
            elif self.path.startswith("/trace"):
                # the remote half of merge_fleet_trace: this host's kept
                # span trees + its clock, so the head can sanity-check
                # its skew estimate against a direct stamp
                self._reply_json(200, {
                    "host": obs_trace.host_label(),
                    "clock_us": obs_trace.epoch_us(),
                    "trees": obs_trace.kept_trees()})
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})
        except Exception as e:
            logger.exception("agent GET %s failed", self.path)
            self._reply_json(500, {"error": str(e)})

    def do_POST(self):  # noqa: N802
        agent = self.server.agent
        try:
            if self.path == "/prepared":
                t_recv_us = obs_trace.epoch_us()
                buf = self._read_body()
                d0 = time.monotonic()
                try:
                    # v1 fp32 canvases and v2 u8 source frames decode
                    # through the same versioned entry point; typed
                    # rejection (400) either way
                    frame = decode_frame_ex(buf)
                except ValueError as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                ctx = frame.ctx
                actx = None
                root_sid = 0
                if ctx is not None:
                    root_sid = obs_trace.new_span_id()
                    actx = ctx.child(root_sid)
                    obs_trace.record_span(
                        actx, "agent.decode",
                        (time.monotonic() - d0) * 1e3,
                        bytes=len(buf))
                req = self._submit_wire_frame(agent, frame, actx)
                self._wait_and_reply(req, frame.timeout_ms, binary=True,
                                     ctx=ctx, root_sid=root_sid,
                                     t_recv_us=t_recv_us)
            elif self.path == "/frames":
                t_recv_us = obs_trace.epoch_us()
                buf = self._read_body()
                d0 = time.monotonic()
                try:
                    # the head builds envelopes itself, so ANY malformed
                    # member means corruption: reject the WHOLE envelope
                    # (400) — never serve a prefix of it
                    frames = [decode_frame_ex(f)
                              for f in decode_envelope(buf)]
                except ValueError as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                self._serve_envelope(agent, frames,
                                     decode_ms=(time.monotonic() - d0)
                                     * 1e3,
                                     nbytes=len(buf),
                                     t_recv_us=t_recv_us)
            elif self.path == "/prepared_json":
                t_recv_us = obs_trace.epoch_us()
                ctx = self._inbound_ctx()
                body = json.loads(self._read_body().decode())
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                shape = tuple(body["shape"])
                data = np.frombuffer(
                    base64.b64decode(body["data_b64"]),
                    np.float32).reshape(shape)
                timeout_ms = check_timeout_ms(
                    body.get("timeout_ms") or 0.0)
                root_sid = obs_trace.new_span_id() if ctx is not None \
                    else 0
                req = agent.router.submit_prepared(
                    data, np.asarray(body["im_info"], np.float32),
                    shape[:2], timeout_ms=timeout_ms,
                    tctx=ctx.child(root_sid) if ctx is not None else None)
                self._wait_and_reply(req, timeout_ms, binary=False,
                                     raw_dets=True, ctx=ctx,
                                     root_sid=root_sid,
                                     t_recv_us=t_recv_us)
            elif self.path == "/detect":
                from mx_rcnn_tpu_torch.serve.server import decode_image_payload

                t_recv_us = obs_trace.epoch_us()
                ctx = self._inbound_ctx()
                body = json.loads(self._read_body().decode())
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                img = decode_image_payload(body)
                timeout_ms = check_timeout_ms(
                    body.get("timeout_ms") or 0.0)
                root_sid = obs_trace.new_span_id() if ctx is not None \
                    else 0
                req = agent.router.submit(
                    img, timeout_ms=timeout_ms,
                    tctx=ctx.child(root_sid) if ctx is not None else None)
                self._wait_and_reply(req, timeout_ms, binary=False,
                                     raw_dets=bool(body.get("raw_dets")),
                                     ctx=ctx, root_sid=root_sid,
                                     t_recv_us=t_recv_us)
            elif self.path == "/replicas":
                t_recv_us = obs_trace.epoch_us()
                ctx = self._inbound_ctx()
                body = json.loads(self._read_body().decode() or "{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                res = agent.resize(
                    target=body.get("target"), delta=body.get("delta"))
                if ctx is not None:
                    root_sid = obs_trace.new_span_id()
                    self._close_agent_trace(
                        ctx.child(root_sid), root_sid, ctx.parent,
                        t_recv_us, "agent.resize")
                self._reply_json(200, res)
            elif self.path == "/rollout":
                t_recv_us = obs_trace.epoch_us()
                ctx = self._inbound_ctx()
                body = json.loads(self._read_body().decode() or "{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                op = body.get("op")
                if ctx is not None:
                    root_sid = obs_trace.new_span_id()
                    self._close_agent_trace(
                        ctx.child(root_sid), root_sid, ctx.parent,
                        t_recv_us, f"agent.rollout.{op}")
                if op == "pull":
                    self._reply_json(200, agent.rollout_pull(
                        body.get("url"), body.get("version"),
                        body.get("train_fingerprint")))
                elif op == "swap":
                    self._reply_json(200, agent.rollout_swap(
                        body.get("version")))
                elif op == "rollback":
                    self._reply_json(200, agent.rollout_rollback())
                elif op == "canary":
                    self._reply_json(200, agent.rollout_canary(
                        body.get("version"), body.get("fraction")))
                elif op == "shadow":
                    self._reply_json(200, agent.rollout_shadow())
                elif op == "status":
                    self._reply_json(200, agent.rollout_status())
                else:
                    raise ValueError(f"unknown rollout op {op!r}")
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})
        except BodyError as e:
            # 411 absent Content-Length / 413 over cap / 400 short body
            self._reply_json(e.status, {"error": str(e)})
        except (ValueError, KeyError, TypeError, ExportMismatch) as e:
            # malformed input is the CLIENT's fault: missing JSON keys
            # (KeyError) and wrong-typed fields (TypeError) are 400s,
            # never 500s, and so is a store whose lineage this host
            # refuses (the JAX agent answers that one 500)
            self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:
            logger.exception("agent POST %s failed", self.path)
            self._reply_json(500, {"error": str(e)})


def make_agent_server(agent: ReplicaAgent, host: str = "127.0.0.1",
                      port: int = 0,
                      max_body_mb: float = None) -> ThreadingHTTPServer:
    """Bind the agent's HTTP front end (port 0 picks a free port —
    read ``server.server_address``).  ``server.connections`` counts
    accepted sockets: with HTTP/1.1 keep-alive the head's pool should
    hold it at its connection count for a whole burst."""
    srv = ThreadingHTTPServer((host, port), _AgentHandler)
    srv.daemon_threads = True
    srv.agent = agent
    srv.stats_lock = threading.Lock()
    srv.connections = 0
    if max_body_mb is None:
        max_body_mb = agent.cfg.crosshost.max_body_mb
    srv.max_body_bytes = int(float(max_body_mb) * (1 << 20))
    srv.body_deadline_s = 30.0  # slow-loris bound (netio 408 contract)
    return srv
