"""The cross-host bench rig.

Counterpart of ``mx_rcnn_tpu/tools/crosshost.py``, driven through
``tools/loadgen.py --crosshost_bench`` (the full battery) and
``--crosshost_smoke`` (gate scale).  Every "host" is a separate
``tools/agent.py`` process on a loopback port it binds itself
(``--port 0``, read off its ready line), so the wire, the store pull,
the scrapes and the SIGKILL legs cross a real process boundary.  The
processes share this machine's cores (and its cards), so ratios check
the plane, not several machines.  Each agent gets ``--device``
explicitly; the rig never hides a card from it.

Legs:

1. **join**: export a store here, serve it from
   :func:`~mx_rcnn_tpu_torch.serve.agent.make_store_server`, start one
   real (model) agent that joins through ``--store_url``: the store
   server's log shows each file shipped once, and after a mixed-bucket
   burst the agent's ``agent.kernel_builds_after_warm`` reads 0;
2. **wire A/B**: one prepared burst through one stub agent over the
   binary frame against the base64-JSON control arm
   (``RemoteEngine(wire=...)``);
3. **scaling**: 1, 2 (and 4) stub hosts behind the cross-host router,
   closed-loop prepared traffic, throughput against the 1-host leg;
4. **host kill**: 2 stub hosts and the live scheduler; one agent
   SIGKILLed mid-burst: every admitted request ends (0 lost), every
   non-shed one serves within its original deadline, and the scheduler
   restores capacity on the survivor without operator input;
5. **bulk over 2 hosts**: the bulk plane over two content-stub hosts: an
   uninterrupted control and an aborted-and-resumed run commit
   byte-identical shards.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import (Config, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.netio import read_limited
from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded, RequestFailed,
                                           ShedError)
from mx_rcnn_tpu_torch.tools.loadgen import (_drain, _fleet_leg_record,
                                             _smoke_overrides)

logger = logging.getLogger("mx_rcnn_tpu_torch")


# ---------------------------------------------------------------------------
# rig plumbing
# ---------------------------------------------------------------------------

# the directory holding the package the agents import: this one's
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def _child_env(package_root: str = None) -> Dict[str, str]:
    """The agent's environment: this process's, with the package's root
    first on ``PYTHONPATH``.  Nothing hides a card: the device is the
    agent's ``--device``."""
    env = dict(os.environ)
    root = package_root or PACKAGE_ROOT
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


class AgentProc:
    """One ``tools/agent.py`` process: launch, ready-line handshake,
    teardown.  It binds ``port`` (0: a free one it picks and reports),
    so a port is never chosen here and taken by another process before
    the agent binds it.  ``env`` adds to the agent's environment.
    stderr (the logs) goes to a file under ``workdir``, quoted on
    failure; stdout carries the one ready line."""

    def __init__(self, workdir: str, name: str, overrides: Dict, *,
                 network: str = "tiny", dataset: str = "synthetic",
                 replicas: int = 1, store_url: str = None,
                 export_dir: str = None, stub_ms: float = None,
                 stub: str = "plain", device: str = "cuda",
                 prefix: str = None, epoch: int = 0, port: int = 0,
                 package_root: str = None, env: Dict[str, str] = None):
        self.name = name
        self.port = port
        self.log_path = os.path.join(workdir, f"{name}.log")
        cmd = [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.agent",
               "--network", network, "--dataset", dataset,
               "--host", "127.0.0.1", "--port", str(port),
               "--replicas", str(replicas), "--device", str(device)]
        for k, v in overrides.items():
            cmd += ["--set", f"{k}={v!r}" if isinstance(v, str)
                    else f"{k}={v}"]
        if prefix:
            cmd += ["--prefix", prefix, "--epoch", str(epoch)]
        if store_url:
            cmd += ["--store_url", store_url]
        if export_dir:
            cmd += ["--export_dir", export_dir]
        if stub_ms is not None:
            cmd += ["--stub_ms", str(stub_ms), "--stub", stub]
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=self._log, text=True,
                                     env=dict(_child_env(package_root),
                                              **(env or {})))
        self.ready: Dict = {}

    @property
    def url(self) -> str:
        if not self.port:
            raise RuntimeError(f"agent {self.name} has not reported its "
                               f"port yet (wait_ready)")
        return f"http://127.0.0.1:{self.port}"

    def log_tail(self, n: int = 2000) -> str:
        try:
            with open(self.log_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def wait_ready(self, timeout_s: float = 300.0) -> Dict:
        if self.ready:
            return self.ready
        box: Dict = {}

        def read():
            box["line"] = self.proc.stdout.readline()

        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(timeout_s)
        line = box.get("line")
        if not line:
            self.kill()
            raise RuntimeError(f"agent {self.name} not ready within "
                               f"{timeout_s}s:\n{self.log_tail()}")
        self.ready = json.loads(line)
        if not self.ready.get("ready"):
            raise RuntimeError(f"agent {self.name} reported unready: "
                               f"{self.ready}")
        # threadlint: disable=TL201 one instance's port is written once, by the thread that waits on its ready line and alone reads it until wait_ready returns (tools/rollout.py — _kill_leg's relaunch)
        self.port = int(self.ready["port"])
        return self.ready

    def sigkill(self) -> None:
        """The host-death lever: no shutdown path runs, sockets go
        half-dead, as a host that lost power looks."""
        try:
            self.proc.send_signal(signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        self._log.close()


def _scrape(url: str, timeout_s: float = 10.0) -> Dict:
    with urllib.request.urlopen(url.rstrip("/") + "/metrics",
                                timeout=timeout_s) as r:
        snap = json.loads(read_limited(r).decode())
    return snap.get("registry", snap)


def _healthz(url: str, timeout_s: float = 10.0) -> Dict:
    with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                timeout=timeout_s) as r:
        return json.loads(read_limited(r).decode())


def _prepared_set(cfg: Config, n: int, seed: int = 0) -> List[Tuple]:
    """n (canvas, im_info, bucket) triples alternating over the shape
    buckets — the prepared-path analogue of ``synthetic_images`` (mixed
    buckets keep the no-build pin and the lane-JSQ path honest)."""
    rng = np.random.RandomState(seed)
    buckets = [tuple(b) for b in cfg.bucket.shapes]
    out = []
    for i in range(n):
        b = buckets[i % len(buckets)]
        out.append((rng.rand(*b, 3).astype(np.float32) * 255.0,
                    np.array([b[0], b[1], 1.0], np.float32), b))
    return out


def _submit_prepared(target, item, timeout_ms: float):
    data, im_info, bucket = item
    return target.submit_prepared(data, im_info, bucket,
                                  timeout_ms=timeout_ms)


def _run_prepared_closed(target, prepared, duration_s: float,
                         concurrency: int, timeout_ms: float,
                         submit=None, requests: List[dict] = None) -> dict:
    """``run_closed_loop`` over the prepared/binary hot path —
    ``target`` is anything with ``submit_prepared`` (cross-host router
    or a bare RemoteEngine).  ``submit(target, item, timeout_ms)``
    replaces the prepared submit (a v2 source frame, a raw image).
    ``requests``, where given, gets one record a request: its submit and
    end times in seconds from the loop's start, its outcome and, for a
    router's request, each dispatch as [replica, sent, ended, state]."""
    submit = submit or _submit_prepared
    t_start = time.monotonic()
    stop = t_start + duration_s
    outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
    lock = threading.Lock()

    def since(t):
        return None if t is None else round(t - t_start, 4)

    def worker(wid: int):
        i = wid
        while time.monotonic() < stop:
            item = prepared[i % len(prepared)]
            i += concurrency
            req = None
            t0 = time.monotonic()
            try:
                req = submit(target, item, timeout_ms)
                req.wait(timeout=timeout_ms / 1000.0 + 30.0)
                key = "ok"
            except ShedError:
                key = "shed"
                time.sleep(0.005)  # a real client backs off; a tight
                # resubmit spin would just burn the shared core
            except DeadlineExceeded:
                key = "expired"
            except (RequestFailed, TimeoutError):
                key = "failed"
            with lock:
                outcomes[key] += 1
                if requests is not None:
                    requests.append({
                        "t": since(t0), "end": since(time.monotonic()),
                        "outcome": key,
                        "dispatches": [[r, since(a), since(b), st]
                                       for r, a, b, st in
                                       getattr(req, "history", ())]})

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"wall_s": time.perf_counter() - t0, "client": outcomes}


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------

def run_crosshost_bench(args) -> int:
    from mx_rcnn_tpu_torch.analysis import sanitizer
    from mx_rcnn_tpu_torch.serve.agent import make_store_server
    from mx_rcnn_tpu_torch.serve.export import export_serve_programs
    from mx_rcnn_tpu_torch.serve.remote import (RemoteEngine,
                                                build_crosshost_router)
    from mx_rcnn_tpu_torch.serve.scheduler import AgentAdmin, FleetScheduler
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    from mx_rcnn_tpu_torch.serve.fleet import default_devices

    # the agents' device is resolved (and refused) before anything runs
    default_devices(args.device)
    smoke = args.crosshost_smoke
    overrides = dict(_smoke_overrides())  # both tiers use the tiny rig:
    # every "host" shares one machine, so the production canvas would
    # only measure core contention; the full tier differs in durations
    overrides.update(parse_set_overrides(args.set))
    cfg = generate_config(args.network, args.dataset, **overrides)
    # agent processes must build the same config (the prepared frames'
    # bucket shapes are part of the wire contract)
    agent_overrides = dict(overrides)
    workdir = args.workdir or tempfile.mkdtemp(prefix="crosshost_")
    os.makedirs(workdir, exist_ok=True)
    timeout_ms = 20_000.0 if args.timeout_ms is None else args.timeout_ms
    dur = min(args.duration, 4.0) if smoke else max(args.duration, 8.0)
    batch = cfg.serve.batch_size
    dev = args.device
    # keep-alive pipeline sized so the closed loop never sheds at the
    # head: per-agent capacity (connections x depth) >= its share
    ch_over = {"connections": 2, "pipeline_depth": 4 * batch,
               "scrape_interval_s": 0.2, "io_timeout_s": 30.0}
    rec: dict = {
        "metric": "crosshost_scaling_x_at_2_hosts",
        "unit": "x",
        "measured": True,
        "smoke": smoke,
        "network": args.network,
        "device": dev,
        "bucket_shapes": [list(b) for b in cfg.bucket.shapes],
        "batch_size": batch,
        "host": {"cores": os.cpu_count()},
        "note": "every 'host' is a separate local process sharing this "
                "machine's cores: ratios check the cross-host plane "
                "(wire, store pull, scheduler), not several machines",
    }
    problems: List[str] = []
    prepared = _prepared_set(cfg, args.images, args.seed)

    def agent(name, overrides_=None, **kw):
        return AgentProc(workdir, name, overrides_ or agent_overrides,
                         network=args.network, dataset=args.dataset,
                         device=dev, **kw)

    # -- 1. store export + one-transfer join (real model) ---------------
    store_root = os.path.join(workdir, "store")
    logger.info("[crosshost] exporting store -> %s", store_root)
    predictor = init_predictor(cfg, args.prefix, args.epoch, args.seed,
                               dev)
    report = export_serve_programs(predictor, cfg, store_root,
                                   bundle_variables=True)
    del predictor
    store_srv = make_store_server(store_root)
    threading.Thread(target=store_srv.serve_forever,
                     daemon=True).start()
    sp = store_srv.server_address[1]
    logger.info("[crosshost] join leg: real agent pulling store from "
                ":%d ...", sp)
    a0 = agent("join-agent", replicas=1,
               store_url=f"http://127.0.0.1:{sp}",
               export_dir=os.path.join(workdir, "agent_store"))
    try:
        ready = a0.wait_ready()
        pull = ready.get("store_pull") or {}
        router, feed = build_crosshost_router(
            cfg.replace_in("crosshost", **ch_over), [a0.url])
        try:
            run = _run_prepared_closed(router, prepared,
                                       min(dur, 3.0),
                                       concurrency=2 * batch,
                                       timeout_ms=timeout_ms)
            _drain(router)
        finally:
            feed.close()
            router.close()
        snap = _scrape(a0.url)
        builds = snap["gauges"].get("agent.kernel_builds_after_warm")
        with store_srv.stats_lock:
            reqs = list(store_srv.requests)
        files_in_store = len(store_srv.index)
        rec["join"] = {
            "store_files": files_in_store,
            "store_bytes": report["bytes"],
            "pull": pull,
            "store_requests": len(reqs),
            "warm_s": ready.get("warm_s"),
            "burst_ok": run["client"]["ok"],
            "kernel_builds_after_warm": builds,
        }
        if pull.get("files") != files_in_store or pull.get("refused"):
            problems.append(f"join pull incomplete or refused: {pull}")
        if len(reqs) != files_in_store or any(r["start"] for r in reqs):
            problems.append(
                f"join was not ONE whole transfer per file: "
                f"{len(reqs)} requests for {files_in_store} files")
        if run["client"]["ok"] == 0:
            problems.append("join burst served nothing")
        if builds is None or builds > 0:
            problems.append(f"agent built {builds} kernel librar(ies) "
                            f"after its warm")
    finally:
        a0.kill()
        store_srv.shutdown()
        store_srv.server_close()

    # -- 2. wire A/B: binary frame vs base64-JSON control ---------------
    logger.info("[crosshost] wire A/B leg ...")
    # near-zero batching delay on the agent and concurrency pinned to
    # the connection count: every request ships at once and waits only
    # on encode, wire and decode, so the A/B isolates the frame's cost
    aw = agent("wire-agent", dict(agent_overrides, serve__max_delay_ms=2.0),
               replicas=1, stub_ms=0.0)
    wire: dict = {}
    try:
        aw.wait_ready()
        wcfg = cfg.replace_in("crosshost", **ch_over)
        for arm in ("json", "binary"):
            eng = RemoteEngine(f"wire-{arm}", aw.url, wcfg, wire=arm)
            try:
                # warm the arm's whole path before the measured window,
                # then zero the counters: else the arm that runs first
                # pays every first-touch cost
                _run_prepared_closed(eng, prepared, 0.5,
                                     concurrency=ch_over["connections"],
                                     timeout_ms=timeout_ms)
                _drain(eng)
                eng.metrics.reset()
                run = _run_prepared_closed(eng, prepared,
                                           max(dur / 2, 2.0),
                                           concurrency=ch_over[
                                               "connections"],
                                           timeout_ms=timeout_ms)
                _drain(eng)
                snap = eng.metrics.snapshot()
                wire[arm] = {
                    "imgs_per_sec": round(run["client"]["ok"]
                                          / run["wall_s"], 2),
                    "p50_ms": snap["total_ms"]["p50"],
                    "p99_ms": snap["total_ms"]["p99"],
                    "client": run["client"],
                }
            finally:
                eng.close()
        ratio = (wire["binary"]["imgs_per_sec"]
                 / max(wire["json"]["imgs_per_sec"], 1e-9))
        wire["binary_over_json"] = round(ratio, 3)
        wire["note"] = ("one burst, one agent; the arms differ only in "
                        "the prepared frame's encoding")
        if ratio < args.min_wire_ratio:
            problems.append(f"binary wire {ratio:.3f}x JSON < "
                            f"{args.min_wire_ratio}")
    finally:
        aw.kill()
    rec["wire_ab"] = wire

    # -- 3. host scaling (stub model, 1/2/4 agent processes) ------------
    sweep = [1, 2] if smoke else [int(s) for s in
                                  args.crosshost_sweep.split(",")]
    stub_ms = min(args.stub_ms, 60.0) if smoke else args.stub_ms
    thr: dict = {}
    for n_hosts in sweep:
        logger.info("[crosshost] scaling leg: %d host(s) ...", n_hosts)
        agents = [agent(f"scale{n_hosts}-{i}", replicas=1, stub_ms=stub_ms)
                  for i in range(n_hosts)]
        try:
            for a in agents:
                a.wait_ready()
            router, feed = build_crosshost_router(
                cfg.replace_in("crosshost", **ch_over),
                [a.url for a in agents])
            try:
                run = _run_prepared_closed(
                    router, prepared, dur,
                    concurrency=4 * batch * n_hosts,
                    timeout_ms=timeout_ms)
                _drain(router)
                leg = _fleet_leg_record(run, router.metrics.snapshot())
                thr[str(n_hosts)] = leg
                if leg["lost"]:
                    problems.append(f"{n_hosts}-host leg lost "
                                    f"{leg['lost']} requests")
            finally:
                feed.close()
                router.close()
        finally:
            for a in agents:
                a.kill()
    scaling: dict = {"stub_model_ms": stub_ms, "hosts": thr}
    base = thr[str(sweep[0])]["imgs_per_sec"]
    for n_hosts in sweep[1:]:
        if base:
            s = round(thr[str(n_hosts)]["imgs_per_sec"] / base, 3)
            scaling[f"scaling_{n_hosts}h"] = s
            floor = args.min_crosshost_scaling * (n_hosts / 2.0)
            if s < floor:
                problems.append(f"scaling at {n_hosts} hosts {s} < "
                                f"{floor}")
    rec["host_scaling"] = scaling
    rec["value"] = scaling.get("scaling_2h")

    # -- 4. host-kill + live scheduler ----------------------------------
    logger.info("[crosshost] host-kill leg (live scheduler) ...")
    rec["host_kill"] = host_kill_leg(
        cfg, ch_over, [agent(f"kill-{i}", replicas=1, stub_ms=stub_ms)
                       for i in range(2)],
        prepared, max(dur, 6.0), 4 * batch * 2, timeout_ms, problems)

    # -- 5. bulk over 2 hosts: exactly-once + byte-identical resume -----
    logger.info("[crosshost] bulk 2-host leg ...")
    rec["bulk_2host"] = _bulk_leg(
        cfg, workdir, [agent(f"bulk-{i}", replicas=1, stub_ms=0.0,
                             stub="content") for i in range(2)],
        ch_over, problems)

    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if args.check:
        problems += sanitizer.check_problems()
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        return 1 if problems else 0
    return 0


def host_kill_leg(cfg: Config, ch_over: Dict, agents: List[AgentProc],
                  prepared, burst_s: float, concurrency: int,
                  timeout_ms: float, problems: List[str],
                  submit=None, restore_timeout_s: float = 60.0,
                  sched_over: Dict = None) -> dict:
    """Two agents behind the cross-host router with the live scheduler;
    ``agents[1]`` SIGKILLed a third into a closed-loop burst.  Every
    admitted request must end (0 lost), every non-shed one serve within
    its original deadline, and the scheduler must grow the survivor to
    cover the dead host's replica.  ``submit(router, item, timeout_ms)``
    replaces the prepared-frame submit (default ``submit_prepared`` of
    ``prepared``'s triples).  ``sched_over`` overrides the leg's
    ``crosshost`` scheduler knobs: a real model's join outlasts the
    stand-in's 1 s cooldown, and a deficit judged again before the
    added replica is ready adds another.  The agents are killed on
    return."""
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router
    from mx_rcnn_tpu_torch.serve.scheduler import AgentAdmin, FleetScheduler

    # up_shed_ratio near 1: the closed loop overdrives the head on
    # purpose, so its capacity gate sheds as backpressure; that is
    # client load, not missing replicas, and the leg measures the
    # deficit path
    kcfg = cfg.replace_in("crosshost", **dict(
        ch_over, dead_after_failures=2, for_samples=2,
        cooldown_s=1.0, interval_s=0.2, window_s=5.0,
        up_shed_ratio=0.9) | dict(sched_over or {}))
    kcfg = kcfg.replace_in("fleet", reroute_retries=2,
                           health_interval_s=0.2)
    try:
        for a in agents:
            a.wait_ready()
        urls = [a.url for a in agents]
        router, feed = build_crosshost_router(kcfg, urls)
        sched = FleetScheduler(feed.store,
                               AgentAdmin.from_config(urls, kcfg),
                               kcfg).start()
        try:
            box = {}
            requests: List[dict] = []

            def burst():
                box["run"] = _run_prepared_closed(
                    router, prepared, burst_s, concurrency=concurrency,
                    timeout_ms=timeout_ms, submit=submit,
                    requests=requests)

            t_burst = time.monotonic()
            bt = threading.Thread(target=burst, daemon=True)
            bt.start()
            time.sleep(burst_s / 3.0)
            served_before = router.metrics.snapshot()["counters"]["served"]
            t_sig = time.monotonic()
            agents[1].sigkill()
            kill_t = time.monotonic()
            # capacity restore, watched from the kill on (beside the rest
            # of the burst): the scheduler must grow the survivor to
            # cover the dead host's replica, with no operator input
            restored: Dict = {"survivor": {}}

            def watch():
                deadline = kill_t + restore_timeout_s
                while time.monotonic() < deadline:
                    try:
                        h = _healthz(urls[0])
                        restored["survivor"] = h
                        if h.get("ready", 0) >= 2:
                            restored["s"] = round(
                                time.monotonic() - kill_t, 2)
                            return
                    except OSError:
                        pass
                    time.sleep(0.1)

            wt = threading.Thread(target=watch, daemon=True)
            wt.start()
            bt.join()
            _drain(router)
            run = box["run"]
            wt.join()
            restore_s = restored.get("s")
            survivor = restored["survivor"]
            snap = router.metrics.snapshot()
            c = snap["counters"]
            leg = {
                "submitted": c["submitted"], "served": c["served"],
                "shed": c["shed"], "expired": c["expired"],
                "failed": c["failed"],
                "lost": c["submitted"] - snap["terminated"],
                "served_after_kill": c["served"] - served_before,
                # SIGKILL to reaped: the host answers nothing meanwhile,
                # yet its sockets stay open
                "kill_reap_s": round(kill_t - t_sig, 3),
                "rerouted": router.rerouted(),
                "ejects": router.manager.ejects,
                "client": run["client"],
                "capacity_restore_s": restore_s,
                "survivor_joins": [r.get("last_join_s") for r in
                                   survivor.get("replicas", [])],
                "survivor_builds_after_warm":
                    survivor.get("kernel_builds_after_warm"),
                "scheduler_actions": [
                    {k: a[k] for k in ("action", "source", "reason")}
                    for a in sched.actions],
                # every request of the burst (seconds from its start;
                # replica k is agents[k]) and the SIGKILL's time there
                "kill_at_s": round(t_sig - t_burst, 4),
                "requests": sorted(requests, key=lambda r: r["t"]),
            }
            if leg["lost"]:
                problems.append(f"host-kill leg lost {leg['lost']} "
                                f"requests")
            if run["client"]["failed"] or run["client"]["expired"]:
                problems.append(
                    "host-kill leg had client failures/expiries — "
                    "reroute did not complete within the original "
                    f"deadline: {run['client']}")
            if leg["served_after_kill"] <= 0:
                problems.append("nothing served after the host kill")
            if restore_s is None:
                problems.append(f"scheduler did not restore capacity on "
                                f"the survivor within "
                                f"{restore_timeout_s:g}s")
            if leg["survivor_builds_after_warm"]:
                problems.append(f"the survivor built "
                                f"{leg['survivor_builds_after_warm']} "
                                f"kernel librar(ies) for the new replica")
            if not any(a["action"] == "add" for a in sched.actions):
                problems.append("scheduler recorded no add action "
                                "after the host kill")
            return leg
        finally:
            sched.close()
            feed.close()
            router.close()
    finally:
        for a in agents:
            a.kill()


class _PlannedAbort(RuntimeError):
    """The bulk leg's mid-run failure: raised from the fault hook after
    a shard commit, so the resume starts from a committed prefix (the
    in-process stand-in of the SIGKILL protocol)."""


def _bulk_leg(cfg: Config, workdir: str, agents: List[AgentProc],
              ch_over: Dict, problems: List[str]) -> dict:
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import StreamTestLoader
    from mx_rcnn_tpu_torch.serve.bulk import (BulkRunner, BulkSink,
                                              make_sink_manifest)
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router

    data_root = os.path.join(workdir, "bulk_data")
    bcfg = cfg.replace_in("dataset", root_path=data_root,
                          dataset_path=os.path.join(data_root,
                                                    "synthetic"))
    bcfg = bcfg.replace_in("bulk", shard_batches=2)
    bcfg = bcfg.replace_in("crosshost", **ch_over)
    h, w = bcfg.bucket.shapes[0]
    imdb, roidb = load_gt_roidb(bcfg, training=True, flip=False,
                                num_images=16, image_size=(h, w),
                                max_objects=2)
    try:
        for a in agents:
            a.wait_ready()
        router, feed = build_crosshost_router(
            bcfg, [a.url for a in agents])
        try:
            def run_bulk(sink_dir, fault=None):
                loader = StreamTestLoader(roidb, bcfg, imdb.load_image,
                                          batch_images=2, shuffle=False,
                                          seed=0, raw_images=False,
                                          num_workers=0)
                sink = BulkSink(sink_dir,
                                make_sink_manifest(bcfg, roidb, 0, 2))
                return BulkRunner(router, loader, sink, bcfg,
                                  fault=fault).run()

            ctrl_dir = os.path.join(workdir, "bulk_ctrl")
            kill_dir = os.path.join(workdir, "bulk_resume")
            ctrl = run_bulk(ctrl_dir)

            def fault(shard_i: int):
                if shard_i == 1:
                    raise _PlannedAbort(f"planned abort @shard="
                                        f"{shard_i}")

            aborted = False
            try:
                run_bulk(kill_dir, fault=fault)
            except _PlannedAbort:
                aborted = True
            resumed = run_bulk(kill_dir)
            names = sorted(f for f in os.listdir(ctrl_dir)
                           if f.startswith("shard-"))
            k_names = sorted(f for f in os.listdir(kill_dir)
                             if f.startswith("shard-"))

            def read(path):
                with open(path, "rb") as f:
                    return f.read()

            identical = names == k_names and all(
                read(os.path.join(ctrl_dir, n))
                == read(os.path.join(kill_dir, n)) for n in names)
            leg = {
                "corpus_images": len(roidb),
                "control": {k: ctrl[k] for k in
                            ("planned_images", "shards")},
                "aborted_mid_run": aborted,
                "resumed_shards": resumed["resumed_shards"],
                "resumed_images": resumed["resumed_images"],
                "byte_identical": identical,
            }
            if not aborted:
                problems.append("bulk leg: planned abort never fired")
            if not resumed["resumed_shards"]:
                problems.append("bulk resume re-scored everything — "
                                "committed prefix was not honored")
            if not identical:
                problems.append("bulk resume shards differ from the "
                                "uninterrupted control")
            return leg
        finally:
            feed.close()
            router.close()
    finally:
        for a in agents:
            a.kill()
