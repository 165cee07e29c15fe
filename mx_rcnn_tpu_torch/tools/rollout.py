"""The rollout plane's protocol: five legs over real agent processes.

Counterpart of ``mx_rcnn_tpu/tools/rollout.py``.  Drives the port's
:class:`~mx_rcnn_tpu_torch.serve.rollout.RolloutController` over real
``tools/agent.py`` processes on loopback ports, the cross-host rig's
way: every "host" is a process of this machine (sharing its cores and
its cards), so the legs check the plane, not several machines.  Legs:

1. **lineage**: the admission truth table over real exported stores: a
   v2 child admits against its recorded parent, an unknown parent and
   an unrooted version are refused, a ``train_fingerprint`` mismatch is
   refused, and a version-less store still admits;
2. **live swap**: two agents booted from a v1 store; a v2 store (the
   same weights) rolled out mid-burst through pull → canary (the online
   paired gate) → per-host rolling swap → finalize: every request ends
   once (0 lost), a mixed-bucket burst after the swap builds no kernel,
   each host pulls v2 once, and both hosts end all-v2;
3. **red team**: a v2d store whose bundled weights are damaged
   (additive noise): it passes lineage (its lineage is genuine, only its
   behaviour is wrong), the gate refuses it on the shadow-scored deltas,
   the controller rolls back by itself, every host ends base-only with
   0 lost, and a second rollback is a recorded no-op;
4. **kill mid-rollout** (full run): one agent SIGKILLed while its swap
   is in flight; the controller defers it, finishes the fleet, and
   FINALIZE brings the relaunched (clean-disk) host to v2: pull again,
   swap again;
5. **the 100-host sim** (full run): the virtual-time canary rollout over
   the same controller, shipped and damaged arms (``tools/sim.py``'s
   rubric).

``--smoke`` runs legs 1-3.  The port's differences: no compile cache
(the store's ``kernels/`` takes its place); agents bind ``--port 0`` and
report their port on a ready line (a relaunched agent gets a new port,
and the admin's source is pointed at it); the damaged store is verified
like every port store; "no kernel built after the swap" reads each
agent's ``agent.kernel_builds_after_warm``; ``--device`` (default
``cuda``) places the agents and the exporting predictor, and on the CPU
every process runs one intra-op thread (a store's digests hold across
processes only at one thread count).  Usage::

    python -m mx_rcnn_tpu_torch.tools.rollout --smoke --device cpu --check
    python -m mx_rcnn_tpu_torch.tools.rollout --network resnet101 \\
        --dataset coco --check
"""

from __future__ import annotations

# the lock sanitizer first: the locks the package allocates at import
# are born wrapped only if it is armed before
from mx_rcnn_tpu_torch.analysis import sanitizer  # isort: skip

sanitizer.maybe_install_from_env()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from typing import Dict, List  # noqa: E402

import numpy as np  # noqa: E402

from mx_rcnn_tpu_torch.config import (NETWORKS, Config,  # noqa: E402
                                      generate_config, parse_set_overrides)
from mx_rcnn_tpu_torch.tools.crosshost import (AgentProc,  # noqa: E402
                                               _prepared_set,
                                               _run_prepared_closed,
                                               _scrape)
from mx_rcnn_tpu_torch.tools.loadgen import (_drain,  # noqa: E402
                                             _smoke_overrides)

logger = logging.getLogger("mx_rcnn_tpu_torch")


def _damaged_variables(variables, scale: float, seed: int = 1):
    """The red-team arm's weights: every matrix or conv leaf (ndim >= 2)
    gains additive noise ``scale`` times its own mean magnitude.  The
    lineage stays genuine (the damaged store records the true parent and
    its own true fingerprint): only the model's behaviour is wrong, so
    nothing but the online paired gate can catch it.  The tree is the
    JAX-layout host tree and is walked in sorted key order, the order
    the JAX package's variables hold, so both packages draw the same
    noise for the same leaf."""
    rng = np.random.RandomState(seed)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in sorted(x.items())}
        a = np.asarray(x)
        if a.ndim >= 2:
            noise = rng.standard_normal(a.shape).astype(a.dtype)
            return a + scale * (np.abs(a).mean() + 1e-3) * noise
        return a

    return walk(variables)


def _store_server(root: str):
    from mx_rcnn_tpu_torch.serve.agent import make_store_server

    srv = make_store_server(root)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _lineage_leg(cfg: Config, predictor, workdir: str, v1_root: str,
                 v2_root: str, problems: List[str], *,
                 unrooted_root: str = None, legacy_root: str = None) -> Dict:
    """Leg 1: the admission truth table (lineage fields, refusals, the
    version-less store admitted).  ``v2_root`` is a child of
    ``v1_root``; the unrooted case reads ``unrooted_root`` (default
    ``v1_root``, a versioned store without a parent) and the version-less
    case ``legacy_root`` (default: one exported here)."""
    from mx_rcnn_tpu_torch.serve.export import (ExportMismatch, ExportStore,
                                                export_serve_programs,
                                                manifest_sha,
                                                predictor_variables,
                                                variables_fingerprint)

    if legacy_root is None:
        legacy_root = os.path.join(workdir, "store_legacy")
        export_serve_programs(predictor, cfg, legacy_root)

    sha1 = manifest_sha(v1_root)
    v1s, v2s = ExportStore(unrooted_root or v1_root), ExportStore(v2_root)
    table: Dict[str, Dict] = {}

    def case(name: str, fn, expect_refused: bool):
        try:
            lineage = fn()
            table[name] = {"refused": False, "lineage": lineage}
        except ExportMismatch as e:
            table[name] = {"refused": True, "error": str(e)[:160]}
        if table[name]["refused"] != expect_refused:
            problems.append(
                f"lineage case {name}: expected refused="
                f"{expect_refused}, got {table[name]}")

    case("child_admits",
         lambda: v2s.check_lineage(known_parents={sha1}), False)
    case("unknown_parent_refused",
         lambda: v2s.check_lineage(known_parents={"0" * 64}), True)
    case("unrooted_refused",
         lambda: v1s.check_lineage(known_parents={sha1}), True)
    case("fingerprint_mismatch_refused",
         lambda: v2s.check_lineage(
             known_parents={sha1},
             expect_train_fingerprint="deadbeef"), True)
    case("fingerprint_match_admits",
         lambda: v2s.check_lineage(
             known_parents={sha1},
             expect_train_fingerprint=variables_fingerprint(
                 predictor_variables(predictor))), False)
    case("legacy_versionless_admits",
         lambda: ExportStore(legacy_root).check_lineage(
             known_parents={sha1}), False)
    return {"parent_sha": sha1[:16], "cases": table}


def _ver_counters(url: str) -> Dict[str, float]:
    """The per-version counters one agent exports (``fleet.ver.<label>.*``,
    the canary rules' inputs)."""
    try:
        snap = _scrape(url)
    except OSError:
        return {}
    return {k: v for k, v in (snap.get("counters") or {}).items()
            if k.startswith("fleet.ver.")}


def _host_state(port, admin) -> Dict[str, Dict]:
    out = {}
    for source in sorted(admin.by_source):
        rec = {"versions": port.versions(source)}
        try:
            snap = _scrape(admin.by_source[source])
            rec["kernel_builds_after_warm"] = (
                snap["gauges"].get("agent.kernel_builds_after_warm"))
        except OSError:
            rec["kernel_builds_after_warm"] = None
        out[source] = rec
    return out


def _burst(router, prepared, duration_s: float, concurrency: int,
           timeout_ms: float) -> Dict:
    box: Dict = {}

    def run():
        box["run"] = _run_prepared_closed(router, prepared, duration_s,
                                          concurrency, timeout_ms)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    box["thread"] = t
    return box


class _PairLog:
    """The rollout port as the controller sees it, keeping every shadow
    pair ``(base score, canary score)`` it hands the gate."""

    def __init__(self, port):
        self._port = port
        self.pairs: List[List[float]] = []

    def __getattr__(self, name):
        return getattr(self._port, name)

    def shadow_pair(self):
        pair = self._port.shadow_pair()
        if pair is not None:
            self.pairs.append([float(x) for x in pair])
        return pair


def _controller(port, cfg: Config, version: str, store_url: str):
    from mx_rcnn_tpu_torch.serve.rollout import RolloutController

    return RolloutController(_PairLog(port), cfg, version=version,
                             store_url=store_url)


def _swap_leg_record(ctrl, run: Dict, snap: Dict, hosts: Dict) -> Dict:
    c = snap["counters"]
    return {
        "phase": ctrl.phase,
        "submitted": c["submitted"], "served": c["served"],
        "shed": c["shed"], "expired": c["expired"],
        "failed": c["failed"],
        "lost": c["submitted"] - snap["terminated"],
        "client": run["client"],
        "gate": ctrl.gate.verdict(),
        "events": [e["kind"] for e in ctrl.events],
        "hosts": hosts,
    }


def _check_exactly_once(name: str, leg: Dict,
                        problems: List[str]) -> None:
    if leg["lost"]:
        problems.append(f"{name}: lost {leg['lost']} requests")
    if leg["failed"] or leg["expired"]:
        problems.append(f"{name}: {leg['failed']} failed / "
                        f"{leg['expired']} expired mid-rollout — the "
                        "graceful drain path dropped work")
    if leg["served"] <= 0:
        problems.append(f"{name}: burst served nothing")


def rollout_config(cfg: Config) -> Config:
    """The rig's controller and wire cadence for two wall-clock hosts:
    a gate sample every tick, a verdict after 6 pairs, a 2 s bake, and a
    step timeout that covers a clean-disk agent's relaunch (leg 4), so
    FINALIZE brings it back instead of abandoning it.  An admin RPC
    waits for a pull while the agent downloads the store."""
    batch = cfg.serve.batch_size
    rcfg = cfg.replace_in("rollout", gate_min_pairs=6,
                          gate_sample_every=1, bake_s=2.0,
                          settle_s=0.25, step_timeout_s=45.0)
    return rcfg.replace_in("crosshost", connections=2,
                           pipeline_depth=4 * batch, scrape_interval_s=0.2,
                           io_timeout_s=30.0, admin_timeout_s=30.0)


def live_swap_leg(router, port, admin, agents, cfg: Config, prepared,
                  store_url: str, burst_s: float, post_s: float,
                  timeout_ms: float, problems: List[str]) -> Dict:
    """Leg 2: v2 (the boot weights) rolled out mid-burst, then a
    mixed-bucket burst after the swap (no kernel may build).  Every
    shadow pair must score the base arm above 0 and both arms alike."""
    from mx_rcnn_tpu_torch.serve.rollout import DONE

    batch = cfg.serve.batch_size
    ctrl = _controller(port, cfg, "v2", store_url)
    router.metrics.reset()  # per-leg accounting
    box = _burst(router, prepared, burst_s, concurrency=2 * batch * 2,
                 timeout_ms=timeout_ms)
    phase = ctrl.run(timeout_s=300.0)
    box["thread"].join()
    _drain(router)
    hosts = _host_state(port, admin)
    post = _run_prepared_closed(router, prepared, post_s,
                                concurrency=2 * batch * 2,
                                timeout_ms=timeout_ms)
    _drain(router)
    hosts_after = _host_state(port, admin)
    leg = _swap_leg_record(ctrl, box["run"], router.metrics.snapshot(),
                           hosts)
    leg["shadow_deltas"] = list(ctrl.gate._deltas)
    leg["shadow_pairs"] = ctrl.port.pairs
    leg["post_swap_client"] = post["client"]
    leg["builds_during_post_swap_burst"] = {
        s: (None if hosts_after[s]["kernel_builds_after_warm"] is None
            or hosts[s]["kernel_builds_after_warm"] is None
            else hosts_after[s]["kernel_builds_after_warm"]
            - hosts[s]["kernel_builds_after_warm"])
        for s in hosts}
    # one transfer a host: a second pull is a recorded no-op
    leg["repull_already"] = [
        bool((port.pull(s, store_url, "v2") or {}).get("already"))
        for s in sorted(admin.by_source)]
    leg["per_version_counters"] = {
        a.name: _ver_counters(a.url) for a in agents}
    if phase != DONE:
        problems.append(f"live swap ended {phase}, not done "
                        f"(events: {leg['events']})")
    _check_exactly_once("live swap", leg, problems)
    for src, h in hosts.items():
        if h["versions"] != {"v2": 1}:
            problems.append(f"live swap: {src} ended "
                            f"{h['versions']}, not all-v2")
    for src, delta in leg["builds_during_post_swap_burst"].items():
        if delta != 0:
            problems.append(
                f"live swap: {src} built {delta} kernel(s) during the "
                "post-swap burst: v2 does not serve from its store")
    if not post["client"].get("ok", 0) > 0:
        problems.append("live swap: the post-swap burst served nothing: "
                        "the build count is vacuous")
    if not all(leg["repull_already"]):
        problems.append("live swap: a second pull was not a no-op: one "
                        "transfer a host is broken")
    if not leg["gate"]["judged"] or leg["gate"]["refused"]:
        problems.append(f"live swap gate did not pass: {leg['gate']}")
    if not leg["shadow_pairs"] or any(
            b <= 0.0 or c != b for b, c in leg["shadow_pairs"]):
        problems.append(f"live swap: the shadow pairs "
                        f"{leg['shadow_pairs']} are not equal arms with a "
                        "base score above 0")
    if not any(k.endswith(".dispatched") for k in
               {c for d in leg["per_version_counters"].values()
                for c in d}):
        problems.append("no fleet.ver.* counters appeared: the "
                        "per-version accounting never engaged")
    return leg


def redteam_leg(router, port, admin, cfg: Config, prepared,
                store_url: str, burst_s: float, timeout_ms: float,
                problems: List[str]) -> Dict:
    """Leg 3: the damaged v2d refused by the gate, judged worse (mean
    delta below 0, the CI wholly below −budget), and rolled back by the
    controller; a second rollback, the scheduler's verb
    (``FleetScheduler.rollback`` with the controller attached), must be a
    recorded no-op."""
    from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore
    from mx_rcnn_tpu_torch.serve.rollout import ROLLED_BACK
    from mx_rcnn_tpu_torch.serve.scheduler import FleetScheduler

    batch = cfg.serve.batch_size
    ctrl = _controller(port, cfg, "v2d", store_url)
    router.metrics.reset()
    box = _burst(router, prepared, burst_s, concurrency=2 * batch * 2,
                 timeout_ms=timeout_ms)
    phase = ctrl.run(timeout_s=300.0)
    box["thread"].join()
    _drain(router)
    hosts = _host_state(port, admin)
    leg = _swap_leg_record(ctrl, box["run"], router.metrics.snapshot(),
                           hosts)
    leg["shadow_deltas"] = list(ctrl.gate._deltas)
    leg["shadow_pairs"] = ctrl.port.pairs
    leg["rollback_reason"] = ctrl.status()["rollback_reason"]
    leg["rollback_s"] = ctrl.rollback_s
    scheduler = FleetScheduler(TimeSeriesStore(), admin, cfg)
    scheduler.rollout = ctrl
    leg["rollback_noop"] = scheduler.rollback("operator")["result"]
    if phase != ROLLED_BACK:
        problems.append(f"red-team ended {phase}, not "
                        f"rolled_back ({leg['events']})")
    if leg["rollback_reason"] != "gate_refused":
        problems.append(f"red-team rollback reason "
                        f"{leg['rollback_reason']!r}, not the gate")
    gate = leg["gate"]
    if not gate["refused"]:
        problems.append(f"gate did not refuse the damaged "
                        f"model: {gate}")
    elif not (gate["mean_delta"] < 0
              and gate["ci95"][1] < -gate["budget"]):
        problems.append(f"the gate refused the damaged model without "
                        f"judging it worse: {gate}")
    _check_exactly_once("red-team", leg, problems)
    for src, h in hosts.items():
        if h["versions"] != {"base": 1}:
            problems.append(f"red-team: {src} ended "
                            f"{h['versions']}, not base-only")
    if not (leg["rollback_noop"] or {}).get("noop"):
        problems.append("second rollback was not a no-op: rollback is "
                        "not idempotent")
    return leg


def run_rollout_bench(args) -> int:
    import torch

    from mx_rcnn_tpu_torch.serve.export import (export_serve_programs,
                                                predictor_from_variables,
                                                predictor_variables)
    from mx_rcnn_tpu_torch.serve.fleet import default_devices
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router
    from mx_rcnn_tpu_torch.serve.rollout import AgentRolloutPort
    from mx_rcnn_tpu_torch.serve.scheduler import AgentAdmin
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    # the agents' device is resolved (and refused) before anything runs
    dev = default_devices(args.device)[0]
    env = None
    if dev.type == "cpu":
        # a store's digests hold across processes only at one thread
        # count: one here and in every agent
        torch.set_num_threads(1)
        env = {"OMP_NUM_THREADS": "1"}
    smoke = args.smoke
    overrides = dict(_smoke_overrides())  # the tiny rig's canvas on both
    # tiers: every "host" shares one machine; the full run differs in legs
    overrides.update(parse_set_overrides(args.set))
    cfg = generate_config(args.network, args.dataset, **overrides)
    agent_overrides = dict(overrides)
    workdir = args.workdir or tempfile.mkdtemp(prefix="rollout_")
    os.makedirs(workdir, exist_ok=True)
    timeout_ms = 20_000.0 if args.timeout_ms is None else args.timeout_ms
    rcfg = rollout_config(cfg)
    rec: Dict = {
        "metric": "rollout_live_swap_exactly_once",
        "unit": "invariant",
        "measured": True,
        "smoke": smoke,
        "network": args.network,
        "device": args.device,
        "bucket_shapes": [list(b) for b in cfg.bucket.shapes],
        "batch_size": cfg.serve.batch_size,
        "host": {"cores": os.cpu_count()},
        "note": "every 'host' is a separate agent process sharing this "
                "machine's cores and cards: the invariants (exactly "
                "once, no kernel build after the swap, the gate's "
                "refusal, the re-convergence) check the rollout plane, "
                "not several machines",
    }
    problems: List[str] = []
    prepared = _prepared_set(cfg, args.images, args.seed)
    dur = min(args.duration, 4.0) if smoke else max(args.duration, 8.0)

    # -- stores: v1 (boot), v2 (the same weights), v2d (damaged)
    v1_root = os.path.join(workdir, "store_v1")
    v2_root = os.path.join(workdir, "store_v2")
    v2d_root = os.path.join(workdir, "store_v2d")
    logger.info("[rollout] exporting v1/v2/v2d stores -> %s", workdir)
    predictor = init_predictor(cfg, args.prefix, args.epoch, args.seed,
                               args.device)
    export_serve_programs(predictor, cfg, v1_root, version="v1",
                          bundle_variables=True)
    export_serve_programs(predictor, cfg, v2_root, version="v2",
                          parent=v1_root, bundle_variables=True)
    damaged = predictor_from_variables(
        _damaged_variables(predictor_variables(predictor), scale=10.0),
        cfg, predictor.device)
    export_serve_programs(damaged, cfg, v2d_root, version="v2d",
                          parent=v1_root, bundle_variables=True)
    del damaged

    # -- 1. the lineage truth table
    logger.info("[rollout] lineage leg ...")
    rec["lineage"] = _lineage_leg(cfg, predictor, workdir, v1_root,
                                  v2_root, problems)
    del predictor

    srv1, url1 = _store_server(v1_root)
    srv2, url2 = _store_server(v2_root)
    srv2d, url2d = _store_server(v2d_root)

    def agent(name: str) -> AgentProc:
        return AgentProc(workdir, name, agent_overrides,
                         network=args.network, dataset=args.dataset,
                         replicas=1, store_url=url1, device=args.device,
                         export_dir=os.path.join(workdir, f"{name}_store"),
                         env=env)

    logger.info("[rollout] launching 2 agents ...")
    agents = [agent(f"roll-{i}") for i in range(2)]
    try:
        for a in agents:
            a.wait_ready()
        urls = [a.url for a in agents]
        admin = AgentAdmin.from_config(urls, rcfg)
        port = AgentRolloutPort(admin)
        router, feed = build_crosshost_router(rcfg, urls)
        try:
            # -- 2. the live v1 -> v2 swap mid-burst
            logger.info("[rollout] live swap leg (v2 mid-burst) ...")
            rec["live_swap"] = live_swap_leg(
                router, port, admin, agents, rcfg, prepared, url2,
                max(dur * 3, 12.0), max(dur, 3.0), timeout_ms, problems)
            # -- 3. the red team: damaged weights, the gate's refusal
            logger.info("[rollout] red-team leg (damaged v2d) ...")
            rec["redteam"] = redteam_leg(
                router, port, admin, rcfg, prepared, url2d,
                max(dur * 3, 12.0), timeout_ms, problems)
            # -- 4. SIGKILL mid-rollout, relaunch, re-converge
            if not smoke:
                logger.info("[rollout] kill-mid-rollout leg ...")
                rec["kill_rollout"] = _kill_leg(agent, agents, port, admin,
                                                rcfg, url2, problems)
        finally:
            feed.close()
            router.close()
    finally:
        for a in agents:
            a.kill()
        for srv in (srv1, srv2, srv2d):
            srv.shutdown()
            srv.server_close()

    # -- 5. the fleet-scale virtual-time arm
    if not smoke:
        logger.info("[rollout] sim 100-host leg ...")
        rec["sim_100h"] = _sim_leg(args.seed, problems)

    print(json.dumps(rec))
    if args.out:
        from mx_rcnn_tpu_torch.tools.sim import _atomic_json

        _atomic_json(args.out, rec)
    if args.check:
        problems += sanitizer.check_problems()
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        return 1 if problems else 0
    return 0


def _kill_leg(make_agent, agents: List[AgentProc], port, admin,
              rcfg: Config, url2: str, problems: List[str]) -> Dict:
    """Leg 4: SIGKILL one agent while its rolling swap is in flight.  The
    relaunch gets a clean store directory (a replaced host, not a
    rebooted one) and a port of its own, which the admin's source is
    pointed at once it is ready: FINALIZE must pull v2 onto it again and
    swap it again."""
    from mx_rcnn_tpu_torch.serve.remote import normalize_agent_url
    from mx_rcnn_tpu_torch.serve.rollout import DONE, ROLLING, _TERMINAL

    ctrl = _controller(port, rcfg, "v2", url2)
    ctrl.start()
    killed_source = sorted(admin.by_source)[1]
    killed = False
    deadline = time.monotonic() + 420.0
    while ctrl.phase not in _TERMINAL and time.monotonic() < deadline:
        ctrl.step()
        if (not killed and ctrl.phase == ROLLING
                and any(e["kind"] == "host_rolling"
                        and e.get("source") == killed_source
                        for e in ctrl.events)):
            agents[1].sigkill()
            killed = True
            # the replacement, on a clean disk; it warms while the rest
            # of the rollout runs
            agents[1] = make_agent("roll-1b")

            def relaunch(a=agents[1]):
                a.wait_ready()
                admin.by_source[killed_source] = normalize_agent_url(a.url)

            threading.Thread(target=relaunch, daemon=True).start()
        time.sleep(rcfg.rollout.settle_s)
    hosts = _host_state(port, admin)
    leg = {
        "phase": ctrl.phase,
        "killed": killed,
        "killed_source": killed_source,
        "events": [e["kind"] for e in ctrl.events],
        "deferred": ctrl.status()["deferred"],
        "hosts": hosts,
    }
    if not killed:
        problems.append("kill leg: never reached the kill point")
    if ctrl.phase != DONE:
        problems.append(f"kill leg ended {ctrl.phase}, not done "
                        f"({leg['events']})")
    if "host_deferred" not in leg["events"]:
        problems.append("kill leg: the killed host was never deferred: "
                        "the kill did not land mid-swap")
    for src, h in hosts.items():
        if h["versions"] != {"v2": 1}:
            problems.append(f"kill leg: {src} ended {h['versions']}: "
                            "FINALIZE did not bring the fleet to v2")
    return leg


def _sim_leg(seed: int, problems: List[str]) -> Dict:
    """Leg 5: the 100-host virtual-time canary rollout, both arms, under
    the sim gauntlet's rubric (``tools/sim.py``)."""
    from mx_rcnn_tpu_torch.sim.traffic import generate
    from mx_rcnn_tpu_torch.tools.sim import MISTUNED_BY_SCENARIO, _arm

    cfg = generate_config("tiny", "synthetic")
    trace = generate("canary_rollout", cfg, 100, max(seed, 0))
    shipped = _arm(trace, cfg, "shipped")
    mistuned = _arm(trace, cfg, "mistuned",
                    MISTUNED_BY_SCENARIO["canary_rollout"])

    def summary(s: Dict) -> Dict:
        r = s.get("rollout") or {}
        return {"lost": s["lost"], "served": s["served"],
                "phase": r.get("phase"), "reason": r.get("reason"),
                "final_versions": r.get("final_versions"),
                "gate": r.get("gate"), "wall_s": s["wall_s"]}

    leg = {"hosts": trace["hosts"], "seed": trace["seed"],
           "shipped": summary(shipped), "mistuned": summary(mistuned)}
    sh, mi = leg["shipped"], leg["mistuned"]
    if sh["phase"] != "done" or sh["final_versions"] != {"v2": 100}:
        problems.append(f"sim shipped arm: {sh}")
    if sh["lost"] or mi["lost"]:
        problems.append(f"sim lost requests: shipped {sh['lost']}, "
                        f"mistuned {mi['lost']}")
    if (mi["phase"] != "rolled_back" or mi["reason"] != "gate_refused"
            or set(mi["final_versions"] or {}) != {"base"}):
        problems.append(f"sim mistuned arm not refused+rolled back: "
                        f"{mi}")
    return leg


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="tiny", choices=NETWORKS)
    p.add_argument("--dataset", default="synthetic",
                   choices=["PascalVOC", "coco", "synthetic",
                            "synthetic_hard"])
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix (default: random weights; the "
                        "invariants do not depend on them)")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the agents' and the exporter's device: cuda "
                        "(default), cuda:k or cpu")
    p.add_argument("--duration", type=float, default=4.0,
                   help="each leg's burst window, seconds")
    p.add_argument("--timeout_ms", type=float, default=None)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--workdir", default=None,
                   help="the stores' and agent logs' directory (default: "
                        "a new temporary one)")
    p.add_argument("--out", default=None,
                   help="also write the protocol's record here")
    p.add_argument("--smoke", action="store_true",
                   help="legs 1-3 only")
    p.add_argument("--check", action="store_true",
                   help="exit nonzero on any broken invariant")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   default=[], help="config override (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    return run_rollout_bench(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
