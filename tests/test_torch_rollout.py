"""The rollout plane against the JAX package's, on the CPU.

``serve/rollout.py``'s judgments (``paired_stats``, ``detection_score``,
``OnlinePairedGate``, ``rollout_rules``) equal the JAX ones on seeded
inputs; the port's ``RolloutController`` and the JAX one, each over the
same scripted fake port and fake clock, write byte-equal decision logs
(canonical JSON) in every path: a clean rollout, the gate's refusal and
automatic rollback, rollbacks repeated and after a finished rollout, a
health-critical rollback, a killed host deferred then brought back in
FINALIZE, a host abandoned after the grace, a host that cannot pull;
``tools/rollout.py — _damaged_variables`` damages the bridged tiny tree
as the JAX one does; and an in-process port agent (the tiny model on the
CPU) is driven through ``AgentRolloutPort`` over ``POST /rollout``:
pulls, lineage refusals (400), the swap, the canary lane, the shadow
pair (``(base, canary)``: a damaged canary scores below its base),
rollback, and ``FleetScheduler.rollback`` reaching the attached
controller.  The agents' rolling swap and rollback steps
(``ReplicaAgent._pump_toward``) equal the JAX ones over one scripted
replica set.  The config sections and ``Config.replace`` are held to
the JAX ones.
"""

import dataclasses
import functools
import http.client
import json
import threading
import time
from types import SimpleNamespace
from urllib.parse import urlsplit

import numpy as np
import pytest

from mx_rcnn_tpu import config as jconfig
from mx_rcnn_tpu.obs.health import CRITICAL as J_CRITICAL
from mx_rcnn_tpu.serve import rollout as jr
from mx_rcnn_tpu.serve.agent import ReplicaAgent as JReplicaAgent
from mx_rcnn_tpu.sim.score import decision_log_bytes as j_log_bytes
from mx_rcnn_tpu_torch import config as pconfig
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.obs.health import CRITICAL
from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore
from mx_rcnn_tpu_torch.serve import rollout as pr
from mx_rcnn_tpu_torch.serve.agent import (ReplicaAgent, make_agent_server,
                                           make_store_server)
from mx_rcnn_tpu_torch.serve.export import (export_serve_programs,
                                            manifest_sha,
                                            predictor_from_variables,
                                            predictor_variables)
from mx_rcnn_tpu_torch.serve.fleet import version_label
from mx_rcnn_tpu_torch.serve.scheduler import AgentAdmin, FleetScheduler
from mx_rcnn_tpu_torch.sim.score import decision_log_bytes
from mx_rcnn_tpu_torch.tools.loadgen import _smoke_overrides
from mx_rcnn_tpu_torch.tools.rollout import _damaged_variables


# ---- the judgments ---------------------------------------------------------

def _delta_sets():
    rng = np.random.RandomState(11)
    out = [[], [0.0], [0.0] * 8, [-0.7, -0.75, -0.8, -0.72, -0.78],
           [0.01, -0.01, 0.02, 0.0], [0.5, -0.5, 0.4, -0.4]]
    for n in (2, 3, 12, 31, 45):
        out.append(list(rng.normal(rng.uniform(-0.05, 0.05),
                                   rng.uniform(0.001, 0.2), n)))
    return out


@pytest.mark.parametrize("i", range(11))
@pytest.mark.parametrize("budget", [0.02, 0.1])
def test_paired_stats_equal_jax(i, budget):
    deltas = _delta_sets()[i]
    assert pr.paired_stats(deltas, budget) == jr.paired_stats(deltas, budget)


def test_t_table_is_the_jax_one():
    assert pr.T975 == jr.T975


def test_detection_score_equals_jax():
    rng = np.random.RandomState(3)
    cases = [{}, {"c": np.zeros((0, 5))}, [np.zeros((0, 5))],
             {"c": np.array([0, 0, 9, 9, 0.9])}]
    for n in (1, 5, 40):
        cases.append({k: rng.rand(rng.randint(0, n + 1), 5)
                      .astype(np.float32) for k in range(1, 4)})
        cases.append([rng.rand(n, 5)])
    for dets in cases:
        got, want = pr.detection_score(dets), jr.detection_score(dets)
        assert got == want and type(got) is type(want)
    same = {"c": np.array([[0, 0, 10, 10, 0.9], [1, 1, 5, 5, 0.8]])}
    assert pr.detection_score(same) - pr.detection_score(dict(same)) == 0.0


@pytest.mark.parametrize("min_pairs", [1, 4, 12])
def test_online_gate_verdict_equals_jax(min_pairs):
    rng = np.random.RandomState(min_pairs)
    ours = pr.OnlinePairedGate(budget=0.02, min_pairs=min_pairs)
    theirs = jr.OnlinePairedGate(budget=0.02, min_pairs=min_pairs)
    for k in range(16):
        assert ours.verdict() == theirs.verdict()
        base = 0.8 + 0.05 * rng.standard_normal()
        canary = base - (0.3 if k % 3 == 0 else 0.0)
        ours.add_pair(base, canary)
        theirs.add_pair(base, canary)
    assert ours.pairs() == theirs.pairs() == 16
    assert ours.verdict() == theirs.verdict()


@pytest.mark.parametrize("version", ["v2", "r-1.0", "a b/c", None, ""])
def test_rollout_rules_and_labels_equal_jax(version):
    cfg = generate_config("tiny", "synthetic", serve__default_timeout_ms=750.0)
    jcfg = jconfig.generate_config("tiny", "synthetic",
                                   serve__default_timeout_ms=750.0)
    assert version_label(version) == jr.version_label(version)
    assert pr.version_label is version_label
    if version is None:
        return
    ours = [dataclasses.asdict(r) for r in pr.rollout_rules(cfg, version)]
    theirs = [dataclasses.asdict(r) for r in jr.rollout_rules(jcfg, version)]
    assert ours == theirs


# ---- the controller over one scripted port ---------------------------------

class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class FakePort:
    """The port protocol, scripted: each host swaps base → v2 in two
    pumps (add the v2 replica, then drain base), as the agent's pump
    does; the shadow pairs come from a seeded stream."""

    def __init__(self, names, damage=0.0, seed=0):
        self.hosts = {n: {"versions": {"base": 1}, "pulls": 0, "down": False}
                      for n in names}
        self.damage = damage
        self.rng = np.random.RandomState(seed)

    def sources(self):
        return sorted(self.hosts)

    def pull(self, source, url, version):
        h = self.hosts[source]
        if h["down"]:
            return None
        h["pulls"] += 1
        return {"already": h["pulls"] > 1}

    def versions(self, source):
        h = self.hosts[source]
        return None if h["down"] else dict(h["versions"])

    def swap_next(self, source, version):
        h = self.hosts[source]
        if h["down"]:
            return None
        if h["versions"].get(version, 0) < 1:
            h["versions"][version] = 1
            return {"added": 1, "remaining": 1, "pending": False}
        if h["versions"].get("base", 0) > 0:
            del h["versions"]["base"]
            return {"swapped": 1, "remaining": 0, "pending": False}
        return {"remaining": 0, "pending": False}

    def rollback(self, source):
        h = self.hosts[source]
        if h["down"]:
            return None
        h["versions"] = {"base": 1}
        return {"remaining": 0, "pending": False}

    def set_canary(self, version, fraction):
        pass

    def shadow_pair(self):
        base = round(0.8 + 0.01 * float(self.rng.standard_normal()), 6)
        return base, round(base - self.damage, 6)


def _kill_then_relaunch(port, events):
    kinds = [e["kind"] for e in events]
    b = port.hosts["b"]
    if (not b["down"] and "host_deferred" not in kinds
            and any(e["kind"] == "host_rolling" and e.get("source") == "b"
                    for e in events)):
        b["down"] = True
        b["versions"] = {"base": 1}
    if "host_deferred" in kinds:
        b["down"] = False


def _kill_for_good(port, events):
    if any(e["kind"] == "host_rolling" and e.get("source") == "b"
           for e in events):
        port.hosts["b"]["down"] = True


CASES = {
    # name: (hosts, damage, health verdict, on_tick, after)
    "clean": (["a", "b", "c"], 0.0, None, None, None),
    "gate_refused": (["a", "b"], 0.75, None, None, None),
    "rollback_twice": (["a"], 0.75, None, None, "rollback"),
    "rollback_after_done": (["a", "b"], 0.0, None, None, "rollback"),
    "health_critical": (["a"], 0.0, "CRITICAL", None, None),
    "health_ok": (["a", "b"], 0.0, "OK", None, None),
    "killed_host_reconverged": (["a", "b", "c"], 0.0, None,
                                _kill_then_relaunch, None),
    "host_abandoned": (["a", "b"], 0.0, None, _kill_for_good, None),
    "unpullable_host": (["a", "b"], 0.0, None, "b_down", None),
}


def _run_controller(mod, cfg, critical, case):
    hosts, damage, verdict, on_tick, after = CASES[case]
    port = FakePort(hosts, damage=damage, seed=7)
    clock = FakeClock()
    if on_tick == "b_down":
        port.hosts["b"]["down"] = True
        on_tick = None
    health = None
    if verdict is not None:
        # a health engine's face: its verdict, and the stamp of the
        # sample it last judged (the decisions' correlation id)
        health = SimpleNamespace(
            verdict=critical if verdict == "CRITICAL" else verdict,
            last=lambda: {"ts": clock.now - 0.5})
    ctrl = mod.RolloutController(port, cfg, version="v2",
                                 store_url="http://store", clock=clock,
                                 health=health)
    ctrl.start()
    for _ in range(200):
        if ctrl.phase in (mod.DONE, mod.ROLLED_BACK):
            break
        ctrl.step()
        clock.now += 1.0
        if on_tick is not None:
            on_tick(port, ctrl.events)
    out = {"phase": ctrl.phase, "status": ctrl.status()}
    if after == "rollback":
        out["rollback"] = ctrl.rollback("operator")
        for _ in range(20):
            if ctrl.phase != mod.ROLLING_BACK:
                break
            ctrl.step()
            clock.now += 1.0
        out["again"] = ctrl.rollback("scheduler")
        out["phase_after"] = ctrl.phase
    out["versions"] = {h: port.hosts[h]["versions"] for h in hosts}
    return ctrl.events, out


def _controller_cfgs():
    kw = dict(rollout__gate_min_pairs=3, rollout__gate_sample_every=1,
              rollout__bake_s=4.0, rollout__step_timeout_s=10.0,
              rollout__canary_fraction=0.25)
    return (generate_config("tiny", "synthetic", **kw),
            jconfig.generate_config("tiny", "synthetic", **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_decision_log_is_byte_equal_to_jax(case):
    cfg, jcfg = _controller_cfgs()
    ours, o = _run_controller(pr, cfg, CRITICAL, case)
    theirs, t = _run_controller(jr, jcfg, J_CRITICAL, case)
    assert decision_log_bytes(ours) == j_log_bytes(theirs)
    assert ours and o == t
    kinds = [e["kind"] for e in ours]
    want = {"clean": "done", "gate_refused": "rolled_back",
            "rollback_twice": "rolled_back", "rollback_after_done": "done",
            "health_critical": "rolled_back", "health_ok": "done",
            "killed_host_reconverged": "done", "host_abandoned": "done",
            "unpullable_host": "done"}[case]
    assert o["phase"] == want, kinds
    if case == "gate_refused":
        assert "gate_refused" in kinds and "host_rolling" not in kinds
    if case in ("rollback_twice", "rollback_after_done"):
        assert o["again"]["noop"] is True
        assert o["phase_after"] == "rolled_back"
        assert all(v == {"base": 1} for v in o["versions"].values())
    if case == "killed_host_reconverged":
        assert "host_deferred" in kinds
        assert "finalize_abandoned" not in kinds
        assert all(v == {"v2": 1} for v in o["versions"].values())
    if case in ("host_abandoned", "unpullable_host"):
        assert "finalize_abandoned" in kinds
    if case == "health_critical":
        assert o["status"]["rollback_reason"] == "health_critical"


# ---- the red team's weights ------------------------------------------------

def test_damaged_variables_equal_jax_leaf_for_leaf():
    import jax

    from mx_rcnn_tpu.tools.rollout import _damaged_variables as j_damage
    from mx_rcnn_tpu_torch.tools.rollout import _damaged_variables

    cfg = generate_config("tiny", "synthetic")
    tree = predictor_variables(Predictor(build_model(cfg, "cpu", seed=3),
                                         cfg, "cpu"))
    # the JAX package holds its variables in sorted key order, as a
    # pytree round trip leaves them; the bridged tree is in module order
    jtree = jax.tree_util.tree_map(np.asarray, tree)
    assert list(tree["params"]) != sorted(tree["params"])
    ours = jax.tree_util.tree_leaves_with_path(_damaged_variables(tree, 10.0))
    theirs = jax.tree_util.tree_leaves_with_path(j_damage(jtree, 10.0))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    clean = dict(jax.tree_util.tree_leaves_with_path(jtree))
    changed = [p for p, a in ours if a.tobytes() != clean[p].tobytes()]
    assert changed and all(len(clean[p].shape) >= 2 for p in changed)


# ---- the config sections -----------------------------------------------------

@pytest.mark.parametrize("name", ["SimConfig", "RolloutConfig"])
def test_config_sections_equal_jax(name):
    ours = [(f.name, f.default) for f in
            dataclasses.fields(getattr(pconfig, name))]
    theirs = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jconfig, name))]
    assert ours == theirs


def test_config_replace_equals_jax():
    cfg = generate_config("resnet101", "coco")
    jcfg = jconfig.generate_config("resnet101", "coco")
    got = cfg.replace(rollout=pconfig.RolloutConfig(wave=3),
                      sim=pconfig.SimConfig(hosts=7))
    want = jcfg.replace(rollout=jconfig.RolloutConfig(wave=3),
                        sim=jconfig.SimConfig(hosts=7))
    for section in ("rollout", "sim", "serve", "crosshost"):
        assert (dataclasses.asdict(getattr(got, section))
                == dataclasses.asdict(getattr(want, section)))
    assert got.rollout.wave == 3 and cfg.rollout.wave == 1
    with pytest.raises(TypeError):
        cfg.replace(no_such_section=1)


# ---- an agent driven through AgentRolloutPort --------------------------------

def _post(url, body):
    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60.0)
    try:
        conn.request("POST", "/rollout", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _wait(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def agent_run(tmp_path_factory):
    """One pass of the rollout verbs over one in-process tiny agent; the
    tests below read its record."""
    tmp = tmp_path_factory.mktemp("rollout")
    cfg = generate_config("tiny", "synthetic", **_smoke_overrides())
    pred = Predictor(build_model(cfg, "cpu", seed=5), cfg, "cpu")
    roots = {v: str(tmp / f"store_{v}") for v in
             ("v1", "v2", "vf", "vu", "vp", "vd")}
    export_serve_programs(pred, cfg, roots["v1"], version="v1",
                          bundle_variables=True)
    for v, parent in (("v2", roots["v1"]), ("vf", roots["v1"]),
                      ("vu", None), ("vp", "0" * 64)):
        export_serve_programs(pred, cfg, roots[v], version=v, parent=parent,
                              bundle_variables=True)
    damaged = predictor_from_variables(
        _damaged_variables(predictor_variables(pred), 10.0), cfg, "cpu")
    export_serve_programs(damaged, cfg, roots["vd"], version="vd",
                          parent=roots["v1"], bundle_variables=True)
    servers, urls = {}, {}
    for v, root in roots.items():
        srv = make_store_server(root)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers[v] = srv
        urls[v] = f"http://127.0.0.1:{srv.server_address[1]}"
    acfg = cfg.replace_in("crosshost", store_url=urls["v1"],
                          agent_replicas=1)
    acfg = acfg.replace_in("fleet", export_dir=str(tmp / "agent"))
    ag = ReplicaAgent(acfg, device="cpu")
    asrv = make_agent_server(ag, "127.0.0.1", 0)
    threading.Thread(target=asrv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{asrv.server_address[1]}"
    admin = AgentAdmin([url], timeout_s=60.0)
    port = pr.AgentRolloutPort(admin)
    r = {"boot_sha": manifest_sha(roots["v1"])}
    try:
        r["refusals"] = {
            "unknown_parent": _post(url, {"op": "pull", "url": urls["vp"],
                                          "version": "vp"}),
            "unrooted": _post(url, {"op": "pull", "url": urls["vu"],
                                    "version": "vu"}),
            "fingerprint": _post(url, {"op": "pull", "url": urls["vf"],
                                       "version": "vf",
                                       "train_fingerprint": "deadbeef"}),
            "unknown_op": _post(url, {"op": "frobnicate"}),
            "swap_unpulled": _post(url, {"op": "swap", "version": "v9"}),
        }
        r["pull"] = port.pull("agent-0", urls["v2"], "v2")
        r["repull"] = port.pull("agent-0", urls["v2"], "v2")
        with servers["v2"].stats_lock:
            r["v2_requests"] = [q["rel"] for q in servers["v2"].requests]
        r["v2_files"] = sorted(servers["v2"].index)
        r["versions_boot"] = port.versions("agent-0")
        r["no_lane_shadow"] = _post(url, {"op": "shadow"})[1]
        port.set_canary("v2", 0.25)
        r["canary_set"] = ag.rollout_canary_state()
        r["swaps"] = [port.swap_next("agent-0", "v2")]
        _wait(lambda: port.versions("agent-0") == {"base": 1, "v2": 1})
        r["versions_both"] = port.versions("agent-0")
        r["pairs"] = [port.shadow_pair() for _ in range(3)]
        r["shadow_raw"] = _post(url, {"op": "shadow"})[1]
        while not r["swaps"][-1].get("done"):
            r["swaps"].append(port.swap_next("agent-0", "v2"))
            time.sleep(0.05)
            assert len(r["swaps"]) < 400
        r["versions_v2"] = port.versions("agent-0")
        r["default_version"] = ag.manager.default_version
        port.set_canary(None, 0.0)
        r["canary_cleared"] = ag.rollout_canary_state()
        r["rollbacks"] = [port.rollback("agent-0")]
        while not r["rollbacks"][-1].get("done"):
            r["rollbacks"].append(port.rollback("agent-0"))
            time.sleep(0.05)
            assert len(r["rollbacks"]) < 400
        r["rollback_again"] = port.rollback("agent-0")
        r["versions_end"] = port.versions("agent-0")
        r["status"] = _post(url, {"op": "status"})[1]
        r["health"] = ag.healthz()
        # the scheduler's verb reaches an attached controller
        sched = FleetScheduler(TimeSeriesStore(), admin, acfg)
        r["sched_none"] = sched.rollback("operator")
        ctrl = pr.RolloutController(port, acfg, version="v2",
                                    store_url=urls["v2"])
        sched.rollout = ctrl
        ctrl.start()
        r["sched_first"] = sched.rollback("operator")
        r["sched_second"] = sched.rollback("operator")
        for _ in range(10):
            if ctrl.step() == pr.ROLLED_BACK:
                break
        r["ctrl_phase"] = ctrl.phase
        r["ctrl_events"] = [e["kind"] for e in ctrl.events]
        # a damaged canary beside the base: the pair's order shows in
        # the sign of its delta
        port.pull("agent-0", urls["vd"], "vd")
        port.set_canary("vd", 0.25)
        port.swap_next("agent-0", "vd")
        _wait(lambda: port.versions("agent-0") == {"base": 1, "vd": 1})
        r["damaged_pairs"] = [port.shadow_pair() for _ in range(3)]
    finally:
        asrv.shutdown()
        asrv.server_close()
        ag.close()
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
    return r


def test_a_version_is_pulled_once(agent_run):
    r = agent_run
    assert r["pull"]["already"] is False and r["pull"]["version"] == "v2"
    assert r["pull"]["lineage"]["parent_sha"] == r["boot_sha"]
    assert r["repull"]["already"] is True
    assert sorted(r["v2_requests"]) == r["v2_files"]
    assert r["versions_boot"] == {"base": 1}


@pytest.mark.parametrize("case", ["unknown_parent", "unrooted", "fingerprint",
                                  "unknown_op", "swap_unpulled"])
def test_refused_pulls_and_bad_verbs_answer_400(agent_run, case):
    status, payload = agent_run["refusals"][case]
    assert status == 400, payload
    if case in ("unknown_parent", "unrooted", "fingerprint"):
        assert payload["error"].startswith("ExportMismatch")
    assert agent_run["status"]["pulled"] == ["v2"]


def test_swap_pumps_to_done_through_both_arms(agent_run):
    r = agent_run
    assert r["swaps"][0]["added"] is not None and r["swaps"][0]["pending"]
    assert any(s.get("swapped") is not None for s in r["swaps"])
    assert r["swaps"][-1] == {"done": True, "remaining": 0}
    assert r["versions_both"] == {"base": 1, "v2": 1}
    assert r["versions_v2"] == {"v2": 1}
    assert r["default_version"] == "v2"


def test_the_canary_lane_sets_and_clears(agent_run):
    assert agent_run["canary_set"] == ["v2", 0.25]
    assert agent_run["canary_cleared"] is None
    assert agent_run["no_lane_shadow"]["pair"] is None


def test_same_weights_shadow_delta_is_exactly_zero(agent_run):
    pairs = agent_run["pairs"]
    assert all(p is not None for p in pairs)
    assert [b - a for a, b in pairs] == [0.0, 0.0, 0.0]
    assert pairs[0][0] > 0.0
    assert agent_run["shadow_raw"]["seq"] == 3


def test_rollback_to_base_is_idempotent(agent_run):
    r = agent_run
    assert r["rollbacks"][-1] == {"done": True, "remaining": 0}
    assert r["rollback_again"] == {"done": True, "remaining": 0}
    assert r["versions_end"] == {"base": 1}
    assert r["status"]["pulled"] == ["v2"]
    h = r["health"]
    # the boot replica, the v2 replica and the base replica rolled back
    assert h["replica_warms"] == 3
    assert h["kernel_builds_after_warm"] == 0
    assert h["engine_batches"] >= 6   # the shadow pairs' batches


def test_scheduler_rollback_reaches_the_attached_controller(agent_run):
    r = agent_run
    assert r["sched_none"]["error"] == "NoRolloutController"
    first = r["sched_first"]
    assert "error" not in first
    assert first["result"] == {"phase": "rolling_back", "noop": False,
                               "reason": "operator"}
    assert r["sched_second"]["result"] == {"phase": "rolling_back",
                                           "noop": True}
    assert r["ctrl_phase"] == "rolled_back"
    assert r["ctrl_events"] == ["start", "rollback", "rollback_noop",
                                "rolled_back"]


def test_a_damaged_canary_scores_below_its_base(agent_run):
    pairs = agent_run["damaged_pairs"]
    assert all(p is not None for p in pairs)
    assert all(base > canary for base, canary in pairs), pairs


# ---- the rolling swap's steps against the JAX agent's ------------------------

class _PumpReplica:
    def __init__(self, rid, version, ready_at, step):
        self.id, self.version = rid, version
        self._ready_at, self._step = ready_at, step

    def ready(self):
        return self._step[0] >= self._ready_at


class _PumpManager:
    """A scripted replica set: a replica added at step ``s`` is ready at
    ``s + warm``; boot replica 0 is ready only at ``late_boot``; a drain
    removes its replica at once."""

    def __init__(self, n_boot, warm, late_boot):
        self.step = [0]
        self.warm = warm
        self.replicas = [_PumpReplica(i, None, late_boot if i == 0 else 0,
                                      self.step) for i in range(n_boot)]
        self._next = n_boot
        self._build_fn = "boot"
        self.default_version = None
        self.built_with = []

    def add_replica(self, build_fn=None, version=None):
        r = _PumpReplica(self._next, version, self.step[0] + self.warm,
                         self.step)
        self._next += 1
        self.replicas.append(r)
        self.built_with.append(build_fn)
        return r

    def drain_replica(self, rid=None):
        self.replicas = [r for r in self.replicas if r.id != rid]
        return rid


def _pump_run(cls, want, n_boot, warm, late_boot):
    """``cls``'s rollout_swap to v2 then rollout_rollback, one step a
    tick until done, as unbound methods over one scripted manager."""
    mgr = _PumpManager(n_boot, warm, late_boot)
    agent = SimpleNamespace(manager=mgr, _target_replicas=want,
                            _rollout_lock=threading.Lock(),
                            _boot_build_fn="boot",
                            _versions={"v2": {"build_fn": "v2"}})
    agent._pump_toward = functools.partial(cls._pump_toward, agent)
    out = {}
    for name, verb in (("swap", lambda: cls.rollout_swap(agent, "v2")),
                       ("rollback", lambda: cls.rollout_rollback(agent))):
        steps = []
        while not (steps and steps[-1].get("done")):
            steps.append(verb())
            mgr.step[0] += 1
            assert len(steps) < 60
        out[name] = {"steps": steps,
                     "replicas": [(r.id, r.version) for r in mgr.replicas],
                     "build_fn": mgr._build_fn,
                     "default_version": mgr.default_version}
    out["built_with"] = mgr.built_with
    return out


@pytest.mark.parametrize("want,n_boot,warm,late_boot", [
    (1, 1, 0, 0), (2, 2, 1, 0), (3, 3, 2, 0), (2, 2, 0, 3), (3, 2, 1, 0),
    (2, 3, 1, 2)])
def test_pump_steps_equal_jax(want, n_boot, warm, late_boot):
    ours = _pump_run(ReplicaAgent, want, n_boot, warm, late_boot)
    theirs = _pump_run(JReplicaAgent, want, n_boot, warm, late_boot)
    assert json.dumps(ours) == json.dumps(theirs)
    assert any(s.get("swapped") is not None for s in ours["swap"]["steps"])
    assert {v for _, v in ours["swap"]["replicas"]} == {"v2"}
    assert {v for _, v in ours["rollback"]["replicas"]} == {None}
