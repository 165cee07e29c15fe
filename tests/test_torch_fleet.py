"""The serving fleet held against the JAX package's on the CPU.

``FleetConfig``, ``partition_devices``, ``jsq_key``, the
``RestartPolicy`` schedule and verdicts, the healthz keys, JSQ's choice
over prefilled lanes, ``collector_for_fleet`` + ``view_to_snapshot`` and
the ``fleet-degraded`` rule equal to the JAX package's.  The cases of
``tests/test_fleet.py`` on the port's fleet of stand-in devices (each
batch gated by an event, no model): expiry while routing, the fleet
shedding only when every replica sheds, a reroute that does not extend
the deadline, crash → eject → reroute → relaunch → rejoin, thread-safe
counters, the crash-loop verdict, relaunch off, exactly-once under a
kill.  Then the tiny model: a 2-replica fleet joined from an export
store serving bit-equal to the offline ``Predictor`` batch, and an int8
fleet calibrated once serving through every replica.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import FleetConfig as JFleetConfig
from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.ft.supervisor import RestartPolicy as JRestartPolicy
from mx_rcnn_tpu.obs import collect as j_collect
from mx_rcnn_tpu.obs import health as j_health
from mx_rcnn_tpu.obs.metrics import Registry as JRegistry
from mx_rcnn_tpu.serve import fleet as jfleet
from mx_rcnn_tpu.tools.loadgen import make_stub_run_fn as j_make_stub_run_fn
from mx_rcnn_tpu_torch.config import FleetConfig, generate_config
from mx_rcnn_tpu_torch.core.tester import (Predictor, _postprocess_batch,
                                           detections_from_keep,
                                           tiled_bbox_stats)
from mx_rcnn_tpu_torch.data.image import prepare_image
from mx_rcnn_tpu_torch.ft.supervisor import RestartPolicy
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.obs import collect, health
from mx_rcnn_tpu_torch.obs.metrics import Registry
from mx_rcnn_tpu_torch.serve import fleet
from mx_rcnn_tpu_torch.serve.export import (export_serve_programs,
                                            predictor_variables)
from mx_rcnn_tpu_torch.serve.fleet import (R_DEAD, R_READY, R_RELAUNCHING,
                                           FleetRequest, ReplicaManager,
                                           build_fleet, jsq_key,
                                           partition_devices)
from mx_rcnn_tpu_torch.serve.queue import (EXPIRED, FAILED, PENDING, SERVED,
                                           SHED)
from mx_rcnn_tpu_torch.tools.loadgen import make_stub_run_fn

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _over(replicas=2, **kw):
    """tests/test_fleet.py's canvas and fleet knobs."""
    over = dict(bucket__scale=128, bucket__max_size=160,
                bucket__shapes=((128, 160), (160, 128)),
                test__rpn_pre_nms_top_n=512, test__rpn_post_nms_top_n=64,
                serve__batch_size=2, serve__max_delay_ms=20.0,
                fleet__replicas=replicas, fleet__health_interval_s=30.0)
    over.update(kw)
    return over


def _fleet_cfg(replicas=2, **kw):
    return generate_config("tiny", "synthetic", **_over(replicas, **kw))


def _img(landscape=True, seed=0):
    rng = np.random.RandomState(seed)
    h, w = (128, 160) if landscape else (160, 128)
    return rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)


class _Gate:
    """Stand-in replicas serve at once while open; closed, every batch
    blocks until it reopens: the routing tests' backlog."""

    def __init__(self):
        self._ev = threading.Event()
        self._ev.set()

    def close(self):
        self._ev.clear()

    def open(self):
        self._ev.set()

    def factory(self, cfg, make=make_stub_run_fn):
        def build(rid):
            inner = make(cfg, model_ms=1.0)

            def run_fn(images, im_info):
                self._ev.wait(timeout=30.0)
                return inner(images, im_info)

            return run_fn

        return build


def _stub_fleet(cfg, gate=None):
    gate = gate or _Gate()
    router = build_fleet(cfg, None, run_fn_factory=gate.factory(cfg),
                         device="cpu")
    return router, gate


def _drain(router, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while (router.metrics.snapshot()["in_flight"] > 0
           and time.monotonic() < deadline):
        time.sleep(0.02)


# ---- config, devices, the JSQ key, the restart schedule -----------------------

def test_fleet_config_fields_and_defaults_equal_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(FleetConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JFleetConfig)]
    assert got == want
    kw = dict(fleet__replicas=4, fleet__reroute_retries=3,
              fleet__export_dir="/tmp/x", fleet__relaunch=False,
              fleet__health_interval_s=0.5, fleet__devices_per_replica=2)
    assert repr(generate_config("tiny", "synthetic", **kw).fleet) == \
        repr(j_generate_config("tiny", "synthetic", **kw).fleet)
    with pytest.raises(ValueError, match="replicas"):
        ReplicaManager(lambda rid: None,
                       generate_config("tiny", "synthetic",
                                       fleet__replicas=0))


@pytest.mark.parametrize("n,devices,per", [
    (3, ["d0"], 0), (2, ["d0", "d1", "d2", "d3"], 0),
    (4, ["d0", "d1"], 0), (3, ["d0", "d1", "d2", "d3", "d4"], 2),
    (2, ["d0", "d1", "d2"], 5), (1, ["d0", "d1"], 0)])
def test_partition_devices_equals_jax(n, devices, per):
    assert partition_devices(n, devices, per) == \
        jfleet.partition_devices(n, devices, per)
    with pytest.raises(ValueError):
        partition_devices(0, devices=devices)


def test_partition_devices_of_cards():
    one = [torch.device("cuda", 0)]
    assert partition_devices(2, one) == [one, one]
    two = [torch.device("cuda", i) for i in range(2)]
    assert partition_devices(2, two) == [[two[0]], [two[1]]]
    assert fleet.default_devices("cpu") == [CPU]


def test_jsq_key_equals_jax():
    for lane in range(0, 9):
        for total in (0, 1, 5, 17):
            for rid in range(3):
                for rot in (0, 1, 7):
                    for batch in (1, 2, 4):
                        assert jsq_key(lane, total, rid, rot, 3, batch) == \
                            jfleet.jsq_key(lane, total, rid, rot, 3, batch)


def test_restart_policy_schedule_and_verdicts_equal_jax():
    for seed in range(4):
        ours = RestartPolicy(seed=seed, registry=Registry())
        theirs = JRestartPolicy(seed=seed, registry=JRegistry())
        assert [ours.delay_s(n) for n in range(0, 9)] == \
            [theirs.delay_s(n) for n in range(0, 9)]
    seq = [(("a",), False), (("a",), False), (("b",), False), (("b",), False),
           (("b",), False), (("ok",), True), (("c",), False), (("c",), False),
           (("c",), False), (("c",), False), (("c",), False)]
    t = [0.0]
    ours = RestartPolicy(seed=2, give_up_after=4, registry=Registry(),
                         clock=lambda: t[0])
    theirs = JRestartPolicy(seed=2, give_up_after=4, registry=JRegistry(),
                            clock=lambda: t[0])
    got = [ours.record(s, p) + (ours.ready_at,) for s, p in seq]
    want = [theirs.record(s, p) + (theirs.ready_at,) for s, p in seq]
    assert got == want
    assert [g[1] for g in got][-2:] == [True, True]
    reg = Registry()
    RestartPolicy(registry=reg).record(("x",), False)
    assert reg.gauge("ft.supervisor.consecutive_failures") == 1
    assert reg.gauge("ft.supervisor.crash_loop") == 0


def test_restart_policy_record_is_thread_safe():
    p = RestartPolicy(give_up_after=10 ** 6, registry=Registry())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda: [p.record(("same",), False) for _ in range(200)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert p.failures == p.identical == 1600


# ---- routing --------------------------------------------------------------------

def test_jsq_over_prefilled_lanes_picks_the_replica_jax_picks():
    """Both fleets get the same backlog (replica 0's landscape lane two
    batch cycles deep, the portrait lanes idle); both route a landscape
    and a portrait request to the same replica."""
    cfg = _fleet_cfg()
    jcfg = j_generate_config("tiny", "synthetic", **_over())
    chosen = []
    for build, c, make in (
            (lambda c, g: build_fleet(c, None, run_fn_factory=g.factory(c),
                                      device="cpu"), cfg, make_stub_run_fn),
            (lambda c, g: jfleet.build_fleet(
                c, None, {}, run_fn_factory=g.factory(c, j_make_stub_run_fn)),
             jcfg, j_make_stub_run_fn)):
        gate = _Gate()
        router = build(c, gate)
        gate.close()
        try:
            r0 = router.manager.replicas[0]
            for seed in range(5):
                assert r0.engine.submit(_img(True, seed),
                                        timeout_ms=0).state != SHED
            got = [router.submit(_img(True, 99), timeout_ms=30_000),
                   router.submit(_img(False, 7), timeout_ms=30_000)]
            chosen.append([f.replica_id for f in got])
        finally:
            gate.open()
            _drain(router)
            router.close()
    assert chosen[0] == chosen[1] == [1, 1]


def test_request_expired_during_routing_terminates_expired():
    router, _ = _stub_fleet(_fleet_cfg())
    try:
        now = time.monotonic()
        freq = FleetRequest(_img(), now - 1.0, now)   # born expired
        before = [r.engine.metrics.counters["submitted"]
                  for r in router.manager.replicas]
        router._dispatch(freq)
        assert freq.state == EXPIRED and freq.image is None
        assert [r.engine.metrics.counters["submitted"]
                for r in router.manager.replicas] == before
        assert router.metrics.counters["expired"] == 1
    finally:
        router.close()


def test_fleet_sheds_only_when_every_replica_is_saturated():
    router, gate = _stub_fleet(_fleet_cfg(serve__shed_watermark=2))
    try:
        gate.close()
        shed_at = None
        for seed in range(12):
            if router.submit(_img(True, seed), timeout_ms=0).state == SHED:
                shed_at = seed
                break
        assert shed_at is not None, "the fleet never shed"
        for r in router.manager.replicas:
            assert r.engine.bucket_depth((128, 160)) >= 2
        gate.open()
        _drain(router)
        snap = router.metrics.snapshot()
        assert snap["counters"]["submitted"] == snap["terminated"]
        assert snap["counters"]["shed"] == 1
    finally:
        gate.open()
        router.close()


def test_reroute_does_not_extend_the_deadline():
    router, gate = _stub_fleet(_fleet_cfg(fleet__reroute_retries=1))
    try:
        gate.close()
        # both landscape dispatchers busy, so the victim stays queued
        for r in router.manager.replicas:
            for s in range(2):
                r.engine.submit(_img(True, s), timeout_ms=0)
        time.sleep(0.15)
        freq = router.submit(_img(True, 9), timeout_ms=150.0)
        target = router.manager.replicas[freq.replica_id]
        time.sleep(0.25)              # the deadline passes while queued
        target.engine.kill()          # FAILED → reroute → expiry check
        deadline = time.monotonic() + 5.0
        while freq.state == PENDING and time.monotonic() < deadline:
            time.sleep(0.01)
        assert freq.state == EXPIRED
        assert freq.attempts == 1
    finally:
        gate.open()
        router.close()


# ---- lifecycle ---------------------------------------------------------------

def test_crash_eject_reroute_relaunch_rejoin():
    router, gate = _stub_fleet(_fleet_cfg())
    try:
        gate.close()
        victim, survivor = router.manager.replicas
        riders = []
        while victim.engine.bucket_depth((128, 160)) < 3:
            riders.append(router.submit(_img(True, len(riders)),
                                        timeout_ms=30_000))
        dead = victim.engine
        dead.kill()
        assert not dead.alive()
        router.manager.tick(now=time.monotonic())
        assert victim.state in (R_RELAUNCHING, R_READY)
        assert router.manager.ejects == 1
        # the ejected replica reads down at once
        assert victim.engine is None or victim.generation == 2
        gate.open()
        _drain(router)
        assert all(f.state == SERVED for f in riders)
        assert router.rerouted() > 0
        deadline = time.monotonic() + 15.0
        while victim.generation < 2 and time.monotonic() < deadline:
            router.manager.tick(now=time.monotonic() + 10.0)
            time.sleep(0.02)
        assert victim.generation == 2 and victim.ready()
        assert victim.engine is not dead and victim.dead_engine is None
        freq = router.submit(_img(True, 123), timeout_ms=30_000)
        freq.wait(timeout=10.0)
        assert freq.state == SERVED
    finally:
        gate.open()
        router.close()


def test_manager_counters_are_thread_safe():
    cfg = _fleet_cfg(replicas=48, fleet__relaunch=False)
    manager = ReplicaManager(lambda rid: (None, {}), cfg)
    for r in manager.replicas:
        r.state = R_READY
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=manager.eject, args=(r, "test"))
                   for r in manager.replicas]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert manager.ejects == len(manager.replicas)
    assert all(r.state == R_DEAD for r in manager.replicas)


def test_crash_loop_becomes_a_verdict():
    cfg = _fleet_cfg(replicas=1)

    def bad_build(rid):
        raise RuntimeError("no devices for you")

    manager = ReplicaManager(bad_build, cfg)
    r = manager.replicas[0]
    r.policy.give_up_after = 3
    if not r.launch():
        manager._schedule_relaunch(r, ("boot-failed",), made_progress=False)
    for _ in range(10):
        deadline = time.monotonic() + 5.0
        while r.state != R_DEAD and not (
                r.state == R_RELAUNCHING and r.relaunch_at is not None) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        if r.state == R_DEAD:
            break
        manager.tick(now=time.monotonic() + 3600.0)
    assert r.state == R_DEAD
    assert r.policy.identical == 3
    manager.close()


def test_relaunch_off_leaves_a_dead_replica_dead():
    router, _ = _stub_fleet(_fleet_cfg(fleet__relaunch=False))
    try:
        victim = router.manager.replicas[0]
        victim.engine.kill()
        router.manager.tick()
        assert victim.state == R_DEAD
        freq = router.submit(_img(True, 5), timeout_ms=30_000)
        freq.wait(timeout=10.0)
        assert freq.state == SERVED
        assert freq.replica_id == router.manager.replicas[1].id
    finally:
        router.close()


def test_exactly_once_under_a_kill():
    router, _ = _stub_fleet(_fleet_cfg(fleet__health_interval_s=0.1))
    counts = {}
    lock = threading.Lock()

    def on_done(req):
        with lock:
            counts[id(req)] = counts.get(id(req), 0) + 1

    try:
        handles = []
        stop = time.monotonic() + 2.0
        killed = False
        seed = 0
        while time.monotonic() < stop:
            freq = router.submit(_img(seed % 2 == 0, seed),
                                 timeout_ms=10_000)
            freq.add_done_callback(on_done)
            handles.append(freq)
            seed += 1
            if not killed and time.monotonic() > stop - 1.5:
                router.manager.replicas[0].engine.kill()
                killed = True
            time.sleep(0.005)
        _drain(router)
        snap = router.metrics.snapshot()
        c = snap["counters"]
        assert c["submitted"] == len(handles) == snap["terminated"]
        assert len(counts) == len(handles)
        assert all(n == 1 for n in counts.values())
        assert all(f.state in (SERVED, SHED, EXPIRED, FAILED)
                   for f in handles)
        assert c["served"] > 0
    finally:
        router.close()


def test_healthz_keys_equal_jax():
    cfg = _fleet_cfg()
    jcfg = j_generate_config("tiny", "synthetic", **_over())
    router, _ = _stub_fleet(cfg)
    jrouter = jfleet.build_fleet(
        jcfg, None, {}, run_fn_factory=_Gate().factory(jcfg,
                                                       j_make_stub_run_fn))
    try:
        h, jh = router.healthz(), jrouter.healthz()
        assert set(h) == set(jh)
        assert h["ok"] and h["fleet"] and h["ready"] == 2
        assert [set(r) for r in h["replicas"]] == \
            [set(r) for r in jh["replicas"]]
        assert [r["state"] for r in h["replicas"]] == [R_READY, R_READY]
        for k in ("ready", "ejects", "relaunches", "buckets", "batch_size",
                  "versions", "canary"):
            assert h[k] == jh[k], k
    finally:
        router.close()
        jrouter.close()


def test_fleet_gauges_and_the_canary_lane():
    router, _ = _stub_fleet(_fleet_cfg())
    try:
        router.manager.export_gauges()
        reg = router.manager.registry
        assert reg.gauge("fleet.replicas") == 2
        assert reg.gauge("fleet.replicas_ready") == 2
        router.manager.replicas[1].version = "v2"
        router.set_canary("v2", 0.5)
        got = [router.submit(_img(True, s), timeout_ms=30_000)
               for s in range(4)]
        for f in got:
            f.wait(timeout=10.0)
        assert [f.replica_id for f in got] == [0, 1, 0, 1]
        assert router.manager.versions() == {"base": 1, "v2": 1}
        router.set_canary(None, 0.0)
        assert router.healthz()["canary"] is None
    finally:
        router.close()


def test_add_and_drain_replicas():
    router, _ = _stub_fleet(_fleet_cfg())
    try:
        mgr = router.manager
        r = mgr.add_replica(version="v2")
        deadline = time.monotonic() + 15.0
        while not r.ready() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert r.id == 2 and r.ready() and r.version == "v2"
        assert mgr.versions() == {"base": 2, "v2": 1}
        mgr.export_gauges()
        assert mgr.registry.gauge("fleet.replica2.generation") == 1
        assert mgr.drain_replica(version=None) == 1
        assert mgr.registry.gauge("fleet.replica1.generation") is None
        assert mgr.drain_replica() == 2
        assert mgr.drain_replica() is None          # never the last one
        assert [x.id for x in mgr.replicas] == [0]
        freq = router.submit(_img(True, 3), timeout_ms=30_000)
        freq.wait(timeout=10.0)
        assert freq.state == SERVED and freq.replica_id == 0
    finally:
        router.close()


# ---- the obs plane over a fleet ------------------------------------------------

class _FakeReplica:
    def __init__(self, rid, reg, state="ready"):
        self.id = rid
        self._lock = threading.Lock()
        self.engine = (None if reg is None else
                       type("E", (), {"metrics": type(
                           "M", (), {"registry": reg})()})())
        self.generation = 3
        self.state = state


def _fake_router(regs, router_reg):
    router = type("R", (), {})()
    router.manager = type("Mgr", (), {})()
    router.manager.replicas = [_FakeReplica(i, r) for i, r in enumerate(regs)]
    router.manager.registry = router_reg
    return router


def _fill(reg_cls, seed):
    rng = np.random.RandomState(seed)
    reg = reg_cls()
    reg.inc("serve.served", int(rng.randint(1, 50)))
    reg.inc("serve.submitted", 60)
    reg.set_gauge("serve.ready", float(rng.randint(0, 3)))
    for v in rng.rand(5) * 300:
        reg.observe("serve.total_ms", float(v))
    return reg


def test_collector_for_fleet_equals_jax():
    """The same registries behind a duck-typed fleet (replica 2 down):
    the collected view and its snapshot equal the JAX package's."""
    views = []
    for coll, reg_cls in ((collect, Registry), (j_collect, JRegistry)):
        regs = [_fill(reg_cls, 0), _fill(reg_cls, 1), None]
        router_reg = reg_cls()
        router_reg.set_gauge("fleet.replicas_ready", 2.0)
        router_reg.set_gauge("fleet.replicas", 3.0)
        col = coll.collector_for_fleet(_fake_router(regs, router_reg))
        view = col.collect()
        view.pop("ts")
        views.append((view, coll.view_to_snapshot(view)))
    (ours, ours_snap), (theirs, theirs_snap) = views
    assert ours == theirs
    assert ours_snap == theirs_snap
    assert ours["up"] == 3 and not ours["sources"]["replica-2"]["up"]
    assert ours["sources"]["replica-0"]["labels"]["generation"] == 3


def test_collector_reads_an_ejected_replica_down_and_a_relaunch_up():
    router, _ = _stub_fleet(_fleet_cfg())
    try:
        col = collect.collector_for_fleet(router)
        assert col.collect()["up"] == 3
        victim = router.manager.replicas[0]
        victim.engine.kill()
        router.manager.tick()
        view = col.collect()
        assert not view["sources"]["replica-0"]["up"]
        deadline = time.monotonic() + 15.0
        while victim.generation < 2 and time.monotonic() < deadline:
            router.manager.tick(now=time.monotonic() + 10.0)
            time.sleep(0.02)
        view = col.collect()
        assert view["sources"]["replica-0"]["up"]
        assert view["sources"]["replica-0"]["labels"]["generation"] == 2
    finally:
        router.close()


def test_default_rules_read_the_configured_replicas_as_jax():
    over = dict(fleet__replicas=3, serve__default_timeout_ms=1500.0)
    ours = health.default_rules(generate_config("tiny", "synthetic", **over))
    theirs = j_health.default_rules(j_generate_config("tiny", "synthetic",
                                                      **over))
    assert [vars(r) for r in ours] == [vars(r) for r in theirs]
    deg = [r for r in ours if r.name == "fleet-degraded"][0]
    assert deg.threshold == 3.0


# ---- the tiny model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """A seeded tiny model's variables and its offline Predictor."""
    cfg = _fleet_cfg()
    pred = Predictor(build_model(cfg, "cpu", seed=0), cfg, "cpu")
    return cfg, pred, predictor_variables(pred)


def _offline(pred, cfg, img):
    """One image alone in a batch, as the engine composes it, through the
    Predictor and the eval postprocess."""
    data, im_info, (bh, bw) = prepare_image(img, cfg)
    n = cfg.serve.batch_size
    images = np.zeros((n, bh, bw, 3), np.float32)
    info = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
    images[0], info[0] = data, im_info
    stds, means = tiled_bbox_stats(cfg, cfg.num_classes, pred.device)
    t = torch.from_numpy(info)
    with torch.inference_mode():
        out = _postprocess_batch(*pred.raw(images, info), t, t[:, 2], stds,
                                 means, nms_thresh=cfg.test.nms,
                                 score_thresh=cfg.serve.score_thresh)
    return detections_from_keep(*(x.numpy() for x in out), 0)


def test_export_warm_fleet_is_bit_equal_to_the_offline_batch(tiny, tmp_path):
    cfg, pred, variables = tiny
    cfg = cfg.replace_in("serve", score_thresh=0.0)
    export_serve_programs(pred, cfg, str(tmp_path), bundle_variables=True)
    router = build_fleet(cfg, variables, export_root=str(tmp_path),
                         device="cpu")
    try:
        joins = [r.joins[-1] for r in router.manager.replicas]
        assert [j["export_root"] for j in joins] == [str(tmp_path)] * 2
        assert all(r.engine.healthz()["warm_programs"] == 3
                   for r in router.manager.replicas)
        seen = set()
        for s in range(8):
            img = _img(s % 2 == 0, 100 + s)
            freq = router.submit(img, timeout_ms=0)
            got = freq.wait(timeout=60.0)
            seen.add(freq.replica_id)
            want = _offline(pred, cfg, img)
            assert sorted(got) == sorted(want)
            assert sum(len(v) for v in got.values()) > 0
            for c in want:
                assert got[c].tobytes() == want[c].tobytes()
        assert seen == {0, 1}
    finally:
        router.close()


def test_an_int8_fleet_calibrates_once_and_serves_on_every_replica(
        monkeypatch):
    from mx_rcnn_tpu_torch.core import tester
    from mx_rcnn_tpu_torch.tools import fleet as fleet_tool

    calls = []
    real = tester.calibrate_quant

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tester, "calibrate_quant", counting)
    cfg = _fleet_cfg(quant__enabled=True, quant__calibration_batches=1)
    args = fleet_tool.parse_args(["serve", "--device", "cpu"])
    variables = fleet_tool.fleet_variables(cfg, args)
    assert "quant" in variables and len(calls) == 1
    router = build_fleet(cfg, variables, device="cpu")
    try:
        fps = {r.engine.predictor.quant_fingerprint
               for r in router.manager.replicas}
        assert len(fps) == 1 and None not in fps
        handles = [router.submit(_img(s % 2 == 0, s), timeout_ms=0)
                   for s in range(8)]
        for h in handles:
            h.wait(timeout=120.0)
        assert {h.replica_id for h in handles} == {0, 1}
        assert all(h.state == SERVED for h in handles)
        assert len(calls) == 1
    finally:
        router.close()


# ---- an image's bits do not follow its batch row ----------------------------

def test_rpn_head_runs_each_image_alone_in_eval_and_batched_in_training():
    from mx_rcnn_tpu_torch.models.rpn import RPNHead

    torch.manual_seed(0)
    head = RPNHead(16, num_anchors=3, mid_channels=8)
    for p in head.parameters():
        torch.nn.init.normal_(p, std=0.1)
    sizes = []
    head.rpn_conv_3x3.register_forward_hook(
        lambda mod, args, out: sizes.append(args[0].shape[0]))
    feat = torch.randn(3, 6, 5, 16).permute(0, 3, 1, 2)   # NHWC memory
    head.eval()
    with torch.inference_mode():
        cls, box = head(feat)
        want_cls, want_box = head._head(feat)
    assert sizes == [1, 1, 1, 3]
    assert cls.shape == (3, 6 * 5 * 3, 2) and box.shape == (3, 6 * 5 * 3, 4)
    torch.testing.assert_close(cls, want_cls, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(box, want_box, rtol=1e-5, atol=1e-6)
    sizes.clear()
    head.train()
    head(feat)
    assert sizes == [3]


def test_each_image_scores_the_same_bits_at_every_batch_row(tiny):
    """Four images in a batch of four, in four rotations: each one's
    detections are byte-equal at every row, so a bulk run's shards do
    not depend on which replica or row scored an image."""
    cfg, pred, _ = tiny
    cfg = cfg.replace_in("serve", score_thresh=0.0)
    canv = [prepare_image(_img(True, 200 + s), cfg) for s in range(4)]
    bh, bw = canv[0][2]
    stds, means = tiled_bbox_stats(cfg, cfg.num_classes, pred.device)
    seen = [[] for _ in canv]
    for shift in range(4):
        order = [(j + shift) % 4 for j in range(4)]
        images = np.stack([canv[i][0] for i in order])
        info = np.stack([canv[i][1] for i in order]).astype(np.float32)
        t = torch.from_numpy(info)
        with torch.inference_mode():
            out = [x.numpy() for x in _postprocess_batch(
                *pred.raw(images, info), t, t[:, 2], stds, means,
                nms_thresh=cfg.test.nms,
                score_thresh=cfg.serve.score_thresh)]
        for row, i in enumerate(order):
            dets = detections_from_keep(*out, row)
            seen[i].append({c: v.tobytes() for c, v in dets.items()})
    for i, runs in enumerate(seen):
        assert sum(len(v) for v in runs[0].values()) > 0
        assert all(r == runs[0] for r in runs[1:]), f"image {i}"
