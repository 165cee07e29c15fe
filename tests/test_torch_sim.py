"""The fleet simulator against the JAX package's, on the CPU.

``sim/kernel.py``'s event order and RNG substreams; every scenario's
generated trace byte-equal to the JAX one; ``score_run`` equal and exact
on a hand-computed record; a seconds-scale failure storm whose decision
log is byte-identical across two port runs and to the JAX run's bytes
(shipped clean, mistuned breaching); a small canary rollout through the
port's ``RolloutController`` (v2 landed with nothing lost, the damaged
arm refused and rolled back), its log equal to the JAX one; and
``tools/sim.py — check_gauntlet`` equal to the JAX predicate, the
rollout rubric included.  Everything runs in virtual time.
"""

import hashlib
import json
import logging

import pytest

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.sim import control as j_control
from mx_rcnn_tpu.sim import kernel as j_kernel
from mx_rcnn_tpu.sim import score as j_score
from mx_rcnn_tpu.sim import traffic as j_traffic
from mx_rcnn_tpu.tools import sim as j_sim_cli
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.sim import kernel as p_kernel
from mx_rcnn_tpu_torch.sim.control import MISTUNED_OVERRIDES, SimRun
from mx_rcnn_tpu_torch.sim.kernel import SimKernel, VirtualClock
from mx_rcnn_tpu_torch.sim.score import decision_log_bytes, score_run
from mx_rcnn_tpu_torch.sim.traffic import (SCENARIOS, bucket_weights,
                                           fleet_capacity_rps, generate,
                                           rate_at)
from mx_rcnn_tpu_torch.tools import sim as sim_cli

logging.getLogger("mx_rcnn_tpu").setLevel(logging.ERROR)
logging.getLogger("mx_rcnn_tpu_torch").setLevel(logging.ERROR)


# ---- the kernel --------------------------------------------------------------

def _order(mod):
    k = mod.SimKernel(seed=0)
    order = []

    def outer():
        order.append(("outer", k.clock.now))
        k.at(k.clock.now, lambda: order.append(("inner", k.clock.now)))
        k.after(-3.0, lambda: order.append(("clamped", k.clock.now)))

    k.at(5.0, lambda: order.append(("a", k.clock.now)))
    k.at(5.0, lambda: order.append(("b", k.clock.now)))
    k.at(2.0, lambda: order.append(("c", k.clock.now)))
    k.at(1.0, outer)
    n = k.run_until(10.0)
    k.at(3.0, lambda: order.append(("past", k.clock.now)))
    k.at(40.0, lambda: order.append(("late", k.clock.now)))
    m = k.run_until_idle(30.0)
    return order, n, m, k.fired, k.clock.now, len(k)


def test_kernel_fires_in_the_jax_order():
    ours = _order(p_kernel)
    assert ours == _order(j_kernel)
    order, n, m, fired, now, left = ours
    assert [o[0] for o in order] == ["outer", "inner", "clamped", "c", "a",
                                     "b", "past"]
    assert (n, m, fired, now, left) == (6, 1, 7, 10.0, 1)


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_rng_substreams_equal_jax(seed):
    for name in ("arrivals", "buckets", "service", "shadow"):
        ours = SimKernel(seed=seed).rng(name).random_sample(6)
        theirs = j_kernel.SimKernel(seed=seed).rng(name).random_sample(6)
        assert ours.tobytes() == theirs.tobytes()
    k = SimKernel(seed=seed)
    a = k.rng("arrivals").random_sample(4)
    assert k.rng("buckets").random_sample(4).tobytes() != a.tobytes()
    assert k.rng("arrivals").random_sample(4).tobytes() == a.tobytes()


def test_virtual_clock_is_a_monotonic_callable():
    clk = VirtualClock(7.5)
    assert clk() == clk.now == 7.5


# ---- the traces ----------------------------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("hosts", [6, 20])
def test_scenario_trace_byte_equal_to_jax(name, hosts):
    cfg = generate_config("tiny", "synthetic")
    jcfg = j_generate_config("tiny", "synthetic")
    tr = generate(name, cfg, hosts, seed=5)
    theirs = j_traffic.generate(name, jcfg, hosts, seed=5)
    assert json.dumps(tr, sort_keys=True) == json.dumps(theirs,
                                                        sort_keys=True)
    assert tr["fingerprint"] == theirs["fingerprint"]
    T = tr["duration_s"]
    for t, rps in tr["rate"]:
        assert 0.0 <= t < T and rps >= 0.0
        assert rate_at(tr, t) == j_traffic.rate_at(theirs, t)
    for ev in tr["events"]:
        assert ev["kind"] in ("host_down", "host_flap", "drain_host")
        assert 0 <= ev["host"] < hosts
    assert generate(name, cfg, hosts, seed=6)["fingerprint"] \
        != tr["fingerprint"]


def test_capacity_and_weights_equal_jax():
    cfg = generate_config("tiny", "synthetic")
    jcfg = j_generate_config("tiny", "synthetic")
    assert bucket_weights(cfg) == j_traffic.bucket_weights(jcfg)
    assert fleet_capacity_rps(cfg, 37) == j_traffic.fleet_capacity_rps(jcfg,
                                                                       37)
    with pytest.raises(KeyError):
        generate("no_such_scenario", cfg, 4, 0)


# ---- the scorer ------------------------------------------------------------------

def test_score_run_exact_and_equal_to_jax():
    stats = {"submitted": 10, "served": 6, "shed": 2,
             "expired": 1, "failed": 1, "rerouted": 3}
    log = [{"t": 1, "kind": "action"}, {"kind": "health", "t": 2}]
    args = (stats, 90.0, 30.0, 12.34, 55.57, 432.1, log)
    s = score_run(*args)
    assert s == j_score.score_run(*args)
    assert s["lost"] == 2 and s["slo_critical_minutes"] == 1.5
    assert s["capacity_wasted_replica_s"] == 12.3 and s["actions"] == 1
    blob = (b'{"kind": "action", "t": 1}\n'
            b'{"kind": "health", "t": 2}\n')
    assert decision_log_bytes(log) == blob == j_score.decision_log_bytes(log)
    assert s["decision_log_sha256"] == hashlib.sha256(blob).hexdigest()
    empty = {k: 0 for k in stats}
    assert score_run(empty, 0.0, 0.0, 0.0, 0.0, None, []) == \
        j_score.score_run(empty, 0.0, 0.0, 0.0, 0.0, None, [])
    assert decision_log_bytes([]) == b""


# ---- the mini storm: the port's control plane against the JAX one --------------

def _mini_storm(cfg, hosts=10, duration_s=90.0, seed=7):
    """A failure storm at test scale: 40% of the fleet preempted under
    ~70% of the base load: shipped re-places the capacity, a policy
    blind to the deficit overloads the survivors past the deadline."""
    cap = fleet_capacity_rps(cfg, hosts)
    return {
        "name": "mini_storm", "seed": seed, "hosts": hosts,
        "duration_s": duration_s,
        "rate": [[0.0, round(0.7 * cap, 3)]],
        "bucket_weights": [[list(s), w] for s, w in bucket_weights(cfg)],
        "events": [{"t": 15.0 + 2.5 * j, "kind": "host_down",
                    "host": hosts - 1 - j} for j in range(4)],
        "overrides": {
            "crosshost__target_replicas": hosts,
            "crosshost__max_replicas": hosts * 4,
            "crosshost__min_replicas": hosts,
            "crosshost__up_backlog": 50.0,
            "serve__default_timeout_ms": 6000.0,
            "serve__shed_watermark": 96,
            "fleet__reroute_retries": 2,
        },
        "fingerprint": "test-mini-storm",
    }


def _arm(trace, label, overrides=None):
    run = SimRun(trace, generate_config("tiny", "synthetic"), label=label,
                 arm_overrides=overrides)
    score = run.run()
    return score, decision_log_bytes(run.log)


def _j_arm(trace, label, overrides=None):
    run = j_control.SimRun(trace, j_generate_config("tiny", "synthetic"),
                           label=label, arm_overrides=overrides)
    score = run.run()
    return score, j_score.decision_log_bytes(run.log)


@pytest.fixture(scope="module")
def storm():
    trace = _mini_storm(generate_config("tiny", "synthetic"))
    return {"shipped": [_arm(trace, "shipped") for _ in range(2)],
            "mistuned": _arm(trace, "mistuned", MISTUNED_OVERRIDES),
            "jax_shipped": _j_arm(trace, "shipped"),
            "jax_mistuned": _j_arm(trace, "mistuned",
                                   j_control.MISTUNED_OVERRIDES)}


def test_storm_log_byte_identical_across_runs_and_to_jax(storm):
    (s1, b1), (s2, b2) = storm["shipped"]
    assert b1 == b2 and s1 == s2
    js, jb = storm["jax_shipped"]
    assert b1 == jb and s1 == js
    ms, mb = storm["mistuned"]
    jms, jmb = storm["jax_mistuned"]
    assert mb == jmb and ms == jms
    assert MISTUNED_OVERRIDES == j_control.MISTUNED_OVERRIDES


def test_storm_shipped_is_clean_and_acts(storm):
    s, _ = storm["shipped"][0]
    assert s["lost"] == 0 and s["slo_critical_minutes"] == 0.0
    assert s["actions"] > 0
    assert s["submitted"] == (s["served"] + s["shed"] + s["expired"]
                              + s["failed"])


def test_storm_mistuned_breaches(storm):
    s, _ = storm["mistuned"]
    assert s["actions"] == 0 and s["lost"] > 0
    assert s["slo_critical_minutes"] > 0.0
    assert s["decision_log_sha256"] != \
        storm["shipped"][0][0]["decision_log_sha256"]


# ---- a small canary rollout through the port's controller ------------------------

@pytest.fixture(scope="module")
def canary():
    cfg = generate_config("tiny", "synthetic")
    trace = generate("canary_rollout", cfg, 6, seed=3)
    damage = sim_cli.MISTUNED_BY_SCENARIO["canary_rollout"]
    assert damage == j_sim_cli.MISTUNED_BY_SCENARIO["canary_rollout"]
    return {"shipped": _arm(trace, "shipped"),
            "redteam": _arm(trace, "mistuned", damage),
            "jax_shipped": _j_arm(trace, "shipped"),
            "jax_redteam": _j_arm(trace, "mistuned", damage)}


def test_canary_rollout_lands_v2_with_zero_lost(canary):
    s, blob = canary["shipped"]
    assert s["rollout"]["phase"] == "done" and s["lost"] == 0
    assert s["rollout"]["final_versions"] == {"v2": 6}
    assert s["rollout"]["gate"]["mean_delta"] == 0.0
    assert s["submitted"] == (s["served"] + s["shed"] + s["expired"]
                              + s["failed"])
    assert b"rollout_done" in blob and b"host_dark" in blob


def test_canary_redteam_refused_and_rolled_back(canary):
    s, _ = canary["redteam"]
    ro = s["rollout"]
    assert ro["phase"] == "rolled_back" and ro["reason"] == "gate_refused"
    assert ro["gate"]["refused"] is True and s["lost"] == 0
    assert set(ro["final_versions"]) == {"base"}


@pytest.mark.parametrize("arm", ["shipped", "redteam"])
def test_canary_log_byte_equal_to_jax(canary, arm):
    s, blob = canary[arm]
    js, jblob = canary["jax_" + arm]
    assert blob == jblob and s == js


def test_sim_smoke_runs_twice_byte_identical(capsys):
    assert sim_cli.run_smoke(hosts=8, seed=0) == 0
    assert "SIM SMOKE OK" in capsys.readouterr().out


# ---- the gauntlet's acceptance predicate -------------------------------------------

def _record(shipped_lost=0, shipped_crit=0.0, mistuned_lost=5,
            mistuned_crit=0.3, hosts=100, det=True, rollout=None):
    def arm(lost, crit):
        return {"lost": lost, "expired": lost, "failed": 0,
                "slo_critical_minutes": crit}

    shipped, mistuned = arm(shipped_lost, shipped_crit), \
        arm(mistuned_lost, mistuned_crit)
    if rollout is not None:
        shipped["rollout"], mistuned["rollout"] = rollout
    return {"scenarios": {"s": {"hosts": hosts,
                                "arms": {"shipped": shipped,
                                         "mistuned": mistuned}}},
            "determinism": {"log_identical": det, "score_identical": det}}


_DONE = {"phase": "done", "final_versions": {"v2": 100}}
_BACK = {"phase": "rolled_back", "reason": "gate_refused",
         "final_versions": {"base": 100}}

GAUNTLET_CASES = {
    "clean": _record(),
    "shipped_lost": _record(shipped_lost=3),
    "no_discrimination": _record(mistuned_lost=0, mistuned_crit=0.0),
    "small_fleet": _record(hosts=20),
    "broken_determinism": _record(det=False),
    "rollout_clean": _record(mistuned_lost=0, mistuned_crit=0.0,
                             rollout=(_DONE, _BACK)),
    "rollout_not_done": _record(rollout=({"phase": "canary"}, _BACK)),
    "rollout_mixed": _record(rollout=({"phase": "done", "final_versions":
                                       {"v2": 99, "base": 1}}, _BACK)),
    "rollout_not_refused": _record(rollout=(_DONE, {"phase": "done"})),
    "rollout_wrong_reason": _record(rollout=(_DONE, dict(
        _BACK, reason="health_critical"))),
    "rollout_not_restored": _record(rollout=(_DONE, dict(
        _BACK, final_versions={"base": 90, "v2": 10}))),
    "empty": {"scenarios": {}, "determinism": {}},
}


@pytest.mark.parametrize("case", sorted(GAUNTLET_CASES))
def test_check_gauntlet_equals_jax(case):
    record = GAUNTLET_CASES[case]
    got = sim_cli.check_gauntlet(record)
    assert got == j_sim_cli.check_gauntlet(record)
    assert (got == []) == (case in ("clean", "rollout_clean"))
