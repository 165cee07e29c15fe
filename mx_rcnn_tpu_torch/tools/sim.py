"""Policy gauntlet: the port's control plane against the fleet
simulator.

Counterpart of ``mx_rcnn_tpu/tools/sim.py``.  Runs every scenario in
``sim/traffic.py`` through two arms of the same harness
(``sim/control.py``):

* **shipped**: the port's ``SchedulerPolicy``, ``HealthEngine`` and
  JSQ-router tuning, as ``generate_config`` sets them;
* **mistuned**: the same code with the red-team knobs
  (``MISTUNED_OVERRIDES``; for ``canary_rollout`` a damaged canary,
  :data:`MISTUNED_BY_SCENARIO`),

then runs one shipped arm again to pin determinism (a byte-identical
decision log and an equal score for the same trace and seed).

``--check`` is the acceptance gate (:func:`check_gauntlet`): shipped
loses no request on any trace, the mistuned arm breaches (lost > 0 or
CRITICAL SLO-minutes > 0, or the gate's refusal and rollback of the
damaged canary) on at least one scenario where shipped is clean, and
the second run matched.  ``--smoke`` runs one scenario (failure_storm:
preemptions, crash-loop supervision, deficit re-placement), shipped arm
twice, with the same assertions.  The port's difference: the record is
written only where ``--out`` names a file.

Usage::

    python -m mx_rcnn_tpu_torch.tools.sim [--scenario all] [--hosts 100]
        [--seed 0] [--out record.json] [--check] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.sim.control import MISTUNED_OVERRIDES, SimRun
from mx_rcnn_tpu_torch.sim.score import decision_log_bytes
from mx_rcnn_tpu_torch.sim.traffic import SCENARIOS, generate

# the scenario whose shipped arm is re-run for the determinism pin and
# which `--smoke` exercises: failure_storm drives every subsystem at
# once (preemption, crash-loop supervision, deficit re-placement,
# reroute, expiry pressure)
PIN_SCENARIO = "failure_storm"

# per-scenario red-team arms.  canary_rollout's mistuned arm is not a
# sabotaged scheduler but a DAMAGED MODEL: the canary's shadow scores
# drop by redteam_damage while its latency/failure metrics stay clean,
# so only the online paired gate can catch it.  The required mistuned
# outcome there is refusal + auto-rollback (protection), not a breach.
MISTUNED_BY_SCENARIO = {
    "canary_rollout": {"rollout__redteam_damage": 0.35},
}


def _arm(trace: Dict, cfg, label: str,
         overrides: Optional[Dict] = None) -> Dict:
    t0 = time.perf_counter()
    run = SimRun(trace, cfg, label=label, arm_overrides=overrides)
    logger = logging.getLogger("mx_rcnn_tpu_torch")
    level = logger.level
    logger.setLevel(logging.ERROR)  # per-event health/supervisor chatter
    try:                            # — thousands of lines at fleet scale
        score = run.run()
    finally:
        logger.setLevel(level)
    score["wall_s"] = round(time.perf_counter() - t0, 2)
    return score


def _atomic_json(path: str, record: Dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _fmt(name: str, s: Dict) -> str:
    return (f"  {name:>14}/{s['label']:<8} lost={s['lost']:5d} "
            f"(exp {s['expired']}, fail {s['failed']}) "
            f"shed={s['shed']:5d} served={s['served']:6d} "
            f"crit_min={s['slo_critical_minutes']:7.3f} "
            f"waste_rs={s['capacity_wasted_replica_s']:9.1f} "
            f"acts={s['actions']:3d} [{s['wall_s']}s]")


def run_gauntlet(scenarios: List[str], hosts: int, seed: int,
                 duration_s: Optional[float] = None) -> Dict:
    """All requested scenarios x both arms + the determinism pin."""
    overrides = {} if duration_s is None else {"sim__duration_s":
                                               float(duration_s)}
    cfg = generate_config("tiny", "synthetic", **overrides)
    out: Dict = {"scenarios": {}}
    for name in scenarios:
        trace = generate(name, cfg, hosts, seed)
        shipped = _arm(trace, cfg, "shipped")
        mistuned = _arm(trace, cfg, "mistuned",
                        MISTUNED_BY_SCENARIO.get(name,
                                                 MISTUNED_OVERRIDES))
        out["scenarios"][name] = {
            "trace_fingerprint": trace["fingerprint"],
            "hosts": trace["hosts"],
            "duration_s": trace["duration_s"],
            "seed": trace["seed"],
            "arms": {"shipped": shipped, "mistuned": mistuned},
        }
        print(_fmt(name, shipped), flush=True)
        print(_fmt(name, mistuned), flush=True)
    # determinism pin: same trace + seed must reproduce the same bytes
    pin = PIN_SCENARIO if PIN_SCENARIO in scenarios else scenarios[0]
    trace = generate(pin, cfg, hosts, seed)
    rerun = _arm(trace, cfg, "shipped")
    first = out["scenarios"][pin]["arms"]["shipped"]
    out["determinism"] = {
        "scenario": pin,
        "sha_first": first["decision_log_sha256"],
        "sha_rerun": rerun["decision_log_sha256"],
        "log_identical": (first["decision_log_sha256"]
                          == rerun["decision_log_sha256"]),
        "score_identical": all(
            first[k] == rerun[k] for k in first if k != "wall_s"),
    }
    return out


def check_gauntlet(record: Dict) -> List[str]:
    """The acceptance predicate — empty list means the gate holds."""
    problems: List[str] = []
    scen = record["scenarios"]
    if not scen:
        return ["no scenarios ran"]
    breach = 0
    for name, s in sorted(scen.items()):
        shipped = s["arms"]["shipped"]
        mistuned = s["arms"]["mistuned"]
        if s["hosts"] < 100:
            problems.append(f"{name}: only {s['hosts']} hosts — the "
                            "acceptance gate requires >= 100")
        if shipped["lost"] != 0:
            problems.append(
                f"{name}: shipped policy LOST {shipped['lost']} "
                f"requests (expired {shipped['expired']}, failed "
                f"{shipped['failed']}) — must be 0")
        shipped_clean = (shipped["lost"] == 0
                         and shipped["slo_critical_minutes"] == 0)
        ro_ship, ro_mis = shipped.get("rollout"), mistuned.get("rollout")
        if ro_ship is not None:
            # rollout rubric: the shipped (healthy-v2) arm must land
            # the whole fleet on v2; the damaged-model arm must be
            # REFUSED by the gate and auto-rolled back — and neither
            # arm may lose a request while swapping under load
            if ro_ship["phase"] != "done":
                problems.append(f"{name}: shipped rollout ended in "
                                f"phase {ro_ship['phase']!r}, not done")
            elif set(ro_ship["final_versions"]) != {"v2"}:
                problems.append(
                    f"{name}: shipped fleet not converged on v2 "
                    f"(ready versions: {ro_ship['final_versions']})")
            if mistuned["lost"] != 0:
                problems.append(f"{name}: mistuned (damaged-model) arm "
                                f"LOST {mistuned['lost']} requests — "
                                "rollback must not lose work")
            if ro_mis is None or ro_mis["phase"] != "rolled_back":
                problems.append(
                    f"{name}: damaged-model arm was NOT rolled back "
                    f"(phase {ro_mis and ro_mis['phase']!r})")
            elif ro_mis["reason"] != "gate_refused":
                problems.append(
                    f"{name}: damaged-model rollback reason "
                    f"{ro_mis['reason']!r}, expected gate_refused")
            elif set(ro_mis["final_versions"]) != {"base"}:
                problems.append(
                    f"{name}: damaged-model fleet not restored to the "
                    f"boot version (ready: {ro_mis['final_versions']})")
            if (shipped_clean and ro_mis is not None
                    and ro_mis.get("reason") == "gate_refused"):
                breach += 1  # the gate IS the discrimination here
            continue
        mistuned_breached = (mistuned["lost"] > 0
                             or mistuned["slo_critical_minutes"] > 0)
        if shipped_clean and mistuned_breached:
            breach += 1
    if breach == 0:
        problems.append(
            "mistuned arm never breached where shipped was clean — "
            "the gauntlet has zero discrimination")
    det = record.get("determinism") or {}
    if not det.get("log_identical"):
        problems.append("determinism: decision logs differ between "
                        "identical runs")
    if not det.get("score_identical"):
        problems.append("determinism: scores differ between identical "
                        "runs")
    return problems


def run_smoke(hosts: int, seed: int) -> int:
    """The smoke: one shipped failure_storm arm, twice; asserts
    zero lost + byte-identical decision log.  No file written."""
    cfg = generate_config("tiny", "synthetic")
    trace = generate(PIN_SCENARIO, cfg, hosts, seed)
    logging.getLogger("mx_rcnn_tpu_torch").setLevel(logging.ERROR)
    runs = []
    for i in (1, 2):
        t0 = time.perf_counter()
        run = SimRun(trace, cfg, label="shipped")
        score = run.run()
        print(f"sim-smoke: run {i}: lost={score['lost']} "
              f"served={score['served']} actions={score['actions']} "
              f"sha={score['decision_log_sha256'][:16]} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
        runs.append((score, decision_log_bytes(run.log)))
    (s1, b1), (s2, b2) = runs
    problems = []
    if s1["lost"] != 0:
        problems.append(f"shipped policy lost {s1['lost']} requests "
                        f"on {PIN_SCENARIO}")
    if b1 != b2:
        problems.append("decision logs are not byte-identical")
    if {k: v for k, v in s1.items() if k != "wall_s"} != \
            {k: v for k, v in s2.items() if k != "wall_s"}:
        problems.append("scores differ between identical runs")
    if problems:
        for pr in problems:
            print(f"SIM SMOKE FAILED: {pr}", file=sys.stderr)
        return 1
    print(f"SIM SMOKE OK: {PIN_SCENARIO} x {hosts} hosts, "
          f"{s1['submitted']} requests, 0 lost, byte-identical "
          "decision log across runs")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sim",
        description="fleet-at-scale policy gauntlet in virtual time "
                    "(sim/)")
    p.add_argument("--scenario", default="all",
                   choices=list(SCENARIOS) + ["all"],
                   help="one scenario, or 'all' (default)")
    p.add_argument("--hosts", type=int, default=0,
                   help="fleet size (0 = config sim.hosts, 100)")
    p.add_argument("--seed", type=int, default=-1,
                   help="trace seed (-1 = config sim.seed, 0)")
    p.add_argument("--duration_s", type=float, default=0.0,
                   help="trace length override (0 = config default)")
    p.add_argument("--out", default=None,
                   help="write the gauntlet record here (default: none)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless shipped loses 0 everywhere, "
                        "mistuned breaches somewhere, and reruns are "
                        "byte-identical")
    p.add_argument("--smoke", action="store_true",
                   help="gate-scale run: one scenario, shipped arm "
                        "twice, determinism + zero-lost asserted")
    args = p.parse_args(argv)
    cfg = generate_config("tiny", "synthetic")
    hosts = args.hosts or cfg.sim.hosts
    seed = args.seed if args.seed >= 0 else cfg.sim.seed

    if args.smoke:
        return run_smoke(hosts, seed)

    scenarios = (list(SCENARIOS) if args.scenario == "all"
                 else [args.scenario])
    print(f"sim gauntlet: {len(scenarios)} scenario(s) x "
          f"{hosts} hosts, seed {seed}", flush=True)
    result = run_gauntlet(scenarios, hosts, seed,
                          args.duration_s or None)
    problems = check_gauntlet(result)
    worst = max(s["arms"]["shipped"]["lost"]
                for s in result["scenarios"].values())
    record = {
        "metric": "sim_gauntlet_shipped_lost_requests",
        "value": worst,
        "unit": "requests",
        "measured": True,
        "hosts": hosts,
        "seed": seed,
        "scenarios": result["scenarios"],
        "determinism": result["determinism"],
        "check": {"problems": problems, "ok": not problems},
    }
    if args.out:
        _atomic_json(args.out, record)
        print(f"sim: record -> {args.out}", flush=True)
    if args.check:
        if problems:
            for pr in problems:
                print(f"SIM CHECK FAILED: {pr}", file=sys.stderr)
            return 1
        n = len(result["scenarios"])
        print(f"SIM CHECK OK: shipped lost 0 on all {n} scenario(s); "
              "mistuned arm measurably breached; decision log "
              "byte-identical across identical runs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
