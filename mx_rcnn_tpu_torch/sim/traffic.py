"""Scenario traces: the demand/failure scripts the gauntlet replays.

Counterpart of ``mx_rcnn_tpu/sim/traffic.py``, whole: the same events in
the same order, so a seeded run's decision log is byte-equal to the
JAX package's.

A **trace** is a plain-JSON dict — replayable, diffable, fingerprinted:

``{"name", "seed", "hosts", "duration_s",``
``  "rate": [[t, rps], ...],          # piecewise-constant demand``
``  "bucket_weights": [[[h, w], frac], ...],``
``  "events": [{"t", "kind", "host"}, ...],  # host_down|host_flap|drain_host``
``  "overrides": {"section__field": value, ...},  # cfg for BOTH arms``
``  "fingerprint": sha256-of-the-above}``

Arrivals are NOT enumerated in the trace (a 240 s scenario carries
~10^5 requests): the harness draws Poisson arrivals from the kernel's
seeded ``arrivals`` substream against the rate curve, so the same trace
+ seed reproduces the same request sequence exactly.

Generators (each deterministic in (hosts, cfg, seed)):

* ``diurnal``       — a full demand cycle, trough 10% of peak.  No
  faults; the question is pure stability: does hysteresis flap at this
  scale?  (The shipped policy must take ZERO actions here.)
* ``flash_crowd``   — a 2x step spike to ~130% of fleet capacity for
  45 s.  Demand exceeds capacity, so watermark shedding is the CORRECT
  outcome; the deadline is set well above the watermark wait so
  shedding structurally precedes expiry and nothing is lost.
* ``failure_storm`` — 15% of hosts preempted mid-trace (3 of them
  crash-looping flappers judged by the shipped ``RestartPolicy``),
  then a demand ramp to ~92% of ORIGINAL capacity.  The deficit signal
  must re-place capacity on survivors before the ramp; a policy that
  ignores it overloads the survivors until queued requests expire.
* ``rolling_update``— every host drained, darkened and relaunched on a
  stagger, under steady load.  The scheduler must NOT fight the update
  (the operator derates the target by the expected concurrent dip —
  the trace's override encodes that runbook step).
* ``canary_rollout``— a ``"rollout"`` block starts the REAL
  ``RolloutController`` (pull → canary + online paired gate → wave
  rolling swaps → finalize) against the whole fleet under steady load,
  with one host darkened mid-roll so FINALIZE must re-converge a
  relaunched (boot-version) host.  Autoscaling is frozen for the
  rollout window (the runbook step), and the red-team arm damages the
  canary's shadow scores (``rollout__redteam_damage``) so only the
  paired gate can catch it — the required outcome there is refusal +
  auto-rollback, not completion.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Dict, List, Tuple

from mx_rcnn_tpu_torch.config import Config

SCENARIOS = ("diurnal", "flash_crowd", "failure_storm",
             "rolling_update", "canary_rollout")


def bucket_weights(cfg: Config) -> List[Tuple[Tuple[int, int], float]]:
    """Demand mix over the configured static buckets: 60/30/10 across
    the first three shapes (normalized over however many exist)."""
    shapes = [tuple(b) for b in cfg.bucket.shapes][:3]
    raw = [0.6, 0.3, 0.1][:len(shapes)]
    total = sum(raw)
    return [(s, w / total) for s, w in zip(shapes, raw)]


def fleet_capacity_rps(cfg: Config, hosts: int) -> float:
    """Boot-fleet service capacity estimate: replicas x batch / the
    demand-weighted mean service time.  An estimate for shaping demand
    curves, not a promise — the simulator measures the truth."""
    weights = bucket_weights(cfg)
    base = min(h * w for h, w in (tuple(b) for b in cfg.bucket.shapes))
    mean_svc_s = sum(w * (cfg.sim.service_ms / 1000.0)
                     * (s[0] * s[1]) / base for s, w in weights)
    replicas = hosts * max(int(cfg.crosshost.agent_replicas), 1)
    return replicas * cfg.serve.batch_size / mean_svc_s


def _finalize(trace: Dict) -> Dict:
    body = json.dumps({k: trace[k] for k in sorted(trace)},
                      sort_keys=True)
    trace["fingerprint"] = hashlib.sha256(body.encode()).hexdigest()
    return trace


def _base(name: str, cfg: Config, hosts: int, seed: int,
          duration_s: float) -> Dict:
    return {
        "name": name, "seed": int(seed), "hosts": int(hosts),
        "duration_s": float(duration_s),
        "bucket_weights": [[list(s), w]
                           for s, w in bucket_weights(cfg)],
        "events": [],
        # every scenario pins the fleet-shape knobs both arms share:
        # explicit target (hosts x agent_replicas), a ceiling that can
        # absorb re-placement, a floor at one replica per host
        "overrides": {
            "crosshost__target_replicas": hosts,
            "crosshost__max_replicas": hosts * 4,
            "crosshost__min_replicas": hosts,
            # padded-batch serving carries ~1-2 dispatch times of
            # standing queue even at healthy utilization (the batch
            # only fills when something waits), so the 2-4-host
            # up_backlog tuning reads permanent overload at fleet
            # scale; the scenarios derate it and let the shed-ratio
            # trigger own the overload judgment
            "crosshost__up_backlog": 50.0,
            # deadline well above the standing padded-batch wait —
            # nothing should expire at baseline
            "serve__default_timeout_ms": 6000.0,
        },
    }


def gen_diurnal(cfg: Config, hosts: int, seed: int) -> Dict:
    T = cfg.sim.duration_s
    cap = fleet_capacity_rps(cfg, hosts)
    tr = _base("diurnal", cfg, hosts, seed, T)
    steps = 24
    tr["rate"] = []
    for i in range(steps):
        t = i * T / steps
        # trough->peak->trough over one trace: 10%..100% of util x cap
        frac = 0.55 - 0.45 * math.cos(2.0 * math.pi * i / steps)
        tr["rate"].append([round(t, 3),
                           round(cap * cfg.sim.util * frac, 3)])
    return _finalize(tr)


def gen_flash_crowd(cfg: Config, hosts: int, seed: int) -> Dict:
    T = cfg.sim.duration_s
    cap = fleet_capacity_rps(cfg, hosts)
    base = cap * cfg.sim.util
    t0, spike_s = round(0.4 * T, 3), 45.0
    tr = _base("flash_crowd", cfg, hosts, seed, T)
    # the spike lands at ~2x base = ~130% of capacity: shedding is the
    # correct answer, and the deadline leaves expiry unreachable below
    # the watermark (watermark wait ~ shed_watermark/batch service
    # cycles << deadline)
    tr["overrides"]["serve__default_timeout_ms"] = 15_000.0
    tr["rate"] = [[0.0, round(base, 3)],
                  [t0, round(2.0 * base, 3)],
                  [round(t0 + spike_s, 3), round(base, 3)]]
    return _finalize(tr)


def gen_failure_storm(cfg: Config, hosts: int, seed: int) -> Dict:
    T = cfg.sim.duration_s
    cap = fleet_capacity_rps(cfg, hosts)
    base = cap * cfg.sim.util
    tr = _base("failure_storm", cfg, hosts, seed, T)
    # the watermark is raised so that under a SUSTAINED survivor
    # overload the queue wait crosses the deadline BEFORE the lane
    # sheds: watermark/batch dispatch cycles x service must exceed the
    # deadline.  A policy that never re-places the preempted capacity
    # therefore LOSES requests (expiry), not just sheds them.
    tr["overrides"]["serve__shed_watermark"] = 96
    # a sweep strands work on several hosts inside one queue lifetime;
    # one extra reroute is the difference between absorbed and lost
    tr["overrides"]["fleet__reroute_retries"] = 2
    killed = max(hosts * 15 // 100, 1)
    flappy = min(3, killed)
    t_kill = 0.25 * T
    for j in range(killed):
        kind = "host_flap" if j < flappy else "host_down"
        # stagger 2.5 s apart: a correlated preemption sweep, not one
        # atomic instant
        tr["events"].append({"t": round(t_kill + 2.5 * j, 3),
                             "kind": kind, "host": hosts - 1 - j})
    # phase 2: demand ramps to ~92% of ORIGINAL capacity — survivable
    # only if the lost capacity was re-placed
    t_ramp0, t_ramp1 = 0.55 * T, 0.75 * T
    tr["rate"] = [[0.0, round(base, 3)]]
    steps = 8
    for i in range(1, steps + 1):
        t = t_ramp0 + (t_ramp1 - t_ramp0) * i / steps
        r = base + (0.92 * cap - base) * i / steps
        tr["rate"].append([round(t, 3), round(r, 3)])
    return _finalize(tr)


def gen_rolling_update(cfg: Config, hosts: int, seed: int) -> Dict:
    T = cfg.sim.duration_s
    cap = fleet_capacity_rps(cfg, hosts)
    tr = _base("rolling_update", cfg, hosts, seed, T)
    # drain->dark->relaunch takes ~relaunch_s + warmup_s; the stagger
    # keeps a handful of hosts dark at once.  The runbook derate: the
    # operator lowers the target by the expected concurrent dip so the
    # deficit signal doesn't fight the planned update.
    dark_s = cfg.sim.relaunch_s + cfg.sim.warmup_s + 2.0
    t0, t1 = 10.0, T - max(dark_s * 2, 30.0)
    stagger = (t1 - t0) / hosts
    concurrent = max(int(math.ceil(dark_s / stagger)), 1)
    tr["overrides"]["crosshost__target_replicas"] = hosts - concurrent - 1
    tr["overrides"]["crosshost__min_replicas"] = hosts - concurrent - 1
    for i in range(hosts):
        tr["events"].append({"t": round(t0 + i * stagger, 3),
                             "kind": "drain_host", "host": i})
    tr["rate"] = [[0.0, round(cap * cfg.sim.util, 3)]]
    return _finalize(tr)


def gen_canary_rollout(cfg: Config, hosts: int, seed: int) -> Dict:
    cap = fleet_capacity_rps(cfg, hosts)
    # wave width: roll ~1/6th of the fleet concurrently (floor 1) —
    # the runbook wave a 100-host operator would pick
    wave = max(1, min(16, hosts // 6))
    per_host = max(int(cfg.crosshost.agent_replicas), 1)
    interval = cfg.sim.scrape_interval_s
    # duration floor from the rollout's own timeline: pull, canary
    # capacity warm + gate samples + bake, the wave-rolled swaps, and
    # a FINALIZE re-convergence of the darkened host — with 50% slack
    t_start = 10.0
    pull_s = cfg.rollout.pull_s + 2 * interval
    # the canary replica warms while the bake clock and the per-tick
    # gate samples run concurrently
    canary_s = (max(cfg.rollout.bake_s,
                    cfg.sim.warmup_s
                    + cfg.rollout.gate_min_pairs * interval)
                + 3 * interval)
    roll_s = (math.ceil(hosts / wave)
              * per_host * (cfg.sim.warmup_s + 2 * interval + 2.0))
    final_s = (cfg.sim.relaunch_s + cfg.sim.warmup_s
               + cfg.rollout.pull_s
               + per_host * (cfg.sim.warmup_s + 3 * interval) + 10.0)
    T = max(cfg.sim.duration_s,
            round((t_start + pull_s + canary_s + roll_s + final_s)
                  * 1.5, 0))
    tr = _base("canary_rollout", cfg, hosts, seed, T)
    tr["rate"] = [[0.0, round(cap * cfg.sim.util, 3)]]
    # runbook: freeze autoscaling during the rollout window (both the
    # deficit and the idle-drain signals) — the rollout's deliberate
    # +1-replica overshoot and one-dark-host dip are planned states,
    # not capacity incidents
    tr["overrides"]["crosshost__for_samples"] = 100_000
    tr["overrides"]["crosshost__idle_samples"] = 100_000
    tr["overrides"]["rollout__wave"] = wave
    # the canary lane must not exceed the canary arm's capacity share:
    # `wave` hosts hold ONE canary replica each while the gate bakes,
    # so a fraction above wave/(hosts*per_host) would overload them
    # into watermark sheds and page the canary p99 rule on a perfectly
    # healthy model (the runbook sizing step)
    tr["overrides"]["rollout__canary_fraction"] = round(
        min(cfg.rollout.canary_fraction,
            wave / float(hosts * per_host)), 4)
    # one gate sample per controller tick: the online gate judges on
    # ~min_pairs virtual seconds instead of min_pairs x sample_every
    tr["overrides"]["rollout__gate_sample_every"] = 1
    # a darkened host relaunches on the boot version well inside the
    # trace; a tighter step bound hands it to FINALIZE quickly
    tr["overrides"]["rollout__step_timeout_s"] = 25.0
    tr["rollout"] = {"version": "v2", "t_start": t_start}
    # darken one early-rolled host mid-roll: it comes back on the boot
    # store and FINALIZE must pull + swap it again (the convergence
    # half of the kill-mid-rollout bar)
    t_dark = round(t_start + pull_s + canary_s + roll_s * 0.3, 3)
    tr["events"].append({"t": t_dark, "kind": "drain_host", "host": 0})
    return _finalize(tr)


GENERATORS = {
    "diurnal": gen_diurnal,
    "flash_crowd": gen_flash_crowd,
    "failure_storm": gen_failure_storm,
    "rolling_update": gen_rolling_update,
    "canary_rollout": gen_canary_rollout,
}


def generate(name: str, cfg: Config, hosts: int, seed: int) -> Dict:
    if name not in GENERATORS:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have: {', '.join(SCENARIOS)})")
    return GENERATORS[name](cfg, hosts, seed)


def rate_at(trace: Dict, t: float) -> float:
    """Piecewise-constant demand readout (0 past the trace end)."""
    if t >= trace["duration_s"]:
        return 0.0
    r = 0.0
    for t0, rps in trace["rate"]:
        if t >= t0:
            r = rps
        else:
            break
    return float(r)
