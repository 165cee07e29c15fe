"""Scoring rubric: what a control-plane policy is judged on.

Counterpart of ``mx_rcnn_tpu/sim/score.py``, whole: the same events in
the same order, so a seeded run's decision log is byte-equal to the
JAX package's.

Three axes, worst first:

* **lost requests** — EXPIRED + FAILED terminals.  A shed is NOT lost:
  a 429 at the watermark is the system keeping its latency promise
  under demand it cannot absorb; an expiry or a reroute-exhausted
  failure is a request the system accepted and then betrayed.
* **SLO-minutes breached** — virtual minutes the health engine's
  verdict sat at CRITICAL (WARN-minutes reported alongside).  Judged by
  the SHIPPED ``HealthEngine`` over the same samples the scheduler
  read, so "breached" means what production monitoring would have paged
  on.
* **capacity-seconds wasted** — integral of ready replicas above what
  the demand curve needed (per-replica service rate from the same
  measured distribution the hosts serve with), floored at the
  scenario's ``min_replicas``.  Over-provisioning is the cheapest
  failure, but it is still a failure — a policy could ace the first two
  axes by never draining anything.

Every number is derived from exact event-level integer counts (not
scraped gauges), so the hand-computed mini-trace in
``tests/test_torch_sim.py`` can pin the scorer to the digit.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List


def decision_log_bytes(log: List[Dict]) -> bytes:
    """Canonical byte form of a decision log: one sorted-key JSON
    object per line.  Byte-identical across runs of the same trace +
    seed — the determinism contract ``tests/test_torch_sim.py`` pins."""
    import json

    return ("\n".join(json.dumps(e, sort_keys=True) for e in log)
            + ("\n" if log else "")).encode()


def score_run(stats: Dict, critical_s: float, warn_s: float,
              wasted_replica_s: float, wait_ms_max: float,
              p99_ms, log: List[Dict]) -> Dict:
    """Collapse one run's exact counts into the BENCH-style score."""
    lost = int(stats["expired"]) + int(stats["failed"])
    blob = decision_log_bytes(log)
    return {
        "submitted": int(stats["submitted"]),
        "served": int(stats["served"]),
        "shed": int(stats["shed"]),
        "expired": int(stats["expired"]),
        "failed": int(stats["failed"]),
        "rerouted": int(stats["rerouted"]),
        "lost": lost,
        "slo_critical_minutes": round(critical_s / 60.0, 4),
        "slo_warn_minutes": round(warn_s / 60.0, 4),
        "capacity_wasted_replica_s": round(wasted_replica_s, 1),
        "wait_ms_max": round(float(wait_ms_max), 1),
        "served_p99_ms": (None if p99_ms is None
                          else round(float(p99_ms), 1)),
        "actions": sum(1 for e in log if e.get("kind") == "action"),
        "decision_log_entries": len(log),
        "decision_log_sha256": hashlib.sha256(blob).hexdigest(),
    }
