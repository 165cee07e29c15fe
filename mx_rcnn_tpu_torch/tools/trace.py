"""The request causality doctor and the distributed-tracing protocol.

Counterpart of ``mx_rcnn_tpu/tools/trace.py``: the read side of the
distributed half of ``obs/trace.py``.

* ``--tree <trace_id>``: one request's causal tree from a merged trace
  file: the head's root span, each attempt's subtree, the wire hop, the
  agent's decode, lane and compute spans and every terminal, indented by
  parent.  A reroute after a SIGKILL reads as one trace with both
  attempts;
* ``--table``: the burst's latency attribution, p50/p99 of every stage
  (span name) across the file's traces;
* ``--decision <corr>``: the scheduler's (or a flight record's)
  decisions carrying a correlation id;
* ``--check [--smoke]``: the live protocol.  Two agent processes behind
  the cross-host router: a traced burst, a SIGKILL-reroute leg and a
  traced-against-untraced A/B.  It exits non-zero unless the span trees
  are 100% complete, the reroute shows as one two-attempt trace, the
  skew-corrected timelines are monotonic and tracing costs under 2% of
  the served rate.  ``--device`` places the agents, which run
  ``tools/loadgen.py``'s stand-in model.

The agents are processes on this machine, sharing its cores: the
protocol checks the plane (propagation, skew merge, retention), not
several machines.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List

logger = logging.getLogger("mx_rcnn_tpu_torch")


# ---------------------------------------------------------------------------
# doctor primitives (pure; tests drive these directly)
# ---------------------------------------------------------------------------

def load_traces(path: str) -> Dict[str, List[dict]]:
    """{trace_id: [spans]} from a merged trace file — either the doc
    shape (``{"traces": ...}``) or plain chrome-trace JSON
    (``{"traceEvents": [...]}``, span/parent hex in args)."""
    with open(path) as f:
        doc = json.load(f)
    if "traces" in doc:
        return doc["traces"]
    traces: Dict[str, List[dict]] = {}
    for ev in doc.get("traceEvents", []):
        a = ev.get("args", {})
        tid = a.get("trace_id")
        if tid is None:
            continue
        traces.setdefault(tid, []).append({
            "name": ev["name"], "ts": ev["ts"], "dur": ev.get("dur", 0),
            "span": int(a.get("span", "0"), 16),
            "parent": int(a.get("parent", "0"), 16),
            "host": ev.get("pid", "?"),
            "hop": int(str(ev.get("tid", "hop-0")).split("-")[-1] or 0),
            "args": {k: v for k, v in a.items()
                     if k not in ("trace_id", "span", "parent")}})
    return traces


def format_tree(spans: List[dict]) -> List[str]:
    """One trace's spans → indented causal-tree lines (children under
    parents, siblings by start time).  Orphans — spans whose parent is
    not in the tree, e.g. half a trace lost with a SIGKILLed host —
    print as extra roots marked ``(orphan)``."""
    ids = {s["span"] for s in spans}
    children: Dict[int, List[dict]] = {}
    roots: List[dict] = []
    for s in sorted(spans, key=lambda s: s["ts"]):
        p = s.get("parent", 0)
        if p and p in ids:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    out: List[str] = []

    def walk(s: dict, depth: int, orphan: bool = False) -> None:
        args = s.get("args", {})
        extra = "".join(f" {k}={v}" for k, v in sorted(args.items()))
        out.append(f"{'  ' * depth}{s['name']}  "
                   f"[{s['dur'] / 1e3:.3f} ms]  host={s.get('host')}"
                   f"{extra}{'  (orphan)' if orphan else ''}")
        for c in children.get(s["span"], []):
            walk(c, depth + 1)

    for i, r in enumerate(roots):
        walk(r, 0, orphan=bool(r.get("parent", 0)))
    return out


def attribution_table(traces: Dict[str, List[dict]]) -> Dict[str, Dict]:
    """Burst-level latency attribution: per stage (span name), the
    count and p50/p99 duration across every trace.  Terminal spans
    (zero-duration markers) aggregate by their full name so EXPIRED/
    FAILED/SHED terminals stay distinguishable."""
    durs: Dict[str, List[float]] = {}
    for spans in traces.values():
        for s in spans:
            durs.setdefault(s["name"], []).append(s["dur"] / 1e3)

    def pctl(vals: List[float], q: float) -> float:
        vs = sorted(vals)
        return vs[min(len(vs) - 1, int(len(vs) * q / 100.0))]

    return {name: {"n": len(vs),
                   "p50_ms": round(pctl(vs, 50), 3),
                   "p99_ms": round(pctl(vs, 99), 3)}
            for name, vs in sorted(durs.items())}


def decision_query(doc, corr: str) -> List[dict]:
    """Every decision event carrying correlation id ``corr``, from a
    scheduler action list, a rollout event list, a flight record, or
    any nesting of those (lists of dicts are searched recursively)."""
    out: List[dict] = []

    def walk(node) -> None:
        if isinstance(node, dict):
            if node.get("corr") == corr:
                out.append(node)
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(doc)
    return out


# ---------------------------------------------------------------------------
# the live 2-agent protocol (--check)
# ---------------------------------------------------------------------------

def _agent_trees(url: str, timeout_s: float = 10.0) -> dict:
    from mx_rcnn_tpu_torch.netio import read_limited

    with urllib.request.urlopen(url.rstrip("/") + "/trace",
                                timeout=timeout_s) as r:
        return json.loads(read_limited(r).decode())


def _merge_now(urls: List[str], path: str = None) -> Dict:
    """Merge this process's kept trees with every agent's /trace dump
    under the head's current skew estimates.  Engine names pin agent i
    to skew source ``remote-i`` (build_crosshost_router order)."""
    from mx_rcnn_tpu_torch.obs import trace as obs_trace

    remote_by_source: Dict[str, List[dict]] = {}
    offsets: Dict[str, float] = {}
    for i, u in enumerate(urls):
        src = f"remote-{i}"
        try:
            remote_by_source[src] = _agent_trees(u).get("trees", [])
        except OSError:
            remote_by_source[src] = []  # SIGKILLed host: spans lost
        off = obs_trace.skew().offset_ms(src)
        if off is not None:
            offsets[src] = off
    return obs_trace.merge_fleet_trace(obs_trace.kept_trees(),
                                       remote_by_source, offsets,
                                       path=path)


def _root_spans(spans: List[dict]) -> List[dict]:
    return [s for s in spans if s["name"] == "request"]


def run_check(args) -> int:
    from mx_rcnn_tpu_torch.analysis import sanitizer
    from mx_rcnn_tpu_torch.config import (generate_config,
                                          parse_set_overrides)
    from mx_rcnn_tpu_torch.obs import trace as obs_trace
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router
    from mx_rcnn_tpu_torch.tools.crosshost import (AgentProc, _prepared_set,
                                                   _run_prepared_closed)
    from mx_rcnn_tpu_torch.tools.loadgen import _drain, _smoke_overrides

    from mx_rcnn_tpu_torch.serve.fleet import default_devices

    # the agents' device is resolved (and refused) before anything runs
    default_devices(args.device)
    smoke = args.smoke
    overrides = dict(_smoke_overrides())
    overrides.update(parse_set_overrides(args.set))
    # the check needs every trace end-to-end: sample everything, keep
    # everything (slow_pct=0 disables the percentile cut), and size the
    # rings so the burst cannot evict its own evidence
    trace_over = {"obs__trace_sample": 1.0, "obs__trace_ring": 8192,
                  "obs__trace_slow_pct": 0.0}
    agent_overrides = dict(overrides, **trace_over)
    cfg = generate_config(args.network, args.dataset,
                          **agent_overrides)
    workdir = args.workdir or tempfile.mkdtemp(prefix="trace_check_")
    os.makedirs(workdir, exist_ok=True)
    timeout_ms = 20_000.0
    dur = 2.0 if smoke else 4.0
    batch = cfg.serve.batch_size
    stub_ms = 20.0
    ch_over = {"connections": 2, "pipeline_depth": 4 * batch,
               "scrape_interval_s": 0.2, "io_timeout_s": 30.0}
    rec: dict = {
        "metric": "trace_complete_tree_pct",
        "unit": "%",
        "measured": True,
        "smoke": smoke,
        "network": args.network,
        "batch_size": batch,
        "stub_model_ms": stub_ms,
        "device": args.device,
        "host": {"cores": os.cpu_count()},
        "note": "2 stub-agent processes on one machine: checks the "
                "tracing plane (propagation, skew merge, retention), "
                "not several machines",
    }
    problems: List[str] = []
    prepared = _prepared_set(cfg, args.images, args.seed)
    obs_trace.configure_distributed(host="head")
    tcfg = cfg.replace_in("crosshost", **ch_over)

    # -- 1. traced burst: completeness + skew-corrected merge -----------
    logger.info("[trace] traced-burst leg ...")
    agents = [AgentProc(workdir, f"trace-{i}", agent_overrides,
                        network=args.network, dataset=args.dataset,
                        replicas=1, stub_ms=stub_ms, device=args.device)
              for i in range(2)]
    try:
        for a in agents:
            a.wait_ready()
        urls = [a.url for a in agents]
        router, feed = build_crosshost_router(tcfg, urls)
        try:
            run = _run_prepared_closed(router, prepared, dur,
                                       concurrency=2 * batch * 2,
                                       timeout_ms=timeout_ms)
            _drain(router)
        finally:
            feed.close()
            router.close()
        # client waits unblock INSIDE the terminal transition, before
        # the worker thread closes the trace — let the tail settle
        time.sleep(0.25)
        merged = _merge_now(urls, path=os.path.join(workdir,
                                                    "trace_burst.json"))
        head_trees = obs_trace.kept_trees()
        complete = monotonic = cross_host = 0
        for t in head_trees:
            spans = merged["traces"].get(t["trace"], [])
            complete += obs_trace.tree_complete(spans)
            monotonic += obs_trace.tree_monotonic(spans)
            cross_host += len({s.get("host") for s in spans}) >= 2
        n = len(head_trees)
        leg = {
            "client": run["client"],
            "traces_kept": n,
            "complete_pct": round(100.0 * complete / max(n, 1), 2),
            "monotonic_pct": round(100.0 * monotonic / max(n, 1), 2),
            "cross_host_traces": cross_host,
            "clamped_spans": merged["metadata"]["clamped"],
            "offsets_ms": merged["metadata"]["offsets_ms"],
            "chrome_trace": os.path.join(workdir, "trace_burst.json"),
        }
        rec["traced_burst"] = leg
        rec["value"] = leg["complete_pct"]
        if run["client"]["ok"] == 0:
            problems.append("traced burst served nothing")
        if n == 0:
            problems.append("traced burst kept no span trees")
        if leg["complete_pct"] < 100.0:
            problems.append(f"span trees only {leg['complete_pct']}% "
                            "complete (claim: 100%)")
        if leg["monotonic_pct"] < 100.0:
            problems.append("skew-corrected timelines not monotonic: "
                            f"{leg['monotonic_pct']}%")
        if cross_host == 0:
            problems.append("no trace carries spans from 2+ hosts")
        if not leg["offsets_ms"]:
            problems.append("skew estimator saw no timestamp pairs")
    finally:
        for a in agents:
            a.kill()

    # -- 2. SIGKILL-reroute: both attempts, ONE trace --------------------
    logger.info("[trace] SIGKILL-reroute leg ...")
    obs_trace.reset_distributed()
    kcfg = tcfg.replace_in("crosshost", dead_after_failures=2)
    kcfg = kcfg.replace_in("fleet", reroute_retries=2,
                           health_interval_s=0.2)
    agents = [AgentProc(workdir, f"kill-{i}", agent_overrides,
                        network=args.network, dataset=args.dataset,
                        replicas=1, stub_ms=stub_ms, device=args.device)
              for i in range(2)]
    try:
        for a in agents:
            a.wait_ready()
        urls = [a.url for a in agents]
        router, feed = build_crosshost_router(kcfg, urls)
        try:
            kdur = max(dur, 4.0)
            box: dict = {}

            def burst():
                box["run"] = _run_prepared_closed(
                    router, prepared, kdur, concurrency=2 * batch * 2,
                    timeout_ms=timeout_ms)

            bt = threading.Thread(target=burst, daemon=True)
            bt.start()
            time.sleep(kdur / 3.0)
            agents[1].sigkill()
            bt.join()
            _drain(router)
        finally:
            feed.close()
            router.close()
        time.sleep(0.25)   # same settle as leg 1
        merged = _merge_now(urls, path=os.path.join(workdir,
                                                    "trace_kill.json"))
        rerouted = []
        for t in obs_trace.kept_trees():
            spans = merged["traces"].get(t["trace"], [])
            attempts = [s for s in spans if s["name"] == "fleet.attempt"]
            roots = _root_spans(spans)
            if len(attempts) >= 2 and roots:
                rerouted.append({
                    "trace": t["trace"],
                    "attempts": len(attempts),
                    "state": roots[0].get("args", {}).get("state"),
                    "complete": obs_trace.tree_complete(spans),
                    "monotonic": obs_trace.tree_monotonic(spans),
                })
        served_2a = [r for r in rerouted if r["state"] == "served"]
        leg = {
            "client": box["run"]["client"],
            "rerouted_traces": len(rerouted),
            "served_after_reroute": len(served_2a),
            "all_complete": all(r["complete"] for r in rerouted),
            "all_monotonic": all(r["monotonic"] for r in rerouted),
            "example": rerouted[0] if rerouted else None,
        }
        rec["sigkill_reroute"] = leg
        if not rerouted:
            problems.append("no two-attempt trace after the SIGKILL — "
                            "the reroute is invisible to tracing")
        if rerouted and not served_2a:
            problems.append("no rerouted request both traced and "
                            "SERVED on the survivor")
        if rerouted and not leg["all_complete"]:
            problems.append("a rerouted trace lost head-side spans")
    finally:
        for a in agents:
            a.kill()

    # -- 3. overhead A/B: trace_sample=0 vs 1.0 --------------------------
    logger.info("[trace] overhead A/B leg ...")
    aw = AgentProc(workdir, "ab-agent", agent_overrides,
                   network=args.network, dataset=args.dataset,
                   replicas=1, stub_ms=stub_ms, device=args.device)
    try:
        aw.wait_ready()
        adur = max(dur / 2, 1.5)
        thr: Dict[str, List[float]] = {"untraced": [], "traced": []}
        rounds = 2
        for rnd in range(rounds):
            for arm, sample in (("untraced", 0.0), ("traced", 1.0)):
                obs_trace.reset_distributed()
                acfg = tcfg.replace_in("obs", trace_sample=sample)
                router, feed = build_crosshost_router(acfg, [aw.url])
                try:
                    # first window of each round warms the path
                    _run_prepared_closed(router, prepared, 0.5,
                                         concurrency=2 * batch,
                                         timeout_ms=timeout_ms)
                    _drain(router)
                    run = _run_prepared_closed(router, prepared, adur,
                                               concurrency=2 * batch,
                                               timeout_ms=timeout_ms)
                    _drain(router)
                finally:
                    feed.close()
                    router.close()
                thr[arm].append(run["client"]["ok"] / run["wall_s"])
        u = max(thr["untraced"])
        t = max(thr["traced"])
        overhead_pct = max(0.0, (u - t) / max(u, 1e-9) * 100.0)
        rec["overhead"] = {
            "rounds": rounds,
            "untraced_imgs_per_sec": [round(v, 2)
                                      for v in thr["untraced"]],
            "traced_imgs_per_sec": [round(v, 2) for v in thr["traced"]],
            "overhead_pct": round(overhead_pct, 3),
            "note": "best-of-rounds per arm on shared cores; the "
                    "traced arm samples 100% of requests",
        }
        if overhead_pct >= 2.0:
            problems.append(f"traced overhead {overhead_pct:.2f}% >= "
                            "2% budget")
    finally:
        aw.kill()
    obs_trace.reset_distributed()

    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    problems += sanitizer.check_problems()
    for msg in problems:
        logger.error("CHECK FAILED: %s", msg)
    return 1 if problems else 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    from mx_rcnn_tpu_torch.config import NETWORKS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="tiny", choices=NETWORKS)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--set", action="append", metavar="section__f=v")
    p.add_argument("--input", default=None,
                   help="merged trace file for --tree/--table (the "
                        "--check legs write these under --workdir)")
    p.add_argument("--tree", default=None, metavar="TRACE_ID",
                   help="print one request's causal tree")
    p.add_argument("--table", action="store_true",
                   help="print the burst latency-attribution table")
    p.add_argument("--decision", default=None, metavar="CORR",
                   help="query a decision log (--input) by "
                        "correlation id")
    p.add_argument("--check", action="store_true",
                   help="run the live 2-agent protocol; non-zero exit "
                        "on any failed claim")
    p.add_argument("--smoke", action="store_true",
                   help="gate-scale durations")
    p.add_argument("--device", default="cuda",
                   help="the agents' device: cuda (default), cuda:k or "
                        "cpu")
    p.add_argument("--out", default=None,
                   help="also write the --check record to this path")
    p.add_argument("--workdir", default=None)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    if args.tree or args.table:
        if not args.input:
            print("--tree/--table need --input <merged trace json>",
                  file=sys.stderr)
            return 2
        traces = load_traces(args.input)
        if args.tree:
            spans = traces.get(args.tree)
            if spans is None:
                print(f"trace {args.tree!r} not in {args.input} "
                      f"({len(traces)} traces)", file=sys.stderr)
                return 1
            for line in format_tree(spans):
                print(line)
            return 0
        print(json.dumps(attribution_table(traces), indent=1))
        return 0
    if args.decision:
        if not args.input:
            print("--decision needs --input <decision log json>",
                  file=sys.stderr)
            return 2
        with open(args.input) as f:
            doc = json.load(f)
        hits = decision_query(doc, args.decision)
        print(json.dumps(hits, indent=1))
        return 0 if hits else 1
    if args.check:
        return run_check(args)
    print("nothing to do: pass --check, --tree, --table or --decision",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
