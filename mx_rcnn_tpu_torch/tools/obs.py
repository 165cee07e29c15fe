"""The fleet observability CLI: live view, SLO check, manual dump, smoke.

Counterpart of ``mx_rcnn_tpu/tools/obs.py``, the consumer of the
time-series plane (``obs/timeseries.py``, ``collect.py``, ``health.py``,
``flightrec.py``):

* ``watch``: scrape the given ``/metrics`` sources every interval and
  print the merged, source-labelled view, one block a tick;
* ``check``: scrape the sources ``--samples`` times into a local
  window (``collect.view_to_snapshot``), judge the default SLO rules,
  print the verdict as JSON and exit ``0`` OK, ``1`` WARN, ``2``
  CRITICAL (``3``: no source answered; unknown is not healthy);
* ``dump``: write a flight-style record of the current merged view (the
  manual pull in an incident);
* ``smoke``: an observed 2-replica fleet burst with a replica killed
  mid-burst: the merged labelled view (replicas, router, and an
  elastic-shaped registry scraped over real HTTP), the CRITICAL to OK
  verdict around the relaunch, and a parseable flight record naming the
  ejected replica.  The stand-in model by default (the router and the
  plane are under test); ``--export`` runs an export-warmed fleet
  instead.
  It runs on the card unless ``--device cpu``.

The smoke's HTTP source, as the JAX smoke's, is an elastic-shaped
registry: the ``elastic.generation`` and ``elastic.num_devices`` gauges
and the ``elastic.recovery_ms`` histogram that ``ft/elastic.py``
publishes.  Sources: ``--url host:port`` (repeatable, ``name=url`` too)
or ``cfg.obs.collect_urls``.
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
import time  # noqa: E402

from mx_rcnn_tpu_torch.config import (NETWORKS,  # noqa: E402
                                      generate_config, parse_set_overrides)
from mx_rcnn_tpu_torch.obs.collect import (  # noqa: E402
    Collector, HttpSource, collector_for_fleet, sources_from_urls,
    view_to_snapshot)
from mx_rcnn_tpu_torch.obs.health import (  # noqa: E402
    EXIT_BY_VERDICT, HealthEngine, default_rules)
from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore  # noqa: E402

logger = logging.getLogger("mx_rcnn_tpu_torch")

EXIT_NO_SOURCE = 3


def _collector_from_args(args, cfg) -> Collector:
    urls = list(args.url or [])
    if not urls and cfg.obs.collect_urls:
        urls = [cfg.obs.collect_urls]
    sources = []
    for u in urls:
        sources.extend(sources_from_urls(u))
    return Collector(sources)


def _fmt_view(view) -> str:
    """One human block per collection: per-source status line + the
    headline aggregate numbers."""
    lines = []
    for name, src in sorted(view["sources"].items()):
        if not src.get("up"):
            lines.append(f"  {name:<14} DOWN")
            continue
        lab = src.get("labels", {})
        gen = lab.get("generation")
        extras = f" gen={gen}" if gen is not None else ""
        c = src.get("counters", {})
        served = c.get("serve.served", c.get("served"))
        lines.append(f"  {name:<14} up{extras}"
                     + (f" served={served}" if served is not None else ""))
    agg = view["agg"]["counters"]
    head = {k: v for k, v in sorted(agg.items())
            if k.startswith(("serve.", "bulk.", "train."))}
    lines.append(f"  agg: {json.dumps(head)[:160]}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# watch / check / dump
# ---------------------------------------------------------------------------

def cmd_watch(args) -> int:
    cfg = generate_config(args.network, args.dataset,
                          **parse_set_overrides(args.set))
    collector = _collector_from_args(args, cfg)
    if not collector.names():
        print("obs watch: no sources (pass --url or set "
              "obs.collect_urls)", file=sys.stderr)
        return EXIT_NO_SOURCE
    n = 0
    try:
        while args.iterations <= 0 or n < args.iterations:
            view = collector.collect()
            print(f"-- {time.strftime('%H:%M:%S')}  "
                  f"{view['up']}/{len(view['sources'])} sources up")
            print(_fmt_view(view), flush=True)
            n += 1
            if args.iterations <= 0 or n < args.iterations:
                time.sleep(args.interval_s)
    except KeyboardInterrupt:
        pass
    return 0


def run_check(collector: Collector, cfg, samples: int,
              interval_s: float) -> dict:
    """The check protocol, callable in-process (the smoke reuses it
    against a live fleet's collector): scrape ``samples`` times into a
    local window, judge the default rules over it, return the verdict
    document (plus the final merged view under ``"view"``)."""
    store = TimeSeriesStore(capacity=max(samples + 2, 16))
    engine = HealthEngine(default_rules(cfg), store)
    view = None
    up = 0
    ever_up: set = set()
    for i in range(samples):
        view = collector.collect()
        up = view["up"]
        ever_up.update(name for name, src in view["sources"].items()
                       if src.get("up"))
        store.append_snapshot(view_to_snapshot(view), ts=view["ts"])
        engine.evaluate()
        if i < samples - 1:
            time.sleep(interval_s)
    verdict = dict(engine.last() or {"verdict": "OK", "code": 0,
                                     "rules": [], "firing": []})
    verdict["sources_up"] = up
    verdict["samples"] = samples
    # a configured source that answered NO scrape the whole check: it
    # contributed zero samples, so every gauge-backed judgment treats
    # it exactly like a downed one (absent, not stale) — but the
    # operator should see the distinction spelled out
    verdict["never_up"] = sorted(set(collector.names()) - ever_up)
    if view is not None:
        verdict["view"] = {
            name: ({"up": src.get("up", False),
                    **({"labels": src["labels"]} if src.get("up")
                       else {})})
            for name, src in view["sources"].items()}
    return verdict


def cmd_check(args) -> int:
    cfg = generate_config(args.network, args.dataset,
                          **parse_set_overrides(args.set))
    collector = _collector_from_args(args, cfg)
    if not collector.names():
        print("obs check: no sources (pass --url or set "
              "obs.collect_urls)", file=sys.stderr)
        return EXIT_NO_SOURCE
    verdict = run_check(collector, cfg, args.samples, args.interval_s)
    print(json.dumps(verdict, indent=1))
    if verdict["sources_up"] == 0:
        return EXIT_NO_SOURCE  # unknown is not healthy
    return EXIT_BY_VERDICT[verdict["verdict"]]


def cmd_dump(args) -> int:
    cfg = generate_config(args.network, args.dataset,
                          **parse_set_overrides(args.set))
    collector = _collector_from_args(args, cfg)
    if not collector.names():
        print("obs dump: no sources (pass --url or set "
              "obs.collect_urls)", file=sys.stderr)
        return EXIT_NO_SOURCE
    view = collector.collect()
    record = {"schema": "mx_rcnn_tpu.flight/2", "reason": "manual",
              "ts": view["ts"], "pid": os.getpid(), "view": view}
    from mx_rcnn_tpu_torch.utils.checkpoint import _atomic_write

    out = args.out or f"flight-manual-{int(view['ts'])}.json"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    _atomic_write(out, json.dumps(record, indent=1).encode())
    print(f"obs dump: {view['up']}/{len(view['sources'])} sources "
          f"-> {out}")
    return 0 if view["up"] > 0 else EXIT_NO_SOURCE


# ---------------------------------------------------------------------------
# smoke
# ---------------------------------------------------------------------------

def run_smoke(args) -> dict:
    """Observed 2-replica fleet burst with a mid-burst replica kill.

    The whole plane runs as production wires it — ``cli_obs`` builds
    the store/sampler/health/flight from cfg, the fleet publishes its
    gauges through ``ReplicaManager.export_gauges`` and its
    eject/rejoin events through the run record, and an elastic-shaped
    registry is scraped over real HTTP so the merged view crosses an HTTP
    boundary as a live fleet's does.  Assertions
    (folded into ``ev["problems"]``):

    * merged view: both replicas up with ``source``/``generation``
      labels, the HTTP elastic source up with its gauges, counters
      aggregated;
    * kill-mid-burst: verdict transitions to CRITICAL on the eject and
      back to OK after the relaunch (`fleet-degraded` rule);
    * flight: a ``health-critical`` record written, parseable, schema-
      tagged, and naming the ejected replica (the ``fleet_eject``
      event + the router's healthz context);
    * ``run_check`` over the live collector returns OK with exit-code
      semantics once the fleet has healed.
    """
    import tempfile
    import threading

    from mx_rcnn_tpu_torch.obs.metrics import Registry, registry, \
        start_metrics_server
    from mx_rcnn_tpu_torch.obs.runrec import cli_obs
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet
    from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded, RequestFailed,
                                               ShedError)
    from mx_rcnn_tpu_torch.tools.loadgen import (_smoke_overrides,
                                                 make_stub_run_fn,
                                                 synthetic_images)

    from mx_rcnn_tpu_torch.serve.fleet import default_devices

    # the device is resolved (and refused) before anything is written
    default_devices(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="health_smoke_")
    os.makedirs(workdir, exist_ok=True)
    overrides = dict(_smoke_overrides())
    overrides.update({
        "fleet__replicas": 2, "fleet__health_interval_s": 0.2,
        "obs__enabled": True, "obs__run_dir": os.path.join(workdir,
                                                           "runs"),
        "obs__timeseries": True, "obs__sample_interval_s": 0.1,
        "obs__health": True, "obs__flight": True,
        "obs__flight_window_s": 60.0,
    })
    overrides.update(parse_set_overrides(args.set))
    cfg = generate_config(args.network, args.dataset, **overrides)
    registry().reset()

    ev: dict = {"workdir": workdir, "problems": []}
    problems = ev["problems"]

    # a stand-in run_fn replaces the forward; --export runs the real,
    # export-warmed path
    variables = None
    export_root = None
    factory = (lambda rid: make_stub_run_fn(cfg, args.stub_ms,
                                            seed=rid))
    if args.export:
        from mx_rcnn_tpu_torch.serve.export import (export_serve_programs,
                                                    predictor_variables)
        from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

        predictor = init_predictor(cfg, device=args.device)
        export_root = os.path.join(workdir, "store")
        export_serve_programs(predictor, cfg, export_root)
        variables = predictor_variables(predictor)
        del predictor
        factory = None

    obs_sess = cli_obs(cfg, "health_smoke")
    assert obs_sess is not None and obs_sess.health is not None

    # the elastic-shaped peer: its own registry behind a real HTTP
    # exporter, so the collector crosses an HTTP boundary as a live
    # fleet's scrape does (the gauges mirror what ft/elastic.py publishes)
    elastic_reg = Registry()
    elastic_reg.set_gauge("elastic.generation", 1)
    elastic_reg.set_gauge("elastic.num_devices", 1)
    elastic_reg.observe("elastic.recovery_ms", 1500.0, lo=1.0,
                        hi=600_000.0)
    elastic_srv = start_metrics_server(elastic_reg, port=0)
    elastic_url = "http://%s:%d/metrics" % elastic_srv.server_address[:2]

    router = build_fleet(cfg, variables, export_root=export_root,
                         run_fn_factory=factory, device=args.device,
                         record=obs_sess.record)
    verdicts = []
    seen_lock = threading.Lock()

    def on_verdict(_smp):
        obs_sess.health.evaluate()
        v = obs_sess.health.verdict
        with seen_lock:
            if not verdicts or verdicts[-1] != v:
                verdicts.append(v)

    # rebind the sampler hook so the smoke records the verdict SEQUENCE
    obs_sess.sampler._after = on_verdict
    obs_sess.flight.add_context("fleet", router.healthz)

    try:
        collector = collector_for_fleet(
            router, extra_sources=[HttpSource("elastic-0", elastic_url)])
        view = collector.collect()
        ev["sources"] = sorted(view["sources"])
        ev["elastic_gauges"] = sorted(
            k for k in view["agg"]["gauges"] if k.startswith("elastic."))
        for want in ("replica-0", "replica-1", "elastic-0", "router"):
            src = view["sources"].get(want)
            if not (src and src.get("up")):
                problems.append(f"source {want} not up in merged view: "
                                f"{src}")
        for rid in (0, 1):
            lab = view["sources"].get(f"replica-{rid}", {}).get(
                "labels", {})
            if lab.get("source") != f"replica-{rid}" \
                    or lab.get("generation") != 1:
                problems.append(f"replica-{rid} labels wrong: {lab}")
        if "elastic.generation" not in view["agg"]["gauges"]:
            problems.append("elastic gauges missing from merged view")

        # closed-loop burst with a mid-burst kill (the
        # loadgen._kill_mid_burst_leg pattern, obs-instrumented)
        images = synthetic_images(cfg, 8)
        concurrency = 2 * cfg.serve.batch_size * 2
        duration_s = args.duration_s
        stop = time.monotonic() + duration_s
        kill_at = time.monotonic() + duration_s / 3.0
        outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
        olock = threading.Lock()

        def worker(wid: int):
            i = wid
            while time.monotonic() < stop:
                try:
                    router.detect(images[i % len(images)],
                                  timeout_ms=5000.0)
                    key = "ok"
                except ShedError:
                    key = "shed"
                except DeadlineExceeded:
                    key = "expired"
                except (RequestFailed, TimeoutError):
                    key = "failed"
                i += concurrency
                with olock:
                    outcomes[key] += 1

        threads = [threading.Thread(target=worker, args=(w,),
                                    daemon=True)
                   for w in range(concurrency)]
        for t in threads:
            t.start()
        while time.monotonic() < kill_at:
            time.sleep(0.02)
        victim = router.manager.replicas[0]
        victim.engine.kill()
        kill_t = time.monotonic()
        for t in threads:
            t.join()
        # wait out the relaunch
        rejoin_s = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if victim.ready() and victim.generation >= 2:
                rejoin_s = round(victim.joins[-1]["ready_t"] - kill_t, 2)
                break
            time.sleep(0.05)
        if rejoin_s is None:
            problems.append("victim replica never relaunched")
        # let the sampler observe the healed fleet
        ok_deadline = time.monotonic() + 10.0
        while (obs_sess.health.verdict != "OK"
               and time.monotonic() < ok_deadline):
            time.sleep(0.1)
        with seen_lock:
            seq = list(verdicts)
        ev["verdict_sequence"] = seq
        ev["outcomes"] = outcomes
        ev["rejoin_s"] = rejoin_s
        if "CRITICAL" not in seq:
            problems.append(f"no CRITICAL transition on kill: {seq}")
        if not seq or seq[-1] != "OK":
            problems.append(f"verdict did not recover to OK: {seq}")

        # the check surface against the (healed) live fleet
        check = run_check(collector, cfg, samples=3, interval_s=0.2)
        ev["check"] = {k: check[k] for k in ("verdict", "code",
                                             "sources_up")}
        if check["verdict"] != "OK":
            firing = [r for r in check["rules"] if r["firing"]]
            problems.append(f"post-heal check not OK: {firing}")
        if check["sources_up"] < 4:
            problems.append(f"check saw {check['sources_up']} sources, "
                            "wanted 4")

        # flight record: written, parseable, names the ejected replica
        dumps = [p for p in obs_sess.flight.dumps
                 if "health-critical" in p]
        ev["flight_dumps"] = list(obs_sess.flight.dumps)
        if not dumps:
            problems.append("no health-critical flight record written")
        else:
            with open(dumps[0]) as f:
                rec = json.load(f)
            if rec.get("schema") != "mx_rcnn_tpu.flight/2":
                problems.append(f"flight schema wrong: "
                                f"{rec.get('schema')}")
            if not rec.get("samples"):
                problems.append("flight record has no samples")
            ejected = [e for e in rec.get("events", [])
                       if e.get("event") == "fleet_eject"]
            if not any(e.get("replica") == victim.id for e in ejected):
                problems.append(f"flight record does not name ejected "
                                f"replica {victim.id}: {ejected}")
            ctx = rec.get("context", {}).get("fleet", {})
            if not any(r.get("id") == victim.id
                       for r in ctx.get("replicas", [])):
                problems.append("fleet context missing from flight "
                                "record")
        # scrape shape: the serving /metrics carries the timeseries
        # section while the store is active (the obs-smoke twin assert,
        # here over the fleet front end's snapshot path)
        snap = router.metrics.snapshot()
        snap["timeseries"] = (obs_sess.store.scrape_section()
                              if obs_sess.store else None)
        if not snap["timeseries"] or snap["timeseries"]["samples"] < 5:
            problems.append(f"timeseries store thin: "
                            f"{snap['timeseries']}")
    finally:
        router.close()
        elastic_srv.shutdown()
        elastic_srv.server_close()
        obs_sess.close(metric="health_smoke_requests",
                       value=None, unit="requests")
    ev["ok"] = not problems
    return ev


def cmd_smoke(args) -> int:
    ev = run_smoke(args)
    print("HEALTH_SMOKE " + json.dumps(
        {k: v for k, v in ev.items() if k != "check"} | {
            "check": ev.get("check")}, default=repr))
    if args.check:
        for p in ev["problems"]:
            print(f"HEALTH_SMOKE_PROBLEM {p}", file=sys.stderr)
        return 0 if ev["ok"] else 1
    return 0


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--network", default="tiny", choices=NETWORKS)
        sp.add_argument("--dataset", default="synthetic",
                        choices=["PascalVOC", "coco", "synthetic",
                                 "synthetic_hard"])
        sp.add_argument("--url", action="append", default=[],
                        help="/metrics source (host:port, URL, or "
                             "name=url; repeatable, comma-lists ok)")
        sp.add_argument("--set", action="append",
                        metavar="SEC__FIELD=VAL",
                        help="override a config field (repeatable)")

    w = sub.add_parser("watch", help="live merged fleet view")
    common(w)
    w.add_argument("--interval_s", type=float, default=2.0)
    w.add_argument("--iterations", type=int, default=0,
                   help="stop after N collections (0 = forever)")
    w.set_defaults(fn=cmd_watch)

    c = sub.add_parser("check", help="SLO verdict with exit code "
                                     "(0 OK / 1 WARN / 2 CRITICAL / "
                                     "3 no source)")
    common(c)
    c.add_argument("--samples", type=int, default=5)
    c.add_argument("--interval_s", type=float, default=1.0)
    c.set_defaults(fn=cmd_check)

    d = sub.add_parser("dump", help="manual flight-style dump of the "
                                    "merged view")
    common(d)
    d.add_argument("--out", default=None)
    d.set_defaults(fn=cmd_dump)

    s = sub.add_parser("smoke", help="kill-mid-burst verdict and "
                                     "flight-record assertions")
    common(s)
    s.add_argument("--workdir", default=None)
    s.add_argument("--duration_s", type=float, default=6.0)
    s.add_argument("--stub_ms", type=float, default=15.0,
                   help="stub model time per batch (stub fleet mode)")
    s.add_argument("--export", action="store_true",
                   help="run an export-warmed fleet of the model instead "
                        "of the stand-in (slower)")
    s.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:k or cpu")
    s.add_argument("--check", action="store_true",
                   help="exit nonzero when any assertion fails")
    s.set_defaults(fn=cmd_smoke)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
