"""Fleet serving CLI: the export store, an N-replica HTTP service, and
one replica's cold join.

Counterpart of ``mx_rcnn_tpu/tools/fleet.py``.  Three subcommands:

* ``export``: the serving programs' store (``serve/export.py —
  export_serve_programs``): each bucket's forward and the postprocess
  with the digest of their outputs (held to a second run), the kernel
  libraries they launched and the weights, which a replica builds its
  predictor from.  The JAX ``--eval_batch`` and ``--no_verify`` are not
  here: the port's store holds no eval program, and it always holds
  every program to a second run::

      python -m mx_rcnn_tpu_torch.tools.fleet export --network resnet101 \\
          --prefix model/e2e --epoch 10 --out model/export

* ``serve``: the replica manager and the join-shortest-queue router
  behind ``tools/serve.py``'s HTTP front end (``POST /detect``,
  ``GET /healthz`` with each replica's state, ``GET /metrics`` with the
  fleet's accounting).  A quantized fleet is calibrated once here and
  every replica takes the same scales::

      python -m mx_rcnn_tpu_torch.tools.fleet serve --replicas 2 \\
          --export_dir model/export --prefix model/e2e --epoch 10

* ``join_bench``: one replica's cold join, timed in this process, and
  one JSON line.  ``--mode trace`` runs the warm-up (a process whose
  package copy has an empty ``_build/`` builds K1 and K2 there);
  ``--mode export`` joins from ``--export_dir`` (it installs the store's
  libraries and builds none).  ``overhead_s`` is the first warm-up less
  a second one, bucket by bucket, plus the store's load: the join's own
  cost beside the model's.  ``tools/loadgen.py --fleet_bench`` runs both
  modes in fresh processes.

Every subcommand runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

# the lock sanitizer first: the locks the package allocates at import
# are born wrapped only if it is armed before
from mx_rcnn_tpu_torch.analysis import sanitizer  # isort: skip

sanitizer.maybe_install_from_env()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import time  # noqa: E402

from mx_rcnn_tpu_torch.config import (NETWORKS,  # noqa: E402
                                      generate_config, parse_set_overrides)

logger = logging.getLogger("mx_rcnn_tpu_torch")


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--network", default="tiny", choices=NETWORKS)
    p.add_argument("--dataset", default="synthetic",
                   choices=["PascalVOC", "coco", "synthetic",
                            "synthetic_hard", "synthetic_stream"])
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix (default: random weights)")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")


def _config(args):
    return generate_config(args.network, args.dataset,
                           **parse_set_overrides(args.set))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="write and verify an export store")
    _add_model_args(pe)
    pe.add_argument("--out", required=True, help="export store directory")

    ps = sub.add_parser("serve", help="N-replica fleet HTTP service")
    _add_model_args(ps)
    ps.add_argument("--replicas", type=int, default=None,
                    help="replica count (default fleet.replicas)")
    ps.add_argument("--export_dir", default=None,
                    help="join the replicas from this export store "
                         "(default fleet.export_dir; empty: by running "
                         "the warm-up)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8080,
                    help="0 picks a free port (logged)")
    ps.add_argument("--class_names", default=None)

    pj = sub.add_parser("join_bench",
                        help="time one replica's cold join and print JSON")
    _add_model_args(pj)
    pj.add_argument("--mode", required=True, choices=["trace", "export"])
    pj.add_argument("--export_dir", default=None,
                    help="the store of --mode export")
    return p.parse_args(argv)


def _init_predictor(cfg, args):
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    return init_predictor(cfg, args.prefix, args.epoch, args.seed,
                          args.device)


def cmd_export(args) -> int:
    from mx_rcnn_tpu_torch.obs.runrec import cli_obs
    from mx_rcnn_tpu_torch.serve.export import export_serve_programs

    cfg = _config(args)
    obs_sess = cli_obs(cfg, "fleet_export")
    report = None
    try:
        predictor = _init_predictor(cfg, args)
        t0 = time.perf_counter()
        report = export_serve_programs(predictor, cfg, args.out,
                                       bundle_variables=True)
        report["export_s"] = round(time.perf_counter() - t0, 2)
    finally:
        if obs_sess is not None:
            obs_sess.close(metric="fleet_export_s",
                           value=(report or {}).get("export_s"),
                           unit="s", store=args.out)
    print(json.dumps(report), flush=True)
    return 0


def fleet_variables(cfg, args):
    """The weights every replica builds from, as the JAX-layout tree: the
    checkpoint's (or random ones from ``--seed``), with the ``quant``
    scales of one calibration sweep when ``cfg.quant`` is on."""
    from mx_rcnn_tpu_torch.serve.export import predictor_variables

    predictor = _init_predictor(cfg, args)
    if cfg.quant.enabled:
        logger.info("quant fleet: %s/%s calibrated once, fingerprint %s",
                    cfg.quant.dtype, cfg.quant.mode,
                    predictor.quant_fingerprint)
    return predictor_variables(predictor)


def cmd_serve(args) -> int:
    from mx_rcnn_tpu_torch.obs.runrec import cli_obs
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet, default_devices
    from mx_rcnn_tpu_torch.serve.server import make_server

    cfg = _config(args)
    if args.replicas:
        cfg = cfg.replace_in("fleet", replicas=args.replicas)
    export_dir = (cfg.fleet.export_dir if args.export_dir is None
                  else args.export_dir)
    # the device is resolved (and refused) before anything is read
    default_devices(args.device)
    obs_sess = cli_obs(cfg, "fleet")
    router = srv = None
    try:
        variables = fleet_variables(cfg, args)
        logger.info("launching %d replica(s), %s ...", cfg.fleet.replicas,
                    f"export-warm from {export_dir}" if export_dir
                    else "trace-warm")
        router = build_fleet(cfg, variables, export_root=export_dir or None,
                             device=args.device,
                             record=obs_sess.record if obs_sess else None)
        del variables
        if obs_sess is not None and obs_sess.flight is not None:
            # a flight dump of this process carries the fleet's shape
            obs_sess.flight.add_context("fleet", router.healthz)
        names = args.class_names.split(",") if args.class_names else None
        srv = make_server(router, args.host, args.port, class_names=names,
                          max_body_mb=cfg.serve.max_body_mb)
        host, port = srv.server_address[:2]
        logger.info("fleet serving on http://%s:%d  (%d replicas ready; "
                    "POST /detect, GET /healthz, GET /metrics)", host, port,
                    router.healthz()["ready"])
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        if srv is not None:
            srv.server_close()
        if router is not None:
            router.close()
        if obs_sess is not None:
            served = (router.metrics.snapshot()["counters"]["served"]
                      if router is not None else None)
            obs_sess.close(metric="fleet_requests_served", value=served,
                           unit="requests")
    return 0


def cmd_join_bench(args) -> int:
    """One replica's cold join, timed in this process: the predictor,
    then the warm-up (``trace``) or the store's join (``export``), then
    a second warm-up; one JSON line."""
    from pathlib import Path

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.obs.runrec import cli_obs
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine

    from mx_rcnn_tpu_torch.utils.device import resolve_device

    cfg = _config(args)
    if args.mode == "export" and not args.export_dir:
        raise SystemExit("--mode export requires --export_dir")
    # the device is resolved (and refused) before anything is read
    resolve_device(args.device)
    obs_sess = cli_obs(cfg, "join_bench")
    builds0 = kernels.load_events()["builds"]
    t_start = time.perf_counter()
    if args.mode == "export":
        from mx_rcnn_tpu_torch.serve.export import (ExportStore,
                                                    predictor_from_variables)

        store = ExportStore(args.export_dir)
        predictor = predictor_from_variables(store.load_variables(), cfg,
                                             args.device)
    else:
        predictor = _init_predictor(cfg, args)
    t_build = time.perf_counter() - t_start
    engine = ServingEngine(predictor, cfg, start=False)
    t0 = time.perf_counter()
    if args.mode == "export":
        join = engine.warm_from_export(store)
    else:
        engine.warmup()
        join = {}
    warm_s = time.perf_counter() - t0
    first = list(engine.last_warmup_run_s)
    builds = kernels.load_events()["builds"] - builds0
    # a second warm-up: each bucket's model alone, beside its first call
    # (adjacent, so that load drift does not split them)
    engine.warmup()
    second = engine.last_warmup_run_s
    overhead_s = sum(max(a - b, 0.0) for a, b in zip(first, second)) \
        + join.get("load_s", 0.0)
    doc = {
        "mode": args.mode,
        "build_s": round(t_build, 3),
        "warm_s": round(warm_s, 3),
        "exec_s": round(sum(second), 3),
        "overhead_s": round(max(overhead_s, 0.001), 3),
        "total_s": round(time.perf_counter() - t_start, 3),
        "programs": engine.program_count(),
        "kernel_builds": builds,
        "first_s": [round(x, 4) for x in first],
        "second_s": [round(x, 4) for x in second],
        "package": str(Path(kernels.__file__).resolve().parent),
        "device": str(predictor.device),
        **{k: v for k, v in join.items() if k in ("load_s",
                                                  "kernels_placed")},
    }
    engine.close()
    if obs_sess is not None:
        obs_sess.close(metric="join_total_s", value=doc["total_s"],
                       unit="s", mode=args.mode)
    print(json.dumps(doc), flush=True)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    return {"export": cmd_export, "serve": cmd_serve,
            "join_bench": cmd_join_bench}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
