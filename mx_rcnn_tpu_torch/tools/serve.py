"""Online detection serving: checkpoint → warm HTTP service.

Counterpart of ``mx_rcnn_tpu/tools/serve.py``: the weights of
``--prefix``@``--epoch`` (``utils/checkpoint.py — load_model``, either
package's file) on the device, wrapped in the micro-batching
:class:`~mx_rcnn_tpu_torch.serve.engine.ServingEngine`, one dummy batch
per bucket before the first request (``--no_warmup`` skips it), then
``/detect``, ``/healthz`` and ``/metrics`` over stdlib HTTP
(``serve/server.py``) until SIGINT.  Policy is ``cfg.serve``
(``--set serve__batch_size=8``).  ``--set quant__enabled=true`` serves
the quantized predictor (a calibration sweep over held-out training
batches first; the log names the calibration fingerprint), which the
engine takes unchanged.

``--set obs__enabled=true`` opens the obs session (``obs/runrec.py —
cli_obs``): a ``runs/<id>/`` record, the engine's metrics in the process
registry (so ``/metrics`` is the unified scrape), the kept ring of
``X-MXR-Trace``-traced requests, and with ``obs__timeseries``,
``obs__health`` and ``obs__flight`` the time series on ``/metrics``, the
verdict on ``/healthz`` and the flight recorder (the engine's
``healthz`` in its dumps).  ``MXRCNN_THREAD_SANITIZER`` arms the lock
sanitizer before the package is imported.  Not ported: the JAX CLI's
compile cache.

    python -m mx_rcnn_tpu_torch.tools.serve --prefix model/e2e --epoch 1
    python -m mx_rcnn_tpu_torch.tools.serve --device cpu --network tiny \\
        --dataset synthetic --prefix /tmp/p --epoch 1 --port 0
"""

from __future__ import annotations

# the lock sanitizer first: the locks the package allocates at import
# are born wrapped only if it is armed before
from mx_rcnn_tpu_torch.analysis import sanitizer  # isort: skip

sanitizer.maybe_install_from_env()

import argparse  # noqa: E402
import logging  # noqa: E402

from mx_rcnn_tpu_torch.config import (NETWORKS,  # noqa: E402
                                      generate_config, parse_set_overrides)
from mx_rcnn_tpu_torch.obs import trace as obs_trace  # noqa: E402
from mx_rcnn_tpu_torch.obs.metrics import ServeMetrics, registry  # noqa: E402
from mx_rcnn_tpu_torch.obs.runrec import cli_obs  # noqa: E402
from mx_rcnn_tpu_torch.serve.engine import ServingEngine  # noqa: E402
from mx_rcnn_tpu_torch.serve.server import make_server  # noqa: E402
from mx_rcnn_tpu_torch.tools.loadgen import init_predictor  # noqa: E402

logger = logging.getLogger("mx_rcnn_tpu_torch")


def open_obs(cfg):
    """The serving obs session: ``(session, metrics)``, both None when
    ``cfg.obs`` is off.  ``metrics`` records into the process registry;
    the kept-trace ring is armed for inbound trace headers."""
    obs_sess = cli_obs(cfg, "serve")
    if obs_sess is None:
        return None, None
    obs_trace.configure_distributed(
        sample=cfg.obs.trace_sample, ring=cfg.obs.trace_ring,
        slow_pct=cfg.obs.trace_slow_pct)
    return obs_sess, ServeMetrics(registry=registry())


def watch_engine(obs_sess, engine: ServingEngine) -> None:
    """A flight dump of this process carries the engine's queues and
    warm buckets at dump time."""
    if obs_sess is not None and obs_sess.flight is not None:
        obs_sess.flight.add_context("engine", engine.healthz)


def close_obs(obs_sess, engine: ServingEngine) -> None:
    """The run record's closing ``serve_stats`` and summary; the trace
    ring disarmed.  Call it after the engine closed."""
    if obs_sess is None:
        return
    snap = engine.metrics.snapshot()
    obs_sess.record.event("serve_stats", **snap["counters"])
    obs_sess.close(metric="serve_requests_served",
                   value=snap["counters"]["served"], unit="requests")
    obs_trace.reset_distributed()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="resnet101", choices=NETWORKS)
    p.add_argument("--dataset", default="PascalVOC",
                   choices=["PascalVOC", "coco", "synthetic",
                            "synthetic_hard"])
    p.add_argument("--prefix", default="model/e2e")
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (logged)")
    p.add_argument("--class_names", default=None,
                   help="comma-separated class names (index 0 = "
                        "background); default labels are cls<N>")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the dummy batch per bucket at startup")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    cfg = generate_config(args.network, args.dataset,
                          **parse_set_overrides(args.set))
    obs_sess, metrics = open_obs(cfg)
    engine = srv = None
    try:
        # the device is resolved (and refused) before the checkpoint is
        # read
        predictor = init_predictor(cfg, args.prefix, args.epoch,
                                   device=args.device)
        if cfg.quant.enabled:
            logger.info("quant serving: %s/%s fingerprint=%s",
                        cfg.quant.dtype, cfg.quant.mode,
                        predictor.quant_fingerprint)
        engine = ServingEngine(predictor, cfg, metrics=metrics)
        if not args.no_warmup:
            logger.info("warming %d bucket(s) at batch %d ...",
                        len(engine.buckets), cfg.serve.batch_size)
            engine.warmup()
        watch_engine(obs_sess, engine)
        names = args.class_names.split(",") if args.class_names else None
        srv = make_server(engine, args.host, args.port, class_names=names,
                          max_body_mb=cfg.serve.max_body_mb)
        host, port = srv.server_address[:2]
        logger.info("serving on http://%s:%d  (POST /detect, GET /healthz, "
                    "GET /metrics)", host, port)
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        if srv is not None:
            srv.server_close()
        if engine is not None:
            engine.close()
            close_obs(obs_sess, engine)
        elif obs_sess is not None:
            obs_sess.close()


if __name__ == "__main__":
    main()
