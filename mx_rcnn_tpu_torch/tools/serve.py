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
engine takes unchanged.  Not ported: the JAX CLI's observability hooks
(``cli_obs``) and its compile cache.

    python -m mx_rcnn_tpu_torch.tools.serve --prefix model/e2e --epoch 1
    python -m mx_rcnn_tpu_torch.tools.serve --device cpu --network tiny \\
        --dataset synthetic --prefix /tmp/p --epoch 1 --port 0
"""

from __future__ import annotations

import argparse
import logging

from mx_rcnn_tpu_torch.config import (NETWORKS, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.server import make_server
from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

logger = logging.getLogger("mx_rcnn_tpu_torch")


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
    # the device is resolved (and refused) before the checkpoint is read
    predictor = init_predictor(cfg, args.prefix, args.epoch,
                               device=args.device)
    if cfg.quant.enabled:
        logger.info("quant serving: %s/%s fingerprint=%s", cfg.quant.dtype,
                    cfg.quant.mode, predictor.quant_fingerprint)
    engine = ServingEngine(predictor, cfg)
    if not args.no_warmup:
        logger.info("warming %d bucket(s) at batch %d ...",
                    len(engine.buckets), cfg.serve.batch_size)
        engine.warmup()
    names = args.class_names.split(",") if args.class_names else None
    srv = make_server(engine, args.host, args.port, class_names=names,
                      max_body_mb=cfg.serve.max_body_mb)
    host, port = srv.server_address[:2]
    logger.info("serving on http://%s:%d  (POST /detect, GET /healthz, "
                "GET /metrics)", host, port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        srv.server_close()
        engine.close()


if __name__ == "__main__":
    main()
