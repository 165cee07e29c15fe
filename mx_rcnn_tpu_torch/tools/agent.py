"""The per-host replica agent CLI: the cross-host fleet's host-side entry
point.

Counterpart of ``mx_rcnn_tpu/tools/agent.py``.  Runs one
:class:`~mx_rcnn_tpu_torch.serve.agent.ReplicaAgent`: pull the export
store (when ``--store_url`` or ``crosshost.store_url`` names a head's
store server), start ``crosshost.agent_replicas`` local replicas, and
serve the agent's HTTP surface (``/healthz``, ``/metrics``, ``/trace``,
the binary ``/prepared`` and ``/frames``, ``/detect``, ``POST
/replicas``)::

    python -m mx_rcnn_tpu_torch.tools.agent --port 0 \\
        --store_url http://head:9200 --export_dir /tmp/store \\
        --replicas 2 --device cuda:0

The weights come from ``--prefix``, else from the pulled store's bundled
variables (``tools/fleet.py export`` bundles them), else from ``--seed``.
``--stub_ms`` with ``--stub plain|content`` replaces the model with
``tools/loadgen.py``'s stand-ins, as the rigs' "hosts" run.  Once the
server is bound, one JSON line goes to stdout with the bound host and
port (the rigs' handshake: they start agents on ``--port 0`` and read
it); logs go to stderr.  It runs on the card (``--device cuda`` or
``cuda:k``) unless given ``--device cpu``.
"""

from __future__ import annotations

# the lock sanitizer first: the locks the package allocates at import
# are born wrapped only if it is armed before
from mx_rcnn_tpu_torch.analysis import sanitizer  # isort: skip

sanitizer.maybe_install_from_env()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import sys  # noqa: E402

logger = logging.getLogger("mx_rcnn_tpu_torch")


def parse_args(argv=None) -> argparse.Namespace:
    from mx_rcnn_tpu_torch.tools.fleet import _add_model_args

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 binds a free port (reported in the ready "
                        "line)")
    p.add_argument("--replicas", type=int, default=None,
                   help="local replica count (default "
                        "crosshost.agent_replicas)")
    p.add_argument("--store_url", default=None,
                   help="the head's store server to pull the export "
                        "store from (default crosshost.store_url; empty: "
                        "no pull)")
    p.add_argument("--export_dir", default=None,
                   help="the local export store: the pull's target and "
                        "the replicas' join (default fleet.export_dir)")
    p.add_argument("--class_names", default=None)
    p.add_argument("--stub_ms", type=float, default=None,
                   help="replace the model with a sleep of this many ms "
                        "a batch that releases the GIL (the rigs)")
    p.add_argument("--stub", default="plain", choices=["plain", "content"],
                   help="the stand-in of --stub_ms: 'content' scores each "
                        "image by its own pixels (the bulk leg's "
                        "byte-identity needs it)")
    return p.parse_args(argv)


def _variables(cfg, args):
    """The weights' JAX-layout tree: the checkpoint's, else None (the
    agent takes the pulled store's), else random ones from ``--seed``."""
    from mx_rcnn_tpu_torch.serve.export import predictor_variables
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    if args.prefix is None and cfg.fleet.export_dir:
        return None
    return predictor_variables(init_predictor(cfg, args.prefix, args.epoch,
                                              args.seed, args.device))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)

    from mx_rcnn_tpu_torch.obs.runrec import cli_obs
    from mx_rcnn_tpu_torch.serve.agent import ReplicaAgent, make_agent_server
    from mx_rcnn_tpu_torch.serve.fleet import default_devices
    from mx_rcnn_tpu_torch.tools.fleet import _config

    cfg = _config(args)
    if args.replicas:
        cfg = cfg.replace_in("crosshost", agent_replicas=args.replicas)
    if args.store_url is not None:
        cfg = cfg.replace_in("crosshost", store_url=args.store_url)
    if args.export_dir is not None:
        cfg = cfg.replace_in("fleet", export_dir=args.export_dir)
    # the device is resolved (and refused) before anything is pulled
    default_devices(args.device)

    run_fn_factory = None
    if args.stub_ms is not None:
        from mx_rcnn_tpu_torch.tools.loadgen import (make_content_stub_run_fn,
                                                     make_stub_run_fn)

        if args.stub == "content":
            run_fn_factory = (lambda rid:
                              make_content_stub_run_fn(cfg, args.stub_ms))
        else:
            run_fn_factory = (lambda rid:
                              make_stub_run_fn(cfg, args.stub_ms, seed=rid))

    obs_sess = cli_obs(cfg, "agent")
    agent = srv = None
    try:
        variables = None if run_fn_factory else _variables(cfg, args)
        agent = ReplicaAgent(
            cfg, variables, run_fn_factory=run_fn_factory,
            record=obs_sess.record if obs_sess else None,
            class_names=(args.class_names.split(",")
                         if args.class_names else None),
            device=args.device)
        del variables
        srv = make_agent_server(agent, args.host, args.port)
        host, port = srv.server_address[:2]
        h = agent.healthz()
        print(json.dumps({"ready": bool(h.get("ok")), "host": host,
                          "port": port, "replicas": h.get("ready"),
                          "warm_s": h.get("warm_s"),
                          "store_pull": h.get("store_pull"),
                          "kernel_builds_after_warm":
                              h.get("kernel_builds_after_warm")}),
              flush=True)
        logger.info("agent serving on http://%s:%d (%s replicas ready)",
                    host, port, h.get("ready"))
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        if srv is not None:
            srv.server_close()
        if agent is not None:
            agent.close()
        if obs_sess is not None:
            obs_sess.close(metric="agent_warm_s",
                           value=agent.warm_s if agent else None, unit="s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
