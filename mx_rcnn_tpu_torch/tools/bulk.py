"""Bulk scoring CLI: a corpus through an export-warmed serving fleet into
a sharded sink, every image accounted exactly once.

Counterpart of ``mx_rcnn_tpu/tools/bulk.py``.  ``--protocol single``
scores a ``data/loader.py — StreamTestLoader`` corpus through a
``serve/fleet.py`` fleet joined from an export store (``serve/bulk.py —
BulkRunner`` into a ``BulkSink``) and prints one JSON record whose
``--check`` invariants are:

* **N in = N accounted**: every planned image reaches the sink once
  (``lost == 0``; an image that cannot be served aborts the run);
* **0 kernel builds after the join**: the whole corpus runs on the
  libraries the replicas installed from the store (the port's stand-in
  for the JAX "0 recompiles");
* **bounded RSS**: the peak stays under ``data.ram_ceiling_mb``;
* **rate floor**: images/s at least ``--min_ratio_vs_serve`` times the
  closed-loop serve baseline (the same fleet, clients that load each
  image and ``detect`` it, each writing its lines to a file of its own).

``--protocol kill_resume``: a control run, a run SIGKILLed after its
middle shard commits (``--fault kill@shard=K``) and the resume of that
sink, each a process of its own; the killed and resumed shards must be
byte-identical to the control's.

    python -m mx_rcnn_tpu_torch.tools.bulk --smoke --device cpu --check
    python -m mx_rcnn_tpu_torch.tools.bulk --network resnet101 \\
        --dataset coco --prefix model/e2e --epoch 1 --protocol kill_resume \\
        --replicas 2 --check                                     # card
"""

from __future__ import annotations

# the lock sanitizer first: the locks the package allocates at import
# are born wrapped only if it is armed before
from mx_rcnn_tpu_torch.analysis import sanitizer  # isort: skip

sanitizer.maybe_install_from_env()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from typing import List  # noqa: E402

import numpy as np  # noqa: E402

from mx_rcnn_tpu_torch.config import (NETWORKS,  # noqa: E402
                                      generate_config, parse_set_overrides)

logger = logging.getLogger("mx_rcnn_tpu_torch")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def parse_fault(spec: str):
    """``kill@shard=K``: a hook that SIGKILLs this process right after
    shard K commits."""
    if not spec:
        return None
    if not spec.startswith("kill@shard="):
        raise ValueError(f"unknown fault spec {spec!r} "
                         "(expected kill@shard=K)")
    k = int(spec.split("=", 1)[1])

    def fault(shard: int) -> None:
        if shard == k:
            logger.warning("FAULT: SIGKILL after shard %d commit", shard)
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    return fault


def _model_ident(args) -> str:
    """The weights' identity in the sink manifest: the checkpoint file's
    sha256 (a retrain to the same path is other weights), or the seed of
    random ones."""
    if args.prefix:
        from mx_rcnn_tpu_torch.utils.checkpoint import checkpoint_path

        path = checkpoint_path(args.prefix, args.epoch)
        return f"sha256:{_sha256_file(path)[:16]}@{args.epoch}"
    return f"random-init@seed={args.seed}"


def _corpus(cfg, args):
    """(imdb, roidb) of the scoring corpus: the dataset's train set read
    as an eval set (no flips, no gt filter: unannotated images are
    scored too), its first ``--num_images`` images."""
    from mx_rcnn_tpu_torch.data import _GENERATED, load_gt_roidb

    kw = ({"num_images": args.num_images}
          if cfg.dataset.name in _GENERATED else {})
    imdb, roidb = load_gt_roidb(cfg, image_set=cfg.dataset.image_set,
                                training=False, **kw)
    return imdb, roidb[:args.num_images]


def _serve_baseline(router, imdb, roidb, duration_s: float, concurrency: int,
                    out_dir: str) -> dict:
    """The closed-loop serve baseline: each client loads a corpus image
    (``imdb.load_image``, the decode for a file set), ``detect``\\ s it
    raw and appends its line to a file of its own, images drawn in a
    seeded permutation of the corpus."""
    from mx_rcnn_tpu_torch.serve.bulk import detections_line
    from mx_rcnn_tpu_torch.tools.loadgen import _outcome

    os.makedirs(out_dir, exist_ok=True)
    order = np.random.RandomState(0).permutation(len(roidb))
    stop = time.monotonic() + duration_s
    outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
    lock = threading.Lock()

    def worker(wid: int):
        i = wid
        with open(os.path.join(out_dir, f"client{wid}.jsonl"), "w") as f:
            while time.monotonic() < stop:
                ci = int(order[i % len(order)])
                img = imdb.load_image(roidb[ci])
                got = {}

                def one():
                    got["dets"] = router.detect(img, timeout_ms=60_000.0)

                key = _outcome(one)
                if key == "ok":
                    f.write(detections_line(ci, got["dets"]) + "\n")
                i += concurrency
                with lock:
                    outcomes[key] += 1

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return {"imgs_per_sec": round(outcomes["ok"] / max(wall, 1e-9), 2),
            "duration_s": round(wall, 2), "client": outcomes,
            "concurrency": concurrency}


def _ensure_store(cfg, args, store_root: str) -> None:
    """Export the serving programs to ``store_root`` unless it holds a
    store."""
    from mx_rcnn_tpu_torch.serve.export import export_serve_programs
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    if os.path.exists(os.path.join(store_root, "manifest.json")):
        return
    logger.info("[bulk] exporting serving programs -> %s", store_root)
    predictor = init_predictor(cfg, args.prefix, args.epoch, args.seed,
                               args.device)
    export_serve_programs(predictor, cfg, store_root)


def run_single(args, cfg) -> int:
    """One bulk pass (fresh or resuming) in this process: prints the
    record and returns the ``--check`` exit code."""
    from mx_rcnn_tpu_torch.data.loader import StreamTestLoader
    from mx_rcnn_tpu_torch.obs.metrics import registry
    from mx_rcnn_tpu_torch.obs.runrec import cli_obs
    from mx_rcnn_tpu_torch.serve.bulk import (BulkRunner, BulkSink,
                                              auto_inflight,
                                              make_sink_manifest)
    from mx_rcnn_tpu_torch.serve.export import predictor_variables
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet, default_devices
    from mx_rcnn_tpu_torch.tools.data_bench import _peak_rss_mb
    from mx_rcnn_tpu_torch.tools.loadgen import (KernelBuildCounter,
                                                 init_predictor)

    # the device is resolved (and refused) before anything is read
    default_devices(args.device)
    imdb, roidb = _corpus(cfg, args)
    store_root = args.export_dir or os.path.join(args.workdir, "store")
    _ensure_store(cfg, args, store_root)
    # every replica builds from these weights; its join holds them to the
    # store's digests
    variables = predictor_variables(init_predictor(
        cfg, args.prefix, args.epoch, args.seed, args.device))

    obs_sess = cli_obs(cfg, "bulk")
    record = obs_sess.record if obs_sess else None
    logger.info("[bulk] launching %d export-warmed replica(s) ...",
                cfg.fleet.replicas)
    router = build_fleet(cfg, variables, export_root=store_root,
                         record=record, device=args.device)
    del variables
    rec = {
        "metric": "bulk_imgs_per_sec",
        "unit": "imgs/s",
        "measured": True,
        "network": args.network,
        "dataset": args.dataset,
        "corpus_images": len(roidb),
        "replicas": cfg.fleet.replicas,
        "batch_images": args.batch_images,
        "serve_batch_size": cfg.serve.batch_size,
        "max_inflight": auto_inflight(cfg),
        "shard_batches": cfg.bulk.shard_batches,
        "quant": (f"{cfg.quant.dtype}/{cfg.quant.mode}"
                  if cfg.quant.enabled else None),
        "smoke": bool(args.smoke),
        "host": {"physical_cores": os.cpu_count()},
        "device": args.device,
        "package": os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
    }
    problems: List[str] = []
    try:
        ready = router.healthz()["ready"]
        rec["replicas_ready"] = ready
        rec["joins"] = [r.joins[-1] for r in router.manager.replicas
                        if r.joins]
        rec["join_kernel_builds"] = sum(
            j["load_events_after"]["builds"]
            - j["load_events_before"]["builds"] for j in rec["joins"])
        if ready < cfg.fleet.replicas:
            problems.append(f"only {ready}/{cfg.fleet.replicas} replicas "
                            "joined")
        if not args.skip_baseline:
            logger.info("[bulk] closed-loop serve baseline ...")
            rec["serve_baseline"] = _serve_baseline(
                router, imdb, roidb, args.baseline_s,
                concurrency=2 * cfg.serve.batch_size * cfg.fleet.replicas,
                out_dir=os.path.join(args.workdir, "baseline_out"))
            router.metrics.reset()

        loader = StreamTestLoader(roidb, cfg, imdb.load_image,
                                  batch_images=args.batch_images,
                                  shuffle=False, seed=args.seed,
                                  raw_images=False)
        sink = BulkSink(args.out_dir,
                        make_sink_manifest(cfg, roidb, args.seed,
                                           args.batch_images,
                                           model=_model_ident(args)))
        runner = BulkRunner(router, loader, sink, cfg, registry=registry(),
                            fault=parse_fault(args.fault), record=record)
        logger.info("[bulk] scoring %d images -> %s (resume cursor: %d "
                    "shard(s))", len(roidb), args.out_dir,
                    sink.committed_shards())
        with KernelBuildCounter() as kb:
            stats = runner.run()
        rec["bulk"] = stats
        # rows below batch_size mean the lanes ran dry
        rec["batch_occupancy_mean"] = [
            r.engine.metrics.snapshot()["batch_occupancy"]["mean_rows"]
            for r in router.manager.replicas if r.engine is not None]
        rec["value"] = stats["imgs_per_sec"]
        rec["kernel_builds_after_join"] = kb.n
        rec["peak_rss_mb"] = round(_peak_rss_mb(), 1)
        rec["ram_ceiling_mb"] = cfg.data.ram_ceiling_mb
        checks = {
            "n_in_equals_n_accounted": (stats["accounted_images"]
                                        == stats["planned_images"]),
            "zero_lost": stats["lost"] == 0,
            "zero_kernel_builds_after_join": kb.n == 0,
        }
        if cfg.data.ram_ceiling_mb > 0:
            checks["rss_under_ceiling"] = (rec["peak_rss_mb"]
                                           <= cfg.data.ram_ceiling_mb)
        if "serve_baseline" in rec and stats["scored_images"]:
            base = rec["serve_baseline"]["imgs_per_sec"]
            rec["ratio_vs_serve_baseline"] = (
                round(stats["imgs_per_sec"] / base, 3) if base else None)
            checks["rate_vs_serve_baseline"] = (
                base == 0 or stats["imgs_per_sec"]
                >= args.min_ratio_vs_serve * base)
        rec["checks"] = checks
        problems += [k for k, v in checks.items() if not v]
    finally:
        router.close()
        if obs_sess is not None:
            obs_sess.close(metric=rec["metric"], value=rec.get("value"),
                           unit=rec.get("unit"), checks=rec.get("checks"))

    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    problems += sanitizer.check_problems()
    if args.check and problems:
        for p in problems:
            logger.error("CHECK FAILED: %s", p)
        return 1
    if args.check:
        logger.info("CHECK OK: %s", ", ".join(rec.get("checks", {})))
    return 0


def _child_cmd(args, out_dir: str, store: str, fault: str = None,
               baseline: bool = False) -> List[str]:
    cmd = [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.bulk",
           "--protocol", "single", "--network", args.network,
           "--dataset", args.dataset, "--root_path", args.root_path,
           "--num_images", str(args.num_images),
           "--batch_images", str(args.batch_images),
           "--replicas", str(args.replicas),
           "--seed", str(args.seed), "--device", args.device,
           "--out_dir", out_dir, "--export_dir", store,
           "--workdir", args.workdir,
           "--baseline_s", str(args.baseline_s),
           "--min_ratio_vs_serve", str(args.min_ratio_vs_serve),
           "--check"]
    if args.dataset_path:
        cmd += ["--dataset_path", args.dataset_path]
    if args.prefix:
        cmd += ["--prefix", args.prefix, "--epoch", str(args.epoch)]
    if not baseline:
        cmd += ["--skip_baseline"]
    if fault:
        cmd += ["--fault", fault]
    for s in args.set or []:
        cmd += ["--set", s]
    return cmd


def _run_child(cmd, timeout_s: float = 3600.0):
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout_s)
    record = None
    for ln in out.stdout.strip().splitlines():
        if ln.startswith("{"):
            record = json.loads(ln)
    return out.returncode, record, out


def run_kill_resume(args, cfg) -> int:
    """Control, a run killed after its middle shard, its resume, then the
    byte comparison; each run a real process (a SIGKILL must be real),
    over one corpus and one export store made here first."""
    from mx_rcnn_tpu_torch.data.loader import StreamTestLoader
    from mx_rcnn_tpu_torch.obs.runrec import cli_obs
    from mx_rcnn_tpu_torch.serve.bulk import BulkSink
    from mx_rcnn_tpu_torch.serve.fleet import default_devices

    default_devices(args.device)
    obs_sess = cli_obs(cfg, "bulk_kill_resume")

    def _phase(name: str, **kw) -> None:
        if obs_sess is not None:
            obs_sess.record.event("bulk_protocol_phase", phase=name, **kw)

    # the corpus files and the store, once, so that the children race on
    # neither
    imdb, roidb = _corpus(cfg, args)
    store = args.export_dir or os.path.join(args.workdir, "store")
    _ensure_store(cfg, args, store)
    # the plan's geometry (each bucket has its own tail batch)
    plan = StreamTestLoader(roidb, cfg, imdb.load_image,
                            batch_images=args.batch_images, shuffle=False,
                            seed=args.seed, num_workers=0)._plan(
        0, args.batch_images)
    n_shards = math.ceil(len(plan) / max(cfg.bulk.shard_batches, 1))
    kill_shard = max(n_shards // 2 - 1, 0)
    ctrl_dir = os.path.join(args.workdir, "sink_control")
    kill_dir = args.out_dir or os.path.join(args.workdir, "sink_kill")

    rec = {"metric": "bulk_kill_resume", "measured": True,
           "corpus_images": len(roidb), "shards": n_shards,
           "kill_after_shard": kill_shard, "smoke": bool(args.smoke),
           "device": args.device}
    problems: List[str] = []

    def tail(out) -> None:
        print(out.stdout[-4000:], file=sys.stderr)
        print(out.stderr[-4000:], file=sys.stderr)

    logger.info("[bulk] CONTROL run (uninterrupted, with the serve "
                "baseline) -> %s", ctrl_dir)
    _phase("control", out_dir=ctrl_dir)
    rc, ctrl, out = _run_child(_child_cmd(args, ctrl_dir, store,
                                          baseline=True))
    rec["control"] = ctrl
    if rc != 0 or ctrl is None:
        problems.append(f"control run failed rc={rc}")
        tail(out)

    logger.info("[bulk] KILL run (SIGKILL after shard %d) -> %s",
                kill_shard, kill_dir)
    _phase("kill", out_dir=kill_dir, kill_after_shard=kill_shard)
    rc, _, out = _run_child(_child_cmd(
        args, kill_dir, store, fault=f"kill@shard={kill_shard}"))
    killed_by_signal = rc in (-signal.SIGKILL, 128 + signal.SIGKILL)
    try:
        committed_at_kill = BulkSink(kill_dir).committed_shards()
    except ValueError:
        # it died before the sink's manifest: a start-up failure
        committed_at_kill = 0
        tail(out)
    rec["kill"] = {"rc": rc, "killed_by_signal": killed_by_signal,
                   "committed_shards": committed_at_kill}
    if not killed_by_signal:
        problems.append(f"kill run exited rc={rc}, not by SIGKILL")
    if not 0 < committed_at_kill < n_shards:
        problems.append(f"kill left {committed_at_kill}/{n_shards} "
                        "shards: not a mid-corpus kill")

    logger.info("[bulk] RESUME run (same sink) ...")
    _phase("resume", out_dir=kill_dir, committed_at_kill=committed_at_kill)
    rc, resume, out = _run_child(_child_cmd(args, kill_dir, store))
    rec["resume"] = resume
    if rc != 0 or resume is None:
        problems.append(f"resume run failed rc={rc}")
        tail(out)
    elif resume["bulk"]["resumed_shards"] != committed_at_kill:
        problems.append("the resume did not start at the killed run's "
                        "cursor")

    # every shard of the killed and resumed sink equals the control's:
    # the union shows no seam
    sink_c, sink_k = BulkSink(ctrl_dir), BulkSink(kill_dir)
    nc, nk = sink_c.committed_shards(), sink_k.committed_shards()
    identical = nc == nk == n_shards and all(
        _sha256_file(sink_c.shard_path(k))
        == _sha256_file(sink_k.shard_path(k)) for k in range(nc))
    rec["union_bit_identical"] = identical
    if not identical:
        problems.append(f"killed+resumed union differs from control "
                        f"({nk} vs {nc} shards of {n_shards})")
    checks = {
        "control_check_ok": bool(ctrl and ctrl.get("checks")
                                 and all(ctrl["checks"].values())),
        "killed_mid_corpus": killed_by_signal
        and 0 < committed_at_kill < n_shards,
        "resume_check_ok": bool(resume and resume.get("checks")
                                and all(resume["checks"].values())),
        "union_bit_identical": identical,
    }
    rec["checks"] = checks
    if ctrl:
        rec["value"] = ctrl.get("value")
        rec["unit"] = "imgs/s"
    problems += [k for k, v in checks.items() if not v]
    if obs_sess is not None:
        obs_sess.close(metric=rec["metric"], value=rec.get("value"),
                       unit=rec.get("unit"), checks=checks)

    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if args.check and problems:
        for p in problems:
            logger.error("CHECK FAILED: %s", p)
        return 1
    if args.check:
        logger.info("CHECK OK: %s", ", ".join(checks))
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="tiny", choices=NETWORKS)
    p.add_argument("--dataset", default="synthetic_stream",
                   choices=["PascalVOC", "coco", "synthetic",
                            "synthetic_hard", "synthetic_stream"])
    p.add_argument("--root_path", default="data")
    p.add_argument("--dataset_path", default=None)
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix (default: random weights from "
                        "--seed, the same in every process)")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--num_images", type=int, default=10_000)
    p.add_argument("--batch_images", type=int, default=0,
                   help="loader batch rows (0 = serve.batch_size)")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--export_dir", default=None,
                   help="an export store (default: one made under "
                        "--workdir)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--out_dir", default=None, help="the result sink")
    p.add_argument("--protocol", default="single",
                   choices=["single", "kill_resume"])
    p.add_argument("--fault", default=None,
                   help="kill@shard=K: SIGKILL after shard K commits")
    p.add_argument("--baseline_s", type=float, default=10.0,
                   help="the closed-loop serve baseline's window")
    p.add_argument("--skip_baseline", action="store_true")
    p.add_argument("--min_ratio_vs_serve", type=float, default=1.0,
                   help="--check floor of bulk over the serve baseline's "
                        "rate (the smoke's is 0.4)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true",
                   help="the smoke canvas, a 48-image corpus, 2 replicas, "
                        "the kill_resume protocol")
    p.add_argument("--check", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    overrides = {}
    if args.smoke:
        from mx_rcnn_tpu_torch.tools.loadgen import _smoke_overrides

        overrides.update(_smoke_overrides())
        overrides.update({"bulk__shard_batches": 4,
                          "data__ram_ceiling_mb": 3072})
        args.dataset = "synthetic"
        args.num_images = min(args.num_images, 48)
        args.baseline_s = min(args.baseline_s, 5.0)
        if args.min_ratio_vs_serve == 1.0:
            args.min_ratio_vs_serve = 0.4
        if args.protocol == "single" and not args.fault \
                and not args.out_dir:
            args.protocol = "kill_resume"
    overrides.update(parse_set_overrides(args.set))
    overrides.setdefault("fleet__replicas", args.replicas)
    overrides.setdefault("data__streaming", True)
    if args.dataset_path:
        overrides["dataset__dataset_path"] = args.dataset_path
    cfg = generate_config(args.network, args.dataset,
                          dataset__root_path=args.root_path, **overrides)
    if args.batch_images <= 0:
        args.batch_images = cfg.serve.batch_size
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="bulk_")
    os.makedirs(args.workdir, exist_ok=True)
    if args.protocol == "kill_resume":
        # the children rebuild the config from flags alone: they get the
        # merged overrides, the smoke's included
        args.set = [f"{k}={v!r}" for k, v in overrides.items()]
        return run_kill_resume(args, cfg)
    if args.out_dir is None:
        args.out_dir = os.path.join(args.workdir, "sink")
    return run_single(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
