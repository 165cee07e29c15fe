"""Load generator for the serving engine: closed or open loop, one JSON
record.

Counterpart of the single-engine part of ``mx_rcnn_tpu/tools/loadgen.py``.
Replays synthetic images against an in-process
:class:`~mx_rcnn_tpu_torch.serve.engine.ServingEngine` (no network in the
measured path; the HTTP front end has its own tests) and prints one JSON
line::

    {"metric": "serve_imgs_per_sec", "value": ..., "measured": true,
     "offline_imgs_per_sec": ..., "ratio_vs_offline": ...,
     "p50_ms"/"p90_ms"/"p99_ms": ..., "shed_rate": ..., "lost": 0, ...}

* ``--mode closed``: ``--concurrency`` workers, each with one request in
  flight (submit, wait, repeat): throughput and latency without
  overload.
* ``--mode open``: requests arrive on a fixed ``--qps`` schedule whatever
  the completions; past capacity, deadlines expire and the watermark
  sheds.  The port resizes on the caller's thread (tens of ms a request
  without cv2), so one submitting thread would cap arrivals at its own
  resize rate and quietly close the loop: the schedule's arrivals are
  dealt round-robin to ``2 * batch_size`` submitting threads, each
  keeping its arrivals' times.

The offline rate is the same forward and postprocess in a plain loop, no
queues or threads, at the same bucket and batch size:
``ratio_vs_offline`` is the serving machinery's cost.  ``--check`` makes
the exit code say: nothing lost, something served, ratio at least
``--min_ratio``.

The record has the JAX package's keys but ``recompiles_after_warmup``
(the port compiles no program, so there is nothing to count), and adds
``preprocess_ms_p50`` (resize and pad of one request on the caller's
thread), ``resize_backend`` (cv2 or numpy) and ``device``.

    python -m mx_rcnn_tpu_torch.tools.loadgen --network resnet101 \\
        --dataset PascalVOC --duration 8                        # card
    python -m mx_rcnn_tpu_torch.tools.loadgen --smoke --device cpu --check
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from typing import List

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import (NETWORKS, Config, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.core.tester import Predictor, quant_predictor
from mx_rcnn_tpu_torch.data.image import RESIZE_BACKEND
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded, RequestFailed,
                                           ShedError)
from mx_rcnn_tpu_torch.utils.checkpoint import load_model, load_state_dict
from mx_rcnn_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mx_rcnn_tpu_torch")


def synthetic_images(cfg: Config, n: int, seed: int = 0
                     ) -> List[np.ndarray]:
    """``n`` random uint8 RGB images alternating between the bucket
    canvases' sizes, so the traffic uses every bucket."""
    rng = np.random.RandomState(seed)
    buckets = [tuple(b) for b in cfg.bucket.shapes]
    return [rng.randint(0, 256, size=buckets[i % len(buckets)] + (3,),
                        dtype=np.uint8)
            for i in range(n)]


def init_predictor(cfg: Config, prefix: str = None, epoch: int = 0,
                   seed: int = 0, device="cuda") -> Predictor:
    """A predictor on ``device`` (CUDA unless the caller asks for the
    CPU) from checkpoint ``prefix``@``epoch``, else from random weights
    made from ``seed``: serving throughput does not depend on them.  With
    ``cfg.quant.enabled`` it is the quantized predictor (a calibration
    sweep over held-out training batches first, ``quant_predictor``), so
    every serving CLI gains the quant mode through one ``--set``."""
    dev = resolve_device(device)
    if cfg.quant.enabled:
        state = (load_state_dict(prefix, epoch) if prefix else build_model(
            cfg.replace_in("quant", enabled=False), "cpu", seed,
            train=True).state_dict())
        return quant_predictor(cfg, state, dev)
    model = (load_model(cfg, prefix, epoch, dev) if prefix
             else build_model(cfg, dev, seed))
    return Predictor(model, cfg, dev)


def offline_rate(engine: ServingEngine, reps: int = 12) -> float:
    """The bar: full batches of forward and postprocess in a plain loop,
    no serving machinery, buckets alternating as the traffic does."""
    b = engine.cfg.serve.batch_size
    batches = [engine._compose(bucket, []) for bucket in engine.buckets]
    engine._run(*batches[0])  # warm before timing
    t0 = time.perf_counter()
    for i in range(reps):
        engine._run(*batches[i % len(batches)])
    return reps * b / (time.perf_counter() - t0)


def _outcome(fn) -> str:
    try:
        fn()
        return "ok"
    except ShedError:
        return "shed"
    except DeadlineExceeded:
        return "expired"
    except (RequestFailed, TimeoutError):
        return "failed"


def run_closed_loop(engine: ServingEngine, images, duration_s: float,
                    concurrency: int, timeout_ms: float) -> dict:
    """``concurrency`` workers, one request in flight each."""
    stop = time.monotonic() + duration_s
    outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
    lock = threading.Lock()

    def worker(wid: int):
        i = wid
        while time.monotonic() < stop:
            img = images[i % len(images)]
            i += concurrency
            key = _outcome(lambda: engine.detect(img, timeout_ms=timeout_ms))
            with lock:
                outcomes[key] += 1

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"wall_s": time.perf_counter() - t0, "client": outcomes}


def run_open_loop(engine: ServingEngine, images, duration_s: float,
                  qps: float, timeout_ms: float) -> dict:
    """Arrival k at ``start + k / qps`` for ``duration_s``, whatever the
    completions; arrivals dealt round-robin to ``2 * batch_size``
    submitting threads (a thread behind its schedule submits at once).
    Every handle is collected, so no outcome is dropped."""
    period = 1.0 / qps
    n = max(int(np.ceil(duration_s * qps)), 1)
    submitters = min(2 * engine.cfg.serve.batch_size, n)
    handles = [None] * n
    start = time.monotonic()

    def submitter(first: int):
        for k in range(first, n, submitters):
            delay = start + k * period - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            handles[k] = engine.submit(images[k % len(images)],
                                       timeout_ms=timeout_ms)

    threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
               for i in range(submitters)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outcomes = {"ok": 0, "shed": 0, "expired": 0, "failed": 0}
    for h in handles:
        outcomes[_outcome(lambda: h.wait(timeout=30.0))] += 1
    return {"wall_s": time.perf_counter() - t0, "client": outcomes,
            "submitted": n}


def make_stub_run_fn(cfg: Config, model_ms: float, seed: int = 0):
    """A stand-in for the device: sleeps ``model_ms`` per batch (the GIL
    released, as a host thread waiting on the card is) and returns
    canned postprocess-shaped outputs, so everything around the model
    (preprocess, queues, batching, demultiplex, accounting) runs for
    real at a rate that does not depend on this machine."""
    n = cfg.serve.batch_size
    r = cfg.test.rpn_post_nms_top_n
    c = cfg.num_classes
    rng = np.random.RandomState(seed)
    boxes = (rng.rand(n, r, 4 * c) * 100.0).astype(np.float32)
    scores = rng.rand(n, r, c).astype(np.float32)
    keep = np.zeros((n, c, r), bool)
    keep[:, 1:, :3] = True  # a few detections per class: real demux work

    def run_fn(images, im_info):
        time.sleep(model_ms / 1000.0)
        return boxes, scores, keep

    return run_fn


def _smoke_overrides() -> dict:
    """The smoke canvas: the tiny network on 128x160 buckets with the
    eval's ROI counts cut, so a run takes seconds on a CPU."""
    return {
        "bucket__scale": 128, "bucket__max_size": 160,
        "bucket__shapes": ((128, 160), (160, 128)),
        "test__rpn_pre_nms_top_n": 512, "test__rpn_post_nms_top_n": 64,
        "serve__batch_size": 2, "serve__max_delay_ms": 20.0,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="tiny", choices=NETWORKS)
    p.add_argument("--dataset", default="synthetic",
                   choices=["PascalVOC", "coco", "synthetic",
                            "synthetic_hard"])
    p.add_argument("--prefix", default=None,
                   help="checkpoint prefix (default: random weights)")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mode", default="closed", choices=["closed", "open"])
    p.add_argument("--duration", type=float, default=20.0,
                   help="measurement window, seconds")
    p.add_argument("--concurrency", type=int, default=None,
                   help="closed-loop workers (default 2 x batch_size)")
    p.add_argument("--qps", type=float, default=20.0,
                   help="open-loop arrival rate")
    p.add_argument("--timeout_ms", type=float, default=None,
                   help="per-request deadline (default "
                        "serve.default_timeout_ms)")
    p.add_argument("--images", type=int, default=16,
                   help="distinct synthetic images to cycle through")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="also write the JSON record to this path")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless nothing is lost, something is "
                        "served and ratio_vs_offline >= --min_ratio")
    p.add_argument("--min_ratio", type=float, default=0.5)
    p.add_argument("--smoke", action="store_true",
                   help="tiny network on 128x160 buckets, at most 12 s")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    overrides = {}
    if args.smoke:
        overrides.update(_smoke_overrides())
        args.duration = min(args.duration, 12.0)
    overrides.update(parse_set_overrides(args.set))
    cfg = generate_config(args.network, args.dataset, **overrides)
    concurrency = args.concurrency or 2 * cfg.serve.batch_size
    timeout_ms = (cfg.serve.default_timeout_ms if args.timeout_ms is None
                  else args.timeout_ms)

    predictor = init_predictor(cfg, args.prefix, args.epoch, args.seed,
                               args.device)
    images = synthetic_images(cfg, args.images, args.seed)
    engine = ServingEngine(predictor, cfg)
    t0 = time.perf_counter()
    engine.warmup()
    logger.info("warmup: %d bucket(s) at batch %d in %.1f s",
                len(engine.buckets), cfg.serve.batch_size,
                time.perf_counter() - t0)
    off = offline_rate(engine)
    logger.info("offline: %.2f imgs/s at batch %d", off,
                cfg.serve.batch_size)

    engine.metrics.reset()   # the measured window excludes the warm-up
    logger.info("load: mode=%s duration=%.0fs %s", args.mode, args.duration,
                f"concurrency={concurrency}" if args.mode == "closed"
                else f"qps={args.qps}")
    if args.mode == "closed":
        run = run_closed_loop(engine, images, args.duration, concurrency,
                              timeout_ms)
    else:
        run = run_open_loop(engine, images, args.duration, args.qps,
                            timeout_ms)
    # drain: every submitted request must reach a terminal state
    deadline = time.monotonic() + 30.0
    while (engine.metrics.snapshot()["in_flight"] > 0
           and time.monotonic() < deadline):
        time.sleep(0.05)
    snap = engine.metrics.snapshot()
    pre = engine.metrics.summary("preprocess_ms")
    engine.close()

    c = snap["counters"]
    lost = c["submitted"] - snap["terminated"]
    served_rate = c["served"] / run["wall_s"]
    dev = predictor.device
    rec = {
        "metric": "serve_imgs_per_sec",
        "value": round(served_rate, 2),
        "unit": "imgs/s",
        "measured": True,
        "mode": args.mode,
        "network": args.network,
        "bucket_shapes": [list(b) for b in cfg.bucket.shapes],
        "batch_size": cfg.serve.batch_size,
        "max_delay_ms": cfg.serve.max_delay_ms,
        "duration_s": round(run["wall_s"], 2),
        "concurrency": concurrency if args.mode == "closed" else None,
        "qps_target": args.qps if args.mode == "open" else None,
        "fleet_replicas": None,
        "offline_imgs_per_sec": round(off, 2),
        "ratio_vs_offline": round(served_rate / off, 3),
        "p50_ms": snap["total_ms"]["p50"],
        "p90_ms": snap["total_ms"]["p90"],
        "p99_ms": snap["total_ms"]["p99"],
        "queue_wait_p99_ms": snap["queue_wait_ms"]["p99"],
        "model_ms_p50": snap["model_ms"]["p50"],
        "batch_occupancy_mean": snap["batch_occupancy"]["mean_rows"],
        "served": c["served"], "shed": c["shed"],
        "expired": c["expired"], "failed": c["failed"],
        "submitted": c["submitted"],
        "shed_rate": round(c["shed"] / max(c["submitted"], 1), 4),
        "expired_rate": round(c["expired"] / max(c["submitted"], 1), 4),
        "lost": lost,
        "client_outcomes": run["client"],
        "preprocess_ms_p50": pre["p50"],
        "resize_backend": RESIZE_BACKEND,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if args.check:
        problems = []
        if lost != 0:
            problems.append(f"{lost} requests lost (no terminal state)")
        if rec["ratio_vs_offline"] < args.min_ratio:
            problems.append(f"serving/offline ratio "
                            f"{rec['ratio_vs_offline']} < {args.min_ratio}")
        if c["served"] == 0:
            problems.append("zero requests served")
        for msg in problems:
            logger.error("CHECK FAILED: %s", msg)
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
