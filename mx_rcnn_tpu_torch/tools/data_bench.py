"""Dataset-scale input-plane benchmark: an epoch of a generated set
through the real input path, with ``--check`` invariants.

Counterpart of ``mx_rcnn_tpu/tools/data_bench.py``.  It drives
``synthetic_stream`` (10,000 images and 80 classes by default, written
once as PNG files, ``data/synthetic.py``) through the port's input path
and prints one JSON record:

* **shard rig**: ``--num_shards`` worker processes (``--worker``), each
  owning one row shard of the streaming plan, consume one epoch; the union
  of their decoded (image, flipped) identities must be the epoch exactly
  once, and each must decode about 1/N of it;
* **streaming epoch**: ``StreamLoader`` → the bounded decoded-image cache
  (its budget under ``data.ram_ceiling_mb``, ``stream_cache_budget``) →
  ``DeviceStager`` → a consumer on ``--device`` that reads every staged
  byte; it must see each image exactly once, build no kernel and write
  nothing new under ``_build/`` in the timed pass (the JAX tool's "zero
  lowerings"), add no more to the peak RSS than the ceiling leaves above
  the process floor (``ram_ceiling_mb`` less ``loader.py``'s 1 GiB for
  the interpreter and torch: the JAX tool holds the whole peak to the
  ceiling, but a CUDA build of torch maps several GiB before any data,
  4.6 GiB on the H100 machine), and find staged
  batches waiting (stager hits) when the consumer takes a device step's
  time (``--step_ms``, simulated; 10 ms under ``--smoke``); it reports
  images/s and a per-stage table (the loader threads' assembly ms per
  batch, the consumer's waits, the stager's hits and misses);
* **eval leg**: the test split through ``TestLoader``;
* **control**: ``train_net`` of the tiny network on 64 synthetic images
  with streaming and staging on ``--device``; the median step's
  data-wait share must be near 0.

Where the JAX tool reads the process-wide obs registry (``loader.*`` and
``train.*`` metrics, which the port does not have yet), this one reads
the ``DeviceStager``'s own ``hits``/``misses``, times the loader's batch
assembly itself, and parses ``fit``'s own data-wait share from its
Speedometer lines (one step a line).

    python -m mx_rcnn_tpu_torch.tools.data_bench --smoke --check \\
        --device cpu --root_path /tmp/db
    python -m mx_rcnn_tpu_torch.tools.data_bench --root_path data --check
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

from mx_rcnn_tpu_torch.data.loader import _PROCESS_FLOOR_BYTES

_PKG_PARENT = str(Path(__file__).resolve().parents[2])


def _peak_rss_mb() -> float:
    """This process's peak resident set in MiB (``getrusage``'s
    ``ru_maxrss``, KiB on Linux; ``/proc/self/status`` has no ``VmHWM``
    on every system)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _build(args, shard=None):
    """(cfg, roidb, loader, pool) of the train split's streaming epoch 0;
    the caller closes ``pool`` (None unless ``--decode_procs``)."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import (StreamLoader,
                                               cache_from_config,
                                               decode_pool_from_config)

    cfg = generate_config(
        args.network, args.dataset, dataset__root_path=args.root_path,
        dataset__dataset_path=args.dataset_path,
        train__flip=False,  # the epoch is the unique images, exactly
        data__ram_ceiling_mb=args.ram_ceiling_mb, data__streaming=True,
        default__num_workers=args.num_workers,
        default__decode_procs=args.decode_procs)
    imdb, roidb = load_gt_roidb(cfg, training=True,
                                num_images=args.num_images)
    bh, bw = cfg.bucket.shapes[0]
    sizes = dict(n_images=len(roidb), image_bytes=bh * bw * 3,
                 batch_bytes=args.batch_images * bh * bw * 3)
    pool = decode_pool_from_config(cfg, **sizes)
    loader = StreamLoader(roidb, cfg, imdb.load_image,
                          batch_images=args.batch_images, shuffle=True,
                          seed=args.seed, decode_pool=pool,
                          cache=None if pool else cache_from_config(
                              cfg, **sizes),
                          shard=shard)
    loader.record_decodes()
    loader.set_epoch(0)
    return cfg, roidb, loader, pool


def run_worker(args) -> int:
    """One shard of the rig: an epoch of shard ``--shard_id`` of
    ``--num_shards``, its decoded identities and numbers to ``--ids_out``."""
    _, _, loader, pool = _build(args, shard=(args.shard_id, args.num_shards))
    try:
        t0 = time.perf_counter()
        batches = sum(1 for _ in loader)
        wall = time.perf_counter() - t0
    finally:
        if pool is not None:
            pool.close()
    with open(args.ids_out, "w") as f:
        json.dump({"shard_id": args.shard_id, "num_shards": args.num_shards,
                   "images_decoded": loader.images_decoded,
                   "batches": batches, "wall_s": wall,
                   "peak_rss_mb": _peak_rss_mb(),
                   "ids": sorted(loader.decoded_ids)}, f)
    return 0


def _common_argv(args) -> List[str]:
    return ["--dataset", args.dataset, "--network", args.network,
            "--root_path", args.root_path,
            "--dataset_path", args.dataset_path,
            "--num_images", str(args.num_images),
            "--batch_images", str(args.batch_images),
            "--num_workers", str(args.num_workers),
            "--ram_ceiling_mb", str(args.ram_ceiling_mb),
            "--seed", str(args.seed)]


def run_shard_rig(args, expected) -> dict:
    """``--num_shards`` worker processes, one shard each, started
    together."""
    tmp = tempfile.mkdtemp(prefix="data_bench_rig_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_PKG_PARENT, os.environ.get("PYTHONPATH")) if p))
    outs, procs = [], []
    for s in range(args.num_shards):
        outs.append(os.path.join(tmp, f"shard{s}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.data_bench",
             "--worker", "--shard_id", str(s),
             "--num_shards", str(args.num_shards), "--ids_out", outs[-1],
             *_common_argv(args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        logs = [p.communicate()[0] for p in procs]
        for p, log in zip(procs, logs):
            if p.returncode:
                raise RuntimeError(f"shard worker failed (exit "
                                   f"{p.returncode}):\n{log[-2000:]}")
        workers = []
        for o in outs:
            with open(o) as f:
                workers.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    counts = [w["images_decoded"] for w in workers]
    total = sum(counts)
    wall = max(w["wall_s"] for w in workers)
    union = sorted(tuple(i) for w in workers for i in w["ids"])
    return {"processes": args.num_shards, "per_process_decoded": counts,
            "total_decoded": total, "expected_images": len(expected),
            "union_exactly_once": union == expected,
            "per_process_share": [c / max(total, 1) for c in counts],
            "wall_s": wall, "aggregate_imgs_per_sec": total / wall,
            "per_process_peak_rss_mb": [w["peak_rss_mb"] for w in workers]}


def _expected_epoch_ids(args):
    """Every (index, flipped=False) that epoch 0's full batches cover."""
    _, roidb, loader, pool = _build(args)
    if pool is not None:
        pool.close()
    return sorted((int(roidb[i]["index"]), False)
                  for _, idx in loader._plan(0, args.batch_images)
                  for i in idx)


def _build_state():
    """What the timed pass may not change: which kernels are loaded, each
    kernel's launches, and the files under ``_build/``."""
    from mx_rcnn_tpu_torch import kernels

    files = (sorted(os.listdir(kernels.BUILD_DIR))
             if kernels.BUILD_DIR.is_dir() else [])
    return ([k._fn is not None for k in kernels.KERNELS],
            kernels.launch_counts(), files)


def run_stream_epoch(args, expected) -> dict:
    """One epoch through the cache, the stager and a device consumer."""
    import torch

    from mx_rcnn_tpu_torch.data.staging import DeviceStager
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg, roidb, loader, pool = _build(args)
    assemble_ms: List[float] = []
    make = loader.make_batch

    def timed_make(indices, bucket):
        t0 = time.perf_counter()
        batch = make(indices, bucket)
        assemble_ms.append((time.perf_counter() - t0) * 1e3)
        return batch

    loader.make_batch = timed_make

    def consume(images, gt_boxes, acc):
        # reads every staged byte on the device, in place of a train step
        return acc + images.sum(dtype=torch.int64) + gt_boxes.sum().long()

    bh, bw = cfg.bucket.shapes[0]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    consume(torch.zeros((args.batch_images, bh, bw, 3), dtype=torch.uint8,
                        device=device),
            torch.zeros((args.batch_images, cfg.train.max_gt_boxes, 4),
                        device=device), zero)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = _build_state()
    rss_before = _peak_rss_mb()
    stager = DeviceStager(loader, device, depth=cfg.data.stage_depth)
    acc, n_img, waits = zero, 0, []
    t0 = time.perf_counter()
    try:
        it = iter(stager)
        while True:
            tw = time.perf_counter()
            batch = next(it, None)
            waits.append((time.perf_counter() - tw) * 1e3)
            if batch is None:
                break
            acc = consume(batch.images, batch.gt_boxes, acc)
            if args.step_ms:
                time.sleep(args.step_ms / 1e3)  # a simulated device step
            n_img += batch.images.shape[0]
        if n_img == 0:
            raise SystemExit(
                f"the streaming epoch yielded no batch: --num_images "
                f"{args.num_images} is below --batch_images "
                f"{args.batch_images} per bucket")
        checksum = int(acc)  # waits for the device
    finally:
        stager.close()
        if pool is not None:
            pool.close()
    wall = time.perf_counter() - t0
    cache = loader.cache
    return {
        "device": str(device),
        "images": n_img, "roidb_images": len(roidb), "wall_s": wall,
        "imgs_per_sec": n_img / wall,
        "exactly_once": sorted(loader.decoded_ids) == expected,
        "built_in_timed_pass": _build_state() != before,
        "peak_rss_mb": _peak_rss_mb(),
        "peak_rss_before_mb": rss_before,
        "ram_ceiling_mb": args.ram_ceiling_mb,
        "cache": (None if cache is None else
                  {"hits": cache.hits, "misses": cache.misses,
                   "ram_budget_mb": cache.ram_bytes >> 20}),
        "stage": {
            "hits": stager.hits, "misses": stager.misses,
            "hit_rate": stager.hits / max(stager.hits + stager.misses, 1),
            "consumer_wait_ms_total": sum(waits),
            "consumer_wait_ms_p50": statistics.median(waits),
            "assemble_ms_per_batch_p50": statistics.median(assemble_ms),
        },
        "simulated_step_ms": args.step_ms,
        "consumer_checksum": checksum,
    }


def run_eval_leg(args) -> dict:
    """The test split through ``TestLoader``, the input half of
    ``pred_eval``."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import TestLoader

    cfg = generate_config(args.network, args.dataset,
                          dataset__root_path=args.root_path,
                          dataset__dataset_path=args.dataset_path)
    imdb, roidb = load_gt_roidb(cfg, training=False,
                                num_images=args.test_images)
    loader = TestLoader(roidb, cfg, imdb.load_image,
                        batch_images=args.batch_images,
                        num_workers=args.num_workers)
    t0 = time.perf_counter()
    n = sum(b.images.shape[0] for b, _, _ in loader)
    wall = time.perf_counter() - t0
    return {"images": n, "expected": len(roidb), "wall_s": wall,
            "imgs_per_sec": n / wall, "decoded": loader.images_decoded}


def run_control(args) -> dict:
    """``train_net`` of the tiny network on the device with streaming and
    staging: each step's data-wait share, from ``fit``'s Speedometer
    lines at one step a line (each epoch's first step, which waits for
    the loader to start, left out)."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.tools.train import train_net

    cfg = generate_config(
        "tiny", "synthetic", dataset__root_path=args.root_path,
        train__flip=False,
        train__rpn_pre_nms_top_n=256, train__rpn_post_nms_top_n=64,
        train__max_gt_boxes=8, bucket__scale=128, bucket__max_size=160,
        bucket__shapes=((128, 160), (160, 128)), train__batch_images=2,
        data__streaming=True, data__staging=True)
    lines: List[str] = []
    train_net(cfg, end_epoch=args.control_epochs, frequent=1, seed=0,
              device=args.device, log=lines.append,
              dataset_kw={"num_images": args.control_images,
                          "image_size": (128, 160), "max_objects": 3})
    fracs = [float(w) / 100 for b, w in re.findall(
        r"Batch \[(\d+)\] Speed: .* data wait ([0-9.]+)%", "\n".join(lines))
        if int(b) > 0]
    epochs = [float(x) / 100 for x in re.findall(
        r"steps in .* data wait .* \(([0-9.]+)%\)", "\n".join(lines))]
    return {"steps": len(fracs) + args.control_epochs,
            "epochs": args.control_epochs, "images": args.control_images,
            "data_wait_frac_p50": statistics.median(fracs),
            "data_wait_frac_per_epoch": epochs}


def _checks(record: dict, args) -> Dict[str, bool]:
    checks = {}
    if "shard_rig" in record:
        r = record["shard_rig"]
        checks["rig_union_exactly_once"] = r["union_exactly_once"]
        checks["rig_decode_split"] = all(
            abs(s - 1.0 / r["processes"]) < 0.02
            for s in r["per_process_share"])
    se = record["stream_epoch"]
    checks["stream_exactly_once"] = se["exactly_once"]
    checks["nothing_built_in_timed_pass"] = not se["built_in_timed_pass"]
    if args.ram_ceiling_mb > 0:
        room = args.ram_ceiling_mb - (_PROCESS_FLOOR_BYTES >> 20)
        checks["rss_growth_under_ceiling"] = (
            0 < se["peak_rss_before_mb"]
            and se["peak_rss_mb"] - se["peak_rss_before_mb"] <= room)
    checks["stage_overlap_nonzero"] = se["stage"]["hits"] > 0
    if args.min_rate > 0:
        checks["rate_floor"] = se["imgs_per_sec"] >= args.min_rate
    checks["eval_complete"] = (record["eval_leg"]["images"]
                               == record["eval_leg"]["expected"])
    if "control" in record:
        checks["control_data_wait_near_zero"] = (
            record["control"]["data_wait_frac_p50"] < 0.15)
    return checks


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="synthetic_stream",
                   choices=["synthetic_hard", "synthetic_stream"])
    p.add_argument("--network", default="tiny")
    p.add_argument("--root_path", default="data")
    p.add_argument("--dataset_path", default=None,
                   help="the set's directory (default: the preset's; "
                        "--smoke: <root_path>/<dataset>_smoke, so that a "
                        "smoke never rewrites the full set's PNGs)")
    p.add_argument("--num_images", type=int, default=10_000)
    p.add_argument("--test_images", type=int, default=1_000)
    p.add_argument("--batch_images", type=int, default=2)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--decode_procs", type=int, default=0,
                   help="decode pool processes for the streaming epoch "
                        "(0: the loader threads decode)")
    p.add_argument("--num_shards", type=int, default=2,
                   help="worker processes of the shard rig")
    p.add_argument("--ram_ceiling_mb", type=int, default=4096)
    p.add_argument("--min_rate", type=float, default=0.0,
                   help="images/s floor of the streaming epoch under --check")
    p.add_argument("--step_ms", type=float, default=0.0,
                   help="a simulated device step per batch in the streaming "
                        "epoch (0: the input plane's own rate)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--control_images", type=int, default=64)
    p.add_argument("--control_epochs", type=int, default=2)
    p.add_argument("--skip_control", action="store_true")
    p.add_argument("--skip_rig", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="every leg at a small size, every invariant; the "
                        "streaming epoch simulates a 10 ms device step "
                        "(at least) so that the stager can run ahead of "
                        "the consumer, which its overlap check tests")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless every invariant holds")
    p.add_argument("--out", default=None, help="write the record here too")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--shard_id", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--ids_out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.smoke:
        args.num_images = min(args.num_images, 240)
        args.test_images = min(args.test_images, 60)
        args.control_epochs = min(args.control_epochs, 2)
        args.ram_ceiling_mb = min(args.ram_ceiling_mb, 3072)
        args.step_ms = max(args.step_ms, 10.0)
        if args.dataset_path is None:
            args.dataset_path = os.path.join(args.root_path,
                                             f"{args.dataset}_smoke")
    if args.dataset_path is None:
        args.dataset_path = os.path.join(args.root_path, args.dataset)
    if args.worker:
        return run_worker(args)

    record = {"metric": "stream_input_plane", "dataset": args.dataset,
              "num_images": args.num_images,
              "batch_images": args.batch_images, "smoke": args.smoke}
    t_all = time.perf_counter()
    # writes the PNGs here first, so that the rig's workers find them
    expected = _expected_epoch_ids(args)
    if not args.skip_rig:
        record["shard_rig"] = run_shard_rig(args, expected)
    record["stream_epoch"] = run_stream_epoch(args, expected)
    record["eval_leg"] = run_eval_leg(args)
    if not args.skip_control:
        record["control"] = run_control(args)
    record["wall_s_total"] = time.perf_counter() - t_all
    record["checks"] = _checks(record, args)
    record["ok"] = all(record["checks"].values())
    out = json.dumps(record, indent=1)
    print(out, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    if args.check:
        failed = [k for k, v in record["checks"].items() if not v]
        if failed:
            print(f"CHECK FAILED: {failed}", file=sys.stderr)
            return 1
        print("CHECK OK: " + ", ".join(record["checks"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
