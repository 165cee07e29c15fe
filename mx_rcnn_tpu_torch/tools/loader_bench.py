"""Host input-pipeline benchmark: epoch images/s against the loader's
thread and process counts.

Counterpart of ``mx_rcnn_tpu/tools/loader_bench.py``.  For each
configuration one ``AnchorLoader`` epoch (no shuffle) is run twice, cold
(the first pass decodes every image) and warm (the second; with a cache
its decodes are cache reads):

* ``threads=N``: the loader's N assembly threads decode in this process
  (0: on the caller's thread);
* ``procs=N``: the spawn decode pool of N processes
  (``data/decode_pool.py``) under 2 assembly threads, warmed by one
  decode first so that the interpreters' start is not billed to the cold
  pass;
* with ``--cache_dir``, each configuration reads and writes a disk cache
  of its own (``<cache_dir>/threadsN``, ``procsN``), so that no cold
  pass finds another configuration's decodes; without it the thread
  configurations run uncached.

One JSON line per configuration, then a summary with each
configuration's cold rate over N times the 1-worker rate of its kind.
The default set is ``synthetic_hard`` (written once as PNG files under
``--root_path``) at ResNet-101's config; the tool moves nothing to a
device, so it takes no ``--device``.

    python -m mx_rcnn_tpu_torch.tools.loader_bench --root_path /tmp/lb \\
        --limit 64 --threads 0 1 2 --procs 1 2 --cache_dir /tmp/lb/cache
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

from mx_rcnn_tpu_torch.config import NETWORKS, generate_config
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.cache import DecodedImageCache
from mx_rcnn_tpu_torch.data.decode_pool import DecodePool
from mx_rcnn_tpu_torch.data.loader import AnchorLoader


def _rate(loader) -> float:
    """Images/s of one epoch of ``loader``."""
    n = 0
    t0 = time.perf_counter()
    for b in loader:
        n += b.images.shape[0]
    return n / (time.perf_counter() - t0)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="synthetic_hard",
                   choices=["PascalVOC", "coco", "synthetic_hard",
                            "synthetic_stream"],
                   help="a set read from image files")
    p.add_argument("--network", default="resnet101", choices=NETWORKS)
    p.add_argument("--root_path", default="data")
    p.add_argument("--dataset_path", default=None,
                   help="the dataset directory (default: the preset's)")
    p.add_argument("--image_set", default=None)
    p.add_argument("--batch_images", type=int, default=2)
    p.add_argument("--threads", type=int, nargs="*", default=[0, 1, 2, 4])
    p.add_argument("--procs", type=int, nargs="*", default=[1, 2, 4])
    p.add_argument("--cache_dir", default=None,
                   help="give each configuration a disk cache under here")
    p.add_argument("--limit", type=int, default=None,
                   help="the first this many training records only")
    args = p.parse_args(argv)

    over = {"dataset__root_path": args.root_path}
    if args.dataset_path:
        over["dataset__dataset_path"] = args.dataset_path
    cfg = generate_config(args.network, args.dataset, **over)
    imdb, roidb = load_gt_roidb(cfg, image_set=args.image_set,
                                training=True)
    roidb = roidb[:args.limit] if args.limit else roidb
    cores = os.cpu_count()
    print(json.dumps({"event": "setup", "images": len(roidb),
                      "host_cores": cores,
                      "bucket": list(cfg.bucket.shapes[0])}), flush=True)

    results = []

    def record(kind: str, n: int, loader) -> None:
        cold, warm = _rate(loader), _rate(loader)
        results.append((kind, n, cold, warm))
        print(json.dumps({"config": f"{kind}={n}",
                          "cold_imgs_per_sec": round(cold, 2),
                          "warm_imgs_per_sec": round(warm, 2)}), flush=True)

    def cache_dir(kind: str, n: int) -> Optional[str]:
        return (os.path.join(args.cache_dir, f"{kind}{n}")
                if args.cache_dir else None)

    for n in args.threads:
        d = cache_dir("threads", n)
        record("threads", n, AnchorLoader(
            roidb, cfg, imdb.load_image, batch_images=args.batch_images,
            shuffle=False, num_workers=n,
            cache=DecodedImageCache(cache_dir=d) if d else None))
    for n in args.procs:
        with DecodePool(n, cache_dir=cache_dir("procs", n)) as pool:
            b = cfg.bucket
            pool.submit(roidb[0]["image"], False, b.scale, b.max_size,
                        tuple(b.shapes[0])).result()
            record("procs", n, AnchorLoader(
                roidb, cfg, imdb.load_image, batch_images=args.batch_images,
                shuffle=False, num_workers=2, decode_pool=pool))

    base = {kind: cold for kind, n, cold, _ in results if n == 1}
    summary = {
        "event": "summary", "host_cores": cores,
        "per_worker_efficiency_cold": {
            f"{kind}={n}": round(cold / (base[kind] * n), 3)
            for kind, n, cold, _ in results
            if n >= 1 and base.get(kind, 0) > 0},
        "configs": {f"{kind}={n}": dict(cold=round(cold, 2),
                                        warm=round(warm, 2))
                    for kind, n, cold, warm in results}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
