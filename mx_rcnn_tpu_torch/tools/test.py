"""Evaluate a checkpoint: checkpoint → mAP.

Counterpart of ``mx_rcnn_tpu/tools/test.py — test_rcnn``: the epoch's
weights (``utils/checkpoint.py — load_param``, either package's file) →
the test model on the device → ``TestLoader`` (assembly threads, no
decode cache: each image is read once) → ``pred_eval`` (per-class NMS,
kernel K1 on the card, and the ``max_per_image`` cap) →
``imdb.evaluate_detections``: VOC07 AP over a VOCdevkit (with the comp4
detection files under ``--out_dir``), COCO bbox AP over a COCO tree (the
results json under ``--out_dir``), or VOC07 AP over ``--synthetic N``
synthetic images (375x500 for the VOC and COCO presets).
``--num_devices N`` splits each eval batch, ``test.batch_images`` x N
images, across the first N cards (``Predictor(devices=...)``); fewer
cards than N is an error.

    python -m mx_rcnn_tpu_torch.tools.test --network resnet101 \\
        --dataset PascalVOC --root_path data --dataset_path data/VOCdevkit \\
        --prefix model/e2e --epoch 1 --out_dir model/dets
    python -m mx_rcnn_tpu_torch.tools.test --device cpu --network tiny \\
        --dataset synthetic --synthetic 4 --prefix /tmp/p --epoch 1
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

from mx_rcnn_tpu_torch.config import (NETWORKS, Config, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.loader import TestLoader
from mx_rcnn_tpu_torch.parallel.dp import local_devices
from mx_rcnn_tpu_torch.tools import dataset_args, dataset_overrides
from mx_rcnn_tpu_torch.utils.checkpoint import load_model
from mx_rcnn_tpu_torch.utils.device import resolve_device


def print_results(results: Dict[str, float], verbose: bool = True) -> None:
    """An evaluator's numbers: VOC's per-class APs (when ``verbose``) and
    ``mAP``, or each of COCO's metrics."""
    if "mAP" not in results:
        for k, v in results.items():
            print(f"{k} = {v:.4f}")
        return
    if verbose:
        for k, v in sorted(results.items()):
            if k != "mAP":
                print(f"{k} AP = {v:.4f}")
    print(f"mAP = {results['mAP']:.4f}", flush=True)


def test_rcnn(cfg: Config, *, prefix: str, epoch: int, image_set: str = None,
              out_dir: str = None, verbose: bool = True,
              dataset_kw: dict = None, save_dets: str = None, device="cuda",
              synthetic: int = 0, num_devices: int = 1
              ) -> Dict[str, float]:
    """Evaluate checkpoint ``prefix``@``epoch`` on ``device`` (CUDA unless
    the caller asks for the CPU); returns the evaluator's numbers (VOC:
    the per-class APs and ``mAP``; COCO: AP, AP50, AP75, AP by area and
    AR_100).  ``out_dir`` receives the detection files; ``synthetic`` > 0
    scores that many synthetic images.  ``num_devices`` > 1 splits each
    batch of ``test.batch_images`` x N across the first N cards (the CPU
    N times when ``device`` is the CPU; ``parallel/dp.py —
    local_devices``)."""
    dev = resolve_device(device)
    imdb, roidb = load_gt_roidb(cfg, image_set=image_set, training=False,
                                synthetic=synthetic, **(dataset_kw or {}))
    devs = local_devices(dev, num_devices) if num_devices > 1 else None
    loader = TestLoader(roidb, cfg, imdb.load_image,
                        batch_images=cfg.test.batch_images
                        * (len(devs) if devs else 1))
    predictor = Predictor(load_model(cfg, prefix, epoch, dev), cfg, dev,
                          devices=devs)
    t0 = time.perf_counter()
    results = pred_eval(predictor, loader, imdb, cfg, out_dir=out_dir,
                        verbose=verbose, save_dets=save_dets)
    wall = time.perf_counter() - t0
    if verbose:
        print(f"pred_eval: {len(roidb)} images in {wall:.3f} s, "
              f"{len(roidb) / wall:.2f} images/s on {devs or dev}",
              flush=True)
    print_results(results, verbose)
    return results


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="resnet101",
                   choices=NETWORKS)
    dataset_args(p)
    p.add_argument("--prefix", default="model/e2e")
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--out_dir", default=None,
                   help="write detection files here (VOC comp4 / COCO json)")
    p.add_argument("--save_dets", default=None,
                   help="pickle raw detections here for tools/reeval.py")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--num_devices", type=int, default=1,
                   help="split each eval batch across this many cards")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    cfg = generate_config(args.network, args.dataset,
                          **{**dataset_overrides(args),
                             **parse_set_overrides(args.set)})
    return test_rcnn(cfg, prefix=args.prefix, epoch=args.epoch,
                     image_set=args.image_set, out_dir=args.out_dir,
                     save_dets=args.save_dets, device=args.device,
                     synthetic=args.synthetic, num_devices=args.num_devices)


if __name__ == "__main__":
    main()
