"""Evaluate an RCNN-stage checkpoint on precomputed proposals → mAP.

Counterpart of ``mx_rcnn_tpu/tools/test_rcnn.py``: the head of
checkpoint ``--prefix``@``--epoch`` classifies the proposals of
``--proposals`` (``tools/test_rpn.py --eval_set``'s pickle over the test
roidb) through ``FasterRCNN.detect_rois`` (ROIAlign, kernel K2), then the
eval postprocess (per-class NMS, kernel K1), the ``max_per_image`` cap
and the dataset's evaluator, as ``tools/test.py`` does for a whole model,
on the datasets ``tools/test.py`` reads.

    python -m mx_rcnn_tpu_torch.tools.test_rcnn --network vgg \\
        --dataset PascalVOC --synthetic 8 --prefix model/rcnn --epoch 1 \\
        --proposals model/rpn-test-proposals.pkl                      # card
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence

from mx_rcnn_tpu_torch.config import (NETWORKS, Config, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.loader import ROITestLoader
from mx_rcnn_tpu_torch.tools.test import print_results
from mx_rcnn_tpu_torch.tools import dataset_args, dataset_overrides
from mx_rcnn_tpu_torch.tools.train_rpn import load_proposals
from mx_rcnn_tpu_torch.utils.checkpoint import load_model
from mx_rcnn_tpu_torch.utils.device import resolve_device


def test_rcnn_stage(cfg: Config, *, prefix: str, epoch: int,
                    proposals: Sequence, image_set: str = None,
                    out_dir: str = None, verbose: bool = True,
                    dataset_kw: dict = None, save_dets: str = None,
                    device="cuda", synthetic: int = 0) -> Dict[str, float]:
    """Evaluate RCNN-stage checkpoint ``prefix``@``epoch`` on
    ``proposals`` (one raw-coordinate (k, 5) array per test-roidb record)
    on ``device`` (CUDA unless the caller asks for the CPU); returns the
    evaluator's numbers, as :func:`tools.test.test_rcnn` does."""
    dev = resolve_device(device)
    imdb, roidb = load_gt_roidb(cfg, image_set=image_set, training=False,
                                synthetic=synthetic, **(dataset_kw or {}))
    loader = ROITestLoader(roidb, cfg, imdb.load_image, proposals)
    predictor = Predictor(load_model(cfg, prefix, epoch, dev), cfg, dev)
    results = pred_eval(predictor, loader, imdb, cfg, out_dir=out_dir,
                        verbose=verbose, save_dets=save_dets)
    print_results(results, verbose)
    return results


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="resnet101", choices=NETWORKS)
    dataset_args(p)
    p.add_argument("--prefix", default="model/rcnn")
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--proposals", required=True,
                   help="proposal pickle over the test roidb "
                        "(tools/test_rpn.py --eval_set)")
    p.add_argument("--out_dir", default=None,
                   help="write detection files here (VOC comp4 / COCO json)")
    p.add_argument("--save_dets", default=None,
                   help="pickle raw detections here for tools/reeval.py")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", metavar="SEC__FIELD=VAL",
                   help="override a config field (repeatable)")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    resolve_device(args.device)
    cfg = generate_config(args.network, args.dataset,
                          **{**dataset_overrides(args),
                             **parse_set_overrides(args.set)})
    return test_rcnn_stage(cfg, prefix=args.prefix, epoch=args.epoch,
                           proposals=load_proposals(args.proposals),
                           image_set=args.image_set, out_dir=args.out_dir,
                           save_dets=args.save_dets, device=args.device,
                           synthetic=args.synthetic)


if __name__ == "__main__":
    main()
