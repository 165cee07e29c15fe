"""Re-score saved detections without running the model.

Counterpart of ``mx_rcnn_tpu/tools/reeval.py``: reads the
``{"all_boxes", "classes"}`` pickle that ``tools/test.py --save_dets``
writes (in either package) and runs ``imdb.evaluate_detections`` again,
over a VOCdevkit, a COCO tree or synthetic images.

    python -m mx_rcnn_tpu_torch.tools.reeval --dets dets.pkl \\
        --dataset PascalVOC --dataset_path data/VOCdevkit --out_dir dets
    python -m mx_rcnn_tpu_torch.tools.reeval --dets dets.pkl \\
        --network tiny --dataset synthetic --synthetic 4
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict

from mx_rcnn_tpu_torch.config import NETWORKS, generate_config
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.tools.test import print_results
from mx_rcnn_tpu_torch.tools import dataset_args, dataset_overrides


def reeval(cfg, dets_path: str, image_set: str = None, out_dir: str = None,
           dataset_kw: dict = None, synthetic: int = 0) -> Dict[str, float]:
    """Load pickled all_boxes (a file this program or the JAX package
    wrote) and re-run the dataset's evaluator, which writes its detection
    files under ``out_dir`` when given."""
    imdb, _ = load_gt_roidb(cfg, image_set=image_set, training=False,
                            synthetic=synthetic, **(dataset_kw or {}))
    with open(dets_path, "rb") as f:
        payload = pickle.load(f)
    all_boxes = payload["all_boxes"]
    saved = payload.get("classes")
    if saved is not None and list(saved) != list(imdb.classes):
        raise ValueError(
            f"detections were saved for classes {saved}, the evaluator has "
            f"{imdb.classes}: wrong --dataset/--network?")
    if len(all_boxes[0]) != len(imdb.image_index):
        raise ValueError(
            f"{len(all_boxes[0])} per-image detection lists for "
            f"{len(imdb.image_index)} images: wrong --image_set?")
    results = imdb.evaluate_detections(all_boxes, out_dir)
    print_results(results)
    return results


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dets", required=True,
                   help="detections pickle written by tools/test.py "
                        "--save_dets")
    p.add_argument("--network", default="resnet101",
                   choices=NETWORKS)
    dataset_args(p)
    p.add_argument("--out_dir", default=None,
                   help="write detection files here (VOC comp4 / COCO json)")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    cfg = generate_config(args.network, args.dataset,
                          **dataset_overrides(args))
    return reeval(cfg, args.dets, image_set=args.image_set,
                  out_dir=args.out_dir, synthetic=args.synthetic)


if __name__ == "__main__":
    main()
