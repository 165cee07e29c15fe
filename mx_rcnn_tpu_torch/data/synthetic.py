"""Synthetic detection images: coloured rectangles on a noise background.

Counterpart of ``mx_rcnn_tpu/data/synthetic.py — SyntheticDataset``,
an :class:`IMDB` rendered in memory (no PNG cache).  The specs come from
the same ``RandomState`` sequence, seeded from ``crc32(image_set)``, so
the two packages generate the same boxes, classes and pixels, and score
detections with the same VOC07 evaluator.  Class k fills its rectangles
with a class-specific colour, which makes the task learnable.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.data.roidb import IMDB, Roidb
from mx_rcnn_tpu_torch.data.voc_eval import voc_eval

VOC_IMAGE_SIZE = (375, 500)


def default_image_size(dataset: str) -> Tuple[int, int]:
    """(h, w) of the synthetic stand-in images for a dataset preset: the
    synthetic sets' own canvas, else VOC's typical 375x500."""
    return (320, 400) if dataset.startswith("synthetic") else VOC_IMAGE_SIZE


def _class_color(c: int) -> np.ndarray:
    rng = np.random.RandomState(1234 + c)
    return rng.randint(40, 255, size=3).astype(np.uint8)


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1)
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
    inter = ix * iy
    area = lambda r: (r[2] - r[0] + 1) * (r[3] - r[1] + 1)
    return inter / (area(a) + area(b) - inter)


class SyntheticDataset(IMDB):
    """``num_images`` deterministic images of ``image_size`` (h, w), each
    with 1..max_objects low-overlap rectangles of classes 1..C-1."""

    def __init__(self, image_set: str = "train",
                 num_images: Optional[int] = None, num_classes: int = 4,
                 image_size: Tuple[int, int] = (320, 400),
                 max_objects: int = 3, root_path: str = "data",
                 dataset_path: Optional[str] = None):
        if num_images is None:
            num_images = 64 if "train" in image_set else 16
        super().__init__("synthetic", image_set, root_path,
                         dataset_path or os.path.join(root_path, "synthetic"))
        self.classes = ["__background__"] + [
            f"class{i}" for i in range(1, num_classes)]
        self.num_images = num_images
        self.image_size = tuple(image_size)
        self.max_objects = max_objects
        self._rng = np.random.RandomState(
            zlib.crc32(image_set.encode()) % (2 ** 31))
        self.specs = self._make_specs()
        self.image_index = list(range(num_images))

    def _make_specs(self) -> List[Dict]:
        h, w = self.image_size
        rng = self._rng
        specs = []
        for _ in range(self.num_images):
            n = rng.randint(1, self.max_objects + 1)
            boxes, classes = [], []
            for _ in range(n):
                # rejection-sample low-overlap placements
                for _attempt in range(20):
                    bw = rng.randint(max(16, w // 5), max(17, w // 2))
                    bh = rng.randint(max(16, h // 5), max(17, h // 2))
                    x1 = rng.randint(0, w - bw)
                    y1 = rng.randint(0, h - bh)
                    cand = [x1, y1, x1 + bw - 1, y1 + bh - 1]
                    if all(_iou(cand, b) < 0.2 for b in boxes):
                        boxes.append(cand)
                        classes.append(rng.randint(1, self.num_classes))
                        break
            specs.append(dict(
                boxes=np.asarray(boxes, np.float32),
                gt_classes=np.asarray(classes, np.int32),
                noise_seed=int(rng.randint(0, 2 ** 31)),
            ))
        return specs

    def render(self, i: int) -> np.ndarray:
        """Image ``i`` as RGB uint8 (h, w, 3)."""
        spec = self.specs[i]
        h, w = self.image_size
        rng = np.random.RandomState(spec["noise_seed"])
        img = rng.randint(0, 60, size=(h, w, 3)).astype(np.uint8)
        for box, cls in zip(spec["boxes"], spec["gt_classes"]):
            x1, y1, x2, y2 = box.astype(int)
            img[y1:y2 + 1, x1:x2 + 1] = _class_color(int(cls))
        return img

    def gt_roidb(self) -> Roidb:
        h, w = self.image_size
        return [dict(image=f"{self.image_set}_{i:05d}", index=i, height=h,
                     width=w, boxes=spec["boxes"].copy(),
                     gt_classes=spec["gt_classes"].copy(), flipped=False)
                for i, spec in enumerate(self.specs)]

    def load_image(self, rec: Dict) -> np.ndarray:
        return self.render(rec["index"])

    def evaluate_detections(self, all_boxes, out_dir: Optional[str] = None
                            ) -> Dict[str, float]:
        """VOC07 AP of each class that has a gt box, and their mean;
        nothing is written, so ``out_dir`` is unused."""
        gt = {i: dict(boxes=spec["boxes"], gt_classes=spec["gt_classes"],
                      difficult=np.zeros(len(spec["boxes"]), bool))
              for i, spec in enumerate(self.specs)}
        aps = []
        results = {}
        for c in range(1, self.num_classes):
            if not any((g["gt_classes"] == c).any() for g in gt.values()):
                continue
            dets = {i: np.asarray(all_boxes[c][i]).reshape(-1, 5)
                    for i in range(self.num_images)}
            ap = voc_eval(dets, gt, c, ovthresh=0.5, use_07_metric=True)
            results[self.classes[c]] = ap
            aps.append(ap)
        results["mAP"] = float(np.mean(aps)) if aps else 0.0
        return results
