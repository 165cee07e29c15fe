"""The roidb: the per-image annotation records the loaders consume.

Counterpart of ``mx_rcnn_tpu/data/roidb.py`` (``IMDB``, ``merge_roidbs``,
``filter_roidb``).  A roidb entry is a dict with the JAX package's keys:
``image``, ``index``, ``height``, ``width``, ``boxes`` (n, 4) float32 gt
boxes (x1, y1, x2, y2), ``gt_classes`` (n,) int32 class ids (1..C-1) and
``flipped``.  A flipped record's boxes are mirrored here and its pixels
by the loaders, before the resize.  The gt_roidb pickle cache and the
evaluators' detection files come with the VOC and COCO readers, which
are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

Roidb = List[Dict]


class IMDB:
    """Image database base class: a named image set with its classes, its
    roidb, the pixels of each record and its evaluator."""

    def __init__(self, name: str, image_set: str, root_path: str,
                 dataset_path: str):
        self.name = f"{name}_{image_set}"
        self.image_set = image_set
        self.root_path = root_path
        self.data_path = dataset_path
        self.classes: Sequence[str] = []
        self.num_images = 0

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def gt_roidb(self) -> Roidb:
        raise NotImplementedError

    def load_image(self, rec: Dict) -> np.ndarray:
        """The RGB uint8 (h, w, 3) pixels of roidb entry ``rec``."""
        raise NotImplementedError

    def evaluate_detections(self, all_boxes) -> Dict[str, float]:
        """all_boxes[class][image] = (k, 5) array of [x1 y1 x2 y2 score]."""
        raise NotImplementedError

    @staticmethod
    def append_flipped_images(roidb: Roidb) -> Roidb:
        """The roidb followed by a horizontally flipped copy of each
        record: boxes mirrored as ``x' = width - 1 - x``, ``flipped``
        set."""
        flipped = []
        for rec in roidb:
            boxes = rec["boxes"].copy()
            if boxes.size:
                x1 = boxes[:, 0].copy()
                boxes[:, 0] = rec["width"] - boxes[:, 2] - 1
                boxes[:, 2] = rec["width"] - x1 - 1
                assert (boxes[:, 2] >= boxes[:, 0]).all()
            flipped.append(dict(rec, boxes=boxes, flipped=True))
        return list(roidb) + flipped


def merge_roidbs(roidbs: Sequence[Roidb]) -> Roidb:
    """Concatenate the roidbs of several image sets."""
    out: Roidb = []
    for r in roidbs:
        out.extend(r)
    return out


def filter_roidb(roidb: Roidb) -> Roidb:
    """Drop images without any gt box."""
    return [r for r in roidb if len(r["boxes"]) > 0]
