"""The roidb: the per-image annotation records the loaders consume.

Counterpart of ``mx_rcnn_tpu/data/roidb.py`` (``IMDB`` with its
``gt_roidb`` pickle cache, ``merge_roidbs``, ``filter_roidb``).  A roidb
entry is a dict with the JAX package's keys: ``image`` (the file's path
for the on-disk readers), ``index``, ``height``, ``width``, ``boxes`` (n,
4) float32 gt boxes (x1, y1, x2, y2), ``gt_classes`` (n,) int32 class ids
(1..C-1) and ``flipped``.  A flipped record's boxes are mirrored here and
its pixels by the loaders, before the resize.  The cache file,
``<root_path>/cache/<name>_gt_roidb.pkl``, holds these dicts and nothing
of either package, so each package reads the other's.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from mx_rcnn_tpu_torch.data.image import imread_rgb

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

    @property
    def cache_path(self) -> str:
        path = os.path.join(self.root_path, "cache")
        os.makedirs(path, exist_ok=True)
        return path

    def gt_roidb(self) -> Roidb:
        """The annotations, read once and then from the pickle cache."""
        cache_file = os.path.join(self.cache_path,
                                  self.name + "_gt_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        roidb = self._load_annotations()
        with open(cache_file, "wb") as f:
            pickle.dump(roidb, f, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_annotations(self) -> Roidb:
        raise NotImplementedError

    def load_image(self, rec: Dict) -> np.ndarray:
        """The RGB uint8 (h, w, 3) pixels of roidb entry ``rec``: its
        ``image`` file, for the on-disk readers."""
        return imread_rgb(rec["image"])

    def evaluate_detections(self, all_boxes, out_dir: Optional[str] = None
                            ) -> Dict[str, float]:
        """all_boxes[class][image] = (k, 5) array of [x1 y1 x2 y2 score];
        a reader that writes result files writes them under ``out_dir``."""
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


def reads_files(load_image: Callable) -> bool:
    """Whether ``load_image`` is an on-disk reader's
    :meth:`IMDB.load_image`, which decodes each record's ``image`` file:
    only then can a decode cache or pool, which read that file
    themselves, stand in for it."""
    return getattr(load_image, "__func__", None) is IMDB.load_image


def merge_roidbs(roidbs: Sequence[Roidb]) -> Roidb:
    """Concatenate the roidbs of several image sets."""
    out: Roidb = []
    for r in roidbs:
        out.extend(r)
    return out


def filter_roidb(roidb: Roidb) -> Roidb:
    """Drop images without any gt box."""
    return [r for r in roidb if len(r["boxes"]) > 0]
