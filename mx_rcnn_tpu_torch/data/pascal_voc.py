"""PASCAL VOC: the devkit reader and its evaluator.

Counterpart of ``mx_rcnn_tpu/data/pascal_voc.py — PascalVOC``: the image
index of ``VOC<year>/ImageSets/Main/<set>.txt``, the XML annotations
(boxes made 0-based, ``difficult`` objects dropped unless
``use_difficult``), the reference's ``comp4_det_<set>_<class>.txt``
detection files (1-based pixels) and the VOC07 11-point AP over
``data/voc_eval.py``.  ``image_set`` is ``<year>_<set>``, e.g.
``2007_trainval``; the devkit is ``<dataset_path>/VOC<year>/{Annotations,
ImageSets/Main,JPEGImages}``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.data.roidb import IMDB, Roidb
from mx_rcnn_tpu_torch.data.voc_eval import voc_eval

CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class PascalVOC(IMDB):
    def __init__(self, image_set: str, root_path: str, dataset_path: str,
                 use_difficult: bool = False):
        year, sset = image_set.split("_", 1)
        super().__init__("voc_" + year, sset, root_path, dataset_path)
        self.year = year
        self.sset = sset
        self.classes = CLASSES
        self.use_difficult = use_difficult
        self.voc_path = os.path.join(dataset_path, "VOC" + year)
        self.image_index = self._load_image_index()
        self.num_images = len(self.image_index)

    def _load_image_index(self) -> List[str]:
        index_file = os.path.join(self.voc_path, "ImageSets", "Main",
                                  self.sset + ".txt")
        with open(index_file) as f:
            return [line.strip().split()[0] for line in f if line.strip()]

    def image_path(self, index: str) -> str:
        return os.path.join(self.voc_path, "JPEGImages", index + ".jpg")

    def _annotation_path(self, index: str) -> str:
        return os.path.join(self.voc_path, "Annotations", index + ".xml")

    def _load_annotations(self) -> Roidb:
        roidb = []
        class_to_id = {c: i for i, c in enumerate(self.classes)}
        for index in self.image_index:
            tree = ET.parse(self._annotation_path(index))
            size = tree.find("size")
            width = int(size.find("width").text)
            height = int(size.find("height").text)
            boxes, classes = [], []
            for obj in tree.findall("object"):
                difficult = obj.find("difficult")
                if (not self.use_difficult and difficult is not None
                        and int(difficult.text) == 1):
                    continue
                name = obj.find("name").text.lower().strip()
                if name not in class_to_id:
                    continue
                bb = obj.find("bndbox")
                # pixel indexes 0-based
                x1 = float(bb.find("xmin").text) - 1
                y1 = float(bb.find("ymin").text) - 1
                x2 = float(bb.find("xmax").text) - 1
                y2 = float(bb.find("ymax").text) - 1
                boxes.append([x1, y1, x2, y2])
                classes.append(class_to_id[name])
            roidb.append(dict(
                image=self.image_path(index),
                index=index,
                height=height,
                width=width,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                gt_classes=np.asarray(classes, np.int32),
                flipped=False,
            ))
        return roidb

    # ---- evaluation -------------------------------------------------------

    def _det_file(self, cls: str, out_dir: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        return os.path.join(out_dir, f"comp4_det_{self.sset}_{cls}.txt")

    def write_detections(self, all_boxes, out_dir: str) -> None:
        """Write per-class comp4 txt files:
        ``image_id score x1 y1 x2 y2`` with 1-based pixel coords."""
        for c, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            with open(self._det_file(cls, out_dir), "w") as f:
                for i, index in enumerate(self.image_index):
                    dets = all_boxes[c][i]
                    for k in range(len(dets)):
                        f.write(
                            f"{index} {dets[k, 4]:.6f} "
                            f"{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} "
                            f"{dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n")

    def evaluate_detections(self, all_boxes, out_dir: str = None
                            ) -> Dict[str, float]:
        """Per-class VOC07 11-point AP and their mean, ``mAP``, after
        writing the detection files under ``out_dir`` when given.
        ``all_boxes[class][image] = (k, 5)`` arrays."""
        use_07 = True
        if out_dir is not None:
            self.write_detections(all_boxes, out_dir)
        gt = {}
        for i, index in enumerate(self.image_index):
            rec = self._gt_for_eval(index)
            gt[index] = rec
        results = {}
        aps = []
        for c, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            dets = {
                self.image_index[i]: np.asarray(all_boxes[c][i]).reshape(-1, 5)
                for i in range(self.num_images)
            }
            ap = voc_eval(dets, gt, c, ovthresh=0.5, use_07_metric=use_07)
            results[cls] = ap
            aps.append(ap)
        results["mAP"] = float(np.mean(aps)) if aps else 0.0
        return results

    def _gt_for_eval(self, index: str):
        tree = ET.parse(self._annotation_path(index))
        boxes, classes, difficult = [], [], []
        class_to_id = {c: i for i, c in enumerate(self.classes)}
        for obj in tree.findall("object"):
            name = obj.find("name").text.lower().strip()
            if name not in class_to_id:
                continue
            d = obj.find("difficult")
            bb = obj.find("bndbox")
            boxes.append([float(bb.find("xmin").text) - 1,
                          float(bb.find("ymin").text) - 1,
                          float(bb.find("xmax").text) - 1,
                          float(bb.find("ymax").text) - 1])
            classes.append(class_to_id[name])
            difficult.append(int(d.text) if d is not None else 0)
        return dict(
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            gt_classes=np.asarray(classes, np.int32),
            difficult=np.asarray(difficult, bool),
        )
