"""COCO: the instances-json reader and its bbox and segm evaluators.

Counterpart of ``mx_rcnn_tpu/data/coco.py — COCODataset`` without
pycocotools: the image index and annotations of
``<dataset_path>/annotations/instances_<set>.json`` (images under
``<dataset_path>/<set>/``), crowd and zero-area boxes left out of the
training roidb, category ids mapped to contiguous classes 1..80 (0 is
the background), ``evaluate_detections`` through ``data/coco_eval.py``
and the results json in the standard xywh format; ``ann_rle`` turns an
annotation's polygon, uncompressed or compressed RLE (or, lacking one,
its box) into a ``native`` RLE dict, and ``evaluate_segmentations``
scores mask detections with crowds as ignore regions.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.data.coco_eval import evaluate_bbox
from mx_rcnn_tpu_torch.data.roidb import IMDB, Roidb


class COCODataset(IMDB):
    def __init__(self, image_set: str, root_path: str, dataset_path: str):
        super().__init__("coco", image_set, root_path, dataset_path)
        self.ann_file = os.path.join(
            dataset_path, "annotations", f"instances_{image_set}.json")
        self.image_dir = os.path.join(dataset_path, image_set)
        self._load_index()

    def _load_index(self) -> None:
        with open(self.ann_file) as f:
            ann = json.load(f)
        cats = sorted(ann["categories"], key=lambda c: c["id"])
        self.classes = ["__background__"] + [c["name"] for c in cats]
        self.cat_ids = [c["id"] for c in cats]
        self.cat_to_class = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}
        self.images = {im["id"]: im for im in ann["images"]}
        self.image_index = sorted(self.images.keys())
        self.num_images = len(self.image_index)
        self.anns_by_image: Dict[int, List[dict]] = defaultdict(list)
        for a in ann.get("annotations", []):
            self.anns_by_image[a["image_id"]].append(a)

    def image_path(self, image_id: int) -> str:
        return os.path.join(self.image_dir, self.images[image_id]["file_name"])

    def _load_annotations(self) -> Roidb:
        roidb = []
        for image_id in self.image_index:
            info = self.images[image_id]
            w, h = info["width"], info["height"]
            boxes, classes = [], []
            for a in self.anns_by_image.get(image_id, []):
                if a.get("iscrowd", 0):
                    continue
                x, y, bw, bh = a["bbox"]  # COCO xywh → xyxy, clipped
                x1 = max(0.0, x)
                y1 = max(0.0, y)
                x2 = min(w - 1.0, x + max(0.0, bw - 1))
                y2 = min(h - 1.0, y + max(0.0, bh - 1))
                if a.get("area", bw * bh) > 0 and x2 >= x1 and y2 >= y1:
                    boxes.append([x1, y1, x2, y2])
                    classes.append(self.cat_to_class[a["category_id"]])
            roidb.append(dict(
                image=self.image_path(image_id),
                index=image_id,
                height=h,
                width=w,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                gt_classes=np.asarray(classes, np.int32),
                flipped=False,
            ))
        return roidb

    def evaluate_detections(self, all_boxes, out_dir: str = None
                            ) -> Dict[str, float]:
        """COCO bbox AP@[.5:.95], AP50, AP75, AP by area and AR_100,
        after writing the results json under ``out_dir`` when given."""
        dets = {}
        gts = {}
        for i, image_id in enumerate(self.image_index):
            per_cat_d = {}
            for c in range(1, self.num_classes):
                d = np.asarray(all_boxes[c][i]).reshape(-1, 5)
                if len(d):
                    per_cat_d[c] = d
            dets[image_id] = per_cat_d
            per_cat_g: Dict[int, dict] = {}
            for a in self.anns_by_image.get(image_id, []):
                c = self.cat_to_class[a["category_id"]]
                x, y, bw, bh = a["bbox"]
                entry = per_cat_g.setdefault(
                    c, {"boxes": [], "iscrowd": [], "area": []})
                entry["boxes"].append([x, y, x + bw, y + bh])
                entry["iscrowd"].append(bool(a.get("iscrowd", 0)))
                entry["area"].append(a.get("area", bw * bh))
            gts[image_id] = {
                c: {k: np.asarray(v) for k, v in e.items()}
                for c, e in per_cat_g.items()
            }
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._write_results_json(all_boxes, out_dir)
        return evaluate_bbox(dets, gts, list(range(1, self.num_classes)))

    def ann_rle(self, a: dict, image_id: int) -> dict:
        """An annotation's segmentation as a ``native`` RLE dict
        (pycocotools ``annToRLE``): polygons (the union of their
        fills), uncompressed RLE (counts as an int list), compressed RLE
        (a counts string), else the bbox rectangle."""
        from mx_rcnn_tpu_torch import native

        info = self.images[image_id]
        h, w = info["height"], info["width"]
        seg = a.get("segmentation")
        if isinstance(seg, list) and seg:
            return native.merge([native.from_poly(p, h, w) for p in seg])
        if isinstance(seg, dict):
            counts = seg["counts"]
            if isinstance(counts, list):  # uncompressed (crowd) RLE
                return native.from_uncompressed(seg["size"], counts)
            if isinstance(counts, str):
                counts = counts.encode()
            return {"size": list(seg["size"]), "counts": counts}
        x, y, bw, bh = a["bbox"]
        return native.from_bbox([x, y, bw, bh], h, w)

    def evaluate_segmentations(self, dets_by_image_cat,
                               out_dir: str = None) -> Dict[str, float]:
        """COCO segm AP over mask detections: ``dets_by_image_cat`` maps
        image id → {class id → list of (rle, score) pairs}, each rle a
        ``native`` RLE dict.  The ground-truth masks come from
        :meth:`ann_rle`, crowds as ignore regions; returns the bbox
        evaluator's metric dict."""
        from mx_rcnn_tpu_torch.data.coco_eval import evaluate_segm

        gts: Dict[int, dict] = {}
        for image_id in self.image_index:
            per_cat: Dict[int, dict] = {}
            for a in self.anns_by_image.get(image_id, []):
                c = self.cat_to_class[a["category_id"]]
                e = per_cat.setdefault(c, {"rles": [], "iscrowd": [],
                                           "area": []})
                e["rles"].append(self.ann_rle(a, image_id))
                e["iscrowd"].append(bool(a.get("iscrowd", 0)))
                bw, bh = a["bbox"][2], a["bbox"][3]
                e["area"].append(a.get("area", bw * bh))
            gts[image_id] = {
                c: {"rles": e["rles"],
                    "iscrowd": np.asarray(e["iscrowd"], bool),
                    "area": np.asarray(e["area"], float)}
                for c, e in per_cat.items()
            }
        return evaluate_segm(dets_by_image_cat, gts,
                             list(range(1, self.num_classes)))

    def _write_results_json(self, all_boxes, out_dir: str) -> None:
        """The standard COCO results file (xywh boxes)."""
        results = []
        class_to_cat = {v: k for k, v in self.cat_to_class.items()}
        for i, image_id in enumerate(self.image_index):
            for c in range(1, self.num_classes):
                for d in np.asarray(all_boxes[c][i]).reshape(-1, 5):
                    results.append({
                        "image_id": int(image_id),
                        "category_id": int(class_to_cat[c]),
                        "bbox": [float(d[0]), float(d[1]),
                                 float(d[2] - d[0]), float(d[3] - d[1])],
                        "score": float(d[4]),
                    })
        with open(os.path.join(out_dir, "detections_results.json"), "w") as f:
            json.dump(results, f)
