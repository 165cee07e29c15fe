"""PASCAL VOC detection AP.

Counterpart of ``mx_rcnn_tpu/data/voc_eval.py`` (the py-faster-rcnn
evaluator): score-ranked detections matched greedily to ground truth at
IoU > 0.5 with +1 pixel areas, difficult boxes excluded from both the
penalties and the positive count, AP by the VOC07 11-point
interpolation or the continuous metric.  Detections are ranked by
``np.argsort(-confidences)``, as there: another sort orders tied scores
differently and changes the AP.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False
           ) -> float:
    """AP from recall/precision curves."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(dets_by_image: Mapping, gt_by_image: Mapping[object, Dict],
             class_id: int, ovthresh: float = 0.5,
             use_07_metric: bool = True) -> float:
    """AP of one class.  ``dets_by_image``: image id → (k, 5) [x1 y1 x2 y2
    score]; ``gt_by_image``: image id → dict(boxes (n, 4), gt_classes (n,),
    difficult (n,) bool, optional)."""
    class_gt = {}
    npos = 0
    for img, rec in gt_by_image.items():
        mask = rec["gt_classes"] == class_id
        boxes = rec["boxes"][mask]
        difficult = (rec["difficult"][mask] if "difficult" in rec
                     else np.zeros(mask.sum(), bool))
        npos += int((~difficult).sum())
        class_gt[img] = dict(boxes=boxes, difficult=difficult,
                             det=np.zeros(len(boxes), bool))

    image_ids, confidences, bbs = [], [], []
    for img, dets in dets_by_image.items():
        for d in np.asarray(dets).reshape(-1, 5):
            image_ids.append(img)
            confidences.append(d[4])
            bbs.append(d[:4])
    if not image_ids:
        return 0.0
    confidences = np.asarray(confidences)
    bbs = np.asarray(bbs)
    order = np.argsort(-confidences)
    image_ids = [image_ids[i] for i in order]
    bbs = bbs[order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = class_gt.get(image_ids[d])
        bb = bbs[d]
        ovmax = -np.inf
        jmax = -1
        if rec is not None and len(rec["boxes"]):
            bbgt = rec["boxes"]
            ixmin = np.maximum(bbgt[:, 0], bb[0])
            iymin = np.maximum(bbgt[:, 1], bb[1])
            ixmax = np.minimum(bbgt[:, 2], bb[2])
            iymax = np.minimum(bbgt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (bbgt[:, 2] - bbgt[:, 0] + 1.0)
                   * (bbgt[:, 3] - bbgt[:, 1] + 1.0) - inters)
            overlaps = inters / uni
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1.0
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / max(npos, 1)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(recall, precision, use_07_metric)
