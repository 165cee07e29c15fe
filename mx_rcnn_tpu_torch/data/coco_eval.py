"""COCO bbox and segm AP, without pycocotools.

Counterpart of ``mx_rcnn_tpu/data/coco_eval.py`` (``_iou_xyxy``,
``_last_argmax``, ``_evaluate_image``, ``_match_image``,
``evaluate_bbox``, ``evaluate_segm``, ``_run_eval``), the protocol of
pycocotools' ``COCOeval`` in numpy: greedy score-ordered matching per
(category, IoU threshold), crowd annotations as ignore regions,
101-point interpolated precision averaged over IoU 0.50:0.95:0.05,
AP50/AP75, the small/medium/large breakdown and AR at 100 detections.
The matcher is vectorised over the 10 thresholds.  Segm mode takes its
IoUs and areas from RLE masks (``native/``) and shares the matcher and
the accumulation with bbox mode, as pycocotools' iouType switch does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_xyxy(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray
              ) -> np.ndarray:
    """IoU matrix (D, G); for crowd gt, IoU = intersection / det area
    (pycocotools semantics)."""
    d = dets[:, None, :]
    g = gts[None, :, :]
    iw = np.minimum(d[..., 2], g[..., 2]) - np.maximum(d[..., 0], g[..., 0])
    ih = np.minimum(d[..., 3], g[..., 3]) - np.maximum(d[..., 1], g[..., 1])
    iw = np.maximum(iw, 0.0)
    ih = np.maximum(ih, 0.0)
    inter = iw * ih
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _last_argmax(a: np.ndarray) -> np.ndarray:
    """Row-wise argmax returning the LAST index among ties — the greedy
    matcher's update rule (`iou < best → continue; best ← iou` updates on
    equality, so a later gt with equal IoU wins)."""
    n = a.shape[1]
    return n - 1 - np.argmax(a[:, ::-1], axis=1)


def _evaluate_image(dets: np.ndarray, gt_boxes: np.ndarray,
                    gt_ignore: np.ndarray, iscrowd: np.ndarray,
                    max_dets: int, ious: np.ndarray = None):
    """Match one image's detections for all IoU thresholds at once.

    Semantics are the pycocotools greedy matcher
    (``cocoeval.py — evaluateImg``), vectorized over the 10 IoU thresholds
    and the gt axis; only the (data-dependent) loop over detections remains,
    and it skips detections whose best IoU can't reach the lowest threshold.
    The reference loop's rules:
      * gts sorted real-first / ignored-last; a det prefers ANY real match
        over a higher-IoU ignored match (the transcription's break),
      * equal-IoU ties go to the later gt index,
      * used non-crowd gts leave the candidate pool; crowd gts can absorb
        any number of detections.

    ``ious``: optional precomputed (D_sorted, G_unsorted) matrix (crowd
    semantics applied) — lets the caller share it across area ranges.
    Returns (det_scores (D,), det_matched (T, D), det_ignore (T, D),
    num_gt_not_ignored).
    """
    order = np.argsort(-dets[:, 4], kind="mergesort")[:max_dets]
    dets = dets[order]
    if len(gt_boxes) and len(dets) and ious is None:
        ious = _iou_xyxy(dets[:, :4], gt_boxes, iscrowd)
    elif ious is not None:
        ious = ious[:max_dets]
    matched, ignored = _match_image(ious, len(gt_boxes), gt_ignore, iscrowd,
                                    len(dets))
    return dets[:, 4], matched, ignored, int((~gt_ignore).sum())


def _match_image(ious, ngt: int, gt_ignore: np.ndarray, iscrowd: np.ndarray,
                 nd: int):
    """The matcher core for one image: ``ious`` is the (D_sorted, G) matrix
    over score-sorted capped detections and UNSORTED gts (None when either
    side is empty).  Returns (matched (T, D), ignored (T, D))."""
    t = len(IOU_THRS)
    matched = np.zeros((t, nd), bool)
    ignored = np.zeros((t, nd), bool)
    if ngt and nd:
        # sort gt: real first, ignored last (pycocotools order)
        gt_order = np.argsort(gt_ignore, kind="mergesort")
        gt_ignore_s = gt_ignore[gt_order]
        crowd_s = iscrowd[gt_order]
        ious = ious[:, gt_order]
        n_real = int((~gt_ignore_s).sum())
        thr_e = np.minimum(IOU_THRS, 1 - 1e-10)  # (T,)
        gt_used = np.zeros((t, ngt), bool)
        # a det whose best IoU is below the lowest threshold can never
        # match — skip it (matched/ignored stay False)
        for di in np.nonzero(ious.max(axis=1) >= thr_e[0])[0]:
            avail = ~gt_used | crowd_s[None, :]           # (T, G)
            vals = np.where(avail, ious[di][None, :], -1.0)
            if n_real:
                best_rv = vals[:, :n_real].max(axis=1)
                best_ri = _last_argmax(vals[:, :n_real])
            else:
                best_rv = np.full(t, -1.0)
                best_ri = np.zeros(t, np.intp)
            if ngt > n_real:
                best_iv = vals[:, n_real:].max(axis=1)
                best_ii = n_real + _last_argmax(vals[:, n_real:])
            else:
                best_iv = np.full(t, -1.0)
                best_ii = np.zeros(t, np.intp)
            has_r = best_rv >= thr_e
            has_i = ~has_r & (best_iv >= thr_e)
            chosen = np.where(has_r, best_ri,
                              np.where(has_i, best_ii, -1))
            sel = chosen >= 0
            gt_used[np.nonzero(sel)[0], chosen[sel]] = True
            matched[:, di] = sel
            ignored[:, di] = has_i
    return matched, ignored


def evaluate_bbox(
    dets_by_image_cat: Mapping[str, Mapping[int, np.ndarray]],
    gt_by_image_cat: Mapping[str, Mapping[int, Dict]],
    categories: Sequence[int],
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO bbox AP.

    Args:
      dets_by_image_cat: image id → {category → (k, 5) [x1 y1 x2 y2 score]}.
      gt_by_image_cat: image id → {category → dict(boxes (n, 4),
        iscrowd (n,) bool, area (n,))}; area defaults to box area.
      categories: category ids to evaluate.
    Returns dict with AP, AP50, AP75, AP_small/medium/large, AR_100.
    """
    def fetch(img, cat):
        gt = gt_by_image_cat[img].get(cat)
        if gt is None:
            gt_boxes = np.zeros((0, 4))
            iscrowd = np.zeros((0,), bool)
            areas = np.zeros((0,))
        else:
            gt_boxes = np.asarray(gt["boxes"]).reshape(-1, 4)
            iscrowd = np.asarray(
                gt.get("iscrowd", np.zeros(len(gt_boxes), bool)), bool)
            areas = np.asarray(gt.get(
                "area",
                (gt_boxes[:, 2] - gt_boxes[:, 0])
                * (gt_boxes[:, 3] - gt_boxes[:, 1])))
        dets = dets_by_image_cat.get(img, {}).get(cat)
        dets = (np.asarray(dets).reshape(-1, 5) if dets is not None
                else np.zeros((0, 5)))
        if len(dets) == 0 and len(gt_boxes) == 0:
            return None
        order = np.argsort(-dets[:, 4], kind="mergesort")[:max_dets]
        dets_s = dets[order]
        ious = (_iou_xyxy(dets_s[:, :4], gt_boxes, iscrowd)
                if len(gt_boxes) and len(dets_s) else None)
        d_area = (dets_s[:, 2] - dets_s[:, 0]) \
            * (dets_s[:, 3] - dets_s[:, 1])
        return dets_s[:, 4], d_area, ious, gt_boxes.shape[0], areas, iscrowd

    return _run_eval(list(gt_by_image_cat.keys()), categories, fetch)


def evaluate_segm(
    dets_by_image_cat: Mapping[str, Mapping[int, Sequence]],
    gt_by_image_cat: Mapping[str, Mapping[int, Dict]],
    categories: Sequence[int],
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO segmentation (mask) AP: :func:`evaluate_bbox`'s protocol with
    mask IoUs (pycocotools' iouType='segm').

    ``dets_by_image_cat``: image id → {category → list of (rle, score)
    pairs}, each ``rle`` a ``native`` RLE dict.  ``gt_by_image_cat``:
    image id → {category → dict(rles (n,), iscrowd (n,) bool, area (n,),
    optional: the masks' areas by default)}.  Returns the metric dict of
    :func:`evaluate_bbox`."""
    from mx_rcnn_tpu_torch import native

    def fetch(img, cat):
        gt = gt_by_image_cat[img].get(cat)
        if gt is None:
            gt_rles, iscrowd, areas = [], np.zeros(0, bool), np.zeros(0)
        else:
            gt_rles = list(gt["rles"])
            iscrowd = np.asarray(
                gt.get("iscrowd", np.zeros(len(gt_rles), bool)), bool)
            areas = np.asarray(
                gt["area"] if "area" in gt
                else [native.area(r) for r in gt_rles], float)
        dets = dets_by_image_cat.get(img, {}).get(cat) or []
        if not dets and not gt_rles:
            return None
        scores = np.asarray([s for _, s in dets], float)
        order = np.argsort(-scores, kind="mergesort")[:max_dets]
        d_rles = [dets[i][0] for i in order]
        d_scores = scores[order]
        d_area = np.asarray([native.area(r) for r in d_rles], float)
        ious = None
        if d_rles and gt_rles:
            ious = native.iou_matrix(d_rles, gt_rles, iscrowd)
        return d_scores, d_area, ious, len(gt_rles), areas, iscrowd

    return _run_eval(list(gt_by_image_cat.keys()), categories, fetch)


def _run_eval(images, categories, fetch) -> Dict[str, float]:
    """The eval loop: per (image, cat) ``fetch`` returns
    (det_scores SORTED desc + capped, det_areas, ious (D, G)|None, n_gt,
    gt_areas, iscrowd) or None when the image has neither dets nor gts;
    then matching per area range and the 101-point accumulation
    (pycocotools ``evaluate``/``accumulate``)."""
    t = len(IOU_THRS)
    precisions = {k: [] for k in AREA_RANGES}  # per (cat): (T, 101) arrays
    recalls = {k: [] for k in AREA_RANGES}

    for cat in categories:
        # one pass over images: the IoU matrix is computed ONCE per
        # (image, cat) — gt sorting and matching differ per area range,
        # the IoUs do not (crowd semantics are area-independent)
        acc = {k: dict(scores=[], matched=[], ignored=[], npos=0)
               for k in AREA_RANGES}
        for img in images:
            got = fetch(img, cat)
            if got is None:
                continue
            scores, d_area, ious, n_gt, areas, iscrowd = got
            for area_name, (lo, hi) in AREA_RANGES.items():
                gt_ignore = iscrowd | (areas < lo) | (areas >= hi)
                m, ig = _match_image(ious, n_gt, gt_ignore, iscrowd,
                                     len(scores))
                # detections outside the area range that match nothing are
                # ignored too (pycocotools marks unmatched out-of-range dets)
                oor = (d_area < lo) | (d_area >= hi)
                ig = ig | (~m & oor[None, :])
                a = acc[area_name]
                a["scores"].append(scores)
                a["matched"].append(m)
                a["ignored"].append(ig)
                a["npos"] += int((~gt_ignore).sum())
        for area_name in AREA_RANGES:
            a = acc[area_name]
            npos = a["npos"]
            if npos == 0:
                continue
            scores = (np.concatenate(a["scores"]) if a["scores"]
                      else np.zeros(0))
            matched = (np.concatenate(a["matched"], axis=1) if a["matched"]
                       else np.zeros((t, 0), bool))
            ignored = (np.concatenate(a["ignored"], axis=1) if a["ignored"]
                       else np.zeros((t, 0), bool))
            order = np.argsort(-scores, kind="mergesort")
            matched = matched[:, order]
            ignored = ignored[:, order]
            prec_interp = np.zeros((t, len(RECALL_THRS)))
            rec_final = np.zeros(t)
            for ti in range(t):
                keep = ~ignored[ti]
                tps = np.cumsum(matched[ti][keep])
                fps = np.cumsum(~matched[ti][keep])
                rec = tps / npos
                prec = tps / np.maximum(tps + fps, 1e-12)
                # precision envelope: monotonically non-increasing, sampled
                # at the 101 recall points (pycocotools accumulate)
                prec = np.maximum.accumulate(prec[::-1])[::-1]
                idx = np.searchsorted(rec, RECALL_THRS, side="left")
                valid = idx < len(prec)
                prec_interp[ti, valid] = prec[idx[valid]]
                rec_final[ti] = rec[-1] if len(rec) else 0.0
            precisions[area_name].append(prec_interp)
            recalls[area_name].append(rec_final)

    def mean_ap(area: str, thr_idx=None) -> float:
        ps = precisions[area]
        if not ps:
            return float("nan")
        arr = np.stack(ps)  # (cats, T, 101)
        if thr_idx is not None:
            arr = arr[:, thr_idx:thr_idx + 1]
        return float(arr.mean())

    out = {
        "AP": mean_ap("all"),
        "AP50": mean_ap("all", 0),
        "AP75": mean_ap("all", 5),
        "AP_small": mean_ap("small"),
        "AP_medium": mean_ap("medium"),
        "AP_large": mean_ap("large"),
    }
    if recalls["all"]:
        out["AR_100"] = float(np.stack(recalls["all"]).mean())
    return out
