"""The port's COCO bbox and segm evaluators held against the JAX
package's.

``evaluate_bbox`` must give the JAX function's numbers exactly (AP,
AP50, AP75, AP by area and AR_100; nan where both give nan) on seeded
random scenes with crowds, ignored areas, tied scores and tied IoUs;
the matcher agrees with the JAX one and with the loop transcription of
pycocotools' ``evaluateImg`` in ``tests/test_coco_eval.py``; and the
worked goldens of that file hold for the port.  ``evaluate_segm`` and
``COCODataset.evaluate_segmentations`` give the JAX functions' numbers
exactly on a generated COCO tree whose annotations are polygons,
compressed and uncompressed RLE (crowds) and bare boxes, with the JAX
masks on its NumPy path and on its C++ library.
"""

import numpy as np
import pytest

from mx_rcnn_tpu.data import coco_eval as jce
from mx_rcnn_tpu_torch.data import coco_eval as tce
from tests.test_coco_eval import _evaluate_image_transcription


def _scene(rng, n_images=6, n_cats=4):
    """Seeded per-image, per-category gts and detections: jittered hits
    on a coarse grid (tied IoUs), misses, crowds, small and large boxes,
    scores rounded to a few levels (tied scores)."""
    dets, gts = {}, {}
    for img in range(n_images):
        dets[img], gts[img] = {}, {}
        for cat in range(1, n_cats + 1):
            ngt = rng.randint(0, 5)
            xy = rng.randint(0, 300, (ngt, 2)).astype(float)
            wh = rng.choice([8, 20, 45, 120, 200], (ngt, 2)).astype(float)
            boxes = np.hstack([xy, xy + wh])
            if ngt:
                gts[img][cat] = dict(
                    boxes=boxes, iscrowd=rng.uniform(size=ngt) < 0.15,
                    area=wh.prod(1) * rng.choice([0.6, 1.0], ngt))
            rows = []
            for b in boxes:
                for _ in range(rng.randint(0, 3)):
                    rows.append(np.r_[b + rng.randint(-5, 6, 4),
                                      np.round(rng.uniform(), 1)])
            for _ in range(rng.randint(0, 4)):
                x, y = rng.randint(0, 300, 2)
                w, h = rng.randint(5, 150, 2)
                rows.append([x, y, x + w, y + h, np.round(rng.uniform(), 1)])
            if rows:
                dets[img][cat] = np.asarray(rows, float)
    return dets, gts


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("max_dets", [100, 3])
def test_evaluate_bbox_equals_jax(seed, max_dets):
    dets, gts = _scene(np.random.RandomState(seed))
    cats = [1, 2, 3, 4, 5]          # category 5 has no gt and no detection
    got = tce.evaluate_bbox(dets, gts, cats, max_dets=max_dets)
    want = jce.evaluate_bbox(dets, gts, cats, max_dets=max_dets)
    assert list(got) == list(want) == ["AP", "AP50", "AP75", "AP_small",
                                       "AP_medium", "AP_large", "AR_100"]
    np.testing.assert_equal(got, want)
    assert np.isfinite(got["AP"])


@pytest.mark.parametrize("seed", range(6))
def test_matcher_equals_jax_and_the_transcription(seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(10):
        ngt = rng.randint(0, 7)
        gt = rng.randint(0, 60, (ngt, 2)).astype(float)
        gt = np.hstack([gt, gt + 10 + rng.randint(0, 30, (ngt, 2))])
        rows = [np.r_[g + rng.randint(-6, 7, 4), rng.rand()]
                for g in gt for _ in range(rng.randint(0, 3))]
        rows += [np.r_[x, y, x + rng.randint(5, 40), y + rng.randint(5, 40),
                       rng.rand()]
                 for x, y in rng.randint(0, 50, (rng.randint(0, 12), 2))]
        dets = np.asarray(rows, float).reshape(-1, 5)
        crowd = rng.rand(ngt) < 0.25
        ignore = crowd | (rng.rand(ngt) < 0.25)
        max_dets = rng.choice([3, 100])
        got = tce._evaluate_image(dets, gt, ignore, crowd, max_dets)
        for want in (jce._evaluate_image(dets, gt, ignore, crowd, max_dets),
                     _evaluate_image_transcription(dets, gt, ignore, crowd,
                                                   max_dets)):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_iou_and_last_argmax_equal_jax():
    rng = np.random.RandomState(0)
    d = np.sort(rng.randint(0, 50, (7, 4)).astype(float).reshape(7, 2, 2),
                1).transpose(0, 2, 1).reshape(7, 4)[:, [0, 2, 1, 3]]
    g = d[rng.permutation(7)][:5] + rng.randint(-3, 4, (5, 4))
    crowd = np.array([False, True, False, False, True])
    np.testing.assert_array_equal(tce._iou_xyxy(d, g, crowd),
                                  jce._iou_xyxy(d, g, crowd))
    a = rng.randint(0, 3, (6, 5)).astype(float)
    np.testing.assert_array_equal(tce._last_argmax(a), jce._last_argmax(a))


# ---- the worked goldens of tests/test_coco_eval.py, through the port ------

_GT = {0: {1: dict(boxes=np.array([[10.0, 10.0, 50.0, 50.0]]))}}
_FP_TP = {0: {1: np.array([[200.0, 200.0, 240.0, 240.0, 0.9],
                           [10.0, 10.0, 50.0, 50.0, 0.8]])}}
_TP_FP = {0: {1: np.array([[10.0, 10.0, 50.0, 50.0, 0.9],
                           [200.0, 200.0, 240.0, 240.0, 0.8]])}}


@pytest.mark.parametrize("dets,max_dets,key,want", [
    (_FP_TP, 100, "AP", 0.5), (_FP_TP, 100, "AP50", 0.5),
    (_FP_TP, 100, "AR_100", 1.0), (_TP_FP, 100, "AP", 1.0),
    (_FP_TP, 1, "AP", 0.0), (_FP_TP, 2, "AP", 0.5)])
def test_golden_ranking_cases(dets, max_dets, key, want):
    """A fp above a tp: precision 0.5 everywhere; a fp below: AP 1; a cap
    of 1 keeps only the fp: AP 0."""
    got = tce.evaluate_bbox(dets, _GT, [1], max_dets=max_dets)
    assert abs(got[key] - want) < 1e-9
    np.testing.assert_equal(
        got, jce.evaluate_bbox(dets, _GT, [1], max_dets=max_dets))


def test_golden_real_match_preferred_over_higher_iou_ignored():
    real, big = [0.0, 0.0, 99.0, 9.0], [0.0, 0.0, 99.0, 99.0]
    gts = np.array([real, big])
    ignore, crowd = np.array([False, True]), np.zeros(2, bool)
    # IoU 0.111 with the real gt, 0.8 with the ignored one: matched,
    # ignored at thresholds up to 0.8
    _, m, ig, _ = tce._evaluate_image(np.array([[0.0, 0.0, 99.0, 80.0, 0.9]]),
                                      gts, ignore, crowd, 100)
    assert ig[0, 0] and m[0, 0]
    # IoU 0.529 with the real gt: the real match wins at 0.5
    _, m, ig, _ = tce._evaluate_image(np.array([[0.0, 0.0, 99.0, 17.0, 0.9]]),
                                      gts, ignore, crowd, 100)
    assert m[0, 0] and not ig[0, 0]


def test_golden_equal_iou_tie_goes_to_later_gt():
    gt = np.array([[0.0, 0.0, 9.0, 9.0], [0.0, 0.0, 9.0, 9.0]])
    dets = np.array([[0.0, 0.0, 9.0, 9.0, 0.9], [0.0, 0.0, 9.0, 9.0, 0.8]])
    none = np.zeros(2, bool)
    _, m, _, _ = tce._evaluate_image(dets, gt, none, none, 100)
    assert m[:, 0].all() and m[:, 1].all()
    np.testing.assert_array_equal(
        _evaluate_image_transcription(dets, gt, none, none, 100)[1], m)


# ---- segm mode ----------------------------------------------------------------


def _blob(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
    m[y:y + rng.randint(3, h // 2), x:x + rng.randint(3, w // 2)] = 1
    if rng.rand() < 0.5:
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        m[y:y + rng.randint(2, 12), x:x + rng.randint(2, 12)] = 1
    return m


def _segm_tree(root, seed, n_images=5, h=60, w=80):
    """A COCO tree's annotation file (the evaluator reads no pixel):
    categories 3, 9, 12; per image a few annotations, each a polygon, a
    compressed RLE, an uncompressed crowd RLE or a bare box; and the
    detections (rle, score) per (image, class): jittered copies of the
    gt masks and random false positives, scores on a few levels."""
    import json
    import os

    from mx_rcnn_tpu_torch import native

    rng = np.random.RandomState(seed)
    cats = [{"id": c, "name": f"c{c}"} for c in (3, 9, 12)]
    images, anns, dets = [], [], {}
    for i in range(n_images):
        iid = 10 + i
        images.append({"id": iid, "file_name": f"{iid}.jpg", "width": w,
                       "height": h})
        dets[iid] = {}
        for _ in range(rng.randint(1, 5)):
            cat = cats[rng.randint(0, 3)]["id"]
            kind = rng.randint(0, 4)
            m = _blob(rng, h, w)
            ys, xs = np.nonzero(m)
            bbox = [float(xs.min()), float(ys.min()),
                    float(xs.max() - xs.min() + 1),
                    float(ys.max() - ys.min() + 1)]
            a = {"id": len(anns) + 1, "image_id": iid, "category_id": cat,
                 "bbox": bbox, "iscrowd": 0}
            if kind == 0:      # polygons: the blob's box and a triangle
                x0, y0, bw, bh = bbox
                a["segmentation"] = [
                    [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh],
                    [x0, y0, x0 + bw / 2, y0 + bh + 5.5, x0 - 3.25,
                     y0 + bh]]
            elif kind == 1:    # compressed RLE, counts as a str
                r = native.encode(m)
                a["segmentation"] = {"size": [h, w],
                                     "counts": r["counts"].decode()}
                a["area"] = float(m.sum())
            elif kind == 2:    # a crowd region, uncompressed RLE
                r = native.encode(m)
                a["segmentation"] = {"size": [h, w], "counts": [
                    int(c) for c in native._string_to_counts(r["counts"])]}
                a["iscrowd"] = 1
            # kind 3: no segmentation, the box stands in
            anns.append(a)
            cls = 1 + [c["id"] for c in cats].index(cat)
            for _ in range(rng.randint(0, 3)):
                jm = np.roll(m, (rng.randint(-3, 4), rng.randint(-3, 4)),
                             (0, 1))
                dets[iid].setdefault(cls, []).append(
                    (native.encode(jm), float(np.round(rng.rand(), 1))))
        for _ in range(rng.randint(0, 3)):
            cls = rng.randint(1, 4)
            dets[iid].setdefault(cls, []).append(
                (native.encode(_blob(rng, h, w)),
                 float(np.round(rng.rand(), 1))))
    ds = os.path.join(str(root), "coco")
    os.makedirs(os.path.join(ds, "annotations"), exist_ok=True)
    with open(os.path.join(ds, "annotations", "instances_val2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return ds, dets


@pytest.fixture(params=["numpy", "native"])
def jax_masks(request, monkeypatch):
    """The JAX package's RLE module on its NumPy path or its C++ one."""
    from mx_rcnn_tpu import native as jnative

    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert jnative.ensure_built()
    return request.param


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_segmentations_equals_jax(tmp_path, seed, jax_masks):
    from mx_rcnn_tpu.data.coco import COCODataset as JCOCO
    from mx_rcnn_tpu_torch.data.coco import COCODataset as TCOCO

    ds, dets = _segm_tree(tmp_path, seed)
    t = TCOCO("val2017", str(tmp_path), ds)
    j = JCOCO("val2017", str(tmp_path), ds)
    for iid in t.image_index:
        for a in t.anns_by_image.get(iid, []):
            assert t.ann_rle(a, iid) == j.ann_rle(a, iid)
    got = t.evaluate_segmentations(dets)
    want = j.evaluate_segmentations(dets)
    assert list(got) == list(want)
    np.testing.assert_equal(got, want)
    assert np.isfinite(got["AP"])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_dets", [100, 2])
def test_evaluate_segm_equals_jax(seed, max_dets, jax_masks):
    """The function itself, with gts given with and without areas and a
    category neither side has."""
    from mx_rcnn_tpu_torch import native

    rng = np.random.RandomState(100 + seed)
    h, w = 48, 40
    dets, gts = {}, {}
    for img in range(4):
        dets[img], gts[img] = {}, {}
        for cat in (1, 2, 3):
            n = rng.randint(0, 4)
            masks = [_blob(rng, h, w) for _ in range(n)]
            if n:
                g = {"rles": [native.encode(m) for m in masks],
                     "iscrowd": rng.rand(n) < 0.25}
                if rng.rand() < 0.5:
                    g["area"] = np.asarray([m.sum() for m in masks],
                                           float) * rng.choice([0.5, 1], n)
                gts[img][cat] = g
            rows = [(native.encode(np.roll(m, rng.randint(-2, 3), 1)),
                     float(np.round(rng.rand(), 1))) for m in masks]
            rows += [(native.encode(_blob(rng, h, w)),
                      float(np.round(rng.rand(), 1)))
                     for _ in range(rng.randint(0, 3))]
            if rows:
                dets[img][cat] = rows
    got = tce.evaluate_segm(dets, gts, [1, 2, 3, 4], max_dets=max_dets)
    want = jce.evaluate_segm(dets, gts, [1, 2, 3, 4], max_dets=max_dets)
    assert list(got) == list(want)
    np.testing.assert_equal(got, want)
