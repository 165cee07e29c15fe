"""The port's COCO bbox evaluator held against the JAX package's.

``evaluate_bbox`` must give the JAX function's numbers exactly (AP,
AP50, AP75, AP by area and AR_100; nan where both give nan) on seeded
random scenes with crowds, ignored areas, tied scores and tied IoUs;
the matcher agrees with the JAX one and with the loop transcription of
pycocotools' ``evaluateImg`` in ``tests/test_coco_eval.py``; and the
worked goldens of that file hold for the port.
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
