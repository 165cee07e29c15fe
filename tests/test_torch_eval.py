"""The port's evaluation path held against the JAX package's on the CPU.

``voc_eval``/``voc_ap`` on seeded detections, ``pred_eval`` on the same
raw network outputs, ``test_rcnn`` end to end from one checkpoint, and
``reeval`` of each package's saved detections by the other.  Everything
runs in fp32 at the tiny size (the synthetic set, 4 classes, scale 128,
max 160).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.core.tester import pred_eval as j_pred_eval
from mx_rcnn_tpu.data import TestLoader as JTestLoader
from mx_rcnn_tpu.data import load_gt_roidb as j_load_gt_roidb
from mx_rcnn_tpu.data.voc_eval import voc_ap as j_voc_ap
from mx_rcnn_tpu.data.voc_eval import voc_eval as j_voc_eval
from mx_rcnn_tpu.tools.reeval import reeval as j_reeval
from mx_rcnn_tpu.tools.test import test_rcnn as j_test_rcnn
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core import train as ttrain
from mx_rcnn_tpu_torch.core.tester import im_detect_batch, pred_eval
from mx_rcnn_tpu_torch.data import load_gt_roidb
from mx_rcnn_tpu_torch.data.loader import TestLoader as PortTestLoader
from mx_rcnn_tpu_torch.data.voc_eval import voc_ap, voc_eval
from mx_rcnn_tpu_torch.tools.reeval import reeval
from mx_rcnn_tpu_torch.tools.test import test_rcnn as port_test_rcnn
from mx_rcnn_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

_TOY = dict(dataset__num_classes=4, bucket__scale=128, bucket__max_size=160,
            bucket__shapes=((128, 160), (160, 128)),
            test__rpn_pre_nms_top_n=256, test__rpn_post_nms_top_n=32)


def _configs(tmp_path, **extra):
    """The same toy config in both packages; the JAX one caches its
    synthetic PNGs under ``tmp_path``."""
    kw = dict(_TOY, **extra)
    jcfg = j_generate_config("tiny", "synthetic", **kw)
    jcfg = jcfg.replace_in("dataset", root_path=str(tmp_path),
                           dataset_path=str(tmp_path / "synthetic"))
    return jcfg, generate_config("tiny", "synthetic", **kw)


# ---- voc_eval --------------------------------------------------------------

def _detections(seed: int, n_images=6, tied=False):
    """Seeded gt (some difficult) and detections around it: jittered hits,
    duplicates and misses, scores rounded to a few levels when ``tied``."""
    rng = np.random.RandomState(seed)
    gt, dets = {}, {}
    for i in range(n_images):
        k = rng.randint(0, 5)
        xy = rng.uniform(0, 200, (k, 2))
        boxes = np.hstack([xy, xy + rng.uniform(10, 80, (k, 2))])
        gt[i] = dict(boxes=boxes.astype(np.float32),
                     gt_classes=rng.randint(1, 3, k).astype(np.int32),
                     difficult=rng.uniform(size=k) < 0.2)
        m = rng.randint(0, 8)
        pick = rng.randint(0, max(k, 1), m)
        d = (boxes[pick] if k else rng.uniform(0, 200, (m, 4))) + \
            rng.normal(0, 6, (m, 4))
        scores = rng.uniform(size=(m, 1))
        if tied:
            scores = np.round(scores * 4) / 4
        dets[i] = np.hstack([d, scores]).astype(np.float32)
    return dets, gt


@pytest.mark.parametrize("seed,tied,use_07", [
    (0, False, True), (1, True, True), (2, True, False), (3, False, False),
    (4, True, True)])
def test_voc_eval_equals_jax(seed, tied, use_07):
    dets, gt = _detections(seed, tied=tied)
    for c in (1, 2):
        got = voc_eval(dets, gt, c, use_07_metric=use_07)
        want = j_voc_eval(dets, gt, c, use_07_metric=use_07)
        assert got == want, (c, got, want)
    assert voc_eval({}, gt, 1) == 0.0


def test_voc_ap_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(10):
        rec = np.sort(rng.uniform(size=12))
        prec = rng.uniform(size=12)
        for use_07 in (True, False):
            assert voc_ap(rec, prec, use_07) == j_voc_ap(rec, prec, use_07)


# ---- pred_eval on the same raw outputs --------------------------------------

class _RawPredictor:
    """Seeded raw outputs per roidb image, from numpy: rois inside the
    image (the first ``k`` on its gt boxes, others jittered copies),
    random softmax scores and small deltas; ``to`` makes torch tensors or
    jnp arrays of them."""

    def __init__(self, roidb, num_classes, to, r=24, seed=0):
        self.roidb, self.c, self.to, self.r = roidb, num_classes, to, r
        self.seed = seed
        self._cursor = 0

    def raw(self, images, im_info):
        n = images.shape[0]
        out = [np.zeros((n, self.r, 4), np.float32),
               np.zeros((n, self.r), bool),
               np.zeros((n, self.r, self.c), np.float32),
               np.zeros((n, self.r, 4 * self.c), np.float32)]
        for j in range(n):
            rec = self.roidb[self._cursor + j]
            rng = np.random.RandomState(self.seed + self._cursor + j)
            scale = float(np.asarray(im_info)[j, 2])
            gt = rec["boxes"][rng.randint(0, len(rec["boxes"]), self.r)]
            rois = (gt + rng.normal(0, 8, gt.shape)) * scale
            out[0][j] = np.clip(rois, 0, [rec["width"] * scale - 1,
                                          rec["height"] * scale - 1] * 2)
            out[1][j] = rng.uniform(size=self.r) < 0.9
            logits = rng.normal(0, 2, (self.r, self.c))
            e = np.exp(logits - logits.max(-1, keepdims=True))
            out[2][j] = e / e.sum(-1, keepdims=True)
            out[3][j] = rng.normal(0, 0.1, (self.r, 4 * self.c))
        self._cursor += n
        return tuple(self.to(x) for x in out)

    def raw_batch(self, batch):
        return self.raw(batch.images, batch.im_info)


class _PerfectPredictor(_RawPredictor):
    """Every gt box with an almost one-hot, distinct score: mAP 1."""

    def raw(self, images, im_info):
        n = images.shape[0]
        rois = np.zeros((n, self.r, 4), np.float32)
        valid = np.zeros((n, self.r), bool)
        prob = np.zeros((n, self.r, self.c), np.float32)
        prob[:, :, 0] = 1.0
        for j in range(n):
            rec = self.roidb[self._cursor + j]
            k = len(rec["boxes"])
            rois[j, :k] = rec["boxes"] * float(np.asarray(im_info)[j, 2])
            valid[j, :k] = True
            for t in range(k):
                prob[j, t] = 0.0
                prob[j, t, rec["gt_classes"][t]] = 0.95 - 0.01 * t
        self._cursor += n
        return (rois, valid, prob,
                np.zeros((n, self.r, 4 * self.c), np.float32))


def _load_dets(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same_detections(got, want, atol=1e-4):
    """Equal counts per (class, image), boxes within ``atol`` px, equal
    scores, equal class lists."""
    assert list(got["classes"]) == list(want["classes"])
    assert len(got["all_boxes"]) == len(want["all_boxes"])
    total = 0
    for c, (gc, wc) in enumerate(zip(got["all_boxes"], want["all_boxes"])):
        assert len(gc) == len(wc)
        for i, (g, w) in enumerate(zip(gc, wc)):
            assert g.shape == w.shape, (c, i, g.shape, w.shape)
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0,
                                       atol=atol, err_msg=str((c, i)))
            np.testing.assert_array_equal(g[:, 4], w[:, 4])
            total += len(g)
    return total


@pytest.mark.parametrize("max_per_image,batch", [(100, 1), (5, 2)])
def test_pred_eval_on_the_same_raw_outputs_equals_jax(max_per_image, batch,
                                                      tmp_path):
    """The same rois, scores and deltas through both packages' ``pred_eval``
    (the port's plain NMS sweep, the JAX package's jnp one): equal counts
    per (class, image), boxes within 1e-4 px, equal mAP.  At
    ``max_per_image`` 5 the cap cuts most images."""
    jcfg, cfg = _configs(tmp_path, test__max_per_image=max_per_image,
                         test__batch_images=batch)
    kw = dict(num_images=6)
    jimdb, jroidb = j_load_gt_roidb(jcfg, training=False, **kw)
    imdb, roidb = load_gt_roidb(cfg, training=False, **kw)
    want = j_pred_eval(_RawPredictor(jroidb, 4, jnp.asarray),
                       JTestLoader(jroidb, jcfg, num_workers=0), jimdb, jcfg,
                       verbose=False, save_dets=str(tmp_path / "j.pkl"))
    got = pred_eval(_RawPredictor(roidb, 4, torch.from_numpy),
                    PortTestLoader(roidb, cfg, imdb.load_image), imdb, cfg,
                    verbose=False, save_dets=str(tmp_path / "t.pkl"))
    total = _assert_same_detections(_load_dets(tmp_path / "t.pkl"),
                                    _load_dets(tmp_path / "j.pkl"))
    assert total > 0
    if max_per_image == 5:
        per_image = [sum(len(c[i]) for c in
                         _load_dets(tmp_path / "t.pkl")["all_boxes"])
                     for i in range(6)]
        assert max(per_image) == 5
    assert got == want


def test_pred_eval_perfect_predictor_scores_map_1(tmp_path):
    _, cfg = _configs(tmp_path)
    imdb, roidb = load_gt_roidb(cfg, training=False, num_images=6,
                                image_size=(128, 160))
    results = pred_eval(_PerfectPredictor(roidb, 4, None),
                        PortTestLoader(roidb, cfg, imdb.load_image), imdb, cfg,
                        verbose=False)
    assert results["mAP"] == pytest.approx(1.0)


def test_test_loader_batches_equal_jax(tmp_path):
    """Same (Batch, indices, scales) as the JAX loader over its PNG-cached
    roidb: two buckets, a short last batch."""
    jcfg, cfg = _configs(tmp_path, test__batch_images=2)
    kw = dict(num_images=6, image_size=(128, 160))
    jimdb, jroidb = j_load_gt_roidb(jcfg, training=False, **kw)
    imdb, roidb = load_gt_roidb(cfg, training=False, **kw)
    # one portrait image: a second bucket
    for rb in (jroidb, roidb):
        rb[2] = dict(rb[2], height=160, width=128)
    jroidb[2]["image"] = str(tmp_path / "portrait.png")
    img = np.ascontiguousarray(np.random.RandomState(0).randint(
        0, 255, (160, 128, 3)).astype(np.uint8))
    import cv2

    cv2.imwrite(jroidb[2]["image"], img[:, :, ::-1])
    read = lambda rec: img if rec["height"] == 160 else imdb.load_image(rec)
    jl = list(JTestLoader(jroidb, jcfg, num_workers=0, raw_images=True))
    tl = list(PortTestLoader(roidb, cfg, read))
    assert len(tl) == len(jl) == len(PortTestLoader(roidb, cfg, read)) == 4
    for (tb, ti, ts), (jb, ji, js) in zip(tl, jl):
        assert ti == ji
        np.testing.assert_array_equal(ts, js)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_im_detect_batch_equals_jax():
    from mx_rcnn_tpu.core.tester import im_detect_batch as j_im_detect_batch

    cfg = generate_config("tiny", "synthetic")
    jcfg = j_generate_config("tiny", "synthetic")
    rng = np.random.RandomState(0)
    rois = np.sort(rng.uniform(0, 150, (2, 8, 4)).astype(np.float32), -1)
    args = (rois, rng.uniform(size=(2, 8)) < 0.8,
            rng.uniform(size=(2, 8, 4)).astype(np.float32),
            rng.normal(0, 0.2, (2, 8, 16)).astype(np.float32),
            np.array([[120, 150, 0.5], [100, 160, 0.4]], np.float32),
            np.array([0.5, 0.4], np.float32))
    for (gb, gs), (wb, ws) in zip(im_detect_batch(*args, cfg),
                                  j_im_detect_batch(*args, jcfg)):
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(gs, ws)


# ---- test_rcnn end to end, and reeval --------------------------------------

@pytest.fixture
def checkpoint(tmp_path):
    """A port checkpoint of the tiny network for the toy config, with
    random weights from a seed."""
    _, cfg = _configs(tmp_path)
    prefix = str(tmp_path / "e2e")
    save_checkpoint(prefix, 1, ttrain.setup_training(cfg, "cpu", seed=4))
    return prefix


def test_test_rcnn_equals_jax_from_one_checkpoint(checkpoint, tmp_path):
    """Both packages' ``test_rcnn`` on the same port checkpoint over 4
    synthetic images give the same detections: equal counts per (class,
    image), boxes within 1e-2 px and scores within 1e-5 (the two
    frameworks' fp32 conv sums differ in order; boxes agree to ~2.4e-3 px
    here), and per-class APs and mAP within 1e-6.  Random weights score
    an AP of 0 here; the nonzero APs are held by the tests above."""
    jcfg, cfg = _configs(tmp_path)
    kw = dict(num_images=4)
    want = j_test_rcnn(jcfg, prefix=checkpoint, epoch=1, verbose=False,
                       dataset_kw=kw, save_dets=str(tmp_path / "j.pkl"))
    got = port_test_rcnn(cfg, prefix=checkpoint, epoch=1, verbose=False,
                         dataset_kw=kw, save_dets=str(tmp_path / "t.pkl"),
                         device="cpu")
    t, j = _load_dets(tmp_path / "t.pkl"), _load_dets(tmp_path / "j.pkl")
    assert t["classes"] == list(j["classes"])
    total = 0
    for c, (tc, jc) in enumerate(zip(t["all_boxes"], j["all_boxes"])):
        for i, (g, w) in enumerate(zip(tc, jc)):
            assert g.shape == w.shape, (c, i)
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-5)
            total += len(g)
    assert total > 0
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_reeval_reads_the_other_packages_detections(tmp_path):
    """Each package's ``reeval`` scores the other's ``save_dets`` pickle
    as its own ``pred_eval`` scored it."""
    jcfg, cfg = _configs(tmp_path)
    kw = dict(num_images=6)
    jimdb, jroidb = j_load_gt_roidb(jcfg, training=False, **kw)
    imdb, roidb = load_gt_roidb(cfg, training=False, **kw)
    want = j_pred_eval(_RawPredictor(jroidb, 4, jnp.asarray, seed=9),
                       JTestLoader(jroidb, jcfg, num_workers=0), jimdb, jcfg,
                       verbose=False, save_dets=str(tmp_path / "j.pkl"))
    got = pred_eval(_RawPredictor(roidb, 4, torch.from_numpy, seed=9),
                    PortTestLoader(roidb, cfg, imdb.load_image), imdb, cfg,
                    verbose=False, save_dets=str(tmp_path / "t.pkl"))
    assert reeval(cfg, str(tmp_path / "j.pkl"), dataset_kw=kw) == want
    assert j_reeval(jcfg, str(tmp_path / "t.pkl"), dataset_kw=kw) == got
    with pytest.raises(ValueError, match="images"):
        reeval(cfg, str(tmp_path / "j.pkl"), dataset_kw=dict(num_images=5))
