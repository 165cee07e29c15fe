"""The PyTorch port's ops held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``mx_rcnn_tpu_torch``.  Box geometry, anchors and image
normalisation do the same fp32 operations in the same order, so they are
compared bit for bit.  NMS decisions are compared exactly, against the jnp
sweep and against the Pallas kernel itself run in interpret mode.  The
kernel wrappers take their plain versions here because every tensor lies
on the CPU; the CUDA kernels are checked on the card by ``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.data import image as jimage
from mx_rcnn_tpu.ops import anchors as janchors
from mx_rcnn_tpu.ops import boxes as jboxes
from mx_rcnn_tpu.ops.normalize import normalize_images as j_normalize
from mx_rcnn_tpu.ops.proposal import propose_batch as j_propose_batch
from mx_rcnn_tpu.ops.roi_align_pallas import roi_align_pallas
from mx_rcnn_tpu.ops.roi_pool import interp_matrices as j_interp_matrices
from mx_rcnn_tpu.ops.roi_pool import roi_align as j_roi_align
from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.data import image as timage
from mx_rcnn_tpu_torch.ops import anchors as tanchors
from mx_rcnn_tpu_torch.ops import boxes as tboxes
from mx_rcnn_tpu_torch.ops import nms as tnms
from mx_rcnn_tpu_torch.ops import roi_pool as troi
from mx_rcnn_tpu_torch.ops.normalize import normalize_images as t_normalize
from mx_rcnn_tpu_torch.ops.proposal import propose_batch as t_propose_batch

# ``mx_rcnn_tpu.ops`` re-exports the nms function over its module's name
jnms = importlib.import_module("mx_rcnn_tpu.ops.nms")
# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers
torch.set_num_threads(1)
T = torch.from_numpy


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand_boxes(rng, k, span=200.0, lo=5.0, hi=80.0):
    xy = rng.uniform(0, span, (k, 2)).astype(np.float32)
    wh = rng.uniform(lo, hi, (k, 2)).astype(np.float32)
    return np.hstack([xy, xy + wh])


# ---- boxes ---------------------------------------------------------------

def _overlap_cases():
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0, 100, (40, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    query = rng.uniform(0, 100, (17, 4)).astype(np.float32)
    query[:, 2:] += query[:, :2]
    return {
        "identity": (np.array([[0, 0, 9, 9]], np.float32),) * 2,
        "hand": (np.array([[0, 0, 9, 9]], np.float32),
                 np.array([[5, 0, 14, 9]], np.float32)),
        "disjoint_degenerate": (
            np.array([[0, 0, 4, 4], [10, 10, 5, 5]], np.float32),
            np.array([[100, 100, 110, 110]], np.float32)),
        "random": (boxes, query),
    }


@pytest.mark.parametrize("case", sorted(_overlap_cases()))
def test_bbox_overlaps_bit_equal(case):
    a, b = _overlap_cases()[case]
    want = _np(jboxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b)))
    got = _np(tboxes.bbox_overlaps(T(a), T(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_classes", [1, 3])
def test_bbox_pred_bit_equal(num_classes):
    """Bit-equal where XLA's and torch's ``exp`` agree (dw = dh = 0, and
    the 4.135 clamp, which both apply before ``exp``); with arbitrary
    dw/dh the two ``exp``s differ by up to one ulp on about 8% of inputs,
    which the decoded corners carry as a relative error below 1e-6."""
    rng = np.random.RandomState(num_classes)
    ex = _rand_boxes(rng, 30)
    deltas = rng.uniform(-2, 6, (30, 4 * num_classes)).astype(np.float32)
    want = _np(jboxes.bbox_pred(jnp.asarray(ex), jnp.asarray(deltas)))
    got = _np(tboxes.bbox_pred(T(ex), T(deltas)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    no_exp = deltas.copy()
    no_exp[:, 2::4] = 0.0
    no_exp[:, 3::4] = 9.0              # clamped to the same 4.135 by both
    np.testing.assert_array_equal(
        _np(tboxes.bbox_pred(T(ex), T(no_exp))),
        _np(jboxes.bbox_pred(jnp.asarray(ex), jnp.asarray(no_exp))))


@pytest.mark.parametrize("b,shape", [
    ([[-10.0, -5.0, 700.0, 300.0]], (256, 512)),
    ([[-1.0, -1.0, 600.0, 600.0, 5.0, 5.0, 10.0, 10.0]], (100, 100)),
])
def test_clip_boxes_bit_equal(b, shape):
    b = np.asarray(b, np.float32)
    want = _np(jboxes.clip_boxes(jnp.asarray(b), shape))
    got = _np(tboxes.clip_boxes(T(b), shape))
    np.testing.assert_array_equal(got, want)


# ---- anchors, normalisation, image geometry ------------------------------

@pytest.mark.parametrize("args", [
    dict(feat_height=2, feat_width=3, feat_stride=16),
    dict(feat_height=4, feat_width=4, feat_stride=8, scales=(4,)),
    dict(feat_height=38, feat_width=64, feat_stride=16),
])
def test_anchors_equal(args):
    np.testing.assert_array_equal(
        tanchors.generate_shifted_anchors(**args),
        janchors.generate_shifted_anchors(**args))
    np.testing.assert_array_equal(
        tanchors.generate_anchors(16, (0.5, 1.0, 2.0), (8, 16, 32)),
        janchors.generate_anchors(16, (0.5, 1.0, 2.0), (8, 16, 32)))


def test_normalize_images_bit_equal():
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (2, 16, 20, 3)).astype(np.uint8)
    info = np.array([[16, 20, 1.0], [9, 13, 0.5]], np.float32)
    means = (123.68, 116.779, 103.939)
    want = _np(j_normalize(jnp.asarray(imgs), jnp.asarray(info), means))
    got = _np(t_normalize(T(imgs), T(info), means))
    np.testing.assert_array_equal(got, want)
    assert (got[1, 9:] == 0).all() and (got[1, :, 13:] == 0).all()
    x = torch.ones((1, 4, 4, 3))
    assert t_normalize(x, None, means) is x
    with pytest.raises(ValueError):
        t_normalize(x.to(torch.uint8), None, means)


@pytest.mark.parametrize("hw", [(480, 640), (300, 900), (375, 500),
                                (1000, 600)])
def test_image_geometry_equal(hw):
    h, w = hw
    buckets = ((608, 1024), (1024, 608))
    assert timage.compute_scale(h, w, 600, 1000) == \
        jimage.compute_scale(h, w, 600, 1000)
    assert timage.choose_bucket(h, w, buckets) == \
        jimage.choose_bucket(h, w, buckets)
    assert timage.bucket_fit(h, w, buckets[0]) == \
        jimage.bucket_fit(h, w, buckets[0])


def test_resize_to_bucket_equal():
    """Where cv2 imports, both packages resize with it and the canvases
    are bit-equal; the numpy bilinear fallback (used where cv2 is absent)
    stays within one grey level of cv2 on a smooth image."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    means = (123.68, 116.779, 103.939)
    buckets = ((160, 224), (224, 160))
    got = timage.resize_to_bucket(img, means, 150, 220, buckets)
    want = jimage.resize_to_bucket(img, means, 150, 220, buckets)
    assert got[1:] == want[1:]
    if timage.RESIZE_BACKEND == "cv2":
        np.testing.assert_array_equal(got[0], want[0])
        yy, xx = np.mgrid[0:60, 0:80]
        smooth = np.stack([yy * 3, xx * 2, yy + xx], -1).astype(np.uint8)
        for size in ((110, 150), (40, 50)):
            diff = (timage._resize_bilinear_np(smooth, *size).astype(int)
                    - timage._resize(smooth, *size).astype(int))
            assert np.abs(diff).max() <= 1


# ---- NMS -----------------------------------------------------------------

def _nms_case(name, k, seed):
    """(boxes (k, 4), scores (k,), valid (k,) or None) for one case."""
    rng = np.random.RandomState(seed)
    valid = None
    if name == "dense_cluster":
        base = rng.uniform(0, 40, (k // 16 + 1, 2))
        boxes = []
        for bx, by in base:
            for _ in range(16):
                j = rng.uniform(-3, 3, 2)
                boxes.append([bx + j[0], by + j[1],
                              bx + 30 + j[0], by + 30 + j[1]])
        boxes = np.asarray(boxes[:k], np.float32)
        scores = rng.uniform(size=k).astype(np.float32)
    elif name == "ties":
        # duplicated boxes and scores quantised to a few levels: the stable
        # sort and the sweep must break every tie the same way
        boxes = _rand_boxes(rng, k // 4)
        boxes = np.repeat(boxes, 4, axis=0)[:k]
        boxes = np.concatenate([boxes, _rand_boxes(rng, k - len(boxes))])
        scores = rng.randint(0, 5, k).astype(np.float32) / 4.0
    elif name == "integer":
        # integer boxes: many IoUs are fractions that land exactly on the
        # threshold, where only identical rounding gives equal decisions
        xy = rng.randint(0, 48, (k, 2))
        boxes = np.concatenate([xy, xy + rng.randint(0, 24, (k, 2))],
                               -1).astype(np.float32)
        scores = (rng.randint(0, 8, k) / 8.0).astype(np.float32)
    else:
        boxes = _rand_boxes(rng, k)
        scores = rng.uniform(size=k).astype(np.float32)
        if name == "valid_masked":
            valid = rng.uniform(size=k) > 0.3
    return boxes, scores, valid


_NMS_CASES = [("random", 256), ("random", 384), ("dense_cluster", 256),
              ("valid_masked", 320), ("ties", 256), ("integer", 256),
              ("random", 127), ("random", 129)]


@pytest.mark.parametrize("name,k", _NMS_CASES)
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_nms_mask_decision_exact(name, k, backend):
    """The plain sweep against ``nms_mask`` with the jnp sweep and with
    the Pallas kernel (interpret mode, tile 128 as on the TPU)."""
    boxes, scores, valid = _nms_case(name, k, seed=k)
    thr = 0.5
    want = _np(jnms.nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), thr,
        valid=None if valid is None else jnp.asarray(valid),
        tile_size=128, backend=backend))
    got = _np(tnms.nms_mask_batch(
        T(boxes)[None], T(scores)[None], thr,
        valid=None if valid is None else T(valid)[None], tile_size=128))[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", [64, 256])
def test_plain_sweep_equals_jnp_batched_sweep(tile):
    """The port's sweep against ``_suppression_sweep_batched`` on sorted
    boxes, B=3 images, including all-dead and duplicate rows."""
    rng = np.random.RandomState(tile)
    b, k = 3, 512
    boxes = np.stack([_rand_boxes(rng, k, span=120) for _ in range(b)])
    boxes[1, 10:20] = boxes[1, 9]
    alive = rng.uniform(size=(b, k)) > 0.2
    alive[2] = False
    want = _np(jnms._suppression_sweep_batched(
        jnp.asarray(boxes), jnp.asarray(alive), 0.7, tile))
    got = _np(tnms.suppression_sweep(T(boxes), T(alive), 0.7, tile))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,k", _NMS_CASES[:6])
def test_nms_batch_index_exact(name, k):
    b = 2
    cases = [_nms_case(name, k, seed=k + i) for i in range(b)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    valid = (None if cases[0][2] is None
             else np.stack([c[2] for c in cases]))
    args = dict(iou_threshold=0.7, max_output=50)
    want_i, want_v = jnms.nms_batch(
        jnp.asarray(boxes), jnp.asarray(scores),
        valid=None if valid is None else jnp.asarray(valid),
        backend="jnp", **args)
    got_i, got_v = tnms.nms_batch(
        T(boxes), T(scores), valid=None if valid is None else T(valid),
        **args)
    np.testing.assert_array_equal(_np(got_i), _np(want_i))
    np.testing.assert_array_equal(_np(got_v), _np(want_v))
    mask_want = _np(jnms.nms_mask_batch(
        jnp.asarray(boxes), jnp.asarray(scores), 0.3,
        valid=None if valid is None else jnp.asarray(valid), backend="jnp"))
    mask_got = _np(tnms.nms_mask_batch(
        T(boxes), T(scores), 0.3, valid=None if valid is None else T(valid)))
    np.testing.assert_array_equal(mask_got, mask_want)


def test_nms_empty_inputs():
    idx, ok = tnms.nms_batch(torch.zeros((2, 0, 4)), torch.zeros((2, 0)),
                             0.7, 5)
    assert idx.shape == (2, 5) and (idx == -1).all() and not ok.any()
    assert tnms.nms_mask_batch(torch.zeros((2, 0, 4)), torch.zeros((2, 0)),
                               0.7).shape == (2, 0)


# ---- proposals -----------------------------------------------------------

def _proposal_inputs(seed, b=2, fh=8, fw=10):
    rng = np.random.RandomState(seed)
    anchors = janchors.generate_shifted_anchors(fh, fw, 16, scales=(2, 4, 8))
    n = anchors.shape[0]
    scores = rng.uniform(size=(b, n)).astype(np.float32)
    deltas = (rng.standard_normal((b, n, 4)) * 0.3).astype(np.float32)
    im_info = np.array([[128, 160, 1.0], [100, 150, 0.8]], np.float32)[:b]
    return scores, deltas, anchors, im_info


@pytest.mark.parametrize("seed,exp_free", [(0, False), (1, False),
                                            (2, True)])
def test_propose_batch_matches(seed, exp_free):
    """Same decode arithmetic, so rois agree to 0 ULP wherever the two
    libraries' ``exp`` agree: with dw = dh = 0 (``exp(0) = 1`` in both)
    they are compared bit for bit.  Otherwise ``exp`` may differ by one
    ulp between XLA and torch, which moves a coordinate by at most 1e-4 px
    at these box sizes, so rois are held at atol 1e-3; the kept sets and
    their order (``roi_valid``, scores) are exact either way."""
    scores, deltas, anchors, im_info = _proposal_inputs(seed)
    if exp_free:
        deltas[..., 2:] = 0.0
    kw = dict(pre_nms_top_n=400, post_nms_top_n=60, nms_thresh=0.7,
              min_size=16)
    want = [_np(x) for x in j_propose_batch(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(anchors),
        jnp.asarray(im_info), **kw)]
    got = [_np(x) for x in t_propose_batch(
        T(scores), T(deltas), T(anchors), T(im_info), **kw)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    if exp_free:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    assert want[2].sum() > 10


def test_propose_batch_ties_stable():
    """Quantised scores tie everywhere: the pre-NMS top-k must take the
    lower index first, as ``lax.top_k`` does."""
    scores, deltas, anchors, im_info = _proposal_inputs(3)
    scores = np.round(scores * 4) / 4
    kw = dict(pre_nms_top_n=300, post_nms_top_n=40, nms_thresh=0.7,
              min_size=4)
    want = [_np(x) for x in j_propose_batch(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(anchors),
        jnp.asarray(im_info), **kw)]
    got = [_np(x) for x in t_propose_batch(
        T(scores), T(deltas), T(anchors), T(im_info), **kw)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)


# ---- ROIAlign ------------------------------------------------------------

def _roi_inputs(seed, n=2, r=12, h=9, w=13, c=8):
    rng = np.random.RandomState(seed)
    feat = rng.standard_normal((n, h, w, c)).astype(np.float32)
    xy = rng.uniform(-20, 16 * w, (n, r, 2))
    wh = rng.uniform(0, 120, (n, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0, 0] = [5, 5, 5, 5]          # a degenerate roi: extent clamps to 1
    return feat, rois


def test_interp_matrices_bit_equal():
    _, rois = _roi_inputs(0)
    want = j_interp_matrices(jnp.asarray(rois[0]), 7, 5, 9, 13, 1 / 16, 2)
    got = troi.interp_matrices(T(rois[0]), 7, 5, 9, 13, 1 / 16, 2)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w_))


@pytest.mark.parametrize("size,sr", [((14, 14), 2), ((7, 5), 2), ((3, 4), 1)])
def test_roi_align_matches_einsum_and_pallas(size, sr):
    """fp32 at atol=rtol=1e-5: the port runs the same einsum pair, but
    torch's CPU contraction sums in another order than XLA's."""
    feat, rois = _roi_inputs(sum(size) + sr)
    got = _np(troi.roi_align(T(feat), T(rois), size, 1 / 16, sr))
    want = np.stack([_np(j_roi_align(jnp.asarray(feat[i]),
                                     jnp.asarray(rois[i]), size, 1 / 16, sr))
                     for i in range(feat.shape[0])])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = _np(roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois), size,
                                  1 / 16, sr, True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


# ---- dispatch ------------------------------------------------------------

def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    feat, rois = _roi_inputs(1)
    out = troi.roi_align(T(feat), T(rois), (7, 7))
    np.testing.assert_array_equal(
        _np(out), _np(troi.roi_align_plain(T(feat), T(rois), (7, 7))))
    boxes, scores, _ = _nms_case("random", 256, 0)
    tnms.nms_mask_batch(T(boxes)[None], T(scores)[None], 0.5)
    assert kernels.launch_counts() == {k.name: 0 for k in kernels.KERNELS}


def test_cuda_wrappers_refuse_cpu_tensors():
    feat, rois = _roi_inputs(2)
    with pytest.raises(ValueError, match="CUDA"):
        troi.roi_align_cuda(T(feat), T(rois))
    with pytest.raises(ValueError, match="CUDA"):
        tnms.suppression_sweep_cuda(torch.zeros((1, 64, 4)),
                                    torch.ones((1, 64), dtype=torch.bool),
                                    0.7)
