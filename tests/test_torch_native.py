"""The port's host box and RLE mask ops against the JAX package's.

``mx_rcnn_tpu_torch/native`` carries the NumPy path alone.  Every
function is held bit-equal to the JAX module's NumPy path (its C++
library switched off) and to its C++ backend (``native.build()``, which
compiles ``native/src/*.cc`` with g++ here): masks, counts strings,
areas, boxes and NMS keeps exactly, IoUs within 1e-12 of the C++ ones
and exactly equal to the NumPy ones.  Inputs are made from seeds with
numpy: random blob masks, star polygons, crowd pairs and counts that
need several 5-bit chunks.
"""

import numpy as np
import pytest

from mx_rcnn_tpu import native as jnative
from mx_rcnn_tpu_torch import native as tnative

BACKENDS = ["numpy", "native"]


@pytest.fixture(params=BACKENDS)
def ref(request, monkeypatch):
    """The JAX module on one backend."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert jnative.build(), "g++ could not build the JAX native library"
        assert jnative.ensure_built()
    return request.param


def _rand_mask(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(rng.randint(1, 5)):
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(1, h + 1), x:x + rng.randint(1, w + 1)] = 1
    if rng.rand() < 0.5:
        m ^= (rng.rand(h, w) < 0.05).astype(np.uint8)
    return m


def _star(rng, h, w, k=7):
    cx, cy = rng.uniform(w * 0.3, w * 0.7), rng.uniform(h * 0.3, h * 0.7)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = rng.uniform(3, min(h, w) * 0.45, k)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).reshape(-1).tolist()


def _rand_dets(rng, n):
    xy = rng.uniform(0, 80, (n, 2)).astype(np.float32)
    wh = rng.uniform(5, 40, (n, 2)).astype(np.float32)
    scores = rng.uniform(size=(n, 1)).astype(np.float32)
    if n > 3:
        scores[1] = scores[3]  # a tie: the higher index goes first
    return np.hstack([xy, xy + wh, scores])


def test_backend_is_numpy():
    assert tnative.backend() == "numpy"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bbox_overlaps_equal(ref, seed):
    rng = np.random.RandomState(seed)
    a = _rand_dets(rng, 37)[:, :4]
    b = _rand_dets(rng, 19)[:, :4]
    b[0] = [500, 500, 510, 510]  # overlaps nothing
    got, want = tnative.bbox_overlaps(a, b), jnative.bbox_overlaps(a, b)
    assert got.dtype == want.dtype == np.float32
    if ref == "numpy":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,thresh", [(0, 0.3), (1, 0.3), (50, 0.3),
                                      (300, 0.5), (300, 0.7)])
def test_cpu_nms_equal(ref, n, thresh):
    rng = np.random.RandomState(n)
    dets = _rand_dets(rng, n) if n else np.zeros((0, 5), np.float32)
    got, want = tnative.cpu_nms(dets, thresh), jnative.cpu_nms(dets, thresh)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (33, 21), (64, 64),
                                   (100, 90)])
def test_encode_decode_area_bbox_equal(ref, shape):
    rng = np.random.RandomState(sum(shape))
    for _ in range(4):
        m = _rand_mask(rng, *shape)
        r = tnative.encode(m)
        assert r == jnative.encode(m)
        np.testing.assert_array_equal(tnative.decode(r), m)
        np.testing.assert_array_equal(tnative.decode(r), jnative.decode(r))
        assert tnative.area(r) == jnative.area(r) == int(m.sum())
        np.testing.assert_array_equal(tnative.to_bbox(r), jnative.to_bbox(r))
    empty = tnative.encode(np.zeros(shape, np.uint8))
    np.testing.assert_array_equal(tnative.to_bbox(empty),
                                  jnative.to_bbox(empty))


def test_counts_codec_large_counts(ref):
    """Runs past 2^20, and deltas that go negative, need several chunks."""
    rng = np.random.RandomState(7)
    for _ in range(20):
        counts = rng.randint(0, 1 << rng.randint(1, 28), size=rng.randint(
            1, 40)).astype(np.uint32)
        s = tnative._counts_to_string(counts)
        assert s == jnative._counts_to_string(counts)
        np.testing.assert_array_equal(tnative._string_to_counts(s), counts)
        np.testing.assert_array_equal(tnative._string_to_counts(s),
                                      jnative._string_to_counts(s))
    m = np.zeros((1200, 1100), np.uint8)
    m[600:, :] = 1
    m[0, 0] = 1
    r = tnative.encode(m)
    assert r == jnative.encode(m)
    assert tnative.area(r) == int(m.sum())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_iou_and_matrix_with_crowds(ref, seed):
    rng = np.random.RandomState(seed)
    h, w = 40, 36
    dts = [tnative.encode(_rand_mask(rng, h, w)) for _ in range(5)]
    gts = [tnative.encode(_rand_mask(rng, h, w)) for _ in range(4)]
    crowd = np.array([False, True, False, True])
    got = tnative.iou_matrix(dts, gts, crowd)
    want = jnative.iou_matrix(dts, gts, crowd)
    tol = 0 if ref == "numpy" else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for d in range(5):
        for g in range(4):
            a = tnative.iou(dts[d], gts[g], bool(crowd[g]))
            b = jnative.iou(dts[d], gts[g], bool(crowd[g]))
            assert abs(a - b) <= tol
            assert a == got[d, g]
    # a strided crowd view must read the flags it shows
    wide = np.array([[1, 0], [0, 0], [1, 0], [0, 0]], np.uint8)[:, 0]
    np.testing.assert_allclose(tnative.iou_matrix(dts, gts, wide),
                               jnative.iou_matrix(dts, gts, wide),
                               rtol=0, atol=tol)
    assert tnative.iou_matrix([], gts).shape == (0, 4)
    assert tnative.iou_matrix(dts, []).shape == (5, 0)
    with pytest.raises(ValueError, match="crowd flags"):
        tnative.iou_matrix(dts, gts, [True])


@pytest.mark.parametrize("intersect", [False, True])
def test_merge_equal(ref, intersect):
    rng = np.random.RandomState(11 + intersect)
    for _ in range(5):
        ms = [_rand_mask(rng, 18, 22) for _ in range(rng.randint(1, 4))]
        rs = [tnative.encode(m) for m in ms]
        got = tnative.merge(rs, intersect=intersect)
        assert got == jnative.merge(rs, intersect=intersect)
        want = ms[0].astype(bool)
        for m in ms[1:]:
            want = (want & m.astype(bool)) if intersect else \
                (want | m.astype(bool))
        np.testing.assert_array_equal(tnative.decode(got), want)
    with pytest.raises(ValueError):
        tnative.merge([])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_from_poly_and_bbox_equal(ref, seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(20, 60), rng.randint(20, 60)
    poly = _star(rng, h, w)
    assert tnative.from_poly(poly, h, w) == jnative.from_poly(poly, h, w)
    # a polygon reaching past the canvas, and a half-pixel box
    past = [-4.5, -3.0, w + 5.0, 2.5, w * 0.5, h + 7.25]
    assert tnative.from_poly(past, h, w) == jnative.from_poly(past, h, w)
    for bb in ([2, 1, 3, 4], [0.5, 0.5, 7.5, 3.5],
               rng.uniform(0, 15, 4).tolist()):
        assert tnative.from_bbox(bb, h, w) == jnative.from_bbox(bb, h, w)


def test_from_uncompressed_equal(ref):
    rng = np.random.RandomState(5)
    h, w = 30, 25
    m = _rand_mask(rng, h, w)
    counts = tnative._string_to_counts(tnative.encode(m)["counts"])
    ints = [int(c) for c in counts]
    got = tnative.from_uncompressed([h, w], ints)
    assert got == jnative.from_uncompressed([h, w], ints)
    np.testing.assert_array_equal(tnative.decode(got), m)
    # counts given as a str decode the same as bytes
    s = {"size": [h, w], "counts": got["counts"].decode()}
    np.testing.assert_array_equal(tnative.decode(s), jnative.decode(s))


def test_decode_refuses_short_counts():
    with pytest.raises(ValueError, match="cover"):
        tnative.decode({"size": [4, 4], "counts": [3, 2]})
