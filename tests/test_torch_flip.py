"""The port's training roidb, with its flipped copies, held against the
JAX package's on the CPU.

``load_gt_roidb(training=True)`` appends a horizontally flipped copy of
each record (``train.flip``, on by default), whose boxes are mirrored as
``x' = width - 1 - x`` and whose pixels the loaders mirror before the
resize.  Both packages must give the same records, the same number of
batches (so the same steps per epoch and the same learning-rate steps),
and the same uint8 canvases, ``im_info`` and padded gt in the same plan
for each (seed, epoch).  Every comparison is exact: the data path has no
floating-point freedom.
"""

import numpy as np
import pytest

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data import AnchorLoader as JAnchorLoader
from mx_rcnn_tpu.data import TestLoader as JTestLoader
from mx_rcnn_tpu.data import load_gt_roidb as j_load_gt_roidb
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.data import IMDB, load_gt_roidb
from mx_rcnn_tpu_torch.data.loader import AnchorLoader
from mx_rcnn_tpu_torch.data.loader import TestLoader as PortTestLoader

_TOY = dict(dataset__num_classes=4, bucket__scale=128, bucket__max_size=160,
            bucket__shapes=((128, 160), (160, 128)), train__max_gt_boxes=4)
_KW = dict(num_images=5, image_size=(128, 160))


def _configs(tmp_path, **extra):
    kw = dict(_TOY, **extra)
    jcfg = j_generate_config("tiny", "synthetic", **kw)
    jcfg = jcfg.replace_in("dataset", root_path=str(tmp_path),
                           dataset_path=str(tmp_path / "synthetic"))
    return jcfg, generate_config("tiny", "synthetic", **kw)


def _roidbs(tmp_path, flip=None, **extra):
    jcfg, cfg = _configs(tmp_path, **extra)
    _, jroidb = j_load_gt_roidb(jcfg, training=True, flip=flip, **_KW)
    imdb, roidb = load_gt_roidb(cfg, training=True, flip=flip, **_KW)
    return jcfg, cfg, jroidb, imdb, roidb


@pytest.mark.parametrize("cfg_flip,flip,doubled", [
    (True, None, True), (False, None, False), (False, True, True),
    (True, False, False)])
def test_training_roidb_equals_jax(cfg_flip, flip, doubled, tmp_path):
    """The same records in the same order, flips appended after the
    originals when ``train.flip`` (or the ``flip`` argument) says so."""
    _, _, jroidb, _, roidb = _roidbs(tmp_path, flip, train__flip=cfg_flip)
    assert len(roidb) == len(jroidb) == _KW["num_images"] * (1 + doubled)
    for t, j in zip(roidb, jroidb):
        assert t["flipped"] == j["flipped"]
        assert (t["height"], t["width"]) == (j["height"], j["width"])
        np.testing.assert_array_equal(t["boxes"], j["boxes"])
        np.testing.assert_array_equal(t["gt_classes"], j["gt_classes"])
    assert [r["flipped"] for r in roidb] == (
        [False] * _KW["num_images"] + [True] * _KW["num_images"] * doubled)


def test_flipped_boxes_are_mirrored(tmp_path):
    _, _, _, _, roidb = _roidbs(tmp_path)
    n = _KW["num_images"]
    for orig, flipped in zip(roidb[:n], roidb[n:]):
        w = orig["width"]
        np.testing.assert_array_equal(flipped["boxes"][:, 0],
                                      w - 1 - orig["boxes"][:, 2])
        np.testing.assert_array_equal(flipped["boxes"][:, 2],
                                      w - 1 - orig["boxes"][:, 0])
        np.testing.assert_array_equal(flipped["boxes"][:, [1, 3]],
                                      orig["boxes"][:, [1, 3]])
        assert not orig["flipped"] and flipped["flipped"]
    # a record without boxes flips to one without boxes
    assert IMDB.append_flipped_images([dict(
        roidb[0], boxes=np.zeros((0, 4), np.float32))])[1]["boxes"].shape \
        == (0, 4)


@pytest.mark.parametrize("seed", [0, 3])
def test_first_epochs_batches_equal_jax(seed, tmp_path):
    """Batch 2 over 5 images and their flips: 5 batches an epoch in both
    (the unflipped roidb gives 2), and the same uint8 canvases, im_info,
    gt boxes, classes and masks batch for batch in epochs 0 and 1."""
    jcfg, cfg, jroidb, imdb, roidb = _roidbs(tmp_path)
    jl = JAnchorLoader(jroidb, jcfg, batch_images=2, seed=seed,
                       num_workers=0, raw_images=True)
    tl = AnchorLoader(roidb, cfg, imdb.load_image, batch_images=2, seed=seed)
    assert len(tl) == len(jl) == 5
    for _ in range(2):
        pairs = list(zip(jl, tl))
        assert len(pairs) == 5
        for want, got in pairs:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
    # unshuffled, batch 1: a flipped image's canvas mirrors its original's
    batches = list(AnchorLoader(roidb, cfg, imdb.load_image, batch_images=1,
                                shuffle=False))
    n = _KW["num_images"]
    for a, b in zip(batches[:n], batches[n:]):
        h, w = int(a.im_info[0, 0]), int(a.im_info[0, 1])
        np.testing.assert_array_equal(b.images[0, :h, :w],
                                      a.images[0, :h, :w][:, ::-1])


def test_test_loader_mirrors_flipped_records_like_jax(tmp_path):
    """The proposal dumps read the flipped training roidb through the
    eval loader: the same batches, indices and scales as the JAX one."""
    jcfg, cfg, jroidb, imdb, roidb = _roidbs(tmp_path,
                                             test__batch_images=3)
    jl = list(JTestLoader(jroidb, jcfg, num_workers=0, raw_images=True))
    tl = list(PortTestLoader(roidb, cfg, imdb.load_image))
    assert len(tl) == len(jl) == 4
    for (tb, ti, ts), (jb, ji, js) in zip(tl, jl):
        assert ti == ji
        np.testing.assert_array_equal(ts, js)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, np.asarray(b))
