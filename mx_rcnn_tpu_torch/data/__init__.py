"""Data: roidb, synthetic images, resize and bucket, batch loading.

Counterpart of ``mx_rcnn_tpu/data/``.  Only the synthetic images are
ported: :func:`load_gt_roidb` builds them for the synthetic presets, and
for any preset when the caller asks for ``synthetic`` stand-in images
(VOC-sized, labelled with the preset's classes).  The VOC and COCO
readers are not ported yet.
"""

from __future__ import annotations

from mx_rcnn_tpu_torch.data.roidb import IMDB, filter_roidb, merge_roidbs
from mx_rcnn_tpu_torch.data.synthetic import (SyntheticDataset,
                                              default_image_size)


def load_gt_roidb(cfg, image_set: str = None, training: bool = True,
                  synthetic: int = 0, flip: bool = None, **kw):
    """Config → (imdb, roidb), as ``mx_rcnn_tpu/data/__init__.py —
    load_gt_roidb`` assembles them: ``image_set`` defaults to the
    dataset's train or test set, a '+'-joined list is merged (train
    only), and training drops images without gt, then appends each set's
    flipped copies (``flip``, default ``cfg.train.flip``).  ``synthetic``
    > 0 makes that many synthetic images per set; ``kw`` goes to
    :class:`SyntheticDataset`.  Returns the first imdb (the evaluator) and
    the merged roidb."""
    ds = cfg.dataset
    if image_set is None:
        image_set = ds.image_set if training else ds.test_image_set
    if not training and "+" in image_set:
        raise ValueError(
            f"'+'-joined image sets are train-only; got {image_set!r}")
    if ds.name != "synthetic" and synthetic <= 0:
        raise NotImplementedError(
            f"the {ds.name} reader is not ported yet; evaluate synthetic "
            f"stand-in images instead (synthetic=N, --synthetic N)")
    if synthetic > 0:
        kw.setdefault("num_images", synthetic)
    kw.setdefault("image_size", default_image_size(ds.name))
    imdbs, roidbs = [], []
    for sset in image_set.split("+"):
        imdb = SyntheticDataset(sset, num_classes=ds.num_classes,
                                root_path=ds.root_path,
                                dataset_path=ds.dataset_path, **kw)
        r = imdb.gt_roidb()
        if training:
            r = filter_roidb(r)
            if cfg.train.flip if flip is None else flip:
                r = IMDB.append_flipped_images(r)
        imdbs.append(imdb)
        roidbs.append(r)
    return imdbs[0], merge_roidbs(roidbs)


__all__ = ["IMDB", "SyntheticDataset", "filter_roidb", "load_gt_roidb",
           "merge_roidbs"]
