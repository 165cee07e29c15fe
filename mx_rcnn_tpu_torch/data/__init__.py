"""Data: the dataset readers, roidb, image decode and resize, batch loading.

Counterpart of ``mx_rcnn_tpu/data/``.  :func:`load_gt_roidb` reads the
on-disk datasets (a VOCdevkit through :class:`PascalVOC`, a COCO tree
through :class:`COCODataset`) and builds the generated sets: the
in-memory synthetic images (for the ``synthetic`` preset, and for any
preset when the caller asks for ``synthetic`` stand-in images, VOC-sized
or at a generated set's canvas, labelled with the preset's classes) and
the PNG-backed ``synthetic_hard`` and ``synthetic_stream`` sets.  This
package's ``__init__`` imports no torch, so that the decode pool's
workers start light; the loaders are in
:mod:`mx_rcnn_tpu_torch.data.loader`.
"""

from __future__ import annotations

from mx_rcnn_tpu_torch.data.coco import COCODataset
from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC
from mx_rcnn_tpu_torch.data.roidb import (IMDB, filter_roidb, merge_roidbs,
                                          reads_files)
from mx_rcnn_tpu_torch.data.synthetic import (HardSyntheticDataset,
                                              StreamSyntheticDataset,
                                              SyntheticDataset,
                                              default_image_size)

_READERS = {"PascalVOC": PascalVOC, "coco": COCODataset,
            "synthetic": SyntheticDataset,
            "synthetic_hard": HardSyntheticDataset,
            "synthetic_stream": StreamSyntheticDataset}
# the sets generated from a seed, which take the preset's class count
_GENERATED = ("synthetic", "synthetic_hard", "synthetic_stream")


def get_dataset(name: str, image_set: str, root_path: str, dataset_path: str,
                **kw) -> IMDB:
    """The imdb of dataset ``name``'s ``image_set`` (ref
    ``rcnn/utils/load_data.py — load_gt_roidb``'s eval-by-name)."""
    if name not in _READERS:
        raise KeyError(f"no reader for dataset {name!r} (have "
                       f"{sorted(_READERS)}); give synthetic=N for stand-in "
                       f"images")
    return _READERS[name](image_set, root_path=root_path,
                          dataset_path=dataset_path, **kw)


def load_gt_roidb(cfg, image_set: str = None, training: bool = True,
                  synthetic: int = 0, flip: bool = None, **kw):
    """Config → (imdb, roidb), as ``mx_rcnn_tpu/data/__init__.py —
    load_gt_roidb`` assembles them: ``image_set`` defaults to the
    dataset's train or test set, a '+'-joined list (e.g.
    ``2007_trainval+2012_trainval``) is merged (train only), and training
    drops images without gt, then appends each set's flipped copies
    (``flip``, default ``cfg.train.flip``).  ``synthetic`` > 0 makes that
    many synthetic images per set in place of the dataset's files, at the
    preset's canvas (:func:`default_image_size`); ``kw`` goes to the
    reader (``use_difficult`` for VOC, ``num_images`` for a generated
    set: ``tools/train.py --dataset_kw``).  A generated set gets the
    preset's ``num_classes``.  Returns the first imdb (the evaluator) and
    the merged roidb."""
    ds = cfg.dataset
    if image_set is None:
        image_set = ds.image_set if training else ds.test_image_set
    if not training and "+" in image_set:
        raise ValueError(
            f"'+'-joined image sets are train-only; got {image_set!r}")
    name = "synthetic" if synthetic > 0 else ds.name
    if synthetic > 0:
        kw.setdefault("num_images", synthetic)
        kw.setdefault("image_size", default_image_size(ds.name))
    if name in _GENERATED:
        kw.setdefault("num_classes", ds.num_classes)
    imdbs, roidbs = [], []
    for sset in image_set.split("+"):
        imdb = get_dataset(name, sset, ds.root_path, ds.dataset_path, **kw)
        r = imdb.gt_roidb()
        if training:
            r = filter_roidb(r)
            if cfg.train.flip if flip is None else flip:
                r = IMDB.append_flipped_images(r)
        imdbs.append(imdb)
        roidbs.append(r)
    return imdbs[0], merge_roidbs(roidbs)


__all__ = ["COCODataset", "HardSyntheticDataset", "IMDB", "PascalVOC",
           "StreamSyntheticDataset", "SyntheticDataset", "filter_roidb",
           "get_dataset", "load_gt_roidb", "merge_roidbs", "reads_files"]
