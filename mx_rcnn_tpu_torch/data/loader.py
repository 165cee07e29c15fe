"""Training and eval batches from a roidb.

Counterpart of ``mx_rcnn_tpu/data/loader.py — AnchorLoader``,
``ROIIter``, ``TestLoader`` and ``ROITestLoader``, with their batch plans
and ``_make_batch`` semantics, and without the decode pool, cache, shards
or streaming: each record's pixels come from ``load_image(rec)``, are
mirrored when the record is flipped, resized into its bucket and kept as
raw uint8 (normalised on the device); a training batch also carries the
gt boxes scaled by ``im_scale`` and padded to ``max_gt_boxes``, and a
proposal-fed batch (:class:`RCNNBatch`) the proposals, scaled the same
way and padded to ``max_rois`` slots.  Batches hold numpy arrays;
``core/train.py — to_device`` moves them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import Batch, RCNNBatch
from mx_rcnn_tpu_torch.data.image import (choose_bucket, compute_scale,
                                          fit_to_bucket, resize_keep_ratio)

LoadImage = Callable[[Dict], np.ndarray]


def _bucket_of(h: int, w: int, cfg: Config, buckets) -> Tuple[int, int]:
    """The bucket of an (h, w) image after the reference resize."""
    s = compute_scale(h, w, cfg.bucket.scale, cfg.bucket.max_size)
    return choose_bucket(int(round(h * s)), int(round(w * s)), buckets)


def _place(rec: Dict, load_image: LoadImage, cfg: Config, bucket,
           images: np.ndarray, j: int) -> Tuple[int, int, float]:
    """Load ``rec``'s pixels, mirror them when it is flipped, resize them
    into ``bucket`` at row ``j`` of the uint8 canvas ``images``; returns
    (h, w, im_scale)."""
    img = load_image(rec)
    if rec.get("flipped", False):
        img = img[:, ::-1, :]
    img, im_scale = resize_keep_ratio(img, cfg.bucket.scale,
                                      cfg.bucket.max_size)
    img, im_scale = fit_to_bucket(img, im_scale, bucket)
    h, w = img.shape[:2]
    images[j, :h, :w] = img
    return h, w, im_scale


def _check_proposals(proposals, roidb) -> list:
    """One proposal set per roidb record, in order."""
    if len(proposals) != len(roidb):
        raise ValueError(
            f"{len(proposals)} proposal sets for {len(roidb)} roidb records")
    return list(proposals)


def _fill_rois(proposals, indices, scales, max_rois: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw-coordinate (k, 5) proposal arrays of records ``indices`` →
    the padded (n, max_rois, 4) input-coordinate ROI buffer (each image's
    boxes times its scale, the first ``max_rois`` kept) and its validity
    mask.  Shared by :class:`ROIIter` and :class:`ROITestLoader`."""
    n = len(indices)
    rois = np.zeros((n, max_rois, 4), np.float32)
    rois_valid = np.zeros((n, max_rois), bool)
    for j, i in enumerate(indices):
        p = np.asarray(proposals[i], np.float32).reshape(-1, 5)
        k = min(len(p), max_rois)
        rois[j, :k] = p[:k, :4] * scales[j]
        rois_valid[j, :k] = True
    return rois, rois_valid


class AnchorLoader:
    """Iterating yields one epoch of :class:`Batch` es; the images of a
    batch share a bucket.  ``load_image(rec)`` gives a record's RGB uint8
    pixels (``IMDB.load_image``)."""

    def __init__(self, roidb: Sequence[Dict], cfg: Config,
                 load_image: LoadImage, batch_images: int = None,
                 shuffle: bool = None, seed: int = 0):
        self.roidb = list(roidb)
        self.cfg = cfg
        self.load_image = load_image
        self.batch_images = batch_images or cfg.train.batch_images
        self.shuffle = cfg.train.shuffle if shuffle is None else shuffle
        self.seed = seed
        self._epoch = 0
        self.buckets = tuple(tuple(s) for s in cfg.bucket.shapes)
        self._bucket_ids = [_bucket_of(rec["height"], rec["width"], cfg,
                                       self.buckets) for rec in self.roidb]

    def __len__(self) -> int:
        return sum(len(self._indices_for(bucket)) // self.batch_images
                   for bucket in set(self._bucket_ids))

    def _indices_for(self, bucket) -> List[int]:
        return [i for i, b in enumerate(self._bucket_ids) if b == bucket]

    def set_epoch(self, epoch: int) -> None:
        """Pin the next epoch's shuffle to ``epoch``: a run resumed at
        epoch k replays the batches the unbroken run saw."""
        self._epoch = epoch

    def plan(self) -> List[Tuple[Tuple[int, int], List[int]]]:
        """The next epoch's (bucket, roidb indices) batches, as the JAX
        loader orders them for (seed, epoch); advances the epoch."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + self._epoch) % (2 ** 31))
        self._epoch += 1
        batches = []
        for bucket in sorted(set(self._bucket_ids)):
            idx = self._indices_for(bucket)
            if self.shuffle:
                rng.shuffle(idx)
            for s in range(0, len(idx) - self.batch_images + 1,
                           self.batch_images):
                batches.append((bucket, idx[s:s + self.batch_images]))
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def make_batch(self, indices: Sequence[int], bucket) -> Batch:
        cfg = self.cfg
        g = cfg.train.max_gt_boxes
        n = len(indices)
        images = np.zeros((n, bucket[0], bucket[1], 3), np.uint8)
        im_info = np.zeros((n, 3), np.float32)
        gt_boxes = np.zeros((n, g, 4), np.float32)
        gt_classes = np.zeros((n, g), np.int32)
        gt_valid = np.zeros((n, g), bool)
        for j, i in enumerate(indices):
            rec = self.roidb[i]
            h, w, im_scale = _place(rec, self.load_image, cfg, bucket,
                                    images, j)
            im_info[j] = (h, w, im_scale)
            k = min(len(rec["boxes"]), g)
            if k:
                gt_boxes[j, :k] = rec["boxes"][:k] * im_scale
                gt_classes[j, :k] = rec["gt_classes"][:k]
                gt_valid[j, :k] = True
        return Batch(images, im_info, gt_boxes, gt_classes, gt_valid)

    def __iter__(self) -> Iterator[Batch]:
        for bucket, idx in self.plan():
            yield self.make_batch(idx, bucket)


class ROIIter(AnchorLoader):
    """The RCNN-only training loader (alternate stages 2 and 4): the
    batches of :class:`AnchorLoader`, on its plan, as :class:`RCNNBatch`
    es carrying ``proposals[i]``, the (k, 5) [x1 y1 x2 y2 score] array of
    roidb record ``i`` in raw image coordinates
    (``core/tester.py — generate_proposals``), padded to ``max_rois``
    (default ``cfg.test.proposal_post_nms_top_n``) slots."""

    def __init__(self, roidb: Sequence[Dict], cfg: Config,
                 load_image: LoadImage, proposals: Sequence,
                 batch_images: int = None, shuffle: bool = None,
                 seed: int = 0, max_rois: int = None):
        super().__init__(roidb, cfg, load_image, batch_images, shuffle, seed)
        self.proposals = _check_proposals(proposals, self.roidb)
        self.max_rois = max_rois or cfg.test.proposal_post_nms_top_n

    def make_batch(self, indices: Sequence[int], bucket) -> RCNNBatch:
        base = super().make_batch(indices, bucket)
        rois, rois_valid = _fill_rois(self.proposals, indices,
                                      base.im_info[:, 2], self.max_rois)
        return RCNNBatch(*base, rois=rois, rois_valid=rois_valid)


class TestLoader:
    """Eval batches (ref ``TestLoader``): iterating yields ``(Batch,
    indices, scales)`` with zero gt fields, ``indices`` the roidb
    positions and ``scales`` each image's ``im_scale``, which maps its
    detections back to raw image coordinates.  Images are grouped by
    bucket in roidb order; each bucket's last batch may be short.
    ``load_image(rec)`` gives a record's RGB uint8 pixels (``IMDB.
    load_image``); a flipped record is mirrored, as the alternate
    schedule's proposal dumps over the training roidb need."""

    def __init__(self, roidb: Sequence[Dict], cfg: Config,
                 load_image: LoadImage, batch_images: int = None):
        self.roidb = list(roidb)
        self.cfg = cfg
        self.load_image = load_image
        self.batch_images = batch_images or cfg.test.batch_images
        self.buckets = tuple(tuple(s) for s in cfg.bucket.shapes)
        self._bucket_ids = [_bucket_of(rec["height"], rec["width"], cfg,
                                       self.buckets) for rec in self.roidb]

    def _plan(self) -> List[Tuple[Tuple[int, int], List[int]]]:
        batches = []
        for bucket in sorted(set(self._bucket_ids)):
            idx = [i for i, b in enumerate(self._bucket_ids) if b == bucket]
            for s in range(0, len(idx), self.batch_images):
                batches.append((bucket, idx[s:s + self.batch_images]))
        return batches

    def __len__(self) -> int:
        return len(self._plan())

    def make_batch(self, chunk: Sequence[int], bucket
                   ) -> Tuple[Batch, List[int], np.ndarray]:
        n = len(chunk)
        g = self.cfg.train.max_gt_boxes
        images = np.zeros((n, bucket[0], bucket[1], 3), np.uint8)
        im_info = np.zeros((n, 3), np.float32)
        for j, i in enumerate(chunk):
            im_info[j] = _place(self.roidb[i], self.load_image, self.cfg,
                                bucket, images, j)
        batch = Batch(images, im_info, np.zeros((n, g, 4), np.float32),
                      np.zeros((n, g), np.int32), np.zeros((n, g), bool))
        return batch, list(chunk), im_info[:, 2].copy()

    def __iter__(self):
        for bucket, chunk in self._plan():
            yield self.make_batch(chunk, bucket)


class ROITestLoader(TestLoader):
    """Eval batches of an RCNN-only checkpoint: those of
    :class:`TestLoader`, as :class:`RCNNBatch` es carrying each record's
    precomputed proposals (raw coordinates, ``tools/test_rpn.py``'s
    pickle) scaled and padded as :class:`ROIIter` does."""

    def __init__(self, roidb: Sequence[Dict], cfg: Config,
                 load_image: LoadImage, proposals: Sequence,
                 batch_images: int = None, max_rois: int = None):
        super().__init__(roidb, cfg, load_image, batch_images)
        self.proposals = _check_proposals(proposals, self.roidb)
        self.max_rois = max_rois or cfg.test.proposal_post_nms_top_n

    def make_batch(self, chunk: Sequence[int], bucket
                   ) -> Tuple[RCNNBatch, List[int], np.ndarray]:
        base, indices, scales = super().make_batch(chunk, bucket)
        rois, rois_valid = _fill_rois(self.proposals, indices, scales,
                                      self.max_rois)
        return (RCNNBatch(*base, rois=rois, rois_valid=rois_valid),
                indices, scales)
