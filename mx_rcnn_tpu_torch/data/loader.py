"""Training batches from an in-memory dataset.

Counterpart of ``mx_rcnn_tpu/data/loader.py — AnchorLoader`` with its
batch plan and ``_make_batch`` semantics, and without the decode pool,
cache, shards or streaming: each image is resized into its bucket, kept
as raw uint8 (normalised on the device), and its gt boxes are scaled by
``im_scale`` and padded to ``max_gt_boxes``.  Batches hold numpy arrays;
``core/train.py — to_device`` moves them.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import Batch
from mx_rcnn_tpu_torch.data.image import (choose_bucket, compute_scale,
                                          fit_to_bucket, resize_keep_ratio)


class AnchorLoader:
    """Iterating yields one epoch of :class:`Batch` es; the images of a
    batch share a bucket.  ``dataset`` has ``num_images``, ``image_size``
    (h, w), ``specs`` (``boxes``, ``gt_classes``) and ``render(i)``."""

    def __init__(self, dataset, cfg: Config, batch_images: int = None,
                 shuffle: bool = None, seed: int = 0):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_images = batch_images or cfg.train.batch_images
        self.shuffle = cfg.train.shuffle if shuffle is None else shuffle
        self.seed = seed
        self._epoch = 0
        b = cfg.bucket
        self.buckets = tuple(tuple(s) for s in b.shapes)
        h, w = dataset.image_size
        s = compute_scale(h, w, b.scale, b.max_size)
        bucket = choose_bucket(int(round(h * s)), int(round(w * s)),
                               self.buckets)
        self._bucket_ids = [bucket] * dataset.num_images

    def __len__(self) -> int:
        return sum(len(self._indices_for(bucket)) // self.batch_images
                   for bucket in set(self._bucket_ids))

    def _indices_for(self, bucket) -> List[int]:
        return [i for i, b in enumerate(self._bucket_ids) if b == bucket]

    def plan(self) -> List[Tuple[Tuple[int, int], List[int]]]:
        """The next epoch's (bucket, image indices) batches, as the JAX
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
            img, im_scale = resize_keep_ratio(self.dataset.render(i),
                                              cfg.bucket.scale,
                                              cfg.bucket.max_size)
            img, im_scale = fit_to_bucket(img, im_scale, bucket)
            h, w = img.shape[:2]
            images[j, :h, :w] = img
            im_info[j] = (h, w, im_scale)
            spec = self.dataset.specs[i]
            k = min(len(spec["boxes"]), g)
            if k:
                gt_boxes[j, :k] = spec["boxes"][:k] * im_scale
                gt_classes[j, :k] = spec["gt_classes"][:k]
                gt_valid[j, :k] = True
        return Batch(images, im_info, gt_boxes, gt_classes, gt_valid)

    def __iter__(self) -> Iterator[Batch]:
        for bucket, idx in self.plan():
            yield self.make_batch(idx, bucket)
