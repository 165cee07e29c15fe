"""Training and eval batches from a roidb.

Counterpart of ``mx_rcnn_tpu/data/loader.py``: ``AnchorLoader``,
``StreamLoader``, ``ROIIter``, ``TestLoader`` and ``ROITestLoader``, with
their batch plans and ``_make_batch`` semantics, the image source
(``_ImageSource``: decode cache, decode pool, ``raw_images`` and the
decode count), the assembly threads (``_prefetched``) and the cache and
pool factories (``stream_cache_budget``, ``cache_from_config``,
``decode_pool_from_config``).  Each record's pixels come from
``load_image(rec)`` (the imdb's), or, for the on-disk readers, from a
:class:`DecodedImageCache` or a :class:`DecodePool` that read the
record's file themselves; they are mirrored when the record is flipped,
resized into its bucket and kept as raw uint8 (normalised on the device)
unless ``raw_images`` is off.  A training batch also carries the gt boxes
scaled by ``im_scale`` and padded to ``max_gt_boxes``, and a
proposal-fed batch (:class:`RCNNBatch`) the proposals, scaled the same
way and padded to ``max_rois`` slots.  Batches hold numpy arrays;
``core/fit.py`` (through ``data/staging.py``) moves them to the device.
A resumed run positions a :class:`StreamLoader` mid-epoch by the
manifest's data cursor (:meth:`StreamLoader.resume_at`).  In a
data-parallel run each rank's training loader owns a row shard of every
batch of the global plan (:meth:`AnchorLoader.set_shard`).
Not ported yet: ``StreamTestLoader``.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import Batch, RCNNBatch
from mx_rcnn_tpu_torch.data.cache import DecodedImageCache, plan_scale
from mx_rcnn_tpu_torch.data.image import (choose_bucket, compute_scale,
                                          flip_resize_fit)
from mx_rcnn_tpu_torch.data.roidb import reads_files

LoadImage = Callable[[Dict], np.ndarray]
Plan = List[Tuple[Tuple[int, int], List[int]]]

# host RAM reserved under data.ram_ceiling_mb before any cache budget:
# the interpreter, torch and the loader's scratch
_PROCESS_FLOOR_BYTES = 1 << 30

logger = logging.getLogger("mx_rcnn_tpu_torch")


def stream_cache_budget(cfg: Config, n_images: Optional[int] = None,
                        image_bytes: Optional[int] = None,
                        batch_bytes: int = 0) -> int:
    """The decoded-image cache's RAM budget in bytes, logged once:
    ``default.image_cache_mb``, capped by the decoded size of the whole
    set (``n_images * image_bytes``) and, under ``data.ram_ceiling_mb``,
    by what the ceiling leaves after the process floor and the streaming
    window (prefetch depth, assembly threads and staged batches, one
    batch each)."""
    d = cfg.default
    budget = d.image_cache_mb << 20
    if budget <= 0:
        return 0
    why = [f"configured={d.image_cache_mb}MB"]
    if n_images and image_bytes:
        dataset = int(n_images) * int(image_bytes)
        if dataset < budget:
            budget = dataset
            why.append(f"dataset={dataset >> 20}MB ({n_images} images)")
    data = cfg.data
    ceiling = data.ram_ceiling_mb << 20
    if ceiling > 0:
        depth = data.stage_depth if data.staging else 0
        window = (d.prefetch + max(d.num_workers, 1) + depth + 1) \
            * max(int(batch_bytes), 0)
        room = max(ceiling - _PROCESS_FLOOR_BYTES - window, 0)
        if room < budget:
            budget = room
            why.append(f"ceiling={data.ram_ceiling_mb}MB - floor "
                       f"{_PROCESS_FLOOR_BYTES >> 20}MB - window "
                       f"{window >> 20}MB")
    logger.info("decoded-image cache budget: %d MB (%s)", budget >> 20,
                ", ".join(why))
    return budget


def cache_from_config(cfg: Config, n_images: Optional[int] = None,
                      image_bytes: Optional[int] = None,
                      batch_bytes: int = 0) -> Optional[DecodedImageCache]:
    """The decoded-image cache the config asks for, or None, its RAM tier
    budgeted by :func:`stream_cache_budget`."""
    d = cfg.default
    if d.image_cache_mb <= 0 and not d.image_cache_dir:
        return None
    budget = stream_cache_budget(cfg, n_images, image_bytes, batch_bytes)
    if budget <= 0 and not d.image_cache_dir:
        return None
    return DecodedImageCache(ram_bytes=budget,
                             cache_dir=d.image_cache_dir or None)


def decode_pool_from_config(cfg: Config, n_images: Optional[int] = None,
                            image_bytes: Optional[int] = None,
                            batch_bytes: int = 0):
    """The decode pool the config asks for (``default.decode_procs`` > 0),
    or None.  The RAM tier moves into the workers, the budget split
    between them (at least 1 MiB each); the disk tier is shared.  The
    caller closes the pool."""
    d = cfg.default
    if d.decode_procs <= 0:
        return None
    from mx_rcnn_tpu_torch.data.decode_pool import DecodePool

    total = stream_cache_budget(cfg, n_images, image_bytes, batch_bytes)
    per_worker = total // d.decode_procs
    if total > 0 and per_worker < (1 << 20):
        logger.warning(
            "cache budget %d MB split across decode_procs=%d leaves under "
            "1 MB per worker; each worker's RAM tier is clamped to 1 MB",
            total >> 20, d.decode_procs)
        per_worker = 1 << 20
    return DecodePool(d.decode_procs, cache_dir=d.image_cache_dir or None,
                      ram_bytes=per_worker)


def _bucket_of(rec: Dict, cfg: Config, buckets) -> Tuple[int, int]:
    """The bucket of a roidb record after the reference resize."""
    h, w = rec["height"], rec["width"]
    s = compute_scale(h, w, cfg.bucket.scale, cfg.bucket.max_size)
    return choose_bucket(int(round(h * s)), int(round(w * s)), buckets)


class _ImageSource:
    """The decode plumbing the loaders share: the record's pixels from
    the decode pool, else the cache, else ``load_image``; written into a
    uint8 canvas (``raw_images``) or mean-subtracted into an fp32 one.
    ``images_decoded`` counts the images this loader decoded, and
    :meth:`record_decodes` collects their (roidb index, flipped)
    identities.  With ``cfg.obs.enabled`` the loader records into the
    process registry: ``loader.images_decoded``, ``loader.decode_ms`` (a
    batch's images), ``loader.assemble_ms`` and ``loader.batches`` (a
    batch, on its assembly thread) and the ``loader.queue_depth`` gauge
    (batches in flight when one is handed over; 0: the consumer waits
    on decoding)."""

    def _init_source(self, roidb: Sequence[Dict], cfg: Config,
                     load_image: LoadImage, num_workers, prefetch,
                     raw_images, cache, decode_pool) -> None:
        if (cache is not None or decode_pool is not None) \
                and not reads_files(load_image):
            raise ValueError(
                "a decode cache or pool reads each record's image file; "
                "this roidb's load_image makes its pixels otherwise")
        self.roidb = list(roidb)
        self.cfg = cfg
        self.load_image = load_image
        d = cfg.default
        self.num_workers = d.num_workers if num_workers is None \
            else num_workers
        self.prefetch = d.prefetch if prefetch is None else prefetch
        self.raw_images = d.raw_images if raw_images is None else raw_images
        self.cache = cache
        self.decode_pool = decode_pool
        self._pixel_means = np.asarray(cfg.network.pixel_means, np.float32)
        self.buckets = tuple(tuple(s) for s in cfg.bucket.shapes)
        self._bucket_ids = [_bucket_of(rec, cfg, self.buckets)
                            for rec in self.roidb]
        self.images_decoded = 0
        self.decoded_ids: Optional[List[Tuple[int, bool]]] = None
        self._decode_count_lock = threading.Lock()
        self._rec = None
        if cfg.obs.enabled:
            from mx_rcnn_tpu_torch.obs.metrics import registry

            self._rec = registry()

    def _indices_for(self, bucket) -> List[int]:
        return [i for i, b in enumerate(self._bucket_ids) if b == bucket]

    def record_decodes(self, on: bool = True) -> None:
        """Start (or stop) collecting the (roidb index, flipped) identity
        of every decoded image."""
        with self._decode_count_lock:
            self.decoded_ids = [] if on else None

    def _image_buffer(self, n: int, bucket) -> np.ndarray:
        dtype = np.uint8 if self.raw_images else np.float32
        return np.zeros((n, bucket[0], bucket[1], 3), dtype)

    def _write_slot(self, out: np.ndarray, img: np.ndarray
                    ) -> Tuple[int, int]:
        h, w = img.shape[:2]
        if self.raw_images:
            out[:h, :w] = img
        else:
            np.subtract(img, self._pixel_means, out=out[:h, :w],
                        casting="unsafe")
        return h, w

    def _images_into(self, images: np.ndarray, recs: Sequence[Dict], bucket
                     ) -> List[Tuple[int, int, float]]:
        """Decode ``recs`` into rows of the padded canvas ``images``; one
        (h, w, im_scale) per record.  With a decode pool every image of
        the batch is in flight at once and ``im_scale`` comes from the
        record's geometry."""
        with self._decode_count_lock:
            self.images_decoded += len(recs)
            if self.decoded_ids is not None:
                self.decoded_ids.extend(
                    (int(rec.get("index", -1)),
                     bool(rec.get("flipped", False))) for rec in recs)
        if self._rec is None:
            return self._decode_into(images, recs, bucket)
        self._rec.inc("loader.images_decoded", len(recs))
        t0 = time.perf_counter()
        out = self._decode_into(images, recs, bucket)
        self._rec.observe("loader.decode_ms",
                          (time.perf_counter() - t0) * 1e3)
        return out

    def _decode_into(self, images: np.ndarray, recs: Sequence[Dict], bucket
                     ) -> List[Tuple[int, int, float]]:
        scale, max_size = self.cfg.bucket.scale, self.cfg.bucket.max_size
        futs = None
        if self.decode_pool is not None:
            futs = [self.decode_pool.submit(rec["image"],
                                            rec.get("flipped", False),
                                            scale, max_size, bucket)
                    for rec in recs]
        infos = []
        for j, rec in enumerate(recs):
            flipped = rec.get("flipped", False)
            if futs is None and self.cache is None:
                img, im_scale = flip_resize_fit(self.load_image(rec),
                                                flipped, scale, max_size,
                                                bucket)
            else:
                img = (futs[j].result() if futs is not None else
                       self.cache.load(rec["image"], flipped, scale,
                                       max_size, bucket))
                im_scale = plan_scale(rec["height"], rec["width"], scale,
                                      max_size, bucket)
            infos.append(self._write_slot(images[j], img) + (im_scale,))
        return infos

    def _make_images(self, indices: Sequence[int], bucket
                     ) -> Tuple[np.ndarray, np.ndarray, List[float]]:
        """The canvas, the float32 im_info (h, w, im_scale) and the
        scales as Python floats of records ``indices``."""
        images = self._image_buffer(len(indices), bucket)
        infos = self._images_into(images, [self.roidb[i] for i in indices],
                                  bucket)
        im_info = np.asarray(infos, np.float32).reshape(-1, 3)
        return images, im_info, [info[2] for info in infos]

    def _batches(self, plan: Plan, make: Callable) -> Iterator:
        return _prefetched(plan, lambda b: make(b[1], b[0]),
                           self.num_workers, self.prefetch, self._rec)


def _prefetched(work: Iterable, make: Callable, num_workers: int,
                prefetch: int, rec=None) -> Iterator:
    """``make(item)`` for each item on a pool of ``num_workers`` threads,
    up to ``prefetch`` results in flight, yielded in order (cv2 and numpy
    release the interpreter lock, so assembly overlaps the steps);
    ``num_workers`` 0 assembles on the caller's thread.  Abandoning the
    iterator drops the queued work.  ``rec`` (a registry, or None):
    ``loader.assemble_ms`` and ``loader.batches`` on the assembling
    thread, the ``loader.queue_depth`` gauge at each hand-over."""
    if rec is not None:
        inner = make

        def make(item):
            t0 = time.perf_counter()
            out = inner(item)
            rec.observe("loader.assemble_ms",
                        (time.perf_counter() - t0) * 1e3)
            rec.inc("loader.batches")
            return out

    if num_workers <= 0:
        for item in work:
            yield make(item)
        return
    ex = ThreadPoolExecutor(num_workers)
    futures: deque = deque()
    it = iter(work)
    exhausted = False
    try:
        while True:
            while not exhausted and len(futures) < max(prefetch, 1):
                try:  # only the source: a worker's StopIteration propagates
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                futures.append(ex.submit(make, item))
            if not futures:
                break
            fut = futures.popleft()
            if rec is not None:
                rec.set_gauge("loader.queue_depth", len(futures))
            yield fut.result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


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


class AnchorLoader(_ImageSource):
    """Iterating yields one epoch of :class:`Batch` es; the images of a
    batch share a bucket.  ``load_image(rec)`` gives a record's RGB uint8
    pixels (``IMDB.load_image``).  The plan shuffles each bucket's
    images, chunks them into batches and shuffles the batch list, from
    one RNG seeded by (seed, epoch).  ``shard=(shard_id, num_shards)``
    makes the loader yield only its rows of each batch
    (:meth:`set_shard`)."""

    def __init__(self, roidb: Sequence[Dict], cfg: Config,
                 load_image: LoadImage, batch_images: int = None,
                 shuffle: bool = None, seed: int = 0,
                 num_workers: int = None, prefetch: int = None,
                 raw_images: bool = None, cache: DecodedImageCache = None,
                 decode_pool=None, shard: Tuple[int, int] = None):
        self._init_source(roidb, cfg, load_image, num_workers, prefetch,
                          raw_images, cache, decode_pool)
        self.batch_images = batch_images or cfg.train.batch_images
        self.shuffle = cfg.train.shuffle if shuffle is None else shuffle
        self.seed = seed
        self._epoch = 0
        self._skip_next = 0
        self.shard: Optional[Tuple[int, int]] = None
        if shard is not None:
            self.set_shard(*shard)

    def __len__(self) -> int:
        return sum(len(self._indices_for(bucket)) // self.batch_images
                   for bucket in set(self._bucket_ids))

    def set_epoch(self, epoch: int) -> None:
        """Pin the next epoch's shuffle to ``epoch``: a run resumed at
        epoch k replays the batches the unbroken run saw."""
        self._epoch = epoch

    def set_shard(self, shard_id: int, num_shards: int) -> None:
        """Own rows ``[shard_id * per, (shard_id + 1) * per)`` of every
        batch, ``per = batch_images / num_shards``.  The plan stays the
        global one, the same on every rank for a (seed, epoch); each rank
        decodes only its rows, so the union of the shards' yields is the
        unsharded batches byte for byte.  ``num_shards`` of 1 or less
        clears the shard."""
        if num_shards is None or num_shards <= 1:
            self.shard = None
            return
        if not 0 <= shard_id < num_shards:
            raise ValueError(
                f"shard_id={shard_id} out of range for {num_shards} shards")
        if self.batch_images % num_shards:
            raise ValueError(
                f"batch_images={self.batch_images} is not divisible by "
                f"num_shards={num_shards} — rows cannot be owned evenly "
                f"(choose a divisor topology)")
        self.shard = (int(shard_id), int(num_shards))

    def _shard_rows(self, batches: Plan) -> Plan:
        """This shard's rows of every (bucket, indices) entry of a global
        plan (the plan itself without a shard)."""
        if self.shard is None:
            return batches
        sid, n = self.shard
        per = self.batch_images // n
        return [(bucket, idx[sid * per:(sid + 1) * per])
                for bucket, idx in batches]

    def skip_next_batches(self, n: int) -> None:
        """Drop the first ``n`` batches of the next epoch only, before any
        image is decoded."""
        self._skip_next = n

    def _epoch_plan(self, epoch: int) -> Plan:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + epoch) % (2 ** 31))
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

    def plan(self) -> Plan:
        """The next epoch's (bucket, roidb indices) batches, as the JAX
        loader orders them for (seed, epoch), less any skipped prefix;
        advances the epoch."""
        epoch = self._epoch
        self._epoch += 1
        batches = self._epoch_plan(epoch)
        if self._skip_next:
            batches = batches[self._skip_next:]
            self._skip_next = 0
        return batches

    def make_batch(self, indices: Sequence[int], bucket) -> Batch:
        g = self.cfg.train.max_gt_boxes
        n = len(indices)
        images, im_info, scales = self._make_images(indices, bucket)
        gt_boxes = np.zeros((n, g, 4), np.float32)
        gt_classes = np.zeros((n, g), np.int32)
        gt_valid = np.zeros((n, g), bool)
        for j, i in enumerate(indices):
            rec = self.roidb[i]
            k = min(len(rec["boxes"]), g)
            if k:
                gt_boxes[j, :k] = rec["boxes"][:k] * scales[j]
                gt_classes[j, :k] = rec["gt_classes"][:k]
                gt_valid[j, :k] = True
        return Batch(images, im_info, gt_boxes, gt_classes, gt_valid)

    def __iter__(self) -> Iterator[Batch]:
        return self._batches(self._shard_rows(self.plan()), self.make_batch)


class StreamLoader(AnchorLoader):
    """The training loader whose plan is a pure function of (seed, epoch)
    at image granularity (``cfg.data.streaming``, the default): each
    bucket's epoch order comes from its own RNG seeded by (seed, epoch,
    bucket), batches are consecutive chunks of each bucket's stream, and
    the buckets interleave by largest remaining fraction of their
    batches.  The first K images of an epoch are then the same set under
    any batch size dividing K.  Images past a bucket's last full batch
    wait for the next epoch, as in :class:`AnchorLoader`."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._resume: Optional[Tuple[int, int]] = None

    def _bucket_orders(self, epoch: int) -> Dict[Tuple[int, int], List[int]]:
        """{bucket: the epoch's image order}, each from its own RNG."""
        orders = {}
        for bucket in sorted(set(self._bucket_ids)):
            idx = self._indices_for(bucket)
            if self.shuffle:
                s = zlib.crc32(
                    f"{self.seed}:{epoch}:{bucket[0]}x{bucket[1]}".encode()
                ) % (2 ** 31)
                np.random.RandomState(s).shuffle(idx)
            orders[bucket] = idx
        return orders

    @staticmethod
    def _interleave(counts: Dict) -> List:
        """The bucket of each batch in turn: always the bucket with the
        largest remaining fraction of its own batches (ties to the
        smaller bucket tuple)."""
        remaining = {b: n for b, n in counts.items() if n > 0}
        totals = dict(remaining)
        seq = []
        while remaining:
            bucket = max(sorted(remaining),
                         key=lambda b: remaining[b] / totals[b])
            seq.append(bucket)
            remaining[bucket] -= 1
            if not remaining[bucket]:
                del remaining[bucket]
        return seq

    def _plan(self, epoch: int, batch_images: int,
              offsets: Optional[Dict] = None) -> Plan:
        """The epoch's batch plan [(bucket, indices), ...] at
        ``batch_images``, each bucket's stream starting past its consumed
        prefix ``offsets[bucket]``."""
        off = offsets or {}
        streams = {b: o[off.get(b, 0):]
                   for b, o in self._bucket_orders(epoch).items()}
        counts = {b: len(s) // batch_images for b, s in streams.items()}
        pos = {b: 0 for b in streams}
        plan = []
        for bucket in self._interleave(counts):
            p = pos[bucket]
            plan.append((bucket, streams[bucket][p:p + batch_images]))
            pos[bucket] = p + batch_images
        return plan

    def resume_at(self, images_consumed: int,
                  old_batch_images: Optional[int] = None) -> None:
        """Start the next epoch (pinned by :meth:`set_epoch`) after its
        first ``images_consumed`` images, as consumed by a run at
        ``old_batch_images`` a batch (the manifest's data cursor; the
        current size by default).  At the same size the recording run's
        plan is trimmed, so its order goes on; at another, each bucket's
        consumed prefix is found by replaying that run's plan and the
        rest is chunked at the current size."""
        images = int(images_consumed)
        old_bi = int(old_batch_images or self.batch_images)
        if images % old_bi:
            raise ValueError(
                f"cursor images_consumed={images} is not a multiple of "
                f"the recording run's batch_images={old_bi} — the cursor "
                f"does not sit on a batch boundary")
        self._resume = (images, old_bi)

    def _consumed_offsets(self, epoch: int, images: int,
                          old_bi: int) -> Dict:
        """Each bucket's images consumed after ``images`` images of the
        epoch on the plan at ``old_bi`` a batch."""
        plan = self._plan(epoch, old_bi)
        nb = images // old_bi
        if nb > len(plan):
            raise ValueError(
                f"cursor consumed {nb} batches but the epoch only has "
                f"{len(plan)} at batch_images={old_bi} — wrong epoch or "
                f"wrong dataset")
        offsets: Dict = {}
        for bucket, idx in plan[:nb]:
            offsets[bucket] = offsets.get(bucket, 0) + len(idx)
        return offsets

    def _epoch_plan(self, epoch: int) -> Plan:
        """The epoch's plan, with a pending :meth:`resume_at` applied
        (and consumed)."""
        if self._resume is None:
            return self._plan(epoch, self.batch_images)
        images, old_bi = self._resume
        self._resume = None
        if old_bi == self.batch_images:
            return self._plan(epoch, old_bi)[images // old_bi:]
        return self._plan(epoch, self.batch_images,
                          self._consumed_offsets(epoch, images, old_bi))


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
                 seed: int = 0, max_rois: int = None,
                 shard: Tuple[int, int] = None, **source):
        super().__init__(roidb, cfg, load_image, batch_images, shuffle, seed,
                         shard=shard, **source)
        self.proposals = _check_proposals(proposals, self.roidb)
        self.max_rois = max_rois or cfg.test.proposal_post_nms_top_n

    def make_batch(self, indices: Sequence[int], bucket) -> RCNNBatch:
        base = super().make_batch(indices, bucket)
        rois, rois_valid = _fill_rois(self.proposals, indices,
                                      base.im_info[:, 2], self.max_rois)
        return RCNNBatch(*base, rois=rois, rois_valid=rois_valid)


class TestLoader(_ImageSource):
    """Eval batches (ref ``TestLoader``): iterating yields ``(Batch,
    indices, scales)`` with zero gt fields, ``indices`` the roidb
    positions and ``scales`` each image's ``im_scale``, which maps its
    detections back to raw image coordinates.  Images are grouped by
    bucket in roidb order; each bucket's last batch may be short.
    ``load_image(rec)`` gives a record's RGB uint8 pixels (``IMDB.
    load_image``); a flipped record is mirrored, as the alternate
    schedule's proposal dumps over the training roidb need."""

    def __init__(self, roidb: Sequence[Dict], cfg: Config,
                 load_image: LoadImage, batch_images: int = None,
                 num_workers: int = None, prefetch: int = None,
                 raw_images: bool = None, cache: DecodedImageCache = None,
                 decode_pool=None):
        self._init_source(roidb, cfg, load_image, num_workers, prefetch,
                          raw_images, cache, decode_pool)
        self.batch_images = batch_images or cfg.test.batch_images

    def _plan(self) -> Plan:
        batches = []
        for bucket in sorted(set(self._bucket_ids)):
            idx = self._indices_for(bucket)
            for s in range(0, len(idx), self.batch_images):
                batches.append((bucket, idx[s:s + self.batch_images]))
        return batches

    def __len__(self) -> int:
        return len(self._plan())

    def make_batch(self, chunk: Sequence[int], bucket
                   ) -> Tuple[Batch, List[int], np.ndarray]:
        n = len(chunk)
        g = self.cfg.train.max_gt_boxes
        images, im_info, _ = self._make_images(chunk, bucket)
        batch = Batch(images, im_info, np.zeros((n, g, 4), np.float32),
                      np.zeros((n, g), np.int32), np.zeros((n, g), bool))
        return batch, list(chunk), im_info[:, 2].copy()

    def __iter__(self):
        return self._batches(self._plan(), self.make_batch)


class ROITestLoader(TestLoader):
    """Eval batches of an RCNN-only checkpoint: those of
    :class:`TestLoader`, as :class:`RCNNBatch` es carrying each record's
    precomputed proposals (raw coordinates, ``tools/test_rpn.py``'s
    pickle) scaled and padded as :class:`ROIIter` does."""

    def __init__(self, roidb: Sequence[Dict], cfg: Config,
                 load_image: LoadImage, proposals: Sequence,
                 batch_images: int = None, max_rois: int = None, **source):
        super().__init__(roidb, cfg, load_image, batch_images, **source)
        self.proposals = _check_proposals(proposals, self.roidb)
        self.max_rois = max_rois or cfg.test.proposal_post_nms_top_n

    def make_batch(self, chunk: Sequence[int], bucket
                   ) -> Tuple[RCNNBatch, List[int], np.ndarray]:
        base, indices, scales = super().make_batch(chunk, bucket)
        rois, rois_valid = _fill_rois(self.proposals, indices, scales,
                                      self.max_rois)
        return (RCNNBatch(*base, rois=rois, rois_valid=rois_valid),
                indices, scales)
