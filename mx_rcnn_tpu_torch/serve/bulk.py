"""Bulk scoring: a corpus streamed through the serving engine into a
sharded sink, every image accounted exactly once.

Counterpart of ``mx_rcnn_tpu/serve/bulk.py``:

* **admission**: the feeder walks the corpus plan of a
  ``data/loader.py — StreamTestLoader`` (fp32 canvases, read ahead by
  the loader's own pool and kept on the host: the rows go to the engine
  as numpy arrays) and ``submit_prepared``\\ s each row
  into its bucket lane, at most ``bulk.max_inflight`` images in flight
  (the feeder blocks; lanes never reach the shed watermark);
* **scoring**: the serving path end to end (static micro-batches, K1
  and K2 on the card, the eval postprocess, ``detections_from_keep``).
  A FAILED or SHED end is resubmitted, ``bulk.retries`` times, and then
  the run aborts: no image is ever dropped;
* **commit**: shard ``k`` holds plan batches ``[k*S, (k+1)*S)`` (``S =
  bulk.shard_batches``) and lands by tmp → fsync → rename → dir fsync
  once all its images are terminal and every earlier shard has landed,
  so a SIGKILL leaves a contiguous committed prefix and nothing else;
* **resume**: the sink's manifest (corpus fingerprint, plan geometry,
  serving knobs, quant tag) admits only the run that wrote it, and the
  committed prefix is the cursor: a restarted run recomputes the plan,
  skips the committed batches and writes shards byte-identical to an
  unbroken run's.

The router is anything with ``submit_prepared``: a
``serve/fleet.py — FleetRouter`` (``tools/bulk.py`` builds one) or a bare
``ServingEngine``.  Given a registry (``obs/metrics.py``), the runner
records ``bulk.*``:
the ``imgs_per_s``, ``inflight`` and ``committed_shards`` gauges, the
``committed_images`` and ``retries`` counters and the
``sink_commit_ms`` histogram; given a run record (``obs/runrec.py``),
``bulk_shard_commit`` and ``bulk_abort`` events.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.serve.queue import FAILED, SERVED, SHED
from mx_rcnn_tpu_torch.utils.checkpoint import _atomic_write

logger = logging.getLogger("mx_rcnn_tpu_torch")

MANIFEST = "MANIFEST.json"


class BulkSinkMismatch(ValueError):
    """The sink's manifest disagrees with this run's corpus, plan or
    serving recipe: resuming would splice other results."""


class BulkAborted(RuntimeError):
    """An image used up its resubmits: the run stops, its accounting
    whole, rather than commit a corpus with holes."""


def corpus_fingerprint(cfg: Config, roidb, seed: int,
                       batch_images: int, model: str = None) -> str:
    """sha256 of what a resume must share: each record's geometry, the
    plan's seed and batch size, the ``model`` identity (``prefix@epoch``
    or ``random-init@seed``), the buckets, the serving knobs, the
    proposal sizes and the quant tag; the JAX package's string."""
    recs = [(int(r.get("index", i)), os.path.basename(r["image"]),
             int(r["height"]), int(r["width"]),
             bool(r.get("flipped", False)))
            for i, r in enumerate(roidb)]
    ident = {
        "records": recs,
        "seed": int(seed),
        "batch_images": int(batch_images),
        "model": model,
        "bucket": {"scale": cfg.bucket.scale,
                   "max_size": cfg.bucket.max_size,
                   "shapes": [list(b) for b in cfg.bucket.shapes]},
        "serve": {"batch_size": cfg.serve.batch_size,
                  "nms": cfg.test.nms,
                  "score_thresh": cfg.serve.score_thresh,
                  "num_classes": cfg.num_classes,
                  "rpn_pre_nms_top_n": cfg.test.rpn_pre_nms_top_n,
                  "rpn_post_nms_top_n": cfg.test.rpn_post_nms_top_n},
        "quant": _quant_tag(cfg),
    }
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()


def _quant_tag(cfg: Config) -> Optional[str]:
    q = cfg.quant
    if not q.enabled:
        return None
    return f"{q.dtype}:{q.mode}:{q.estimator}:{q.weight_bits}"


class BulkSink:
    """``MANIFEST.json`` and ``shard-<k>.jsonl`` files: the manifest
    first (atomically), then each shard whole by ``_atomic_write``, in
    order, so the committed set is always a prefix ``0..n-1``.  A gap
    means foreign interference and is refused; a stray ``.tmp`` (a kill
    before its rename) is removed when the sink opens."""

    def __init__(self, root: str, manifest: Optional[Dict] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        mpath = os.path.join(root, MANIFEST)
        existing = None
        if os.path.exists(mpath):
            with open(mpath) as f:
                existing = json.load(f)
        if manifest is None:
            if existing is None:
                raise ValueError(f"no manifest at {mpath} and none given")
            self.manifest = existing
        elif existing is None:
            self.manifest = dict(manifest)
            _atomic_write(mpath, (json.dumps(self.manifest, indent=1,
                                             sort_keys=True) + "\n").encode())
        else:
            mism = [k for k in manifest if existing.get(k) != manifest[k]]
            if mism:
                raise BulkSinkMismatch(
                    f"sink {root} was written by a different run: manifest "
                    f"keys {sorted(mism)} disagree (e.g. "
                    f"{mism[0]}={existing.get(mism[0])!r} vs "
                    f"{manifest[mism[0]]!r}); resuming would splice "
                    "other results")
            self.manifest = existing
        for name in os.listdir(root):
            if name.endswith(".tmp"):
                os.unlink(os.path.join(root, name))

    @staticmethod
    def shard_name(k: int) -> str:
        return f"shard-{k:05d}.jsonl"

    def shard_path(self, k: int) -> str:
        return os.path.join(self.root, self.shard_name(k))

    def committed_shards(self) -> int:
        """The committed prefix's length: the resume cursor."""
        ids = sorted(int(n[len("shard-"):-len(".jsonl")])
                     for n in os.listdir(self.root)
                     if n.startswith("shard-") and n.endswith(".jsonl"))
        if ids != list(range(len(ids))):
            raise BulkSinkMismatch(
                f"sink {self.root} holds a non-contiguous shard set "
                f"{ids}: commits are in order, so this directory mixes "
                "runs or lost a shard")
        return len(ids)

    def commit(self, k: int, lines: List[str]) -> int:
        """Land shard ``k`` atomically; returns its bytes."""
        data = ("\n".join(lines) + "\n").encode() if lines else b""
        _atomic_write(self.shard_path(k), data)
        return len(data)

    def read_lines(self, k: int) -> List[str]:
        with open(self.shard_path(k)) as f:
            return f.read().splitlines()


def detections_line(index: int, dets: Dict[int, np.ndarray]) -> str:
    """One image's canonical JSONL line, ``{"dets": {class: [[x1, y1,
    x2, y2, score], ...]}, "i": corpus index}`` in raw image coordinates
    (sorted keys, fixed separators, full float repr): equal detections
    give equal bytes."""
    out = {str(c): np.asarray(arr).tolist()
           for c, arr in sorted(dets.items())}
    return json.dumps({"i": int(index), "dets": out},
                      sort_keys=True, separators=(",", ":"))


def auto_inflight(cfg: Config) -> int:
    """The in-flight bound: ``bulk.max_inflight``, or two full
    micro-batches per replica (``fleet.replicas``), under the lane's
    shed watermark."""
    n = cfg.bulk.max_inflight
    if n > 0:
        return n
    n = 2 * cfg.serve.batch_size * max(cfg.fleet.replicas, 1)
    return max(min(n, cfg.serve.shed_watermark - 1), 1)


class BulkRunner:
    """One corpus pass: feed → score → in-order shard commit.

    ``fault(k)`` runs after shard ``k`` commits (the kill-and-resume
    rigs stop the process there).  ``record``: a run record for the
    shard commits and an abort.
    """

    def __init__(self, router, loader, sink: BulkSink, cfg: Config,
                 registry=None,
                 fault: Optional[Callable[[int], None]] = None,
                 record=None):
        self.router = router
        self.loader = loader
        self.sink = sink
        self.cfg = cfg
        self.rec = registry
        self.run_record = record
        self.fault = fault
        self._cond = threading.Condition(threading.Lock())
        self._inflight_bound = auto_inflight(cfg)
        self._inflight = threading.BoundedSemaphore(self._inflight_bound)
        # each plan batch's result slots until its shard commits:
        # {batch: [(corpus index, dets) or None] * rows}
        self._slots: Dict[int, List[Optional[Tuple]]] = {}
        self._pending: Dict[int, int] = {}
        self._complete: set = set()
        self._error: Optional[BaseException] = None
        self._retry_q: List[Tuple] = []
        self._feeding_done = False
        self._n_shards = 0
        self.retries = 0
        self.committed_shards = 0
        self.committed_images = 0

    def _plan_geometry(self) -> Tuple[List[int], int]:
        plan = self.loader._plan(0, self.loader.batch_images)
        sizes = [len(idx) for _, idx in plan]
        return sizes, sum(sizes)

    # ---- completion (dispatcher, caller or retry threads) -----------------

    def _on_done(self, bi: int, j: int, corpus_i: int, data, im_info,
                 bucket, attempt: int, req) -> None:
        state = req.state
        if state == SERVED:
            # the committer serialises; this is often a dispatcher
            # thread, which should get back to the model
            with self._cond:
                slot = self._slots.get(bi)
                if slot is not None and slot[j] is None:
                    slot[j] = (corpus_i, req.result or {})
                    self._pending[bi] -= 1
                    if self._pending[bi] == 0:
                        self._complete.add(bi)
                self._cond.notify_all()
            self._inflight.release()
            return
        if state in (FAILED, SHED) and attempt < self.cfg.bulk.retries:
            # resubmitted from the retry thread: a SHED can end inside
            # submit_prepared, and a resubmit here would recurse
            with self._cond:
                self._retry_q.append((bi, j, corpus_i, data, im_info,
                                      bucket, attempt + 1))
                self.retries += 1
                self._cond.notify_all()
            if self.rec is not None:
                self.rec.inc("bulk.retries")
            return
        err = req.error or RuntimeError(f"terminal state {state}")
        with self._cond:
            if self._error is None:
                self._error = BulkAborted(
                    f"image {corpus_i} (plan batch {bi} row {j}) ended "
                    f"{state} after {attempt + 1} attempt(s): {err}")
            self._cond.notify_all()
        self._inflight.release()

    def _submit(self, bi: int, j: int, corpus_i: int, data, im_info,
                bucket, attempt: int) -> None:
        req = self.router.submit_prepared(data, im_info, bucket,
                                          timeout_ms=0)
        req.add_done_callback(
            lambda done, a=(bi, j, corpus_i, data, im_info, bucket,
                            attempt): self._on_done(*a, done))

    def _retry_worker(self) -> None:
        backoff = 0.01
        while True:
            with self._cond:
                while not self._retry_q and self._error is None \
                        and not self._done_feeding_and_committed():
                    self._cond.wait(timeout=0.2)
                if self._error is not None \
                        or (not self._retry_q
                            and self._done_feeding_and_committed()):
                    return
                item = self._retry_q.pop(0)
            # paced: a full lane or a restarting engine needs a moment
            time.sleep(min(backoff * item[-1], 0.25))
            self._submit(*item)

    def _done_feeding_and_committed(self) -> bool:
        return self._feeding_done and self.committed_shards >= self._n_shards

    # ---- committer (one thread: commits in order) ----------------------------

    def _committer(self, n_batches: int, t0: float) -> None:
        S = max(self.cfg.bulk.shard_batches, 1)
        try:
            for k in range(self.committed_shards, self._n_shards):
                lo, hi = k * S, min((k + 1) * S, n_batches)
                with self._cond:
                    while not all(b in self._complete
                                  for b in range(lo, hi)):
                        if self._error is not None:
                            return
                        self._cond.wait(timeout=0.5)
                    results = []
                    for b in range(lo, hi):
                        results.extend(self._slots.pop(b))
                        self._pending.pop(b, None)
                        self._complete.discard(b)
                lines = [detections_line(ci, res) for ci, res in results]
                tc = time.perf_counter()
                self.sink.commit(k, lines)  # fsync outside the lock
                commit_ms = (time.perf_counter() - tc) * 1e3
                with self._cond:
                    self.committed_shards = k + 1
                    self.committed_images += len(lines)
                    self._cond.notify_all()
                if self.rec is not None:
                    self.rec.observe("bulk.sink_commit_ms", commit_ms)
                    self.rec.set_gauge("bulk.committed_shards",
                                       self.committed_shards)
                    self.rec.inc("bulk.committed_images", len(lines))
                    self.rec.set_gauge(
                        "bulk.imgs_per_s",
                        round(self.committed_images
                              / max(time.perf_counter() - t0, 1e-9), 2))
                if self.run_record is not None:
                    self.run_record.event("bulk_shard_commit", shard=k,
                                          images=len(lines),
                                          commit_ms=round(commit_ms, 3))
                if self.fault is not None:
                    self.fault(k)
        except BaseException as e:  # noqa: BLE001 — re-raised in run()
            with self._cond:
                if self._error is None:
                    self._error = e
                self._cond.notify_all()

    # ---- the run -----------------------------------------------------------

    def run(self) -> Dict:
        """One corpus pass, resumed from the sink's committed prefix;
        returns the accounting record, or raises :class:`BulkAborted`
        (or the error underneath) rather than count short."""
        cfg = self.cfg
        batch_sizes, planned_images = self._plan_geometry()
        n_batches = len(batch_sizes)
        S = max(cfg.bulk.shard_batches, 1)
        self._n_shards = -(-n_batches // S) if n_batches else 0
        done = self.sink.committed_shards()
        skip_batches = min(done * S, n_batches)
        resumed_images = sum(batch_sizes[:skip_batches])
        self.committed_shards = done
        self.committed_images = 0
        self._feeding_done = skip_batches >= n_batches
        self.loader.set_epoch(0)
        if skip_batches:
            self.loader.skip_next_batches(skip_batches)
            logger.info("bulk resume: %d shard(s) committed, skipping %d "
                        "plan batches (%d images)", done, skip_batches,
                        resumed_images)

        t0 = time.perf_counter()
        committer = threading.Thread(target=self._committer,
                                     args=(n_batches, t0),
                                     name="bulk-committer", daemon=True)
        committer.start()
        retrier = threading.Thread(target=self._retry_worker,
                                   name="bulk-retry", daemon=True)
        retrier.start()
        batches = None
        try:
            if not self._feeding_done:
                # the rows stay on the host: the engine composes and
                # copies its batches
                batches = iter(self.loader)
                bi = skip_batches
                for batch, indices, _ in batches:
                    bucket = tuple(batch.images.shape[1:3])
                    with self._cond:
                        if self._error is not None:
                            break
                        self._slots[bi] = [None] * len(indices)
                        self._pending[bi] = len(indices)
                    if self.rec is not None:
                        self.rec.set_gauge(
                            "bulk.inflight",
                            self._inflight_bound - self._inflight._value)
                    for j, corpus_i in enumerate(indices):
                        while not self._inflight.acquire(timeout=1.0):
                            if self._error is not None:
                                raise self._error
                        # row views: an in-flight row pins its batch,
                        # and the in-flight bound caps how many are live
                        self._submit(bi, j, int(corpus_i), batch.images[j],
                                     batch.im_info[j], bucket, 0)
                    bi += 1
                with self._cond:
                    self._feeding_done = True
                    self._cond.notify_all()
            committer.join()
            retrier.join()
        finally:
            if batches is not None:
                batches.close()
            with self._cond:
                self._feeding_done = True
                self._cond.notify_all()
        if self._error is not None:
            from mx_rcnn_tpu_torch.obs import flightrec

            if self.run_record is not None:
                self.run_record.event("bulk_abort",
                                      error=repr(self._error)[:500],
                                      committed_shards=self.committed_shards)
            flightrec.trigger("bulk-abort", error=repr(self._error)[:500])
            raise self._error
        wall = time.perf_counter() - t0
        accounted = resumed_images + self.committed_images
        rate = self.committed_images / max(wall, 1e-9)
        if self.rec is not None:
            self.rec.set_gauge("bulk.imgs_per_s", round(rate, 2))
            self.rec.set_gauge("bulk.inflight", 0)
        return {
            "planned_images": planned_images,
            "planned_batches": n_batches,
            "shards": self._n_shards,
            "resumed_shards": done,
            "resumed_images": resumed_images,
            "scored_images": self.committed_images,
            "accounted_images": accounted,
            "lost": planned_images - accounted,
            "retries": self.retries,
            "wall_s": round(wall, 3),
            "imgs_per_sec": round(rate, 2),
        }


def make_sink_manifest(cfg: Config, roidb, seed: int,
                       batch_images: int, model: str = None) -> Dict:
    """The sink's admission record, everything a resume must agree on
    (``model``: the weights' identity, folded into the fingerprint)."""
    return {
        "version": 1,
        "corpus": corpus_fingerprint(cfg, roidb, seed, batch_images,
                                     model=model),
        "images": len(roidb),
        "batch_images": int(batch_images),
        "shard_batches": int(cfg.bulk.shard_batches),
        "seed": int(seed),
        "model": model,
        "serve_batch_size": cfg.serve.batch_size,
        "nms_thresh": cfg.test.nms,
        "score_thresh": cfg.serve.score_thresh,
        "rpn_pre_nms_top_n": cfg.test.rpn_pre_nms_top_n,
        "rpn_post_nms_top_n": cfg.test.rpn_post_nms_top_n,
        "quant": _quant_tag(cfg),
    }
