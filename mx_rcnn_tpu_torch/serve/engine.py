"""Online serving engine: micro-batching over the static-bucket
``Predictor``.

Counterpart of ``mx_rcnn_tpu/serve/engine.py — ServingEngine``:

* a request is one image; ``submit`` resizes and pads it with the
  eval's own ``prepare_image`` on the caller's thread and routes it
  to its bucket's bounded queue (``serve/queue.py``);
* one dispatcher thread per bucket gathers requests into micro-batches
  (at most ``serve.batch_size``, waiting at most ``serve.max_delay_ms``)
  and always pads the batch to ``batch_size`` rows, so a bucket runs one
  batch shape;
* a batch runs ``Predictor.raw`` (proposals through K1, ROIAlign through
  K2 on the card) and the eval's ``_postprocess_batch`` (per-class NMS,
  K1) on the predictor's device, then comes to the host once, one
  ``.cpu()`` per output, and ``detections_from_keep`` splits it per
  request: a served image gets what the offline path gives the same
  batch, bit for bit.

Every dispatcher launches on its device's default stream, so the two
buckets' batches share one queue of work on the card.  With host spans on
(``obs/trace.py``), a request opens a ``serve.request`` interval at
admission and its batch records ``serve.queue_wait`` per rider and one
``serve.batch`` span (launches, forward, postprocess and the result's
copy to the host, the batch's one sync); a request with a distributed
context (``tctx``) records ``serve.lane_wait`` and ``serve.compute``
under it.

Two more ways in, as in the JAX package: ``submit_prepared`` takes a
canvas already padded and normalised (the bulk tier's loader rows), and
``submit_source`` a resized uint8 image whose bucket is known (it pays
only ``pad_normalize``, after the shed check).  ``warm_from_export``
joins from an export store (``serve/export.py``): its checks, its kernel
libraries, each bucket's dummy batch held to the recorded digests.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.tester import (Predictor, _postprocess_batch,
                                           detections_from_keep,
                                           tiled_bbox_stats)
from mx_rcnn_tpu_torch.data.image import (estimate_bucket, pad_normalize,
                                          prepare_image)
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.metrics import ServeMetrics
from mx_rcnn_tpu_torch.serve.queue import (EXPIRED, FAILED, SERVED, SHED,
                                           BoundedQueue, ServeRequest)

logger = logging.getLogger("mx_rcnn_tpu_torch")


class ServingEngine:
    """Micro-batching front end over a :class:`Predictor`.

    ``start=False`` builds the engine without its dispatcher threads (the
    tests fill queues that way without racing them); :meth:`start`
    starts them, :meth:`close` drains and joins.  ``run_fn(images,
    im_info) -> (boxes_b, scores_b, keep_b)`` replaces the model path
    (the load generator's device stand-in, the tests' fakes).
    """

    def __init__(self, predictor: Predictor, cfg: Config,
                 metrics: ServeMetrics = None, start: bool = True,
                 run_fn=None):
        s = cfg.serve
        if s.batch_size < 1:
            raise ValueError(f"serve.batch_size must be >= 1, got "
                             f"{s.batch_size}")
        if s.max_delay_ms < 0:
            raise ValueError(f"serve.max_delay_ms must be >= 0, got "
                             f"{s.max_delay_ms}")
        if s.shed_watermark > s.queue_depth:
            raise ValueError(
                f"serve.shed_watermark ({s.shed_watermark}) exceeds "
                f"queue_depth ({s.queue_depth})")
        self.predictor = predictor
        self.cfg = cfg
        self.metrics = metrics or ServeMetrics()
        self.buckets: Tuple[Tuple[int, int], ...] = tuple(
            tuple(b) for b in cfg.bucket.shapes)
        self.queues: Dict[Tuple[int, int], BoundedQueue] = {
            b: BoundedQueue(s.queue_depth, s.shed_watermark)
            for b in self.buckets}
        # built once, on the device the postprocess runs on
        self._stds, self._means = tiled_bbox_stats(cfg, cfg.num_classes,
                                                   predictor.device)
        self._threads: List[threading.Thread] = []
        self._closed = False
        self._warm: List[Tuple[int, int]] = []
        self._warm_programs = 0
        # seconds of each bucket's first batch in the last warm-up (or
        # join): tools/fleet.py join_bench pairs two warm-ups to split
        # the join's own cost from the model's
        self.last_warmup_run_s: List[float] = []
        self._export_root = None    # the store warm_from_export joined
        self._run_fn = run_fn
        if start:
            self.start()

    # ---- request path (caller threads) ------------------------------------

    def preprocess(self, img: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        """RGB uint8 (h, w, 3) → (padded fp32 canvas, im_info (3,),
        bucket): the eval's preprocessing, so a served image sees the
        pixels an offline eval of it sees."""
        return prepare_image(img, self.cfg)

    def submit(self, img: np.ndarray, timeout_ms: float = None,
               tctx: "obs_trace.TraceContext" = None) -> ServeRequest:
        """Admit one image and return its handle at once; it ends SERVED,
        SHED, EXPIRED or FAILED, and ``handle.wait()`` blocks and raises
        the matching error.  ``timeout_ms`` overrides
        ``serve.default_timeout_ms`` (0: no deadline).  ``tctx``: an
        inbound distributed trace context (None costs one check)."""
        now = time.monotonic()
        deadline = self._deadline(now, timeout_ms)
        # the dims-only check first: a request refused under overload
        # pays no resize or pad (offer stays the authoritative check)
        h, w = img.shape[:2]
        rough = estimate_bucket(h, w, self.cfg.bucket.scale,
                                self.cfg.bucket.max_size, self.buckets)
        if self._closed or (len(self.queues[rough])
                            >= self.queues[rough].shed_watermark):
            return self._admit(None, None, rough, deadline, now, tctx)
        t0 = time.perf_counter()
        data, im_info, bucket = self.preprocess(img)
        self.metrics.observe("preprocess_ms",
                             (time.perf_counter() - t0) * 1e3)
        return self._admit(data, im_info, bucket, deadline, now, tctx)

    def _deadline(self, now: float, timeout_ms: float = None):
        t = (self.cfg.serve.default_timeout_ms if timeout_ms is None
             else timeout_ms)
        return now + t / 1000.0 if t and t > 0 else None

    def _check_bucket(self, bucket) -> Tuple[int, int]:
        bucket = tuple(bucket)
        if bucket not in self.queues:
            raise ValueError(f"bucket {bucket} is not a configured shape "
                             f"bucket {sorted(self.queues)}")
        return bucket

    def _admit(self, data, im_info, bucket, deadline, now, tctx
               ) -> ServeRequest:
        """Queue a prepared request, or end it SHED at the watermark."""
        req = ServeRequest(data, None if im_info is None else
                           np.asarray(im_info, np.float32), bucket,
                           deadline, now)
        req.tctx = tctx
        self._trace_admit(req)
        self.metrics.count("submitted")
        if data is None or self._closed or not self.queues[bucket].offer(req):
            req._finish(SHED)
            self.metrics.count("shed")
        return req

    def submit_prepared(self, data: np.ndarray, im_info: np.ndarray,
                        bucket: Tuple[int, int], timeout_ms: float = None,
                        tctx: "obs_trace.TraceContext" = None
                        ) -> ServeRequest:
        """Admit one image already preprocessed: ``data`` the (bh, bw, 3)
        fp32 canvas :meth:`preprocess` would build (a
        ``StreamTestLoader`` row with ``raw_images=False`` is that canvas
        bit for bit), ``im_info`` its (3,) record.  Everything after the
        resize is :meth:`submit`'s path.  A bucket that is not
        configured, or a canvas of another shape or dtype, raises."""
        bucket = self._check_bucket(bucket)
        data = np.asarray(data)
        if data.shape != bucket + (3,) or data.dtype != np.float32:
            # a uint8 raw row would skip the normalisation
            raise ValueError(
                f"prepared image must be float32 {bucket + (3,)}, got "
                f"{data.dtype} {data.shape} (build the loader with "
                f"raw_images=False)")
        now = time.monotonic()
        return self._admit(data, im_info, bucket,
                           self._deadline(now, timeout_ms), now, tctx)

    def submit_source(self, img: np.ndarray, im_info: np.ndarray,
                      bucket: Tuple[int, int], timeout_ms: float = None,
                      tctx: "obs_trace.TraceContext" = None
                      ) -> ServeRequest:
        """Admit one resized, unnormalised (h, w, 3) uint8 image whose
        bucket and im_info the caller resolved.  The shed check runs
        before the pixel work; then ``data/image.py — pad_normalize``,
        the step every preprocess ends with, builds the canvas (bit-equal
        to :meth:`preprocess`'s), on the caller's thread as in the JAX
        package."""
        bucket = self._check_bucket(bucket)
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"source image must be uint8 (h, w, 3), "
                             f"got {img.dtype} {tuple(img.shape)}")
        h, w = img.shape[:2]
        if h > bucket[0] or w > bucket[1]:
            raise ValueError(f"source image ({h}, {w}) does not fit "
                             f"bucket {bucket}")
        now = time.monotonic()
        deadline = self._deadline(now, timeout_ms)
        if self._closed or (len(self.queues[bucket])
                            >= self.queues[bucket].shed_watermark):
            return self._admit(None, None, bucket, deadline, now, tctx)
        data = pad_normalize(img, self.cfg.network.pixel_means, bucket)
        return self._admit(data, im_info, bucket, deadline, now, tctx)

    @staticmethod
    def _trace_admit(req: ServeRequest) -> None:
        """Open the request's ``serve.request`` interval (a no-op unless
        spans are on); its id rides the request across threads."""
        if obs_trace.enabled():
            req.trace_id = obs_trace.new_trace_id()
            obs_trace.async_begin(
                "serve.request", req.trace_id,
                bucket=f"{req.bucket[0]}x{req.bucket[1]}")

    def detect(self, img: np.ndarray, timeout_ms: float = None
               ) -> Dict[int, np.ndarray]:
        """Submit and wait: ``{class_id: (k, 5) [x1 y1 x2 y2 score]}`` in
        raw image coordinates, or ShedError / DeadlineExceeded /
        RequestFailed."""
        req = self.submit(img, timeout_ms=timeout_ms)
        # the dispatcher decides EXPIRED; the slack covers its wake-up
        wait_s = None
        if req.deadline is not None:
            wait_s = max(req.deadline - time.monotonic(), 0.0) + 30.0
        return req.wait(timeout=wait_s)

    # ---- dispatch path (one thread per bucket) -----------------------------

    def start(self) -> None:
        if self._threads:
            return
        for bucket in self.buckets:
            t = threading.Thread(target=self._dispatcher, args=(bucket,),
                                 name=f"serve-dispatch-{bucket[0]}x"
                                      f"{bucket[1]}", daemon=True)
            t.start()
            self._threads.append(t)

    def _dispatcher(self, bucket: Tuple[int, int]) -> None:
        q = self.queues[bucket]
        s = self.cfg.serve
        on_expire = lambda req: self.metrics.count("expired")  # noqa: E731
        while True:
            batch = q.take_batch(s.batch_size, s.max_delay_ms / 1000.0,
                                 on_expire=on_expire)
            if not batch:
                return  # closed and drained
            self._serve_batch(bucket, batch)

    def _compose(self, bucket: Tuple[int, int], reqs: List[ServeRequest]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """The static batch: real rows first, then zero-image pad rows
        with im_info (bh, bw, 1.0), which run the normal path and give no
        NaN."""
        bh, bw = bucket
        n = self.cfg.serve.batch_size
        images = np.zeros((n, bh, bw, 3), np.float32)
        im_info = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
        for j, r in enumerate(reqs):
            images[j] = r.image
            im_info[j] = r.im_info
        return images, im_info

    def _run(self, images: np.ndarray, im_info: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Forward and the eval's postprocess of one padded batch on the
        predictor's device; (boxes_b, scores_b, keep_b) on the host."""
        if self._run_fn is not None:
            return self._run_fn(images, im_info)
        p = self.predictor
        rois, roi_valid, cls_prob, deltas = p.raw(images, im_info)
        info = torch.from_numpy(im_info).to(p.device)
        with torch.inference_mode():
            out = _postprocess_batch(
                rois, roi_valid, cls_prob, deltas, info, info[:, 2],
                self._stds, self._means, nms_thresh=self.cfg.test.nms,
                score_thresh=self.cfg.serve.score_thresh)
        return tuple(t.cpu().numpy() for t in out)

    def _serve_batch(self, bucket: Tuple[int, int],
                     reqs: List[ServeRequest]) -> None:
        """Run one micro-batch and terminate every rider.  Any exception
        FAILs the unfinished riders, so none waits forever and the
        bucket keeps its dispatcher."""
        try:
            now = time.monotonic()
            tracing = obs_trace.enabled()
            label = f"{bucket[0]}x{bucket[1]}"
            for r in reqs:
                r.dispatch_t = now
                self.metrics.observe("queue_wait_ms",
                                     (now - r.enqueue_t) * 1e3)
                if tracing and r.trace_id is not None:
                    # stamped on this thread with the request's id; its
                    # start lies on the caller's
                    obs_trace.complete("serve.queue_wait",
                                       (now - r.enqueue_t) * 1e3,
                                       trace_id=r.trace_id)
                if r.tctx is not None:
                    obs_trace.record_span(r.tctx, "serve.lane_wait",
                                          (now - r.enqueue_t) * 1e3,
                                          bucket=label)
            images, im_info = self._compose(bucket, reqs)
            t0 = time.monotonic()
            if tracing:
                with obs_trace.span(
                        "serve.batch", bucket=label, rows=len(reqs),
                        trace_ids=[r.trace_id for r in reqs
                                   if r.trace_id is not None]):
                    boxes_b, scores_b, keep_b = self._run(images, im_info)
            else:
                boxes_b, scores_b, keep_b = self._run(images, im_info)
            batch_ms = (time.monotonic() - t0) * 1e3
            self.metrics.observe_batch(len(reqs), self.cfg.serve.batch_size,
                                       batch_ms)
            for r in reqs:
                if r.tctx is not None:
                    obs_trace.record_span(r.tctx, "serve.compute", batch_ms,
                                          rows=len(reqs), bucket=label)
            for j, r in enumerate(reqs):
                # a request alive when taken may expire while its batch
                # runs: it ends EXPIRED (504), never as a late 200
                if r.expired(time.monotonic()):
                    if r._finish(EXPIRED):
                        self.metrics.count("expired")
                    continue
                dets = detections_from_keep(boxes_b, scores_b, keep_b, j)
                r.batch_rows = len(reqs)
                if r._finish(SERVED, result=dets):
                    self.metrics.count("served")
                    self.metrics.observe("total_ms",
                                         (r.done_t - r.enqueue_t) * 1e3)
        except Exception as e:  # terminate every rider, never hang one
            logger.exception("serve batch failed (bucket %s)", bucket)
            for r in reqs:
                if r._finish(FAILED, error=e):
                    self.metrics.count("failed")

    # ---- lifecycle ----------------------------------------------------------

    def warmup(self) -> int:
        """One dummy batch per bucket before the first request, so no
        client pays a kernel build or a first-call cost; returns the
        number of warm buckets."""
        n = self.cfg.serve.batch_size
        self.last_warmup_run_s = []
        for bucket in self.buckets:
            t0 = time.perf_counter()
            self._run(*self._compose(bucket, []))
            self.last_warmup_run_s.append(time.perf_counter() - t0)
            if bucket not in self._warm:
                self._warm.append(bucket)
        self._warm_programs = self.program_count()
        logger.info("serve warmup: %d bucket(s) at batch %d", len(self._warm),
                    n)
        return len(self._warm)

    def warm_from_export(self, store) -> Dict:
        """Join from an export store (``serve/export.py``): its
        :meth:`~ExportStore.check` against this process (config,
        versions, device, serving knobs, quant block with this
        predictor's calibration fingerprint, kernel library names), its
        kernel libraries installed where ``kernels.py`` loads them, then
        each bucket's dummy batch (and the postprocess) run and held to
        the recorded digests bit for bit.  Any mismatch raises
        ``ExportMismatch``.  Returns the join record: its seconds, the
        programs held, the libraries placed and ``kernels.load_events()``
        before and after (a process whose ``_build/`` was empty builds
        none)."""
        from mx_rcnn_tpu_torch.serve.export import (SERVE_POST,
                                                    _dummy_batch,
                                                    serve_fwd_name)

        t0 = time.monotonic()
        before = kernels.load_events()
        p = self.predictor
        store.check(self.cfg, quant_fingerprint=p.quant_fingerprint,
                    device=p.device)
        placed = store.install_kernels()
        t_load = time.monotonic() - t0
        n = self.cfg.serve.batch_size
        programs = []
        self.last_warmup_run_s = []
        for bucket in self.buckets:
            t1 = time.perf_counter()
            name = serve_fwd_name(bucket, n)
            images, im_info = _dummy_batch(bucket, n)
            out = store.load(name, p)(images, im_info)
            store.require_digest(name, out)
            programs.append(name)
            if SERVE_POST not in programs:
                info = torch.from_numpy(im_info).to(p.device)
                store.require_digest(SERVE_POST, store.load(SERVE_POST, p)(
                    *out, info, info[:, 2], self._stds, self._means))
                programs.append(SERVE_POST)
            self.last_warmup_run_s.append(time.perf_counter() - t1)
            if bucket not in self._warm:
                self._warm.append(bucket)
        self._warm_programs = self.program_count()
        self._export_root = store.root
        total = time.monotonic() - t0
        logger.info("serve join from %s: %d program(s) bit-equal to the "
                    "store in %.3f s", store.root, len(programs), total)
        return {"programs": programs, "kernels_placed": placed,
                "load_s": round(t_load, 3), "total_s": round(total, 3),
                "export_root": store.root, "load_events_before": before,
                "load_events_after": kernels.load_events()}

    def program_count(self) -> int:
        """The warm serving programs: one forward per warmed bucket, plus
        the postprocess they share.  The port keeps no program cache,
        so this counts what a warm-up ran, and growth after it cannot
        happen; a steady state that builds nothing shows as
        ``kernels.load_events()["builds"]`` unchanged."""
        return len(self._warm) + (1 if self._warm else 0)

    def depth(self) -> int:
        """Admitted requests not yet terminal, queued or in a batch."""
        return self.metrics.in_flight()

    def bucket_depth(self, bucket: Tuple[int, int]) -> int:
        """Requests queued (not yet dispatched) in one bucket."""
        q = self.queues.get(tuple(bucket))
        return len(q) if q is not None else 0

    def alive(self) -> bool:
        """Not closed, and every bucket's dispatcher still running."""
        if self._closed:
            return False
        return bool(self._threads) and all(t.is_alive()
                                           for t in self._threads)

    def kill(self) -> None:
        """Abrupt death: stop admitting and FAIL everything still queued
        (the replica died under it); a batch already running finishes."""
        self._closed = True
        err = RuntimeError("replica killed")
        for q in self.queues.values():
            for req in q.close():
                if req._finish(FAILED, error=err):
                    self.metrics.count("failed")

    def healthz(self) -> Dict:
        return {
            "ok": not self._closed,
            "buckets": [list(b) for b in self.buckets],
            "batch_size": self.cfg.serve.batch_size,
            "warm_buckets": [list(b) for b in self._warm],
            "warm_programs": self._warm_programs,
            "programs": self.program_count(),
            "export_root": self._export_root,   # None: warmed by running
            "device": str(self.predictor.device),
            "queue_depths": {f"{b[0]}x{b[1]}": len(q)
                             for b, q in self.queues.items()},
        }

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, shed what is still queued, join the
        dispatchers (batches already running finish)."""
        self._closed = True
        for q in self.queues.values():
            for req in q.close():
                if req._finish(SHED):
                    self.metrics.count("shed")
        for t in self._threads:
            t.join(timeout)
        self._threads = []
