"""Prediction, the eval/serve postprocess and the evaluation loop.

Counterpart of ``mx_rcnn_tpu/core/tester.py``: :class:`Predictor` (the
test forward on a device, and its RPN-only and RCNN-only halves),
``tiled_bbox_stats``, ``_decode_batch`` (which applies ``delta * std +
mean`` at decode time — weights stay in normalised space),
``_postprocess_batch`` (per-class NMS over the
flattened (N·C, R) batch, kernel K1 on the card),
``detections_from_keep``, ``im_detect_batch``, ``pred_eval`` (forward
→ postprocess → ``max_per_image`` cap → ``imdb.evaluate_detections``)
and ``generate_proposals`` (the alternate schedule's proposal dump).
A :class:`Predictor` given several ``devices`` splits each batch across
them, as the JAX ``Predictor(mesh=...)`` shards it.

Quantized inference (``cfg.quant``): ``calibration_batches`` (a seeded
subsample of the training roidb), ``calibrate_quant`` (the fp forward
recording activation statistics → per-layer scales) and
``quant_predictor`` (the quantized model with those scales in a
:class:`Predictor`, which carries the calibration fingerprint).
"""

from __future__ import annotations

import copy
import logging
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import RCNNBatch
from mx_rcnn_tpu_torch.models.faster_rcnn import (FasterRCNN, build_model,
                                                  to_device_batch)
from mx_rcnn_tpu_torch.obs.profiler import scope
from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.nms import nms_mask_batch
from mx_rcnn_tpu_torch.ops.quant import (calibration_fingerprint,
                                         finalize_calibration,
                                         quant_program_tag)
from mx_rcnn_tpu_torch.utils.bridge import (load_quant, quant_stats_to_flax,
                                            quant_to_flax)
from mx_rcnn_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mx_rcnn_tpu_torch")


# what a pad row of each input holds: im_info rows of 1, as the JAX
# Predictor pads them, so that no pad row divides by zero
_PAD_FILLS = {"images": 0, "im_info": 1, "rois": 0, "rois_valid": False}


def _forward_fn(kind: str, cfg: Config):
    """The model call of each forward kind, on tensors of one device."""
    t = cfg.test
    return {"raw": lambda m, *a: m(*a),
            "rois": lambda m, *a: m.detect_rois(*a),
            "rpn": lambda m, *a: m.rpn_proposals(
                *a, t.proposal_pre_nms_top_n, t.proposal_post_nms_top_n),
            }[kind]


class Predictor:
    """The test-mode forward of ``model`` on ``device`` (CUDA unless the
    caller asks for the CPU).

    With ``devices`` (N of them; a device may repeat in a test rig) it
    keeps one replica of the model per device and splits each batch: the
    batch is padded to a multiple of N (pad images of 0, ``im_info`` rows
    of 1, as the JAX ``Predictor._forward`` pads for its mesh), slice k
    runs on device k (the launches of different cards overlap without
    threads), and the outputs are gathered to the host in row order
    without the pad rows.  ``pred_eval`` postprocesses each slice on its
    own device (:meth:`raw_shards`).

    With ``cfg.quant.enabled`` the model must be the quantized one with
    its calibrated scales (:func:`quant_predictor`), or this raises; the
    predictor then carries ``quant_fingerprint`` and ``program_tag``
    (the port has no program cache: the tag is logged and keys
    nothing)."""

    def __init__(self, model: FasterRCNN, cfg: Config, device="cuda",
                 devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.quant_fingerprint: Optional[str] = None
        self.program_tag = ""
        if cfg.quant.enabled:
            if model.quant is None or model.quant.phase != "apply":
                raise ValueError(
                    "cfg.quant.enabled but the model is not the quantized "
                    "apply-phase model — build it with cfg.quant enabled "
                    "(core/tester.py — quant_predictor)")
            try:
                col = quant_to_flax(model)
            except ValueError as e:
                raise ValueError(
                    "cfg.quant.enabled but the model carries no calibrated "
                    "'quant' scales — calibrate first (core/tester.py — "
                    f"quant_predictor): {e}") from None
            self.quant_fingerprint = calibration_fingerprint(col, cfg.quant)
            self.program_tag = quant_program_tag(cfg.quant,
                                                 self.quant_fingerprint)
            logger.info("quant program tag %s", self.program_tag)
        self.replicas: List[Tuple[torch.device, FasterRCNN]] = []
        if devices:
            for i, d in enumerate(devices):
                dev = resolve_device(d)
                self.replicas.append(
                    (dev, (model if i == 0 else copy.deepcopy(model))
                     .to(dev).eval()))
        else:
            dev = resolve_device(device)
            self.replicas.append((dev, model.to(dev).eval()))
        self.device, self.model = self.replicas[0]

    def raw(self, images, im_info) -> Tuple[torch.Tensor, ...]:
        """Forward returning device tensors without a host sync: rois,
        roi_valid, cls_prob, bbox_deltas.  ``images``/``im_info`` are
        numpy arrays or tensors.  Split across several devices, the
        outputs are gathered to host tensors."""
        return self._run("raw", images=images, im_info=im_info)

    def _inputs(self, *arrays, device=None) -> Tuple[torch.Tensor, ...]:
        """Numpy arrays or tensors → tensors on ``device`` (the
        predictor's first by default)."""
        device = device or self.device
        if isinstance(arrays[0], np.ndarray):
            arrays = to_device_batch(*arrays[:2], device) + tuple(
                torch.from_numpy(np.ascontiguousarray(a)) for a in arrays[2:])
        return tuple(a.to(device) for a in arrays)

    def raw_rois(self, images, im_info, rois, rois_valid
                 ) -> Tuple[torch.Tensor, ...]:
        """The RCNN-only forward on precomputed proposals (N, R, 4) in
        input coordinates: what :meth:`raw` returns, without the RPN."""
        return self._run("rois", images=images, im_info=im_info, rois=rois,
                         rois_valid=rois_valid)

    def rpn(self, images, im_info) -> Tuple[torch.Tensor, ...]:
        """The RPN-only forward at the proposal dump's numbers
        (``test.proposal_pre_nms_top_n`` / ``proposal_post_nms_top_n``):
        device tensors (rois (N, R, 4), scores (N, R), valid (N, R))."""
        return self._run("rpn", images=images, im_info=im_info)

    def raw_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """A loader batch: an ``RCNNBatch`` runs the RCNN-only forward on
        its proposals, a ``Batch`` the whole test forward."""
        if isinstance(batch, RCNNBatch):
            return self.raw_rois(batch.images, batch.im_info, batch.rois,
                                 batch.rois_valid)
        return self.raw(batch.images, batch.im_info)

    def raw_shards(self, batch) -> List[Tuple[range, Tuple[torch.Tensor,
                                                            ...]]]:
        """:meth:`raw_batch` left on the devices: one (rows, outputs) per
        device, ``rows`` the batch rows its outputs begin with (any rows
        after them are padding; a slice of padding alone has none)."""
        kind, arrays = (("rois", dict(images=batch.images,
                                      im_info=batch.im_info, rois=batch.rois,
                                      rois_valid=batch.rois_valid))
                        if isinstance(batch, RCNNBatch) else
                        ("raw", dict(images=batch.images,
                                     im_info=batch.im_info)))
        return self._shards(kind, arrays)

    def _shards(self, kind: str, arrays: Dict
                ) -> List[Tuple[range, Tuple[torch.Tensor, ...]]]:
        fn = _forward_fn(kind, self.cfg)
        if len(self.replicas) == 1:
            with torch.inference_mode():
                out = fn(self.model, *self._inputs(*arrays.values()))
            return [(range(len(arrays["images"])), out)]
        host = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in arrays.items()}
        n, k = len(host["images"]), len(self.replicas)
        per = -(-n // k)
        padded = [np.concatenate([a, np.full((per * k - n,) + a.shape[1:],
                                             _PAD_FILLS[name], a.dtype)])
                  for name, a in host.items()]
        shards = []
        for i, (dev, model) in enumerate(self.replicas):
            part = [a[i * per:(i + 1) * per] for a in padded]
            with torch.inference_mode():
                out = fn(model, *self._inputs(*part, device=dev))
            shards.append((range(min(i * per, n), min((i + 1) * per, n)),
                           out))
        return shards

    def _run(self, kind: str, **arrays) -> Tuple[torch.Tensor, ...]:
        shards = self._shards(kind, arrays)
        if len(shards) == 1:
            return shards[0][1]
        return tuple(torch.cat([out[j][:len(rows)].cpu()
                                for rows, out in shards])
                     for j in range(len(shards[0][1])))

    def __call__(self, images, im_info) -> Tuple[np.ndarray, ...]:
        return tuple(t.cpu().numpy() for t in self.raw(images, im_info))


def tiled_bbox_stats(cfg: Config, num_classes: int, device="cpu"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stds, means) tiled per class for delta de-normalisation."""
    stds = torch.tensor(cfg.train.bbox_stds, dtype=torch.float32,
                        device=device).repeat(num_classes)
    means = torch.tensor(cfg.train.bbox_means, dtype=torch.float32,
                         device=device).repeat(num_classes)
    return stds, means


def _decode_batch(rois, roi_valid, cls_prob, deltas, im_info, scales,
                  stds, means):
    """De-normalise, decode, clip, unscale.  Returns (boxes (N, R, 4C) in
    raw-image coordinates, scores (N, R, C) with padded slots zeroed)."""
    d = deltas * stds + means
    boxes = bbox_pred(rois, d)
    boxes = clip_boxes(boxes, (im_info[:, 0], im_info[:, 1]))
    boxes = boxes / scales[:, None, None]
    scores = cls_prob * roi_valid[..., None]
    return boxes, scores


def _postprocess_batch(rois, roi_valid, cls_prob, deltas, im_info, scales,
                       stds, means, *, nms_thresh: float, score_thresh: float):
    """Decode + clip + unscale + per-class masked NMS for a whole batch.

    Returns (boxes (N, R, 4C), scores (N, R, C), keep (N, C, R) bool)."""
    n, r, _ = deltas.shape
    c = cls_prob.shape[-1]
    with scope("postprocess"):
        boxes_b, scores_b = _decode_batch(rois, roi_valid, cls_prob, deltas,
                                          im_info, scales, stds, means)
        boxes_c = boxes_b.reshape(n, r, c, 4).permute(0, 2, 1, 3)
        scores_c = scores_b.transpose(1, 2)                    # (N, C, R)
        cand = (scores_c > score_thresh) & roi_valid[:, None, :]
        keep_flat = nms_mask_batch(
            boxes_c.reshape(n * c, r, 4), scores_c.reshape(n * c, r),
            nms_thresh, valid=cand.reshape(n * c, r))
        keep_b = keep_flat.reshape(n, c, r) & cand
    return boxes_b, scores_b, keep_b


def detections_from_keep(boxes_b: np.ndarray, scores_b: np.ndarray,
                         keep_b: np.ndarray, j: int) -> Dict[int, np.ndarray]:
    """Row ``j`` of the postprocess outputs → ``{class_id: (k, 5)
    [x1 y1 x2 y2 score]}`` over the foreground classes."""
    r = boxes_b.shape[1]
    num_classes = scores_b.shape[-1]
    boxes = boxes_b[j].reshape(r, num_classes, 4)
    out: Dict[int, np.ndarray] = {}
    for c in range(1, num_classes):
        keep = keep_b[j, c]
        if keep.any():
            out[c] = np.hstack([boxes[keep, c],
                                scores_b[j][keep, c, None]]
                               ).astype(np.float32)
    return out


def im_detect_batch(rois, roi_valid, cls_prob, deltas, im_info, scales,
                    cfg: Config) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One forward batch (numpy or tensors) → per-image (boxes (R, 4C),
    scores (R, C)) in raw-image coordinates, decoded on the device of
    ``deltas``."""
    deltas = torch.as_tensor(deltas)
    dev = deltas.device
    stds, means = tiled_bbox_stats(cfg, deltas.shape[-1] // 4, dev)
    boxes_b, scores_b = (t.cpu().numpy() for t in _decode_batch(
        *(torch.as_tensor(x, device=dev)
          for x in (rois, roi_valid, cls_prob)), deltas,
        torch.as_tensor(im_info, device=dev),
        torch.as_tensor(scales, device=dev), stds, means))
    return [(boxes_b[i], scores_b[i]) for i in range(len(boxes_b))]


def pred_eval(predictor, test_loader, imdb, cfg: Config, out_dir: str = None,
              verbose: bool = True, save_dets: str = None
              ) -> Dict[str, float]:
    """The evaluation loop (ref ``pred_eval``): forward each batch of
    ``test_loader``, per-class score threshold and NMS on the device of
    the forward's outputs, cap each image at ``max_per_image`` detections
    by score (ties at the cap are kept), then
    ``imdb.evaluate_detections``.  ``predictor.raw_batch(batch)`` takes
    the loader's batch whole (an ``RCNNBatch`` of :class:`ROITestLoader`
    goes through its proposals) and returns (rois, roi_valid, cls_prob,
    deltas) as tensors or numpy; a :class:`Predictor` over several
    devices gives one such output per device (``raw_shards``), and each
    is postprocessed on its own device, pad rows dropped.

    ``out_dir``: the evaluator writes its detection files there (VOC's
    per-class comp4 files, COCO's results json).  ``save_dets``: pickle
    ``{"all_boxes", "classes"}`` there first, for ``tools/reeval.py`` of
    either package."""
    num_classes = imdb.num_classes
    num_images = len(test_loader.roidb)
    all_boxes: List[List[np.ndarray]] = [
        [np.zeros((0, 5), np.float32) for _ in range(num_images)]
        for _ in range(num_classes)]
    done = 0
    raw_shards = getattr(predictor, "raw_shards", None)
    for batch, indices, scales in test_loader:
        shards = (raw_shards(batch) if raw_shards is not None else
                  [(range(len(indices)), predictor.raw_batch(batch))])
        posted = []
        for rows, out in shards:
            if not rows:      # padding alone
                continue
            rois, roi_valid, cls_prob, deltas = (
                torch.as_tensor(t)[:len(rows)] for t in out)
            dev = rois.device
            stds, means = tiled_bbox_stats(cfg, num_classes, dev)
            with torch.inference_mode():
                posted.append((rows, _postprocess_batch(
                    rois, roi_valid, cls_prob, deltas,
                    torch.as_tensor(batch.im_info[rows.start:rows.stop],
                                    device=dev),
                    torch.as_tensor(scales[rows.start:rows.stop],
                                    device=dev), stds, means,
                    nms_thresh=cfg.test.nms,
                    score_thresh=cfg.test.score_thresh)))
        for rows, post in posted:
            boxes_b, scores_b, keep_b = (t.cpu().numpy() for t in post)
            _collect(boxes_b, scores_b, keep_b,
                     [indices[r] for r in rows], all_boxes, cfg)
        done += len(indices)
        if verbose:
            print(f"eval: {done}/{num_images} images", flush=True)
    if save_dets:
        os.makedirs(os.path.dirname(save_dets) or ".", exist_ok=True)
        with open(save_dets, "wb") as f:
            pickle.dump({"all_boxes": all_boxes,
                         "classes": list(imdb.classes)}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
    return imdb.evaluate_detections(all_boxes, out_dir)


def _collect(boxes_b: np.ndarray, scores_b: np.ndarray, keep_b: np.ndarray,
             indices: Sequence[int], all_boxes: List[List[np.ndarray]],
             cfg: Config) -> None:
    """Rows of a postprocessed batch → ``all_boxes[class][image]``, each
    image capped at ``test.max_per_image`` detections by score."""
    num_classes = len(all_boxes)
    for j, i in enumerate(indices):
        dets = detections_from_keep(boxes_b, scores_b, keep_b, j)
        for c, arr in dets.items():
            all_boxes[c][i] = arr
        if not dets:
            continue
        all_scores = np.concatenate([a[:, 4] for a in dets.values()])
        if len(all_scores) > cfg.test.max_per_image:
            thresh = np.sort(all_scores)[-cfg.test.max_per_image]
            for c in range(1, num_classes):
                all_boxes[c][i] = all_boxes[c][i][
                    all_boxes[c][i][:, 4] >= thresh]


def calibration_batches(cfg: Config, dataset_kw: dict = None,
                        synthetic: int = 0
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The held-out calibration sweep: ``cfg.quant.calibration_batches``
    test-mode batches of ``test.batch_images`` from a
    ``calibration_seed`` subsample of the TRAINING roidb (never the eval
    set), taken in roidb order on the caller's thread.  ``synthetic`` as
    in ``load_gt_roidb``.  Returns ``(images, im_info)`` pairs."""
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import TestLoader

    q = cfg.quant
    imdb, roidb = load_gt_roidb(cfg, training=True, synthetic=synthetic,
                                **(dataset_kw or {}))
    per_batch = max(1, cfg.test.batch_images)
    want = max(1, q.calibration_batches) * per_batch
    order = np.random.RandomState(q.calibration_seed).permutation(len(roidb))
    roidb = [roidb[i] for i in order[:want]]
    loader = TestLoader(roidb, cfg, imdb.load_image, batch_images=per_batch,
                        num_workers=0)
    out = []
    for batch, _, _ in loader:
        out.append((np.asarray(batch.images), np.asarray(batch.im_info)))
        if len(out) >= q.calibration_batches:
            break
    return out


def calibrate_quant(cfg: Config, state_dict, device="cuda", *,
                    dataset_kw: dict = None, synthetic: int = 0,
                    batches=None) -> dict:
    """The calibration sweep on ``device`` (CUDA unless the caller asks
    for the CPU): the fp forward of the calibration-phase model with the
    fp32 weights ``state_dict`` over ``batches`` (default
    :func:`calibration_batches`), in order, recording each quantized
    layer's activation statistics; returns the ``quant`` collection of
    per-layer scales (``ops/quant.py — finalize_calibration``).  The same
    batches in the same order give the same scales."""
    if not cfg.quant.enabled:
        raise ValueError("calibrate_quant needs cfg.quant.enabled")
    dev = resolve_device(device)
    model = build_model(cfg, dev, seed=None, quant_phase="calib")
    model.load_state_dict(state_dict)
    seen = 0
    with torch.inference_mode():
        for images, im_info in (batches if batches is not None else
                                calibration_batches(cfg, dataset_kw,
                                                    synthetic)):
            model(*to_device_batch(np.asarray(images), np.asarray(im_info),
                                   dev))
            seen += 1
    if not seen:
        raise ValueError("calibration sweep saw zero batches")
    return finalize_calibration(quant_stats_to_flax(model), cfg.quant)


def quant_predictor(cfg: Config, state_dict, device="cuda", *,
                    dataset_kw: dict = None, synthetic: int = 0,
                    batches=None, devices: Optional[Sequence] = None
                    ) -> Predictor:
    """The quantized-inference :class:`Predictor` on ``device``:
    :func:`calibrate_quant` → the apply-phase quantized model with the
    fp32 weights ``state_dict`` and the scales (each layer's weight
    quantized once) → a Predictor carrying the calibration fingerprint
    (over ``devices``, when given, as :class:`Predictor` splits a batch).
    Eval (``tools/test.py``) and serving (``tools/serve.py``) take it
    unchanged."""
    quant_col = calibrate_quant(cfg, state_dict, device,
                                dataset_kw=dataset_kw, synthetic=synthetic,
                                batches=batches)
    dev = resolve_device(device)
    model = build_model(cfg, dev, seed=None)
    model.load_state_dict(state_dict)
    load_quant(model, quant_col)
    return Predictor(model, cfg, dev, devices=devices)


def generate_proposals(model: FasterRCNN, test_loader, cfg: Config,
                       device="cuda") -> List[np.ndarray]:
    """The RPN-only proposal dump (alternate stages 1.5 and 3.5) on
    ``device`` (CUDA unless the caller asks for the CPU): one float32
    (k, 5) [x1 y1 x2 y2 score] array per record of ``test_loader.roidb``,
    in roidb order, the valid proposals of :meth:`Predictor.rpn` divided
    by the image's scale (raw coordinates)."""
    predictor = Predictor(model, cfg, device)
    proposals: List[np.ndarray] = [None] * len(test_loader.roidb)
    for batch, indices, scales in test_loader:
        rois, scores, valid = (t.cpu().numpy() for t in predictor.rpn(
            batch.images, batch.im_info))
        for j, i in enumerate(indices):
            keep = valid[j]
            proposals[i] = np.hstack(
                [rois[j][keep] / scales[j],
                 scores[j][keep][:, None]]).astype(np.float32)
    return proposals
