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
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.core.train import RCNNBatch
from mx_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, to_device_batch
from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.nms import nms_mask_batch
from mx_rcnn_tpu_torch.utils.device import resolve_device


class Predictor:
    """The test-mode forward of ``model`` on ``device`` (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, model: FasterRCNN, cfg: Config, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg

    def raw(self, images, im_info) -> Tuple[torch.Tensor, ...]:
        """Forward returning device tensors without a host sync: rois,
        roi_valid, cls_prob, bbox_deltas.  ``images``/``im_info`` are
        numpy arrays or tensors."""
        with torch.inference_mode():
            return self.model(*self._inputs(images, im_info))

    def _inputs(self, *arrays) -> Tuple[torch.Tensor, ...]:
        """Numpy arrays or tensors → tensors on the predictor's device."""
        if isinstance(arrays[0], np.ndarray):
            arrays = to_device_batch(*arrays[:2], self.device) + tuple(
                torch.from_numpy(np.ascontiguousarray(a)) for a in arrays[2:])
        return tuple(a.to(self.device) for a in arrays)

    def raw_rois(self, images, im_info, rois, rois_valid
                 ) -> Tuple[torch.Tensor, ...]:
        """The RCNN-only forward on precomputed proposals (N, R, 4) in
        input coordinates: what :meth:`raw` returns, without the RPN."""
        with torch.inference_mode():
            return self.model.detect_rois(
                *self._inputs(images, im_info, rois, rois_valid))

    def rpn(self, images, im_info) -> Tuple[torch.Tensor, ...]:
        """The RPN-only forward at the proposal dump's numbers
        (``test.proposal_pre_nms_top_n`` / ``proposal_post_nms_top_n``):
        device tensors (rois (N, R, 4), scores (N, R), valid (N, R))."""
        t = self.cfg.test
        with torch.inference_mode():
            return self.model.rpn_proposals(
                *self._inputs(images, im_info), t.proposal_pre_nms_top_n,
                t.proposal_post_nms_top_n)

    def raw_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """A loader batch: an ``RCNNBatch`` runs the RCNN-only forward on
        its proposals, a ``Batch`` the whole test forward."""
        if isinstance(batch, RCNNBatch):
            return self.raw_rois(batch.images, batch.im_info, batch.rois,
                                 batch.rois_valid)
        return self.raw(batch.images, batch.im_info)

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
    boxes_b, scores_b = _decode_batch(rois, roi_valid, cls_prob, deltas,
                                      im_info, scales, stds, means)
    boxes_c = boxes_b.reshape(n, r, c, 4).permute(0, 2, 1, 3)  # (N, C, R, 4)
    scores_c = scores_b.transpose(1, 2)                        # (N, C, R)
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
    deltas) as tensors or numpy.

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
    for batch, indices, scales in test_loader:
        out = predictor.raw_batch(batch)
        rois, roi_valid, cls_prob, deltas = (torch.as_tensor(t) for t in out)
        dev = rois.device
        stds, means = tiled_bbox_stats(cfg, num_classes, dev)
        with torch.inference_mode():
            boxes_b, scores_b, keep_b = (t.cpu().numpy() for t in
                                         _postprocess_batch(
                rois, roi_valid, cls_prob, deltas,
                torch.as_tensor(batch.im_info, device=dev),
                torch.as_tensor(scales, device=dev), stds, means,
                nms_thresh=cfg.test.nms, score_thresh=cfg.test.score_thresh))
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
