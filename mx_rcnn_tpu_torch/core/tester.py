"""Prediction and the eval/serve postprocess.

Counterpart of ``mx_rcnn_tpu/core/tester.py``: :class:`Predictor` (the
test forward on a device), ``tiled_bbox_stats``, ``_decode_batch`` (which
applies ``delta * std + mean`` at decode time — weights stay in
normalised space), ``_postprocess_batch`` (per-class NMS over the
flattened (N·C, R) batch, kernel K1 on the card) and
``detections_from_keep``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import Config
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
        if isinstance(images, np.ndarray):
            images, im_info = to_device_batch(images, im_info, self.device)
        with torch.inference_mode():
            return self.model(images.to(self.device),
                              im_info.to(self.device))

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
