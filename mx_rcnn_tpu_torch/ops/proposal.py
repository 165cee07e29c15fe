"""Fused RPN proposal generation: decode + clip + min-size + top-k + NMS + pad.

Counterpart of ``mx_rcnn_tpu/ops/proposal.py``: ``propose_batch`` (the
batched-NMS path) gives fixed ``(B, post_nms_top_n, 4)`` outputs with a
validity mask, padded slots filled with the image's best surviving box;
``propose`` is the one-image form (one launch of K1 on a card), the
per-image composition of ``tools/profile_step.py --nms_mode per_image``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mx_rcnn_tpu_torch.ops.boxes import bbox_pred, clip_boxes
from mx_rcnn_tpu_torch.ops.nms import nms_batch


def _decode_filter_topk(scores, bbox_deltas, anchors, im_info,
                        pre_nms_top_n: int, min_size: int):
    """Decode + clip, min-size filter, pre-NMS top-k for B images.
    Returns (top_boxes (B, pre, 4), top_scores (B, pre), top_valid)."""
    n = scores.shape[1]
    scores = scores.to(torch.float32)
    proposals = bbox_pred(anchors, bbox_deltas.to(torch.float32))
    proposals = clip_boxes(proposals, (im_info[:, 0], im_info[:, 1]))
    ws = proposals[..., 2] - proposals[..., 0] + 1.0
    hs = proposals[..., 3] - proposals[..., 1] + 1.0
    min_sz = min_size * im_info[:, 2:3]
    size_ok = (ws >= min_sz) & (hs >= min_sz)
    scores = torch.where(size_ok, scores, -torch.inf)
    pre = min(pre_nms_top_n, n)
    # lax.top_k puts the lower index first on ties; a stable descending
    # sort does the same, torch.topk promises no order
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :pre], top_idx[:, :pre]
    top_boxes = torch.gather(proposals, 1,
                             top_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, torch.isfinite(top_scores)


def _compact_rois(top_boxes, top_scores, keep_idx, keep_valid):
    """Gather NMS survivors into the fixed buffer; padded slots take the
    best surviving box (slot 0)."""
    safe_idx = keep_idx.clamp_min(0)
    rois = torch.gather(top_boxes, 1, safe_idx[..., None].expand(-1, -1, 4))
    roi_scores = torch.where(keep_valid, torch.gather(top_scores, 1, safe_idx),
                             0.0)
    rois = torch.where(keep_valid[..., None], rois, rois[:, :1])
    return rois, roi_scores, keep_valid


def propose_batch(scores: torch.Tensor, bbox_deltas: torch.Tensor,
                  anchors: torch.Tensor, im_info: torch.Tensor,
                  pre_nms_top_n: int = 6000, post_nms_top_n: int = 300,
                  nms_thresh: float = 0.7, min_size: int = 16
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ROIs from a batch of RPN outputs.

    scores (B, N) fg probabilities in HWA order, bbox_deltas (B, N, 4),
    anchors (N, 4) shared, im_info (B, 3) = (real_h, real_w, scale).
    Returns rois (B, post, 4), roi_scores (B, post), roi_valid (B, post).
    """
    top_boxes, top_scores, top_valid = _decode_filter_topk(
        scores, bbox_deltas, anchors, im_info, pre_nms_top_n, min_size)
    keep_idx, keep_valid = nms_batch(top_boxes, top_scores, nms_thresh,
                                     post_nms_top_n, valid=top_valid)
    return _compact_rois(top_boxes, top_scores, keep_idx, keep_valid)


def propose(scores: torch.Tensor, bbox_deltas: torch.Tensor,
            anchors: torch.Tensor, im_info: torch.Tensor,
            pre_nms_top_n: int = 6000, post_nms_top_n: int = 300,
            nms_thresh: float = 0.7, min_size: int = 16
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ROIs from one image's RPN outputs: scores (N,), bbox_deltas (N, 4),
    anchors (N, 4), im_info (3,) → rois (post, 4), roi_scores (post,),
    roi_valid (post,)."""
    rois, roi_scores, valid = propose_batch(
        scores[None], bbox_deltas[None], anchors, im_info[None],
        pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
        nms_thresh=nms_thresh, min_size=min_size)
    return rois[0], roi_scores[0], valid[0]
