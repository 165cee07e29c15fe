"""Box geometry: IoU, encode, decode, clipping.

Counterpart of ``mx_rcnn_tpu/ops/boxes.py`` with the same operations in
the same order, so fp32 results agree bit for bit: +1-pixel widths, the
``union > 0`` guard with ``inter / max(union, 1e-12)``, the
``4.135166556742356`` clamp on dw/dh and the ``[0, size - 1]`` clip.
Boxes are ``(x1, y1, x2, y2)`` inclusive pixel corners.  Every function
takes optional leading batch dimensions where the JAX version is vmapped.
"""

from __future__ import annotations

import torch


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise IoU: (..., N, 4) x (..., K, 4) → (..., N, K).
    Degenerate (zero/negative-area) boxes give 0."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + 1.0
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + 1.0
    iw = iw.clamp_min(0.0)
    ih = ih.clamp_min(0.0)
    inter = iw * ih
    area_b = (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)
    area_q = (query_boxes[..., 2] - query_boxes[..., 0] + 1.0) * (
        query_boxes[..., 3] - query_boxes[..., 1] + 1.0)
    union = area_b[..., :, None] + area_q[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), 0.0)


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor
                   ) -> torch.Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) deltas w.r.t. example boxes:
    (..., N, 4) x (..., N, 4) → (..., N, 4).  The 1e-14 guards and the
    ``max(·, 1)`` in the logs are the reference's."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * (ex_w - 1.0)
    ex_cy = ex_rois[..., 1] + 0.5 * (ex_h - 1.0)

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * (gt_w - 1.0)
    gt_cy = gt_rois[..., 1] + 0.5 * (gt_h - 1.0)

    dx = (gt_cx - ex_cx) / (ex_w + 1e-14)
    dy = (gt_cy - ex_cy) / (ex_h + 1e-14)
    dw = torch.log(gt_w.clamp_min(1.0) / ex_w.clamp_min(1.0))
    dh = torch.log(gt_h.clamp_min(1.0) / ex_h.clamp_min(1.0))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def bbox_pred(boxes: torch.Tensor, box_deltas: torch.Tensor) -> torch.Tensor:
    """Decode deltas: boxes (..., N, 4), deltas (..., N, 4*C) → (..., N, 4*C)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)

    dx = box_deltas[..., 0::4]
    dy = box_deltas[..., 1::4]
    # cap dw/dh at log(1000/16) so exp() of a wild delta cannot overflow
    dw = box_deltas[..., 2::4].clamp_max(4.135166556742356)
    dh = box_deltas[..., 3::4].clamp_max(4.135166556742356)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    x1 = pred_cx - 0.5 * (pred_w - 1.0)
    y1 = pred_cy - 0.5 * (pred_h - 1.0)
    x2 = pred_cx + 0.5 * (pred_w - 1.0)
    y2 = pred_cy + 0.5 * (pred_h - 1.0)
    out = torch.stack([x1, y1, x2, y2], dim=-1)  # (..., N, C, 4)
    return out.reshape(out.shape[:-2] + (-1,))


def clip_boxes(boxes: torch.Tensor, im_shape) -> torch.Tensor:
    """Clip (..., N, 4*C) boxes to [0, W-1] x [0, H-1].

    ``im_shape`` is (height, width): numbers, or tensors shaped like the
    leading batch dimensions of ``boxes`` (one extent per image)."""
    h = torch.as_tensor(im_shape[0], dtype=torch.float32,
                        device=boxes.device)[..., None, None]
    w = torch.as_tensor(im_shape[1], dtype=torch.float32,
                        device=boxes.device)[..., None, None]
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    x1 = torch.minimum(b[..., 0].clamp_min(0.0), w - 1.0)
    y1 = torch.minimum(b[..., 1].clamp_min(0.0), h - 1.0)
    x2 = torch.minimum(b[..., 2].clamp_min(0.0), w - 1.0)
    y2 = torch.minimum(b[..., 3].clamp_min(0.0), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)
