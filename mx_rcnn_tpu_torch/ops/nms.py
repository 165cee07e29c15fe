"""Greedy non-maximum suppression with fixed output shapes.

Counterpart of ``mx_rcnn_tpu/ops/nms.py``: the batched entry points
``nms_batch`` / ``nms_mask_batch`` and their one-image forms ``nms`` /
``nms_mask`` (one launch of K1 on a card, for one image):

1. mask invalid scores to ``_NEG``, pad the box axis to a multiple of
   ``t = min(tile, K)``, sort by descending score (stable, like
   ``jnp.argsort``),
2. the suppression sweep — exact sequential greedy NMS over the sorted
   boxes.  On a CUDA tensor it is kernel K1 (``csrc/nms_sweep.cu``); on a
   CPU tensor it is the plain tile sweep below, the port of
   ``_suppression_sweep_batched`` with ``_chain_fixed_point``,
3. compact the survivors into a fixed buffer padded with -1 (or scatter
   the keep mask back to the original box order).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch.kernels import NMS_SWEEP
from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps

_NEG = -1e10


def _chain_fixed_point(iou_self: torch.Tensor, alive0: torch.Tensor,
                       t: int) -> torch.Tensor:
    """Resolve the within-tile greedy chain by fixed-point iteration (the
    suppressor of a suppressed box does not count).  ``iou_self`` is the
    (..., t, t) strictly-upper-triangular suppressor relation; extra
    iterations past one row's fixed point leave it unchanged, so a joint
    loop over many images decides each image exactly."""
    alive, prev = alive0, torch.zeros_like(alive0)
    it = 0
    while it < t and bool((alive != prev).any()):
        sup = (iou_self & alive[..., :, None]).any(dim=-2)
        alive, prev = alive0 & ~sup, alive
        it += 1
    return alive


def suppression_sweep_plain(boxes: torch.Tensor, alive_init: torch.Tensor,
                            iou_threshold: float, tile_size: int
                            ) -> torch.Tensor:
    """The plain version of K1: exact greedy NMS over B images, boxes
    (B, K, 4) score-sorted per image, alive_init (B, K) → keep (B, K).

    Each tile of ``tile_size`` boxes is first suppressed by the final
    survivors of earlier tiles, then its own chain is resolved."""
    b, k = alive_init.shape
    t = tile_size
    if k % t != 0:
        raise ValueError(f"padded box count {k} must be a multiple of tile {t}")
    tri = torch.arange(t, device=boxes.device)[:, None] < torch.arange(
        t, device=boxes.device)[None, :]
    iou0 = bbox_overlaps(boxes[:, :t], boxes[:, :t]) > iou_threshold
    keep = alive_init.clone()
    keep[:, :t] = _chain_fixed_point(iou0 & tri, alive_init[:, :t], t)
    for start in range(t, k, t):
        end = start + t
        # boxes after this tile neither suppress it nor are decided here
        overlaps = bbox_overlaps(boxes[:, start:end],
                                 boxes[:, :end]) > iou_threshold
        sup_prev = (overlaps[:, :, :start] & keep[:, None, :start]).any(dim=2)
        alive0 = keep[:, start:end] & ~sup_prev
        iou_self = overlaps[:, :, start:end] & tri
        keep[:, start:end] = _chain_fixed_point(iou_self, alive0, t)
    return keep


def suppression_sweep_cuda(boxes: torch.Tensor, alive_init: torch.Tensor,
                           iou_threshold: float) -> torch.Tensor:
    """Kernel K1 on the card: same contract as the plain sweep, any K."""
    if not (boxes.is_cuda and alive_init.device == boxes.device):
        raise ValueError("suppression_sweep_cuda needs CUDA tensors on one device")
    if boxes.dtype != torch.float32 or alive_init.dtype != torch.bool:
        raise TypeError(f"need fp32 boxes and bool alive, got {boxes.dtype}, "
                        f"{alive_init.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            alive_init.shape != boxes.shape[:2]:
        raise ValueError(f"bad shapes boxes {tuple(boxes.shape)} alive "
                         f"{tuple(alive_init.shape)}")
    b, k = alive_init.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit")
    boxes = boxes.contiguous()
    alive_init = alive_init.contiguous()
    # the IoU words column-block-major: (image, col block, row padded to 64)
    n = (k + 63) // 64
    mask = torch.empty((b, n, 64 * n), dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    # the launch goes to the current device: make it the tensors' card
    with torch.cuda.device(boxes.device):
        NMS_SWEEP.launch(boxes.data_ptr(), alive_init.data_ptr(), b, k,
                         float(iou_threshold), mask.data_ptr(),
                         keep.data_ptr(),
                         torch.cuda.current_stream(boxes.device).cuda_stream)
    return keep


def suppression_sweep(boxes: torch.Tensor, alive_init: torch.Tensor,
                      iou_threshold: float, tile_size: int) -> torch.Tensor:
    """K1 for a CUDA tensor, its plain version for a CPU tensor."""
    if boxes.is_cuda:
        return suppression_sweep_cuda(boxes, alive_init, iou_threshold)
    if boxes.device.type == "cpu":
        return suppression_sweep_plain(boxes, alive_init, iou_threshold,
                                       tile_size)
    raise ValueError(f"unsupported device {boxes.device}")


def _mask_pad_sort(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: Optional[torch.Tensor], tile_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, int]:
    """Mask invalid scores, pad to a tile multiple, sort descending.
    boxes (B, K, 4) / scores (B, K) → (boxes_sorted, order, alive0, pad, t)."""
    k = scores.shape[-1]
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    if valid is not None:
        scores = torch.where(valid, scores, _NEG)
    t = min(tile_size, max(k, 1))
    pad = (-k) % t
    if pad:
        boxes = F.pad(boxes, (0, 0, 0, pad))
        scores = F.pad(scores, (0, pad), value=_NEG)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_sorted = torch.gather(boxes, -2,
                                order[..., None].expand(boxes.shape))
    alive0 = torch.gather(scores, -1, order) > _NEG / 2
    return boxes_sorted, order, alive0, pad, t


def _sorted_survivors(boxes, scores, valid, iou_threshold, tile_size):
    boxes_sorted, order, alive0, pad, t = _mask_pad_sort(
        boxes, scores, valid, tile_size)
    keep = suppression_sweep(boxes_sorted, alive0, iou_threshold, t)
    return order, keep, pad


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              max_output: int, valid: Optional[torch.Tensor] = None,
              tile_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per image: boxes (B, K, 4), scores (B, K) →
    ((B, max_output) int64 indices by descending score padded with -1,
    (B, max_output) bool valid)."""
    b, k = scores.shape
    if k == 0:
        return (torch.full((b, max_output), -1, dtype=torch.int64,
                           device=scores.device),
                torch.zeros((b, max_output), dtype=torch.bool,
                            device=scores.device))
    order, keep, _ = _sorted_survivors(boxes, scores, valid, iou_threshold,
                                       tile_size)
    pos = torch.cumsum(keep, dim=1) - 1
    emit = keep & (pos < max_output)
    # non-emitted survivors all land in a spill column that is dropped
    target = torch.where(emit, pos, max_output)
    out = torch.full((b, max_output + 1), -1, dtype=torch.int64,
                     device=scores.device)
    out.scatter_(1, target, order)
    out = out[:, :max_output]
    return out, out >= 0


def nms_mask_batch(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float, valid: Optional[torch.Tensor] = None,
                   tile_size: int = 256) -> torch.Tensor:
    """Greedy NMS per image returning a (B, K) keep mask in the original
    box order (the eval postprocess's per-class NMS)."""
    b, k = scores.shape
    if k == 0:
        return torch.zeros((b, 0), dtype=torch.bool, device=scores.device)
    order, keep_sorted, pad = _sorted_survivors(boxes, scores, valid,
                                                iou_threshold, tile_size)
    keep = torch.zeros((b, k + pad), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, order, keep_sorted)
    return keep[:, :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int, valid: Optional[torch.Tensor] = None,
        tile_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of one image: boxes (K, 4), scores (K,) → ((max_output,)
    int64 indices by descending score padded with -1, (max_output,) bool
    valid)."""
    idx, ok = nms_batch(boxes[None], scores[None], iou_threshold, max_output,
                        None if valid is None else valid[None], tile_size)
    return idx[0], ok[0]


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None,
             tile_size: int = 256) -> torch.Tensor:
    """Greedy NMS of one image returning a (K,) keep mask in the original
    box order."""
    return nms_mask_batch(boxes[None], scores[None], iou_threshold,
                          None if valid is None else valid[None],
                          tile_size)[0]
