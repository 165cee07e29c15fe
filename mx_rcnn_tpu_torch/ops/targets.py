"""Training targets: RPN anchor targets and RCNN proposal targets.

Counterpart of ``mx_rcnn_tpu/ops/targets.py`` with the image axis written
out (the JAX functions are per image under ``vmap``): every function takes
a leading batch dimension N.

The random subsampling cannot reproduce ``jax.random``, so each function
takes its uniforms as tensors, ``(u_fg, u_bg)`` with the shape of the
candidate mask; the selection given those uniforms is the JAX one exactly:

* :func:`_choose_k` keeps the ``quota`` smallest uniforms among the
  candidates, ties to the lower index (``lax.top_k``: a stable sort),
* :func:`_rank_of_uniform` ranks candidates by a stable argsort,
* ``proposal_target`` orders its slots by integer priorities that are
  distinct, so ``topk`` has one answer.

A caller that passes no uniforms gets them from ``generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch.ops.boxes import bbox_overlaps, bbox_transform

_INF = 3.4e38


def _uniforms(uniforms, shape, generator: Optional[torch.Generator], device):
    if uniforms is not None:
        return uniforms
    return tuple(torch.rand(shape, generator=generator, device=device)
                 for _ in range(2))


def _choose_k(u: torch.Tensor, mask: torch.Tensor, k_max: int,
              quota) -> torch.Tensor:
    """Keep min(quota, count(mask)) True elements of each row of ``mask``
    (..., n): those with the smallest uniforms ``u``, ties to the lower
    index.  ``quota`` is an int or a tensor of the leading shape."""
    k_max = min(k_max, mask.shape[-1])
    if k_max <= 0:
        return torch.zeros_like(mask)
    r = torch.where(mask, u, _INF)
    vals, idx = torch.sort(r, dim=-1, stable=True)
    vals, idx = vals[..., :k_max], idx[..., :k_max]
    pos = torch.arange(k_max, device=mask.device)
    quota = torch.as_tensor(quota, device=mask.device)[..., None]
    take = (pos < quota) & (vals < _INF)
    return torch.zeros_like(mask).scatter_(-1, idx, take)


def _rank_of_uniform(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0-based rank of each True element among the True elements of its row
    by uniform value; False elements rank after all True ones."""
    r = torch.where(mask, u, _INF)
    order = torch.sort(r, dim=-1, stable=True).indices
    pos = torch.arange(mask.shape[-1], device=mask.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor        # (N, A) int64 in {1, 0, -1}
    bbox_targets: torch.Tensor  # (N, A, 4) fp32
    bbox_weights: torch.Tensor  # (N, A, 4) fp32


def anchor_target(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, im_info: torch.Tensor,
                  uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None,
                  rpn_batch_size: int = 256, rpn_fg_fraction: float = 0.5,
                  positive_overlap: float = 0.7,
                  negative_overlap: float = 0.3,
                  clobber_positives: bool = False, allowed_border: int = 0,
                  bbox_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
                  ) -> AnchorTargets:
    """RPN targets for N images: anchors (A, 4) shared, gt_boxes (N, G, 4),
    gt_valid (N, G), im_info (N, 3), uniforms ((N, A), (N, A))."""
    n, a = gt_boxes.shape[0], anchors.shape[0]
    u_fg, u_bg = _uniforms(uniforms, (n, a), generator, anchors.device)
    gt = gt_boxes.to(torch.float32)
    b = allowed_border
    inside = ((anchors[:, 0] >= -b) & (anchors[:, 1] >= -b)
              & (anchors[:, 2] < im_info[:, 1:2] + b)
              & (anchors[:, 3] < im_info[:, 0:1] + b))        # (N, A)

    overlaps = bbox_overlaps(anchors, gt)                    # (N, A, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, 0.0)
    max_overlap = overlaps.max(dim=-1).values
    argmax_gt = torch.argmax(overlaps, dim=-1)
    any_gt = gt_valid.any(dim=-1, keepdim=True)

    # per-gt best anchors (all ties), among inside anchors only
    overlaps_in = torch.where(inside[..., None], overlaps, -1.0)
    gt_best = overlaps_in.max(dim=1, keepdim=True).values     # (N, 1, G)
    is_gt_best = ((overlaps_in == gt_best) & gt_valid[:, None, :]
                  & (gt_best > 0)).any(dim=-1)

    neg = inside & (max_overlap < negative_overlap)
    pos = inside & (is_gt_best | (max_overlap >= positive_overlap)) & any_gt
    if clobber_positives:
        pos = pos & ~neg
    else:
        neg = neg & ~pos

    quota = int(rpn_fg_fraction * rpn_batch_size)
    pos_kept = _choose_k(u_fg, pos, quota, quota)
    num_pos = pos_kept.sum(dim=-1)
    neg_kept = _choose_k(u_bg, neg, rpn_batch_size, rpn_batch_size - num_pos)

    labels = torch.full((n, a), -1, dtype=torch.int64, device=anchors.device)
    labels = torch.where(neg_kept, 0, labels)
    labels = torch.where(pos_kept, 1, labels)

    matched_gt = torch.gather(gt, 1, argmax_gt[..., None].expand(-1, -1, 4))
    targets = bbox_transform(anchors.to(torch.float32), matched_gt)
    w = torch.tensor(bbox_weights, dtype=torch.float32, device=anchors.device)
    weights = torch.where(pos_kept[..., None], w, 0.0)
    targets = torch.where(pos_kept[..., None], targets, 0.0)
    return AnchorTargets(labels, targets, weights)


class ProposalTargets(NamedTuple):
    rois: torch.Tensor          # (N, B, 4) fp32
    labels: torch.Tensor        # (N, B) int64; 0 background, -1 filler
    bbox_targets: torch.Tensor  # (N, B, 4*classes) fp32
    bbox_weights: torch.Tensor  # (N, B, 4*classes) fp32
    fg_mask: torch.Tensor       # (N, B) bool


def proposal_pool_size(num_rois: int, max_gt: int, batch_rois: int,
                       gt_append: bool = True) -> int:
    """Length of the candidate pool ``proposal_target`` samples from, the
    shape of its uniforms."""
    return max(num_rois + (max_gt if gt_append else 0), batch_rois)


def proposal_target(rois: torch.Tensor, roi_valid: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                    gt_valid: torch.Tensor,
                    uniforms: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None,
                    num_classes: int = 21, batch_rois: int = 128,
                    fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                    bg_thresh_hi: float = 0.5, bg_thresh_lo: float = 0.0,
                    bbox_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
                    bbox_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2),
                    gt_append: bool = True) -> ProposalTargets:
    """Sample ``batch_rois`` ROIs per image and build the RCNN targets.

    rois (N, R, 4), roi_valid (N, R), gt_boxes (N, G, 4), gt_classes
    (N, G), gt_valid (N, G); uniforms ((N, P), (N, P)) with ``P =
    proposal_pool_size(R, G, batch_rois, gt_append)``.  Slots hold the
    selected fg first, then the selected bg, then filler labelled -1."""
    n = rois.shape[0]
    dev = rois.device
    gt = gt_boxes.to(torch.float32)
    all_rois = rois.to(torch.float32)
    all_valid = roi_valid
    if gt_append:
        all_rois = torch.cat([all_rois, gt], dim=1)
        all_valid = torch.cat([all_valid, gt_valid], dim=1)
    short = batch_rois - all_rois.shape[1]
    if short > 0:
        all_rois = F.pad(all_rois, (0, 0, 0, short))
        all_valid = F.pad(all_valid, (0, short))
    pool = all_rois.shape[1]
    u_fg, u_bg = _uniforms(uniforms, (n, pool), generator, dev)

    overlaps = bbox_overlaps(all_rois, gt)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, 0.0)
    max_ov = overlaps.max(dim=-1).values
    argmax_gt = torch.argmax(overlaps, dim=-1)

    fg = all_valid & (max_ov >= fg_thresh)
    bg = all_valid & (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo)
    fg_quota = int(round(fg_fraction * batch_rois))
    fg_rank = _rank_of_uniform(u_fg, fg)
    fg_sel = fg & (fg_rank < fg_quota)
    num_fg = fg_sel.sum(dim=-1, keepdim=True)
    bg_rank = _rank_of_uniform(u_bg, bg)
    bg_sel = bg & (bg_rank < batch_rois - num_fg)

    # integer priorities, distinct by construction: fg by rank, then bg by
    # rank, then filler by index
    filler = pool - torch.arange(pool, device=dev)
    prio = torch.where(fg_sel, 3 * pool - fg_rank,
                       torch.where(bg_sel, 2 * pool - bg_rank, filler))
    pick = torch.topk(prio, batch_rois, dim=-1).indices

    sel_rois = torch.gather(all_rois, 1, pick[..., None].expand(-1, -1, 4))
    sel_fg = torch.gather(fg_sel, 1, pick)
    sel_bg = torch.gather(bg_sel, 1, pick)
    sel_gt = torch.gather(argmax_gt, 1, pick)
    labels = torch.where(sel_fg, torch.gather(gt_classes.to(torch.int64), 1,
                                              sel_gt),
                         torch.where(sel_bg, 0, -1))

    matched = torch.gather(gt, 1, sel_gt[..., None].expand(-1, -1, 4))
    t = bbox_transform(sel_rois, matched)
    t = (t - torch.tensor(bbox_means, dtype=torch.float32, device=dev)) / \
        torch.tensor(bbox_stds, dtype=torch.float32, device=dev)
    # one_hot(-1) is the zero row, as in jax.nn.one_hot
    onehot = F.one_hot(labels.clamp_min(0), num_classes).to(torch.float32) \
        * (labels >= 0)[..., None]
    targets = (onehot[..., None] * t[..., None, :]).reshape(
        n, batch_rois, 4 * num_classes)
    weights = (onehot[..., None] * sel_fg[..., None, None]).expand(
        n, batch_rois, num_classes, 4).reshape(n, batch_rois, 4 * num_classes)
    fg_label = (labels > 0)[..., None]
    return ProposalTargets(sel_rois, labels, targets * fg_label,
                           weights * fg_label, sel_fg)
