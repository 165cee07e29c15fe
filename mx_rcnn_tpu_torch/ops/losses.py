"""Training losses and metrics.

Counterpart of ``mx_rcnn_tpu/ops/losses.py``: softmax cross-entropy with
an ignore label, smooth-L1 weighted and divided by a fixed count, and the
masked accuracy the training log reports.  Everything is computed in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              sigma: float = 1.0) -> torch.Tensor:
    """Elementwise ``0.5 (sigma x)^2`` if ``|x| < 1/sigma^2``, else
    ``|x| - 0.5/sigma^2``."""
    sigma2 = sigma * sigma
    diff = (pred - target).to(torch.float32)
    abs_diff = diff.abs()
    return torch.where(abs_diff < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       abs_diff - 0.5 / sigma2)


def softmax_cross_entropy_with_ignore(logits: torch.Tensor,
                                      labels: torch.Tensor,
                                      ignore_label: int = -1,
                                      normalization: str = "valid"
                                      ) -> torch.Tensor:
    """Softmax CE over the last axis; labels equal to ``ignore_label`` add
    nothing.  ``normalization``: 'valid' divides by the non-ignored count
    (at least 1), 'batch' by the label count, 'null' returns the sum."""
    logits = logits.to(torch.float32)
    mask = labels != ignore_label
    safe = torch.where(mask, labels, 0).to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    total = torch.where(mask, nll, 0.0).sum()
    if normalization == "valid":
        return total / mask.to(torch.float32).sum().clamp_min(1.0)
    if normalization == "batch":
        return total / float(labels.numel())
    if normalization == "null":
        return total
    raise ValueError(f"unknown normalization {normalization!r}")


def weighted_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                       weight: torch.Tensor, sigma: float,
                       grad_norm: float) -> torch.Tensor:
    """``sum(weight * smooth_l1(pred - target)) / grad_norm``."""
    loss = smooth_l1(pred, target, sigma) * weight.to(torch.float32)
    return loss.sum() / float(grad_norm)


def accuracy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_label: int = -1) -> torch.Tensor:
    """Accuracy over the non-ignored labels.  ``torch.argmax`` returns the
    first of tied maxima, as ``jnp.argmax`` does."""
    mask = labels != ignore_label
    pred = torch.argmax(logits, dim=-1)
    correct = torch.where(mask, (pred == labels).to(torch.float32), 0.0)
    return correct.sum() / mask.to(torch.float32).sum().clamp_min(1.0)
