"""Device-side normalisation of raw uint8 image batches.

Counterpart of ``mx_rcnn_tpu/ops/normalize.py``: valid pixels become
``float32(uint8) - float32(mean)`` and padding beyond each image's real
(h, w) is masked back to exact 0.0, so the result equals the host
mean-subtract path (``data/image.py — pad_normalize``) bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def normalize_images(images: torch.Tensor, im_info: Optional[torch.Tensor],
                     pixel_means: Sequence[float]) -> torch.Tensor:
    """(N, H, W, 3) uint8 → mean-subtracted fp32, zero beyond (h_i, w_i);
    fp32 input passes through unchanged."""
    if images.dtype != torch.uint8:
        return images
    if im_info is None:
        raise ValueError("uint8 image batches need im_info to bound the "
                         "valid region during device-side normalization")
    n, h, w, _ = images.shape
    means = torch.tensor(pixel_means, dtype=torch.float32,
                         device=images.device)
    x = images.to(torch.float32) - means
    row = torch.arange(h, device=images.device).reshape(1, h, 1, 1)
    col = torch.arange(w, device=images.device).reshape(1, 1, w, 1)
    hi = im_info[:, 0].reshape(n, 1, 1, 1)
    wi = im_info[:, 1].reshape(n, 1, 1, 1)
    mask = (row < hi) & (col < wi)
    return torch.where(mask, x, 0.0)
