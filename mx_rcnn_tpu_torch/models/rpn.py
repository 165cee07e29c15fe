"""Region Proposal Network head.

Counterpart of ``mx_rcnn_tpu/models/rpn.py``: 3x3 conv (512) + relu, then
1x1 convs to 2A scores and 4A deltas, Normal(0.01) init.  Outputs are
ordered (H, W, A) with anchors innermost, so the NCHW conv output is
permuted to NHWC before the ``(N, H*W*A, ·)`` reshape.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mx_rcnn_tpu_torch.models.layers import Conv2dSame


class RPNHead(nn.Module):
    def __init__(self, cin: int, num_anchors: int = 9, mid_channels: int = 512):
        super().__init__()
        self.num_anchors = num_anchors
        self.rpn_conv_3x3 = Conv2dSame(cin, mid_channels, 3, init="normal:0.01")
        self.rpn_cls_score = Conv2dSame(mid_channels, 2 * num_anchors, 1,
                                        init="normal:0.01")
        self.rpn_bbox_pred = Conv2dSame(mid_channels, 4 * num_anchors, 1,
                                        init="normal:0.01")

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat (N, C, H, W) → (cls logits (N, H*W*A, 2), deltas (N, H*W*A, 4)).

        In eval mode one image at a time: on the card, the batched head
        gives an image at row 0 of a 608x1024 batch other bits than at
        rows 1-3 (``tools/row_probe.py``), and an image's detections must
        not depend on the row it rides (a bulk run's shards are
        byte-equal whichever replica and row scored each image).  Training
        keeps the batched convolutions."""
        if not self.training:
            outs = [self._head(f) for f in feat.split(1)]
            return tuple(torch.cat(o) for o in zip(*outs))
        return self._head(feat)

    def _head(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.rpn_conv_3x3(feat))
        cls = self.rpn_cls_score(x).permute(0, 2, 3, 1)
        box = self.rpn_bbox_pred(x).permute(0, 2, 3, 1)
        n, h, w, _ = cls.shape
        a = self.num_anchors
        return (cls.reshape(n, h * w * a, 2), box.reshape(n, h * w * a, 4))
