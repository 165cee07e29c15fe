"""VGG16 backbone and its fc6/fc7 head.

Counterpart of ``mx_rcnn_tpu/models/vgg.py``: conv1_1 … conv5_3 (3x3,
"SAME", ReLU) with a 2x2 max-pool after each of the first four blocks
(flax's VALID windows, which floor an odd extent) and no pool5, so the
features are at stride 16 with 512 channels; the head flattens the
(R, 7, 7, 512) pooled features in NHWC order, as flax does, before fc6
and fc7 (4096 each, ReLU), each followed in train mode by dropout 0.5.

Dropout takes its uniforms from the caller, ``u`` of the activation's
shape: an element is kept where ``u < keep_prob`` and scaled by
``1 / keep_prob``, flax's ``bernoulli(keep_prob)`` rule, so a mask drawn
by flax can be replayed exactly.  ``quant`` quantizes the 13 convolutions
and fc6/fc7 (``ops/quant.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mx_rcnn_tpu_torch.models.layers import conv, dense
from mx_rcnn_tpu_torch.ops.quant import QuantSpec

# (block name, number of convs, filters); a pool after blocks 1-4 only
VGG16_BLOCKS = (
    ("conv1", 2, 64),
    ("conv2", 2, 128),
    ("conv3", 3, 256),
    ("conv4", 3, 512),
    ("conv5", 3, 512),
)


class VGGBackbone(nn.Module):
    out_channels = 512

    def __init__(self, dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantSpec] = None, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.blocks = []
        cin = in_channels
        for name, n_convs, filters in VGG16_BLOCKS:
            names = []
            for j in range(n_convs):
                setattr(self, f"{name}_{j + 1}",
                        conv(cin, filters, 3, quant=quant))
                names.append(f"{name}_{j + 1}")
                cin = filters
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, names in enumerate(self.blocks):
            for name in names:
                x = F.relu(getattr(self, name)(x))
            if i < 4:  # no pool5: conv5_3 stays at stride 16
                x = F.max_pool2d(x, 2, 2)
        return x


def dropout(x: torch.Tensor, u: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's ``nn.Dropout`` with its uniforms given: keep where
    ``u < 1 - rate``, scaled by ``1 / (1 - rate)``."""
    keep_prob = 1.0 - rate
    keep = u.to(x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class VGGHead(nn.Module):
    out_channels = 4096
    # the draws' sites of the dropouts after fc6 and fc7, in order; each
    # acts on the (R, out_channels) activation
    dropout_sites = ("dropout_fc6", "dropout_fc7")

    def __init__(self, pooled_size=(7, 7), in_channels: int = 512,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.5,
                 quant: Optional[QuantSpec] = None):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.fc6 = dense(pooled_size[0] * pooled_size[1] * in_channels, 4096,
                         quant=quant)
        self.fc7 = dense(4096, 4096, quant=quant)

    def forward(self, pooled: torch.Tensor,
                dropout_uniforms: Tuple[torch.Tensor, ...] = ()
                ) -> torch.Tensor:
        """(R, ph, pw, C) NHWC → (R, 4096), flattened in NHWC order.
        ``dropout_uniforms`` (train mode only): the (R, 4096) uniforms of
        the dropout after fc6 and after fc7."""
        x = pooled.to(self.dtype).reshape(pooled.shape[0], -1)
        x = F.relu(self.fc6(x))
        if dropout_uniforms:
            x = dropout(x, dropout_uniforms[0], self.dropout_rate)
        x = F.relu(self.fc7(x))
        if dropout_uniforms:
            x = dropout(x, dropout_uniforms[1], self.dropout_rate)
        return x
