"""A miniature backbone/head pair, the CPU test vehicle.

Counterpart of ``mx_rcnn_tpu/models/tiny.py``: two strided convs to stride
16 with 32 channels, and a head that flattens the (R, 7, 7, 32) pooled
features in NHWC order (as flax does) before a 64-unit dense layer.
``quant`` quantizes both convolutions and the dense layer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mx_rcnn_tpu_torch.models.layers import conv, dense
from mx_rcnn_tpu_torch.ops.quant import QuantSpec


class TinyBackbone(nn.Module):
    out_channels = 32

    def __init__(self, dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantSpec] = None, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv(in_channels, 16, 5, 4, quant=quant)
        self.conv2 = conv(16, 32, 3, 4, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x.to(self.dtype)))
        return F.relu(self.conv2(x))


class TinyHead(nn.Module):
    out_channels = 64
    dropout_sites = ()

    def __init__(self, pooled_size=(7, 7), in_channels: int = 32,
                 dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantSpec] = None):
        super().__init__()
        self.dtype = dtype
        self.fc = dense(pooled_size[0] * pooled_size[1] * in_channels, 64,
                        quant=quant)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """(R, ph, pw, C) NHWC → (R, 64); flattened in NHWC order."""
        x = pooled.to(self.dtype).reshape(pooled.shape[0], -1)
        return F.relu(self.fc(x))
