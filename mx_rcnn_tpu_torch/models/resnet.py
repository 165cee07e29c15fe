"""ResNet-50/101 backbone (stride 16) and per-ROI head.

Counterpart of ``mx_rcnn_tpu/models/resnet.py``: pre-activation bottleneck
units with frozen BN (stride on ``conv2``, projection shortcut ``sc`` from
the first activation), a 3x3/2 max-pool padded with −inf, and a head that
runs the 2048-filter stage per ROI and closes with ``bn1`` → relu →
spatial mean.  Module names match the flax names so the weight bridge is
mechanical.  Layers run NCHW; the head takes NHWC pooled features.
``quant`` (an ``ops/quant.py — QuantSpec``) makes every convolution a
quantized one: conv0 and each unit's conv1/conv2/conv3/sc, in the
backbone and in the per-ROI stage 4.  In the apply phase each frozen BN
that feeds quantized convolutions, with its ReLU, runs inside the
quantizer (``ops/quant.py — quantize_act_fused``: K4, one launch, on the
card), which writes each reading layer's quantized input; the bf16
activations between BN and convolution are never written.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mx_rcnn_tpu_torch.models.layers import (FrozenBatchNorm,
                                             QuantConv2dSame, conv)
from mx_rcnn_tpu_torch.ops.quant import QuantSpec, quantize_act_fused

STAGE_UNITS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


def _quant_apply(layer: nn.Module) -> bool:
    return isinstance(layer, QuantConv2dSame) and layer.spec.phase == "apply"


def bn_quantize(x: torch.Tensor, bn: FrozenBatchNorm, layers, relu: bool
                ) -> List[torch.Tensor]:
    """``relu(bn(x))`` (or ``bn(x.to(dtype))`` without ``relu``)
    quantized for each quantized layer of ``layers``, against its folded
    step, in one pass."""
    for m in layers:
        m.check_prepared()
    return quantize_act_fused(x, [m.x_unit for m in layers], layers[0].spec,
                              affine=bn.folded(), dtype=bn.dtype, relu=relu)


class BottleneckUnit(nn.Module):
    """bn→relu→1x1(f/4) → bn→relu→3x3(f/4, stride) → bn→relu→1x1(f), plus
    the identity or a 1x1 projection of the first activation."""

    def __init__(self, cin: int, filters: int, stride: int, dim_match: bool,
                 dtype: torch.dtype, quant: Optional[QuantSpec] = None):
        super().__init__()
        mid = filters // 4
        self.dim_match = dim_match
        self.bn1 = FrozenBatchNorm(cin, dtype)
        self.conv1 = conv(cin, mid, 1, bias=False, quant=quant)
        self.bn2 = FrozenBatchNorm(mid, dtype)
        self.conv2 = conv(mid, mid, 3, stride, bias=False, quant=quant)
        self.bn3 = FrozenBatchNorm(mid, dtype)
        # zero-init residual output: with frozen identity BN a he-init
        # conv3 doubles the activation variance per unit (2^33 by the end
        # of ResNet-101); pretrained weights overwrite it
        self.conv3 = conv(mid, filters, 1, bias=False, init="zeros",
                          quant=quant)
        if not dim_match:
            self.sc = conv(cin, filters, 1, stride, bias=False, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _quant_apply(self.conv1):
            return self._forward_quantized(x)
        act1 = F.relu(self.bn1(x))
        c1 = self.conv1(act1)
        c2 = self.conv2(F.relu(self.bn2(c1)))
        c3 = self.conv3(F.relu(self.bn3(c2)))
        shortcut = x if self.dim_match else self.sc(act1)
        return c3 + shortcut

    def _forward_quantized(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` with each BN and ReLU inside K4; ``bn1``'s pass
        writes the projection's input too."""
        dtype = self.bn1.dtype
        first = [self.conv1] if self.dim_match else [self.conv1, self.sc]
        q1 = bn_quantize(x, self.bn1, first, relu=True)
        c1 = self.conv1.forward_quantized(q1[0], dtype)
        q2, = bn_quantize(c1, self.bn2, [self.conv2], relu=True)
        c2 = self.conv2.forward_quantized(q2, dtype)
        q3, = bn_quantize(c2, self.bn3, [self.conv3], relu=True)
        c3 = self.conv3.forward_quantized(q3, dtype)
        shortcut = x if self.dim_match else self.sc.forward_quantized(
            q1[1], dtype)
        return c3 + shortcut


def _add_stage(parent: nn.Module, cin: int, filters: int, units: int,
               stride: int, dtype: torch.dtype, prefix: str,
               quant: Optional[QuantSpec] = None) -> List[str]:
    names = []
    for u in range(units):
        name = f"{prefix}_unit{u + 1}"
        parent.add_module(name, BottleneckUnit(
            cin if u == 0 else filters, filters, stride if u == 0 else 1,
            dim_match=u != 0, dtype=dtype, quant=quant))
        names.append(name)
    return names


class ResNetBackbone(nn.Module):
    """(N, 3, H, W) mean-subtracted RGB → (N, 1024, H/16, W/16)."""

    out_channels = 1024

    def __init__(self, depth: int = 101, dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantSpec] = None, in_channels: int = 3):
        super().__init__()
        units = STAGE_UNITS[depth]
        self.dtype = dtype
        self.bn_data = FrozenBatchNorm(in_channels, dtype)
        self.conv0 = conv(in_channels, 64, 7, 2, bias=False, quant=quant)
        self.bn0 = FrozenBatchNorm(64, dtype)
        self.units = (
            _add_stage(self, 64, 256, units[0], 1, dtype, "stage1", quant)
            + _add_stage(self, 256, 512, units[1], 2, dtype, "stage2", quant)
            + _add_stage(self, 512, 1024, units[2], 2, dtype, "stage3",
                         quant))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _quant_apply(self.conv0):
            q, = bn_quantize(x, self.bn_data, [self.conv0], relu=False)
            x = self.conv0.forward_quantized(q, self.dtype)
        else:
            x = self.conv0(self.bn_data(x.to(self.dtype)))
        x = F.relu(self.bn0(x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.units:
            x = getattr(self, name)(x)
        return x


class ResNetHead(nn.Module):
    """(R, ph, pw, 1024) NHWC pooled features → (R, 2048): the stage-4
    units (first stride 2) + bn1 + relu + global mean."""

    out_channels = 2048
    dropout_sites = ()

    def __init__(self, depth: int = 101, dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantSpec] = None):
        super().__init__()
        self.dtype = dtype
        self.units = _add_stage(self, 1024, 2048, STAGE_UNITS[depth][3], 2,
                                dtype, "stage4", quant)
        self.bn1 = FrozenBatchNorm(2048, dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view
        for name in self.units:
            x = getattr(self, name)(x)
        x = F.relu(self.bn1(x))
        return x.mean(dim=(2, 3))
