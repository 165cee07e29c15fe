"""Shared layers: frozen BatchNorm, flax-"SAME" convolution, dense.

Counterpart of ``mx_rcnn_tpu/models/layers.py``.  Layers work on NCHW
tensors (the backbone runs NCHW views of channels-last memory).  Weights
are initialised by :meth:`init_` from an explicit ``torch.Generator`` with
the flax initialisers the reference uses.  Convolutions and dense layers
cast their weights to the activation dtype inside ``forward``, as flax's
``kernel.astype(dtype)`` does, so fp32 master weights train a bf16 model;
a weight already stored in the activation dtype casts to itself.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mx_rcnn_tpu_torch.ops.quant import (QuantSpec, _unit, new_act_stats,
                                         pack_weight, qconv_prepared,
                                         qdot_prepared, quantize_act_fused,
                                         quantize_weight, record_act_stats)

# std of a unit normal truncated to [-2, 2]: flax's truncated-normal
# variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       generator: Optional[torch.Generator]) -> None:
    """flax ``variance_scaling(scale, 'fan_in', 'truncated_normal')``:
    Normal(0, std) truncated to ±2 std, drawn by redrawing only the
    entries that fall outside (~4.6% at each pass), which is quick for
    fc6's 102.8 M weights."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    flat = w.view(-1).normal_(0.0, std, generator=generator)
    out = (flat.abs() > 2.0 * std).nonzero().squeeze(1)
    while out.numel():
        redrawn = torch.empty(out.numel(), dtype=w.dtype,
                              device=w.device).normal_(0.0, std,
                                                       generator=generator)
        flat[out] = redrawn
        out = out[redrawn.abs() > 2.0 * std]


def _init_weight_(w: torch.Tensor, init: str,
                  generator: Optional[torch.Generator]) -> None:
    fan_in = w[0].numel()  # OIHW conv and (out, in) dense alike
    with torch.no_grad():
        if init == "he_normal":
            _variance_scaling_(w, 2.0, fan_in, generator)
        elif init == "lecun_normal":
            _variance_scaling_(w, 1.0, fan_in, generator)
        elif init == "zeros":
            w.zero_()
        elif init.startswith("normal:"):
            w.normal_(0.0, float(init.split(":", 1)[1]), generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm (eps 2e-5): folded to one scale/shift in
    fp32, applied to the fp32 input, then cast once to ``dtype``.  The
    affine ``weight``/``bias`` are parameters (the optimizer's frozen mask
    decides whether they train); the running statistics are buffers.
    :meth:`folded` hands the scale/shift to K4, which applies them on the
    quantized path."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 eps: float = 2e-5):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self._folded = None

    def _fold(self):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return inv, shift

    def folded(self):
        """``(inv, shift)``, fp32 on the parameters' device, computed once
        by the expressions of :meth:`forward` (so the bits are its bits)
        and again only when a parameter or statistic changes."""
        key = tuple((t.device, t.data_ptr(), t._version) for t in
                    (self.weight, self.bias, self.running_mean,
                     self.running_var))
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                inv, shift = self._fold()
            self._folded = (key, inv.contiguous(), shift.contiguous())
        return self._folded[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self._fold()
        y = x.to(torch.float32) * inv[:, None, None] + shift[:, None, None]
        return y.to(self.dtype)


def same_pads(size: int, kernel: int, stride: int):
    """flax/XLA "SAME" padding for one axis: ``total = max((ceil(in/s) - 1)
    * s + k - in, 0)``, ``total // 2`` before and the rest after.  On even
    extents a stride-2 conv pads asymmetrically (7x7/2: (2, 3); 3x3/2:
    (0, 1)), which torch's symmetric ``padding=`` cannot express."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Module):
    """NCHW convolution with flax "SAME" padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = True, init: str = "he_normal"):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.init = init
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def init_(self, generator: Optional[torch.Generator]) -> None:
        _init_weight_(self.weight, self.init, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (pt, pb), (pl, pr) = (same_pads(s, self.kernel, self.stride)
                              for s in x.shape[-2:])
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if pt == pb and pl == pr:
            return F.conv2d(x, weight, bias, self.stride, (pt, pl))
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, bias, self.stride)


class Dense(nn.Module):
    """``(…, in) → (…, out)`` with a (out, in) weight."""

    def __init__(self, cin: int, cout: int, init: str = "lecun_normal"):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def init_(self, generator: Optional[torch.Generator]) -> None:
        _init_weight_(self.weight, self.init, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _QuantMixin:
    """The state a quantized layer adds, none of it in the state_dict:
    the calibrated activation scale ``act_scale`` (apply phase) and its
    step ``x_unit``, the weight quantized once by :meth:`prepare_`
    (``qweight`` in the weight's layout, ``w_unit`` per output channel,
    and ``packed``, the rows K5/K6 read), and the calibration phase's
    statistics ``stats``."""

    def _init_quant(self, spec: QuantSpec) -> None:
        self.spec = spec
        for name in ("act_scale", "x_unit", "qweight", "w_unit", "packed"):
            self.register_buffer(name, None, persistent=False)
        self.stats: Optional[Dict[str, torch.Tensor]] = None

    def prepare_(self, act_scale) -> None:
        """Set the calibrated scale, fold it into the input's step once,
        and quantize the (fp32) weight."""
        if not torch.is_tensor(act_scale):
            act_scale = torch.from_numpy(np.array(act_scale, np.float32))
        self.act_scale = act_scale.to(torch.float32).to(
            self.weight.device).reshape(())
        self.x_unit = _unit(self.act_scale, self.spec.qmax)
        qw, self.w_unit = quantize_weight(self.weight, self.spec)
        self.qweight = qw
        sim = self.spec.dtype == "int8" and self.spec.mode == "sim"
        self.packed = None if sim else pack_weight(qw)

    def _record(self, x: torch.Tensor) -> None:
        if self.stats is None:
            self.stats = new_act_stats(x.device)
        record_act_stats(self.stats, x, self.spec)

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` quantized against this layer's step (K4 on the card)."""
        self.check_prepared()
        return quantize_act_fused(x, [self.x_unit], self.spec)[0]

    def check_prepared(self) -> None:
        if self.x_unit is None or self.qweight is None:
            raise RuntimeError(
                "quantized layer has no calibrated act_scale: calibrate "
                "first (core/tester.py — quant_predictor)")


class QuantConv2dSame(_QuantMixin, Conv2dSame):
    """Inference-only quantized NCHW convolution with flax "SAME"
    padding: the input is quantized per tensor against ``act_scale``
    and contracted with the per-channel quantized weight (K4 then K5/K6
    on the card), rescaled once, the bias added in fp32 and the result
    cast once to the input's dtype, as the JAX ``QuantConv``.  In the
    calibration phase it is :class:`Conv2dSame` recording statistics."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = True, init: str = "he_normal",
                 spec: QuantSpec = QuantSpec()):
        super().__init__(cin, cout, kernel, stride, bias, init)
        self._init_quant(spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.phase == "calib":
            self._record(x)
            return super().forward(x)
        return self.forward_quantized(self.quantize_input(x), x.dtype)

    def forward_quantized(self, q: torch.Tensor, out_dtype: torch.dtype
                          ) -> torch.Tensor:
        """The apply phase on ``q``, the NCHW input already quantized
        against ``x_unit`` (by :meth:`quantize_input`, or by K4 with the
        BN before this layer); the output in ``out_dtype``."""
        self.check_prepared()
        y = qconv_prepared(q.permute(0, 2, 3, 1), self.qweight, self.packed,
                           self.w_unit, None, self.spec,
                           (self.stride, self.stride), "SAME",
                           bias=self.bias, out_dtype=out_dtype,
                           x_unit=self.x_unit)
        return y.permute(0, 3, 1, 2)  # NCHW view of NHWC memory


class QuantDense(_QuantMixin, Dense):
    """The :class:`QuantConv2dSame` contract for ``(…, in) → (…, out)``."""

    def __init__(self, cin: int, cout: int, init: str = "lecun_normal",
                 spec: QuantSpec = QuantSpec()):
        super().__init__(cin, cout, init)
        self._init_quant(spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec.phase == "calib":
            self._record(x)
            return super().forward(x)
        q = self.quantize_input(x.reshape(-1, x.shape[-1]))
        y = qdot_prepared(q, self.qweight, self.packed, self.w_unit, None,
                          self.spec, bias=self.bias, out_dtype=x.dtype,
                          x_unit=self.x_unit)
        return y.reshape(x.shape[:-1] + y.shape[-1:])


QUANT_LAYERS = (QuantConv2dSame, QuantDense)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         bias: bool = True, init: str = "he_normal",
         quant: Optional[QuantSpec] = None) -> Conv2dSame:
    """:class:`Conv2dSame`, or with a ``quant`` recipe the
    :class:`QuantConv2dSame` of the same parameters."""
    if quant is None:
        return Conv2dSame(cin, cout, kernel, stride, bias, init)
    return QuantConv2dSame(cin, cout, kernel, stride, bias, init, quant)


def dense(cin: int, cout: int, init: str = "lecun_normal",
          quant: Optional[QuantSpec] = None) -> Dense:
    """:class:`Dense`, or its :class:`QuantDense` for a ``quant`` recipe."""
    if quant is None:
        return Dense(cin, cout, init)
    return QuantDense(cin, cout, init, quant)
