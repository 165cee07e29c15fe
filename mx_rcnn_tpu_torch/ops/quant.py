"""Post-training quantization of the inference forward (int8 / fp8).

Counterpart of ``mx_rcnn_tpu/ops/quant.py``, the Jacob et al. 2018
recipe: weights quantized per output channel, symmetric (zero-point 0),
from the fp32 checkpoint; activations quantized per tensor against a
scale from a calibration sweep over held-out training batches; two
containers, ``int8`` and ``fp8`` (e4m3), and two modes: ``native`` runs
the low-precision contraction (int8 x int8 accumulated in int32, e4m3 x
e4m3 accumulated in fp32) with one fp32 rescale at the end, ``sim`` runs
the same quantized integer values in fp32 arithmetic.

Layouts are torch's: conv weights OIHW, dense weights (out, in), so the
per-channel absmax runs over dims 1.. (the JAX package's HWIO and (in,
out) kernels reduce over their leading axes).  Activations at the public
functions are NHWC, as in the JAX package; the layers hand them over as
views of the channels-last memory the backbone already runs in.

On a CUDA tensor the activation quantizer is kernel K4
(``csrc/quantize.cu``) and the native contraction kernel K5 (int8) or K6
(e4m3) (``csrc/qconv.cu``); there is no way back to the plain versions on
the card.  K4 also takes in the frozen BN and ReLU that produce a ResNet
convolution's input (:func:`quantize_act_fused`), writing one quantized
tensor for each layer that reads it.  On a CPU tensor both are the plain
versions below: the
quantizer as the JAX expression, the contraction in float64 on the
quantized values (exact for int8), rounded once to fp32.  The sim mode's
fp32 convolution runs with TF32 off, so that it is the fp32 arithmetic
the JAX sim path is.  Weights are quantized once, in plain torch, when a
quantized layer is prepared (``models/layers.py``).

The calibration side (``record_act_stats``, ``finalize_calibration``,
``calibration_fingerprint``) works on nested dicts whose paths are the
flax collection's (``{'backbone': {'conv0': {'act_scale': ...}}}``), so
the same scales give the JAX package's fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
from fractions import Fraction
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch.kernels import QCONV_E4M3, QCONV_S8, QUANTIZE_ACT

_DTYPES = ("int8", "fp8")
_MODES = ("native", "sim")
_ESTIMATORS = ("absmax", "percentile")
_PHASES = ("apply", "calib")

# e4m3fn's largest finite magnitude: values are clipped to it before the
# cast, which would otherwise turn an overflow into NaN
FP8_MAX = 448.0

# what one layer's calibration statistics hold
_STAT_KEYS = frozenset({"amax", "psum", "pcnt"})

# the contraction depth K5/K6 step over; packed weights are zero-padded
# to a multiple of it
K_TILE = 32

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """The quantization recipe a quantized layer runs (from ``cfg.quant``
    by :func:`spec_from_config`)."""

    dtype: str = "int8"        # 'int8' | 'fp8' (e4m3)
    mode: str = "native"       # 'native' low-precision contraction | 'sim'
    estimator: str = "absmax"  # activation-scale estimator
    percentile: float = 99.9   # for estimator='percentile'
    # integer bits of the int8 container, shared by the weight channels
    # and the activation grid (qmax = 2^(b-1) - 1); below 8 is the
    # red-team over-quantization arm
    weight_bits: int = 8
    # 'apply' runs quantized; 'calib' runs the fp forward and records
    # activation statistics
    phase: str = "apply"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"quant dtype must be one of {_DTYPES}, "
                             f"got {self.dtype!r}")
        if self.mode not in _MODES:
            raise ValueError(f"quant mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.estimator not in _ESTIMATORS:
            raise ValueError(f"quant estimator must be one of "
                             f"{_ESTIMATORS}, got {self.estimator!r}")
        if self.phase not in _PHASES:
            raise ValueError(f"quant phase must be one of {_PHASES}, "
                             f"got {self.phase!r}")
        if not 2 <= self.weight_bits <= 8:
            raise ValueError(f"quant weight_bits must be in [2, 8], "
                             f"got {self.weight_bits}")
        if self.dtype == "fp8" and self.weight_bits != 8:
            # fp8's qmax is the format's own: a narrowed weight_bits would
            # be ignored, and a red-team arm would quietly run at full width
            raise ValueError("weight_bits only narrows the int8 "
                             "container; use dtype='int8' with "
                             f"weight_bits={self.weight_bits}")

    @property
    def qmax(self) -> float:
        """Largest magnitude of the quantized container."""
        if self.dtype == "fp8":
            return FP8_MAX
        return float(2 ** (self.weight_bits - 1) - 1)

    @property
    def container(self) -> torch.dtype:
        """The dtype K4 writes and K5/K6 read."""
        return torch.float8_e4m3fn if self.dtype == "fp8" else torch.int8


def spec_from_config(qcfg: "QuantConfig", phase: str = "apply") -> QuantSpec:
    """``cfg.quant`` → :class:`QuantSpec` (validates every knob).  The
    string annotation names the config section for configlint; ops/
    does not import config.py."""
    return QuantSpec(dtype=qcfg.dtype, mode=qcfg.mode,
                     estimator=qcfg.estimator, percentile=qcfg.percentile,
                     weight_bits=qcfg.weight_bits, phase=phase)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

def _unit(est: torch.Tensor, qmax: float) -> torch.Tensor:
    """Step size from an absmax-style estimate, floored so that an
    all-zero channel or tensor divides by a representable epsilon (its
    quantized values are exactly 0 either way)."""
    est = torch.as_tensor(est, dtype=torch.float32)
    return torch.clamp_min(est, 1e-12) / qmax


def _quantize_plain(x: torch.Tensor, unit: torch.Tensor, spec: QuantSpec
                    ) -> torch.Tensor:
    """The plain version of K4, for weights and activations alike: scale
    by ``unit``, then clip (and, for int8, round half to even) into the
    container; the sim mode keeps int8 values in fp32."""
    if spec.dtype == "fp8":
        return torch.clamp(x / unit, -FP8_MAX, FP8_MAX).to(
            torch.float8_e4m3fn)
    q = torch.clamp(torch.round(x / unit), -spec.qmax, spec.qmax)
    return q.to(torch.int8 if spec.mode == "native" else torch.float32)


def quantize_weight(w: torch.Tensor, spec: QuantSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of an OIHW conv or
    (out, in) dense weight (output channels on dim 0).  Returns ``(q,
    unit)``, ``q`` in ``w``'s shape and ``unit`` (out,): dequantized =
    q * unit.  Plain torch on any device (it runs once per layer)."""
    w = w.detach().to(torch.float32)
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())))
    unit = _unit(absmax, spec.qmax)
    return _quantize_plain(w, unit.view((-1,) + (1,) * (w.dim() - 1)),
                           spec), unit


def quantize_act_plain(x: torch.Tensor, est: torch.Tensor, spec: QuantSpec
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`quantize_act`."""
    unit = _unit(est, spec.qmax).to(x.device)
    return _quantize_plain(x.to(torch.float32), unit, spec), unit


def _dense(x: torch.Tensor) -> bool:
    """Row-major or channels-last dense storage: K4 walks the storage."""
    return x.is_contiguous() or (
        x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last))


# K4's launch (csrc/quantize.cu): 256-thread blocks, a thread moving 8
# elements a vector, the BN's per-channel values for at most 2048 channels
K4_THREADS = 256
K4_VECTOR = 8
K4_MAX_CHANNELS = 2048

Affine = Tuple[torch.Tensor, torch.Tensor]


def quantize_act_fused_plain(x: torch.Tensor, units: Sequence[torch.Tensor],
                             spec: QuantSpec, affine: Optional[Affine] = None,
                             dtype: Optional[torch.dtype] = None,
                             relu: bool = False) -> List[torch.Tensor]:
    """The plain version of :func:`quantize_act_fused`: the torch ops of
    ``FrozenBatchNorm.forward`` on ``x.to(dtype)`` (fp32 ``x * inv +
    shift`` on channel dim 1, cast to ``dtype``), ``F.relu``, and
    :func:`quantize_act_plain`'s quantizer once per unit."""
    if affine is not None:
        inv, shift = affine
        view = (-1,) + (1,) * (x.dim() - 2)
        x = (x.to(dtype).to(torch.float32) * inv.view(view)
             + shift.view(view)).to(dtype)
    if relu:
        x = F.relu(x)
    return [_quantize_plain(x.to(torch.float32), u, spec) for u in units]


def _check_on(t: torch.Tensor, x: torch.Tensor, what: str, numel: int
              ) -> None:
    if not (t.device == x.device and t.dtype == torch.float32
            and t.is_contiguous() and t.numel() == numel):
        raise ValueError(f"{what} must be {numel} contiguous fp32 values on "
                         f"{x.device}, got {t.numel()} {t.dtype} on "
                         f"{t.device}")


def quantize_act_fused_cuda(x: torch.Tensor, units: Sequence[torch.Tensor],
                            spec: QuantSpec, affine: Optional[Affine] = None,
                            dtype: Optional[torch.dtype] = None,
                            relu: bool = False) -> List[torch.Tensor]:
    """Kernel K4 on the card, one launch: :func:`quantize_act_fused`'s
    contract.  Without ``affine``, ``x`` is any dense tensor; with it, an
    NCHW view of channels-last memory of at most K4_MAX_CHANNELS
    channels.  Each output keeps ``x``'s memory layout."""
    if not x.is_cuda:
        raise ValueError("quantize_act_fused_cuda needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be fp32 or bf16, got {x.dtype}")
    if not 1 <= len(units) <= 2:
        raise ValueError(f"K4 writes one or two outputs, got {len(units)}")
    for u in units:
        _check_on(u, x, "a unit", 1)
    if affine is None:
        if dtype is not None or relu:
            raise ValueError("dtype and relu come with the BN's affine")
        if not _dense(x):
            raise ValueError("K4 needs dense storage")
        c, inv, shift = 1, None, None
    else:
        if x.dim() != 4 or not x.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError("the fused BN needs an NCHW view of "
                             "channels-last memory")
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the model dtype must be fp32 or bf16, got "
                            f"{dtype}")
        c = x.shape[1]
        if c > K4_MAX_CHANNELS:
            raise ValueError(f"{c} channels: K4 stages at most "
                             f"{K4_MAX_CHANNELS}")
        inv, shift = affine
        _check_on(inv, x, "inv", c)
        _check_on(shift, x, "shift", c)
    outs = [torch.empty_like(x, dtype=spec.container) for _ in units]
    # the second output and unit, or null pointers
    out1, unit1 = ((outs[1].data_ptr(), units[1].data_ptr())
                   if len(units) == 2 else (0, 0))
    with torch.cuda.device(x.device):
        QUANTIZE_ACT.launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(), c,
            0 if inv is None else inv.data_ptr(),
            0 if shift is None else shift.data_ptr(),
            int(dtype == torch.bfloat16), int(relu), outs[0].data_ptr(),
            units[0].data_ptr(), out1, unit1, float(spec.qmax),
            int(spec.dtype == "fp8"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if spec.dtype == "int8" and spec.mode == "sim":
        outs = [q.to(torch.float32) for q in outs]
    return outs


def quantize_act_fused(x: torch.Tensor, units: Sequence[torch.Tensor],
                       spec: QuantSpec, affine: Optional[Affine] = None,
                       dtype: Optional[torch.dtype] = None,
                       relu: bool = False) -> List[torch.Tensor]:
    """``x`` → optional frozen BN (``affine`` = the folded ``(inv,
    shift)`` of ``models/layers.py — FrozenBatchNorm``, applied to
    ``x.to(dtype)`` and cast to the model ``dtype``) → optional ReLU →
    one quantized tensor per unit (each layer reading the activation has
    its own), in ``x``'s layout.  K4 in one pass for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.is_cuda:
        return quantize_act_fused_cuda(x, units, spec, affine, dtype, relu)
    if x.device.type == "cpu":
        return quantize_act_fused_plain(x, units, spec, affine, dtype, relu)
    raise ValueError(f"unsupported device {x.device}")


def quantize_act_cuda(x: torch.Tensor, est: torch.Tensor, spec: QuantSpec
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4 on the card, no BN; same contract as
    :func:`quantize_act_plain` (the sim mode's fp32 values are K4's int8
    output, cast exactly).  The output keeps ``x``'s memory layout."""
    if not x.is_cuda:
        raise ValueError("quantize_act_cuda needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be fp32 or bf16, got {x.dtype}")
    if not _dense(x):
        x = x.contiguous()
    unit = _unit(est, spec.qmax).to(x.device)
    return quantize_act_fused_cuda(x, [unit], spec)[0], unit


def quantize_act(x: torch.Tensor, est: torch.Tensor, spec: QuantSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric activation quantization against the
    calibrated estimate ``est`` (a scalar): ``(q, unit)``.  K4 for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return quantize_act_cuda(x, est, spec)
    if x.device.type == "cpu":
        return quantize_act_plain(x, est, spec)
    raise ValueError(f"unsupported device {x.device}")


def fake_quant(x: torch.Tensor, est: torch.Tensor, spec: QuantSpec
               ) -> torch.Tensor:
    """Quantize-dequantize: the fp32 values the quantized representation
    can express."""
    q, unit = quantize_act(x, est, spec)
    return q.to(torch.float32) * unit


# ---------------------------------------------------------------------------
# the quantized contractions
# ---------------------------------------------------------------------------

def _on_kernels(x: torch.Tensor, spec: QuantSpec) -> bool:
    """The contraction of ``x`` runs K5/K6: a CUDA tensor, and the native
    int8 or either fp8 mode (int8 sim is the fp32 contraction)."""
    return x.is_cuda and not (spec.dtype == "int8" and spec.mode == "sim")


def pack_weight(qw: torch.Tensor) -> torch.Tensor:
    """A quantized OIHW or (out, in) weight → the (out, Kp) rows K5/K6
    read: each output channel's taps in (kh, kw, c_in) order, as the NHWC
    activations are laid out, zero-padded to a multiple of ``K_TILE``."""
    if qw.dim() == 4:
        qw = qw.permute(0, 2, 3, 1)
    rows = qw.reshape(qw.shape[0], -1)
    k = rows.shape[1]
    kp = -(-k // K_TILE) * K_TILE
    out = torch.zeros((rows.shape[0], kp), dtype=torch.int8,
                      device=qw.device)
    out[:, :k] = rows.view(torch.int8)
    return out.view(qw.dtype)


def _explicit_pads(padding, h: int, w: int, kh: int, kw: int,
                   stride: Tuple[int, int]) -> Pads:
    if padding == "SAME":
        from mx_rcnn_tpu_torch.models.layers import same_pads

        return (same_pads(h, kh, stride[0]), same_pads(w, kw, stride[1]))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int],
               pads: Pads) -> torch.Tensor:
    """NHWC ``x`` with an OIHW ``w`` → NHWC, in their (common) dtype."""
    (pt, pb), (pl, pr) = pads
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)), w,
                 stride=tuple(stride))
    return y.permute(0, 2, 3, 1)


def _accum_plain(qx: torch.Tensor, qw: torch.Tensor, spec: QuantSpec,
                 conv: Optional[Tuple[Tuple[int, int], Pads]]
                 ) -> torch.Tensor:
    """The contraction in plain torch → fp32: native (int8 and e4m3) in
    float64, exact for int8 and rounded once for e4m3; int8 sim in fp32
    with TF32 off (the JAX sim path's arithmetic)."""
    sim = spec.dtype == "int8" and spec.mode == "sim"
    t = torch.float32 if sim else torch.float64
    qx, qw = qx.to(t), qw.to(t)
    dense = conv is None
    if dense:
        # a dense layer as a 1x1 convolution, so that one switch (cuDNN's
        # TF32) governs both on the card
        qx, qw = qx[:, None, None, :], qw[:, :, None, None]
        conv = ((1, 1), ((0, 0), (0, 0)))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = _conv_nhwc(qx, qw, *conv).to(torch.float32)
    return y[:, 0, 0, :] if dense else y


def _epilogue(acc: torch.Tensor, x_unit: torch.Tensor, w_unit: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype
              ) -> torch.Tensor:
    """fp32 ``acc * (x_unit * w_unit)`` (the units' product first), the
    bias added in fp32, one cast to ``out_dtype``: the JAX ``QuantConv``
    order."""
    y = acc * (x_unit * w_unit)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)


# K5/K6's tiles (csrc/qconv.cu — Tile): a tile is QCONV_BM output rows by
# BN columns, one block an SM walks them; K moves through a ring of stages
# QCONV_BK deep in K (K6's B in f16, twice the bytes), at most
# QCONV_MAX_STAGES and QCONV_STAGE_BUDGET bytes of shared memory, beside a
# row-origin table (16 bytes a row), the consumers' epilogue buffers
# (QCONV_EPI_BYTES), two barriers a stage, and 1024 bytes of slack to
# align the ring for the 128-byte swizzle
QCONV_BM = 128
QCONV_BK = 128
QCONV_STAGE_BUDGET = 192 * 1024
QCONV_MAX_STAGES = 6
QCONV_EPI_BYTES = 2 * 64 * (32 * 4 + 32)
# shared memory one block may take on an H100, and its SMs; BN is chosen
# by waves of blocks over the SMs times a block's work, BN plus a fixed
# cost worth QCONV_BLOCK_COST columns (its fill, drain and epilogue)
QCONV_SMEM_LIMIT = 232448
H100_SMS = 132
QCONV_BLOCK_COST = 64
QCONV_ROUTES = ("gemm", "gather", "bytes")


@dataclasses.dataclass(frozen=True)
class QconvPlan:
    """How K5/K6 cover one contraction: ``route`` (how A reaches shared
    memory: ``gemm`` by TMA, ``gather`` by 16-byte cp.async, ``bytes``
    byte by byte), ``bn`` output columns a tile, ``stages`` in the
    ring, ``smem`` bytes a block asks for, the ``grid`` of tiles (row
    tiles, column tiles; min(tiles, SMs) blocks walk it), and the TMA
    ``maps`` as (operand, global dims innermost first in elements, row
    stride in bytes, box dims in elements)."""

    route: str
    bn: int
    stages: int
    smem: int
    grid: Tuple[int, int]
    maps: Tuple[Tuple[str, Tuple[int, int], int, Tuple[int, int]], ...]


def _qconv_slot(bn: int, fp8: bool) -> int:
    """One stage's bytes: A's 8-bit tile and B's (K6: f16) tile."""
    return (QCONV_BM + (2 if fp8 else 1) * bn) * QCONV_BK


def qconv_stages(bn: int, fp8: bool = False) -> int:
    """The ring's depth at ``bn``: as many stages as the budget holds, at
    most QCONV_MAX_STAGES."""
    return min(QCONV_MAX_STAGES, QCONV_STAGE_BUDGET // _qconv_slot(bn, fp8))


def qconv_plan(m: int, c: int, cout: int, kp: int, kernel: Tuple[int, int],
               stride: Tuple[int, int], pads: Pads, fp8: bool) -> QconvPlan:
    """K5/K6's tile plan for an M x Cout x K contraction over ``c`` input
    channels.  A 1x1 stride-1 convolution (or dense layer) reads A as a
    row-major [M, c] matrix by TMA; other shapes gather it, 16 bytes at a
    time where ``c % 16 == 0`` (a chunk within one tap), else byte by
    byte (conv0).  BN is 64 for Cout <= 64, else the width of 64, 128 and
    256 (K6 and the byte route: 64 and 128; K6's k32 scratch fragment
    sits beside its accumulators) whose waves of blocks cost least, the
    narrower on a tie."""
    one = (tuple(kernel) == (1, 1) and tuple(stride) == (1, 1)
           and tuple(map(tuple, pads)) == ((0, 0), (0, 0)))
    if c % 16:
        route = "bytes"
    elif one:
        route = "gemm"
    else:
        route = "gather"
    row_tiles = -(-m // QCONV_BM)
    widths = ((64,) if cout <= 64 else
              (64, 128) if fp8 or route == "bytes" else (64, 128, 256))

    def cost(bn):
        waves = -(-row_tiles * -(-cout // bn) // H100_SMS)
        return waves * (bn + QCONV_BLOCK_COST), bn

    bn = min(widths, key=cost)
    stages = qconv_stages(bn, fp8)
    smem = (1024 + stages * _qconv_slot(bn, fp8) + QCONV_BM * 16
            + QCONV_EPI_BYTES + 2 * stages * 8)
    # K6's B is the weight widened to f16: 64 elements make a 128-byte box
    bsize = 2 if fp8 else 1
    maps = (("b", (kp, cout), kp * bsize, (QCONV_BK // bsize, bn)),)
    if route == "gemm":
        maps += (("a", (c, m), c, (QCONV_BK, QCONV_BM)),)
    return QconvPlan(route, bn, stages, smem, (row_tiles, -(-cout // bn)),
                     maps)


def qconv_cuda(qx: torch.Tensor, packed: torch.Tensor, x_unit: torch.Tensor,
               w_unit: torch.Tensor, bias: Optional[torch.Tensor],
               out_dtype: torch.dtype, kernel: Tuple[int, int],
               stride: Tuple[int, int], pads: Pads) -> torch.Tensor:
    """Kernel K5 (int8) or K6 (e4m3): the NHWC implicit-GEMM convolution
    of quantized ``qx`` (N, H, W, C) with :func:`pack_weight` rows
    ``packed`` (Cout, Kp), epilogue fused (:func:`_epilogue`); returns
    NHWC ``out_dtype``.  A dense layer is the 1x1 case on a 1x1 map."""
    if not (qx.is_cuda and packed.device == qx.device):
        raise ValueError("qconv_cuda needs CUDA tensors on one device")
    if qx.dtype != packed.dtype or qx.dtype not in (torch.int8,
                                                     torch.float8_e4m3fn):
        raise TypeError(f"operands must both be int8 or e4m3, got "
                        f"{qx.dtype} and {packed.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"output must be fp32 or bf16, got {out_dtype}")
    n, h, w, c = qx.shape
    kh, kw = kernel
    cout, kp = packed.shape
    if kp % K_TILE or kp < kh * kw * c or kp - kh * kw * c >= K_TILE:
        raise ValueError(f"packed weight ({cout}, {kp}) does not fit a "
                         f"{kh}x{kw}x{c} contraction")
    (pt, pb), (pl, pr) = pads
    oh = (h + pt + pb - kh) // stride[0] + 1
    ow = (w + pl + pr - kw) // stride[1] + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty output for a {h}x{w} input")
    if n * oh * ow >= 2 ** 31 or qx.numel() >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's indexing")
    qx = qx.contiguous()
    packed = packed.contiguous()
    w_unit = w_unit.to(torch.float32).contiguous()
    x_unit = x_unit.to(torch.float32).reshape(1).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty((n, oh, ow, cout), dtype=out_dtype, device=qx.device)
    fp8 = qx.dtype == torch.float8_e4m3fn
    plan = qconv_plan(n * oh * ow, c, cout, kp, kernel, stride, pads, fp8)
    k = QCONV_E4M3 if fp8 else QCONV_S8
    # K6 widens the weight to f16 once a call, into this scratch
    w16 = (torch.empty((cout, kp), dtype=torch.float16, device=qx.device)
           if fp8 else None)
    with torch.cuda.device(qx.device):
        k.launch(qx.data_ptr(), packed.data_ptr(), x_unit.data_ptr(),
                 w_unit.data_ptr(), 0 if bias is None else bias.data_ptr(),
                 out.data_ptr(), int(out_dtype == torch.bfloat16),
                 n, h, w, c, oh, ow, cout, kh, kw, stride[0], stride[1],
                 pt, pl, kp, QCONV_ROUTES.index(plan.route), plan.bn,
                 plan.stages, 0 if w16 is None else w16.data_ptr(),
                 torch.cuda.current_stream(qx.device).cuda_stream)
    return out


def qconv_prepared(x: torch.Tensor, qw: torch.Tensor,
                   packed: Optional[torch.Tensor], w_unit: torch.Tensor,
                   act_est: Optional[torch.Tensor], spec: QuantSpec,
                   stride: Tuple[int, int], padding,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32,
                   x_unit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`qconv` with the weight already quantized (``qw`` OIHW and,
    for the card's native path, its :func:`pack_weight` rows).  Given
    ``x_unit``, ``x`` is the input already quantized against it (K4's
    output) and ``act_est`` is not read."""
    kh, kw = qw.shape[2:]
    pads = _explicit_pads(padding, x.shape[1], x.shape[2], kh, kw, stride)
    qx = x
    if x_unit is None:
        qx, x_unit = quantize_act(x, act_est, spec)
    if _on_kernels(x, spec):
        if packed is None:
            raise ValueError("the native path on the card needs the "
                             "packed weight (pack_weight)")
        return qconv_cuda(qx, packed, x_unit, w_unit, bias, out_dtype,
                          (kh, kw), tuple(stride), pads)
    acc = _accum_plain(qx, qw, spec, (tuple(stride), pads))
    return _epilogue(acc, x_unit, w_unit, bias, out_dtype)


def qdot_prepared(x: torch.Tensor, qw: torch.Tensor,
                  packed: Optional[torch.Tensor], w_unit: torch.Tensor,
                  act_est: Optional[torch.Tensor], spec: QuantSpec,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32,
                  x_unit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`qdot` with the (out, in) weight already quantized; given
    ``x_unit``, ``x`` is already quantized against it, as in
    :func:`qconv_prepared`."""
    lead, k = x.shape[:-1], x.shape[-1]
    qx = x.reshape(-1, k)
    if x_unit is None:
        qx, x_unit = quantize_act(qx, act_est, spec)
    if _on_kernels(x, spec):
        if packed is None:
            raise ValueError("the native path on the card needs the "
                             "packed weight (pack_weight)")
        y = qconv_cuda(qx.view(-1, 1, 1, k), packed, x_unit, w_unit, bias,
                       out_dtype, (1, 1), (1, 1), ((0, 0), (0, 0)))
    else:
        y = _epilogue(_accum_plain(qx, qw, spec, None), x_unit, w_unit,
                      bias, out_dtype)
    return y.reshape(lead + (qw.shape[0],))


def qdot(x: torch.Tensor, w: torch.Tensor, act_est: torch.Tensor,
         spec: QuantSpec) -> torch.Tensor:
    """Quantized dense contraction ``x (..., K) @ w (N, K).T → fp32``:
    (qx·qw) · x_unit · w_unit[n]."""
    qw, w_unit = quantize_weight(w, spec)
    packed = pack_weight(qw) if _on_kernels(x, spec) else None
    return qdot_prepared(x, qw, packed, w_unit, act_est, spec)


def qconv(x: torch.Tensor, w: torch.Tensor, act_est: torch.Tensor,
          spec: QuantSpec, strides: Tuple[int, int],
          padding: Union[str, Pads]) -> torch.Tensor:
    """Quantized NHWC convolution with an OIHW weight → NHWC fp32, the
    :func:`qdot` contract with per-output-channel units on the channel
    axis.  ``padding``: 'SAME' (flax's, asymmetric on even extents),
    'VALID' or ((top, bottom), (left, right))."""
    qw, w_unit = quantize_weight(w, spec)
    packed = pack_weight(qw) if _on_kernels(x, spec) else None
    return qconv_prepared(x, qw, packed, w_unit, act_est, spec,
                          tuple(strides), padding)


# ---------------------------------------------------------------------------
# calibration: statistics → activation scales → fingerprint
# ---------------------------------------------------------------------------

def _fma32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """fp32 ``fma(a, b, c)``: the exact ``a * b + c`` rounded once to
    nearest even (non-finite inputs take the plain expression)."""
    if not all(np.isfinite(v) for v in (a, b, c)):
        return np.float32(a * b + c)
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    best = np.float32(float(exact))
    # float() rounded to double first: settle a double rounding exactly
    for cand in (np.nextafter(best, np.float32(-np.inf)),
                 np.nextafter(best, np.float32(np.inf))):
        d_cand = abs(Fraction(float(cand)) - exact)
        d_best = abs(Fraction(float(best)) - exact)
        if d_cand < d_best or (d_cand == d_best and
                               not int(cand.view(np.uint32)) & 1):
            best = cand
    return best


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation) over all of ``x``
    as the JAX calibration sweep computes it, inside a jit with ``q`` a
    constant: the index ``q / 100 * (n - 1)`` in fp32, folded in order;
    the neighbours' weights from its floor; then ``lo * w_lo + hi *
    w_hi``, which XLA's CPU code contracts into one fma (the first
    product inside it).  Unlike ``torch.quantile`` it takes inputs over
    2^24 elements (a sort).  A NaN anywhere gives NaN, as in JAX.  The
    two neighbours are read back to the host (calibration is a one-off
    sweep)."""
    flat = x.reshape(-1).to(torch.float32)
    n = np.float32(flat.numel())
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(
        n - np.float32(1.0))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(np.float32(1.0) - w_hi)
    last = np.float32(n - np.float32(1.0))
    # an index the fp32 arithmetic rounds past the end reads the last
    # element, as XLA's gather clamps it
    lo = min(int(min(max(lo, np.float32(0.0)), last)), flat.numel() - 1)
    hi = min(int(min(max(hi, np.float32(0.0)), last)), flat.numel() - 1)
    if bool(torch.isnan(flat).any()):
        return torch.tensor(float("nan"), device=x.device)
    srt = torch.sort(flat).values
    v_lo, v_hi = (np.float32(v) for v in srt[[lo, hi]].tolist())
    out = _fma32(v_lo, w_lo, np.float32(v_hi * w_hi))
    return torch.tensor(float(out), dtype=torch.float32, device=x.device)


def record_act_stats(stats: Dict[str, torch.Tensor], x: torch.Tensor,
                     spec: QuantSpec) -> None:
    """Fold one calibration batch into a layer's ``{amax, psum, pcnt}``
    (fp32 scalars, updated in place): the running max of |x| and the
    running sum and count of the batch's ``spec.percentile`` of |x|.
    Both estimators are collected; :func:`finalize_calibration` picks."""
    ax = x.detach().to(torch.float32).abs()
    stats["amax"] = torch.maximum(stats["amax"], ax.max())
    stats["psum"] = stats["psum"] + percentile(ax, spec.percentile)
    stats["pcnt"] = stats["pcnt"] + 1.0


def new_act_stats(device) -> Dict[str, torch.Tensor]:
    """One layer's empty statistics."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("amax", "psum", "pcnt")}


def finalize_calibration(stats: Mapping, qcfg) -> Dict:
    """A statistics tree (one ``{amax, psum, pcnt}`` node per quantized
    layer) → the scales tree: each node becomes ``{act_scale}`` under the
    configured estimator, an fp32 scalar (a numpy value).  A pure
    function of the statistics."""
    def walk(node):
        if isinstance(node, Mapping) and _STAT_KEYS <= set(node):
            v = {k: np.float32(np.asarray(
                node[k].detach().cpu() if torch.is_tensor(node[k])
                else node[k], np.float32)) for k in _STAT_KEYS}
            if qcfg.estimator == "percentile":
                est = v["psum"] / np.maximum(v["pcnt"], np.float32(1.0))
            else:
                est = v["amax"]
            return {"act_scale": np.asarray(est, np.float32)}
        if isinstance(node, Mapping):
            return {k: walk(val) for k, val in node.items()}
        return node
    return walk(stats)


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def calibration_fingerprint(quant_col: Mapping, qcfg) -> str:
    """16 hex digits of a sha256 over the quant knobs (dtype, estimator,
    percentile, weight_bits) and every scale's path and exact fp32
    bytes, in ``keystr`` order: the JAX package's fingerprint of the same
    scales."""
    h = hashlib.sha256()
    h.update(repr((qcfg.dtype, qcfg.estimator, float(qcfg.percentile),
                   int(qcfg.weight_bits))).encode())
    leaves = sorted(((_keystr(p), v) for p, v in _leaves(quant_col)),
                    key=lambda kv: kv[0])
    for key, leaf in leaves:
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        h.update(key.encode())
        h.update(np.asarray(leaf, np.float32).tobytes())
    return h.hexdigest()[:16]


def quant_program_tag(qcfg, fingerprint: str) -> str:
    """The tag that keeps quantized and fp programs apart: the recipe and
    the calibration fingerprint."""
    return (f"quant[{qcfg.dtype}:{qcfg.mode}:{qcfg.estimator}"
            f":b{qcfg.weight_bits}:{fingerprint}]")


def quant_manifest_meta(qcfg, fingerprint: str) -> Dict[str, Any]:
    """The quant knobs a manifest records, fingerprint included."""
    return {
        "dtype": qcfg.dtype,
        "mode": qcfg.mode,
        "estimator": qcfg.estimator,
        "percentile": float(qcfg.percentile),
        "weight_bits": int(qcfg.weight_bits),
        "calibration_fingerprint": fingerprint,
    }
