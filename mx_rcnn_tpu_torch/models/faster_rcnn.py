"""The composite Faster R-CNN model and its test-mode forward.

Counterpart of ``mx_rcnn_tpu/models/faster_rcnn.py``: ``features``
(backbone), ``rpn_raw`` (RPN head), ``roi_head`` (per-ROI classifier and
regressor), ``anchors_for``, the full test forward images → features →
RPN → proposals (NMS kernel K1) → ROIAlign (kernel K2) → head →
(rois, roi_valid, cls_prob, bbox_deltas), and its two halves for the
alternate schedule: ``rpn_proposals`` (the RPN-only forward, K1) and
``detect_rois`` (the head on given proposals, K2).

Public layouts are the JAX package's: NHWC images in, NHWC features,
(N, R, ph, pw, C) pooled features.  Inside, the backbone runs NCHW views
of channels-last memory, so each boundary is a permute and not a copy.
Each conv and dense layer casts its weight to the activation dtype, as
flax does.  For serving the weights are stored in the compute dtype, so
the cast is free; for training they stay fp32 masters
(``build_model(train=True)``) and the optimizer updates those.  Frozen-BN
parameters and statistics stay fp32 either way.

``quant`` (``ops/quant.py — QuantSpec``, from ``cfg.quant``) quantizes the
backbone's convolutions and the head's trunk (``models/layers.py —
QuantConv2dSame/QuantDense``, whose weights stay fp32 and are quantized
once when the calibrated scales are loaded); the RPN head and
``cls_score``/``bbox_pred`` stay floating point, the PTQ recipe's
first/last-layer exemption.  ``quant=None`` is the unchanged fp model.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.models.layers import QUANT_LAYERS, Conv2dSame, Dense
from mx_rcnn_tpu_torch.models.resnet import ResNetBackbone, ResNetHead
from mx_rcnn_tpu_torch.models.rpn import RPNHead
from mx_rcnn_tpu_torch.models.tiny import TinyBackbone, TinyHead
from mx_rcnn_tpu_torch.models.vgg import VGGBackbone, VGGHead
from mx_rcnn_tpu_torch.obs.profiler import scope
from mx_rcnn_tpu_torch.ops.anchors import generate_shifted_anchors
from mx_rcnn_tpu_torch.ops.normalize import normalize_images
from mx_rcnn_tpu_torch.ops.proposal import propose_batch
from mx_rcnn_tpu_torch.ops.quant import QuantSpec, spec_from_config
from mx_rcnn_tpu_torch.ops.roi_pool import roi_align
from mx_rcnn_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FasterRCNN(nn.Module):
    """Backbone + RPN + RCNN head with the reference's hyperparameters."""

    def __init__(self, network: str = "resnet101", num_classes: int = 21,
                 anchor_scales: Tuple[int, ...] = (8, 16, 32),
                 anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0),
                 feat_stride: int = 16,
                 pooled_size: Tuple[int, int] = (14, 14),
                 test_pre_nms_top_n: int = 6000,
                 test_post_nms_top_n: int = 300,
                 test_nms_thresh: float = 0.7, test_min_size: int = 16,
                 pixel_means: Tuple[float, ...] = (123.68, 116.779, 103.939),
                 dtype: torch.dtype = torch.float32,
                 quant: Optional[QuantSpec] = None):
        super().__init__()
        self.network = network
        self.num_classes = num_classes
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_ratios = tuple(anchor_ratios)
        self.feat_stride = feat_stride
        self.pooled_size = tuple(pooled_size)
        self.test_pre_nms_top_n = test_pre_nms_top_n
        self.test_post_nms_top_n = test_post_nms_top_n
        self.test_nms_thresh = test_nms_thresh
        self.test_min_size = test_min_size
        self.pixel_means = tuple(pixel_means)
        self.dtype = dtype
        self.quant = quant
        if network == "vgg":
            self.backbone = VGGBackbone(dtype, quant)
            self.head = VGGHead(self.pooled_size, VGGBackbone.out_channels,
                                dtype, quant=quant)
        elif network in ("resnet50", "resnet101"):
            depth = int(network.replace("resnet", ""))
            self.backbone = ResNetBackbone(depth, dtype, quant)
            self.head = ResNetHead(depth, dtype, quant)
        elif network == "tiny":
            self.backbone = TinyBackbone(dtype, quant)
            self.head = TinyHead(self.pooled_size,
                                 TinyBackbone.out_channels, dtype, quant)
        else:
            raise ValueError(f"unknown network {network!r}")
        num_anchors = len(self.anchor_scales) * len(self.anchor_ratios)
        self.rpn = RPNHead(self.backbone.out_channels, num_anchors)
        head_c = self.head.out_channels
        self.cls_score = Dense(head_c, num_classes, init="normal:0.01")
        self.bbox_pred = Dense(head_c, 4 * num_classes, init="normal:0.001")
        self._anchors: Dict[Tuple, torch.Tensor] = {}

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """Random init mirroring the reference: he-normal convs, zero
        ``conv3``, Normal(0.01) RPN and cls, Normal(0.001) bbox."""
        for m in self.modules():
            if isinstance(m, (Conv2dSame, Dense)):
                m.init_(generator)

    def cast_compute_dtype(self) -> "FasterRCNN":
        """Store conv/dense weights in the compute dtype, channels-last.
        Quantized layers keep fp32 weights: they are quantized from the
        fp32 values, as the JAX package quantizes its fp32 params."""
        for m in self.modules():
            if isinstance(m, (Conv2dSame, Dense)) and \
                    not isinstance(m, QUANT_LAYERS):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(self.dtype)
        return self.channels_last_()

    def channels_last_(self) -> "FasterRCNN":
        """Lay conv weights out channels-last, like the activations."""
        for m in self.modules():
            if isinstance(m, Conv2dSame):
                m.weight.data = m.weight.data.contiguous(
                    memory_format=torch.channels_last)
        return self

    # ---- pieces -----------------------------------------------------------

    def features(self, images: torch.Tensor,
                 im_info: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, H, W, 3) RGB, fp32 mean-subtracted or raw uint8 →
        (N, H/16, W/16, C) NHWC features."""
        with scope("backbone"):
            images = normalize_images(images, im_info, self.pixel_means)
            x = images.contiguous().permute(0, 3, 1, 2)  # NCHW view
            return self.backbone(x).permute(0, 2, 3, 1).contiguous()

    def rpn_raw(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC feat → ((N, H*W*A, 2) cls logits, (N, H*W*A, 4) deltas)."""
        return self.rpn(feat.permute(0, 3, 1, 2))

    def roi_head(self, pooled: torch.Tensor,
                 dropout_uniforms: Tuple[torch.Tensor, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, ph, pw, C) pooled → ((R, classes) logits, (R, 4*classes)).
        ``dropout_uniforms``, in train mode: one (R, head.out_channels)
        uniform per site of ``head.dropout_sites``, in order; none (test
        mode) drops nothing."""
        if dropout_uniforms:
            if len(dropout_uniforms) != len(self.head.dropout_sites):
                raise ValueError(
                    f"{len(dropout_uniforms)} dropout uniforms for the "
                    f"head's sites {self.head.dropout_sites}")
            x = self.head(pooled, dropout_uniforms)
        else:
            x = self.head(pooled)
        return self.cls_score(x), self.bbox_pred(x)

    def anchors_for(self, feat_h: int, feat_w: int) -> torch.Tensor:
        """(H*W*A, 4) anchor grid for a feature shape, cached on device."""
        device = self.cls_score.weight.device
        key = (feat_h, feat_w, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(generate_shifted_anchors(
                feat_h, feat_w, self.feat_stride, self.anchor_ratios,
                self.anchor_scales)).to(device)
        return self._anchors[key]

    def _classify(self, feat: torch.Tensor, rois: torch.Tensor,
                  roi_valid: torch.Tensor, mark: Callable[[str], None]
                  ) -> Tuple[torch.Tensor, ...]:
        """ROIAlign (K2) → head → softmax: the test forward's second half."""
        n = feat.shape[0]
        with scope("roi_align"):
            pooled = roi_align(feat, rois, self.pooled_size,
                               1.0 / self.feat_stride)
        mark("roi_align")
        r = pooled.shape[1]
        with scope("head"):
            flat = pooled.reshape((n * r,) + pooled.shape[2:])
            cls_logits, deltas = self.roi_head(flat)
            cls_prob = torch.softmax(cls_logits.to(torch.float32), dim=-1)
            out = (rois, roi_valid,
                   cls_prob.reshape(n, r, self.num_classes),
                   deltas.to(torch.float32).reshape(
                       n, r, 4 * self.num_classes))
        mark("head")
        return out

    def rpn_proposals(self, images: torch.Tensor, im_info: torch.Tensor,
                      pre_nms_top_n: int = 6000, post_nms_top_n: int = 300
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The RPN-only forward (the alternate schedule's proposal dumps):
        images → (rois (N, post, 4), fg scores (N, post), valid (N, post)),
        at the test NMS threshold and minimum size (K1)."""
        feat = self.features(images, im_info)
        rpn_cls, rpn_box = self.rpn_raw(feat)
        anchors = self.anchors_for(*feat.shape[1:3])
        fg = torch.softmax(rpn_cls.to(torch.float32), dim=-1)[..., 1]
        return propose_batch(
            fg, rpn_box.to(torch.float32), anchors, im_info.to(torch.float32),
            pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
            nms_thresh=self.test_nms_thresh, min_size=self.test_min_size)

    def detect_rois(self, images: torch.Tensor, im_info: torch.Tensor,
                    rois: torch.Tensor, roi_valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
        """The RCNN-only test forward on precomputed proposals ``rois``
        (N, R, 4) in input coordinates with their mask ``roi_valid``: the
        RPN is skipped; returns what :meth:`forward` returns."""
        feat = self.features(images, im_info)
        return self._classify(feat, rois, roi_valid, lambda name: None)

    # ---- full test-mode forward ------------------------------------------

    def forward(self, images: torch.Tensor, im_info: torch.Tensor,
                stage_hook: Optional[Callable[[str], None]] = None
                ) -> Tuple[torch.Tensor, ...]:
        """Test forward for a batch.

        images (N, H, W, 3) mean-subtracted (or uint8) RGB in one bucket
        shape; im_info (N, 3) = (real_h, real_w, scale).  Returns rois
        (N, R, 4), roi_valid (N, R), cls_prob (N, R, classes) fp32 and
        bbox_deltas (N, R, 4*classes) fp32, R = test_post_nms_top_n.
        ``stage_hook(name)``, when given, is called as each stage ends
        (``backbone``, ``proposal``, ``roi_align``, ``head``) — the
        measurement scripts record CUDA events there.
        """
        mark = stage_hook or (lambda name: None)
        feat = self.features(images, im_info)
        mark("backbone")
        with scope("proposal"):
            rpn_cls, rpn_box = self.rpn_raw(feat)
            _, fh, fw, _ = feat.shape
            anchors = self.anchors_for(fh, fw)
            fg_scores = torch.softmax(rpn_cls.to(torch.float32),
                                      dim=-1)[..., 1]
            rois, _, roi_valid = propose_batch(
                fg_scores, rpn_box, anchors, im_info.to(torch.float32),
                pre_nms_top_n=self.test_pre_nms_top_n,
                post_nms_top_n=self.test_post_nms_top_n,
                nms_thresh=self.test_nms_thresh, min_size=self.test_min_size)
        mark("proposal")
        return self._classify(feat, rois, roi_valid, mark)


def build_model(cfg: Config, device="cuda", seed: Optional[int] = 0,
                train: bool = False, quant_phase: str = "apply"
                ) -> FasterRCNN:
    """The model for a Config, randomly initialised from ``seed`` (an
    explicit ``torch.Generator``; ``None`` leaves the weights for a
    checkpoint to fill), on ``device``.  CUDA is the default; without a
    card this raises unless ``device='cpu'``.

    ``train=False``: eval mode, weights stored in the compute dtype.
    ``train=True``: train mode, fp32 master weights that each op casts to
    the compute dtype.

    With ``cfg.quant.enabled`` (inference only) the model is the
    quantized one: ``quant_phase='apply'`` runs quantized once its scales
    are loaded (``core/tester.py — quant_predictor``), ``'calib'`` is the
    fp forward recording activation statistics (``calibrate_quant``).
    Quant disabled gives the unchanged fp model."""
    if cfg.quant.enabled and train:
        raise ValueError(
            "quant__enabled=true is inference-only — train with the fp "
            "config and enable quant at test/serve/export time")
    quant = (spec_from_config(cfg.quant, quant_phase)
             if cfg.quant.enabled else None)
    dev = resolve_device(device)
    model = FasterRCNN(
        network=cfg.network.name,
        num_classes=cfg.num_classes,
        anchor_scales=cfg.network.anchor_scales,
        anchor_ratios=cfg.network.anchor_ratios,
        feat_stride=cfg.network.rpn_feat_stride,
        pooled_size=cfg.network.rcnn_pooled_size,
        test_pre_nms_top_n=cfg.test.rpn_pre_nms_top_n,
        test_post_nms_top_n=cfg.test.rpn_post_nms_top_n,
        test_nms_thresh=cfg.test.rpn_nms_thresh,
        test_min_size=cfg.test.rpn_min_size,
        pixel_means=tuple(cfg.network.pixel_means),
        dtype=_DTYPES[cfg.network.compute_dtype],
        quant=quant,
    )
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(seed))
    if train:
        model.channels_last_()
    else:
        model.cast_compute_dtype()
    return model.to(dev).train(train)


def to_device_batch(images: np.ndarray, im_info: np.ndarray,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host batch → device tensors (pinned and non-blocking on CUDA)."""
    imgs = torch.from_numpy(np.ascontiguousarray(images))
    info = torch.from_numpy(np.ascontiguousarray(im_info, np.float32))
    if device.type == "cuda":
        imgs, info = imgs.pin_memory(), info.pin_memory()
    return (imgs.to(device, non_blocking=True),
            info.to(device, non_blocking=True))
