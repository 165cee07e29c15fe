"""Anchor generation.

Reference: ``rcnn/processing/generate_anchor.py — generate_anchors`` (the
py-faster-rcnn lineage enumeration: ratio-enumerated then scale-enumerated
windows around a base stride-16 box) and the shift-grid expansion inside
``rcnn/io/rpn.py — assign_anchor`` / ``rcnn/symbol/proposal.py``.

Anchors are pure constants for a given feature-grid shape, so they are
computed once in NumPy and cached on the device by the model.  This module
is the port's own copy of ``mx_rcnn_tpu/ops/anchors.py``, unchanged in
its arithmetic.

Layout convention (framework-wide): anchors are enumerated **row-major over
(H, W, A)** and flattened to ``(H*W*A, 4)``, matching the NHWC ``(..., A*k)``
channel layout of the RPN head outputs.  (The reference uses MXNet's NCHW
``(A, H, W)`` layout; we are free to differ because no reference checkpoints
are imported — consistency within this framework is what matters.)
Boxes are ``(x1, y1, x2, y2)`` inclusive corners, as in the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _whctrs(anchor: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Box (x1,y1,x2,y2) -> (width, height, x_center, y_center)."""
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws: np.ndarray, hs: np.ndarray, x_ctr: float, y_ctr: float) -> np.ndarray:
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def _ratio_enum(anchor: np.ndarray, ratios: np.ndarray) -> np.ndarray:
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor: np.ndarray, scales: np.ndarray) -> np.ndarray:
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = w * scales
    hs = h * scales
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def generate_anchors(
    base_size: int = 16,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    scales: Sequence[int] = (8, 16, 32),
) -> np.ndarray:
    """Generate the (A, 4) base anchor windows around a base_size cell.

    Matches the reference numerics exactly (rounded ratio enumeration about
    the [0, 0, 15, 15] window), e.g. the canonical first anchor for the
    defaults is ``[-84, -40, 99, 55]``.
    """
    # fp64 on purpose: host-side trace-time constants matching the
    # reference's Cython anchor enumeration bit-for-bit; cast to fp32 below
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base_anchor = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    ratio_anchors = _ratio_enum(base_anchor, ratios)
    anchors = np.vstack(
        [_scale_enum(ratio_anchors[i, :], scales) for i in range(ratio_anchors.shape[0])]
    )
    return anchors.astype(np.float32)


def generate_shifted_anchors(
    feat_height: int,
    feat_width: int,
    feat_stride: int = 16,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    scales: Sequence[int] = (8, 16, 32),
) -> np.ndarray:
    """All anchors over an (H, W) feature grid, flattened to (H*W*A, 4).

    Reference: the shift-grid block at the top of ``rcnn/io/rpn.py —
    assign_anchor`` (and duplicated inside ``rcnn/symbol/proposal.py``):
    base anchors are translated by ``feat_stride`` per grid cell.

    Enumeration order is row-major (y, x, a): index = (y * W + x) * A + a.
    """
    base = generate_anchors(base_size=feat_stride, ratios=ratios, scales=scales)
    a = base.shape[0]
    shift_x = np.arange(feat_width, dtype=np.float32) * feat_stride
    shift_y = np.arange(feat_height, dtype=np.float32) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)  # (H, W, 4)
    anchors = shifts[:, :, None, :] + base[None, None, :, :]  # (H, W, A, 4)
    return anchors.reshape(-1, 4).astype(np.float32)
