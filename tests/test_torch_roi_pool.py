"""The port's ``roi_pool`` against the JAX package's, exactly.

``mx_rcnn_tpu_torch/ops/roi_pool.py — roi_pool`` is the reference-parity
quantized max pooling (``floor(x*scale + 0.5)`` corners, bin edges
``floor(p·rh/ph)`` / ``ceil((p+1)·rh/ph)``, 0 for an empty bin).  On
seeded inputs it must equal ``mx_rcnn_tpu/ops/roi_pool.py — roi_pool``
bit for bit in fp32 and in bf16 (a max of bf16 values is exact): ROIs
on half-integer feature corners, ROIs reaching past the map or lying
wholly outside it, degenerate ROIs, bins that overlap (an ROI smaller
than the grid) and bins left empty by the clip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from mx_rcnn_tpu_torch.ops.roi_pool import roi_pool


def _rois(rng, h, w, scale):
    """Image-coordinate ROIs of every kind above."""
    hw, ww = h / scale, w / scale
    rand = np.sort(rng.uniform(-20, max(hw, ww) + 20, (12, 2, 2)), axis=1)
    rand = rand.transpose(0, 2, 1).reshape(12, 4)[:, [0, 2, 1, 3]]
    half = (rng.randint(0, 6, (6, 4)) + 0.5) / scale   # x.5 at feature scale
    half[:, 2:] += half[:, :2] + 2 / scale
    fixed = np.array([
        [0, 0, ww - 1, hw - 1],            # the whole image
        [ww - 30, hw - 30, ww + 200, hw + 200],  # past the map
        [ww + 50, hw + 50, ww + 90, hw + 90],     # wholly outside
        [-90, -90, -40, -40],              # wholly outside, negative
        [10, 10, 10, 10],                  # a point
        [40, 20, 20, 40],                  # inverted: width floored at 1
        [8, 8, 24, 24],                    # smaller than the grid: overlap
    ], np.float64)
    return np.concatenate([rand, half, fixed]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size,scale,out", [
    ((9, 11, 5), 1.0 / 16.0, (7, 7)),
    ((14, 6, 3), 1.0 / 16.0, (3, 5)),
    ((5, 5, 4), 1.0 / 8.0, (7, 7)),
    ((20, 13, 2), 1.0, (2, 2)),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_roi_pool_equals_jax(dtype, size, scale, out, seed):
    rng = np.random.RandomState(seed + 10 * size[0])
    h, w, c = size
    feat = rng.randn(h, w, c).astype(np.float32) * 3
    feat[0, 0] = -1e30   # very negative values are not "empty"
    rois = _rois(rng, h, w, scale)
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    got = roi_pool(tfeat, torch.from_numpy(rois), out, scale)
    want = np.asarray(jax_roi_pool(
        jnp.asarray(feat).astype(dtype), jnp.asarray(rois), out,
        scale).astype(jnp.float32))
    assert got.dtype == tfeat.dtype
    assert tuple(got.shape) == (len(rois),) + tuple(out) + (c,)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    # the outside ROIs pool only empty bins
    assert (want[-4] == 0).all() and (want[-5] == 0).all()


def test_roi_pool_rounds_half_away_from_zero():
    """A corner on x.5 at feature scale rounds up (C's round), where
    torch.round would go to the even neighbour."""
    feat = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1).repeat(
        1, 1, 1)
    rois = torch.tensor([[2.5 * 16, 0, 2.5 * 16, 0]])
    got = roi_pool(feat, rois, (1, 1))
    assert got.item() == 3.0   # column floor(2.5 + 0.5) = 3
    want = np.asarray(jax_roi_pool(jnp.asarray(feat.numpy()),
                                   jnp.asarray(rois.numpy()), (1, 1)))
    assert want.item() == 3.0
