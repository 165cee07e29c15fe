"""ROIAlign over NHWC feature maps.

Counterpart of ``mx_rcnn_tpu/ops/roi_pool.py``.  The bilinear weights are
the repo's own (not torchvision's): sample positions clipped into
``[0, size - 1]``, ``hi = min(lo + 1, size - 1)``, ROI extent
``max(·, 1)`` at feature scale, pixel centres at integer coordinates
(the −0.5 offset), and the sr×sr sample mean folded into per-axis
interpolation matrices:

    pooled[n, r, s, t, c] = Σ_h Σ_w wy[n, r, s, h] · feat[n, h, w, c] · wx[n, r, t, w]

:func:`roi_align_plain` computes that as the reference's einsum pair and is
the plain version of kernel K2 (``csrc/roi_align_fwd.cu``), which computes
the same sum as a gather.  :func:`roi_align_bwd_plain` is the plain version
of kernel K3 (``csrc/roi_align_bwd.cu``), the feature gradient

    dfeat[n, h, w, c] = Σ_r Σ_s Σ_t wy[n, r, s, h] · g[n, r, s, t, c] · wx[n, r, t, w]

:func:`roi_align` (the forward, for serving) and :func:`roi_align_batched`
(differentiable, for training) dispatch: the kernels for a CUDA tensor,
the plain versions for a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch.kernels import ROI_ALIGN_BWD, ROI_ALIGN_FWD


def _interp_matrix(starts: torch.Tensor, bin_sizes: torch.Tensor,
                   num_bins: int, sampling_ratio: int, size: int
                   ) -> torch.Tensor:
    """Pooled bilinear sampling matrices (R, num_bins, size) for one axis;
    starts/bin_sizes are (R,)."""
    s = num_bins * sampling_ratio
    k = torch.arange(s, dtype=torch.float32, device=starts.device)
    pos = starts[:, None] + (k + 0.5) * (bin_sizes[:, None] / sampling_ratio) - 0.5
    pos = pos.clamp(0.0, size - 1.0)
    lo = torch.floor(pos)
    frac = pos - lo
    lo_i = lo.to(torch.int64)
    hi_i = (lo_i + 1).clamp_max(size - 1)
    m = F.one_hot(lo_i, size).to(torch.float32) * (1.0 - frac)[..., None]
    m = m + F.one_hot(hi_i, size).to(torch.float32) * frac[..., None]
    return m.reshape(-1, num_bins, sampling_ratio, size).mean(dim=2)


def interp_matrices(rois: torch.Tensor, ph: int, pw: int, h: int, w: int,
                    spatial_scale: float, sampling_ratio: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ROI (wy (R, ph, H), wx (R, pw, W)) fp32 interpolation matrices
    for rois (R, 4) in input coordinates."""
    x1 = rois[:, 0].to(torch.float32) * spatial_scale
    y1 = rois[:, 1].to(torch.float32) * spatial_scale
    x2 = rois[:, 2].to(torch.float32) * spatial_scale
    y2 = rois[:, 3].to(torch.float32) * spatial_scale
    roi_w = (x2 - x1).clamp_min(1.0)
    roi_h = (y2 - y1).clamp_min(1.0)
    wy = _interp_matrix(y1, roi_h / ph, ph, sampling_ratio, h)
    wx = _interp_matrix(x1, roi_w / pw, pw, sampling_ratio, w)
    return wy, wx


def roi_align_plain(features: torch.Tensor, rois: torch.Tensor,
                    output_size: Tuple[int, int] = (14, 14),
                    spatial_scale: float = 1.0 / 16.0,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """The plain version of K2: features (N, H, W, C), rois (N, R, 4) →
    (N, R, ph, pw, C) in the feature dtype, as the reference's einsum pair
    (the cheaper contraction first: ``rows_first = ph*w <= h*pw``)."""
    ph, pw = output_size
    n, h, w, _ = features.shape
    r = rois.shape[1]
    dtype = features.dtype
    wy, wx = interp_matrices(rois.reshape(-1, 4), ph, pw, h, w,
                             spatial_scale, sampling_ratio)
    wy = wy.reshape(n, r, ph, h).to(dtype)
    wx = wx.reshape(n, r, pw, w).to(dtype)
    if ph * w <= h * pw:
        rows = torch.einsum("nrsh,nhwc->nrswc", wy, features)
        pooled = torch.einsum("nrswc,nrtw->nrstc", rows, wx)
    else:
        cols = torch.einsum("nhwc,nrtw->nrhtc", features, wx)
        pooled = torch.einsum("nrhtc,nrsh->nrstc", cols, wy)
    return pooled.to(dtype)


def roi_align_cuda(features: torch.Tensor, rois: torch.Tensor,
                   output_size: Tuple[int, int] = (14, 14),
                   spatial_scale: float = 1.0 / 16.0,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """Kernel K2 on the card; same contract as :func:`roi_align_plain`."""
    if not (features.is_cuda and rois.device == features.device):
        raise ValueError("roi_align_cuda needs CUDA tensors on one device")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be fp32 or bf16, got {features.dtype}")
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4 or \
            rois.shape[0] != features.shape[0]:
        raise ValueError(f"bad shapes features {tuple(features.shape)} rois "
                         f"{tuple(rois.shape)}")
    ph, pw = output_size
    n, h, w, c = features.shape
    r = rois.shape[1]
    if r > 65535 or n > 65535:
        raise ValueError(f"{n} images x {r} rois exceed the kernel's grid")
    features = features.contiguous()
    rois = rois.to(torch.float32).contiguous()
    out = torch.empty((n, r, ph, pw, c), dtype=features.dtype,
                      device=features.device)
    # the launch goes to the current device: make it the tensors' card
    with torch.cuda.device(features.device):
        ROI_ALIGN_FWD.launch(
            features.data_ptr(), rois.data_ptr(), out.data_ptr(),
            int(features.dtype == torch.bfloat16), n, r, h, w, c, ph, pw,
            sampling_ratio, float(spatial_scale),
            torch.cuda.current_stream(features.device).cuda_stream)
    return out


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              output_size: Tuple[int, int] = (14, 14),
              spatial_scale: float = 1.0 / 16.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """Batched ROIAlign: K2 for a CUDA tensor, the plain version for a
    CPU tensor."""
    if features.is_cuda:
        return roi_align_cuda(features, rois, output_size, spatial_scale,
                              sampling_ratio)
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, output_size, spatial_scale,
                               sampling_ratio)
    raise ValueError(f"unsupported device {features.device}")


def roi_align_bwd_plain(g: torch.Tensor, rois: torch.Tensor,
                        feat_hw: Tuple[int, int],
                        spatial_scale: float = 1.0 / 16.0,
                        sampling_ratio: int = 2) -> torch.Tensor:
    """The plain version of K3: g (N, R, ph, pw, C), rois (N, R, 4) →
    dfeat (N, H, W, C), summed in fp32 and cast once to ``g.dtype``
    (the smaller intermediate first)."""
    n, r, ph, pw, _ = g.shape
    h, w = feat_hw
    wy, wx = interp_matrices(rois.reshape(-1, 4), ph, pw, h, w,
                             spatial_scale, sampling_ratio)
    wy = wy.reshape(n, r, ph, h)
    wx = wx.reshape(n, r, pw, w)
    g32 = g.to(torch.float32)
    if ph * w <= h * pw:
        rows = torch.einsum("nrstc,nrtw->nrswc", g32, wx)
        dfeat = torch.einsum("nrsh,nrswc->nhwc", wy, rows)
    else:
        cols = torch.einsum("nrstc,nrsh->nrhtc", g32, wy)
        dfeat = torch.einsum("nrtw,nrhtc->nhwc", wx, cols)
    return dfeat.to(g.dtype)


def roi_align_bwd_cuda(g: torch.Tensor, rois: torch.Tensor,
                       feat_hw: Tuple[int, int],
                       spatial_scale: float = 1.0 / 16.0,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """Kernel K3 on the card; same contract as :func:`roi_align_bwd_plain`."""
    if not (g.is_cuda and rois.device == g.device):
        raise ValueError("roi_align_bwd_cuda needs CUDA tensors on one device")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be fp32 or bf16, got {g.dtype}")
    if g.dim() != 5 or rois.dim() != 3 or rois.shape[-1] != 4 or \
            tuple(rois.shape[:2]) != tuple(g.shape[:2]):
        raise ValueError(f"bad shapes g {tuple(g.shape)} rois "
                         f"{tuple(rois.shape)}")
    n, r, ph, pw, c = g.shape
    h, w = feat_hw
    if n > 65535 or h > 32767 or w > 32767:
        raise ValueError(f"{n} images of {h} x {w} exceed the kernel's "
                         f"limits")
    g = g.contiguous()
    rois = rois.to(torch.float32).contiguous()
    dfeat = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
    scratch = torch.empty(_bwd_scratch_bytes(n * r, ph, pw, sampling_ratio),
                          dtype=torch.uint8, device=g.device)
    with torch.cuda.device(g.device):
        ROI_ALIGN_BWD.launch(
            g.data_ptr(), rois.data_ptr(), dfeat.data_ptr(),
            scratch.data_ptr(), scratch.numel(),
            int(g.dtype == torch.bfloat16), n, r, h, w, c, ph, pw,
            sampling_ratio, float(spatial_scale),
            torch.cuda.current_stream(g.device).cuda_stream)
    return dfeat


def _bwd_scratch_bytes(rois: int, ph: int, pw: int, sampling_ratio: int
                       ) -> int:
    """K3's tables (``csrc/roi_align_bwd.cu — scratch_bytes``): per ROI and
    bin of either axis, 2*sr (index, weight) pairs of 8 bytes and the bin's
    first and last index in 4."""
    return rois * (ph + pw) * (2 * sampling_ratio * 8 + 4)


class _RoIAlignFunction(torch.autograd.Function):
    """K2 forward, K3 backward."""

    @staticmethod
    def forward(ctx, features, rois, output_size, spatial_scale,
                sampling_ratio):
        ctx.save_for_backward(rois)
        ctx.geometry = (tuple(features.shape[1:3]), spatial_scale,
                        sampling_ratio)
        return roi_align_cuda(features, rois, output_size, spatial_scale,
                              sampling_ratio)

    @staticmethod
    def backward(ctx, g):
        (rois,) = ctx.saved_tensors
        feat_hw, spatial_scale, sampling_ratio = ctx.geometry
        dfeat = roi_align_bwd_cuda(g, rois, feat_hw, spatial_scale,
                                   sampling_ratio)
        # rois are data and get no gradient.  The JAX custom VJP returns an
        # explicit zeros cotangent for them; autograd takes None as "no
        # gradient" and never builds one.
        return dfeat, None, None, None, None


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor,
                      output_size: Tuple[int, int] = (14, 14),
                      spatial_scale: float = 1.0 / 16.0,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """Differentiable batched ROIAlign, features (N, H, W, C), rois
    (N, R, 4) → (N, R, ph, pw, C).  A CUDA tensor runs K2 forward and K3
    backward; a CPU tensor runs the einsum pair under plain autograd."""
    if features.is_cuda:
        return _RoIAlignFunction.apply(features, rois.detach(), output_size,
                                       spatial_scale, sampling_ratio)
    if features.device.type == "cpu":
        return roi_align_plain(features, rois.detach(), output_size,
                               spatial_scale, sampling_ratio)
    raise ValueError(f"unsupported device {features.device}")
