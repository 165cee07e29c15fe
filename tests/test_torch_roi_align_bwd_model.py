"""A numpy model of kernel K3, the ROIAlign backward
(``csrc/roi_align_bwd.cu``), held against the port's plain version and the
JAX gradients on the CPU.

The CUDA kernel runs only on the card.  This model repeats what it does, so
that a mistake in the design shows here:

- the tables kernel: per (image, ROI, bin of one axis) the bin's merged taps
  from K2's ``merged_row`` (modelled in ``test_torch_roi_align_taps.py``),
  padded to ``2*sr`` with ``(-1, 0)``, and the bin's first and last index;
- the ownership: one block per (image, feature row h, band of ``WB``
  feature columns, channel group), one thread per 16-byte channel vector
  (one channel where C is not a multiple of the vector), and every output
  element written by exactly one thread;
- the skip rules: a block's s-range for h is ``s0 = #{s : last(s) < h}``,
  ``s1 = #{s : first(s) <= h} - 1``, its t-range for the band the same
  with the band's first and last column, and a ROI with either range
  empty is skipped;
- the walk: ROI ascending, t ascending, s ascending within t.  ``row =
  fma(wy[s, h], g[r, s, t], row)``, then for each of bin t's taps inside
  the band ``acc[x] = fma(wx[t, x], row, acc[x])``, all in fp32;
- one rounding to g's dtype at the end.

The kernel lists the ROIs in chunks of 64, in order, so chunking changes
neither the order nor the sum; the cases here have fewer ROIs.  The fused
multiply-adds are taken in float64 and rounded to fp32, which is the
kernel's ``fmaf`` except where the float64 sum itself rounds: at the
tolerances below that never shows, and on the exact inputs of the bf16
case nothing rounds at all.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.roi_align_pallas import roi_align_pallas
from mx_rcnn_tpu.ops.roi_pool import roi_align as j_roi_align
from mx_rcnn_tpu_torch.ops import roi_pool as troi
from test_torch_roi_align_taps import (CASES, F32, GRID, H, SCALE, W,
                                       _case_id, merged_row, roi_case,
                                       roi_geometry)

torch.set_num_threads(1)

WB = 4                # kBand: feature columns a block owns
THREADS = 128         # kThreads: channel vectors per block, at most
VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels in 16 bytes


def fma(a, b, c):
    """fp32 ``fmaf(a, b, c)`` elementwise: the product is exact in float64."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def tables(rois, h, w, ph, pw, sr):
    """The tables kernel for one image's rois (R, 4): tap indices and
    weights (R, ph + pw, 2*sr), rows first, padded with (-1, 0), and the
    spans (R, ph + pw, 2), each bin's first and last index."""
    r, nt = len(rois), 2 * sr
    idx = np.full((r, ph + pw, nt), -1, np.int64)
    wts = np.zeros((r, ph + pw, nt), F32)
    span = np.zeros((r, ph + pw, 2), np.int64)
    for ri, roi in enumerate(rois):
        x1, y1, bin_w, bin_h = roi_geometry(roi, ph, pw)
        for b in range(ph + pw):
            taps = (merged_row(y1, bin_h, sr, b, h) if b < ph
                    else merged_row(x1, bin_w, sr, b - ph, w))
            for e, (i, wt) in enumerate(taps):
                idx[ri, b, e], wts[ri, b, e] = i, wt
            span[ri, b] = taps[0][0], taps[-1][0]
    return idx, wts, span


def ranges(span, ph, hrow, b0, b1):
    """Each ROI's s-range for feature row hrow and t-range for the band
    [b0, b1], as the block counts them from the spans."""
    s0 = (span[:, :ph, 1] < hrow).sum(1)
    s1 = (span[:, :ph, 0] <= hrow).sum(1) - 1
    t0 = (span[:, ph:, 1] < b0).sum(1)
    t1 = (span[:, ph:, 0] <= b1).sum(1) - 1
    return s0, s1, t0, t1


def block_list(idx, wts, span, ph, hrow, b0, b1):
    """One block's list: the ROIs that touch row hrow and the band, in
    ascending order, each with its ranges and wy[s, hrow] (0 where hrow
    falls between a bin's taps)."""
    s0, s1, t0, t1 = ranges(span, ph, hrow, b0, b1)
    out = []
    for r in np.nonzero((s0 <= s1) & (t0 <= t1))[0]:
        wy = {s: F32(wts[r, s][idx[r, s] == hrow].sum())
              for s in range(s0[r], s1[r] + 1)}
        out.append((r, s0[r], s1[r], t0[r], t1[r], wy))
    return out


def walk(g_img, idx, wts, hits, ph, b0, round_rows=None):
    """One block's walk over all its channels: the (WB, C) fp32
    accumulators and the loads per thread.  ``round_rows`` rounds each
    folded row to that dtype (a second rounding the kernel does not do)."""
    acc = np.zeros((WB, g_img.shape[-1]), F32)
    loads = 0
    for r, s0, s1, t0, t1, wy in hits:
        for t in range(t0, t1 + 1):
            row = np.zeros(g_img.shape[-1], F32)
            for s in range(s0, s1 + 1):
                row = fma(wy[s], g_img[r, s, t], row)
                loads += 1
            if round_rows is not None:
                row = torch.from_numpy(row).to(round_rows).float().numpy()
            for e in range(idx.shape[-1]):
                x = idx[r, ph + t, e] - b0
                if 0 <= x < WB:
                    acc[x] = fma(wts[r, ph + t, e], row, acc[x])
    return acc, loads


def k3_model(g, rois, feat_hw, sr, round_rows=None):
    """The kernel on g (N, R, ph, pw, C) fp32 or bf16 and rois (N, R, 4):
    dfeat (N, H, W, C) in g's dtype, and every block's loads per thread."""
    n, r, ph, pw, c = g.shape
    h, w = feat_hw
    v = VEC[g.dtype] if c % VEC[g.dtype] == 0 else 1
    vecs = -(-c // v)
    threads = THREADS if vecs >= THREADS else -(-vecs // 32) * 32
    groups = -(-vecs // threads)
    g32 = g.float().numpy()
    out = np.zeros((n, h, w, c), F32)
    owners = np.zeros((n, h, w, c), np.int64)
    loads = []
    for ni in range(n):
        idx, wts, span = tables(rois[ni], h, w, ph, pw, sr)
        for hrow in range(h):
            for b0 in range(0, w, WB):
                b1 = min(b0 + WB, w) - 1
                hits = block_list(idx, wts, span, ph, hrow, b0, b1)
                band, nl = walk(g32[ni], idx, wts, hits, ph, b0, round_rows)
                loads.append(nl)
                # each thread of each channel group stores its own vector
                for grp in range(groups):
                    for tid in range(threads):
                        ci = (grp * threads + tid) * v
                        if ci >= c:
                            continue
                        at = (ni, hrow, slice(b0, b1 + 1), slice(ci, ci + v))
                        owners[at] += 1
                        out[at] = band[:b1 - b0 + 1, ci:ci + v]
    assert (owners == 1).all()        # every element written exactly once
    return torch.from_numpy(out).to(g.dtype), np.array(loads)


@functools.lru_cache(maxsize=None)
def _jax_grads(size, sr):
    """jitted d/dfeat of sum(pooled * g) through the einsum roi_align and
    through roi_align_pallas in interpret mode."""
    def loss_ein(f, rois, g):
        p = jax.vmap(lambda fi, b: j_roi_align(fi, b, size, float(SCALE),
                                               sr))(f, rois)
        return jnp.sum(p * g)

    def loss_pal(f, rois, g):
        p = roi_align_pallas(f, rois, size, float(SCALE), sr, True)
        return jnp.sum(p * g)

    return jax.jit(jax.grad(loss_ein)), jax.jit(jax.grad(loss_pal))


@pytest.mark.parametrize("case", GRID, ids=[_case_id(p) for p in GRID])
def test_model_matches_plain_and_jax(case):
    """The model on the taps test's ROI kinds (W = 13, not a multiple of
    WB) against ``roi_align_bwd_plain`` and the JAX gradients of the einsum
    ``roi_align`` and of ``roi_align_pallas``: the same products summed in
    other orders, atol = rtol = 1e-5 in fp32.  g is normal with standard
    deviation 1/4: a cell at the border of a map smaller than the ROI sums
    ~100 terms, and at unit deviation the cancellation in those sums leaves
    the plain version and the JAX einsum ~2e-5 apart on results near 0."""
    name, size, sr = case
    rois = roi_case(name, seed=len(name) + size[0] + sr)
    c = 8
    g = np.random.RandomState(size[0] + sr).standard_normal(
        (2, rois.shape[1]) + size + (c,)).astype(F32) / 4
    got, _ = k3_model(torch.from_numpy(g), rois, (H, W), sr)
    plain = troi.roi_align_bwd_plain(torch.from_numpy(g),
                                     torch.from_numpy(rois), (H, W),
                                     float(SCALE), sr)
    feat = jnp.zeros((2, H, W, c), jnp.float32)
    ein, pal = _jax_grads(size, sr)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    for grad in (ein, pal):
        want = np.asarray(grad(feat, jnp.asarray(rois), jnp.asarray(g)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("sr", (1, 2, 4))
def test_spans_give_exactly_the_touching_bins(name, sr):
    """Every bin has a tap; the spans never decrease with the bin, so the
    counted ranges hold every bin that touches the row (band) and start
    and end on one.  A range with no such bin is empty, except where the
    row falls between one bin's taps (a bin wider than two cells): that
    bin then gets weight 0.  (On these cases no bin straddles a band
    without a tap in it, so the t-ranges are exact too.)"""
    rois = roi_case(name, seed=sr)
    for ph, pw in ((7, 7), (14, 14)):
        for img in range(rois.shape[0]):
            idx, wts, span = tables(rois[img], H, W, ph, pw, sr)
            assert (idx[..., 0] >= 0).all()
            assert (np.diff(span[:, :ph], axis=1) >= 0).all()
            assert (np.diff(span[:, ph:], axis=1) >= 0).all()
            assert (idx[..., 1:] == -1).sum() == (wts == 0).sum()
            for hrow in range(H):
                for b0 in range(0, W, WB):
                    b1 = min(b0 + WB, W) - 1
                    s0, s1, t0, t1 = ranges(span, ph, hrow, b0, b1)
                    for r in range(len(idx)):
                        rows = {s for s in range(ph) if hrow in idx[r, s]}
                        cols = {t for t in range(pw) if
                                ((idx[r, ph + t] >= b0)
                                 & (idx[r, ph + t] <= b1)).any()}
                        assert rows == set() or (
                            (min(rows), max(rows)) == (s0[r], s1[r]))
                        assert rows != set() or s0[r] > s1[r] or all(
                            s1[r] == s0[r] and hrow not in idx[r, s]
                            for s in range(s0[r], s1[r] + 1))
                        assert cols == set() or (
                            (min(cols), max(cols)) == (t0[r], t1[r]))
                        assert cols != set() or t0[r] > t1[r]


def _exact_case():
    """Inputs on which every fp32 product and sum is exact: rois whose
    sides are multiples of pw/4 feature cells and corners on the quarter
    cell (dyadic weights), g of small dyadic bf16 values."""
    rng = np.random.RandomState(3)
    ph = pw = 7
    n, r = 2, 6
    lo = rng.randint(-8, 4 * W, (n, r, 2)) / 4.0
    side = rng.randint(1, 12, (n, r, 2)) * pw / 4.0
    rois = (np.concatenate([lo, lo + side], -1) * 16).astype(F32)
    g = rng.randint(-64, 65, (n, r, ph, pw, 8)) / 16.0
    return torch.tensor(g, dtype=torch.bfloat16), rois


def test_bf16_is_rounded_once():
    """bf16 g on exact inputs: the model's fp32 sum equals the plain
    version's bit for bit whatever the order, and its one rounding equals
    ``roi_align_bwd_plain`` of the same bf16 g.  Rounding each folded row
    to bf16 as well, as the TPU kernel rounds its intermediate, does not."""
    g16, rois = _exact_case()
    got16, _ = k3_model(g16, rois, (H, W), 2)
    got32, _ = k3_model(g16.float(), rois, (H, W), 2)
    rois_t = torch.from_numpy(rois)
    plain16 = troi.roi_align_bwd_plain(g16, rois_t, (H, W), float(SCALE), 2)
    plain32 = troi.roi_align_bwd_plain(g16.float(), rois_t, (H, W),
                                       float(SCALE), 2)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got32, plain32, rtol=0, atol=0)
    torch.testing.assert_close(got16, plain16, rtol=0, atol=0)
    twice, _ = k3_model(g16, rois, (H, W), 2, round_rows=torch.bfloat16)
    assert not torch.equal(twice, plain16)


@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.float32, 13),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 13),
                                     (torch.float32, 1036)])
def test_channel_vectors_own_every_element_once(dtype, c):
    """16-byte vectors where C is a multiple of the vector, one channel per
    thread where it is not, several channel groups at C = 1036 (259
    vectors of 4 fp32, 3 groups of 128 threads): every output element has
    one owner (asserted inside the model), and the result is the plain
    version's."""
    rois = roi_case("crossing", seed=4)[:, :3]
    g = torch.from_numpy(np.random.RandomState(c).standard_normal(
        (2, 3, 7, 7, c)).astype(F32)).to(dtype)
    got, _ = k3_model(g, rois, (5, W), 2)
    want = troi.roi_align_bwd_plain(g.float(), torch.from_numpy(rois), (5, W),
                                    float(SCALE), 2)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -8, atol=1e-5)
    torch.testing.assert_close(got.float(), want, **tol)


def _smoke_rois(seed, wh):
    """The rois of chip_smoke.py's K3 phase (``roi_inputs(2, 128, seed)``:
    a 38x64x1024 feature draw first, then corners and sides)."""
    rng = np.random.RandomState(seed)
    rng.standard_normal((2, 38, 64, 1024))
    xy = rng.uniform(-8, [1024, 608], (2, 128, 2))
    sides = rng.uniform(wh[0], wh[1], (2, 128, 2))
    return np.concatenate([xy, xy + sides], -1).astype(F32)


@pytest.mark.parametrize("seed,wh,reads,busiest,mean", [
    (30, (0, 500), 2.97, 1021, 123),    # random rois, 0-500 px a side
    (23, (16, 64), 2.58, 672, 106),     # small rois
])
def test_loads_at_the_smoke_shape(seed, wh, reads, busiest, mean):
    """At the smoke's K3 shape (2 x 128 rois, 14 x 14, sr 2, a 38 x 64
    map) and WB = 4, the walk reads each g vector at most 3 times (2.97 on
    random rois), and its busiest block reads 1021 vectors per thread
    against a mean of 123: the numbers a change of WB moves (WB = 8: 2.57
    reads, 1474 and 212)."""
    rois = _smoke_rois(seed, wh)
    ph = pw = 14
    loads = []
    for img in range(2):
        _, _, span = tables(rois[img], 38, 64, ph, pw, 2)
        for hrow in range(38):
            for b0 in range(0, 64, WB):
                s0, s1, t0, t1 = ranges(span, ph, hrow, b0, b0 + WB - 1)
                hit = (s0 <= s1) & (t0 <= t1)
                loads.append(int(((s1 - s0 + 1) * (t1 - t0 + 1))[hit].sum()))
    per_element = sum(loads) / (2 * 128 * ph * pw)
    assert per_element <= 3
    assert round(per_element, 2) == reads
    assert max(loads) == busiest
    assert round(float(np.mean(loads))) == mean
