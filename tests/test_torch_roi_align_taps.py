"""A numpy model of kernel K2's merged taps and gather order
(``csrc/roi_align_fwd.cu``), held against the port's plain version and the
JAX package on the CPU.

The CUDA kernel runs only on the card.  This model repeats what each of its
blocks does, so that a mistake in the design shows here:

- the compact tables: for one bin of one axis, ``axis_tap`` per sample (the
  reference's formula, each step rounded once in fp32), the sample's
  ``(1 - frac)`` at ``lo`` and ``frac`` at ``hi`` added to the entry of
  their index in sample order (summed first where ``lo == hi``), a weight
  of exactly 0 making no entry, then each entry divided by ``sr``;
- the gather in two stages, in the TPU kernel's order: stage 1 contracts H
  for a feature column, ``col[x] = sum_i wy_i * feat[y_i, x, :]`` over row
  ``s``'s table, and stage 2 contracts W for a bin, ``out[s, t, :] =
  sum_j wx_j * col[x_j]``, accumulated in fp32.  The bins are walked in
  order and the stage-1 values of the two newest columns are kept, so each
  distinct column of a row is computed once.

Expanded to dense rows, the tables are the reference's interpolation
matrices bit for bit (``sr`` 1, 2 and 4 alike); the gathered output agrees
with ``roi_align_plain`` and the JAX ``roi_align`` to fp32 rounding.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ops.roi_pool import interp_matrices as j_interp_matrices
from mx_rcnn_tpu.ops.roi_pool import roi_align as j_roi_align
from mx_rcnn_tpu_torch.ops import roi_pool as troi

torch.set_num_threads(1)

CSRC = Path(troi.__file__).resolve().parents[1] / "csrc"
F32 = np.float32
H, W, C = 9, 13, 8           # feature map of the cases: 144 x 208 input px
SCALE = F32(1 / 16)


def axis_tap(start, bin_, sr, k, size):
    """The kernel's ``axis_tap``: sample k of one axis, in fp32."""
    step = F32(bin_) / F32(sr)
    pos = (F32(start) + (F32(k) + F32(0.5)) * step) - F32(0.5)
    pos = min(max(pos, F32(0.0)), F32(size - 1))
    lo = np.floor(pos)
    frac = pos - lo
    return int(lo), min(int(lo) + 1, size - 1), F32(1.0) - frac, frac


def merged_row(start, bin_, sr, b, size):
    """The kernel's ``merged_row``: the nonzeros of row b of one axis's
    interpolation matrix as [(index, weight)], in the order built."""
    taps = []

    def add(idx, w):
        if w == F32(0.0):
            return
        for e in range(len(taps) - 1, -1, -1):
            if taps[e][0] < idx:
                break
            if taps[e][0] == idx:
                taps[e][1] = taps[e][1] + w
                return
        taps.append([idx, w])

    for a in range(sr):
        lo, hi, wlo, whi = axis_tap(start, bin_, sr, b * sr + a, size)
        if lo == hi:
            add(lo, wlo + whi)
        else:
            add(lo, wlo)
            add(hi, whi)
    return [(i, w / F32(sr)) for i, w in taps]


def roi_geometry(roi, ph, pw):
    """A block's ROI arithmetic: (x1, y1, bin_w, bin_h) in fp32."""
    x1, y1, x2, y2 = (F32(v) * SCALE for v in roi)
    bin_w = max(x2 - x1, F32(1.0)) / F32(pw)
    bin_h = max(y2 - y1, F32(1.0)) / F32(ph)
    return x1, y1, bin_w, bin_h


def tables(rois, ph, pw, sr):
    """Every block's tables for rois (R, 4): per ROI, ph row tables and pw
    column tables."""
    out = []
    for roi in rois:
        x1, y1, bin_w, bin_h = roi_geometry(roi, ph, pw)
        out.append(([merged_row(y1, bin_h, sr, s, H) for s in range(ph)],
                    [merged_row(x1, bin_w, sr, t, W) for t in range(pw)]))
    return out


def dense(rows, size):
    m = np.zeros((len(rows), size), F32)
    for b, taps in enumerate(rows):
        for idx, w in taps:
            m[b, idx] = w
    return m


def gather(feat, tabs, ph, pw):
    """The kernel's gather in its order, feat (H, W, C) → (R, ph, pw, C),
    and the number of stage-1 column computations per row.

    Stage 1 contracts H for a column, stage 2 contracts W for a bin; the
    stage-1 values of the two newest columns are kept, as the kernel keeps
    them in registers."""
    out = np.zeros((len(tabs), ph, pw, feat.shape[-1]), F32)
    computed = []
    for ri, (ty, tx) in enumerate(tabs):
        for s in range(ph):
            def column(x):
                v = np.zeros(feat.shape[-1], F32)
                for yi, wy in ty[s]:
                    v = v + wy * feat[yi, x]
                return v

            newest, prev, col_n, has_prev, n = None, None, -1, False, 0
            for t in range(pw):
                acc = np.zeros(feat.shape[-1], F32)
                for x, wx in tx[t]:
                    if x == col_n:
                        acc = acc + wx * newest
                    elif has_prev and x == col_n - 1:
                        acc = acc + wx * prev
                    else:
                        v = column(x)
                        n += 1
                        acc = acc + wx * v
                        if x > col_n:
                            has_prev = col_n >= 0 and x == col_n + 1
                            prev, newest, col_n = newest, v, x
                out[ri, s, t] = acc
            computed.append((n, len({x for taps in tx for x, _ in taps})))
    return out, computed


def roi_case(name, seed, r=6):
    """(2, r, 4) rois of one kind on the 144 x 208 input canvas."""
    rng = np.random.RandomState(seed)
    ih, iw = 16 * H, 16 * W
    xy = rng.uniform(0, [iw - 100, ih - 100], (2, r, 2))
    wh = rng.uniform(16, 100, (2, r, 2))
    if name == "inside":
        rois = np.concatenate([xy, xy + wh], -1)
    elif name == "crossing":        # across each border in turn, and beyond
        rois = np.concatenate([xy, xy + wh], -1)
        rois[:, 0, 0] = -30.0
        rois[:, 1, 1] = -45.0
        rois[:, 2, 2] = iw + 25.0
        rois[:, 3, 3] = ih + 60.0
        rois[:, 4] = [iw + 10, ih + 5, iw + 90, ih + 70]   # wholly outside
        rois[:, 5] = [-90, -80, -20, -10]
    elif name == "larger":          # larger than the map
        lo = -rng.uniform(10, 200, (2, r, 2))
        hi = np.array([iw, ih]) + rng.uniform(10, 300, (2, r, 2))
        rois = np.concatenate([lo, hi], -1)
    elif name == "degenerate":      # x2 < x1, y2 < y1, zero size
        rois = np.concatenate([xy + wh, xy], -1)
        rois[:, 0] = [50, 50, 50, 50]
        rois[:, 1] = [0, 0, 0, 0]
        rois[:, 2] = [iw, ih, iw, ih]
        rois[:, 3, 2] = rois[:, 3, 0]
    elif name == "subcell":         # smaller than one feature cell
        rois = np.concatenate([xy, xy + rng.uniform(0.5, 15, (2, r, 2))], -1)
    else:
        raise ValueError(name)
    return rois.astype(F32)


CASES = ("inside", "crossing", "larger", "degenerate", "subcell")
GRID = [(name, size, sr) for name in CASES for size in ((7, 7), (14, 14))
        for sr in (1, 2, 4)]


def _case_id(p):
    return f"{p[0]}-{p[1][0]}x{p[1][1]}-sr{p[2]}"


@pytest.mark.parametrize("case", GRID, ids=[_case_id(p) for p in GRID])
def test_tables_are_the_reference_matrices(case):
    """Each table holds at most 2*sr distinct taps, and expanded to dense
    rows equals the port's and the JAX ``interp_matrices`` bit for bit in
    fp32, at sr 1, 2 and 4 alike (the reference's mean sums its sr
    samples in order, as the table's entries do, and divides by sr)."""
    name, (ph, pw), sr = case
    rois = roi_case(name, seed=len(name) + ph + sr)
    for img in range(rois.shape[0]):
        tabs = tables(rois[img], ph, pw, sr)
        for ty, tx in tabs:
            for taps in ty + tx:
                idx = [i for i, _ in taps]
                assert 1 <= len(taps) <= 2 * sr
                assert idx == sorted(set(idx))
        wy = np.stack([dense(ty, H) for ty, _ in tabs])
        wx = np.stack([dense(tx, W) for _, tx in tabs])
        t_wy, t_wx = troi.interp_matrices(torch.from_numpy(rois[img]), ph, pw,
                                          H, W, float(SCALE), sr)
        j_wy, j_wx = j_interp_matrices(jnp.asarray(rois[img]), ph, pw, H, W,
                                       float(SCALE), sr)
        np.testing.assert_array_equal(wy, t_wy.numpy())
        np.testing.assert_array_equal(wx, t_wx.numpy())
        np.testing.assert_array_equal(wy, np.asarray(j_wy))
        np.testing.assert_array_equal(wx, np.asarray(j_wx))


@pytest.mark.parametrize("case", GRID, ids=[_case_id(p) for p in GRID])
def test_gather_matches_plain_and_jax(case):
    """The two-stage gather over the tables in the kernel's order, which
    computes each distinct column of a row once, against
    ``roi_align_plain`` and the JAX ``roi_align`` (fp32 'highest'): the
    three sum the same products in other orders, so they agree to fp32
    rounding, atol = rtol = 1e-5 on standard-normal features."""
    name, size, sr = case
    rois = roi_case(name, seed=len(name) + size[0] + sr)
    feat = np.random.RandomState(sr).standard_normal((2, H, W, C)).astype(F32)
    got, computed = [], []
    for i in range(2):
        out, n = gather(feat[i], tables(rois[i], *size, sr), *size)
        got.append(out)
        computed.extend(n)
    got = np.stack(got)
    # each distinct column of a row goes through stage 1 exactly once
    assert all(n == distinct for n, distinct in computed)
    plain = troi.roi_align_plain(torch.from_numpy(feat),
                                 torch.from_numpy(rois), size, float(SCALE),
                                 sr).numpy()
    jax_out = np.stack([np.asarray(j_roi_align(
        jnp.asarray(feat[i]), jnp.asarray(rois[i]), size, float(SCALE), sr))
        for i in range(2)])
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-5)


def _axis_tap_text(source: str) -> str:
    text = (CSRC / source).read_text()
    m = re.search(r"^__device__ __forceinline__ Tap axis_tap\(.*?^}\n", text,
                  re.S | re.M)
    assert m, f"axis_tap not found in {source}"
    return m.group(0)


def test_axis_tap_same_in_forward_and_backward():
    """K2 and K3 must agree on every sample's tap: ``axis_tap`` is the
    same text in both sources."""
    assert _axis_tap_text("roi_align_fwd.cu") == \
        _axis_tap_text("roi_align_bwd.cu")


def _template_text(source: str, head: str) -> str:
    """The definition in ``source`` that starts with ``template
    <typename Index>`` and then the line ``head``, up to its closing
    brace at the start of a line."""
    text = (CSRC / source).read_text()
    m = re.search(r"^template <typename Index>\n" + re.escape(head)
                  + r".*?^}.*?\n", text, re.S | re.M)
    assert m, f"{head!r} not found in {source}"
    return m.group(0)


@pytest.mark.parametrize("head", [
    "struct WTap {",
    "__device__ __forceinline__ void add_tap(",
    "__device__ int merged_row(",
], ids=["WTap", "add_tap", "merged_row"])
def test_merged_row_same_in_forward_and_backward(head):
    """K2 and K3 must agree on every weight: the merged taps (``WTap``,
    ``add_tap`` and ``merged_row``, which K3's tables kernel calls) are
    the same text in both sources."""
    assert _template_text("roi_align_fwd.cu", head) == \
        _template_text("roi_align_bwd.cu", head)


def test_loads_per_output_at_the_smoke_shapes():
    """At the ROI sizes of the main paths (16-512 px on a side at stride
    16, 14 x 14 bins, sr 2) a bin has at most 16 distinct taps and on
    average well under the 16 sample taps of an unmerged gather, and the
    column stage loads fewer still: each distinct column of a row once."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(-8, [1024, 608], (64, 2))
    wh = rng.uniform(16, 512, (64, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(F32)
    taps, loads = [], 0
    for roi in rois:
        x1, y1, bin_w, bin_h = roi_geometry(roi, 14, 14)
        ny = [len(merged_row(y1, bin_h, 2, s, 38)) for s in range(14)]
        tx = [merged_row(x1, bin_w, 2, t, 64) for t in range(14)]
        taps.extend(a * len(b) for a in ny for b in tx)
        loads += sum(ny) * len({x for row in tx for x, _ in row})
    assert max(taps) <= 16
    assert np.mean(taps) < 10
    assert loads / len(taps) < 0.6 * np.mean(taps)
    # a roi covering the whole 38 x 64 map has no column to share: its
    # 14 rows read 2576 taps, 13.1 per output element, as many as its
    # bins' distinct taps
    x1, y1, bin_w, bin_h = roi_geometry(np.array([0, 0, 1024, 608], F32),
                                        14, 14)
    ny = sum(len(merged_row(y1, bin_h, 2, s, 38)) for s in range(14))
    tx = [merged_row(x1, bin_w, 2, t, 64) for t in range(14)]
    assert ny * len({x for row in tx for x, _ in row}) == 2576
    assert ny * sum(len(row) for row in tx) == 2576
