"""Host-side box and COCO RLE mask ops, in NumPy.

Counterpart of ``mx_rcnn_tpu/native/__init__.py``.  The JAX package
builds these as a C++ library (``native/src/maskapi.cc``, ``nms.cc``)
and falls back to NumPy when no compiler is at hand; the port carries
the NumPy path alone, so :func:`backend` answers ``"numpy"``.  Nothing
here runs on the card: the per-class NMS of the eval and serving
postprocess is kernel K1 (``ops/nms.py``), and these functions serve the
host paths, the COCO segmentation evaluator above all.

* boxes: :func:`bbox_overlaps` (the +1-pixel IoU matrix) and
  :func:`cpu_nms` (greedy NMS, ties to the higher index first);
* masks in the pycocotools wire format, ``{"size": [h, w], "counts":
  bytes}`` with compressed column-major counts: :func:`encode`,
  :func:`decode`, :func:`area`, :func:`to_bbox`, :func:`iou`,
  :func:`iou_matrix`, :func:`merge`, :func:`from_poly`,
  :func:`from_uncompressed`, :func:`from_bbox`, and the counts codec
  (``_string_to_counts``, ``_counts_to_string``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def backend() -> str:
    """The active backend: always NumPy in the port."""
    return "numpy"


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


# ---- boxes (ref rcnn/cython) -------------------------------------------------


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(n, 4) x (k, 4) → (n, k) IoU matrix with +1-pixel areas (ref
    ``bbox_overlaps_cython``)."""
    boxes, query = _f32(boxes).reshape(-1, 4), _f32(query).reshape(-1, 4)
    bw = boxes[:, 2] - boxes[:, 0] + 1
    bh = boxes[:, 3] - boxes[:, 1] + 1
    qw = query[:, 2] - query[:, 0] + 1
    qh = query[:, 3] - query[:, 1] + 1
    iw = np.clip(
        np.minimum(boxes[:, None, 2], query[None, :, 2])
        - np.maximum(boxes[:, None, 0], query[None, :, 0]) + 1, 0, None)
    ih = np.clip(
        np.minimum(boxes[:, None, 3], query[None, :, 3])
        - np.maximum(boxes[:, None, 1], query[None, :, 1]) + 1, 0, None)
    inter = iw * ih
    union = (bw * bh)[:, None] + (qw * qh)[None, :] - inter
    return np.where(inter > 0, inter / np.maximum(union, 1e-12), 0.0
                    ).astype(np.float32)


def cpu_nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS over (n, 5) [x1 y1 x2 y2 score]; the kept indices in
    descending-score order (ref ``cpu_nms.pyx``).  Among equal scores the
    higher original index comes first, as the reference's
    ``scores.argsort()[::-1]`` orders them (a stable sort here)."""
    dets = _f32(dets).reshape(-1, 5)
    order = dets[:, 4].argsort(kind="stable")[::-1]
    sorted_dets = np.ascontiguousarray(dets[order])
    n = len(sorted_dets)
    if n == 0:
        return np.zeros((0,), np.int64)
    keep = []
    suppressed = np.zeros(n, bool)
    boxes = sorted_dets[:, :4]
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        rest = np.arange(i + 1, n)
        rest = rest[~suppressed[i + 1:]]
        if len(rest) == 0:
            continue
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = (np.clip(xx2 - xx1 + 1, 0, None)
                 * np.clip(yy2 - yy1 + 1, 0, None))
        iou_ = inter / (areas[i] + areas[rest] - inter)
        suppressed[rest[iou_ > thresh]] = True
    return order[np.asarray(keep, np.int64)]


# ---- RLE masks (ref rcnn/pycocotools/maskApi.c) -------------------------------


def _counts_of(rle: Dict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return _string_to_counts(c if isinstance(c, bytes) else c.encode())
    return np.ascontiguousarray(c, dtype=np.uint32)


def _string_to_counts(s: bytes) -> np.ndarray:
    """COCO's compressed counts string → run lengths: 5-bit chunks offset
    by 48, a continuation bit, a sign bit, each run from index 3 on
    delta-coded against the run two before it."""
    counts, x, k = [], 0, 0
    for ch in s:
        c = ch - 48
        x |= (c & 0x1F) << (5 * k)
        k += 1
        if not (c & 0x20):
            if c & 0x10:
                x -= 1 << (5 * k)
            if len(counts) > 2:
                x += counts[-2]
            counts.append(x)
            x, k = 0, 0
    return np.asarray(counts, np.uint32)


def _counts_to_string(counts: np.ndarray) -> bytes:
    """The inverse of :func:`_string_to_counts`."""
    out = bytearray()
    lst = [int(v) for v in np.ascontiguousarray(counts, np.uint32)]
    for i, v in enumerate(lst):
        x = v - (lst[i - 2] if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _runs(v: np.ndarray) -> np.ndarray:
    """Run lengths of a flat 0/1 vector, starting with a run of zeros
    (of length 0 when ``v`` starts with a one)."""
    change = np.flatnonzero(np.diff(v.astype(np.int8))) + 1
    edges = np.concatenate([[0], change, [len(v)]])
    counts = np.diff(edges).astype(np.uint32)
    if v.size and v[0]:
        counts = np.concatenate([[np.uint32(0)], counts])
    return counts


def encode(mask: np.ndarray) -> Dict:
    """Binary (h, w) mask → RLE dict (compressed counts)."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be (h, w), got {mask.shape}")
    h, w = mask.shape
    flat = np.ascontiguousarray(mask.astype(np.uint8).T.reshape(-1))
    return _encode_colmajor(flat, h, w)


def _encode_colmajor(flat: np.ndarray, h: int, w: int) -> Dict:
    return {"size": [h, w],
            "counts": _counts_to_string(_runs(flat.astype(bool)))}


def decode(rle: Dict) -> np.ndarray:
    """RLE dict → binary (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = _counts_of(rle)
    if counts.sum() != h * w:
        raise ValueError("RLE counts do not cover the canvas")
    vals = np.arange(len(counts)) % 2
    out = np.repeat(vals.astype(np.uint8), counts)
    return out.reshape(w, h).T


def area(rle: Dict) -> int:
    return int(_counts_of(rle)[1::2].sum())


def to_bbox(rle: Dict) -> np.ndarray:
    """RLE → its (x, y, w, h) COCO box (zeros for an empty mask)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros((4,), np.float64)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float64)


def iou(dt: Dict, gt: Dict, iscrowd: bool = False) -> float:
    """Mask IoU; a crowd gt divides by the detection's area (COCO)."""
    md, mg = decode(dt).astype(bool), decode(gt).astype(bool)
    inter = np.logical_and(md, mg).sum()
    denom = md.sum() if iscrowd else np.logical_or(md, mg).sum()
    return float(inter / denom) if denom else 0.0


def iou_matrix(dts: Sequence[Dict], gts: Sequence[Dict],
               iscrowd: Sequence[bool] = None) -> np.ndarray:
    """The (len(dts), len(gts)) mask-IoU matrix (pycocotools ``rleIou``),
    pair by pair through :func:`iou`."""
    nd, ng = len(dts), len(gts)
    crowd = np.zeros(ng, np.uint8) if iscrowd is None else \
        np.ascontiguousarray(iscrowd, np.uint8)
    if len(crowd) != ng:
        raise ValueError(f"{len(crowd)} crowd flags for {ng} gts")
    out = np.zeros((nd, ng), np.float64)
    for d in range(nd):
        for g in range(ng):
            out[d, g] = iou(dts[d], gts[g], bool(crowd[g]))
    return out


def merge(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    """Union (default) or intersection of RLEs on one canvas."""
    if not rles:
        raise ValueError("merge of zero masks")
    h, w = rles[0]["size"]
    acc = _counts_of(rles[0])
    for r in rles[1:]:
        c = _counts_of(r)
        a = np.repeat(np.arange(len(acc)) % 2, acc).astype(bool)
        b = np.repeat(np.arange(len(c)) % 2, c).astype(bool)
        acc = _runs((a & b) if intersect else (a | b))
    return {"size": [h, w], "counts": _counts_to_string(acc)}


def from_poly(xy: Sequence[float], h: int, w: int) -> Dict:
    """Flat polygon [x0, y0, x1, y1, ...] → RLE by an even-odd fill of
    the pixel centres, column by column.  The reference's maskApi
    rasterises a 5x-upsampled boundary instead; the two differ only on
    the one-pixel boundary ring, as the JAX package's copy does."""
    xy = np.ascontiguousarray(xy, np.float64).reshape(-1)
    k = len(xy) // 2
    pts = xy.reshape(-1, 2)
    mask = np.zeros((h, w), np.uint8)
    cx = np.arange(w) + 0.5
    for col in range(w):
        ys = []
        for i in range(k):
            x1, y1 = pts[i]
            x2, y2 = pts[(i + 1) % k]
            if (x1 <= cx[col] < x2) or (x2 <= cx[col] < x1):
                t = (cx[col] - x1) / (x2 - x1)
                ys.append(y1 + t * (y2 - y1))
        ys.sort()
        for j in range(0, len(ys) - 1, 2):
            r0 = int(np.ceil(ys[j] - 0.5))
            r1 = int(np.floor(ys[j + 1] - 0.5))
            mask[max(r0, 0):min(r1, h - 1) + 1, col] = 1
    return _encode_colmajor(
        np.ascontiguousarray(mask.T.reshape(-1)), h, w)


def from_uncompressed(size: Sequence[int], counts: Sequence[int]) -> Dict:
    """COCO's uncompressed RLE (counts as an int list, the crowd
    annotations' json form) → a compressed RLE dict (ref pycocotools
    ``frUncompressedRLE``)."""
    return {"size": list(size),
            "counts": _counts_to_string(np.asarray(counts, np.uint32))}


def from_bbox(bb: Sequence[float], h: int, w: int) -> Dict:
    """COCO (x, y, w, h) box → RLE."""
    x, y, bw, bh = (float(v) for v in bb)
    return from_poly([x, y, x, y + bh, x + bw, y + bh, x + bw, y], h, w)
