"""Image decode, resize, bucket choice and pad/normalise.

Counterpart of ``mx_rcnn_tpu/data/image.py`` (``imread_rgb``,
``compute_scale``, ``resize_keep_ratio``, ``bucket_fit``,
``choose_bucket``, ``load_resized_uint8``, ``pad_normalize``,
``load_and_transform``, ``resize_to_bucket``, ``estimate_bucket``, and
``load_resized_uint8``'s flip, resize and shrink-to-fit as
``flip_resize_fit``), and ``prepare_image``, the canvas and ``im_info``
of one served or demo image.  Images are RGB uint8 (H, W, 3).  Files are
decoded (and the generated sets' PNGs written, ``imwrite_rgb``) by
OpenCV (BGR to RGB), or by PIL where ``cv2`` does not import.
Resizing uses OpenCV's bilinear resize where ``cv2`` imports, else a
numpy bilinear resize with the same half-pixel-centre convention;
:data:`RESIZE_BACKEND` says which one this process uses.  This module
imports no torch: the decode pool's workers import it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

RESIZE_BACKEND = "cv2" if cv2 is not None else "numpy"


def imread_rgb(path: str) -> np.ndarray:
    """An image file as RGB uint8 (H, W, 3)."""
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path!r}")
        return img[:, :, ::-1]
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imwrite_rgb(path: str, img: np.ndarray) -> None:
    """Write RGB uint8 (H, W, 3) ``img`` to ``path``, its format by the
    extension."""
    if cv2 is not None:
        if not cv2.imwrite(path, np.ascontiguousarray(img[:, :, ::-1])):
            raise OSError(f"cannot write image {path!r}")
        return
    from PIL import Image

    Image.fromarray(img).save(path)


def _resize_bilinear_np(img: np.ndarray, new_w: int, new_h: int
                        ) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W, 3) image, half-pixel centres,
    edges clamped (OpenCV's INTER_LINEAR convention up to rounding)."""
    h, w = img.shape[:2]

    def axis(out_n, in_n):
        pos = (np.arange(out_n, dtype=np.float32) + 0.5) * (in_n / out_n) - 0.5
        pos = np.clip(pos, 0.0, in_n - 1.0)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, in_n - 1)
        return lo, hi, (pos - lo).astype(np.float32)

    ylo, yhi, fy = axis(new_h, h)
    xlo, xhi, fx = axis(new_w, w)
    src = img.astype(np.float32)
    top = src[ylo] * (1.0 - fy)[:, None, None] + src[yhi] * fy[:, None, None]
    out = top[:, xlo] * (1.0 - fx)[None, :, None] + top[:, xhi] * fx[None, :, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    if cv2 is not None:
        return cv2.resize(np.ascontiguousarray(img), (new_w, new_h),
                          interpolation=cv2.INTER_LINEAR)
    return _resize_bilinear_np(np.asarray(img), new_w, new_h)


def compute_scale(h: int, w: int, target_size: int, max_size: int) -> float:
    """Scale so the short side hits ``target_size`` unless the long side
    would pass ``max_size``."""
    short, long = min(h, w), max(h, w)
    scale = float(target_size) / short
    if round(scale * long) > max_size:
        scale = float(max_size) / long
    return scale


def resize_keep_ratio(img: np.ndarray, target_size: int, max_size: int
                      ) -> Tuple[np.ndarray, float]:
    """Resize keeping the aspect ratio; returns (image, scale)."""
    h, w = img.shape[:2]
    scale = compute_scale(h, w, target_size, max_size)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    return _resize(img, new_w, new_h), scale


def bucket_fit(h: int, w: int, bucket: Tuple[int, int]) -> float:
    """Shrink factor that makes an (h, w) image fit ``bucket``."""
    bh, bw = bucket
    if h > bh or w > bw:
        return min(bh / h, bw / w)
    return 1.0


def choose_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]
                  ) -> Tuple[int, int]:
    """The smallest bucket that fits (h, w), else the largest bucket of
    the same orientation."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    landscape = w >= h
    same = [b for b in buckets if (b[1] >= b[0]) == landscape]
    return max(same or buckets, key=lambda b: b[0] * b[1])


def estimate_bucket(h: int, w: int, scale: int, max_size: int,
                    buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """The bucket an (h, w) image serves in after ``resize_keep_ratio``,
    from its dims alone: the serving engine's admission check, made
    before any pixel work."""
    s = compute_scale(h, w, scale, max_size)
    return choose_bucket(int(round(h * s)), int(round(w * s)), buckets)


def flip_resize_fit(img: np.ndarray, flipped: bool, scale: int,
                    max_size: int, bucket: Tuple[int, int]
                    ) -> Tuple[np.ndarray, float]:
    """Mirror (when ``flipped``), resize keeping the ratio and shrink to
    fit ``bucket``, staying uint8: the unpadded contiguous (h, w, 3)
    image and its ``im_scale``."""
    if flipped:
        img = img[:, ::-1, :]
    img, im_scale = resize_keep_ratio(img, scale, max_size)
    img, im_scale = fit_to_bucket(img, im_scale, bucket)
    return np.ascontiguousarray(img), im_scale


def load_resized_uint8(path: str, flipped: bool, scale: int, max_size: int,
                       bucket: Tuple[int, int]) -> Tuple[np.ndarray, float]:
    """Decode → flip → resize → shrink to fit ``bucket``, staying uint8:
    what the decode cache stores and the decode pool returns."""
    return flip_resize_fit(imread_rgb(path), flipped, scale, max_size,
                           bucket)


def load_and_transform(path: str, flipped: bool,
                       pixel_means: Sequence[float], scale: int,
                       max_size: int, bucket: Tuple[int, int]
                       ) -> Tuple[np.ndarray, float]:
    """The whole host pipeline of one file: decode, flip, resize, then
    mean-subtract and pad into ``bucket``; returns ((bh, bw, 3) fp32
    canvas, im_scale)."""
    img, im_scale = load_resized_uint8(path, flipped, scale, max_size,
                                       bucket)
    return pad_normalize(img, pixel_means, bucket), im_scale


def pad_normalize(img: np.ndarray, pixel_means: Sequence[float],
                  bucket: Tuple[int, int]) -> np.ndarray:
    """Unpadded (h, w, 3) uint8 → padded (bh, bw, 3) fp32 mean-subtracted
    canvas, exact zeros in the padding."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        raise ValueError(f"image ({h}, {w}) does not fit bucket ({bh}, {bw})")
    out = np.zeros((bh, bw, 3), dtype=np.float32)
    np.subtract(img, np.asarray(pixel_means, dtype=np.float32),
                out=out[:h, :w], casting="unsafe")
    return out


def resize_to_bucket(img: np.ndarray, pixel_means: Sequence[float], scale: int,
                     max_size: int, buckets: Sequence[Tuple[int, int]]
                     ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Resize → choose bucket (shrinking to fit if needed) → pad and
    normalise.  Returns (canvas, im_scale, bucket)."""
    resized, im_scale = resize_keep_ratio(np.asarray(img), scale, max_size)
    bucket = choose_bucket(*resized.shape[:2], buckets)
    resized, im_scale = fit_to_bucket(resized, im_scale, bucket)
    return pad_normalize(resized, pixel_means, bucket), im_scale, bucket


def prepare_image(img: np.ndarray, cfg
                  ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """One RGB uint8 (h, w, 3) image → (padded fp32 canvas, im_info (3,),
    bucket) under a ``Config``'s pixel means, scales and buckets: the
    eval's preprocessing, which the demo and the serving engine share."""
    canvas, im_scale, bucket = resize_to_bucket(
        img, cfg.network.pixel_means, cfg.bucket.scale, cfg.bucket.max_size,
        tuple(tuple(s) for s in cfg.bucket.shapes))
    h, w = img.shape[:2]
    im_info = np.array([round(h * im_scale), round(w * im_scale), im_scale],
                       np.float32)
    return canvas, im_info, bucket


def fit_to_bucket(img: np.ndarray, im_scale: float, bucket: Tuple[int, int]
                  ) -> Tuple[np.ndarray, float]:
    """Shrink a resized uint8 image that overflows ``bucket`` until it
    fits; returns (image, updated im_scale)."""
    h, w = img.shape[:2]
    fit = bucket_fit(h, w, bucket)
    if fit != 1.0:
        img = _resize(img, int(w * fit), int(h * fit))
        im_scale *= fit
    return img, im_scale
