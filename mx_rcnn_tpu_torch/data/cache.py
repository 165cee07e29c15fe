"""The decoded-image cache: resized uint8 images in RAM, with a disk tier.

Counterpart of ``mx_rcnn_tpu/data/cache.py`` (``plan_scale``,
``DecodedImageCache``).  The cached value is the result of
``data/image.py — load_resized_uint8`` (decode → flip → resize →
shrink to fit), pixels only: ``im_scale`` is a pure function of the
record's geometry (:func:`plan_scale`), so the cache cannot hold a scale
that disagrees with its pixels.

* The RAM tier is an LRU dict under a byte budget.
* The disk tier keeps one ``.npy`` per image under ``cache_dir``, written
  to a temporary name and renamed, so no reader (thread or process) sees
  a torn file; a file that fails to load falls through to a decode.
* A key is a stable digest of the absolute path, flip and geometry, then
  a version from the file's mtime and size: a replaced source image
  misses instead of serving stale pixels, and the writer removes the
  superseded versions of its entry.

Thread-safe: the loader's assembly threads call :meth:`load` at once.
This module imports no torch: the decode pool's workers import it.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.data.image import (bucket_fit, compute_scale,
                                          load_resized_uint8)


def plan_scale(height: int, width: int, scale: int, max_size: int,
               bucket: Tuple[int, int]) -> float:
    """The im_scale ``load_resized_uint8`` will produce for an original of
    (height, width) — including the shrink-to-fit correction.  Pure
    function of geometry: cache hits get the exact scale the decode path
    would have returned without touching pixels.  Both the resize rule
    (:func:`compute_scale`) and the shrink correction
    (:func:`bucket_fit`) are the decode path's own helpers, so the two
    computations cannot drift apart."""
    s = compute_scale(height, width, scale, max_size)
    rh, rw = int(round(height * s)), int(round(width * s))
    return s * bucket_fit(rh, rw, bucket)


class DecodedImageCache:
    """Cache of ``load_resized_uint8`` pixel results.

    Args:
      ram_bytes: RAM tier budget in bytes (0 disables the RAM tier).
      cache_dir: disk tier directory (None disables the disk tier).
    """

    def __init__(self, ram_bytes: int = 2 << 30,
                 cache_dir: Optional[str] = None):
        self.ram_bytes = int(ram_bytes)
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._ram: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._ram_used = 0
        self._lock = threading.Lock()
        # stable-prefix -> set of versioned filenames currently on disk;
        # built from ONE os.listdir on first write, then kept in sync by
        # the writers in this process, so evicting superseded versions is
        # an O(1) lookup, not a scan of cache_dir per miss (O(N^2) over a
        # cold COCO-scale epoch).  Stale entries (another process wrote
        # concurrently) only cost a missed best-effort eviction.
        self._disk_index: Optional[dict] = None
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(path: str, flipped: bool, scale: int, max_size: int,
             bucket: Tuple[int, int]) -> str:
        # Two-part key: a STABLE digest of path+geometry, then a VERSION
        # suffix from the file's mtime_ns+size.  The version guarantees a
        # re-generated/replaced source image can never be served stale
        # pixels from cache_dir; the stable prefix lets the
        # writer evict superseded versions so repeated dataset regeneration
        # doesn't grow cache_dir unboundedly.  A missing file falls through
        # to the decode path, which raises its own error.
        try:
            st = os.stat(path)
            stamp = f"{st.st_mtime_ns}:{st.st_size}"
        except OSError:
            stamp = "0:0"
        ident = f"{os.path.abspath(path)}|{int(flipped)}|{scale}|" \
                f"{max_size}|{bucket[0]}x{bucket[1]}"
        stem = os.path.splitext(os.path.basename(path))[0]
        # full-width digest: a truncated hash colliding would silently
        # serve another image's pixels
        digest = hashlib.sha1(ident.encode()).hexdigest()
        version = hashlib.sha1(stamp.encode()).hexdigest()[:16]
        return f"{digest}-{stem}{'-f' if flipped else ''}.{version}"

    def _build_disk_index(self) -> dict:
        """One listdir pass over cache_dir → {stable prefix: {versioned
        filenames}} — built lazily on the first disk write, then kept in
        sync by :meth:`_record_version`."""
        index: dict = {}
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            names = []
        hexdigits = set("0123456789abcdef")
        for name in names:
            if not name.endswith(".npy"):
                continue
            stem = name[:-len(".npy")]
            head, _, version = stem.rpartition(".")
            # only properly-versioned entries (16-hex suffix) are indexed;
            # anything else is either a pre-versioning legacy name
            # (cleared by direct unlink in the writer) or a foreign file
            # we must not touch.  The check also keeps dotted image stems
            # (`img.v2.jpg`) from being split at the wrong dot.
            if head and len(version) == 16 and set(version) <= hexdigits:
                index.setdefault(head, set()).add(name)
        return index

    def _record_version(self, prefix: str, fn: str) -> list:
        """Record ``fn`` as the current on-disk version for ``prefix``;
        return the superseded sibling filenames the caller should unlink.
        The listdir-sized index build runs OUTSIDE the lock (it would
        otherwise stall every _ram_get for hundreds of ms on a warm
        COCO-scale dir); the dict/set mutations run UNDER it (the loader's
        prefetch threads can miss on the same key concurrently)."""
        if self._disk_index is None:
            built = self._build_disk_index()
            with self._lock:
                if self._disk_index is None:
                    self._disk_index = built
        with self._lock:
            entries = self._disk_index.setdefault(prefix, set())
            stale = [n for n in entries if n != fn]
            entries.difference_update(stale)
            entries.add(fn)
        return stale

    def _ram_get(self, key: str) -> Optional[np.ndarray]:
        with self._lock:
            img = self._ram.get(key)
            if img is not None:
                self._ram.move_to_end(key)
            return img

    def _ram_put(self, key: str, img: np.ndarray) -> None:
        if self.ram_bytes <= 0 or img.nbytes > self.ram_bytes:
            return
        with self._lock:
            if key in self._ram:
                return
            self._ram[key] = img
            self._ram_used += img.nbytes
            while self._ram_used > self.ram_bytes:
                _, old = self._ram.popitem(last=False)
                self._ram_used -= old.nbytes

    def load(self, path: str, flipped: bool, scale: int, max_size: int,
             bucket: Tuple[int, int]) -> np.ndarray:
        """Cached decode→flip→resize; returns the (h, w, 3) uint8 image
        (unpadded).  The caller derives im_scale via :func:`plan_scale`."""
        key = self._key(path, flipped, scale, max_size, bucket)
        img = self._ram_get(key)
        from_disk = False
        if img is None and self.cache_dir:
            fp = os.path.join(self.cache_dir, key + ".npy")
            if os.path.exists(fp):
                try:
                    img = np.load(fp)
                    from_disk = True
                except Exception:
                    img = None  # torn/corrupt file: fall through to decode
        if img is not None:
            self.hits += 1
            self._ram_put(key, img)
            if from_disk and self._disk_index is not None:
                # a disk HIT on a version this process's index doesn't
                # know can mean a sibling process wrote the new version
                # (so only ITS index would evict our stale one — it never
                # writes again after we start hitting its file).  The
                # index is already built, so this is an O(1) check that
                # closes the cross-process leak at zero listdir cost.
                prefix = key.rsplit(".", 1)[0]
                for old in self._record_version(prefix, key + ".npy"):
                    try:
                        os.unlink(os.path.join(self.cache_dir, old))
                    except OSError:  # already gone
                        pass
            return img
        self.misses += 1
        img, _ = load_resized_uint8(path, flipped, scale, max_size, bucket)
        self._ram_put(key, img)
        if self.cache_dir:
            fp = os.path.join(self.cache_dir, key + ".npy")
            tmp = fp + f".tmp{os.getpid()}-{threading.get_ident()}"
            try:
                # write via the handle: np.save(path) would append another
                # ".npy" to the tmp name and break the atomic rename
                with open(tmp, "wb") as f:
                    np.save(f, img)
                # no fsync: the cache is rebuildable, and a torn or lost
                # file falls through to a decode that rewrites it
                os.replace(tmp, fp)
                # evict superseded versions of this entry (same stable
                # prefix, different mtime/size version) so regenerating the
                # dataset N times doesn't keep N dead copies on disk; also
                # the pre-versioning legacy name `prefix.npy`, which the
                # new keys can never read again.  Sibling versions come
                # from the one-time directory index (O(1) per write) — not
                # a per-miss glob, which made cold first epochs O(N^2)
                prefix = key.rsplit(".", 1)[0]
                for old in self._record_version(prefix,
                                                os.path.basename(fp)):
                    try:
                        os.unlink(os.path.join(self.cache_dir, old))
                    except OSError:  # already gone
                        pass
                try:  # targeted single unlink, no directory scan
                    os.unlink(os.path.join(self.cache_dir,
                                           prefix + ".npy"))
                except OSError:  # never existed (the common case)
                    pass
            except OSError:  # disk full etc. — the cache stays best-effort
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return img
