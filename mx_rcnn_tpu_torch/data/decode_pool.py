"""Process-parallel image decoding for the loaders.

Counterpart of ``mx_rcnn_tpu/data/decode_pool.py — DecodePool``.  The
assembly threads (``data/loader.py — _prefetched``) overlap batch
assembly with the steps, but the Python side of a decode still holds one
interpreter lock; worker processes lift that ceiling.

* The pool uses the **spawn** context: forking a process that has CUDA
  or threads running is unsafe.
* A worker imports only this module, ``data/image.py`` and
  ``data/cache.py`` (numpy and cv2): no torch, so it starts fast and
  never touches CUDA.  Each worker may hold a :class:`DecodedImageCache`
  whose RAM tier is its own and whose disk tier it shares with the
  others (the cache's tmp+rename writes are safe across processes).
* Paths go to the workers and uint8 pixels come back; ``im_scale`` does
  not, since the parent derives it from the record's geometry
  (``cache.plan_scale``).
* A failed decode raises in the loader, through the future; nothing
  falls back to a decode in the parent.

Build the pool from code under ``if __name__ == "__main__":`` or from an
importable module: spawn re-imports ``__main__`` in each worker.
"""

from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import Future, ProcessPoolExecutor
from typing import Optional, Tuple

import numpy as np

# each worker's cache, made once by the pool's initializer
_WORKER_CACHE = None


def _init_worker(cache_dir: Optional[str], ram_bytes: int) -> None:
    global _WORKER_CACHE
    if cache_dir or ram_bytes > 0:
        from mx_rcnn_tpu_torch.data.cache import DecodedImageCache

        _WORKER_CACHE = DecodedImageCache(ram_bytes=ram_bytes,
                                          cache_dir=cache_dir)
    else:
        _WORKER_CACHE = None


def _decode(path: str, flipped: bool, scale: int, max_size: int,
            bucket: Tuple[int, int]) -> np.ndarray:
    """The worker's task: decode → flip → resize → shrink to fit,
    returning the unpadded uint8 pixels."""
    if _WORKER_CACHE is not None:
        return _WORKER_CACHE.load(path, flipped, scale, max_size, bucket)
    from mx_rcnn_tpu_torch.data.image import load_resized_uint8

    return load_resized_uint8(path, flipped, scale, max_size, bucket)[0]


class DecodePool:
    """``num_procs`` spawned worker processes decoding images for the
    loaders; ``cache_dir`` is a disk tier the workers share, and
    ``ram_bytes`` each worker's own RAM tier (0 disables it)."""

    def __init__(self, num_procs: int, cache_dir: Optional[str] = None,
                 ram_bytes: int = 0):
        if num_procs < 1:
            raise ValueError("num_procs must be >= 1")
        self.num_procs = num_procs
        self._ex = ProcessPoolExecutor(
            num_procs, mp_context=mp.get_context("spawn"),
            initializer=_init_worker, initargs=(cache_dir, ram_bytes))

    def submit(self, path: str, flipped: bool, scale: int, max_size: int,
               bucket: Tuple[int, int]) -> Future:
        """Schedule one decode; a future of the uint8 pixels."""
        return self._ex.submit(_decode, path, flipped, scale, max_size,
                               tuple(bucket))

    def close(self) -> None:
        """Stop the workers, dropping decodes not yet started."""
        self._ex.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "DecodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
