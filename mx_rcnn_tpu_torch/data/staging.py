"""Host-to-device staging of training batches, ahead of the steps.

Counterpart of ``mx_rcnn_tpu/data/staging.py — DeviceStager``.  One
daemon thread pulls batch k+1 from the loader (which assembles it on its
own threads), copies it into pinned host memory and from there to the
card on a side CUDA stream, and records an event; the consumer's stream
waits on that event and each tensor is marked as used by the consumer's
stream (``record_stream``), so the caching allocator does not reuse its
memory while the step still reads it.  Up to ``depth`` staged batches
wait in a bounded queue.  On the CPU a batch is staged with a plain
``to(device)``.

The values pass through unchanged: the same batches in the same order.
An error from the source or the copy re-raises in the consumer, and
:meth:`DeviceStager.close` releases the thread without draining the
epoch.  ``hits`` counts the batches that were staged before the consumer
asked for them and ``misses`` those it waited for (the JAX stager's
``loader.stage_hits``/``stage_misses``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

_END = object()


class DeviceStager:
    """Iterating yields the batches of ``source`` (namedtuples of numpy
    arrays) as the same namedtuples of tensors on ``device``, staged by a
    background thread up to ``depth`` batches ahead."""

    def __init__(self, source: Iterable, device, depth: int = 2):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the stage thread makes this card current: name it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda"
            else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._closed = False
        self.hits = 0
        self.misses = 0
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), name="device-stager",
            daemon=True)
        self._thread.start()

    def _place(self, batch):
        """(the batch on the device, the copy's event or None)."""
        host = [torch.from_numpy(np.ascontiguousarray(x)) for x in batch]
        if self._stream is None:
            return type(batch)(*(t.to(self.device) for t in host)), None
        with torch.cuda.stream(self._stream):
            out = [t.pin_memory().to(self.device, non_blocking=True)
                   for t in host]
            event = torch.cuda.Event()
            event.record(self._stream)
        return type(batch)(*out), event

    def _run(self, it: Iterator) -> None:
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            while not self._closed:
                try:
                    batch = next(it)
                except StopIteration:
                    break
                self._put(self._place(batch))
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            self._put(e)
            return
        finally:  # stops the loader's assembly threads on abandonment too
            close = getattr(it, "close", None)
            if close is not None:
                close()
        self._put(_END)

    def _put(self, item) -> None:
        # gives up once the consumer has closed: a plain blocking put
        # would wedge the thread on a full queue nobody drains
        while not self._closed:
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        while True:
            try:
                item, ready = self._q.get_nowait(), True
            except queue.Empty:
                item, ready = self._q.get(), False
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            if ready:
                self.hits += 1
            else:
                self.misses += 1
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in batch:
                    t.record_stream(stream)
            yield batch

    def close(self) -> None:
        """Release the thread (at the epoch's end or on abandonment);
        idempotent.  Staged batches still queued are dropped."""
        self._closed = True
        while True:  # unblock a thread parked on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
