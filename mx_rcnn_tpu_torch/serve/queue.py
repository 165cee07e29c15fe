"""Bounded admission queues with deadlines and load shedding.

Counterpart of ``mx_rcnn_tpu/serve/queue.py``.  A request is admitted
only while its bucket's queue is under the shed watermark, may carry a
deadline, and ends in exactly one of four states: ``SERVED``, ``SHED``
(HTTP 429), ``EXPIRED`` (504) or ``FAILED`` (500).  Overload is refused
at the door instead of growing the queue until every request times out.

Deadlines are enforced at batch collection (expired requests are
cancelled before dispatch, so dead work takes no batch row), at
completion (``engine.py — _serve_batch``: a request that expired while
its batch ran ends EXPIRED, never as a late success) and in the caller's
``wait``.  A request carries its host-trace id (``trace_id``, while
``obs/trace.py`` collects spans) and its distributed context (``tctx``,
from an ``X-MXR-Trace`` header): whichever thread ends it closes its
``serve.request`` interval and records exactly one ``terminal.<state>``
span.  ``add_done_callback`` runs a callback once at the terminal
transition, on whichever thread makes it (the bulk tier's completion
hook, and the fleet router's).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.obs import trace as obs_trace


class ShedError(RuntimeError):
    """Refused at admission: the queue is at its shed watermark (429)."""


class DeadlineExceeded(RuntimeError):
    """The deadline passed before a result was produced (504)."""


class RequestFailed(RuntimeError):
    """The engine failed while serving the request (500); the original
    exception is chained."""


# terminal states: every submitted request reaches exactly one
PENDING = "pending"
SERVED = "served"
SHED = "shed"
EXPIRED = "expired"
FAILED = "failed"


class ServeRequest:
    """One in-flight detection request.

    ``ServingEngine.submit`` makes it; the caller blocks on :meth:`wait`
    while a dispatcher fills :attr:`result`.  Every transition goes
    through :meth:`_finish` under the lock, so a request terminates once.
    """

    __slots__ = ("image", "im_info", "bucket", "enqueue_t", "deadline",
                 "state", "result", "error", "dispatch_t", "done_t",
                 "batch_rows", "trace_id", "tctx", "_event", "_lock",
                 "_on_done")

    def __init__(self, image: np.ndarray, im_info: np.ndarray,
                 bucket: Tuple[int, int], deadline: Optional[float],
                 now: float):
        self.image = image          # (bh, bw, 3) fp32, padded into bucket
        self.im_info = im_info      # (3,) fp32: (h, w, im_scale)
        self.bucket = bucket
        self.enqueue_t = now
        self.deadline = deadline    # absolute time.monotonic(), or None
        self.state = PENDING
        self.result = None          # {class_id: (k, 5) array} when SERVED
        self.error: Optional[BaseException] = None
        self.dispatch_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.batch_rows = 0         # real rows of the batch it rode
        self.trace_id = None        # obs/trace.py span id (None: off)
        self.tctx = None            # inbound TraceContext (None: none)
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._on_done = None        # add_done_callback's hook

    # latency accounting (None until the matching transition happened)
    @property
    def queue_wait_s(self) -> Optional[float]:
        """Seconds from admission to dispatch (None until dispatched)."""
        if self.dispatch_t is None:
            return None
        return self.dispatch_t - self.enqueue_t

    @property
    def total_s(self) -> Optional[float]:
        """Seconds from admission to the terminal state (None while
        pending)."""
        if self.done_t is None:
            return None
        return self.done_t - self.enqueue_t

    def _finish(self, state: str, result=None,
                error: BaseException = None, now: float = None) -> bool:
        """Move to a terminal state; False if already terminal."""
        with self._lock:
            if self.state != PENDING:
                return False
            self.state = state
            self.result = result
            self.error = error
            self.done_t = time.monotonic() if now is None else now
        if self.trace_id is not None:
            # closes the interval opened at admission, from whichever
            # thread ended the request
            obs_trace.async_end("serve.request", self.trace_id, state=state)
        if self.tctx is not None:
            # one terminal span per terminal transition: the trace
            # audits the exactly-once accounting
            obs_trace.record_span(
                self.tctx, f"terminal.{state}", 0.0,
                total_ms=round((self.done_t - self.enqueue_t) * 1e3, 3))
        self._event.set()
        cb = self._on_done
        if cb is not None:
            cb(self)  # once: a second _finish returned above
        return True

    def add_done_callback(self, cb: Callable[["ServeRequest"], None]
                          ) -> None:
        """Call ``cb(request)`` once the request is terminal, from the
        thread that ends it; a request already terminal (one shed inside
        ``submit``) calls it at once, on the caller's thread."""
        with self._lock:
            if self.state == PENDING:
                self._on_done = cb
                return
        cb(self)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def wait(self, timeout: float = None):
        """Block until the request terminates; return its detections or
        raise the error of its state.  ``timeout`` (s) bounds the wait
        apart from the request's deadline."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending after wait timeout")
        if self.state == SERVED:
            return self.result
        if self.state == SHED:
            raise ShedError("request shed at admission (queue over "
                            "watermark)")
        if self.state == EXPIRED:
            raise DeadlineExceeded("request deadline expired before serve")
        raise RequestFailed("engine error while serving request") \
            from self.error


class BoundedQueue:
    """FIFO request queue with a depth cap, a shed watermark and
    deadline-aware batch collection.

    ``offer`` refuses (returns False) at ``shed_watermark``; the caller
    marks the request SHED.  ``take_batch`` blocks for a first request,
    then gathers up to ``max_n``, waiting at most ``max_delay_s`` past
    the first for more; expired requests are cancelled, not returned.
    """

    def __init__(self, depth: int, shed_watermark: int = None):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self.shed_watermark = min(depth, shed_watermark or depth)
        if self.shed_watermark < 1:
            raise ValueError(
                f"shed_watermark must be >= 1, got {self.shed_watermark}")
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def offer(self, req: ServeRequest) -> bool:
        """Admit ``req`` unless the queue is at its watermark or closed."""
        with self._cond:
            if self._closed or len(self._q) >= self.shed_watermark:
                return False
            self._q.append(req)
            self._cond.notify()
            return True

    def take_batch(self, max_n: int, max_delay_s: float,
                   now_fn: Callable[[], float] = time.monotonic,
                   on_expire: Callable[[ServeRequest], None] = None
                   ) -> List[ServeRequest]:
        """The next micro-batch; an empty list means closed and drained.
        Blocks for the first request; from the first one taken, waits at
        most ``max_delay_s`` for more.  ``on_expire`` is called for each
        request cancelled here, after its transition."""
        batch: List[ServeRequest] = []
        window_end: Optional[float] = None
        with self._cond:
            while True:
                while self._q and len(batch) < max_n:
                    req = self._q.popleft()
                    if req.expired(now_fn()):
                        if req._finish(EXPIRED) and on_expire is not None:
                            on_expire(req)
                        continue
                    batch.append(req)
                    if window_end is None:
                        window_end = now_fn() + max_delay_s
                if len(batch) >= max_n:
                    return batch
                if batch:
                    remaining = window_end - now_fn()
                    if remaining <= 0 or self._closed:
                        return batch      # window closed: a partial batch
                    self._cond.wait(timeout=remaining)
                else:
                    if self._closed:
                        return batch      # empty: the dispatcher exits
                    self._cond.wait()     # woken by offer() or close()

    def close(self) -> List[ServeRequest]:
        """Stop admitting, wake the dispatchers, and return what was still
        queued for the caller to terminate."""
        with self._cond:
            self._closed = True
            leftovers = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        return leftovers
