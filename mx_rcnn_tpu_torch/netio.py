"""Bounded reads and checks of what a peer sends the HTTP server.

Counterpart of the parts of ``mx_rcnn_tpu/netio.py`` the serving front
end (``serve/server.py``) needs: :class:`BodyError`,
:func:`check_timeout_ms`, :func:`check_trace_header` and
:func:`read_request_body`, with the same limits and the same refusal
statuses.  A request body without a Content-Length is 411, a claim over
the cap 413 before a byte is read, a read past its wall-clock deadline
408, an unparseable, negative or short one 400.  Stdlib only.
"""

from __future__ import annotations

import time

_CHUNK = 64 << 10

# default cap of a response body read by read_limited
DEFAULT_CAP_BYTES = 8 << 20

# widest timeout a peer may ask for: a week in ms.  A finite but huge
# value (1e38) still overflows Condition.wait, so finite is not enough
MAX_TIMEOUT_MS = 7 * 86400 * 1000.0

# an X-MXR-Trace header is a short structured string; longer is hostile
MAX_TRACE_HEADER = 256


class ResponseTooLarge(ValueError):
    """A response body crossed its byte cap mid-read."""


class ResponseTooSlow(ValueError):
    """A response body read crossed its wall-clock deadline (the socket
    timeout bounds only the gap between bytes)."""


class BodyError(ValueError):
    """A request body refused before it is read; ``status`` is the HTTP
    status to reply with (411, 413, 408 or 400)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = int(status)


def check_timeout_ms(value, what: str = "timeout_ms"):
    """A peer-supplied timeout: ``None`` passes (the caller's default
    applies), anything else must be a number in ``[0, MAX_TIMEOUT_MS]``.
    NaN fails the range test, so one comparison refuses NaN, inf and
    negatives."""
    if value is None:
        return None
    try:
        t = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"{what} must be a number, got {value!r}")
    if not (0.0 <= t <= MAX_TIMEOUT_MS):
        raise ValueError(f"{what} must be in [0, {MAX_TIMEOUT_MS:g}], "
                         f"got {t!r}")
    return t


def check_trace_header(value, what: str = "X-MXR-Trace"):
    """A peer-supplied trace header before any parse: ``None`` passes,
    anything else must be an ascii string of at most
    ``MAX_TRACE_HEADER`` characters, else a 400 :class:`BodyError`."""
    if value is None:
        return None
    if not isinstance(value, str) or len(value) > MAX_TRACE_HEADER:
        raise BodyError(400, f"{what} header missing or over "
                             f"{MAX_TRACE_HEADER} chars")
    try:
        value.encode("ascii")
    except UnicodeEncodeError:
        raise BodyError(400, f"{what} header is not ascii")
    return value


def read_request_body(handler, max_bytes: int,
                      deadline_s: float = None) -> bytes:
    """One request body off ``handler`` (a ``BaseHTTPRequestHandler``).

    The 413 is decided on the claimed length, before a body byte is
    read.  ``deadline_s`` bounds the whole read by the wall clock (408
    past it): the socket timeout bounds only the gap between bytes,
    which a sender trickling one byte at a time never exceeds."""
    claimed = handler.headers.get("Content-Length")
    if claimed is None:
        raise BodyError(411, "Content-Length required "
                             "(chunked bodies are not accepted)")
    try:
        n = int(claimed)
    except ValueError:
        raise BodyError(400, f"unparseable Content-Length {claimed!r}")
    if n < 0:
        raise BodyError(400, f"negative Content-Length {n}")
    if n > int(max_bytes):
        raise BodyError(413, f"body of {n} bytes over the "
                             f"{int(max_bytes)}-byte cap")
    if not deadline_s:
        body = handler.rfile.read(n)
    else:
        t0 = time.monotonic()
        read1 = getattr(handler.rfile, "read1", None)
        out = bytearray()
        while len(out) < n:
            want = min(_CHUNK, n - len(out))
            chunk = (read1(want) if read1 is not None
                     else handler.rfile.read(want))
            if not chunk:
                break
            out += chunk
            if len(out) < n and time.monotonic() - t0 > deadline_s:
                raise BodyError(408, f"body read exceeded "
                                     f"{deadline_s:g}s at {len(out)} "
                                     f"of {n} bytes")
        body = bytes(out)
    if len(body) != n:
        raise BodyError(400, f"body ended at {len(body)} of {n} "
                             f"claimed bytes")
    return body


def read_limited(resp, max_bytes: int = DEFAULT_CAP_BYTES,
                 what: str = "response body",
                 deadline_s: float = None) -> bytes:
    """Drain ``resp`` (anything with ``.read(n)``) up to ``max_bytes``,
    in chunks, so that a peer sending more than it claimed is cut off at
    the cap plus one chunk (:class:`ResponseTooLarge`).  ``deadline_s``
    bounds the whole read by the wall clock (:class:`ResponseTooSlow`);
    ``read1`` is preferred then, so a trickling peer is cut off at the
    deadline."""
    max_bytes = int(max_bytes)
    t0 = time.monotonic() if deadline_s else 0.0
    read1 = getattr(resp, "read1", None) if deadline_s else None
    out = bytearray()
    while True:
        chunk = read1(_CHUNK) if read1 is not None else resp.read(_CHUNK)
        if not chunk:
            return bytes(out)
        out += chunk
        if len(out) > max_bytes:
            raise ResponseTooLarge(
                f"{what} exceeded the {max_bytes}-byte cap")
        if deadline_s and time.monotonic() - t0 > deadline_s:
            raise ResponseTooSlow(
                f"{what} read exceeded {deadline_s:g}s "
                f"({len(out)} bytes in)")
