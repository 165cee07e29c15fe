"""Bounded reads and checks of what a peer sends the HTTP server.

Counterpart of ``mx_rcnn_tpu/netio.py``: :class:`BodyError`,
:func:`check_timeout_ms`, :func:`check_trace_header`,
:func:`read_request_body` and :func:`read_limited` for the HTTP servers
and scrapes, and the cross-host wire's socket half,
:func:`sendmsg_all` and :func:`read_http_response_into`, with the same
limits and the same refusal statuses.  A request body without a
Content-Length is 411, a claim over
the cap 413 before a byte is read, a read past its wall-clock deadline
408, an unparseable, negative or short one 400.  Stdlib only.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

_CHUNK = 64 << 10

# default cap of a response body read by read_limited
DEFAULT_CAP_BYTES = 8 << 20

# widest timeout a peer may ask for: a week in ms.  A finite but huge
# value (1e38) still overflows Condition.wait, so finite is not enough
MAX_TIMEOUT_MS = 7 * 86400 * 1000.0

# an X-MXR-Trace header is a short structured string; longer is hostile
MAX_TRACE_HEADER = 256

# iovecs a sendmsg call: under every platform's IOV_MAX (Linux 1024)
_IOV_CHUNK = 64

# a response head past this is not an HTTP response from an agent
MAX_HTTP_HEAD = 16 << 10


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


def sendmsg_all(sock, bufs) -> int:
    """``sendall`` of a list of buffers through ``socket.sendmsg``: a
    wire frame goes out as header bytes and a memoryview of its pixels,
    never joined into one body.  Short writes re-slice the buffer they
    stopped in; the iovec list goes out ``_IOV_CHUNK`` at a time.
    Returns the bytes sent."""
    views = [memoryview(b).cast("B") for b in bufs]
    views = [v for v in views if len(v)]
    total = 0
    while views:
        n = sock.sendmsg(views[:_IOV_CHUNK])
        total += n
        while n > 0:
            if n >= len(views[0]):
                n -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][n:]
                n = 0
    return total


def _parse_http_head(head: bytes, what: str) -> Tuple[int, Dict[str, str]]:
    lines = head.split(b"\r\n")
    parts = lines[0].split(None, 2)
    if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
        raise ValueError(f"{what}: not an HTTP status line: "
                         f"{bytes(lines[0][:80])!r}")
    try:
        status = int(parts[1])
    except ValueError:
        raise ValueError(f"{what}: unparseable status {parts[1]!r}")
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(b":")
        headers[k.strip().lower().decode("latin-1")] = \
            v.strip().decode("latin-1")
    return status, headers


def read_http_response_into(sock, body: bytearray, max_bytes: int,
                            deadline_s: float = None,
                            what: str = "response"
                            ) -> Tuple[int, int, bool]:
    """One HTTP/1.1 response off a blocking socket into ``body``, a
    buffer the caller keeps and this grows: no allocation a response
    once it is as large as the largest reply.

    The head is capped at :data:`MAX_HTTP_HEAD`; the body must declare a
    Content-Length, refused above ``max_bytes`` before a body byte is
    read; ``deadline_s`` bounds the whole read by the wall clock.
    Returns ``(status, body_len, server_wants_close)``: the body is
    ``memoryview(body)[:body_len]`` until the next call.  A protocol
    violation raises ``ValueError``, a peer that went away
    ``ConnectionError`` (the stale keep-alive retry's signal)."""
    t0 = time.monotonic() if deadline_s else 0.0
    head = bytearray()
    while True:
        idx = head.find(b"\r\n\r\n")
        if idx >= 0:
            break
        if len(head) > MAX_HTTP_HEAD:
            raise ResponseTooLarge(
                f"{what}: header exceeded the {MAX_HTTP_HEAD}-byte cap")
        if deadline_s and time.monotonic() - t0 > deadline_s:
            raise ResponseTooSlow(
                f"{what}: header read exceeded {deadline_s:g}s")
        chunk = sock.recv(8192)
        if not chunk:
            raise ConnectionError(
                f"{what}: peer closed at {len(head)} header bytes")
        head += chunk
    status, headers = _parse_http_head(bytes(head[:idx]), what)
    leftover = head[idx + 4:]
    claimed = headers.get("content-length")
    if claimed is None:
        raise ValueError(f"{what}: missing Content-Length")
    n = int(claimed)  # garbage raises ValueError: the typed rejection
    if n < 0:
        raise ValueError(f"{what}: negative Content-Length {n}")
    if n > int(max_bytes):
        raise ResponseTooLarge(
            f"{what}: body of {n} bytes over the {int(max_bytes)}-byte "
            f"cap")
    if len(leftover) > n:
        raise ValueError(f"{what}: {len(leftover) - n} bytes past the "
                         f"declared body")
    if len(body) < n:
        body.extend(bytes(n - len(body)))
    view = memoryview(body)
    view[:len(leftover)] = leftover
    got = len(leftover)
    while got < n:
        if deadline_s and time.monotonic() - t0 > deadline_s:
            raise ResponseTooSlow(
                f"{what}: body read exceeded {deadline_s:g}s at {got} "
                f"of {n} bytes")
        k = sock.recv_into(view[got:n])
        if not k:
            raise ConnectionError(
                f"{what}: peer closed at {got} of {n} body bytes")
        got += k
    wants_close = headers.get("connection", "").lower() == "close"
    return status, n, wants_close
