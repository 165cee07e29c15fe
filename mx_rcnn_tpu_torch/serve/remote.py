"""The cross-host replica plane: the fleet's ``Replica`` seam over the
wire.

Counterpart of ``mx_rcnn_tpu/serve/remote.py``, whole; the router
process holds no model and touches no card.  :class:`RemoteEngine` is
an engine-shaped proxy for a whole remote host: the per-host agent
(``serve/agent.py``) runs N local replicas behind its own router, and
the head sees one remote replica per host and routes across hosts by
the same join-shortest-queue backlog it uses in-process.

Three pieces:

* **The binary wire** of the hot path.  A v1 frame is the (bh, bw, 3)
  fp32 bucket canvas as raw C-order bytes behind a fixed header (magic,
  dims, im_info, the remaining deadline); detections come back as raw
  fp32 rows: no JSON, no base64, bit-exact both ways.  A v2 frame ships
  the resized but unnormalized u8 pixels (1 byte a pixel against the
  canvas's 4, no padding), and the agent rebuilds the same canvas with
  ``data/image.py — pad_normalize``.  Queued frames coalesce into
  count-prefixed envelopes (``crosshost.frames_per_send``) sent as
  ``socket.sendmsg`` iovecs with no payload copy; v1 frames decode as
  ever (``decode_frame_ex`` takes both).  JSON stays for ``submit``
  (the raw-image control path) and the operational surface.  Every
  codec is byte-for-byte the JAX package's.

* **A bounded pipeline a connection**: each RemoteEngine keeps
  ``crosshost.connections`` keep-alive HTTP/1.1 connections, each a
  worker draining one shared frame queue; admission sheds once
  ``connections x pipeline_depth`` frames are in flight toward the
  host, so a slow or dying host pushes back on the router.  With
  ``pipeline_depth_max > 0`` a :class:`PipelineController` tunes the
  depth by AIMD on the windowed wire RTT.

* **The remote backlog feed**: :class:`RemoteBacklogFeed` polls every
  agent's /metrics through ``obs/collect.py`` (a timeout and a backoff
  a source, so a half-open host cannot stall the loop), pushes each
  bucket's lane depth into the RemoteEngines (the router's
  ``bucket_depth``) and appends the merged view to a
  :class:`~mx_rcnn_tpu_torch.obs.timeseries.TimeSeriesStore`, which the
  scheduler (``serve/scheduler.py``) judges.

Failures end as in the in-process fleet: a transport error fails the
frame (FAILED: the router reroutes it within its deadline);
``crosshost.dead_after_failures`` consecutive transport or scrape
failures flip ``alive()``, the manager ejects the replica, and its
relaunch probes the agent on the RestartPolicy schedule until the host
is back.  The eject also aborts the frames already on the wire to that
host: a host that stops answering without closing its sockets (power
lost, a process stuck in its exit) would otherwise hold them until the
socket's read timeout, past their deadline; aborted, they fail at once
and the router reroutes them (the port's repair: the JAX engine's kill
fails only the frames still queued).
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np

from mx_rcnn_tpu_torch.config import Config
from mx_rcnn_tpu_torch.netio import (check_timeout_ms, read_http_response_into,
                                     read_limited, sendmsg_all)
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.metrics import Registry, ServeMetrics
from mx_rcnn_tpu_torch.serve.fleet import Replica
from mx_rcnn_tpu_torch.serve.queue import (EXPIRED, FAILED, SERVED, SHED,
                                           ServeRequest)

logger = logging.getLogger("mx_rcnn_tpu_torch")

# ---------------------------------------------------------------------------
# binary wire format (the prepared hot path)
# ---------------------------------------------------------------------------

# request frame: header + raw fp32 canvas.  Little-endian, packed.
#   magic    4s   b"MXR1"
#   version  H    1
#   h, w, c  HHH  canvas dims (c is always 3 today; on the wire for
#                 self-description)
#   reserved H    0
#   timeout_ms f  remaining budget in ms (0 = no deadline) — the HEAD
#                 owns the absolute deadline; the wire carries the
#                 remainder so clock skew between hosts cannot move it
#   im_info  3f   (h, w, im_scale) fp32 record
WIRE_MAGIC = b"MXR1"
RESULT_MAGIC = b"MXD1"
WIRE_VERSION = 1
# result frame version carrying the trace extension (agent receive/send
# epoch-µs stamps after the entries).  A version-1 result is the untraced
# layout; agents only emit version 2 to a head that SENT a trace
# context, so an untraced head never sees bytes it cannot decode.
WIRE_VERSION_TRACED = 2
# request-frame flags (the previously-reserved header field).  0 keeps
# the frame bit-identical to the untraced layout; bit 0 declares a trace
# context extension appended after the canvas payload.  Unknown bits
# are typed-rejected — a length the head and agent disagree on must
# never be zero-filled into a "valid" frame.
WIRE_F_TRACE = 0x1
_REQ_HEAD = struct.Struct("<4sHHHHHf3f")
_RESP_HEAD = struct.Struct("<4sHH")
_RESP_ENTRY = struct.Struct("<HI")
_RESP_TRACE_EXT = struct.Struct("<QQ")   # agent recv / send (epoch µs)

# --- MXR1 v2: source-pixel frames -----------------------------------------
# The bandwidth harvest: sources are u8 (1 B/px) but v1 ships the
# preprocessed fp32 canvas (4 B/px) — and `pad_normalize` is deterministic
# and lives on every agent.  A v2 frame carries the resized-but-
# UNNORMALIZED u8 HWC image plus the bucket it serves in and the head-
# computed im_info; the agent runs the SAME data/image.py pad_normalize
# before enqueue, so the canvas is bit-equal to what the head would have
# shipped at a quarter of the bytes.  The dtype tag keeps the fp32
# prepared-row variant expressible in v2 too (bulk/export flows that
# really do hold canvases), and v1 frames keep decoding unchanged.
#   magic      4s  b"MXR1"
#   version    H   2
#   dtype      H   DTYPE_U8 | DTYPE_F32 (payload element layout)
#   h, w, c    HHH payload dims (u8: unpadded source, h<=bh w<=bw;
#                  f32: the full bucket canvas, h==bh w==bw)
#   bh, bw     HH  target bucket (validated against configured buckets
#                  at admission — a lying bucket costs a 400)
#   flags      H   same carve-out as v1 (bit 0 = trace extension)
#   timeout_ms f   remaining budget (head-owned deadline remainder)
#   im_info    3f  head-computed (h*s, w*s, s) record
WIRE_VERSION_SRC = 2
DTYPE_F32 = 0
DTYPE_U8 = 1
_DTYPE_ITEMSIZE = {DTYPE_F32: 4, DTYPE_U8: 1}
_REQ_HEAD2 = struct.Struct("<4sHHHHHHHHf3f")

# --- multi-frame envelopes (frame coalescing) -----------------------------
# A worker that finds several binary frames queued packs up to
# `crosshost.frames_per_send` of them into ONE count-prefixed envelope:
# one sendmsg, one HTTP round trip, one agent wakeup for the lot.  Each
# member is a complete MXR1 frame (v1 or v2, each with its own trace
# ctx); the result envelope answers with a PER-FRAME terminal status so
# every frame keeps its own served/shed/expired/failed semantics — the
# envelope only amortizes transport, never terminal accounting.
ENV_MAGIC = b"MXE1"          # request envelope
ENV_RESULT_MAGIC = b"MXF1"   # response envelope
ENV_VERSION = 1
_ENV_HEAD = struct.Struct("<4sHH")   # magic, version, frame count
_ENV_LEN = struct.Struct("<I")       # per-frame byte-length prefix
_ENV_RENTRY = struct.Struct("<HI")   # per-frame status, payload length
# per-frame terminal status codes in a result envelope
ENV_SERVED, ENV_SHED, ENV_EXPIRED, ENV_FAILED = 0, 1, 2, 3
_ENV_STATUSES = (ENV_SERVED, ENV_SHED, ENV_EXPIRED, ENV_FAILED)
# count-prefix sanity bound: frames_per_send is single digits in any
# sane config; a count-prefix lie is refused before any allocation
MAX_ENV_FRAMES = 256

FRAME_CTYPE = "application/x-mxrcnn-frame"
ENVELOPE_CTYPE = "application/x-mxrcnn-envelope"


def encode_prepared_parts(data: np.ndarray, im_info: np.ndarray,
                          timeout_ms: float,
                          ctx: "obs_trace.TraceContext" = None) -> list:
    """Zero-copy encode: the v1 frame as a list of buffers (header
    bytes, memoryview of the canvas's raw C-order bytes, optional trace
    blob) whose concatenation is byte-for-byte :func:`encode_prepared`.
    The hot path hands this list straight to ``socket.sendmsg`` iovecs
    (``netio.sendmsg_all``) — the canvas is never copied into a request
    body; the memoryview keeps the array alive until shipped."""
    a = np.ascontiguousarray(data, dtype=np.float32)
    if a.ndim != 3:
        raise ValueError(f"prepared frame wants (h, w, c), got {a.shape}")
    h, w, c = a.shape
    info = np.asarray(im_info, np.float32).reshape(3)
    flags = 0 if ctx is None else WIRE_F_TRACE
    head = _REQ_HEAD.pack(WIRE_MAGIC, WIRE_VERSION, h, w, c, flags,
                          float(timeout_ms or 0.0),
                          float(info[0]), float(info[1]), float(info[2]))
    parts = [head, memoryview(a).cast("B")]
    if ctx is not None:
        parts.append(obs_trace.encode_ctx(ctx))
    return parts


def encode_prepared(data: np.ndarray, im_info: np.ndarray,
                    timeout_ms: float,
                    ctx: "obs_trace.TraceContext" = None) -> bytes:
    """(bh, bw, 3) fp32 canvas + (3,) im_info → one request frame.
    The payload is the array's raw C-order bytes — encode/decode is a
    memcpy, and the agent reconstructs a bit-identical array.

    ``ctx=None`` (the untraced default) produces bytes BIT-IDENTICAL to
    the pre-trace layout (flags field 0, nothing appended); a trace
    context appends the compact extension blob and sets the flag bit."""
    return b"".join(encode_prepared_parts(data, im_info, timeout_ms,
                                          ctx=ctx))


def encode_source_parts(img: np.ndarray, im_info: np.ndarray,
                        bucket: Tuple[int, int], timeout_ms: float,
                        ctx: "obs_trace.TraceContext" = None) -> list:
    """Zero-copy encode of a v2 u8 source frame: the resized-but-
    unnormalized (h, w, 3) uint8 image, the bucket it serves in and the
    head-computed im_info, as sendmsg-ready buffers (header bytes +
    memoryview of the pixels + optional trace blob).  1 byte/pixel on
    the wire against v1's 4 — the agent rebuilds the identical fp32
    canvas with the shared ``data/image.py pad_normalize``."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"source frame must be uint8, got {a.dtype}")
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"source frame wants (h, w, 3), got {a.shape}")
    h, w, c = a.shape
    bh, bw = int(bucket[0]), int(bucket[1])
    if h > bh or w > bw:
        raise ValueError(f"source image ({h}, {w}) does not fit bucket "
                         f"({bh}, {bw})")
    info = np.asarray(im_info, np.float32).reshape(3)
    flags = 0 if ctx is None else WIRE_F_TRACE
    head = _REQ_HEAD2.pack(WIRE_MAGIC, WIRE_VERSION_SRC, DTYPE_U8,
                           h, w, c, bh, bw, flags,
                           float(timeout_ms or 0.0),
                           float(info[0]), float(info[1]), float(info[2]))
    parts = [head, memoryview(a).cast("B")]
    if ctx is not None:
        parts.append(obs_trace.encode_ctx(ctx))
    return parts


def encode_source(img: np.ndarray, im_info: np.ndarray,
                  bucket: Tuple[int, int], timeout_ms: float,
                  ctx: "obs_trace.TraceContext" = None) -> bytes:
    """Bytes variant of :func:`encode_source_parts` (tests, fuzz
    corpus, anything that wants one buffer)."""
    return b"".join(encode_source_parts(img, im_info, bucket, timeout_ms,
                                        ctx=ctx))


class WireFrame(NamedTuple):
    """One decoded request frame, version-agnostic: ``data`` is either
    the unpadded u8 source image (``dtype == DTYPE_U8``) or the full
    fp32 bucket canvas (``dtype == DTYPE_F32``); ``bucket`` is the lane
    it serves in either way."""

    version: int
    dtype: int
    data: np.ndarray
    bucket: Tuple[int, int]
    im_info: np.ndarray
    timeout_ms: float
    ctx: Optional["obs_trace.TraceContext"]


def decode_frame_ex(buf) -> WireFrame:
    """Request frame (v1 OR v2) → :class:`WireFrame`; ValueError on any
    malformed frame — same typed-rejection discipline as
    :func:`decode_prepared_ex` (which stays v1-only).  The v2 additions
    each reject rather than
    degrade: an unknown dtype tag, a dtype/length disagreement (a u8
    frame claiming an fp32 length must never be reinterpreted), a
    source image that does not fit its claimed bucket, an fp32 frame
    that is not a full canvas."""
    if len(buf) < 8:
        raise ValueError(f"frame truncated at {len(buf)} bytes")
    magic, ver = struct.unpack_from("<4sH", buf)
    if magic != WIRE_MAGIC:
        raise ValueError(f"bad frame magic {bytes(magic)!r}")
    if ver == WIRE_VERSION:
        data, im_info, timeout_ms, ctx = decode_prepared_ex(buf)
        return WireFrame(WIRE_VERSION, DTYPE_F32, data,
                         tuple(data.shape[:2]), im_info, timeout_ms, ctx)
    if ver != WIRE_VERSION_SRC:
        raise ValueError(f"unsupported wire version {ver}")
    if len(buf) < _REQ_HEAD2.size:
        raise ValueError(f"v2 frame header truncated at {len(buf)} bytes")
    (_magic, _ver, dtype, h, w, c, bh, bw, flags, timeout_ms,
     i0, i1, i2) = _REQ_HEAD2.unpack_from(buf)
    if dtype not in _DTYPE_ITEMSIZE:
        raise ValueError(f"unknown frame dtype tag {dtype}")
    if flags & ~WIRE_F_TRACE:
        raise ValueError(f"unknown frame flags {flags:#x}")
    check_timeout_ms(timeout_ms)
    if c != 3:
        raise ValueError(f"frame wants 3 channels, got {c}")
    if h <= 0 or w <= 0 or h > bh or w > bw:
        raise ValueError(f"frame dims ({h}, {w}) do not fit bucket "
                         f"({bh}, {bw})")
    if dtype == DTYPE_F32 and (h != bh or w != bw):
        raise ValueError(f"fp32 v2 frame must be a full ({bh}, {bw}) "
                         f"canvas, got ({h}, {w})")
    want = _REQ_HEAD2.size + h * w * c * _DTYPE_ITEMSIZE[dtype]
    ctx = None
    if flags & WIRE_F_TRACE:
        if len(buf) <= want:
            raise ValueError("frame flags declare a trace extension "
                             "but none is present")
        ctx = obs_trace.decode_ctx(bytes(buf[want:]))
    elif len(buf) != want:
        raise ValueError(f"frame is {len(buf)} bytes, header asks {want}")
    np_dtype = np.float32 if dtype == DTYPE_F32 else np.uint8
    data = np.frombuffer(buf, np_dtype, count=h * w * c,
                         offset=_REQ_HEAD2.size)
    data = data.reshape(h, w, c).copy()  # own the memory (buf transient)
    return WireFrame(WIRE_VERSION_SRC, dtype, data, (int(bh), int(bw)),
                     np.array([i0, i1, i2], np.float32),
                     float(timeout_ms), ctx)


def encode_envelope_parts(frame_parts: list) -> list:
    """N frames (each a parts list from ``encode_*_parts``) → one
    request envelope, still as sendmsg-ready buffers: the envelope head
    and per-frame length prefixes interleave with the frames' own
    buffers, so coalescing adds 10 + 4N bytes and ZERO payload copies."""
    if not frame_parts:
        raise ValueError("empty envelope")
    if len(frame_parts) > MAX_ENV_FRAMES:
        raise ValueError(f"envelope of {len(frame_parts)} frames over "
                         f"the {MAX_ENV_FRAMES} cap")
    out = [_ENV_HEAD.pack(ENV_MAGIC, ENV_VERSION, len(frame_parts))]
    for fp in frame_parts:
        out.append(_ENV_LEN.pack(sum(len(p) for p in fp)))
        out.extend(fp)
    return out


def decode_envelope(buf) -> List[bytes]:
    """Request envelope → list of member frame buffers; ValueError on
    ANY malformation (bad magic/version, count outside [1, cap], a
    length prefix past the bytes actually present, trailing bytes).
    Member lengths are checked against bytes on hand BEFORE any slice —
    a count-prefix or length-prefix lie costs a rejection, never an
    allocation.  Members are returned undecoded; the caller runs
    :func:`decode_frame_ex` per member and rejects the WHOLE envelope
    on any malformed member (the head builds envelopes itself, so a bad
    member means corruption, not a mixed batch)."""
    if len(buf) < _ENV_HEAD.size:
        raise ValueError(f"envelope truncated at {len(buf)} bytes")
    magic, ver, count = _ENV_HEAD.unpack_from(buf)
    if magic != ENV_MAGIC:
        raise ValueError(f"bad envelope magic {bytes(magic)!r}")
    if ver != ENV_VERSION:
        raise ValueError(f"unsupported envelope version {ver}")
    if not 1 <= count <= MAX_ENV_FRAMES:
        raise ValueError(f"envelope frame count {count} outside "
                         f"[1, {MAX_ENV_FRAMES}]")
    off = _ENV_HEAD.size
    out: List[bytes] = []
    for i in range(count):
        if off + _ENV_LEN.size > len(buf):
            raise ValueError(f"frame {i} length prefix truncated")
        (n,) = _ENV_LEN.unpack_from(buf, off)
        off += _ENV_LEN.size
        if n > len(buf) - off:
            raise ValueError(f"frame {i} claims {n} bytes, "
                             f"{len(buf) - off} remain")
        out.append(bytes(buf[off:off + n]))
        off += n
    if off != len(buf):
        raise ValueError(f"{len(buf) - off} trailing bytes after "
                         f"envelope")
    return out


def encode_result_envelope(entries: List[Tuple[int, bytes]]) -> bytes:
    """[(status, payload)] → one response envelope.  ENV_SERVED entries
    carry an MXD1 result frame; failure entries carry UTF-8 error text
    (possibly empty)."""
    parts = [_ENV_HEAD.pack(ENV_RESULT_MAGIC, ENV_VERSION, len(entries))]
    for status, payload in entries:
        parts.append(_ENV_RENTRY.pack(int(status), len(payload)))
        parts.append(payload)
    return b"".join(parts)


def decode_result_envelope(buf) -> List[Tuple[int, bytes]]:
    """Response envelope → [(status, payload)]; ValueError on any
    malformation.  The CALLER checks the entry count against the frames
    it sent — a count mismatch fails every frame (reroute), never a
    positional guess."""
    if len(buf) < _ENV_HEAD.size:
        raise ValueError(f"result envelope truncated at {len(buf)} bytes")
    magic, ver, count = _ENV_HEAD.unpack_from(buf)
    if magic != ENV_RESULT_MAGIC:
        raise ValueError(f"bad result envelope magic {bytes(magic)!r}")
    if ver != ENV_VERSION:
        raise ValueError(f"unsupported envelope version {ver}")
    if not 1 <= count <= MAX_ENV_FRAMES:
        raise ValueError(f"result envelope count {count} outside "
                         f"[1, {MAX_ENV_FRAMES}]")
    off = _ENV_HEAD.size
    out: List[Tuple[int, bytes]] = []
    for i in range(count):
        if off + _ENV_RENTRY.size > len(buf):
            raise ValueError(f"result entry {i} header truncated")
        status, n = _ENV_RENTRY.unpack_from(buf, off)
        off += _ENV_RENTRY.size
        if status not in _ENV_STATUSES:
            raise ValueError(f"result entry {i} has unknown status "
                             f"{status}")
        if n > len(buf) - off:
            raise ValueError(f"result entry {i} claims {n} bytes, "
                             f"{len(buf) - off} remain")
        out.append((int(status), bytes(buf[off:off + n])))
        off += n
    if off != len(buf):
        raise ValueError(f"{len(buf) - off} trailing bytes after "
                         f"result envelope")
    return out


def decode_prepared_ex(buf: bytes) -> Tuple[
        np.ndarray, np.ndarray, float,
        Optional["obs_trace.TraceContext"]]:
    """Request frame → (canvas, im_info, timeout_ms, trace_ctx | None);
    raises ValueError on any malformed frame (bad magic/version/length/
    flags/extension) so the agent can answer 400 instead of crashing a
    handler.  Flag-less frames (the untraced layout) decode unchanged with
    ctx None — back-compat is a pinned contract, and a malformed trace
    extension REJECTS the frame rather than degrading to untraced."""
    if len(buf) < _REQ_HEAD.size:
        raise ValueError(f"frame truncated at {len(buf)} bytes")
    (magic, ver, h, w, c, flags, timeout_ms,
     i0, i1, i2) = _REQ_HEAD.unpack_from(buf)
    if magic != WIRE_MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    if ver != WIRE_VERSION:
        raise ValueError(f"unsupported wire version {ver}")
    if flags & ~WIRE_F_TRACE:
        raise ValueError(f"unknown frame flags {flags:#x}")
    # a flipped bit in the timeout float must not smuggle inf/NaN into
    # deadline arithmetic (inf reaches Condition.wait as OverflowError)
    check_timeout_ms(timeout_ms)
    want = _REQ_HEAD.size + h * w * c * 4
    ctx = None
    if flags & WIRE_F_TRACE:
        if len(buf) <= want:
            raise ValueError("frame flags declare a trace extension "
                             "but none is present")
        ctx = obs_trace.decode_ctx(buf[want:])  # validates its own length
    elif len(buf) != want:
        raise ValueError(f"frame is {len(buf)} bytes, header asks {want}")
    data = np.frombuffer(buf, np.float32,
                         count=h * w * c, offset=_REQ_HEAD.size)
    data = data.reshape(h, w, c).copy()  # own the memory (buf is transient)
    return data, np.array([i0, i1, i2], np.float32), float(timeout_ms), ctx


def decode_prepared(buf: bytes) -> Tuple[np.ndarray, np.ndarray, float]:
    """The untraced decode surface (canvas, im_info, timeout_ms) — same
    validation as :func:`decode_prepared_ex`, trace context dropped."""
    return decode_prepared_ex(buf)[:3]


def encode_result(dets: Dict[int, np.ndarray],
                  ts_pair: Tuple[float, float] = None) -> bytes:
    """{class_id: (k, 5) fp32} → one result frame (raw fp32 rows — the
    head decodes arrays bit-identical to what the remote demux
    produced).  ``ts_pair`` (agent receive/send epoch-µs stamps, set
    only when the request carried a trace context) appends the skew
    extension and bumps the frame to WIRE_VERSION_TRACED."""
    ver = WIRE_VERSION if ts_pair is None else WIRE_VERSION_TRACED
    parts = [_RESP_HEAD.pack(RESULT_MAGIC, ver, len(dets))]
    for cid in sorted(dets):
        arr = np.ascontiguousarray(dets[cid], dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != 5:
            raise ValueError(f"class {cid} rows must be (k, 5), "
                             f"got {arr.shape}")
        parts.append(_RESP_ENTRY.pack(int(cid), arr.shape[0]))
        parts.append(arr.tobytes())
    if ts_pair is not None:
        parts.append(_RESP_TRACE_EXT.pack(int(ts_pair[0]),
                                          int(ts_pair[1])))
    return b"".join(parts)


def decode_result_ex(buf: bytes) -> Tuple[Dict[int, np.ndarray],
                                          Optional[Tuple[float, float]]]:
    """Result frame → ({class_id: (k, 5) fp32}, ts_pair | None);
    ValueError on malformed frames.  Version 1 (untraced) must end
    exactly at the last entry; version 2 must carry exactly the 16-byte
    skew extension after the entries."""
    if len(buf) < _RESP_HEAD.size:
        raise ValueError(f"result truncated at {len(buf)} bytes")
    magic, ver, n = _RESP_HEAD.unpack_from(buf)
    if magic != RESULT_MAGIC:
        raise ValueError(f"bad result magic {magic!r}")
    if ver not in (WIRE_VERSION, WIRE_VERSION_TRACED):
        raise ValueError(f"unsupported wire version {ver}")
    off = _RESP_HEAD.size
    out: Dict[int, np.ndarray] = {}
    for _ in range(n):
        if off + _RESP_ENTRY.size > len(buf):
            raise ValueError("result entry header truncated")
        cid, k = _RESP_ENTRY.unpack_from(buf, off)
        off += _RESP_ENTRY.size
        nbytes = k * 5 * 4
        if off + nbytes > len(buf):
            raise ValueError(f"class {cid} rows truncated")
        out[cid] = np.frombuffer(buf, np.float32, count=k * 5,
                                 offset=off).reshape(k, 5).copy()
        off += nbytes
    ts_pair = None
    if ver == WIRE_VERSION_TRACED:
        if len(buf) - off != _RESP_TRACE_EXT.size:
            raise ValueError(
                f"traced result wants a {_RESP_TRACE_EXT.size}-byte "
                f"skew extension, found {len(buf) - off} bytes")
        t1, t2 = _RESP_TRACE_EXT.unpack_from(buf, off)
        if t2 < t1:
            raise ValueError("skew extension send stamp precedes receive")
        ts_pair = (float(t1), float(t2))
        off = len(buf)
    if off != len(buf):
        raise ValueError(f"{len(buf) - off} trailing bytes after result")
    return out, ts_pair


def decode_result(buf: bytes) -> Dict[int, np.ndarray]:
    """The untraced decode surface — same validation, ts pair dropped."""
    return decode_result_ex(buf)[0]


def normalize_agent_url(url: str) -> str:
    """'host:port' / full URL → scheme://host:port (no trailing slash)."""
    if "://" not in url:
        url = f"http://{url}"
    return url.rstrip("/")


# ---------------------------------------------------------------------------
# RemoteEngine — the engine-shaped proxy for one agent
# ---------------------------------------------------------------------------

class RemoteTransportError(RuntimeError):
    """A frame died on the wire (connect/send/recv failure) — the fleet
    router sees FAILED and reroutes; it is never surfaced as SHED."""


class _WireConn:
    """One persistent keep-alive socket speaking minimal HTTP/1.1 for
    the data plane — the zero-copy replacement for ``http.client`` on
    the hot path (the control surface keeps ``http.client``).

    Send side: the request goes out as HTTP-head bytes + frame-header
    bytes + memoryview-of-pixels iovecs through ``socket.sendmsg``
    (:func:`~mx_rcnn_tpu_torch.netio.sendmsg_all`) — the payload is never
    concatenated into one transient body (v1 paid a full-canvas
    ``bytes(...)`` copy per request).  Recv side: the response body
    lands in a per-connection buffer reused across requests
    (``recv_into`` — no per-response allocation once the buffer has
    grown to the burst's largest reply).  The returned body view
    aliases that buffer: decode/copy it before the next request."""

    def __init__(self, host: str, port: int, timeout_s: float,
                 max_body: int):
        self._hosthdr = f"{host}:{port}"
        self._timeout = float(timeout_s)
        self._max_body = int(max_body)
        self.sock = socket.create_connection((host, port),
                                             timeout=self._timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._body = bytearray(64 << 10)
        self.keep = True  # False once the peer said Connection: close
        self.tx_bytes = 0
        self.rx_bytes = 0

    def request_parts(self, path: str, ctype: str, parts: list,
                      extra_headers: Dict[str, str] = None
                      ) -> Tuple[int, memoryview]:
        """POST ``parts`` (buffer list, sent vectored) → (status, body
        view).  The view is only valid until the next call."""
        n = sum(len(memoryview(p).cast("B")) for p in parts)
        head = (f"POST {path} HTTP/1.1\r\n"
                f"Host: {self._hosthdr}\r\n"
                f"Content-Type: {ctype}\r\n"
                + "".join(f"{k}: {v}\r\n"
                          for k, v in (extra_headers or {}).items())
                + f"Content-Length: {n}\r\n\r\n").encode("ascii")
        self.tx_bytes += sendmsg_all(self.sock, [head, *parts])
        status, nbody, wants_close = read_http_response_into(
            self.sock, self._body, self._max_body,
            deadline_s=self._timeout * 4, what="agent response")
        self.rx_bytes += nbody
        if wants_close:
            self.keep = False
        return status, memoryview(self._body)[:nbody]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def abort(self) -> None:
        """Wake a thread blocked on this socket from another thread: its
        read sees the end of the stream, its write an error."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


class PipelineController:
    """AIMD per-connection pipeline depth from windowed wire RTT.
    The engine feeds every response's wire RTT;
    once per INTERVAL_S the controller snapshots its private registry
    into a :class:`~mx_rcnn_tpu_torch.obs.timeseries.TimeSeriesStore`
    and retunes: a windowed p50 RTT above ``RTT_FACTOR ×`` the windowed
    RTT floor means frames are queueing behind a slow or skewed agent —
    halve the depth (multiplicative decrease) so in-flight frames stop
    accumulating there; a healthy window in which the pipeline actually
    filled grows it by one (additive increase — taken from depth 1 even
    under a congested verdict, where queueing cannot be self-induced
    and refusing to probe would pin the depth).  Depth is clamped to
    ``[1, depth_max]``; every read/write happens under the lock on
    whatever worker thread noted the sample — no extra thread, no tick
    loop."""

    RTT_FACTOR = 2.0      # congestion verdict: p50 > factor × floor
    INTERVAL_S = 0.25     # retune cadence
    WINDOW_S = 2.0        # RTT judgment window

    def __init__(self, depth: int, depth_max: int, clock=time.monotonic):
        from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore

        self.depth_max = max(1, int(depth_max))
        self._depth = max(1, min(int(depth), self.depth_max))
        self._clock = clock
        self._lock = threading.Lock()
        self._reg = Registry()
        self._store = TimeSeriesStore(capacity=64)
        self._last = clock()
        self._floor = float("inf")  # min RTT since the last retune
        self._full = False          # pipeline filled since last retune
        self.retunes = 0
        self.depth_peak = self._depth  # high-water mark (bench/debug)

    def current(self) -> int:
        with self._lock:
            return self._depth

    def note_full(self) -> None:
        """The engine's admission gate found the pipeline at capacity —
        the additive-increase appetite signal."""
        with self._lock:
            self._full = True

    def note_rtt(self, rtt_ms: float, now: float = None) -> bool:
        """Feed one wire RTT sample; returns True when a retune ran
        (the engine republishes its depth gauge on True)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._reg.observe("wire.rtt_ms", float(rtt_ms))
            if rtt_ms < self._floor:
                self._floor = float(rtt_ms)
            if now - self._last < self.INTERVAL_S:
                return False
            self._retune(now)
            return True

    def _retune(self, now: float) -> None:
        # publish the interval's floor/fill as gauges, snapshot, judge
        # the WINDOW (several intervals) — one slow interval does not
        # whipsaw the depth, a sustained drift does
        if self._floor != float("inf"):
            self._reg.set_gauge("wire.rtt_floor_ms", self._floor)
        self._reg.set_gauge("wire.pipe_full", 1.0 if self._full else 0.0)
        self._store.sample(reg=self._reg, ts=now)
        p50 = self._store.pctl("wire.rtt_ms", 50, window_s=self.WINDOW_S)
        floor = self._store.gauge_min("wire.rtt_floor_ms",
                                      window_s=self.WINDOW_S)
        congested = (p50 is not None and floor is not None and floor > 0
                     and p50 > self.RTT_FACTOR * floor)
        if congested and self._depth > 1:
            self._depth = max(1, self._depth // 2)
        elif self._full:
            # additive increase — taken from depth 1 even under a
            # congested verdict: with one frame per connection there is
            # no SELF-induced queueing, so the dispersion is exogenous
            # (slow agent, shared core, batching jitter) and
            # suppressing the probe would pin the engine at depth 1
            # forever; probing 1→2 and getting halved back IS the AIMD
            # steady state against a genuinely slow agent
            self._depth = min(self._depth + 1, self.depth_max)
        self.depth_peak = max(self.depth_peak, self._depth)
        self._full = False  # threadlint: disable=TL201 guarded by self._lock at the only call site (note_rtt)
        self._floor = float("inf")
        self._last = now
        self.retunes += 1


class RemoteEngine:
    """Duck-types the :class:`~mx_rcnn_tpu_torch.serve.engine.ServingEngine`
    fleet surface (submit / submit_prepared / depth / bucket_depth /
    alive / kill / close / healthz / metrics) over persistent HTTP
    connections to one per-host agent.

    ``wire`` selects the prepared-path framing: "binary" (the default —
    the raw-fp32 frame above) or "json" (base64 canvas in a JSON body,
    kept ONLY as the A/B control arm ``tools/loadgen.py
    --crosshost_bench`` measures the binary format against).
    """

    def __init__(self, name: str, url: str, cfg: Config,
                 wire: str = "binary", probe: bool = True):
        if wire not in ("binary", "json"):
            raise ValueError(f"wire must be binary|json, got {wire!r}")
        self.name = name
        self.cfg = cfg
        self.wire = wire
        self.agent_url = normalize_agent_url(url)
        parts = urlsplit(self.agent_url)
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        cc = cfg.crosshost
        self._n_conns = max(1, int(cc.connections))
        self._capacity = self._n_conns * max(1, int(cc.pipeline_depth))
        # frame coalescing: a worker packs up to this many
        # queued binary frames into one envelope per send; 1 = off
        self._frames_per_send = max(1, min(int(cc.frames_per_send),
                                           MAX_ENV_FRAMES))
        # adaptive pipelining: pipeline_depth_max > 0
        # replaces the fixed per-connection depth with an AIMD
        # controller in [1, max] fed by wire RTT
        self._pipe: Optional[PipelineController] = None
        if int(cc.pipeline_depth_max) > 0:
            self._pipe = PipelineController(
                max(1, int(cc.pipeline_depth)),
                int(cc.pipeline_depth_max))
        self._io_timeout = float(cc.io_timeout_s)
        # scraped lane hints decay: a feed that stopped resolving this
        # agent (collector backoff, relaunch gap) must not pin phantom
        # JSQ depth forever — past the ttl only local accounting counts
        self._lane_ttl_s = max(6.0 * float(cc.scrape_interval_s), 0.5)
        self._scraped_at = 0.0   # monotonic stamp of the last hint
        # response-body buffering cap: a misbehaving agent streaming
        # past it costs a RemoteTransportError (FAILED -> reroute),
        # never an unbounded head-side allocation
        self._max_body = int(float(cc.max_body_mb) * (1 << 20))
        self._dead_after = max(1, int(cc.dead_after_failures))
        self.metrics = ServeMetrics()  # private registry (fleet idiom)
        self._cond = threading.Condition()
        self._q: deque = deque()          # (req, kind) frames to ship
        self._closed = False
        self._killed = False    # ejected: no reconnect, no retry
        self._conns: set = set()          # the workers' open _WireConns
        # liveness: transport and scrape failures counted separately —
        # a scrape flake must not stack onto a served-traffic blip
        self._fail_lock = threading.Lock()
        self._transport_failures = 0
        self._scrape_failures = 0
        self.conns_opened = 0  # the keep-alive pin
        # remote lane backlog: last scraped depths + frames we have
        # admitted that are not yet terminal, per bucket
        self._lane_lock = threading.Lock()
        self._scraped_lanes: Dict[Tuple[int, int], float] = {}
        self._local_pending: Dict[Tuple[int, int], int] = {}
        self._last_healthz: Dict = {}
        self._export_root = None
        self.join_info: Dict = {}
        if probe:
            h = self.healthz()  # raises on a dead agent → launch fails
            if not h.get("ok", False):
                raise RemoteTransportError(
                    f"agent {self.agent_url} reports not ok: {h}")
            self._export_root = h.get("export_root")
            self.join_info = {k: h[k] for k in
                              ("store_pull", "replicas", "warm_s")
                              if k in h}
            if h.get("export_root"):
                self.join_info["export_root"] = h["export_root"]
        self._threads = [
            threading.Thread(target=self._worker, name=f"{name}-conn{i}",
                             daemon=True)
            for i in range(self._n_conns)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    # admission (the fleet router's dispatch target)
    # ------------------------------------------------------------------

    def submit_prepared(self, data: np.ndarray, im_info: np.ndarray,
                        bucket: Tuple[int, int],
                        timeout_ms: float = None,
                        tctx: "obs_trace.TraceContext" = None
                        ) -> ServeRequest:
        bucket = tuple(bucket)
        if tuple(data.shape) != bucket + (3,):
            raise ValueError(f"prepared data shape {tuple(data.shape)} "
                             f"does not match bucket {bucket}")
        if data.dtype != np.float32:
            raise ValueError(f"prepared data must be float32, "
                             f"got {data.dtype}")
        now = time.monotonic()
        t = (self.cfg.serve.default_timeout_ms if timeout_ms is None
             else timeout_ms)
        deadline = now + t / 1000.0 if t and t > 0 else None
        req = ServeRequest(data, np.asarray(im_info, np.float32), bucket,
                           deadline, now)
        req.tctx = tctx
        return self._admit(req, "prepared")

    def submit_source(self, img: np.ndarray, im_info: np.ndarray,
                      bucket: Tuple[int, int],
                      timeout_ms: float = None,
                      tctx: "obs_trace.TraceContext" = None
                      ) -> ServeRequest:
        """v2 hot path: ship the resized-but-unnormalized u8 source
        image (1 B/px on the wire — the agent pays the deterministic
        pad+normalize).  Same admission/terminal semantics as
        :meth:`submit_prepared`; the source pixels ride the request, so
        a router reroute re-ships the same small frame elsewhere."""
        bucket = tuple(int(b) for b in bucket)
        a = np.ascontiguousarray(img)
        if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
            raise ValueError(f"source image must be uint8 (h, w, 3), "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.shape[0] > bucket[0] or a.shape[1] > bucket[1]:
            raise ValueError(f"source image {tuple(a.shape[:2])} does "
                             f"not fit bucket {bucket}")
        now = time.monotonic()
        t = (self.cfg.serve.default_timeout_ms if timeout_ms is None
             else timeout_ms)
        deadline = now + t / 1000.0 if t and t > 0 else None
        req = ServeRequest(a, np.asarray(im_info, np.float32), bucket,
                           deadline, now)
        req.tctx = tctx
        return self._admit(req, "source")

    def submit(self, img: np.ndarray,
               timeout_ms: float = None,
               tctx: "obs_trace.TraceContext" = None) -> ServeRequest:
        """Raw-image control path: ships JSON to the agent's /detect
        (the agent preprocesses server-side — same pixels as local
        serving by construction)."""
        from mx_rcnn_tpu_torch.data.image import estimate_bucket

        now = time.monotonic()
        t = (self.cfg.serve.default_timeout_ms if timeout_ms is None
             else timeout_ms)
        deadline = now + t / 1000.0 if t and t > 0 else None
        h, w = img.shape[:2]
        bucket = estimate_bucket(h, w, self.cfg.bucket.scale,
                                 self.cfg.bucket.max_size,
                                 self.cfg.bucket.shapes)
        req = ServeRequest(np.ascontiguousarray(img), None, bucket,
                           deadline, now)
        req.tctx = tctx
        return self._admit(req, "detect")

    def _capacity_now(self) -> int:
        """connections × pipeline depth — the fixed config product, or
        the controller's current depth when adaptive."""
        if self._pipe is not None:
            return self._n_conns * self._pipe.current()
        return self._capacity

    def _admit(self, req: ServeRequest, kind: str) -> ServeRequest:
        self.metrics.count("submitted")
        with self._cond:
            cap = self._capacity_now()
            in_flight = self.metrics.in_flight()
            if self._pipe is not None and in_flight >= cap:
                self._pipe.note_full()
            shed = self._closed or in_flight > cap
            if not shed:
                self._q.append((req, kind))
                with self._lane_lock:
                    self._local_pending[req.bucket] = \
                        self._local_pending.get(req.bucket, 0) + 1
                self._cond.notify()
        if shed:
            if req._finish(SHED):
                self.metrics.count("shed")
        return req

    # ------------------------------------------------------------------
    # wire workers (one persistent connection each)
    # ------------------------------------------------------------------

    def _worker(self) -> None:
        # the connection lives in a worker-LOCAL holder: each worker is
        # one persistent keep-alive connection for its whole life (the
        # reuse pin: conns_opened == connections after any burst)
        holder = {"conn": None}
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait(0.5)
                if self._closed and not self._q:
                    break
                batch = [self._q.popleft()]
                # coalescing: opportunistically pack the
                # binary frames already queued behind this one — up to
                # frames_per_send — into one envelope send.  Latency
                # is untouched when the queue is shallow (a lone frame
                # ships alone, immediately); at burst depth the
                # header + syscall + wakeup tax amortizes across the
                # batch.  JSON kinds (A/B control arms) never coalesce.
                if (self.wire == "binary" and self._frames_per_send > 1
                        and batch[0][1] in ("prepared", "source")):
                    while (self._q
                           and len(batch) < self._frames_per_send
                           and self._q[0][1] in ("prepared", "source")):
                        batch.append(self._q.popleft())
            if len(batch) == 1:
                self._ship(batch[0][0], batch[0][1], holder)
            else:
                self._ship_envelope(batch, holder)
        self._drop_conn(holder)

    def _get_conn(self, holder) -> _WireConn:
        if holder["conn"] is None:
            if self._killed:
                raise RemoteTransportError("replica killed")
            conn = _WireConn(self._host, self._port, self._io_timeout,
                             self._max_body)
            with self._cond:
                killed = self._killed
                if not killed:
                    self._conns.add(conn)
            if killed:  # the eject came while this one connected
                conn.close()
                raise RemoteTransportError("replica killed")
            holder["conn"] = conn
            with self._fail_lock:
                self.conns_opened += 1
        return holder["conn"]

    def _drop_conn(self, holder) -> None:
        conn, holder["conn"] = holder["conn"], None
        if conn is not None:
            with self._cond:
                self._conns.discard(conn)
            try:
                conn.close()
            except Exception:
                pass

    def _note_rtt(self, rtt_ms: float) -> None:
        self.metrics.observe("wire_rtt_ms", rtt_ms)
        if self._pipe is not None and self._pipe.note_rtt(rtt_ms):
            self.metrics.registry.set_gauge(
                "serve.pipeline_depth", float(self._pipe.current()))

    def _count_wire(self, conn: _WireConn, frames: int) -> None:
        """Fold the connection's byte deltas into the engine metrics —
        the bench's bytes/image accounting reads these counters."""
        tx, conn.tx_bytes = conn.tx_bytes, 0
        rx, conn.rx_bytes = conn.rx_bytes, 0
        self.metrics.count("wire_tx_bytes", tx)
        self.metrics.count("wire_rx_bytes", rx)
        self.metrics.count("wire_frames", frames)
        self.metrics.count("wire_sends")

    def _ship(self, req: ServeRequest, kind: str, holder) -> None:
        now = time.monotonic()
        if req.expired(now):
            self._terminate(req, EXPIRED)
            return
        remaining_ms = ((req.deadline - now) * 1000.0
                        if req.deadline is not None else 0.0)
        # trace shipping: allocate the wire span HERE so the agent's
        # root span can parent under it; the untraced path pays exactly
        # one None-check
        ctx = req.tctx
        wire_sid = 0
        ship_ctx = None
        extra = None
        if ctx is not None:
            wire_sid = obs_trace.new_span_id()
            ship_ctx = ctx.child(wire_sid)
        if kind in ("prepared", "source") and self.wire == "binary":
            path = "/prepared"
            ctype = FRAME_CTYPE
            # zero-copy: the frame is a buffer list — the
            # pixels go onto the wire as a memoryview iovec, never
            # concatenated into a transient request body
            if kind == "source":
                parts = encode_source_parts(req.image, req.im_info,
                                            req.bucket, remaining_ms,
                                            ctx=ship_ctx)
            else:
                parts = encode_prepared_parts(req.image, req.im_info,
                                              remaining_ms, ctx=ship_ctx)
        elif kind in ("prepared", "source"):
            # the JSON/base64 A/B control arm (fp32 canvas either way:
            # a "json" engine ships source frames as prepared rows so
            # the arm isolates the codec, not the payload dtype)
            canvas = req.image
            if kind == "source":
                from mx_rcnn_tpu_torch.data.image import pad_normalize
                canvas = pad_normalize(req.image,
                                       self.cfg.network.pixel_means,
                                       req.bucket)
            path = "/prepared_json"
            ctype = "application/json"
            parts = [json.dumps({
                "data_b64": base64.b64encode(
                    np.ascontiguousarray(canvas).tobytes()).decode(),
                "shape": list(canvas.shape),
                "im_info": [float(v) for v in req.im_info],
                "timeout_ms": remaining_ms,
            }).encode()]
        else:  # detect: raw image JSON control path
            parts = [json.dumps({
                "pixels_b64": base64.b64encode(req.image.tobytes()).decode(),
                "shape": list(req.image.shape),
                "timeout_ms": remaining_ms,
                "raw_dets": True,
            }).encode()]
            path = "/detect"
            ctype = "application/json"
        if ship_ctx is not None and ctype == "application/json":
            extra = {obs_trace.TRACE_HEADER:
                     obs_trace.format_header(ship_ctx)}
        t0_us = obs_trace.epoch_us() if ctx is not None else 0
        t_send = time.monotonic()
        # one transparent retry on a fresh connection: a keep-alive
        # socket the agent's server idled out raises on the FIRST write
        # after reuse — that is connection staleness, not host death
        for attempt in (0, 1):
            try:
                conn = self._get_conn(holder)
                status, payload = conn.request_parts(path, ctype, parts,
                                                     extra_headers=extra)
            except Exception as e:
                self._drop_conn(holder)
                if (attempt == 0 and not self._killed
                        and not req.expired(time.monotonic())):
                    continue
                self._note_transport(ok=False)
                if ctx is not None:
                    t3_us = obs_trace.epoch_us()
                    obs_trace.record_span(
                        ctx, "remote.wire", (t3_us - t0_us) / 1e3,
                        span_id=wire_sid, t1_us=t3_us,
                        engine=self.name, outcome="transport_error")
                self._terminate(req, FAILED,
                                error=RemoteTransportError(
                                    f"{self.agent_url}{path}: {e}"))
                return
            self._note_transport(ok=True)
            self._note_rtt((time.monotonic() - t_send) * 1e3)
            self._count_wire(conn, frames=1)
            self._finish_from_response(req, kind, status, payload,
                                       ctx=ctx, wire_sid=wire_sid,
                                       t0_us=t0_us)
            if not conn.keep:
                self._drop_conn(holder)
            return

    def _ship_envelope(self, batch, holder) -> None:
        """Ship >= 2 coalesced binary frames as one MXE1 envelope and
        terminate each member from the per-frame status in the MXF1
        reply.  Terminal semantics are exactly the single-frame path's,
        applied per member: a transport error (after the one
        transparent fresh-socket retry) FAILs every frame — the router
        reroutes each within its own deadline, so a partially-sent
        envelope's frames each terminate exactly once elsewhere."""
        now = time.monotonic()
        live = []
        for req, kind in batch:
            if req.expired(now):
                self._terminate(req, EXPIRED)
            else:
                live.append((req, kind))
        if not live:
            return
        if len(live) == 1:
            self._ship(live[0][0], live[0][1], holder)
            return
        frames = []
        metas = []   # (req, ctx, wire_sid) aligned with frames
        for req, kind in live:
            remaining_ms = ((req.deadline - now) * 1000.0
                            if req.deadline is not None else 0.0)
            ctx = req.tctx
            wire_sid = 0
            ship_ctx = None
            if ctx is not None:
                wire_sid = obs_trace.new_span_id()
                ship_ctx = ctx.child(wire_sid)
            if kind == "source":
                frames.append(encode_source_parts(
                    req.image, req.im_info, req.bucket, remaining_ms,
                    ctx=ship_ctx))
            else:
                frames.append(encode_prepared_parts(
                    req.image, req.im_info, remaining_ms, ctx=ship_ctx))
            metas.append((req, ctx, wire_sid))
        parts = encode_envelope_parts(frames)
        traced = any(m[1] is not None for m in metas)
        t0_us = obs_trace.epoch_us() if traced else 0
        t_send = time.monotonic()
        for attempt in (0, 1):
            try:
                conn = self._get_conn(holder)
                status, payload = conn.request_parts(
                    "/frames", ENVELOPE_CTYPE, parts)
            except Exception as e:
                self._drop_conn(holder)
                if attempt == 0 and not self._killed and not any(
                        req.expired(time.monotonic())
                        for req, _ in live):
                    continue
                self._note_transport(ok=False)
                err = RemoteTransportError(
                    f"{self.agent_url}/frames: {e}")
                t3_us = obs_trace.epoch_us() if traced else 0
                for req, ctx, wire_sid in metas:
                    if ctx is not None:
                        obs_trace.record_span(
                            ctx, "remote.wire", (t3_us - t0_us) / 1e3,
                            span_id=wire_sid, t1_us=t3_us,
                            engine=self.name, frames=len(metas),
                            outcome="transport_error")
                    self._terminate(req, FAILED, error=err)
                return
            break
        self._note_transport(ok=True)
        self._note_rtt((time.monotonic() - t_send) * 1e3)
        self._count_wire(conn, frames=len(metas))
        self.metrics.count("envelopes")
        t3_us = obs_trace.epoch_us() if traced else 0
        try:
            if status != 200:
                raise ValueError(f"agent answered {status}: "
                                 f"{bytes(payload[:200])!r}")
            entries = decode_result_envelope(payload)
            if len(entries) != len(metas):
                raise ValueError(f"result envelope has {len(entries)} "
                                 f"entries for {len(metas)} frames")
        except ValueError as e:
            # a malformed/short reply fails EVERY member (reroute) —
            # positional guessing could terminate the wrong request
            err = RemoteTransportError(f"bad envelope response: {e}")
            for req, ctx, wire_sid in metas:
                if ctx is not None:
                    obs_trace.record_span(
                        ctx, "remote.wire", (t3_us - t0_us) / 1e3,
                        span_id=wire_sid, t1_us=t3_us,
                        engine=self.name, frames=len(metas),
                        status=int(status))
                self._terminate(req, FAILED, error=err)
            if not conn.keep:
                self._drop_conn(holder)
            return
        for (req, ctx, wire_sid), (st, pl) in zip(metas, entries):
            if ctx is not None:
                obs_trace.record_span(
                    ctx, "remote.wire", (t3_us - t0_us) / 1e3,
                    span_id=wire_sid, t1_us=t3_us,
                    engine=self.name, frames=len(metas), status=int(st))
            if st == ENV_SERVED:
                try:
                    dets, ts_pair = decode_result_ex(pl)
                except ValueError as e:
                    self._terminate(req, FAILED,
                                    error=RemoteTransportError(
                                        f"bad response payload: {e}"))
                    continue
                if ctx is not None and ts_pair is not None:
                    obs_trace.skew().note(self.name, t0_us, ts_pair[0],
                                          ts_pair[1], t3_us)
                self._terminate(req, SERVED, result=dets)
            elif st == ENV_SHED:
                self._terminate(req, SHED)
            elif st == ENV_EXPIRED:
                self._terminate(req, EXPIRED)
            else:
                self._terminate(req, FAILED,
                                error=RemoteTransportError(
                                    f"agent frame failed: "
                                    f"{pl[:200].decode(errors='replace')}"))
        if not conn.keep:
            self._drop_conn(holder)

    def _finish_from_response(self, req: ServeRequest, kind: str,
                              status: int, payload: bytes,
                              ctx: "obs_trace.TraceContext" = None,
                              wire_sid: int = 0, t0_us: int = 0) -> None:
        t3_us = obs_trace.epoch_us() if ctx is not None else 0
        dets = None
        decode_err = None
        try:
            if status == 200:
                if kind in ("prepared", "source") and self.wire == "binary":
                    dets, ts_pair = decode_result_ex(payload)
                    if ctx is not None and ts_pair is not None:
                        # NTP-style skew sample from the (t0, t1, t2, t3)
                        # stamp quartet riding this response
                        obs_trace.skew().note(self.name, t0_us,
                                              ts_pair[0], ts_pair[1],
                                              t3_us)
                else:
                    body = json.loads(bytes(payload).decode())
                    dets = {int(c): np.asarray(
                        np.frombuffer(base64.b64decode(rows), np.float32)
                        .reshape(-1, 5))
                        for c, rows in body["dets_b64"].items()}
        except Exception as e:  # undecodable 200 body
            decode_err = e
            status = -1
        # the wire span must land BEFORE _terminate: terminating fires
        # the fleet completion chain, which closes (keeps/drops) the
        # whole trace — a span recorded after close would re-open a ring
        # entry that never closes and vanish from every kept tree
        if ctx is not None:
            obs_trace.record_span(
                ctx, "remote.wire", (t3_us - t0_us) / 1e3,
                span_id=wire_sid, t1_us=t3_us,
                engine=self.name, status=int(status))
        if decode_err is not None:
            self._terminate(req, FAILED, error=RemoteTransportError(
                f"bad response payload: {decode_err}"))
        elif status == 200:
            self._terminate(req, SERVED, result=dets)
        elif status == 429:
            self._terminate(req, SHED)
        elif status == 504:
            self._terminate(req, EXPIRED)
        else:
            err = RemoteTransportError(
                f"agent answered {status}: {bytes(payload[:200])!r}")
            self._terminate(req, FAILED, error=err)

    def _terminate(self, req: ServeRequest, state: str, result=None,
                   error=None) -> None:
        with self._lane_lock:
            n = self._local_pending.get(req.bucket, 0)
            if n > 1:
                self._local_pending[req.bucket] = n - 1
            else:
                self._local_pending.pop(req.bucket, None)
        if req._finish(state, result=result, error=error):
            self.metrics.count({SERVED: "served", SHED: "shed",
                                EXPIRED: "expired",
                                FAILED: "failed"}[state])
            if state == SERVED:
                self.metrics.observe(
                    "total_ms", (time.monotonic() - req.enqueue_t) * 1e3)

    # ------------------------------------------------------------------
    # liveness + backlog signals
    # ------------------------------------------------------------------

    def _note_transport(self, ok: bool) -> None:
        with self._fail_lock:
            self._transport_failures = (0 if ok
                                        else self._transport_failures + 1)

    def note_scrape(self, ok: bool) -> None:
        """Backlog-feed liveness input: a host whose /metrics stops
        answering is dying even if no traffic is flowing."""
        with self._fail_lock:
            self._scrape_failures = 0 if ok else self._scrape_failures + 1

    def update_backlog(self, lanes: Dict[Tuple[int, int], float],
                       at: float = None) -> None:
        """Install a scraped lane snapshot.  ``at`` is the monotonic
        stamp of when the snapshot was RESOLVED (defaults to now): the
        feed replays its cached last-resolved snapshot into freshly
        discovered engines with the original stamp, so a relaunched
        replica gets hints immediately without the cache masquerading
        as a fresh scrape — the ttl decay judges the honest age."""
        now = time.monotonic()
        at = now if at is None else min(float(at), now)
        with self._lane_lock:
            if at >= self._scraped_at:
                self._scraped_lanes = dict(lanes)
                self._scraped_at = at

    def backlog_age(self, now: float = None) -> float:
        """Seconds since the installed lane snapshot was resolved
        (inf before the first one)."""
        now = time.monotonic() if now is None else now
        with self._lane_lock:
            return now - self._scraped_at if self._scraped_at else \
                float("inf")

    def depth(self) -> int:
        return self.metrics.in_flight()

    def bucket_depth(self, bucket: Tuple[int, int]) -> int:
        """Remote lane depth (last scrape) + frames we have in flight
        toward that lane the scrape cannot have seen yet — the JSQ
        batch-packing signal, kept fresh between scrapes by local
        accounting.  Scraped hints DECAY: past ``_lane_ttl_s`` without
        a resolved scrape (collector backoff, feed death, relaunch gap)
        the hint is dropped and only local accounting counts — a stale
        snapshot must not pin phantom depth that misroutes JSQ, and the
        dispatch path itself never blocks on a scrape to find out."""
        b = tuple(bucket)
        now = time.monotonic()
        with self._lane_lock:
            scraped = self._scraped_lanes.get(b, 0)
            if scraped and now - self._scraped_at > self._lane_ttl_s:
                scraped = 0
            return int(scraped + self._local_pending.get(b, 0))

    def alive(self) -> bool:
        if self._closed:
            return False
        with self._fail_lock:
            return (self._transport_failures < self._dead_after
                    and self._scrape_failures < self._dead_after)

    # ------------------------------------------------------------------
    # control surface
    # ------------------------------------------------------------------

    def _control(self, method: str, path: str, body: dict = None) -> Dict:
        conn = http.client.HTTPConnection(
            self._host, self._port,
            timeout=min(self._io_timeout, 10.0))
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = read_limited(resp, self._max_body, "control reply",
                                deadline_s=self._io_timeout * 4)
            if resp.status != 200:
                raise RemoteTransportError(
                    f"{self.agent_url}{path} -> {resp.status}")
            return json.loads(data.decode())
        finally:
            conn.close()

    def healthz(self) -> Dict:
        h = self._control("GET", "/healthz")
        self._last_healthz = h
        return h

    def program_count(self) -> int:
        return int(self._last_healthz.get("programs", 0))

    def kill(self) -> None:
        """Abrupt local death (manager eject path): fail everything we
        still hold — the router reroutes FAILED work.  The frames on the
        wire fail too: their sockets are aborted, and their workers
        neither retry nor reconnect.  The agent itself is NOT touched:
        its local replicas keep serving whoever else routes to them."""
        with self._cond:
            self._killed = True
            conns = list(self._conns)
        self._shutdown(FAILED, RuntimeError("replica killed"))
        for conn in conns:
            conn.abort()

    def close(self, timeout: float = 10.0) -> None:
        self._shutdown(SHED, None)
        for t in self._threads:
            t.join(timeout)

    def _shutdown(self, state: str, error) -> None:
        with self._cond:
            self._closed = True
            leftovers = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for req, _kind in leftovers:
            self._terminate(req, state, error=error)


# ---------------------------------------------------------------------------
# RemoteReplica + fleet construction
# ---------------------------------------------------------------------------

class RemoteReplica(Replica):
    """A managed replica whose engine is a :class:`RemoteEngine` — the
    whole in-process lifecycle applies unchanged (launch → ready →
    eject on death → RestartPolicy-paced relaunch); the only addition
    is the host identity, which placement decisions read."""

    @property
    def agent_url(self) -> Optional[str]:
        with self._lock:
            eng = self.engine
        return eng.agent_url if isinstance(eng, RemoteEngine) else None

    def agent_versions(self) -> Optional[Dict]:
        """The host's per-version ready capacity as of its last healthz
        probe (rollout plane status surface — a mid-rollout host reports
        both arms here; None before the first probe)."""
        with self._lock:
            eng = self.engine
        if not isinstance(eng, RemoteEngine):
            return None
        return eng._last_healthz.get("versions")


def make_remote_build_fn(cfg: Config, agent_urls: List[str]):
    """``build_fn(rid) -> (RemoteEngine, join_stats)`` — replica rid is
    pinned to agent ``rid % len(urls)``, so a relaunch re-probes the SAME
    host (host identity is the replica identity; capacity moved between
    hosts is the scheduler's job, not the relaunch path's)."""
    urls = [normalize_agent_url(u) for u in agent_urls]
    if not urls:
        raise ValueError("make_remote_build_fn needs at least one agent")

    def build(rid: int):
        url = urls[rid % len(urls)]
        eng = RemoteEngine(f"remote-{rid}", url, cfg)
        join = dict(eng.join_info)
        join["agent_url"] = url
        return eng, join

    return build


def agent_urls_from_cfg(cfg: Config) -> List[str]:
    """``cfg.crosshost.agents`` (comma-separated host:port list) →
    normalized agent URLs — the config-declared fleet membership
    ``tools/fleet.py serve --crosshost`` and any caller that passes no
    explicit URL list build from."""
    return [normalize_agent_url(u.strip())
            for u in str(cfg.crosshost.agents).split(",") if u.strip()]


def build_crosshost_router(cfg: Config, agent_urls: List[str] = None,
                           registry: Registry = None, record=None,
                           wire: str = "binary"):
    """Head-side construction: one :class:`RemoteReplica` per agent
    behind the standard manager/router, plus the started backlog feed.
    ``agent_urls=None`` reads the membership from
    ``cfg.crosshost.agents``.  Returns ``(router, feed)`` — callers own
    ``feed.close()`` + ``router.close()``."""
    from mx_rcnn_tpu_torch.serve.fleet import FleetRouter, ReplicaManager

    if agent_urls is None:
        agent_urls = agent_urls_from_cfg(cfg)
    if not agent_urls:
        raise ValueError("build_crosshost_router needs agent URLs "
                         "(argument or cfg.crosshost.agents)")
    urls = [normalize_agent_url(u) for u in agent_urls]
    cfg = cfg.replace_in("fleet", replicas=len(urls))

    def build(rid: int):
        eng = RemoteEngine(f"remote-{rid}", urls[rid % len(urls)], cfg,
                           wire=wire)
        join = dict(eng.join_info)
        join["agent_url"] = eng.agent_url
        return eng, join

    manager = ReplicaManager(build, cfg, registry=registry, record=record,
                             replica_cls=RemoteReplica).start()
    router = FleetRouter(manager, cfg)
    feed = RemoteBacklogFeed(router, urls, cfg)
    feed.start()
    return router, feed


# ---------------------------------------------------------------------------
# the backlog feed: collector → RemoteEngines + time-series store
# ---------------------------------------------------------------------------

def _parse_lane_gauges(gauges: Dict[str, float]
                       ) -> Dict[Tuple[int, int], float]:
    """Agent-published ``lane.<h>x<w>.depth`` gauges → {bucket: depth}."""
    lanes: Dict[Tuple[int, int], float] = {}
    for name, v in gauges.items():
        if not (name.startswith("lane.") and name.endswith(".depth")):
            continue
        dims = name[len("lane."):-len(".depth")]
        try:
            h, w = dims.split("x")
            lanes[(int(h), int(w))] = float(v)
        except ValueError:
            continue
    return lanes


class RemoteBacklogFeed:
    """One poll loop per head: scrapes every agent's /metrics through
    the :class:`~mx_rcnn_tpu_torch.obs.collect.Collector` (per-request
    timeout + failure backoff — one wedged host cannot stall the loop),
    then fans the sample out to BOTH consumers: per-bucket lane depths
    into each :class:`RemoteEngine` (JSQ signal) and the merged
    fleet-view snapshot into a TimeSeriesStore (scheduler signal)."""

    def __init__(self, router, agent_urls: List[str], cfg: Config,
                 store=None):
        from mx_rcnn_tpu_torch.obs.collect import (Collector, HttpSource,
                                                   RegistrySource)
        from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore

        self.router = router
        self.cfg = cfg
        self._interval = max(0.05, float(cfg.crosshost.scrape_interval_s))
        self._urls = [normalize_agent_url(u) for u in agent_urls]
        timeout = max(self._interval, 1.0)
        sources = [
            HttpSource(f"agent-{i}", u, timeout_s=timeout,
                       backoff_base_s=self._interval,
                       backoff_cap_s=max(4 * self._interval, 2.0))
            for i, u in enumerate(self._urls)]
        # the head's own admission accounting (``fleet.*`` counters in
        # the router's PRIVATE registry): sheds taken at the RemoteEngine
        # capacity gate never cross the wire, so without this source the
        # scheduler would read a saturated burst as "idle"
        sources.append(RegistrySource("head", router.metrics.registry))
        self.collector = Collector(sources)
        # per-agent clock-offset gauges (obs.skew_ms.*): estimated by
        # the head's SkewEstimator off traced result frames, folded in
        # here so the drift alarm rule can judge them from the store
        self.collector.add_gauge_fn(obs_trace.skew_gauges)
        self.store = store if store is not None else TimeSeriesStore(
            capacity=cfg.obs.ts_capacity)
        # last-RESOLVED lane snapshot per agent url, with its monotonic
        # resolve stamp: {url: (t_mono, lanes)}.  Only the feed thread
        # writes it; fanout serves it to engines a failed scrape (or a
        # replica relaunched between scrapes) would otherwise leave
        # blind — the engines' own lane ttl ages it out, and the
        # dispatch hot path never waits on a collector scrape.
        self._last_hints: Dict[str, Tuple[float,
                                          Dict[Tuple[int, int], float]]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RemoteBacklogFeed":
        self._thread = threading.Thread(target=self._loop,
                                        name="crosshost-feed", daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _engines_by_url(self) -> Dict[str, List[RemoteEngine]]:
        out: Dict[str, List[RemoteEngine]] = {}
        for r in list(self.router.manager.replicas):
            with r._lock:
                eng, state = r.engine, r.state
            if eng is not None and isinstance(eng, RemoteEngine):
                out.setdefault(eng.agent_url, []).append(eng)
        return out

    def tick(self) -> Dict:
        """One scrape+fanout pass (public so tests drive it without the
        wall-clock loop).  Returns the collected view."""
        from mx_rcnn_tpu_torch.obs.collect import view_to_snapshot

        view = self.collector.collect()
        engines = self._engines_by_url()
        now = time.monotonic()
        for i, url in enumerate(self._urls):
            src = view["sources"].get(f"agent-{i}", {})
            up = bool(src.get("up"))
            if up:
                self._last_hints[url] = (
                    now, _parse_lane_gauges(src.get("gauges", {})))
            cached = self._last_hints.get(url)
            for eng in engines.get(url, []):
                eng.note_scrape(up)
                # fan out the last-RESOLVED snapshot with its honest
                # stamp even when THIS scrape failed: a collector
                # backoff or a just-relaunched engine keeps routing on
                # recent hints instead of going blind, and the engine's
                # lane ttl retires the snapshot once it is truly stale
                if cached is not None:
                    eng.update_backlog(cached[1], at=cached[0])
        self.store.append_snapshot(view_to_snapshot(view), ts=view["ts"])
        return view

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.tick()
            except Exception:  # the feed must never die silently
                logger.exception("crosshost backlog feed tick failed")
