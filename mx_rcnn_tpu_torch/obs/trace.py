"""Host-side span tracing with chrome-trace export, and the distributed
trace context.

Counterpart of ``mx_rcnn_tpu/obs/trace.py``.  ``with span("h2d")``
wraps a host region (data wait, dispatch, snapshot stall, a serve
request's queue wait) at a few µs, and a trace id ties the pieces of one
operation together across threads: a serve request's admission (caller
thread), batch (dispatcher thread) and terminal transition carry one
``trace_id``.

Disabled (the default) the API is a no-op: ``span`` returns a shared
null context manager after one module-flag read, so the calls left in
hot paths cost a branch (pinned by ``tests/test_torch_obs.py``).

Export is the chrome trace event format (Perfetto, ``chrome://tracing``):
spans are ``ph:"X"`` duration events on their thread (µs), request
lifecycles ``ph:"b"/"e"`` async events keyed by trace id.  Host stamps
are ``time.time_ns()``, epoch µs.  :func:`device_trace_events` reads the
chrome trace ``torch.profiler`` writes (``obs/profiler.py``), whose
events Kineto stamps relative to its ``baseTimeNanoseconds`` (or in
epoch µs in builds that write no base), puts them on the same epoch
clock, and :func:`merge_device_trace` writes host and device events as
one timeline.  A span around asynchronous CUDA launches measures the
launch, not the kernels: the device events say when those ran.

The distributed half (``TraceContext``, its wire blob and ``X-MXR-Trace``
header, ``SpanRing``, ``record_span``, the skew estimator,
``merge_fleet_trace``) is the JAX package's byte for byte, so the two
packages interoperate on the wire.
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

_lock = threading.Lock()
_events: List[dict] = []
_enabled = False
_cap = 100_000
_dropped = 0
_tls = threading.local()
_ids = itertools.count(1)


def enable(cap: int = 100_000) -> None:
    """Start collecting spans (bounded buffer of ``cap`` events; overflow
    is counted, never grows memory)."""
    global _enabled, _cap
    with _lock:
        _cap = int(cap)
        _enabled = True


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop collected events (keeps the enabled flag)."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def dropped() -> int:
    return _dropped


def events() -> List[dict]:
    with _lock:
        return list(_events)


def _emit(ev: dict) -> None:
    global _dropped
    with _lock:
        if len(_events) >= _cap:
            _dropped += 1
            return
        _events.append(ev)


def _now_us() -> float:
    # the wall clock, not perf_counter: device events are put on epoch
    # µs too, so the two merge without a per-run offset
    return time.time_ns() / 1e3


def epoch_us() -> int:
    """Integer epoch-µs stamp — the cross-host span/skew clock (the
    wire skew extension ships these, so both ends must agree on units
    and epoch; monotonic clocks are per-host and cannot be compared)."""
    return time.time_ns() // 1000


# ---------------------------------------------------------------------------
# trace-context ids
# ---------------------------------------------------------------------------

def new_trace_id() -> str:
    """Process-unique id tying the spans of one logical operation
    together (e.g. one serve request across caller + dispatcher
    threads)."""
    return f"{os.getpid():x}.{next(_ids):x}"


def set_trace_id(trace_id: Optional[str]) -> None:
    """Bind a trace id to the CURRENT thread: spans opened on it attach
    the id automatically until cleared (pass None to clear)."""
    _tls.trace_id = trace_id


def get_trace_id() -> Optional[str]:
    return getattr(_tls, "trace_id", None)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _Null:
    """Reusable no-op context manager (the disabled fast path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "args", "t0", "depth")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self.depth = getattr(_tls, "depth", 0)
        _tls.depth = self.depth + 1
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now_us()
        _tls.depth = self.depth
        args = {"depth": self.depth}
        tid = self.args.pop("trace_id", None) or get_trace_id()
        if tid is not None:
            args["trace_id"] = tid
        args.update(self.args)
        _emit({"name": self.name, "ph": "X", "ts": self.t0,
               "dur": t1 - self.t0, "pid": os.getpid(),
               "tid": threading.get_ident(), "args": args})
        return False


def span(name: str, **args):
    """``with span("h2d"): ...`` — record a duration event on this
    thread.  Attaches the thread's bound trace id (or an explicit
    ``trace_id=`` kwarg).  Near-free when tracing is disabled."""
    if not _enabled:
        return _NULL
    return _Span(name, args)


def complete(name: str, dur_ms: float, **args) -> None:
    """Record a duration event that ENDED now and lasted ``dur_ms`` —
    for intervals measured with other clocks (e.g. a request's
    ``monotonic`` queue wait) whose endpoints span threads."""
    if not _enabled:
        return
    t1 = _now_us()
    tid = args.pop("trace_id", None) or get_trace_id()
    a = dict(args)
    if tid is not None:
        a["trace_id"] = tid
    _emit({"name": name, "ph": "X", "ts": t1 - dur_ms * 1e3,
           "dur": dur_ms * 1e3, "pid": os.getpid(),
           "tid": threading.get_ident(), "args": a})


def instant(name: str, **args) -> None:
    if not _enabled:
        return
    tid = args.pop("trace_id", None) or get_trace_id()
    a = dict(args)
    if tid is not None:
        a["trace_id"] = tid
    _emit({"name": name, "ph": "i", "s": "t", "ts": _now_us(),
           "pid": os.getpid(), "tid": threading.get_ident(), "args": a})


def async_begin(name: str, trace_id: str, **args) -> None:
    """Open an async (cross-thread) interval keyed by ``trace_id`` —
    chrome ``ph:"b"``.  Close it with :func:`async_end` from ANY
    thread."""
    if not _enabled:
        return
    _emit({"name": name, "ph": "b", "cat": "request", "id": trace_id,
           "ts": _now_us(), "pid": os.getpid(),
           "tid": threading.get_ident(),
           "args": {"trace_id": trace_id, **args}})


def async_end(name: str, trace_id: str, **args) -> None:
    if not _enabled:
        return
    _emit({"name": name, "ph": "e", "cat": "request", "id": trace_id,
           "ts": _now_us(), "pid": os.getpid(),
           "tid": threading.get_ident(),
           "args": {"trace_id": trace_id, **args}})


# ---------------------------------------------------------------------------
# export + device-trace merge
# ---------------------------------------------------------------------------

def export_chrome_trace(path: str, extra_events: List[dict] = None) -> str:
    """Write collected events (plus ``extra_events``, e.g. the decoded
    device timeline) as chrome trace JSON."""
    evs = events() + list(extra_events or [])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms",
                   "metadata": {"dropped_host_events": _dropped}}, f)
    return path


def _epoch_base_us(doc: dict, events: List[dict]) -> float:
    """What to add to a Kineto event's ``ts`` for epoch µs: its
    ``baseTimeNanoseconds`` when the events are stamped relative to it,
    else 0 (absolute stamps, or no base written)."""
    base = doc.get("baseTimeNanoseconds")
    if not base:
        return 0.0
    stamps = [e["ts"] for e in events if isinstance(e.get("ts"), (int,
                                                                 float))]
    if stamps and min(stamps) >= 1e14:   # already epoch µs (after 1973)
        return 0.0
    return float(base) / 1e3


# Kineto's categories of what ran on a CUDA device
_DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))


def device_trace_events(source) -> List[dict]:
    """A ``torch.profiler`` chrome trace (a path, or its parsed dict) →
    chrome duration events on the host spans' epoch-µs clock: every
    kernel, copy and memset with pid ``device:cuda:<n>`` and tid
    ``stream <s>``.  A window that traced no CUDA activity (the CPU)
    gives its ``cpu_op`` events instead, with pid ``device:cpu``."""
    if isinstance(source, str):
        with open(source) as f:
            source = json.load(f)
    raw = [e for e in source.get("traceEvents", [])
           if e.get("ph") == "X" and "ts" in e]
    offset = _epoch_base_us(source, raw)
    dev = [e for e in raw if e.get("cat") in _DEVICE_CATS]
    out: List[dict] = []
    if dev:
        for e in dev:
            args = e.get("args") or {}
            out.append({
                "name": e.get("name", "?"), "ph": "X", "cat": e["cat"],
                "ts": float(e["ts"]) + offset,
                "dur": float(e.get("dur", 0.0)),
                "pid": f"device:cuda:{args.get('device', 0)}",
                "tid": f"stream {args.get('stream', '?')}",
                "args": {k: args[k] for k in ("correlation", "grid",
                                              "block") if k in args}})
        return out
    for e in raw:
        if e.get("cat") == "cpu_op":
            out.append({"name": e.get("name", "?"), "ph": "X",
                        "cat": "cpu_op", "ts": float(e["ts"]) + offset,
                        "dur": float(e.get("dur", 0.0)),
                        "pid": "device:cpu", "tid": e.get("tid", 0)})
    return out


def merge_device_trace(path: str, trace_dir: str) -> str:
    """Export the host spans merged with the newest ``torch.profiler``
    trace under ``trace_dir`` into one chrome-trace file."""
    from mx_rcnn_tpu_torch.obs.profiler import newest_trace

    found = newest_trace(trace_dir)
    extra = device_trace_events(found) if found else []
    return export_chrome_trace(path, extra_events=extra)


# ---------------------------------------------------------------------------
# distributed tracing
#
# A compact trace context (trace id, parent span id, hop depth, sampling
# bit) rides the ``X-MXR-Trace`` header (and the JAX package's wire
# frames), each process records its spans of a request into a bounded
# SpanRing, the head estimates each peer's clock offset NTP-style, and
# merge_fleet_trace joins them into one skew-corrected timeline.  The
# port serves one engine, so its server reads the header, records the
# request's spans under it and keeps the trees.
# ---------------------------------------------------------------------------

#: header name carried on JSON verbs (/detect, agent admin/rollout)
TRACE_HEADER = "X-MXR-Trace"

CTX_VERSION = 1
# version, flags (bit0 = sampled), hop depth, parent span id, id length
_CTX_HEAD = struct.Struct("<BBHQB")
_MAX_CTX_ID = 64                     # trace-id byte bound (wire + header)
_CTX_ID_CHARS = frozenset("0123456789abcdefABCDEF.-_:")


class TraceContext:
    """One request's propagated trace context — immutable value object.

    ``parent`` is the SPAN id (64-bit int) the next hop's spans must
    nest under; ``hop`` counts process boundaries crossed (head = 0).
    """

    __slots__ = ("trace_id", "parent", "hop", "sampled")

    def __init__(self, trace_id: str, parent: int = 0, hop: int = 0,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.parent = int(parent)
        self.hop = int(hop)
        self.sampled = bool(sampled)

    def child(self, parent_span: int) -> "TraceContext":
        """The context the NEXT hop receives: same trace, one hop
        deeper, nesting under ``parent_span``."""
        return TraceContext(self.trace_id, parent_span, self.hop + 1,
                            self.sampled)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.parent == other.parent
                and self.hop == other.hop
                and self.sampled == other.sampled)

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, parent={self.parent:#x},"
                f" hop={self.hop}, sampled={self.sampled})")


def _check_ctx_id(trace_id: str) -> bytes:
    raw = trace_id.encode("ascii", "strict") if isinstance(
        trace_id, str) else bytes(trace_id)
    if not raw or len(raw) > _MAX_CTX_ID:
        raise ValueError(
            f"trace id length {len(raw)} outside [1, {_MAX_CTX_ID}]")
    if not set(trace_id) <= _CTX_ID_CHARS:
        raise ValueError(f"trace id {trace_id!r} has invalid characters")
    return raw


def encode_ctx(ctx: TraceContext) -> bytes:
    """Trace context → the compact wire extension blob."""
    raw = _check_ctx_id(ctx.trace_id)
    if not 0 <= ctx.parent < (1 << 64):
        raise ValueError(f"parent span id {ctx.parent} outside u64")
    if not 0 <= ctx.hop < (1 << 16):
        raise ValueError(f"hop depth {ctx.hop} outside u16")
    return _CTX_HEAD.pack(CTX_VERSION, 1 if ctx.sampled else 0,
                          ctx.hop, ctx.parent, len(raw)) + raw


def decode_ctx(buf: bytes) -> TraceContext:
    """Wire extension blob → trace context.  Malformed input is a
    typed ``ValueError`` (the netio rejection contract) — NEVER a
    zero-filled default."""
    if len(buf) < _CTX_HEAD.size:
        raise ValueError(
            f"trace extension truncated: {len(buf)} < {_CTX_HEAD.size}")
    ver, flags, hop, parent, idlen = _CTX_HEAD.unpack_from(buf)
    if ver != CTX_VERSION:
        raise ValueError(f"trace extension version {ver} unsupported")
    if idlen == 0 or idlen > _MAX_CTX_ID:
        raise ValueError(
            f"trace id length {idlen} outside [1, {_MAX_CTX_ID}]")
    if len(buf) != _CTX_HEAD.size + idlen:
        raise ValueError(
            f"trace extension length {len(buf)} != "
            f"{_CTX_HEAD.size + idlen} declared")
    raw = buf[_CTX_HEAD.size:]
    try:
        trace_id = raw.decode("ascii")
    except UnicodeDecodeError:
        raise ValueError("trace id is not ascii")
    if not set(trace_id) <= _CTX_ID_CHARS:
        raise ValueError(f"trace id {trace_id!r} has invalid characters")
    # unknown FLAG bits are ignored (forward-compat: a newer head may
    # set bits this build does not know), unknown VERSIONS are rejected
    return TraceContext(trace_id, parent, hop, bool(flags & 1))


def format_header(ctx: TraceContext) -> str:
    """Trace context → the ``X-MXR-Trace`` header value."""
    _check_ctx_id(ctx.trace_id)
    return (f"v{CTX_VERSION};id={ctx.trace_id};parent={ctx.parent:x};"
            f"hop={ctx.hop};s={1 if ctx.sampled else 0}")


def parse_header(value: str) -> TraceContext:
    """``X-MXR-Trace`` header value → trace context (ValueError on any
    malformation — a bad header is a 400, never a silent default)."""
    if not isinstance(value, str) or len(value) > 256:
        raise ValueError("trace header missing or oversized")
    parts = value.strip().split(";")
    if parts[0] != f"v{CTX_VERSION}":
        raise ValueError(f"trace header version {parts[0]!r} unsupported")
    kv: Dict[str, str] = {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"trace header field {p!r} malformed")
        k, v = p.split("=", 1)
        kv[k] = v
    try:
        trace_id = kv["id"]
        parent = int(kv["parent"], 16)
        hop = int(kv["hop"])
        s = kv["s"]
    except KeyError as e:
        raise ValueError(f"trace header missing field {e.args[0]!r}")
    except ValueError:
        raise ValueError("trace header numeric field malformed")
    if s not in ("0", "1"):
        raise ValueError(f"trace header sampling bit {s!r} malformed")
    if not 0 <= parent < (1 << 64) or not 0 <= hop < (1 << 16):
        raise ValueError("trace header field out of range")
    _check_ctx_id(trace_id)
    return TraceContext(trace_id, parent, hop, s == "1")


# -- span ids ---------------------------------------------------------------

_span_ids = itertools.count(1)


def new_span_id() -> int:
    """Fleet-unique-enough 64-bit span id: pid in the high bits, a
    process counter in the low — no randomness, so traces stay
    byte-reproducible under a virtual clock."""
    return ((os.getpid() & 0xFFFF) << 48) | (next(_span_ids) & 0xFFFFFFFFFFFF)


# -- distributed configuration ---------------------------------------------

_dist_lock = threading.Lock()
_dist_sample = 0.0        # head sampling probability (cfg.obs.trace_sample)
_dist_acc = 0.0           # deterministic fraction accumulator
_dist_slow_pct = 99.0     # slowest-percentile forced retention
_dist_host = f"pid-{os.getpid()}"
_dist_ring: Optional["SpanRing"] = None
_dist_durs: deque = deque(maxlen=512)   # recent SERVED totals (tail window)


def configure_distributed(sample: float = None, ring: int = None,
                          slow_pct: float = None, host: str = None) -> None:
    """Arm (or retune) the distributed plane.  ``sample`` is the head
    sampling probability (0 disables head-side trace creation; agents
    obey the inbound sampled bit regardless); ``ring`` bounds the kept
    span trees; ``host`` labels this process's spans in merged views."""
    global _dist_sample, _dist_slow_pct, _dist_host, _dist_ring, _dist_acc
    with _dist_lock:
        if sample is not None:
            _dist_sample = max(0.0, min(1.0, float(sample)))
            _dist_acc = 0.0
        if slow_pct is not None:
            _dist_slow_pct = max(0.0, min(100.0, float(slow_pct)))
        if host is not None:
            _dist_host = str(host)
        if ring is not None and ring > 0 and (
                _dist_ring is None or _dist_ring.cap != int(ring)):
            _dist_ring = SpanRing(int(ring))


def reset_distributed() -> None:
    """Drop all distributed state (tests)."""
    global _dist_sample, _dist_ring, _dist_acc
    with _dist_lock:
        _dist_sample = 0.0
        _dist_acc = 0.0
        _dist_ring = None
        _dist_durs.clear()
        _skew.reset()


def host_label() -> str:
    return _dist_host


def ring() -> Optional["SpanRing"]:
    return _dist_ring


def sample_trace() -> Optional[TraceContext]:
    """The head's admission-time sampling decision: a new root context
    for every sampled request, None otherwise.  Deterministic fraction
    accumulator (the canary-lane idiom), not a coin flip — request k is
    sampled iff ``floor(k*p) > floor((k-1)*p)``, so a 25% sample is
    exactly 1-in-4 and byte-reproducible."""
    global _dist_acc
    if _dist_ring is None or _dist_sample <= 0.0:
        return None
    with _dist_lock:
        _dist_acc += _dist_sample
        take = _dist_acc >= 1.0
        if take:
            _dist_acc -= 1.0
    if not take:
        return None
    return TraceContext(new_trace_id(), parent=0, hop=0, sampled=True)


def correlation_id(sample_ts: float) -> str:
    """The decision-log correlation id: derived from the TRIGGERING
    health sample's timestamp (``w`` + epoch-ms hex), so every action a
    window caused carries the same id and a decision log can join the
    actions with the sample window they reacted to.  Purely a function
    of the sample clock, so under a virtual clock the id is
    deterministic."""
    return f"w{int(round(float(sample_ts) * 1000)):x}"


def admin_trace() -> Optional[TraceContext]:
    """An ALWAYS-sampled root context for control-plane verbs (resize,
    rollout) — rare enough that probabilistic sampling would lose most
    of them, important enough that every one should be reconstructible.
    None (no header, byte-identical admin RPC) unless the distributed
    plane is armed with a non-zero sample rate."""
    if _dist_ring is None or _dist_sample <= 0.0:
        return None
    return TraceContext(new_trace_id(), parent=0, hop=0, sampled=True)


def retain_trace(state: str, total_ms: float = None,
                 attempts: int = 1) -> bool:
    """Tail retention: forced for every non-SERVED terminal and every
    rerouted request; SERVED requests are kept when they land in the
    slowest ``obs.trace_slow_pct`` percentile of the recent window
    (warmup keeps everything until the window has 32 samples)."""
    if state != "SERVED" or attempts > 1:
        return True
    if total_ms is None:
        return True
    with _dist_lock:
        _dist_durs.append(float(total_ms))
        n = len(_dist_durs)
        if n < 32:
            return True
        cut = sorted(_dist_durs)[min(n - 1,
                                     int(n * _dist_slow_pct / 100.0))]
    return total_ms >= cut


class SpanRing:
    """Bounded per-trace span store: spans accumulate under their trace
    id while the request is in flight, then :meth:`close` either KEEPS
    the finished tree (bounded deque — oldest kept tree falls off) or
    drops it.  Overflowing open traces evict oldest-first, counted."""

    def __init__(self, cap: int = 256, cap_spans: int = 128):
        self.cap = int(cap)
        self.cap_spans = int(cap_spans)
        self._lock = threading.Lock()
        self._open: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._kept: deque = deque(maxlen=self.cap)
        self.dropped = 0

    def record(self, trace_id: str, span: dict) -> None:
        with self._lock:
            spans = self._open.get(trace_id)
            if spans is None:
                if len(self._open) >= 2 * self.cap:
                    self._open.popitem(last=False)
                    self.dropped += 1
                spans = self._open[trace_id] = []
            if len(spans) < self.cap_spans:
                spans.append(span)
            else:
                self.dropped += 1

    def close(self, trace_id: str, keep: bool, **meta) -> None:
        with self._lock:
            spans = self._open.pop(trace_id, None)
            if spans is None or not keep:
                return
            self._kept.append({"trace": trace_id, "host": _dist_host,
                               "spans": spans, **meta})

    def trees(self, limit: int = None) -> List[dict]:
        with self._lock:
            out = list(self._kept)
        return out[-limit:] if limit else out

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)


def record_span(ctx: TraceContext, name: str, dur_ms: float,
                span_id: int = None, parent: int = None,
                t1_us: float = None, **args) -> int:
    """Record one completed span under ``ctx`` into the ring.  The span
    ENDED at ``t1_us`` (epoch µs; default now) and lasted ``dur_ms``.
    Returns the span id so callers can parent later spans under it.
    Callers gate on ``ctx is not None`` — that None-check is the whole
    untraced hot-path cost."""
    r = _dist_ring
    sid = span_id if span_id is not None else new_span_id()
    if r is None or not ctx.sampled:
        return sid
    end = _now_us() if t1_us is None else t1_us
    span = {"name": name, "span": sid,
            "parent": ctx.parent if parent is None else parent,
            "ts": end - float(dur_ms) * 1e3, "dur": float(dur_ms) * 1e3,
            "host": _dist_host, "hop": ctx.hop}
    if args:
        span["args"] = args
    r.record(ctx.trace_id, span)
    return sid


def close_trace(ctx: TraceContext, keep: bool = True, **meta) -> None:
    r = _dist_ring
    if r is not None and ctx.sampled:
        r.close(ctx.trace_id, keep, **meta)


def kept_trees(limit: int = None) -> List[dict]:
    """The retained span trees (flight-recorder + /trace surface)."""
    r = _dist_ring
    return r.trees(limit) if r is not None else []


# -- clock-skew estimation --------------------------------------------------

class SkewEstimator:
    """NTP-style per-source clock-offset estimation from request/
    response timestamp pairs: for each exchange the head records its
    send (t0) and receive (t3) epoch-µs stamps and the agent returns
    its receive (t1) and send (t2); offset = ((t1-t0)+(t2-t3))/2, rtt =
    (t3-t0)-(t2-t1).  The estimate is the median offset of the
    lowest-rtt half of a bounded sample window — queueing delay inflates
    rtt symmetrically, so low-rtt exchanges bound the skew tightest."""

    def __init__(self, window: int = 64):
        self._lock = threading.Lock()
        self._window = int(window)
        self._samples: Dict[str, deque] = {}

    def note(self, source: str, t0_us: float, t1_us: float,
             t2_us: float, t3_us: float) -> None:
        off = ((t1_us - t0_us) + (t2_us - t3_us)) / 2.0 / 1e3
        rtt = max(((t3_us - t0_us) - (t2_us - t1_us)) / 1e3, 0.0)
        with self._lock:
            dq = self._samples.setdefault(
                source, deque(maxlen=self._window))
            dq.append((off, rtt))

    def offset_ms(self, source: str) -> Optional[float]:
        """Estimated ``source_clock - head_clock`` in ms (None until a
        sample lands)."""
        with self._lock:
            dq = self._samples.get(source)
            if not dq:
                return None
            samples = list(dq)
        best = sorted(samples, key=lambda s: s[1])
        best = best[:max(1, len(best) // 2)]
        offs = sorted(s[0] for s in best)
        return offs[len(offs) // 2]

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._samples)

    def gauges(self) -> Dict[str, float]:
        """``obs.skew_ms.<source>`` per-agent offsets plus
        ``obs.skew_ms.max`` (the worst |offset|) — the drift-alarm
        rule's input (obs/health.py — default_rules)."""
        out: Dict[str, float] = {}
        worst = 0.0
        for src in self.sources():
            off = self.offset_ms(src)
            if off is None:
                continue
            out[f"obs.skew_ms.{src}"] = round(off, 3)
            worst = max(worst, abs(off))
        if out:
            out["obs.skew_ms.max"] = round(worst, 3)
        return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


_skew = SkewEstimator()


def skew() -> SkewEstimator:
    return _skew


def skew_gauges() -> Dict[str, float]:
    return _skew.gauges()


# -- skew-corrected fleet merge --------------------------------------------

def correct_tree_spans(spans: List[dict], offset_ms: float) -> int:
    """Shift one host's spans onto the head clock (subtract its
    estimated offset), IN PLACE.  Returns the span count."""
    if offset_ms:
        for s in spans:
            s["ts"] = s["ts"] - offset_ms * 1e3
    return len(spans)


def _clamp_children(spans: List[dict]) -> int:
    """Post-correction monotonicity: no child span may start before its
    parent.  Residual estimation error (sub-ms) can still invert an
    edge; the clamp pins child start to parent start and COUNTS it, so
    the merge reports its correction quality."""
    by_id = {s["span"]: s for s in spans}
    clamped = 0
    for _ in range(8):               # tree depth bound; converges fast
        changed = False
        for s in spans:
            p = by_id.get(s.get("parent"))
            if p is not None and s["ts"] < p["ts"]:
                s["ts"] = p["ts"]
                clamped += 1
                changed = True
        if not changed:
            break
    return clamped


def merge_fleet_trace(local_trees: List[dict],
                      remote_by_source: Dict[str, List[dict]],
                      offsets_ms: Dict[str, float],
                      path: str = None) -> Dict:
    """Merge head + remote span trees into one skew-corrected view.

    ``local_trees`` are the head's kept trees; ``remote_by_source``
    maps agent source name → its ``/trace`` trees; ``offsets_ms`` the
    per-source skew estimates (missing sources merge uncorrected).
    Returns ``{"traces": {trace_id: [spans]}, "traceEvents": [...],
    "metadata": {...}}`` — the traceEvents list loads in Perfetto, with
    one pid per host.  When ``path`` is given the chrome-trace JSON is
    also written there."""
    traces: Dict[str, List[dict]] = {}

    def _fold(trees: List[dict], offset: float) -> None:
        for t in trees:
            spans = [dict(s) for s in t.get("spans", [])]
            correct_tree_spans(spans, offset)
            traces.setdefault(t["trace"], []).extend(spans)

    _fold(local_trees, 0.0)
    for src, trees in remote_by_source.items():
        _fold(trees, float(offsets_ms.get(src) or 0.0))
    clamped = 0
    for spans in traces.values():
        spans.sort(key=lambda s: s["ts"])
        clamped += _clamp_children(spans)
    events_out: List[dict] = []
    for tid, spans in traces.items():
        for s in spans:
            events_out.append({
                "name": s["name"], "ph": "X", "ts": s["ts"],
                "dur": s["dur"], "pid": s.get("host", "?"),
                "tid": f"hop-{s.get('hop', 0)}",
                "args": {"trace_id": tid, "span": f"{s['span']:x}",
                         "parent": f"{s.get('parent', 0):x}",
                         **s.get("args", {})}})
    doc = {"traces": traces, "traceEvents": events_out,
           "metadata": {"clamped": clamped,
                        "offsets_ms": {k: round(float(v), 3)
                                       for k, v in offsets_ms.items()},
                        "n_traces": len(traces)}}
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events_out, "displayTimeUnit": "ms",
                       "metadata": doc["metadata"]}, f)
    return doc


def tree_complete(spans: List[dict]) -> bool:
    """A span tree is COMPLETE when every non-root parent pointer
    resolves to a span in the tree (root spans carry parent 0)."""
    ids = {s["span"] for s in spans}
    return all(s.get("parent", 0) == 0 or s["parent"] in ids
               for s in spans)


def tree_monotonic(spans: List[dict]) -> bool:
    """No child starts before its parent (the skew-correction check)."""
    by_id = {s["span"]: s for s in spans}
    for s in spans:
        p = by_id.get(s.get("parent"))
        if p is not None and s["ts"] < p["ts"] - 1e-3:
            return False
    return True
