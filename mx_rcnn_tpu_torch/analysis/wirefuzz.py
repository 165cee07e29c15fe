"""wirefuzz: deterministic wire-protocol fuzzing of the port's
cross-host plane.

Counterpart of ``mx_rcnn_tpu/analysis/wirefuzz.py``, the same code: the
same outcomes, seeded mutation engine, allocation guard, raw-socket HTTP
sender and fault proxy, so a corpus comes out byte for byte and name
for name as the JAX module's does at the same seed.  netlint
(``analysis/netlint.py``) proves the network surface is SHAPED right —
timeouts at allocation sites, bounded reads, length checks before
unpacks.  This module is its runtime twin: it feeds the real decoders
and the real HTTP servers deterministically malformed bytes and asserts
the CONTRACT those shapes exist for:

* a malformed frame is a TYPED rejection (``ValueError`` in-process, a
  4xx over HTTP) — never a crash, never a 500;
* no input makes a decoder allocate unboundedly (a wire-read length
  field must be validated against the buffer before it sizes anything);
* no input wedges a handler past its deadline, and the server still
  answers ``/healthz`` and serves a good frame AFTERWARD;
* socket-level faults between head and agent (drop / delay / split /
  truncate mid-frame / black-hole) end in reroute + exactly-once, never
  a lost or doubled request.

The port's wire path allocates only through numpy (``serve/remote.py``
decodes into numpy arrays; tensors are made after the decode), so the
guard wraps numpy's allocators and no torch allocator.

Everything is seeded (``random.Random(seed)``) so a corpus is
reproducible byte-for-byte: a failure report names the mutation and the
seed regenerates it exactly.  The driver that aims this at the MXR1/MXD1
codec, a live agent, ``HttpSource`` and a faulted head-agent link — and
the planted-arm sensitivity proof — is ``tools/wirefuzz.py``.
"""

from __future__ import annotations

import contextlib
import random
import socket
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# outcomes
# ---------------------------------------------------------------------------

REJECTED = "rejected"                    # typed ValueError — the contract
ACCEPTED_VALID = "accepted_valid"        # benign mutation decoded fine
ACCEPTED_MALFORMED = "accepted_malformed"  # VIOLATION: must_reject decoded
CRASHED = "crashed"                      # VIOLATION: untyped exception
HUNG = "hung"                            # VIOLATION: past the deadline
ALLOC = "alloc_cap"                      # VIOLATION: unbounded allocation

VIOLATIONS = (ACCEPTED_MALFORMED, CRASHED, HUNG, ALLOC)


class Mutation:
    """One corpus entry: a name (stable across runs for the same seed),
    the mutated bytes, and whether the decoder MUST reject them.
    ``must_reject=False`` marks data-carrying mutations (payload bytes,
    benign header fields) that may decode to different values but must
    still never crash/hang/over-allocate."""

    __slots__ = ("name", "data", "must_reject")

    def __init__(self, name: str, data: bytes, must_reject: bool):
        self.name = name
        self.data = data
        self.must_reject = must_reject

    def __repr__(self):
        return (f"Mutation({self.name!r}, {len(self.data)}B, "
                f"must_reject={self.must_reject})")


# ---------------------------------------------------------------------------
# seeded corpus generation
# ---------------------------------------------------------------------------

class Mutator:
    """Deterministic mutation engine over a VALID frame.

    The caller describes the frame's header layout as spans:
    ``reject_spans`` are load-bearing fields (magic, version, dims, any
    length/count) where a flip must produce a rejection;
    ``benign_spans`` are data-carrying fields (reserved, timeouts,
    im_info) where a flip must merely not crash.  Same seed + same
    frame → the identical corpus, names and bytes.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)

    def corpus(self, frame: bytes, head_size: int,
               reject_spans: Sequence[Tuple[str, int, int]],
               benign_spans: Sequence[Tuple[str, int, int]] = (),
               payload_flips: int = 4,
               extra: Iterable[Mutation] = ()) -> List[Mutation]:
        if len(frame) <= head_size:
            raise ValueError("corpus wants a frame with a payload")
        muts: List[Mutation] = []

        # -- truncation at every structural boundary ------------------
        cuts = {0, 1, 3}
        for _name, a, b in list(reject_spans) + list(benign_spans):
            cuts.add(a)
            cuts.add(b)
        cuts.update({head_size - 1, head_size,
                     head_size + (len(frame) - head_size) // 2,
                     len(frame) - 1})
        for c in sorted(x for x in cuts if 0 <= x < len(frame)):
            muts.append(Mutation(f"trunc@{c}", frame[:c], True))

        # -- bit flips in load-bearing header fields ------------------
        for name, a, b in reject_spans:
            for _ in range(max(2, b - a)):
                off = self.rng.randrange(a, b)
                bit = self.rng.randrange(8)
                d = bytearray(frame)
                d[off] ^= 1 << bit
                muts.append(Mutation(f"flip:{name}@{off}.{bit}",
                                     bytes(d), True))

        # -- bit flips in data-carrying header fields (benign) --------
        for name, a, b in benign_spans:
            for _ in range(max(1, (b - a) // 2)):
                off = self.rng.randrange(a, b)
                bit = self.rng.randrange(8)
                d = bytearray(frame)
                d[off] ^= 1 << bit
                muts.append(Mutation(f"flip:{name}@{off}.{bit}",
                                     bytes(d), False))

        # -- payload flips: decode fine, different values, no crash ---
        for _ in range(payload_flips):
            off = self.rng.randrange(head_size, len(frame))
            bit = self.rng.randrange(8)
            d = bytearray(frame)
            d[off] ^= 1 << bit
            muts.append(Mutation(f"flip:payload@{off}.{bit}",
                                 bytes(d), False))

        # -- structural edits ----------------------------------------
        muts.append(Mutation("empty", b"", True))
        muts.append(Mutation("garbage", bytes(
            self.rng.randrange(256) for _ in range(head_size + 16)), True))
        muts.append(Mutation("magic:xxxx",
                             b"XXXX" + frame[4:], True))
        muts.append(Mutation("trailing-junk", frame + b"\xde\xad", True))
        muts.append(Mutation("header-only", frame[:head_size], True))
        muts.extend(extra)
        return muts

    @staticmethod
    def fingerprint(muts: Sequence[Mutation]) -> str:
        """Stable digest of a corpus (names + bytes) — the determinism
        pin: same seed, same frame → same fingerprint."""
        import hashlib

        h = hashlib.sha256()
        for m in muts:
            h.update(m.name.encode())
            h.update(b"\x00" + m.data + b"\x01")
        return h.hexdigest()


# ---------------------------------------------------------------------------
# allocation guard
# ---------------------------------------------------------------------------

class AllocationCapExceeded(Exception):
    """A decoder asked numpy for more memory than the guard's cap —
    i.e. a wire-read length sized an allocation without a bound."""


def _nbytes_of(fname: str, args, kwargs) -> Optional[int]:
    import numpy as np

    try:
        if fname == "frombuffer":
            count = kwargs.get("count", args[2] if len(args) > 2 else -1)
            dtype = kwargs.get("dtype", args[1] if len(args) > 1
                               else np.float64)
            if count is None or int(count) < 0:
                return None  # whole-buffer read: bounded by the buffer
            return int(count) * np.dtype(dtype).itemsize
        shape = kwargs.get("shape", args[0] if args else None)
        dtype = kwargs.get("dtype",
                           args[2 if fname == "full" else 1]
                           if len(args) > (2 if fname == "full" else 1)
                           else np.float64)
        if shape is None:
            return None
        if not isinstance(shape, (tuple, list)):
            shape = (shape,)
        n = 1
        for s in shape:
            n *= int(s)
        return n * np.dtype(dtype).itemsize
    except Exception:
        return None  # unparseable call: let numpy raise its own error


@contextlib.contextmanager
def alloc_guard(cap_bytes: int = 64 << 20):
    """Monkeypatch numpy's allocators so any request past ``cap_bytes``
    raises :class:`AllocationCapExceeded` instead of attempting a
    multi-GB allocation.  Single-threaded use (the codec leg)."""
    import numpy as np

    names = ("zeros", "empty", "ones", "full", "frombuffer")
    orig = {n: getattr(np, n) for n in names}

    def wrap(fname, fn):
        def g(*args, **kwargs):
            est = _nbytes_of(fname, args, kwargs)
            if est is not None and est > cap_bytes:
                raise AllocationCapExceeded(
                    f"np.{fname} asked for {est} bytes (cap {cap_bytes})")
            return fn(*args, **kwargs)
        return g

    for n in names:
        setattr(np, n, wrap(n, orig[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(np, n, orig[n])


# ---------------------------------------------------------------------------
# in-process codec leg
# ---------------------------------------------------------------------------

def run_case(decode: Callable[[bytes], object], m: Mutation,
             deadline_s: float = 5.0,
             alloc_cap: int = 64 << 20) -> Dict:
    """One mutation against one decoder, under the alloc guard and a
    wall-clock deadline.  ``ValueError`` is the ONLY typed rejection."""
    t0 = time.monotonic()
    try:
        with alloc_guard(alloc_cap):
            decode(m.data)
    except ValueError:
        outcome = REJECTED
    except AllocationCapExceeded as e:
        return {"case": m.name, "outcome": ALLOC, "detail": str(e)}
    except Exception as e:
        return {"case": m.name, "outcome": CRASHED,
                "detail": f"{type(e).__name__}: {e}"}
    else:
        outcome = ACCEPTED_MALFORMED if m.must_reject else ACCEPTED_VALID
    dt = time.monotonic() - t0
    if dt > deadline_s:
        return {"case": m.name, "outcome": HUNG,
                "detail": f"{dt:.1f}s > {deadline_s:.1f}s"}
    return {"case": m.name, "outcome": outcome}


def fuzz_codec(decode: Callable[[bytes], object],
               muts: Sequence[Mutation], deadline_s: float = 5.0,
               alloc_cap: int = 64 << 20) -> List[Dict]:
    return [run_case(decode, m, deadline_s, alloc_cap) for m in muts]


def summarize(results: Iterable[Dict]) -> Dict:
    counts: Dict[str, int] = {}
    violations: List[Dict] = []
    n = 0
    for r in results:
        n += 1
        counts[r["outcome"]] = counts.get(r["outcome"], 0) + 1
        if r["outcome"] in VIOLATIONS:
            violations.append(r)
    return {"cases": n, "outcomes": counts, "violations": violations}


# ---------------------------------------------------------------------------
# raw-socket HTTP leg
# ---------------------------------------------------------------------------

def _http_request_bytes(path: str, body: bytes, ctype: str,
                        content_length: Optional[int]) -> bytes:
    head = [f"POST {path} HTTP/1.1", "Host: fuzz",
            f"Content-Type: {ctype}"]
    if content_length is not None:
        head.append(f"Content-Length: {content_length}")
    head.append("Connection: close")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _read_http_response(sock: socket.socket,
                        max_bytes: int = 1 << 20) -> Tuple[int, bytes]:
    """Minimal capped response reader: returns (status, raw).  Raises
    ``socket.timeout`` past the socket's deadline, ``ValueError`` on an
    unparseable status line or an over-cap body."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            break
        buf += chunk
        if len(buf) > max_bytes:
            raise ValueError("response headers exceed cap")
    if not buf:
        raise ValueError("connection closed before any response")
    line = buf.split(b"\r\n", 1)[0].decode("latin-1", "replace")
    parts = line.split()
    if len(parts) < 2 or not parts[1].isdigit():
        raise ValueError(f"bad status line {line!r}")
    status = int(parts[1])
    # drain the rest (Connection: close) under the same cap
    while len(buf) <= max_bytes:
        try:
            chunk = sock.recv(4096)
        except socket.timeout:
            break
        if not chunk:
            break
        buf += chunk
    return status, buf


def http_post_raw(host: str, port: int, path: str, body: bytes,
                  mode: str = "whole", ctype: str = "application/x-mxr1",
                  content_length: str = "auto",
                  timeout_s: float = 10.0,
                  trickle_bytes: int = 64,
                  trickle_delay_s: float = 0.01) -> Dict:
    """One raw HTTP POST with byte-level control over delivery.

    modes: ``whole`` (one sendall), ``split`` (two halves, 50 ms gap),
    ``trickle`` (headers whole, then the first ``trickle_bytes`` body
    bytes one at a time, then the rest), ``disconnect`` (headers + half
    the body, then close — no response expected).
    ``content_length``: ``"auto"`` (=len(body)), ``"absent"`` (no CL
    header → the server must 411), or an int to LIE (a multi-GB claim
    must 413 before a body byte is read).

    Returns ``{"status": int|None, "error": str|None, "elapsed_s": f}``.
    """
    cl: Optional[int]
    if content_length == "auto":
        cl = len(body)
    elif content_length == "absent":
        cl = None
    else:
        cl = int(content_length)
    req = _http_request_bytes(path, b"", ctype, cl)
    t0 = time.monotonic()
    status = None
    err = None
    sock = socket.create_connection((host, port), timeout=timeout_s)
    try:
        try:
            sock.sendall(req)
            if mode == "whole":
                sock.sendall(body)
            elif mode == "split":
                half = len(body) // 2
                sock.sendall(body[:half])
                time.sleep(0.05)
                sock.sendall(body[half:])
            elif mode == "trickle":
                n = min(trickle_bytes, len(body))
                for i in range(n):
                    sock.sendall(body[i:i + 1])
                    time.sleep(trickle_delay_s)
                sock.sendall(body[n:])
            elif mode == "disconnect":
                sock.sendall(body[:max(1, len(body) // 2)])
                sock.shutdown(socket.SHUT_RDWR)
                return {"status": None, "error": "client-disconnect",
                        "elapsed_s": round(time.monotonic() - t0, 3)}
            else:
                raise ValueError(f"unknown mode {mode!r}")
        except (BrokenPipeError, ConnectionResetError):
            # the server refused mid-send (e.g. a 408 at its body
            # deadline while we were still trickling): its response is
            # sitting in our receive buffer — read it, don't lose it
            pass
        status, _raw = _read_http_response(sock)
    except (socket.timeout, TimeoutError):
        err = "timeout"
    except (OSError, ValueError) as e:
        err = f"{type(e).__name__}: {e}"
    finally:
        sock.close()
    return {"status": status, "error": err,
            "elapsed_s": round(time.monotonic() - t0, 3)}


def http_case_outcome(res: Dict, must_reject: bool,
                      deadline_s: float) -> str:
    """Map an ``http_post_raw`` result to a fuzz outcome.  The HTTP
    contract: malformed client input is a 4xx (never 5xx), a valid
    frame is 200, and either way the answer lands inside the deadline.
    A connection the server dropped without a response counts as a
    rejection (it refused the input without wedging)."""
    if res.get("elapsed_s", 0.0) > deadline_s:
        return HUNG
    if res.get("error") == "timeout":
        return HUNG
    st = res.get("status")
    if st is None:
        return REJECTED  # dropped connection: refused, not wedged
    if 400 <= st < 500:
        return REJECTED
    if st == 200:
        return ACCEPTED_MALFORMED if must_reject else ACCEPTED_VALID
    return CRASHED  # 5xx for client-fault input breaks the contract


# ---------------------------------------------------------------------------
# socket-level fault proxy (head ↔ agent)
# ---------------------------------------------------------------------------

class FaultProxy:
    """A TCP proxy that injects one deterministic fault per accepted
    connection, chosen by ``schedule(conn_index)`` from:

    ``pass`` (forward untouched), ``delay`` (0.2 s stall before the
    first upstream write), ``split`` (forward in 7-byte writes),
    ``truncate`` (forward half of the first client read, then close
    both sides — mid-frame disconnect), ``blackhole`` (accept and read
    but never forward — the peer looks alive and says nothing),
    ``reset`` (close the client immediately).

    The head's reroute/exactly-once machinery is the system under test:
    every request submitted through the proxy must reach exactly one
    terminal state (tools/wirefuzz.py leg D).
    """

    MODES = ("pass", "delay", "split", "truncate", "blackhole", "reset")

    def __init__(self, upstream_host: str, upstream_port: int,
                 schedule: Optional[Callable[[int], str]] = None,
                 seed: int = 0, io_timeout_s: float = 30.0):
        self.upstream = (upstream_host, upstream_port)
        rng = random.Random(seed)
        self.schedule = schedule or (
            lambda i: self.MODES[rng.randrange(len(self.MODES))])
        self.io_timeout_s = float(io_timeout_s)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.settimeout(0.5)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(64)
        self.address = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._conn_index = 0
        self._lock = threading.Lock()
        self._live: set = set()   # sockets snapped by kill_live()
        self.faults_applied: List[str] = []
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- lifecycle ---------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        self._lsock.close()
        self.kill_live()
        self._accept_thread.join(timeout=5.0)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)

    def kill_live(self) -> None:
        """Snap every connection currently riding the proxy — a
        keep-alive peer is forced to reconnect, so the NEXT scheduled
        fault mode actually gets a connection to apply to."""
        with self._lock:
            socks = list(self._live)
            self._live.clear()
        for s in socks:
            with contextlib.suppress(OSError):
                s.close()

    # -- internals ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                idx = self._conn_index
                self._conn_index += 1
            mode = self.schedule(idx)
            with self._lock:
                self.faults_applied.append(mode)
            t = threading.Thread(target=self._serve_conn,
                                 args=(client, mode), daemon=True)
            t.start()
            with self._lock:
                self._threads.append(t)

    def _serve_conn(self, client: socket.socket, mode: str) -> None:
        client.settimeout(self.io_timeout_s)
        if mode == "reset":
            client.close()
            return
        try:
            up = socket.create_connection(self.upstream,
                                          timeout=self.io_timeout_s)
        except OSError:
            client.close()
            return
        with self._lock:
            self._live.add(client)
            self._live.add(up)
        try:
            if mode == "blackhole":
                # swallow the request, say nothing until the client
                # gives up (its timeout is the system under test)
                try:
                    while not self._stop.is_set():
                        if not client.recv(4096):
                            break
                except (socket.timeout, OSError):
                    pass
                return
            if mode == "truncate":
                try:
                    first = client.recv(4096)
                    if first:
                        up.sendall(first[:max(1, len(first) // 2)])
                except (socket.timeout, OSError):
                    pass
                return  # finally closes both: mid-frame disconnect
            first_write = [mode == "delay"]

            def pump(src, dst):
                try:
                    while not self._stop.is_set():
                        data = src.recv(4096)
                        if not data:
                            break
                        if first_write[0]:
                            first_write[0] = False
                            time.sleep(0.2)
                        if mode == "split":
                            for i in range(0, len(data), 7):
                                dst.sendall(data[i:i + 7])
                        else:
                            dst.sendall(data)
                except (socket.timeout, OSError):
                    pass
                finally:
                    with contextlib.suppress(OSError):
                        dst.shutdown(socket.SHUT_WR)

            t = threading.Thread(target=pump, args=(up, client),
                                 daemon=True)
            t.start()
            pump(client, up)
            t.join(timeout=self.io_timeout_s)
        finally:
            with self._lock:
                self._live.discard(client)
                self._live.discard(up)
            up.close()
            client.close()
