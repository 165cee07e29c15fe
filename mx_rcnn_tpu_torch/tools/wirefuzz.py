"""wirefuzz driver: aim the deterministic fuzzer at the port's real
cross-host plane.

Counterpart of ``mx_rcnn_tpu/tools/wirefuzz.py``: the same corpora
(byte for byte and name for name at the same seed), legs, planted arms
and record, aimed at the port's counterparts.  ``analysis/wirefuzz.py``
is the engine (seeded Mutator, alloc guard, raw-socket HTTP sender,
FaultProxy); this driver points it at four targets and records the
verdicts:

* **codec** — every mutation against the in-process MXR1/MXD1
  decoders (``serve/remote.py``) under the allocation guard and a
  wall-clock deadline: malformed frames must die as ``ValueError``.
  Covers v1 fp32 frames, v2 u8 source frames (dtype-tag confusion, a
  u8 frame claiming an fp32 length), multi-frame envelopes
  (count-prefix lies, per-member truncation/inflation, poisoned
  members) and both result framings;
* **agent** — a LIVE per-host agent (``serve/agent.py — ReplicaAgent``
  of content-stub replicas, ``tools/loadgen.py —
  make_content_stub_run_fn``, with a 2 s body deadline): mutated frames
  over real HTTP must come back 4xx (never 5xx, never a wedged
  handler), plus the HTTP-level attacks — multi-GB Content-Length
  claims (413), absent Content-Length (411), slow-trickled bodies (408
  at the deadline), mid-frame disconnects, garbage pipelined behind a
  valid frame — and the server must still answer ``/healthz`` and
  serve a GOOD frame afterward;
* **httpsource** — ``obs/collect.py — HttpSource`` against a malicious
  metrics endpoint (unbounded stream, slow trickle, garbage): every
  scrape returns ``None`` inside its deadline, memory capped;
* **proxy** — a fault-injecting TCP proxy (truncate / reset / delay /
  split / black-hole) between ``build_crosshost_router`` and one of its
  two agents: every submitted frame must reach exactly one terminal
  state and the healthy lane keeps serving (reroute, exactly-once).

Three PLANTED ARMS prove sensitivity (a fuzzer that cannot catch a
seeded bug proves nothing): a zero-fill-on-short-read decoder variant
(accepts truncated frames → flagged), an uncapped-length variant
(allocates off the wire's row count → the alloc guard flags it), and
a trusting-envelope variant (believes count/length prefixes, zero-
fills short members → flagged).  All carry netlint waivers — the
static layer flags them too.

It runs no model, so it takes no ``--device``: the stand-in agents'
replicas run on the host.  The port's differences: the record is
written only where ``--out`` names a file, and ``leg_agent`` /
``leg_proxy`` take live agents to aim at (``chip_smoke.py`` phase 25
aims them at ResNet-101 agent processes on the card); called as the
JAX tool calls them, they start their own stand-in agents.

Usage::

    python -m mx_rcnn_tpu_torch.tools.wirefuzz [--seed 16] [--smoke]
        [--out record.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import socket
import struct
import threading
import time
from typing import Dict, List

import numpy as np

from mx_rcnn_tpu_torch.analysis.wirefuzz import (ACCEPTED_VALID, ALLOC,
                                                 CRASHED, HUNG, REJECTED,
                                                 FaultProxy, Mutation,
                                                 Mutator, fuzz_codec,
                                                 http_case_outcome,
                                                 http_post_raw, run_case,
                                                 summarize)
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.serve.remote import (_ENV_HEAD, _ENV_LEN, _REQ_HEAD,
                                            _REQ_HEAD2, _RESP_ENTRY,
                                            _RESP_HEAD, _RESP_TRACE_EXT,
                                            DTYPE_F32, ENV_MAGIC,
                                            ENV_VERSION, MAX_ENV_FRAMES,
                                            RESULT_MAGIC, WIRE_MAGIC,
                                            WIRE_VERSION_SRC,
                                            decode_envelope,
                                            decode_frame_ex,
                                            decode_prepared,
                                            decode_prepared_ex,
                                            decode_result,
                                            decode_result_envelope,
                                            decode_result_ex,
                                            encode_prepared, encode_result,
                                            encode_result_envelope,
                                            encode_source)

logger = logging.getLogger("mx_rcnn_tpu_torch")

# MXR1 request header spans: load-bearing fields (a flip must reject)
# vs data-carrying fields (a flip must merely stay typed/no-crash).
# The former reserved field (12:14) is now FLAGS and load-bearing: any
# set bit either declares a trace extension that is not present or is
# an unknown flag — both must typed-reject on an untraced frame.
REQ_REJECT_SPANS = [("magic", 0, 4), ("version", 4, 6),
                    ("h", 6, 8), ("w", 8, 10), ("c", 10, 12),
                    ("flags", 12, 14)]
REQ_BENIGN_SPANS = [("timeout", 14, 18), ("im_info", 18, 30)]
# MXD1 result header + first entry: the class id is data, the row
# COUNT is load-bearing (it sizes the decode)
RES_REJECT_SPANS = [("magic", 0, 4), ("version", 4, 6), ("n", 6, 8),
                    ("k0", 10, 14)]
RES_BENIGN_SPANS = [("cid0", 8, 10)]


def _prepared_frame(shape=(16, 20), seed=0) -> bytes:
    rng = np.random.RandomState(seed)
    data = (rng.rand(*shape, 3) * 255.0).astype(np.float32)
    info = np.array([shape[0], shape[1], 1.0], np.float32)
    return encode_prepared(data, info, 500.0)


def _result_frame(seed=0) -> bytes:
    rng = np.random.RandomState(seed)
    return encode_result({1: rng.rand(4, 5).astype(np.float32),
                          3: np.zeros((0, 5), np.float32)})


def prepared_corpus(seed: int, shape=(16, 20)) -> List[Mutation]:
    frame = _prepared_frame(shape)
    inflate = bytearray(frame)
    struct.pack_into("<HHH", inflate, 6, 0xFFFF, 0xFFFF, 0xFFFF)
    zero = bytearray(frame[:_REQ_HEAD.size])
    struct.pack_into("<HHH", zero, 6, 0, 0, 0)
    extra = [
        # dims claim 65535^3 over the same small payload: the decoder
        # must refuse off the length MISMATCH, allocating nothing
        Mutation("inflate:dims=65535^3", bytes(inflate), True),
        # all-zero dims with an empty payload is self-consistent: the
        # codec may accept it (downstream shape checks own it) but it
        # must never crash
        Mutation("zero-dims", bytes(zero), False),
    ]
    return Mutator(seed).corpus(frame, _REQ_HEAD.size, REQ_REJECT_SPANS,
                                REQ_BENIGN_SPANS, extra=extra)


def traced_prepared_corpus(seed: int, shape=(16, 20)) -> List[Mutation]:
    """Trace-extension arms over a ctx-carrying MXR1 frame.  Once the
    flag bit declares an extension, the extension bytes are
    LOAD-BEARING: truncations, inflations, version/length lies, and
    charset violations must typed-reject (never zero-fill or silently
    degrade to untraced) — only unknown ctx FLAG bits are the pinned
    forward-compat carve-out (ignored, frame decodes)."""
    rng = np.random.RandomState(seed)
    data = (rng.rand(*shape, 3) * 255.0).astype(np.float32)
    info = np.array([shape[0], shape[1], 1.0], np.float32)
    ctx = obs_trace.TraceContext("feed.1234abcd", parent=0xDEAD,
                                 hop=2, sampled=True)
    frame = encode_prepared(data, info, 500.0, ctx=ctx)
    ext_off = _REQ_HEAD.size + shape[0] * shape[1] * 3 * 4
    ext_len = len(frame) - ext_off

    def patched(off: int, val: int) -> bytes:
        d = bytearray(frame)
        d[off] = val
        return bytes(d)

    muts = [
        Mutation("tr:valid", frame, False),
        # flag set, extension entirely absent
        Mutation("tr:trunc@ext", frame[:ext_off], True),
        # extension cut inside its fixed header
        Mutation("tr:trunc@ext+3", frame[:ext_off + 3], True),
        # one byte short of the declared id length
        Mutation("tr:trunc@-1", frame[:-1], True),
        # inflated: trailing bytes past the declared id length
        Mutation("tr:inflate+1", frame + b"\0", True),
        Mutation("tr:inflate+64", frame + b"\x41" * 64, True),
        # ctx version lies (byte 0 of the extension)
        Mutation("tr:ctx-version=0", patched(ext_off, 0), True),
        Mutation("tr:ctx-version=255", patched(ext_off, 255), True),
        # unknown ctx FLAG bits: forward-compat, must decode
        Mutation("tr:ctx-flags=0x81", patched(ext_off + 1, 0x81), False),
        # id-length lies (byte 12 of the extension): zero, over-cap,
        # and off-by-one against the actual payload
        Mutation("tr:idlen=0", patched(ext_off + 12, 0), True),
        Mutation("tr:idlen=255", patched(ext_off + 12, 255), True),
        Mutation("tr:idlen+1",
                 patched(ext_off + 12, ext_len - 13 + 1), True),
        # id charset violation (first id byte → '!')
        Mutation("tr:id-charset", patched(ext_off + 13, 0x21), True),
        Mutation("tr:id-nonascii", patched(ext_off + 13, 0xFF), True),
    ]
    # deterministic bit flips across the extension: every arm must
    # either reject or decode to a well-formed ctx — never crash
    for i in range(ext_len):
        off = ext_off + i
        d = bytearray(frame)
        d[off] ^= 1 << (i % 8)
        muts.append(Mutation(f"tr:flip@ext+{i}.{i % 8}",
                             bytes(d), False))
    return muts


def traced_result_corpus(seed: int) -> List[Mutation]:
    """Skew-extension arms over a version-2 MXD1 result: the 16-byte
    (t1, t2) extension must be exactly present, and a send stamp that
    precedes the receive stamp is a lie the codec rejects."""
    rng = np.random.RandomState(seed)
    dets = {1: rng.rand(4, 5).astype(np.float32),
            3: np.zeros((0, 5), np.float32)}
    v2 = encode_result(dets, ts_pair=(1_000_000, 1_000_500))
    v1 = encode_result(dets)
    muts = [
        Mutation("trr:valid-v2", v2, False),
        # t2 == t1 is legal (a zero-latency stub)
        Mutation("trr:t2==t1", encode_result(dets, ts_pair=(7, 7)),
                 False),
        # send stamp precedes receive
        Mutation("trr:t2<t1",
                 encode_result(dets, ts_pair=(1_000_500, 1_000_000)),
                 True),
        # version 2 with the extension truncated / absent
        Mutation("trr:ext-trunc", v2[:-1], True),
        Mutation("trr:ext-absent", v2[:-_RESP_TRACE_EXT.size], True),
        # version 2 with an inflated extension
        Mutation("trr:ext-inflate", v2 + b"\0" * 4, True),
        # version 1 carrying trailing extension bytes it never declared
        Mutation("trr:v1-trailing-ext",
                 v1 + v2[-_RESP_TRACE_EXT.size:], True),
    ]
    # bit flips inside the stamps: reject (t2<t1) or decode, no crash
    rnd = np.random.RandomState(seed + 1)
    for _ in range(8):
        off = len(v2) - _RESP_TRACE_EXT.size + int(rnd.randint(0, 16))
        bit = int(rnd.randint(0, 8))
        d = bytearray(v2)
        d[off] ^= 1 << bit
        muts.append(Mutation(f"trr:flip@ext+{off - (len(v2) - 16)}.{bit}",
                             bytes(d), False))
    return muts


def result_corpus(seed: int) -> List[Mutation]:
    frame = _result_frame()
    inflate = bytearray(frame)
    struct.pack_into("<I", inflate, 10, 0x7FFFFFFF)  # k0 → 2^31-1 rows
    many = bytearray(frame)
    struct.pack_into("<H", many, 6, 0xFFFF)          # n → 65535 entries
    extra = [Mutation("inflate:k0=2^31-1", bytes(inflate), True),
             Mutation("inflate:n=65535", bytes(many), True)]
    return Mutator(seed).corpus(frame, _RESP_HEAD.size, RES_REJECT_SPANS,
                                RES_BENIGN_SPANS, extra=extra)


# MXR1 v2 header ("<4sHHHHHHHHf3f"): the dtype TAG and the
# (h, w, c) payload sizing are load-bearing — a flip must reject off
# the dtype/length disagreement, never reinterpret the pixels.  The
# BUCKET dims are data at codec level (the agent's configured-bucket
# check owns them; a flip below h rejects, above merely retargets), so
# they sit in the benign set with the timeout and im_info.
REQ2_REJECT_SPANS = [("magic", 0, 4), ("version", 4, 6),
                     ("dtype", 6, 8), ("h", 8, 10), ("w", 10, 12),
                     ("c", 12, 14), ("flags", 18, 20)]
REQ2_BENIGN_SPANS = [("bh", 14, 16), ("bw", 16, 18),
                     ("timeout", 20, 24), ("im_info", 24, 36)]


def _source_frame(bucket=(16, 24), hw=(12, 20), seed=0) -> bytes:
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, size=(hw[0], hw[1], 3), dtype=np.uint8)
    info = np.array([hw[0], hw[1], 1.0], np.float32)
    return encode_source(img, info, bucket, 500.0)


def _f32_partial_frame(bucket=(16, 24), hw=(12, 20)) -> bytes:
    """Hand-packed v2 fp32 frame SMALLER than its bucket — no encoder
    produces this (fp32 v2 means a full canvas), so it is pure wire
    corruption the decoder must refuse."""
    payload = np.zeros((hw[0], hw[1], 3), np.float32).tobytes()
    head = _REQ_HEAD2.pack(WIRE_MAGIC, WIRE_VERSION_SRC, DTYPE_F32,
                           hw[0], hw[1], 3, bucket[0], bucket[1], 0,
                           500.0, float(hw[0]), float(hw[1]), 1.0)
    return head + payload


def source_corpus(seed: int) -> List[Mutation]:
    """v2 u8 source-frame arms: dtype-tag confusion and dtype/length
    lies on top of the generic header/truncation/flip corpus."""
    frame = _source_frame(seed=seed)
    as_f32 = bytearray(frame)
    struct.pack_into("<H", as_f32, 6, DTYPE_F32)
    unknown = bytearray(frame)
    struct.pack_into("<H", unknown, 6, 7)
    inflate = bytearray(frame)
    struct.pack_into("<HH", inflate, 8, 0x7FFF, 0x7FFF)
    extra = [
        # u8 pixels re-tagged fp32: the length disagreement (1 B/px on
        # the wire, 4 B/px claimed) must reject — NEVER reinterpret
        Mutation("v2:dtype-u8-claims-f32", bytes(as_f32), True),
        # a u8 frame shipped with an fp32-sized payload (4x too long)
        Mutation("v2:u8-with-f32-length",
                 frame + b"\0" * (len(frame) - _REQ_HEAD2.size) * 3,
                 True),
        Mutation("v2:dtype-unknown=7", bytes(unknown), True),
        # dims claim 32767^2 over the same small payload: refuse off
        # the length mismatch, allocating nothing
        Mutation("v2:inflate:dims", bytes(inflate), True),
        # fp32 v2 frame that is not a full canvas
        Mutation("v2:f32-partial-canvas", _f32_partial_frame(), True),
    ]
    return Mutator(seed).corpus(frame, _REQ_HEAD2.size,
                                REQ2_REJECT_SPANS, REQ2_BENIGN_SPANS,
                                extra=extra)


def _envelope(frames: List[bytes], count: int = None) -> bytes:
    n = len(frames) if count is None else count
    return b"".join([_ENV_HEAD.pack(ENV_MAGIC, ENV_VERSION, n)]
                    + [_ENV_LEN.pack(len(f)) + f for f in frames])


def _decode_envelope_frames(buf):
    """The agent's composite: envelope split, then every member frame
    decoded — ANY malformed member rejects the whole envelope."""
    return [decode_frame_ex(f) for f in decode_envelope(buf)]


# request envelope header: magic, version, count, then the first
# member's length prefix — every one load-bearing
ENV_REJECT_SPANS = [("magic", 0, 4), ("version", 4, 6),
                    ("count", 6, 8), ("len0", 8, 12)]


def envelope_corpus(seed: int) -> List[Mutation]:
    """Multi-frame envelope arms: count-prefix lies, length-prefix
    lies, per-member truncation/inflation, a poisoned member among
    valid mates — all must reject as a WHOLE envelope."""
    f1 = _prepared_frame((16, 20), seed)          # v1 fp32 member
    f2 = _source_frame(seed=seed + 1)             # v2 u8, pads on agent
    f3 = _source_frame(hw=(16, 24), seed=seed + 2)  # v2 u8 full canvas
    env = _envelope([f1, f2, f3])
    len_inflate = bytearray(_envelope([f1]))
    struct.pack_into("<I", len_inflate, 8, len(f1) + 1000)
    extra = [
        Mutation("env:valid-mixed", env, False),
        Mutation("env:valid-single", _envelope([f2]), False),
        # count-prefix lies: more frames than shipped, fewer than
        # shipped (trailing bytes), zero, and over the hard cap
        Mutation("env:count-over", _envelope([f1, f2], count=3), True),
        Mutation("env:count-under", _envelope([f1, f2, f3], count=2),
                 True),
        Mutation("env:count=0", _envelope([], count=0), True),
        Mutation("env:count-over-cap",
                 _envelope([f1], count=MAX_ENV_FRAMES + 1), True),
        # member length prefix past the bytes actually present
        Mutation("env:len-inflate", bytes(len_inflate), True),
        # member truncated under an honest length prefix
        Mutation("env:member-trunc",
                 _envelope([f1, f2[:len(f2) // 2], f3]), True),
        # member inflated under an honest length prefix
        Mutation("env:member-inflate", _envelope([f1, f3 + b"\0\0"]),
                 True),
        # one garbage member between two valid mates
        Mutation("env:member-poisoned",
                 _envelope([f1, b"\x07GARBAGE", f3]), True),
    ]
    return Mutator(seed).corpus(env, _ENV_HEAD.size + _ENV_LEN.size,
                                ENV_REJECT_SPANS, extra=extra)


def result_envelope_corpus(seed: int) -> List[Mutation]:
    """Response-envelope arms: per-entry status codes are load-bearing
    (an unknown terminal must reject, not default), and the entry
    count/length discipline matches the request side."""
    ok = encode_result_envelope([(0, _result_frame(seed)), (1, b""),
                                 (3, b"agent exploded")])
    bad_status = bytearray(ok)
    struct.pack_into("<H", bad_status, _ENV_HEAD.size, 9)
    count_over = bytearray(ok)
    struct.pack_into("<H", count_over, 6, 4)
    muts = [
        Mutation("renv:valid", ok, False),
        Mutation("renv:status-unknown=9", bytes(bad_status), True),
        Mutation("renv:count-over", bytes(count_over), True),
        Mutation("renv:trunc@-1", ok[:-1], True),
        Mutation("renv:trunc@head", ok[:_ENV_HEAD.size - 2], True),
        Mutation("renv:inflate+4", ok + b"\0" * 4, True),
        Mutation("renv:req-magic", ENV_MAGIC + ok[4:], True),
    ]
    return muts


# ---------------------------------------------------------------------------
# leg A: in-process codec
# ---------------------------------------------------------------------------

def leg_codec(seed: int, smoke: bool = False) -> Dict:
    shapes = ([(16, 20)] if smoke
              else [(16, 20), (40, 24), (8, 12)])
    results: List[Dict] = []
    for i, shape in enumerate(shapes):
        muts = prepared_corpus(seed + i, shape)
        results += fuzz_codec(decode_prepared, muts)
    for j in (7, 9) if not smoke else (7,):
        results += fuzz_codec(decode_result, result_corpus(seed + j))
    # trace-extension arms: the ctx-carrying request frame and
    # the skew-carrying v2 result, against the _ex decode surfaces
    results += fuzz_codec(decode_prepared_ex,
                          traced_prepared_corpus(seed))
    results += fuzz_codec(decode_result_ex, traced_result_corpus(seed))
    # v2 source frames + multi-frame envelopes: dtype-tag
    # confusion, count-prefix lies, per-member truncation/inflation —
    # against decode_frame_ex and the envelope→frame composite.  The
    # v1 corpus also re-runs through the version-dispatching
    # decode_frame_ex: the dispatcher must reject exactly what the
    # pinned v1 decoder rejects
    results += fuzz_codec(decode_frame_ex, source_corpus(seed + 20))
    results += fuzz_codec(decode_frame_ex,
                          prepared_corpus(seed + 21, (16, 20)))
    results += fuzz_codec(_decode_envelope_frames,
                          envelope_corpus(seed + 22))
    results += fuzz_codec(decode_result_envelope,
                          result_envelope_corpus(seed + 23))
    out = summarize(results)
    out["target"] = ("decode_prepared[_ex]/decode_result[_ex]/"
                     "decode_frame_ex/decode_[result_]envelope")
    return out


# ---------------------------------------------------------------------------
# leg B: live agent over real HTTP
# ---------------------------------------------------------------------------

def _mk_cfg(**kw):
    from mx_rcnn_tpu_torch.config import generate_config

    over = {"bucket__scale": 128, "bucket__max_size": 160,
            "bucket__shapes": ((128, 160), (160, 128)),
            "serve__batch_size": 2, "serve__max_delay_ms": 5.0,
            "fleet__replicas": 1, "fleet__health_interval_s": 30.0}
    over.update(kw)
    return generate_config("tiny", "synthetic", **over)


def _start_agent(cfg, body_deadline_s: float = None):
    from mx_rcnn_tpu_torch.serve.agent import (ReplicaAgent,
                                              make_agent_server)
    from mx_rcnn_tpu_torch.tools.loadgen import make_content_stub_run_fn

    # stand-in replicas: no model, so they run on the host
    ag = ReplicaAgent(cfg, run_fn_factory=(
        lambda rid: make_content_stub_run_fn(cfg)), device="cpu")
    srv = make_agent_server(ag, "127.0.0.1", 0)
    if body_deadline_s is not None:
        srv.body_deadline_s = body_deadline_s
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address[:2]
    return ag, srv, host, port


def _stop_agent(ag, srv):
    srv.shutdown()
    srv.server_close()
    ag.close()


def _good_frame(cfg) -> bytes:
    b = tuple(cfg.bucket.shapes[0])
    rng = np.random.RandomState(5)
    data = (rng.rand(*b, 3) * 255.0).astype(np.float32)
    return encode_prepared(data,
                           np.array([b[0], b[1], 1.0], np.float32),
                           10_000.0)


def _healthz_ok(host: str, port: int, timeout_s: float = 10.0) -> bool:
    import urllib.request

    from mx_rcnn_tpu_torch.netio import read_limited

    with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                timeout=timeout_s) as r:
        return (r.status == 200
                and bool(json.loads(read_limited(r).decode()).get("ok")))


def leg_agent(seed: int, smoke: bool = False, target=None) -> Dict:
    """The live-agent leg.  ``target`` = (host, port, cfg) aims it at
    a running agent that serves ``cfg`` instead of a stand-in agent of
    ``_mk_cfg`` with a 2 s body deadline: the good frames are then
    ``cfg``'s canvases, and the slow-trickle case, which waits for the
    agent's own body deadline, is left out."""
    deadline_s = 15.0
    if target is None:
        cfg = _mk_cfg()
        ag, srv, host, port = _start_agent(cfg, body_deadline_s=2.0)
    else:
        host, port, cfg = target
        ag = srv = None
    results: List[Dict] = []

    def record(case: str, outcome: str, detail: str = None):
        r = {"case": case, "outcome": outcome}
        if detail:
            r["detail"] = detail
        results.append(r)

    try:
        good = _good_frame(cfg)
        # mutated frames over the wire: the per-shape corpus is built
        # on the small frame (fast), shipped as /prepared bodies
        muts = [m for m in prepared_corpus(seed, (16, 20))
                if m.must_reject]
        if smoke:
            muts = muts[::4]
        for m in muts:
            res = http_post_raw(host, port, "/prepared", m.data)
            record(f"http:{m.name}",
                   http_case_outcome(res, True, deadline_s),
                   res.get("error"))
        # HTTP-level attacks
        for case, kw, want in [
            ("huge-content-length",
             dict(body=good[:64], content_length=3 << 30), 413),
            ("absent-content-length",
             dict(body=good, content_length="absent"), 411),
            ("trickle-past-deadline",
             dict(body=good, mode="trickle", trickle_bytes=10 ** 9,
                  trickle_delay_s=0.05, timeout_s=30.0), 408),
            ("garbage-json-detect",
             dict(path="/detect", body=b"\xff\xfe{{{",
                  ctype="application/json"), 400),
            ("wrong-route",
             dict(path="/nope", body=b"x"), 404),
        ]:
            if target is not None and case == "trickle-past-deadline":
                continue
            kw.setdefault("path", "/prepared")
            res = http_post_raw(host, port, **kw)
            ok = res.get("status") == want
            record(f"http:{case}",
                   REJECTED if ok else CRASHED,
                   None if ok else f"want {want}, got {res}")
        # trickle note: the sender gives up when the server's 408
        # arrives (the read side unblocks) — elapsed must sit near the
        # server's 2 s body deadline, not the client's 30 s budget
        # mid-frame disconnect: no response expected, server survives
        res = http_post_raw(host, port, "/prepared", good,
                            mode="disconnect")
        record("http:mid-frame-disconnect",
               REJECTED if res.get("error") == "client-disconnect"
               else CRASHED)
        # garbage pipelined behind a valid frame on one connection:
        # the first response must be an intact 200
        sock = socket.create_connection((host, port), timeout=deadline_s)
        try:
            head = (f"POST /prepared HTTP/1.1\r\nHost: f\r\n"
                    f"Content-Type: application/x-mxr1\r\n"
                    f"Content-Length: {len(good)}\r\n\r\n").encode()
            sock.sendall(head + good + b"\x07GARBAGE NOT HTTP\r\n\r\n")
            first = sock.recv(64)
            ok = first.startswith(b"HTTP/1.1 200")
            record("http:pipelined-garbage",
                   ACCEPTED_VALID if ok else CRASHED,
                   None if ok else repr(first[:40]))
        finally:
            sock.close()
        # traced frames over the wire: a valid ctx-carrying frame must
        # serve (200), a mutilated extension must 4xx — and must NOT
        # silently serve as untraced (the no-zero-fill contract holds
        # end-to-end, not just in-process)
        tmuts = [m for m in traced_prepared_corpus(seed, (16, 20))
                 if m.must_reject]
        if smoke:
            tmuts = tmuts[::4]
        for m in tmuts:
            res = http_post_raw(host, port, "/prepared", m.data)
            record(f"http:{m.name}",
                   http_case_outcome(res, True, deadline_s),
                   res.get("error"))
        b = tuple(cfg.bucket.shapes[0])
        rng = np.random.RandomState(seed + 3)
        good_traced = encode_prepared(
            (rng.rand(*b, 3) * 255.0).astype(np.float32),
            np.array([b[0], b[1], 1.0], np.float32), 10_000.0,
            ctx=obs_trace.TraceContext("feed.cafe", parent=0xBEEF,
                                       hop=1, sampled=True))
        res = http_post_raw(host, port, "/prepared", good_traced,
                            timeout_s=30.0)
        record("http:tr:good-traced-frame",
               ACCEPTED_VALID if res.get("status") == 200 else CRASHED,
               None if res.get("status") == 200 else str(res))
        # v2 source frames + envelopes over the wire: every
        # must-reject mutation comes back 4xx from /prepared (v2) and
        # /frames (envelopes) — a poisoned envelope rejects WHOLE
        smuts = [m for m in source_corpus(seed + 20) if m.must_reject]
        emuts = [m for m in envelope_corpus(seed + 22) if m.must_reject]
        if smoke:
            smuts, emuts = smuts[::4], emuts[::4]
        for m in smuts:
            res = http_post_raw(host, port, "/prepared", m.data)
            record(f"http:{m.name}",
                   http_case_outcome(res, True, deadline_s),
                   res.get("error"))
        for m in emuts:
            res = http_post_raw(host, port, "/frames", m.data)
            record(f"http:{m.name}",
                   http_case_outcome(res, True, deadline_s),
                   res.get("error"))
        # ... and the well-formed v2 path serves: a sub-bucket u8
        # frame (the agent pads) and a two-frame envelope both 200
        rng2 = np.random.RandomState(seed + 7)
        src = rng2.randint(0, 256, size=(b[0] - 8, b[1] - 8, 3),
                           dtype=np.uint8)
        good_src = encode_source(
            src, np.array([b[0] - 8, b[1] - 8, 1.0], np.float32), b,
            10_000.0)
        res = http_post_raw(host, port, "/prepared", good_src,
                            timeout_s=30.0)
        record("http:v2:good-source-frame",
               ACCEPTED_VALID if res.get("status") == 200 else CRASHED,
               None if res.get("status") == 200 else str(res))
        res = http_post_raw(host, port, "/frames",
                            _envelope([good_src, good]), timeout_s=30.0)
        record("http:env:good-envelope",
               ACCEPTED_VALID if res.get("status") == 200 else CRASHED,
               None if res.get("status") == 200 else str(res))
        # aftermath: the server still answers /healthz and serves a
        # good frame — no fuzz case may have wedged it
        record("aftermath:healthz",
               ACCEPTED_VALID if _healthz_ok(host, port) else CRASHED)
        res = http_post_raw(host, port, "/prepared", good,
                            timeout_s=30.0)
        record("aftermath:good-frame",
               ACCEPTED_VALID if res.get("status") == 200 else CRASHED,
               None if res.get("status") == 200 else str(res))
    finally:
        if ag is not None:
            _stop_agent(ag, srv)
    out = summarize(results)
    out["target"] = f"live agent http://{host}:{port}"
    return out


# ---------------------------------------------------------------------------
# leg C: HttpSource vs a malicious metrics endpoint
# ---------------------------------------------------------------------------

class _EvilMetrics:
    """A metrics endpoint that misbehaves on purpose: ``good`` (valid
    snapshot), ``garbage`` (200 with non-JSON), ``flood`` (streams
    zeros far past any cap), ``trickle`` (one byte per tick, forever —
    the slow-loris that never trips a socket timeout)."""

    def __init__(self, behavior: str):
        self.behavior = behavior
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(0.25)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.address = self._sock.getsockname()[:2]
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        self._sock.close()
        self._thread.join(timeout=5.0)

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        conn.settimeout(10.0)
        try:
            buf = b""
            while b"\r\n\r\n" not in buf and len(buf) < 65536:
                d = conn.recv(4096)
                if not d:
                    return
                buf += d
            if self.behavior == "good":
                body = json.dumps({"counters": {"up": 1.0},
                                   "gauges": {}, "hists": {}}).encode()
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: "
                             b"application/json\r\nContent-Length: "
                             + str(len(body)).encode() + b"\r\n\r\n"
                             + body)
            elif self.behavior == "garbage":
                body = b"<html>definitely not a registry snapshot"
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: "
                             + str(len(body)).encode() + b"\r\n\r\n"
                             + body)
            elif self.behavior == "flood":
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: "
                             b"1073741824\r\n\r\n")
                chunk = b"\0" * 65536
                while not self._stop.is_set():
                    conn.sendall(chunk)
            elif self.behavior == "trickle":
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: "
                             b"1000000\r\n\r\n")
                while not self._stop.is_set():
                    conn.sendall(b"{")
                    time.sleep(0.05)
        except OSError:
            pass  # the scraper hung up: exactly what we want
        finally:
            conn.close()


def leg_httpsource(seed: int) -> Dict:
    from mx_rcnn_tpu_torch.obs.collect import HttpSource

    results: List[Dict] = []
    for behavior, must_fail in [("good", False), ("garbage", True),
                                ("flood", True), ("trickle", True)]:
        ev = _EvilMetrics(behavior)
        try:
            host, port = ev.address
            src = HttpSource(f"evil-{behavior}", f"{host}:{port}",
                             timeout_s=0.5, max_bytes=64 << 10)
            t0 = time.monotonic()
            got = src.scrape()
            dt = time.monotonic() - t0
            # deadline = timeout_s (connect+headers) + 4x timeout_s
            # (read_limited's wall bound) + slack
            if dt > 0.5 * 4 + 2.0:
                outcome = HUNG
            elif must_fail:
                outcome = REJECTED if got is None else "accepted_malformed"
            else:
                outcome = (ACCEPTED_VALID if got is not None
                           else CRASHED)
            results.append({"case": f"scrape:{behavior}",
                            "outcome": outcome,
                            "detail": f"{dt:.2f}s"})
        finally:
            ev.close()
    out = summarize(results)
    out["target"] = "obs.collect.HttpSource"
    return out


# ---------------------------------------------------------------------------
# leg D: fault proxy between head and agent (reroute + exactly-once)
# ---------------------------------------------------------------------------

def _same_dets(got, want) -> bool:
    """Detections equal class for class, dtype and bytes."""
    return sorted(got) == sorted(want) and all(
        got[c].dtype == want[c].dtype and got[c].tobytes() == want[c].tobytes()
        for c in want)


def leg_proxy(seed: int, cfg=None, urls=None, frames=None,
              want=None) -> Dict:
    """The fault-proxy leg.  ``urls`` (two agents' base URLs, serving
    ``cfg``) aims it at running agents, the first behind the proxy,
    instead of two stand-in agents of ``_mk_cfg``; ``frames`` (data,
    im_info, bucket) triples then replace the random canvases, taken in
    turn, and ``want`` holds their detections: a served frame whose
    detections differ is a violation."""
    from mx_rcnn_tpu_torch.serve.queue import (DeadlineExceeded,
                                               RequestFailed, ShedError)
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router

    cfg = (_mk_cfg() if cfg is None else cfg).replace_in(
        "crosshost", connections=1, pipeline_depth=16, io_timeout_s=2.0,
        dead_after_failures=20, scrape_interval_s=0.25)
    cfg = cfg.replace_in("fleet", health_interval_s=0.25, reroute_retries=3)
    # every connection accepted while a step is active gets that
    # step's fault; kill_live() between steps forces the head's
    # keep-alive connections to re-handshake INTO the new fault
    holder = {"mode": "pass"}

    if urls is None:
        agents = [_start_agent(cfg), _start_agent(cfg)]
        ends = [(a[2], a[3]) for a in agents]
    else:
        agents = []
        ends = [tuple(u.split("//", 1)[1].rsplit(":", 1)) for u in urls]
        ends = [(h, int(p)) for h, p in ends]
    proxy = FaultProxy(ends[0][0], ends[0][1],
                       schedule=lambda i: holder["mode"], seed=seed)
    router = feed = None
    results: List[Dict] = []
    terminal = {"served": 0, "failed": 0, "expired": 0, "shed": 0}
    turn = itertools.count()

    def submit_pair(tag: str, rng):
        reqs = []
        for i in range(2):
            if frames is None:
                b = tuple(cfg.bucket.shapes[i % 2])
                data = (rng.rand(*b, 3) * 255.0).astype(np.float32)
                info = np.array([b[0], b[1], 1.0], np.float32)
                k = None
            else:
                k = next(turn) % len(frames)
                data, info, b = frames[k]
            reqs.append((k, router.submit_prepared(data, info, b,
                                                   timeout_ms=15_000)))
        for i, (k, r) in enumerate(reqs):
            try:
                dets = r.wait(timeout=25.0)
                state = "served" if dets is not None else "failed"
            except ShedError:
                state = "shed"
            except DeadlineExceeded:
                state = "expired"
            except (RequestFailed, TimeoutError) as e:
                # a bare wait-timeout means the request never went
                # terminal: the exactly-once violation
                if isinstance(e, TimeoutError):
                    results.append({"case": f"{tag}-req{i}",
                                    "outcome": HUNG})
                    continue
                state = "failed"
            terminal[state] += 1
            if (state == "served" and want is not None
                    and not _same_dets(dets, want[k])):
                results.append({"case": f"{tag}-req{i}", "outcome": CRASHED,
                                "detail": f"frame {k}'s detections differ"})
                continue
            results.append({"case": f"{tag}-req{i}", "outcome":
                            ACCEPTED_VALID if state == "served"
                            else REJECTED})

    try:
        router, feed = build_crosshost_router(
            cfg, [f"http://{proxy.address[0]}:{proxy.address[1]}",
                  f"http://{ends[1][0]}:{ends[1][1]}"])
        rng = np.random.RandomState(seed)
        for mode in ("pass", "truncate", "reset", "split", "delay",
                     "blackhole", "pass"):
            holder["mode"] = mode
            proxy.kill_live()  # force reconnect under the new fault
            submit_pair(mode, rng)
        # reroute: the healthy lane must have absorbed every fault —
        # each request served inside its original deadline
        if terminal["served"] < 12:
            results.append({"case": "reroute-served", "outcome": CRASHED,
                            "detail": str(terminal)})
        if not _healthz_ok(*ends[1]):
            results.append({"case": "aftermath:agent1-healthz",
                            "outcome": CRASHED})
        out = summarize(results)
        out["terminal"] = terminal
        out["faults_applied"] = list(proxy.faults_applied)
    finally:
        if feed is not None:
            feed.close()
        if router is not None:
            router.close()
        proxy.close()
        for a in agents:
            _stop_agent(a[0], a[1])
    out["target"] = "crosshost router through FaultProxy"
    return out


# ---------------------------------------------------------------------------
# planted arms: the sensitivity proof
# ---------------------------------------------------------------------------

def _decode_prepared_zerofill(buf: bytes):
    """PLANTED ARM, never wired into serving: the classic broken
    decoder that pads a short read with zeros instead of rejecting it.
    wirefuzz must flag it (truncations decode "fine") and netlint
    already does statically — the waivers below are the proof both
    layers see it."""
    # netlint: disable=NL202 planted arm: zero-fill pad sized off wire
    b = bytes(buf) + b"\0" * max(0, _REQ_HEAD.size - len(buf))
    # netlint: disable=NL201 planted arm: unpack with no length check
    parts = _REQ_HEAD.unpack_from(b)
    magic, _ver, h, w, c = parts[0], parts[1], parts[2], parts[3], parts[4]
    if magic != WIRE_MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    want = _REQ_HEAD.size + h * w * c * 4
    if len(b) < want:
        b = b + b"\0" * (want - len(b))  # zero-fill the missing bytes
    data = np.frombuffer(b, np.float32, count=h * w * c,
                         offset=_REQ_HEAD.size)
    return data.reshape(h, w, c)


def _decode_result_uncapped(buf: bytes):
    """PLANTED ARM, never wired into serving: trusts the wire's row
    count to size an allocation BEFORE any bounds check — the alloc
    guard must flag the 2^31-row inflation as AllocationCapExceeded
    (and truncations crash as struct.error, not ValueError)."""
    # netlint: disable=NL201 planted arm: unpack with no length check
    magic, _ver, n = _RESP_HEAD.unpack_from(buf)
    if magic != RESULT_MAGIC:
        raise ValueError(f"bad result magic {magic!r}")
    off = _RESP_HEAD.size
    out = {}
    for _ in range(n):
        # netlint: disable=NL201,NL202 planted arm: wire k sizes zeros
        cid, k = _RESP_ENTRY.unpack_from(buf, off)
        off += _RESP_ENTRY.size
        # netlint: disable=NL202 planted arm: unbounded wire-sized alloc
        rows = np.zeros((k, 5), np.float32)
        avail = np.frombuffer(buf, np.uint8, count=min(
            k * 20, max(0, len(buf) - off)), offset=off)
        rows.reshape(-1)[:avail.size // 4] = avail[
            :avail.size // 4 * 4].view(np.float32)
        out[cid] = rows
        off += k * 20
    return out


def _decode_envelope_trusting(buf):
    """PLANTED ARM, never wired into serving: trusts the envelope's
    count and per-member length prefixes — a count lie walks off the
    buffer (struct.error, not a typed rejection), a short member gets
    ZERO-FILLED to its declared length instead of rejected, and the
    trailing-bytes check is absent (an inflated envelope "decodes").
    wirefuzz must flag all three; the waivers below are netlint seeing
    the same bugs statically."""
    # netlint: disable=NL201 planted arm: unpack with no length check
    magic, _ver, count = _ENV_HEAD.unpack_from(buf)
    if magic != ENV_MAGIC:
        raise ValueError(f"bad envelope magic {magic!r}")
    off = _ENV_HEAD.size
    frames = []
    for _ in range(count):
        # netlint: disable=NL201,NL202 planted arm: trusted length prefix
        (n,) = _ENV_LEN.unpack_from(buf, off)
        off += _ENV_LEN.size
        member = bytes(buf[off:off + n])
        member += b"\0" * (n - len(member))  # zero-fill the short read
        frames.append(member)
        off += n
    return frames


def leg_planted(seed: int) -> Dict:
    # the zero-fill arm sees truncations + flips only: its inflation
    # "acceptance" would be a multi-GB bytes pad, which is the OTHER
    # arm's job to demonstrate (under the guard)
    zf_muts = [m for m in prepared_corpus(seed, (16, 20))
               if m.name.startswith(("trunc@", "flip:", "header-only"))]
    zf = summarize(run_case(_decode_prepared_zerofill, m,
                            alloc_cap=256 << 20) for m in zf_muts)
    un = summarize(fuzz_codec(_decode_result_uncapped,
                              result_corpus(seed)))
    # the trusting-envelope arm sees the full envelope corpus: count
    # lies must crash it (walks off the buffer) and member truncations
    # must "decode" (zero-filled) — both are violations it cannot hide
    env = summarize(fuzz_codec(_decode_envelope_trusting,
                               envelope_corpus(seed + 22)))
    zf_flagged = len(zf["violations"]) > 0
    un_flagged = any(v["outcome"] == ALLOC for v in un["violations"])
    env_flagged = len(env["violations"]) > 0
    return {
        "zerofill": {"cases": zf["cases"], "outcomes": zf["outcomes"],
                     "flagged": zf_flagged},
        "uncapped": {"cases": un["cases"], "outcomes": un["outcomes"],
                     "alloc_flagged": un_flagged,
                     "flagged": len(un["violations"]) > 0},
        "trusting_envelope": {"cases": env["cases"],
                              "outcomes": env["outcomes"],
                              "flagged": env_flagged},
        "ok": zf_flagged and un_flagged and env_flagged,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run(seed: int = 16, smoke: bool = False) -> Dict:
    t0 = time.monotonic()
    legs: Dict[str, Dict] = {}
    legs["codec"] = leg_codec(seed, smoke=smoke)
    legs["agent"] = leg_agent(seed, smoke=smoke)
    if not smoke:
        legs["httpsource"] = leg_httpsource(seed)
        legs["proxy"] = leg_proxy(seed)
    planted = leg_planted(seed)
    cases = sum(d["cases"] for d in legs.values())
    violations = [dict(v, leg=name) for name, d in legs.items()
                  for v in d["violations"]]
    doc = {
        "metric": "wirefuzz_violations",
        "value": len(violations),
        "seed": seed,
        "smoke": smoke,
        "corpus_cases": cases,
        "legs": legs,
        "planted": planted,
        "ok": not violations and planted["ok"],
        "elapsed_s": round(time.monotonic() - t0, 1),
    }
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="wirefuzz",
        description="Deterministic wire-protocol fuzz of the port's "
                    "cross-host plane")
    p.add_argument("--seed", type=int, default=16)
    p.add_argument("--smoke", action="store_true",
                   help="the quick subset (codec + live agent + planted "
                        "arms)")
    p.add_argument("--out", default=None,
                   help="write the result JSON here (default: none)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    doc = run(seed=args.seed, smoke=args.smoke)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    brief = {k: doc[k] for k in ("metric", "value", "corpus_cases",
                                 "ok", "elapsed_s")}
    brief["planted_ok"] = doc["planted"]["ok"]
    print(json.dumps(brief))
    if doc["value"]:
        for v in [dict(v, leg=name) for name, d in doc["legs"].items()
                  for v in d["violations"]]:
            print(json.dumps(v))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
