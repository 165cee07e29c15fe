"""The cross-host serving tier held against the JAX package's on the CPU.

The wire codecs (v1 prepared frames, v2 source frames, envelopes, result
frames and result envelopes) byte-equal to the JAX encoders over seeded
and hypothesis-drawn inputs, each side decoding the other's frames, and
the JAX rejection battery (``tests/test_remote.py``,
``tests/test_wire_v2.py``) refused by both with the same exception type.
``CrosshostConfig`` and its ``--set`` overrides, ``PipelineController``,
``SchedulerPolicy`` and the per-agent parsers make the JAX package's
decisions on the same seeded gauge traces.  On loopback, in this
process: the port's ``RemoteEngine`` against a JAX stand-in agent and
the JAX ``RemoteEngine`` against a port stand-in agent, the lane gauges
of a port agent read by the JAX parsers, the keep-alive pin, host death
rerouted within the deadline, coalescing, an envelope member failing
alone, the lane hints' decay; a port agent over the tiny model, byte-
equal to the port's in-process engine and close to the JAX engine;
``pull_store`` (skip, resume, refusal, the double mismatch, ``kernels/``
carried, a dead endpoint typed) and ``AgentAdmin``'s typed timeout and
refusal.  Agents bind port 0 and are read off their server.
"""

import dataclasses
import hashlib
import http.client
import json
import os
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mx_rcnn_tpu.config import CrosshostConfig as JCrosshostConfig
from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.obs import trace as j_trace
from mx_rcnn_tpu.obs.timeseries import TimeSeriesStore as JTimeSeriesStore
from mx_rcnn_tpu.serve import agent as j_agent
from mx_rcnn_tpu.serve import remote as jr
from mx_rcnn_tpu.serve import scheduler as j_sched
from mx_rcnn_tpu.serve.engine import ServingEngine as JServingEngine
from mx_rcnn_tpu.tools.loadgen import \
    make_content_stub_run_fn as j_content_stub
from mx_rcnn_tpu_torch.config import (CrosshostConfig, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.data.image import pad_normalize, prepare_image
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.obs import trace as obs_trace
from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore
from mx_rcnn_tpu_torch.serve import remote
from mx_rcnn_tpu_torch.serve import scheduler as sched
from mx_rcnn_tpu_torch.serve.agent import (ReplicaAgent, StorePullError,
                                           make_agent_server,
                                           make_store_server, pull_store,
                                           store_index)
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.export import predictor_variables
from mx_rcnn_tpu_torch.serve.remote import (RemoteEngine,
                                            build_crosshost_router)
from mx_rcnn_tpu_torch.serve.scheduler import (AgentAdmin, AgentAdminError,
                                               AgentAdminTimeout,
                                               FleetScheduler)
from mx_rcnn_tpu_torch.tools.loadgen import (make_content_stub_run_fn,
                                             make_stub_run_fn)
from mx_rcnn_tpu_torch.utils.bridge import from_flax

torch.set_num_threads(1)

_OVER = {"bucket__scale": 128, "bucket__max_size": 160,
         "bucket__shapes": ((128, 160), (160, 128)),
         "serve__batch_size": 2, "serve__max_delay_ms": 5.0,
         "fleet__health_interval_s": 30.0}


@pytest.fixture(autouse=True)
def _clean_distributed_state():
    obs_trace.reset_distributed()
    j_trace.reset_distributed()
    yield
    obs_trace.reset_distributed()
    j_trace.reset_distributed()


def _cfg(**kw):
    return generate_config("tiny", "synthetic", **dict(_OVER, **kw))


def _jcfg(**kw):
    return j_generate_config("tiny", "synthetic", **dict(_OVER, **kw))


def _canvas(seed=0, bucket=(128, 160)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*bucket, 3).astype(np.float32) * 255.0,
            np.array([bucket[0], bucket[1], 1.0], np.float32), bucket)


def _src(seed=0, hw=(120, 150)):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, size=(*hw, 3), dtype=np.uint8)
    return img, np.array([hw[0], hw[1], 1.0], np.float32)


def _ctxs(seed):
    """The same trace context in both packages."""
    rng = np.random.RandomState(seed)
    tid = "%032x" % rng.randint(0, 2 ** 62)
    parent = int(rng.randint(1, 2 ** 62))
    hop = int(rng.randint(0, 5))
    return (obs_trace.TraceContext(tid, parent, hop, True),
            j_trace.TraceContext(tid, parent, hop, True))


def _same_ctx(a, b):
    return (a.trace_id, a.parent, a.hop, a.sampled) == \
        (b.trace_id, b.parent, b.hop, b.sampled)


def _det_key(dets):
    return b"".join(np.ascontiguousarray(dets[c], np.float32).tobytes()
                    for c in sorted(dets))


def _start_agent(cfg, stub="content", model_ms=0.0):
    """A port agent of stand-in replicas behind its server on a port the
    server binds (0)."""
    if stub == "content":
        factory = (lambda rid: make_content_stub_run_fn(cfg, model_ms))
    else:
        factory = (lambda rid: make_stub_run_fn(cfg, model_ms, seed=0))
    ag = ReplicaAgent(cfg, run_fn_factory=factory, device="cpu")
    srv = make_agent_server(ag, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return ag, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _start_j_agent(jcfg):
    """The JAX package's agent of content stand-ins, the same way."""
    ag = j_agent.ReplicaAgent(jcfg, None, {}, run_fn_factory=(
        lambda rid: j_content_stub(jcfg, 0.0)))
    srv = j_agent.make_agent_server(ag, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return ag, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop_agent(ag, srv):
    srv.shutdown()
    srv.server_close()
    ag.close()


# ---- the codecs: byte-equal encoders, cross decodes ------------------------

@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       timeout=st.sampled_from([0.0, 1.5, 1234.5, 6.0e8]),
       traced=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_v1_prepared_frames_byte_equal_and_cross_decode(h, w, timeout,
                                                        traced, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(h, w, 3) * 255.0).astype(np.float32)
    info = np.array([h, w, rng.rand()], np.float32)
    ctx, jctx = _ctxs(seed) if traced else (None, None)
    ours = remote.encode_prepared(data, info, timeout, ctx=ctx)
    theirs = jr.encode_prepared(data, info, timeout, ctx=jctx)
    assert ours == theirs
    assert b"".join(bytes(p) for p in remote.encode_prepared_parts(
        data, info, timeout, ctx=ctx)) == ours
    for decode, buf in ((remote.decode_prepared_ex, theirs),
                        (jr.decode_prepared_ex, ours)):
        d, i, t, c = decode(buf)
        assert d.tobytes() == data.tobytes() and i.tobytes() == info.tobytes()
        assert t == np.float32(timeout)
        assert (c is None) == (ctx is None)
        if ctx is not None:
            assert _same_ctx(c, ctx)
    f, jf = remote.decode_frame_ex(theirs), jr.decode_frame_ex(ours)
    assert (f.version, f.dtype, f.bucket) == (jf.version, jf.dtype,
                                              jf.bucket)
    assert f.data.tobytes() == jf.data.tobytes()


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 20), w=st.integers(1, 20),
       pad=st.tuples(st.integers(0, 6), st.integers(0, 6)),
       timeout=st.sampled_from([0.0, 50.0, 20000.0]),
       traced=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_v2_source_frames_byte_equal_and_cross_decode(h, w, pad, timeout,
                                                      traced, seed):
    img, info = _src(seed, (h, w))
    bucket = (h + pad[0], w + pad[1])
    ctx, jctx = _ctxs(seed) if traced else (None, None)
    ours = remote.encode_source(img, info, bucket, timeout, ctx=ctx)
    theirs = jr.encode_source(img, info, bucket, timeout, ctx=jctx)
    assert ours == theirs
    parts = remote.encode_source_parts(img, info, bucket, timeout, ctx=ctx)
    assert isinstance(parts[1], memoryview)
    assert np.shares_memory(np.frombuffer(parts[1], np.uint8), img)
    for decode, buf in ((remote.decode_frame_ex, theirs),
                        (jr.decode_frame_ex, ours)):
        f = decode(buf)
        assert f.version == remote.WIRE_VERSION_SRC == jr.WIRE_VERSION_SRC
        assert f.dtype == remote.DTYPE_U8
        assert f.data.tobytes() == img.tobytes() and f.bucket == bucket
        assert f.im_info.tobytes() == info.tobytes()
        assert (f.ctx is None) == (ctx is None)
        if ctx is not None:
            assert _same_ctx(f.ctx, ctx)


@settings(max_examples=20, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(counts=st.lists(st.integers(0, 7), min_size=0, max_size=5),
       classes=st.lists(st.integers(0, 200), min_size=5, max_size=5,
                        unique=True),
       dtype=st.sampled_from([np.float32, np.float64, np.float16]),
       stamped=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_result_frames_byte_equal_and_cross_decode(counts, classes, dtype,
                                                   stamped, seed):
    rng = np.random.RandomState(seed)
    dets = {classes[i]: (rng.rand(k, 5) * 100).astype(dtype)
            for i, k in enumerate(counts)}
    ts = (float(seed), float(seed) + 17.0) if stamped else None
    ours = remote.encode_result(dets, ts_pair=ts)
    assert ours == jr.encode_result(dets, ts_pair=ts)
    for decode in (remote.decode_result_ex, jr.decode_result_ex):
        out, pair = decode(ours)
        assert sorted(out) == sorted(dets) and pair == ts
        for c in dets:
            assert out[c].dtype == np.float32
            assert out[c].tobytes() == dets[c].astype(np.float32).tobytes()


@settings(max_examples=20, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(kinds=st.lists(st.sampled_from(["v1", "v2", "v2t"]), min_size=1,
                      max_size=6), seed=st.integers(0, 2 ** 16))
def test_envelopes_byte_equal_and_cross_decode(kinds, seed):
    ours_parts, theirs_parts, frames = [], [], []
    for i, kind in enumerate(kinds):
        if kind == "v1":
            data, info, _ = _canvas(seed + i, (8, 12))
            o = remote.encode_prepared_parts(data, info, 10.0)
            t = jr.encode_prepared_parts(data, info, 10.0)
        else:
            img, info = _src(seed + i, (6, 9))
            ctx, jctx = _ctxs(seed + i) if kind == "v2t" else (None, None)
            o = remote.encode_source_parts(img, info, (8, 12), 5.0, ctx=ctx)
            t = jr.encode_source_parts(img, info, (8, 12), 5.0, ctx=jctx)
        ours_parts.append(o)
        theirs_parts.append(t)
        frames.append(b"".join(bytes(p) for p in o))
    ours = b"".join(bytes(p) for p in
                    remote.encode_envelope_parts(ours_parts))
    assert ours == b"".join(bytes(p) for p in
                            jr.encode_envelope_parts(theirs_parts))
    assert remote.decode_envelope(ours) == jr.decode_envelope(ours) == frames
    entries = [(i % 4, f[:i]) for i, f in enumerate(frames)]
    env = remote.encode_result_envelope(entries)
    assert env == jr.encode_result_envelope(entries)
    assert remote.decode_result_envelope(env) == entries
    assert jr.decode_result_envelope(env) == entries


def test_wire_constants_equal_jax():
    for name in ("WIRE_MAGIC", "RESULT_MAGIC", "WIRE_VERSION",
                 "WIRE_VERSION_TRACED", "WIRE_F_TRACE", "WIRE_VERSION_SRC",
                 "DTYPE_F32", "DTYPE_U8", "ENV_MAGIC", "ENV_RESULT_MAGIC",
                 "ENV_VERSION", "ENV_SERVED", "ENV_SHED", "ENV_EXPIRED",
                 "ENV_FAILED", "MAX_ENV_FRAMES", "FRAME_CTYPE",
                 "ENVELOPE_CTYPE"):
        assert getattr(remote, name) == getattr(jr, name), name
    for name in ("_REQ_HEAD", "_REQ_HEAD2", "_RESP_HEAD", "_RESP_ENTRY",
                 "_RESP_TRACE_EXT", "_ENV_HEAD", "_ENV_LEN", "_ENV_RENTRY"):
        assert getattr(remote, name).format == getattr(jr, name).format


# ---- the rejection battery: both refuse, with the same type ---------------

def _v1():
    data, info, _ = _canvas(1, (16, 24))
    return remote.encode_prepared(data, info, 0.0)


def _v2():
    img, info = _src(6, (12, 20))
    return remote.encode_source(img, info, (16, 24), 0.0)


def _patched(buf, off, fmt, val):
    m = bytearray(buf)
    struct.pack_into(fmt, m, off, val)
    return bytes(m)


def _env(frames):
    return b"".join(bytes(p) for p in
                    remote.encode_envelope_parts([[f] for f in frames]))


def _full_f32_partial():
    full = np.zeros((16, 24, 3), np.float32)
    head = remote._REQ_HEAD2.pack(b"MXR1", 2, remote.DTYPE_F32, 12, 20, 3,
                                  16, 24, 0, 0.0, 12.0, 20.0, 1.0)
    return head + full[:12, :20].tobytes()


_RESULT = remote.encode_result({1: np.ones((2, 5), np.float32)})
_RENV = remote.encode_result_envelope([(remote.ENV_SERVED, b"p"),
                                       (remote.ENV_FAILED, b"e")])

_REJECT = {
    # v1 prepared frames
    "v1-truncated-header": ("decode_prepared", lambda: _v1()[:10]),
    "v1-bad-magic": ("decode_prepared", lambda: b"XXXX" + _v1()[4:]),
    "v1-short-payload": ("decode_prepared", lambda: _v1()[:-8]),
    "v1-trailing": ("decode_prepared", lambda: _v1() + b"\0\0"),
    "v1-bad-version": ("decode_prepared",
                       lambda: _patched(_v1(), 4, "<H", 3)),
    "v1-unknown-flags": ("decode_prepared",
                         lambda: _patched(_v1(), 12, "<H", 0x4)),
    "v1-timeout-inf": ("decode_prepared",
                       lambda: _patched(_v1(), 14, "<f", float("inf"))),
    "v1-timeout-nan": ("decode_prepared",
                       lambda: _patched(_v1(), 14, "<f", float("nan"))),
    "v1-timeout-negative": ("decode_prepared",
                            lambda: _patched(_v1(), 14, "<f", -1.0)),
    "v1-timeout-1e38": ("decode_prepared",
                        lambda: _patched(_v1(), 14, "<f", 1e38)),
    "v1-trace-flag-no-blob": ("decode_prepared",
                              lambda: _patched(_v1(), 12, "<H", 0x1)),
    # v2 source frames
    "v2-truncated-head": ("decode_frame_ex", lambda: _v2()[:6]),
    "v2-truncated-payload": ("decode_frame_ex", lambda: _v2()[:-1]),
    "v2-trailing": ("decode_frame_ex", lambda: _v2() + b"\0"),
    "v2-bad-magic": ("decode_frame_ex", lambda: b"XXXX" + _v2()[4:]),
    "v2-unknown-version": ("decode_frame_ex",
                           lambda: _patched(_v2(), 4, "<H", 9)),
    "v2-unknown-dtype": ("decode_frame_ex",
                         lambda: _patched(_v2(), 6, "<H", 7)),
    "v2-four-channels": ("decode_frame_ex",
                         lambda: _patched(_v2(), 12, "<H", 4)),
    "v2-unknown-flags": ("decode_frame_ex",
                         lambda: _patched(_v2(), 18, "<H", 0x80)),
    "v2-taller-than-bucket": ("decode_frame_ex",
                              lambda: _patched(_v2(), 8, "<H", 17)),
    "v2-u8-retagged-f32": ("decode_frame_ex", lambda: _patched(
        _v2(), 6, "<H", remote.DTYPE_F32)),
    "v2-retag-inflated": ("decode_frame_ex", lambda: _patched(
        _v2(), 6, "<H", remote.DTYPE_F32) + b"\0" * (12 * 20 * 3 * 3)),
    "v2-u8-with-f32-length": ("decode_frame_ex",
                              lambda: _v2() + b"\0" * (12 * 20 * 3 * 3)),
    "v2-f32-partial-canvas": ("decode_frame_ex", _full_f32_partial),
    "v2-trace-flag-no-blob": ("decode_frame_ex",
                              lambda: _patched(_v2(), 18, "<H", 0x1)),
    # request envelopes
    "env-truncated": ("decode_envelope", lambda: _env([_v2(), _v2()])[:4]),
    "env-bad-magic": ("decode_envelope",
                      lambda: b"XXXX" + _env([_v2(), _v2()])[4:]),
    "env-bad-version": ("decode_envelope", lambda: _patched(
        _env([_v2(), _v2()]), 4, "<H", 2)),
    "env-count-zero": ("decode_envelope", lambda: _patched(
        _env([_v2(), _v2()]), 6, "<H", 0)),
    "env-count-high": ("decode_envelope", lambda: _patched(
        _env([_v2(), _v2()]), 6, "<H", 3)),
    "env-count-low": ("decode_envelope", lambda: _patched(
        _env([_v2(), _v2()]), 6, "<H", 1)),
    "env-count-over-cap": ("decode_envelope", lambda: _patched(
        _env([_v2(), _v2()]), 6, "<H", remote.MAX_ENV_FRAMES + 1)),
    "env-length-lie": ("decode_envelope", lambda: _patched(
        _env([_v2(), _v2()]), remote._ENV_HEAD.size, "<I", 100000)),
    "env-member-truncated": ("decode_envelope",
                             lambda: _env([_v2(), _v2()])[:-3]),
    "env-trailing": ("decode_envelope",
                     lambda: _env([_v2(), _v2()]) + b"\0\0"),
    # result frames and result envelopes
    "result-truncated": ("decode_result", lambda: _RESULT[:4]),
    "result-bad-magic": ("decode_result", lambda: b"YYYY" + _RESULT[4:]),
    "result-trailing": ("decode_result", lambda: _RESULT + b"\0"),
    "result-rows-truncated": ("decode_result", lambda: _RESULT[:-4]),
    "result-bad-version": ("decode_result",
                           lambda: _patched(_RESULT, 4, "<H", 5)),
    "result-traced-no-ext": ("decode_result",
                             lambda: _patched(_RESULT, 4, "<H", 2)),
    "renv-truncated": ("decode_result_envelope", lambda: _RENV[:5]),
    "renv-request-magic": ("decode_result_envelope",
                           lambda: b"MXE1" + _RENV[4:]),
    "renv-unknown-status": ("decode_result_envelope", lambda: _patched(
        _RENV, remote._ENV_HEAD.size, "<H", 9)),
    "renv-count-high": ("decode_result_envelope",
                        lambda: _patched(_RENV, 6, "<H", 4)),
    "renv-short": ("decode_result_envelope", lambda: _RENV[:-1]),
    "renv-trailing": ("decode_result_envelope", lambda: _RENV + b"\0"),
}


@pytest.mark.parametrize("case", sorted(_REJECT))
def test_malformed_bytes_are_refused_by_both(case):
    fn, make = _REJECT[case]
    buf = make()
    with pytest.raises(ValueError) as ours:
        getattr(remote, fn)(buf)
    with pytest.raises(ValueError) as theirs:
        getattr(jr, fn)(buf)
    assert type(ours.value).__name__ == type(theirs.value).__name__


_ENCODE_REJECT = {
    "prepared-not-hwc": lambda m: m.encode_prepared(
        np.zeros((4, 4), np.float32), np.ones(3, np.float32), 0.0),
    "source-f32": lambda m: m.encode_source(
        np.zeros((4, 4, 3), np.float32), np.ones(3, np.float32), (4, 4), 0),
    "source-one-channel": lambda m: m.encode_source(
        np.zeros((4, 4), np.uint8), np.ones(3, np.float32), (4, 4), 0),
    "source-does-not-fit": lambda m: m.encode_source(
        np.zeros((9, 4, 3), np.uint8), np.ones(3, np.float32), (8, 8), 0),
    "result-not-k5": lambda m: m.encode_result(
        {1: np.zeros((2, 4), np.float32)}),
    "envelope-empty": lambda m: m.encode_envelope_parts([]),
    "envelope-over-cap": lambda m: m.encode_envelope_parts(
        [[b"x"]] * (m.MAX_ENV_FRAMES + 1)),
}


@pytest.mark.parametrize("case", sorted(_ENCODE_REJECT))
def test_encoders_refuse_what_the_jax_encoders_refuse(case):
    for mod in (remote, jr):
        with pytest.raises(ValueError):
            _ENCODE_REJECT[case](mod)


def test_normalize_agent_url_equals_jax():
    for u in ("127.0.0.1:9201", "http://h:1/", "https://x:2", "h:3//"):
        assert remote.normalize_agent_url(u) == jr.normalize_agent_url(u)


# ---- CrosshostConfig --------------------------------------------------------

def test_crosshost_config_equals_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(CrosshostConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(JCrosshostConfig)]
    assert got == want
    items = ["crosshost__connections=3", "crosshost__pipeline_depth=7",
             "crosshost__up_shed_ratio=0.2", "crosshost__agents=h1:1,h2:2",
             "crosshost__frames_per_send=4",
             "crosshost__pipeline_depth_max=8"]
    ours = generate_config("tiny", "synthetic",
                           **parse_set_overrides(items))
    from mx_rcnn_tpu.tools.train import \
        parse_set_overrides as j_parse_set_overrides

    class _Args:
        set = items

    theirs = j_generate_config("tiny", "synthetic",
                               **j_parse_set_overrides(_Args))
    assert dataclasses.asdict(ours.crosshost) == \
        dataclasses.asdict(theirs.crosshost)
    assert remote.agent_urls_from_cfg(ours) == \
        jr.agent_urls_from_cfg(theirs) == ["http://h1:1", "http://h2:2"]
    with pytest.raises(TypeError):
        generate_config("tiny", "synthetic", crosshost__connections=1.5)
    with pytest.raises(ValueError):
        build_crosshost_router(_cfg())   # no URLs anywhere


def test_config_fingerprint_unchanged_by_crosshost():
    """``crosshost`` is outside the config fingerprint in both packages:
    a store or checkpoint is admitted whatever the tier's knobs."""
    from mx_rcnn_tpu.utils.checkpoint import \
        config_fingerprint as j_fingerprint
    from mx_rcnn_tpu_torch.utils.checkpoint import config_fingerprint

    kw = {"crosshost__connections": 5, "crosshost__agents": "h:1",
          "crosshost__max_replicas": 3}
    assert config_fingerprint(_cfg(**kw)) == config_fingerprint(_cfg())
    assert j_fingerprint(_jcfg(**kw)) == j_fingerprint(_jcfg())


# ---- PipelineController, SchedulerPolicy, the parsers ----------------------

def _controller_trace(mod, seed):
    """A seeded RTT trace through one package's controller: the depth
    after every sample, the retunes and the peak."""
    rng = np.random.RandomState(seed)
    c = mod.PipelineController(int(rng.randint(0, 6)),
                               int(rng.randint(1, 10)), clock=lambda: 0.0)
    out, now = [c.current()], 0.0
    for _ in range(200):
        now += float(rng.choice([0.01, 0.05, 0.3]))
        if rng.rand() < 0.4:
            c.note_full()
        rtt = float(rng.choice([5.0, 10.0, 12.0, 200.0, 400.0]))
        out.append((c.note_rtt(rtt, now=now), c.current()))
    return out, c.retunes, c.depth_peak


@pytest.mark.parametrize("seed", range(6))
def test_pipeline_controller_decisions_equal_jax(seed):
    assert _controller_trace(remote, seed) == _controller_trace(jr, seed)


def _snap(store, ts, ready, backlog=None, counters=None, extra=None):
    snap = {"counters": dict(counters or {}), "gauges": dict(extra or {})}
    for src, v in ready.items():
        snap["gauges"][f"agent.replicas_ready@{src}"] = v
    for src, v in (backlog or {}).items():
        snap["gauges"][f"lane.128x160.depth@{src}"] = v
    return store.append_snapshot(snap, ts=ts)


def _trace_no_flap(i, rng):
    return ({"agent-0": 1} if i % 2 else {"agent-0": 1, "agent-1": 1}), \
        None, None


def _trace_deficit(i, rng):
    return ({"agent-0": 1, "agent-1": 1} if i < 2 else {"agent-0": 1}), \
        None, None


def _trace_overload(i, rng):
    return {"agent-0": 1, "agent-1": 1}, {"agent-0": 3.0}, \
        {"fleet.submitted": 100 * i, "fleet.shed": 50 * i}


def _trace_idle(i, rng):
    sub = 100 * min(i, 6)
    return {"agent-0": 2, "agent-1": 1}, None, \
        {"fleet.submitted": sub, "fleet.shed": 0,
         "serve.submitted": sub, "serve.shed": 0}


def _trace_random(i, rng):
    ready = {f"agent-{k}": int(rng.randint(0, 4))
             for k in range(3) if rng.rand() < 0.8}
    backlog = {k: float(rng.randint(0, 12)) for k in ready}
    counters = {"fleet.submitted": 50 * i + int(rng.randint(0, 40)),
                "fleet.shed": int(rng.randint(0, 10)) * i,
                "serve.submitted": 40 * i, "serve.shed": 0}
    return ready, backlog, counters


_TRACES = {"no_flap": _trace_no_flap, "deficit": _trace_deficit,
           "overload": _trace_overload, "idle": _trace_idle,
           "random0": _trace_random, "random1": _trace_random,
           "random2": _trace_random}


def _policy_run(mod, store_cls, cfg, trace, seed):
    rng = np.random.RandomState(seed)
    store = store_cls(capacity=64)
    pol = mod.SchedulerPolicy(cfg, clock=lambda: 0.0)
    out = []
    for i in range(40):
        ready, backlog, counters = trace(i, rng)
        _snap(store, float(i) * 0.5, ready, backlog, counters,
              extra={"agent.replicas_ready@router@agent-0": 9.0})
        act = pol.decide(store, now=float(i) * 0.5)
        out.append(None if act is None else
                   {k: act[k] for k in ("action", "source", "reason",
                                        "ready", "target", "corr")})
    return out, pol.target


@pytest.mark.parametrize("name", sorted(_TRACES))
def test_scheduler_policy_decisions_equal_jax(name):
    over = {"crosshost__for_samples": 2, "crosshost__idle_samples": 3,
            "crosshost__cooldown_s": 2.0, "crosshost__window_s": 3.0,
            "crosshost__max_replicas": 5}
    seed = sorted(_TRACES).index(name)
    ours = _policy_run(sched, TimeSeriesStore, _cfg(**over), _TRACES[name],
                       seed)
    theirs = _policy_run(j_sched, JTimeSeriesStore, _jcfg(**over),
                         _TRACES[name], seed)
    assert ours == theirs
    if name == "no_flap":
        assert all(a is None for a in ours[0])
    if name in ("deficit", "overload", "idle"):
        assert any(a is not None for a in ours[0])


def test_per_agent_parsers_equal_jax_and_ignore_nested_labels():
    snap = {"counters": {}, "gauges": {
        "agent.replicas_ready@agent-0": 2.0,
        "agent.replicas_ready@agent-12": 1.0,
        "agent.replicas_ready@router": 2.0,
        "agent.replicas_ready@router@agent-0": 2.0,
        "lane.128x160.depth@agent-0": 3.0,
        "lane.160x128.depth@agent-0": 1.0,
        "lane.128x160.depth@serve-1@agent-0": 3.0,
        "lane.bad.depth@agent-0": 9.0,
        "lane.128x160.depth": 4.0,
    }}
    ours = TimeSeriesStore(capacity=4).append_snapshot(snap, ts=1.0)
    theirs = JTimeSeriesStore(capacity=4).append_snapshot(snap, ts=1.0)
    assert sched.per_agent_ready(ours) == j_sched.per_agent_ready(theirs) \
        == {"agent-0": 2.0, "agent-12": 1.0}
    assert sched.per_agent_backlog(ours) == \
        j_sched.per_agent_backlog(theirs)
    g = snap["gauges"] | {"lane.12x34.depth": 2.0, "lane.1x.depth": 1.0}
    assert remote._parse_lane_gauges(g) == jr._parse_lane_gauges(g)


def test_a_port_agents_gauges_read_by_the_jax_parsers():
    """The backlog feed's sample of a port agent, as the JAX parsers and
    the port's read it: its ready replicas under ``agent-0`` and each
    bucket's lane."""
    cfg = _cfg(crosshost__agent_replicas=2)
    ag, srv, url = _start_agent(cfg, stub="plain")
    router, feed = build_crosshost_router(cfg, [url])
    try:
        view = feed.tick()
        smp = feed.store.window(None)[-1]
        assert j_sched.per_agent_ready(smp) == \
            sched.per_agent_ready(smp) == {"agent-0": 2.0}
        gauges = view["sources"]["agent-0"]["gauges"]
        lanes = jr._parse_lane_gauges(gauges)
        assert lanes == remote._parse_lane_gauges(gauges)
        assert sorted(lanes) == [(128, 160), (160, 128)]
        assert gauges["agent.kernel_builds_after_warm"] == 0
        assert j_sched.per_agent_backlog(smp) == {"agent-0": 0.0}
    finally:
        feed.close()
        router.close()
        _stop_agent(ag, srv)


# ---- wire interop on loopback ----------------------------------------------

@pytest.mark.parametrize("frames_per_send", [1, 4])
def test_port_engine_against_jax_agent_and_jax_engine_against_port_agent(
        frames_per_send):
    """The same pixels through both directions of the interop, v1 and
    v2, one frame or envelopes: the content stand-in scores each image
    by its own canvas, so a byte that differs shows."""
    over = {"crosshost__connections": 1, "crosshost__pipeline_depth": 16,
            "crosshost__frames_per_send": frames_per_send}
    cfg, jcfg = _cfg(**over), _jcfg(**over)
    jag, jsrv, jurl = _start_j_agent(jcfg)
    ag, srv, url = _start_agent(cfg)
    ours = RemoteEngine("port-to-jax", jurl, cfg)
    theirs = jr.RemoteEngine("jax-to-port", url, jcfg)
    try:
        b = tuple(cfg.bucket.shapes[0])
        keys = {"ours": [], "theirs": []}
        for name, eng in (("ours", ours), ("theirs", theirs)):
            reqs = []
            for i in range(6):
                img, info = _src(60 + i)
                canvas = pad_normalize(img, cfg.network.pixel_means, b)
                reqs.append(eng.submit_source(img, info, b,
                                              timeout_ms=20_000))
                reqs.append(eng.submit_prepared(canvas, info, b,
                                                timeout_ms=20_000))
            keys[name] = [_det_key(r.wait(30.0)) for r in reqs]
        assert keys["ours"] == keys["theirs"]
        assert keys["ours"][0::2] == keys["ours"][1::2]   # v2 == v1
        assert len(set(keys["ours"])) == 6
        if frames_per_send > 1:
            assert ours.metrics.registry.counter("serve.wire_frames") == 12
    finally:
        ours.close()
        theirs.close()
        _stop_agent(jag, jsrv)
        _stop_agent(ag, srv)


def test_keep_alive_connection_reuse_pinned():
    cfg = _cfg(crosshost__connections=2, crosshost__pipeline_depth=16)
    ag, srv, url = _start_agent(cfg, stub="plain")
    try:
        before = srv.connections
        eng = RemoteEngine("t-keepalive", url, cfg, probe=False)
        try:
            reqs = []
            for i in range(24):
                data, info, b = _canvas(i, cfg.bucket.shapes[i % 2])
                reqs.append(eng.submit_prepared(data, info, b,
                                                timeout_ms=20_000))
            for r in reqs:
                assert r.wait(30.0) is not None
            assert eng.conns_opened == 2
            assert srv.connections - before == 2
        finally:
            eng.close()
    finally:
        _stop_agent(ag, srv)


def test_host_death_ejects_and_reroutes_within_deadline():
    cfg = _cfg(crosshost__connections=1, crosshost__pipeline_depth=16,
               crosshost__frames_per_send=4,
               crosshost__dead_after_failures=2,
               crosshost__scrape_interval_s=0.1,
               fleet__health_interval_s=0.1, fleet__reroute_retries=3)
    agents = [_start_agent(cfg, stub="plain", model_ms=5.0)
              for _ in range(2)]
    router, feed = build_crosshost_router(cfg, [a[2] for a in agents])
    try:
        _stop_agent(*agents[1][:2])
        t0 = time.monotonic()
        reqs = []
        for i in range(8):
            img, info = _src(i)
            reqs.append(router.submit_source(img, info, (128, 160),
                                             timeout_ms=15_000))
        for r in reqs:
            assert r.wait(20.0) is not None
        assert time.monotonic() - t0 < 15.0
        c = router.metrics.snapshot()["counters"]
        assert c["served"] == 8 and c["failed"] == c["expired"] == 0
        deadline = time.monotonic() + 10.0
        while router.manager.ejects < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.manager.ejects >= 1
    finally:
        feed.close()
        router.close()
        _stop_agent(*agents[0][:2])


def test_envelope_member_failure_is_isolated_and_rollout_is_unknown():
    cfg = _cfg()
    ag, srv, url = _start_agent(cfg)
    try:
        img, info = _src(30)
        good = remote.encode_source(img, info, (128, 160), 15_000.0)
        odd_img, odd_info = _src(31, (60, 60))
        odd = remote.encode_source(odd_img, odd_info, (96, 96), 15_000.0)
        host, port = srv.server_address
        conn = http.client.HTTPConnection(host, port, timeout=30.0)
        try:
            conn.request("POST", "/frames", body=_env([good, odd, good]),
                         headers={"Content-Type": remote.ENVELOPE_CTYPE})
            resp = conn.getresponse()
            payload = resp.read()
            conn.request("POST", "/rollout", body=b'{"op": "status"}',
                         headers={"Content-Type": "application/json"})
            rollout = conn.getresponse()
            rollout.read()
        finally:
            conn.close()
        assert resp.status == 200 and rollout.status == 404
        entries = remote.decode_result_envelope(payload)
        assert [s for s, _ in entries] == [remote.ENV_SERVED,
                                           remote.ENV_FAILED,
                                           remote.ENV_SERVED]
        for status, p in entries[::2]:
            ours, theirs = remote.decode_result(p), jr.decode_result(p)
            assert ours and _det_key(ours) == _det_key(theirs)
    finally:
        _stop_agent(ag, srv)


def test_backlog_hints_decay_and_stamps_are_monotonic():
    cfg = _cfg(crosshost__scrape_interval_s=0.1)
    ag, srv, url = _start_agent(cfg)
    eng = RemoteEngine("t-lanes", url, cfg)
    try:
        b = tuple(cfg.bucket.shapes[0])
        assert eng.bucket_depth(b) == 0
        assert eng.backlog_age() == float("inf")
        now = time.monotonic()
        eng.update_backlog({b: 3.0}, at=now - eng._lane_ttl_s - 0.1)
        assert eng.bucket_depth(b) == 0
        eng.update_backlog({b: 5.0}, at=now)
        assert eng.bucket_depth(b) == 5
        eng.update_backlog({b: 99.0}, at=now - 0.2)
        assert eng.bucket_depth(b) == 5
        eng.update_backlog({b: 7.0}, at=now + 100.0)
        assert eng.bucket_depth(b) == 7 and eng.backlog_age() < 1.0
        img, info = _src(12)
        for bad in ((img.astype(np.float32), b), (img[..., 0], b),
                    (img, (64, 64))):
            with pytest.raises(ValueError):
                eng.submit_source(bad[0], info, bad[1])
    finally:
        eng.close()
        _stop_agent(ag, srv)


# ---- the tiny model through a port agent ------------------------------------

def test_a_port_agent_over_the_tiny_model_serves_its_engines_bits():
    """A port agent of the seeded tiny model (real forward, CPU): v1, v2,
    an envelope and ``/detect`` byte-equal to the port's in-process
    engine on the same canvas, and close to the JAX engine with the same
    weights: boxes within 1e-2 px, scores within 1e-5, the tolerance of
    ``test_torch_serve.py — test_engine_detections_match_jax`` (the two
    frameworks' fp32 convolutions sum in other orders; boxes differ by
    more than 1e-5 relative)."""
    import jax

    from mx_rcnn_tpu.tools.loadgen import init_predictor as j_init_predictor

    over = {"test__rpn_pre_nms_top_n": 512, "test__rpn_post_nms_top_n": 64,
            "serve__max_delay_ms": 30.0, "crosshost__connections": 1,
            "crosshost__pipeline_depth": 8, "crosshost__frames_per_send": 4}
    cfg, jcfg = _cfg(**over), _jcfg(**over)
    jpred = j_init_predictor(jcfg)
    model = build_model(cfg, "cpu", seed=None)
    model.load_state_dict(from_flax(jax.device_get(jpred.variables)))
    pred = Predictor(model, cfg, "cpu")
    variables = predictor_variables(pred)
    ag = ReplicaAgent(cfg, variables, device="cpu")
    srv = make_agent_server(ag, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    local = ServingEngine(pred, cfg)
    jeng = JServingEngine(jpred, jcfg)
    eng = RemoteEngine("t-model", url, cfg)
    try:
        local.warmup()
        jeng.warmup()
        assert ag.healthz()["kernel_builds_after_warm"] == 0
        total = 0
        for i in range(4):
            rng = np.random.RandomState(70 + i)
            hw = (128, 160) if i % 2 == 0 else (160, 128)
            img = rng.randint(0, 256, size=(*hw, 3), dtype=np.uint8)
            canvas, info, b = prepare_image(img, cfg)
            want = local.submit_prepared(canvas, info, b,
                                         timeout_ms=0).wait(60.0)
            got_v1 = eng.submit_prepared(canvas, info, b,
                                         timeout_ms=0).wait(60.0)
            got_det = eng.submit(img, timeout_ms=0).wait(60.0)
            assert _det_key(got_v1) == _det_key(want), i
            assert _det_key(got_det) == _det_key(want), i
            ref = jeng.detect(img)
            assert sorted(ref) == sorted(want), i
            for c in ref:
                assert want[c].shape == ref[c].shape, (i, c)
                np.testing.assert_allclose(want[c][:, :4], ref[c][:, :4],
                                           rtol=0, atol=1e-2)
                np.testing.assert_allclose(want[c][:, 4], ref[c][:, 4],
                                           rtol=0, atol=1e-5)
                total += len(ref[c])
        # a source smaller than its bucket: the agent pads and
        # normalizes it as the head would
        img, info = _src(80, (100, 150))
        canvas = pad_normalize(img, cfg.network.pixel_means, (128, 160))
        want = local.submit_prepared(canvas, info, (128, 160),
                                     timeout_ms=0).wait(60.0)
        reqs = [eng.submit_source(img, info, (128, 160), timeout_ms=0)
                for _ in range(3)]
        for r in reqs:
            assert _det_key(r.wait(60.0)) == _det_key(want)
        assert total > 0
    finally:
        eng.close()
        local.close()
        jeng.close()
        _stop_agent(ag, srv)


# ---- pull_store --------------------------------------------------------------

def _mk_store(root, sizes):
    rng = np.random.RandomState(7)
    for rel, n in sizes.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "wb") as f:
            f.write(rng.bytes(n))
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump({"files": sorted(sizes)}, f)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _serve_store(root):
    srv = make_store_server(root)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_store_pull_skip_resume_refusal_and_kernels(tmp_path):
    root = str(tmp_path / "store")
    _mk_store(root, {"a.bin": 1 << 16, "sub/b.bin": 1 << 12,
                     "kernels/libnms_sweep-0123.so": 1 << 10})
    assert j_agent.store_index(root) == store_index(root)
    srv, url = _serve_store(root)
    try:
        d1 = str(tmp_path / "d1")
        stats = pull_store(url, d1)
        assert stats["files"] == 4 and not stats["refused"]
        lib = os.path.join("kernels", "libnms_sweep-0123.so")
        assert _sha(os.path.join(d1, lib)) == _sha(os.path.join(root, lib))
        with srv.stats_lock:
            order = [r["rel"] for r in srv.requests]
        assert order[-1] == "manifest.json"          # the commit point
        again = pull_store(url, d1)
        assert again["skipped"] == 4 and again["files"] == 0

        d2 = str(tmp_path / "d2")
        os.makedirs(d2)
        with open(os.path.join(root, "a.bin"), "rb") as f:
            half = f.read((1 << 16) // 2)
        with open(os.path.join(d2, "a.bin.part"), "wb") as f:
            f.write(half)
        stats = pull_store(url, d2)
        assert stats["resumed"] == 1 and stats["refused"] == 0
        assert _sha(os.path.join(d2, "a.bin")) == _sha(
            os.path.join(root, "a.bin"))
        with srv.stats_lock:
            starts = [r["start"] for r in srv.requests
                      if r["rel"] == "a.bin" and r["start"]]
        assert starts == [len(half)]

        d3 = str(tmp_path / "d3")
        os.makedirs(d3)
        with open(os.path.join(d3, "a.bin.part"), "wb") as f:
            f.write(b"\xff" * len(half))
        stats = pull_store(url, d3)
        assert stats["refused"] == 1
        assert _sha(os.path.join(d3, "a.bin")) == _sha(
            os.path.join(root, "a.bin"))
        # the JAX client pulls the port's server the same way
        d4 = str(tmp_path / "d4")
        assert j_agent.pull_store(url, d4)["files"] == 4
    finally:
        srv.shutdown()
        srv.server_close()


def test_store_pull_double_mismatch_and_dead_endpoint_raise(tmp_path):
    root = str(tmp_path / "store")
    _mk_store(root, {"a.bin": 1 << 12})
    srv, url = _serve_store(root)
    try:
        with open(os.path.join(root, "a.bin"), "r+b") as f:
            f.write(b"\x00" * 16)
        with pytest.raises(StorePullError):
            pull_store(url, str(tmp_path / "d"))
    finally:
        srv.shutdown()
        srv.server_close()
    with socket.socket() as s:   # bound, never listening: refused
        s.bind(("127.0.0.1", 0))
        with pytest.raises(StorePullError):
            pull_store(f"127.0.0.1:{s.getsockname()[1]}",
                       str(tmp_path / "e"), timeout_s=2.0)


# ---- AgentAdmin ----------------------------------------------------------------

class _HungHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — accepts, then never answers
        time.sleep(3.0)

    do_POST = do_GET

    def log_message(self, *a):
        pass


def test_agent_admin_resize_roundtrip():
    cfg = _cfg(crosshost__agent_replicas=1)
    ag, srv, url = _start_agent(cfg, stub="plain")
    try:
        admin = AgentAdmin([url])
        r = admin.resize("agent-0", +1)
        assert r and r["replicas"] == 2 and r["added"] == 1
        deadline = time.monotonic() + 20.0
        while (len(ag.manager.ready_replicas()) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert len(ag.manager.ready_replicas()) == 2
        assert admin.resize("agent-0", -1)["drained"] == 1
        r = admin.resize("agent-0", -5)
        assert r and r["replicas"] == 1 and r["drained"] == 0
        assert admin.resize("no-such-agent", 1) is None
        assert AgentAdmin.from_config(
            [url], _cfg(crosshost__admin_timeout_s=1.25)).timeout_s == 1.25
    finally:
        _stop_agent(ag, srv)


def test_agent_admin_timeout_is_typed_and_tick_stays_alive():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _HungHandler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        admin = AgentAdmin([url], timeout_s=0.3)
        t0 = time.monotonic()
        assert admin.resize("agent-0", +1) is None
        assert time.monotonic() - t0 < 2.0
        assert isinstance(admin.last_error, AgentAdminTimeout)
        s = FleetScheduler(TimeSeriesStore(capacity=64), admin,
                           _cfg(crosshost__for_samples=2,
                                crosshost__cooldown_s=5.0))
        _snap(s.store, 0.0, {"agent-0": 1, "agent-1": 1})
        assert s.tick(now=0.0) is None
        _snap(s.store, 1.0, {"agent-0": 1})
        s.tick(now=1.0)
        _snap(s.store, 2.0, {"agent-0": 1})
        t0 = time.monotonic()
        act = s.tick(now=2.0)
        assert time.monotonic() - t0 < 2.0
        assert act is not None and act["result"] is None
        assert act["error"] == "AgentAdminTimeout"
        assert s.rollback()["error"] == "NoRolloutController"
    finally:
        srv.shutdown()
        srv.server_close()


def test_agent_admin_refused_socket_is_typed_not_timeout():
    with socket.socket() as s:   # bound, never listening: refused
        s.bind(("127.0.0.1", 0))
        admin = AgentAdmin([f"http://127.0.0.1:{s.getsockname()[1]}"],
                           timeout_s=0.5)
        assert admin.resize("agent-0", 1) is None
    assert isinstance(admin.last_error, AgentAdminError)
    assert not isinstance(admin.last_error, AgentAdminTimeout)
    with pytest.raises(AgentAdminError):
        admin.call("agent-9", "/replicas", {})


def test_remote_build_fn_pins_a_replica_to_its_host():
    """``make_remote_build_fn``: replica ``rid`` is built against agent
    ``rid % hosts``, so a relaunch probes the same host; no agent raises."""
    cfg = _cfg()
    agents = [_start_agent(cfg, stub="plain") for _ in range(2)]
    try:
        build = remote.make_remote_build_fn(cfg, [a[2] for a in agents])
        for rid in range(3):
            eng, join = build(rid)
            try:
                assert join["agent_url"] == agents[rid % 2][2]
                assert eng.agent_url == agents[rid % 2][2]
                assert join["replicas"] and "warm_s" in join
            finally:
                eng.close()
        with pytest.raises(ValueError):
            remote.make_remote_build_fn(cfg, [])
    finally:
        for ag, srv, _ in agents:
            _stop_agent(ag, srv)
