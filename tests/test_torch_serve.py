"""The port's serving tier held against the JAX package's on the CPU.

``ServeConfig``, ``estimate_bucket``, the metrics (``Histogram``,
``ServeMetrics``), the netio checks, ``BoundedQueue`` admission and the
``ServingEngine`` answers of both packages on the same inputs; then the
port's own engine against its offline path, its coalescing, deadline and
shed cases (``start=False``, so no case depends on timing), the HTTP
front end on port 0, ``tools/loadgen.py`` and ``tools/serve.py``.  The
engines run the tiny network on the JAX serve tests' canvas (128x160 and
160x128, pre/post-NMS 512/64, fp32) with one set of seeded weights.
"""

import ast
import base64
import dataclasses
import http.client
import io
import json
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu import netio as j_netio
from mx_rcnn_tpu.config import ServeConfig as JServeConfig
from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.data.image import estimate_bucket as j_estimate_bucket
from mx_rcnn_tpu.obs import trace as j_trace
from mx_rcnn_tpu.obs.metrics import Histogram as JHistogram
from mx_rcnn_tpu.obs.metrics import ServeMetrics as JServeMetrics
from mx_rcnn_tpu.serve import queue as jq
from mx_rcnn_tpu.serve.engine import ServingEngine as JServingEngine
from mx_rcnn_tpu.tools.loadgen import init_predictor as j_init_predictor
from mx_rcnn_tpu_torch import netio
from mx_rcnn_tpu_torch.config import (ServeConfig, generate_config,
                                      parse_set_overrides)
from mx_rcnn_tpu_torch.core.tester import (Predictor, _postprocess_batch,
                                           detections_from_keep)
from mx_rcnn_tpu_torch.data.image import estimate_bucket
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.obs.metrics import Histogram, ServeMetrics
from mx_rcnn_tpu_torch.serve import queue as tq
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.server import (check_trace_context,
                                            decode_image_payload,
                                            detections_to_json, make_server)
from mx_rcnn_tpu_torch.tools import loadgen
from mx_rcnn_tpu_torch.tools import serve as serve_cli
from mx_rcnn_tpu_torch.utils.bridge import from_flax
from mx_rcnn_tpu_torch.utils.checkpoint import save_params

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
_CANVAS = dict(bucket__scale=128, bucket__max_size=160,
               bucket__shapes=((128, 160), (160, 128)),
               test__rpn_pre_nms_top_n=512, test__rpn_post_nms_top_n=64)


def _cfgs(**serve_kw):
    """The same serve canvas in both packages (the JAX serve tests')."""
    jcfg = j_generate_config("tiny", "synthetic", **_CANVAS)
    cfg = generate_config("tiny", "synthetic", **_CANVAS)
    if serve_kw:
        jcfg = jcfg.replace_in("serve", **serve_kw)
        cfg = cfg.replace_in("serve", **serve_kw)
    return jcfg, cfg


def _img(landscape=True, seed=0):
    rng = np.random.RandomState(seed)
    h, w = (128, 160) if landscape else (160, 128)
    return rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def predictors():
    """The JAX predictor from its seeded init, and the port's with the
    same weights through the bridge."""
    jcfg, cfg = _cfgs()
    jpred = j_init_predictor(jcfg)
    model = build_model(cfg, "cpu", seed=None)
    model.load_state_dict(from_flax(jax.device_get(jpred.variables)))
    return jpred, Predictor(model, cfg, "cpu")


@pytest.fixture(scope="module")
def engine(predictors):
    """A warm port engine at batch 2, shared by the read-mostly tests."""
    _, cfg = _cfgs(batch_size=2, max_delay_ms=30.0)
    eng = ServingEngine(predictors[1], cfg)
    eng.warmup()
    yield eng
    eng.close()


# ---- config, geometry, metrics ----------------------------------------------

def test_serve_config_equals_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JServeConfig)]
    assert got == want
    assert generate_config("tiny", "synthetic").serve == ServeConfig()
    cfg = generate_config("tiny", "synthetic", **parse_set_overrides(
        ["serve__batch_size=8", "serve__max_delay_ms=3.5",
         "serve__queue_depth=16"]))
    assert (cfg.serve.batch_size, cfg.serve.max_delay_ms,
            cfg.serve.queue_depth) == (8, 3.5, 16)
    assert generate_config("tiny", "synthetic",
                           serve__queue_depth="16").serve.queue_depth == 16


@pytest.mark.parametrize("buckets,scale,max_size", [
    (((608, 1024), (1024, 608)), 600, 1000),
    (((128, 160), (160, 128)), 128, 160),
    (((320, 416), (416, 320)), 320, 416)])
def test_estimate_bucket_equals_jax(buckets, scale, max_size):
    for h in range(16, 2100, 37):
        for w in range(16, 2100, 41):
            assert estimate_bucket(h, w, scale, max_size, buckets) == \
                j_estimate_bucket(h, w, scale, max_size, buckets), (h, w)


def _samples(seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.lognormal(3.0, 1.5, 500),
                           rng.uniform(0.0, 0.2, 20), [1e9, 0.1, 30_000.0]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_summary_equals_jax(seed):
    h, jh = Histogram(), JHistogram()
    assert h.summary() == jh.summary()
    for v in _samples(seed):
        h.record(float(v))
        jh.record(float(v))
    assert h.summary() == jh.summary()
    for p in (0, 1, 50, 99.9, 100):
        assert h.percentile(p) == jh.percentile(p)
    np.testing.assert_array_equal(h.counts, jh.counts)


def _metrics_calls(m, seed):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        op = rng.randint(4)
        if op == 0:
            m.count(["submitted", "served", "shed", "expired", "failed"][
                rng.randint(5)], int(rng.randint(1, 3)))
        elif op == 1:
            m.observe(["queue_wait_ms", "total_ms"][rng.randint(2)],
                      float(rng.lognormal(2.0, 1.0)))
        elif op == 2:
            m.observe_batch(int(rng.randint(1, 5)), 4,
                            float(rng.lognormal(3.0, 0.5)))
        else:
            assert m.snapshot()["in_flight"] == m.in_flight()


@pytest.mark.parametrize("seed", [0, 1])
def test_serve_metrics_snapshot_equals_jax(seed):
    m, jm = ServeMetrics(), JServeMetrics()
    assert m.snapshot() == jm.snapshot()
    _metrics_calls(m, seed)
    _metrics_calls(jm, seed)
    assert m.snapshot() == jm.snapshot()
    assert m.in_flight() == jm.in_flight()
    assert m.counters == jm.counters
    m.reset()
    jm.reset()
    assert m.snapshot() == jm.snapshot()


# ---- netio --------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except j_netio.BodyError as e:
        return "body", e.status, str(e)
    except netio.BodyError as e:
        return "body", e.status, str(e)
    except ValueError as e:
        return "value", str(e)


@pytest.mark.parametrize("value", [
    None, 0, 5, 2000.5, "12", float("nan"), float("inf"), float("-inf"), -3.0,
    1e38, netio.MAX_TIMEOUT_MS, netio.MAX_TIMEOUT_MS + 1, "soon", [1]])
def test_check_timeout_ms_equals_jax(value):
    assert _outcome(netio.check_timeout_ms, value) == \
        _outcome(j_netio.check_timeout_ms, value)


class _Handler:
    """What ``read_request_body`` reads of a ``BaseHTTPRequestHandler``."""

    def __init__(self, headers, body: bytes, trickle_s: float = 0.0):
        self.headers = headers
        self.rfile = _Trickle(body, trickle_s)


class _Trickle(io.BytesIO):
    def __init__(self, body, delay_s):
        super().__init__(body)
        self.delay_s = delay_s

    def read1(self, n=-1):
        if self.delay_s:
            time.sleep(self.delay_s)
            n = 1
        return super().read1(n)


@pytest.mark.parametrize("headers,body,cap,deadline,trickle", [
    ({}, b"", 100, None, 0),                                  # 411
    ({"Content-Length": "abc"}, b"", 100, None, 0),           # 400
    ({"Content-Length": "-1"}, b"", 100, None, 0),            # 400
    ({"Content-Length": str(3 << 30)}, b"{}", 100, None, 0),  # 413
    ({"Content-Length": "10"}, b"12345", 100, None, 0),       # short: 400
    ({"Content-Length": "10"}, b"12345", 100, 5.0, 0),        # short: 400
    ({"Content-Length": "5"}, b"12345", 100, None, 0),        # whole
    ({"Content-Length": "5"}, b"12345", 100, 5.0, 0),         # whole
    ({"Content-Length": "40"}, b"x" * 40, 100, 0.05, 0.01)])  # slow: 408
def test_read_request_body_equals_jax(headers, body, cap, deadline, trickle):
    got = _outcome(netio.read_request_body,
                   _Handler(headers, body, trickle), cap, deadline)
    want = _outcome(j_netio.read_request_body,
                    _Handler(headers, body, trickle), cap, deadline)
    assert got[:2] == want[:2]


_TRACE_HEADERS = [
    None, "v1;id=abc;parent=1f;hop=2;s=1", "v1;id=a.b-c_d:e;parent=0;hop=0;s=0",
    " v1;id=abc;parent=1f;hop=2;s=1 ", "v2;id=abc;parent=1;hop=0;s=1",
    "garbage", "v1;id=zz;parent=1;hop=0;s=1", "v1;id=abc;parent=x;hop=0;s=1",
    "v1;id=abc;parent=1;hop=0;s=2", "v1;id=abc;parent=1;hop=70000;s=1",
    "v1;id=abc;parent=1;s=1", "v1;id=abc;parent=1;hop=0;s=1;junk",
    "v1;id=;parent=1;hop=0;s=1", "v1;id=" + "a" * 65 + ";parent=1;hop=0;s=1",
    "v1;id=é;parent=1;hop=0;s=1", "v1;" + "x" * 300]


@pytest.mark.parametrize("value", _TRACE_HEADERS)
def test_trace_header_accepted_as_jax_accepts_it(value):
    """The server's check refuses what the JAX package's ``check_trace_
    header`` then ``parse_header`` refuse, with a 400 either way."""
    def jax_check(v):
        if j_netio.check_trace_header(v) is not None:
            j_trace.parse_header(v)

    got = _outcome(check_trace_context, value)
    want = _outcome(jax_check, value)
    assert got[0] == want[0]
    if got[0] == "body":
        assert got[1] == want[1] == 400


# ---- admission ----------------------------------------------------------------

def _admission(q_mod):
    """One scripted scenario through a package's queue module; returns
    the terminal states and what each step returned."""
    clock = [100.0]
    now_fn = lambda: clock[0]  # noqa: E731
    q = q_mod.BoundedQueue(depth=8, shed_watermark=3)
    reqs = [q_mod.ServeRequest(None, None, (1, 1), d, 100.0)
            for d in (100.5, None, 101.0, None, 100.2)]
    offered = [q.offer(r) for r in reqs]          # the fourth hits 3
    for r, ok in zip(reqs, offered):
        if not ok:
            r._finish(q_mod.SHED, now=clock[0])
    clock[0] = 100.7                              # reqs[0] has expired
    expired = []
    batch = q.take_batch(2, 0.0, now_fn=now_fn, on_expire=expired.append)
    twice = [batch[0]._finish(q_mod.SERVED, result={}, now=clock[0]),
             batch[0]._finish(q_mod.FAILED, now=clock[0])]
    left = q.close()
    closed_offer = q.offer(reqs[4])
    for r in left:
        r._finish(q_mod.SHED, now=clock[0])
    errors = []
    for r in reqs:
        try:
            errors.append(type(r.wait(timeout=0)).__name__)
        except Exception as e:
            errors.append(type(e).__name__)
    return dict(offered=offered, batch=[reqs.index(r) for r in batch],
                expired=[reqs.index(r) for r in expired], twice=twice,
                left=[reqs.index(r) for r in left], closed_offer=closed_offer,
                states=[r.state for r in reqs], errors=errors,
                pending=[reqs.index(r) for r in reqs if r.state == "pending"])


def test_admission_scenario_equals_jax():
    got, want = _admission(tq), _admission(jq)
    assert got == want
    assert got["offered"] == [True, True, True, False, False]
    assert got["expired"] == [0] and got["twice"] == [True, False]


def test_take_batch_waits_the_window_then_dispatches_partial():
    q = tq.BoundedQueue(depth=4)
    q.offer(tq.ServeRequest(None, None, (1, 1), None, 0.0))
    t0 = time.monotonic()
    assert len(q.take_batch(4, 0.05)) == 1
    assert time.monotonic() - t0 >= 0.045
    q.close()
    assert q.take_batch(4, 0.05) == []


# ---- the engine ----------------------------------------------------------------

def test_engine_detections_match_jax(predictors, engine):
    """Both packages' engines at batch 2 on seeded images of both
    buckets: the same classes and counts per class, boxes within 1e-2 px
    and scores within 1e-5 (the fp32 conv sums of the two frameworks
    differ in order)."""
    jcfg, _ = _cfgs(batch_size=2, max_delay_ms=30.0)
    jeng = JServingEngine(predictors[0], jcfg)
    jeng.warmup()
    total = 0
    try:
        for i in range(4):
            img = _img(landscape=i % 2 == 0, seed=20 + i)
            got, want = engine.detect(img), jeng.detect(img)
            assert sorted(got) == sorted(want), i
            for c in want:
                assert got[c].shape == want[c].shape, (i, c)
                np.testing.assert_allclose(got[c][:, :4], want[c][:, :4],
                                           rtol=0, atol=1e-2)
                np.testing.assert_allclose(got[c][:, 4], want[c][:, 4],
                                           rtol=0, atol=1e-5)
                total += len(want[c])
    finally:
        jeng.close()
    assert total > 0


def _offline(engine, img):
    """The offline path on the batch the engine composes for ``img``."""
    p, cfg = engine.predictor, engine.cfg
    canvas, info, (bh, bw) = engine.preprocess(img)
    n = cfg.serve.batch_size
    images = np.zeros((n, bh, bw, 3), np.float32)
    im_info = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
    images[0], im_info[0] = canvas, info
    outs = p.raw(images, im_info)
    info_t = torch.from_numpy(im_info)
    post = _postprocess_batch(*outs, info_t, info_t[:, 2], engine._stds,
                              engine._means, nms_thresh=cfg.test.nms,
                              score_thresh=cfg.serve.score_thresh)
    return detections_from_keep(*(t.numpy() for t in post), 0)


@pytest.mark.parametrize("landscape", [True, False])
def test_engine_bit_equal_to_the_offline_batch(engine, landscape):
    img = _img(landscape, seed=7)
    got, want = engine.detect(img), _offline(engine, img)
    assert want and sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def test_bucket_routing_and_shrink_to_fit(engine):
    assert engine.preprocess(_img(True))[2] == (128, 160)
    assert engine.preprocess(_img(False))[2] == (160, 128)
    _, info, b = engine.preprocess(np.zeros((640, 800, 3), np.uint8))
    assert b == (128, 160) and info[0] <= 128 and info[1] <= 160
    h = engine.healthz()
    assert h["ok"] and h["warm_buckets"] == h["buckets"] == [[128, 160],
                                                             [160, 128]]
    assert engine.alive()


def test_engine_rejects_inconsistent_policy(predictors):
    for kw, match in ((dict(shed_watermark=100, queue_depth=10),
                       "shed_watermark"),
                      (dict(batch_size=0), "batch_size"),
                      (dict(max_delay_ms=-1.0), "max_delay_ms")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(predictors[1], _cfgs(**kw)[1], start=False)


def _step(eng, bucket, max_n=None):
    """One dispatcher step by hand: take a batch and serve it."""
    q = eng.queues[bucket]
    batch = q.take_batch(max_n or eng.cfg.serve.batch_size, 0.0,
                         on_expire=lambda r: eng.metrics.count("expired"))
    eng._serve_batch(bucket, batch)
    return batch


def test_coalescing_into_static_batches(predictors):
    """Five queued requests of one bucket at batch 4: one full batch,
    then one of a single request padded to 4 rows."""
    eng = ServingEngine(predictors[1], _cfgs(batch_size=4)[1], start=False)
    reqs = [eng.submit(_img(seed=i), timeout_ms=0) for i in range(5)]
    assert [len(_step(eng, (128, 160))) for _ in range(2)] == [4, 1]
    assert [r.batch_rows for r in reqs] == [4, 4, 4, 4, 1]
    assert all(isinstance(r.wait(timeout=0), dict) for r in reqs)
    snap = eng.metrics.snapshot()
    assert snap["counters"]["batches"] == 2
    assert snap["counters"]["padded_rows"] == 3
    assert snap["batch_occupancy"]["mean_rows"] == 2.5
    assert eng.metrics.summary("preprocess_ms")["count"] == 5
    # the dispatcher thread does the same, and exits on close
    eng.start()
    assert eng.detect(_img(False), timeout_ms=0)
    eng.close()
    assert not eng.alive()


def test_deadline_expiry_and_watermark_shedding(predictors):
    eng = ServingEngine(predictors[1],
                        _cfgs(batch_size=4, queue_depth=4,
                              shed_watermark=2)[1], start=False)
    img = _img()
    r_expire = eng.submit(img, timeout_ms=1.0)
    r_live = eng.submit(img, timeout_ms=0)           # no deadline
    r_shed = eng.submit(img)                         # the queue is at 2
    assert r_shed.state == tq.SHED
    with pytest.raises(tq.ShedError):
        r_shed.wait(timeout=0)
    time.sleep(0.01)                                 # r_expire's deadline
    assert _step(eng, (128, 160)) == [r_live]
    assert r_live.wait(timeout=0) is not None
    with pytest.raises(tq.DeadlineExceeded):
        r_expire.wait(timeout=0)
    snap = eng.metrics.snapshot()
    c = snap["counters"]
    assert (c["submitted"], c["served"], c["shed"], c["expired"]) == \
        (3, 1, 1, 1)
    assert snap["in_flight"] == 0 and snap["terminated"] == 3
    eng.close()
    assert eng.submit(img).state == tq.SHED      # closed: shed, not hung


def test_a_request_expiring_while_its_batch_runs_is_expired(predictors):
    eng = ServingEngine(predictors[1], _cfgs()[1], start=False)
    r = eng.submit(_img(), timeout_ms=20.0)
    batch = eng.queues[(128, 160)].take_batch(4, 0.0)
    assert batch == [r]
    time.sleep(0.03)                                 # expires mid-batch
    eng._serve_batch((128, 160), batch)
    with pytest.raises(tq.DeadlineExceeded):
        r.wait(timeout=0)
    c = eng.metrics.snapshot()["counters"]
    assert (c["expired"], c["served"], c["batches"]) == (1, 0, 1)


def test_a_failing_batch_fails_every_rider_and_keeps_the_dispatcher(
        predictors):
    def broken(images, im_info):
        raise RuntimeError("device lost")

    eng = ServingEngine(predictors[1], _cfgs()[1], run_fn=broken)
    try:
        with pytest.raises(tq.RequestFailed):
            eng.detect(_img(), timeout_ms=0)
        assert eng.alive()
        assert eng.metrics.snapshot()["counters"]["failed"] == 1
    finally:
        eng.kill()
        eng.close()


def test_kill_fails_what_is_queued(predictors):
    eng = ServingEngine(predictors[1], _cfgs()[1], start=False)
    r = eng.submit(_img(), timeout_ms=0)
    eng.kill()
    with pytest.raises(tq.RequestFailed):
        r.wait(timeout=0)
    assert not eng.alive() and eng.depth() == 0


# ---- HTTP -----------------------------------------------------------------------

@pytest.fixture
def http_url(engine):
    srv = make_server(engine, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address[:2]
    yield f"http://{host}:{port}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _http(url, payload=None, headers=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pixels(img):
    return {"pixels_b64": base64.b64encode(img.tobytes()).decode(),
            "shape": list(img.shape)}


def _raw_post(url, body: bytes, content_length):
    host, port = url.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/detect")
        if content_length is not None:
            conn.putheader("Content-Length", str(content_length))
        conn.endheaders()
        conn.send(body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_http_detect_equals_engine_detect(engine, http_url):
    img = _img(seed=3)
    status, body = _http(http_url + "/detect", _pixels(img))
    assert status == 200 and 1 <= body["batch_rows"] <= 2
    assert body["detections"] == detections_to_json(engine.detect(img), None)
    assert body["detections"]
    scores = [d["score"] for d in body["detections"]]
    assert scores == sorted(scores, reverse=True)
    import cv2

    ok, png = cv2.imencode(".png", img[:, :, ::-1])
    status, body2 = _http(http_url + "/detect", {
        "image_b64": base64.b64encode(png.tobytes()).decode()})
    assert status == 200 and body2["detections"] == body["detections"]


def test_http_healthz_metrics_and_refusals(http_url):
    status, health = _http(http_url + "/healthz")
    assert status == 200 and health["ok"] and health["warm_buckets"]
    status, snap = _http(http_url + "/metrics")
    assert status == 200 and "registry" in snap
    assert set(snap) >= {"counters", "total_ms", "batch_occupancy"}
    assert _http(http_url + "/nope")[0] == 404
    assert _http(http_url + "/nope", {})[0] == 404
    img = _img(seed=5)
    for bad in ({"shape": [2, 2, 3]}, "image_b64",
                {"pixels_b64": "AAAA", "shape": [0, 2, 3]},
                {"image_b64": base64.b64encode(b"not an image").decode()}):
        status, err = _http(http_url + "/detect", bad)
        assert status == 400 and "error" in err, bad
    for hostile in (float("inf"), float("nan"), -3.0, 1e38, "soon"):
        status, err = _http(http_url + "/detect",
                            dict(_pixels(img), timeout_ms=hostile))
        assert status == 400 and "timeout_ms" in err["error"], hostile
    status, err = _http(http_url + "/detect", _pixels(img),
                        {"X-MXR-Trace": "v1;id=zz;parent=1;hop=0;s=1"})
    assert status == 400 and "trace" in err["error"]
    status, _ = _http(http_url + "/detect", _pixels(img),
                      {"X-MXR-Trace": "v1;id=ab12;parent=1f;hop=1;s=1"})
    assert status == 200
    assert _raw_post(http_url, b"{}", 3 << 30)[0] == 413
    assert _raw_post(http_url, b"", None)[0] == 411


def test_http_429_from_a_full_queue(predictors):
    _, cfg = _cfgs(queue_depth=2, shed_watermark=1)
    eng = ServingEngine(predictors[1], cfg, start=False)
    srv = make_server(eng, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        img = _img()
        eng.submit(img, timeout_ms=0)            # fills the watermark
        status, err = _http("http://%s:%d/detect" % srv.server_address[:2],
                            _pixels(img))
        assert status == 429 and "shed" in err["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def test_image_b64_without_a_decoder_is_a_400(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="pixels_b64"):
        decode_image_payload({"image_b64": base64.b64encode(b"x").decode()})


def test_image_b64_through_pil_when_cv2_is_absent(monkeypatch):
    from PIL import Image

    img = _img(seed=9)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = decode_image_payload(
        {"image_b64": base64.b64encode(buf.getvalue()).decode()})
    np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError, match="PIL"):
        decode_image_payload({"image_b64": base64.b64encode(b"x").decode()})


# ---- loadgen and the serve CLI -------------------------------------------------

def _jax_record_keys():
    """The keys of the record the JAX package's loadgen prints (the dict
    literal ``rec`` in its ``main``), read from its source."""
    tree = ast.parse((REPO / "mx_rcnn_tpu/tools/loadgen.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    rec = next(n.value for n in ast.walk(main)
               if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
               and getattr(n.targets[0], "id", None) == "rec")
    return {k.value for k in rec.keys}


def test_loadgen_smoke_check_and_record_keys(capsys):
    rc = loadgen.main(["--smoke", "--device", "cpu", "--duration", "2",
                       "--check"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["lost"] == 0 and rec["served"] > 0
    assert rec["submitted"] == (rec["served"] + rec["shed"]
                                + rec["expired"] + rec["failed"])
    assert rec["shed_rate"] == 0.0 and rec["p50_ms"] <= rec["p99_ms"]
    assert rec["device"] == "cpu" and rec["resize_backend"] in ("cv2",
                                                                "numpy")
    assert rec["preprocess_ms_p50"] > 0
    assert set(rec) - {"preprocess_ms_p50", "resize_backend", "device"} == \
        _jax_record_keys() - {"recompiles_after_warmup"}


def test_open_loop_overdrive_sheds_and_loses_nothing(predictors):
    """400 arrivals/s against a stand-in device of 2 rows per 50 ms (40
    images/s), 4-deep watermark, 250 ms deadlines: every request ends,
    none fails, and admission control sheds or expires."""
    _, cfg = _cfgs(batch_size=2, queue_depth=8, shed_watermark=4)
    eng = ServingEngine(predictors[1], cfg,
                        run_fn=loadgen.make_stub_run_fn(cfg, 50.0))
    try:
        run = loadgen.run_open_loop(eng, loadgen.synthetic_images(cfg, 8),
                                    1.0, 400.0, 250.0)
    finally:
        eng.close()
    snap = eng.metrics.snapshot()
    c = snap["counters"]
    assert run["submitted"] == c["submitted"] == 400
    assert snap["in_flight"] == 0 and c["failed"] == 0
    assert sum(run["client"].values()) == 400 and run["client"]["failed"] == 0
    assert c["shed"] + c["expired"] > 0 and c["served"] > 0


def test_closed_loop_counts_every_outcome(predictors):
    _, cfg = _cfgs(batch_size=2)
    eng = ServingEngine(predictors[1], cfg,
                        run_fn=loadgen.make_stub_run_fn(cfg, 5.0))
    try:
        run = loadgen.run_closed_loop(eng, loadgen.synthetic_images(cfg, 4),
                                      0.5, 4, 2000.0)
    finally:
        eng.close()
    c = eng.metrics.snapshot()["counters"]
    assert run["client"]["ok"] == c["served"] > 0 and c["failed"] == 0


def test_entry_points_refuse_to_drop_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--prefix", str(tmp_path / "none"), "--epoch", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        loadgen.main(["--smoke", "--duration", "1"])
    assert serve_cli.parse_args(["--epoch", "1"]).device == "cuda"
    assert loadgen.parse_args([]).device == "cuda"


def test_serve_cli_serves_a_checkpoint_and_exits_on_sigint(tmp_path):
    """``tools/serve.py --device cpu`` on a tiny checkpoint: warm, one
    request served, ``/metrics`` counts it, SIGINT ends it with 0.  The
    CLI binds ``--port 0`` and names the port on its ready line: a port
    picked here and closed before the child binds it can be taken by
    any other process in between."""
    cfg = generate_config("tiny", "synthetic", **_CANVAS)
    prefix = str(tmp_path / "m")
    save_params(prefix, 1, build_model(cfg, "cpu", seed=3,
                                       train=True).state_dict())
    sets = [a for k, v in _CANVAS.items() for a in ("--set", f"{k}={v}")]
    err_path = tmp_path / "serve.err"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.serve",
             "--device", "cpu", "--network", "tiny", "--dataset",
             "synthetic", "--prefix", prefix, "--epoch", "1", "--port", "0"]
            + sets, cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        box = {}
        reader = threading.Thread(
            target=lambda: box.update(line=proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(90)
        assert box.get("line"), err_path.read_text()[-3000:]
        ready = json.loads(box["line"])
        assert ready["ready"] and ready["port"] > 0
        url = f"http://127.0.0.1:{ready['port']}"
        health = _http(url + "/healthz")[1]
        assert health["warm_buckets"] == [[128, 160], [160, 128]]
        status, body = _http(url + "/detect", _pixels(_img(False, seed=4)))
        assert status == 200 and body["batch_rows"] == 1
        assert _http(url + "/metrics")[1]["counters"]["served"] == 1
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    assert rc == 0, err_path.read_text()[-3000:]
