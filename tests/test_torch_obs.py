"""The port's observability plane, local half, held against the JAX
package on the CPU: the metrics registry and ``ServeMetrics``, host
spans and their chrome trace, run records, the ``torch.profiler``
window and its rollup, the fit loop's and the loaders' metrics, the
disabled path's cost, and ``tools/obs_smoke.py --device cpu --check``.

The same recordings go through ``mx_rcnn_tpu/obs`` and
``mx_rcnn_tpu_torch/obs``; what is compared is stated in each test (the
snapshots whole, the trace events without their clock stamps, the run
record's schema).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.obs import metrics as j_metrics
from mx_rcnn_tpu.obs import runrec as j_runrec
from mx_rcnn_tpu.obs import trace as j_trace
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.obs import health as t_health
from mx_rcnn_tpu_torch.obs import metrics as t_metrics
from mx_rcnn_tpu_torch.obs import profiler as t_profiler
from mx_rcnn_tpu_torch.obs import runrec as t_runrec
from mx_rcnn_tpu_torch.obs import timeseries as t_ts
from mx_rcnn_tpu_torch.obs import trace as t_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Both packages' module state off and empty around every test."""
    for tr in (j_trace, t_trace):
        tr.disable()
        tr.reset()
    t_ts.set_active(None)
    t_health.set_active_engine(None)
    yield
    for tr in (j_trace, t_trace):
        tr.disable()
        tr.reset()
    t_ts.set_active(None)
    t_health.set_active_engine(None)


def _record(reg, seed: int) -> None:
    """A seeded stream of recordings through a registry's public API."""
    rng = np.random.RandomState(seed)
    for i in range(300):
        reg.inc(f"c.{i % 5}", int(rng.randint(1, 4)))
        reg.set_gauge(f"g.{i % 3}", float(rng.uniform(-5, 5)))
        reg.observe("h.lat_ms", float(rng.lognormal(2.0, 1.5)))
        if i % 7 == 0:
            reg.observe("h.frac_pct", float(rng.uniform(0.0, 150.0)),
                        lo=0.01, hi=1000.0)
    reg.observe("h.huge", 1e9)   # the open overflow bucket


# ---------------------------------------------------------------------------
# registry and ServeMetrics against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_equals_jax(seed):
    j, t = j_metrics.Registry(), t_metrics.Registry()
    _record(j, seed)
    _record(t, seed)
    assert json.dumps(t.snapshot()) == json.dumps(j.snapshot())
    assert t.names() == j.names()
    for name in j.names():
        assert t.counter(name) == j.counter(name)
        assert t.gauge(name) == j.gauge(name)
    for name in ("h.lat_ms", "h.frac_pct", "h.huge"):
        np.testing.assert_array_equal(t.hist(name).counts,
                                      j.hist(name).counts)


@pytest.mark.parametrize("prefix", ["", "c.", "g.", "h.", "nothing."])
def test_registry_reset_is_prefix_scoped_as_in_jax(prefix):
    j, t = j_metrics.Registry(), t_metrics.Registry()
    _record(j, 3)
    _record(t, 3)
    j.reset(prefix)
    t.reset(prefix)
    assert t.snapshot() == j.snapshot()
    t.inc("c.0")
    j.inc("c.0")
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("p", [0, 1, 50, 90, 99, 99.9, 100])
def test_histogram_percentiles_equal_jax(p):
    rng = np.random.RandomState(5)
    jh, th = j_metrics.Histogram(), t_metrics.Histogram()
    for v in rng.lognormal(3.0, 2.0, 1000):
        jh.record(float(v))
        th.record(float(v))
    assert th.percentile(p) == jh.percentile(p)
    assert th.summary() == jh.summary()


def _serve_traffic(m, seed: int) -> None:
    rng = np.random.RandomState(seed)
    for i in range(400):
        m.count("submitted")
        q, t = rng.uniform(0.05, 900.0, 2)
        m.observe("queue_wait_ms", q)
        m.count(("served", "shed", "expired", "failed")[i % 4])
        m.observe("total_ms", t)
        if i % 3 == 0:
            m.observe_batch(1 + i % 4, 4, float(rng.uniform(1.0, 50.0)))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shared", [False, True])
def test_serve_metrics_snapshot_bit_identical_to_jax(seed, shared):
    """The serving snapshot, and the registry it records into (private
    or shared with other subsystems), byte for byte."""
    jreg, treg = j_metrics.Registry(), t_metrics.Registry()
    if shared:
        jreg.inc("train.steps", 5)
        treg.inc("train.steps", 5)
    j = j_metrics.ServeMetrics(registry=jreg)
    t = t_metrics.ServeMetrics(registry=treg)
    _serve_traffic(j, seed)
    _serve_traffic(t, seed)
    assert json.dumps(t.snapshot(), sort_keys=True) == \
        json.dumps(j.snapshot(), sort_keys=True)
    assert json.dumps(treg.snapshot()) == json.dumps(jreg.snapshot())
    assert t.in_flight() == j.in_flight()
    assert t.counters == j.counters
    assert sorted(t.hists) == sorted(j.hists)


def test_serve_metrics_survive_registry_reset_mid_traffic():
    reg = t_metrics.Registry()
    m = t_metrics.ServeMetrics(registry=reg)
    m.count("submitted")
    m.observe_batch(2, 4, 5.0)
    reg.reset()
    m.count("served")
    m.observe_batch(1, 4, 3.0)
    snap = m.snapshot()
    assert snap["counters"]["served"] == 1
    assert snap["counters"]["submitted"] == 0
    assert snap["batch_occupancy"]["batches"] == 1
    assert m.counters["shed"] == 0 and "total_ms" in m.hists


def test_registry_exact_under_concurrent_recorders():
    reg = t_metrics.Registry()
    threads, per = 8, 2000

    def worker(wid):
        for i in range(per):
            reg.inc("c.total")
            reg.observe("h.lat_ms", float(i % 7) + 0.5)
            reg.set_gauge(f"g.w{wid}", i)

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = reg.snapshot()
    assert snap["counters"]["c.total"] == threads * per
    assert snap["hists"]["h.lat_ms"]["count"] == threads * per
    assert all(snap["gauges"][f"g.w{w}"] == per - 1 for w in range(threads))


def test_process_registry_is_one_object():
    assert t_metrics.registry() is t_metrics.registry()
    import mx_rcnn_tpu_torch.obs as obs

    assert obs.registry is t_metrics.registry


# ---------------------------------------------------------------------------
# the stdlib /metrics exporter
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_metrics_http_scrape_timeseries_and_healthz():
    reg = t_metrics.Registry()
    reg.inc("train.steps", 3)
    srv = t_metrics.start_metrics_server(reg, port=0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        status, body = _get(base + "/metrics")
        assert status == 200 and body == reg.snapshot()
        assert "timeseries" not in body
        store = t_ts.TimeSeriesStore(8)
        store.sample(reg, ts=1.0)
        store.sample(reg, ts=2.0)
        t_ts.set_active(store)
        status, body = _get(base + "/metrics")
        assert body["timeseries"] == store.scrape_section()
        assert _get(base + "/healthz") == (200, {"ok": True})
        eng = t_health.HealthEngine(
            [t_health.Rule("r", "train.steps", "gauge", ">", 0.0,
                           severity=t_health.CRITICAL, for_samples=1)],
            store)
        reg.set_gauge("train.steps", 1.0)
        store.sample(reg, ts=3.0)
        eng.evaluate()
        t_health.set_active_engine(eng)
        status, body = _get(base + "/healthz")
        assert status == 503 and body["health"]["verdict"] == "CRITICAL"
        assert _get(base + "/nope")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# host spans and the chrome trace against the JAX package
# ---------------------------------------------------------------------------

def _spans(tr, path):
    tr.enable()
    tr.reset()
    tr.set_trace_id("7.1")
    with tr.span("outer", stage="a"):
        with tr.span("inner"):
            tr.instant("tick", n=1)
        with tr.span("inner2", trace_id="7.2"):
            pass
    tr.set_trace_id(None)
    tr.complete("done", 2.5, k="v")
    tr.async_begin("req", "9.9", bucket="1x2")
    tr.async_end("req", "9.9", state="served")
    tr.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def _strip(ev):
    """An event without its clock stamps, process and thread."""
    return {k: v for k, v in ev.items()
            if k not in ("ts", "dur", "pid", "tid")}


def test_chrome_trace_schema_and_nesting_equal_jax(tmp_path):
    jdoc = _spans(j_trace, tmp_path / "j.json")
    tdoc = _spans(t_trace, tmp_path / "t.json")
    assert sorted(tdoc) == sorted(jdoc)
    assert tdoc["metadata"] == jdoc["metadata"]
    assert [_strip(e) for e in tdoc["traceEvents"]] == \
        [_strip(e) for e in jdoc["traceEvents"]]
    for je, te in zip(jdoc["traceEvents"], tdoc["traceEvents"]):
        assert sorted(te) == sorted(je)
    ev = {e["name"]: e for e in tdoc["traceEvents"] if e["ph"] == "X"}
    outer, inner = ev["outer"], ev["inner"]
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert inner["args"] == {"depth": 1, "trace_id": "7.1"}
    assert ev["inner2"]["args"]["trace_id"] == "7.2"


def test_trace_disabled_emits_nothing():
    with t_trace.span("x"):
        pass
    t_trace.complete("y", 1.0)
    t_trace.instant("z")
    t_trace.async_begin("a", "1")
    assert t_trace.events() == []
    assert t_trace.span("x") is t_trace.span("y")   # the shared null


@pytest.mark.parametrize("cap", [1, 10, 100])
def test_trace_buffer_is_bounded_as_in_jax(cap):
    for tr in (j_trace, t_trace):
        tr.enable(cap)
        tr.reset()
        for i in range(cap + 25):
            with tr.span(f"s{i}"):
                pass
    assert len(t_trace.events()) == len(j_trace.events()) == cap
    assert t_trace.dropped() == j_trace.dropped() == 25


def _tiny_engine(cfg, model_ms=2.0):
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.tools import loadgen

    pred = Predictor(build_model(cfg, device="cpu"), cfg, "cpu")
    return ServingEngine(pred, cfg,
                         run_fn=loadgen.make_stub_run_fn(cfg, model_ms))


def _serve_cfg(**kw):
    return generate_config("tiny", "synthetic", bucket__scale=64,
                           bucket__max_size=96,
                           bucket__shapes=((64, 96), (96, 64)),
                           serve__batch_size=2, **kw)


def test_trace_id_continuity_queue_engine_respond():
    """One trace id across a request's admission (caller), batch
    (dispatcher) and terminal transition."""
    from mx_rcnn_tpu_torch.tools import loadgen

    cfg = _serve_cfg()
    t_trace.enable()
    eng = _tiny_engine(cfg)
    try:
        reqs = [eng.submit(img) for img in loadgen.synthetic_images(cfg, 4)]
        for r in reqs:
            r.wait(10)
    finally:
        eng.close()
    evs = t_trace.events()
    for r in reqs:
        mine = [e for e in evs if e.get("args", {}).get("trace_id")
                == r.trace_id or e.get("id") == r.trace_id]
        phases = sorted(e["ph"] for e in mine if e["name"] == "serve.request")
        assert phases == ["b", "e"]
        assert any(e["name"] == "serve.queue_wait" for e in mine)
        begin = next(e for e in mine if e["ph"] == "b")
        queue = next(e for e in mine if e["name"] == "serve.queue_wait")
        assert begin["tid"] != queue["tid"]       # across threads
    batches = [e for e in evs if e["name"] == "serve.batch"]
    assert batches and all(e["args"]["rows"] >= 1 for e in batches)
    assert {t for e in batches for t in e["args"]["trace_ids"]} == \
        {r.trace_id for r in reqs}


def test_shed_request_closes_its_trace_interval():
    from mx_rcnn_tpu_torch.tools import loadgen

    cfg = _serve_cfg()
    t_trace.enable()
    eng = _tiny_engine(cfg)
    eng.close()
    req = eng.submit(loadgen.synthetic_images(cfg, 1)[0])
    assert req.state == "shed"
    ends = [e for e in t_trace.events()
            if e["ph"] == "e" and e["id"] == req.trace_id]
    assert len(ends) == 1 and ends[0]["args"]["state"] == "shed"


def test_disabled_path_costs_a_branch():
    """The fit loop's disabled obs path: two disabled spans, the
    ``rec is None`` checks and a disabled profiler scope a step; each
    one flag read (JAX's bound, ``tests/test_obs.py``: 50 µs a step)."""
    rec = None
    it = iter(range(10_000))
    end = object()
    n = 0
    t0 = time.perf_counter()
    while True:
        with t_trace.span("train.data_wait"):
            item = next(it, end)
        if item is end:
            break
        if rec is not None:  # pragma: no cover - disabled path
            pass
        with t_trace.span("train.dispatch"):
            with t_profiler.scope("loss"):
                pass
        if rec is not None:  # pragma: no cover
            pass
        n += 1
    per_step = (time.perf_counter() - t0) / n
    assert per_step < 50e-6, f"{per_step * 1e6:.1f} µs a step"


def test_speedometer_line_unchanged_and_registry():
    from mx_rcnn_tpu_torch.core.fit import Speedometer

    plain, wired = [], []
    reg = t_metrics.Registry()
    a = Speedometer(2, plain.append)
    b = Speedometer(2, wired.append, registry=reg)
    for s in (a, b):
        s._tic = 0.0
    metrics = {"loss": 1.25, "rpn_acc": 0.5}
    a(0, 3, metrics, 0.0)
    b(0, 3, metrics, 0.0)
    strip = lambda s: s.split("Speed:")[0]  # noqa: E731
    assert [strip(x) for x in plain] == [strip(x) for x in wired]
    assert plain[0].endswith(wired[0].split("samples/sec")[1])
    assert reg.gauge("train.metric.loss") == 1.25
    assert reg.gauge("train.samples_per_sec") > 0


# ---------------------------------------------------------------------------
# run records against the JAX package
# ---------------------------------------------------------------------------

def _run_record(mod, base, metrics_mod):
    rec = mod.RunRecord("train", base_dir=str(base), run_id="r1")
    seen = []
    rec.add_listener(seen.append)
    rec.event("epoch_start", epoch=0, skip=0, steps_per_epoch=4)
    rec.event("log", epoch=0, nbatch=1, loss=np.float32(1.5),
              arr=np.arange(3))
    rec.event("snapshot", epoch=0, path="/x")
    reg = metrics_mod.Registry()
    _record(reg, 4)
    summary = rec.finish(metric="train_samples_per_sec", value=12.5,
                         unit="imgs/s", registry=reg, steps=4)
    rec.close()
    with open(rec.events_path) as f:
        lines = [json.loads(line) for line in f]
    with open(rec.summary_path) as f:
        on_disk = json.load(f)
    return lines, summary, on_disk, seen


def test_run_record_schema_and_summary_equal_jax(tmp_path):
    jl, js, jd, jseen = _run_record(j_runrec, tmp_path / "j", j_metrics)
    tl, ts_, td, tseen = _run_record(t_runrec, tmp_path / "t", t_metrics)
    strip = lambda e: {k: v for k, v in e.items()  # noqa: E731
                       if k not in ("ts", "argv", "pid")}
    assert [strip(e) for e in tl] == [strip(e) for e in jl]
    assert all(isinstance(e["ts"], float) for e in tl)
    assert [e["event"] for e in tseen] == [e["event"] for e in jseen]
    assert td == ts_ and jd == js
    assert td == jd


def test_run_record_never_raises_and_is_line_granular(tmp_path):
    rec = t_runrec.RunRecord("serve", base_dir=str(tmp_path), run_id="x")
    rec.event("weird", obj=object())            # degrades to repr
    rec.add_listener(lambda e: 1 / 0)           # a failing listener
    rec.event("after")
    with open(rec.events_path, "a") as f:       # a torn tail line
        f.write('{"ts": 1.0, "ev')
    rec.close()
    rec.event("closed")                          # no-op, no raise
    lines = open(rec.events_path).read().splitlines()
    whole = [json.loads(ln) for ln in lines[:-1]]
    assert [e["event"] for e in whole] == ["run_start", "weird", "after"]
    with pytest.raises(json.JSONDecodeError):
        json.loads(lines[-1])


def test_cli_obs_is_off_by_default():
    assert t_runrec.cli_obs(generate_config("tiny", "synthetic"),
                            "train") is None


def test_cli_obs_full_plane_build_and_teardown(tmp_path):
    from mx_rcnn_tpu_torch.obs import flightrec

    cfg = generate_config("tiny", "synthetic", obs__enabled=True,
                          obs__trace=True, obs__timeseries=True,
                          obs__health=True, obs__flight=True,
                          obs__sample_interval_s=0.05,
                          obs__run_dir=str(tmp_path))
    prev_hook = sys.excepthook
    sess = t_runrec.cli_obs(cfg, "train")
    try:
        assert t_trace.enabled() and t_ts.active() is sess.store
        assert t_health.active_engine() is sess.health
        assert flightrec.active() is sess.flight
        with t_trace.span("work"):
            time.sleep(0.15)
    finally:
        sess.close(metric="m", value=1.0)
    assert not t_trace.enabled() and t_ts.active() is None
    assert t_health.active_engine() is None and flightrec.active() is None
    assert sys.excepthook is prev_hook
    summary = json.load(open(os.path.join(sess.record.dir, "summary.json")))
    assert summary["obs_failures"] == [] and summary["value"] == 1.0
    assert "health.verdict" in summary["metrics"]["gauges"]
    trace = json.load(open(os.path.join(sess.record.dir, "trace.json")))
    assert any(e["name"] == "work" for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# the profiler: op classes, rollup, windows, merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cls", [
    ("nms_mask_kernel", "K1 nms_mask_kernel"),
    ("nms_reduce_kernel", "K1 nms_reduce_kernel"),
    ("void roi_align_fwd_kernel<__nv_bfloat16>(...)",
     "K2 roi_align_fwd_kernel"),
    ("roi_align_bwd_tables_kernel", "K3 roi_align_bwd_tables_kernel"),
    ("void roi_align_bwd_kernel<float>(...)", "K3 roi_align_bwd_kernel"),
    ("quantize_act_kernel", "K4 quantize_act_kernel"),
    ("qconv_kernel_widen_b", "K5/K6 qconv_kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "gemm_conv"),
    ("cudnn::engines_precompiled::nchwToNhwcKernel", "gemm_conv"),
    ("aten::addmm", "gemm_conv"),
    ("aten::add_", "elementwise"),
    ("void at::native::reduce_kernel<512, 1>", "other"),
    ("Memset (Device)", "other"),
])
def test_op_class(name, cls):
    assert t_profiler.op_class(name) == cls


def _kineto_doc(base_ns=None, absolute=False):
    """A trace as Kineto writes one: two scoped launches on the main
    thread, one from the autograd thread inside ``backward``, a copy
    outside every range, CPU ops, and their correlations."""
    off = 1.7e15 if absolute else 0.0
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "loss", "pid": 1,
         "tid": 10, "ts": off + 100.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "roi_align", "pid": 1,
         "tid": 10, "ts": off + 150.0, "dur": 20.0},
        {"ph": "X", "cat": "user_annotation", "name": "backward", "pid": 1,
         "tid": 10, "ts": off + 210.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 10, "ts": off + 120.0, "dur": 5.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 10, "ts": off + 160.0, "dur": 5.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 11, "ts": off + 220.0, "dur": 5.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "pid": 1, "tid": 12, "ts": off + 300.0, "dur": 5.0,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "nms_mask_kernel", "pid": 0,
         "tid": 7, "ts": off + 130.0, "dur": 400.0,
         "args": {"correlation": 1, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "roi_align_fwd_kernel",
         "pid": 0, "tid": 7, "ts": off + 530.0, "dur": 100.0,
         "args": {"correlation": 2, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "roi_align_bwd_kernel",
         "pid": 0, "tid": 7, "ts": off + 630.0, "dur": 200.0,
         "args": {"correlation": 3, "device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 8, "ts": off + 310.0, "dur": 50.0,
         "args": {"correlation": 4, "device": 0, "stream": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
         "tid": 10, "ts": off + 101.0, "dur": 3.0},
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "python"}},
    ]
    doc = {"traceEvents": ev}
    if base_ns is not None:
        doc["baseTimeNanoseconds"] = base_ns
    return doc


def test_rollup_attributes_device_time_by_scope_and_class():
    roll = t_profiler.rollup_events(_kineto_doc())
    assert roll["device"] == "cuda:0"
    assert roll["by_op_class"] == {"K1 nms_mask_kernel": 0.4,
                                   "K3 roi_align_bwd_kernel": 0.2,
                                   "K2 roi_align_fwd_kernel": 0.1,
                                   "copies": 0.05}
    assert roll["op_class_calls"] == {"K1 nms_mask_kernel": 1,
                                      "K2 roi_align_fwd_kernel": 1,
                                      "K3 roi_align_bwd_kernel": 1,
                                      "copies": 1}
    # the innermost range on the launching thread; the autograd
    # thread's launch falls to the range open on any thread
    assert roll["by_scope"] == {"loss": 0.4, "backward": 0.2,
                                "roi_align": 0.1, "(unscoped)": 0.05}
    assert roll["device_ms"] == pytest.approx(0.75)


def test_rollup_of_a_host_only_window():
    doc = _kineto_doc()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("cat") not in ("kernel", "gpu_memcpy")]
    roll = t_profiler.rollup_events(doc)
    assert roll["device"] == "cpu"
    assert roll["by_op_class"] == {"elementwise": 0.003}
    assert roll["by_scope"] == {"loss": 0.1, "backward": 0.05,
                                "roi_align": 0.02}


@pytest.mark.parametrize("base_ns,absolute,shift", [
    (1_790_000_000_000_000_000, False, 1_790_000_000_000_000.0),
    (1_790_000_000_000_000_000, True, 0.0),
    (None, True, 0.0),
])
def test_device_events_on_the_host_clock(base_ns, absolute, shift):
    doc = _kineto_doc(base_ns, absolute)
    out = t_trace.device_trace_events(doc)
    raw = [e for e in doc["traceEvents"]
           if e.get("cat") in ("kernel", "gpu_memcpy")]
    assert [e["ts"] for e in out] == [e["ts"] + shift for e in raw]
    assert {e["pid"] for e in out} == {"device:cuda:0"}
    assert {e["tid"] for e in out} == {"stream 7", "stream 8"}
    assert all(e["ph"] == "X" for e in out)


def test_profiler_window_on_the_cpu(tmp_path):
    assert t_profiler.scope("loss") is t_profiler.scope("head")
    assert t_profiler.start_window(str(tmp_path / "w"))
    try:
        assert not t_profiler.start_window(str(tmp_path / "w2"))  # one
        with t_profiler.scope("backbone"):
            torch.randn(64, 64) @ torch.randn(64, 64)
        with t_profiler.scope("head"):
            torch.relu(torch.randn(128))
    finally:
        roll = t_profiler.stop_window()
    assert t_profiler.stop_window() == {}
    assert roll["device"] == "cpu" and roll["by_op_class"]
    assert {"backbone", "head"} <= set(roll["by_scope"])
    assert set(roll["launch_counts"]) >= {"nms_sweep", "roi_align_fwd"}
    on_disk = json.load(open(tmp_path / "w" / "rollup.json"))
    assert on_disk == json.loads(json.dumps(roll))
    assert t_profiler.newest_trace(str(tmp_path)) == roll["trace"]
    # host spans and the window's events in one file
    t_trace.enable()
    with t_trace.span("host"):
        pass
    path = t_trace.merge_device_trace(str(tmp_path / "merged.json"),
                                      str(tmp_path))
    evs = json.load(open(path))["traceEvents"]
    assert any(e["name"] == "host" for e in evs)
    assert any(e["pid"] == "device:cpu" for e in evs)


def test_window_refused_while_another_profiler_runs(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert not t_profiler.start_window(str(tmp_path))
    assert not t_profiler.window_open()


def test_step_profiler_covers_its_steps(tmp_path):
    sp = t_profiler.StepProfiler(str(tmp_path), at_step=3, steps=2)
    opened = []
    for step in range(1, 8):
        sp.on_step(step)
        opened.append(t_profiler.window_open())
    assert opened == [False, False, True, True, False, False, False]
    assert sp.result["device"] == "cpu"
    idle = t_profiler.StepProfiler(str(tmp_path / "x"), at_step=0)
    idle.on_step(5)
    idle.close()
    assert idle.result == {}


def test_sigusr2_toggles_a_window_at_the_next_safe_point(tmp_path):
    prev = signal.getsignal(signal.SIGUSR2)
    try:
        t_profiler.install_sigusr2(str(tmp_path))
        t_profiler.poll_sigusr2()                 # nothing asked yet
        assert not t_profiler.window_open()
        signal.raise_signal(signal.SIGUSR2)
        assert not t_profiler.window_open()       # the handler only flags
        t_profiler.poll_sigusr2()
        assert t_profiler.window_open()
        torch.randn(32, 32) @ torch.randn(32, 32)
        signal.raise_signal(signal.SIGUSR2)
        t_profiler.poll_sigusr2()
        assert not t_profiler.window_open()
        roll = json.load(open(tmp_path / "sigusr2-0" / "rollup.json"))
        assert roll["by_op_class"]
    finally:
        signal.signal(signal.SIGUSR2, prev)


# ---------------------------------------------------------------------------
# the training path's wiring
# ---------------------------------------------------------------------------

def _train(obs: bool, tmp_path, **obs_kw):
    from mx_rcnn_tpu_torch.tools.train import train_net

    over = {f"obs__{k}": v for k, v in obs_kw.items()}
    cfg = generate_config("tiny", "synthetic", train__batch_images=2,
                          obs__enabled=obs, bucket__scale=64,
                          bucket__max_size=96,
                          bucket__shapes=((64, 96), (96, 64)), **over)
    t_metrics.registry().reset()
    lines = []
    _, metrics = train_net(cfg, synthetic=4, end_epoch=1, frequent=1,
                           device="cpu", seed=0, log=lines.append,
                           prefix=str(tmp_path / ("on" if obs else "off")))
    return metrics, lines


def _untimed(line: str) -> str:
    """A log line without its timings and paths."""
    return line.split("Speed:")[0].split(" in ")[0].split(" to ")[0]


def test_fit_with_the_plane_on_trains_the_same_steps(tmp_path):
    """Training with ``cfg.obs`` on gives the losses of a run with it
    off, and publishes the train/loader/snapshot metrics; off, the
    process registry stays empty."""
    off, off_lines = _train(False, tmp_path)
    assert t_metrics.registry().names() == ()
    on, on_lines = _train(True, tmp_path, trace=True)
    assert on == off
    assert [_untimed(x) for x in on_lines] == [_untimed(x) for x in off_lines]
    names = set(t_metrics.registry().names())
    assert {"train.steps", "train.step_ms", "train.data_wait_frac_pct",
            "train.samples_per_sec", "train.loss_ema",
            "loader.decode_ms", "loader.assemble_ms", "loader.batches",
            "loader.stage_hits", "snapshot.stall_ms"} <= names
    assert t_metrics.registry().counter("train.steps") == 4


def test_snapshotter_publishes_snapshot_metrics(tmp_path):
    from mx_rcnn_tpu_torch.core.train import setup_training
    from mx_rcnn_tpu_torch.ft.snapshot import make_snapshotter

    cfg = generate_config("tiny", "synthetic", obs__enabled=True)
    reg = t_metrics.registry()
    reg.reset("snapshot.")
    state = setup_training(cfg, device="cpu")
    for async_ in (True, False):
        snap = make_snapshotter(str(tmp_path / f"m{async_}"),
                                cfg.replace_in("ft", async_snapshots=async_),
                                4)
        snap.save_epoch(1, state)
        snap.close()
    assert reg.counter("snapshot.commits") == 2
    assert reg.counter("snapshot.bytes") > 0
    assert reg.hist("snapshot.stall_ms").total == 2
    assert reg.hist("snapshot.commit_ms").total == 2


def test_obs_smoke_checks_pass_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.obs_smoke",
         "--device", "cpu", "--check", "--workdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["value"] == 1 and rec["problems"] == []
    assert rec["final_epoch_loads"] == {"builds": 0, "loads": 0}
