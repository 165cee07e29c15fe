"""The port's time-series plane and distributed trace, held against the
JAX package on the CPU: the time-series store's windowed queries, the
health engine's verdicts, the flight recorder's dumps, the collector's
merged view, the trace context's bytes and header, the span ring and the
skew-corrected merge, and their wiring into the serving front end and
the training CLI.

Each parity test drives ``mx_rcnn_tpu/obs`` and ``mx_rcnn_tpu_torch/obs``
with the same seeded stream and fixed sample timestamps; the results are
compared exactly.
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

from mx_rcnn_tpu.config import generate_config as j_generate_config
from mx_rcnn_tpu.obs import collect as j_collect
from mx_rcnn_tpu.obs import flightrec as j_flight
from mx_rcnn_tpu.obs import health as j_health
from mx_rcnn_tpu.obs import metrics as j_metrics
from mx_rcnn_tpu.obs import timeseries as j_ts
from mx_rcnn_tpu.obs import trace as j_trace
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.obs import collect as t_collect
from mx_rcnn_tpu_torch.obs import flightrec as t_flight
from mx_rcnn_tpu_torch.obs import health as t_health
from mx_rcnn_tpu_torch.obs import metrics as t_metrics
from mx_rcnn_tpu_torch.obs import timeseries as t_ts
from mx_rcnn_tpu_torch.obs import trace as t_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state():
    for tr in (j_trace, t_trace):
        tr.disable()
        tr.reset()
        tr.reset_distributed()
    yield
    for tr in (j_trace, t_trace):
        tr.disable()
        tr.reset()
        tr.reset_distributed()
    t_ts.set_active(None)
    t_health.set_active_engine(None)
    t_flight.set_active(None)


def _stream(metrics_mod, ts_mod, seed: int, n: int = 40):
    """A registry and a store fed the same seeded recordings, one sample
    a second from t=1000."""
    reg = metrics_mod.Registry()
    store = ts_mod.TimeSeriesStore(capacity=32,
                                   clock=lambda: 0.0)
    rng = np.random.RandomState(seed)
    for i in range(n):
        reg.inc("serve.submitted", int(rng.randint(5, 20)))
        reg.inc("serve.shed", int(rng.randint(0, 3)))
        reg.set_gauge("train.data_wait_frac", float(rng.uniform(0, 1)))
        for _ in range(int(rng.randint(1, 30))):
            reg.observe("serve.total_ms", float(rng.lognormal(4, 1.2)))
        if i % 3:
            reg.set_gauge("fleet.replicas_ready", float(i % 2))
        store.sample(reg, ts=1000.0 + i)
    return reg, store


_WINDOWS = [None, 0.0, 3.0, 10.0, 25.0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("window", _WINDOWS)
def test_windowed_queries_equal_jax(seed, window):
    _, js = _stream(j_metrics, j_ts, seed)
    _, tsr = _stream(t_metrics, t_ts, seed)
    for name in ("serve.submitted", "serve.shed", "nope"):
        assert tsr.delta(name, window) == js.delta(name, window)
        assert tsr.rate(name, window) == js.rate(name, window)
    for name in ("train.data_wait_frac", "fleet.replicas_ready", "nope"):
        assert tsr.gauge(name, window) == js.gauge(name, window)
        assert tsr.gauge_max(name, window) == js.gauge_max(name, window)
        assert tsr.gauge_min(name, window) == js.gauge_min(name, window)
        assert tsr.series(name, window) == js.series(name, window)
    for p in (50, 90, 99, 100):
        assert tsr.pctl("serve.total_ms", p, window) == \
            js.pctl("serve.total_ms", p, window)
    assert tsr.hist_window("serve.total_ms", window) == \
        js.hist_window("serve.total_ms", window)
    assert tsr.scrape_section(window or 60.0) == \
        js.scrape_section(window or 60.0)
    assert len(tsr) == len(js) and tsr.dropped == js.dropped


def test_windowed_percentile_is_the_bucket_count_difference():
    reg, store = t_metrics.Registry(), t_ts.TimeSeriesStore(16)
    store.sample(reg, ts=100.0)
    reg.observe("lat", 5000.0)          # an old spike
    store.sample(reg, ts=125.0)
    for v in (10.0, 12.0, 11.0, 13.0):
        reg.observe("lat", v)
    store.sample(reg, ts=130.0)
    assert store.pctl("lat", 99) >= 5000.0 * 0.9
    assert store.pctl("lat", 99, 10.0) < 100.0
    assert store.hist_window("lat", 10.0)["count"] == 4


def test_summary_only_samples_equal_jax():
    snap = {"counters": {"c": 5}, "gauges": {"g": 1.0},
            "hists": {"lat": {"count": 3, "p50": 10.0, "p99": 40.0,
                              "max": 41.0}}}
    out = []
    for mod in (j_ts, t_ts):
        store = mod.TimeSeriesStore(capacity=8)
        store.append_snapshot(snap, ts=100.0)
        store.append_snapshot(snap, ts=101.0, gauge_labels={"g": {"a": 1}})
        out.append((store.pctl("lat", 99, 60.0),
                    store.hist_window("lat", 60.0), store.window()))
    assert out[0] == out[1]


def test_sampler_hook_failure_disables_the_hook_only():
    store = t_ts.TimeSeriesStore(8)
    calls = []

    def hook(smp):
        calls.append(smp["ts"])
        raise RuntimeError("boom")

    s = t_ts.Sampler(store, interval_s=0.01, reg=t_metrics.Registry(),
                     after_sample=hook)
    s.tick()
    s.tick()
    assert len(calls) == 1 and len(store) == 2
    s.start()
    time.sleep(0.05)
    s.stop()
    assert len(store) > 3


def test_concurrent_sampling_is_exact():
    reg, store = t_metrics.Registry(), t_ts.TimeSeriesStore(1000)
    s = t_ts.Sampler(store, interval_s=0.001, reg=reg).start()

    def work():
        for _ in range(2000):
            reg.inc("c")
            reg.observe("h", 1.0)

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    s.stop(final_sample=True)
    for smp in store.window():
        h = smp["hists"].get("h")
        if h is not None:
            assert int(h["counts"].sum()) == h["total"]
    last = store.window()[-1]
    assert last["counters"]["c"] == 8000 and last["hists"]["h"]["total"] == \
        8000


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------

def _rules(mod):
    R = mod.Rule
    return [R("p99", "serve.total_ms", "p99", ">", 150.0, window_s=5.0,
              severity=mod.CRITICAL),
            R("shed", "serve.shed/serve.submitted", "ratio", ">", 0.1,
              window_s=5.0),
            R("wait", "train.data_wait_frac", "gauge", ">", 0.6,
              window_s=2.0, for_samples=3, clear_samples=1),
            R("ready", "fleet.replicas_ready", "gauge_min", "<", 1.0,
              window_s=3.0, severity=mod.CRITICAL, for_samples=1),
            R("rate", "serve.submitted", "rate", "<", 11.0, window_s=4.0),
            R("absent", "no.such.metric", "delta", ">", 0.0)]


def _verdicts(metrics_mod, ts_mod, health_mod, seed):
    """Verdicts after each sample of the seeded stream, with the gauges
    and the transitions the engine published."""
    reg = metrics_mod.Registry()
    store = ts_mod.TimeSeriesStore(capacity=64)
    transitions = []

    class Rec:
        def event(self, kind, **kw):
            transitions.append((kind, kw))

    clock = iter(range(10_000))
    eng = health_mod.HealthEngine(
        _rules(health_mod), store, registry=reg, record=Rec(),
        on_transition=lambda a, b, v: transitions.append(("cb", a, b)),
        clock=lambda: float(next(clock)))
    rng = np.random.RandomState(seed)
    out = []
    for i in range(60):
        reg.inc("serve.submitted", int(rng.randint(5, 20)))
        reg.inc("serve.shed", int(rng.randint(0, 4)))
        reg.set_gauge("train.data_wait_frac", float(rng.uniform(0, 1)))
        for _ in range(int(rng.randint(1, 10))):
            reg.observe("serve.total_ms", float(rng.lognormal(4.2, 1.0)))
        reg.set_gauge("fleet.replicas_ready", float(i % 7 != 0))
        store.sample(reg, ts=2000.0 + i)
        v = eng.evaluate()
        out.append((v["verdict"], v["firing"], v["changed"],
                    [r["value"] for r in v["rules"]],
                    [r["breaching"] for r in v["rules"]]))
    gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
              if k.startswith("health.")}
    return out, gauges, transitions, eng.exit_code()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_health_verdicts_equal_jax(seed):
    assert _verdicts(t_metrics, t_ts, t_health, seed) == \
        _verdicts(j_metrics, j_ts, j_health, seed)


def test_default_rules_equal_jax():
    over = dict(serve__default_timeout_ms=900.0, obs__health_window_s=12.0,
                obs__skew_alarm_ms=7.0)
    t = t_health.default_rules(generate_config("tiny", "synthetic", **over))
    j = j_health.default_rules(j_generate_config("tiny", "synthetic",
                                                 **over))
    assert [vars(r) for r in t] == [vars(r) for r in j]
    assert t_health.EXIT_BY_VERDICT == j_health.EXIT_BY_VERDICT


def test_hysteresis_and_missing_metric():
    reg, store = t_metrics.Registry(), t_ts.TimeSeriesStore(16)
    eng = t_health.HealthEngine(
        [t_health.Rule("g", "g", "gauge", ">", 1.0, for_samples=2,
                       clear_samples=2),
         t_health.Rule("m", "missing", "gauge", ">", 0.0,
                       severity=t_health.CRITICAL)], store)
    seen = []
    for i, v in enumerate([2.0, 0.0, 2.0, 2.0, 0.0, 2.0, 0.0, 0.0]):
        reg.set_gauge("g", v)
        store.sample(reg, ts=float(i))
        seen.append(eng.evaluate()["verdict"])
    assert seen == ["OK", "OK", "OK", "WARN", "WARN", "WARN", "WARN", "OK"]
    assert eng.exit_code() == 0 and eng.last()["rules"][1]["value"] is None


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _flight(mod_flight, mod_ts, mod_metrics, mod_trace, run_dir):
    reg = mod_metrics.Registry()
    store = mod_ts.TimeSeriesStore(16)
    reg.inc("c", 3)
    reg.observe("h", 5.0)
    store.sample(reg, ts=time.time() - 1)
    store.sample(reg, ts=time.time())
    mod_trace.enable()
    with mod_trace.span("s"):
        pass
    mod_trace.configure_distributed(ring=8)
    ctx = mod_trace.TraceContext("a.1", parent=5)
    mod_trace.record_span(ctx, "x", 1.0)
    mod_trace.close_trace(ctx, keep=True)
    rec = mod_flight.FlightRecorder(store, str(run_dir), window_s=60.0,
                                    min_gap_s=60.0)
    rec.note_event({"event": "e1"})
    rec.add_context("ctx", lambda: {"depth": 1})
    rec.add_context("bad", lambda: 1 / 0)
    first = rec.dump("crash", force=False, error="E")
    second = rec.dump("crash")              # inside min_gap: refused
    third = rec.dump("watchdog")            # another reason: written
    forced = rec.dump("crash", force=True)
    with open(first) as f:
        return json.load(f), [first, second, third, forced]


def test_flight_dump_schema_and_rate_limit_equal_jax(tmp_path):
    jdoc, jpaths = _flight(j_flight, j_ts, j_metrics, j_trace,
                           tmp_path / "j")
    tdoc, tpaths = _flight(t_flight, t_ts, t_metrics, t_trace,
                           tmp_path / "t")
    assert sorted(tdoc) == sorted(jdoc)
    assert tdoc["schema"] == jdoc["schema"] == "mx_rcnn_tpu.flight/2"
    assert tdoc["reason"] == "crash" and tdoc["extra"] == {"error": "E"}
    assert sorted(tdoc["samples"][0]) == sorted(jdoc["samples"][0])
    assert tdoc["samples"][0]["hists"] == jdoc["samples"][0]["hists"]
    assert tdoc["events"] == jdoc["events"]
    assert sorted(tdoc["context"]) == sorted(jdoc["context"])
    assert tdoc["context"]["ctx"] == {"depth": 1}
    assert [s["name"] for s in tdoc["spans"]] == \
        [s["name"] for s in jdoc["spans"]]
    assert len(tdoc["trace_trees"]) == len(jdoc["trace_trees"]) == 1
    assert [p is None for p in tpaths] == [p is None for p in jpaths] == \
        [False, True, False, False]
    assert [os.path.basename(os.path.dirname(p)) for p in tpaths if p] == \
        ["001-crash", "002-watchdog", "003-crash"]


def test_flight_triggers(tmp_path):
    from mx_rcnn_tpu_torch.analysis import sanitizer

    store = t_ts.TimeSeriesStore(8)
    rec = t_flight.FlightRecorder(store, str(tmp_path), min_gap_s=0.0)
    prev_hook = sys.excepthook
    chained = []
    sys.excepthook = lambda *a: chained.append(a[0])
    try:
        rec.arm(signals=False)
        sys.excepthook(ValueError, ValueError("x"), None)   # crash
        assert chained == [ValueError]
        sanitizer._notify_trip({"lock": "L", "thread": "t"})  # watchdog
        rec.on_health_transition("OK", "WARN", {"firing": ["a"]})
        rec.on_health_transition("WARN", "CRITICAL", {"firing": ["b"]})
        t_flight.set_active(rec)
        assert t_flight.trigger("manual") is not None
    finally:
        rec.disarm()
        t_flight.set_active(None)
        sys.excepthook = prev_hook
    reasons = sorted(os.listdir(tmp_path / "flight"))
    assert reasons == ["001-crash", "002-watchdog", "003-health-critical",
                       "004-manual"]
    assert t_flight.trigger("none") is None


def test_sigterm_trigger_chains_to_the_previous_handler(tmp_path):
    """The flight recorder's SIGTERM handler sets its flag and calls the
    handler it replaced (a training CLI's stop flag), and its worker
    writes the dump; disarm puts the previous handler back."""
    stop = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    try:
        rec = t_flight.FlightRecorder(t_ts.TimeSeriesStore(8),
                                      str(tmp_path))
        rec.arm(signals=True, excepthook=False, watchdog=False)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not rec.dumps and time.monotonic() < deadline:
            time.sleep(0.01)
        assert stop.is_set()
        assert [os.path.basename(os.path.dirname(p)) for p in rec.dumps] \
            == ["001-sigterm"]
        rec.disarm()
        os.kill(os.getpid(), signal.SIGTERM)   # the stop flag's again
    finally:
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# collector
# ---------------------------------------------------------------------------

def _collect(metrics_mod, collect_mod, url, down_url):
    r1, r2 = metrics_mod.Registry(), metrics_mod.Registry()
    r1.inc("serve.served", 10)
    r1.set_gauge("ready", 2.0)
    r1.observe("lat", 10.0)
    r2.inc("serve.served", 5)
    r2.set_gauge("ready", 1.0)
    r2.observe("lat", 500.0)
    col = collect_mod.Collector([
        collect_mod.RegistrySource("a", r1, labels={"zone": "x"}),
        collect_mod.RegistrySource("b", lambda: (r2, {"generation": 2})),
        collect_mod.RegistrySource("gone", lambda: None),
        collect_mod.HttpSource("http", url),
        collect_mod.HttpSource("down", down_url, timeout_s=1.0)],
        clock=lambda: 5.0)
    col.add_gauge_fn(lambda: {"obs.skew_ms.max": 1.5})
    view = col.collect()
    return view, collect_mod.view_to_snapshot(view)


def test_collector_merge_equals_jax_with_a_real_and_a_down_source():
    reg = t_metrics.Registry()
    reg.inc("train.steps", 4)
    reg.set_gauge("ready", 3.0)
    srv = t_metrics.start_metrics_server(reg, port=0)
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        down = "127.0.0.1:%d" % s.getsockname()[1]
    try:
        url = "%s:%d" % srv.server_address[:2]
        jv, js = _collect(j_metrics, j_collect, url, down)
        tv, tsnap = _collect(t_metrics, t_collect, url, down)
    finally:
        srv.shutdown()
        srv.server_close()
    assert tv == jv and tsnap == js
    assert tv["up"] == 3 and tv["sources"]["down"] == {"up": False}
    assert tv["agg"]["counters"] == {"serve.served": 15, "train.steps": 4}
    assert tsnap["gauges"]["ready"] == 1.0


@pytest.mark.parametrize("urls", [
    "127.0.0.1:9090, worker=http://h:1/metrics, train=9137,",
    "", "9101", "a=b:1,c=http://d:2/x"])
def test_sources_from_urls_equal_jax(urls):
    t = [(s.name, s.url) for s in t_collect.sources_from_urls(urls)]
    j = [(s.name, s.url) for s in j_collect.sources_from_urls(urls)]
    assert t == j


def test_http_source_backs_off_after_a_failure():
    src = t_collect.HttpSource("x", "127.0.0.1:1", timeout_s=0.5,
                               backoff_base_s=60.0)
    assert src.scrape() is None and src.failures() == 1
    t0 = time.monotonic()
    assert src.scrape() is None and src.failures() == 1   # no socket
    assert time.monotonic() - t0 < 0.1


# ---------------------------------------------------------------------------
# the trace context: bytes, header, ring, skew, merge
# ---------------------------------------------------------------------------

_CTXS = [("abc", 0, 0, True), ("a.b-c_d:E", 0x1F, 2, False),
         ("f" * 64, (1 << 64) - 1, (1 << 16) - 1, True), ("1.2", 7, 1, True)]


@pytest.mark.parametrize("tid,parent,hop,sampled", _CTXS)
def test_trace_context_bytes_and_header_equal_jax(tid, parent, hop,
                                                  sampled):
    t = t_trace.TraceContext(tid, parent, hop, sampled)
    j = j_trace.TraceContext(tid, parent, hop, sampled)
    blob = t_trace.encode_ctx(t)
    assert blob == j_trace.encode_ctx(j)
    assert t_trace.decode_ctx(blob) == t
    header = t_trace.format_header(t)
    assert header == j_trace.format_header(j)
    assert t_trace.parse_header(header) == t
    assert t.child(9) == t_trace.TraceContext(tid, 9, hop + 1, sampled)


def _refusal(fn, arg):
    try:
        fn(arg)
    except ValueError as e:
        return str(e)
    return None


_BAD_BLOBS = [b"", b"\x01\x01", b"\x02" + bytes(12) + b"\x01a",
              bytes([1, 1, 0, 0]) + bytes(8) + b"\x00",
              bytes([1, 1, 0, 0]) + bytes(8) + b"\x41" + b"a" * 65,
              bytes([1, 1, 0, 0]) + bytes(8) + b"\x03ab",
              bytes([1, 1, 0, 0]) + bytes(8) + b"\x02a$",
              bytes([1, 1, 0, 0]) + bytes(8) + b"\x02\xff\xfe",
              bytes([1, 0xFF, 0, 0]) + bytes(8) + b"\x01a"]


@pytest.mark.parametrize("blob", _BAD_BLOBS)
def test_malformed_blobs_refused_as_in_jax(blob):
    assert _refusal(t_trace.decode_ctx, blob) == \
        _refusal(j_trace.decode_ctx, blob)


_BAD_HEADERS = ["v2;id=abc;parent=1;hop=0;s=1", "garbage",
                "v1;id=zz;parent=1;hop=0;s=1", "v1;id=abc;parent=x;hop=0;s=1",
                "v1;id=abc;parent=1;hop=0;s=2",
                "v1;id=abc;parent=1;hop=70000;s=1", "v1;id=abc;parent=1;s=1",
                "v1;id=abc;parent=1;hop=0;s=1;junk",
                "v1;id=;parent=1;hop=0;s=1",
                "v1;id=" + "a" * 65 + ";parent=1;hop=0;s=1", "v1;" + "x" * 300,
                None, " v1;id=abc;parent=1f;hop=2;s=1 "]


@pytest.mark.parametrize("header", _BAD_HEADERS)
def test_headers_refused_or_read_as_in_jax(header):
    got = _refusal(t_trace.parse_header, header)
    want = _refusal(j_trace.parse_header, header)
    assert got == want
    if want is None:
        assert vars_of(t_trace.parse_header(header)) == \
            vars_of(j_trace.parse_header(header))


def vars_of(ctx):
    return (ctx.trace_id, ctx.parent, ctx.hop, ctx.sampled)


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 1.0])
def test_sampling_and_retention_equal_jax(p):
    got = []
    for tr in (t_trace, j_trace):
        tr.configure_distributed(sample=p, ring=16, slow_pct=90.0)
        picks = [tr.sample_trace() is not None for _ in range(40)]
        keeps = [tr.retain_trace("SERVED", total_ms=float(i))
                 for i in range(60)]
        other = [tr.retain_trace(s) for s in ("SHED", "FAILED")]
        admin = tr.admin_trace() is not None
        got.append((picks, keeps, other, admin,
                    tr.correlation_id(1234.5678)))
        tr.reset_distributed()
    assert got[0] == got[1]


def _ring_and_skew(tr):
    ring = tr.SpanRing(cap=2, cap_spans=3)
    for t in ("a", "b", "c", "d", "e"):
        for i in range(4):
            ring.record(t, {"name": f"{t}{i}"})
        ring.close(t, keep=t != "c", meta=1)
    sk = tr.SkewEstimator(window=8)
    rng = np.random.RandomState(0)
    for i in range(20):
        t0 = 1000.0 * i
        rtt = float(rng.uniform(100, 2000))
        t1 = t0 + rtt / 2 + 5000.0
        sk.note("agent", t0, t1, t1 + 50.0, t0 + rtt + 50.0)
    return ring.trees(), ring.dropped, ring.open_count(), sk.gauges()


def test_span_ring_and_skew_equal_jax():
    assert _ring_and_skew(t_trace) == _ring_and_skew(j_trace)


def test_fleet_merge_equals_jax(tmp_path):
    local = [{"trace": "t1", "spans": [
        {"name": "req", "span": 1, "parent": 0, "ts": 100.0, "dur": 50.0,
         "host": "head", "hop": 0}]}]
    remote = {"agent": [{"trace": "t1", "spans": [
        {"name": "agent.request", "span": 2, "parent": 1, "ts": 5095.0,
         "dur": 30.0, "host": "agent", "hop": 1, "args": {"k": 1}},
        {"name": "inner", "span": 3, "parent": 2, "ts": 5090.0, "dur": 5.0,
         "host": "agent", "hop": 1}]}]}
    t = t_trace.merge_fleet_trace(local, remote, {"agent": 5.0},
                                  str(tmp_path / "t.json"))
    j = j_trace.merge_fleet_trace(local, remote, {"agent": 5.0},
                                  str(tmp_path / "j.json"))
    assert t == j and t["metadata"]["clamped"] > 0
    assert open(tmp_path / "t.json").read() == \
        open(tmp_path / "j.json").read()
    assert t_trace.tree_complete(t["traces"]["t1"])
    assert t_trace.tree_monotonic(t["traces"]["t1"])


def test_every_terminal_transition_records_one_terminal_span():
    from mx_rcnn_tpu_torch.serve.queue import ServeRequest

    t_trace.configure_distributed(sample=1.0, ring=64, slow_pct=0.0)
    for state in ("served", "shed", "expired", "failed"):
        ctx = t_trace.TraceContext(f"t.{state}",
                                   parent=t_trace.new_span_id())
        req = ServeRequest(np.zeros((2, 2, 3), np.float32),
                           np.array([2, 2, 1], np.float32), (2, 2), None,
                           time.monotonic())
        req.tctx = ctx
        assert req._finish(state)
        assert not req._finish(state)
        t_trace.close_trace(ctx, keep=True, state=state)
        names = [s["name"] for s in t_trace.kept_trees()[-1]["spans"]]
        assert names.count(f"terminal.{state}") == 1


# ---------------------------------------------------------------------------
# the serving front end with the plane on
# ---------------------------------------------------------------------------

def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_traces_requests_and_reports_health(tmp_path):
    """``tools/serve.py``'s session over a stub device: a traced request
    is kept with one terminal span under its root, a malformed header is
    a 400, ``/metrics`` carries the registry and the time series and
    ``/healthz`` the verdict (503 once CRITICAL)."""
    import base64

    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.serve.server import make_server
    from mx_rcnn_tpu_torch.tools import loadgen
    from mx_rcnn_tpu_torch.tools import serve as serve_tool

    cfg = generate_config(
        "tiny", "synthetic", bucket__scale=64, bucket__max_size=96,
        bucket__shapes=((64, 96), (96, 64)), serve__batch_size=2,
        obs__enabled=True, obs__trace=True, obs__timeseries=True,
        obs__health=True, obs__flight=True, obs__sample_interval_s=0.05,
        obs__run_dir=str(tmp_path), obs__trace_slow_pct=0.0)
    sess, metrics = serve_tool.open_obs(cfg)
    assert metrics.registry is t_metrics.registry()
    eng = ServingEngine(Predictor(build_model(cfg, device="cpu"), cfg, "cpu"),
                        cfg, metrics=metrics,
                        run_fn=loadgen.make_stub_run_fn(cfg, 2.0))
    serve_tool.watch_engine(sess, eng)
    srv = make_server(eng, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    img = loadgen.synthetic_images(cfg, 1)[0]
    body = {"pixels_b64": base64.b64encode(img.tobytes()).decode(),
            "shape": list(img.shape)}
    try:
        st, _ = _post(base + "/detect", body,
                      {"X-MXR-Trace": "v1;id=7.1;parent=0;hop=0;s=1"})
        assert st == 200
        assert _post(base + "/detect", body,
                     {"X-MXR-Trace": "v1;id=zz;parent=0;hop=0;s=1"})[0] == 400
        assert _post(base + "/detect", body)[0] == 200
        tree = [t for t in t_trace.kept_trees() if t["trace"] == "7.1"]
        spans = tree[0]["spans"]
        names = sorted(s["name"] for s in spans)
        assert names == ["serve.compute", "serve.lane_wait",
                         "serve.request", "terminal.served"]
        assert t_trace.tree_complete(spans)
        time.sleep(0.2)
        with urllib.request.urlopen(base + "/metrics") as r:
            snap = json.loads(r.read())
        assert snap["registry"]["counters"]["serve.served"] == 2
        assert snap["timeseries"]["samples"] >= 2
        with urllib.request.urlopen(base + "/healthz") as r:
            h = json.loads(r.read())
        assert h["ok"] and h["health"]["verdict"] == "OK"
        sess.health.rules.append(t_health.Rule(
            "always", "serve.served", "delta", ">=", 0.0,
            severity=t_health.CRITICAL, for_samples=1))
        sess.health._state["always"] = t_health._RuleState()
        deadline = time.monotonic() + 10
        while sess.health.verdict != "CRITICAL" and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        try:
            urllib.request.urlopen(base + "/healthz")
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
        assert status == 503
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()
        serve_tool.close_obs(sess, eng)
    run = os.path.join(sess.record.dir)
    assert json.load(open(os.path.join(run, "summary.json")))["value"] == 2
    dumps = os.listdir(os.path.join(run, "flight"))
    assert dumps == ["001-health-critical"]
    flight = json.load(open(os.path.join(run, "flight", dumps[0],
                                         "flight.json")))
    assert flight["context"]["engine"]["batch_size"] == 2
    assert t_trace.ring() is None


def test_train_cli_sigterm_leaves_flight_dump_and_interrupt(tmp_path):
    """The training CLI with the plane and the strict sanitizer on: a
    SIGTERM mid-epoch leaves the flight dump and the step-exact
    interrupt checkpoint, the run record closes, the sanitizer is
    clean."""
    env = dict(os.environ, MXRCNN_THREAD_SANITIZER="strict")
    argv = [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train",
            "--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
            "--synthetic", "8", "--batch_images", "2", "--frequent", "1",
            "--end_epoch", "3", "--prefix", str(tmp_path / "m"),
            "--set", "bucket__scale=64", "--set", "bucket__max_size=96",
            "--set", "bucket__shapes=((64, 96), (96, 64))",
            "--set", "obs__enabled=true", "--set", "obs__trace=true",
            "--set", "obs__timeseries=true", "--set", "obs__flight=true",
            "--set", f"obs__run_dir={tmp_path / 'runs'}"]
    proc = subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("Epoch[1] Batch [2]"):
            proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=120) == 0
    from mx_rcnn_tpu_torch.utils.checkpoint import (interrupt_path,
                                                    read_manifest)

    manifest = read_manifest(interrupt_path(str(tmp_path / "m")))
    run = os.path.join(tmp_path, "runs", os.listdir(tmp_path / "runs")[0])
    summary = json.load(open(os.path.join(run, "summary.json")))
    assert manifest["kind"] == "interrupt"
    assert summary["steps"] == manifest["step"] and summary["steps"] > 10
    assert summary["obs_failures"] == []
    events = [json.loads(x)["event"]
              for x in open(os.path.join(run, "events.jsonl"))]
    assert "interrupt" in events and events[-1] == "run_finish"
    flight = os.listdir(os.path.join(run, "flight"))
    assert flight == ["001-sigterm"]
    report = [x for x in lines if x.startswith("LOCKSAN_REPORT ")]
    assert len(report) == 1
    rep = json.loads(report[0].split(" ", 1)[1])
    assert rep["strict"] and rep["locks_wrapped"] > 0
    assert rep["inversions"] == [] and rep["watchdog_trips"] == []


def test_each_rank_of_a_data_parallel_run_writes_its_own_record(tmp_path):
    """``--num_devices 2``: each rank process opens its own session and
    run record (the launcher none), and both count the same steps."""
    from mx_rcnn_tpu_torch.tools import train as train_cli

    train_cli.main([
        "--device", "cpu", "--network", "tiny", "--dataset", "synthetic",
        "--synthetic", "4", "--batch_images", "1", "--num_devices", "2",
        "--end_epoch", "1", "--frequent", "1",
        "--set", "bucket__scale=64", "--set", "bucket__max_size=96",
        "--set", "bucket__shapes=((64, 96), (96, 64))",
        "--set", "obs__enabled=true",
        "--set", f"obs__run_dir={tmp_path / 'runs'}"])
    runs = sorted(os.listdir(tmp_path / "runs"))
    assert len(runs) == 2 and len({r.rsplit("-", 1)[1] for r in runs}) == 2
    steps = []
    for r in runs:
        summary = json.load(open(tmp_path / "runs" / r / "summary.json"))
        assert summary["obs_failures"] == []
        steps.append(summary["steps"])
    assert steps[0] == steps[1] == 4


def test_obs_smoke_scrapes_an_elastic_shaped_registry(tmp_path, capsys):
    """``tools/obs.py smoke``'s HTTP source is the JAX smoke's
    elastic-shaped registry (``mx_rcnn_tpu/tools/obs.py``): a source
    ``elastic-0`` in the merged view whose gauges are ones that
    ``ft/elastic.py — ElasticController.mark_applied`` publishes."""
    from mx_rcnn_tpu_torch.ft.elastic import ElasticController, Topology
    from mx_rcnn_tpu_torch.tools import obs as obs_cli

    try:
        rc = obs_cli.main(["smoke", "--device", "cpu", "--check",
                           "--duration_s", "3", "--workdir", str(tmp_path)])
        line = next(ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("HEALTH_SMOKE "))
        ev = json.loads(line[len("HEALTH_SMOKE "):])
        t_metrics.registry().reset()
        ElasticController(generate_config("tiny", "synthetic"),
                          str(tmp_path / "run"), install_signal=False
                          ).mark_applied(Topology(1, 1))
        published = set(t_metrics.registry().snapshot()["gauges"])
    finally:
        t_metrics.registry().reset()
    assert rc == 0, ev["problems"]
    assert ev["sources"] == ["elastic-0", "replica-0", "replica-1", "router"]
    assert ev["elastic_gauges"] == ["elastic.generation",
                                    "elastic.num_devices"]
    assert set(ev["elastic_gauges"]) <= published
