"""The port's wire fuzzer (``mx_rcnn_tpu_torch/analysis/wirefuzz.py`` and
``tools/wirefuzz.py``) held against the JAX package's on the CPU.

Every corpus comes out byte for byte and name for name as the JAX one
at the same seed; the codec leg's, the agent leg's and the planted
arms' per-case outcomes equal the JAX legs' (read through each tool's
``summarize``; timings are not compared); the allocation guard and
``summarize`` behave as the JAX ones do; the httpsource and proxy legs
end ok with every frame in one terminal state.  The legs aimed at
running agents (``target`` / ``urls``, the parameters the card phase
uses) are driven here against stand-in agents.
"""

import json
import threading

import numpy as np
import pytest

from mx_rcnn_tpu.analysis import wirefuzz as jwf
from mx_rcnn_tpu.tools import wirefuzz as jtw
from mx_rcnn_tpu_torch.analysis import wirefuzz as twf
from mx_rcnn_tpu_torch.tools import wirefuzz as ttw

SEEDS = (0, 16, 37)


def _rows(muts):
    return [(m.name, m.data, m.must_reject) for m in muts]


CORPORA = [
    ("prepared", lambda mod, s: mod.prepared_corpus(s)),
    ("prepared_40x24", lambda mod, s: mod.prepared_corpus(s, (40, 24))),
    ("prepared_8x12", lambda mod, s: mod.prepared_corpus(s, (8, 12))),
    ("traced_prepared", lambda mod, s: mod.traced_prepared_corpus(s)),
    ("traced_result", lambda mod, s: mod.traced_result_corpus(s)),
    ("result", lambda mod, s: mod.result_corpus(s)),
    ("source", lambda mod, s: mod.source_corpus(s)),
    ("envelope", lambda mod, s: mod.envelope_corpus(s)),
    ("result_envelope", lambda mod, s: mod.result_envelope_corpus(s)),
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,make", CORPORA, ids=[c[0] for c in CORPORA])
def test_corpus_equals_jax(name, make, seed):
    want = make(jtw, seed)
    got = make(ttw, seed)
    assert _rows(got) == _rows(want)
    assert twf.Mutator.fingerprint(got) == jwf.Mutator.fingerprint(want)
    assert any(m.must_reject for m in got)


@pytest.mark.parametrize("seed", SEEDS)
def test_mutator_equals_jax(seed):
    frame = b"TEST" + (4).to_bytes(4, "little") + b"\0\0pay!"
    spans, benign = [("magic", 0, 4), ("n", 4, 8)], [("pad", 8, 10)]
    got = twf.Mutator(seed).corpus(frame, 10, spans, benign)
    want = jwf.Mutator(seed).corpus(frame, 10, spans, benign)
    assert _rows(got) == _rows(want)
    assert repr(got[0]) == repr(want[0])
    assert (twf.REJECTED, twf.ACCEPTED_VALID, twf.ACCEPTED_MALFORMED,
            twf.CRASHED, twf.HUNG, twf.ALLOC, twf.VIOLATIONS) == \
        (jwf.REJECTED, jwf.ACCEPTED_VALID, jwf.ACCEPTED_MALFORMED,
         jwf.CRASHED, jwf.HUNG, jwf.ALLOC, jwf.VIOLATIONS)
    assert ttw.REQ_REJECT_SPANS == jtw.REQ_REJECT_SPANS
    assert ttw.REQ2_BENIGN_SPANS == jtw.REQ2_BENIGN_SPANS
    assert ttw.ENV_REJECT_SPANS == jtw.ENV_REJECT_SPANS


def _captured(mod, monkeypatch):
    """Every result list ``mod``'s legs hand to ``summarize``."""
    seen = []
    real = mod.summarize

    def summarize(results):
        results = list(results)
        seen.append([(r["case"], r["outcome"]) for r in results])
        return real(results)

    monkeypatch.setattr(mod, "summarize", summarize)
    return seen


def test_codec_leg_outcomes_equal_jax(monkeypatch):
    jseen = _captured(jtw, monkeypatch)
    tseen = _captured(ttw, monkeypatch)
    want = jtw.leg_codec(16)
    got = ttw.leg_codec(16)
    assert tseen == jseen
    assert got == want
    assert got["cases"] == 418 and got["violations"] == []
    assert got["outcomes"] == {"rejected": 313, "accepted_valid": 105}
    assert ttw.leg_codec(16, smoke=True) == jtw.leg_codec(16, smoke=True)


def test_planted_arms_equal_jax(monkeypatch):
    jseen = _captured(jtw, monkeypatch)
    tseen = _captured(ttw, monkeypatch)
    want = jtw.leg_planted(16)
    got = ttw.leg_planted(16)
    assert len(tseen) == 3 and tseen == jseen
    assert got == want
    assert got["ok"] and got["uncapped"]["alloc_flagged"]


def test_alloc_guard_equals_jax():
    calls = [("zeros", (16,), {}), ("zeros", ((1 << 20, 8),), {}),
             ("empty", ((64, 64), np.float32), {}),
             ("ones", (), {"shape": (1 << 22,), "dtype": np.uint8}),
             ("full", ((1 << 21,), 1.0, np.float64), {}),
             ("frombuffer", (b"\0" * 64, np.uint8), {}),
             ("frombuffer", (b"\0" * 64,), {"dtype": np.float32,
                                            "count": 1 << 30}),
             ("zeros", ("bad",), {})]
    for mod in (twf, jwf):
        outcomes = []
        with mod.alloc_guard(cap_bytes=1 << 20):
            for fname, args, kw in calls:
                try:
                    outcomes.append(getattr(np, fname)(*args, **kw).nbytes)
                except mod.AllocationCapExceeded:
                    outcomes.append("cap")
                except (TypeError, ValueError) as e:
                    outcomes.append(type(e).__name__)
        # restored on the way out
        assert np.zeros(1 << 22, np.uint8).nbytes == 1 << 22
        if mod is twf:
            got = outcomes
    assert got == outcomes
    assert got == [128, "cap", 16384, "cap", "cap", 64, "cap", "TypeError"]
    assert [twf._nbytes_of(f, a, k) for f, a, k in calls] == \
        [jwf._nbytes_of(f, a, k) for f, a, k in calls]


def test_run_case_and_summarize_equal_jax():
    def decode(buf):
        if len(buf) < 4:
            raise ValueError("short")
        if buf[0] == 0xff:
            raise KeyError("untyped")
        if buf[0] == 0xfe:
            np.zeros(1 << 40, np.uint8)
        return len(buf)

    cases = [b"", b"abcd", b"\xffabc", b"\xfeabc", b"xyzw"]
    for must in (True, False):
        got = [twf.run_case(decode, twf.Mutation(f"c{i}", c, must))
               for i, c in enumerate(cases)]
        want = [jwf.run_case(decode, jwf.Mutation(f"c{i}", c, must))
                for i, c in enumerate(cases)]
        assert got == want
        assert twf.summarize(got) == jwf.summarize(want)
        assert twf.summarize(iter(got)) == twf.summarize(got)
    res = [{"status": None, "error": "client-disconnect", "elapsed_s": 0.1},
           {"status": 413, "error": None, "elapsed_s": 0.1},
           {"status": 200, "error": None, "elapsed_s": 0.1},
           {"status": 500, "error": None, "elapsed_s": 0.1},
           {"status": None, "error": "timeout", "elapsed_s": 0.1},
           {"status": 400, "error": None, "elapsed_s": 99.0}]
    for must in (True, False):
        assert [twf.http_case_outcome(r, must, 15.0) for r in res] == \
            [jwf.http_case_outcome(r, must, 15.0) for r in res]


def test_agent_leg_outcomes_equal_jax(monkeypatch):
    jseen = _captured(jtw, monkeypatch)
    tseen = _captured(ttw, monkeypatch)
    want = jtw.leg_agent(16)
    got = ttw.leg_agent(16)
    assert tseen == jseen
    assert got["cases"] == want["cases"] == 136
    assert got["outcomes"] == want["outcomes"]
    assert got["violations"] == []
    assert ("http:trickle-past-deadline", "rejected") in tseen[0]


def test_agent_leg_aimed_at_a_running_agent(monkeypatch):
    """``target``: the leg leaves a running agent (its own 30 s body
    deadline) up, runs every case but the slow trickle, and serves the
    good frames at the agent's config."""
    cfg = ttw._mk_cfg()
    ag, srv, host, port = ttw._start_agent(cfg)
    try:
        seen = _captured(ttw, monkeypatch)
        got = ttw.leg_agent(16, smoke=True, target=(host, port, cfg))
        assert ttw._healthz_ok(host, port)
        batches = ag.healthz()["engine_batches"]
    finally:
        ttw._stop_agent(ag, srv)
    monkeypatch.undo()
    jseen = _captured(jtw, monkeypatch)
    jtw.leg_agent(16, smoke=True)
    want = [r for r in jseen[0] if r[0] != "http:trickle-past-deadline"]
    assert seen[0] == want
    assert got["violations"] == [] and got["target"].endswith(str(port))
    # the good frames, and nothing the leg rejected, reached the engine:
    # 6 frames, two of them in one envelope
    assert 5 <= batches <= 6


def test_httpsource_leg_ends_ok():
    got = ttw.leg_httpsource(16)
    assert got["cases"] == 4 and got["violations"] == []
    assert got["outcomes"] == {"accepted_valid": 1, "rejected": 3}


def _terminal_ok(leg, n):
    assert leg["violations"] == [], leg["violations"]
    assert sum(leg["terminal"].values()) == n == leg["terminal"]["served"]
    assert set(leg["faults_applied"]) == {"pass", "truncate", "reset",
                                          "split", "delay", "blackhole"}


def test_proxy_leg_ends_ok():
    _terminal_ok(ttw.leg_proxy(16), 14)


def test_proxy_leg_aimed_at_running_agents():
    """``urls``, ``frames`` and ``want``: two running agents, the first
    behind the proxy; every frame served once with the detections the
    second agent gives it directly, and a wrong expectation flagged."""
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router

    cfg = ttw._mk_cfg()
    agents = [ttw._start_agent(cfg), ttw._start_agent(cfg)]
    urls = [f"http://{a[2]}:{a[3]}" for a in agents]
    try:
        rng = np.random.RandomState(3)
        frames = []
        for b in list(cfg.bucket.shapes) * 2:
            b = tuple(b)
            frames.append(((rng.rand(*b, 3) * 255.0).astype(np.float32),
                           np.array([b[0], b[1], 1.0], np.float32), b))
        router, feed = build_crosshost_router(cfg, urls[1:])
        try:
            want = [router.submit_prepared(*f, timeout_ms=0).wait(30.0)
                    for f in frames]
        finally:
            feed.close()
            router.close()
        # frame 0's expectation is wrong: the turns that carry it (0, 4,
        # 8, 12 of the 14) are flagged, every other frame matches
        want[0] = {c: v + 1.0 for c, v in want[0].items()}
        leg = ttw.leg_proxy(16, cfg=cfg, urls=urls, frames=frames,
                            want=want)
        assert sorted(v["case"] for v in leg["violations"]) == \
            ["delay-req0", "pass-req0", "pass-req0", "reset-req0"]
        assert {v["outcome"] for v in leg["violations"]} == {"crashed"}
        leg["violations"] = []
        _terminal_ok(leg, 14)
        assert all(ttw._healthz_ok(a[2], a[3]) for a in agents)
    finally:
        for a in agents:
            ttw._stop_agent(a[0], a[1])


def test_cli_writes_only_with_out(tmp_path, monkeypatch, capsys):
    doc = {"metric": "wirefuzz_violations", "value": 0, "seed": 5,
           "smoke": False, "corpus_cases": 3, "ok": True, "elapsed_s": 0.1,
           "legs": {"codec": {"violations": []}}, "planted": {"ok": True}}
    calls = []
    monkeypatch.setattr(ttw, "run", lambda seed, smoke: (
        calls.append((seed, smoke)), doc)[1])
    monkeypatch.chdir(tmp_path)
    assert ttw.main([]) == 0
    assert list(tmp_path.iterdir()) == []
    assert ttw.main(["--seed", "5", "--smoke", "--out", "r.json"]) == 0
    assert calls == [(16, False), (5, True)]
    assert json.loads((tmp_path / "r.json").read_text()) == doc
    brief = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert brief == {"metric": "wirefuzz_violations", "value": 0,
                     "corpus_cases": 3, "ok": True, "elapsed_s": 0.1,
                     "planted_ok": True}
    doc["ok"] = False
    assert ttw.main([]) == 1


def test_fault_proxy_modes_equal_jax():
    assert twf.FaultProxy.MODES == jwf.FaultProxy.MODES
    # the seeded default schedule draws the JAX proxy's modes
    got, want = [], []
    for mod, out in ((twf, got), (jwf, want)):
        p = mod.FaultProxy("127.0.0.1", 9, seed=7)
        try:
            out.extend(p.schedule(i) for i in range(12))
        finally:
            p.close()
    assert got == want
    assert threading.active_count() < 50
