"""The cross-host tier across real processes, on the CPU.

``tools/agent.py`` processes started by ``tools/crosshost.py — AgentProc``
on ports they bind themselves (``--port 0``, read off the ready line):
an agent of the tiny model joining from a pulled store and serving the
port's in-process engine's bits; two stand-in agents behind the router
with the live scheduler, one SIGKILLed mid-burst (nothing lost, every
request served within its deadline, the survivor grown without operator
input); the bulk plane over two content-stand-in agents, an aborted and
resumed run byte-identical to its control; and ``tools/trace.py --check
--smoke``'s trees across the processes.  The entry point refuses a card
it does not have.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.core.tester import Predictor
from mx_rcnn_tpu_torch.data.image import prepare_image
from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
from mx_rcnn_tpu_torch.serve.agent import make_store_server
from mx_rcnn_tpu_torch.serve.engine import ServingEngine
from mx_rcnn_tpu_torch.serve.export import export_serve_programs
from mx_rcnn_tpu_torch.serve.remote import RemoteEngine
from mx_rcnn_tpu_torch.tools import agent as agent_cli
from mx_rcnn_tpu_torch.tools import crosshost
from mx_rcnn_tpu_torch.tools import trace as trace_cli
from mx_rcnn_tpu_torch.tools.loadgen import _smoke_overrides

torch.set_num_threads(1)

_AGENT_OVER = dict(_smoke_overrides())


def _cfg(**kw):
    return generate_config("tiny", "synthetic", **dict(_AGENT_OVER, **kw))


def _ch_over(cfg):
    return {"connections": 2, "pipeline_depth": 4 * cfg.serve.batch_size,
            "scrape_interval_s": 0.2, "io_timeout_s": 30.0}


def test_agent_cli_refuses_a_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        agent_cli.main(["--stub_ms", "0"])
    assert agent_cli.parse_args([]).device == "cuda"
    assert agent_cli.parse_args([]).port == 0


def test_an_agent_joins_from_the_pulled_store_and_serves_its_bits(tmp_path):
    cfg = _cfg(serve__max_delay_ms=20.0)
    pred = Predictor(build_model(cfg, "cpu", seed=5), cfg, "cpu")
    store = str(tmp_path / "store")
    export_serve_programs(pred, cfg, store, bundle_variables=True)
    srv = make_store_server(store)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    # one intra-op thread here and in the agent: the CPU's fp32 sums
    # follow the thread count, and the join holds the store's digests
    a = crosshost.AgentProc(
        str(tmp_path), "join", _AGENT_OVER, device="cpu",
        env={"OMP_NUM_THREADS": "1"},
        store_url=f"http://127.0.0.1:{srv.server_address[1]}",
        export_dir=str(tmp_path / "pulled"))
    local = ServingEngine(pred, cfg)
    try:
        ready = a.wait_ready(120)
        assert ready["port"] > 0 and ready["replicas"] == 1
        assert ready["kernel_builds_after_warm"] == 0
        pull = ready["store_pull"]
        with srv.stats_lock:
            reqs = list(srv.requests)
        assert pull["files"] == len(srv.index) == len(reqs)
        assert not pull["refused"] and not any(r["start"] for r in reqs)
        eng = RemoteEngine("t-join", a.url, cfg)
        try:
            for i in range(2):
                rng = np.random.RandomState(40 + i)
                hw = (128, 160) if i == 0 else (160, 128)
                img = rng.randint(0, 256, size=(*hw, 3), dtype=np.uint8)
                canvas, info, b = prepare_image(img, cfg)
                want = local.submit_prepared(canvas, info, b,
                                             timeout_ms=0).wait(60.0)
                got = eng.submit_prepared(canvas, info, b,
                                          timeout_ms=0).wait(60.0)
                assert sorted(got) == sorted(want)
                for c in want:
                    assert got[c].tobytes() == want[c].tobytes(), (i, c)
        finally:
            eng.close()
        health = crosshost._healthz(a.url)
        assert health["kernel_builds_after_warm"] == 0
        assert health["export_root"] == str(tmp_path / "pulled")
    finally:
        a.kill()
        local.close()
        srv.shutdown()
        srv.server_close()


def test_host_kill_under_the_live_scheduler(tmp_path):
    cfg = _cfg()
    agents = [crosshost.AgentProc(str(tmp_path), f"kill-{i}", _AGENT_OVER,
                                  device="cpu", stub_ms=20.0)
              for i in range(2)]
    problems = []
    leg = crosshost.host_kill_leg(
        cfg, _ch_over(cfg), agents, crosshost._prepared_set(cfg, 8),
        burst_s=4.0, concurrency=4 * cfg.serve.batch_size * 2,
        timeout_ms=20_000.0, problems=problems, restore_timeout_s=30.0)
    assert problems == [], leg
    assert leg["lost"] == 0 and leg["ejects"] >= 1
    assert leg["served_after_kill"] > 0
    assert leg["survivor_builds_after_warm"] == 0
    assert any(a["action"] == "add" for a in leg["scheduler_actions"])
    # every request of the burst is in the record: its outcome, and each
    # dispatch's replica, times and state; the dead host's last ones
    # rerouted to the survivor
    reqs = leg["requests"]
    assert len(reqs) == sum(leg["client"].values())
    assert 0 < leg["kill_at_s"] < 4.0
    for r in reqs:
        assert r["t"] <= r["end"]
        ds = r["dispatches"]
        assert all(d[0] in (0, 1) for d in ds)
        assert all(ds[i][2] <= ds[i + 1][1] for i in range(len(ds) - 1))
        if r["outcome"] == "ok":
            assert ds and ds[-1][3] == "served"
    assert any(len(r["dispatches"]) > 1 and r["dispatches"][0][0] == 1
               and r["dispatches"][-1][0] == 0 for r in reqs)


def test_bulk_union_across_two_hosts_is_byte_identical(tmp_path):
    cfg = _cfg()
    agents = [crosshost.AgentProc(str(tmp_path), f"bulk-{i}", _AGENT_OVER,
                                  device="cpu", stub_ms=0.0, stub="content")
              for i in range(2)]
    problems = []
    leg = crosshost._bulk_leg(cfg, str(tmp_path), agents, _ch_over(cfg),
                              problems)
    assert problems == [], leg
    assert leg["byte_identical"] and leg["aborted_mid_run"]
    assert leg["resumed_shards"] > 0


def test_trace_check_smoke_merges_one_tree_across_the_processes(tmp_path):
    """``tools/trace.py --check --smoke``: every kept tree complete and
    monotonic after the skew merge, spans from both processes, the
    SIGKILL reroute one two-attempt trace served on the survivor.  The
    traced-against-untraced A/B is recorded; its 2% budget is not judged
    here, where other tests share the cores."""
    out = str(tmp_path / "trace.json")
    trace_cli.main(["--check", "--smoke", "--device", "cpu", "--workdir",
                    str(tmp_path), "--out", out])
    with open(out) as f:
        rec = json.load(f)
    burst = rec["traced_burst"]
    assert burst["traces_kept"] > 0 and burst["client"]["ok"] > 0
    assert burst["complete_pct"] == 100.0
    assert burst["monotonic_pct"] == 100.0
    assert burst["cross_host_traces"] > 0 and burst["offsets_ms"]
    kill = rec["sigkill_reroute"]
    assert kill["rerouted_traces"] > 0 and kill["served_after_reroute"] > 0
    assert kill["all_complete"]
    assert "overhead_pct" in rec["overhead"]
    assert os.path.exists(burst["chrome_trace"])


# ---- standing alone ------------------------------------------------------------

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
PKG = REPO / "mx_rcnn_tpu_torch"
_TIER = [PKG / rel for rel in (
    "serve/remote.py", "serve/agent.py", "serve/scheduler.py",
    "tools/agent.py", "tools/crosshost.py", "tools/wire_bench.py",
    "tools/trace.py", "tools/obs.py", "netio.py", "config.py")]
_FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "mx_rcnn_tpu")


@pytest.mark.parametrize("path", _TIER, ids=lambda p: str(p.relative_to(PKG)))
def test_tier_modules_import_nothing_of_jax(path):
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & set(_FORBIDDEN)


def test_tier_entry_points_refuse_to_drop_to_the_cpu(tmp_path):
    """The agent, the rigs and the obs smoke raise without a card unless
    asked for the CPU, before they start a process or write a file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from mx_rcnn_tpu_torch.serve.agent import ReplicaAgent
    from mx_rcnn_tpu_torch.tools import loadgen
    from mx_rcnn_tpu_torch.tools import obs as obs_cli
    from mx_rcnn_tpu_torch.tools.loadgen import make_stub_run_fn

    work = tmp_path / "w"
    cfg = _cfg()
    calls = [
        lambda: loadgen.main(["--crosshost_smoke", "--workdir", str(work)]),
        lambda: loadgen.main(["--wire_smoke", "--workdir", str(work)]),
        lambda: trace_cli.main(["--check", "--smoke", "--workdir",
                                str(work)]),
        lambda: obs_cli.main(["smoke", "--workdir", str(work)]),
        lambda: ReplicaAgent(cfg, run_fn_factory=(
            lambda rid: make_stub_run_fn(cfg, 0.0))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not work.exists()


# ---- tools/obs.py ----------------------------------------------------------------

def test_obs_smoke_kill_verdicts_and_flight_record(tmp_path):
    """``tools/obs.py smoke --device cpu --check``: the merged view over
    two stand-in replicas, the router and a registry scraped over HTTP;
    CRITICAL at the kill and OK after the relaunch; a flight record
    naming the ejected replica; ``check`` OK over the healed fleet."""
    from mx_rcnn_tpu_torch.obs.metrics import registry
    from mx_rcnn_tpu_torch.tools import obs as obs_cli

    try:
        rc = obs_cli.main(["smoke", "--device", "cpu", "--check",
                           "--duration_s", "3", "--workdir",
                           str(tmp_path)])
    finally:
        registry().reset()
    assert rc == 0


def test_obs_check_and_dump_over_http(tmp_path, capsys):
    from mx_rcnn_tpu_torch.obs.metrics import Registry, start_metrics_server
    from mx_rcnn_tpu_torch.tools import obs as obs_cli

    reg = Registry()
    reg.inc("serve.submitted", 4)
    reg.inc("serve.served", 4)
    srv = start_metrics_server(reg, port=0)
    url = "http://%s:%d/metrics" % srv.server_address[:2]
    try:
        assert obs_cli.main(["check", "--url", f"peer={url}", "--samples",
                             "2", "--interval_s", "0"]) == 0
        verdict = json.loads(capsys.readouterr().out)
        assert verdict["verdict"] == "OK" and verdict["sources_up"] == 1
        out = str(tmp_path / "flight.json")
        assert obs_cli.main(["dump", "--url", url, "--out", out]) == 0
        with open(out) as f:
            rec = json.load(f)
        assert rec["schema"] == "mx_rcnn_tpu.flight/2"
        assert rec["view"]["up"] == 1
        assert obs_cli.main(["watch", "--url", url, "--iterations",
                             "1"]) == 0
    finally:
        srv.shutdown()
        srv.server_close()
    with socket_closed() as dead:
        assert obs_cli.main(["check", "--url", dead, "--samples", "1",
                             "--interval_s", "0"]) == obs_cli.EXIT_NO_SOURCE


class socket_closed:
    """A URL whose port is bound and never listens: every scrape is
    refused."""

    def __enter__(self):
        import socket

        self._s = socket.socket()
        self._s.bind(("127.0.0.1", 0))
        return "http://127.0.0.1:%d/metrics" % self._s.getsockname()[1]

    def __exit__(self, *exc):
        self._s.close()
        return False
