"""The fleet's CLIs on the CPU: ``tools/fleet.py`` (``export``,
``serve`` on a free port, ``join_bench``), ``tools/bulk.py --protocol
kill_resume`` and ``tools/loadgen.py --fleet``, their flags' defaults
equal to the JAX CLIs' (read from the JAX sources).
"""

import ast
import base64
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.serve.export import MANIFEST_NAME, ExportStore
from mx_rcnn_tpu_torch.tools import fleet as fleet_tool
from mx_rcnn_tpu_torch.tools import loadgen

REPO = pathlib.Path(__file__).resolve().parents[1]

_CANVAS = dict(bucket__scale=128, bucket__max_size=160,
               bucket__shapes=((128, 160), (160, 128)),
               test__rpn_pre_nms_top_n=512, test__rpn_post_nms_top_n=64,
               serve__batch_size=2, serve__max_delay_ms=20.0)
_SETS = [a for k, v in _CANVAS.items() for a in ("--set", f"{k}={v}")]
# the store's digests hold across processes at one CPU thread count
_ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))


def _flag_defaults(path, func):
    """``{flag: default}`` of the ``add_argument`` calls inside ``func``
    of the module at ``path`` (literal defaults only)."""
    tree = ast.parse((REPO / path).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    out = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            d = kw.get("default")
            out[node.args[0].value] = (ast.literal_eval(d) if d is not None
                                       else None)
    return out


def test_fleet_flags_and_defaults_equal_jax():
    ours = _flag_defaults("mx_rcnn_tpu_torch/tools/loadgen.py", "parse_args")
    theirs = _flag_defaults("mx_rcnn_tpu/tools/loadgen.py", "main")
    for flag in ("--fleet", "--export_dir", "--fleet_bench", "--fleet_smoke",
                 "--fleet_sweep", "--stub_ms", "--join_network",
                 "--max_join_ratio", "--min_scaling", "--workdir"):
        assert ours[flag] == theirs[flag], flag
    ours = _flag_defaults("mx_rcnn_tpu_torch/tools/bulk.py", "parse_args")
    theirs = _flag_defaults("mx_rcnn_tpu/tools/bulk.py", "main")
    assert set(theirs) <= set(ours)
    assert {f: ours[f] for f in theirs} == theirs
    ours = _flag_defaults("mx_rcnn_tpu_torch/tools/fleet.py", "parse_args")
    theirs = _flag_defaults("mx_rcnn_tpu/tools/fleet.py", "parse_args")
    # the port's store holds no eval program and always verifies
    assert set(theirs) - set(ours) == {"--eval_batch", "--no_verify",
                                       "--no_warmup"}
    assert {f: ours[f] for f in set(theirs) & set(ours)} == \
        {f: theirs[f] for f in set(theirs) & set(ours)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _img(landscape=True, seed=0):
    rng = np.random.RandomState(seed)
    h, w = (128, 160) if landscape else (160, 128)
    return rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """``tools/fleet.py export`` in a process of its own."""
    root = str(tmp_path_factory.mktemp("fleet_store") / "store")
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.fleet", "export",
         "--device", "cpu", "--out", root] + _SETS,
        cwd=REPO, env=_ENV, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bit_equal"] and report["kernels"] == []
    return root, report


def test_export_writes_a_store_with_its_weights(store):
    root, report = store
    assert os.path.exists(os.path.join(root, MANIFEST_NAME))
    names = [p["name"] for p in report["programs"]]
    assert names == ["serve_fwd_128x160_b2", "serve_post",
                     "serve_fwd_160x128_b2", "variables.npz"]
    assert ExportStore(root).manifest()["variables"]["bytes"] > 0


def test_join_bench_from_the_store_builds_nothing(store, capsys):
    root, _ = store
    torch.set_num_threads(1)
    assert fleet_tool.main(["join_bench", "--mode", "export", "--device",
                            "cpu", "--export_dir", root] + _SETS) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["mode"] == "export" and doc["kernel_builds"] == 0
    assert doc["programs"] == 3 and doc["overhead_s"] > 0
    assert len(doc["first_s"]) == len(doc["second_s"]) == 2
    assert doc["device"] == "cpu"
    assert fleet_tool.main(["join_bench", "--mode", "trace", "--device",
                            "cpu"] + _SETS) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["mode"] == "trace" and doc["kernel_builds"] == 0


def test_fleet_serve_answers_detect_and_healthz_and_exits_on_sigint(store):
    root, _ = store
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.fleet", "serve",
         "--device", "cpu", "--replicas", "2", "--export_dir", root,
         "--port", str(port)] + _SETS, cwd=REPO, env=_ENV,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        health = None
        while health is None and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read()
            try:
                health = _http(url + "/healthz")[1]
            except OSError:
                time.sleep(0.1)
        assert health["fleet"] and health["ready"] == 2
        assert [r["export_root"] for r in health["replicas"]] == [root] * 2
        for s in range(4):
            img = _img(s % 2 == 0, s)
            status, body = _http(url + "/detect", {
                "pixels_b64": base64.b64encode(img.tobytes()).decode(),
                "shape": list(img.shape)})
            assert status == 200 and body["batch_rows"] == 1
        metrics = _http(url + "/metrics")[1]
        assert metrics["counters"]["served"] == 4
        assert metrics["registry"]["counters"]["fleet.served"] == 4
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    assert rc == 0


def test_bulk_kill_resume_protocol_union_is_byte_equal(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.bulk", "--smoke",
         "--device", "cpu", "--num_images", "12", "--baseline_s", "1",
         "--root_path", str(tmp_path / "data"), "--workdir",
         str(tmp_path / "w"), "--set", "bulk__shard_batches=2", "--check"],
        cwd=REPO, env=_ENV, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "bulk_kill_resume" and rec["corpus_images"] == 12
    assert rec["shards"] == 3 and rec["kill"]["killed_by_signal"]
    assert rec["union_bit_identical"] and all(rec["checks"].values())
    ctrl, resume = rec["control"], rec["resume"]
    assert ctrl["bulk"]["lost"] == resume["bulk"]["lost"] == 0
    assert ctrl["kernel_builds_after_join"] == 0
    assert ctrl["replicas_ready"] == 2 and ctrl["join_kernel_builds"] == 0
    assert resume["bulk"]["resumed_shards"] == rec["kill"]["committed_shards"]
    assert ctrl["serve_baseline"]["client"]["ok"] > 0


def test_loadgen_through_a_two_replica_fleet(capsys):
    rc = loadgen.main(["--smoke", "--fleet", "2", "--device", "cpu",
                       "--duration", "2", "--check"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["fleet_replicas"] == 2 and rec["lost"] == 0
    assert rec["served"] > 0 and rec["ratio_vs_offline"] is None
