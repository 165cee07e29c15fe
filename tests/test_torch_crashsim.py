"""The port's crash simulator (``mx_rcnn_tpu_torch/analysis/crashsim.py``)
and its runner (``tools/crashsim.py``), held against the JAX package's on
the CPU.

The same hand-built op logs give the same crash states and ``simulate``
tallies in both; both recorders log the same ops for each package's
``_atomic_write`` of the same bytes; the bulk and snapshotter arms give
the JAX arms' counts; every real arm recovers or refuses every state on
the CPU, and both planted arms are flagged; the port's export store
commits through the shared ``_atomic_write`` with the pinned syscall
order (``tests/test_persistlint.py — test_export_store_commit_syscall_
order``); the CLI writes a record only where ``--out`` names a file and
runs on the card unless asked for the CPU.
"""

import builtins
import os

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.analysis import crashsim as j_cs
from mx_rcnn_tpu_torch.analysis import crashsim as t_cs

torch.set_num_threads(1)


def _ops(mod, root, case):
    """A hand-built op log of ``case`` in ``mod``'s ``Op``."""
    j = lambda *p: os.path.join(root, *p)  # noqa: E731
    Op = mod.Op
    if case == "unsynced_write":
        return [Op("write", path=j("f1"), data=b"AAAABBBB"),
                Op("fsync", path=j("f1"))]
    if case == "rename_dirfsync":
        return [Op("write", path=j("x.tmp"), data=b"D" * 8),
                Op("fsync", path=j("x.tmp")),
                Op("rename", path=j("x.tmp"), dst=j("x")),
                Op("dirfsync", path=root)]
    if case == "torn_publish":
        return [Op("write", path=j("x.tmp"), data=b"D" * 8),
                Op("rename", path=j("x.tmp"), dst=j("x"))]
    if case == "commit_no_barrier":
        return [Op("write", path=j("art"), data=b"A" * 8),
                Op("commit", ident="a")]
    if case == "two_sessions_and_unlink":
        # payload, manifest last, a second version, the old one unlinked;
        # a rewritten file's later snapshot supersedes its earlier one
        return [Op("write", path=j("p.tmp"), data=b"v1-payload"),
                Op("write", path=j("p.tmp"), data=b"v1-payload-more"),
                Op("fsync", path=j("p.tmp")),
                Op("rename", path=j("p.tmp"), dst=j("p")),
                Op("dirfsync", path=root),
                Op("write", path=j("m.tmp"), data=b'{"p": 1}'),
                Op("rename", path=j("m.tmp"), dst=j("manifest")),
                Op("commit", ident="a"),
                Op("write", path=j("q"), data=b"v2"),
                Op("unlink", path=j("p")),
                Op("dirfsync", path=root),
                Op("commit", ident="b")]
    raise KeyError(case)


CASES = ("unsynced_write", "rename_dirfsync", "torn_publish",
         "commit_no_barrier", "two_sessions_and_unlink")


def _states(mod, ops, root, cap=256):
    return [(s.point, s.fs, s.floor, s.decisions)
            for s in mod.crash_states(ops, root, cap)]


@pytest.mark.parametrize("case", CASES)
def test_crash_states_equal_jax(tmp_path, case):
    root = str(tmp_path)
    want = _states(j_cs, _ops(j_cs, root, case), root)
    got = _states(t_cs, _ops(t_cs, root, case), root)
    assert got == want and len(got) > 1
    # and under a cap, the same truncation and the same sentinels
    assert _states(t_cs, _ops(t_cs, root, case), root, cap=2) == \
        _states(j_cs, _ops(j_cs, root, case), root, cap=2)


def _recover(d):
    """Recovered when ``art``/``x``/``p`` holds a known payload, refused
    when none is there, corrupt otherwise."""
    known = {b"A" * 8: "a", b"D" * 8: "a", b"AAAABBBB": "a",
             b"v1-payload-more": "a", b"v2": "b"}
    for name in ("q", "p", "art", "x", "f1"):
        path = os.path.join(d, name)
        if os.path.exists(path):
            data = open(path, "rb").read()
            if data in known:
                return ("recovered", known[data])
            return ("corrupt", f"{name} holds {data!r}")
    return ("refused", "nothing there")


@pytest.mark.parametrize("case", CASES)
def test_simulate_tallies_equal_jax(tmp_path, case):
    root = str(tmp_path / "w")
    os.makedirs(root)
    want = j_cs.simulate(_ops(j_cs, root, case), root, _recover, ["a", "b"],
                         str(tmp_path / "js"))
    got = t_cs.simulate(_ops(t_cs, root, case), root, _recover, ["a", "b"],
                        str(tmp_path / "ts"))
    assert got == want


def test_recorders_log_the_same_ops_for_atomic_write(tmp_path):
    """Each package's recorder over its own ``_atomic_write`` of the same
    bytes: the same op kinds, paths and contents; arming is reversed."""
    from mx_rcnn_tpu.utils.checkpoint import _atomic_write as j_write
    from mx_rcnn_tpu_torch.utils.checkpoint import _atomic_write as t_write

    logs = []
    for mod, write, tag in ((j_cs, j_write, "j"), (t_cs, t_write, "t")):
        root = str(tmp_path / tag)
        os.makedirs(root)
        with mod.CrashRecorder(root) as rec:
            write(os.path.join(root, "a.ckpt"), b"payload")
            rec.mark_commit("a")
        assert not rec._armed and builtins.open is t_cs._RAW_OPEN
        logs.append([(op.kind, os.path.relpath(op.path, root)
                      if op.path else "", os.path.basename(op.dst),
                      op.data, op.ident) for op in rec.ops])
    assert logs[0] == logs[1]
    assert [k for k, *_ in logs[1]] == ["write", "fsync", "rename",
                                        "dirfsync", "commit"]
    assert logs[1][0][3] == b"payload"


def test_recorder_ignores_out_of_root_and_drop_modes(tmp_path):
    from mx_rcnn_tpu_torch.utils.checkpoint import _atomic_write

    root = str(tmp_path / "w")
    os.makedirs(root)
    outside = str(tmp_path / "elsewhere.ckpt")
    with t_cs.CrashRecorder(root, drop=("fsync", "dirfsync")) as rec:
        _atomic_write(outside, b"x")                      # not under root
        _atomic_write(os.path.join(root, "a.ckpt"), b"y")
        with open(os.path.join(root, "b.ckpt"), "wb") as f:
            f.write(b"from a test frame")                  # not the package
    assert [op.kind for op in rec.ops] == ["write", "rename"]
    assert all(op.path.startswith(root) for op in rec.ops)
    assert open(outside, "rb").read() == b"x"


def _counts(rep):
    return {k: rep[k] for k in ("ops", "crash_points", "states_total",
                                "states_unique", "recovered", "refused",
                                "capped_points", "idents")} | {
        "violations": len(rep["violations"])}


def test_bulk_arm_counts_equal_jax(tmp_path):
    from mx_rcnn_tpu.tools import crashsim as j_tool
    from mx_rcnn_tpu_torch.tools import crashsim as t_tool

    want = j_tool.run_bulk(str(tmp_path / "j"), max_states=64)
    got = t_tool.run_bulk(str(tmp_path / "t"), max_states=64)
    assert got["ok"] and _counts(got) == _counts(want)
    assert got["states_total"] > 20


@pytest.mark.parametrize("drop", [(), ("fsync", "dirfsync")])
def test_snapshotter_arm_counts_equal_jax(tmp_path, drop):
    """The port's TrainState stand-in through ``SyncSnapshotter``: the
    JAX arm's op log length and verdict tallies, clean without drops and
    flagged with the barriers dropped (``planted_nofsync``)."""
    from mx_rcnn_tpu.tools import crashsim as j_tool
    from mx_rcnn_tpu_torch.tools import crashsim as t_tool

    cap = 64 if not drop else 16
    want = j_tool.run_snapshotter(str(tmp_path / "j"), drop=drop,
                                  max_states=cap)
    got = t_tool.run_snapshotter(str(tmp_path / "t"), drop=drop,
                                 max_states=cap, device="cpu")
    assert _counts(got) == _counts(want)
    if drop:
        assert not got["ok"]
        assert any("durably committed" in v["problem"]
                   for v in got["violations"])
    else:
        assert got["ok"], got["violations"][:3]
        assert got["states_total"] > 50
        assert got["recovered"] > 0 and got["refused"] > 0


def test_export_arm_recovers_or_refuses_every_state(tmp_path):
    """The tiny network's store through the port's admission path on the
    CPU: every state recovered with the digest or refused, some of each;
    the CPU store bundles no library, so no kernel launches."""
    from mx_rcnn_tpu_torch.tools import crashsim as t_tool

    rep = t_tool.run_export(str(tmp_path / "w"), max_states=64,
                            device="cpu")
    assert rep["ok"], rep["violations"][:3]
    assert rep["states_total"] >= 10
    assert rep["recovered"] > 0 and rep["refused"] > 0
    assert not any(rep["kernel_launches"].values())


def test_planted_nodirfsync_export_arm_is_flagged(tmp_path):
    """Without directory fsyncs a host crash loses the committed
    manifest: violations at the ``store`` floor."""
    from mx_rcnn_tpu_torch.tools import crashsim as t_tool

    rep = t_tool.run_export(str(tmp_path / "w"), drop=("dirfsync",),
                            max_states=32, device="cpu")
    assert not rep["ok"]
    assert any(v["floor"] == "store" for v in rep["violations"])


def test_export_store_commit_syscall_order(tmp_path, monkeypatch):
    """``add_variables`` and ``finish`` go through the shared
    ``_atomic_write``: fsync(file) → replace → fsync(dir), the payload
    before the manifest, and the committed store loads and admits."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.serve.export import ExportStore

    cfg = generate_config("tiny", "synthetic")
    events = []
    real_fsync, real_replace, real_open = os.fsync, os.replace, os.open
    real_close = os.close
    fd_kind = {}

    def spy_open(path, flags, *a, **kw):
        fd = real_open(path, flags, *a, **kw)
        fd_kind[fd] = "dir" if os.path.isdir(path) else "file"
        return fd

    def spy_close(fd):
        fd_kind.pop(fd, None)
        return real_close(fd)

    def spy_fsync(fd):
        events.append(("fsync", fd_kind.get(fd, "file")))
        return real_fsync(fd)

    def spy_replace(src, dst):
        events.append(("replace", os.path.basename(dst)))
        return real_replace(src, dst)

    store = ExportStore.create(str(tmp_path / "store"), cfg, device="cpu")
    store.add("double", (np.arange(4, dtype=np.float32),),
              [torch.arange(4, dtype=torch.float32) * 2])
    monkeypatch.setattr(os, "open", spy_open)
    monkeypatch.setattr(os, "close", spy_close)
    monkeypatch.setattr(os, "fsync", spy_fsync)
    monkeypatch.setattr(os, "replace", spy_replace)
    store.add_variables({"params": {"w": np.ones(3, np.float32)}})
    store.finish()
    monkeypatch.undo()
    assert events == [
        ("fsync", "file"), ("replace", "variables.npz"), ("fsync", "dir"),
        ("fsync", "file"), ("replace", "manifest.json"), ("fsync", "dir"),
    ], events
    again = ExportStore(str(tmp_path / "store"))
    again.check(cfg, device="cpu")
    again.require_digest("double", [torch.arange(4.0) * 2])
    assert again.load_variables()["params"]["w"].tolist() == [1.0] * 3


def test_cli_smoke_check_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``--smoke --check --device cpu`` exits 0; the record is written
    only where ``--out`` names a file."""
    from mx_rcnn_tpu_torch.tools import crashsim as t_tool

    monkeypatch.chdir(tmp_path)
    assert t_tool.main(["--smoke", "--check", "--device", "cpu",
                        "--workdir", str(tmp_path / "w")]) == 0
    assert not any(n.endswith(".json") for n in os.listdir(tmp_path))
    assert "CRASHSIM CHECK OK" in capsys.readouterr().out
    out = str(tmp_path / "rec.json")
    assert t_tool.main(["--smoke", "--device", "cpu", "--max_states", "8",
                        "--workdir", str(tmp_path / "w2"), "--out",
                        out]) == 0
    import json

    rec = json.load(open(out))
    assert rec["device"] == "cpu" and rec["check"]["ok"]
    assert set(rec["workloads"]) == {"snapshotter", "export", "bulk"}
    assert set(rec["planted"]) == {"planted_nofsync", "planted_nodirfsync"}


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from mx_rcnn_tpu_torch.tools import crashsim as t_tool

    with pytest.raises(RuntimeError, match="CUDA"):
        t_tool.main(["--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
