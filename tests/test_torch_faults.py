"""The port's fault injection (``ft/faults.py``) and the training CLI's
``--fault_plan``, held against the JAX package on the CPU.

Plans parse to the JAX package's faults, and both refuse the same bad
specs.  Each file fault leaves a checkpoint tree byte-equal to the tree
JAX's injector leaves on a byte-identical copy.  Each fault fires once,
in the JAX order.  A SIGTERM plan in process, and SIGTERM and SIGKILL
plans through the rank launcher of ``tools/train.py --num_devices 2``
(whose ranks die with it), followed by ``--resume auto``, end on a final
checkpoint byte-equal to an unbroken run's.
"""

import os
import shutil
import signal
import subprocess
import sys
import time
import uuid

import pytest
import torch

from mx_rcnn_tpu.ft import faults as jfaults
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.ft import faults
from mx_rcnn_tpu_torch.tools import train as ttrain
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_ft import _state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VALID = ["kill@step=9@sig=TERM, flip-byte@step=3@offset=64,"
         "truncate-last-ckpt@step=5",
         "kill@step=9@sig=term",
         "stale-interrupt@step=4@after=2,kill@step=4",
         "truncate-last-ckpt@step=33@after=32,kill@step=34@sig=KILL",
         "", " , kill@step=1 ,"]
BAD = ["explode@step=1", "kill", "kill@step=1@sig=HUP", "kill@step=2@what=3",
       "kill@step", "kill@step=x", "flip-byte@step=1@offset=a"]


@pytest.mark.parametrize("spec", VALID)
def test_parse_plan_equals_the_jax_packages(spec):
    got = faults.parse_plan(spec)
    want = jfaults.parse_plan(spec)
    assert [tuple(f) for f in got] == [tuple(f) for f in want]
    assert all(isinstance(f, faults.Fault) for f in got)


@pytest.mark.parametrize("spec", BAD)
def test_parse_plan_refuses_what_the_jax_package_refuses(spec):
    with pytest.raises(ValueError):
        jfaults.parse_plan(spec)
    with pytest.raises(ValueError):
        faults.parse_plan(spec)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("spec", [
    "truncate-last-ckpt@step=2",
    "flip-byte@step=2",
    "flip-byte@step=2@offset=64",
    "flip-byte@step=2@offset=99999999",
    "stale-interrupt@step=2@after=6",
    "truncate-last-ckpt@step=1@after=3,stale-interrupt@step=2"])
def test_file_faults_leave_the_jax_packages_tree(tmp_path, spec):
    _, state = _state(count=3)
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    prefix = str(port_dir / "m")
    topo = tckpt.make_topology(1, grad_accum=1, batch_images=2)
    tckpt.save_checkpoint(prefix, 1, state, steps_per_epoch=3,
                          config_fp="0123456789abcdef", topology=topo)
    state.optimizer.count = 6
    tckpt.save_checkpoint(prefix, 2, state, steps_per_epoch=3,
                          config_fp="0123456789abcdef", topology=topo)
    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    assert _tree(port_dir) == _tree(jax_dir)
    before = _tree(port_dir)
    faults.FaultInjector(faults.parse_plan(spec), prefix,
                         kill_fn=lambda s: None).on_step(5)
    jfaults.FaultInjector(jfaults.parse_plan(spec), str(jax_dir / "m"),
                          kill_fn=lambda s: None).on_step(5)
    after = _tree(port_dir)
    assert after != before
    assert after == _tree(jax_dir)


def test_a_file_fault_without_a_committed_checkpoint_does_nothing(
        tmp_path, monkeypatch):
    """No committed checkpoint within the wait: the fault logs and returns,
    as the JAX one does (the wait cut to 0 s for the test)."""
    wait = faults.FaultInjector._newest_epoch_ckpt
    monkeypatch.setattr(
        faults.FaultInjector, "_newest_epoch_ckpt",
        lambda self, min_step=None, wait_s=15.0: wait(self, min_step, 0.0))
    inj = faults.FaultInjector(faults.parse_plan("flip-byte@step=1"),
                               str(tmp_path / "m"), kill_fn=lambda s: None)
    inj.on_step(1)
    assert os.listdir(tmp_path) == []


def test_each_fault_fires_once_in_the_jax_order(tmp_path):
    spec = ("kill@step=4@sig=TERM,kill@step=6,kill@step=6@sig=TERM,"
            "kill@step=11")
    steps = [1, 2, 5, 5, 6, 9, 12, 12, 20, 3]
    fired = {}
    for name, mod in (("port", faults), ("jax", jfaults)):
        got = []
        inj = mod.FaultInjector(mod.parse_plan(spec), str(tmp_path / name),
                                kill_fn=got.append)
        for s in steps:
            inj.on_step(s)
        fired[name] = got
    assert fired["port"] == fired["jax"]
    assert fired["port"] == [signal.SIGTERM, signal.SIGKILL, signal.SIGTERM,
                             signal.SIGKILL]


_TINY_RUN = dict(synthetic=4, end_epoch=2, frequent=100, device="cpu")


def _tiny_cfg():
    return generate_config("tiny", "synthetic", train__batch_images=1,
                           train__flip=False)


def test_in_process_term_plan_then_resume_auto_is_byte_equal(tmp_path):
    """``train_net(fault_plan='kill@step=2@sig=TERM')`` signals this
    process: the SIGTERM handler's stop flag writes the interrupt
    checkpoint mid-epoch; ``resume='auto'`` ends byte-equal to an unbroken
    run."""
    cfg = _tiny_cfg()
    unbroken = str(tmp_path / "u" / "m")
    ttrain.train_net(cfg, prefix=unbroken, log=lambda line: None,
                     **_TINY_RUN)
    prefix = str(tmp_path / "k" / "m")
    with ttrain.sigterm_stop_flag() as stop:
        state, _ = ttrain.train_net(cfg, prefix=prefix, stop_flag=stop,
                                    fault_plan="kill@step=2@sig=TERM",
                                    log=lambda line: None, **_TINY_RUN)
    assert state.step == 3
    assert tckpt.read_manifest(tckpt.interrupt_path(prefix))["step"] == 3
    state, _ = ttrain.train_net(cfg, prefix=prefix, resume="auto",
                                log=lambda line: None, **_TINY_RUN)
    assert state.step == 8
    with open(tckpt.checkpoint_path(unbroken, 2), "rb") as f:
        want = f.read()
    with open(tckpt.checkpoint_path(prefix, 2), "rb") as f:
        assert f.read() == want


def test_a_plan_needs_a_prefix():
    with pytest.raises(ValueError, match="prefix"):
        ttrain.train_net(_tiny_cfg(), fault_plan="kill@step=1",
                         log=lambda line: None, **_TINY_RUN)


def _marked_pids(mark: str):
    """Live processes whose environment carries ``mark``."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if mark.encode() in f.read():
                    pids.append(int(pid))
        except OSError:
            pass
    return pids


def test_plans_through_the_rank_launcher(tmp_path):
    """``tools/train.py --num_devices 2 --fault_plan``: the plan runs in
    rank 0 and signals the launcher.  A TERM drains both ranks into the
    interrupt checkpoint; a KILL ends the launcher, and its ranks die with
    it; ``--resume auto`` then ends byte-equal to an unbroken run."""
    mark = f"MXRCNN_FAULT_TEST={uuid.uuid4().hex}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **dict([mark.split("=")]))
    args = ["--device", "cpu", "--network", "tiny", "--dataset",
            "synthetic", "--synthetic", "8", "--batch_images", "1",
            "--num_devices", "2", "--end_epoch", "2", "--frequent", "100",
            "--no_flip"]

    def run(prefix, *extra):
        return subprocess.run(
            [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train", *args,
             "--prefix", str(tmp_path / prefix), *extra], env=env,
            capture_output=True, text=True, timeout=120)

    unbroken = run("u")
    assert unbroken.returncode == 0, unbroken.stderr[-2000:]
    term = run("k", "--fault_plan", "kill@step=2@sig=TERM")
    assert term.returncode == 0, term.stderr[-2000:]
    assert "FAULT INJECTION at step 2" in term.stdout + term.stderr
    m = tckpt.read_manifest(tckpt.interrupt_path(str(tmp_path / "k")))
    assert m is not None and m["kind"] == "interrupt" and 2 <= m["step"] < 4
    kill = run("k", "--resume", "auto", "--fault_plan",
               "kill@step=6@sig=KILL")
    assert kill.returncode == -signal.SIGKILL, kill.stderr[-2000:]
    deadline = time.monotonic() + 10
    while _marked_pids(mark) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _marked_pids(mark) == []
    assert tckpt.latest_checkpoint(str(tmp_path / "k"))[0] == 1
    done = run("k", "--resume", "auto")
    assert done.returncode == 0, done.stderr[-2000:]
    with open(tckpt.checkpoint_path(str(tmp_path / "u"), 2), "rb") as f:
        want = f.read()
    with open(tckpt.checkpoint_path(str(tmp_path / "k"), 2), "rb") as f:
        assert f.read() == want
