"""The port's training supervisor (``ft/supervisor.py``) and
``tools/crashloop.py``, held against the JAX package on the CPU.

With the same seed and the same resume points, the port's crash loop
realises the JAX supervisor's fault plans, attempt by attempt (both run
over one stand-in child that advances a counter instead of training).
Then the real thing at a reduced size: ``tools/crashloop.py --smoke
--check`` on the CPU (a SIGTERM mid-epoch, then a torn write and a
SIGKILL past a boundary) ends on a survivor byte-equal to its control,
and ``--elastic --smoke --check`` takes a two-process gloo world through
a preemption, a shrink to one process with ``grad_accum`` 2, a grow back
and completion, every restore bit-identical.  The snapshot overhead
measurement reports the JAX record's keys.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.ft import supervisor as jsup
from mx_rcnn_tpu.utils import checkpoint as jckpt
from mx_rcnn_tpu_torch.ft import integrity
from mx_rcnn_tpu_torch.ft import supervisor as tsup
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)


class _StandIn:
    """A child that trains nothing: its progress under a prefix is a
    counter its fault plan moves as the real child's would (a TERM resume
    at the kill step, a KILL back to the last boundary, one more epoch
    back after a corrupting fault); without a plan it completes."""

    def __init__(self, tmp_path, spe, total, end_epoch):
        self.progress = {}
        self.spe, self.total, self.end_epoch = spe, total, end_epoch
        self.tmp_path = tmp_path

    def run(self, cmd, **kw):
        prefix = cmd[cmd.index("--prefix") + 1]
        plan = (cmd[cmd.index("--fault_plan") + 1]
                if "--fault_plan" in cmd else None)
        cur = self.progress.get(prefix, 0)
        rc = 0
        if plan is None:
            self.progress[prefix] = self.total
            path = f"{prefix}-{self.end_epoch:04d}.ckpt"
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(b"same")
        else:
            kill = int(re.search(r"kill@step=(\d+)", plan).group(1))
            if "sig=TERM" in plan:
                self.progress[prefix] = kill
            else:
                back = (kill // self.spe) * self.spe
                if "truncate" in plan or "flip-byte" in plan:
                    back -= self.spe
                self.progress[prefix] = max(back, cur)
                rc = -9
        return subprocess.CompletedProcess(cmd, rc, "", "")

    def at(self, prefix):
        return self.progress.get(prefix, 0), None


@pytest.mark.parametrize("events,rng_seed,num_images,end_epoch", [
    ("DEFAULT_EVENTS", 0, 32, 5), ("DEFAULT_EVENTS", 7, 32, 5),
    ("DEFAULT_EVENTS", 3, 20, 6), ("SMOKE_EVENTS", 0, 16, 3),
    ("SMOKE_EVENTS", 11, 32, 3)])
def test_kill_schedules_are_the_jax_supervisors(tmp_path, monkeypatch,
                                                events, rng_seed,
                                                num_images, end_epoch):
    attempts = {}
    for name, sup, ckpt in (("port", tsup, tckpt), ("jax", jsup, jckpt)):
        child = _StandIn(tmp_path / name, num_images,
                         num_images * end_epoch, end_epoch)
        monkeypatch.setattr(subprocess, "run", child.run)
        monkeypatch.setattr(sup, "_progress", child.at)
        monkeypatch.setattr(ckpt, "load_checkpoint",
                            lambda prefix, epoch: {})
        rec = sup.run_crashloop(str(tmp_path / name), events=getattr(
            sup, events), num_images=num_images, end_epoch=end_epoch,
            rng_seed=rng_seed)
        attempts[name] = [(a["plan"], a["resume_step"], a["exit"],
                           a["progress_step"]) for a in rec["attempts"]]
        assert rec["bit_identical"] and rec["files_identical"]
    assert attempts["port"] == attempts["jax"]
    assert any(plan for plan, *_ in attempts["port"])


def test_the_events_are_the_jax_supervisors():
    assert tsup.DEFAULT_EVENTS == jsup.DEFAULT_EVENTS
    assert tsup.SMOKE_EVENTS == jsup.SMOKE_EVENTS


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _crashloop(tmp_path, *args, timeout=150):
    """``tools/crashloop.py`` in a process of its own (one intra-op thread
    in it and its children), with a time limit; its JSON record."""
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.crashloop",
         "--device", "cpu", "--smoke", "--check", "--workdir",
         str(tmp_path / "w"), "--out", str(out), *args], env=env,
        capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def test_the_crashloop_smoke_on_the_cpu(tmp_path):
    """A real control and survivor, tools/train.py in processes of their
    own: two kills survived, one fallback past the torn checkpoint, the
    survivor's final checkpoint byte-equal to the control's."""
    rec = _crashloop(tmp_path, "--num_images", "16", "--skip_overhead")
    assert rec["bit_identical"] and rec["files_identical"]
    assert rec["kills_survived"] == 2 and rec["fallback_events"] >= 1
    plans = [a["plan"] for a in rec["attempts"]]
    assert plans[0].endswith("@sig=TERM") and "truncate" in plans[1]
    assert [a["exit"] for a in rec["attempts"]] == [0, -9, 0]
    # every child reports its steps; no kernel launches on the CPU
    assert rec["control"]["steps_run"] == 48
    for a in rec["attempts"]:
        assert a["steps_run"] > 0
        assert not any(a["launches_per_step"].values())


def test_the_elastic_storm_smoke_over_gloo_on_the_cpu(tmp_path):
    # 6 epochs of 4 steps: the first world is preempted an epoch or more
    # in, and the grow drains the shrunk one at its first step
    rec = _crashloop(tmp_path, "--elastic", "--num_images", "8",
                     "--end_epoch", "6")
    assert rec["completed"] and rec["final_step"] == rec["total_steps"]
    assert 1 <= rec["steps_left_at_grow"] < rec["total_steps"]
    assert rec["rig"] == "gloo on the CPU"
    assert rec["restores"] >= 2 and rec["restores_bit_identical"]
    assert rec["grad_accums"] == [1, 2]
    assert (rec["shrinks"], rec["grows"]) == (1, 1)
    assert set(rec["recovery_ms"]["by_kind"]) == {"shrink_world",
                                                  "grow_world"}
    # the steps per epoch never moved: every checkpoint's manifest says 4
    assert rec["manifest_steps_per_epoch"] == [rec["steps_per_epoch"]] == [4]
    prefix = str(tmp_path / "w" / "storm" / "e2e")
    assert integrity.latest_valid_checkpoint(prefix).step == 24


def test_the_full_storm_refuses_fewer_cards_than_its_base(tmp_path,
                                                         monkeypatch):
    # its live grow puts base_devices ranks in one process, a card each
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards, 1 found"):
        tsup.run_elastic_storm(str(tmp_path), smoke=False, device="cuda")
    assert not os.listdir(tmp_path)


def test_snapshot_overhead_reports_the_jax_records_keys():
    rec = tsup.measure_snapshot_overhead(steps=4, snapshot_every=2,
                                         warmup=1, device="cpu")
    jax_keys = {"steps", "snapshot_every", "base_step_ms", "async_step_ms",
                "sync_step_ms", "async_overhead_pct_1core",
                "sync_overhead_pct_1core", "async_stall_ms_per_snapshot",
                "sync_stall_ms_per_snapshot", "async_stall_overhead_pct",
                "sync_stall_overhead_pct"}
    assert jax_keys <= set(rec)
    assert rec["network"] == "tiny" and rec["device"] == "cpu"
    assert all(np.isfinite(rec[k]) for k in jax_keys)
    assert rec["sync_stall_ms_per_snapshot"] > 0
