"""The port's elastic run controller (``ft/elastic.py``), held against the
JAX package on the CPU.

Topology directives written by either package are read by the other, and
torn ones read None in both; ``parse_events`` skips the JAX package's
torn lines; the controller answers a scripted sequence of polls, pending
directives, stale generations, SIGUSR1 and stop-flag reads as the JAX
one does, and emits the same events; ``infer_base_devices`` and
``_divide_base`` decide as the JAX ones do; a restored state
re-serialises to the checkpoint's sha256, the same sha256 the JAX
``_verify_restore`` computes.  A live shrink through ``tools/train.py
--elastic`` from two gloo ranks on the CPU to one rank with
``grad_accum`` 2 keeps ``state.step``, the steps per epoch and the
global batch, and its restore passes ``_verify_restore``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import generate_config as jgenerate_config
from mx_rcnn_tpu.ft import elastic as jelastic
from mx_rcnn_tpu.ft import integrity as jintegrity
from mx_rcnn_tpu.utils import checkpoint as jckpt
from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.ft import elastic, integrity
from mx_rcnn_tpu_torch.obs.metrics import registry
from mx_rcnn_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_ft import _jax_state, _state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {"port": (elastic, generate_config),
            "jax": (jelastic, jgenerate_config)}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_directives_cross_between_the_packages(tmp_path, writer, reader):
    wmod, rmod = PACKAGES[writer][0], PACKAGES[reader][0]
    path = str(tmp_path / "m.topology.json")
    wmod.write_topology(path, 3, 4, num_processes=2, ts=123.5)
    assert tuple(rmod.read_topology(path)) == (3, 4, 2, 123.5)
    other = str(tmp_path / "other.json")
    rmod.write_topology(other, 3, 4, num_processes=2, ts=123.5)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("text", [
    None, '{"generation": 3, "num_dev', '{"num_devices": 4}', "[4]",
    '{"generation": "x", "num_devices": 4}', "", "\xff\xfe",
    '{"generation": 1, "num_devices": 2}'])
def test_torn_and_partial_directives_read_as_in_the_jax_package(
        tmp_path, text):
    path = str(tmp_path / "m.topology.json")
    if text is not None:
        with open(path, "wb") as f:
            f.write(text.encode("latin-1"))
    got = elastic.read_topology(path)
    want = jelastic.read_topology(path)
    assert (None if got is None else tuple(got)) == \
        (None if want is None else tuple(want))


def test_topology_path_override():
    for mod, gen in PACKAGES.values():
        cfg = gen("tiny", "PascalVOC")
        assert mod.topology_path("/r/m/e2e", cfg) == "/r/m/e2e.topology.json"
        cfg = cfg.replace_in("elastic", topology_path="/etc/t.json")
        assert mod.topology_path("/r/m/e2e", cfg) == "/etc/t.json"


def test_parse_events_on_torn_lines_gives_the_jax_packages():
    text = ("noise\n"
            'ELASTIC_EVENT {"ts": 1.0, "event": "mesh", "num_devices": 4}\n'
            'ELASTIC_EVENT {"ts": 2.0, "event": "first_st\n'
            '  ELASTIC_EVENT {"ts": 3.0, "event": "restore"}  \n'
            "ELASTIC_EVENT\n"
            'ELASTIC_EVENT {"ts": 4.0, "event": "complete", "step": 9}')
    got = elastic.parse_events(text)
    assert got == jelastic.parse_events(text)
    assert [e["event"] for e in got] == ["mesh", "restore", "complete"]


def _script(mod, gen, tmp_path, poll_steps, capsys):
    """Drive one package's controller through a fixed sequence; returns
    what each call answered and the events it emitted (without their
    times)."""
    cfg = gen("tiny", "PascalVOC").replace_in("elastic",
                                              poll_steps=poll_steps)
    prefix = str(tmp_path / "e2e")
    ctrl = mod.ElasticController(cfg, prefix, install_signal=False)
    user = {"stop": False}
    flag = ctrl.make_stop_flag(lambda: user["stop"])
    out = []

    def note(tag, value):
        out.append((tag, tuple(value) if isinstance(value, tuple)
                    else value))

    def steps(n):
        for _ in range(n):
            note("rr", ctrl.resize_requested())

    ctrl.mark_applied(mod.Topology(0, 8, 1))
    steps(3)                                       # no directive file
    mod.write_topology(ctrl.path, 1, 4, 1, ts=10.0)
    steps(4)
    note("pending", ctrl.pending())
    ctrl.mark_applied(ctrl.pending())
    note("applied", ctrl.applied())
    steps(3)
    mod.write_topology(ctrl.path, 0, 8, 1, ts=11.0)   # a stale generation
    steps(4)
    ctrl._on_sigusr1(None, None)
    mod.write_topology(ctrl.path, 3, 2, 2, ts=12.0)
    steps(1)                                       # SIGUSR1: polled now
    note("pending", ctrl.pending())
    note("poll", ctrl.poll())
    ctrl.mark_applied(mod.Topology(3, 2, 2))
    note("flag", flag())
    user["stop"] = True
    note("flag", flag())
    user["stop"] = False
    mod.write_topology(ctrl.path, 4, 1, 1, ts=13.0)
    for _ in range(4):
        note("flag", flag())
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in mod.parse_events(capsys.readouterr().out)]
    return out, events


@pytest.mark.parametrize("poll_steps", [1, 3])
def test_the_controller_answers_as_the_jax_one(tmp_path, capsys, poll_steps):
    runs = {name: _script(mod, gen, tmp_path / name, poll_steps, capsys)
            for name, (mod, gen) in PACKAGES.items()}
    assert runs["port"] == runs["jax"]
    out, events = runs["port"]
    assert ("pending", (1, 4, 1, 10.0)) in out
    assert [e["event"] for e in events] == ["resize_requested"] * 3


def test_the_controllers_gauges_and_counters(tmp_path, capsys):
    reg = registry()
    reg.reset("elastic.")
    cfg = generate_config("tiny", "PascalVOC")
    ctrl = elastic.ElasticController(cfg, str(tmp_path / "m"),
                                     install_signal=False)
    ctrl.mark_applied(elastic.Topology(2, 4, 1))
    for event in ("shrink", "grow", "restore", "rescale", "drain"):
        ctrl.emit(event)
    ctrl.emit("first_step", recovery_ms=250.0)
    assert reg.gauge("elastic.generation") == 2
    assert reg.gauge("elastic.num_devices") == 4
    for name in ("shrinks", "grows", "restores", "rescales", "drains"):
        assert reg.counter(f"elastic.{name}") == 1
    assert reg.hist("elastic.recovery_ms").summary()["count"] == 1


def _write_ckpt(prefix, topology):
    _, state = _state(count=10)
    tckpt.save_checkpoint(prefix, 1, state, steps_per_epoch=10,
                          topology=topology)


@pytest.mark.parametrize("case", ["explicit", "fresh", "checkpoint",
                                  "no_topology"])
def test_infer_base_devices_as_the_jax_one(tmp_path, case):
    prefix = str(tmp_path / "m")
    shrunk = (3, 4, 1)
    base = 8 if case == "explicit" else 0
    if case == "checkpoint":
        _write_ckpt(prefix, tckpt.make_topology(8, grad_accum=1,
                                                batch_images=2))
    elif case == "no_topology":
        _write_ckpt(prefix, None)
    got = elastic.infer_base_devices(
        generate_config("tiny", "PascalVOC", train__batch_images=2,
                        elastic__base_devices=base),
        prefix, elastic.Topology(*shrunk))
    want = jelastic.infer_base_devices(
        jgenerate_config("tiny", "PascalVOC").replace_in(
            "train", batch_images=2).replace_in(
            "elastic", base_devices=base),
        prefix, jelastic.Topology(*shrunk))
    assert got == want
    assert got == {"explicit": 8, "fresh": 4, "checkpoint": 8,
                   "no_topology": 4}[case]


@pytest.mark.parametrize("base,devices,allow", [
    (4, 1, False), (4, 2, False), (8, 8, False), (4, 3, True), (2, 4, True),
    (4, 3, False), (2, 4, False)])
def test_divide_base_as_the_jax_one(base, devices, allow):
    def run(mod):
        try:
            return mod._divide_base(base, devices, allow)
        except ValueError:
            return "refused"

    assert run(elastic) == run(jelastic)


@pytest.mark.parametrize("kind", ["epoch", "interrupt"])
def test_verify_restore_gives_the_jax_packages_sha(tmp_path, kind):
    _, state = _state(seed=4, count=7)
    prefix = str(tmp_path / "m")
    if kind == "epoch":
        tckpt.save_checkpoint(prefix, 1, state, steps_per_epoch=5)
    else:
        tckpt.save_interrupt(prefix, state, 5)
    ref = integrity.latest_valid_checkpoint(prefix)
    assert ref.kind == kind
    _, fresh = _state(seed=9, count=0)
    if kind == "epoch":
        tckpt.restore_state(fresh, prefix, 1)
    else:
        tckpt.restore_interrupt(fresh, prefix)
    ok, sha = elastic._verify_restore(ref, fresh, 5)
    assert ok
    assert not elastic._verify_restore(ref, _state(seed=9)[1], 5)[0]
    # the JAX package's audit of its own restore of the same file
    jref = jintegrity.latest_valid_checkpoint(prefix)
    epoch_file = tckpt.save_checkpoint(str(tmp_path / "e"), 1, state)
    template = jax.tree.map(np.zeros_like, _jax_state(epoch_file))
    if kind == "epoch":
        jstate = jckpt.restore_state(template, prefix, 1)
    else:
        jstate, _ = jckpt.restore_interrupt(template, prefix)
    assert jelastic._verify_restore(jref, jstate, 5) == (True, sha)


def test_a_live_shrink_over_gloo_ranks_keeps_the_recipe(tmp_path):
    """``tools/train.py --elastic``: two gloo ranks on the CPU train epoch
    1; a directive for one device (and a SIGUSR1) then drains them, and
    the same process continues in process with grad_accum 2 to the end."""
    prefix = str(tmp_path / "m")
    path = elastic.topology_path(prefix)
    elastic.write_topology(path, 0, 2, 1, ts=1.0)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train",
         "--elastic", "--device", "cpu", "--network", "tiny", "--dataset",
         "synthetic", "--synthetic", "8", "--batch_images", "1",
         "--no_flip", "--end_epoch", "4", "--frequent", "100",
         "--prefix", prefix], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        # the scheduler's side: shrink once epoch 1 is committed
        deadline = time.monotonic() + 90
        while integrity.latest_valid_checkpoint(prefix) is None:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        elastic.write_topology(path, 1, 1, 1)
        proc.send_signal(signal.SIGUSR1)
        out, _ = proc.communicate(timeout=90)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-3000:]
    events = elastic.parse_events(out)
    names = [e["event"] for e in events]
    assert names.count("mesh") == 2 and "complete" in names
    meshes = [e for e in events if e["event"] == "mesh"]
    assert [(m["num_devices"], m["grad_accum"]) for m in meshes] == \
        [(2, 1), (1, 2)]
    shrink = next(e for e in events if e["event"] == "shrink")
    assert (shrink["from_devices"], shrink["num_devices"]) == (2, 1)
    rescale = next(e for e in events if e["event"] == "rescale")
    assert rescale == {**rescale, "grad_accum": 2, "global_batch": 2}
    restores = [e for e in events if e["event"] == "restore"]
    assert len(restores) == 1 and restores[0]["bit_identical"]
    first = [e for e in events if e["event"] == "first_step"]
    # the generation over ranks reports from rank 0; the next resumes
    # at the restored step
    assert [e["generation"] for e in first] == [0, 1]
    assert first[1]["step"] == restores[0]["step"] + 1
    # steps per epoch, state.step and the global batch never moved
    spe = 4                                     # 8 images, 2 a step
    ref = integrity.latest_valid_checkpoint(prefix)
    assert (ref.kind, ref.epoch, ref.step) == ("epoch", 4, 4 * spe)
    for ref in integrity.scan_candidates(prefix):
        assert ref.manifest["steps_per_epoch"] == spe
        assert ref.manifest["topology"]["global_batch"] == 2
    assert json.loads(open(path).read())["generation"] == 1
    assert not os.path.exists(tckpt.interrupt_path(prefix))
